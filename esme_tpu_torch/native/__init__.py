"""ctypes bindings of the port's C++ FASTA reader and packer.

Counterpart of ``esme_tpu/native/__init__.py``: :class:`NativeFasta`
(mmap'd random access by the ``.fai`` offsets, and packed batch
tokenization) and :func:`make_lut`. :func:`library` builds
:file:`fasta_reader.cpp` at first use:

    g++ -O3 -shared -fPIC -o build/esme_tpu_torch/fasta-<hash>/libesme_fasta.so \\
        esme_tpu_torch/native/fasta_reader.cpp

into the git-ignored build tree that :mod:`esme_tpu_torch._build` uses,
keyed by a hash of the source and the flags; never beside the source.
A failed build raises with the compiler's own output: there is no
silent fallback here. The datasets choose (``use_native``,
:class:`esme_tpu_torch.data.FastaTokenDataset`). Nothing is built at
import time. The library's calls release the GIL (``ctypes.CDLL``), so
threads that read batches run in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

from .. import _build

SRC = Path(__file__).resolve().parent / 'fasta_reader.cpp'
GXX_FLAGS = ('-O3', '-shared', '-fPIC')

_lock = threading.Lock()
_loaded = {}


def lib_path() -> Path:
    """Where the library of this source and these flags is built."""
    h = hashlib.sha256(' '.join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return _build.BUILD_ROOT / f'fasta-{h.hexdigest()[:16]}' / \
        'libesme_fasta.so'


def build() -> Path:
    """Compile the library if it is missing; returns its path. Raises
    ``RuntimeError`` without ``g++`` or with the compiler's output when
    the build fails."""
    path = lib_path()
    if path.exists():
        return path
    gxx = shutil.which('g++')
    if gxx is None:
        raise RuntimeError('g++ not found: the native FASTA reader of '
                           'esme_tpu_torch is built from source at first use')
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f'{path.name}.{os.getpid()}.tmp')
    run = subprocess.run([gxx, *GXX_FLAGS, '-o', str(tmp), str(SRC)],
                         capture_output=True, text=True, timeout=120)
    if run.returncode != 0:
        raise RuntimeError(f'g++ failed to build {SRC.name}:\n'
                           f'{run.stdout}{run.stderr}')
    os.replace(tmp, path)
    return path


def library() -> ctypes.CDLL:
    """The loaded library, built first if needed, with its C signatures."""
    with _lock:
        path = build()
        lib = _loaded.get(path)
        if lib is not None:
            return lib
        lib = ctypes.CDLL(str(path))
        i64, ptr = ctypes.c_int64, np.ctypeslib.ndpointer
        lib.esme_fasta_open.restype = ctypes.c_void_p
        lib.esme_fasta_open.argtypes = [ctypes.c_char_p]
        lib.esme_fasta_close.argtypes = [ctypes.c_void_p]
        lib.esme_read_seq.restype = i64
        lib.esme_read_seq.argtypes = [ctypes.c_void_p, i64, i64, i64, i64,
                                      ctypes.c_char_p]
        lib.esme_tokenize_pack.restype = i64
        lib.esme_tokenize_pack.argtypes = [
            ctypes.c_void_p, *[ptr(np.int64)] * 5, i64, ptr(np.int8),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, i64,
            ptr(np.int32), ptr(np.int32), ptr(np.int64)]
        _loaded[path] = lib
        return lib


def make_lut(alphabet) -> np.ndarray:
    """Byte -> token-id lookup table (unknown bytes -> ``unk_idx``)."""
    lut = np.full(256, alphabet.unk_idx, np.int8)
    for tok, idx in alphabet.token_to_idx.items():
        if len(tok) == 1:
            lut[ord(tok)] = idx
    return lut


class NativeFasta:
    """mmap'd random-access FASTA with packed batch tokenization: the
    native counterpart of :class:`esme_tpu_torch.fasta.Fasta` with
    :func:`esme_tpu_torch.alphabet.tokenize_unpad` on the training path.

    ``fai_rows`` are the index rows (:func:`esme_tpu_torch.fasta.read_fai`,
    after any ``max_len`` filter or ``k_sample``), so indices are the
    dataset's."""

    def __init__(self, fasta_path, fai_rows, alphabet):
        self._lib = library()
        self._handle = self._lib.esme_fasta_open(str(fasta_path).encode())
        if not self._handle:
            raise OSError(f'cannot mmap {fasta_path}')
        self.lengths = np.asarray([r['length'] for r in fai_rows], np.int64)
        self.offsets = np.asarray([r['offset'] for r in fai_rows], np.int64)
        self.line_bases = np.asarray([r['line_bases'] for r in fai_rows],
                                     np.int64)
        self.line_widths = np.asarray([r['line_width'] for r in fai_rows],
                                      np.int64)
        self.lut = make_lut(alphabet)
        self.alphabet = alphabet

    def read_seq(self, idx: int) -> str:
        n = int(self.lengths[idx])
        buf = ctypes.create_string_buffer(n)
        got = self._lib.esme_read_seq(
            self._handle, int(self.offsets[idx]), n,
            int(self.line_bases[idx]), int(self.line_widths[idx]), buf)
        if got != n:
            raise IOError(f'short read for seq {idx}: {got} != {n}')
        return buf.raw.decode()

    def tokenize_pack(self, indices: Sequence[int], token_budget: int):
        """Packed tokens of the sequences ``indices``: ``(tokens (budget,)
        int32, cu_lens (n + 1,) int32, max_len)``, the tail past
        ``cu_lens[-1]`` the padding index (``tokenize_unpad`` then
        ``pack_tokens``' padding)."""
        idx = np.asarray(indices, np.int64)
        tokens = np.empty(token_budget, np.int32)
        cu_lens = np.empty(idx.shape[0] + 1, np.int32)
        max_len = np.zeros(1, np.int64)
        total = self._lib.esme_tokenize_pack(
            self._handle, self.offsets, self.lengths, self.line_bases,
            self.line_widths, idx, idx.shape[0], self.lut,
            self.alphabet.cls_idx, self.alphabet.eos_idx,
            self.alphabet.padding_idx, token_budget,
            tokens, cu_lens, max_len)
        if total < 0:
            raise ValueError(f'batch exceeds token_budget={token_budget}')
        return tokens, cu_lens, int(max_len[0])

    def close(self):
        if getattr(self, '_handle', None):
            self._lib.esme_fasta_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
