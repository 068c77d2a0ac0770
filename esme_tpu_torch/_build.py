"""Build and bind the port's CUDA kernels.

Each ``csrc/*.cu`` source (with the ``csrc/*.cuh`` headers it includes)
compiles at first use into its own shared library with a plain C
interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v \\
         -o build/esme_tpu_torch/<hash>/lib<name>.so \\
         esme_tpu_torch/csrc/<name>.cu

The output directory is keyed by a hash of every source and the flags,
so an edited source rebuilds and an unchanged one is reused. All
sources compile in parallel (one ``nvcc`` each, started together). The
libraries are bound with ``ctypes``: every pointer and the stream pass
as ``c_void_p``, and every C entry returns ``cudaGetLastError()`` of
its launch, which the wrappers turn into an exception.

Only sources in the repository are built; a machine with a card but
without ``nvcc`` raises. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_ROOT = Path(__file__).resolve().parent.parent / 'build' / \
    'esme_tpu_torch'
CUDA_NVCC = '/usr/local/cuda/bin/nvcc'    # the toolkit's default place
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC')

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# C signatures of every entry point, by library
SIGNATURES = {
    'flash_fwd': {
        'esme_segment_flash_fwd': (I, [P, P, P, P, P, P, P, P, I, I, I, F,
                                       P]),
        'esme_segment_flash_fwd_variant': (I, [I] + [P] * 8 + [I, I, I, F,
                                                               P]),
        'esme_segment_flash_fwd_rect': (I, [P] * 9 + [I, I, I, I, F, P]),
        'esme_flash_error_string': (ctypes.c_char_p, [I]),
    },
    'flash_fwd_sm90': {
        'esme_segment_flash_fwd_sm90': (I, [P] * 8 + [I, I, I, F, P]),
        'esme_flash_fwd_t_sm90': (I, [P] * 8 + [I, I, I, F, P]),
        'esme_segment_flash_fwd_sm90_variant': (I, [I] + [P] * 8
                                                + [I, I, I, F, P]),
        # H9's entry ends with its launch order (null: q-block order)
        'esme_segment_flash_fwd_rect_sm90': (I, [P] * 9
                                             + [I, I, I, I, F, P, P]),
        'esme_flash_fwd_sm90_error_string': (ctypes.c_char_p, [I]),
    },
    'flash_bwd': {
        'esme_segment_flash_bwd': (I, [P] * 14 + [I, I, I, F, P]),
        'esme_segment_flash_bwd_variant': (I, [I, I] + [P] * 14
                                           + [I, I, I, F, P]),
        'esme_segment_flash_bwd_rect': (I, [P] * 15 + [I, I, I, I, F, P]),
        'esme_flash_bwd_error_string': (ctypes.c_char_p, [I]),
    },
    'flash_bwd_sm90': {
        'esme_segment_flash_bwd_sm90': (I, [P] * 14 + [I, I, I, F, P]),
        'esme_flash_bwd_sm90_pass': (I, [I, I] + [P] * 14
                                     + [I, I, I, F, P]),
        'esme_segment_flash_bwd_rect_sm90': (I, [P] * 15
                                             + [I, I, I, I, F, P]),
        'esme_flash_bwd_rect_sm90_pass': (I, [I] + [P] * 15
                                          + [I, I, I, I, F, P]),
        'esme_flash_bwd_sm90_timeline': (I, [I] + [P] * 13
                                         + [I, I, I, I, F, I, P]),
        'esme_flash_bwd_sm90_error_string': (ctypes.c_char_p, [I]),
    },
    'flash_fwd_t': {
        'esme_flash_fwd_t': (I, [P] * 8 + [I, I, I, F, P]),
        'esme_flash_fwd_t_error_string': (ctypes.c_char_p, [I]),
    },
    'probes': {
        'esme_probe_vpu': (I, [P] * 4 + [I, I, P]),
        'esme_probe_mxu': (I, [P] * 5 + [I, I, P]),
        'esme_probe_dma': (I, [P] * 6 + [I, I, P]),
        'esme_probe_dma_t': (I, [P] * 5 + [I, I, P]),
        'esme_probe_error_string': (ctypes.c_char_p, [I]),
    },
    'probes_sm90': {
        'esme_probe_dma_sm90': (I, [P] * 6 + [I, I, I, P]),
        'esme_probe_dma_t_sm90': (I, [P] * 5 + [I, I, P]),
        'esme_probe_sm90_error_string': (ctypes.c_char_p, [I]),
    },
    'headsplit': {
        'esme_relayout_heads': (I, [P] * 6 + [I] * 4
                                + [P, P, I, I, I, I, P]),
        'esme_relayout_error_string': (ctypes.c_char_p, [I]),
    },
    'rope': {
        'esme_rope_qk': (I, [P, P, P, P, P, P, I, I, I, I, P]),
        'esme_rope_error_string': (ctypes.c_char_p, [I]),
    },
}


def _nvcc() -> str:
    path = shutil.which('nvcc')
    if path is None and os.path.exists(CUDA_NVCC):
        path = CUDA_NVCC
    if path is None:
        raise RuntimeError('nvcc not found: the CUDA kernels of '
                           'esme_tpu_torch are built from source at first '
                           'use and need the CUDA toolkit')
    return path


def _build_dir() -> Path:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob('*.cu*')):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all(verbose: bool = False) -> dict:
    """Compile every missing library, all sources in parallel, each with
    its ``nvcc`` output (``ptxas``' registers, stack and spills per
    kernel) kept beside it as ``lib<name>.log``. Returns ``{name:
    seconds}`` for the libraries it compiled."""
    out_dir = _build_dir()
    todo = [src for src in sorted(CSRC.glob('*.cu'))
            if not (out_dir / f'lib{src.stem}.so').exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    t0 = time.perf_counter()
    for src in todo:
        tmp = out_dir / f'lib{src.stem}.so.{os.getpid()}.tmp'
        cmd = [nvcc, *NVCC_FLAGS, '-Xptxas', '-v', '-o', str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    times, errors = {}, []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        times[src.stem] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f'{src.name}:\n{log}')
            continue
        if verbose:
            print(f'[nvcc {src.name}]\n{log}', flush=True)
        (out_dir / f'lib{src.stem}.log').write_text(log)
        os.replace(tmp, out_dir / f'lib{src.stem}.so')
    if errors:
        raise RuntimeError('nvcc failed:\n' + '\n'.join(errors))
    return times


def build_log(name: str) -> str:
    """What ``nvcc`` printed when it built ``lib<name>.so``."""
    build_all()
    return (_build_dir() / f'lib{name}.log').read_text()


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``lib<name>.so``, built if needed."""
    build_all()
    lib = ctypes.CDLL(str(_build_dir() / f'lib{name}.so'))
    for fn, (restype, argtypes) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = argtypes
    return lib


def check(rc: int, lib: ctypes.CDLL, error_fn: str, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if rc != 0:
        msg = getattr(lib, error_fn)(rc).decode()
        raise RuntimeError(f'{what}: CUDA error {rc} ({msg})')
