"""Time a variant of H2's Hopper source against the source itself.

    python -m esme_tpu_torch.tools.bwd_ab VARIANT.cu

``VARIANT.cu`` is a copy of ``csrc/flash_bwd_sm90.cu`` with one change
to measure: it keeps the C entry ``esme_segment_flash_bwd_sm90`` and may
include the headers of ``csrc``. Both build with ``_build``'s flags (the
variant into ``build/esme_tpu_torch/variant/``), run on ``bench.py``'s
50k masked-LM batch at ESM2-650M's attention (H = 20, D = 64, bf16) and
are timed with CUDA events, 20 calls a side, in the order source,
variant, variant, source. Prints the variant's ``ptxas`` lines, each
side's ms, the variant's ratio and whether its dq, dk and dv are
bit-equal to the source's. On the card only.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from .. import _build
from ..profiling import benchmark
from . import BWD_SEED, CUDA_REPS, attention_batch
from .decompose_bwd import backward_inputs

LIBRARY = 'flash_bwd_sm90'
ENTRY = 'esme_segment_flash_bwd_sm90'


def variant_library(path: Path) -> ctypes.CDLL:
    """``path`` built as ``_build`` builds its sources and bound with
    :data:`LIBRARY`'s signatures; prints ``nvcc``'s ``ptxas`` lines."""
    out = _build.BUILD_ROOT / 'variant' / f'lib{path.stem}.so'
    out.parent.mkdir(parents=True, exist_ok=True)
    run = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, '-Xptxas', '-v', '-I',
         str(_build.CSRC), '-o', str(out), str(path)],
        capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f'nvcc failed on {path}:\n{run.stdout}{run.stderr}')
    print(f'[nvcc {path.name}]\n{run.stdout}{run.stderr}', flush=True)
    lib = ctypes.CDLL(str(out))
    for fn, (restype, argtypes) in _build.SIGNATURES[LIBRARY].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def launch(lib: ctypes.CDLL, args):
    """Both passes of ``lib`` on H2's arguments ``args``; dq, dk, dv."""
    q, *_, H = args
    T, HD = q.shape
    outs = [torch.empty_like(q) for _ in range(3)]
    rc = getattr(lib, ENTRY)(
        *(x.data_ptr() for x in (*args[:11], *outs)), T, H, HD // H,
        (HD // H) ** -0.5, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, lib, 'esme_flash_bwd_sm90_error_string', ENTRY)
    return outs


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('variant', type=Path)
    path = p.parse_args(argv).variant
    if not torch.cuda.is_available():
        raise RuntimeError('this tool times CUDA kernels and needs a card')
    libs = {'source': _build.library(LIBRARY),
            'variant': variant_library(path)}
    b = attention_batch(seed=BWD_SEED, grads=True)
    lse, delta = backward_inputs(b)
    args = (b.q, b.k, b.v, b.do, lse, delta, b.seg, *b.spans, b.H)
    equal = all(map(torch.equal, launch(libs['source'], args),
                    launch(libs['variant'], args)))
    samples = {side: [] for side in libs}
    for side in ('source', 'variant', 'variant', 'source'):
        samples[side].append(benchmark(launch, libs[side], args,
                                       reps=CUDA_REPS, device='cuda') * 1e3)
    ms = {side: sum(s) / len(s) for side, s in samples.items()}
    print(f'T={b.T} H={b.H} D={b.D}: source {ms["source"]:.4f} ms, variant '
          f'{ms["variant"]:.4f} ms ({ms["variant"] / ms["source"]:.4f}); '
          f'samples {samples}; dq, dk, dv bit-equal: {equal}', flush=True)
    return {'ms': ms, 'samples': samples, 'bit_equal': equal}


if __name__ == '__main__':
    main(sys.argv[1:])
