"""Time a variant of H1's, H2's or H5's Hopper source against the source.

    python -m esme_tpu_torch.tools.sm90_ab FORM VARIANT.cu

``FORM`` is ``flash_fwd_sm90`` (H1), ``flash_bwd_sm90`` (H2) or
``fwd_T_sm90`` (H5's Hopper form, H1's kernel on token-minor operands),
and ``VARIANT.cu`` a copy of the form's source, ``csrc/flash_fwd_sm90.cu``
or ``csrc/flash_bwd_sm90.cu``, with one change to measure: it keeps the
source's C entries and may include the headers of ``csrc``. Both build
with ``_build``'s flags (the variant into ``build/esme_tpu_torch/variant/``),
run on ``bench.py``'s 50k batch at ESM2-650M's attention (H = 20, D = 64,
bf16; H1 and H5 on the inference batch, H5's operands made token-minor,
H2 on the masked-LM batch) through the wrapper's launch
(``ops/flash.py:launch_fwd``, ``launch_bwd``,
``tools/fwd_T_experiment.py:launch_fwd_T``) and are timed with CUDA
events, 20 calls a side, in the order source, variant, variant, source.
Prints the variant's ``ptxas`` lines, each side's ms, the variant's ratio
and whether its outputs (o and lse; dq, dk and dv) are bit-equal to the
source's. On the card only.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from .. import _build
from ..ops import flash
from ..profiling import benchmark
from . import BWD_SEED, CUDA_REPS, FWD_SEED, attention_batch, thd_to_hdt
from .decompose_bwd import backward_inputs
from .fwd_T_experiment import launch_fwd_T


def forward_args():
    """H1's arguments on the inference batch."""
    b = attention_batch(seed=FWD_SEED)
    return (b.q, b.k, b.v, b.seg, *b.spans[:2], b.H)


def backward_args():
    """H2's arguments on the masked-LM batch."""
    b = attention_batch(seed=BWD_SEED, grads=True)
    lse, delta = backward_inputs(b)
    return (b.q, b.k, b.v, b.do, lse, delta, b.seg, *b.spans, b.H)


def token_minor_args():
    """H5's arguments on the inference batch: q, k, v token-minor."""
    b = attention_batch(seed=FWD_SEED)
    return (*(thd_to_hdt(x, b.H) for x in (b.q, b.k, b.v)), b.seg,
            *b.spans[:2])


# form -> (its library, its wrapper's arguments, its launch)
SOURCES = {
    'flash_fwd_sm90': ('flash_fwd_sm90', forward_args, flash.launch_fwd),
    'flash_bwd_sm90': ('flash_bwd_sm90', backward_args, flash.launch_bwd),
    'fwd_T_sm90': ('flash_fwd_sm90', token_minor_args, launch_fwd_T),
}


def variant_library(path: Path, library: str) -> ctypes.CDLL:
    """``path`` built as ``_build`` builds its sources and bound with
    ``library``'s signatures; prints ``nvcc``'s ``ptxas`` lines."""
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
    for fn, (restype, argtypes) in _build.SIGNATURES[library].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('form', choices=sorted(SOURCES))
    p.add_argument('variant', type=Path)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError('this tool times CUDA kernels and needs a card')
    library, make_args, launch = SOURCES[a.form]
    libs = {'source': _build.library(library),
            'variant': variant_library(a.variant, library)}
    args = make_args()

    def run(lib):
        return launch(library, *args, lib=lib)

    equal = all(map(torch.equal, run(libs['source']), run(libs['variant'])))
    samples = {side: [] for side in libs}
    for side in ('source', 'variant', 'variant', 'source'):
        samples[side].append(benchmark(run, libs[side], reps=CUDA_REPS,
                                       device='cuda') * 1e3)
    ms = {side: sum(s) / len(s) for side, s in samples.items()}
    print(f'{a.form} q {tuple(args[0].shape)}: source {ms["source"]:.4f} ms, '
          f'variant {ms["variant"]:.4f} ms '
          f'({ms["variant"] / ms["source"]:.4f}); samples {samples}; '
          f'outputs bit-equal: {equal}', flush=True)
    return {'ms': ms, 'samples': samples, 'bit_equal': equal}


if __name__ == '__main__':
    main(sys.argv[1:])
