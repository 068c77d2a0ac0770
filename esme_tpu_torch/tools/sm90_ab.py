"""Time a variant of H1's, H2's or H5's Hopper source, or of H4's or H8's,
against the source.

    python -m esme_tpu_torch.tools.sm90_ab FORM VARIANT.cu

``FORM`` is ``flash_fwd_sm90`` (H1), ``flash_bwd_sm90`` (H2),
``fwd_T_sm90`` (H5's Hopper form, H1's kernel on token-minor operands),
``headsplit_vec`` (H4's vec kernel) or ``probes_sm90`` (H8's streaming
probes on Hopper), and ``VARIANT.cu`` a copy of the form's source,
``csrc/flash_fwd_sm90.cu``, ``csrc/flash_bwd_sm90.cu``,
``csrc/headsplit.cu`` or ``csrc/probes_sm90.cu``, with one change to
measure: it keeps the
source's C entries and may include the headers of ``csrc``. Both build
with ``_build``'s flags (the variant into ``build/esme_tpu_torch/variant/``),
run on ``bench.py``'s 50k batch at ESM2-650M's attention (H = 20, D = 64,
bf16; H1 and H5 on the inference batch, H5's operands made token-minor,
H2 on the masked-LM batch; H4 on the inference batch's q, k, v and
positions, in each move with a token-minor side that the ops make; H8's
dma, alone and in pairs, and dma_t, on the inference batch over H1's
spans) through the wrapper's launch (``ops/flash.py:launch_fwd``,
``launch_bwd``, ``tools/fwd_T_experiment.py:launch_fwd_T``,
``ops/headsplit.py:launch_relayout('vec', ...)``,
``tools/profile_attn.py:launch_dma``, ``launch_dma_t``) and are timed with CUDA
events, 20 calls a side, in the order source, variant, variant, source.
Prints the variant's ``ptxas`` lines, each side's ms, the variant's ratio
and whether its outputs (o and lse; dq, dk and dv; the moved tensors; the
probes' outputs) are bit-equal to the source's. On the card only.
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
from ..ops import headsplit
from ..ops.rotary import rotary_cos_sin
from .decompose_bwd import backward_inputs
from .fwd_T_experiment import launch_fwd_T
from . import profile_attn


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


def relayout_cases():
    """H4's moves with a token-minor side, as the ops make them, on the
    inference batch: ``{move: relayout_heads' arguments}``."""
    b = attention_batch(seed=FWD_SEED)
    H = b.H
    cos, sin = rotary_cos_sin(b.pos, b.D)
    qT, kT, vT = (thd_to_hdt(x, H) for x in (b.q, b.k, b.v))
    q_htd = b.q.view(b.T, H, b.D).transpose(0, 1).contiguous()
    R, N = headsplit.ROT_R, headsplit.ROT_NONE
    RT = headsplit.ROT_RT
    thd3 = (b.q, b.k, b.v)
    return {
        'split_t (K7)': (thd3, 'thd', ('htd', 'hdt', 'hdt'), H, (R, R, N),
                         cos, sin),
        'split_t q_minor (K8, K9)': (thd3, 'thd', 'hdt', H, (R, R, N), cos,
                                     sin),
        'merge_t, R^T (K10)': ((qT,), 'hdt', 'thd', H, (RT,), cos, sin),
        'to thd (fwd_v2)': ((q_htd, kT, vT), ('htd', 'hdt', 'hdt'), 'thd',
                            H),
        'to hdt (flash_tm)': ((b.q,), 'thd', 'hdt', H),
        'from hdt (flash_tm)': ((qT,), 'hdt', 'thd', H),
    }


def launch_vec(library, *args, lib=None):
    """H4's vec kernel on ``relayout_heads``' arguments (``library`` is
    ``'headsplit'``)."""
    return headsplit.launch_relayout('vec', *args, lib=lib)


def probe_cases():
    """H8's streaming probes on the inference batch over H1's spans: dma
    alone and in pairs, dma_t on k and v made token-minor: ``{case:
    (probe, cluster size, the launch's arguments)}``."""
    b = attention_batch(seed=FWD_SEED)
    ks, ke = b.spans[:2]
    kT, vT = (thd_to_hdt(x, b.H) for x in (b.k, b.v))
    dma = (b.q, b.k, b.v, ks, ke, b.H)
    return {'dma': ('dma', 1, dma), 'dma pair': ('dma', 2, dma),
            'dma_t': ('dma_t', 1, (kT, vT, ks, ke))}


def launch_probe(library, probe, cluster, args, lib=None):
    """One of H8's streaming probes on ``library``'s form (``probes_sm90``),
    its output as a tuple."""
    if probe == 'dma':
        return (profile_attn.launch_dma(library, *args, cluster=cluster,
                                        lib=lib),)
    return (profile_attn.launch_dma_t(library, *args, lib=lib),)


# form -> (its library, its cases: name -> the wrapper's arguments, its
# launch)
SOURCES = {
    'flash_fwd_sm90': ('flash_fwd_sm90', lambda: {'H1': forward_args()},
                       flash.launch_fwd),
    'flash_bwd_sm90': ('flash_bwd_sm90', lambda: {'H2': backward_args()},
                       flash.launch_bwd),
    'fwd_T_sm90': ('flash_fwd_sm90', lambda: {'H5': token_minor_args()},
                   launch_fwd_T),
    'headsplit_vec': ('headsplit', relayout_cases, launch_vec),
    'probes_sm90': ('probes_sm90', probe_cases, launch_probe),
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
    library, make_cases, launch = SOURCES[a.form]
    libs = {'source': _build.library(library),
            'variant': variant_library(a.variant, library)}
    out = {}
    for case, args in make_cases().items():
        def run(lib):
            return launch(library, *args, lib=lib)

        equal = all(map(torch.equal, run(libs['source']),
                        run(libs['variant'])))
        samples = {side: [] for side in libs}
        for side in ('source', 'variant', 'variant', 'source'):
            samples[side].append(benchmark(run, libs[side], reps=CUDA_REPS,
                                           device='cuda') * 1e3)
        ms = {side: sum(s) / len(s) for side, s in samples.items()}
        print(f'{a.form} {case}: source {ms["source"]:.4f} ms, variant '
              f'{ms["variant"]:.4f} ms ({ms["variant"] / ms["source"]:.4f}); '
              f'samples {samples}; outputs bit-equal: {equal}', flush=True)
        out[case] = {'ms': ms, 'samples': samples, 'bit_equal': equal}
    return out


if __name__ == '__main__':
    main(sys.argv[1:])
