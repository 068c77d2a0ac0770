"""Time a variant of H1's, H2's or H5's Hopper source, or of H4's or H8's,
against the source.

    python -m esme_tpu_torch.tools.sm90_ab FORM VARIANT.cu [VARIANT.cu ...]
        [--heads H] [--head-dim D] [--ranks N]

``FORM`` is ``flash_fwd_sm90`` (H1), ``flash_bwd_sm90`` (H2),
``fwd_T_sm90`` (H5's Hopper form, H1's kernel on token-minor operands),
``headsplit_vec`` (H4's vec kernel) or ``probes_sm90`` (H8's streaming
probes on Hopper), and ``VARIANT.cu`` a copy of the form's source,
``csrc/flash_fwd_sm90.cu``, ``csrc/flash_bwd_sm90.cu``,
``csrc/headsplit.cu`` or ``csrc/probes_sm90.cu``, with one change to
measure: it keeps the
source's C entries and may include the headers of ``csrc``. Several
copies may be named: each is timed against the source in turn. All build
at once with ``_build``'s flags (each copy into
``build/esme_tpu_torch/variant/``, so their file names differ), and run
on ``bench.py``'s 50k batch at ESM2-650M's attention (H = 20, D = 64,
bf16; ``--heads 40 --head-dim 128`` is ESM2-15B's; H1 and H5 on the
inference batch, H5's operands made token-minor, and H9 with that batch's
queries over its keys (one rank: Tq = Tk) and on each rank of an N-rank
split of it (``--ranks``, 4 by default: each rank's 50,000 / N queries
over all 50,000 keys, as ``chip_smoke.py:time_rect`` splits it; the
ranks' medians also summed), H9 with its launch order
(``ops/flash.py:fwd_order``) at the head dims of ``ORDER_HEAD_DIMS``,
H2 on the masked-LM batch, both passes and each alone, and H10 with
that batch's queries over its keys (one rank: Tq = Tk) and on each rank
of an N-rank split of it (``--ranks``, each rank's 50,000 / N queries
over all 50,000 keys, as ``chip_smoke.py`` splits the train batch; the
ranks' medians also summed); H4 on the inference batch's q, k, v
and positions, in each move with a token-minor side that the ops make;
H8's dma, alone and in pairs, and dma_t, on the inference batch over
H1's spans) through the wrapper's launch (``ops/flash.py:launch_fwd``,
``launch_bwd``, the pass entry ``esme_flash_bwd_sm90_pass``,
``tools/fwd_T_experiment.py:launch_fwd_T``,
``ops/headsplit.py:launch_relayout('vec', ...)``,
``tools/profile_attn.py:launch_dma``, ``launch_dma_t``) and are timed launch by
launch in turns, source then variant, ``ROUNDS`` rounds after 3 warm-up
calls a side, each launch between CUDA events of its own, so that a drift
of the card's clocks during the run (blocks of 20 calls a side in the
order source, variant, variant, source read up to 18% apart from block to
block on the H100 at D = 128) falls on both sides alike. Prints the
variant's ``ptxas`` lines, each side's median and quartiles in ms, the
variant's ratio of medians and whether its outputs (o and lse; dq, dk and
dv; the moved tensors; the probes' outputs) are bit-equal to the
source's; where a case has a launch order, the source also runs in
q-block order in the same turns (the order's yardstick: the two medians'
ratio, and whether the source's outputs are bit-equal under both). A
copy from before the launch order (whose H9 entry ends at the stream)
takes the order's trailing pointer unread, so it runs in q-block order.
On the card only.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import math
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from .. import _build
from ..ops import flash
from . import (BWD_SEED, FWD_SEED, HEAD_DIM, HEADS, attention_batch,
               thd_to_hdt)
from ..ops import headsplit
from ..ops.rotary import rotary_cos_sin
from .decompose_bwd import backward_inputs
from .fwd_T_experiment import launch_fwd_T
from . import profile_attn


# launches a side, one of each side per round
ROUNDS = 40
# H9's and H10's split: the ranks of phase 20's four-card cells
RANKS = 4
# the side that runs the source in q-block order, in the turns of a case
# that has a launch order
QBLOCK = 'source, q-block order'


def rect_rank_split(b, ranks):
    """H9's arguments on each rank of a ``ranks``-way split of the
    inference batch ``b`` (:func:`attention_batch`), as
    ``chip_smoke.py:time_rect`` splits it (``rank_rows``, ``rect_args``)
    and ``forward_flat_cp`` a forward's tokens: the ids of the batch's
    ``budget`` rows without the ALIGN pad, rank r's queries rows ``[r
    budget / ranks, (r + 1) budget / ranks)`` over all ``budget`` keys,
    H9's spans and its launch order. Returns ``[((lo, hi), (q, k, v,
    seg_q, kstart, kend, H, seg_k, order))]``."""
    from ..models.esm import packed_meta
    budget = b.budget
    seg = packed_meta(torch.as_tensor(b.cu, device=b.device),
                      budget)[0].contiguous()
    k, v = (x[:budget].contiguous() for x in (b.k, b.v))
    out = []
    for r in range(ranks):
        lo, hi = r * budget // ranks, (r + 1) * budget // ranks
        sq = seg[lo:hi].contiguous()
        ks, ke = flash.rect_spans(sq, seg)
        out.append(((lo, hi), (b.q[lo:hi].contiguous(), k, v, sq, ks, ke,
                               b.H, seg, flash.fwd_order(ks, ke))))
    return out


def forward_cases(heads, head_dim, ranks=RANKS):
    """H1 on the inference batch (``'square'``), H9 (``'rect'``) with the
    batch's queries over its keys, the one-rank shape, and H9 on each rank
    of a ``ranks``-way split of the batch (:func:`rect_rank_split`), H9's
    with its launch order (``ops/flash.py:fwd_order``) at the head dims of
    ``ORDER_HEAD_DIMS`` (None at the others, and H1's always): ``{case:
    (kind, (q, k, v, seg_q, kstart, kend, H, seg_k, order))}``."""
    b = attention_batch(seed=FWD_SEED, heads=heads, head_dim=head_dim)
    ordered = head_dim in flash.ORDER_HEAD_DIMS
    h1 = (b.q, b.k, b.v, b.seg, *b.spans[:2], b.H, None, None)
    ks, ke = flash.rect_spans(b.seg, b.seg)
    cases = {'H1': ('square', h1),
             'H9 one rank': ('rect', (*h1[:4], ks, ke, b.H, b.seg,
                                      flash.fwd_order(ks, ke) if ordered
                                      else None))}
    for r, (_, args) in enumerate(rect_rank_split(b, ranks)):
        cases[f'H9 rank {r} of {ranks}'] = \
            ('rect', args if ordered else (*args[:-1], None))
    return cases


def q_block_twin(form, case_args):
    """A forward case's arguments without its launch order, or None where
    the case has none (every case of the other forms)."""
    if form != 'flash_fwd_sm90' or case_args[1][-1] is None:
        return None
    kind, args = case_args
    return kind, (*args[:-1], None)


def launch_forward(library, kind, args, lib=None):
    """One of :func:`forward_cases`' launches on ``library``'s form: o and
    lse of H1 (``kind`` ``'square'``) or of H9 (``'rect'``), with the
    case's launch order or none."""
    seg_k = args[7] if kind == 'rect' else None
    return flash.launch_fwd(library, *args[:7], lib=lib, seg_k=seg_k,
                            order=args[8])


def rank_split(b, ranks):
    """H10's arguments on each rank of a ``ranks``-way split of batch
    ``b`` (:func:`attention_batch` with ``grads``), as
    ``chip_smoke.py:time_rect_bwd`` splits the train batch (and
    ``ShardedMaskedPLM`` a step's): the ids of the batch's ``budget``
    rows without the ALIGN pad, rank r's queries and output gradients
    rows ``[r budget / ranks, (r + 1) budget / ranks)`` over all
    ``budget`` keys, H9's lse (on its route), delta and H10's spans.
    Returns ``[((lo, hi), arguments, seg_k)]``."""
    from ..models.esm import packed_meta
    budget = b.budget
    seg = packed_meta(torch.as_tensor(b.cu, device=b.device),
                      budget)[0].contiguous()
    q, k, v, do = (x[:budget].contiguous() for x in (b.q, b.k, b.v, b.do))
    out = []
    for r in range(ranks):
        lo, hi = r * budget // ranks, (r + 1) * budget // ranks
        sq = seg[lo:hi].contiguous()
        spans = flash.rect_flash_spans(sq, seg)
        qr, dor = q[lo:hi].contiguous(), do[lo:hi].contiguous()
        o, lse = flash.segment_flash_fwd(qr, k, v, sq, *spans[:2], b.H,
                                         seg_k=seg)
        out.append(((lo, hi), (qr, k, v, dor, lse,
                               flash.attention_delta(o, dor, b.H), sq,
                               *spans, b.H), seg))
    return out


def backward_cases(heads, head_dim, ranks=RANKS):
    """H2 on the masked-LM batch, both passes (``'both'``) and each alone
    (``'dkv'``, ``'dq'``), H10 (``'rect'``) with the batch's queries over
    its keys, the one-rank shape, and H10 on each rank of a ``ranks``-way
    split of the batch (``'rank'``, :func:`rank_split`; its arguments end
    with the keys' ids): ``{case: (kind, arguments)}``."""
    b = attention_batch(seed=BWD_SEED, heads=heads, head_dim=head_dim,
                        grads=True)
    lse, delta = backward_inputs(b)
    args = (b.q, b.k, b.v, b.do, lse, delta, b.seg, *b.spans, b.H)
    seg = args[6]
    rect = (*args[:7], *flash.rect_flash_spans(seg, seg), args[-1])
    cases = {'H2': ('both', args), 'H2 dk/dv': ('dkv', args),
             'H2 dq': ('dq', args), 'H10 one rank': ('rect', rect)}
    for r, (_, rank, seg_k) in enumerate(rank_split(b, ranks)):
        cases[f'H10 rank {r} of {ranks}'] = ('rank', (*rank, seg_k))
    return cases


def launch_backward(library, kind, args, lib=None):
    """One of :func:`backward_cases`' launches on ``library``'s form: dq,
    dk and dv of both passes or of H10, dk and dv of the dk/dv pass, dq of
    the dq pass."""
    if kind == 'both':
        return flash.launch_bwd(library, *args, lib=lib)
    if kind == 'rect':
        return flash.launch_bwd(library, *args, lib=lib, seg_k=args[6])
    if kind == 'rank':
        return flash.launch_bwd(library, *args[:-1], lib=lib,
                                seg_k=args[-1])
    q = args[0]
    T, HD = q.shape
    H = args[-1]
    which = ('dkv', 'dq').index(kind)
    outs = [torch.empty_like(q) for _ in range(3)]
    lib = _build.library(library) if lib is None else lib
    rc = lib.esme_flash_bwd_sm90_pass(
        which, 0, *(x.data_ptr() for x in (*args[:11], *outs)), T, H,
        HD // H, 1.0 / math.sqrt(HD // H),
        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, lib, flash.BWD_ROUTES[library][1],
                 f'esme_flash_bwd_sm90_pass ({kind})')
    return tuple(outs[1:]) if kind == 'dkv' else (outs[0],)


def token_minor_args(heads, head_dim):
    """H5's arguments on the inference batch: q, k, v token-minor."""
    b = attention_batch(seed=FWD_SEED, heads=heads, head_dim=head_dim)
    return (*(thd_to_hdt(x, b.H) for x in (b.q, b.k, b.v)), b.seg,
            *b.spans[:2])


def relayout_cases(heads, head_dim):
    """H4's moves with a token-minor side, as the ops make them, on the
    inference batch: ``{move: relayout_heads' arguments}``."""
    b = attention_batch(seed=FWD_SEED, heads=heads, head_dim=head_dim)
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


def probe_cases(heads, head_dim):
    """H8's streaming probes on the inference batch over H1's spans: dma
    alone and in pairs, dma_t on k and v made token-minor: ``{case:
    (probe, cluster size, the launch's arguments)}``."""
    b = attention_batch(seed=FWD_SEED, heads=heads, head_dim=head_dim)
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


# form -> (its library, its cases at (heads, head dim): name -> the
# launch's arguments, its launch)
SOURCES = {
    'flash_fwd_sm90': ('flash_fwd_sm90', forward_cases, launch_forward),
    'flash_bwd_sm90': ('flash_bwd_sm90', backward_cases, launch_backward),
    'fwd_T_sm90': ('flash_fwd_sm90',
                   lambda *hd: {'H5': token_minor_args(*hd)}, launch_fwd_T),
    'headsplit_vec': ('headsplit', relayout_cases, launch_vec),
    'probes_sm90': ('probes_sm90', probe_cases, launch_probe),
}


def interleaved_ms(runs, rounds=ROUNDS, warmup=3):
    """Each of ``runs`` (``{side: fn}``), one launch of each per round,
    every launch between CUDA events of its own: ``{side: sorted ms}``."""
    for run in runs.values():
        for _ in range(warmup):
            run()
    events = {side: [] for side in runs}
    for _ in range(rounds):
        for side, run in runs.items():
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            run()
            end.record()
            events[side].append((start, end))
    torch.cuda.synchronize()
    return {side: sorted(s.elapsed_time(e) for s, e in ev)
            for side, ev in events.items()}


def variant_library(path: Path, library: str) -> ctypes.CDLL:
    """``path`` built as ``_build`` builds its sources and bound with
    ``library``'s signatures (those of its entries that it has: a copy of
    the parent lacks the entries added since); prints ``nvcc``'s ``ptxas``
    lines."""
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
        if not hasattr(lib, fn):   # an entry added after the copy was made
            continue
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def order_note(ms, order_equal):
    """The source's time in q-block order and the launch order's over it,
    where ``ms`` (median ms by side) has a ``QBLOCK`` side; else ''."""
    if QBLOCK not in ms:
        return ''
    return (f'; source in q-block order {ms[QBLOCK]:.4f} ms (launch order '
            f'over it {ms["source"] / ms[QBLOCK]:.4f}, bit-equal: '
            f'{order_equal})')


def compare(form, cases, launch, libs, label):
    """Each of ``cases`` on ``libs``' source and variant in turns, and a
    case with a launch order also on the source in q-block order in the
    same turns (``QBLOCK``: the order's yardstick, under the same drift of
    the card's clocks): prints and returns ``{case: {'ms', 'quartiles',
    'bit_equal', 'order_bit_equal'}}``, with H9's and H10's ranks also
    summed. ``bit_equal``: the variant's outputs are the source's;
    ``order_bit_equal``: the source's are the same in both orders."""
    library = SOURCES[form][0]
    out = {}
    for case, case_args in cases.items():
        runs = {side: functools.partial(launch, library, *case_args, lib=lib)
                for side, lib in libs.items()}
        twin = q_block_twin(form, case_args)
        if twin is not None:
            runs[QBLOCK] = functools.partial(launch, library, *twin,
                                             lib=libs['source'])
        got = {side: run() for side, run in runs.items()}
        equal = all(map(torch.equal, got['source'], got['variant']))
        order_equal = twin is None or \
            all(map(torch.equal, got['source'], got[QBLOCK]))
        times = interleaved_ms(runs)
        ms = {side: t[len(t) // 2] for side, t in times.items()}
        quart = {side: (t[len(t) // 4], t[3 * len(t) // 4])
                 for side, t in times.items()}
        print(f'{form} {case} ({label}): source '
              f'{ms["source"]:.4f} ms, variant '
              f'{ms["variant"]:.4f} ms ({ms["variant"] / ms["source"]:.4f})'
              f'{order_note(ms, order_equal)}; quartiles '
              + ', '.join(f'{side} {lo:.4f}-{hi:.4f}'
                          for side, (lo, hi) in quart.items())
              + f'; outputs bit-equal: {equal}', flush=True)
        out[case] = {'ms': ms, 'quartiles': quart, 'bit_equal': equal,
                     'order_bit_equal': order_equal}
    for kernel in ('H9', 'H10'):
        ranks = [c for c in cases if c.startswith(f'{kernel} rank ')]
        if not ranks:
            continue
        ms = {side: sum(out[c]['ms'][side] for c in ranks)
              for side in out[ranks[0]]['ms']}
        equal = all(out[c]['bit_equal'] for c in ranks)
        order_equal = all(out[c]['order_bit_equal'] for c in ranks)
        print(f'{form} {kernel} summed over the {len(ranks)} ranks: source '
              f'{ms["source"]:.4f} ms, variant {ms["variant"]:.4f} ms '
              f'({ms["variant"] / ms["source"]:.4f})'
              f'{order_note(ms, order_equal)}; every rank\'s '
              f'outputs bit-equal: {equal}', flush=True)
        out[f'{kernel} {len(ranks)} ranks summed'] = {
            'ms': ms, 'bit_equal': equal, 'order_bit_equal': order_equal}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('form', choices=sorted(SOURCES))
    p.add_argument('variant', type=Path, nargs='+',
                   help='one or more copies, built together and each '
                        'timed against the source')
    p.add_argument('--heads', type=int, default=HEADS)
    p.add_argument('--head-dim', type=int, default=HEAD_DIM,
                   choices=flash.HEAD_DIMS)
    p.add_argument('--ranks', type=int, default=RANKS,
                   help='H9\'s (flash_fwd_sm90) and H10\'s '
                        '(flash_bwd_sm90) split: its ranks')
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError('this tool times CUDA kernels and needs a card')
    library, make_cases, launch = SOURCES[a.form]
    with ThreadPoolExecutor(len(a.variant) + 1) as pool:   # nvcc in parallel
        source = pool.submit(_build.library, library)
        variants = list(pool.map(lambda path: variant_library(path, library),
                                 a.variant))
        source = source.result()
    kw = {'ranks': a.ranks} \
        if a.form in ('flash_fwd_sm90', 'flash_bwd_sm90') else {}
    cases = make_cases(a.heads, a.head_dim, **kw)
    label = f'H = {a.heads}, D = {a.head_dim}'
    out = {}
    for path, lib in zip(a.variant, variants):
        print(f'variant {path}', flush=True)
        out[path.name] = compare(a.form, cases, launch,
                                 {'source': source, 'variant': lib}, label)
    return out


if __name__ == '__main__':
    main(sys.argv[1:])
