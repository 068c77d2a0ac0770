"""The port's attention probes (``esme_tpu_torch/tools``) against the JAX
package's tools, whose Pallas kernels run in interpret mode on the CPU:

* K14 ``tools/fwd_T_experiment.py:fwd_T`` against the port's ``fwd_T``
  (H5's plain version), fp32, D = 64 and 32;
* K17 ``tools/flash_variants.py:variant_kernel``, each of its 11 modes,
  under a grid written here with the BlockSpecs of the round-4 layout it
  was written for (q head-major ``(H, T, D)`` in ``(hb, bq, D)`` blocks,
  q's segment ids a column ``(T, 1)``, k's a row ``(1, T)``, k and v
  token-minor ``(hb, D, bk)``: today's ``flash._fwd`` passes q
  token-minor, and the tool's own ``run`` fails there), against
  ``variant_fwd_plain`` (H6's) at the same 256x256 tiles and head groups;
  that plain version's walk of H1's Hopper form (128-key stages) against
  H1's plain version, the TPU walk in the modes that do not depend on it,
  and the tile an odd span's last stage reads;
* K15 ``tools/decompose_bwd.py:dq_variant``/``dkv_variant``, each of the
  7 modes and ``real``, swapped into ``esme_tpu.ops.flash`` as the tool
  swaps them and run through ``flash._bwd(interpret=True)``, against
  ``dq_variant_plain``/``dkv_variant_plain`` (H7's), the dk/dv pass also
  over the union spans H2's Hopper form walks (``union_spans``), given
  to both as the q-tile spans (H2's Hopper form at D = 64 rounds them out
  to 128-row stages, ``stage_spans``);
* K16 ``tools/profile_attn.py``'s four probe kernels, closures of its
  ``main`` and ``extra`` rebuilt from their code objects and run under
  ``pallas_call(interpret=True)`` with the tool's BlockSpecs, against the
  H8 plain versions.

Gates, fp32: atol 2e-5 and rtol 1e-4 (the flash gate of
``tests/test_torch_flash.py``: the same fp32 arithmetic, summed in
another order). Where a mode's values are large or sum what they touch
(``sumfree``, ``noexp``, ``nothing``, ``mm_only``, ``dma``) the gate is
relative to the tensor's largest value: |Δ| <= 1e-5·max|ref|. NaN
(``noexp``'s lse, the log of a negative sum) must be NaN on both sides.
``bf16exp`` rounds p to bf16 on both sides, in two libraries' exp:
|Δ| <= 2^-8 there.
"""

import functools
import math
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from esme_tpu.ops import flash as jflash
from esme_tpu.ops import segment as jseg
from esme_tpu_torch import tools as ttools
from esme_tpu_torch.ops import flash as tflash
from esme_tpu_torch.tools import decompose_bwd as tdb
from esme_tpu_torch.tools import flash_variants as tfv
from esme_tpu_torch.tools import fwd_T_experiment as tft
from esme_tpu_torch.tools import profile_attn as tpa

F32 = dict(atol=2e-5, rtol=1e-4)
LARGE_REL = 1e-5
BF16_ATOL = 2.0 ** -8
LARGE = ('sumfree', 'noexp', 'nothing', 'mm_only', 'dma')
H, D, T, BQ, BK = 4, 64, 1024, 256, 256
LENS = [130, 7, 300, 256, 200, 90]            # a tail of 41 tokens


@pytest.fixture(scope='module')
def jtools():
    """The JAX tools, imported here: three of them turn on JAX's
    persistent compilation cache when imported, for the whole process;
    the test worker's settings are put back at once."""
    names = ('jax_compilation_cache_dir',
             'jax_persistent_cache_min_compile_time_secs')
    saved = {n: getattr(jax.config, n) for n in names}
    try:
        from tools import decompose_bwd, flash_variants, fwd_T_experiment, \
            profile_attn
    finally:
        for n, v in saved.items():
            jax.config.update(n, v)
    return types.SimpleNamespace(fwd_T=fwd_T_experiment, fv=flash_variants,
                                 db=decompose_bwd, pa=profile_attn)


def _seg(lens, total):
    cu = np.cumsum([0, *lens]).astype(np.int32)
    return np.array(jseg.segment_ids_from_cu_lens(jnp.asarray(cu), total))


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(got, ref, mode=''):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    got, ref = np.nan_to_num(got), np.nan_to_num(ref)
    if mode in LARGE:
        assert np.abs(got - ref).max() <= LARGE_REL * np.abs(ref).max()
    elif mode == 'bf16exp':
        np.testing.assert_allclose(got, ref, atol=BF16_ATOL, rtol=0)
    else:
        np.testing.assert_allclose(got, ref, **F32)


def _thd(x_htd):
    """(H, T, D) numpy -> (T, H·D) torch."""
    x = np.asarray(x_htd, np.float32)
    return _t(x.transpose(1, 0, 2).reshape(x.shape[1], -1))


def _hdt_to_thd(x_hdt):
    x = np.asarray(x_hdt, np.float32)
    return _t(x.transpose(2, 0, 1).reshape(x.shape[2], -1))


# ---------------------------------------------------------------------------
# K14: the transposed-score forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('d', [64, 32])
def test_fwd_T_matches_jax(jtools, d):
    seg = _seg(LENS, T)
    qT, kT, vT = (_normal((H, d, T), d + i) for i in range(3))
    ks, ke = jflash.block_spans(jnp.asarray(seg), BQ, BK)[:2]
    o_j, lse_j = jtools.fwd_T.fwd_T(
        jnp.asarray(qT), jnp.asarray(kT), jnp.asarray(vT),
        jnp.asarray(seg).reshape(1, T), jnp.asarray(seg).reshape(T, 1), ks,
        ke, block_q=BQ, block_k=BK, head_block=2,
        max_span=jflash._span_cap(T, BQ, BK, max(LENS)),
        scale=1 / math.sqrt(d), interpret=True)
    tseg = torch.from_numpy(seg)
    spans = tflash.block_spans(tseg, tft.BLOCK_Q, tft.BLOCK_K)
    before = tft.fwd_T.launches
    o_t, lse_t = tft.fwd_T(_t(qT), _t(kT), _t(vT), tseg, *spans)
    assert tft.fwd_T.launches == before          # the CPU runs the plain
    _close(o_t, o_j)
    _close(lse_t, np.asarray(lse_j)[:, 0])


# ---------------------------------------------------------------------------
# K17: H1's ablation modes
# ---------------------------------------------------------------------------

def _variant_call(kernel, q, kT, vT, seg, kstart, kend, hb, max_span):
    """``variant_kernel`` over the grid and BlockSpecs of the round-4
    layout: q head-major, k and v token-minor."""
    nqb = T // BQ

    def kv_index(g, i, jj, ks, ke):
        return (g, 0, jnp.minimum(ks[i] + jj, ke[i] - 1))

    def segk_index(g, i, jj, ks, ke):
        return (0, jnp.minimum(ks[i] + jj, ke[i] - 1))

    vmem = pltpu.VMEM
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2, grid=(H // hb, nqb, max_span),
        in_specs=[
            pl.BlockSpec((hb, BQ, D), lambda g, i, jj, *_: (g, i, 0),
                         memory_space=vmem),
            pl.BlockSpec((BQ, 1), lambda g, i, jj, *_: (i, 0),
                         memory_space=vmem),
            pl.BlockSpec((hb, D, BK), kv_index, memory_space=vmem),
            pl.BlockSpec((hb, D, BK), kv_index, memory_space=vmem),
            pl.BlockSpec((1, BK), segk_index, memory_space=vmem),
        ],
        out_specs=[
            pl.BlockSpec((hb, BQ, D), lambda g, i, jj, *_: (g, i, 0),
                         memory_space=vmem),
            pl.BlockSpec((hb, BQ, 1), lambda g, i, jj, *_: (g, i, 0),
                         memory_space=vmem),
        ],
        scratch_shapes=[vmem((hb, BQ, 1), jnp.float32),
                        vmem((hb, BQ, 1), jnp.float32),
                        vmem((hb, BQ, D), jnp.float32)])
    return pl.pallas_call(
        kernel, grid_spec=grid_spec,
        out_shape=[jax.ShapeDtypeStruct((H, T, D), jnp.float32),
                   jax.ShapeDtypeStruct((H, T, 1), jnp.float32)],
        interpret=True,
    )(kstart, kend, q, seg.reshape(T, 1), kT, vT, seg.reshape(1, T))


@pytest.mark.parametrize('mode', list(tfv.MODES))
def test_flash_variant_matches_jax(jtools, mode):
    hb = 2
    seg = _seg(LENS, T)
    q = _normal((H, T, D), 1)
    kT, vT = _normal((H, D, T), 2), _normal((H, D, T), 3)
    jseg_ = jnp.asarray(seg)
    ks, ke = jflash.block_spans(jseg_, BQ, BK)[:2]
    kernel = functools.partial(jtools.fv.variant_kernel, scale=0.125,
                               mode=mode)
    o_j, lse_j = _variant_call(kernel, jnp.asarray(q), jnp.asarray(kT),
                               jnp.asarray(vT), jseg_, ks, ke, hb,
                               jflash._span_cap(T, BQ, BK, max(LENS)))
    o_t, lse_t = tfv.variant_fwd_plain(
        mode, _thd(q), _hdt_to_thd(kT), _hdt_to_thd(vT),
        torch.from_numpy(seg), torch.from_numpy(np.array(ks)),
        torch.from_numpy(np.array(ke)), H, scale=0.125, block_q=BQ,
        block_k=BK, head_block=hb, exp2_bf16=False)
    _close(o_t, np.asarray(o_j).transpose(1, 0, 2).reshape(T, H * D), mode)
    _close(lse_t, np.asarray(lse_j)[..., 0], mode)


def test_flash_variant_wrapper_runs_plain_on_cpu():
    """On the CPU the H6 wrapper is its plain version at the walk of H1's
    route (the Hopper form's at D = 64), launches nothing, and its
    baseline is H1's plain version."""
    seg = torch.from_numpy(_seg(LENS, T))
    q, k, v = (_t(_normal((T, H * D), i)) for i in range(3))
    spans = tflash.block_spans(seg, tflash.BLOCK_Q, tflash.BLOCK_K)
    o, lse = tfv.variant_fwd('baseline', q, k, v, seg, *spans, H)
    o_p, lse_p = tflash.segment_flash_fwd_plain(q, k, v, seg, *spans, H)
    _close(o, o_p)
    _close(lse, lse_p)
    assert tfv.variant_fwd.launches == 0
    with pytest.raises(ValueError, match='unknown mode'):
        tfv.variant_fwd('nomode', q, k, v, seg, *spans, H)


def _fwd_case(seed=40):
    seg = torch.from_numpy(_seg(LENS, T))
    q, k, v = (_t(_normal((T, H * D), seed + i)) for i in range(3))
    return q, k, v, seg, tflash.block_spans(seg, tflash.BLOCK_Q,
                                            tflash.BLOCK_K)


def test_flash_variant_hopper_walk_baseline_is_h1():
    """The Hopper form's walk (128-key stages of paired 64-key tiles, odd
    spans reading the tile after the span) computes H1 in ``baseline``:
    H1's plain version within the fp32 gate."""
    q, k, v, seg, spans = _fwd_case()
    assert any((e - s) % 2 for s, e in zip(*map(torch.Tensor.tolist, spans)))
    o, lse = tfv.variant_fwd_plain('baseline', q, k, v, seg, *spans, H,
                                   library='flash_fwd_sm90')
    o_p, lse_p = tflash.segment_flash_fwd_plain(q, k, v, seg, *spans, H)
    _close(o, o_p)
    _close(lse, lse_p)


@pytest.mark.parametrize('mode', ['maxfree', 'nomax', 'noexp'])
def test_flash_variant_walk_free_modes_agree(mode):
    """The modes without a running max give the same o and lse whatever
    the walk: the TPU tool's (256x256 tiles) and the Hopper form's (128
    rows over 128-key stages) agree within the fp32 gate (``_close``).
    ``noexp`` sums p = s/2 + 0.1 over every key it walks, the masked ones
    (s = -1e30) included, so its o depends on the walk: only its lse
    (NaN where l < 0, -1e30 elsewhere, on both sides) is compared."""
    q, k, v, seg, spans = _fwd_case()
    hopper = tfv.variant_fwd_plain(mode, q, k, v, seg, *spans, H,
                                   library='flash_fwd_sm90')
    tpu_spans = tflash.block_spans(seg, BQ, BK)
    tpu = tfv.variant_fwd_plain(mode, q, k, v, seg, *tpu_spans, H,
                                block_q=BQ, block_k=BK, exp2_bf16=False)
    if mode != 'noexp':
        _close(hopper[0], tpu[0])
    _close(hopper[1], tpu[1], mode)


def test_flash_variant_odd_span_extra_tile_changes_no_baseline_row():
    """An odd span's last stage reads the tile after the span: its keys
    are masked out of every row of the block, so ``baseline``'s rows stay
    bit-equal when that tile's k and v change, while ``nomask``, which
    reads it unmasked, moves."""
    q, k, v, seg, spans = _fwd_case()
    ks, ke = spans[0].tolist(), spans[1].tolist()
    b = next(i for i in range(len(ks)) if (ke[i] - ks[i]) % 2
             and (ke[i] + 1) * tflash.BLOCK_K <= T)
    rows = slice(b * tflash.BLOCK_Q, (b + 1) * tflash.BLOCK_Q)
    extra = slice(ke[b] * tflash.BLOCK_K, (ke[b] + 1) * tflash.BLOCK_K)
    k2, v2 = k.clone(), v.clone()
    k2[extra] *= 1e3
    v2[extra] = 1e3
    hopper = 'flash_fwd_sm90'
    for mode, same in (('baseline', True), ('nomask', False)):
        o, lse = tfv.variant_fwd_plain(mode, q, k, v, seg, *spans, H,
                                       library=hopper)
        o2, lse2 = tfv.variant_fwd_plain(mode, q, k2, v2, seg, *spans, H,
                                         library=hopper)
        assert (torch.equal(o[rows], o2[rows])
                and torch.equal(lse[:, rows], lse2[:, rows])) == same, mode


def test_variant_fwd_library_argument_on_cpu():
    """``variant_fwd`` takes a key of ``FORMS``, the libraries of
    ``FWD_ROUTES`` (H1's route, the Hopper form, when none): on the CPU it
    runs the plain version of that form's walk and launches nothing; any
    other name is refused, by the plain version too. Without a library
    the plain version walks one tile per step, the mma.sync form's walk
    at its tiles."""
    q, k, v, seg, spans = _fwd_case()
    args = (q, k, v, seg, *spans, H)
    assert set(tfv.FORMS) == set(tflash.FWD_ROUTES)
    for library in tfv.FORMS:
        got = tfv.variant_fwd('nomask', *args, library=library)
        ref = tfv.variant_fwd_plain('nomask', *args, library=library)
        assert all(map(torch.equal, got, ref))
    assert all(map(torch.equal, tfv.variant_fwd_plain('nomask', *args),
                   tfv.variant_fwd_plain('nomask', *args,
                                         library='flash_fwd')))
    hopper = tfv.variant_fwd('nomask', *args)
    assert all(map(torch.equal, hopper, tfv.variant_fwd(
        'nomask', *args, library='flash_fwd_sm90')))
    assert not torch.equal(hopper[0], tfv.variant_fwd(
        'nomask', *args, library='flash_fwd')[0])
    assert tfv.variant_fwd.launches == 0
    for bad in ('flash_bwd_sm90', 'sm90'):
        with pytest.raises(ValueError, match='unknown library'):
            tfv.variant_fwd('baseline', *args, library=bad)
        with pytest.raises(ValueError, match='unknown library'):
            tfv.variant_fwd_plain('baseline', *args, library=bad)


# ---------------------------------------------------------------------------
# K15: H2's ablation modes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _bwd_case():
    seg = _seg(LENS, T)
    qT, kT, vT, doT = (_normal((H, D, T), 10 + i) for i in range(4))
    jseg_ = jnp.asarray(seg)
    spans = jflash.block_spans(jseg_, BQ, BK)
    cap = jflash._span_cap(T, BQ, BK, max(LENS))
    args = [jnp.asarray(x) for x in (qT, kT, vT)]
    oT, lse = jflash._fwd(*args, jseg_.reshape(1, T), jseg_.reshape(T, 1),
                          *spans[:2], block_q=BQ, block_k=BK, head_block=H,
                          max_span=cap, scale=1 / math.sqrt(D),
                          interpret=True)
    delta = jnp.sum(jnp.asarray(doT) * oT, axis=1, keepdims=True)
    return seg, (qT, kT, vT, doT), spans, cap, lse, delta


@functools.lru_cache(maxsize=None)
def _jax_bwd(mode):
    """dq, dk, dv of ``flash._bwd`` with the kernels ``esme_tpu.ops.flash``
    holds when first called for ``mode`` (the caller swaps them)."""
    seg, xs, spans, cap, lse, delta = _bwd_case()
    jseg_ = jnp.asarray(seg)
    qT, kT, vT, doT = (jnp.asarray(x) for x in xs)
    return tuple(np.asarray(g) for g in jflash._bwd(
        qT, kT, vT, jseg_.reshape(1, T), jseg_.reshape(T, 1), lse, delta,
        doT, *spans, block_q=BQ, block_k=BK, max_span_q=cap, max_span_k=cap,
        scale=1 / math.sqrt(D), interpret=True))


@pytest.mark.parametrize('kernel', ['dq', 'dkv'])
@pytest.mark.parametrize('mode', list(tdb.MODES))
def test_bwd_variant_matches_jax(jtools, monkeypatch, mode, kernel):
    # the swap of the tool's variants into esme_tpu.ops.flash, as its
    # own time_dq/time_dkv make it, undone by monkeypatch after the test
    if mode != 'real':
        monkeypatch.setattr(jflash, '_dq_kernel', functools.partial(
            jtools.db.dq_variant, mode=mode))
        monkeypatch.setattr(jflash, '_dkv_kernel', functools.partial(
            jtools.db.dkv_variant, mode=mode))
    dq_j, dk_j, dv_j = _jax_bwd(mode)
    seg, xs, spans, _, lse, delta = _bwd_case()
    q2, k2, v2, do2 = (_hdt_to_thd(x) for x in xs)
    lse_t, delta_t = _t(np.asarray(lse)[:, 0]), _t(np.asarray(delta)[:, 0])
    tspans = [torch.from_numpy(np.array(s)) for s in spans]
    tseg = torch.from_numpy(seg)
    if kernel == 'dq':
        got = (tdb.dq_variant_plain(mode, q2, k2, v2, do2, lse_t, delta_t,
                                    tseg, *tspans[:2], H, block_q=BQ,
                                    block_k=BK),)
        ref = (dq_j,)
    else:
        got = tdb.dkv_variant_plain(mode, q2, k2, v2, do2, lse_t, delta_t,
                                    tseg, *tspans[2:], H, block_k=BK,
                                    block_q=BQ)
        ref = (dk_j, dv_j)
    for a, b in zip(got, ref):
        _close(a, _hdt_to_thd(b), mode)


@functools.lru_cache(maxsize=None)
def _jax_bwd_union(mode):
    """dk, dv of ``flash._bwd`` over the union q-tile spans, with the
    kernels ``esme_tpu.ops.flash`` holds when first called for ``mode``."""
    seg, xs, spans, cap, lse, delta = _bwd_case()
    jseg_ = jnp.asarray(seg)
    qT, kT, vT, doT = (jnp.asarray(x) for x in xs)
    qs, qe = tdb.union_spans(*(torch.from_numpy(np.array(x))
                               for x in spans[2:]))
    cap_q = max(cap, int((qe - qs).max()))
    _, dk, dv = jflash._bwd(
        qT, kT, vT, jseg_.reshape(1, T), jseg_.reshape(T, 1), lse, delta,
        doT, *spans[:2], jnp.asarray(qs.numpy()), jnp.asarray(qe.numpy()),
        block_q=BQ, block_k=BK, max_span_q=cap_q, max_span_k=cap,
        scale=1 / math.sqrt(D), interpret=True)
    return np.asarray(dk), np.asarray(dv)


@pytest.mark.parametrize('mode', list(tdb.MODES))
def test_bwd_variant_union_spans_match_jax(jtools, monkeypatch, mode):
    """The dk/dv pass at the Hopper form's walk: each k block over the
    union of its pair's q-tile spans, which adds tiles the modes without a
    mask (and ``dma``, ``no_acc``) count."""
    if mode != 'real':
        monkeypatch.setattr(jflash, '_dkv_kernel', functools.partial(
            jtools.db.dkv_variant, mode=mode))
    dk_j, dv_j = _jax_bwd_union(mode)
    seg, xs, spans, _, lse, delta = _bwd_case()
    q2, k2, v2, do2 = (_hdt_to_thd(x) for x in xs)
    lse_t, delta_t = _t(np.asarray(lse)[:, 0]), _t(np.asarray(delta)[:, 0])
    qs, qe = tdb.union_spans(*(torch.from_numpy(np.array(x))
                               for x in spans[2:]))
    assert not torch.equal(qs, torch.from_numpy(np.array(spans[2])))
    got = tdb.dkv_variant_plain(mode, q2, k2, v2, do2, lse_t, delta_t,
                                torch.from_numpy(seg), qs, qe, H, block_k=BK,
                                block_q=BQ)
    for a, b in zip(got, (dk_j, dv_j)):
        _close(a, _hdt_to_thd(b), mode)


def test_union_spans_pair_the_k_blocks():
    """Each pair of 64-row k blocks walks the union of its two spans; a
    last odd block keeps its own; empty spans (start past end) drop out."""
    i32 = functools.partial(torch.tensor, dtype=torch.int32)
    qs, qe = tdb.union_spans(i32([0, 1, 9, 2, 5]), i32([2, 3, 0, 4, 7]))
    assert qs.tolist() == [0, 0, 2, 2, 5] and qe.tolist() == [3, 3, 4, 4, 7]
    assert qs.dtype == qe.dtype == torch.int32


@pytest.mark.parametrize('D', tflash.HEAD_DIMS)
def test_fwd_T_route_is_a_static_rule(D):
    """H5 runs H1's Hopper kernel (token-minor layout) at the tools' head dims
    when T % 8 == 0, the mma.sync form otherwise; each route's entry and
    error string are bound C functions."""
    from esme_tpu_torch import _build
    for T in (1000, 1001, 1024, 8165, 50176):
        want = 'flash_fwd_sm90' \
            if D in ttools.SM90_HEAD_DIMS and T % 8 == 0 else 'flash_fwd_t'
        assert tft.fwd_T_route(D, T) == want
    for name, fns in tft.FWD_T_ROUTES.items():
        assert set(fns) <= set(_build.SIGNATURES[name])


def test_bwd_variant_library_argument_on_cpu():
    """``bwd_variant`` takes a key of ``BWD_ROUTES`` (H2's route when
    none): on the CPU each form's plain walk, the Hopper form's dk/dv over
    its 128-row stages (the union spans rounded out); any other name is
    refused."""
    seg = torch.from_numpy(_seg(LENS, T))
    q, k, v, do = (_t(_normal((T, H * D), 30 + i)) for i in range(4))
    spans = tflash.flash_spans(seg)
    o, lse = tflash.segment_flash_fwd_plain(q, k, v, seg, *spans[:2], H)
    args = (q, k, v, do, lse, tflash.attention_delta(o, do, H), seg, *spans,
            H)
    hopper = tdb.bwd_variant('dkv', 'no_mask', *args)
    assert all(map(torch.equal, hopper, tdb.bwd_variant(
        'dkv', 'no_mask', *args, library='flash_bwd_sm90')))
    assert all(map(torch.equal, hopper, tdb.dkv_variant_plain(
        'no_mask', *args[:7], *tdb.stage_spans(*spans[2:], 128), H)))
    mma_sync = tdb.bwd_variant('dkv', 'no_mask', *args, library='flash_bwd')
    assert all(map(torch.equal, mma_sync, tdb.dkv_variant_plain(
        'no_mask', *args[:7], *spans[2:], H)))
    assert not torch.equal(hopper[0], mma_sync[0])
    assert tdb.bwd_variant.launches == 0
    for bad in ('flash_fwd_sm90', 'sm90'):
        with pytest.raises(ValueError, match='unknown library'):
            tdb.bwd_variant('dq', 'real', *args, library=bad)


def test_bwd_variant_wrapper_runs_plain_on_cpu():
    """On the CPU the H7 wrapper is its plain version at H2's tiles,
    launches nothing, and ``real`` is H2's plain version."""
    seg = torch.from_numpy(_seg(LENS, T))
    q, k, v, do = (_t(_normal((T, H * D), 20 + i)) for i in range(4))
    spans = tflash.flash_spans(seg)
    o, lse = tflash.segment_flash_fwd_plain(q, k, v, seg, *spans[:2], H)
    delta = tflash.attention_delta(o, do, H)
    args = (q, k, v, do, lse, delta, seg, *spans, H)
    ref = tflash.segment_flash_bwd_plain(*args)
    _close(tdb.bwd_variant('dq', 'real', *args), ref[0])
    for a, b in zip(tdb.bwd_variant('dkv', 'real', *args), ref[1:]):
        _close(a, b)
    assert tdb.bwd_variant.launches == 0
    with pytest.raises(ValueError, match='unknown mode'):
        tdb.bwd_variant('dq', 'nomode', *args)


# ---------------------------------------------------------------------------
# K16: the ceiling probes
# ---------------------------------------------------------------------------

def _closure(fn, name):
    """The function ``name`` defined inside ``fn``, rebuilt from its code
    object over ``fn``'s module globals (none of them has free
    variables)."""
    code = next(c for c in fn.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == name)
    assert not code.co_freevars
    return types.FunctionType(code, fn.__globals__)


def test_vpu_probe_matches_jax(jtools):
    kernel = functools.partial(_closure(jtools.pa.main, 'vpu_kernel'),
                               passes=4)
    hb, bq, bk = 2, 64, 128
    s = _normal((hb, bq, bk), 30) * 4
    out = pl.pallas_call(
        kernel, grid=(3,),
        in_specs=[pl.BlockSpec((hb, bq, bk), lambda i: (0, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((hb, bq, 1), lambda i: (0, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((hb, bq, 1), jnp.float32),
        interpret=True)(jnp.asarray(s))
    _close(tpa.vpu_plain(_t(s)), out)


def test_mxu_probe_matches_jax(jtools):
    kernel = _closure(jtools.pa.main, 'mxu_kernel')
    hb, bq, bk = 2, 64, 128
    q, k, v = _normal((hb, bq, D), 31), _normal((hb, bk, D), 32), \
        _normal((hb, bk, D), 33)
    out = pl.pallas_call(
        kernel, grid=(2,),
        in_specs=[pl.BlockSpec((hb, bq, D), lambda i: (0, 0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((hb, bk, D), lambda i: (0, 0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((hb, bk, D), lambda i: (0, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((hb, bq, D), lambda i: (0, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((hb, bq, D), jnp.float32),
        interpret=True)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _close(tpa.mxu_plain(_t(q), _t(k), _t(v)), out)


@pytest.mark.parametrize('span', [1, 3])
def test_dma_probe_matches_jax(jtools, span):
    kernel = _closure(jtools.pa.main, 'dma_kernel')
    hb, bq, bk = 2, 256, 128
    nqb, nkb = T // bq, T // bk
    q, k, v = (_normal((H, T, D), 40 + i) for i in range(3))

    def kv(g, i, j):
        return (g, (i + j) % nkb, 0)
    out = pl.pallas_call(
        kernel, grid=(H // hb, nqb, span),
        in_specs=[pl.BlockSpec((hb, bq, D), lambda g, i, j: (g, i, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((hb, bk, D), kv, memory_space=pltpu.VMEM),
                  pl.BlockSpec((hb, bk, D), kv, memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((hb, bq, D), lambda g, i, j: (g, i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((H, T, D), jnp.float32),
        interpret=True)(*(jnp.asarray(x) for x in (q, k, v)))
    got = tpa.dma_plain(_thd(q), _thd(k), _thd(v), span, H, block_q=bq,
                        block_k=bk, head_block=hb)
    _close(got, _thd(out))


@pytest.mark.parametrize('span', [1, 3])
def test_dma_t_probe_matches_jax(jtools, span):
    probe = _closure(jtools.pa.extra, 'dma_kernel')

    def kernel(k_ref, v_ref, o_ref):
        # interpret mode fills an output block with NaN before its first
        # write, and the probe's `o_ref[:] * 0` takes the block's old
        # contents to be finite: zero it at the group's first step
        @pl.when((pl.program_id(1) == 0) & (pl.program_id(2) == 0))
        def _():
            o_ref[:] = jnp.zeros_like(o_ref)
        probe(k_ref, v_ref, o_ref)
    hb, bq, bk = 2, 256, 128
    nqb, nkb = T // bq, T // bk
    kT, vT = _normal((H, D, T), 50), _normal((H, D, T), 51)

    def kv(g, i, j):
        return (g, 0, (i + j) % nkb)
    out = pl.pallas_call(
        kernel, grid=(H // hb, nqb, span),
        in_specs=[pl.BlockSpec((hb, D, bk), kv, memory_space=pltpu.VMEM),
                  pl.BlockSpec((hb, D, bk), kv, memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((hb, 8, 128), lambda g, i, j: (g, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((H, 8, 128), jnp.float32),
        interpret=True)(jnp.asarray(kT), jnp.asarray(vT))
    got = tpa.dma_t_plain(_t(kT), _t(vT), span, block_q=bq, block_k=bk,
                          head_block=hb)
    # the TPU probe's output block holds its head group's last step
    ref = np.asarray(out)[::hb, 0, 0]
    _close(got[:, -1], ref)
    assert np.all(np.asarray(out) == np.repeat(ref, hb)[:, None, None])


def test_probe_wrappers_run_plain_on_cpu():
    """On the CPU each H8 wrapper is its plain version at H1's tiles and
    launches nothing; the streaming probes walk H1's step counts."""
    seg = torch.from_numpy(_seg(LENS, T))
    q, k, v = (_t(_normal((T, H * D), 60 + i)) for i in range(3))
    ks, ke = tflash.block_spans(seg, tflash.BLOCK_Q, tflash.BLOCK_K)
    s = _t(_normal((128, 64), 63))
    assert torch.equal(tpa.vpu(s, ks, ke, H)[2], tpa.vpu_plain(s)[:, 0])
    qt, kt = q[:128, :64].contiguous(), k[:64, :64].contiguous()
    assert torch.equal(tpa.mxu(qt, kt, ks, ke, H)[1],
                       tpa.mxu_plain(qt, kt, kt))
    assert torch.equal(tpa.dma(q, k, v, ks, ke, H),
                       tpa.dma_plain(q, k, v, ke - ks, H))
    kT = k.view(T, H, D).permute(1, 2, 0).contiguous()
    vT = v.view(T, H, D).permute(1, 2, 0).contiguous()
    assert torch.equal(tpa.dma_t(kT, vT, ks, ke),
                       tpa.dma_t_plain(kT, vT, ke - ks))
    assert [f.launches for f in (tpa.vpu, tpa.mxu, tpa.dma, tpa.dma_t)] \
        == [0, 0, 0, 0]


# ---------------------------------------------------------------------------
# H8's streaming probes: the Hopper form's walk, forms and pair mode
# ---------------------------------------------------------------------------

def _walk_steps(seed, nqb=13, nkb=16):
    """Random step counts in [0, nkb] with zeros (block 0, and the whole
    pair 4, 5), odd counts, and walks past ``nkb - 1`` (block 12, alone
    in its pair at nqb = 13)."""
    n = np.random.default_rng(seed).integers(0, nkb + 1, nqb)
    n[0] = n[4] = n[5] = 0
    n[1], n[12] = 5, 7
    return n


@pytest.mark.parametrize('cluster', [1, 2])
@pytest.mark.parametrize('seed', range(3))
def test_stream_walk_covers_the_tpu_walk(cluster, seed):
    """``stream_walk`` (the walk ``csrc/probes_sm90.cu`` launches): each
    block's tiles, read off its unit's stages in order, are the TPU
    probe's ``(i + j) % nkb`` for ``j < n_i``; its last one is
    ``_last_tiles``'s; a stage holds one or two tiles, one box of two only
    where they are adjacent and go to the same blocks, every box to some
    block; a pair loads the union of its blocks' walks, each position
    once, and never more than its blocks read."""
    nqb, nkb = 13, 16
    n = _walk_steps(seed, nqb, nkb)
    assert any(i + m > nkb for i, m in enumerate(n))   # a walk wraps
    units = tpa.stream_walk(n, nkb, cluster)
    assert len(units) == -(-nqb // cluster)
    last, read = tpa._last_tiles(torch.from_numpy(n), nqb, nkb, 1)
    for u, stages in enumerate(units):
        i0 = u * cluster
        ns = [int(n[i0 + r]) if i0 + r < nqb else 0 for r in range(cluster)]
        for stage in stages:
            assert 1 <= sum(t for _, t, _ in stage) <= 2
            for t0, t, mask in stage:
                assert 0 < mask < 1 << cluster and 0 <= t0 < nkb
                assert t == 1 or (len(stage) == 1 and t0 + 1 < nkb)
            if len(stage) == 2:
                (a, _, ma), (b, _, mb) = stage
                assert b != a + 1 or mb != ma
        for r, m in enumerate(ns):
            tiles = [t0 + k for stage in stages for t0, t, mask in stage
                     if mask >> r & 1 for k in range(t)]
            assert tiles == [(i0 + r + j) % nkb for j in range(m)]
            if m:
                assert read[i0 + r] and tiles[-1] == int(last[i0 + r])
        positions = {r + j for r, m in enumerate(ns) for j in range(m)}
        assert tpa.walk_tiles([stages]) == len(positions) <= sum(ns)
    assert (tpa.walk_tiles(units) == int(n.sum())) == (cluster == 1)


def test_stream_walk_pairs_load_fewer_tiles():
    """On the probe tool's batch the pair mode's ``work`` counts the tiles
    of the pairs' runs (each shared tile once), fewer than the walks'
    own; both forms load the same tiles one block to a CTA."""
    from esme_tpu_torch.tools import attention_batch
    b = attention_batch(4096, 0, device='cpu', dtype=torch.float32)
    ks, ke = b.spans[:2]
    tile = 2 * tflash.BLOCK_K * 64 * b.q.element_size() * b.H
    kw, one = tpa.work('dma', b)
    assert one == int((ke - ks).sum()) * tile
    _, pair = tpa.work('dma', b, cluster=2)
    units = tpa.stream_walk((ke - ks).tolist(), -(-b.T // 64), 2)
    assert pair == tpa.walk_tiles(units) * tile and pair < 0.8 * one
    assert tpa.work('dma', b, cluster=2)[0] == kw     # the same DRAM bytes


@pytest.mark.parametrize('library', [None, 'probes_sm90', 'probes'])
def test_streaming_probe_forms_run_plain_on_cpu(library):
    """``dma`` and ``dma_t`` take a key of ``FORMS`` (the Hopper form when
    None) and ``dma`` a cluster size of that form: on the CPU each is the
    plain version and launches nothing. Each form's C entries are bound
    and defined in its source."""
    from esme_tpu_torch import _build
    seg = torch.from_numpy(_seg(LENS, T))
    q, k, v = (_t(_normal((T, H * D), 70 + i)) for i in range(3))
    ks, ke = tflash.block_spans(seg, tflash.BLOCK_Q, tflash.BLOCK_K)
    kT = k.view(T, H, D).permute(1, 2, 0).contiguous()
    vT = v.view(T, H, D).permute(1, 2, 0).contiguous()
    name = library or list(tpa.FORMS)[0]
    assert name == 'probes_sm90' or library is not None
    for cluster in tpa.FORMS[name].clusters:
        assert torch.equal(tpa.dma(q, k, v, ks, ke, H, library, cluster),
                           tpa.dma_plain(q, k, v, ke - ks, H))
    assert torch.equal(tpa.dma_t(kT, vT, ks, ke, library),
                       tpa.dma_t_plain(kT, vT, ke - ks))
    assert tpa.dma.launches == tpa.dma_t.launches == 0
    form = tpa.FORMS[name]
    src = (_build.CSRC / f'{name}.cu').read_text()
    for fn in (form.dma, form.dma_t, form.error):
        assert fn in _build.SIGNATURES[name]
        assert re.search(rf'^\S.* {fn}\(', src, re.M), fn


def test_streaming_probe_arguments_refused_on_cpu():
    """An unknown library, or a cluster size the form does not take, is
    refused on the CPU too, before the plain version runs."""
    q = torch.zeros((256, 2 * D))
    kT = torch.zeros((2, D, 256))
    ks = ke = torch.zeros(2, dtype=torch.int32)
    for bad in ('flash_fwd_sm90', 'sm90'):
        with pytest.raises(ValueError, match='unknown library'):
            tpa.dma(q, q, q, ks, ke, 2, library=bad)
        with pytest.raises(ValueError, match='unknown library'):
            tpa.dma_t(kT, kT, ks, ke, library=bad)
    with pytest.raises(ValueError, match='cluster 2: the probes form'):
        tpa.dma(q, q, q, ks, ke, 2, library='probes', cluster=2)
    for cluster in (0, 3, 4):
        with pytest.raises(ValueError, match=f'cluster {cluster}'):
            tpa.dma(q, q, q, ks, ke, 2, cluster=cluster)
    assert set(tpa.RUNS) == set(tpa.calls(
        types.SimpleNamespace(q=q, k=q, v=q, H=2, spans=(ks, ke)),
        (None,) * 5))
    assert all(tpa.RUNS[r][0] == tpa.RUNS[s][0]
               for r, s in tpa.SAME_AS.items())
