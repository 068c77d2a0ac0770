"""Context parallelism on the port against the JAX package: the
rectangular block spans, H9's plain version (the rectangular
segment-flash forward) against JAX's ``flash_rect_attention`` (K-rect in
interpret mode), ``attention_rect``, and the whole slice, ranks of
``forward_flat_cp`` and ``context_parallel_log_prob`` against JAX's over
a ``seq`` mesh of its CPU devices (``tests/conftest.py`` gives JAX 8).

The port's ranks are processes of their own (``tests/torch_cp_ranks.py``,
which imports no JAX), spawned by the test into a gloo group on
127.0.0.1. On the CPU every kernel runs as its plain version; H9 itself
is held against that plain version on the card
(``tests/test_torch_kernels_cuda.py``).

Gates (each with its reason):
* block spans: exact (integer functions of the ids).
* H9's plain version, fp32: o and lse within ``tests/test_torch_flash.py``'s
  atol 2e-5 / rtol 1e-4 of JAX's K-rect and of the square H1 plain
  version on the whole batch (the same fp32 online softmax in another
  summation order). ``attention_rect`` under the same gate.
* the model: ``tests/test_torch_families.py``'s gates, fp32 5e-5 absolute
  and in bf16 largest error 0.1, mean 0.01, per-token centred cosine
  0.999; every rank's gathered result is bit-equal to every other's and
  to its own ``forward_flat_cp`` rows.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from esme_tpu.models import config as jconfig
from esme_tpu.models import esm as jesm
from esme_tpu.models.init import init_params as jinit
from esme_tpu.ops import attention as jattn
from esme_tpu.ops import flash as jflash
from esme_tpu.parallel import context as jcontext

from esme_tpu_torch import tokenize_unpad
from esme_tpu_torch.models import config as tconfig
from esme_tpu_torch.models import io as tio
from esme_tpu_torch.ops import attention as tattn
from esme_tpu_torch.ops import flash as tflash

from test_torch_families import TINY, _gate
from test_torch_families import _configs as _family_configs
from torch_cp_ranks import CLASSES, IMPLS, cp_rank
from torch_spawn import free_port, spawn

ATOL, RTOL = 2e-5, 1e-4
AA = list('LAGVSERTIDPKQNFYMHWC')


def _packed_ids(T, lo, hi, seed):
    """Segment ids of a packed batch of T tokens: sequences of lo..hi
    tokens (the last one cut at T), so they cross any split of T."""
    rng = np.random.default_rng(seed)
    lens, total = [], 0
    while total < T:
        lens.append(int(rng.integers(lo, hi)))
        total += lens[-1]
    return np.repeat(np.arange(len(lens)), lens)[:T].astype(np.int32)


def _qkv(Tq, Tk, H, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((Tq, H, D)).astype(np.float32),
            *(rng.standard_normal((Tk, H, D)).astype(np.float32)
              for _ in range(2)))


# -------------------------------------------------------------------------
# block spans with the keys' own ids
# -------------------------------------------------------------------------

@pytest.mark.parametrize('n', [2, 4, 8])
def test_rect_block_spans_match_jax(n):
    """Every rank's queries over the whole batch's keys: H9's spans and
    the transposed spans equal JAX's ``block_spans(seg_q, ..., seg_k)``
    where the shard is a multiple of the blocks."""
    T = 2048
    seg = _packed_ids(T, 40, 400, seed=n)
    for r in range(n):
        sq = seg[r * T // n:(r + 1) * T // n]
        want = jflash.block_spans(jnp.asarray(sq), tflash.BLOCK_Q,
                                  tflash.BLOCK_K, jnp.asarray(seg))
        got = tflash.rect_spans(torch.from_numpy(sq), torch.from_numpy(seg))
        for a, b in zip(got, want[:2]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        got_t = tflash.transposed_spans(
            torch.from_numpy(sq), tflash.BLOCK_QT, tflash.BLOCK_KV,
            torch.from_numpy(seg))
        want_t = jflash.block_spans(jnp.asarray(sq), tflash.BLOCK_QT,
                                    tflash.BLOCK_KV, jnp.asarray(seg))[2:]
        for a, b in zip(got_t, want_t):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_rect_block_spans_cover_the_mask_on_a_ragged_split():
    """Tq % 128 != 0 on both sides of a ragged split: each q block's span
    is exactly the k tiles that hold a key of one of its rows' segments
    (the ids are monotonic), and a q block whose ids match no key gets
    an empty span."""
    T = 1500
    seg = _packed_ids(T, 30, 300, seed=11)
    for lo, hi in ((0, 701), (701, T), (333, 1111)):
        sq = seg[lo:hi]
        ks, ke = tflash.rect_spans(torch.from_numpy(sq),
                                   torch.from_numpy(seg))
        for b in range(len(ks)):
            rows = sq[b * tflash.BLOCK_Q:(b + 1) * tflash.BLOCK_Q]
            hit = np.flatnonzero(np.isin(seg, rows)) // tflash.BLOCK_K
            assert (int(ks[b]), int(ke[b])) == (hit.min(), hit.max() + 1)
    ks, ke = tflash.rect_spans(torch.from_numpy(seg[:300] + 10 ** 6),
                               torch.from_numpy(seg))
    assert bool((ke <= ks).all())


# -------------------------------------------------------------------------
# H9's plain version against K-rect, attention_rect
# -------------------------------------------------------------------------

def _rect_cases():
    return [(n, D) for n in (2, 4) for D in (16, 32, 64, 128)]


@pytest.mark.parametrize('n,D', _rect_cases())
def test_flash_rect_matches_jax(n, D):
    """Every rank of a 1,024-token packed batch (segments crossing the
    ranks' boundaries) over the whole batch: the port's
    ``flash_rect_attention`` (H9's plain version on the CPU) against
    JAX's (K-rect, interpret mode); its lse against the square H1 plain
    version's rows on the whole batch."""
    T, H = 1024, 2
    seg = _packed_ids(T, 60, 420, seed=D)
    q, k, v = _qkv(T, T, H, D, seed=n + D)
    segt = torch.from_numpy(seg)
    ks, ke = tflash.block_spans(segt, tflash.BLOCK_Q, tflash.BLOCK_K)
    to = lambda x: torch.from_numpy(x.reshape(x.shape[0], H * D))
    _, lse_sq = tflash.segment_flash_fwd_plain(to(q), to(k), to(v), segt, ks,
                                               ke, H)
    for r in range(n):
        lo, hi = r * T // n, (r + 1) * T // n
        want = jflash.flash_rect_attention(
            jnp.asarray(q[lo:hi]), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(seg[lo:hi]), jnp.asarray(seg), block_q=128,
            block_k=128, interpret=True)
        got = tflash.flash_rect_attention(
            torch.from_numpy(q[lo:hi]), torch.from_numpy(k),
            torch.from_numpy(v), segt[lo:hi], segt)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=RTOL)
        rks, rke = tflash.rect_spans(segt[lo:hi], segt)
        _, lse = tflash.segment_flash_fwd(to(q[lo:hi]), to(k), to(v),
                                          segt[lo:hi], rks, rke, H,
                                          seg_k=segt)
        np.testing.assert_allclose(lse.numpy(), lse_sq[:, lo:hi].numpy(),
                                   atol=ATOL, rtol=RTOL)


def test_flash_rect_ragged_matches_jax():
    """A ragged split, Tq = 389 (Tq % 128 != 0) and Tk = 1,000 (a ragged
    last k tile), and one q block whose ids match no key: o = 0 and
    lse = ``EMPTY_LSE`` there, as H9 writes them."""
    T, H, D = 1000, 2, 32
    seg = _packed_ids(T, 50, 350, seed=3)
    q, k, v = _qkv(T, T, H, D, seed=5)
    lo, hi = 307, 696
    want = jflash.flash_rect_attention(
        jnp.asarray(q[lo:hi]), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(seg[lo:hi]), jnp.asarray(seg), block_q=128, block_k=128,
        interpret=True)
    got = tflash.flash_rect_attention(
        torch.from_numpy(q[lo:hi]), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(seg[lo:hi]), torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    # the first q block's ids match no key: its span is empty
    sq = torch.from_numpy(seg[lo:hi].copy())
    sq[:tflash.BLOCK_Q] = 10 ** 6
    segk = torch.from_numpy(seg)
    ks, ke = tflash.rect_spans(sq, segk)
    assert ke[0] <= ks[0] and bool((ke[1:] > ks[1:]).all())
    o, lse = tflash.segment_flash_fwd(
        torch.from_numpy(q[lo:hi].reshape(-1, H * D)),
        *(torch.from_numpy(x.reshape(T, H * D)) for x in (k, v)), sq, ks, ke,
        H, seg_k=segk)
    assert not o[:tflash.BLOCK_Q].any()
    assert bool((lse[:, :tflash.BLOCK_Q] == tflash.EMPTY_LSE).all())
    np.testing.assert_allclose(
        o[tflash.BLOCK_Q:].numpy(),
        got.numpy()[tflash.BLOCK_Q:].reshape(-1, H * D), atol=ATOL,
        rtol=RTOL)


@pytest.mark.parametrize('rect', [False, True])
def test_attention_rect_matches_jax(rect):
    """``attention_rect`` against JAX's, square and rectangular (the
    second half of the queries), with a ragged last k tile."""
    T, H, D = 300, 4, 16
    seg = _packed_ids(T, 20, 120, seed=7)
    q, k, v = _qkv(T, T, H, D, seed=8)
    lo = 150 if rect else 0
    args = (q[lo:], k, v, seg[lo:], seg)
    want = jattn.attention_rect(*map(jnp.asarray, args), block_k=64)
    got = tattn.attention_rect(*map(torch.from_numpy, args), block_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


# -------------------------------------------------------------------------
# the slice: ranks of forward_flat_cp / context_parallel_log_prob
# -------------------------------------------------------------------------

SEQS_LENS = [150, 7, 233, 60, 31]        # 491 tokens: every n needs a pad


def _configs(family, dtype):
    """The tiny config of ``family`` in both packages (the other families'
    as ``tests/test_torch_families.py`` makes them)."""
    if family == 'esm2':
        return (jconfig.esm2_config(**TINY, dtype=dtype),
                tconfig.esm2_config(**TINY, dtype=dtype))
    return _family_configs(family, dtype)


def _jax_params(family, dtype):
    """JAX's init from seed 3 with the embedding lifted to N(0, 1)."""
    jcfg, _ = _configs(family, dtype)
    jp = jinit(jcfg, jax.random.key(3))
    rng = np.random.default_rng(4)
    return {**jp, 'embed_tokens': jnp.asarray(
        rng.standard_normal(jp['embed_tokens'].shape),
        jp['embed_tokens'].dtype)}


def _run_ranks(n, *args, out):
    spawn(cp_rank, n, free_port(), *args, out, timeout=240)
    return [dict(np.load(out / f'rank{r}.npz')) for r in range(n)]


CP_CASES = [('esm2', 2, 'float32'), ('esm2', 4, 'float32'),
            ('esm2', 2, 'bfloat16'), ('esm2', 4, 'bfloat16'),
            ('esmc', 2, 'float32'), ('esm1b', 2, 'float32')]


@pytest.mark.parametrize('family,n,dtype', CP_CASES)
def test_context_parallel_matches_jax(family, n, dtype, tmp_path):
    """n gloo ranks of the port: each rank's ``forward_flat_cp`` rows on
    both attention routes ('flash': H9's plain version; 'reference':
    ``attention_rect``) against JAX's ``forward_flat_cp`` over a ``seq``
    mesh of n CPU devices on the same route ('flash': K-rect in interpret
    mode); ``context_parallel_log_prob`` (the gathered ``(T, V)``, the
    same on every rank and equal to each rank's own 'flash' rows) against
    JAX's ``forward_flat_cp``, JAX's ``context_parallel_log_prob`` and the
    port's single-process ``predict_log_prob``; T not divisible by n
    refused with ``ValueError``."""
    jcfg, tcfg = _configs(family, dtype)
    jp = _jax_params(family, dtype)
    params = tio.params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    rng = np.random.default_rng(0)
    seqs = [''.join(rng.choice(AA, m)) for m in SEQS_LENS]
    model = CLASSES[family](config=tcfg, params=params, device='cpu')
    tok, _, cu, ml = tokenize_unpad(seqs, alphabet=model.alphabet)
    T = tok.shape[0]
    assert T % n
    ranks = _run_ranks(n, family, tcfg, params, tok, cu, ml, out=tmp_path)

    mesh = Mesh(np.asarray(jax.devices()[:n]), ('seq',))
    jtok = jnp.asarray(np.pad(tok, (0, (-T) % n),
                              constant_values=tcfg.padding_idx), jnp.int32)
    jseg, jpos = jesm.packed_meta(jnp.asarray(cu, jnp.int32), jtok.shape[0])
    want = {impl: np.asarray(jcontext.forward_flat_cp(
        jp, jcfg, jtok, jseg, jpos, mesh=mesh, log_prob=True,
        attn_impl=impl), np.float32) for impl in IMPLS}
    jmodel = getattr(jesm, {'esm2': 'ESM2', 'esmc': 'ESMC',
                            'esm1b': 'ESM1b'}[family])(config=jcfg, params=jp)
    want_api = np.asarray(jcontext.context_parallel_log_prob(
        jmodel, tok, (cu, ml), mesh), np.float32)
    single = model.predict_log_prob(tok, pad_args=(cu, ml)).numpy()

    per = jtok.shape[0] // n
    for r, res in enumerate(ranks):
        for impl in IMPLS:
            _gate(res[impl], want[impl][r * per:(r + 1) * per], dtype)
        got = res['gathered']
        assert got.shape == (T, tcfg.vocab_size)
        np.testing.assert_array_equal(got, ranks[0]['gathered'])
        real = min(per, T - r * per)
        np.testing.assert_array_equal(res['flash'][:real],
                                      got[r * per:r * per + real])
        _gate(got, want['flash'][:T], dtype)
        _gate(got, want_api[:T], dtype)
        _gate(got, single, dtype)
        assert bool(res['refused'])
