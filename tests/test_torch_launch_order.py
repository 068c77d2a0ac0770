"""H9's launch order (``ops/flash.py:fwd_order``) on the CPU.

The order is a property of the spans alone: a permutation of the q blocks
by falling span length, ties in q-block order, empty spans last, each
block's span beside it. Each context-parallel span site
(``parallel/context.py:forward_flat_cp``, ``train/distributed.py``'s
sharded step) builds it once per forward, beside the spans, and every
layer's H9 launch gets that one tensor; the model's own span site
(``models/esm.py:pad_flat_meta``) builds none, as H1 runs in q-block
order, and H1's wrapper refuses one. On the CPU the kernels' plain
versions ignore it, so the rectangular attention with the order still
matches JAX's ``flash_rect_attention`` (K-rect in interpret mode) and
gives the same bits as without it, gradients included. The card's tests
(``tests/test_torch_kernels_cuda.py``) hold the kernels' bits under the
order.

Gates: the order and the counts are exact (integer functions of the
ids); against JAX, ``tests/test_torch_context.py``'s fp32 atol 2e-5 /
rtol 1e-4 (the same online softmax in another summation order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from esme_tpu.ops import flash as jflash

from esme_tpu_torch import ESM2, tokenize_unpad
from esme_tpu_torch.alphabet import mask_tokens
from esme_tpu_torch.models.config import esm2_config
from esme_tpu_torch.ops import flash as tflash
from esme_tpu_torch.parallel import (context_parallel_log_prob,
                                     initialize_distributed, make_mesh)
from esme_tpu_torch.train.distributed import ShardedMaskedPLM

from torch_spawn import free_port

ATOL, RTOL = 2e-5, 1e-4
AA = list('LAGVSERTIDPKQNFYMHWC')


def _packed_ids(T, lo, hi, seed):
    """Segment ids of a packed batch of T tokens: sequences of lo..hi
    tokens, the last one cut at T."""
    rng = np.random.default_rng(seed)
    lens, total = [], 0
    while total < T:
        lens.append(int(rng.integers(lo, hi)))
        total += lens[-1]
    return np.repeat(np.arange(len(lens)), lens)[:T].astype(np.int32)


def _span_cases():
    """(name, kstart, kend): H1's spans of packed batches and H9's on each
    rank of a 4-way split, one rank with a q block whose ids match no key
    (an empty span) and one ragged (Tq % 128 != 0)."""
    cases = []
    for seed, (lo, hi) in enumerate(((20, 300), (100, 1000), (600, 700))):
        seg = torch.from_numpy(_packed_ids(4096, lo, hi, seed))
        cases.append((f'H1 {lo}-{hi}', *tflash.flash_spans(seg)[:2]))
        for r in range(4):
            sq = seg[r * 1024:(r + 1) * 1024].clone()
            if r == 1:
                sq[:tflash.BLOCK_Q] += 10 ** 6
            cases.append((f'H9 {lo}-{hi} rank {r}',
                          *tflash.rect_spans(sq, seg)))
        cases.append((f'H9 {lo}-{hi} ragged',
                      *tflash.rect_spans(seg[700:1701].contiguous(), seg)))
    return cases


def test_fwd_order_is_longest_span_first():
    """On every case: the order's first row is an int32 permutation of the
    q blocks on the spans' device, its other two the blocks' kstart and
    kend in that order; the span lengths in its order never rise; blocks
    with an empty span come last; blocks of one length keep q-block
    order."""
    saw_empty = saw_tie = False
    for name, ks, ke in _span_cases():
        rows = tflash.fwd_order(ks, ke)
        nqb = ks.numel()
        assert rows.dtype == torch.int32 and rows.device == ks.device
        assert tuple(rows.shape) == (3, nqb), name
        order = rows[0]
        assert sorted(order.tolist()) == list(range(nqb)), name
        assert torch.equal(rows[1], ks[order.long()])
        assert torch.equal(rows[2], ke[order.long()])
        length = (ke - ks).clamp_min(0)[order.long()]
        assert bool((length[1:] <= length[:-1]).all()), name
        empty = (ke <= ks)[order.long()]
        saw_empty |= bool(empty.any())
        if empty.any():   # every empty span after every other
            assert bool(empty[int(torch.nonzero(empty)[0]):].all()), name
        for n in length.unique():
            blocks = order[length == n]
            saw_tie |= blocks.numel() > 1
            assert bool((blocks[1:] > blocks[:-1]).all()), (name, int(n))
    assert saw_empty and saw_tie


def test_with_order_keeps_the_spans():
    """``with_order`` carries the four spans as they are, adds the order of
    the first two, and ``Spans(*spans)`` takes a plain four-tuple (order
    None) or a ``Spans`` unchanged. H1's wrapper refuses an order."""
    seg = torch.from_numpy(_packed_ids(2048, 50, 500, 7))
    spans = tflash.rect_flash_spans(seg[512:1024].contiguous(), seg)
    ordered = tflash.with_order(spans)
    assert isinstance(ordered, tflash.Spans) and len(ordered) == 5
    assert all(a is b for a, b in zip(ordered[:4], spans))
    assert torch.equal(ordered.order, tflash.fwd_order(*spans[:2]))
    assert tflash.Spans(*spans).order is None
    assert tflash.Spans(*ordered) == ordered
    x = torch.zeros((2048, 2 * 64))
    with pytest.raises(ValueError, match='q-block order'):
        tflash.segment_flash_fwd(x, x, x, seg, *tflash.flash_spans(seg)[:2],
                                 2, order=ordered.order)


def test_segment_flash_rect_with_order_matches_jax():
    """Every rank of a 4-way split of a 1,024-token packed batch at D =
    64: ``segment_flash_rect`` with the spans and their launch order (H9's
    plain version) against JAX's ``flash_rect_attention`` (K-rect,
    interpret mode), and bit-equal to the same call without the order, in
    o and in the gradients of q, k and v (H10's plain version, which
    reads the first four spans)."""
    T, H, D, n = 1024, 2, 64, 4
    seg = _packed_ids(T, 60, 420, seed=5)
    rng = np.random.default_rng(9)
    q, k, v, do = (rng.standard_normal((T, H * D)).astype(np.float32)
                   for _ in range(4))
    segt = torch.from_numpy(seg)
    for r in range(n):
        lo, hi = r * T // n, (r + 1) * T // n
        sq = segt[lo:hi].contiguous()
        spans = tflash.rect_flash_spans(sq, segt)
        outs = []
        for s in (tflash.with_order(spans), spans):
            qt, kt, vt = (torch.from_numpy(x).requires_grad_()
                          for x in (q[lo:hi], k, v))
            o = tflash.segment_flash_rect(qt, kt, vt, sq, segt, H, s)
            o.backward(torch.from_numpy(do[lo:hi]))
            outs.append((o.detach(), qt.grad, kt.grad, vt.grad))
        assert all(map(torch.equal, *outs)), r
        want = jflash.flash_rect_attention(
            jnp.asarray(q[lo:hi].reshape(-1, H, D)),
            jnp.asarray(k.reshape(T, H, D)), jnp.asarray(v.reshape(T, H, D)),
            jnp.asarray(seg[lo:hi]), jnp.asarray(seg), block_q=128,
            block_k=128, interpret=True)
        np.testing.assert_allclose(
            outs[0][0].numpy(), np.asarray(want).reshape(hi - lo, H * D),
            atol=ATOL, rtol=RTOL)


def _counting(monkeypatch):
    """Count ``fwd_order``'s calls and record the order each attention
    launch gets (``segment_flash_fwd``, looked up in ``flash`` at call
    time, and in ``fused_attn``)."""
    from esme_tpu_torch.ops import fused_attn
    seen = {'orders': 0, 'launches': []}
    fwd_order, fwd = tflash.fwd_order, tflash.segment_flash_fwd

    def counted_order(*a):
        seen['orders'] += 1
        seen['last'] = fwd_order(*a)
        return seen['last']

    def recorded(*a, **kw):
        seen['launches'].append((kw.get('seg_k') is not None,
                                 kw.get('order')))
        return fwd(*a, **kw)
    monkeypatch.setattr(tflash, 'fwd_order', counted_order)
    monkeypatch.setattr(tflash, 'segment_flash_fwd', recorded)
    monkeypatch.setattr(fused_attn, 'segment_flash_fwd', recorded)
    return seen


def _model():
    return ESM2(config=esm2_config(2, 64, 4, dtype='float32'), rng=0,
                device='cpu')


def _seqs(seed, total):
    rng = np.random.default_rng(seed)
    lens, n = [], 0
    while n < total:
        lens.append(int(rng.integers(20, 250)))
        n += lens[-1] + 2
    return [''.join(rng.choice(AA, m)) for m in lens]


@pytest.fixture
def one_rank():
    """A one-rank gloo world in this process and its (1, 1, 1) mesh."""
    import torch.distributed as dist
    initialize_distributed(f'127.0.0.1:{free_port()}', 1, 0, device='cpu')
    try:
        yield make_mesh(1, 1, seq=1, device='cpu')
    finally:
        dist.destroy_process_group()


def _check_sites(seen, rect, launches):
    """``launches`` attention launches; with ``rect``, H9's, one
    ``fwd_order`` call and each launch with the order it made; else H1's,
    with no order and no call."""
    assert seen['orders'] == int(rect)
    assert len(seen['launches']) == launches
    for is_rect, order in seen['launches']:
        assert is_rect == rect
        assert order is (seen['last'] if rect else None)


def test_model_span_site_builds_no_order(monkeypatch):
    """``predict_log_prob`` (``pad_flat_meta``'s span site): H1 runs in
    q-block order, so the site builds no order and each layer's H1 launch
    gets none."""
    model = _model()
    tok, _, cu, ml = tokenize_unpad(_seqs(1, 900), alphabet=model.alphabet)
    seen = _counting(monkeypatch)
    lp = model.predict_log_prob(tok, pad_args=(cu, ml))
    assert bool(torch.isfinite(lp).all())
    _check_sites(seen, False, 2)


def test_context_span_site_builds_the_order_once(monkeypatch, one_rank):
    """``context_parallel_log_prob`` (``forward_flat_cp``'s span site) in a
    one-rank world: one order for the forward, and each layer's H9 launch
    gets it."""
    model = _model()
    tok, _, cu, ml = tokenize_unpad(_seqs(2, 900), alphabet=model.alphabet)
    seen = _counting(monkeypatch)
    lp = context_parallel_log_prob(model, tok, (cu, ml), one_rank)
    assert bool(torch.isfinite(lp).all())
    _check_sites(seen, True, 2)


def test_sharded_span_site_builds_the_order_once(monkeypatch, one_rank):
    """``ShardedMaskedPLM``'s step over a ``seq`` axis (``_local``'s span
    site) in a one-rank world: one order for the step, and each layer's H9
    launch gets it, the recomputed layers' under checkpointing too."""
    model = _model()
    model.checkpointing = True
    tok, _, cu, ml = tokenize_unpad(_seqs(3, 900), alphabet=model.alphabet)
    masked, mask = mask_tokens(tok, alphabet=model.alphabet,
                               rng=np.random.default_rng(4))
    batch = (masked[None], tok[None], mask[None], cu[None], int(ml))
    plm = ShardedMaskedPLM(model, one_rank, learning_rate=1e-3,
                           seq_axis='seq')
    seen = _counting(monkeypatch)
    loss, _ = plm._grad_step(batch)
    assert bool(torch.isfinite(loss))
    _check_sites(seen, True, 4)
