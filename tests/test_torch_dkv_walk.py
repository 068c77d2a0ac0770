"""The walk of H2's and H10's Hopper dk/dv pass (``ops/flash.py:
dkv_stages``, the kernel's index arithmetic in Python) and the summary of
its timeline probe (``tools/decompose_bwd.py:timeline_summary``).

A dk/dv CTA holds two 64-row k blocks and walks the union of their q-tile
spans, rounded out to stages of 128 q rows at D = 64 (64 at the other head
dims). The walk is right when every same-segment (q row, k row) pair lies
in a stage the k row's CTA visits: on seeded packed batches and on each
rank of H10's splits (a rank's queries over all keys), with the spans from
the port's ``flash_spans``/``rect_flash_spans`` and from the JAX package's
``block_spans``. Integer arithmetic: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esme_tpu.ops import flash as jflash
from esme_tpu.ops import segment as jseg

from esme_tpu_torch.ops import flash as tflash
from esme_tpu_torch.tools import decompose_bwd as tdb

# 47 64-row k blocks: the last CTA holds one (ragged against 128 rows)
T = 3008
STAGE_ROWS = (64, 128)
# H10's splits, on 64-row bounds (JAX's spans take whole blocks): four
# ranks and three, ragged against 128 rows
SPLITS = ((0, 768, 1536, 2304, T), (0, 1024, 1984, T))


def _packed_ids(seed: int, total: int = T) -> np.ndarray:
    """Segment ids of a packed batch: lengths 1-700, a tail segment."""
    rng = np.random.default_rng(seed)
    lens = []
    while sum(lens) < total:
        lens.append(int(rng.integers(1, 700)))
    cu = np.cumsum([0, *lens]).astype(np.int32)
    return np.array(jseg.segment_ids_from_cu_lens(jnp.asarray(cu), total))


def _uncovered(seg_q: np.ndarray, seg_k: np.ndarray, qstart, qend,
               stage_rows: int) -> int:
    """Same-segment (q, k) pairs outside the stages the k row's CTA walks."""
    sb0, n = (x.numpy().astype(np.int64)
              for x in tflash.dkv_stages(qstart, qend, stage_rows))
    cta = np.arange(seg_k.size) // (2 * tflash.BLOCK_KV)
    lo, hi = sb0[cta] * stage_rows, (sb0[cta] + n[cta]) * stage_rows
    rows = np.arange(seg_q.size)[:, None]
    pairs = seg_q[:, None] == seg_k[None, :]
    return int((pairs & ((rows < lo) | (rows >= hi))).sum())


def _cases():
    """(name, seg_q, seg_k): three packed batches, and each rank of the
    first's ``SPLITS`` (H10)."""
    out = []
    for seed in (0, 1, 2):
        seg = _packed_ids(seed)
        out.append((f'h2 seed {seed}', seg, seg))
    seg = _packed_ids(0)
    for bounds in SPLITS:
        n = len(bounds) - 1
        for r, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
            out.append((f'h10 rank {r} of {n}', seg[lo:hi], seg))
    return out


@pytest.mark.parametrize('stage_rows', STAGE_ROWS)
@pytest.mark.parametrize('case', _cases(), ids=lambda c: c[0])
def test_dkv_stages_cover_same_segment_pairs(case, stage_rows):
    """Every same-segment pair falls in a stage the walk visits, with the
    port's spans and with JAX's; the 128-row walk covers the 64-row one
    and adds at most one 64-row tile at each end."""
    _, seg_q, seg_k = case
    tq, tk = torch.from_numpy(seg_q), torch.from_numpy(seg_k)
    rect = seg_q is not seg_k
    spans = tflash.rect_flash_spans(tq, tk) if rect \
        else tflash.flash_spans(tq)
    qstart, qend = spans[2:]
    jq = jflash.block_spans(jnp.asarray(seg_q), tflash.BLOCK_QT,
                            tflash.BLOCK_KV,
                            seg_k=jnp.asarray(seg_k) if rect else None)
    assert np.array_equal(np.asarray(jq[2]), qstart.numpy())
    assert np.array_equal(np.asarray(jq[3]), qend.numpy())
    assert _uncovered(seg_q, seg_k, qstart, qend, stage_rows) == 0
    lo64, hi64 = tdb.stage_spans(qstart, qend, 64)
    lo, hi = tdb.stage_spans(qstart, qend, stage_rows)
    walks = hi64 > lo64
    assert torch.equal(hi > lo, walks)
    assert ((lo <= lo64) & (lo >= lo64 - 1))[walks].all()
    assert ((hi >= hi64) & (hi <= hi64 + 1))[walks].all()


def test_dkv_stages_are_the_kernels_arithmetic():
    """``sb0 = q0 / r``, ``n = ceil(q1 / r) - sb0`` over the pair's union
    ``[q0, q1)`` of 64-row tiles (``r`` tiles a stage), ``n = 0`` for an
    empty union; a last odd k block keeps its own span; at 64-row stages
    the walk is ``union_spans``."""
    i32 = lambda x: torch.tensor(x, dtype=torch.int32)  # noqa: E731
    qs, qe = i32([0, 1, 9, 2, 3, 4, 5]), i32([2, 3, 0, 4, 6, 7, 9])
    sb0, n = tflash.dkv_stages(qs, qe, 128)
    assert sb0.tolist() == [0, 1, 1, 2] and n.tolist() == [2, 1, 3, 3]
    assert sb0.dtype == n.dtype == torch.int32
    sb0, n = tflash.dkv_stages(i32([7, 7]), i32([0, 0]), 128)
    assert n.tolist() == [0]
    for x, y in zip(tdb.stage_spans(qs, qe, 64), tdb.union_spans(qs, qe)):
        assert torch.equal(x, y)
    assert tflash.dkv_stage_rows(64) == 128
    assert {tflash.dkv_stage_rows(d) for d in (16, 24, 32, 128)} == \
        {tflash.BLOCK_QT}


def _record(n: int, stages: int, base: int, steps) -> np.ndarray:
    """A CTA's timeline record (``tl_words``) whose two warpgroups enter
    at ``base``, see K and V 10 cycles later, spend ``steps`` (five
    intervals) on each of ``n`` stages, and store for 7 cycles; loads
    issued 2 cycles before each stage's full barrier passes."""
    rec = np.zeros(tdb.tl_words(stages), dtype=np.int64)
    rec[0], rec[1], rec[2], rec[3] = 3, n, 1000, 1000 + 400
    for w in range(2):
        t = base
        rec[4 + 3 * w] = t
        t += 10
        rec[5 + 3 * w] = t
        for i in range(n):
            for k, d in enumerate(steps):
                t += d
                rec[10 + stages + 5 * (w * stages + i) + k] = t
            rec[10 + i] = rec[10 + stages + 5 * (w * stages + i)] - 2
        t += 7
        rec[6 + 3 * w] = t
    return rec


def test_timeline_summary_on_synthetic_stamps():
    """The phases of each warpgroup's wall time add up to it, stage
    intervals are read per stage, a CTA that walks no stage is counted
    apart, and the global timer gives the CTA's microseconds."""
    steps = (3, 4, 5, 6, 2)
    stamps = np.stack([_record(2, 3, 100, steps), _record(0, 3, 0, steps),
                       _record(3, 3, 50, steps)])
    stamps[1, 2:] = 0
    s = tdb.timeline_summary(torch.from_numpy(stamps), 3)
    assert s['ctas'] == 2 and s['empty_ctas'] == 1
    assert set(s['shares']) == set(tdb.TL_PHASES)
    for (name, d), want in zip(s['stage_cycles'].items(), steps):
        assert d == {'q1': want, 'median': want, 'q3': want}, name
    # CTA walls 10 + 2 * 20 + 7 = 57 and 10 + 3 * 20 + 7 = 77 cycles
    walls = (57.0, 77.0)
    for phase, per_stage in zip(('full_wait', 'st_dpt', 'scores', 'dv_dk',
                                 'handback'), steps):
        got = s['shares'][phase]
        want = sorted(k * per_stage / w for k, w in zip((2, 3), walls))
        assert got['q1'] == pytest.approx(want[0] + (want[1] - want[0]) / 4)
        assert got['q3'] == pytest.approx(want[0] + 3 * (want[1] - want[0])
                                          / 4)
    total = sum(s['shares'][p]['median'] for p in tdb.TL_PHASES)
    assert total == pytest.approx(1.0)
    assert s['shares']['prologue']['median'] == \
        pytest.approx((10 / 57 + 10 / 77) / 2)
    assert s['shares']['epilogue']['median'] == \
        pytest.approx((7 / 57 + 7 / 77) / 2)
    assert s['issue_to_ready_cycles']['median'] == 2
    assert s['stages_walked']['median'] == 2.5
    assert s['cta_us']['median'] == pytest.approx(0.4)
    assert s['cycles_per_ns']['median'] == pytest.approx((57 + 77) / 2
                                                         / 400)
    line = tdb.timeline_line('synthetic', s)
    assert line.startswith('synthetic: 2 CTAs walking 2 (2-3) stages')


def test_dkv_timeline_needs_the_card():
    """The timeline reads the card's clocks: no plain version, so CPU
    tensors are refused, as is a form that was not built."""
    seg = torch.from_numpy(_packed_ids(0, 256))
    q = torch.zeros((256, 128), dtype=torch.bfloat16)
    spans = tflash.flash_spans(seg)
    lse = torch.zeros((2, 256))
    args = (q, q, q, q, lse, lse, seg, *spans[2:], 2)
    with pytest.raises(RuntimeError, match='CUDA tensors'):
        tdb.dkv_timeline(128, *args)
    with pytest.raises(ValueError, match='unknown form'):
        tdb.dkv_timeline(32, *args)
