"""What the metric files read: each function takes the run's
:class:`~hbench.harness.Record` and returns a number, or None where the run
holds nothing to read (a metric that is then left out of the line).

Kernels are sorted into classes here, the yardstick's and not the
program's: a GEMM is any kernel an ``aten::mm``, ``addmm``, ``bmm``,
``baddbmm`` or ``_scaled_mm`` launched; the program's own kernels are
known by their names (H1 ``flash_fwd``, H2 ``bwd_dkv``/``bwd_dq``/
``flash_bwd``, H3 ``rope_qk``, H4 ``relayout_``), the rectangular
context-parallel forms (``rect``) apart.
"""

from __future__ import annotations

import numpy as np

from . import work

GEMM_OPS = ('aten::mm', 'aten::addmm', 'aten::bmm', 'aten::baddbmm',
            'aten::_scaled_mm')
H1 = ('flash_fwd',)
H2 = ('bwd_dkv', 'bwd_dq', 'flash_bwd')
OWN = H1 + H2 + ('rope_qk', 'relayout_')
OPTIMIZER = 'Optimizer.step'


def is_gemm(k) -> bool:
    return k.cat == 'kernel' and any(op in GEMM_OPS for op in k.stack)


def is_own(k, names=OWN) -> bool:
    return k.cat == 'kernel' and 'rect' not in k.name and any(
        n in k.name for n in names)


def device_s(rec, pick) -> float | None:
    """Device seconds of the traced kernels ``pick`` selects."""
    if rec.trace is None:
        return None
    return sum(k.dur for k in rec.trace.kernels if pick(k)) * 1e-6


def per_unit_ms(rec, pick):
    s = device_s(rec, pick)
    if not s:
        return None
    return s / len(rec.traced) * 1e3


def roofline_pct(rec, bound_key: str, pick):
    """Σ the traced units' least time for the work over the device time of
    the kernels that did it, in percent."""
    s = device_s(rec, pick)
    if not s:
        return None
    least = sum(u.get(bound_key, 0.0) for u in rec.traced)
    return least / s * 100.0 if least else None


def gemm_roofline(rec):
    s = device_s(rec, is_gemm)
    if not s:
        return None
    flops = sum(u['gemm_flops'] for u in rec.traced)
    return flops / work.BF16_FLOP_PER_S / s * 100.0


def attn_fwd_roofline(rec):
    return roofline_pct(rec, 'h1_bound_s', lambda k: is_own(k, H1))


def attn_bwd_roofline(rec):
    return roofline_pct(rec, 'h2_bound_s', lambda k: is_own(k, H2))


def elementwise_ms(rec):
    return per_unit_ms(rec, lambda k: k.cat == 'kernel' and not is_gemm(k)
                       and not is_own(k))


def optimizer_ms(rec):
    return per_unit_ms(rec, lambda k: k.cat == 'kernel' and any(
        op.startswith(OPTIMIZER) for op in k.stack))


def idle_pct(rec):
    if rec.trace is None or not rec.trace.units or not rec.trace.busy_s:
        return None
    return (1.0 - rec.trace.busy_s / rec.trace.span_s) * 100.0


def mfu(rec):
    flops = sum(u['model_flops'] for u in rec.units)
    return flops / rec.window_s / work.BF16_FLOP_PER_S * 100.0


def tokens_per_s(rec):
    return sum(u['tokens'] for u in rec.units) / rec.window_s


def data_wait_ms(rec):
    waits = [u['data_wait_s'] for u in rec.units if 'data_wait_s' in u]
    return float(np.mean(waits)) * 1e3 if waits else None


def latency_ms(rec, q: float):
    lat = [u['latency_s'] for u in rec.units if 'latency_s' in u]
    return float(np.percentile(lat, q)) * 1e3 if lat else None


def peak_mem_gib(rec):
    return rec.window_peak_bytes / 2 ** 30


def setup_s(rec):
    return rec.setup_s
