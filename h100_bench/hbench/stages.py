"""The traced units' idle device time, charged to the port's stages.

The port marks its stages with ``torch.profiler`` ranges named ``esme.``
(``esme_tpu_torch/profiling.py:SPANS``), which share the device kernels'
clock in the benchmark's trace. Each idle instant of the traced units'
span (no device operation running, as :func:`readers.idle_pct` counts it)
is charged to the innermost ``esme.`` range open at that instant on the
units' thread, or to :data:`UNATTRIBUTED` where none is. The charges add
up to the span's idle time exactly. While a backward runs the units'
thread sits inside ``esme.train.backward``, so the backward's idle is
charged there whichever thread autograd launches from.

A trace without any ``esme.`` range on the units' thread (a program
without the spans) charges nothing: :func:`idle_ms` is then None.
"""

from __future__ import annotations

PREFIX = 'esme.'
UNATTRIBUTED = 'unattributed'

# the stages each per-layer metric reads (metrics/*_idle_ms.*.py)
PACK = ('esme.model.prepare', 'esme.model.unpad')
TRUNK = ('esme.model.trunk', 'esme.model.layer_params')
BACKWARD = ('esme.train.backward',)
STEP = ('esme.train.batch', 'esme.train.forward', 'esme.train.loss',
        'esme.train.optimizer', 'esme.train.sync', 'esme.model.prepare',
        'esme.model.head')
SCORE_HOST = ('esme.variant.build', 'esme.variant.forward',
              'esme.variant.fetch', 'esme.variant.margins')


def idle_intervals(tr) -> list:
    """The ``(start, end)`` stretches of the traced units' span in which
    no device operation ran, in order."""
    a, b = tr.span
    out, t = [], a
    for s, e in tr.busy_intervals():
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if b > t:
        out.append((t, b))
    return out


def innermost(ranges: list) -> list:
    """``(start, end, name)`` pieces of time, in order, each labelled by the
    innermost of the ``(start, end, name)`` ``ranges`` open over it (the
    one opened last); time under no range is left out."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    points = sorted({p for r in ranges for p in r[:2]})
    out, stack, i = [], [], 0
    for t0, t1 in zip(points, points[1:]):
        while i < len(ranges) and ranges[i][0] <= t0:
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] <= t0:
            stack.pop()
        if stack:
            out.append((t0, t1, stack[-1][2]))
    return out


def charge(intervals: list, pieces: list) -> dict:
    """Seconds of the sorted, disjoint ``intervals`` (µs) under each label
    of the sorted ``pieces`` (:func:`innermost`), the rest under
    :data:`UNATTRIBUTED`."""
    out, j = {}, 0
    for s, e in intervals:
        covered = 0.0
        while j < len(pieces) and pieces[j][1] <= s:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < e:
            lo, hi = max(s, pieces[k][0]), min(e, pieces[k][1])
            if hi > lo:
                name = pieces[k][2]
                out[name] = out.get(name, 0.0) + (hi - lo) * 1e-6
                covered += hi - lo
            k += 1
        out[UNATTRIBUTED] = out.get(UNATTRIBUTED, 0.0) + \
            (e - s - covered) * 1e-6
    return out


def stage_ranges(tr) -> list:
    """The ``esme.`` ranges on the units' thread that overlap their span."""
    a, b = tr.span
    return [r for r in tr.host.get(tr.main_tid, [])
            if r[2].startswith(PREFIX) and r[1] > a and r[0] < b]


def idle_by_stage(tr) -> dict | None:
    """``{stage: idle seconds}`` over the traced units' span, with
    :data:`UNATTRIBUTED`; None where there is nothing to charge: no units,
    no device operation, or no ``esme.`` range on the units' thread."""
    if tr is None or not tr.units or not tr.busy_s:
        return None
    ranges = stage_ranges(tr)
    if not ranges:
        return None
    return charge(idle_intervals(tr), innermost(ranges))


def idle_ms(rec, stages) -> float | None:
    """Idle ms a traced unit spent with one of ``stages`` innermost on the
    units' thread (mean over the traced units)."""
    by = idle_by_stage(rec.trace)
    if by is None:
        return None
    return sum(by.get(s, 0.0) for s in stages) / len(rec.trace.units) * 1e3
