"""The benchmark's own profiler wrapper and the reading of its trace.

``torch.profiler`` records a fixed number of consecutive units in the
middle of a full window, each under a ``record_function`` span of the
benchmark's (:data:`UNIT`). The Chrome trace it exports is read back
here: every device kernel with the stack of host ranges (operators and
``record_function`` spans) that launched it, matched through the launch's
correlation id, and the device's busy time within the traced units.
"""

from __future__ import annotations

import contextlib
import json
from dataclasses import dataclass, field
from pathlib import Path

UNIT = 'h100_bench.unit'
HOST = ('cpu_op', 'user_annotation')
LAUNCH = ('cuda_runtime', 'cuda_driver')
DEVICE = ('kernel', 'gpu_memcpy', 'gpu_memset')


class Profiler:
    """Starts, wraps each unit, stops and exports."""

    def __init__(self):
        self._prof = None
        self.active = False
        self.done = False

    @staticmethod
    def warm() -> None:
        """One short profile, so the window's start pays no first-use
        cost of the profiler."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            x = torch.ones(256, 256, device='cuda')
            (x @ x).sum().item()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self.active = True

    def unit(self):
        if not self.active:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(UNIT)

    def stop(self) -> None:
        self._prof.__exit__(None, None, None)
        self.active = False
        self.done = True

    def export(self, out_dir: Path) -> Path:
        """``trace.json`` (Chrome trace) and ``ops.txt`` (device time by
        operator) in ``out_dir``; returns the trace's path."""
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / 'trace.json'
        self._prof.export_chrome_trace(str(path))
        table = None
        for key in ('self_device_time_total', 'self_cuda_time_total'):
            try:
                table = self._prof.key_averages().table(sort_by=key,
                                                        row_limit=60)
                break
            except (AttributeError, KeyError, ValueError):
                continue
        (out_dir / 'ops.txt').write_text(table or '')
        return path


@dataclass
class Kernel:
    name: str
    start: float          # µs, the trace's clock
    dur: float            # µs
    stack: tuple          # host ranges, outermost first
    cat: str = 'kernel'

    @property
    def short(self) -> str:
        n = self.name.removeprefix('void ').replace(
            '(anonymous namespace)::', '')
        for c in '(<':
            n = n.split(c, 1)[0]
        return n


@dataclass
class Trace:
    units: list                         # (start, end) µs of each unit
    kernels: list = field(default_factory=list)   # Kernel, in the units
    host: dict = field(default_factory=dict)      # tid -> [(s, e, name)]
    main_tid: object = None

    @property
    def span(self) -> tuple:
        return self.units[0][0], self.units[-1][1]

    @property
    def span_s(self) -> float:
        a, b = self.span
        return (b - a) * 1e-6

    def busy_intervals(self) -> list:
        """The merged intervals in which any device operation ran, clipped
        to the traced units' span."""
        a, b = self.span
        iv = sorted((max(k.start, a), min(k.start + k.dur, b))
                    for k in self.kernels)
        out = []
        for s, e in iv:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def idle_gaps(self) -> list:
        """``(label, seconds)`` of each idle stretch in the span, labelled
        by the innermost host range running on the units' thread at its
        middle (``host`` where none)."""
        a, b = self.span
        edges = [a]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(b)
        gaps = [(s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s]
        stacks = _enclosing(self.host.get(self.main_tid, []),
                            [(s + e) / 2 for s, e in gaps])
        out = []
        for (s, e), st in zip(gaps, stacks):
            out.append((st[-1] if st else 'host', (e - s) * 1e-6))
        return out


def read(path: Path) -> Trace:
    """The kernels, copies and sets of a Chrome trace that ran inside its
    :data:`UNIT` spans, each with its launching host stack."""
    events = json.loads(Path(path).read_text())
    events = events.get('traceEvents', events) \
        if isinstance(events, dict) else events
    host, launches, device, units = {}, {}, [], []
    for ev in events:
        if ev.get('ph') != 'X':
            continue
        cat = str(ev.get('cat', '')).lower()
        ts, dur = float(ev.get('ts', 0)), float(ev.get('dur', 0))
        args = ev.get('args') or {}
        if cat in HOST:
            host.setdefault(ev.get('tid'), []).append(
                (ts, ts + dur, ev.get('name', '')))
            if ev.get('name') == UNIT:
                units.append((ts, ts + dur, ev.get('tid')))
        elif cat in LAUNCH and 'correlation' in args:
            launches[args['correlation']] = (ev.get('tid'), ts)
        elif cat in DEVICE:
            device.append((ev.get('name', ''), ts, dur, cat,
                           args.get('correlation')))
    units.sort()
    tr = Trace(units=[(s, e) for s, e, _ in units], host=host,
               main_tid=units[0][2] if units else None)
    if not units:
        return tr
    stacks = _stacks(host, launches)
    a, b = tr.span
    for name, ts, dur, cat, corr in device:
        if ts + dur <= a or ts >= b:
            continue
        tr.kernels.append(Kernel(name, ts, dur, stacks.get(corr, ()), cat))
    return tr


def _stacks(host: dict, launches: dict) -> dict:
    """For each launch's correlation id, the names of the host ranges that
    enclose it on its thread, outermost first."""
    by_tid = {}
    for corr, (tid, ts) in launches.items():
        by_tid.setdefault(tid, []).append((ts, corr))
    out = {}
    for tid, ls in by_tid.items():
        ls.sort()
        found = _enclosing(host.get(tid, []), [ts for ts, _ in ls])
        out.update((corr, st) for (_, corr), st in zip(ls, found))
    return out


def _enclosing(ranges: list, points: list) -> list:
    """For each of the sorted ``points``, the names of the ``(start, end,
    name)`` ranges that enclose it, outermost first (one sweep)."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    stack, i, out = [], 0, []
    for ts in points:
        while i < len(ranges) and ranges[i][0] <= ts:
            while stack and stack[-1][1] <= ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] <= ts:
            stack.pop()
        out.append(tuple(r[2] for r in stack))
    return out
