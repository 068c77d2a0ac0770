#!/usr/bin/env python3
"""The traced units' idle time and blocking syncs by the port's stage, from
the ``trace.json`` a ``--trace 1`` run leaves under
``$TMPDIR/h100_bench/<workload>.<seed>.<pid>/``:

    python3 h100_bench/tools/stage_table.py <trace.json> [...]

One JSON line a trace: the traced units (``units``, ``unit_ms``: the mean
traced unit), the span's ``idle_ms`` a unit and, a unit for each stage
(``hbench/stages.py``: the innermost ``esme.`` range on the units' thread,
or ``unattributed``), its idle ms (``idle_ms_by_stage``), its share of the
idle time (``idle_share``) and its blocking syncs (``syncs_by_stage``:
``cudaStreamSynchronize``, ``cudaDeviceSynchronize`` and
``cudaEventSynchronize`` calls on the units' thread, by the stage open at
each call's start). ``unattributed_by_range`` splits the unattributed
idle by the innermost host range of any name open over it (the
benchmark's ``h100_bench.unit`` where none of the port's is),
``largest_gaps`` lists the longest idle stretches with the stage and the
innermost range of any name open at their start, and ``check`` holds the
charges' sum against ``span − busy``.
"""

from __future__ import annotations

import bisect
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

from hbench import stages                      # noqa: E402
from hbench.trace import read                  # noqa: E402

SYNCS = ('cudaStreamSynchronize', 'cudaDeviceSynchronize',
         'cudaEventSynchronize')


def _uncovered(intervals: list, pieces: list) -> list:
    """The parts of the sorted ``intervals`` under none of ``pieces``."""
    out, j = [], 0
    for s, e in intervals:
        while j < len(pieces) and pieces[j][1] <= s:
            j += 1
        t, k = s, j
        while k < len(pieces) and pieces[k][0] < e:
            if pieces[k][0] > t:
                out.append((t, pieces[k][0]))
            t = max(t, pieces[k][1])
            k += 1
        if e > t:
            out.append((t, e))
    return out


def _at(pieces: list, ts: float) -> str:
    """The label of the piece of :func:`stages.innermost` open at ``ts``."""
    i = bisect.bisect_right([p[0] for p in pieces], ts) - 1
    return pieces[i][2] if i >= 0 and ts < pieces[i][1] \
        else stages.UNATTRIBUTED


def _syncs(path: Path, tr, pieces: list) -> dict:
    events = json.loads(path.read_text())
    events = events.get('traceEvents', events) \
        if isinstance(events, dict) else events
    a, b = tr.span
    out = {}
    for ev in events:
        if ev.get('ph') != 'X' or ev.get('name') not in SYNCS or \
                ev.get('tid') != tr.main_tid:
            continue
        ts = float(ev.get('ts', 0))
        if a <= ts < b:
            name = _at(pieces, ts)
            out[name] = out.get(name, 0) + 1
    return out


def table(path: Path) -> dict:
    tr = read(path)
    n = len(tr.units)
    idle = tr.span_s - tr.busy_s
    esme = stages.innermost(stages.stage_ranges(tr))
    gaps = stages.idle_intervals(tr)
    by = stages.charge(gaps, esme)
    a, b = tr.span
    every = stages.innermost([r for r in tr.host.get(tr.main_tid, [])
                              if r[1] > a and r[0] < b])
    rest = stages.charge(_uncovered(gaps, esme), every)
    rest.pop(stages.UNATTRIBUTED, None)
    largest = [[(e - s) * 1e-3, _at(esme, s), _at(every, s)]
               for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:8]]

    def per_unit(d, scale=1e3):
        return {k: v / n * scale for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])}
    return {
        'trace': str(path), 'units': n, 'unit_ms': tr.span_s / n * 1e3,
        'idle_ms': idle / n * 1e3,
        'idle_ms_by_stage': per_unit(by),
        'idle_share': {k: v / idle for k, v in
                       sorted(by.items(), key=lambda kv: -kv[1])} if idle
        else {},
        'syncs_by_stage': per_unit(_syncs(path, tr, esme), 1),
        'unattributed_by_range': dict(list(per_unit(rest).items())[:8]),
        'largest_gaps': largest,
        'check': {'charged_s': sum(by.values()), 'span_minus_busy_s': idle},
    }


def main(argv) -> int:
    for p in argv:
        print(json.dumps(table(Path(p))), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
