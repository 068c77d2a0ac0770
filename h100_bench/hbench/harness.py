"""One run of one cell: set-up, the measured window, the readers, the check.

``python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` prints, as the last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` a ``breakdown``, and last ``compared``: each number of
the check with its limit, also the last lines of standard error.

The window runs whole units (a forward, a training step, a protein
scored) while its seconds last, each ending on the host; a rate is the
window's work over its time, from the first unit's start to the last
one's end. A traced run records a fixed number of consecutive units from
40% of the window on.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

from reference.model import Arch

from . import drivers, env, spec
from .trace import Profiler, read as read_trace

TRACE_FROM = 0.4


@dataclass
class Ctx:
    """What a driver gets: the configuration's shapes, the traffic, the
    seed, the device and a working directory."""
    arch: Arch
    traffic: dict
    seed: int
    device: str
    workdir: Path


@dataclass
class Record:
    """What the metric readers read."""
    units: list
    window_s: float
    setup_s: float
    window_peak_bytes: int
    traced: list = field(default_factory=list)
    trace: object = None


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def log(msg: str) -> None:
    print(f'[h100_bench] {msg}', file=sys.stderr, flush=True)


def run_window(driver, seconds: float, prof, trace_units: int) -> list:
    units = []
    t0 = time.perf_counter()
    deadline, trace_at = t0 + seconds, t0 + TRACE_FROM * seconds
    traced = 0
    while True:
        now = time.perf_counter()
        if now >= deadline and (prof is None or prof.done):
            break
        if prof is not None and not prof.done and not prof.active \
                and now >= trace_at:
            prof.start()
            now = time.perf_counter()
        with prof.unit() if prof is not None else contextlib.nullcontext():
            u = driver.unit()
        u['t0'], u['t1'] = now, time.perf_counter()
        u['traced'] = prof is not None and prof.active
        units.append(u)
        if u['traced']:
            traced += 1
            if traced == trace_units:
                prof.stop()
    return units


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = 'cuda', config=None,
             traffic=None, fault=None):
    """Set-up, window, readers and check of one run. Returns the result
    line's dict. ``config`` and ``traffic`` replace the cell's files (tests
    run small shapes on the CPU this way); ``fault`` names a fault the
    driver plants in the timed path (tests only)."""
    import torch
    bench = spec.load()
    cell = spec.workload(bench, name)
    config = config or spec.config(bench, cell)
    traffic = traffic or spec.traffic(cell['traffic'])
    limits = spec.limits(name)
    arch = Arch.from_config(config)
    work = Path(tempfile.gettempdir()) / 'h100_bench' / \
        f'{name}.{seed}.{os.getpid()}'
    work.mkdir(parents=True, exist_ok=True)
    ctx = Ctx(arch, traffic, seed, device, work)
    drv = drivers.load(traffic['driver'])(ctx)
    drv.fault = fault
    cuda = device.startswith('cuda')
    try:
        drv.setup()
        prof = None
        if trace:
            prof = Profiler()
            if cuda:
                Profiler.warm()
        if cuda:
            torch.cuda.synchronize()
            setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start
        log(f'set-up {setup_s:.3f} s; card before the window: '
            f'{env.card_state() if cuda else "cpu"}')
        before = drv.counters()
        units = run_window(drv, seconds, prof, traffic['trace_units'])
        window_s = units[-1]['t1'] - units[0]['t0']
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        log(f'card after the window: {env.card_state() if cuda else "cpu"}')
        after = drv.counters()
        log(f'{len(units)} units in {window_s:.3f} s; kernel launches a '
            f'unit {_per_unit(before, after, len(units))}')
        drv.end_window()
        found = env.forbidden_modules()
        if found:
            raise RuntimeError(f'loaded after the window: {found}')
        rec = Record(units, window_s, setup_s, peak)
        result = {'correct': False, 'attempted': len(units), 'failed': 0}
        if prof is not None and prof.done:
            path = prof.export(work)
            rec.trace = read_trace(path)
            rec.traced = [u for u in units if u['traced']]
            log(f'trace: {path}')
        result['metrics'] = _metrics(bench, cell, trace, rec)
        dev = {'platform': 'gpu' if cuda else 'cpu',
               'kind': torch.cuda.get_device_name(0) if cuda else 'cpu',
               'count': 1 if cuda else 0,
               'memory_peak_bytes': max(setup_peak, peak) if cuda else 0}
        if rec.trace is not None:
            dev['busy_s'] = rec.trace.busy_s
            dev['window_s'] = rec.trace.span_s
            result['breakdown'] = _breakdown(rec.trace)
        result['device'] = dev
        drv.release()
        numbers = drv.check(units)
        compared = {k: {'value': v, 'limit': limits[k]}
                    for k, v in numbers.items()}
        result['correct'] = all(c['value'] <= c['limit']
                                for c in compared.values())
        result['compared'] = compared
        return result
    finally:
        drv.close()
        for p in work.glob('*.fa*'):
            p.unlink()


def _per_unit(before: dict, after: dict, n: int) -> dict:
    return {k: (after[k] - before[k]) / n for k in before}


def _metrics(bench, cell, trace, rec) -> dict:
    out = {}
    for m in spec.metrics(bench, cell, trace):
        value = spec.reader(m['name'])(rec)
        if value is not None:
            out[m['name']] = {'value': float(value), 'unit': m['unit']}
    return out


def _breakdown(tr) -> dict:
    from .readers import is_gemm, is_own
    ops, gaps = {}, {}
    for k in tr.kernels:
        if is_own(k):
            label = k.short
        elif is_gemm(k):
            label = 'gemm'
        elif k.cat != 'kernel':
            label = k.cat
        else:
            label = next((op for op in reversed(k.stack)
                          if op.startswith('aten::')), k.short)
        ops[label] = ops.get(label, 0.0) + k.dur * 1e-6
    for label, s in tr.idle_gaps():
        gaps[label] = gaps.get(label, 0.0) + s

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:10]]
    return {'device_ops': top(ops), 'idle_gaps': top(gaps)}


def main(argv, t_start: float) -> int:
    args = parse(argv)
    bench = spec.load()
    cell = spec.workload(bench, args.workload)
    env.cache_dirs(spec.ROOT)
    try:
        env.require_card(int(cell['chips']))
    except env.NoCard as e:
        log(f'no result: {e}')
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start)
    found = env.forbidden_modules()
    if found:
        log(f'no result: loaded in this process: {found}')
        return 3
    for k, c in result['compared'].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0

