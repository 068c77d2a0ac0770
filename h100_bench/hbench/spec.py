"""``BENCHMARK.json`` and the files it names, looked up by name."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]       # h100_bench/
ROOT = BENCH.parent                                 # the checkout


def load(root: Path = ROOT) -> dict:
    return json.loads((root / 'BENCHMARK.json').read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench['workloads']:
        if w['name'] == name:
            return w
    raise KeyError(f'no workload {name!r} in BENCHMARK.json')


def config(bench: dict, cell: dict, root: Path = ROOT) -> dict:
    for c in bench['configs']:
        if c['name'] == cell['config']:
            return json.loads((root / c['file']).read_text())
    raise KeyError(f"no configuration {cell['config']!r}")


def traffic(name: str) -> dict:
    return json.loads((BENCH / 'traffic' / f'{name}.json').read_text())


def limits(cell_name: str) -> dict:
    """The check's limits for a cell: ``{number: limit}``."""
    path = BENCH / 'cells' / f'{cell_name}.json'
    return json.loads(path.read_text())['limits']


def applies(metric: dict, cell: dict, bench: dict) -> bool:
    """Whether a metric is reported in a cell: listed in its
    ``workloads``, or, without that key, in every cell (a per-layer
    metric: every cell that reports the end-to-end metric it moves)."""
    if 'workloads' in metric:
        return cell['name'] in metric['workloads']
    moves = metric.get('moves')
    if moves is None:
        return True
    for m in bench['end_to_end']:
        if m['name'] == moves:
            return applies(m, cell, bench)
    return False


def metrics(bench: dict, cell: dict, trace: bool) -> list:
    key = 'per_layer' if trace else 'end_to_end'
    return [m for m in bench[key] if applies(m, cell, bench)]


def reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = BENCH / 'metrics' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(
        f'h100_bench_metric_{name.replace(".", "_")}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
