"""``BENCHMARK.json`` and the files it names: every configuration, traffic
mix, metric and cell resolves to a file of its own, and the harness's
sources import nothing of JAX."""

import ast
import json
from pathlib import Path

from hbench import spec
from reference.model import Arch

BENCH = Path(__file__).resolve().parents[1]
BANNED = {'jax', 'jaxlib', 'flax', 'esme_tpu'}


def test_every_name_has_its_file():
    bench = spec.load()
    for c in bench['configs']:
        cfg = json.loads((spec.ROOT / c['file']).read_text())
        Arch.from_config(cfg)
    for w in bench['workloads']:
        t = spec.traffic(w['traffic'])
        assert (BENCH / 'hbench' / 'drivers' / f"{t['driver']}.py").exists()
        assert spec.limits(w['name'])
        assert w['chips'] == 1
    for m in bench['end_to_end'] + bench['per_layer']:
        assert callable(spec.reader(m['name']))


def test_every_cell_reports_what_its_per_layer_metrics_move():
    bench = spec.load()
    for w in bench['workloads']:
        e2e = {m['name'] for m in spec.metrics(bench, w, False)}
        assert 'setup_s' in e2e and len(e2e) >= 2
        layer = spec.metrics(bench, w, True)
        assert layer
        assert {m['moves'] for m in layer} <= e2e


def test_sources_import_nothing_of_jax():
    for path in BENCH.rglob('*.py'):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split('.', 1)[0] not in BANNED, (path, n)
