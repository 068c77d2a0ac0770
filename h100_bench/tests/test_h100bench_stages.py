"""``hbench/stages.py`` on synthetic traces: each idle instant goes to the
innermost ``esme.`` range on the units' thread, the backward's idle to
``esme.train.backward`` while autograd launches from another thread, the
charges add up to the span's idle time, and every stage metric is silent
where there is nothing to read."""

import numpy as np
import pytest

from hbench import spec, stages
from hbench.harness import Record
from hbench.trace import Kernel, Trace

MAIN, AUTOGRAD = 1, 2
STAGE_METRICS = ('pack_idle_ms.infer', 'pack_idle_ms.score',
                 'trunk_idle_ms.infer', 'trunk_idle_ms.score',
                 'trunk_idle_ms.train', 'backward_idle_ms.train',
                 'step_idle_ms.train', 'score_host_idle_ms.score')


def _trace(units, busy, main, other=()):
    """A trace of ``units`` (µs) whose device ran over ``busy``, with
    ``main`` ranges on the units' thread and ``other`` on autograd's."""
    host = {MAIN: [(s, e, 'h100_bench.unit') for s, e in units] + list(main)}
    if other:
        host[AUTOGRAD] = list(other)
    kernels = [Kernel('k', s, e - s, ()) for s, e in busy]
    return Trace(units=list(units), kernels=kernels, host=host,
                 main_tid=MAIN)


def _rec(tr):
    return Record(units=[{}], window_s=1.0, setup_s=1.0, window_peak_bytes=0,
                  traced=[{}] * len(tr.units) if tr else [], trace=tr)


def _ms(d):
    return {k: round(v * 1e6, 6) for k, v in d.items()}


def test_the_innermost_range_wins():
    tr = _trace([(0, 100)], [(40, 50), (70, 80)],
                [(10, 60, 'esme.model.trunk'),
                 (20, 30, 'esme.model.layer_params'),
                 (22, 24, 'aten::select')])
    got = _ms(stages.idle_by_stage(tr))
    assert got == {'unattributed': 40.0, 'esme.model.trunk': 30.0,
                   'esme.model.layer_params': 10.0}
    # the trunk metric takes both of its stages, per traced unit
    assert stages.idle_ms(_rec(tr), stages.TRUNK) == pytest.approx(0.040)
    assert stages.idle_ms(_rec(tr), stages.PACK) == 0.0


def test_backward_idle_is_charged_there_while_autograd_launches():
    # the backward's kernels come from autograd's thread, whose ranges
    # (even one named like a stage) are not the units'
    tr = _trace([(0, 100)], [(20, 30), (50, 60)],
                [(5, 15, 'esme.train.forward'),
                 (15, 90, 'esme.train.backward'),
                 (90, 100, 'esme.train.sync')],
                other=[(15, 89, 'autograd::engine::evaluate_function'),
                       (31, 49, 'esme.model.trunk')])
    got = _ms(stages.idle_by_stage(tr))
    assert got == {'unattributed': 5.0, 'esme.train.forward': 10.0,
                   'esme.train.backward': 55.0, 'esme.train.sync': 10.0}
    rec = _rec(tr)
    assert spec.reader('backward_idle_ms.train')(rec) == \
        pytest.approx(0.055)
    assert spec.reader('step_idle_ms.train')(rec) == pytest.approx(0.020)
    assert spec.reader('trunk_idle_ms.train')(rec) == 0.0


def _nested(rng, lo, hi, depth, names):
    """Properly nested random ranges inside ``(lo, hi)``."""
    out, t = [], lo
    while depth and t < hi - 4:
        s = t + rng.uniform(0, (hi - t) / 3)
        e = s + rng.uniform(1, (hi - s) / 2)
        out.append((s, e, str(rng.choice(names))))
        out += _nested(rng, s, e, depth - 1, names)
        t = e
    return out


@pytest.mark.parametrize('seed', range(6))
def test_charges_add_up_to_the_idle_time(seed):
    rng = np.random.default_rng(seed)
    names = ['esme.model.prepare', 'esme.model.trunk', 'esme.model.head',
             'aten::copy_', 'esme.variant.margins']
    units = [(0, 1000), (1000, 2200), (2300, 3000)]
    main = [r for u in units for r in _nested(rng, *u, 4, names)]
    starts = np.sort(rng.uniform(-50, 3050, 40))
    busy = [(s, s + rng.uniform(0, 120)) for s in starts]
    tr = _trace(units, busy, main)
    got = stages.idle_by_stage(tr)
    assert sum(got.values()) == pytest.approx(tr.span_s - tr.busy_s,
                                              rel=1e-9, abs=1e-12)
    assert all(v >= -1e-12 for v in got.values())
    assert set(got) <= {n for n in names if n.startswith('esme.')} | \
        {'unattributed'}


def test_every_stage_metric_is_silent_with_nothing_to_read():
    without_trace = _rec(None)
    # a program without the spans (only the benchmark's and torch's ranges)
    no_spans = _trace([(0, 100)], [(10, 20)], [(30, 40, 'aten::mm')])
    # a CPU run: no device operation
    no_device = _trace([(0, 100)], [], [(30, 40, 'esme.model.trunk')])
    bench = spec.load()
    listed = {m['name']: m for m in bench['per_layer']}
    for name in STAGE_METRICS:
        read = spec.reader(name)
        for rec in (without_trace, _rec(no_spans), _rec(no_device)):
            assert read(rec) is None, name
        m = listed[name]
        assert (m['source'], m['unit'], m['better']) == \
            ('device_trace', 'ms', 'lower')
        assert m['workloads']


def test_a_traced_cpu_run_leaves_the_stage_metrics_out(tiny_run):
    r = tiny_run('esm2_650m.score_dms', trace=True)
    assert r['correct']
    assert not set(STAGE_METRICS) & set(r['metrics'])
