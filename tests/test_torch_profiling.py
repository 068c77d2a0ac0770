"""``esme_tpu_torch/profiling.py`` on the CPU: ``benchmark`` times with
the host clock after its warm-up calls, the memory helpers report
nothing without a card, and ``trace`` writes a Chrome trace and a table
by kernel."""

import json

import pytest
import torch

from esme_tpu_torch import profiling


def test_benchmark_on_cpu_runs_warmup_then_reps():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    x = torch.ones(4)
    sec = profiling.benchmark(fn, x, reps=5, warmup=2)
    assert len(calls) == 7
    assert 0.0 < sec < 1.0
    profiling.sync(fn(x))                # a no-op on the CPU
    profiling.sync({'a': [x]})


@pytest.mark.parametrize('device', [None, 'cpu'])
def test_memory_helpers_report_nothing_without_a_card(monkeypatch, device):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert profiling.device_memory_stats(device) == {}
    assert profiling.peak_memory_gb(device) is None
    assert profiling.memory_analysis_gb(torch.ones, 3) == {}


def test_trace_writes_chrome_trace_and_kernel_table(tmp_path):
    a = torch.randn(32, 32)
    with profiling.trace(str(tmp_path / 'prof')) as logdir:
        (a @ a).sum()
    with open(tmp_path / 'prof' / 'trace.json') as f:
        assert 'traceEvents' in json.load(f)
    table = (tmp_path / 'prof' / 'kernels.txt').read_text()
    assert 'aten::' in table
    assert logdir == str(tmp_path / 'prof')
