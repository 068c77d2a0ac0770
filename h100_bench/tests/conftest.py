"""CPU tests of the benchmark: ``python -m pytest h100_bench/tests -q``.

They import the harness from ``h100_bench/`` and run the port's plain
PyTorch paths at tiny shapes; nothing here needs a card, and tests that
would are marked ``cuda`` and skip without one."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

TINY_ESM2 = {'architecture': 'esm2', 'num_hidden_layers': 2,
             'hidden_size': 64, 'num_attention_heads': 4,
             'intermediate_size': 256, 'vocab_size': 33,
             'mask_token_id': 32, 'pad_token_id': 1}
TINY_ESMC = {'architecture': 'esmc', 'n_layers': 2, 'd_model': 64,
             'n_heads': 4, 'ffn_hidden_size': 256, 'vocab_size': 64,
             'mask_token_id': 32, 'pad_token_id': 1}
LENGTHS = {'min': 10, 'max': 40, 'count': 60, 'length_seed': 2}
TINY_TRAFFIC = {
    'infer_packed': {'driver': 'infer_packed', 'lengths': LENGTHS,
                     'token_per_batch': 256, 'prefetch_depth': 2,
                     'warmup_units': 1, 'trace_units': 2, 'check_units': 2,
                     'check_within': 3},
    'train_mlm': {'driver': 'train_mlm', 'lengths': LENGTHS,
                  'token_per_batch': 256, 'mask_freq': 0.15,
                  'alter_freq': 0.1, 'learning_rate': 1e-4,
                  'adam': {'betas': [0.9, 0.999], 'eps': 1e-8},
                  'checkpointing': True, 'remat': 'full',
                  'prefetch_depth': 2, 'check_steps': 3, 'trace_units': 2},
    'score_mask_margin': {'driver': 'score_mask_margin',
                          'lengths': {'min': 5, 'max': 12, 'each': 1},
                          'batch_size': 4, 'trace_units': 2,
                          'check_units': 3},
}


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'cuda: needs a CUDA card; skips where there is none')


@pytest.fixture
def tiny_run():
    """``tiny_run(cell, fault=None, trace=False)``: one run of a cell of
    ``BENCHMARK.json`` on the CPU at tiny shapes, its driver's traffic
    kind and the cell's own limits."""
    import time
    from hbench import harness, spec

    def run(cell, fault=None, trace=False, seed=2 ** 31 + 7):
        bench = spec.load()
        w = spec.workload(bench, cell)
        kind = spec.traffic(w['traffic'])['driver']
        config = TINY_ESMC if w['config'].startswith('esmc') else TINY_ESM2
        return harness.run_cell(cell, seed, 0.5, trace, time.perf_counter(),
                                device='cpu', config=config,
                                traffic=TINY_TRAFFIC[kind], fault=fault)
    return run
