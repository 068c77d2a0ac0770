"""Whole runs: without a card the command fails and prints no result; on
the CPU at tiny shapes (the harness's look for a card skipped) a run
loads nothing of JAX, reads its trace, and its check passes sound runs and
fails every fault the cell can have, and the control put in the program's
place, under the cell's own limits."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
INFER = ('altered', 'half', 'stale', 'control')
CELLS = {'esm2_650m.infer_proteome': INFER,
         'esmc_300m.infer_proteome': INFER,
         'esm2_650m.train_ckpt50k': ('unchanged', 'half', 'control'),
         'esm2_650m.score_dms': ('altered', 'control')}


def test_without_a_card_the_run_fails_and_prints_nothing():
    out = subprocess.run(
        [sys.executable, 'h100_bench/run.py', '--workload',
         'esm2_650m.infer_proteome', '--seed', str(2 ** 31 + 3),
         '--seconds', '1', '--trace', '0'],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ''
    assert 'no result' in out.stderr


def test_a_cpu_run_loads_nothing_of_jax():
    code = f'''
import sys, time
sys.path.insert(0, {str(ROOT / "h100_bench")!r})
sys.path.insert(0, {str(ROOT / "h100_bench" / "tests")!r})
from conftest import TINY_ESM2, TINY_TRAFFIC
from hbench import harness, env
r = harness.run_cell('esm2_650m.infer_proteome', 5, 0.3, False,
                     time.perf_counter(), device='cpu', config=TINY_ESM2,
                     traffic=TINY_TRAFFIC['infer_packed'])
print(sorted({{m.split('.')[0] for m in sys.modules}}))
'''
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]
                            .replace("'", '"')))
    assert 'esme_tpu_torch' in loaded
    assert not loaded & {'jax', 'jaxlib', 'flax', 'esme_tpu'}


@pytest.mark.parametrize('cell', sorted(CELLS))
def test_sound_run_is_correct(tiny_run, cell):
    r = tiny_run(cell)
    assert r['correct'], r['compared']
    assert list(r)[-1] == 'compared'
    assert r['attempted'] > 0 and r['failed'] == 0


@pytest.mark.parametrize('cell,fault', [(c, f) for c in sorted(CELLS)
                                        for f in CELLS[c]])
def test_fault_is_caught(tiny_run, cell, fault):
    r = tiny_run(cell, fault=fault)
    assert not r['correct'], (fault, r['compared'])


def test_traced_run_reports_what_a_cpu_trace_holds(tiny_run):
    r = tiny_run('esm2_650m.infer_proteome', trace=True)
    assert r['correct']
    assert 'data_wait_ms.infer' in r['metrics']
    assert 'mfu.infer' in r['metrics']
    # no device operations on the CPU: the device's readers are silent
    assert 'idle_pct.infer' not in r['metrics']
    assert 'gemm_roofline.infer' not in r['metrics']
    assert r['device']['busy_s'] == 0.0


def test_setup_counts_from_the_start(tiny_run):
    t0 = time.perf_counter()
    r = tiny_run('esm2_650m.score_dms')
    assert 0 < r['metrics']['setup_s']['value'] < time.perf_counter() - t0
