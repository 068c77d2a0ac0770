"""The port stands alone: importing it loads no JAX and nothing of the
JAX package, no source file of it names either, its entry points run on
CUDA unless asked for the CPU, and CPU runs launch no kernel.

Every check here is exact (names, modules, counts).
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import esme_tpu_torch
from esme_tpu_torch import ESM, ESM2
from esme_tpu_torch.models.config import esm2_config
from esme_tpu_torch.ops import fused_attn, headsplit
from esme_tpu_torch.ops import flash as tflash

PKG = Path(esme_tpu_torch.__file__).resolve().parent

_IMPORT_ALL = '''
import importlib, pkgutil, sys
import esme_tpu_torch
for m in pkgutil.walk_packages(esme_tpu_torch.__path__, 'esme_tpu_torch.'):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n.split('.')[0] in ('jax', 'jaxlib', 'esme_tpu'))
print(len([n for n in sys.modules if n.startswith('esme_tpu_torch')]))
print(bad)
'''


def test_import_loads_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, '-c', _IMPORT_ALL],
                         capture_output=True, text=True, check=True,
                         cwd=PKG.parent).stdout.split('\n')
    assert int(out[0]) >= 15          # every module was imported
    assert out[1] == '[]', out[1]


def test_sources_name_no_jax():
    # a module reference or an import, not the word in prose
    # (``params_from_jax`` is the carry-over's name)
    pattern = re.compile(r'\bjax\b|\bjaxlib\b|\besme_tpu\.|'
                         r'^\s*(from|import)\s+esme_tpu\b', re.M)
    files = sorted(PKG.rglob('*.py')) + sorted(PKG.rglob('*.cu'))
    assert len(files) >= 17
    hits = [f'{f.relative_to(PKG)}: {m.group(0)}' for f in files
            for m in pattern.finditer(f.read_text())]
    assert hits == []


def test_entry_points_default_to_cuda(tmp_path):
    cfg = esm2_config(1, 32, 2)
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default does not raise')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ESM2(config=cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ESM2(1, 32, 2)
    path = str(tmp_path / 'esm2_t.safetensors')
    ESM2(config=cfg, device='cpu').save_pretrained(path)
    for load in (ESM.from_pretrained, ESM2.from_pretrained):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load(path)
        assert load(path, device='cpu').device.type == 'cpu'


def test_cpu_runs_launch_no_kernel():
    counters = (fused_attn.segment_flash_fwd, fused_attn.rotary_qk,
                tflash.segment_flash_fwd, headsplit.rotary_qk,
                headsplit.relayout_heads)
    before = [f.launches for f in counters]
    model = ESM2(config=esm2_config(2, 32, 2, dtype='float32'), rng=1,
                 device='cpu')
    lens = [7, 30, 12]
    tok = np.concatenate([np.r_[0, np.full(n - 2, 5 + i), 2]
                          for i, n in enumerate(lens)]).astype(np.int32)
    cu = np.cumsum([0, *lens]).astype(np.int32)
    lp = model.predict_log_prob(tok, pad_args=(cu, max(lens)))
    assert lp.shape == (sum(lens), 33) and torch.isfinite(lp).all()
    assert [f.launches for f in counters] == before == [0, 0, 0, 0, 0]


def test_entry_points_pin_fp32_accumulation(monkeypatch):
    """The entry points run their products with fp32 cuBLAS reductions
    and no TF32, and give the caller's settings back after the call."""
    from esme_tpu_torch.ops import linear
    flags = torch.backends.cuda.matmul
    seen = []
    matmul = linear.matmul

    def spy(x, kernel):
        seen.append((flags.allow_bf16_reduced_precision_reduction,
                     flags.allow_tf32))
        return matmul(x, kernel)

    monkeypatch.setattr(linear, 'matmul', spy)
    saved = flags.allow_bf16_reduced_precision_reduction, flags.allow_tf32
    try:
        flags.allow_bf16_reduced_precision_reduction = True
        flags.allow_tf32 = True
        model = ESM2(config=esm2_config(1, 32, 2, dtype='float32'),
                     device='cpu')
        tok = np.array([0, 5, 6, 7, 2], dtype=np.int32)
        model.predict_log_prob(tok, pad_args=(np.array([0, 5], np.int32), 5))
        assert seen and set(seen) == {(False, False)}
        assert (flags.allow_bf16_reduced_precision_reduction,
                flags.allow_tf32) == (True, True)
    finally:
        (flags.allow_bf16_reduced_precision_reduction,
         flags.allow_tf32) = saved


def test_kernel_wrappers_fall_back_only_on_cpu():
    """A tensor on another device than the CPU goes to the kernel or
    raises; the plain version is never taken for it."""
    q = torch.empty((64, 32), dtype=torch.bfloat16, device='meta')
    seg = torch.empty(64, dtype=torch.int32, device='meta')
    spans = torch.empty(1, dtype=torch.int32, device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        tflash.segment_flash_fwd(q, q, q, seg, spans, spans, 2)
    tab = torch.empty((64, 16), dtype=torch.bfloat16, device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        headsplit.rotary_qk(q, q, tab, tab, 2)
    with pytest.raises(ValueError, match='unsupported device'):
        headsplit.relayout_heads((q,), 'thd', 'htd', 2)


def test_build_needs_nvcc(monkeypatch, tmp_path):
    from esme_tpu_torch import _build
    monkeypatch.setattr(_build, 'BUILD_ROOT', tmp_path)
    monkeypatch.setattr(_build.shutil, 'which', lambda name: None)
    monkeypatch.setattr(_build, 'CUDA_NVCC', str(tmp_path / 'no-nvcc'))
    with pytest.raises(RuntimeError, match='nvcc not found'):
        _build.build_all()
    # builds go under BUILD_ROOT, keyed by a hash of sources and flags
    assert _build._build_dir().parent == tmp_path
    assert sorted(p.name for p in _build.CSRC.glob('*.cu')) == \
        ['flash_bwd.cu', 'flash_fwd.cu', 'headsplit.cu', 'rope.cu']


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the script runs for real')
    run = subprocess.run([sys.executable, 'chip_smoke.py'],
                         capture_output=True, text=True, timeout=120,
                         cwd=PKG.parent)
    assert run.returncode != 0
    assert run.stdout == '' and 'no CUDA device' in run.stderr
