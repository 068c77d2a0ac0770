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
from esme_tpu_torch.tools import decompose_bwd, flash_variants, \
    fwd_T_experiment, profile_attn

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


TOOL_COUNTERS = (fwd_T_experiment.fwd_T, flash_variants.variant_fwd,
                 decompose_bwd.bwd_variant, profile_attn.vpu,
                 profile_attn.mxu, profile_attn.dma, profile_attn.dma_t)


def test_cpu_runs_launch_no_kernel():
    counters = (fused_attn.segment_flash_fwd, fused_attn.rotary_qk,
                tflash.segment_flash_fwd, headsplit.rotary_qk,
                headsplit.relayout_heads, *TOOL_COUNTERS)
    before = [f.launches for f in counters]
    model = ESM2(config=esm2_config(2, 32, 2, dtype='float32'), rng=1,
                 device='cpu')
    lens = [7, 30, 12]
    tok = np.concatenate([np.r_[0, np.full(n - 2, 5 + i), 2]
                          for i, n in enumerate(lens)]).astype(np.int32)
    cu = np.cumsum([0, *lens]).astype(np.int32)
    lp = model.predict_log_prob(tok, pad_args=(cu, max(lens)))
    assert lp.shape == (sum(lens), 33) and torch.isfinite(lp).all()
    assert [f.launches for f in counters] == before == [0] * 12


def test_cpu_tools_launch_no_kernel(monkeypatch):
    """Each probe tool run through on the CPU (plain versions) moves no
    kernel's counter."""
    import contextlib
    import io
    from esme_tpu_torch import tools
    monkeypatch.setattr(tools, 'CPU_BUDGET', 1100)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        for tool in (fwd_T_experiment, flash_variants, decompose_bwd,
                     profile_attn):
            tool.main(['--device', 'cpu'])
    assert 'baseline' in out.getvalue() and 'dkv no_acc' in out.getvalue()
    assert [f.launches for f in TOOL_COUNTERS] == [0] * 7


def test_bwd_ab_runs_only_on_a_card(monkeypatch, tmp_path):
    """The A/B tool of H1's, H2's and H5's Hopper sources, H4's vec
    kernel and H8's Hopper streaming probes (``tools/sm90_ab.py``) refuses
    to run without a card, before it builds anything, and takes only
    those forms."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the tool runs for real')
    from esme_tpu_torch import _build
    from esme_tpu_torch.tools import sm90_ab
    monkeypatch.setattr(_build, 'BUILD_ROOT', tmp_path / 'build')
    for library in ('flash_fwd_sm90', 'flash_bwd_sm90', 'fwd_T_sm90',
                    'headsplit_vec', 'probes_sm90'):
        with pytest.raises(RuntimeError, match='needs a card'):
            sm90_ab.main([library, str(tmp_path / 'variant.cu')])
    with pytest.raises(SystemExit):
        sm90_ab.main(['flash_fwd', str(tmp_path / 'variant.cu')])
    assert not (tmp_path / 'build').exists()


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
    # the probe tools' kernels: D = 64
    q64 = torch.empty((64, 128), dtype=torch.bfloat16, device='meta')
    qT = torch.empty((2, 64, 64), dtype=torch.bfloat16, device='meta')
    lse = torch.empty((2, 64), device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        fwd_T_experiment.fwd_T(qT, qT, qT, seg, spans, spans)
    with pytest.raises(ValueError, match='unsupported device'):
        flash_variants.variant_fwd('nomax', q64, q64, q64, seg, spans, spans,
                                   2)
    with pytest.raises(ValueError, match='unsupported device'):
        decompose_bwd.bwd_variant('dq', 'dma', q64, q64, q64, q64, lse, lse,
                                  seg, spans, spans, spans, spans, 2)
    with pytest.raises(ValueError, match='unsupported device'):
        profile_attn.dma(q64, q64, q64, spans, spans, 2)
    with pytest.raises(ValueError, match='unsupported device'):
        profile_attn.dma_t(qT, qT, spans, spans)


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
        ['flash_bwd.cu', 'flash_bwd_sm90.cu', 'flash_fwd.cu',
         'flash_fwd_sm90.cu', 'flash_fwd_t.cu', 'headsplit.cu', 'probes.cu',
         'probes_sm90.cu', 'rope.cu']
    # every library has its C signatures
    assert sorted(_build.SIGNATURES) == sorted(
        p.stem for p in _build.CSRC.glob('*.cu'))


def test_bwd_route_is_a_static_rule_on_head_dim():
    """H2 launches the Hopper form (``flash_bwd_sm90``) at head dims 32,
    64 and 128 and the mma.sync form (``flash_bwd``) at 16 and 24; each
    route's entry and error string are bound C functions."""
    from esme_tpu_torch import _build
    assert {D: tflash.bwd_route(D) for D in tflash.HEAD_DIMS} == {
        16: 'flash_bwd', 24: 'flash_bwd', 32: 'flash_bwd_sm90',
        64: 'flash_bwd_sm90', 128: 'flash_bwd_sm90'}
    for name, fns in tflash.BWD_ROUTES.items():
        assert set(fns) <= set(_build.SIGNATURES[name])
    assert set(_build.SIGNATURES['flash_bwd_sm90']) == {
        'esme_segment_flash_bwd_sm90', 'esme_flash_bwd_sm90_pass',
        'esme_flash_bwd_sm90_error_string'}
    src = (_build.CSRC / 'flash_bwd_sm90.cu').read_text()
    for fn in _build.SIGNATURES['flash_bwd_sm90']:
        assert re.search(rf'^\S.* {fn}\(', src, re.M), fn


def test_fwd_route_is_a_static_rule_on_head_dim():
    """H1 launches the Hopper form (``flash_fwd_sm90``) at head dims 32,
    64 and 128 and the mma.sync form (``flash_fwd``) at 16 and 24; each
    route's entry and error string are bound C functions, and each of the
    Hopper library's bound functions is defined in its source."""
    from esme_tpu_torch import _build
    assert {D: tflash.fwd_route(D) for D in tflash.HEAD_DIMS} == {
        16: 'flash_fwd', 24: 'flash_fwd', 32: 'flash_fwd_sm90',
        64: 'flash_fwd_sm90', 128: 'flash_fwd_sm90'}
    for name, fns in tflash.FWD_ROUTES.items():
        assert set(fns) <= set(_build.SIGNATURES[name])
    assert set(_build.SIGNATURES['flash_fwd_sm90']) == {
        'esme_segment_flash_fwd_sm90', 'esme_flash_fwd_t_sm90',
        'esme_segment_flash_fwd_sm90_variant',
        'esme_flash_fwd_sm90_error_string'}
    # the same C signatures as the mma.sync form's entries (H1's, H6's)
    for entry in ('esme_segment_flash_fwd', 'esme_segment_flash_fwd_variant'):
        assert _build.SIGNATURES['flash_fwd_sm90'][
            entry.replace('fwd', 'fwd_sm90', 1)] == \
            _build.SIGNATURES['flash_fwd'][entry]
    src = (_build.CSRC / 'flash_fwd_sm90.cu').read_text()
    for fn in _build.SIGNATURES['flash_fwd_sm90']:
        assert re.search(rf'^\S.* {fn}\(', src, re.M), fn


@pytest.mark.parametrize('D', [16, 64])
def test_flash_fwd_on_cpu_is_the_plain_version(D):
    """On a CPU tensor ``segment_flash_fwd`` returns its plain version's
    outputs, bit for bit, on either route's head dim, and moves no
    counter."""
    rng = np.random.default_rng(D)
    T, H = 300, 2
    q, k, v = (torch.from_numpy(rng.standard_normal((T, H * D))
                                .astype(np.float32)) for _ in range(3))
    seg = torch.from_numpy(np.repeat(np.arange(3), [120, 100, 80])
                           .astype(np.int32))
    ks, ke = tflash.block_spans(seg, tflash.BLOCK_Q, tflash.BLOCK_K)
    before = tflash.segment_flash_fwd.launches
    got = tflash.segment_flash_fwd(q, k, v, seg, ks, ke, H)
    ref = tflash.segment_flash_fwd_plain(q, k, v, seg, ks, ke, H)
    assert all(map(torch.equal, got, ref))
    assert tflash.segment_flash_fwd.launches == before == 0


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the script runs for real')
    run = subprocess.run([sys.executable, 'chip_smoke.py'],
                         capture_output=True, text=True, timeout=120,
                         cwd=PKG.parent)
    assert run.returncode != 0
    assert run.stdout == '' and 'no CUDA device' in run.stderr
