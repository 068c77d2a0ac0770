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


FINE_TUNE_MODULES = ('esme_tpu_torch.metrics', 'esme_tpu_torch.logger',
                     'esme_tpu_torch.lora', 'esme_tpu_torch.ops.pooling',
                     'esme_tpu_torch.models.heads',
                     'esme_tpu_torch.train.partition',
                     'esme_tpu_torch.train.checkpoint')


def test_fine_tune_modules_load_no_jax():
    """The fine-tuning slice's modules, each imported alone in a fresh
    interpreter, load no JAX and nothing of the JAX package."""
    code = ('import importlib, sys\n'
            f'for m in {FINE_TUNE_MODULES!r}:\n'
            '    importlib.import_module(m)\n'
            "print(sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'esme_tpu')))")
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, check=True, cwd=PKG.parent).stdout
    assert out.strip() == '[]', out
    for m in FINE_TUNE_MODULES:
        path = PKG.parent / (m.replace('.', '/') + '.py')
        assert path.is_file(), path


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


_IMPORT_ALL_PANDAS = _IMPORT_ALL.replace("('jax', 'jaxlib', 'esme_tpu')",
                                         "('pandas',)")


def test_port_loads_and_names_no_pandas():
    """The card's machine has no pandas: importing every module of the
    port loads none, and no source file of it imports it (the variant
    scores are dicts, ``esme_tpu_torch/variant.py``)."""
    assert "('pandas',)" in _IMPORT_ALL_PANDAS
    out = subprocess.run([sys.executable, '-c', _IMPORT_ALL_PANDAS],
                         capture_output=True, text=True, check=True,
                         cwd=PKG.parent).stdout.split('\n')
    assert int(out[0]) >= 15 and out[1] == '[]', out
    pattern = re.compile(r'^\s*(from|import)\s+pandas\b', re.M)
    files = sorted(PKG.rglob('*.py'))
    assert [f.name for f in files if pattern.search(f.read_text())] == []
    assert (PKG / 'variant.py') in files


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


# What each tool's CPU run prints of its modes; the heads of its batch
# there (its other shapes as the tool sets them: the 1,100-token budget
# gives one sequence and the padding tail, a ragged last tile)
TOOL_OUTPUT = {fwd_T_experiment: 'fwd_T', flash_variants: 'baseline',
               decompose_bwd: 'dkv no_acc', profile_attn: 'dma'}
TOOL_CPU_HEADS = 2


@pytest.mark.parametrize('tool', list(TOOL_OUTPUT),
                         ids=lambda t: t.__name__.rsplit('.', 1)[-1])
def test_cpu_tools_launch_no_kernel(tool, monkeypatch):
    """Each probe tool run through on the CPU (plain versions, every mode)
    moves no kernel's counter. Its batch has 2 heads, and torch takes one
    thread: the plain versions' work is ~75 CPU-seconds at 20 heads, and
    beside other test processes each taking every core, its threads
    contend (680 s in one run of the suite on six workers)."""
    import contextlib
    import functools
    import io
    from esme_tpu_torch import tools
    monkeypatch.setattr(tools, 'CPU_BUDGET', 1100)
    monkeypatch.setattr(tool, 'attention_batch', functools.partial(
        tools.attention_batch, heads=TOOL_CPU_HEADS))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(io.StringIO()) as out:
            tool.main(['--device', 'cpu'])
    finally:
        torch.set_num_threads(threads)
    assert TOOL_OUTPUT[tool] in out.getvalue()
    assert f'H={TOOL_CPU_HEADS} ' in out.getvalue()
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


def test_sm90_ab_takes_a_head_shape(monkeypatch, tmp_path):
    """``tools/sm90_ab.py`` takes ESM2-15B's attention (``--heads 40
    --head-dim 128``) and still refuses to run without a card before it
    builds anything; a head dim no kernel is built for is refused; its
    backward cases are H2's two passes together and alone and H10 on one
    rank."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the tool runs for real')
    from esme_tpu_torch import _build
    from esme_tpu_torch.tools import sm90_ab
    monkeypatch.setattr(_build, 'BUILD_ROOT', tmp_path / 'build')
    variant = str(tmp_path / 'variant.cu')
    with pytest.raises(RuntimeError, match='needs a card'):
        sm90_ab.main(['flash_bwd_sm90', variant, '--heads', '40',
                      '--head-dim', '128'])
    with pytest.raises(SystemExit):
        sm90_ab.main(['flash_bwd_sm90', variant, '--head-dim', '48'])
    assert not (tmp_path / 'build').exists()
    b = sm90_ab.attention_batch

    def small(**kw):
        return b(budget=2048, device='cpu', dtype=torch.float32, **kw)
    monkeypatch.setattr(sm90_ab, 'attention_batch', small)
    cases = sm90_ab.backward_cases(4, 128)
    assert {k: kind for k, (kind, _) in cases.items()} == {
        'H2': 'both', 'H2 dk/dv': 'dkv', 'H2 dq': 'dq',
        'H10 one rank': 'rect', **{f'H10 rank {r} of 4': 'rank'
                                   for r in range(4)}}
    h2, rect = cases['H2'][1], cases['H10 one rank'][1]
    assert h2[0].shape[1] == 4 * 128 and rect[-1] == h2[-1] == 4
    # one rank: H10's spans are H2's
    assert all(map(torch.equal, h2[7:11], rect[7:11]))


def test_sm90_ab_forward_cases(monkeypatch):
    """``tools/sm90_ab.py``'s forward cases are H1 on the inference batch,
    H9 on one rank (its queries over its own keys), whose spans are H1's,
    so the two launches walk the same stages, and H9 on each rank of a
    4-way split; at D = 64 H9's with its launch order, whose q-block-order
    twin (the same arguments, no order) runs in the same turns, and H1's
    and all at D = 128 (no order there) in q-block order alone, without a
    twin."""
    from esme_tpu_torch.tools import sm90_ab
    b = sm90_ab.attention_batch

    def small(**kw):
        return b(budget=2048, device='cpu', dtype=torch.float32, **kw)
    monkeypatch.setattr(sm90_ab, 'attention_batch', small)
    ranks = {f'H9 rank {r} of 4': 'rect' for r in range(4)}
    cases = sm90_ab.forward_cases(4, 128)
    assert {k: kind for k, (kind, _) in cases.items()} == {
        'H1': 'square', 'H9 one rank': 'rect', **ranks}
    assert all(args[-1] is None for _, args in cases.values())
    assert not any(sm90_ab.q_block_twin('flash_fwd_sm90', c)
                   for c in cases.values())
    h1, rect = cases['H1'][1], cases['H9 one rank'][1]
    assert h1[0].shape[1] == 4 * 128 and rect[6] == h1[6] == 4
    assert all(map(torch.equal, h1[:6], rect[:6]))
    assert h1[7] is None and rect[7] is h1[3]
    cases = sm90_ab.forward_cases(4, 64)
    assert {k: kind for k, (kind, _) in cases.items()} == {
        'H1': 'square', 'H9 one rank': 'rect', **ranks}
    assert cases.pop('H1')[1][-1] is None   # H1 runs in q-block order
    for case, (kind, args) in cases.items():
        assert torch.equal(args[-1], tflash.fwd_order(args[4], args[5]))
        twin_kind, twin = sm90_ab.q_block_twin('flash_fwd_sm90',
                                               (kind, args))
        assert twin_kind == kind and twin[-1] is None
        assert all(a is b_ for a, b_ in zip(twin[:-1], args[:-1]))
    assert sm90_ab.q_block_twin('flash_bwd_sm90',
                                cases['H9 one rank']) is None


def test_sm90_ab_rank_split_is_chip_smokes():
    """``tools/sm90_ab.py``'s split of H10 over ranks is
    ``chip_smoke.py:time_rect_bwd``'s: on a 2,048-token masked-LM batch
    split four ways, each rank's query rows, their ids, H9's lse, delta
    and H10's spans are the ones ``chip_smoke.py`` gives it over the same
    keys, and the ranks cover the queries once."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from esme_tpu_torch.models.esm import packed_meta
    from esme_tpu_torch.tools import BWD_SEED, sm90_ab
    b = sm90_ab.attention_batch(budget=2048, seed=BWD_SEED, heads=2,
                                head_dim=64, device='cpu',
                                dtype=torch.float32, grads=True)
    _, cu, _ = chip_smoke.packed_batch(2048, seed=2)
    assert np.array_equal(b.cu, cu) and BWD_SEED == 2
    seg = packed_meta(torch.as_tensor(cu), 2048)[0].contiguous()
    q, k, v, do = (x[:2048] for x in (b.q, b.k, b.v, b.do))
    split = sm90_ab.rank_split(b, 4)
    rows = chip_smoke.rank_rows(2048, 4)
    assert [lh for lh, *_ in split] == rows
    assert rows[0][0] == 0 and rows[-1][1] == 2048
    assert all(a[1] == b_[0] for a, b_ in zip(rows, rows[1:]))
    for ((lo, hi), args, seg_k), want in zip(
            split, (chip_smoke.rect_bwd_args(q, k, v, do, seg, lo, hi, 2)
                    for lo, hi in rows)):
        assert torch.equal(seg_k, seg)
        assert args[-1] == want[-1] == 2
        for got, ref in zip(args[:-1], want[:-1]):
            assert torch.equal(got, ref)


def test_sm90_ab_rect_split_is_chip_smokes():
    """``tools/sm90_ab.py``'s split of H9 over ranks is
    ``chip_smoke.py:time_rect``'s: on a 2,048-token inference batch split
    four ways, each rank's query rows, their ids, the keys and H9's spans
    are the ones ``chip_smoke.py:rect_args`` gives it, the keys' ids are
    the batch's without the ALIGN pad, and each rank's launch order is
    ``fwd_order`` of its spans."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from esme_tpu_torch.models.esm import packed_meta
    from esme_tpu_torch.tools import FWD_SEED, sm90_ab
    b = sm90_ab.attention_batch(budget=2048, seed=FWD_SEED, heads=2,
                                head_dim=64, device='cpu',
                                dtype=torch.float32)
    _, cu, _ = chip_smoke.packed_batch(2048, seed=0)
    assert np.array_equal(b.cu, cu) and FWD_SEED == 0
    seg = packed_meta(torch.as_tensor(cu), 2048)[0].contiguous()
    q, k, v = (x[:2048] for x in (b.q, b.k, b.v))
    split = sm90_ab.rect_rank_split(b, 4)
    rows = chip_smoke.rank_rows(2048, 4)
    assert [lh for lh, _ in split] == rows
    for ((lo, hi), args), want in zip(
            split, (chip_smoke.rect_args(q, k, v, seg, lo, hi, 2)
                    for lo, hi in rows)):
        assert torch.equal(args[7], seg) and args[6] == want[-1] == 2
        for got, ref in zip(args[:6], want[:-1]):
            assert torch.equal(got, ref)
        assert torch.equal(args[8], tflash.fwd_order(args[4], args[5]))


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
    """H2 launches the Hopper form (``flash_bwd_sm90``) at every head dim,
    16 and 24 included; the mma.sync form (``flash_bwd``) stays a bound
    library. Each route's entry and error string are bound C
    functions."""
    from esme_tpu_torch import _build
    assert {D: tflash.bwd_route(D) for D in tflash.HEAD_DIMS} == {
        16: 'flash_bwd_sm90', 24: 'flash_bwd_sm90', 32: 'flash_bwd_sm90',
        64: 'flash_bwd_sm90', 128: 'flash_bwd_sm90'}
    assert tflash.bwd_route(48) == 'flash_bwd'
    for name, fns in tflash.BWD_ROUTES.items():
        assert set(fns) <= set(_build.SIGNATURES[name])
    assert set(_build.SIGNATURES['flash_bwd_sm90']) == {
        'esme_segment_flash_bwd_sm90', 'esme_flash_bwd_sm90_pass',
        'esme_segment_flash_bwd_rect_sm90', 'esme_flash_bwd_rect_sm90_pass',
        'esme_flash_bwd_sm90_timeline', 'esme_flash_bwd_sm90_error_string'}
    # H10's entry of each of H2's libraries is bound, with one C signature
    # across the two forms (per-side ids and lengths)
    for name, entry in tflash.BWD_RECT_ENTRIES.items():
        assert entry in _build.SIGNATURES[name]
    assert _build.SIGNATURES['flash_bwd_sm90'][
        'esme_segment_flash_bwd_rect_sm90'] == \
        _build.SIGNATURES['flash_bwd']['esme_segment_flash_bwd_rect']
    for name in ('flash_bwd_sm90', 'flash_bwd'):
        src = (_build.CSRC / f'{name}.cu').read_text()
        for fn in _build.SIGNATURES[name]:
            assert re.search(rf'^\S.* {fn}\(', src, re.M), fn


def test_fwd_route_is_a_static_rule_on_head_dim():
    """H1 launches the Hopper form (``flash_fwd_sm90``) at every head dim,
    16 and 24 included; the mma.sync form (``flash_fwd``) stays a bound
    library. Each route's entry and error string are bound C functions,
    and each of the Hopper library's bound functions is defined in its
    source."""
    from esme_tpu_torch import _build
    assert {D: tflash.fwd_route(D) for D in tflash.HEAD_DIMS} == {
        16: 'flash_fwd_sm90', 24: 'flash_fwd_sm90', 32: 'flash_fwd_sm90',
        64: 'flash_fwd_sm90', 128: 'flash_fwd_sm90'}
    assert tflash.fwd_route(48) == 'flash_fwd'
    for name, fns in tflash.FWD_ROUTES.items():
        assert set(fns) <= set(_build.SIGNATURES[name])
    assert set(_build.SIGNATURES['flash_fwd_sm90']) == {
        'esme_segment_flash_fwd_sm90', 'esme_flash_fwd_t_sm90',
        'esme_segment_flash_fwd_sm90_variant',
        'esme_segment_flash_fwd_rect_sm90',
        'esme_flash_fwd_sm90_error_string'}
    # the same C signatures as the mma.sync form's entries (H1's, H6's,
    # H9's), H9's with its launch order as a trailing pointer
    for entry in ('esme_segment_flash_fwd', 'esme_segment_flash_fwd_variant',
                  'esme_segment_flash_fwd_rect'):
        sm90 = entry.replace('fwd', 'fwd_sm90', 1) if 'rect' not in entry \
            else entry + '_sm90'
        restype, argtypes = _build.SIGNATURES['flash_fwd'][entry]
        tail = [_build.P] if 'rect' in entry else []
        assert _build.SIGNATURES['flash_fwd_sm90'][sm90] == \
            (restype, argtypes + tail)
    assert tflash.ORDERED_LIBRARIES == ('flash_fwd_sm90',)
    # H9's entry of each of H1's libraries is bound
    for name, entry in tflash.FWD_RECT_ENTRIES.items():
        assert entry in _build.SIGNATURES[name]
    for name in ('flash_fwd_sm90', 'flash_fwd'):
        src = (_build.CSRC / f'{name}.cu').read_text()
        for fn in _build.SIGNATURES[name]:
            assert re.search(rf'^\S.* {fn}\(', src, re.M), fn


def test_probe_tools_route_is_their_own_rule():
    """The probe tools keep the forms they are built on where H1 and H2
    moved: H5's token-minor Hopper kernel and H6's and H7's Hopper modes
    at head dims 32-128, the mma.sync forms at 16 and 24 (where H1's and
    H2's routes are the Hopper forms)."""
    from esme_tpu_torch import tools
    from esme_tpu_torch.tools import fwd_T_experiment
    assert tools.SM90_HEAD_DIMS == (32, 64, 128)
    assert {D: (tools.fwd_route(D), tools.bwd_route(D))
            for D in tflash.HEAD_DIMS} == {
        16: ('flash_fwd', 'flash_bwd'), 24: ('flash_fwd', 'flash_bwd'),
        **{D: ('flash_fwd_sm90', 'flash_bwd_sm90') for D in (32, 64, 128)}}
    assert [fwd_T_experiment.fwd_T_route(D, 1024) for D in (16, 24, 32)] \
        == ['flash_fwd_t', 'flash_fwd_t', 'flash_fwd_sm90']
    assert flash_variants._library(None, 24) == 'flash_fwd'
    assert decompose_bwd._library(None, 16) == 'flash_bwd'
    assert flash_variants._library(None, 64) == tflash.fwd_route(64)
    assert decompose_bwd._library(None, 64) == tflash.bwd_route(64)


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


def test_first_call_tool_compares_traces():
    """``tools/first_call.py`` names the first op whose output differs
    between two traces of the same calls (None when all agree), and one
    process's three traced CPU forwards run."""
    from esme_tpu_torch.tools import first_call
    a = [('aten.mm', torch.ones(2)), ('aten.cos', torch.zeros(3))]
    b = [('aten.mm', torch.ones(2)), ('aten.cos', torch.full((3,), 0.5))]
    assert first_call.first_difference(a, a) is None
    assert first_call.first_difference(a, b) == ('aten.cos', 0.5)
    out = first_call.one_process()
    assert out == 'equal' or out.startswith('aten.')
