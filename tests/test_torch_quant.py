"""Weight quantization in the port (``esme_tpu_torch/quant.py`` and the
places that use it) against the JAX package's ``esme_tpu/quant.py``.

Inputs are seeded numpy arrays; models are tiny (2 layers, width 64, 4
heads) from JAX's init (``test_torch_families.py``'s recipe), carried over
with ``params_from_jax``; kernels reach 1280 x 5120.

Gates (each with its reason):
* bit-equal, dtypes and shapes included: each numpy twin against JAX's
  (the same numpy calls); each torch quantizer against JAX's jnp one
  (fp32 and bf16 values, one layer and stacked; the NF4 outlier rows in
  ``jax.lax.top_k``'s order on tied row maxima); ``dequantize`` (int8,
  NF4; one layer's 1-D ``outlier_idx`` and a stack's 2-D one; fp32 and
  bf16 out); ``quantize_model_params`` over ESM2 and ESMC trees; the
  streaming ``load_pretrained(quantization=)`` against JAX's (its fp32
  outlier rows included); the save/load round trip in both directions.
  The same fp32 operations in the same order give the same bits.
* ``linear`` over a quantized kernel with a bias and LoRA adapters: the
  dense LoRA gate of ``test_torch_lora.py`` (fp32 1e-5, bf16 2^-8 of the
  output's scale): both dequantize to the same bits, so what remains is
  the dense layer's summation order.
* quantized models' log-probabilities: ``test_torch_families.py``'s
  gates (fp32 5e-5 absolute; bf16 largest error 0.1, mean 0.01, per-token
  centred cosine 0.999), for the same reason.
* QLoRA, fp32: one step's loss 1e-5 relative and every adapter's and head
  leaf's gradient within 1e-4 of its largest (``test_torch_train.py``'s
  fp32 gradient gate); the aggregation head's key bias, whose gradient is
  0 in exact arithmetic, within 1e-6 of its kernel's largest (ROADMAP.md
  Queue 3, rule 15). No quantized leaf has a gradient, and after an
  update every frozen leaf keeps its bits and each trained leaf is within
  0.1·lr of JAX's (``test_torch_finetune.py``'s gate) where its gradient
  is above that gradient gate's resolution, 1e-4 of the leaf's largest;
  below it, where a gradient of Adam's eps (1e-8) differs in its last
  bits, Adam's first step can land anywhere within ±lr, so there the
  gate is 2·lr (measured 0.35·lr at a gradient of 3.7e-8). JAX's own
  ``RegressionTrainer`` cannot step over a quantized base (``jax.grad``
  of its integer leaves raises: ROADMAP.md Queue 3, item 24), so JAX's
  gradients are taken of its trainer's loss over the trainable leaves.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esme_tpu import quant as jq
from esme_tpu.data import LabeledDataset as JLabeledDataset
from esme_tpu.loss import cross_entropy as jcross_entropy
from esme_tpu.models import esm as jesm
from esme_tpu.models import io as jio
from esme_tpu.models.heads import init_learned_aggregation as jinit_head
from esme_tpu.ops import linear as jlinear
from esme_tpu.train import MaskedPLM as JMaskedPLM
from esme_tpu.train import RegressionTrainer as JRegressionTrainer
from esme_tpu.train.partition import split_by_mask

from esme_tpu_torch import ESM, ESM2, ESMC, LabeledDataset, tokenize_unpad
from esme_tpu_torch import quant as tq
from esme_tpu_torch.models import io as tio
from esme_tpu_torch.models.heads import init_learned_aggregation
from esme_tpu_torch.ops import linear as tlinear
from esme_tpu_torch.train import MaskedPLM, RegressionTrainer
from esme_tpu_torch.train.trainer import _grad_tree, _map

from test_torch_families import (SEQS, _batch, _configs, _gate,
                                 _jax_params, _leaves, _np)
from test_torch_lora import _lift_b

MODES = ['8bit', '4bit']
TCLASSES = {'esm2': ESM2, 'esmc': ESMC}
JCLASSES = {'esm2': jesm.ESM2, 'esmc': jesm.ESMC}


def _raw(x):
    """(dtype name, shape, bytes) of a torch tensor or a JAX/numpy array."""
    if torch.is_tensor(x):
        x = x.detach().cpu()
        name = str(x.dtype).split('.')[-1]
        a = x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    else:
        a = np.asarray(x)
        name = a.dtype.name
        if name == 'bfloat16':
            a = a.view(np.int16)
    return name, a.shape, np.ascontiguousarray(a).view(np.uint8)


def _assert_bits(got, ref, what=''):
    g, r = _raw(got), _raw(ref)
    assert g[:2] == r[:2], (what, g[:2], r[:2])
    assert np.array_equal(g[2], r[2]), what


def _assert_tree_bits(got, ref):
    g, r = dict(_leaves(got)), dict(_leaves(ref))
    assert sorted(g) == sorted(r), (sorted(g), sorted(r))
    for name in r:
        _assert_bits(g[name], r[name], name)


def _t(a):
    return tio.params_from_jax({'x': np.asarray(a)}, None)['x']


def _kernel(shape, dtype, seed=0):
    """A seeded ``(..., in, out)`` kernel as torch stores it: weights
    ``(..., out, in)`` from 0.02·N(0, 1) in ``dtype``, transposed. Returns
    the JAX array and its fp32 values in numpy."""
    w = np.random.default_rng(seed).standard_normal(
        (*shape[:-2], shape[-1], shape[-2])) * 0.02
    j = jnp.asarray(np.swapaxes(w, -1, -2)).astype(dtype)
    return j, np.asarray(j.astype(jnp.float32))


TWIN_CASES = {'128x64': ((128, 64), 'float32'),
              'stacked': ((3, 128, 64), 'float32'),
              'fc1_bf16': ((1280, 5120), 'bfloat16')}


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('case', sorted(TWIN_CASES))
def test_numpy_twins_match_jax(mode, case):
    shape, dtype = TWIN_CASES[case]
    _, w = _kernel(shape, dtype)
    _assert_tree_bits(tq.quantize_kernel_np(w, mode),
                      jq.quantize_kernel_np(w, mode))


@pytest.mark.parametrize('fn', ['quantize_int8', 'quantize_nf4'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape', [(128, 64), (3, 128, 64)],
                         ids=['one', 'stacked'])
def test_torch_quantizers_match_jax(fn, dtype, shape):
    j, _ = _kernel(shape, dtype, seed=1)
    got = getattr(tq, fn)(_t(j))
    _assert_tree_bits(got, getattr(jq, fn)(j))
    for out in ('float32', 'bfloat16'):
        _assert_bits(tq.dequantize(got, getattr(torch, out)),
                     jq.dequantize(getattr(jq, fn)(j), getattr(jnp, out)))


def test_nf4_ties_follow_each_jax_function():
    """The bf16 fc1 kernel of ESM2-650M's width (seed 0): its 16th and
    17th largest row maxima tie. JAX's numpy twin (``np.argsort``) keeps
    other outlier rows than its jnp form (``top_k``), so the two give
    other weights; the port's twin equals JAX's twin, its torch quantizer
    JAX's jnp one (ROADMAP.md Queue 3, item 23)."""
    j, w = _kernel((1280, 5120), 'bfloat16')
    top = np.sort(np.abs(w).max(-1))[::-1]
    assert top[15] == top[16]
    twin, jnp_form = jq.quantize_nf4_np(w), jq.quantize_nf4(j)
    assert set(twin['outlier_idx'].tolist()) != set(
        np.asarray(jnp_form['outlier_idx']).tolist())
    got = tq.quantize_nf4(_t(j))
    _assert_tree_bits(got, jnp_form)
    _assert_tree_bits(tq.quantize_nf4_np(w), twin)
    assert list(got['outlier_idx']) == sorted(
        range(1280), key=lambda i: (-np.abs(w[i]).max(), i))[:16]
    _assert_bits(tq.dequantize(got), jq.dequantize(jnp_form))
    assert not np.array_equal(*(_raw(x)[2] for x in (
        jq.dequantize(twin, jnp.float32), jq.dequantize(jnp_form,
                                                        jnp.float32))))


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('lead', [(), (3,)], ids=['one', 'stacked'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_dequantize_matches_jax(mode, lead, dtype):
    """JAX's quantized leaves carried over; ``outlier_idx`` 1-D for one
    layer, 2-D for a stack."""
    j, _ = _kernel((*lead, 256, 96), dtype, seed=2)
    jp = {'8bit': jq.quantize_int8, '4bit': jq.quantize_nf4}[mode](j)
    tp = {k: _t(v) for k, v in jp.items()}
    if mode == '4bit':
        assert tp['outlier_idx'].dim() == len(lead) + 1
    for out in ('float32', 'bfloat16'):
        _assert_bits(tq.dequantize(tp, getattr(torch, out)),
                     jq.dequantize(jp, getattr(jnp, out)))
    codes = np.arange(16, dtype=np.uint8).reshape(4, 4)
    _assert_bits(tq._nf4_decode(torch.from_numpy(codes)),
                 jq._nf4_decode(jnp.asarray(codes)))


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('family', ['esm2', 'esmc'])
def test_quantize_model_params_matches_jax(family, mode):
    """The whole tree, and the model's ``quantize``, against JAX's
    ``quantize_model_params`` of the same bf16 weights."""
    jcfg, tcfg = _configs(family, 'bfloat16')
    jp = jax.tree.map(np.asarray, _jax_params(family, 'bfloat16'))
    ref = jq.quantize_model_params(jax.tree.map(jnp.asarray, jp), jcfg, mode)
    got = tq.quantize_model_params(tio.params_from_jax(jp, tcfg), tcfg, mode)
    _assert_tree_bits(got, ref)
    model = TCLASSES[family](config=tcfg, params=tio.params_from_jax(
        jp, tcfg), device='cpu')
    assert model.quantize(mode) is model
    _assert_tree_bits(model.params, ref)
    assert 'kernel' in model.params['lm_head']['dense']


def _jax_file(tmp_path, dtype='bfloat16'):
    jcfg, _ = _configs('esm2', dtype)
    path = str(tmp_path / 'esm2_t.safetensors')
    jio.save_pretrained(path, _jax_params('esm2', dtype), jcfg, 'esm2_t')
    return path


@pytest.mark.parametrize('mode', MODES)
def test_streaming_load_matches_jax(tmp_path, mode):
    """Quantize-at-load on the host, both entry points, by keyword and in
    JAX's positional slot: JAX's leaves, dtypes included (NF4's outlier
    rows fp32, as JAX's streaming loader keeps them)."""
    path = _jax_file(tmp_path)
    _, ref, _ = jio.load_pretrained(path, 'bfloat16', quantization=mode)
    _, got, name = tio.load_pretrained(path, 'bfloat16', mode)
    assert name == 'esm2_t'
    _assert_tree_bits(got, ref)
    if mode == '4bit':
        assert got['layers']['attn']['q']['outlier_rows'].dtype == \
            torch.float32
    for load in (ESM.from_pretrained, ESM2.from_pretrained):
        _assert_tree_bits(load(path, quantization=mode, device='cpu').params,
                          ref)
        _assert_tree_bits(load(path, mode, device='cpu').params, ref)


@pytest.mark.parametrize('mode', MODES)
def test_quantized_save_load_round_trip(tmp_path, mode):
    """A quantized model saves with the ``quantization`` (and, for NF4,
    ``qscheme``) metadata and loads back bit for bit, its log-probs too;
    JAX reads the port's file as the same leaves, and the port reads
    JAX's."""
    jcfg, tcfg = _configs('esm2', 'bfloat16')
    jp = jax.tree.map(np.asarray, _jax_params('esm2', 'bfloat16'))
    model = ESM2(config=tcfg, params=tio.params_from_jax(jp, tcfg),
                 device='cpu').quantize(mode)
    path = str(tmp_path / 'q.safetensors')
    model.save_pretrained(path, name='esm2_q')
    meta = tio.read_metadata(path)
    assert meta['quantization'] == mode
    assert meta.get('qscheme') == ('outlier-rows-v1' if mode == '4bit'
                                   else None)
    back = ESM.from_pretrained(path, device='cpu')
    _assert_tree_bits(back.params, model.params)
    tok, _, cu, ml = tokenize_unpad(SEQS[:3])
    assert torch.equal(back.predict_log_prob(tok, pad_args=(cu, ml)),
                       model.predict_log_prob(tok, pad_args=(cu, ml)))
    _, jback, _ = jio.load_pretrained(path, 'bfloat16')
    _assert_tree_bits(model.params, jback)
    jpath = str(tmp_path / 'jq.safetensors')
    jio.save_pretrained(jpath, jq.quantize_model_params(
        jax.tree.map(jnp.asarray, jp), jcfg, mode), jcfg, 'esm2_q')
    _assert_tree_bits(tio.load_pretrained(jpath)[1], model.params)


def test_quantization_errors(tmp_path):
    """A file declaring ``qscheme: outlier-rows-v1`` without its outlier
    keys is refused by both packages; NF4 at an input width that is not a
    multiple of 64 (ESM2-35M's 480) raises in both."""
    _, tcfg = _configs('esm2', 'bfloat16')
    path = str(tmp_path / 'q4.safetensors')
    ESM2(config=tcfg, device='cpu').quantize('4bit').save_pretrained(path)
    flat, meta = tio.read_safetensors(path)
    stripped = str(tmp_path / 'stripped.safetensors')
    tio.write_safetensors(stripped, {k: v for k, v in flat.items()
                                     if '.qoutlier_' not in k}, meta)
    with pytest.raises(ValueError, match='qscheme=outlier-rows-v1'):
        ESM.from_pretrained(stripped, device='cpu')
    with pytest.raises(ValueError, match='qscheme=outlier-rows-v1'):
        jio.load_pretrained(stripped)
    w = np.zeros((480, 64), np.float32)
    with pytest.raises(AssertionError):
        jq.quantize_nf4(jnp.asarray(w))
    for fn in (lambda: tq.quantize_nf4(torch.from_numpy(w)),
               lambda: tq.quantize_nf4_np(w),
               lambda: ESM2(2, 480, 20, dtype='float32',
                            device='cpu').quantize('4bit')):
        with pytest.raises(ValueError, match='480 not divisible by 64'):
            fn()
    with pytest.raises(ValueError, match='quantization mode'):
        ESM2(config=tcfg, device='cpu').quantize('2bit')


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_quantized_linear_matches_jax(mode, dtype):
    """``linear`` over a quantized kernel with a bias and two adapters."""
    rng = np.random.default_rng(3)
    jdt = getattr(jnp, dtype)
    D, O, r = 128, 96, 8

    def arr(shape, sc):
        return jnp.asarray(rng.standard_normal(shape) * sc, jdt)
    jp = jq.quantize_params({
        'kernel': arr((D, O), D ** -0.5), 'bias': arr((O,), 0.1),
        'lora': {n: {'a': arr((D, r), D ** -0.5), 'b': arr((r, O), 0.2),
                     'scale': jnp.asarray(s, jnp.float32)}
                 for n, s in (('u', 2.0), ('w', 0.5))}}, mode)
    tp = jax.tree.map(_t, jp)
    x = arr((130, D), 1.0)
    for names in (None, ('w',), ()):
        ref = _np(jlinear.linear(x, jp, names))
        got = tlinear.linear(_t(x), tp, names)
        assert got.dtype == getattr(torch, dtype)
        tol = 1e-5 if dtype == 'float32' else 2.0 ** -8
        assert np.abs(_np(got) - ref).max() <= tol * np.abs(ref).max(), names


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_quantized_matmul_gradient_keeps_only_the_stored_leaves(mode, dtype):
    """``quantized_matmul``'s gradient of ``x`` against JAX's (the gate of
    ``test_quantized_linear_matches_jax``) and bit-equal to autograd over
    the plain product, while its backward keeps the stored leaves alone:
    no dense kernel and not ``x``; its product is bit-equal to the one
    taken without a gradient. A stored leaf that requires a gradient is
    refused: quantized storage never trains."""
    rng = np.random.default_rng(5)
    jdt = getattr(jnp, dtype)
    D, O = 128, 96
    jp = jq.quantize_params({'kernel': jnp.asarray(
        rng.standard_normal((D, O)) * D ** -0.5, jdt)}, mode)
    xj = jnp.asarray(rng.standard_normal((130, D)), jdt)
    gj = jnp.asarray(rng.standard_normal((130, O)), jdt)
    ref = _np(jax.grad(lambda x: jnp.sum(
        (jq.quantized_matmul(x, jp) * gj).astype(jnp.float32)))(xj))
    tp = jax.tree.map(_t, jp)
    g = _t(gj)

    def grad_x(fn, params):
        x = _t(xj).requires_grad_()
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t) or t, lambda t: t):
            y = fn(x, params)
        (y * g).float().sum().backward()
        return x.grad, saved, y.detach()

    got, saved, y = grad_x(tq.quantized_matmul, tp)
    plain, _, _ = grad_x(lambda x, p: torch.matmul(
        x, tq.dequantize(p, dtype=x.dtype)), tp)
    _assert_bits(got, plain)
    with torch.no_grad():
        _assert_bits(y, tq.quantized_matmul(_t(xj), tp))
    tol = 1e-5 if dtype == 'float32' else 2.0 ** -8
    assert np.abs(_np(got) - ref).max() <= tol * np.abs(ref).max()
    stored = {t.data_ptr() for t in tp.values()}
    big = [tuple(t.shape) for t in saved if t.data_ptr() not in stored
           and t.numel() >= D * O]
    assert not big, big
    with pytest.raises(ValueError, match='never trains'):
        tq.quantized_matmul(_t(xj), {
            **tp, 'scale': tp['scale'].clone().requires_grad_()})


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('family,dtype', [('esm2', 'float32'),
                                          ('esm2', 'bfloat16'),
                                          ('esmc', 'float32')])
def test_quantized_model_matches_jax(family, dtype, mode):
    """``predict_log_prob`` of the port's quantized model against JAX's
    quantized model on the same weights (JAX's einsum attention)."""
    lift = 'all' if dtype == 'float32' else 'embed'
    jcfg, tcfg = _configs(family, dtype)
    jp = _jax_params(family, dtype, lift)
    model = TCLASSES[family](config=tcfg, params=tio.params_from_jax(
        jax.tree.map(np.asarray, jp), tcfg), device='cpu').quantize(mode)
    jqp = jq.quantize_model_params(jp, jcfg, mode)
    tok, _, cu, ml = tokenize_unpad(SEQS, alphabet=model.alphabet)
    got = model.predict_log_prob(tok, pad_args=(cu, ml)).numpy()
    seg, pos = jesm.packed_meta(jnp.asarray(cu), tok.shape[0])
    ref = jesm.forward_flat(jqp, jcfg, jnp.asarray(tok), seg, pos,
                            log_prob=True, attn_impl='reference')
    _gate(got, np.asarray(ref, np.float32), dtype)


@functools.lru_cache(maxsize=None)
def _jax_qlora():
    """JAX's tiny fp32 ESM2 (seed 3, every leaf lifted), quantized to NF4,
    with adapters (rank 4, alpha 8 on query, value and output) whose ``b``
    is non-zero."""
    jcfg, _ = _configs('esm2', 'float32')
    jm = jesm.ESM2(config=jcfg, params=_jax_params('esm2', 'float32', 'all'))
    jm.quantize('4bit').add_lora(rank=4, alpha=8)
    return _lift_b(jm.params, 12), jm.lora_kwargs


def _qlora_pair():
    jp, kw = _jax_qlora()
    jcfg, tcfg = _configs('esm2', 'float32')
    jm = jesm.ESM2(config=jcfg, params=jax.tree.map(jnp.copy, jp))
    jm.lora_kwargs = dict(kw)
    tm = ESM2(config=tcfg, params=tio.params_from_jax(
        jax.tree.map(np.asarray, jp), tcfg), device='cpu')
    tm.lora_kwargs = dict(kw)
    return jm, tm


def _jax_grads(loss, params, mask):
    """JAX's loss and gradients over the leaves ``mask`` trains, by name."""
    train, frozen, treedef, flags = split_by_mask(params, mask)
    paths = [jax.tree_util.keystr(p, simple=True, separator='.') for p, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]

    def of_train(t):
        it_t, it_f = iter(t), iter(frozen)
        return loss(jax.tree_util.tree_unflatten(
            treedef, [next(it_t) if f else next(it_f) for f in flags]))
    value, grads = jax.value_and_grad(of_train)(train)
    names = [p for p, f in zip(paths, flags) if f]
    return float(value), dict(zip(names, map(np.asarray, grads)))


def _check_grads(loss, grads, jloss, jgrads, zero=()):
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    got = {k: v for k, v in _leaves(grads) if v is not None}
    assert sorted(got) == sorted(jgrads)
    for name, ref in jgrads.items():
        g = got[name].numpy()
        assert g.shape == ref.shape, name
        if name in zero:
            scale = np.abs(jgrads[zero[name]]).max()
            assert max(np.abs(g).max(), np.abs(ref).max()) <= 1e-6 * scale
            continue
        err = np.abs(g - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), (name, err)


def _quant_leaves(params):
    return {k: v for k, v in _leaves(params)
            if k.split('.')[-1] in tq.NON_TRAINABLE_QUANT_LEAVES
            and k.split('.')[-2] in ('q', 'k', 'v', 'out', 'fc1', 'fc2')}


def test_masked_plm_lora_only_over_nf4_matches_jax():
    """One ``MaskedPLM(lora_only=True)`` step over an NF4 base: the loss
    and the adapters' gradients against JAX's, nothing else with a
    gradient, and bit-equal with checkpointing (the recompute dequantizes
    again); then an update moves the adapters alone."""
    jm, tm = _qlora_pair()
    batch = _batch(300, 512, seed=5, alphabet=ESM2.alphabet)
    seg, pos = jesm.packed_meta(jnp.asarray(batch.cu_lens), 512)

    def jloss(p):
        logits = jesm.forward_flat(p, jm.config,
                                   jnp.asarray(batch.masked_tokens), seg, pos)
        return jcross_entropy(logits, jnp.asarray(batch.tokens),
                              jnp.asarray(batch.mask))
    ref = _jax_grads(jloss, jm.params, jm.trainable_filter())
    lr = 1e-3
    plm = MaskedPLM(tm, learning_rate=lr, lora_only=True)
    loss, grads = plm._grad_step(batch)
    _check_grads(loss.item(), grads, *ref)
    assert len(ref[1]) == 3 * 2                  # q, v, out: a and b
    quant = _quant_leaves(tm.params)
    assert len(quant) == 6 * 4 and all(
        dict(_leaves(grads))[k] is None for k in quant)
    # checkpointed layers dequantize again in the recompute: the same bits
    ckpt = ESM2(config=tm.config, params=tm.params, device='cpu',
                checkpointing=True)
    ckpt.lora_kwargs = tm.lora_kwargs
    loss_c, grads_c = MaskedPLM(ckpt, lora_only=True)._grad_step(batch)
    assert loss_c.item() == loss.item()
    for name, g in _leaves(grads):
        if g is not None:
            _assert_bits(dict(_leaves(grads_c))[name], g, name)
    start = {k: v.clone() for k, v in _leaves(tm.params)}
    jt = JMaskedPLM(jm, learning_rate=lr)
    np.testing.assert_allclose(plm.training_step(batch),
                               jt.training_step(batch), rtol=1e-5)
    jafter = dict(_leaves(jax.tree.map(np.asarray, jt.state.params)))
    for name, v in _leaves(tm.params):
        if name in ref[1]:
            err = np.abs(v.numpy() - jafter[name])
            g = np.abs(ref[1][name])
            sure = g > 1e-4 * g.max()
            assert err[sure].max() <= 0.1 * lr and err.max() <= 2 * lr, name
        else:
            _assert_bits(v, start[name], name)


def test_regression_trainer_over_nf4_matches_jax():
    """One ``RegressionTrainer`` step over an NF4 base with the
    aggregation head: the loss, the adapters' and the head's gradients
    against JAX's trainer loss differentiated over the same leaves; no
    quantized leaf has a gradient, and the update keeps their bits."""
    jm, tm = _qlora_pair()
    rng = np.random.default_rng(9)
    seqs = [''.join(rng.choice(list('LAGVSERTIDPKQNFYMHWC'),
                               rng.integers(20, 60))) for _ in range(8)]
    labels = rng.standard_normal(8).tolist()
    kw = dict(token_per_batch=256, shuffle=False)
    jb = JLabeledDataset(seqs, labels, **kw)[0]
    tb = LabeledDataset(seqs, labels, **kw)[0]
    jh = jinit_head(0, 64, num_cls=1, attention_heads=4, dtype=jnp.float32)
    th = tio.params_from_jax(jax.tree.map(np.asarray, jh), None)
    jt = JRegressionTrainer(jm, jh)
    _, seg, pos, S, weight = jt._batch_meta(jb)

    def jloss(p):
        return jt._loss_fn(p, jnp.asarray(jb.tokens, jnp.int32), seg, pos,
                           jnp.asarray(jb.labels), weight, S,
                           int(jb.max_len))
    params = {'plm': jm.params, 'head': jh}
    mask = {'plm': jm.trainable_filter(), 'head': jax.tree.map(
        lambda _: True, jh)}
    ref = _jax_grads(jloss, params, mask)
    tt = RegressionTrainer(tm, th)
    loss = tt._grad_step(tb)
    grads = {'plm': _grad_tree(tt._views),
             'head': _map(lambda t: t.grad, tt._head_views)}
    _check_grads(loss.item(), grads, *ref, zero={'head.k.bias':
                                                 'head.k.kernel'})
    assert all(dict(_leaves(grads['plm']))[k] is None
               for k in _quant_leaves(tm.params))
    quant = {k: v.clone() for k, v in _quant_leaves(tm.params).items()}
    assert np.isfinite(tt.training_step(tb))
    for name, v in _quant_leaves(tm.params).items():
        _assert_bits(v, quant[name], name)
