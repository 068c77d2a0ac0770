"""Masked-LM training in the port vs the JAX package: ``gelu_linear``'s
gradient, whole-model gradients of every leaf against
``jax.grad(cross_entropy ∘ forward_flat)``, and ``MaskedPLM`` against
JAX's ``MaskedPLM`` from the same weights on the same batches.

On the CPU the kernels run as their plain versions; the JAX side runs
its Pallas kernels in interpret mode (``attn_impl='flash'``: the
token-minor path, forward K1 and backward K4) or its einsum attention
(``'reference'``). The bf16 model is held against the einsum path:
XLA:CPU cannot run the bf16 backward of the JAX token-minor path
("Unsupported element type for DotThunk::Execute: BF16 x BF16 = F32").

Gates (each with its reason):
* ``gelu_linear``: fp32 1e-5 relative to the gradient's scale (the same
  fp32 math); bf16 2^-6 of the scale (both round dh, the GELU
  derivative and each product to bf16, XLA at other points).
* whole-model gradients, fp32 (ESM2-8M shape: 6 layers, width 320, 20
  heads of 16): loss 1e-5 relative and per leaf max|Δ| ≤ 1e-4 · max|g|
  (the same fp32 function summed in another order through 6 layers;
  measured at most 1.9e-6 · max|g|).
* whole-model gradients, bf16 (ESM2-650M width at 2 layers): loss 1e-3
  relative, per leaf cosine ≥ 0.999 and max|Δ| ≤ 2^-4 · max|g| (bf16
  activations rounded at other points in each layer, carried through
  the backward; measured: loss 1.3e-4, cosine ≥ 0.99981, max|Δ| ≤
  0.020 · max|g|).
* ``MaskedPLM`` over 3 fp32 steps: losses 1e-5 relative; params
  within 0.1 · learning rate per update (Adam's update is ~lr whatever
  the gradient's size, so where a gradient is near 0 a tiny difference
  in it moves the update by a fraction of lr; measured: losses 1.3e-7,
  params at most 0.012 · lr per update).
* ``MaskedPLM`` over 6 bf16 steps (Adam keeps its moments in bf16 on
  both sides): the loss trajectories within 2e-3 relative (bf16
  weights and moments round at other points in each update; measured
  at most 1.4e-4).
* checkpointing: bit-equal loss and gradients (the same ops recomputed)
  and the JAX suite's 1e-4 relative on the loss against JAX
  (``tests/test_trainer.py:43``).
"""

import functools

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from esme_tpu import MaskedFastaTokenDataset as JMaskedDataset
from esme_tpu import loss as jloss
from esme_tpu.models import esm as jesm
from esme_tpu.models import modules as jmod
from esme_tpu.models.config import esm2_config as jesm2_config
from esme_tpu.models.init import init_params as jinit
from esme_tpu.train import MaskedPLM as JMaskedPLM

from esme_tpu_torch import ESM2, MaskedFastaTokenDataset, tokenize_unpad
from esme_tpu_torch.alphabet import Alphabet, mask_tokens
from esme_tpu_torch.models import modules as tmod
from esme_tpu_torch.models.config import esm2_config
from esme_tpu_torch.models.io import params_from_jax
from esme_tpu_torch.ops import flash as tflash
from esme_tpu_torch.ops import headsplit
from esme_tpu_torch.train import MaskedPLM
from esme_tpu_torch.train.trainer import train_views

AA = list('LAGVSERTIDPKQNFYMHWC')
SHAPES = {'8m': (6, 320, 20), '650m_w': (2, 1280, 20)}


def _np(x):
    return np.asarray(x.astype(jnp.float32)) if not torch.is_tensor(x) \
        else x.detach().float().numpy()


def _torch(x, dtype):
    return torch.from_numpy(np.array(x.astype(jnp.float32))).to(dtype)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_gelu_linear_grad_matches_jax(dtype):
    rng = np.random.default_rng(0)
    jdt = getattr(jnp, dtype)
    x, k, b, dy = (jnp.asarray(rng.standard_normal(s) * sc, jdt)
                   for s, sc in (((96, 256), 2.0), ((256, 64), 0.06),
                                 ((64,), 0.1), ((96, 64), 1.0)))
    y_ref, vjp = jax.vjp(jmod.gelu_linear, x, k, b)
    ref = vjp(dy)
    tdt = getattr(torch, dtype)
    tx, tk, tb = (_torch(a, tdt).requires_grad_() for a in (x, k, b))
    y = tmod.gelu_linear(tx, tk, tb)
    y.backward(_torch(dy, tdt))
    tol = 1e-5 if dtype == 'float32' else 2.0 ** -6
    for got, r in zip((y, tx.grad, tk.grad, tb.grad), (y_ref, *ref)):
        assert got.dtype == tdt
        r = _np(r)
        assert np.abs(_np(got) - r).max() <= tol * np.abs(r).max()


def test_mlp_block_uses_gelu_linear():
    """The MLP's graph saves no GELU output: its fc2 runs through
    ``gelu_linear`` whenever fc2 is a plain kernel, as in JAX."""
    cfg = esm2_config(1, 32, 2, dtype='float32')
    model = ESM2(config=cfg, device='cpu')
    views = train_views(model.params)
    x = torch.randn(8, 32)
    out = tmod.mlp_block(x, views['layers'][0]['mlp'], cfg)
    assert type(out.grad_fn).__name__ == '_GeluLinearBackward'


def _batch(T_real, budget, seed, alphabet=Alphabet):
    """A packed masked-LM batch in the data plane's layout."""
    rng = np.random.default_rng(seed)
    lens, total = [], 0
    while total < T_real - 22:             # at most T_real tokens
        n = int(rng.integers(20, min(200, T_real - total - 2)))
        lens.append(n)
        total += n + 2
    seqs = [''.join(rng.choice(AA, n)) for n in lens]
    tok, _, cu, ml = tokenize_unpad(seqs, alphabet=alphabet)
    masked, mask = mask_tokens(tok, alphabet=alphabet,
                               rng=np.random.default_rng(seed + 1))
    pad = budget - tok.shape[0]

    class B:
        pass
    b = B()
    b.tokens = np.pad(tok, (0, pad), constant_values=alphabet.padding_idx)
    b.masked_tokens = np.pad(masked, (0, pad),
                             constant_values=alphabet.padding_idx)
    b.mask = np.pad(mask, (0, pad), constant_values=False)
    b.cu_lens, b.max_len = cu, ml
    return b


@functools.lru_cache(maxsize=None)
def _jax_params(shape, dtype):
    L, C, H = SHAPES[shape]
    jcfg = jesm2_config(L, C, H, dtype=dtype)
    jp = jinit(jcfg, jax.random.key(3))
    # lift the tiny init so attention and the head see non-trivial inputs
    rng = np.random.default_rng(4)
    jp = {**jp, 'embed_tokens': jnp.asarray(
        rng.standard_normal(jp['embed_tokens'].shape),
        jp['embed_tokens'].dtype)}
    return jcfg, jp


def _port_model(shape, dtype, **kw):
    L, C, H = SHAPES[shape]
    jcfg, jp = _jax_params(shape, dtype)
    cfg = esm2_config(L, C, H, dtype=dtype)
    return ESM2(config=cfg, params=params_from_jax(
        jax.tree.map(np.asarray, jp), cfg), device='cpu', **kw)


def _jax_grads(shape, dtype, batch, impl):
    jcfg, jp = _jax_params(shape, dtype)
    seg, pos = jesm.packed_meta(jnp.asarray(batch.cu_lens),
                                batch.tokens.shape[0])

    def loss(p):
        logits = jesm.forward_flat(p, jcfg, jnp.asarray(batch.masked_tokens),
                                   seg, pos, attn_impl=impl)
        return jloss.cross_entropy(logits, jnp.asarray(batch.tokens),
                                   jnp.asarray(batch.mask))
    return jax.value_and_grad(loss)(jp)


def _pairs(got, ref, path=()):
    for k, v in ref.items():
        if isinstance(v, dict):
            yield from _pairs(got[k], v, path + (k,))
        else:
            yield '.'.join(path + (k,)), got[k], _np(v)


@pytest.mark.parametrize('impl', ['flash', 'reference'])
def test_model_grads_match_jax_fp32(impl):
    """Every leaf's gradient of the masked-LM loss, ESM2-8M shape."""
    batch = _batch(430, 512, seed=0)
    jval, jgrads = _jax_grads('8m', 'float32', batch, impl)
    plm = MaskedPLM(_port_model('8m', 'float32'), attn_impl=impl)
    loss, grads = plm._grad_step(batch)
    np.testing.assert_allclose(loss.item(), float(jval), rtol=1e-5)
    n = 0
    for name, g, r in _pairs(grads, jgrads):
        assert g.shape == r.shape and g.dtype == torch.float32, name
        err = np.abs(g.numpy() - r).max()
        assert err <= 1e-4 * np.abs(r).max(), (name, err, np.abs(r).max())
        n += 1
    assert n == len(jax.tree.leaves(jgrads))     # every leaf


def test_model_grads_match_jax_bf16():
    """Every leaf's gradient, ESM2-650M width at 2 layers, bf16, the
    port's flash path against the JAX model's einsum path."""
    batch = _batch(430, 512, seed=1)
    jval, jgrads = _jax_grads('650m_w', 'bfloat16', batch, 'reference')
    plm = MaskedPLM(_port_model('650m_w', 'bfloat16'))
    loss, grads = plm._grad_step(batch)
    np.testing.assert_allclose(loss.item(), float(jval), rtol=1e-3)
    for name, g, r in _pairs(grads, jgrads):
        assert g.dtype == torch.bfloat16, name
        a, b = g.float().numpy().ravel(), r.ravel()
        if not np.abs(b).max():
            assert not np.abs(a).max(), name
            continue
        cos = a @ b / np.linalg.norm(a) / np.linalg.norm(b)
        err = np.abs(a - b).max() / np.abs(b).max()
        assert cos >= 0.999 and err <= 2.0 ** -4, (name, cos, err)


@pytest.fixture(scope='module')
def batches(fasta_path):
    kw = dict(token_per_batch=1024, shuffle=False, random_state=0)
    jds = JMaskedDataset(fasta_path, **kw)
    jds._native = None
    tds = MaskedFastaTokenDataset(fasta_path, **kw)
    return [jds[i] for i in range(2)], [tds[i] for i in range(2)]


def _tiny_pair(checkpointing=False):
    cfg = jesm2_config(2, 64, 4, dtype='float32')
    jm = jesm.ESM2(config=cfg, rng=0, checkpointing=checkpointing)
    tcfg = esm2_config(2, 64, 4, dtype='float32')
    tm = ESM2(config=tcfg, params=params_from_jax(
        jax.tree.map(np.asarray, jm.params), tcfg), device='cpu',
        checkpointing=checkpointing)
    return jm, tm


@pytest.mark.parametrize('kw', [{}, {'grad_accum': 2},
                                {'weight_decay': 0.05}],
                         ids=['adam', 'grad_accum', 'adamw'])
def test_masked_plm_matches_jax(batches, kw):
    """Per-step losses and the final params of 3 steps from the same
    weights on the same batches (fp32)."""
    jb, tb = batches
    jm, tm = _tiny_pair()
    lr = 1e-3
    jt = JMaskedPLM(jm, learning_rate=lr, **kw)
    tt = MaskedPLM(tm, learning_rate=lr, **kw)
    for i in range(3):
        lj = jt.training_step(jb[i % 2])
        lt = tt.training_step(tb[i % 2])
        np.testing.assert_allclose(lt, lj, rtol=1e-5)
    updates = 3 // kw.get('grad_accum', 1)
    for name, got, ref in _pairs(tm.params, jt.state.params):
        err = np.abs(got.numpy() - ref).max()
        assert err <= 0.1 * lr * updates, (name, err)
    assert tt.step == 3


def test_masked_plm_bf16_trajectory_matches_jax(batches):
    jb, tb = batches
    jcfg = jesm2_config(2, 64, 4, dtype='bfloat16')
    jm = jesm.ESM2(config=jcfg, rng=0)
    tcfg = esm2_config(2, 64, 4, dtype='bfloat16')
    tm = ESM2(config=tcfg, params=params_from_jax(
        jax.tree.map(np.asarray, jm.params), tcfg), device='cpu')
    jt = JMaskedPLM(jm, learning_rate=1e-3)
    tt = MaskedPLM(tm, learning_rate=1e-3)
    for i in range(6):
        np.testing.assert_allclose(tt.training_step(tb[i % 2]),
                                   jt.training_step(jb[i % 2]), rtol=2e-3)
    assert tm.params['embed_tokens'].dtype == torch.bfloat16


def test_masked_plm_grad_accum_updates_every_kth_step(batches):
    _, tb = batches
    _, tm = _tiny_pair()
    before = tm.params['embed_tokens'].clone()
    tt = MaskedPLM(tm, learning_rate=1e-3, grad_accum=2)
    tt.training_step(tb[0])
    assert torch.equal(tm.params['embed_tokens'], before)
    tt.training_step(tb[0])
    assert not torch.equal(tm.params['embed_tokens'], before)


def test_masked_plm_checkpointing_matches(batches):
    jb, tb = batches
    _, plain = _tiny_pair(False)
    jck, ckpt = _tiny_pair(True)
    l0, g0 = MaskedPLM(plain)._grad_step(tb[0])
    l1, g1 = MaskedPLM(ckpt)._grad_step(tb[0])
    assert torch.equal(l0, l1)
    for name, a, b in _pairs(g1, jax.tree.map(lambda t: t.numpy(), g0)):
        assert np.array_equal(a.numpy(), b), name
    lj = JMaskedPLM(jck, learning_rate=1e-3).training_step(jb[0])
    lt = MaskedPLM(ckpt, learning_rate=1e-3).training_step(tb[0])
    np.testing.assert_allclose(lt, lj, rtol=1e-4)


def test_masked_plm_loss_decreases_and_fit(batches, capsys):
    _, tb = batches
    _, tm = _tiny_pair()
    trainer = MaskedPLM(tm, learning_rate=1e-3)
    first = trainer.training_step(tb[0])
    for _ in range(10):
        last = trainer.training_step(tb[0])
    assert last < first
    # the views are the model's params: inference sees the trained weights
    assert trainer.validation_step(tb[0]) < first
    history = trainer.fit(tb, epochs=1, val_dataset=tb[:1], log_every=1)
    assert len(history) == 2 and all(np.isfinite(history))
    out = capsys.readouterr().out
    assert 'epoch 0 step 1: loss' in out and 'val_loss' in out
    assert trainer.step == 13


def test_cpu_training_launches_no_kernel(batches):
    _, tb = batches
    _, tm = _tiny_pair()
    counters = (tflash.segment_flash_fwd, tflash.segment_flash_bwd,
                headsplit.rotary_qk)
    before = [f.launches for f in counters] + [
        headsplit.rotary_qk.inverse_launches]
    MaskedPLM(tm).training_step(tb[0])
    assert [f.launches for f in counters] + [
        headsplit.rotary_qk.inverse_launches] == before == [0, 0, 0, 0]


@pytest.mark.parametrize('kw,match', [
    ({'lora_only': True}, 'no leaf of the model trains'),
    ({'trainable_mask': {}}, 'mask does not match'),
])
def test_masked_plm_refuses_later_slices(kw, match):
    """The LoRA options came with the fine-tuning slice: ``lora_only=True``
    on a model without adapters leaves nothing to train, and a mask that is
    not a tree of the params' structure is refused (JAX asserts it,
    ``esme_tpu/train/partition.py:26-27``); both raise before any step."""
    _, tm = _tiny_pair()
    with pytest.raises(ValueError, match=match):
        MaskedPLM(tm, **kw)
