"""Port's layers vs the JAX package's: LayerNorm, linear, GELU,
``mlp_block``, ``attention_block`` and ``roberta_lm_head`` (tied and
untied), on weights carried across with ``params_from_jax``.

Gates: fp32 — 1e-5 absolute and relative (the same fp32 arithmetic,
summed in another order). bf16 — both sides round to bf16 at the same
ops, but XLA's CPU backend and PyTorch fuse elementwise chains
differently (GELU most of all, ROADMAP Queue 3, item 2: XLA rounds each
op of the tanh chain to bf16, PyTorch rounds the fp32 chain once, up to
0.003 apart), and a one-ulp difference inside a layer grows to a few
ulps of the layer's scale at its output, where single elements may
cancel to near 0. So the bf16 gate is on the layer's scale: the largest
error at most 8 bf16 ulps of the largest output (2**-5 * max|ref|) and
the mean error at most one ulp of the mean output (2**-8 * mean|ref|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esme_tpu import quant as jquant
from esme_tpu.models import modules as jmod
from esme_tpu.models.config import esm2_config as jesm2_config
from esme_tpu.models.config import esmc_config as jesmc_config
from esme_tpu.models.init import init_params as jinit
from esme_tpu.ops import linear as jlin
from esme_tpu.ops import norm as jnorm

from esme_tpu_torch.models import modules as tmod
from esme_tpu_torch.models.config import esm2_config as tesm2_config
from esme_tpu_torch.models.config import esmc_config as tesmc_config
from esme_tpu_torch.models.io import params_from_jax
from esme_tpu_torch.ops import flash as tflash
from esme_tpu_torch.ops import linear as tlin
from esme_tpu_torch.ops import norm as tnorm
from esme_tpu_torch.ops import rotary as trot

DTYPES = ['float32', 'bfloat16']


def _close(got, ref, dtype):
    got = got.float().numpy()
    ref = np.asarray(ref, dtype=np.float32)
    if dtype == 'float32':
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    else:
        err = np.abs(got - ref)
        assert err.max() <= 2 ** -5 * np.abs(ref).max(), err.max()
        assert err.mean() <= 2 ** -8 * np.abs(ref).mean(), err.mean()


def _model(dtype, C=64, H=4, L=2, seed=0):
    jcfg = jesm2_config(num_layers=L, embed_dim=C, attention_heads=H,
                        dtype=dtype)
    tcfg = tesm2_config(num_layers=L, embed_dim=C, attention_heads=H,
                        dtype=dtype)
    jp = jinit(jcfg, jax.random.key(seed))
    # non-trivial norms and biases so every leaf is exercised
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(lambda a: (a + jnp.asarray(
        rng.standard_normal(a.shape) * 0.1, a.dtype)), jp)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    return jcfg, tcfg, jp, tp


def _x(T, C, dtype, seed=1):
    x = np.random.default_rng(seed).standard_normal((T, C)).astype(
        np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


@pytest.mark.parametrize('dtype', DTYPES)
def test_layer_norm_linear_gelu(dtype):
    _, _, jp, tp = _model(dtype)
    jx, tx = _x(200, 64, dtype)
    _close(tnorm.apply_norm(tx, tmod.layer_params(tp['layers'], 0)['attn']
                            ['norm']),
           jnorm.apply_norm(jx, _layer(jp['layers'], 0)['attn']['norm']),
           dtype)
    _close(tlin.linear(tx, tmod.layer_params(tp['layers'], 1)['mlp']['fc1']),
           jlin.linear(jx, _layer(jp['layers'], 1)['mlp']['fc1']), dtype)
    _close(tmod.gelu(tx * 3), jmod.gelu(jx * 3), dtype)


@pytest.mark.parametrize('dtype', DTYPES)
def test_mlp_block(dtype):
    jcfg, tcfg, jp, tp = _model(dtype)
    jx, tx = _x(200, 64, dtype)
    _close(tmod.mlp_block(tx, tmod.layer_params(tp['layers'], 0)['mlp'],
                          tcfg),
           jmod.mlp_block(jx, _layer(jp['layers'], 0)['mlp'], jcfg), dtype)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('impl', ['flash', 'reference'])
def test_attention_block(dtype, impl):
    """The port's block (RoPE + flash plain versions, or the einsum
    path) vs the JAX block on its einsum path, over a packed batch."""
    jcfg, tcfg, jp, tp = _model(dtype)
    T = 512
    lens = [100, 37, 200, 175]
    seg = np.repeat(np.arange(4, dtype=np.int32), lens)
    pos = np.concatenate([np.arange(n) for n in lens]).astype(np.int32)
    jx, tx = _x(T, 64, dtype, seed=2)
    ref = jmod.attention_block(jx, _layer(jp['layers'], 1)['attn'], jcfg,
                               jnp.asarray(seg), jnp.asarray(pos),
                               attn_impl='reference')
    tseg, tpos = torch.from_numpy(seg), torch.from_numpy(pos)
    rope = trot.rotary_cos_sin(tpos, tcfg.head_dim, dtype=tx.dtype)
    spans = tflash.flash_spans(tseg)
    got = tmod.attention_block(tx, tmod.layer_params(tp['layers'], 1)
                               ['attn'], tcfg, tseg, tpos, attn_impl=impl,
                               rope=rope, spans=spans)
    _close(got, ref, dtype)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('tied', [False, True])
def test_roberta_lm_head(dtype, tied):
    _, _, jp, tp = _model(dtype)
    jh, th = jp['lm_head'], tp['lm_head']
    if tied:
        jh = {**jh, 'final': {'bias': jh['final']['bias']}}
        th = {**th, 'final': {'bias': th['final']['bias']}}
    jx, tx = _x(100, 64, dtype, seed=3)
    _close(tmod.roberta_lm_head(tx, th, embed=tp['embed_tokens']),
           jmod.roberta_lm_head(jx, jh, embed=jp['embed_tokens']), dtype)


def test_embed_tokens_zeroes_mask():
    jcfg, tcfg, jp, tp = _model('float32')
    tok = np.array([0, 5, 32, 7, 1, 32, 2], np.int32)
    got = tmod.embed_tokens(torch.from_numpy(tok), tp, tcfg)
    ref = jmod.embed_tokens(jnp.asarray(tok), jp, jcfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert not got[2].any() and not got[5].any()


def test_unported_family_raises():
    """Once a stub for every family but ESM2; now ESMC's SwiGLU MLP runs
    and matches JAX's ``mlp_block`` (fp32). A quantized gate, which once
    raised here, leaves the fused SwiGLU route for ``linear``, as in JAX,
    and matches JAX's block over the same NF4 leaves (fp32)."""
    jcfg = jesmc_config(num_layers=2, embed_dim=64, attention_heads=4,
                        dtype='float32')
    tcfg = tesmc_config(num_layers=2, embed_dim=64, attention_heads=4,
                        dtype='float32')
    jp = jinit(jcfg, jax.random.key(0))
    rng = np.random.default_rng(0)
    jp = jax.tree.map(lambda a: (a + jnp.asarray(
        rng.standard_normal(a.shape) * 0.1, a.dtype)), jp)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    jx, tx = _x(200, 64, 'float32')
    mlp = tmod.layer_params(tp['layers'], 1)['mlp']
    _close(tmod.mlp_block(tx, mlp, tcfg),
           jmod.mlp_block(jx, _layer(jp['layers'], 1)['mlp'], jcfg),
           'float32')
    jmlp = _layer(jp['layers'], 1)['mlp']
    jq_mlp = {**jmlp, 'gate': jquant.quantize_params(jmlp['gate'], '4bit')}
    tq_mlp = {**mlp, 'gate': {k: params_from_jax({'x': np.asarray(v)},
                                                 None)['x']
                              for k, v in jq_mlp['gate'].items()}}
    assert not tmod._plain_swiglu_params(tq_mlp)
    _close(tmod.mlp_block(tx, tq_mlp, tcfg),
           jmod.mlp_block(jx, jq_mlp, jcfg), 'float32')
