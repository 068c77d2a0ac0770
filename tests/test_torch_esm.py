"""The slice as a whole: the port's ``predict_log_prob`` vs the JAX
package's ``forward_flat`` (``attn_impl='flash'``: the token-minor
Pallas path in interpret mode; and ``'reference'``: einsum attention)
and vs the independent torch oracle (``tests/torch_oracle.py``), on the
same weights, real tokens only.

Shapes: ESM2-8M (6 layers, width 320, 20 heads, head dim 16),
ESM2-650M's width cut to 2 layers (1280, 20 heads, head dim 64), and
narrow cases of the other head dims, each cut to 2 layers: ESM2-35M
(480, 20 heads, head dim 24), ESM2-150M's width (640, 20 heads, head dim
32) and head dim 128 at 4 heads (width 512; ESM2-15B's head dim).

Gates on the log-probabilities:
* fp32 — 5e-5 absolute: the same fp32 math in another summation order
  through up to 6 layers (measured: under 4e-6).
* bf16 — each side rounds every layer's activations to bf16 at the
  same ops, but GELU and the fused elementwise chains round differently
  (see ``test_torch_modules.py``), so per-token errors of a few bf16
  ulps of the logits are expected: largest error at most 0.1 and mean
  error at most 0.01 in log-probability, and the per-token centred
  log-probability vectors agree with cosine similarity at least 0.999
  (measured: largest 0.038, mean 0.0072, cosine 0.99988 or more).
"""

import functools

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from esme_tpu.models import esm as jesm
from esme_tpu.models import io as jio
from esme_tpu.models.config import esm2_config as jesm2_config
from esme_tpu.models.init import init_params as jinit

from esme_tpu_torch import ESM, ESM2, tokenize, tokenize_unpad
from esme_tpu_torch.models.config import esm2_config as tesm2_config
from esme_tpu_torch.models.io import params_from_jax

from torch_oracle import forward_oracle

AA = list('LAGVSERTIDPKQNFYMHWC')
SHAPES = {'8m': (6, 320, 20), '650m_w': (2, 1280, 20),
          '35m': (2, 480, 20), '150m_w': (2, 640, 20), 'd128': (2, 512, 4)}
FP32_ATOL = 5e-5


def _seqs(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [''.join(rng.choice(AA, n)) for n in lengths]


SEQS = _seqs([150, 7, 233, 60, 31])          # 486 tokens with cls/eos


@functools.lru_cache(maxsize=None)
def _jax_model(shape, dtype):
    L, C, H = SHAPES[shape]
    jcfg = jesm2_config(L, C, H, dtype=dtype)
    jp = jinit(jcfg, jax.random.key(3))
    # lift the tiny init so attention and the head see non-trivial
    # inputs (random-init logits are otherwise nearly uniform)
    rng = np.random.default_rng(4)
    jp = {**jp, 'embed_tokens': jnp.asarray(
        rng.standard_normal(jp['embed_tokens'].shape), jp[
            'embed_tokens'].dtype)}
    return jcfg, jp


def _models(shape, dtype, tmp_path=None):
    L, C, H = SHAPES[shape]
    jcfg, jp = _jax_model(shape, dtype)
    if tmp_path is None:
        model = ESM2(config=tesm2_config(L, C, H, dtype=dtype),
                     params=params_from_jax(jax.tree.map(np.asarray, jp),
                                            tesm2_config(L, C, H, dtype)),
                     device='cpu')
    else:
        path = str(tmp_path / f'esm2_{shape}.safetensors')
        jio.save_pretrained(path, jp, jcfg, f'esm2_{shape}')
        model = ESM.from_pretrained(path, dtype=dtype, device='cpu')
    return jcfg, jp, model


def _jax_logp(jcfg, jp, seqs, impl):
    tok, _, cu, _ = tokenize_unpad(seqs)
    seg, pos = jesm.packed_meta(jnp.asarray(cu), tok.shape[0])
    out = jesm.forward_flat(jp, jcfg, jnp.asarray(tok), seg, pos,
                            log_prob=True, attn_impl=impl)
    return np.asarray(out, dtype=np.float32)


def _gate(got, ref, dtype):
    if dtype == 'float32':
        np.testing.assert_allclose(got, ref, atol=FP32_ATOL, rtol=0)
        return
    err = np.abs(got - ref)
    assert err.max() <= 0.1 and err.mean() <= 0.01, (err.max(), err.mean())
    a = got - got.mean(-1, keepdims=True)
    b = ref - ref.mean(-1, keepdims=True)
    cos = (a * b).sum(-1) / np.linalg.norm(a, axis=-1) \
        / np.linalg.norm(b, axis=-1)
    assert cos.min() >= 0.999, cos.min()


@pytest.mark.parametrize('shape', list(SHAPES))
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_predict_log_prob_matches_jax(shape, dtype, tmp_path):
    # the 8M model's weights travel through a safetensors file written
    # by the JAX package, the 650M-width model's through params_from_jax
    jcfg, jp, model = _models(shape, dtype,
                              tmp_path if shape == '8m' else None)
    tok, _, cu, ml = tokenize_unpad(SEQS, alphabet=model.alphabet)
    got = model.predict_log_prob(tok, pad_args=(cu, ml))
    assert got.dtype == torch.float32 and got.shape == (tok.shape[0], 33)
    got = got.numpy()
    for impl in ('flash', 'reference'):
        _gate(got, _jax_logp(jcfg, jp, SEQS, impl), dtype)
    # the port's einsum path agrees with its flash path
    ref_t = model.predict_log_prob(tok, pad_args=(cu, ml),
                                   attn_impl='reference').numpy()
    np.testing.assert_allclose(got, ref_t, atol=FP32_ATOL if dtype == 'float32'
                               else 0.1, rtol=0)


def test_matches_torch_oracle():
    """Independent per-sequence fp32 oracle on the reference key
    schema (the fp32 gate of the JAX comparison)."""
    jcfg, jp, model = _models('8m', 'float32')
    flat = {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in jio.params_to_flat(jp, jcfg).items()}
    tok, _, cu, ml = tokenize_unpad(SEQS, alphabet=model.alphabet)
    logits = model.forward(tok, pad_args=(cu, ml)).numpy()
    for i in range(len(SEQS)):
        ref = forward_oracle(flat, jcfg, tok[cu[i]:cu[i + 1]]).numpy()
        np.testing.assert_allclose(logits[cu[i]:cu[i + 1]], ref,
                                   atol=FP32_ATOL, rtol=0)


def test_padded_route_and_pad_output():
    """The padded ``(B, L)`` route equals the packed route with
    ``pad_output``, which equals the JAX model's padded route; pads
    hold ``lm_head(0)``."""
    jcfg, jp, model = _models('8m', 'float32')
    padded = tokenize(SEQS, alphabet=model.alphabet)
    tok, _, cu, ml = tokenize_unpad(SEQS, alphabet=model.alphabet)
    lp_pad = model.predict_log_prob(padded).numpy()
    lp_po = model.predict_log_prob(tok, pad_args=(cu, ml),
                                   pad_output=True).numpy()
    assert lp_pad.shape == (len(SEQS), ml, 33)
    np.testing.assert_allclose(lp_pad, lp_po, atol=FP32_ATOL, rtol=0)
    jm = jesm.ESM2(config=jcfg, params=jp)
    np.testing.assert_allclose(lp_pad, np.asarray(jm.predict_log_prob(
        padded)), atol=FP32_ATOL, rtol=0)
    reps = model.forward_representation(tok, pad_args=(cu, ml),
                                        layers=[0, -1]).numpy()
    jreps = np.asarray(jm.forward_representation(tok, pad_args=(cu, ml),
                                                 layers=[0, -1],
                                                 attn_impl='reference'))
    assert reps.shape == (tok.shape[0], 3 * 320)
    np.testing.assert_allclose(reps, jreps, atol=FP32_ATOL, rtol=0)
    probs = model.predict_prob(tok, pad_args=(cu, ml)).numpy()
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
