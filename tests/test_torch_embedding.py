"""The token embedding's fixed-order gradient
(``esme_tpu_torch/models/modules.py:embed_tokens``, ``embedding_grad``)
against JAX's (``jax.vjp`` of ``esme_tpu/models/modules.py:embed_tokens``)
at ESM2's vocabulary (33, ``<mask>`` rows zeroed) and ESMC's (64), on
3,000 seeded tokens of width 64.

Gates:
* fp32: within 1e-6·max|g| of JAX's (both sum ~100 fp32 terms per entry,
  in other orders; measured 2.4e-7·max|g|).
* bf16: JAX's XLA:CPU scatter adds in bf16 (measured up to 1.5% of
  max|g| from the exact sum); the port sums with fp32 accumulation and
  rounds once. So each entry of the port's is within one bf16 rounding
  (2^-8 relative) of the exact fp64 sum, and no further from JAX's than
  JAX's own error plus that rounding.
* bit-equal from call to call, in both dtypes; the forward bit-equal to
  JAX's (a gather).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esme_tpu.models import modules as jmod
from esme_tpu.models.config import esm2_config as jesm2_config
from esme_tpu.models.config import esmc_config as jesmc_config

from esme_tpu_torch.models import modules as tmod
from esme_tpu_torch.models.config import esm2_config, esmc_config

T, WIDTH = 3000, 64


def _case(family, dtype, seed=0):
    jcfg = (jesm2_config if family == 'esm2' else jesmc_config)(
        1, WIDTH, 4, dtype=dtype)
    tcfg = (esm2_config if family == 'esm2' else esmc_config)(
        1, WIDTH, 4, dtype=dtype)
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, tcfg.vocab_size, T).astype(np.int32)
    w = jnp.asarray(rng.standard_normal((tcfg.vocab_size, WIDTH))
                    .astype(np.float32)).astype(dtype)
    dy = jnp.asarray(rng.standard_normal((T, WIDTH)).astype(np.float32)) \
        .astype(dtype)
    return jcfg, tcfg, tok, w, dy


def _torch(a):
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, str(a.dtype)))


def _port(tcfg, tok, w, dy):
    tw = _torch(w).requires_grad_()
    x = tmod.embed_tokens(torch.from_numpy(np.array(tok)),
                          {'embed_tokens': tw}, tcfg)
    g, = torch.autograd.grad(x, tw, _torch(dy))
    return x.detach(), g


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('family', ['esm2', 'esmc'])
def test_embedding_grad_matches_jax(family, dtype):
    jcfg, tcfg, tok, w, dy = _case(family, dtype)
    jx, vjp = jax.vjp(lambda W: jmod.embed_tokens(
        jnp.asarray(tok), {'embed_tokens': W}, jcfg), w)
    jg = np.asarray(vjp(dy)[0].astype(jnp.float32), np.float64)
    x, g = _port(tcfg, tok, w, dy)
    assert g.dtype == getattr(torch, dtype)
    assert torch.equal(x.float(), torch.from_numpy(
        np.array(jx.astype(jnp.float32))))
    g = g.double().numpy()
    keep = tok != tcfg.mask_idx if tcfg.zero_mask_embedding else \
        np.ones(T, bool)
    exact = np.zeros_like(g)
    np.add.at(exact, tok[keep],
              np.asarray(dy.astype(jnp.float32), np.float64)[keep])
    if tcfg.zero_mask_embedding:
        assert not g[tcfg.mask_idx].any()
    if dtype == 'float32':
        assert np.abs(g - jg).max() <= 1e-6 * np.abs(jg).max()
    else:
        assert (np.abs(g - exact) <= 2.0 ** -8 * np.abs(exact)).all()
        assert (np.abs(g - jg) <= np.abs(jg - exact)
                + 2.0 ** -8 * np.abs(exact)).all()


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_embedding_grad_is_reproducible(dtype):
    _, tcfg, tok, w, dy = _case('esmc', dtype, seed=1)
    _, first = _port(tcfg, tok, w, dy)
    for _ in range(3):
        assert torch.equal(_port(tcfg, tok, w, dy)[1], first)
    ids = torch.from_numpy(np.array(tok)).long()
    assert torch.equal(tmod.embedding_grad(ids, _torch(dy), 64), first)

