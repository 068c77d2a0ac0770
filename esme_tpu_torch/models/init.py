"""Seeded random parameter init for every ESM family.

Counterpart of ``esme_tpu/models/init.py``: for each family the same
param tree, key for key and shape for shape (per-layer tensors stacked
on axis 0, linear kernels stored ``(in, out)``; the learned position
table, the embedding LayerNorm, q/k LayerNorms and SwiGLU's gate, up and
down where the family has them), truncated-normal kernels scaled by
fan-in, ones/zeros norms, a zero padding row in the embedding and the
position table. Random numbers come from a
``torch.Generator`` on the target device, so the same seed gives other
numbers than the JAX package's random keys (tests carry JAX weights
across with :func:`esme_tpu_torch.models.io.params_from_jax` instead).
"""

from __future__ import annotations

import torch

from .config import ESMConfig


def host_generator(rng) -> torch.Generator:
    """``rng`` if it is a ``torch.Generator``, else a CPU generator seeded
    by it (the LoRA and head inits draw on the host, then move, so a seed
    gives the same values on every device)."""
    if isinstance(rng, torch.Generator):
        return rng
    return torch.Generator().manual_seed(int(rng))


def init_params(cfg: ESMConfig, seed: int = 0, device='cpu') -> dict:
    """Create a randomly initialised param tree for ``cfg`` on
    ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dt = cfg.torch_dtype
    D, F, L, V = cfg.embed_dim, cfg.ffn_dim, cfg.num_layers, cfg.vocab_size

    def dense(*shape):
        # scaled in place: one fp32 copy of a stacked kernel at a time
        # (ESM2-15B's fc1 stack is 20 GB in fp32)
        fan_in = shape[-2]
        w = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return w.mul_(fan_in ** -0.5).to(dt)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    def norm(dim, bias=True, stacked=None):
        shape = (dim,) if stacked is None else (stacked, dim)
        p = {'scale': torch.ones(shape, dtype=dt, device=device)}
        if bias:
            p['bias'] = zeros(*shape)
        return p

    def lin(d_in, d_out, bias, stacked=None):
        lead = () if stacked is None else (stacked,)
        p = {'kernel': dense(*lead, d_in, d_out)}
        if bias:
            p['bias'] = zeros(*lead, d_out)
        return p

    emb = torch.randn((V, D), dtype=torch.float32, device=device,
                      generator=gen) * 0.02
    emb[cfg.padding_idx] = 0        # like nn.Embedding(padding_idx=...)
    params = {'embed_tokens': emb.to(dt)}
    if cfg.learned_positions is not None:
        # +2 rows like the reference table (reference: esme/embedding.py:31)
        pos = torch.randn((cfg.learned_positions + 2, D),
                          dtype=torch.float32, device=device,
                          generator=gen) * 0.02
        pos[cfg.padding_idx] = 0
        params['embed_positions'] = pos.to(dt)
    if cfg.emb_layer_norm_before:
        params['emb_norm_before'] = norm(D)
    attn = {
        'norm': norm(D, bias=cfg.norm_bias, stacked=L),
        'q': lin(D, D, cfg.bias, stacked=L),
        'k': lin(D, D, cfg.bias, stacked=L),
        'v': lin(D, D, cfg.bias, stacked=L),
        'out': lin(D, D, cfg.bias, stacked=L),
    }
    if cfg.qk_layernorm:
        attn['ln_q'] = norm(D, bias=cfg.bias, stacked=L)
        attn['ln_k'] = norm(D, bias=cfg.bias, stacked=L)
    mlp = {'norm': norm(D, bias=cfg.norm_bias, stacked=L)}
    if cfg.mlp == 'swiglu':
        mlp.update(gate=lin(D, F, cfg.bias, stacked=L),
                   up=lin(D, F, cfg.bias, stacked=L),
                   down=lin(F, D, cfg.bias, stacked=L))
    else:
        mlp.update(fc1=lin(D, F, cfg.bias, stacked=L),
                   fc2=lin(F, D, cfg.bias, stacked=L))
    params['layers'] = {'attn': attn, 'mlp': mlp}
    params['emb_norm_after'] = norm(D, bias=cfg.final_ln_bias)
    params['lm_head'] = {
        'dense': lin(D, D, True),
        'norm': norm(D),
        'final': lin(D, V, True),
    }
    return params
