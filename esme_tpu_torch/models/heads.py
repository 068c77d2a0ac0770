"""Prediction heads over pooled segment representations.

Counterpart of ``esme_tpu/models/heads.py:17-92`` (reference:
esme/head.py:30-68 ``ClsHead``, esme/pooling.py:139-228
``LearnedAttentionPool`` / ``LearnedAggregation``): param dicts and apply
functions. Linear kernels are stored ``(in, out)``, as the model's.

The inits draw from a ``torch.Generator`` (an int seeds one), on the CPU
and then move to ``device``, so a seed gives the same head on every
device. They cannot equal JAX's random draws: a head trained or made
by the JAX package comes over with
:func:`esme_tpu_torch.models.io.params_from_jax`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.linear import linear
from ..ops.pooling import attention_pool, partition_mean_pool
from .esm import resolve_device
from .init import host_generator


def _linear_init(gen, d_in, d_out, dtype, device, bias=True):
    """Kernel ``(d_in, d_out)`` from a normal truncated at ±2, times
    ``d_in^-1/2``, drawn in fp32; zero bias."""
    w = torch.empty(d_in, d_out)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    p = {'kernel': (w * d_in ** -0.5).to(device=device, dtype=dtype)}
    if bias:
        p['bias'] = torch.zeros(d_out, dtype=dtype, device=device)
    return p


def _dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype)


def init_cls_head(rng, embed_dim, num_cls=1, hidden_dim=4096,
                  dtype=torch.bfloat16, device='cuda'):
    """(reference: esme/head.py:57-65)"""
    gen, dtype = host_generator(rng), _dtype(dtype)
    device = resolve_device(device)
    return {'fc1': _linear_init(gen, embed_dim, hidden_dim, dtype, device),
            'fc2': _linear_init(gen, hidden_dim, num_cls, dtype, device)}


def apply_cls_head(params, x, seg_ids, num_segments):
    """Mean-pool, then a 2-layer ReLU MLP -> ``(S, num_cls)``, squeezed
    when ``num_cls`` is 1 (reference: esme/head.py:67-68)."""
    pooled = partition_mean_pool(x, seg_ids, num_segments)
    out = linear(F.relu(linear(pooled, params['fc1'])), params['fc2'])
    return out.squeeze(-1) if out.shape[-1] == 1 else out


def init_learned_aggregation(rng, embed_dim, num_cls=1, attention_heads=4,
                             dtype=torch.bfloat16, device='cuda'):
    """Learned cls queries (ones, as the reference inits them,
    esme/pooling.py:164), a key projection and a 2-layer ReLU head to one
    output per cls (reference: esme/pooling.py:139-218).
    ``attention_heads`` is the apply functions' argument, kept here for
    the JAX signature."""
    gen, dtype = host_generator(rng), _dtype(dtype)
    device = resolve_device(device)
    return {
        'cls': torch.ones(num_cls, embed_dim, dtype=dtype, device=device),
        'k': _linear_init(gen, embed_dim, embed_dim, dtype, device),
        'linear': _linear_init(gen, embed_dim, embed_dim, dtype, device),
        'final': _linear_init(gen, embed_dim, 1, dtype, device),
    }


def apply_learned_attention_pool(params, x, seg_ids, num_segments,
                                 attention_heads):
    """``(S, C, D)`` pooled embeddings (reference:
    esme/pooling.py:166-179)."""
    return attention_pool(params['cls'], x, params['k'], seg_ids,
                          num_segments, attention_heads)


def apply_learned_aggregation(params, x, seg_ids, num_segments,
                              attention_heads):
    """``(S, C)`` scores, ``(S,)`` for one cls (reference:
    esme/pooling.py:215-228)."""
    pooled = apply_learned_attention_pool(params, x, seg_ids, num_segments,
                                          attention_heads)
    h = F.relu(linear(pooled, params['linear']))
    out = linear(h, params['final'])[..., 0]
    return out[..., 0] if out.shape[-1] == 1 else out


def init_feed_forward(rng, embed_dim, hidden_dim, out_dim=None,
                      dtype=torch.bfloat16, device='cuda'):
    """Plain ReLU MLP (reference: esme/layer.py:1-23)."""
    gen, dtype = host_generator(rng), _dtype(dtype)
    device = resolve_device(device)
    out_dim = out_dim or embed_dim
    return {'fc1': _linear_init(gen, embed_dim, hidden_dim, dtype, device),
            'fc2': _linear_init(gen, hidden_dim, out_dim, dtype, device)}


def apply_feed_forward(params, x):
    """(reference: esme/layer.py:14-23)"""
    return linear(F.relu(linear(x, params['fc1'])), params['fc2'])
