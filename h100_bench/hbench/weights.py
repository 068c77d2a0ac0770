"""Seeded weights, made by the benchmark on the device: the param tree the
program takes (layer leaves stacked on axis 0, linear kernels ``(in,
out)``), each leaf one draw from a ``torch.Generator`` on the device in the
type the configuration serves. Kernels are normal with standard deviation
``fan_in^-1/2``, biases ``0.02``, LayerNorm scales ``1 + 0.02·z`` and
biases ``0.02·z``, the embedding ``0.02·z`` with a zero ``<pad>`` row.

The same seed on the same device gives the same weights, so the reference
makes them again after the window rather than keeping a copy."""

from __future__ import annotations

import torch

from reference.model import Arch

from . import seeds


def make_params(arch: Arch, seed: int, device, dtype=torch.bfloat16) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(seeds.torch_seed(seed, 'weights'))
    L, d, F, V = arch.layers, arch.width, arch.ffn, arch.vocab
    bias = arch.family == 'esm2'      # ESMC's linears have none

    def draw(*shape, std, mean=0.0):
        x = torch.randn(shape, dtype=dtype, device=device, generator=gen)
        x.mul_(std)
        return x.add_(mean) if mean else x

    def lin(d_in, d_out, with_bias, *lead):
        p = {'kernel': draw(*lead, d_in, d_out, std=d_in ** -0.5)}
        if with_bias:
            p['bias'] = draw(*lead, d_out, std=0.02)
        return p

    def norm(dim, with_bias, *lead):
        p = {'scale': draw(*lead, dim, std=0.02, mean=1.0)}
        if with_bias:
            p['bias'] = draw(*lead, dim, std=0.02)
        return p

    emb = draw(V, d, std=0.02)
    emb[arch.padding_idx] = 0
    attn = {'norm': norm(d, True, L)}
    attn.update({n: lin(d, d, bias, L) for n in ('q', 'k', 'v', 'out')})
    if arch.qk_layernorm:
        attn['ln_q'] = norm(d, bias, L)
        attn['ln_k'] = norm(d, bias, L)
    mlp = {'norm': norm(d, True, L)}
    if arch.swiglu:
        mlp.update(gate=lin(d, F, False, L), up=lin(d, F, False, L),
                   down=lin(F, d, False, L))
    else:
        mlp.update(fc1=lin(d, F, True, L), fc2=lin(F, d, True, L))
    return {
        'embed_tokens': emb,
        'layers': {'attn': attn, 'mlp': mlp},
        'emb_norm_after': norm(d, bias),
        'lm_head': {'dense': lin(d, d, True), 'norm': norm(d, True),
                    'final': lin(d, V, True)},
    }


def param_count(tree: dict) -> int:
    return sum(param_count(v) if isinstance(v, dict) else v.numel()
               for v in tree.values())
