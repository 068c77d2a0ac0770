"""Transformer layer, embedding and head apply functions.

Counterpart of ``esme_tpu/models/modules.py`` (every family: ESM2,
ESM1b, ESM1v and ESMC; forward and gradient): plain functions over a
params dict of tensors, with
per-layer tensors stacked on axis 0 and linear kernels stored
``(in, out)``. The layer stack is a Python loop, optionally
checkpointed per layer. There is one layer path: on the card
``(T, H, D)`` is already the natural layout, so the JAX package's
token-minor twins have no counterpart.

For training, the layer stack also takes a list of per-layer param
dicts (see :func:`layer_params`): each layer's leaves are then their
own gradient targets, where indexing a stacked leaf would make
autograd build a zero tensor the size of the whole stack for each
layer's gradient.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention_rect, attention_reference
from ..ops.flash import AttnStash, flash_spans, segment_flash, \
    segment_flash_rect
from ..ops.fused_attn import fused_rotary_flash
from ..ops import headsplit
from ..ops.linear import fold_in, linear, matmul
from ..ops.norm import apply_norm
from ..ops.rotary import apply_rotary, rotary_cos_sin
from ..profiling import span


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU as the JAX package computes it: the tanh form in bf16 and
    the exact erf form in fp32 (``esme_tpu/models/modules.py:31-74``)."""
    if x.dtype == torch.bfloat16:
        return F.gelu(x, approximate='tanh')
    return F.gelu(x, approximate='none')


class _GeluLinear(torch.autograd.Function):
    """``gelu(x) @ kernel (+ bias)`` saving only x and the kernel
    (``esme_tpu/models/modules.py:88-116``): the backward recomputes
    gelu(x) instead of keeping a second ``(T, 4C)`` tensor per layer."""

    @staticmethod
    def forward(ctx, x, kernel, bias):
        ctx.save_for_backward(x, kernel)
        ctx.has_bias = bias is not None
        y = matmul(gelu(x), kernel)
        return y + bias if bias is not None else y

    @staticmethod
    def backward(ctx, dy):
        x, kernel = ctx.saved_tensors
        dy = dy.to(x.dtype)
        dh = torch.matmul(dy, kernel.T.to(x.dtype))  # fp32 sums, rounded
        # dh * gelu'(x) for the form gelu() uses (tanh in bf16, erf in
        # fp32; esme_tpu/models/modules.py:77-85), in fp32, rounded once
        dx = torch.ops.aten.gelu_backward(
            dh, x, approximate='tanh' if x.dtype == torch.bfloat16
            else 'none')
        dkernel = torch.matmul(gelu(x).T, dy).to(kernel.dtype) \
            if ctx.needs_input_grad[1] else None
        dbias = dy.sum(0) if ctx.has_bias and ctx.needs_input_grad[2] \
            else None
        return dx, dkernel, dbias


def gelu_linear(x, kernel, bias=None):
    """``gelu(x) @ kernel + bias`` with the memory-lean gradient."""
    return _GeluLinear.apply(x, kernel, bias)


def attention_block(x, params, cfg, seg_ids, pos_ids,
                    attn_impl: str = 'auto',
                    rope: Optional[tuple] = None, spans=None,
                    kv_gather=None, stash=None, lora_names=None,
                    lora_dropout: float = 0.0, dropout_key=None):
    """Multi-head self-attention over the packed layout
    (reference: esme/attention.py:91-139). ``x``: ``(T, C)``.

    With ``cfg.qk_layernorm`` (ESMC) q and k are layer-normed over the
    full width before the head split and RoPE
    (``esme_tpu/models/modules.py:141-143``).

    ``attn_impl``: 'flash' (or 'auto') runs the segment-flash kernel H1
    (H2 in the backward) on a CUDA tensor, their plain versions on a CPU
    tensor; with ``cfg.rotary`` (ESM2, ESMC) RoPE kernel H3 rotates q
    and k first (:func:`fused_rotary_flash`), without it (ESM1b, ESM1v)
    H1 takes the projections as they are (:func:`segment_flash`; JAX
    rotates by identity tables there, which is exact, so the port skips
    the rotation and launches no H3). 'reference' runs the einsum oracle,
    with RoPE only when ``cfg.rotary``.

    ``kv_gather`` (context parallelism, ``esme_tpu/models/modules.py:
    148-173``): ``x`` holds this rank's tokens, and
    ``kv_gather(k, v, seg_ids) -> (k_full, v_full, seg_full)`` gathers the
    keys, values (``(T, H, D)``) and ids of every rank
    (:func:`esme_tpu_torch.parallel.make_kv_gather`). q and k are rotated
    locally before the gather (H3 on the 'flash' route, with H3's inverse
    in the backward, the plain rotation on 'reference', as JAX rotates
    before it), then the local queries
    attend the gathered stream: kernel H9, H10 in the backward
    (:func:`segment_flash_rect`, 'flash' or 'auto') or
    :func:`attention_rect` ('reference'). ``spans`` is then H9's and H10's
    spans over the local and the gathered ids
    (:func:`~esme_tpu_torch.ops.flash.rect_flash_spans`), or None to
    compute them here.

    ``stash``: the checkpointed layer's
    :class:`~esme_tpu_torch.ops.flash.AttnStash` under ``remat='attn'``
    (the flash routes keep o and lse in it, and the recompute launches no
    H1 or H9), or None.

    ``lora_names``, ``lora_dropout``, ``dropout_key``: the LoRA adapters of
    q, k, v and out (:func:`~esme_tpu_torch.ops.linear.linear`), the
    dropout key folded with the projection's index (0-3), as JAX folds it
    (``esme_tpu/models/modules.py:120-134``). Adapters on q, k and v act
    before RoPE and the attention kernels, the one on out after them.
    """
    h = apply_norm(x, params['norm'])
    keys = [None] * 4
    if dropout_key is not None and lora_dropout > 0.0:
        keys = [fold_in(dropout_key, i) for i in range(4)]
    q = linear(h, params['q'], lora_names, lora_dropout, keys[0])
    k = linear(h, params['k'], lora_names, lora_dropout, keys[1])
    v = linear(h, params['v'], lora_names, lora_dropout, keys[2])
    if cfg.qk_layernorm:
        q = apply_norm(q, params['ln_q'])
        k = apply_norm(k, params['ln_k'])
    T = x.shape[0]
    H, Dh = cfg.attention_heads, cfg.head_dim
    if cfg.rotary and rope is None:
        rope = rotary_cos_sin(pos_ids, Dh, dtype=x.dtype)

    if kv_gather is not None:
        o = _attention_cp(q, k, v, cfg, seg_ids, attn_impl, rope, spans,
                          kv_gather, stash)
    elif attn_impl in ('auto', 'flash'):
        if cfg.rotary:
            o = fused_rotary_flash(q, k, v, *rope, seg_ids, H, spans=spans,
                                   stash=stash)
        else:
            o = segment_flash(q, k, v, seg_ids, H,
                              flash_spans(seg_ids) if spans is None
                              else spans, stash)
    elif attn_impl == 'reference':
        qh, kh = q.reshape(T, H, Dh), k.reshape(T, H, Dh)
        if cfg.rotary:
            qh, kh = apply_rotary(qh, *rope), apply_rotary(kh, *rope)
        o = attention_reference(qh, kh, v.reshape(T, H, Dh), seg_ids)
        o = o.reshape(T, H * Dh)
    else:
        raise ValueError(f'unknown attention impl: {attn_impl}')
    return linear(o, params['out'], lora_names, lora_dropout, keys[3])


def _attention_cp(q, k, v, cfg, seg_ids, attn_impl, rope, spans, kv_gather,
                  stash=None):
    """The context-parallel branch of :func:`attention_block`: ``(T, H·D)``
    q, k, v of this rank's tokens -> ``(T, H·D)`` attention output over
    every rank's keys."""
    T = q.shape[0]
    H, Dh = cfg.attention_heads, cfg.head_dim
    if attn_impl not in ('auto', 'flash', 'reference'):
        raise ValueError(f'unknown attention impl: {attn_impl}')
    flash = attn_impl != 'reference'
    if cfg.rotary:
        if flash:
            q, k = headsplit.rotate_qk(q, k, *rope, H)
        else:
            q, k = (apply_rotary(x.reshape(T, H, Dh), *rope)
                    .reshape(T, H * Dh) for x in (q, k))
    k_full, v_full, seg_k = kv_gather(k.reshape(T, H, Dh),
                                      v.reshape(T, H, Dh), seg_ids)
    Tk = k_full.shape[0]
    if flash:
        seg_k = seg_k.to(torch.int32).contiguous()
        return segment_flash_rect(
            q.contiguous(), k_full.reshape(Tk, H * Dh),
            v_full.reshape(Tk, H * Dh), seg_ids, seg_k, H, spans, stash)
    o = attention_rect(q.reshape(T, H, Dh), k_full, v_full, seg_ids, seg_k)
    return o.reshape(T, H * Dh)


class _SwigluLinear(torch.autograd.Function):
    """``(silu(h @ gk) * (h @ uk)) @ dk`` saving only h and the three
    kernels (``esme_tpu/models/modules.py:235-280``): the backward
    recomputes gate and up (two matmuls and one SiLU) instead of keeping
    three ``(T, F)`` tensors per layer. Bias-free, as ESMC's MLP is.
    SiLU and its derivative each round once to the activation dtype,
    where XLA rounds each op of its expansion (the bf16 gate of
    ``tests/test_torch_families.py`` holds the difference)."""

    @staticmethod
    def forward(ctx, h, gk, uk, dk):
        ctx.save_for_backward(h, gk, uk, dk)
        return matmul(F.silu(matmul(h, gk)) * matmul(h, uk), dk)

    @staticmethod
    def backward(ctx, dy):
        h, gk, uk, dk = ctx.saved_tensors
        dt = h.dtype
        h2 = h.reshape(-1, h.shape[-1])
        dy = dy.to(dt).reshape(-1, dy.shape[-1])
        g, u = matmul(h2, gk), matmul(h2, uk)
        sg = F.silu(g)
        dsu = matmul(dy, dk.T)
        dg = torch.ops.aten.silu_backward(dsu * u, g)
        du = dsu * sg
        dh = matmul(dg, gk.T) + matmul(du, uk.T)
        need = ctx.needs_input_grad
        dgk = torch.matmul(h2.T, dg).to(gk.dtype) if need[1] else None
        duk = torch.matmul(h2.T, du).to(uk.dtype) if need[2] else None
        ddk = torch.matmul((sg * u).T, dy).to(dk.dtype) if need[3] else None
        return dh.reshape(h.shape), dgk, duk, ddk


def swiglu_linear(h, gk, uk, dk):
    """``(silu(h @ gk) * (h @ uk)) @ dk`` with the memory-lean
    gradient."""
    return _SwigluLinear.apply(h, gk, uk, dk)


def _plain_swiglu_params(params) -> bool:
    """True when gate, up and down are bias-free dense kernels without
    LoRA adapters: the contract of :func:`swiglu_linear`
    (``esme_tpu/models/modules.py:283-288``)."""
    return all('kernel' in params[k] and not params[k].get('lora')
               and 'bias' not in params[k] for k in ('gate', 'up', 'down'))


def mlp_block(x, params, cfg):
    """Position-wise MLP: LN -> fc1 -> GELU -> fc2 (ESM2, ESM1b, ESM1v,
    reference: esme/attention.py:228-236) or LN -> SwiGLU -> down (ESMC,
    reference: esme/attention.py:217-227,258-281). A LoRA adapter on fc2
    (or gate, up, down) leaves the memory-lean routes, as in JAX
    (``esme_tpu/models/modules.py:291-309``)."""
    h = apply_norm(x, params['norm'])
    if cfg.mlp == 'swiglu':
        if _plain_swiglu_params(params):
            return swiglu_linear(h, params['gate']['kernel'],
                                 params['up']['kernel'],
                                 params['down']['kernel'])
        return linear(F.silu(linear(h, params['gate']))
                      * linear(h, params['up']), params['down'])
    h = linear(h, params['fc1'])
    fc2 = params['fc2']
    if 'kernel' in fc2 and not fc2.get('lora'):
        return gelu_linear(h, fc2['kernel'], fc2.get('bias'))
    return linear(gelu(h), fc2)


def transformer_layer(x, params, cfg, seg_ids, pos_ids,
                      attn_impl: str = 'auto',
                      rope: Optional[tuple] = None, spans=None,
                      kv_gather=None, stash=None, lora_names=None,
                      lora_dropout: float = 0.0, dropout_key=None):
    """Pre-norm residual block with residue scaling
    (reference: esme/attention.py:241-255). The branch is multiplied by
    ``1 / residue_scaling`` rounded to the activation dtype first, as JAX
    rounds a Python scalar to a bf16 operand's dtype (ESMC-300M's
    1/sqrt(30/36) is 1.09375 in bf16). ESM2's scaling is 1, and the
    multiply by 1.0 (an exact no-op) is skipped."""
    inv_scale = torch.tensor(1.0 / cfg.residue_scaling,
                             dtype=x.dtype).item()

    def scaled(y):
        return y if inv_scale == 1.0 else y * inv_scale

    x = x + scaled(attention_block(x, params['attn'], cfg, seg_ids, pos_ids,
                                   attn_impl, rope, spans, kv_gather, stash,
                                   lora_names, lora_dropout, dropout_key))
    return x + scaled(mlp_block(x, params['mlp'], cfg))


def layer_params(stacked: dict, i: int) -> dict:
    """Layer ``i``'s params: index axis 0 of every stacked leaf (views)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def num_layers(stacked: dict) -> int:
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[0]


def check_remat(remat: str) -> None:
    """``remat`` is 'full' (recompute the whole layer) or 'attn' (keep
    the attention output and its lse, recompute the rest)."""
    if remat not in ('full', 'attn'):
        raise ValueError(f'unknown remat policy: {remat}')


def _gathered_layer(x, params, cfg, seg_ids, pos_ids, attn_impl, rope, spans,
                    kv_gather, layer_gather, lora, stash=None):
    """:func:`transformer_layer` on the layer's params gathered by
    ``layer_gather`` (FSDP shards), or on ``params`` as they are;
    ``lora``: ``(lora_names, lora_dropout, dropout_key)``."""
    if layer_gather is not None:
        params = layer_gather(params)
    return transformer_layer(x, params, cfg, seg_ids, pos_ids, attn_impl,
                             rope, spans, kv_gather, stash, *lora)


def layer_stack(x, stacked_params, cfg, seg_ids, pos_ids,
                attn_impl: str = 'auto', checkpointing: bool = False,
                collect_layers: Optional[Sequence[int]] = None,
                rope: Optional[tuple] = None, spans=None,
                remat: str = 'full', kv_gather=None, layer_gather=None,
                lora_names=None, lora_dropout: float = 0.0,
                dropout_key=None):
    """Run every layer over the per-layer params: a dict of stacked
    leaves, or a list of one dict per layer.

    ``checkpointing`` recomputes each layer in the backward from its input
    (``torch.utils.checkpoint``, the counterpart of ``_remat_wrap``,
    ``esme_tpu/models/modules.py:328-340``): all of it with
    ``remat='full'``; with ``remat='attn'`` all but the flash kernel, whose
    output o and lse the layer keeps (an
    :class:`~esme_tpu_torch.ops.flash.AttnStash` per layer call, freed by
    the attention's backward). That is JAX's policy of saving only
    ``flash_out`` and ``flash_lse``: one H1 (or H9) launch per layer and
    step instead of two, for ``T·H·D`` activations and ``H·T`` fp32 lse
    kept per layer. The einsum route (``attn_impl='reference'``) has no
    such outputs, so there 'attn' recomputes all, as in JAX. As in JAX,
    ``remat`` is ignored without ``checkpointing``.
    Returns ``(x, reps)``: ``reps`` holds the outputs of the layers in
    ``collect_layers`` (negative indices count from the end), in that
    order (reference: esme/esm.py:243-250). ``kv_gather``: the
    context-parallel hook of :func:`attention_block`, the same in every
    layer. ``layer_gather``: the FSDP hook that all-gathers a layer's
    param shards (``esme_tpu/models/modules.py:367-371``), called inside
    the checkpointed layer so that the recompute gathers again.
    ``lora_names``, ``lora_dropout``: the LoRA adapters' selection and
    dropout rate; ``dropout_key``: None (no dropout) or the forward's key,
    folded with the layer index for each layer, as JAX folds it
    (``esme_tpu/models/modules.py:373-374``). The key, not a generator's
    state, fixes each mask, so a checkpointed layer's recompute draws the
    masks of its forward.
    """
    check_remat(remat)
    if isinstance(stacked_params, dict):
        with span('esme.model.layer_params'):
            layers = [layer_params(stacked_params, i)
                      for i in range(num_layers(stacked_params))]
    else:
        layers = list(stacked_params)
    L = len(layers)
    collect = [i % L for i in (collect_layers or ())]
    reps = [None] * len(collect)
    for i in range(L):
        key = None if dropout_key is None else fold_in(dropout_key, i)
        args = (x, layers[i], cfg, seg_ids, pos_ids, attn_impl, rope, spans,
                kv_gather, layer_gather, (lora_names, lora_dropout, key))
        if checkpointing and torch.is_grad_enabled():
            stash = AttnStash() if remat == 'attn' else None
            x = checkpoint(_gathered_layer, *args, stash, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _gathered_layer(*args)
        for j, ci in enumerate(collect):
            if ci == i:
                reps[j] = x
    return x, reps


def embedding_grad(ids, dy, vocab: int):
    """The embedding table's gradient, ``onehot(ids)ᵀ @ dy``: one product
    with the ``(vocab, T)`` indicator, which sums each row's
    contributions with fp32 accumulation in an order fixed by the shapes
    alone. ``F.embedding``'s own backward
    (``aten::embedding_dense_backward``) gives other bits from call to
    call on the card at ESMC's vocabulary of 64."""
    rows = torch.arange(vocab, device=ids.device, dtype=ids.dtype)
    onehot = (rows[:, None] == ids.reshape(1, -1)).to(dy.dtype)
    return matmul(onehot, dy.reshape(-1, dy.shape[-1]))


class _Embedding(torch.autograd.Function):
    """A gather forward; the table's gradient from :func:`embedding_grad`."""

    @staticmethod
    def forward(ctx, ids, table):
        ctx.save_for_backward(ids)
        ctx.vocab = table.shape[0]
        return F.embedding(ids, table)

    @staticmethod
    def backward(ctx, dy):
        ids, = ctx.saved_tensors
        return None, embedding_grad(ids, dy, ctx.vocab)


def embed_tokens(tokens, params, cfg):
    """Token embedding with ``<mask>`` zeroing where the config asks for
    it (reference: esme/esm.py:176-199; ESMC does not zero, esm.py:876).
    The table's gradient is reproducible bit for bit from call to call
    (:func:`embedding_grad`)."""
    x = _Embedding.apply(tokens.long(), params['embed_tokens'])
    if cfg.zero_mask_embedding:
        x = torch.where((tokens == cfg.mask_idx)[..., None],
                        torch.zeros_like(x), x)
    return x


def learned_positions_flat(pos_ids, params, cfg):
    """Learned position embedding over packed positions (ESM1b, ESM1v):
    the 0-based in-sequence position maps to table row
    ``pos + 1 + padding_idx``, clipped to the table
    (``esme_tpu/models/modules.py:403-409``; reference:
    esme/embedding.py:54-81)."""
    table = params['embed_positions']
    rows = (pos_ids.long() + 1 + cfg.padding_idx).clamp(0,
                                                        table.shape[0] - 1)
    return F.embedding(rows, table)


def roberta_lm_head(x, params, embed=None):
    """``final(layer_norm(gelu(dense(x))))`` (reference: esme/head.py:25-27).

    With the final projection tied to the token embedding (no
    ``kernel`` leaf; detected at load, see models/io.py) the logits are
    computed through ``embed``.
    """
    h = linear(x, params['dense'])
    h = apply_norm(gelu(h), params['norm'])
    final = params['final']
    if 'kernel' in final:
        return linear(h, final)
    logits = matmul(h, embed.T)
    if 'bias' in final:
        logits = logits + final['bias']
    return logits
