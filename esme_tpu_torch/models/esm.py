"""ESM models: packed forward and the user-facing classes.

Counterpart of ``esme_tpu/models/esm.py``: ESM2, ESM1b, ESM1v and ESMC
(:class:`ESM2`, :class:`ESM1b`, :class:`ESM1v`, :class:`ESMC`; the
:class:`ESM` dispatcher loads any of them). The forward is a
plain function over a params dict, differentiable for training
(:class:`esme_tpu_torch.train.MaskedPLM`); the classes hold
``(config, params, device, checkpointing)`` and mirror the reference's
API:
``from_pretrained`` (optionally quantizing), ``quantize``,
``forward_representation``, ``forward``,
``predict_log_prob``, ``predict_prob``, and the LoRA methods ``add_lora``,
``lora_state_dict``, ``save_lora``/``load_lora`` and ``trainable_filter``
(reference: esme/esm.py).

Computation always runs over the packed flat token layout. Padded
``(B, L)`` inputs are repacked valid-tokens-first with one gather
(flash-attn's ``unpad_input``, reference: esme/esm.py:238), and outputs
scatter back to ``(B, L)`` with the reference's pad-fill semantics.

Entry points run on ``device='cuda'`` unless the caller asks for the
CPU; without a card they raise.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..alphabet import Alphabet, Alphabet3
from ..ops.flash import flash_spans
from ..ops.linear import fp32_accumulation
from ..ops.norm import apply_norm
from ..ops.rotary import rotary_cos_sin
from ..ops.segment import (positions_from_cu_lens, segment_ids_from_cu_lens,
                           unpad_gather_meta)
from ..profiling import span
from .config import (ESMConfig, esm1b_config, esm1v_config, esm2_config,
                     esmc_config)
from .init import init_params
from .io import load_pretrained, read_metadata, save_pretrained
from .modules import (embed_tokens, layer_stack,
                      learned_positions_flat, roberta_lm_head)

# The packed batch is padded once per forward to a multiple of ALIGN
# tokens, with one fake tail segment that real tokens never attend (as
# in the JAX package, whose flash kernels ran zero-copy at this
# multiple). The flash kernel's own tiles are smaller and independent.
ALIGN = 256


def _embed_flat(params, cfg: ESMConfig, tokens, pos_ids):
    """Embedding over flat tokens: tokens, then learned positions and the
    embedding LayerNorm where the family has them
    (``esme_tpu/models/esm.py:54-62``; reference: esme/esm.py:176-199
    ESM2, 636-655 ESM1b, 698-715 ESM1v, 876 ESMC)."""
    x = embed_tokens(tokens, params, cfg)
    if cfg.learned_positions is not None:
        x = x + learned_positions_flat(pos_ids, params, cfg)
    if cfg.emb_layer_norm_before:
        x = apply_norm(x, params['emb_norm_before'])
    return x


def forward_flat(params, cfg: ESMConfig, tokens, seg_ids, pos_ids, *,
                 with_head: bool = True, log_prob: bool = False,
                 attn_impl: str = 'auto', checkpointing: bool = False,
                 collect_layers=None, max_seqlen=None, num_jobs=None,
                 remat: str = 'full', kv_gather=None, spans=None,
                 layer_gather=None, outer_gather=None, lora_names=None,
                 lora_dropout: float = 0.0, dropout_key=None):
    """Trunk (+ optional LM head) over flat tokens with explicit
    segment/position metadata. Returns ``(T, C)``; with
    ``collect_layers`` the requested layer outputs are concatenated on
    the last axis. ``params['layers']`` is a dict of stacked leaves or a
    list of per-layer dicts (the trainer's).

    ``checkpointing``/``remat`` recompute each layer in the backward
    (:func:`~esme_tpu_torch.models.modules.layer_stack`).
    ``max_seqlen`` and ``num_jobs`` are accepted for call compatibility
    with the JAX signature and unused: the kernels walk each block's
    exact span, so they need no static span cap and no job budget.

    Pads once to ``ALIGN``; the RoPE tables (only for a family with
    rotary embeddings) and the flash block spans depend only on positions
    and segment ids, so they are computed once here and shared by every
    layer. The padded rows are sliced off.

    ``kv_gather``: the context-parallel hook (``esme_tpu/models/esm.py:
    97-100``; :func:`esme_tpu_torch.parallel.forward_flat_cp` passes it).
    The tokens are then this rank's contiguous slice of the global batch,
    and nothing is padded: a shard-local pad would corrupt the gathered
    key layout, and H9 and H10 take any length. ``spans`` is then H9's and
    H10's four spans over the local and the gathered ids with H9's launch
    order, which every layer shares
    (:func:`~esme_tpu_torch.ops.flash.rect_flash_spans` and
    :func:`~esme_tpu_torch.ops.flash.with_order`; the caller holds both
    sets of ids), or None to compute them in each layer.

    ``layer_gather``/``outer_gather``: the FSDP all-gather hooks
    (``esme_tpu/models/esm.py:75-86``;
    :func:`esme_tpu_torch.parallel.make_layer_gather`,
    :func:`~esme_tpu_torch.parallel.make_outer_gather`) when ``params``
    holds this rank's shards: the non-layer leaves are gathered here, each
    layer's inside its (checkpointed) step of the layer stack.

    ``lora_names``: the LoRA adapters applied (None: every adapter of a
    layer, in sorted order); ``lora_dropout``, ``dropout_key``: their
    output dropout in training (the key None: none), as
    :func:`~esme_tpu_torch.models.modules.layer_stack` takes them.
    """
    with span('esme.model.prepare'):
        flat = _prepare_flat(params, cfg, tokens, seg_ids, pos_ids, attn_impl,
                             kv_gather, spans, outer_gather)
    return _trunk_head(flat, cfg, with_head=with_head, log_prob=log_prob,
                       attn_impl=attn_impl, checkpointing=checkpointing,
                       collect_layers=collect_layers, remat=remat,
                       kv_gather=kv_gather, layer_gather=layer_gather,
                       lora_names=lora_names, lora_dropout=lora_dropout,
                       dropout_key=dropout_key)


class _Flat(NamedTuple):
    """What the trunk runs on: :func:`_prepare_flat`'s output."""
    params: dict
    tokens: torch.Tensor
    seg_ids: torch.Tensor
    pos_ids: torch.Tensor
    spans: object
    rope: Optional[tuple]
    T: int                      # the real tokens, before the ALIGN pad


def _prepare_flat(params, cfg: ESMConfig, tokens, seg_ids, pos_ids,
                  attn_impl: str = 'auto', kv_gather=None, spans=None,
                  outer_gather=None) -> _Flat:
    """Everything :func:`forward_flat` does before the embedding: the
    outer FSDP gather, the ``ALIGN`` pad of tokens and metadata with the
    flash block spans (the flash path), and the RoPE tables."""
    if outer_gather is not None:
        params = {**outer_gather({k: v for k, v in params.items()
                                  if k != 'layers'}),
                  'layers': params['layers']}
    T = tokens.shape[0]
    if kv_gather is not None or attn_impl == 'reference':
        seg_ids = seg_ids.to(torch.int32).contiguous()
    else:
        seg_ids, pos_ids, spans = pad_flat_meta(seg_ids, pos_ids)
        pad_token = cfg.padding_idx if cfg.padding_idx is not None else 0
        tokens = torch.cat([tokens, torch.full(
            (seg_ids.shape[0] - T,), pad_token, dtype=tokens.dtype,
            device=tokens.device)])
    # the embedding's dtype is its table's
    rope = rotary_cos_sin(pos_ids, cfg.head_dim,
                          dtype=params['embed_tokens'].dtype) \
        if cfg.rotary else None
    return _Flat(params, tokens, seg_ids, pos_ids, spans, rope, T)


def _trunk_head(flat: _Flat, cfg: ESMConfig, *, with_head: bool,
                log_prob: bool, attn_impl: str, checkpointing: bool = False,
                collect_layers=None, remat: str = 'full', kv_gather=None,
                layer_gather=None, lora_names=None, lora_dropout: float = 0.0,
                dropout_key=None):
    """:func:`forward_flat` from the embedding on: the trunk, then the
    head and the collected layers' concat."""
    params, T = flat.params, flat.T
    with span('esme.model.trunk'):
        x = _embed_flat(params, cfg, flat.tokens, flat.pos_ids)
        x, reps = layer_stack(
            x, params['layers'], cfg, flat.seg_ids, flat.pos_ids,
            attn_impl=attn_impl, checkpointing=checkpointing,
            collect_layers=collect_layers, rope=flat.rope, spans=flat.spans,
            remat=remat, kv_gather=kv_gather, layer_gather=layer_gather,
            lora_names=lora_names, lora_dropout=lora_dropout,
            dropout_key=dropout_key)
        x = apply_norm(x, params['emb_norm_after'])
        x = x[:T]
        reps = [r[:T] for r in reps]

    with span('esme.model.head'):
        if with_head:
            x = roberta_lm_head(x, params['lm_head'],
                                embed=params['embed_tokens'])
            if log_prob:
                x = torch.log_softmax(x.float(), dim=-1)
        if reps:
            x = torch.cat([x, *[r.to(x.dtype) for r in reps]], dim=-1)
    return x


def pad_flat_meta(seg_ids, pos_ids):
    """The metadata the flash path of :func:`forward_flat` runs on:
    segment ids (int32) and positions padded once to a multiple of
    ``ALIGN`` with one fake tail segment at position 0, and the flash
    kernels' block spans over them (:func:`flash_spans`). Returns
    ``(seg_ids, pos_ids, spans)``."""
    t_pad = (-seg_ids.shape[0]) % ALIGN
    if t_pad:
        seg_ids = torch.cat([seg_ids, (seg_ids.max() + 1).expand(t_pad)])
        pos_ids = torch.cat([pos_ids, torch.zeros(
            t_pad, dtype=pos_ids.dtype, device=pos_ids.device)])
    seg_ids = seg_ids.to(torch.int32).contiguous()
    return seg_ids, pos_ids, flash_spans(seg_ids)


def packed_meta(cu_lens, total: int):
    seg_ids = segment_ids_from_cu_lens(cu_lens, total)
    pos_ids = positions_from_cu_lens(cu_lens, total, seg_ids)
    return seg_ids, pos_ids


def scatter_to_padded(x, seg_ids, pos_ids, num_segments: int, max_len: int,
                      fill=None):
    """Scatter flat per-token values into ``(num_segments, max_len, C)``
    — flash-attn's ``pad_input`` (reference: esme/esm.py:255). Tokens
    outside the grid (the padding tail) are dropped; pad positions take
    ``fill`` (default zeros)."""
    shape = (num_segments, max_len) + tuple(x.shape[1:])
    if fill is None:
        out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    else:
        out = fill.to(x.dtype).expand(shape).clone()
    seg = seg_ids.long()
    pos = pos_ids.long()
    keep = (seg < num_segments) & (pos < max_len)
    out[seg[keep], pos[keep]] = x[keep]
    return out


def _repack_padded(tokens, padding_idx: int):
    """Gather a padded ``(B, L)`` batch into the monotonic packed layout
    (valid tokens first). Returns ``(flat, seg_ids, pos_ids, valid,
    dst)`` where ``dst`` scatters packed outputs back to flat order."""
    valid = tokens != padding_idx
    src, dst, seg_ids, pos_ids = unpad_gather_meta(valid)
    flat = tokens.reshape(-1)[src.long()]
    return flat, seg_ids, pos_ids, valid, dst


def _scatter_back_padded(x, dst, valid, fill):
    """Packed outputs back to ``(B, L, C)`` with ``fill`` at pads
    (reference: esme/esm.py:255)."""
    B, Lseq = valid.shape
    x = x[dst.long()].reshape(B, Lseq, -1)
    return torch.where(valid[..., None], x, fill.to(x.dtype))


def _pad_head_row(params, cfg: ESMConfig, log_prob: bool, device):
    """What the reference emits at pad positions when the head runs
    after ``pad_input``'s zero-fill (reference: esme/esm.py:255,281):
    ``lm_head(0)``, a constant row."""
    x = torch.zeros((1, cfg.embed_dim), dtype=cfg.torch_dtype,
                    device=device)
    r = roberta_lm_head(x, params['lm_head'], embed=params['embed_tokens'])
    if log_prob:
        r = torch.log_softmax(r.float(), dim=-1)
    return r[0]


def resolve_device(device) -> torch.device:
    """The entry points' device: CUDA unless the caller asks for
    another; raises when CUDA is asked for and there is no card."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'esme_tpu_torch runs on CUDA by default and no CUDA device is '
            "available; pass device='cpu' to run the plain PyTorch path")
    return device


class _ESMBase:
    """Shared stateful wrapper. Subclasses pin the family config."""

    alphabet = Alphabet
    family = 'esm2'

    def __init__(self, config: ESMConfig, params: Optional[dict] = None,
                 rng: int = 0, checkpointing: bool = False,
                 name: Optional[str] = None, device='cuda'):
        self.device = resolve_device(device)
        self.config = config
        self.checkpointing = bool(checkpointing)
        self.name = name or self.family
        self.lora_kwargs = None
        if params is None:
            params = init_params(config, rng, device=self.device)
        self.params = params

    @classmethod
    def from_pretrained(cls, path, quantization=None, checkpointing=False,
                        dtype='bfloat16', device='cuda'):
        """Load a reference-schema safetensors checkpoint
        (reference: esme/esm.py:342-374). The JAX package's parameters in
        its order, then ``device``. ``quantization`` in {None, '8bit',
        '4bit'} quantizes each linear on the host as it is read, so the
        full-precision linears never reach ``device`` (reference streams
        per layer likewise, esme/esm.py:448-472); a quantized file loads
        as it is."""
        device = resolve_device(device)
        cfg, params, name = load_pretrained(
            path, dtype=dtype, quantization=quantization, device=device)
        return _class_for(name.split('_')[0])(
            config=cfg, params=params, checkpointing=checkpointing,
            name=name, device=device)

    def save_pretrained(self, path, name=None):
        save_pretrained(path, self.params, self.config, name or self.name)
        return self

    def quantize(self, mode='8bit'):
        """Quantize the attention and MLP linears in place, on the
        model's device, one layer slice at a time (reference loads
        bitsandbytes layers, esme/esm.py:420-446). Returns the model."""
        from ..quant import quantize_model_params
        self.params = quantize_model_params(self.params, self.config, mode)
        return self

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                               else x).to(self.device)

    def _check_positions(self, width: int):
        """Raise before any launch when a sequence is wider than the
        learned position table (``esme_tpu/models/esm.py:299-309``;
        reference: esme/embedding.py:47-51,69-74); the table has 2 more
        rows than positions."""
        if self.config.learned_positions is None:
            return
        max_positions = int(self.params['embed_positions'].shape[0]) - 2
        if width > max_positions:
            raise ValueError(f'sequence length {width} above maximum '
                             f'position table size {max_positions}')

    @torch.inference_mode()
    @fp32_accumulation()
    def _run(self, tokens, pad_args=None, pad_output=False, lora_names=None,
             layers=None, attn_impl='auto', with_head=True, log_prob=False):
        lora_names = tuple(lora_names) if lora_names is not None else None
        collect = tuple(layers) if layers else None
        cfg = self.config
        with span('esme.model.prepare'):
            tokens = self._tensor(tokens).to(torch.int32)
            self._check_positions(int(pad_args[1]) if pad_args is not None
                                  else int(tokens.shape[-1]))
            if pad_args is not None:
                if tokens.dim() != 1:
                    raise ValueError('tokens must be flat (batch*seq_len) '
                                     'when pad_args given')
                cu_lens, max_len = pad_args
                cu_lens = self._tensor(cu_lens).to(torch.int32)
                seg_ids, pos_ids = packed_meta(cu_lens, tokens.shape[0])
                flat_tokens = tokens
            else:
                if tokens.dim() != 2:
                    raise ValueError('tokens must be (batch, seq_len)')
                flat_tokens, seg_ids, pos_ids, valid, dst = _repack_padded(
                    tokens, cfg.padding_idx)
            flat = _prepare_flat(self.params, cfg, flat_tokens, seg_ids,
                                 pos_ids, attn_impl)
        x = _trunk_head(flat, cfg, with_head=with_head, log_prob=log_prob,
                        attn_impl=attn_impl, collect_layers=collect,
                        lora_names=lora_names)

        if pad_args is not None and not pad_output:
            return x
        with span('esme.model.unpad'):
            if pad_args is not None:
                fill = _pad_head_row(self.params, cfg, log_prob,
                                     self.device) if with_head else None
                return scatter_to_padded(x, seg_ids, pos_ids,
                                         int(cu_lens.shape[0]) - 1,
                                         int(max_len), fill=fill)
            # representation pads are zeros (pad_input zero-fill), logits
            # pads are lm_head(0) because the reference runs the head after
            # the scatter (reference: esme/esm.py:255,281)
            fill = _pad_head_row(self.params, cfg, log_prob, self.device) \
                if with_head else torch.zeros(
                    (x.shape[-1],), dtype=x.dtype, device=x.device)
            return _scatter_back_padded(x, dst, valid, fill)

    # The entries take the JAX package's parameters in its order;
    # ``lora_names`` selects the LoRA adapters (None: all of them).

    def forward_representation(self, tokens, pad_args=None, pad_output=False,
                               lora_names=None, layers=None,
                               attn_impl='auto'):
        """(reference: esme/esm.py:201-266)"""
        return self._run(tokens, pad_args, pad_output, lora_names, layers,
                         attn_impl, with_head=False)

    def forward(self, tokens, pad_args=None, pad_output=False,
                lora_names=None, attn_impl='auto'):
        """Logits (reference: esme/esm.py:268-282)."""
        return self._run(tokens, pad_args, pad_output, lora_names, None,
                         attn_impl, with_head=True)

    __call__ = forward

    def predict_log_prob(self, tokens, pad_args=None, pad_output=False,
                         lora_names=None, attn_impl='auto'):
        """fp32 log-probabilities (reference: esme/esm.py:284-298)."""
        return self._run(tokens, pad_args, pad_output, lora_names, None,
                         attn_impl, with_head=True, log_prob=True)

    def predict_prob(self, tokens, log=False, pad_args=None,
                     pad_output=False, lora_names=None, attn_impl='auto'):
        """(reference: esme/esm.py:300-317)"""
        lp = self.predict_log_prob(tokens, pad_args, pad_output, lora_names,
                                   attn_impl)
        return lp if log else torch.exp(lp)

    # -- LoRA (esme_tpu/models/esm.py:387-420) --------------------------

    def add_lora(self, rank=16, alpha=16, layers=('query', 'value', 'output'),
                 adapter_names=None, dropout_p: float = 0.0, rng=0):
        """(reference: esme/esm.py:495-543). ``dropout_p`` drops each
        adapter's output in training steps (reference:
        esme/lora.py:84-88)."""
        from ..lora import add_lora_params
        self.params, self.lora_kwargs = add_lora_params(
            self.params, self.config, rank=rank, alpha=alpha, layers=layers,
            adapter_names=adapter_names, dropout_p=dropout_p, rng=rng)
        return self

    def lora_state_dict(self, adapter_names=None):
        from ..lora import lora_state_dict
        return lora_state_dict(self.params, adapter_names)

    def save_lora(self, path, adapter_names=None):
        from ..lora import save_lora
        save_lora(path, self.params, self.lora_kwargs, adapter_names)
        return self

    def load_lora(self, path, names=None):
        from ..lora import load_lora
        self.params, self.lora_kwargs = load_lora(path, self.params, names)
        return self

    def trainable_filter(self, lora_only=None, train_lmhead=False):
        """The trainable mask of ``params``, a tree of bools
        (``mark_only_lora_as_trainable`` / ``mark_lmhead``, reference:
        esme/lora.py:97-108, esme/esm.py:609-615)."""
        from ..lora import trainable_mask
        return trainable_mask(self.params, lora_only=lora_only,
                              train_lmhead=train_lmhead)


class ESM2(_ESMBase):
    """(reference: esme/esm.py:72-615)"""
    family = 'esm2'

    def __init__(self, num_layers=33, embed_dim=1280, attention_heads=20,
                 checkpointing=False, dtype='bfloat16', config=None,
                 params=None, rng=0, name=None, device='cuda'):
        config = config or esm2_config(num_layers, embed_dim,
                                       attention_heads, dtype=dtype)
        super().__init__(config, params=params, rng=rng,
                         checkpointing=checkpointing, name=name,
                         device=device)


class ESM1b(_ESMBase):
    """(reference: esme/esm.py:618-679)"""
    family = 'esm1b'

    def __init__(self, checkpointing=False, dtype='bfloat16', config=None,
                 params=None, rng=0, name=None, device='cuda'):
        config = config or esm1b_config(dtype=dtype)
        super().__init__(config, params=params, rng=rng,
                         checkpointing=checkpointing, name=name,
                         device=device)


class ESM1v(_ESMBase):
    """(reference: esme/esm.py:682-735)"""
    family = 'esm1v'

    def __init__(self, checkpointing=False, dtype='bfloat16', config=None,
                 params=None, rng=0, name=None, device='cuda'):
        config = config or esm1v_config(dtype=dtype)
        super().__init__(config, params=params, rng=rng,
                         checkpointing=checkpointing, name=name,
                         device=device)


class ESMC(_ESMBase):
    """(reference: esme/esm.py:738-946)"""
    family = 'esmc'
    alphabet = Alphabet3

    def __init__(self, num_layers=30, embed_dim=960, attention_heads=15,
                 checkpointing=False, dtype='bfloat16', config=None,
                 params=None, rng=0, name=None, device='cuda'):
        config = config or esmc_config(num_layers, embed_dim,
                                       attention_heads, dtype=dtype)
        super().__init__(config, params=params, rng=rng,
                         checkpointing=checkpointing, name=name,
                         device=device)


_CLASSES = {'esm2': ESM2, 'esm1b': ESM1b, 'esm1v': ESM1v, 'esmc': ESMC}


def _class_for(family: str):
    if family not in _CLASSES:
        raise ValueError(f'unknown model family: {family}')
    return _CLASSES[family]


class ESM:
    """Dispatcher: load any family by checkpoint metadata
    (reference: esme/esm.py:28-69)."""

    @staticmethod
    def from_pretrained(path, quantization=None, checkpointing=False,
                        dtype='bfloat16', device='cuda'):
        """``path``: a safetensors file, or a model name of the registry
        (:func:`esme_tpu_torch.download.download_model`: the cache, then
        the hub)."""
        if not os.path.isfile(path):
            from ..download import download_model, model_names
            if path not in model_names:
                raise FileNotFoundError(
                    f'{path}: no such checkpoint file, nor a model name '
                    f'of the registry {model_names}')
            path = download_model(path)
        family = read_metadata(path)['name'].split('_')[0]
        return _class_for(family).from_pretrained(
            path, quantization=quantization, checkpointing=checkpointing,
            dtype=dtype, device=device)
