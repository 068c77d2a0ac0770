"""Named multi-adapter LoRA over the params dict.

Counterpart of ``esme_tpu/lora.py:37-215`` (reference: esme/lora.py:8-124).
Adapters live inside the attention projections' param dicts,
``params['layers']['attn'][t]['lora'][name] = {'a': (L, in, r),
'b': (L, r, out), 'scale': (L,)}`` for ``t`` in q, k, v, out, and
:func:`esme_tpu_torch.ops.linear.linear` applies them
(``y + (x @ a) @ b * scale``, scale = alpha / rank, never trained).

Adapters work over a quantized base (:mod:`esme_tpu_torch.quant`) as over
a dense one: ``add_lora_params`` makes them in the config's dtype,
``load_lora`` in the kernel's dtype, or bf16 where the projection is
quantized (``esme_tpu/lora.py:155-157``); quantized storage never trains.

The init follows the reference: ``a`` uniform in ±in^-1/2 (kaiming-uniform
with a = √5), ``b`` zero, so adding adapters leaves the output unchanged
(reference: esme/lora.py:68-71). ``a`` is drawn from a ``torch.Generator``
(an int seeds one) on the CPU in fp32, so it cannot equal
JAX's random draw; ``b`` is zero on both sides.

Files: safetensors with the reference's torch-layout keys
``layers.{i}.self_attn.{q|k|v|out}.lora_A.{name}`` ``(rank, in)`` and
``lora_B.{name}`` ``(out, rank)``, and metadata ``rank, alpha, dropout_p,
layers, names, format='pt'`` (reference: esme/esm.py:564-607): a file of
either package loads in the other, bit for bit.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .models.init import host_generator
from .models.io import read_safetensors, write_safetensors
from .quant import NON_TRAINABLE_QUANT_LEAVES

_LAYER_TO_TARGET = {'query': 'q', 'key': 'k', 'value': 'v', 'output': 'out'}

# the linear layers' keys, under which NON_TRAINABLE_QUANT_LEAVES never train
_LINEARS = {'q', 'k', 'v', 'out', 'fc1', 'fc2', 'gate', 'up', 'down',
            'dense', 'final'}


def _targets(layers: Sequence[str]) -> List[str]:
    extra = set(layers) - set(_LAYER_TO_TARGET)
    if extra:
        raise ValueError(
            f'layers must be a subset of {set(_LAYER_TO_TARGET)}, got {extra}')
    return [_LAYER_TO_TARGET[name] for name in layers]


def _base(p: dict) -> torch.Tensor:
    """A projection's weight storage: its kernel, or its quantized
    values."""
    return p['kernel'] if 'kernel' in p else p['qvalue']


def _with_attn(params: dict) -> Tuple[dict, dict]:
    """A copy of ``params`` whose dicts down to ``layers.attn`` are new
    (the tensors shared), and that ``attn`` dict."""
    attn = dict(params['layers']['attn'])
    params = {**params, 'layers': {**params['layers'], 'attn': attn}}
    return params, attn


def add_lora_params(params: dict, cfg, rank: int = 16, alpha: float = 16,
                    layers=('query', 'value', 'output'),
                    adapter_names: Optional[Sequence[str]] = None,
                    dropout_p: float = 0.0, rng=0) -> Tuple[dict, dict]:
    """Attach named LoRA adapters to the attention projections
    (reference: esme/esm.py:495-543). Returns ``(params, lora_kwargs)``."""
    gen = host_generator(rng)
    names = list(adapter_names) if adapter_names else ['default']
    L, D = cfg.num_layers, cfg.embed_dim
    params, attn = _with_attn(params)
    for t in _targets(layers):
        device = _base(attn[t]).device
        dtype = cfg.torch_dtype
        adapters = dict(attn[t].get('lora', {}))
        bound = D ** -0.5
        for name in names:
            a = torch.empty(L, D, rank).uniform_(-bound, bound, generator=gen)
            adapters[name] = {
                'a': a.to(device=device, dtype=dtype),
                'b': torch.zeros(L, rank, D, dtype=dtype, device=device),
                'scale': torch.full((L,), alpha / rank, dtype=torch.float32,
                                    device=device),
            }
        attn[t] = {**attn[t], 'lora': adapters}
    lora_kwargs = {'rank': rank, 'alpha': alpha, 'dropout_p': dropout_p,
                   'layers': sorted(set(layers)), 'names': names}
    return params, lora_kwargs


def lora_state_dict(params: dict, adapter_names=None
                    ) -> Dict[str, torch.Tensor]:
    """Flat torch-layout LoRA tensors (reference: esme/lora.py:111-124)."""
    out: Dict[str, torch.Tensor] = {}
    for t, p in params['layers']['attn'].items():
        lora = p.get('lora') if isinstance(p, dict) else None
        for name, ad in (lora or {}).items():
            if adapter_names and name not in adapter_names:
                continue
            for i in range(ad['a'].shape[0]):
                out[f'layers.{i}.self_attn.{t}.lora_A.{name}'] = ad['a'][i].T
                out[f'layers.{i}.self_attn.{t}.lora_B.{name}'] = ad['b'][i].T
    return out


def save_lora(path: str, params: dict, lora_kwargs: dict,
              adapter_names=None):
    """(reference: esme/esm.py:564-585)"""
    state = lora_state_dict(params, adapter_names)
    if not state:
        raise ValueError('no LoRA adapters found to save')
    metadata = {
        'rank': str(lora_kwargs['rank']),
        'alpha': str(lora_kwargs['alpha']),
        'dropout_p': str(lora_kwargs['dropout_p']),
        'layers': ','.join(lora_kwargs['layers']),
        'names': ','.join(adapter_names or lora_kwargs['names']),
        'format': 'pt',
    }
    write_safetensors(path, state, metadata)


def load_lora(path: str, params: dict, names=None, cfg=None
              ) -> Tuple[dict, dict]:
    """Attach the adapters the file's metadata describes and fill their
    weights, in the dtype of each projection's kernel (bf16 over a
    quantized projection) and on its device (reference:
    esme/esm.py:587-607)."""
    flat, metadata = read_safetensors(path)
    names = names or metadata['names']
    adapter_names = names.split(',') if isinstance(names, str) \
        else list(names)
    num_layers = cfg.num_layers if cfg is not None else \
        _base(params['layers']['attn']['q']).shape[0]
    rank = int(metadata['rank'])
    alpha = float(metadata['alpha'])
    layer_names = metadata['layers'].split(',')

    params, attn = _with_attn(params)
    for lname in layer_names:
        t = _LAYER_TO_TARGET[lname]
        base = _base(attn[t])
        dtype = base.dtype if 'kernel' in attn[t] else torch.bfloat16
        adapters = dict(attn[t].get('lora', {}))
        for name in adapter_names:
            a, b = (torch.stack([
                flat[f'layers.{i}.self_attn.{t}.lora_{ab}.{name}'].T
                for i in range(num_layers)]).to(device=base.device,
                                                dtype=dtype)
                for ab in 'AB')
            adapters[name] = {
                'a': a, 'b': b,
                'scale': torch.full((num_layers,), alpha / rank,
                                    dtype=torch.float32,
                                    device=base.device)}
        attn[t] = {**attn[t], 'lora': adapters}
    lora_kwargs = {'rank': rank, 'alpha': alpha,
                   'dropout_p': float(metadata['dropout_p']),
                   'layers': layer_names, 'names': adapter_names}
    return params, lora_kwargs


def _map_path(fn, tree, path=()):
    return {k: _map_path(fn, v, path + (k,)) if isinstance(v, dict)
            else fn(path + (k,), v) for k, v in tree.items()}


def trainable_mask(params: dict, lora_only=None,
                   train_lmhead: bool = False) -> dict:
    """A tree of bools over ``params``: which leaves train
    (``mark_only_lora_as_trainable`` and ``mark_lmhead``, reference:
    esme/lora.py:97-108, esme/esm.py:609-615).

    ``lora_only``: None trains the adapters alone if there are any, else
    everything; True, or a list of adapter names, trains only (those)
    adapters; False trains everything. ``train_lmhead`` adds the LM head
    under ``lora_only``. Non-floating leaves, quantized storage and the
    LoRA scales never train."""
    has_lora = bool(lora_state_dict(params))
    if lora_only is None:
        lora_only = has_lora
    allowed_names = None
    if isinstance(lora_only, (list, tuple, set)):
        allowed_names = set(lora_only)
        lora_only = True

    def mark(keys, leaf):
        if not leaf.is_floating_point():
            return False      # int8/NF4 quantized storage
        if keys[-1] in NON_TRAINABLE_QUANT_LEAVES and len(keys) >= 2 \
                and keys[-2] in _LINEARS:
            return False      # quantization storage, never trained
        if 'scale' in keys and 'lora' in keys:
            return False      # adapter metadata, never trained
        if not lora_only:
            return True
        if 'lora' in keys:
            # path: ... 'lora' name 'a'/'b'
            return allowed_names is None or \
                keys[keys.index('lora') + 1] in allowed_names
        return bool(train_lmhead and keys[0] == 'lm_head')

    return _map_path(mark, params)
