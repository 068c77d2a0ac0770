"""Safetensors weight IO in the reference's key schema.

Counterpart of ``esme_tpu/models/io.py``. Keys are
``embed_tokens.weight``, ``embed_positions.weight`` and
``emb_layer_norm_before.*`` (ESM1b/1v),
``layers.{i}.self_attn.{norm,q,k,v,out,layernorm_q,layernorm_k}.*``,
``layers.{i}.final.{0,1,3}.*`` (GELU MLP) or
``layers.{i}.final.{0,1.activation,1.fc,2}.*`` (ESMC's SwiGLU),
``emb_layer_norm_after.*`` and ``lm_head.{dense,layer_norm,final}.*``
(reference: esme/esm.py:376-411, workflow/common/safetensor_c.py:19-49),
with metadata ``{name, num_layers, embed_dim, attention_heads}``; the
family is the name's first word. Files written by either package load
in the other.

Torch stores linear weights ``(out, in)``; the param tree keeps kernels
``(in, out)`` stacked per layer on axis 0, and both transforms happen
here at the file boundary. A quantized linear (:mod:`esme_tpu_torch.quant`)
is stored in the kernel's ``(in, out)`` layout as ``{prefix}.qweight``,
``.qscale`` and, for NF4, ``.qoutlier_idx`` and ``.qoutlier_rows``, with
metadata ``quantization`` (``8bit`` or ``4bit``) and ``qscheme:
outlier-rows-v1`` (the JAX package's extension of the schema).

The safetensors format is read and written by a small codec of its own
(:func:`read_safetensors`, :func:`write_safetensors`): an 8-byte
little-endian header length, a JSON header, then the raw little-endian
tensor bytes, bf16 as raw 16-bit words.
"""

from __future__ import annotations

import json
import struct
from dataclasses import replace
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..quant import quantize_kernel_np
from .config import (ESMConfig, esm1b_config, esm1v_config, esm2_config,
                     esmc_config)

# safetensors dtype tag -> (torch dtype, numpy dtype of the raw words)
_DTYPES = {
    'BF16': (torch.bfloat16, np.int16),
    'F16': (torch.float16, np.float16),
    'F32': (torch.float32, np.float32),
    'F64': (torch.float64, np.float64),
    'I8': (torch.int8, np.int8),
    'U8': (torch.uint8, np.uint8),
    'I16': (torch.int16, np.int16),
    'I32': (torch.int32, np.int32),
    'I64': (torch.int64, np.int64),
    'BOOL': (torch.bool, np.bool_),
}
_TAGS = {td: tag for tag, (td, _) in _DTYPES.items()}
# a qweight's storage dtype -> the file's ``quantization`` metadata
_QUANT_MODES = {torch.int8: '8bit', torch.uint8: '4bit'}


def read_safetensors(path: str) -> Tuple[Dict[str, torch.Tensor],
                                         Dict[str, str]]:
    """Read a safetensors file into ``({key: CPU tensor}, metadata)``."""
    with open(path, 'rb') as f:
        (n,) = struct.unpack('<Q', f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    metadata = header.pop('__metadata__', None) or {}
    out = {}
    for key, info in header.items():
        tdtype, ndtype = _DTYPES[info['dtype']]
        begin, end = info['data_offsets']
        arr = np.frombuffer(data, dtype=ndtype, count=(end - begin)
                            // np.dtype(ndtype).itemsize, offset=begin)
        t = torch.from_numpy(arr.copy()).reshape(info['shape'])
        out[key] = t.view(tdtype) if tdtype == torch.bfloat16 else t
    return out, metadata


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor],
                      metadata: Dict[str, str] | None = None) -> None:
    """Write ``{key: tensor}`` (any device) as a safetensors file."""
    header, blobs, offset = {}, [], 0
    for key in sorted(tensors):
        t = tensors[key].detach().to('cpu').contiguous()
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        blob = raw.numpy().astype(raw.numpy().dtype.newbyteorder('<'),
                                  copy=False).tobytes()
        header[key] = {'dtype': _TAGS[t.dtype], 'shape': list(t.shape),
                       'data_offsets': [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    if metadata:
        header['__metadata__'] = {str(k): str(v) for k, v in
                                  metadata.items()}
    hb = json.dumps(header, separators=(',', ':')).encode()
    hb += b' ' * ((-len(hb)) % 8)
    with open(path, 'wb') as f:
        f.write(struct.pack('<Q', len(hb)))
        f.write(hb)
        for blob in blobs:
            f.write(blob)


def read_metadata(path: str) -> Dict[str, str]:
    """Read the safetensors header metadata without loading tensors."""
    with open(path, 'rb') as f:
        (n,) = struct.unpack('<Q', f.read(8))
        header = json.loads(f.read(n))
    return header.get('__metadata__', {}) or {}


def config_from_metadata(metadata: Dict[str, str],
                         dtype='bfloat16') -> Tuple[ESMConfig, str]:
    """Dispatch on the metadata ``name`` (reference: esme/esm.py:50-68)."""
    name = metadata['name']
    family = name.split('_')[0]
    if family in ('esm2', 'esmc'):
        cfg = {'esm2': esm2_config, 'esmc': esmc_config}[family](
            num_layers=int(metadata['num_layers']),
            embed_dim=int(metadata['embed_dim']),
            attention_heads=int(metadata['attention_heads']), dtype=dtype)
    elif family in ('esm1b', 'esm1v'):
        # fixed sizes (reference: esme/esm.py:627-634, 691-696)
        cfg = {'esm1b': esm1b_config, 'esm1v': esm1v_config}[family](
            dtype=dtype)
    else:
        raise ValueError(f'unknown model family in metadata: {name}')
    return cfg, name


# the MLP's linears: (param key, file key under layers.{i}.final.)
_MLP_KEYS = {'gelu': (('fc1', '1'), ('fc2', '3')),
             'swiglu': (('gate', '1.activation'), ('up', '1.fc'),
                        ('down', '2'))}


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def params_to_flat(params: dict, cfg: ESMConfig) -> Dict[str, torch.Tensor]:
    """Flatten the stacked param tree into the reference key schema."""
    flat: Dict[str, torch.Tensor] = {'embed_tokens.weight':
                                     params['embed_tokens']}
    if cfg.learned_positions is not None:
        flat['embed_positions.weight'] = params['embed_positions']

    def put_norm(prefix, p):
        flat[f'{prefix}.weight'] = p['scale']
        if 'bias' in p:
            flat[f'{prefix}.bias'] = p['bias']

    def put_linear(prefix, p):
        if 'qvalue' in p:
            flat[f'{prefix}.qweight'] = p['qvalue']
            flat[f'{prefix}.qscale'] = p['scale']
            if 'outlier_idx' in p:
                flat[f'{prefix}.qoutlier_idx'] = p['outlier_idx']
                flat[f'{prefix}.qoutlier_rows'] = p['outlier_rows']
        else:
            flat[f'{prefix}.weight'] = p['kernel'].transpose(-1, -2) \
                .contiguous()
        if 'bias' in p:
            flat[f'{prefix}.bias'] = p['bias']

    if cfg.emb_layer_norm_before:
        put_norm('emb_layer_norm_before', params['emb_norm_before'])
    layers = params['layers']
    for i in range(cfg.num_layers):
        attn = _map(lambda x: x[i], layers['attn'])
        mlp = _map(lambda x: x[i], layers['mlp'])
        put_norm(f'layers.{i}.self_attn.norm', attn['norm'])
        for j in ('q', 'k', 'v', 'out'):
            put_linear(f'layers.{i}.self_attn.{j}', attn[j])
        if cfg.qk_layernorm:
            put_norm(f'layers.{i}.self_attn.layernorm_q', attn['ln_q'])
            put_norm(f'layers.{i}.self_attn.layernorm_k', attn['ln_k'])
        put_norm(f'layers.{i}.final.0', mlp['norm'])
        for key, j in _MLP_KEYS[cfg.mlp]:
            put_linear(f'layers.{i}.final.{j}', mlp[key])

    put_norm('emb_layer_norm_after', params['emb_norm_after'])
    put_linear('lm_head.dense', params['lm_head']['dense'])
    put_norm('lm_head.layer_norm', params['lm_head']['norm'])
    final = params['lm_head']['final']
    if 'kernel' in final:
        put_linear('lm_head.final', final)
    else:
        # tied head: materialise the reference schema's duplicate tensor
        flat['lm_head.final.weight'] = params['embed_tokens']
        if 'bias' in final:
            flat['lm_head.final.bias'] = final['bias']
    return flat


def flat_to_params(flat: Dict[str, torch.Tensor], cfg: ESMConfig,
                   quantization: Optional[str] = None, device='cpu') -> dict:
    """Rebuild the stacked param tree from reference-schema tensors,
    cast to ``cfg.dtype`` on ``device``.

    ``quantization`` in {None, '8bit', '4bit'} quantizes each attention
    and MLP linear on the host as it is read (fp32, the numpy twins of
    :mod:`esme_tpu_torch.quant`; NF4's outlier rows stay fp32, as in
    JAX's streaming loader), so only the quantized leaves reach
    ``device``. Quantized tensors in ``flat`` are taken as they are
    (their outlier rows cast to ``cfg.dtype``). Embeddings, norms and the
    LM head stay in ``cfg.dtype``."""
    dt = cfg.torch_dtype

    def get(key):
        return flat[key].to(device=device, dtype=dt)

    def norm(prefix):
        p = {'scale': get(f'{prefix}.weight')}
        if f'{prefix}.bias' in flat:
            p['bias'] = get(f'{prefix}.bias')
        return p

    def lin(prefix, quant=None):
        if f'{prefix}.qweight' in flat:
            p = {'qvalue': flat[f'{prefix}.qweight'],
                 'scale': flat[f'{prefix}.qscale']}
            if f'{prefix}.qoutlier_idx' in flat:
                p['outlier_idx'] = flat[f'{prefix}.qoutlier_idx']
                p['outlier_rows'] = get(f'{prefix}.qoutlier_rows')
        elif quant is not None:
            kernel = flat[f'{prefix}.weight'].float().transpose(-1, -2)
            p = {k: torch.from_numpy(v) for k, v in quantize_kernel_np(
                kernel.contiguous().numpy(), quant).items()}
        else:
            p = {'kernel': get(f'{prefix}.weight').transpose(-1, -2)
                 .contiguous()}
        if f'{prefix}.bias' in flat:
            p['bias'] = get(f'{prefix}.bias')
        return p

    def stack(fn, pattern, **kw):
        per_layer = [fn(pattern.format(i=i), **kw)
                     for i in range(cfg.num_layers)]
        return {k: torch.stack([p[k] for p in per_layer]).to(device)
                for k in per_layer[0]}

    params = {'embed_tokens': get('embed_tokens.weight')}
    if cfg.learned_positions is not None:
        params['embed_positions'] = get('embed_positions.weight')
    if cfg.emb_layer_norm_before:
        params['emb_norm_before'] = norm('emb_layer_norm_before')
    attn = {'norm': stack(norm, 'layers.{i}.self_attn.norm')}
    for j in ('q', 'k', 'v', 'out'):
        attn[j] = stack(lin, f'layers.{{i}}.self_attn.{j}',
                        quant=quantization)
    if cfg.qk_layernorm:
        attn['ln_q'] = stack(norm, 'layers.{i}.self_attn.layernorm_q')
        attn['ln_k'] = stack(norm, 'layers.{i}.self_attn.layernorm_k')
    mlp = {'norm': stack(norm, 'layers.{i}.final.0')}
    for key, j in _MLP_KEYS[cfg.mlp]:
        mlp[key] = stack(lin, f'layers.{{i}}.final.{j}', quant=quantization)
    params['layers'] = {'attn': attn, 'mlp': mlp}
    params['emb_norm_after'] = norm('emb_layer_norm_after')
    if cfg.tie_lm_head:
        final = {}
        if 'lm_head.final.bias' in flat:
            final['bias'] = get('lm_head.final.bias')
    else:
        final = lin('lm_head.final')
    params['lm_head'] = {
        'dense': lin('lm_head.dense'),
        'norm': norm('lm_head.layer_norm'),
        'final': final,
    }
    return params


def save_pretrained(path: str, params: dict, cfg: ESMConfig, name: str):
    """Write a reference-compatible safetensors checkpoint. Quantized
    params save too, with the ``quantization`` and ``qscheme`` metadata
    (the reference cannot save quantized models)."""
    flat = params_to_flat(params, cfg)
    metadata = {
        'name': name,
        'num_layers': str(cfg.num_layers),
        'embed_dim': str(cfg.embed_dim),
        'attention_heads': str(cfg.attention_heads),
        'format': 'pt',
    }
    for key, t in flat.items():
        if key.endswith('.qweight'):
            metadata['quantization'] = _QUANT_MODES[t.dtype]
        if key.endswith('.qoutlier_idx'):
            # the qweight rows at qoutlier_idx are stored zeroed and their
            # values in qoutlier_rows: load_pretrained refuses a file that
            # declares this and lacks those keys
            metadata['qscheme'] = 'outlier-rows-v1'
    write_safetensors(path, flat, metadata)


def load_pretrained(path: str, dtype='bfloat16',
                    quantization: Optional[str] = None, device='cpu'
                    ) -> Tuple[ESMConfig, dict, str]:
    """Load a reference-schema checkpoint into ``(config, params,
    name)``. ``quantization`` (None: the file's ``quantization``
    metadata, if any) quantizes the linears on the host as they are read
    (:func:`flat_to_params`). Raises ``ValueError`` for a file whose
    ``qscheme`` declares outlier rows that its ``qweight`` tensors lack.
    Detects an lm_head tied to the embedding (the reference's
    pretrained checkpoints carry the tie) and realises it: the head then
    projects through ``embed_tokens``."""
    flat, metadata = read_safetensors(path)
    cfg, name = config_from_metadata(metadata, dtype=dtype)
    if 'quantization' in metadata and quantization is None:
        quantization = metadata['quantization']
    if metadata.get('qscheme') == 'outlier-rows-v1':
        missing = [k for k in sorted(flat) if k.endswith('.qweight')
                   and k[:-len('.qweight')] + '.qoutlier_idx' not in flat]
        if missing:
            raise ValueError(
                'checkpoint metadata declares qscheme=outlier-rows-v1 but '
                f'{len(missing)} qweight tensors lack qoutlier_idx/'
                f'qoutlier_rows keys (first: {missing[0]}); the quantized '
                'weights cannot be reconstructed without them')
    if 'lm_head.final.weight' in flat:
        head = flat['lm_head.final.weight']
        emb = flat['embed_tokens.weight']
        if head.shape == emb.shape and bool(torch.equal(head, emb)):
            cfg = replace(cfg, tie_lm_head=True)
    return cfg, flat_to_params(flat, cfg, quantization=quantization,
                               device=device), name


def params_from_jax(params_np: dict, cfg: ESMConfig, device='cpu') -> dict:
    """Carry a JAX param tree with numpy leaves over to the port's
    params, bit for bit (bf16 leaves travel as raw 16-bit words), as
    copies. ``cfg`` is the port's config of the same model: every family
    has the same tree in both packages, LoRA adapters included
    (``{'a', 'b', 'scale'}`` under ``layers.attn.<t>.lora.<name>``); a
    head's tree (``cls``, ``k``, ``linear``, ``final``; or ``fc1``,
    ``fc2``) comes over the same way."""

    def convert(a):
        a = np.asarray(a)
        if a.dtype.name == 'bfloat16':
            t = torch.from_numpy(a.view(np.int16).copy()) \
                .view(torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
        return t.to(device)

    return _map(convert, params_np)
