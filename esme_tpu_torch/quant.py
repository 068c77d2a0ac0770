"""Weight-only quantization: per-channel int8 and blockwise NF4 4-bit.

Counterpart of ``esme_tpu/quant.py`` (reference: esme/esm.py:420-446,
esme/quantization.py:20-110), name for name, with the same leaves,
shapes and dtypes:

* **int8**: per-output-channel absmax over the input dim of an
  ``(..., in, out)`` kernel: ``qvalue`` int8 ``(..., in, out)``,
  ``scale`` fp32 ``(..., 1, out)``.
* **4bit**: the NF4 codebook with absmax over 64-row blocks of the input
  dim, two codes a byte (low nibble first), and the
  ``_NF4_OUTLIER_ROWS`` input rows of largest absmax kept exact:
  ``qvalue`` uint8 ``(..., in/2, out)``, ``scale`` fp32
  ``(..., in/64, 1, out)``, ``outlier_idx`` int32 ``(..., 16)``,
  ``outlier_rows`` ``(..., 16, out)`` in the kernel's dtype. The outlier
  rows are zeroed before the block scales are taken and scattered back
  at dequantization.

The torch quantizers (:func:`quantize_int8`, :func:`quantize_nf4`) run on
the tensor's device; the numpy twins (:func:`quantize_int8_np`,
:func:`quantize_nf4_np`, :func:`quantize_kernel_np`) quantize on the
host while a checkpoint streams in (``models/io.py``), so the
full-precision linears never reach the card. Each follows its JAX
counterpart: :func:`quantize_nf4` orders tied row maxima as
JAX's ``top_k`` does (lower index first, a stable descending sort),
and :func:`_outlier_rows_np` calls ``np.argsort`` as the JAX twin does,
whose order on ties is not stable, so on bf16 kernels, whose row maxima
tie, the two routes may keep other outlier rows (ROADMAP.md Queue 3,
item 23).

As in JAX, a quantized layer is dequantized and then multiplied
(:func:`quantized_matmul`; plain PyTorch, no kernel of its own), one
layer at a time under the layer loop. :func:`quantize_model_params`
quantizes the attention and MLP linears; embeddings, norms and the LM
head stay dense (reference: esme/esm.py:448-472). It quantizes a stacked
kernel one layer slice at a time, so no fp32 copy of a whole stacked leaf
is made; every operation is per slice, so the bits are those of the
whole-leaf call.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

# QLoRA NF4 codebook (public constant)
NF4_CODE = np.array([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
], dtype=np.float32)
_NF4_BOUNDARIES = (NF4_CODE[1:] + NF4_CODE[:-1]) / 2

# Input rows kept exact per kernel in the 4-bit scheme
_NF4_OUTLIER_ROWS = 16

NON_TRAINABLE_QUANT_LEAVES = ('qvalue', 'scale', 'outlier_idx',
                              'outlier_rows')


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """An fp32 scalar on ``like``'s device: a CUDA division by a CPU
    scalar multiplies by its reciprocal, which rounds otherwise."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def quantize_int8(kernel: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-output-channel absmax int8 over ``(..., in, out)`` kernels."""
    w = kernel.float()
    scale = w.abs().amax(dim=-2, keepdim=True) / _scalar(127.0, w)
    scale = torch.where(scale == 0, _scalar(1.0, w), scale)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {'qvalue': q, 'scale': scale}


def quantize_int8_np(kernel: np.ndarray) -> Dict[str, np.ndarray]:
    """Host (numpy) twin of :func:`quantize_int8`, as JAX's twin."""
    w = np.asarray(kernel, np.float32)
    scale = np.abs(w).max(axis=-2, keepdims=True) / 127.0
    scale[scale == 0] = 1.0
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return {'qvalue': q, 'scale': scale.astype(np.float32)}


def _outlier_rows_np(w, k):
    """Indices of the ``k`` largest-absmax input rows, per lead slice.
    w: (*lead, d_in, d_out) fp32. Returns idx (*lead, k) int32 and the
    exact rows (*lead, k, d_out). ``np.argsort``'s default sort, as in
    JAX's twin: its order on tied maxima is not ``top_k``'s."""
    row_absmax = np.abs(w).max(axis=-1)                # (*lead, d_in)
    idx = np.argsort(-row_absmax, axis=-1)[..., :k].astype(np.int32)
    rows = np.take_along_axis(w, idx[..., None], axis=-2)
    return idx, rows


def _check_block(d_in: int, block: int):
    if d_in % block:
        raise ValueError(f'in dim {d_in} not divisible by {block}')


def quantize_nf4_np(kernel: np.ndarray, block: int = 64
                    ) -> Dict[str, np.ndarray]:
    """Host (numpy) twin of :func:`quantize_nf4`, as JAX's twin."""
    *lead, d_in, d_out = kernel.shape
    _check_block(d_in, block)
    w = np.asarray(kernel, np.float32)
    k = min(_NF4_OUTLIER_ROWS, d_in)
    oidx, orows = _outlier_rows_np(w, k)
    wq = w.copy()
    np.put_along_axis(wq, oidx[..., None],
                      np.zeros_like(orows), axis=-2)
    wq = wq.reshape(*lead, d_in // block, block, d_out)
    absmax = np.abs(wq).max(axis=-2, keepdims=True)
    absmax[absmax == 0] = 1.0
    norm = wq / absmax
    # #{B_i < x}: np.searchsorted(B, x, side='left') as 15 compares
    idx = np.zeros(norm.shape, np.uint8)
    for b in _NF4_BOUNDARIES:
        idx += norm > b
    idx = idx.reshape(*lead, d_in // block, block // 2, 2, d_out)
    packed = (idx[..., 0, :] | (idx[..., 1, :] << 4)).astype(np.uint8)
    dt = kernel.dtype if kernel.dtype.kind == 'f' else np.float32
    return {
        'qvalue': packed.reshape(*lead, d_in // 2, d_out),
        'scale': absmax.reshape(*lead, d_in // block, 1,
                                d_out).astype(np.float32),
        'outlier_idx': oidx,
        'outlier_rows': orows.astype(dt),
    }


def quantize_kernel_np(kernel: np.ndarray, mode: str
                       ) -> Dict[str, np.ndarray]:
    fn = {'8bit': quantize_int8_np, '4bit': quantize_nf4_np,
          '8bitexperimental': quantize_int8_np}[mode]
    return fn(kernel)


def quantize_nf4(kernel: torch.Tensor, block: int = 64
                 ) -> Dict[str, torch.Tensor]:
    """Blockwise NF4 over the input dim of ``(..., in, out)`` kernels,
    with the top-``_NF4_OUTLIER_ROWS`` input rows kept exact; tied row
    maxima in JAX's ``top_k`` order (lower index first)."""
    *lead, d_in, d_out = kernel.shape
    _check_block(d_in, block)
    w = kernel.float()
    k = min(_NF4_OUTLIER_ROWS, d_in)
    row_absmax = w.abs().amax(dim=-1)                  # (*lead, d_in)
    oidx = torch.sort(row_absmax, dim=-1, descending=True,
                      stable=True).indices[..., :k]
    orows = torch.take_along_dim(w, oidx[..., None], dim=-2)
    keep = torch.ones(w.shape[:-1], dtype=torch.bool,
                      device=w.device).scatter(-1, oidx, False)
    w0 = torch.where(keep[..., None], w, _scalar(0.0, w))
    w0 = w0.reshape(*lead, d_in // block, block, d_out)
    absmax = w0.abs().amax(dim=-2, keepdim=True)
    absmax = torch.where(absmax == 0, _scalar(1.0, w), absmax)
    idx = torch.searchsorted(_tables(w.device)[1], w0 / absmax) \
        .to(torch.uint8)
    # two codes a byte along the block dim, the even row in the low nibble
    idx = idx.reshape(*lead, d_in // block, block // 2, 2, d_out)
    packed = idx[..., 0, :] | (idx[..., 1, :] << 4)
    return {
        'qvalue': packed.reshape(*lead, d_in // 2, d_out),
        'scale': absmax.reshape(*lead, d_in // block, 1, d_out),
        'outlier_idx': oidx.to(torch.int32),
        'outlier_rows': orows.to(kernel.dtype),
    }


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """The fp32 constants on ``device`` (never written), copied there
    once: a copy from host memory waits for the device, and ``dequantize``
    runs before every quantized linear. ``(codebook (16,), boundaries (15,), pairs (256,
    2))``: ``pairs[b]`` decodes byte ``b``, the low nibble first."""
    b = np.arange(256)
    pairs = np.stack([NF4_CODE[b & 0x0F], NF4_CODE[b >> 4]], axis=-1)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (NF4_CODE, _NF4_BOUNDARIES, pairs))


def _nf4_decode(idx: torch.Tensor) -> torch.Tensor:
    """The fp32 codebook values of the codes ``idx`` (a lookup; JAX's
    select tree gives the same values)."""
    code = _tables(idx.device)[0]
    return torch.index_select(code, 0, idx.reshape(-1).int()) \
        .reshape(idx.shape)


def dequantize(params: Dict[str, torch.Tensor],
               dtype=torch.bfloat16) -> torch.Tensor:
    """Back to a dense ``(..., in, out)`` kernel in ``dtype``. The scheme
    follows the storage dtype: int8 per-channel, uint8 packed NF4. Each
    weight is its fp32 code times its fp32 scale, rounded once to
    ``dtype``, as in JAX, computed in one pass that writes ``dtype``."""
    q = params['qvalue']
    if q.dtype == torch.int8:
        w = torch.empty(q.shape, dtype=dtype, device=q.device)
        return torch.mul(q, params['scale'], out=w)
    if q.dtype == torch.uint8:
        *lead, half_in, d_out = q.shape
        scale = params['scale']
        nblocks = scale.shape[-3]
        half_block = half_in // nblocks
        # each byte's two codes, (..., in/2, out, 2), viewed as rows
        # (..., blocks, rows of a block / 2, 2, out) of the kernel
        vals = torch.index_select(_tables(q.device)[2], 0,
                                  q.reshape(-1).int())
        vals = vals.reshape(*lead, nblocks, half_block, d_out, 2) \
            .transpose(-1, -2)
        w = torch.empty((*lead, nblocks, half_block, 2, d_out), dtype=dtype,
                        device=q.device)
        torch.mul(vals, scale.unsqueeze(-2), out=w)
        w = w.reshape(*lead, half_in * 2, d_out)
        if 'outlier_idx' in params:
            # the exact outlier rows back (zeroed at quantize time)
            oidx = params['outlier_idx'].long()
            orows = params['outlier_rows'].to(dtype)
            w.scatter_(-2, oidx[..., None].expand(orows.shape), orows)
        return w
    raise ValueError(f'unknown quant dtype {q.dtype}')


class _QuantizedMatmul(torch.autograd.Function):
    """``x @ dequantize(params)`` whose backward dequantizes again: the
    stored leaves never train, so it keeps only them (no dense kernel, and
    not ``x``, which only a kernel's gradient would need). Autograd over
    the plain product would keep every layer's dense kernel until the
    backward (1.3 GB of bf16 at ESM2-650M)."""

    @staticmethod
    def forward(ctx, x, names, *leaves):
        ctx.names = names
        ctx.save_for_backward(*leaves)
        return torch.matmul(x, dequantize(dict(zip(names, leaves)),
                                          dtype=x.dtype))

    @staticmethod
    def backward(ctx, dy):
        leaves = ctx.saved_tensors
        w = dequantize(dict(zip(ctx.names, leaves)), dtype=dy.dtype)
        return (torch.matmul(dy, w.mT), None, *[None] * len(leaves))


def quantized_matmul(x: torch.Tensor,
                     params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``x @ dequantize(params)`` in ``x``'s dtype, fp32 accumulation
    (``ops.linear.matmul``'s product); its gradient is ``x``'s alone
    (:class:`_QuantizedMatmul`, whose Python call is skipped when no
    gradient is taken). Raises ``ValueError`` if a stored leaf requires a
    gradient: quantized storage never trains."""
    names = tuple(k for k in NON_TRAINABLE_QUANT_LEAVES if k in params)
    leaves = [params[k] for k in names]
    trained = [k for k, t in zip(names, leaves) if t.requires_grad]
    if trained:
        raise ValueError(f'quantized storage never trains: {trained} '
                         'require a gradient')
    if torch.is_grad_enabled() and x.requires_grad:
        return _QuantizedMatmul.apply(x, names, *leaves)
    return torch.matmul(x, dequantize(params, dtype=x.dtype))


_QUANTIZERS = {'8bit': quantize_int8, '4bit': quantize_nf4,
               '8bitexperimental': quantize_int8}


def _by_slice(fn, kernel: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``fn(kernel)`` computed one ``(in, out)`` slice at a time into
    stacked outputs."""
    if kernel.dim() == 2:
        return fn(kernel)
    lead = kernel.shape[:-2]
    slices = kernel.reshape(-1, *kernel.shape[-2:])
    out = None
    for i in range(slices.shape[0]):
        part = fn(slices[i])
        if out is None:
            out = {k: torch.empty((slices.shape[0], *v.shape), dtype=v.dtype,
                                  device=v.device) for k, v in part.items()}
        for k, v in part.items():
            out[k][i] = v
    return {k: v.reshape(*lead, *v.shape[1:]) for k, v in out.items()}


def quantize_params(linear_params: dict, mode: str) -> dict:
    """Quantize one linear param dict, keeping bias/lora leaves."""
    if 'qvalue' in linear_params:
        return linear_params
    fn = _QUANTIZERS[mode]
    out = {k: v for k, v in linear_params.items() if k != 'kernel'}
    out.update(_by_slice(fn, linear_params['kernel']))
    return out


def quantize_model_params(params: dict, cfg, mode: str = '8bit') -> dict:
    """Quantize attention + MLP linears (reference walks the same set:
    q/k/v/out + the two/three MLP linears, esme/esm.py:448-472)."""
    if mode not in _QUANTIZERS:
        raise ValueError(f'unknown quantization mode {mode!r}')
    params = dict(params)
    layers = {k: dict(v) for k, v in params['layers'].items()}
    for name in ('q', 'k', 'v', 'out'):
        layers['attn'][name] = quantize_params(layers['attn'][name], mode)
    mlp_linears = ('gate', 'up', 'down') if cfg.mlp == 'swiglu' \
        else ('fc1', 'fc2')
    for name in mlp_linears:
        layers['mlp'][name] = quantize_params(layers['mlp'][name], mode)
    params['layers'] = layers
    return params
