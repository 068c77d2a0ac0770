"""Linear layer over a ``{'kernel': (in, out), 'bias'?: (out,),
'lora'?: {name: {'a': (in, r), 'b': (r, out), 'scale': ()}}}`` param dict,
or a quantized one (``{'qvalue', 'scale', ...}`` in place of ``kernel``:
:mod:`esme_tpu_torch.quant`).

Counterpart of ``esme_tpu/ops/linear.py:39-79``: operands in the
activation dtype, fp32 accumulation, the product rounded once to the
activation dtype, and the bias added after that cast. Then each selected
LoRA adapter adds ``matmul(matmul(x, a), b) * scale`` (reference:
esme/lora.py:73-91), in sorted-name order unless ``lora_names`` names
them; ``scale`` (alpha / rank) is detached, never trained, and cast to
the activation dtype. With ``lora_dropout`` and a ``dropout_key``
(training), each adapter's output is dropped by inverted dropout
(reference: esme/lora.py:84-88) under a mask drawn from a generator
seeded by ``fold_in(dropout_key, j)`` for adapter ``j``, as JAX folds
its key: the same key draws the same mask, so a checkpointed layer's
recompute drops what its forward dropped. A quantized layer is
dequantized to the activation dtype and then multiplied
(:func:`esme_tpu_torch.quant.quantized_matmul`), its bias and adapters
added as a dense layer's.

On CUDA, cuBLAS may reduce bf16 split-K partial sums in bf16 unless
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
is False, and fp32 products use TF32 if
``torch.backends.cuda.matmul.allow_tf32`` is True. The models' entry
points run under :func:`fp32_accumulation`, which pins both for the
call and restores the caller's settings after it.
"""

from __future__ import annotations

import contextlib

import torch

from ..quant import quantized_matmul


@contextlib.contextmanager
def fp32_accumulation():
    """cuBLAS reductions in fp32 and fp32 products without TF32, for the
    duration of the block (also usable as a decorator)."""
    flags = torch.backends.cuda.matmul
    saved = flags.allow_bf16_reduced_precision_reduction, flags.allow_tf32
    flags.allow_bf16_reduced_precision_reduction = False
    flags.allow_tf32 = False
    try:
        yield
    finally:
        (flags.allow_bf16_reduced_precision_reduction,
         flags.allow_tf32) = saved


def matmul(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, kernel.to(x.dtype))


_MASK64 = (1 << 64) - 1


def fold_in(key: int, data: int) -> int:
    """A new dropout key from ``key`` and ``data`` (a step, layer,
    projection or adapter index), as JAX's ``random.fold_in`` derives one:
    SplitMix64's finaliser over the pair, 63 bits (a generator's seed)."""
    z = (int(key) * 0x9E3779B97F4A7C15 + int(data) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def dropout(x: torch.Tensor, rate: float, key: int) -> torch.Tensor:
    """Inverted dropout of ``x``: each element kept with probability
    ``1 - rate`` and divided by it, the rest zero, under a mask drawn
    from a generator seeded by ``key`` on ``x``'s device."""
    gen = torch.Generator(device=x.device)
    gen.manual_seed(key)
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def linear(x: torch.Tensor, params: dict, lora_names=None,
           lora_dropout: float = 0.0, dropout_key=None) -> torch.Tensor:
    """Apply a linear param dict and its selected LoRA adapters
    (``dropout_key`` None: no dropout, as in evaluation)."""
    if 'qvalue' in params:
        y = quantized_matmul(x, params)
    else:
        y = matmul(x, params['kernel'])
    if params.get('bias') is not None:
        y = y + params['bias']
    lora = params.get('lora')
    if lora:
        names = lora_names if lora_names is not None else sorted(lora)
        for j, name in enumerate(names):
            adapter = lora[name]
            scale = adapter['scale'].detach().to(x.dtype)
            contrib = matmul(matmul(x, adapter['a']), adapter['b']) * scale
            if dropout_key is not None and lora_dropout > 0.0:
                contrib = dropout(contrib, lora_dropout,
                                  fold_in(dropout_key, j))
            y = y + contrib
    return y
