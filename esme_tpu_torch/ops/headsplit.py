"""RoPE on q and k in the ``(T, H·D)`` layout.

Counterpart of ``esme_tpu/ops/headsplit.py``. :func:`rotary_qk` is the
wrapper of kernel H3 (``csrc/rope.cu``), which replaces the TPU kernel
``headsplit.py:_rot_one_kernel_t``. The TPU kernels of that module
also relayout ``(T, H·D)`` into the token-minor ``(H, D, T)`` the TPU
flash kernels stream; on the card ``(T, H·D) -> (T, H, D)`` is a free
view and the flash kernel reads it directly, so only the rotation is
left. On a CUDA tensor the wrapper launches the kernel or raises; on a
CPU tensor it runs :func:`rotary_qk_plain`, which is
:func:`esme_tpu_torch.ops.rotary.apply_rotary`.
"""

from __future__ import annotations

import torch

from .rotary import apply_rotary


def rotary_qk_plain(q2, k2, cos, sin, num_heads: int,
                    inverse: bool = False):
    """Plain PyTorch version of H3: ``(R q, R k)`` (``Rᵀ`` when
    ``inverse``) as new ``(T, H·D)`` tensors."""
    T, HD = q2.shape
    D = HD // num_heads
    s = -sin if inverse else sin
    return tuple(apply_rotary(x.reshape(T, num_heads, D), cos, s)
                 .reshape(T, HD) for x in (q2, k2))


def rotary_qk(q2, k2, cos, sin, num_heads: int, inverse: bool = False):
    """Rotate q and k ``(T, H·D)`` with per-token tables ``(T, D)``
    (kernel H3). ``inverse`` applies ``Rᵀ`` (the backward rotation, the
    rotating ``headsplit.py:_merge_kernel_t`` of the JAX backward).
    Writes new tensors; q2 and k2 stay unrotated. ``launches`` counts
    every launch, ``inverse_launches`` those with ``inverse``."""
    if q2.device.type == 'cpu':
        return rotary_qk_plain(q2, k2, cos, sin, num_heads, inverse)
    T, HD = q2.shape
    D = HD // num_heads
    if q2.device.type != 'cuda':
        raise ValueError(f'rotary_qk: unsupported device {q2.device}')
    for name, t, shape in (('q', q2, (T, HD)), ('k', k2, (T, HD)),
                           ('cos', cos, (T, D)), ('sin', sin, (T, D))):
        if t.dtype != torch.bfloat16:
            raise TypeError(f'rotary_qk: the CUDA kernel takes bf16; '
                            f'{name} is {t.dtype}')
        if tuple(t.shape) != shape or t.device != q2.device \
                or not t.is_contiguous() or t.data_ptr() % 4:
            raise ValueError(f'rotary_qk: {name} must be a contiguous '
                             f'{shape} tensor on {q2.device}')
    if HD != num_heads * D or D % 4:
        raise ValueError(f'rotary_qk: head dim {D} must be a multiple '
                         f'of 4 and divide {HD}')
    from .. import _build
    lib = _build.library('rope')
    qo = torch.empty_like(q2)
    ko = torch.empty_like(k2)
    stream = torch.cuda.current_stream(q2.device).cuda_stream
    rc = lib.esme_rope_qk(q2.data_ptr(), k2.data_ptr(), cos.data_ptr(),
                          sin.data_ptr(), qo.data_ptr(), ko.data_ptr(),
                          T, num_heads, D, int(bool(inverse)), stream)
    _build.check(rc, lib, 'esme_rope_error_string', 'rotary_qk')
    rotary_qk.launches += 1
    rotary_qk.inverse_launches += bool(inverse)
    return qo, ko


rotary_qk.launches = 0
rotary_qk.inverse_launches = 0
