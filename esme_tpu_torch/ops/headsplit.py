"""Head relayouts with optional RoPE, and RoPE on q and k in the
``(T, H·D)`` layout.

Counterpart of ``esme_tpu/ops/headsplit.py``. Two kernels:

* :func:`rotary_qk` is the wrapper of kernel H3 (``csrc/rope.cu``), which
  replaces the TPU kernel ``headsplit.py:_rot_one_kernel_t`` on the
  model path: H1 and H2 read the ``(T, H·D)`` layout directly, so there
  only the rotation is left.
* :func:`relayout_heads` is the wrapper of kernel H4
  (``csrc/headsplit.cu``), which replaces ``:_split_kernel`` (K11),
  ``:_merge_kernel`` (K12), ``:_split_one_kernel`` (K13) and
  ``:_split_kernel_t`` (K7): up to three tensors per launch move between
  the layouts ``'thd'`` ``(T, H·D)``, ``'htd'`` ``(H, T, D)`` and
  ``'hdt'`` ``(H, D, T)``, each with its own rotation (none, R or Rᵀ).
  Each launch runs one of H4's three kernels, by a static rule on the
  layouts and T (:func:`relayout_route`).

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor
it runs its plain version (:func:`rotary_qk_plain`,
:func:`relayout_heads_plain`, both through
:func:`esme_tpu_torch.ops.rotary.apply_rotary`).

The JAX package's functions have counterparts under their names, so that
a test can set each beside its JAX function: :func:`_split_call`,
:func:`_merge_call`, :func:`_split_call_t`, :func:`_split_one_call_t`,
:func:`_merge_call_t` and :func:`_split_one_call` (the split inline in
JAX's ``_merge_bwd``). They take no ``interpret``: the device decides.
:func:`split_heads_rotary` and :func:`merge_heads` carry JAX's VJPs: the
gradient of a split with R is a merge with Rᵀ, of a merge a split.
"""

from __future__ import annotations

import torch

from .rotary import apply_rotary

LAYOUTS = ('thd', 'htd', 'hdt')
# rotations of a relayout: none, R, R^T
ROT_NONE, ROT_R, ROT_RT = 0, 1, 2
# the rotation of the gradient of a move with each rotation
_ROT_VJP = {ROT_NONE: ROT_NONE, ROT_R: ROT_RT, ROT_RT: ROT_R}
HEAD_DIMS = (16, 24, 32, 64, 128)
# H4's kernels, in the C entry's order: rows (no hdt side), tile (an hdt
# side, T % 8 != 0) and vec (an hdt side, T % 8 == 0)
RELAYOUT_ROUTES = ('rows', 'tile', 'vec')


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


class _RotaryQK(torch.autograd.Function):
    """:func:`rotary_qk` with its gradient: R on q and k forward, Rᵀ on
    their gradients backward (H3 with ``inverse=True``; RoPE is
    orthogonal). The tables get no gradient. H3 is looked up in this
    module at call time, so a caller may swap in its plain version."""

    @staticmethod
    def forward(ctx, q2, k2, cos, sin, num_heads):
        ctx.save_for_backward(cos, sin)
        ctx.num_heads = num_heads
        return rotary_qk(q2, k2, cos, sin, num_heads)

    @staticmethod
    def backward(ctx, dq, dk):
        cos, sin = ctx.saved_tensors
        dq2, dk2 = rotary_qk(dq.contiguous(), dk.contiguous(), cos, sin,
                             ctx.num_heads, inverse=True)
        return dq2, dk2, None, None, None


def rotate_qk(q2, k2, cos, sin, num_heads: int):
    """RoPE on q and k ``(T, H·D)`` (kernel H3), with a gradient where q
    or k needs one (H3 with ``inverse=True`` in the backward): the
    rotation of context-parallel attention, which rotates the rank's q and
    k before the keys are gathered (``fused_rotary_flash`` rotates inside
    its own Function)."""
    if torch.is_grad_enabled() and (q2.requires_grad or k2.requires_grad):
        return _RotaryQK.apply(q2, k2, cos, sin, num_heads)
    return rotary_qk(q2, k2, cos, sin, num_heads)


# ---------------------------------------------------------------------------
# H4: relayout between (T, H·D), (H, T, D) and (H, D, T), optional RoPE
# ---------------------------------------------------------------------------

def _per_tensor(value, n, what):
    if isinstance(value, (str, int)) or value is None:
        return (value,) * n
    value = tuple(value)
    if len(value) != n:
        raise ValueError(f'relayout_heads: {len(value)} {what} for {n} '
                         'tensors')
    return value


def _shape(layout: str, T: int, H: int, D: int):
    return {'thd': (T, H * D), 'htd': (H, T, D), 'hdt': (H, D, T)}[layout]


def _logical(x, layout: str, num_heads: int):
    """``(T, D)`` of ``x`` in ``layout``."""
    if layout not in LAYOUTS:
        raise ValueError(f'relayout_heads: unknown layout {layout!r}; '
                         f'one of {LAYOUTS}')
    if x.dim() != (2 if layout == 'thd' else 3):
        raise ValueError(f'relayout_heads: a {layout} tensor has '
                         f'{2 if layout == "thd" else 3} dims, not '
                         f'{tuple(x.shape)}')
    if layout == 'thd':
        T, HD = x.shape
        if HD % num_heads:
            raise ValueError(f'relayout_heads: {HD} columns do not split '
                             f'into {num_heads} heads')
        return T, HD // num_heads
    if x.shape[0] != num_heads:
        raise ValueError(f'relayout_heads: {tuple(x.shape)} is not a '
                         f'{layout} tensor of {num_heads} heads')
    return (x.shape[1], x.shape[2]) if layout == 'htd' else \
        (x.shape[2], x.shape[1])


def _thd_view(x, layout: str, num_heads: int):
    """The ``(T, H, D)`` view of ``x`` in ``layout``."""
    if layout == 'thd':
        return x.view(x.shape[0], num_heads, -1)
    if layout == 'htd':
        return x.transpose(0, 1)
    return x.permute(2, 0, 1)


def _prepare(xs, src, dst, num_heads, rot):
    xs = tuple(xs)
    n = len(xs)
    if not 1 <= n <= 3:
        raise ValueError(f'relayout_heads: moves 1 to 3 tensors, not {n}')
    src = _per_tensor(src, n, 'source layouts')
    dst = _per_tensor(dst, n, 'destination layouts')
    rot = _per_tensor(ROT_NONE if rot is None else rot, n, 'rotations')
    T, D = _logical(xs[0], src[0], num_heads)
    for x, s, d, r in zip(xs, src, dst, rot):
        if _logical(x, s, num_heads) != (T, D) or x.dtype != xs[0].dtype:
            raise ValueError('relayout_heads: the tensors differ in shape '
                             'or dtype')
        if d not in LAYOUTS:
            raise ValueError(f'relayout_heads: unknown layout {d!r}; one '
                             f'of {LAYOUTS}')
        if r not in _ROT_VJP:
            raise ValueError(f'relayout_heads: unknown rotation {r!r}')
    return xs, src, dst, rot, T, D


def relayout_heads_plain(xs, src, dst, num_heads: int, rot=None, cos=None,
                         sin=None):
    """Plain PyTorch version of H4: the same arguments and outputs.

    Each tensor is viewed as ``(T, H, D)`` (reshape or permute), rotated
    by :func:`~esme_tpu_torch.ops.rotary.apply_rotary` with the tables'
    first halves repeated (the kernel, like the TPU kernels, reads
    ``cos[:, :D/2]``) and ``-sin`` for Rᵀ, and copied into a new
    contiguous tensor of the destination layout.
    """
    xs, src, dst, rot, T, D = _prepare(xs, src, dst, num_heads, rot)
    out = []
    for x, s, d, r in zip(xs, src, dst, rot):
        y = _thd_view(x, s, num_heads)
        if r != ROT_NONE:
            c = cos[:, :D // 2].repeat(1, 2)
            sn = sin[:, :D // 2].repeat(1, 2)
            y = apply_rotary(y, c, -sn if r == ROT_RT else sn)
        o = torch.empty(_shape(d, T, num_heads, D), dtype=x.dtype,
                        device=x.device)
        _thd_view(o, d, num_heads).copy_(y)
        out.append(o)
    return tuple(out)


def relayout_route(src, dst, T: int) -> str:
    """The kernel of a launch whose tensors move from layouts ``src`` to
    ``dst`` (one or one per tensor) over T tokens: ``'rows'`` where no
    move has an hdt side (D contiguous on both sides); else ``'vec'``
    where T % 8 == 0, so that an hdt row is whole 16-byte vectors (8
    tokens of a thread transposed in registers, the rotation on
    token-major rows); else ``'tile'`` (64-token tiles through shared
    memory, element by element at a ragged end)."""
    sides = {src} if isinstance(src, str) else set(src)
    sides |= {dst} if isinstance(dst, str) else set(dst)
    if 'hdt' not in sides:
        return 'rows'
    return 'vec' if T % 8 == 0 else 'tile'


def relayout_heads(xs, src, dst, num_heads: int, rot=None, cos=None,
                   sin=None):
    """Move up to three tensors between head layouts in one launch
    (kernel H4), rotating each as asked.

    Args:
        xs: 1 to 3 tensors of the same logical ``(T, H, D)`` shape.
        src, dst: a layout (``'thd'`` ``(T, H·D)``, ``'htd'``
            ``(H, T, D)``, ``'hdt'`` ``(H, D, T)``) or one per tensor.
        num_heads: H.
        rot: None, or a rotation or one per tensor: ``ROT_NONE``,
            ``ROT_R`` or ``ROT_RT``.
        cos, sin: ``(T, D)`` RoPE tables, needed when a tensor rotates;
            their first ``D/2`` columns are read.
    Returns:
        A tuple of new tensors in the destination layouts.
    ``launches`` counts every launch, ``routes`` those of each kernel
    (:func:`relayout_route`).
    """
    if xs[0].device.type == 'cpu':
        return relayout_heads_plain(xs, src, dst, num_heads, rot, cos, sin)
    xs, src, dst, rot, T, D = _prepare(xs, src, dst, num_heads, rot)
    what = 'relayout_heads'
    dev = xs[0].device
    if dev.type != 'cuda':
        raise ValueError(f'{what}: unsupported device {dev}')
    rotates = any(r != ROT_NONE for r in rot)
    named = [(f'tensor {i}', x) for i, x in enumerate(xs)]
    if rotates:
        named += [('cos', cos), ('sin', sin)]
        for name, t in named[-2:]:
            if t is None or tuple(t.shape) != (T, D):
                raise ValueError(f'{what}: {name} must be a ({T}, {D}) '
                                 'table')
    for name, t in named:
        if t.dtype != torch.bfloat16:
            raise TypeError(f'{what}: the CUDA kernel takes bf16; {name} is '
                            f'{t.dtype} (fp32 runs on the CPU through the '
                            'plain version)')
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f'{what}: {name} must be a contiguous, '
                             f'16-byte aligned tensor on {dev}')
    if D not in HEAD_DIMS:
        raise ValueError(f'{what}: head dim {D} is not one of {HEAD_DIMS}')
    route = relayout_route(src, dst, T)
    ys = _launch(route, xs, src, dst, num_heads, rot, cos, sin, T, D)
    relayout_heads.launches += 1
    relayout_heads.routes[route] += 1
    return ys


def _launch(route, xs, src, dst, num_heads, rot, cos, sin, T, D,
            lib=None):
    from .. import _build
    lib = _build.library('headsplit') if lib is None else lib
    dev = xs[0].device
    rotates = any(r != ROT_NONE for r in rot)
    ys = [torch.empty(_shape(d, T, num_heads, D), dtype=torch.bfloat16,
                      device=dev) for d in dst]
    ptrs = [x.data_ptr() for x in xs] + [None] * (3 - len(xs))
    outs = [y.data_ptr() for y in ys] + [None] * (3 - len(xs))
    specs = [LAYOUTS.index(s) | LAYOUTS.index(d) << 2 | r << 4
             for s, d, r in zip(src, dst, rot)] + [0] * (3 - len(xs))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.esme_relayout_heads(
        *ptrs, *outs, *specs, len(xs),
        cos.data_ptr() if rotates else None,
        sin.data_ptr() if rotates else None, T, num_heads, D,
        RELAYOUT_ROUTES.index(route), stream)
    _build.check(rc, lib, 'esme_relayout_error_string',
                 f'relayout_heads ({route})')
    return tuple(ys)


def launch_relayout(route: str, xs, src, dst, num_heads: int, rot=None,
                    cos=None, sin=None, lib=None):
    """H4's kernel ``route`` (a name of ``RELAYOUT_ROUTES``) launched
    through its C entry on :func:`relayout_heads`' arguments, which it
    does not check beyond their shapes; no counter moves. For timing one
    kernel against another: ``'tile'`` takes any launch, ``'vec'`` needs
    T % 8 == 0, ``'rows'`` no hdt side (the C entry refuses the rest).
    ``lib``, another build of the same entry (an A/B variant), takes the
    library's place."""
    xs, src, dst, rot, T, D = _prepare(xs, src, dst, num_heads, rot)
    return _launch(route, xs, src, dst, num_heads, rot, cos, sin, T, D, lib)


relayout_heads.launches = 0
relayout_heads.routes = dict.fromkeys(RELAYOUT_ROUTES, 0)


class _Relayout(torch.autograd.Function):
    """A relayout with its gradient: the reverse relayout, with Rᵀ where
    the forward rotated by R (RoPE is orthogonal) and R where it rotated
    by Rᵀ. ``cos`` and ``sin`` get no gradient. H4 is looked up in this
    module at call time, so a caller may swap in its plain version."""

    @staticmethod
    def forward(ctx, src, dst, num_heads, rot, cos, sin, *xs):
        ctx.args = (src, dst, num_heads, rot)
        ctx.save_for_backward(cos, sin)
        return relayout_heads(xs, src, dst, num_heads, rot, cos, sin)

    @staticmethod
    def backward(ctx, *grads):
        src, dst, num_heads, rot = ctx.args
        cos, sin = ctx.saved_tensors
        dxs = relayout_heads(tuple(g.contiguous() for g in grads), dst, src,
                             num_heads, tuple(_ROT_VJP[r] for r in rot), cos,
                             sin)
        return (None,) * 6 + dxs


def relayout(xs, src, dst, num_heads: int, rot=None, cos=None, sin=None):
    """:func:`relayout_heads` with a gradient (H4 both ways)."""
    rot = _per_tensor(ROT_NONE if rot is None else rot, len(xs), 'rotations')
    return _Relayout.apply(src, dst, num_heads, rot, cos, sin, *xs)


def split_heads_rotary(q2, k2, v2, cos, sin, num_heads: int):
    """Split ``(T, H·D)`` projections into three ``(H, T, D)`` tensors,
    RoPE on q and k in the same launch (K11 forward). Its gradient is
    one launch that merges dq and dk with Rᵀ and dv plain (K12)."""
    return relayout((q2, k2, v2), 'thd', 'htd', num_heads,
                    (ROT_R, ROT_R, ROT_NONE), cos, sin)


def merge_heads(x):
    """``(H, T, D)`` -> ``(T, H·D)`` (K12); its gradient is the plain
    split (K13)."""
    return relayout((x,), 'htd', 'thd', x.shape[0])[0]


# ---------------------------------------------------------------------------
# The JAX package's functions, under their names
# ---------------------------------------------------------------------------

def _rotation(rotate: bool, inverse_rotation: bool) -> int:
    if not rotate:
        return ROT_NONE
    return ROT_RT if inverse_rotation else ROT_R


def _split_call(q2, k2, v2, cos, sin, H, inverse_rotation):
    """K11: ``(T, H·D)`` q/k/v -> three ``(H, T, D)``, q and k rotated."""
    r = _rotation(True, inverse_rotation)
    return relayout_heads((q2, k2, v2), 'thd', 'htd', H, (r, r, ROT_NONE),
                          cos, sin)


def _merge_call(x, cos, sin, rotate, inverse_rotation):
    """K12: ``(H, T, D)`` -> ``(T, H·D)``, optionally rotated."""
    return relayout_heads((x,), 'htd', 'thd', x.shape[0],
                          _rotation(rotate, inverse_rotation), cos, sin)[0]


def _split_one_call(x2, H):
    """K13: ``(T, H·D)`` -> ``(H, T, D)``."""
    return relayout_heads((x2,), 'thd', 'htd', H)[0]


def _split_call_t(q2, k2, v2, cos, sin, H, q_minor=False):
    """K7: ``(T, H·D)`` q/k/v -> q ``(H, T, D)`` (``(H, D, T)`` with
    ``q_minor``, which is K8 for q and k plus K9 for v) and k, v
    token-minor ``(H, D, T)``; RoPE on q and k. One launch."""
    return relayout_heads((q2, k2, v2), 'thd',
                          ('hdt' if q_minor else 'htd', 'hdt', 'hdt'), H,
                          (ROT_R, ROT_R, ROT_NONE), cos, sin)


def _split_one_call_t(x2, H):
    """K9: ``(T, H·D)`` -> token-minor ``(H, D, T)``."""
    return relayout_heads((x2,), 'thd', 'hdt', H)[0]


def _merge_call_t(x, cos, sin, rotate, inverse_rotation):
    """K10: token-minor ``(H, D, T)`` -> ``(T, H·D)``, optionally
    rotated."""
    return relayout_heads((x,), 'hdt', 'thd', x.shape[0],
                          _rotation(rotate, inverse_rotation), cos, sin)[0]
