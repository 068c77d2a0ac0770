"""Port's head relayouts (kernel H4's wrapper ``relayout_heads``, its
plain version on the CPU) vs the JAX package's Pallas kernels in
interpret mode: ``_split_call`` (K11), ``_merge_call`` (K12),
``_split_call_t`` (K7; with ``q_minor`` K8 plus K9), ``_split_one_call_t``
(K9), ``_merge_call_t`` (K10), the split inline in ``_merge_bwd`` (K13,
through ``merge_heads``' gradient), and the gradients of
``split_heads_rotary`` and ``merge_heads`` against ``jax.vjp``.

Both sides are fed the same tables (the port's). Gates: a move without
rotation is exact in both dtypes (a copy). A rotation is elementwise:
fp32 must agree to 1e-6 absolute (the same products, at most a
last-bit difference in the sum) and bf16 to one bf16 ulp of the output
(both sides round the products and the sum to bf16; XLA may fuse them
differently), the gates of ``tests/test_torch_rope_fused.py``. The
gradients are the same relayouts, so they take the same gates. The
kernel itself is held against the plain version on the card in
``tests/test_torch_kernels_cuda.py``.
"""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from esme_tpu.ops import headsplit as jhs

from esme_tpu_torch.ops import headsplit as ths
from esme_tpu_torch.ops import rotary as trot

DTYPES = [torch.float32, torch.bfloat16]


def _inputs(T, H, D, dtype, seed, n=3, shape=None):
    """``n`` tensors of ``shape`` (default ``(T, H·D)``) and the port's
    RoPE tables, as JAX arrays and torch tensors of the same values."""
    rng = np.random.default_rng(seed)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    xs = [jnp.asarray(rng.standard_normal(shape or (T, H * D)), jdt)
          for _ in range(n)]
    pos = torch.from_numpy(rng.integers(0, 1000, T).astype(np.int32))
    cos, sin = trot.rotary_cos_sin(pos, D, dtype=dtype)
    jx = xs + [jnp.asarray(t.float().numpy(), jdt) for t in (cos, sin)]
    tx = [_torch(x, dtype) for x in xs] + [cos, sin]
    return jx, tx


def _torch(x, dtype):
    return torch.from_numpy(np.array(x.astype(jnp.float32))).to(dtype)


def _close(got, ref, dtype, rotated=True):
    got = got.float().numpy()
    ref = np.asarray(ref, dtype=np.float32)
    assert got.shape == ref.shape
    if not rotated:
        np.testing.assert_array_equal(got, ref)
    elif dtype == torch.float32:
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    else:
        ulp = np.spacing(np.abs(ref)) * 2 ** 16
        assert (np.abs(got - ref) <= np.maximum(ulp, 2 ** -133)).all()


@pytest.mark.parametrize('D,dtype', [(D, torch.float32)
                                     for D in (16, 24, 32, 64, 128)]
                         + [(D, torch.bfloat16) for D in (24, 64, 128)])
@pytest.mark.parametrize('inverse', [False, True])
def test_split_call_matches_jax(inverse, D, dtype):
    T, H = 512, 3
    (qj, kj, vj, cj, sj), (qt, kt, vt, ct, st) = _inputs(T, H, D, dtype, D)
    ref = jhs._split_call(qj, kj, vj, cj, sj, H, inverse, True)
    got = ths._split_call(qt, kt, vt, ct, st, H, inverse)
    for g, r, rotated in zip(got, ref, (True, True, False)):
        assert g.dtype == dtype and g.shape == (H, T, D)
        _close(g, r, dtype, rotated)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('D', [24, 64])
@pytest.mark.parametrize('rotate,inverse', [(False, False), (False, True),
                                            (True, False), (True, True)])
def test_merge_call_matches_jax(rotate, inverse, D, dtype):
    T, H = 512, 4
    (xj, cj, sj), (xt, ct, st) = _inputs(T, H, D, dtype, D + 1, n=1,
                                         shape=(H, T, D))
    ref = jhs._merge_call(xj, cj, sj, rotate, inverse, True)
    got = ths._merge_call(xt, ct, st, rotate, inverse)
    assert got.shape == (T, H * D)
    _close(got, ref, dtype, rotate)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('D', [24, 64])
@pytest.mark.parametrize('q_minor', [False, True])
def test_split_call_t_matches_jax(q_minor, D, dtype):
    """One launch of H4 against K7 (``q_minor=False``) or against K8 for
    q and k plus K9 for v (``q_minor=True``)."""
    T, H = 512, 2
    (qj, kj, vj, cj, sj), (qt, kt, vt, ct, st) = _inputs(T, H, D, dtype,
                                                         D + 2)
    ref = jhs._split_call_t(qj, kj, vj, cj, sj, H, True, q_minor=q_minor)
    got = ths._split_call_t(qt, kt, vt, ct, st, H, q_minor=q_minor)
    shapes = ((H, D, T) if q_minor else (H, T, D), (H, D, T), (H, D, T))
    for g, r, shape, rotated in zip(got, ref, shapes, (True, True, False)):
        assert g.shape == shape
        _close(g, r, dtype, rotated)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('D', [16, 128])
def test_split_one_call_t_and_merge_call_t_match_jax(D, dtype):
    T, H = 512, 2
    (xj, cj, sj), (xt, ct, st) = _inputs(T, H, D, dtype, D + 3, n=1)
    ref = jhs._split_one_call_t(xj, H, True)
    got = ths._split_one_call_t(xt, H)
    assert got.shape == (H, D, T)
    _close(got, ref, dtype, rotated=False)
    yT = jnp.asarray(np.asarray(ref, np.float32) * 0.5 + 1.0, ref.dtype)
    yt = _torch(yT, dtype)
    for rotate, inverse in ((False, False), (True, True)):
        ref2 = jhs._merge_call_t(yT, cj, sj, rotate, inverse, True)
        got2 = ths._merge_call_t(yt, ct, st, rotate, inverse)
        assert got2.shape == (T, H * D)
        _close(got2, ref2, dtype, rotate)


@pytest.mark.parametrize('dtype', DTYPES)
def test_merge_heads_grad_is_the_split_k13(dtype):
    """``merge_heads``' gradient against the JAX VJP, which runs K13
    (``_split_one_kernel``, inline in ``_merge_bwd``): a copy, exact."""
    T, H, D = 512, 4, 32
    (xj, dyj, _, _), _ = _inputs(T, H, D, dtype, 7, n=2, shape=(H, T, D))
    dy2 = jnp.asarray(np.asarray(dyj, np.float32).reshape(T, H * D),
                      xj.dtype)
    out, vjp = jax.vjp(lambda x: jhs.merge_heads(x, True), xj)
    ref = vjp(dy2)[0]
    xt = _torch(xj, dtype).requires_grad_()
    got = ths.merge_heads(xt)
    _close(got.detach(), out, dtype, rotated=False)
    got.backward(_torch(dy2, dtype))
    assert xt.grad.dtype == dtype
    _close(xt.grad, ref, dtype, rotated=False)


def test_split_heads_rotary_grad_matches_jax():
    """fp32 gradient of a weighted sum of ``split_heads_rotary``'s three
    outputs: JAX merges dq and dk with Rᵀ and dv plain (three K12
    launches), the port does it in one H4 launch. cos and sin get no
    gradient."""
    T, H, D = 512, 3, 64
    (qj, kj, vj, cj, sj), (qt, kt, vt, ct, st) = _inputs(
        T, H, D, torch.float32, 11)
    ws = [np.random.default_rng(s).standard_normal((H, T, D))
          .astype(np.float32) for s in range(3)]

    def loss(q, k, v):
        out = jhs.split_heads_rotary(q, k, v, cj, sj, H, True)
        return sum(jnp.sum(o * w) for o, w in zip(out, ws))

    ref = jax.grad(loss, argnums=(0, 1, 2))(qj, kj, vj)
    xs = [x.clone().requires_grad_() for x in (qt, kt, vt)]
    ct.requires_grad_()
    out = ths.split_heads_rotary(*xs, ct, st, H)
    sum((o * torch.from_numpy(w)).sum() for o, w in zip(out, ws)).backward()
    for g, r in zip((x.grad for x in xs), ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6,
                                   rtol=0)
    assert ct.grad is None


def test_merge_heads_grad_matches_jax():
    T, H, D = 512, 2, 16
    (xj, wj, _, _), (xt, _, _, _) = _inputs(T, H, D, torch.float32, 12,
                                            n=2, shape=(H, T, D))
    w2 = np.array(wj).reshape(T, H * D)
    ref = jax.grad(lambda x: jnp.sum(jhs.merge_heads(x, True) * w2))(xj)
    xt.requires_grad_()
    (ths.merge_heads(xt) * torch.from_numpy(w2)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(ref))


@pytest.mark.parametrize('src', ['thd', 'htd', 'hdt'])
@pytest.mark.parametrize('dst', ['thd', 'htd', 'hdt'])
def test_relayout_round_trip(src, dst):
    """Every layout pair: rotating by R on the way and Rᵀ on the way
    back gives the input (fp32, 1e-5), and the gradient of a rotating
    relayout is the reverse one with Rᵀ (checked by autograd's own
    adjoint identity <f(x), y> = <x, f*(y)> of a linear f)."""
    T, H, D = 300, 2, 24
    _, (x, y, cos, sin) = _inputs(T, H, D, torch.float32, 13, n=2,
                                  shape=(T, H * D))
    x = ths.relayout_heads_plain([x], 'thd', src, H)[0]
    there = ths.relayout_heads([x], src, dst, H, ths.ROT_R, cos, sin)[0]
    back = ths.relayout_heads([there], dst, src, H, ths.ROT_RT, cos, sin)[0]
    np.testing.assert_allclose(back.numpy(), x.numpy(), atol=1e-5, rtol=0)
    y = ths.relayout_heads_plain([y], 'thd', dst, H)[0]
    xg = x.clone().requires_grad_()
    fx = ths.relayout([xg], src, dst, H, ths.ROT_R, cos, sin)[0]
    (fx * y).sum().backward()
    np.testing.assert_allclose((fx * y).sum().item(),
                               (x * xg.grad).sum().item(), rtol=1e-5)


def test_relayout_refuses_bad_arguments():
    x = torch.zeros(64, 32)
    with pytest.raises(ValueError, match='unknown layout'):
        ths.relayout_heads([x], 'thd', 'dth', 2)
    with pytest.raises(ValueError, match='differ in shape'):
        ths.relayout_heads([x, torch.zeros(32, 32)], 'thd', 'htd', 2)
    with pytest.raises(ValueError, match='1 to 3'):
        ths.relayout_heads([x] * 4, 'thd', 'htd', 2)
    with pytest.raises(ValueError, match='not a htd tensor'):
        ths.relayout_heads([torch.zeros(3, 64, 16)], 'htd', 'thd', 2)
    before = ths.relayout_heads.launches
    ths.relayout_heads([x], 'thd', 'hdt', 2)
    assert ths.relayout_heads.launches == before      # no kernel here


@pytest.mark.parametrize('D', ths.HEAD_DIMS)
def test_relayout_route_is_a_static_rule(D):
    """H4's kernel is a rule on the layouts and T alone: the rows kernel
    where no move has an hdt side, the vec kernel where one has and
    T % 8 == 0 (an hdt row is whole 16-byte vectors), the tile kernel
    otherwise; the C entry takes the route by its index in
    ``RELAYOUT_ROUTES``. On the CPU no route counter moves."""
    from esme_tpu_torch import _build
    moves = [('thd', 'htd'), ('htd', 'thd'), ('thd', 'hdt'), ('hdt', 'thd'),
             ('thd', ('htd', 'hdt', 'hdt')), (('htd', 'hdt', 'hdt'), 'thd')]
    for src, dst in moves:
        hdt = 'hdt' in (src, dst) or 'hdt' in src or 'hdt' in dst
        for T in (1000, 1001, 1024, 8165, 50176):
            want = 'rows' if not hdt else 'vec' if T % 8 == 0 else 'tile'
            assert ths.relayout_route(src, dst, T) == want
    assert ths.RELAYOUT_ROUTES == ('rows', 'tile', 'vec')
    _, argtypes = _build.SIGNATURES['headsplit']['esme_relayout_heads']
    assert len(argtypes) == 17
    _, (x, _, _) = _inputs(64, 2, D, torch.float32, 0, n=1)
    before = dict(ths.relayout_heads.routes)
    ths.relayout_heads([x], 'thd', 'hdt', 2)
    assert ths.relayout_heads.routes == before
