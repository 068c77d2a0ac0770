"""The memory slice of the port against the JAX package: ``remat='attn'``
(the checkpointed layer keeps the attention output and its lse),
``adam8bit`` (Adam with float8_e5m2 moments, ``esme_tpu_torch/train/
optim.py``) and ``MaskedPLM(offload_optimizer=True)`` (fp32 masters and the
optimizer state on the host). All at 2 layers, width 64, 4 heads.

On the CPU the kernels run as their plain versions; the JAX side runs its
Pallas kernels in interpret mode (``attn_impl='auto'``). The ranks of the
sharded cases are processes of their own (``tests/torch_cp_ranks.py``)
in a gloo group on 127.0.0.1.

Gates (each with its reason):
* ``remat='attn'`` against ``'full'`` in the port: the loss and every
  leaf's gradient bit-equal (the recompute takes the kept o and lse, the
  same values the skipped forward would give); ``flash.segment_flash_fwd``
  called 2·L times per step with ``'full'`` and L with ``'attn'`` (counted
  by a wrapper: the Functions look it up at call time).
* ``remat='attn'`` against JAX's over 3 steps (fp32): each loss within
  1e-4 relative, ``tests/test_torch_train.py::
  test_masked_plm_checkpointing_matches``' gate.
* ``adam8bit`` against ``esme_tpu.train.optim.adam8bit`` fed the same
  numpy gradients: codes (as uint8), scales and params after each update
  bit-equal. The JAX side runs op by op (``jax.disable_jit``): jitted,
  XLA:CPU contracts a product and a sum into one FMA and moves a moment by
  an ulp, which a code then shows rarely. The bias corrections, the
  correctly rounded square root and JAX's order of operations make every
  other step IEEE-exact on both sides.
* ``MaskedPLM(optimizer=adam8bit(...))`` against JAX's over 3 steps
  (fp32): losses within 1e-5 relative (the same fp32 model in another
  summation order, ``test_masked_plm_matches_jax``' gate), params within
  0.2 · learning rate per update: a gradient that differs in its last
  bits can move a moment's e5m2 code by one step (2⁻³ relative), which
  moves that element's update by up to an eighth of lr, where Adam's
  gate is 0.1 · lr.
* ``ShardedMaskedPLM(optimizer=adam8bit(...))`` on a (1, 2, 1) mesh
  against JAX's: losses within 1e-4 relative (JAX's own gate,
  ``tests/test_distributed.py``). JAX's sharded gradient is a power-of-two
  multiple of the port's (ROADMAP.md Queue 3, item 17), which leaves e5m2
  codes as they are and moves only ``eps``'s share.
* the offloaded optimizer against JAX's ``MaskedPLM(offload_optimizer=
  True)``: fp32 losses 1e-5 relative and params 0.1 · lr per update
  (``test_masked_plm_matches_jax``' gates); bf16 losses 2e-3 relative
  (``test_masked_plm_bf16_trajectory_matches_jax``' gate: the moments
  round at other points).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh

from esme_tpu.models import esm as jesm
from esme_tpu.train import MaskedPLM as JMaskedPLM
from esme_tpu.train.distributed import ShardedMaskedPLM as JSharded
from esme_tpu.train.optim import adam8bit as jadam8bit

from esme_tpu_torch.models import io as tio
from esme_tpu_torch.ops import flash as tflash
from esme_tpu_torch.ops import fused_attn
from esme_tpu_torch.train import MaskedPLM, adam8bit, stack_batches
from esme_tpu_torch.train import optim as toptim
from esme_tpu_torch.train.trainer import accumulate, leaf_groups, train_views

from test_torch_cp_train import _batch, _configs, _flat_jax, _jax_params, _run
from torch_cp_ranks import CLASSES, _flat, adam8bit_rank, remat_rank

JCLASSES = {'esm2': 'ESM2', 'esmc': 'ESMC', 'esm1b': 'ESM1b'}


def _models(family, dtype='float32', checkpointing=False):
    """The same tiny weights (JAX's seed-3 init, every leaf moved) in a JAX
    model and a port model."""
    jcfg, tcfg = _configs(family, dtype)
    jp = _jax_params(family, dtype)
    jm = getattr(jesm, JCLASSES[family])(
        config=jcfg, params=jax.tree.map(jnp.copy, jp),
        checkpointing=checkpointing)
    tm = CLASSES[family](config=tcfg, params=tio.params_from_jax(
        jax.tree.map(np.asarray, jp), tcfg), device='cpu',
        checkpointing=checkpointing)
    return jm, tm


def _batches(family, n=2):
    return [_batch(70 + i, CLASSES[family].alphabet) for i in range(n)]


def _tleaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tleaves(v, path + (k,))
        else:
            yield '.'.join(path + (k,)), v


class _Count:
    """Counts the calls of ``flash.segment_flash_fwd`` made through the
    attention Functions (``fused_attn`` and ``flash`` look it up at call
    time)."""

    def __init__(self, monkeypatch):
        self.calls = 0
        fwd = tflash.segment_flash_fwd

        def counted(*args, **kw):
            self.calls += 1
            return fwd(*args, **kw)
        monkeypatch.setattr(tflash, 'segment_flash_fwd', counted)
        monkeypatch.setattr(fused_attn, 'segment_flash_fwd', counted)


# -------------------------------------------------------------------------
# remat='attn'
# -------------------------------------------------------------------------

@pytest.mark.parametrize('family', ['esm2', 'esmc', 'esm1b'])
def test_remat_attn_is_full_bit_for_bit(family, monkeypatch):
    """With checkpointing, ``remat='attn'`` gives ``'full'``'s loss and
    every leaf's gradient bit for bit, with one attention forward per
    layer instead of two (RoPE route: ESM2, ESMC; no-RoPE route: ESM1b)."""
    count = _Count(monkeypatch)
    batch = _batches(family, 1)[0]
    out = {}
    for remat in ('full', 'attn'):
        _, tm = _models(family, checkpointing=True)
        count.calls = 0
        out[remat] = MaskedPLM(tm, remat=remat)._grad_step(batch)
        out[remat + '_calls'] = count.calls
    L = tm.config.num_layers
    assert (out['full_calls'], out['attn_calls']) == (2 * L, L)
    assert torch.equal(out['full'][0], out['attn'][0])
    full, attn = dict(_tleaves(out['full'][1])), dict(_tleaves(out['attn'][1]))
    assert full.keys() == attn.keys() and len(full) > 10
    for name, g in full.items():
        assert torch.equal(g, attn[name]), name


def test_remat_attn_frees_its_stash(monkeypatch):
    """Each checkpointed layer's stash holds o and lse from its forward to
    its attention's backward, and nothing after."""
    stashes = []
    real = tflash.AttnStash

    class Kept(real):
        __slots__ = ()

        def __init__(self):
            super().__init__()
            stashes.append(self)
    monkeypatch.setattr('esme_tpu_torch.models.modules.AttnStash', Kept)
    _, tm = _models('esm2', checkpointing=True)
    plm = MaskedPLM(tm, remat='attn')
    loss = plm._loss(plm._views, _batches('esm2', 1)[0])
    L = tm.config.num_layers
    assert len(stashes) == L and all(s.o is not None and s.lse is not None
                                     for s in stashes)
    T, C = stashes[0].o.shape
    assert C == tm.config.embed_dim and stashes[0].lse.shape == (4, T)
    loss.backward()
    assert all(s.o is None and s.lse is None for s in stashes)


@pytest.mark.parametrize('family', ['esm2', 'esm1b'])
def test_remat_attn_matches_jax(family):
    """``MaskedPLM(remat='attn')`` with checkpointing against JAX's over
    3 steps from the same weights (fp32)."""
    jm, tm = _models(family, checkpointing=True)
    batches = _batches(family)
    jt = JMaskedPLM(jm, learning_rate=1e-3, remat='attn')
    tt = MaskedPLM(tm, learning_rate=1e-3, remat='attn')
    for i in range(3):
        np.testing.assert_allclose(tt.training_step(batches[i % 2]),
                                   jt.training_step(batches[i % 2]),
                                   rtol=1e-4)


def test_remat_attn_reference_route_recomputes_all(monkeypatch):
    """The einsum route has no flash outputs to keep: 'attn' there is
    'full', as in JAX (whose policy names only the flash outputs)."""
    batch = _batches('esm2', 1)[0]
    got = {}
    for remat in ('full', 'attn'):
        _, tm = _models('esm2', checkpointing=True)
        got[remat] = MaskedPLM(tm, remat=remat,
                               attn_impl='reference')._grad_step(batch)
    assert torch.equal(got['full'][0], got['attn'][0])
    for (name, a), (_, b) in zip(_tleaves(got['full'][1]),
                                 _tleaves(got['attn'][1])):
        assert torch.equal(a, b), name


def test_remat_attn_on_the_context_parallel_route(tmp_path):
    """``ShardedMaskedPLM(seq_axis='seq', remat='attn')`` on a (1, 1, 2)
    gloo world: H9's wrapper called L times per step where ``'full'``
    calls it 2·L times, the loss and every leaf's gradient bit-equal to
    ``'full'``'s on every rank."""
    jcfg, tcfg = _configs('esm2', 'float32')
    params = tio.params_from_jax(
        jax.tree.map(np.asarray, _jax_params('esm2', 'float32')), tcfg)
    ranks = _run(remat_rank, 2, (1, 1, 2), 'esm2', tcfg, params,
                 stack_batches(_batches('esm2', 1)), out=tmp_path,
                 timeout=300)
    L = tcfg.num_layers
    for res in ranks:
        assert (int(res['full.calls']), int(res['attn.calls'])) == (2 * L, L)
        names = [k[len('full.'):] for k in res
                 if k.startswith('full.') and k != 'full.calls']
        assert len(names) > 10
        for name in names:
            np.testing.assert_array_equal(res[f'attn.{name}'],
                                          res[f'full.{name}'])


# -------------------------------------------------------------------------
# adam8bit against esme_tpu.train.optim.adam8bit
# -------------------------------------------------------------------------

L_STACK = 3
SHAPES = {'w': (L_STACK, 40, 50), 'b': (L_STACK, 50), 'e': (30, 16)}


def _grads(rng, dtype):
    """Gradients whose magnitudes span eight decades within each leaf, as
    Adam's moments do."""
    return {k: jnp.asarray((rng.standard_normal(s) * 10.0 ** rng.integers(
        -6, 2, s)).astype(np.float32)).astype(dtype)
        for k, s in SHAPES.items()}


def _port_groups(jp, dtype):
    """Each stacked leaf as L per-layer views in one param group (one JAX
    leaf), 'e' alone, as the trainers group them. The port's params are
    copies: ``np.asarray`` of an fp32 JAX array is a view of JAX's buffer,
    and the optimizer's in-place update would write into it while JAX's
    asynchronously dispatched ``apply_updates`` may still be reading it."""
    tp = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(dtype)
          for k, v in jp.items()}
    return tp, [{'params': [tp[k][i].detach().requires_grad_()
                            for i in range(L_STACK)]} if k != 'e'
                else {'params': [tp[k].detach().requires_grad_()]}
                for k in SHAPES]


def _codes(opt, group, key):
    return torch.stack([opt.state[p][key] for p in group['params']]) \
        .view(torch.uint8).numpy()


def _assert_state_equal(opt, groups, jstate, tp, jp):
    for group, k in zip(groups, SHAPES):
        head = opt.state[group['params'][0]]
        for key, jq in (('mu', jstate.mu[k]), ('nu', jstate.nu[k])):
            np.testing.assert_array_equal(
                _codes(opt, group, key).reshape(jq.q.shape),
                np.asarray(jq.q).view(np.uint8), err_msg=f'{k} {key}')
            assert float(head[f'{key}_scale']) == float(jq.scale), (k, key)
        np.testing.assert_array_equal(
            tp[k].float().numpy().view(np.uint32),
            np.asarray(jp[k].astype(jnp.float32)).view(np.uint32),
            err_msg=f'{k} params')


def test_port_groups_copy_jax_buffers():
    """The port's params of ``test_adam8bit_matches_jax`` own their
    memory. The view this replaced shared JAX's buffer (``np.asarray`` of
    an fp32 JAX array), which the port's in-place update then wrote while
    JAX's asynchronously dispatched ``apply_updates`` could still read it
    (ROADMAP.md Queue 3, item 16)."""
    jp = {k: jnp.asarray(np.ones(s, np.float32)) for k, s in SHAPES.items()}
    for dtype in (torch.float32, torch.bfloat16):
        tp, groups = _port_groups(jp, dtype)
        for k, v in jp.items():
            assert tp[k].data_ptr() != v.unsafe_buffer_pointer()
    view = torch.from_numpy(np.asarray(jp['w'].astype(jnp.float32)))
    assert view.data_ptr() == jp['w'].unsafe_buffer_pointer()


@pytest.mark.parametrize('dtype,wd,accum', [
    ('float32', 0.0, 1), ('float32', 0.05, 1), ('bfloat16', 0.0, 1),
    ('float32', 0.0, 2), ('bfloat16', 0.01, 2)],
    ids=['fp32', 'fp32-adamw', 'bf16', 'fp32-grad_accum', 'bf16-adamw-accum'])
def test_adam8bit_matches_jax(dtype, wd, accum):
    """Five updates from the same params and numpy gradients: each
    stacked leaf's codes, its one pair of scales and the params bit-equal
    to JAX's; with ``accum`` micro-batches folded by the trainers'
    ``accumulate`` against ``optax.MultiSteps``."""
    rng = np.random.default_rng(0)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jp = {k: jnp.asarray(rng.standard_normal(s) * 0.1).astype(jd)
          for k, s in SHAPES.items()}
    tx = jadam8bit(1e-2, weight_decay=wd)
    if accum > 1:
        tx = optax.MultiSteps(tx, accum)
    state = tx.init(jp)
    tp, groups = _port_groups(jp, td)
    opt = toptim.Adam8bit(groups, lr=1e-2, weight_decay=wd)
    params = [p for g in groups for p in g['params']]
    acc = {}
    for step in range(5 * accum):
        jg = _grads(rng, jd)
        with jax.disable_jit():      # op by op: no FMA contraction
            u, state = tx.update(jg, state, jp)
        jp = optax.apply_updates(jp, u)
        for group, k in zip(groups, SHAPES):
            g = torch.from_numpy(np.array(jg[k].astype(jnp.float32))).to(td)
            for i, p in enumerate(group['params']):
                p.grad = g[i].clone() if k != 'e' else g.clone()
        if accum > 1:
            accumulate(acc, params, step % accum)
        if (step + 1) % accum:
            continue
        for p in params:
            p.grad = acc.pop(p, p.grad)
        opt.step()
        views = {k: torch.stack([p.detach() for p in g['params']])
                 if k != 'e' else g['params'][0].detach()
                 for g, k in zip(groups, SHAPES)}
        _assert_state_equal(opt, groups, state.inner_opt_state if accum > 1
                            else state, views, jp)
    # one pair of scales per JAX leaf, kept in its first view's state
    scales = [k for st in opt.state.values() for k in st if 'scale' in k]
    assert len(scales) == 2 * len(SHAPES)
    assert all(opt.state[p]['mu'].dtype == torch.float8_e5m2 for p in params)


def test_adam8bit_state_is_one_byte_a_moment():
    """Codes of one byte per element and moment, two fp32 scales per
    leaf; a leaf whose bound is 0 gets the normal floor as its scale (JAX's
    ``1e-38`` is subnormal: ROADMAP.md Queue 3, item 5), no NaN."""
    p = torch.zeros(1000, 100, requires_grad=True)
    q = torch.ones(7, requires_grad=True)
    opt = toptim.Adam8bit([{'params': [p]}, {'params': [q]}], lr=1e-3,
                          weight_decay=0.1)
    p.grad, q.grad = torch.zeros_like(p), torch.full_like(q, 0.5)
    opt.step()
    st = opt.state[p]
    state_bytes = sum(t.numel() * t.element_size() for t in st.values()
                      if torch.is_tensor(t))
    assert state_bytes == 2 * p.numel() + 2 * 4
    assert float(st['mu_scale']) == float(st['nu_scale']) == 2.0 ** -126
    assert not st['mu'].float().any() and torch.equal(p, torch.zeros_like(p))
    # decay is applied: q moves by its gradient and by lr * wd * q
    assert bool(torch.isfinite(q).all()) and float(q.detach().max()) < 1.0


def test_adam8bit_takes_a_schedule():
    """``learning_rate`` may be a callable of the step count (1 at the
    first update): a constant one gives the float's params bit for bit."""
    seen = []

    def sched(count):
        seen.append(count)
        return 1e-2
    out = []
    for lr in (1e-2, sched):
        torch.manual_seed(0)
        p = torch.randn(64, 33, requires_grad=True)
        opt = adam8bit(lr)([{'params': [p]}])
        for i in range(3):
            p.grad = torch.from_numpy(
                np.random.default_rng(i).standard_normal((64, 33))
                .astype(np.float32))
            opt.step()
        out.append(p.detach().clone())
    assert seen == [1, 2, 3]
    assert torch.equal(*out)


@functools.lru_cache(maxsize=None)
def _cast_inputs():
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(2 ** 20) * 10.0 ** rng.uniform(
        -9, 5, 2 ** 20)).astype(np.float32)
    edge = np.array([0.0, -0.0, 57344.0, -57344.0, 61439.0, 61440.0,
                     65536.0, 1e30, -1e30, np.inf, -np.inf, 2.0 ** -16,
                     2.0 ** -17, 1.5 * 2.0 ** -17, 2.0 ** -18, 1e-45,
                     -1e-45, 2.0 ** -14, 3 * 2.0 ** -16],
                    dtype=np.float32)
    return np.concatenate([x, edge])


def test_float8_e5m2_casts_agree_with_jax():
    """torch's and jnp's fp32 -> float8_e5m2 casts bit for bit over 2^20
    values spread over 14 decades and the rounding, overflow, subnormal
    and signed-zero edges; and back to fp32 exactly."""
    x = _cast_inputs()
    got = torch.from_numpy(x).to(torch.float8_e5m2)
    ref = np.asarray(jnp.asarray(x).astype(jnp.float8_e5m2))
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(),
                                  ref.view(np.uint8))
    np.testing.assert_array_equal(
        got.float().numpy().view(np.uint32),
        np.asarray(jnp.asarray(ref).astype(jnp.float32)).view(np.uint32))


def _plm_pair(kw, jkw, dtype='float32'):
    jm, tm = _models('esm2', dtype)
    return (JMaskedPLM(jm, learning_rate=1e-3, **jkw),
            MaskedPLM(tm, learning_rate=1e-3, **kw), tm)


def _params_within(tm, jt, bound):
    jparams = _flat_jax(jt.state.params)
    got = {k: v.detach().float().numpy() for k, v in _tleaves(tm.params)}
    assert got.keys() == jparams.keys()
    for name, ref in jparams.items():
        err = np.abs(got[name] - ref).max()
        assert err <= bound, (name, err, bound)


@pytest.mark.parametrize('accum', [1, 2], ids=['adam8bit', 'grad_accum'])
def test_masked_plm_adam8bit_matches_jax(accum):
    """``MaskedPLM(optimizer=adam8bit(1e-3))`` against JAX's over 3 steps
    (with ``grad_accum=2``: one update, against ``optax.MultiSteps``)."""
    batches = _batches('esm2')
    jt, tt, tm = _plm_pair(dict(optimizer=adam8bit(1e-3), grad_accum=accum),
                           dict(optimizer=jadam8bit(1e-3),
                                grad_accum=accum))
    for i in range(3):
        np.testing.assert_allclose(tt.training_step(batches[i % 2]),
                                   jt.training_step(batches[i % 2]),
                                   rtol=1e-5)
    _params_within(tm, jt, 0.2 * 1e-3 * (3 // accum))
    assert isinstance(tt.optimizer, toptim.Adam8bit)
    assert len(tt.optimizer.param_groups) == len(leaf_groups(train_views(
        tm.params)))


def test_adam8bit_state_dict_round_trip(tmp_path):
    """The state through ``torch.save``/``load_state_dict`` into a new
    trainer on a copy of the weights: codes stay float8_e5m2, scales fp32,
    and both trainers' next two steps agree bit for bit."""
    batches = _batches('esm2')
    _, tm = _models('esm2')
    a = MaskedPLM(tm, learning_rate=1e-3, optimizer=adam8bit(1e-3))
    for i in range(2):
        a.training_step(batches[i])
    path = tmp_path / 'opt.pt'
    torch.save({'optimizer': a.optimizer.state_dict(),
                'params': tm.params}, path)
    saved = torch.load(path, weights_only=False)
    _, tm2 = _models('esm2')
    for (_, dst), (_, src) in zip(_tleaves(tm2.params),
                                  _tleaves(saved['params'])):
        dst.copy_(src)
    b = MaskedPLM(tm2, learning_rate=1e-3, optimizer=adam8bit(1e-3))
    b.optimizer.load_state_dict(saved['optimizer'])
    for p in (p for g in b.optimizer.param_groups for p in g['params']):
        st = b.optimizer.state[p]
        assert st['mu'].dtype == st['nu'].dtype == torch.float8_e5m2
        for k in ('mu_scale', 'nu_scale'):
            if k in st:
                assert st[k].dtype == torch.float32
    for i in range(2):
        assert a.training_step(batches[i]) == b.training_step(batches[i])
    for (name, x), (_, y) in zip(_tleaves(tm.params), _tleaves(tm2.params)):
        assert torch.equal(x, y), name


def test_sharded_masked_plm_adam8bit_matches_jax(tmp_path):
    """``ShardedMaskedPLM(optimizer=adam8bit(1e-3))`` on a (1, 2, 1) gloo
    world against JAX's sharded trainer with ``adam8bit`` on a mesh of the
    same shape: three steps' losses; both ranks hold the same params and
    the same per-leaf scales (the max of |g| is all-reduced over
    ``fsdp``); the codes are float8_e5m2."""
    jcfg, tcfg = _configs('esm2', 'float32')
    jp = _jax_params('esm2', 'float32')
    params = tio.params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    batches = _batches('esm2', 1)
    ranks = _run(adam8bit_rank, 2, (1, 2, 1), tcfg, params,
                 stack_batches(batches), out=tmp_path, timeout=300)
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape((1, 2, 1)),
                ('data', 'fsdp', 'seq'))
    jt = JSharded(jesm.ESM2(config=jcfg, params=jax.tree.map(jnp.copy, jp)),
                  mesh, optimizer=jadam8bit(1e-3), seq_axis='seq')
    jlosses = [jt.training_step(stack_batches(batches)) for _ in range(3)]
    for res in ranks:
        np.testing.assert_allclose(res['losses'], jlosses, rtol=1e-4)
        assert res['f8'].all()
        np.testing.assert_array_equal(res['scales'], ranks[0]['scales'])
        for k in res:
            if k.startswith('param.'):
                np.testing.assert_array_equal(res[k], ranks[0][k])


# -------------------------------------------------------------------------
# offload_optimizer=True
# -------------------------------------------------------------------------

@pytest.mark.parametrize('dtype,kw', [
    ('float32', {}), ('float32', {'weight_decay': 0.05}),
    ('bfloat16', {}), ('float32', {'grad_accum': 2}),
    ('float32', {'optimizer': 'adam8bit'})],
    ids=['fp32', 'adamw', 'bf16', 'grad_accum', 'adam8bit'])
def test_offload_optimizer_matches_jax(dtype, kw):
    """``MaskedPLM(offload_optimizer=True)`` against JAX's over 3 steps
    from the same weights: the losses, and in fp32 the params."""
    jkw = dict(kw)
    if kw.get('optimizer'):
        kw = {**kw, 'optimizer': adam8bit(1e-3)}
        jkw['optimizer'] = jadam8bit(1e-3)
    batches = _batches('esm2')
    jt, tt, tm = _plm_pair({**kw, 'offload_optimizer': True},
                           {**jkw, 'offload_optimizer': True}, dtype)
    for i in range(3):
        np.testing.assert_allclose(
            tt.training_step(batches[i % 2]),
            jt.training_step(batches[i % 2]),
            rtol=1e-5 if dtype == 'float32' else 2e-3)
    accum = kw.get('grad_accum', 1)
    if dtype == 'float32':
        lr_share = 0.2 if kw.get('optimizer') else 0.1
        _params_within(tm, jt, lr_share * 1e-3 * (3 // accum))
    # the last step's parts, timed on the host clock (an update only where
    # the step emits one)
    assert set(tt._host.ms) == {'device', 'grads_down'} | (
        {'host_update', 'params_up'} if 3 % accum == 0 else set())


def test_offload_optimizer_keeps_state_on_the_host():
    """The masters are fp32 host copies; the optimizer's params are those
    masters and its state lies beside them; the model's params are
    updated in place (the same storage), rounded from the masters."""
    batches = _batches('esm2')
    _, tm = _models('esm2', 'bfloat16')
    ptrs = {k: v.data_ptr() for k, v in _tleaves(tm.params)}
    plm = MaskedPLM(tm, learning_rate=1e-3, offload_optimizer=True)
    plm.training_step(batches[0])
    host = plm._host
    opt_params = [p for g in plm.optimizer.param_groups for p in g['params']]
    assert all(p.dtype == torch.float32 and p.device.type == 'cpu'
               for p in opt_params)
    assert len(opt_params) == len(plm._params)
    state = [v for st in plm.optimizer.state.values() for v in st.values()
             if torch.is_tensor(v) and v.dim()]
    assert state and all(v.dtype == torch.float32 for v in state)
    assert {k: v.data_ptr() for k, v in _tleaves(tm.params)} == ptrs
    leaves = [v for _, v in _tleaves(tm.params)]
    assert [param for param, _, _ in host._up] == leaves
    for param, master, _ in host._up:
        assert master.dtype == torch.float32 and master.device.type == 'cpu'
        assert torch.equal(param, master.to(param.dtype))
    # masters, gradient buffers, the rounding buffers and Adam's moments
    assert host.host_bytes() >= sum(v.numel() * (4 + 4 + 2 + 8)
                                    for v in leaves)
