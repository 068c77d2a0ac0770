"""Restoring a sharded training state on a mesh of another shape: the
port's ``CheckpointManager.restore`` with a ``ShardedMaskedPLM`` state as
template, against itself (A -> B -> A), against the uninterrupted run,
and against JAX's ``ShardedMaskedPLM`` and orbax-backed
``CheckpointManager`` on the same mesh pairs (``tests/conftest.py`` gives
JAX 8 CPU devices).

The port's ranks are processes of their own
(``tests/torch_cp_ranks.py:reshard_rank``, which imports no JAX), spawned
once per mesh pair; each joins a gloo world on 127.0.0.1 for each mesh
of the round trip in turn. Every kernel runs as its plain version.

Each pair ``(A, B)`` of ``(data, fsdp, seq)`` shapes runs three trainers,
all with ``grad_accum=2`` and ``seq_axis='seq'``, cut after three
micro-steps (one update, a cycle left open):
* ``adam``: every leaf trains under Adam; ESM2 of 2 layers, width 150,
  3 heads, fp32 (JAX's init from seed 3, every leaf moved by
  0.1·N(0, 1)). At width 150 the projections' kernels are sharded at
  ``fsdp`` 1 and 2 and replicated at 4 (150 is not a multiple of 4), and
  ``fc2``'s moves from its dim 2 to its dim 1;
* ``adam8bit``: the same under ``adam8bit`` (e5m2 codes, global scales);
* ``nf4_lora``: ESM2 of 2 layers, width 192, 3 heads, fp32 (seed 3),
  quantized to NF4, LoRA rank 90 on query, value and output (``b``
  lifted to 0.01·N(0, 1)), ``lora_only=True``: the frozen ``uint8`` and
  ``int32`` leaves are resharded too, and an adapter's ``a`` moves from
  its dim 2 to its dim 1 at ``fsdp`` 4.

The global batch is two packed batches of 1,024 tokens; a mesh with one
data row takes them as one row of 2,048 (the first one's padding a
segment of its own), so every mesh computes the same global masked mean.

Gates (each with its reason):
* A -> B -> A: every param, every optimizer state tensor and scalar, the
  step: bit for bit in every rank's part (resharding cuts and joins
  bytes). The open cycle's gradients: each leaf's sum over its reduce
  group, in coordinate order, bit for bit (the restore keeps that sum on
  one rank of the new group and ``-0.0`` on the others, and adds nothing
  else);
* B's restored params, gathered: bit-equal to A's at the cut;
* the resumed fourth micro-step on B against the uninterrupted one on A,
  the gate ``tests/test_torch_sharded_lora.py`` holds the sharded
  gradient to against JAX's single-device one: the loss 1e-5 relative
  and, per trained leaf, the gradient the update takes within 1e-4 ·
  max|g| (the same fp32 sums in another order: B sums the open cycle's
  gradients over its own ranks, and adds the new micro-step's to them
  rather than to each rank's share). The params after that update
  within 1e-4 · lr of the uninterrupted ones; under ``adam8bit`` all but
  a thousandth of each leaf's elements so, and every one within 2 · lr
  (its e5m2 codes are rounded from the moments, and a gradient an ulp
  away can round a code to its neighbour, 2^-2 of the code apart; none
  did in these runs, where the largest difference was 2.98e-8 under
  either optimizer). A misplaced block of params, moments or codes moves
  most of its elements by ~lr or more;
* against JAX (``adam`` only, as JAX's restore of its ``MultiSteps``
  state): B's restored params, gathered, within 2 · lr of JAX's restored
  global arrays, every leaf: one Adam update apart at most (each side's
  first update is at most lr per element), since JAX's gradient is a
  multiple of the port's (ROADMAP.md Queue 3, item 17) and Adam's ``eps``
  weighs the two differently where |g| is near it; a block in the wrong
  place moves a leaf by its own size, ~0.1. The loss of the next step on
  B within rtol 1e-4 of JAX's, the gate of JAX's own tests
  (``tests/test_distributed.py:53-70``) that
  ``tests/test_torch_sharded_lora.py`` holds two steps to. The update
  after it is not compared: JAX's resumed update mixes the two meshes'
  multiples (ROADMAP.md Queue 3, item 29);
* the refusals: ``ValueError`` naming the cause, never a silent restore;
* each replicated shard written once, as orbax writes it: before each
  save the ranks of an ``fsdp`` coordinate (the replicas along ``data``
  and ``seq``) hold the same params and optimizer state, bit for bit (so
  one of them can stand for all), and in every checkpoint the parts at a
  ``data`` or ``seq`` coordinate other than 0 hold no param or optimizer
  tensor, while each still holds its own open cycle's gradients, step
  and layout;
* parts written in the old form (every rank its whole part) still
  restore: on B, resharded, to the state B restored from the new form,
  and on A's own shape to A's saved part, bit for bit in every field.
"""

import functools
import tempfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from esme_tpu.models import config as jconfig
from esme_tpu.models import esm as jesm
from esme_tpu.models.init import init_params as jinit
from esme_tpu.train.checkpoint import CheckpointManager as JCheckpoints
from esme_tpu.train.distributed import ShardedMaskedPLM as JSharded

from esme_tpu_torch import ESM2
from esme_tpu_torch.models import config as tconfig
from esme_tpu_torch.models import io as tio
from esme_tpu_torch.parallel.fsdp import _leaf_dim, reshard_leaf
from esme_tpu_torch.train import stack_batches
from esme_tpu_torch.train.checkpoint import _load

from test_torch_cp_train import MAX_SEGMENTS, T_BATCH, _batch
from torch_cp_ranks import reshard_refusal_rank, reshard_rank
from torch_spawn import free_ports, spawn

LR = 1e-3
PAIRS = {
    '1x1x1-1x4x1': ((1, 1, 1), (1, 4, 1)),
    '1x4x1-1x2x1': ((1, 4, 1), (1, 2, 1)),
    '2x2x1-1x1x2': ((2, 2, 1), (1, 1, 2)),
    '1x2x2-2x1x1': ((1, 2, 2), (2, 1, 1)),
}
# The pairs whose tests this file collects; each other pair has a file of
# its own (test_torch_reshard_<A>_<B>.py, which imports these tests), so
# that xdist's --dist loadfile gives each pair's spawned world and JAX's
# run of it a worker of its own
PAIR_NAMES = ('1x1x1-1x4x1',)
RUNS = ('adam', 'adam8bit', 'nf4_lora')
DENSE = dict(num_layers=2, embed_dim=150, attention_heads=3)
NF4 = dict(num_layers=2, embed_dim=192, attention_heads=3)
NF4_RANK = 90


def pytest_generate_tests(metafunc):
    """``name``: the mesh pairs (``PAIR_NAMES``) of the module that
    collects the test."""
    if 'name' in metafunc.fixturenames:
        metafunc.parametrize('name', metafunc.module.PAIR_NAMES)


def _bits(x) -> np.ndarray:
    """The bytes of an array or tensor (compares -0.0 and NaNs too)."""
    if torch.is_tensor(x):
        x = x.detach().reshape(-1).contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def _named(tree, path=''):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, f'{path}{k}.')
        else:
            yield f'{path}{k}', v


# -------------------------------------------------------------------------
# (1) the leaf function
# -------------------------------------------------------------------------

DTYPES = (torch.float32, torch.bfloat16, torch.float8_e5m2, torch.uint8,
          torch.int32)


def _blocks(leaf, d, n):
    """``leaf`` as ``n`` ranks hold it: blocks of dim ``d``, or copies."""
    return [leaf.clone() for _ in range(n)] if d is None else \
        [b.clone() for b in leaf.chunk(n, d)]


@settings(max_examples=80, deadline=None)
@given(data=st.data())
def test_reshard_leaf_round_trip(data):
    """Blocks saved at n ranks, resharded to m ranks and back to n, are
    the saved blocks byte for byte; each of the m blocks is the leaf's
    block by the dims ``fsdp_partition_specs``' rule picks at m (which
    may be another dim, or none)."""
    shape = tuple(data.draw(st.lists(st.sampled_from([1, 2, 3, 4, 6, 8, 12]),
                                     min_size=1, max_size=3)))
    n, m = (data.draw(st.sampled_from([1, 2, 3, 4])) for _ in range(2))
    dtype = data.draw(st.sampled_from(DTYPES))
    min_size = data.draw(st.sampled_from([1, 16, 10 ** 6]))
    rng = np.random.default_rng(data.draw(st.integers(0, 2 ** 32 - 1)))
    size = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    leaf = torch.from_numpy(rng.integers(0, 256, size, dtype=np.uint8)) \
        .view(dtype).reshape(shape)
    d, e = _leaf_dim(leaf, n, min_size), _leaf_dim(leaf, m, min_size)
    saved = _blocks(leaf, d, n)
    moved = [reshard_leaf(saved, d, e, m, j) for j in range(m)]
    for got, want in zip(moved, _blocks(leaf, e, m)):
        assert got.dtype == dtype and got.is_contiguous()
        np.testing.assert_array_equal(_bits(got), _bits(want))
    for i in range(n):
        np.testing.assert_array_equal(
            _bits(reshard_leaf(moved, e, d, n, i)), _bits(saved[i]))


@pytest.mark.parametrize('shape,n,m,dims', [
    ((2, 150, 150), 2, 4, (2, None)),     # sharded -> replicated
    ((2, 150, 150), 4, 1, (None, 2)),     # replicated -> one block
    ((2, 600, 150), 2, 4, (2, 1)),        # another dim
    ((2, 192, 90), 1, 4, (2, 1)),
])
def test_reshard_leaf_cases(shape, n, m, dims):
    """The cases the mesh pairs below exercise, by the real rule at
    ``MIN_SIZE``: the dims are as stated, and n -> m -> n is the
    identity, byte for byte, in fp32, bf16 and uint8."""
    for dtype in (torch.float32, torch.bfloat16, torch.uint8):
        leaf = (torch.randn(shape) * 100).to(dtype)
        d, e = (_leaf_dim(leaf, k, 2 ** 15) for k in (n, m))
        assert (d, e) == dims
        saved = _blocks(leaf, d, n)
        moved = [reshard_leaf(saved, d, e, m, j) for j in range(m)]
        for i in range(n):
            np.testing.assert_array_equal(
                _bits(reshard_leaf(moved, e, d, n, i)), _bits(saved[i]))


def test_reshard_leaf_refuses_an_uneven_split():
    with pytest.raises(ValueError, match='does not split'):
        reshard_leaf([torch.zeros(6, 5)], None, 1, 2, 0)


# -------------------------------------------------------------------------
# (2) mesh pairs in gloo worlds
# -------------------------------------------------------------------------

def _cat(a, b):
    """Two packed batches as one row: ``a``'s padding a segment of its
    own, ``b``'s the tail; the loss mask, targets and masked tokens
    concatenated, so the row's masked mean is the pair's."""
    T = len(a.tokens)
    cu_a, cu_b = np.unique(a.cu_lens), np.unique(b.cu_lens) + T
    cu = np.concatenate([cu_a, [T] if cu_a[-1] < T else [], cu_b[1:]])
    cu = np.pad(cu, (0, 2 * MAX_SEGMENTS + 3 - len(cu)), mode='edge')
    return SimpleNamespace(
        tokens=np.concatenate([a.tokens, b.tokens]),
        masked_tokens=np.concatenate([a.masked_tokens, b.masked_tokens]),
        mask=np.concatenate([a.mask, b.mask]),
        cu_lens=cu.astype(a.cu_lens.dtype),
        max_len=max(int(a.max_len), int(b.max_len), T - int(cu_a[-1])))


@functools.lru_cache(maxsize=None)
def _rows():
    """The global batch as stacked rows for ``data`` 1 and 2."""
    a, b = (_batch(20 + i, ESM2.alphabet) for i in range(2))
    assert len(a.tokens) == T_BATCH
    return {2: stack_batches([a, b]), 1: stack_batches([_cat(a, b)])}


@functools.lru_cache(maxsize=None)
def _dense_jax():
    """JAX's dense params (numpy copies): init from seed 3, every leaf
    moved by 0.1·N(0, 1) (seed 4)."""
    jcfg = jconfig.esm2_config(**DENSE, dtype='float32')
    jp = jinit(jcfg, jax.random.key(3))
    rng = np.random.default_rng(4)
    jp = jax.tree.map(lambda a: a + jnp.asarray(
        rng.standard_normal(a.shape) * 0.1, a.dtype), jp)
    return jax.tree.map(lambda a: np.array(a), jp)


@functools.lru_cache(maxsize=None)
def _runs():
    """Each run's config, params (the same tensors for every rank),
    LoRA kwargs, trainer options and rows."""
    cfg = tconfig.esm2_config(**DENSE, dtype='float32')
    dense = tio.params_from_jax(_dense_jax(), cfg)
    qcfg = tconfig.esm2_config(**NF4, dtype='float32')
    model = ESM2(config=qcfg, device='cpu', rng=3).quantize('4bit')
    model.add_lora(rank=NF4_RANK, alpha=NF4_RANK, rng=5)
    gen = torch.Generator().manual_seed(6)
    for p in model.params['layers']['attn'].values():
        for ad in p.get('lora', {}).values():
            ad['b'].copy_(torch.randn(ad['b'].shape, generator=gen) * 0.01)
    rows = _rows()
    return {
        'adam': dict(cfg=cfg, params=dense, lora_kwargs={}, opts={},
                     rows=rows),
        'adam8bit': dict(cfg=cfg, params=dense, lora_kwargs={},
                         opts={'optimizer': 'adam8bit'}, rows=rows),
        'nf4_lora': dict(cfg=qcfg, params=model.params,
                         lora_kwargs=dict(model.lora_kwargs),
                         opts={'lora_only': True}, rows=rows),
    }


@functools.lru_cache(maxsize=None)
def _pair(name):
    """The round trip of pair ``name`` for every run: its directory,
    holding ``<run>/<world>_rank<r>.npz`` and the checkpoints."""
    a, b = PAIRS[name]
    out = Path(tempfile.mkdtemp(prefix=f'reshard-{name}-'))
    n = max(int(np.prod(a)), int(np.prod(b)))
    spawn(reshard_rank, n, free_ports(3 * len(RUNS)), (a, b), _runs(),
           str(out), timeout=600)
    return out


def _results(name, run, world):
    shape = PAIRS[name][1 if world == 'b' else 0]
    out = _pair(name) / run
    return [dict(np.load(out / f'{world}_rank{r}.npz'))
            for r in range(int(np.prod(shape)))]


def _parts(name, run, world):
    """A checkpoint's parts (the trainer state of every rank), by rank;
    ``world`` a, b, a2 (the round trip) or a_old, b_old, a2_old."""
    root = _pair(name) / run / world
    (step,) = [p for p in root.iterdir() if p.name.isdigit()]
    return [_load(step / f'rank{r}.pt')
            for r in range(len(list(step.glob('rank*.pt'))))]


def _assert_parts_equal(q, p, accum=True):
    """Part ``q`` is part ``p``, bit for bit: layout, views, step, params
    and optimizer state (tensors byte for byte, scalars and groups equal;
    None in both for a replica), with ``accum`` the open cycle's
    gradients too."""
    assert q.mesh == p.mesh and q.views == p.views and q.step == p.step
    assert (q.params is None) == (p.params is None)
    assert (q.opt_state is None) == (p.opt_state is None)
    if p.params is not None:
        for (k, x), (k2, y) in zip(_named(p.params), _named(q.params)):
            assert k == k2 and x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(_bits(y), _bits(x), k)
    if p.opt_state is not None:
        assert q.opt_state['param_groups'] == p.opt_state['param_groups']
        assert q.opt_state['state'].keys() == p.opt_state['state'].keys()
        for pid, st_p in p.opt_state['state'].items():
            st_q = q.opt_state['state'][pid]
            assert st_q.keys() == st_p.keys()
            for key, v in st_p.items():
                if torch.is_tensor(v):
                    assert st_q[key].dtype == v.dtype, (pid, key)
                    np.testing.assert_array_equal(_bits(st_q[key]), _bits(v))
                else:
                    assert st_q[key] == v, (pid, key)
    if accum:
        assert len(q.accum) == len(p.accum)
        for x, y in zip(p.accum, q.accum):
            np.testing.assert_array_equal(_bits(y), _bits(x))


def _is_replica(part) -> bool:
    mesh = part.mesh
    return any(c for a, c in zip(mesh['axes'], mesh['coords'])
               if a != 'fsdp')


def _group_sums(parts, i):
    """Trained view ``i``'s open-cycle gradient summed over each reduce
    group of the parts' mesh, in coordinate order: one sum per ``fsdp``
    block of a sharded view, one for a replicated view."""
    mesh = parts[0].mesh
    axes, loss = mesh['axes'], mesh['loss_axes']
    path, layer = parts[0].views['trained'][i]
    spec = dict(_named(mesh['specs']))[path]
    by = sorted((tuple(p.mesh['coords']), p) for p in parts)

    def keep(c, free, f=None):
        return all(c[k] == 0 for k, a in enumerate(axes) if a not in free) \
            and (f is None or c[axes.index('fsdp')] == f)
    groups = [[p for c, p in by if keep(c, (*loss, 'fsdp'))]] \
        if spec is None else \
        [[p for c, p in by if keep(c, (*loss, 'fsdp'), f)]
         for f in range(mesh['shape'][axes.index('fsdp')])]
    out = []
    for group in groups:
        acc = None
        for p in group:
            g = p.accum[i]
            acc = g.clone() if acc is None else acc.add_(g)
        out.append(acc)
    return out


@pytest.mark.parametrize('run', RUNS)
def test_round_trip_is_bit_equal(name, run):
    """A -> B -> A: each rank's part of the state restored on A from B's
    parts, B's restored from A's, against A's own part: params, the
    optimizer's state (tensors byte for byte, scalars and groups equal),
    the step; the open cycle's gradients as each reduce group's sum;
    B's restored params, gathered, byte-equal to A's at the cut."""
    a, a2 = _parts(name, run, 'a'), _parts(name, run, 'a2')
    assert len(a) == len(a2) == int(np.prod(PAIRS[name][0]))
    for p, q in zip(a, a2):
        _assert_parts_equal(q, p, accum=False)
        assert p.accum is not None and q.accum is not None
    assert len(a[0].opt_state['state']) == len(a[0].views['optimizer'])
    if run == 'adam8bit':
        assert any(v.dtype == torch.float8_e5m2
                   for v in a[0].opt_state['state'][0].values())
    for i in range(len(a[0].views['trained'])):
        for x, y in zip(_group_sums(a, i), _group_sums(a2, i)):
            np.testing.assert_array_equal(_bits(y), _bits(x))
    cut, restored = _results(name, run, 'a')[0], _results(name, run, 'b')[0]
    assert int(cut['step']) == int(restored['step']) == 3
    for k in (k for k in cut if k.startswith('before.')):
        np.testing.assert_array_equal(_bits(restored[k]), _bits(cut[k]), k)


@pytest.mark.parametrize('run', RUNS)
def test_resumed_step_matches_the_uninterrupted_one(name, run):
    """The fourth micro-step (closing the open cycle) on B after the
    restore against the same micro-step on A without a cut: its loss,
    the gradients its update takes, the params after it; every rank of
    B the same, bit for bit."""
    want = _results(name, run, 'a')[0]
    ranks = _results(name, run, 'b')
    for res in ranks[1:]:
        for k, v in res.items():
            np.testing.assert_array_equal(_bits(v), _bits(ranks[0][k]), k)
    got = ranks[0]
    np.testing.assert_allclose(float(got['loss']), float(want['loss']),
                               rtol=1e-5)
    grads = [k for k in want if k.startswith('grad.')]
    assert grads and sorted(grads) == sorted(
        k for k in got if k.startswith('grad.'))
    for k in grads:
        err = np.abs(got[k] - want[k]).max()
        assert err <= 1e-4 * np.abs(want[k]).max(), (k, err)
    for k in (k for k in want if k.startswith('param.')):
        if want[k].dtype.kind != 'f':
            np.testing.assert_array_equal(got[k], want[k], k)
            continue
        err = np.abs(got[k] - want[k])
        if run == 'adam8bit':
            assert err.max() <= 2 * LR and (err > 1e-4 * LR).mean() <= 1e-3, \
                (k, err.max(), (err > 1e-4 * LR).mean())
        else:
            assert err.max() <= 1e-4 * LR, (k, err.max())


def test_leaves_move_between_layouts(name):
    """The pairs exercise what they are for: on A and B the dims of some
    leaf differ, and with ``fsdp`` 4 on one side some leaf is replicated
    there and sharded on the other."""
    a, b = (_parts(name, 'adam', w)[0] for w in ('a', 'b'))
    assert not (_is_replica(a) or _is_replica(b))
    sa, sb = (dict(_named(p.mesh['specs'])) for p in (a, b))
    moved = [k for k in sa if sa[k] != sb[k]]
    fsdp = {PAIRS[name][0][1], PAIRS[name][1][1]}
    if 4 in fsdp:
        assert any(None in (sa[k], sb[k]) for k in moved), moved
        assert any(None not in (sa[k], sb[k]) for k in moved), moved
        qa, qb = (dict(_named(_parts(name, 'nf4_lora', w)[0].mesh['specs']))
                  for w in ('a', 'b'))
        assert any(qa[k] != qb[k] and None not in (qa[k], qb[k])
                   and '.lora.' in k for k in qa)
    assert a.mesh['shape'] != b.mesh['shape']


@pytest.mark.parametrize('run', RUNS)
def test_replicas_are_bit_equal_before_the_save(name, run):
    """On every rank of A, B and A again, before its save: the ranks of
    its ``fsdp`` coordinate hold the same params and optimizer state, bit
    for bit, so a replica's part can be left to the part at ``data`` and
    ``seq`` 0."""
    for world in ('a', 'b', 'a2'):
        ranks = _results(name, run, world)
        assert all(bool(r['replicas_equal']) for r in ranks), world


@pytest.mark.parametrize('run', RUNS)
def test_replica_parts_hold_no_params(name, run):
    """In every checkpoint of the round trip, the parts at a ``data`` or
    ``seq`` coordinate other than 0 hold no param or optimizer tensor (no
    optimizer state at all), yet their own open cycle's gradients, step,
    layout and views; the others hold all of it. Pairs with a replicated
    axis have such parts, and their files are the smaller."""
    shapes = dict(zip(('a', 'b', 'a2'), (*PAIRS[name], PAIRS[name][0])))
    for world, shape in shapes.items():
        parts = _parts(name, run, world)
        replicas = [p for p in parts if _is_replica(p)]
        assert len(replicas) == len(parts) - shape[1], world
        for p in parts:
            assert p.accum is not None and p.step == 3 and p.views
            assert (p.params is None) == (p.opt_state is None) \
                == _is_replica(p), (world, p.mesh['coords'])
        root = _pair(name) / run / world / '3'
        sizes = [(root / f'rank{r}.pt').stat().st_size
                 for r in range(len(parts))]
        for p, size in zip(parts, sizes):
            if _is_replica(p):
                assert size < min(s for q, s in zip(parts, sizes)
                                  if not _is_replica(q))


@pytest.mark.parametrize('run', RUNS)
def test_old_form_parts_still_restore(name, run):
    """Parts written in the old form, where every rank saved its whole
    part (``a_old``): B restores them, resharded, to the very state it
    restored from the new form (``b_old`` against ``b``), and A restores
    them on its own shape to its saved part (``a2_old`` against ``a``),
    bit for bit in every field."""
    old = _parts(name, run, 'a_old')
    assert all(p.params is not None for p in old)
    for new, ref in (('b_old', 'b'), ('a2_old', 'a')):
        got, want = _parts(name, run, new), _parts(name, run, ref)
        assert len(got) == len(want)
        for q, p in zip(got, want):
            _assert_parts_equal(q, p)


def _jax_mesh(shape):
    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                ('data', 'fsdp', 'seq'))


def test_restore_matches_jax(name):
    """The same pair through JAX: ``ShardedMaskedPLM(grad_accum=2,
    seq_axis='seq')`` on A from the same weights, three micro-steps,
    saved by JAX's ``CheckpointManager``, restored by it into a trainer on
    B; the port's restored params on B (gathered) against JAX's restored
    global arrays, and the loss of the next step on B against JAX's."""
    a, b = PAIRS[name]
    rows = _rows()
    jcfg = jconfig.esm2_config(**DENSE, dtype='float32')

    def trainer(shape):
        model = jesm.ESM2(config=jcfg, params=jax.tree.map(
            jnp.asarray, _dense_jax()))
        return JSharded(model, _jax_mesh(shape), learning_rate=LR,
                        grad_accum=2, seq_axis='seq')
    ja = trainer(a)
    for _ in range(3):
        ja.training_step(rows[a[0]])
    with tempfile.TemporaryDirectory() as tmp:
        mgr = JCheckpoints(tmp, monitor=None)
        mgr.save(3, ja.state)
        jb = trainer(b)
        jb.state = mgr.restore(jb.state)
        restored = jax.tree.map(lambda x: np.array(x), jb.state.params)
        jloss = float(jb.training_step(rows[b[0]]))
    got = _results(name, 'adam', 'b')[0]
    for k, want in _named(restored):
        assert got[f'before.{k}'].shape == want.shape, k
        err = np.abs(got[f'before.{k}'] - want).max()
        assert err <= 2 * LR, (k, err)
    np.testing.assert_allclose(float(got['loss']), jloss, rtol=1e-4)


# -------------------------------------------------------------------------
# (3) refusals
# -------------------------------------------------------------------------

REFUSALS = ('model', 'mask', 'optimizer', 'no_specs', 'setter')


@functools.lru_cache(maxsize=None)
def _refusals():
    out = Path(tempfile.mkdtemp(prefix='reshard-refusals-'))
    run = _runs()['adam']
    other = tconfig.esm2_config(num_layers=2, embed_dim=96,
                                attention_heads=3, dtype='float32')
    spawn(reshard_refusal_rank, 2, free_ports(3), run, other, str(out),
           timeout=300)
    return [dict(np.load(out / f'rank{r}.npz')) for r in range(2)]


@pytest.mark.parametrize('case', REFUSALS)
def test_restore_refuses(case):
    """A state saved on (1, 2, 1) restored on (1, 1, 1) into a trainer
    of another model (width 96), another mask (the token embedding
    frozen), another optimizer (``adam8bit``), or from parts without
    shard dims (saved before a part recorded its layout): each raises
    ``ValueError`` naming why; such parts still restore on their own
    shape, bit for bit; the setter refuses a part of another mesh."""
    ranks = _refusals() if case == 'setter' else _refusals()[:1]
    for res in ranks:
        msg = str(res[case])
        assert msg.startswith('ValueError: '), msg
        assert {'model': 'another model', 'mask': 'embed_tokens',
                'optimizer': 'Adam8bit', 'no_specs': 'records no shard dims',
                'setter': 'CheckpointManager.restore reshards'}[case] in msg
    assert all(bool(res['own_shape_restored']) for res in _refusals())
