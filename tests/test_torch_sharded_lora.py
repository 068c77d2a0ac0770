"""LoRA, trainable masks and quantized trunks over a mesh: the port's
``fsdp_partition_specs`` of LoRA + int8 and LoRA + NF4 trees against
JAX's, and ranks of ``ShardedMaskedPLM`` with adapters in gloo worlds
against the single-device JAX gradient over the trainable leaves and
against JAX's ``ShardedMaskedPLM`` on a mesh of the same shape
(``tests/conftest.py`` gives JAX 8 CPU devices).

The model is ESM2 at width 256, 2 layers, 4 heads, fp32 (JAX's init from
seed 3, every leaf moved by 0.1·N(0, 1)), with LoRA rank 64 on query,
value and output whose ``b`` is lifted to 0.01·N(0, 1): at that size the
adapters' ``a`` and ``b`` and every projection's ``qvalue`` are sharded
over ``fsdp`` (the spec test asserts it), their ``scale`` leaves and NF4's
``outlier_idx`` replicated. The port's ranks are processes of their own
(``tests/torch_cp_ranks.py:lora_rank``, which imports no JAX), spawned
into a gloo group on 127.0.0.1; every kernel runs as its plain version.

The worlds, ``(data, fsdp, seq)``:
* ``dense``: (2, 2, 1), ``lora_only=True, train_lmhead=True`` (the LM
  head's leaves train beside the adapters, sharded and replicated); a
  model whose ``dropout_p`` is 0.1 gives the loss of ``dropout_p`` 0,
  bit for bit: no LoRA dropout over a mesh, as JAX's class (ROADMAP.md
  Queue 3, item 26);
* ``8bit``: (1, 2, 2) over an int8 trunk with ``seq_axis='seq'`` (H9 and
  H10's plain versions);
* ``4bit``: (1, 2, 2) over an NF4 trunk without ``seq_axis`` (the seq
  axis holds replicas), a hand-written ``trainable_mask``: the adapters,
  the layers' attention LayerNorm and the embedding LayerNorm, so that
  replicated leaves train; and a checkpoint round trip: every rank saves
  its part with ``CheckpointManager`` after two steps, a fresh trainer on
  each rank restores it, and its next step is the uninterrupted one; the
  same with ``grad_accum=2`` cut inside the first cycle.

Gates (each with its reason):
* the shard dims: exact (the rule reads shapes only).
* the loss and gradients of one step, fp32: per trainable leaf max|Δ| <=
  1e-4 · max|g| and the loss 1e-5 relative against JAX's single-device
  ``jax.value_and_grad`` of the global masked mean over the trainable
  leaves (``tests/test_torch_cp_train.py``'s gate: the same fp32 function
  summed in another order); the same leaves train on both sides.
* every rank: the same gradients, losses and gathered params, bit for
  bit (each rank's copy of the same reductions).
* frozen and quantized leaves after two updates: bit-unchanged with their
  dtypes; no frozen view requires or holds a gradient; the optimizer's
  state is the trained shards' two Adam moments exactly, byte for byte.
* two steps' losses against JAX's ``ShardedMaskedPLM`` at rtol 1e-4, the
  gate of JAX's own tests (``tests/test_distributed.py:53-70``): JAX's
  update is a multiple of the gradient (ROADMAP.md Queue 3, item 17),
  which Adam's first step hides.
* the resumed step: loss and every gathered param bit-equal to the
  uninterrupted third step.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from esme_tpu.models import config as jconfig
from esme_tpu.models import esm as jesm
from esme_tpu.models.init import init_params as jinit
from esme_tpu.parallel import fsdp as jfsdp
from esme_tpu.train.distributed import ShardedMaskedPLM as JSharded
from esme_tpu.train.partition import merge_leaves, split_by_mask

from esme_tpu_torch import ESM2
from esme_tpu_torch.models import config as tconfig
from esme_tpu_torch.models import io as tio
from esme_tpu_torch.parallel import fsdp as tfsdp
from esme_tpu_torch.train import stack_batches

from test_torch_cp_train import T_BATCH, _Mesh, _batch, _run
from torch_cp_ranks import lora_rank

DIMS = dict(num_layers=2, embed_dim=256, attention_heads=4)
RANK = 64


def _configs():
    return (jconfig.esm2_config(**DIMS, dtype='float32'),
            tconfig.esm2_config(**DIMS, dtype='float32'))


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


@functools.lru_cache(maxsize=None)
def _model(quant):
    """The JAX model's params (numpy, copies) and ``lora_kwargs``: init
    from seed 3, every leaf moved by 0.1·N(0, 1) (seed 4), quantized to
    ``quant`` (None: dense), adapters of rank 64 from seed 5 with ``b``
    lifted to 0.01·N(0, 1) (seed 6)."""
    jcfg, _ = _configs()
    jp = jinit(jcfg, jax.random.key(3))
    rng = np.random.default_rng(4)
    jp = jax.tree.map(lambda a: a + jnp.asarray(
        rng.standard_normal(a.shape) * 0.1, a.dtype), jp)
    jm = jesm.ESM2(config=jcfg, params=jp)
    if quant:
        jm.quantize(quant)
    jm.add_lora(rank=RANK, alpha=RANK, rng=5)
    params = _np_tree(jm.params)
    rng = np.random.default_rng(6)
    for p in params['layers']['attn'].values():
        for ad in p.get('lora', {}).values():
            ad['b'] = (rng.standard_normal(ad['b'].shape) * 0.01).astype(
                ad['b'].dtype)
    return params, dict(jm.lora_kwargs)


def _paths(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, path + (k,))
        else:
            yield '.'.join(path + (k,)), v


def _at(tree, path):
    for k in path.split('.'):
        tree = tree[k]
    return tree


# -------------------------------------------------------------------------
# (1) the shard specs
# -------------------------------------------------------------------------

@pytest.mark.parametrize('quant', ['8bit', '4bit'])
@pytest.mark.parametrize('fsdp', [2, 4])
def test_lora_quant_shard_specs_match_jax(quant, fsdp):
    """Every leaf's shard dim of a LoRA tree over an int8 or NF4 trunk
    against the dim JAX's ``fsdp_partition_specs`` names ``fsdp`` on a
    ``(1, fsdp)`` mesh; at least one adapter leaf and one ``qvalue`` are
    sharded, and the adapters' and quantization's scales replicated."""
    jp, _ = _model(quant)
    mesh = Mesh(np.asarray(jax.devices()[:fsdp]).reshape(1, fsdp),
                ('data', 'fsdp'))
    want = jfsdp.fsdp_partition_specs(jp, mesh)
    _, tcfg = _configs()
    got = tfsdp.fsdp_partition_specs(tio.params_from_jax(jp, tcfg),
                                     _Mesh(fsdp))
    flat = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    assert len(flat) == len(list(_paths(got)))
    sharded = []
    for path, spec in flat:
        name = '.'.join(k.key for k in path)
        dims = [i for i, a in enumerate(tuple(spec)) if a == 'fsdp']
        assert _at(got, name) == (dims[0] if dims else None), (name, spec)
        if dims:
            sharded.append(name)
    assert any('.lora.' in n and n[-2:] in ('.a', '.b') for n in sharded)
    assert any(n.endswith('.qvalue') for n in sharded)
    assert not any(n.endswith('.scale') and ('.lora.' in n or n.startswith(
        'layers.')) for n in sharded)


# -------------------------------------------------------------------------
# (2) the sharded LoRA trainer in gloo worlds
# -------------------------------------------------------------------------

WORLDS = {
    'dense': ((2, 2, 1), None, dict(lora_only=True, train_lmhead=True,
                                    dropout=0.1)),
    '8bit': ((1, 2, 2), '8bit', dict(seq_axis='seq', lora_only=True)),
    '4bit': ((1, 2, 2), '4bit', dict(mask=True, resume=True)),
}


def _hand_mask(jm):
    """The adapters (JAX's ``lora_only`` filter), every layer's attention
    LayerNorm and the embedding LayerNorm: a tree of Python bools."""
    mask = jax.tree.map(bool, jm.trainable_filter(lora_only=True))
    for leaf in ('scale', 'bias'):
        mask['layers']['attn']['norm'][leaf] = True
        mask['emb_norm_after'][leaf] = True
    return mask


def _jax_grads(jcfg, params, mask, batches):
    """JAX's single-device loss and gradients of the global masked mean
    over the batches, over the leaves ``mask`` trains, by name."""
    train, frozen, treedef, flags = split_by_mask(params, mask)

    def loss(train):
        p = merge_leaves(train, frozen, treedef, flags)
        s = c = 0.0
        for b in batches:
            seg, pos = jesm.packed_meta(jnp.asarray(b.cu_lens), T_BATCH)
            logits = jesm.forward_flat(p, jcfg, jnp.asarray(b.masked_tokens),
                                       seg, pos)
            logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
            ll = jnp.take_along_axis(logp, jnp.asarray(b.tokens)[:, None],
                                     axis=-1)[:, 0]
            w = jnp.asarray(b.mask, jnp.float32)
            s, c = s + (ll * w).sum(), c + w.sum()
        return -s / jnp.maximum(c, 1.0)
    value, grads = jax.value_and_grad(loss)(train)
    names = [jax.tree_util.keystr(p, simple=True, separator='.') for p, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    names = [n for n, f in zip(names, flags) if f]
    return float(value), dict(zip(names, map(np.asarray, grads)))


@pytest.mark.parametrize('world', list(WORLDS))
def test_sharded_lora_matches_jax(world, tmp_path):
    """The ranks of a world run ``ShardedMaskedPLM`` with adapters on R =
    data batches of 1,024 tokens: one step's loss and the trainable
    leaves' gradients against JAX's single-device gradient; two steps'
    losses against JAX's ``ShardedMaskedPLM`` on the same mesh; every rank
    bit-equal; frozen and quantized leaves bit-unchanged with their
    dtypes, without gradients and without optimizer state; the world's
    own check (dropout ignored; the checkpoint round trip)."""
    shape, quant, opts = WORLDS[world]
    jp, kw = _model(quant)
    jcfg, tcfg = _configs()
    jm = jesm.ESM2(config=jcfg, params=jax.tree.map(jnp.asarray, jp))
    jm.lora_kwargs = dict(kw)
    mask = _hand_mask(jm) if opts.get('mask') else jm.trainable_filter(
        lora_only=opts['lora_only'],
        train_lmhead=opts.get('train_lmhead', False))
    rank_opts = {k: v for k, v in opts.items() if k != 'mask'}
    if opts.get('mask'):
        rank_opts['trainable_mask'] = mask
    batches = [_batch(10 * i + shape[2], ESM2.alphabet)
               for i in range(shape[0])]
    n = int(np.prod(shape))
    ranks = _run(lora_rank, n, shape, tcfg, tio.params_from_jax(jp, tcfg),
                 kw, stack_batches(batches), rank_opts, out=tmp_path,
                 timeout=300)

    jloss, jgrads = _jax_grads(jcfg, jm.params, mask, batches)
    trained = sorted(jgrads)
    assert sorted(ranks[0]['trained']) == trained
    assert any('.lora.' in k for k in trained)
    for res in ranks:
        np.testing.assert_allclose(float(res['loss']), jloss, rtol=1e-5)
        for key in res:
            np.testing.assert_array_equal(res[key], ranks[0][key], key)
    res = ranks[0]
    for name, ref in jgrads.items():
        g = res[f'grad.{name}']
        assert g.shape == ref.shape, name
        err = np.abs(g - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), (name, err)
    for name, p0 in _paths(jp):
        p = res[f'param.{name}']
        assert p.dtype == p0.dtype and p.shape == p0.shape, name
        if name in jgrads:
            assert not np.array_equal(p, p0), name
        else:
            np.testing.assert_array_equal(p, p0, name)
    assert not res['frozen_grads'].any()
    assert int(res['opt_tensors']) > 0
    assert int(res['opt_bytes']) == int(res['moment_bytes'])
    if quant:
        assert any(name.endswith('.qvalue') and name not in jgrads
                   for name, _ in _paths(jp))

    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                ('data', 'fsdp', 'seq'))
    jt = JSharded(jm, mesh, learning_rate=1e-3,
                  seq_axis=opts.get('seq_axis'), trainable_mask=mask)
    jlosses = [jt.training_step(stack_batches(batches)) for _ in range(2)]
    np.testing.assert_allclose(res['losses'], jlosses, rtol=1e-4)
    assert res['losses'][1] < res['losses'][0]

    if 'dropout' in opts:
        assert res['dropout_loss'] == res['loss']
    if opts.get('resume'):
        assert int(res['resume.step']) == 2
        assert res['resume.steps'].tolist() == [2]
        assert res['resume.fresh_loss'] == res['resume.loss']
        for name, _ in _paths(jp):
            for tag in ('resume', 'resume.accum'):
                np.testing.assert_array_equal(
                    res[f'{tag}.fresh.param.{name}'],
                    res[f'{tag}.param.{name}'], name)
        assert not np.array_equal(res[f'resume.accum.param.{trained[0]}'],
                                  _at(jp, trained[0]))
        assert sorted(p.name for p in (tmp_path / 'ckpt' / '2').iterdir()) \
            == ['metrics.json'] + [f'rank{r}.pt' for r in range(n)]
