"""The mesh at ESM2-15B's head dim and the process groups' timeout, in
gloo worlds of spawned ranks on the CPU.

* ``ShardedMaskedPLM(seq_axis='seq')`` at head dim 128 (ESM2-15B's; the
  context-parallel tests of ``tests/test_torch_cp_train.py`` run 16, 32
  and 64) on the meshes ESM2-15B's training and the context-parallel
  ranks use, ``(1, 4, 1)`` and ``(1, 2, 2)``: ESM2 of 2 layers, width 256,
  2 heads, fp32 (JAX's init from seed 3, every leaf moved by 0.1·N(0,
  1)), one 1,024-token batch. The ranks are
  ``tests/torch_cp_ranks.py:train_rank`` (H9 and H10 run as their plain
  versions here).
* Every group a mesh is built from, and every group ``axes_group``
  makes, takes the world's timeout (``initialize_distributed(...,
  timeout=)``): c10d gives a new group its backend's default otherwise
  (30 minutes for gloo, 10 for NCCL), so a collective hung in a mesh
  axis's group waited that long whatever the world was given.

Gates (each with its reason):
* the loss and every leaf's gradient of one step, fp32, against the
  port's single-device ``MaskedPLM`` on the same batch: the loss 1e-5
  relative, per leaf max|Δ| <= 1e-4 · max|g| (``tests/test_torch_
  cp_train.py``'s gate against JAX's: the same fp32 function summed in
  another order); every rank holds the same gradients and gathered
  params, bit for bit (each rank's copy of the same reductions).
* the first step's loss against JAX's ``ShardedMaskedPLM`` on a virtual
  4-device CPU mesh of the same shape, at rtol 1e-4, the gate of JAX's own
  tests (``tests/test_distributed.py:53-70``). Only the first: JAX's update
  is a multiple of the gradient (ROADMAP.md Queue 3, item 17).
* the timeout: a sum over a group whose other rank never joins fails
  after about the world's timeout (10 s), well inside the 60 s its silent
  partner stays.
"""

import multiprocessing
import socket

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from esme_tpu.models import config as jconfig
from esme_tpu.models import esm as jesm
from esme_tpu.models.init import init_params as jinit
from esme_tpu.train.distributed import ShardedMaskedPLM as JSharded

from esme_tpu_torch import ESM2
from esme_tpu_torch.models import config as tconfig
from esme_tpu_torch.models import io as tio
from esme_tpu_torch.train import MaskedPLM, stack_batches

from test_torch_cp_train import _batch
from torch_cp_ranks import _flat, silent_peer_rank, train_rank

DIMS = dict(num_layers=2, embed_dim=256, attention_heads=2)


def _port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _spawn(target, n, *args, timeout):
    """``n`` spawned ranks of ``target(rank, n, port, *args)``; every one
    joined within ``timeout`` seconds (or killed). Returns the exit
    codes."""
    ctx = multiprocessing.get_context('spawn')
    port = _port()
    procs = [ctx.Process(target=target, args=(r, n, port, *args))
             for r in range(n)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    return [p.exitcode for p in procs]


def _jax_params(jcfg):
    jp = jinit(jcfg, jax.random.key(3))
    rng = np.random.default_rng(4)
    return jax.tree.map(lambda a: a + jnp.asarray(
        rng.standard_normal(a.shape) * 0.1, a.dtype), jp)


@pytest.mark.parametrize('shape', [(1, 4, 1), (1, 2, 2)])
def test_sharded_head_dim_128_matches_masked_plm(shape, tmp_path):
    """Four gloo ranks of ``ShardedMaskedPLM(seq_axis='seq')`` on
    ``shape`` at D = 128: one step's loss and every leaf's gradient (the
    same on every rank) against the single-device ``MaskedPLM``'s, the
    gathered params after two steps the same on every rank, and the first
    step's loss against JAX's ``ShardedMaskedPLM`` on a mesh of the same
    shape."""
    jcfg = jconfig.esm2_config(**DIMS, dtype='float32')
    tcfg = tconfig.esm2_config(**DIMS, dtype='float32')
    assert tcfg.embed_dim // tcfg.attention_heads == 128
    jp = _jax_params(jcfg)
    params = tio.params_from_jax(jax.tree.map(np.array, jp), tcfg)
    batch = _batch(7, ESM2.alphabet)
    n = int(np.prod(shape))
    codes = _spawn(train_rank, n, shape, 'esm2', tcfg, params,
                   stack_batches([batch]), False, tmp_path, timeout=300)
    assert codes == [0] * n
    ranks = [dict(np.load(tmp_path / f'rank{r}.npz')) for r in range(n)]

    model = ESM2(config=tcfg, params=params, device='cpu')
    loss, grads = MaskedPLM(model)._grad_step(batch)
    want = _flat(grads)
    for res in ranks:
        np.testing.assert_allclose(float(res['loss']), loss.item(),
                                   rtol=1e-5)
        for name in want:
            np.testing.assert_array_equal(res[f'grad.{name}'],
                                          ranks[0][f'grad.{name}'])
            np.testing.assert_array_equal(res[f'param.{name}'],
                                          ranks[0][f'param.{name}'])
    for name, ref in want.items():
        err = np.abs(ranks[0][f'grad.{name}'] - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), (name, err)

    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                ('data', 'fsdp', 'seq'))
    jmodel = jesm.ESM2(config=jcfg, params=jax.tree.map(jnp.copy, jp))
    jt = JSharded(jmodel, mesh, learning_rate=1e-3, seq_axis='seq')
    jloss = jt.training_step(stack_batches([batch]))
    np.testing.assert_allclose(ranks[0]['losses'][0], jloss, rtol=1e-4)


def test_mesh_groups_take_the_world_timeout(tmp_path):
    """A gloo world of four given a 10 s timeout, on a (1, 2, 2) mesh: a
    sum over the mesh's ``seq`` group and one over an ``axes_group``,
    each of whose other rank stays silent for a minute, fail after about
    10 s (``tests/torch_cp_ranks.py:silent_peer_rank``)."""
    timeout_s = 10
    codes = _spawn(silent_peer_rank, 4, timeout_s, str(tmp_path),
                   timeout=120)
    assert codes == [0] * 4
    for r in (0, 2):
        took = float(np.load(tmp_path / f'rank{r}.npz')['seconds'])
        assert timeout_s / 2 <= took <= 3 * timeout_s, (r, took)
