"""The ranks of the port's context-parallel tests
(``tests/test_torch_context.py``, ``tests/test_torch_cp_train.py``,
``tests/test_torch_memory.py``, ``tests/test_torch_sharded_lora.py``,
``tests/test_torch_reshard.py``): each
runs in a process of its own, spawned by the test, and joins a gloo group
of ``n`` ranks on ``127.0.0.1``. This module imports neither JAX nor the JAX package, so
that a spawned rank loads only the port."""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from esme_tpu_torch.models.esm import ESM1b, ESM1v, ESM2, ESMC, packed_meta
from esme_tpu_torch.ops import flash
from esme_tpu_torch.parallel import (context_parallel_log_prob,
                                     forward_flat_cp, initialize_distributed,
                                     make_kv_gather, make_mesh)
from esme_tpu_torch.parallel.fsdp import gather_dim
from esme_tpu_torch.train import CheckpointManager, ShardedMaskedPLM, adam8bit
from esme_tpu_torch.train.distributed import ShardedTrainState
from esme_tpu_torch.train.trainer import _grad_tree, _leaves as _tensors

CLASSES = {'esm2': ESM2, 'esmc': ESMC, 'esm1b': ESM1b, 'esm1v': ESM1v}
IMPLS = ('flash', 'reference')


def cp_rank(rank, n, port, family, cfg, params, tokens, cu, max_len, out):
    """Rank ``rank`` of ``n``: ``context_parallel_log_prob`` (every
    rank's gathered ``(T, V)``), its own rows of ``forward_flat_cp`` over
    the padded batch on both attention routes, and whether
    ``forward_flat_cp`` refuses a token count the axis does not divide;
    written to ``out``/rank<r>.npz."""
    torch.set_num_threads(1)
    initialize_distributed(f'127.0.0.1:{port}', n, rank, device='cpu')
    try:
        mesh = make_mesh(seq=n, device='cpu')
        model = CLASSES[family](config=cfg, params=params, device='cpu')
        res = {'gathered': context_parallel_log_prob(
            model, tokens, (cu, max_len), mesh).numpy()}
        tok = torch.as_tensor(tokens, dtype=torch.int32)
        T = tok.shape[0]
        pad = (-T) % n
        tok = torch.cat([tok, tok.new_full((pad,), cfg.padding_idx)])
        seg, pos = packed_meta(torch.as_tensor(cu, dtype=torch.int32),
                               T + pad)
        with torch.inference_mode():
            for impl in IMPLS:
                res[impl] = forward_flat_cp(
                    model.params, cfg, tok, seg, pos, mesh=mesh,
                    log_prob=True, attn_impl=impl).numpy()
        try:
            forward_flat_cp(model.params, cfg, tok[:-1], seg[:-1],
                            pos[:-1], mesh=mesh)
            res['refused'] = np.array(False)
        except ValueError as e:
            res['refused'] = np.array('not divisible' in str(e))
        np.savez(f'{out}/rank{rank}.npz', **res)
    finally:
        dist.destroy_process_group()


def train_rank(rank, n, port, mesh_shape, family, cfg, params, batches,
               checkpointing, out):
    """Rank ``rank`` of a ``(data, fsdp, seq)`` world of ``n`` ranks:
    ``ShardedMaskedPLM(seq_axis='seq')``'s loss and full gradients of one
    step without an update (``_grad_step``), then the losses of two
    ``training_step``s, the params gathered back from the shards after
    them, and the checks that its constructor and step refuse what they
    must (an axis the mesh lacks, a token count the seq axis does not
    divide, an optimizer that is not a factory); written to ``out``/rank<r>.npz (the gradients under
    ``grad.<leaf>``, the params under ``param.<leaf>``)."""
    torch.set_num_threads(1)
    initialize_distributed(f'127.0.0.1:{port}', n, rank, device='cpu')
    try:
        data, fsdp, seq = mesh_shape
        mesh = make_mesh(data, fsdp, seq=seq, device='cpu')
        model = CLASSES[family](config=cfg, params=params, device='cpu',
                                checkpointing=checkpointing)
        plm = ShardedMaskedPLM(model, mesh, learning_rate=1e-3,
                               seq_axis='seq')
        loss, grads = plm._grad_step(batches)
        res = {'loss': loss.numpy()}
        res.update({f'grad.{k}': v for k, v in _flat(grads).items()})
        res['losses'] = np.array([plm.training_step(batches)
                                  for _ in range(2)])
        res['val'] = np.array(plm.validation_step(batches))
        res.update({f'param.{k}': v
                    for k, v in _flat(plm.unsharded_params()).items()})
        refused = []
        try:
            ShardedMaskedPLM(model, mesh, seq_axis='sequence')
        except ValueError as e:
            refused.append('no axis' in str(e))
        masked, tokens, mask, cu_lens, max_len = batches
        cut = (masked[:, :-1], tokens[:, :-1], mask[:, :-1], cu_lens,
               max_len)
        try:
            plm.training_step(cut)
        except ValueError as e:
            refused.append(seq == 1 or 'not divisible' in str(e))
        else:
            refused.append(seq == 1)
        try:          # an optimizer is a factory of param groups
            ShardedMaskedPLM(model, mesh, optimizer=object())
        except TypeError as e:
            refused.append('factory' in str(e))
        res['refused'] = np.array(refused)
        np.savez(f'{out}/rank{rank}.npz', **res)
    finally:
        dist.destroy_process_group()


def _flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, path + (k,)))
        else:
            out['.'.join(path + (k,))] = v.detach().float().numpy()
    return out


def gather_rank(rank, n, port, k, v, dk, dv, out):
    """Rank ``rank`` of ``n``: ``make_kv_gather`` over its rows of ``k``,
    ``v`` (``(T, H, D)``) and of a ramp of ids, and the gradients of
    ``<k_full, dk[rank]> + <v_full, dv[rank]>`` with respect to its rows
    (``dk``, ``dv``: ``(n, T, H, D)``, a cotangent per rank); written to
    ``out``/rank<r>.npz."""
    torch.set_num_threads(1)
    initialize_distributed(f'127.0.0.1:{port}', n, rank, device='cpu')
    try:
        mesh = make_mesh(seq=n, device='cpu')
        lo, hi = rank * k.shape[0] // n, (rank + 1) * k.shape[0] // n
        kr, vr = (torch.from_numpy(x[lo:hi]).requires_grad_() for x in (k, v))
        ids = torch.arange(lo, hi, dtype=torch.int32)
        kf, vf, sf = make_kv_gather(mesh['seq'])(kr, vr, ids)
        ((kf * torch.from_numpy(dk[rank])).sum()
         + (vf * torch.from_numpy(dv[rank])).sum()).backward()
        np.savez(f'{out}/rank{rank}.npz', k=kf.detach().numpy(),
                 ids=sf.numpy(), dk=kr.grad.numpy(), dv=vr.grad.numpy())
    finally:
        dist.destroy_process_group()


def fit_rank(rank, n, port, mesh_shape, cfg, params, batches, out):
    """Rank ``rank`` of a ``(data, fsdp, seq)`` world: ``fit`` of
    ``ShardedMaskedPLM(seq_axis='seq', grad_accum=2, weight_decay=0.05)``
    (AdamW, one update every two micro-batches) over ``batches`` (a list
    of steps, each the R batches of one step) with the first step as the
    validation set, logged to a list; written to ``out``/rank<r>.npz (the
    losses, the validation loss, the params gathered back from the
    shards)."""
    torch.set_num_threads(1)
    initialize_distributed(f'127.0.0.1:{port}', n, rank, device='cpu')
    try:
        data, fsdp, seq = mesh_shape
        mesh = make_mesh(data, fsdp, seq=seq, device='cpu')
        model = ESM2(config=cfg, params=params, device='cpu')
        plm = ShardedMaskedPLM(model, mesh, learning_rate=1e-3,
                               weight_decay=0.05, grad_accum=2,
                               seq_axis='seq')

        class Log:
            def __init__(self):
                self.lines = []

            def log(self, record, step):
                self.lines.append((step, record))

            def track_best(self, record):
                pass
        log = Log()
        history = plm.fit(batches, val_dataset=batches[:1], log_every=1,
                          logger=log)
        res = {'history': np.array(history), 'step': np.array(plm.step),
               'val': np.array([r['val_loss'] for _, r in log.lines
                                if 'val_loss' in r])}
        res.update({f'param.{k}': v
                    for k, v in _flat(plm.unsharded_params()).items()})
        np.savez(f'{out}/rank{rank}.npz', **res)
    finally:
        dist.destroy_process_group()


def remat_rank(rank, n, port, mesh_shape, family, cfg, params, batches, out):
    """Rank ``rank`` of a ``(data, fsdp, seq)`` world: the loss and full
    gradients of one ``_grad_step`` of ``ShardedMaskedPLM(seq_axis='seq')``
    with checkpointing, under ``remat='full'`` and ``remat='attn'``, and
    how many times each called ``flash.segment_flash_fwd`` with the keys'
    own ids (H9's wrapper, looked up by ``_FlashRect`` at call time);
    written to ``out``/rank<r>.npz (``<remat>.grad.<leaf>``,
    ``<remat>.loss``, ``<remat>.calls``)."""
    torch.set_num_threads(1)
    initialize_distributed(f'127.0.0.1:{port}', n, rank, device='cpu')
    fwd = flash.segment_flash_fwd
    calls = [0]

    def counted(*args, **kw):
        calls[0] += kw.get('seg_k') is not None
        return fwd(*args, **kw)
    flash.segment_flash_fwd = counted
    try:
        data, fsdp, seq = mesh_shape
        mesh = make_mesh(data, fsdp, seq=seq, device='cpu')
        res = {}
        for remat in ('full', 'attn'):
            model = CLASSES[family](config=cfg, params=params, device='cpu',
                                    checkpointing=True)
            plm = ShardedMaskedPLM(model, mesh, seq_axis='seq', remat=remat)
            calls[0] = 0
            loss, grads = plm._grad_step(batches)
            res[f'{remat}.calls'] = np.array(calls[0])
            res[f'{remat}.loss'] = loss.numpy()
            res.update({f'{remat}.grad.{k}': v
                        for k, v in _flat(grads).items()})
        np.savez(f'{out}/rank{rank}.npz', **res)
    finally:
        flash.segment_flash_fwd = fwd
        dist.destroy_process_group()


def adam8bit_rank(rank, n, port, mesh_shape, cfg, params, batches, out):
    """Rank ``rank`` of a ``(data, fsdp, seq)`` world: three steps of
    ``ShardedMaskedPLM(optimizer=adam8bit(1e-3))``; written to
    ``out``/rank<r>.npz (the losses, the params gathered back, the state's
    code dtypes and this rank's scales, one per leaf)."""
    torch.set_num_threads(1)
    initialize_distributed(f'127.0.0.1:{port}', n, rank, device='cpu')
    try:
        data, fsdp, seq = mesh_shape
        mesh = make_mesh(data, fsdp, seq=seq, device='cpu')
        model = ESM2(config=cfg, params=params, device='cpu')
        plm = ShardedMaskedPLM(model, mesh, optimizer=adam8bit(1e-3),
                               seq_axis='seq')
        res = {'losses': np.array([plm.training_step(batches)
                                   for _ in range(3)])}
        opt = plm.optimizer
        res['scales'] = np.array([
            [float(opt.state[g['params'][0]][k]) for k in ('mu_scale',
                                                           'nu_scale')]
            for g in opt.param_groups])
        res['f8'] = np.array([opt.state[p][k].dtype == torch.float8_e5m2
                              for g in opt.param_groups for p in g['params']
                              for k in ('mu', 'nu')])
        res.update({f'param.{k}': v
                    for k, v in _flat(plm.unsharded_params()).items()})
        np.savez(f'{out}/rank{rank}.npz', **res)
    finally:
        dist.destroy_process_group()


def _named(tree, path=()):
    """``(dotted path, tensor)`` for every leaf of ``tree``."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, path + (k,))
        else:
            yield '.'.join(path + (k,)), v


def lora_rank(rank, n, port, mesh_shape, cfg, params, lora_kwargs, batches,
              opts, out):
    """Rank ``rank`` of a ``(data, fsdp, seq)`` world: ``ShardedMaskedPLM``
    over a model with LoRA adapters (``lora_kwargs``; a dense or quantized
    trunk), with ``opts``' ``seq_axis``, ``lora_only``, ``train_lmhead``
    and ``trainable_mask``. Writes to ``out``/rank<r>.npz: the loss and
    the trainable leaves' gradients of one ``_grad_step``
    (``grad.<leaf>``); the losses of two ``training_step``s; the params
    gathered back after them (``param.<leaf>``, their own dtypes); the
    trained leaves' paths (``trained``), whether a frozen view has a
    ``.grad`` or requires one (``frozen_grads``), the optimizer's state
    tensors, their bytes and the bytes of the trained shards' two
    moments; with ``opts['dropout']``, the loss of a ``_grad_step`` of the
    same model with ``dropout_p`` set to it (``dropout_loss``); with
    ``opts['resume']``, a checkpoint of the state after the two steps in
    ``out``/ckpt, a third step, and the same third step of a fresh trainer
    that restored the checkpoint (``resume.*``); and with ``grad_accum=2``
    a checkpoint inside the first cycle, the update that ends it, and the
    same update of a fresh trainer that restored it
    (``resume.accum.*``)."""
    torch.set_num_threads(1)
    initialize_distributed(f'127.0.0.1:{port}', n, rank, device='cpu')
    try:
        data, fsdp, seq = mesh_shape
        mesh = make_mesh(data, fsdp, seq=seq, device='cpu')
        model = ESM2(config=cfg, params=params, device='cpu')
        model.lora_kwargs = dict(lora_kwargs)
        kw = {k: opts[k] for k in ('seq_axis', 'lora_only', 'train_lmhead',
                                   'trainable_mask') if k in opts}

        def trainer(**extra):
            return ShardedMaskedPLM(model, mesh, learning_rate=1e-3, **kw,
                                    **extra)
        plm = trainer()
        loss, grads = plm._grad_step(batches)
        res = {'loss': loss.numpy()}
        res.update({f'grad.{k}': v.numpy()
                    for k, v in _named(grads) if v is not None})
        res['losses'] = np.array([plm.training_step(batches)
                                  for _ in range(2)])
        res.update({f'param.{k}': v.numpy()
                    for k, v in _named(plm.unsharded_params())})
        views = list(_tensors(plm._views))
        res['frozen_grads'] = np.array([
            t.requires_grad or t.grad is not None for t in views
            if not any(t is u for u in plm._trained)])
        res['trained'] = np.array([
            k for k, v in _named(grads) if v is not None])
        opt = plm.optimizer
        res['opt_tensors'] = np.array(sum(
            torch.is_tensor(v) and v.dim() > 0
            for st in opt.state.values() for v in st.values()))
        res['opt_bytes'] = np.array(sum(
            v.numel() * v.element_size() for st in opt.state.values()
            for v in st.values() if torch.is_tensor(v) and v.dim() > 0))
        res['moment_bytes'] = np.array(sum(
            2 * t.numel() * t.element_size() for t in plm._trained))
        if opts.get('dropout'):
            model.lora_kwargs['dropout_p'] = opts['dropout']
            res['dropout_loss'] = trainer()._grad_step(batches)[0].numpy()
            model.lora_kwargs = dict(lora_kwargs)
        if opts.get('resume'):
            mgr = CheckpointManager(f'{out}/ckpt', monitor=None)
            mgr.save(plm.step, plm.state)
            res['resume.loss'] = np.array(plm.training_step(batches))
            fresh = trainer()
            fresh.state = mgr.restore(fresh.state)
            res['resume.step'] = np.array(fresh.step)
            res['resume.fresh_loss'] = np.array(fresh.training_step(batches))
            res['resume.steps'] = np.array(mgr.all_steps())
            for tag, t in (('', plm), ('fresh.', fresh)):
                res.update({f'resume.{tag}param.{k}': v.numpy()
                            for k, v in _named(t.unsharded_params())})
            # inside a grad_accum cycle: the gradients gathered so far
            # are part of the state
            mgr = CheckpointManager(f'{out}/ckpt_accum', monitor=None)
            cut = trainer(grad_accum=2)
            cut.training_step(batches)
            mgr.save(cut.step, cut.state)
            cut.training_step(batches)
            fresh = trainer(grad_accum=2)
            fresh.state = mgr.restore(fresh.state)
            fresh.training_step(batches)
            for tag, t in (('', cut), ('fresh.', fresh)):
                res.update({f'resume.accum.{tag}param.{k}': v.numpy()
                            for k, v in _named(t.unsharded_params())})
        np.savez(f'{out}/rank{rank}.npz', **res)
    finally:
        dist.destroy_process_group()


def _capture_update(plm, res):
    """Wrap ``plm``'s optimizer so that its next update first writes the
    gradients it takes into ``res`` (``grad.<leaf>``, gathered over
    ``fsdp``; every rank calls the gathers in the same order)."""
    step = plm.optimizer.step
    specs = dict(_named(plm.specs))

    def wrapped(*args, **kw):
        for name, g in _named(_grad_tree(plm._views)):
            if g is not None:
                d = specs[name]
                res[f'grad.{name}'] = (g if d is None else gather_dim(
                    g, d, plm._fsdp_group)).numpy()
        return step(*args, **kw)
    plm.optimizer.step = wrapped


def reshard_rank(rank, n, ports, pair, runs, out):
    """Rank ``rank`` of the worlds of a reshard round trip, one process
    for every world of ``pair`` (the ``(data, fsdp, seq)`` shapes A and
    B): for each run of ``runs`` (name -> config, params, LoRA kwargs,
    trainer options, the global batch as stacked rows for each ``data``
    size), three worlds one after another, each on a port of ``ports``
    (a rank outside a world skips it):

    * A: ``ShardedMaskedPLM(grad_accum=2, seq_axis='seq')`` takes three
      micro-steps (one update, then a cycle left open) and every rank
      saves its part to ``out/<run>/a``; then the fourth micro-step,
      which closes the cycle;
    * B: a fresh trainer restores ``a`` (resharded), saves its part to
      ``out/<run>/b`` and takes the fourth micro-step;
    * A again: a fresh trainer restores ``b`` and saves to
      ``out/<run>/a2``.

    Beside ``a``, every rank of A also writes its whole part as the
    manager wrote it before replicas left their params and optimizer
    state out (``out/<run>/a_old``); on B and on A again a second fresh
    trainer restores ``a_old`` and saves to ``b_old`` and ``a2_old``.

    Written to ``out/<run>/<world>_rank<r>.npz``: the losses, the params
    gathered before the fourth micro-step (``before.<leaf>``, on B the
    restored ones) and after it (``param.<leaf>``), the gradients its
    update took (``grad.<leaf>``), the step, and whether before each save
    the replicas' params and optimizer state were bit-equal
    (``replicas_equal``: the ranks of each ``fsdp`` coordinate)."""
    torch.set_num_threads(1)
    ports = iter(ports)
    for name, run in runs.items():
        for world, shape in (('a', pair[0]), ('b', pair[1]),
                             ('a2', pair[0])):
            port, size = next(ports), int(np.prod(shape))
            if rank >= size:
                continue
            initialize_distributed(f'127.0.0.1:{port}', size, rank,
                                   device='cpu')
            try:
                _reshard_world(rank, world, shape, run, f'{out}/{name}')
            finally:
                dist.destroy_process_group()


def _raw(t) -> bytes:
    return t.detach().reshape(-1).contiguous().view(torch.uint8) \
        .numpy().tobytes()


def _digest(state) -> str:
    """A hash of a sharded part's params and optimizer state, bytes and
    scalars."""
    h = hashlib.sha256()
    for name, t in _named(state.params):
        h.update(name.encode() + _raw(t))
    for pid, st in sorted(state.opt_state['state'].items()):
        for key, v in sorted(st.items()):
            h.update(f'{pid}.{key}'.encode())
            h.update(_raw(v) if torch.is_tensor(v) else repr(v).encode())
    h.update(repr(state.opt_state['param_groups']).encode())
    return h.hexdigest()


def _replicas_equal(state) -> bool:
    """Whether every rank of this rank's ``fsdp`` coordinate holds the
    same params and optimizer state, bit for bit (every rank calls it)."""
    mesh = state.mesh
    f = mesh['coords'][mesh['axes'].index('fsdp')]
    mine, got = _digest(state), [None] * dist.get_world_size()
    dist.all_gather_object(got, (f, mine))
    return all(d == mine for g, d in got if g == f)


def _save_old_form(state, directory):
    """This rank's whole part as ``CheckpointManager.save`` wrote it
    before replicas left their params and optimizer state out."""
    step_dir = Path(directory) / str(state.step)
    step_dir.mkdir(parents=True, exist_ok=True)
    torch.save({'sharded_train_state': state._asdict()},
               step_dir / f'rank{dist.get_rank()}.pt')
    dist.barrier()


def _reshard_world(rank, world, shape, run, out):
    data, fsdp, seq = shape
    mesh = make_mesh(data, fsdp, seq=seq, device='cpu')
    model = ESM2(config=run['cfg'], params=run['params'], device='cpu')
    model.lora_kwargs = dict(run['lora_kwargs'])
    opts = dict(run['opts'])
    if opts.pop('optimizer', None) == 'adam8bit':
        opts['optimizer'] = adam8bit(1e-3)

    def trainer():
        return ShardedMaskedPLM(model, mesh, learning_rate=1e-3,
                                grad_accum=2, seq_axis='seq', **opts)
    plm = trainer()
    rows = run['rows'][data]
    res = {}
    if world == 'a':
        res['losses'] = np.array([plm.training_step(rows)
                                  for _ in range(3)])
        _save_old_form(plm.state, f'{out}/a_old')
    else:
        source = 'b' if world == 'a2' else 'a'
        plm.state = CheckpointManager(f'{out}/{source}',
                                      monitor=None).restore(plm.state)
        old = trainer()
        old.state = CheckpointManager(f'{out}/a_old',
                                      monitor=None).restore(old.state)
        CheckpointManager(f'{out}/{world}_old', monitor=None).save(
            old.step, old.state)
        del old
    res['step'] = np.array(plm.step)
    res['replicas_equal'] = np.array(_replicas_equal(plm.state))
    CheckpointManager(f'{out}/{world}', monitor=None).save(plm.step,
                                                           plm.state)
    if world != 'a2':
        res.update({f'before.{k}': v.numpy()
                    for k, v in _named(plm.unsharded_params())})
        _capture_update(plm, res)
        res['loss'] = np.array(plm.training_step(rows))
        res.update({f'param.{k}': v.numpy()
                    for k, v in _named(plm.unsharded_params())})
    np.savez(f'{out}/{world}_rank{rank}.npz', **res)


def _refused(fn) -> str:
    """The ``ValueError`` ``fn()`` raises, as ``'ValueError: ...'``."""
    try:
        fn()
    except ValueError as e:
        return f'ValueError: {e}'
    return 'no error'


def reshard_refusal_rank(rank, n, ports, run, other_cfg, out):
    """Rank ``rank`` of two worlds. On a (1, 2, 1) mesh: three micro-steps
    of ``run``'s dense Adam trainer (``grad_accum=2``) saved to
    ``out/a``, and the same parts without their layout (a part as saved
    before it recorded ``coords``, ``specs`` and ``views``) to
    ``out/old``; a fresh trainer takes ``out/old`` back on its own shape
    (``own_shape_restored``: every param bit-equal) and a trainer on a
    (2, 1, 1) mesh refuses a (1, 2, 1) part through its setter
    (``setter``); written to ``out/rank<r>.npz``. Then rank 0 alone, on
    a (1, 1, 1) mesh, restores ``out/a`` into a trainer of ``other_cfg``
    (``model``), one whose mask freezes the token embedding (``mask``),
    one with ``adam8bit`` (``optimizer``), and ``out/old`` into the dense
    Adam trainer (``no_specs``); the messages are added to rank 0's
    file."""
    torch.set_num_threads(1)
    res = {}

    def trainer(mesh, cfg=None, **kw):
        model = ESM2(config=cfg or run['cfg'],
                     params=None if cfg else run['params'], device='cpu',
                     rng=0)
        return ShardedMaskedPLM(model, mesh, learning_rate=1e-3,
                                grad_accum=2, seq_axis='seq', **kw)
    initialize_distributed(f'127.0.0.1:{ports[0]}', n, rank, device='cpu')
    try:
        mesh = make_mesh(1, 2, seq=1, device='cpu')
        plm = trainer(mesh)
        rows = run['rows'][1]
        for _ in range(3):
            plm.training_step(rows)
        CheckpointManager(f'{out}/a', monitor=None).save(3, plm.state)
        state = plm.state
        old = ShardedTrainState(
            state.params, state.opt_state, state.step, state.accum,
            {k: state.mesh[k] for k in ('axes', 'shape', 'rank')})
        CheckpointManager(f'{out}/old', monitor=None).save(3, old)
        fresh = trainer(mesh)
        fresh.state = CheckpointManager(f'{out}/old').restore(fresh.state)
        res['own_shape_restored'] = np.array(all(
            torch.equal(x.view(torch.uint8), y.view(torch.uint8))
            for x, y in zip(_tensors(fresh.params), _tensors(plm.params))))
        other = trainer(make_mesh(2, 1, seq=1, device='cpu'))

        def take():
            other.state = plm.state
        res['setter'] = np.array(_refused(take))
    finally:
        dist.destroy_process_group()
    if rank == 0:
        initialize_distributed(f'127.0.0.1:{ports[1]}', 1, 0, device='cpu')
        try:
            mesh = make_mesh(1, 1, seq=1, device='cpu')
            frozen = {k: k != 'embed_tokens' for k in run['params']}
            for case, t, source in (
                    ('model', trainer(mesh, other_cfg), 'a'),
                    ('mask', trainer(mesh, trainable_mask=frozen), 'a'),
                    ('optimizer', trainer(mesh, optimizer=adam8bit(1e-3)),
                     'a'),
                    ('no_specs', trainer(mesh), 'old')):
                mgr = CheckpointManager(f'{out}/{source}', monitor=None)
                res[case] = np.array(_refused(
                    lambda: mgr.restore(t.state)))
        finally:
            dist.destroy_process_group()
    np.savez(f'{out}/rank{rank}.npz', **res)


def host_parts_rank(rank, n, port, cfg, params, batches, out):
    """Rank ``rank`` of a (1, n, 1) gloo world on the host:
    ``ShardedMaskedPLM(grad_accum=2, seq_axis='seq')`` over ESM2 of
    ``cfg`` from ``params`` takes three micro-steps (one update, then a
    cycle left open) on ``batches``; every rank saves its part to
    ``out``/ckpt, and rank 0 the params gathered at the cut to
    ``out``/params.pt."""
    torch.set_num_threads(1)
    initialize_distributed(f'127.0.0.1:{port}', n, rank, device='cpu')
    try:
        mesh = make_mesh(1, n, seq=1, device='cpu')
        model = ESM2(config=cfg, params=params, device='cpu')
        plm = ShardedMaskedPLM(model, mesh, learning_rate=1e-3,
                               grad_accum=2, seq_axis='seq')
        for _ in range(3):
            plm.training_step(batches)
        CheckpointManager(f'{out}/ckpt', monitor=None).save(plm.step,
                                                           plm.state)
        params = plm.unsharded_params()
        if rank == 0:
            torch.save(params, f'{out}/params.pt')
    finally:
        dist.destroy_process_group()
