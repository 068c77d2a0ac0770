"""The ranks of the port's context-parallel tests
(``tests/test_torch_context.py``, ``tests/test_torch_cp_train.py``,
``tests/test_torch_memory.py``): each
runs in a process of its own, spawned by the test, and joins a gloo group
of ``n`` ranks on ``127.0.0.1``. This module imports neither JAX nor the JAX package, so
that a spawned rank loads only the port."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from esme_tpu_torch.models.esm import ESM1b, ESM1v, ESM2, ESMC, packed_meta
from esme_tpu_torch.ops import flash
from esme_tpu_torch.parallel import (context_parallel_log_prob,
                                     forward_flat_cp, initialize_distributed,
                                     make_kv_gather, make_mesh)
from esme_tpu_torch.train import ShardedMaskedPLM, adam8bit

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
    them, and the checks that its constructor and step refuse what JAX
    refuses; written to ``out``/rank<r>.npz (the gradients under
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
        for kw in ({'lora_only': True}, {'train_lmhead': True},
                   {'trainable_mask': {}}):
            try:
                ShardedMaskedPLM(model, mesh, **kw)
            except NotImplementedError as e:
                refused.append('slice' in str(e))
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
