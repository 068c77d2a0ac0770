"""Masked-LM training: a seeded FASTA through the port's
``MaskedFastaTokenDataModule`` (token budget, 80/10/10 masking) and its
``Prefetcher`` into ``MaskedPLM.training_step``.

Set-up builds one trainer and drives it through its first
``check_steps`` steps, through the window's own call and feed; the
window then continues with the same trainer. Those first steps are what
the reference follows: the first gradient as Adam got it (its first
moment after one step over ``1 − β1``), whole by the worst leaf and
projected on the difference of the batch's two halves' gradients (a step
that leaves half of its batch out leans to the other half), and the
parameters' change after the last step by the worst leaf. Each step's
loss is read beside them."""

from __future__ import annotations

import numpy as np
import torch

from reference import compare
from reference.data import Catalog, mask_faults, read_fasta, segments
from reference.model import leaf_norms, strict_fp32, train

from .. import port, traffic, weights, work
from .base import Base, Feed, real_lengths


class Driver(Base):

    def setup(self):
        ctx, t = self.ctx, self.ctx.traffic
        p = port.package()
        from esme_tpu_torch.train import MaskedPLM
        self.params = weights.make_params(ctx.arch, ctx.seed, ctx.device)
        self.n_params = weights.param_count(self.params)
        self.model = port.model(ctx.arch, self.params, ctx.device,
                                checkpointing=t['checkpointing'])
        self.plm = MaskedPLM(self.model, learning_rate=t['learning_rate'],
                             remat=t['remat'])
        group = self.plm.optimizer.param_groups[0]
        stated = (t['learning_rate'], tuple(t['adam']['betas']),
                  t['adam']['eps'], 0)
        if (group['lr'], tuple(group['betas']), group['eps'],
                group['weight_decay']) != stated:
            raise ValueError(f'the trainer runs Adam {group} and the traffic '
                             f'states {stated}')
        self.fasta = ctx.workdir / 'seqs.fa'
        traffic.write_fasta(self.fasta, t['lengths'], ctx.seed)
        dm = p.MaskedFastaTokenDataModule(
            str(self.fasta), token_per_batch=t['token_per_batch'],
            mask_freq=t['mask_freq'], alter_freq=t['alter_freq'],
            alphabet=self.model.alphabet)

        def epoch(e):
            dm.set_epoch(e)
            return dm.train_dataloader()
        self.feed = Feed(p.Prefetcher, epoch, t['prefetch_depth'])
        self.first = []
        for step in range(t['check_steps']):
            u = self.unit()
            self.first.append(self._kept)
            self.first[-1]['loss'] = u['loss']
            if step == 0:
                self.first_grads = self._adam_grads()
        self.change_norms = self._change()

    def _batch(self, batch):
        """The batch the step trains on, and the mask the data layer
        made (a planted fault narrows the first)."""
        made = batch.mask
        if self.fault == 'half':
            lengths = real_lengths(batch.cu_lens)
            cut = sum(lengths[:len(lengths) // 2])
            batch.mask = batch.mask.copy()
            batch.mask[cut:] = False
        return batch, made

    def unit(self) -> dict:
        arch, t = self.ctx.arch, self.ctx.traffic
        batch, wait = self.feed.next()
        batch, made = self._batch(batch)
        if self.fault == 'unchanged':
            saved = [x.clone() for x in _leaves(self.model.params)]
        loss = self.plm.training_step(batch)
        if self.fault == 'unchanged':
            with torch.no_grad():
                for x, s in zip(_leaves(self.model.params), saved):
                    x.copy_(s)
        n = batch.num_tokens
        lengths = real_lengths(batch.cu_lens)
        self._kept = {'tokens': batch.tokens[:n], 'masked':
                      batch.masked_tokens[:n], 'mask': made[:n],
                      'lengths': lengths}
        fwd = work.bound_s(*work.flash_fwd_work(lengths, arch.heads,
                                                arch.head_dim))
        bwd = work.bound_s(*work.flash_bwd_work(lengths, arch.heads,
                                                arch.head_dim))
        again = t['checkpointing'] and t['remat'] == 'full'
        attn = work.attn_fwd_flops(lengths, arch.width, arch.layers)
        return {'tokens': n, 'data_wait_s': wait, 'loss': loss,
                'gemm_flops': work.gemm_flops_train(arch, n, again),
                'model_flops': work.model_flops_train(self.n_params, n, attn),
                'h1_bound_s': arch.layers * fwd * (2 if again else 1),
                'h2_bound_s': arch.layers * bwd}

    def _adam_grads(self) -> dict:
        """The first gradient as the optimizer holds it, per view
        ``(leaf path, layer)``: its first moment after one step over
        ``1 − β1``, in float32 on the host (so the window's device memory
        does not hold it)."""
        st = self.plm.state
        b1 = st.opt_state['param_groups'][0]['betas'][0]
        return {tuple(view): st.opt_state['state'][i]['exp_avg'].cpu()
                .float().div_(1 - b1)
                for i, view in enumerate(st.views['optimizer'])}

    def _change(self) -> dict:
        """Per leaf, the norm of the parameters' change since the start
        (the start made again from the seed)."""
        start = weights.make_params(self.ctx.arch, self.ctx.seed,
                                    self.ctx.device)
        out = {path: float((x.float() - s.float()).norm())
               for (path, x), (_, s) in zip(_named(self.model.params),
                                            _named(start))}
        del start
        return out

    def check(self, units, control: bool = False,
              detail: bool = False) -> dict:
        t = self.ctx.traffic
        catalog = Catalog(read_fasta(self.fasta))
        bad = 0
        batches = []
        for b in self.first:
            bad += catalog.unknown(segments(b['tokens'], b['lengths']))
            bad += mask_faults(b['tokens'], b['masked'], b['mask'],
                               b['lengths'], t['mask_freq'])
            batches.append(self._ref_batch(b))
        low = self._train(batches, fp8=True) \
            if control or self.fault == 'control' else None
        ref = self._train(batches)
        keep = compare.kept_leaves(ref['grad_norms'])
        program = {'losses': [b['loss'] for b in self.first],
                   'first_grads': self.first_grads,
                   'change_norms': self.change_norms}
        if self.fault == 'control':      # the control in the program's place
            program, bad = low, 0
        numbers = _numbers(program, ref, keep, bad, detail)
        if not control:
            return numbers
        return {'program': numbers,
                'control': _numbers(low, ref, keep, 0, detail)}

    def _ref_batch(self, b) -> dict:
        dev = self.ctx.device
        return {'tokens': torch.as_tensor(np.asarray(b['masked']),
                                          device=dev),
                'targets': torch.as_tensor(np.asarray(b['tokens']),
                                           device=dev),
                'mask': torch.as_tensor(np.asarray(b['mask']), device=dev),
                'lengths': b['lengths']}

    def _train(self, batches, fp8: bool = False) -> dict:
        t = self.ctx.traffic
        strict_fp32()
        tree = weights.make_params(self.ctx.arch, self.ctx.seed,
                                   self.ctx.device)
        out = train(tree, self.ctx.arch, batches, t['learning_rate'],
                    tuple(t['adam']['betas']), t['adam']['eps'], fp8=fp8)
        del tree
        return out


def _numbers(got: dict, ref: dict, keep: list, bad: int,
             detail: bool = False) -> dict:
    """The check's numbers: the change's norm gap and the first gradient's
    difference, each by the worst leaf, and how far the first gradient
    leans to one half of the batch. ``detail`` adds what the limits were
    chosen from (``tools/readings.py``), among them each step's loss gap
    and the first gradient's norm gap, which neither the control nor a
    fault separates from sound runs (PERF.md): they are not compared."""
    diff = compare.diff_gaps(got['first_grads'], ref['first_grads'],
                             ref['grad_norms'], keep)
    out = {'batch_faults': bad,
           'change_norm_gap': compare.norm_gap(
               got['change_norms'], ref['change_norms'], keep),
           'grad_diff_gap': max(diff.values()),
           'half_lean': compare.lean(got['first_grads'], ref['first_grads'],
                                     ref['halves_diff'])}
    if detail:
        grad_norms = leaf_norms((view[0], g) for view, g in
                                got['first_grads'].items())
        out['loss_gaps'] = [compare.loss_gap([a], [b]) for a, b in
                            zip(got['losses'], ref['losses'], strict=True)]
        out['grad_diff_median'] = float(np.median(list(diff.values())))
        out['grad_diff_worst_leaf'] = max(diff, key=diff.get)
        for name, norms, leaves in (('grad', grad_norms, sorted(grad_norms)),
                                    ('change', got['change_norms'], keep)):
            gaps = compare.leaf_gaps(norms, ref[f'{name}_norms'], leaves)
            out[f'{name}_norm_gap'] = max(gaps.values())
            out[f'{name}_gap_median'] = float(np.median(list(gaps.values())))
            out[f'{name}_gap_worst_leaf'] = max(gaps, key=gaps.get)
    return out


def _named(tree: dict, path: str = ''):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, f'{path}{k}.')
        else:
            yield f'{path}{k}', v


def _leaves(tree: dict):
    return [x for _, x in _named(tree)]
