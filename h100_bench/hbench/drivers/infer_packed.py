"""Packed inference, closed loop, one client: a seeded FASTA read by the
port's ``FastaTokenDataset`` (token budget ``token_per_batch``) through its
``Prefetcher`` into ``predict_log_prob(tokens, pad_args=...)``, each
batch's log-probabilities brought to the host.

The log-probabilities come back into one pinned host buffer, reused, so
the client's copy costs no fresh pages. The check: a sample of the
window's batches, drawn from the seed among its first ``check_within``
(a window runs well past that many; if one does not, the loop runs on
after it until the sample is made). Every sequence of a sampled batch must
be a record of the FASTA (read by the reference), and its
log-probabilities are held against the float32 reference's, computed
sequence by sequence."""

from __future__ import annotations

import numpy as np
import torch

from reference import compare
from reference.data import Catalog, read_fasta, segments
from reference.model import log_probs

from .. import port, seeds, traffic, weights, work
from .base import Base, Feed, real_lengths


class Driver(Base):

    def setup(self):
        ctx, t = self.ctx, self.ctx.traffic
        p = port.package()
        self.params = weights.make_params(ctx.arch, ctx.seed, ctx.device)
        self.n_params = weights.param_count(self.params)
        self.model = port.model(ctx.arch, self.params, ctx.device)
        self.fasta = ctx.workdir / 'seqs.fa'
        traffic.write_fasta(self.fasta, t['lengths'], ctx.seed)
        shuffle = seeds.torch_seed(ctx.seed, 'shuffle')
        self.dataset = p.FastaTokenDataset(
            str(self.fasta), token_per_batch=t['token_per_batch'],
            shuffle=True, random_state=shuffle, alphabet=self.model.alphabet)
        self.feed = Feed(p.Prefetcher, lambda epoch: self.dataset,
                         t['prefetch_depth'])
        rows = (t['token_per_batch'], ctx.arch.vocab)
        self.host = torch.empty(rows, pin_memory=ctx.device != 'cpu')
        rng = seeds.rng(ctx.seed, 'check')
        self.sample = sorted(int(i) for i in rng.choice(
            t['check_within'], t['check_units'], replace=False))
        self.done, self.kept = -t['warmup_units'], {}
        for _ in range(t['warmup_units']):
            self.unit()

    def unit(self) -> dict:
        arch = self.ctx.arch
        batch, wait = self.feed.next()
        n = batch.num_tokens
        lp = self.model.predict_log_prob(batch.tokens, pad_args=batch.pad_args)
        out = self.host[:n]
        out.copy_(lp[:n])
        lengths = real_lengths(batch.cu_lens)
        if self.done in self.sample:
            self.kept[self.done] = (batch.tokens[:n], lengths,
                                    self._planted(out.numpy().copy(),
                                                  lengths))
        if self.fault == 'stale':
            self._prev = out.numpy().copy()
        self.done += 1
        h1 = work.bound_s(*work.flash_fwd_work(lengths, arch.heads,
                                               arch.head_dim))
        attn = work.attn_fwd_flops(lengths, arch.width, arch.layers)
        return {'tokens': n, 'data_wait_s': wait,
                'gemm_flops': work.gemm_flops_infer(arch, n),
                'model_flops': work.model_flops_infer(self.n_params, n, attn),
                'h1_bound_s': arch.layers * h1}

    def _planted(self, out, lengths):
        """The faults a test plants where the answer is produced."""
        if self.fault == 'altered':
            out[1] = out[1, ::-1].copy()
        elif self.fault == 'half':
            out[sum(lengths[:len(lengths) // 2]):] = -np.log(out.shape[1])
        elif self.fault == 'stale':         # the answer to the batch before
            m = min(len(self._prev), len(out))
            out[:m] = self._prev[:m]
        return out

    def end_window(self):
        while self.done <= self.sample[-1]:
            self.unit()
        super().end_window()

    def check(self, units, control: bool = False) -> dict:
        arch, dev = self.ctx.arch, self.ctx.device
        catalog = Catalog(read_fasta(self.fasta))
        params = self.reference_params()
        # the fault 'control': the control in the program's place
        planted = self.fault == 'control'
        got, ref, low, unknown = [], [], [], 0
        for i in self.sample:
            tokens, lengths, out = self.kept[i]
            unknown += catalog.unknown(segments(tokens, lengths))
            tok = torch.as_tensor(np.asarray(tokens), device=dev)
            got.append(out)
            ref.append(log_probs(params, arch, tok, lengths).cpu().numpy())
            if control or planted:
                low.append(log_probs(params, arch, tok, lengths, fp8=True)
                           .cpu().numpy())
        numbers = _numbers(low if planted else got, ref, unknown)
        if control:
            return {'program': numbers, 'control': _numbers(low, ref, 0)}
        return numbers


def _numbers(got, ref, unknown) -> dict:
    x, r = np.concatenate(got), np.concatenate(ref)
    return {'unknown_sequences': unknown,
            'logprob_rel_rms': compare.rel_rms(x, r),
            'logprob_max_abs': compare.max_abs(x, r)}
