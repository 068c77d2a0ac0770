"""Variant scoring, closed loop, one protein at a time: each protein
through the port's ``variant.predict_mask_margin(model, seq,
batch_size)``, its latency the wall time from the call to its returned
scores.

The check: a sample of the window's proteins drawn from the seed, with
the longest in it. Every score's key must be the one the masked position
and substitution give, and the scores are held against the margins of
the float32 reference's log-probabilities, in float64."""

from __future__ import annotations

import time

import numpy as np
import torch

from reference import compare
from reference.data import AMINO, MASK, tokenize
from reference.model import log_probs

from .. import port, seeds, traffic, weights, work
from .base import Base

AA_IDS = np.arange(4, 24)


class Driver(Base):

    def setup(self):
        ctx, t = self.ctx, self.ctx.traffic
        port.package()
        from esme_tpu_torch import variant
        self.variant = variant
        self.params = weights.make_params(ctx.arch, ctx.seed, ctx.device)
        self.n_params = weights.param_count(self.params)
        self.model = port.model(ctx.arch, self.params, ctx.device)
        self.proteins = traffic.proteins(t['lengths'], ctx.seed)
        b = t['batch_size']
        for n in sorted(set(traffic.length_pool(t['lengths']).tolist())):
            chunk = np.tile(tokenize('A' * n), (b, 1))
            self.model.predict_log_prob(chunk).cpu()
        self.kept = []

    def unit(self) -> dict:
        arch, b = self.ctx.arch, self.ctx.traffic['batch_size']
        seq = next(self.proteins)
        t0 = time.perf_counter()
        scores = self.variant.predict_mask_margin(self.model, seq,
                                                  batch_size=b)
        lat = time.perf_counter() - t0
        if self.fault == 'altered':
            key = next(iter(scores))
            scores[key] += 1.0
        # kept as one array and a count of wrong keys, so the window holds
        # no growing heap of Python objects for the collector to scan
        keys = _keys(seq)
        wrong = sum(a != b for a, b in zip(scores, keys)) \
            + abs(len(scores) - len(keys))
        values = np.fromiter((scores.get(k, np.nan) for k in keys),
                             np.float64, len(keys)).reshape(len(seq), 20)
        self.kept.append((seq, values, wrong))
        n = len(seq)
        tokens = n * (n + 2)             # the masked copies' real rows
        attn = work.attn_fwd_flops([n + 2] * n, arch.width, arch.layers)
        return {'tokens': tokens, 'latency_s': lat,
                'gemm_flops': work.gemm_flops_infer(arch, tokens),
                'model_flops': work.model_flops_infer(self.n_params, tokens,
                                                      attn)}

    def _sample(self) -> list:
        k = self.ctx.traffic['check_units']
        longest = max(range(len(self.kept)),
                      key=lambda i: len(self.kept[i][0]))
        rest = [i for i in range(len(self.kept)) if i != longest]
        rng = seeds.rng(self.ctx.seed, 'check')
        pick = rng.choice(len(rest), min(k - 1, len(rest)), replace=False)
        return sorted([longest] + [rest[int(i)] for i in pick])

    def check(self, units, control: bool = False) -> dict:
        params = self.reference_params()
        # the fault 'control': the control in the program's place
        planted = self.fault == 'control'
        got, ref, low, bad = [], [], [], 0
        for i in self._sample():
            seq, values, wrong = self.kept[i]
            bad += wrong
            got.append(values)
            ref.append(self._margins(params, seq, False))
            if control or planted:
                low.append(self._margins(params, seq, True))
        numbers = _numbers(low if planted else got, ref, bad)
        if control:
            return {'program': numbers, 'control': _numbers(low, ref, 0)}
        return numbers

    def _margins(self, params, seq: str, fp8: bool) -> np.ndarray:
        """``(L, 20)`` float64 margins: log P(aa) − log P(wt) at each masked
        position of the reference's log-probabilities."""
        base = tokenize(seq)
        n, w = len(seq), len(base)
        copies = np.tile(base, (n, 1))
        copies[np.arange(n), np.arange(n) + 1] = MASK
        tok = torch.as_tensor(copies.reshape(-1), device=self.ctx.device)
        lp = log_probs(params, self.ctx.arch, tok, [w] * n, fp8=fp8)
        rows = lp.view(n, w, -1)[torch.arange(n), torch.arange(n) + 1]
        rows = rows.double().cpu().numpy()
        wt = base[1:-1]
        return rows[:, AA_IDS] - rows[np.arange(n), wt][:, None]


def _keys(seq: str) -> list:
    """The scores' keys in the order the port returns them."""
    return [f'{wt}{p + 1}{aa}' for p, wt in enumerate(seq) for aa in AMINO]


def _numbers(got, ref, bad) -> dict:
    x, r = np.concatenate(got), np.concatenate(ref)
    gap = np.where(np.isnan(x), np.inf, np.abs(x - r))
    return {'score_keys_wrong': bad,
            'score_rel_rms': compare.rel_rms(np.nan_to_num(x, nan=1e9), r),
            'score_max_abs': float(gap.max())}
