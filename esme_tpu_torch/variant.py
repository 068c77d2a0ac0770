"""Variant-effect prediction by mask-margin scoring and pseudo-perplexity.

Counterpart of ``esme_tpu/variant.py`` (reference: esme/variant.py:10-246),
without pandas: the two margin functions return a ``dict`` ``variant ->
score``, keyed ``'{wt}{pos}{aa}'`` in the order of the JAX frame's index
(:func:`predict_mask_margin`: position, then ``alphabet.amino_acids``;
:func:`predict_pseudoperplexity_margin`: sorted, as ``groupby`` sorts),
and :func:`predict_pseudoperplexity` returns a float, as in JAX.

Every chunk of masked copies shares one ``(batch_size, L)`` shape (the
tail chunk is padded with repeated rows, which are dropped) and goes
through the model's padded ``predict_log_prob(tokens)`` route. The
log-probs a score needs are picked on the device, then copied to the
host, where scores are computed in fp64 (JAX's Python floats).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .alphabet import Alphabet3, tokenize
from .profiling import span


class MaskMarginDataset:
    """One item per sequence position, that position masked; with
    ``max_len`` a window of that many tokens centred on the variant
    (``esme_tpu/variant.py:21-58``, reference: esme/variant.py:10-70)."""

    def __init__(self, seq: str, max_len: Optional[int] = None,
                 alphabet=Alphabet3):
        self.seq = seq
        self.max_len = max_len
        self.alphabet = alphabet
        self.token = tokenize([seq], alphabet=alphabet)[0]

    def __len__(self):
        return len(self.seq)

    def __getitem__(self, idx):
        token = self.token.copy()
        wt = self.seq[idx]
        idx += 1
        token[idx] = self.alphabet.mask_idx

        if self.max_len is not None and token.shape[0] > self.max_len:
            start = max(0, idx - self.max_len // 2)
            start = min(token.shape[0] - self.max_len, start)
            end = min(token.shape[0], start + self.max_len)
            token = token[start:end]
            pos = idx - start
        else:
            pos = idx

        return {
            'token': token,
            'local_pos': pos,
            'pos': idx,
            'wt': wt,
            'wt_token': self.alphabet.token_to_idx[wt],
        }


def _batched_items(ds, batch_size):
    """Fixed-size batches of ``ds``'s items and their stacked tokens: the
    tail is padded by repeating the last item so every batch has one
    shape; ``n_real`` counts the real rows (``esme_tpu/variant.py:61-70``).
    Yields ``(items, tokens, n_real)``."""
    n = len(ds)
    for lo in range(0, n, batch_size):
        with span('esme.variant.build'):
            idxs = list(range(lo, min(lo + batch_size, n)))
            n_real = len(idxs)
            while len(idxs) < batch_size and n > 0:
                idxs.append(idxs[-1])
            items = [ds[i] for i in idxs]
            tokens = np.stack([it['token'] for it in items])
        yield items, tokens, n_real


def _rows(model, items, tokens, n_real, pos_key):
    """Log-prob rows ``(n_real, V)`` of each real item at its
    ``pos_key`` position, picked on the device, as fp64 on the host."""
    with span('esme.variant.forward'):
        lp = model.predict_log_prob(tokens)
    with span('esme.variant.fetch'):
        pos = torch.as_tensor([it[pos_key] for it in items[:n_real]],
                              device=lp.device)
        rows = lp[torch.arange(n_real, device=lp.device), pos]
        return rows.cpu().numpy().astype(np.float64)


def _dataset(seq, max_len, alphabet):
    return seq if isinstance(seq, MaskMarginDataset) else \
        MaskMarginDataset(seq, max_len=max_len, alphabet=alphabet)


def predict_mask_margin(model, seq, batch_size: int = 32,
                        max_len: Optional[int] = None,
                        alphabet=None) -> Dict[str, float]:
    """Mask-margin scores of every single-residue substitution
    (``esme_tpu/variant.py:73-97``, reference: esme/variant.py:110-165):
    ``{'{wt}{pos}{aa}': logP(aa) - logP(wt)}`` at the masked position,
    positions 1-based, in position order, then ``alphabet.amino_acids``'
    order."""
    alphabet = alphabet or model.alphabet
    ds = _dataset(seq, max_len, alphabet)
    aa_idx = np.asarray([alphabet.token_to_idx[aa]
                         for aa in alphabet.amino_acids])
    scores = {}
    for items, tokens, n_real in _batched_items(ds, batch_size):
        rows = _rows(model, items, tokens, n_real, 'local_pos')
        with span('esme.variant.margins'):
            for b, it in enumerate(items[:n_real]):
                margin = rows[b, aa_idx] - rows[b, it['wt_token']]
                for aa, m in zip(alphabet.amino_acids, margin):
                    scores[f"{it['wt']}{it['pos']}{aa}"] = float(m)
    return scores


def predict_pseudoperplexity(model, seq, batch_size: int = 32,
                             max_len: Optional[int] = None,
                             alphabet=None) -> float:
    """``exp`` of the mean NLL of the wild-type residue at each masked
    position (``esme_tpu/variant.py:100-119``, reference:
    esme/variant.py:168-216)."""
    alphabet = alphabet or model.alphabet
    ds = _dataset(seq, max_len, alphabet)
    total_nll = 0.0
    count = 0
    for items, tokens, n_real in _batched_items(ds, batch_size):
        rows = _rows(model, items, tokens, n_real, 'local_pos')
        with span('esme.variant.margins'):
            for b, it in enumerate(items[:n_real]):
                total_nll -= float(rows[b, it['wt_token']])
                count += 1
    return float(np.exp(total_nll / max(count, 1)))


class PseudoPerplexitiesMarginDataset:
    """Every (variant, masked position) pair: the sequence with one
    substitution and one position masked (``esme_tpu/variant.py:122-152``,
    reference: esme/variant.py:73-107)."""

    def __init__(self, seq: str, alphabet=Alphabet3):
        self.seq = seq
        self.alphabet = alphabet
        self.token = tokenize([seq], alphabet=alphabet)[0]
        self.variants = [
            (wt, pos + 1, mt, mask_pos + 1, mask_aa)
            for pos, wt in enumerate(seq)
            for mt in alphabet.amino_acids
            for mask_pos, mask_aa in enumerate(seq)
        ]

    def __len__(self):
        return len(self.variants)

    def __getitem__(self, idx):
        wt, pos, mt, mask_pos, mask_aa = self.variants[idx]
        token = self.token.copy()
        token[pos] = self.alphabet.token_to_idx[mt]
        token[mask_pos] = self.alphabet.mask_idx
        return {
            'token': token,
            'wt': wt,
            'pos': pos,
            'mt': mt,
            'wt_mask_idx': self.alphabet.token_to_idx[mask_aa],
            'mask_pos': mask_pos,
        }


def predict_pseudoperplexity_margin(model, seq, batch_size: int = 32,
                                    alphabet=None) -> Dict[str, float]:
    """Per variant, the mean log-prob of the wild-type residue at each
    masked position under the mutated background
    (``esme_tpu/variant.py:155-176``, reference: esme/variant.py:219-246):
    ``{'{wt}{pos}{mt}': mean}``, keys sorted as ``groupby`` sorts them."""
    alphabet = alphabet or model.alphabet
    ds = PseudoPerplexitiesMarginDataset(seq, alphabet=alphabet)
    sums: Dict[str, list] = {}
    for items, tokens, n_real in _batched_items(ds, batch_size):
        rows = _rows(model, items, tokens, n_real, 'mask_pos')
        with span('esme.variant.margins'):
            for b, it in enumerate(items[:n_real]):
                sums.setdefault(f"{it['wt']}{it['pos']}{it['mt']}",
                                []).append(rows[b, it['wt_mask_idx']])
    return {v: float(np.mean(sums[v])) for v in sorted(sums)}
