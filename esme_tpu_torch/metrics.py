"""Evaluation metrics: Spearman correlation, AUROC, AUPRC and accuracy.

A copy of ``esme_tpu/metrics.py`` (numpy only; the port imports nothing
of the JAX package): the reference computes these with ``torchmetrics``
(reference: esme/trainer.py:59-60, workflow/tf/finetune.py). They run on
the host, on whatever device the predictions came from.
"""

from __future__ import annotations

import numpy as np


def _rank(a: np.ndarray) -> np.ndarray:
    """Ranks with tie-averaging (matches scipy/torchmetrics Spearman)."""
    a = np.asarray(a, dtype=np.float64)
    order = np.argsort(a, kind='mergesort')
    r = np.empty(len(a), dtype=np.float64)
    r[order] = np.arange(len(a), dtype=np.float64)
    # average ranks over ties
    sa = a[order]
    i = 0
    while i < len(sa):
        j = i
        while j + 1 < len(sa) and sa[j + 1] == sa[i]:
            j += 1
        if j > i:
            r[order[i:j + 1]] = (i + j) / 2.0
        i = j + 1
    return r


def spearman(pred, target) -> float:
    """Spearman rank correlation (reference: esme/trainer.py:59-60)."""
    rp, rt = _rank(pred), _rank(target)
    rp -= rp.mean()
    rt -= rt.mean()
    denom = np.sqrt((rp ** 2).sum() * (rt ** 2).sum())
    return float((rp * rt).sum() / denom) if denom > 0 else 0.0


def auroc(target, score) -> float:
    """Area under the ROC curve by rank statistic (ties averaged): exact
    for binary targets (the Mann-Whitney U formulation)."""
    y = np.asarray(target).astype(np.float64)
    s = np.asarray(score).astype(np.float64)
    n_pos = y.sum()
    n_neg = len(y) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float('nan')
    r = _rank(s) + 1.0          # 1-based ranks
    u = r[y == 1].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def auprc(target, score) -> float:
    """Area under the precision-recall curve (average precision, the
    torchmetrics ``AveragePrecision`` estimator)."""
    y = np.asarray(target).astype(np.float64)
    s = np.asarray(score).astype(np.float64)
    n_pos = y.sum()
    if n_pos == 0:
        return float('nan')
    order = np.argsort(-s, kind='mergesort')
    y = y[order]
    tp = np.cumsum(y)
    precision = tp / (np.arange(len(y)) + 1.0)
    # AP = sum over positives of precision at that threshold / n_pos
    return float((precision * y).sum() / n_pos)


def accuracy(target, score, threshold: float = 0.0) -> float:
    y = np.asarray(target).astype(bool)
    pred = np.asarray(score) > threshold
    return float((pred == y).mean())
