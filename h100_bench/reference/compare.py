"""The numbers that compare an output with the reference's.

Each is a plain function of two arrays (or two tables of norms), so the
program's reading and the control's come from the same code.
"""

from __future__ import annotations

import math

import numpy as np


def rel_rms(x, ref) -> float:
    """RMS of ``x − ref`` over the RMS of ``ref`` about each row's mean
    (rows: a token's log-probabilities, a sequence's scores)."""
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    spread = ref - ref.mean(axis=-1, keepdims=True)
    return float(np.sqrt(np.mean((x - ref) ** 2))
                 / max(np.sqrt(np.mean(spread ** 2)), 1e-30))


def max_abs(x, ref) -> float:
    """The widest gap, ``max |x − ref|``."""
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(x - ref).max())


def loss_gap(losses, ref_losses) -> float:
    """The worst step's ``|loss − ref| / |ref|``."""
    return max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(losses, ref_losses, strict=True))


def kept_leaves(ref_grad: dict, share: float = 1e-3) -> list:
    """Leaves whose reference gradient is at least ``share`` of the median
    leaf's: the others (a key bias under softmax) move under Adam by
    round-off alone."""
    med = float(np.median(list(ref_grad.values())))
    return sorted(k for k, g in ref_grad.items() if g >= share * med)


def leaf_gaps(norms: dict, ref_norms: dict, leaves) -> dict:
    """Per leaf of ``leaves``: ``|‖x‖ − ‖ref‖|`` over the larger of the
    reference's norm of that leaf and of the median leaf."""
    med = float(np.median([ref_norms[k] for k in leaves]))
    return {k: abs(norms[k] - ref_norms[k]) / max(ref_norms[k], med, 1e-30)
            for k in leaves}


def norm_gap(norms: dict, ref_norms: dict, leaves) -> float:
    """:func:`leaf_gaps` by the worst leaf."""
    return max(leaf_gaps(norms, ref_norms, leaves).values())


def diff_gaps(views: dict, ref_views: dict, ref_norms: dict,
              leaves) -> dict:
    """Per leaf of ``leaves``: ``‖x − ref‖`` over its views (``(leaf
    path, layer)`` to a tensor), over the larger of the reference's norm
    of that leaf and of the median leaf (``ref_norms``)."""
    sq = dict.fromkeys(leaves, 0.0)
    for view, r in ref_views.items():
        if view[0] in sq:
            d = views[view].double() - r.double()
            sq[view[0]] += float(d.pow(2).sum())
    med = float(np.median([ref_norms[k] for k in leaves]))
    return {k: math.sqrt(v) / max(ref_norms[k], med, 1e-30)
            for k, v in sq.items()}


def lean(views: dict, ref_views: dict, diff: dict) -> float:
    """How far ``views`` lean toward one half of the batch: the gap
    ``x − ref`` projected on ``diff``, the first half's gradient less the
    second's, as a share of it, ``|⟨x − ref, d⟩| / ‖d‖²`` over every view.
    About 0 where ``x`` weighs the halves as the whole batch does; the
    other half's share of the masked targets, about 0.5, where ``x``
    comes from one half alone."""
    dot = sq = 0.0
    for view, d in diff.items():
        d = d.double()
        dot += float(((views[view].double() - ref_views[view].double())
                      * d).sum())
        sq += float(d.pow(2).sum())
    return abs(dot) / max(sq, 1e-300)
