"""Clustering quality metrics used in the paper's Tables 2: NMI, RI, F-measure,
Accuracy (Hungarian-matched), plus the average-rank-score aggregation of
[Yang & Leskovec 2015] the paper uses to combine them.

Pure numpy/scipy — metrics run on host over final labelings.
"""
from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
from scipy.optimize import linear_sum_assignment


def contingency(labels_pred: np.ndarray, labels_true: np.ndarray) -> np.ndarray:
    """C[i, j] = #points assigned to predicted cluster i with true label j."""
    pred = np.unique(labels_pred, return_inverse=True)[1]
    true = np.unique(labels_true, return_inverse=True)[1]
    k_p, k_t = pred.max() + 1, true.max() + 1
    c = np.zeros((k_p, k_t), dtype=np.int64)
    np.add.at(c, (pred, true), 1)
    return c


def nmi(labels_pred: np.ndarray, labels_true: np.ndarray) -> float:
    """Normalized mutual information: 2·I / (H_pred + H_true)."""
    c = contingency(labels_pred, labels_true).astype(np.float64)
    n = c.sum()
    pi = c.sum(axis=1) / n
    pj = c.sum(axis=0) / n
    pij = c / n
    nz = pij > 0
    outer = np.outer(pi, pj)
    mi = float((pij[nz] * np.log(pij[nz] / outer[nz])).sum())
    h_p = -float((pi[pi > 0] * np.log(pi[pi > 0])).sum())
    h_t = -float((pj[pj > 0] * np.log(pj[pj > 0])).sum())
    denom = h_p + h_t
    return 2.0 * mi / denom if denom > 0 else 1.0


def rand_index(labels_pred: np.ndarray, labels_true: np.ndarray) -> float:
    """RI = (TP + TN) / #pairs via the contingency pair-count identity."""
    c = contingency(labels_pred, labels_true).astype(np.float64)
    n = c.sum()
    total_pairs = n * (n - 1) / 2.0
    sum_ij = (c * (c - 1) / 2.0).sum()                  # TP
    sum_i = (c.sum(axis=1) * (c.sum(axis=1) - 1) / 2.0).sum()
    sum_j = (c.sum(axis=0) * (c.sum(axis=0) - 1) / 2.0).sum()
    fp = sum_i - sum_ij
    fn = sum_j - sum_ij
    tn = total_pairs - sum_ij - fp - fn
    return float((sum_ij + tn) / total_pairs)


def adjusted_rand_index(labels_pred: np.ndarray, labels_true: np.ndarray) -> float:
    """ARI = (RI − E[RI]) / (max RI − E[RI]) — chance-corrected Rand index.

    Used by the streaming-vs-single-shot parity gates (label agreement must
    be ≥ 0.95); kept out of ``all_metrics`` so the Table 2 average-rank
    protocol stays exactly the paper's.
    """
    c = contingency(labels_pred, labels_true).astype(np.float64)
    n = c.sum()
    sum_ij = (c * (c - 1) / 2.0).sum()
    a = (c.sum(axis=1) * (c.sum(axis=1) - 1) / 2.0).sum()
    b = (c.sum(axis=0) * (c.sum(axis=0) - 1) / 2.0).sum()
    total = n * (n - 1) / 2.0
    expected = a * b / total if total > 0 else 0.0
    denom = 0.5 * (a + b) - expected
    if denom == 0:
        return 1.0
    return float((sum_ij - expected) / denom)


def f_measure(labels_pred: np.ndarray, labels_true: np.ndarray) -> float:
    """Paper's FM: mean over predicted clusters of the best-matching F1."""
    c = contingency(labels_pred, labels_true).astype(np.float64)
    sizes_pred = c.sum(axis=1, keepdims=True)           # (Kp, 1)
    sizes_true = c.sum(axis=0, keepdims=True)           # (1, Kt)
    with np.errstate(divide="ignore", invalid="ignore"):
        prec = c / sizes_pred
        rec = c / sizes_true
        f = np.where(prec + rec > 0, 2 * prec * rec / (prec + rec), 0.0)
    return float(f.max(axis=1).mean())


def accuracy(labels_pred: np.ndarray, labels_true: np.ndarray) -> float:
    """Best-map accuracy via Hungarian assignment on the contingency matrix."""
    c = contingency(labels_pred, labels_true)
    k = max(c.shape)
    cost = np.zeros((k, k), dtype=np.int64)
    cost[: c.shape[0], : c.shape[1]] = c
    row, col = linear_sum_assignment(-cost)
    return float(cost[row, col].sum() / len(labels_pred))


METRICS = {"nmi": nmi, "ri": rand_index, "fm": f_measure, "acc": accuracy}


def all_metrics(labels_pred: np.ndarray, labels_true: np.ndarray) -> Dict[str, float]:
    lp = np.asarray(labels_pred)
    lt = np.asarray(labels_true)
    return {name: fn(lp, lt) for name, fn in METRICS.items()}


def average_rank_scores(
    per_method_metrics: Mapping[str, Mapping[str, float]]
) -> Dict[str, float]:
    """Average rank over the 4 metrics (1 = best). Ties share the mean rank.

    Input: {method: {metric: value}}. Lower output is better (paper Table 2).
    """
    methods = list(per_method_metrics)
    metric_names = sorted({m for v in per_method_metrics.values() for m in v})
    ranks: Dict[str, List[float]] = {m: [] for m in methods}
    for metric in metric_names:
        vals = np.array([per_method_metrics[m][metric] for m in methods])
        order = (-vals).argsort(kind="stable")
        rank = np.empty(len(methods))
        # mean rank for ties
        sorted_vals = vals[order]
        i = 0
        while i < len(methods):
            j = i
            while j + 1 < len(methods) and np.isclose(sorted_vals[j + 1], sorted_vals[i]):
                j += 1
            rank[order[i : j + 1]] = (i + j) / 2.0 + 1.0
            i = j + 1
        for m_i, m in enumerate(methods):
            ranks[m].append(float(rank[m_i]))
    return {m: float(np.mean(r)) for m, r in ranks.items()}
