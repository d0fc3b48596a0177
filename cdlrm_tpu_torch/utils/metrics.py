"""Host-side metrics.

The reference reports only rounded-prediction accuracy
(main_no_ddp.py:431,490-492); AUC thresholds are parsed but
never computed (main_no_ddp.py:119-120). We keep accuracy for parity and add a
real AUC (BASELINE.json requires AUC parity as the north-star metric).
"""

from __future__ import annotations

import numpy as np


def accuracy_count(scores: np.ndarray, targets: np.ndarray) -> int:
    """Number of rounded predictions matching targets (reference semantics:
    ``np.sum(np.round(S, 0) == T)``, main_no_ddp.py:431)."""
    return int(np.sum((np.round(scores, 0) == targets).astype(np.uint32)))


def roc_auc(scores: np.ndarray, targets: np.ndarray) -> float:
    """ROC AUC via the rank-statistic (Mann-Whitney U) formulation.

    Equivalent to sklearn.metrics.roc_auc_score for binary targets; implemented
    directly so we don't depend on sklearn. Ties are handled with midranks.
    """
    scores = np.asarray(scores, dtype=np.float64).ravel()
    targets = np.asarray(targets).ravel()
    pos = targets > 0.5
    n_pos = int(pos.sum())
    n_neg = targets.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(scores.size, dtype=np.float64)
    sorted_scores = scores[order]
    # midranks for ties
    i = 0
    while i < scores.size:
        j = i
        while j + 1 < scores.size and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    sum_pos_ranks = ranks[pos].sum()
    u = sum_pos_ranks - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


class StreamingAUC:
    """Histogram-bucketed streaming AUC for large eval sets.

    Scores must lie in [0, 1] (they do: DLRM outputs a sigmoid,
    model_no_ddp.py:306-316). Exact up to bucket resolution.
    """

    def __init__(self, num_buckets: int = 100_000):
        self.num_buckets = num_buckets
        self._pos = np.zeros(num_buckets, dtype=np.int64)
        self._neg = np.zeros(num_buckets, dtype=np.int64)

    def update(self, scores: np.ndarray, targets: np.ndarray) -> None:
        scores = np.asarray(scores, dtype=np.float64).ravel()
        targets = np.asarray(targets).ravel()
        b = np.clip((scores * self.num_buckets).astype(np.int64), 0, self.num_buckets - 1)
        pos = targets > 0.5
        np.add.at(self._pos, b[pos], 1)
        np.add.at(self._neg, b[~pos], 1)

    def result(self) -> float:
        n_pos = self._pos.sum()
        n_neg = self._neg.sum()
        if n_pos == 0 or n_neg == 0:
            return float("nan")
        # For each bucket: negatives strictly below + half of ties.
        neg_below = np.cumsum(self._neg) - self._neg
        u = np.sum(self._pos * (neg_below + 0.5 * self._neg))
        return float(u / (n_pos * n_neg))
