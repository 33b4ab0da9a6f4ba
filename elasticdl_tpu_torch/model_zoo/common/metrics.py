"""Host-side eval metrics shared by zoo models (the port's copy of the
JAX zoo's model_zoo/common/metrics.py; numpy, same behaviour)."""

from __future__ import annotations

import numpy as np


def auc(labels: np.ndarray, predictions: np.ndarray) -> float:
    """Binary AUC via the Mann-Whitney rank statistic (no sklearn).
    `predictions` may be logits or probabilities: AUC is invariant to
    monotone transforms."""
    labels = np.asarray(labels).reshape(-1)
    scores = np.asarray(predictions).reshape(-1)
    pos = scores[labels == 1]
    neg = scores[labels == 0]
    if len(pos) == 0 or len(neg) == 0:
        return 0.5
    # tie-averaged ranks via one stable sort
    all_scores = np.concatenate([pos, neg])
    order = np.argsort(all_scores, kind="mergesort")
    sorted_scores = all_scores[order]
    avg_rank = np.empty(len(all_scores))
    i = 0
    while i < len(sorted_scores):
        j = i
        while (j + 1 < len(sorted_scores)
               and sorted_scores[j + 1] == sorted_scores[i]):
            j += 1
        avg_rank[order[i: j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    rank_sum_pos = avg_rank[: len(pos)].sum()
    n_pos, n_neg = len(pos), len(neg)
    return float(
        (rank_sum_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)
    )


def binary_accuracy(labels, predictions, threshold=0.0):
    """Accuracy for logit predictions (threshold 0 == probability 0.5)."""
    labels = np.asarray(labels).reshape(-1)
    preds = np.asarray(predictions).reshape(-1)
    return float(np.mean((preds > threshold) == (labels > 0.5)))
