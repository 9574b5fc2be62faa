"""Classification metrics (deepfake_tpu/utils/metrics.py)."""

from __future__ import annotations

import numpy as np


def roc_auc(scores, labels) -> float:
    """Exact ROC-AUC via the rank statistic (Mann-Whitney U), tie-aware, in
    numpy float64 on the host; nan when empty or when one class is absent."""
    scores = np.asarray(scores, np.float64).reshape(-1)
    labels = np.asarray(labels, np.float64).reshape(-1)
    n = scores.shape[0]
    if n == 0:
        return float("nan")
    order = np.argsort(scores, kind="stable")
    s_sorted = scores[order]
    l_sorted = labels[order]
    # average ranks over runs of tied scores
    idx = np.arange(n, dtype=np.float64)
    is_new = np.concatenate([[True], s_sorted[1:] != s_sorted[:-1]])
    grp = np.cumsum(is_new) - 1
    n_grp = int(grp[-1]) + 1
    grp_first = np.full(n_grp, np.inf)
    np.minimum.at(grp_first, grp, idx)
    grp_last = np.full(n_grp, -np.inf)
    np.maximum.at(grp_last, grp, idx)
    ranks = (grp_first[grp] + grp_last[grp]) / 2.0 + 1.0
    n_pos = float(np.sum(l_sorted))
    n_neg = n - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    sum_pos_ranks = float(np.sum(ranks * l_sorted))
    return (sum_pos_ranks - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)
