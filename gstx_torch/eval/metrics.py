"""VisDial retrieval metrics: R@1/5/10, Mean rank, MRR, NDCG.

The port's own copy of ``gstx/eval/metrics.py`` (lines 14-100), itself a
vectorized NumPy version of the reference ``utils/visdial_metrics.py``
(same observe/retrieve/reset protocol; the reference's O(n^2) Python
rank-conversion loop, :33-35, becomes a double argsort).  Host code on
numpy arrays: the evaluators bring their scores to the host once a batch.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def scores_to_ranks(scores: np.ndarray) -> np.ndarray:
    """[..., num_options] scores -> 1-based ranks (highest score = rank 1).

    Matches reference visdial_metrics.py:21-39 (descending stable sort):
    equal scores rank in option order.
    """
    scores = np.asarray(scores)
    order = np.argsort(-scores, axis=-1, kind="stable")
    ranks = np.empty_like(order)
    np.put_along_axis(ranks, order,
                      np.broadcast_to(np.arange(scores.shape[-1]),
                                      scores.shape).copy(), axis=-1)
    return ranks + 1


class SparseGTMetrics:
    """R@1/5/10, mean rank, MRR over ground-truth options
    (visdial_metrics.py:41-117)."""

    def __init__(self):
        self._rank_list: List[np.ndarray] = []

    def observe(self, predicted_scores: np.ndarray,
                target_ranks: np.ndarray) -> None:
        scores = np.asarray(predicted_scores)
        b, r, n = scores.shape
        ranks = scores_to_ranks(scores).reshape(b * r, n)
        targets = np.asarray(target_ranks).reshape(b * r).astype(np.int64)
        gt_ranks = ranks[np.arange(b * r), targets]
        self._rank_list.append(gt_ranks.astype(np.float64))

    def retrieve(self, reset: bool = True) -> Dict[str, float]:
        if not self._rank_list:
            return {}
        ranks = np.concatenate(self._rank_list)
        metrics = {
            "r@1": float((ranks <= 1).mean()),
            "r@5": float((ranks <= 5).mean()),
            "r@10": float((ranks <= 10).mean()),
            "mean": float(ranks.mean()),
            "mrr": float((1.0 / ranks).mean()),
        }
        if reset:
            self.reset()
        return metrics

    def reset(self):
        self._rank_list = []


class NDCG:
    """NDCG over the dense-annotated round (visdial_metrics.py:119-195)."""

    def __init__(self):
        self._numerator = 0.0
        self._denominator = 0.0

    def observe(self, predicted_scores: np.ndarray,
                target_relevance: np.ndarray) -> None:
        scores = np.asarray(predicted_scores)
        rel = np.asarray(target_relevance, dtype=np.float64)
        b, n = scores.shape
        ranks = scores_to_ranks(scores[:, None, :])[:, 0, :]  # [B, n]
        k = (rel != 0).sum(-1)  # [B]

        # options in predicted-rank order / in ideal (relevance) order
        rank_order = np.argsort(ranks, axis=-1, kind="stable")
        ideal_order = np.argsort(-rel, axis=-1, kind="stable")

        discounts = 1.0 / np.log2(np.arange(n) + 2.0)
        for i in range(b):
            ki = int(k[i])
            dcg = (rel[i, rank_order[i, :ki]] * discounts[:ki]).sum()
            idcg = (rel[i, ideal_order[i, :ki]] * discounts[:ki]).sum()
            self._numerator += float(dcg / idcg) if idcg > 0 else 0.0
        self._denominator += b

    def retrieve(self, reset: bool = True) -> Dict[str, float]:
        if self._denominator == 0:
            return {}
        out = {"ndcg": float(self._numerator / self._denominator)}
        if reset:
            self.reset()
        return out

    def reset(self):
        self._numerator = 0.0
        self._denominator = 0.0
