"""Cross-modal retrieval recall metrics.

Port of ``speechclip_plus_tpu/ops/retrieval.py`` (numpy, stable argsort).

Reference semantics: ``avssl/module/retrieval.py:6-121`` (mutualRetrieval):
argsort score matrices in both directions, recall@k per ``recall_at`` x 100,
plus the mean of both directions. The reference loops per row with in-place
permutation; here it is a single vectorized gather (host-side numpy - the only
device work is the score matmul, done by the caller).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

__all__ = ["mutual_retrieval", "recall_at_k"]


def recall_at_k(
    scores: np.ndarray,
    query_answers: np.ndarray,
    gallery_answers: np.ndarray,
    recall_at: Sequence[int],
) -> Dict[str, float]:
    """Recall@k for one direction.

    Args:
      scores: (Nq, Ng) similarity matrix.
      query_answers: (Nq,) gold pair id per query.
      gallery_answers: (Ng,) pair id of each gallery item.
    """
    scores = np.asarray(scores)
    query_answers = np.asarray(query_answers)
    gallery_answers = np.asarray(gallery_answers)
    assert scores.shape == (len(query_answers), len(gallery_answers)), (
        scores.shape,
        (len(query_answers), len(gallery_answers)),
    )
    order = np.argsort(-scores, axis=1, kind="stable")
    hits = gallery_answers[order] == query_answers[:, None]
    out = {}
    for k in recall_at:
        kk = min(int(k), hits.shape[1])
        out[f"recall@{k}"] = float(hits[:, :kk].any(axis=1).mean() * 100.0)
    return out


def mutual_retrieval(
    score_per_A: np.ndarray,
    score_per_B: np.ndarray,
    AB_answers: np.ndarray,
    BA_answers: np.ndarray,
    recall_at: Sequence[int],
    modality_A_title: str = "audio",
    modality_B_title: str = "image",
) -> Tuple[Dict[str, float], Dict[str, float], Dict[str, float]]:
    """A->B and B->A retrieval recalls plus their mean (all x100)."""
    recall_AB = recall_at_k(score_per_A, AB_answers, BA_answers, recall_at)
    recall_BA = recall_at_k(score_per_B, BA_answers, AB_answers, recall_at)
    recall_mean = {
        k: (recall_AB[k] + recall_BA[k]) / 2.0 for k in recall_AB
    }
    return recall_AB, recall_BA, recall_mean
