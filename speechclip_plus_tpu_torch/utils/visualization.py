"""Embedding-space PCA visualization.

Port of ``speechclip_plus_tpu/utils/visualization.py``: without matplotlib
or scikit-learn it logs a warning and draws nothing, as the JAX package does.

Reference: ``avssl/util/embedding_visualization.py:8-41`` — PCA of keyword
embeddings vs CLIP token embeddings, scatter plot saved as PDF under
``visualization/pca_ep*.pdf`` (invoked at `kwClip.py:362-377`). The reference
uses plotly+kaleido; this uses sklearn + matplotlib.
"""
from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["draw_embedding_space_pca"]


def draw_embedding_space_pca(
    kw_embs: np.ndarray, gold_embs: np.ndarray, output_path: str,
    max_points: int = 5000,
) -> None:
    """2-component PCA scatter of keyword vs gold token embeddings."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from sklearn.decomposition import PCA
    except Exception:  # matplotlib or scikit-learn not installed
        logger.warning("matplotlib/sklearn unavailable; skipping PCA plot")
        return

    kw = np.asarray(kw_embs, np.float32).reshape(-1, np.asarray(kw_embs).shape[-1])
    gold = np.asarray(gold_embs, np.float32)
    rng = np.random.RandomState(0)
    if len(kw) > max_points:
        kw = kw[rng.choice(len(kw), max_points, replace=False)]
    if len(gold) > max_points:
        gold = gold[rng.choice(len(gold), max_points, replace=False)]

    pca = PCA(n_components=2).fit(np.concatenate([gold, kw], axis=0))
    g2, k2 = pca.transform(gold), pca.transform(kw)

    fig, ax = plt.subplots(figsize=(8, 8))
    ax.scatter(g2[:, 0], g2[:, 1], s=2, alpha=0.3, label="CLIP tokens")
    ax.scatter(k2[:, 0], k2[:, 1], s=2, alpha=0.3, label="keywords")
    ax.legend()
    ax.set_title("Keyword vs CLIP token embedding space (PCA)")
    fig.savefig(output_path, bbox_inches="tight")
    plt.close(fig)
