"""Keyword detokenization: nearest CLIP subwords per learned keyword.

Port of ``speechclip_plus_tpu/utils/keyword_extraction.py`` (numpy).

Reference: ``avssl/util/model_utils.py:41-227`` — every N epochs, retrieve
each keyword embedding's top-K neighbor subwords (cosine similarity or
pseudo-inverse projection scores) and dump them with the gold caption to a
``retokenizeText/keywords_ep*.json`` artifact (driven from
``avssl/model/kwClip.py:404-445``).

Simplification: the reference splits work per-GPU shard with
bookkeeping comments; here scores are one (N*Kw, D) x (D, V) numpy/BLAS
matmul over the whole validation set at once.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["KeywordDecoder", "keyword_retrieval_scores", "extract_keyword_neighbors"]


class KeywordDecoder:
    """Token-id -> subword text, through the reduced->original id map when a
    reduced vocabulary is in use (reference `SpeechCLIPDecoder`,
    `model_utils.py:17-28`)."""

    def __init__(self, decoder: Dict[int, str], reduced2original: Optional[Dict[int, int]] = None):
        self.decoder = decoder
        self.reduced2original = reduced2original

    def decode(self, token_id: int) -> str:
        if self.reduced2original is not None:
            token_id = self.reduced2original[int(token_id)]
        return self.decoder[int(token_id)]


def keyword_retrieval_scores(
    keyword_embeddings: np.ndarray,  # (N, D)
    token_embeddings: np.ndarray,  # (V, D)
    retrieve_method: str = "cosine",
) -> np.ndarray:
    """(N, V) retrieval scores (reference `model_utils.py:80-95`)."""
    kw = np.asarray(keyword_embeddings, np.float32)
    emb = np.asarray(token_embeddings, np.float32)
    if retrieve_method == "pseudo_inverse":
        emb_pinv = np.linalg.pinv(emb.T)  # (V, D)
        return kw @ emb_pinv.T
    if retrieve_method == "cosine":
        kwn = kw / np.maximum(np.linalg.norm(kw, axis=-1, keepdims=True), 1e-8)
        embn = emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-8)
        return kwn @ embn.T
    raise NotImplementedError(retrieve_method)


def extract_keyword_neighbors(
    keyword_embeddings: np.ndarray,  # (B, Kmax, D)
    token_embeddings: np.ndarray,  # (V, D)
    gold_texts: Sequence[str],
    decoder: KeywordDecoder,
    K: int = 10,
    retrieve_method: str = "cosine",
    keyword_lengths: Optional[np.ndarray] = None,  # (B,) for dynamic keywords
) -> List[dict]:
    """Top-K neighbor subwords per keyword per utterance.

    Handles both the fixed-K path (`extract_fixed_keyword_neighbors`,
    `model_utils.py:41-124`; `keyword_lengths=None`) and the dynamic path
    (`extract_dynamic_keyword_neighbors`, `:127-227`).
    """
    kw = np.asarray(keyword_embeddings)
    B, kmax, D = kw.shape
    scores = keyword_retrieval_scores(kw.reshape(-1, D), token_embeddings,
                                      retrieve_method).reshape(B, kmax, -1)
    top_idx = np.argsort(-scores, axis=-1)[..., :K]
    top_val = np.take_along_axis(scores, top_idx, axis=-1)

    out: List[dict] = []
    for b in range(B):
        n_kw = int(keyword_lengths[b]) if keyword_lengths is not None else kmax
        neighbors: Dict[str, list] = {}
        for k in range(min(n_kw, kmax)):
            neighbors[f"keyword_{k}"] = [
                [decoder.decode(int(i)), float(v)]
                for i, v in zip(top_idx[b, k], top_val[b, k])
            ]
        out.append({"gold": gold_texts[b], "neighbors": neighbors})
    return out
