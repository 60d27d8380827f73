"""Usage-ranked reduced subword vocabulary.

Port of ``ReducedVocab`` from ``speechclip_plus_tpu/data/tokenizer.py:161``
(reference ``clip_official.py:63-107``), as far as the serving slice uses it:
the table size and the reduced SOT/EOT ids. Pure numpy; the BPE tokenizer and
the id mappings come with text queries (no BPE vocabulary ships with the
repository).
"""
from __future__ import annotations

import numpy as np

__all__ = ["ReducedVocab"]


class ReducedVocab:
    """Built from an (N, 2) [id, freq] array (the
    `assets/*_stat/text_clip_vocab_usage_*.npy` tables)."""

    def __init__(self, usage: np.ndarray, sot_original: int = 49406,
                 eot_original: int = 49407):
        self.selected_ids = np.asarray(usage)[:, 0].astype(np.int64)
        original2reduced = {int(o): i for i, o in enumerate(self.selected_ids)}
        self.sot_reduced = original2reduced[sot_original]
        self.eot_reduced = original2reduced[eot_original]

    @classmethod
    def from_npy(cls, path: str, **kw) -> "ReducedVocab":
        return cls(np.load(path), **kw)

    def __len__(self) -> int:
        return len(self.selected_ids)
