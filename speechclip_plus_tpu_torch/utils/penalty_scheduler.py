"""Piecewise-linear penalty-weight schedule.

Port of ``speechclip_plus_tpu/utils/penalty_scheduler.py`` (reference
``avssl/util/penalty_scheduler.py:4-28``): a weight interpolated over the
global step between (keypoint, value) pairs. Exported by the reference and
unused on the KWClip path.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["PenaltyScheduler"]


class PenaltyScheduler:
    def __init__(self, weights: Sequence[float], keypoints: Sequence[int]):
        if len(weights) != len(keypoints) or list(keypoints) != sorted(keypoints):
            raise ValueError(f"PenaltyScheduler: weights {weights}, keypoints {keypoints}")
        self.weights = np.asarray(weights, np.float64)
        self.keypoints = np.asarray(keypoints, np.int64)
        self.value = float(self.weights[0])

    def update(self, global_step: int) -> None:
        self.value = float(np.interp(global_step, self.keypoints, self.weights))

    def get_value(self) -> float:
        return self.value
