"""CLIP image preprocessing (host-side, PIL + numpy).

Port of ``speechclip_plus_tpu/data/image.py``. Reference: the official CLIP
transform used via `clip.load`'s preprocess
(`avssl/module/clip_official.py:52,153-166` and
`avssl/data/image_transforms.py:5-18`): bicubic resize of the short side to
N, center crop N x N, RGB, normalize with the CLIP mean/std. Output is
channel-last (H, W, 3) float32, the layout the port's ViT takes
(`models/clip.py` permutes it). PIL is imported where an image is read, so
importing the package needs no PIL.
"""
from __future__ import annotations

import numpy as np

__all__ = ["CLIP_MEAN", "CLIP_STD", "clip_image_transform"]

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


def clip_image_transform(img, size: int = 224) -> np.ndarray:
    """PIL image -> normalized (size, size, 3) float32 array."""
    from PIL import Image

    if img.mode != "RGB":
        img = img.convert("RGB")
    w, h = img.size
    scale = size / min(w, h)
    new_w, new_h = int(round(w * scale)), int(round(h * scale))
    img = img.resize((new_w, new_h), Image.BICUBIC)
    left = (new_w - size) // 2
    top = (new_h - size) // 2
    img = img.crop((left, top, left + size, top + size))
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return (arr - CLIP_MEAN) / CLIP_STD
