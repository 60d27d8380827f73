"""Frozen image-tower embedding cache.

Port of ``speechclip_plus_tpu/data/image_cache.py``. The CLIP image encoder
is frozen in every released SpeechCLIP(+) config
(`clip.image_encoder_trainable: false`), yet the reference re-encodes every
image on every training step (`kwClip.py:854`). Computing the
(pre-projection) image features once removes the image tower and the per-step
JPEG decode from the training loop; the trainable projection and the
normalization still run in the step (`models/kwclip.py:project_image_feat`).

The features are computed on the model's device by `KWClip.encode_image_raw`
(the ViT's 12 blocks through K1) in batches of a fixed size, the last one
padded with zeros, and kept on the host as float32 numpy. torch is imported
where the features are computed: loader workers unpickle
`CachedImageDataset` and need no torch.
"""
from __future__ import annotations

import logging
from typing import Dict

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["precompute_image_embeddings", "CachedImageDataset"]


def precompute_image_embeddings(model, dataset, batch_size: int = 64) -> Dict[str, np.ndarray]:
    """path -> raw frozen image feature (np.float32 (D,))."""
    import torch
    from PIL import Image

    from .image import clip_image_transform

    paths = sorted({s.image_path for s in dataset.data if s.image_path})
    device = next(model.parameters()).device
    size = model.cfg.clip.image_resolution
    out: Dict[str, np.ndarray] = {}
    for i in range(0, len(paths), batch_size):
        chunk = paths[i : i + batch_size]
        imgs = []
        for p in chunk:
            with Image.open(p) as im:
                imgs.append(clip_image_transform(im, size))
        arr = np.stack(imgs).astype(np.float32)
        if len(chunk) < batch_size:  # pad to the batch shape
            arr = np.concatenate(
                [arr, np.zeros((batch_size - len(chunk),) + arr.shape[1:], np.float32)])
        with torch.no_grad():
            feats = model.encode_image_raw(torch.from_numpy(arr).to(device))
        feats = feats.float().cpu().numpy()
        for p, f in zip(chunk, feats):
            out[p] = f
    logger.info("cached %d image embeddings", len(out))
    return out


class CachedImageDataset:
    """Wraps a dataset: items carry `image_feat` instead of `image`."""

    def __init__(self, dataset, feats: Dict[str, np.ndarray]):
        self.dataset = dataset
        self.dataset.load_image = False  # skip per-item JPEG decode entirely
        self.feats = feats
        self.data = dataset.data

    def __len__(self) -> int:
        return len(self.dataset)

    def wav_length(self, index: int) -> int:
        return self.dataset.wav_length(index)

    def __getitem__(self, index: int):
        s = self.dataset.data[index]
        item = dict(self.dataset[index])
        item.pop("image", None)
        if s.image_path is not None:
            item["image_feat"] = self.feats[s.image_path]
        return item
