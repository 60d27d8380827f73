"""The one traffic generator: a mix is a data file of parameters it reads.

Every input comes from the run's seed. Lengths and image ids come from
numpy's PCG64 on the host; waveform samples and images from one torch
generator on the device, a few large draws, copied to the host where the
program takes host arrays. The same seed gives the same inputs; a different
seed other lengths, samples and ids.

Keys of a mix (``port_bench/traffic/*.json``):
  loop          "train" (Trainer.fit, closed loop) or "search"
                (search_stream, closed loop)
  batch         rows a batch, or "config" for the configuration's batch_size
  min_s, max_s  utterance length, uniform in seconds
  sample_rate   samples a second
  crop          longest row in samples, or "config" for audio_encoder.max_audio_len
  distinct      distinct batches made; the loop cycles over them
  images        images made (the cached-feature pool, or the index)
  k, depth      search: top-k and batches in flight
  check         batches the correctness check compares (train: the first
                steps, each on its own batch; search: a seeded sample)
"""
from __future__ import annotations

import json
from typing import Dict, List

import numpy as np
import torch

__all__ = ["load_mix", "resolve", "image_batch", "train_batches", "search_batches",
           "bucket_of", "pad_batch", "BUCKETS"]

# the program's serving buckets for a ragged batch (a batch pads to the first
# that holds its longest row); a copy, for the reference's padding
BUCKETS = (16000, 32000, 48000, 64000, 80000, 102400, 160000, 240000)


def load_mix(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(mix: dict, yaml_cfg: dict) -> dict:
    """The mix with "config" values taken from the configuration."""
    out = dict(mix)
    if out.get("batch") == "config":
        out["batch"] = int(yaml_cfg["data"]["batch_size"])
    if out.get("crop") == "config":
        out["crop"] = int(yaml_cfg["audio_encoder"]["max_audio_len"])
    return out


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF, int(seed) >> 48, stream])


def _device_gen(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((int(seed) * 1000003 + stream) % (2 ** 63))


def image_batch(seed: int, n: int, resolution: int, device) -> torch.Tensor:
    """(n, H, W, 3) float32 preprocessed images on the device."""
    gen = _device_gen(seed, 7, device)
    return torch.randn((n, resolution, resolution, 3), generator=gen, device=device)


def _lengths(rng, n, mix) -> np.ndarray:
    sr = int(mix["sample_rate"])
    lo, hi = int(round(mix["min_s"] * sr)), int(round(mix["max_s"] * sr))
    return rng.integers(lo, hi + 1, size=n)


def _waves(seed: int, stream: int, rows: int, width: int, device) -> np.ndarray:
    gen = _device_gen(seed, stream, device)
    return torch.randn((rows, width), generator=gen, device=device).cpu().numpy()


def train_batches(mix: dict, seed: int, device) -> List[Dict[str, np.ndarray]]:
    """`distinct` numpy batches as the collate makes them: each row a crop
    of at most `crop` samples, zero-padded to `crop`, with `wav_len`, the
    row's image `id` and `valid`; `image_feat` is filled by the caller from
    the pool."""
    b, crop, n = int(mix["batch"]), int(mix["crop"]), int(mix["distinct"])
    rng = _rng(seed, 1)
    out = []
    for i in range(n):
        lens = np.minimum(_lengths(rng, b, mix), crop)
        wav = _waves(seed, 100 + i, b, crop, device)
        wav[np.arange(crop)[None, :] >= lens[:, None]] = 0.0
        ids = rng.integers(0, int(mix["images"]), size=b)
        out.append({"wav": wav, "wav_len": lens.astype(np.int32), "id": ids.astype(np.int32),
                    "valid": np.ones((b,), bool)})
    return out


def search_batches(mix: dict, seed: int, device) -> List[List[np.ndarray]]:
    """`distinct` batches, each a list of ragged float32 utterances."""
    b, n = int(mix["batch"]), int(mix["distinct"])
    rng = _rng(seed, 2)
    out = []
    for i in range(n):
        lens = _lengths(rng, b, mix)
        wav = _waves(seed, 200 + i, b, int(lens.max()), device)
        out.append([np.ascontiguousarray(wav[j, : lens[j]]) for j in range(b)])
    return out


def bucket_of(n: int) -> int:
    return next((b for b in BUCKETS if n <= b), n)


def pad_batch(wavs: List[np.ndarray]):
    """(B, bucket) float32 and the lengths: the padding the program applies."""
    lens = np.array([len(w) for w in wavs], np.int64)
    out = np.zeros((len(wavs), bucket_of(int(lens.max()))), np.float32)
    for i, w in enumerate(wavs):
        out[i, : len(w)] = w
    return out, lens
