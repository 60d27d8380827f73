"""Audio loading and transforms (host-side, numpy).

Port of ``speechclip_plus_tpu/data/audio.py`` (a copy: the port imports
nothing of the JAX package).

Reference semantics:
  - `BaseDataset` loads wavs at 16 kHz via librosa and optionally
    layer-normalizes the waveform (`avssl/data/base_dataset.py:70-147`);
    librosa is not available here, so decoding uses the stdlib `wave` module
    (Flickr8k/SpokenCOCO are 16-bit PCM) with scipy polyphase resampling for
    non-16k inputs.
  - `random_crop_max_length` (`avssl/data/audio_transforms.py:5-23`): crop a
    random window of at most `max_len` samples at train time.
"""
from __future__ import annotations

import wave
from typing import Optional

import numpy as np

__all__ = ["load_wav", "wav_length", "waveform_layer_norm", "random_crop_max_length"]

TARGET_SR = 16000


def load_wav(path: str, target_sr: int = TARGET_SR) -> np.ndarray:
    """Decode a PCM wav file to float32 mono at `target_sr`."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"Unsupported sample width {width} in {path}")
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    if sr != target_sr:
        from math import gcd

        from scipy.signal import resample_poly

        g = gcd(sr, target_sr)
        data = resample_poly(data, target_sr // g, sr // g).astype(np.float32)
    return data


def wav_length(path: str, target_sr: int = TARGET_SR) -> int:
    """The number of samples `load_wav(path, target_sr)` returns, from the
    header: scipy's polyphase resampling gives ceil(n · up / down)."""
    with wave.open(path, "rb") as w:
        sr, n = w.getframerate(), w.getnframes()
    if sr == target_sr:
        return n
    from math import gcd

    g = gcd(sr, target_sr)
    up, down = target_sr // g, sr // g
    return -(-n * up // down)


def waveform_layer_norm(wav: np.ndarray, eps: float = 1e-5) -> np.ndarray:
    """Zero-mean/unit-var per utterance (torch F.layer_norm over the wav)."""
    mean = wav.mean()
    var = wav.var()
    return ((wav - mean) / np.sqrt(var + eps)).astype(np.float32)


def random_crop_max_length(
    audio: np.ndarray,
    max_len: int,
    orig_len: Optional[int] = None,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """Random window of at most `max_len` samples
    (reference `audio_transforms.py:5-23`)."""
    orig_len = len(audio) if orig_len is None else min(orig_len, len(audio))
    if max_len is None or max_len < 0 or orig_len <= max_len:
        return audio[:orig_len]
    r = rng if rng is not None else np.random
    offset = int(r.randint(0, orig_len - max_len + 1))
    return audio[offset : offset + max_len]
