"""High-level library API (port of ``speechclip_plus_tpu/api.py``).

`SpeechCLIP(model, device)` wraps a KWClip model for inference on ragged
host-side waveform lists: they are padded to the same length buckets as the
JAX package (`_BUCKETS`), int16 PCM stays int16 on the host (half the
transfer bytes) and is scaled by 1/32768 on the device.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .models.kwclip import KWClip, KWClipConfig

__all__ = ["SpeechCLIP"]

_BUCKETS = (16000, 32000, 48000, 64000, 80000, 102400, 160000, 240000)
_PCM16_SCALE = 1.0 / 32768.0


def _wav_to_f32(wav: torch.Tensor) -> torch.Tensor:
    """Device-side dtype gate: float waveforms as-is, int16 PCM scaled."""
    if wav.dtype == torch.int16:
        return wav.to(torch.float32) * _PCM16_SCALE
    return wav


def _pad_wavs(wavs: Sequence[np.ndarray], buckets=_BUCKETS) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a ragged waveform list to a bucketed (B, T) host batch + lengths;
    an all-int16 batch stays int16."""
    lens = np.array([len(w) for w in wavs], np.int64)
    t = int(lens.max())
    t = next((b for b in buckets if t <= b), t)
    dt = np.int16 if all(np.asarray(w).dtype == np.int16 for w in wavs) else np.float32
    out = np.zeros((len(wavs), t), dt)
    for i, w in enumerate(wavs):
        out[i, : len(w)] = np.asarray(w, dt)
    return out, lens


class SpeechCLIP:
    """Inference wrapper: a KWClip model (eval mode) on `device`."""

    def __init__(self, model: KWClip, device="cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()

    @property
    def cfg(self) -> KWClipConfig:
        return self.model.cfg

    def to_device(self, wavs: Sequence[np.ndarray], *, non_blocking: bool = False):
        """Pad on the host and copy (B, T) waveforms + lengths to the device;
        returns (wav fp32, wav_len, host buffers to keep alive until the copy
        has run)."""
        w, lens = _pad_wavs(wavs)
        w_host, l_host = torch.from_numpy(w), torch.from_numpy(lens)
        if non_blocking and self.device.type == "cuda":
            w_host, l_host = w_host.pin_memory(), l_host.pin_memory()
        wav = w_host.to(self.device, non_blocking=non_blocking)
        wav_len = l_host.to(self.device, non_blocking=non_blocking)
        return _wav_to_f32(wav), wav_len, (w_host, l_host)

    @torch.inference_mode()
    def encode_speech(self, wavs: Sequence[np.ndarray]) -> dict:
        """JAX `SpeechCLIP.encode_speech` (reference `kwClip.py:1042-1091`):
        parallel and cascaded features, VQ results, keywords, CIF results."""
        wav, wav_len, _ = self.to_device(wavs)
        return self.model.encode_speech(wav, wav_len)
