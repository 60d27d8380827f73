"""Log-mel filterbank frontend of the mel-input upstreams.

Port of ``speechclip_plus_tpu/ops/mel.py``: the shared frontend of APC,
VQ-APC, TERA, Mockingjay and DeCoAR 2.0, which read 80-dim log-mel features
at a 10 ms hop instead of raw waveforms (the reference's s3prl wrapper,
``avssl/module/speech_encoder_plus.py:110-146``, takes any `s3prl.hub`
upstream).

25 ms window / 10 ms hop at 16 kHz (win=400, hop=160, n_fft=512),
snip-edges framing (no centering), the symmetric Hann window of
`np.hanning`, an HTK-scale triangular filterbank, natural log with a 1e-10
floor. Everything runs in fp32 whatever the model's dtype, as in JAX; the
FFT and the (257, 80) product are library calls (the JAX package computes
them in XLA, outside any Pallas kernel). Padded frames come out as whatever
the zero padding gives: the tower masks them.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["log_mel_spectrogram", "mel_filterbank", "mel_frame_count"]


def mel_frame_count(n_samples: int, win: int = 400, hop: int = 160) -> int:
    """Frames produced by snip-edges framing (no centering)."""
    return max(0, (int(n_samples) - win) // hop + 1)


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(n_mels: int = 80, n_fft: int = 512, sample_rate: int = 16000,
                   fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """(n_fft//2+1, n_mels) triangular HTK-mel filterbank (numpy, cached; do
    not write to the result)."""
    fmax = sample_rate / 2.0 if fmax is None else fmax
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    hz_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    lower, center, upper = hz_pts[:-2], hz_pts[1:-1], hz_pts[2:]
    up = (fft_freqs[:, None] - lower[None, :]) / np.maximum(center - lower, 1e-8)[None, :]
    down = (upper[None, :] - fft_freqs[:, None]) / np.maximum(upper - center, 1e-8)[None, :]
    return np.maximum(0.0, np.minimum(up, down)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _frontend_constants(win: int, n_mels: int, n_fft: int, sample_rate: int, device):
    """The window and the filterbank on `device`, copied there once (a copy
    from the host per call would wait for the device). Do not write to them."""
    window = torch.from_numpy(np.hanning(win).astype(np.float32)).to(device)
    return window, torch.from_numpy(mel_filterbank(n_mels, n_fft, sample_rate)).to(device)


def log_mel_spectrogram(wav: torch.Tensor, *, n_mels: int = 80, win: int = 400,
                        hop: int = 160, n_fft: int = 512,
                        sample_rate: int = 16000) -> torch.Tensor:
    """(B, T) waveform -> (B, n_frames, n_mels) fp32 log-mel features."""
    t = wav.shape[1]
    if mel_frame_count(t, win, hop) == 0:
        raise ValueError(f"waveform too short for one {win}-sample frame: {t}")
    window, fb = _frontend_constants(win, n_mels, n_fft, sample_rate, wav.device)
    frames = wav.float().unfold(1, win, hop)  # (B, nf, win): a strided view
    spec = torch.fft.rfft(frames * window, n=n_fft, dim=-1)  # (B, nf, n_fft//2+1)
    power = spec.real.square() + spec.imag.square()
    return torch.log(torch.clamp_min(power @ fb, 1e-10))
