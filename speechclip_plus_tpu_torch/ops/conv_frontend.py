"""Waveform convolution: the acoustic frontend's layer 0 (K6).

Port of ``speechclip_plus_tpu/ops/conv_frontend.py`` (Pallas `_conv0_kernel`,
:45, via `conv0_pallas`, :64):

    out[b, f, c] = Σ_{j<k} wav[b, s·f + j] · K[j, 0, c],   T0 = (T − k)//s + 1

VALID, fp32 accumulation, (B, T) × (k, 1, C) → (B, T0, C) in `out_dtype`; the
taps are used in the waveform's dtype, as on the JAX side. On a CUDA tensor
it runs the hand-written kernel in ``csrc/conv_frontend.cu`` (bound by the
output write: coalesced channel-pair stores, the waveform strip and the taps
staged in shared memory). On a CPU tensor it runs `plain_conv0`, the tap sum
in plain PyTorch. There is no fallback from one to the other.

As in the JAX package, no model path calls it (the tower's frontend runs its
library convolution); it exists for regimes where that lowering regresses.
The TPU kernel's residue-deinterleaved waveform and its `s < k <= 2s`
restriction came from its matrix unit's layout rules and stay behind: any
k and s with T >= k are taken; C must be even.
"""
from __future__ import annotations

import torch

__all__ = ["conv0", "plain_conv0", "LAUNCHES"]

# wrapper calls that launched the kernel on the card
LAUNCHES = 0


def plain_conv0(wav, kernel, stride: int = 5, out_dtype=torch.float32):
    """Plain PyTorch twin of the kernel: the sum over taps, in tap order, in
    fp32 on the operands' values."""
    k, _, c = kernel.shape
    t0 = (wav.shape[1] - k) // stride + 1
    taps = kernel[:, 0, :].to(wav.dtype).float()
    out = torch.zeros(wav.shape[0], t0, c, dtype=torch.float32, device=wav.device)
    for j in range(k):
        cols = wav[:, j: j + stride * (t0 - 1) + 1: stride].float()
        out = out + cols[:, :, None] * taps[j]
    return out.to(out_dtype)


def _launch(wav, kernel, stride, out_dtype):
    global LAUNCHES
    from ..utils.cuda_build import check, kernels

    b, t = wav.shape
    k, _, c = kernel.shape
    for name, dt in (("wav", wav.dtype), ("out_dtype", out_dtype)):
        if dt not in (torch.float32, torch.bfloat16):
            raise TypeError(f"conv0: {name} {dt} (fp32 or bf16)")
    if kernel.device != wav.device:
        raise ValueError(f"conv0: kernel on {kernel.device}, wav on {wav.device}")
    if not wav.is_contiguous():
        raise ValueError("conv0: wav must be contiguous")
    if c % 2:
        raise ValueError(f"conv0: C={c} must be even")
    taps = kernel[:, 0, :].to(wav.dtype).contiguous()
    t0 = (t - k) // stride + 1
    lib = kernels()
    with torch.cuda.device(wav.device):
        out = torch.empty(b, t0, c, dtype=out_dtype, device=wav.device)
        check(lib.sc_conv0(wav.data_ptr(), taps.data_ptr(), out.data_ptr(), b, t, c, k,
                           stride, int(wav.dtype == torch.bfloat16),
                           int(out_dtype == torch.bfloat16),
                           torch.cuda.current_stream().cuda_stream), "conv0")
    LAUNCHES += 1
    return out


def conv0(wav: torch.Tensor, kernel: torch.Tensor, *, stride: int = 5,
          out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """wav (B, T), kernel (k, 1, C) in the JAX layout -> (B, T0, C) in
    `out_dtype`. Equivalent to a VALID 1-D convolution of the one-channel
    waveform with `stride`."""
    if wav.ndim != 2 or kernel.ndim != 3 or kernel.shape[1] != 1:
        raise ValueError(f"conv0: wav {tuple(wav.shape)}, kernel {tuple(kernel.shape)}; "
                         "want (B, T) and (k, 1, C)")
    if stride < 1 or wav.shape[1] < kernel.shape[0]:
        raise ValueError(f"conv0: T={wav.shape[1]} shorter than k={kernel.shape[0]}, "
                         f"or stride {stride} < 1")
    if wav.device.type == "cpu":
        return plain_conv0(wav, kernel, stride, out_dtype)
    if wav.device.type != "cuda":
        raise NotImplementedError(f"conv0 on {wav.device.type}")
    return _launch(wav, kernel, stride, out_dtype)
