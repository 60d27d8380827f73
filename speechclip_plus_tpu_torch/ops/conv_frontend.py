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

No model path calls `conv0` (its output is frame-first and unnormalized);
it exists for regimes where the library convolution regresses. The TPU
kernel's residue-deinterleaved waveform and its `s < k <= 2s` restriction
came from its matrix unit's layout rules and stay behind: any k and s with
T >= k are taken; C must be even.

`conv0_gn_gelu` is layer 0 of a group-norm frontend (HuBERT, WavLM base)
fused into one operation: conv 0, GroupNorm(C, C) with fp32 statistics over
every frame of the utterance (padding included, as fairseq's), exact-erf
GELU, (B, T) -> (B, C, T0) channel-first in the waveform's dtype, with the
rounding points of the composite it replaces (`plain_conv0_gn_gelu`: conv 0
rounded to the dtype, the affine in fp32 rounded, GELU rounded). On a CUDA
tensor it runs three kernels of ``csrc/conv_frontend.cu`` that recompute
conv 0 from the waveform instead of storing it (statistics, a merge of each
channel's tiles in a fixed order, apply); nothing of the activation's size
exists in fp32, and only the summation order of the statistics differs from
the composite. The tower calls it where layer 0 needs no gradient
(``models/hubert.py``); a trainable layer 0 runs the twin through autograd.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["conv0", "plain_conv0", "LAUNCHES", "conv0_gn_gelu", "plain_conv0_gn_gelu",
           "GN_LAUNCHES"]

# wrapper calls that launched the kernel on the card
LAUNCHES = 0
# conv0_gn_gelu calls that launched its three kernels on the card
GN_LAUNCHES = 0
# frames a statistics block of the fused layer 0 covers, and the fp32 words of
# its bf16 GELU table (G_TILE, 2 x G_LUT_N / 2 in csrc/conv_frontend.cu)
_GN_TILE, _GN_LUT_WORDS = 256, 2560


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


def plain_conv0_gn_gelu(wav, weight, gamma, beta, eps: float, stride: int = 5, bias=None):
    """Plain PyTorch twin of `conv0_gn_gelu`, the composite it replaces: conv
    0 in wav's dtype (`F.conv1d`, rounded), per-(utterance, channel) mean and
    variance over time in fp32, the affine in fp32 rounded to the dtype, then
    GELU. Differentiable; `bias` is a conv bias, which the kernel does not
    take."""
    bias = None if bias is None else bias.to(wav.dtype)
    x = F.conv1d(wav[:, None, :], weight.to(wav.dtype), bias, stride)
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    x = (xf * gamma.float()[:, None] + beta.float()[:, None]).to(x.dtype)
    return F.gelu(x)


def _launch_gn(wav, weight, gamma, beta, eps, stride):
    global GN_LAUNCHES
    from ..utils.cuda_build import check, kernels

    b, t = wav.shape
    c, _, k = weight.shape
    if wav.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv0_gn_gelu: wav {wav.dtype} (fp32 or bf16)")
    for name, x in (("weight", weight), ("gamma", gamma), ("beta", beta)):
        if x.device != wav.device:
            raise ValueError(f"conv0_gn_gelu: {name} on {x.device}, wav on {wav.device}")
    if not wav.is_contiguous():
        raise ValueError("conv0_gn_gelu: wav must be contiguous")
    if c % 2:
        raise ValueError(f"conv0_gn_gelu: C={c} must be even")
    if k > 10:
        raise ValueError(f"conv0_gn_gelu: k={k} taps (at most 10)")
    taps = weight[:, 0, :].t().to(wav.dtype).contiguous()  # (k, C)
    g, bt = gamma.float().contiguous(), beta.float().contiguous()
    t0 = (t - k) // stride + 1
    tiles = -(-t0 // _GN_TILE)
    lib = kernels()
    with torch.cuda.device(wav.device):
        out = torch.empty(b, c, t0, dtype=wav.dtype, device=wav.device)
        part = torch.empty(2, b, tiles, c, dtype=torch.float32, device=wav.device)
        stats = torch.empty(2 * b * c + _GN_LUT_WORDS, dtype=torch.float32, device=wav.device)
        check(lib.sc_conv0_gn_gelu(wav.data_ptr(), taps.data_ptr(), g.data_ptr(), bt.data_ptr(),
                                   float(eps), part.data_ptr(), stats.data_ptr(), out.data_ptr(),
                                   b, t, c, k, stride, int(wav.dtype == torch.bfloat16),
                                   torch.cuda.current_stream().cuda_stream), "conv0_gn_gelu")
    GN_LAUNCHES += 1
    return out


def conv0_gn_gelu(wav: torch.Tensor, weight: torch.Tensor, gamma: torch.Tensor,
                  beta: torch.Tensor, eps: float, *, stride: int = 5) -> torch.Tensor:
    """wav (B, T) in the activation dtype, weight (C, 1, k) as `nn.Conv1d`
    holds it (no bias), GroupNorm(C, C)'s gamma and beta (C,) -> GELU(GN(conv
    0)) (B, C, T0) in wav's dtype. Forward only: no gradient flows through
    the kernel."""
    if wav.ndim != 2 or weight.ndim != 3 or weight.shape[1] != 1:
        raise ValueError(f"conv0_gn_gelu: wav {tuple(wav.shape)}, weight "
                         f"{tuple(weight.shape)}; want (B, T) and (C, 1, k)")
    if gamma.shape != (weight.shape[0],) or beta.shape != (weight.shape[0],):
        raise ValueError(f"conv0_gn_gelu: gamma {tuple(gamma.shape)}, beta "
                         f"{tuple(beta.shape)}; want ({weight.shape[0]},)")
    if stride < 1 or wav.shape[1] < weight.shape[2]:
        raise ValueError(f"conv0_gn_gelu: T={wav.shape[1]} shorter than k={weight.shape[2]}, "
                         f"or stride {stride} < 1")
    if wav.device.type == "cpu":
        return plain_conv0_gn_gelu(wav, weight, gamma, beta, eps, stride)
    if wav.device.type != "cuda":
        raise NotImplementedError(f"conv0_gn_gelu on {wav.device.type}")
    return _launch_gn(wav, weight, gamma, beta, eps, stride)
