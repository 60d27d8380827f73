"""Flash attention forward with a saved log-sum-exp (K4).

Port of ``speechclip_plus_tpu/nn/flash.py`` (Pallas `_fwd_kernel`, :47), the
acoustic tower's opt-in attention for long audio
(`HubertConfig.use_flash_attention`):

    out = softmax(q kᵀ / sqrt(dh) + key_bias) v,   lse = m + log(max(l, 1e-30))

On a CUDA tensor the forward runs the hand-written kernel in
``csrc/flash.cu`` (an online softmax over key tiles; T needs no padding to a
tile multiple). On a CPU tensor it runs `plain_flash_attention`, the same
function in plain PyTorch. There is no fallback from one to the other, and
the TPU knobs (`block_q`, `block_k`, `use_pallas`) stay behind.

`flash_attention` is differentiable: its backward is plain tensor code that
recomputes the weights as exp(s − lse) from the saved log-sum-exp, as the JAX
package's `_flash_bwd` does with XLA einsums (``:169-184``; it has no kernel
there, so it has none here). It materializes (B, H, T, T), which is fine at
training lengths and not for very long sequences.
"""
from __future__ import annotations

from typing import Optional

import torch

from .fused_attention import bhtd_strides, check_bhtd

__all__ = ["flash_attention", "plain_flash_attention", "flash_forward", "LAUNCHES"]

# wrapper calls that launched the kernel on the card
LAUNCHES = 0

_NEG_INF = -1e30


def plain_flash_attention(q, k, v, key_padding_bias=None):
    """Plain PyTorch twin of the kernel: (out in q's dtype, lse (B, H, T) fp32),
    fp32 arithmetic on the operands' values."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if key_padding_bias is not None:
        s = s + key_padding_bias.float()[:, None, None, :]
    m = s.max(dim=-1, keepdim=True).values
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p, v.float()) / l
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def _launch(q, k, v, key_padding_bias):
    global LAUNCHES
    from ..utils.cuda_build import check, kernels

    b, h, t, dh = q.shape
    kb = check_bhtd("flash_attention", q, k, v, key_padding_bias)
    lib = kernels()
    with torch.cuda.device(q.device):
        out = torch.empty(b, t, h, dh, dtype=q.dtype, device=q.device).transpose(1, 2)
        lse = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
        check(lib.sc_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bhtd_strides(q, k, v, out), kb.data_ptr(), lse.data_ptr(), b, h, t, dh,
            int(q.dtype == torch.bfloat16), dh ** -0.5,
            torch.cuda.current_stream().cuda_stream), "flash_attention")
    LAUNCHES += 1
    return out, lse


def flash_forward(q, k, v, key_padding_bias=None):
    """(out, lse) with no autograd: the kernel on CUDA tensors, the twin on
    CPU tensors."""
    if q.device.type == "cpu":
        return plain_flash_attention(q, k, v, key_padding_bias)
    if q.device.type != "cuda":
        raise NotImplementedError(f"flash_attention on {q.device.type}")
    return _launch(q, k, v, key_padding_bias)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias):
        out, lse = flash_forward(q, k, v, bias)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        qf, kf, vf, gf, of = (a.float() for a in (q, k, v, g, out))
        scale = q.shape[-1] ** -0.5
        s = torch.matmul(qf, kf.transpose(-1, -2)) * scale + bias[:, None, None, :]
        p = torch.exp(s - lse[..., None])  # the exact softmax from the saved lse
        dv = torch.matmul(p.transpose(-1, -2), gf)
        dp = torch.matmul(gf, vf.transpose(-1, -2))
        delta = (of * gf).sum(dim=-1, keepdim=True)
        ds = p * (dp - delta)
        dq = torch.matmul(ds, kf) * scale
        dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q kᵀ / sqrt(dh) + mask) v on (B, H, T, dh); key_padding_mask
    (B, T) bool, True = pad. Returns (B, H, T, dh) in q's dtype."""
    b, t = q.shape[0], k.shape[2]
    if key_padding_mask is not None:
        bias = torch.where(key_padding_mask, _NEG_INF, 0.0).to(torch.float32)
    else:
        bias = torch.zeros(b, t, dtype=torch.float32, device=q.device)
    return _Flash.apply(q, k, v, bias)
