"""Fused cosine-score -> VQ statistics, forward (K3).

Port of the forward of ``speechclip_plus_tpu/ops/fused_keyword.py`` (Pallas
`_fwd_kernel`, :92, reached by `fused_cosine_vq`, :290): the keyword head's
cosine scores against the normalized CLIP token table and the statistics of
SimpleVectorQuantizer in its eval (hard) form, without an (N, V) tensor in
device memory.

`cosine_vq_stats` returns, for rows x (N, D) and the normalized table en
(V, D): the masked argmax k (N,), the per-row entropy ent (N,) and the column
sums of softmax(s) psum (V,). On a CUDA tensor it runs the hand-written
kernels in ``csrc/fused_keyword.cu``; on a CPU tensor it runs
`plain_cosine_vq_stats`, the same function in plain PyTorch. The gather
`emb[k]` and the perplexity and entropy reductions stay plain torch, as they
are XLA outside the kernel in JAX (:334-366).

Forward only: the straight-through backward (K3b) comes with the training
step; a backward raises.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

__all__ = ["cosine_vq_stats", "plain_cosine_vq_stats", "fused_cosine_vq", "LAUNCHES"]

# wrapper calls that ran the kernels on the card
LAUNCHES = 0

_MASK_VALUE = -1e30


def column_mask(v: int, prob_msk: Sequence[int], device) -> torch.Tensor:
    """(V,) int32, 1 at the excluded codebook ids."""
    mask = torch.zeros(v, dtype=torch.int32)
    for i in prob_msk:
        if 0 <= int(i) < v:
            mask[int(i)] = 1
    return mask.to(device)


def plain_cosine_vq_stats(xn: torch.Tensor, en: torch.Tensor, mask: torch.Tensor):
    """Plain PyTorch twin of the kernels: fp32 scores from the operands'
    values (the TPU's bf16 x bf16 -> fp32 products), masked columns at -1e30."""
    s = xn.float() @ en.float().T
    s = s.masked_fill(mask.bool()[None, :], _MASK_VALUE)
    k = torch.argmax(s, dim=-1).to(torch.int32)
    m = s.max(dim=-1, keepdim=True).values
    e = torch.exp(s - m)
    z = e.sum(dim=-1, keepdim=True)
    ent = torch.log(z[:, 0]) - (e * (s - m)).sum(dim=-1) / z[:, 0]
    psum = (e / z).sum(dim=0)
    return k, ent, psum


def _launch(xn, en, mask):
    global LAUNCHES
    from ..utils.cuda_build import check, kernels

    n, d = xn.shape
    v = en.shape[0]
    if xn.dtype not in (torch.float32, torch.bfloat16) or en.dtype != xn.dtype:
        raise TypeError(f"cosine_vq_stats: dtypes {xn.dtype}, {en.dtype}")
    if en.shape[1] != d or tuple(mask.shape) != (v,) or mask.dtype != torch.int32:
        raise ValueError(f"cosine_vq_stats: shapes x {tuple(xn.shape)}, "
                         f"en {tuple(en.shape)}, mask {tuple(mask.shape)} {mask.dtype}")
    for t in (xn, en, mask):
        if t.device != xn.device or not t.is_contiguous():
            raise ValueError("cosine_vq_stats: inputs must be contiguous on one device")
    lib = kernels()
    splits, row_chunk = lib.sc_vq_splits(), lib.sc_vq_row_chunk()
    chunks = -(-n // row_chunk)
    f32 = dict(dtype=torch.float32, device=xn.device)
    with torch.cuda.device(xn.device):
        part_f = torch.empty(4 * splits * n, **f32)
        part_i = torch.empty(splits * n, dtype=torch.int32, device=xn.device)
        col_part = torch.empty(chunks * v, **f32)
        k = torch.empty(n, dtype=torch.int32, device=xn.device)
        ent, m, z = (torch.empty(n, **f32) for _ in range(3))
        psum = torch.empty(v, **f32)
        check(lib.sc_vq_fwd(xn.data_ptr(), en.data_ptr(), mask.data_ptr(), n, v, d,
                            int(xn.dtype == torch.bfloat16), part_f.data_ptr(),
                            part_i.data_ptr(), col_part.data_ptr(), k.data_ptr(),
                            ent.data_ptr(), m.data_ptr(), z.data_ptr(), psum.data_ptr(),
                            torch.cuda.current_stream().cuda_stream),
              "cosine_vq_stats")
    LAUNCHES += 1
    return k, ent, psum


class _ForwardOnly(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xn, en, mask):
        if xn.device.type == "cpu":
            return plain_cosine_vq_stats(xn, en, mask)
        if xn.device.type != "cuda":
            raise NotImplementedError(f"cosine_vq_stats on {xn.device.type}")
        return _launch(xn, en, mask)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "cosine_vq_stats is forward-only; the straight-through backward "
            "(K3b) is not ported yet")


def cosine_vq_stats(xn: torch.Tensor, en: torch.Tensor, mask: torch.Tensor):
    """xn (N, D), en (V, D) in the compute dtype, mask (V,) int32 ->
    (k (N,) int32, ent (N,) fp32, psum (V,) fp32)."""
    return _ForwardOnly.apply(xn, en, mask)


def fused_cosine_vq(
    xn: torch.Tensor,
    emb: torch.Tensor,
    temp,
    *,
    prob_msk: Sequence[int] = (0, 2, 3),
    dtype: torch.dtype = torch.bfloat16,
) -> Dict[str, torch.Tensor]:
    """Cosine score + SimpleVectorQuantizer, eval (hard) form.

    xn: (B, K, D) L2-normalized keyword vectors; emb: (V, D) raw fp32 token
    embedding (also the codebook); temp: the VQ temperature (reported only).
    Returns the JAX `fused_cosine_vq` result dict without `subword_prob`
    (the (B, K, V) one-hot nothing on the serving path reads)."""
    b, kk, d = xn.shape
    v = emb.shape[0]
    n = b * kk
    embf = emb.float()
    en = (embf / embf.norm(dim=-1, keepdim=True).clamp_min(1e-8)).to(dtype)
    mask = column_mask(v, prob_msk, xn.device)
    k, ent, psum = cosine_vq_stats(xn.reshape(n, d).to(dtype).contiguous(),
                                   en.contiguous(), mask)
    k = k.long()
    avg_probs = psum / n
    hard_probs = torch.bincount(k, minlength=v).float() / n
    perplexity = lambda p: torch.exp(-(p * torch.log(p + 1e-7)).sum())
    result = {
        "num_vars": v,
        "prob_perplexity": perplexity(avg_probs),
        "code_perplexity": perplexity(hard_probs),
        "ent_per_t": ent.reshape(b, kk).mean(dim=0),
        "temp": torch.as_tensor(temp, dtype=torch.float32, device=xn.device),
        "targets": k.reshape(b, kk, 1),
        "keywords": embf[k].reshape(b, kk, d),
    }
    result["diversity_loss"] = (v - result["prob_perplexity"]) / v
    return result
