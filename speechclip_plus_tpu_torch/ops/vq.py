"""Vector quantization onto the CLIP subword codebook: the materialized route.

Port of ``speechclip_plus_tpu/ops/vq.py`` (reference
``my_vector_quantizer.py:12-165``) for a (B, T, V) score tensor: special-token
columns masked to -1e30, hard argmax, the codebook statistics on a
stop-gradient basis, and in training the straight-through softmax at a
temperature, with Gumbel noise from the caller's generator, or the soft
(`hard=False`) probabilities. `st_codebook_matmul` is JAX's fused
straight-through form: the keywords `codebook[argmax]` as a gather, with the
estimator's exact gradient into the scores, the codebook and the temperature.

The keyword head takes this route where the configuration selects it, as JAX
does (``models/branches.py:231-252``): `fused_score_kernel` off (a trainable
text tower turns it off, since K3 and K3b give no codebook gradient), or a
training form that is not straight-through (Gumbel, `hard: false`), or
`time_first: false`. Otherwise the head takes K3 / K3b
(``ops/fused_keyword.py``), which never builds the (B, T, V) tensor.

The batch-reduced statistics (the code and prob perplexities, `ent_per_t`,
`diversity_loss`) are logs, never trained on; with a data-parallel `group`
(``parallel/mesh.py``) they are taken over the global batch, as JAX's
global-view step takes them.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..parallel.mesh import global_mean

__all__ = ["simple_vector_quantizer", "scheduled_temperature", "st_codebook_matmul"]

_MASK_VALUE = -1e30


class _STCodebookMatmul(torch.autograd.Function):
    """keywords = codebook[argmax(scores)] in fp32; backward, with
    z = s / t, p = softmax(z), u = g codebookᵀ, dz = p (u - Σ p u):
    ds = dz / t, dcodebook = onehot(argmax)ᵀ g, dt = Σ dz (-s / t²)
    (JAX `_st_cm_bwd`)."""

    @staticmethod
    def forward(ctx, scores, codebook, temp):
        flat = scores.reshape(-1, scores.shape[-1])
        k = torch.argmax(flat, dim=-1)
        ctx.save_for_backward(scores, codebook, temp, k)
        return codebook.float()[k].reshape(*scores.shape[:-1], codebook.shape[-1])

    @staticmethod
    def backward(ctx, g):
        scores, codebook, temp, k = ctx.saved_tensors
        v, d = scores.shape[-1], g.shape[-1]
        s = scores.reshape(-1, v).float()
        g2 = g.reshape(-1, d).float()
        t = temp.float()
        cb = codebook.float()
        p = torch.softmax(s / t, dim=-1)
        u = g2 @ cb.T
        dz = p * (u - (p * u).sum(dim=-1, keepdim=True))
        ds = (dz / t).to(scores.dtype).reshape(scores.shape)
        dcb = torch.zeros(v, d, dtype=torch.float32, device=g.device).index_add_(0, k, g2)
        dt = (dz * (-s / (t * t))).sum().reshape(temp.shape)
        return ds, dcb.to(codebook.dtype), dt.to(temp.dtype)


def st_codebook_matmul(scores: torch.Tensor, codebook: torch.Tensor,
                       temp: torch.Tensor) -> torch.Tensor:
    """(..., V) masked scores, (V, D) codebook, 0-d temperature -> (..., D)
    fp32 keywords with the straight-through gradient (JAX
    `st_codebook_matmul`)."""
    return _STCodebookMatmul.apply(scores, codebook, temp)


def scheduled_temperature(max_temp: float, min_temp: float, decay: float, num_updates,
                          device=None) -> torch.Tensor:
    """max(max_temp · decay^step, min_temp) in fp32 on `device` (reference
    ``my_vector_quantizer.py:58-62``): the step is a host integer (the
    optimizer step) and the value is formed on the device, so reading it
    never waits for the card."""
    f32 = dict(dtype=torch.float32, device=device)
    step = torch.full((), float(0 if num_updates is None else num_updates), **f32)
    return torch.clamp(max_temp * torch.pow(torch.full((), decay, **f32), step), min=min_temp)


def simple_vector_quantizer(
    x: torch.Tensor,
    *,
    temp,
    prob_msk: Sequence[int] = (0, 2, 3),
    training: bool = False,
    use_gumbel: bool = False,
    hard: bool = True,
    generator: Optional[torch.Generator] = None,
    ground_truth_perplexity: Optional[float] = None,
    time_first: bool = True,
    codebook: Optional[torch.Tensor] = None,
    fused_st: bool = True,
    group=None,
) -> Dict[str, torch.Tensor]:
    """x: (B, T, V) cosine scores ((B, V, T) with `time_first=False`); temp a
    float or a 0-d tensor (which may take a gradient). Returns code/prob
    perplexity, ent_per_t (T,), diversity_loss, temp, targets (B, T, 1),
    subword_prob (B, T, V) and, with a (V, D) `codebook`, keywords (fp32).
    Gumbel noise comes from `generator`, which it then requires; `group`
    takes the statistics over the data-parallel global batch."""
    if not time_first:
        x = x.transpose(1, 2)
    b, t, v = x.shape
    dev = x.device
    temp = torch.as_tensor(temp, dtype=torch.float32, device=dev)
    flat = x.reshape(b * t, v)
    if len(prob_msk) > 0:
        special = torch.zeros(v, dtype=torch.bool, device=dev)
        special[[int(i) for i in prob_msk if 0 <= int(i) < v]] = True
        flat = flat.masked_fill(special[None, :], _MASK_VALUE)
    k = torch.argmax(flat, dim=-1)
    hard_x = torch.nn.functional.one_hot(k, v).to(flat.dtype)

    # the statistics are logged, never trained on (JAX :214-224)
    flat_sg = flat.detach().float()
    perplexity = lambda p: torch.exp(-(p * torch.log(p + 1e-7)).sum())
    hard_probs = torch.zeros(v, device=dev).index_add_(0, k, torch.ones(b * t, device=dev)) \
        / (b * t)
    soft_all = torch.softmax(flat_sg, dim=-1)
    result = {
        "num_vars": v,
        "code_perplexity": perplexity(global_mean(hard_probs, group)),
        "prob_perplexity": perplexity(global_mean(soft_all.mean(dim=0), group)),
        "ent_per_t": global_mean((-(soft_all * torch.log(soft_all + 1e-9)).sum(dim=-1))
                                 .reshape(b, t).mean(dim=0), group),
        "temp": temp.detach(),
    }
    out_k = k
    use_fused = fused_st and codebook is not None and ((not training) or (hard and not use_gumbel))
    if training:
        if use_gumbel:
            if generator is None:
                raise ValueError("Gumbel sampling requires a generator")
            uni = torch.rand(flat.shape, generator=generator, device=dev) * (1.0 - 1e-10) + 1e-10
            gumbel = -torch.log(-torch.log(uni))
            soft = torch.softmax((flat.float() + gumbel) / temp, dim=-1).to(flat.dtype)
            out_k = torch.argmax(soft, dim=-1)
            if hard:
                g_hard = torch.nn.functional.one_hot(out_k, v).to(flat.dtype)
                out = g_hard + soft - soft.detach()
            else:
                out = soft
        elif hard and use_fused:
            out = hard_x  # the keywords take `st_codebook_matmul`
        else:
            soft = torch.softmax(flat.float() / temp, dim=-1).to(flat.dtype)
            out = hard_x + soft - soft.detach() if hard else soft
    else:
        out = hard_x
    result["subword_prob"] = out.reshape(b, t, v)
    if codebook is not None:
        if use_fused and training:
            result["keywords"] = st_codebook_matmul(flat.reshape(b, t, v), codebook, temp)
        elif use_fused:
            result["keywords"] = codebook.float()[k].reshape(b, t, -1)
        else:
            result["keywords"] = torch.einsum("btv,vd->btd", result["subword_prob"].float(),
                                              codebook.float())
    if ground_truth_perplexity is not None:
        gt = float(ground_truth_perplexity)
        result["diversity_loss"] = (result["prob_perplexity"] - gt) ** 2 / (v - gt) ** 2
    else:
        result["diversity_loss"] = (v - result["prob_perplexity"]) / v
    result["targets"] = out_k.reshape(b, t, 1)
    return result
