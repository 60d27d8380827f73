"""Frozen CLIP towers (ViT image tower, causal text tower).

Port of ``speechclip_plus_tpu/models/clip.py`` (reference
``avssl/module/clip_official.py``): pre-norm blocks with quick-GELU MLPs and
packed-QKV attention. The vision tower's attention runs through the fused
attention block with the out-projection fused in (K1). The text tower keeps
the plain path with its causal mask by default, as in JAX;
`ClipConfig.text_fused_attention_vjp` (the `clip.text_fused_attention_vjp`
key) routes it through the differentiable block instead (K1 context-only
forward, K2 backward, the causal mask as their per-head bias; JAX
``:181-199``), for a frozen tower whose keyword inputs take gradients.
`text_remat_mode` recomputes the text blocks ("full") or their attention
("attn") in the backward with `torch.utils.checkpoint` instead of saving
their activations ("none"); values and gradients are the same in every mode.

Every module computes in `ClipConfig.dtype` and casts its parameters to it at
use, so a trainable tower (`clip.image_encoder_trainable`,
`clip.text_encoder_trainable`; JAX ``models/kwclip.py:204-221``, ``:811``,
``:909``) can hold fp32 masters (`KWClip` casts them); a trainable ViT takes
the plain attention (`ClipModel(vision_kernel=False)`: K1 is forward-only).

`encode_keywords` (``clip.py:404-439``) builds [SOT, kw_1..kw_n, EOT, 0...]
over the static context with selects, so the keyword count is data, and pools
at the EOT slot; `TextTransformer.forward` finds EOT by its id, not by argmax
(the reduced vocabulary puts EOT at id 3). Images are NHWC at the public
surface, like JAX.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..nn.attention import MultiheadAttention
from ..nn.transformer import LayerNorm
from ..parallel.tp import copy_to_model, reduce_from_model, row_parallel_linear

__all__ = ["ClipConfig", "ClipModel", "VisionTransformer", "TextTransformer"]


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    embed_dim: int = 512
    image_resolution: int = 224
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    vision_patch_size: int = 32
    context_length: int = 77
    vocab_size: int = 49408
    text_width: int = 512
    text_heads: int = 8
    text_layers: int = 12
    sot_id: int = 49406
    eot_id: int = 49407
    # the text tower's attention through K1 + K2 (frozen tower only)
    text_fused_attention_vjp: bool = False
    # what the text tower recomputes in the backward: "full" (each block),
    # "attn" (each block's attention) or "none"; ignored with the fused route,
    # which saves no (B, H, T, T) tensor to begin with
    text_remat_mode: str = "none"
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.text_remat_mode not in ("full", "attn", "none"):
            raise ValueError(f"text_remat_mode {self.text_remat_mode!r}: full, attn or none")

    @staticmethod
    def vit_b32() -> "ClipConfig":
        return ClipConfig()

    @staticmethod
    def vit_l14() -> "ClipConfig":
        """ViT-L/14 (JAX ``models/clip.py:89-99``): 257 tokens at 224, 16 heads
        of 64; a 768-wide text tower with 12 heads."""
        return ClipConfig(embed_dim=768, vision_width=1024, vision_layers=24, vision_heads=16,
                          vision_patch_size=14, text_width=768, text_heads=12, text_layers=12)

    @staticmethod
    def tiny(**kw) -> "ClipConfig":
        """`speechclip_plus_tpu.models.clip.ClipConfig.tiny`."""
        defaults = dict(embed_dim=16, image_resolution=32, vision_width=24, vision_layers=2,
                        vision_heads=2, vision_patch_size=16, context_length=16, vocab_size=64,
                        text_width=32, text_heads=4, text_layers=2, sot_id=62, eot_id=63)
        defaults.update(kw)
        return ClipConfig(**defaults)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _remat(fn, x: torch.Tensor, *args) -> torch.Tensor:
    """fn(x, *args), recomputed in the backward when x takes a gradient."""
    if torch.is_grad_enabled() and x.requires_grad:
        return checkpoint(fn, x, *args, use_reentrant=False)
    return fn(x, *args)


class ResidualAttentionBlock(nn.Module):
    """Pre-norm block. `fused_vjp` sends the attention, mask included, through
    the differentiable fused block (K1 + K2); `remat_attn` recomputes the
    plain attention in the backward."""

    def __init__(self, d_model: int, n_head: int, dtype: torch.dtype, fused_vjp: bool = False,
                 remat_attn: bool = False, kernel: bool = True):
        super().__init__()
        self.fused_vjp, self.remat_attn, self.cd = fused_vjp, remat_attn, dtype
        self.ln_1 = LayerNorm(d_model, dtype=dtype)
        self.attn = MultiheadAttention(d_model, n_head, fuse_out=not fused_vjp, dtype=dtype,
                                       kernel=kernel)
        self.ln_2 = LayerNorm(d_model, dtype=dtype)
        self.c_fc = nn.Linear(d_model, 4 * d_model, dtype=dtype)
        self.c_proj = nn.Linear(4 * d_model, d_model, dtype=dtype)
        self.tp = None  # the model group when the MLP is sharded (parallel/tp.py)

    def _attend(self, h: torch.Tensor, attn_mask=None) -> torch.Tensor:
        if self.fused_vjp:
            # the mask rides the kernels as their per-head bias: (T, T),
            # (1, T, T) or (H, T, T); any other shape raises there (JAX cuts a
            # 4-D bias to its first entry, ``:188-189``)
            return self.attn(h, attn_bias=attn_mask)
        return self.attn(h, attn_mask=attn_mask)

    def forward(self, x: torch.Tensor, attn_mask=None) -> torch.Tensor:
        h = self.ln_1(x)
        if self.remat_attn and not self.fused_vjp:
            x = x + _remat(self._attend, h, attn_mask)
        else:
            x = x + self._attend(h, attn_mask)
        cd, fc, proj = self.cd, self.c_fc, self.c_proj
        if self.tp is not None:  # c_fc column-parallel, c_proj row-parallel
            h = copy_to_model(self.ln_2(x), self.tp)
            h = quick_gelu(F.linear(h, fc.weight.to(cd), fc.bias.to(cd)))
            return x + row_parallel_linear(h, proj.weight.to(cd), proj.bias.to(cd), self.tp, cd)
        h = quick_gelu(F.linear(self.ln_2(x), fc.weight.to(cd), fc.bias.to(cd)))
        return x + F.linear(h, proj.weight.to(cd), proj.bias.to(cd))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, dtype: torch.dtype,
                 fused_vjp: bool = False, remat: str = "none", kernel: bool = True):
        super().__init__()
        # the fused route saves only each layer's input and K1's qkv and lse,
        # so recomputing on top of it would rerun the forward for nothing
        self.remat_full = remat == "full" and not fused_vjp
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, dtype, fused_vjp=fused_vjp,
                                   remat_attn=remat == "attn", kernel=kernel)
            for _ in range(layers))

    def forward(self, x: torch.Tensor, attn_mask=None) -> torch.Tensor:
        for block in self.blocks:
            x = _remat(block, x, attn_mask) if self.remat_full else block(x, attn_mask)
        return x


class VisionTransformer(nn.Module):
    """Patch conv -> [CLS; patches] + pos -> ln_pre -> blocks -> ln_post(CLS) @ proj."""

    def __init__(self, c: ClipConfig, kernel: bool = True):
        super().__init__()
        w, p, dt = c.vision_width, c.vision_patch_size, c.dtype
        self.cd = dt
        self.conv1 = nn.Conv2d(3, w, p, stride=p, bias=False, dtype=dt)
        self.class_embedding = nn.Parameter(torch.zeros(w, dtype=dt))
        n_pos = (c.image_resolution // p) ** 2 + 1
        self.positional_embedding = nn.Parameter(torch.zeros(n_pos, w, dtype=dt))
        self.ln_pre = LayerNorm(w, dtype=dt)
        self.transformer = Transformer(w, c.vision_layers, c.vision_heads, dt, kernel=kernel)
        self.ln_post = LayerNorm(w, dtype=dt)
        self.proj = nn.Parameter(torch.zeros(w, c.embed_dim, dtype=dt))

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        """image (B, H, W, 3) -> (B, embed_dim)."""
        cd = self.cd
        x = F.conv2d(image.permute(0, 3, 1, 2).to(cd), self.conv1.weight.to(cd),
                     stride=self.conv1.stride)
        x = x.flatten(2).transpose(1, 2)                            # (B, P, W)
        cls = self.class_embedding.to(cd).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(cd)
        x = self.transformer(self.ln_pre(x))
        return self.ln_post(x[:, 0, :]) @ self.proj.to(cd)


class TextTransformer(nn.Module):
    """Causal text tower over embedded token sequences. The token table stays
    fp32: it is also the fp32 VQ codebook; lookups are cast to the compute
    dtype. Under tensor parallelism (`tp` set by ``parallel/tp.py``) the table
    is this rank's vocabulary shard: a lookup gathers the ids inside the
    shard, zeros the others and sums over the model group (exactly one rank
    holds each id)."""

    def __init__(self, c: ClipConfig):
        super().__init__()
        self.cfg = c
        dt = c.dtype
        self.token_embedding = nn.Embedding(c.vocab_size, c.text_width)
        self.positional_embedding = nn.Parameter(torch.zeros(c.context_length, c.text_width,
                                                             dtype=dt))
        self.transformer = Transformer(c.text_width, c.text_layers, c.text_heads, dt,
                                       fused_vjp=c.text_fused_attention_vjp,
                                       remat=c.text_remat_mode)
        self.ln_final = LayerNorm(c.text_width, dtype=dt)
        self.text_projection = nn.Parameter(torch.zeros(c.text_width, c.embed_dim, dtype=dt))
        t = c.context_length
        causal = torch.full((t, t), -1e30).triu(1)
        self.register_buffer("causal_bias", causal, persistent=False)
        self.tp = None  # the model group when the table is vocabulary-sharded

    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return self.token_embedding(ids).to(self.cfg.dtype)
        w = self.token_embedding.weight
        local = ids - self.tp.model_rank * w.shape[0]
        inside = (local >= 0) & (local < w.shape[0])
        e = torch.where(inside[..., None], F.embedding(local.clamp(0, w.shape[0] - 1), w), 0.0)
        return reduce_from_model(e, self.tp).to(self.cfg.dtype)

    def run(self, x: torch.Tensor, eot_index: torch.Tensor) -> torch.Tensor:
        """Embedded sequence (B, ctx, W) -> pooled feature (B, E) at eot_index."""
        cd = self.cfg.dtype
        x = x + self.positional_embedding.to(cd)
        x = self.ln_final(self.transformer(x, self.causal_bias))
        pooled = x[torch.arange(x.shape[0], device=x.device), eot_index]
        return pooled @ self.text_projection.to(cd)

    def forward(self, text_ids: torch.Tensor) -> torch.Tensor:
        is_eot = text_ids == self.cfg.eot_id
        eot_index = torch.where(is_eot.any(dim=-1), is_eot.int().argmax(dim=-1),
                                text_ids.argmax(dim=-1))
        return self.run(self._embed(text_ids), eot_index)

    def encode_keywords(self, keywords: torch.Tensor, keyword_num) -> torch.Tensor:
        """keywords (B, K, W); keyword_num an int or a (B,) tensor."""
        c = self.cfg
        b, kmax, _ = keywords.shape
        dev = keywords.device
        keyword_num = torch.as_tensor(keyword_num, device=dev).to(torch.long)
        if keyword_num.ndim == 0:
            keyword_num = keyword_num.expand(b)
        eot_index = keyword_num.clamp(1, c.context_length - 2) + 1
        pos = torch.arange(c.context_length, device=dev)[None, :]
        ids = torch.where(pos == 0, c.sot_id, 0)
        ids = torch.where(pos == eot_index[:, None], c.eot_id, ids)
        x = self._embed(ids)
        kw_at_pos = keywords[:, (pos[0] - 1).clamp(0, kmax - 1), :]
        is_kw = (pos >= 1) & (pos < eot_index[:, None])
        x = torch.where(is_kw[:, :, None], kw_at_pos.to(x.dtype), x)
        return self.run(x, eot_index)


class ClipModel(nn.Module):
    """`vision_kernel`: the ViT's attention through K1 fused-out (a frozen
    image tower), else the plain attention."""

    def __init__(self, c: ClipConfig, vision_kernel: bool = True):
        super().__init__()
        self.visual = VisionTransformer(c, kernel=vision_kernel)
        self.text = TextTransformer(c)
        self.logit_scale = nn.Parameter(torch.tensor(0.0))

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        return self.visual(image)

    def encode_text(self, text_ids: torch.Tensor) -> torch.Tensor:
        return self.text(text_ids)

    def encode_keywords(self, keywords: torch.Tensor, keyword_num) -> torch.Tensor:
        return self.text.encode_keywords(keywords, keyword_num)
