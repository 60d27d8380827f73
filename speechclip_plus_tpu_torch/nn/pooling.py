"""Pooling layers kept for API and checkpoint compatibility.

Port of ``speechclip_plus_tpu/nn/pooling.py`` (reference
``avssl/module/pooling.py``): `MeanPoolingLayer` (:8-61, a length-aware mean
with optional pre/post linear projections) and `AttentivePoolingLayer`
(:64-390, a learnable bilinear alignment U with max + softmax pooling;
paired, batch-crossed and gallery variants). The reference exports them and
the KWClip path does not use them. Channel-last (B, T, D) as in JAX, where
the reference is (B, D, T); the math is the same.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

__all__ = ["MeanPoolingLayer", "AttentivePoolingLayer"]

_NEG_INF = -1e30


class MeanPoolingLayer(nn.Module):
    """Length-aware mean over time, with optional pre/post projections to
    `out_dim` (both only when `in_dim` and `out_dim` are positive)."""

    def __init__(self, in_dim: int = 0, out_dim: int = 0, bias: bool = True,
                 pre_proj: bool = True, post_proj: bool = True):
        super().__init__()
        proj = in_dim > 0 and out_dim > 0
        self.pre_proj = nn.Linear(in_dim, out_dim, bias=bias) if proj and pre_proj else None
        width = out_dim if self.pre_proj is not None else in_dim
        self.post_proj = nn.Linear(width, out_dim, bias=bias) if proj and post_proj else None

    def forward(self, x: torch.Tensor, x_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.pre_proj is not None:
            x = self.pre_proj(x)
        if x_len is not None:
            m = (torch.arange(x.shape[1], device=x.device)[None, :, None]
                 < x_len[:, None, None]).to(x.dtype)
            x = (x * m).sum(dim=1) / x_len.to(x.dtype)[:, None].clamp_min(1.0)
        else:
            x = x.mean(dim=1)
        if self.post_proj is not None:
            x = self.post_proj(x)
        return x


class AttentivePoolingLayer(nn.Module):
    """Bilinear attentive pooling between two modalities: `forward` pools
    paired batches, `batch_forward` crosses every A with every B,
    `cal_batch_embedding` pools A against an (N, D) gallery. `degraded` fixes
    U to the identity (not a parameter)."""

    def __init__(self, dim_A: int, dim_B: int, degraded: bool = False):
        super().__init__()
        if degraded:
            if dim_A != dim_B:
                raise ValueError(f"degraded pooling needs dim_A == dim_B: {dim_A}, {dim_B}")
            self.register_buffer("U", torch.eye(dim_A), persistent=False)
        else:
            self.U = nn.Parameter(torch.randn(dim_A, dim_B))

    @staticmethod
    def generate_input_msk(input_A_lens: Optional[torch.Tensor] = None,
                           input_B_lens: Optional[torch.Tensor] = None,
                           max_Alen: int = 1, max_Blen: int = 1) -> torch.Tensor:
        """(B, max_Alen, max_Blen) additive mask, -1e30 at padding."""
        lens = input_A_lens if input_A_lens is not None else input_B_lens
        if lens is None:
            raise ValueError("generate_input_msk needs input_A_lens or input_B_lens")
        msk = torch.zeros(lens.shape[0], max_Alen, max_Blen, device=lens.device)
        if input_A_lens is not None:
            pa = torch.arange(max_Alen, device=lens.device)[None, :, None] \
                >= input_A_lens[:, None, None]
            msk = msk.masked_fill(pa, _NEG_INF)
        if input_B_lens is not None:
            pb = torch.arange(max_Blen, device=lens.device)[None, None, :] \
                >= input_B_lens[:, None, None]
            msk = msk.masked_fill(pb, _NEG_INF)
        return msk

    def forward(self, input_A: torch.Tensor, input_B: torch.Tensor,
                input_msk: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, Ta, Da), (B, Tb, Db), additive (B, Ta, Tb) -> (B, Da), (B, Db)."""
        align = torch.tanh(torch.einsum("btd,de,bse->bts", input_A, self.U, input_B))
        if input_msk is not None:
            align = align + input_msk
        score_A = torch.softmax(align.amax(dim=2), dim=-1)
        score_B = torch.softmax(align.amax(dim=1), dim=-1)
        return (torch.einsum("btd,bt->bd", input_A, score_A),
                torch.einsum("bsd,bs->bd", input_B, score_B))

    def batch_forward(self, input_A: torch.Tensor, input_B: torch.Tensor,
                      input_msk: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(Na, Ta, Da), (Nb, Tb, Db), (Na, Ta, Tb) -> (Na, Nb, Da), (Na, Nb, Db)."""
        align = torch.tanh(torch.einsum("atd,de,bse->abts", input_A, self.U, input_B))
        if input_msk is not None:
            align = align + input_msk[:, None, :, :]
        score_A = torch.softmax(align.amax(dim=3), dim=-1)
        score_B = torch.softmax(align.amax(dim=2), dim=-1)
        return (torch.einsum("atd,abt->abd", input_A, score_A),
                torch.einsum("bsd,abs->abd", input_B, score_B))

    def cal_batch_embedding(self, input_A: torch.Tensor, input_B: torch.Tensor,
                            input_msk: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, Ta, Da) against an (N, Db) gallery, (B, Ta, 1) -> (B, Da, N)."""
        align = torch.tanh(torch.einsum("btd,de,ne->btn", input_A, self.U, input_B))
        if input_msk is not None:
            align = align + input_msk
        return torch.einsum("btd,btn->bdn", input_A, torch.softmax(align, dim=1))
