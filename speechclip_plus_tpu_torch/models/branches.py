"""SpeechCLIP+ hybrid branch.

Port of `SimpleVectorQuantizer`, `KwBatchNorm` (dynamic), `KeywordHead` and
`HybridBranchPlus` from ``speechclip_plus_tpu/models/branches.py``
(reference ``avssl/model/kw_branches.py:780-891``): [CLS; frames] through one
MultiheadAttentionAndNorm; the CLS output, projected, is the parallel
feature; the frames go through CIF to at most 75 keyword slots, the keyword
projection, dynamic keyword BN, and the fused cosine-score + VQ against the
CLIP token table (K3, with the straight-through backward K3b in training).
The other branch families are later slices.

Every parameter is stored in fp32 and cast to the compute dtype at use, as
flax's `dtype=` does (JAX ``:693-736`` with `TransformerArgs.dtype` /
`KeywordHeadConfig.dtype` bf16 under `trainer.precision: bf16`). `training`
switches keyword BN to batch statistics, CIF to its training form and the VQ
to straight-through gradients; a `generator` turns the dropouts on (the
branch attention's 0.1 and CIF's 0.5).
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.transformer import MultiheadAttentionAndNorm
from ..ops.fused_keyword import fused_cosine_vq
from ..ops.kw_bn import kw_bn_dynamic
from ..ops.masks import get_keypadding_mask
from .cif import CIF, CifConfig

__all__ = ["TransformerArgs", "VQConfig", "KeywordHeadConfig", "SimpleVectorQuantizer",
           "KwBatchNorm", "KeywordHead", "HybridBranchPlus"]


@dataclasses.dataclass(frozen=True)
class TransformerArgs:
    """`transformer_args` of the branch (MultiheadAttentionAndNorm only)."""

    d_model: int = 768
    nhead: int = 8
    layer_norm_eps: float = 1e-5
    dropout: float = 0.1
    compute_dtype: torch.dtype = torch.float32

    @staticmethod
    def from_config(node) -> "TransformerArgs":
        d = node.to_dict() if hasattr(node, "to_dict") else dict(node)
        if d.get("type", "MultiheadAttentionAndNorm") != "MultiheadAttentionAndNorm":
            raise NotImplementedError(f"branch transformer {d.get('type')!r}")
        return TransformerArgs(d_model=int(d.get("d_model", 768)), nhead=int(d.get("nhead", 8)),
                               layer_norm_eps=float(d.get("layer_norm_eps", 1e-5)),
                               dropout=float(d.get("dropout", 0.1)))


@dataclasses.dataclass(frozen=True)
class VQConfig:
    """`model_settings.cascaded_branch.vq.args`: hard, time-first, no Gumbel,
    fixed temperature (every hybrid+ config; in eval the temperature is only
    reported)."""

    temp: float = 0.1
    prob_msk: Tuple[int, ...] = (0, 2, 3)

    @staticmethod
    def from_config(node) -> "VQConfig":
        d = node.to_dict() if hasattr(node, "to_dict") else dict(node)
        temp = str(d.get("temp", "fixed=0.1"))
        if d.get("use_gumbel", False) or not d.get("hard", True) \
                or not d.get("time_first", True) or not temp.startswith("fixed="):
            raise NotImplementedError("VQ other than hard, time-first, fixed temperature")
        return VQConfig(temp=float(ast.literal_eval(temp[len("fixed="):])))


@dataclasses.dataclass(frozen=True)
class KeywordHeadConfig:
    d_model: int = 768
    text_dim: int = 512
    vq: VQConfig = VQConfig()
    bn_std_scale: float = 1.0
    compute_dtype: torch.dtype = torch.float32


class SimpleVectorQuantizer(nn.Module):
    """Quantizes through the fused cosine-score + VQ path (K3; K3b backward)."""

    def __init__(self, cfg: VQConfig):
        super().__init__()
        self.cfg = cfg

    def forward(self, xn: torch.Tensor, emb: torch.Tensor, compute_dtype: torch.dtype,
                training: bool = False) -> Dict[str, torch.Tensor]:
        return fused_cosine_vq(xn, emb, self.cfg.temp, prob_msk=self.cfg.prob_msk,
                               dtype=compute_dtype, training=training)


class KwBatchNorm(nn.Module):
    """Dynamic keyword BatchNorm over D (running statistics as buffers,
    updated without gradient in training); scale/bias are set from CLIP
    token-embedding statistics by the builder."""

    def __init__(self, dim: int, momentum: float = 0.1):
        super().__init__()
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, keywords: torch.Tensor, training: bool = False) -> torch.Tensor:
        y, stats = kw_bn_dynamic(keywords, self.weight, self.bias, self.running_mean,
                                 self.running_var, training=training, momentum=self.momentum)
        if stats is not None:
            with torch.no_grad():
                self.running_mean.copy_(stats[0])
                self.running_var.copy_(stats[1])
        return y


class KeywordHead(nn.Module):
    """proj -> keyword BN -> L2 normalize -> cosine vs codebook -> VQ."""

    def __init__(self, cfg: KeywordHeadConfig):
        super().__init__()
        self.cfg = cfg
        self.linear_proj = nn.Linear(cfg.d_model, cfg.text_dim)
        self.bn_layer = KwBatchNorm(cfg.text_dim)
        self.vector_quantizer = SimpleVectorQuantizer(cfg.vq)

    def forward(self, feats: torch.Tensor, token_embedding: torch.Tensor,
                training: bool = False):
        cd, lp = self.cfg.compute_dtype, self.linear_proj
        x = F.linear(feats.to(cd), lp.weight.to(cd), lp.bias.to(cd))
        xf = self.bn_layer(x, training).float()
        xn = xf / xf.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        vq = self.vector_quantizer(xn, token_embedding.float(), cd, training)
        keywords = vq.pop("keywords")
        return vq, keywords


class HybridBranchPlus(nn.Module):
    def __init__(self, ta: TransformerArgs, head: KeywordHeadConfig, cif: CifConfig,
                 out_dim: int = 512):
        super().__init__()
        self.cls = nn.Parameter(torch.zeros(1, 1, ta.d_model))
        self.self_att = MultiheadAttentionAndNorm(ta.d_model, ta.nhead, ta.layer_norm_eps,
                                                  compute_dtype=ta.compute_dtype,
                                                  dropout=ta.dropout)
        self.downsampling = CIF(cif)
        self.head = KeywordHead(head)
        self.parallel_proj = nn.Linear(ta.d_model, out_dim)

    def _attend(self, audio_feat: torch.Tensor, audio_len: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        b, t = audio_feat.shape[:2]
        cls = self.cls.to(audio_feat.dtype).expand(b, 1, -1)
        mask = get_keypadding_mask(t + 1, audio_len + 1)
        out = self.self_att(torch.cat([cls, audio_feat], dim=1), key_padding_mask=mask,
                            generator=generator)
        return out, mask

    def parallel_feature(self, audio_feat: torch.Tensor,
                         audio_len: torch.Tensor) -> torch.Tensor:
        """The parallel feature alone: the branch attention and the CLS
        projection, without CIF, the VQ or the text tower."""
        out, _ = self._attend(audio_feat, audio_len)
        return self.parallel_proj(out[:, 0, :].float())

    def forward(self, audio_feat: torch.Tensor, audio_len: torch.Tensor,
                token_embedding: torch.Tensor, *, target_len: Optional[torch.Tensor] = None,
                global_step=None, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """`target_len` and `global_step` drive CIF's train-time scaling;
        `generator` turns the dropouts on."""
        out, mask = self._attend(audio_feat, audio_len, generator)
        dsample = self.downsampling(out[:, 1:, :], mask[:, 1:],
                                    target_len if training else None, global_step,
                                    training=training, generator=generator)
        if target_len is not None:
            dsample["target_len"] = target_len
        vq_results, keywords = self.head(dsample["dsample_feats"], token_embedding, training)
        return {
            "parallel_audio_feat": self.parallel_proj(out[:, 0, :].float()),
            "vq_results": vq_results,
            "keywords": keywords,
            "dsample_results": dsample,
            "keywords_len": dsample["dsample_feats_length"],
        }
