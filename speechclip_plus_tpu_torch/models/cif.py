"""CIF downsampler, eval path: alpha net + integrate-and-fire.

Port of ``speechclip_plus_tpu/models/cif.py`` (reference
``avssl/module/cif.py:24-155``). The alpha head is Conv1d (k=3) in the
compute dtype, then ReLU, then Linear(1) and sigmoid in fp32 (JAX
``models/cif.py:96-119``, dtype set at ``models/kwclip.py:519-525``); alphas
are zeroed at padding and integrated into at most `max_feat_len` keyword
slots by ``ops/cif.py``. Train-time alpha scaling comes with the training
step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from ..ops.cif import MAX_FEAT_LEN, integrate_and_fire

__all__ = ["CifConfig", "CIF"]


@dataclasses.dataclass(frozen=True)
class CifConfig:
    """One conv layer, output width = input width (every hybrid+ config)."""

    cif_threshold: float = 1.0
    encoder_embed_dim: int = 768
    conv_cif_width: int = 3
    apply_tail_handling: bool = True
    tail_handling_firing_threshold: float = 0.5
    max_feat_len: int = MAX_FEAT_LEN
    dtype: torch.dtype = torch.float32

    @staticmethod
    def from_config(node) -> "CifConfig":
        """`model_settings.cascaded_branch.downsampling.cif` (reference schema)."""
        d = node.to_dict() if hasattr(node, "to_dict") else dict(node)
        width = int(d.get("encoder_embed_dim", 768))
        if d.get("produce_weight_type", "conv") != "conv" \
                or int(d.get("conv_cif_layer_num", d.get("num_layer", 1))) != 1 \
                or int(d.get("cif_output_dim", width)) != width:
            raise NotImplementedError("CIF other than one conv layer without output proj")
        return CifConfig(
            cif_threshold=float(d.get("cif_threshold", 1.0)),
            encoder_embed_dim=width,
            conv_cif_width=int(d.get("conv_cif_width", 3)),
            apply_tail_handling=bool(d.get("apply_tail_handling", True)),
            tail_handling_firing_threshold=float(d.get("tail_handling_firing_threshold", 0.5)),
            max_feat_len=int(d.get("max_feat_len", MAX_FEAT_LEN)),
        )


class CIF(nn.Module):
    def __init__(self, cfg: CifConfig):
        super().__init__()
        self.cfg = cfg
        d, k = cfg.encoder_embed_dim, cfg.conv_cif_width
        self.conv = nn.Conv1d(d, d, k, padding=k // 2, dtype=cfg.dtype)
        self.weight_proj = nn.Linear(d, 1)

    def forward(self, audio_feat: torch.Tensor, pad_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """audio_feat (B, S, D), pad_mask (B, S) bool (True = pad)."""
        c = self.cfg
        x = torch.relu(self.conv(audio_feat.to(c.dtype).transpose(1, 2)))
        alpha = torch.sigmoid(self.weight_proj(x.transpose(1, 2).float()))[..., 0]
        alpha = alpha.masked_fill(pad_mask, 0.0)
        result = {"quantity_out": alpha.sum(dim=1)}
        result.update(integrate_and_fire(
            audio_feat, alpha, threshold=c.cif_threshold, max_feat_len=c.max_feat_len,
            is_inference=True, apply_tail_handling=c.apply_tail_handling,
            tail_handling_firing_threshold=c.tail_handling_firing_threshold))
        result["input_feats_pad_mask"] = pad_mask
        return result
