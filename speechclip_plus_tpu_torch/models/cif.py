"""CIF downsampler: alpha net + integrate-and-fire.

Port of ``speechclip_plus_tpu/models/cif.py`` (reference
``avssl/module/cif.py:24-155``). The alpha head is Conv1d (k=3) in the
compute dtype with fp32 master weights, dropout 0.5, ReLU, dropout 0.5, then
Linear(1) and sigmoid in fp32 (JAX ``models/cif.py:96-119``, dtype set at
``models/kwclip.py:519-525``); alphas are zeroed at padding and integrated
into at most `max_feat_len` keyword slots by ``ops/cif.py``.

The variants (JAX ``:77-107``, ``:150-158``): `conv_cif_layer_num` > 1
stacks conv -> dropout -> ReLU (`conv`, then `conv_1`, ...);
`produce_weight_type: dense` is Linear + ReLU (`dense_proj`) in place of the
convs; `cif_output_dim` other than the width projects the fired keywords
without a bias (`cif_output_proj`) and zeroes the padded slots.

Training (JAX ``:121-132``): `quantity_out` is the alpha sum before scaling;
while `global_step < scaling_step` the alphas are scaled toward the target
length (the model's `round(frames / 20)`, or the caption length with
`using_gt_len`); there is no tail handling. The dropout rate is 0.5 as in
JAX, which hard-codes it (``:109``, ``:115``); the YAML's `conv_cif_dropout`
is parsed and not read there either (ROADMAP queue C).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.dropout import dropout
from ..ops.cif import MAX_FEAT_LEN, integrate_and_fire, scale_alpha
from ..parallel.mesh import global_mean

__all__ = ["CifConfig", "CIF"]


@dataclasses.dataclass(frozen=True)
class CifConfig:
    cif_threshold: float = 1.0
    cif_output_dim: Optional[int] = None  # None: the width (from_config: JAX's 768)
    encoder_embed_dim: int = 768
    produce_weight_type: str = "conv"  # conv | dense
    num_layer: int = 1  # conv_cif_layer_num
    conv_cif_width: int = 3
    conv_cif_dropout: float = 0.1  # parsed; the alpha net's dropout is 0.5 (JAX)
    apply_tail_handling: bool = True
    tail_handling_firing_threshold: float = 0.5
    max_feat_len: int = MAX_FEAT_LEN
    apply_scaling: bool = True
    scaling_step: int = -1  # stop scaling at this optimizer step (-1: never)
    quantity_loss_weight: float = 1.0
    # the target length from the caption (EOT position - 1), where the batch
    # carries its `text`
    using_gt_len: bool = False
    compute_dtype: torch.dtype = torch.float32

    @property
    def out_dim(self) -> int:
        """The fired keywords' width."""
        return self.encoder_embed_dim if self.cif_output_dim is None else self.cif_output_dim

    @staticmethod
    def from_config(node) -> "CifConfig":
        """`model_settings.cascaded_branch.downsampling.cif` (reference schema)."""
        d = node.to_dict() if hasattr(node, "to_dict") else dict(node)
        kind = d.get("produce_weight_type", "conv")
        if kind not in ("conv", "dense"):
            raise NotImplementedError(f"CIF produce_weight_type {kind!r}")
        return CifConfig(
            cif_threshold=float(d.get("cif_threshold", 1.0)),
            cif_output_dim=int(d.get("cif_output_dim", 768)),
            encoder_embed_dim=int(d.get("encoder_embed_dim", 768)),
            produce_weight_type=kind,
            num_layer=int(d.get("conv_cif_layer_num", d.get("num_layer", 1))),
            conv_cif_width=int(d.get("conv_cif_width", 3)),
            conv_cif_dropout=float(d.get("conv_cif_dropout", 0.1)),
            apply_tail_handling=bool(d.get("apply_tail_handling", True)),
            tail_handling_firing_threshold=float(d.get("tail_handling_firing_threshold", 0.5)),
            max_feat_len=int(d.get("max_feat_len", MAX_FEAT_LEN)),
            apply_scaling=bool(d.get("apply_scaling", True)),
            scaling_step=int(d.get("scaling_step", -1)),
            quantity_loss_weight=float(d.get("quantity_loss_weight", 1.0)),
            using_gt_len=bool(d.get("using_gt_len", False)),
        )


class CIF(nn.Module):
    def __init__(self, cfg: CifConfig):
        super().__init__()
        self.cfg = cfg
        d, k = cfg.encoder_embed_dim, cfg.conv_cif_width
        if cfg.produce_weight_type == "dense":
            self.dense_proj = nn.Linear(d, d)
        else:
            self.conv = nn.Conv1d(d, d, k, padding=k // 2)
            for i in range(1, cfg.num_layer):
                self.add_module(f"conv_{i}", nn.Conv1d(d, d, k, padding=k // 2))
        self.weight_proj = nn.Linear(d, 1)
        if cfg.out_dim != d:
            self.cif_output_proj = nn.Linear(d, cfg.out_dim, bias=False)

    def convs(self):
        """The alpha net's convolutions, in order."""
        return [self.conv] + [getattr(self, f"conv_{i}") for i in range(1, self.cfg.num_layer)]

    def forward(self, audio_feat: torch.Tensor, pad_mask: torch.Tensor,
                target_lengths: Optional[torch.Tensor] = None, global_step=None, *,
                training: bool = False,
                generator: Optional[torch.Generator] = None,
                group=None) -> Dict[str, torch.Tensor]:
        """audio_feat (B, S, D), pad_mask (B, S) bool (True = pad);
        target_lengths (B,) and the optimizer step drive the train-time
        scaling; `generator` turns the dropouts on; `group` takes the logged
        `dsample_len_diff` over the data-parallel global batch."""
        c, cd = self.cfg, self.cfg.compute_dtype
        if c.produce_weight_type == "dense":
            lin = self.dense_proj
            x = torch.relu(F.linear(audio_feat.to(cd), lin.weight.to(cd), lin.bias.to(cd)))
            x = x.transpose(1, 2)
        else:  # channel-first (B, D, S) through the convolutions
            x = audio_feat.to(cd).transpose(1, 2)
            for conv in self.convs():
                x = F.conv1d(x, conv.weight.to(cd), conv.bias.to(cd), padding=conv.padding)
                x = torch.relu(dropout(x, 0.5, generator))
        x = dropout(x, 0.5, generator)
        alpha = torch.sigmoid(self.weight_proj(x.transpose(1, 2).float()))[..., 0]
        alpha = alpha.masked_fill(pad_mask, 0.0)
        result = {"quantity_out": alpha.sum(dim=1), "orig_alpha": alpha}
        if training and c.apply_scaling and target_lengths is not None:
            scaled = scale_alpha(alpha, target_lengths, c.cif_threshold)
            if c.scaling_step < 0 or global_step is None or int(global_step) < c.scaling_step:
                alpha = scaled
        result.update(integrate_and_fire(
            audio_feat, alpha, threshold=c.cif_threshold, max_feat_len=c.max_feat_len,
            is_inference=not training, apply_tail_handling=c.apply_tail_handling,
            tail_handling_firing_threshold=c.tail_handling_firing_threshold))
        result["input_feats_pad_mask"] = pad_mask
        if c.out_dim != c.encoder_embed_dim:
            w = self.cif_output_proj.weight.to(cd)
            proj = F.linear(result["dsample_feats"].to(cd), w)
            result["dsample_feats"] = proj.masked_fill(
                result["dsample_feats_pad_mask"][:, :, None], 0.0)
        if target_lengths is not None:
            result["target_len"] = target_lengths
            result["dsample_len_diff"] = global_mean(
                (result["dsample_feats_length"].float() - target_lengths.float()).abs().mean(),
                group)
        return result
