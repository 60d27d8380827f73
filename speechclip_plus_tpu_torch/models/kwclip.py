"""KWClip: the SpeechCLIP+ hybrid+ model.

Port of ``speechclip_plus_tpu/models/kwclip.py`` for the hybrid+ family
(`HybridBranch_dynamic`): frozen HuBERT or WavLM tower -> softmax-weighted sum of its
hidden states -> HybridBranchPlus; the keywords go through the frozen CLIP
text tower (`encode_keywords`); images through the frozen ViT, or come as
cached image features.

`forward` is the JAX `__call__` (``:829-992``): (loss_feats, log_metrics,
others) for a batch, in training with keyword-BN batch statistics, CIF alpha
scaling and straight-through VQ gradients, and with dropout when a generator
is given; `compute_loss` (``:1006-1063``) is the masked contrastive loss of
each branch plus the weighted CIF quantity loss. The towers are frozen
(`requires_grad=False`): gradients reach the weighted sum, the branch, the
keyword inputs of the text tower and the learnable contrastive temperature
`criterion_log_inv_temp`.

`trainer.precision: bf16` (or 16) puts the towers, the branch attention, the
keyword projection and the CIF conv in bf16, as `KWClipConfig.from_config`
does in JAX (``:281-287``, ``:515-525``): the frozen towers store bf16, the
trainable modules keep fp32 master weights and compute in bf16; statistics,
BN, the alpha head and the VQ codebook stay fp32. Other branch types raise
NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.losses import masked_contrastive_loss, quantity_l1_loss
from ..ops.weighted_sum import layer_weights
from .branches import HybridBranchPlus, KeywordHeadConfig, TransformerArgs, VQConfig
from .cif import CifConfig
from .clip import ClipConfig, ClipModel
from .hubert import HubertConfig, HubertModel

__all__ = ["ClLossConfig", "KWClipConfig", "KWClip", "init_kw_bn_from_token_embedding"]

_HALF = ("16", "16-mixed", "bf16", "bf16-mixed", "bfloat16")


@dataclasses.dataclass(frozen=True)
class ClLossConfig:
    """`cl_loss` (MaskedContrastiveLoss only)."""

    temperature: float = 0.07
    temperature_trainable: bool = True
    margin: float = 0.0
    dcl: bool = False
    a2b: bool = True
    b2a: bool = True

    @staticmethod
    def from_config(node) -> "ClLossConfig":
        d = node.to_dict() if hasattr(node, "to_dict") else dict(node)
        if d.get("type", "MaskedContrastiveLoss") != "MaskedContrastiveLoss":
            raise NotImplementedError(f"cl_loss.type {d.get('type')!r}")
        a = d.get("args", {})
        return ClLossConfig(
            temperature=float(a.get("temperature", 0.07)),
            temperature_trainable=bool(a.get("temperature_trainable",
                                             a.get("learnable_temperature", True))),
            margin=float(a.get("margin", 0.0)), dcl=bool(a.get("dcl", False)),
            a2b=bool(a.get("a2b", True)), b2a=bool(a.get("b2a", True)))


@dataclasses.dataclass(frozen=True)
class KWClipConfig:
    audio: HubertConfig = HubertConfig()
    clip: ClipConfig = ClipConfig()
    cascaded_ta: TransformerArgs = TransformerArgs()
    head: KeywordHeadConfig = KeywordHeadConfig()
    cif: CifConfig = CifConfig()
    cl_loss: ClLossConfig = ClLossConfig()
    cascaded_objective_weight: float = 1.0
    parallel_objective_weight: float = 1.0
    retrieval_audio_feat_src: str = "parallel"

    @staticmethod
    def from_config(cfg, *, vocab_size: Optional[int] = None, sot_id: Optional[int] = None,
                    eot_id: Optional[int] = None) -> "KWClipConfig":
        """From a reference-format ConfigNode, hybrid+ family only."""
        ms = cfg.model_settings
        cb = getattr(ms, "cascaded_branch", None)
        if float(getattr(ms, "cascaded_objective_weight", 0.0)) <= 0 or cb is None \
                or cb.type.replace("KW_", "").replace("dynamic", "plus") != "HybridBranch_plus":
            raise NotImplementedError(
                "the PyTorch port builds the hybrid+ branch (HybridBranch_dynamic) only")
        for key in ("image_encoder_projection", "parallel_branch_projection",
                    "cascaded_branch_projection"):
            if ms.get(key, None) is not None:
                raise NotImplementedError(f"model_settings.{key}")
        kw = getattr(cb, "keyword", None)
        if kw is not None and getattr(kw, "kw_projection", None) is not None:
            raise NotImplementedError("keyword.kw_projection MLP")
        ae = cfg.audio_encoder
        if getattr(ae, "feat_select_idx", "weighted_sum") != "weighted_sum" \
                or getattr(ae, "normalize_hiddenstates", False):
            raise NotImplementedError("audio features other than the plain weighted sum")
        audio_is_trainable = bool(getattr(ae, "trainable", False)
                                  or getattr(ae, "reinit_layers", None)
                                  or getattr(ae, "unfreeze_layers", None))
        # the tower's attention kernels are forward-only (JAX :383-388, :406-413)
        fused_attn = getattr(ae, "fused_attention", None)
        fused_blk = getattr(ae, "fused_attention_block", None)
        for key, on in (("fused_attention", fused_attn), ("fused_attention_block", fused_blk)):
            if on and audio_is_trainable:
                raise ValueError(f"audio_encoder.{key} requires a frozen tower "
                                 f"(forward-only kernel, nn/{key}.py)")
        if audio_is_trainable \
                or getattr(cfg.clip, "image_encoder_trainable", False) \
                or getattr(cfg.clip, "text_encoder_trainable", False):
            raise NotImplementedError("trainable towers (the port trains frozen towers only)")
        if float(getattr(ae, "layer_drop", 0.0) or 0.0) != 0.0:
            raise NotImplementedError("audio_encoder.layer_drop")

        if getattr(cfg.clip, "tiny", False):
            width = int(getattr(cfg.clip, "tiny_width", 32))
            clip_cfg = ClipConfig.tiny(text_width=width, embed_dim=width)
        elif "L/14" in cfg.clip.name:
            raise NotImplementedError("ViT-L/14 (the large family) is a later slice")
        else:
            clip_cfg = ClipConfig.vit_b32()
        if vocab_size is not None:
            clip_cfg = dataclasses.replace(clip_cfg, vocab_size=vocab_size, sot_id=sot_id,
                                           eot_id=eot_id)
        if getattr(ae, "tiny", False):
            audio_cfg = HubertConfig.tiny(d_model=int(getattr(ae, "tiny_width", 32)))
        else:
            audio_cfg = HubertConfig.from_upstream_name(getattr(ae, "name", "hubert_base"))
        # the reference trains with dropout on in the frozen tower (Lightning's
        # train() undoes its eval()); `frozen_dropout: false` opts out (JAX :353-371)
        if not bool(getattr(ae, "frozen_dropout", True)):
            audio_cfg = dataclasses.replace(audio_cfg, dropout=0.0, attention_dropout=0.0)
        # `fused_attention` selects K5 around plain projections; the block
        # kernel K1 is the default for the frozen tower (`false` forces it off)
        if fused_attn is not None:
            audio_cfg = dataclasses.replace(audio_cfg, fused_attention_dropout=bool(fused_attn))
        if fused_blk is not None:
            audio_cfg = dataclasses.replace(audio_cfg, fused_attention_block=bool(fused_blk))

        ta = TransformerArgs.from_config(cb.transformer_args)
        bn = getattr(kw, "batchnorms", None) if kw is not None else None
        if bn is None:
            raise NotImplementedError("hybrid+ without keyword.batchnorms")
        head = KeywordHeadConfig(
            d_model=ta.d_model, text_dim=clip_cfg.text_width,
            vq=VQConfig.from_config(cb.vq.args),
            bn_std_scale=float(getattr(bn, "std_scale", 1.0)))
        ds = getattr(cb, "downsampling", None)
        if ds is None or getattr(ds, "type", None) != "cif":
            raise NotImplementedError("hybrid+ without CIF downsampling")
        cif = CifConfig.from_config(ds.cif)
        # keyword slots + SOT + EOT must fit the text context (75 + 2 = 77)
        cif = dataclasses.replace(
            cif, max_feat_len=min(cif.max_feat_len, clip_cfg.context_length - 2))

        precision = str(getattr(getattr(cfg, "trainer", None), "precision", 32) or 32).lower()
        if precision in _HALF:
            bf = torch.bfloat16
            audio_cfg = dataclasses.replace(audio_cfg, dtype=bf)
            clip_cfg = dataclasses.replace(clip_cfg, dtype=bf)
            ta = dataclasses.replace(ta, compute_dtype=bf)
            head = dataclasses.replace(head, compute_dtype=bf)
            cif = dataclasses.replace(cif, compute_dtype=bf)
        return KWClipConfig(
            audio=audio_cfg, clip=clip_cfg, cascaded_ta=ta, head=head, cif=cif,
            cl_loss=ClLossConfig.from_config(cfg.cl_loss),
            cascaded_objective_weight=float(ms.cascaded_objective_weight),
            parallel_objective_weight=float(getattr(ms, "parallel_objective_weight", 0.0)),
            retrieval_audio_feat_src=getattr(cfg.retrieval, "audio_feat_src", "parallel"))


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


class KWClip(nn.Module):
    def __init__(self, cfg: KWClipConfig):
        super().__init__()
        self.cfg = cfg
        self.audio_encoder = HubertModel(cfg.audio)
        self.weightedsum = nn.Parameter(torch.zeros(cfg.audio.num_hidden_states))
        self.clip = ClipModel(cfg.clip)
        self.cascaded_branch = HybridBranchPlus(cfg.cascaded_ta, cfg.head, cfg.cif,
                                                out_dim=cfg.clip.text_width)
        if cfg.cl_loss.temperature_trainable:
            # learnable log(1/T) (reference losses.py:160-163, JAX :706-712)
            self.criterion_log_inv_temp = nn.Parameter(
                torch.tensor(math.log(1.0 / cfg.cl_loss.temperature)))
        # frozen towers: gradients flow through their activations (the text
        # tower's keyword inputs), never into their weights
        self.audio_encoder.requires_grad_(False)
        self.clip.requires_grad_(False)

    def forward_audio(self, wav: torch.Tensor, wav_len: torch.Tensor,
                      generator: Optional[torch.Generator] = None):
        """Frozen HuBERT + weighted sum -> (feat (B, T', D) fp32, feat_len (B,))."""
        pad = torch.arange(wav.shape[1], device=wav.device)[None, :] >= wav_len[:, None]
        feat = self.audio_encoder(wav, pad, layer_weights(self.weightedsum),
                                  generator)["weighted_sum"]
        rate = self.cfg.audio.downsample_rate
        feat_len = torch.clamp(torch.round(wav_len.float() / rate).to(torch.int64),
                               max=feat.shape[1])
        return feat, feat_len

    def encode_image_raw(self, image: torch.Tensor) -> torch.Tensor:
        """Frozen CLIP image features (B, H, W, 3) -> (B, E), before normalization
        (the quantity a training run may cache)."""
        return self.clip.encode_image(image)

    def encode_parallel(self, wav: torch.Tensor, wav_len: torch.Tensor) -> torch.Tensor:
        """The parallel feature alone: tower and branch attention, no CIF, VQ
        or text tower (what XLA's dead-code elimination leaves of the JAX
        query for feat_src="parallel")."""
        feat, feat_len = self.forward_audio(wav, wav_len)
        return self.cascaded_branch.parallel_feature(feat, feat_len)

    def encode_speech(self, wav: torch.Tensor, wav_len: torch.Tensor) -> Dict[str, Any]:
        """JAX `KWClip.encode_speech` (reference `kwClip.py:1042-1091`)."""
        feat, feat_len = self.forward_audio(wav, wav_len)
        token_emb = self.clip.text.token_embedding.weight
        out = self.cascaded_branch(feat, feat_len, token_emb)
        cascaded = self.clip.encode_keywords(out["keywords"], out["keywords_len"])
        return {
            "cascaded_audio_feat": cascaded,
            "parallel_audio_feat": out["parallel_audio_feat"],
            "vq_results": out["vq_results"],
            "keywords": out["keywords"],
            "dsample_results": out["dsample_results"],
        }

    def forward(self, batch: Dict[str, torch.Tensor], *, training: bool = False,
                global_step=None,
                generator: Optional[torch.Generator] = None) -> Tuple[Dict, Dict, Dict]:
        """JAX `KWClip.__call__`: (loss_feats, log_metrics, others) for a batch
        with `wav`, `wav_len`, `id` and `image` or a cached `image_feat`.
        Dropout draws from `generator`; None runs without dropout (flax's
        `deterministic=True`). `global_step` is the optimizer step (CIF
        scaling)."""
        feat, feat_len = self.forward_audio(batch["wav"], batch["wav_len"], generator)
        return self.forward_from_audio(feat, feat_len, batch, training=training,
                                       global_step=global_step, generator=generator)

    def forward_from_audio(self, audio_feat: torch.Tensor, audio_feat_len: torch.Tensor,
                           batch: Dict[str, torch.Tensor], *, training: bool = False,
                           global_step=None, generator: Optional[torch.Generator] = None):
        """Everything downstream of the acoustic tower (JAX ``:859-992``)."""
        if batch.get("image_feat") is not None:
            image_feat = _l2norm(batch["image_feat"].detach())  # cached frozen-tower output
        else:
            with torch.no_grad():
                image_feat = _l2norm(self.encode_image_raw(batch["image"]))
        target_len = torch.round(audio_feat_len.float() / 20.0).to(torch.int64)
        out = self.cascaded_branch(
            audio_feat, audio_feat_len, self.clip.text.token_embedding.weight,
            target_len=target_len, global_step=global_step, training=training,
            generator=generator)
        cascaded = _l2norm(self.clip.encode_keywords(out["keywords"], out["keywords_len"]))
        parallel = _l2norm(out["parallel_audio_feat"])
        ds, vq = out["dsample_results"], out["vq_results"]
        ids = batch["id"]
        loss_feats = {"id": ids, "image_feat": image_feat, "cascaded_audio_feat": cascaded,
                      "parallel_audio_feat": parallel, "cif_quantity_out": ds["quantity_out"],
                      "cif_target_len": ds.get("target_len", target_len)}
        log_metrics = {"cl_temp": 1.0 / self.logit_multiplier(),
                       "softmax_temp": vq["temp"], "temp": vq["temp"],
                       "code_perplexity": vq["code_perplexity"],
                       "prob_perplexity": vq["prob_perplexity"],
                       "ent_per_t": vq["ent_per_t"].mean()}
        if "dsample_len_diff" in ds:
            log_metrics["dsample_len_diff"] = ds["dsample_len_diff"]
        others = {"id": ids, "image_feat": image_feat, "parallel_audio_feat": parallel,
                  "cascaded_audio_feat": cascaded, "vq_results": vq,
                  "keywords": out["keywords"], "dsample_results": ds,
                  "keywords_len": out["keywords_len"]}
        return loss_feats, log_metrics, others

    def logit_multiplier(self) -> torch.Tensor:
        if self.cfg.cl_loss.temperature_trainable:
            return torch.exp(self.criterion_log_inv_temp)
        return torch.tensor(1.0 / self.cfg.cl_loss.temperature,
                            device=self.weightedsum.device)

    def compute_loss(self, loss_feats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """JAX `compute_loss` (``:1006-1063``): each branch's masked contrastive
        loss, weighted, plus quantity_loss_weight x the CIF quantity L1."""
        c = self.cfg
        scale = self.logit_multiplier()
        image_feat = loss_feats["image_feat"].float()
        ids, valid = loss_feats["id"], loss_feats.get("valid")
        l = c.cl_loss
        losses: Dict[str, torch.Tensor] = {}
        total = torch.zeros((), device=image_feat.device)
        for key, weight, short in (
                ("cascaded_audio_feat", c.cascaded_objective_weight, "c_cl_loss"),
                ("parallel_audio_feat", c.parallel_objective_weight, "p_cl_loss")):
            if weight > 0.0 and key in loss_feats:
                losses[short] = masked_contrastive_loss(
                    loss_feats[key].float(), image_feat, ids, logit_scale=scale,
                    margin=l.margin, dcl=l.dcl, a2b=l.a2b, b2a=l.b2a, valid=valid)
                total = total + weight * losses[short]
        if loss_feats.get("cif_target_len") is not None:
            losses["quantity_loss"] = quantity_l1_loss(
                loss_feats["cif_quantity_out"], loss_feats["cif_target_len"], valid=valid)
            total = total + c.cif.quantity_loss_weight * losses["quantity_loss"]
        losses["loss"] = total
        return losses


@torch.no_grad()
def init_kw_bn_from_token_embedding(model: KWClip) -> None:
    """Keyword-BN scale/bias from CLIP token-embedding statistics (reference
    `kw_branches.py:93-118`): gamma = std(emb) * std_scale (unbiased), beta =
    mean(emb)."""
    bn = model.cascaded_branch.head.bn_layer
    emb = model.clip.text.token_embedding.weight.float()
    bn.weight.copy_(emb.std(dim=0) * model.cfg.head.bn_std_scale)
    bn.bias.copy_(emb.mean(dim=0))
