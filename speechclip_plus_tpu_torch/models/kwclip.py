"""KWClip: the SpeechCLIP+ hybrid+ model, serving surface.

Port of ``speechclip_plus_tpu/models/kwclip.py`` for the hybrid+ family
(`HybridBranch_dynamic`): frozen HuBERT tower -> softmax-weighted sum of its
hidden states -> HybridBranchPlus; the keywords go through the frozen CLIP
text tower (`encode_keywords`); images through the frozen ViT.

`trainer.precision: bf16` (or 16) puts the towers, the branch attention, the
keyword projection and the CIF conv in bf16, as `KWClipConfig.from_config`
does in JAX (``:281-287``, ``:515-525``); statistics, BN, the alpha head and
the VQ codebook stay fp32. Other branch types raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..ops.weighted_sum import layer_weights
from .branches import HybridBranchPlus, KeywordHeadConfig, TransformerArgs, VQConfig
from .cif import CifConfig
from .clip import ClipConfig, ClipModel
from .hubert import HubertConfig, HubertModel

__all__ = ["KWClipConfig", "KWClip", "init_kw_bn_from_token_embedding"]

_HALF = ("16", "16-mixed", "bf16", "bf16-mixed", "bfloat16")


@dataclasses.dataclass(frozen=True)
class KWClipConfig:
    audio: HubertConfig = HubertConfig()
    clip: ClipConfig = ClipConfig()
    cascaded_ta: TransformerArgs = TransformerArgs()
    head: KeywordHeadConfig = KeywordHeadConfig()
    cif: CifConfig = CifConfig()
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
            ta = dataclasses.replace(ta, dtype=bf)
            head = dataclasses.replace(head, dtype=bf)
            cif = dataclasses.replace(cif, dtype=bf)
        return KWClipConfig(
            audio=audio_cfg, clip=clip_cfg, cascaded_ta=ta, head=head, cif=cif,
            retrieval_audio_feat_src=getattr(cfg.retrieval, "audio_feat_src", "parallel"))


class KWClip(nn.Module):
    def __init__(self, cfg: KWClipConfig):
        super().__init__()
        self.cfg = cfg
        self.audio_encoder = HubertModel(cfg.audio)
        self.weightedsum = nn.Parameter(torch.zeros(cfg.audio.num_hidden_states))
        self.clip = ClipModel(cfg.clip)
        self.cascaded_branch = HybridBranchPlus(cfg.cascaded_ta, cfg.head, cfg.cif,
                                                out_dim=cfg.clip.text_width)

    def forward_audio(self, wav: torch.Tensor, wav_len: torch.Tensor):
        """Frozen HuBERT + weighted sum -> (feat (B, T', D) fp32, feat_len (B,))."""
        pad = torch.arange(wav.shape[1], device=wav.device)[None, :] >= wav_len[:, None]
        feat = self.audio_encoder(wav, pad, layer_weights(self.weightedsum))["weighted_sum"]
        rate = self.cfg.audio.downsample_rate
        feat_len = torch.clamp(torch.round(wav_len.float() / rate).to(torch.int64),
                               max=feat.shape[1])
        return feat, feat_len

    def encode_image_raw(self, image: torch.Tensor) -> torch.Tensor:
        """Frozen CLIP image features (B, H, W, 3) -> (B, E), before normalization."""
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


@torch.no_grad()
def init_kw_bn_from_token_embedding(model: KWClip) -> None:
    """Keyword-BN scale/bias from CLIP token-embedding statistics (reference
    `kw_branches.py:93-118`): gamma = std(emb) * std_scale (unbiased), beta =
    mean(emb)."""
    bn = model.cascaded_branch.head.bn_layer
    emb = model.clip.text.token_embedding.weight.float()
    bn.weight.copy_(emb.std(dim=0) * model.cfg.head.bn_std_scale)
    bn.bias.copy_(emb.mean(dim=0))
