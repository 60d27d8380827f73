"""KWClip: the SpeechCLIP and SpeechCLIP+ models.

Port of ``speechclip_plus_tpu/models/kwclip.py`` for the five branch families
(parallel, cascaded, cascaded+, hybrid, hybrid+) with the base or large towers
(ViT-B/32 or ViT-L/14; HuBERT, WavLM or data2vec, base or large, or a mel
upstream: APC / VQ-APC, TERA / Mockingjay / DeCoAR 2.0): frozen acoustic
tower -> softmax-weighted sum of its hidden states -> the branch; the
keywords of a cascaded or hybrid branch go through the frozen CLIP text tower
(`encode_keywords`); images through the frozen ViT, or come as cached image
features. A model with one objective has one feature: the other is None in
`encode_speech` and absent from the loss.

`forward` is the JAX `__call__` (``:829-992``): (loss_feats, log_metrics,
others) for a batch, in training with keyword-BN batch statistics, CIF alpha
scaling and straight-through VQ gradients, and with dropout (and LayerDrop,
Gumbel noise) when a generator is given; `compute_loss` (``:1006-1063``) is
the masked contrastive loss, or SupConLoss over the audio and image views, of
each branch plus the weighted CIF quantity loss. Gradients reach the weighted
sum, the branch, the keyword inputs of the text tower and the learnable
temperatures (`criterion_log_inv_temp`, the VQ's `curr_temp`); the towers
train where the configuration says so (`audio_encoder.trainable`,
`unfreeze_layers`, `reinit_layers`, `clip.image_encoder_trainable`,
`clip.text_encoder_trainable`), through JAX's trainable set
(``optim/optimizer.py``), and are frozen otherwise (`requires_grad=False`).

`trainer.precision: bf16` (or 16) puts the towers, the branch attention, the
keyword projection and the CIF conv in bf16, as `KWClipConfig.from_config`
does in JAX (``:281-287``, ``:515-525``): the frozen towers store bf16, the
trainable modules keep fp32 master weights and compute in bf16; statistics,
BN, the alpha head and the VQ codebook stay fp32; a trainable tower keeps
fp32 masters too. Configuration keys JAX does not implement raise by name.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.losses import masked_contrastive_loss, quantity_l1_loss, supcon_loss
from ..ops.weighted_sum import layer_weights, weighted_sum
from ..nn.mlp import MLPLayers
from ..optim.optimizer import trainable_mask
from ..parallel.tp import full_parameter
from ..utils.profiling import backward_span, span
from .branches import (CascadedBranch, CascadedBranchPlus, HybridBranch, HybridBranchPlus,
                       KeywordHeadConfig, KwBnConfig, ParallelBranch, TransformerArgs,
                       VQConfig)
from .cif import CifConfig
from .clip import ClipConfig, ClipModel
from .hubert import HubertConfig, HubertModel
from .mel_upstreams import MelUpstream, MelUpstreamConfig

__all__ = ["ClLossConfig", "KWClipConfig", "KWClip", "init_kw_bn_from_token_embedding"]

_HALF = ("16", "16-mixed", "bf16", "bf16-mixed", "bfloat16")


@dataclasses.dataclass(frozen=True)
class ClLossConfig:
    """`cl_loss`: MaskedContrastiveLoss or SupConLoss (JAX ``:54-84``)."""

    type: str = "MaskedContrastiveLoss"
    temperature: float = 0.07
    temperature_trainable: bool = True
    margin: float = 0.0
    dcl: bool = False
    a2b: bool = True
    b2a: bool = True
    base_temperature: float = 0.07  # SupConLoss
    contrast_mode: str = "all"  # SupConLoss: all | one

    @staticmethod
    def from_config(node) -> "ClLossConfig":
        d = node.to_dict() if hasattr(node, "to_dict") else dict(node)
        kind = d.get("type", "MaskedContrastiveLoss")
        if kind not in ("MaskedContrastiveLoss", "SupConLoss"):
            raise NotImplementedError(f"cl_loss.type {kind!r}")
        a = d.get("args", {})
        return ClLossConfig(
            type=kind, temperature=float(a.get("temperature", 0.07)),
            temperature_trainable=bool(a.get("temperature_trainable",
                                             a.get("learnable_temperature", True))),
            margin=float(a.get("margin", 0.0)), dcl=bool(a.get("dcl", False)),
            a2b=bool(a.get("a2b", True)), b2a=bool(a.get("b2a", True)),
            base_temperature=float(a.get("base_temperature", 0.07)),
            contrast_mode=a.get("contrast_mode", "all"))


# tower keys that only the wav2vec2/HuBERT family has: they raise for a mel
# upstream, which JAX cannot apply them to either (JAX ``:339-350``)
_HUBERT_ONLY_KEYS = ("fused_attention", "fused_attention_block", "reinit_layers",
                     "unfreeze_layers")


@dataclasses.dataclass(frozen=True)
class KWClipConfig:
    audio: Any = HubertConfig()  # HubertConfig or MelUpstreamConfig
    clip: ClipConfig = ClipConfig()
    branch_type: str = "HybridBranch_plus"  # normalized alias; "" = parallel only
    parallel_ta: TransformerArgs = TransformerArgs(type="TransformerEncoder")
    cascaded_ta: TransformerArgs = TransformerArgs()
    head: KeywordHeadConfig = KeywordHeadConfig()
    cif: Optional[CifConfig] = CifConfig()
    cl_loss: ClLossConfig = ClLossConfig()
    cascaded_objective_weight: float = 1.0
    parallel_objective_weight: float = 1.0
    need_projection: bool = True  # the parallel feature's projection
    img_proj_dims: Optional[Tuple[int, ...]] = None
    img_proj_dropout: float = 0.1
    p_proj_dims: Optional[Tuple[int, ...]] = None
    p_proj_dropout: float = 0.1
    # the hybrid branch's own parallel projection (`projection_config`,
    # reference kw_branches.py:492-505), distinct from `p_proj_dims`
    pbranch_proj_dims: Optional[Tuple[int, ...]] = None
    pbranch_proj_dropout: float = 0.1
    c_proj_dims: Optional[Tuple[int, ...]] = None
    c_proj_dropout: float = 0.1
    retrieval_audio_feat_src: str = "parallel"
    # `audio_encoder.feat_select_idx`: "weighted_sum", "last_hidden_state" or
    # a tuple of hidden-state indices; `normalize_hiddenstates` with
    # `normalize_type` s3prl (layer norm of each hidden state in the sum),
    # method1 (each frame to unit norm) or method2 (each layer over its mean
    # frame norm), JAX ``:725-803``
    feat_select_idx: Any = "weighted_sum"
    normalize_hiddenstates: bool = False
    normalize_type: str = "s3prl"
    # the trainable towers and the acoustic tower's subset policies (JAX
    # ``:103-114``): the two lists are exclusive, and either implies a
    # trainable tower that trains only those layers
    audio_trainable: bool = False
    image_encoder_trainable: bool = False
    text_encoder_trainable: bool = False
    reinit_layers: Tuple[int, ...] = ()
    unfreeze_layers: Tuple[int, ...] = ()
    # CIF's target length from the caption's EOT (original ids) where the
    # batch carries `text` (JAX ``:891-903``)
    using_gt_len: bool = False
    original_eot_id: int = 49407
    # the branch self-attention through K1 + K2 (`model_settings.fused_attention_vjp`)
    # and the ViT's through K1 (`clip.fused_attention_block`; off for a
    # trainable image tower): else the plain attention
    fused_attention_vjp: bool = True
    vision_fused_attention_block: bool = True

    @property
    def keyword_num(self) -> Optional[int]:
        """K for the fixed-keyword branches, None for the dynamic (plus) ones."""
        if self.branch_type in ("CascadedBranch", "HybridBranch"):
            return self.head.keyword_num
        return None

    @property
    def has_parallel(self) -> bool:
        return self.parallel_objective_weight > 0

    @property
    def has_cascaded(self) -> bool:
        return self.cascaded_objective_weight > 0 and self.branch_type != ""

    @staticmethod
    def from_config(cfg, *, vocab_size: Optional[int] = None, sot_id: Optional[int] = None,
                    eot_id: Optional[int] = None) -> "KWClipConfig":
        """From a reference-format ConfigNode: the parallel, cascaded,
        cascaded+, hybrid and hybrid+ families, base or large, with any tower
        whose name JAX resolves (JAX ``:150-627``). Keys the port does not
        implement raise by name."""
        ms = cfg.model_settings
        c_w = float(getattr(ms, "cascaded_objective_weight", 0.0))
        p_w = float(getattr(ms, "parallel_objective_weight", 0.0))
        ae = cfg.audio_encoder
        feat_select_idx = getattr(ae, "feat_select_idx", "weighted_sum")
        if isinstance(feat_select_idx, (list, tuple)):
            feat_select_idx = tuple(int(i) for i in feat_select_idx)
        elif feat_select_idx not in ("weighted_sum", "last_hidden_state"):
            raise NotImplementedError(f"audio_encoder.feat_select_idx {feat_select_idx!r}")
        normalize_type = getattr(ae, "normalize_type", "s3prl")
        if normalize_type not in ("s3prl", "method1", "method2"):
            raise NotImplementedError(f"audio_encoder.normalize_type {normalize_type!r}")
        if getattr(ae, "tiny", False):
            audio_cfg = HubertConfig.tiny(d_model=int(getattr(ae, "tiny_width", 32)))
        else:
            # the wav2vec2/HuBERT family, else the mel upstreams (JAX :266-276)
            name = getattr(ae, "name", "hubert_base")
            try:
                audio_cfg = HubertConfig.from_upstream_name(name)
            except NotImplementedError:
                audio_cfg = MelUpstreamConfig.from_upstream_name(name)
        mel = isinstance(audio_cfg, MelUpstreamConfig)
        for key in _HUBERT_ONLY_KEYS if mel else ():
            if getattr(ae, key, None) not in (None, [], ()):
                raise NotImplementedError(
                    f"audio_encoder.{key}: a wav2vec2/HuBERT tower key, and {name!r} is a "
                    f"mel upstream ({audio_cfg.arch})")
        reinit_layers = tuple(int(i) for i in (getattr(ae, "reinit_layers", None) or []))
        unfreeze_layers = tuple(int(i) for i in (getattr(ae, "unfreeze_layers", None) or []))
        if reinit_layers and unfreeze_layers:
            raise ValueError("reinit_layers and unfreeze_layers are mutually exclusive "
                             "(reference speech_encoder_plus.py:418)")
        audio_is_trainable = bool(getattr(ae, "trainable", False) or reinit_layers
                                  or unfreeze_layers)
        # the forward-only kernels need a frozen tower (JAX :383-388, :406-413,
        # :204-221, :534-547)
        fused_attn = getattr(ae, "fused_attention", None)
        fused_blk = getattr(ae, "fused_attention_block", None)
        for key, on in (("fused_attention", fused_attn), ("fused_attention_block", fused_blk)):
            if on and audio_is_trainable:
                raise ValueError(f"audio_encoder.{key} requires a frozen tower "
                                 f"(forward-only kernel, nn/{key}.py)")
        image_trainable = bool(getattr(cfg.clip, "image_encoder_trainable", False))
        clip_fused = getattr(cfg.clip, "fused_attention_block", None)
        if clip_fused and image_trainable:
            raise ValueError("clip.fused_attention_block requires a frozen image tower "
                             "(forward-only kernel, nn/fused_attention_block.py)")
        text_trainable = bool(getattr(cfg.clip, "text_encoder_trainable", False))
        text_vjp = getattr(cfg.clip, "text_fused_attention_vjp", None)
        if text_vjp and text_trainable:
            raise ValueError("clip.text_fused_attention_vjp assumes a frozen text tower "
                             "(the backward returns input gradients only)")
        fused_score = getattr(ms, "fused_score_kernel", None)
        if fused_score and text_trainable:
            raise ValueError("model_settings.fused_score_kernel requires a frozen text tower "
                             "(no codebook gradient, ops/fused_keyword.py)")
        fused_score = not text_trainable if fused_score is None else bool(fused_score)

        if getattr(cfg.clip, "tiny", False):
            width = int(getattr(cfg.clip, "tiny_width", 32))
            clip_cfg = ClipConfig.tiny(text_width=width, embed_dim=width)
        elif "L/14" in cfg.clip.name:
            clip_cfg = ClipConfig.vit_l14()
        else:
            clip_cfg = ClipConfig.vit_b32()
        if vocab_size is not None:
            clip_cfg = dataclasses.replace(clip_cfg, vocab_size=vocab_size, sot_id=sot_id,
                                           eot_id=eot_id)
        # `clip.text_remat`: full | attn | none (true = full, false = none).
        # Unset means none here, where JAX defaults to full: recomputing
        # changes no value, only time and memory (ROADMAP C, PERF.md).
        text_remat = getattr(cfg.clip, "text_remat", None)
        if text_remat is None or getattr(cfg.clip, "remat", None) is False:
            text_remat = "none"
        if text_remat in (True, False):
            text_remat = "full" if text_remat else "none"
        clip_cfg = dataclasses.replace(clip_cfg, text_fused_attention_vjp=bool(text_vjp),
                                       text_remat_mode=str(text_remat))

        # LayerDrop: a rate, or "original" = the pretrained model's 0.05 (JAX
        # :301-307); a mel upstream has no LayerDrop (JAX accepts and ignores it)
        layer_drop = getattr(ae, "layer_drop", 0.0) or 0.0
        layer_drop = 0.05 if layer_drop == "original" else float(layer_drop)
        if not mel:
            # `remat` is auto-on for a trainable tower of width >= 1024 (JAX :437-448)
            remat = getattr(ae, "remat", None)
            if remat is None:
                remat = audio_is_trainable and audio_cfg.d_model >= 1024
            audio_cfg = dataclasses.replace(audio_cfg, layer_drop=layer_drop, remat=bool(remat))
        # the reference trains with dropout on in the frozen tower (Lightning's
        # train() undoes its eval()); `frozen_dropout: false` opts a frozen
        # tower out (JAX :353-371)
        if not audio_is_trainable and not bool(getattr(ae, "frozen_dropout", True)):
            off = {"dropout": 0.0} if mel else {"dropout": 0.0, "attention_dropout": 0.0,
                                                "layer_drop": 0.0}
            audio_cfg = dataclasses.replace(audio_cfg, **off)
        # `fused_attention` selects K5 around plain projections; the block
        # kernel K1 is the default for a frozen tower (`false` forces it off)
        # and off for a trainable one
        if fused_attn is not None:
            audio_cfg = dataclasses.replace(audio_cfg, fused_attention_dropout=bool(fused_attn))
        if fused_blk is None:
            fused_blk = not audio_is_trainable
        audio_cfg = dataclasses.replace(audio_cfg, fused_attention_block=bool(fused_blk))

        def branch_ta(node) -> TransformerArgs:
            """`transformer_args`; the original-SpeechCLIP configs name the
            block type in a sibling `transformer_type` key instead."""
            args = node.transformer_args
            ta = TransformerArgs.from_config(args)
            d = args.to_dict() if hasattr(args, "to_dict") else dict(args)
            sibling = getattr(node, "transformer_type", None)
            if sibling and "type" not in d:
                ta = dataclasses.replace(ta, type=sibling)
            return ta

        branch_type, cascaded_ta, head, cif = "", TransformerArgs(), KeywordHeadConfig(), None
        if c_w > 0:
            cb = ms.cascaded_branch
            branch_type = cb.type.replace("KW_", "").replace("dynamic", "plus")
            if branch_type not in ("CascadedBranch", "CascadedBranch_plus", "HybridBranch",
                                   "HybridBranch_plus"):
                raise NotImplementedError(f"cascaded_branch.type {cb.type!r}")
            cascaded_ta = branch_ta(cb)
            kw = getattr(cb, "keyword", None)
            kwp = getattr(kw, "kw_projection", None) if kw is not None else None
            head = KeywordHeadConfig(
                d_model=cascaded_ta.d_model, text_dim=clip_cfg.text_width,
                kw_proj_dims=tuple(kwp.dimensions) if kwp is not None else None,
                kw_proj_dropout=float(kwp.dropout) if kwp is not None else 0.1,
                vq=VQConfig.from_config(cb.vq.args),
                bn=KwBnConfig.from_config(getattr(kw, "batchnorms", None)
                                          if kw is not None else None),
                keyword_num=int(getattr(kw, "number", 8)) if kw is not None else 8,
                fused_score_kernel=fused_score)
            ds = getattr(cb, "downsampling", None)
            if ds is not None and getattr(ds, "type", None) == "cif":
                cif = CifConfig.from_config(ds.cif)
                # keyword slots + SOT + EOT must fit the text context (75 + 2 = 77)
                cif = dataclasses.replace(
                    cif, max_feat_len=min(cif.max_feat_len, clip_cfg.context_length - 2))
                # the keyword head reads CIF's output (its projection's width)
                head = dataclasses.replace(head, d_model=cif.out_dim)
            if branch_type.endswith("_plus") and cif is None:
                raise NotImplementedError(f"{branch_type} without CIF downsampling")
        pb = getattr(ms, "parallel_branch", None)
        parallel_ta = (branch_ta(pb) if p_w > 0 and pb is not None
                       else TransformerArgs(type="TransformerEncoder"))
        pb_proj = getattr(pb, "projection_config", None) if pb is not None else None

        precision = str(getattr(getattr(cfg, "trainer", None), "precision", 32) or 32).lower()
        if precision in _HALF:
            bf = torch.bfloat16
            audio_cfg = dataclasses.replace(audio_cfg, dtype=bf)
            clip_cfg = dataclasses.replace(clip_cfg, dtype=bf)
            cascaded_ta = dataclasses.replace(cascaded_ta, compute_dtype=bf)
            parallel_ta = dataclasses.replace(parallel_ta, compute_dtype=bf)
            head = dataclasses.replace(head, compute_dtype=bf)
            if cif is not None:
                cif = dataclasses.replace(cif, compute_dtype=bf)

        def proj(name):
            node = ms.get(name, None) if hasattr(ms, "get") else getattr(ms, name, None)
            if node is None:
                return None, 0.1
            return tuple(node.dimensions), float(node.dropout)

        img_dims, img_drop = proj("image_encoder_projection")
        pb_dims, pb_drop = proj("parallel_branch_projection")
        cb_dims, cb_drop = proj("cascaded_branch_projection")
        return KWClipConfig(
            audio=audio_cfg, clip=clip_cfg, branch_type=branch_type, parallel_ta=parallel_ta,
            cascaded_ta=cascaded_ta, head=head, cif=cif,
            cl_loss=ClLossConfig.from_config(cfg.cl_loss),
            cascaded_objective_weight=c_w, parallel_objective_weight=p_w,
            need_projection=bool(getattr(pb, "need_projection", True)) if pb is not None
            else True,
            img_proj_dims=img_dims, img_proj_dropout=img_drop,
            p_proj_dims=pb_dims, p_proj_dropout=pb_drop,
            pbranch_proj_dims=tuple(pb_proj.dimensions) if pb_proj is not None else None,
            pbranch_proj_dropout=float(pb_proj.dropout) if pb_proj is not None else 0.1,
            c_proj_dims=cb_dims, c_proj_dropout=cb_drop,
            retrieval_audio_feat_src=getattr(cfg.retrieval, "audio_feat_src", "parallel"),
            feat_select_idx=feat_select_idx,
            normalize_hiddenstates=bool(getattr(ae, "normalize_hiddenstates", False)),
            normalize_type=normalize_type, audio_trainable=audio_is_trainable,
            image_encoder_trainable=image_trainable, text_encoder_trainable=text_trainable,
            reinit_layers=reinit_layers, unfreeze_layers=unfreeze_layers,
            using_gt_len=bool(cif is not None and cif.using_gt_len),
            fused_attention_vjp=getattr(ms, "fused_attention_vjp", None) is not False,
            vision_fused_attention_block=not image_trainable if clip_fused is None
            else bool(clip_fused))


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


class KWClip(nn.Module):
    def __init__(self, cfg: KWClipConfig):
        super().__init__()
        self.cfg = c = cfg
        self.audio_encoder = (MelUpstream(c.audio) if isinstance(c.audio, MelUpstreamConfig)
                              else HubertModel(c.audio))
        self.weightedsum = nn.Parameter(torch.zeros(c.audio.num_hidden_states))
        self.clip = ClipModel(c.clip, vision_kernel=c.vision_fused_attention_block)
        # one branch module: the cascaded / hybrid one, or the parallel one
        # when only the parallel objective has a weight (JAX :651-686)
        self.cascaded_branch = self.parallel_branch = None
        kernel = c.fused_attention_vjp
        if c.has_cascaded:
            if c.branch_type == "CascadedBranch":
                self.cascaded_branch = CascadedBranch(c.cascaded_ta, c.head, kernel=kernel)
            elif c.branch_type == "CascadedBranch_plus":
                self.cascaded_branch = CascadedBranchPlus(c.cascaded_ta, c.head, c.cif,
                                                          kernel=kernel)
            elif c.branch_type == "HybridBranch":
                self.cascaded_branch = HybridBranch(
                    c.cascaded_ta, c.head, out_dim=c.clip.text_width,
                    need_projection=c.need_projection,
                    parallel_proj_dims=c.pbranch_proj_dims,
                    parallel_proj_dropout=c.pbranch_proj_dropout, kernel=kernel)
            elif c.branch_type == "HybridBranch_plus":
                self.cascaded_branch = HybridBranchPlus(c.cascaded_ta, c.head, c.cif,
                                                        out_dim=c.clip.text_width, kernel=kernel)
            else:
                raise NotImplementedError(c.branch_type)
        elif c.has_parallel:
            self.parallel_branch = ParallelBranch(c.parallel_ta, out_dim=c.clip.text_width,
                                                  need_projection=c.need_projection,
                                                  kernel=kernel)
        mlp = lambda dims, p: None if dims is None else MLPLayers(dims, p)
        self.img_enc_proj_net = mlp(c.img_proj_dims, c.img_proj_dropout)
        self.p_branch_proj_net = mlp(c.p_proj_dims, c.p_proj_dropout)
        self.c_branch_proj_net = mlp(c.c_proj_dims, c.c_proj_dropout)
        if c.cl_loss.temperature_trainable:
            # learnable log(1/T) (reference losses.py:160-163, JAX :706-712)
            self.criterion_log_inv_temp = nn.Parameter(
                torch.tensor(math.log(1.0 / c.cl_loss.temperature)))
        # JAX's trainable set: a frozen tower passes gradients through its
        # activations (the text tower's keyword inputs), never into its
        # weights; a trainable tower keeps fp32 masters, as flax does, each
        # module casting them to its compute dtype at use
        for trains, tower in ((c.audio_trainable, self.audio_encoder),
                              (c.image_encoder_trainable, self.clip.visual),
                              (c.text_encoder_trainable, self.clip.text)):
            if trains:
                tower.float()
        mask = trainable_mask(self, c)
        for name, p in self.named_parameters():
            p.requires_grad_(mask[name])

    def forward_audio(self, wav: torch.Tensor, wav_len: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      return_hidden_states: bool = False,
                      layer_drop_generator: Optional[torch.Generator] = None):
        """Frozen tower + the feature `feat_select_idx` names -> (feat
        (B, T', D) fp32, or (n, B, T', D) for n > 1 indices, feat_len (B,)),
        and with `return_hidden_states` the tower's (L+1, B, T', D) stack
        third (JAX ``:725-803``). The weighted sum, plain or s3prl-normalized,
        is accumulated in the tower's layer loop; the other features read the
        stack, normalized first by method1 / method2 (the stack returned is
        then the normalized one, as JAX returns it)."""
        c = self.cfg
        with span("tower"):
            pad = torch.arange(wav.shape[1], device=wav.device)[None, :] >= wav_len[:, None]
            s3prl = c.normalize_hiddenstates and c.normalize_type == "s3prl"
            fused = c.feat_select_idx == "weighted_sum" and (s3prl or not c.normalize_hiddenstates)
            weights = layer_weights(self.weightedsum) if fused else None
            out = self.audio_encoder(wav, pad, weights, generator,
                                     return_hidden_states=return_hidden_states or not fused,
                                     normalize_contrib=s3prl,
                                     layer_drop_generator=layer_drop_generator)
            hidden = out.get("hidden_states")
            if fused:
                feat = out["weighted_sum"]
            else:
                h = hidden.float()
                if c.normalize_hiddenstates and c.normalize_type == "method1":
                    hidden = h = h / (h.norm(dim=-1, keepdim=True) + 1e-8)
                elif c.normalize_hiddenstates and c.normalize_type == "method2":
                    hidden = h = h / h.norm(dim=-1).mean(dim=-1)[:, :, None, None]
                if isinstance(c.feat_select_idx, tuple):
                    sel = h[list(c.feat_select_idx)]
                    feat = sel[0] if len(c.feat_select_idx) == 1 else sel
                elif c.feat_select_idx == "weighted_sum":
                    feat = weighted_sum(h, self.weightedsum)
                else:
                    feat = h[-1]
            rate = c.audio.downsample_rate
            feat_len = torch.clamp(torch.round(wav_len.float() / rate).to(torch.int64),
                                   max=feat.shape[-2])
        backward_span("tower.bwd", feat, weights)
        if return_hidden_states:
            return feat, feat_len, hidden
        return feat, feat_len

    def feature_extractor(self, wav: torch.Tensor, wav_len: torch.Tensor
                          ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """Reference `feature_extractor_s3prl` (`kwClip.py:965-997`, JAX
        ``:1120-1135``): (last hidden state, every hidden state: the tower's
        L+1, then each branch transformer layer's output over the frames)."""
        feat, feat_len, hidden = self.forward_audio(wav, wav_len, return_hidden_states=True)
        hidden_states = tuple(hidden.unbind(0))
        for branch in (self.cascaded_branch, self.parallel_branch):
            if branch is not None:
                hidden_states += tuple(branch.extract_hidden_states(feat, feat_len)[1:])
        return hidden_states[-1], hidden_states

    def encode_image_raw(self, image: torch.Tensor) -> torch.Tensor:
        """CLIP image features (B, H, W, 3) -> (B, E), before projection and
        normalization (the quantity a training run with a frozen ViT may
        cache)."""
        return self.clip.encode_image(image)

    def project_image_feat(self, feat: torch.Tensor,
                           generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.img_enc_proj_net is not None:
            feat = self.img_enc_proj_net(feat, generator)
        return _l2norm(feat)

    def encode_parallel(self, wav: torch.Tensor, wav_len: torch.Tensor) -> torch.Tensor:
        """The parallel feature alone: tower and branch attention, no CIF, VQ
        or text tower (what XLA's dead-code elimination leaves of the JAX
        query for feat_src="parallel")."""
        branch = self.cascaded_branch if self.cascaded_branch is not None \
            else self.parallel_branch
        if not hasattr(branch, "parallel_feature"):
            raise ValueError(f"{self.cfg.branch_type} has no parallel feature")
        feat, feat_len = self.forward_audio(wav, wav_len)
        with span("branch"):
            out = branch.parallel_feature(feat, feat_len)
            return out if self.p_branch_proj_net is None else self.p_branch_proj_net(out)

    def encode_speech(self, wav: torch.Tensor, wav_len: torch.Tensor) -> Dict[str, Any]:
        """JAX `KWClip.encode_speech` (reference `kwClip.py:1042-1091`); a
        feature the model does not have is None."""
        feat, feat_len = self.forward_audio(wav, wav_len)
        with span("branch"):
            if self.cascaded_branch is not None:
                out = self.cascaded_branch(feat, feat_len, self.clip.text.token_embedding.weight)
            else:
                out = self.parallel_branch(feat, feat_len)
            parallel = out.get("parallel_audio_feat")
            if parallel is not None and self.p_branch_proj_net is not None:
                parallel = self.p_branch_proj_net(parallel)
        cascaded = None
        if out.get("keywords") is not None:
            with span("text"):
                cascaded = self.clip.encode_keywords(
                    out["keywords"], out["keywords_len"] if "keywords_len" in out
                    else out["keyword_num"])
        return {
            "cascaded_audio_feat": cascaded,
            "parallel_audio_feat": parallel,
            "vq_results": out.get("vq_results"),
            "keywords": out.get("keywords"),
            "dsample_results": out.get("dsample_results"),
        }

    def get_attention_map(self, wav: torch.Tensor, wav_len: torch.Tensor) -> torch.Tensor:
        """Keyword-CLS attention weights over the frames (fixed-K cascaded
        branch only; reference `getAttentionMap`)."""
        if not hasattr(self.cascaded_branch, "get_attention_map"):
            raise NotImplementedError("attention maps require a fixed-K cascaded branch")
        return self.cascaded_branch.get_attention_map(*self.forward_audio(wav, wav_len))

    def forward(self, batch: Dict[str, torch.Tensor], *, training: bool = False,
                global_step=None, generator: Optional[torch.Generator] = None,
                group=None, layer_drop_generator: Optional[torch.Generator] = None
                ) -> Tuple[Dict, Dict, Dict]:
        """JAX `KWClip.__call__`: (loss_feats, log_metrics, others) for a batch
        with `wav`, `wav_len`, `id` and `image` or a cached `image_feat`.
        Dropout draws from `generator`; None runs without dropout (flax's
        `deterministic=True`). `global_step` is the optimizer step (CIF
        scaling). Under data parallelism `batch` holds this rank's rows,
        `group` (``parallel/mesh.py``) takes the keyword-BN and VQ statistics
        over the global batch and `layer_drop_generator` is the generator
        every rank shares for LayerDrop; the loss features stay per rank (the
        step gathers them)."""
        idx = self.cfg.feat_select_idx
        if isinstance(idx, tuple) and len(idx) > 1:
            raise NotImplementedError(
                "a multi-layer feat_select_idx is a feature-extraction surface (forward_audio, "
                "feature_extractor): the branches take one (B, T, D) feature, as in JAX")
        feat, feat_len = self.forward_audio(batch["wav"], batch["wav_len"], generator,
                                            layer_drop_generator=layer_drop_generator)
        return self.forward_from_audio(feat, feat_len, batch, training=training,
                                       global_step=global_step, generator=generator,
                                       group=group)

    def forward_from_audio(self, audio_feat: torch.Tensor, audio_feat_len: torch.Tensor,
                           batch: Dict[str, torch.Tensor], *, training: bool = False,
                           global_step=None, generator: Optional[torch.Generator] = None,
                           group=None):
        """Everything downstream of the acoustic tower (JAX ``:859-992``)."""
        c = self.cfg
        if batch.get("image_feat") is not None:
            image_feat = batch["image_feat"].detach()  # cached frozen-tower output
        else:  # the ViT takes gradients where it trains (JAX :806-813)
            with torch.set_grad_enabled(torch.is_grad_enabled() and c.image_encoder_trainable):
                image_feat = self.encode_image_raw(batch["image"])
        image_feat = self.project_image_feat(image_feat, generator)
        target_len = None
        if c.branch_type.endswith("_plus"):
            if c.using_gt_len and "text" in batch:
                # the caption length: EOT position - 1 in original-id space,
                # the EOT found by its id (argmax where a row has none)
                text = batch["text"]
                is_eot = text == c.original_eot_id
                eot_pos = torch.where(is_eot.any(dim=-1), is_eot.int().argmax(dim=-1),
                                      text.argmax(dim=-1))
                target_len = eot_pos - 1
            else:
                target_len = torch.round(audio_feat_len.float() / 20.0).to(torch.int64)
        with span("branch"):
            if self.cascaded_branch is not None:
                out = self.cascaded_branch(
                    audio_feat, audio_feat_len, self.clip.text.token_embedding.weight,
                    target_len=target_len, global_step=global_step, training=training,
                    generator=generator, group=group)
            else:
                out = self.parallel_branch(audio_feat, audio_feat_len, generator)
        backward_span("branch.bwd", out, audio_feat)
        ids = batch["id"]
        loss_feats: Dict[str, Any] = {"id": ids, "image_feat": image_feat}
        cascaded = parallel = None
        if out.get("keywords") is not None:
            with span("text"):
                cascaded = self.clip.encode_keywords(
                    out["keywords"], out["keywords_len"] if "keywords_len" in out
                    else out["keyword_num"])
                if self.c_branch_proj_net is not None:
                    cascaded = self.c_branch_proj_net(cascaded, generator)
                loss_feats["cascaded_audio_feat"] = cascaded = _l2norm(cascaded)
            backward_span("text.bwd", cascaded, out["keywords"])
        if out.get("parallel_audio_feat") is not None:
            parallel = out["parallel_audio_feat"]
            if self.p_branch_proj_net is not None:
                parallel = self.p_branch_proj_net(parallel, generator)
            loss_feats["parallel_audio_feat"] = parallel = _l2norm(parallel)
        ds, vq = out.get("dsample_results"), out.get("vq_results")
        if ds is not None:
            loss_feats["cif_quantity_out"] = ds["quantity_out"]
            loss_feats["cif_target_len"] = ds.get("target_len", target_len)
        log_metrics = {"cl_temp": 1.0 / self.logit_multiplier()}
        if vq is not None:
            log_metrics.update({"softmax_temp": vq["temp"], "temp": vq["temp"],
                                "code_perplexity": vq["code_perplexity"],
                                "prob_perplexity": vq["prob_perplexity"],
                                "ent_per_t": vq["ent_per_t"].mean()})
        if ds is not None and "dsample_len_diff" in ds:
            log_metrics["dsample_len_diff"] = ds["dsample_len_diff"]
        others = {"id": ids, "image_feat": image_feat, "parallel_audio_feat": parallel,
                  "cascaded_audio_feat": cascaded, "vq_results": vq,
                  "keywords": out.get("keywords"), "dsample_results": ds,
                  "keywords_len": out.get("keywords_len")}
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
                if l.type == "SupConLoss":
                    # audio and image as two views of the pair: same-id samples
                    # are positives (JAX :1021-1035)
                    feats = torch.stack([loss_feats[key].float(), image_feat], dim=1)
                    losses[short] = supcon_loss(
                        feats, labels=ids, temperature=1.0 / scale,
                        base_temperature=l.base_temperature, contrast_mode=l.contrast_mode,
                        valid=valid)
                else:
                    losses[short] = masked_contrastive_loss(
                        loss_feats[key].float(), image_feat, ids, logit_scale=scale,
                        margin=l.margin, dcl=l.dcl, a2b=l.a2b, b2a=l.b2a, valid=valid)
                total = total + weight * losses[short]
        if c.cif is not None and loss_feats.get("cif_target_len") is not None:
            losses["quantity_loss"] = quantity_l1_loss(
                loss_feats["cif_quantity_out"], loss_feats["cif_target_len"], valid=valid)
            total = total + c.cif.quantity_loss_weight * losses["quantity_loss"]
        losses["loss"] = total
        return losses


@torch.no_grad()
def init_kw_bn_from_token_embedding(model: KWClip) -> None:
    """Keyword-BN scale/bias from CLIP token-embedding statistics (reference
    `kw_branches.py:93-118`): gamma = std(emb) * std_scale (unbiased), beta =
    mean(emb), laid out as the BN variant keeps its channels (JAX
    ``:1145-1176``): repeated K times per dimension for the fused `eachKw`
    layout (channel = d*K + k), tiled over K rows for the per-keyword one."""
    c = model.cfg
    if not (c.has_cascaded and c.head.bn.enabled):
        return
    bn = model.cascaded_branch.head.bn_layer
    # the whole table (gathered over the model group of a tensor-parallel model)
    emb = full_parameter(model, "clip.text.token_embedding.weight").float()
    std, mean = emb.std(dim=0) * c.head.bn.std_scale, emb.mean(dim=0)
    if bn.variant == "fixed" and c.head.bn.type == "eachKw":
        k = c.head.keyword_num
        if c.head.bn.parallel:
            std, mean = std.repeat_interleave(k), mean.repeat_interleave(k)
        else:
            std, mean = std[None, :].expand(k, -1), mean[None, :].expand(k, -1)
    bn.weight.copy_(std)
    bn.bias.copy_(mean)
