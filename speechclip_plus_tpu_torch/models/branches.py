"""SpeechCLIP(+) branch family.

Port of ``speechclip_plus_tpu/models/branches.py`` (reference
``avssl/model/kw_branches.py``):

  - `ParallelBranch` (:200-282): one CLS over the tower's frames -> the
    utterance vector.
  - `CascadedBranch` (:285-447): K keyword CLS -> projection -> keyword BN ->
    cosine scores against the CLIP token table -> VQ -> keyword embeddings
    (the parent model runs the frozen text tower on them).
  - `HybridBranch` (:450-577): one transformer over [parallel CLS; K keyword
    CLS; frames].
  - `CascadedBranchPlus` (:580-777): transformer, then CIF to a dynamic number
    of keywords, dynamic keyword BN and the VQ.
  - `HybridBranchPlus` (:780-891): the plus variant with a parallel CLS.

The branch transformer is `MultiheadAttentionAndNorm` or `TransformerEncoder`
(`make_self_att`); its self-attention is K1 forward and K2 backward at every
head width the configs use (8 heads of 96 or 128, or one head of 768 or
1024), or the plain attention of ``nn/attention.py`` with
`model_settings.fused_attention_vjp: false` (JAX ``:60-75``). The keyword
head's cosine score + VQ is K3, with the straight-through backward K3b in
training, where `model_settings.fused_score_kernel` is on (the default for a
frozen text tower) and the VQ's training form is straight-through; else the
materialized scores of ``ops/vq.py`` (JAX ``:231-252``). The VQ temperature
is fixed, learnable (`curr_temp`) or scheduled by the optimizer step.

Every parameter is stored in fp32 and cast to the compute dtype at use, as
flax's `dtype=` does (`TransformerArgs.compute_dtype` /
`KeywordHeadConfig.compute_dtype` bf16 under `trainer.precision: bf16`); the
parallel projections stay fp32, as in JAX. `training` switches keyword BN to
batch statistics, CIF to its training form and the VQ to straight-through
gradients; a `generator` turns the dropouts on.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.mlp import MLPLayers
from ..nn.transformer import MultiheadAttentionAndNorm, TransformerEncoder
from ..ops.fused_keyword import fused_cosine_vq
from ..ops.kw_bn import kw_bn_dynamic, kw_bn_fixed
from ..ops.masks import get_keypadding_mask
from ..ops.vq import scheduled_temperature, simple_vector_quantizer
from ..parallel.tp import gather_from_model
from ..utils.profiling import span
from .cif import CIF, CifConfig

__all__ = ["TransformerArgs", "VQConfig", "KwBnConfig", "KeywordHeadConfig", "make_self_att",
           "SimpleVectorQuantizer", "KwBatchNorm", "KeywordHead", "ParallelBranch",
           "CascadedBranch", "HybridBranch", "CascadedBranchPlus", "HybridBranchPlus"]


@dataclasses.dataclass(frozen=True)
class TransformerArgs:
    """`transformer_args` of a branch."""

    type: str = "MultiheadAttentionAndNorm"
    n_layers: int = 1
    d_model: int = 768
    nhead: int = 8
    dim_feedforward: int = 3072
    dropout: float = 0.1
    activation: str = "gelu"
    layer_norm_eps: float = 1e-5
    norm_first: bool = False
    compute_dtype: torch.dtype = torch.float32

    @staticmethod
    def from_config(node) -> "TransformerArgs":
        d = node.to_dict() if hasattr(node, "to_dict") else dict(node)
        allowed = {f.name for f in dataclasses.fields(TransformerArgs)} - {"compute_dtype"}
        return TransformerArgs(**{k: v for k, v in d.items() if k in allowed})


def make_self_att(args: TransformerArgs, kernel: bool = True) -> nn.Module:
    """Branch transformer factory (reference ``kw_branches.py:31-42``); its
    self-attention through K1 + K2, or with `kernel=False`
    (`model_settings.fused_attention_vjp: false`) the plain attention."""
    if args.type == "TransformerEncoder":
        return TransformerEncoder(
            n_layers=int(args.n_layers), d_model=int(args.d_model), nhead=int(args.nhead),
            dim_feedforward=int(args.dim_feedforward), dropout=float(args.dropout),
            activation=args.activation, layer_norm_eps=float(args.layer_norm_eps),
            norm_first=bool(args.norm_first), compute_dtype=args.compute_dtype,
            kernel=kernel)
    if args.type == "MultiheadAttentionAndNorm":
        return MultiheadAttentionAndNorm(
            int(args.d_model), int(args.nhead), float(args.layer_norm_eps),
            compute_dtype=args.compute_dtype, dropout=float(args.dropout), kernel=kernel)
    raise NotImplementedError(f"branch transformer {args.type!r}")


@dataclasses.dataclass(frozen=True)
class VQConfig:
    """`model_settings.cascaded_branch.vq.args` (reference
    ``my_vector_quantizer.py:15-62``, JAX ``:115-150``): the temperature is
    `fixed=t`, `learnable=t` (the `curr_temp` parameter) or a schedule
    "(max, min, decay)" over the optimizer step."""

    temp_type: str = "fixed"  # fixed | learnable | scheduled
    temp_init: float = 0.1
    temp_schedule: Tuple[float, float, float] = (2.0, 0.5, 0.999995)
    use_gumbel: bool = False
    hard: bool = True
    time_first: bool = True
    prob_msk: Tuple[int, ...] = (0, 2, 3)
    ground_truth_perplexity: Optional[float] = None
    # the straight-through form as a gather with its exact gradient; false:
    # the materialized one-hot + softmax product (``ops/vq.py``)
    fused_st: bool = True

    @staticmethod
    def from_config(node) -> "VQConfig":
        d = node.to_dict() if hasattr(node, "to_dict") else dict(node)
        temp = d.get("temp", "fixed=0.1")
        temp_type, temp_init, sched = "fixed", 0.1, (2.0, 0.5, 0.999995)
        if isinstance(temp, str):
            if temp.startswith("learnable="):
                temp_type, temp_init = "learnable", float(ast.literal_eval(temp[10:]))
            elif temp.startswith("fixed="):
                temp_init = float(ast.literal_eval(temp[6:]))
            else:
                temp_type, sched = "scheduled", tuple(float(v) for v in ast.literal_eval(temp))
        elif isinstance(temp, (list, tuple)):
            temp_type, sched = "scheduled", tuple(float(v) for v in temp)
        else:
            temp_init = float(temp)
        gt = d.get("groundTruthPerplexity", None)
        return VQConfig(temp_type=temp_type, temp_init=temp_init, temp_schedule=sched,
                        use_gumbel=bool(d.get("use_gumbel", False)),
                        hard=bool(d.get("hard", True)),
                        time_first=bool(d.get("time_first", True)),
                        ground_truth_perplexity=None if gt is None else float(gt),
                        fused_st=bool(d.get("fused_st", True)))


@dataclasses.dataclass(frozen=True)
class KwBnConfig:
    """`keyword.batchnorms` (reference ``kw_branches.py:93-118``)."""

    enabled: bool = True
    type: str = "eachKw"  # eachKw | same
    std_scale: float = 1.0
    learnable: bool = True
    parallel: bool = True

    @staticmethod
    def from_config(node) -> "KwBnConfig":
        if node is None:
            return KwBnConfig(enabled=False)
        d = node.to_dict() if hasattr(node, "to_dict") else dict(node)
        return KwBnConfig(enabled=True, type=d.get("type", "eachKw"),
                          std_scale=float(d.get("std_scale", 1.0)),
                          learnable=bool(d.get("learnable", True)),
                          parallel=bool(d.get("parallel", True)))


@dataclasses.dataclass(frozen=True)
class KeywordHeadConfig:
    d_model: int = 768
    text_dim: int = 512
    kw_proj_dims: Optional[Tuple[int, ...]] = None  # None: a single Linear
    kw_proj_dropout: float = 0.1
    vq: VQConfig = VQConfig()
    bn: KwBnConfig = KwBnConfig()
    keyword_num: int = 8
    compute_dtype: torch.dtype = torch.float32
    # the cosine scores + VQ through K3 / K3b (`model_settings.fused_score_kernel`,
    # on by default for a frozen text tower; they give no codebook gradient)
    fused_score_kernel: bool = True


class SimpleVectorQuantizer(nn.Module):
    """The VQ with its temperature (JAX ``:168-271``): K3 (K3b backward) where
    the configuration takes the fused route and the form is straight-through
    (or eval), else the materialized scores of ``ops/vq.py``. Under tensor
    parallelism (`tp`, set by ``parallel/tp.py``) the table it is given is this
    rank's vocabulary shard: K3 and K3b run on the shard and merge across the
    model group; the materialized route gathers the whole table first, as
    XLA does for JAX."""

    def __init__(self, cfg: VQConfig, fused_score_kernel: bool = True):
        super().__init__()
        self.cfg, self.fused_score_kernel = cfg, fused_score_kernel
        self.tp = None
        if cfg.temp_type == "learnable":
            self.curr_temp = nn.Parameter(torch.tensor(float(cfg.temp_init)))

    def temperature(self, global_step, device) -> torch.Tensor:
        """The 0-d fp32 temperature on `device`: the parameter, the fixed
        value, or the schedule at the optimizer step (0 when None)."""
        c = self.cfg
        if c.temp_type == "learnable":
            return self.curr_temp
        if c.temp_type == "fixed":
            return torch.full((), c.temp_init, dtype=torch.float32, device=device)
        return scheduled_temperature(*c.temp_schedule, global_step, device=device)

    def forward(self, xn: torch.Tensor, emb: torch.Tensor, compute_dtype: torch.dtype,
                training: bool = False, global_step=None,
                generator: Optional[torch.Generator] = None, group=None
                ) -> Dict[str, torch.Tensor]:
        c = self.cfg
        temp = self.temperature(global_step, xn.device)
        st_compatible = not training or (c.hard and not c.use_gumbel)
        if self.fused_score_kernel and st_compatible and c.time_first:
            res = fused_cosine_vq(xn, emb, temp, prob_msk=c.prob_msk, dtype=compute_dtype,
                                  training=training, group=group, model_group=self.tp)
            gt = c.ground_truth_perplexity
            if gt is not None:
                v = res["num_vars"]
                res["diversity_loss"] = (res["prob_perplexity"] - gt) ** 2 / (v - gt) ** 2
            return res
        # the materialized cosine scores (the reference einsum): bf16 operands
        # under bf16 compute, fp32 products and sums, as JAX's
        # preferred_element_type=float32
        embf = gather_from_model(emb, self.tp).float()
        en = embf / embf.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        scores = xn.to(compute_dtype).float() @ en.to(compute_dtype).float().T
        return simple_vector_quantizer(
            scores, temp=temp, prob_msk=c.prob_msk, training=training,
            use_gumbel=c.use_gumbel, hard=c.hard,
            generator=generator if training and c.use_gumbel else None,
            ground_truth_perplexity=c.ground_truth_perplexity, time_first=c.time_first,
            codebook=embf, fused_st=c.fused_st, group=group)


class KwBatchNorm(nn.Module):
    """Keyword BatchNorm, fixed-K or dynamic (running statistics as buffers,
    updated without gradient in training); scale and bias are set from CLIP
    token-embedding statistics by ``tasks/builder.py``. The parameter layout follows
    the variant (``ops/kw_bn.py``): (K, D) for fixed `eachKw` per keyword,
    (D*K,) for fixed `eachKw` parallel, (D,) otherwise."""

    def __init__(self, dim: int, momentum: float = 0.1, *, cfg: KwBnConfig = KwBnConfig(),
                 variant: str = "dynamic", kw_num: int = 8):
        super().__init__()
        if variant not in ("fixed", "dynamic"):
            raise ValueError(f"keyword BN variant {variant!r}")
        self.cfg, self.variant, self.momentum = cfg, variant, momentum
        shape: Tuple[int, ...] = (dim,)
        if variant == "fixed" and cfg.type == "eachKw":
            shape = (dim * kw_num,) if cfg.parallel else (kw_num, dim)
        self.weight = nn.Parameter(torch.ones(shape))
        self.bias = nn.Parameter(torch.zeros(shape))
        self.register_buffer("running_mean", torch.zeros(shape))
        self.register_buffer("running_var", torch.ones(shape))

    def forward(self, keywords: torch.Tensor, training: bool = False,
                group=None) -> torch.Tensor:
        """`group`: the data-parallel group whose global batch gives the
        training statistics (``parallel/mesh.py``)."""
        args = (keywords, self.weight, self.bias, self.running_mean, self.running_var)
        if self.variant == "fixed":
            y, stats = kw_bn_fixed(*args, batchnorm_type=self.cfg.type,
                                   parallel=self.cfg.parallel, training=training,
                                   momentum=self.momentum, group=group)
        else:
            y, stats = kw_bn_dynamic(*args, training=training, momentum=self.momentum,
                                     group=group)
        if stats is not None:
            with torch.no_grad():
                self.running_mean.copy_(stats[0])
                self.running_var.copy_(stats[1])
        return y


class KeywordHead(nn.Module):
    """proj -> keyword BN -> L2 normalize -> cosine vs codebook -> VQ."""

    def __init__(self, cfg: KeywordHeadConfig, variant: str = "dynamic"):
        super().__init__()
        self.cfg = cfg
        if cfg.kw_proj_dims is None:
            self.linear_proj = nn.Linear(cfg.d_model, cfg.text_dim)
        else:
            self.linear_proj = MLPLayers(cfg.kw_proj_dims, cfg.kw_proj_dropout,
                                         compute_dtype=cfg.compute_dtype)
        if cfg.bn.enabled:
            self.bn_layer = KwBatchNorm(cfg.text_dim, cfg=cfg.bn, variant=variant,
                                        kw_num=cfg.keyword_num)
        self.vector_quantizer = SimpleVectorQuantizer(cfg.vq, cfg.fused_score_kernel)

    def forward(self, feats: torch.Tensor, token_embedding: torch.Tensor,
                training: bool = False, generator: Optional[torch.Generator] = None,
                global_step=None, group=None):
        cd, lp = self.cfg.compute_dtype, self.linear_proj
        if isinstance(lp, MLPLayers):
            x = lp(feats, generator)
        else:
            x = F.linear(feats.to(cd), lp.weight.to(cd), lp.bias.to(cd))
        if self.cfg.bn.enabled:
            with span("branch.kw_bn"):
                x = self.bn_layer(x, training, group)
        xf = x.float()
        xn = xf / xf.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        with span("branch.vq"):
            vq = self.vector_quantizer(xn, token_embedding.float(), cd, training, global_step,
                                       generator, group)
        keywords = vq.pop("keywords")
        return vq, keywords


def _prepend(cls: torch.Tensor, audio_feat: torch.Tensor, audio_len: torch.Tensor):
    """[cls; frames] and its key-padding mask."""
    b, t = audio_feat.shape[:2]
    k = cls.shape[1]
    src = torch.cat([cls.to(audio_feat.dtype).expand(b, k, -1), audio_feat], dim=1)
    return src, get_keypadding_mask(t + k, audio_len + k)


class ParallelBranch(nn.Module):
    """Reference KW_ParallelBranch (``kw_branches.py:200-282``)."""

    def __init__(self, ta: TransformerArgs, out_dim: int = 512, need_projection: bool = True,
                 kernel: bool = True):
        super().__init__()
        self.cls = nn.Parameter(torch.zeros(1, 1, ta.d_model))
        self.self_att = make_self_att(ta, kernel)
        self.linear_proj = nn.Linear(ta.d_model, out_dim) if need_projection else None

    def parallel_feature(self, audio_feat: torch.Tensor, audio_len: torch.Tensor,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        src, mask = _prepend(self.cls, audio_feat, audio_len)
        out = self.self_att(src, key_padding_mask=mask, generator=generator)[:, 0, :]
        return out if self.linear_proj is None else self.linear_proj(out.float())

    def forward(self, audio_feat: torch.Tensor, audio_len: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        return {"parallel_audio_feat": self.parallel_feature(audio_feat, audio_len, generator)}

    def extract_hidden_states(self, audio_feat, audio_len) -> Tuple[torch.Tensor, ...]:
        src, mask = _prepend(self.cls, audio_feat, audio_len)
        return tuple(h[:, 1:, :] for h in self.self_att.extract_hidden_states(src, mask))


class CascadedBranch(nn.Module):
    """Reference KW_CascadedBranch (``kw_branches.py:285-447``), fixed K:
    returns the keywords and the VQ results; the parent runs CLIP's
    `encode_keywords`."""

    def __init__(self, ta: TransformerArgs, head: KeywordHeadConfig, kernel: bool = True):
        super().__init__()
        self.cls = nn.Parameter(torch.zeros(1, head.keyword_num, ta.d_model))
        self.self_att = make_self_att(ta, kernel)
        self.head = KeywordHead(head, variant="fixed")

    def forward(self, audio_feat: torch.Tensor, audio_len: torch.Tensor,
                token_embedding: torch.Tensor, *, training: bool = False, global_step=None,
                generator: Optional[torch.Generator] = None, group=None,
                **_) -> Dict[str, torch.Tensor]:
        k = self.head.cfg.keyword_num
        src, mask = _prepend(self.cls, audio_feat, audio_len)
        out = self.self_att(src, key_padding_mask=mask, generator=generator)
        vq_results, keywords = self.head(out[:, :k, :], token_embedding, training, generator,
                                         global_step, group)
        return {"vq_results": vq_results, "keywords": keywords, "keyword_num": k}

    def extract_hidden_states(self, audio_feat, audio_len) -> Tuple[torch.Tensor, ...]:
        k = self.head.cfg.keyword_num
        src, mask = _prepend(self.cls, audio_feat, audio_len)
        return tuple(h[:, k:, :] for h in self.self_att.extract_hidden_states(src, mask))

    def get_attention_map(self, audio_feat: torch.Tensor,
                          audio_len: torch.Tensor) -> torch.Tensor:
        """Keyword-CLS attention weights (B, H, K, K + T) for visualization
        (reference `getAttentionMap`, ``kw_branches.py:384-447``)."""
        src, mask = _prepend(self.cls, audio_feat, audio_len)
        _, weights = self.self_att.extract_attention_map(src, key_padding_mask=mask)
        return weights[:, :, : self.head.cfg.keyword_num, :]


class HybridBranch(nn.Module):
    """Reference KW_HybridBranch (``kw_branches.py:450-577``): one shared
    transformer over [parallel CLS; K keyword CLS; frames]."""

    def __init__(self, ta: TransformerArgs, head: KeywordHeadConfig, out_dim: int = 512,
                 need_projection: bool = True,
                 parallel_proj_dims: Optional[Tuple[int, ...]] = None,
                 parallel_proj_dropout: float = 0.1, kernel: bool = True):
        super().__init__()
        self.parallel_cls = nn.Parameter(torch.zeros(1, 1, ta.d_model))
        self.cascaded_cls = nn.Parameter(torch.zeros(1, head.keyword_num, ta.d_model))
        self.self_att = make_self_att(ta, kernel)
        self.head = KeywordHead(head, variant="fixed")
        self.parallel_proj = None
        if need_projection:
            self.parallel_proj = (MLPLayers(parallel_proj_dims, parallel_proj_dropout)
                                  if parallel_proj_dims is not None
                                  else nn.Linear(ta.d_model, out_dim))

    def _attend(self, audio_feat, audio_len, generator=None):
        cls = torch.cat([self.parallel_cls, self.cascaded_cls], dim=1)
        src, mask = _prepend(cls, audio_feat, audio_len)
        return self.self_att(src, key_padding_mask=mask, generator=generator)

    def _project(self, cls_out: torch.Tensor) -> torch.Tensor:
        # fp32, and without dropout even in training: JAX calls the projection
        # with its default `deterministic=True` (``models/branches.py:585``)
        return cls_out if self.parallel_proj is None else self.parallel_proj(cls_out.float())

    def parallel_feature(self, audio_feat: torch.Tensor,
                         audio_len: torch.Tensor) -> torch.Tensor:
        """The parallel feature alone (no keyword head, VQ or text tower)."""
        return self._project(self._attend(audio_feat, audio_len)[:, 0, :])

    def forward(self, audio_feat: torch.Tensor, audio_len: torch.Tensor,
                token_embedding: torch.Tensor, *, training: bool = False, global_step=None,
                generator: Optional[torch.Generator] = None, group=None,
                **_) -> Dict[str, torch.Tensor]:
        k = self.head.cfg.keyword_num
        out = self._attend(audio_feat, audio_len, generator)
        vq_results, keywords = self.head(out[:, 1: 1 + k, :], token_embedding, training,
                                         generator, global_step, group)
        return {"parallel_audio_feat": self._project(out[:, 0, :]),
                "vq_results": vq_results, "keywords": keywords, "keyword_num": k}

    def extract_hidden_states(self, audio_feat, audio_len) -> Tuple[torch.Tensor, ...]:
        k = self.head.cfg.keyword_num + 1
        cls = torch.cat([self.parallel_cls, self.cascaded_cls], dim=1)
        src, mask = _prepend(cls, audio_feat, audio_len)
        return tuple(h[:, k:, :] for h in self.self_att.extract_hidden_states(src, mask))


def _downsample_head(branch, frames, pad_mask, token_embedding, target_len, global_step,
                     training, generator, group):
    """CIF, then the dynamic keyword head: the tail of both plus branches."""
    with span("branch.cif"):
        dsample = branch.downsampling(frames, pad_mask, target_len if training else None,
                                      global_step, training=training, generator=generator,
                                      group=group)
    if target_len is not None:
        dsample["target_len"] = target_len
    vq_results, keywords = branch.head(dsample["dsample_feats"], token_embedding, training,
                                       generator, global_step, group)
    return {"vq_results": vq_results, "keywords": keywords, "dsample_results": dsample,
            "keywords_len": dsample["dsample_feats_length"]}


class CascadedBranchPlus(nn.Module):
    """Reference KW_CascadedBranchPlus (``kw_branches.py:580-777``):
    transformer -> CIF downsampling -> dynamic keyword head."""

    def __init__(self, ta: TransformerArgs, head: KeywordHeadConfig, cif: CifConfig,
                 kernel: bool = True):
        super().__init__()
        self.self_att = make_self_att(ta, kernel)
        self.downsampling = CIF(cif)
        self.head = KeywordHead(head, variant="dynamic")

    def forward(self, audio_feat: torch.Tensor, audio_len: torch.Tensor,
                token_embedding: torch.Tensor, *, target_len: Optional[torch.Tensor] = None,
                global_step=None, training: bool = False,
                generator: Optional[torch.Generator] = None,
                group=None) -> Dict[str, torch.Tensor]:
        pad_mask = get_keypadding_mask(audio_feat.shape[1], audio_len)
        x = self.self_att(audio_feat, key_padding_mask=pad_mask, generator=generator)
        return _downsample_head(self, x, pad_mask, token_embedding, target_len, global_step,
                                training, generator, group)

    def extract_hidden_states(self, audio_feat, audio_len) -> Tuple[torch.Tensor, ...]:
        pad_mask = get_keypadding_mask(audio_feat.shape[1], audio_len)
        return tuple(self.self_att.extract_hidden_states(audio_feat, pad_mask))


class HybridBranchPlus(nn.Module):
    """Reference KW_HybridBranchPlus (``kw_branches.py:780-891``)."""

    def __init__(self, ta: TransformerArgs, head: KeywordHeadConfig, cif: CifConfig,
                 out_dim: int = 512, kernel: bool = True):
        super().__init__()
        self.cls = nn.Parameter(torch.zeros(1, 1, ta.d_model))
        self.self_att = make_self_att(ta, kernel)
        self.downsampling = CIF(cif)
        self.head = KeywordHead(head, variant="dynamic")
        self.parallel_proj = nn.Linear(ta.d_model, out_dim)

    def _attend(self, audio_feat: torch.Tensor, audio_len: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        src, mask = _prepend(self.cls, audio_feat, audio_len)
        return self.self_att(src, key_padding_mask=mask, generator=generator), mask

    def parallel_feature(self, audio_feat: torch.Tensor,
                         audio_len: torch.Tensor) -> torch.Tensor:
        """The parallel feature alone: the branch attention and the CLS
        projection, without CIF, the VQ or the text tower."""
        out, _ = self._attend(audio_feat, audio_len)
        return self.parallel_proj(out[:, 0, :].float())

    def forward(self, audio_feat: torch.Tensor, audio_len: torch.Tensor,
                token_embedding: torch.Tensor, *, target_len: Optional[torch.Tensor] = None,
                global_step=None, training: bool = False,
                generator: Optional[torch.Generator] = None,
                group=None) -> Dict[str, torch.Tensor]:
        """`target_len` and `global_step` drive CIF's train-time scaling;
        `generator` turns the dropouts on; `group` takes the keyword-BN and VQ
        statistics over the data-parallel global batch."""
        out, mask = self._attend(audio_feat, audio_len, generator)
        result = _downsample_head(self, out[:, 1:, :], mask[:, 1:], token_embedding,
                                  target_len, global_step, training, generator, group)
        result["parallel_audio_feat"] = self.parallel_proj(out[:, 0, :].float())
        return result

    def extract_hidden_states(self, audio_feat, audio_len) -> Tuple[torch.Tensor, ...]:
        src, mask = _prepend(self.cls, audio_feat, audio_len)
        return tuple(h[:, 1:, :] for h in self.self_att.extract_hidden_states(src, mask))
