"""PyTorch-Lightning SpeechCLIP(+) checkpoint importer.

Port of ``speechclip_plus_tpu/checkpoint/lightning_import.py``. The
reference's released `.ckpt` files hold a full `state_dict` (frozen HuBERT
and CLIP, the branch, keyword-BN statistics, the loss temperature), the model
config under `hyper_parameters` (pickled `avssl` `OrderedNamespace` objects)
and Lightning's loop state. This module:

  - unpickles the file without the `avssl` package
    (`torch_import.trusted_torch_load`, whose shim class stands in for
    `OrderedNamespace`) into a flat numpy state dict and a `ConfigNode`;
  - fills a port `KWClip` for all five branch types: `audio_encoder.encoder.*`
    (fairseq names) -> the tower, `clip.model.*` (OpenAI names, the reduced
    token table as it is) -> CLIP, the branch and projection nets,
    `criterion.temperature` -> `criterion_log_inv_temp`, and the keyword BN
    with its running statistics (the per-keyword `bn_layers.{i}` of the
    fixed-K `eachKw` layout stacked to (K, D)).

The fill is strict both ways (`torch_import.load_port_state_dict`): a port
tensor left unfilled raises, and so does a reference key the mapping expects
and does not find. Unpickling runs arbitrary code from the file, so only
trusted files belong here.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Tuple

import numpy as np
import torch

from ..config import ConfigNode
from .torch_import import (_get, _NamespaceShim, copy_batchnorm, copy_packed_mha,
                           copy_weight_bias, load_port_state_dict, to_numpy,
                           trusted_torch_load)
from .towers import fairseq_hubert_to_port, openai_clip_to_port

__all__ = ["load_lightning_checkpoint", "lightning_to_kwclip"]


def _to_plain(obj):
    if isinstance(obj, _NamespaceShim):
        return _to_plain(obj.state)
    if isinstance(obj, (dict, OrderedDict)):
        return {k: _to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_plain(v) for v in obj)
    return obj


def load_lightning_checkpoint(path: str) -> Tuple[Dict[str, np.ndarray], ConfigNode, Dict]:
    """Returns (flat numpy state dict, the reference's ConfigNode, meta)."""
    ckpt = trusted_torch_load(path)
    sd = {k: to_numpy(v) for k, v in ckpt["state_dict"].items()}
    hp = _to_plain(ckpt.get("hyper_parameters", ckpt.get("hparams", {})))
    cfg_node = ConfigNode(hp.get("config", hp) or {})
    meta = {"epoch": ckpt.get("epoch"), "global_step": ckpt.get("global_step")}
    return sd, cfg_node, meta


def _mlp_or_linear(out: Dict, dst: str, sd: Dict, src: str, module) -> None:
    """`nn.Linear`, or `MLPLayers` (the reference's Sequential: indices 0, 3,
    6, ... are the Linears)."""
    if isinstance(module, torch.nn.Linear):
        return copy_weight_bias(out, dst, sd, src)
    for i in range(len(module.layers)):
        copy_weight_bias(out, f"{dst}layers.{i}.", sd, f"{src}sequential.{3 * i}.")


def _self_att(out: Dict, dst: str, sd: Dict, src: str, module) -> None:
    """`MultiheadAttentionAndNorm`, or `TransformerEncoder` (reference names
    `model.layers.{i}.*` and `model.norm`)."""
    if hasattr(module, "multihead_attn_layer"):
        copy_packed_mha(out, f"{dst}multihead_attn_layer.", sd, f"{src}multihead_attn_layer.")
        return copy_weight_bias(out, f"{dst}attentionBlock_Norm.", sd,
                                f"{src}attentionBlock_Norm.")
    for i in range(len(module.layers)):
        lp, dp = f"{src}model.layers.{i}.", f"{dst}layers.{i}."
        copy_packed_mha(out, f"{dp}self_attn.", sd, f"{lp}self_attn.")
        for name in ("linear1", "linear2", "norm1", "norm2"):
            copy_weight_bias(out, f"{dp}{name}.", sd, f"{lp}{name}.")
    copy_weight_bias(out, f"{dst}norm.", sd, f"{src}model.norm.")


def _keyword_bn(out: Dict, dst: str, sd: Dict, src: str, bn) -> None:
    """One BatchNorm (`bn_layer.bn_layer`: dynamic, `same`, or fixed `eachKw`
    fused over D*K channels, channel d*K + k in both packages), or the fixed
    per-keyword `bn_layer.bn_layers.{i}` stacked to the port's (K, D)."""
    if bn.variant == "fixed" and bn.cfg.type == "eachKw" and not bn.cfg.parallel:
        parts = [{} for _ in range(bn.weight.shape[0])]
        for i, part in enumerate(parts):
            copy_batchnorm(part, "", sd, f"{src}bn_layers.{i}.")
        for key in parts[0]:
            out[f"{dst}{key}"] = np.stack([part[key] for part in parts])
    else:
        copy_batchnorm(out, dst, sd, f"{src}bn_layer.")


def _branch(out: Dict, dst: str, sd: Dict, src: str, branch) -> None:
    """Any of the five branches: the CLS tokens it has, the transformer, the
    parallel projection, CIF and the keyword head (reference names: the head's
    `linear_proj` and `bn_layer` sit on the branch itself)."""
    for name in ("cls", "parallel_cls", "cascaded_cls"):
        if hasattr(branch, name):
            out[f"{dst}{name}"] = _get(sd, f"{src}{name}")
    _self_att(out, f"{dst}self_att.", sd, f"{src}self_att.", branch.self_att)
    for name in ("parallel_proj", "linear_proj"):
        if getattr(branch, name, None) is not None:
            _mlp_or_linear(out, f"{dst}{name}.", sd, f"{src}{name}.", getattr(branch, name))
    if hasattr(branch, "downsampling"):
        copy_weight_bias(out, f"{dst}downsampling.conv.", sd, f"{src}downsampling.conv.0.")
        copy_weight_bias(out, f"{dst}downsampling.weight_proj.", sd,
                         f"{src}downsampling.weight_proj.1.")
    if hasattr(branch, "head"):
        head = branch.head
        _mlp_or_linear(out, f"{dst}head.linear_proj.", sd, f"{src}linear_proj.",
                       head.linear_proj)
        if hasattr(head, "bn_layer"):
            _keyword_bn(out, f"{dst}head.bn_layer.", sd, f"{src}bn_layer.", head.bn_layer)


def lightning_to_kwclip(sd: Dict[str, np.ndarray], model) -> None:
    """Fill a port `KWClip` (any of the five branch types) from a flat
    Lightning state dict, in place."""
    c, out = model.cfg, {}
    if hasattr(c.audio, "arch"):
        raise NotImplementedError(f"a Lightning checkpoint with the {c.audio.kind} mel upstream: "
                                  "the importer maps the fairseq HuBERT-family tower only")
    for key, value in fairseq_hubert_to_port(sd, c.audio, prefix="audio_encoder.encoder.").items():
        out[f"audio_encoder.{key}"] = value
    ws = "audio_encoder.weightedsum_layer.weights"
    out["weightedsum"] = (_get(sd, ws) if ws in sd
                          else np.zeros(c.audio.num_hidden_states, np.float32))
    for key, value in openai_clip_to_port(sd, c.clip, prefix="clip.model.").items():
        out[f"clip.{key}"] = value
    if hasattr(model, "criterion_log_inv_temp"):
        out["criterion_log_inv_temp"] = _get(sd, "criterion.temperature").reshape(())
    for name in ("cascaded_branch", "parallel_branch"):
        if getattr(model, name) is not None:
            _branch(out, f"{name}.", sd, f"{name}.", getattr(model, name))
    for name in ("img_enc_proj_net", "p_branch_proj_net", "c_branch_proj_net"):
        if getattr(model, name) is not None:
            _mlp_or_linear(out, f"{name}.", sd, f"{name}.", getattr(model, name))
    load_port_state_dict(model, out)
