"""Frozen-tower weight importers: reference torch state dicts -> the port's
`HubertModel` / `ClipModel` state dicts.

Port of ``speechclip_plus_tpu/checkpoint/towers.py``. The formats:

  - fairseq HuBERT (`hubert_base_ls960.pt`: `feature_extractor.conv_layers.{i}.0.*`,
    `encoder.layers.{i}.self_attn.{q,k,v}_proj`, weight-normed `encoder.pos_conv.0`;
    HuBERT-Large, `hubert_large_ll60k.pt`, adds the conv biases and a LayerNorm
    per conv, `feature_extractor.conv_layers.{i}.2.1.*`), also inside Lightning
    checkpoints under `audio_encoder.encoder.`;
  - HuggingFace HuBERT, WavLM (the bucketed relative-position table in layer
    0's attention and each layer's gate) and data2vec-audio (a LayerNorm per
    frontend conv, the stacked `pos_conv_embed.layers.{j}`), base and large
    (the large layers keep the base names; the frontend convs of HuBERT- and
    WavLM-Large carry a bias);
  - OpenAI CLIP (`visual.transformer.resblocks.{i}.*`, packed `in_proj`),
    also inside Lightning checkpoints under `clip.model.`;
  - HuggingFace CLIP (separate q / k / v, packed here).

Each importer returns `{port name: numpy array}` relative to the tower, for
`torch_import.load_port_state_dict`. The port's tower holds the packed,
unscaled `in_proj_weight` in q, k, v order, so no importer scales q. The
pos-conv weight norm is materialized to one kernel (the tower is frozen).
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np

from ..models.clip import ClipConfig
from ..models.hubert import HubertConfig
from .torch_import import _get, copy_packed_mha, copy_weight_bias, pack_qkv

__all__ = [
    "materialize_weight_norm",
    "fairseq_hubert_to_port",
    "hf_hubert_to_port",
    "hf_wavlm_to_port",
    "hf_data2vec_audio_to_port",
    "openai_clip_to_port",
    "hf_clip_to_port",
    "reduce_token_embedding",
    "hubert_config_from_fairseq_sd",
    "clip_config_from_openai_sd",
]


def materialize_weight_norm(g: np.ndarray, v: np.ndarray, dim: int = 2) -> np.ndarray:
    """torch weight_norm(w, dim): w = g * v / ||v|| with the norm taken over
    every axis except `dim` (fairseq's pos_conv uses dim=2, the kernel axis)."""
    axes = tuple(i for i in range(v.ndim) if i != dim)
    norm = np.sqrt(np.sum(v.astype(np.float64) ** 2, axis=axes, keepdims=True))
    return (v * (g / np.maximum(norm, 1e-12))).astype(v.dtype)


def _pos_conv(out: Dict, dst: str, sd: Mapping, src: str) -> None:
    """A plain weight, classic weight_norm (`weight_g` / `weight_v`) or the
    torch >= 2 parametrizations layout, into one `weight`, and the bias."""
    if f"{src}weight" in sd:
        w = _get(sd, f"{src}weight")
    elif f"{src}weight_g" in sd:
        w = materialize_weight_norm(_get(sd, f"{src}weight_g"), _get(sd, f"{src}weight_v"))
    else:
        w = materialize_weight_norm(_get(sd, f"{src}parametrizations.weight.original0"),
                                    _get(sd, f"{src}parametrizations.weight.original1"))
    out[f"{dst}weight"] = w
    out[f"{dst}bias"] = _get(sd, f"{src}bias")


def _encoder_layers(out: Dict, sd: Mapping, cfg: HubertConfig, src: str, names: Dict) -> None:
    """Every encoder layer: packed attention and the post-norm block, with the
    format's names (`names`: port name -> reference name)."""
    for i in range(cfg.n_layers):
        lp, dp = f"{src}encoder.layers.{i}.", f"layers.{i}."
        pack_qkv(out, f"{dp}self_attn.", sd, f"{lp}{names['self_attn']}.")
        for port, ref in names.items():
            if port != "self_attn":
                copy_weight_bias(out, f"{dp}{port}.", sd, f"{lp}{ref}.")


def _frontend(out: Dict, sd: Mapping, cfg: HubertConfig, conv: str, norm: str) -> None:
    """Frontend convs (with a bias where the config has one) and their norms:
    layer 0's GroupNorm, or a LayerNorm after every conv."""
    for i in range(len(cfg.conv_layers)):
        copy_weight_bias(out, f"feature_extractor.conv_layers.{i}.", sd, conv.format(i),
                         bias=cfg.conv_bias)
        if cfg.extractor_mode == "layer_norm":
            copy_weight_bias(out, f"feature_extractor.layer_norms.{i}.", sd, norm.format(i))
    if cfg.extractor_mode == "group_norm":
        copy_weight_bias(out, "feature_extractor.gn.", sd, norm.format(0))


_FAIRSEQ_LAYER = {"self_attn": "self_attn", "self_attn_layer_norm": "self_attn_layer_norm",
                  "fc1": "fc1", "fc2": "fc2", "final_layer_norm": "final_layer_norm"}
_HF_LAYER = {"self_attn": "attention", "self_attn_layer_norm": "layer_norm",
             "fc1": "feed_forward.intermediate_dense", "fc2": "feed_forward.output_dense",
             "final_layer_norm": "final_layer_norm"}


def fairseq_hubert_to_port(sd: Mapping, cfg: HubertConfig, prefix: str = "") -> Dict:
    """fairseq HubertModel state dict -> `HubertModel` state dict; `prefix`
    reads it out of a Lightning checkpoint (`audio_encoder.encoder.`)."""
    p, out = prefix, {}
    norm = (f"{p}feature_extractor.conv_layers.{{}}.2." if cfg.extractor_mode == "group_norm"
            else f"{p}feature_extractor.conv_layers.{{}}.2.1.")
    _frontend(out, sd, cfg, f"{p}feature_extractor.conv_layers.{{}}.0.", norm)
    copy_weight_bias(out, "layer_norm.", sd, f"{p}layer_norm.")
    if cfg.conv_layers[-1][0] != cfg.d_model:
        copy_weight_bias(out, "post_extract_proj.", sd, f"{p}post_extract_proj.")
    _pos_conv(out, "pos_conv.conv.", sd, f"{p}encoder.pos_conv.0.")
    copy_weight_bias(out, "encoder_layer_norm.", sd, f"{p}encoder.layer_norm.")
    _encoder_layers(out, sd, cfg, p, _FAIRSEQ_LAYER)
    return out


def _hf_wav2vec2(sd: Mapping, cfg: HubertConfig, prefix: str) -> Dict:
    """What HF HuBERT, WavLM and data2vec-audio share: the frontend, the
    feature projection, the encoder norm and the layers."""
    p, out = prefix, {}
    _frontend(out, sd, cfg, f"{p}feature_extractor.conv_layers.{{}}.conv.",
              f"{p}feature_extractor.conv_layers.{{}}.layer_norm.")
    copy_weight_bias(out, "layer_norm.", sd, f"{p}feature_projection.layer_norm.")
    copy_weight_bias(out, "post_extract_proj.", sd, f"{p}feature_projection.projection.")
    copy_weight_bias(out, "encoder_layer_norm.", sd, f"{p}encoder.layer_norm.")
    _encoder_layers(out, sd, cfg, p, _HF_LAYER)
    return out


def hf_hubert_to_port(sd: Mapping, cfg: HubertConfig, prefix: str = "") -> Dict:
    """HuggingFace `HubertModel` state dict -> `HubertModel` state dict."""
    out = _hf_wav2vec2(sd, cfg, prefix)
    _pos_conv(out, "pos_conv.conv.", sd, f"{prefix}encoder.pos_conv_embed.conv.")
    return out


def hf_wavlm_to_port(sd: Mapping, cfg: HubertConfig, prefix: str = "") -> Dict:
    """HuggingFace `WavLMModel` state dict -> `HubertModel` (`rel_pos_bias`)
    state dict: HF keeps the one relative-position table in layer 0's
    attention, the port in the model; each layer keeps its gate."""
    p = prefix
    out = hf_hubert_to_port(sd, cfg, p)
    out["rel_attn_embed"] = _get(sd, f"{p}encoder.layers.0.attention.rel_attn_embed.weight")
    for i in range(cfg.n_layers):
        lp = f"{p}encoder.layers.{i}.attention."
        copy_weight_bias(out, f"layers.{i}.gru_rel_pos_linear.", sd, f"{lp}gru_rel_pos_linear.")
        out[f"layers.{i}.gru_rel_pos_const"] = _get(sd, f"{lp}gru_rel_pos_const")
    return out


def hf_data2vec_audio_to_port(sd: Mapping, cfg: HubertConfig, prefix: str = "") -> Dict:
    """HuggingFace `Data2VecAudioModel` state dict -> `HubertModel`
    (`data2vec_base`) state dict: the stacked positional convs, plain weights."""
    out = _hf_wav2vec2(sd, cfg, prefix)
    for j in range(cfg.pos_conv_depth):
        copy_weight_bias(out, f"pos_conv.layers.{j}.", sd,
                         f"{prefix}encoder.pos_conv_embed.layers.{j}.conv.")
    return out


def hubert_config_from_fairseq_sd(sd: Mapping, prefix: str = "") -> HubertConfig:
    """Base or large from the tensor shapes of a fairseq / Lightning dict (JAX
    ``checkpoint/towers.py:275-280``)."""
    d_model = _get(sd, f"{prefix}encoder.layers.0.fc1.weight").shape[1]
    return HubertConfig.large() if d_model == 1024 else HubertConfig()


# ------------------------------------------------------------------ CLIP ----


def _clip_blocks(out: Dict, dst: str, sd: Mapping, src: str, n_layers: int, *, hf: bool) -> None:
    """Residual attention blocks: OpenAI's packed `attn`, or HF's separate
    q / k / v packed here."""
    for i in range(n_layers):
        dp = f"{dst}blocks.{i}."
        if hf:
            bp = f"{src}layers.{i}."
            pack_qkv(out, f"{dp}attn.", sd, f"{bp}self_attn.")
            names = {"ln_1": "layer_norm1", "ln_2": "layer_norm2", "c_fc": "mlp.fc1",
                     "c_proj": "mlp.fc2"}
        else:
            bp = f"{src}resblocks.{i}."
            copy_packed_mha(out, f"{dp}attn.", sd, f"{bp}attn.")
            names = {"ln_1": "ln_1", "ln_2": "ln_2", "c_fc": "mlp.c_fc", "c_proj": "mlp.c_proj"}
        for port, ref in names.items():
            copy_weight_bias(out, f"{dp}{port}.", sd, f"{bp}{ref}.")


def openai_clip_to_port(sd: Mapping, cfg: ClipConfig, prefix: str = "") -> Dict:
    """OpenAI CLIP state dict -> `ClipModel` state dict; `prefix` reads it out
    of a Lightning checkpoint (`clip.model.`)."""
    p, out = prefix, {}
    out["visual.conv1.weight"] = _get(sd, f"{p}visual.conv1.weight")
    for name in ("class_embedding", "positional_embedding", "proj"):
        out[f"visual.{name}"] = _get(sd, f"{p}visual.{name}")
    for name in ("ln_pre", "ln_post"):
        copy_weight_bias(out, f"visual.{name}.", sd, f"{p}visual.{name}.")
    _clip_blocks(out, "visual.transformer.", sd, f"{p}visual.transformer.", cfg.vision_layers,
                 hf=False)
    out["text.token_embedding.weight"] = _get(sd, f"{p}token_embedding.weight")
    for name in ("positional_embedding", "text_projection"):
        out[f"text.{name}"] = _get(sd, f"{p}{name}")
    _clip_blocks(out, "text.transformer.", sd, f"{p}transformer.", cfg.text_layers, hf=False)
    copy_weight_bias(out, "text.ln_final.", sd, f"{p}ln_final.")
    out["logit_scale"] = _get(sd, f"{p}logit_scale")
    return out


def hf_clip_to_port(sd: Mapping, cfg: ClipConfig) -> Dict:
    """HuggingFace `CLIPModel` state dict -> `ClipModel` state dict."""
    v, t, out = "vision_model.", "text_model.", {}
    out["visual.conv1.weight"] = _get(sd, f"{v}embeddings.patch_embedding.weight")
    out["visual.class_embedding"] = _get(sd, f"{v}embeddings.class_embedding")
    out["visual.positional_embedding"] = _get(sd, f"{v}embeddings.position_embedding.weight")
    copy_weight_bias(out, "visual.ln_pre.", sd, f"{v}pre_layrnorm.")
    _clip_blocks(out, "visual.transformer.", sd, f"{v}encoder.", cfg.vision_layers, hf=True)
    copy_weight_bias(out, "visual.ln_post.", sd, f"{v}post_layernorm.")
    out["visual.proj"] = _get(sd, "visual_projection.weight").T
    out["text.token_embedding.weight"] = _get(sd, f"{t}embeddings.token_embedding.weight")
    out["text.positional_embedding"] = _get(sd, f"{t}embeddings.position_embedding.weight")
    _clip_blocks(out, "text.transformer.", sd, f"{t}encoder.", cfg.text_layers, hf=True)
    copy_weight_bias(out, "text.ln_final.", sd, f"{t}final_layer_norm.")
    out["text.text_projection"] = _get(sd, "text_projection.weight").T
    out["logit_scale"] = _get(sd, "logit_scale")
    return out


def clip_config_from_openai_sd(sd: Mapping, prefix: str = "") -> ClipConfig:
    """A ClipConfig from an OpenAI-format state dict (ViT variants)."""
    p = prefix
    conv1 = _get(sd, f"{p}visual.conv1.weight")
    vision_width, patch = conv1.shape[0], conv1.shape[-1]
    grid = int(round((_get(sd, f"{p}visual.positional_embedding").shape[0] - 1) ** 0.5))
    layers = lambda stem: len({k[len(stem):].split(".")[0] for k in sd if k.startswith(stem)})
    text_width = _get(sd, f"{p}ln_final.weight").shape[0]
    vocab = _get(sd, f"{p}token_embedding.weight").shape[0]
    return ClipConfig(
        embed_dim=_get(sd, f"{p}text_projection").shape[1],
        image_resolution=grid * patch,
        vision_width=vision_width,
        vision_layers=layers(f"{p}visual.transformer.resblocks."),
        vision_heads=vision_width // 64,
        vision_patch_size=patch,
        context_length=_get(sd, f"{p}positional_embedding").shape[0],
        vocab_size=vocab,
        text_width=text_width,
        text_heads=text_width // 64,
        text_layers=layers(f"{p}transformer.resblocks."),
        sot_id=vocab - 2,
        eot_id=vocab - 1,
    )


def reduce_token_embedding(state: Dict, selected_ids: Sequence[int]) -> Dict:
    """Slice the text token table of a `ClipModel` state dict to a usage-ranked
    id subset (reference `clip_official.py:63-107`); returns a new dict. The
    caller sets `ClipConfig.vocab_size / sot_id / eot_id` from
    `data.tokenizer.ReducedVocab`."""
    out = dict(state)
    out["text.token_embedding.weight"] = np.asarray(
        state["text.token_embedding.weight"])[np.asarray(selected_ids)]
    return out
