"""Model construction from a reference-format YAML config.

Port of ``speechclip_plus_tpu/tasks/builder.py``: resolve the reduced subword
vocabulary (``config.clip.reduce_subword_embbedding``, mapped onto this
repository's `assets/`), build the typed config and the model, initialize it
from a seed with an explicit `torch.Generator`, import the tower weights
where `audio_encoder.ckpt_path` (fairseq HuBERT) and `clip.ckpt_path`
(OpenAI CLIP) name files that exist (with `reinit_layers`, the selected
layers keep the seeded initialization: `reinit_hubert_layers`), and set
keyword BN from the token-table statistics. No weight files ship with the
repository, so the towers are seeded random weights at full width, as the
JAX builder leaves them when the files are missing (``:139-187``).
"""
from __future__ import annotations

import dataclasses
import logging
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..checkpoint.torch_import import load_port_state_dict, load_torch_state_dict
from ..checkpoint.towers import fairseq_hubert_to_port, openai_clip_to_port, reduce_token_embedding
from ..config import ConfigNode
from ..data.tokenizer import ReducedVocab
from ..models.kwclip import KWClip, KWClipConfig, init_kw_bn_from_token_embedding
from ..models.mel_upstreams import MelUpstreamConfig

__all__ = ["build_model_from_config", "resolve_reduced_vocab", "init_params",
           "reinit_hubert_layers"]

logger = logging.getLogger(__name__)

_REPO_ROOT = os.path.join(os.path.dirname(__file__), "..", "..")


def reinit_hubert_layers(imported: Dict[str, np.ndarray], random_state: Dict[str, np.ndarray],
                         layer_ids: Sequence[int]) -> Dict[str, np.ndarray]:
    """An imported tower state (port names relative to the tower) with the
    selected layers' tensors replaced by the seeded initialization's
    (reference `reinit_layers`, ``speech_encoder_plus.py:418-431``, JAX
    ``tasks/builder.py:45-68``); a new dict."""
    ids = {int(i) for i in layer_ids}
    out = dict(imported)
    for name, value in random_state.items():
        parts = name.split(".")
        if parts[0] == "layers" and int(parts[1]) in ids:
            out[name] = value
    return out


def _import_towers(cfg: ConfigNode, model: KWClip, model_cfg: KWClipConfig,
                   vocab: Optional[ReducedVocab]) -> None:
    """The tower weights from local files, where the YAML names ones that
    exist (JAX ``:139-187``); a missing file leaves the seeded weights."""
    path = getattr(cfg.audio_encoder, "ckpt_path", None)
    if isinstance(model_cfg.audio, MelUpstreamConfig):
        if path:  # JAX :139-150: only the wav2vec2/HuBERT family has a checkpoint format
            logger.warning(
                "audio_encoder.ckpt_path is only importable for the HuBERT/wav2vec2 tower "
                "(fairseq format); the %s mel upstream stays randomly initialized "
                "(import_torch_lstm_state covers the LSTM family)", model_cfg.audio.kind)
    elif path and os.path.exists(path):
        tower = model.audio_encoder
        arrays = fairseq_hubert_to_port(load_torch_state_dict(path), model_cfg.audio)
        if model_cfg.reinit_layers:
            seeded = {k: v.detach().float().cpu().numpy() for k, v in tower.state_dict().items()}
            arrays = reinit_hubert_layers(arrays, seeded, model_cfg.reinit_layers)
            logger.warning("Reinitialized encoder layers %s (reference "
                           "speech_encoder_plus.py:420-422)", model_cfg.reinit_layers)
        load_port_state_dict(tower, arrays)
        logger.info("Loaded HuBERT weights from %s", path)
    path = getattr(cfg.clip, "ckpt_path", None)
    if path and os.path.exists(path):
        full = dataclasses.replace(model_cfg.clip, vocab_size=49408)
        arrays = openai_clip_to_port(load_torch_state_dict(path), full)
        if vocab is not None:
            arrays = reduce_token_embedding(arrays, vocab.selected_ids)
        load_port_state_dict(model.clip, arrays)
        logger.info("Loaded CLIP weights from %s", path)


def resolve_reduced_vocab(cfg: ConfigNode) -> Optional[ReducedVocab]:
    path = getattr(cfg.clip, "reduce_subword_embbedding", None)
    if not path:
        return None
    if not os.path.exists(path):
        # reference layout (./avssl/data/<ds>_stat/<file>.npy) and bare
        # config paths map onto this repository's assets/ and root
        parent = os.path.basename(os.path.dirname(path))
        for alt in (os.path.join(_REPO_ROOT, "assets", parent, os.path.basename(path)),
                    os.path.join(_REPO_ROOT, path)):
            if os.path.exists(alt):
                path = alt
                break
    if not os.path.exists(path):
        raise FileNotFoundError(f"reduce_subword_embbedding file not found: {path}")
    return ReducedVocab.from_npy(
        path, sot_original=int(getattr(cfg.clip, "sot_original", 49406)),
        eot_original=int(getattr(cfg.clip, "eot_original", 49407)))


# parameters whose init is not the fan-in rule: (name suffix, std or constant)
_NORMAL_STD = {
    "cls": 1.0,
    "class_embedding": 0.02,
    "visual.positional_embedding": 0.02,
    "text.positional_embedding": 0.01,
    "token_embedding.weight": 0.02,
    "rel_attn_embed": 0.02,
}


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init on the CPU: fan-in normal for weights (lecun, as flax),
    zeros for biases, ones/zeros for norms, CLIP's stds for embeddings, and
    torch's U(-1/sqrt(H), 1/sqrt(H)) for every LSTM tensor (JAX
    ``nn/lstm.py:39-42``)."""
    norms = tuple(m for m in model.modules()
                  if isinstance(m, (nn.LayerNorm, nn.GroupNorm)))
    norm_weights = {id(m.weight) for m in norms}
    for name, p in model.named_parameters():
        if name == "criterion_log_inv_temp" or name.endswith("curr_temp"):
            continue  # log(1/T) and the VQ temperature, set by the model
        if "lstm" in name.split("."):  # (4H, ...) gate-stacked tensors
            p.uniform_(-(p.shape[0] // 4) ** -0.5, (p.shape[0] // 4) ** -0.5,
                       generator=generator)
        elif id(p) in norm_weights or name.endswith("gru_rel_pos_const"):
            p.fill_(1.0)
        elif name.endswith("bias") or name in ("weightedsum", "clip.logit_scale"):
            p.zero_()
        elif name.endswith(("proj", "text_projection")) and p.ndim == 2:
            p.copy_(torch.randn(p.shape, generator=generator) * p.shape[0] ** -0.5)
        else:
            std = next((v for k, v in _NORMAL_STD.items() if name.endswith(k)), None)
            if std is None:
                std = 1.0 / math.sqrt(max(1, p[0].numel()))
            p.copy_(torch.randn(p.shape, generator=generator) * std)


def build_model_from_config(
    cfg: ConfigNode, *, device="cuda", seed: int = 0,
) -> Tuple[KWClip, KWClipConfig, Optional[ReducedVocab]]:
    """Returns (model in eval mode on `device`, model_cfg, reduced_vocab). The
    model goes to the card unless the caller asks for the CPU; the seeded
    init itself runs on the CPU, so the weights do not depend on the device."""
    vocab = resolve_reduced_vocab(cfg)
    if vocab is not None:
        model_cfg = KWClipConfig.from_config(
            cfg, vocab_size=len(vocab), sot_id=int(vocab.sot_reduced),
            eot_id=int(vocab.eot_reduced))
    else:
        model_cfg = KWClipConfig.from_config(cfg)
    model = KWClip(model_cfg)
    init_params(model, torch.Generator().manual_seed(seed))
    _import_towers(cfg, model, model_cfg, vocab)
    init_kw_bn_from_token_embedding(model)
    return model.to(device).eval(), model_cfg, vocab
