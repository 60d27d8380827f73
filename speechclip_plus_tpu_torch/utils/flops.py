"""Analytic per-step FLOP count of the KWClip training step (port of
``speechclip_plus_tpu/utils/flops.py``).

The model-FLOP share of a step (`mfu_analytic`) divides this count by the
step's time and the card's dense peak. It counts the dominant matrix work
(dots and convolutions) from the model's configuration and the batch's
shape, so each term can be checked by hand.

Counting conventions (standard MFU accounting, the PaLM appendix):
  - 2 FLOPs per multiply-add; only matmuls and convolutions are counted
    (softmax, norms, GELU, dropout, VQ statistics are O(N*D) elementwise
    work: under 1% at these shapes).
  - fwd+bwd multipliers: a module that takes no gradient costs 1x its
    forward, one that passes input gradients only (the frozen CLIP text
    tower fed by trainable keywords) 2x, a trainable one 3x (dX and dW).
  - attention's score and context products count 2 * B * H * Tq * Tk * dh
    each.
  - recomputation (remat) and LayerDrop's skipped layers are not counted:
    the count is the model's, not the schedule's.

It reads a `models.kwclip.KWClipConfig` (any object with its fields) and
imports neither torch nor jax. The keys and the arithmetic are the JAX
count's, except where that count differs from what the model runs; the port
counts what it runs (ROADMAP C):
  - the branch's sequence: [parallel CLS; frames] for parallel and hybrid+,
    [K keyword CLS; frames] for cascaded, [parallel CLS; K keyword CLS;
    frames] for hybrid, the frames alone for cascaded+ (JAX counts
    frames + 1 + K, or frames + 1, for every cascaded family);
  - a parallel branch only where the model builds one: without a cascaded
    objective (JAX also counts one beside a non-hybrid cascaded branch);
  - data2vec's positional convolution: `pos_conv_depth` layers (JAX counts
    one);
  - a subset policy (`unfreeze_layers` / `reinit_layers`) trains only the
    selected layers: the frontend and the positional convolution take no
    gradient (1x), a selected layer 3x, any other layer 2x where a gradient
    has to pass it on the way to a trainable tensor below it (the post-norm
    tower's `encoder_layer_norm`, ahead of layer 0, trains), else 1x (JAX
    counts 3x for the whole tower);
  - a trainable text tower trains the token table the keyword head scores
    against: the head counts 3x (JAX counts 2x, input gradients only).
"""
from __future__ import annotations

from typing import Dict, Sequence

__all__ = ["train_step_flops", "conv_out_len", "branch_sequence", "audio_layer_multipliers"]


def conv_out_len(wav_len: int, conv_layers) -> int:
    t = wav_len
    for (_c, k, s) in conv_layers:
        t = (t - k) // s + 1
    return t


def _conv_stack_flops(B: int, wav_len: int, conv_layers) -> float:
    t, cin, total = wav_len, 1, 0.0
    for (c, k, s) in conv_layers:
        t = (t - k) // s + 1
        total += 2.0 * B * t * c * cin * k
        cin = c
    return total


def _transformer_flops(tokens: int, d: int, ffn: int, n_layers: int, seq: int, *,
                       has_ffn: bool = True) -> float:
    """Forward FLOPs of a standard post/pre-norm encoder stack.

    tokens = B * seq. Attention scores + context each cost
    2 * tokens * seq * d (summing over heads restores the full d)."""
    per = 2.0 * tokens * d * (3 * d)          # QKV projection
    per += 2.0 * tokens * d * d               # output projection
    per += 2.0 * 2.0 * tokens * seq * d       # scores + context
    if has_ffn:
        per += 2.0 * 2.0 * tokens * d * ffn   # two FFN matmuls
    return per * n_layers


def _mlp_flops(tokens: int, dims, d_in: int) -> float:
    total, prev = 0.0, d_in
    for d in dims or ():
        total += 2.0 * tokens * prev * d
        prev = d
    return total


def branch_sequence(cfg, frames: int) -> int:
    """The length of the sequence the cascaded / hybrid branch's
    self-attention runs at (`models/branches.py`)."""
    K = cfg.head.keyword_num
    return {"CascadedBranch": frames + K, "CascadedBranch_plus": frames,
            "HybridBranch": frames + 1 + K, "HybridBranch_plus": frames + 1}[cfg.branch_type]


def audio_layer_multipliers(cfg) -> Sequence[float]:
    """The fwd+bwd multiplier of each layer of the wav2vec2/HuBERT tower."""
    audio = cfg.audio
    n = audio.n_layers
    if not cfg.audio_trainable:
        return [1.0] * n
    sel = set(cfg.reinit_layers) or set(cfg.unfreeze_layers)
    if not sel:
        return [3.0] * n
    # a post-norm tower's encoder LayerNorm sits ahead of layer 0 and trains
    first = 0 if not audio.layer_norm_first else min(sel)
    return [3.0 if i in sel else 2.0 if i >= first else 1.0 for i in range(n)]


def train_step_flops(cfg, batch_size: int, wav_len: int, *,
                     cached_image: bool = False) -> Dict[str, float]:
    """Per-component analytic FLOPs of one training step.

    `cfg` is a KWClipConfig. Returns a dict of component -> FLOPs plus
    "total". `cached_image=True` drops the image tower (the product
    default for a frozen image tower caches its features)."""
    B = batch_size
    out: Dict[str, float] = {}
    audio = cfg.audio

    audio_mult = 3.0 if cfg.audio_trainable else 1.0
    image_mult = 3.0 if cfg.image_encoder_trainable else 1.0
    # keywords are trainable inputs to the frozen text tower -> input grads
    text_mult = 3.0 if cfg.text_encoder_trainable else 2.0

    conv_layers = getattr(audio, "conv_layers", None)
    if conv_layers:
        frames = conv_out_len(wav_len, conv_layers)
        layer_mults = audio_layer_multipliers(cfg)
        subset = bool(set(cfg.reinit_layers) or set(cfg.unfreeze_layers))
        front_mult = 1.0 if subset else audio_mult
        out["hubert_conv_frontend"] = front_mult * _conv_stack_flops(B, wav_len, conv_layers)
        # positional conv: grouped (d, k=conv_pos, groups), pos_conv_depth of them
        out["hubert_pos_conv"] = front_mult * 2.0 * B * frames * audio.d_model * (
            audio.d_model // audio.conv_pos_groups) * audio.conv_pos * audio.pos_conv_depth
        out["hubert_stack"] = sum(layer_mults) * _transformer_flops(
            B * frames, audio.d_model, audio.ffn_dim, 1, frames)
    else:  # mel upstreams: the mel frontend's matmul is negligible; count the stack
        # frame count as ops/mel.py: (n - win)//hop + 1
        frames = max(0, (wav_len - audio.win) // audio.hop + 1)
        d = audio.d_model
        if audio.arch == "lstm":
            # APC/VQ-APC: 4 gates of (in + H) x H per token per layer, layer 0
            # on n_mels inputs (no attention, no FFN)
            per_token = 0.0
            for i in range(audio.n_layers):
                in_dim = audio.n_mels if i == 0 else d
                per_token += 2.0 * 4.0 * d * (in_dim + d)
            out["upstream_stack"] = audio_mult * B * frames * per_token
        else:
            out["upstream_stack"] = audio_mult * _transformer_flops(
                B * frames, d, audio.ffn_dim, audio.n_layers, frames)

    clip = cfg.clip
    if not cached_image:
        patches = (clip.image_resolution // clip.vision_patch_size) ** 2
        out["clip_image_tower"] = image_mult * (
            _transformer_flops(B * (patches + 1), clip.vision_width, 4 * clip.vision_width,
                               clip.vision_layers, patches + 1)
            # patch-embedding conv = one matmul over 3*P^2 inputs
            + 2.0 * B * patches * clip.vision_width * 3 * clip.vision_patch_size ** 2
            + 2.0 * B * clip.vision_width * clip.embed_dim)  # CLS projection

    has_cascaded = bool(cfg.cascaded_objective_weight > 0 and cfg.branch_type)
    if has_cascaded:
        out["clip_text_tower"] = text_mult * (
            _transformer_flops(B * clip.context_length, clip.text_width, 4 * clip.text_width,
                               clip.text_layers, clip.context_length)
            + 2.0 * B * clip.text_width * clip.embed_dim)  # text projection

    # the branch transformer: hybrid shares ONE self_att over both CLS kinds;
    # the parallel branch exists only without a cascaded one (models/kwclip.py)
    is_plus = cfg.branch_type.endswith("_plus")
    kmax = cfg.cif.max_feat_len if (is_plus and cfg.cif) else cfg.head.keyword_num
    branch_mult = 3.0

    def ta_flops(ta, seq):
        return branch_mult * _transformer_flops(
            B * seq, ta.d_model, ta.dim_feedforward, ta.n_layers, seq,
            has_ffn=(ta.type == "TransformerEncoder"))

    if has_cascaded:
        out["branch_self_att"] = ta_flops(cfg.cascaded_ta, branch_sequence(cfg, frames))
    elif cfg.parallel_objective_weight > 0:
        out["parallel_self_att"] = ta_flops(cfg.parallel_ta, frames + 1)

    if has_cascaded:
        # keyword projection MLP on K (or <=75) keyword slots
        out["kw_projection"] = branch_mult * _mlp_flops(
            B * kmax, cfg.head.kw_proj_dims or (cfg.head.text_dim,), cfg.head.d_model)
        # cosine scores vs the token table + the codebook product; the table
        # takes a gradient only with a trainable text tower
        V = clip.vocab_size
        head_mult = 3.0 if cfg.text_encoder_trainable else 2.0
        out["keyword_head"] = head_mult * (
            2.0 * B * kmax * cfg.head.text_dim * V      # scores
            + 2.0 * B * kmax * V * cfg.head.text_dim)   # prob @ table
        if is_plus and cfg.cif is not None:
            c = cfg.cif
            if c.produce_weight_type == "conv":
                out["cif_alpha"] = branch_mult * 2.0 * B * frames * (
                    c.encoder_embed_dim * c.conv_cif_width * c.out_dim) * c.num_layer
            else:
                out["cif_alpha"] = branch_mult * 2.0 * B * frames * (
                    c.encoder_embed_dim * c.out_dim)
            # integrate-and-fire bin-overlap matmul (ops/cif.py):
            # (B, 75, T) @ (B, T, D)
            out["cif_fire"] = branch_mult * 2.0 * B * kmax * frames * c.out_dim

    # post projections and the loss similarities are O(B*D^2) or O(B^2*D),
    # well under 1%; count the two similarity matmuls for completeness
    out["loss_similarity"] = 3.0 * 2.0 * 2.0 * B * B * clip.embed_dim

    out["total"] = float(sum(out.values()))
    return out
