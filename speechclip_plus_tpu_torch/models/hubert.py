"""HuBERT, WavLM and data2vec-audio acoustic towers, base and large.

Port of ``speechclip_plus_tpu/models/hubert.py`` (reference
``avssl/module/speech_encoder_plus.py:29-107``), frozen or trainable (below):

  conv frontend (GroupNorm on layer 0 only, exact-erf GELU) -> LayerNorm ->
  post_extract_proj -> zero padded frames -> + weight-normed pos_conv
  (k=128, 16 groups) -> encoder LayerNorm -> 12 post-norm layers.

A frozen group-norm layer 0 (conv 0, GroupNorm, GELU) is one fused operation
on the card (`ops.conv_frontend.conv0_gn_gelu`, `ConvFeatureExtractor`).

data2vec-audio base (`HubertConfig.data2vec_base`, JAX ``:195-206``) keeps
the encoder and changes the two convolution stacks: a LayerNorm over
channels after every frontend conv (`extractor_mode="layer_norm"`, no conv
bias, JAX ``:492-575``) and five stacked positional convs (k=19, 16 groups),
each followed by a LayerNorm without affine over channels and exact-erf GELU
(`pos_conv_depth=5`, JAX ``:628-680``). Both stacks run channel-first for the
convolutions and transpose once per layer for the norm. data2vec's
per-utterance waveform normalization is the dataset's
(`data.dataset.normalize_waveform`, `data.audio.waveform_layer_norm`): the
tower does not apply it, as in JAX.

Each layer's attention takes one of four routes, in the JAX layer's order of
precedence (``:794-910``):

  1. WavLM through K1 (`rel_pos_bias` and `fused_attention_block`): the
     shared (H, T, T) relative position bias and the per-row gate are kernel
     inputs, so the (B, H, T, T) gated bias never exists;
  2. WavLM plain (`rel_pos_bias` without the fused block): the full gated
     bias through `dot_product_attention`;
  3. K1 with the out-projection fused in (`fused_attention_block`, the
     default for a frozen tower, the card being the accelerator);
  4. plain q/k/v/out projections around K5 (`fused_attention_dropout`), K4
     (`use_flash_attention`, only without attention dropout) or
     `dot_product_attention`.

WavLM (`rel_pos_bias`): one bucketed relative-position table
`rel_attn_embed` (buckets, H) owned by the model is gathered to (H, T, T)
once per forward (``:993-1005``, span `tower.relpos`); each layer gates it
per head and query from its input (`rel_pos_gate`, ``:775-790``, span
`tower.gate`).

In training (a generator passed) the tower runs its dropouts
at the JAX sites, all p=0.1 for HuBERT-base: features after the projection
(JAX ``:967``), the encoder input (``:982``), the two residual branches
(``:920``, ``:928-929``) and the attention weights inside K1;
`activation_dropout` is 0 (``:917``). The reference trains with dropout on
in the frozen tower (`audio_encoder.frozen_dropout`, default true). The
softmax-weighted sum over the L+1 hidden states (13, or 25 large) is accumulated inside the layer loop (JAX ``:1016-1044``), so no (L+1, B, T, D)
stack exists. The pos-conv weight norm is materialized to one kernel, as the
JAX side stores it (``:627-680``), and a trainable tower trains that kernel.

The large towers (`HubertConfig.large`, `wavlm_large`, `data2vec_large`, JAX
``:174-212``) are 24 layers of D=1024 with 16 heads (K1 at dh=64). HuBERT-Large
and WavLM-Large add a bias to every frontend conv (`conv_bias`, JAX ``:66``,
``:501``) and run their layers pre-norm (`layer_norm_first`, JAX ``:924-930``):
`x + drop(attn(ln(x)))`, then `x + drop(ffn(ln(x)))`, K1 taking the normed
input and the residual staying outside it. The encoder LayerNorm of a
pre-norm tower keeps its parameters (the checkpoints carry them) but is not
applied to the hidden states (JAX ``:973-980``). data2vec-large is the base
data2vec structure at large width (post-norm, no conv bias).

A trainable tower (`audio_encoder.trainable`, `unfreeze_layers`,
`reinit_layers`; JAX ``:93-132``, ``:1000-1050``) takes gradients through
every layer: its hidden states and their weighted-sum contributions keep
theirs (JAX's `stop_contrib_gradient=not audio_trainable`), its attention
takes the plain route (K1 is forward-only, so `fused_attention_block` is off,
as JAX turns it off), and under bf16 its parameters are fp32 masters
(`KWClip` casts them) cast to the compute dtype at use, as flax keeps them. In
training (a generator passed) `layer_drop` skips each layer with that
probability, one Bernoulli keep per layer per step from the step's
generator; a dropped layer passes its input through (JAX ``:1009-1011``,
``:746``). `remat` recomputes each layer in the backward
(`torch.utils.checkpoint`, JAX `nn.remat`): the layer's dropouts draw from
a generator set to the state the step's generator had before the layer, in
the forward and again in the recompute, so both build the same masks, and
the step's generator then moves on as if the layer had drawn from it.

Under tensor parallelism (``parallel/tp.py``) each encoder layer runs
Megatron-style on its model group: the attention on this rank's heads (K1
fused-out, or the plain routes, on the head range; the WavLM gate and the
shared position bias computed whole and sliced to those heads) with the
out-projection row-parallel, `fc1` column-parallel and `fc2` row-parallel,
each row-parallel product summed in fp32 over the model group before its
bias (`tp_heads`, `tp_ffn`; `shard_model` sets them).

Layouts at the public surface follow JAX: waveforms (B, T), features
(B, T', D).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..nn.attention import MultiheadAttention, dot_product_attention, padding_bias
from ..nn.dropout import dropout
from ..nn.flash import flash_attention
from ..nn.fused_attention import fused_attention_dropout
from ..nn.transformer import LayerNorm
from ..ops.conv_frontend import conv0_gn_gelu, plain_conv0_gn_gelu
from ..ops.weighted_sum import layer_norm
from ..parallel.tp import copy_to_model, row_parallel_linear
from ..utils.profiling import span

__all__ = ["HubertConfig", "HubertModel", "downsample_padding_mask",
           "relative_position_buckets"]


@dataclasses.dataclass(frozen=True)
class HubertConfig:
    conv_layers: Tuple[Tuple[int, int, int], ...] = (
        (512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2), (512, 3, 2),
        (512, 2, 2), (512, 2, 2),
    )
    # "group_norm": GroupNorm on layer 0 (HuBERT, WavLM); "layer_norm": a
    # LayerNorm over channels after every conv (data2vec)
    extractor_mode: str = "group_norm"
    conv_bias: bool = False  # a bias on every frontend conv (HuBERT-Large, WavLM-Large)
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    ffn_dim: int = 3072
    # pre-norm layers, and no encoder LayerNorm on the hidden states (large)
    layer_norm_first: bool = False
    conv_pos: int = 128
    conv_pos_groups: int = 16
    # data2vec's stacked positional conv: depth x [conv -> LayerNorm without
    # affine -> GELU]; 1 = the single fairseq pos_conv
    pos_conv_depth: int = 1
    # WavLM's gated relative position bias (JAX ``:78-84``)
    rel_pos_bias: bool = False
    rel_buckets: int = 320
    rel_max_distance: int = 800
    dropout: float = 0.1
    attention_dropout: float = 0.1
    # the probability that a training step skips a layer (fairseq LayerDrop)
    layer_drop: float = 0.0
    # each layer recomputed in the backward (a trainable tower)
    remat: bool = False
    # K1 per layer (forward only: a frozen tower). On by default: the JAX
    # default is "on for a frozen tower on the accelerator"
    fused_attention_block: bool = True
    # K5: attention only, in-kernel dropout, plain projections
    # (`audio_encoder.fused_attention`)
    fused_attention_dropout: bool = False
    # K4: the flash forward, for long audio; taken only without attention
    # dropout (no YAML key, as in the JAX package)
    use_flash_attention: bool = False
    # the compute dtype, and the parameters' as built (a trainable tower's
    # are then made fp32 masters, cast to it at use)
    dtype: torch.dtype = torch.float32

    @property
    def downsample_rate(self) -> int:
        r = 1
        for _, _, s in self.conv_layers:
            r *= s
        return r

    @property
    def num_hidden_states(self) -> int:
        return self.n_layers + 1

    @staticmethod
    def large() -> "HubertConfig":
        """fairseq HuBERT-Large (`hubert_large_ll60k`): the layer-norm frontend
        with conv bias, 24 pre-norm layers of D=1024, 16 heads, FFN 4096."""
        return HubertConfig(extractor_mode="layer_norm", conv_bias=True, d_model=1024,
                            n_layers=24, n_heads=16, ffn_dim=4096, layer_norm_first=True)

    @staticmethod
    def wavlm_base() -> "HubertConfig":
        return HubertConfig(rel_pos_bias=True)

    @staticmethod
    def wavlm_large() -> "HubertConfig":
        """WavLM Large (arXiv:2110.13900): HuBERT-Large's block with the gated
        relative position bias, 320 buckets up to distance 800. `conv_bias`
        is HuBERT-Large's, as JAX resolves it: WavLM's own `WavLMConfig`
        defaults it to False, and the published checkpoint's configuration is
        not in the repository. The waveform `normalize` of its checkpoints
        is the dataset's (`data.dataset.normalize_waveform`)."""
        return dataclasses.replace(HubertConfig.large(), rel_pos_bias=True)

    @staticmethod
    def data2vec_base() -> "HubertConfig":
        """fairseq data2vec audio base (HF `Data2VecAudioModel`)."""
        return HubertConfig(extractor_mode="layer_norm", conv_pos=19, pos_conv_depth=5)

    @staticmethod
    def data2vec_large() -> "HubertConfig":
        return dataclasses.replace(HubertConfig.data2vec_base(), d_model=1024, n_layers=24,
                                   n_heads=16, ffn_dim=4096)

    @staticmethod
    def from_upstream_name(name: str) -> "HubertConfig":
        """An s3prl / reference `audio_encoder.name` to its tower (JAX ``:215``)."""
        n = name.lower()
        large = "large" in n
        if "wavlm" in n:
            return HubertConfig.wavlm_large() if large else HubertConfig.wavlm_base()
        if "data2vec" in n:
            return HubertConfig.data2vec_large() if large else HubertConfig.data2vec_base()
        if "hubert" in n or "wav2vec2" in n:
            return HubertConfig.large() if large else HubertConfig()
        raise NotImplementedError(
            f"audio_encoder.name={name!r} is not a wav2vec2/HuBERT-family tower (HuBERT, "
            "WavLM, data2vec-audio); `KWClipConfig.from_config` then tries the mel "
            "upstreams (models/mel_upstreams.py)")

    @staticmethod
    def tiny(**kw) -> "HubertConfig":
        """`speechclip_plus_tpu.models.hubert.HubertConfig.tiny`."""
        defaults = dict(conv_layers=((16, 3, 2), (16, 3, 2)), d_model=32, n_layers=2,
                        n_heads=4, ffn_dim=64, conv_pos=16, conv_pos_groups=2)
        defaults.update(kw)
        return HubertConfig(**defaults)


def downsample_padding_mask(wav_padding_mask: torch.Tensor, n_frames: int) -> torch.Tensor:
    """fairseq `forward_padding_mask`: a frame is padding iff all of its
    waveform samples are (JAX ``models/hubert.py:297``)."""
    b, t_wav = wav_padding_mask.shape
    extra = t_wav % n_frames
    if extra > 0:
        wav_padding_mask = wav_padding_mask[:, :-extra]
    return wav_padding_mask.reshape(b, n_frames, -1).all(dim=-1)


@functools.lru_cache(maxsize=32)
def relative_position_buckets(t: int, num_buckets: int, max_distance: int) -> torch.Tensor:
    """WavLM / T5 bucketed relative positions of a (T, T) self-attention, int64
    on the CPU (JAX ``:683-706``): the sign picks the half, small distances
    map one to one, large ones log-spaced up to `max_distance`. The log ratio
    is formed in float32 with the operations in the JAX function's order and
    truncated, so the bucket edges agree with it; it is always formed on the
    CPU (another device's log may differ in the last bit, which would move an
    edge) and cached, being a function of T alone. Do not write to the result."""
    pos = torch.arange(t)
    rel = pos[None, :] - pos[:, None]
    num = num_buckets // 2
    max_exact = num // 2
    ad = rel.abs()
    log_ratio = torch.log(ad.clamp_min(1).to(torch.float32) / max_exact)
    log_max = torch.log(torch.tensor(max_distance / max_exact, dtype=torch.float32))
    large = max_exact + (log_ratio / log_max * (num - max_exact)).to(torch.int64)
    large = large.clamp_max(num - 1)
    return (rel > 0).to(torch.int64) * num + torch.where(ad < max_exact, ad, large)


def _channel_layer_norm(x: torch.Tensor, norm: Optional[nn.Module]) -> torch.Tensor:
    """LayerNorm over the channels of a channel-first (B, C, T) activation,
    then exact-erf GELU, in x's dtype and layout: one transpose each way.
    `F.layer_norm` keeps its statistics and affine in fp32 whatever x's dtype
    and rounds once at the end, as JAX's fp32 norm does, without an fp32 copy
    of the frontend's largest activation. `norm` None is data2vec's pos-conv
    norm, without affine."""
    y = x.transpose(1, 2)
    if norm is None:
        y = F.layer_norm(y, y.shape[-1:], eps=1e-5)
    else:
        y = F.layer_norm(y, norm.normalized_shape, norm.weight.to(y.dtype),
                         norm.bias.to(y.dtype), norm.eps)
    return F.gelu(y).transpose(1, 2)


def _linear(x: torch.Tensor, mod: nn.Linear, cd: torch.dtype) -> torch.Tensor:
    """mod(x) in the compute dtype: the parameters cast at use (a no-op for a
    tower stored in it)."""
    bias = None if mod.bias is None else mod.bias.to(cd)
    return F.linear(x.to(cd), mod.weight.to(cd), bias)


def _conv1d(x: torch.Tensor, mod: nn.Conv1d, cd: torch.dtype) -> torch.Tensor:
    bias = None if mod.bias is None else mod.bias.to(cd)
    return F.conv1d(x.to(cd), mod.weight.to(cd), bias, mod.stride, mod.padding, mod.dilation,
                    mod.groups)


class ConvFeatureExtractor(nn.Module):
    """Waveform (B, T) -> frames (B, T', C), run channel-first as torch convs
    want: conv -> [GroupNorm(C, C) on layer 0] -> GELU (`group_norm` mode), or
    conv -> LayerNorm over channels -> GELU at every layer (`layer_norm`).

    A group-norm layer 0 whose result needs no gradient (grad mode off, or
    neither the waveform nor conv 0's and the GroupNorm's parameters require
    one) and whose conv has no bias runs `ops.conv_frontend.conv0_gn_gelu`:
    on the card one fused operation that never stores the raw conv output
    nor an fp32 copy of it, on the CPU its twin. A trainable layer 0 runs the
    twin (`plain_conv0_gn_gelu`, the composite) through autograd."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.mode, self.cd = cfg.extractor_mode, cfg.dtype
        if self.mode not in ("group_norm", "layer_norm"):
            raise NotImplementedError(f"extractor_mode {self.mode!r}")
        convs, cin = [], 1
        for ch, k, s in cfg.conv_layers:
            convs.append(nn.Conv1d(cin, ch, k, stride=s, bias=cfg.conv_bias, dtype=cfg.dtype))
            cin = ch
        self.conv_layers = nn.ModuleList(convs)
        if self.mode == "group_norm":
            ch0 = cfg.conv_layers[0][0]
            self.gn = nn.GroupNorm(ch0, ch0, dtype=cfg.dtype)
        else:
            self.layer_norms = nn.ModuleList(LayerNorm(ch, dtype=cfg.dtype)
                                             for ch, _, _ in cfg.conv_layers)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        with span("tower.frontend.layer0"):
            x = (self._group_norm_layer0(wav.to(self.cd)) if self.mode == "group_norm"
                 else self._layer(0, wav[:, None, :].to(self.cd)))
        for i in range(1, len(self.conv_layers)):
            x = self._layer(i, x)
        return x.transpose(1, 2)

    def _group_norm_layer0(self, wav: torch.Tensor) -> torch.Tensor:
        conv, gn = self.conv_layers[0], self.gn
        needs_grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in (wav, conv.weight, gn.weight, gn.bias))
        if needs_grad or conv.bias is not None:
            return plain_conv0_gn_gelu(wav, conv.weight, gn.weight, gn.bias, gn.eps,
                                       conv.stride[0], bias=conv.bias)
        return conv0_gn_gelu(wav.contiguous(), conv.weight, gn.weight, gn.bias, gn.eps,
                             stride=conv.stride[0])

    def _layer(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Conv i, its LayerNorm over channels (`layer_norm` mode) and GELU;
        a group-norm frontend's layer 0 is `_group_norm_layer0`."""
        x = _conv1d(x, self.conv_layers[i], self.cd)
        if self.mode == "layer_norm":
            return _channel_layer_norm(x, self.layer_norms[i])
        return F.gelu(x)


class PositionalConvEmbedding(nn.Module):
    """fairseq pos_conv: grouped Conv1d(k, pad k//2) + SamePad + GELU; with
    `pos_conv_depth` > 1 data2vec's stack of `layers`, each grouped conv ->
    LayerNorm without affine over channels -> GELU."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        k, self.cd = cfg.conv_pos, cfg.dtype
        conv = lambda: nn.Conv1d(cfg.d_model, cfg.d_model, k, padding=k // 2,
                                 groups=cfg.conv_pos_groups, dtype=cfg.dtype)
        if cfg.pos_conv_depth > 1:
            self.layers = nn.ModuleList(conv() for _ in range(cfg.pos_conv_depth))
        else:
            self.conv = conv()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.transpose(1, 2)
        if not hasattr(self, "layers"):
            out = _conv1d(x, self.conv, self.cd)
            if self.conv.kernel_size[0] % 2 == 0:
                out = out[:, :, :-1]
            return F.gelu(out).transpose(1, 2)
        for conv in self.layers:  # k=19: odd, so no SamePad trim
            x = _channel_layer_norm(_conv1d(x, conv, self.cd), None)
        return x.transpose(1, 2)


class HubertEncoderLayer(nn.Module):
    """fairseq TransformerSentenceEncoderLayer, post-norm or (`layer_norm_first`)
    pre-norm."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.d_model, cfg.dtype
        self.self_attn = MultiheadAttention(d, cfg.n_heads, fuse_out=True, dtype=dt,
                                            dropout=cfg.attention_dropout)
        self.self_attn_layer_norm = LayerNorm(d, dtype=dt)
        self.fc1 = nn.Linear(d, cfg.ffn_dim, dtype=dt)
        self.fc2 = nn.Linear(cfg.ffn_dim, d, dtype=dt)
        self.final_layer_norm = LayerNorm(d, dtype=dt)
        if cfg.rel_pos_bias:
            self.gru_rel_pos_linear = nn.Linear(d // cfg.n_heads, 8, dtype=dt)
            # fp32 like the gate it scales (a flax param without a dtype)
            self.gru_rel_pos_const = nn.Parameter(torch.ones(1, cfg.n_heads, 1, 1))
        # tensor parallelism (parallel/tp.py): the model group, and whether the
        # attention (by head) and the FFN are sharded
        self.tp, self.tp_heads, self.tp_ffn = None, False, False

    def rel_pos_gate(self, x: torch.Tensor) -> torch.Tensor:
        """WavLM's per-layer gate on the shared relative position bias, from
        the layer input split per head (HF `WavLMAttention`): (B, H, T) fp32."""
        b, t, d = x.shape
        h = self.cfg.n_heads
        with span("tower.gate"):
            gh = x.reshape(b, t, h, d // h).transpose(1, 2)
            proj = _linear(gh, self.gru_rel_pos_linear, self.cfg.dtype).float()
            proj = proj.reshape(b, h, t, 2, 4).sum(-1)
            gate_a, gate_b = torch.sigmoid(proj).split(1, dim=-1)
            gate = gate_a * (gate_b * self.gru_rel_pos_const - 1.0) + 2.0
            return gate[..., 0]

    def attention(self, x: torch.Tensor, key_padding_bias: Optional[torch.Tensor],
                  generator: Optional[torch.Generator],
                  position_bias: Optional[torch.Tensor]) -> torch.Tensor:
        c, att = self.cfg, self.self_attn
        h, h0, heads = att.head_range()
        gate = None
        if position_bias is not None:
            # computed whole from the layer input; a head shard takes its heads
            gate = self.rel_pos_gate(x)[:, h0: h0 + h]
            position_bias = position_bias[h0: h0 + h]
        if position_bias is not None and c.fused_attention_block:
            return att(x, key_padding_bias=key_padding_bias, generator=generator,
                       attn_bias=position_bias, attn_gate=gate)
        if position_bias is None and c.fused_attention_block:
            return att(x, key_padding_bias=key_padding_bias, generator=generator)
        q, k, v = att.project_qkv(x)
        p = c.attention_dropout
        heads_kw = {"head_offset": h0, "total_heads": heads}
        if position_bias is not None:
            bias = gate[..., None] * position_bias.float()[None]
            if key_padding_bias is not None:
                bias = bias + key_padding_bias[:, None, None, :]
            out = dot_product_attention(q, k, v, bias, p, generator, **heads_kw)
        elif c.fused_attention_dropout:
            out = fused_attention_dropout(q, k, v, key_padding_bias, dropout_rate=p,
                                          generator=generator, **heads_kw)
        elif c.use_flash_attention and (generator is None or p == 0.0):
            kpm = None if key_padding_bias is None else key_padding_bias < -1e20
            out = flash_attention(q, k, v, kpm)
        else:
            bias = None if key_padding_bias is None else key_padding_bias[:, None, None, :]
            out = dot_product_attention(q, k, v, bias, p, generator, **heads_kw)
        return att.project_out(out)

    def ffn(self, h: torch.Tensor) -> torch.Tensor:
        """fc2(gelu(fc1(h))) in the compute dtype; sharded, fc1
        column-parallel and fc2 row-parallel over the model group."""
        cd = self.cfg.dtype
        if not self.tp_ffn:
            return _linear(F.gelu(_linear(h, self.fc1, cd)), self.fc2, cd)
        h = F.gelu(_linear(copy_to_model(h, self.tp), self.fc1, cd))
        return row_parallel_linear(h, self.fc2.weight.to(cd), self.fc2.bias.to(cd), self.tp, cd)

    def forward(self, x: torch.Tensor, key_padding_bias: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None,
                position_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        c, g, ffn = self.cfg, generator, self.ffn
        # activation_dropout is 0 (JAX :917)
        if c.layer_norm_first:
            attn = self.attention(self.self_attn_layer_norm(x), key_padding_bias, g,
                                  position_bias)
            x = x + dropout(attn, c.dropout, g)
            return x + dropout(ffn(self.final_layer_norm(x)), c.dropout, g)
        attn = self.attention(x, key_padding_bias, g, position_bias)
        x = self.self_attn_layer_norm(x + dropout(attn, c.dropout, g))
        return self.final_layer_norm(x + dropout(ffn(x), c.dropout, g))


class HubertModel(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        c_out = cfg.conv_layers[-1][0]
        self.feature_extractor = ConvFeatureExtractor(cfg)
        self.layer_norm = LayerNorm(c_out, dtype=dt)
        self.post_extract_proj = (nn.Linear(c_out, cfg.d_model, dtype=dt)
                                  if c_out != cfg.d_model else None)
        self.pos_conv = PositionalConvEmbedding(cfg)
        self.encoder_layer_norm = LayerNorm(cfg.d_model, dtype=dt)
        self.layers = nn.ModuleList(HubertEncoderLayer(cfg) for _ in range(cfg.n_layers))
        if cfg.rel_pos_bias:
            # fp32 in every precision: the (H, T, T) bias is a kernel input in fp32
            self.rel_attn_embed = nn.Parameter(torch.empty(cfg.rel_buckets, cfg.n_heads))
            self._buckets = {}  # (T, device) -> the flat bucket index on that device

    def position_bias(self, t: int) -> Optional[torch.Tensor]:
        """WavLM's shared relative position bias (H, T, T), gathered from the one
        table once per forward; None for HuBERT."""
        c = self.cfg
        if not c.rel_pos_bias:
            return None
        dev = self.rel_attn_embed.device
        with span("tower.relpos"):
            if (t, dev) not in self._buckets:
                if len(self._buckets) >= 16:  # a handful of lengths in practice (length buckets)
                    self._buckets.clear()
                self._buckets[(t, dev)] = relative_position_buckets(
                    t, c.rel_buckets, c.rel_max_distance).reshape(-1).to(dev)
            # (T*T, H) gathered rows -> one contiguous (H, T, T) tensor for every layer
            return self.rel_attn_embed[self._buckets[(t, dev)]].t().reshape(c.n_heads, t, t)

    def forward(self, wav: torch.Tensor, wav_padding_mask: torch.Tensor,
                layer_weights: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None,
                return_hidden_states: bool = False,
                normalize_contrib: bool = False,
                layer_drop_generator: Optional[torch.Generator] = None) -> dict:
        """wav (B, T), wav_padding_mask (B, T) bool (True = pad), layer_weights
        (L+1,) fp32 softmax weights, or None for no weighted sum; `generator`
        turns the dropouts (and LayerDrop) on. LayerDrop's one draw for the
        whole batch comes from `layer_drop_generator` where given (data
        parallelism: a generator every rank shares, JAX's one global draw),
        else from `generator`. Returns the last hidden state
        `x`, the fp32 `weighted_sum` (B, T', D) and the frame `padding_mask`
        (B, T'), with LayerDrop the (L,) bool `layer_keep`; with
        `return_hidden_states` also `hidden_states`, the
        (L+1, B, T', D) stack of the encoder input and every layer's output in
        the tower's dtype. `normalize_contrib` layer-norms each hidden state in
        fp32 (no parameters, eps 1e-5) before its weight (s3prl's normalized
        sum, JAX ``:748-751``, ``:1020-1023``). The hidden states carry the
        gradient of whatever tower parameters take one (none for a frozen
        tower, whose weighted sum then takes gradients into `layer_weights`
        alone)."""
        c, g = self.cfg, generator
        p = c.dropout
        with span("tower.frontend"):
            feats = self.feature_extractor(wav)
        with span("tower.prenet"):
            pad = downsample_padding_mask(wav_padding_mask, feats.shape[1])
            feats = self.layer_norm(feats)
            if self.post_extract_proj is not None:
                feats = _linear(feats, self.post_extract_proj, c.dtype)
            x = dropout(feats, p, g).masked_fill(pad[:, :, None], 0.0)
            x = x + self.pos_conv(x)
            if not c.layer_norm_first:  # a pre-norm tower keeps the norm unapplied
                x = self.encoder_layer_norm(x)
            x = dropout(x, p, g)
        bias = padding_bias(pad)
        position_bias = self.position_bias(x.shape[1])
        keep = None
        if c.layer_drop > 0.0 and g is not None:
            keep = torch.empty(len(self.layers), device=x.device).bernoulli_(
                1.0 - c.layer_drop,
                generator=g if layer_drop_generator is None else layer_drop_generator).bool()

        def contrib(h):
            h = h.float()
            return layer_norm(h) if normalize_contrib else h

        acc = None
        if layer_weights is not None:
            with span("tower.wsum"):
                acc = layer_weights[0] * contrib(x)
        hidden = None
        if return_hidden_states:  # filled layer by layer: one copy of the stack
            hidden = x.new_empty((len(self.layers) + 1, *x.shape))
            hidden[0] = x
        for i, layer in enumerate(self.layers):
            with span("tower.layer", layer=i):
                y = self._run_layer(layer, x, bias, g, position_bias)
                x = y if keep is None else torch.where(keep[i], y, x)
            if acc is not None:
                with span("tower.wsum"):
                    acc = acc + layer_weights[i + 1] * contrib(x)
            if hidden is not None:
                hidden[i + 1] = x
        out = {"x": x, "weighted_sum": acc, "padding_mask": pad}
        if keep is not None:
            out["layer_keep"] = keep
        if hidden is not None:
            out["hidden_states"] = hidden
        return out

    def _run_layer(self, layer, x, bias, generator, position_bias):
        """One layer, recomputed in the backward under `remat` when it takes
        a gradient; its dropouts draw from a generator set to the step
        generator's state before the layer, in the forward and again in the
        recompute, and the step generator continues from where the layer's
        draws left it."""
        if not (self.cfg.remat and torch.is_grad_enabled()
                and (x.requires_grad or any(p.requires_grad for p in layer.parameters()))):
            return layer(x, bias, generator, position_bias)
        if generator is None:
            return checkpoint(layer, x, bias, None, position_bias, use_reentrant=False,
                              preserve_rng_state=False)
        start, end = generator.get_state(), {}

        def run(h):
            g = torch.Generator(device=generator.device)
            g.set_state(start)
            out = layer(h, bias, g, position_bias)
            end["state"] = g.get_state()
            return out

        out = checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)
        generator.set_state(end["state"])
        return out
