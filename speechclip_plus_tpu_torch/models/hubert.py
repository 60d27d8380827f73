"""HuBERT-base acoustic tower (the fairseq `FairseqHubert` base path).

Port of ``speechclip_plus_tpu/models/hubert.py`` (reference
``avssl/module/speech_encoder_plus.py:29-107``), forward only (the tower is
frozen):

  conv frontend (GroupNorm on layer 0 only, exact-erf GELU) -> LayerNorm ->
  post_extract_proj -> zero padded frames -> + weight-normed pos_conv
  (k=128, 16 groups) -> encoder LayerNorm -> 12 post-norm layers.

Each layer's attention is the fused attention block with the out-projection
fused in (K1). In training (a generator passed) the tower runs its dropouts
at the JAX sites, all p=0.1 for HuBERT-base: features after the projection
(JAX ``:967``), the encoder input (``:982``), the two residual branches
(``:920``, ``:928-929``) and the attention weights inside K1;
`activation_dropout` is 0 (``:917``). The reference trains with dropout on
in the frozen tower (`audio_encoder.frozen_dropout`, default true). The softmax-weighted sum over the 13 hidden states is
accumulated inside the layer loop (JAX ``:1016-1044``), so no (13, B, T, D)
stack exists. The pos-conv weight norm is materialized to one kernel, as the
JAX side stores it (``:627-680``): the tower is frozen.

Layouts at the public surface follow JAX: waveforms (B, T), features
(B, T', D). Large / WavLM / data2vec variants are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.attention import MultiheadAttention, padding_bias
from ..nn.dropout import dropout
from ..nn.transformer import LayerNorm

__all__ = ["HubertConfig", "HubertModel", "downsample_padding_mask"]


@dataclasses.dataclass(frozen=True)
class HubertConfig:
    conv_layers: Tuple[Tuple[int, int, int], ...] = (
        (512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2), (512, 3, 2),
        (512, 2, 2), (512, 2, 2),
    )
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    ffn_dim: int = 3072
    conv_pos: int = 128
    conv_pos_groups: int = 16
    dropout: float = 0.1
    attention_dropout: float = 0.1
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
    def from_upstream_name(name: str) -> "HubertConfig":
        n = name.lower()
        if ("hubert" in n or "wav2vec2" in n) and "large" not in n:
            return HubertConfig()
        raise NotImplementedError(
            f"audio_encoder.name={name!r}: the PyTorch port has the HuBERT-base "
            "tower only (large, WavLM, data2vec and mel upstreams are later slices)")

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


class ConvFeatureExtractor(nn.Module):
    """Waveform (B, T) -> frames (B, T', C): conv (no bias) -> [GroupNorm(C, C)
    on layer 0] -> GELU, run channel-first as torch convs want."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        convs, cin = [], 1
        for ch, k, s in cfg.conv_layers:
            convs.append(nn.Conv1d(cin, ch, k, stride=s, bias=False, dtype=cfg.dtype))
            cin = ch
        self.conv_layers = nn.ModuleList(convs)
        self.gn = nn.GroupNorm(cfg.conv_layers[0][0], cfg.conv_layers[0][0], dtype=cfg.dtype)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = wav[:, None, :].to(self.gn.weight.dtype)
        for i, conv in enumerate(self.conv_layers):
            x = conv(x)
            if i == 0:
                # per-(utterance, channel) statistics over time, in fp32
                xf = x.float()
                mean = xf.mean(dim=-1, keepdim=True)
                var = xf.var(dim=-1, unbiased=False, keepdim=True)
                xf = (xf - mean) * torch.rsqrt(var + self.gn.eps)
                x = (xf * self.gn.weight.float()[:, None]
                     + self.gn.bias.float()[:, None]).to(x.dtype)
            x = F.gelu(x)
        return x.transpose(1, 2)


class PositionalConvEmbedding(nn.Module):
    """fairseq pos_conv: grouped Conv1d(k, pad k//2) + SamePad + GELU."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        k = cfg.conv_pos
        self.conv = nn.Conv1d(cfg.d_model, cfg.d_model, k, padding=k // 2,
                              groups=cfg.conv_pos_groups, dtype=cfg.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv(x.transpose(1, 2))
        if self.conv.kernel_size[0] % 2 == 0:
            out = out[:, :, :-1]
        return F.gelu(out).transpose(1, 2)


class HubertEncoderLayer(nn.Module):
    """Post-norm fairseq TransformerSentenceEncoderLayer."""

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

    def forward(self, x: torch.Tensor, key_padding_bias: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        c, g = self.cfg, generator
        attn = self.self_attn(x, key_padding_bias=key_padding_bias, generator=g)
        x = self.self_attn_layer_norm(x + dropout(attn, c.dropout, g))
        h = F.gelu(self.fc1(x))  # activation_dropout is 0 (JAX :917)
        return self.final_layer_norm(x + dropout(self.fc2(h), c.dropout, g))


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

    def forward(self, wav: torch.Tensor, wav_padding_mask: torch.Tensor,
                layer_weights: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> dict:
        """wav (B, T), wav_padding_mask (B, T) bool (True = pad), layer_weights
        (L+1,) fp32 softmax weights; `generator` turns the dropouts on.
        Returns the last hidden state `x`, the fp32 `weighted_sum` (B, T', D)
        and the frame `padding_mask` (B, T'). The hidden states take no
        gradient (frozen tower): the weighted sum's only gradient is into
        `layer_weights`, which keeps each fp32 hidden state for it."""
        p, g = self.cfg.dropout, generator
        feats = self.feature_extractor(wav)
        pad = downsample_padding_mask(wav_padding_mask, feats.shape[1])
        feats = self.layer_norm(feats)
        if self.post_extract_proj is not None:
            feats = self.post_extract_proj(feats)
        x = dropout(feats, p, g).masked_fill(pad[:, :, None], 0.0)
        x = dropout(self.encoder_layer_norm(x + self.pos_conv(x)), p, g)
        bias = padding_bias(pad)
        acc = layer_weights[0] * x.float().detach()
        for i, layer in enumerate(self.layers):
            x = layer(x, bias, g)
            acc = acc + layer_weights[i + 1] * x.float().detach()
        return {"x": x, "weighted_sum": acc, "padding_mask": pad}
