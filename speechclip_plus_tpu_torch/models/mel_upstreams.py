"""Mel-input upstreams: APC / VQ-APC (LSTM), TERA / Mockingjay / DeCoAR 2.0
(transformer).

Port of ``speechclip_plus_tpu/models/mel_upstreams.py``. The reference's
`S3prlSpeechEncoderPlus` wraps any `s3prl.hub` upstream
(``avssl/module/speech_encoder_plus.py:110-146``); besides the wav2vec2 /
HuBERT family (``models/hubert.py``) the hub serves mel-spectrogram models
of two architectures:

- **LSTM predictive coding** (APC, VQ-APC): 80-d log-mel -> n stacked
  unidirectional LSTM layers (H=512). The hidden states are the layer
  outputs, L = n (no embedding state, as s3prl returns them).
- **Mel transformers** (TERA, Mockingjay, DeCoAR 2.0): 80-d log-mel ->
  `input_proj` -> LayerNorm (eps 1e-12) -> + sinusoidal positions -> dropout
  -> n post-norm `TransformerEncoderLayer`s (D=768, exact-erf GELU, eps
  1e-12). The hidden states are the embedding and every layer, L = n + 1.

A frozen tower's self-attention takes the frozen towers' route, K1 with the
out-projection fused in, forward only, with the attention dropout inside the
kernel (`TransformerEncoderLayer(fuse_out=True)`); JAX runs the same math as
plain attention in XLA (``nn/attention.py:134-139``). A trainable tower
(`audio_encoder.trainable`) takes that plain attention
(`fused_attention_block` off). Frames
whose samples are all padding (`downsample_padding_mask`) have their mel
zeroed and are masked keys. Parameters are fp32 and compute in the config's
dtype (flax `dtype=`); the LSTM recurrence stays fp32 (``nn/lstm.py``).

`MelUpstream.forward` follows the acoustic towers' contract
(`HubertModel.forward`), so `KWClip.forward_audio` drives either: the
softmax-weighted sum of the hidden states is accumulated layer by layer.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.dropout import dropout
from ..nn.lstm import LSTMStack
from ..nn.transformer import LayerNorm, TransformerEncoderLayer
from ..ops.mel import log_mel_spectrogram
from ..ops.weighted_sum import layer_norm
from .hubert import downsample_padding_mask

__all__ = ["MelUpstreamConfig", "MelUpstream", "import_torch_lstm_state"]


@dataclasses.dataclass(frozen=True)
class MelUpstreamConfig:
    kind: str = "apc"  # apc | vq_apc | tera | mockingjay | decoar2
    arch: str = "lstm"  # lstm | transformer
    d_model: int = 512
    n_layers: int = 3
    n_heads: int = 12
    ffn_dim: int = 3072
    n_mels: int = 80
    win: int = 400
    hop: int = 160
    n_fft: int = 512
    # every dropout of the tower: between LSTM layers; the transformer's
    # input, attention and residual dropouts (JAX uses this one rate for all)
    dropout: float = 0.1
    # the transformer layers' attention through K1 fused-out (forward only: a
    # frozen tower); off, the plain attention (a trainable tower)
    fused_attention_block: bool = True
    dtype: torch.dtype = torch.float32

    @property
    def downsample_rate(self) -> int:
        return self.hop

    @property
    def num_hidden_states(self) -> int:
        return self.n_layers if self.arch == "lstm" else self.n_layers + 1

    @staticmethod
    def from_upstream_name(name: str) -> "MelUpstreamConfig":
        """An s3prl `audio_encoder.name` to its mel upstream (JAX ``:84``)."""
        n = name.lower()
        if "apc" in n:  # apc, apc_360hr, apc_960hr, vq_apc, ...
            return MelUpstreamConfig(kind="vq_apc" if "vq" in n else "apc", arch="lstm",
                                     d_model=512, n_layers=3, dropout=0.0)
        for key, kind, layers in (("tera", "tera", 3), ("mockingjay", "mockingjay", 12),
                                  ("decoar", "decoar2", 12)):
            if key in n:
                return MelUpstreamConfig(kind=kind, arch="transformer", d_model=768,
                                         n_layers=layers, n_heads=12, ffn_dim=3072)
        raise NotImplementedError(
            f"audio_encoder.name={name!r}: the upstreams are the wav2vec2/HuBERT family "
            "(HuBERT, WavLM, data2vec-audio), APC/VQ-APC (mel LSTM) and "
            "TERA/Mockingjay/DeCoAR2 (mel transformer); other s3prl upstreams (npc, pase, "
            "...) are out of scope")


@functools.lru_cache(maxsize=16)
def _sinusoidal_positions(n: int, d: int, device) -> torch.Tensor:
    """(n, d) sin/cos positions, formed in float64, as fp32 on `device`,
    copied there once per length (do not write to it)."""
    pos = np.arange(n)[:, None].astype(np.float64)
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * (-np.log(10000.0) / d))
    pe = np.zeros((n, d), np.float64)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)[:, : d // 2]
    return torch.from_numpy(pe.astype(np.float32)).to(device)


class MelUpstream(nn.Module):
    def __init__(self, cfg: MelUpstreamConfig):
        super().__init__()
        self.cfg = c = cfg
        if c.arch == "lstm":
            self.lstm = LSTMStack(c.n_mels, c.d_model, c.n_layers, c.dropout)
        elif c.arch == "transformer":
            self.input_proj = nn.Linear(c.n_mels, c.d_model)
            self.input_norm = LayerNorm(c.d_model, eps=1e-12, compute_dtype=c.dtype)
            self.layers = nn.ModuleList(
                TransformerEncoderLayer(c.d_model, c.n_heads, c.ffn_dim, c.dropout, "gelu",
                                        1e-12, norm_first=False, compute_dtype=c.dtype,
                                        fuse_out=True, kernel=c.fused_attention_block)
                for _ in range(c.n_layers))
        else:
            raise NotImplementedError(f"mel upstream arch {c.arch!r}")

    def forward(self, wav: torch.Tensor, wav_padding_mask: torch.Tensor,
                layer_weights: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None,
                return_hidden_states: bool = False,
                normalize_contrib: bool = False,
                layer_drop_generator: Optional[torch.Generator] = None) -> dict:
        """As `HubertModel.forward`: wav (B, T), wav_padding_mask (B, T) bool
        (True = pad), layer_weights (L,) fp32 softmax weights or None;
        `generator` turns the dropouts on (no LayerDrop: `layer_drop_generator`
        is accepted and unused). Returns `x` (the last hidden state),
        the fp32 `weighted_sum` (B, T', D) or None, the frame `padding_mask`
        (B, T'), and with `return_hidden_states` the (L, B, T', D)
        `hidden_states` in the tower's dtype. `normalize_contrib` layer-norms
        each hidden state in fp32 before its weight (s3prl's normalized sum)."""
        c, g = self.cfg, generator
        mel = log_mel_spectrogram(wav, n_mels=c.n_mels, win=c.win, hop=c.hop, n_fft=c.n_fft)
        pad = downsample_padding_mask(wav_padding_mask, mel.shape[1])
        mel = mel.masked_fill(pad[:, :, None], 0.0)
        hidden, acc = [], None

        def keep(i, h):
            nonlocal acc
            if layer_weights is not None:
                f = layer_norm(h.float()) if normalize_contrib else h.float()
                acc = layer_weights[i] * f if acc is None else acc + layer_weights[i] * f
            if return_hidden_states:
                hidden.append(h)

        if c.arch == "lstm":
            for i, h in enumerate(self.lstm(mel, g)):
                x = h.to(c.dtype)
                keep(i, x)
        else:
            cd, proj = c.dtype, self.input_proj
            x = self.input_norm(F.linear(mel.to(cd), proj.weight.to(cd), proj.bias.to(cd)))
            pe = _sinusoidal_positions(x.shape[1], c.d_model, x.device)
            x = dropout(x + pe.to(x.dtype), c.dropout, g)
            keep(0, x)
            for i, layer in enumerate(self.layers):
                x = layer(x, pad, g)
                keep(i + 1, x)
        out = {"x": x, "weighted_sum": acc, "padding_mask": pad}
        if return_hidden_states:
            out["hidden_states"] = torch.stack(hidden)
        return out


def import_torch_lstm_state(state_dict: dict, n_layers: int, prefix: str = "") -> dict:
    """`torch.nn.LSTM(num_layers=n)` state-dict tensors (`{prefix}weight_ih_l{i}`
    ...) -> the state dict of an `LSTMStack` (`layer_{i}.weight_ih_l0` ...)."""
    out = {}
    for i in range(n_layers):
        for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
            out[f"layer_{i}.{name}_l0"] = torch.as_tensor(
                np.asarray(state_dict[f"{prefix}{name}_l{i}"]))
    return out
