"""High-level library API (port of ``speechclip_plus_tpu/api.py``).

The reference's library usage (`example.py:10-33`):

    model = load_from_checkpoint(path)
    feat, hidden_states = model.feature_extractor_s3prl(wav=[...])
    out = model.encode_speech(wav=[...])

`SpeechCLIP(model, device)` wraps a KWClip model for inference on ragged
host-side waveform lists: they are padded to the same length buckets as the
JAX package (`_BUCKETS`), int16 PCM stays int16 on the host (half the
transfer bytes) and is scaled by 1/32768 on the device. `load_from_checkpoint`
builds one from a directory the Trainer saved (`<save_path>/checkpoints`, the
config inside) or from a reference PyTorch-Lightning `.ckpt`; both run on the
card unless the caller passes `device="cpu"`.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .config import ConfigNode, load_config
from .models.kwclip import KWClip, KWClipConfig
from .utils.profiling import span

__all__ = ["SpeechCLIP", "load_from_checkpoint"]

_BUCKETS = (16000, 32000, 48000, 64000, 80000, 102400, 160000, 240000)
_PCM16_SCALE = 1.0 / 32768.0


def _wav_to_f32(wav: torch.Tensor) -> torch.Tensor:
    """Device-side dtype gate: float waveforms as-is, int16 PCM scaled."""
    if wav.dtype == torch.int16:
        return wav.to(torch.float32) * _PCM16_SCALE
    return wav


def _pad_wavs(wavs: Sequence[np.ndarray], buckets=_BUCKETS) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a ragged waveform list to a bucketed (B, T) host batch + lengths;
    an all-int16 batch stays int16."""
    lens = np.array([len(w) for w in wavs], np.int64)
    t = int(lens.max())
    t = next((b for b in buckets if t <= b), t)
    dt = np.int16 if all(np.asarray(w).dtype == np.int16 for w in wavs) else np.float32
    out = np.zeros((len(wavs), t), dt)
    for i, w in enumerate(wavs):
        out[i, : len(w)] = np.asarray(w, dt)
    return out, lens


class SpeechCLIP:
    """Inference wrapper: a KWClip model (eval mode) on `device`, with the BPE
    tokenizer and the reduced vocabulary when the model has them (text
    queries, keyword ids in the full CLIP vocabulary)."""

    def __init__(self, model: KWClip, device="cuda", tokenizer=None, vocab=None):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self.vocab = vocab

    @property
    def cfg(self) -> KWClipConfig:
        return self.model.cfg

    def to_device(self, wavs: Sequence[np.ndarray], *, non_blocking: bool = False):
        """Pad on the host and copy (B, T) waveforms + lengths to the device;
        returns (wav fp32, wav_len, host buffers to keep alive until the copy
        has run)."""
        with span("serve.pad"):
            w, lens = _pad_wavs(wavs)
        with span("serve.copy"):
            w_host, l_host = torch.from_numpy(w), torch.from_numpy(lens)
            if non_blocking and self.device.type == "cuda":
                w_host, l_host = w_host.pin_memory(), l_host.pin_memory()
            wav = w_host.to(self.device, non_blocking=non_blocking)
            wav_len = l_host.to(self.device, non_blocking=non_blocking)
        return _wav_to_f32(wav), wav_len, (w_host, l_host)

    @torch.inference_mode()
    def encode_speech(self, wavs: Sequence[np.ndarray]) -> dict:
        """JAX `SpeechCLIP.encode_speech` (reference `kwClip.py:1042-1091`):
        parallel and cascaded features, VQ results, keywords, CIF results."""
        wav, wav_len, _ = self.to_device(wavs)
        return self.model.encode_speech(wav, wav_len)

    @torch.inference_mode()
    def feature_extractor_s3prl(self, wavs: Sequence[np.ndarray]
                                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """Reference `feature_extractor_s3prl` (`kwClip.py:965-997`): (the last
        hidden state, every hidden state: the tower's L+1, then the branch
        transformer's layers over the frames)."""
        wav, wav_len, _ = self.to_device(wavs)
        return self.model.feature_extractor(wav, wav_len)

    def extract_keywords(self, wavs: Sequence[np.ndarray]) -> dict:
        """Reference `extract_keywords` (`kwClip.py:1093-1103`): the VQ results
        with `targets_original`, the targets as ids of the full CLIP vocabulary
        (B, slots), when the model has a reduced vocabulary; and the CIF
        results."""
        out = self.encode_speech(wavs)
        vq = dict(out["vq_results"]) if out.get("vq_results") else None
        if vq is not None and self.vocab is not None:
            targets = vq["targets"].reshape(len(wavs), -1).cpu().numpy()
            vq["targets_original"] = self.vocab.to_original(targets)
        return {"vq_results": vq, "dsample_results": out.get("dsample_results")}


def _tokenizer_for(cfg_node: ConfigNode):
    """The BPE tokenizer of `data.dataset.bpe_path`, when that file exists."""
    data = getattr(cfg_node, "data", None)
    bpe = getattr(getattr(data, "dataset", None), "bpe_path", None)
    if bpe and os.path.exists(bpe):
        from .data.tokenizer import SimpleTokenizer

        return SimpleTokenizer(bpe)
    return None


def load_from_checkpoint(path: str, config: Optional[str] = None,
                         monitor: Optional[str] = None, device="cuda") -> SpeechCLIP:
    """A SpeechCLIP on `device` from a checkpoint, with no other argument: the
    config rides inside (reference `base_model.py:10-27`).

    A `*.ckpt` path is a reference PyTorch-Lightning file
    (`checkpoint.lightning_import`); `config`, a YAML path, is merged over
    its config. Any other path is a directory the Trainer saved
    (`<save_path>/checkpoints`): the config it embeds and the model of
    `CheckpointManager.restore`, the `last` step or `monitor`'s best."""
    from .checkpoint import CheckpointManager, lightning_to_kwclip, load_lightning_checkpoint
    from .tasks.builder import build_model_from_config

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_from_checkpoint: no CUDA device (pass device='cpu')")
    if path.endswith(".ckpt"):
        sd, cfg_node, _ = load_lightning_checkpoint(path)
        if config:
            cfg_node.deep_update(load_config(config))
        model, _, vocab = build_model_from_config(cfg_node, device="cpu")
        lightning_to_kwclip(sd, model)
    else:
        cfg_node = ConfigNode(CheckpointManager.load_config(path))
        model, _, vocab = build_model_from_config(cfg_node, device="cpu")
        CheckpointManager(path).restore(model, monitor=monitor)
    return SpeechCLIP(model, device, tokenizer=_tokenizer_for(cfg_node), vocab=vocab)
