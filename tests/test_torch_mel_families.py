"""The models built from a YAML with a mel upstream, against the JAX package.

`audio_encoder.name` set to a mel upstream in a base YAML (apc into
`parallel.yaml`, tera into `hybrid_plus.yaml`), parsed by both packages with
`trainer.precision` 32; the tower cut to width 32 and 2 layers and the rest
cut as `tests/test_torch_families.py` cuts it. `encode_speech` and 3
training steps with dropout off through that file's `check_small_family`, at
its tolerances, on 4800-sample waveforms (28 frames); JAX's `encode_speech`
under `jax.jit`.

The tower alone is `tests/test_torch_mel_upstreams.py`.
"""
import dataclasses
import os

import numpy as np
import pytest

import test_torch_families as fam
from speechclip_plus_tpu.config import load_config as jax_load_config
from speechclip_plus_tpu.models.clip import ClipConfig as JClipConfig
from speechclip_plus_tpu.models.hubert import HubertConfig as JHubertConfig
from speechclip_plus_tpu.models.kwclip import KWClipConfig as JKWClipConfig
from speechclip_plus_tpu.tasks.builder import resolve_reduced_vocab as jax_vocab

from speechclip_plus_tpu_torch.config import load_config
from speechclip_plus_tpu_torch.models.clip import ClipConfig
from speechclip_plus_tpu_torch.models.hubert import HubertConfig
from speechclip_plus_tpu_torch.models.kwclip import KWClipConfig
from speechclip_plus_tpu_torch.tasks.builder import resolve_reduced_vocab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mel_configs(path, name):
    """As `test_torch_families._configs`, with `audio_encoder.name` a mel
    upstream, cut to the tiny tower at the branch's width 32."""
    out = []
    for load, vocab_of, cfg_cls, clip_cls, hubert_cls in (
            (jax_load_config, jax_vocab, JKWClipConfig, JClipConfig, JHubertConfig),
            (load_config, resolve_reduced_vocab, KWClipConfig, ClipConfig, HubertConfig)):
        cfg = load(os.path.join(REPO, path))
        cfg.trainer.precision = 32
        cfg.audio_encoder.scheduler.warmup = 2
        cfg.audio_encoder.name = name
        vocab = vocab_of(cfg)
        mc = cfg_cls.from_config(cfg, vocab_size=len(vocab), sot_id=int(vocab.sot_reduced),
                                 eot_id=int(vocab.eot_reduced))
        small = fam._downscale(mc, clip_cls, hubert_cls)
        small = dataclasses.replace(small, audio=dataclasses.replace(
            mc.audio, d_model=fam.D, n_layers=2, n_heads=4, ffn_dim=64))
        out += [cfg, (mc, small)]
    return out


def _mel_batch():
    """`test_torch_families._batch` at 4800 samples (28 frames; a CIF target
    of 1-2 keywords)."""
    rng = np.random.RandomState(5)
    lens = np.array([4800, 3600, 4350, 2700, 4000, 4740], np.int64)
    wav = (0.3 * rng.randn(6, 4800)).astype(np.float32)
    wav[np.arange(4800)[None, :] >= lens[:, None]] = 0.0
    return {"wav": wav, "wav_len": lens, "id": np.array([4, 9, 2, 7, 4, 1]),
            "image": rng.randn(6, 32, 32, 3).astype(np.float32)}


@pytest.mark.parametrize("name,family", [("apc", "parallel"), ("tera", "hybrid_plus")])
def test_mel_family_matches_jax(monkeypatch, name, family):
    path = f"config/speechclip_plus/base/{family}.yaml"
    jcfg, (jfull, jsmall), cfg, (full, small) = _mel_configs(path, name)
    for mc in (full, jfull):
        assert type(mc.audio).__name__ == "MelUpstreamConfig" and mc.audio.kind == name
    assert full.audio.num_hidden_states == (3 if name == "apc" else 4)
    monkeypatch.setattr(fam, "_batch", _mel_batch)
    fam.check_small_family(jcfg, jsmall, cfg, small, family, jit_encode=True)
