"""The mel-input upstreams in the port against the JAX package (fp32, CPU).

APC / VQ-APC (LSTM) and TERA / Mockingjay / DeCoAR 2.0 (mel transformer):
the log-mel frontend (`ops/mel.py`), the LSTM (`nn/lstm.py`), the tower
(`models/mel_upstreams.py`), the name resolution, the builder's warning
and the refusals. The same numpy inputs go through both packages; weights
move through `checkpoint/from_jax.py`, which fails on a JAX leaf it does not
read. Tiny widths (d=16, 2 layers, 3200-sample waveforms), as
`tests/test_mel_upstreams.py`. The models built from the YAMLs with a mel
upstream are `tests/test_torch_mel_families.py`.

Tolerances: the frame count and the filterbank exact; the log-mel at the JAX
test's own 1e-4 (rtol and atol; both sides take an fp32 FFT); the LSTM and
the towers at 1e-5 abs.

The card's route of the tower (K1 fused-out, cuDNN's LSTM) is held against
these twins in `tests/test_torch_cuda_kernels.py`.
"""
import dataclasses
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechclip_plus_tpu.models.mel_upstreams import MelUpstream as JMelUpstream
from speechclip_plus_tpu.models.mel_upstreams import MelUpstreamConfig as JMelUpstreamConfig
from speechclip_plus_tpu.models.mel_upstreams import (
    import_torch_lstm_state as jax_import_torch_lstm_state,
)
from speechclip_plus_tpu.nn.lstm import LSTMStack as JLSTMStack
from speechclip_plus_tpu.ops import mel as jax_mel

from speechclip_plus_tpu_torch.checkpoint.from_jax import load_mel_upstream
from speechclip_plus_tpu_torch.config import load_config
from speechclip_plus_tpu_torch.models.kwclip import KWClipConfig
from speechclip_plus_tpu_torch.models.mel_upstreams import (
    MelUpstream,
    MelUpstreamConfig,
    import_torch_lstm_state,
)
from speechclip_plus_tpu_torch.nn.lstm import LSTMStack
from speechclip_plus_tpu_torch.ops import mel
from speechclip_plus_tpu_torch.tasks.builder import build_model_from_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(d_model=16, n_layers=2, n_heads=4, ffn_dim=32)


def _wav(lens=(3200, 2000, 1000), t=3200, seed=1):
    """Seeded waveforms, zero past each length, and the padding mask."""
    rng = np.random.RandomState(seed)
    wav = (0.3 * rng.randn(len(lens), t)).astype(np.float32)
    pad = np.arange(t)[None, :] >= np.asarray(lens)[:, None]
    wav[pad] = 0.0
    return wav, pad


# ------------------------------------------------------------- mel ----


def test_frame_count_and_filterbank_are_jax_s():
    for n in (0, 399, 400, 559, 560, 3200, 16000, 102400):
        assert mel.mel_frame_count(n) == jax_mel.mel_frame_count(n)
    assert mel.mel_frame_count(102400) == 638
    for args in ((80, 512, 16000), (40, 400, 8000), (80, 512, 16000, 20.0, 7600.0)):
        got, want = mel.mel_filterbank(*args), jax_mel.mel_filterbank(*args)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_log_mel_matches_jax_with_ragged_padding():
    wav, _ = _wav()
    got = mel.log_mel_spectrogram(torch.from_numpy(wav))
    want = np.asarray(jax_mel.log_mel_spectrogram(jnp.asarray(wav)))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (3, 18, 80)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # bf16 input: the frontend still computes in fp32, as in JAX
    got16 = mel.log_mel_spectrogram(torch.from_numpy(wav).to(torch.bfloat16))
    want16 = np.asarray(jax_mel.log_mel_spectrogram(jnp.asarray(wav).astype(jnp.bfloat16)))
    assert got16.dtype == torch.float32
    np.testing.assert_allclose(got16.numpy(), want16, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="too short"):
        mel.log_mel_spectrogram(torch.zeros(1, 399))


# ------------------------------------------------------------ lstm ----


def test_lstm_stack_matches_jax_and_torch():
    """One torch.nn.LSTM's weights through both packages' importers: every
    layer's output of the port against JAX's, the last against torch's."""
    torch.manual_seed(0)
    b, t, d, h, n = 2, 17, 12, 8, 3
    ref = torch.nn.LSTM(d, h, num_layers=n, batch_first=True)
    x = torch.randn(b, t, d)
    with torch.no_grad():
        want_last, _ = ref(x)
    sd = {k: v.numpy() for k, v in ref.state_dict().items()}
    stack = LSTMStack(d, h, n)
    stack.load_state_dict(import_torch_lstm_state(sd, n))
    with torch.no_grad():
        got = stack(x)
    jouts = JLSTMStack(features=h, n_layers=n).apply(
        {"params": jax_import_torch_lstm_state(sd, n)}, jnp.asarray(x.numpy()))
    assert len(got) == len(jouts) == n
    for a, w in zip(got, jouts):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[-1].numpy(), want_last.numpy(), rtol=0, atol=1e-5)
    # bf16 inputs: the recurrence stays fp32 (JAX nn/lstm.py:48-70)
    with torch.no_grad():
        got16 = stack(x.to(torch.bfloat16))
    assert got16[-1].dtype == torch.float32
    # dropout between layers only, and only with a generator
    drop = LSTMStack(d, h, n, dropout=0.5)
    drop.load_state_dict(stack.state_dict())
    with torch.no_grad():
        same = drop(x)
        dropped = drop(x, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, c) for a, c in zip(same, got))
    assert torch.equal(dropped[0], got[0]) and not torch.equal(dropped[1], got[1])


# ------------------------------------------------------- the tower ----


@pytest.mark.parametrize("arch", ["lstm", "transformer"])
def test_mel_upstream_matches_jax(arch):
    wav, pad = _wav()
    jmodel = JMelUpstream(JMelUpstreamConfig(arch=arch, **TINY))
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(wav), jnp.asarray(pad)))
    want = jmodel.apply(variables, jnp.asarray(wav), jnp.asarray(pad))
    model = MelUpstream(MelUpstreamConfig(arch=arch, **TINY)).eval()
    load_mel_upstream(model, variables["params"])
    if arch == "transformer":  # the frozen towers' route: K1 with the out-projection
        assert all(layer.self_attn.fuse_out for layer in model.layers)
    n = model.cfg.num_hidden_states
    assert n == (2 if arch == "lstm" else 3)
    weights = torch.softmax(torch.linspace(-1.0, 1.0, n), dim=0)
    with torch.no_grad():
        got = model(torch.from_numpy(wav), torch.from_numpy(pad), weights,
                    return_hidden_states=True)
    assert tuple(got["hidden_states"].shape) == (n, 3, 18, 16)
    for key in ("hidden_states", "x"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=1e-5,
                                   err_msg=key)
    np.testing.assert_array_equal(got["padding_mask"].numpy(), np.asarray(want["padding_mask"]))
    assert got["padding_mask"][2, -1] and not got["padding_mask"][0].any()
    stacked = (weights.numpy()[:, None, None, None] * np.asarray(want["hidden_states"])).sum(0)
    np.testing.assert_allclose(got["weighted_sum"].numpy(), stacked, rtol=0, atol=1e-5)
    with torch.no_grad():  # the accumulated sum alone, no stack
        alone = model(torch.from_numpy(wav), torch.from_numpy(pad), weights)
    assert "hidden_states" not in alone
    np.testing.assert_allclose(alone["weighted_sum"].numpy(), stacked, rtol=0, atol=1e-5)

    # the bridge is strict: a JAX leaf the port does not read fails
    extra = jax.tree_util.tree_map(np.copy, variables["params"])
    extra["stray"] = {"kernel": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="stray"):
        load_mel_upstream(MelUpstream(MelUpstreamConfig(arch=arch, **TINY)), extra)


@pytest.mark.parametrize("name,kind,arch,layers,d", [
    ("apc", "apc", "lstm", 3, 512),
    ("apc_360hr", "apc", "lstm", 3, 512),
    ("vq_apc", "vq_apc", "lstm", 3, 512),
    ("tera", "tera", "transformer", 3, 768),
    ("mockingjay", "mockingjay", "transformer", 12, 768),
    ("decoar2", "decoar2", "transformer", 12, 768),
    ("pase_plus", None, None, None, None),
])
def test_from_upstream_name(name, kind, arch, layers, d):
    if kind is None:
        for cls in (MelUpstreamConfig, JMelUpstreamConfig):
            with pytest.raises(NotImplementedError, match="pase_plus"):
                cls.from_upstream_name(name)
        return
    c, j = MelUpstreamConfig.from_upstream_name(name), JMelUpstreamConfig.from_upstream_name(name)
    assert (c.kind, c.arch, c.n_layers, c.d_model) == (kind, arch, layers, d)
    for field in ("kind", "arch", "d_model", "n_layers", "n_heads", "ffn_dim", "n_mels", "win",
                  "hop", "n_fft", "dropout", "downsample_rate", "num_hidden_states"):
        assert getattr(c, field) == getattr(j, field), field
    assert c.downsample_rate == 160


# ------------------------------------------- the builder and the refusals ----


def _tiny_mel(name):
    cfg = load_config(os.path.join(REPO, "config", "dev", "tiny.yaml"))
    cfg.audio_encoder.tiny = False
    cfg.audio_encoder.name = name
    return cfg


def test_builder_warns_that_a_mel_ckpt_path_is_not_read(caplog, monkeypatch):
    """JAX's warning (`tasks/builder.py:139-150`): a mel tower stays at its
    seeded init when `audio_encoder.ckpt_path` is set. The tower is cut to
    tiny width so that the build stays small."""
    cut = KWClipConfig.from_config

    def tiny_tower(cfg, **kw):
        mc = cut(cfg, **kw)
        return dataclasses.replace(mc, audio=dataclasses.replace(mc.audio, **TINY))

    monkeypatch.setattr(KWClipConfig, "from_config", staticmethod(tiny_tower))
    cfg = _tiny_mel("apc")
    cfg.audio_encoder.ckpt_path = "/nonexistent/apc.ckpt"
    with caplog.at_level(logging.WARNING, logger="speechclip_plus_tpu_torch.tasks.builder"):
        model, mc, _ = build_model_from_config(cfg, device="cpu")
    assert "stays randomly initialized" in caplog.text and "apc" in caplog.text
    assert isinstance(model.audio_encoder, MelUpstream)
    # torch's LSTM init, U(-1/sqrt(H), 1/sqrt(H)), for every LSTM tensor
    lstm = dict(model.audio_encoder.lstm.named_parameters())
    assert len(lstm) == 8 and all(0 < p.abs().max() <= 16 ** -0.5 for p in lstm.values())
    caplog.clear()
    cfg.audio_encoder.ckpt_path = None
    with caplog.at_level(logging.WARNING, logger="speechclip_plus_tpu_torch.tasks.builder"):
        build_model_from_config(cfg, device="cpu")
    assert "stays randomly initialized" not in caplog.text


@pytest.mark.parametrize("key,value", [
    ("fused_attention", True), ("fused_attention_block", False), ("reinit_layers", [1]),
    ("unfreeze_layers", [0]),
])
def test_hubert_tower_keys_raise_by_name_for_a_mel_upstream(key, value):
    cfg = _tiny_mel("tera")
    setattr(cfg.audio_encoder, key, value)
    with pytest.raises(NotImplementedError, match=f"audio_encoder.{key}"):
        KWClipConfig.from_config(cfg)
    cfg = _tiny_mel("tera")
    mc = KWClipConfig.from_config(cfg)
    assert mc.audio.dropout == 0.1 and mc.audio.dtype == torch.float32
    cfg.audio_encoder.frozen_dropout = False
    cfg.trainer.precision = "bf16"
    mc = KWClipConfig.from_config(cfg)
    assert mc.audio.dropout == 0.0 and mc.audio.dtype == torch.bfloat16
