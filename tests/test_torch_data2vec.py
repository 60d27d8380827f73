"""The data2vec-audio base tower in the port against the JAX package (fp32, CPU).

`HubertConfig.data2vec_base` keeps HuBERT's encoder and changes its two
convolution stacks: a LayerNorm over channels after every frontend conv (no
conv bias) and five stacked positional convs (k=19, 16 groups at base width),
each with a LayerNorm without affine and exact-erf GELU. Here at tiny width
(2 layers, D=32, the stacked pos_conv kept at depth 5 and k=19, 2 groups),
the JAX weights moved in through `checkpoint/from_jax.py`; tolerance 1e-5 abs.
`config/speechclip_plus/base/hybrid_plus_data2vec.yaml` goes through the
families harness of `test_torch_families.py` (`encode_speech` and 3 training
steps at width 32, that file's tolerances), and the dataset's per-utterance
normalization (`data.audio.waveform_layer_norm`, which the port's dataset
applies under `data.dataset.normalize_waveform`) is held against JAX's
`normalize_waveform`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechclip_plus_tpu.models.hubert import HubertConfig as JHubertConfig
from speechclip_plus_tpu.models.hubert import HubertModel as JHubert
from speechclip_plus_tpu.models.hubert import normalize_waveform as jax_normalize_waveform
from speechclip_plus_tpu_torch.checkpoint.from_jax import load_hubert
from speechclip_plus_tpu_torch.data.audio import waveform_layer_norm
from speechclip_plus_tpu_torch.models.hubert import HubertConfig, HubertModel

from test_torch_families import _configs, check_small_family

TINY_D2V = dict(extractor_mode="layer_norm", conv_pos=19, pos_conv_depth=5)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def d2v_pair():
    jm = JHubert(JHubertConfig.tiny(**TINY_D2V))
    wav = jnp.zeros((2, 400), jnp.float32)
    params = jax.jit(lambda k: jm.init(k, wav, wav == 1.0))(jax.random.PRNGKey(2))
    params = jax.tree_util.tree_map(np.asarray, params)["params"]
    tm = HubertModel(HubertConfig.tiny(**TINY_D2V)).eval()
    load_hubert(tm, params)  # strict both ways: every ln_i and pos_conv/conv_j read
    return jm, params, tm


@pytest.mark.parametrize("lens,t", [([800, 515, 300], 800), ([640, 640], 640)])
def test_data2vec_tower_matches_jax(d2v_pair, lens, t):
    jm, params, tm = d2v_pair
    rng = np.random.RandomState(0)
    wav = (0.5 * rng.randn(len(lens), t)).astype(np.float32)
    pad = np.arange(t)[None, :] >= np.asarray(lens)[:, None]
    wav[pad] = 0.0
    logits = rng.randn(3).astype(np.float32)
    w = jax.nn.softmax(jnp.asarray(logits))
    want = jm.apply({"params": params}, jnp.asarray(wav), jnp.asarray(pad), layer_weights=w)
    stack = jm.apply({"params": params}, jnp.asarray(wav), jnp.asarray(pad))["hidden_states"]
    with torch.no_grad():
        got = tm(torch.from_numpy(wav), torch.from_numpy(pad),
                 torch.softmax(torch.from_numpy(logits), 0), return_hidden_states=True)
    np.testing.assert_array_equal(got["padding_mask"].numpy(), np.asarray(want["padding_mask"]))
    for key in ("weighted_sum", "x"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL, err_msg=key)
    np.testing.assert_allclose(got["hidden_states"].numpy(), np.asarray(stack), **TOL)


def test_data2vec_layout():
    cfg = HubertConfig.from_upstream_name("data2vec")
    assert cfg == HubertConfig.data2vec_base()
    assert (cfg.extractor_mode, cfg.pos_conv_depth, cfg.conv_pos) == ("layer_norm", 5, 19)
    tm = HubertModel(HubertConfig.tiny(**TINY_D2V))
    names = set(tm.state_dict())
    assert "feature_extractor.layer_norms.1.weight" in names
    assert "pos_conv.layers.4.bias" in names
    assert not any(n.startswith(("feature_extractor.gn", "pos_conv.conv.")) for n in names)
    assert not any(n.startswith("feature_extractor.conv_layers") and n.endswith("bias")
                   for n in names)
    # data2vec-large: the same structure at large width (ported with the large family)
    large = HubertConfig.from_upstream_name("data2vec_large")
    assert large == HubertConfig.data2vec_large()
    assert (large.extractor_mode, large.pos_conv_depth, large.conv_bias, large.layer_norm_first,
            large.d_model, large.n_layers) == ("layer_norm", 5, False, False, 1024, 24)


def test_hybrid_plus_data2vec_yaml_matches_jax():
    jcfg, (jfull, jsmall), cfg, (full, small) = _configs(
        "config/speechclip_plus/base/hybrid_plus_data2vec.yaml", **TINY_D2V)
    for c in (full.audio, jfull.audio):
        assert (c.extractor_mode, c.pos_conv_depth, c.conv_pos, c.d_model) == (
            "layer_norm", 5, 19, 768)
    assert full.branch_type == jfull.branch_type == "HybridBranch_plus"
    assert small.audio.pos_conv_depth == jsmall.audio.pos_conv_depth == 5
    check_small_family(jcfg, jsmall, cfg, small, "hybrid_plus_data2vec")


def test_normalize_waveform_matches_jax():
    rng = np.random.RandomState(3)
    lens = np.array([1600, 1011, 1], np.int64)
    wav = (0.7 * rng.randn(3, 1600) + 0.2).astype(np.float32)
    wav[np.arange(1600)[None, :] >= lens[:, None]] = 0.0
    want = np.asarray(jax_normalize_waveform(jnp.asarray(wav), jnp.asarray(lens)))
    for row, n in enumerate(lens):
        got = waveform_layer_norm(wav[row, :n])
        np.testing.assert_allclose(got, want[row, :n], **TOL, err_msg=str(row))
    assert float(np.abs(want[1, 1011:]).max()) == 0.0
