"""The port's Lightning importer against the JAX package's (fp32, CPU).

For each of the five branch types, `config/dev/tiny.yaml` with the branch set
(parallel; cascaded with one BatchNorm per keyword; cascaded+; hybrid with
the keyword BN fused over D*K channels; hybrid+, the YAML's own) and a
reference-format state dict with seeded values under the exact fairseq /
OpenAI CLIP / avssl names (`synthetic_lightning_sd` of
`tests/test_checkpoint_import.py` for the towers and hybrid+, the other
branches in the same style; weights scaled to the fan-in scale of trained
weights, `fan_in_scale`). It goes through (a) the port's
`lightning_to_kwclip` and (b) JAX's `lightning_to_kwclip` followed by
`from_jax.load_jax_variables`: the two port state dicts must be equal
tensor for tensor, and `encode_speech` must agree with JAX's at 1e-5 abs.
A `.ckpt` written with `torch.save` and a config pickled under a class named
`OrderedNamespace` loads through both packages' `load_lightning_checkpoint`
to the same arrays and config; the fill is strict both ways.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechclip_plus_tpu.checkpoint.lightning_import import (
    lightning_to_kwclip as jax_lightning_to_kwclip,
    load_lightning_checkpoint as jax_load_lightning_checkpoint,
)
from speechclip_plus_tpu.config import load_config as jax_load_config
from speechclip_plus_tpu.models.kwclip import KWClip as JKWClip
from speechclip_plus_tpu.models.kwclip import KWClipConfig as JKWClipConfig
from speechclip_plus_tpu.tasks.builder import resolve_reduced_vocab as jax_vocab

from speechclip_plus_tpu_torch.checkpoint import lightning_to_kwclip, load_lightning_checkpoint
from speechclip_plus_tpu_torch.checkpoint.from_jax import load_jax_variables
from speechclip_plus_tpu_torch.config import load_config
from speechclip_plus_tpu_torch.models.kwclip import KWClip, KWClipConfig
from speechclip_plus_tpu_torch.tasks.builder import resolve_reduced_vocab

from test_checkpoint_import import _bn, _ln, _lin, _mha_packed, synthetic_lightning_sd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "config", "dev", "tiny.yaml")
D = 32

# family -> edits of tiny.yaml (dotted key -> value)
FAMILIES = {
    "parallel": {"model_settings.cascaded_objective_weight": 0.0},
    "cascaded": {"model_settings.parallel_objective_weight": 0.0,
                 "model_settings.cascaded_branch.type": "KW_CascadedBranch",
                 "model_settings.cascaded_branch.keyword.batchnorms.parallel": False},
    "cascaded_plus": {"model_settings.parallel_objective_weight": 0.0,
                      "model_settings.cascaded_branch.type": "KW_CascadedBranch_dynamic"},
    "hybrid": {"model_settings.cascaded_branch.type": "KW_HybridBranch"},
    "hybrid_plus": {},
}


def _set(cfg, dotted, value):
    node = cfg
    *parents, leaf = dotted.split(".")
    for key in parents:
        node = getattr(node, key)
    setattr(node, leaf, value)


def family_config(load, family):
    """tiny.yaml with the family's edits, loaded by either package."""
    cfg = load(TINY)
    for key, value in FAMILIES[family].items():
        _set(cfg, key, value)
    return cfg


def model_configs(family):
    """(JAX KWClipConfig, port KWClipConfig) of the family."""
    out = []
    for load, vocab_of, cfg_cls in ((jax_load_config, jax_vocab, JKWClipConfig),
                                    (load_config, resolve_reduced_vocab, KWClipConfig)):
        cfg = family_config(load, family)
        vocab = vocab_of(cfg)
        out.append(cfg_cls.from_config(cfg, vocab_size=len(vocab), sot_id=int(vocab.sot_reduced),
                                       eot_id=int(vocab.eot_reduced)))
    return out


def fan_in_scale(sd):
    """Every projection and convolution weight scaled by 1/sqrt(fan-in), the
    scale of trained weights: with the unit-variance values of `_lin` the
    features reach magnitudes near 20, where fp32 rounding alone exceeds the
    1e-5 tolerance. Embeddings, norms and biases keep their values."""
    for key, v in sd.items():
        if key.endswith(("visual.proj", "text_projection")):
            sd[key] = v * np.float32(v.shape[0] ** -0.5)
        elif key.endswith("weight") and v.ndim >= 2 and "embedding" not in key:
            sd[key] = v * np.float32(np.prod(v.shape[1:]) ** -0.5)
    return sd


def _transformer_encoder(sd, prefix, n_layers, ffn=64):
    for i in range(n_layers):
        lp = f"{prefix}model.layers.{i}"
        _mha_packed(sd, f"{lp}.self_attn", D)
        _lin(sd, f"{lp}.linear1", ffn, D)
        _lin(sd, f"{lp}.linear2", D, ffn)
        _ln(sd, f"{lp}.norm1", D)
        _ln(sd, f"{lp}.norm2", D)
    _ln(sd, f"{prefix}model.norm", D)


def reference_sd(jcfg, family):
    """A reference-format Lightning state dict for the family: the towers of
    `synthetic_lightning_sd`, then the family's branch in the same style, at
    the fan-in scale."""
    sd = synthetic_lightning_sd(jcfg)
    if family == "hybrid_plus":
        return fan_in_scale(sd)
    sd = {k: v for k, v in sd.items() if not k.startswith("cascaded_branch.")}
    np.random.seed(1)
    text = jcfg.clip.text_width
    if family == "parallel":
        bp = "parallel_branch."
        sd[f"{bp}cls"] = np.random.randn(1, 1, D).astype(np.float32)
        _transformer_encoder(sd, f"{bp}self_att.", jcfg.parallel_ta.n_layers)
        _lin(sd, f"{bp}linear_proj", text, D)
        return fan_in_scale(sd)
    bp = "cascaded_branch."
    k = jcfg.head.keyword_num
    _mha_packed(sd, f"{bp}self_att.multihead_attn_layer", D)
    _ln(sd, f"{bp}self_att.attentionBlock_Norm", D)
    _lin(sd, f"{bp}linear_proj", jcfg.head.text_dim, D)
    sd[f"{bp}vector_quantizer.curr_temp"] = np.asarray([0.1], np.float32)
    if family == "cascaded":
        sd[f"{bp}cls"] = np.random.randn(1, k, D).astype(np.float32)
        for i in range(k):  # one BatchNorm per keyword
            _bn(sd, f"{bp}bn_layer.bn_layers.{i}", jcfg.head.text_dim)
    elif family == "cascaded_plus":
        sd[f"{bp}downsampling.conv.0.weight"] = np.random.randn(D, D, 3).astype(np.float32)
        sd[f"{bp}downsampling.conv.0.bias"] = np.random.randn(D).astype(np.float32)
        _lin(sd, f"{bp}downsampling.weight_proj.1", 1, D)
        _bn(sd, f"{bp}bn_layer.bn_layer", jcfg.head.text_dim)
    elif family == "hybrid":
        sd[f"{bp}parallel_cls"] = np.random.randn(1, 1, D).astype(np.float32)
        sd[f"{bp}cascaded_cls"] = np.random.randn(1, k, D).astype(np.float32)
        _bn(sd, f"{bp}bn_layer.bn_layer", jcfg.head.text_dim * k)  # fused: d*K + k
        _lin(sd, f"{bp}parallel_proj", text, D)
    return fan_in_scale(sd)


def wav_batch():
    rng = np.random.RandomState(5)
    lens = np.array([1600, 1200, 1450, 900], np.int64)
    wav = (0.3 * rng.randn(4, 1600)).astype(np.float32)
    wav[np.arange(1600)[None, :] >= lens[:, None]] = 0.0
    return wav, lens


def jax_encode_speech(jcfg, variables, wav, lens):
    return JKWClip(jcfg).apply(variables, jnp.asarray(wav), jnp.asarray(lens),
                               method=JKWClip.encode_speech)


def assert_same_speech(got, want, tol=1e-5):
    """Port `encode_speech` against JAX's: features at `tol`, VQ targets and
    CIF lengths equal."""
    for key in ("parallel_audio_feat", "cascaded_audio_feat", "keywords"):
        assert (got[key] is None) == (want[key] is None), key
        if got[key] is not None:
            np.testing.assert_allclose(got[key].cpu().numpy(), np.asarray(want[key]), rtol=0,
                                       atol=tol, err_msg=key)
    if got["vq_results"] is not None:
        np.testing.assert_array_equal(got["vq_results"]["targets"].cpu().numpy(),
                                      np.asarray(want["vq_results"]["targets"]))
    if got["dsample_results"] is not None:
        np.testing.assert_array_equal(
            got["dsample_results"]["dsample_feats_length"].cpu().numpy(),
            np.asarray(want["dsample_results"]["dsample_feats_length"]))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_lightning_import_matches_jax(family):
    jcfg, cfg = model_configs(family)
    sd = reference_sd(jcfg, family)

    port = KWClip(cfg).eval()
    lightning_to_kwclip(sd, port)
    params, batch_stats = jax_lightning_to_kwclip(sd, jcfg)
    variables = jax.tree_util.tree_map(np.asarray, {"params": params,
                                                    "batch_stats": batch_stats})
    bridged = KWClip(cfg).eval()
    load_jax_variables(bridged, variables)  # strict both ways
    a, b = port.state_dict(), bridged.state_dict()
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), name
    if hasattr(port.cascaded_branch, "head"):  # the running statistics came through
        bn = port.cascaded_branch.head.bn_layer
        assert not torch.equal(bn.running_var, torch.ones_like(bn.running_var))

    wav, lens = wav_batch()
    want = jax_encode_speech(jcfg, variables, wav, lens)
    with torch.inference_mode():
        got = port.encode_speech(torch.from_numpy(wav), torch.from_numpy(lens))
    assert_same_speech(got, want)


class OrderedNamespace:
    """Stands in for avssl's config class: pickled by its (qualified) name,
    which neither package can import; both unpickle it through a shim."""

    def __init__(self, d):
        for key, value in d.items():
            setattr(self, key, OrderedNamespace(value) if isinstance(value, dict) else value)


def write_lightning_ckpt(path, sd, config: dict, **extra):
    """A `.ckpt` as Lightning writes one: the state dict, the config pickled
    as `OrderedNamespace` under `hyper_parameters`, and the loop state."""
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                "hyper_parameters": {"config": OrderedNamespace(config)},
                "epoch": 3, "global_step": 1234, **extra}, path)


def test_ckpt_file_loads_like_jax(tmp_path):
    jcfg, _ = model_configs("hybrid_plus")
    sd = reference_sd(jcfg, "hybrid_plus")
    path = str(tmp_path / "x.ckpt")
    write_lightning_ckpt(path, sd, load_config(TINY).to_dict())
    got_sd, got_cfg, meta = load_lightning_checkpoint(path)
    want_sd, want_cfg, want_meta = jax_load_lightning_checkpoint(path)
    assert got_sd.keys() == want_sd.keys() == sd.keys()
    for key in sd:
        np.testing.assert_array_equal(got_sd[key], want_sd[key], err_msg=key)
        np.testing.assert_array_equal(got_sd[key], sd[key], err_msg=key)
    assert got_cfg.to_dict() == want_cfg.to_dict() == load_config(TINY).to_dict()
    assert meta == want_meta == {"epoch": 3, "global_step": 1234}


def test_import_is_strict_both_ways():
    jcfg, cfg = model_configs("hybrid_plus")
    sd = reference_sd(jcfg, "hybrid_plus")
    missing = dict(sd)
    missing.pop("cascaded_branch.bn_layer.bn_layer.running_mean")
    with pytest.raises(KeyError, match="running_mean"):
        lightning_to_kwclip(missing, KWClip(cfg))
    # a port tensor the mapping does not fill: a model with a projection net
    # the checkpoint does not have
    cfg_proj = load_config(TINY)
    cfg_proj.model_settings.image_encoder_projection = {"dimensions": [D, D], "dropout": 0.1}
    vocab = resolve_reduced_vocab(cfg_proj)
    mc = KWClipConfig.from_config(cfg_proj, vocab_size=len(vocab),
                                  sot_id=int(vocab.sot_reduced), eot_id=int(vocab.eot_reduced))
    with pytest.raises(KeyError, match="img_enc_proj_net"):
        lightning_to_kwclip(sd, KWClip(mc))
    from speechclip_plus_tpu_torch.checkpoint import load_port_state_dict

    model = KWClip(cfg)
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    state.pop("weightedsum")
    with pytest.raises(ValueError, match="weightedsum"):
        load_port_state_dict(model, state)
    state["weightedsum"], state["not_a_tensor"] = np.zeros(3, np.float32), np.zeros(1)
    with pytest.raises(ValueError, match="not_a_tensor"):
        load_port_state_dict(model, state)
