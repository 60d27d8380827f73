"""The PyTorch port's WavLM tower and K1's bias and gate modes against JAX.

fp32 on the CPU, inputs from numpy seeds, weights through
`checkpoint/from_jax.py`; the port's kernels run their plain twins here.

  - `relative_position_buckets` equals the JAX function exactly (a float32 log
    ratio is truncated to the bucket index, so a last-bit difference would
    move a bucket edge), for T up to 1500;
  - `rel_pos_gate` against the formula on the JAX parameters, and one WavLM
    layer against the JAX layer, through both of the port's WavLM routes;
  - K1's twin with `attn_bias` alone and with `attn_gate` against the JAX
    function's XLA route (fp32 bias; 2e-5 abs: fp32 on both sides, sums in
    another order) and against its Pallas kernel in interpret mode. The
    gated Pallas kernel keeps the bias in bf16: with bias values that bf16
    represents exactly it must agree to the same 2e-5; with arbitrary fp32
    values the tolerance is 2e-2 abs, which covers the bias's bf16 rounding
    (|bias| < 4 rounds by up to 2^-7 = 7.8e-3 in the score, times a gate
    below 2, on outputs of order 1);
  - the tiny WavLM tower (`HubertConfig.tiny(rel_pos_bias=True,
    rel_buckets=8, rel_max_distance=20)`, a ragged batch): weighted sum and
    last hidden state to 1e-5;
  - the whole slice: hybrid+ from `config/dev/tiny.yaml` with that tower,
    `encode_speech` for both feature sources (1e-5 abs, the tolerance of
    `test_torch_slice.py`) and a 3-step training run (1e-5 abs + 1e-4 rel,
    the tolerance of `test_torch_train_step.py`);
  - dropout on: the gated twin's keep rate and preserved mean.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechclip_plus_tpu.api import SpeechCLIP as JSpeechCLIP
from speechclip_plus_tpu.config import load_config as jax_load_config
from speechclip_plus_tpu.models.hubert import HubertConfig as JHubertConfig
from speechclip_plus_tpu.models.hubert import HubertEncoderLayer as JLayer
from speechclip_plus_tpu.models.hubert import HubertModel as JHubert
from speechclip_plus_tpu.models.hubert import relative_position_buckets as jax_buckets
from speechclip_plus_tpu.models.kwclip import KWClip as JKWClip
from speechclip_plus_tpu.models.kwclip import KWClipConfig as JKWClipConfig
from speechclip_plus_tpu.models.kwclip import init_kw_bn_from_token_embedding as jax_kw_bn_init
from speechclip_plus_tpu.nn.fused_attention_block import fused_attention_block as jax_fab
from speechclip_plus_tpu.tasks.builder import resolve_reduced_vocab as jax_vocab

from speechclip_plus_tpu_torch.api import SpeechCLIP
from speechclip_plus_tpu_torch.checkpoint.from_jax import load_hubert, load_jax_variables
from speechclip_plus_tpu_torch.config import load_config
from speechclip_plus_tpu_torch.models.hubert import (
    HubertConfig, HubertModel, relative_position_buckets)
from speechclip_plus_tpu_torch.models.kwclip import KWClip, KWClipConfig
from speechclip_plus_tpu_torch.nn import fused_attention_block as fab
from speechclip_plus_tpu_torch.ops.random import attention_keep_mask
from speechclip_plus_tpu_torch.optim.optimizer import (
    build_optimizer_from_config, trainable_parameters)
from speechclip_plus_tpu_torch.parallel.train_step import create_train_state, make_train_step
from speechclip_plus_tpu_torch.tasks.builder import (
    init_params, resolve_reduced_vocab)

from test_torch_fused_attention_block import _case, _port_args
from test_torch_slice import TINY, _wavs, short_buckets  # noqa: F401 (autouse fixture)
from test_torch_train_step import STEPS, _as_port, _batch, _jax_steps

ATOL = 2e-5
TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
WAVLM = dict(rel_pos_bias=True, rel_buckets=8, rel_max_distance=20)


@pytest.mark.parametrize("t,buckets,max_distance", [
    (1500, 320, 800), (1499, 320, 800), (320, 320, 800), (50, 8, 20), (333, 32, 128)])
def test_bucket_matrix_equals_jax_exactly(t, buckets, max_distance):
    want = np.asarray(jax_buckets(t, buckets, max_distance))
    got = relative_position_buckets(t, buckets, max_distance).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < buckets


# ------------------------------------------------------------ the tower ----

@pytest.fixture(scope="module")
def tower_pair():
    jm = JHubert(JHubertConfig.tiny(**WAVLM))
    wav = jnp.zeros((2, 400), jnp.float32)
    params = jax.jit(lambda k: jm.init(k, wav, wav == 1.0))(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.array, params)["params"]
    # flax initializes the gate's constant to ones and the table at std 0.02:
    # other values make the gated bias matter
    rng = np.random.RandomState(3)
    layers = params["layers"]["layer"]
    layers["gru_rel_pos_const"] = (1.0 + rng.rand(*layers["gru_rel_pos_const"].shape)
                                   ).astype(np.float32)
    layers["gru_rel_pos_linear"]["bias"] = rng.randn(
        *layers["gru_rel_pos_linear"]["bias"].shape).astype(np.float32)
    params["rel_attn_embed"] = rng.randn(*params["rel_attn_embed"].shape).astype(np.float32)
    towers = {}
    for fused in (True, False):
        tm = HubertModel(HubertConfig.tiny(fused_attention_block=fused, **WAVLM)).eval()
        load_hubert(tm, params)
        towers[fused] = tm
    return jm, params, towers


def _layer_inputs(seed=4, b=3, t=29, d=32):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, d).astype(np.float32)
    lens = np.array([t, 17, 5])
    kb = np.where(np.arange(t)[None, :] >= lens[:, None], -1e30, 0.0).astype(np.float32)
    return x, kb


def test_rel_pos_gate_matches_formula(tower_pair):
    _, params, towers = tower_pair
    x, _ = _layer_inputs()
    layer = jax.tree_util.tree_map(lambda a: a[1], params["layers"]["layer"])
    b, t, d = x.shape
    h = 4
    gh = x.reshape(b, t, h, d // h).transpose(0, 2, 1, 3)
    proj = gh @ layer["gru_rel_pos_linear"]["kernel"] + layer["gru_rel_pos_linear"]["bias"]
    proj = proj.reshape(b, h, t, 2, 4).sum(-1)
    sig = 1.0 / (1.0 + np.exp(-proj))
    want = (sig[..., :1] * (sig[..., 1:] * layer["gru_rel_pos_const"] - 1.0) + 2.0)[..., 0]
    with torch.no_grad():
        got = towers[True].layers[1].rel_pos_gate(torch.from_numpy(x))
    assert got.shape == (b, h, t) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fused", [True, False])
def test_wavlm_layer_matches_jax(tower_pair, fused):
    jm, params, towers = tower_pair
    x, kb = _layer_inputs()
    t = x.shape[1]
    tm = towers[fused]
    with torch.no_grad():
        pb = tm.position_bias(t)
        got = tm.layers[0](torch.from_numpy(x), torch.from_numpy(kb), None, pb)
    buckets = np.asarray(jax_buckets(t, 8, 20))
    want_pb = params["rel_attn_embed"][buckets.reshape(-1)].reshape(t, t, 4).transpose(2, 0, 1)
    np.testing.assert_array_equal(pb.numpy(), want_pb)
    layer = jax.tree_util.tree_map(lambda a: a[0], params["layers"]["layer"])
    want = JLayer(jm.cfg).apply({"params": layer}, jnp.asarray(x),
                                jnp.asarray(kb)[:, None, None, :],
                                position_bias=jnp.asarray(want_pb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("lens,t", [([800, 515, 300], 800), ([640, 640], 640)])
def test_wavlm_tower_matches_jax(tower_pair, lens, t, fused):
    jm, params, towers = tower_pair
    rng = np.random.RandomState(0)
    wav = (0.5 * rng.randn(len(lens), t)).astype(np.float32)
    pad = np.arange(t)[None, :] >= np.asarray(lens)[:, None]
    wav[pad] = 0.0
    logits = np.random.RandomState(1).randn(3).astype(np.float32)
    want = jm.apply({"params": params}, jnp.asarray(wav), jnp.asarray(pad),
                    layer_weights=jax.nn.softmax(jnp.asarray(logits)))
    with torch.no_grad():
        got = towers[fused](torch.from_numpy(wav), torch.from_numpy(pad),
                            torch.softmax(torch.from_numpy(logits), 0))
    np.testing.assert_array_equal(got["padding_mask"].numpy(), np.asarray(want["padding_mask"]))
    for key in ("weighted_sum", "x"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL, err_msg=key)


def test_wavlm_bridge_is_strict(tower_pair):
    _, params, _ = tower_pair
    missing = copy.deepcopy(params)
    del missing["rel_attn_embed"]
    with pytest.raises(KeyError):
        load_hubert(HubertModel(HubertConfig.tiny(**WAVLM)), missing)
    # a HuBERT tower must not swallow WavLM leaves
    with pytest.raises(ValueError, match="rel_attn_embed|gru_rel_pos"):
        load_hubert(HubertModel(HubertConfig.tiny()), params)


def test_upstream_names():
    assert HubertConfig.from_upstream_name("wavlm_base_plus") == HubertConfig.wavlm_base()
    assert HubertConfig.from_upstream_name("wavlm_base").rel_pos_bias
    assert not HubertConfig.from_upstream_name("hubert_base").rel_pos_bias
    jcfg = JHubertConfig.from_upstream_name("wavlm_base_plus")
    cfg = HubertConfig.wavlm_base()
    assert (cfg.rel_buckets, cfg.rel_max_distance, cfg.n_heads, cfg.d_model) == (
        jcfg.rel_buckets, jcfg.rel_max_distance, jcfg.n_heads, jcfg.d_model) == (320, 800, 12, 768)
    for name in ("wavlm_large", "data2vec_large", "hubert_large_ll60k"):  # the large family
        got, want = HubertConfig.from_upstream_name(name), JHubertConfig.from_upstream_name(name)
        assert (got.d_model, got.n_layers, got.rel_pos_bias, got.layer_norm_first) == (
            want.d_model, want.n_layers, want.rel_pos_bias, want.layer_norm_first)
    assert HubertConfig.from_upstream_name("wavlm_large") == HubertConfig.wavlm_large()
    # WavLM Large as resolved: HuBERT-Large's block (its conv bias kept, as JAX keeps
    # it) with the gated bias at 320 buckets up to distance 800
    large, jlarge = HubertConfig.wavlm_large(), JHubertConfig.wavlm_large()
    fields = ("extractor_mode", "conv_bias", "d_model", "n_layers", "n_heads", "ffn_dim",
              "layer_norm_first", "conv_pos", "conv_pos_groups", "rel_pos_bias", "rel_buckets",
              "rel_max_distance")
    assert [getattr(large, f) for f in fields] == [getattr(jlarge, f) for f in fields] == [
        "layer_norm", True, 1024, 24, 16, 4096, True, 128, 16, True, 320, 800]


# ------------------------------------------- K1's twin: bias and gate ----

def _bias_gate(seed, b, t, heads, ab_shape, bf16_exact=False):
    rng = np.random.RandomState(seed)
    ab = rng.randn(*{"tt": (t, t), "1tt": (1, t, t), "htt": (heads, t, t)}[ab_shape])
    ab = ab.astype(np.float32)
    if bf16_exact:
        ab = torch.from_numpy(ab).bfloat16().float().numpy()
    gate = (1.0 + rng.rand(b, heads, t)).astype(np.float32)
    return ab, gate


def _jax_block(x, w, bias, kb, heads, interpret, ab, gate):
    args = [jnp.asarray(a) for n in "qkvo" for a in (w[n], bias[n])]
    out = jax_fab(jnp.asarray(x), *args, jnp.asarray(kb), n_heads=heads, dtype=jnp.float32,
                  interpret=interpret, attn_bias=jnp.asarray(ab),
                  attn_gate=None if gate is None else jnp.asarray(gate))
    return np.asarray(out)


@pytest.mark.parametrize("interpret", [False, True])
@pytest.mark.parametrize("ab_shape,t,d,heads", [
    ("htt", 37, 48, 4), ("tt", 19, 72, 3), ("1tt", 48, 64, 4)])
def test_attn_bias_matches_jax(ab_shape, t, d, heads, interpret):
    x, w, bias, kb = _case(10, 3, t, d)
    ab, _ = _bias_gate(11, 3, t, heads, ab_shape)
    want = _jax_block(x, w, bias, kb, heads, interpret, ab, None)
    got = fab.fused_attention_block(*_port_args(x, w, bias, kb), n_heads=heads,
                                    attn_bias=torch.from_numpy(ab))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("route,atol", [("xla", ATOL), ("interpret_bf16_exact", ATOL),
                                        ("interpret", 2e-2)])
@pytest.mark.parametrize("t,d,heads", [(37, 48, 4), (48, 64, 4)])
def test_attn_gate_matches_jax(t, d, heads, route, atol):
    x, w, bias, kb = _case(12, 3, t, d)
    ab, gate = _bias_gate(13, 3, t, heads, "htt", bf16_exact=route.endswith("exact"))
    want = _jax_block(x, w, bias, kb, heads, route != "xla", ab, gate)
    got = fab.fused_attention_block(*_port_args(x, w, bias, kb), n_heads=heads,
                                    attn_bias=torch.from_numpy(ab),
                                    attn_gate=torch.from_numpy(gate))
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


def test_bias_modes_keep_masked_rows_finite_and_compose_with_lse():
    x, w, bias, kb = _case(14, 2, 21, 48)
    kb[1, :] = -1e30  # a fully padded row
    ab, gate = _bias_gate(15, 2, 21, 4, "htt")
    xt, w_in, b_in, w_out, b_out, kbt = _port_args(x, w, bias, kb)
    out = fab.fused_attention_block(xt, w_in, b_in, w_out, b_out, kbt, n_heads=4,
                                    attn_bias=torch.from_numpy(ab),
                                    attn_gate=torch.from_numpy(gate))
    assert bool(torch.isfinite(out).all())
    ctx, qkv, lse = fab._run(xt, w_in, b_in, None, None, kbt, 4, False, return_aux=True,
                             attn_bias=torch.from_numpy(ab), attn_gate=torch.from_numpy(gate))
    assert lse.shape == (2, 4, 21) and bool(torch.isfinite(lse).all())
    ref = torch.nn.functional.linear(ctx, w_out, b_out)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6, rtol=0)


def test_gated_dropout_statistics():
    """Dropout on the gated weights: the keep rate is 0.9 within 4 sigma, the
    mask is the counter mask, and the mean of the output is preserved."""
    b, t, d, heads = 4, 64, 48, 4
    x, w, bias, kb = _case(16, b, t, d, padded=False)
    ab, gate = _bias_gate(17, b, t, heads, "htt")
    args = _port_args(x, w, bias, kb)
    kw = dict(attn_bias=torch.from_numpy(ab), attn_gate=torch.from_numpy(gate))
    base = fab.plain_fused_attention_block(*args, heads, False, **kw)
    outs = []
    for seed in range(24):
        seeds = torch.tensor([1000 + seed, 77 * seed], dtype=torch.int64)
        outs.append(fab.plain_fused_attention_block(*args, heads, False, seeds=seeds,
                                                    keep_prob=0.9, **kw))
    keep = attention_keep_mask(torch.tensor([1000, 0], dtype=torch.int64), b, heads, t, 0.9)
    n = keep.numel()
    assert abs(keep.float().mean().item() - 0.9) <= 4 * (0.09 / n) ** 0.5
    assert not torch.equal(outs[0], base)
    stack = torch.stack(outs)
    # 24 independent masks: the mean's error against the undropped context is
    # of the size of its standard error (E|N(0, se)| = 0.8 se), so it is unbiased
    se = stack.std(0) / len(outs) ** 0.5
    assert (stack.mean(0) - base).abs().mean().item() < 1.2 * se.mean().item()
    g = torch.Generator().manual_seed(0)
    a = fab.fused_attention_block(*args, n_heads=heads, dropout_rate=0.1, generator=g, **kw)
    assert not torch.equal(a, fab.fused_attention_block(*args, n_heads=heads, **kw))


@pytest.mark.parametrize("kwargs,match", [
    (dict(attn_gate=torch.zeros(2, 4, 16)), "needs an attn_bias"),
    (dict(attn_bias=torch.zeros(2, 16, 16)), "attn_bias"),
    (dict(attn_bias=torch.zeros(16, 15)), "attn_bias"),
    (dict(attn_bias=torch.zeros(16, 16), attn_gate=torch.zeros(2, 3, 16)), "attn_gate"),
])
def test_bad_bias_and_gate_raise(kwargs, match):
    x, w, bias, kb = _case(5, 2, 16, 48)
    with pytest.raises(ValueError, match=match):
        fab.fused_attention_block(*_port_args(x, w, bias, kb), n_heads=4, **kwargs)


# ------------------------------------------------------ the whole slice ----

def hybrid_pair(audio_overrides, jax_audio_overrides=None):
    """hybrid+ from config/dev/tiny.yaml in both packages with the acoustic
    tower's config replaced, the JAX variables moved into the port.
    Returns (cfg, jax model, variables, port model)."""
    cfg = jax_load_config(TINY)
    vocab = jax_vocab(cfg)
    mcfg = JKWClipConfig.from_config(cfg, vocab_size=len(vocab), sot_id=int(vocab.sot_reduced),
                                     eot_id=int(vocab.eot_reduced))
    jover = audio_overrides if jax_audio_overrides is None else jax_audio_overrides
    mcfg = dataclasses.replace(mcfg, audio=dataclasses.replace(mcfg.audio, **jover))
    jmodel = JKWClip(mcfg)
    rng = np.random.RandomState(0)
    batch = {"wav": jnp.asarray(rng.randn(2, 3200).astype(np.float32)),
             "wav_len": jnp.asarray([3200, 2880]),
             "image": jnp.asarray(rng.randn(2, 32, 32, 3).astype(np.float32)),
             "id": jnp.asarray([0, 1])}
    variables = jax.jit(lambda k, b: jmodel.init({"params": k}, b, training=False))(
        jax.random.PRNGKey(0), batch)
    variables = jax.tree_util.tree_map(np.array, dict(variables))
    params = jax_kw_bn_init(
        variables["params"], variables["params"]["clip"]["text"]["token_embedding"]["embedding"],
        mcfg)
    # a low alpha bias keeps CIF below max_feat_len (as in test_torch_slice.py)
    params["cascaded_branch"]["downsampling"]["weight_proj"]["bias"] = np.full(1, -6.0, np.float32)
    if "rel_attn_embed" in params["audio_encoder"]:
        table = params["audio_encoder"]["rel_attn_embed"]
        params["audio_encoder"]["rel_attn_embed"] = np.random.RandomState(9).randn(
            *table.shape).astype(np.float32)
    variables["params"] = jax.tree_util.tree_map(np.asarray, params)

    pcfg = load_config(TINY)
    pvocab = resolve_reduced_vocab(pcfg)
    pm = KWClipConfig.from_config(pcfg, vocab_size=len(pvocab), sot_id=int(pvocab.sot_reduced),
                                  eot_id=int(pvocab.eot_reduced))
    pm = dataclasses.replace(pm, audio=dataclasses.replace(pm.audio, **audio_overrides))
    model = KWClip(pm)
    init_params(model, torch.Generator().manual_seed(0))
    load_jax_variables(model, variables)
    return cfg, jmodel, variables, model.eval()


@pytest.fixture(scope="module")
def slice_pair():
    return hybrid_pair(WAVLM)


def check_encode_speech(jmodel, variables, model):
    want = JSpeechCLIP(jmodel, variables).encode_speech(_wavs(False))
    got = SpeechCLIP(model, "cpu").encode_speech(_wavs(False))
    for key in ("parallel_audio_feat", "cascaded_audio_feat"):  # both feature sources
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=1e-5,
                                   err_msg=key)
    np.testing.assert_array_equal(got["vq_results"]["targets"].numpy(),
                                  np.asarray(want["vq_results"]["targets"]))
    np.testing.assert_array_equal(
        got["dsample_results"]["dsample_feats_length"].numpy(),
        np.asarray(want["dsample_results"]["dsample_feats_length"]))


def test_slice_encode_speech_matches_jax(slice_pair):
    _, jmodel, variables, model = slice_pair
    assert model.audio_encoder.cfg.rel_pos_bias and model.audio_encoder.cfg.fused_attention_block
    check_encode_speech(jmodel, variables, model)


def check_training_steps(cfg, jmodel, variables, template):
    """STEPS optimizer steps, dropout off: losses of the first step and every
    parameter after each step (the zero-gradient slices of
    `test_torch_train_step.py` left out)."""
    batch = _batch(True, jmodel, variables)
    (jlosses, _), jafter = _jax_steps(cfg, jmodel, variables, batch, STEPS)
    model = copy.deepcopy(template)
    optimizer = build_optimizer_from_config(model, load_config(TINY))
    state = create_train_state(optimizer)
    step_fn = make_train_step(model, optimizer, accumulate_grad_batches=1)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    d = template.cfg.cascaded_ta.d_model
    skip = {"cascaded_branch.self_att.multihead_attn_layer.in_proj_bias": slice(d, 2 * d),
            "cascaded_branch.head.linear_proj.bias": slice(None)}
    names = [n for n, _ in trainable_parameters(model)]
    for step in range(STEPS):
        metrics = step_fn(state, tbatch, None)
        if step == 0:
            for key in ("loss", "c_cl_loss", "p_cl_loss", "quantity_loss"):
                np.testing.assert_allclose(float(metrics[f"train_{key}"]), float(jlosses[key]),
                                           **STEP_TOL, err_msg=key)
        want = dict(_as_port(template, jafter[step]).named_parameters())
        got = dict(model.named_parameters())
        for n in names:
            a, b = got[n].detach().numpy(), want[n].detach().numpy()
            keep = np.ones(a.shape[0], bool) if a.ndim else True
            if n in skip:
                keep[skip[n]] = False
            np.testing.assert_allclose(a[keep], b[keep], **STEP_TOL, err_msg=f"step {step}: {n}")
    assert state.step == STEPS and len(names) > 10


def test_slice_training_steps_match_jax(slice_pair):
    check_training_steps(*slice_pair)
