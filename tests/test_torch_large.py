"""The large plus family in the port against the JAX package (fp32, CPU).

`config/speechclip_plus/large/{flickr,coco}/{hybrid_plus,cascaded_plus}.yaml`:
HuBERT-Large (the layer-norm frontend with conv bias, 24 pre-norm layers of
1024), ViT-L/14 with its 768-wide text tower, a 1024-wide branch with 8 heads
(K1 and K2 at dh=128) and a keyword head through `MLPLayers` [1024, 1024, 768]
onto the 768-wide codebook (K3 and K3b at D=768).

- All four YAMLs parse to the same typed config in both packages (no
  full-width init). The flickr hybrid+ and cascaded+ models, cut to width 32
  and depth 2 with the large structure kept (the tower's `extractor_mode`,
  `conv_bias` and `layer_norm_first`; three keyword-projection widths; the
  ViT's patch of 14), go through `encode_speech` and 3 training steps against
  JAX (`test_torch_families.check_small_family`, its tolerances: features
  1e-5 abs; losses and parameters after 3 steps 1e-5 abs + 1e-4 rel;
  first-step gradients the same plus 1e-4 of the largest entry).
- The towers `large`, `wavlm_large` and `data2vec_large`: the presets equal
  JAX's on the architecture fields, and at width 32 and depth 2 the hidden
  states and the fused weighted sum agree at 1e-5; ViT-L/14 cut to width 32
  with patch 14, `encode_image` at 1e-5.
- The importers at cut width: a fairseq HuBERT-Large-format dict (conv biases,
  per-conv LayerNorms, the unapplied encoder LayerNorm), an OpenAI
  ViT-L/14-format dict and a Lightning `.ckpt` of hybrid+ large, each
  through the port's importer and JAX's (+ `from_jax`): equal tensor for
  tensor, and the same `encode_speech`.
- The twins at the new widths against the JAX kernels in interpret mode: K1
  context-only + lse and K2 at dh=128 (2e-5 abs, as
  `test_torch_fused_attention_block_vjp.py`), K3 and K3b at D=768 (targets
  and keywords equal, statistics 1e-5 rel; the straight-through gradient
  1e-5 abs).

The card's kernels at these widths are in `test_torch_cuda_kernels.py`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechclip_plus_tpu.checkpoint import towers as jtowers
from speechclip_plus_tpu.checkpoint.lightning_import import (
    lightning_to_kwclip as jax_lightning_to_kwclip,
)
from speechclip_plus_tpu.config import load_config as jax_load_config
from speechclip_plus_tpu.models.clip import ClipConfig as JClipConfig
from speechclip_plus_tpu.models.clip import ClipModel as JClip
from speechclip_plus_tpu.models.hubert import HubertConfig as JHubertConfig
from speechclip_plus_tpu.models.hubert import HubertModel as JHubert
from speechclip_plus_tpu.models.kwclip import KWClipConfig as JKWClipConfig
from speechclip_plus_tpu.nn.fused_attention_block_vjp import (
    fused_attention_block_vjp as jax_vjp,
)
from speechclip_plus_tpu.ops.fused_keyword import fused_cosine_vq as jax_fused_vq
from speechclip_plus_tpu.tasks.builder import resolve_reduced_vocab as jax_vocab

from speechclip_plus_tpu_torch.checkpoint import lightning_to_kwclip, load_lightning_checkpoint
from speechclip_plus_tpu_torch.checkpoint import towers
from speechclip_plus_tpu_torch.checkpoint.from_jax import (load_clip, load_hubert,
                                                           load_jax_variables)
from speechclip_plus_tpu_torch.checkpoint.torch_import import load_port_state_dict
from speechclip_plus_tpu_torch.config import load_config
from speechclip_plus_tpu_torch.models.clip import ClipConfig, ClipModel
from speechclip_plus_tpu_torch.models.hubert import HubertConfig, HubertModel
from speechclip_plus_tpu_torch.models.kwclip import KWClip, KWClipConfig
from speechclip_plus_tpu_torch.nn import fused_attention_block as fab
from speechclip_plus_tpu_torch.nn import fused_attention_block_vjp as vjp
from speechclip_plus_tpu_torch.ops import fused_keyword as fk
from speechclip_plus_tpu_torch.tasks.builder import resolve_reduced_vocab

from test_checkpoint_import import _bn, _ln, _lin, _mha_packed
from test_torch_checkpoint_import import (assert_same_speech, fan_in_scale,
                                          jax_encode_speech, wav_batch,
                                          write_lightning_ckpt)
from test_torch_families import D, _configs, check_small_family
from test_torch_towers import _assert_equal_modules, clip_sd, hubert_sd

LARGE = "config/speechclip_plus/large/{}/{}.yaml"
# the large towers' structure at tiny width (`HubertConfig.tiny` keys)
TOWERS = {
    "large": dict(extractor_mode="layer_norm", conv_bias=True, layer_norm_first=True),
    "wavlm_large": dict(extractor_mode="layer_norm", conv_bias=True, layer_norm_first=True,
                        rel_pos_bias=True),
    "data2vec_large": dict(extractor_mode="layer_norm", conv_pos=19, pos_conv_depth=5),
}
ARCH = ("conv_layers", "extractor_mode", "conv_bias", "d_model", "n_layers", "n_heads",
        "ffn_dim", "layer_norm_first", "conv_pos", "conv_pos_groups", "pos_conv_depth",
        "rel_pos_bias", "rel_buckets", "rel_max_distance", "dropout", "attention_dropout")
TOL = dict(rtol=1e-5, atol=1e-5)
ATOL = 2e-5


def _cut(mc):
    """The cut model keeps three keyword-projection widths and ViT-L's patch
    of 14 (a 32 x 32 image: 2 x 2 patches)."""
    head = dataclasses.replace(mc.head, kw_proj_dims=(D, D, D))
    clip = dataclasses.replace(mc.clip, vision_patch_size=14)
    return dataclasses.replace(mc, head=head, clip=clip)


# ------------------------------------------------------------ the YAMLs ----

@pytest.mark.parametrize("dataset", ["flickr", "coco"])
@pytest.mark.parametrize("family", ["hybrid_plus", "cascaded_plus"])
def test_large_yaml_parses_as_jax_does(dataset, family):
    path = LARGE.format(dataset, family)
    got = []
    for load, vocab_of, cfg_cls in ((jax_load_config, jax_vocab, JKWClipConfig),
                                    (load_config, resolve_reduced_vocab, KWClipConfig)):
        cfg = load(path)
        vocab = vocab_of(cfg)
        got.append((cfg_cls.from_config(cfg, vocab_size=len(vocab),
                                        sot_id=int(vocab.sot_reduced),
                                        eot_id=int(vocab.eot_reduced)), len(vocab)))
    (jmc, jv), (mc, v) = got
    assert v == jv == {"flickr": 8112, "coco": 19787}[dataset]
    for name in ARCH:
        assert getattr(mc.audio, name) == getattr(jmc.audio, name), name
    assert mc.audio == dataclasses.replace(HubertConfig.large(), dtype=torch.bfloat16)
    for f in dataclasses.fields(ClipConfig):
        if f.name not in ("dtype", "text_remat_mode", "text_fused_attention_vjp"):
            assert getattr(mc.clip, f.name) == getattr(jmc.clip, f.name), f.name
    assert (mc.clip.vision_width, mc.clip.vision_layers, mc.clip.vision_patch_size,
            mc.clip.text_width, mc.clip.vocab_size) == (1024, 24, 14, 768, v)
    ta, jta = mc.cascaded_ta, jmc.cascaded_ta
    assert (ta.type, ta.d_model, ta.nhead, ta.dim_feedforward) == (
        jta.type, jta.d_model, jta.nhead, jta.dim_feedforward) == (
        "MultiheadAttentionAndNorm", 1024, 8, 4096)
    assert ta.d_model // ta.nhead == 128
    assert mc.head.kw_proj_dims == tuple(jmc.head.kw_proj_dims) == (1024, 1024, 768)
    assert mc.head.text_dim == jmc.head.text_dim == 768
    assert mc.branch_type == jmc.branch_type == {"hybrid_plus": "HybridBranch_plus",
                                                 "cascaded_plus": "CascadedBranch_plus"}[family]
    assert mc.cif.encoder_embed_dim == jmc.cif.encoder_embed_dim == 1024
    assert (mc.cascaded_objective_weight, mc.parallel_objective_weight) == (
        jmc.cascaded_objective_weight, jmc.parallel_objective_weight)
    assert mc.retrieval_audio_feat_src == jmc.retrieval_audio_feat_src == "cascaded"


@pytest.mark.parametrize("family", ["hybrid_plus", "cascaded_plus"])
def test_large_family_matches_jax(family):
    jcfg, (jfull, jsmall), cfg, (full, small) = _configs(
        LARGE.format("flickr", family), **TOWERS["large"])
    assert full.audio.layer_norm_first and jfull.audio.layer_norm_first
    jsmall, small = _cut(jsmall), _cut(small)
    assert (small.audio.conv_bias, small.audio.layer_norm_first, small.clip.vision_patch_size,
            len(small.head.kw_proj_dims)) == (True, True, 14, 3)
    check_small_family(jcfg, jsmall, cfg, small, family)


# ----------------------------------------------------------- the towers ----

@pytest.mark.parametrize("name", ["large", "wavlm_large", "data2vec_large"])
def test_large_presets_equal_jax(name):
    port, jax_ = getattr(HubertConfig, name)(), getattr(JHubertConfig, name)()
    for field in ARCH:
        assert getattr(port, field) == getattr(jax_, field), field
    assert (port.d_model, port.n_layers, port.n_heads, port.ffn_dim) == (1024, 24, 16, 4096)
    upstream = {"large": "hubert_large_ll60k", "wavlm_large": "wavlm_large",
                "data2vec_large": "data2vec_large"}[name]
    assert HubertConfig.from_upstream_name(upstream) == port
    assert port.num_hidden_states == 25


@pytest.mark.parametrize("name", list(TOWERS))
def test_large_tower_matches_jax(name):
    jm = JHubert(JHubertConfig.tiny(**TOWERS[name]))
    wav0 = jnp.zeros((2, 400), jnp.float32)
    params = jax.jit(lambda k: jm.init(k, wav0, wav0 == 1.0))(jax.random.PRNGKey(4))
    params = jax.tree_util.tree_map(np.asarray, params)["params"]
    tm = HubertModel(HubertConfig.tiny(**TOWERS[name])).eval()
    load_hubert(tm, params)  # strict both ways: conv biases, ln_i, the encoder norm
    lens = [800, 515, 300]
    rng = np.random.RandomState(0)
    wav = (0.5 * rng.randn(3, 800)).astype(np.float32)
    pad = np.arange(800)[None, :] >= np.asarray(lens)[:, None]
    wav[pad] = 0.0
    logits = rng.randn(3).astype(np.float32)
    want = jm.apply({"params": params}, jnp.asarray(wav), jnp.asarray(pad),
                    layer_weights=jax.nn.softmax(jnp.asarray(logits)))
    stack = jm.apply({"params": params}, jnp.asarray(wav), jnp.asarray(pad))["hidden_states"]
    with torch.no_grad():
        got = tm(torch.from_numpy(wav), torch.from_numpy(pad),
                 torch.softmax(torch.from_numpy(logits), 0), return_hidden_states=True)
    np.testing.assert_array_equal(got["padding_mask"].numpy(), np.asarray(want["padding_mask"]))
    for key in ("weighted_sum", "x"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL, err_msg=key)
    np.testing.assert_allclose(got["hidden_states"].numpy(), np.asarray(stack), **TOL)
    if TOWERS[name].get("layer_norm_first"):
        # the encoder norm is held (a checkpoint carries it) but not applied:
        # hidden state 0 is the frames plus the positional conv
        assert not torch.allclose(tm.encoder_layer_norm(got["hidden_states"][0]),
                                  got["hidden_states"][0], atol=1e-3)


def _vit_l14_cut():
    """ViT-L/14's structure at width 32: patch 14, 4 x 4 patches of a 56-pixel
    image, 2 layers of 2 heads."""
    kw = dict(embed_dim=16, image_resolution=56, vision_width=32, vision_layers=2,
              vision_heads=2, context_length=16, vocab_size=64, text_width=32, text_heads=4,
              text_layers=2, sot_id=62, eot_id=63)
    return (dataclasses.replace(ClipConfig.vit_l14(), **kw),
            dataclasses.replace(JClipConfig.vit_l14(), **kw))


def test_vit_l14_preset_and_image_tower_match_jax():
    for f in dataclasses.fields(ClipConfig):
        if f.name not in ("dtype", "text_remat_mode", "text_fused_attention_vjp"):
            assert getattr(ClipConfig.vit_l14(), f.name) == getattr(JClipConfig.vit_l14(),
                                                                    f.name), f.name
    cfg, jcfg = _vit_l14_cut()
    assert cfg.vision_patch_size == 14
    jm = JClip(jcfg)
    img0 = jnp.zeros((1, 56, 56, 3), jnp.float32)
    ids = jnp.zeros((1, 16), jnp.int32)
    params = jax.jit(lambda k: jm.init(k, img0, ids))(jax.random.PRNGKey(5))
    params = jax.tree_util.tree_map(np.asarray, params)["params"]
    tm = ClipModel(cfg).eval()
    load_clip(tm, params)
    img = np.random.RandomState(6).rand(3, 56, 56, 3).astype(np.float32)
    want = jm.apply({"params": params}, jnp.asarray(img), method=JClip.encode_image)
    with torch.no_grad():
        got = tm.encode_image(torch.from_numpy(img))
    assert got.shape == (3, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -------------------------------------------------------- the importers ----

def fairseq_large_sd(cfg, seed=2):
    """A fairseq HuBERT-Large-format dict: the base names, plus a bias on
    every frontend conv and a LayerNorm after it (`conv_layers.{i}.2.1`) in
    place of layer 0's GroupNorm."""
    sd = hubert_sd("fairseq", cfg, seed)
    rng = np.random.RandomState(seed + 1)
    del sd["feature_extractor.conv_layers.0.2.weight"], sd["feature_extractor.conv_layers.0.2.bias"]
    for i, (ch, _, _) in enumerate(cfg.conv_layers):
        sd[f"feature_extractor.conv_layers.{i}.0.bias"] = rng.randn(ch).astype(np.float32)
        for part in ("weight", "bias"):
            sd[f"feature_extractor.conv_layers.{i}.2.1.{part}"] = rng.randn(ch).astype(np.float32)
    return sd


def test_fairseq_large_importer_matches_jax():
    cfg = HubertConfig.tiny(**TOWERS["large"])
    jcfg = JHubertConfig.tiny(**TOWERS["large"])
    sd = fan_in_scale(fairseq_large_sd(cfg))
    port = HubertModel(cfg)
    load_port_state_dict(port, towers.fairseq_hubert_to_port(sd, cfg))
    bridged = HubertModel(cfg)
    load_hubert(bridged, jtowers.fairseq_hubert_to_flax(sd, jcfg))
    _assert_equal_modules(port, bridged)
    assert torch.equal(port.feature_extractor.conv_layers[1].bias,
                       torch.from_numpy(sd["feature_extractor.conv_layers.1.0.bias"]))
    assert torch.equal(port.encoder_layer_norm.weight,
                       torch.from_numpy(sd["encoder.layer_norm.weight"]))
    # the config inferred from a full-width dict is the large preset in both packages
    large = {"encoder.layers.0.fc1.weight": np.zeros((4096, 1024), np.float32)}
    got, want = towers.hubert_config_from_fairseq_sd(large), \
        jtowers.hubert_config_from_fairseq_sd(large)
    assert got == HubertConfig.large()
    for name in ARCH:
        assert getattr(got, name) == getattr(want, name), name


def test_openai_vit_l14_importer_matches_jax():
    cfg, jcfg = _vit_l14_cut()
    sd = clip_sd("openai", cfg)
    port = ClipModel(cfg)
    load_port_state_dict(port, towers.openai_clip_to_port(sd, cfg))
    bridged = ClipModel(cfg)
    load_clip(bridged, jtowers.openai_clip_to_flax(sd, jcfg))
    _assert_equal_modules(port, bridged)
    inferred, jinferred = (towers.clip_config_from_openai_sd(sd),
                           jtowers.clip_config_from_openai_sd(sd))
    for f in dataclasses.fields(ClipConfig):
        if f.name not in ("dtype", "text_remat_mode", "text_fused_attention_vjp"):
            assert getattr(inferred, f.name) == getattr(jinferred, f.name), f.name
    assert (inferred.vision_patch_size, inferred.image_resolution, inferred.vision_width) == (
        14, 56, 32)
    # a full-width ViT-L/14 dict (shapes only) infers the preset
    full = ClipConfig.vit_l14()
    shapes = {"visual.conv1.weight": (1024, 3, 14, 14), "visual.positional_embedding": (257, 1024),
              "ln_final.weight": (768,), "token_embedding.weight": (49408, 768),
              "text_projection": (768, 768), "positional_embedding": (77, 768)}
    big = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    for i in range(24):
        big[f"visual.transformer.resblocks.{i}.ln_1.weight"] = np.zeros(1, np.float32)
    for i in range(12):
        big[f"transformer.resblocks.{i}.ln_1.weight"] = np.zeros(1, np.float32)
    assert towers.clip_config_from_openai_sd(big) == full


def _large_hybrid_plus_configs():
    """(JAX, port) KWClipConfig of hybrid+ large (flickr) cut to width 32 with
    the large structure."""
    _, (_, jsmall), _, (_, small) = _configs(LARGE.format("flickr", "hybrid_plus"),
                                             **TOWERS["large"])
    return _cut(jsmall), _cut(small)


def large_reference_sd(jcfg):
    """A reference-format Lightning state dict of hybrid+ large at cut width:
    fairseq HuBERT-Large names under `audio_encoder.encoder.`, OpenAI
    ViT-L/14 names under `clip.model.`, and the avssl hybrid+ branch with its
    `MLPLayers` keyword projection (`linear_proj.sequential.{0,3}`)."""
    sd = {f"audio_encoder.encoder.{k}": v
          for k, v in fairseq_large_sd(HubertConfig.tiny(**TOWERS["large"])).items()}
    sd["audio_encoder.weightedsum_layer.weights"] = np.random.RandomState(3).randn(
        jcfg.audio.n_layers + 1).astype(np.float32)
    c = jcfg.clip
    sd.update({f"clip.model.{k}": v for k, v in clip_sd("openai", c).items()})
    sd["criterion.temperature"] = np.asarray(np.log(1 / 0.07), np.float32)
    np.random.seed(4)
    bp = "cascaded_branch."
    sd[f"{bp}cls"] = np.random.randn(1, 1, D).astype(np.float32)
    _mha_packed(sd, f"{bp}self_att.multihead_attn_layer", D)
    _ln(sd, f"{bp}self_att.attentionBlock_Norm", D)
    sd[f"{bp}downsampling.conv.0.weight"] = np.random.randn(D, D, 3).astype(np.float32)
    sd[f"{bp}downsampling.conv.0.bias"] = np.random.randn(D).astype(np.float32)
    _lin(sd, f"{bp}downsampling.weight_proj.1", 1, D)
    dims = jcfg.head.kw_proj_dims
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        _lin(sd, f"{bp}linear_proj.sequential.{3 * i}", b, a)
    _bn(sd, f"{bp}bn_layer.bn_layer", jcfg.head.text_dim)
    sd[f"{bp}vector_quantizer.curr_temp"] = np.asarray([0.1], np.float32)
    _lin(sd, f"{bp}parallel_proj", c.text_width, D)
    sd = fan_in_scale(sd)
    # a low CIF alpha bias keeps the keyword count below the text context
    sd[f"{bp}downsampling.weight_proj.1.bias"] = np.full(1, -5.0, np.float32)
    return sd


def test_lightning_ckpt_of_hybrid_plus_large_matches_jax(tmp_path):
    jcfg, cfg = _large_hybrid_plus_configs()
    sd = large_reference_sd(jcfg)
    path = str(tmp_path / "large.ckpt")
    write_lightning_ckpt(path, sd, load_config(LARGE.format("flickr", "hybrid_plus")).to_dict())
    got_sd, got_cfg, _ = load_lightning_checkpoint(path)
    assert got_cfg.clip.name == "ViT-L/14"
    assert got_cfg.audio_encoder.name == "hubert_large_ll60k"
    port = KWClip(cfg).eval()
    lightning_to_kwclip(got_sd, port)
    params, batch_stats = jax_lightning_to_kwclip(sd, jcfg)
    variables = jax.tree_util.tree_map(np.asarray, {"params": params,
                                                    "batch_stats": batch_stats})
    bridged = KWClip(cfg).eval()
    load_jax_variables(bridged, variables)  # strict both ways
    _assert_equal_modules(port, bridged)
    assert len(port.cascaded_branch.head.linear_proj.layers) == 2
    wav, lens = wav_batch()
    want = jax_encode_speech(jcfg, variables, wav, lens)
    with torch.inference_mode():
        got = port.encode_speech(torch.from_numpy(wav), torch.from_numpy(lens))
    assert_same_speech(got, want)


# ---------------------------------------- the twins at the new widths ----

def _block_case(seed, b, t, d):
    rng = np.random.RandomState(seed)
    mk = lambda *s, scale=1.0: (rng.randn(*s) * scale).astype(np.float32)
    x = mk(b, t, d)
    w = {n: mk(d, d, scale=d ** -0.5) for n in "qkvo"}   # JAX (in, out) kernels
    bias = {n: mk(d, scale=0.1) for n in "qkvo"}
    lens = np.array([t] + list(rng.randint(1, t + 1, size=b - 1)))
    kb = np.where(np.arange(t)[None, :] >= lens[:, None], -1e30, 0.0).astype(np.float32)
    return x, w, bias, kb, mk(b, t, d)


@pytest.mark.parametrize("b,t", [(2, 37), (2, 21)])
def test_dh128_context_lse_and_backward_twins_match_jax(b, t):
    """K1's context-only forward with its lse and K2, at two heads of 128
    (the large branches' head), against JAX's differentiable fused block."""
    d, heads = 256, 2
    x, w, bias, kb, probe = _block_case(7, b, t, d)

    def jloss(x, w, bias):
        out = jax_vjp(x, *(a for n in "qkvo" for a in (w[n], bias[n])), jnp.asarray(kb),
                      n_heads=heads, dtype=jnp.float32, interpret=True)
        return (out * probe).sum(), out

    (_, jout), (jdx, jdw, jdb) = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), {n: jnp.asarray(a) for n, a in w.items()},
        {n: jnp.asarray(a) for n, a in bias.items()})
    params = [torch.from_numpy(a).requires_grad_(True) for a in (
        np.concatenate([w["q"], w["k"], w["v"]], 1).T.copy(),
        np.concatenate([bias["q"], bias["k"], bias["v"]]), w["o"].T.copy(), bias["o"])]
    xt = torch.from_numpy(x).requires_grad_(True)
    out = vjp.fused_attention_block_vjp(xt, *params, torch.from_numpy(kb), n_heads=heads)
    (out * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=ATOL, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), atol=ATOL, rtol=0)
    jw_in = np.concatenate([np.asarray(jdw[n]) for n in "qkv"], 1).T
    np.testing.assert_allclose(params[0].grad.numpy(), jw_in, atol=ATOL, rtol=0)
    # the lse the backward reads: logsumexp of the scaled scores, in JAX
    with torch.no_grad():
        _, _, lse = fab.attention_forward(torch.from_numpy(x), params[0], params[1],
                                          torch.from_numpy(kb), n_heads=heads)
    q = (jnp.asarray(x) @ jnp.asarray(w["q"]) + bias["q"]).reshape(b, t, heads, -1)
    k = (jnp.asarray(x) @ jnp.asarray(w["k"]) + bias["k"]).reshape(b, t, heads, -1)
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) * (d // heads) ** -0.5 + kb[:, None, None, :]
    np.testing.assert_allclose(lse.numpy(), np.asarray(jax.nn.logsumexp(s, axis=-1)),
                               atol=1e-4, rtol=0)


def _vq_case(b, k, d, v, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, k, d).astype(np.float32)
    xn = x / np.linalg.norm(x, axis=-1, keepdims=True)
    emb = (rng.randn(v, d) * 0.1 + rng.randn(1, d) * 0.02).astype(np.float32)
    return xn, emb


def test_d768_cosine_vq_and_st_backward_twins_match_jax():
    """K3 and K3b's twins at the large family's codebook width, D=768."""
    b, k, d, v = 4, 8, 768, 130  # N=32 rows: a whole Pallas row tile
    xn, emb = _vq_case(b, k, d, v, 8)
    cot = (np.random.RandomState(9).randn(b, k, d) * 1e-2).astype(np.float32)

    def jloss(x):
        out = jax_fused_vq(x, jnp.asarray(emb), jnp.float32(0.1), prob_msk=(0, 2, 3),
                           training=True, dtype=jnp.float32, interpret=True)
        return (out["keywords"] * cot).sum(), out

    (_, want), jdx = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(xn))
    xt = torch.from_numpy(xn).requires_grad_(True)
    got = fk.fused_cosine_vq(xt, torch.from_numpy(emb), 0.1, prob_msk=(0, 2, 3),
                             dtype=torch.float32, training=True)
    (got["keywords"] * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(got["targets"].numpy(), np.asarray(want["targets"]))
    np.testing.assert_array_equal(got["keywords"].detach().numpy(),
                                  np.asarray(want["keywords"]))
    for key in ("code_perplexity", "prob_perplexity"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(got["ent_per_t"].detach().numpy(), np.asarray(want["ent_per_t"]),
                               rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), atol=1e-5, rtol=0)
    assert np.abs(np.asarray(jdx)).max() > 1e-4  # a gradient that says something


def test_vit_l14_image_transform_matches_jax():
    """`clip_image_transform: ViT-L/14`: the datasets size images to the
    tower's `image_resolution` (224, as ViT-B/32) in both packages."""
    from PIL import Image

    from speechclip_plus_tpu.data.image import clip_image_transform as jax_transform
    from speechclip_plus_tpu_torch.data.image import clip_image_transform

    size = ClipConfig.vit_l14().image_resolution
    assert size == JClipConfig.vit_l14().image_resolution == 224
    pixels = np.random.RandomState(10).randint(0, 256, (300, 410, 3)).astype(np.uint8)
    img = Image.fromarray(pixels)
    got, want = clip_image_transform(img, size), jax_transform(img, size)
    assert got.shape == (224, 224, 3)
    np.testing.assert_array_equal(got, want)
