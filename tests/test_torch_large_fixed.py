"""The fixed-K large family in the port against the JAX package (fp32, CPU).

`config/speechclip/large/{flickr,coco}/{cascaded,parallel}.yaml` and
`config/speechclip_plus/large/{flickr,coco}/hybrid.yaml`: HuBERT-Large with
`normalize_hiddenstates: true` (the s3prl layer norm of every hidden state in
the weighted sum), ViT-L/14 with its 768-wide text tower; the cascaded and
hybrid branches run one head over 1024 (K1 and K2 at dh=1024) with K=8
keyword CLS and the keyword BN fused over 768 x 8 channels, the parallel
branch a `TransformerEncoder` of 8 heads of 128; hybrid large projects its
keywords and its parallel CLS through `MLPLayers` [1024, 1024, 768].

- (a) All six YAMLs parse to the same typed config in both packages (no
  full-width init).
- (b) The flickr models, cut to width 32 and depth 2 with the large structure
  and `normalize_hiddenstates` kept, through `encode_speech` and 3 training
  steps against JAX (`test_torch_families.check_small_family`, its
  tolerances). Hybrid large accumulates 4 batches: the cut test takes 2 in both
  packages, so that its 3 steps hold an Adam update.
- (c) `KWClip.forward_audio` for every feature `feat_select_idx` and
  `normalize_type` name (s3prl through the tower's accumulation; method1,
  method2, last_hidden_state and an index tuple through the stack) with
  `return_hidden_states`, at 1e-5, and the gradient into the layer weights
  at the first-step gradient tolerance of `check_small_family`; the stacked
  `ops.weighted_sum.weighted_sum` against JAX's, with and without its layer
  norm, at 1e-6.
- (d) K1's twin (context-only + lse) and K2's at one head of 1024 against
  JAX's differentiable block by both of its routes: the XLA route it takes
  by default off the TPU (and on the TPU at this width: no head grouping fits
  its VMEM budget), and its Pallas body in interpret mode with the budget
  raised. 2e-5 abs, as `test_torch_fused_attention_block_vjp.py`; lse 1e-4.
  At the branch's training shapes (B=128, T=327 and 328) JAX's own sizing
  sends both to XLA.
- (e) A Lightning `.ckpt` of cascaded large and of hybrid large at cut width
  through the port's importer and through JAX's (+ `from_jax`): equal tensor
  for tensor, and the same `encode_speech`.

The card's kernels at dh=1024 are in `test_torch_cuda_kernels.py`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechclip_plus_tpu.checkpoint.lightning_import import (
    lightning_to_kwclip as jax_lightning_to_kwclip,
)
from speechclip_plus_tpu.config import load_config as jax_load_config
from speechclip_plus_tpu.models.kwclip import KWClip as JKWClip
from speechclip_plus_tpu.models.kwclip import KWClipConfig as JKWClipConfig
from speechclip_plus_tpu.nn import fused_attention_block as jfab
from speechclip_plus_tpu.nn import fused_attention_block_vjp as jvjp
from speechclip_plus_tpu.tasks.builder import resolve_reduced_vocab as jax_vocab

from speechclip_plus_tpu_torch.checkpoint import lightning_to_kwclip, load_lightning_checkpoint
from speechclip_plus_tpu_torch.checkpoint.from_jax import load_jax_variables
from speechclip_plus_tpu_torch.config import load_config
from speechclip_plus_tpu_torch.models.hubert import HubertConfig
from speechclip_plus_tpu_torch.models.kwclip import KWClip, KWClipConfig
from speechclip_plus_tpu_torch.nn import fused_attention_block as fab
from speechclip_plus_tpu_torch.nn import fused_attention_block_vjp as vjp
from speechclip_plus_tpu_torch.tasks.builder import resolve_reduced_vocab

from test_checkpoint_import import _bn, _ln, _lin, _mha_packed
from test_torch_checkpoint_import import (assert_same_speech, fan_in_scale,
                                          jax_encode_speech, wav_batch,
                                          write_lightning_ckpt)
from test_torch_families import D, _batch, _configs, _jax_variables, check_small_family
from test_torch_large import ARCH, TOWERS, _block_case, fairseq_large_sd
from test_torch_towers import _assert_equal_modules, clip_sd

FIXED = {"cascaded": "config/speechclip/large/{}/cascaded.yaml",
         "parallel": "config/speechclip/large/{}/parallel.yaml",
         "hybrid": "config/speechclip_plus/large/{}/hybrid.yaml"}
BRANCH = {"cascaded": "CascadedBranch", "parallel": "", "hybrid": "HybridBranch"}
ATOL = 2e-5


def _cut(mc):
    """The cut model keeps every projection's depth (at width 32) and
    ViT-L's patch of 14 (a 32 x 32 image: 2 x 2 patches)."""
    width = lambda dims: None if dims is None else (D,) * len(dims)
    return dataclasses.replace(
        mc, head=dataclasses.replace(mc.head, kw_proj_dims=width(mc.head.kw_proj_dims)),
        pbranch_proj_dims=width(mc.pbranch_proj_dims),
        clip=dataclasses.replace(mc.clip, vision_patch_size=14))


# ----------------------------------------------------- (a) the YAMLs ----

@pytest.mark.parametrize("dataset", ["flickr", "coco"])
@pytest.mark.parametrize("family", list(FIXED))
def test_fixed_large_yaml_parses_as_jax_does(dataset, family):
    got = []
    for load, vocab_of, cfg_cls in ((jax_load_config, jax_vocab, JKWClipConfig),
                                    (load_config, resolve_reduced_vocab, KWClipConfig)):
        cfg = load(FIXED[family].format(dataset))
        vocab = vocab_of(cfg)
        got.append((cfg_cls.from_config(cfg, vocab_size=len(vocab),
                                        sot_id=int(vocab.sot_reduced),
                                        eot_id=int(vocab.eot_reduced)), len(vocab)))
    (jmc, jv), (mc, v) = got
    assert v == jv == {"flickr": 8112, "coco": 19787}[dataset]
    for name in ARCH:
        assert getattr(mc.audio, name) == getattr(jmc.audio, name), name
    assert mc.audio == dataclasses.replace(HubertConfig.large(), dtype=torch.bfloat16)
    assert (mc.normalize_hiddenstates, mc.normalize_type, mc.feat_select_idx) == (
        jmc.normalize_hiddenstates, jmc.normalize_type, jmc.feat_select_idx) == (
        True, "s3prl", "weighted_sum")
    assert (mc.clip.vision_width, mc.clip.vision_layers, mc.clip.vision_patch_size,
            mc.clip.text_width, mc.clip.vocab_size) == (1024, 24, 14, 768, v)
    assert mc.branch_type == jmc.branch_type == BRANCH[family]
    assert (mc.cascaded_objective_weight, mc.parallel_objective_weight) == (
        jmc.cascaded_objective_weight, jmc.parallel_objective_weight)
    assert mc.retrieval_audio_feat_src == jmc.retrieval_audio_feat_src == (
        "parallel" if family == "parallel" else "cascaded")
    for attr in ("cascaded_ta", "parallel_ta"):
        ta, jta = getattr(mc, attr), getattr(jmc, attr)
        assert (ta.type, ta.d_model, ta.nhead, ta.dim_feedforward) == (
            jta.type, jta.d_model, jta.nhead, jta.dim_feedforward), attr
    active = mc.cascaded_ta if mc.has_cascaded else mc.parallel_ta
    assert (active.d_model, active.d_model // active.nhead) == (
        (1024, 128) if family == "parallel" else (1024, 1024))
    if family != "parallel":
        assert active.type == "MultiheadAttentionAndNorm"
        assert mc.keyword_num == jmc.head.keyword_num == 8
        assert mc.head.text_dim == jmc.head.text_dim == 768
        assert (mc.head.bn.type, mc.head.bn.parallel) == (jmc.head.bn.type,
                                                          jmc.head.bn.parallel)
        kw = None if jmc.head.kw_proj_dims is None else tuple(jmc.head.kw_proj_dims)
        assert mc.head.kw_proj_dims == kw == (
            (1024, 1024, 768) if family == "hybrid" else None)
    pb = None if jmc.pbranch_proj_dims is None else tuple(jmc.pbranch_proj_dims)
    assert mc.pbranch_proj_dims == pb
    if family == "hybrid":
        assert pb == (1024, 1024, 768)


# ----------------------------------------- (b) the families at cut width ----

@pytest.mark.parametrize("family", list(FIXED))
def test_fixed_large_family_matches_jax(family):
    jcfg, (jfull, jsmall), cfg, (full, small) = _configs(
        FIXED[family].format("flickr"), **TOWERS["large"])
    jsmall, small = _cut(jsmall), _cut(small)
    assert small.normalize_hiddenstates and jsmall.normalize_hiddenstates
    assert (small.audio.conv_bias, small.audio.layer_norm_first,
            small.clip.vision_patch_size) == (True, True, 14)
    if family != "parallel":
        assert small.cascaded_ta.nhead == 1  # one head stays one head
    if family == "hybrid":
        assert len(small.head.kw_proj_dims) == len(small.pbranch_proj_dims) == 3
        assert int(cfg.trainer.accumulate_grad_batches) == 4
        jcfg.trainer.accumulate_grad_batches = cfg.trainer.accumulate_grad_batches = 2
    check_small_family(jcfg, jsmall, cfg, small, family)


# --------------------------------------------- (c) the audio features ----

MODES = {  # id -> (feat_select_idx, normalize_type), all with normalize_hiddenstates
    "s3prl_fused": ("weighted_sum", "s3prl"),
    "method1": ("weighted_sum", "method1"),
    "method2": ("weighted_sum", "method2"),
    "last_hidden_state": ("last_hidden_state", "s3prl"),
    "index_tuple": ((2, 0), "s3prl"),
}


@pytest.fixture(scope="module")
def cascaded_cut():
    """(JAX config, port config, JAX variables) of cascaded large at cut
    width, with random layer-weight logits."""
    _, (_, jsmall), _, (_, small) = _configs(FIXED["cascaded"].format("flickr"),
                                             **TOWERS["large"])
    jsmall, small = _cut(jsmall), _cut(small)
    variables = _jax_variables(JKWClip(jsmall), jsmall)
    n = small.audio.num_hidden_states
    variables["params"]["weightedsum"] = np.random.RandomState(11).randn(n).astype(np.float32)
    return jsmall, small, variables


@pytest.mark.parametrize("mode", list(MODES))
def test_forward_audio_features_match_jax(mode, cascaded_cut):
    jsmall, small, variables = cascaded_cut
    idx, norm = MODES[mode]
    jc = dataclasses.replace(jsmall, feat_select_idx=idx, normalize_type=norm)
    pc = dataclasses.replace(small, feat_select_idx=idx, normalize_type=norm)
    batch = _batch()
    wav, lens = jnp.asarray(batch["wav"]), jnp.asarray(batch["wav_len"])
    jmodel = JKWClip(jc)
    feat0, _, _ = jmodel.apply(variables, wav, lens, method=JKWClip.forward_audio,
                               return_hidden_states=True)
    probe = np.random.RandomState(12).randn(*feat0.shape).astype(np.float32)

    def jloss(w):
        v = {**variables, "params": {**variables["params"], "weightedsum": w}}
        feat, feat_len, hidden = jmodel.apply(v, wav, lens, method=JKWClip.forward_audio,
                                              return_hidden_states=True)
        return (feat * probe).sum(), (feat, feat_len, hidden)

    (_, (jfeat, jlen, jhidden)), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(variables["params"]["weightedsum"]))
    model = KWClip(pc).eval()
    load_jax_variables(model, variables)
    feat, feat_len, hidden = model.forward_audio(torch.from_numpy(batch["wav"]),
                                                 torch.from_numpy(batch["wav_len"]),
                                                 return_hidden_states=True)
    reads_weights = mode not in ("last_hidden_state", "index_tuple")
    assert feat.requires_grad == reads_weights
    if reads_weights:
        (feat * torch.from_numpy(probe)).sum().backward()
    assert feat.shape == jfeat.shape == ((2,) if mode == "index_tuple" else ()) + (
        6, hidden.shape[2], D)
    np.testing.assert_allclose(feat.detach().numpy(), np.asarray(jfeat), rtol=0, atol=1e-5)
    frames = np.minimum(np.round(batch["wav_len"] / pc.audio.downsample_rate), hidden.shape[2])
    np.testing.assert_array_equal(feat_len.numpy(), frames)
    if mode != "index_tuple":  # JAX clamps a stacked feature's lengths to its axis 1 (B)
        np.testing.assert_array_equal(feat_len.numpy(), np.asarray(jlen))
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jhidden), rtol=0, atol=1e-5)
    jgrad = np.asarray(jgrad)
    if not reads_weights:
        assert not jgrad.any()
        return
    # a sum over every (frame, channel) of the batch: the first-step gradient
    # tolerance of `check_small_family`
    gmax = np.abs(jgrad).max()
    assert gmax > 1e-3  # a gradient that says something
    np.testing.assert_allclose(model.weightedsum.grad.numpy(), jgrad, rtol=1e-4,
                               atol=1e-5 + 1e-4 * gmax)


@pytest.mark.parametrize("normalize", [False, True])
def test_stacked_weighted_sum_matches_jax(normalize):
    """`ops.weighted_sum.weighted_sum` (the stacked route) against JAX's, with
    and without the layer norm of each feature vector, 1e-6."""
    from speechclip_plus_tpu.ops.weighted_sum import weighted_sum as jax_weighted_sum
    from speechclip_plus_tpu_torch.ops.weighted_sum import weighted_sum

    rng = np.random.RandomState(14)
    hidden = (3.0 * rng.randn(5, 2, 7, 16) + 1.0).astype(np.float32)
    logits = rng.randn(5).astype(np.float32)
    want = jax_weighted_sum(jnp.asarray(hidden), jnp.asarray(logits), normalize)
    got = weighted_sum(torch.from_numpy(hidden), torch.from_numpy(logits), normalize)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


# ------------------------------------------- (d) the twins at dh=1024 ----

@pytest.mark.parametrize("t", [327, 328])
def test_jax_takes_its_xla_route_at_one_head_of_1024(t):
    """At the fixed-K large branch's training shapes the JAX package runs no
    Pallas kernel: neither the forward's nor the backward's VMEM estimate fits
    its budget with any head grouping, in bf16 or fp32, so both take XLA
    (`nn/fused_attention_block.py:494`, `nn/fused_attention_block_vjp.py:431`).
    The port runs its K1 and K2 there all the same."""
    b, d, heads = 128, 1024, 1
    for itemsize in (2, 4):
        assert jfab._vmem_estimate(b, t, d, d, 1, itemsize) > jfab._VMEM_BUDGET_BYTES
        assert jfab._pick_groups(b, t, d, d, heads, itemsize) is None
        assert jvjp._pick_groups_vjp(b, t, d, heads, itemsize, False) is None
    assert 1024 in fab._HEAD_DIMS


@pytest.mark.parametrize("route", ["xla", "pallas"])
@pytest.mark.parametrize("t", [40, 45])
def test_dh1024_context_lse_and_backward_twins_match_jax(t, route, monkeypatch):
    """K1's context-only forward with its lse and K2 at one head of 1024,
    against JAX's differentiable fused block, p=0."""
    b, d, heads = 2, 1024, 1
    x, w, bias, kb, probe = _block_case(13, b, t, d)
    # JAX's own sizing: at this width no head grouping fits its VMEM budget,
    # so it takes its XLA route even where it could run Pallas
    assert jvjp._pick_groups_vjp(b, t, d, heads, 4, False) is None
    interpret = route == "pallas"
    if interpret:  # the Pallas body, with the budget raised as JAX's tests raise it
        monkeypatch.setattr(jfab, "_VMEM_BUDGET_BYTES", 1 << 30)
        assert jvjp._pick_groups_vjp(b, t, d, heads, 4, False) == 1

    def jloss(x, w, bias):
        out = jvjp.fused_attention_block_vjp(
            x, *(a for n in "qkvo" for a in (w[n], bias[n])), jnp.asarray(kb), n_heads=heads,
            dtype=jnp.float32, interpret=interpret)
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
    jb_in = np.concatenate([np.asarray(jdb[n]) for n in "qkv"])
    np.testing.assert_allclose(params[1].grad.numpy(), jb_in, atol=ATOL, rtol=0)
    np.testing.assert_allclose(params[2].grad.numpy(), np.asarray(jdw["o"]).T, atol=ATOL, rtol=0)
    # the lse the backward reads: logsumexp of the scaled scores, in JAX
    with torch.no_grad():
        _, _, lse = fab.attention_forward(torch.from_numpy(x), params[0], params[1],
                                          torch.from_numpy(kb), n_heads=heads)
    q = jnp.asarray(x) @ jnp.asarray(w["q"]) + bias["q"]
    k = jnp.asarray(x) @ jnp.asarray(w["k"]) + bias["k"]
    s = jnp.einsum("bqd,bkd->bqk", q, k) * d ** -0.5 + kb[:, None, :]
    assert lse.shape == (b, heads, t)
    np.testing.assert_allclose(lse[:, 0].numpy(), np.asarray(jax.nn.logsumexp(s, axis=-1)),
                               atol=1e-4, rtol=0)


# ------------------------------------------------- (e) the importers ----

def fixed_large_reference_sd(jcfg, family):
    """A reference-format Lightning state dict of cascaded or hybrid large at
    cut width: fairseq HuBERT-Large names under `audio_encoder.encoder.`,
    OpenAI ViT-L/14 names under `clip.model.`, and the avssl branch: one-head
    `MultiheadAttentionAndNorm`, K=8 keyword CLS, the keyword BN fused over
    D x K channels, the keyword projection (`linear_proj`, an `MLPLayers` in
    hybrid) and hybrid's `MLPLayers` parallel projection."""
    sd = {f"audio_encoder.encoder.{k}": v
          for k, v in fairseq_large_sd(HubertConfig.tiny(**TOWERS["large"])).items()}
    sd["audio_encoder.weightedsum_layer.weights"] = np.random.RandomState(3).randn(
        jcfg.audio.n_layers + 1).astype(np.float32)
    sd.update({f"clip.model.{k}": v for k, v in clip_sd("openai", jcfg.clip).items()})
    sd["criterion.temperature"] = np.asarray(np.log(1 / 0.07), np.float32)
    np.random.seed(4)
    bp, k = "cascaded_branch.", jcfg.head.keyword_num
    _mha_packed(sd, f"{bp}self_att.multihead_attn_layer", D)
    _ln(sd, f"{bp}self_att.attentionBlock_Norm", D)
    if jcfg.head.kw_proj_dims is None:
        _lin(sd, f"{bp}linear_proj", jcfg.head.text_dim, D)
    else:
        dims = jcfg.head.kw_proj_dims
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            _lin(sd, f"{bp}linear_proj.sequential.{3 * i}", b, a)
    _bn(sd, f"{bp}bn_layer.bn_layer", jcfg.head.text_dim * k)  # fused: d*K + k
    sd[f"{bp}vector_quantizer.curr_temp"] = np.asarray([0.1], np.float32)
    if family == "cascaded":
        sd[f"{bp}cls"] = np.random.randn(1, k, D).astype(np.float32)
    else:
        sd[f"{bp}parallel_cls"] = np.random.randn(1, 1, D).astype(np.float32)
        sd[f"{bp}cascaded_cls"] = np.random.randn(1, k, D).astype(np.float32)
        dims = jcfg.pbranch_proj_dims
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            _lin(sd, f"{bp}parallel_proj.sequential.{3 * i}", b, a)
    return fan_in_scale(sd)


@pytest.mark.parametrize("family", ["cascaded", "hybrid"])
def test_lightning_ckpt_of_fixed_large_matches_jax(family, tmp_path):
    path = FIXED[family].format("flickr")
    _, (_, jcfg), _, (_, cfg) = _configs(path, **TOWERS["large"])
    jcfg, cfg = _cut(jcfg), _cut(cfg)
    sd = fixed_large_reference_sd(jcfg, family)
    ckpt = str(tmp_path / f"{family}_large.ckpt")
    write_lightning_ckpt(ckpt, sd, load_config(path).to_dict())
    got_sd, got_cfg, _ = load_lightning_checkpoint(ckpt)
    assert got_cfg.audio_encoder.normalize_hiddenstates is True
    assert got_cfg.model_settings.cascaded_branch.transformer_args.nhead == 1
    port = KWClip(cfg).eval()
    lightning_to_kwclip(got_sd, port)
    params, batch_stats = jax_lightning_to_kwclip(sd, jcfg)
    variables = jax.tree_util.tree_map(np.asarray, {"params": params,
                                                    "batch_stats": batch_stats})
    bridged = KWClip(cfg).eval()
    load_jax_variables(bridged, variables)  # strict both ways
    _assert_equal_modules(port, bridged)
    branch = port.cascaded_branch
    assert branch.head.bn_layer.running_mean.numel() == 8 * D
    if family == "hybrid":
        assert len(branch.head.linear_proj.layers) == len(branch.parallel_proj.layers) == 2
    wav, lens = wav_batch()
    want = jax_encode_speech(jcfg, variables, wav, lens)
    with torch.inference_mode():
        got = port.encode_speech(torch.from_numpy(wav), torch.from_numpy(lens))
    assert_same_speech(got, want)
