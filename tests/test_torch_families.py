"""Every base YAML builds in the port and matches the JAX package on the CPU.

For each file of `config/speechclip_plus/base/` and `config/speechclip/base/`
that names a model family (parallel, cascaded, cascaded+, hybrid, hybrid+,
hybrid+ with WavLM), both packages parse the YAML with `trainer.precision`
set to 32, the towers and the branch are cut to width 32 as
`tests/test_config_matrix.py` does (the wiring stays the YAML's: branch type,
transformer type, keyword BN layout, CIF, objective weights; one head stays
one head), the JAX variables move into the port through
`checkpoint/from_jax.py`, and the same numpy inputs go through
`encode_speech` and through 3 training steps with dropout off (JAX:
`value_and_grad` with the towers stop-gradient'd and the optax chain of its
`build_optimizer_from_config`; the port: `make_train_step`).

Tolerances, fp32 on both sides with sums in another order: features 1e-5 abs;
losses and the parameters after 3 steps 1e-5 abs + 1e-4 rel (the slice tests'
own); first-step gradients the same plus 1e-4 of the step's largest gradient
entry: some tensors' gradients are zero in exact arithmetic (a key bias under
softmax; any bias ahead of a batch-statistics BN, which in the fixed-K
families includes the branch LayerNorm's) and hold rounding noise of that
size on both sides. Adam turns such noise into lr-sized steps (the schedule's
warm-up is cut to 2 steps so that the updates are not below fp32 resolution),
so entries whose first-step gradient is below 1e-3 of the largest on both
sides are left out of the parameter comparison; the keyword-BN running mean
averages such a bias, so it is held to 1e-3 abs.

Also: the configuration keys the port does not implement still raise by name.
"""
import dataclasses
import operator
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speechclip_plus_tpu.config import load_config as jax_load_config
from speechclip_plus_tpu.models.clip import ClipConfig as JClipConfig
from speechclip_plus_tpu.models.hubert import HubertConfig as JHubertConfig
from speechclip_plus_tpu.models.kwclip import KWClip as JKWClip
from speechclip_plus_tpu.models.kwclip import KWClipConfig as JKWClipConfig
from speechclip_plus_tpu.models.kwclip import init_kw_bn_from_token_embedding as jax_kw_bn_init
from speechclip_plus_tpu.optim.optimizer import build_optimizer_from_config as jax_build_opt
from speechclip_plus_tpu.tasks.builder import resolve_reduced_vocab as jax_vocab

from speechclip_plus_tpu_torch.checkpoint.from_jax import load_jax_variables
from speechclip_plus_tpu_torch.config import load_config
from speechclip_plus_tpu_torch.models.clip import ClipConfig
from speechclip_plus_tpu_torch.models.hubert import HubertConfig
from speechclip_plus_tpu_torch.models.kwclip import KWClip, KWClipConfig
from speechclip_plus_tpu_torch.models.mel_upstreams import MelUpstreamConfig
from speechclip_plus_tpu_torch.optim.optimizer import (
    build_optimizer_from_config,
    trainable_parameters,
)
from speechclip_plus_tpu_torch.parallel.train_step import create_train_state, make_train_step
from speechclip_plus_tpu_torch.tasks.builder import resolve_reduced_vocab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = [
    "config/speechclip_plus/base/parallel.yaml",
    "config/speechclip_plus/base/cascaded.yaml",
    "config/speechclip_plus/base/cascaded_plus.yaml",
    "config/speechclip_plus/base/hybrid.yaml",
    "config/speechclip_plus/base/hybrid_plus.yaml",
    "config/speechclip_plus/base/hybrid_plus_wavlm.yaml",
    "config/speechclip/base/cascaded.yaml",
    "config/speechclip/base/parallel.yaml",
]
BRANCH = {"parallel": "", "cascaded": "CascadedBranch", "cascaded_plus": "CascadedBranch_plus",
          "hybrid": "HybridBranch", "hybrid_plus": "HybridBranch_plus",
          "hybrid_plus_wavlm": "HybridBranch_plus"}
D = 32
TOL = dict(rtol=1e-4, atol=1e-5)
STEPS = 3


def _downscale(mc, clip_cls, hubert_cls, **tower):
    """Width-32 towers and branch, the YAML's wiring (either package's config);
    `tower` keys go to `HubertConfig.tiny`."""
    clip = clip_cls.tiny(text_width=D, embed_dim=D, vocab_size=mc.clip.vocab_size,
                         sot_id=mc.clip.sot_id, eot_id=mc.clip.eot_id)
    ta = lambda t: dataclasses.replace(t, d_model=D, nhead=1 if t.nhead == 1 else 4,
                                       dim_feedforward=64)
    cif = mc.cif
    if cif is not None:
        extra = {"cif_output_dim": D} if hasattr(cif, "cif_output_dim") else {}
        cif = dataclasses.replace(cif, encoder_embed_dim=D,
                                  max_feat_len=min(cif.max_feat_len, clip.context_length - 2),
                                  **extra)
    return dataclasses.replace(
        mc, audio=hubert_cls.tiny(d_model=D, **tower), clip=clip, parallel_ta=ta(mc.parallel_ta),
        cascaded_ta=ta(mc.cascaded_ta),
        head=dataclasses.replace(mc.head, d_model=D, text_dim=D), cif=cif)


def _configs(path, **tower):
    """(JAX yaml node, (JAX model config, cut), port yaml node, (port model
    config, cut)), fp32; `tower` keys go to the cut tower's config."""
    out = []
    for load, vocab_of, cfg_cls, clip_cls, hubert_cls in (
            (jax_load_config, jax_vocab, JKWClipConfig, JClipConfig, JHubertConfig),
            (load_config, resolve_reduced_vocab, KWClipConfig, ClipConfig, HubertConfig)):
        cfg = load(os.path.join(REPO, path))
        cfg.trainer.precision = 32
        cfg.audio_encoder.scheduler.warmup = 2  # full learning rate by the third step
        vocab = vocab_of(cfg)
        mc = cfg_cls.from_config(cfg, vocab_size=len(vocab), sot_id=int(vocab.sot_reduced),
                                 eot_id=int(vocab.eot_reduced))
        out += [cfg, (mc, _downscale(mc, clip_cls, hubert_cls, **tower))]
    return out


def _batch():
    rng = np.random.RandomState(5)
    lens = np.array([1600, 1200, 1450, 900, 1333, 1580], np.int64)
    wav = (0.3 * rng.randn(6, 1600)).astype(np.float32)
    wav[np.arange(1600)[None, :] >= lens[:, None]] = 0.0
    return {"wav": wav, "wav_len": lens, "id": np.array([4, 9, 2, 7, 4, 1]),
            "image": rng.randn(6, 32, 32, 3).astype(np.float32)}


def _jax_variables(jmodel, mcfg):
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    variables = jax.jit(lambda k, b: jmodel.init({"params": k}, b, training=False))(
        jax.random.PRNGKey(0), batch)
    variables = jax.tree_util.tree_map(np.array, dict(variables))
    if "transformer" not in variables["params"]["clip"]["text"]:
        # a parallel-only model never runs the text tower, so flax creates no
        # parameters for it; the port's frozen CLIP has both towers
        text = jax.jit(lambda k, t: jmodel.init({"params": k}, t, method=JKWClip.forward_text))(
            jax.random.PRNGKey(1), jnp.zeros((1, mcfg.clip.context_length), jnp.int32))
        variables["params"]["clip"]["text"] = jax.tree_util.tree_map(
            np.array, dict(text["params"]["clip"]["text"]))
    params = jax_kw_bn_init(
        variables["params"], variables["params"]["clip"]["text"]["token_embedding"]["embedding"],
        mcfg)
    if mcfg.cif is not None and mcfg.has_cascaded:
        # a low alpha bias keeps CIF below max_feat_len (as in test_torch_slice.py)
        params["cascaded_branch"]["downsampling"]["weight_proj"]["bias"] = np.full(
            1, -5.0, np.float32)
    variables["params"] = jax.tree_util.tree_map(np.asarray, params)
    variables.setdefault("batch_stats", {})
    return variables


def _jax_steps(cfg, model, variables, batch, n):
    tx = jax_build_opt(variables["params"], model.cfg, cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params, stats, step):
        p = dict(params)
        for root in ("audio_encoder", "clip"):  # frozen towers
            p[root] = jax.lax.stop_gradient(params[root])
        v = {"params": p, "batch_stats": stats}
        (loss_feats, _, _), new_vars = model.apply(
            v, jbatch, training=True, deterministic=True, global_step=step,
            mutable=["batch_stats"])
        losses = model.apply(v, loss_feats, method=JKWClip.compute_loss)
        return losses["loss"], (losses, new_vars.get("batch_stats", {}))

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    params, stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)
    losses_seen, first_grads = [], None
    for step in range(n):
        (_, (losses, stats)), grads = grad_fn(params, stats, step)
        losses_seen.append({k: float(v) for k, v in losses.items()})
        if first_grads is None:
            first_grads = jax.tree_util.tree_map(np.asarray, grads)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    final = {"params": jax.tree_util.tree_map(np.asarray, params),
             "batch_stats": jax.tree_util.tree_map(np.asarray, stats)}
    return losses_seen, first_grads, final


@pytest.mark.parametrize("path", YAMLS, ids=lambda p: p[len("config/"):-len(".yaml")])
def test_family_builds_and_matches_jax(path):
    jcfg, (jfull, jsmall), cfg, (full, small) = _configs(path)
    family = os.path.basename(path)[:-len(".yaml")]
    # the YAML's wiring reached the port's typed config as it reached JAX's
    assert full.branch_type == jfull.branch_type == BRANCH[family]
    assert full.cascaded_objective_weight == jfull.cascaded_objective_weight
    assert full.parallel_objective_weight == jfull.parallel_objective_weight
    assert (full.cif is None) == (jfull.cif is None)
    active = full.cascaded_ta if full.has_cascaded else full.parallel_ta
    jactive = jfull.cascaded_ta if jfull.has_cascaded else jfull.parallel_ta
    assert (active.type, active.nhead, active.d_model) == (jactive.type, jactive.nhead, 768)
    assert full.audio.rel_pos_bias == ("wavlm" in family)
    assert full.retrieval_audio_feat_src == jfull.retrieval_audio_feat_src
    check_small_family(jcfg, jsmall, cfg, small, family)


def check_small_family(jcfg, jsmall, cfg, small, family, jit_encode=False):
    """The cut model of one family in both packages, the same weights:
    `encode_speech` (JAX's under `jax.jit` with `jit_encode`, which compiles
    a recurrent tower once instead of op by op) and STEPS training steps
    with dropout off."""
    jmodel = JKWClip(jsmall)
    variables = _jax_variables(jmodel, jsmall)
    model = KWClip(small).eval()
    load_jax_variables(model, variables)  # strict both ways
    assert all(p.dtype == torch.float32 for _, p in trainable_parameters(model))

    # encode_speech: the features the family has, None where JAX has None
    batch = _batch()
    encode = lambda v, w, n: jmodel.apply(v, w, n, method=JKWClip.encode_speech)
    want = (jax.jit(encode) if jit_encode else encode)(
        variables, jnp.asarray(batch["wav"]), jnp.asarray(batch["wav_len"]))
    with torch.inference_mode():
        got = model.encode_speech(torch.from_numpy(batch["wav"]),
                                  torch.from_numpy(batch["wav_len"]))
    for key in ("parallel_audio_feat", "cascaded_audio_feat", "keywords"):
        assert (got[key] is None) == (want[key] is None), key
        if got[key] is not None:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0,
                                       atol=1e-5, err_msg=key)
    assert (got["parallel_audio_feat"] is not None) == (family not in ("cascaded",
                                                                       "cascaded_plus"))
    if got["vq_results"] is not None:
        np.testing.assert_array_equal(got["vq_results"]["targets"].numpy(),
                                      np.asarray(want["vq_results"]["targets"]))
    if got["dsample_results"] is not None:
        lens = got["dsample_results"]["dsample_feats_length"].numpy()
        np.testing.assert_array_equal(
            lens, np.asarray(want["dsample_results"]["dsample_feats_length"]))
        assert lens.max() < small.cif.max_feat_len

    # three training steps, dropout off
    jlosses, jgrads, jfinal = _jax_steps(jcfg, jmodel, variables, batch, STEPS)
    optimizer = build_optimizer_from_config(model, cfg)
    state = create_train_state(optimizer)
    # the YAML's accumulation (2 in the large family), as JAX's optax.MultiSteps
    step_fn = make_train_step(model, optimizer,
                              int(getattr(cfg.trainer, "accumulate_grad_batches", 1) or 1))
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    names = [n for n, _ in trainable_parameters(model)]
    grads = {}
    hooks = [p.register_hook(lambda g, n=n: grads.__setitem__(n, g.clone()))
             for n, p in trainable_parameters(model)]
    for step in range(STEPS):
        metrics = step_fn(state, tbatch, None)
        for h in hooks:
            h.remove()
        hooks = []
        assert set(jlosses[step]) == {k[len("train_"):] for k in metrics
                                      if k.endswith("loss")}, step
        for key, value in jlosses[step].items():
            np.testing.assert_allclose(float(metrics[f"train_{key}"]), value, **TOL,
                                       err_msg=f"step {step}: {key}")
    template = KWClip(small)
    load_jax_variables(template, {"params": jgrads, "batch_stats": variables["batch_stats"]})
    jgrad = dict(template.named_parameters())
    assert len(grads) == len(names) >= 10
    gmax = max(float(jgrad[n].detach().abs().max()) for n in names)
    real = {}
    for n in names:
        a, b = grads[n].numpy(), jgrad[n].detach().numpy()
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5 + 1e-4 * gmax,
                                   err_msg=f"gradient {n}")
        real[n] = (np.abs(a) > 1e-3 * gmax) | (np.abs(b) > 1e-3 * gmax)
    load_jax_variables(template, jfinal)
    want_state = template.state_dict()
    compared = 0
    for n, t in model.state_dict().items():
        a, b = t.numpy(), want_state[n].numpy()
        if n in real:
            compared += int(real[n].sum())
            np.testing.assert_allclose(a[real[n]], b[real[n]], **TOL, err_msg=f"parameter {n}")
        elif n.endswith("running_mean"):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-3, err_msg=n)
        else:
            np.testing.assert_allclose(a, b, **TOL, err_msg=n)
    assert compared > 1000


def _tiny():
    return load_config(os.path.join(REPO, "config", "dev", "tiny.yaml"))


def _jax_tiny_named(name):
    cfg = jax_load_config(os.path.join(REPO, "config", "dev", "tiny.yaml"))
    cfg.audio_encoder.tiny = False
    cfg.audio_encoder.name = name
    return cfg


def _set(cfg, dotted, value):
    node = cfg
    *parents, leaf = dotted.split(".")
    for key in parents:
        node = getattr(node, key)
    setattr(node, leaf, value)


# a ported key's case gives the typed field (a dotted path of KWClipConfig)
# that must hold the value, and `_TYPED` the value's typed form where it differs
_TYPED = {"learnable=0.1": "learnable", "(2, 0.5, 0.999995)": (2.0, 0.5, 0.999995)}


@pytest.mark.parametrize("key,value,error,match", [
    # the VQ variants, trainable towers, LayerDrop, SupCon and the CIF variants
    # build since the training variants were ported
    ("model_settings.cascaded_branch.vq.args.use_gumbel", True, None, "head.vq.use_gumbel"),
    ("model_settings.cascaded_branch.vq.args.hard", False, None, "head.vq.hard"),
    ("model_settings.cascaded_branch.vq.args.temp", "learnable=0.1", None, "head.vq.temp_type"),
    ("model_settings.cascaded_branch.vq.args.temp", "(2, 0.5, 0.999995)", None,
     "head.vq.temp_schedule"),
    ("model_settings.cascaded_branch.vq.args.fused_st", False, None, "head.vq.fused_st"),
    ("clip.name", "ViT-L/14", None, "L/14"),  # builds since the large family was ported
    ("clip.text_encoder_trainable", True, None, "text_encoder_trainable"),
    ("clip.image_encoder_trainable", True, None, "image_encoder_trainable"),
    ("audio_encoder.trainable", True, None, "audio_trainable"),
    ("audio_encoder.layer_drop", 0.05, None, "audio.layer_drop"),
    # the audio feature's keys build since the fixed-K large family was ported
    ("audio_encoder.feat_select_idx", "last_hidden_state", None, "feat_select_idx"),
    ("audio_encoder.feat_select_idx", "mean_pool", NotImplementedError, "feat_select_idx"),
    ("audio_encoder.normalize_hiddenstates", True, None, "normalize_hiddenstates"),
    ("audio_encoder.normalize_type", "method3", NotImplementedError, "normalize_type"),
    ("cl_loss.type", "SupConLoss", None, "cl_loss.type"),
    ("model_settings.cascaded_branch.downsampling.cif.using_gt_len", True, None,
     "using_gt_len"),
    ("model_settings.cascaded_branch.downsampling.cif.produce_weight_type", "dense", None,
     "cif.produce_weight_type"),
    ("model_settings.fused_attention_vjp", False, None, "fused_attention_vjp"),
    ("model_settings.cascaded_branch.type", "KW_ConformerBranch", NotImplementedError,
     "cascaded_branch.type"),
    ("model_settings.cascaded_branch.transformer_args.type", "Conformer", NotImplementedError,
     "branch transformer"),
    ("clip.text_remat", "half", ValueError, "text_remat_mode"),
])
def test_unsupported_keys_raise_by_name(key, value, error, match):
    cfg = _tiny()
    _set(cfg, key, value)
    if key == "clip.name":
        cfg.clip.tiny = False
    if error is None and key != "clip.name":  # ported: the typed config, a build
        mc = KWClipConfig.from_config(cfg)
        assert operator.attrgetter(match)(mc) == _TYPED.get(value, value)
        KWClip(mc)
        return
    if error is None:  # a key that is ported now: its typed config, not a full-width build
        clip = KWClipConfig.from_config(cfg).clip
        want = ClipConfig.vit_l14()
        assert match in value and all(
            getattr(clip, f) == getattr(want, f) for f in (
                "embed_dim", "vision_width", "vision_layers", "vision_heads",
                "vision_patch_size", "text_width", "text_heads", "text_layers"))
        return
    with pytest.raises(error, match=match):
        KWClip(KWClipConfig.from_config(cfg))


def test_text_vjp_knob_needs_a_frozen_text_tower():
    cfg = _tiny()
    cfg.clip.text_fused_attention_vjp = True
    assert KWClipConfig.from_config(cfg).clip.text_fused_attention_vjp
    cfg.clip.text_encoder_trainable = True
    with pytest.raises(ValueError, match="frozen text tower"):
        KWClipConfig.from_config(cfg)


@pytest.mark.parametrize("name", ["data2vec_large", "wavlm_large", "apc", "hubert_large_ll60k",
                                  "pase_plus"])
def test_upstreams_left_for_later_raise(name):
    """An upstream outside both families (pase_plus) raises by name; the large
    towers and the mel upstreams (apc) resolve since they were ported, each
    as its preset and as JAX resolves the name."""
    cfg = _tiny()
    cfg.audio_encoder.tiny = False
    cfg.audio_encoder.name = name
    preset = {"data2vec_large": HubertConfig.data2vec_large, "wavlm_large":
              HubertConfig.wavlm_large, "hubert_large_ll60k": HubertConfig.large}.get(name)
    if name == "pase_plus":
        with pytest.raises(NotImplementedError, match="pase_plus"):
            KWClipConfig.from_config(cfg)
        return
    if preset is None:  # a mel upstream
        audio = KWClipConfig.from_config(cfg).audio
        want = JKWClipConfig.from_config(_jax_tiny_named(name)).audio
        assert audio == MelUpstreamConfig.from_upstream_name(name)
        assert type(want).__name__ == "MelUpstreamConfig"
        for field in ("kind", "arch", "d_model", "n_layers", "n_heads", "ffn_dim", "dropout"):
            assert getattr(audio, field) == getattr(want, field), field
        return
    audio = KWClipConfig.from_config(cfg).audio
    assert audio == preset()
    want = JHubertConfig.from_upstream_name(name)
    for field in ("extractor_mode", "conv_bias", "d_model", "n_layers", "n_heads", "ffn_dim",
                  "layer_norm_first", "pos_conv_depth", "rel_pos_bias"):
        assert getattr(audio, field) == getattr(want, field), field
