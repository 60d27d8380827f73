"""The port's analytic FLOP count (`speechclip_plus_tpu_torch/utils/flops.py`)
against the JAX package's (`speechclip_plus_tpu/utils/flops.py`), on the CPU.

Configuration building only, no full-width model: every YAML under `config/`
goes through both packages' `KWClipConfig.from_config`, and each component
and the total must agree at 1e-12 relative, with cached and live images, at
(B, wav) = (8, 32000) and (128, 102400), except where the JAX count differs
from what the model runs (ROADMAP C). Those deviations are pinned here with
their deltas, and each is tied to the port's model: the branch's sequence to
the length its self-attention sees at width 32, the subset policy's
multipliers to the trainable set the model builds.

Also mirrored from `tests/test_flops.py`: the hand values, the cached image,
the x1 / x2 / x3 multipliers and linearity in B.
"""
import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from speechclip_plus_tpu.config import load_config as jax_load_config
from speechclip_plus_tpu.models.kwclip import KWClipConfig as JKWClipConfig
from speechclip_plus_tpu.utils import flops as jflops

from speechclip_plus_tpu_torch.config import load_config
from speechclip_plus_tpu_torch.models.clip import ClipConfig
from speechclip_plus_tpu_torch.models.hubert import HubertConfig
from speechclip_plus_tpu_torch.models.kwclip import KWClip, KWClipConfig
from speechclip_plus_tpu_torch.utils.flops import (_transformer_flops, audio_layer_multipliers,
                                                   branch_sequence, conv_out_len,
                                                   train_step_flops)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(os.path.relpath(p, REPO) for p in glob.glob(
    os.path.join(REPO, "config", "**", "*.yaml"), recursive=True))
SHAPES = [(8, 32000), (128, 102400)]
HYBRID_PLUS = "config/speechclip_plus/base/hybrid_plus.yaml"
# the families whose branch the JAX count runs one keyword-CLS row too long
# (cascaded: frames + K, not frames + 1 + K) or one CLS row too long
# (cascaded+: frames, not frames + 1)
SHORTER_BRANCH = {"CascadedBranch": 1, "CascadedBranch_plus": 1}
# the mel upstreams, base YAMLs with keys overridden in memory (chip_smoke.py's path O)
MEL = {
    "mockingjay hybrid+": (HYBRID_PLUS, {"audio_encoder.name": "mockingjay"}),
    "apc parallel": ("config/speechclip_plus/base/parallel.yaml", {
        "audio_encoder.name": "apc",
        "model_settings.parallel_branch.transformer_args.d_model": 512}),
    "tera cascaded+": ("config/speechclip_plus/base/cascaded_plus.yaml",
                       {"audio_encoder.name": "tera"}),
}


def _set(cfg, overrides):
    for key, value in overrides.items():
        node, *path, last = [cfg] + key.split(".")
        for name in path:
            node = getattr(node, name)
        setattr(node, last, value)
    return cfg


def _pair(path, overrides=None):
    """(JAX KWClipConfig, port KWClipConfig) of one YAML."""
    out = []
    for load, cls in ((jax_load_config, JKWClipConfig), (load_config, KWClipConfig)):
        out.append(cls.from_config(_set(load(os.path.join(REPO, path)), overrides or {})))
    return out


def _branch_delta(mc, B, frames):
    """JAX's branch count minus the port's where JAX counts a longer sequence."""
    ta = mc.cascaded_ta
    ffn = ta.type == "TransformerEncoder"
    seq = branch_sequence(mc, frames)
    jax_seq = frames + 1 + (0 if mc.branch_type.endswith("_plus") else mc.head.keyword_num)
    assert jax_seq - seq == SHORTER_BRANCH[mc.branch_type]
    return 3.0 * (_transformer_flops(B * jax_seq, ta.d_model, ta.dim_feedforward, ta.n_layers,
                                     jax_seq, has_ffn=ffn)
                  - _transformer_flops(B * seq, ta.d_model, ta.dim_feedforward, ta.n_layers,
                                       seq, has_ffn=ffn))


def _close(a, b, rtol=1e-12):
    return abs(a - b) <= rtol * max(abs(a), abs(b))


def _expected_port(jmc, pmc, B, wav, cached):
    """JAX's count with the pinned deviations applied: what the port must give."""
    want = dict(jflops.train_step_flops(jmc, B, wav, cached_image=cached))
    frames = conv_out_len(wav, pmc.audio.conv_layers) if hasattr(pmc.audio, "conv_layers") \
        else (wav - pmc.audio.win) // pmc.audio.hop + 1
    if pmc.branch_type in SHORTER_BRANCH:
        want["branch_self_att"] -= _branch_delta(pmc, B, frames)
    if getattr(pmc.audio, "pos_conv_depth", 1) > 1:
        want["hubert_pos_conv"] *= pmc.audio.pos_conv_depth
    want["total"] = sum(v for k, v in want.items() if k != "total")
    return want


# -- the port against JAX --------------------------------------------------


@pytest.mark.parametrize("cached", [False, True], ids=["live", "cached"])
@pytest.mark.parametrize("B,wav", SHAPES, ids=[f"{b}x{w}" for b, w in SHAPES])
@pytest.mark.parametrize("path", YAMLS)
def test_matches_jax_per_component(path, B, wav, cached):
    jmc, pmc = _pair(path)
    got = train_step_flops(pmc, B, wav, cached_image=cached)
    want = _expected_port(jmc, pmc, B, wav, cached)
    assert sorted(got) == sorted(want), path
    bad = {k: (got[k], want[k]) for k in got if not _close(got[k], want[k])}
    assert not bad, (path, bad)
    assert _close(got["total"], sum(v for k, v in got.items() if k != "total"))
    deviates = pmc.branch_type in SHORTER_BRANCH or pmc.audio.pos_conv_depth > 1
    raw = jflops.train_step_flops(jmc, B, wav, cached_image=cached)
    assert _close(got["total"], raw["total"]) != deviates, path


@pytest.mark.parametrize("name", sorted(MEL))
def test_mel_upstreams_match_jax(name):
    jmc, pmc = _pair(*MEL[name])
    for B, wav in SHAPES:
        for cached in (False, True):
            got = train_step_flops(pmc, B, wav, cached_image=cached)
            want = _expected_port(jmc, pmc, B, wav, cached)
            assert "upstream_stack" in got and sorted(got) == sorted(want)
            assert all(_close(got[k], want[k]) for k in got), name


# -- the pinned deviations -------------------------------------------------


def test_branch_sequence_deviation_delta():
    """cascaded at (128, 102400): the port counts 327 rows (319 frames + 8
    keyword CLS), JAX 328; the delta is one row of the one-layer, no-FFN
    branch at d=768, three times: 3 (8 B d^2 + 4 B d (2T + 1)) with T=327.
    cascaded+: 319 rows against JAX's 320."""
    B, d = 128, 768
    for path, rows, T in (("config/speechclip_plus/base/cascaded.yaml", 327, 327),
                          ("config/speechclip_plus/base/cascaded_plus.yaml", 319, 319)):
        jmc, pmc = _pair(path)
        assert branch_sequence(pmc, 319) == rows
        got = train_step_flops(pmc, B, 102400)["branch_self_att"]
        want = jflops.train_step_flops(jmc, B, 102400)["branch_self_att"]
        assert want - got == 3 * (8 * B * d * d + 4 * B * d * (2 * T + 1))
    assert 2584608768 == 3 * (8 * B * d * d + 4 * B * d * (2 * 327 + 1))
    for path, rows in (("config/speechclip_plus/base/hybrid.yaml", 328), (HYBRID_PLUS, 320),
                       ("config/speechclip_plus/base/parallel.yaml", None)):
        jmc, pmc = _pair(path)
        if rows is not None:
            assert branch_sequence(pmc, 319) == rows
        got, want = train_step_flops(pmc, B, 102400), jflops.train_step_flops(jmc, B, 102400)
        assert sorted(got) == sorted(want) and all(_close(got[k], want[k]) for k in got)


def _tiny(mc, **tower):
    """`mc`'s wiring (branch type, transformer type, CIF, objective weights)
    at width 32 with the two-layer tiny tower."""
    D = 32
    clip = ClipConfig.tiny(text_width=D, embed_dim=D)
    ta = lambda t: dataclasses.replace(t, d_model=D, nhead=1 if t.nhead == 1 else 4,
                                       dim_feedforward=64)
    cif = mc.cif if mc.cif is None else dataclasses.replace(
        mc.cif, encoder_embed_dim=D, cif_output_dim=D,
        max_feat_len=min(mc.cif.max_feat_len, clip.context_length - 2))
    return dataclasses.replace(mc, audio=HubertConfig.tiny(d_model=D, **tower), clip=clip,
                               parallel_ta=ta(mc.parallel_ta), cascaded_ta=ta(mc.cascaded_ta),
                               head=dataclasses.replace(mc.head, d_model=D, text_dim=D),
                               cif=cif)


@pytest.mark.parametrize("family", ["cascaded", "cascaded_plus", "hybrid", "hybrid_plus",
                                    "parallel"])
def test_branch_sequence_is_what_the_model_runs(family):
    """The sequence `branch_sequence` counts is the one the port's branch
    self-attention is called with, in a training forward at width 32."""
    _, pmc = _pair(f"config/speechclip_plus/base/{family}.yaml")
    mc = _tiny(pmc)
    torch.manual_seed(0)
    model = KWClip(mc)
    branch = model.cascaded_branch or model.parallel_branch
    seen = []
    branch.self_att.register_forward_pre_hook(lambda mod, args: seen.append(args[0].shape[1]))
    rng = np.random.RandomState(0)
    b, n = 4, 1600
    batch = {"wav": torch.from_numpy((0.3 * rng.randn(b, n)).astype(np.float32)),
             "wav_len": torch.full((b,), n), "id": torch.arange(b),
             "image": torch.from_numpy(rng.randn(b, 32, 32, 3).astype(np.float32))}
    model.train()
    model(batch, training=True, global_step=0)
    frames = conv_out_len(n, mc.audio.conv_layers)
    want = branch_sequence(mc, frames) if mc.has_cascaded else frames + 1
    assert seen and set(seen) == {want}, (family, seen, frames)


def test_parallel_branch_only_without_cascaded():
    """A non-hybrid cascaded branch beside a parallel objective: the model
    builds no parallel branch, so the port counts none (JAX counts one)."""
    jmc, pmc = _pair("config/speechclip_plus/base/cascaded.yaml")
    jmc = dataclasses.replace(jmc, parallel_objective_weight=1.0)
    pmc = dataclasses.replace(pmc, parallel_objective_weight=1.0)
    assert KWClip(_tiny(pmc)).parallel_branch is None
    got = train_step_flops(pmc, 128, 102400)
    want = jflops.train_step_flops(jmc, 128, 102400)
    assert "parallel_self_att" in want and "parallel_self_att" not in got
    assert _close(want["total"] - got["total"],
                  want["parallel_self_att"] + _branch_delta(pmc, 128, 319))


def test_data2vec_positional_convolution_depth():
    """data2vec's five positional convolutions (k=19, 16 groups): 5 x JAX's one."""
    jmc, pmc = _pair("config/speechclip_plus/base/hybrid_plus_data2vec.yaml")
    assert (pmc.audio.pos_conv_depth, pmc.audio.conv_pos) == (5, 19)
    got = train_step_flops(pmc, 128, 102400)["hubert_pos_conv"]
    want = jflops.train_step_flops(jmc, 128, 102400)["hubert_pos_conv"]
    assert got == 5 * want == 5 * 2.0 * 128 * 319 * 768 * 48 * 19


@pytest.mark.parametrize("policy", ["unfreeze_layers", "reinit_layers"])
def test_subset_policy_multipliers(policy):
    """`unfreeze_layers: [10, 11]` on the post-norm base tower: the frontend
    and positional convolution 1x (JAX 3x); layers 10 and 11 3x, layers 0-9
    2x (the trainable encoder LayerNorm sits ahead of layer 0): 26 of JAX's
    36 layer-forwards. On the pre-norm large tower, [20, 23]: layers 0-19
    1x, 20 and 23 3x, 21 and 22 2x: 30 of JAX's 72."""
    for path, layers, mults in (
            (HYBRID_PLUS, [10, 11], [2.0] * 10 + [3.0] * 2),
            ("config/speechclip_plus/large/flickr/hybrid_plus.yaml", [20, 23],
             [1.0] * 20 + [3.0, 2.0, 2.0, 3.0])):
        jmc, pmc = _pair(path, {f"audio_encoder.{policy}": layers})
        assert jmc.audio_trainable and pmc.audio_trainable
        assert list(audio_layer_multipliers(pmc)) == mults
        got = train_step_flops(pmc, 128, 102400)
        want = jflops.train_step_flops(jmc, 128, 102400)
        assert _close(got["hubert_stack"], want["hubert_stack"] * sum(mults) / (3 * len(mults)))
        for key in ("hubert_conv_frontend", "hubert_pos_conv"):
            assert _close(got[key], want[key] / 3)
        rest = [k for k in got if k.startswith(("clip", "branch", "kw", "keyword", "cif", "loss"))]
        assert all(got[k] == want[k] for k in rest)


def test_subset_multipliers_follow_the_trainable_set():
    """The tiny tower (2 post-norm layers) with `unfreeze_layers: [1]`: layer 1
    and `encoder_layer_norm` train, layer 0 does not; so layer 0 passes the
    gradient on (2x) and layer 1 trains (3x). Pre-norm, layer 0 takes none."""
    _, pmc = _pair(HYBRID_PLUS)
    for pre_norm, mults in ((False, [2.0, 3.0]), (True, [1.0, 3.0])):
        mc = dataclasses.replace(_tiny(pmc, layer_norm_first=pre_norm, fused_attention_block=False),
                                 audio_trainable=True, unfreeze_layers=(1,))
        assert list(audio_layer_multipliers(mc)) == mults
        tower = KWClip(mc).audio_encoder
        trains = lambda mod: {p.requires_grad for p in mod.parameters()}
        assert trains(tower.layers[0]) == {False} and trains(tower.layers[1]) == {True}
        assert trains(tower.encoder_layer_norm) == {not pre_norm}
        assert trains(tower.feature_extractor) == {False}


def test_trainable_text_tower_trains_the_codebook():
    """A trainable text tower trains the token table the keyword head scores
    against: the head counts 3x (JAX 2x)."""
    jmc, pmc = _pair(HYBRID_PLUS, {"clip.text_encoder_trainable": True,
                                   "model_settings.fused_score_kernel": False})
    got = train_step_flops(pmc, 128, 102400)
    want = jflops.train_step_flops(jmc, 128, 102400)
    assert _close(got["keyword_head"], 1.5 * want["keyword_head"])
    assert _close(got["clip_text_tower"], want["clip_text_tower"])


# -- tests/test_flops.py, mirrored ----------------------------------------


def test_conv_out_len_matches_reference_downsampling():
    _, pmc = _pair(HYBRID_PLUS)
    assert conv_out_len(102400, pmc.audio.conv_layers) == 319
    assert conv_out_len(320 * 100 + 80, pmc.audio.conv_layers) == 100


def test_transformer_flops_hand_value():
    # qkv 2*10*4*12=960, out 2*10*4*4=320, attn 2*2*10*10*4=1600, ffn 2*2*10*4*8=1280
    assert _transformer_flops(10, 4, 8, 1, 10) == 4160
    assert _transformer_flops(10, 4, 8, 1, 10, has_ffn=False) == 2880


def test_cached_image_drops_only_image_tower():
    _, pmc = _pair(HYBRID_PLUS)
    live = train_step_flops(pmc, 64, 102400)
    cached = train_step_flops(pmc, 64, 102400, cached_image=True)
    assert "clip_image_tower" in live and "clip_image_tower" not in cached
    assert abs((live["total"] - cached["total"]) - live["clip_image_tower"]) \
        < 1e-6 * live["total"]


def test_multipliers():
    """x1 for a frozen tower, x2 for the frozen text tower's input gradients,
    x3 for a trainable tower and the branch."""
    _, pmc = _pair(HYBRID_PLUS)
    a, c, ta = pmc.audio, pmc.clip, pmc.cascaded_ta
    B, T = 64, 319
    f = train_step_flops(pmc, B, 102400)
    assert _close(f["hubert_stack"], _transformer_flops(B * T, a.d_model, a.ffn_dim, a.n_layers, T))
    text = (_transformer_flops(B * 77, c.text_width, 4 * c.text_width, c.text_layers, 77)
            + 2.0 * B * c.text_width * c.embed_dim)
    assert _close(f["clip_text_tower"], 2 * text)
    assert _close(f["branch_self_att"], 3 * _transformer_flops(
        B * (T + 1), ta.d_model, ta.dim_feedforward, ta.n_layers, T + 1, has_ffn=False))
    trainable = train_step_flops(dataclasses.replace(
        pmc, audio_trainable=True, image_encoder_trainable=True, text_encoder_trainable=True),
        B, 102400)
    for key in ("hubert_stack", "hubert_conv_frontend", "hubert_pos_conv", "clip_image_tower"):
        assert _close(trainable[key], 3 * f[key]), key
    assert _close(trainable["clip_text_tower"], 1.5 * f["clip_text_tower"])


def test_scales_linearly_in_batch():
    _, pmc = _pair(HYBRID_PLUS)
    f1 = train_step_flops(pmc, 64, 102400)
    f2 = train_step_flops(pmc, 128, 102400)
    for key in f1:
        if key not in ("total", "loss_similarity"):  # O(B^2), negligible
            assert _close(f2[key], 2 * f1[key]), key
        assert _close(f2["loss_similarity"], 4 * f1["loss_similarity"])
    assert abs(f2["total"] - 2 * f1["total"]) < 0.01 * f2["total"]


def test_every_yaml_counts():
    for path in YAMLS:
        _, pmc = _pair(path)
        assert train_step_flops(pmc, 8, 32000)["total"] > 0, path


def test_flops_module_imports_neither_torch_nor_jax():
    import ast

    import speechclip_plus_tpu_torch.utils.flops as mod

    tree = ast.parse(open(mod.__file__).read())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {(n.module or "").split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0}
    assert names <= {"__future__", "typing"}, names
