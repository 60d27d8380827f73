"""The trainable towers of the PyTorch port against the JAX package, on the CPU.

`config/dev/tiny.yaml` in fp32 with every tower trainable (the acoustic
tower, the ViT, the text tower and its token table) set in memory, the JAX
variables moved into the port through `checkpoint/from_jax.py`, dropout
off: the gradient of one training step's loss with respect to every tensor
the port trains (JAX: `jax.value_and_grad` with the frozen roots
stop-gradient'd, as its train step does), and the parameters after one Adam
step with clip 4 under the subset policies (JAX: the masked optax chain of
`build_optimizer_from_config`). Also LayerDrop, `remat` with dropout on, the
route rules of `KWClipConfig.from_config` and `reinit_hubert_layers`.

Tolerance for gradients: rtol 1e-4 and an absolute 5e-5 x the largest
|gradient| of the tensor (at least 5e-6): fp32 on both sides through the conv
frontend or the ViT, two tower layers, the branch, CIF and the text tower,
summed in another order; the CIF quantity loss is O(100), so gradients near
the frontend reach O(10). For parameters after an update: rtol 1e-4, atol
1e-5, as `test_torch_train_step.py`, with the slices that hold rounding noise
left out (`rounding_noise`).

`setup_pair`, `port_grads`, `jax_grads` and `assert_close` are shared with
`test_torch_vq_variants.py` and `test_torch_supcon_cif.py`.
"""
import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speechclip_plus_tpu.config import load_config as jax_load_config
from speechclip_plus_tpu.models.kwclip import KWClip as JKWClip
from speechclip_plus_tpu.models.kwclip import KWClipConfig as JKWClipConfig
from speechclip_plus_tpu.models.kwclip import init_kw_bn_from_token_embedding as jax_kw_bn_init
from speechclip_plus_tpu.optim.optimizer import build_optimizer_from_config as jax_build_opt
from speechclip_plus_tpu.tasks.builder import reinit_hubert_layers as jax_reinit
from speechclip_plus_tpu.tasks.builder import resolve_reduced_vocab as jax_vocab

from speechclip_plus_tpu_torch.checkpoint.from_jax import load_hubert, load_jax_variables
from speechclip_plus_tpu_torch.config import load_config
from speechclip_plus_tpu_torch.models.hubert import HubertConfig, HubertModel
from speechclip_plus_tpu_torch.models.kwclip import KWClip, KWClipConfig
from speechclip_plus_tpu_torch.optim.optimizer import (build_optimizer_from_config,
                                                       trainable_parameters)
from speechclip_plus_tpu_torch.parallel.train_step import create_train_state, make_train_step
from speechclip_plus_tpu_torch.tasks.builder import (build_model_from_config, init_params,
                                                     reinit_hubert_layers)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "config", "dev", "tiny.yaml")
EOT = 49407  # the original-id EOT that `using_gt_len` looks for


def set_keys(cfg, keys):
    for dotted, value in keys.items():
        node = cfg
        *parents, leaf = dotted.split(".")
        for key in parents:
            node = getattr(node, key)
        setattr(node, leaf, value)
    return cfg


def setup_pair(keys):
    """(JAX cfg node, JAX model, variables, port model holding the same
    variables, port cfg node) for tiny.yaml with `keys` set."""
    cfg = set_keys(jax_load_config(TINY), keys)
    vocab = jax_vocab(cfg)
    mcfg = JKWClipConfig.from_config(cfg, vocab_size=len(vocab), sot_id=int(vocab.sot_reduced),
                                     eot_id=int(vocab.eot_reduced))
    model = JKWClip(mcfg)
    rng = np.random.RandomState(0)
    init_batch = {"wav": jnp.asarray(rng.randn(2, 3200).astype(np.float32)),
                  "wav_len": jnp.asarray([3200, 2880]),
                  "image": jnp.asarray(rng.randn(2, 32, 32, 3).astype(np.float32)),
                  "id": jnp.asarray([0, 1])}
    variables = jax.jit(lambda k, b: model.init({"params": k}, b, training=False))(
        jax.random.PRNGKey(0), init_batch)
    variables = jax.tree_util.tree_map(np.array, dict(variables))
    params = jax_kw_bn_init(
        variables["params"], variables["params"]["clip"]["text"]["token_embedding"]["embedding"],
        mcfg)
    # a low alpha bias keeps CIF below max_feat_len (as in test_torch_slice.py)
    ds = params["cascaded_branch"]["downsampling"]
    ds["weight_proj"]["bias"] = np.full(1, -6.0, np.float32)
    variables["params"] = jax.tree_util.tree_map(np.asarray, params)
    pcfg = set_keys(load_config(TINY), keys)
    port, _, _ = build_model_from_config(pcfg, device="cpu", seed=0)
    load_jax_variables(port, variables)
    return cfg, model, variables, port, pcfg


def make_batch(live=True, seed=5):
    """3 ragged waveforms, distinct ids, captions whose EOT (49407) sits at 4,
    2 and 3, and live images."""
    rng = np.random.RandomState(seed)
    lens = np.array([3200, 2400, 2900], np.int64)
    wav = (0.3 * rng.randn(3, 3200)).astype(np.float32)
    wav[np.arange(3200)[None, :] >= lens[:, None]] = 0.0
    text = np.zeros((3, 16), np.int64)
    for row, eot in enumerate((4, 2, 3)):
        text[row, 0], text[row, 1:eot], text[row, eot] = 62, 5 + row, EOT
    batch = {"wav": wav, "wav_len": lens, "id": np.array([4, 9, 2]), "text": text}
    if live:
        batch["image"] = rng.randn(3, 32, 32, 3).astype(np.float32)
    return batch


def jax_grads(model, variables, batch, step=0, rngs=None, deterministic=True):
    """(losses, gradient tree) of one JAX training step, the frozen roots
    stop-gradient'd as the JAX train step does; the losses also hold the
    step's `cif_target_len`."""
    c = model.cfg
    frozen = [r for r, on in (("audio_encoder", not c.audio_trainable),
                              ("clip", not (c.image_encoder_trainable
                                            or c.text_encoder_trainable))) if on]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        p = dict(params)
        for root in frozen:
            p[root] = jax.lax.stop_gradient(params[root])
        v = {"params": p, "batch_stats": variables["batch_stats"]}
        (loss_feats, _, _), _ = model.apply(v, jbatch, training=True,
                                            deterministic=deterministic,
                                            global_step=jnp.asarray(step),
                                            mutable=["batch_stats"], rngs=rngs or {})
        losses = model.apply(v, loss_feats, method=JKWClip.compute_loss)
        return losses["loss"], {**losses, "cif_target_len": loss_feats["cif_target_len"]}

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    return (jax.tree_util.tree_map(np.asarray, losses),
            jax.tree_util.tree_map(np.asarray, grads))


def in_port_layout(port, variables, tree):
    """{name: numpy} of a JAX params-shaped tree in the port's layout."""
    model = copy.deepcopy(port)
    load_jax_variables(model, {"params": tree, "batch_stats": variables["batch_stats"]})
    return {n: p.detach().numpy() for n, p in model.named_parameters()}


def port_grads(port, batch, step=0, generator=None):
    """(losses, {name: gradient}) of one port training step for every tensor
    the port trains."""
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss_feats, _, _ = port(tb, training=True, global_step=step, generator=generator)
    losses = port.compute_loss(loss_feats)
    named = trainable_parameters(port)
    grads = torch.autograd.grad(losses["loss"], [p for _, p in named], allow_unused=True)
    return ({k: float(v) for k, v in losses.items()},
            {n: (torch.zeros_like(p) if g is None else g).numpy()
             for (n, p), g in zip(named, grads)})


def assert_close(got, want, what, rtol=1e-4, atol=5e-5):
    """rtol, and atol x the largest |want| (at least 0.1 atol)."""
    scale = max(float(np.abs(want).max()) if np.size(want) else 0.0, 0.1)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale, err_msg=what)


def compare_grads(port, variables, jgrads, pgrads):
    """Every gradient within `assert_close`, but for the slices that hold
    rounding noise (`rounding_noise`): there both sides stay below 1e-4."""
    want = in_port_layout(port, variables, jgrads)
    noise = rounding_noise(port)
    for n, g in pgrads.items():
        w = want[n]
        if n in noise:
            sl = noise[n]
            assert max(float(np.abs(g[sl]).max()), float(np.abs(w[sl]).max())) < 1e-4, n
            keep = np.ones(g.shape[0], bool)
            keep[sl] = False
            g, w = g[keep], w[keep]
        assert_close(g, w, f"gradient {n}")


def rounding_noise(model):
    """{name: slice} of the tensors whose gradient is zero in exact arithmetic,
    so that both sides hold rounding noise there, which Adam scales to
    lr-sized steps: every attention's key bias (a shift of all the key scores
    of a query leaves its softmax unchanged) and the keyword projection's
    bias (batch-statistics BN subtracts the batch mean right after it). An
    update comparison leaves them out, as `test_torch_train_step.py` does."""
    out = {}
    for n, p in model.named_parameters():
        if n.endswith("in_proj_bias"):
            d = p.shape[0] // 3
            out[n] = slice(d, 2 * d)
        elif n == "cascaded_branch.head.linear_proj.bias":
            out[n] = slice(None)
    return out


def assert_update_close(model, want, what):
    noise = rounding_noise(model)
    for n, p in model.named_parameters():
        got, w = p.detach().numpy(), want[n]
        keep = np.ones(got.shape[0], bool) if got.ndim else True
        if n in noise:
            keep[noise[n]] = False
        np.testing.assert_allclose(got[keep], w[keep], rtol=1e-4, atol=1e-5,
                                   err_msg=f"{what}: {n}")


# ------------------------------------------------------------- fixtures ----

@pytest.fixture(scope="module")
def towers():
    """Every tower trainable: the acoustic tower (`audio_encoder.trainable`),
    the ViT and the text tower (fused_score_kernel then off); live images."""
    cfg, model, variables, port, pcfg = setup_pair({"audio_encoder.trainable": True,
                                                    "clip.text_encoder_trainable": True,
                                                    "clip.image_encoder_trainable": True})
    batch = make_batch()
    return cfg, model, variables, port, pcfg, batch, jax_grads(model, variables, batch)


# ---------------------------------------------------------------- tests ----

def test_trainable_tower_gradients_match_jax(towers):
    """The gradient of every tower tensor (the conv frontend, the ViT, the
    text tower and the token table, which is also the VQ codebook and takes
    both terms) and of every other trainable tensor."""
    _, model, variables, port, _, batch, (jlosses, jgrads) = towers
    assert not port.cfg.head.fused_score_kernel and not port.cfg.vision_fused_attention_block
    assert not port.clip.visual.transformer.blocks[0].attn.kernel
    assert not port.audio_encoder.cfg.fused_attention_block
    losses, pgrads = port_grads(port, batch)
    np.testing.assert_allclose(losses["loss"], float(jlosses["loss"]), rtol=1e-5)
    tower = [n for n in pgrads if n.startswith("audio_encoder.")]
    assert len(tower) == len(list(port.audio_encoder.parameters())) > 30
    assert sum(n.startswith("clip.") for n in pgrads) == len(list(port.clip.parameters()))
    for prefix in ("clip.visual.", "clip.text.transformer."):
        assert sum(n.startswith(prefix) for n in pgrads) > 10, prefix
    for name in ("audio_encoder.feature_extractor.conv_layers.0.weight",
                 "clip.text.token_embedding.weight", "clip.visual.conv1.weight"):
        assert np.abs(pgrads[name]).max() > 0, name
    compare_grads(port, variables, jgrads, pgrads)


@pytest.mark.parametrize("policy", ["unfreeze_layers", "reinit_layers"])
def test_subset_policy_update_matches_jax(towers, policy):
    """One Adam step with clip 4 under a subset policy: of the acoustic tower
    only layer 1 and the post-norm encoder LayerNorm move, as JAX's masked
    update moves them (the CLIP towers train here too)."""
    cfg, model, variables, template, _, batch, (_, jgrads) = towers
    keys = {"audio_encoder.trainable": False, f"audio_encoder.{policy}": [1],
            "clip.text_encoder_trainable": True, "clip.image_encoder_trainable": True}
    jmcfg = dataclasses.replace(model.cfg, audio_trainable=True, **{policy: (1,)})
    tx = jax_build_opt(variables["params"], jmcfg, cfg)
    updates, _ = jax.jit(tx.update)(jgrads, tx.init(variables["params"]), variables["params"])
    want = in_port_layout(template, variables,
                          optax.apply_updates(variables["params"], updates))

    pcfg = set_keys(load_config(TINY), keys)
    mc = KWClipConfig.from_config(pcfg, vocab_size=template.cfg.clip.vocab_size,
                                  sot_id=template.cfg.clip.sot_id, eot_id=template.cfg.clip.eot_id)
    assert mc.audio_trainable and getattr(mc, policy) == (1,)
    port = KWClip(mc)
    port.load_state_dict(template.state_dict())
    optimizer = build_optimizer_from_config(port, pcfg)
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    make_train_step(port, optimizer)(create_train_state(optimizer),
                                     {k: torch.from_numpy(np.array(v)) for k, v in batch.items()},
                                     None)
    moved = {n for n, p in port.named_parameters() if not torch.equal(p, before[n])}
    tower_moved = {n.split(".")[1] for n in moved if n.startswith("audio_encoder.")}
    assert tower_moved == {"layers", "encoder_layer_norm"}
    assert all(n.startswith(("audio_encoder.layers.1.", "audio_encoder.encoder_layer_norm"))
               for n in moved if n.startswith("audio_encoder."))
    assert_update_close(port, want, policy)


def test_trainable_towers_store_fp32_masters_under_bf16():
    cfg = set_keys(load_config(TINY), {"trainer.precision": "bf16",
                                       "audio_encoder.trainable": True,
                                       "clip.image_encoder_trainable": True})
    model, mc, _ = build_model_from_config(cfg, device="cpu", seed=0)
    assert mc.audio.dtype == torch.bfloat16
    for n, p in trainable_parameters(model):
        assert p.dtype == torch.float32, n
    assert model.clip.text.transformer.blocks[0].c_fc.weight.dtype == torch.bfloat16  # frozen
    optimizer = build_optimizer_from_config(model, cfg)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in make_batch().items()}
    metrics = make_train_step(model, optimizer)(create_train_state(optimizer), batch,
                                                torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())


def _tiny_tower(**kw):
    cfg = HubertConfig.tiny(dropout=0.0, attention_dropout=0.0, fused_attention_block=False, **kw)
    tower = HubertModel(cfg)
    init_params(tower, torch.Generator().manual_seed(0))
    return tower


def _wav(b=2, t=800, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, t, generator=g), torch.zeros(b, t, dtype=torch.bool)


def test_layer_drop_all_dropped_is_identity_and_eval_untouched():
    wav, pad = _wav()
    dropped, plain = _tiny_tower(layer_drop=1.0), _tiny_tower()
    w = torch.softmax(torch.randn(3, generator=torch.Generator().manual_seed(1)), 0)
    out = dropped(wav, pad, w, torch.Generator().manual_seed(3), return_hidden_states=True)
    for i in range(1, out["hidden_states"].shape[0]):
        assert torch.equal(out["hidden_states"][i], out["hidden_states"][0])
    ref = plain(wav, pad, w, return_hidden_states=True)
    ev = dropped(wav, pad, w, None, return_hidden_states=True)
    for key in ("x", "weighted_sum", "hidden_states"):
        assert torch.equal(ev[key], ref[key]), key
    assert not torch.equal(ref["x"], ref["hidden_states"][0])


def test_layer_drop_keeps_each_layer_at_its_rate():
    """p = 0.05: each layer of each step skipped on its own draw, the layers
    themselves stood in for; over 50 steps
    of 64 layers (3200 draws) the skip rate is within 4 standard deviations
    of 0.05 and the steps differ."""
    tower = _tiny_tower(layer_drop=0.05, n_layers=64, d_model=8, n_heads=2, ffn_dim=8,
                        conv_pos_groups=2)
    # every kept layer adds 1: a cheap stand-in that shows which ran
    tower._run_layer = lambda layer, x, *args: x + 1.0
    wav, pad = _wav(1, 64)
    g = torch.Generator().manual_seed(0)
    skipped, patterns = 0, set()
    with torch.no_grad():
        for _ in range(50):
            h = tower(wav, pad, None, g, return_hidden_states=True)["hidden_states"]
            same = [bool(torch.equal(h[i + 1], h[i])) for i in range(64)]
            skipped += sum(same)
            patterns.add(tuple(same))
    rate, sd = skipped / 3200, (0.05 * 0.95 / 3200) ** 0.5
    assert abs(rate - 0.05) <= 4 * sd, rate
    assert len(patterns) > 40


def test_remat_gradients_are_bit_identical_with_dropout_on():
    """`remat` recomputes each layer in the backward with the masks of the
    forward: the gradients equal the plain run's bit for bit, with the
    tower's dropouts and LayerDrop on, and the generator ends where the
    plain run's does."""
    results = []
    for remat in (False, True):
        cfg = HubertConfig.tiny(fused_attention_block=False, layer_drop=0.3, remat=remat)
        tower = HubertModel(cfg)
        init_params(tower, torch.Generator().manual_seed(0))
        wav, pad = _wav()
        w = torch.softmax(torch.zeros(3), 0)
        g = torch.Generator().manual_seed(7)
        out = tower(wav, pad, w, g)
        grads = torch.autograd.grad(out["weighted_sum"].pow(2).sum() + out["x"].sum(),
                                    list(tower.parameters()))
        results.append((out["weighted_sum"].detach(), grads, torch.rand(4, generator=g)))
    (a, ga, ra), (b, gb, rb) = results
    assert torch.equal(a, b) and torch.equal(ra, rb)
    assert all(torch.equal(x, y) for x, y in zip(ga, gb))
    assert any(float(x.abs().max()) > 0 for x in ga)


@pytest.mark.parametrize("keys,error,match", [
    ({"audio_encoder.trainable": True, "audio_encoder.fused_attention_block": True},
     ValueError, "frozen tower"),
    ({"audio_encoder.unfreeze_layers": [1], "audio_encoder.fused_attention": True},
     ValueError, "frozen tower"),
    ({"clip.image_encoder_trainable": True, "clip.fused_attention_block": True},
     ValueError, "frozen image tower"),
    ({"clip.text_encoder_trainable": True, "model_settings.fused_score_kernel": True},
     ValueError, "frozen text tower"),
    ({"audio_encoder.unfreeze_layers": [1], "audio_encoder.reinit_layers": [0]},
     ValueError, "mutually exclusive"),
    ({"audio_encoder.tiny": False, "audio_encoder.name": "apc",
      "audio_encoder.unfreeze_layers": [1]}, NotImplementedError, "mel upstream"),
])
def test_route_rules_raise(keys, error, match):
    with pytest.raises(error, match=match):
        KWClipConfig.from_config(set_keys(load_config(TINY), keys))


def test_route_rules_match_jax():
    """Each key's typed config: the routes the port and JAX take."""
    cases = [
        {"audio_encoder.trainable": True},
        {"audio_encoder.unfreeze_layers": [1], "audio_encoder.layer_drop": "original"},
        {"audio_encoder.reinit_layers": [0], "audio_encoder.remat": True},
        {"clip.image_encoder_trainable": True},
        {"clip.text_encoder_trainable": True},
        {"model_settings.fused_attention_vjp": False, "model_settings.fused_score_kernel": False},
        {"audio_encoder.trainable": True, "audio_encoder.frozen_dropout": False},
    ]
    for keys in cases:
        mc = KWClipConfig.from_config(set_keys(load_config(TINY), keys))
        jc = JKWClipConfig.from_config(set_keys(jax_load_config(TINY), keys))
        for f in ("audio_trainable", "image_encoder_trainable", "text_encoder_trainable",
                  "reinit_layers", "unfreeze_layers"):
            assert getattr(mc, f) == getattr(jc, f), (keys, f)
        for f in ("layer_drop", "remat", "dropout", "attention_dropout"):
            assert getattr(mc.audio, f) == getattr(jc.audio, f), (keys, f)
        # on the accelerator JAX turns these kernels on exactly where the port does
        assert mc.audio.fused_attention_block == (not jc.audio_trainable)
        assert mc.vision_fused_attention_block == (not jc.image_encoder_trainable)
        assert mc.head.fused_score_kernel == (
            not jc.text_encoder_trainable and keys.get("model_settings.fused_score_kernel", True))
        assert mc.fused_attention_vjp == keys.get("model_settings.fused_attention_vjp", True)
        KWClip(mc)


def test_reinit_hubert_layers_matches_jax():
    """The selected layers of an imported tower take the seeded
    initialization's tensors, the rest stay imported (JAX's
    `reinit_hubert_layers` on the scanned tree)."""
    from speechclip_plus_tpu.models.hubert import HubertConfig as JHubertConfig
    from speechclip_plus_tpu.models.hubert import HubertModel as JHubertModel

    jm = JHubertModel(JHubertConfig.tiny())
    wav = jnp.zeros((1, 800))
    init = jax.jit(lambda k: jm.init(k, wav, jnp.zeros((1, 800), bool))["params"])
    imported, seeded = (jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(s)))
                        for s in (1, 2))
    want = HubertModel(HubertConfig.tiny())
    load_hubert(want, jax_reinit(imported, seeded, [1]))
    towers = []
    for tree in (imported, seeded):
        t = HubertModel(HubertConfig.tiny())
        load_hubert(t, tree)
        towers.append({k: v.numpy() for k, v in t.state_dict().items()})
    got = reinit_hubert_layers(towers[0], towers[1], [1])
    for n, v in want.state_dict().items():
        np.testing.assert_array_equal(got[n], v.numpy(), err_msg=n)
    assert not np.array_equal(got["layers.1.fc1.weight"], towers[0]["layers.1.fc1.weight"])
    assert np.array_equal(got["layers.0.fc1.weight"], towers[0]["layers.0.fc1.weight"])


def test_builder_imports_the_tower_and_reinitializes_the_selected_layers(tmp_path):
    """`audio_encoder.ckpt_path` names a fairseq file: the builder imports it,
    and with `reinit_layers: [1]` layer 1 keeps the seeded initialization
    while every other tower tensor is the file's."""
    from speechclip_plus_tpu_torch.checkpoint.towers import fairseq_hubert_to_port
    from test_torch_towers import hubert_sd

    sd = hubert_sd("fairseq", HubertConfig.tiny())
    path = str(tmp_path / "hubert.pt")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    imported = fairseq_hubert_to_port(sd, HubertConfig.tiny())
    seeded, _, _ = build_model_from_config(load_config(TINY), device="cpu", seed=0)
    cfg = set_keys(load_config(TINY), {"audio_encoder.ckpt_path": path,
                                       "audio_encoder.reinit_layers": [1]})
    model, _, _ = build_model_from_config(cfg, device="cpu", seed=0)
    want = seeded.audio_encoder.state_dict()
    for n, t in model.audio_encoder.state_dict().items():
        ref = want[n] if n.startswith("layers.1.") else torch.from_numpy(
            np.asarray(imported[n], np.float32))
        assert torch.equal(t, ref), n


def test_resume_carries_the_trainable_tower_and_curr_temp(tmp_path):
    """A checkpoint of a trainable tower with a learnable VQ temperature
    restores the tower, `curr_temp` and their Adam state: the next step
    after a restore equals the next step of the unbroken run bit for bit."""
    from speechclip_plus_tpu_torch.checkpoint.manager import CheckpointManager

    cfg = set_keys(load_config(TINY), {"audio_encoder.unfreeze_layers": [1],
                                       "model_settings.cascaded_branch.vq.args.temp":
                                           "learnable=0.1"})
    batch = {k: torch.from_numpy(np.array(v)) for k, v in make_batch().items()}

    def fresh():
        model, _, _ = build_model_from_config(cfg, device="cpu", seed=0)
        opt = build_optimizer_from_config(model, cfg)
        return model, create_train_state(opt), make_train_step(model, opt)

    model, state, step = fresh()
    step(state, batch, torch.Generator().manual_seed(0))
    ck = CheckpointManager(str(tmp_path))
    ck.save(1, model, state)
    names = [n for n, _ in trainable_parameters(model)]
    assert "cascaded_branch.head.vector_quantizer.curr_temp" in names
    assert any(n.startswith("audio_encoder.layers.1.") for n in names)
    step(state, batch, torch.Generator().manual_seed(1))
    model2, state2, step2 = fresh()
    ck.restore(model2, state2)
    step2(state2, batch, torch.Generator().manual_seed(1))
    for (n, a), (_, b) in zip(model.state_dict().items(), model2.state_dict().items()):
        assert torch.equal(a, b), n
