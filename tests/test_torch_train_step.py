"""The PyTorch port's training step against the JAX package, on the CPU.

Both packages build hybrid+ from `config/dev/tiny.yaml` in fp32 and the JAX
variables move into the port through `checkpoint/from_jax.py`. One batch
(ragged waveforms, distinct ids; live images or cached image features) goes
through a training step with dropout off and everything else in training
form (keyword-BN batch statistics, CIF alpha scaling, straight-through VQ):
the JAX side as `model.apply(..., training=True, deterministic=True,
mutable=["batch_stats"])`, `compute_loss`, `jax.value_and_grad` with the
frozen towers stop-gradient'd, and the optax chain of
`build_optimizer_from_config`; the port as `make_train_step`'s step with no
generator. The JAX gradients and parameters are moved into a port model with
the same bridge, so every tensor is compared in the port's layout.

Tolerance 1e-5 abs + 1e-4 rel: fp32 on both sides, several layers, sums in
another order; the CIF quantity loss is O(100), so its gradients are large.

Also the two repairs of this slice: trainable parameters are fp32 master
weights under `trainer.precision: bf16`, and the bridge raises on a JAX leaf
it does not read.
"""
import copy
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
from speechclip_plus_tpu.tasks.builder import resolve_reduced_vocab as jax_vocab

from speechclip_plus_tpu_torch.checkpoint.from_jax import load_jax_variables
from speechclip_plus_tpu_torch.config import load_config
from speechclip_plus_tpu_torch.optim.optimizer import (
    build_optimizer_from_config,
    trainable_parameters,
)
from speechclip_plus_tpu_torch.parallel.train_step import create_train_state, make_train_step
from speechclip_plus_tpu_torch.tasks.builder import build_model_from_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "config", "dev", "tiny.yaml")
TOL = dict(rtol=1e-4, atol=1e-5)
STEPS = 3


def _jax_setup():
    cfg = jax_load_config(TINY)
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
    params["cascaded_branch"]["downsampling"]["weight_proj"]["bias"] = np.full(1, -6.0, np.float32)
    variables["params"] = jax.tree_util.tree_map(np.asarray, params)
    return cfg, model, variables


def _batch(cached, jmodel, variables):
    rng = np.random.RandomState(5)
    lens = np.array([3200, 2400, 2900], np.int64)
    wav = (0.3 * rng.randn(3, 3200)).astype(np.float32)
    wav[np.arange(3200)[None, :] >= lens[:, None]] = 0.0
    image = rng.randn(3, 32, 32, 3).astype(np.float32)
    batch = {"wav": wav, "wav_len": lens, "id": np.array([4, 9, 2])}
    if cached:
        batch["image_feat"] = np.asarray(jmodel.apply(
            {"params": variables["params"]}, jnp.asarray(image), method=JKWClip.encode_image_raw))
    else:
        batch["image"] = image
    return batch


def _jax_steps(cfg, model, variables, batch, n):
    """n optimizer steps of the JAX model, dropout off; returns the losses and
    gradients of the first step and the variables after each step."""
    tx = jax_build_opt(variables["params"], model.cfg, cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params, stats, step):
        p = dict(params)
        for root in ("audio_encoder", "clip"):  # frozen towers (train_step.py:123-127)
            p[root] = jax.lax.stop_gradient(params[root])
        v = {"params": p, "batch_stats": stats}
        (loss_feats, _, _), new_vars = model.apply(
            v, jbatch, training=True, deterministic=True, global_step=step,
            mutable=["batch_stats"])
        losses = model.apply(v, loss_feats, method=JKWClip.compute_loss)
        return losses["loss"], (losses, new_vars["batch_stats"])

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    params, stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)
    first, after = None, []
    for step in range(n):
        (_, (losses, stats)), grads = grad_fn(params, stats, step)
        if first is None:
            first = (jax.tree_util.tree_map(np.asarray, losses),
                     jax.tree_util.tree_map(np.asarray, grads))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        after.append({"params": jax.tree_util.tree_map(np.asarray, params),
                      "batch_stats": jax.tree_util.tree_map(np.asarray, stats)})
    return first, after


def _as_port(template, variables):
    """A port model holding `variables` (a JAX tree) in the port's layout."""
    model = copy.deepcopy(template)
    load_jax_variables(model, variables)
    return model


@pytest.fixture(scope="module")
def setup():
    cfg, jmodel, variables = _jax_setup()
    model, _, _ = build_model_from_config(load_config(TINY), device="cpu", seed=0)
    load_jax_variables(model, variables)
    return cfg, jmodel, variables, model


@pytest.mark.parametrize("cached", [False, True])
def test_step_matches_jax(setup, cached):
    cfg, jmodel, variables, template = setup
    batch = _batch(cached, jmodel, variables)
    (jlosses, jgrads), jafter = _jax_steps(cfg, jmodel, variables, batch, STEPS)

    model = copy.deepcopy(template)
    optimizer = build_optimizer_from_config(model, load_config(TINY))
    state = create_train_state(optimizer)
    step_fn = make_train_step(model, optimizer, accumulate_grad_batches=1)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}

    # the first step's losses and gradients (taken before the update)
    params = optimizer.params
    names = [n for n, _ in trainable_parameters(model)]
    grads_seen = {}
    hooks = [p.register_hook(lambda g, n=n: grads_seen.__setitem__(n, g.clone()))
             for n, p in zip(names, params)]
    metrics = step_fn(state, tbatch, None)
    for h in hooks:
        h.remove()
    for key in ("loss", "c_cl_loss", "p_cl_loss", "quantity_loss"):
        np.testing.assert_allclose(float(metrics[f"train_{key}"]), float(jlosses[key]),
                                   **TOL, err_msg=key)
    jgrad_model = _as_port(template, {"params": jgrads, "batch_stats": variables["batch_stats"]})
    want = dict(jgrad_model.named_parameters())
    assert len(names) == len(grads_seen) > 10
    for n in names:
        np.testing.assert_allclose(grads_seen[n].numpy(), want[n].detach().numpy(), **TOL,
                                   err_msg=f"gradient {n}")
    assert float(metrics["grad_norm"]) > 0

    # Two slices get a zero gradient in exact arithmetic: the branch's key
    # bias (a shift of every key score of a query leaves its softmax
    # unchanged) and the keyword projection's bias (batch-statistics BN
    # subtracts the batch mean right after it). Both sides hold rounding
    # noise there, and Adam scales noise to lr-sized steps, so these slices
    # are left out of the parameter comparison; they change no output.
    d = template.cfg.cascaded_ta.d_model
    noise = {"cascaded_branch.self_att.multihead_attn_layer.in_proj_bias": slice(d, 2 * d),
             "cascaded_branch.head.linear_proj.bias": slice(None)}
    # The keyword-BN running mean averages the projection's output, bias
    # included, so it is compared with each side's own bias history taken out:
    # running_mean_k - sum_j 0.1 * 0.9^(k-j) * bias_j, bias_j the bias of step j.
    for n, sl in noise.items():
        assert float(grads_seen[n][sl].abs().max()) < 1e-6, n
        assert float(want[n][sl].detach().abs().max()) < 1e-6, n
    proj_bias, running_mean = ("cascaded_branch.head.linear_proj.bias",
                               "cascaded_branch.head.bn_layer.running_mean")
    history = {"port": [template.state_dict()[proj_bias].numpy()],
               "jax": [template.state_dict()[proj_bias].numpy()]}
    for step in range(1, STEPS + 1):
        if step > 1:
            step_fn(state, tbatch, None)
        sides = {"port": model.state_dict(), "jax": _as_port(template, jafter[step - 1])
                 .state_dict()}
        for side, sd in sides.items():
            sd[running_mean] = sd[running_mean].numpy() - sum(
                0.1 * 0.9 ** (step - j) * b for j, b in enumerate(history[side][:step], 1))
            history[side].append(sd[proj_bias].numpy().copy())  # not a view of the live bias
        for n, t in sides["port"].items():
            got, want_t = np.asarray(t), np.asarray(sides["jax"][n])
            keep = np.ones(got.shape[0], bool) if got.ndim else True
            if n in noise:
                keep[noise[n]] = False
            np.testing.assert_allclose(got[keep], want_t[keep], **TOL,
                                       err_msg=f"step {step}: {n}")
    assert state.step == STEPS
    bn = model.cascaded_branch.head.bn_layer
    assert not torch.equal(bn.running_mean, template.cascaded_branch.head.bn_layer.running_mean)


def test_frozen_towers_stay_and_temperature_trains(setup):
    _, _, _, template = setup
    model = copy.deepcopy(template)
    optimizer = build_optimizer_from_config(model, load_config(TINY))
    step_fn = make_train_step(model, optimizer)
    rng = np.random.RandomState(1)
    batch = {"wav": torch.from_numpy((0.3 * rng.randn(2, 3200)).astype(np.float32)),
             "wav_len": torch.tensor([3200, 2000]), "id": torch.tensor([0, 1]),
             "image": torch.from_numpy(rng.randn(2, 32, 32, 3).astype(np.float32))}
    step_fn(create_train_state(optimizer), batch, torch.Generator().manual_seed(0))
    before = dict(template.named_parameters())
    for n, p in model.named_parameters():
        changed = not torch.equal(p, before[n])
        assert changed == p.requires_grad, n
        assert p.requires_grad == (not n.startswith(("audio_encoder.", "clip."))), n
    assert "criterion_log_inv_temp" in [n for n, _ in trainable_parameters(model)]


def test_accumulation_counts_optimizer_steps(setup):
    """accumulate_grad_batches=2: parameters move on every second call, with
    the mean gradient, and the step clock the model sees is the optimizer's."""
    _, _, _, template = setup
    rng = np.random.RandomState(2)
    batch = {"wav": torch.from_numpy((0.3 * rng.randn(2, 3200)).astype(np.float32)),
             "wav_len": torch.tensor([3200, 2000]), "id": torch.tensor([0, 1]),
             "image": torch.from_numpy(rng.randn(2, 32, 32, 3).astype(np.float32))}
    seen_steps = []
    model = copy.deepcopy(template)
    forward = model.forward
    model.forward = lambda *a, **kw: (seen_steps.append(kw["global_step"]), forward(*a, **kw))[1]
    optimizer = build_optimizer_from_config(model, load_config(TINY))
    state = create_train_state(optimizer)
    step_fn = make_train_step(model, optimizer, accumulate_grad_batches=2)
    w = model.cascaded_branch.parallel_proj.weight
    w0 = w.detach().clone()
    step_fn(state, batch, None)
    assert torch.equal(w, w0)          # first micro-step: no update
    step_fn(state, batch, None)
    assert not torch.equal(w, w0)      # second: one optimizer step
    # the two micro-steps saw the same batch with the same weights (BN
    # normalizes with batch statistics), so the mean gradient is the one
    # step of a run without accumulation
    ref = copy.deepcopy(template)
    ref_opt = build_optimizer_from_config(ref, load_config(TINY))
    make_train_step(ref, ref_opt)(create_train_state(ref_opt), batch, None)
    np.testing.assert_allclose(w.detach().numpy(),
                               ref.cascaded_branch.parallel_proj.weight.detach().numpy(), **TOL)
    step_fn(state, batch, None)
    assert seen_steps == [0, 0, 1] and state.step == 3


def test_trainable_parameters_are_fp32_masters_under_bf16():
    """Repair: under trainer.precision bf16 every trainable parameter is stored
    in fp32 (flax keeps params fp32 and casts at use); the frozen towers may
    store bf16."""
    cfg = load_config(TINY)
    cfg.trainer.precision = "bf16"
    model, mcfg, _ = build_model_from_config(cfg, device="cpu", seed=0)
    assert mcfg.cascaded_ta.compute_dtype == torch.bfloat16
    trainable = trainable_parameters(model)
    assert len(trainable) > 10
    for n, p in trainable:
        assert p.dtype == torch.float32, n
    assert model.audio_encoder.layers[0].fc1.weight.dtype == torch.bfloat16
    # why: a 3e-6 Adam step (lr 1e-4 early in warm-up) on a 0.03 weight is
    # below half of bf16's ulp there (1.2e-4) and would round away
    w = torch.tensor(0.03)
    assert torch.equal(w.bfloat16() + 3e-6, w.bfloat16()) and not torch.equal(w + 3e-6, w)


def test_bf16_step_runs_and_stays_finite():
    cfg = load_config(TINY)
    cfg.trainer.precision = "bf16"
    model, _, _ = build_model_from_config(cfg, device="cpu", seed=0)
    optimizer = build_optimizer_from_config(model, cfg)
    rng = np.random.RandomState(3)
    batch = {"wav": torch.from_numpy((0.3 * rng.randn(2, 3200)).astype(np.float32)),
             "wav_len": torch.tensor([3200, 2500]), "id": torch.tensor([0, 1]),
             "image": torch.from_numpy(rng.randn(2, 32, 32, 3).astype(np.float32))}
    before = {n: p.detach().clone() for n, p in trainable_parameters(model)}
    metrics = make_train_step(model, optimizer)(create_train_state(optimizer), batch,
                                                torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
    for n, p in trainable_parameters(model):
        assert p.dtype == torch.float32 and not torch.equal(p, before[n]), n


def test_bridge_raises_on_unread_jax_leaf(setup):
    """Repair: a JAX leaf nothing reads is an error, as an unfilled port
    tensor already was."""
    _, _, variables, template = setup
    extra = copy.deepcopy(variables)
    extra["params"]["cascaded_branch"]["head"]["unused_scale"] = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="unused_scale"):
        load_jax_variables(copy.deepcopy(template), extra)
    scanned = copy.deepcopy(variables)  # a leaf inside a scanned layer stack
    scanned["params"]["audio_encoder"]["layers"]["layer"]["fc1"]["extra"] = np.ones((2, 3))
    with pytest.raises(ValueError, match="layers/layer/fc1/extra"):
        load_jax_variables(copy.deepcopy(template), scanned)
    missing = copy.deepcopy(variables)
    del missing["params"]["criterion_log_inv_temp"]
    with pytest.raises(KeyError):
        load_jax_variables(copy.deepcopy(template), missing)
    model = copy.deepcopy(template)
    load_jax_variables(model, variables)
    assert float(model.criterion_log_inv_temp.detach()) == pytest.approx(
        float(variables["params"]["criterion_log_inv_temp"]))
