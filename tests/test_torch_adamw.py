"""AdamW in the port (`optim.optimizer.build_optimizer`, `optim.name: AdamW`)
against the JAX package's optax chain on the CPU.

JAX builds AdamW as clip_by_global_norm -> scale_by_adam ->
add_decayed_weights -> the learning-rate schedule: the decay acts after the
moments and is scaled by the scheduled rate (``optim/optimizer.py:151-157``).
The port's `Optimizer(decoupled=True)` is `torch.optim.AdamW` with the rate
set from the schedule before each step. Held as Adam is in
`test_torch_dropout_optim.py`: on loose tensors (clip on and off, large
gradients), and through the tiny config's trainable set over 3 steps, every
tensor after every step within 1e-5 relative.
"""
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speechclip_plus_tpu.config import load_config as jax_load_config
from speechclip_plus_tpu.ops import schedulers as jsched
from speechclip_plus_tpu.optim.optimizer import build_optimizer as jax_build_optimizer
from speechclip_plus_tpu_torch.config import load_config
from speechclip_plus_tpu_torch.ops import schedulers
from speechclip_plus_tpu_torch.optim.optimizer import (Optimizer, build_optimizer_from_config,
                                                       trainable_parameters)
from speechclip_plus_tpu_torch.tasks.builder import build_model_from_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "config", "dev", "tiny.yaml")
SCHEDULE = dict(warmup=2, max_step=10, final_lr=1e-8)


@pytest.mark.parametrize("grad_scale,clip", [(1.0, 4.0), (100.0, 4.0), (1.0, 0.0)])
def test_adamw_matches_optax(grad_scale, clip):
    rng = np.random.RandomState(8)
    shapes = [(5, 3), (7,), (), (2, 2, 3)]
    params = [np.asarray(rng.randn(*s), np.float32) for s in shapes]
    grads = [[np.asarray(grad_scale * rng.randn(*s), np.float32) for s in shapes]
             for _ in range(4)]
    parts = ([optax.clip_by_global_norm(clip)] if clip else []) + [
        optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8), optax.add_decayed_weights(1e-1),
        optax.scale_by_learning_rate(jsched.linear_warmup_decay_schedule(1e-2, **SCHEDULE))]
    tx = optax.chain(*parts)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = Optimizer(tp, lr=1e-2, weight_decay=1e-1, gradient_clip_val=clip, decoupled=True,
                    schedule=schedulers.linear_warmup_decay_schedule(1e-2, **SCHEDULE))
    assert isinstance(opt.adam, torch.optim.AdamW)
    for step, g in enumerate(grads):
        updates, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.apply([torch.from_numpy(a) for a in g], step)
        for got, want in zip(tp, jp):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5,
                                       atol=1e-7)


def _adamw(cfg):
    cfg.audio_encoder.optim.name = "AdamW"
    cfg.audio_encoder.optim.args.weight_decay = 0.05
    return cfg


def test_adamw_from_the_tiny_config_matches_jax_over_3_steps():
    cfg = _adamw(load_config(TINY))
    model, _, _ = build_model_from_config(cfg, device="cpu", seed=0)
    opt = build_optimizer_from_config(model, cfg)
    assert isinstance(opt.adam, torch.optim.AdamW)
    assert opt.adam.param_groups[0]["weight_decay"] == 0.05
    named = trainable_parameters(model)
    assert len(named) > 10

    # JAX's build_optimizer over the same trainable tensors, as a flat tree
    jcfg = _adamw(jax_load_config(TINY))
    args = jcfg.audio_encoder.optim.args
    sched = jcfg.audio_encoder.scheduler
    # copies: jnp.asarray would alias the parameters' memory, which the port's
    # in-place step then changes under JAX's asynchronous update
    params = {n.replace(".", "/"): jnp.asarray(p.detach().numpy().copy()) for n, p in named}
    # every tensor of the flat tree trains (no tower root among its names)
    trains = SimpleNamespace(audio_trainable=False, image_encoder_trainable=False,
                             text_encoder_trainable=False, reinit_layers=(), unfreeze_layers=())
    tx = jax_build_optimizer(
        params, trains, optim_name=jcfg.audio_encoder.optim.name, lr=float(args.lr),
        weight_decay=float(args.weight_decay), scheduler_name=sched.name,
        scheduler_args={"warmup": int(sched.warmup), "max_step": int(sched.max_step),
                        "final_lr": float(sched.final_lr)},
        gradient_clip_val=float(jcfg.trainer.gradient_clip_val))
    state = tx.init(params)
    rng = np.random.RandomState(5)
    for step in range(3):
        grads = {n: np.asarray(rng.randn(*p.shape), np.float32) for n, p in params.items()}
        updates, state = tx.update({n: jnp.asarray(g) for n, g in grads.items()}, state, params)
        params = optax.apply_updates(params, updates)
        opt.apply([torch.from_numpy(grads[n.replace(".", "/")]) for n, _ in named], step)
        for n, p in named:
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[n.replace(".", "/")]),
                                       rtol=1e-5, atol=1e-7, err_msg=f"step {step}: {n}")
