"""The port's tensor parallelism on the CPU: gloo ranks on a (data, model)
grid against one process and against JAX's single-device step.

Ranks, processes that `tests/torch_tp_ranks.py` spawns (a free port, a 120 s
timeout; the two grids side by side), shard the tiny model over their model
group and run the cases of that file on their data rank's rows of each global
batch of 8 in fp32, at tp=2 (world 2) and dp=2 x tp=2 (world 4):

  (a) the continuous path: every gradient Adam is given, gathered whole,
      within 1e-5 of its largest |g| of the one-process gradient, the losses
      within rtol 1e-6, every rank's whole parameters bit-identical;
  (b) hybrid+ (keyword BN, CIF, K3 / K3b on the vocabulary shard): the loss
      within rtol 1e-5, `grad_norm` within 1e-4, the logged batch statistics
      within 1e-5;
  (c) with every dropout on at tp=2: the masks match the one process's by
      construction (one data rank, the column-sliced FFN mask, the head-keyed
      attention mask), so (a)'s tolerances hold;
  (d) the continuous path from JAX's weights against JAX's single-device
      `make_train_step`, built as `tests/test_parallel_tp.py:183-187` builds
      it, at its tolerances: loss rtol 1e-4, gradients rtol 1e-3 / atol 1e-6
      (JAX's gradients from that file's `_make_grad_fn`), parameters after
      one step within 5e-4 under that file's schedule (warmup 10);
  (e) Adam's moments have the shards' shapes.
"""
import copy
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechclip_plus_tpu.optim.optimizer import build_optimizer_from_config as jax_build_opt
from speechclip_plus_tpu.parallel import create_train_state as jax_train_state
from speechclip_plus_tpu.parallel import make_train_step as jax_make_train_step

import torch_tp_ranks as ranks_mod
from speechclip_plus_tpu_torch.checkpoint.from_jax import load_jax_variables
from speechclip_plus_tpu_torch.tasks.base_task import free_port
from test_parallel_tp import _make_grad_fn
from test_torch_parallel_dp import assert_grads_close, jax_side  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELPER = os.path.join(REPO, "tests", "torch_tp_ranks.py")
GRIDS = {"tp2": (2, 2), "dp2xtp2": (4, 2)}


@pytest.fixture(scope="module")
def grids(jax_side, tmp_path_factory):
    """{grid: (world, every rank's results of every case)}: one run of the
    helper a grid, both at once."""
    runs = {}
    for name, (world, tp_size) in GRIDS.items():
        out = tmp_path_factory.mktemp(f"tp_ranks_{name}")
        err = open(out / "stderr", "w+")
        runs[name] = out, err, subprocess.Popen(
            [sys.executable, HELPER, "--world", str(world), "--tp", str(tp_size), "--port",
             str(free_port()), "--out", str(out), "--weights", jax_side[4]],
            cwd=REPO, stdout=subprocess.DEVNULL, stderr=err, text=True)
    results = {}
    for name, (out, err, proc) in runs.items():
        code = proc.wait(timeout=120)
        err.seek(0)
        assert code == 0, err.read()[-4000:]
        world = GRIDS[name][0]
        results[name] = world, [torch.load(out / f"rank{r}.pt", weights_only=False)
                                for r in range(world)]
    return results


@pytest.fixture(scope="module", params=sorted(GRIDS))
def grid(request, grids):
    return grids[request.param]


@pytest.fixture(scope="module")
def one_process(jax_side):
    return {name: ranks_mod.run_case(name, weights=jax_side[4]) for name in ranks_mod.CASES}


def _identical_everywhere(ranks, case):
    a = ranks[0][case]["state"]
    for other in ranks[1:]:
        b = other[case]["state"]
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), f"{case}: {k} differs across ranks"


@pytest.mark.parametrize("case", ["continuous", "dropout"])
def test_gradients_match_one_process(grid, one_process, case):
    world, ranks = grid
    if case not in ranks[0]:
        assert world == 4  # dropout: one data rank only (its masks are the one process's)
        return
    ref = one_process[case]
    for r in range(world):
        got = ranks[r][case]
        for step in range(len(ref["applied"])):
            assert_grads_close(got["applied"][step], ref["applied"][step], ref["names"],
                               f"rank {r} step {step}")
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-6 if case != "dropout"
                                   else 1e-5)
        np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=1e-5)
    _identical_everywhere(ranks, case)


def test_hybrid_plus_loss_and_grad_norm(grid, one_process):
    world, ranks = grid
    ref = one_process["hybrid"]
    for r in range(world):
        got = ranks[r]["hybrid"]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=1e-4)
        assert got["logs"][0].keys() == ref["logs"][0].keys() == set(ranks_mod.LOGGED)
        for key, want in ref["logs"][0].items():
            np.testing.assert_allclose(got["logs"][0][key], want, rtol=1e-5, err_msg=key)
    _identical_everywhere(ranks, "hybrid")


def test_adam_moments_are_the_shards(grid, one_process):
    _, ranks = grid
    got, whole = ranks[0]["continuous"], one_process["continuous"]
    halves = 0
    for n in got["names"]:
        assert got["adam_shapes"][n] == got["shards"][n], n
        if got["shards"][n] != tuple(whole["state"][n].shape):
            halves += 1
            assert np.prod(got["shards"][n]) * 2 == whole["state"][n].numel(), n
    assert halves == 3  # linear1 (weight, bias) and linear2.weight of the branch


@pytest.fixture(scope="module")
def jax_step(jax_side):
    """JAX's single-device step and raw gradients, built as
    `tests/test_parallel_tp.py:177-187` builds them, in the port's layout:
    (loss, {name: gradient}, {name: parameter after the step})."""
    cfg, jmodel, variables, port, _ = jax_side
    cfg = copy.deepcopy(cfg)
    for k, v in ranks_mod.JAX_SCHEDULE.items():
        setattr(cfg.audio_encoder.scheduler, k, v)
    tx = jax_build_opt(variables["params"], jmodel.cfg, cfg)
    state0 = jax_train_state(jmodel, variables, tx)
    batch = {k: jnp.asarray(v) for k, v in ranks_mod.global_batch(8, 0).items()}
    key = jax.random.PRNGKey(42)
    state1, metrics = jax_make_train_step(jmodel, tx, mesh=None, donate=False)(state0, batch, key)
    grads = jax.tree_util.tree_map(np.asarray, _make_grad_fn(jmodel)(state0, batch, key))
    grads = dict(grads)
    grads["clip"] = dict(grads["clip"], text=variables["params"]["clip"]["text"])
    as_port = copy.deepcopy(port)
    load_jax_variables(as_port, {"params": grads, "batch_stats": variables.get("batch_stats", {})})
    want_g = dict(as_port.named_parameters())
    after = copy.deepcopy(port)
    load_jax_variables(after, {"params": jax.tree_util.tree_map(np.asarray, state1.params),
                               "batch_stats": variables.get("batch_stats", {})})
    return float(metrics["train_loss"]), want_g, dict(after.named_parameters())


def test_matches_jax_single_device_step(grid, jax_step):
    """`tests/test_parallel_tp.py::test_tp_step_matches_single_device` on the
    continuous path, the port's dp x tp ranks in JAX's sharded step's place."""
    world, ranks = grid
    loss, want_g, want_p = jax_step
    for r in range(world):
        got = ranks[r]["jax"]
        np.testing.assert_allclose(got["loss"][0], loss, rtol=1e-4)
        for n, g in zip(got["names"], got["applied"][0]):
            np.testing.assert_allclose(g.numpy(), want_g[n].detach().numpy(), rtol=1e-3,
                                       atol=1e-6, err_msg=n)
        for n, t in got["state"].items():
            if n in want_p:
                d = float((t - want_p[n].detach()).abs().max())
                assert d < 5e-4, (n, d)
    _identical_everywhere(ranks, "jax")
