"""The port's data parallelism on the CPU: two gloo ranks against one process
and against JAX's step on a 2-device mesh.

Two ranks, processes that `tests/torch_dp_ranks.py` spawns (a free port, a
120 s timeout), run the cases of that file on their rows of each global batch
of 8 at `config/dev/tiny.yaml` size in fp32; the tests hold them against the
same cases in this process without a group:

  (a) the continuous path (the parallel branch alone, no dropout): the reduced
      gradient (the ranks' mean) equals the one-process gradient of the global batch, every
      tensor within 1e-5 of its largest |g|, and the parameters are
      bit-identical on both ranks after 2 steps (`parallel/mesh.py`'s
      gradient conventions);
  (b) hybrid+ (keyword BN, CIF, the hard VQ): the loss within rtol 1e-5,
      `grad_norm` within 1e-4, and the logged batch statistics (the VQ's
      perplexities and entropy, CIF's length difference, the quantity loss)
      within 1e-5;
  (c) the continuous path from JAX's weights (`checkpoint/from_jax.py`)
      against JAX's `make_train_step` on `make_mesh(jax.devices()[:2])` with
      `shard_batch`, within `tests/test_parallel_dp.py`'s tolerances (loss
      rtol 1e-4, `grad_norm` 1e-3, the parameters after the update within
      2.5 learning-rate steps everywhere and close in 98 %);
  (d) the keyword-BN running statistics after (b) within 1e-6 of their
      largest value;
  (e) LayerDrop: both ranks keep the same layers, the draw of the shared
      `layer_drop` stream, while their dropout masks differ;
  (f) a global batch of 7 rows pads one `valid=False` row onto the second
      rank and gives the one-process loss of the 7;
  (g) gradient accumulation of 2: one all-reduce per optimizer step, and
      the mean gradient Adam takes equals the one-process one.
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

from speechclip_plus_tpu.config import load_config as jax_load_config
from speechclip_plus_tpu.models.kwclip import KWClip as JKWClip
from speechclip_plus_tpu.models.kwclip import KWClipConfig as JKWClipConfig
from speechclip_plus_tpu.optim.optimizer import build_optimizer_from_config as jax_build_opt
from speechclip_plus_tpu.parallel import create_train_state as jax_train_state
from speechclip_plus_tpu.parallel import make_mesh as jax_make_mesh
from speechclip_plus_tpu.parallel import make_train_step as jax_make_train_step
from speechclip_plus_tpu.parallel.mesh import shard_batch as jax_shard_batch
from speechclip_plus_tpu.tasks.builder import resolve_reduced_vocab as jax_vocab

import torch_dp_ranks as ranks_mod
from speechclip_plus_tpu_torch.checkpoint.from_jax import load_jax_variables
from speechclip_plus_tpu_torch.parallel import mesh
from speechclip_plus_tpu_torch.parallel.train_step import training_key
from speechclip_plus_tpu_torch.tasks.base_task import free_port
from speechclip_plus_tpu_torch.tasks.builder import build_model_from_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELPER = os.path.join(REPO, "tests", "torch_dp_ranks.py")


def jax_config():
    """The continuous case's config in the JAX package (`ranks_mod.config`)."""
    cfg = jax_load_config(ranks_mod.TINY)
    cfg.model_settings.cascaded_objective_weight = 0.0
    cfg.model_settings.parallel_branch.transformer_args.dropout = 0.0
    cfg.audio_encoder.frozen_dropout = False
    cfg.audio_encoder.layer_drop = 0.0
    return cfg


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX continuous model, its variables, and the port's weights file."""
    cfg = jax_config()
    vocab = jax_vocab(cfg)
    mcfg = JKWClipConfig.from_config(cfg, vocab_size=len(vocab), sot_id=int(vocab.sot_reduced),
                                     eot_id=int(vocab.eot_reduced))
    model = JKWClip(mcfg)
    batch = {k: jnp.asarray(v) for k, v in ranks_mod.global_batch(2, 0).items()}
    variables = jax.jit(lambda k, b: model.init({"params": k}, b, training=False))(
        jax.random.PRNGKey(0), batch)
    variables = jax.tree_util.tree_map(np.array, dict(variables))
    # a parallel-only model never runs the text tower, so flax creates no
    # parameters for it; the port's frozen CLIP has both towers (as in
    # test_torch_families.py)
    text = jax.jit(lambda k, t: model.init({"params": k}, t, method=JKWClip.forward_text))(
        jax.random.PRNGKey(1), jnp.zeros((1, mcfg.clip.context_length), jnp.int32))
    variables["params"]["clip"]["text"] = jax.tree_util.tree_map(
        np.array, dict(text["params"]["clip"]["text"]))
    port, _, _ = build_model_from_config(ranks_mod.config("jax"), device="cpu", seed=0)
    load_jax_variables(port, variables)
    weights = tmp_path_factory.mktemp("dp_weights") / "port.pt"
    torch.save(port.state_dict(), weights)
    return cfg, model, variables, port, str(weights)


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    """Both ranks' results of every case (one run of the helper)."""
    out = tmp_path_factory.mktemp("dp_ranks")
    run = subprocess.run(
        [sys.executable, HELPER, "--world", "2", "--port", str(free_port()), "--out", str(out),
         "--weights", jax_side[4]],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-4000:]
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]


def assert_grads_close(got, want, names, what):
    for n, g, w in zip(names, got, want):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-5 * scale, f"{what}: {n}"


def assert_ranks_identical(ranks, case):
    a, b = ranks[0][case]["state"], ranks[1][case]["state"]
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), f"{case}: {k} differs across ranks"


def test_mesh_without_process_group_and_batch_rows():
    assert mesh.make_mesh() is None
    batch = ranks_mod.global_batch(7, 0)
    padded = mesh.pad_batch(batch, 2)
    assert padded["wav"].shape[0] == 8 and padded["valid"].tolist() == [True] * 7 + [False]
    assert not padded["wav"][7].any() and padded["wav_len"][7] == 0
    group = mesh.DataGroup(rank=1, world=2, device=torch.device("cpu"))
    rows = mesh.shard_batch(padded, group)
    np.testing.assert_array_equal(rows["wav"], padded["wav"][4:])
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_batch(batch, group)
    assert mesh.shard_batch(batch, None) is batch


def test_continuous_sum_of_ranks_is_the_global_gradient(ranks):
    ref = ranks_mod.run_case("continuous")
    for r in range(2):
        got = ranks[r]["continuous"]
        for step in range(2):
            assert_grads_close(got["applied"][step], ref["applied"][step], ref["names"],
                               f"rank {r} step {step}")
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-6)
        assert got["reductions"] == 2
    assert_ranks_identical(ranks, "continuous")


def test_hybrid_plus_loss_and_grad_norm(ranks):
    ref = ranks_mod.run_case("hybrid")
    for r in range(2):
        got = ranks[r]["hybrid"]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=1e-4)
        # the VQ's statistics and CIF's are the global batch's, as the loss is
        assert got["logs"][0].keys() == ref["logs"][0].keys() == set(ranks_mod.LOGGED)
        for key, want in ref["logs"][0].items():
            np.testing.assert_allclose(got["logs"][0][key], want, rtol=1e-5, err_msg=key)
    assert_ranks_identical(ranks, "hybrid")

    # (d) the keyword-BN running statistics moved from the global batch's
    names = sorted(k for k in ref["state"] if "running_" in k)
    assert [k.rsplit(".", 1)[1] for k in names] == ["running_mean", "running_var"]
    for k, start in zip(names, (0.0, 1.0)):
        want = ref["state"][k]
        assert not torch.equal(want, torch.full_like(want, start)), f"{k} did not move"
        for r in range(2):
            got = ranks[r]["hybrid"]["state"][k]
            assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max()), k


def test_two_ranks_match_jax_two_device_mesh(jax_side, ranks):
    cfg, jmodel, variables, port, _ = jax_side
    tx = jax_build_opt(variables["params"], jmodel.cfg, cfg)
    mesh2 = jax_make_mesh(jax.devices()[:2])
    step = jax_make_train_step(jmodel, tx, mesh=mesh2, donate=False)
    batch = {k: jnp.asarray(v) for k, v in ranks_mod.global_batch(8, 0).items()}
    state, metrics = step(jax_train_state(jmodel, variables, tx), jax_shard_batch(batch, mesh2),
                          jax.random.PRNGKey(42))
    for r in range(2):
        got = ranks[r]["jax"]
        np.testing.assert_allclose(got["loss"][0], float(metrics["train_loss"]), rtol=1e-4)
        np.testing.assert_allclose(got["grad_norm"][0], float(metrics["grad_norm"]), rtol=1e-3)
    after = copy.deepcopy(port)
    load_jax_variables(after, {"params": jax.tree_util.tree_map(np.asarray, state.params),
                               "batch_stats": variables.get("batch_stats", {})})
    want = dict(after.named_parameters())
    lr_step = ranks_mod.config("jax").audio_encoder.optim.args.lr / 2  # warmup step 0: lr / 2
    n_close = n_total = 0
    for n, t in ranks[0]["jax"]["state"].items():
        if n not in want:
            continue
        a, b = t.double().numpy(), want[n].detach().double().numpy()
        close = np.isclose(a, b, rtol=2e-4, atol=2e-5)
        n_close += close.sum()
        n_total += close.size
        assert np.abs(a - b).max() < 2.5 * lr_step + 1e-12, n
    assert n_total > 0 and n_close / n_total >= 0.98, n_close / n_total
    assert_ranks_identical(ranks, "jax")


def test_layer_drop_is_one_draw_for_every_rank(ranks):
    keeps = [ranks[r]["layer_drop"]["keep"] for r in range(2)]
    assert len(keeps[0]) == len(keeps[1]) == 2
    for step, (k0, k1) in enumerate(zip(*keeps)):
        assert torch.equal(k0, k1), step
        want = torch.empty(k0.shape[0]).bernoulli_(
            0.5, generator=training_key(ranks_mod.SEED, step, "cpu", stream="layer_drop")).bool()
        assert torch.equal(k0, want), step
    # the per-row draws differ between the ranks' dropout streams
    g0, g1 = (training_key(ranks_mod.SEED, 0, "cpu", rank=r) for r in range(2))
    assert not torch.equal(torch.rand(64, generator=g0), torch.rand(64, generator=g1))
    assert_ranks_identical(ranks, "layer_drop")


def test_short_global_batch_pads_a_row_and_keeps_the_loss(ranks):
    ref = ranks_mod.run_case("pad")
    for r in range(2):
        got = ranks[r]["pad"]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        assert_grads_close(got["applied"][0], ref["applied"][0], ref["names"], f"rank {r}")
    assert_ranks_identical(ranks, "pad")


def test_accumulation_reduces_once_per_optimizer_step(ranks):
    ref = ranks_mod.run_case("accum")
    assert len(ref["applied"]) == 2 and len(ref["loss"]) == 4
    for r in range(2):
        got = ranks[r]["accum"]
        assert got["reductions"] == 2 and len(got["applied"]) == 2
        for step in range(2):
            assert_grads_close(got["applied"][step], ref["applied"][step], ref["names"],
                               f"rank {r} window {step}")
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-6)
        # grad_norm is the window mean's, logged at the window's last micro-step
        assert got["grad_norm"][0] is None and got["grad_norm"][2] is None
        assert got["grad_norm"][1] > 0
    assert_ranks_identical(ranks, "accum")
