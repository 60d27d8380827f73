"""The PyTorch port's Trainer against the JAX package's, on the CPU.

Both packages build hybrid+ from `config/dev/tiny.yaml` in fp32 (crops cut
to 1280 samples, dev batches of 3 so the last one is padded), the JAX
weights move into the port through `checkpoint/from_jax.py`, and a small
Flickr-shaped tree (`test_torch_data.write_flickr_tree`) feeds both.

- `validate` on the same batches: the `val_*` losses within 1e-5 abs +
  1e-4 rel, the recalls equal, and the same keyword-neighbor JSON (names
  equal, scores within the same tolerance).
- `fit` with the deterministic step on both sides (dropout cannot match
  across frameworks, PARITY.md): the JAX side gets the step
  `test_torch_train_step.py` builds, with the frozen towers stop-gradient'd,
  in place of `trainer.train_step`; the port runs its step with no
  generator. Four optimizer steps over two epochs with validation after
  each: the logged train losses within 1e-5 abs + 1e-4 rel, the `val_*`
  losses after training within the same, equal recalls, the same
  `opt_step`, epoch, `fit_state.json` and checkpoint directories.
- The port's resume after a stop and after a preemption flag at an
  optimizer-step boundary equals an unbroken port run bit for bit, with
  dropout on; `max_steps` counts optimizer steps under
  `accumulate_grad_batches: 2`; the image cache equals the live path; the
  checkpoint manager keeps the steps orbax's managers keep.
"""
import copy
import json
import os
import signal

import jax
import numpy as np
import optax
import pytest
import torch

import speechclip_plus_tpu.data as jdata
from speechclip_plus_tpu.models.kwclip import KWClip as JKWClip
from speechclip_plus_tpu.parallel.train_step import TrainState as JTrainState
from speechclip_plus_tpu.tasks.trainer import Trainer as JTrainer
from speechclip_plus_tpu.utils.keyword_extraction import KeywordDecoder as JKeywordDecoder

import speechclip_plus_tpu_torch.data as pdata
from speechclip_plus_tpu_torch.checkpoint.from_jax import load_jax_variables
from speechclip_plus_tpu_torch.config import load_config
from speechclip_plus_tpu_torch.data.image_cache import (CachedImageDataset,
                                                        precompute_image_embeddings)
from speechclip_plus_tpu_torch.tasks.builder import build_model_from_config
from speechclip_plus_tpu_torch.tasks.trainer import Trainer
from speechclip_plus_tpu_torch.utils.keyword_extraction import KeywordDecoder
from test_torch_data import MERGES, write_flickr_tree
from test_torch_train_step import TINY, _jax_setup

TOL = dict(rtol=1e-4, atol=1e-5)
CROP = 1280  # samples per training crop: 320 tiny-tower frames
SEED = 3


def _overrides(cfg, root, max_steps=4, accum=1):
    cfg.data.dataset.dataset_root = root
    cfg.data.dataset.bpe_path = MERGES
    cfg.data.dev_batch_size = 3
    cfg.audio_encoder.max_audio_len = CROP
    cfg.trainer.max_steps = max_steps
    cfg.trainer.accumulate_grad_batches = accum
    return cfg


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(tree, JAX (cfg, model, variables), port template model, tokenizer)."""
    root = write_flickr_tree(tmp_path_factory.mktemp("trainer") / "flickr")
    jcfg, jmodel, variables = _jax_setup()
    _overrides(jcfg, root)
    template, _, vocab = build_model_from_config(_overrides(load_config(TINY), root),
                                                 device="cpu", seed=0)
    load_jax_variables(template, variables)
    return root, (jcfg, jmodel, variables), template, vocab


def _decoders(vocab):
    tok = pdata.SimpleTokenizer(MERGES)
    r2o = vocab.reduced2original
    return KeywordDecoder(tok.decoder, r2o), JKeywordDecoder(tok.decoder, r2o)


def _loaders(root, pkg, split, max_audio_len=CROP):
    ds = pkg.FlickrDataset(root, split=split, image_size=32, normalize_waveform=True)
    if split == "train":
        return pkg.BucketedLoader(ds, 4, shuffle=True, drop_last=True,
                                  max_audio_len=max_audio_len, train=True, seed=SEED)
    return pkg.BucketedLoader(ds, 3, shuffle=False, drop_last=False)


def _port_trainer(world, save_path, max_steps=4, accum=1, deterministic=False):
    root, _, template, vocab = world
    cfg = _overrides(load_config(TINY), root, max_steps, accum)
    trainer = Trainer(copy.deepcopy(template), cfg, str(save_path), seed=SEED,
                      tokenizer_decoder=_decoders(vocab)[0])
    if deterministic:
        step = trainer.train_step
        trainer.train_step = lambda state, batch, gen: step(state, batch, None)
    return trainer


def _jax_deterministic_step(model, tx, accum):
    """JAX `make_train_step`'s step with dropout off (flax deterministic)."""

    def step_fn(state, batch, rng):
        opt_step = state.step // accum

        def loss_fn(params):
            p = dict(params)
            for root in ("audio_encoder", "clip"):  # frozen towers
                p[root] = jax.lax.stop_gradient(params[root])
            v = {"params": p, "batch_stats": state.batch_stats}
            (loss_feats, log_metrics, _), new_vars = model.apply(
                v, batch, training=True, deterministic=True, global_step=opt_step,
                mutable=["batch_stats"])
            loss_feats = dict(loss_feats, valid=batch["valid"])
            losses = model.apply(v, loss_feats, method=JKWClip.compute_loss)
            return losses["loss"], (losses, log_metrics, new_vars["batch_stats"])

        (_, (losses, log_metrics, stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        new_state = JTrainState(step=state.step + 1,
                                params=optax.apply_updates(state.params, updates),
                                batch_stats=stats, opt_state=opt_state)
        metrics = {f"train_{k}": v for k, v in losses.items()}
        metrics.update({f"train_{k}": v for k, v in log_metrics.items()})
        metrics["grad_norm"] = optax.global_norm(grads)
        return new_state, metrics

    return jax.jit(step_fn)


@pytest.fixture(scope="module")
def jax_run(world, tmp_path_factory):
    """The JAX Trainer: `validate` on the dev batches before training, then a
    deterministic `fit` of 4 optimizer steps over two epochs."""
    root, (jcfg, jmodel, variables), _, vocab = world
    save = tmp_path_factory.mktemp("jax_run")
    trainer = JTrainer(jmodel, variables, jcfg, str(save / "validate"), devices=1, seed=SEED,
                       tokenizer_decoder=_decoders(vocab)[1])
    dev = list(_loaders(root, pdata, "dev"))
    before = trainer.validate(dev)
    trainer = JTrainer(jmodel, variables, jcfg, str(save / "fit"), devices=1, seed=SEED,
                       tokenizer_decoder=_decoders(vocab)[1])
    trainer.train_step = _jax_deterministic_step(jmodel, trainer.tx, trainer.accum)
    trainer.fit(_loaders(root, jdata, "train"), _loaders(root, jdata, "dev"))
    return dev, before, trainer, save


def _rows(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _close(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        if "recall" in k:
            assert got[k] == want[k], (what, k)
        elif isinstance(want[k], float) and k not in ("time", "steps_per_sec"):
            np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=f"{what}: {k}")


def _keywords_json(path, epoch):
    with open(os.path.join(path, "retokenizeText", f"keywords_ep{epoch}.json")) as f:
        return json.load(f)


def _assert_same_keywords(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["gold"] == w["gold"]
        assert list(g["neighbors"]) == list(w["neighbors"])
        for k in w["neighbors"]:
            assert [n for n, _ in g["neighbors"][k]] == [n for n, _ in w["neighbors"][k]]
            np.testing.assert_allclose([v for _, v in g["neighbors"][k]],
                                       [v for _, v in w["neighbors"][k]], **TOL)


def test_validate_matches_jax(world, jax_run, tmp_path):
    dev, want, _, save = jax_run
    trainer = _port_trainer(world, tmp_path)
    got = trainer.validate(dev)
    assert any(not b["valid"].all() for b in dev)  # a padded final batch
    assert got["val_loss"] > 0 and "val_recall_mean_10" in got
    _close(got, want, "validate")
    _assert_same_keywords(_keywords_json(tmp_path, 0),
                          _keywords_json(str(save / "validate"), 0))


def test_fit_matches_jax(world, jax_run, tmp_path):
    _, _, jtrainer, save = jax_run
    trainer = _port_trainer(world, tmp_path, deterministic=True)
    root = world[0]
    trainer.fit(_loaders(root, pdata, "train"), _loaders(root, pdata, "dev"))
    assert (trainer.opt_step, trainer.epoch) == (jtrainer.opt_step, jtrainer.epoch) == (4, 2)
    got, want = _rows(tmp_path), _rows(str(save / "fit"))
    assert [r["step"] for r in got] == [r["step"] for r in want]
    assert sum("train_loss" in r for r in got) == 4 and sum("val_loss" in r for r in got) == 3
    for g, w in zip(got, want):
        _close(g, w, f"row at step {w['step']}")
    ck, jck = os.path.join(tmp_path, "checkpoints"), os.path.join(save, "fit", "checkpoints")
    for name in ("last", "val_loss", "val_recall_mean_10"):
        steps = lambda d: sorted(s for s in os.listdir(os.path.join(d, name)) if s.isdigit())
        assert steps(ck) == steps(jck), name
    with open(os.path.join(ck, "fit_state.json")) as f, \
            open(os.path.join(jck, "fit_state.json")) as g:
        assert json.load(f) == json.load(g)
    assert trainer.ckpt.best_step("val_loss") == jtrainer.ckpt.best_step("val_loss")
    _assert_same_keywords(_keywords_json(tmp_path, 2), _keywords_json(str(save / "fit"), 2))


def _snapshot(trainer):
    return ({k: v.clone() for k, v in trainer.model.state_dict().items()},
            copy.deepcopy(trainer.optimizer.adam.state_dict()["state"]))


def _assert_bitwise(a, b):
    (ma, oa), (mb, ob) = a, b
    assert ma.keys() == mb.keys()
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    assert oa.keys() == ob.keys()
    for i in oa:
        for k in oa[i]:
            assert torch.equal(oa[i][k], ob[i][k]), (i, k)


@pytest.fixture(scope="module")
def unbroken(world, tmp_path_factory):
    """An unbroken port run with dropout on: 4 optimizer steps, 2 epochs."""
    trainer = _port_trainer(world, tmp_path_factory.mktemp("unbroken"))
    trainer.fit(_loaders(world[0], pdata, "train"), _loaders(world[0], pdata, "dev"))
    assert trainer.state.step == 4
    return _snapshot(trainer)


def test_resume_after_stop_is_bit_identical(world, unbroken, tmp_path):
    root = world[0]
    first = _port_trainer(world, tmp_path, max_steps=2)
    first.fit(_loaders(root, pdata, "train"), _loaders(root, pdata, "dev"))
    assert (first.opt_step, first.epoch) == (2, 1)
    second = _port_trainer(world, tmp_path / "resumed")
    second.resume(os.path.join(tmp_path, "checkpoints", "last"))
    assert (second.state.step, second.epoch, second._skip_batches) == (2, 1, 0)
    second.fit(_loaders(root, pdata, "train"), _loaders(root, pdata, "dev"))
    assert (second.opt_step, second.epoch) == (4, 2)
    _assert_bitwise(_snapshot(second), unbroken)


def test_resume_after_preemption_is_bit_identical(world, unbroken, tmp_path):
    """The preemption flag arrives during micro-step 3, in the middle of the
    second epoch: the loop saves at the next optimizer-step boundary with one
    batch of the epoch done, and a resumed run skips that batch."""
    root = world[0]
    first = _port_trainer(world, tmp_path)
    step = first.train_step

    def flagged(state, batch, gen):
        metrics = step(state, batch, gen)
        if state.step == 3:
            first._preempt_signum = signal.SIGTERM
        return metrics

    first.train_step = flagged
    first.fit(_loaders(root, pdata, "train"), _loaders(root, pdata, "dev"))
    assert (first.state.step, first.epoch) == (3, 1)
    with open(os.path.join(tmp_path, "checkpoints", "fit_state.json")) as f:
        assert json.load(f) == {"epoch": 1, "opt_step": 3, "batches_done": 1}
    assert first.ckpt.latest_step() == 3
    second = _port_trainer(world, tmp_path / "resumed")
    second.resume(os.path.join(tmp_path, "checkpoints"))
    assert (second.state.step, second.epoch, second._skip_batches) == (3, 1, 1)
    second.fit(_loaders(root, pdata, "train"), _loaders(root, pdata, "dev"))
    assert (second.opt_step, second.epoch) == (4, 2)
    _assert_bitwise(_snapshot(second), unbroken)


def test_max_steps_counts_optimizer_steps_under_accumulation(world, tmp_path):
    trainer = _port_trainer(world, tmp_path, max_steps=2, accum=2, deterministic=True)
    root = world[0]
    trainer.fit(_loaders(root, pdata, "train"), _loaders(root, pdata, "dev"))
    # 2 optimizer steps = 4 micro-steps = two epochs of two batches
    assert (trainer.state.step, trainer.opt_step, trainer.epoch) == (4, 2, 2)
    assert trainer.state.grad_acc is None
    rows = [r for r in _rows(tmp_path) if "train_loss" in r]
    assert [r["step"] for r in rows] == [0, 1, 1, 2]
    assert [r["micro_step"] for r in rows] == [1.0, 2.0, 3.0, 4.0]
    assert trainer.ckpt.steps("last") == [2]


def test_timings_keep_each_pass_over_the_loader(world, tmp_path):
    trainer = _port_trainer(world, tmp_path, max_steps=3, deterministic=True)
    root = world[0]
    trainer.fit(_loaders(root, pdata, "train"), _loaders(root, pdata, "dev"))
    t = trainer.timings
    # one full epoch of two batches, then one stopped after its first step
    assert (trainer.state.step, trainer.epoch) == (3, 1)
    assert len(t["loader_wait_s"]) == 3 and len(t["train_s"]) == 2
    # the validation after epoch 1 and the one at the end, each saved
    assert len(t["validate_s"]) == 2 and len(t["save_s"]) == 2
    assert t["image_cache_s"] == []  # the task appends it; this Trainer is built alone
    assert all(s > 0 for s in t["train_s"] + t["loader_wait_s"])
    assert sum(t["train_s"]) >= sum(t["loader_wait_s"])


def test_image_cache_equals_live_path(world, jax_run):
    root, (jcfg, jmodel, variables), template, _ = world
    from speechclip_plus_tpu.data.image_cache import precompute_image_embeddings as jax_cache

    ds = pdata.FlickrDataset(root, split="train", image_size=32)
    feats = precompute_image_embeddings(template, ds, batch_size=3)
    assert len(feats) == 4 and all(f.dtype == np.float32 for f in feats.values())
    want = jax_cache(jmodel, variables, jdata.FlickrDataset(root, split="train", image_size=32),
                     batch_size=3)
    for path, f in feats.items():
        np.testing.assert_allclose(f, np.asarray(want[path], np.float32), **TOL)
    live = next(iter(pdata.BucketedLoader(ds, 4, shuffle=False)))
    cached = next(iter(pdata.BucketedLoader(CachedImageDataset(
        pdata.FlickrDataset(root, split="train", image_size=32), feats), 4, shuffle=False)))
    assert "image" not in cached and "image_feat" in cached
    to_t = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}
    with torch.no_grad():
        lf_live, _, _ = template(to_t(live), training=False)
        lf_cached, _, _ = template(to_t(cached), training=False)
    np.testing.assert_allclose(lf_live["image_feat"].numpy(), lf_cached["image_feat"].numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("metrics", [
    [(5.0, 10.0), (4.0, 30.0), (4.0, 30.0), (6.0, 20.0), (3.0, 30.0), (3.5, 5.0)],
    [(1.0, 50.0), (1.0, 50.0), (1.0, 50.0), (1.0, 50.0), (2.0, 60.0)],
])
def test_checkpoint_retention_matches_orbax(world, tmp_path, metrics):
    """Steps kept by `last` (1), `val_loss` (best min, 1) and
    `val_recall_mean_10` (best max, 3), and `best_step`, as orbax keeps them,
    ties included; a save at a step already kept is skipped; a restore
    brings the step and the parameters back."""
    from speechclip_plus_tpu.checkpoint import CheckpointManager as JManager

    from speechclip_plus_tpu_torch.checkpoint import CheckpointManager

    trainer = _port_trainer(world, tmp_path / "run")
    port = CheckpointManager(tmp_path / "port", config={"a": 1})
    jax_mgr = JManager(str(tmp_path / "jax"), config={"a": 1})
    jstate = {"w": np.zeros(3, np.float32)}
    for step, (loss, recall) in enumerate(metrics, 1):
        m = {"val_loss": loss, "val_recall_mean_10": recall, "note": "x"}
        trainer.state.step = step
        port.save(step, trainer.model, trainer.state, m)
        jax_mgr.save(step, jstate, m)
    port.save(len(metrics), trainer.model, trainer.state, {"val_loss": -1.0})  # skipped
    jax_mgr.save(len(metrics), jstate, {"val_loss": -1.0})
    for name in ("last", "val_loss", "val_recall_mean_10"):
        kept = sorted(int(s) for s in os.listdir(tmp_path / "jax" / name) if s.isdigit())
        assert port.steps(name) == kept, name
    for monitor in ("val_loss", "val_recall_mean_10"):
        assert port.best_step(monitor) == jax_mgr.best_step(monitor), monitor
    assert port.latest_step() == jax_mgr.latest_step() == len(metrics)
    assert CheckpointManager.load_config(tmp_path / "port") == {"a": 1}
    jax_mgr.close()

    fresh = _port_trainer(world, tmp_path / "fresh")
    with torch.no_grad():
        fresh.model.weightedsum.add_(1.0)
    best = port.best_step("val_loss")
    assert port.restore(fresh.model, fresh.state, monitor="val_loss") == best
    assert fresh.state.step == best
    assert torch.equal(fresh.model.weightedsum, trainer.model.weightedsum)
    trainer.state.grad_acc = [torch.zeros(1)]
    with pytest.raises(ValueError, match="between optimizer steps"):
        port.save(99, trainer.model, trainer.state)
