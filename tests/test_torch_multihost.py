"""The port's multi-process start-up (`parallel/multihost.py`) and the task
CLI on two gloo ranks, on the CPU.

- The environment contract of `maybe_initialize_distributed`: JAX's
  SPEECHCLIP_* variables, torchrun's, `SPEECHCLIP_MULTIHOST=auto` without
  torchrun's raising with their names, and a second call doing nothing.
- `python -m speechclip_plus_tpu_torch.run_task ... --train --devices 2
  --device cpu` (two spawned ranks, each decoding its rows of every global
  batch) on a small Flickr-shaped tree: 2 steps, validation, checkpoints
  written by rank 0 alone, then `--eval --resume` on two ranks from them. The
  logged losses and validation, and the saved `state_dict` (each tensor in
  the 2-norm), agree with the one-device run within 3e-7 relative; the
  tensors that start at zero, which hold nothing but Adam's two steps,
  within 1e-5. The model is the tiny config's
  continuous path with every dropout off: two ranks draw their own per-row
  dropout masks, so a run with dropout has no one-device twin. Adam's steps
  on the attention's key bias are left out of the `state_dict` comparison:
  its gradient is zero in exact arithmetic, and Adam scales the rounding
  noise there to learning-rate-sized steps (`test_torch_train_step.py`).
- The loader's shards: concatenated over the ranks, each rank's rows are the
  one-process batch, padded to a multiple of the ranks.
- `--devices 2` under a process group of one (torchrun's variables with
  WORLD_SIZE=1) raises.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from speechclip_plus_tpu_torch.config import load_config
from speechclip_plus_tpu_torch.data import BucketedLoader, FlickrDataset
from speechclip_plus_tpu_torch.parallel.mesh import pad_batch
from speechclip_plus_tpu_torch.parallel import multihost
from speechclip_plus_tpu_torch.run_task import main
from speechclip_plus_tpu_torch.tasks.base_task import free_port
from speechclip_plus_tpu_torch.tasks.builder import build_model_from_config
from test_torch_data import write_flickr_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "config", "dev", "tiny.yaml")


def test_environment_contract():
    assert multihost.distributed_env({}) is None
    jax_vars = {"SPEECHCLIP_COORDINATOR": "10.0.0.1:1234", "SPEECHCLIP_NUM_PROCESSES": "4",
                "SPEECHCLIP_PROCESS_ID": "3"}
    assert multihost.distributed_env(jax_vars) == {
        "rank": 3, "world": 4, "local_rank": None, "init_method": "tcp://10.0.0.1:1234"}
    torchrun = {"RANK": "5", "WORLD_SIZE": "8", "LOCAL_RANK": "1", "MASTER_ADDR": "host",
                "MASTER_PORT": "29500"}
    assert multihost.distributed_env(torchrun) == {
        "rank": 5, "world": 8, "local_rank": 1, "init_method": "tcp://host:29500"}
    assert multihost.distributed_env(dict(torchrun, SPEECHCLIP_MULTIHOST="auto"))["rank"] == 5
    with pytest.raises(RuntimeError, match="RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT"):
        multihost.distributed_env({"SPEECHCLIP_MULTIHOST": "auto"})
    with pytest.raises(RuntimeError, match="MASTER_PORT"):
        multihost.distributed_env({"RANK": "0", "WORLD_SIZE": "2", "MASTER_ADDR": "h"})


@pytest.mark.parametrize("local_rank,rank,count,index", [
    (None, 5, 4, 1), (None, 2, 4, 2), (1, 5, 4, 1), (3, 3, 4, 3), (4, 4, 4, None)])
def test_cuda_index_takes_local_rank_and_refuses_one_past_the_gpus(local_rank, rank, count,
                                                                   index):
    spec = {"rank": rank, "world": 8, "local_rank": local_rank, "init_method": "tcp://h:1"}
    if index is None:
        with pytest.raises(RuntimeError, match="LOCAL_RANK=4, but this host shows 4 GPU"):
            multihost.cuda_index(spec, count)
    else:
        assert multihost.cuda_index(spec, count) == index


def test_initialize_is_idempotent():
    env = {"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port())}
    assert not multihost.maybe_initialize_distributed(env={}, device="cpu")
    try:
        assert multihost.maybe_initialize_distributed(env=env, device="cpu")
        assert torch.distributed.get_backend() == "gloo"
        assert multihost.local_device() == torch.device("cpu")
        # a second call (another environment even) keeps the group
        assert multihost.maybe_initialize_distributed(env={}, device="cpu")
        assert torch.distributed.get_world_size() == 1
    finally:
        torch.distributed.destroy_process_group()
    assert not torch.distributed.is_initialized()


def test_make_global_batch_gives_the_local_rows_as_tensors():
    batch = {"wav": np.zeros((2, 5), np.float32), "id": np.arange(2)}
    out = multihost.make_global_batch(batch, None)
    assert all(torch.is_tensor(v) and v.device.type == "cpu" for v in out.values())
    assert out["id"].tolist() == [0, 1]


@pytest.mark.parametrize("split,batch_size,train", [("train", 4, True), ("dev", 3, False)])
def test_sharded_loader_rows_concatenate_to_the_global_batch(tmp_path, split, batch_size,
                                                             train):
    """Each rank decodes only its rows of every global batch (the other rows'
    lengths from the wav headers); concatenated they are the one-process
    batch, padded to a multiple of the ranks: the crops (the train split's
    wavs run past max_audio_len), the bucket, the `valid` rows, and a rank
    whose shard is padding alone (the dev split's last batch of 2)."""
    root = write_flickr_tree(tmp_path / "flickr")
    ds = FlickrDataset(root, split=split, image_size=32, normalize_waveform=True)
    kw = dict(shuffle=train, drop_last=train, max_audio_len=2800 if train else -1, train=train,
              seed=5)
    want = list(BucketedLoader(ds, batch_size, **kw))
    shards = []
    for rank in range(2):
        loader = BucketedLoader(ds, batch_size, **kw)
        loader.set_shard(rank, 2)
        shards.append(list(loader))
    assert len(want) == len(shards[0]) == len(shards[1]) > 1
    for whole, a, b in zip(want, *shards):
        padded = pad_batch(whole, 2)
        assert a.keys() == b.keys() == padded.keys()
        for k in padded:
            np.testing.assert_array_equal(np.concatenate([a[k], b[k]]), padded[k], err_msg=k)
    if not train:
        assert not shards[1][-1]["valid"].any()


def _config(path):
    cfg = load_config(TINY)
    cfg.model_settings.cascaded_objective_weight = 0.0
    cfg.model_settings.parallel_branch.transformer_args.dropout = 0.0
    cfg.audio_encoder.frozen_dropout = False
    cfg.trainer.max_steps = 2
    with open(path, "w") as f:
        yaml.safe_dump(cfg.to_dict(), f)
    return str(path)


def _argv(config, root, save, *extra):
    return ["TrainKWClip_GeneralTransformer", "--config", config, "--device", "cpu",
            "--dataset_root", root, "--save_path", str(save), "--njobs", "0", "--seed", "1",
            *extra]


def _ranks(argv):
    out = subprocess.run([sys.executable, "-m", "speechclip_plus_tpu_torch.run_task", *argv],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    return out


def _rows(save):
    with open(os.path.join(save, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _close(got, want, what):
    assert abs(got - want) <= 3e-7 * abs(want), f"{what}: {got} vs {want}"


def _state(save, step):
    return torch.load(os.path.join(save, "checkpoints", "last", str(step), "state.pt"),
                      weights_only=True)["model"]


def test_two_ranks_train_validate_save_and_resume(tmp_path):
    root = write_flickr_tree(tmp_path / "flickr")
    config = _config(tmp_path / "continuous.yaml")
    one, two = tmp_path / "one", tmp_path / "two"
    cwd = os.getcwd()
    os.chdir(REPO)  # the config names the BPE merges relative to the repository
    try:
        trainer = main(_argv(config, root, one, "--train"))
    finally:
        os.chdir(cwd)
    assert trainer.group is None and trainer.opt_step == 2
    assert _ranks(_argv(config, root, two, "--train", "--devices", "2")).stdout == ""

    rows_one, rows_two = _rows(one), _rows(two)
    # rank 0 alone logs: as many rows as the one-device run, the same keys
    assert [sorted(r) for r in rows_two] == [sorted(r) for r in rows_one]
    for a, b in zip(rows_two, rows_one):
        for key in b:
            if key.startswith(("train_", "val_")) and key != "train_cl_temp":
                _close(a[key], b[key], key)
    assert sum("train_loss" in r for r in rows_two) == 2
    ck = two / "checkpoints"
    assert sorted(os.listdir(ck)) == sorted(os.listdir(one / "checkpoints"))
    with open(ck / "fit_state.json") as f:
        assert json.load(f) == {"epoch": 1, "opt_step": 2, "batches_done": 0}
    got, want = _state(two, 2), _state(one, 2)
    assert got.keys() == want.keys()
    start = build_model_from_config(load_config(config), device="cpu", seed=1)[0].state_dict()
    for name, w in want.items():
        g = got[name]
        if name.endswith("in_proj_bias"):  # the key bias: rounding noise (docstring)
            d = w.shape[0] // 3
            g, w = torch.cat([g[:d], g[2 * d:]]), torch.cat([w[:d], w[2 * d:]])
        # relative in the 2-norm; a tensor that starts at zero (the biases,
        # the weighted sum's logits) is Adam's two steps alone, whose second
        # divides moments of small gradients summed in another row order
        rtol = 1e-5 if not start[name].any() else 3e-7
        assert float((g.double() - w.double()).norm()) <= rtol * float(w.double().norm()), name

    # every rank restores rank 0's checkpoint and validates its rows
    out = _ranks(_argv(config, root, tmp_path / "eval", "--eval", "--devices", "2", "--resume",
                       str(ck / "last")))
    printed = [line for line in out.stdout.splitlines() if line.startswith("{")]
    assert len(printed) == 1  # rank 0 prints
    val = [r for r in rows_one if "val_loss" in r][-1]
    evaluated = _rows(tmp_path / "eval")[-1]
    for key in ("val_loss", "val_recall_mean_10", "val_p_cl_loss"):
        _close(evaluated[key], val[key], key)


def test_devices_must_equal_the_world_size(tmp_path, monkeypatch):
    for key, value in {"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(free_port())}.items():
        monkeypatch.setenv(key, value)
    with pytest.raises(ValueError, match="--devices 2 under a process group of 1"):
        main(["TrainKWClip_GeneralTransformer", "--config", TINY, "--device", "cpu",
              "--devices", "2", "--train", "--save_path", str(tmp_path)])
    assert not torch.distributed.is_initialized()
