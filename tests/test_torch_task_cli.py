"""The port's task CLI on the CPU, end to end at the fast tier's size.

`python -m speechclip_plus_tpu_torch.run_task TrainKWClip_GeneralTransformer
--config config/dev/tiny.yaml --train --device cpu` on a small Flickr-shaped
tree (datasets -> worker loader -> image cache -> fit with validation,
retrieval, keyword artifacts, checkpoints), then `--test --resume` from its
checkpoints, as `tests/test_task_cli.py` drives the JAX package's CLI. Also:
the entry points run on the card unless asked for the CPU, and what the port
does not implement, or the machine cannot give, raises by name.
"""
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from speechclip_plus_tpu_torch.config import load_config
from speechclip_plus_tpu_torch.run_task import main
from speechclip_plus_tpu_torch.tasks import TrainKWClip_GeneralTransformer
from test_torch_data import write_flickr_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = "config/dev/tiny.yaml"


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "speechclip_plus_tpu_torch.run_task",
         "TrainKWClip_GeneralTransformer", "--config", TINY, *args],
        cwd=REPO, capture_output=True, text=True, timeout=300)


def test_cli_train_then_test_from_resume(tmp_path):
    root = write_flickr_tree(tmp_path / "flickr")
    save = tmp_path / "exp"
    out = _cli("--train", "--device", "cpu", "--dataset_root", root, "--save_path", str(save),
               "--njobs", "1", "--seed", "1")
    assert out.returncode == 0, out.stderr[-3000:]
    rows = [json.loads(line) for line in (save / "metrics.jsonl").read_text().splitlines()]
    assert sum("train_loss" in r for r in rows) == 4  # max_steps 4, log every step
    assert any("val_recall_mean_10" in r for r in rows)
    for r in rows:
        for k, v in r.items():
            if isinstance(v, float):
                assert math.isfinite(v), (k, v, r)
    neighbors = json.loads((save / "retokenizeText" / "keywords_ep2.json").read_text())
    assert neighbors and "neighbors" in neighbors[0]
    ck = save / "checkpoints"
    for name in ("last", "val_loss", "val_recall_mean_10"):
        assert any(p.name.isdigit() for p in (ck / name).iterdir()), name
    assert json.loads((ck / "fit_state.json").read_text()) == {
        "epoch": 2, "opt_step": 4, "batches_done": 0}
    assert json.loads((ck / "config.json").read_text())["data"]["dataset"]["dataset_root"] == root

    out = _cli("--test", "--device", "cpu", "--dataset_root", root, "--save_path",
               str(tmp_path / "eval"), "--resume", str(ck / "last"), "--njobs", "0")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "at step 4 epoch 2" in out.stderr
    assert "'val_recall_mean_10'" in out.stdout


def _run(argv, config=None):
    runner = TrainKWClip_GeneralTransformer()
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("task")
    runner.add_args(parser)
    runner.parse_args(parser, ["TrainKWClip_GeneralTransformer", *argv])
    return runner.run(config)


def test_cli_defaults_to_the_card():
    import argparse

    from speechclip_plus_tpu_torch.tasks.args import add_general_arguments

    assert add_general_arguments(argparse.ArgumentParser()).parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            main(["TrainKWClip_GeneralTransformer", "--config", os.path.join(REPO, TINY),
                  "--eval"])


@pytest.mark.parametrize("argv,error,match", [
    pytest.param(["--devices", "MORE", "--device", "cuda"], ValueError, "GPU", id="argv0-GPU"),
    pytest.param(["--ckpt", "exp/run/checkpoints"], NotImplementedError, "Lightning .ckpt",
                 id="argv1-Lightning .ckpt")])
def test_unported_options_raise(argv, error, match):
    # MORE: more GPUs than the machine shows, which raises before anything is
    # built (data parallelism itself runs: tests/test_torch_multihost.py)
    more = str(max(torch.cuda.device_count(), 1) + 1)
    argv = [more if a == "MORE" else a for a in argv]
    with pytest.raises(error, match=match):
        _run(["--config", os.path.join(REPO, TINY), "--device", "cpu", *argv])


@pytest.mark.parametrize("devices", ["1", "3"])
def test_tensor_parallel_must_divide_devices(tmp_path, devices):
    # as JAX's Trainer (tasks/trainer.py:71-76); tensor parallelism itself
    # runs: tests/test_torch_tp_cli.py
    cfg = load_config(os.path.join(REPO, TINY))
    cfg.trainer.tensor_parallel = 2
    with pytest.raises(ValueError, match="must divide --devices"):
        _run(["--device", "cpu", "--devices", devices, "--save_path", str(tmp_path)], cfg)
