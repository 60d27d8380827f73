"""`trainer.tensor_parallel: 2` through the port's task CLI on the CPU.

`python -m speechclip_plus_tpu_torch.run_task TrainKWClip_GeneralTransformer
--train --device cpu --devices 2` with the tiny hybrid+ config and
`trainer.tensor_parallel: 2` spawns two gloo ranks, one model group (the
acoustic tower by head, the FFNs column / row, the token table by
vocabulary, K3 / K3b on the shards): it fits 2 steps, validates and saves a
checkpoint of whole tensors (the shapes of the unsharded model's, Adam's
moments too). That checkpoint then resumes at tp=2 (`--eval --devices 2
--resume`) and loads at tp=1 (`--eval --resume` with the same YAML at
`tensor_parallel: 1`), and both validate to the same metrics within 1e-5
(the fp32 summation order of the row-parallel products). This replaces the
refusal `test_torch_task_cli.py` held before tensor parallelism was ported.
"""
import json
import os
import subprocess
import sys

import torch
import yaml

from speechclip_plus_tpu_torch.config import load_config
from speechclip_plus_tpu_torch.tasks.builder import build_model_from_config
from test_torch_data import write_flickr_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "config", "dev", "tiny.yaml")


def _config(path, tp):
    cfg = load_config(TINY)
    cfg.trainer.max_steps = 2
    cfg.trainer.tensor_parallel = tp
    with open(path, "w") as f:
        yaml.safe_dump(cfg.to_dict(), f)
    return str(path)


def _run(config, root, save, *extra):
    out = subprocess.run(
        [sys.executable, "-m", "speechclip_plus_tpu_torch.run_task",
         "TrainKWClip_GeneralTransformer", "--config", config, "--device", "cpu",
         "--dataset_root", root, "--save_path", str(save), "--njobs", "0", "--seed", "1",
         *extra], cwd=REPO, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-4000:]
    with open(os.path.join(save, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_tensor_parallel_fits_saves_and_resumes_at_either_tp(tmp_path):
    root = write_flickr_tree(tmp_path / "flickr")
    tp2, tp1 = _config(tmp_path / "tp2.yaml", 2), _config(tmp_path / "tp1.yaml", 1)
    rows = _run(tp2, root, tmp_path / "fit", "--train", "--devices", "2")
    assert sum("train_loss" in r for r in rows) == 2
    assert any("val_recall_mean_10" in r for r in rows)
    ck = tmp_path / "fit" / "checkpoints"
    with open(ck / "fit_state.json") as f:
        assert json.load(f)["opt_step"] == 2
    saved = torch.load(ck / "last" / "2" / "state.pt", weights_only=True)
    whole = build_model_from_config(load_config(tp1), device="cpu", seed=1)[0]
    assert {k: tuple(v.shape) for k, v in saved["model"].items()} == \
        {k: tuple(v.shape) for k, v in whole.state_dict().items()}
    trainable = [p for p in whole.parameters() if p.requires_grad]
    for i, entry in saved["optimizer"]["state"].items():
        assert entry["exp_avg"].shape == trainable[int(i)].shape

    at2 = _run(tp2, root, tmp_path / "eval2", "--eval", "--devices", "2", "--resume",
               str(ck / "last"))[-1]
    at1 = _run(tp1, root, tmp_path / "eval1", "--eval", "--resume", str(ck / "last"))[-1]
    val = [r for r in rows if "val_loss" in r][-1]
    for key in ("val_loss", "val_c_cl_loss", "val_p_cl_loss", "val_recall_mean_10"):
        assert abs(at2[key] - at1[key]) <= 1e-5 * max(abs(at1[key]), 1.0), key
        assert abs(at2[key] - val[key]) <= 1e-5 * max(abs(val[key]), 1.0), key
