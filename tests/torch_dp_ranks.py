"""Data-parallel cases of the port's training step, run by ranks on the CPU.

    python tests/torch_dp_ranks.py --world 2 --port P --out DIR [--weights W.pt]

spawns `--world` ranks. Each takes torchrun's variables, brings up a gloo
process group through `maybe_initialize_distributed(device="cpu")`, runs
every case of `CASES` on its rows of each global batch and writes
DIR/rank<r>.pt. `run_case(name)` runs a case in one process without a group,
the reference `tests/test_torch_parallel_dp.py` holds the ranks against.
Imports torch and the port only (no JAX), so a rank starts quickly.
"""
import argparse
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from speechclip_plus_tpu_torch.config import load_config  # noqa: E402
from speechclip_plus_tpu_torch.optim.optimizer import (  # noqa: E402
    build_optimizer_from_config, trainable_parameters)
from speechclip_plus_tpu_torch.parallel import mesh  # noqa: E402
from speechclip_plus_tpu_torch.parallel.multihost import maybe_initialize_distributed  # noqa: E402
from speechclip_plus_tpu_torch.parallel.train_step import (  # noqa: E402
    create_train_state, make_train_step, step_generators)
from speechclip_plus_tpu_torch.tasks.builder import build_model_from_config  # noqa: E402

TINY = os.path.join(REPO, "config", "dev", "tiny.yaml")
SEED = 3

# continuous: parallel branch only and no dropout (nothing couples the rows
# but the loss); hybrid: config/dev/tiny.yaml's hybrid+ (keyword BN, CIF, VQ)
CASES = {
    "continuous": dict(continuous=True, rows=8, steps=2),
    "hybrid": dict(rows=8, steps=1),
    "layer_drop": dict(rows=8, steps=2, layer_drop=0.5, dropout=True),
    "pad": dict(continuous=True, rows=7, steps=1),
    "accum": dict(continuous=True, rows=8, steps=2, accum=2),
    "jax": dict(continuous=True, rows=8, steps=1, weights=True),
}


# batch statistics the step logs (the VQ's, CIF's) and the quantity loss
LOGGED = ("train_quantity_loss", "train_prob_perplexity", "train_code_perplexity",
          "train_ent_per_t", "train_dsample_len_diff")


def config(name: str):
    """The tiny config of a case. The continuous one has no dropout
    anywhere, so that JAX's step and the one-process step draw nothing."""
    case = CASES[name]
    cfg = load_config(TINY)
    if case.get("continuous"):
        cfg.model_settings.cascaded_objective_weight = 0.0
        cfg.model_settings.parallel_branch.transformer_args.dropout = 0.0
        cfg.audio_encoder.frozen_dropout = False
    cfg.audio_encoder.layer_drop = case.get("layer_drop", 0.0)
    cfg.trainer.accumulate_grad_batches = case.get("accum", 1)
    return cfg


def global_batch(rows: int, step: int):
    """A ragged global batch of `rows` (seeded by the step), ids with repeats."""
    rng = np.random.RandomState(100 + step)
    t = 3200
    lens = rng.randint(2000, t + 1, size=rows)
    lens[0] = t
    wav = (0.3 * rng.randn(rows, t)).astype(np.float32)
    wav[np.arange(t)[None, :] >= lens[:, None]] = 0.0
    return {"wav": wav, "wav_len": lens.astype(np.int64),
            "id": rng.randint(0, 6, size=rows).astype(np.int64),
            "image": rng.randn(rows, 32, 32, 3).astype(np.float32)}


def run_case(name: str, group=None, weights=None):
    """The case's micro-steps; returns the losses, `grad_norm`s, the logged
    batch statistics (`LOGGED`), the gradients Adam was given, the LayerDrop
    draws, the number of gradient all-reduces, and the trainable tensors and
    keyword-BN statistics after."""
    case = CASES[name]
    cfg = config(name)
    model, _, _ = build_model_from_config(cfg, device="cpu", seed=0)
    if case.get("weights"):
        model.load_state_dict(torch.load(weights, weights_only=True))
    accum = case.get("accum", 1)
    optimizer = build_optimizer_from_config(model, cfg)
    state = create_train_state(optimizer)
    step_fn = make_train_step(model, optimizer, accum, group=group)
    out = {"loss": [], "grad_norm": [], "applied": [], "keep": [], "logs": [],
           "names": [n for n, _ in trainable_parameters(model)]}

    apply = optimizer.apply

    def recording_apply(grads, step):
        out["applied"].append([g.detach().clone() for g in grads])
        apply(grads, step)

    optimizer.apply = recording_apply
    tower_forward = model.audio_encoder.forward

    def recording_forward(*args, **kwargs):
        res = tower_forward(*args, **kwargs)
        if "layer_keep" in res:
            out["keep"].append(res["layer_keep"].clone())
        return res

    model.audio_encoder.forward = recording_forward
    for step in range(case["steps"] * accum):
        batch = global_batch(case["rows"], step)
        if group is not None:
            batch = mesh.shard_batch(mesh.pad_batch(batch, group.world), group)
        tbatch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        gens = step_generators(SEED, step, "cpu", group) if case.get("dropout") else (None,)
        metrics = step_fn(state, tbatch, *gens)
        out["loss"].append(float(metrics["train_loss"]))
        out["grad_norm"].append(float(metrics["grad_norm"]) if "grad_norm" in metrics else None)
        out["logs"].append({k: float(metrics[k]) for k in LOGGED if k in metrics})
    out["reductions"] = len(step_fn.timer.collect())
    keep = set(out["names"])
    out["state"] = {k: v.clone() for k, v in model.state_dict().items()
                    if k in keep or "running_" in k}
    return out


def _rank(rank: int, world: int, port: int, out_dir: str, weights) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(2)
    assert maybe_initialize_distributed(device="cpu")
    group = mesh.make_mesh("cpu")
    try:
        results = {name: run_case(name, group, weights) for name, case in CASES.items()
                   if weights is not None or not case.get("weights")}
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--weights", default=None)
    args = ap.parse_args(argv)
    import torch.multiprocessing as mp

    mp.start_processes(_rank, args=(args.world, args.port, args.out, args.weights),
                       nprocs=args.world, join=True, start_method="spawn")


if __name__ == "__main__":
    main()
