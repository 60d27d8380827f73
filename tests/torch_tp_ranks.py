"""Tensor-parallel cases of the port's training step, run by ranks on the CPU.

    python tests/torch_tp_ranks.py --world 4 --tp 2 --port P --out DIR [--weights W.pt]

spawns `--world` ranks on a (data, model) grid of `--tp` ranks to a model
group. Each brings up a gloo process group through
`maybe_initialize_distributed(device="cpu")`, shards the tiny model over its
model group (`parallel/tp.py`), runs every case of `CASES` on its data rank's
rows of each global batch and writes DIR/rank<r>.pt with the gradients Adam
was given and the trainable tensors after, gathered whole. `run_case(name)`
runs a case in one process without a group, the reference
`tests/test_torch_parallel_tp.py` holds the ranks against. Imports torch and
the port only (no JAX), so a rank starts quickly.
"""
import argparse
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

from speechclip_plus_tpu_torch.optim.optimizer import (  # noqa: E402
    build_optimizer_from_config, trainable_parameters)
from speechclip_plus_tpu_torch.parallel import mesh, tp  # noqa: E402
from speechclip_plus_tpu_torch.parallel.multihost import maybe_initialize_distributed  # noqa: E402
from speechclip_plus_tpu_torch.parallel.train_step import (  # noqa: E402
    create_train_state, make_train_step, step_generators)
from speechclip_plus_tpu_torch.tasks.builder import build_model_from_config  # noqa: E402
from torch_dp_ranks import LOGGED, SEED, config as dp_config, global_batch  # noqa: E402

# continuous: the parallel branch alone, no dropout; hybrid: the tiny hybrid+
# (keyword BN, CIF, K3 / K3b on the vocabulary shard); dropout: the continuous
# path with every dropout on (one data rank only: its masks are the one
# process's); jax: the continuous path from JAX's weights
CASES = {
    "continuous": dict(base="continuous", steps=2),
    "hybrid": dict(base="hybrid", steps=1),
    "dropout": dict(base="continuous", steps=1, dropout=True),
    "jax": dict(base="jax", steps=1, weights=True),
}


# tests/test_parallel_tp.py's schedule (:177-180): at warmup 10 the first
# step's rate is lr / 10, so a gradient that is rounding noise moves a
# parameter by at most 2e-4 (Adam's sign), under that file's 5e-4
JAX_SCHEDULE = {"warmup": 10, "max_step": 100, "final_lr": 1e-8}


def config(name: str):
    case = CASES[name]
    cfg = dp_config(case["base"])
    if case.get("dropout"):
        cfg.model_settings.parallel_branch.transformer_args.dropout = 0.1
        cfg.audio_encoder.frozen_dropout = True
    if case.get("weights"):
        for k, v in JAX_SCHEDULE.items():
            setattr(cfg.audio_encoder.scheduler, k, v)
    return cfg


def run_case(name: str, mg=None, weights=None):
    """The case's steps: the losses, `grad_norm`s, the logged batch
    statistics, the whole gradients Adam was given, and the whole trainable
    tensors and keyword-BN statistics after."""
    case = CASES[name]
    cfg = config(name)
    model, _, _ = build_model_from_config(cfg, device="cpu", seed=0)
    if case.get("weights"):
        model.load_state_dict(torch.load(weights, weights_only=True))
    group = None
    if mg is not None:
        tp.shard_model(model, mg)
        group = mg.data()
    optimizer = build_optimizer_from_config(model, cfg)
    state = create_train_state(optimizer)
    step_fn = make_train_step(model, optimizer, 1, group=group)
    named = trainable_parameters(model)
    plan = getattr(model, "_tp", None)
    out = {"loss": [], "grad_norm": [], "applied": [], "logs": [],
           "names": [n for n, _ in named]}
    apply = optimizer.apply

    def recording_apply(grads, step):
        whole = [g if plan is None else tp._gather_named(n, g, plan.plan.get(n), mg)
                 for (n, _), g in zip(named, grads)]
        out["applied"].append([g.detach().clone() for g in whole])
        apply(grads, step)

    optimizer.apply = recording_apply
    for step in range(case["steps"]):
        batch = global_batch(8, step)
        if group is not None:
            batch = mesh.shard_batch(mesh.pad_batch(batch, group.world), group)
        tbatch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        gens = step_generators(SEED, step, "cpu", group) if case.get("dropout") else (None,)
        metrics = step_fn(state, tbatch, *gens)
        out["loss"].append(float(metrics["train_loss"]))
        out["grad_norm"].append(float(metrics["grad_norm"]))
        out["logs"].append({k: float(metrics[k]) for k in LOGGED if k in metrics})
    keep = set(out["names"])
    out["state"] = {k: v.clone() for k, v in tp.gather_state_dict(model).items()
                    if k in keep or "running_" in k}
    out["shards"] = {n: tuple(p.shape) for n, p in model.named_parameters()}
    out["adam_shapes"] = {n: tuple(optimizer.adam.state[p]["exp_avg"].shape) for n, p in named}
    return out


def _rank(rank: int, world: int, tp_size: int, port: int, out_dir: str, weights) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    assert maybe_initialize_distributed(device="cpu")
    mg = tp.make_mesh_2d(tp_size, "cpu")
    try:
        results = {name: run_case(name, mg, weights) for name, case in CASES.items()
                   if (weights is not None or not case.get("weights"))
                   and (mg.data_world == 1 or not case.get("dropout"))}
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--weights", default=None)
    args = ap.parse_args(argv)
    import torch.multiprocessing as mp

    mp.start_processes(_rank, args=(args.world, args.tp, args.port, args.out, args.weights),
                       nprocs=args.world, join=True, start_method="spawn")


if __name__ == "__main__":
    main()
