"""Data parallelism on the card: a process group of one under NCCL gives the
group-less training step bit for bit (a `cuda` test; it skips without a card).

hybrid+ base (config/speechclip_plus/base/hybrid_plus.yaml, bf16, seeded
random weights) takes 2 steps with dropout on at B=8 x 32000 samples and
cached image features, once without a group and once under NCCL at world
size 1 (every collective of `parallel/mesh.py` runs: the parameter
broadcast, the loss features' gather, the keyword-BN moments, the VQ
statistics, the gradient all-reduce); the losses, `grad_norm`, the
parameters and the keyword-BN statistics must be equal. Tensor parallelism:
two gloo ranks of one model group sharing the card
(`maybe_initialize_distributed(device="cuda", backend="gloo")`) take the same
2 steps with the model sharded (`parallel/tp.py`: the tower by head, the FFNs
column / row, K3 / K3b on the vocabulary shard); their losses and `grad_norm`
against the one process within chip_smoke's R1 limits, and the two ranks
equal. Imports torch and the port only: `python -m pytest --noconftest -m cuda
tests/test_torch_cuda_dp.py`.
"""
import os

import pytest
import torch

from speechclip_plus_tpu_torch.config import load_config
from speechclip_plus_tpu_torch.optim.optimizer import build_optimizer_from_config
from speechclip_plus_tpu_torch.parallel.mesh import make_mesh
from speechclip_plus_tpu_torch.parallel.multihost import maybe_initialize_distributed
from speechclip_plus_tpu_torch.parallel.tp import make_mesh_2d, shard_model
from speechclip_plus_tpu_torch.parallel.train_step import (create_train_state, make_train_step,
                                                           step_generators)
from speechclip_plus_tpu_torch.tasks.base_task import free_port
from speechclip_plus_tpu_torch.tasks.builder import build_model_from_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "config", "speechclip_plus", "base", "hybrid_plus.yaml")
# chip_smoke.py's R1 limits on the tp=2 step against the one process (set
# there between the readings of the sound step and of planted faults)
TP_LOSS_RTOL, TP_GRAD_NORM_RTOL = 2e-3, 1.5e-4


def _steps(group, n=2, b=8, t=32000, model_group=None):
    cfg = load_config(CONFIG)
    model, _, _ = build_model_from_config(cfg, device="cuda", seed=0)
    if model_group is not None:
        shard_model(model, model_group)
    optimizer = build_optimizer_from_config(model, cfg)
    state = create_train_state(optimizer)
    step_fn = make_train_step(model, optimizer, 1, group=group)
    gen = torch.Generator(device="cuda").manual_seed(3)
    wav = torch.randn(b, t, generator=gen, device="cuda")
    wav_len = t - torch.randint(0, t // 3, (b,), generator=gen, device="cuda")
    wav = wav.masked_fill(torch.arange(t, device="cuda")[None] >= wav_len[:, None], 0.0)
    image = torch.randn(b, 224, 224, 3, generator=gen, device="cuda")
    with torch.no_grad():
        batch = {"wav": wav, "wav_len": wav_len, "id": torch.arange(b, device="cuda"),
                 "image_feat": model.encode_image_raw(image)}
    metrics = []
    for step in range(n):
        m = step_fn(state, batch, *step_generators(7, step, "cuda", group))
        metrics.append({k: float(m[k]) for k in ("train_loss", "grad_norm")})
    torch.cuda.synchronize()
    return metrics, {k: v.detach().cpu() for k, v in model.state_dict().items()}, step_fn


@pytest.mark.cuda
def test_nccl_world_one_equals_no_group():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    alone, alone_state, _ = _steps(None)
    env = {"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port())}
    assert maybe_initialize_distributed(env=env, device="cuda")
    try:
        group = make_mesh()
        assert group.world == 1 and group.device.type == "cuda"
        grouped, grouped_state, step_fn = _steps(group)
    finally:
        torch.distributed.destroy_process_group()
    assert grouped == alone
    assert len(step_fn.timer.collect()) == 2  # one gradient all-reduce a step
    differ = [k for k in alone_state if not torch.equal(alone_state[k], grouped_state[k])]
    assert not differ, differ[:8]


def _tp_rank(rank, port, out):
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    os.environ.pop("LOCAL_RANK", None)  # both ranks drive cuda:0
    assert maybe_initialize_distributed(device="cuda", backend="gloo")
    try:
        mg = make_mesh_2d(2)
        metrics, _, _ = _steps(mg.data(), model_group=mg)
        torch.save(metrics, os.path.join(out, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.cuda
def test_two_gloo_ranks_of_a_model_group_on_one_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.multiprocessing as mp

    alone, _, _ = _steps(None)
    mp.start_processes(_tp_rank, args=(free_port(), str(tmp_path)), nprocs=2, join=True,
                       start_method="spawn")
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    assert ranks[0] == ranks[1]
    for step, (got, want) in enumerate(zip(ranks[0], alone)):
        for key, rtol in (("train_loss", TP_LOSS_RTOL), ("grad_norm", TP_GRAD_NORM_RTOL)):
            rel = abs(got[key] - want[key]) / abs(want[key])
            print(f"step {step + 1} {key}: tp=2 {got[key]!r} vs one process {want[key]!r}, "
                  f"relative {rel:.3e}")
            assert rel <= rtol, (step + 1, key, rel)
