"""Data parallelism over `torch.distributed` ranks, one process per device.

Port of ``speechclip_plus_tpu/parallel/mesh.py``. JAX shards the batch's
leading axis over a 1-D "data" mesh and runs one global-view program: XLA
all-gathers the projected features, so the contrastive loss sees the global
batch, psums the gradients, and takes the keyword-BN and VQ statistics over
the global batch (``parallel/train_step.py:1-13``, ``ops/losses.py:14-17``;
the reference gets the same from Lightning DP's gather, `kwClip.py:145-193`).
Here W processes each hold B/W contiguous rows of the global batch of B, and
the step says where the global view is needed:

  - `all_gather_rows(x, group)` concatenates every rank's rows in rank order.
    Its backward returns W times this rank's slice of this rank's gradient,
    with no collective: every rank computes the same global loss from the
    gathered tensor, so that slice is already exactly dL/dx_r.
  - `all_reduce_sum(x, group)` sums over the ranks; its backward is a sum
    all-reduce of the upstream gradient. It carries the keyword-BN moments.
  - `reduce_gradients` averages the parameter gradients over the ranks in
    one flat fp32 buffer, once per optimizer step. No
    `DistributedDataParallel`: its hooks fire under `.backward()`, and the
    step takes its gradients with `torch.autograd.grad`.

The convention behind the factor W: on rank r a tensor of this rank's rows
alone gets W times its share of dL, and the ranks' gradients of a tensor
that every rank holds (a parameter, a gathered feature, a global statistic)
sum to W times its dL. A gathered feature or a parameter the loss reads after
the gather (the contrastive temperature) gets its whole dL on every rank;
one read before it, its part through this rank's rows, times W. So the mean
over the ranks is exactly the gradient of the global loss (JAX's psum of a
global-view program) for every parameter, wherever the loss reads it. (The
common "GatherLayer" all-reduces the gathered gradient instead, and its
parameters' gradients need a per-parameter correction.)

Every helper is exact at W=1 (a sum over one rank, a weight of 1.0), so a
process group of one gives the group-less step's numbers bit for bit.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

__all__ = ["DataGroup", "make_mesh", "pad_batch", "shard_batch", "all_gather_rows",
           "all_reduce_sum", "global_mean", "global_moments", "reduce_gradients",
           "broadcast_module", "any_rank", "barrier", "CollectiveTimer"]


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """This process's place in the data-parallel group: its rank, the world
    size, the device it drives and the process group (None: the default)."""
    rank: int
    world: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None


def make_mesh(device=None) -> Optional[DataGroup]:
    """The 1-D data group of the initialized process group, or None without
    one (JAX builds no mesh for one device); under tensor parallelism the data
    group is `make_mesh_2d(tp).data()` (``parallel/tp.py``). `device` is the
    device this process drives; by default `cuda:LOCAL_RANK` under NCCL, else
    the CPU (``parallel/multihost.py``)."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    if device is None:
        from .multihost import local_device

        device = local_device()
    return DataGroup(rank=dist.get_rank(), world=dist.get_world_size(),
                     device=torch.device(device))


def _rows(x) -> int:
    return int(x.shape[0])


def pad_batch(batch: Dict, world: int) -> Dict:
    """Pad a host batch (numpy) whose row count is not a multiple of `world`
    with zero rows marked `valid=False`, as JAX's Trainer pads before sharding
    (``tasks/trainer.py:140-163``); the losses leave those rows out."""
    n = _rows(next(iter(batch.values())))
    pad = (-n) % world
    if not pad:
        return batch
    out = {k: np.asarray(v) for k, v in batch.items()}
    if "valid" not in out:
        out["valid"] = np.ones((n,), bool)
    out = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)]) for k, v in out.items()}
    out["valid"][n:] = False
    return out


def shard_batch(batch: Dict, group: Optional[DataGroup]) -> Dict:
    """This rank's contiguous rows [r B/W, (r+1) B/W) of every array of a
    global batch of B rows (B a multiple of W: `pad_batch` first)."""
    if group is None:
        return batch
    n = _rows(next(iter(batch.values())))
    if n % group.world:
        raise ValueError(f"a batch of {n} rows does not split over {group.world} ranks")
    per = n // group.world
    lo = group.rank * per
    return {k: v[lo: lo + per] for k, v in batch.items()}


def _gather(x: torch.Tensor, group: DataGroup) -> torch.Tensor:
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(wire) for _ in range(group.world)]
    dist.all_gather(parts, wire, group=group.group)
    out = torch.cat(parts, dim=0)
    return out.bool() if x.dtype == torch.bool else out


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.group.rank * ctx.rows
        g = g[lo: lo + ctx.rows]
        return (g * ctx.group.world if ctx.group.world > 1 else g), None


def all_gather_rows(x: torch.Tensor, group: Optional[DataGroup]) -> torch.Tensor:
    """Every rank's rows of `x` in rank order (the module docstring states the
    gradient, W times this rank's slice); `x` itself without a group."""
    if group is None:
        return x
    if x.requires_grad:
        return _AllGatherRows.apply(x, group)
    return _gather(x, group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group.group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group: Optional[DataGroup]) -> torch.Tensor:
    """Σ over the ranks of `x`, on every rank; the gradient is the sum of the
    ranks' upstream gradients. `x` itself without a group."""
    if group is None:
        return x
    if x.requires_grad:
        return _AllReduceSum.apply(x, group)
    y = x.clone()
    dist.all_reduce(y, group=group.group)
    return y


def global_mean(x: torch.Tensor, group: Optional[DataGroup]) -> torch.Tensor:
    """The mean over the ranks of a per-rank mean over equal row counts (a
    logged statistic): (Σ_r x_r) · (1/W), exact at W=1."""
    if group is None:
        return x
    return all_reduce_sum(x, group) * (1.0 / group.world)


def global_moments(mean: torch.Tensor, var: torch.Tensor, count, group: DataGroup):
    """Combine each rank's batch mean and biased variance of `count` rows
    into those of the global batch (Chan, Golub and LeVeque's pairwise
    update, never the sum of squares minus the squared sum):

        mean = Σ_r w_r mean_r,  var = Σ_r w_r (var_r + (mean_r - mean)²),
        w_r = count_r / Σ count.

    `count` is an int when every rank holds the same rows (the weights are
    then the host's 1/W), else a 0-d tensor (the length-aware BN). One
    all-reduce of the (W, 2C [+1]) table, each rank filling its row, carries
    the gradient back to every rank's moments. Returns (mean, var, global
    count as an int or a 0-d tensor clamped to 1); exact at W=1."""
    c = mean.shape[0]
    tensor_count = torch.is_tensor(count)
    cols = [mean, var] + ([count.reshape(1).to(mean.dtype)] if tensor_count else [])
    row = torch.cat(cols)[None, :]
    table = all_reduce_sum(F.pad(row, (0, 0, group.rank, group.world - group.rank - 1)), group)
    means, variances = table[:, :c], table[:, c: 2 * c]
    if tensor_count:
        counts = table[:, 2 * c]
        total = counts.sum().clamp_min(1.0)
        w = (counts / total)[:, None]
    else:
        total = int(count) * group.world
        w = 1.0 / group.world
    g_mean = (w * means).sum(dim=0)
    g_var = (w * (variances + (means - g_mean) ** 2)).sum(dim=0)
    return g_mean, g_var, total


class CollectiveTimer:
    """Seconds of each timed collective: CUDA events on the current stream
    around it (read once the caller has synchronized, so timing adds no
    host wait), the host clock on the CPU, where gloo blocks."""

    def __init__(self):
        self._open: List = []

    def start(self, device: torch.device):
        if device.type == "cuda":
            begin = torch.cuda.Event(enable_timing=True)
            begin.record()
            return begin
        return time.perf_counter()

    def stop(self, begin) -> None:
        if isinstance(begin, float):
            self._open.append(time.perf_counter() - begin)
            return
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self._open.append((begin, end))

    def collect(self) -> List[float]:
        """The seconds recorded since the last call (events synchronized)."""
        out = []
        for r in self._open:
            if not isinstance(r, float):
                r[1].synchronize()
                r = r[0].elapsed_time(r[1]) / 1e3
            out.append(r)
        self._open = []
        return out


def reduce_gradients(grads: Sequence[torch.Tensor], group: DataGroup,
                     timer: Optional[CollectiveTimer] = None) -> List[torch.Tensor]:
    """The mean over the ranks of every gradient (the module docstring: the
    gradient of the global loss), through one flat fp32 buffer (one
    all-reduce; the gradients are of fp32 master weights)."""
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    begin = timer.start(flat.device) if timer is not None else None
    dist.all_reduce(flat, group=group.group)
    if timer is not None:
        timer.stop(begin)
    if group.world > 1:
        flat = flat / group.world
    out, at = [], 0
    for g in grads:
        out.append(flat[at: at + g.numel()].view(g.shape).to(g.dtype))
        at += g.numel()
    return out


@torch.no_grad()
def broadcast_module(module: torch.nn.Module, group: Optional[DataGroup]) -> None:
    """Rank 0's parameters and floating-point buffers to every rank, in place
    (the rest are constants of the build); a tensor-parallel model's sharded
    parameters within their data column (``parallel/tp.py``)."""
    if getattr(module, "_tp", None) is not None:
        from .tp import broadcast_sharded_module

        broadcast_sharded_module(module)
        return
    if group is None:
        return
    for t in list(module.parameters()) + [b for b in module.buffers() if b.is_floating_point()]:
        dist.broadcast(t.data, src=0, group=group.group)


def any_rank(flag: bool, group: DataGroup) -> Callable[[], bool]:
    """Start a max all-reduce of `flag` over the ranks; returns the function
    that reads the result (True where any rank set it). On the GPU the result
    comes back through pinned memory behind an event, so reading it waits for
    the work queued before the reduction, not for what the host queued since."""
    t = torch.full((1,), int(bool(flag)), dtype=torch.int32, device=group.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group.group)
    if t.device.type != "cuda":
        return lambda: bool(t.item())
    host = torch.empty(1, dtype=torch.int32, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def read() -> bool:
        done.synchronize()
        return bool(host.item())

    return read


def barrier(group: Optional[DataGroup]) -> None:
    if group is not None:
        dist.barrier(group=group.group)
