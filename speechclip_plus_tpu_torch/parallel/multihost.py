"""Multi-process start-up: the process group from the environment.

Port of ``speechclip_plus_tpu/parallel/multihost.py``. JAX runs one process
per host over all of its devices; here one process drives one device, so a
run on N GPUs is N processes, started by `torchrun`, by a cluster launcher
through the JAX package's variables, or by `run_task --devices N`
(``tasks/base_task.py``), which spawns N ranks on this host.

`maybe_initialize_distributed` reads, first match wins:

  SPEECHCLIP_MULTIHOST=auto     torchrun's variables below, which must be set
                                (a TPU pod's metadata has no GPU counterpart);
  SPEECHCLIP_COORDINATOR=host:port, SPEECHCLIP_NUM_PROCESSES=N,
  SPEECHCLIP_PROCESS_ID=i       JAX's explicit contract;
  RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT
                                torchrun's.

The process drives `cuda:LOCAL_RANK` under NCCL (without LOCAL_RANK, the rank
modulo the visible GPUs; a LOCAL_RANK past them raises); `device="cpu"`, the
caller's `--device cpu`, selects gloo and the CPU.
A collective that waits longer than `timeout_s` fails the run instead of
hanging it.
"""
from __future__ import annotations

import datetime
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["maybe_initialize_distributed", "make_global_batch", "local_device",
           "distributed_env", "cuda_index", "TORCHRUN_VARS"]

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")

_device: Optional[torch.device] = None


def distributed_env(env: Optional[Dict[str, str]] = None) -> Optional[Dict]:
    """(rank, world, local_rank, init_method) from the environment, or None
    when it asks for no process group; local_rank is None without LOCAL_RANK.
    Raises on an incomplete contract."""
    e = os.environ if env is None else env
    mode = e.get("SPEECHCLIP_MULTIHOST", "").lower()
    if mode == "auto":
        missing = [k for k in TORCHRUN_VARS if not e.get(k)]
        if missing:
            raise RuntimeError(
                "SPEECHCLIP_MULTIHOST=auto reads torchrun's variables on GPUs; "
                f"{', '.join(missing)} not set")
    coord = e.get("SPEECHCLIP_COORDINATOR")
    if mode != "auto" and coord:
        rank = int(e["SPEECHCLIP_PROCESS_ID"])
        world = int(e["SPEECHCLIP_NUM_PROCESSES"])
        init = f"tcp://{coord}"
    elif e.get("WORLD_SIZE"):
        missing = [k for k in TORCHRUN_VARS if not e.get(k)]
        if missing:
            raise RuntimeError(f"WORLD_SIZE is set but {', '.join(missing)} not")
        rank, world = int(e["RANK"]), int(e["WORLD_SIZE"])
        init = f"tcp://{e['MASTER_ADDR']}:{e['MASTER_PORT']}"
    else:
        return None
    local = e.get("LOCAL_RANK")
    return {"rank": rank, "world": world, "local_rank": int(local) if local else None,
            "init_method": init}


def cuda_index(spec: Dict, count: int) -> int:
    """The GPU this process drives among the `count` visible: LOCAL_RANK, or
    without it the rank modulo `count`. A LOCAL_RANK past the visible GPUs
    raises (two ranks would share a card)."""
    if spec["local_rank"] is None:
        return spec["rank"] % count
    if not 0 <= spec["local_rank"] < count:
        raise RuntimeError(f"LOCAL_RANK={spec['local_rank']}, but this host shows {count} GPU(s)")
    return spec["local_rank"]


def maybe_initialize_distributed(env: Optional[Dict[str, str]] = None, device: str = "cuda",
                                 timeout_s: float = 600.0, backend: Optional[str] = None) -> bool:
    """Initialize `torch.distributed` from the environment (idempotent).
    Returns True when a process group is (already) up. `device` is the
    caller's `--device`: `cuda` (NCCL, `cuda:LOCAL_RANK`) or `cpu` (gloo).
    `backend` None takes that pairing; `"gloo"` with `device="cuda"` lets
    ranks share one card (NCCL refuses two ranks on one device), for a
    check on a one-GPU machine: nothing in the package asks for it."""
    global _device
    if dist.is_initialized():
        return True
    spec = distributed_env(env)
    if spec is None:
        return False
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a process group on `cuda` needs a CUDA device")
        _device = torch.device("cuda", cuda_index(spec, torch.cuda.device_count()))
        torch.cuda.set_device(_device)
        backend = backend or "nccl"
    elif kind == "cpu":
        _device = torch.device("cpu")
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} on the CPU (gloo)")
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {device!r}")
    dist.init_process_group(backend, init_method=spec["init_method"], rank=spec["rank"],
                            world_size=spec["world"],
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def local_device() -> torch.device:
    """The device this process drives under its process group."""
    if _device is None:
        raise RuntimeError("no process group was initialized by maybe_initialize_distributed")
    return _device


def make_global_batch(batch: Dict, group, device=None) -> Dict[str, torch.Tensor]:
    """Each process passes its LOCAL rows (global batch / world) and gets them
    as tensors on its device, one copy each (through pinned memory to a GPU):
    the step sees the global batch through its collectives (JAX's name and
    meaning). `device` defaults to the group's, else the CPU."""
    if device is None:
        device = group.device if group is not None else "cpu"
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out
