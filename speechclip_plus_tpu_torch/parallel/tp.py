"""Tensor parallelism over a 2-D ("data", "model") grid of ranks.

Port of ``speechclip_plus_tpu/parallel/tp.py``. JAX writes Megatron-style
tensor parallelism as sharding annotations and lets XLA's SPMD partitioner
insert the collectives; here each process holds its shard of every sharded
parameter and the modules call the collectives themselves:

  - `copy_to_model` (identity forward, sum all-reduce of the gradient) goes
    in front of a column-parallel product, whose input every model rank
    holds whole and whose input gradient each rank has only a part of;
  - `reduce_from_model` (sum all-reduce forward, identity backward) goes
    after a row-parallel product, whose fp32 partial sums it adds up before
    the bias is added once and the result rounded once;
  - `gather_from_model` (all-gather forward; the backward returns this
    rank's slice, without a sum, since every model rank computed the same
    gradient of the gathered tensor) serves the plain VQ route, which reads
    the whole token table (XLA gathers it for JAX too).

Ranks [d·tp, (d+1)·tp) form model group d (`make_mesh_2d`); ranks with the
same model rank form a data group, over which the batch is split and the
gradients are averaged (``parallel/mesh.py``). The sharding, by parameter
name (`param_partition_spec`, the port's names for JAX's table):

  - column-parallel (the output dimension): HuBERT's packed
    `self_attn.in_proj_weight` / `in_proj_bias`, by head across q, k and v
    alike, HuBERT's `fc1`, CLIP's `c_fc`, and the branch and mel
    transformers' `linear1`;
  - row-parallel (the contraction dimension, the bias replicated): HuBERT's
    `self_attn.out_proj.weight`, `fc2`, `c_proj`, `linear2`;
  - the vocabulary: `token_embedding.weight`, on V;
  - replicated: the CLIP and branch attentions, everything else, and any
    dimension the model-axis size does not divide. One deviation from JAX:
    HuBERT's attention is sharded by whole heads, so a `tp` that divides D
    but not the head count keeps that layer's attention replicated.

`shard_model` keeps this rank's slice of every sharded parameter in place
and tells each module which of its products are sharded; Adam built after it
holds shard-local moments (JAX's `train_state_shardings`). `gather_state_dict`
and `gather_optimizer_state` return full tensors (the checkpoint is
independent of `tp`), `load_full_state_dict` and `shard_optimizer_state` cut
them to this rank's shards. Every helper is the identity without a model
group, and nothing of this module runs at `tensor_parallel: 1`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .mesh import DataGroup

__all__ = ["ModelGroup", "make_mesh_2d", "param_partition_spec",
           "partition_plan", "shard_model", "model_group_of", "copy_to_model",
           "reduce_from_model", "gather_from_model", "all_gather_model", "all_reduce_model",
           "partial_product", "row_parallel_linear", "dropout_columns", "shard_tensor",
           "gather_state_dict", "gather_optimizer_state", "load_full_state_dict",
           "shard_optimizer_state",
           "full_parameter", "sharded_global_norm", "broadcast_sharded_module"]

# column-parallel: the output dimension of the weight (torch's (out, in)) and the bias
_COLUMN = {"fc1", "c_fc", "linear1"}
# row-parallel: the contraction dimension of the weight; the bias stays replicated
_ROW = {"fc2", "c_proj", "linear2"}


@dataclasses.dataclass(frozen=True)
class ModelGroup:
    """This process's place on the (data, model) grid: its data rank and
    world, its model rank and world, the device it drives and one process
    group per axis (this rank's data column and its model group)."""
    data_rank: int
    data_world: int
    model_rank: int
    model_world: int
    device: torch.device
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    def data(self) -> DataGroup:
        """The data group (``parallel/mesh.py``) of this rank's column."""
        return DataGroup(rank=self.data_rank, world=self.data_world, device=self.device,
                         group=self.data_group)

    @property
    def global_rank(self) -> int:
        return self.data_rank * self.model_world + self.model_rank


_MESHES: Dict[Tuple[int, int], Tuple] = {}


def make_mesh_2d(tp: int, device=None) -> ModelGroup:
    """The (data, model) grid of the initialized process group with `tp`
    ranks to a model group: ranks [d·tp, (d+1)·tp) are model group d.
    Raises unless `tp` divides the world (JAX ``:77-78``). The process groups
    are made once per (tp, world) and every rank must call this together."""
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(f"tensor_parallel={tp} needs a process group of a multiple of {tp} "
                         "ranks (run_task --devices N, or torchrun)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if tp <= 0 or world % tp:
        raise ValueError(f"tp_size {tp} must divide device count {world}")
    if device is None:
        from .multihost import local_device

        device = local_device()
    key = (tp, world)
    if key not in _MESHES:
        # every rank creates every group, in one order (torch.distributed's contract)
        models = [dist.new_group(list(range(d * tp, (d + 1) * tp))) for d in range(world // tp)]
        datas = [dist.new_group(list(range(m, world, tp))) for m in range(tp)]
        _MESHES[key] = (models, datas)
    models, datas = _MESHES[key]
    return ModelGroup(data_rank=rank // tp, data_world=world // tp, model_rank=rank % tp,
                      model_world=tp, device=torch.device(device),
                      data_group=datas[rank % tp], model_group=models[rank // tp])


# ------------------------------------------------------------ collectives ----

def all_reduce_model(t: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    """Σ over the model group of `t`, in place, returned. (gloo, which two
    ranks sharing one card take, carries CUDA tensors itself.)"""
    dist.all_reduce(t, group=mg.model_group)
    return t


def all_gather_model(t: torch.Tensor, mg: ModelGroup) -> List[torch.Tensor]:
    """Every model rank's `t`, in rank order (column order of a shard)."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mg.model_world)]
    dist.all_gather(parts, t, group=mg.model_group)
    return parts


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_model(g.clone(), ctx.mg), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg):
        return all_reduce_model(x.clone(), mg)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg, dim):
        ctx.mg, ctx.dim, ctx.n = mg, dim, x.shape[dim]
        return torch.cat(all_gather_model(x, mg), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.mg.model_rank * ctx.n, ctx.n), None, None


def copy_to_model(x: torch.Tensor, mg: Optional[ModelGroup]) -> torch.Tensor:
    """`x` itself; its gradient is summed over the model group (in front of
    a column-parallel product)."""
    if mg is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToModel.apply(x, mg)


def reduce_from_model(x: torch.Tensor, mg: Optional[ModelGroup]) -> torch.Tensor:
    """Σ over the model group of `x` (after a row-parallel product); the
    gradient passes through unchanged."""
    if mg is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromModel.apply(x, mg)
    return all_reduce_model(x.clone(), mg)


def gather_from_model(x: torch.Tensor, mg: Optional[ModelGroup], dim: int = 0) -> torch.Tensor:
    """The model ranks' `x` concatenated along `dim` in rank order; the
    gradient is this rank's slice of the (model-replicated) gradient."""
    if mg is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherFromModel.apply(x, mg, dim)
    return torch.cat(all_gather_model(x, mg), dim=dim)


def _mm_fp32_out(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) · w (N, K)ᵀ in fp32 from 16-bit operands: on the card one
    tensor-core GEMM with fp32 accumulation and output; on the CPU, which has
    none, the same products of the operands' values in fp32."""
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cuda":
        y = torch.mm(x2, w.t(), out_dtype=torch.float32)
    else:
        y = torch.mm(x2.float(), w.float().t())
    return y.reshape(*x.shape[:-1], w.shape[0])


class _PartialProduct(torch.autograd.Function):
    """A row-parallel partial product, fp32 out of 16-bit operands. The
    backward takes the products F.linear's backward takes, in the operands'
    dtype: the cotangent of a result that is rounded to that dtype after the
    sum is exact in it."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_fp32_out(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = g @ w if ctx.needs_input_grad[0] else None
        dw = (g.reshape(-1, g.shape[-1]).t() @ x.reshape(-1, x.shape[-1])
              if ctx.needs_input_grad[1] else None)
        return dx, dw


def partial_product(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x (..., K) · weight (N, K)ᵀ in fp32: F.linear for fp32 operands, one
    GEMM with fp32 output (`_PartialProduct`) for bf16 / fp16 ones."""
    if x.dtype == torch.float32:
        return F.linear(x, weight)
    return _PartialProduct.apply(x, weight)


def row_parallel_linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                        mg: ModelGroup, out_dtype: torch.dtype) -> torch.Tensor:
    """x (..., K/tp) · weight (N, K/tp)ᵀ summed over the model group, + bias:
    the partial products in fp32 (`partial_product`), the bias added once
    and the result rounded to `out_dtype` once (summing rounded partials
    would round twice where the whole product rounds once)."""
    y = reduce_from_model(partial_product(x, weight), mg)
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def dropout_columns(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
                    full: int, lo: int) -> torch.Tensor:
    """Inverted dropout on columns [lo, lo + x.shape[-1]) of a (..., full)
    activation: the whole-width mask is drawn as ``nn/dropout.py`` draws it
    and this rank's columns kept, so the draw stream and the mask are those
    of the unsharded step."""
    if rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.empty((*x.shape[:-1], full), dtype=x.dtype, device=x.device).bernoulli_(
        keep, generator=generator)
    return x * mask[..., lo: lo + x.shape[-1]] / keep


# --------------------------------------------------------------- the plan ----

def param_partition_spec(name: str, shape: Sequence[int], tp: int,
                         heads: Optional[int] = None) -> Optional[int]:
    """The sharded dimension of parameter `name` (the port's dotted name)
    under `tp`-way tensor parallelism, or None (replicated). `heads` is the
    head count of the HuBERT attention the name belongs to (None outside
    HuBERT: the packed attentions of CLIP, the branches and the mel towers
    stay replicated, as JAX's `_PACKED_ATTN`); its packed in-projection is
    sharded by head (dimension 0, q, k and v alike: `shard_tensor`)."""
    keys = name.split(".")
    if tp <= 1 or len(shape) == 0 or len(keys) < 2:
        return None
    leaf, mod = keys[-1], keys[-2]
    if mod == "token_embedding" and leaf == "weight":
        return 0 if shape[0] % tp == 0 else None
    if "self_attn" in keys:
        if heads is None or heads % tp:
            return None
        if mod == "self_attn" and leaf in ("in_proj_weight", "in_proj_bias"):
            return 0
        if mod == "out_proj" and leaf == "weight":
            return 1
        return None
    if mod in _COLUMN and leaf in ("weight", "bias") and shape[0] % tp == 0:
        return 0
    if mod in _ROW and leaf == "weight" and len(shape) == 2 and shape[1] % tp == 0:
        return 1
    return None


def _hubert_heads(model: nn.Module) -> Dict[str, int]:
    """Module prefix -> head count of every HuBERT encoder layer."""
    from ..models.hubert import HubertEncoderLayer

    return {name: mod.cfg.n_heads for name, mod in model.named_modules()
            if isinstance(mod, HubertEncoderLayer)}


def partition_plan(model: nn.Module, tp: int) -> Dict[str, Optional[int]]:
    """`param_partition_spec` of every parameter of `model` (full shapes)."""
    heads = _hubert_heads(model)
    plan = {}
    for name, p in model.named_parameters():
        owner = next((pre for pre in heads if name.startswith(pre + ".self_attn.")), None)
        plan[name] = param_partition_spec(name, tuple(p.shape), tp,
                                          heads[owner] if owner is not None else None)
    return plan


def _packed(name: str) -> bool:
    return name.endswith(("in_proj_weight", "in_proj_bias"))


def shard_tensor(name: str, full: torch.Tensor, spec: Optional[int], rank: int,
                 tp: int) -> torch.Tensor:
    """Rank `rank`'s shard of the whole tensor `full` under `spec`; a packed
    in-projection (3D, ...) gives the rank's heads of q, k and v."""
    if spec is None:
        return full
    if _packed(name):
        parts = full.reshape(3, full.shape[0] // 3, *full.shape[1:])
        n = parts.shape[1] // tp
        return parts[:, rank * n: (rank + 1) * n].reshape(-1, *full.shape[1:])
    n = full.shape[spec] // tp
    return full.narrow(spec, rank * n, n)


def _unshard(name: str, parts: Sequence[torch.Tensor], spec: int) -> torch.Tensor:
    if _packed(name):
        return torch.cat([p.reshape(3, -1, *p.shape[1:]) for p in parts], dim=1).reshape(
            -1, *parts[0].shape[1:])
    return torch.cat(list(parts), dim=spec)


@dataclasses.dataclass
class _TPState:
    group: ModelGroup
    plan: Dict[str, Optional[int]]


def model_group_of(model: nn.Module) -> Optional[ModelGroup]:
    """The model group a `shard_model`-ed model runs over, else None."""
    st = getattr(model, "_tp", None)
    return None if st is None else st.group


@torch.no_grad()
def shard_model(model: nn.Module, mg: ModelGroup) -> Dict[str, Optional[int]]:
    """Keep this rank's shard of every sharded parameter of `model` in place
    (the same `nn.Parameter` objects) and mark the modules whose products
    run sharded; returns the plan (name -> sharded dimension). Call before
    the optimizer is built, so that Adam holds the shards."""
    from ..models.branches import SimpleVectorQuantizer
    from ..models.clip import ResidualAttentionBlock, TextTransformer
    from ..models.hubert import HubertEncoderLayer
    from ..nn.transformer import TransformerEncoderLayer

    if getattr(model, "_tp", None) is not None:
        raise ValueError("shard_model: the model is sharded already")
    tp = mg.model_world
    plan = partition_plan(model, tp)
    for name, p in model.named_parameters():
        if plan[name] is not None:
            p.data = shard_tensor(name, p.data, plan[name], mg.model_rank, tp).clone()
    vocab = plan.get("clip.text.token_embedding.weight") is not None
    for name, mod in model.named_modules():
        pre = name + "." if name else ""
        if isinstance(mod, HubertEncoderLayer):
            mod.tp_heads = plan[pre + "self_attn.in_proj_weight"] is not None
            mod.tp_ffn = plan[pre + "fc1.weight"] is not None
            mod.tp = mg if (mod.tp_heads or mod.tp_ffn) else None
            mod.self_attn.tp = mg if mod.tp_heads else None
        elif isinstance(mod, ResidualAttentionBlock):
            mod.tp = mg if plan[pre + "c_fc.weight"] is not None else None
        elif isinstance(mod, TransformerEncoderLayer):
            mod.tp = mg if plan[pre + "linear1.weight"] is not None else None
        elif isinstance(mod, (TextTransformer, SimpleVectorQuantizer)):
            mod.tp = mg if vocab else None
    model._tp = _TPState(group=mg, plan=plan)
    return plan


def _gather_named(name: str, t: torch.Tensor, spec: Optional[int],
                  mg: ModelGroup) -> torch.Tensor:
    if spec is None:
        return t
    return _unshard(name, all_gather_model(t.detach(), mg), spec)


def full_parameter(model: nn.Module, name: str) -> torch.Tensor:
    """The whole tensor of parameter `name` (a collective over the model
    group where it is sharded; every model rank must call it)."""
    t = dict(model.named_parameters())[name]
    st = getattr(model, "_tp", None)
    if st is None:
        return t
    return _gather_named(name, t, st.plan.get(name), st.group)


def gather_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """`model.state_dict()` with every sharded tensor whole (a collective
    over the model group; every model rank calls it)."""
    sd = model.state_dict()
    st = getattr(model, "_tp", None)
    if st is None:
        return sd
    return {k: _gather_named(k, v, st.plan.get(k), st.group) for k, v in sd.items()}


@torch.no_grad()
def load_full_state_dict(model: nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """Load whole tensors (a checkpoint of any `tp`) into a sharded model:
    each sharded one cut to this rank's shard."""
    st = getattr(model, "_tp", None)
    if st is not None:
        sd = {k: shard_tensor(k, v, st.plan.get(k), st.group.model_rank, st.group.model_world)
              for k, v in sd.items()}
    model.load_state_dict(sd)


def _trainable_specs(model: nn.Module) -> List[Tuple[str, Optional[int]]]:
    st = getattr(model, "_tp", None)
    return [(n, None if st is None else st.plan.get(n))
            for n, p in model.named_parameters() if p.requires_grad]


def gather_optimizer_state(opt_sd: Dict, model: nn.Module) -> Dict:
    """A torch Adam `state_dict` over `model`'s trainable parameters (in
    their order) with the moments of sharded parameters whole."""
    st = getattr(model, "_tp", None)
    if st is None:
        return opt_sd
    specs = _trainable_specs(model)
    state = {}
    for i, entry in opt_sd["state"].items():
        name, spec = specs[int(i)]
        state[i] = {k: (_gather_named(name, v, spec, st.group)
                        if torch.is_tensor(v) and v.ndim > 0 else v) for k, v in entry.items()}
    return {"state": state, "param_groups": opt_sd["param_groups"]}


def shard_optimizer_state(opt_sd: Dict, model: nn.Module) -> Dict:
    """The inverse of `gather_optimizer_state` for this rank."""
    st = getattr(model, "_tp", None)
    if st is None:
        return opt_sd
    specs = _trainable_specs(model)
    mg = st.group
    state = {}
    for i, entry in opt_sd["state"].items():
        name, spec = specs[int(i)]
        state[i] = {k: (shard_tensor(name, v, spec, mg.model_rank, mg.model_world).clone()
                        if torch.is_tensor(v) and v.ndim > 0 else v) for k, v in entry.items()}
    return {"state": state, "param_groups": opt_sd["param_groups"]}


def sharded_global_norm(grads: Sequence[torch.Tensor], sharded: Sequence[bool],
                        mg: ModelGroup) -> torch.Tensor:
    """The global 2-norm of a gradient whose `sharded` tensors are this
    rank's shards: their squares summed over the model group, each
    replicated tensor's counted once (optax.global_norm of the whole)."""
    zero = torch.zeros((), device=grads[0].device if grads else mg.device)
    part = sum((g.float().pow(2).sum() for g, s in zip(grads, sharded) if s), zero)
    rest = sum((g.float().pow(2).sum() for g, s in zip(grads, sharded) if not s), zero)
    return torch.sqrt(all_reduce_model(part.clone(), mg) + rest)


@torch.no_grad()
def broadcast_sharded_module(model: nn.Module) -> None:
    """Rank 0's replicated parameters and floating-point buffers to every
    rank, and each sharded parameter from data rank 0 to the same model rank
    of every model group, in place."""
    st = model._tp
    mg = st.group
    for name, t in model.named_parameters():
        if st.plan.get(name) is None:
            dist.broadcast(t.data, src=0)
        elif mg.data_world > 1:
            dist.broadcast(t.data, src=mg.model_rank, group=mg.data_group)
    for b in model.buffers():
        if b.is_floating_point():
            dist.broadcast(b.data, src=0)
