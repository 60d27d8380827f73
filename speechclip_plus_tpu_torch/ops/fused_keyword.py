"""Fused cosine-score -> VQ statistics (K3) and straight-through backward (K3b).

Port of ``speechclip_plus_tpu/ops/fused_keyword.py``: the keyword head's
cosine scores against the normalized CLIP token table and the statistics of
SimpleVectorQuantizer in its hard form, without an (N, V) tensor in device
memory, forward (Pallas `_fwd_kernel`, :92) and backward (`_bwd_kernel`,
:123, the straight-through estimator of `_st_gather`, :253-287).

`cosine_vq_stats` returns, for rows x (N, D) and the normalized table en
(V, D): the masked argmax k (N,), the per-row entropy ent (N,) and the column
sums of softmax(s) psum (V,). `st_backward` returns, for the keyword
cotangent g (N, D): dx = (dz / t) en and dt = Σ dz (-s / t²), with
u = (g enᵀ) ‖emb‖, p = softmax(s / t), dz = p (u - Σ p u). On a CUDA tensor
each runs its hand-written kernels in ``csrc/fused_keyword.cu``, over a grid
of (row tiles, V splits) that a cached plan (`_fwd_plan`, `_bwd_plan`)
chooses per shape so that every row count fills the card; on a CPU tensor
its plain PyTorch twin. The gather `emb[k]` and the perplexity and
entropy reductions stay plain torch, as they are XLA outside the kernel in
JAX (:334-366). The codebook gets no gradient: the configuration takes this
route only for a frozen token table (`model_settings.fused_score_kernel`),
and `fused_cosine_vq` refuses a table that requires one.

The temperature is a 0-d fp32 tensor on the rows' device, which K3b reads in
the kernel: a learnable temperature (`curr_temp`) takes K3b's dt as its
gradient, and no temperature, fixed, scheduled or learnable, is read back to
the host.

Under tensor parallelism (``parallel/tp.py``) each rank of a model group
holds a vocabulary shard of the table, and each kernel runs in two halves
around a gather over the group (`cosine_vq_stats_shard`, `st_backward_shard`):

  - K3: `vq_rows` runs pass 1 on the shard and merges its V splits into one
    row of statistics per keyword, its best index offset by the shard's
    first id; the rows of every shard, gathered in column order, are merged
    by `vq_combine` (the kernel's own split merge, with one split a shard:
    ties go to the lowest global id, as the unsharded argmax); `vq_cols` then
    runs pass 2 on the shard from the global (m, z), so psum is the shard's.
    The keywords' gather `emb[k]` becomes a masked local gather summed over
    the group (one rank holds each id).
  - K3b: `st_backward_stats` writes the shard's per-split statistics, the
    group gathers them in column order, and `st_backward_apply` merges them
    all and writes the shard's partial dx and dt, which the group sums.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Sequence

import torch

from ..parallel.mesh import global_mean

__all__ = ["cosine_vq_stats", "plain_cosine_vq_stats", "st_backward", "plain_st_backward",
           "fused_cosine_vq", "vq_rows", "vq_combine", "vq_cols", "plain_vq_rows",
           "plain_vq_combine", "plain_vq_cols", "cosine_vq_stats_shard", "st_backward_stats",
           "st_backward_apply", "plain_st_backward_stats", "plain_st_backward_apply",
           "st_backward_shard", "LAUNCHES", "BWD_LAUNCHES", "D768_LAUNCHES",
           "BWD_D768_LAUNCHES", "SHARD_LAUNCHES", "BWD_SHARD_LAUNCHES"]

# wrapper calls that ran the kernels on the card: K3 (forward), K3b (backward),
# and those of them at the large family's codebook width, D=768
LAUNCHES = 0
BWD_LAUNCHES = 0
D768_LAUNCHES = 0
BWD_D768_LAUNCHES = 0
# calls on a tensor-parallel vocabulary shard (rows, merge and columns: one)
SHARD_LAUNCHES = 0
BWD_SHARD_LAUNCHES = 0

_MASK_VALUE = -1e30
_INIT_MAX = -3e38  # the kernels' empty-set maximum (a shard with no live column)


def column_mask(v: int, prob_msk: Sequence[int], device, offset: int = 0) -> torch.Tensor:
    """(V,) int32, 1 at the excluded codebook ids; of the ids [offset,
    offset + V) of a vocabulary shard."""
    mask = torch.zeros(v, dtype=torch.int32)
    for i in prob_msk:
        if 0 <= int(i) - offset < v:
            mask[int(i) - offset] = 1
    return mask.to(device)


@functools.lru_cache(maxsize=16)
def _cached_mask(v: int, prob_msk: tuple, device, offset: int = 0) -> torch.Tensor:
    """`column_mask` made once per (V, ids, device, offset): building it copies
    from the host, which waits for the card. Made outside inference mode, so
    that a training step can save the mask a serving call made."""
    with torch.inference_mode(False):
        return column_mask(v, prob_msk, device, offset)


def plain_cosine_vq_stats(xn: torch.Tensor, en: torch.Tensor, mask: torch.Tensor):
    """Plain PyTorch twin of the kernels: fp32 scores from the operands'
    values (the TPU's bf16 x bf16 -> fp32 products), masked columns at -1e30."""
    s = xn.float() @ en.float().T
    s = s.masked_fill(mask.bool()[None, :], _MASK_VALUE)
    k = torch.argmax(s, dim=-1).to(torch.int32)
    m = s.max(dim=-1, keepdim=True).values
    e = torch.exp(s - m)
    z = e.sum(dim=-1, keepdim=True)
    ent = torch.log(z[:, 0]) - (e * (s - m)).sum(dim=-1) / z[:, 0]
    psum = (e / z).sum(dim=0)
    return k, ent, psum


def _launch(xn, en, mask):
    global LAUNCHES, D768_LAUNCHES
    from ..utils.cuda_build import check, kernels

    head, rows, splits = _fwd_args(xn, en, mask, "cosine_vq_stats")
    n, d, v = xn.shape[0], xn.shape[1], en.shape[0]
    lib = kernels()
    with torch.cuda.device(xn.device):
        scratch = _fwd_scratch(n, v, rows, splits, xn.device)
        k = torch.empty(n, dtype=torch.int32, device=xn.device)
        ent = torch.empty(n, dtype=torch.float32, device=xn.device)
        psum = torch.empty(v, dtype=torch.float32, device=xn.device)
        stream = torch.cuda.current_stream().cuda_stream
        check(lib.sc_vq_fwd_rows(*head, scratch["stats"].data_ptr(), scratch["best_i"].data_ptr(),
                                 k.data_ptr(), ent.data_ptr(), scratch["m"].data_ptr(),
                                 scratch["z"].data_ptr(), None, None, 0, stream),
              "cosine_vq_stats")
        check(lib.sc_vq_fwd_cols(*head, scratch["m"].data_ptr(), scratch["z"].data_ptr(),
                                 scratch["col_part"].data_ptr(), psum.data_ptr(), stream),
              "cosine_vq_stats")
    LAUNCHES += 1
    D768_LAUNCHES += d == 768
    return k, ent, psum


def cosine_vq_stats(xn: torch.Tensor, en: torch.Tensor, mask: torch.Tensor):
    """xn (N, D), en (V, D) in the compute dtype, mask (V,) int32 ->
    (k (N,) int32, ent (N,) fp32, psum (V,) fp32). No gradient (the
    statistics are taken on a stop-gradient basis, as in JAX)."""
    xn, en = xn.detach(), en.detach()
    if xn.device.type == "cpu":
        return plain_cosine_vq_stats(xn, en, mask)
    if xn.device.type != "cuda":
        raise NotImplementedError(f"cosine_vq_stats on {xn.device.type}")
    return _launch(xn, en, mask)


def plain_st_backward(xn, g, en, norms, mask, temp: torch.Tensor):
    """Plain PyTorch twin of K3b: fp32 products on the operands' values, with
    dz / t rounded to the compute dtype before its product, as the kernel.
    `temp` is a 0-d fp32 tensor (or a float). Returns (dx (N, D) fp32, dt ()
    fp32)."""
    temp = torch.as_tensor(temp, dtype=torch.float32, device=xn.device)
    live = ~mask.bool()[None, :]
    s = xn.float() @ en.float().T
    p = torch.softmax(torch.where(live, s / temp, -torch.inf), dim=-1)
    u = (g.float() @ en.float().T) * norms[None, :]
    dz = p * (u - (p * u).sum(dim=-1, keepdim=True))
    dz = torch.where(live, dz, 0.0)
    dt = (dz * (-s / (temp * temp))).sum()
    dx = (dz / temp).to(xn.dtype).float() @ en.float()
    return dx, dt


H100_SMS = 132
_BLOCK_OVERHEAD = 0.5  # a block's own loads and writes, in column tiles


def _best_splits(row_tiles: int, col_tiles: int, slots: int, scratch_per_split: int,
                 cap: int) -> int:
    """The split count of V whose blocks finish soonest on `slots` resident
    blocks: a block costs its column tiles plus a fixed overhead, the blocks
    run in whole waves, no split is empty and, beyond one split, the
    partials take at most `cap` bytes. Ties go to fewer splits."""
    best_cost, best = math.inf, 1
    for splits in range(1, col_tiles + 1):
        per = -(-col_tiles // splits)
        if -(-col_tiles // per) != splits:
            continue  # the last split would be empty
        if splits > 1 and splits * scratch_per_split > cap:
            break
        cost = -(-row_tiles * splits // slots) * (per + _BLOCK_OVERHEAD)
        if cost < best_cost:
            best_cost, best = cost, splits
    return best


def _check_width(what: str, d: int, dtype, max_d) -> None:
    if dtype not in max_d:
        raise TypeError(f"{what}: dtype {dtype}")
    if d <= 0 or d % 16 or d > max_d[dtype]:
        raise ValueError(f"{what}: D={d} must be a positive multiple of 16 and at most "
                         f"{max_d[dtype]} in {dtype}")


# K3's grid (csrc/fused_keyword.cu): blocks of `rows` keyword rows x one of
# `splits` ranges of whole codebook tiles, `_FWD_COLS` columns each
_FWD_COLS = {torch.bfloat16: 128, torch.float32: 64}  # the tensor-core tile, the FMA tile
_FWD_MAX_D = {torch.bfloat16: 768, torch.float32: 1024}
# resident blocks an SM: the tensor-core tile takes 178-217 KB of shared
# memory; the FMA tile 25-29 KB and 48 registers a thread
_FWD_BLOCKS_PER_SM = {torch.bfloat16: 1, torch.float32: 4}
FWD_SCRATCH_CAP = 16 << 20  # bytes of the splits' row statistics (5 x splits x N x 4)


def _fwd_rows(d: int, dtype) -> int:
    """Rows a K3 block: the tensor-core tile keeps them in shared memory
    beside a 74 KB codebook ring, 128 up to D=512 (217 KB) and 64 beyond (178
    KB at D=768); every block reads its split's codebook from L2 once, so
    128 rows halve that traffic. The FMA tile: 32."""
    return 32 if dtype == torch.float32 else 128 if d <= 512 else 64


@functools.lru_cache(maxsize=None)
def _fwd_plan(n: int, v: int, d: int, dtype=torch.bfloat16, sms: int = H100_SMS):
    """(rows, splits) of K3's grid for N rows, V codebook columns and width
    D (`_best_splits`: whole waves x tiles per split, at most
    FWD_SCRATCH_CAP bytes of split statistics). Raises on a width the
    kernels do not take: D a multiple of 16 (16-byte rows for `cp.async`
    and `ldmatrix`), at most 768 in bf16 (the x rows and the codebook ring in
    shared memory) or 1024 in fp32."""
    _check_width("cosine_vq_stats", d, dtype, _FWD_MAX_D)
    if n <= 0 or v <= 0:
        raise ValueError(f"cosine_vq_stats: N={n}, V={v}")
    rows = _fwd_rows(d, dtype)
    splits = _best_splits(-(-n // rows), -(-v // _FWD_COLS[dtype]),
                          sms * _FWD_BLOCKS_PER_SM[dtype], 5 * 4 * n, FWD_SCRATCH_CAP)
    return rows, splits


def _fwd_scratch(n: int, v: int, rows: int, splits: int, device) -> Dict[str, torch.Tensor]:
    """K3's scratch for a plan, two allocations: the splits' (m, z, w, best
    value) and best index per row, one column-sum partial per (row tile,
    column), and the combined m and z per row."""
    sizes = {"stats": 4 * splits * n, "col_part": -(-n // rows) * v, "m": n, "z": n}
    buf = torch.empty(sum(sizes.values()), dtype=torch.float32, device=device)
    out = dict(zip(sizes, buf.split(list(sizes.values()))))
    out["best_i"] = torch.empty(splits * n, dtype=torch.int32, device=device)
    return out


# K3b's grid (csrc/fused_keyword.cu): blocks of `rows` keyword rows x one of
# `splits` ranges of whole 64-column codebook tiles
_BWD_COLS = 64
_BWD_MAX_D = {torch.bfloat16: 768, torch.float32: 1024}
BWD_SCRATCH_CAP = 64 << 20  # bytes of partial dx (splits x N x D fp32) a plan may use


def _bwd_rows(d: int, dtype) -> int:
    """Rows a K3b block: the tensor-core tile keeps its x and g rows and one
    64-column codebook tile in shared memory, 64 rows up to D=512 (208 KB)
    and 32 beyond (201 KB at D=768); the FMA tile: 32."""
    return 32 if dtype == torch.float32 or d > 512 else 64


@functools.lru_cache(maxsize=None)
def _bwd_plan(n: int, v: int, d: int, dtype=torch.bfloat16, sms: int = H100_SMS):
    """(rows, splits) of K3b's grid for N rows, V codebook columns and width
    D (`_best_splits`: whole waves x tiles per split, at most
    BWD_SCRATCH_CAP bytes of partial dx). Raises on a width the kernels do
    not take: D a multiple of 16 (16-byte rows for `cp.async` and
    `ldmatrix`), at most 768 in bf16 (the dx accumulators of 8 warps x 96
    columns over 32 rows) or 1024 in fp32."""
    _check_width("st_backward", d, dtype, _BWD_MAX_D)
    if n <= 0 or v <= 0:
        raise ValueError(f"st_backward: N={n}, V={v}")
    rows = _bwd_rows(d, dtype)
    # one tensor-core block an SM (208 KB of shared memory at D=512, 201 KB
    # at D=768); two FMA blocks up to D=512
    slots = sms * (2 if dtype == torch.float32 and d <= 512 else 1)
    return rows, _best_splits(-(-n // rows), -(-v // _BWD_COLS), slots, n * d * 4,
                              BWD_SCRATCH_CAP)


def _bwd_scratch(n: int, d: int, rows: int, splits: int, device) -> Dict[str, torch.Tensor]:
    """K3b's scratch for a plan: the splits' (m, z, zu) per row, their partial
    dx (none for one split: the kernel writes dx itself) and one dt partial
    per block."""
    f32 = dict(dtype=torch.float32, device=device)
    return {"stats": torch.empty(3 * splits * n, **f32),
            "dx_part": torch.empty(splits * n * d if splits > 1 else 0, **f32),
            "dt_part": torch.empty(-(-n // rows) * splits, **f32)}


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_bwd(xn, g, en, norms, mask, temp):
    global BWD_LAUNCHES, BWD_D768_LAUNCHES

    if not torch.is_tensor(temp):
        temp = torch.full((), float(temp), dtype=torch.float32, device=xn.device)
    rows, splits = _bwd_args(xn, g, en, norms, mask, temp, "st_backward")
    with torch.cuda.device(xn.device):
        dx, dt = _run_bwd(xn, g, en, norms, mask, temp, rows, splits, None, splits, 3,
                          "st_backward")
    BWD_LAUNCHES += 1
    BWD_D768_LAUNCHES += xn.shape[1] == 768
    return dx, dt


def st_backward(xn: torch.Tensor, g: torch.Tensor, en: torch.Tensor, norms: torch.Tensor,
                mask: torch.Tensor, temp: torch.Tensor):
    """K3b: xn, g (N, D) and en (V, D) in the compute dtype, norms (V,) fp32
    = ‖emb‖, mask (V,) int32, temp a 0-d fp32 tensor > 0 on the same device
    (the kernel reads it; a temperature that is not positive gives a NaN dx)
    -> (dx (N, D) fp32, dt () fp32). A float temperature is put on the device
    first."""
    if xn.device.type == "cpu":
        return plain_st_backward(xn, g, en, norms, mask, temp)
    if xn.device.type != "cuda":
        raise NotImplementedError(f"st_backward on {xn.device.type}")
    return _launch_bwd(xn, g, en, norms, mask, temp)


# ------------------------------------------- a tensor-parallel vocabulary shard ----

def _check_fwd(what, xn, en, mask):
    """K3's inputs: one dtype, matching shapes, contiguous on one device,
    16-byte aligned rows; returns (N, D, V)."""
    n, d = xn.shape
    v = en.shape[0]
    if xn.dtype not in (torch.float32, torch.bfloat16) or en.dtype != xn.dtype:
        raise TypeError(f"{what}: dtypes {xn.dtype}, {en.dtype}")
    if en.shape[1] != d or tuple(mask.shape) != (v,) or mask.dtype != torch.int32:
        raise ValueError(f"{what}: shapes x {tuple(xn.shape)}, en {tuple(en.shape)}, "
                         f"mask {tuple(mask.shape)} {mask.dtype}")
    for t in (xn, en, mask):
        if t.device != xn.device or not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous on one device")
    if any(t.data_ptr() % 16 for t in (xn, en)):
        raise ValueError(f"{what}: x and en must be 16-byte aligned")
    return n, d, v


def plain_vq_rows(xn, en, mask, index_offset: int = 0):
    """Twin of `vq_rows`: per row, over the live columns of this codebook
    shard, the softmax statistics (m, z = Σ e, w = Σ e s, best value) as a
    (4, N) fp32 table and the best column + `index_offset` (N,) int32 (the
    lowest on a tie; -1 and the empty set (-3e38, 0, 0, -3e38) where the
    shard has no live column)."""
    n = xn.shape[0]
    live = ~mask.bool()
    if not bool(live.any()):
        stats = torch.tensor([_INIT_MAX, 0.0, 0.0, _INIT_MAX], device=xn.device)
        return stats[:, None].expand(4, n).contiguous(), torch.full(
            (n,), -1, dtype=torch.int32, device=xn.device)
    ids = live.nonzero()[:, 0]
    s = (xn.float() @ en.float().T)[:, ids]
    m = s.max(dim=-1).values
    e = torch.exp(s - m[:, None])
    best = (ids[torch.argmax(s, dim=-1)] + index_offset).to(torch.int32)
    return torch.stack([m, e.sum(dim=-1), (e * s).sum(dim=-1), m]), best


def plain_vq_combine(stats, best):
    """Twin of `vq_combine`: (4, S, N) statistics and (S, N) best ids merged
    in order, as the kernel merges its splits -> (k, ent, m, z)."""
    n = stats.shape[-1]
    m = torch.full((n,), _INIT_MAX, device=stats.device)
    z, w = torch.zeros(n, device=stats.device), torch.zeros(n, device=stats.device)
    bv = torch.full((n,), _INIT_MAX, device=stats.device)
    bi = torch.zeros(n, dtype=torch.int32, device=stats.device)
    for i in range(stats.shape[1]):
        m2, z2, w2, b2 = stats[:, i]
        mn = torch.maximum(m, m2)
        a, b = torch.exp(m - mn), torch.exp(m2 - mn)
        z, w, m = a * z + b * z2, a * w + b * w2, mn
        take = (best[i] >= 0) & (b2 > bv)
        bv, bi = torch.where(take, b2, bv), torch.where(take, best[i], bi)
    return bi, torch.log(z) + m - w / z, m, z


def plain_vq_cols(xn, en, mask, m, z):
    """Twin of `vq_cols`: Σ over rows of exp(s - m) / z on the live columns
    of this codebook (V,) fp32."""
    s = xn.float() @ en.float().T
    e = torch.where(mask.bool()[None, :], 0.0, torch.exp(s - m[:, None]))
    return (e / z[:, None]).sum(dim=0)


def _fwd_args(xn, en, mask, what):
    """(the entry points' leading arguments, rows, splits) of K3's plan."""
    n, d, v = _check_fwd(what, xn, en, mask)
    rows, splits = _fwd_plan(n, v, d, xn.dtype, _sm_count(xn.device))
    return (xn.data_ptr(), en.data_ptr(), mask.data_ptr(), n, v, d,
            int(xn.dtype == torch.bfloat16), rows, splits), rows, splits


def vq_rows(xn, en, mask, index_offset: int = 0):
    """K3's pass 1 and split merge on a codebook shard whose first id is
    `index_offset`: ((4, N) fp32 row statistics, (N,) int32 best ids)."""
    xn, en = xn.detach(), en.detach()
    if xn.device.type == "cpu":
        return plain_vq_rows(xn, en, mask, index_offset)
    from ..utils.cuda_build import check, kernels

    head, rows, splits = _fwd_args(xn, en, mask, "vq_rows")
    n, v = xn.shape[0], en.shape[0]
    with torch.cuda.device(xn.device):
        scratch = _fwd_scratch(n, v, rows, splits, xn.device)
        stats = torch.empty(4, n, dtype=torch.float32, device=xn.device)
        best = torch.empty(n, dtype=torch.int32, device=xn.device)
        check(kernels().sc_vq_fwd_rows(*head, scratch["stats"].data_ptr(),
                                       scratch["best_i"].data_ptr(), None, None, None, None,
                                       stats.data_ptr(), best.data_ptr(), int(index_offset),
                                       torch.cuda.current_stream().cuda_stream), "vq_rows")
    return stats, best


def vq_combine(stats, best):
    """K3's split merge over (4, S, N) statistics and (S, N) best ids in
    column order -> (k (N,) int32, ent, m, z (N,) fp32)."""
    if stats.device.type == "cpu":
        return plain_vq_combine(stats, best)
    from ..utils.cuda_build import check, kernels

    s, n = stats.shape[1], stats.shape[2]
    stats, best = stats.contiguous(), best.to(torch.int32).contiguous()
    with torch.cuda.device(stats.device):
        k = torch.empty(n, dtype=torch.int32, device=stats.device)
        ent, m, z = (torch.empty(n, dtype=torch.float32, device=stats.device) for _ in range(3))
        check(kernels().sc_vq_combine(stats.data_ptr(), best.data_ptr(), n, s, k.data_ptr(),
                                      ent.data_ptr(), m.data_ptr(), z.data_ptr(),
                                      torch.cuda.current_stream().cuda_stream), "vq_combine")
    return k, ent, m, z


def vq_cols(xn, en, mask, m, z):
    """K3's pass 2 and reduce on a codebook shard from the rows' global m and
    z (N,) -> psum (V_shard,) fp32."""
    xn, en = xn.detach(), en.detach()
    if xn.device.type == "cpu":
        return plain_vq_cols(xn, en, mask, m, z)
    from ..utils.cuda_build import check, kernels

    head, rows, splits = _fwd_args(xn, en, mask, "vq_cols")
    n, v = xn.shape[0], en.shape[0]
    with torch.cuda.device(xn.device):
        col_part = torch.empty(-(-n // rows) * v, dtype=torch.float32, device=xn.device)
        psum = torch.empty(v, dtype=torch.float32, device=xn.device)
        check(kernels().sc_vq_fwd_cols(*head, m.contiguous().data_ptr(),
                                       z.contiguous().data_ptr(), col_part.data_ptr(),
                                       psum.data_ptr(), torch.cuda.current_stream().cuda_stream),
              "vq_cols")
    return psum


def cosine_vq_stats_shard(xn, en, mask, index_offset: int, mg):
    """`cosine_vq_stats` on this rank's codebook shard (first id
    `index_offset`) of a model group `mg`: (k (N,) int32 global ids, ent (N,),
    psum (V_shard,) the shard's column sums). Every rank of the group calls it."""
    global SHARD_LAUNCHES
    from ..parallel.tp import all_gather_model

    stats, best = vq_rows(xn, en, mask, index_offset)
    stats = torch.stack(all_gather_model(stats, mg), dim=1)  # (4, tp, N), column order
    best = torch.stack(all_gather_model(best, mg), dim=0)
    k, ent, m, z = vq_combine(stats, best)
    psum = vq_cols(xn, en, mask, m, z)
    SHARD_LAUNCHES += xn.device.type == "cuda"
    return k, ent, psum


def _empty_bwd_stats(n, device):
    stats = torch.tensor([_INIT_MAX, 0.0, 0.0], device=device)
    return stats[:, None, None].expand(3, 1, n).contiguous()


def plain_st_backward_stats(xn, g, en, norms, mask, temp):
    """Twin of `st_backward_stats`: per row, over the live columns of this
    codebook shard, (m, z, zu) of softmax(s / t), with u = (g enᵀ) ‖emb‖,
    as one split: (3, 1, N) fp32."""
    temp = torch.as_tensor(temp, dtype=torch.float32, device=xn.device)
    live = ~mask.bool()
    if not bool(live.any()):
        return _empty_bwd_stats(xn.shape[0], xn.device)
    zs = (xn.float() @ en.float().T)[:, live] / temp
    u = ((g.float() @ en.float().T) * norms[None, :])[:, live]
    m = zs.max(dim=-1).values
    e = torch.exp(zs - m[:, None])
    return torch.stack([m, e.sum(dim=-1), (e * u).sum(dim=-1)])[:, None, :]


def plain_st_backward_apply(xn, g, en, norms, mask, temp, stats):
    """Twin of `st_backward_apply`: the (3, S, N) statistics merged in order
    into (m, 1/z, ρ), then this shard's partial (dx (N, D) fp32, dt () fp32)."""
    temp = torch.as_tensor(temp, dtype=torch.float32, device=xn.device)
    n = xn.shape[0]
    m = torch.full((n,), _INIT_MAX, device=xn.device)
    z, zu = torch.zeros(n, device=xn.device), torch.zeros(n, device=xn.device)
    for i in range(stats.shape[1]):
        m2, z2, zu2 = stats[:, i]
        mn = torch.maximum(m, m2)
        a, b = torch.exp(m - mn), torch.exp(m2 - mn)
        z, zu, m = a * z + b * z2, a * zu + b * zu2, mn
    live = ~mask.bool()[None, :]
    s = xn.float() @ en.float().T
    p = torch.where(live, torch.exp(s / temp - m[:, None]), 0.0) / z[:, None]
    u = (g.float() @ en.float().T) * norms[None, :]
    dz = torch.where(live, p * (u - (zu / z)[:, None]), 0.0)
    dt = (dz * (-s / (temp * temp))).sum()
    dx = (dz / temp).to(xn.dtype).float() @ en.float()
    return dx, dt


def _bwd_args(xn, g, en, norms, mask, temp, what):
    """K3b's inputs checked (one dtype, fp32 norms and a 0-d fp32
    temperature, matching shapes, contiguous on one device, 16-byte aligned
    rows); returns (rows, splits) of its plan."""
    n, d = xn.shape
    v = en.shape[0]
    if xn.dtype not in (torch.float32, torch.bfloat16) or g.dtype != xn.dtype \
            or en.dtype != xn.dtype or norms.dtype != torch.float32:
        raise TypeError(f"{what}: dtypes x {xn.dtype}, g {g.dtype}, en {en.dtype}, "
                        f"norms {norms.dtype}")
    if tuple(g.shape) != (n, d) or en.shape[1] != d or tuple(norms.shape) != (v,) \
            or tuple(mask.shape) != (v,) or mask.dtype != torch.int32 \
            or temp.dim() != 0 or temp.dtype != torch.float32:
        raise ValueError(f"{what}: shapes x {tuple(xn.shape)}, g {tuple(g.shape)}, "
                         f"en {tuple(en.shape)}, norms {tuple(norms.shape)}, "
                         f"mask {tuple(mask.shape)} {mask.dtype}, temp "
                         f"{tuple(temp.shape)} {temp.dtype}")
    for t in (xn, g, en, norms, mask, temp):
        if t.device != xn.device or not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous on one device")
    if any(t.data_ptr() % 16 for t in (xn, g, en)):
        raise ValueError(f"{what}: x, g and en must be 16-byte aligned")
    return _bwd_plan(n, v, d, xn.dtype, _sm_count(xn.device))


def _run_bwd(xn, g, en, norms, mask, temp, rows, splits, stats, n_stats, passes, what):
    """One `sc_vq_bwd` call: `passes` 3 both passes over this call's own
    statistics (`stats` None: the scratch's), 1 pass 1 into `stats`, 2 pass 2
    over the n_stats entries of `stats`. Returns (dx, dt ())."""
    from ..utils.cuda_build import check, kernels

    n, d = xn.shape
    v = en.shape[0]
    scratch = _bwd_scratch(n, d, rows, splits, xn.device)
    if stats is None:
        stats = scratch["stats"]
    dx = torch.empty(n, d, dtype=torch.float32, device=xn.device)
    dt = torch.empty(1, dtype=torch.float32, device=xn.device)
    check(kernels().sc_vq_bwd(xn.data_ptr(), g.data_ptr(), en.data_ptr(), norms.data_ptr(),
                              mask.data_ptr(), n, v, d, temp.data_ptr(),
                              int(xn.dtype == torch.bfloat16), rows, splits, stats.data_ptr(),
                              scratch["dx_part"].data_ptr(), scratch["dt_part"].data_ptr(),
                              dx.data_ptr(), dt.data_ptr(), n_stats, passes,
                              torch.cuda.current_stream().cuda_stream), what)
    return dx, dt[0]


def st_backward_stats(xn, g, en, norms, mask, temp):
    """K3b's pass 1 on this rank's codebook shard: its per-split statistics
    (3, splits, N) fp32 (one split on the twin)."""
    if xn.device.type == "cpu":
        return plain_st_backward_stats(xn, g, en, norms, mask, temp)
    rows, splits = _bwd_args(xn, g, en, norms, mask, temp, "st_backward_stats")
    n = xn.shape[0]
    with torch.cuda.device(xn.device):
        stats = torch.empty(3, splits, n, dtype=torch.float32, device=xn.device)
        _run_bwd(xn, g, en, norms, mask, temp, rows, splits, stats, splits, 1,
                 "st_backward_stats")
    return stats


def st_backward_apply(xn, g, en, norms, mask, temp, stats):
    """K3b's pass 2 on this rank's codebook shard from the (3, S, N) stats of
    every shard in column order: the shard's partial (dx (N, D) fp32, dt ())."""
    if xn.device.type == "cpu":
        return plain_st_backward_apply(xn, g, en, norms, mask, temp, stats)
    rows, splits = _bwd_args(xn, g, en, norms, mask, temp, "st_backward_apply")
    with torch.cuda.device(xn.device):
        return _run_bwd(xn, g, en, norms, mask, temp, rows, splits, stats.contiguous(),
                        stats.shape[1], 2, "st_backward_apply")


def st_backward_shard(xn, g, en, norms, mask, temp, mg):
    """`st_backward` on this rank's codebook shard of the model group `mg`:
    the statistics gathered over the group, then (dx, dt) summed over it.
    Every rank of the group calls it."""
    global BWD_SHARD_LAUNCHES
    from ..parallel.tp import all_gather_model, all_reduce_model

    if not torch.is_tensor(temp):
        temp = torch.full((), float(temp), dtype=torch.float32, device=xn.device)
    stats = st_backward_stats(xn, g, en, norms, mask, temp)
    stats = torch.cat(all_gather_model(stats, mg), dim=1)  # (3, tp · splits, N), column order
    dx, dt = st_backward_apply(xn, g, en, norms, mask, temp, stats)
    BWD_SHARD_LAUNCHES += xn.device.type == "cuda"
    return all_reduce_model(dx, mg), all_reduce_model(dt.reshape(1), mg)[0]


class _STGatherShard(torch.autograd.Function):
    """`_STGather` on a vocabulary shard: the forward is this rank's part of
    emb[k] (zero where another shard holds k; the caller sums over the group),
    the backward K3b's shard halves, dx and dt summed over the group."""

    @staticmethod
    def forward(ctx, flat, embf, en, norms, mask, temp, k, index_offset, mg):
        ctx.save_for_backward(flat, en, norms, mask, temp)
        ctx.mg = mg
        return _local_rows(embf, k, index_offset)

    @staticmethod
    def backward(ctx, g):
        flat, en, norms, mask, temp = ctx.saved_tensors
        dx, dt = st_backward_shard(flat, g.to(flat.dtype).contiguous(), en, norms, mask, temp,
                                   ctx.mg)
        dt = dt.reshape(temp.shape) if ctx.needs_input_grad[5] else None
        return dx.to(flat.dtype), None, None, None, None, dt, None, None, None


def _local_rows(embf, k, index_offset):
    """embf[k - index_offset] where this shard holds k, else zeros."""
    local = k - index_offset
    inside = (local >= 0) & (local < embf.shape[0])
    return torch.where(inside[:, None], embf[local.clamp(0, embf.shape[0] - 1)], 0.0)


class _STGather(torch.autograd.Function):
    """keywords = emb[k] from the exact fp32 table; backward K3b into xn and,
    where the temperature takes a gradient (`learnable=`), K3b's dt into it
    (the JAX `_st_gather` custom_vjp)."""

    @staticmethod
    def forward(ctx, flat, embf, en, norms, mask, temp, k):
        ctx.save_for_backward(flat, en, norms, mask, temp)
        return embf[k]

    @staticmethod
    def backward(ctx, g):
        flat, en, norms, mask, temp = ctx.saved_tensors
        dx, dt = st_backward(flat, g.to(flat.dtype).contiguous(), en, norms, mask, temp)
        dt = dt.reshape(temp.shape) if ctx.needs_input_grad[5] else None
        return dx.to(flat.dtype), None, None, None, None, dt, None


def fused_cosine_vq(
    xn: torch.Tensor,
    emb: torch.Tensor,
    temp,
    *,
    prob_msk: Sequence[int] = (0, 2, 3),
    dtype: torch.dtype = torch.bfloat16,
    training: bool = False,
    group=None,
    model_group=None,
) -> Dict[str, torch.Tensor]:
    """Cosine score + SimpleVectorQuantizer, hard form.

    xn: (B, K, D) L2-normalized keyword vectors; emb: (V, D) raw fp32 token
    embedding (also the codebook; frozen); temp: the VQ temperature, a 0-d
    fp32 tensor on xn's device (a learnable one takes K3b's dt) or a float.
    `training` gives the keywords the straight-through gradient (K3b).
    Returns the JAX `fused_cosine_vq` result dict without `subword_prob`
    (the (B, K, V) one-hot nothing reads). Nothing in it waits for the card
    once the column mask of (V, prob_msk) is on the device. With a
    data-parallel `group` the column sums, the code counts and the entropy
    are taken over the global batch (logs: the loss never reads them). With
    a tensor-parallel `model_group` (``parallel/tp.py``), `emb` is this rank's
    vocabulary shard and the result is the whole codebook's (the module
    docstring)."""
    if emb.requires_grad:
        raise ValueError("fused_cosine_vq: the codebook must be frozen (no codebook gradient)")
    if model_group is not None:
        return _fused_cosine_vq_shard(xn, emb, temp, prob_msk, dtype, training, group,
                                      model_group)
    b, kk, d = xn.shape
    v = emb.shape[0]
    n = b * kk
    embf = emb.float()
    norms = embf.norm(dim=-1).clamp_min(1e-8)
    en = (embf / norms[:, None]).to(dtype).contiguous()
    mask = _cached_mask(v, tuple(int(i) for i in prob_msk), xn.device)
    flat = xn.reshape(n, d).to(dtype).contiguous()
    k, ent, psum = cosine_vq_stats(flat, en, mask)
    k = k.long()
    avg_probs = global_mean(psum / n, group)
    # the counts by index_add_, exact in fp32: bincount reads its size back to
    # the host
    hard_probs = global_mean(torch.zeros(v, device=xn.device).index_add_(
        0, k, torch.ones(n, device=xn.device)) / n, group)
    perplexity = lambda p: torch.exp(-(p * torch.log(p + 1e-7)).sum())
    if not torch.is_tensor(temp):
        temp = torch.full((), float(temp), dtype=torch.float32, device=xn.device)
    if training:
        keywords = _STGather.apply(flat, embf, en, norms.contiguous(), mask, temp, k)
    else:
        keywords = embf[k]
    result = {
        "num_vars": v,
        "prob_perplexity": perplexity(avg_probs),
        "code_perplexity": perplexity(hard_probs),
        "ent_per_t": global_mean(ent.reshape(b, kk).mean(dim=0), group),
        "temp": temp.detach(),
        "targets": k.reshape(b, kk, 1),
        "keywords": keywords.reshape(b, kk, d),
    }
    result["diversity_loss"] = (v - result["prob_perplexity"]) / v
    return result


def _fused_cosine_vq_shard(xn, emb, temp, prob_msk, dtype, training, group, mg):
    """`fused_cosine_vq` with `emb` this rank's vocabulary shard of `mg`."""
    from ..parallel.tp import all_reduce_model, reduce_from_model

    b, kk, d = xn.shape
    v_r = emb.shape[0]
    lo, v = mg.model_rank * v_r, v_r * mg.model_world
    n = b * kk
    embf = emb.float()
    norms = embf.norm(dim=-1).clamp_min(1e-8)
    en = (embf / norms[:, None]).to(dtype).contiguous()
    mask = _cached_mask(v_r, tuple(int(i) for i in prob_msk), xn.device, lo)
    flat = xn.reshape(n, d).to(dtype).contiguous()
    k, ent, psum = cosine_vq_stats_shard(flat, en, mask, lo, mg)
    k = k.long()
    avg_probs = global_mean(psum / n, group)  # this shard's columns
    plogp = all_reduce_model((avg_probs * torch.log(avg_probs + 1e-7)).sum(), mg)
    hard_probs = global_mean(torch.zeros(v, device=xn.device).index_add_(
        0, k, torch.ones(n, device=xn.device)) / n, group)
    if not torch.is_tensor(temp):
        temp = torch.full((), float(temp), dtype=torch.float32, device=xn.device)
    if training:
        keywords = _STGatherShard.apply(flat, embf, en, norms.contiguous(), mask, temp, k, lo,
                                        mg)
    else:
        keywords = _local_rows(embf, k, lo)
    result = {
        "num_vars": v,
        "prob_perplexity": torch.exp(-plogp),
        "code_perplexity": torch.exp(-(hard_probs * torch.log(hard_probs + 1e-7)).sum()),
        "ent_per_t": global_mean(ent.reshape(b, kk).mean(dim=0), group),
        "temp": temp.detach(),
        "targets": k.reshape(b, kk, 1),
        "keywords": reduce_from_model(keywords, mg).reshape(b, kk, d),
    }
    result["diversity_loss"] = (v - result["prob_perplexity"]) / v
    return result
