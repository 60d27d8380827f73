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
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Sequence

import torch

from ..parallel.mesh import global_mean

__all__ = ["cosine_vq_stats", "plain_cosine_vq_stats", "st_backward", "plain_st_backward",
           "fused_cosine_vq", "LAUNCHES", "BWD_LAUNCHES", "D768_LAUNCHES",
           "BWD_D768_LAUNCHES"]

# wrapper calls that ran the kernels on the card: K3 (forward), K3b (backward),
# and those of them at the large family's codebook width, D=768
LAUNCHES = 0
BWD_LAUNCHES = 0
D768_LAUNCHES = 0
BWD_D768_LAUNCHES = 0

_MASK_VALUE = -1e30


def column_mask(v: int, prob_msk: Sequence[int], device) -> torch.Tensor:
    """(V,) int32, 1 at the excluded codebook ids."""
    mask = torch.zeros(v, dtype=torch.int32)
    for i in prob_msk:
        if 0 <= int(i) < v:
            mask[int(i)] = 1
    return mask.to(device)


@functools.lru_cache(maxsize=16)
def _cached_mask(v: int, prob_msk: tuple, device) -> torch.Tensor:
    """`column_mask` made once per (V, ids, device): building it copies from
    the host, which waits for the card. Made outside inference mode, so that a
    training step can save the mask a serving call made."""
    with torch.inference_mode(False):
        return column_mask(v, prob_msk, device)


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

    n, d = xn.shape
    v = en.shape[0]
    if xn.dtype not in (torch.float32, torch.bfloat16) or en.dtype != xn.dtype:
        raise TypeError(f"cosine_vq_stats: dtypes {xn.dtype}, {en.dtype}")
    if en.shape[1] != d or tuple(mask.shape) != (v,) or mask.dtype != torch.int32:
        raise ValueError(f"cosine_vq_stats: shapes x {tuple(xn.shape)}, "
                         f"en {tuple(en.shape)}, mask {tuple(mask.shape)} {mask.dtype}")
    for t in (xn, en, mask):
        if t.device != xn.device or not t.is_contiguous():
            raise ValueError("cosine_vq_stats: inputs must be contiguous on one device")
    if any(t.data_ptr() % 16 for t in (xn, en)):
        raise ValueError("cosine_vq_stats: x and en must be 16-byte aligned")
    rows, splits = _fwd_plan(n, v, d, xn.dtype, _sm_count(xn.device))
    lib = kernels()
    with torch.cuda.device(xn.device):
        scratch = _fwd_scratch(n, v, rows, splits, xn.device)
        k = torch.empty(n, dtype=torch.int32, device=xn.device)
        ent = torch.empty(n, dtype=torch.float32, device=xn.device)
        psum = torch.empty(v, dtype=torch.float32, device=xn.device)
        check(lib.sc_vq_fwd(xn.data_ptr(), en.data_ptr(), mask.data_ptr(), n, v, d,
                            int(xn.dtype == torch.bfloat16), rows, splits,
                            *(scratch[key].data_ptr() for key in ("stats", "best_i", "col_part")),
                            k.data_ptr(), ent.data_ptr(), scratch["m"].data_ptr(),
                            scratch["z"].data_ptr(), psum.data_ptr(),
                            torch.cuda.current_stream().cuda_stream),
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
    from ..utils.cuda_build import check, kernels

    n, d = xn.shape
    v = en.shape[0]
    if not torch.is_tensor(temp):
        temp = torch.full((), float(temp), dtype=torch.float32, device=xn.device)
    if xn.dtype not in (torch.float32, torch.bfloat16) or g.dtype != xn.dtype \
            or en.dtype != xn.dtype or norms.dtype != torch.float32:
        raise TypeError(f"st_backward: dtypes x {xn.dtype}, g {g.dtype}, en {en.dtype}, "
                        f"norms {norms.dtype}")
    if tuple(g.shape) != (n, d) or en.shape[1] != d or tuple(norms.shape) != (v,) \
            or tuple(mask.shape) != (v,) or mask.dtype != torch.int32 \
            or temp.dim() != 0 or temp.dtype != torch.float32:
        raise ValueError(f"st_backward: shapes x {tuple(xn.shape)}, g {tuple(g.shape)}, "
                         f"en {tuple(en.shape)}, norms {tuple(norms.shape)}, "
                         f"mask {tuple(mask.shape)} {mask.dtype}, temp "
                         f"{tuple(temp.shape)} {temp.dtype}")
    for t in (xn, g, en, norms, mask, temp):
        if t.device != xn.device or not t.is_contiguous():
            raise ValueError("st_backward: inputs must be contiguous on one device")
    if any(t.data_ptr() % 16 for t in (xn, g, en)):
        raise ValueError("st_backward: x, g and en must be 16-byte aligned")
    rows, splits = _bwd_plan(n, v, d, xn.dtype, _sm_count(xn.device))
    lib = kernels()
    with torch.cuda.device(xn.device):
        scratch = _bwd_scratch(n, d, rows, splits, xn.device)
        dx = torch.empty(n, d, dtype=torch.float32, device=xn.device)
        dt = torch.empty(1, dtype=torch.float32, device=xn.device)
        check(lib.sc_vq_bwd(xn.data_ptr(), g.data_ptr(), en.data_ptr(), norms.data_ptr(),
                            mask.data_ptr(), n, v, d, temp.data_ptr(),
                            int(xn.dtype == torch.bfloat16), rows, splits,
                            scratch["stats"].data_ptr(), scratch["dx_part"].data_ptr(),
                            scratch["dt_part"].data_ptr(), dx.data_ptr(), dt.data_ptr(),
                            torch.cuda.current_stream().cuda_stream),
              "st_backward")
    BWD_LAUNCHES += 1
    BWD_D768_LAUNCHES += d == 768
    return dx, dt[0]


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
    are taken over the global batch (logs: the loss never reads them)."""
    if emb.requires_grad:
        raise ValueError("fused_cosine_vq: the codebook must be frozen (no codebook gradient)")
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
