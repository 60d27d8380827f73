"""Fused attention block, forward (K1): QKV proj -> attention [-> out proj].

Port of ``speechclip_plus_tpu/nn/fused_attention_block.py`` (Pallas
`_kernel`, :118). Per layer it computes, for x (B, T, D) in its native
layout:

    qkv = x Wqkvᵀ + bqkv,  q scaled by 1/sqrt(dh)
    ctx = concat_h dropout(softmax(q_h k_hᵀ + key_bias [+ gate_h · ab_h])) v_h
    out = ctx Woᵀ + bo        (fuse_out=True; else ctx is returned)

On a CUDA tensor it runs the hand-written kernels of
``csrc/fused_attention_block.cu``: the projection GEMMs through `projection`
(K1a: wgmma fed by TMA at bf16, an FMA tile at fp32; its plain twin is
`plain_projection`) and an online-softmax attention kernel on TF32
tensor-core products (K1b; see the note there). On a CPU tensor it runs
`plain_fused_attention_block`, the same function in plain PyTorch. There is
no fallback from one to the other. Both compute in fp32, keep qkv in fp32
and round the context and the output to x's dtype (the TPU kernel rounded
qkv to bf16 as well).

Dropout on the attention weights (`dropout_rate` with a `generator`; None
means deterministic) uses the counter-based mask of ``ops/random.py``: one
(seed, offset) pair per call, drawn from the generator. The context-only
mode also serves the branch attention's autograd function
(``nn/fused_attention_block_vjp.py``) through `attention_forward`, which
returns what the backward kernel (K2) needs: the fp32 qkv buffer and the
per-row log-sum-exp.

`attn_bias` is a per-head additive bias shared by the batch, (T, T),
(1, T, T) or (H, T, T) (a causal mask, WavLM's relative position bias);
`attn_gate` (B, H, T) multiplies it per query row (WavLM's gated bias
factorizes as gate(b, h, i) · bias(h, i, j)), so the (B, H, T, T) gated bias
never exists. Both are kept in fp32: the TPU kernel rounded the gated bias
to bf16 only to fit its on-chip memory (JAX ``:559-567``); on the card the
(H, T, T) tensor (4.9 MB at H=12, T=320) stays in L2. Both compose with the
dropout mode and the log-sum-exp output.

A tensor-parallel rank runs the block on its range of heads
(``parallel/tp.py``): `w_in` holds q, k and v of heads [head_offset,
head_offset + n_heads) of a layer of `total_heads`, `w_out` the matching
columns of the out-projection. The dropout mask's rows are keyed by the
layer's head index (``ops/random.py``), so a shard's context is exactly the
whole block's context for those heads. With `partial` the fused-out mode
returns the shard's out-projection in fp32 without the bias, which the
caller sums over the model group, adds the bias to and rounds once (bf16
partials would round twice where the whole block rounds once).

`fused_attention_block` itself is forward-only: the frozen towers never need
its gradient, and a backward raises, as ``_fused_bwd`` does on the JAX side.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.random import attention_keep_mask, draw_seed, keep_threshold

__all__ = ["fused_attention_block", "attention_forward", "plain_fused_attention_block",
           "projection", "plain_projection", "check_attn_bias", "LAUNCHES", "WIDE_LAUNCHES",
           "DH128_LAUNCHES", "DH1024_LAUNCHES", "PROJECTION_LAUNCHES", "SHARD_LAUNCHES",
           "GATE_LAUNCHES"]

# wrapper calls that ran the kernels on the card (one per call, whatever the
# number of CUDA launches it makes)
LAUNCHES = 0
# those of them at a head of 768 (the base cascaded branches)
WIDE_LAUNCHES = 0
# those of them at a head of 128 (the large branches)
DH128_LAUNCHES = 0
# those of them at a head of 1024 (the fixed-K large branches; the wide kernel
# with 16 query rows a block)
DH1024_LAUNCHES = 0
# launches of the projection GEMM (K1a): two per fused-out block, one per context-only block
PROJECTION_LAUNCHES = 0
# those of LAUNCHES on a tensor-parallel range of heads (fewer than the layer's)
SHARD_LAUNCHES = 0
# those of them with an `attn_bias` and an `attn_gate` (WavLM's gated bias)
GATE_LAUNCHES = 0

# 64, 96 and 128: the towers' and the 8-head branches' heads (base and large),
# whole (64, dh) tiles in shared memory; 768 and 1024: the cascaded branches'
# single head (base and large), whose head dim is cut across the warps
# (csrc/attention_core.cuh). Anything else raises.
_HEAD_DIMS = (64, 96, 128, 768, 1024)


def plain_projection(x, w, b, *, scale_cols: int = 0, scale: float = 1.0,
                     out_dtype=torch.float32):
    """K1a's plain twin: x (..., K) · wᵀ + b in fp32 on the operands' values,
    columns n < `scale_cols` times `scale`, rounded to `out_dtype`."""
    y = F.linear(x.float(), w.float(), b.float())
    if scale_cols:
        y = torch.cat([y[..., :scale_cols] * scale, y[..., scale_cols:]], dim=-1)
    return y.to(out_dtype)


def _launch_projection(x, w, b, scale_cols, scale, out_dtype):
    global PROJECTION_LAUNCHES
    from ..utils.cuda_build import check, kernels

    bf = x.dtype == torch.bfloat16
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise TypeError(f"projection: x {x.dtype}, w {w.dtype} (both fp32 or both bf16)")
    if out_dtype not in (torch.float32, x.dtype):
        raise TypeError(f"projection: out_dtype {out_dtype} for {x.dtype} operands")
    n, k = w.shape if w.ndim == 2 else (0, 0)
    if w.ndim != 2 or x.shape[-1] != k or b.shape != (n,) or w.device != x.device \
            or b.device != x.device:
        raise ValueError(f"projection: x {tuple(x.shape)}, w {tuple(w.shape)}, b "
                         f"{tuple(b.shape)} on {w.device}; want w (N, {x.shape[-1]}) in torch's "
                         f"(out, in) layout and b (N,) on {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("projection: x and w must be contiguous")
    # TMA reads bf16 rows of K values: 16-byte aligned bases and row strides
    if bf and (k % 8 or n % 2):
        raise ValueError(f"projection: K={k} must be a multiple of 8 and N={n} even")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("projection: x and w must be 16-byte aligned")
    if not (b.dtype == torch.float32 or (bf and b.dtype == torch.bfloat16)) \
            or not b.is_contiguous():
        b = b.to(torch.float32).contiguous()  # bf16 operands take a bf16 bias as it is
    out = torch.empty(*x.shape[:-1], n, dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        check(kernels().sc_fab_gemm(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                                    x.numel() // k, n, k, scale_cols, scale, int(bf),
                                    int(out_dtype == torch.bfloat16),
                                    int(b.dtype == torch.bfloat16),
                                    torch.cuda.current_stream().cuda_stream),
              "projection (K1a)")
    PROJECTION_LAUNCHES += 1
    return out


def projection(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, scale_cols: int = 0,
               scale: float = 1.0, out_dtype=torch.float32) -> torch.Tensor:
    """K1a, the block's projection GEMM: x (..., K) · wᵀ + b with w (N, K) in
    torch's (out, in) layout, columns n < `scale_cols` times `scale` (the q
    scale of the qkv projection), fp32 accumulation, the result in `out_dtype`
    (fp32, or x's dtype). bf16 operands need K % 8 == 0, an even N and 16-byte
    aligned x and w. A CPU tensor runs `plain_projection`."""
    if x.device.type == "cpu":
        return plain_projection(x, w, b, scale_cols=scale_cols, scale=scale, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise NotImplementedError(f"projection on {x.device.type}")
    return _launch_projection(x, w, b, scale_cols, scale, out_dtype)


def plain_fused_attention_block(x, w_in, b_in, w_out, b_out, key_padding_bias,
                                n_heads: int, fuse_out: bool = True, seeds=None,
                                keep_prob: float = 1.0, return_aux: bool = False,
                                attn_bias=None, attn_gate=None, head_offset: int = 0,
                                total_heads=None, partial: bool = False):
    """Plain PyTorch twin of the kernels: fp32 arithmetic on the operands'
    values, qkv kept fp32; the context and the output rounded to x's dtype.
    `seeds` (the (2,) int64 [seed, offset]) turns on dropout at `keep_prob`.
    `return_aux` (context-only) returns (ctx, qkv with q scaled, lse (B, H, T)).
    `attn_bias` (H | 1, T, T) and `attn_gate` (B, H, T) as in the wrapper, and
    the head range (`head_offset`, `total_heads`, `partial`) too."""
    b, t, d = x.shape
    dh = d // (total_heads or n_heads)
    dr = n_heads * dh  # this range's width: d itself without tensor parallelism
    qkv = plain_projection(x, w_in, b_in, scale_cols=dr, scale=dh ** -0.5)
    q, k, v = (a.reshape(b, t, n_heads, dh).transpose(1, 2) for a in qkv.split(dr, dim=-1))
    s = torch.matmul(q, k.transpose(-1, -2))
    if key_padding_bias is not None:
        s = s + key_padding_bias.float()[:, None, None, :]
    if attn_bias is not None:
        ab = attn_bias.float()[None]
        s = s + (ab if attn_gate is None else attn_gate.float()[..., None] * ab)
    w = torch.softmax(s, dim=-1)
    if seeds is not None:
        keep = attention_keep_mask(seeds, b, n_heads, t, keep_prob, head_offset, total_heads)
        w = torch.where(keep, w / keep_prob, 0.0)
    ctx = torch.matmul(w, v).transpose(1, 2).reshape(b, t, dr).to(x.dtype)
    if return_aux:
        return ctx, qkv, torch.logsumexp(s, dim=-1)
    if fuse_out and partial:
        return F.linear(ctx.float(), w_out.float())
    if fuse_out:
        return plain_projection(ctx, w_out, b_out, out_dtype=x.dtype)
    return ctx


def _launch(x, w_in, b_in, w_out, b_out, key_padding_bias, n_heads, fuse_out,
            seeds=None, keep_prob=1.0, return_aux=False, attn_bias=None, attn_gate=None,
            head_offset=0, total_heads=None, partial=False):
    global LAUNCHES, WIDE_LAUNCHES, DH128_LAUNCHES, DH1024_LAUNCHES, SHARD_LAUNCHES, \
        GATE_LAUNCHES

    b, t, d = x.shape
    total = total_heads or n_heads
    dh = d // total
    dr = n_heads * dh
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_attention_block: dtype {x.dtype} (fp32 or bf16)")
    if dh not in _HEAD_DIMS or d % 8 or d % total:
        raise ValueError(f"fused_attention_block: head dim {dh} not in {_HEAD_DIMS}")
    if not 0 <= head_offset <= total - n_heads:
        raise ValueError(f"fused_attention_block: heads [{head_offset}, "
                         f"{head_offset + n_heads}) of {total}")
    weights = [w_in] + ([w_out] if fuse_out else [])
    for w, shape in zip(weights, [(3 * dr, d), (d, dr)]):
        if w.device != x.device or w.dtype != x.dtype or tuple(w.shape) != shape \
                or not w.is_contiguous():
            raise ValueError(f"fused_attention_block: weight {tuple(w.shape)} "
                             f"{w.dtype} {w.device}; want {shape} {x.dtype} contiguous")
    if key_padding_bias is None:
        key_padding_bias = torch.zeros(b, t, dtype=torch.float32, device=x.device)
    if tuple(key_padding_bias.shape) != (b, t):
        raise ValueError(f"key_padding_bias {tuple(key_padding_bias.shape)}; want {(b, t)}")
    if seeds is not None and (seeds.device != x.device or seeds.dtype != torch.int64
                              or tuple(seeds.shape) != (2,)):
        raise ValueError("fused_attention_block: seeds must be (2,) int64 on x's device")
    kb = key_padding_bias.to(torch.float32).contiguous()
    ab = gate = None
    if attn_bias is not None:
        if attn_bias.device != x.device or attn_bias.ndim != 3 \
                or attn_bias.shape[0] not in (1, n_heads) or tuple(attn_bias.shape[1:]) != (t, t):
            raise ValueError(f"attn_bias {tuple(attn_bias.shape)} on {attn_bias.device}; want "
                             f"(1 | {n_heads}, {t}, {t}) on {x.device}")
        ab = attn_bias.to(torch.float32).contiguous()
    if attn_gate is not None:
        if ab is None or attn_gate.device != x.device \
                or tuple(attn_gate.shape) != (b, n_heads, t):
            raise ValueError(f"attn_gate {tuple(attn_gate.shape)}; want {(b, n_heads, t)} on "
                             f"{x.device}, with an attn_bias")
        gate = attn_gate.to(torch.float32).contiguous()
    qkv = projection(x, w_in, b_in, scale_cols=dr, scale=dh ** -0.5)
    ctx, lse = _attention(qkv, kb, n_heads, x.dtype, seeds, keep_prob, ab, gate, return_aux,
                          head_offset, total)
    LAUNCHES += 1
    WIDE_LAUNCHES += dh == 768
    DH128_LAUNCHES += dh == 128
    DH1024_LAUNCHES += dh == 1024
    SHARD_LAUNCHES += total != n_heads
    GATE_LAUNCHES += gate is not None
    if return_aux:
        return ctx, qkv, lse
    if fuse_out and partial:
        zero = torch.zeros(d, dtype=torch.float32, device=x.device)
        return projection(ctx, w_out, zero, out_dtype=torch.float32)
    return projection(ctx, w_out, b_out, out_dtype=x.dtype) if fuse_out else ctx


def _attention(qkv, kb, n_heads, dtype, seeds, keep_prob, ab, gate, return_lse,
               head_offset=0, total_heads=None):
    """K1b on the fp32 (B, T, 3D) buffer with q scaled: (ctx in `dtype`, fp32
    lse (B, H, T) or None). The inputs are checked by `_launch`."""
    from ..utils.cuda_build import check, kernels

    b, t, d = qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3
    ctx = torch.empty(b, t, d, dtype=dtype, device=qkv.device)
    lse = (torch.empty(b, n_heads, t, dtype=torch.float32, device=qkv.device)
           if return_lse else None)
    with torch.cuda.device(qkv.device):
        check(kernels().sc_fab_attention(
            qkv.data_ptr(), kb.data_ptr(), ctx.data_ptr(), b, t, n_heads, d // n_heads,
            int(dtype == torch.bfloat16), None if ab is None else ab.data_ptr(),
            0 if ab is None else ab.shape[0], None if gate is None else gate.data_ptr(),
            None if seeds is None else seeds.data_ptr(), keep_threshold(keep_prob),
            1.0 / keep_prob, None if lse is None else lse.data_ptr(), head_offset,
            total_heads or n_heads, torch.cuda.current_stream().cuda_stream),
            "fused_attention_block attention")
    return ctx, lse


def _run(*args, **kw):
    x = args[0]
    if x.device.type == "cpu":
        return plain_fused_attention_block(*args, **kw)
    if x.device.type != "cuda":
        raise NotImplementedError(f"fused_attention_block on {x.device.type}")
    return _launch(*args, **kw)


class _ForwardOnly(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_in, b_in, w_out, b_out, key_padding_bias, n_heads, fuse_out,
                seeds, keep_prob, attn_bias, attn_gate, head_offset, total_heads, partial):
        return _run(x, w_in, b_in, w_out, b_out, key_padding_bias, n_heads, fuse_out,
                    seeds=seeds, keep_prob=keep_prob, attn_bias=attn_bias,
                    attn_gate=attn_gate, head_offset=head_offset, total_heads=total_heads,
                    partial=partial)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "fused_attention_block is forward-only (frozen towers and serving); "
            "the branch attention's gradient is fused_attention_block_vjp (K2)")


def attention_forward(x, w_in, b_in, key_padding_bias, *, n_heads: int, seeds=None,
                      keep_prob: float = 1.0, attn_bias=None):
    """Context-only K1 for a backward: (ctx in x's dtype, fp32 qkv (B, T, 3D)
    with q scaled, fp32 lse (B, H, T)). `attn_bias` (H | 1, T, T) is added to
    the scores and is part of the lse. No autograd."""
    return _run(x, w_in, b_in, None, None, key_padding_bias, n_heads, False,
                seeds=seeds, keep_prob=keep_prob, return_aux=True, attn_bias=attn_bias)


def check_attn_bias(attn_bias, t: int, n_heads: int, what: str):
    """A per-head bias shared by the batch, (T, T), (1, T, T) or (H, T, T), as
    (1 | H, T, T); any other shape raises (a batch-dependent (B, H, T, T) bias
    is not cut down to its first entry)."""
    if attn_bias.ndim not in (2, 3) or tuple(attn_bias.shape[-2:]) != (t, t) \
            or (attn_bias.ndim == 3 and attn_bias.shape[0] not in (1, n_heads)):
        raise ValueError(f"{what}: attn_bias {tuple(attn_bias.shape)}; "
                         f"want ({t}, {t}), (1, {t}, {t}) or ({n_heads}, {t}, {t})")
    return attn_bias.reshape(-1, t, t)


def fused_attention_block(
    x: torch.Tensor,
    w_in: torch.Tensor, b_in: torch.Tensor,
    w_out: torch.Tensor, b_out: torch.Tensor,
    key_padding_bias: Optional[torch.Tensor] = None,
    *,
    n_heads: int,
    fuse_out: bool = True,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    attn_bias: Optional[torch.Tensor] = None,
    attn_gate: Optional[torch.Tensor] = None,
    head_offset: int = 0,
    total_heads: Optional[int] = None,
    partial: bool = False,
) -> torch.Tensor:
    """x (B, T, D); w_in (3D, D), b_in (3D,), w_out (D, D), b_out (D,) in
    torch's (out, in) layout; key_padding_bias (B, T) additive fp32 (-1e30 at
    pads). Returns (B, T, D) in x's dtype: the out-projected block output, or
    the attention context when `fuse_out` is False. Attention dropout at
    `dropout_rate` when a `generator` is given. `attn_bias` (T, T), (1, T, T)
    or (H, T, T) is added to every sequence's scores, times `attn_gate`
    (B, H, T) per query row when that is given (only with an `attn_bias`).

    On a range of heads (tensor parallelism), `n_heads` heads from
    `head_offset` of a layer of `total_heads`: w_in (3 D_r, D) and b_in
    (3 D_r,) are q, k and v of those heads (D_r = n_heads · D / total_heads),
    w_out (D, D_r), and H above is `n_heads`; the context is (B, T, D_r), and
    with `partial` the fused-out result is the fp32 (B, T, D) partial
    out-projection without `b_out`."""
    if partial and not fuse_out:
        raise ValueError("fused_attention_block: partial needs fuse_out")
    t = x.shape[1]
    if attn_gate is not None and attn_bias is None:
        raise ValueError("fused_attention_block: attn_gate needs an attn_bias")
    if attn_bias is not None:
        attn_bias = check_attn_bias(attn_bias, t, n_heads, "fused_attention_block")
        if attn_gate is not None and tuple(attn_gate.shape) != (x.shape[0], n_heads, t):
            raise ValueError(f"fused_attention_block: attn_gate {tuple(attn_gate.shape)}; "
                             f"want {(x.shape[0], n_heads, t)}")
    seeds, keep_prob = None, 1.0
    if dropout_rate > 0.0 and generator is not None:
        seeds, keep_prob = draw_seed(generator), 1.0 - float(dropout_rate)
    return _ForwardOnly.apply(x, w_in, b_in, w_out, b_out, key_padding_bias,
                              n_heads, fuse_out, seeds, keep_prob, attn_bias, attn_gate,
                              head_offset, total_heads, partial)
