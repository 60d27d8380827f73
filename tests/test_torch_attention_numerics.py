"""The numerical model of the tensor-core attention kernels, on the CPU.

The CUDA kernels multiply in TF32 (operands rounded to 10 explicit mantissa
bits, fp32 sums): one pass where the block's output is bf16, the
error-compensated three passes where it is fp32. They run only on the card
(`test_torch_cuda_kernels.py`), so here the same operand rounding is repeated
in plain PyTorch (`nn/attention_numerics.py`) at the shapes the model paths
use, with a small batch, and held against the fp32 twins by the criteria the
on-card checks apply to the kernels:

    bf16 block   the error beyond half a bf16 ulp of the twin's value
                 <= 2e-2 x RMS(twin)                      (`compare`, bf16)
    fp32 block   abs <= 1e-4 (context, lse), abs <= 1e-4 x max(1, RMS) (dqkv)

One case records why the operands are TF32 and not bf16: with q, k and v
rounded to bf16 the same block is several times further from its twin.
Inputs are seeded with numpy.
"""
import numpy as np
import pytest
import torch

from speechclip_plus_tpu_torch.nn import attention_numerics as num
from speechclip_plus_tpu_torch.nn import fused_attention_block as fab
from speechclip_plus_tpu_torch.nn import fused_attention_block_vjp as vjp

BF16_LIMIT = 2e-2   # x RMS of the twin, beyond half a bf16 ulp
FP32_LIMIT = 1e-4

# (B, T, D, heads, causal bias): the branch, the cascaded branch's one head of
# 768, the text tower, the HuBERT tower
SHAPES = [(2, 320, 768, 8, False), (2, 327, 768, 1, False), (2, 77, 512, 8, True),
          (2, 320, 768, 12, False)]


def bf16_excess(got, want):
    """The largest error beyond half a bf16 ulp of the twin's value, over the
    twin's RMS (the bf16 criterion of the on-card `compare`)."""
    got, want = got.float(), want.float()
    _, exp = torch.frexp(want)
    half_ulp = torch.ldexp(torch.ones_like(want), exp - 9)
    excess = ((got - want).abs() - half_ulp).clamp_min(0).max().item()
    return excess / want.pow(2).mean().sqrt().item()


def block_case(seed, b, t, d, heads, causal, bf16):
    """x, the projection and the cotangent (bf16 values when `bf16`), the key
    bias with a ragged tail, the causal bias, dropout seeds."""
    rng = np.random.RandomState(seed)
    mk = lambda *s, scale=1.0: torch.from_numpy((rng.randn(*s) * scale).astype(np.float32))
    x, w_in, b_in, dctx = mk(b, t, d), mk(3 * d, d, scale=d ** -0.5), mk(3 * d, scale=0.1), \
        mk(b, t, d)
    if bf16:
        x, w_in, b_in, dctx = (a.bfloat16().float() for a in (x, w_in, b_in, dctx))
    lens = np.array([t] + list(rng.randint(t // 2, t + 1, size=b - 1)))
    kb = torch.from_numpy(
        np.where(np.arange(t)[None, :] >= lens[:, None], -1e30, 0.0).astype(np.float32))
    ab = torch.full((t, t), -1e30).triu(1)[None] if causal else None
    seeds = torch.tensor([1234 + seed, 77], dtype=torch.int64)
    return x, w_in, b_in, dctx, kb, ab, seeds


def twin_forward(x, w_in, b_in, kb, ab, heads, seeds, keep):
    return fab.plain_fused_attention_block(x, w_in, b_in, None, None, kb, heads, False,
                                           seeds=seeds, keep_prob=keep, return_aux=True,
                                           attn_bias=ab)


def test_tf32_round_keeps_ten_mantissa_bits():
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.randn(4096) * np.exp(rng.randn(4096) * 4)).astype(np.float32))
    r = num.tf32_round(x)
    assert torch.all(r.view(torch.int32) & 0x1FFF == 0)
    assert torch.all((r - x).abs() <= x.abs() * 2.0 ** -11)
    assert torch.equal(num.tf32_round(r), r)
    # ties go away from zero; bf16 values and the kernels' mask constants are exact
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert torch.equal(num.tf32_round(tie), torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]))
    b = x.bfloat16().float()
    assert torch.equal(num.tf32_round(b), b)
    hi, lo = num.split_tf32(x)
    assert torch.all((hi + lo - x).abs() <= x.abs() * 2.0 ** -21)


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("b,t,d,heads,causal", SHAPES)
def test_tf32_forward_within_bf16_tolerance(b, t, d, heads, causal, p):
    x, w_in, b_in, _, kb, ab, seeds = block_case(1, b, t, d, heads, causal, bf16=True)
    seeds, keep = (seeds, 1.0 - p) if p else (None, 1.0)
    want, qkv, lse = twin_forward(x, w_in, b_in, kb, ab, heads, seeds, keep)
    got, lse_tf32 = num.emulated_attention(qkv, kb, heads, "tf32", seeds, keep, ab)
    excess = bf16_excess(got.bfloat16(), want)
    assert excess <= BF16_LIMIT, excess
    # the log-sum-exp is held to fp32 accuracy, which one TF32 pass over fp32
    # q and k does not reach: the kernel takes the three passes for it
    _, lse_x3 = num.emulated_attention(qkv, kb, heads, "tf32x3", seeds, keep, ab)
    assert (lse_x3 - lse).abs().max().item() <= FP32_LIMIT
    assert (lse_tf32 - lse).abs().max().item() > (lse_x3 - lse).abs().max().item()


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("b,t,d,heads,causal", SHAPES)
def test_tf32_backward_within_bf16_tolerance(b, t, d, heads, causal, p):
    x, w_in, b_in, dctx, kb, ab, seeds = block_case(2, b, t, d, heads, causal, bf16=True)
    seeds, keep = (seeds, 1.0 - p) if p else (None, 1.0)
    ctx, qkv, lse = twin_forward(x, w_in, b_in, kb, ab, heads, seeds, keep)
    ctx = ctx.bfloat16().float()  # K1 hands K2 the rounded context
    want = vjp.plain_attention_backward(qkv, kb, dctx, ctx, lse, heads, seeds, keep, ab)
    got = num.emulated_attention_backward(qkv, kb, dctx, ctx, lse, heads, "tf32", seeds, keep, ab)
    excess = bf16_excess(got.bfloat16(), want)
    assert excess <= BF16_LIMIT, excess


@pytest.mark.parametrize("b,t,d,heads,causal", SHAPES)
def test_three_pass_split_within_fp32_tolerance(b, t, d, heads, causal):
    x, w_in, b_in, dctx, kb, ab, seeds = block_case(3, b, t, d, heads, causal, bf16=False)
    want, qkv, lse = twin_forward(x, w_in, b_in, kb, ab, heads, seeds, 0.9)
    got, got_lse = num.emulated_attention(qkv, kb, heads, "tf32x3", seeds, 0.9, ab)
    assert (got - want).abs().max().item() <= FP32_LIMIT
    assert (got_lse - lse).abs().max().item() <= FP32_LIMIT
    dwant = vjp.plain_attention_backward(qkv, kb, dctx, want, lse, heads, seeds, 0.9, ab)
    dgot = num.emulated_attention_backward(qkv, kb, dctx, want, lse, heads, "tf32x3", seeds, 0.9,
                                           ab)
    rms = dwant.pow(2).mean().sqrt().item()
    assert (dgot - dwant).abs().max().item() <= FP32_LIMIT * max(1.0, rms)
    # one pass is not enough for the fp32 checks
    one, _ = num.emulated_attention(qkv, kb, heads, "tf32", seeds, 0.9, ab)
    assert (one - want).abs().max().item() > (got - want).abs().max().item()


def test_fp32_mode_is_the_twin():
    x, w_in, b_in, dctx, kb, ab, seeds = block_case(4, 2, 50, 128, 2, False, bf16=False)
    want, qkv, lse = twin_forward(x, w_in, b_in, kb, ab, 2, seeds, 0.9)
    got, got_lse = num.emulated_attention(qkv, kb, 2, "fp32", seeds, 0.9, ab)
    assert (got - want).abs().max().item() <= 1e-5
    assert (got_lse - lse).abs().max().item() <= 1e-5
    dwant = vjp.plain_attention_backward(qkv, kb, dctx, want, lse, 2, seeds, 0.9, ab)
    dgot = num.emulated_attention_backward(qkv, kb, dctx, want, lse, 2, "fp32", seeds, 0.9, ab)
    assert (dgot - dwant).abs().max().item() <= 1e-5
    with pytest.raises(ValueError):
        num.rounded_matmul(x, x.transpose(-1, -2), "fp16")


def test_bf16_operands_are_the_larger_error():
    """Why the products are TF32: at the branch shape, q, k and v rounded to
    bf16 (the operands of a bf16 `mma`) leave the context several times
    further from the fp32 twin than TF32 operands do."""
    b, t, d, heads, causal = SHAPES[0]
    x, w_in, b_in, _, kb, ab, _ = block_case(5, b, t, d, heads, causal, bf16=True)
    want, qkv, _ = twin_forward(x, w_in, b_in, kb, ab, heads, None, 1.0)
    err = {}
    for mode, buffer in (("tf32", qkv), ("bf16", qkv.bfloat16().float())):
        got, _ = num.emulated_attention(buffer, kb, heads, "tf32", None, 1.0, ab)
        err[mode] = bf16_excess(got.bfloat16(), want)
    assert err["tf32"] <= BF16_LIMIT
    assert err["bf16"] > 4 * err["tf32"], err


def test_one_pass_everywhere_fails_short_sequences():
    """Why K2 chooses its precision per tile: where a sequence has a few
    keys, every query's weight sits on them. There p = exp(s - lse) must be
    normalized to what the forward's lse says (1e-3 in s is 1e-3 x sum_i |g_i|
    in dv), ds = p (dp - D) cancels, so the error of dp itself adds up over the
    queries into dk, and w = 1 / keep is no TF32 value. One TF32 pass in those
    products misses the bf16 tolerance there; with the tiles that hold a large
    weight compensated, one pass everywhere else meets it."""
    b, t, d, heads = 4, 321, 768, 8
    x, w_in, b_in, dctx, _, ab, seeds = block_case(6, b, t, d, heads, False, bf16=True)
    lens = np.array([t, 1, 2, 5])
    kb = torch.from_numpy(
        np.where(np.arange(t)[None, :] >= lens[:, None], -1e30, 0.0).astype(np.float32))
    ctx, qkv, lse = twin_forward(x, w_in, b_in, kb, ab, heads, seeds, 0.9)
    ctx = ctx.bfloat16().float()
    want = vjp.plain_attention_backward(qkv, kb, dctx, ctx, lse, heads, seeds, 0.9, ab)
    excess = {}
    for above in (float("inf"), num.PRECISE_ABOVE):
        got = num.emulated_attention_backward(qkv, kb, dctx, ctx, lse, heads, "tf32", seeds, 0.9,
                                              precise_above=above)
        excess[above] = bf16_excess(got.bfloat16(), want)
    assert excess[float("inf")] > BF16_LIMIT, excess
    assert excess[num.PRECISE_ABOVE] <= BF16_LIMIT / 2, excess


def test_long_sequences_take_the_compensated_passes():
    """Past `PRECISE_BEYOND_T` keys K2 forms q kᵀ and dctx vᵀ at fp32
    accuracy in every tile: with flat weights the one-pass error of the
    second products' inputs adds up over the keys. At the mel upstreams'
    branch (T=639, 8 heads of 64) the model of the kernel stays under half
    the bf16 tolerance, and closer to the twin than the per-tile choice
    alone."""
    b, t, d, heads = 2, 639, 512, 8
    assert t > num.PRECISE_BEYOND_T >= 329  # the HuBERT-family branches keep the tile choice
    x, w_in, b_in, dctx, kb, ab, seeds = block_case(7, b, t, d, heads, False, bf16=True)
    ctx, qkv, lse = twin_forward(x, w_in, b_in, kb, ab, heads, seeds, 0.9)
    ctx = ctx.bfloat16().float()
    want = vjp.plain_attention_backward(qkv, kb, dctx, ctx, lse, heads, seeds, 0.9, ab)
    excess = {}
    for beyond in (num.PRECISE_BEYOND_T, 10 ** 9):
        got = num.emulated_attention_backward(qkv, kb, dctx, ctx, lse, heads, "tf32", seeds, 0.9,
                                              precise_beyond_t=beyond)
        excess[beyond] = bf16_excess(got.bfloat16(), want)
    assert excess[num.PRECISE_BEYOND_T] <= BF16_LIMIT / 2, excess
    assert excess[num.PRECISE_BEYOND_T] < excess[10 ** 9], excess
