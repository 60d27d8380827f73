"""The port's hand-written CUDA kernels against their plain PyTorch twins, on
the card (every test is marked `cuda` and skips without one).

This file imports torch and the port only, never jax, so it runs on a GPU
machine without JAX: `python -m pytest --noconftest -m cuda
tests/test_torch_cuda_kernels.py -q`. The CPU parity of the twins with the
JAX kernels is in `test_torch_fused_attention_block.py` and
`test_torch_fused_keyword.py`.

Tolerances: fp32 1e-4 abs (K1) or 1e-4 x max(1, RMS) (K1 with dropout, bias
or gate, K2, K4, K5, K6, the fused layer 0); bf16 K1, K2, K4, K5 and K6 error
beyond half an ulp of the bf16 output <= 2e-2 x the output's RMS, the fused
layer 0's as its test states; K4's lse 1e-4 relative; K3
targets equal wherever the top-2 margin exceeds 1e-3 (bf16) or 1e-5 (fp32),
ent and psum to rtol 1e-3, exact ties to the lowest index; K3b dx to 1e-4 (fp32) or 1e-2
(bf16) x RMS and dt to 1e-4 x the sum of its terms' sizes, with the
temperature a float or a device tensor (the same bits at t = 0.1; a training
step with a learnable one makes no device-to-host sync); the bf16 attention
kernels against their numerical model (`nn/attention_numerics.py`) 4e-3 x RMS
beyond half an ulp, a fifth of what the twin is allowed. K2, K3 and K3b repeat
bit for bit (no float atomics), as do K1, K4, K5, K6 and the fused layer
0. On a tensor-parallel shard (a range of heads, a vocabulary shard): K1's and K5's contexts equal
the whole kernel's columns for those heads bit for bit, K1's fp32 partial
out-projection against its twin (bf16: the error beyond one ulp of each
context element, through |Wo|, <= 2e-2 x RMS) and the partials summed with
the bias within the bf16 check of the whole block,
K3's merged shards give the whole kernel's k bit for bit with ent and psum
to rtol 1e-3, and K3b's summed shards pass its dx and dt tolerances.
"""
import pytest
import torch

from speechclip_plus_tpu_torch.nn import fused_attention_block as fab
from speechclip_plus_tpu_torch.nn import fused_attention_block_vjp as vjp
from speechclip_plus_tpu_torch.ops import fused_keyword as fk
from speechclip_plus_tpu_torch.ops.random import draw_seed

SPECIAL = (0, 2, 3)  # the reduced vocabulary's masked ids: '!', SOT, EOT


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _block_args(dev, b, t, d, seed=6):
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    lens = torch.randint(1, t + 1, (b,), generator=g, device=dev)
    lens[0] = t
    kb = torch.where(torch.arange(t, device=dev)[None] >= lens[:, None], -1e30, 0.0)
    return [mk(b, t, d), mk(3 * d, d, scale=d ** -0.5), mk(3 * d, scale=0.1),
            mk(d, d, scale=d ** -0.5), mk(d, scale=0.1), kb]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,d,heads,fuse_out", [
    (8, 319, 768, 12, True), (64, 50, 768, 12, True), (128, 50, 768, 12, True),
    (256, 50, 768, 12, True), (8, 320, 768, 8, False), (3, 37, 128, 2, True)])
def test_fused_attention_block_kernel_matches_plain(cuda_device, dtype, b, t, d, heads,
                                                    fuse_out):
    args = _block_args(cuda_device, b, t, d)
    args = [a.to(dtype) if i < 5 else a for i, a in enumerate(args)]
    before = fab.LAUNCHES
    got = fab.fused_attention_block(*args, n_heads=heads, fuse_out=fuse_out).float()
    assert fab.LAUNCHES == before + 1
    want = fab.plain_fused_attention_block(*[a.float() for a in args], heads, fuse_out)
    assert bool(torch.isfinite(got).all())
    err = (got - want).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-4
    else:  # beyond the bf16 output's own rounding (half an ulp)
        _, exp = torch.frexp(want)
        excess = (err - torch.ldexp(torch.ones_like(want), exp - 9)).clamp_min(0).max()
        assert excess.item() <= 2e-2 * want.pow(2).mean().sqrt().item()


@pytest.mark.cuda
def test_fused_attention_block_rejects_misaligned_input(cuda_device):
    args = [a.to(torch.bfloat16) if i < 5 else a
            for i, a in enumerate(_block_args(cuda_device, 2, 16, 128))]
    x = args[0]
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view(x.shape)
    shifted.copy_(x)  # contiguous, but 2 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="aligned"):
        fab.fused_attention_block(shifted, *args[1:], n_heads=2)


def _vq_inputs(dev, dtype, n, d, v, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.nn.functional.normalize(torch.randn(n, d, generator=g, device=dev), dim=-1)
    en = torch.nn.functional.normalize(torch.randn(v, d, generator=g, device=dev), dim=-1)
    return x.to(dtype).contiguous(), en.to(dtype).contiguous()


def _check_vq(x, en, mask, dtype):
    """K3 against its twin: targets equal where the top-2 margin is decided,
    ent and psum to rtol 1e-3, one wrapper call counted, reruns identical."""
    before = fk.LAUNCHES
    k1, e1, p1 = fk.cosine_vq_stats(x, en, mask)
    assert fk.LAUNCHES == before + 1
    k0, e0, p0 = fk.plain_cosine_vq_stats(x, en, mask)
    s = (x.float() @ en.float().T).masked_fill(mask.bool()[None], -1e30)
    top2 = s.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > (1e-3 if dtype == torch.bfloat16 else 1e-5)
    assert torch.equal(k1.long()[decided], k0.long()[decided])
    assert not bool(mask.bool()[k1.long()].any())
    torch.testing.assert_close(e1, e0, rtol=1e-3, atol=0)
    torch.testing.assert_close(p1, p0, rtol=1e-3, atol=0)
    again = fk.cosine_vq_stats(x, en, mask)
    assert all(torch.equal(a, b) for a, b in zip(again, (k1, e1, p1)))  # deterministic
    return k1, k0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,v", [(600, 512, 8112), (4800, 512, 8112), (9600, 512, 8112),
                                   (37, 64, 300), (8, 512, 8112), (64, 512, 8112),
                                   (75, 512, 8112), (512, 512, 8112), (1024, 512, 8112),
                                   (600, 768, 8112), (8, 768, 8112), (1024, 768, 8112),
                                   (9600, 768, 8112), (8, 768, 19787), (1024, 768, 19787),
                                   (9600, 768, 19787)])
def test_cosine_vq_kernel_matches_plain(cuda_device, dtype, n, d, v):
    """K3 on its (row tiles, V splits) grid at every N the paths record (one
    query's 8 or 75 keywords up to the plus families' 9600 training rows), a
    ragged small case and the large family's width, D=768."""
    x, en = _vq_inputs(cuda_device, dtype, n, d, v)
    _check_vq(x, en, fk.column_mask(v, SPECIAL, cuda_device), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cosine_vq_exact_ties_go_to_the_lowest_index(cuda_device, dtype):
    """Every row is a codebook vector that appears three times, in different
    tiles and splits: the scores tie exactly and the lowest index must win,
    as in the twin (torch.argmax) and jnp.argmax."""
    n, d, v = 600, 512, 8112
    x, en = _vq_inputs(cuda_device, dtype, n, d, v, seed=3)
    sources = 4 + 8 * torch.arange(250, device=cuda_device)  # ids 4, 12, .., 1996
    en[sources + 5] = en[sources]  # the same column tile, or the next one
    en[sources + 4000] = en[sources]  # a later tile, and a later split
    src = sources[torch.arange(n, device=cuda_device) % 250]
    x = en[src].contiguous()
    mask = fk.column_mask(v, SPECIAL, cuda_device)
    k1, k0 = _check_vq(x, en, mask, dtype)
    assert torch.equal(k1.long(), k0.long())
    assert torch.equal(k1.long(), src)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cosine_vq_with_an_all_masked_split(cuda_device, dtype):
    """V=300 runs as one split per column tile; the second split is masked
    whole, so its statistics must merge as the identity (no NaN)."""
    n, d, v = 37, 64, 300
    rows, splits = fk._fwd_plan(n, v, d, dtype, fk._sm_count(cuda_device))
    cols = fk._FWD_COLS[dtype]
    assert splits == -(-v // cols) >= 3
    x, en = _vq_inputs(cuda_device, dtype, n, d, v, seed=5)
    mask = fk.column_mask(v, SPECIAL + tuple(range(cols, 2 * cols)), cuda_device)
    k1, e1, p1 = fk.cosine_vq_stats(x, en, mask)
    assert bool(torch.isfinite(e1).all()) and bool(torch.isfinite(p1).all())
    assert torch.all(p1[cols:2 * cols] == 0)
    _check_vq(x, en, mask, dtype)


@pytest.mark.cuda
def test_cosine_vq_rejects_bad_inputs(cuda_device):
    n, v = 37, 300
    mask = fk.column_mask(v, SPECIAL, cuda_device)
    before = fk.LAUNCHES
    x, en = _vq_inputs(cuda_device, torch.bfloat16, n, 72, v)
    with pytest.raises(ValueError, match="multiple of 16"):  # D % 16 != 0
        fk.cosine_vq_stats(x, en, mask)
    x, en = _vq_inputs(cuda_device, torch.bfloat16, n, 784, v)
    with pytest.raises(ValueError, match="at most 768"):  # wider than the shared x rows
        fk.cosine_vq_stats(x, en, mask)
    x, en = _vq_inputs(cuda_device, torch.bfloat16, n, 64, v)
    with pytest.raises(TypeError, match="dtypes"):
        fk.cosine_vq_stats(x, en.float(), mask)
    shifted = torch.empty(n * 64 + 1, dtype=torch.bfloat16, device=cuda_device)[1:].view(n, 64)
    shifted.copy_(x)
    with pytest.raises(ValueError, match="aligned"):
        fk.cosine_vq_stats(shifted, en, mask)
    with pytest.raises(ValueError, match="contiguous"):
        fk.cosine_vq_stats(x, en.T.contiguous().T, mask)
    assert fk.LAUNCHES == before


def _close(got, want, dtype):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    rms = want.pow(2).mean().sqrt().item()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-4 * max(1.0, rms)
    else:  # beyond the bf16 output's own rounding (half an ulp)
        _, exp = torch.frexp(want)
        excess = (err - torch.ldexp(torch.ones_like(want), exp - 9)).clamp_min(0).max()
        assert excess.item() <= 2e-2 * rms


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,d,heads,fuse_out", [
    (8, 320, 768, 12, True), (8, 321, 768, 8, False), (3, 37, 128, 2, False)])
def test_fused_attention_block_dropout_matches_plain(cuda_device, dtype, b, t, d, heads,
                                                    fuse_out):
    args = _block_args(cuda_device, b, t, d)
    args = [a.to(dtype) if i < 5 else a for i, a in enumerate(args)]
    seeds = draw_seed(torch.Generator(device=cuda_device).manual_seed(3))
    before = fab.LAUNCHES
    got = fab._run(*args, heads, fuse_out, seeds=seeds, keep_prob=0.9)
    assert fab.LAUNCHES == before + 1
    want = fab.plain_fused_attention_block(*[a.float() for a in args], heads, fuse_out,
                                           seeds=seeds, keep_prob=0.9)
    assert bool(torch.isfinite(got.float()).all())
    _close(got, want, dtype)
    if not fuse_out:
        _, _, lse = fab.attention_forward(*args[:3], args[5], n_heads=heads, seeds=seeds,
                                          keep_prob=0.9)
        _, _, lse0 = fab.plain_fused_attention_block(
            *[a.float() for a in args[:3]], None, None, args[5], heads, False, seeds=seeds,
            keep_prob=0.9, return_aux=True)
        assert (lse - lse0).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,d,heads,p", [
    (8, 321, 768, 8, 0.1), (8, 321, 768, 8, 0.0), (3, 37, 128, 2, 0.3), (2, 70, 256, 4, 0.1)])
def test_attention_backward_matches_plain(cuda_device, dtype, b, t, d, heads, p):
    x, w_in, b_in, _, _, kb = _block_args(cuda_device, b, t, d)
    x, w_in, b_in = x.to(dtype), w_in.to(dtype), b_in.to(dtype)
    seeds = draw_seed(torch.Generator(device=cuda_device).manual_seed(4)) if p else None
    ctx, qkv, lse = fab.attention_forward(x, w_in, b_in, kb, n_heads=heads, seeds=seeds,
                                          keep_prob=1.0 - p)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    dctx = torch.randn(b, t, d, generator=g, device=cuda_device).to(dtype)
    before = vjp.LAUNCHES
    got = vjp.attention_backward(qkv, kb, dctx, ctx, lse, n_heads=heads, seeds=seeds,
                                 keep_prob=1.0 - p)
    assert vjp.LAUNCHES == before + 1
    want = vjp.plain_attention_backward(qkv, kb, dctx.float(), ctx.float(), lse, heads, seeds,
                                        1.0 - p)
    assert bool(torch.isfinite(got.float()).all())
    _close(got, want, dtype)
    again = vjp.attention_backward(qkv, kb, dctx, ctx, lse, n_heads=heads, seeds=seeds,
                                   keep_prob=1.0 - p)
    assert torch.equal(got, again)  # deterministic


def _st_inputs(dev, dtype, n, d, v):
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.nn.functional.normalize(torch.randn(n, d, generator=g, device=dev), dim=-1)
    cot = torch.randn(n, d, generator=g, device=dev) * 1e-3
    emb = torch.randn(v, d, generator=g, device=dev) * 0.1
    norms = emb.norm(dim=-1).clamp_min(1e-8)
    en = (emb / norms[:, None]).to(dtype).contiguous()
    return x.to(dtype).contiguous(), cot.to(dtype).contiguous(), en, norms


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,v", [(9600, 512, 8112), (1024, 512, 8112), (4800, 512, 8112),
                                   (37, 64, 300), (8, 512, 8112), (8, 768, 8112),
                                   (1024, 768, 8112), (9600, 768, 8112), (8, 768, 19787),
                                   (1024, 768, 19787), (9600, 768, 19787), (37, 528, 300)])
def test_st_backward_kernel_matches_plain(cuda_device, dtype, n, d, v):
    """K3b on its (row tiles, V splits) grid at the paths' N (9600: the plus
    families; 1024: the fixed-K ones), a half batch, a ragged small case and
    one query's 8 keywords (one row tile, 127 splits); at the large family's
    width, D=768 with both reduced vocabularies (the 32-row tile), and the
    narrowest width of that tile."""
    x, cot, en, norms = _st_inputs(cuda_device, dtype, n, d, v)
    mask = fk.column_mask(v, SPECIAL, cuda_device)
    before = fk.BWD_LAUNCHES
    dx, dt = fk.st_backward(x, cot, en, norms, mask, 0.1)
    assert fk.BWD_LAUNCHES == before + 1
    dx0, dt0 = fk.plain_st_backward(x, cot, en, norms, mask, 0.1)
    rms = dx0.pow(2).mean().sqrt().item()
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    assert (dx - dx0).abs().max().item() <= tol * rms
    s = x.float() @ en.float().T
    p = torch.softmax(torch.where(mask.bool()[None], -torch.inf, s / 0.1), dim=-1)
    u = (cot.float() @ en.float().T) * norms
    scale = (p * (u - (p * u).sum(-1, keepdim=True)) * s).abs().sum().item() / 0.01
    assert abs(dt.item() - dt0.item()) <= 1e-4 * scale
    dx2, dt2 = fk.st_backward(x, cot, en, norms, mask, 0.1)
    assert torch.equal(dx, dx2) and torch.equal(dt, dt2)  # deterministic


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_st_backward_with_an_all_masked_split(cuda_device, dtype):
    """V=300 runs as 5 splits of one 64-column tile; the second is masked
    whole, so its statistics must merge as the identity (no NaN)."""
    n, d, v = 37, 64, 300
    assert fk._bwd_plan(n, v, d, dtype, fk._sm_count(cuda_device))[1] == 5
    x, cot, en, norms = _st_inputs(cuda_device, dtype, n, d, v)
    mask = fk.column_mask(v, SPECIAL + tuple(range(64, 128)), cuda_device)
    dx, dt = fk.st_backward(x, cot, en, norms, mask, 0.1)
    dx0, dt0 = fk.plain_st_backward(x, cot, en, norms, mask, 0.1)
    assert bool(torch.isfinite(dx).all()) and bool(torch.isfinite(dt))
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    assert (dx - dx0).abs().max().item() <= tol * dx0.pow(2).mean().sqrt().item()
    s = x.float() @ en.float().T
    p = torch.softmax(torch.where(mask.bool()[None], -torch.inf, s / 0.1), dim=-1)
    u = (cot.float() @ en.float().T) * norms
    scale = (p * (u - (p * u).sum(-1, keepdim=True)) * s).abs().sum().item() / 0.01
    assert abs(dt.item() - dt0.item()) <= 1e-4 * scale
    again = fk.st_backward(x, cot, en, norms, mask, 0.1)
    assert torch.equal(dx, again[0]) and torch.equal(dt, again[1])


@pytest.mark.cuda
def test_st_backward_rejects_bad_inputs(cuda_device):
    n, v = 37, 300
    x, cot, en, norms = _st_inputs(cuda_device, torch.bfloat16, n, 72, v)
    mask = fk.column_mask(v, SPECIAL, cuda_device)
    before = fk.BWD_LAUNCHES
    with pytest.raises(ValueError, match="multiple of 16"):  # D % 16 != 0
        fk.st_backward(x, cot, en, norms, mask, 0.1)
    x, cot, en, norms = _st_inputs(cuda_device, torch.bfloat16, n, 784, v)
    with pytest.raises(ValueError, match="at most 768"):  # wider than the dx accumulators
        fk.st_backward(x, cot, en, norms, mask, 0.1)
    x, cot, en, norms = _st_inputs(cuda_device, torch.bfloat16, n, 64, v)
    shifted = torch.empty(n * 64 + 1, dtype=torch.bfloat16, device=cuda_device)[1:].view(n, 64)
    shifted.copy_(x)
    with pytest.raises(ValueError, match="aligned"):
        fk.st_backward(shifted, cot, en, norms, mask, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        fk.st_backward(x, cot, en.T.contiguous().T, norms, mask, 0.1)
    assert fk.BWD_LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_st_backward_device_temperature_is_the_float_path(cuda_device, dtype):
    """K3b reads the temperature from device memory: a 0-d tensor at t = 0.1
    gives the float argument's results bit for bit (the wrapper puts a float
    on the device as the same fp32 value)."""
    n, d, v = 9600, 512, 8112
    x, cot, en, norms = _st_inputs(cuda_device, dtype, n, d, v)
    mask = fk.column_mask(v, SPECIAL, cuda_device)
    temp = torch.full((), 0.1, device=cuda_device)
    dx, dt = fk.st_backward(x, cot, en, norms, mask, temp)
    dx2, dt2 = fk.st_backward(x, cot, en, norms, mask, 0.1)
    assert torch.equal(dx, dx2) and torch.equal(dt, dt2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1024, 9600])
def test_st_backward_dt_matches_the_twin_for_a_device_temperature(cuda_device, dtype, n):
    """dt, the learnable temperature's gradient, at t = 0.37 on the device
    against the twin, to 1e-4 x the sum of its terms' sizes; dx as K3b's
    rows above."""
    d, v, t = 512, 8112, 0.37
    x, cot, en, norms = _st_inputs(cuda_device, dtype, n, d, v)
    mask = fk.column_mask(v, SPECIAL, cuda_device)
    temp = torch.full((), t, device=cuda_device)
    dx, dt = fk.st_backward(x, cot, en, norms, mask, temp)
    dx0, dt0 = fk.plain_st_backward(x, cot, en, norms, mask, temp)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    assert (dx - dx0).abs().max().item() <= tol * dx0.pow(2).mean().sqrt().item()
    s = x.float() @ en.float().T
    p = torch.softmax(torch.where(mask.bool()[None], -torch.inf, s / t), dim=-1)
    u = (cot.float() @ en.float().T) * norms
    scale = (p * (u - (p * u).sum(-1, keepdim=True)) * s).abs().sum().item() / t ** 2
    assert abs(dt.item() - dt0.item()) <= 1e-4 * scale
    assert dt.item() != 0.0


@pytest.mark.cuda
def test_learnable_temperature_step_does_not_sync(cuda_device):
    """A training step's pass through `fused_cosine_vq` with a learnable
    temperature (K3, the gather, K3b into the keywords and the temperature)
    waits for the card nowhere: `set_sync_debug_mode("error")` raises on any
    device-to-host sync. The column mask is put on the device by a first
    call, as in a training run's first step."""
    dev, b, k, d, v = cuda_device, 128, 75, 512, 8112
    g = torch.Generator(device=dev).manual_seed(3)
    emb = torch.randn(v, d, generator=g, device=dev) * 0.1
    x = torch.nn.functional.normalize(torch.randn(b, k, d, generator=g, device=dev), dim=-1)
    cot = torch.randn(b, k, d, generator=g, device=dev) * 1e-3
    temp = torch.nn.Parameter(torch.full((), 0.1, device=dev))

    def step():
        xn = x.clone().requires_grad_(True)
        res = fk.fused_cosine_vq(xn, emb, temp, dtype=torch.bfloat16, training=True)
        (res["keywords"] * cot).sum().backward()
        return xn.grad

    step()
    temp.grad = None
    before = (fk.LAUNCHES, fk.BWD_LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dx = step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (fk.LAUNCHES, fk.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert temp.grad is not None and bool(torch.isfinite(temp.grad)) and float(temp.grad) != 0
    assert bool(torch.isfinite(dx).all())


# ---- K1's bias and gate modes, K5, K4, K6 ----

def _bias_gate(dev, b, t, heads, shared=False, seed=8):
    g = torch.Generator(device=dev).manual_seed(seed)
    ab = torch.randn(1 if shared else heads, t, t, generator=g, device=dev)
    gate = 1.0 + torch.rand(b, heads, t, generator=g, device=dev)
    return ab, gate


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,d,heads,gated,shared,p", [
    (8, 320, 768, 12, True, False, 0.0), (8, 320, 768, 12, True, False, 0.1),
    (8, 320, 768, 12, False, False, 0.0), (4, 77, 512, 8, False, True, 0.0),
    (3, 37, 128, 2, True, False, 0.3), (128, 320, 768, 12, True, False, 0.1)])
def test_fused_attention_block_bias_gate_matches_plain(cuda_device, dtype, b, t, d, heads,
                                                       gated, shared, p):
    args = _block_args(cuda_device, b, t, d)
    args[5][-1, :] = -1e30  # a fully padded row stays finite
    args = [a.to(dtype) if i < 5 else a for i, a in enumerate(args)]
    ab, gate = _bias_gate(cuda_device, b, t, heads, shared)
    kw = dict(attn_bias=ab, attn_gate=gate if gated else None)
    if p:
        kw.update(seeds=draw_seed(torch.Generator(device=cuda_device).manual_seed(3)),
                  keep_prob=1.0 - p)
    before = fab.LAUNCHES
    got = fab._run(*args, heads, True, **kw)
    assert fab.LAUNCHES == before + 1
    want = fab.plain_fused_attention_block(*[a.float() for a in args], heads, True, **kw)
    assert bool(torch.isfinite(got.float()).all())
    _close(got, want, dtype)
    assert torch.equal(got, fab._run(*args, heads, True, **kw))  # deterministic
    # context-only with the log-sum-exp output composes with the bias
    ctx, _, lse = fab._run(*args[:3], None, None, args[5], heads, False, return_aux=True, **kw)
    ctx0, _, lse0 = fab.plain_fused_attention_block(
        *[a.float() for a in args[:3]], None, None, args[5], heads, False, return_aux=True, **kw)
    _close(ctx, ctx0, dtype)
    assert (lse - lse0).abs().max().item() <= 1e-4 * max(1.0, lse0.abs().max().item())


@pytest.mark.cuda
def test_fused_attention_block_rejects_bad_bias(cuda_device):
    args = _block_args(cuda_device, 2, 16, 128)
    ab, gate = _bias_gate(cuda_device, 2, 16, 2)
    with pytest.raises(ValueError, match="attn_gate"):
        fab.fused_attention_block(*args, n_heads=2, attn_gate=gate)
    with pytest.raises(ValueError, match="attn_bias"):
        fab.fused_attention_block(*args, n_heads=2, attn_bias=ab.cpu())
    with pytest.raises(ValueError, match="attn_bias"):
        fab.fused_attention_block(*args, n_heads=2, attn_bias=ab[:, :15])


def _qkv(dev, b, h, t, dh, dtype, packed, seed=9):
    """q, k, v (B, H, T, dh): strided views of a packed (B, T, 3D) buffer, or
    three contiguous tensors; and a ragged key bias with one fully padded row."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if packed:
        qkv = torch.randn(b, t, 3, h, dh, generator=g, device=dev).to(dtype)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    else:
        q, k, v = (torch.randn(b, h, t, dh, generator=g, device=dev).to(dtype) for _ in range(3))
    lens = torch.randint(1, t + 1, (b,), generator=g, device=dev)
    lens[0] = t
    kb = torch.where(torch.arange(t, device=dev)[None] >= lens[:, None], -1e30, 0.0)
    kb[-1, :] = -1e30
    return q, k, v, kb


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,t,dh,packed,p", [
    (8, 12, 320, 64, True, 0.1), (8, 12, 320, 64, True, 0.0), (3, 2, 37, 64, False, 0.3),
    (2, 4, 130, 96, True, 0.1), (128, 12, 320, 64, True, 0.1)])
def test_fused_attention_dropout_kernel_matches_plain(cuda_device, dtype, b, h, t, dh, packed, p):
    from speechclip_plus_tpu_torch.nn import fused_attention as fa

    q, k, v, kb = _qkv(cuda_device, b, h, t, dh, dtype, packed)
    seeds = draw_seed(torch.Generator(device=cuda_device).manual_seed(3)) if p else None
    before = fa.LAUNCHES
    got = fa._run(q, k, v, kb, seeds, 1.0 - p)
    assert fa.LAUNCHES == before + 1 and got.shape == q.shape
    want = fa.plain_fused_attention_dropout(q.float(), k.float(), v.float(), kb, seeds, 1.0 - p)
    assert bool(torch.isfinite(got.float()).all())
    _close(got, want, dtype)
    assert torch.equal(got, fa._run(q, k, v, kb, seeds, 1.0 - p))
    # the heads merge without a copy
    assert got.transpose(1, 2).reshape(b, t, h * dh).data_ptr() == got.data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_attention_dropout_draws_the_block_kernels_mask(cuda_device, dtype):
    """K5 on the q, k, v that K1's context-only mode projects, with the same
    (seed, offset): the same mask, so the same context up to K1's fp32 qkv."""
    from speechclip_plus_tpu_torch.nn import fused_attention as fa

    b, t, d, heads = 4, 320, 768, 12
    x, w_in, b_in, _, _, kb = _block_args(cuda_device, b, t, d)
    x, w_in, b_in = x.to(dtype), w_in.to(dtype), b_in.to(dtype)
    seeds = draw_seed(torch.Generator(device=cuda_device).manual_seed(7))
    ctx, qkv, _ = fab.attention_forward(x, w_in, b_in, kb, n_heads=heads, seeds=seeds,
                                        keep_prob=0.9)
    # K1's buffer holds q already scaled by 1/sqrt(dh); K5 scales q itself
    q, k, v = qkv.view(b, t, 3, heads, d // heads).permute(2, 0, 3, 1, 4).unbind(0)
    got = fa._run(q * (d // heads) ** 0.5, k, v, kb, seeds, 0.9)
    got = got.transpose(1, 2).reshape(b, t, d)
    # fp32 inputs to K5 here; K1 rounds its context to x's dtype
    _close(ctx, got, dtype)
    other = fa._run(q * (d // heads) ** 0.5, k, v, kb, seeds + 1, 0.9)
    assert (other.transpose(1, 2).reshape(b, t, d) - got).abs().max().item() > 1e-2


@pytest.mark.cuda
def test_bhtd_kernels_reject_bad_inputs(cuda_device):
    from speechclip_plus_tpu_torch.nn import flash, fused_attention as fa

    q, k, v, kb = _qkv(cuda_device, 2, 2, 16, 64, torch.float32, False)
    strided = torch.empty(2, 2, 16, 128, device=cuda_device)[..., ::2]
    for fn in (fa.fused_attention_dropout, flash.flash_forward):
        with pytest.raises(ValueError, match="contiguous head dim"):
            fn(strided, k, v, kb)
        with pytest.raises(ValueError, match="want"):
            fn(q, k[:, :, :8], v, kb)
        with pytest.raises(TypeError):
            fn(q.half(), k.half(), v.half(), kb)
    q32 = torch.randn(2, 2, 16, 32, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        fa.fused_attention_dropout(q32, q32, q32, kb)
    out = fa.fused_attention_dropout(q.requires_grad_(), k, v, kb)
    with pytest.raises(NotImplementedError, match="forward-only"):
        out.sum().backward()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,t,dh,packed", [
    (8, 12, 1499, 64, True), (3, 2, 37, 64, False), (2, 4, 130, 96, True),
    (128, 12, 320, 64, True)])
def test_flash_kernel_matches_plain(cuda_device, dtype, b, h, t, dh, packed):
    from speechclip_plus_tpu_torch.nn import flash

    q, k, v, kb = _qkv(cuda_device, b, h, t, dh, dtype, packed)
    before = flash.LAUNCHES
    out, lse = flash.flash_forward(q, k, v, kb)
    assert flash.LAUNCHES == before + 1
    out0, lse0 = flash.plain_flash_attention(q.float(), k.float(), v.float(), kb)
    assert bool(torch.isfinite(out.float()).all()) and bool(torch.isfinite(lse).all())
    _close(out, out0, dtype)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, t)
    # a fully padded row's lse is about -1e30: relative there, absolute elsewhere
    assert ((lse - lse0).abs() <= 1e-4 * lse0.abs().clamp_min(1.0)).all()
    again, lse2 = flash.flash_forward(q, k, v, kb)
    assert torch.equal(out, again) and torch.equal(lse, lse2)


@pytest.mark.cuda
def test_flash_attention_gradients_on_the_card(cuda_device):
    """The kernel's forward with the plain backward from its lse, against
    autograd through plain attention (fp32)."""
    from speechclip_plus_tpu_torch.nn import flash

    q, k, v, kb = _qkv(cuda_device, 2, 2, 70, 64, torch.float32, False)
    kb[-1, :50] = 0.0
    kpm = kb < -1e20
    probe = torch.randn(q.shape, device=cuda_device)
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    grads = torch.autograd.grad((flash.flash_attention(*leaves, kpm) * probe).sum(), leaves)
    ref = [a.clone().requires_grad_() for a in (q, k, v)]
    s = (ref[0] @ ref[1].transpose(-1, -2)) * 64 ** -0.5 + kb[:, None, None, :]
    want = torch.autograd.grad(((torch.softmax(s, -1) @ ref[2]) * probe).sum(), ref)
    for g, w in zip(grads, want):
        assert (g - w).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,out_dtype", [(torch.float32, torch.float32),
                                             (torch.bfloat16, torch.bfloat16),
                                             (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("b,t,c,k,s", [(4, 102400, 512, 10, 5), (3, 1003, 64, 10, 5),
                                       (2, 700, 16, 3, 2), (2, 333, 6, 4, 7)])
def test_conv0_kernel_matches_plain(cuda_device, dtype, out_dtype, b, t, c, k, s):
    from speechclip_plus_tpu_torch.ops import conv_frontend as cf

    g = torch.Generator(device=cuda_device).manual_seed(2)
    wav = torch.randn(b, t, generator=g, device=cuda_device).to(dtype)
    kernel = (torch.randn(k, 1, c, generator=g, device=cuda_device) * k ** -0.5).to(dtype)
    before = cf.LAUNCHES
    got = cf.conv0(wav, kernel, stride=s, out_dtype=out_dtype)
    assert cf.LAUNCHES == before + 1
    want = cf.plain_conv0(wav, kernel, s, torch.float32)
    assert got.shape == (b, (t - k) // s + 1, c) and got.dtype == out_dtype
    _close(got, want, out_dtype)
    lib = torch.nn.functional.conv1d(wav.float()[:, None], kernel.float().permute(2, 1, 0),
                                     stride=s).transpose(1, 2)
    _close(got, lib, out_dtype)
    assert torch.equal(got, cf.conv0(wav, kernel, stride=s, out_dtype=out_dtype))


@pytest.mark.cuda
def test_conv0_rejects_bad_inputs(cuda_device):
    from speechclip_plus_tpu_torch.ops import conv_frontend as cf

    wav = torch.randn(2, 100, device=cuda_device)
    kernel = torch.randn(10, 1, 8, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        cf.conv0(wav[:, ::2], kernel)
    with pytest.raises(ValueError, match="even"):
        cf.conv0(wav, kernel[..., :7])
    with pytest.raises(ValueError, match="want"):
        cf.conv0(wav, kernel.expand(10, 2, 8))
    with pytest.raises(ValueError, match="shorter"):
        cf.conv0(wav[:, :5], kernel)
    with pytest.raises(TypeError):
        cf.conv0(wav.half(), kernel.half())


# ---- the fused group-norm layer 0 (conv0_gn_gelu) ----

def _gn_case(dev, b, t, c, k, dtype, seed=3):
    """When B >= 2 row 0 of the waveform carries a DC offset and the last row
    is all zero (variance 0: the output is GELU(beta)). In fp32 the offset is
    500 and the samples and taps are multiples of 1/16 and 1/256, so every
    product and partial sum of conv 0 is exact in any order and the
    comparison sees the statistics alone, where a one-pass variance would lose
    five digits; in bf16 it is 100, at which a sample keeps its spread."""
    g = torch.Generator(device=dev).manual_seed(seed)
    wav = torch.randn(b, t, generator=g, device=dev)
    weight = torch.randn(c, 1, k, generator=g, device=dev) * k ** -0.5
    if b >= 2:
        wav[0] += 500.0 if dtype == torch.float32 else 100.0
        wav[-1] = 0.0
    if dtype == torch.float32:
        wav, weight = torch.round(wav * 16) / 16, torch.round(weight * 256) / 256
    gamma = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
    beta = 0.1 * torch.randn(c, generator=g, device=dev)
    return [x.to(dtype) for x in (wav, weight, gamma, beta)]


def _gn_model(wav, weight, gamma, beta, s):
    """The kernel's arithmetic in plain PyTorch: conv 0 as fp32 sums in tap
    order (`plain_conv0`; bf16 products are exact in fp32, so the sums are the
    kernel's), rounded to the dtype, then the statistics and the affine in
    fp64, rounded to the dtype, and GELU. Returns the output, the rounded
    affine value y GELU takes, and the size of the affine's terms,
    (|x - mean| + |mean|) * rstd * |gamma| + |beta|: fp32 holds the mean
    itself only to its own ulps, so a kernel's mean error scales with it."""
    from speechclip_plus_tpu_torch.ops import conv_frontend as cf

    x = cf.plain_conv0(wav, weight.permute(2, 1, 0), s, wav.dtype).transpose(1, 2)
    xd, g, b = x.double(), gamma.double()[:, None], beta.double()[:, None]
    mean = xd.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(xd.var(dim=-1, unbiased=False, keepdim=True) + 1e-5)
    y = ((xd - mean) * rstd * g + b).to(x.dtype)
    terms = ((xd - mean).abs() + mean.abs()) * rstd * g.abs() + b.abs()
    return torch.nn.functional.gelu(y), y, terms.float()


def _ulp(x):
    """One ulp of each bf16 value (2^(e - 8) for |x| in [2^(e-1), 2^e))."""
    _, exp = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), exp - 8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,c,k,s", [(4, 102400, 512, 10, 5), (1, 16000, 512, 10, 5),
                                       (3, 1003, 64, 10, 5), (2, 700, 16, 3, 2),
                                       (2, 333, 6, 4, 7)])
def test_conv0_gn_gelu_kernel_matches_plain(cuda_device, dtype, b, t, c, k, s):
    """Against the kernel's arithmetic with exact statistics (`_gn_model`) and
    the twin (the library composite). The kernel's fp32 statistics hold the
    mean to its own ulps, so its affine value z may differ by a few fp32 ulps
    of the terms' size. fp32: <= 1e-4 x max(1, RMS) + 1.13 x 2^-18 x terms (64
    ulps, carried through GELU's slope of at most 1.13; a one-pass variance
    misses it at the offset row by its square); bf16: z may differ by 2^-16 of
    the terms, and its rounding y by an ulp more (two across a binade edge),
    carried through GELU, plus the output's rounding on both sides: <= 2 x
    (ulp(y) + ulp(out)) + 1.13 x 2^-16 x terms, and in the rows without an
    offset in at most 1e-3 of the elements. The twin's own fp32 statistics
    carry the offset row's mean to its ulps as well: fp32 against it <= 1e-4
    x max(1, RMS) on the other rows; bf16, where its
    library convolution rounds some conv values the other way, the RMS of the
    difference <= 1e-2 x the output's RMS. Reruns are bit-identical."""
    from speechclip_plus_tpu_torch.ops import conv_frontend as cf

    wav, weight, gamma, beta = _gn_case(cuda_device, b, t, c, k, dtype)
    before = cf.GN_LAUNCHES
    got = cf.conv0_gn_gelu(wav, weight, gamma, beta, 1e-5, stride=s)
    assert cf.GN_LAUNCHES == before + 1
    assert got.shape == (b, c, (t - k) // s + 1) and got.dtype == dtype
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, cf.conv0_gn_gelu(wav, weight, gamma, beta, 1e-5, stride=s))
    want, y, terms = _gn_model(wav, weight, gamma, beta, s)
    twin = cf.plain_conv0_gn_gelu(wav, weight, gamma, beta, 1e-5, s)
    err = (got.float() - want.float()).abs()
    rms = want.float().pow(2).mean().sqrt().item()
    if dtype == torch.float32:
        limit = 1e-4 * max(1.0, rms) + 1.13 * 2.0 ** -18 * terms
        assert bool((err <= limit).all()), (err / limit).max().item()
        rows = slice(1 if b >= 2 else 0, b)
        assert (got[rows] - twin[rows]).abs().max().item() <= 1e-4 * max(1.0, rms)
    else:
        limit = 2 * (_ulp(y) + _ulp(want)) + 1.13 * 2.0 ** -16 * terms
        assert bool((err <= limit).all()), (err / limit).max().item()
        plain_rows = err[1:-1] if b >= 3 else err[b - 1:]
        assert (plain_rows > 0).float().mean().item() <= 1e-3
        diff = (got.float() - twin.float()).pow(2).mean().sqrt().item()
        assert diff <= 1e-2 * rms, diff
    if b >= 2:  # the all-zero utterance: GELU(beta) in every frame
        last = torch.nn.functional.gelu(beta.float()).to(dtype)[:, None].expand(c, got.shape[2])
        assert torch.equal(got[-1], last)


@pytest.mark.cuda
def test_frozen_hubert_forward_takes_fused_layer0(cuda_device, monkeypatch):
    """A frozen bf16 HuBERT-base forward launches the fused layer 0 once and
    matches the composite's forward: RMS of the difference of the last hidden
    state and of the weighted sum <= 2e-2 x their RMS (the rare flipped
    roundings of layer 0 carried through 12 bf16 layers)."""
    from speechclip_plus_tpu_torch.models import hubert
    from speechclip_plus_tpu_torch.ops import conv_frontend as cf

    torch.manual_seed(0)
    model = hubert.HubertModel(hubert.HubertConfig(dtype=torch.bfloat16)).to(cuda_device)
    model.requires_grad_(False).eval()
    g = torch.Generator(device=cuda_device).manual_seed(4)
    wav = torch.randn(3, 32000, generator=g, device=cuda_device)
    pad = torch.zeros(3, 32000, dtype=torch.bool, device=cuda_device)
    pad[1, 20000:] = True
    wav = wav.masked_fill(pad, 0.0)
    weights = torch.softmax(torch.randn(13, generator=g, device=cuda_device), 0)
    before = cf.GN_LAUNCHES
    got = model(wav, pad, weights)
    assert cf.GN_LAUNCHES == before + 1
    monkeypatch.setattr(hubert, "conv0_gn_gelu",
                        lambda w, k, ga, be, eps, *, stride: cf.plain_conv0_gn_gelu(
                            w, k, ga, be, eps, stride))
    want = model(wav, pad, weights)
    assert cf.GN_LAUNCHES == before + 1
    for key in ("x", "weighted_sum"):
        a, b_ = got[key].float(), want[key].float()
        rms = b_.pow(2).mean().sqrt().item()
        assert (a - b_).pow(2).mean().sqrt().item() <= 2e-2 * rms, key


@pytest.mark.cuda
def test_conv0_gn_gelu_rejects_bad_inputs(cuda_device):
    from speechclip_plus_tpu_torch.ops import conv_frontend as cf

    wav, weight, gamma, beta = _gn_case(cuda_device, 2, 100, 8, 10, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        cf.conv0_gn_gelu(wav[:, ::2], weight, gamma, beta, 1e-5)
    with pytest.raises(ValueError, match="even"):
        cf.conv0_gn_gelu(wav, weight[:7], gamma[:7], beta[:7], 1e-5)
    with pytest.raises(ValueError, match="taps"):
        cf.conv0_gn_gelu(wav, weight.repeat(1, 1, 2), gamma, beta, 1e-5)
    with pytest.raises(ValueError, match="want"):
        cf.conv0_gn_gelu(wav, weight, gamma[:4], beta, 1e-5)
    with pytest.raises(ValueError, match="want"):
        cf.conv0_gn_gelu(wav[0], weight, gamma, beta, 1e-5)
    with pytest.raises(ValueError, match="shorter"):
        cf.conv0_gn_gelu(wav[:, :5], weight, gamma, beta, 1e-5)
    with pytest.raises(TypeError):
        cf.conv0_gn_gelu(wav.half(), weight.half(), gamma, beta, 1e-5)
    with pytest.raises(ValueError, match="cpu"):
        cf.conv0_gn_gelu(wav, weight.cpu(), gamma, beta, 1e-5)


# ---- K2's attn_bias input, and K1 / K2 at the single-head width dh = 768 ----

def _causal(dev, t, heads=None):
    """The text tower's causal bias (T, T), or (H, T, T) with random
    sub-diagonal entries per head."""
    causal = torch.full((t, t), -1e30, device=dev).triu(1)
    if heads is None:
        return causal
    g = torch.Generator(device=dev).manual_seed(12)
    return causal[None] + torch.randn(heads, t, t, generator=g, device=dev).tril()


def _bwd_case(dev, dtype, b, t, d, heads, p, ab, seed=4):
    x, w_in, b_in, _, _, kb = _block_args(dev, b, t, d)
    kb[0, :] = 0.0
    if ab is not None and t > 1:
        kb[-1, :] = 0.0
        kb[-1, 1] = -1e30  # a masked key that is also above the diagonal for row 0
    x, w_in, b_in = x.to(dtype), w_in.to(dtype), b_in.to(dtype)
    seeds = draw_seed(torch.Generator(device=dev).manual_seed(seed)) if p else None
    ab3 = None if ab is None else ab.reshape(-1, t, t)
    ctx, qkv, lse = fab.attention_forward(x, w_in, b_in, kb, n_heads=heads, seeds=seeds,
                                          keep_prob=1.0 - p, attn_bias=ab3)
    g = torch.Generator(device=dev).manual_seed(5)
    dctx = torch.randn(b, t, d, generator=g, device=dev).to(dtype)
    return x, w_in, b_in, kb, seeds, ab3, ctx, qkv, lse, dctx


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,d,heads,per_head,p", [
    (128, 77, 512, 8, False, 0.0), (4, 77, 512, 8, True, 0.0), (4, 77, 512, 8, False, 0.1),
    (3, 130, 768, 8, True, 0.3), (2, 37, 128, 2, False, 0.0), (2, 64, 128, 2, True, 0.0)])
def test_attention_backward_with_bias_matches_plain(cuda_device, dtype, b, t, d, heads,
                                                    per_head, p):
    """K1 context-only and K2 with the per-head bias (the text tower's causal
    mask and an (H, T, T) bias), ragged T, with and without dropout."""
    ab = _causal(cuda_device, t, heads if per_head else None)
    x, w_in, b_in, kb, seeds, ab3, ctx, qkv, lse, dctx = _bwd_case(
        cuda_device, dtype, b, t, d, heads, p, ab)
    ctx0, _, lse0 = fab.plain_fused_attention_block(
        x.float(), w_in.float(), b_in.float(), None, None, kb, heads, False, seeds=seeds,
        keep_prob=1.0 - p, return_aux=True, attn_bias=ab3)
    _close(ctx, ctx0, dtype)
    assert (lse - lse0).abs().max().item() <= 1e-4  # the lse includes the bias
    before = vjp.LAUNCHES
    got = vjp.attention_backward(qkv, kb, dctx, ctx, lse, n_heads=heads, seeds=seeds,
                                 keep_prob=1.0 - p, attn_bias=ab3)
    assert vjp.LAUNCHES == before + 1
    want = vjp.plain_attention_backward(qkv, kb, dctx.float(), ctx.float(), lse, heads, seeds,
                                        1.0 - p, ab3)
    assert bool(torch.isfinite(got.float()).all())
    _close(got, want, dtype)
    assert torch.equal(got, vjp.attention_backward(
        qkv, kb, dctx, ctx, lse, n_heads=heads, seeds=seeds, keep_prob=1.0 - p, attn_bias=ab3))
    # without the bias the result differs: the kernel does read it
    other = vjp.attention_backward(qkv, kb, dctx, ctx, lse, n_heads=heads, seeds=seeds,
                                   keep_prob=1.0 - p)
    assert (other.float() - got.float()).abs().max().item() > 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,heads,p,bias", [
    (8, 328, 1, 0.1, False), (8, 328, 1, 0.0, False), (3, 37, 1, 0.3, False),
    (2, 65, 1, 0.0, True), (2, 96, 2, 0.1, True), (128, 320, 1, 0.1, False)])
def test_wide_head_kernels_match_plain(cuda_device, dtype, b, t, heads, p, bias):
    """K1 (context-only + lse, and fused-out) and K2 at dh = 768, one head and
    two, ragged T, dropout and the per-head bias."""
    d = 768 * heads
    ab = _causal(cuda_device, t, heads) if bias else None
    x, w_in, b_in, kb, seeds, ab3, ctx, qkv, lse, dctx = _bwd_case(
        cuda_device, dtype, b, t, d, heads, p, ab)
    ctx0, _, lse0 = fab.plain_fused_attention_block(
        x.float(), w_in.float(), b_in.float(), None, None, kb, heads, False, seeds=seeds,
        keep_prob=1.0 - p, return_aux=True, attn_bias=ab3)
    assert bool(torch.isfinite(ctx.float()).all())
    _close(ctx, ctx0, dtype)
    assert (lse - lse0).abs().max().item() <= 1e-4
    again, _, lse2 = fab.attention_forward(x, w_in, b_in, kb, n_heads=heads, seeds=seeds,
                                           keep_prob=1.0 - p, attn_bias=ab3)
    assert torch.equal(ctx, again) and torch.equal(lse, lse2)  # deterministic
    before = vjp.LAUNCHES
    got = vjp.attention_backward(qkv, kb, dctx, ctx, lse, n_heads=heads, seeds=seeds,
                                 keep_prob=1.0 - p, attn_bias=ab3)
    assert vjp.LAUNCHES == before + 1
    want = vjp.plain_attention_backward(qkv, kb, dctx.float(), ctx.float(), lse, heads, seeds,
                                        1.0 - p, ab3)
    assert bool(torch.isfinite(got.float()).all())
    _close(got, want, dtype)
    assert torch.equal(got, vjp.attention_backward(
        qkv, kb, dctx, ctx, lse, n_heads=heads, seeds=seeds, keep_prob=1.0 - p, attn_bias=ab3))


@pytest.mark.cuda
def test_wide_head_fused_out_and_fully_padded_row(cuda_device):
    """K1's fused-out mode at dh = 768, with a fully padded row (finite)."""
    args = _block_args(cuda_device, 3, 70, 768)
    args[5][-1, :] = -1e30
    got = fab.fused_attention_block(*args, n_heads=1)
    want = fab.plain_fused_attention_block(*args, 1, True)
    assert bool(torch.isfinite(got).all())
    _close(got, want, torch.float32)


# ---- K1 / K2 at one head of 1024 (the fixed-K large branches) ----

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("t", [319, 320, 327, 328, 329, 16, 45, 130])
def test_dh1024_kernels_match_plain(cuda_device, dtype, p, t):
    """K1 context-only (with the lse, as in training, and without, as in
    serving: the one-pass q kᵀ of a bf16 context) and K2 at dh = 1024, one
    head: the wide kernels with 16 query rows a block and the backward's other
    rows 8 at a time, at the paths' T (cascaded 8 + 319, hybrid 1 + 8 + 319,
    and their neighbours) and short ragged T, against the twins; bit-identical
    reruns; a launch of each counted as dh = 1024. (The per-head bias at this
    head runs in `test_attention_family_backward_modes`; K1's fused-out mode,
    on no path at this head, in
    `test_fused_out_bf16_error_is_the_context_rounding`.)"""
    b, d = 4, 1024
    x, w_in, b_in, kb, seeds, _, ctx, qkv, lse, dctx = _bwd_case(
        cuda_device, dtype, b, t, d, 1, p, None)
    ctx0, _, lse0 = fab.plain_fused_attention_block(
        x.float(), w_in.float(), b_in.float(), None, None, kb, 1, False, seeds=seeds,
        keep_prob=1.0 - p, return_aux=True)
    assert bool(torch.isfinite(ctx.float()).all())
    _close(ctx, ctx0, dtype)
    assert (lse - lse0).abs().max().item() <= 1e-4
    serve = lambda: fab._run(x, w_in, b_in, None, None, kb, 1, False, seeds=seeds,
                             keep_prob=1.0 - p)
    got = serve()
    _close(got, ctx0, dtype)
    assert torch.equal(got, serve())
    before = fab.DH1024_LAUNCHES
    again, _, lse2 = fab.attention_forward(x, w_in, b_in, kb, n_heads=1, seeds=seeds,
                                           keep_prob=1.0 - p)
    assert torch.equal(ctx, again) and torch.equal(lse, lse2)  # deterministic
    assert fab.DH1024_LAUNCHES == before + 1
    before = vjp.DH1024_LAUNCHES
    got = vjp.attention_backward(qkv, kb, dctx, ctx, lse, n_heads=1, seeds=seeds,
                                 keep_prob=1.0 - p)
    assert vjp.DH1024_LAUNCHES == before + 1
    want = vjp.plain_attention_backward(qkv, kb, dctx.float(), ctx.float(), lse, 1, seeds,
                                        1.0 - p)
    assert bool(torch.isfinite(got.float()).all())
    _close(got, want, dtype)
    assert torch.equal(got, vjp.attention_backward(qkv, kb, dctx, ctx, lse, n_heads=1,
                                                   seeds=seeds, keep_prob=1.0 - p))


@pytest.mark.cuda
def test_head_dim_and_bias_shape_errors(cuda_device):
    args = _block_args(cuda_device, 2, 16, 256)
    with pytest.raises(ValueError, match="head dim"):
        fab.fused_attention_block(*args, n_heads=1)          # dh = 256
    with pytest.raises(ValueError, match="head dim"):
        vjp.fused_attention_block_vjp(*args, n_heads=8)      # dh = 32
    qkv = torch.randn(2, 16, 3 * 256, device=cuda_device)
    z = torch.zeros(2, 16, 256, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        vjp.attention_backward(qkv, None, z, z, torch.zeros(2, 1, 16, device=cuda_device),
                               n_heads=1)
    args = _block_args(cuda_device, 2, 16, 128)
    for bad in (torch.zeros(2, 2, 16, 16, device=cuda_device),   # (B, H, T, T)
                torch.zeros(3, 16, 16, device=cuda_device),      # neither 1 nor H heads
                torch.zeros(16, 15, device=cuda_device)):
        with pytest.raises(ValueError, match="attn_bias"):
            vjp.fused_attention_block_vjp(*args, n_heads=2, attn_bias=bad)
    qkv = torch.randn(2, 16, 3 * 128, device=cuda_device)
    z = torch.zeros(2, 16, 128, device=cuda_device)
    with pytest.raises(ValueError, match="attn_bias"):
        vjp.attention_backward(qkv, None, z, z, torch.zeros(2, 2, 16, device=cuda_device),
                               n_heads=2, attn_bias=torch.zeros(2, 16, 16))  # on the CPU


@pytest.mark.cuda
def test_text_route_gradients_on_the_card(cuda_device):
    """fused_attention_block_vjp with a causal bias (frozen weights, input
    gradient only) against autograd through the plain twin, fp32."""
    b, t, d, heads = 4, 77, 512, 8
    x, w_in, b_in, w_out, b_out, _ = _block_args(cuda_device, b, t, d)
    ab = _causal(cuda_device, t)
    probe = torch.randn(b, t, d, device=cuda_device)
    x1 = x.clone().requires_grad_()
    out = vjp.fused_attention_block_vjp(x1, w_in, b_in, w_out, b_out, None, n_heads=heads,
                                        attn_bias=ab)
    (g1,) = torch.autograd.grad((out * probe).sum(), x1)
    x2 = x.clone().requires_grad_()
    ref = torch.nn.functional.linear(fab.plain_fused_attention_block(
        x2, w_in, b_in, None, None, None, heads, False, attn_bias=ab[None]), w_out, b_out)
    (g2,) = torch.autograd.grad((ref * probe).sum(), x2)
    assert (out - ref).abs().max().item() <= 1e-4
    assert (g1 - g2).abs().max().item() <= 1e-4 * max(1.0, g2.pow(2).mean().sqrt().item())


# ---- the tensor-core attention family: every mode x head dim x dtype, ragged T ----

RAGGED_T = (50, 77, 319, 320, 327, 328, 329, 1499)


def _family_case(dev, dtype, t, dh):
    """Two heads (one at dh = 768 and 1024), three sequences: a whole one, a
    ragged one and a fully padded one."""
    heads = 1 if dh >= 768 else 2
    d = heads * dh
    args = _block_args(dev, 3, t, d, seed=21)
    args[5][-1, :] = -1e30
    return heads, [a.to(dtype) if i < 5 else a for i, a in enumerate(args)]


def _lse_close(lse, lse0):
    """1e-4 absolute; relative on a fully padded row, whose lse is about -1e30."""
    assert ((lse - lse0).abs() <= 1e-4 * lse0.abs().clamp_min(1.0)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [64, 96, 128, 768])
@pytest.mark.parametrize("t", RAGGED_T)
def test_attention_family_forward_modes(cuda_device, dtype, dh, t):
    """K1's attention kernel in every mode a wrapper reaches (fused-out,
    context-only + lse, dropout, per-head bias, gated bias) at one shape:
    against the twin, finite on the padded row, bit-identical reruns."""
    heads, args = _family_case(cuda_device, dtype, t, dh)
    f32 = [a.float() for a in args]
    seeds = draw_seed(torch.Generator(device=cuda_device).manual_seed(31))
    ab, gate = _bias_gate(cuda_device, 3, t, heads)
    modes = {
        "fused-out": dict(),
        "dropout": dict(seeds=seeds, keep_prob=0.9),
        "bias": dict(attn_bias=ab),
        "gate + dropout": dict(attn_bias=ab, attn_gate=gate, seeds=seeds, keep_prob=0.8),
    }
    for name, kw in modes.items():
        got = fab._run(*args, heads, True, **kw)
        assert bool(torch.isfinite(got.float()).all()), name
        # the padded sequence's output (a mean of v over every key) only has to
        # be finite: its small values would lower the RMS the tolerance scales with
        _close(got[:-1], fab.plain_fused_attention_block(*f32, heads, True, **kw)[:-1], dtype)
        assert torch.equal(got, fab._run(*args, heads, True, **kw)), name
        if "attn_gate" in kw:
            continue  # the context-only entry point takes no gate
        ctx, _, lse = fab.attention_forward(*args[:3], args[5], n_heads=heads, **kw)
        ctx0, _, lse0 = fab.plain_fused_attention_block(
            *f32[:3], None, None, args[5], heads, False, return_aux=True, **kw)
        _close(ctx, ctx0, dtype)
        _lse_close(lse, lse0)
        again, _, lse2 = fab.attention_forward(*args[:3], args[5], n_heads=heads, **kw)
        assert torch.equal(ctx, again) and torch.equal(lse, lse2), name


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [768, 1024])
def test_fused_out_bf16_error_is_the_context_rounding(cuda_device, dh):
    """At one wide head, K1's fused-out bf16 block with a gated bias and
    dropout (the family case above, T=320) is held to the twin's 2e-2 x RMS
    beyond half an ulp on top of what rounding the twin's own fp32 context
    to bf16 before the out-projection costs: that rounding is the block's
    design (a bf16 context in a bf16 block), and alone it reaches most of the
    tolerance at this width. The kernel's context itself meets the tolerance
    outright. Prints the three figures."""
    t = 320
    heads, args = _family_case(cuda_device, torch.bfloat16, t, dh)
    f32 = [a.float() for a in args]
    ab, gate = _bias_gate(cuda_device, 3, t, heads)
    kw = dict(attn_bias=ab, attn_gate=gate,
              seeds=draw_seed(torch.Generator(device=cuda_device).manual_seed(31)), keep_prob=0.8)
    out = fab._run(*args, heads, True, **kw)[:-1]
    want = fab.plain_fused_attention_block(*f32, heads, True, **kw)[:-1]
    ctx = fab._run(*args, heads, False, **kw)[:-1]
    ctx0 = fab.plain_fused_attention_block(*f32[:3], None, None, args[5], heads, False, **kw)[:-1]
    rounded = fab.plain_projection(ctx0.to(torch.bfloat16), *f32[3:5]).to(torch.bfloat16)
    exact = fab.plain_projection(ctx0, *f32[3:5])
    found = {"fused-out": _excess(out, want),
             "context rounding alone": _excess(rounded, exact),
             "kernel context": _excess(ctx, ctx0)}
    print(f"dh={dh} fused-out bf16, error beyond half an ulp over RMS: {found}")
    assert found["kernel context"] <= 2e-2, found
    assert found["fused-out"] <= found["context rounding alone"] + 2e-2, found


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [64, 96, 128, 768, 1024])
@pytest.mark.parametrize("t", RAGGED_T)
def test_attention_family_backward_modes(cuda_device, dtype, dh, t):
    """K2 with and without the per-head bias and dropout, from K1's own
    forward (so K2 regenerates K1's mask): against the twin, finite on the
    padded row, bit-identical reruns."""
    heads, args = _family_case(cuda_device, dtype, t, dh)
    x, w_in, b_in, _, _, kb = args
    g = torch.Generator(device=cuda_device).manual_seed(33)
    dctx = torch.randn(3, t, heads * dh, generator=g, device=cuda_device).to(dtype)
    seeds = draw_seed(torch.Generator(device=cuda_device).manual_seed(32))
    for ab in (None, _causal(cuda_device, t, heads)):
        for kw in (dict(), dict(seeds=seeds, keep_prob=0.9)):
            ctx, qkv, lse = fab.attention_forward(x, w_in, b_in, kb, n_heads=heads,
                                                  attn_bias=ab, **kw)
            got = vjp.attention_backward(qkv, kb, dctx, ctx, lse, n_heads=heads, attn_bias=ab,
                                         **kw)
            want = vjp.plain_attention_backward(qkv, kb, dctx.float(), ctx.float(), lse, heads,
                                                kw.get("seeds"), kw.get("keep_prob", 1.0), ab)
            assert bool(torch.isfinite(got.float()).all())
            _close(got, want, dtype)
            assert torch.equal(got, vjp.attention_backward(
                qkv, kb, dctx, ctx, lse, n_heads=heads, attn_bias=ab, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [64, 96])
@pytest.mark.parametrize("t", RAGGED_T)
def test_attention_family_bhtd_kernels(cuda_device, dtype, dh, t):
    """K4 (out + lse) and K5 (no dropout, dropout) from the same forward
    template, on strided views of a packed buffer, with a fully padded row."""
    from speechclip_plus_tpu_torch.nn import flash, fused_attention as fa

    q, k, v, kb = _qkv(cuda_device, 3, 2, t, dh, dtype, True, seed=23)
    q32, k32, v32 = q.float(), k.float(), v.float()
    out, lse = flash.flash_forward(q, k, v, kb)
    out0, lse0 = flash.plain_flash_attention(q32, k32, v32, kb)
    assert bool(torch.isfinite(out.float()).all()) and bool(torch.isfinite(lse).all())
    _close(out, out0, dtype)
    _lse_close(lse, lse0)
    again, lse2 = flash.flash_forward(q, k, v, kb)
    assert torch.equal(out, again) and torch.equal(lse, lse2)
    seeds = draw_seed(torch.Generator(device=cuda_device).manual_seed(34))
    for sd, keep in ((None, 1.0), (seeds, 0.9)):
        got = fa._run(q, k, v, kb, sd, keep)
        assert bool(torch.isfinite(got.float()).all())
        _close(got, fa.plain_fused_attention_dropout(q32, k32, v32, kb, sd, keep), dtype)
        assert torch.equal(got, fa._run(q, k, v, kb, sd, keep))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [64, 96])
def test_attention_family_draws_one_mask(cuda_device, dtype, dh):
    """One (seed, offset) gives K1, K2 and K5 one mask: K5 on K1's projected
    q, k, v returns K1's context, and K2 agrees with the twin that regenerates
    the mask from the same pair."""
    from speechclip_plus_tpu_torch.nn import fused_attention as fa

    b, t, heads = 3, 327, 4
    d = heads * dh
    x, w_in, b_in, _, _, kb = (a.to(dtype) if i < 5 else a
                               for i, a in enumerate(_block_args(cuda_device, b, t, d)))
    seeds = draw_seed(torch.Generator(device=cuda_device).manual_seed(35))
    ctx, qkv, lse = fab.attention_forward(x, w_in, b_in, kb, n_heads=heads, seeds=seeds,
                                          keep_prob=0.9)
    q, k, v = qkv.view(b, t, 3, heads, dh).permute(2, 0, 3, 1, 4).unbind(0)
    same = fa._run(q * dh ** 0.5, k, v, kb, seeds, 0.9).transpose(1, 2).reshape(b, t, d)
    _close(ctx, same, dtype)
    dctx = torch.randn(b, t, d, device=cuda_device).to(dtype)
    got = vjp.attention_backward(qkv, kb, dctx, ctx, lse, n_heads=heads, seeds=seeds,
                                 keep_prob=0.9)
    _close(got, vjp.plain_attention_backward(qkv, kb, dctx.float(), ctx.float(), lse, heads,
                                             seeds, 0.9), dtype)
    other = vjp.attention_backward(qkv, kb, dctx, ctx, lse, n_heads=heads, seeds=seeds + 1,
                                   keep_prob=0.9)
    assert (other.float() - got.float()).abs().max().item() > 1e-3


# x RMS beyond half a bf16 ulp: a fifth of what the twin is allowed. The model
# sums in fp32, the tensor core adds into its accumulator by truncation, which
# alone is up to 2e-3 (measured: 0.3e-3 to 2.1e-3 where the kernels are 5e-3 to
# 15e-3 from the fp32 twin).
MODEL_LIMIT = 4e-3


def _excess(got, want):
    """The largest error beyond half a bf16 ulp, over want's RMS. The ulp is
    that of the larger of the two values: where they straddle a power of two,
    half an ulp of the smaller one is a quarter of the other's rounding."""
    got, want = got.float(), want.float()
    _, exp = torch.frexp(torch.maximum(got.abs(), want.abs()))
    excess = ((got - want).abs() - torch.ldexp(torch.ones_like(want), exp - 9)).clamp_min(0)
    return excess.max().item() / want.pow(2).mean().sqrt().item()


@pytest.mark.cuda
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("b,t,d,heads,causal", [
    (4, 320, 768, 8, False), (4, 327, 768, 1, False), (4, 77, 512, 8, True),
    (4, 320, 768, 12, False), (4, 1499, 128, 2, False), (4, 320, 1024, 8, False),
    (4, 329, 1024, 8, False), (4, 327, 1024, 1, False), (4, 328, 1024, 1, False),
    (4, 639, 512, 8, False), (4, 639, 768, 8, False)])
def test_attention_kernels_match_their_numerical_model(cuda_device, b, t, d, heads, causal, p):
    """The bf16 kernels round what `attention_numerics` says they round: K1's
    attention kernel (context and lse) and K2 agree with the emulation of their
    operand rounding on the same qkv buffer five times closer than the fp32 twin
    has to be met, at the paths' shapes with sequences of every length. So the
    CPU tests of that model speak about these kernels."""
    from speechclip_plus_tpu_torch.nn import attention_numerics as num

    ab = _causal(cuda_device, t) if causal else None
    x, w_in, b_in, kb, seeds, ab3, ctx, qkv, lse, dctx = _bwd_case(
        cuda_device, torch.bfloat16, b, t, d, heads, p, ab)
    keep = 1.0 - p
    ctx_m, lse_m = num.emulated_attention(qkv, kb, heads, "tf32", seeds, keep, ab3,
                                          scores_mode="tf32x3")
    got = vjp.attention_backward(qkv, kb, dctx, ctx, lse, n_heads=heads, seeds=seeds,
                                 keep_prob=keep, attn_bias=ab3)
    dqkv_m = num.emulated_attention_backward(qkv, kb, dctx.float(), ctx.float(), lse, heads,
                                             "tf32", seeds, keep, ab3)
    found = {"ctx": _excess(ctx, ctx_m), "lse": (lse - lse_m).abs().max().item(),
             "dqkv": _excess(got, dqkv_m)}
    print(f"kernel against its numerical model: {found}")
    assert found["ctx"] <= MODEL_LIMIT and found["dqkv"] <= MODEL_LIMIT, found
    assert found["lse"] <= 1e-5, found


# ---- K1a, the projection GEMM (wgmma + TMA at bf16), through its wrapper ----

# (M, N, K) at the paths' widths, M ragged and not a multiple of the 128-row
# tile: the tower's and the branch's qkv and out projections (B=8 x 319, 3 x
# 327), the ViT's (B=64 x 50 + 7), the text tower's (3 x 77, D=512), a tile
# of 129 rows and the qkv shape of a B=128 training step
PROJECTION_SHAPES = [(2552, 2304, 768), (2552, 768, 768), (981, 2304, 768), (3207, 768, 768),
                     (231, 1536, 512), (129, 1536, 512), (37, 768, 768), (40960, 2304, 768)]


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("m,n,k", PROJECTION_SHAPES)
def test_projection_kernel_matches_plain(cuda_device, m, n, k, scaled, out_dtype):
    g = torch.Generator(device=cuda_device).manual_seed(m + n + k)
    x = torch.randn(m, k, generator=g, device=cuda_device).to(torch.bfloat16)
    w = (torch.randn(n, k, generator=g, device=cuda_device) * k ** -0.5).to(torch.bfloat16)
    b = torch.randn(n, generator=g, device=cuda_device) * 0.1
    kw = dict(scale_cols=n // 3 if scaled else 0, scale=0.125, out_dtype=out_dtype)
    before = fab.PROJECTION_LAUNCHES
    got = fab.projection(x, w, b, **kw)
    assert fab.PROJECTION_LAUNCHES == before + 1
    assert got.dtype == out_dtype and tuple(got.shape) == (m, n)
    want = fab.plain_projection(x, w, b, **dict(kw, out_dtype=torch.float32))
    assert bool(torch.isfinite(got.float()).all())
    _close(got, want, out_dtype)
    assert torch.equal(got, fab.projection(x, w, b, **kw))  # no split-K: bit-identical


@pytest.mark.cuda
def test_projection_takes_a_bf16_bias_as_it_is(cuda_device):
    """A bf16 block hands K1a its bias in bf16: read in place, the same sums
    as the bias widened to fp32 first."""
    g = torch.Generator(device=cuda_device).manual_seed(8)
    x = torch.randn(981, 768, generator=g, device=cuda_device).to(torch.bfloat16)
    w = (torch.randn(2304, 768, generator=g, device=cuda_device) / 768 ** 0.5).to(torch.bfloat16)
    b = torch.randn(2304, generator=g, device=cuda_device).to(torch.bfloat16)
    got = fab.projection(x, w, b, scale_cols=768, scale=0.125)
    assert torch.equal(got, fab.projection(x, w, b.float(), scale_cols=768, scale=0.125))


@pytest.mark.cuda
def test_projection_fp32_operands_match_plain(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.randn(3, 77, 512, generator=g, device=cuda_device)
    w = torch.randn(1536, 512, generator=g, device=cuda_device) * 512 ** -0.5
    b = torch.randn(1536, generator=g, device=cuda_device)
    got = fab.projection(x, w, b, scale_cols=512, scale=0.125)
    _close(got, fab.plain_projection(x, w, b, scale_cols=512, scale=0.125), torch.float32)


@pytest.mark.cuda
def test_projection_rejects_bad_inputs(cuda_device):
    bf = torch.bfloat16
    x = torch.randn(40, 64, device=cuda_device).to(bf)
    w = torch.randn(96, 64, device=cuda_device).to(bf)
    b = torch.zeros(96, device=cuda_device)
    shifted = torch.empty(x.numel() + 1, dtype=bf, device=cuda_device)[1:].view(x.shape)
    shifted.copy_(x)  # contiguous, but 2 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="aligned"):
        fab.projection(shifted, w, b)
    with pytest.raises(ValueError, match="multiple of 8"):
        fab.projection(torch.zeros(40, 60, dtype=bf, device=cuda_device),
                       torch.zeros(96, 60, dtype=bf, device=cuda_device), b)
    with pytest.raises(ValueError, match="layout"):
        fab.projection(x, w.T.contiguous(), b)  # (in, out)
    with pytest.raises(ValueError, match="contiguous"):
        fab.projection(torch.zeros(64, 40, dtype=bf, device=cuda_device).T, w, b)
    with pytest.raises(TypeError):
        fab.projection(x.float(), w.float(), b, out_dtype=bf)


# ---- K2 at dh = 768 at the cascaded paths' T ----

def _ctx64(u, kb, heads, seeds, keep):
    """The context of the unscaled packed projection u (B, T, 3D) in float64,
    with the kernels' dropout mask."""
    from speechclip_plus_tpu_torch.ops.random import attention_keep_mask

    b, t, d3 = u.shape
    d = d3 // 3
    q, k, v = (a.reshape(b, t, heads, -1).transpose(1, 2) for a in u.split(d, dim=-1))
    s = q @ k.transpose(-1, -2) * (d // heads) ** -0.5 + kb.double()[:, None, None, :]
    w = torch.softmax(s, dim=-1)
    if seeds is not None:
        w = torch.where(attention_keep_mask(seeds, b, heads, t, keep), w / keep, 0.0)
    return (w @ v).transpose(1, 2).reshape(b, t, d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("b,t", [(8, 319), (8, 327), (8, 328), (5, 45), (3, 130)])
def test_wide_head_backward_at_the_cascaded_shapes(cuda_device, dtype, p, b, t):
    """K2 at one head of 768 against its twin at the cascaded families' T and
    at short ragged T, bit-identical reruns; in fp32 also against a float64
    central difference of the forward in three random directions (1e-4 of
    the larger of the derivative and a random direction's size)."""
    d, heads = 768, 1
    x, w_in, b_in, kb, seeds, _, ctx, qkv, lse, dctx = _bwd_case(
        cuda_device, dtype, b, t, d, heads, p, None)
    keep = 1.0 - p
    before = vjp.WIDE_LAUNCHES
    got = vjp.attention_backward(qkv, kb, dctx, ctx, lse, n_heads=heads, seeds=seeds,
                                 keep_prob=keep)
    assert vjp.WIDE_LAUNCHES == before + 1
    want = vjp.plain_attention_backward(qkv, kb, dctx.float(), ctx.float(), lse, heads, seeds,
                                        keep)
    assert bool(torch.isfinite(got.float()).all())
    _close(got, want, dtype)
    assert torch.equal(got, vjp.attention_backward(qkv, kb, dctx, ctx, lse, n_heads=heads,
                                                   seeds=seeds, keep_prob=keep))
    if dtype != torch.float32:
        return
    u = qkv.double().clone()
    u[..., :d] *= d ** 0.5  # K2's dq is the cotangent of the unscaled projection
    g = torch.Generator(device=cuda_device).manual_seed(t)
    for _ in range(3):
        v = torch.randn(u.shape, generator=g, device=cuda_device, dtype=torch.float64)
        v = v / v.norm() * u.norm()
        loss = lambda e: (_ctx64(u + e * v, kb, heads, seeds, keep) * dctx.double()).sum().item()
        fd = (loss(1e-4) - loss(-1e-4)) / 2e-4
        an = (got.double() * v).sum().item()
        typical = got.double().norm().item() * v.norm().item() / v.numel() ** 0.5
        assert abs(fd - an) <= 1e-4 * max(abs(fd), typical), (fd, an, typical)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("b,t", [(8, 319), (8, 320), (8, 327), (8, 328), (8, 329), (5, 45),
                                 (3, 130), (2, 16)])
def test_dh128_kernels_at_the_large_branch_shapes(cuda_device, dtype, p, b, t):
    """K1 context-only + lse and K2 at 8 heads of 128 (the large branches,
    D=1024) against their twins at the large families' T (the tower's 319
    frames and their CLS rows) and at short ragged T, bit-identical reruns,
    counted as dh=128 launches; in fp32 K2 also against a float64 central
    difference of the forward in three random directions (1e-4 of the larger
    of the derivative and a random direction's size)."""
    d, heads = 1024, 8
    f1, f2 = fab.DH128_LAUNCHES, vjp.DH128_LAUNCHES
    x, w_in, b_in, kb, seeds, _, ctx, qkv, lse, dctx = _bwd_case(
        cuda_device, dtype, b, t, d, heads, p, None)
    assert fab.DH128_LAUNCHES == f1 + 1
    keep = 1.0 - p
    ctx0, _, lse0 = fab.plain_fused_attention_block(
        x.float(), w_in.float(), b_in.float(), None, None, kb, heads, False, seeds=seeds,
        keep_prob=keep, return_aux=True)
    _close(ctx, ctx0, dtype)
    _lse_close(lse, lse0)
    again, _, lse2 = fab.attention_forward(x, w_in, b_in, kb, n_heads=heads, seeds=seeds,
                                           keep_prob=keep)
    assert torch.equal(ctx, again) and torch.equal(lse, lse2)
    got = vjp.attention_backward(qkv, kb, dctx, ctx, lse, n_heads=heads, seeds=seeds,
                                 keep_prob=keep)
    assert vjp.DH128_LAUNCHES == f2 + 1
    want = vjp.plain_attention_backward(qkv, kb, dctx.float(), ctx.float(), lse, heads, seeds,
                                        keep)
    assert bool(torch.isfinite(got.float()).all())
    _close(got, want, dtype)
    assert torch.equal(got, vjp.attention_backward(qkv, kb, dctx, ctx, lse, n_heads=heads,
                                                   seeds=seeds, keep_prob=keep))
    if dtype != torch.float32:
        return
    u = qkv.double().clone()
    u[..., :d] *= (d // heads) ** 0.5  # K2's dq is the cotangent of the unscaled projection
    g = torch.Generator(device=cuda_device).manual_seed(t)
    for _ in range(3):
        v = torch.randn(u.shape, generator=g, device=cuda_device, dtype=torch.float64)
        v = v / v.norm() * u.norm()
        loss = lambda e: (_ctx64(u + e * v, kb, heads, seeds, keep) * dctx.double()).sum().item()
        fd = (loss(1e-4) - loss(-1e-4)) / 2e-4
        an = (got.double() * v).sum().item()
        typical = got.double().norm().item() * v.norm().item() / v.numel() ** 0.5
        assert abs(fd - an) <= 1e-4 * max(abs(fd), typical), (fd, an, typical)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("dh", [64, 96, 768])
@pytest.mark.parametrize("t", [638, 639, 640])
def test_kernels_at_the_mel_lengths(cuda_device, dtype, p, dh, t):
    """K1 context-only + lse and K2 at the mel upstreams' lengths: 638 frames
    for 102400 samples (the cascaded+ branch), 639 with one CLS row (hybrid+,
    parallel) and 640, at the branches' heads (8 of 96 and 8 of 64; one of
    768), against their twins, bit-identical reruns. Prints K2's bf16 error
    beyond half an ulp over RMS."""
    heads = 1 if dh == 768 else 8
    b, d = 4, heads * dh
    x, w_in, b_in, kb, seeds, _, ctx, qkv, lse, dctx = _bwd_case(
        cuda_device, dtype, b, t, d, heads, p, None)
    keep = 1.0 - p
    ctx0, _, lse0 = fab.plain_fused_attention_block(
        x.float(), w_in.float(), b_in.float(), None, None, kb, heads, False, seeds=seeds,
        keep_prob=keep, return_aux=True)
    assert bool(torch.isfinite(ctx.float()).all())
    _close(ctx, ctx0, dtype)
    _lse_close(lse, lse0)
    again, _, lse2 = fab.attention_forward(x, w_in, b_in, kb, n_heads=heads, seeds=seeds,
                                           keep_prob=keep)
    assert torch.equal(ctx, again) and torch.equal(lse, lse2)
    got = vjp.attention_backward(qkv, kb, dctx, ctx, lse, n_heads=heads, seeds=seeds,
                                 keep_prob=keep)
    want = vjp.plain_attention_backward(qkv, kb, dctx.float(), ctx.float(), lse, heads, seeds,
                                        keep)
    assert bool(torch.isfinite(got.float()).all())
    if dtype == torch.bfloat16:
        print(f"K2 dh={dh} T={t} p={p} bf16: beyond half an ulp {_excess(got, want):.3e} x RMS")
    _close(got, want, dtype)
    assert torch.equal(got, vjp.attention_backward(qkv, kb, dctx, ctx, lse, n_heads=heads,
                                                   seeds=seeds, keep_prob=keep))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_fused_out_block_at_the_mel_tower_shape(cuda_device, dtype, p):
    """K1 fused-out, as the mel transformers' layers call it: 12 heads of 64
    over 638 frames (B=8), with and without attention dropout."""
    b, t, d, heads = 8, 638, 768, 12
    args = _block_args(cuda_device, b, t, d)
    args = [a.to(dtype) if i < 5 else a for i, a in enumerate(args)]
    kw = dict(seeds=draw_seed(torch.Generator(device=cuda_device).manual_seed(3)),
              keep_prob=1.0 - p) if p else {}
    before = fab.LAUNCHES
    got = fab._run(*args, heads, True, **kw)
    assert fab.LAUNCHES == before + 1
    want = fab.plain_fused_attention_block(*[a.float() for a in args], heads, True, **kw)
    assert bool(torch.isfinite(got.float()).all())
    _close(got, want, dtype)
    assert torch.equal(got, fab._run(*args, heads, True, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["lstm", "transformer"])
def test_mel_tower_on_the_card_matches_its_cpu_twin(cuda_device, arch):
    """The log-mel frontend and the mel tower (APC's 3 LSTM layers of 512 on
    cuDNN, TF32 off inside the LSTM; TERA's 3 post-norm layers of 768 through
    K1 fused-out) in fp32 on the card against the same weights on the CPU
    (plain twins), on ragged 6.4 s waveforms: 1e-4 abs for the log-mel,
    1e-4 x max(1, RMS) for every hidden state and the weighted sum."""
    from speechclip_plus_tpu_torch.models.mel_upstreams import MelUpstream, MelUpstreamConfig
    from speechclip_plus_tpu_torch.ops.mel import log_mel_spectrogram
    from speechclip_plus_tpu_torch.tasks.builder import init_params

    cfg = MelUpstreamConfig.from_upstream_name("apc" if arch == "lstm" else "tera")
    cpu = MelUpstream(cfg).eval()
    init_params(cpu, torch.Generator().manual_seed(0))
    card = MelUpstream(cfg).eval()
    card.load_state_dict(cpu.state_dict())
    card = card.to(cuda_device)
    g = torch.Generator().manual_seed(7)
    t = 102400
    lens = torch.tensor([t, 80000, 51234, 33000])
    wav = 0.1 * torch.randn(4, t, generator=g)
    pad = torch.arange(t)[None] >= lens[:, None]
    wav = wav.masked_fill(pad, 0.0)
    mel = log_mel_spectrogram(wav)
    assert (log_mel_spectrogram(wav.to(cuda_device)).cpu() - mel).abs().max().item() <= 1e-4
    weights = torch.softmax(torch.linspace(-1.0, 1.0, cfg.num_hidden_states), dim=0)
    with torch.no_grad():
        want = cpu(wav, pad, weights, return_hidden_states=True)
        got = card(wav.to(cuda_device), pad.to(cuda_device), weights.to(cuda_device),
                   return_hidden_states=True)
    assert torch.equal(got["padding_mask"].cpu(), want["padding_mask"])
    assert tuple(want["hidden_states"].shape) == (cfg.num_hidden_states, 4, 638, cfg.d_model)
    for key in ("hidden_states", "weighted_sum"):
        _close(got[key].cpu(), want[key], torch.float32)


# ------------------------------------------------- tensor-parallel shards ----

def _head_shard(w_in, b_in, w_out, r, tp):
    from speechclip_plus_tpu_torch.parallel.tp import shard_tensor

    d = w_out.shape[0]
    return (shard_tensor("in_proj_weight", w_in, 0, r, tp).contiguous(),
            shard_tensor("in_proj_bias", b_in, 0, r, tp).contiguous(),
            shard_tensor("out_proj.weight", w_out, 1, r, tp).contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("p,gated", [(0.0, False), (0.1, False), (0.1, True)])
def test_head_shards_are_the_whole_blocks_heads(cuda_device, dtype, tp, p, gated):
    """K1 on each range of heads: the context equals the whole kernel's
    columns bit for bit (dropout mask and WavLM bias and gate included), and
    the fp32 partial out-projections summed with the bias once pass the
    whole block's bf16 check; each shard call against its twin."""
    b, t, d, heads = 4, 320, 768, 12
    x, w_in, b_in, w_out, b_out, kb = _block_args(cuda_device, b, t, d)
    x, w_in, b_in, w_out, b_out = (a.to(dtype) for a in (x, w_in, b_in, w_out, b_out))
    kw = {}
    if p:
        kw.update(seeds=draw_seed(torch.Generator(device=cuda_device).manual_seed(3)),
                  keep_prob=1.0 - p)
    ab = gate = None
    if gated:
        ab, gate = _bias_gate(cuda_device, b, t, heads)
    whole = fab._run(x, w_in, b_in, None, None, kb, heads, False, attn_bias=ab, attn_gate=gate,
                     **kw)
    want = fab.plain_fused_attention_block(x.float(), w_in.float(), b_in.float(),
                                           w_out.float(), b_out.float(), kb, heads, True,
                                           attn_bias=ab, attn_gate=gate, **kw)
    h, dh = heads // tp, d // heads
    parts = []
    before = fab.SHARD_LAUNCHES
    for r in range(tp):
        wi, bi, wo = _head_shard(w_in, b_in, w_out, r, tp)
        sl = dict(attn_bias=None if ab is None else ab[r * h:(r + 1) * h].contiguous(),
                  attn_gate=None if gate is None else gate[:, r * h:(r + 1) * h].contiguous(),
                  head_offset=r * h, total_heads=heads, **kw)
        ctx = fab._run(x, wi, bi, None, None, kb, h, False, **sl)
        assert torch.equal(ctx, whole[..., r * h * dh:(r + 1) * h * dh]), r
        part = fab._run(x, wi, bi, wo, b_out, kb, h, True, partial=True, **sl)
        assert part.dtype == torch.float32 and part.shape == (b, t, d)
        f32 = (x.float(), wi.float(), bi.float())
        twin = fab.plain_fused_attention_block(*f32, wo.float(), None, kb, h, True, partial=True,
                                               **sl)
        err, rms = (part - twin).abs(), twin.pow(2).mean().sqrt().item()
        if dtype == torch.float32:
            assert err.max().item() <= 1e-4 * max(1.0, rms), r
        else:  # beyond one bf16 ulp of each context element, through |Wo|
            ctx0 = fab.plain_fused_attention_block(*f32, None, None, kb, h, False, **sl).to(dtype)
            _, exp = torch.frexp(ctx0.float())
            explained = torch.nn.functional.linear(
                torch.ldexp(torch.ones_like(ctx0, dtype=torch.float32), exp - 8),
                wo.float().abs())
            assert (err - explained).clamp_min(0).max().item() <= 2e-2 * rms, r
        parts.append(part)
    assert fab.SHARD_LAUNCHES == before + 2 * tp
    _close((sum(parts) + b_out.float()).to(dtype), want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_fused_attention_dropout_head_shards(cuda_device, dtype, tp, p):
    """K5 on each range of heads equals the whole kernel's heads bit for bit."""
    from speechclip_plus_tpu_torch.nn import fused_attention as fa

    b, heads, t, dh = 4, 12, 320, 64
    q, k, v, kb = _qkv(cuda_device, b, heads, t, dh, dtype, True)
    seeds = draw_seed(torch.Generator(device=cuda_device).manual_seed(3)) if p else None
    whole = fa._run(q, k, v, kb, seeds, 1.0 - p)
    h = heads // tp
    before = fa.SHARD_LAUNCHES
    for r in range(tp):
        sl = slice(r * h, (r + 1) * h)
        got = fa._run(q[:, sl], k[:, sl], v[:, sl], kb, seeds, 1.0 - p, r * h, heads)
        assert torch.equal(got, whole[:, sl]), r
        twin = fa.plain_fused_attention_dropout(q[:, sl].float(), k[:, sl].float(),
                                                v[:, sl].float(), kb, seeds, 1.0 - p, r * h,
                                                heads)
        _close(got, twin, dtype)
    assert fa.SHARD_LAUNCHES == before + tp


def _vocab_shards(x, en, mask, tp, merge=True):
    """K3's halves on each of tp vocabulary shards, merged as a model group
    merges them (one process stands in for the ranks)."""
    v_r = en.shape[0] // tp
    rows = [fk.vq_rows(x, en[r * v_r:(r + 1) * v_r].contiguous(),
                       mask[r * v_r:(r + 1) * v_r].contiguous(), r * v_r) for r in range(tp)]
    k, ent, m, z = fk.vq_combine(torch.stack([s for s, _ in rows], dim=1),
                                 torch.stack([bi for _, bi in rows], dim=0))
    psum = torch.cat([fk.vq_cols(x, en[r * v_r:(r + 1) * v_r].contiguous(),
                                 mask[r * v_r:(r + 1) * v_r].contiguous(), m, z)
                      for r in range(tp)])
    return k, ent, psum


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("n", [1024, 9600])
def test_cosine_vq_vocabulary_shards(cuda_device, dtype, tp, n):
    """K3 on vocabulary shards merged across them: the whole kernel's k bit
    for bit, ent and psum to rtol 1e-3."""
    d, v = 512, 8112
    x, en = _vq_inputs(cuda_device, dtype, n, d, v)
    mask = fk.column_mask(v, SPECIAL, cuda_device)
    k1, e1, p1 = fk.cosine_vq_stats(x, en, mask)
    k, ent, psum = _vocab_shards(x, en, mask, tp)
    assert torch.equal(k, k1)
    torch.testing.assert_close(ent, e1, rtol=1e-3, atol=0)
    torch.testing.assert_close(psum, p1, rtol=1e-3, atol=0)
    k0, e0, p0 = fk.plain_cosine_vq_stats(x, en, mask)
    torch.testing.assert_close(ent, e0, rtol=1e-3, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cosine_vq_shard_ties_go_to_the_lowest_id(cuda_device, dtype):
    """Exact ties across a shard boundary resolve to the lowest global id."""
    n, d, v, tp = 600, 512, 8112, 2
    x, en = _vq_inputs(cuda_device, dtype, n, d, v, seed=3)
    sources = 4 + 8 * torch.arange(250, device=cuda_device)
    en[sources + v // 2] = en[sources]  # the same vector in the other shard
    src = sources[torch.arange(n, device=cuda_device) % 250]
    x = en[src].contiguous()
    k, _, _ = _vocab_shards(x, en, fk.column_mask(v, SPECIAL, cuda_device), tp)
    assert torch.equal(k.long(), src)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("n", [1024, 9600])
def test_st_backward_vocabulary_shards(cuda_device, dtype, tp, n):
    """K3b's halves on vocabulary shards: the statistics gathered in column
    order, the shards' dx and dt summed, within K3b's tolerances of the whole
    kernel's; each shard's half against its twin."""
    d, v = 512, 8112
    x, cot, en, norms = _st_inputs(cuda_device, dtype, n, d, v)
    mask = fk.column_mask(v, SPECIAL, cuda_device)
    temp = torch.full((), 0.1, device=cuda_device)
    dx1, dt1 = fk.st_backward(x, cot, en, norms, mask, temp)
    v_r = v // tp
    cut = lambda a, r: a[r * v_r:(r + 1) * v_r].contiguous()
    stats = torch.cat([fk.st_backward_stats(x, cot, cut(en, r), cut(norms, r), cut(mask, r),
                                            temp) for r in range(tp)], dim=1)
    halves = [fk.st_backward_apply(x, cot, cut(en, r), cut(norms, r), cut(mask, r), temp, stats)
              for r in range(tp)]
    dx, dt = sum(h[0] for h in halves), sum(h[1] for h in halves)
    rms = dx1.pow(2).mean().sqrt().item()
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    assert (dx - dx1).abs().max().item() <= tol * rms
    s = x.float() @ en.float().T
    p = torch.softmax(torch.where(mask.bool()[None], -torch.inf, s / 0.1), dim=-1)
    u = (cot.float() @ en.float().T) * norms
    scale = (p * (u - (p * u).sum(-1, keepdim=True)) * s).abs().sum().item() / 0.01
    assert abs(dt.item() - dt1.item()) <= 1e-4 * scale
    twin_stats = torch.cat([fk.plain_st_backward_stats(x, cot, cut(en, r), cut(norms, r),
                                                       cut(mask, r), temp) for r in range(tp)],
                           dim=1)
    for r in range(tp):
        dx0, _ = fk.plain_st_backward_apply(x, cot, cut(en, r), cut(norms, r), cut(mask, r),
                                            temp, twin_stats)
        assert (halves[r][0] - dx0).abs().max().item() <= tol * rms, r
