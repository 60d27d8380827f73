"""The port's hand-written CUDA kernels against their plain PyTorch twins, on
the card (every test is marked `cuda` and skips without one).

This file imports torch and the port only, never jax, so it runs on a GPU
machine without JAX: `python -m pytest --noconftest -m cuda
tests/test_torch_cuda_kernels.py -q`. The CPU parity of the twins with the
JAX kernels is in `test_torch_fused_attention_block.py` and
`test_torch_fused_keyword.py`.

Tolerances: fp32 1e-4 abs (K1) or 1e-4 x max(1, RMS) (K1 with dropout, K2);
bf16 K1 and K2 error beyond half an ulp of the bf16 output <= 2e-2 x the
output's RMS; K3 targets equal wherever the top-2 margin exceeds 1e-3 (bf16)
or 1e-5 (fp32), ent and psum to rtol 1e-3; K3b dx to 1e-4 (fp32) or 1e-2
(bf16) x RMS and dt to 1e-4 x the sum of its terms' sizes. K2 and K3b repeat
bit for bit (no float atomics).
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,v", [(600, 512, 8112), (4800, 512, 8112), (9600, 512, 8112),
                                   (37, 64, 300)])
def test_cosine_vq_kernel_matches_plain(cuda_device, dtype, n, d, v):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.nn.functional.normalize(torch.randn(n, d, generator=g, device=cuda_device), dim=-1)
    en = torch.nn.functional.normalize(torch.randn(v, d, generator=g, device=cuda_device), dim=-1)
    x, en = x.to(dtype).contiguous(), en.to(dtype).contiguous()
    mask = fk.column_mask(v, SPECIAL, cuda_device)
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,v", [(9600, 512, 8112), (37, 64, 300)])
def test_st_backward_kernel_matches_plain(cuda_device, dtype, n, d, v):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.nn.functional.normalize(torch.randn(n, d, generator=g, device=cuda_device), dim=-1)
    cot = torch.randn(n, d, generator=g, device=cuda_device) * 1e-3
    emb = torch.randn(v, d, generator=g, device=cuda_device) * 0.1
    norms = emb.norm(dim=-1).clamp_min(1e-8)
    en = (emb / norms[:, None]).to(dtype).contiguous()
    x, cot = x.to(dtype).contiguous(), cot.to(dtype).contiguous()
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
