"""The branch attention's backward (K2) and K1's dropout mode, on the CPU.

The port's differentiable block (`fused_attention_block_vjp`: K1
context-only forward, K2 backward, plain matmuls for dx / dWqkv / dbqkv and
the out-projection) runs its plain twins on CPU tensors. Against the JAX
`fused_attention_block_vjp` in Pallas interpret mode at dropout 0: the output
and the gradients of x and all eight projection parameters to 1e-5 abs (fp32
on both sides, sums in another order). With dropout, masks cannot match
across frameworks, so K2's twin is held to central finite differences of the
port's own seeded forward (rel. 2e-3, fp32 at eps 1e-2), and to plain
autograd through K1's twin with the same mask (1e-5 abs).

The CUDA kernels against these twins are in `test_torch_cuda_kernels.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechclip_plus_tpu.nn.fused_attention_block_vjp import (
    fused_attention_block_vjp as jax_vjp,
)
from speechclip_plus_tpu_torch.nn import fused_attention_block as fab
from speechclip_plus_tpu_torch.nn import fused_attention_block_vjp as vjp
from speechclip_plus_tpu_torch.nn.attention import MultiheadAttention, padding_bias
from speechclip_plus_tpu_torch.ops.random import draw_seed

ATOL = 1e-5


def _case(seed, b, t, d):
    rng = np.random.RandomState(seed)
    mk = lambda *s, scale=1.0: (rng.randn(*s) * scale).astype(np.float32)
    x = mk(b, t, d)
    w = {n: mk(d, d, scale=d ** -0.5) for n in "qkvo"}   # JAX (in, out) kernels
    bias = {n: mk(d, scale=0.1) for n in "qkvo"}
    lens = np.array([t] + list(rng.randint(1, t + 1, size=b - 1)))
    kb = np.where(np.arange(t)[None, :] >= lens[:, None], -1e30, 0.0).astype(np.float32)
    probe = mk(b, t, d)
    return x, w, bias, kb, probe


def _port_params(w, bias):
    return [torch.from_numpy(a).requires_grad_(True) for a in (
        np.concatenate([w["q"], w["k"], w["v"]], 1).T.copy(),
        np.concatenate([bias["q"], bias["k"], bias["v"]]),
        w["o"].T.copy(), bias["o"])]


@pytest.mark.parametrize("b,t,d,heads", [(3, 37, 48, 4), (2, 50, 96, 8), (2, 21, 40, 2)])
def test_gradients_match_jax_kernel(b, t, d, heads):
    x, w, bias, kb, probe = _case(0, b, t, d)

    def jloss(x, w, bias):
        out = jax_vjp(x, *(a for n in "qkvo" for a in (w[n], bias[n])), jnp.asarray(kb),
                      n_heads=heads, dtype=jnp.float32, interpret=True)
        return (out * probe).sum(), out

    (_, jout), (jdx, jdw, jdb) = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), {n: jnp.asarray(a) for n, a in w.items()},
        {n: jnp.asarray(a) for n, a in bias.items()})

    xt = torch.from_numpy(x).requires_grad_(True)
    w_in, b_in, w_out, b_out = _port_params(w, bias)
    out = vjp.fused_attention_block_vjp(xt, w_in, b_in, w_out, b_out, torch.from_numpy(kb),
                                        n_heads=heads)
    (out * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=ATOL, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), atol=ATOL, rtol=0)
    jw_in = np.concatenate([np.asarray(jdw[n]) for n in "qkv"], 1).T
    jb_in = np.concatenate([np.asarray(jdb[n]) for n in "qkv"])
    for got, want, name in ((w_in.grad, jw_in, "w_in"), (b_in.grad, jb_in, "b_in"),
                            (w_out.grad, np.asarray(jdw["o"]).T, "w_out"),
                            (b_out.grad, np.asarray(jdb["o"]), "b_out")):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0, err_msg=name)


def _dropout_loss(x, w_in, b_in, kb, probe, heads, seeds, keep):
    return (vjp._AttnCore.apply(x, w_in, b_in, kb, heads, seeds, keep, None) * probe).sum()


@pytest.mark.parametrize("t,p", [(37, 0.1), (21, 0.3)])
def test_dropout_backward_matches_finite_differences(t, p):
    x, w, bias, kb, probe = _case(1, 2, t, 48)
    x, kb, probe = (torch.from_numpy(a) for a in (x, kb, probe))
    w_in, b_in = (a.detach() for a in _port_params(w, bias)[:2])
    seeds = draw_seed(torch.Generator().manual_seed(4))
    args = [a.clone().requires_grad_(True) for a in (x, w_in, b_in)]
    grads = torch.autograd.grad(_dropout_loss(*args, kb, probe, 4, seeds, 1.0 - p), args)
    gen = torch.Generator().manual_seed(5)
    for i, (a, g) in enumerate(zip((x, w_in, b_in), grads)):
        v = torch.randn(a.shape, generator=gen)
        v = v / v.norm() * a.norm()
        eps = 1e-2
        shifted = lambda sign: [c + sign * eps * v if j == i else c
                                for j, c in enumerate((x, w_in, b_in))]
        fd = (_dropout_loss(*shifted(1), kb, probe, 4, seeds, 1.0 - p)
              - _dropout_loss(*shifted(-1), kb, probe, 4, seeds, 1.0 - p)) / (2 * eps)
        an = (g * v).sum()
        assert abs(float(fd - an)) <= 2e-3 * abs(float(fd)), (i, float(fd), float(an))


def test_dropout_backward_matches_autograd_of_the_twin():
    x, w, bias, kb, probe = _case(2, 3, 29, 48)
    kb, probe = torch.from_numpy(kb), torch.from_numpy(probe)
    w_in, b_in = (a.detach() for a in _port_params(w, bias)[:2])
    seeds = draw_seed(torch.Generator().manual_seed(6))
    a1 = [t.clone().requires_grad_(True) for t in (torch.from_numpy(x), w_in, b_in)]
    g1 = torch.autograd.grad(_dropout_loss(*a1, kb, probe, 4, seeds, 0.9), a1)
    a2 = [t.clone().requires_grad_(True) for t in (torch.from_numpy(x), w_in, b_in)]
    ctx = fab.plain_fused_attention_block(a2[0], a2[1], a2[2], None, None, kb, 4, False,
                                          seeds=seeds, keep_prob=0.9)
    g2 = torch.autograd.grad((ctx * probe).sum(), a2)
    for got, want in zip(g1, g2):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


def test_k1_dropout_twin_applies_the_mask():
    """K1's twin with dropout: ctx = (p * keep / 0.9) v with p = softmax(s);
    the log-sum-exp it returns recomputes p; no dropout without a seed."""
    x, w, bias, kb, _ = _case(3, 2, 19, 32)
    xt, kbt = torch.from_numpy(x), torch.from_numpy(kb)
    w_in, b_in, w_out, b_out = (a.detach() for a in _port_params(w, bias))
    seeds = draw_seed(torch.Generator().manual_seed(7))
    ctx, qkv, lse = fab.attention_forward(xt, w_in, b_in, kbt, n_heads=2, seeds=seeds,
                                          keep_prob=0.9)
    q, k, v = (a.reshape(2, 19, 2, 16).transpose(1, 2) for a in qkv.split(32, dim=-1))
    s = q @ k.transpose(-1, -2) + kbt[:, None, None, :]
    p = torch.exp(s - lse[..., None])
    torch.testing.assert_close(p, torch.softmax(s, dim=-1), rtol=0, atol=1e-6)
    from speechclip_plus_tpu_torch.ops.random import attention_keep_mask
    keep = attention_keep_mask(seeds, 2, 2, 19, 0.9)
    want = ((p * keep / 0.9) @ v).transpose(1, 2).reshape(2, 19, 32)
    torch.testing.assert_close(ctx, want, rtol=0, atol=1e-6)
    no_drop = fab.fused_attention_block(xt, w_in, b_in, w_out, b_out, kbt, n_heads=2)
    drop = fab.fused_attention_block(xt, w_in, b_in, w_out, b_out, kbt, n_heads=2,
                                     dropout_rate=0.1, generator=torch.Generator().manual_seed(1))
    plain = fab.fused_attention_block(xt, w_in, b_in, w_out, b_out, kbt, n_heads=2,
                                      dropout_rate=0.1)  # no generator: deterministic
    assert torch.equal(plain, no_drop) and not torch.equal(drop, no_drop)


def test_branch_module_routes_through_the_vjp_block():
    """MultiheadAttention(fuse_out=False) takes K1 + K2: its gradients equal
    plain autograd through the same math (dropout off)."""
    x, w, bias, kb, probe = _case(4, 2, 23, 48)
    mha = MultiheadAttention(48, 4, fuse_out=False)
    w_in, b_in, w_out, b_out = (a.detach() for a in _port_params(w, bias))
    with torch.no_grad():
        for dst, src in ((mha.in_proj_weight, w_in), (mha.in_proj_bias, b_in),
                         (mha.out_proj.weight, w_out), (mha.out_proj.bias, b_out)):
            dst.copy_(src)
    mask = torch.from_numpy(kb < -1e20)
    xt = torch.from_numpy(x).requires_grad_(True)
    (mha(xt, key_padding_bias=padding_bias(mask)) * torch.from_numpy(probe)).sum().backward()
    x2 = torch.from_numpy(x).requires_grad_(True)
    ref = torch.nn.functional.linear(fab.plain_fused_attention_block(
        x2, w_in, b_in, None, None, torch.from_numpy(kb), 4, False), w_out, b_out)
    (ref * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), x2.grad.numpy(), atol=ATOL, rtol=0)
    assert mha.in_proj_weight.grad is not None and mha.out_proj.weight.grad is not None
