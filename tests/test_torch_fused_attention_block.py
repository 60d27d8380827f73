"""PyTorch port of the fused attention block (K1) against the JAX kernel.

CPU: the port's plain twin (what its wrapper runs on a CPU tensor) against
the JAX Pallas kernel in interpret mode, in fp32, for both forward modes:
out-projection fused (`fused_attention_block`) and context-only (the branch
path, `fused_attention_block_vjp`, whose out-projection is plain XLA). Odd T
(not a multiple of 16), ragged key padding and head dims that are not powers
of two. Tolerance 2e-5 abs: fp32 on both sides, sums in another order.

The CUDA kernels against the plain twin are in `test_torch_cuda_kernels.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechclip_plus_tpu.nn.fused_attention_block import fused_attention_block as jax_fab
from speechclip_plus_tpu.nn.fused_attention_block_vjp import (
    fused_attention_block_vjp as jax_fab_vjp,
)
from speechclip_plus_tpu_torch.nn import fused_attention_block as fab
from speechclip_plus_tpu_torch.nn.attention import MultiheadAttention, padding_bias

ATOL = 2e-5


def _case(seed, b, t, d, padded=True):
    rng = np.random.RandomState(seed)
    mk = lambda *s, scale=1.0: (rng.randn(*s) * scale).astype(np.float32)
    x = mk(b, t, d)
    w = {n: mk(d, d, scale=d ** -0.5) for n in ("q", "k", "v", "o")}
    bias = {n: mk(d, scale=0.1) for n in ("q", "k", "v", "o")}
    lens = np.array([t] + list(rng.randint(1, t + 1, size=b - 1)))
    kpm = np.arange(t)[None, :] >= lens[:, None]
    if not padded:
        kpm[:] = False
    kb = np.where(kpm, -1e30, 0.0).astype(np.float32)
    return x, w, bias, kb


def _jax(fn, x, w, bias, kb, heads):
    out = fn(jnp.asarray(x), *(jnp.asarray(a) for n in "qkvo" for a in (w[n], bias[n])),
             jnp.asarray(kb), n_heads=heads, dtype=jnp.float32, interpret=True)
    return np.asarray(out)


def _port_args(x, w, bias, kb):
    """torch layout: packed (3D, D) in-proj, (out, in) weights."""
    w_in = torch.from_numpy(np.concatenate([w["q"], w["k"], w["v"]], 1).T.copy())
    b_in = torch.from_numpy(np.concatenate([bias["q"], bias["k"], bias["v"]]))
    return (torch.from_numpy(x), w_in, b_in, torch.from_numpy(w["o"].T.copy()),
            torch.from_numpy(bias["o"]), torch.from_numpy(kb))


@pytest.mark.parametrize("t,d,heads", [(37, 48, 4), (64, 64, 4), (19, 72, 3)])
def test_fused_out_matches_jax_kernel(t, d, heads):
    x, w, bias, kb = _case(0, 3, t, d)
    want = _jax(jax_fab, x, w, bias, kb, heads)
    got = fab.fused_attention_block(*_port_args(x, w, bias, kb), n_heads=heads)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("t,d,heads", [(37, 48, 4), (50, 96, 8), (21, 40, 2)])
def test_context_only_matches_jax_vjp_kernel(t, d, heads):
    x, w, bias, kb = _case(1, 3, t, d)
    want = _jax(jax_fab_vjp, x, w, bias, kb, heads)
    xt, w_in, b_in, w_out, b_out, kbt = _port_args(x, w, bias, kb)
    ctx = fab.fused_attention_block(xt, w_in, b_in, w_out, b_out, kbt, n_heads=heads,
                                    fuse_out=False)
    got = torch.nn.functional.linear(ctx, w_out, b_out)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_multihead_attention_module_routes_both_modes():
    x, w, bias, kb = _case(2, 2, 33, 48)
    xt, w_in, b_in, w_out, b_out, _ = _port_args(x, w, bias, kb)
    mask = torch.from_numpy(kb < -1e20)
    outs = []
    for fuse_out in (True, False):
        mha = MultiheadAttention(48, 4, fuse_out=fuse_out)
        with torch.no_grad():
            mha.in_proj_weight.copy_(w_in)
            mha.in_proj_bias.copy_(b_in)
            mha.out_proj.weight.copy_(w_out)
            mha.out_proj.bias.copy_(b_out)
            outs.append(mha(xt, key_padding_bias=padding_bias(mask)))
    want = _jax(jax_fab, x, w, bias, kb, 4)
    for got in outs:
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_no_padding_and_no_bias_agree():
    x, w, bias, kb = _case(3, 2, 24, 48, padded=False)
    args = _port_args(x, w, bias, kb)
    with_bias = fab.fused_attention_block(*args, n_heads=4)
    without = fab.fused_attention_block(*args[:5], None, n_heads=4)
    np.testing.assert_allclose(with_bias.numpy(), without.numpy(), atol=1e-6, rtol=0)


def test_backward_raises():
    x, w, bias, kb = _case(4, 2, 16, 48)
    xt, *rest = _port_args(x, w, bias, kb)
    xt.requires_grad_(True)
    out = fab.fused_attention_block(xt, *rest, n_heads=4)
    with pytest.raises(NotImplementedError, match="forward-only"):
        out.sum().backward()


@pytest.mark.parametrize("kwargs", [
    # every mode is ported now (dropout: test_torch_dropout_optim.py; bias and
    # gate: test_torch_wavlm.py); what still raises is a call the modes cannot
    # mean: a gate without its bias, a bias or a gate of another shape
    dict(attn_gate=torch.zeros(2, 4, 16)),
    dict(attn_bias=torch.zeros(3, 16, 16)),
    dict(attn_bias=torch.zeros(16, 16), attn_gate=torch.zeros(2, 4, 15)),
])
def test_training_modes_raise(kwargs):
    x, w, bias, kb = _case(5, 2, 16, 48)
    with pytest.raises(ValueError):
        fab.fused_attention_block(*_port_args(x, w, bias, kb), n_heads=4, **kwargs)
