"""K2's `attn_bias` input and the text tower's fused-attention route, on the CPU.

The port's differentiable block with a per-head bias (K1 context-only forward
and K2 backward, here their plain twins) against the JAX
`fused_attention_block_vjp(..., attn_bias=...)` in Pallas interpret mode: a
causal (T, T) bias and an (H, T, T) bias, with a key-padding bias on top (a
masked key above the diagonal carries both -1e30 terms). Output and the
gradients of x and all eight projection parameters to 1e-5 abs (fp32 on both
sides, sums in another order), and the bias takes no gradient. K2's twin with
bias and dropout together is held to plain autograd through K1's twin with
the same mask (1e-5 abs).

The text tower with `ClipConfig.text_fused_attention_vjp` against the same
weights with the knob off, and against the JAX tower with the knob on:
`encode_keywords` values and keyword-input gradients to 1e-5 abs. The three
`text_remat_mode`s give the knob-off values and gradients (recomputing
changes no value: 1e-6 abs). A bias the kernels cannot take (4-D, or a wrong
head count or length) raises instead of being cut to its first entry.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechclip_plus_tpu.models.clip import ClipConfig as JClipConfig
from speechclip_plus_tpu.models.clip import ClipModel as JClipModel
from speechclip_plus_tpu.nn.fused_attention_block_vjp import (
    fused_attention_block_vjp as jax_vjp,
)
from speechclip_plus_tpu_torch.checkpoint.from_jax import load_clip
from speechclip_plus_tpu_torch.models.clip import ClipConfig, ClipModel
from speechclip_plus_tpu_torch.nn import fused_attention_block as fab
from speechclip_plus_tpu_torch.nn import fused_attention_block_vjp as vjp
from speechclip_plus_tpu_torch.nn.attention import MultiheadAttention
from speechclip_plus_tpu_torch.ops.random import draw_seed
from test_torch_fused_attention_block_vjp import _case, _port_params

ATOL = 1e-5


def _bias(kind, t, heads, seed=3):
    causal = np.where(np.tril(np.ones((t, t), bool)), 0.0, -1e30).astype(np.float32)
    if kind == "causal":
        return causal
    rng = np.random.RandomState(seed)
    return causal[None] + np.tril(rng.randn(heads, t, t)).astype(np.float32)


@pytest.mark.parametrize("kind,b,t,d,heads", [
    ("causal", 3, 16, 32, 4), ("heads", 2, 21, 48, 4), ("causal", 2, 37, 64, 8),
    ("heads", 2, 16, 32, 1)])
def test_bias_gradients_match_jax_kernel(kind, b, t, d, heads):
    x, w, bias, kb, probe = _case(0, b, t, d)
    kb[0, :] = 0.0
    kb[-1, :] = 0.0
    kb[-1, 1] = -1e30  # masked and, for query 0, above the diagonal: -2e30
    ab = _bias(kind, t, heads)

    def jloss(x, w, bias):
        out = jax_vjp(x, *(a for n in "qkvo" for a in (w[n], bias[n])), jnp.asarray(kb),
                      n_heads=heads, dtype=jnp.float32, interpret=True,
                      attn_bias=jnp.asarray(ab))
        return (out * probe).sum(), out

    (_, jout), (jdx, jdw, jdb) = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), {n: jnp.asarray(a) for n, a in w.items()},
        {n: jnp.asarray(a) for n, a in bias.items()})

    xt = torch.from_numpy(x).requires_grad_(True)
    abt = torch.from_numpy(ab).requires_grad_(True)
    w_in, b_in, w_out, b_out = _port_params(w, bias)
    out = vjp.fused_attention_block_vjp(xt, w_in, b_in, w_out, b_out, torch.from_numpy(kb),
                                        n_heads=heads, attn_bias=abt)
    (out * torch.from_numpy(probe)).sum().backward()
    assert bool(torch.isfinite(out).all()) and abt.grad is None  # no gradient for the bias
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=ATOL, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), atol=ATOL, rtol=0)
    jw_in = np.concatenate([np.asarray(jdw[n]) for n in "qkv"], 1).T
    jb_in = np.concatenate([np.asarray(jdb[n]) for n in "qkv"])
    for got, want, name in ((w_in.grad, jw_in, "w_in"), (b_in.grad, jb_in, "b_in"),
                            (w_out.grad, np.asarray(jdw["o"]).T, "w_out"),
                            (b_out.grad, np.asarray(jdb["o"]), "b_out")):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("kind,p", [("causal", 0.1), ("heads", 0.3), ("heads", 0.0)])
def test_bias_and_dropout_compose_in_the_twin(kind, p):
    """K2's twin with bias x dropout equals plain autograd through K1's twin
    with the same bias and the same mask; the lse K1 hands over holds the bias."""
    b, t, d, heads = 3, 29, 48, 4
    x, w, bias, kb, probe = _case(2, b, t, d)
    kb, probe = torch.from_numpy(kb), torch.from_numpy(probe)
    ab = torch.from_numpy(_bias(kind, t, heads)).reshape(-1, t, t)
    w_in, b_in = (a.detach() for a in _port_params(w, bias)[:2])
    seeds = draw_seed(torch.Generator().manual_seed(6)) if p else None
    a1 = [a.clone().requires_grad_(True) for a in (torch.from_numpy(x), w_in, b_in)]
    core = vjp._AttnCore.apply(*a1, kb, heads, seeds, 1.0 - p, ab)
    g1 = torch.autograd.grad((core * probe).sum(), a1)
    a2 = [a.clone().requires_grad_(True) for a in (torch.from_numpy(x), w_in, b_in)]
    ctx, qkv, lse = fab.plain_fused_attention_block(
        a2[0], a2[1], a2[2], None, None, kb, heads, False, seeds=seeds, keep_prob=1.0 - p,
        attn_bias=ab, return_aux=True)
    g2 = torch.autograd.grad((ctx * probe).sum(), a2)
    for got, want in zip(g1, g2):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)
    q, k, _ = (a.reshape(b, t, heads, -1).transpose(1, 2) for a in qkv.detach().split(d, -1))
    s = q @ k.transpose(-1, -2) + kb[:, None, None, :] + ab[None]
    torch.testing.assert_close(lse.detach(), torch.logsumexp(s, -1), rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 4, 16, 16), (3, 16, 16), (16, 15), (4, 15, 16), (16,)])
def test_bad_bias_shapes_raise(shape):
    """A (B, H, T, T) bias is not cut to its first entry; a wrong head count
    or length is not broadcast."""
    x, w, bias, kb, _ = _case(1, 2, 16, 32)
    w_in, b_in, w_out, b_out = (a.detach() for a in _port_params(w, bias))
    bad = torch.zeros(shape)
    with pytest.raises(ValueError, match="attn_bias"):
        vjp.fused_attention_block_vjp(torch.from_numpy(x), w_in, b_in, w_out, b_out, None,
                                      n_heads=4, attn_bias=bad)
    mha = MultiheadAttention(32, 4, fuse_out=False)
    with pytest.raises(ValueError, match="attn_bias"):
        mha(torch.from_numpy(x), attn_bias=bad)
    with pytest.raises(ValueError, match="one additive term"):
        mha(torch.from_numpy(x), attn_bias=torch.zeros(16, 16), attn_mask=torch.zeros(16, 16))


def _towers(**kw):
    """(JAX ClipModel with the knob on, its variables, port towers by mode)."""
    jcfg = dataclasses.replace(JClipConfig.tiny(), text_fused_attention_vjp=True)
    jmodel = JClipModel(jcfg)
    rng = np.random.RandomState(6)
    image = jnp.asarray(rng.randn(1, 32, 32, 3).astype(np.float32))
    ids = jnp.zeros((1, jcfg.context_length), jnp.int32)
    variables = jax.tree_util.tree_map(np.asarray, dict(jmodel.init(
        jax.random.PRNGKey(0), image, ids)))
    return jmodel, variables


def _port_tower(variables, **kw):
    model = ClipModel(dataclasses.replace(ClipConfig.tiny(), **kw)).eval()
    load_clip(model, variables["params"])
    model.requires_grad_(False)
    return model


def _keywords():
    rng = np.random.RandomState(7)
    return rng.randn(3, 5, 32).astype(np.float32), np.array([2, 5, 3]), \
        rng.randn(3, 16).astype(np.float32)


@pytest.fixture(scope="module")
def towers():
    return _towers()


def _run_port(model, kws, knum, probe):
    k = torch.from_numpy(kws).requires_grad_(True)
    out = model.encode_keywords(k, torch.from_numpy(knum))
    (out * torch.from_numpy(probe)).sum().backward()
    return out.detach().numpy(), k.grad.numpy()


def test_text_tower_knob_matches_knob_off_and_jax(towers):
    jmodel, variables = towers
    kws, knum, probe = _keywords()

    def jloss(k):
        out = jmodel.apply(variables, k, jnp.asarray(knum), method=JClipModel.encode_keywords)
        return (out * probe).sum(), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(kws))
    off = _run_port(_port_tower(variables), kws, knum, probe)
    on_model = _port_tower(variables, text_fused_attention_vjp=True)
    on = _run_port(on_model, kws, knum, probe)
    # the same parameters either way: the knob does not change the checkpoint
    assert [n for n, _ in on_model.named_parameters()] == \
        [n for n, _ in _port_tower(variables).named_parameters()]
    for got in (off, on):
        np.testing.assert_allclose(got[0], np.asarray(jout), atol=ATOL, rtol=0)
        np.testing.assert_allclose(got[1], np.asarray(jgrad), atol=ATOL, rtol=0)
    np.testing.assert_allclose(on[0], off[0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(on[1], off[1], atol=ATOL, rtol=0)
    # gradients stop at keyword slots past each row's count
    assert np.all(on[1][0, 2:] == 0) and np.abs(on[1][0, :2]).max() > 0


def test_text_tower_knob_runs_the_fused_block(towers, monkeypatch):
    """With the knob on every text block calls K1's and K2's wrappers with the
    causal bias, and asks for no weight gradients; with it off none does."""
    _, variables = towers
    kws, knum, probe = _keywords()
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = vjp.attention_forward, vjp.attention_backward

    def count_fwd(*a, **kw):
        calls["fwd"] += 1
        assert kw["attn_bias"].shape == (1, 16, 16) and kw["attn_bias"][0, 0, 1] < -1e29
        return fwd(*a, **kw)

    def count_bwd(*a, **kw):
        calls["bwd"] += 1
        assert kw["attn_bias"] is not None
        return bwd(*a, **kw)

    monkeypatch.setattr(vjp, "attention_forward", count_fwd)
    monkeypatch.setattr(vjp, "attention_backward", count_bwd)
    _run_port(_port_tower(variables), kws, knum, probe)
    assert calls == {"fwd": 0, "bwd": 0}
    model = _port_tower(variables, text_fused_attention_vjp=True)
    _run_port(model, kws, knum, probe)
    assert calls == {"fwd": 2, "bwd": 2}  # ClipConfig.tiny has 2 text layers
    assert all(p.grad is None for p in model.parameters())


@pytest.mark.parametrize("mode", ["full", "attn", "none"])
@pytest.mark.parametrize("knob", [False, True])
def test_remat_modes_change_no_value(towers, mode, knob):
    _, variables = towers
    kws, knum, probe = _keywords()
    want = _run_port(_port_tower(variables), kws, knum, probe)
    got = _run_port(_port_tower(variables, text_remat_mode=mode, text_fused_attention_vjp=knob),
                    kws, knum, probe)
    tol = ATOL if knob else 1e-6
    np.testing.assert_allclose(got[0], want[0], atol=tol, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=tol, rtol=0)


def test_remat_recomputes_in_the_backward(towers, monkeypatch):
    """`full` and `attn` run each text block's attention a second time in the
    backward; `none` and the fused route do not."""
    _, variables = towers
    kws, knum, probe = _keywords()
    runs = {}
    for mode, knob in (("none", False), ("attn", False), ("full", False), ("full", True)):
        model = _port_tower(variables, text_remat_mode=mode, text_fused_attention_vjp=knob)
        count = [0]
        for block in model.text.transformer.blocks:
            block.attn.register_forward_pre_hook(lambda *a: count.__setitem__(0, count[0] + 1))
        _run_port(model, kws, knum, probe)
        runs[(mode, knob)] = count[0]
    assert runs == {("none", False): 2, ("attn", False): 4, ("full", False): 4,
                    ("full", True): 2}


def test_remat_mode_is_checked():
    with pytest.raises(ValueError, match="text_remat_mode"):
        ClipConfig(text_remat_mode="some")
