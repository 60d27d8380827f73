"""PyTorch port of the flash-attention forward (K4) against JAX.

CPU, fp32: the port's plain twin (what its wrapper runs on a CPU tensor)
against the JAX Pallas kernel, run in interpret mode as
`tests/test_flash_attention.py` runs it, and against `_xla_attention`; the
log-sum-exp against the JAX kernel's; gradients against JAX's custom VJP;
odd lengths and ragged key padding. Tolerance 2e-5 abs (values) and 1e-4 abs
(gradients): fp32 on both sides, sums in another order. Also the tiny tower
with `use_flash_attention=True` against the JAX tower (1e-5).

The CUDA kernel against the twin is in `test_torch_cuda_kernels.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechclip_plus_tpu.models.hubert import HubertConfig as JHubertConfig
from speechclip_plus_tpu.models.hubert import HubertModel as JHubert
from speechclip_plus_tpu.nn import flash as jax_flash_mod
from speechclip_plus_tpu.nn.flash import _flash_fwd, _xla_attention
from speechclip_plus_tpu.nn.flash import flash_attention as jax_flash

from speechclip_plus_tpu_torch.checkpoint.from_jax import load_hubert
from speechclip_plus_tpu_torch.models.hubert import HubertConfig, HubertModel
from speechclip_plus_tpu_torch.nn import flash

ATOL = 2e-5


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    """Force pallas_call(interpret=True) so the JAX kernel runs on the CPU."""
    jax_flash_mod._ensure_pallas()
    real_call = jax_flash_mod.pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        return real_call(*args, **kwargs)

    monkeypatch.setattr(jax_flash_mod.pl, "pallas_call", interp_call)
    yield


def _data(seed, b, h, t, d):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, t, d).astype(np.float32) for _ in range(3))
    lens = np.array([t] + list(rng.randint(1, t, size=b - 1)))
    kpm = np.arange(t)[None, :] >= lens[:, None]
    return q, k, v, kpm


@pytest.mark.parametrize("t,d", [(200, 32), (37, 16), (131, 64)])
@pytest.mark.parametrize("masked", [True, False])
def test_twin_matches_jax_kernel_and_xla(t, d, masked):
    q, k, v, kpm = _data(0, 2, 3, t, d)
    jkpm = jnp.asarray(kpm) if masked else None
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = np.asarray(jax_flash(jq, jk, jv, jkpm, use_pallas=True, block_q=64, block_k=64))
    want_xla = np.asarray(_xla_attention(jq, jk, jv, jkpm))
    got = flash.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                torch.from_numpy(kpm) if masked else None)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), want_xla, atol=ATOL, rtol=0)


@pytest.mark.parametrize("t", [200, 37])
def test_lse_matches_jax_kernel(t):
    q, k, v, kpm = _data(1, 2, 2, t, 32)
    bias = np.where(kpm, -1e30, 0.0).astype(np.float32)
    out, (_, _, _, _, _, lse) = _flash_fwd(*(jnp.asarray(a) for a in (q, k, v, bias)), 64, 64)
    got, got_lse = flash.flash_forward(*(torch.from_numpy(a) for a in (q, k, v, bias)))
    assert got_lse.shape == (2, 2, t) and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), atol=ATOL, rtol=1e-6)
    # the twin's lse is the log-sum-exp of the biased scores
    s = torch.from_numpy(q) @ torch.from_numpy(k).transpose(-1, -2) * 32 ** -0.5
    ref = torch.logsumexp(s + torch.from_numpy(bias)[:, None, None, :], dim=-1)
    np.testing.assert_allclose(got_lse.numpy(), ref.numpy(), atol=ATOL, rtol=1e-6)


@pytest.mark.parametrize("t,d", [(200, 32), (37, 16)])
def test_gradients_match_jax(t, d):
    q, k, v, kpm = _data(2, 2, 3, t, d)
    probe = np.random.RandomState(3).randn(*q.shape).astype(np.float32)

    def loss(q, k, v):
        out = jax_flash(q, k, v, jnp.asarray(kpm), use_pallas=True, block_q=64, block_k=64)
        return (out * jnp.asarray(probe)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = flash.flash_attention(*leaves, torch.from_numpy(kpm))
    got = torch.autograd.grad((out * torch.from_numpy(probe)).sum(), leaves)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0,
                                   err_msg=f"d{name}")
    # and against autograd through plain attention
    ref = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    s = (ref[0] @ ref[1].transpose(-1, -2)) * d ** -0.5
    s = s.masked_fill(torch.from_numpy(kpm)[:, None, None, :], -1e30)
    plain = torch.autograd.grad(((torch.softmax(s, -1) @ ref[2]) * torch.from_numpy(probe)).sum(),
                                ref)
    for g, w in zip(got, plain):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4, rtol=0)


def test_fully_padded_row_is_finite():
    q, k, v, kpm = _data(4, 2, 2, 21, 16)
    kpm[1, :] = True
    out, lse = flash.flash_forward(*(torch.from_numpy(a) for a in (q, k, v)),
                                   torch.from_numpy(np.where(kpm, -1e30, 0.0).astype(np.float32)))
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(lse).all())


@pytest.mark.parametrize("lens,t", [([800, 515, 300], 800), ([643, 640], 643)])
def test_tower_with_flash_attention_matches_jax(lens, t, monkeypatch):
    jm = JHubert(JHubertConfig.tiny(use_flash_attention=True))
    wav0 = jnp.zeros((2, 400), jnp.float32)
    params = jax.jit(lambda k: jm.init(k, wav0, wav0 == 1.0))(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, params)["params"]
    tm = HubertModel(HubertConfig.tiny(use_flash_attention=True,
                                       fused_attention_block=False)).eval()
    load_hubert(tm, params)
    calls = []
    real = flash.plain_flash_attention
    monkeypatch.setattr(flash, "plain_flash_attention",
                        lambda *a, **kw: (calls.append(1), real(*a, **kw))[1])
    rng = np.random.RandomState(0)
    wav = (0.5 * rng.randn(len(lens), t)).astype(np.float32)
    pad = np.arange(t)[None, :] >= np.asarray(lens)[:, None]
    wav[pad] = 0.0
    logits = rng.randn(3).astype(np.float32)
    want = jm.apply({"params": params}, jnp.asarray(wav), jnp.asarray(pad),
                    layer_weights=jax.nn.softmax(jnp.asarray(logits)))
    with torch.no_grad():
        got = tm(torch.from_numpy(wav), torch.from_numpy(pad),
                 torch.softmax(torch.from_numpy(logits), 0))
    assert len(calls) == 2  # both layers took the K4 route
    for key in ("weighted_sum", "x"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5, atol=1e-5,
                                   err_msg=key)
    # with attention dropout on, the route is not taken (JAX :890-892)
    calls.clear()
    tm(torch.from_numpy(wav), torch.from_numpy(pad), torch.softmax(torch.from_numpy(logits), 0),
       torch.Generator().manual_seed(0))
    assert not calls
