"""K1a, the fused attention block's projection GEMM, on the CPU.

`plain_projection` (what the `projection` wrapper runs on a CPU tensor)
against the two products the JAX kernel computes: the qkv projection of
`speechclip_plus_tpu/nn/fused_attention_block.py` (`_kernel`, :153-157, with
the weights prepared as its wrapper does, :522-527: the 1/sqrt(dh) q scale
folded into Wq and bq, torch's (out, in) layout on the port's side, the
scale applied to the first D columns instead) and its out-projection
(:193-198), in fp32 at `config/dev/tiny.yaml` widths (d_model 32, 4 heads)
with a ragged row count. Tolerance 1e-5 abs: fp32 on both sides, the scale
applied before or after the sum. Also: the wrapper takes the twin only
because its tensors lie on the CPU, and `_launch` routes both GEMMs of a
block through it. The kernel itself is held to the twin on the card in
`test_torch_cuda_kernels.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechclip_plus_tpu_torch.nn import fused_attention_block as fab

D, HEADS = 32, 4  # config/dev/tiny.yaml: d_model, nhead
ATOL = 1e-5


def _weights(seed, d):
    rng = np.random.RandomState(seed)
    w = {n: (rng.randn(d, d) * d ** -0.5).astype(np.float32) for n in "qkvo"}  # JAX: (in, out)
    b = {n: (rng.randn(d) * 0.1).astype(np.float32) for n in "qkvo"}
    return w, b


def _dot(a, w):
    """The JAX kernel's product: bf16 or fp32 operands, fp32 accumulation."""
    return jax.lax.dot_general(jnp.asarray(a), jnp.asarray(w), (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.float32)


@pytest.mark.parametrize("m", [37, 7, 130])
def test_plain_projection_matches_the_jax_qkv_projection(m):
    w, b = _weights(m, D)
    x = np.random.RandomState(m + 1).randn(m, D).astype(np.float32)
    scale = (D // HEADS) ** -0.5
    # the wrapper's folding (:522-527, one group): [Wq s | Wk | Wv], [bq s | bk | bv]
    wqkv = np.concatenate([w["q"] * scale, w["k"], w["v"]], axis=1)
    bqkv = np.concatenate([b["q"] * scale, b["k"], b["v"]])
    want = np.asarray(_dot(x, wqkv) + bqkv)
    w_in = torch.from_numpy(np.concatenate([w["q"], w["k"], w["v"]], axis=1).T.copy())
    b_in = torch.from_numpy(np.concatenate([b["q"], b["k"], b["v"]]))
    got = fab.plain_projection(torch.from_numpy(x), w_in, b_in, scale_cols=D, scale=scale)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, 3 * D)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("m", [37, 130])
def test_plain_projection_matches_the_jax_out_projection(m):
    w, b = _weights(m + 2, D)
    ctx = np.random.RandomState(m + 3).randn(m, D).astype(np.float32)
    want = np.asarray(_dot(ctx, w["o"]) + b["o"])
    got = fab.plain_projection(torch.from_numpy(ctx), torch.from_numpy(w["o"].T.copy()),
                               torch.from_numpy(b["o"]))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_plain_projection_rounds_to_out_dtype():
    """bf16 operands multiply in fp32 on their values; the result is rounded
    once, to the requested dtype (the out-projection of a bf16 block)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, 3, D, generator=g).to(torch.bfloat16)
    w = torch.randn(D, D, generator=g).to(torch.bfloat16)
    b = torch.randn(D, generator=g)
    got = fab.plain_projection(x, w, b, out_dtype=torch.bfloat16)
    want = (x.float().reshape(-1, D) @ w.float().T + b).reshape(5, 3, D)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))


def test_projection_takes_the_twin_on_cpu_tensors(monkeypatch):
    def no_kernel(*args):
        raise AssertionError("the kernel path ran for a CPU tensor")

    monkeypatch.setattr(fab, "_launch_projection", no_kernel)
    w, b = _weights(5, D)
    x = torch.randn(9, D)
    kw = dict(scale_cols=D, scale=0.25)
    w_in = torch.from_numpy(np.concatenate([w["q"], w["k"], w["v"]], 1).T.copy())
    b_in = torch.from_numpy(np.concatenate([b["q"], b["k"], b["v"]]))
    before = fab.PROJECTION_LAUNCHES
    got = fab.projection(x, w_in, b_in, **kw)
    assert torch.equal(got, fab.plain_projection(x, w_in, b_in, **kw))
    assert fab.PROJECTION_LAUNCHES == before  # the count is of kernel launches only
    with pytest.raises(NotImplementedError):
        fab.projection(x.to("meta"), w_in.to("meta"), b_in.to("meta"))


@pytest.mark.parametrize("fuse_out", [True, False])
def test_launch_routes_both_gemms_through_the_wrapper(monkeypatch, fuse_out):
    """`_launch` (the CUDA path of the block) calls `projection` for the qkv
    projection (fp32 out, q scaled) and, fused-out, for the out-projection
    (x's dtype); here the attention kernel and the wrapper are stood in for
    on the CPU so that the calls can be seen."""
    calls = []

    def record(x, w, b, *, scale_cols=0, scale=1.0, out_dtype=torch.float32):
        calls.append((tuple(x.shape), tuple(w.shape), scale_cols, scale, out_dtype))
        return fab.plain_projection(x, w, b, scale_cols=scale_cols, scale=scale,
                                    out_dtype=out_dtype)

    def attention(qkv, kb, n_heads, dtype, *args):
        b, t, _ = qkv.shape
        return torch.zeros(b, t, qkv.shape[-1] // 3, dtype=dtype), None

    monkeypatch.setattr(fab, "projection", record)
    monkeypatch.setattr(fab, "_attention", attention)
    d, heads = 128, 2  # dh = 64, a head dim the kernels take
    x = torch.randn(2, 7, d)
    w_in, b_in = torch.randn(3 * d, d), torch.randn(3 * d)
    w_out, b_out = torch.randn(d, d), torch.randn(d)
    fab._launch(x, w_in, b_in, w_out, b_out, None, heads, fuse_out)
    want = [((2, 7, d), (3 * d, d), d, (d // heads) ** -0.5, torch.float32)]
    if fuse_out:
        want.append(((2, 7, d), (d, d), 0, 1.0, torch.float32))
    assert calls == want
