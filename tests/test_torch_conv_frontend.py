"""PyTorch port of the waveform convolution (K6) against JAX.

CPU: the port's plain twin (the tap sum its wrapper runs on a CPU tensor)
against the JAX Pallas kernel `conv0_pallas(..., interpret=True)` and against
`lax.conv_general_dilated`, at T not a multiple of the stride and at a frame
count that crosses the JAX kernel's 2048-frame block. Tolerance 1e-5 abs in
fp32 (ten taps, sums in another order); with bf16 inputs the products are
exact in fp32 on both sides and the bf16 output may differ by one rounding
(1e-2 x the output's scale).

The CUDA kernel against the twin is in `test_torch_cuda_kernels.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechclip_plus_tpu.ops.conv_frontend import conv0_pallas

from speechclip_plus_tpu_torch.ops import conv_frontend as cf


def _case(seed, b, t, c, k=10):
    rng = np.random.RandomState(seed)
    wav = rng.randn(b, t).astype(np.float32)
    kernel = (rng.randn(k, 1, c) * k ** -0.5).astype(np.float32)
    return wav, kernel


def _lax_conv(wav, kernel, stride):
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(wav)[:, :, None], jnp.asarray(kernel), (stride,), "VALID",
        dimension_numbers=("NWC", "WIO", "NWC")))


@pytest.mark.parametrize("b,t,c", [(2, 1003, 16), (3, 400, 8), (1, 10300, 4)])
def test_twin_matches_jax_kernel_and_lax_conv(b, t, c):
    wav, kernel = _case(0, b, t, c)
    want = np.asarray(conv0_pallas(jnp.asarray(wav), jnp.asarray(kernel), interpret=True))
    got = cf.conv0(torch.from_numpy(wav), torch.from_numpy(kernel))
    assert got.shape == (b, (t - 10) // 5 + 1, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), _lax_conv(wav, kernel, 5), atol=1e-5, rtol=0)


def test_frame_count_crossing_a_block_edge():
    # T0 = 2049: one frame past the JAX kernel's 2048-frame block
    wav, kernel = _case(1, 1, 5 * 2048 + 10, 4)
    got = cf.conv0(torch.from_numpy(wav), torch.from_numpy(kernel))
    assert got.shape[1] == 2049
    want = np.asarray(conv0_pallas(jnp.asarray(wav), jnp.asarray(kernel), interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_bf16_inputs_and_output_match_jax_kernel():
    wav, kernel = _case(2, 2, 777, 8)
    jw, jk = jnp.asarray(wav).astype(jnp.bfloat16), jnp.asarray(kernel).astype(jnp.bfloat16)
    want = np.asarray(conv0_pallas(jw, jk, out_dtype=jnp.bfloat16, interpret=True)
                      .astype(jnp.float32))
    got = cf.conv0(torch.from_numpy(wav).bfloat16(), torch.from_numpy(kernel).bfloat16(),
                   out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2 * np.abs(want).max(), rtol=0)
    # an fp32 output of bf16 inputs is the exact tap sum of the rounded values
    got32 = cf.conv0(torch.from_numpy(wav).bfloat16(), torch.from_numpy(kernel).bfloat16())
    ref = _lax_conv(np.asarray(jw.astype(jnp.float32)), np.asarray(jk.astype(jnp.float32)), 5)
    np.testing.assert_allclose(got32.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("k,s", [(3, 2), (2, 2), (4, 7)])
def test_other_kernel_sizes_and_strides_match_lax_conv(k, s):
    """What a C_in = 1 convolution takes: the JAX kernel needs s < k <= 2s."""
    wav, kernel = _case(3, 2, 333, 6, k=k)
    got = cf.conv0(torch.from_numpy(wav), torch.from_numpy(kernel), stride=s)
    np.testing.assert_allclose(got.numpy(), _lax_conv(wav, kernel, s), atol=1e-5, rtol=0)


def test_bad_shapes_raise():
    wav, kernel = (torch.from_numpy(a) for a in _case(4, 2, 100, 4))
    with pytest.raises(ValueError, match="want"):
        cf.conv0(wav[0], kernel)
    with pytest.raises(ValueError, match="want"):
        cf.conv0(wav, kernel.expand(10, 2, 4))
    with pytest.raises(ValueError, match="shorter"):
        cf.conv0(wav[:, :9], kernel)
