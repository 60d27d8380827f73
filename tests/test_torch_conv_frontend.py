"""PyTorch port of the waveform convolution (K6) against JAX.

CPU: the port's plain twin (the tap sum its wrapper runs on a CPU tensor)
against the JAX Pallas kernel `conv0_pallas(..., interpret=True)` and against
`lax.conv_general_dilated`, at T not a multiple of the stride and at a frame
count that crosses the JAX kernel's 2048-frame block. Tolerance 1e-5 abs in
fp32 (ten taps, sums in another order); with bf16 inputs the products are
exact in fp32 on both sides and the bf16 output may differ by one rounding
(1e-2 x the output's scale).

The fused group-norm layer 0: its twin `plain_conv0_gn_gelu` (the composite
the tower ran) against the JAX package's layer 0 (conv, fp32 GroupNorm, GELU)
in fp32 at 1e-5 abs and relative (JAX's one-pass variance), and the tower's routing
rule: a group-norm layer 0 that needs no gradient calls `conv0_gn_gelu`
(the kernel on the card, the twin on the CPU), a trainable one the twin.

The CUDA kernels against the twins are in `test_torch_cuda_kernels.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechclip_plus_tpu.models.hubert import ConvFeatureExtractor as JaxExtractor
from speechclip_plus_tpu.models.hubert import HubertConfig as JaxConfig
from speechclip_plus_tpu.ops.conv_frontend import conv0_pallas

from speechclip_plus_tpu_torch.models import hubert
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


@pytest.mark.parametrize("b,t,c,k,s", [(2, 1003, 16, 10, 5), (3, 400, 8, 3, 2)])
def test_gn_twin_matches_jax_layer0(b, t, c, k, s):
    """JAX's group-norm frontend cut to its layer 0, in fp32, against the twin
    on the same weights (a DC offset on one utterance, an all-zero one)."""
    rng = np.random.RandomState(5)
    wav = rng.randn(b, t).astype(np.float32)
    wav[0] += 3.0
    wav[-1] = 0.0
    cfg = JaxConfig(conv_layers=((c, k, s),), dtype=jnp.float32)
    mod = JaxExtractor(cfg)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(wav[:, :k + s]))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    params["gn_0"]["scale"] = (1 + 0.1 * rng.randn(c)).astype(np.float32)
    params["gn_0"]["bias"] = (0.1 * rng.randn(c)).astype(np.float32)
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(wav)))  # (B, T0, C)
    weight = torch.from_numpy(np.ascontiguousarray(params["conv_0"]["kernel"].transpose(2, 1, 0)))
    got = cf.plain_conv0_gn_gelu(torch.from_numpy(wav), weight,
                                 torch.from_numpy(params["gn_0"]["scale"]),
                                 torch.from_numpy(params["gn_0"]["bias"]), 1e-5, s)
    assert got.shape == (b, c, (t - k) // s + 1) and got.dtype == torch.float32
    # JAX's variance is E[x^2] - mean^2, which loses digits where the mean
    # is large against the spread (the offset utterance): rtol 1e-5 besides
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1), want, atol=1e-5, rtol=1e-5)
    # on a CPU tensor the wrapper is the twin
    before = cf.GN_LAUNCHES
    same = cf.conv0_gn_gelu(torch.from_numpy(wav), weight,
                            torch.from_numpy(params["gn_0"]["scale"]),
                            torch.from_numpy(params["gn_0"]["bias"]), 1e-5, stride=s)
    assert torch.equal(same, got) and cf.GN_LAUNCHES == before


ROUTES = {  # case -> (extractor_mode, conv bias, grad mode, trainable parameters, route)
    "frozen": ("group_norm", False, True, (), "fused"),
    "trainable_under_no_grad": ("group_norm", False, False, ("conv", "gn"), "fused"),
    "conv0_trains": ("group_norm", False, True, ("conv",), "twin"),
    "group_norm_trains": ("group_norm", False, True, ("gn",), "twin"),
    "conv_bias": ("group_norm", True, True, (), "twin"),
    "layer_norm": ("layer_norm", False, True, (), None),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_layer0_routing(case, monkeypatch):
    mode, conv_bias, grad, trains, route = ROUTES[case]
    cfg = hubert.HubertConfig(conv_layers=((8, 3, 2), (8, 3, 2)), extractor_mode=mode,
                              conv_bias=conv_bias)
    fe = hubert.ConvFeatureExtractor(cfg)
    fe.requires_grad_(False)
    if "conv" in trains:
        fe.conv_layers[0].weight.requires_grad_(True)
    if "gn" in trains:
        fe.gn.weight.requires_grad_(True)
        fe.gn.bias.requires_grad_(True)
    calls = []
    for name in ("conv0_gn_gelu", "plain_conv0_gn_gelu"):
        fn = getattr(hubert, name)
        monkeypatch.setattr(hubert, name,
                            lambda *a, _fn=fn, _name=name, **kw: calls.append(_name) or _fn(*a, **kw))
    wav = torch.randn(2, 101)
    want = fe(wav) if route is None else None
    calls.clear()
    before = cf.GN_LAUNCHES
    with torch.set_grad_enabled(grad):
        out = fe(wav)
    assert out.shape == (2, 24, 8)
    assert calls == {"fused": ["conv0_gn_gelu"], "twin": ["plain_conv0_gn_gelu"],
                     None: []}[route]
    assert cf.GN_LAUNCHES == before  # a CPU tensor never reaches the kernel
    if route == "twin":
        assert out.requires_grad == (grad and bool(trains))
    if route is None:
        assert torch.equal(out, want)
