"""PyTorch port's pure ops against the JAX package, in fp32 on the CPU.

Same inputs, made with numpy from a seed, through both functions. Masks and
VQ targets must be equal; float outputs agree to 1e-5 (fp32 on both sides,
reductions in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechclip_plus_tpu.ops import cif as jcif
from speechclip_plus_tpu.ops import kw_bn as jkw_bn
from speechclip_plus_tpu.ops import masks as jmasks
from speechclip_plus_tpu.ops import vq as jvq
from speechclip_plus_tpu.ops.weighted_sum import weighted_sum as jax_weighted_sum
from speechclip_plus_tpu_torch.ops import cif, kw_bn, masks, vq
from speechclip_plus_tpu_torch.ops.weighted_sum import layer_weights

TOL = dict(rtol=1e-5, atol=1e-5)


def test_key_padding_mask_matches():
    lens = np.array([5, 1, 9, 0], np.int32)
    want = np.asarray(jmasks.key_padding_mask(9, jnp.asarray(lens)))
    np.testing.assert_array_equal(masks.get_keypadding_mask(9, torch.from_numpy(lens)).numpy(),
                                  want)


@pytest.mark.parametrize("n_layers", [13, 25])
def test_layer_weights_sum_matches_jax_weighted_sum(n_layers):
    """The tower's in-loop accumulation sum_i w_i h_i against JAX's stacked sum."""
    rng = np.random.RandomState(0)
    h = rng.randn(n_layers, 2, 7, 16).astype(np.float32)
    logits = rng.randn(n_layers).astype(np.float32)
    want = np.asarray(jax_weighted_sum(jnp.asarray(h), jnp.asarray(logits)))
    w = layer_weights(torch.from_numpy(logits))
    got = w[0] * torch.from_numpy(h[0])
    for i in range(1, n_layers):
        got = got + w[i] * torch.from_numpy(h[i])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_kw_bn_dynamic_eval_matches():
    rng = np.random.RandomState(1)
    x = rng.randn(3, 11, 24).astype(np.float32)
    scale, bias = rng.rand(24).astype(np.float32) + 0.5, rng.randn(24).astype(np.float32)
    mean, var = rng.randn(24).astype(np.float32), rng.rand(24).astype(np.float32) + 0.1
    want, _ = jkw_bn.kw_bn_dynamic(
        jnp.asarray(x), {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
        {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}, training=False)
    got, stats = kw_bn.kw_bn_dynamic(*(torch.from_numpy(a) for a in (x, scale, bias, mean, var)))
    assert stats is None  # eval: the running statistics stay
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _alphas(rng, b, s, scale):
    a = rng.rand(b, s).astype(np.float32) * scale
    lens = rng.randint(s // 2, s + 1, size=b)
    a[np.arange(s)[None, :] >= lens[:, None]] = 0.0
    return a


@pytest.mark.parametrize("scale,max_len,tail", [
    (0.3, 75, True),    # a few fires, tail handling on
    (0.45, 6, True),    # saturates at max_feat_len
    (0.3, 75, False),   # tail handling off
    (0.05, 75, True),   # less than one fire: length clamps to 1
])
def test_integrate_and_fire_eval_matches(scale, max_len, tail):
    rng = np.random.RandomState(2)
    x = rng.randn(4, 40, 8).astype(np.float32)
    a = _alphas(rng, 4, 40, scale)
    kw = dict(threshold=1.0, max_feat_len=max_len, is_inference=True,
              apply_tail_handling=tail, tail_handling_firing_threshold=0.5)
    want = jcif.integrate_and_fire(jnp.asarray(x), jnp.asarray(a), **kw)
    got = cif.integrate_and_fire(torch.from_numpy(x), torch.from_numpy(a), **kw)
    for key in ("dsample_feats_length", "dsample_feats_pad_mask"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got["dsample_feats"].numpy(),
                               np.asarray(want["dsample_feats"]), **TOL)


def test_simple_vector_quantizer_eval_matches():
    rng = np.random.RandomState(3)
    scores = rng.randn(3, 10, 50).astype(np.float32)
    codebook = rng.randn(50, 16).astype(np.float32)
    want = jvq.simple_vector_quantizer(jnp.asarray(scores), temp=jnp.float32(0.1),
                                       training=False, codebook=jnp.asarray(codebook))
    got = vq.simple_vector_quantizer(torch.from_numpy(scores), temp=0.1,
                                     codebook=torch.from_numpy(codebook))
    np.testing.assert_array_equal(got["targets"].numpy(), np.asarray(want["targets"]))
    np.testing.assert_array_equal(got["keywords"].numpy(), np.asarray(want["keywords"]))
    for key in ("code_perplexity", "prob_perplexity"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(got["ent_per_t"].numpy(), np.asarray(want["ent_per_t"]), **TOL)
    assert not set(got["targets"].unique().tolist()) & {0, 2, 3}  # masked ids
