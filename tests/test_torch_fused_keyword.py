"""PyTorch port of the fused cosine-score + VQ forward (K3) against JAX.

CPU: the port's `fused_cosine_vq` (its wrapper runs the plain twin on a CPU
tensor) against the JAX `fused_cosine_vq(training=False, dtype=float32,
interpret=True)`, the Pallas kernel in interpret mode. Targets and keywords
exact; perplexities and `ent_per_t` to rtol 1e-5 (fp32, sums in another
order). Also the twin against the port's materialized
`simple_vector_quantizer` (same argmax, same statistics up to its +1e-9 in
the entropy log).

The CUDA kernels against the twin are in `test_torch_cuda_kernels.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechclip_plus_tpu.ops.fused_keyword import fused_cosine_vq as jax_fused_vq
from speechclip_plus_tpu_torch.ops import fused_keyword as fk
from speechclip_plus_tpu_torch.ops.vq import simple_vector_quantizer

SPECIAL = (0, 2, 3)  # the reduced vocabulary's masked ids: '!', SOT, EOT


def _case(b, k, d, v, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, k, d).astype(np.float32)
    xn = x / np.linalg.norm(x, axis=-1, keepdims=True)
    emb = (rng.randn(v, d) * 0.1 + rng.randn(1, d) * 0.02).astype(np.float32)
    return xn, emb


@pytest.mark.parametrize("b,k,d,v,seed", [
    (4, 16, 128, 300, 0), (2, 32, 64, 129, 1), (8, 8, 32, 1000, 2)])
def test_matches_jax_kernel(b, k, d, v, seed):
    xn, emb = _case(b, k, d, v, seed)
    want = jax_fused_vq(jnp.asarray(xn), jnp.asarray(emb), jnp.float32(0.1),
                        prob_msk=SPECIAL, training=False, dtype=jnp.float32,
                        interpret=True)
    got = fk.fused_cosine_vq(torch.from_numpy(xn), torch.from_numpy(emb), 0.1,
                             prob_msk=SPECIAL, dtype=torch.float32)
    np.testing.assert_array_equal(got["targets"].numpy(), np.asarray(want["targets"]))
    np.testing.assert_array_equal(got["keywords"].numpy(), np.asarray(want["keywords"]))
    for key in ("code_perplexity", "prob_perplexity"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, err_msg=key)
    # (V - perplexity) / V cancels: the perplexities' rtol becomes an atol here
    np.testing.assert_allclose(float(got["diversity_loss"]), float(want["diversity_loss"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["ent_per_t"].numpy(), np.asarray(want["ent_per_t"]),
                               rtol=1e-5)
    assert got["num_vars"] == v and float(got["temp"]) == pytest.approx(0.1)


def test_twin_matches_materialized_quantizer():
    xn, emb = _case(3, 20, 64, 500, 3)
    x, e = torch.from_numpy(xn), torch.from_numpy(emb)
    got = fk.fused_cosine_vq(x, e, 0.1, prob_msk=SPECIAL, dtype=torch.float32)
    en = e / e.norm(dim=-1, keepdim=True)
    ref = simple_vector_quantizer(x @ en.T, temp=0.1, prob_msk=SPECIAL, codebook=e)
    assert torch.equal(got["targets"], ref["targets"])
    assert torch.equal(got["keywords"], ref["keywords"])
    for key in ("code_perplexity", "prob_perplexity"):
        torch.testing.assert_close(got[key], ref[key], rtol=1e-5, atol=0)
    torch.testing.assert_close(got["ent_per_t"], ref["ent_per_t"], rtol=1e-4, atol=0)


def test_masked_ids_never_win():
    xn, emb = _case(2, 16, 32, 40, 4)
    emb[list(SPECIAL)] = xn[0, 0] * 5.0  # the best match for row 0 is masked
    k, _, psum = fk.plain_cosine_vq_stats(
        torch.from_numpy(xn.reshape(-1, 32)), torch.from_numpy(emb),
        fk.column_mask(40, SPECIAL, "cpu"))
    assert not set(k.tolist()) & set(SPECIAL)
    assert torch.all(psum[list(SPECIAL)] == 0)
    torch.testing.assert_close(psum.sum(), torch.tensor(32.0), rtol=1e-5, atol=0)


def test_backward_raises():
    xn, emb = _case(2, 8, 32, 50, 5)
    x = torch.from_numpy(xn.reshape(-1, 32)).requires_grad_(True)
    en = torch.nn.functional.normalize(torch.from_numpy(emb), dim=-1)
    k, ent, psum = fk.cosine_vq_stats(x, en, fk.column_mask(50, SPECIAL, "cpu"))
    # the statistics are taken on a stop-gradient basis, as in JAX; the
    # gradient into x is the straight-through one (K3b, fused_cosine_vq)
    assert not ent.requires_grad and not psum.requires_grad
    with pytest.raises(RuntimeError, match="does not require grad"):
        ent.sum().backward()

