"""The pooling layers and the penalty schedule in the port against the JAX
package (fp32, CPU), at the JAX tests' 1e-5.

`nn/pooling.py`: `MeanPoolingLayer` with and without lengths and
projections (the JAX Dense kernels moved in), `AttentivePoolingLayer`'s
paired, batch-crossed and gallery forms with and without its additive mask
(the same U), its degraded identity form and `generate_input_msk`.
`utils/penalty_scheduler.py`: `PenaltyScheduler` over the steps around and
between its keypoints.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechclip_plus_tpu.nn.pooling import AttentivePoolingLayer as JAttentive
from speechclip_plus_tpu.nn.pooling import MeanPoolingLayer as JMean
from speechclip_plus_tpu.utils.penalty_scheduler import PenaltyScheduler as JPenalty

from speechclip_plus_tpu_torch.nn import AttentivePoolingLayer, MeanPoolingLayer
from speechclip_plus_tpu_torch.utils import PenaltyScheduler

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dims", [(0, 0, True, True), (4, 3, True, True), (4, 3, False, True),
                                  (4, 3, True, False)])
def test_mean_pooling_matches_jax(dims):
    in_dim, out_dim, pre, post = dims
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 4).astype(np.float32)
    lens = np.array([5, 3, 0])
    jpool = JMean(in_dim=in_dim, out_dim=out_dim, pre_proj=pre, post_proj=post)
    variables = jpool.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(lens))
    pool = MeanPoolingLayer(in_dim, out_dim, pre_proj=pre, post_proj=post)
    params = variables.get("params", {})
    assert sorted(params) == sorted(n for n, m in pool.named_children() if m is not None)
    with torch.no_grad():
        for name, leaf in params.items():
            getattr(pool, name).weight.copy_(torch.tensor(np.asarray(leaf["kernel"]).T))
            getattr(pool, name).bias.copy_(torch.tensor(np.asarray(leaf["bias"])))
    for args in ((jnp.asarray(x), jnp.asarray(lens)), (jnp.asarray(x),)):
        want = jpool.apply(variables, *args)
        got = pool(*(torch.tensor(np.asarray(a)) for a in args))
        _close(got, want)


def test_attentive_pooling_matches_jax():
    rng = np.random.RandomState(1)
    b, ta, tb, da, db, n = 3, 5, 4, 6, 8, 7
    a = rng.randn(b, ta, da).astype(np.float32)
    bb = rng.randn(b, tb, db).astype(np.float32)
    gallery = rng.randn(n, db).astype(np.float32)
    u = rng.randn(da, db).astype(np.float32)
    jpool, jvars = JAttentive(dim_A=da, dim_B=db), {"params": {"U": jnp.asarray(u)}}
    pool = AttentivePoolingLayer(da, db)
    with torch.no_grad():
        pool.U.copy_(torch.from_numpy(u))
    a_lens, b_lens = np.array([5, 2, 4]), np.array([4, 4, 1])
    msk = JAttentive.generate_input_msk(jnp.asarray(a_lens), jnp.asarray(b_lens), ta, tb)
    tmsk = AttentivePoolingLayer.generate_input_msk(torch.from_numpy(a_lens),
                                                    torch.from_numpy(b_lens), ta, tb)
    np.testing.assert_array_equal(tmsk.numpy(), np.asarray(msk))
    only_a = AttentivePoolingLayer.generate_input_msk(torch.from_numpy(a_lens), None, ta, 1)
    np.testing.assert_array_equal(
        only_a.numpy(), np.asarray(JAttentive.generate_input_msk(jnp.asarray(a_lens), None, ta, 1)))
    ta_, tb_ = torch.from_numpy(a), torch.from_numpy(bb)
    for m, tm in ((None, None), (msk, tmsk)):
        want = jpool.apply(jvars, jnp.asarray(a), jnp.asarray(bb), m)
        got = pool(ta_, tb_, tm)
        for g, w in zip(got, want):
            _close(g, w)
        want = jpool.apply(jvars, jnp.asarray(a), jnp.asarray(bb), m,
                           method=JAttentive.batch_forward)
        got = pool.batch_forward(ta_, tb_, tm)
        for g, w in zip(got, want):
            _close(g, w)
    for m, tm in ((None, None), (msk[:, :, :1], tmsk[:, :, :1])):
        want = jpool.apply(jvars, jnp.asarray(a), jnp.asarray(gallery), m,
                           method=JAttentive.cal_batch_embedding)
        _close(pool.cal_batch_embedding(ta_, torch.from_numpy(gallery), tm), want)


def test_degraded_attentive_pooling_is_the_identity_bilinear():
    rng = np.random.RandomState(2)
    a = rng.randn(2, 5, 8).astype(np.float32)
    b = rng.randn(2, 4, 8).astype(np.float32)
    pool = AttentivePoolingLayer(8, 8, degraded=True)
    assert not list(pool.parameters()) and "U" not in pool.state_dict()
    want = JAttentive(dim_A=8, dim_B=8, degraded=True).apply({}, jnp.asarray(a), jnp.asarray(b))
    for g, w in zip(pool(torch.from_numpy(a), torch.from_numpy(b)), want):
        _close(g, w)
    with pytest.raises(ValueError, match="dim_A == dim_B"):
        AttentivePoolingLayer(8, 6, degraded=True)


@pytest.mark.parametrize("weights,keypoints", [([0.0, 1.0], [0, 100]),
                                               ([1.0, 0.5, 0.5, 0.0], [10, 20, 50, 80])])
def test_penalty_scheduler_matches_jax(weights, keypoints):
    ours, ref = PenaltyScheduler(weights, keypoints), JPenalty(weights, keypoints)
    assert ours.get_value() == ref.get_value() == weights[0]
    for step in (0, 5, 10, 15, 20, 33, 50, 79, 80, 100, 1000):
        ours.update(step)
        ref.update(step)
        assert ours.get_value() == pytest.approx(ref.get_value(), rel=1e-5, abs=1e-5), step
    with pytest.raises(ValueError):
        PenaltyScheduler([1.0, 2.0], [5, 1])
