"""The VQ variants of the PyTorch port against the JAX package, on the CPU.

Model level (`config/dev/tiny.yaml`, fp32, dropout off, the JAX variables
moved through `checkpoint/from_jax.py`; helpers from
`test_torch_trainable_towers.py`): the loss and the gradient of every
trainable tensor, the VQ temperature's included, for `temp: learnable=0.1`
(the port through K3's and K3b's twins, JAX through its XLA straight-through
form: the same estimator; and the port again on the materialized route,
`fused_score_kernel: false` with `fused_st: false`, against the same JAX
gradients, which the two JAX forms share), here with CIF's
`conv_cif_layer_num: 2` and `cif_output_dim: 24` (of 32) as well; and for
`hard: false` with the scheduled temperature at optimizer step 10.
Tolerance: rtol 1e-4 and 5e-5 x the tensor's largest |gradient|, as in
`test_torch_trainable_towers.py`.

Op level (`ops/vq.py` against JAX `ops/vq.py`): `scheduled_temperature` at
steps 0, 10^3 and 10^6 (rtol 1e-6: one fp32 power), and
`simple_vector_quantizer` in training for each form (hard and fused_st on or
off, `time_first: false`), its outputs and its gradients into the scores,
the codebook and the temperature (rtol 1e-5, atol 1e-6). Gumbel noise comes
from another generator than JAX's, so the Gumbel form is checked on its own:
one-hot (within the rounding of hard + soft - soft), it needs a generator,
eval unaffected.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechclip_plus_tpu.ops import vq as jvq

from speechclip_plus_tpu_torch.checkpoint.from_jax import load_jax_variables
from speechclip_plus_tpu_torch.config import load_config
from speechclip_plus_tpu_torch.ops import vq
from speechclip_plus_tpu_torch.ops.fused_keyword import plain_st_backward
from speechclip_plus_tpu_torch.tasks.builder import build_model_from_config
from test_torch_trainable_towers import (TINY, compare_grads, jax_grads, make_batch, port_grads,
                                         set_keys, setup_pair)

VQ, CIF = "model_settings.cascaded_branch.vq.args.", "model_settings.cascaded_branch.downsampling.cif."
CASES = {
    "learnable": ({VQ + "temp": "learnable=0.1", CIF + "conv_cif_layer_num": 2,
                   CIF + "cif_output_dim": 24}, 0),
    "soft_scheduled": ({VQ + "hard": False, VQ + "temp": "(2, 0.5, 0.999995)"}, 10),
}
MATERIALIZED = {"model_settings.fused_score_kernel": False, VQ + "fused_st": False}


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    keys, step = CASES[request.param]
    _, model, variables, port, _ = setup_pair(keys)
    batch = make_batch()
    return (request.param, keys, model, variables, port, batch, step,
            jax_grads(model, variables, batch, step))


def _check(port, variables, batch, step, jlosses, jgrads):
    losses, pgrads = port_grads(port, batch, step)
    for key in ("loss", "c_cl_loss", "p_cl_loss", "quantity_loss"):
        np.testing.assert_allclose(losses[key], float(jlosses[key]), rtol=1e-5, err_msg=key)
    compare_grads(port, variables, jgrads, pgrads)
    return pgrads


def test_vq_variant_matches_jax(pair):
    name, keys, _, variables, port, batch, step, (jlosses, jgrads) = pair
    assert port.cascaded_branch.head.vector_quantizer.fused_score_kernel
    pgrads = _check(port, variables, batch, step, jlosses, jgrads)
    temp = "cascaded_branch.head.vector_quantizer.curr_temp"
    assert (temp in pgrads) == (name == "learnable")
    if name == "learnable":
        assert abs(float(pgrads[temp])) > 0
        assert len(port.cascaded_branch.downsampling.convs()) == 2


def test_materialized_route_matches_jax(pair):
    """The same model on the materialized route: the port builds the (B, K,
    V) scores and the one-hot + softmax product, as JAX's `fused_st: false`."""
    name, keys, _, variables, _, batch, step, (jlosses, jgrads) = pair
    port, _, _ = build_model_from_config(set_keys(load_config(TINY), {**keys, **MATERIALIZED}),
                                         device="cpu", seed=0)
    load_jax_variables(port, variables)
    vqm = port.cascaded_branch.head.vector_quantizer
    assert not vqm.fused_score_kernel and not vqm.cfg.fused_st
    _check(port, variables, batch, step, jlosses, jgrads)


def test_scheduled_temperature_matches_jax():
    for step in (0, 1000, 10 ** 6):
        got = vq.scheduled_temperature(2.0, 0.5, 0.999995, step)
        want = jvq.scheduled_temperature(2.0, 0.5, 0.999995, jnp.asarray(step))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, err_msg=str(step))
    assert float(vq.scheduled_temperature(2.0, 0.5, 0.999995, 10 ** 6)) == 0.5


def _scores(b=3, t=4, v=40, d=8, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (b, t, v)).astype(np.float32)
    cb = rng.randn(v, d).astype(np.float32)
    g = rng.randn(b, t, d).astype(np.float32)
    return x, cb, g


@pytest.mark.parametrize("hard,fused_st", [(True, True), (True, False), (False, True)])
def test_training_forms_match_jax(hard, fused_st):
    """Straight-through (gather or materialized) and soft: the keywords, the
    statistics and the gradients into the scores, the codebook and the
    temperature."""
    x, cb, g = _scores()
    prob_msk = (0, 2, 3)

    def jfun(x, cb, t):
        r = jvq.simple_vector_quantizer(x, temp=t, prob_msk=prob_msk, training=True, hard=hard,
                                        codebook=cb, fused_st=fused_st)
        return jnp.sum(r["keywords"] * g), r

    (jl, jr), jg = jax.value_and_grad(jfun, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(cb), jnp.float32(0.7))
    tx, tcb, tt = (torch.tensor(a, requires_grad=True) for a in (x, cb, np.float32(0.7)))
    r = vq.simple_vector_quantizer(tx, temp=tt, prob_msk=prob_msk, training=True, hard=hard,
                                   codebook=tcb, fused_st=fused_st)
    loss = (r["keywords"] * torch.from_numpy(g)).sum()
    pg = torch.autograd.grad(loss, (tx, tcb, tt))
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(loss), float(jl), **tol)
    for key in ("code_perplexity", "prob_perplexity", "ent_per_t", "diversity_loss",
                "subword_prob", "targets"):
        np.testing.assert_allclose(r[key].detach().numpy(), np.asarray(jr[key]), **tol,
                                   err_msg=key)
    for what, a, b in zip(("scores", "codebook", "temp"), pg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol, err_msg=what)


def test_time_first_false_matches_jax():
    x, _, _ = _scores()
    xt = np.swapaxes(x, 1, 2).copy()  # (B, V, T)
    want = jvq.simple_vector_quantizer(jnp.asarray(xt), temp=jnp.float32(0.5), training=True,
                                       time_first=False)
    got = vq.simple_vector_quantizer(torch.from_numpy(xt), temp=0.5, training=True,
                                     time_first=False)
    for key in ("subword_prob", "targets", "ent_per_t", "prob_perplexity"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)


def test_gumbel_is_one_hot_needs_a_generator_and_leaves_eval_alone():
    x, cb, _ = _scores()
    tx = torch.from_numpy(x)
    with pytest.raises(ValueError, match="generator"):
        vq.simple_vector_quantizer(tx, temp=0.5, training=True, use_gumbel=True)
    g = torch.Generator().manual_seed(0)
    r = vq.simple_vector_quantizer(tx, temp=0.5, training=True, use_gumbel=True, generator=g,
                                   codebook=torch.from_numpy(cb))
    # one-hot up to the rounding of hard + soft - soft, as in JAX
    p, k = r["subword_prob"], r["targets"][..., 0]
    one_hot = torch.nn.functional.one_hot(k, p.shape[-1]).float()
    torch.testing.assert_close(p, one_hot, rtol=0, atol=1e-6)
    torch.testing.assert_close(r["keywords"], torch.from_numpy(cb)[k], rtol=0, atol=1e-5)
    assert not set(r["targets"].unique().tolist()) & {0, 2, 3}
    # the noise moves some winners off the argmax, and a second draw differs
    plain = vq.simple_vector_quantizer(tx, temp=0.5)
    r2 = vq.simple_vector_quantizer(tx, temp=0.5, training=True, use_gumbel=True, generator=g)
    assert not torch.equal(r["targets"], plain["targets"])
    assert not torch.equal(r["targets"], r2["targets"])
    ev = vq.simple_vector_quantizer(tx, temp=0.5, use_gumbel=True, generator=g)
    for key in ("targets", "subword_prob", "prob_perplexity"):
        assert torch.equal(ev[key], plain[key]), key


def test_st_backward_twin_takes_a_device_temperature():
    """K3b's twin with the temperature as a 0-d tensor equals the float
    form, and its dt is the JAX straight-through form's temperature
    gradient."""
    rng = np.random.RandomState(1)
    n, v, d = 12, 40, 16
    xn = rng.randn(n, d).astype(np.float32)
    xn /= np.linalg.norm(xn, axis=-1, keepdims=True)
    emb = rng.randn(v, d).astype(np.float32)
    g = rng.randn(n, d).astype(np.float32)
    norms = np.maximum(np.linalg.norm(emb, axis=-1), 1e-8)
    en = emb / norms[:, None]
    mask = torch.zeros(v, dtype=torch.int32)
    mask[[0, 2, 3]] = 1
    args = [torch.from_numpy(a) for a in (xn, g, en, norms)]
    dx, dt = plain_st_backward(*args, mask, torch.tensor(0.1))
    dx2, dt2 = plain_st_backward(*args, mask, 0.1)
    assert torch.equal(dx, dx2) and torch.equal(dt, dt2)
    scores = xn @ en.T
    scores[:, [0, 2, 3]] = -1e30

    def f(t):
        return jnp.sum(jvq.st_codebook_matmul(jnp.asarray(scores), jnp.asarray(emb), t) * g)

    np.testing.assert_allclose(float(dt), float(jax.grad(f)(jnp.float32(0.1))), rtol=1e-4)


def test_training_after_a_serving_call_on_the_same_vocabulary():
    """A serving call (inference mode) first, then a training step with a
    learnable temperature: the column mask the first call put on the device
    is saved for the backward of the second."""
    from speechclip_plus_tpu_torch.ops.fused_keyword import fused_cosine_vq

    rng = torch.Generator().manual_seed(0)
    emb = torch.randn(37, 16, generator=rng)
    x = torch.nn.functional.normalize(torch.randn(2, 3, 16, generator=rng), dim=-1)
    with torch.inference_mode():
        fused_cosine_vq(x, emb, 0.1, prob_msk=(0, 5, 6), dtype=torch.float32)
    temp = torch.nn.Parameter(torch.tensor(0.1))
    xn = x.clone().requires_grad_(True)
    res = fused_cosine_vq(xn, emb, temp, prob_msk=(0, 5, 6), dtype=torch.float32,
                          training=True)
    res["keywords"].sum().backward()
    assert temp.grad is not None and float(temp.grad) != 0.0 and xn.grad is not None
