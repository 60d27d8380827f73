"""The training slice's small pieces against the JAX package, on the CPU.

- The counter-based dropout mask (`ops/random.py`): its int64 torch hash is
  lowbias32 bit for bit (the CUDA kernels' uint32 arithmetic, checked against
  a pure-Python reference), deterministic, seed- and offset-sensitive, and its
  keep rate is within 4 sigma of the target. `nn/dropout.py` likewise.
- LR schedules against JAX's at every step, past `max_step` and in a resumed
  run that extends it (the floor at `final_lr`; noam keeps decaying).
- Adam with coupled L2 and the global-norm clip against the optax chain of
  JAX's `build_optimizer` on random parameter lists, clip on and off.
- The masked contrastive loss (ids, `valid`) and the quantity L1 loss, CIF in
  training form (alpha scaling, no tail handling) with its gradient, and
  keyword BN with batch statistics, each against JAX.
- K3b's twin (the straight-through VQ backward) against the JAX
  `fused_cosine_vq(training=True, interpret=True)` gradients into the keyword
  vectors and the temperature.

fp32 on both sides; tolerances 1e-5 (abs + rel) unless a test says otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speechclip_plus_tpu.ops import cif as jcif
from speechclip_plus_tpu.ops import kw_bn as jkw_bn
from speechclip_plus_tpu.ops import losses as jlosses
from speechclip_plus_tpu.ops import schedulers as jsched
from speechclip_plus_tpu.ops.fused_keyword import fused_cosine_vq as jax_fused_vq
from speechclip_plus_tpu_torch.nn.dropout import dropout
from speechclip_plus_tpu_torch.ops import cif, kw_bn, losses, schedulers
from speechclip_plus_tpu_torch.ops import fused_keyword as fk
from speechclip_plus_tpu_torch.ops.random import (
    attention_keep_mask,
    draw_seed,
    keep_threshold,
    mix32,
)
from speechclip_plus_tpu_torch.optim.optimizer import Optimizer

TOL = dict(rtol=1e-5, atol=1e-5)


def _lowbias32(x: int) -> int:
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x846CA68B) & 0xFFFFFFFF
    return x ^ (x >> 16)


def test_mix32_is_lowbias32_in_uint32():
    vals = [0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1] + list(
        np.random.RandomState(0).randint(0, 2 ** 32, size=200, dtype=np.int64))
    got = mix32(torch.tensor(vals, dtype=torch.int64)).tolist()
    assert got == [_lowbias32(int(v)) for v in vals]


def test_attention_mask_matches_its_definition():
    seeds = torch.tensor([2 ** 32 - 5, 123456789])
    keep = attention_keep_mask(seeds, 2, 3, 5, 0.7)
    thresh = keep_threshold(0.7)
    for b, h, i, j in [(0, 0, 0, 0), (1, 2, 4, 3), (0, 1, 2, 4), (1, 0, 3, 1)]:
        row = (b * 3 + h) * 5 + i
        bits = _lowbias32(_lowbias32(row ^ int(seeds[0])) ^
                          _lowbias32((j + int(seeds[1])) & 0xFFFFFFFF))
        assert bool(keep[b, h, i, j]) == (bits < thresh)


@pytest.mark.parametrize("keep_prob", [0.9, 0.5])
def test_attention_mask_is_deterministic_seeded_and_at_rate(keep_prob):
    seeds = draw_seed(torch.Generator().manual_seed(0))
    assert seeds.dtype == torch.int64 and bool(((seeds >= 0) & (seeds < 2 ** 32)).all())
    a = attention_keep_mask(seeds, 4, 8, 97, keep_prob)
    assert torch.equal(a, attention_keep_mask(seeds.clone(), 4, 8, 97, keep_prob))
    for other in (seeds + torch.tensor([1, 0]), seeds + torch.tensor([0, 1])):
        b = attention_keep_mask(other, 4, 8, 97, keep_prob)
        differ = (a != b).float().mean().item()
        assert abs(differ - 2 * keep_prob * (1 - keep_prob)) < 0.01
    n = a.numel()
    sigma = (keep_prob * (1 - keep_prob) / n) ** 0.5
    assert abs(a.float().mean().item() - keep_prob) <= 4 * sigma
    # no structure along rows or columns: per-row and per-column rates
    rows, cols = a.float().mean(-1), a.float().mean(-2)
    assert abs(rows.std().item() - (keep_prob * (1 - keep_prob) / 97) ** 0.5) < 0.01
    assert abs(cols.std().item() - (keep_prob * (1 - keep_prob) / 97) ** 0.5) < 0.01
    assert not torch.equal(draw_seed(torch.Generator().manual_seed(0)),
                           draw_seed(torch.Generator().manual_seed(1)))


def test_dropout_module():
    x = torch.ones(200, 500)
    assert torch.equal(dropout(x, 0.1, None), x)  # no generator: deterministic
    y = dropout(x, 0.1, torch.Generator().manual_seed(0))
    assert torch.equal(y, dropout(x, 0.1, torch.Generator().manual_seed(0)))
    assert not torch.equal(y, dropout(x, 0.1, torch.Generator().manual_seed(1)))
    kept = y != 0
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))
    sigma = (0.9 * 0.1 / x.numel()) ** 0.5
    assert abs(kept.float().mean().item() - 0.9) <= 4 * sigma
    assert torch.equal(dropout(x, 0.0, torch.Generator()), x)


def test_linear_warmup_decay_matches_jax_past_max_step_and_resumed():
    kw = dict(warmup=5, max_step=20, final_lr=1e-8)
    want = jsched.linear_warmup_decay_schedule(1e-4, **kw)
    got = schedulers.get_schedule("linear_warmup_decay", 1e-4, **kw)
    steps = list(range(0, 61))  # a resumed run extended to 3x max_step
    # JAX evaluates in fp32: near the floor its 1 - (1 - 1e-4) cancels to ~1e-11
    np.testing.assert_allclose([got(s) for s in steps], [float(want(s)) for s in steps],
                               rtol=1e-6, atol=1e-11)
    assert got(4) == pytest.approx(1e-4) and got(19) == pytest.approx(1e-8)
    assert all(got(s) == pytest.approx(1e-8) for s in range(20, 61))  # floored, never < 0


def test_noam_matches_jax_past_warmup_and_resumed():
    want = jsched.noam_schedule(2e-4, warmup=8)
    got = schedulers.get_schedule("noam", 2e-4, warmup=8)
    steps = list(range(0, 200))
    vals = [got(s) for s in steps]
    np.testing.assert_allclose(vals, [float(want(s)) for s in steps], rtol=1e-6, atol=0)
    assert vals[7] == pytest.approx(2e-4) and all(v > 0 for v in vals)
    assert all(a > b for a, b in zip(vals[8:], vals[9:]))  # keeps decaying, stays positive
    with pytest.raises(NotImplementedError):
        schedulers.get_schedule("cosine", 1e-4)


@pytest.mark.parametrize("grad_scale,clip", [(1.0, 4.0), (100.0, 4.0), (1.0, 0.0)])
def test_adam_l2_clip_matches_optax(grad_scale, clip):
    rng = np.random.RandomState(7)
    shapes = [(5, 3), (7,), (), (2, 2, 3)]
    params = [np.asarray(rng.randn(*s), np.float32) for s in shapes]
    grads = [[np.asarray(grad_scale * rng.randn(*s), np.float32) for s in shapes]
             for _ in range(4)]
    schedule_kw = dict(warmup=2, max_step=10, final_lr=1e-8)
    parts = ([optax.clip_by_global_norm(clip)] if clip else []) + [
        optax.add_decayed_weights(1e-2), optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8),
        optax.scale_by_learning_rate(jsched.linear_warmup_decay_schedule(1e-2, **schedule_kw))]
    tx = optax.chain(*parts)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = Optimizer(tp, lr=1e-2, weight_decay=1e-2, gradient_clip_val=clip,
                    schedule=schedulers.linear_warmup_decay_schedule(1e-2, **schedule_kw))
    for step, g in enumerate(grads):
        updates, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.apply([torch.from_numpy(a) for a in g], step)
        for got, want in zip(tp, jp):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5,
                                       atol=1e-7)


@pytest.mark.parametrize("valid", [None, [True, True, False, True, True]])
def test_masked_contrastive_loss_matches_jax(valid):
    rng = np.random.RandomState(1)
    a, b = (rng.randn(5, 8).astype(np.float32) for _ in range(2))
    a, b = (x / np.linalg.norm(x, axis=-1, keepdims=True) for x in (a, b))
    ids = np.array([3, 1, 3, 0, 2])
    v = None if valid is None else np.asarray(valid)
    for kw in (dict(), dict(margin=0.2), dict(dcl=True), dict(b2a=False)):
        want = jlosses.masked_contrastive_loss(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(ids), logit_scale=jnp.float32(14.3),
            valid=None if v is None else jnp.asarray(v), **kw)
        ta = torch.from_numpy(a).requires_grad_(True)
        got = losses.masked_contrastive_loss(
            ta, torch.from_numpy(b), torch.from_numpy(ids), logit_scale=torch.tensor(14.3),
            valid=None if v is None else torch.from_numpy(v), **kw)
        np.testing.assert_allclose(float(got.detach()), float(want), **TOL, err_msg=str(kw))
        jgrad = jax.grad(lambda x: jlosses.masked_contrastive_loss(
            x, jnp.asarray(b), jnp.asarray(ids), logit_scale=jnp.float32(14.3),
            valid=None if v is None else jnp.asarray(v), **kw))(jnp.asarray(a))
        got.backward()
        np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jgrad), **TOL, err_msg=str(kw))
    q = rng.rand(5).astype(np.float32) * 20
    t = np.array([4, 17, 9, 0, 12])
    want = jlosses.quantity_l1_loss(jnp.asarray(q), jnp.asarray(t),
                                    None if v is None else jnp.asarray(v))
    got = losses.quantity_l1_loss(torch.from_numpy(q), torch.from_numpy(t),
                                  None if v is None else torch.from_numpy(v))
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_cif_training_form_matches_jax():
    """Scaled alphas (toward the target length), no tail handling, and the
    gradient into features and alphas through the cumulative sums."""
    rng = np.random.RandomState(2)
    x = rng.randn(3, 30, 8).astype(np.float32)
    a = rng.rand(3, 30).astype(np.float32) * 0.4
    a[1, 22:] = 0.0
    target = np.array([7, 5, 9])
    probe = rng.randn(3, 75, 8).astype(np.float32)

    def jfun(x, a):
        out = jcif.integrate_and_fire(x, jcif.scale_alpha(a, jnp.asarray(target)),
                                      is_inference=False)
        return (out["dsample_feats"] * probe[:, :75]).sum(), out

    (jl, jout), (jdx, jda) = jax.value_and_grad(jfun, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(a))
    tx, ta = (torch.from_numpy(v).requires_grad_(True) for v in (x, a))
    out = cif.integrate_and_fire(tx, cif.scale_alpha(ta, torch.from_numpy(target)),
                                 is_inference=False)
    (out["dsample_feats"] * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_array_equal(out["dsample_feats_length"].numpy(),
                                  np.asarray(jout["dsample_feats_length"]))
    np.testing.assert_allclose(out["dsample_feats"].detach().numpy(),
                               np.asarray(jout["dsample_feats"]), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jda), rtol=1e-4, atol=1e-4)


def test_kw_bn_training_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(4, 6, 16).astype(np.float32) * 2 + 1
    scale, bias = rng.rand(16).astype(np.float32) + 0.5, rng.randn(16).astype(np.float32)
    mean, var = rng.randn(16).astype(np.float32), rng.rand(16).astype(np.float32) + 0.1
    probe = rng.randn(4, 6, 16).astype(np.float32)

    def jfun(x):
        y, st = jkw_bn.kw_bn_dynamic(x, {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                                     {"mean": jnp.asarray(mean), "var": jnp.asarray(var)},
                                     training=True)
        return (y * probe).sum(), (y, st)

    (_, (jy, jst)), jdx = jax.value_and_grad(jfun, has_aux=True)(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    y, (new_mean, new_var) = kw_bn.kw_bn_dynamic(
        tx, *(torch.from_numpy(a) for a in (scale, bias, mean, var)), training=True)
    (y * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(new_mean.numpy(), np.asarray(jst["mean"]), **TOL)
    np.testing.assert_allclose(new_var.numpy(), np.asarray(jst["var"]), **TOL)
    assert not new_mean.requires_grad and not new_var.requires_grad


@pytest.mark.parametrize("b,k,d,v,seed", [(4, 16, 128, 300, 0), (4, 8, 32, 1000, 1)])
def test_st_backward_matches_jax_kernel(b, k, d, v, seed):
    """K3b's twin: dx and dt against the JAX Pallas backward (interpret mode)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, k, d).astype(np.float32)
    xn = x / np.linalg.norm(x, axis=-1, keepdims=True)
    emb = (rng.randn(v, d) * 0.1 + rng.randn(1, d) * 0.02).astype(np.float32)
    probe = rng.randn(b, k, d).astype(np.float32)

    def jfun(xn, temp):
        r = jax_fused_vq(xn, jnp.asarray(emb), temp, prob_msk=(0, 2, 3), training=True,
                         dtype=jnp.float32, interpret=True)
        return (r["keywords"] * probe).sum()

    jdx, jdt = jax.grad(jfun, argnums=(0, 1))(jnp.asarray(xn), jnp.float32(0.1))
    embf = torch.from_numpy(emb)
    norms = embf.norm(dim=-1).clamp_min(1e-8)
    en = embf / norms[:, None]
    flat = torch.from_numpy(xn.reshape(-1, d))
    dx, dt = fk.st_backward(flat, torch.from_numpy(probe.reshape(-1, d)), en, norms,
                            fk.column_mask(v, (0, 2, 3), "cpu"), 0.1)
    np.testing.assert_allclose(dx.numpy().reshape(b, k, d), np.asarray(jdx), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(dt), float(jdt), rtol=1e-4, atol=1e-5)
    # and through the autograd path the model takes
    xt = torch.from_numpy(xn).requires_grad_(True)
    r = fk.fused_cosine_vq(xt, embf, 0.1, dtype=torch.float32, training=True)
    (r["keywords"] * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="frozen"):
        fk.fused_cosine_vq(xt, embf.clone().requires_grad_(True), 0.1, training=True)
