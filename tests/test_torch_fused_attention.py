"""PyTorch port of the attention-only kernel with dropout (K5) against JAX.

CPU, fp32: the port's plain twin (what its wrapper runs on a CPU tensor)
against the JAX Pallas kernel `fused_attention_dropout(..., interpret=True)`
at T = 50 and 130 (not multiples of its 128 padding), ragged key padding
and a fully padded row (finite). Tolerance 2e-5 abs: fp32 on both sides,
sums in another order. Also: with one (seed, offset) the twin equals K1's
context-only twin fed the same q, k, v; the backward raises; `from_config`
rejects a trainable tower; and the tiny hybrid+ model with
`audio_encoder.fused_attention: true` matches the JAX package
(`encode_speech` to 1e-5 abs and a 3-step training run, as in
`test_torch_wavlm.py`).

The CUDA kernel against the twin is in `test_torch_cuda_kernels.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechclip_plus_tpu.nn.fused_attention import fused_attention_dropout as jax_fad

from speechclip_plus_tpu_torch.config import load_config
from speechclip_plus_tpu_torch.models.hubert import HubertConfig
from speechclip_plus_tpu_torch.models.kwclip import KWClipConfig
from speechclip_plus_tpu_torch.nn import fused_attention as fa
from speechclip_plus_tpu_torch.nn import fused_attention_block as fab
from speechclip_plus_tpu_torch.tasks.builder import build_model_from_config

from test_torch_slice import TINY, short_buckets  # noqa: F401 (autouse fixture)
from test_torch_wavlm import check_encode_speech, check_training_steps, hybrid_pair

ATOL = 2e-5


def _qkv(seed, b, h, t, dh, padded_row=False):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, t, dh).astype(np.float32) for _ in range(3))
    lens = np.array([t] + list(rng.randint(1, t + 1, size=b - 1)))
    kb = np.where(np.arange(t)[None, :] >= lens[:, None], -1e30, 0.0).astype(np.float32)
    if padded_row:
        kb[-1, :] = -1e30
    return q, k, v, kb


@pytest.mark.parametrize("t", [50, 130])
@pytest.mark.parametrize("bias_rank", [2, 4, None])
def test_twin_matches_jax_kernel(t, bias_rank):
    q, k, v, kb = _qkv(0, 3, 4, t, 16)
    jbias = {2: jnp.asarray(kb), 4: jnp.asarray(kb)[:, None, None, :], None: None}[bias_rank]
    want = np.asarray(jax_fad(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jbias,
                              interpret=True))
    got = fa.fused_attention_dropout(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v),
                                     None if bias_rank is None else torch.from_numpy(kb))
    assert got.shape == (3, 4, t, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_fully_padded_row_is_finite():
    q, k, v, kb = _qkv(1, 3, 2, 50, 8, padded_row=True)
    want = np.asarray(jax_fad(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kb),
                              interpret=True))
    got = fa.fused_attention_dropout(*(torch.from_numpy(a) for a in (q, k, v, kb)))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got[:-1].numpy(), want[:-1], atol=ATOL, rtol=0)
    # -1e30 absorbs the scores, so a fully padded row is the mean of v over its
    # T keys (the JAX kernel, which pads T to 128, averages over the pad too)
    np.testing.assert_allclose(got[-1].numpy(), np.broadcast_to(v[-1].mean(1, keepdims=True),
                                                                v[-1].shape), atol=ATOL)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_twin_draws_the_block_kernels_mask(p):
    """K5's twin on the q, k, v that K1's context-only twin projects, with the
    same (seed, offset): the same mask, so the same context."""
    rng = np.random.RandomState(2)
    b, t, d, heads = 2, 37, 48, 4
    x = torch.from_numpy(rng.randn(b, t, d).astype(np.float32))
    w_in = torch.from_numpy((rng.randn(3 * d, d) * d ** -0.5).astype(np.float32))
    b_in = torch.from_numpy((rng.randn(3 * d) * 0.1).astype(np.float32))
    kb = torch.from_numpy(_qkv(3, b, heads, t, d // heads)[3])
    seeds = torch.tensor([123456789, 4242], dtype=torch.int64)
    ctx, qkv, _ = fab.attention_forward(x, w_in, b_in, kb, n_heads=heads, seeds=seeds,
                                        keep_prob=1.0 - p)
    q, k, v = qkv.view(b, t, 3, heads, d // heads).permute(2, 0, 3, 1, 4).unbind(0)
    # K1's buffer holds q already scaled by 1/sqrt(dh); K5 scales q itself
    got = fa._run(q * (d // heads) ** 0.5, k, v, kb, seeds, 1.0 - p)
    np.testing.assert_allclose(got.transpose(1, 2).reshape(b, t, d).numpy(), ctx.numpy(),
                               atol=1e-6, rtol=0)
    same = fa.fused_attention_dropout(q, k, v, kb, dropout_rate=p,
                                      generator=torch.Generator().manual_seed(5))
    again = fa.fused_attention_dropout(q, k, v, kb, dropout_rate=p,
                                       generator=torch.Generator().manual_seed(5))
    other = fa.fused_attention_dropout(q, k, v, kb, dropout_rate=p,
                                       generator=torch.Generator().manual_seed(6))
    assert torch.equal(same, again) and not torch.equal(same, other)
    # no generator, no seeds: deterministic, whatever the rate
    assert torch.equal(fa.fused_attention_dropout(q, k, v, kb, dropout_rate=p),
                       fa.fused_attention_dropout(q, k, v, kb))


def test_backward_raises():
    q, k, v, kb = (torch.from_numpy(a) for a in _qkv(4, 2, 2, 16, 8))
    out = fa.fused_attention_dropout(q.requires_grad_(), k, v, kb)
    with pytest.raises(NotImplementedError, match="forward-only"):
        out.sum().backward()


@pytest.mark.parametrize("key", ["fused_attention", "fused_attention_block"])
def test_from_config_rejects_a_trainable_tower(key):
    cfg = load_config(TINY)
    cfg.audio_encoder.trainable = True
    setattr(cfg.audio_encoder, key, True)
    with pytest.raises(ValueError, match=f"audio_encoder.{key} requires a frozen tower"):
        KWClipConfig.from_config(cfg)


def test_from_config_reads_the_attention_keys():
    cfg = load_config(TINY)
    default = KWClipConfig.from_config(cfg).audio
    assert default.fused_attention_block and not default.fused_attention_dropout
    cfg.audio_encoder.fused_attention = True
    cfg.audio_encoder.fused_attention_block = False
    audio = KWClipConfig.from_config(cfg).audio
    assert audio.fused_attention_dropout and not audio.fused_attention_block
    model, mcfg, _ = build_model_from_config(cfg, device="cpu", seed=0)
    assert mcfg.audio == audio and isinstance(mcfg.audio, HubertConfig)


@pytest.fixture(scope="module")
def k5_pair():
    # the JAX tower takes `fused_attention_dropout` to its XLA route off the TPU
    over = dict(fused_attention_dropout=True, fused_attention_block=False)
    return hybrid_pair(over)


def test_hybrid_plus_with_fused_attention_matches_jax(k5_pair, monkeypatch):
    cfg, jmodel, variables, model = k5_pair
    calls = []
    real = fa.plain_fused_attention_dropout
    monkeypatch.setattr(fa, "plain_fused_attention_dropout",
                        lambda *a, **kw: (calls.append(1), real(*a, **kw))[1])
    check_encode_speech(jmodel, variables, model)
    assert len(calls) == model.cfg.audio.n_layers  # every tower layer took the K5 route


def test_hybrid_plus_with_fused_attention_trains_like_jax(k5_pair):
    check_training_steps(*k5_pair)
