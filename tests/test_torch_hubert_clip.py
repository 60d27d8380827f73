"""PyTorch port's towers against the JAX towers, in fp32 on the CPU.

Tiny HuBERT (`HubertConfig.tiny`, a padded ragged batch) and tiny CLIP
(`encode_keywords` with a per-row keyword count, EOT-by-id text pooling, the
vision tower), with the JAX weights moved through
`checkpoint/from_jax.py`. The JAX towers take their XLA paths on the CPU; the
port's attention takes the plain twin of its CUDA kernel. Tolerance 1e-5 abs
(fp32, several layers, sums in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechclip_plus_tpu.models.clip import ClipConfig as JClipConfig, ClipModel as JClip
from speechclip_plus_tpu.models.hubert import HubertConfig as JHubertConfig
from speechclip_plus_tpu.models.hubert import HubertModel as JHubert
from speechclip_plus_tpu_torch.checkpoint.from_jax import load_clip, load_hubert
from speechclip_plus_tpu_torch.models.clip import ClipConfig, ClipModel
from speechclip_plus_tpu_torch.models.hubert import HubertConfig, HubertModel

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def hubert_pair():
    jcfg = JHubertConfig.tiny()
    jm = JHubert(jcfg)
    wav = jnp.zeros((2, 400), jnp.float32)
    params = jax.jit(lambda k: jm.init(k, wav, wav == 1.0))(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, params)["params"]
    tm = HubertModel(HubertConfig.tiny()).eval()
    load_hubert(tm, params)
    return jm, params, tm


def _wav_batch(seed, lens, t):
    rng = np.random.RandomState(seed)
    wav = (0.5 * rng.randn(len(lens), t)).astype(np.float32)
    pad = np.arange(t)[None, :] >= np.asarray(lens)[:, None]
    wav[pad] = 0.0
    return wav, pad


@pytest.mark.parametrize("lens,t", [([800, 515, 300], 800), ([640, 640], 640)])
def test_hubert_weighted_sum_matches(hubert_pair, lens, t):
    jm, params, tm = hubert_pair
    wav, pad = _wav_batch(0, lens, t)
    logits = np.random.RandomState(1).randn(3).astype(np.float32)
    w = jax.nn.softmax(jnp.asarray(logits))
    want = jm.apply({"params": params}, jnp.asarray(wav), jnp.asarray(pad), layer_weights=w)
    with torch.no_grad():
        got = tm(torch.from_numpy(wav), torch.from_numpy(pad),
                 torch.softmax(torch.from_numpy(logits), 0))
    np.testing.assert_array_equal(got["padding_mask"].numpy(), np.asarray(want["padding_mask"]))
    for key in ("weighted_sum", "x"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL, err_msg=key)


def test_hubert_bridge_fills_every_tensor(hubert_pair):
    _, params, _ = hubert_pair
    fresh = HubertModel(HubertConfig.tiny())
    load_hubert(fresh, params)  # raises on a missing, doubled or misshapen tensor
    broken = dict(params)
    broken.pop("encoder_layer_norm")
    with pytest.raises(KeyError):
        load_hubert(HubertModel(HubertConfig.tiny()), broken)


@pytest.fixture(scope="module")
def clip_pair():
    jcfg = dataclasses.replace(JClipConfig.tiny(), vocab_size=8, sot_id=6, eot_id=7)
    jm = JClip(jcfg)
    img = jnp.zeros((1, 32, 32, 3), jnp.float32)
    ids = jnp.zeros((1, jcfg.context_length), jnp.int32)
    params = jax.jit(lambda k: jm.init(k, img, ids))(jax.random.PRNGKey(3))
    params = jax.tree_util.tree_map(np.asarray, params)["params"]
    tm = ClipModel(ClipConfig.tiny(vocab_size=8, sot_id=6, eot_id=7)).eval()
    load_clip(tm, params)
    return jm, params, tm


def _jclip(jm, params, method, *args):
    return np.asarray(jm.apply({"params": params}, *args, method=method))


def test_clip_encode_keywords_dynamic_count_matches(clip_pair):
    jm, params, tm = clip_pair
    rng = np.random.RandomState(4)
    kw = rng.randn(4, 14, 32).astype(np.float32)
    counts = np.array([1, 5, 14, 3], np.int32)
    want = _jclip(jm, params, JClip.encode_keywords, jnp.asarray(kw), jnp.asarray(counts))
    with torch.no_grad():
        got = tm.encode_keywords(torch.from_numpy(kw), torch.from_numpy(counts))
        fixed = tm.encode_keywords(torch.from_numpy(kw), 5)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(fixed[1].numpy(), got[1].numpy(), **TOL)


def test_clip_text_pools_at_eot_id(clip_pair):
    jm, params, tm = clip_pair
    ids = np.zeros((3, 16), np.int32)
    ids[:, 0] = 6
    ids[0, 1:4], ids[0, 4] = [1, 2, 5], 7      # EOT at 4
    ids[1, 1:9], ids[1, 9] = 4, 7              # EOT at 9
    ids[2, 1:6] = [5, 4, 3, 2, 1]              # no EOT: falls back to argmax
    want = _jclip(jm, params, JClip.encode_text, jnp.asarray(ids))
    with torch.no_grad():
        got = tm.encode_text(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_clip_vision_tower_matches(clip_pair):
    jm, params, tm = clip_pair
    img = np.random.RandomState(5).rand(3, 32, 32, 3).astype(np.float32)
    want = _jclip(jm, params, JClip.encode_image, jnp.asarray(img))
    with torch.no_grad():
        got = tm.encode_image(torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
