"""The PyTorch port's serving slice against the JAX package, end to end.

Both packages build hybrid+ from `config/dev/tiny.yaml`; the JAX variables
are moved into the port through `checkpoint/from_jax.py`, then the same
ragged float32 and int16 waveforms go through `SpeechCLIP.encode_speech`,
`build_image_index` and `SpeechRetriever.search` (parallel and cascaded) on
both. fp32 on the CPU: the JAX model takes its XLA paths, the port the plain
twins of its CUDA kernels. Ids, VQ targets and keyword counts must be equal;
features and scores agree to 1e-5 abs.

Also: the port imports no JAX, the parallel query runs no cascaded work, and
`chip_smoke.py` fails fast where there is no CUDA device.
"""
import os
import pkgutil
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechclip_plus_tpu.api import SpeechCLIP as JSpeechCLIP
from speechclip_plus_tpu.config import load_config as jax_load_config
from speechclip_plus_tpu.models.kwclip import KWClip as JKWClip
from speechclip_plus_tpu.models.kwclip import KWClipConfig as JKWClipConfig
from speechclip_plus_tpu.models.kwclip import init_kw_bn_from_token_embedding as jax_kw_bn_init
from speechclip_plus_tpu.serving import SpeechRetriever as JRetriever
from speechclip_plus_tpu.serving import build_image_index as jax_build_index
from speechclip_plus_tpu.tasks.builder import resolve_reduced_vocab as jax_vocab

import speechclip_plus_tpu.api as jax_api
import speechclip_plus_tpu_torch
import speechclip_plus_tpu_torch.api as port_api
from speechclip_plus_tpu_torch.api import SpeechCLIP
from speechclip_plus_tpu_torch.checkpoint.from_jax import load_jax_variables
from speechclip_plus_tpu_torch.config import load_config
from speechclip_plus_tpu_torch.serving import SpeechRetriever, build_image_index
from speechclip_plus_tpu_torch.tasks.builder import build_model_from_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "config", "dev", "tiny.yaml")
ATOL = 1e-5


def _jax_model():
    """The JAX builder's steps with a jitted init (same variables tree)."""
    cfg = jax_load_config(TINY)
    vocab = jax_vocab(cfg)
    mcfg = JKWClipConfig.from_config(cfg, vocab_size=len(vocab), sot_id=int(vocab.sot_reduced),
                                     eot_id=int(vocab.eot_reduced))
    model = JKWClip(mcfg)
    rng = np.random.RandomState(0)
    batch = {"wav": jnp.asarray(rng.randn(2, 3200).astype(np.float32)),
             "wav_len": jnp.asarray([3200, 2880]),
             "image": jnp.asarray(rng.randn(2, 32, 32, 3).astype(np.float32)),
             "id": jnp.asarray([0, 1]), "text": jnp.zeros((2, 16), jnp.int32)}
    variables = jax.jit(lambda k, b: model.init({"params": k}, b, training=False))(
        jax.random.PRNGKey(0), batch)
    variables = jax.tree_util.tree_map(np.array, dict(variables))
    params = jax_kw_bn_init(
        variables["params"], variables["params"]["clip"]["text"]["token_embedding"]["embedding"],
        mcfg)
    # the random alpha head saturates CIF at max_feat_len for every utterance;
    # a low bias makes the keyword count follow the utterance length
    params["cascaded_branch"]["downsampling"]["weight_proj"]["bias"] = np.full(1, -6.0, np.float32)
    variables["params"] = jax.tree_util.tree_map(np.asarray, params)
    return model, variables


@pytest.fixture(scope="module", autouse=True)
def short_buckets():
    """The tiny tower keeps one frame per 4 samples (the base tower one per
    320), so the first serving bucket of 16000 samples would give it 4000
    frames; both packages pad to one 4000-sample bucket here instead."""
    with pytest.MonkeyPatch.context() as mp:
        for pad in (jax_api._pad_wavs, port_api._pad_wavs):
            mp.setattr(pad, "__defaults__", ((4000,),))
        yield


@pytest.fixture(scope="module")
def pair():
    jmodel, variables = _jax_model()
    model, _, _ = build_model_from_config(load_config(TINY), device="cpu", seed=0)
    load_jax_variables(model, variables)
    return JSpeechCLIP(jmodel, variables), SpeechCLIP(model, "cpu")


def _wavs(int16, seed=0, lens=(3200, 1700)):
    rng = np.random.RandomState(seed)
    wavs = [(0.3 * rng.randn(n)).astype(np.float32) for n in lens]
    if int16:
        wavs = [np.clip(w * 32767, -32768, 32767).astype(np.int16) for w in wavs]
    return wavs


@pytest.fixture(scope="module")
def indexes(pair):
    jsc, sc = pair
    images = np.random.RandomState(7).randn(20, 32, 32, 3).astype(np.float32)
    ids = list(range(100, 120))
    return (jax_build_index(jsc, images, ids, batch_size=8),
            build_image_index(sc, images, ids, batch_size=8))


@pytest.mark.parametrize("int16", [False, True])
def test_encode_speech_matches_jax(pair, int16):
    jsc, sc = pair
    want = jsc.encode_speech(_wavs(int16))
    got = sc.encode_speech(_wavs(int16))
    assert got["parallel_audio_feat"].shape == (2, 32)
    for key in ("parallel_audio_feat", "cascaded_audio_feat"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=ATOL,
                                   err_msg=key)
    lens = got["dsample_results"]["dsample_feats_length"].numpy()
    np.testing.assert_array_equal(lens, np.asarray(want["dsample_results"]["dsample_feats_length"]))
    assert len(set(lens.tolist())) > 1  # the keyword count follows the length
    np.testing.assert_array_equal(got["vq_results"]["targets"].numpy(),
                                  np.asarray(want["vq_results"]["targets"]))
    np.testing.assert_allclose(got["keywords"].numpy(), np.asarray(want["keywords"]),
                               rtol=0, atol=ATOL)


def test_image_index_matches_jax(indexes):
    jindex, index = indexes
    np.testing.assert_allclose(index.feats.numpy(), np.asarray(jindex.feats), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(index.ids, jindex.ids)


@pytest.mark.parametrize("int16", [False, True])
@pytest.mark.parametrize("feat_src", ["parallel", "cascaded"])
def test_search_matches_jax(pair, indexes, feat_src, int16):
    (jsc, sc), (jindex, index) = pair, indexes
    want_ids, want_scores = JRetriever(jsc, jindex, feat_src=feat_src).search(_wavs(int16), k=5)
    ids, scores = SpeechRetriever(sc, index, feat_src=feat_src).search(_wavs(int16), k=5)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(scores, want_scores, rtol=0, atol=ATOL)
    assert (np.diff(scores, axis=1) <= 0).all()


def test_parallel_query_runs_no_cascaded_work(pair, indexes, monkeypatch):
    _, sc = pair
    _, index = indexes

    def forbidden(*args, **kwargs):
        raise AssertionError("the parallel query ran cascaded work")

    monkeypatch.setattr(sc.model.cascaded_branch.downsampling, "forward", forbidden)
    monkeypatch.setattr(sc.model.cascaded_branch.head, "forward", forbidden)
    monkeypatch.setattr(sc.model.clip.text, "encode_keywords", forbidden)
    wavs = _wavs(False, lens=(1600,))
    ids, _ = SpeechRetriever(sc, index, feat_src="parallel").search(wavs, k=3)
    assert ids.shape == (1, 3)
    with pytest.raises(AssertionError, match="cascaded work"):
        SpeechRetriever(sc, index, feat_src="cascaded").search(wavs, k=3)


def test_submit_and_stream_match_search(pair, indexes):
    _, sc = pair
    _, index = indexes
    r = SpeechRetriever(sc, index, feat_src="cascaded")
    batches = [_wavs(False, seed=s, lens=(2000 + 300 * s,)) for s in range(3)]
    pending = r.submit(batches[0], k=4)
    assert pending.done()  # CPU tensors: nothing in flight
    want = [r.search(b, k=4) for b in batches]
    np.testing.assert_array_equal(pending.result()[0], want[0][0])
    for (ids, scores), (wids, wscores) in zip(r.search_stream(batches, k=4, depth=2), want):
        np.testing.assert_array_equal(ids, wids)
        np.testing.assert_array_equal(scores, wscores)


def test_builder_is_seeded():
    a, _, _ = build_model_from_config(load_config(TINY), device="cpu", seed=3)
    b, _, _ = build_model_from_config(load_config(TINY), device="cpu", seed=3)
    c, _, _ = build_model_from_config(load_config(TINY), device="cpu", seed=4)
    sa, sb, sc_ = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["audio_encoder.layers.0.fc1.weight"],
                           sc_["audio_encoder.layers.0.fc1.weight"])


def test_entry_points_default_to_the_card():
    """`build_model_from_config` and the inference wrapper put the model on
    the GPU unless the caller asks for the CPU."""
    import inspect

    assert inspect.signature(build_model_from_config).parameters["device"].default == "cuda"
    assert inspect.signature(SpeechCLIP.__init__).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            build_model_from_config(load_config(TINY))


def test_other_branch_types_raise():
    """The five families build; a branch type outside them raises by name."""
    cfg = load_config(TINY)
    cfg.model_settings.cascaded_branch.type = "KW_CascadedBranch"
    model, mcfg, _ = build_model_from_config(cfg, device="cpu")
    assert mcfg.branch_type == "CascadedBranch" and model.parallel_branch is None
    cfg.model_settings.cascaded_branch.type = "KW_ConformerBranch"
    with pytest.raises(NotImplementedError, match="cascaded_branch.type"):
        build_model_from_config(cfg, device="cpu")


def test_port_imports_no_jax():
    modules = [m.name for m in pkgutil.walk_packages(speechclip_plus_tpu_torch.__path__,
                                                      "speechclip_plus_tpu_torch.")]
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax'))"
            " or m == 'speechclip_plus_tpu' or m.startswith('speechclip_plus_tpu.')]\n"
            "assert not bad, bad\n"
            "print(len([m for m in sys.modules if m.startswith('speechclip_plus_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= len(modules) >= 20


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_cuda(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cwd = REPO
    if alone:  # a directory holding chip_smoke.py and nothing else of the repo
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                         text=True, timeout=60)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
