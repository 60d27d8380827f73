"""The port's inference and evaluation entry points against the JAX package.

fp32 on the CPU, `config/dev/tiny.yaml` (hybrid+), the JAX variables moved
into the port through `checkpoint/from_jax.py`, both packages padding to one
4000-sample bucket (as `test_torch_slice.py` does):

  - `SpeechCLIP.feature_extractor_s3prl`: every hidden state at 1e-5 abs;
  - `extract_keywords`: VQ targets and `targets_original` (full CLIP ids)
    equal;
  - `SpeechRetriever.search_text` with the BPE merges of
    `tests/test_serving.py`: ids equal, scores at 1e-5, and the error without
    a tokenizer;
  - `api.load_from_checkpoint` from a directory the port's
    `CheckpointManager` wrote (`last` and a monitor's best: the saved model
    bit for bit) and from a Lightning `.ckpt` (`encode_speech` against the
    JAX `load_from_checkpoint` route on the same file at 1e-5);
  - `run_task --test --device cpu --ckpt x.ckpt` on a Flickr-shaped tree;
  - `utils/metric.py` against JAX on goldens and seeded token lists;
    `utils/profiling.py`'s `StepTimer`, `trace` and a `span` inside it.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import speechclip_plus_tpu.api as jax_api
import speechclip_plus_tpu.utils.metric as jax_metric
from speechclip_plus_tpu.api import SpeechCLIP as JSpeechCLIP
from speechclip_plus_tpu.config import load_config as jax_load_config
from speechclip_plus_tpu.data.tokenizer import SimpleTokenizer as JSimpleTokenizer
from speechclip_plus_tpu.models.kwclip import KWClip as JKWClip
from speechclip_plus_tpu.models.kwclip import KWClipConfig as JKWClipConfig
from speechclip_plus_tpu.serving import SpeechRetriever as JRetriever
from speechclip_plus_tpu.serving import build_image_index as jax_build_index
from speechclip_plus_tpu.tasks.builder import resolve_reduced_vocab as jax_vocab

import speechclip_plus_tpu_torch.api as port_api
import speechclip_plus_tpu_torch.utils.metric as metric
from speechclip_plus_tpu_torch.api import SpeechCLIP, load_from_checkpoint
from speechclip_plus_tpu_torch.checkpoint import CheckpointManager
from speechclip_plus_tpu_torch.checkpoint.from_jax import load_jax_variables
from speechclip_plus_tpu_torch.config import load_config
from speechclip_plus_tpu_torch.data.tokenizer import SimpleTokenizer
from speechclip_plus_tpu_torch.models.kwclip import KWClip, KWClipConfig
from speechclip_plus_tpu_torch.optim.optimizer import build_optimizer_from_config
from speechclip_plus_tpu_torch.parallel.train_step import create_train_state
from speechclip_plus_tpu_torch.serving import SpeechRetriever, build_image_index
from speechclip_plus_tpu_torch.tasks.builder import build_model_from_config
from speechclip_plus_tpu_torch.utils import StepTimer, trace

from test_torch_checkpoint_import import (assert_same_speech, model_configs, reference_sd,
                                          write_lightning_ckpt)
from test_torch_data import write_flickr_tree
from test_torch_slice import _jax_model, _wavs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "config", "dev", "tiny.yaml")
ATOL = 1e-5
MERGES = ["#version: 0.2", "a t</w>", "c at</w>", "d o", "do g</w>",
          "r u", "ru n", "run s</w>", "t h", "th e</w>"]  # tests/test_serving.py


@pytest.fixture(scope="module", autouse=True)
def short_buckets():
    with pytest.MonkeyPatch.context() as mp:
        for pad in (jax_api._pad_wavs, port_api._pad_wavs):
            mp.setattr(pad, "__defaults__", ((4000,),))
        yield


@pytest.fixture(scope="module")
def pair():
    """hybrid+ tiny in both packages, the same weights and reduced vocabulary."""
    jmodel, variables = _jax_model()
    model, _, vocab = build_model_from_config(load_config(TINY), device="cpu", seed=0)
    load_jax_variables(model, variables)
    jvocab = jax_vocab(jax_load_config(TINY))
    return (JSpeechCLIP(jmodel, variables, vocab=jvocab),
            SpeechCLIP(model, "cpu", vocab=vocab))


def test_feature_extractor_matches_jax(pair):
    jsc, sc = pair
    wavs = _wavs(False)
    jlast, jhidden = jsc.feature_extractor_s3prl(wavs)
    last, hidden = sc.feature_extractor_s3prl(wavs)
    # the tower's L+1 states, then the branch's one layer over the frames
    assert len(hidden) == len(jhidden) == sc.cfg.audio.num_hidden_states + 1
    for i, (a, b) in enumerate(zip(hidden, jhidden)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=ATOL, err_msg=str(i))
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), rtol=0, atol=ATOL)
    assert last.shape == (2, 999, 32)  # 4000 samples through two (k=3, s=2) convs


def test_hidden_states_only_when_asked(pair):
    """The serving path keeps the fused weighted sum: no stack is built."""
    _, sc = pair
    wav, wav_len, _ = sc.to_device(_wavs(False))
    pad = torch.arange(wav.shape[1])[None, :] >= wav_len[:, None]
    with torch.no_grad():
        w = torch.softmax(sc.model.weightedsum, 0)
        plain = sc.model.audio_encoder(wav, pad, w)
        full = sc.model.audio_encoder(wav, pad, w, return_hidden_states=True)
    assert "hidden_states" not in plain
    assert torch.equal(plain["weighted_sum"], full["weighted_sum"])
    stack = full["hidden_states"]
    assert stack.shape[0] == 3 and torch.equal(stack[-1], full["x"])
    np.testing.assert_allclose((w[:, None, None, None] * stack).sum(0).numpy(),
                               full["weighted_sum"].numpy(), rtol=0, atol=ATOL)


def test_extract_keywords_matches_jax(pair):
    jsc, sc = pair
    wavs = _wavs(True, seed=2, lens=(3300, 2100, 900))
    want, got = jsc.extract_keywords(wavs), sc.extract_keywords(wavs)
    np.testing.assert_array_equal(got["vq_results"]["targets"].numpy(),
                                  np.asarray(want["vq_results"]["targets"]))
    np.testing.assert_array_equal(got["vq_results"]["targets_original"],
                                  want["vq_results"]["targets_original"])
    assert set(np.unique(got["vq_results"]["targets_original"])) <= set(
        sc.vocab.selected_ids.tolist())
    np.testing.assert_array_equal(
        got["dsample_results"]["dsample_feats_length"].numpy(),
        np.asarray(want["dsample_results"]["dsample_feats_length"]))


@pytest.fixture(scope="module")
def text_pair(tmp_path_factory):
    """hybrid+ tiny over the merges' full vocabulary (no reduced table), with
    the tokenizer, in both packages."""
    bpe = tmp_path_factory.mktemp("bpe") / "merges.txt"
    bpe.write_text("\n".join(MERGES) + "\n")
    jtok, tok = JSimpleTokenizer(str(bpe)), SimpleTokenizer(str(bpe))
    special = dict(vocab_size=tok.vocab_size, sot_id=tok.sot, eot_id=tok.eot)
    jcfg = JKWClipConfig.from_config(jax_load_config(TINY), **special)
    cfg = KWClipConfig.from_config(load_config(TINY), **special)
    jmodel = JKWClip(jcfg)
    rng = np.random.RandomState(0)
    batch = {"wav": jnp.asarray(rng.randn(2, 3200).astype(np.float32)),
             "wav_len": jnp.asarray([3200, 2880]),
             "image": jnp.asarray(rng.randn(2, 32, 32, 3).astype(np.float32)),
             "id": jnp.asarray([0, 1]), "text": jnp.zeros((2, 16), jnp.int32)}
    variables = jax.jit(lambda k, b: jmodel.init({"params": k}, b, training=False))(
        jax.random.PRNGKey(4), batch)
    variables = jax.tree_util.tree_map(np.array, dict(variables))
    variables.setdefault("batch_stats", {})
    model = KWClip(cfg)
    load_jax_variables(model, variables)
    jsc = JSpeechCLIP(jmodel, variables, tokenizer=jtok)
    sc = SpeechCLIP(model, "cpu", tokenizer=tok)
    images = rng.randn(9, 32, 32, 3).astype(np.float32)
    ids = np.arange(20, 29)
    return (JRetriever(jsc, jax_build_index(jsc, images, ids, batch_size=9)),
            SpeechRetriever(sc, build_image_index(sc, images, ids, batch_size=4)))


@pytest.mark.parametrize("k", [1, 3, 9])
def test_search_text_matches_jax(text_pair, k):
    jretr, retr = text_pair
    texts = ["the cat runs", "a dog", "cat dog runs the", "in"]
    jids, jscores = jretr.search_text(texts, k=k)
    ids, scores = retr.search_text(texts, k=k)
    assert ids.shape == scores.shape == (4, k)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(scores, np.asarray(jscores), rtol=0, atol=ATOL)


def test_search_text_needs_a_tokenizer(text_pair):
    _, retr = text_pair
    bare = SpeechRetriever(SpeechCLIP(retr.sc.model, "cpu"), retr.index)
    with pytest.raises(ValueError, match="text queries need a tokenizer"):
        bare.search_text(["a cat"])


def test_load_from_trainer_directory(tmp_path):
    cfg = load_config(TINY)
    model, _, _ = build_model_from_config(cfg, device="cpu", seed=3)
    state = create_train_state(build_optimizer_from_config(model, cfg))
    root = str(tmp_path / "checkpoints")
    mgr = CheckpointManager(root, config=cfg.to_dict())
    mgr.save(1, model, state, {"val_loss": 3.0, "val_recall_mean_10": 30.0})
    first = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.5)
        model.cascaded_branch.head.bn_layer.running_mean.add_(0.25)
    mgr.save(2, model, state, {"val_loss": 2.0, "val_recall_mean_10": 10.0})
    for monitor, want in ((None, model.state_dict()), ("val_recall_mean_10", first)):
        sc = load_from_checkpoint(root, monitor=monitor, device="cpu")
        got = sc.model.state_dict()
        assert got.keys() == want.keys()
        for name in got:
            assert torch.equal(got[name], want[name]), (monitor, name)
        assert sc.tokenizer is not None and sc.vocab is not None  # bpe_path, usage.npy
        assert sc.device.type == "cpu" and not sc.model.training


def test_load_from_checkpoint_needs_the_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_from_checkpoint(str(tmp_path / "x.ckpt"))


@pytest.fixture(scope="module")
def lightning_ckpt(tmp_path_factory):
    jcfg, _ = model_configs("hybrid_plus")
    path = str(tmp_path_factory.mktemp("ckpt") / "x.ckpt")
    write_lightning_ckpt(path, reference_sd(jcfg, "hybrid_plus"), load_config(TINY).to_dict())
    return path


def jax_load_lightning(path):
    """JAX `api.load_from_checkpoint`'s `.ckpt` route (``api.py:133-141``)
    without the seeded init of its `build_model_from_config`, whose variables
    the route replaces (an eager init of the whole model: 40 s on the CPU)."""
    from speechclip_plus_tpu.checkpoint import lightning_to_kwclip as jax_import
    from speechclip_plus_tpu.checkpoint import load_lightning_checkpoint as jax_load

    sd, cfg_node, _ = jax_load(path)
    vocab = jax_vocab(cfg_node)
    mcfg = JKWClipConfig.from_config(cfg_node, vocab_size=len(vocab),
                                     sot_id=int(vocab.sot_reduced), eot_id=int(vocab.eot_reduced))
    params, batch_stats = jax_import(sd, mcfg)
    return JSpeechCLIP(JKWClip(mcfg), {"params": params, "batch_stats": batch_stats},
                       vocab=vocab)


def test_load_from_lightning_ckpt_matches_jax(lightning_ckpt):
    jsc = jax_load_lightning(lightning_ckpt)
    sc = load_from_checkpoint(lightning_ckpt, device="cpu")
    assert sc.tokenizer is not None and sc.vocab is not None
    wavs = _wavs(False, seed=4, lens=(3400, 2000))
    assert_same_speech(sc.encode_speech(wavs), jsc.encode_speech(wavs))
    np.testing.assert_allclose(float(sc.model.criterion_log_inv_temp.detach()),
                               np.log(1 / 0.07), rtol=1e-6)


def test_run_task_test_from_lightning_ckpt(tmp_path, lightning_ckpt):
    root = write_flickr_tree(tmp_path / "flickr")
    out = subprocess.run(
        [sys.executable, "-m", "speechclip_plus_tpu_torch.run_task",
         "TrainKWClip_GeneralTransformer", "--test", "--device", "cpu", "--ckpt", lightning_ckpt,
         "--dataset_root", root, "--save_path", str(tmp_path / "eval"), "--njobs", "0",
         "--log_level", "INFO"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "Loaded Lightning checkpoint" in out.stderr
    assert "'val_recall_mean_10'" in out.stdout


def _token_lists(seed):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(0, 6, size=rng.randint(0, 9))) for _ in range(12)]


def test_text_metrics_match_jax():
    # the goldens of tests/test_pooling_metrics.py
    assert metric.edit_distance("kitten", "sitting") == 3
    assert metric.wer(["the dog sat"], ["the cat sat"]) == pytest.approx(1 / 3)
    assert metric.cer(["abcd"], ["abcf"]) == pytest.approx(0.25)
    assert metric.ter([[1, 2, 3]], [[1, 2, 4]]) == pytest.approx(1 / 3)
    assert metric.report_bleu(["the cat sat on the mat"], ["the cat sat on the mat"]) == \
        pytest.approx(100.0, abs=1e-6)
    hyps, refs = _token_lists(0), _token_lists(1)
    for h, r in zip(hyps, refs):
        assert metric.edit_distance(h, r) == jax_metric.edit_distance(h, r)
    assert metric.ter(hyps, refs) == jax_metric.ter(hyps, refs)
    words = lambda lists: [" ".join(f"w{t}" for t in x) for x in lists]
    for name in ("wer", "per", "cer", "report_bleu"):
        assert getattr(metric, name)(words(hyps), words(refs)) == \
            getattr(jax_metric, name)(words(hyps), words(refs)), name


def test_step_timer_and_trace(tmp_path):
    timer = StepTimer(batch_size=4)
    timer.tick()
    assert timer.steps_per_sec == 0.0 and timer.pairs_per_sec == 0.0
    x = torch.ones(8)
    for _ in range(3):
        x = x * 2
        timer.tick(sync_on={"x": x, "rest": [x]})
    assert timer._steps == 3 and timer.steps_per_sec > 0
    assert timer.pairs_per_sec == pytest.approx(4 * timer.steps_per_sec, rel=0.5)
    timer.reset()
    assert timer.steps_per_sec == 0.0
    from speechclip_plus_tpu_torch.utils import recorded, span
    from speechclip_plus_tpu_torch.utils.profiling import clear

    clear()
    with trace(str(tmp_path / "traces")):
        with span("double"):
            (x * 2).sum()
    files = os.listdir(tmp_path / "traces")
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.loads((tmp_path / "traces" / files[0]).read_text())["traceEvents"]
    assert any(e.get("name") == "double" for e in events)
    assert [s["name"] for s in recorded()] == ["double"]
