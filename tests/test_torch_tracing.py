"""The port's tracer (`utils/profiling.py`: `span`, `backward_span`,
`recorded`) and the benchmark's readers of its spans
(`port_bench/metrics/<family>.py`, `_spans.py`).

On the CPU, at `config/dev/tiny.yaml`:

- with no profiler recording, a span site records nothing and creates no
  CUDA event, grad hook or `record_function`; the buffer is bounded and
  counts the spans it drops;
- under a CPU-activity `torch.profiler`, one `Trainer.fit` micro-step records
  the tree of spans (names, parents, the micro-step id) with the backward
  spans on the thread that runs the backward, and a `search_stream` of two
  batches gives each request's `serve.submit` ... `serve.d2h` one id;
- each reader's arithmetic on hand-made span lists: per-unit division,
  incomplete units dropped, the backward spans' overlap, self time, the
  lead, synchronising calls by span, and serving's gap attribution.

On the card (`cuda`, skipped here): a CUDA-only profiler turns the tracer on,
a span's device edges bracket a kernel's interval in the exported trace
within 50 us on the shared clock, and an `.item()` counts one synchronising
call in its span and none in the parent.
"""
import copy
import json
import os
import sys
import tempfile
import threading

import numpy as np
import pytest
import torch

import speechclip_plus_tpu_torch.api as port_api
from speechclip_plus_tpu_torch.api import SpeechCLIP
from speechclip_plus_tpu_torch.config import load_config
from speechclip_plus_tpu_torch.serving import SpeechRetriever, build_image_index
from speechclip_plus_tpu_torch.tasks.builder import build_model_from_config
from speechclip_plus_tpu_torch.tasks.trainer import Trainer
from speechclip_plus_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "config", "dev", "tiny.yaml")
CROP = 1280
if REPO not in sys.path:
    sys.path.insert(0, REPO)


@pytest.fixture(scope="module")
def tiny():
    cfg = load_config(TINY)
    cfg.audio_encoder.max_audio_len = CROP
    cfg.trainer.max_steps = 1
    model, _, _ = build_model_from_config(cfg, device="cpu", seed=0)
    return cfg, model


def _batch(model, b=4, seed=0):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        width = model.encode_image_raw(torch.zeros(1, 32, 32, 3)).shape[-1]
    return {"wav": rng.standard_normal((b, CROP)).astype(np.float32),
            "wav_len": np.array([CROP, CROP - 100, CROP - 300, CROP][:b], np.int32),
            "id": np.arange(b, dtype=np.int32), "valid": np.ones(b, bool),
            "image_feat": rng.standard_normal((b, width)).astype(np.float32)}


def _fit_once(cfg, model, batch):
    with tempfile.TemporaryDirectory() as save:
        trainer = Trainer(copy.deepcopy(model), cfg, save, seed=3)
        trainer.fit([batch])
        return trainer


@pytest.fixture
def short_buckets(monkeypatch):
    """One 4000-sample serving bucket: the tiny tower keeps a frame per 4
    samples, so the first real bucket (16000) would give it 4000 frames."""
    monkeypatch.setattr(port_api._pad_wavs, "__defaults__", ((4000,),))


def _search(model, batches):
    sc = SpeechCLIP(model, "cpu")
    images = np.random.default_rng(1).standard_normal((6, 32, 32, 3)).astype(np.float32)
    retriever = SpeechRetriever(sc, build_image_index(sc, images, list(range(6))))
    return list(retriever.search_stream(batches, k=3, depth=2))


def _wavs(seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(int(rng.integers(2000, 4000))).astype(np.float32)
            for _ in range(n)]


def test_spans_record_nothing_without_a_profiler(tiny, short_buckets, monkeypatch):
    cfg, model = tiny

    def refuse(*a, **k):
        raise AssertionError("the tracer did work while off")

    profiling.clear()
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.graph, "register_multi_grad_hook", refuse)
    assert not torch.autograd._profiler_enabled()
    _fit_once(cfg, model, _batch(model))
    _search(model, [_wavs(0)])
    with profiling.span("outside", step=1):
        pass
    assert profiling.recorded() == [] and profiling.dropped() == 0


def _cpu_profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def test_the_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 2)
    profiling.clear()
    with _cpu_profiler():
        for i in range(3):
            with profiling.span("s", step=i):
                pass
    assert [s["step"] for s in profiling.recorded()] == [0, 1]
    assert profiling.dropped() == 1
    profiling.clear()
    assert profiling.recorded() == [] and profiling.dropped() == 0


def test_a_fit_micro_step_records_the_span_tree(tiny, monkeypatch):
    cfg, model = tiny
    backward_threads = set()
    compute_loss = type(model).compute_loss

    def probed(self, feats):
        losses = compute_loss(self, feats)
        losses["loss"].register_hook(lambda g: backward_threads.add(threading.get_ident()))
        return losses

    monkeypatch.setattr(type(model), "compute_loss", probed)
    profiling.clear()
    with _cpu_profiler():
        _fit_once(cfg, model, _batch(model))
    spans = profiling.recorded()
    by_id = {s["id"]: s for s in spans}
    parent = lambda s: None if s["parent"] is None else by_id[s["parent"]]["name"]
    tree = {}
    for s in spans:
        tree.setdefault(s["name"], set()).add(parent(s))
    want = {
        "fit.next_batch": {None}, "fit.h2d": {None}, "fit.step": {None}, "fit.log": {None},
        "step.forward": {"fit.step"}, "step.loss": {"fit.step"},
        "step.backward": {"fit.step"}, "step.optimizer": {"fit.step"},
        "tower": {"step.forward"}, "tower.frontend": {"tower"},
        "tower.frontend.layer0": {"tower.frontend"}, "tower.prenet": {"tower"},
        "tower.layer": {"tower"}, "tower.wsum": {"tower"},
        "branch": {"step.forward"}, "branch.cif": {"branch"}, "branch.kw_bn": {"branch"},
        "branch.vq": {"branch"}, "text": {"step.forward"},
        "tower.bwd": {"step.backward"}, "branch.bwd": {"step.backward"},
        "text.bwd": {"step.backward"}}
    assert tree == want
    n_layers = model.cfg.audio.n_layers
    assert sorted(s["attrs"]["layer"] for s in spans if s["name"] == "tower.layer") == \
        list(range(n_layers))
    assert sum(s["name"] == "tower.wsum" for s in spans) == n_layers + 1
    # the micro-step's spans carry its id; the loader's next call (the end
    # of the pass) comes after it
    assert {s["step"] for s in spans if s["name"] != "fit.next_batch"} == {0}
    assert [s["step"] for s in spans if s["name"] == "fit.next_batch"] == [0, 1]
    backward = by_id[next(s["id"] for s in spans if s["name"] == "step.backward")]
    for name in profiling_names("bwd", spans):
        s = next(x for x in spans if x["name"] == name)
        assert s["tid"] in backward_threads
        assert backward["host"][0] <= s["host"][0] <= s["host"][1] <= backward["host"][1]
    for s in spans:
        assert s["host"][0] <= s["host"][1] and s["device"] is None and s["syncs"] == 0


def profiling_names(suffix, spans):
    return sorted({s["name"] for s in spans if s["name"].endswith("." + suffix)})


def test_a_search_stream_shares_one_request_id_per_batch(tiny, short_buckets):
    _, model = tiny
    profiling.clear()
    with _cpu_profiler():
        answers = _search(model, [_wavs(0), _wavs(1)])
    assert len(answers) == 2
    spans = profiling.recorded()
    by_request = {}
    for s in spans:
        by_request.setdefault(s["request"], []).append(s)
    assert None not in by_request and len(by_request) == 2
    by_id = {s["id"]: s for s in spans}
    for group in by_request.values():
        names = sorted(s["name"] for s in group)
        assert {"serve.submit", "serve.pad", "serve.copy", "serve.encode", "serve.score",
                "serve.wait", "serve.d2h", "tower", "branch"} <= set(names)
        assert names.count("serve.submit") == names.count("serve.d2h") == 1
        for s in group:
            if s["name"] in ("serve.pad", "serve.copy", "serve.encode", "serve.score"):
                assert by_id[s["parent"]]["name"] == "serve.submit"
            if s["name"] in ("serve.submit", "serve.wait", "serve.d2h"):
                assert s["parent"] is None


# ----------------------------------------------------------------- readers --

def _reader(name):
    from port_bench.run import load_reader

    return load_reader(REPO, name)


class _Timeline:
    def __init__(self, busy_s):
        self.busy = busy_s

    def busy_s(self):
        return self.busy


def _ctx(metric, lines, busy_s=1.0, steps=2):
    return {"metric": metric, "timeline": _Timeline(busy_s), "trace_steps": steps,
            "device_name": "NVIDIA H100 80GB HBM3", "say": lines.append}


class _Spans:
    """Hand-made spans, times in ms."""

    def __init__(self):
        self.spans = []

    def add(self, name, host, device=None, parent=None, step=None, request=None, syncs=0,
            tid=1):
        ms = lambda iv: None if iv is None else tuple(int(round(t * 1e6)) for t in iv)
        s = {"name": name, "id": len(self.spans), "tid": tid,
             "parent": None if parent is None else parent["id"],
             "step": step if step is not None or parent is None else parent["step"],
             "request": request if request is not None or parent is None
             else parent["request"],
             "host": ms(host), "device": ms(device), "syncs": syncs, "attrs": {}}
        self.spans.append(s)
        return s


def _read(monkeypatch, spans, metric, **kw):
    monkeypatch.setattr(profiling, "recorded", lambda: spans)
    lines = []
    return _reader(metric)(_ctx(metric, lines, **kw)), lines


def _train_spans():
    S = _Spans()
    for step, (t, tower, bwd, lead) in enumerate([(0, 10, 4, 30), (200, 20, 6, 10)]):
        fit = S.add("fit.step", (t, t + 100), (t + 1, t + 100 + lead), step=step, syncs=1)
        fwd = S.add("step.forward", (t + 1, t + 40), (t + 2, t + 50), fit, syncs=2)
        S.add("tower", (t + 2, t + 30), (t + 3, t + 3 + tower), fwd, syncs=1)
        S.add("branch", (t + 30, t + 39), (t + 20, t + 28), fwd)
        S.add("text", (t + 39, t + 40), (t + 28, t + 30), fwd)
        back = S.add("step.backward", (t + 41, t + 80), (t + 50, t + 90), fit)
        # the branch's backward opens first; the text tower's opens inside it
        S.add("branch.bwd", (t + 42, t + 70), (t + 50, t + 60), back, tid=2)
        S.add("text.bwd", (t + 43, t + 50), (t + 52, t + 55), back, tid=2)
        S.add("tower.bwd", (t + 71, t + 79), (t + 60, t + 60 + bwd), back, tid=2)
        S.add("step.optimizer", (t + 80, t + 99), (t + 90, t + 97), fit)
        S.add("fit.h2d", (t - 5, t), (t - 4, t + 1), step=step)
    # a step whose `fit.step` was not recorded whole: dropped
    S.add("tower", (400, 410), (400, 500), step=2)
    S.add("fit.log", (500, 501), (500, 501), step=2, syncs=3)
    return S.spans


def test_training_readers_divide_by_whole_steps(monkeypatch):
    spans = _train_spans()
    value, lines = _read(monkeypatch, spans, "tower_ms.train")
    assert value == pytest.approx(((10 + 4) + (20 + 6)) / 2)
    assert "units=2" in lines[0]
    # the text tower's backward (3 ms) is charged to it, not to the branch's
    assert _read(monkeypatch, spans, "branch_ms.train")[0] == pytest.approx(8 + (10 - 3))
    assert _read(monkeypatch, spans, "text_ms.train")[0] == pytest.approx(2 + 3)
    assert _read(monkeypatch, spans, "optim_ms.train")[0] == pytest.approx(7)
    # syncs under fit.step only: 1 + 2 + 1 a step; fit.log's are around it
    value, lines = _read(monkeypatch, spans, "host_syncs.train")
    assert value == pytest.approx(4)
    assert "'fit.log': 3" in lines[0]


def test_the_lead_and_the_coverage(monkeypatch):
    spans = _train_spans()
    S = _Spans()
    S.spans = list(spans)
    fit = S.add("fit.step", (400, 500), (401, 520), step=3)
    S.add("fit.h2d", (395, 400), (396, 401), step=3)
    # leads 30, 10, 20: the median
    value, lines = _read(monkeypatch, S.spans, "step_lead_ms.train", busy_s=0.3, steps=3)
    assert value == pytest.approx(20)
    assert fit["device"][1] - fit["host"][1] == 20 * 10 ** 6
    # fit.step and fit.h2d: (129 + 5) + (109 + 5) + (119 + 5) over 3, against 100 busy
    assert "coverage_pct=124.00" in lines[0]


def test_self_time_less_children_and_backward_overlap():
    from port_bench.metrics import _spans as S

    spans = _train_spans()
    groups = S.steps(spans)
    assert sorted(groups) == [0, 1]
    g = groups[0]
    back = S.one(g, "step.backward")
    # the backward's device (50, 90) less its children's union (50, 64)
    assert S.self_ms(back, g, "device") == pytest.approx(26)
    assert S.self_ms(back, g, "host") == pytest.approx(39 - (28 + 8))
    fwd = S.one(g, "step.forward")
    assert S.self_ms(fwd, g, "device") == pytest.approx(48 - (10 + 8 + 2))
    assert S.dev_ms(S.one(g, "branch.bwd"), g) == pytest.approx(7)
    assert S.dev_ms(S.one(g, "text.bwd"), g) == pytest.approx(3)
    table = S.table(groups, ("tower",))
    assert table == "tower=28.0000/28.0000,15.0000/15.0000(1)"


def _serve_spans():
    """Requests 4 (its submit not recorded), 5 and 6, the stream as the
    program runs it: request 6 is submitted after request 5's answer is
    copied back."""
    S = _Spans()
    S.add("serve.d2h", (0, 1), (0, 1), request=4)
    sub = S.add("serve.submit", (1, 6), (1.5, 20), request=5)
    S.add("serve.pad", (1, 2), (1.5, 2), sub)
    S.add("serve.copy", (2, 3), (2, 4), sub)
    enc = S.add("serve.encode", (3, 5), (4, 18), sub)
    S.add("tower", (3, 4), (4, 15), enc)
    S.add("serve.score", (5, 6), (18, 20), sub)
    S.add("serve.wait", (15, 16), (19, 19.5), request=5)
    S.add("serve.d2h", (16, 24), (20, 21), request=5)
    sub = S.add("serve.submit", (25, 33), (25, 50), request=6)
    S.add("serve.pad", (25, 28), (25, 28), sub)
    S.add("serve.copy", (28, 31), (28, 33), sub)
    enc = S.add("serve.encode", (31, 32), (33, 48), sub)
    S.add("tower", (31, 32), (33, 45), enc)
    S.add("serve.score", (32, 33), (48, 50), sub)
    S.add("serve.wait", (34, 35), (50, 51), request=6)
    S.add("serve.d2h", (35, 40), (51, 52), request=6)
    S.add("serve.wait", (41, 42), (52, 53), request=7)
    return S.spans


def test_serving_gaps_are_charged_to_the_host_spans_open_through_them(monkeypatch):
    spans = _serve_spans()
    # the gap runs from request 5's top-k (20) to request 6's copy (31): d2h
    # 20-24, outside any span 24-25, pad 25-28, copy 28-31
    value, lines = _read(monkeypatch, spans, "idle_host_ms.search")
    assert value == pytest.approx(4 + 3 + 3)
    assert "pairs=1" in lines[0] and "'outside': 1.0" in lines[0]
    assert _read(monkeypatch, spans, "pad_ms.search")[0] == pytest.approx((1 + 1 + 3 + 3) / 2)
    assert _read(monkeypatch, spans, "tower_ms.search")[0] == pytest.approx((11 + 12) / 2)
    # no text span in these requests: no value
    assert _read(monkeypatch, spans, "text_ms.search")[0] is None


def test_readers_read_nothing_off_the_card_or_without_spans(monkeypatch):
    lines = []
    for metric in ("tower_ms.train", "idle_host_ms.search", "host_syncs.train"):
        monkeypatch.setattr(profiling, "recorded", _train_spans)
        ctx = dict(_ctx(metric, lines), device_name="cpu")
        assert _reader(metric)(ctx) is None
        monkeypatch.setattr(profiling, "recorded", lambda: [])
        assert _reader(metric)(_ctx(metric, lines)) is None
    assert lines == []


# ---------------------------------------------------------------- the card --

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cuda_profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])


@pytest.mark.cuda
def test_a_cuda_only_profiler_turns_the_tracer_on(cuda_device):
    profiling.clear()
    x = torch.randn(256, 256, device=cuda_device)
    with _cuda_profiler():
        with profiling.span("outer", request=7):
            y = x @ x
    assert torch.cuda.get_sync_debug_mode() == 1  # until the session is settled
    spans = profiling.recorded()
    assert torch.cuda.get_sync_debug_mode() == 0
    assert [(s["name"], s["request"]) for s in spans] == [("outer", 7)]
    d0, d1 = spans[0]["device"]
    assert d0 <= d1 and y.shape == (256, 256)


@pytest.mark.cuda
def test_a_spans_device_edges_bracket_its_kernel(cuda_device):
    profiling.clear()
    x = torch.randn(8192, 8192, device=cuda_device)
    x @ x
    torch.cuda.synchronize()
    with _cuda_profiler() as prof:
        with profiling.span("anchor"):  # the recording's first span synchronises
            pass
        # a product queued ahead keeps the card busy, so the span's start edge
        # is where that product ends and its own begins, not the host's
        # launch time on an idle card
        x @ x
        with profiling.span("matmul"):
            x @ x
        torch.cuda.synchronize()
    span = profiling.recorded()[-1]
    assert span["name"] == "matmul"
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    base = int(data["baseTimeNanoseconds"])
    kernels = sorted((base + float(e["ts"]) * 1e3, base + (float(e["ts"]) + float(e["dur"])) * 1e3)
                     for e in data["traceEvents"] if e.get("cat") == "kernel")
    assert len(kernels) == 2
    (_, ahead), (k0, k1) = kernels
    d0, d1 = span["device"]
    print(f"span {d0} {d1} kernel {k0:.0f} {k1:.0f} edges (us) {(k0 - d0) / 1e3:.2f} "
          f"{(d1 - k1) / 1e3:.2f} kernel_ms {(k1 - k0) / 1e6:.4f} idle_before_us "
          f"{(k0 - ahead) / 1e3:.2f}")
    assert abs(k0 - d0) <= 50e3 and abs(d1 - k1) <= 50e3


@pytest.mark.cuda
def test_an_item_counts_one_sync_in_its_span_and_none_in_the_parent(cuda_device):
    profiling.clear()
    x = torch.randn(64, device=cuda_device)
    with _cuda_profiler():
        with profiling.span("parent"):
            x * 2
            with profiling.span("child"):
                x.sum().item()
    syncs = {s["name"]: s["syncs"] for s in profiling.recorded()}
    assert syncs == {"parent": 0, "child": 1}
