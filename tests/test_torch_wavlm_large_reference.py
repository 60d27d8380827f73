"""WavLM-Large's structure under the hybrid+ branch against the benchmark's
plain reference (`port_bench/reference/wavlm.py`), on the CPU at a tiny width.

The tiny tower has WavLM-Large's structure: the layer-norm frontend with a
bias on every conv (`conv_bias`, as `HubertConfig.wavlm_large` resolves it),
pre-norm layers, the gated relative position bias at WavLM's 320 buckets up
to distance 800, and the hybrid+ branch with a keyword projection MLP and
`accumulate_grad_batches: 2`, as `config/speechclip_plus/large/flickr/
hybrid_plus_wavlm.yaml` has them. The port runs its plain twins here and the
reference its float32 arithmetic, so the limits (`LIMITS`) are rounding
limits: 1e-4 on the loss, the tower's feature, layer 0's attention output
and the serving feature (float32 sums in another order over a few hundred
terms), 1e-3 on the gradient norms, 5e-3 on the step norms (the branch's
`in_proj_bias` holds the key bias, whose gradient is zero in exact
arithmetic: Adam moves it by rounding noise, 1.7e-3 over three optimizer
steps of two micro-steps). A planted "gate off" (every gate 1) or
"bias off" (no relative bias) in the program fails them.

Also: the reference's bucketing equals the program's at every length up to
400; the tracer's `tower.relpos` and `tower.gate` spans and K1's gated-call
counter appear on a WavLM tower and never on HuBERT's; and the four-card
cell's loop (`port_bench/loops/train_dp.py`) under gloo on the CPU trains
as one process over the global batch, and its control and faults (the
exchange between the ranks left out among them) fail its limits.
"""
import argparse
import dataclasses
import json
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (REPO, os.path.join(REPO, "port_bench", "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)

import tiny_cell  # noqa: E402
from port_bench import run as R  # noqa: E402
from port_bench.lib.cell import Run, no_tf32  # noqa: E402
from port_bench.reference.model import Prec  # noqa: E402
from port_bench.reference.wavlm import WavLM, buckets  # noqa: E402
from speechclip_plus_tpu_torch.models import hubert as H  # noqa: E402
from speechclip_plus_tpu_torch.nn import fused_attention_block as FAB  # noqa: E402
from speechclip_plus_tpu_torch.utils import profiling  # noqa: E402

SEED = 2 ** 31 + 2323
CELL = "tiny_wavlm.train"
LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "step_gap": 5e-3, "kw_gap": 1e-4, "tower_gap": 1e-4,
          "attn0_gap": 1e-4}
FEATURE_LIMIT = 1e-4

# WavLM-Large's structure at a tiny width (`HubertConfig.wavlm_large` but the sizes),
# downsampling by 8: a 0.2-s crop is 399 frames, distances past the exact buckets
CONV = ((16, 3, 2), (16, 3, 2), (16, 2, 2))
TOWER = dict(extractor_mode="layer_norm", conv_bias=True, layer_norm_first=True,
             rel_pos_bias=True, rel_buckets=320, rel_max_distance=800)
ARCH = {**tiny_cell.TINY_ARCH,
        "audio": {**tiny_cell.TINY_ARCH["audio"], "name": "tiny_wavlm",
                  "conv_layers": [list(c) for c in CONV], "downsample_rate": 8,
                  "extractor_mode": "layer_norm", "layer_norm_first": True,
                  "rel_pos_bias": True, "rel_buckets": 320, "rel_max_distance": 800},
        "branch": {**tiny_cell.TINY_ARCH["branch"], "kw_projection_dropout": 0.1},
        "cascaded_weight": 1.5, "parallel_weight": 0.5, "retrieval_feat": "cascaded"}


def _tiny_wavlm(**kw):
    return dataclasses.replace(H.HubertConfig(
        conv_layers=CONV, d_model=32, n_layers=2, n_heads=4, ffn_dim=64,
        conv_pos=16, conv_pos_groups=2), **{**TOWER, **kw})


@pytest.fixture
def wavlm_tiny(monkeypatch):
    """`audio_encoder.tiny` builds the WavLM-structured tower; the harness's
    check for JAX in its process is left out (this test process has it)."""
    monkeypatch.setattr(H.HubertConfig, "tiny", staticmethod(lambda **kw: _tiny_wavlm()))
    monkeypatch.setattr(R, "forbidden_modules", lambda: [])


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny_cell.write_root(str(tmp_path_factory.mktemp("tiny_wavlm")))
    pb = os.path.join(root, "port_bench")
    with open(os.path.join(pb, "configs", "tiny.json")) as f:
        y = json.load(f)["yaml"]
    y["trainer"]["accumulate_grad_batches"] = 2
    y["model_settings"]["cascaded_objective_weight"] = 1.5
    y["model_settings"]["parallel_objective_weight"] = 0.5
    y["retrieval"]["audio_feat_src"] = "cascaded"
    y["model_settings"]["cascaded_branch"]["keyword"]["kw_projection"] = {
        "dropout": 0.1, "dimensions": [32, 32, 32]}
    with open(os.path.join(pb, "configs", "tiny_wavlm.json"), "w") as f:
        json.dump({"source": "test", "yaml": y, "arch": ARCH}, f)
    mix = dict(tiny_cell.MIXES["train_tiny"], loop="train_relpos")
    with open(os.path.join(pb, "traffic", "train_tiny_relpos.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(pb, "limits", CELL + ".json"), "w") as f:
        json.dump(LIMITS, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny_wavlm", "source": "test",
                             "file": "port_bench/configs/tiny_wavlm.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "tiny_wavlm",
                               "traffic": "train_tiny_relpos", "chips": 1, "why": "t"})
    with open(path, "w") as f:
        json.dump(bench, f)
    return root


def _measure(root):
    args = argparse.Namespace(workload=CELL, seed=SEED, seconds=0.3, trace=0)
    return R.measure(root, args, "cpu", say=lambda s: None)


def _gate_off(monkeypatch):
    monkeypatch.setattr(H.HubertEncoderLayer, "rel_pos_gate",
                        lambda self, x: x.new_ones(x.shape[0], self.cfg.n_heads, x.shape[1],
                                                   dtype=torch.float32))


def _bias_off(monkeypatch):
    inner = H.HubertModel.position_bias
    monkeypatch.setattr(H.HubertModel, "position_bias",
                        lambda self, t: None if inner(self, t) is None
                        else torch.zeros_like(inner(self, t)))


def _serving_gap(root):
    """Widest gap of the program's cascaded serving feature from the
    reference's, over the reference's norm, on a ragged batch."""
    _, _, cfg, mix, _ = R.resolve_cell(root, CELL)
    run = Run(cfg, mix, SEED, 0.0, "cpu")
    run.build()
    gen = torch.Generator().manual_seed(SEED % 2 ** 31)
    crop = int(cfg["yaml"]["audio_encoder"]["max_audio_len"])
    wav = torch.randn(4, crop, generator=gen)
    lens = torch.tensor([crop, crop - 333, crop // 2, crop - 1000])
    wav[torch.arange(crop)[None] >= lens[:, None]] = 0.0
    with torch.no_grad():
        prog = run.model.encode_speech(wav, lens)["cascaded_audio_feat"].float()
    ref_w = {n: t.float() for n, t in run.model.state_dict().items()}
    with no_tf32(), torch.no_grad():
        ref = WavLM(ref_w, cfg["arch"], Prec("fp32")).retrieval_feature(wav, lens)
    return float((prog - ref).abs().max() / ref.norm(dim=-1).max())


def test_the_reference_agrees_with_the_program(root, wavlm_tiny):
    result = _measure(root)
    assert result["correct"], result["checks"]
    assert result["checks"]["kw_gap"]["value"] == 0.0
    assert _serving_gap(root) <= FEATURE_LIMIT


@pytest.mark.parametrize("fault", [_gate_off, _bias_off], ids=["gate_off", "bias_off"])
def test_a_planted_tower_fault_is_not_correct(root, wavlm_tiny, monkeypatch, fault):
    fault(monkeypatch)
    result = _measure(root)
    assert not result["correct"], result["checks"]
    assert result["checks"]["tower_gap"]["value"] > LIMITS["tower_gap"]
    assert result["checks"]["attn0_gap"]["value"] > LIMITS["attn0_gap"]
    assert _serving_gap(root) > FEATURE_LIMIT


@pytest.mark.parametrize("buckets_, distance", [(320, 800), (32, 128)])
def test_the_references_buckets_equal_the_programs(buckets_, distance):
    for t in range(1, 401):
        assert torch.equal(buckets(t, buckets_, distance),
                           H.relative_position_buckets(t, buckets_, distance)), t


def _record(tower, t=400):
    gen = torch.Generator().manual_seed(0)
    wav = torch.randn(2, t, generator=gen)
    profiling.clear()
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        tower(wav, torch.zeros(2, t, dtype=torch.bool), None)
    names = [s["name"] for s in profiling.recorded()]
    by_id = {s["id"]: s["name"] for s in profiling.recorded()}
    parents = {by_id.get(s["parent"]) for s in profiling.recorded()
               if s["name"] == "tower.gate"}
    profiling.clear()
    return names, parents


@pytest.mark.parametrize("wavlm", [True, False], ids=["wavlm", "hubert"])
def test_the_relpos_spans(wavlm):
    cfg = _tiny_wavlm(rel_pos_bias=wavlm, n_layers=3)
    names, parents = _record(H.HubertModel(cfg).eval())
    assert names.count("tower.layer") == 3
    assert names.count("tower.relpos") == (1 if wavlm else 0)
    assert names.count("tower.gate") == (3 if wavlm else 0)
    assert parents == ({"tower.layer"} if wavlm else set())


def _cpu_attention(qkv, kb, n_heads, dtype, seeds, keep_prob, ab, gate, return_lse,
                   head_offset=0, total_heads=None):
    """K1b on the CPU: softmax(q kᵀ + key bias + gate · bias) v."""
    b, t, d3 = qkv.shape
    q, k, v = (a.reshape(b, t, n_heads, -1).transpose(1, 2) for a in qkv.split(d3 // 3, -1))
    s = q @ k.transpose(-1, -2) + kb[:, None, None, :]
    if ab is not None:
        s = s + (ab[None] if gate is None else gate[..., None] * ab[None])
    ctx = torch.softmax(s, -1) @ v
    return ctx.transpose(1, 2).reshape(b, t, -1).to(dtype), None


@pytest.mark.parametrize("wavlm", [True, False], ids=["wavlm_large", "hubert_large"])
def test_the_gated_k1_counter(monkeypatch, wavlm):
    """K1's wrapper with its kernel swapped for a CPU twin: a forward of a
    24-layer large-structured tower at dh=64 counts 24 gated calls (WavLM)
    and none (HuBERT), beside 24 calls either way."""
    monkeypatch.setattr(FAB, "_run", FAB._launch)
    monkeypatch.setattr(FAB, "_attention", _cpu_attention)
    cfg = _tiny_wavlm(rel_pos_bias=wavlm, n_layers=24, d_model=128, n_heads=2, ffn_dim=128,
                      conv_pos_groups=4)
    assert cfg.rel_pos_bias == wavlm and cfg.fused_attention_block
    tower = H.HubertModel(cfg).eval()
    before = FAB.LAUNCHES, FAB.GATE_LAUNCHES
    with torch.no_grad():
        tower(torch.randn(2, 200), torch.zeros(2, 200, dtype=torch.bool), None)
    assert FAB.LAUNCHES - before[0] == 24
    assert FAB.GATE_LAUNCHES - before[1] == (24 if wavlm else 0)


DP_CELL = "tiny.train_dp4"


@pytest.fixture(scope="module")
def dp_root(tmp_path_factory):
    root = tiny_cell.write_root(str(tmp_path_factory.mktemp("tiny_dp")),
                                yaml_overrides={"data.batch_size": 8})
    pb = os.path.join(root, "port_bench")
    # 0.1-s crops: 399 frames a row
    mix = dict(tiny_cell.MIXES["train_tiny"], loop="train_dp", ranks=4, max_s=0.1, crop=1600)
    with open(os.path.join(pb, "traffic", "train_tiny_dp4.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(pb, "limits", DP_CELL + ".json"), "w") as f:
        json.dump(tiny_cell.LOOSE["tiny.train"], f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": DP_CELL, "config": "tiny", "traffic": "train_tiny_dp4",
                               "chips": 4, "why": "t"})
    with open(path, "w") as f:
        json.dump(bench, f)
    return root


def test_the_data_parallel_loop_trains_the_global_batch(dp_root, monkeypatch):
    """Four gloo ranks of `loops/train_dp.py` on the CPU, each training 2 of
    the 8 rows of every global batch: rank 0's first steps equal the
    one-process reference over the global batch (each rank's rows with its
    own dropout stream) within `tiny_cell.LOOSE`'s rounding limits."""
    monkeypatch.setattr(R, "forbidden_modules", lambda: [])
    args = argparse.Namespace(workload=DP_CELL, seed=SEED, seconds=0.5, trace=0)
    result = R.measure(dp_root, args, "cpu", say=lambda s: None)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and "setup_s" in result["metrics"]
    assert not torch.distributed.is_initialized()


def test_the_data_parallel_control_and_faults_are_not_correct(dp_root):
    """The four-rank cell's control (the float8 reference), "half" and
    "noexchange" (rank 0's rows, keyword statistics, loss and gradient alone,
    as if no collective ran) each fail the cell's limits."""
    from port_bench.lib.check import judge

    _, _, cfg, mix, limits = R.resolve_cell(dp_root, DP_CELL)
    run = Run(cfg, mix, SEED, 0.0, "cpu")
    run.build(meta=True)
    lines = []
    R.load_loop(dp_root, mix["loop"]).control(run, lines.append)
    kinds = {line.pop("kind"): line for line in lines}
    assert set(kinds) == {"fp8", "half", "noexchange"}
    for kind, line in kinds.items():
        line.pop("worst", None)
        correct, table = judge(line, limits)
        assert not correct, (kind, table)
