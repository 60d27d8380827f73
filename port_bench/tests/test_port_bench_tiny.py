"""Whole runs of a tiny cell (`config/dev/tiny.yaml`): the reference agrees
with the program; the control and planted faults come out not correct."""
import argparse
import json
import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)
sys.path.insert(0, HERE)

import tiny_cell  # noqa: E402
from port_bench import run as R  # noqa: E402
from port_bench.lib.cell import Run  # noqa: E402
from port_bench.lib.check import judge  # noqa: E402

SEED = 2 ** 31 + 4321


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_cell.write_root(str(tmp_path_factory.mktemp("tiny")))


def _measure(root, cell, device="cpu", trace=0, seed=SEED):
    args = argparse.Namespace(workload=cell, seed=seed, seconds=0.5, trace=trace)
    return R.measure(root, args, device, say=lambda s: None)


def _schema(result):
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(result)


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.search", "tiny_cas.search"])
def test_the_reference_agrees_with_the_program(root, cell):
    result = _measure(root, cell)
    _schema(result)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert "setup_s" in result["metrics"]
    # where the timed path chose keyword codes, the reference took them
    keywords = cell != "tiny.search"
    assert ("kw_gap" in result["checks"]) == keywords
    if keywords:
        assert result["checks"]["kw_gap"]["value"] == 0.0


@pytest.mark.parametrize("cell", ["tiny.train", "tiny_cas.search"])
def test_the_control_is_not_correct(root, cell):
    _, _, cfg, mix, limits = R.resolve_cell(root, cell)
    run = Run(cfg, mix, SEED, 0.0, "cpu")
    run.build(meta=True)
    lines = []
    R.load_loop(root, mix["loop"]).control(run, lines.append)
    kinds = {line.pop("kind"): line for line in lines}
    for kind, line in kinds.items():
        line.pop("worst", None)
        correct, table = judge(line, limits)
        assert not correct, (kind, table)


def _half_batch_loss(monkeypatch):
    from speechclip_plus_tpu_torch.models.kwclip import KWClip

    inner = KWClip.compute_loss

    def half(self, feats):
        b = feats["id"].shape[0] // 2
        return inner(self, {k: v[:b] if torch.is_tensor(v) and v.ndim else v
                            for k, v in feats.items()})

    monkeypatch.setattr(KWClip, "compute_loss", half)


def _unchanged_state(monkeypatch):
    from speechclip_plus_tpu_torch.optim.optimizer import Optimizer

    monkeypatch.setattr(Optimizer, "apply", lambda self, grads, step: None)


def _altered_answers(rows):
    def plant(monkeypatch):
        from speechclip_plus_tpu_torch.serving import PendingSearch

        inner = PendingSearch.result

        def altered(self):
            ids, scores = inner(self)
            ids, scores = rows(ids.copy(), scores.copy())
            return ids, scores

        monkeypatch.setattr(PendingSearch, "result", altered)
    return plant


def _first_answer(ids, scores):  # each query's first answer replaced by its last
    ids[:, 0] = ids[:, -1]
    return ids, scores


def _half_batch_answers(ids, scores):  # the second half given the first half's answers
    h = ids.shape[0] // 2
    ids[h: 2 * h], scores[h: 2 * h] = ids[:h], scores[:h]
    return ids, scores


def _keyword_code(pick):
    """K3 returns another code, with its keyword, for the first keyword of
    each call: `pick(cosines, masked ids)` chooses it."""
    def plant(monkeypatch):
        from speechclip_plus_tpu_torch.models.branches import SimpleVectorQuantizer

        inner = SimpleVectorQuantizer.forward

        def forward(self, xn, emb, *a, **k):
            res = inner(self, xn, emb, *a, **k)
            t = res["targets"].clone()
            en = emb / emb.norm(dim=-1, keepdim=True)
            code = pick(xn[0, 0].float() @ en.T, tiny_cell.TINY_ARCH["vq"]["masked_ids"])
            kw = res["keywords"]
            move = torch.zeros_like(kw)
            move[0, 0] = (emb[code] - emb[t[0, 0, 0]]).to(kw.dtype)
            t[0, 0, 0] = code
            res["targets"], res["keywords"] = t, kw + move
            return res

        monkeypatch.setattr(SimpleVectorQuantizer, "forward", forward)
    return plant


def _worst_code(cos, masked):
    cos = cos.clone()
    cos[list(masked)] = float("inf")
    return int(cos.argmin())


def _masked_code(cos, masked):
    return int(masked[0])


@pytest.mark.parametrize("cell, fault", [
    ("tiny.train", _unchanged_state), ("tiny.train", _half_batch_loss),
    ("tiny.train", _keyword_code(_worst_code)), ("tiny.train", _keyword_code(_masked_code)),
    ("tiny.search", _altered_answers(_first_answer)),
    ("tiny.search", _altered_answers(_half_batch_answers)),
    ("tiny_cas.search", _altered_answers(_first_answer)),
    ("tiny_cas.search", _altered_answers(_half_batch_answers)),
    ("tiny_cas.search", _keyword_code(_worst_code)),
    ("tiny_cas.search", _keyword_code(_masked_code))])
def test_a_broken_timed_path_is_not_correct(root, cell, fault, monkeypatch):
    fault(monkeypatch)
    result = _measure(root, cell)
    assert not result["correct"], result["checks"]


@pytest.fixture
def card(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return tiny_cell.write_root(str(tmp_path_factory.mktemp("card")), tiny_cell.CARD_ARCH,
                                tiny_cell.CARD_YAML, tiny_cell.CARD_LIMITS)


@pytest.mark.parametrize("cell", ["tiny.train", "tiny_cas.search"])
def test_the_card_sized_cell_runs_here(tmp_path, cell):
    root = tiny_cell.write_root(str(tmp_path), tiny_cell.CARD_ARCH, tiny_cell.CARD_YAML,
                                tiny_cell.CARD_LIMITS)
    result = _measure(root, cell)
    assert result["correct"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny.train", "tiny_cas.search"])
def test_a_traced_run_on_the_card(card, cell):
    result = _measure(card, cell, "cuda:0", trace=1)
    print(cell, json.dumps(result["checks"]), json.dumps(result["breakdown"]["idle_gaps"][:3]))
    _schema(result)
    assert result["correct"], result["checks"]
    assert result["device"]["busy_s"] > 0 and result["breakdown"]["device_ops"]
