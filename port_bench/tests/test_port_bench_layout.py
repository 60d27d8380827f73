"""BENCHMARK.json against the benchmark's files and its contract; imports."""
import ast
import json
import os
import re
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)

from port_bench.run import applies, load_loop, load_reader, resolve_cell  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_cell_and_metric_resolves_by_name():
    bench = _bench()
    for cell in bench["workloads"]:
        _, c, cfg, mix, limits = resolve_cell(REPO, cell["name"])
        assert cfg["arch"] and cfg["yaml"] and limits
        loop = load_loop(REPO, mix["loop"])
        assert all(callable(getattr(loop, f)) for f in ("drive", "check", "control"))
    for m in bench["per_layer"]:
        assert callable(load_reader(REPO, m["name"]))


def test_a_new_entry_is_found_without_an_edit(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(REPO, "port_bench"), root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = _bench()
    pb = root / "port_bench"
    mix = json.loads((pb / "traffic" / "bulk_search.json").read_text())
    mix["batch"] = 8
    (pb / "traffic" / "small_search.json").write_text(json.dumps(mix))
    (pb / "limits" / "hp_base.small_search.json").write_text(
        json.dumps({"score_gap": 0.1, "rank_gap": 0.1}))
    (pb / "metrics" / "batches.search.py").write_text(
        "def read(ctx):\n    return ctx['out']['steps']\n")
    (pb / "loops" / "replay.py").write_text(
        "def drive(run, profiler=None):\n    run.out['replays_per_s'] = 1.0\n")
    bench["workloads"].append({"name": "hp_base.small_search", "config": "hp_base",
                               "traffic": "small_search", "chips": 1, "why": "a new cell"})
    bench["per_layer"].append({"name": "batches.search", "unit": "batches", "better": "higher",
                               "source": "host_clock", "layer": "serving",
                               "moves": "utterances_per_s",
                               "workloads": ["hp_base.small_search"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    _, cell, cfg, got, limits = resolve_cell(str(root), "hp_base.small_search")
    assert got["batch"] == 8 and limits["rank_gap"] == 0.1
    assert load_reader(str(root), "batches.search")({"out": {"steps": 3}}) == 3
    # a metric of a family takes the family's reader where it has none of its own
    family = load_reader(str(root), "peak_gib.replay").__code__.co_filename
    assert os.path.basename(family) == "peak_gib.py"
    run = type("Run", (), {"out": {}})()
    load_loop(str(root), "replay").drive(run)
    assert run.out == {"replays_per_s": 1.0}
    assert applies(bench["per_layer"][-1], "hp_base.small_search")
    assert not applies(bench["per_layer"][-1], "hp_base.search")


def test_benchmark_json_keeps_to_the_schema():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("port_bench/")
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    cells = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["name"] not in names
        names.add(m["name"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") or "_roofline." in m["name"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def _py_files(top):
    for d, _, files in os.walk(top):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_module_imports_jax_and_the_reference_imports_no_program():
    pb = os.path.join(REPO, "port_bench")
    for path in _py_files(pb):
        bad = set(_imports(path)) & {"jax", "jaxlib", "flax", "speechclip_plus_tpu"}
        assert not bad, (path, bad)
    for path in _py_files(os.path.join(pb, "reference")):
        assert "speechclip_plus_tpu_torch" not in set(_imports(path)), path


@pytest.mark.parametrize("mod", ["speechclip_plus_tpu_torch", "speechclip_plus_tpu_torch.x"])
def test_the_program_is_not_taken_for_the_jax_package(mod, monkeypatch):
    from port_bench import run

    monkeypatch.setitem(sys.modules, mod, sys)
    assert "speechclip_plus_tpu" not in run.forbidden_modules()
