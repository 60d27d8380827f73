"""Traffic, rooflines, the frozen FLOP count and the trace's idle share."""
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)

from port_bench.lib import roofline as R  # noqa: E402
from port_bench.lib import traffic as T  # noqa: E402
from port_bench.lib.flops import train_step_flops  # noqa: E402
from port_bench.lib.trace import HostRanges, Timeline  # noqa: E402
from port_bench.run import resolve_cell  # noqa: E402

H100 = R.peak("NVIDIA H100 80GB HBM3")


def _mix(cell):
    _, _, cfg, mix, _ = resolve_cell(REPO, cell)
    mix = T.resolve(mix, cfg["yaml"])
    mix.update(batch=4, distinct=2)
    return mix


def test_train_traffic_repeats_for_a_seed_and_differs_for_another():
    mix = _mix("hp_base.train")
    a, b = T.train_batches(mix, 2 ** 31 + 7, "cpu"), T.train_batches(mix, 2 ** 31 + 7, "cpu")
    c = T.train_batches(mix, 2 ** 31 + 8, "cpu")
    for x, y in zip(a, b):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    assert not np.array_equal(a[0]["wav"], c[0]["wav"])
    assert not np.array_equal(a[0]["wav_len"], c[0]["wav_len"])
    lens = a[0]["wav_len"]
    assert lens.max() <= 102400 and lens.min() >= 32000
    assert not a[0]["wav"][0, lens[0]:].any()


def test_search_traffic_repeats_for_a_seed_and_differs_for_another():
    mix = _mix("hp_base.search")
    a, b = T.search_batches(mix, 12, "cpu"), T.search_batches(mix, 12, "cpu")
    c = T.search_batches(mix, 13, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a[0], b[0]))
    assert [len(w) for w in a[0]] != [len(w) for w in c[0]]
    assert all(32000 <= len(w) <= 102400 for w in a[0])
    wav, lens = T.pad_batch(a[0])
    assert wav.shape[1] in T.BUCKETS and list(lens) == [len(w) for w in a[0]]


@pytest.mark.parametrize("call, want_ms", [
    (lambda: R.k3(9600, 512, 8112), 0.0806),
    (lambda: R.projection(40960, 2304, 768, out_bytes=4), 0.1466),
])
def test_roofline_matches_the_kernel_tables_bound_column(call, want_ms):
    flops, nbytes = call()
    got = R.least_s(flops, nbytes, H100) * 1e3
    assert abs(got - want_ms) / want_ms < 1e-3


@pytest.mark.parametrize("cell", ["hp_base.train", "cl_large.train"])
def test_frozen_flop_copy_equals_the_programs(cell):
    from speechclip_plus_tpu_torch.config import ConfigNode
    from speechclip_plus_tpu_torch.models.kwclip import KWClipConfig
    from speechclip_plus_tpu_torch.utils.flops import train_step_flops as program_flops

    _, _, cfg, _, _ = resolve_cell(REPO, cell)
    clip = cfg["arch"]["clip"]
    mcfg = KWClipConfig.from_config(ConfigNode(cfg["yaml"]), vocab_size=clip["vocab_size"],
                                    sot_id=clip["sot_id"], eot_id=clip["eot_id"])
    for cached in (True, False):
        assert train_step_flops(mcfg, 256, 102400, cached_image=cached) == \
            program_flops(mcfg, 256, 102400, cached_image=cached)


def _ev(ts, dur, name="k", cat="kernel"):
    return {"ph": "X", "ts": ts, "dur": dur, "name": name, "cat": cat}


def test_idle_share_and_gaps_of_hand_made_intervals():
    events = [_ev(0, 10), _ev(5, 10), _ev(30, 10, "copy", "gpu_memcpy"), _ev(70, 30),
              _ev(0, 5, "cpu op", "cpu_op")]
    tl = Timeline(events, host=[(12, 32, "train_step"), (0, 100, "next batch"),
                                (0, 100, "not a range of the benchmark")])
    assert tl.window_s() == pytest.approx(100e-6)
    assert tl.busy_s() == pytest.approx(55e-6)        # [0, 15] + [30, 40] + [70, 100]
    gaps = tl.idle_gaps(10)
    assert gaps[0] == ["next batch", pytest.approx(30e-6)]  # [40, 70]: train_step has ended
    assert gaps[1] == ["train_step", pytest.approx(15e-6)]  # [15, 30]: inside train_step
    assert tl.seconds_matching(["copy"]) == pytest.approx(10e-6)
    assert tl.top_ops(1) == [["k", pytest.approx(50e-6)]]  # overlaps count in full


def test_host_ranges_are_kept_on_the_wall_clock_once_on():
    import time

    ranges = HostRanges()
    with ranges("next batch"):
        pass
    assert ranges.spans == []
    ranges.on = True
    t0 = time.time_ns()
    with ranges("train_step"):
        pass
    (a, b, name), = ranges.spans
    assert name == "train_step" and t0 <= a <= b <= time.time_ns()


def test_per_call_counts():
    f, m = R.k1_fused_out(2, 3, 8, 2)
    assert f == 2 * 6 * 8 * 24 + 4 * 2 * 2 * 9 * 4 + 2 * 6 * 8 * 8
    assert R.k2(2, 3, 8, 2)[0] == 2.5 * 4 * 2 * 2 * 9 * 4
    assert R.k3b(4, 8, 16)[0] == 3 * R.k3(4, 8, 16)[0]
    assert torch.tensor(m) > 0


@pytest.mark.parametrize("numbers, limits, correct", [
    ({"a": 1.0, "b": 5.0}, {"a": 2.0, "b": None}, True),    # b read, not compared
    ({"a": 3.0, "b": 5.0}, {"a": 2.0, "b": None}, False),
    ({"a": 1.0, "b": 5.0}, {"a": 2.0}, False),               # a number no limit names
    ({"a": 1.0}, {"a": 2.0, "b": None}, False),              # a limit with no number
    ({"a": float("nan")}, {"a": 2.0}, False)])
def test_judge_compares_every_number_the_limits_name(numbers, limits, correct):
    from port_bench.lib.check import judge

    assert judge(numbers, limits)[0] is correct
