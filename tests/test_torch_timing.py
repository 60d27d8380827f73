"""The port's timing helpers (`speechclip_plus_tpu_torch/utils/timing.py`)
against the JAX package's (`speechclip_plus_tpu/utils/timing.py`), on the CPU.

`timed` calls its function as often as JAX's does (one first call, then
`iters` x `chain`) and returns its least mean time; CPU tensors are timed by
the host's clock, never by CUDA events; `median_ms`, the smoke's kernel
timer, raises where there is no CUDA device instead of timing the CPU.
"""
import time

import jax.numpy as jnp
import pytest
import torch

from speechclip_plus_tpu.utils import timing as jtiming

from speechclip_plus_tpu_torch.utils import timing


@pytest.mark.parametrize("iters,chain", [(3, 5), (1, 1), (2, 7)])
def test_timed_calls_fn_as_often_as_jax(iters, chain):
    calls = {"jax": 0, "port": 0}

    def jfn(eps, x):
        calls["jax"] += 1
        return (x + eps).sum() * 1e-20

    def pfn(x):
        calls["port"] += 1
        return x.sum()

    jtiming.timed(jfn, jnp.ones(4), iters=iters, chain=chain)
    timing.timed(pfn, torch.ones(4), iters=iters, chain=chain)
    assert calls["port"] == calls["jax"] == 1 + iters * chain


def test_timed_returns_the_least_mean_host_time(monkeypatch):
    def no_events(*a, **k):
        raise AssertionError("CUDA events for CPU tensors")

    monkeypatch.setattr(torch.cuda, "Event", no_events)
    x = torch.randn(64, 64)
    sec = timing.timed(lambda a: a @ a, x, iters=2, chain=3, label="matmul")
    assert sec > 0

    def sleeper(a):
        time.sleep(0.002)
        return a

    assert timing.timed(sleeper, x, iters=2, chain=2) >= 0.002


def test_sync_value_fetches_a_float():
    assert timing.sync_value(torch.tensor(3.5)) == 3.5
    assert timing.sync_value(torch.ones(2, 3, dtype=torch.bfloat16)) == 6.0
    assert timing.sync_value(2) == 2.0


def test_median_ms_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        timing.median_ms(lambda: calls.append(1))
    assert not calls
