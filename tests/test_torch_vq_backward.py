"""K3b's launch plan and its split-and-merge arithmetic, on the CPU.

The straight-through backward (`ops/fused_keyword.py::st_backward`) runs on
the card over a grid of (row tiles, V splits) that `_bwd_plan` chooses: per
split, pass 1 keeps the running (m, z = Σ e, zu = Σ e u) of softmax(s / t);
pass 2 merges the splits' statistics in column order, recomputes s and u and
forms dz, a dt partial and the split's partial dx; pass 3 sums the partials
in a fixed order. `split_reference` below is those passes in plain torch; it
must equal the plain twin within fp32 rounding for any split count, with
ragged N and V and with a split whose columns are all masked. The kernels
themselves are held to the twin on the card in `test_torch_cuda_kernels.py`;
the twin to the JAX kernel in `test_torch_dropout_optim.py`.
"""
import contextlib
import types

import numpy as np
import pytest
import torch

from speechclip_plus_tpu_torch.ops import fused_keyword as fk

SPECIAL = (0, 2, 3)  # the reduced vocabulary's masked ids: '!', SOT, EOT
INIT_MAX = -3e38


def _inputs(n, d, v, dtype=torch.float32, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    g = (rng.randn(n, d) * 1e-3).astype(np.float32)
    emb = (rng.randn(v, d) * 0.1).astype(np.float32)
    norms = np.maximum(np.linalg.norm(emb, axis=-1), 1e-8).astype(np.float32)
    en = emb / norms[:, None]
    t = lambda a: torch.from_numpy(a).to(dtype).contiguous()
    return t(x), t(g), t(en), torch.from_numpy(norms), fk.column_mask(v, SPECIAL, "cpu")


def _merge(a, b):
    (m, z, zu), (m2, z2, zu2) = a, b
    mn = torch.maximum(m, m2)
    ea, eb = torch.exp(m - mn), torch.exp(m2 - mn)
    return mn, ea * z + eb * z2, ea * zu + eb * zu2


def _identity(n):
    return torch.full((n,), INIT_MAX), torch.zeros(n), torch.zeros(n)


def split_reference(xn, g, en, norms, mask, temp, splits, cols=64):
    """K3b's passes 1-3 in plain torch, in the kernel's order: split k owns the
    whole `cols`-wide tiles [k * per, (k + 1) * per) of V. Returns (dx, dt,
    the splits' statistics)."""
    n, v = xn.shape[0], en.shape[0]
    xf, gf, ef = xn.float(), g.float(), en.float()
    live = ~mask.bool()
    inv_t = torch.tensor(1.0 / temp, dtype=torch.float32)
    per = -(-(-(-v // cols)) // splits) * cols
    ranges = [(k * per, min(v, (k + 1) * per)) for k in range(splits)]
    stats = []
    for lo, hi in ranges:  # pass 1
        acc = _identity(n)
        for c0 in range(lo, hi, cols):
            c1 = min(hi, c0 + cols)
            s = (xf @ ef[c0:c1].T) * inv_t
            u = (gf @ ef[c0:c1].T) * norms[c0:c1]
            tm = torch.where(live[c0:c1], s, INIT_MAX).amax(dim=-1)
            e = torch.where(live[c0:c1], torch.exp(s - tm[:, None]), 0.0)
            acc = _merge(acc, (tm, e.sum(-1), (e * u).sum(-1)))
        stats.append(acc)
    m, z, zu = _identity(n)
    for st in stats:  # pass 2: the merge in column order ...
        m, z, zu = _merge((m, z, zu), st)
    iz = 1.0 / z
    rho = zu * iz
    dx_parts, dt_parts = [], []
    for lo, hi in ranges:  # ... and each split's dz, dt and partial dx
        s = xf @ ef[lo:hi].T
        u = (gf @ ef[lo:hi].T) * norms[lo:hi]
        p = torch.exp(s * inv_t - m[:, None]) * iz[:, None]
        dz = torch.where(live[lo:hi], p * (u - rho[:, None]), 0.0)
        dt_parts.append((dz * (-s * inv_t * inv_t)).sum())
        dx_parts.append((dz * inv_t).to(xn.dtype).float() @ ef[lo:hi])
    dx, dt = dx_parts[0], dt_parts[0]
    for a, b in zip(dx_parts[1:], dt_parts[1:]):  # pass 3, in split order
        dx, dt = dx + a, dt + b
    return dx, dt, stats


def _dt_scale(xn, g, en, norms, mask, temp):
    """Σ |dz · s| / t²: the size of dt's terms, which its error is judged by."""
    s = xn.float() @ en.float().T
    p = torch.softmax(torch.where(mask.bool()[None], -torch.inf, s / temp), dim=-1)
    u = (g.float() @ en.float().T) * norms
    return (p * (u - (p * u).sum(-1, keepdim=True)) * s).abs().sum().item() / temp ** 2


@pytest.mark.parametrize("splits", range(1, 17))
def test_split_reference_matches_the_twin(splits):
    n, d, v = 75, 32, 1000  # ragged: 75 rows, 1000 columns = 15 tiles + 40
    args = _inputs(n, d, v, seed=splits)
    dx0, dt0 = fk.plain_st_backward(*args, 0.1)
    dx, dt, _ = split_reference(*args, 0.1, splits)
    rms = dx0.pow(2).mean().sqrt().item()
    assert (dx - dx0).abs().max().item() <= 1e-5 * rms
    assert abs(dt.item() - dt0.item()) <= 1e-5 * _dt_scale(*args, 0.1)


def test_a_split_of_masked_ids_merges_as_the_identity():
    """Two-column tiles, one a split: split 1 holds ids 2 and 3 alone, both
    masked, so its statistics are (INIT_MAX, 0, 0) and merging them changes
    nothing; its dx part is zero."""
    n, d, v = 37, 16, 21
    args = _inputs(n, d, v, seed=3)
    dx, dt, stats = split_reference(*args, 0.1, splits=11, cols=2)
    m, z, zu = stats[1]
    assert torch.all(m == INIT_MAX) and torch.all(z == 0) and torch.all(zu == 0)
    merged = _merge(stats[0], stats[1])
    assert all(torch.equal(a, b) for a, b in zip(merged, stats[0]))
    assert torch.isfinite(dx).all() and torch.isfinite(dt)
    dx0, dt0 = fk.plain_st_backward(*args, 0.1)
    assert (dx - dx0).abs().max().item() <= 1e-5 * dx0.pow(2).mean().sqrt().item()
    assert abs(dt.item() - dt0.item()) <= 1e-5 * _dt_scale(*args, 0.1)


@pytest.mark.parametrize("splits", [1, 3, 8])
def test_split_reference_in_bf16_rounds_w_as_the_twin(splits):
    """bf16 operands: w = dz / t rounded to bf16 before its product; the
    reference sits within the kernel's bf16 tolerance of the twin."""
    n, d, v = 40, 64, 700
    args = _inputs(n, d, v, dtype=torch.bfloat16, seed=splits)
    dx0, dt0 = fk.plain_st_backward(*args, 0.1)
    dx, dt, _ = split_reference(*args, 0.1, splits)
    assert (dx - dx0).abs().max().item() <= 1e-2 * dx0.pow(2).mean().sqrt().item()
    assert abs(dt.item() - dt0.item()) <= 1e-4 * _dt_scale(*args, 0.1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [8, 37, 600, 1024, 4800, 9600])
def test_plan_fills_the_card(n, dtype):
    """At every N the paths and the tests run (V=8112, D=512), the blocks in
    their whole waves take at most 1.25x the time of a perfectly spread grid
    (a block a column tile: no fewer than one wave)."""
    v, d, sms = 8112, 512, 132
    rows, splits = fk._bwd_plan(n, v, d, dtype, sms)
    assert rows == (64 if dtype == torch.bfloat16 else 32)
    row_tiles, col_tiles = -(-n // rows), -(-v // 64)
    slots = sms * (1 if dtype == torch.bfloat16 else 2)
    per = -(-col_tiles // splits)
    waves = -(-row_tiles * splits // slots)
    ideal = max(row_tiles * col_tiles / slots, 1.0)
    assert waves * per <= 1.25 * ideal, (rows, splits, waves, per, ideal)


def test_plan_keeps_the_scratch_under_its_cap_and_no_split_empty():
    for dtype in (torch.bfloat16, torch.float32):
        for n in list(range(1, 300, 7)) + [1024, 4800, 9600, 20000, 100000]:
            for v, d in ((8112, 512), (300, 64), (49408, 512)):
                _, splits = fk._bwd_plan(n, v, d, dtype)
                col_tiles = -(-v // 64)
                per = -(-col_tiles // splits)
                assert (splits - 1) * per < col_tiles
                assert splits == 1 or splits * n * d * 4 <= fk.BWD_SCRATCH_CAP


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 8), (torch.bfloat16, 72),
                                     (torch.bfloat16, 784), (torch.bfloat16, 1024),
                                     (torch.float32, 0), (torch.float32, 100),
                                     (torch.float32, 1040)])
def test_plan_rejects_widths_the_kernels_do_not_take(dtype, d):
    with pytest.raises(ValueError, match="multiple of 16"):
        fk._bwd_plan(64, 8112, d, dtype)


def test_plan_takes_the_widths_the_kernels_do():
    assert fk._bwd_plan(64, 8112, 512, torch.bfloat16)[0] == 64
    # past D=512 the tensor-core tile keeps 32 rows (the large family's CLIP width)
    assert fk._bwd_plan(64, 8112, 528, torch.bfloat16)[0] == 32
    assert fk._bwd_plan(9600, 19787, 768, torch.bfloat16)[0] == 32
    assert fk._bwd_plan(64, 8112, 1024, torch.float32)[0] == 32
    assert fk._bwd_plan(9600, 8112, 16, torch.bfloat16)[0] == 64


def _stand_in_for_the_card(monkeypatch):
    """The CUDA wrapper's calls made on the CPU: a library that records its
    arguments, and no device context or stream."""
    from speechclip_plus_tpu_torch.utils import cuda_build

    calls = []
    lib = types.SimpleNamespace(sc_vq_bwd=lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(cuda_build, "kernels", lambda: lib)
    monkeypatch.setattr(fk, "_sm_count", lambda device: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,d,v", [(75, 64, 300), (1024, 512, 8112), (9600, 16, 8112)])
def test_wrapper_sizes_its_scratch_from_the_plan(monkeypatch, dtype, n, d, v):
    calls = _stand_in_for_the_card(monkeypatch)
    made = []
    real = fk._bwd_scratch
    monkeypatch.setattr(fk, "_bwd_scratch", lambda *a: made.append(real(*a)) or made[-1])
    x, g, en, norms, mask = (torch.zeros(n, d, dtype=dtype), torch.zeros(n, d, dtype=dtype),
                             torch.zeros(v, d, dtype=dtype), torch.ones(v),
                             fk.column_mask(v, SPECIAL, "cpu"))
    before = fk.BWD_LAUNCHES
    temp = torch.tensor(0.1)  # the kernel reads the temperature from device memory
    dx, dt = fk._launch_bwd(x, g, en, norms, mask, temp)
    assert fk.BWD_LAUNCHES == before + 1
    rows, splits = fk._bwd_plan(n, v, d, dtype, 132)
    (args,) = calls
    assert args[5:12] == (n, v, d, temp.data_ptr(), int(dtype == torch.bfloat16), rows,
                          splits)
    (scratch,) = made
    assert scratch["stats"].numel() == 3 * splits * n
    assert scratch["dx_part"].numel() == (splits * n * d if splits > 1 else 0)
    assert scratch["dt_part"].numel() == -(-n // rows) * splits
    assert args[12:15] == tuple(scratch[k].data_ptr() for k in ("stats", "dx_part", "dt_part"))
    assert args[15:17] == (dx.data_ptr(), dt.data_ptr())
    assert args[17:19] == (splits, 3)  # every split's statistics, both passes
    assert dx.shape == (n, d) and dx.dtype == torch.float32 and dt.shape == ()


@pytest.mark.parametrize("what", ["width", "alignment"])
def test_wrapper_raises_on_inputs_the_kernel_does_not_take(monkeypatch, what):
    calls = _stand_in_for_the_card(monkeypatch)
    n, d, v = 37, 72 if what == "width" else 64, 300
    x = torch.zeros(n * d + 1, dtype=torch.bfloat16)
    x = x[1:].view(n, d) if what == "alignment" else x[:-1].view(n, d)
    g, en = torch.zeros(n, d, dtype=torch.bfloat16), torch.zeros(v, d, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 16" if what == "width" else "aligned"):
        fk._launch_bwd(x, g, en, torch.ones(v), fk.column_mask(v, SPECIAL, "cpu"), 0.1)
    assert not calls


def test_st_backward_takes_the_twin_on_cpu_tensors(monkeypatch):
    def no_kernel(*args):
        raise AssertionError("the kernel path ran on CPU tensors")

    monkeypatch.setattr(fk, "_launch_bwd", no_kernel)
    args = _inputs(20, 32, 100)
    got = fk.st_backward(*args, 0.1)
    want = fk.plain_st_backward(*args, 0.1)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
