"""K3's launch plan and its split-and-merge arithmetic, on the CPU.

The cosine-VQ forward (`ops/fused_keyword.py::cosine_vq_stats`) runs on the
card over a grid of (row tiles, V splits) that `_fwd_plan` chooses: pass 1
keeps, per split and row, the running (m, z = Σ e, w = Σ e s) with
e = exp(s - m) and the best (value, index); a combine merges the splits in
column order into k, ent = log z + m - w / z, m and z; pass 2 sums
exp(s - m) / z over each row tile, one partial per (row tile, column); a
reduce sums the partials in row-tile order. `split_reference` below is
those passes in plain torch; it must equal the plain twin for any split
count, with ragged N and V, with exact ties and with a split whose columns
are all masked. The kernels themselves are held to the twin on the card in
`test_torch_cuda_kernels.py`; the twin to the JAX kernel in
`test_torch_fused_keyword.py`.
"""
import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechclip_plus_tpu.ops.fused_keyword import fused_cosine_vq as jax_fused_vq
from speechclip_plus_tpu_torch.ops import fused_keyword as fk

SPECIAL = (0, 2, 3)  # the reduced vocabulary's masked ids: '!', SOT, EOT
INIT_MAX = -3e38


def _inputs(n, d, v, dtype=torch.float32, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    emb = (rng.randn(v, d) * 0.1).astype(np.float32)
    en = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
    t = lambda a: torch.from_numpy(a).to(dtype).contiguous()
    return t(x), t(en), fk.column_mask(v, SPECIAL, "cpu")


def _merge(a, b):
    """Two (m, z, w, best value, best index) sets merged; b's columns lie
    after a's, so a tie keeps a's index."""
    (m, z, w, bv, bi), (m2, z2, w2, bv2, bi2) = a, b
    mn = torch.maximum(m, m2)
    ea, eb = torch.exp(m - mn), torch.exp(m2 - mn)
    take = bv2 > bv
    return (mn, ea * z + eb * z2, ea * w + eb * w2, torch.where(take, bv2, bv),
            torch.where(take, bi2, bi))


def _identity(n):
    return (torch.full((n,), INIT_MAX), torch.zeros(n), torch.zeros(n),
            torch.full((n,), INIT_MAX), torch.full((n,), -1, dtype=torch.long))


def split_reference(xn, en, mask, splits, cols=128, rows=128):
    """K3's passes in plain torch, in the kernels' order: split k owns the
    whole `cols`-wide tiles [k * per, (k + 1) * per) of V; pass 2's
    partials are per `rows`-row tile. Returns (k, ent, psum, the splits'
    statistics)."""
    n, v = xn.shape[0], en.shape[0]
    xf, ef = xn.float(), en.float()
    live = ~mask.bool()
    per = -(-(-(-v // cols)) // splits) * cols
    stats = []
    for lo in range(0, splits * per, per):  # pass 1
        acc = _identity(n)
        for c0 in range(lo, min(v, lo + per), cols):
            c1 = min(v, lo + per, c0 + cols)
            s = torch.where(live[c0:c1], xf @ ef[c0:c1].T, -torch.inf)
            tm, ti = s.max(dim=-1)  # the tile's first maximum
            e = torch.where(live[c0:c1], torch.exp(s - tm[:, None]), 0.0)
            ws = (e * torch.where(live[c0:c1], s, 0.0)).sum(-1)
            tile = (tm, e.sum(-1), ws, tm, ti + c0)
            if not bool(live[c0:c1].any()):
                tile = _identity(n)
            acc = _merge(acc, tile)
        stats.append(acc)
    m, z, w, bv, k = _identity(n)
    for st in stats:  # the combine, in column order
        m, z, w, bv, k = _merge((m, z, w, bv, k), st)
    ent = torch.log(z) + m - w / z
    psum = torch.zeros(v)
    for r0 in range(0, n, rows):  # pass 2, then the reduce in row-tile order
        r1 = min(n, r0 + rows)
        p = torch.exp(xf[r0:r1] @ ef.T - m[r0:r1, None]) / z[r0:r1, None]
        psum = psum + torch.where(live, p, 0.0).sum(0)
    return k.to(torch.int32), ent, psum, stats


def _assert_matches_twin(got, want):
    k, ent, psum = got[:3]
    k0, ent0, psum0 = want
    assert torch.equal(k, k0)
    torch.testing.assert_close(ent, ent0, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(psum, psum0, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("splits", range(1, 17))
def test_split_reference_matches_the_twin(splits):
    n, d, v = 75, 32, 1000  # ragged: 75 rows, 1000 columns = 15 tiles of 64 + 40
    args = _inputs(n, d, v, seed=splits)
    want = fk.plain_cosine_vq_stats(*args)
    _assert_matches_twin(split_reference(*args, splits, cols=64, rows=32), want)
    if splits <= -(-v // 128):
        _assert_matches_twin(split_reference(*args, splits), want)


def _tied_case(seed=0):
    """Every row of x is a codebook vector that appears three times, in
    different tiles and splits, so that its scores tie exactly."""
    rng = np.random.RandomState(seed)
    b, kk, d, v = 4, 16, 64, 1000
    emb = (rng.randn(v, d) * 0.1).astype(np.float32)
    sources = 4 + 8 * np.arange(60)  # ids 4, 12, .., 476
    emb[sources + 5] = emb[sources]  # the same tile, or the next one
    emb[sources + 500] = emb[sources]  # a later tile and split
    src = sources[rng.randint(0, 60, size=b * kk)]
    xn = emb[src] / np.linalg.norm(emb[src], axis=-1, keepdims=True)
    return xn.reshape(b, kk, d), emb, src


def test_exact_ties_go_to_the_lowest_index_as_in_the_jax_kernel():
    xn, emb, src = _tied_case()
    b, kk, d = xn.shape
    want = jax_fused_vq(jnp.asarray(xn), jnp.asarray(emb), jnp.float32(0.1), prob_msk=SPECIAL,
                        training=False, dtype=jnp.float32, interpret=True)
    jax_k = np.asarray(want["targets"]).reshape(-1)
    np.testing.assert_array_equal(jax_k, src)
    x = torch.from_numpy(xn.reshape(b * kk, d))
    e = torch.from_numpy(emb)
    en = (e / e.norm(dim=-1, keepdim=True)).contiguous()
    mask = fk.column_mask(emb.shape[0], SPECIAL, "cpu")
    for splits in (1, 3, 8):
        for cols, rows in ((128, 128), (64, 32), (2, 64)):
            k = split_reference(x, en, mask, splits, cols=cols, rows=rows)[0]
            np.testing.assert_array_equal(k.numpy(), jax_k, err_msg=f"{splits} {cols}")
    np.testing.assert_array_equal(fk.plain_cosine_vq_stats(x, en, mask)[0].numpy(), jax_k)


def test_a_split_of_masked_ids_merges_as_the_identity():
    """Two-column tiles, one a split: split 1 holds ids 2 and 3 alone, both
    masked, so its statistics are the identity and merging them changes
    nothing."""
    n, d, v = 37, 16, 21
    args = _inputs(n, d, v, seed=3)
    k, ent, psum, stats = split_reference(*args, splits=11, cols=2, rows=8)
    m, z, w, bv, bi = stats[1]
    assert torch.all(m == INIT_MAX) and torch.all(z == 0) and torch.all(w == 0)
    assert torch.all(bv == INIT_MAX) and torch.all(bi == -1)
    merged = _merge(stats[0], stats[1])
    assert all(torch.equal(a, b) for a, b in zip(merged, stats[0]))
    assert torch.all(psum[list(SPECIAL)] == 0)
    _assert_matches_twin((k, ent, psum), fk.plain_cosine_vq_stats(*args))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [8, 64, 75, 512, 600, 1024, 4800, 9600])
def test_plan_fills_the_card(n, dtype):
    """At every N the paths record (V=8112, D=512), the blocks in their whole
    waves take at most 1.25x the time of a perfectly spread grid (a block a
    column tile: no fewer than one wave)."""
    v, d, sms = 8112, 512, 132
    rows, splits = fk._fwd_plan(n, v, d, dtype, sms)
    assert rows == (128 if dtype == torch.bfloat16 else 32)
    row_tiles, col_tiles = -(-n // rows), -(-v // fk._FWD_COLS[dtype])
    slots = sms * fk._FWD_BLOCKS_PER_SM[dtype]
    per = -(-col_tiles // splits)
    waves = -(-row_tiles * splits // slots)
    ideal = max(row_tiles * col_tiles / slots, 1.0)
    assert waves * per <= 1.25 * ideal, (rows, splits, waves, per, ideal)


def test_plan_keeps_the_scratch_under_its_cap_and_no_split_empty():
    for dtype in (torch.bfloat16, torch.float32):
        for n in list(range(1, 300, 7)) + [1024, 4800, 9600, 20000, 100000, 400000]:
            for v, d in ((8112, 512), (300, 64), (49408, 768)):
                _, splits = fk._fwd_plan(n, v, d, dtype)
                col_tiles = -(-v // fk._FWD_COLS[dtype])
                per = -(-col_tiles // splits)
                assert (splits - 1) * per < col_tiles
                assert splits == 1 or 5 * 4 * splits * n <= fk.FWD_SCRATCH_CAP


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 8), (torch.bfloat16, 72),
                                     (torch.bfloat16, 784), (torch.bfloat16, 1024),
                                     (torch.float32, 0), (torch.float32, 100),
                                     (torch.float32, 1040)])
def test_plan_rejects_widths_the_kernels_do_not_take(dtype, d):
    with pytest.raises(ValueError, match="multiple of 16"):
        fk._fwd_plan(64, 8112, d, dtype)


def test_plan_rejects_a_dtype_the_kernels_do_not_take():
    with pytest.raises(TypeError, match="dtype"):
        fk._fwd_plan(64, 8112, 512, torch.float16)


def test_plan_takes_the_widths_the_kernels_do():
    assert fk._fwd_plan(64, 8112, 512, torch.bfloat16)[0] == 128
    assert fk._fwd_plan(64, 8112, 768, torch.bfloat16)[0] == 64  # the large family's CLIP width
    assert fk._fwd_plan(64, 8112, 1024, torch.float32)[0] == 32
    assert fk._fwd_plan(9600, 8112, 16, torch.bfloat16)[0] == 128


def _stand_in_for_the_card(monkeypatch):
    """The CUDA wrapper's calls made on the CPU: a library that records its
    arguments, and no device context or stream."""
    from speechclip_plus_tpu_torch.utils import cuda_build

    calls = []
    lib = types.SimpleNamespace(sc_vq_fwd_rows=lambda *a: calls.append(("rows", a)) or 0,
                                sc_vq_fwd_cols=lambda *a: calls.append(("cols", a)) or 0)
    monkeypatch.setattr(cuda_build, "kernels", lambda: lib)
    monkeypatch.setattr(fk, "_sm_count", lambda device: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,d,v", [(75, 64, 300), (1024, 512, 8112), (9600, 768, 8112)])
def test_wrapper_sizes_its_scratch_from_the_plan(monkeypatch, dtype, n, d, v):
    calls = _stand_in_for_the_card(monkeypatch)
    made = []
    real = fk._fwd_scratch
    monkeypatch.setattr(fk, "_fwd_scratch", lambda *a: made.append(real(*a)) or made[-1])
    x, en = torch.zeros(n, d, dtype=dtype), torch.zeros(v, d, dtype=dtype)
    mask = fk.column_mask(v, SPECIAL, "cpu")
    before = fk.LAUNCHES
    k, ent, psum = fk._launch(x, en, mask)
    assert fk.LAUNCHES == before + 1
    rows, splits = fk._fwd_plan(n, v, d, dtype, 132)
    # the two entry points in turn: pass 1 and the merge, then pass 2 and the reduce
    (first, args), (second, cols) = calls
    assert (first, second) == ("rows", "cols")
    assert args[3:9] == cols[3:9] == (n, v, d, int(dtype == torch.bfloat16), rows, splits)
    (scratch,) = made
    assert scratch["stats"].numel() == 4 * splits * n
    assert scratch["best_i"].numel() == splits * n and scratch["best_i"].dtype == torch.int32
    assert scratch["col_part"].numel() == -(-n // rows) * v
    assert args[9:11] == tuple(scratch[key].data_ptr() for key in ("stats", "best_i"))
    assert args[11:15] == (k.data_ptr(), ent.data_ptr(), scratch["m"].data_ptr(),
                           scratch["z"].data_ptr())
    assert args[15:18] == (None, None, 0)  # no shard's row statistics
    assert cols[9:13] == (scratch["m"].data_ptr(), scratch["z"].data_ptr(),
                          scratch["col_part"].data_ptr(), psum.data_ptr())
    assert scratch["m"].numel() == scratch["z"].numel() == n
    assert k.shape == (n,) and k.dtype == torch.int32
    assert ent.shape == (n,) and psum.shape == (v,) and psum.dtype == torch.float32


@pytest.mark.parametrize("what", ["width", "wider than the tile", "alignment", "dtype"])
def test_wrapper_raises_on_inputs_the_kernel_does_not_take(monkeypatch, what):
    calls = _stand_in_for_the_card(monkeypatch)
    n, v = 37, 300
    d = {"width": 72, "wider than the tile": 784}.get(what, 64)
    x = torch.zeros(n * d + 1, dtype=torch.bfloat16)
    x = x[1:].view(n, d) if what == "alignment" else x[:-1].view(n, d)
    en = torch.zeros(v, d, dtype=torch.float32 if what == "dtype" else torch.bfloat16)
    error, match = {"width": (ValueError, "multiple of 16"),
                    "wider than the tile": (ValueError, "at most 768"),
                    "alignment": (ValueError, "aligned"), "dtype": (TypeError, "dtypes")}[what]
    before = fk.LAUNCHES
    with pytest.raises(error, match=match):
        fk._launch(x, en, fk.column_mask(v, SPECIAL, "cpu"))
    assert not calls and fk.LAUNCHES == before


def test_cosine_vq_stats_takes_the_twin_on_cpu_tensors(monkeypatch):
    def no_kernel(*args):
        raise AssertionError("the kernel path ran on CPU tensors")

    monkeypatch.setattr(fk, "_launch", no_kernel)
    args = _inputs(20, 32, 100)
    got = fk.cosine_vq_stats(*args)
    want = fk.plain_cosine_vq_stats(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
