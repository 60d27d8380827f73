"""The kernels' twins on tensor-parallel shards, on the CPU, in one process.

A model group's ranks are stood in for by a loop over the shards: K1's and
K5's twins on each range of heads against the whole twin's heads (the
dropout mask at p=0.1 included, and WavLM's bias and gate), K1's fp32 partial
out-projections summed against the whole block, K3's rows / merge / columns
and K3b's statistics / apply halves merged across the shards against the
unsharded twins, an exact argmax tie across a shard boundary, a shard with
no live column, and the keep mask's head range (``ops/random.py``).
"""
import pytest
import torch

from speechclip_plus_tpu_torch.nn import fused_attention as fa
from speechclip_plus_tpu_torch.nn import fused_attention_block as fab
from speechclip_plus_tpu_torch.ops import fused_keyword as fk
from speechclip_plus_tpu_torch.ops.random import attention_keep_mask, draw_seed
from speechclip_plus_tpu_torch.parallel.tp import dropout_columns, shard_tensor

SPECIAL = (0, 2, 3)


def _block(b=2, t=11, d=48, seed=0):
    g = torch.Generator().manual_seed(seed)
    mk = lambda *s, scale=1.0: torch.randn(*s, generator=g) * scale
    lens = torch.tensor([t] + [t - 3] * (b - 1))
    kb = torch.where(torch.arange(t)[None] >= lens[:, None], -1e30, 0.0)
    return (mk(b, t, d), mk(3 * d, d, scale=d ** -0.5), mk(3 * d, scale=0.1),
            mk(d, d, scale=d ** -0.5), mk(d, scale=0.1), kb)


def _shards(w_in, b_in, w_out, r, tp):
    return (shard_tensor("in_proj_weight", w_in, 0, r, tp),
            shard_tensor("in_proj_bias", b_in, 0, r, tp),
            shard_tensor("out_proj.weight", w_out, 1, r, tp).contiguous())


def test_keep_mask_head_range_is_the_whole_masks_heads():
    seeds = draw_seed(torch.Generator().manual_seed(1))
    whole = attention_keep_mask(seeds, 3, 6, 9, 0.9)
    for h0, h in ((0, 2), (2, 2), (4, 2), (3, 3), (5, 1)):
        assert torch.equal(attention_keep_mask(seeds, 3, h, 9, 0.9, h0, 6),
                           whole[:, h0:h0 + h])
    with pytest.raises(ValueError, match="heads"):
        attention_keep_mask(seeds, 3, 4, 9, 0.9, 3, 6)


@pytest.mark.parametrize("tp", [2, 3, 6])
@pytest.mark.parametrize("p,gated", [(0.0, False), (0.1, False), (0.1, True)])
def test_block_twin_on_head_shards(tp, p, gated):
    heads = 6
    x, w_in, b_in, w_out, b_out, kb = _block()
    b, t, d = x.shape
    kw = {}
    if p:
        kw.update(seeds=draw_seed(torch.Generator().manual_seed(3)), keep_prob=1.0 - p)
    ab = gate = None
    if gated:
        g = torch.Generator().manual_seed(8)
        ab, gate = torch.randn(heads, t, t, generator=g), 1 + torch.rand(b, heads, t, generator=g)
    whole = fab.plain_fused_attention_block(x, w_in, b_in, None, None, kb, heads, False,
                                            attn_bias=ab, attn_gate=gate, **kw)
    out = fab.plain_fused_attention_block(x, w_in, b_in, w_out, b_out, kb, heads, True,
                                          attn_bias=ab, attn_gate=gate, **kw)
    h, dh = heads // tp, d // heads
    parts = []
    for r in range(tp):
        wi, bi, wo = _shards(w_in, b_in, w_out, r, tp)
        sl = dict(attn_bias=None if ab is None else ab[r * h:(r + 1) * h],
                  attn_gate=None if gate is None else gate[:, r * h:(r + 1) * h],
                  head_offset=r * h, total_heads=heads, **kw)
        ctx = fab.fused_attention_block(x, wi, bi, None, None, kb, n_heads=h, fuse_out=False,
                                        **{k: v for k, v in sl.items()
                                           if k not in ("seeds", "keep_prob")},
                                        **({"dropout_rate": p,
                                            "generator": torch.Generator().manual_seed(3)}
                                           if p else {}))
        assert torch.equal(ctx, whole[..., r * h * dh:(r + 1) * h * dh]), r
        parts.append(fab.plain_fused_attention_block(x, wi, bi, wo, None, kb, h, True,
                                                     partial=True, **sl))
    torch.testing.assert_close(sum(parts) + b_out, out, rtol=0, atol=1e-5)


def test_block_head_range_is_checked():
    x, w_in, b_in, w_out, b_out, kb = _block()
    with pytest.raises(ValueError, match="partial needs fuse_out"):
        fab.fused_attention_block(x, w_in, b_in, w_out, b_out, kb, n_heads=6, fuse_out=False,
                                  partial=True)


@pytest.mark.parametrize("tp", [2, 4])
def test_fused_attention_dropout_twin_on_head_shards(tp):
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(2, 4, 10, 8, generator=g) for _ in range(3))
    seeds = draw_seed(torch.Generator().manual_seed(5))
    whole = fa.plain_fused_attention_dropout(q, k, v, None, seeds, 0.9)
    h = 4 // tp
    for r in range(tp):
        sl = slice(r * h, (r + 1) * h)
        got = fa.fused_attention_dropout(q[:, sl], k[:, sl], v[:, sl], dropout_rate=0.1,
                                         generator=torch.Generator().manual_seed(5),
                                         head_offset=r * h, total_heads=4)
        assert torch.equal(got, whole[:, sl]), r


def test_dropout_columns_is_the_whole_masks_columns():
    x = torch.randn(3, 5, 12)
    whole = x.clone()
    from speechclip_plus_tpu_torch.nn.dropout import dropout

    want = dropout(whole, 0.3, torch.Generator().manual_seed(4))
    for lo in (0, 4, 8):
        got = dropout_columns(x[..., lo:lo + 4], 0.3, torch.Generator().manual_seed(4), 12, lo)
        assert torch.equal(got, want[..., lo:lo + 4])


def _vq(n=40, d=32, v=24, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.nn.functional.normalize(torch.randn(n, d, generator=g), dim=-1)
    emb = torch.randn(v, d, generator=g) * 0.1
    norms = emb.norm(dim=-1)
    return x, emb / norms[:, None], norms, torch.randn(n, d, generator=g) * 1e-3


def _k3_shards(x, en, mask, tp):
    v_r = en.shape[0] // tp
    rows = [fk.vq_rows(x, en[r * v_r:(r + 1) * v_r], mask[r * v_r:(r + 1) * v_r], r * v_r)
            for r in range(tp)]
    k, ent, m, z = fk.vq_combine(torch.stack([s for s, _ in rows], dim=1),
                                 torch.stack([b for _, b in rows], dim=0))
    psum = torch.cat([fk.vq_cols(x, en[r * v_r:(r + 1) * v_r], mask[r * v_r:(r + 1) * v_r], m, z)
                      for r in range(tp)])
    return k, ent, psum


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_cosine_vq_twin_on_vocabulary_shards(tp):
    """tp=8 leaves the shard of ids 0-2 with one live column and that of 3-5
    with none beyond its own: the empty set merges as the identity."""
    x, en, _, _ = _vq()
    mask = fk.column_mask(24, SPECIAL, "cpu")
    k0, e0, p0 = fk.plain_cosine_vq_stats(x, en, mask)
    k, ent, psum = _k3_shards(x, en, mask, tp)
    assert torch.equal(k.long(), k0.long())
    torch.testing.assert_close(ent, e0, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(psum, p0, rtol=1e-5, atol=1e-6)


def test_shard_with_no_live_column():
    x, en, norms, cot = _vq()
    mask = torch.ones(6, dtype=torch.int32)
    stats, best = fk.plain_vq_rows(x, en[:6], mask, 6)
    assert bool((best == -1).all()) and bool((stats[1:3] == 0).all())
    assert bool((fk.plain_vq_cols(x, en[:6], mask, stats[0], torch.ones(40)) == 0).all())
    bstats = fk.plain_st_backward_stats(x, cot, en[:6], norms[:6], mask, 0.1)
    assert bstats.shape == (3, 1, 40) and bool((bstats[1:] == 0).all())


def test_cosine_vq_shard_tie_goes_to_the_lowest_id():
    x, en, _, _ = _vq()
    en = en.clone()
    en[12:] = en[:12]  # every id of the second shard repeats one of the first
    src = torch.arange(40) % 8 + 4
    x = en[src].clone()
    mask = fk.column_mask(24, SPECIAL, "cpu")
    k, _, _ = _k3_shards(x, en, mask, 2)
    assert torch.equal(k.long(), src)
    assert torch.equal(k.long(), fk.plain_cosine_vq_stats(x, en, mask)[0].long())


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_st_backward_twin_on_vocabulary_shards(tp):
    x, en, norms, cot = _vq()
    mask = fk.column_mask(24, SPECIAL, "cpu")
    temp = torch.tensor(0.1)
    dx0, dt0 = fk.plain_st_backward(x, cot, en, norms, mask, temp)
    v_r = 24 // tp
    cut = lambda a, r: a[r * v_r:(r + 1) * v_r]
    stats = torch.cat([fk.st_backward_stats(x, cot, cut(en, r), cut(norms, r), cut(mask, r),
                                            temp) for r in range(tp)], dim=1)
    halves = [fk.st_backward_apply(x, cot, cut(en, r), cut(norms, r), cut(mask, r), temp, stats)
              for r in range(tp)]
    dx, dt = sum(h[0] for h in halves), sum(h[1] for h in halves)
    torch.testing.assert_close(dx, dx0, rtol=1e-5, atol=1e-5 * dx0.abs().max().item())
    torch.testing.assert_close(dt, dt0, rtol=1e-4, atol=1e-7)
