#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: serving and training.

    python3 chip_smoke.py                  # every phase (needs one H100)
    python3 chip_smoke.py --phase kernels  # build + kernel-vs-plain checks only
    python3 chip_smoke.py --phase profile  # device time by kernel: 3 serving
                                           # cells and 1 training cell

Phases, each fatal on failure:
  1. card name and power limit (nvidia-smi); build the CUDA kernels from
     speechclip_plus_tpu_torch/csrc and report the build time;
  2. every kernel against its plain PyTorch twin on the card, at the main
     paths' shapes, in bf16 and fp32 (TF32 off), with the stated tolerances
     and median times over 20 runs (CUDA events): K1 (serving shapes, the
     ViT at B=128 and 256, and with dropout at the training shapes), K2
     (p=0.1 and p=0, and against finite differences in fp32 at T=321), K3
     (N=600 and the training N=9600), K3b; K2 and K3b repeat bit for bit;
     the dropout mask's keep rate;
  3. build hybrid+ base (config/speechclip_plus/base/hybrid_plus.yaml, bf16,
     seeded random weights) on cuda:0;
  4. image index from 1000 seeded random 224x224 images in batches of 256;
  5. serving: B = 1, 8, 64 ragged float32 and int16 requests through
     SpeechRetriever (parallel and cascaded), search_stream and
     SpeechCLIP.encode_speech, with launch-counter checks;
  6. training: hybrid+ base bf16, B=128 crops of 102400 samples (bench.py's
     batch), 3 warm-up and 10 timed steps with cached image features, then
     with live images; finite loss and gradients, every trainable tensor
     moved, every frozen one bit-identical, keyword-BN statistics moved,
     launch counts equal to the plan;
  7. slice parity: the fp32 model on the card (kernels) against the same
     weights on the CPU (plain twins): serving features and retrieval, and
     one training step (B=2, dropout off): loss, gradients, parameters.

Prints a JSON line of kernel results (launch counts of phases 5 and 6; not
printed by --phase kernels, which drives no path) before the last line,
and as the last line {"ok": true, "device": {...}}. Exits non-zero, printing
no result, when there is no CUDA device or any phase fails.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np

CONFIG = "config/speechclip_plus/base/hybrid_plus.yaml"
RATE = 16000
REPS = 10  # timed requests per serving cell


class SmokeFailure(RuntimeError):
    pass


def require(cond, what):
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def median_ms(torch, fn, runs=20, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


TRAIN_BATCH, TRAIN_WAV = 128, 102400  # bench.py's training shapes
WARMUP_STEPS, TIMED_STEPS = 3, 10

# ------------------------------------------------------------- phase 2 ----

def library_block(torch, x, w_in, b_in, w_out, b_out, bias, heads, fuse_out):
    """The block in bf16 arithmetic through cuBLAS and SDPA, timed beside the
    kernel for scale (the plain twin computes in fp32, like the kernel)."""
    F = torch.nn.functional
    b, t, d = x.shape
    q, k, v = (a.reshape(b, t, heads, -1).transpose(1, 2)
               for a in F.linear(x, w_in, b_in).split(d, dim=-1))
    mask = None if bias is None else bias[:, None, None, :].to(x.dtype)
    ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=mask).transpose(1, 2).reshape(b, t, d)
    return F.linear(ctx, w_out, b_out) if fuse_out else ctx


def check_attention(torch, fab, name, b, t, d, heads, fuse_out, padded, dtype, gen):
    dev = "cuda"
    x = torch.randn(b, t, d, generator=gen, device=dev).to(dtype)
    w_in = (torch.randn(3 * d, d, generator=gen, device=dev) / d ** 0.5).to(dtype)
    b_in = torch.randn(3 * d, generator=gen, device=dev) * 0.1
    w_out = (torch.randn(d, d, generator=gen, device=dev) / d ** 0.5).to(dtype)
    b_out = torch.randn(d, generator=gen, device=dev) * 0.1
    bias = None
    if padded:
        lens = torch.randint(t // 2, t + 1, (b,), generator=gen, device=dev)
        lens[0] = t
        bias = torch.where(torch.arange(t, device=dev)[None] >= lens[:, None], -1e30, 0.0)
    args = (x, w_in, b_in.to(dtype), w_out, b_out.to(dtype), bias)
    kern = lambda: fab.fused_attention_block(*args, n_heads=heads, fuse_out=fuse_out)
    plain = lambda: fab.plain_fused_attention_block(*args, heads, fuse_out)
    got = kern().float()
    # the plain twin on the same values in fp32, with no bf16 rounding of the
    # context: for bf16 the error includes the kernel's rounding of it
    f32 = [a if a is None else a.float() for a in args]
    want = fab.plain_fused_attention_block(*f32, heads, fuse_out)
    twin_err = (got - plain().float()).abs().max().item()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    require(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
    if dtype == torch.float32:
        tol, ok = "abs <= 1e-4", err <= 1e-4
    else:
        # a correctly rounded bf16 result is already up to half an ulp of its
        # largest values away, which exceeds 2e-2 * RMS when max/RMS > ~5; the
        # tolerance applies to the error beyond that rounding
        _, exp = torch.frexp(want)
        half_ulp = torch.ldexp(torch.ones_like(want), exp - 9)
        rms = want.pow(2).mean().sqrt().item()
        excess = ((got - want).abs() - half_ulp).clamp_min(0).max().item()
        tol = (f"abs/rms(plain) = {err / rms:.3e}; beyond half a bf16 ulp "
               f"{excess / rms:.3e} <= 2e-2; vs the bf16 twin {twin_err:.3e}")
        ok = excess / rms <= 2e-2
    ms, plain_ms = median_ms(torch, kern), median_ms(torch, plain)
    lib = ""
    if dtype == torch.bfloat16:  # for scale only: bf16 arithmetic, library kernels
        lib_ms = median_ms(torch, lambda: library_block(torch, *args, heads, fuse_out))
        lib = f", bf16 cuBLAS+SDPA {lib_ms:.4f} ms"
    print(f"[kernel] {name} {str(dtype)[6:]}: max_abs_err={err:.3e} ({tol}) "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib}")
    require(ok, f"{name} {dtype}: error {err} over tolerance ({tol})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def check_vq(torch, fk, vocab, n, dtype, gen):
    d, v = 512, len(vocab)
    x = torch.randn(n, d, generator=gen, device="cuda")
    x = (x / x.norm(dim=-1, keepdim=True)).to(dtype).contiguous()
    emb = torch.randn(v, d, generator=gen, device="cuda") * 0.1
    en = (emb / emb.norm(dim=-1, keepdim=True)).to(dtype).contiguous()
    special = (0, vocab.sot_reduced, vocab.eot_reduced)
    mask = fk.column_mask(v, special, "cuda")
    kern = lambda: fk.cosine_vq_stats(x, en, mask)
    plain = lambda: fk.plain_cosine_vq_stats(x, en, mask)
    (k1, e1, p1), (k0, e0, p0) = kern(), plain()
    torch.cuda.synchronize()
    s = (x.float() @ en.float().T).masked_fill(mask.bool()[None], -1e30)
    top2 = s.topk(2, dim=-1).values
    margin = 1e-3 if dtype == torch.bfloat16 else 1e-5
    decided = (top2[:, 0] - top2[:, 1]) > margin
    mismatches = int((k1.long() != k0.long())[decided].sum())
    require(mismatches == 0,
            f"K3 {dtype}: {mismatches} targets differ where the top-2 margin exceeds {margin}")
    require(not bool(mask.bool()[k1.long()].any()), "K3: a masked id won")
    ent_err = (e1 - e0).abs().max().item()
    psum_err = (p1 - p0).abs().max().item()
    require(torch.allclose(e1, e0, rtol=1e-3, atol=0), f"K3 {dtype}: ent off (rtol 1e-3)")
    require(torch.allclose(p1, p0, rtol=1e-3, atol=0), f"K3 {dtype}: psum off (rtol 1e-3)")
    ms, plain_ms = median_ms(torch, kern), median_ms(torch, plain)
    print(f"[kernel] K3 cosine_vq N={n} D={d} V={v} {str(dtype)[6:]}: targets equal on "
          f"{int(decided.sum())}/{n} decided rows, ent max_abs_err={ent_err:.3e}, "
          f"psum max_abs_err={psum_err:.3e} (rtol 1e-3) kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms")
    return {"max_abs_err": max(ent_err, psum_err), "max_abs_err_of": "ent, psum",
            "ent_max_abs_err": ent_err, "psum_max_abs_err": psum_err,
            "target_mismatches_decided": mismatches, "decided_rows": int(decided.sum()),
            "ms": ms, "plain_ms": plain_ms}


def compare(torch, got, want, dtype):
    """(max abs error, ok, tolerance text). fp32: abs <= 1e-4 x max(1, RMS);
    bf16: the error beyond half a bf16 ulp of the plain value <= 2e-2 x RMS
    (K1's tolerances)."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    rms = want.pow(2).mean().sqrt().item()
    if dtype == torch.float32:
        bound = 1e-4 * max(1.0, rms)
        return err, err <= bound, f"abs <= {bound:.2e}"
    _, exp = torch.frexp(want)
    half_ulp = torch.ldexp(torch.ones_like(want), exp - 9)
    excess = ((got - want).abs() - half_ulp).clamp_min(0).max().item()
    return err, excess <= 2e-2 * rms, f"beyond half a bf16 ulp {excess / rms:.3e} x RMS <= 2e-2"


def block_inputs(torch, b, t, d, dtype, gen, padded=True):
    dev = "cuda"
    x = torch.randn(b, t, d, generator=gen, device=dev).to(dtype)
    w_in = (torch.randn(3 * d, d, generator=gen, device=dev) / d ** 0.5).to(dtype)
    b_in = (torch.randn(3 * d, generator=gen, device=dev) * 0.1).to(dtype)
    w_out = (torch.randn(d, d, generator=gen, device=dev) / d ** 0.5).to(dtype)
    b_out = (torch.randn(d, generator=gen, device=dev) * 0.1).to(dtype)
    lens = torch.randint(t // 2, t + 1, (b,), generator=gen, device=dev)
    lens[0] = t
    bias = torch.where(torch.arange(t, device=dev)[None] >= lens[:, None], -1e30, 0.0)
    return x, w_in, b_in, w_out, b_out, bias if padded else None


def check_attention_dropout(torch, fab, name, b, t, d, heads, fuse_out, dtype, gen):
    """K1 with dropout p=0.1 against its twin on the same (seed, offset): the
    masks are identical by construction."""
    from speechclip_plus_tpu_torch.ops.random import draw_seed

    args = block_inputs(torch, b, t, d, dtype, gen)
    seeds = draw_seed(torch.Generator(device="cuda").manual_seed(11))
    f32 = [a.float() for a in args[:5]] + [args[5]]
    if fuse_out:
        kern = lambda: fab._run(*args, heads, True, seeds=seeds, keep_prob=0.9)
        plain = lambda: fab.plain_fused_attention_block(*args, heads, True, seeds=seeds,
                                                        keep_prob=0.9)
        got = kern()
        want = fab.plain_fused_attention_block(*f32, heads, True, seeds=seeds, keep_prob=0.9)
        lse_err = 0.0
    else:
        x, w_in, b_in, _, _, bias = args
        kern = lambda: fab.attention_forward(x, w_in, b_in, bias, n_heads=heads, seeds=seeds,
                                             keep_prob=0.9)
        plain = lambda: fab.plain_fused_attention_block(x, w_in, b_in, None, None, bias, heads,
                                                        False, seeds=seeds, keep_prob=0.9,
                                                        return_aux=True)
        got, _, lse = kern()
        want, _, lse0 = fab.plain_fused_attention_block(
            f32[0], f32[1], f32[2], None, None, bias, heads, False, seeds=seeds,
            keep_prob=0.9, return_aux=True)
        lse_err = (lse - lse0).abs().max().item()
        require(lse_err <= 1e-4, f"{name}: lse error {lse_err} > 1e-4")
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite kernel output")
    err, ok, tol = compare(torch, got, want, dtype)
    ms, plain_ms = median_ms(torch, kern), median_ms(torch, plain)
    print(f"[kernel] {name} p=0.1 {str(dtype)[6:]}: max_abs_err={err:.3e} ({tol}), lse "
          f"max_abs_err={lse_err:.3e} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    require(ok, f"{name} {dtype}: error {err} over tolerance ({tol})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def check_keep_rate(torch):
    """The counter mask's keep rate at the branch shape within 4 sigma of 0.9,
    and another seed gives another mask."""
    from speechclip_plus_tpu_torch.ops.random import attention_keep_mask

    b, h, t = 128, 8, 321
    seeds = torch.tensor([12345, 678], dtype=torch.int64, device="cuda")
    keep = attention_keep_mask(seeds, b, h, t, 0.9)
    n = keep.numel()
    rate = keep.float().mean().item()
    sigma = (0.9 * 0.1 / n) ** 0.5
    other = attention_keep_mask(seeds + 1, b, h, t, 0.9)
    differ = (keep != other).float().mean().item()
    print(f"[kernel] dropout mask B={b} H={h} T={t}: keep rate {rate:.6f} "
          f"({(rate - 0.9) / sigma:+.2f} sigma of 0.9, n={n}); another seed differs on "
          f"{differ * 100:.2f}% (independent masks: 18%)")
    require(abs(rate - 0.9) <= 4 * sigma, f"keep rate {rate} beyond 4 sigma of 0.9")
    require(abs(differ - 0.18) < 0.01, f"masks of two seeds differ on {differ}")


def check_attention_bwd(torch, fab, vjp, dtype, p, gen):
    """K2 at the branch shape against its twin, from one K1 forward."""
    from speechclip_plus_tpu_torch.ops.random import draw_seed

    b, t, d, heads = 128, 321, 768, 8
    x, w_in, b_in, _, _, bias = block_inputs(torch, b, t, d, dtype, gen)
    seeds = draw_seed(torch.Generator(device="cuda").manual_seed(5)) if p > 0 else None
    keep = 1.0 - p
    ctx, qkv, lse = fab.attention_forward(x, w_in, b_in, bias, n_heads=heads, seeds=seeds,
                                          keep_prob=keep)
    dctx = torch.randn(b, t, d, generator=gen, device="cuda").to(dtype)
    kern = lambda: vjp.attention_backward(qkv, bias, dctx, ctx, lse, n_heads=heads,
                                          seeds=seeds, keep_prob=keep)
    plain = lambda: vjp.plain_attention_backward(qkv, bias, dctx, ctx, lse, heads, seeds, keep)
    got, again = kern(), kern()
    want = vjp.plain_attention_backward(qkv, bias, dctx.float(), ctx.float(), lse, heads,
                                        seeds, keep)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got.float()).all()), "K2: non-finite dqkv")
    require(torch.equal(got, again), f"K2 {dtype} p={p}: two runs differ")
    err, ok, tol = compare(torch, got, want, dtype)
    ms, plain_ms = median_ms(torch, kern), median_ms(torch, plain)
    print(f"[kernel] K2 attention backward B={b} T={t} D={d} H={heads} p={p} "
          f"{str(dtype)[6:]}: max_abs_err={err:.3e} ({tol}), bit-identical rerun; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    require(ok, f"K2 {dtype} p={p}: error {err} over tolerance ({tol})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def check_attention_fd(torch, vjp, gen):
    """K2 against finite differences of the K1 forward, fp32, T=321, p=0.1:
    directional derivatives of sum(probe * ctx) along random directions of x,
    Wqkv and bqkv, central differences at eps = 1e-2 (rel. tol. 1e-2)."""
    from speechclip_plus_tpu_torch.ops.random import draw_seed

    b, t, d, heads = 2, 321, 768, 8
    x, w_in, b_in, _, _, bias = block_inputs(torch, b, t, d, torch.float32, gen)
    seeds = draw_seed(torch.Generator(device="cuda").manual_seed(9))
    probe = torch.randn(b, t, d, generator=gen, device="cuda")
    loss = lambda *a: (vjp._AttnCore.apply(*a, bias, heads, seeds, 0.9) * probe).sum()
    params = [a.clone().requires_grad_() for a in (x, w_in, b_in)]
    grads = torch.autograd.grad(loss(*params), params)
    worst = 0.0
    for i, (a, g) in enumerate(zip((x, w_in, b_in), grads)):
        v = torch.randn(a.shape, generator=gen, device="cuda")
        v = v / v.norm() * a.norm()
        eps = 1e-2
        plus = [c + eps * v if j == i else c for j, c in enumerate((x, w_in, b_in))]
        minus = [c - eps * v if j == i else c for j, c in enumerate((x, w_in, b_in))]
        with torch.no_grad():
            fd = ((loss(*plus) - loss(*minus)) / (2 * eps)).item()
        an = (g * v).sum().item()
        rel = abs(fd - an) / max(abs(fd), 1e-6)
        worst = max(worst, rel)
        print(f"[kernel] K2 finite differences fp32 T={t} p=0.1 along {('x', 'Wqkv', 'bqkv')[i]}: "
              f"K2 {an:.6e}, central difference {fd:.6e}, rel {rel:.2e}")
    require(worst <= 1e-2, f"K2 finite differences: rel error {worst} > 1e-2")


def check_vq_bwd(torch, fk, vocab, dtype, gen):
    """K3b at N=9600 V=8112 D=512 against its twin."""
    n, d, v = 128 * 75, 512, len(vocab)
    x = torch.randn(n, d, generator=gen, device="cuda")
    x = (x / x.norm(dim=-1, keepdim=True)).to(dtype).contiguous()
    g = (torch.randn(n, d, generator=gen, device="cuda") * 1e-3).to(dtype).contiguous()
    emb = torch.randn(v, d, generator=gen, device="cuda") * 0.1
    norms = emb.norm(dim=-1).clamp_min(1e-8).contiguous()
    en = (emb / norms[:, None]).to(dtype).contiguous()
    mask = fk.column_mask(v, (0, vocab.sot_reduced, vocab.eot_reduced), "cuda")
    kern = lambda: fk.st_backward(x, g, en, norms, mask, 0.1)
    plain = lambda: fk.plain_st_backward(x, g, en, norms, mask, 0.1)
    (dx, dt), (dx2, dt2) = kern(), kern()
    dx0, dt0 = plain()
    torch.cuda.synchronize()
    require(torch.equal(dx, dx2) and torch.equal(dt, dt2), f"K3b {dtype}: two runs differ")
    require(bool(torch.isfinite(dx).all()) and bool(torch.isfinite(dt)), "K3b: non-finite")
    rms = dx0.pow(2).mean().sqrt().item()
    err = (dx - dx0).abs().max().item()
    # dt sums 78M signed terms: its error is judged against the sum of their sizes
    s = x.float() @ en.float().T
    p = torch.softmax(torch.where(mask.bool()[None], -torch.inf, s / 0.1), dim=-1)
    u = (g.float() @ en.float().T) * norms
    dt_scale = (p * (u - (p * u).sum(-1, keepdim=True)) * s).abs().sum().item() / 0.01
    del s, p, u
    dt_err = abs(dt.item() - dt0.item())
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    ms, plain_ms = median_ms(torch, kern), median_ms(torch, plain)
    print(f"[kernel] K3b ST backward N={n} D={d} V={v} {str(dtype)[6:]}: dx max_abs_err="
          f"{err:.3e} (<= {tol:g} x RMS {rms:.3e}), dt {dt.item():.6e} vs {dt0.item():.6e} "
          f"(err {dt_err:.3e} <= 1e-4 x sum|terms| {dt_scale:.3e}), bit-identical rerun; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    require(err <= tol * rms, f"K3b {dtype}: dx error {err} > {tol} x RMS {rms}")
    require(dt_err <= 1e-4 * dt_scale, f"K3b {dtype}: dt error {dt_err}")
    return {"max_abs_err": err, "max_abs_err_of": "dx", "dt_abs_err": dt_err,
            "ms": ms, "plain_ms": plain_ms}


def phase_kernels(torch):
    from speechclip_plus_tpu_torch.nn import fused_attention_block as fab
    from speechclip_plus_tpu_torch.nn import fused_attention_block_vjp as vjp
    from speechclip_plus_tpu_torch.ops import fused_keyword as fk
    from speechclip_plus_tpu_torch.data.tokenizer import ReducedVocab

    vocab = ReducedVocab.from_npy("assets/flickr_stat/text_clip_vocab_usage_byfreq.npy")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        rows[("hubert", dtype)] = check_attention(
            torch, fab, "K1 fused-out HuBERT B=8 T=319 D=768 H=12", 8, 319, 768, 12,
            True, True, dtype, gen)
        # the ViT at a small batch, the live-image training batch and the
        # image index's batch
        for b in (64, 128, 256):
            rows[("vit", b, dtype)] = check_attention(
                torch, fab, f"K1 fused-out ViT B={b} T=50 D=768 H=12", b, 50, 768, 12,
                True, False, dtype, gen)
        rows[("branch", dtype)] = check_attention(
            torch, fab, "K1 context-only branch B=8 T=320 D=768 H=8", 8, 320, 768, 8,
            False, True, dtype, gen)
        # K3 at a serving batch (B=8) and at the training batch (B=128)
        for b in (8, 128):
            rows[("vq", b, dtype)] = check_vq(torch, fk, vocab, b * 75, dtype, gen)
        rows[("hubert_drop", dtype)] = check_attention_dropout(
            torch, fab, "K1 fused-out HuBERT B=128 T=320 D=768 H=12", 128, 320, 768, 12,
            True, dtype, gen)
        rows[("branch_drop", dtype)] = check_attention_dropout(
            torch, fab, "K1 context-only branch B=128 T=321 D=768 H=8", 128, 321, 768, 8,
            False, dtype, gen)
        for p in (0.1, 0.0):
            rows[("k2", dtype, p)] = check_attention_bwd(torch, fab, vjp, dtype, p, gen)
        rows[("k3b", dtype)] = check_vq_bwd(torch, fk, vocab, dtype, gen)
        torch.cuda.empty_cache()
    check_keep_rate(torch)
    check_attention_fd(torch, vjp, gen)
    bf = torch.bfloat16
    return [
        {"name": "fused_attention_block", "route": "cuda",
         "source": "speechclip_plus_tpu_torch/csrc/fused_attention_block.cu",
         "replaces": "speechclip_plus_tpu/nn/fused_attention_block.py:118",
         "shape": "HuBERT B=128 T=320 D=768 H=12 fused-out, dropout 0.1, bf16",
         **rows[("hubert_drop", bf)]},
        {"name": "fused_attention_block_bwd", "route": "cuda",
         "source": "speechclip_plus_tpu_torch/csrc/fused_attention_block_bwd.cu",
         "replaces": "speechclip_plus_tpu/nn/fused_attention_block_vjp.py:104",
         "shape": "branch B=128 T=321 D=768 H=8, dropout 0.1, bf16", **rows[("k2", bf, 0.1)]},
        {"name": "fused_cosine_vq", "route": "cuda",
         "source": "speechclip_plus_tpu_torch/csrc/fused_keyword.cu",
         "replaces": "speechclip_plus_tpu/ops/fused_keyword.py:92",
         "shape": "N=9600 D=512 V=8112 bf16", **rows[("vq", 128, bf)],
         "at_serving_shape": {"shape": "N=600 D=512 V=8112 bf16", **rows[("vq", 8, bf)]}},
        {"name": "fused_cosine_vq_bwd", "route": "cuda",
         "source": "speechclip_plus_tpu_torch/csrc/fused_keyword.cu",
         "replaces": "speechclip_plus_tpu/ops/fused_keyword.py:123",
         "shape": "N=9600 D=512 V=8112 bf16", **rows[("k3b", bf)]},
    ]


# --------------------------------------------------------- phases 3-6 ----

def ragged_wavs(rng, b, int16):
    lens = rng.randint(2 * RATE, int(6.4 * RATE) + 1, size=b)
    wavs = [(0.1 * rng.randn(n)).astype(np.float32) for n in lens]
    if int16:
        wavs = [np.clip(w * 32767, -32768, 32767).astype(np.int16) for w in wavs]
    return wavs


def check_search(ids, scores, b, k, index_ids, what):
    require(ids.shape == (b, k) and scores.shape == (b, k), f"{what}: shapes {ids.shape}")
    require(np.isfinite(scores).all(), f"{what}: non-finite scores")
    require((np.diff(scores, axis=1) <= 0).all(), f"{what}: scores not descending")
    require(np.isin(ids, index_ids).all(), f"{what}: ids outside the index")


def phase_model(torch, counters):
    from speechclip_plus_tpu_torch.api import SpeechCLIP
    from speechclip_plus_tpu_torch.config import load_config
    from speechclip_plus_tpu_torch.serving import SpeechRetriever, build_image_index
    from speechclip_plus_tpu_torch.tasks.builder import build_model_from_config

    fab, fk = counters
    t0 = time.perf_counter()
    model, model_cfg, vocab = build_model_from_config(load_config(CONFIG), device="cuda", seed=0)
    torch.cuda.synchronize()
    print(f"[build] hybrid+ base bf16 on cuda:0 in {time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters)")
    sc = SpeechCLIP(model, "cuda")

    n_img, batch = 1000, 256
    gen = torch.Generator(device="cuda").manual_seed(1)
    images = torch.randn(n_img, 224, 224, 3, generator=gen, device="cuda")
    index_ids = np.arange(n_img) + 10000

    # every launch the main path makes is counted from here on
    fab.LAUNCHES = fk.LAUNCHES = 0
    expect_k1 = expect_k3 = 0
    t0 = time.perf_counter()
    index = build_image_index(sc, images, index_ids, batch_size=batch)
    torch.cuda.synchronize()
    expect_k1 += 12 * -(-n_img // batch)
    require(len(index) == n_img and bool(torch.isfinite(index.feats).all()), "index")
    print(f"[index] {n_img} images in {time.perf_counter() - t0:.2f} s")

    rng = np.random.RandomState(0)
    retrievers = {src: SpeechRetriever(sc, index, feat_src=src)
                  for src in ("parallel", "cascaded")}
    lat = {}
    for b in (1, 8, 64):
        for int16 in (False, True):
            wavs = ragged_wavs(rng, b, int16)
            for src, r in retrievers.items():
                times = []
                for _ in range(1 + REPS):  # the first request warms up
                    t0 = time.perf_counter()
                    ids, scores = r.search(wavs, k=10)
                    times.append(time.perf_counter() - t0)
                    expect_k1 += 13
                    expect_k3 += src == "cascaded"
                    check_search(ids, scores, b, 10, index_ids, f"{src} B={b}")
                lat[(src, b, int16)] = (times[1:], max(len(w) for w in wavs))
            out = sc.encode_speech(wavs)
            expect_k1 += 13
            expect_k3 += 1
            for key, width in (("parallel_audio_feat", 512), ("cascaded_audio_feat", 512)):
                f = out[key]
                require(tuple(f.shape) == (b, width) and bool(torch.isfinite(f.float()).all()),
                        f"encode_speech {key} B={b}: {tuple(f.shape)}")
            klen = out["dsample_results"]["dsample_feats_length"]
            require(bool(((klen >= 1) & (klen <= 75)).all()), "keywords_len out of [1, 75]")
    for (src, b, int16), (times, longest) in sorted(lat.items()):
        med = float(np.median(times))
        print(f"[serve] {src:9s} B={b:2d} {'int16' if int16 else 'fp32 '} (longest "
              f"{longest} samples): median {med * 1e3:.2f} ms/request, max "
              f"{max(times) * 1e3:.2f} ms (n={len(times)}), {b / med:.1f} utterances/s")

    batches = [ragged_wavs(rng, 8, False) for _ in range(6)]
    t0 = time.perf_counter()
    streamed = list(retrievers["cascaded"].search_stream(batches, k=10, depth=2))
    sec = time.perf_counter() - t0
    expect_k1 += 13 * len(batches)
    expect_k3 += len(batches)
    require(len(streamed) == len(batches), "search_stream lost a batch")
    for (ids, scores), wavs in zip(streamed, batches):
        check_search(ids, scores, len(wavs), 10, index_ids, "search_stream")
    ids0, _ = retrievers["cascaded"].search(batches[-1], k=10)
    expect_k1 += 13
    expect_k3 += 1
    require((ids0 == streamed[-1][0]).all(), "search_stream differs from search")
    print(f"[serve] search_stream depth=2, 6 x B=8 cascaded: {48 / sec:.1f} utterances/s")

    torch.cuda.synchronize()
    launches = {"fused_attention_block": fab.LAUNCHES, "fused_cosine_vq": fk.LAUNCHES}
    print(f"[launches] K1 {fab.LAUNCHES} (expected {expect_k1}), "
          f"K3 {fk.LAUNCHES} (expected {expect_k3})")
    require(fab.LAUNCHES == expect_k1 and fk.LAUNCHES == expect_k3,
            "launch counters do not match the serving path")
    del model, sc, index, retrievers, images
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ phase 6 ----

def train_batch(torch, b, t, image_size, seed):
    """bench.py's `_make_batch` on the device: wav_len in (2/3 T, T] with the
    first at T, zeros past each length, random images, distinct ids."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed)
    wav = torch.randn(b, t, generator=gen, device=dev)
    wav_len = t - torch.randint(0, t // 3, (b,), generator=gen, device=dev)
    wav_len[0] = t
    wav = wav.masked_fill(torch.arange(t, device=dev)[None] >= wav_len[:, None], 0.0)
    image = torch.randn(b, image_size, image_size, 3, generator=gen, device=dev)
    return {"wav": wav, "wav_len": wav_len, "image": image,
            "id": torch.arange(b, device=dev)}


def phase_train(torch, counters):
    from speechclip_plus_tpu_torch.config import load_config
    from speechclip_plus_tpu_torch.optim.optimizer import (
        build_optimizer_from_config, trainable_parameters)
    from speechclip_plus_tpu_torch.parallel.train_step import (
        create_train_state, make_train_step)
    from speechclip_plus_tpu_torch.tasks.builder import build_model_from_config

    fab, vjp, fk = counters
    cfg = load_config(CONFIG)
    t0 = time.perf_counter()
    model, model_cfg, _ = build_model_from_config(cfg, device="cuda", seed=0)
    optimizer = build_optimizer_from_config(model, cfg)
    state = create_train_state(optimizer)
    step_fn = make_train_step(model, optimizer, int(cfg.trainer.accumulate_grad_batches or 1))
    trainable = trainable_parameters(model)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if not p.requires_grad}
    before = {n: p.detach().clone() for n, p in trainable}
    bn = model.cascaded_branch.head.bn_layer
    bn_before = (bn.running_mean.clone(), bn.running_var.clone())
    batch = train_batch(torch, TRAIN_BATCH, TRAIN_WAV, model_cfg.clip.image_resolution, seed=0)
    cached = {k: v for k, v in batch.items() if k != "image"}
    with torch.no_grad():  # the product default: frozen image features cached once
        cached["image_feat"] = model.encode_image_raw(batch["image"])
    live = batch
    torch.cuda.synchronize()
    print(f"[train] hybrid+ base bf16 on cuda:0 built in {time.perf_counter() - t0:.1f} s: "
          f"{sum(p.numel() for _, p in trainable) / 1e6:.2f} M trainable (fp32: "
          f"{all(p.dtype == torch.float32 for _, p in trainable)}), "
          f"{sum(p.numel() for p in frozen.values()) / 1e6:.1f} M frozen; "
          f"B={TRAIN_BATCH} x {TRAIN_WAV} samples")
    require(all(p.dtype == torch.float32 for _, p in trainable), "trainable weights not fp32")

    gen = torch.Generator(device="cuda").manual_seed(1)
    finite = []
    hooks = [p.register_hook(lambda g: finite.append(torch.isfinite(g).all()))
             for _, p in trainable]
    expect = {"fused_attention_block": 0, "fused_attention_block_bwd": 0,
              "fused_cosine_vq": 0, "fused_cosine_vq_bwd": 0}
    # every launch the training path makes is counted from here on
    fab.LAUNCHES = vjp.LAUNCHES = fk.LAUNCHES = fk.BWD_LAUNCHES = 0
    for cell, b in (("cached", cached), ("live", live)):
        for i in range(WARMUP_STEPS):
            metrics = step_fn(state, b, gen)
            if i == 0:
                for h in hooks:
                    h.remove()
                hooks = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = []
        for _ in range(TIMED_STEPS):
            metrics = step_fn(state, b, gen)
            losses.append(metrics["train_loss"])
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / TIMED_STEPS
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n = WARMUP_STEPS + TIMED_STEPS
        expect["fused_attention_block"] += n * (13 + (12 if cell == "live" else 0))
        for k in ("fused_attention_block_bwd", "fused_cosine_vq", "fused_cosine_vq_bwd"):
            expect[k] += n
        loss = torch.stack(losses).float().cpu()
        gn = float(metrics["grad_norm"])
        print(f"[train] {cell:6s} images: {sec * 1e3:.2f} ms/step, "
              f"{TRAIN_BATCH / sec:.1f} pairs/s, peak {peak:.2f} GiB allocated "
              f"(n={TIMED_STEPS} after {WARMUP_STEPS} warm-up); loss {loss[0]:.4f} -> "
              f"{loss[-1]:.4f}, grad_norm {gn:.4f}, c_cl {float(metrics['train_c_cl_loss']):.4f}, "
              f"p_cl {float(metrics['train_p_cl_loss']):.4f}, quantity "
              f"{float(metrics['train_quantity_loss']):.4f}")
        require(bool(torch.isfinite(loss).all()), f"train {cell}: non-finite loss")
        require(gn > 0 and np.isfinite(gn), f"train {cell}: grad_norm {gn}")
    torch.cuda.synchronize()
    counts = {"fused_attention_block": fab.LAUNCHES, "fused_attention_block_bwd": vjp.LAUNCHES,
              "fused_cosine_vq": fk.LAUNCHES, "fused_cosine_vq_bwd": fk.BWD_LAUNCHES}
    print(f"[launches] training: {counts} (expected {expect})")
    require(counts == expect, "launch counters do not match the training plan")
    require(len(finite) == len(trainable) and bool(torch.stack(finite).all()),
            "a gradient is not finite")
    unchanged = [n for n, p in trainable if torch.equal(p, before[n])]
    require(not unchanged, f"trainable tensors did not change: {unchanged}")
    moved = [n for n, p in model.named_parameters() if not p.requires_grad
             and not torch.equal(p, frozen[n])]
    require(not moved, f"frozen tensors changed: {moved[:5]}")
    require(not torch.equal(bn.running_mean, bn_before[0])
            and not torch.equal(bn.running_var, bn_before[1]), "keyword-BN statistics did not move")
    print(f"[train] checks: {len(trainable)} trainable tensors all changed and all finite "
          f"gradients; {len(frozen)} frozen tensors bit-identical; keyword-BN running "
          f"statistics moved; state.step {state.step}")
    del model, optimizer, state, step_fn, frozen, before, cached, live, batch
    torch.cuda.empty_cache()
    return counts


def phase_train_parity(torch):
    """One training step (B=2, fp32, training statistics on, dropout off) on
    the card and on the CPU from the same weights."""
    from speechclip_plus_tpu_torch.config import load_config
    from speechclip_plus_tpu_torch.optim.optimizer import (
        build_optimizer_from_config, trainable_parameters)
    from speechclip_plus_tpu_torch.parallel.train_step import (
        create_train_state, make_train_step)
    from speechclip_plus_tpu_torch.tasks.builder import build_model_from_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(CONFIG)
    cfg.trainer.precision = 32
    t0 = time.perf_counter()
    cpu_model, model_cfg, _ = build_model_from_config(cfg, device="cpu", seed=0)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    batch = train_batch(torch, 2, 48000, model_cfg.clip.image_resolution, seed=3)
    batch["wav_len"] = torch.tensor([48000, 36000], device="cuda")
    batch["wav"][1, 36000:] = 0.0
    out = {}
    for dev, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        optimizer = build_optimizer_from_config(model, cfg)
        step_fn = make_train_step(model, optimizer)
        grads = {}
        hooks = [p.register_hook(lambda g, n=n: grads.__setitem__(n, g.detach().cpu().clone()))
                 for n, p in trainable_parameters(model)]
        metrics = step_fn(create_train_state(optimizer),
                          {k: v.to(dev) for k, v in batch.items()}, None)
        for h in hooks:
            h.remove()
        out[dev] = (float(metrics["train_loss"]), grads,
                    {n: p.detach().cpu() for n, p in trainable_parameters(model)})
    (lg, gg, pg), (lc, gc, pc) = out["cuda"], out["cpu"]
    rel = abs(lg - lc) / abs(lc)
    total = max(1.0, float(sum(g.pow(2).sum() for g in gc.values()) ** 0.5))
    worst, zero = 1.0, []
    for n in gc:
        a, b = gg[n].flatten().double(), gc[n].flatten().double()
        if max(a.norm().item(), b.norm().item()) <= 1e-6 * total:
            zero.append(n)  # zero in exact arithmetic: both sides hold rounding noise
            continue
        worst = min(worst, torch.nn.functional.cosine_similarity(a, b, dim=0).item())
    perr = max((pg[n] - pc[n]).abs().max().item() for n in pc)
    print(f"[parity] training step fp32 B=2, card vs CPU: loss {lg:.7f} vs {lc:.7f} (rel "
          f"{rel:.2e}), min gradient cosine {worst:.7f} over {len(gc) - len(zero)} tensors "
          f"({len(zero)} at rounding noise: {zero}), updated parameters max_abs_err "
          f"{perr:.2e} ({time.perf_counter() - t0:.1f} s)")
    require(rel <= 1e-5, f"training loss rel error {rel} > 1e-5")
    require(worst >= 0.9999, f"gradient cosine {worst} < 0.9999")
    require(perr <= 1e-5, f"updated parameters differ by {perr} > 1e-5")


def phase_parity(torch):
    from speechclip_plus_tpu_torch.api import SpeechCLIP
    from speechclip_plus_tpu_torch.config import load_config
    from speechclip_plus_tpu_torch.serving import SpeechRetriever, build_image_index
    from speechclip_plus_tpu_torch.tasks.builder import build_model_from_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(CONFIG)
    cfg.trainer.precision = 32
    t0 = time.perf_counter()
    cpu_model, _, _ = build_model_from_config(cfg, device="cpu", seed=0)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    cpu, gpu = SpeechCLIP(cpu_model, "cpu"), SpeechCLIP(gpu_model, "cuda")
    wavs = ragged_wavs(np.random.RandomState(7), 2, False)
    a, b = gpu.encode_speech(wavs), cpu.encode_speech(wavs)
    cos = torch.nn.functional.cosine_similarity(
        a["parallel_audio_feat"].cpu().float(), b["parallel_audio_feat"].float()).min().item()
    cos_c = torch.nn.functional.cosine_similarity(
        a["cascaded_audio_feat"].cpu().float(), b["cascaded_audio_feat"].float()).min().item()
    la = a["dsample_results"]["dsample_feats_length"].cpu()
    lb = b["dsample_results"]["dsample_feats_length"]
    ta, tb = a["vq_results"]["targets"].cpu()[..., 0], b["vq_results"]["targets"][..., 0]
    valid = torch.arange(ta.shape[1])[None] < lb[:, None]
    agree = (ta == tb)[valid].float().mean().item()
    print(f"[parity] fp32 card vs CPU: parallel cosine {cos:.7f}, cascaded cosine "
          f"{cos_c:.7f}, keywords_len {la.tolist()} vs {lb.tolist()}, VQ targets agree "
          f"on {agree * 100:.2f}% of valid slots")
    require(cos >= 0.9999, f"parallel cosine {cos} < 0.9999")
    require(bool((la == lb).all()), "keywords_len differ")
    require(agree >= 0.99, f"VQ targets agree on {agree:.4f} < 0.99")

    gen = torch.Generator().manual_seed(3)
    images = torch.rand(1000, 224, 224, 3, generator=gen)
    index = build_image_index(gpu, images.to("cuda"), np.arange(1000), batch_size=256)
    few = images[:4]
    fa = gpu_model.encode_image_raw(few.to("cuda")).cpu()
    with torch.inference_mode():
        fb = cpu_model.encode_image_raw(few)
    cos_i = torch.nn.functional.cosine_similarity(fa.float(), fb.float()).min().item()
    require(cos_i >= 0.9999, f"image feature cosine {cos_i} < 0.9999")
    cpu_index = copy.copy(index)
    cpu_index.feats = index.feats.cpu()
    for src in ("parallel", "cascaded"):
        ia, _ = SpeechRetriever(gpu, index, feat_src=src).search(wavs, k=10)
        ib, _ = SpeechRetriever(cpu, cpu_index, feat_src=src).search(wavs, k=10)
        require((ia == ib).all(), f"{src} top-10 ids differ: {ia} vs {ib}")
    print(f"[parity] image feature cosine {cos_i:.7f}; top-10 ids equal for parallel and "
          f"cascaded over a 1000-image index ({time.perf_counter() - t0:.1f} s)")


def profile_cell(torch, label, fn, n=3):
    """Device time by kernel over n calls of fn (torch.profiler), with the
    device's busy share of the profiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = lambda e: getattr(e, "self_device_time_total", 0) or getattr(
        e, "self_cuda_time_total", 0)
    # kernels only: CPU-side ops also report the device time of what they launched
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev(e) > 0]
    total = sum(dev(e) for e in events)
    print(f"[profile] {label}: wall {wall_us / n / 1e3:.2f} ms/call, device "
          f"{total / n / 1e3:.2f} ms/call, busy {100 * total / wall_us:.1f}% (n={n})")
    # the 16 largest, and every kernel of csrc/ (names "void (anonymous namespace)::...")
    for i, e in enumerate(sorted(events, key=dev, reverse=True)):
        if i < 16 or e.key.startswith("void (anonymous namespace)::"):
            print(f"[profile]   {dev(e) / n / 1e3:8.3f} ms {e.count // n:5d}x  {e.key[:90]}")


def phase_profile(torch):
    """Device time by kernel for three serving cells and one training cell
    (B=128 x 102400 samples, cached image features)."""
    from speechclip_plus_tpu_torch.api import SpeechCLIP
    from speechclip_plus_tpu_torch.config import load_config
    from speechclip_plus_tpu_torch.optim.optimizer import build_optimizer_from_config
    from speechclip_plus_tpu_torch.parallel.train_step import (
        create_train_state, make_train_step)
    from speechclip_plus_tpu_torch.serving import SpeechRetriever, build_image_index
    from speechclip_plus_tpu_torch.tasks.builder import build_model_from_config

    cfg = load_config(CONFIG)
    model, model_cfg, _ = build_model_from_config(cfg, device="cuda", seed=0)
    sc = SpeechCLIP(model, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    images = torch.randn(1000, 224, 224, 3, generator=gen, device="cuda")
    index = build_image_index(sc, images, np.arange(1000), batch_size=256)
    rng = np.random.RandomState(0)
    for src, b in (("parallel", 8), ("cascaded", 8), ("cascaded", 64)):
        r = SpeechRetriever(sc, index, feat_src=src)
        wavs = [(0.1 * rng.randn(102400)).astype(np.float32) for _ in range(b)]
        for _ in range(2):
            r.search(wavs, k=10)
        profile_cell(torch, f"{src} B={b} x 6.4 s query", lambda: r.search(wavs, k=10))
    del sc, index, images
    optimizer = build_optimizer_from_config(model, cfg)
    state = create_train_state(optimizer)
    step_fn = make_train_step(model, optimizer)
    batch = train_batch(torch, TRAIN_BATCH, TRAIN_WAV, model_cfg.clip.image_resolution, seed=0)
    with torch.no_grad():
        batch["image_feat"] = model.encode_image_raw(batch.pop("image"))
    for _ in range(WARMUP_STEPS):
        step_fn(state, batch, gen)
    profile_cell(torch, f"train step B={TRAIN_BATCH} x {TRAIN_WAV} cached images",
                 lambda: step_fn(state, batch, gen))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", choices=("all", "kernels", "profile"), default="all")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    major, minor = torch.cuda.get_device_capability(0)
    if major != 9:
        print(f"chip_smoke: compute capability {major}.{minor}, need 9.x", file=sys.stderr)
        return 2
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    try:
        from speechclip_plus_tpu_torch.nn import fused_attention_block as fab
        from speechclip_plus_tpu_torch.nn import fused_attention_block_vjp as vjp
        from speechclip_plus_tpu_torch.ops import fused_keyword as fk
        from speechclip_plus_tpu_torch.utils import cuda_build

        print(card_line())
        print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
              f"{torch.cuda.get_device_name(0)}")
        cuda_build.kernels()
        print(f"[build] nvcc sm_90a build {cuda_build.build_seconds():.1f} s")
        if args.phase == "profile":
            phase_profile(torch)
            return 0
        rows = phase_kernels(torch)
        if args.phase == "all":
            by_path = {"serve": phase_model(torch, (fab, fk)),
                       "train": phase_train(torch, (fab, vjp, fk))}
            phase_parity(torch)
            phase_train_parity(torch)
            # the counts of the serving (phase 5) and training (phase 6) runs,
            # each counted from 0; phase 2's comparison launches are not in them
            print(json.dumps({"kernels": [
                {**r, "launches": sum(c.get(r["name"], 0) for c in by_path.values()),
                 "launches_by_path": {p: c.get(r["name"], 0) for p, c in by_path.items()}}
                for r in rows]}))
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
