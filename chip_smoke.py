#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase (needs one H100)
    python3 chip_smoke.py --phase kernels  # build + kernel-vs-plain checks only
    python3 chip_smoke.py --phase profile  # device time by kernel, 3 serving cells

Phases, each fatal on failure:
  1. card name and power limit (nvidia-smi); build the CUDA kernels from
     speechclip_plus_tpu_torch/csrc and report the build time;
  2. every kernel of the serving path against its plain PyTorch twin on the
     card, at the path's shapes, in bf16 and fp32 (TF32 off), with the stated
     tolerances and median times over 20 runs (CUDA events);
  3. build hybrid+ base (config/speechclip_plus/base/hybrid_plus.yaml, bf16,
     seeded random weights) on cuda:0;
  4. image index from 1000 seeded random 224x224 images in batches of 256;
  5. serving: B = 1, 8, 64 ragged float32 and int16 requests through
     SpeechRetriever (parallel and cascaded), search_stream and
     SpeechCLIP.encode_speech, with launch-counter checks;
  6. slice parity: the fp32 model on the card (kernels) against the same
     weights on the CPU (plain twins).

Prints a JSON line of kernel results (with the launch counts of phase 5;
not printed by --phase kernels, which does not run the serving path) before
the last line, and as the last line {"ok": true, "device": {...}}. Exits non-zero, printing no result, when
there is no CUDA device or any phase fails.
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


def check_vq(torch, fk, vocab, dtype, gen):
    n, d, v = 8 * 75, 512, len(vocab)
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


def phase_kernels(torch):
    from speechclip_plus_tpu_torch.nn import fused_attention_block as fab
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
        rows[("vit", dtype)] = check_attention(
            torch, fab, "K1 fused-out ViT B=64 T=50 D=768 H=12", 64, 50, 768, 12,
            True, False, dtype, gen)
        rows[("branch", dtype)] = check_attention(
            torch, fab, "K1 context-only branch B=8 T=320 D=768 H=8", 8, 320, 768, 8,
            False, True, dtype, gen)
        rows[("vq", dtype)] = check_vq(torch, fk, vocab, dtype, gen)
    bf = torch.bfloat16
    return [
        {"name": "fused_attention_block", "route": "cuda",
         "source": "speechclip_plus_tpu_torch/csrc/fused_attention_block.cu",
         "replaces": "speechclip_plus_tpu/nn/fused_attention_block.py:118",
         "shape": "HuBERT B=8 T=319 D=768 H=12 fused-out bf16", **rows[("hubert", bf)]},
        {"name": "fused_cosine_vq", "route": "cuda",
         "source": "speechclip_plus_tpu_torch/csrc/fused_keyword.cu",
         "replaces": "speechclip_plus_tpu/ops/fused_keyword.py:92",
         "shape": "N=600 D=512 V=8112 bf16", **rows[("vq", bf)]},
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


def phase_profile(torch):
    """Device time by kernel for three serving cells (torch.profiler), with
    the device's busy share of the profiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from speechclip_plus_tpu_torch.api import SpeechCLIP
    from speechclip_plus_tpu_torch.config import load_config
    from speechclip_plus_tpu_torch.serving import SpeechRetriever, build_image_index
    from speechclip_plus_tpu_torch.tasks.builder import build_model_from_config

    model, _, _ = build_model_from_config(load_config(CONFIG), device="cuda", seed=0)
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
        torch.cuda.synchronize()
        n = 3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                r.search(wavs, k=10)
            wall_us = (time.perf_counter() - t0) * 1e6
        dev = lambda e: getattr(e, "self_device_time_total", 0) or getattr(
            e, "self_cuda_time_total", 0)
        # kernels only: CPU-side ops also report the device time of what they launched
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and dev(e) > 0]
        total = sum(dev(e) for e in events)
        print(f"[profile] {src} B={b} x 6.4 s: wall {wall_us / n / 1e3:.2f} ms/query, device "
              f"{total / n / 1e3:.2f} ms/query, busy {100 * total / wall_us:.1f}% (n={n})")
        for e in sorted(events, key=dev, reverse=True)[:16]:
            print(f"[profile]   {dev(e) / n / 1e3:8.3f} ms {e.count // n:5d}x  {e.key[:90]}")


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
            launches = phase_model(torch, (fab, fk))
            phase_parity(torch)
            # the counts of the serving run (phase 5) only; phase 2's
            # comparison launches are not in them
            print(json.dumps({"kernels": [
                {**r, "launches": launches[r["name"]]} for r in rows]}))
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
