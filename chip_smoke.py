#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: serving and training.

    python3 chip_smoke.py                  # every phase (needs one H100)
    python3 chip_smoke.py --phase kernels  # build + kernel-vs-plain checks only
    python3 chip_smoke.py --phase families # paths E-I and L only (no kernels line)
    python3 chip_smoke.py --phase profile  # device time by kernel: serving
                                           # cells and 5 training cells
    python3 chip_smoke.py --phase fit      # phase 6 (cached), phase J and path K only
    python3 chip_smoke.py --phase large    # phase 2 at the large shapes, then paths M and N
    python3 chip_smoke.py --phase large_fixed  # phase 2 at path N's shapes, then path N
    python3 chip_smoke.py --phase mel      # phase 2 at the base and path O shapes, then path O
    python3 chip_smoke.py --phase variants # phase 2 at the base shapes, then path P
    python3 chip_smoke.py --phase dp       # phase 2 at the base shapes, then path Q
    python3 chip_smoke.py --phase tp       # phase 2 at the base shapes and R0, then path R

Phases, each fatal on failure:
  1. card name and power limit (nvidia-smi); build the CUDA kernels from
     speechclip_plus_tpu_torch/csrc and report the build time;
  2. every kernel against its plain PyTorch twin on the card, at the main
     paths' shapes, in bf16 and fp32 (TF32 off), with the stated tolerances
     and median times over 20 runs (CUDA events), beside the one library call
     (or the labelled composite of library calls) that computes the same
     function and beside its bound, the least time the card could take: K1a,
     K1's projection GEMM, and K1b, its attention kernel, each through the
     call the block makes, at the tower's training shape; K1 (serving shapes, the ViT at B=128 and 256, with dropout at the training
     shapes, and with the per-head bias alone and gated, p=0 and 0.1, at the
     WavLM shape), K2 (p=0.1 and p=0, and against finite differences in fp32
     at T=321), K3 (N=600 and the training N=9600, on the grid of its plan,
     printed with whether it beats its twin), K3b, K4 (out and lse at
     B=8 T=1499 and B=128 T=320), K5 (p=0 and 0.1, and against K1's
     context-only mode with one seed: the same mask), K6 (B=128 x 102400);
     K1, K2, K3, K3b, K4, K5 and K6 repeat bit for bit; the dropout mask's keep
     rate;
  3. build hybrid+ base (config/speechclip_plus/base/hybrid_plus.yaml, bf16,
     seeded random weights) on cuda:0;
  4. image index from 1000 seeded random 224x224 images in batches of 256;
  5. serving: B = 1, 8, 64 ragged float32 and int16 requests through
     SpeechRetriever (parallel and cascaded), search_stream and
     SpeechCLIP.encode_speech, with launch-counter checks;
  6. training: hybrid+ base bf16, B=128 crops of 102400 samples (bench.py's
     batch), 3 warm-up and 5 timed steps with cached image features, then
     with live images; finite loss and gradients, every trainable tensor
     moved, every frozen one bit-identical, keyword-BN statistics moved,
     launch counts equal to the plan;
  7. slice parity: the fp32 model on the card (kernels) against the same
     weights on the CPU (plain twins): serving features and retrieval, and
     one training step (B=2, dropout off): loss, gradients, parameters;
  J. the training entry point: `speechclip_plus_tpu_torch.run_task
     TrainKWClip_GeneralTransformer --train` in process with
     config/speechclip_plus/base/synthetic_fit.yaml (overridden in memory) on
     a Flickr-shaped tree of 160 train and 24 dev images with 5 spoken
     captions each, written by scripts/make_synthetic_dataset.py under a
     temporary directory: hybrid+ base bf16, B=128 crops of 102400 samples,
     the image cache, two epochs with validation, keyword artifacts and
     checkpoints; then `--resume` from checkpoints/last for 3 more steps,
     whose model and Adam state must equal bit for bit those of an unbroken
     run that reads its batches through the prefetch thread;
     finite losses and recalls, the checkpoint directories and fit_state.json,
     the restored step and epoch, launch counts equal to the plan of a step,
     an eval batch and an image-cache batch; prints the loop's ms/step and
     pairs/s (the median of the Trainer's steps_per_sec windows, and all
     steps over the Trainer's passes over the loader, which hold each
     epoch's loader restart and no validation or save) beside phase 6's bare
     step, the loader wait per step and the cache, validation and save times;
  K. the inference and evaluation entry points, inside J on the directory its
     first leg saved: `api.load_from_checkpoint` of `last` (bit for bit
     against the Trainer's final model, and its `encode_speech` at B=8 against
     that model's) and of the best `val_recall_mean_10` step (against its
     file); `feature_extractor_s3prl` at B=8 (timed) and B=8, 64 (peak
     memory); `extract_keywords` at B=8 (full CLIP ids); `search_text` at B =
     1, 8, 64 over a 256-image index with config/dev/merges.txt, against a
     plain ranking; a Lightning `.ckpt` written from the same model under the
     reference's names (fairseq, OpenAI CLIP, avssl; the config pickled as
     `OrderedNamespace`), loaded back (every tensor bit for bit, pos_conv to
     1e-6 relative), and `run_task --test --ckpt` on J's tree; launch counts
     equal to the plan, K1 and K3 held at the recorded shapes;
  A. hybrid+ with the WavLM-Base+ tower (hybrid_plus_wavlm.yaml; K1 in its
     gate mode in every tower layer): serving at B = 1, 8, 64 for both
     feature sources, the training phase with cached image features, and the
     card-vs-CPU parity of serving and of one training step;
  B. hybrid+ base with `audio_encoder.fused_attention: true` and
     `fused_attention_block: false` (K5 in every tower layer): the training
     phase with cached image features and serving at B = 8;
  C. the HuBERT-base tower with `use_flash_attention` (K4 in every layer) on
     B=8 x 480000 samples (30 s), against the same tower through K1 (fp32:
     1e-4 abs; bf16: 5e-2 of the RMS), with both routes' times;
  D. `ops.conv_frontend.conv0` (K6; no model calls it) on the WavLM tower's
     layer-0 weights at B=128 x 102400, against the tower's own convolution;
  E-H. the other four families at base width (cascaded, parallel, hybrid,
     cascaded+: config/speechclip_plus/base/*.yaml, bf16): build, an image
     index, `search` with the YAML's `retrieval.audio_feat_src` at B = 1, 8,
     64 and `encode_speech`, then the training phase with cached image
     features and the checks of phase 6; the cascaded
     families run K1 and K2 at one head of 768; fp32 card-vs-CPU parity of
     serving and of one training step for cascaded;
  I. hybrid+ with `clip.text_fused_attention_vjp: true` (K1 context-only and
     K2 with the causal bias in each of the 12 text layers) against the same
     weights with the knob off: cascaded features (rms(diff)/rms <= 5e-2,
     path C's tolerance for two routes of a bf16 tower) and the first step's loss,
     ms/step and peak memory of both and of `clip.text_remat` full and attn
     with the knob off; fp32 card-vs-CPU parity with the knob on;
  L. hybrid+ with the data2vec-audio base tower (hybrid_plus_data2vec.yaml)
     through the family path (319 frames for 102400 samples), and its fp32
     card-vs-CPU parity of serving and of one training step;
  M. the large plus family (config/speechclip_plus/large/flickr/, bf16, full
     width: HuBERT-Large, ViT-L/14 and its 768-wide text tower, the 1024-wide
     branch with 8 heads of 128, the 768-wide codebook): M1 hybrid+ large
     through the family path with cached and live images, its fp32
     card-vs-CPU parity of serving and of one training step, and its cached
     step again with `clip.text_remat: full` (ms and peak memory against
     none); M2 cascaded+ large through the family path; M3 the
     `wavlm_large` and `data2vec_large` towers, one bf16 forward each at
     B=8 x 102400 samples. Every training step's peak memory must stay below
     80 GB.
  N. the fixed-K large family (config/speechclip/large/flickr/{cascaded,
     parallel}.yaml, config/speechclip_plus/large/flickr/hybrid.yaml; bf16,
     full width, `normalize_hiddenstates: true`: the s3prl layer norm of every
     hidden state in the weighted sum): N1 cascaded large and N3 hybrid large
     run K1 and K2 at one head of 1024 and K3 / K3b on the 768-wide codebook
     at N = 8 B rows, N2 parallel large K1 and K2 at 8 heads of 128; each
     through the family path with cached and live images (N3 with 11 warm-up
     steps a cell: it accumulates 4 batches), N3's fp32 card-vs-CPU parity of
     serving and of one training step, and one cached N1 cell at the YAML's
     own batch of 256 for its peak memory.
  O. the mel upstreams (bf16, full width, nothing cut; base YAMLs with
     `audio_encoder.name` and, for APC, the parallel branch's width
     overridden in memory): the log-mel frontend gives 638 frames for 102400
     samples, so the branch runs at T = 639 (hybrid+, parallel) and 638
     (cascaded+). O1 Mockingjay hybrid+ (12 post-norm layers through K1
     fused-out, 12 heads of 64 over 638 frames): phase 5's serving cells
     over 256 images with its branch and VQ shapes held, the training phase
     with cached and live images, and the fp32 card-vs-CPU parity of serving
     and of one training step; O2 APC parallel (3 cuDNN LSTM layers of 512, a
     512-wide branch of 8 heads of 64) and O3 TERA cascaded+ (3 layers, one
     head of 768 in the branch) through the family path with cached images;
     O2's LSTM tower alone in fp32 against the CPU, and its time with and
     without cuDNN's TF32.
  P. the training variants (bf16, full width, B=128 x 102400; base YAMLs with
     keys overridden in memory, VARIANT_CONFIGS), each through the family
     path (an index of 256 images, `search` at B = 1, 8, 64, `encode_speech`,
     3 warm-up and 5 timed steps a cell) with launch counts equal to the plan
     of its configuration's routes: a trainable acoustic tower takes the plain
     attention (no tower K1, in serving too), a trainable ViT the plain
     attention (no ViT K1), a trainable text tower the materialized VQ scores
     (no K3, K3b). P1 hybrid+ with `unfreeze_layers: [10, 11]` and a learnable
     VQ temperature (K3b's dt is its gradient), cached and live images: only
     layers 10 and 11, `encoder_layer_norm` and the temperature train, every
     other tower tensor bit-identical after the steps; its fp32 card-vs-CPU
     parity of one step, `d curr_temp` included. P2 cascaded+ with the whole
     tower trainable, LayerDrop 0.05, SupConLoss and the scheduled VQ
     temperature, cached images, every tower tensor moved; a second leg with
     `audio_encoder.remat: true` from the same seed and weights, and both
     legs again with deterministic algorithms (cuDNN's included), where the
     remat leg's parameters after the steps must equal the plain leg's bit
     for bit (the default algorithms' difference printed beside), each leg's
     peak memory printed. P3 cascaded (fixed K) with the text and image
     towers trainable and Gumbel VQ, live images: K3 and K3b 0 times, the
     ViT's and the text tower's tensors and the token table moved.
  Q. data parallelism through the training entry point (`run_task` with
     synthetic_fit.yaml on phase J's synthetic tree, hybrid+ base, B=128,
     bf16, the prefetch thread), each leg in a process of its own (this
     script with `--leg`): Q1 a leg without a process group over 8 steps,
     a leg under NCCL at world size 1 (torchrun's variables) over 6 steps and
     one resumed from it to 8; the NCCL legs' logged losses, validation and
     saved model and Adam state against the group-less leg's, bit for bit
     (the loss at most 1e-6 relative, or the run fails); ms/step of both
     legs, the gradient all-reduce's time and bytes a step, the launch counts
     against phase J's plan; Q2, where the machine shows two GPUs, two ranks
     (B=128 as 2 x 64, dropout off, 3 steps) against one process (loss rtol
     1e-4, `grad_norm` 1e-3), and otherwise a line that says it did not run.
  R. tensor parallelism (`parallel/tp.py`). R0, in phase 2: the shard entry
     points at the paths' shapes, tp = 2 and 4 (K1 on a range of heads:
     HuBERT base B=128 T=320 and 319, p=0.1 and 0, WavLM's gated bias,
     HuBERT-Large's 16 heads; K5 on a range of heads; K3 and K3b on a
     vocabulary shard at N=9600 and 1024, V=8112): K1's and K5's contexts bit
     for bit the whole kernels' heads, K1's fp32 partial out-projections
     summed with the bias within the whole block's check, K3's merged shards
     the whole kernel's k bit for bit (ent, psum to rtol 1e-3), K3b's summed
     shards within its tolerances; each shard against its twin; times beside
     the whole kernel's; one rank's row-parallel partial product (bf16
     operands, fp32 out) timed beside the upcast fp32 product it replaced.
     R1: `run_task` with `trainer.tensor_parallel: 2`, two ranks of one
     model group sharing the one card under gloo (this script with
     `--leg`), hybrid+ base at full width, B=128, bf16, cached images,
     crops of 2 s, on a tree of one step an epoch: a pair of rank processes
     for 3 steps (each step and collective timed) and a resume to 4, another
     for 4 steps unbroken, and one process without a group over 4, side by
     side (each fit validating and saving at its end); the resumed fit
     bit for bit the unbroken one, the checkpoint (whole tensors) loaded at
     tp=1 into exactly its tensors, step 1's loss and `grad_norm` and each
     trainable tensor's Adam first moment after 4 steps against the one
     process (rtol TP_LOSS_RTOL, TP_GRAD_NORM_RTOL, TP_MOMENT_RTOL), each
     rank's launches (K1 on a head range, K3 and K3b shards) against the plan, the
     share of step 1's keyword ids that agree; R2, two ranks under NCCL on
     two cards, where the machine shows two GPUs, and otherwise a line that
     says it did not run.
Phase 2 also holds the pieces those paths add against their twins: K2 with
the causal bias at the text shape (128, 77, 512, H=8) and K1 context-only
there, K1 and K2 at (128, 328, 768) with one head (p=0.1 and 0), each against
finite differences in fp32 (of the K1 forward, and of the same function in
float64), and K3 / K3b at N=1024 and N=8; and at path M's shapes
(`phase_kernels_large`): K1a at K=1024, K1b and K1 fused-out at the
HuBERT-Large tower shape, K1 fused-out at ViT-L/14's T=257, K1 context-only
and K2 at the large branch (128, 320, 1024, H=8) with K2's finite
differences, and K3 / K3b at N=9600 on the 768-wide codebook for V=8112 and
19787; and at path N's (`phase_kernels_large_fixed`): K1 context-only + lse and
K2 at one head of 1024 (B=128, T=327 and 328, p=0.1 and 0, K2 against finite
differences in fp32), K1 at the cascaded serving shapes (T=327, B=1, 8, 64),
and K3 / K3b at N=1024 on the 768-wide codebook; and at path O's tower shape
(`phase_kernels_mel`): K1 fused-out at (128, 638, 768, H=12), p=0.1 and 0. The
family paths and every training
phase record the shapes at which they call the branch attention and the
cosine-VQ; after each path, K1 context-only, K2, K3 and K3b are held against
their twins at every recorded shape that no earlier check covered (the
`[shapes]` lines), and those rows join the kernel line as `modes`.

Each timed training cell (phase 6, paths A, B, E-I and L-P) and phase J's
loop (its median window and its whole) also prints an `[mfu]` line: the
analytic TFLOP of the step by component (`utils/flops.py`, with cached or
live images as the cell ran), TFLOP/s at the cell's ms/step, and
`mfu_analytic`, the share of the card's dense bf16 peak from
MODEL_PEAK_TFLOPS (no share for a card that table does not name), with the
card's name and power limit. The kernel timer is `utils/timing.median_ms`.

Prints a JSON line of kernel results (the launch counts of the paths, each
counted from 0; not printed by --phase kernels, which drives no path) before
the last line, and as the last line {"ok": true, "device": {...}}. Exits
non-zero, printing no result, when there is no CUDA device or any phase
fails.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import functools
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

if __name__ == "__main__":
    # the port only where this file runs as the script: the loader's decode
    # workers re-import it as __mp_main__, and they need no torch
    from speechclip_plus_tpu_torch.utils.timing import median_ms

CONFIG = "config/speechclip_plus/base/hybrid_plus.yaml"
LARGE_CONFIGS = {  # path M, the large plus family (flickr)
    "M1 hybrid+ large": "config/speechclip_plus/large/flickr/hybrid_plus.yaml",
    "M2 cascaded+ large": "config/speechclip_plus/large/flickr/cascaded_plus.yaml",
}
VOCAB_FILES = ("assets/flickr_stat/text_clip_vocab_usage_byfreq.npy",   # V=8112
               "assets/coco_stat/text_clip_vocab_usage_byfreq.npy")     # V=19787
WAVLM_CONFIG = "config/speechclip_plus/base/hybrid_plus_wavlm.yaml"
DATA2VEC_CONFIG = "config/speechclip_plus/base/hybrid_plus_data2vec.yaml"  # path L
FAMILY_CONFIGS = {  # paths E-H
    "E cascaded": "config/speechclip_plus/base/cascaded.yaml",
    "F parallel": "config/speechclip_plus/base/parallel.yaml",
    "G hybrid": "config/speechclip_plus/base/hybrid.yaml",
    "H cascaded+": "config/speechclip_plus/base/cascaded_plus.yaml",
}
RATE = 16000
REPS = 5  # timed requests per serving cell

# published dense peaks of one H100 SXM at 700 W (NVIDIA's data sheet)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# the model-FLOP share's denominator: each card's dense bf16 tensor-core peak
# in TFLOP/s, by the name nvidia-smi reports (NVIDIA's data sheet: H100 SXM5,
# 989.4); a card not listed gets no share
MODEL_PEAK_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.4}


class SmokeFailure(RuntimeError):
    pass


def require(cond, what):
    if not cond:
        raise SmokeFailure(what)


@functools.lru_cache(maxsize=1)
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


TRAIN_BATCH, TRAIN_WAV = 128, 102400  # bench.py's training shapes


def print_mfu(label, model_cfg, batch_size, wav_len, cached, ms_per_step):
    """The model-FLOP share of a timed training step: the analytic TFLOP a
    step (`utils/flops.py`, 2 FLOPs a multiply-add, fwd+bwd multipliers, with
    cached or live images as the cell ran), TFLOP/s at `ms_per_step`, and
    `mfu_analytic`, their share of the card's dense bf16 peak, with the
    card's name and power limit; no share for a card without a known peak."""
    from speechclip_plus_tpu_torch.utils.flops import train_step_flops

    flops = train_step_flops(model_cfg, batch_size, wav_len, cached_image=cached)
    tflop = flops["total"] / 1e12
    rate = tflop / (ms_per_step / 1e3)
    card = card_line()
    name = card.split(",")[0].strip()
    peak = MODEL_PEAK_TFLOPS.get(name)
    share = (f"peak unknown for {name}" if peak is None else
             f"mfu_analytic {rate / peak:.4f} of {peak} TFLOP/s dense bf16")
    parts = ", ".join(f"{k} {v / 1e12:.4f}" for k, v in sorted(flops.items(), key=lambda kv: -kv[1])
                      if k != "total")
    print(f"[mfu] {label} {'cached' if cached else 'live'} images, B={batch_size} x {wav_len}: "
          f"{tflop:.4f} TFLOP/step analytic ({parts}); {rate:.2f} TFLOP/s at "
          f"{ms_per_step:.2f} ms/step; {share} ({card})")
WARMUP_STEPS, TIMED_STEPS = 3, 5


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(flops, moved_bytes, dtype):
    """The least time the card could take: the larger of the operations over
    the peak rate of their type and the bytes (each input read once, each
    output written once) over the memory rate."""
    ops_ms = flops / PEAK_FLOPS[str(dtype)[6:]] * 1e3
    bytes_ms = moved_bytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def block_flops(b, t, d, heads, fuse_out):
    """qkv projection + the two attention products [+ out projection]."""
    return 2 * b * t * d * 3 * d + 4 * b * t * t * d + (2 * b * t * d * d if fuse_out else 0)


def timing_text(r):
    lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
    return (f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library {lib}, bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}")


KERNEL_COUNTERS = {  # kernel name -> (module under speechclip_plus_tpu_torch, counter)
    "fused_attention_block": ("nn.fused_attention_block", "LAUNCHES"),
    # K1's projection GEMM (K1a), its own wrapper: two launches per fused-out
    # block, one per context-only block
    "projection_gemm": ("nn.fused_attention_block", "PROJECTION_LAUNCHES"),
    "fused_attention_block_bwd": ("nn.fused_attention_block_vjp", "LAUNCHES"),
    "fused_cosine_vq": ("ops.fused_keyword", "LAUNCHES"),
    "fused_cosine_vq_bwd": ("ops.fused_keyword", "BWD_LAUNCHES"),
    "flash_attention": ("nn.flash", "LAUNCHES"),
    "fused_attention_dropout": ("nn.fused_attention", "LAUNCHES"),
    "conv0": ("ops.conv_frontend", "LAUNCHES"),
    # subsets of the K1 and K2 counts: the wide-head kernels for one head of
    # 768, and K2 launches that read a per-head bias
    "fused_attention_block_dh768": ("nn.fused_attention_block", "WIDE_LAUNCHES"),
    "fused_attention_block_bwd_dh768": ("nn.fused_attention_block_vjp", "WIDE_LAUNCHES"),
    "fused_attention_block_bwd_attn_bias": ("nn.fused_attention_block_vjp", "BIAS_LAUNCHES"),
    # the large family's new widths: K1 and K2 at 8 heads of 128 (the 1024-wide
    # branch), K3 and K3b on the 768-wide codebook (K3b's 32-row tile)
    "fused_attention_block_dh128": ("nn.fused_attention_block", "DH128_LAUNCHES"),
    "fused_attention_block_bwd_dh128": ("nn.fused_attention_block_vjp", "DH128_LAUNCHES"),
    "fused_cosine_vq_d768": ("ops.fused_keyword", "D768_LAUNCHES"),
    "fused_cosine_vq_bwd_d768": ("ops.fused_keyword", "BWD_D768_LAUNCHES"),
    # the fixed-K large branches: K1 and K2 at one head of 1024
    "fused_attention_block_dh1024": ("nn.fused_attention_block", "DH1024_LAUNCHES"),
    "fused_attention_block_bwd_dh1024": ("nn.fused_attention_block_vjp", "DH1024_LAUNCHES"),
    # tensor parallelism (path R): K1 on a range of heads (a subset of the K1
    # count), K3 and K3b on a vocabulary shard (their halves around the group's
    # gather: one a wrapper call)
    "fused_attention_block_shard": ("nn.fused_attention_block", "SHARD_LAUNCHES"),
    "fused_cosine_vq_shard": ("ops.fused_keyword", "SHARD_LAUNCHES"),
    "fused_cosine_vq_bwd_shard": ("ops.fused_keyword", "BWD_SHARD_LAUNCHES"),
}


# the head dims whose K1 and K2 launches are counted again on their own
HEAD_COUNTERS = {768: "_dh768", 128: "_dh128", 1024: "_dh1024"}


def _counter(name):
    import importlib
    module, attr = KERNEL_COUNTERS[name]
    return importlib.import_module("speechclip_plus_tpu_torch." + module), attr


def reset_counts():
    """Every wrapper's launch count to 0: a path is counted from here."""
    for name in KERNEL_COUNTERS:
        setattr(*_counter(name), 0)


def read_counts(torch, label, expect):
    """The launch counts since `reset_counts`, which must equal the plan
    (`expect`; kernels it does not name must not have run)."""
    torch.cuda.synchronize()
    return compare_counts(label, {name: getattr(*_counter(name)) for name in KERNEL_COUNTERS},
                          expect)


def compare_counts(label, counts, expect):
    """`counts` (a path's launches, here or from a process of its own) must
    equal the plan."""
    expect = {name: expect.get(name, 0) for name in KERNEL_COUNTERS}
    short = lambda d: {k: v for k, v in d.items() if v}
    print(f"[launches] {label}: {short(counts)} (expected {short(expect)})")
    require(counts == expect, f"launch counters do not match the plan of {label}")
    return counts

# ------------------------------------------------------------- phase 2 ----

# every (kernel, shape, dropout, dtype) that a check of this run held against
# its twin, with the row it measured: the family paths look their own shapes
# up here and check the ones that are missing (`check_path_shapes`)
CHECKED = {}


def checked(kind, shape, p, dtype, row):
    key = (kind, tuple(shape), float(p), str(dtype)[6:])
    CHECKED[key] = row
    return row


def library_block(torch, x, w_in, b_in, w_out, b_out, bias, heads, fuse_out, p=0.0,
                  ab=None, gate=None):
    """The block as a composite of library calls (cuBLAS + SDPA) in x's dtype,
    timed beside the kernel (the plain twin computes in fp32, like the
    kernel). A per-head bias, gated or not, becomes SDPA's (B, H, T, T) mask;
    dropout is SDPA's own (another mask than the kernel's)."""
    F = torch.nn.functional
    b, t, d = x.shape
    q, k, v = (a.reshape(b, t, heads, -1).transpose(1, 2)
               for a in F.linear(x, w_in, b_in).split(d, dim=-1))
    mask = None if bias is None else bias[:, None, None, :]
    if ab is not None:
        full = ab[None] if gate is None else gate[..., None] * ab[None]
        mask = full if mask is None else mask + full
    if mask is not None:
        mask = mask.to(x.dtype)
    ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, dropout_p=p)
    ctx = ctx.transpose(1, 2).reshape(b, t, d)
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
    require(torch.equal(got, kern().float()), f"{name} {dtype}: two runs differ")
    # the plain twin on the same values in fp32, with no bf16 rounding of the
    # context: for bf16 the error includes the kernel's rounding of it
    f32 = [a if a is None else a.float() for a in args]
    want = fab.plain_fused_attention_block(*f32, heads, fuse_out)
    twin_err = (got - plain().float()).abs().max().item()
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
    err, ok, tol = compare(torch, got, want, dtype, fp32_abs=1e-4)
    if dtype == torch.bfloat16:
        tol += f"; vs the bf16 twin {twin_err:.3e}"
    moved = nbytes(x, w_in, b_in, bias, got.to(dtype)) + (nbytes(w_out, b_out) if fuse_out else 0)
    row = {"max_abs_err": err, "ms": median_ms(kern), "plain_ms": median_ms(plain),
           **bound(block_flops(b, t, d, heads, fuse_out), moved, dtype),
           "library_ms": median_ms(lambda: library_block(torch, *args, heads, fuse_out)),
           "library": "composite: cuBLAS linear + SDPA [+ cuBLAS linear]"}
    print(f"[kernel] {name} {str(dtype)[6:]}: max_abs_err={err:.3e} ({tol}) {timing_text(row)}")
    require(ok, f"{name} {dtype}: error {err} over tolerance ({tol})")
    return row if fuse_out else checked("k1", (b, t, d, heads), 0.0, dtype, row)


def check_block_parts(torch, fab, dtype, gen, b=128, t=320, d=768, heads=12):
    """K1's kernels apart, each through the call `_launch` makes, at the
    tower's training shape: K1a through its wrapper `projection` (the qkv
    projection into the fp32 buffer with q scaled, and the out-projection),
    against `plain_projection` and beside `F.linear`; K1b through `_attention`
    on that buffer, with and without dropout, against the context of
    `plain_fused_attention_block(..., return_aux=True)` on the same x, beside
    SDPA. Returns (K1a rows, K1b rows)."""
    from speechclip_plus_tpu_torch.ops.random import draw_seed

    F = torch.nn.functional
    dh = d // heads
    x, w_in, b_in, w_out, b_out, bias = block_inputs(torch, b, t, d, dtype, gen)
    name = f"B={b} T={t} D={d} H={heads} {str(dtype)[6:]}"

    def gemm_row(what, call, plain, ref, out_dtype, flops, inputs, library):
        got = call()
        require(torch.equal(got, call()), f"K1a {what} {name}: two runs differ")
        err, ok, tol = compare(torch, got, ref(), out_dtype)  # ref: the twin, not rounded
        require(ok, f"K1a {what} {name}: error {err} ({tol})")
        row = {"max_abs_err": err, "ms": median_ms(call), "plain_ms": median_ms(plain),
               **bound(flops, nbytes(*inputs, got), dtype),
               "library_ms": median_ms(library),
               "library": "F.linear in the working dtype (cuBLAS"
                          + ("; no scale, output not fp32)" if out_dtype != dtype else ")")}
        print(f"[kernel] K1a projection GEMM {what} {name}: max_abs_err={err:.3e} ({tol}), "
              f"bit-identical rerun; {timing_text(row)}")
        return got, row

    gemm, attn = [], []
    qkv_kw = dict(scale_cols=d, scale=dh ** -0.5)
    qkv, row = gemm_row("qkv", lambda: fab.projection(x, w_in, b_in, **qkv_kw),
                        lambda: fab.plain_projection(x, w_in, b_in, **qkv_kw),
                        lambda: fab.plain_projection(x, w_in, b_in, **qkv_kw), torch.float32,
                        2 * b * t * d * 3 * d, (x, w_in, b_in), lambda: F.linear(x, w_in, b_in))
    gemm.append({"shape": f"qkv projection (M={b * t}, N={3 * d}, K={d}, fp32 out, q scaled), "
                          f"HuBERT {name}", **row})
    ctx = None
    for p in (0.0, 0.1):
        seeds = draw_seed(torch.Generator(device="cuda").manual_seed(23)) if p else None
        call = lambda: fab._attention(qkv, bias, heads, dtype, seeds, 1.0 - p, None, None,
                                      False)[0]
        got = call()
        require(torch.equal(got, call()), f"K1b {name}: two runs differ")
        twin = lambda: fab.plain_fused_attention_block(
            x, w_in, b_in, None, None, bias, heads, False, seeds=seeds, keep_prob=1.0 - p,
            return_aux=True)[0]
        want = fab.plain_fused_attention_block(
            x.float(), w_in.float(), b_in.float(), None, None, bias, heads, False, seeds=seeds,
            keep_prob=1.0 - p, return_aux=True)[0]
        err, ok, tol = compare(torch, got, want, dtype, fp32_abs=1e-4)
        require(ok, f"K1b attention kernel {name} p={p}: error {err} ({tol})")
        q, k, v = (a.reshape(b, t, heads, dh).transpose(1, 2).to(dtype)
                   for a in qkv.split(d, dim=-1))
        mask = bias[:, None, None, :].to(dtype)
        row = {"max_abs_err": err, "ms": median_ms(call),
               "plain_ms": median_ms(twin),
               "plain": "the context-only twin, its fp32 qkv projection included",
               **bound(4 * b * t * t * d, nbytes(qkv, bias, got), dtype),
               "library_ms": median_ms(lambda: F.scaled_dot_product_attention(
                   q, k, v, attn_mask=mask, dropout_p=p, scale=1.0)),
               "library": "scaled_dot_product_attention with a key mask on q, k, v in the "
                          "working dtype"}
        print(f"[kernel] K1b attention kernel {name} p={p}: max_abs_err={err:.3e} ({tol}), "
              f"bit-identical rerun; {timing_text(row)}")
        attn.append({"shape": f"K1b attention kernel, dropout {p}, HuBERT {name}", **row})
        ctx = got if ctx is None else ctx
        del want, q, k, v
    _, row = gemm_row("out", lambda: fab.projection(ctx, w_out, b_out, out_dtype=dtype),
                      lambda: fab.plain_projection(ctx, w_out, b_out, out_dtype=dtype),
                      lambda: fab.plain_projection(ctx, w_out, b_out), dtype,
                      2 * b * t * d * d, (ctx, w_out, b_out), lambda: F.linear(ctx, w_out, b_out))
    gemm.append({"shape": f"out-projection (M={b * t}, N={d}, K={d}, {str(dtype)[6:]} out), "
                          f"HuBERT {name}", **row})
    return gemm, attn


def check_vq(torch, fk, vocab, n, dtype, gen, d=512):
    """K3 at N rows (D=512, or 768: the large family; V of the vocabulary)
    against its twin, on the grid its plan gives: targets equal where the
    top-2 margin is decided, ent and psum to rtol 1e-3, a bit-identical
    rerun."""
    v = len(vocab)
    x = torch.randn(n, d, generator=gen, device="cuda")
    x = (x / x.norm(dim=-1, keepdim=True)).to(dtype).contiguous()
    emb = torch.randn(v, d, generator=gen, device="cuda") * 0.1
    en = (emb / emb.norm(dim=-1, keepdim=True)).to(dtype).contiguous()
    special = (0, vocab.sot_reduced, vocab.eot_reduced)
    mask = fk.column_mask(v, special, "cuda")
    kern = lambda: fk.cosine_vq_stats(x, en, mask)
    plain = lambda: fk.plain_cosine_vq_stats(x, en, mask)
    (k1, e1, p1), again, (k0, e0, p0) = kern(), kern(), plain()
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(again, (k1, e1, p1))),
            f"K3 {dtype}: two runs differ")
    s = (x.float() @ en.float().T).masked_fill(mask.bool()[None], -1e30)
    top2 = s.topk(2, dim=-1).values
    del s
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
    # the grid the wrapper launched: row tiles x V splits
    rows, splits = fk._fwd_plan(n, v, d, dtype, fk._sm_count(x.device))
    plan = {"rows": rows, "splits": splits, "blocks": -(-n // rows) * splits}
    # one N x D x V product; no single library call computes targets, entropy
    # and column sums without the (N, V) tensor
    row = {"max_abs_err": max(ent_err, psum_err), "max_abs_err_of": "ent, psum",
           "ent_max_abs_err": ent_err, "psum_max_abs_err": psum_err,
           "target_mismatches_decided": mismatches, "decided_rows": int(decided.sum()),
           "ms": median_ms(kern), "plain_ms": median_ms(plain),
           **bound(2 * n * d * v, nbytes(x, en, mask, k1, e1, p1), dtype), "library_ms": None,
           "plan": plan}
    print(f"[kernel] K3 cosine_vq N={n} D={d} V={v} {str(dtype)[6:]}, plan {rows} rows x "
          f"{splits} splits = {plan['blocks']} blocks: targets equal on "
          f"{int(decided.sum())}/{n} decided rows, ent max_abs_err={ent_err:.3e}, "
          f"psum max_abs_err={psum_err:.3e} (rtol 1e-3), bit-identical rerun; "
          f"{timing_text(row)}; {'faster' if row['ms'] < row['plain_ms'] else 'SLOWER'} "
          f"than the twin")
    return checked("k3", (n, d, v), 0.0, dtype, row)


def compare(torch, got, want, dtype, fp32_abs=None):
    """(max abs error, ok, tolerance text). fp32: abs <= 1e-4 x max(1, RMS), or
    <= `fp32_abs`; bf16: the error beyond half a bf16 ulp of the plain value
    <= 2e-2 x RMS (K1's tolerances). A correctly rounded bf16 result is
    already up to half an ulp of its largest values away, which exceeds
    2e-2 x RMS when max/RMS > ~5, so the tolerance applies to the error beyond
    that rounding."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    rms = want.pow(2).mean().sqrt().item()
    if dtype == torch.float32:
        limit = fp32_abs if fp32_abs is not None else 1e-4 * max(1.0, rms)
        return err, err <= limit, f"abs <= {limit:.2e}"
    _, exp = torch.frexp(want)
    half_ulp = torch.ldexp(torch.ones_like(want), exp - 9)
    excess = ((got - want).abs() - half_ulp).clamp_min(0).max().item()
    return (err, excess <= 2e-2 * rms,
            f"abs/rms(plain) = {err / rms:.3e}; beyond half a bf16 ulp {excess / rms:.3e} <= 2e-2")


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
        require(torch.equal(got, kern()[0]), f"{name} {dtype}: two runs differ")
        want, _, lse0 = fab.plain_fused_attention_block(
            f32[0], f32[1], f32[2], None, None, bias, heads, False, seeds=seeds,
            keep_prob=0.9, return_aux=True)
        lse_err = (lse - lse0).abs().max().item()
        require(lse_err <= 1e-4, f"{name}: lse error {lse_err} > 1e-4")
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite kernel output")
    err, ok, tol = compare(torch, got, want, dtype)
    moved = nbytes(*args[:3], args[5], got)
    moved += nbytes(*args[3:5]) if fuse_out else b * t * 3 * d * 4 + b * heads * t * 4
    row = {"max_abs_err": err, "ms": median_ms(kern), "plain_ms": median_ms(plain),
           **bound(block_flops(b, t, d, heads, fuse_out), moved, dtype),
           "library_ms": median_ms(lambda: library_block(torch, *args, heads, fuse_out,
                                                                p=0.1)),
           "library": "composite: cuBLAS linear + SDPA with dropout_p [+ cuBLAS linear]"}
    print(f"[kernel] {name} p=0.1 {str(dtype)[6:]}: max_abs_err={err:.3e} ({tol}), lse "
          f"max_abs_err={lse_err:.3e} {timing_text(row)}")
    require(ok, f"{name} {dtype}: error {err} over tolerance ({tol})")
    return row if fuse_out else checked("k1", (b, t, d, heads), 0.1, dtype, row)


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


def causal_bias(torch, t):
    """The text tower's causal mask as the kernels' per-head bias, (1, T, T)."""
    return torch.full((t, t), -1e30, device="cuda").triu(1)[None]


def library_backward(torch, qkv, bias, ab, dctx, heads, dtype, p):
    """The backward of plain attention as a composite of library calls:
    autograd through cuBLAS products and a masked softmax in the working
    dtype, from a forward that saved its (B, H, T, T) weights (K2 saves
    none). Returns the timed call."""
    b, t, d3 = qkv.shape
    d = d3 // 3
    q, k, v = (a.reshape(b, t, heads, -1).transpose(1, 2).to(dtype).requires_grad_()
               for a in qkv.split(d, dim=-1))
    s = torch.matmul(q, k.transpose(-1, -2)).float() + bias[:, None, None, :]
    if ab is not None:
        s = s + ab[None]
    w = torch.nn.functional.dropout(torch.softmax(s, dim=-1).to(dtype), p)
    ctx = torch.matmul(w, v).transpose(1, 2).reshape(b, t, d)
    g = dctx.to(dtype)
    return lambda: torch.autograd.grad(ctx, (q, k, v), g, retain_graph=True)


def check_attention_bwd(torch, fab, vjp, dtype, p, gen, shape=(128, 321, 768, 8), causal=False,
                        what="branch"):
    """K2 against its twin, from one K1 forward: at the branch shape, at one
    head of 768, or at the text shape with the causal bias."""
    from speechclip_plus_tpu_torch.ops.random import draw_seed

    b, t, d, heads = shape
    x, w_in, b_in, _, _, bias = block_inputs(torch, b, t, d, dtype, gen)
    ab = causal_bias(torch, t) if causal else None
    if causal:
        bias[-1, 1] = -1e30  # a masked key that is above the diagonal for query 0
    seeds = draw_seed(torch.Generator(device="cuda").manual_seed(5)) if p > 0 else None
    keep = 1.0 - p
    ctx, qkv, lse = fab.attention_forward(x, w_in, b_in, bias, n_heads=heads, seeds=seeds,
                                          keep_prob=keep, attn_bias=ab)
    dctx = torch.randn(b, t, d, generator=gen, device="cuda").to(dtype)
    kern = lambda: vjp.attention_backward(qkv, bias, dctx, ctx, lse, n_heads=heads,
                                          seeds=seeds, keep_prob=keep, attn_bias=ab)
    plain = lambda: vjp.plain_attention_backward(qkv, bias, dctx, ctx, lse, heads, seeds, keep,
                                                 ab)
    got, again = kern(), kern()
    want = vjp.plain_attention_backward(qkv, bias, dctx.float(), ctx.float(), lse, heads,
                                        seeds, keep, ab)
    torch.cuda.synchronize()
    name = f"K2 attention backward {what} B={b} T={t} D={d} H={heads} p={p}" \
           + (" causal bias" if causal else "")
    require(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite dqkv")
    require(torch.equal(got, again), f"{name} {dtype}: two runs differ")
    err, ok, tol = compare(torch, got, want, dtype)
    del want, again
    # five T x T x dh products per head (s, dp, dv, dq, dk); no single library
    # call takes the saved qkv, lse and the counter mask: the composite is the
    # backward of plain attention from its saved weights
    row = {"max_abs_err": err, "ms": median_ms(kern), "plain_ms": median_ms(plain),
           **bound(10 * b * t * t * d, nbytes(qkv, bias, ab, dctx, ctx, lse, got), dtype),
           "library_ms": median_ms(library_backward(torch, qkv, bias, ab, dctx, heads,
                                                           dtype, p)),
           "library": "composite: autograd backward through cuBLAS products and a masked "
                      "softmax, from saved (B, H, T, T) weights"}
    print(f"[kernel] {name} {str(dtype)[6:]}: max_abs_err={err:.3e} ({tol}), bit-identical "
          f"rerun; {timing_text(row)}")
    require(ok, f"{name} {dtype}: error {err} over tolerance ({tol})")
    return checked("k2 causal" if causal else "k2", shape, p, dtype, row)


def check_attention_causal(torch, fab, dtype, gen, b=128):
    """K1 context-only at the text shape (B, 77, 512, H=8) with the causal
    bias: context and lse against the twin; library: cuBLAS + SDPA with the
    (T, T) mask."""
    t, d, heads = 77, 512, 8
    name = f"K1 context-only text B={b} T={t} D={d} H={heads} causal bias"
    x, w_in, b_in, w_out, b_out, _ = block_inputs(torch, b, t, d, dtype, gen, padded=False)
    ab = causal_bias(torch, t)
    kern = lambda: fab.attention_forward(x, w_in, b_in, None, n_heads=heads, attn_bias=ab)
    plain = lambda: fab.plain_fused_attention_block(x, w_in, b_in, None, None, None, heads,
                                                    False, return_aux=True, attn_bias=ab)
    (got, _, lse), (again, _, lse2) = kern(), kern()
    want, _, lse0 = fab.plain_fused_attention_block(
        x.float(), w_in.float(), b_in.float(), None, None, None, heads, False, return_aux=True,
        attn_bias=ab)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite kernel output")
    require(torch.equal(got, again) and torch.equal(lse, lse2), f"{name}: two runs differ")
    lse_err = (lse - lse0).abs().max().item()
    require(lse_err <= 1e-4, f"{name}: lse error {lse_err} > 1e-4")
    err, ok, tol = compare(torch, got, want, dtype)
    moved = nbytes(x, w_in, b_in, ab, got, lse) + b * t * 3 * d * 4
    row = {"max_abs_err": err, "ms": median_ms(kern), "plain_ms": median_ms(plain),
           **bound(block_flops(b, t, d, heads, False), moved, dtype),
           "library_ms": median_ms(lambda: library_block(
               torch, x, w_in, b_in, w_out, b_out, None, heads, False, ab=ab)),
           "library": "composite: cuBLAS linear + SDPA with a (T, T) mask"}
    print(f"[kernel] {name} {str(dtype)[6:]}: max_abs_err={err:.3e} ({tol}), lse max_abs_err="
          f"{lse_err:.3e}, bit-identical rerun; {timing_text(row)}")
    require(ok, f"{name} {dtype}: error {err} over tolerance ({tol})")
    return checked("k1 causal", (b, t, d, heads), 0.0, dtype, row)


def attention_fp64(torch, x, w_in, b_in, bias, ab, heads, seeds, keep):
    """The K1 forward's context in float64, with the kernels' dropout mask."""
    from speechclip_plus_tpu_torch.ops.random import attention_keep_mask

    b, t, d = x.shape
    qkv = torch.nn.functional.linear(x.double(), w_in.double(), b_in.double())
    q, k, v = (a.reshape(b, t, heads, -1).transpose(1, 2) for a in qkv.split(d, dim=-1))
    s = q @ k.transpose(-1, -2) * (d // heads) ** -0.5 + bias.double()[:, None, None, :]
    if ab is not None:
        s = s + ab.double()[None]
    w = torch.softmax(s, dim=-1)
    if seeds is not None:
        w = torch.where(attention_keep_mask(seeds, b, heads, t, keep), w / keep, 0.0)
    return (w @ v).transpose(1, 2).reshape(b, t, d)


def check_attention_fd(torch, vjp, gen, shape=(2, 321, 768, 8), p=0.1, causal=False,
                       what="branch"):
    """K2 against finite differences in fp32: directional derivatives of
    sum(probe * ctx) along random directions v of x, Wqkv and bqkv. Two
    central differences: of the K1 forward itself at eps = 1e-2, and of the
    same function in float64 at eps = 1e-4, which has neither the rounding
    noise nor the truncation error of the first (their difference is printed:
    it is the fp32 central difference's own error). The first is held to 1e-2
    and the second to 1e-4 of the larger of the derivative and
    |g| |v| / sqrt(n), the size a random direction's derivative has: a
    direction that happens to cancel below that is judged by the error the
    others are allowed."""
    from speechclip_plus_tpu_torch.ops.random import draw_seed

    b, t, d, heads = shape
    x, w_in, b_in, _, _, bias = block_inputs(torch, b, t, d, torch.float32, gen)
    ab = causal_bias(torch, t) if causal else None
    seeds = draw_seed(torch.Generator(device="cuda").manual_seed(9)) if p else None
    probe = torch.randn(b, t, d, generator=gen, device="cuda")
    loss = lambda *a: (vjp._AttnCore.apply(*a, bias, heads, seeds, 1.0 - p, ab) * probe).sum()
    loss64 = lambda *a: (attention_fp64(torch, *a, bias, ab, heads, seeds, 1.0 - p)
                         * probe.double()).sum()
    inputs = (x, w_in, b_in)
    params = [a.clone().requires_grad_() for a in inputs]
    grads = torch.autograd.grad(loss(*params), params)
    worst = worst64 = 0.0
    for i, (name, a, g) in enumerate(zip(("x", "Wqkv", "bqkv"), inputs, grads)):
        v = torch.randn(a.shape, generator=gen, device="cuda")
        v = v / v.norm() * a.norm()
        moved = lambda f, e: [f(c) + e * f(v) if j == i else f(c) for j, c in enumerate(inputs)]
        with torch.no_grad():
            fd = ((loss(*moved(lambda c: c, 1e-2)) - loss(*moved(lambda c: c, -1e-2)))
                  / 2e-2).item()
            fd64 = ((loss64(*moved(torch.Tensor.double, 1e-4))
                     - loss64(*moved(torch.Tensor.double, -1e-4))) / 2e-4).item()
        an = (g.double() * v.double()).sum().item()
        typical = (g.norm() * v.norm()).item() / a.numel() ** 0.5
        rel = abs(fd - an) / max(abs(fd), typical)
        rel64 = abs(fd64 - an) / max(abs(fd64), typical)
        worst, worst64 = max(worst, rel), max(worst64, rel64)
        print(f"[kernel] K2 finite differences fp32 {what} T={t} H={heads} p={p}"
              f"{' causal bias' if causal else ''} along {name}: K2 {an:.6e}, central "
              f"difference of K1 {fd:.6e} (rel {rel:.2e}), of the float64 forward {fd64:.6e} "
              f"(rel {rel64:.2e}); the fp32 difference's own error {abs(fd - fd64):.2e}; a "
              f"random direction's size {typical:.2e}")
    require(worst <= 1e-2, f"K2 finite differences ({what}): rel error {worst} > 1e-2")
    require(worst64 <= 1e-4,
            f"K2 against the float64 differences ({what}): rel error {worst64} > 1e-4")


def check_vq_bwd(torch, fk, vocab, dtype, gen, n=128 * 75, d=512):
    """K3b at N rows (9600: the plus families; 1024: the fixed-K ones), D=512
    (768: the large family), V of the vocabulary, against its twin."""
    v = len(vocab)
    x = torch.randn(n, d, generator=gen, device="cuda")
    x = (x / x.norm(dim=-1, keepdim=True)).to(dtype).contiguous()
    g = (torch.randn(n, d, generator=gen, device="cuda") * 1e-3).to(dtype).contiguous()
    emb = torch.randn(v, d, generator=gen, device="cuda") * 0.1
    norms = emb.norm(dim=-1).clamp_min(1e-8).contiguous()
    en = (emb / norms[:, None]).to(dtype).contiguous()
    mask = fk.column_mask(v, (0, vocab.sot_reduced, vocab.eot_reduced), "cuda")
    temp = torch.full((), 0.1, device="cuda")  # read by the kernel from device memory
    kern = lambda: fk.st_backward(x, g, en, norms, mask, temp)
    plain = lambda: fk.plain_st_backward(x, g, en, norms, mask, temp)
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
    # the grid the wrapper launched: row tiles x V splits
    rows, splits = fk._bwd_plan(n, v, d, dtype, fk._sm_count(x.device))
    plan = {"rows": rows, "splits": splits, "blocks": -(-n // rows) * splits}
    # three N x D x V products (s, u, dx); no single library call
    row = {"max_abs_err": err, "max_abs_err_of": "dx", "dt_abs_err": dt_err,
           "ms": median_ms(kern), "plain_ms": median_ms(plain),
           **bound(6 * n * d * v, nbytes(x, g, en, norms, mask, dx, dt), dtype),
           "library_ms": None, "plan": plan}
    print(f"[kernel] K3b ST backward N={n} D={d} V={v} {str(dtype)[6:]}, plan {rows} rows x "
          f"{splits} splits = {plan['blocks']} blocks: dx max_abs_err="
          f"{err:.3e} (<= {tol:g} x RMS {rms:.3e}), dt {dt.item():.6e} vs {dt0.item():.6e} "
          f"(err {dt_err:.3e} <= 1e-4 x sum|terms| {dt_scale:.3e}), bit-identical rerun; "
          f"{timing_text(row)}; {'faster' if row['ms'] < row['plain_ms'] else 'SLOWER'} "
          f"than the twin")
    require(err <= tol * rms, f"K3b {dtype}: dx error {err} > {tol} x RMS {rms}")
    require(dt_err <= 1e-4 * dt_scale, f"K3b {dtype}: dt error {dt_err}")
    return checked("k3b", (n, d, v), 0.0, dtype, row)


def check_attention_bias(torch, fab, gated, p, dtype, gen):
    """K1 at the WavLM shape (B=128, T=320, D=768, H=12, fused-out) with the
    per-head bias alone or gated, with or without dropout, against its twin
    on the same (seed, offset); the context-only mode's lse with the bias."""
    from speechclip_plus_tpu_torch.ops.random import draw_seed

    b, t, d, heads = 128, 320, 768, 12
    name = f"K1 fused-out WavLM B={b} T={t} D={d} H={heads} {'gate' if gated else 'bias'} p={p}"
    args = block_inputs(torch, b, t, d, dtype, gen)
    ab = torch.randn(heads, t, t, generator=gen, device="cuda")
    gate = 1.0 + torch.rand(b, heads, t, generator=gen, device="cuda") if gated else None
    kw = dict(attn_bias=ab, attn_gate=gate)
    if p:
        kw.update(seeds=draw_seed(torch.Generator(device="cuda").manual_seed(13)),
                  keep_prob=1.0 - p)
    f32 = [a.float() for a in args[:5]] + [args[5]]
    kern = lambda: fab._run(*args, heads, True, **kw)
    plain = lambda: fab.plain_fused_attention_block(*args, heads, True, **kw)
    got, again = kern(), kern()
    want = fab.plain_fused_attention_block(*f32, heads, True, **kw)
    _, _, lse = fab._run(*args[:3], None, None, args[5], heads, False, return_aux=True, **kw)
    _, _, lse0 = fab.plain_fused_attention_block(*f32[:3], None, None, args[5], heads, False,
                                                 return_aux=True, **kw)
    torch.cuda.synchronize()
    lse_err = (lse - lse0).abs().max().item()
    del lse, lse0
    require(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite kernel output")
    require(torch.equal(got, again), f"{name} {dtype}: two runs differ")
    require(lse_err <= 1e-4, f"{name}: lse error {lse_err} > 1e-4")
    err, ok, tol = compare(torch, got, want, dtype)
    del want
    row = {"max_abs_err": err, "ms": median_ms(kern), "plain_ms": median_ms(plain),
           **bound(block_flops(b, t, d, heads, True), nbytes(*args, ab, gate, got), dtype),
           "library_ms": median_ms(lambda: library_block(
               torch, *args, heads, True, p=p, ab=ab, gate=gate)),
           "library": "composite: cuBLAS linear + (B, H, T, T) mask + SDPA + cuBLAS linear"}
    print(f"[kernel] {name} {str(dtype)[6:]}: max_abs_err={err:.3e} ({tol}), lse max_abs_err="
          f"{lse_err:.3e}, bit-identical rerun; {timing_text(row)}")
    require(ok, f"{name} {dtype}: error {err} over tolerance ({tol})")
    return row


def packed_qkv(torch, b, h, t, dh, dtype, gen):
    """q, k, v (B, H, T, dh) as the tower gives them: strided views of one
    packed (B, T, 3D) projection; and a ragged key bias."""
    qkv = torch.randn(b, t, 3, h, dh, generator=gen, device="cuda").to(dtype)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    lens = torch.randint(t // 2, t + 1, (b,), generator=gen, device="cuda")
    lens[0] = t
    kb = torch.where(torch.arange(t, device="cuda")[None] >= lens[:, None], -1e30, 0.0)
    return q, k, v, kb


def check_fused_attention(torch, b, t, p, dtype, gen):
    """K5 at the tower's shape against its twin on the same (seed, offset);
    library: SDPA with the key mask (and its own dropout for p > 0)."""
    from speechclip_plus_tpu_torch.nn import fused_attention as fa
    from speechclip_plus_tpu_torch.ops.random import draw_seed

    h, dh = 12, 64
    name = f"K5 fused_attention_dropout B={b} H={h} T={t} dh={dh} p={p}"
    q, k, v, kb = packed_qkv(torch, b, h, t, dh, dtype, gen)
    seeds = draw_seed(torch.Generator(device="cuda").manual_seed(17)) if p else None
    kern = lambda: fa._run(q, k, v, kb, seeds, 1.0 - p)
    plain = lambda: fa.plain_fused_attention_dropout(q, k, v, kb, seeds, 1.0 - p)
    got, again = kern(), kern()
    want = fa.plain_fused_attention_dropout(q.float(), k.float(), v.float(), kb, seeds, 1.0 - p)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite kernel output")
    require(torch.equal(got, again), f"{name} {dtype}: two runs differ")
    err, ok, tol = compare(torch, got, want, dtype)
    del want
    mask = kb[:, None, None, :].to(dtype)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row = {"max_abs_err": err, "ms": median_ms(kern), "plain_ms": median_ms(plain),
           **bound(4 * b * h * t * t * dh, nbytes(q, k, v, kb, got), dtype),
           "library_ms": median_ms(lambda: sdpa(q, k, v, attn_mask=mask, dropout_p=p)),
           "library": "scaled_dot_product_attention with a key mask"
                      + (" and dropout_p" if p else "")}
    print(f"[kernel] {name} {str(dtype)[6:]}: max_abs_err={err:.3e} ({tol}), bit-identical "
          f"rerun; {timing_text(row)}")
    require(ok, f"{name} {dtype}: error {err} over tolerance ({tol})")
    return row


def check_flash(torch, b, t, dtype, gen):
    """K4 (out and lse) against its twin; library: SDPA with the key mask."""
    from speechclip_plus_tpu_torch.nn import flash

    h, dh = 12, 64
    name = f"K4 flash_attention B={b} H={h} T={t} dh={dh}"
    q, k, v, kb = packed_qkv(torch, b, h, t, dh, dtype, gen)
    kern = lambda: flash.flash_forward(q, k, v, kb)
    plain = lambda: flash.plain_flash_attention(q, k, v, kb)
    (got, lse), (again, lse2) = kern(), kern()
    want, lse0 = flash.plain_flash_attention(q.float(), k.float(), v.float(), kb)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got.float()).all() and torch.isfinite(lse).all()),
            f"{name}: non-finite kernel output")
    require(torch.equal(got, again) and torch.equal(lse, lse2), f"{name} {dtype}: two runs differ")
    lse_err = (lse - lse0).abs().max().item()
    require(lse_err <= 1e-4, f"{name}: lse error {lse_err} > 1e-4")
    err, ok, tol = compare(torch, got, want, dtype)
    del want, lse0
    mask = kb[:, None, None, :].to(dtype)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row = {"max_abs_err": err, "lse_max_abs_err": lse_err, "ms": median_ms(kern),
           "plain_ms": median_ms(plain),
           **bound(4 * b * h * t * t * dh, nbytes(q, k, v, kb, got, lse), dtype),
           "library_ms": median_ms(lambda: sdpa(q, k, v, attn_mask=mask)),
           "library": "scaled_dot_product_attention with a key mask (no lse output)"}
    print(f"[kernel] {name} {str(dtype)[6:]}: max_abs_err={err:.3e} ({tol}), lse max_abs_err="
          f"{lse_err:.3e} (<= 1e-4), bit-identical rerun; {timing_text(row)}")
    require(ok, f"{name} {dtype}: error {err} over tolerance ({tol})")
    return row


def check_same_mask(torch, fab, dtype, gen):
    """K5 on the q, k, v that K1's context-only mode projects, with one
    (seed, offset): the same mask, so the same context (K1's tolerances; K1
    rounds its context to x's dtype)."""
    from speechclip_plus_tpu_torch.nn import fused_attention as fa
    from speechclip_plus_tpu_torch.ops.random import draw_seed

    b, t, d, heads = 16, 320, 768, 12
    x, w_in, b_in, _, _, kb = block_inputs(torch, b, t, d, dtype, gen)
    seeds = draw_seed(torch.Generator(device="cuda").manual_seed(19))
    ctx, qkv, _ = fab.attention_forward(x, w_in, b_in, kb, n_heads=heads, seeds=seeds,
                                        keep_prob=0.9)
    q, k, v = qkv.view(b, t, 3, heads, d // heads).permute(2, 0, 3, 1, 4).unbind(0)
    q = q * (d // heads) ** 0.5  # K1's buffer holds q scaled; K5 scales q itself
    merge = lambda o: o.transpose(1, 2).reshape(b, t, d)
    same = merge(fa._run(q, k, v, kb, seeds, 0.9))
    other = merge(fa._run(q, k, v, kb, seeds + 1, 0.9))
    torch.cuda.synchronize()
    err, ok, tol = compare(torch, ctx, same, dtype)
    differ = (other - same).abs().max().item()
    print(f"[kernel] K5 vs K1 context-only, one (seed, offset), B={b} T={t} p=0.1 "
          f"{str(dtype)[6:]}: max_abs_err={err:.3e} ({tol}); another seed differs by {differ:.3e}")
    require(ok, f"K5 and K1 draw different masks from one seed ({dtype}): {err}")
    require(differ > 1e-2, "K5: another seed gave the same context")


def check_conv0(torch, dtype, gen):
    """K6 at B=128 x 102400 samples, C=512, k=10, s=5 against its twin;
    library: F.conv1d (whose output is channel-first, (B, C, T0))."""
    from speechclip_plus_tpu_torch.ops import conv_frontend as cf

    b, t, c, k, s = TRAIN_BATCH, TRAIN_WAV, 512, 10, 5
    name = f"K6 conv0 B={b} T={t} C={c} k={k} s={s}"
    wav = torch.randn(b, t, generator=gen, device="cuda").to(dtype)
    kernel = (torch.randn(k, 1, c, generator=gen, device="cuda") * k ** -0.5).to(dtype)
    kern = lambda: cf.conv0(wav, kernel, stride=s, out_dtype=dtype)
    plain = lambda: cf.plain_conv0(wav, kernel, s, dtype)
    got = kern()
    require(torch.equal(got, kern()), f"{name} {dtype}: two runs differ")
    want = cf.plain_conv0(wav, kernel, s, torch.float32)
    torch.cuda.synchronize()
    t0 = (t - k) // s + 1
    require(tuple(got.shape) == (b, t0, c) and got.dtype == dtype, f"{name}: {tuple(got.shape)}")
    require(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite kernel output")
    err, ok, tol = compare(torch, got, want, dtype)
    del want
    weight = kernel.permute(2, 1, 0).contiguous()
    conv1d = torch.nn.functional.conv1d
    lib = conv1d(wav[:, None], weight, stride=s).transpose(1, 2)
    lib_err = (lib.float() - got.float()).abs().max().item()
    del lib
    row = {"max_abs_err": err, "ms": median_ms(kern),
           "plain_ms": median_ms(plain, runs=5, warmup=1),
           **bound(2 * b * t0 * c * k, nbytes(wav, kernel, got), dtype),
           "library_ms": median_ms(lambda: conv1d(wav[:, None], weight, stride=s)),
           "library": "F.conv1d (channel-first output)"}
    print(f"[kernel] {name} {str(dtype)[6:]}: max_abs_err={err:.3e} ({tol}), vs F.conv1d "
          f"{lib_err:.3e}, bit-identical rerun; {timing_text(row)}")
    require(ok, f"{name} {dtype}: error {err} over tolerance ({tol})")
    return row


# rows of `check_path_shapes`, (kernel name, row), joined to the `kernels` line
PATH_ROWS = []


def record_shapes(torch, model):
    """Forward pre-hooks that note the shape at which a path calls every
    differentiable attention block of `model` (K1 context-only; K2 as well
    when gradients are on) and every cosine-VQ (K3; K3b). Returns the set
    they fill, of (kind, shape, dropout, in a training step), and the hooks."""
    from speechclip_plus_tpu_torch.models.branches import SimpleVectorQuantizer
    from speechclip_plus_tpu_torch.nn.attention import MultiheadAttention

    seen = set()

    def attention(module, args, kwargs):
        b, t, d = args[0].shape
        p = module.dropout if kwargs.get("generator") is not None else 0.0
        kind = "k1 causal" if kwargs.get("attn_bias") is not None else "k1"
        seen.add((kind, (b, t, d, module.nhead), p, torch.is_grad_enabled()))

    def vq(module, args, kwargs):
        xn, emb = args[0], args[1]
        c = module.cfg
        if not (module.fused_score_kernel and c.time_first):
            return  # the materialized scores: no K3
        training = len(args) > 3 and args[3]
        seen.add(("k3", (xn.numel() // xn.shape[-1], xn.shape[-1], emb.shape[0]), 0.0,
                  torch.is_grad_enabled() and (not training or (c.hard and not c.use_gumbel))))

    hooks = []
    for m in model.modules():
        if isinstance(m, MultiheadAttention) and not m.fuse_out and m.kernel:
            hooks.append(m.register_forward_pre_hook(attention, with_kwargs=True))
        elif isinstance(m, SimpleVectorQuantizer):
            hooks.append(m.register_forward_pre_hook(vq, with_kwargs=True))
    return seen, hooks


def check_path_shapes(torch, label, seen):
    """Holds K1 context-only, K2, K3 and K3b against their twins at every
    shape in `seen` (what `record_shapes` noted on a path) that no earlier
    check of this run covered, in fp32 and bf16. Called between paths: its
    launches are in no path's count."""
    from speechclip_plus_tpu_torch.data.tokenizer import ReducedVocab
    from speechclip_plus_tpu_torch.nn import fused_attention_block as fab
    from speechclip_plus_tpu_torch.nn import fused_attention_block_vjp as vjp
    from speechclip_plus_tpu_torch.ops import fused_keyword as fk

    vocabs = {len(v): v for v in (ReducedVocab.from_npy(path) for path in VOCAB_FILES)}
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(17)
    backward = {"k1": "k2", "k1 causal": "k2 causal", "k3": "k3b"}
    found = []
    for kind, shape, p, step in sorted(seen):
        require(p in (0.0, 0.1), f"{label}: dropout {p} has no check")
        dh = None if kind == "k3" else shape[2] // shape[3]
        at = HEAD_COUNTERS.get(dh, "")
        d768 = "_d768" * (kind == "k3" and shape[1] == 768)
        names = {"k1": "fused_attention_block" + at,
                 "k2": "fused_attention_block_bwd" + at,
                 "k1 causal": "fused_attention_block",
                 "k2 causal": "fused_attention_block_bwd_attn_bias",
                 "k3": "fused_cosine_vq" + d768, "k3b": "fused_cosine_vq_bwd" + d768}
        for k in [kind] + [backward[kind]] * step:
            for dtype in (torch.float32, torch.bfloat16):
                key = (k, shape, float(p), str(dtype)[6:])
                found.append(key)
                if key in CHECKED:
                    continue
                what = f"{label} B={shape[0]}" if len(shape) == 4 else label
                if k == "k1":
                    name = "K1 context-only {} T={} D={} H={}".format(what, *shape[1:])
                    if p:
                        row = check_attention_dropout(torch, fab, name, *shape, False, dtype, gen)
                    else:
                        row = check_attention(torch, fab, name + " p=0", *shape, False, True,
                                              dtype, gen)
                elif k == "k1 causal":
                    row = check_attention_causal(torch, fab, dtype, gen, b=shape[0])
                elif k in ("k2", "k2 causal"):
                    row = check_attention_bwd(torch, fab, vjp, dtype, p, gen, shape,
                                              causal=k == "k2 causal", what=label)
                elif k == "k3":
                    row = check_vq(torch, fk, vocabs[shape[2]], shape[0], dtype, gen, d=shape[1])
                else:
                    row = check_vq_bwd(torch, fk, vocabs[shape[2]], dtype, gen, n=shape[0],
                                       d=shape[1])
                PATH_ROWS.append((names[k], {
                    "shape": f"{label}: {k} at {shape}, dropout {p}, {str(dtype)[6:]}", **row}))
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    missing = [key for key in found if key not in CHECKED]
    require(not missing, f"{label}: shapes held against no twin: {missing}")
    print(f"[shapes] {label}: every shape the path gave K1 context-only, K2, K3 and K3b is held "
          f"against its twin in fp32 and bf16: "
          + "; ".join(sorted({f"{k} {shape} p={p}" for k, shape, p, _ in found})))


def phase_kernels(torch):
    from speechclip_plus_tpu_torch.nn import fused_attention_block as fab
    from speechclip_plus_tpu_torch.nn import fused_attention_block_vjp as vjp
    from speechclip_plus_tpu_torch.ops import fused_keyword as fk
    from speechclip_plus_tpu_torch.data.tokenizer import ReducedVocab

    vocab = ReducedVocab.from_npy("assets/flickr_stat/text_clip_vocab_usage_byfreq.npy")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, gemm, parts = {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        gemm[dtype], parts[dtype] = check_block_parts(torch, fab, dtype, gen)
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
        # the tower's block at the training batch: no dropout and no bias, with
        # dropout, and the WavLM modes beside them at the same shape
        rows[("hubert_128", dtype)] = check_attention(
            torch, fab, "K1 fused-out HuBERT B=128 T=320 D=768 H=12", 128, 320, 768, 12,
            True, True, dtype, gen)
        rows[("hubert_drop", dtype)] = check_attention_dropout(
            torch, fab, "K1 fused-out HuBERT B=128 T=320 D=768 H=12", 128, 320, 768, 12,
            True, dtype, gen)
        for gated in (False, True):
            for p in (0.0, 0.1):
                rows[("gate" if gated else "bias", p, dtype)] = check_attention_bias(
                    torch, fab, gated, p, dtype, gen)
                torch.cuda.empty_cache()
        rows[("branch_drop", dtype)] = check_attention_dropout(
            torch, fab, "K1 context-only branch B=128 T=321 D=768 H=8", 128, 321, 768, 8,
            False, dtype, gen)
        for p in (0.1, 0.0):
            rows[("k2", dtype, p)] = check_attention_bwd(torch, fab, vjp, dtype, p, gen)
        rows[("k3b", dtype)] = check_vq_bwd(torch, fk, vocab, dtype, gen)
        torch.cuda.empty_cache()
        # the fixed-K families: K3 at N = 8 keywords x B (training B=128, one
        # query) and K3b at N = 1024
        for n in (1024, 8):
            rows[("vq_n", n, dtype)] = check_vq(torch, fk, vocab, n, dtype, gen)
        rows[("k3b_1024", dtype)] = check_vq_bwd(torch, fk, vocab, dtype, gen, n=1024)
        # the text tower's fused route: K1 context-only and K2 with the causal
        # bias at (128, 77, 512), 8 heads
        text = (128, 77, 512, 8)
        rows[("text_k1", dtype)] = check_attention_causal(torch, fab, dtype, gen)
        rows[("text_k2", dtype)] = check_attention_bwd(torch, fab, vjp, dtype, 0.0, gen, text,
                                                       causal=True, what="text")
        # the cascaded families: one head of 768 over [8 keyword CLS; 320 frames]
        wide = (128, 328, 768, 1)
        rows[("wide_k1", dtype, 0.1)] = check_attention_dropout(
            torch, fab, "K1 context-only cascaded B=128 T=328 D=768 H=1", *wide, False, dtype,
            gen)
        rows[("wide_k1", dtype, 0.0)] = check_attention(
            torch, fab, "K1 context-only cascaded B=128 T=328 D=768 H=1 p=0", *wide, False,
            True, dtype, gen)
        for p in (0.1, 0.0):
            rows[("wide_k2", dtype, p)] = check_attention_bwd(torch, fab, vjp, dtype, p, gen,
                                                              wide, what="cascaded")
        torch.cuda.empty_cache()
        # cascaded+ has no CLS rows (T=320, one head of 768); hybrid prepends
        # 1 + 8 of them to 8 heads of 96 (T=329)
        for key, shape in (("plus", (128, 320, 768, 1)), ("hybrid", (128, 329, 768, 8))):
            name = "K1 context-only {} B={} T={} D={} H={}".format(
                "cascaded+" if key == "plus" else key, *shape)
            rows[(key, "k1", dtype, 0.1)] = check_attention_dropout(
                torch, fab, name, *shape, False, dtype, gen)
            rows[(key, "k1", dtype, 0.0)] = check_attention(
                torch, fab, name + " p=0", *shape, False, True, dtype, gen)
            for p in (0.1, 0.0):
                rows[(key, "k2", dtype, p)] = check_attention_bwd(
                    torch, fab, vjp, dtype, p, gen, shape, what=name.split()[2])
            torch.cuda.empty_cache()
        # the dh=768 K1 at the cascaded families' serving batches (p=0, ragged
        # lengths), and K3 at their N = 8 x B
        for b in (1, 8, 64):
            rows[("wide_serve", b, dtype)] = check_attention(
                torch, fab, f"K1 context-only cascaded serving B={b} T=327 D=768 H=1 p=0",
                b, 327, 768, 1, False, True, dtype, gen)
        for n in (64, 512):
            rows[("vq_n", n, dtype)] = check_vq(torch, fk, vocab, n, dtype, gen)
        for p in (0.0, 0.1):
            rows[("k5", 128, p, dtype)] = check_fused_attention(torch, 128, 320, p, dtype, gen)
        rows[("k5", 8, 0.0, dtype)] = check_fused_attention(torch, 8, 320, 0.0, dtype, gen)
        check_same_mask(torch, fab, dtype, gen)
        for b, t in ((8, 1499), (128, 320)):
            rows[("k4", b, dtype)] = check_flash(torch, b, t, dtype, gen)
        torch.cuda.empty_cache()
        rows[("k6", dtype)] = check_conv0(torch, dtype, gen)
        torch.cuda.empty_cache()
    check_keep_rate(torch)
    check_attention_fd(torch, vjp, gen)
    check_attention_fd(torch, vjp, gen, (2, 328, 768, 1), 0.1, what="cascaded")
    check_attention_fd(torch, vjp, gen, (2, 77, 512, 8), 0.0, causal=True, what="text")
    check_attention_fd(torch, vjp, gen, (2, 77, 512, 8), 0.1, causal=True, what="text")
    bf, f32 = torch.bfloat16, torch.float32
    csrc = "speechclip_plus_tpu_torch/csrc/"
    jax_pkg = "speechclip_plus_tpu/"
    wavlm = "WavLM B=128 T=320 D=768 H=12 fused-out, bf16, "
    return [
        {"name": "projection_gemm", "route": "cuda", "source": csrc + "fused_attention_block.cu",
         "replaces": jax_pkg + "nn/fused_attention_block.py:153",
         **gemm[bf][0], "modes": gemm[bf][1:] + gemm[f32]},
        {"name": "fused_attention_block", "route": "cuda",
         "source": csrc + "fused_attention_block.cu",
         "replaces": jax_pkg + "nn/fused_attention_block.py:118",
         "shape": "HuBERT B=128 T=320 D=768 H=12 fused-out, dropout 0.1, bf16",
         **rows[("hubert_drop", bf)],
         "parts": parts[bf] + parts[f32],
         "modes": [
             {"shape": "HuBERT B=128 T=320 D=768 H=12 fused-out, no dropout, bf16",
              **rows[("hubert_128", bf)]},
             {"shape": wavlm + "bias only, no dropout", **rows[("bias", 0.0, bf)]},
             {"shape": wavlm + "bias only, dropout 0.1", **rows[("bias", 0.1, bf)]},
             {"shape": wavlm + "gated bias, no dropout", **rows[("gate", 0.0, bf)]},
             {"shape": wavlm + "gated bias, dropout 0.1", **rows[("gate", 0.1, bf)]},
             {"shape": "WavLM B=128 T=320 fused-out, fp32, gated bias, dropout 0.1",
              **rows[("gate", 0.1, f32)]},
             {"shape": "branch B=128 T=321 D=768 H=8 context-only + lse, dropout 0.1, bf16",
              **rows[("branch_drop", bf)]},
             {"shape": "HuBERT B=8 T=319 fused-out, no dropout, bf16", **rows[("hubert", bf)]},
             {"shape": "ViT B=128 T=50 fused-out, bf16", **rows[("vit", 128, bf)]},
         ] + [{"shape": f"hybrid B=128 T=329 D=768 H=8 context-only + lse, dropout {p}, "
                        f"{str(dt)[6:]}", **rows[("hybrid", "k1", dt, p)]}
              for dt in (bf, f32) for p in (0.1, 0.0)]},
        {"name": "fused_attention_block_bwd", "route": "cuda",
         "source": csrc + "attention_bwd.cuh",
         "replaces": jax_pkg + "nn/fused_attention_block_vjp.py:104",
         "shape": "branch B=128 T=321 D=768 H=8, dropout 0.1, bf16", **rows[("k2", bf, 0.1)],
         "modes": [{"shape": "same, no dropout", **rows[("k2", bf, 0.0)]}] + [
             {"shape": f"hybrid B=128 T=329 D=768 H=8, dropout {p}, {str(dt)[6:]}",
              **rows[("hybrid", "k2", dt, p)]} for dt in (bf, f32) for p in (0.1, 0.0)]},
        {"name": "fused_attention_block_dh768", "route": "cuda",
         "source": csrc + "attention_core.cuh",
         "replaces": jax_pkg + "nn/fused_attention_block.py:118",
         "shape": "cascaded B=128 T=328 D=768 H=1 context-only + lse, dropout 0.1, bf16",
         **rows[("wide_k1", bf, 0.1)],
         "modes": [{"shape": "same, no dropout", **rows[("wide_k1", bf, 0.0)]},
                   {"shape": "same, dropout 0.1, fp32", **rows[("wide_k1", f32, 0.1)]}] + [
             {"shape": f"cascaded+ B=128 T=320 D=768 H=1, dropout {p}, {str(dt)[6:]}",
              **rows[("plus", "k1", dt, p)]} for dt in (bf, f32) for p in (0.1, 0.0)] + [
             {"shape": f"cascaded serving B={b} T=327 D=768 H=1, no dropout, {str(dt)[6:]}",
              **rows[("wide_serve", b, dt)]} for dt in (bf, f32) for b in (1, 8, 64)]},
        {"name": "fused_attention_block_bwd_dh768", "route": "cuda",
         "source": csrc + "attention_bwd.cuh",
         "replaces": jax_pkg + "nn/fused_attention_block_vjp.py:104",
         "shape": "cascaded B=128 T=328 D=768 H=1, dropout 0.1, bf16",
         **rows[("wide_k2", bf, 0.1)],
         "modes": [{"shape": "same, no dropout", **rows[("wide_k2", bf, 0.0)]},
                   {"shape": "same, dropout 0.1, fp32", **rows[("wide_k2", f32, 0.1)]}] + [
             {"shape": f"cascaded+ B=128 T=320 D=768 H=1, dropout {p}, {str(dt)[6:]}",
              **rows[("plus", "k2", dt, p)]} for dt in (bf, f32) for p in (0.1, 0.0)]},
        {"name": "fused_attention_block_bwd_attn_bias", "route": "cuda",
         "source": csrc + "attention_bwd.cuh",
         "replaces": jax_pkg + "nn/fused_attention_block_vjp.py:104",
         "shape": "text B=128 T=77 D=512 H=8 with the causal bias, no dropout, bf16",
         **rows[("text_k2", bf)],
         "modes": [{"shape": "same, fp32", **rows[("text_k2", f32)]},
                   {"shape": "K1 context-only + lse at the same shape with the bias, bf16 "
                             "(counted under fused_attention_block)", **rows[("text_k1", bf)]}]},
        {"name": "fused_cosine_vq", "route": "cuda", "source": csrc + "fused_keyword.cu",
         "replaces": jax_pkg + "ops/fused_keyword.py:92",
         "shape": "N=9600 D=512 V=8112 bf16", **rows[("vq", 128, bf)],
         "at_serving_shape": {"shape": "N=600 D=512 V=8112 bf16", **rows[("vq", 8, bf)]},
         "modes": [{"shape": "N=1024 (fixed-K training) bf16", **rows[("vq_n", 1024, bf)]},
                   {"shape": "N=8 (one fixed-K query) bf16", **rows[("vq_n", 8, bf)]},
                   {"shape": "N=64 (fixed-K queries, B=8) bf16", **rows[("vq_n", 64, bf)]},
                   {"shape": "N=512 (fixed-K queries, B=64) bf16", **rows[("vq_n", 512, bf)]},
                   {"shape": "N=9600 fp32 (FMA tile)", **rows[("vq", 128, f32)]},
                   {"shape": "N=1024 fp32 (FMA tile)", **rows[("vq_n", 1024, f32)]}]},
        {"name": "fused_cosine_vq_bwd", "route": "cuda", "source": csrc + "fused_keyword.cu",
         "replaces": jax_pkg + "ops/fused_keyword.py:123",
         "shape": "N=9600 D=512 V=8112 bf16", **rows[("k3b", bf)],
         "modes": [{"shape": "N=1024 (fixed-K training) bf16", **rows[("k3b_1024", bf)]},
                   {"shape": "N=9600 fp32 (FMA tile)", **rows[("k3b", f32)]},
                   {"shape": "N=1024 fp32 (FMA tile)", **rows[("k3b_1024", f32)]}]},
        {"name": "flash_attention", "route": "cuda", "source": csrc + "flash.cu",
         "replaces": jax_pkg + "nn/flash.py:47",
         "shape": "B=8 H=12 T=1499 dh=64 bf16, out + lse", **rows[("k4", 8, bf)],
         "modes": [{"shape": "B=128 H=12 T=320 dh=64 bf16", **rows[("k4", 128, bf)]},
                   {"shape": "B=8 H=12 T=1499 dh=64 fp32", **rows[("k4", 8, f32)]}]},
        {"name": "fused_attention_dropout", "route": "cuda", "source": csrc + "fused_attention.cu",
         "replaces": jax_pkg + "nn/fused_attention.py:67",
         "shape": "B=128 H=12 T=320 dh=64 bf16, dropout 0.1", **rows[("k5", 128, 0.1, bf)],
         "modes": [{"shape": "B=128, no dropout, bf16", **rows[("k5", 128, 0.0, bf)]},
                   {"shape": "B=8, no dropout, bf16 (serving)", **rows[("k5", 8, 0.0, bf)]},
                   {"shape": "B=128, dropout 0.1, fp32", **rows[("k5", 128, 0.1, f32)]}]},
        {"name": "conv0", "route": "cuda", "source": csrc + "conv_frontend.cu",
         "replaces": jax_pkg + "ops/conv_frontend.py:45",
         "shape": "B=128 T=102400 C=512 k=10 s=5 bf16", **rows[("k6", bf)],
         "modes": [{"shape": "same, fp32", **rows[("k6", f32)]}]},
    ]


def phase_kernels_large(torch):
    """Phase 2 at the large family's shapes: K1a at K=1024 (the tower's qkv,
    N=3072, and out-projection) and K1b at the HuBERT-Large tower shape
    (B=128, T=319, 16 heads of 64) through `check_block_parts`; K1 fused-out
    at the tower's training (dropout) and serving shapes and at ViT-L/14's
    (T=257) for the live step's batch and the index's; K1 context-only + lse
    and K2 at the 1024-wide branch (B=128, T=320, 8 heads of 128), p=0.1 and
    0, and K2 against finite differences in fp32; K3 and K3b at N=9600 on the
    768-wide codebook for both reduced vocabularies. Returns (the rows of the
    four kernels at the new widths, extra modes by kernel name)."""
    from speechclip_plus_tpu_torch.data.tokenizer import ReducedVocab
    from speechclip_plus_tpu_torch.nn import fused_attention_block as fab
    from speechclip_plus_tpu_torch.nn import fused_attention_block_vjp as vjp
    from speechclip_plus_tpu_torch.ops import fused_keyword as fk

    vocabs = {name: ReducedVocab.from_npy(path)
              for name, path in zip(("flickr", "coco"), VOCAB_FILES)}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(40)
    branch = (128, 320, 1024, 8)
    rows, gemm, parts = {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        gemm[dtype], parts[dtype] = check_block_parts(torch, fab, dtype, gen, b=128, t=319,
                                                      d=1024, heads=16)
        rows[("tower", 0.1, dtype)] = check_attention_dropout(
            torch, fab, "K1 fused-out HuBERT-Large B=128 T=319 D=1024 H=16", 128, 319, 1024,
            16, True, dtype, gen)
        rows[("tower", 0.0, dtype)] = check_attention(
            torch, fab, "K1 fused-out HuBERT-Large B=8 T=319 D=1024 H=16", 8, 319, 1024, 16,
            True, True, dtype, gen)
        for b in (128, 256):  # the live step's images, the image index's batch
            rows[("vit", b, dtype)] = check_attention(
                torch, fab, f"K1 fused-out ViT-L/14 B={b} T=257 D=1024 H=16", b, 257, 1024, 16,
                True, False, dtype, gen)
        torch.cuda.empty_cache()
        name = "K1 context-only large branch B={} T={} D={} H={}".format(*branch)
        rows[("k1", 0.1, dtype)] = check_attention_dropout(torch, fab, name, *branch, False,
                                                           dtype, gen)
        rows[("k1", 0.0, dtype)] = check_attention(torch, fab, name + " p=0", *branch, False,
                                                   True, dtype, gen)
        for p in (0.1, 0.0):
            rows[("k2", p, dtype)] = check_attention_bwd(torch, fab, vjp, dtype, p, gen, branch,
                                                         what="large branch")
        torch.cuda.empty_cache()
        for voc, vocab in vocabs.items():
            rows[("k3", voc, dtype)] = check_vq(torch, fk, vocab, 9600, dtype, gen, d=768)
            rows[("k3b", voc, dtype)] = check_vq_bwd(torch, fk, vocab, dtype, gen, n=9600, d=768)
        torch.cuda.empty_cache()
    check_attention_fd(torch, vjp, gen, (2, 320, 1024, 8), 0.1, what="large branch")
    check_attention_fd(torch, vjp, gen, (2, 319, 1024, 8), 0.0, what="large branch")
    bf, f32 = torch.bfloat16, torch.float32
    csrc = "speechclip_plus_tpu_torch/csrc/"
    jax_pkg = "speechclip_plus_tpu/"
    mode = lambda text, key: {"shape": text, **rows[key]}
    new = [
        {"name": "fused_attention_block_dh128", "route": "cuda",
         "source": csrc + "fused_attention_block_attn_dh128.cu",
         "replaces": jax_pkg + "nn/fused_attention_block.py:118",
         "shape": "large branch B=128 T=320 D=1024 H=8 context-only + lse, dropout 0.1, bf16",
         **rows[("k1", 0.1, bf)],
         "modes": [mode("same, no dropout", ("k1", 0.0, bf)),
                   mode("same, dropout 0.1, fp32", ("k1", 0.1, f32)),
                   mode("same, no dropout, fp32", ("k1", 0.0, f32))]},
        {"name": "fused_attention_block_bwd_dh128", "route": "cuda",
         "source": csrc + "fused_attention_block_bwd_dh128.cu",
         "replaces": jax_pkg + "nn/fused_attention_block_vjp.py:104",
         "shape": "large branch B=128 T=320 D=1024 H=8, dropout 0.1, bf16",
         **rows[("k2", 0.1, bf)],
         "modes": [mode("same, no dropout", ("k2", 0.0, bf)),
                   mode("same, dropout 0.1, fp32", ("k2", 0.1, f32)),
                   mode("same, no dropout, fp32", ("k2", 0.0, f32))]},
        {"name": "fused_cosine_vq_d768", "route": "cuda", "source": csrc + "fused_keyword.cu",
         "replaces": jax_pkg + "ops/fused_keyword.py:92",
         "shape": "N=9600 D=768 V=8112 bf16", **rows[("k3", "flickr", bf)],
         "modes": [mode("N=9600 D=768 V=19787 bf16", ("k3", "coco", bf)),
                   mode("N=9600 D=768 V=8112 fp32 (FMA tile)", ("k3", "flickr", f32)),
                   mode("N=9600 D=768 V=19787 fp32 (FMA tile)", ("k3", "coco", f32))]},
        {"name": "fused_cosine_vq_bwd_d768", "route": "cuda", "source": csrc + "fused_keyword.cu",
         "replaces": jax_pkg + "ops/fused_keyword.py:123",
         "shape": "N=9600 D=768 V=8112 bf16 (32-row tile)", **rows[("k3b", "flickr", bf)],
         "modes": [mode("N=9600 D=768 V=19787 bf16", ("k3b", "coco", bf)),
                   mode("N=9600 D=768 V=8112 fp32 (FMA tile)", ("k3b", "flickr", f32)),
                   mode("N=9600 D=768 V=19787 fp32 (FMA tile)", ("k3b", "coco", f32))]},
    ]
    extra = {
        "projection_gemm": gemm[bf] + gemm[f32],
        "fused_attention_block": [
            mode("HuBERT-Large B=128 T=319 D=1024 H=16 fused-out, dropout 0.1, bf16",
                 ("tower", 0.1, bf)),
            mode("HuBERT-Large B=8 T=319 D=1024 H=16 fused-out, no dropout, bf16",
                 ("tower", 0.0, bf)),
            mode("ViT-L/14 B=128 T=257 D=1024 H=16 fused-out, bf16", ("vit", 128, bf)),
            mode("ViT-L/14 B=256 T=257 D=1024 H=16 fused-out, bf16", ("vit", 256, bf)),
            mode("ViT-L/14 B=128 T=257 fused-out, fp32", ("vit", 128, f32)),
        ] + parts[bf] + parts[f32],
    }
    return new, extra


# --------------------------------------------------------------- path M ----

def phase_large_towers(torch):
    """Path M3: the `wavlm_large` (K1 in its gate mode) and `data2vec_large`
    towers, one full-width bf16 forward each at B=8 x 102400 samples: 319
    frames, finite output, K1's launches (24 layers)."""
    from speechclip_plus_tpu_torch.models.hubert import HubertConfig, HubertModel
    from speechclip_plus_tpu_torch.tasks.builder import init_params

    batch = train_batch(torch, 8, TRAIN_WAV, 8, seed=4)
    wav = batch["wav"]
    pad = torch.arange(TRAIN_WAV, device="cuda")[None] >= batch["wav_len"][:, None]
    counts = {}
    for name in ("wavlm_large", "data2vec_large"):
        t0 = time.perf_counter()
        cfg = dataclasses.replace(getattr(HubertConfig, name)(), dtype=torch.bfloat16)
        tower = HubertModel(cfg)
        init_params(tower, torch.Generator().manual_seed(0))
        tower = tower.to("cuda").eval()
        weights = torch.full((cfg.num_hidden_states,), 1.0 / cfg.num_hidden_states,
                             device="cuda")
        built_s = time.perf_counter() - t0
        with torch.inference_mode():
            tower(wav, pad, weights)  # warm-up
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            out = tower(wav, pad, weights)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts[name] = read_counts(torch, f"path M3 {name} tower",
                                       k1_plan(cfg.n_layers))
        frames = out["x"].shape[1]
        finite = bool(torch.isfinite(out["x"].float()).all()) and bool(
            torch.isfinite(out["weighted_sum"]).all())
        print(f"[path M3] {name} tower bf16 B=8 x {TRAIN_WAV} samples ({cfg.n_layers} layers, "
              f"D={cfg.d_model}, {cfg.n_heads} heads{', gated relative position bias' if cfg.rel_pos_bias else ''}): "
              f"built in {built_s:.1f} s, {tuple(out['x'].shape)}, finite {finite}, "
              f"{ms:.2f} ms/forward")
        require(frames == 319, f"path M3 {name}: {frames} frames for {TRAIN_WAV} samples")
        require(tuple(out["weighted_sum"].shape) == (8, 319, cfg.d_model) and finite,
                f"path M3 {name}: output {tuple(out['weighted_sum'].shape)}, finite {finite}")
        del tower, out
        torch.cuda.empty_cache()
    return {f"M3_{name}": c for name, c in counts.items()}


def phase_large(torch):
    """Path M, the large plus family (flickr, bf16, full width, seeded random
    weights): M1 hybrid+ large and M2 cascaded+ large through the family path
    (an index of 256 images through ViT-L/14, cascaded `search` at B = 1, 8,
    64, `encode_speech`, the training phase at B=128 x 102400 with cached and
    live images), M1's fp32 card-vs-CPU parity of serving and of one training
    step, M1's training phase with `clip.text_remat: full` against the
    default none (ms and peak memory), and M3, the other two large towers.
    Returns the launch counts by path."""
    by_path, ms = {}, {}
    # Every training phase here runs both cells, 16 steps: the large YAMLs
    # accumulate 2 batches and warm up over 5000 steps, so 8 steps are 4
    # Adam updates of at most 1e-4 x 3 / 5000 = 6e-8, less than half an fp32
    # ulp of the learnable log(1 / temperature), 2.66: phase 6's check that
    # every trainable tensor moved needs the 8 updates of 16 steps.
    cells = ("cached", "live")
    for label, config in LARGE_CONFIGS.items():
        counts, ms[label] = phase_family(torch, label, config, cells=cells)
        by_path[f"{label[:2]}_serve"], by_path[f"{label[:2]}_train"] = (
            counts["serve"], counts["train"])
        if label.startswith("M1"):
            phase_parity(torch, f"path {label}", config)
            # the keyword projection's last bias reaches the batch-statistics BN
            # through a linear map only: no gradient in exact arithmetic
            phase_train_parity(torch, f"path {label}", config,
                               zero=("head.linear_proj.layers.1.bias",))
            built = build(torch, config, clip_keys={"text_remat": "full"})
            by_path["M1_train_text_remat_full"], ms["M1 text_remat full"] = phase_train(
                torch, f"path {label} text_remat full", config, cells=cells, built=built)
            none, full = ms[label], ms["M1 text_remat full"]
            print(f"[path M1] clip.text_remat on the cached step, B={TRAIN_BATCH}: none "
                  f"{none['cached']:.2f} ms/step, peak {none['cached_peak_gib']:.2f} GiB; full "
                  f"{full['cached']:.2f} ms/step, peak {full['cached_peak_gib']:.2f} GiB")
    by_path.update(phase_large_towers(torch))
    print("[path M] ms/step, pairs/s at B=128 x 102400: " + "; ".join(
        f"{label} {cell} {v:.2f} ms, {TRAIN_BATCH / v * 1e3:.1f} pairs/s"
        for label, cells in ms.items() for cell, v in cells.items() if not cell.endswith("gib")))
    return by_path


# --------------------------------------------------------------- path N ----

FIXED_LARGE_CONFIGS = {  # path N, the fixed-K large family (flickr)
    "N1 cascaded large": "config/speechclip/large/flickr/cascaded.yaml",
    "N2 parallel large": "config/speechclip/large/flickr/parallel.yaml",
    "N3 hybrid large": "config/speechclip_plus/large/flickr/hybrid.yaml",
}


def phase_kernels_large_fixed(torch):
    """Phase 2 at path N's shapes: K1 context-only + lse and K2 at one head of
    1024 (B=128; T=327, the cascaded branch's 8 keyword CLS + 319 frames, and
    T=328, the hybrid's 1 + 8 + 319), p=0.1 and 0; K1 at the cascaded serving
    shapes (T=327, p=0, B=1, 8, 64); K2 against finite differences in fp32 at
    both T; K3 and K3b at the fixed-K step's N = 128 x 8 = 1024 rows on the
    768-wide codebook (V=8112). Returns (the rows of K1 and K2 at dh=1024,
    extra modes by kernel name)."""
    from speechclip_plus_tpu_torch.data.tokenizer import ReducedVocab
    from speechclip_plus_tpu_torch.nn import fused_attention_block as fab
    from speechclip_plus_tpu_torch.nn import fused_attention_block_vjp as vjp
    from speechclip_plus_tpu_torch.ops import fused_keyword as fk

    vocab = ReducedVocab.from_npy(VOCAB_FILES[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(41)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        for t in (327, 328):
            shape = (128, t, 1024, 1)
            name = "K1 context-only fixed-K large branch B={} T={} D={} H={}".format(*shape)
            rows[("k1", t, 0.1, dtype)] = check_attention_dropout(torch, fab, name, *shape,
                                                                  False, dtype, gen)
            rows[("k1", t, 0.0, dtype)] = check_attention(torch, fab, name + " p=0", *shape,
                                                          False, True, dtype, gen)
            for p in (0.1, 0.0):
                rows[("k2", t, p, dtype)] = check_attention_bwd(
                    torch, fab, vjp, dtype, p, gen, shape, what="fixed-K large branch")
            torch.cuda.empty_cache()
        for b in (1, 8, 64):  # cascaded serving: the query batches of `search`
            rows[("serve", b, dtype)] = check_attention(
                torch, fab, f"K1 context-only fixed-K large serving B={b} T=327 D=1024 H=1 p=0",
                b, 327, 1024, 1, False, True, dtype, gen)
        rows[("k3", dtype)] = check_vq(torch, fk, vocab, 1024, dtype, gen, d=768)
        rows[("k3b", dtype)] = check_vq_bwd(torch, fk, vocab, dtype, gen, n=1024, d=768)
        torch.cuda.empty_cache()
    check_attention_fd(torch, vjp, gen, (2, 327, 1024, 1), 0.1, what="fixed-K large branch")
    check_attention_fd(torch, vjp, gen, (2, 328, 1024, 1), 0.0, what="fixed-K large branch")
    bf, f32 = torch.bfloat16, torch.float32
    csrc = "speechclip_plus_tpu_torch/csrc/"
    jax_pkg = "speechclip_plus_tpu/"
    mode = lambda text, key: {"shape": text, **rows[key]}
    k1_modes = [mode(f"B=128 T={t} D=1024 H=1 context-only + lse, dropout {p}, "
                     f"{str(dt)[6:]}", ("k1", t, p, dt))
                for dt in (bf, f32) for t in (327, 328) for p in (0.1, 0.0)
                if (t, p, dt) != (327, 0.1, bf)]
    k1_modes += [mode(f"cascaded serving B={b} T=327 D=1024 H=1 context-only, no dropout, "
                      f"{str(dt)[6:]}", ("serve", b, dt)) for dt in (bf, f32) for b in (1, 8, 64)]
    k2_modes = [mode(f"B=128 T={t} D=1024 H=1, dropout {p}, {str(dt)[6:]}", ("k2", t, p, dt))
                for dt in (bf, f32) for t in (327, 328) for p in (0.1, 0.0)
                if (t, p, dt) != (327, 0.1, bf)]
    new = [
        {"name": "fused_attention_block_dh1024", "route": "cuda",
         "source": csrc + "fused_attention_block_attn_dh1024.cu",
         "replaces": jax_pkg + "nn/fused_attention_block.py:118",
         "shape": "fixed-K large branch B=128 T=327 D=1024 H=1 context-only + lse, dropout 0.1, "
                  "bf16", **rows[("k1", 327, 0.1, bf)], "modes": k1_modes},
        {"name": "fused_attention_block_bwd_dh1024", "route": "cuda",
         "source": csrc + "fused_attention_block_bwd_dh1024.cu",
         "replaces": jax_pkg + "nn/fused_attention_block_vjp.py:104",
         "shape": "fixed-K large branch B=128 T=327 D=1024 H=1, dropout 0.1, bf16",
         **rows[("k2", 327, 0.1, bf)], "modes": k2_modes},
    ]
    extra = {
        "fused_cosine_vq_d768": [mode("N=1024 D=768 V=8112 bf16 (fixed-K large step)",
                                      ("k3", bf)),
                                 mode("N=1024 D=768 V=8112 fp32", ("k3", f32))],
        "fused_cosine_vq_bwd_d768": [mode("N=1024 D=768 V=8112 bf16 (fixed-K large step)",
                                          ("k3b", bf)),
                                     mode("N=1024 D=768 V=8112 fp32", ("k3b", f32))],
    }
    return new, extra


def phase_large_fixed(torch):
    """Path N, the fixed-K large family (flickr, bf16, full width, seeded
    random weights): N1 cascaded large, N2 parallel large and N3 hybrid large
    through the family path (an index of 256 images through ViT-L/14,
    `search` with the YAML's feature source at B = 1, 8, 64, `encode_speech`,
    the training phase at B=128 x 102400 with cached and live images), N3's
    fp32 card-vs-CPU parity of serving and of one training step, and one
    cached N1 cell at the YAML's own batch of 256 for its peak memory.
    Returns the launch counts by path."""
    by_path, ms = {}, {}
    for label, config in FIXED_LARGE_CONFIGS.items():
        # Adam must move every trainable tensor through the 5000-step warm-up
        # (path M): 8 updates. N1 and N2 update every step; N3 accumulates 4
        # batches, so its cells take 11 warm-up steps each: 2 x 16 steps
        accumulate = 4 if label.startswith("N3") else 1
        counts, ms[label] = phase_family(torch, label, config, cells=("cached", "live"),
                                         warmup=WARMUP_STEPS + 8 * (accumulate > 1))
        by_path[f"{label[:2]}_serve"], by_path[f"{label[:2]}_train"] = (
            counts["serve"], counts["train"])
        if label.startswith("N3"):
            phase_parity(torch, f"path {label}", config)
            # the keyword projection's last bias reaches the batch-statistics BN
            # through a linear map only: no gradient in exact arithmetic
            phase_train_parity(torch, f"path {label}", config, batch_size=4,
                               zero=("head.linear_proj.layers.1.bias",))
    label, config = "N1 cascaded large", FIXED_LARGE_CONFIGS["N1 cascaded large"]
    built = build(torch, config)
    require(built[0].data.batch_size == 256, "N1: the YAML's batch is not 256")
    by_path["N1_train_b256"], ms["N1 B=256"] = phase_train(
        torch, f"path {label} B=256", config, cells=("cached",), built=built, batch_size=256)
    print("[path N] ms/step, pairs/s, peak at B=128 x 102400 (N1 also at B=256): " + "; ".join(
        f"{label} {cell} {v:.2f} ms, "
        f"{(256 if label.endswith('256') else TRAIN_BATCH) / v * 1e3:.1f} pairs/s, "
        f"peak {cells[cell + '_peak_gib']:.2f} GiB"
        for label, cells in ms.items() for cell, v in cells.items() if not cell.endswith("gib")))
    return by_path


# --------------------------------------------------------------- path O ----

MEL_CONFIGS = {  # path O, the mel upstreams: base YAMLs with keys overridden in memory
    "O1 mockingjay hybrid+": (CONFIG, {"audio_encoder.name": "mockingjay"}),
    # APC is 512 wide: the parallel branch follows it (8 heads of 64)
    "O2 apc parallel": ("config/speechclip_plus/base/parallel.yaml", {
        "audio_encoder.name": "apc",
        "model_settings.parallel_branch.transformer_args.d_model": 512}),
    "O3 tera cascaded+": ("config/speechclip_plus/base/cascaded_plus.yaml",
                          {"audio_encoder.name": "tera"}),
}


def phase_kernels_mel(torch):
    """Phase 2 at path O's tower shape: K1 fused-out with 12 heads of 64 over
    the mel transformers' 638 frames (B=128), with dropout 0.1 as in training
    and without, in bf16 and fp32. The branch's shapes (T = 638, 639) are held
    after each cell by `check_path_shapes`. Returns extra modes by kernel
    name."""
    from speechclip_plus_tpu_torch.nn import fused_attention_block as fab

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(43)
    name = "K1 fused-out mel transformer B=128 T=638 D=768 H=12"
    modes = []
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype)[6:]
        row = check_attention_dropout(torch, fab, name, 128, 638, 768, 12, True, dtype, gen)
        modes.append({"shape": f"mel tower B=128 T=638 D=768 H=12 fused-out, dropout 0.1, {dt}",
                      **row})
        row = check_attention(torch, fab, name + " p=0", 128, 638, 768, 12, True, True, dtype,
                              gen)
        modes.append({"shape": f"mel tower B=128 T=638 D=768 H=12 fused-out, no dropout, {dt}",
                      **row})
        torch.cuda.empty_cache()
    return {"fused_attention_block": modes}


def phase_lstm_parity(torch):
    """O2's tower alone, fp32: the log-mel frontend and APC's 3 LSTM layers
    of 512 (cuDNN, TF32 off inside each layer) on the card against the same
    weights on the CPU, B=8 ragged up to 102400 samples: every hidden state
    and the weighted sum to 1e-4 x max(1, RMS). For the record, the same
    layers with cuDNN's TF32 left on (its default): their error against the
    CPU, and both forms' time at B=128."""
    from speechclip_plus_tpu_torch.models.mel_upstreams import MelUpstream, MelUpstreamConfig
    from speechclip_plus_tpu_torch.ops.mel import log_mel_spectrogram
    from speechclip_plus_tpu_torch.tasks.builder import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = MelUpstreamConfig.from_upstream_name("apc")
    cpu = MelUpstream(cfg).eval()
    init_params(cpu, torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to("cuda")
    batch = train_batch(torch, 8, TRAIN_WAV, 8, seed=4)
    wav = batch["wav"]
    pad = torch.arange(TRAIN_WAV, device="cuda")[None] >= batch["wav_len"][:, None]
    weights = torch.softmax(torch.linspace(-1.0, 1.0, cfg.num_hidden_states), dim=0)
    with torch.no_grad():
        want = cpu(wav.cpu(), pad.cpu(), weights, return_hidden_states=True)
        got = card(wav, pad, weights.cuda(), return_hidden_states=True)
    worst = 0.0
    for key in ("hidden_states", "weighted_sum"):
        a, w = got[key].cpu().float(), want[key].float()
        worst = max(worst, (a - w).abs().max().item() / max(1.0, w.pow(2).mean().sqrt().item()))
    require(torch.equal(got["padding_mask"].cpu(), want["padding_mask"]), "O2 tower: masks")

    def lstm(x, tf32):
        torch.backends.cudnn.allow_tf32 = tf32
        for i in range(cfg.n_layers):
            layer = getattr(card.lstm, f"layer_{i}")
            x = (layer(x) if not tf32 else torch.nn.LSTM.forward(layer, x)[0])
        torch.backends.cudnn.allow_tf32 = False
        return x

    with torch.no_grad():
        mel = log_mel_spectrogram(wav).masked_fill(got["padding_mask"][:, :, None], 0.0)
        tf32_err = (lstm(mel, True).cpu() - want["hidden_states"][-1]).abs().max().item()
        big = train_batch(torch, TRAIN_BATCH, TRAIN_WAV, 8, seed=5)["wav"]
        mel = log_mel_spectrogram(big)
        off_ms = median_ms(lambda: lstm(mel, False), runs=5, warmup=1)
        on_ms = median_ms(lambda: lstm(mel, True), runs=5, warmup=1)
    print(f"[path O2] APC tower fp32, card vs CPU, B=8 x {TRAIN_WAV} ragged: hidden states and "
          f"weighted sum max_abs_err / max(1, RMS) {worst:.3e} (<= 1e-4), cuDNN LSTM with TF32 "
          f"off; with TF32 on the last layer would be {tf32_err:.3e} off. 3 LSTM layers at "
          f"B={TRAIN_BATCH} x 638 frames: TF32 off {off_ms:.3f} ms, on {on_ms:.3f} ms (median "
          f"of 5)")
    require(worst <= 1e-4, f"O2 tower: card vs CPU {worst} > 1e-4 x max(1, RMS)")


def phase_mel(torch):
    """Path O, the mel upstreams (bf16, full width, seeded random weights; the
    base YAMLs of MEL_CONFIGS with `audio_encoder.name` overridden in memory):
    O1 Mockingjay hybrid+ serves (phase 5's cells at B = 1, 8, 64, both
    feature sources and wire dtypes, `search_stream`, over 256 images) and
    trains (B=128 x 102400, cached and live images), with its fp32
    card-vs-CPU parity of serving and of one training step; O2 APC parallel
    and O3 TERA cascaded+ through the family path (cached images), and O2's
    LSTM tower alone against the CPU. Returns the launch counts by path."""
    by_path, ms = {}, {}
    label = "O1 mockingjay hybrid+"
    config = MEL_CONFIGS[label]
    by_path["O1_serve"] = phase_model(torch, f"path {label}", config, n_img=256, shapes=True)
    by_path["O1_train"], ms[label] = phase_train(torch, f"path {label}", config,
                                                 built=build(torch, config))
    phase_parity(torch, f"path {label}", config)
    phase_train_parity(torch, f"path {label}", config)
    for label in ("O2 apc parallel", "O3 tera cascaded+"):
        counts, ms[label] = phase_family(torch, label, MEL_CONFIGS[label])
        by_path[f"{label[:2]}_serve"], by_path[f"{label[:2]}_train"] = (
            counts["serve"], counts["train"])
        if label.startswith("O2"):
            phase_lstm_parity(torch)
    print(f"[path O] ms/step, pairs/s, peak at B={TRAIN_BATCH} x {TRAIN_WAV}: " + "; ".join(
        f"{label} {cell} {v:.2f} ms, {TRAIN_BATCH / v * 1e3:.1f} pairs/s, "
        f"peak {cells[cell + '_peak_gib']:.2f} GiB"
        for label, cells in ms.items() for cell, v in cells.items() if not cell.endswith("gib")))
    return by_path


# --------------------------------------------------------------- path P ----

VQ_ARGS = "model_settings.cascaded_branch.vq.args."
VARIANT_CONFIGS = {  # path P, the training variants: base YAMLs with keys overridden in memory
    "P1 hybrid+ top layers": (CONFIG, {"audio_encoder.unfreeze_layers": [10, 11],
                                       VQ_ARGS + "temp": "learnable=0.1"}),
    "P2 cascaded+ full tower": ("config/speechclip_plus/base/cascaded_plus.yaml", {
        "audio_encoder.trainable": True, "audio_encoder.layer_drop": "original",
        "cl_loss.type": "SupConLoss", VQ_ARGS + "temp": "(2, 0.5, 0.999995)"}),
    "P3 cascaded text+image": ("config/speechclip/base/cascaded.yaml", {
        "clip.text_encoder_trainable": True, "clip.image_encoder_trainable": True,
        VQ_ARGS + "use_gumbel": True}),
}


def p1_trains(name):
    """P1's trainable set: all but the towers, and of the acoustic tower
    layers 10 and 11 and the post-norm encoder LayerNorm."""
    if name.startswith("clip."):
        return False
    return not name.startswith("audio_encoder.") or name.startswith(
        ("audio_encoder.layers.10.", "audio_encoder.layers.11.",
         "audio_encoder.encoder_layer_norm."))


def params_difference(torch, a, b):
    """(tensors that differ, the largest absolute difference) of two
    parameter dicts."""
    diff = [n for n in a if not torch.equal(a[n], b[n])]
    return diff, max([(a[n].float() - b[n].float()).abs().max().item() for n in diff],
                     default=0.0)


def phase_variants(torch):
    """Path P, the training variants (bf16, full width, seeded random weights;
    VARIANT_CONFIGS) through the family path, with P1's fp32 card-vs-CPU
    parity of one step and P2's remat leg. Returns the launch counts by
    path."""
    by_path, ms = {}, {}
    label = "P1 hybrid+ top layers"
    config = VARIANT_CONFIGS[label]
    counts, ms[label] = phase_family(torch, label, config, cells=("cached", "live"),
                                     trains=p1_trains)
    by_path["P1_serve"], by_path["P1_train"] = counts["serve"], counts["train"]
    print(f"[path P1] the tower's layers 0-9, conv frontend, post_extract_proj and pos_conv "
          f"stayed bit-identical; layers 10 and 11, encoder_layer_norm and curr_temp moved")
    phase_train_parity(torch, f"path {label}", config)

    label = "P2 cascaded+ full tower"
    path, keys = VARIANT_CONFIGS[label]
    legs = {}
    counts, ms[label] = phase_family(torch, label, (path, keys), final=legs.setdefault(
        "plain", {}))
    by_path["P2_serve"], by_path["P2_train"] = counts["serve"], counts["train"]
    remat = {**keys, "audio_encoder.remat": True}
    # the remat leg, then both legs again with deterministic algorithms (cuDNN's
    # convolution backward among them): the remat leg must equal the plain leg
    # bit for bit there, and beside it the default algorithms' difference
    for name, leg_keys, det in (("remat", remat, False), ("plain det", keys, True),
                                ("remat det", remat, True)):
        torch.backends.cudnn.deterministic = det
        torch.use_deterministic_algorithms(det, warn_only=True)
        try:
            built = build(torch, (path, leg_keys))
            require(built[2].audio.remat == ("remat" in name), f"P2 {name}: remat")
            by_path[f"P2_train_{name.replace(' ', '_')}"], ms[f"{label} {name}"] = phase_train(
                torch, f"path {label} {name}", (path, leg_keys), cells=("cached",),
                built=built, final=legs.setdefault(name, {}))
        finally:
            torch.backends.cudnn.deterministic = False
            torch.use_deterministic_algorithms(False)
    diff, worst = params_difference(torch, legs["plain"], legs["remat"])
    det_diff, det_worst = params_difference(torch, legs["plain det"], legs["remat det"])
    print(f"[path P2] parameters after the steps, remat leg vs plain leg: deterministic "
          f"algorithms {len(det_diff)} of {len(legs['plain'])} tensors differ (max_abs_diff "
          f"{det_worst:.3e}); default algorithms {len(diff)} differ (max_abs_diff {worst:.3e})")
    require(not det_diff, "P2: with deterministic algorithms the remat leg differs from the "
                          f"plain leg: {det_diff[:5]}")
    print(f"[path P2] peak memory, cached images: plain {ms[label]['cached_peak_gib']:.2f} GiB, "
          f"remat {ms[label + ' remat']['cached_peak_gib']:.2f} GiB; ms/step plain "
          f"{ms[label]['cached']:.2f}, remat {ms[label + ' remat']['cached']:.2f}, with "
          f"deterministic algorithms {ms[label + ' plain det']['cached']:.2f} / "
          f"{ms[label + ' remat det']['cached']:.2f}")
    del legs

    label = "P3 cascaded text+image"
    counts, ms[label] = phase_family(torch, label, VARIANT_CONFIGS[label], cells=("live",),
                                     still=("clip.logit_scale",))
    by_path["P3_serve"], by_path["P3_train"] = counts["serve"], counts["train"]
    require(all(c.get(k, 0) == 0 for c in counts.values()
                for k in ("fused_cosine_vq", "fused_cosine_vq_bwd")),
            "P3: K3 or K3b ran with a trainable text tower")
    print(f"[path P] ms/step, pairs/s, peak at B={TRAIN_BATCH} x {TRAIN_WAV}: " + "; ".join(
        f"{label} {cell} {v:.2f} ms, {TRAIN_BATCH / v * 1e3:.1f} pairs/s, "
        f"peak {cells[cell + '_peak_gib']:.2f} GiB"
        for label, cells in ms.items() for cell, v in cells.items() if not cell.endswith("gib")))
    return by_path


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


def build(torch, config, device="cuda", precision=None, clip_keys=None, **audio_keys):
    """(cfg, model, model_cfg) from a YAML config with seeded random weights;
    `audio_keys` are set under `audio_encoder` and `clip_keys` under `clip`,
    as a YAML would. `config` is a path, or (path, {dotted key: value}) for a
    cell that overrides keys of a base YAML in memory (path O)."""
    from speechclip_plus_tpu_torch.config import load_config
    from speechclip_plus_tpu_torch.tasks.builder import build_model_from_config

    path, overrides = (config, {}) if isinstance(config, str) else config
    cfg = load_config(path)
    set_keys(cfg, overrides)
    for key, value in audio_keys.items():
        setattr(cfg.audio_encoder, key, value)
    for key, value in (clip_keys or {}).items():
        setattr(cfg.clip, key, value)
    if precision is not None:
        cfg.trainer.precision = precision
    model, model_cfg, _ = build_model_from_config(cfg, device=device, seed=0)
    return cfg, model, model_cfg


def add_counts(total, per_call, times=1):
    for name, n in per_call.items():
        total[name] = total.get(name, 0) + n * times


def k1_plan(fused_out=0, context_only=0):
    """K1 launches, with the projection GEMMs (K1a) they make: qkv and out
    for a fused-out block, qkv for a context-only one."""
    return {"fused_attention_block": fused_out + context_only,
            "projection_gemm": 2 * fused_out + context_only}


def speech_query_plan(tower, cascaded):
    """Kernel launches of one speech query: the tower's 12 layers (K1, or K5
    around plain projections), the branch attention (K1) and, for the
    cascaded feature, the fused cosine-VQ (K3)."""
    plan = (k1_plan(12, 1) if tower == "k1"
            else {"fused_attention_dropout": 12, **k1_plan(0, 1)})
    if cascaded:
        plan["fused_cosine_vq"] = 1
    return plan


def tower_k1_layers(audio):
    """The tower's K1 (fused-out) launches a forward: one a layer, none for
    an LSTM upstream (cuDNN) or a trainable tower (the plain attention)."""
    if getattr(audio, "arch", None) == "lstm" or not audio.fused_attention_block:
        return 0
    return audio.n_layers


def vision_k1_layers(mc):
    """The ViT's K1 (fused-out) launches for one image batch: none for a
    trainable image tower (the plain attention)."""
    return mc.clip.vision_layers if mc.vision_fused_attention_block else 0


def tower_frames(torch, model, n_samples=TRAIN_WAV):
    """(frames the tower gives for `n_samples`, the count the path expects:
    319 through a HuBERT-family frontend, 638 through the mel one), from the
    frontend alone, which runs no kernel of the port."""
    enc = model.audio_encoder
    with torch.no_grad():
        if hasattr(enc, "feature_extractor"):
            return enc.feature_extractor(torch.zeros(1, n_samples, device="cuda")).shape[1], 319
        from speechclip_plus_tpu_torch.ops.mel import log_mel_spectrogram
        return log_mel_spectrogram(torch.zeros(1, n_samples, device="cuda")).shape[1], 638


def family_plans(mc):
    """(launches of one query by feature source, of `encode_speech`, of one
    training step with cached images) for any family, from its typed config:
    the tower's layers (12, or 24 large; a mel transformer's 3 or 12, an
    LSTM upstream none) and the branch attention (K1; K2 in
    the step), at one head of 768 the wide-head kernels, at heads of 128 the
    dh=128 ones; with a keyword head the cosine-VQ (K3; K3b in the step), on
    a 768-wide codebook its D=768 instances; with `text_fused_attention_vjp`
    the text layers (K1; K2 with the bias in the step). The routes follow
    the configuration: no tower K1 for a trainable tower, no branch K1 / K2
    under `fused_attention_vjp: false`, no K3 with `fused_score_kernel` off
    (a trainable text tower) and no K3b for a training form that is not
    straight-through (Gumbel, `hard: false`)."""
    ta = mc.cascaded_ta if mc.has_cascaded else mc.parallel_ta
    at = HEAD_COUNTERS.get(ta.d_model // ta.nhead) if mc.fused_attention_vjp else None
    d768 = mc.has_cascaded and mc.clip.text_width == 768
    text = mc.clip.text_layers if mc.has_cascaded and mc.clip.text_fused_attention_vjp else 0
    vq = mc.head.vq
    k3 = mc.has_cascaded and mc.head.fused_score_kernel and vq.time_first
    k3b = k3 and vq.hard and not vq.use_gumbel
    branch = k1_plan(tower_k1_layers(mc.audio), int(mc.fused_attention_vjp))
    if at:
        branch["fused_attention_block" + at] = 1
    full = dict(branch)
    if k3:
        full["fused_cosine_vq"] = 1
        if d768:
            full["fused_cosine_vq_d768"] = 1
    if mc.has_cascaded:
        add_counts(full, k1_plan(0, text))
    step = dict(full, fused_attention_block_bwd=int(mc.fused_attention_vjp) + text)
    if at:
        step["fused_attention_block_bwd" + at] = 1
    if text:
        step["fused_attention_block_bwd_attn_bias"] = text
    if k3b:
        step["fused_cosine_vq_bwd"] = 1
        if d768:
            step["fused_cosine_vq_bwd_d768"] = 1
    return {"parallel": branch, "cascaded": full}, full, step


def phase_family(torch, label, config, cells=("cached",), warmup=WARMUP_STEPS, **train_kw):
    """Paths E-H, L, M, N and P: one family, bf16: build, an image index of
    256 images, `search` with the YAML's feature source at B = 1, 8, 64,
    `encode_speech`; then the training phase (`cells`, `warmup` untimed steps
    a cell, `train_kw` to `phase_train`) on the same model. Returns
    ({"serve", "train"} launch counts, ms/step by cell)."""
    from speechclip_plus_tpu_torch.api import SpeechCLIP
    from speechclip_plus_tpu_torch.serving import SpeechRetriever, build_image_index

    t0 = time.perf_counter()
    built = build(torch, config)
    _, model, mc = built
    torch.cuda.synchronize()
    src = mc.retrieval_audio_feat_src
    frames, want_frames = tower_frames(torch, model)
    print(f"[build] path {label}: {mc.branch_type or 'ParallelBranch'} bf16 on cuda:0 in "
          f"{time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters); "
          f"retrieval.audio_feat_src {src}; {frames} frames for {TRAIN_WAV} samples")
    require(frames == want_frames,
            f"{label}: {frames} frames for {TRAIN_WAV} samples, not {want_frames}")
    sc = SpeechCLIP(model, "cuda")
    seen, hooks = record_shapes(torch, model)
    query, full, _ = family_plans(mc)
    n_img = 256
    gen = torch.Generator(device="cuda").manual_seed(1)
    images = torch.randn(n_img, 224, 224, 3, generator=gen, device="cuda")
    index_ids = np.arange(n_img) + 10000
    reset_counts()
    expect = k1_plan(vision_k1_layers(mc))  # one image batch through the ViT
    index = build_image_index(sc, images, index_ids, batch_size=256)
    require(len(index) == n_img and bool(torch.isfinite(index.feats).all()), f"{label}: index")
    retriever = SpeechRetriever(sc, index)  # the YAML's feature source
    require(retriever.feat_src == src, f"{label}: feat_src {retriever.feat_src}")
    rng = np.random.RandomState(0)
    for b in (1, 8, 64):
        wavs = ragged_wavs(rng, b, False)
        times = []
        for _ in range(1 + 3):  # the first request warms up
            t0 = time.perf_counter()
            ids, scores = retriever.search(wavs, k=10)
            times.append(time.perf_counter() - t0)
            add_counts(expect, query[src])
            check_search(ids, scores, b, 10, index_ids, f"{label} {src} B={b}")
        med = float(np.median(times[1:]))
        print(f"[serve] path {label} {src} B={b:2d} fp32: median {med * 1e3:.2f} ms/request, "
              f"max {max(times[1:]) * 1e3:.2f} ms (n=3), {b / med:.1f} utterances/s")
    out = sc.encode_speech(ragged_wavs(rng, 8, False))
    add_counts(expect, full)
    has = {"parallel_audio_feat": not mc.has_cascaded or mc.branch_type.startswith("Hybrid"),
           "cascaded_audio_feat": mc.has_cascaded}
    for key, there in has.items():
        f = out[key]
        require((f is not None) == there, f"{label} encode_speech {key}: {f is not None}")
        if there:
            require(tuple(f.shape) == (8, mc.clip.embed_dim)
                    and bool(torch.isfinite(f.float()).all()),
                    f"{label} encode_speech {key}: {tuple(f.shape)}")
    if mc.keyword_num is not None:
        require(tuple(out["keywords"].shape) == (8, mc.keyword_num, mc.clip.text_width),
                f"{label}: keywords")
    counts = {"serve": read_counts(torch, f"path {label} serving", expect)}
    for h in hooks:
        h.remove()
    del sc, index, retriever, images, out
    torch.cuda.empty_cache()
    check_path_shapes(torch, f"path {label} serving", seen)
    counts["train"], ms = phase_train(torch, f"path {label}", config, cells=cells, built=built,
                                      warmup=warmup, **train_kw)
    return counts, ms


def phase_text_route(torch):
    """Path I: hybrid+ with `clip.text_fused_attention_vjp: true` against the
    same weights with the knob off (and with `clip.text_remat` full and attn):
    cascaded features, the first training step's loss, ms/step and peak
    memory."""
    from speechclip_plus_tpu_torch.api import SpeechCLIP

    wavs = ragged_wavs(np.random.RandomState(3), 8, False)
    feats, counts, result, towers = {}, {}, {}, {}
    cells = (("knob on", {"text_fused_attention_vjp": True}), ("knob off", {}),
             ("knob off, text_remat full", {"text_remat": "full"}),
             ("knob off, text_remat attn", {"text_remat": "attn"}))
    for name, keys in cells:
        label = f"path I hybrid+ text route {name}"
        slug = name.replace("knob ", "").replace(", text_remat ", "_")
        built = build(torch, CONFIG, clip_keys=keys)
        _, model, mc = built
        if "text_remat" not in keys:  # serving: the cascaded feature of both routes
            # a copy on the host, so that the later cells' peak memory is their own
            towers[name] = copy.deepcopy(model.clip.text).cpu()
            sc = SpeechCLIP(model, "cuda")
            seen, hooks = record_shapes(torch, model)
            _, full, _ = family_plans(mc)
            reset_counts()
            feats[name] = sc.encode_speech(wavs)
            counts[f"I_serve_{slug}"] = read_counts(torch, f"{label} encode_speech", full)
            for h in hooks:
                h.remove()
            check_path_shapes(torch, f"{label} encode_speech", seen)
            del sc
        c, ms, first = phase_train(torch, label, CONFIG, cells=("cached",), built=built,
                                   first_loss=True)
        counts[f"I_train_{slug}"] = c
        result[name] = (ms["cached"], first)
    on, off = feats["knob on"], feats["knob off"]
    require(bool(torch.equal(on["vq_results"]["targets"], off["vq_results"]["targets"])),
            "path I: VQ targets differ (the branch does not depend on the knob)")
    # Two routes through 12 bf16 layers differ by each one's rounding, so the
    # features are held to path C's tolerance for two routes of a bf16 tower,
    # rms(diff) / rms <= 5e-2 (the single-kernel bf16 rule is printed). That
    # the difference is rounding and not the kernels is shown on the text
    # tower alone, on the training step's shape of keyword inputs: in fp32 the
    # two routes agree under the fp32 rule, and in bf16 the fused route is no
    # farther from the fp32 tower than 1.5 x the plain route's own distance.
    a, b = on["cascaded_audio_feat"].float(), off["cascaded_audio_feat"].float()
    err, _, tol = compare(torch, a, b, torch.bfloat16)
    rms = lambda x: x.float().pow(2).mean().sqrt().item()
    rms_rel = rms(a - b) / rms(b)
    cos = torch.nn.functional.cosine_similarity(a, b).min().item()
    text_on, text_off = towers["knob on"].to("cuda"), towers["knob off"].to("cuda")
    fp32 = {}
    for knob in (False, True):
        cfg32 = dataclasses.replace(text_off.cfg, dtype=torch.float32,
                                    text_fused_attention_vjp=knob)
        fp32[knob] = type(text_off)(cfg32).to("cuda").eval()
        fp32[knob].load_state_dict(text_off.state_dict())
    gen = torch.Generator(device="cuda").manual_seed(4)
    table = text_off.token_embedding.weight
    ids = torch.randint(4, table.shape[0], (TRAIN_BATCH, 75), generator=gen, device="cuda")
    num = torch.randint(1, 76, (TRAIN_BATCH,), generator=gen, device="cuda")
    with torch.no_grad():
        kw = table[ids]
        ref, ref_on = (fp32[knob].encode_keywords(kw, num) for knob in (False, True))
        far_on = rms(text_on.encode_keywords(kw, num) - ref) / rms(ref)
        far_off = rms(text_off.encode_keywords(kw, num) - ref) / rms(ref)
    err32, ok32, tol32 = compare(torch, ref_on, ref, torch.float32)
    loss_on, loss_off = result["knob on"][1], result["knob off"][1]
    rel = abs(loss_on - loss_off) / abs(loss_off)
    print(f"[path I] knob on vs off, bf16: cascaded feature rms(diff)/rms {rms_rel:.3e} (<= "
          f"5e-2), max_abs_err={err:.3e} ({tol}), min cosine {cos:.6f}; first training loss "
          f"{loss_on:.5f} vs {loss_off:.5f} (rel {rel:.2e} <= 1e-4); ms/step "
          + ", ".join(f"{n}: {m:.2f}" for n, (m, _) in result.items()))
    print(f"[path I] text tower alone, B={TRAIN_BATCH} x 1-75 keywords: fp32 knob on vs off "
          f"max_abs_err={err32:.3e} ({tol32}); bf16 against the fp32 tower, rms(diff)/rms: "
          f"fused route {far_on:.3e}, plain route {far_off:.3e} (fused <= 1.5 x plain)")
    require(rms_rel <= 5e-2,
            f"path I: cascaded features of the two routes differ by {rms_rel} of the RMS")
    require(ok32, f"path I: fp32 text tower, knob on vs off: {err32} ({tol32})")
    require(far_on <= 1.5 * far_off,
            f"path I: the fused route is {far_on} from the fp32 tower, the plain one {far_off}")
    require(rel <= 1e-4, f"path I: first training losses differ by {rel}")
    return counts, {n: m for n, (m, _) in result.items()}


def phase_model(torch, label, config, *, tower="k1", batches=(1, 8, 64), wires=(False, True),
                n_img=1000, stream=True, shapes=False, **audio_keys):
    """Phases 3-5 for one configuration of the hybrid+ family: build, image
    index, serving cells; with `shapes`, the branch and cosine-VQ shapes of
    the serving cells held against their twins after them (path O)."""
    from speechclip_plus_tpu_torch.api import SpeechCLIP
    from speechclip_plus_tpu_torch.serving import SpeechRetriever, build_image_index

    t0 = time.perf_counter()
    _, model, mc = build(torch, config, **audio_keys)
    torch.cuda.synchronize()
    print(f"[build] {label}: hybrid+ bf16 on cuda:0 in {time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters)")
    sc = SpeechCLIP(model, "cuda")
    query = (family_plans(mc)[0] if tower == "k1" else
             {src: speech_query_plan(tower, src == "cascaded") for src in ("parallel", "cascaded")})
    seen, shape_hooks = record_shapes(torch, model) if shapes else (set(), [])

    batch = 256
    gen = torch.Generator(device="cuda").manual_seed(1)
    images = torch.randn(n_img, 224, 224, 3, generator=gen, device="cuda")
    index_ids = np.arange(n_img) + 10000

    # every launch the path makes is counted from here on
    reset_counts()
    expect = {}
    t0 = time.perf_counter()
    index = build_image_index(sc, images, index_ids, batch_size=batch)
    torch.cuda.synchronize()
    add_counts(expect, k1_plan(vision_k1_layers(mc)), -(-n_img // batch))
    require(len(index) == n_img and bool(torch.isfinite(index.feats).all()), "index")
    print(f"[index] {label}: {n_img} images in {time.perf_counter() - t0:.2f} s")

    rng = np.random.RandomState(0)
    retrievers = {src: SpeechRetriever(sc, index, feat_src=src)
                  for src in ("parallel", "cascaded")}
    lat = {}
    for b in batches:
        for int16 in wires:
            wavs = ragged_wavs(rng, b, int16)
            for src, r in retrievers.items():
                times = []
                for _ in range(1 + REPS):  # the first request warms up
                    t0 = time.perf_counter()
                    ids, scores = r.search(wavs, k=10)
                    times.append(time.perf_counter() - t0)
                    add_counts(expect, query[src])
                    check_search(ids, scores, b, 10, index_ids, f"{label} {src} B={b}")
                lat[(src, b, int16)] = (times[1:], max(len(w) for w in wavs))
            out = sc.encode_speech(wavs)
            add_counts(expect, query["cascaded"])
            for key, width in (("parallel_audio_feat", 512), ("cascaded_audio_feat", 512)):
                f = out[key]
                require(tuple(f.shape) == (b, width) and bool(torch.isfinite(f.float()).all()),
                        f"{label} encode_speech {key} B={b}: {tuple(f.shape)}")
            klen = out["dsample_results"]["dsample_feats_length"]
            require(bool(((klen >= 1) & (klen <= 75)).all()), "keywords_len out of [1, 75]")
    for (src, b, int16), (times, longest) in sorted(lat.items()):
        med = float(np.median(times))
        print(f"[serve] {label} {src:9s} B={b:2d} {'int16' if int16 else 'fp32 '} (longest "
              f"{longest} samples): median {med * 1e3:.2f} ms/request, max "
              f"{max(times) * 1e3:.2f} ms (n={len(times)}), {b / med:.1f} utterances/s")

    if stream:
        batches_ = [ragged_wavs(rng, 8, False) for _ in range(6)]
        t0 = time.perf_counter()
        streamed = list(retrievers["cascaded"].search_stream(batches_, k=10, depth=2))
        sec = time.perf_counter() - t0
        require(len(streamed) == len(batches_), "search_stream lost a batch")
        for (ids, scores), wavs in zip(streamed, batches_):
            check_search(ids, scores, len(wavs), 10, index_ids, "search_stream")
        ids0, _ = retrievers["cascaded"].search(batches_[-1], k=10)
        add_counts(expect, query["cascaded"], len(batches_) + 1)
        require((ids0 == streamed[-1][0]).all(), "search_stream differs from search")
        print(f"[serve] {label} search_stream depth=2, 6 x B=8 cascaded: "
              f"{48 / sec:.1f} utterances/s")

    counts = read_counts(torch, f"{label} serving", expect)
    for h in shape_hooks:
        h.remove()
    del model, sc, index, retrievers, images
    torch.cuda.empty_cache()
    if shapes:
        check_path_shapes(torch, f"{label} serving", seen)
    return counts


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


def phase_train(torch, label, config, *, tower="k1", cells=("cached", "live"),
                built=None, first_loss=False, warmup=WARMUP_STEPS, batch_size=TRAIN_BATCH,
                still=(), trains=None, final=None, **audio_keys):
    """Phase 6 for one configuration: B=128 x 102400 training steps (`warmup`
    untimed and TIMED_STEPS timed steps a cell; `batch_size` for another B),
    on a model built here or handed in (`built`, with the plan of its
    family). Every trainable tensor must move but those named in `still`
    (no gradient in exact arithmetic, and a zero weight decay term);
    `trains(name)`, where given, must say which tensors train; `final`, a
    dict, receives the parameters after the steps (on the host)."""
    from speechclip_plus_tpu_torch.optim.optimizer import (
        build_optimizer_from_config, trainable_parameters)
    from speechclip_plus_tpu_torch.parallel.train_step import (
        create_train_state, make_train_step)

    t0 = time.perf_counter()
    cfg, model, model_cfg = built or build(torch, config, **audio_keys)
    optimizer = build_optimizer_from_config(model, cfg)
    state = create_train_state(optimizer)
    step_fn = make_train_step(model, optimizer, int(cfg.trainer.accumulate_grad_batches or 1))
    trainable = trainable_parameters(model)
    if trains is not None:
        wrong = [n for n, p in model.named_parameters() if p.requires_grad != trains(n)]
        require(not wrong, f"{label}: the trainable set differs from the plan: {wrong[:5]}")
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if not p.requires_grad}
    before = {n: p.detach().clone() for n, p in trainable}
    bn = getattr(getattr(model.cascaded_branch, "head", None), "bn_layer", None)
    bn_before = None if bn is None else (bn.running_mean.clone(), bn.running_var.clone())
    batch = train_batch(torch, batch_size, TRAIN_WAV, model_cfg.clip.image_resolution, seed=0)
    cached = {k: v for k, v in batch.items() if k != "image"}
    with torch.no_grad():  # the product default: frozen image features cached once
        cached["image_feat"] = model.encode_image_raw(batch["image"])
    batches = {"cached": cached, "live": batch}
    torch.cuda.synchronize()
    print(f"[train] {label}: {model_cfg.branch_type or 'ParallelBranch'} bf16 on cuda:0 ready "
          f"in {time.perf_counter() - t0:.1f} s: "
          f"{sum(p.numel() for _, p in trainable) / 1e6:.2f} M trainable (fp32: "
          f"{all(p.dtype == torch.float32 for _, p in trainable)}), "
          f"{sum(p.numel() for p in frozen.values()) / 1e6:.1f} M frozen; "
          f"B={batch_size} x {TRAIN_WAV} samples")
    require(all(p.dtype == torch.float32 for _, p in trainable), "trainable weights not fp32")

    gen = torch.Generator(device="cuda").manual_seed(1)
    seen, shape_hooks = record_shapes(torch, model)
    finite = {}  # each trainable tensor's first gradient: all finite?

    def note(name):
        def hook(g):
            finite.setdefault(name, torch.isfinite(g).all())  # returns None: g unchanged
        return hook

    hooks = [p.register_hook(note(n)) for n, p in trainable]
    # one step: the tower's 12 layers (K1, or K5), the branch attention forward
    # (K1) and backward (K2), the cosine-VQ forward (K3) and backward (K3b);
    # with live images the ViT's 12 layers (K1) as well
    step_plan = {**speech_query_plan(tower, True), "fused_attention_block_bwd": 1,
                 "fused_cosine_vq_bwd": 1}
    if built is not None:
        step_plan = family_plans(model_cfg)[2]
    expect, result, first = {}, {}, None
    # every launch the training path makes is counted from here on
    reset_counts()
    for cell in cells:
        b = batches[cell]
        for i in range(warmup):
            metrics = step_fn(state, b, gen)
            if i == 0:
                for h in hooks:
                    h.remove()
                hooks = []
                if first is None:
                    first = float(metrics["train_loss"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = []
        for _ in range(TIMED_STEPS):
            metrics = step_fn(state, b, gen)
            losses.append(metrics["train_loss"])
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / TIMED_STEPS
        peak_bytes = torch.cuda.max_memory_allocated()
        peak = peak_bytes / 2 ** 30
        n = warmup + TIMED_STEPS
        add_counts(expect, step_plan, n)
        if cell == "live":  # the ViT on the batch's images
            add_counts(expect, k1_plan(vision_k1_layers(model_cfg)), n)
        loss = torch.stack(losses).float().cpu()
        gn = float(metrics["grad_norm"])
        result[cell] = sec * 1e3
        result[f"{cell}_peak_gib"] = peak
        print(f"[train] {label} {cell:6s} images: {sec * 1e3:.2f} ms/step, "
              f"{batch_size / sec:.1f} pairs/s, peak {peak:.2f} GiB allocated "
              f"(n={TIMED_STEPS} after {warmup} warm-up); loss {loss[0]:.4f} -> "
              f"{loss[-1]:.4f}, grad_norm {gn:.4f}, " + ", ".join(
                  f"{k[len('train_'):]} {float(v):.4f}" for k, v in metrics.items()
                  if k.endswith("_loss")))
        print_mfu(label, model_cfg, batch_size, TRAIN_WAV, cell == "cached", sec * 1e3)
        require(bool(torch.isfinite(loss).all()), f"train {label} {cell}: non-finite loss")
        require(peak_bytes < 80e9, f"train {label} {cell}: peak {peak_bytes / 1e9:.2f} GB")
        require(gn > 0 and np.isfinite(gn), f"train {label} {cell}: grad_norm {gn}")
    counts = read_counts(torch, f"{label} training", expect)
    missing = sorted({n for n, _ in trainable} - set(finite) - set(still))
    require(not missing, f"trainable tensors without a gradient: {missing[:5]}")
    require(bool(torch.stack(list(finite.values())).all()), "a gradient is not finite")
    unchanged = [n for n, p in trainable if torch.equal(p, before[n])]
    require(unchanged == [n for n, _ in trainable if n in still],
            f"trainable tensors did not change: {unchanged}")
    moved = [n for n, p in model.named_parameters() if not p.requires_grad
             and not torch.equal(p, frozen[n])]
    require(not moved, f"frozen tensors changed: {moved[:5]}")
    require(bn is None or (not torch.equal(bn.running_mean, bn_before[0])
                           and not torch.equal(bn.running_var, bn_before[1])),
            "keyword-BN statistics did not move")
    print(f"[train] {label} checks: {len(trainable)} trainable tensors all changed"
          + (f" but {unchanged} (no gradient in exact arithmetic)" if unchanged else "")
          + f" and all finite gradients; {len(frozen)} frozen tensors bit-identical; keyword-BN "
          f"running statistics {'moved' if bn is not None else '(no keyword BN)'}; state.step "
          f"{state.step}")
    if final is not None:
        final.update({n: p.detach().cpu() for n, p in model.named_parameters()})
    for h in shape_hooks:
        h.remove()
    del model, optimizer, state, step_fn, frozen, before, cached, batches, batch, built
    torch.cuda.empty_cache()
    check_path_shapes(torch, f"{label} training", seen)
    return (counts, result, first) if first_loss else (counts, result)


def phase_tower_flash(torch):
    """Path C: the HuBERT-base tower with `use_flash_attention` (K4 in every
    layer) on B=8 x 480000 samples, deterministic, against the same weights
    through the K1 route."""
    from speechclip_plus_tpu_torch.models.hubert import HubertConfig, HubertModel
    from speechclip_plus_tpu_torch.tasks.builder import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b, t = 8, 480000
    gen = torch.Generator(device="cuda").manual_seed(21)
    wav = torch.randn(b, t, generator=gen, device="cuda")
    wav_len = t - torch.randint(0, t // 3, (b,), generator=gen, device="cuda")
    wav_len[0] = t
    pad = torch.arange(t, device="cuda")[None] >= wav_len[:, None]
    wav = wav.masked_fill(pad, 0.0)
    weights = torch.full((13,), 1.0 / 13, device="cuda")
    counts = None
    for dtype in (torch.float32, torch.bfloat16):
        flash_tower = HubertModel(HubertConfig(use_flash_attention=True,
                                               fused_attention_block=False, dtype=dtype))
        init_params(flash_tower, torch.Generator().manual_seed(0))
        flash_tower = flash_tower.to("cuda").eval()
        block_tower = HubertModel(HubertConfig(dtype=dtype)).to("cuda").eval()
        block_tower.load_state_dict(flash_tower.state_dict())
        with torch.inference_mode():
            reset_counts()
            got = flash_tower(wav, pad, weights)
            run = lambda tower: (tower(wav, pad, weights), torch.cuda.synchronize())
            n = 3
            t0 = time.perf_counter()
            for _ in range(n):
                run(flash_tower)
            flash_ms = (time.perf_counter() - t0) / n * 1e3
            counts = read_counts(torch, f"path C tower {str(dtype)[6:]}",
                                 {"flash_attention": 12 * (n + 1)})
            want = block_tower(wav, pad, weights)
            t0 = time.perf_counter()
            for _ in range(n):
                run(block_tower)
            block_ms = (time.perf_counter() - t0) / n * 1e3
        frames = got["x"].shape[1]
        require(tuple(got["x"].shape) == (b, frames, 768) and frames == 1499,
                f"path C: {tuple(got['x'].shape)}")
        require(bool(torch.equal(got["padding_mask"], want["padding_mask"])), "path C: masks")
        worst = 0.0
        for key in ("x", "weighted_sum"):
            a, w = got[key].float(), want[key].float()
            require(bool(torch.isfinite(a).all()), f"path C {key}: non-finite")
            err = (a - w).abs().max().item()
            rel = ((a - w).pow(2).mean().sqrt() / w.pow(2).mean().sqrt()).item()
            worst = max(worst, err if dtype == torch.float32 else rel)
        tol = "max abs <= 1e-4" if dtype == torch.float32 else "rms(diff)/rms <= 5e-2"
        print(f"[path C] HuBERT-base tower B={b} x {t} samples ({frames} frames) "
              f"{str(dtype)[6:]}: K4 route vs K1 route {worst:.3e} ({tol}); K4 route "
              f"{flash_ms:.2f} ms/forward, K1 route {block_ms:.2f} ms/forward (n={n})")
        require(worst <= (1e-4 if dtype == torch.float32 else 5e-2),
                f"path C {dtype}: K4 and K1 routes differ by {worst}")
        del flash_tower, block_tower, got, want
        torch.cuda.empty_cache()
    return counts


def phase_conv0(torch):
    """Path D: the public `conv0` (K6), which no model calls, on the WavLM
    tower's layer-0 weights at the training batch, against the tower's own
    layer-0 convolution (cuDNN, TF32 off)."""
    from speechclip_plus_tpu_torch.models.hubert import HubertConfig, HubertModel
    from speechclip_plus_tpu_torch.ops.conv_frontend import conv0
    from speechclip_plus_tpu_torch.tasks.builder import init_params

    torch.backends.cudnn.allow_tf32 = False
    tower = HubertModel(HubertConfig.wavlm_base())
    init_params(tower, torch.Generator().manual_seed(0))
    conv = tower.feature_extractor.conv_layers[0].to("cuda")
    wav = train_batch(torch, TRAIN_BATCH, TRAIN_WAV, 8, seed=2)["wav"]
    reset_counts()
    got = conv0(wav, conv.weight.detach().permute(2, 1, 0), stride=conv.stride[0])
    counts = read_counts(torch, "path D conv0", {"conv0": 1})
    with torch.no_grad():
        want = conv(wav[:, None]).transpose(1, 2)
    err = (got - want).abs().max().item()
    print(f"[path D] conv0 B={TRAIN_BATCH} x {TRAIN_WAV} fp32 on the tower's layer-0 weights: "
          f"{tuple(got.shape)}, vs the tower's convolution max_abs_err={err:.3e} (<= 1e-4)")
    require(tuple(got.shape) == (TRAIN_BATCH, 20479, 512) and bool(torch.isfinite(got).all()),
            f"path D: {tuple(got.shape)}")
    require(err <= 1e-4, f"path D: conv0 differs from the tower's convolution by {err}")
    return counts


def phase_train_parity(torch, label, config, clip_keys=None, batch_size=2,
                       zero=("head.linear_proj.bias",)):
    """One training step (fp32, training statistics on, dropout off) on the
    card and on the CPU from the same weights. The tensors named by `zero`
    have a zero gradient in exact arithmetic: a bias that reaches the keyword
    BN through linear maps only is a shift that the batch statistics take out
    again (the head's projection bias; in the fixed-K families also the
    branch LayerNorm's, which the head projects directly). Both sides hold
    rounding noise there, which is bounded (1e-3 of the whole gradient's
    norm) and not compared; every other tensor is compared unless it is
    below 1e-6 of the norm on both sides. The fixed-K families take B=4: at
    B=2 a batch-statistics BN puts out +-1 whatever comes in, and every
    gradient ahead of it is noise."""
    from speechclip_plus_tpu_torch.optim.optimizer import (
        build_optimizer_from_config, trainable_parameters)
    from speechclip_plus_tpu_torch.parallel.train_step import (
        create_train_state, make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg, cpu_model, model_cfg = build(torch, config, device="cpu", precision=32,
                                      clip_keys=clip_keys)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    batch = train_batch(torch, batch_size, 48000, model_cfg.clip.image_resolution, seed=3)
    batch["wav_len"][:2] = torch.tensor([48000, 36000], device="cuda")
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
    worst, worst_name, noise, tiny = 1.0, None, [], []
    for n in gc:
        a, b = gg[n].flatten().double(), gc[n].flatten().double()
        size = max(a.norm().item(), b.norm().item()) / total
        if n.endswith(tuple(zero)):
            noise.append(f"{n} ({size:.1e} of the norm)")
            require(size <= 1e-3, f"{label}: {n} should have no gradient, has {size} of the norm")
            continue
        if size <= 1e-6:
            tiny.append(n)
            continue
        cos = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
        if cos < worst:
            worst, worst_name = cos, f"{n}, {size:.1e} of the norm"
    perr = max((pg[n] - pc[n]).abs().max().item() for n in pc)
    # a scalar's cosine is its sign: each 0-d gradient (a learnable temperature's,
    # K3b's dt for the VQ's) is held to 1e-3 of its size
    scalars = {n: (gg[n].item(), gc[n].item()) for n in gc if gc[n].dim() == 0}
    scalar_err = {n: abs(a - b) / max(abs(b), 1e-12) for n, (a, b) in scalars.items()}
    print(f"[parity] {label} 0-d gradients, card vs CPU: " + ", ".join(
        f"{n} {a:.7e} vs {b:.7e} (rel {scalar_err[n]:.2e})" for n, (a, b) in scalars.items()))
    require(all(e <= 1e-3 for e in scalar_err.values()), f"{label}: 0-d gradients {scalar_err}")
    print(f"[parity] {label} training step fp32 B={batch_size}, card vs CPU: loss {lg:.7f} vs "
          f"{lc:.7f} (rel {rel:.2e}), min gradient cosine {worst:.7f} ({worst_name}) over "
          f"{len(gc) - len(noise) - len(tiny)} tensors; zero by rule, at rounding noise: "
          f"{noise}; below 1e-6 of the norm on both sides: {tiny}; updated parameters "
          f"max_abs_err {perr:.2e} ({time.perf_counter() - t0:.1f} s)")
    require(rel <= 1e-5, f"training loss rel error {rel} > 1e-5")
    require(worst >= 0.9999, f"gradient cosine {worst} < 0.9999")
    require(perr <= 1e-5, f"updated parameters differ by {perr} > 1e-5")


def phase_parity(torch, label, config, clip_keys=None):
    """Serving on the card (kernels) against the same fp32 weights on the CPU
    (plain twins): the features the family has, keyword counts, VQ targets
    and top-10 ids."""
    from speechclip_plus_tpu_torch.api import SpeechCLIP
    from speechclip_plus_tpu_torch.serving import SpeechRetriever, build_image_index

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _, cpu_model, mc = build(torch, config, device="cpu", precision=32, clip_keys=clip_keys)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    cpu, gpu = SpeechCLIP(cpu_model, "cpu"), SpeechCLIP(gpu_model, "cuda")
    wavs = ragged_wavs(np.random.RandomState(7), 2, False)
    a, b = gpu.encode_speech(wavs), cpu.encode_speech(wavs)
    sources = [src for src in ("parallel", "cascaded") if a[f"{src}_audio_feat"] is not None]
    cosines = {src: torch.nn.functional.cosine_similarity(
        a[f"{src}_audio_feat"].cpu().float(), b[f"{src}_audio_feat"].float()).min().item()
        for src in sources}
    if mc.keyword_num is None:
        la = a["dsample_results"]["dsample_feats_length"].cpu()
        lb = b["dsample_results"]["dsample_feats_length"]
    else:  # a fixed number of keywords per utterance
        la = lb = torch.full((len(wavs),), mc.keyword_num)
    ta, tb = a["vq_results"]["targets"].cpu()[..., 0], b["vq_results"]["targets"][..., 0]
    valid = torch.arange(ta.shape[1])[None] < lb[:, None]
    agree = (ta == tb)[valid].float().mean().item()
    print(f"[parity] {label} fp32 card vs CPU: " + ", ".join(
              f"{src} cosine {c:.7f}" for src, c in cosines.items())
          + f", keywords_len {la.tolist()} vs {lb.tolist()}, VQ targets agree "
          f"on {agree * 100:.2f}% of valid slots")
    # the cascaded feature follows the VQ's argmax, which a last bit can move:
    # it is held through the targets and the top-10 ids
    first = sources[0]
    require(cosines[first] >= 0.9999, f"{first} cosine {cosines[first]} < 0.9999")
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
    for src in sources:
        ia, _ = SpeechRetriever(gpu, index, feat_src=src).search(wavs, k=10)
        ib, _ = SpeechRetriever(cpu, cpu_index, feat_src=src).search(wavs, k=10)
        require((ia == ib).all(), f"{src} top-10 ids differ: {ia} vs {ib}")
    print(f"[parity] {label} image feature cosine {cos_i:.7f}; top-10 ids equal for "
          f"{' and '.join(sources)} over a 1000-image index ({time.perf_counter() - t0:.1f} s)")


# ------------------------------------------------------------ phase J ----

FIT_CONFIG = "config/speechclip_plus/base/synthetic_fit.yaml"
FIT_TREE = dict(train=160, dev=24, test=8, caps=5)  # images per split, captions each
FIT_EPOCHS = 2  # of the first leg, each with validation
FIT_MORE = 3  # optimizer steps of the resumed run past the first leg


def fit_plans():
    """Launches of one unit of the fit: a training step with cached image
    features, one eval batch (both branches, no dropout) and one batch of the
    image cache (the ViT)."""
    step = {**speech_query_plan("k1", True), "fused_attention_block_bwd": 1,
            "fused_cosine_vq_bwd": 1}
    return step, speech_query_plan("k1", True), k1_plan(12)


def fit_run(torch, label, cfg, save_path, tree, argv=(), njobs=4):
    """One `run_task` of TrainKWClip_GeneralTransformer on the card with `cfg`
    in memory and `njobs` decode workers (0: the prefetch thread); returns
    (trainer, seconds, state snapshot on the host)."""
    from speechclip_plus_tpu_torch.run_task import main as run_task

    t0 = time.perf_counter()
    trainer = run_task(["TrainKWClip_GeneralTransformer", "--train", "--device", "cuda",
                        "--dataset_root", tree, "--save_path", save_path, "--seed", "0",
                        "--njobs", str(njobs), "--log_level", "WARNING", *argv], config=cfg)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    snap = ({k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()},
            {i: {k: v.detach().cpu().clone() for k, v in st.items()}
             for i, st in trainer.optimizer.adam.state_dict()["state"].items()})
    print(f"[fit] {label} ({njobs} decode workers): {trainer.state.step} micro-steps, epoch "
          f"{trainer.epoch}, in {sec:.1f} s")
    return trainer, sec, snap


def free_cuda(torch):
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def state_difference(torch, a, b):
    """(largest |a - b| over model tensors and Adam state, names of the
    tensors that differ)."""
    worst, names = 0.0, []
    pairs = [(k, a[0][k], b[0][k]) for k in a[0]]
    pairs += [(f"adam[{i}].{k}", a[1][i][k], b[1][i][k]) for i in a[1] for k in a[1][i]]
    for name, x, y in pairs:
        if not torch.equal(x, y):
            names.append(name)
            if x.is_floating_point():
                worst = max(worst, (x.double() - y.double()).abs().max().item())
    return worst, names


_TREES = {}  # synthetic trees by size, written once a run (phase J and path Q share one)


def synthetic_tree(label, sizes):
    """The Flickr-shaped tree of `sizes` that `make_synthetic_tree` writes,
    once a run, under a temporary directory that `remove_trees` deletes."""
    key = tuple(sorted(sizes.items()))
    if key in _TREES:
        print(f"[{label}] the synthetic tree written earlier in this run, {sizes}")
    else:
        import tempfile

        tmp = tempfile.mkdtemp(prefix="chip_smoke_tree_")
        t0 = time.perf_counter()
        made = make_synthetic_tree(os.path.join(tmp, "flickr"), sizes)
        print(f"[{label}] {made} in {time.perf_counter() - t0:.1f} s")
        _TREES[key] = tmp
    return os.path.join(_TREES[key], "flickr")


def remove_trees():
    import shutil

    for tmp in _TREES.values():
        shutil.rmtree(tmp, ignore_errors=True)
    _TREES.clear()


def make_synthetic_tree(root, sizes):
    out = subprocess.run(
        [sys.executable, "scripts/make_synthetic_dataset.py", "--root", root,
         "--train-images", str(sizes["train"]), "--dev-images", str(sizes["dev"]),
         "--test-images", str(sizes["test"]), "--caps-per-image", str(sizes["caps"])],
        capture_output=True, text=True, timeout=300)
    require(out.returncode == 0, f"synthetic dataset: {out.stderr[-2000:]}")
    return out.stdout.strip()


def phase_fit(torch, bare_ms):
    """Phase J: the port's training entry point, `run_task
    TrainKWClip_GeneralTransformer --train`, on a synthetic Flickr-shaped tree
    written by `scripts/make_synthetic_dataset.py` under a temporary directory:
    hybrid+ base at full width (bf16, B=128 crops of 102400 samples, dev
    batches of 64) with the image cache, FIT_EPOCHS epochs with validation,
    keyword artifacts and checkpoints; then `--resume` from checkpoints/last
    for FIT_MORE optimizer steps, against an unbroken run over the same steps
    that reads its batches through the prefetch thread. Returns the launch
    counts of the three runs."""
    import shutil
    import tempfile

    from speechclip_plus_tpu_torch.api import SpeechCLIP
    from speechclip_plus_tpu_torch.config import load_config
    from speechclip_plus_tpu_torch.tasks import trainer as trainer_module

    tmp = tempfile.mkdtemp(prefix="chip_smoke_fit_")
    try:
        tree = synthetic_tree("fit", FIT_TREE)

        def cfg_for(max_steps, artifacts):
            cfg = load_config(FIT_CONFIG)  # the YAML stays as it is; overrides in memory
            cfg.trainer.max_steps = max_steps
            cfg.trainer.log_every_n_steps = 2
            cfg.log_setting.log_detokenize_results = artifacts
            cfg.log_setting.log_detokenize_results_every_n_epoch = FIT_EPOCHS
            cfg.log_setting.log_draw_pca_every_n_epoch = FIT_EPOCHS
            return cfg

        base = load_config(FIT_CONFIG)
        batch, dev_batch = int(base.data.batch_size), int(base.data.dev_batch_size)
        per_epoch = FIT_TREE["train"] * FIT_TREE["caps"] // batch
        dev_batches = -(-FIT_TREE["dev"] * FIT_TREE["caps"] // dev_batch)
        cache_batches = -(-FIT_TREE["train"] // 64) + -(-FIT_TREE["dev"] // 64)
        first_leg = FIT_EPOCHS * per_epoch
        total = first_leg + FIT_MORE

        restored = {}
        resume = trainer_module.Trainer.resume

        def recording_resume(self, path):
            resume(self, path)
            restored.update(step=self.state.step, epoch=self.epoch, skip=self._skip_batches)

        trainer_module.Trainer.resume = recording_resume
        reset_counts()
        try:
            stop_dir, resumed_dir, whole_dir = (os.path.join(tmp, d)
                                                for d in ("stop", "resumed", "unbroken"))
            first, first_s, first_state = fit_run(torch, f"first leg, {first_leg} steps",
                                                  cfg_for(first_leg, True), stop_dir, tree)
            timings = first.timings
            # path K's reference: the first leg's final model on a B=8 ragged
            # batch (one encode_speech, in J's plan)
            k_wavs = ragged_wavs(np.random.RandomState(11), 8, False)
            k_reference = {key: value.detach().cpu().clone() for key, value in
                           SpeechCLIP(first.model, "cuda").encode_speech(k_wavs).items()
                           if key in ("parallel_audio_feat", "cascaded_audio_feat")}
            fit_model_cfg = first.model.cfg
            del first
            free_cuda(torch)
            second, _, resumed = fit_run(
                torch, f"--resume from checkpoints/last to {total} steps",
                cfg_for(total, False), resumed_dir, tree,
                ("--resume", os.path.join(stop_dir, "checkpoints", "last")))
            validations = len(second.timings["validate_s"])
            del second
            free_cuda(torch)
            # the unbroken run reads its batches through the prefetch thread:
            # the batches do not depend on the worker count
            whole, _, unbroken = fit_run(torch, f"unbroken run of {total} steps",
                                         cfg_for(total, False), whole_dir, tree, njobs=0)
            validations += len(whole.timings["validate_s"]) + len(timings["validate_s"])
            thread_timings = whole.timings
            del whole
            free_cuda(torch)
        finally:
            trainer_module.Trainer.resume = resume
        step_plan, eval_plan, cache_plan = fit_plans()
        expect = {}
        add_counts(expect, step_plan, first_leg + FIT_MORE + total)
        add_counts(expect, eval_plan, validations * dev_batches)
        add_counts(expect, cache_plan, 3 * cache_batches)
        add_counts(expect, speech_query_plan("k1", True))  # path K's reference
        counts = read_counts(torch, "J fit (three runs)", expect)

        # what the first leg left, and what the resumed run restored
        ck = os.path.join(stop_dir, "checkpoints")
        for name in ("last", "val_loss", "val_recall_mean_10"):
            kept = [d for d in os.listdir(os.path.join(ck, name)) if d.isdigit()]
            require(kept, f"fit: checkpoints/{name} holds no step")
        with open(os.path.join(ck, "fit_state.json")) as f:
            fit_state = json.load(f)
        require(fit_state == {"epoch": FIT_EPOCHS, "opt_step": first_leg, "batches_done": 0},
                f"fit: fit_state.json {fit_state}")
        require(restored == {"step": first_leg, "epoch": FIT_EPOCHS, "skip": 0},
                f"fit: restored {restored}, expected step {first_leg} epoch {FIT_EPOCHS}")
        for run in (resumed_dir, whole_dir, stop_dir):
            with open(os.path.join(run, "metrics.jsonl")) as f:
                rows = [json.loads(line) for line in f]
            bad = [(k, v) for r in rows for k, v in r.items()
                   if isinstance(v, float) and not np.isfinite(v)]
            require(rows and not bad, f"fit: {run}: non-finite metrics {bad[:5]}")
        train_rows = [r for r in rows if "train_loss" in r]
        val_rows = [r for r in rows if "val_loss" in r]
        require(len(val_rows) == FIT_EPOCHS + 1 and all("val_recall_mean_10" in r for r in val_rows),
                f"fit: {len(val_rows)} validations logged")
        artifacts = sorted(os.listdir(os.path.join(stop_dir, "retokenizeText")))
        require(artifacts == [f"keywords_ep{FIT_EPOCHS}.json"], f"fit: artifacts {artifacts}")

        # the loop's own clock, two ways: the median of the Trainer's
        # steps_per_sec windows after the first step (which holds the loader's
        # start and the first launches), which drops the windows that hold an
        # epoch's restart; and the whole: every step over the Trainer's passes
        # over the loader, each from the loader's start to the end of its last
        # step on the card, so the restarts are in it and validation and
        # saves are not
        print(card_line())
        for what, path, t in (("4 decode workers (first leg)", stop_dir, timings),
                              ("the prefetch thread (unbroken run)", whole_dir, thread_timings)):
            with open(os.path.join(path, "metrics.jsonl")) as f:
                rates = [r["steps_per_sec"] for r in map(json.loads, f)
                         if "steps_per_sec" in r and r["micro_step"] > 1]
            window_ms = 1e3 / float(np.median(rates))
            wait = np.array(t["loader_wait_s"]) * 1e3
            whole_ms = 1e3 * sum(t["train_s"]) / len(wait)
            print(f"[fit] loop with {what}, B={batch}: median window {window_ms:.2f} ms/step, "
                  f"{batch * 1e3 / window_ms:.1f} pairs/s ({len(rates)} steps_per_sec windows of "
                  f"2 steps), {window_ms / bare_ms:.2f}x the bare step; whole {whole_ms:.2f} "
                  f"ms/step, {batch * 1e3 / whole_ms:.1f} pairs/s ({len(wait)} steps in "
                  f"{sum(t['train_s']):.2f} s of {len(t['train_s'])} passes over the loader), "
                  f"{whole_ms / bare_ms:.2f}x the bare step; bare step of phase 6 in this run "
                  f"{bare_ms:.2f} ms/step")
            # every training batch pads to the top bucket, max_audio_len: the
            # synthetic wavs are uniform in 2-6.4 s, so a batch of 128 without
            # one over 5 s (the next bucket down) has odds of (3/4.4)^128
            wav_len = int(base.audio_encoder.max_audio_len)
            for clock, ms in (("median window", window_ms), ("whole", whole_ms)):
                print_mfu(f"J fit loop with {what}, {clock}", fit_model_cfg, batch, wav_len,
                          True, ms)
            print(f"[fit] loader wait per step (next batch + copy to the card) with {what}: "
                  f"median {np.median(wait):.2f} ms, mean {wait.mean():.2f}, max {wait.max():.2f} "
                  f"over {len(wait)} steps")
        print(f"[fit] first leg {first_s:.1f} s: image cache "
              f"{', '.join(f'{t:.2f}' for t in timings['image_cache_s'])} s "
              f"(train, dev: {cache_batches} ViT batches of 64); validation "
              f"{', '.join(f'{t:.2f}' for t in timings['validate_s'])} s ({dev_batches} "
              f"batches of {dev_batch}; keyword artifacts "
              f"{', '.join(f'{t:.2f}' for t in timings['artifacts_s'])} s of them); checkpoint "
              f"save {', '.join(f'{t:.2f}' for t in timings['save_s'])} s")
        print(f"[fit] losses: train {train_rows[0]['train_loss']:.4f} -> "
              f"{train_rows[-1]['train_loss']:.4f}; val_loss "
              + ", ".join(f"{r['val_loss']:.4f}" for r in val_rows) + "; val_recall_mean_10 "
              + ", ".join(f"{r['val_recall_mean_10']:.2f}" for r in val_rows))
        worst, names = state_difference(torch, resumed, unbroken)
        print(f"[fit] resumed vs unbroken after {total} steps: "
              + ("bit-identical (model state_dict and Adam state)" if not names else
                 f"{len(names)} tensors differ, max |diff| {worst:.3e}: {names[:8]}"))
        require(not names, "fit: the resumed run differs from the unbroken run")
        k_counts = phase_inference(torch, ck, tree, tmp, first_state[0], k_wavs, k_reference)
        return counts, k_counts
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------ path Q ----

DP_FIRST, DP_TOTAL = 6, 8  # Q1: optimizer steps of the first leg, and with the resumed one
DP_Q2_STEPS = 3


def rank_env(port=None, rank=0, world=1):
    """This environment with torchrun's variables for `rank` of `world` (a
    free local port where `port` is None)."""
    if port is None:
        from speechclip_plus_tpu_torch.tasks.base_task import free_port

        port = free_port()
    return dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))


def bare_env():
    """This environment without any process-group variables."""
    drop = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
            "SPEECHCLIP_MULTIHOST", "SPEECHCLIP_COORDINATOR")
    return {k: v for k, v in os.environ.items() if k not in drop}


def set_keys(cfg, overrides):
    """Sets {dotted key: value} on a loaded config, as a YAML would."""
    for dotted, value in overrides.items():
        node = cfg
        *parents, leaf = dotted.split(".")
        for key in parents:
            node = getattr(node, key)
        setattr(node, leaf, value)


class _TimedStep:
    """A train step that appends (seconds, collective seconds, collective
    calls) of each call to `log`, the card synchronized before and after."""

    def __init__(self, step_fn, log, tally, torch):
        self.__dict__.update(_fn=step_fn, _log=log, _tally=tally, _torch=torch)

    def __call__(self, *args, **kw):
        sync = self._torch.cuda.synchronize
        sync()
        before, t = dict(self._tally), time.perf_counter()
        out = self._fn(*args, **kw)
        sync()
        self._log.append((time.perf_counter() - t, self._tally["s"] - before["s"],
                          self._tally["n"] - before["n"]))
        return out

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __setattr__(self, name, value):
        setattr(self._fn, name, value)


@contextlib.contextmanager
def timed_steps(torch, log):
    """Within: each training step a Trainer makes is timed into `log`
    (`_TimedStep`), and so is every collective of torch.distributed, from a
    synchronized card to a synchronized card (the step's compute is the rest
    of its time)."""
    import torch.distributed as dist
    from speechclip_plus_tpu_torch.tasks import trainer as trainer_module

    tally = {"s": 0.0, "n": 0}

    def timed(fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            tally["s"] += time.perf_counter() - t
            tally["n"] += 1
            return out
        return call

    names = [n for n in ("all_reduce", "all_gather", "broadcast", "all_gather_into_tensor",
                         "reduce_scatter_tensor") if hasattr(dist, n)]
    saved = {n: getattr(dist, n) for n in names}
    make = trainer_module.make_train_step
    trainer_module.make_train_step = lambda *a, **kw: _TimedStep(make(*a, **kw), log, tally,
                                                                  torch)
    for n in names:
        setattr(dist, n, timed(saved[n]))
    try:
        yield
    finally:
        trainer_module.make_train_step = make
        for n in names:
            setattr(dist, n, saved[n])


def fit_leg(rank, spec):
    """A leg of path Q1, R1 or R2 (rank `rank` of it): the fits spec["runs"]
    names, in turn in this process, each `run_task
    TrainKWClip_GeneralTransformer --train` on the card with
    synthetic_fit.yaml overridden in memory (the run's "cfg", dotted keys; no
    keyword artifacts) and the prefetch thread, under spec["group"]: None (no
    process group), "nccl" (torchrun's variables, rank `rank` of
    spec["world"] on cuda:rank) or "gloo" (every rank on cuda:0: NCCL refuses
    two ranks on one device). Each fit writes <its "out">.<rank>.json: the
    launch counts from 0 at its start, the steps taken, the Trainer's
    timings, the data group's world size (None without a group), the model
    group's, the gradient all-reduce's bytes, the fit's seconds and the
    process's start and group before the first fit; with spec["ids"] the
    first training step's keyword ids, and with the run's "profile" each
    training step's seconds beside its collectives' (`timed_steps`)."""
    t0 = time.perf_counter()
    import gc

    import torch
    from speechclip_plus_tpu_torch.config import load_config
    from speechclip_plus_tpu_torch.models import branches
    from speechclip_plus_tpu_torch.parallel.multihost import maybe_initialize_distributed
    from speechclip_plus_tpu_torch.run_task import main as run_task

    label, backend = spec["label"], spec["group"]
    if backend is not None:
        os.environ.update(rank_env(spec["port"], rank, spec["world"]))
        if backend == "gloo":  # every rank drives cuda:0 (the rank modulo the one GPU)
            os.environ.pop("LOCAL_RANK")
        require(maybe_initialize_distributed(device="cuda",
                                             backend=None if backend == "nccl" else backend),
                f"{label}: no process group")
    ids, steps = [], []
    if spec.get("ids"):
        fused = branches.fused_cosine_vq

        def recording(*args, **kw):  # the first training step's keyword ids
            res = fused(*args, **kw)
            if kw.get("training") and not ids:
                ids.append(res["targets"].reshape(-1).cpu().tolist())
            return res

        branches.fused_cosine_vq = recording
    start_s = time.perf_counter() - t0
    try:
        for run in spec["runs"]:
            t = time.perf_counter()
            cfg = load_config(FIT_CONFIG)
            cfg.log_setting.log_detokenize_results = False
            set_keys(cfg, run["cfg"])
            ids.clear()
            steps.clear()
            reset_counts()
            with timed_steps(torch, steps) if run.get("profile") else contextlib.nullcontext():
                trainer = run_task(["TrainKWClip_GeneralTransformer", "--train", "--device",
                                    "cuda", "--dataset_root", spec["tree"], "--save_path",
                                    run["save"], "--seed", "0", "--njobs", "0", "--log_level",
                                    "WARNING", *run["argv"]], config=cfg)
                torch.cuda.synchronize()
            # a thread still running at the interpreter's exit is killed wherever it
            # stands: run_task leaves none (the leg then exits through the normal
            # teardown, and finish_leg holds its exit code)
            alive = [th.name for th in threading.enumerate()
                     if th is not threading.main_thread()]
            require(not alive, f"{label}: threads alive after run_task: {alive}")
            with open(f"{run['out']}.{rank}.json", "w") as f:
                json.dump({"counts": {k: getattr(*_counter(k)) for k in KERNEL_COUNTERS},
                           "timings": trainer.timings, "steps": trainer.state.step,
                           "world": None if trainer.group is None else trainer.group.world,
                           "tp": 1 if trainer.model_group is None
                           else trainer.model_group.model_world,
                           "reduce_bytes": trainer.train_step.reduce_bytes,
                           "run_s": time.perf_counter() - t, "start_s": start_s,
                           "targets": ids[0] if ids else None, "profile": list(steps)}, f)
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if backend is not None:
            torch.distributed.destroy_process_group()


def leg_main(spec):
    """`--leg`: a leg's ranks, each a process of its own where there are
    several (spawned here), or this process."""
    if spec["world"] == 1:
        fit_leg(0, spec)
        return
    import torch.multiprocessing as mp

    mp.start_processes(fit_leg, args=(spec,), nprocs=spec["world"], join=True,
                       start_method="spawn")


def start_leg(spec, mode="--leg"):
    """A leg (`leg_main`, or `dp_q2` for mode "--dp-q2") in a subprocess of
    this script without process-group variables, under Python's fault handler
    (which prints every thread's stack on a fatal signal), its output to
    files: a handle for `finish_leg`. A leg under a group gets a free port."""
    from speechclip_plus_tpu_torch.tasks.base_task import free_port

    if spec.get("group") or mode != "--leg":
        spec = dict(spec, port=free_port())
    logs = [tempfile.TemporaryFile("w+") for _ in range(2)]
    proc = subprocess.Popen([sys.executable, "-X", "faulthandler", os.path.abspath(__file__),
                             mode, json.dumps(spec)], env=bare_env(), stdout=logs[0],
                            stderr=logs[1], text=True)
    return spec, proc, logs, time.perf_counter()


def finish_leg(leg, timeout=600):
    """Waits for a leg; fails unless it exits 0. Returns {fit: [rank 0's
    result, ...]} (`fit_leg`), or the result at spec["out"] (`dp_q2`)."""
    spec, proc, logs, t = leg
    label = spec["label"]
    try:
        code = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        code = proc.wait()
    text = []
    for log in logs:
        log.seek(0)
        text.append(log.read())
        log.close()
    require(code == 0, f"{label}: exit {code} after {time.perf_counter() - t:.1f} s; stdout: "
                       f"{text[0][-2000:]}; stderr: {text[1][-8000:]}")
    if "runs" not in spec:
        with open(spec["out"]) as f:
            out = json.load(f)
    else:
        out = {}
        for run in spec["runs"]:
            out[run["name"]] = []
            for r in range(spec["world"]):
                with open(f"{run['out']}.{r}.json") as f:
                    out[run["name"]].append(json.load(f))
    print(f"[path {label[0]}] {label} ({spec['world']} rank{'s' if spec['world'] > 1 else ''}): "
          f"exit 0, {time.perf_counter() - t:.1f} s with the process's start")
    return out


def fit_run_spec(tmp, name, cfg, argv=(), profile=False):
    """A fit of a leg: `run_task` saving under <tmp>/<name>."""
    return {"name": name, "save": os.path.join(tmp, name), "out": os.path.join(tmp, name),
            "cfg": cfg, "argv": list(argv), "profile": profile}


def leg_rows(save):
    with open(os.path.join(save, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    bad = [(k, v) for r in rows for k, v in r.items()
           if isinstance(v, float) and not np.isfinite(v)]
    require(rows and not bad, f"Q1: {save}: non-finite metrics {bad[:5]}")
    return rows


def saved_state(torch, save, step):
    """(model state_dict, Adam state) of the checkpoint of `step` under any
    manager of a run's `checkpoints/`."""
    for manager in ("last", "val_recall_mean_10", "val_loss"):
        path = os.path.join(save, "checkpoints", manager, str(step), "state.pt")
        if os.path.exists(path):
            payload = torch.load(path, map_location="cpu", weights_only=True)
            return payload["model"], payload["optimizer"]["state"]
    raise SmokeFailure(f"Q1: no checkpoint of step {step} under {save}")


def loop_ms(rows, timings):
    """(median steps_per_sec window ms/step after the first step, the whole:
    every step over the passes over the loader)."""
    rates = [r["steps_per_sec"] for r in rows if "steps_per_sec" in r and r["micro_step"] > 1]
    return (1e3 / float(np.median(rates)),
            1e3 * sum(timings["train_s"]) / len(timings["loader_wait_s"]))


def phase_dp(torch):
    """Path Q, data parallelism through the training entry point on phase J's
    synthetic tree (hybrid+ base, full width, B=128, bf16, the prefetch
    thread), each leg `run_task` in a process of its own (`start_leg`). Q1:
    a leg without a process group over DP_TOTAL steps (validation and a save
    at step 6 and at the end), a leg under NCCL at world size 1 (torchrun's
    variables) over DP_FIRST steps, and a leg resumed from it to DP_TOTAL:
    the logged losses and the step-6 state of the NCCL leg, and the final
    state of the resumed one, against the group-less leg bit for bit (model
    state_dict and Adam state); ms/step of both legs, the all-reduce's
    seconds and bytes, and the launch counts against phase J's plan. Q2 (two
    ranks under NCCL) where the machine has two GPUs. Returns the launch
    counts by leg."""
    import shutil

    free_cuda(torch)  # the legs are processes of their own on the same card
    free, total = torch.cuda.mem_get_info()
    print(f"[path Q] the card: {free / 2**30:.2f} of {total / 2**30:.2f} GiB free for the legs "
          f"({torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved by this process)")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        tree = synthetic_tree("path Q", FIT_TREE)
        saves = {name: os.path.join(tmp, name) for name in ("alone", "nccl", "resumed")}

        def leg(name, max_steps, group, argv=()):
            run = fit_run_spec(tmp, name, {"trainer.max_steps": max_steps,
                                           "trainer.log_every_n_steps": 2}, argv)
            return finish_leg(start_leg({"label": f"Q1 {name}", "tree": tree, "world": 1,
                                         "group": group, "runs": [run]}))[name][0]

        alone = leg("alone", DP_TOTAL, None)
        nccl = leg("nccl", DP_FIRST, "nccl")
        resumed = leg("resumed", DP_TOTAL, "nccl",
                      ("--resume", os.path.join(saves["nccl"], "checkpoints", "last")))
        require(alone["world"] is None and nccl["world"] == 1 and resumed["world"] == 1,
                f"Q1: process groups {alone['world']}, {nccl['world']}, {resumed['world']}")
        require((alone["steps"], nccl["steps"], resumed["steps"])
                == (DP_TOTAL, DP_FIRST, DP_TOTAL), "Q1: steps taken")

        # launches: phase J's plan of a step, an eval batch and an image-cache batch
        from speechclip_plus_tpu_torch.config import load_config

        base = load_config(FIT_CONFIG)
        dev_batches = -(-FIT_TREE["dev"] * FIT_TREE["caps"] // int(base.data.dev_batch_size))
        cache_batches = -(-FIT_TREE["train"] // 64) + -(-FIT_TREE["dev"] // 64)
        step_plan, eval_plan, cache_plan = fit_plans()
        by_path = {}
        for name, res, steps in (("alone", alone, DP_TOTAL), ("nccl", nccl, DP_FIRST),
                                 ("resumed", resumed, DP_TOTAL - DP_FIRST)):
            expect = {}
            add_counts(expect, step_plan, steps)
            add_counts(expect, eval_plan, len(res["timings"]["validate_s"]) * dev_batches)
            add_counts(expect, cache_plan, cache_batches)
            by_path[f"Q1_{name}"] = compare_counts(f"Q1 {name} ({steps} steps)", res["counts"],
                                                   expect)
        print(f"[path Q] launches per training step, as phase J's plan (K1 / K1a / K2 / K3 / "
              f"K3b): " + " / ".join(str(step_plan.get(k, 0)) for k in (
                  "fused_attention_block", "projection_gemm", "fused_attention_block_bwd",
                  "fused_cosine_vq", "fused_cosine_vq_bwd")))

        # the NCCL legs against the leg without a group
        rows = {name: leg_rows(save) for name, save in saves.items()}
        first = {r["micro_step"]: r for r in rows["alone"]
                 if "train_loss" in r and r["micro_step"] <= DP_FIRST}
        got = {r["micro_step"]: r for r in rows["nccl"] if "train_loss" in r}
        require(got.keys() == first.keys(), f"Q1: logged steps {sorted(got)} vs {sorted(first)}")
        worst_loss, differ = 0.0, []
        for step, want in first.items():
            for key, value in want.items():
                if key.startswith("train_") or key == "grad_norm":
                    if got[step][key] != value:
                        differ.append(f"{key}@{step}")
                    if key == "train_loss":
                        worst_loss = max(worst_loss, abs(got[step][key] - value) / abs(value))
        val = {name: [r for r in rows[name] if "val_loss" in r] for name in saves}
        same_val = val["nccl"][0] == {**val["alone"][0], "time": val["nccl"][0]["time"]}
        print(f"[path Q] Q1 logged train metrics at micro-steps {sorted(first)}, NCCL world 1 "
              f"against no group: " + ("bit-identical" if not differ else
                                       f"{len(differ)} differ ({differ[:6]}), loss by at most "
                                       f"{worst_loss:.3e} relative")
              + f"; validation at step {DP_FIRST}: "
              + ("bit-identical" if same_val else f"{val['nccl'][0]} vs {val['alone'][0]}"))
        require(worst_loss <= 1e-6, f"Q1: losses differ by {worst_loss:.3e} relative")
        for label, a, b in (
                (f"NCCL leg at step {DP_FIRST} vs no group", saved_state(torch, saves["nccl"],
                                                                   DP_FIRST),
                 saved_state(torch, saves["alone"], DP_FIRST)),
                (f"resumed NCCL leg at step {DP_TOTAL} vs the unbroken run without a group",
                 saved_state(torch, saves["resumed"], DP_TOTAL),
                 saved_state(torch, saves["alone"], DP_TOTAL))):
            worst, names = state_difference(torch, a, b)
            print(f"[path Q] Q1 {label}: " + (
                "bit-identical (model state_dict and Adam state)" if not names else
                f"{len(names)} tensors differ, max |diff| {worst:.3e}: {names[:8]}"))
            require(not names, f"Q1: {label} differs")

        print(card_line())
        for name in ("alone", "nccl"):
            median, whole = loop_ms(rows[name], (alone if name == "alone" else nccl)["timings"])
            print(f"[path Q] Q1 loop ms/step, B={int(base.data.batch_size)}, "
                  f"{'no process group' if name == 'alone' else 'NCCL world size 1'}: median "
                  f"window {median:.2f}, whole {whole:.2f}")
        reduce_ms = np.array(nccl["timings"]["allreduce_s"] + resumed["timings"]["allreduce_s"]
                             ) * 1e3
        require(len(reduce_ms) == DP_TOTAL, f"Q1: {len(reduce_ms)} all-reduce times")
        print(f"[path Q] Q1 gradient all-reduce (NCCL, world size 1, one flat fp32 buffer of "
              f"{nccl['reduce_bytes']} bytes = {nccl['reduce_bytes'] / 4e6:.3f} M parameters): "
              f"median {np.median(reduce_ms):.4f} ms, max {reduce_ms.max():.4f} ms per optimizer "
              f"step over {len(reduce_ms)} steps (CUDA events)")

        # Q2: two ranks under NCCL, where the machine has two GPUs
        gpus = torch.cuda.device_count()
        if gpus < 2:
            print(f"[path Q] Q2 (two ranks under NCCL, B=128 as 2 x 64) did not run: this "
                  f"machine shows {gpus} GPU; not a pass")
        else:
            legs = {world: finish_leg(start_leg({
                "label": f"Q2 world {world}", "world": world,
                "out": os.path.join(tmp, f"q2_{world}.json")}, mode="--dp-q2"))
                for world in (1, 2)}
            for key, rtol in (("loss", 1e-4), ("grad_norm", 1e-3)):
                a, b = np.array(legs[2][key]), np.array(legs[1][key])
                rel = np.abs(a - b) / np.abs(b)
                print(f"[path Q] Q2 {key} over {DP_Q2_STEPS} steps, two ranks vs one process: "
                      f"{a.tolist()} vs {b.tolist()}, relative {rel.max():.3e} (tolerance {rtol})")
                require(rel.max() <= rtol, f"Q2: {key} differs by {rel.max():.3e}")
        return by_path
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def dp_q2_rank(rank, spec):
    """One rank of path Q2: hybrid+ base on cuda:rank, DP_Q2_STEPS steps with
    dropout off on its rows of one B=128 batch (cached image features), the
    whole batch in one process when spec["world"] is 1."""
    import torch
    from speechclip_plus_tpu_torch.optim.optimizer import build_optimizer_from_config
    from speechclip_plus_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from speechclip_plus_tpu_torch.parallel.multihost import maybe_initialize_distributed
    from speechclip_plus_tpu_torch.parallel.train_step import (
        create_train_state, make_train_step)

    world = spec["world"]
    if world > 1:
        os.environ.update(rank_env(spec["port"], rank, world))
        require(maybe_initialize_distributed(device="cuda"), "Q2: no process group")
    torch.cuda.set_device(rank)
    try:
        group = make_mesh()
        cfg, model, model_cfg = build(torch, CONFIG, device=f"cuda:{rank}")
        optimizer = build_optimizer_from_config(model, cfg)
        state = create_train_state(optimizer)
        step_fn = make_train_step(model, optimizer, 1, group=group)
        batch = train_batch(torch, TRAIN_BATCH, TRAIN_WAV, model_cfg.clip.image_resolution,
                            seed=0)
        with torch.no_grad():
            batch["image_feat"] = model.encode_image_raw(batch.pop("image"))
        batch = shard_batch(batch, group)
        out = {"loss": [], "grad_norm": []}
        for _ in range(DP_Q2_STEPS):
            metrics = step_fn(state, batch, None)
            out["loss"].append(float(metrics["train_loss"]))
            out["grad_norm"].append(float(metrics["grad_norm"]))
        if rank == 0:
            with open(spec["out"], "w") as f:
                json.dump(out, f)
    finally:
        if world > 1:
            torch.distributed.destroy_process_group()


def dp_q2(spec):
    if spec["world"] == 1:
        dp_q2_rank(0, spec)
        return
    import torch.multiprocessing as mp

    mp.start_processes(dp_q2_rank, args=(spec,), nprocs=spec["world"], join=True,
                       start_method="spawn")


# ------------------------------------------------------------ path R ----

TP_SIZES = (2, 4)  # R0: the model groups the shard checks stand in for
TP_FIRST, TP_TOTAL = 3, 4  # R1: optimizer steps of the first leg, and with the resumed one
# R1's tree: 26 train images x 5 captions (one B=128 step an epoch, so that
# each fit ends on an epoch boundary), 12 dev images (one dev batch of 64);
# the fits validate (and save) only at their end, on crops of 2 s
# (`audio_encoder.max_audio_len`), so that the five processes of its three
# legs fit on the card side by side
TP_TREE = dict(train=26, dev=12, test=1, caps=5)
TP_AUDIO = 32000
# R1's limits against the one-process fit, set between the readings of the
# sound fit and of planted faults on an H100 (PERF.md, path R): step 1's loss
# 1.2e-4 sound (7.1e-4 at step 2 of tests/test_torch_cuda_dp.py's B=8), 5.7e-3
# with CLIP's c_proj partial not summed; grad_norm 4.4e-5 (8.3e-5) and 2.1e-4;
# Adam's first moment after 4 steps, the worst tensor, 8.5e-2 sound (the
# keyword head's, where 0.1 % of the keyword ids differ), 0.53 with K3b's shard
# dx not summed and 0.69 with CLIP's MLP input gradient not summed, two faults
# that leave the loss and grad_norm at their sound values
TP_LOSS_RTOL, TP_GRAD_NORM_RTOL, TP_MOMENT_RTOL = 2e-3, 1.5e-4, 0.2
# a trainable tensor whose moment is below this share of the largest holds
# rounding noise alone (the keyword projection's last bias, which has no
# gradient in exact arithmetic: 1.3e-8 of the largest)
TP_MOMENT_FLOOR = 1e-6


def tp_against_one(torch, tp_save, one_save, steps=TP_TOTAL, names=None):
    """A tensor-parallel fit against the one process's: step 1's relative
    differences of the logged loss and grad_norm, and of Adam's first moment
    after `steps` (whole tensors: a weighted sum of every step's clipped
    gradient) the largest relative difference ||m - m_one|| / ||m_one|| over
    the trainable tensors whose moment is at least TP_MOMENT_FLOOR of the
    largest one's. Returns ({"train_loss", "grad_norm", "moment"}, the
    tensor at the largest moment difference, how many tensors were held,
    and (name, ||m_one||, relative difference) of every tensor)."""
    got, want = ({r["micro_step"]: r for r in leg_rows(save) if "train_loss" in r}
                 for save in (tp_save, one_save))
    require(1.0 in got and 1.0 in want, "R1: step 1 was not logged")
    rels = {k: abs(got[1.0][k] - want[1.0][k]) / abs(want[1.0][k])
            for k in ("train_loss", "grad_norm")}
    m_tp, m_one = (saved_state(torch, save, steps)[1] for save in (tp_save, one_save))
    require(m_tp.keys() == m_one.keys(), "R1: the Adam states hold other tensors")
    norms = {i: float(m_one[i]["exp_avg"].float().norm()) for i in m_one}
    held = [i for i in norms if norms[i] >= TP_MOMENT_FLOOR * max(norms.values())]
    diff = {i: float((m_tp[i]["exp_avg"].float() - m_one[i]["exp_avg"].float()).norm())
            / max(norms[i], 1e-30) for i in norms}
    worst = max(held, key=diff.get)
    rels["moment"] = diff[worst]
    name = (lambda i: names[int(i)] if names else f"tensor {i}")
    return (rels, f"{name(worst)} {tuple(m_one[worst]['exp_avg'].shape)}", len(held),
            [(name(i), norms[i], diff[i]) for i in norms])


def shard_block(torch, x, w_in, b_in, w_out, r, tp):
    """Rank r's weights of a block sharded by head (`parallel/tp.py`)."""
    from speechclip_plus_tpu_torch.parallel.tp import shard_tensor

    return (shard_tensor("in_proj_weight", w_in, 0, r, tp).contiguous(),
            shard_tensor("in_proj_bias", b_in, 0, r, tp).contiguous(),
            shard_tensor("out_proj.weight", w_out, 1, r, tp).contiguous())


def library_shard_block(torch, x, w_in, b_in, w_out, bias, heads, p=0.0, ab=None, gate=None):
    """A head shard's block as library calls: cuBLAS linear + SDPA, and the
    partial out-projection in fp32 (what the kernel returns)."""
    F = torch.nn.functional
    b, t, _ = x.shape
    dr = w_out.shape[1]
    q, k, v = (a.reshape(b, t, heads, -1).transpose(1, 2)
               for a in F.linear(x, w_in, b_in.to(x.dtype)).split(dr, dim=-1))
    mask = None if bias is None else bias[:, None, None, :]
    if ab is not None:
        full = ab[None] if gate is None else gate[..., None] * ab[None]
        mask = full if mask is None else mask + full
    if mask is not None:
        mask = mask.to(x.dtype)
    ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, dropout_p=p)
    return F.linear(ctx.transpose(1, 2).reshape(b, t, dr).float(), w_out.float())


def partial_error(torch, fab, part, x, wi, bi, wo, bias, h, dtype, sl):
    """(max abs error, ok, tolerance text) of a shard's fp32 partial
    out-projection against its twin. fp32: abs <= 1e-4 x max(1, RMS); bf16:
    both round the context to bf16 before the product, so the error beyond
    what one ulp of each context element explains (Σ_k |Wo[i, k]| ulp(ctx_k))
    <= 2e-2 x RMS, as `compare` allows half an ulp of a bf16 output."""
    F = torch.nn.functional
    args = (x.float(), wi.float(), bi.float())
    twin = fab.plain_fused_attention_block(*args, wo.float(), None, bias, h, True, partial=True,
                                           **sl)
    err = (part - twin).abs()
    rms = twin.pow(2).mean().sqrt().item()
    if dtype == torch.float32:
        limit = 1e-4 * max(1.0, rms)
        return err.max().item(), err.max().item() <= limit, f"abs <= {limit:.2e}"
    ctx = fab.plain_fused_attention_block(*args, None, None, bias, h, False, **sl).to(dtype)
    _, exp = torch.frexp(ctx.float())
    explained = F.linear(torch.ldexp(torch.ones_like(ctx, dtype=torch.float32), exp - 8),
                         wo.float().abs())
    excess = (err - explained).clamp_min(0).max().item()
    return (err.max().item(), excess <= 2e-2 * rms,
            f"beyond one bf16 ulp of the context {excess / rms:.3e} x RMS <= 2e-2")


def check_head_shards(torch, fab, name, b, t, d, heads, p, dtype, gen, gated=False):
    """R0, K1 on each range of heads of tp = 2 and 4 ranks: the context bit
    for bit the whole kernel's columns for those heads (dropout, bias and
    gate included); each shard's fp32 partial out-projection against its twin
    (`partial_error`); the partials summed with the bias added once within
    the whole block's check against the twin. Times: rank 0's shard call (the
    fused-out partial) beside the whole block's."""
    from speechclip_plus_tpu_torch.ops.random import draw_seed

    x, w_in, b_in, w_out, b_out, bias = block_inputs(torch, b, t, d, dtype, gen)
    kw = {}
    if p:
        kw = dict(seeds=draw_seed(torch.Generator(device="cuda").manual_seed(11)),
                  keep_prob=1.0 - p)
    ab = gate = None
    if gated:
        ab = torch.randn(heads, t, t, generator=gen, device="cuda")
        gate = 1.0 + torch.rand(b, heads, t, generator=gen, device="cuda")
    whole_kw = dict(attn_bias=ab, attn_gate=gate, **kw)
    whole_ctx = fab._run(x, w_in, b_in, None, None, bias, heads, False, **whole_kw)
    whole_ms = median_ms(lambda: fab._run(x, w_in, b_in, w_out, b_out, bias, heads, True,
                                                 **whole_kw))
    want = fab.plain_fused_attention_block(*[a.float() for a in (x, w_in, b_in, w_out, b_out)],
                                           bias, heads, True, **whole_kw)
    rows, dh = {}, d // heads
    for tp in TP_SIZES:
        h = heads // tp
        parts, twin_err, timed = [], 0.0, None
        for r in range(tp):
            wi, bi, wo = shard_block(torch, x, w_in, b_in, w_out, r, tp)
            sl = dict(attn_bias=None if ab is None else ab[r * h:(r + 1) * h].contiguous(),
                      attn_gate=None if gate is None else gate[:, r * h:(r + 1) * h].contiguous(),
                      head_offset=r * h, total_heads=heads, **kw)
            ctx = fab._run(x, wi, bi, None, None, bias, h, False, **sl)
            require(torch.equal(ctx, whole_ctx[..., r * h * dh:(r + 1) * h * dh]),
                    f"R0 {name} tp={tp}: shard {r}'s context is not the whole kernel's heads")
            kern = lambda: fab._run(x, wi, bi, wo, b_out, bias, h, True, partial=True, **sl)
            part = kern()
            e, ok, tol = partial_error(torch, fab, part, x, wi, bi, wo, bias, h, dtype, sl)
            require(ok, f"R0 {name} tp={tp} shard {r}: partial vs its twin {e:.3e} ({tol})")
            twin_err = max(twin_err, e)
            parts.append(part)
            if r == 0:
                plain = lambda: fab.plain_fused_attention_block(
                    x, wi, bi, wo, None, bias, h, True, partial=True, **sl)
                lib = lambda: library_shard_block(torch, x, wi, bi, wo, bias, h, p,
                                                  sl["attn_bias"], sl["attn_gate"])
                moved = nbytes(x, wi, bi, wo, bias, sl["attn_bias"], sl["attn_gate"], part)
                dr = h * dh
                flops = 2 * b * t * d * 3 * dr + 4 * b * t * t * dr + 2 * b * t * dr * d
                timed = {"ms": median_ms(kern), "plain_ms": median_ms(plain),
                         **bound(flops, moved, dtype), "library_ms": median_ms(lib)}
        summed = (sum(parts) + b_out.float()).to(dtype)
        err, ok, tol = compare(torch, summed, want, dtype)
        require(ok, f"R0 {name} tp={tp}: the summed partials miss the whole block ({tol})")
        rows[tp] = {"shape": f"{name}, tp={tp} ({h} of {heads} heads), dropout {p}, "
                             f"{str(dtype)[6:]}", "max_abs_err": err,
                    "shard_twin_max_abs_err": twin_err, **timed, "whole_ms": whole_ms,
                    "library": "composite: cuBLAS linear + SDPA + cuBLAS linear to fp32, "
                               "on the shard"}
        print(f"[R0] K1 head shard {name} tp={tp} ({h} heads) p={p} {str(dtype)[6:]}: context "
              f"bit-identical to the whole kernel's heads on all {tp} shards; summed partials "
              f"max_abs_err={err:.3e} ({tol}); partial vs twin {twin_err:.3e}; rank 0's shard "
              f"{timing_text(rows[tp])}; the whole block {whole_ms:.4f} ms")
        del parts, summed
    del want, whole_ctx
    torch.cuda.empty_cache()
    return rows


def check_k5_shards(torch, b, t, p, dtype, gen):
    """R0, K5 on each range of heads: bit for bit the whole kernel's heads,
    and against its twin; times of rank 0's shard beside the whole call."""
    from speechclip_plus_tpu_torch.nn import fused_attention as fa
    from speechclip_plus_tpu_torch.ops.random import draw_seed

    heads, dh = 12, 64
    q, k, v, kb = packed_qkv(torch, b, heads, t, dh, dtype, gen)
    seeds = draw_seed(torch.Generator(device="cuda").manual_seed(17)) if p else None
    whole = fa._run(q, k, v, kb, seeds, 1.0 - p)
    whole_ms = median_ms(lambda: fa._run(q, k, v, kb, seeds, 1.0 - p))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = kb[:, None, None, :].to(dtype)
    rows = {}
    for tp in TP_SIZES:
        h = heads // tp
        for r in range(tp):
            sl = slice(r * h, (r + 1) * h)
            got = fa._run(q[:, sl], k[:, sl], v[:, sl], kb, seeds, 1.0 - p, r * h, heads)
            require(torch.equal(got, whole[:, sl]),
                    f"R0 K5 tp={tp}: shard {r} is not the whole kernel's heads")
        qs, ks, vs = q[:, :h], k[:, :h], v[:, :h]
        kern = lambda: fa._run(qs, ks, vs, kb, seeds, 1.0 - p, 0, heads)
        plain = lambda: fa.plain_fused_attention_dropout(qs, ks, vs, kb, seeds, 1.0 - p, 0, heads)
        got = kern()
        err, ok, tol = compare(torch, got, fa.plain_fused_attention_dropout(
            qs.float(), ks.float(), vs.float(), kb, seeds, 1.0 - p, 0, heads), dtype)
        require(ok, f"R0 K5 tp={tp}: shard vs twin ({tol})")
        rows[tp] = {"shape": f"K5 B={b} H={h} of {heads} (tp={tp}) T={t} dh={dh}, dropout {p}, "
                             f"{str(dtype)[6:]}", "max_abs_err": err,
                    "ms": median_ms(kern), "plain_ms": median_ms(plain),
                    **bound(4 * b * h * t * t * dh, nbytes(qs, ks, vs, kb, got), dtype),
                    "library_ms": median_ms(lambda: sdpa(qs, ks, vs, attn_mask=mask,
                                                                dropout_p=p)),
                    "library": "scaled_dot_product_attention on the shard's heads",
                    "whole_ms": whole_ms}
        print(f"[R0] K5 head shard B={b} T={t} tp={tp} ({h} heads) p={p}: bit-identical to the "
              f"whole kernel's heads on all {tp} shards; vs twin {err:.3e} ({tol}); rank 0's "
              f"shard {timing_text(rows[tp])}; the whole call {whole_ms:.4f} ms")
    return rows


def vq_inputs(torch, vocab, n, d, dtype, gen):
    v = len(vocab)
    x = torch.randn(n, d, generator=gen, device="cuda")
    x = (x / x.norm(dim=-1, keepdim=True)).to(dtype).contiguous()
    emb = torch.randn(v, d, generator=gen, device="cuda") * 0.1
    norms = emb.norm(dim=-1).clamp_min(1e-8).contiguous()
    en = (emb / norms[:, None]).to(dtype).contiguous()
    return x, en, norms


def check_vq_shards(torch, fk, vocab, n, dtype, gen, d=512):
    """R0, K3 on tp vocabulary shards merged as a model group merges them
    (`vq_rows` on each shard, `vq_combine` of the rows in column order,
    `vq_cols` from the global m and z): k bit for bit the whole kernel's,
    ent and psum to rtol 1e-3 of it. Times: one rank's part (its rows, the
    merge, its columns) beside the whole kernel."""
    v = len(vocab)
    x, en, _ = vq_inputs(torch, vocab, n, d, dtype, gen)
    mask = fk.column_mask(v, (0, vocab.sot_reduced, vocab.eot_reduced), "cuda")
    k1, e1, p1 = fk.cosine_vq_stats(x, en, mask)
    whole_ms = median_ms(lambda: fk.cosine_vq_stats(x, en, mask))
    rows = {}
    for tp in TP_SIZES:
        v_r = v // tp
        cut = lambda a, r: a[r * v_r:(r + 1) * v_r].contiguous()
        shards = [(cut(en, r), cut(mask, r)) for r in range(tp)]
        parts = [fk.vq_rows(x, e_r, m_r, r * v_r) for r, (e_r, m_r) in enumerate(shards)]
        stats = torch.stack([s for s, _ in parts], dim=1)
        best = torch.stack([bi for _, bi in parts], dim=0)
        k, ent, m, z = fk.vq_combine(stats, best)
        psum = torch.cat([fk.vq_cols(x, e_r, m_r, m, z) for e_r, m_r in shards])
        require(torch.equal(k, k1), f"R0 K3 N={n} tp={tp}: k differs from the whole kernel's")
        require(torch.allclose(ent, e1, rtol=1e-3, atol=0), f"R0 K3 N={n} tp={tp}: ent")
        require(torch.allclose(psum, p1, rtol=1e-3, atol=0), f"R0 K3 N={n} tp={tp}: psum")
        err = max((ent - e1).abs().max().item(), (psum - p1).abs().max().item())
        (e0, m0) = shards[0]
        kern = lambda: (fk.vq_rows(x, e0, m0, 0), fk.vq_combine(stats, best),
                        fk.vq_cols(x, e0, m0, m, z))
        plain = lambda: (fk.plain_vq_rows(x, e0, m0, 0), fk.plain_vq_combine(stats, best),
                         fk.plain_vq_cols(x, e0, m0, m, z))
        rows[tp] = {"shape": f"N={n} D={d} V={v_r} of {v} (tp={tp}) {str(dtype)[6:]}",
                    "max_abs_err": err, "max_abs_err_of": "ent, psum (vs the whole kernel)",
                    "ms": median_ms(kern), "plain_ms": median_ms(plain),
                    **bound(2 * n * d * v_r, nbytes(x, e0, m0, k, ent, psum[:v_r]), dtype),
                    "library_ms": None, "whole_ms": whole_ms}
        print(f"[R0] K3 vocabulary shards N={n} tp={tp} (V={v_r} each): k bit-identical to the "
              f"whole kernel's, ent/psum max_abs_err={err:.3e} (rtol 1e-3); one rank's part "
              f"{timing_text(rows[tp])}; the whole kernel {whole_ms:.4f} ms")
    return rows


def check_vq_bwd_shards(torch, fk, vocab, n, dtype, gen, d=512):
    """R0, K3b on tp vocabulary shards: the statistics of every shard
    gathered in column order, the shards' dx and dt summed, within K3b's
    tolerances of its twin (dx 1e-2 x RMS in bf16, dt 1e-4 x the sum of its
    terms' sizes). Times: one rank's halves beside the whole kernel."""
    v = len(vocab)
    x, en, norms = vq_inputs(torch, vocab, n, d, dtype, gen)
    g = (torch.randn(n, d, generator=gen, device="cuda") * 1e-3).to(dtype).contiguous()
    mask = fk.column_mask(v, (0, vocab.sot_reduced, vocab.eot_reduced), "cuda")
    temp = torch.full((), 0.1, device="cuda")
    whole_ms = median_ms(lambda: fk.st_backward(x, g, en, norms, mask, temp))
    dx0, dt0 = fk.plain_st_backward(x, g, en, norms, mask, temp)
    s = x.float() @ en.float().T
    pr = torch.softmax(torch.where(mask.bool()[None], -torch.inf, s / 0.1), dim=-1)
    u = (g.float() @ en.float().T) * norms
    dt_scale = (pr * (u - (pr * u).sum(-1, keepdim=True)) * s).abs().sum().item() / 0.01
    del s, pr, u
    rms = dx0.pow(2).mean().sqrt().item()
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    rows = {}
    for tp in TP_SIZES:
        v_r = v // tp
        cut = lambda a, r: a[r * v_r:(r + 1) * v_r].contiguous()
        shards = [(cut(en, r), cut(norms, r), cut(mask, r)) for r in range(tp)]
        stats = torch.cat([fk.st_backward_stats(x, g, *sh, temp) for sh in shards], dim=1)
        halves = [fk.st_backward_apply(x, g, *sh, temp, stats) for sh in shards]
        dx, dt = sum(hv[0] for hv in halves), sum(hv[1] for hv in halves)
        err, dt_err = (dx - dx0).abs().max().item(), abs(dt.item() - dt0.item())
        require(err <= tol * rms, f"R0 K3b N={n} tp={tp}: dx error {err:.3e} > {tol} x RMS")
        require(dt_err <= 1e-4 * dt_scale, f"R0 K3b N={n} tp={tp}: dt error {dt_err:.3e}")
        sh0 = shards[0]
        kern = lambda: fk.st_backward_apply(x, g, *sh0, temp, torch.cat(
            [fk.st_backward_stats(x, g, *sh0, temp)] + [stats[:, stats.shape[1] // tp:]], dim=1))
        plain = lambda: fk.plain_st_backward_apply(x, g, *sh0, temp, torch.cat(
            [fk.plain_st_backward_stats(x, g, *sh0, temp)] * tp, dim=1))
        rows[tp] = {"shape": f"N={n} D={d} V={v_r} of {v} (tp={tp}) {str(dtype)[6:]}",
                    "max_abs_err": err, "max_abs_err_of": "dx summed over the shards",
                    "dt_abs_err": dt_err, "ms": median_ms(kern),
                    "plain_ms": median_ms(plain),
                    **bound(6 * n * d * v_r, nbytes(x, g, *sh0, halves[0][0], halves[0][1]),
                            dtype),
                    "library_ms": None, "whole_ms": whole_ms}
        print(f"[R0] K3b vocabulary shards N={n} tp={tp}: summed dx max_abs_err={err:.3e} "
              f"(<= {tol:g} x RMS {rms:.3e}), dt err {dt_err:.3e} (<= 1e-4 x {dt_scale:.3e}); "
              f"one rank's halves {timing_text(rows[tp])}; the whole kernel {whole_ms:.4f} ms")
        del halves, stats
    del dx0
    torch.cuda.empty_cache()
    return rows


def time_row_parallel(torch, gen, m=128 * 320, d=768):
    """One rank's row-parallel partial product at the tower's shapes
    (HuBERT base fc2 and out_proj over B=128 x T=320 rows, tp 2 and 4):
    `tp.partial_product` (bf16 operands, fp32 out) against the product of
    the operands upcast to fp32 that it replaced, both beside the whole
    bf16 F.linear; their largest difference over the RMS within 1e-4 (fp32
    sums of the same exact products in another order)."""
    from speechclip_plus_tpu_torch.parallel.tp import partial_product

    F, bf = torch.nn.functional, torch.bfloat16
    for name, k in (("fc2", 4 * d), ("out_proj", d)):
        x = torch.randn(m, k, device="cuda", generator=gen).to(bf)
        w = (torch.randn(d, k, device="cuda", generator=gen) * k ** -0.5).to(bf)
        whole = median_ms(lambda: F.linear(x, w))
        for tp in TP_SIZES:
            xs, ws = x[:, :k // tp].contiguous(), w[:, :k // tp].contiguous()
            new, old = partial_product(xs, ws), F.linear(xs.float(), ws.float())
            err = float((new - old).abs().max() / old.pow(2).mean().sqrt())
            print(f"[R0] row-parallel {name} partial, M={m} N={d} K={k // tp} (tp={tp}): bf16 "
                  f"operands to fp32 {median_ms(lambda: partial_product(xs, ws)):.4f} ms, "
                  f"the operands upcast to fp32 "
                  f"{median_ms(lambda: F.linear(xs.float(), ws.float())):.4f} ms (the "
                  f"whole K={k} in bf16 {whole:.4f} ms); difference {err:.3e} x RMS")
            require(new.dtype == torch.float32 and err <= 1e-4,
                    f"R0: the {name} partial product differs by {err:.3e} x RMS")


def phase_kernels_tp(torch):
    """R0, in phase 2: the shard entry points at the paths' shapes (the
    HuBERT base and large towers' blocks, WavLM's gate mode, K5 at the
    tower's shape, K3 and K3b at N = 9600 and 1024 on V = 8112), tp = 2 and
    4, each held against the unsharded kernel and against its twin. Returns
    the kernel rows of the shard entries and the K5 shard modes."""
    from speechclip_plus_tpu_torch.data.tokenizer import ReducedVocab
    from speechclip_plus_tpu_torch.nn import fused_attention_block as fab
    from speechclip_plus_tpu_torch.ops import fused_keyword as fk

    t0 = time.perf_counter()
    vocab = ReducedVocab.from_npy(VOCAB_FILES[0])
    gen = torch.Generator(device="cuda").manual_seed(5)
    bf = torch.bfloat16
    k1 = check_head_shards(torch, fab, "HuBERT B=128 T=320 D=768 H=12", 128, 320, 768, 12,
                           0.1, bf, gen)
    k1_modes = list(check_head_shards(torch, fab, "HuBERT B=128 T=320 D=768 H=12", 128, 320,
                                      768, 12, 0.0, bf, gen).values())
    k1_modes += list(check_head_shards(torch, fab, "HuBERT B=128 T=319 D=768 H=12", 128, 319,
                                       768, 12, 0.1, bf, gen).values())
    k1_modes += list(check_head_shards(torch, fab, "WavLM gated bias B=128 T=320 D=768 H=12",
                                       128, 320, 768, 12, 0.1, bf, gen, gated=True).values())
    k1_modes += list(check_head_shards(torch, fab, "HuBERT-Large B=128 T=320 D=1024 H=16",
                                       128, 320, 1024, 16, 0.1, bf, gen).values())
    k1_modes += list(check_head_shards(torch, fab, "HuBERT B=8 T=37 D=768 H=12 fp32", 8, 37,
                                       768, 12, 0.1, torch.float32, gen).values())
    k5_modes = []
    for p in (0.1, 0.0):
        k5_modes += list(check_k5_shards(torch, 128, 320, p, bf, gen).values())
    k3 = {n: check_vq_shards(torch, fk, vocab, n, bf, gen) for n in (9600, 1024)}
    k3b = {n: check_vq_bwd_shards(torch, fk, vocab, n, bf, gen) for n in (9600, 1024)}
    time_row_parallel(torch, gen)
    print(f"[time] R0 shard checks: {time.perf_counter() - t0:.1f} s")
    csrc, jax_pkg = "speechclip_plus_tpu_torch/csrc/", "speechclip_plus_tpu/"
    rows = [
        {"name": "fused_attention_block_shard", "route": "cuda",
         "source": csrc + "fused_attention_block_attn.cu",
         "replaces": jax_pkg + "nn/fused_attention_block.py:118", **k1[2],
         "modes": [k1[4]] + k1_modes},
        {"name": "fused_cosine_vq_shard", "route": "cuda", "source": csrc + "fused_keyword.cu",
         "replaces": jax_pkg + "ops/fused_keyword.py:92", **k3[9600][2],
         "modes": [k3[9600][4], k3[1024][2], k3[1024][4]]},
        {"name": "fused_cosine_vq_bwd_shard", "route": "cuda",
         "source": csrc + "fused_keyword.cu", "replaces": jax_pkg + "ops/fused_keyword.py:123",
         **k3b[9600][2], "modes": [k3b[9600][4], k3b[1024][2], k3b[1024][4]]},
    ]
    return rows, {"fused_attention_dropout": [{"shape": "head shard: " + m["shape"], **m}
                                              for m in k5_modes]}


def tp_plan(plan, tower_layers=12):
    """A launch plan under tensor parallelism: the tower's K1 blocks run on a
    range of heads (also counted as K1 launches), one a layer for each speech
    forward (one K3 each), and K3 / K3b run as their shard halves."""
    plan = dict(plan)
    forwards = plan.pop("fused_cosine_vq", 0)
    plan["fused_cosine_vq_shard"] = forwards
    plan["fused_cosine_vq_bwd_shard"] = plan.pop("fused_cosine_vq_bwd", 0)
    plan["fused_attention_block_shard"] = tower_layers * forwards
    return {k: v for k, v in plan.items() if v}


def phase_tp(torch):
    """Path R1, tensor parallelism through the training entry point: two
    ranks of one model group (`trainer.tensor_parallel: 2`) sharing the one
    card under gloo, each `run_task` of hybrid+ base at full width (bf16,
    B=128 crops of TP_AUDIO samples, cached images) on a synthetic tree of
    one step an epoch, three legs side by side (`start_leg`): a pair of rank
    processes for a fit of TP_FIRST steps (its steps and collectives timed,
    `timed_steps`) and one resumed from its checkpoint to TP_TOTAL, a pair
    for an unbroken fit of TP_TOTAL, and one process without a group. Held:
    the resumed leg equals the unbroken one bit for bit (logged losses, model
    state_dict and Adam state, whole tensors); the checkpoint loads at tp=1
    into exactly its tensors; step 1's loss and grad_norm against the one
    process within TP_LOSS_RTOL and TP_GRAD_NORM_RTOL, and each trainable
    tensor's Adam moment at the end within TP_MOMENT_RTOL (`tp_against_one`);
    each rank's launches against the plan. Prints the share of step 1's keyword ids that agree,
    the timed steps' split between the collectives and the rest, and the
    ms/step of two processes time-slicing one card (no measure of
    tensor-parallel speed). R2 (two cards under NCCL) where the machine shows
    two GPUs. Returns the launch counts by leg and rank."""
    import shutil

    from speechclip_plus_tpu_torch.checkpoint import CheckpointManager
    from speechclip_plus_tpu_torch.config import load_config
    from speechclip_plus_tpu_torch.tasks.builder import build_model_from_config

    t_start = time.perf_counter()
    free_cuda(torch)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    try:
        tree = synthetic_tree("path R", TP_TREE)
        saves = {n: os.path.join(tmp, n) for n in ("alone", "tp2", "first", "resumed")}

        def run(name, max_steps, tp, argv=(), profile=False):
            # validation and a save at the fit's end alone
            return fit_run_spec(tmp, name, {
                "trainer.max_steps": max_steps, "trainer.log_every_n_steps": 1,
                "trainer.check_val_every_n_epoch": 1000, "trainer.tensor_parallel": tp,
                "audio_encoder.max_audio_len": TP_AUDIO}, argv, profile)

        def start(label, world, runs, group="gloo"):
            return start_leg({"label": f"R1 {label}", "tree": tree, "world": world,
                              "group": group if world > 1 else None, "runs": runs, "ids": True})

        def finish(leg):
            out = finish_leg(leg)
            for name, ranks in out.items():
                tm = ranks[0]["timings"]
                parts = {k: sum(tm[k]) for k in ("image_cache_s", "train_s", "validate_s",
                                                  "save_s")}
                print(f"[path R] {leg[0]['label']}, {name}: rank 0's run_task "
                      f"{ranks[0]['run_s']:.1f} s (the process's start and group "
                      f"{ranks[0]['start_s']:.1f} s before its first fit), of it "
                      + ", ".join(f"{k[:-2]} {v:.1f} s" for k, v in parts.items()))
            return out

        # three legs side by side (the pairs of ranks spend much of their time in
        # gloo's host copies): one process; a pair of ranks for the first fit
        # and the one resumed from it; a pair for the unbroken fit
        started = [start("one process", 1, [run("alone", TP_TOTAL, 1)]),
                   start("tp=2, first and resumed", 2, [
                       run("first", TP_FIRST, 2, profile=True),
                       run("resumed", TP_TOTAL, 2, ["--resume", os.path.join(
                           saves["first"], "checkpoints", "last")])]),
                   start("tp=2, unbroken", 2, [run("tp2", TP_TOTAL, 2)])]
        done = [finish(leg) for leg in started]
        alone, (first, resumed), tp2 = (done[0]["alone"], (done[1]["first"], done[1]["resumed"]),
                                        done[2]["tp2"])
        require(alone[0]["tp"] == 1 and all(r["tp"] == 2 for r in tp2 + first + resumed),
                "R1: model-group sizes")
        require([r["steps"] for r in tp2 + first + resumed]
                == [TP_TOTAL] * 2 + [TP_FIRST] * 2 + [TP_TOTAL] * 2, "R1: steps taken")

        # launches: phase J's units, the tower's blocks and K3 / K3b as shards
        base = load_config(FIT_CONFIG)
        dev_batches = -(-TP_TREE["dev"] * TP_TREE["caps"] // int(base.data.dev_batch_size))
        cache_batches = -(-TP_TREE["train"] // 64) + -(-TP_TREE["dev"] // 64)
        step_plan, eval_plan, cache_plan = fit_plans()
        by_path = {}
        for name, res, steps in (("alone", alone, TP_TOTAL), ("tp2", tp2, TP_TOTAL),
                                 ("first", first, TP_FIRST),
                                 ("resumed", resumed, TP_TOTAL - TP_FIRST)):
            for r, rank in enumerate(res):
                shard = (lambda p: p) if name == "alone" else tp_plan
                expect = {}
                add_counts(expect, shard(step_plan), steps)
                add_counts(expect, shard(eval_plan),
                           len(rank["timings"]["validate_s"]) * dev_batches)
                add_counts(expect, cache_plan, cache_batches)
                label = f"R1_{name}" + (f"_rank{r}" if name != "alone" else "")
                by_path[label] = compare_counts(f"R1 {name} rank {r} ({steps} steps)",
                                                rank["counts"], expect)
        print("[path R] R1 launches per training step on each rank (K1 / of them on a head "
              "range / K1a / K2 / K3 shard / K3b shard): " + " / ".join(
                  str(tp_plan(step_plan).get(k, 0)) for k in (
                      "fused_attention_block", "fused_attention_block_shard", "projection_gemm",
                      "fused_attention_block_bwd", "fused_cosine_vq_shard",
                      "fused_cosine_vq_bwd_shard")))

        # the resumed leg against the unbroken one, bit for bit
        rows = {name: leg_rows(save) for name, save in saves.items()}
        unbroken = {r["micro_step"]: r for r in rows["tp2"] if "train_loss" in r}
        again = {r["micro_step"]: r for r in rows["resumed"] if "train_loss" in r}
        require(again and set(again) <= set(unbroken), "R1: the resumed leg's logged steps")
        differ = [f"{k}@{s}" for s, r in again.items() for k, v in r.items()
                  if (k.startswith("train_") or k == "grad_norm") and unbroken[s][k] != v]
        worst, names = state_difference(torch, saved_state(torch, saves["resumed"], TP_TOTAL),
                                        saved_state(torch, saves["tp2"], TP_TOTAL))
        print(f"[path R] R1 resumed tp=2 leg at step {TP_TOTAL} against the unbroken tp=2 leg: "
              + ("bit-identical (logged train metrics, model state_dict and Adam state, whole "
                 "tensors)" if not (differ or names) else
                 f"{len(differ)} metrics and {len(names)} tensors differ, max |diff| {worst:.3e}: "
                 f"{(differ + names)[:8]}"))
        require(not differ and not names, "R1: the resumed tp=2 leg differs from the unbroken one")

        # the tp=2 checkpoint at tp=1: exactly its tensors
        free_cuda(torch)
        model, _, _ = build_model_from_config(base, device="cuda", seed=0)
        ck = os.path.join(saves["tp2"], "checkpoints")
        CheckpointManager(ck).restore(model)
        saved = saved_state(torch, saves["tp2"], TP_TOTAL)[0]
        loaded = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        require(loaded.keys() == saved.keys(), "R1: the checkpoint's tensors at tp=1")
        unequal = [k for k in saved if not torch.equal(loaded[k], saved[k])]
        print(f"[path R] R1 the tp=2 checkpoint loaded at tp=1: {len(saved)} tensors, "
              + ("all equal to the gathered tensors" if not unequal else f"{unequal[:6]} differ"))
        require(not unequal, "R1: the checkpoint loads at tp=1 into other tensors")
        del model
        free_cuda(torch)

        # step 1, and Adam's first moment at the end, against the one process
        from speechclip_plus_tpu_torch.optim.optimizer import trainable_parameters

        names = [n for n, _ in trainable_parameters(build_model_from_config(
            base, device="meta", seed=0)[0])]

        def against_one(label, save):
            rels, worst, held, _ = tp_against_one(torch, save, saves["alone"], names=names)
            limits = {"train_loss": TP_LOSS_RTOL, "grad_norm": TP_GRAD_NORM_RTOL,
                      "moment": TP_MOMENT_RTOL}
            print(f"[path R] {label} against one process: step 1 " + ", ".join(
                f"{k} {rels[k]:.3e} relative (limit {limits[k]:g})" for k in rels)
                  + f"; the moment's worst of {held} tensors {worst}")
            for key, limit in limits.items():
                require(rels[key] <= limit, f"{label}: {key} differs by {rels[key]:.3e}")

        against_one("R1 tp=2", saves["tp2"])
        ka, kb = np.array(tp2[0]["targets"]), np.array(alone[0]["targets"])
        require(ka.shape == kb.shape and tp2[0]["targets"] == tp2[1]["targets"],
                "R1: step 1's keyword ids")
        print(f"[path R] R1 step 1 keyword ids: {float((ka == kb).mean()):.6f} of {ka.size} "
              f"agree between tp=2 and one process (both ranks of the group hold the same ids)")
        print(card_line())
        for r, rank in enumerate(first):
            prof = rank["profile"]  # (seconds, collective seconds, collectives) a step
            require(len(prof) == TP_FIRST, f"R1: {len(prof)} timed steps")
            print(f"[path R] R1 first fit, rank {r}, each step from a synchronized card to a "
                  f"synchronized card, every collective the same way: " + "; ".join(
                      f"step {s + 1} {1e3 * sec:.2f} ms, of it {1e3 * coll:.2f} ms in {n} "
                      f"collectives (gloo) and {1e3 * (sec - coll):.2f} ms the rest"
                      for s, (sec, coll, n) in enumerate(prof)))
        for name, res in (("alone", alone), ("tp2", tp2)):
            median, whole = loop_ms(rows[name], res[0]["timings"])
            print(f"[path R] R1 loop ms/step, B={int(base.data.batch_size)}, "
                  + ("one process, no group" if name == "alone" else
                     "two ranks time-slicing one card, gloo collectives through the host (no "
                     "measure of tensor-parallel speed)")
                  + f", beside the other legs: median window {median:.2f}, whole {whole:.2f}")

        gpus = torch.cuda.device_count()
        if gpus < 2:
            print(f"[path R] R2 (two ranks under NCCL on two cards) did not run: this machine "
                  f"shows {gpus} GPU; not a pass")
        else:
            saves["r2"] = os.path.join(tmp, "r2")
            finish_leg(start_leg({"label": "R2", "tree": tree, "world": 2, "group": "nccl",
                                  "runs": [run("r2", TP_TOTAL, 2)]}))
            against_one("R2 two cards under NCCL", saves["r2"])
        print(f"[time] path R: {time.perf_counter() - t_start:.1f} s")
        return by_path
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------ path K ----

class OrderedNamespace:
    """Stands in for the reference's config class in the Lightning checkpoint
    path K writes: pickled under this name, which the port's importer
    unpickles through its shim."""

    def __init__(self, d):
        for key, value in d.items():
            setattr(self, key, OrderedNamespace(value) if isinstance(value, dict) else value)


def reference_state_dict(torch, state):
    """A hybrid+ port `state_dict` under the reference's names, fp32 on the
    host: fairseq HuBERT under `audio_encoder.encoder.` (q, k and v split out
    of the packed projection, the pos_conv weight as weight_norm's `weight_g`
    and `weight_v`), OpenAI CLIP under `clip.model.` (packed qkv, the reduced
    token table as it is), and avssl's branch names."""
    import re

    out = {}
    for name, t in state.items():
        t = t.detach().float().cpu()
        root, _, rest = name.partition(".")
        if name == "weightedsum":
            out["audio_encoder.weightedsum_layer.weights"] = t
        elif name == "criterion_log_inv_temp":
            out["criterion.temperature"] = t
        elif root == "audio_encoder":
            p = "audio_encoder.encoder."
            qkv = re.fullmatch(r"layers\.(\d+)\.self_attn\.in_proj_(weight|bias)", rest)
            if qkv:
                for n, part in zip("qkv", t.chunk(3)):
                    out[f"{p}encoder.layers.{qkv[1]}.self_attn.{n}_proj.{qkv[2]}"] = part.clone()
            elif rest == "pos_conv.conv.weight":
                out[f"{p}encoder.pos_conv.0.weight_g"] = t.norm(dim=(0, 1), keepdim=True)
                out[f"{p}encoder.pos_conv.0.weight_v"] = t
            else:
                for pattern, repl in (
                        (r"feature_extractor\.conv_layers\.(\d+)\.", r"feature_extractor.conv_layers.\1.0."),
                        (r"feature_extractor\.gn\.", "feature_extractor.conv_layers.0.2."),
                        (r"pos_conv\.conv\.", "encoder.pos_conv.0."),
                        (r"encoder_layer_norm\.", "encoder.layer_norm."),
                        (r"layers\.", "encoder.layers.")):
                    rest, n = re.subn("^" + pattern, repl, rest)
                    if n:
                        break
                out[p + rest] = t
        elif root == "clip":
            rest = re.sub(r"transformer\.blocks\.(\d+)\.(c_fc|c_proj)", r"transformer.resblocks.\1.mlp.\2",
                          rest).replace("transformer.blocks.", "transformer.resblocks.")
            out["clip.model." + rest.removeprefix("text.")] = t
        elif root == "cascaded_branch":
            for pattern, repl in (("downsampling.conv.", "downsampling.conv.0."),
                                  ("downsampling.weight_proj.", "downsampling.weight_proj.1."),
                                  ("head.linear_proj.", "linear_proj."),
                                  ("head.bn_layer.", "bn_layer.bn_layer.")):
                if rest.startswith(pattern):
                    rest = repl + rest[len(pattern):]
            out[f"{root}.{rest}"] = t
        else:
            raise SmokeFailure(f"reference writer: no reference name for {name}")
    out["cascaded_branch.bn_layer.bn_layer.num_batches_tracked"] = torch.tensor(1)
    return out


# path K times each checkpoint load as the median of this many (5 before path
# R joined the smoke; each load is a seeded build and a full read, 4-5 s)
CHECKPOINT_LOADS = 3


def seconds_median(torch, fn, n=5):
    """(median seconds over n calls, last result), each call timed with
    `utils.profiling.StepTimer`, which synchronizes the card."""
    from speechclip_plus_tpu_torch.utils import StepTimer

    times, out = [], None
    for _ in range(n):
        timer = StepTimer(1)
        timer.tick()
        out = fn()
        timer.tick(sync_on=torch.zeros(1, device="cuda"))
        times.append(1.0 / timer.steps_per_sec)
    return float(np.median(times)), out


def phase_inference(torch, ck, tree, tmp, final_state, wavs8, reference):
    """Path K: the inference and evaluation entry points on the directory that
    phase J's first leg saved (`ck`, hybrid+ base bf16): `load_from_checkpoint`
    of `last` and of the best `val_recall_mean_10` step, `encode_speech`,
    `feature_extractor_s3prl`, `extract_keywords`, `search_text` over a
    256-image index; then a full-width Lightning `.ckpt` written from the same
    model under the reference's names, loaded back, and `run_task --test
    --ckpt` on phase J's tree. Returns the launch counts."""
    from speechclip_plus_tpu_torch.api import load_from_checkpoint
    from speechclip_plus_tpu_torch.checkpoint import CheckpointManager
    from speechclip_plus_tpu_torch.data.tokenizer import SimpleTokenizer
    from speechclip_plus_tpu_torch.run_task import main as run_task
    from speechclip_plus_tpu_torch.serving import SpeechRetriever, build_image_index
    from speechclip_plus_tpu_torch.tasks import base_task

    full = speech_query_plan("k1", True)  # encode_speech / extract_keywords: 13 K1, 1 K3
    tower_branch = k1_plan(12, 1)  # feature_extractor_s3prl: the tower and the branch
    label = "path K inference"
    reset_counts()
    expect, shape_sets, hooks = {}, [], []

    def differing(model, want, skip=()):
        got = model.state_dict()
        require(got.keys() == want.keys(), f"{label}: state_dict keys differ")
        return [n for n in got if n not in skip and not torch.equal(got[n].cpu(), want[n].cpu())]

    def record(model):  # the shapes at which `model` calls K1 context-only and K3
        shapes, h = record_shapes(torch, model)
        shape_sets.append(shapes)
        hooks.extend(h)

    load_s, sc = seconds_median(torch, lambda: load_from_checkpoint(ck), n=CHECKPOINT_LOADS)
    bad = differing(sc.model, final_state)
    require(not bad, f"{label}: load_from_checkpoint(last) differs from the trainer: {bad[:5]}")
    record(sc.model)
    out = sc.encode_speech(wavs8)
    add_counts(expect, full)
    for key, want in reference.items():
        require(torch.equal(out[key].cpu(), want), f"{label}: encode_speech {key} differs from "
                "the trainer's model")
    best = CheckpointManager(ck).best_step("val_recall_mean_10")
    saved = torch.load(os.path.join(ck, "val_recall_mean_10", str(best), "state.pt"),
                       map_location="cpu", weights_only=True)["model"]
    monitor_s, by_monitor = seconds_median(
        torch, lambda: load_from_checkpoint(ck, monitor="val_recall_mean_10"), n=1)
    bad = differing(by_monitor.model, saved)
    require(not bad, f"{label}: the monitor's step {best} differs from its file: {bad[:5]}")
    del by_monitor, saved
    free_cuda(torch)
    print(f"[K] load_from_checkpoint({ck}): last (step of fit_state.json) in {load_s:.2f} s "
          f"(median of {CHECKPOINT_LOADS}), val_recall_mean_10's best step {best} in "
          f"{monitor_s:.2f} s: both the saved state_dict bit for bit; encode_speech B=8 "
          "equals the trainer's model bit for bit")

    # where the directory route's time goes, step by step as load_from_checkpoint
    # takes it: the seeded build on the host, reading the file, filling the
    # model, moving it to the card (the first three median of 3, the move once)
    from speechclip_plus_tpu_torch.config import ConfigNode
    from speechclip_plus_tpu_torch.tasks.builder import build_model_from_config

    node = ConfigNode(CheckpointManager.load_config(ck))
    state_pt = os.path.join(ck, "last", str(CheckpointManager(ck).latest_step()), "state.pt")
    build_s, (host_model, _, _) = seconds_median(
        torch, lambda: build_model_from_config(node, device="cpu"), n=3)
    read_s, payload = seconds_median(
        torch, lambda: torch.load(state_pt, map_location="cpu", weights_only=True), n=3)
    fill_s, _ = seconds_median(torch, lambda: host_model.load_state_dict(payload["model"]), n=3)
    move_s, _ = seconds_median(torch, lambda: host_model.to("cuda"), n=1)
    del host_model, payload
    free_cuda(torch)
    print(f"[K] load_from_checkpoint(last), its steps: build with the seeded init on the host "
          f"{build_s:.3f} s, torch.load {read_s:.3f} s, load_state_dict {fill_s:.3f} s (median "
          f"of 3 each), to the card {move_s:.3f} s (once); sum "
          f"{build_s + read_s + fill_s + move_s:.3f} s against {load_s:.3f} s for the whole call")

    # feature_extractor_s3prl: the (L+1)-deep stack is built only here
    def fe8():
        return sc.feature_extractor_s3prl(wavs8)
    fe_ms = median_ms(fe8, runs=5, warmup=1)
    add_counts(expect, tower_branch, 6)
    peak = {}
    for b, wavs in ((8, wavs8), (64, ragged_wavs(np.random.RandomState(12), 64, False))):
        free_cuda(torch)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        last, hidden = sc.feature_extractor_s3prl(wavs)
        torch.cuda.synchronize()
        peak[b] = ((torch.cuda.max_memory_allocated() - base) / 2 ** 20,
                   torch.cuda.max_memory_allocated() / 2 ** 30)
        add_counts(expect, tower_branch)
        require(len(hidden) == 14 and tuple(last.shape) == (b, 319, 768)
                and all(tuple(h.shape) == (b, 319, 768) for h in hidden)
                and bool(torch.isfinite(last.float()).all()),
                f"{label}: feature_extractor_s3prl B={b}: {len(hidden)} states, {tuple(last.shape)}")
        del last, hidden
    free_cuda(torch)

    def kw8():
        return sc.extract_keywords(wavs8)
    kw_ms = median_ms(kw8, runs=5, warmup=1)
    add_counts(expect, full, 6)
    kw = kw8()
    add_counts(expect, full)
    original = kw["vq_results"]["targets_original"]
    slots = kw["dsample_results"]["dsample_feats_length"].cpu().numpy()
    require(original.shape[0] == 8 and np.isin(original, sc.vocab.selected_ids).all()
            and original.max() < 49408 and (slots >= 1).all(),
            f"{label}: extract_keywords targets_original {original.shape}")
    print(f"[K] feature_extractor_s3prl B=8: {fe_ms:.2f} ms (median of 5, CUDA events), 14 "
          f"states of (B, 319, 768) (13 tower + the branch's); peak above the resident model "
          f"B=8 {peak[8][0]:.1f} MiB ({peak[8][1]:.2f} GiB allocated), B=64 {peak[64][0]:.1f} "
          f"MiB ({peak[64][1]:.2f} GiB); extract_keywords B=8: {kw_ms:.2f} ms, targets_original "
          f"{original.shape} in the full CLIP vocabulary, {slots.tolist()} slots")

    # search_text with the dev merges, against a plain ranking
    sc.tokenizer = SimpleTokenizer("config/dev/merges.txt")
    gen = torch.Generator(device="cuda").manual_seed(5)
    images = torch.randn(256, 224, 224, 3, generator=gen, device="cuda")
    index = build_image_index(sc, images, np.arange(256) + 5000, batch_size=256)
    add_counts(expect, k1_plan(12))
    del images
    retriever = SpeechRetriever(sc, index)
    words = ["the", "cat", "runs", "at", "a", "dog", "in"]
    rng = np.random.RandomState(13)
    text_ms = {}
    for b in (1, 8, 64):
        texts = [" ".join(rng.choice(words, size=rng.randint(2, 9))) for _ in range(b)]
        ids, scores = retriever.search_text(texts, k=10)
        with torch.inference_mode():
            tok = retriever._text_processor.prep_text(texts, context_length=77)
            feat = sc.model.clip.encode_text(torch.from_numpy(np.asarray(tok, np.int64)).cuda())
            plain = (feat.float() / feat.float().norm(dim=-1, keepdim=True).clamp_min(1e-8)
                     ) @ index.feats.T
            want_scores, want_idx = torch.sort(plain, dim=-1, descending=True)
        require((ids == index.ids[want_idx[:, :10].cpu().numpy()]).all()
                and np.array_equal(scores, want_scores[:, :10].cpu().numpy()),
                f"{label}: search_text B={b} differs from the plain ranking")
        check_search(ids, scores, b, 10, index.ids, f"{label} search_text B={b}")
        text_ms[b] = median_ms(lambda: retriever.search_text(texts, k=10), runs=5,
                               warmup=1)
    print(f"[K] search_text over 256 images (config/dev/merges.txt): ids and scores equal to "
          f"encode_text -> L2 -> product -> sort; " + ", ".join(
              f"B={b} {ms:.2f} ms" for b, ms in text_ms.items()) + " (median of 5)")
    for h in hooks:
        h.remove()
    hooks = []
    del sc, index, retriever
    free_cuda(torch)

    # a Lightning .ckpt at full width, from the same model under reference names
    path = os.path.join(tmp, "hybrid_plus_base.ckpt")
    config = CheckpointManager.load_config(ck)
    t0 = time.perf_counter()
    torch.save({"state_dict": reference_state_dict(torch, final_state),
                "hyper_parameters": {"config": OrderedNamespace(config)},
                "epoch": FIT_EPOCHS, "global_step": 0}, path)
    write_s = time.perf_counter() - t0
    ckpt_s, from_ckpt = seconds_median(torch, lambda: load_from_checkpoint(path),
                                       n=CHECKPOINT_LOADS)
    pos = "audio_encoder.pos_conv.conv.weight"
    bad = differing(from_ckpt.model, final_state, skip=(pos,))
    a, b = from_ckpt.model.state_dict()[pos].float().cpu(), final_state[pos].float().cpu()
    pos_rel = ((a - b).abs().max() / b.abs().max()).item()
    require(not bad, f"{label}: tensors of the .ckpt differ: {bad[:5]}")
    require(pos_rel <= 1e-6, f"{label}: pos_conv after the weight-norm round trip: {pos_rel}")
    require(from_ckpt.tokenizer is None and from_ckpt.vocab is not None,
            f"{label}: the .ckpt's config (bpe_path null, the reduced vocabulary)")
    del from_ckpt
    free_cuda(torch)
    print(f"[K] Lightning .ckpt ({os.path.getsize(path) / 2 ** 20:.0f} MiB, written in "
          f"{write_s:.1f} s): load_from_checkpoint in {ckpt_s:.2f} s (median of "
          f"{CHECKPOINT_LOADS}); every "
          f"tensor equal to the trainer's bit for bit but pos_conv, within {pos_rel:.1e} "
          f"relative (the weight-norm round trip)")

    # run_task --test --ckpt on phase J's tree; its model's shapes recorded too
    build_model = base_task.build_model_from_config

    def recording_build(*args, **kwargs):
        built = build_model(*args, **kwargs)
        record(built[0])
        return built

    base_task.build_model_from_config = recording_build
    try:
        t0 = time.perf_counter()
        trainer = run_task(["TrainKWClip_GeneralTransformer", "--test", "--device", "cuda",
                            "--ckpt", path, "--dataset_root", tree,
                            "--save_path", os.path.join(tmp, "test_from_ckpt"), "--njobs", "0",
                            "--log_level", "WARNING"])
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t0
    finally:
        base_task.build_model_from_config = build_model
    for h in hooks:
        h.remove()
    test_caps = FIT_TREE["test"] * FIT_TREE["caps"]
    add_counts(expect, k1_plan(12), -(-FIT_TREE["test"] // 64))  # the test split's images
    add_counts(expect, full, -(-test_caps // int(trainer.cfg.data.dev_batch_size)))
    del trainer
    free_cuda(torch)
    print(f"[K] run_task --test --ckpt {os.path.basename(path)} on the synthetic test split "
          f"({test_caps} captions): {test_s:.1f} s")
    counts = read_counts(torch, label, expect)
    check_path_shapes(torch, label, set().union(*shape_sets))
    return counts


def profile_cell(torch, label, fn, n=3):
    """Device time by kernel over n calls of fn (torch.profiler), and the
    device's busy share of the profiled wall time: the union of the kernels'
    intervals on the device's clock, so that kernels that overlap (two
    streams) or are reported twice count once. Annotation ranges, which the
    profiler also lists as device events that span their kernels, are left
    out of every sum."""
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
    on_device = lambda e: (e.device_type == DeviceType.CUDA
                           and not getattr(e, "is_user_annotation", False))
    dev = lambda e: getattr(e, "self_device_time_total", 0) or getattr(
        e, "self_cuda_time_total", 0)
    # kernels only: CPU-side ops also report the device time of what they launched
    events = [e for e in prof.key_averages() if on_device(e) and dev(e) > 0]
    total = sum(dev(e) for e in events)
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if on_device(e) and e.time_range.end > e.time_range.start)
    busy_us, end, hidden = 0.0, float("-inf"), {}
    for lo, hi, name in spans:
        busy_us += max(0.0, hi - max(lo, end))
        if lo < end:  # runs while an earlier kernel still does
            hidden[name] = hidden.get(name, 0.0) + min(hi, end) - lo
        end = max(end, hi)
    annotated = sum(dev(e) for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and not on_device(e))
    print(f"[profile] {label}: wall {wall_us / n / 1e3:.2f} ms/call, device busy "
          f"{busy_us / n / 1e3:.2f} ms/call = {100 * busy_us / wall_us:.1f}% of the wall; sum "
          f"over kernels {total / n / 1e3:.2f} ms/call ({100 * total / max(busy_us, 1e-9):.1f}% of "
          f"busy: above 100, kernels overlap), annotation ranges left out "
          f"{annotated / n / 1e3:.2f} ms/call (n={n})")
    for name, us in sorted(hidden.items(), key=lambda kv: -kv[1])[:4]:
        print(f"[profile]   overlaps an earlier kernel for {us / n / 1e3:8.3f} ms: {name[:90]}")
    # the 16 largest, every kernel of csrc/ (names "(anonymous namespace)::...",
    # after "void " where the kernel is a template) and cuFFT's (the mel frontend)
    for i, e in enumerate(sorted(events, key=dev, reverse=True)):
        if i < 16 or e.key.startswith(("void (anonymous namespace)::", "(anonymous namespace)::")) \
                or "fft" in e.key.lower():
            print(f"[profile]   {dev(e) / n / 1e3:8.3f} ms {e.count // n:5d}x  {e.key[:90]}")


def phase_profile(torch):
    """Device time by kernel: three serving cells of hybrid+ base, one of the
    WavLM model, one of the cascaded family and one of hybrid+ large, and one
    training cell (B=128 x 102400 samples, cached image features) for each of
    the HuBERT tower through K1, the WavLM tower, the HuBERT tower through
    K5, the cascaded and parallel families, hybrid+ large (its YAML's
    accumulation of 2: every other step updates) and Mockingjay hybrid+
    (path O1)."""
    from speechclip_plus_tpu_torch.api import SpeechCLIP
    from speechclip_plus_tpu_torch.optim.optimizer import build_optimizer_from_config
    from speechclip_plus_tpu_torch.parallel.train_step import (
        create_train_state, make_train_step)
    from speechclip_plus_tpu_torch.serving import SpeechRetriever, build_image_index

    gen = torch.Generator(device="cuda").manual_seed(1)
    images = torch.randn(1000, 224, 224, 3, generator=gen, device="cuda")
    rng = np.random.RandomState(0)
    k5 = dict(fused_attention=True, fused_attention_block=False)
    for label, config, keys, cells in (
            ("HuBERT (K1 route)", CONFIG, {}, (("parallel", 8), ("cascaded", 8), ("cascaded", 64))),
            ("WavLM", WAVLM_CONFIG, {}, (("parallel", 8),)),
            ("HuBERT (K5 route)", CONFIG, k5, ()),
            ("path E cascaded", FAMILY_CONFIGS["E cascaded"], {}, (("cascaded", 8),)),
            ("path F parallel", FAMILY_CONFIGS["F parallel"], {}, ()),
            ("path M1 hybrid+ large", LARGE_CONFIGS["M1 hybrid+ large"], {},
             (("cascaded", 8),)),
            ("path O1 mockingjay hybrid+", MEL_CONFIGS["O1 mockingjay hybrid+"], {}, ())):
        cfg, model, model_cfg = build(torch, config, **keys)
        sc = SpeechCLIP(model, "cuda")
        index = build_image_index(sc, images, np.arange(1000), batch_size=256)
        for src, b in cells:
            r = SpeechRetriever(sc, index, feat_src=src)
            wavs = [(0.1 * rng.randn(102400)).astype(np.float32) for _ in range(b)]
            for _ in range(2):
                r.search(wavs, k=10)
            profile_cell(torch, f"{label} {src} B={b} x 6.4 s query",
                         lambda: r.search(wavs, k=10))
        del sc, index
        optimizer = build_optimizer_from_config(model, cfg)
        state = create_train_state(optimizer)
        step_fn = make_train_step(model, optimizer,
                                  int(cfg.trainer.accumulate_grad_batches or 1))
        batch = train_batch(torch, TRAIN_BATCH, TRAIN_WAV, model_cfg.clip.image_resolution,
                            seed=0)
        with torch.no_grad():
            batch["image_feat"] = model.encode_image_raw(batch.pop("image"))
        for _ in range(WARMUP_STEPS):
            step_fn(state, batch, gen)
        profile_cell(torch, f"{label} train step B={TRAIN_BATCH} x {TRAIN_WAV} cached images",
                     lambda: step_fn(state, batch, gen))
        del model, optimizer, state, step_fn, batch
        torch.cuda.empty_cache()


def phase_families(torch):
    """Paths E-I and L with their parity phases; returns the launch counts by
    path."""
    by_path, ms = {}, {}
    for label, config in {**FAMILY_CONFIGS, "L data2vec hybrid+": DATA2VEC_CONFIG}.items():
        counts, cell_ms = phase_family(torch, label, config)
        ms[label] = cell_ms["cached"]
        by_path[f"{label[0]}_serve"], by_path[f"{label[0]}_train"] = (
            counts["serve"], counts["train"])
    phase_parity(torch, "path L data2vec hybrid+", DATA2VEC_CONFIG)
    phase_train_parity(torch, "path L data2vec hybrid+", DATA2VEC_CONFIG)
    cascaded = FAMILY_CONFIGS["E cascaded"]
    phase_parity(torch, "path E cascaded", cascaded)
    phase_train_parity(torch, "path E cascaded", cascaded, batch_size=4,
                       zero=("head.linear_proj.bias", "attentionBlock_Norm.bias"))
    counts, ms_text = phase_text_route(torch)
    by_path.update(counts)
    knob = {"text_fused_attention_vjp": True}
    phase_parity(torch, "path I hybrid+ text route", CONFIG, knob)
    phase_train_parity(torch, "path I hybrid+ text route", CONFIG, knob)
    print("[train] cached images, ms/step in this run: " + ", ".join(
        f"path {label} {v:.2f}" for label, v in ms.items())
        + "; path I " + ", ".join(f"{n} {v:.2f}" for n, v in ms_text.items()))
    return by_path


def add_modes(rows, *extras):
    """Each row gains the extra modes that phase 2 measured under its name."""
    for r in rows:
        for extra in extras:
            r["modes"] = r.get("modes", []) + extra.get(r["name"], [])


def print_kernels_line(rows, by_path):
    """The kernels JSON line: each row with the checks made at the paths' own
    shapes as modes, and its launches in the paths' runs, each counted from 0
    (phase 2's comparison launches are not in them)."""
    for r in rows:
        r["modes"] = r.get("modes", []) + [m for name, m in PATH_ROWS if name == r["name"]]
    print(json.dumps({"kernels": [
        {**r, "launches": sum(c[r["name"]] for c in by_path.values()),
         "launches_by_path": {p: c[r["name"]] for p, c in by_path.items() if c[r["name"]]}}
        for r in rows]}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", choices=("all", "kernels", "families", "profile", "fit", "large",
                                        "large_fixed", "mel", "variants", "dp", "tp"),
                    default="all")
    # one leg of path Q or R in a process of its own (the script starts these itself)
    ap.add_argument("--leg", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dp-q2", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.leg or args.dp_q2:
        os.chdir(os.path.dirname(os.path.abspath(__file__)))
        try:
            leg_main(json.loads(args.leg)) if args.leg else dp_q2(json.loads(args.dp_q2))
        except SmokeFailure as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        return 0
    return smoke(args, torch)


def smoke(args, torch) -> int:
    major, minor = torch.cuda.get_device_capability(0)
    if major != 9:
        print(f"chip_smoke: compute capability {major}.{minor}, need 9.x", file=sys.stderr)
        return 2
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    started = time.perf_counter()
    try:
        from speechclip_plus_tpu_torch.utils import cuda_build

        print(card_line())
        print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
              f"{torch.cuda.get_device_name(0)}")
        cuda_build.kernels()
        print(f"[build] nvcc sm_90a build {cuda_build.build_seconds():.1f} s")
        if args.phase == "profile":
            phase_profile(torch)
            return 0
        if args.phase == "families":
            phase_families(torch)
            return 0
        if args.phase == "fit":
            _, ms = phase_train(torch, "HuBERT (K1 route)", CONFIG, cells=("cached",))
            phase_fit(torch, ms["cached"])  # J, then K
            return 0
        if args.phase in ("large", "large_fixed"):
            rows, extra, by_path = [], {}, {}
            if args.phase == "large":
                rows, extra = phase_kernels_large(torch)
            fixed_rows, fixed_extra = phase_kernels_large_fixed(torch)
            rows += fixed_rows
            add_modes(rows, extra, fixed_extra)
            if args.phase == "large":
                by_path = phase_large(torch)
            by_path.update(phase_large_fixed(torch))
            print(f"[time] chip_smoke --phase {args.phase}: {time.perf_counter() - started:.1f} s")
            print_kernels_line(rows, by_path)
            return 0
        rows = phase_kernels(torch)
        if args.phase in ("all", "kernels", "tp"):
            tp_rows, tp_modes = phase_kernels_tp(torch)  # R0, the shard entry points
            rows += tp_rows
            add_modes(rows, tp_modes)
        if args.phase == "tp":
            by_path = phase_tp(torch)
            print(f"[time] chip_smoke --phase tp: {time.perf_counter() - started:.1f} s")
            print_kernels_line(rows, by_path)
            return 0
        if args.phase == "variants":
            by_path = phase_variants(torch)
            print(f"[time] chip_smoke --phase variants: {time.perf_counter() - started:.1f} s")
            print_kernels_line(rows, by_path)
            return 0
        if args.phase == "dp":
            by_path = phase_dp(torch)
            print(f"[time] chip_smoke --phase dp: {time.perf_counter() - started:.1f} s")
            print_kernels_line(rows, by_path)
            return 0
        if args.phase == "mel":
            add_modes(rows, phase_kernels_mel(torch))
            by_path = phase_mel(torch)
            print(f"[time] chip_smoke --phase mel: {time.perf_counter() - started:.1f} s")
            print_kernels_line(rows, by_path)
            return 0
        large_rows, extra = phase_kernels_large(torch)
        fixed_rows, fixed_extra = phase_kernels_large_fixed(torch)
        rows += large_rows + fixed_rows
        add_modes(rows, extra, fixed_extra, phase_kernels_mel(torch))
        if args.phase == "all":
            by_path, ms = {}, {}
            lap = [started]

            def timed(label):  # each path's seconds, for the smoke's budget
                now = time.perf_counter()
                print(f"[time] {label}: {now - lap[0]:.1f} s")
                lap[0] = now

            timed("the build, phase 2 and the kernel checks at the large, mel and shard shapes")
            hubert, wavlm = "HuBERT (K1 route)", "path A WavLM"
            by_path["serve"] = phase_model(torch, hubert, CONFIG)
            by_path["train"], ms["hubert"] = phase_train(torch, hubert, CONFIG)
            phase_parity(torch, hubert, CONFIG)
            phase_train_parity(torch, hubert, CONFIG)
            timed("phases 3-7")
            by_path["fit"], by_path["K"] = phase_fit(torch, ms["hubert"]["cached"])
            timed("phase J and path K")
            by_path["A_serve"] = phase_model(torch, wavlm, WAVLM_CONFIG, wires=(False,),
                                             n_img=256, stream=False)
            by_path["A_train"], ms["wavlm"] = phase_train(torch, wavlm, WAVLM_CONFIG,
                                                          cells=("cached",))
            phase_parity(torch, wavlm, WAVLM_CONFIG)
            phase_train_parity(torch, wavlm, WAVLM_CONFIG)
            k5 = dict(tower="k5", fused_attention=True, fused_attention_block=False)
            by_path["B_train"], ms["k5"] = phase_train(torch, "path B HuBERT (K5 route)", CONFIG,
                                                       cells=("cached",), **k5)
            by_path["B_serve"] = phase_model(torch, "path B HuBERT (K5 route)", CONFIG,
                                             batches=(8,), wires=(False,), n_img=256,
                                             stream=False, **k5)
            print(f"[train] cached images, ms/step in this run: HuBERT through K1 "
                  f"{ms['hubert']['cached']:.2f}, HuBERT through K5 {ms['k5']['cached']:.2f}, "
                  f"WavLM through K1's gate mode {ms['wavlm']['cached']:.2f}")
            by_path["C_tower"] = phase_tower_flash(torch)
            by_path["D_conv0"] = phase_conv0(torch)
            timed("paths A-D")
            by_path.update(phase_families(torch))
            timed("paths E-I and L")
            by_path.update(phase_large(torch))
            timed("path M")
            by_path.update(phase_large_fixed(torch))
            timed("path N")
            by_path.update(phase_mel(torch))
            timed("path O")
            by_path.update(phase_variants(torch))
            timed("path P")
            by_path.update(phase_dp(torch))
            timed("path Q")
            by_path.update(phase_tp(torch))  # prints its own seconds
            print(f"[time] chip_smoke: {time.perf_counter() - started:.1f} s")
            print_kernels_line(rows, by_path)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        remove_trees()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
