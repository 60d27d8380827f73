"""Where K3's bf16 time goes, by pass and by part, on the card (PyTorch/CUDA port).

Builds variants of `speechclip_plus_tpu_torch/csrc/fused_keyword.cu` with
parts of the tensor-core passes (`vq_fwd_tc_kernel`) switched off, and times
each pass of each at the training N (9600) and the fixed-K N (1024), V=8112,
D=512, by `torch.profiler` (device ms per kernel, 5 calls) and CUDA events
(median of 20 wrapper calls):

    full           the kernel as it is in the tree
    no_epilogue    no tile epilogue (the accumulators are kept alive)
    no_products    no `ldmatrix` / `mma.sync` (the epilogue reads zeros)
    no_loads       no codebook stage loads (the products read stale shared memory)
    loads_only     neither products nor epilogue
    products_only  neither loads nor epilogue
    rows64         the whole kernel with 64-row blocks (8 warps) at D=512

Only `full` computes the function; the others are timings of parts (their
outputs are not checked). The variants are patched copies of the source,
compiled by nvcc into `build/k3_ablation/` (git-ignored), one process per
source, in parallel. Needs a CUDA card and nvcc; prints nothing and exits 1
without a card:

    python3 scripts/torch_k3_ablation.py
"""
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "speechclip_plus_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "k3_ablation")

# (text in the source, replacement): each must occur exactly once
PATCHES = [
    ("    if (g < total) {\n      const int c0 = cbeg + g / chunks * FC",
     "    if (g < total && !ABL_NOLOAD) {\n      const int c0 = cbeg + g / chunks * FC"),
    ("      if (ks >= ksteps) break;\n      uint32_t a[2][4], b[2][4];",
     "      if (ks >= ksteps || ABL_NOMMA) break;\n      uint32_t a[2][4], b[2][4];"),
    # no epilogue: the accumulators are summed into `keep`, which a store that
    # never happens reads, so that the products stay
    ("  float acc[2][4][4];\n", "  float acc[2][4][4], keep = 0.f;\n"),
    ("    if (kc != chunks - 1) continue;\n",
     "    if (kc != chunks - 1) continue;\n"
     "    if (ABL_NOEPI) {\n"
     "#pragma unroll\n"
     "      for (int i = 0; i < 32; ++i) keep += (&acc[0][0][0])[i];\n"
     "      continue;\n"
     "    }\n"),
    ("  cp_async_wait(0);\n  if (PSUM) return;\n",
     "  cp_async_wait(0);\n"
     "  if (ABL_NOEPI && keep == 1.2345e-30f) (PSUM ? col_part : stats)[tid] = keep;\n"
     "  if (PSUM) return;\n"),
    ("  const int want_rows = !is_bf16 ? VR : D <= F_DMAX_128 ? 128 : 64;",
     "  const int want_rows = !is_bf16 ? VR : D <= F_DMAX_128 && !ABL_ROWS64 ? 128 : 64;"),
]
VARIANTS = {"full": [], "no_epilogue": ["ABL_NOEPI"], "no_products": ["ABL_NOMMA"],
            "no_loads": ["ABL_NOLOAD"], "loads_only": ["ABL_NOMMA", "ABL_NOEPI"],
            "products_only": ["ABL_NOLOAD", "ABL_NOEPI"], "rows64": ["ABL_ROWS64"]}
FLAGS = ["ABL_NOLOAD", "ABL_NOMMA", "ABL_NOEPI", "ABL_ROWS64"]


def build(nvcc):
    with open(os.path.join(CSRC, "fused_keyword.cu")) as f:
        src = f.read()
    for old, new in PATCHES:
        if src.count(old) != 1:
            raise SystemExit(f"the source no longer has the text to patch: {old[:60]!r}")
        src = src.replace(old, new)
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, "fused_keyword_ablation.cu")
    with open(path, "w") as f:
        f.write(src)

    def one(name):
        on = VARIANTS[name]
        defs = [f"-D{flag}={int(flag in on)}" for flag in FLAGS]
        so = os.path.join(OUT, f"{name}.so")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-w",
               "-Xcompiler", "-fPIC", "-shared", f"-I{CSRC}", *defs, "-o", so, path]
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{done.stderr}")
        return name, so

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        return dict(pool.map(one, VARIANTS))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from speechclip_plus_tpu_torch.ops import fused_keyword as fk
    from speechclip_plus_tpu_torch.utils import cuda_build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    libs = build(cuda_build._nvcc())
    p, i = ctypes.c_void_p, ctypes.c_int

    def median_ms(fn):
        for _ in range(3):
            fn()
        times = []
        for _ in range(20):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    def kernel_ms(fn, calls=5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
            if e.device_type == DeviceType.CUDA and us > 0:
                name = e.key.split("::")[-1].split("(")[0]  # kernel<rows, pass>
                out[name] = us / calls / 1e3
        return out

    gen = torch.Generator(device="cuda").manual_seed(0)
    d, v = 512, 8112
    real_rows = fk._fwd_rows
    for name, so in libs.items():
        lib = ctypes.CDLL(so)
        lib.sc_vq_fwd_rows.argtypes = [p, p, p, i, i, i, i, i, i, p, p, p, p, p, p, p, p, i, p]
        lib.sc_vq_fwd_cols.argtypes = [p, p, p, i, i, i, i, i, i, p, p, p, p, p]
        lib.sc_vq_fwd_rows.restype = lib.sc_vq_fwd_cols.restype = i
        cuda_build._lib = lib
        fk._fwd_rows = (lambda d_, dtype: 64) if name == "rows64" else real_rows
        fk._fwd_plan.cache_clear()
        for n in (9600, 1024):
            x = torch.randn(n, d, generator=gen, device="cuda")
            x = (x / x.norm(dim=-1, keepdim=True)).bfloat16().contiguous()
            emb = torch.randn(v, d, generator=gen, device="cuda") * 0.1
            en = (emb / emb.norm(dim=-1, keepdim=True)).bfloat16().contiguous()
            mask = fk.column_mask(v, (0, 2, 3), "cuda")
            call = lambda: fk.cosine_vq_stats(x, en, mask)
            row = {"card": card, "variant": name, "n": n, "d": d, "v": v,
                   "plan": fk._fwd_plan(n, v, d, torch.bfloat16, fk._sm_count(x.device)),
                   "ms": median_ms(call), "kernels_ms": kernel_ms(call)}
            if name in ("full", "rows64"):
                k, ent, psum = call()
                k0, ent0, psum0 = fk.plain_cosine_vq_stats(x, en, mask)
                row["targets_equal_share"] = (k == k0).float().mean().item()
                row["ent_rel_err"] = ((ent - ent0).abs() / ent0.abs()).max().item()
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
