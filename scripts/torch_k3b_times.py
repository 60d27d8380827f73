"""K3b's or K3's time on the card, for this checkout or another (PyTorch/CUDA port).

`--kernel k3b` (the default) times the straight-through VQ backward
(`ops/fused_keyword.py::st_backward`) and its plain twin at the shapes the
training paths run it at (V=8112, D=512; N=9600 for the plus families, 1024
for the fixed-K ones) in bf16 and fp32, with the inputs `chip_smoke.py`'s
`check_vq_bwd` makes. `--kernel k3` times the cosine-VQ forward
(`cosine_vq_stats`) and its twin at every N the paths record (bf16: 9600,
4800, 1024, 600, 512, 75, 64, 8; fp32: 9600 and 1024), with the inputs of
`check_vq`. Both kernels are in `csrc/fused_keyword.cu`. Times are CUDA
events (median of 20 after 3 warm-ups); one JSON line per (dtype, N) with
the kernel's error against the twin and the plan it ran. `--root` imports
the port from another checkout (an unpacked parent commit, say), so that
two versions are compared in one call, each in its own process:

    python3 scripts/torch_k3b_times.py --root .parent --label parent
    python3 scripts/torch_k3b_times.py --label change
    python3 scripts/torch_k3b_times.py --kernel k3 --profile

K3b takes the temperature t = 0.1 as a float, or with `--device-temp` as a
0-d fp32 tensor on the card (the training path's form since the kernel reads
it from device memory). `--dump DIR` writes each K3b row's dx and dt to
`DIR/<label>_<dtype>_<N>.pt`, and `--same-as LABEL` then requires them to
equal, bit for bit, the files LABEL dumped there (the fixed-temperature
results of two builds).

Needs a CUDA card and nvcc; prints nothing and exits 1 without a card.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np


def kernel_ms(torch, fn, calls=5):
    """{kernel name: device ms per call} over `calls` calls of fn."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if e.device_type == DeviceType.CUDA and us > 0:
            out[e.key[:80]] = us / calls / 1e3
    return out


def k3b_rows(torch, fk, gen, median_ms, temp=0.1, out=None):
    """`out`: a dict that receives each row's (dx, dt) by (dtype, N)."""
    d, v = 512, 8112
    for dtype in (torch.bfloat16, torch.float32):
        for n in (9600, 1024):
            x = torch.randn(n, d, generator=gen, device="cuda")
            x = (x / x.norm(dim=-1, keepdim=True)).to(dtype).contiguous()
            g = (torch.randn(n, d, generator=gen, device="cuda") * 1e-3).to(dtype).contiguous()
            emb = torch.randn(v, d, generator=gen, device="cuda") * 0.1
            norms = emb.norm(dim=-1).clamp_min(1e-8).contiguous()
            en = (emb / norms[:, None]).to(dtype).contiguous()
            mask = fk.column_mask(v, (0, 2, 3), "cuda")
            kern = lambda: fk.st_backward(x, g, en, norms, mask, temp)
            plain = lambda: fk.plain_st_backward(x, g, en, norms, mask, temp)
            (dx, dt), (dx0, dt0) = kern(), plain()
            torch.cuda.synchronize()
            if out is not None:
                out[(str(dtype)[6:], n)] = (dx.cpu(), dt.cpu())
            plan = getattr(fk, "_bwd_plan", None)
            yield kern, {"dtype": str(dtype)[6:], "n": n, "d": d, "v": v,
                         "ms": median_ms(kern), "plain_ms": median_ms(plain),
                         "dx_err_over_rms": (dx - dx0).abs().max().item()
                         / dx0.pow(2).mean().sqrt().item(),
                         "dt_abs_err": abs(dt.item() - dt0.item()),
                         "plan": None if plan is None
                         else plan(n, v, d, dtype, fk._sm_count(x.device))}
            del x, g, emb, en, dx, dx0


def k3_rows(torch, fk, gen, median_ms):
    d, v = 512, 8112
    cells = [(torch.bfloat16, n) for n in (9600, 4800, 1024, 600, 512, 75, 64, 8)]
    for dtype, n in cells + [(torch.float32, 9600), (torch.float32, 1024)]:
        x = torch.randn(n, d, generator=gen, device="cuda")
        x = (x / x.norm(dim=-1, keepdim=True)).to(dtype).contiguous()
        emb = torch.randn(v, d, generator=gen, device="cuda") * 0.1
        en = (emb / emb.norm(dim=-1, keepdim=True)).to(dtype).contiguous()
        mask = fk.column_mask(v, (0, 2, 3), "cuda")
        kern = lambda: fk.cosine_vq_stats(x, en, mask)
        plain = lambda: fk.plain_cosine_vq_stats(x, en, mask)
        (k1, e1, p1), (k0, e0, p0) = kern(), plain()
        s = (x.float() @ en.float().T).masked_fill(mask.bool()[None], -1e30)
        top2 = s.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > (1e-3 if dtype == torch.bfloat16 else 1e-5)
        plan = getattr(fk, "_fwd_plan", None)
        yield kern, {"dtype": str(dtype)[6:], "n": n, "d": d, "v": v,
                     "ms": median_ms(kern), "plain_ms": median_ms(plain),
                     "target_mismatches_decided": int((k1 != k0)[decided].sum()),
                     "ent_rel_err": ((e1 - e0).abs() / e0.abs()).max().item(),
                     "psum_rel_err": ((p1 - p0).abs() / p0.abs().clamp_min(1e-30)).max().item(),
                     "plan": None if plan is None
                     else plan(n, v, d, dtype, fk._sm_count(x.device))}
        del x, emb, en, s


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--kernel", choices=("k3b", "k3"), default="k3b")
    ap.add_argument("--profile", action="store_true",
                    help="also print the device time of each kernel of a call (torch.profiler)")
    ap.add_argument("--device-temp", action="store_true",
                    help="K3b: pass the temperature as a 0-d tensor on the card")
    ap.add_argument("--dump", help="K3b: write each row's dx and dt under this directory")
    ap.add_argument("--same-as", help="K3b: require the dump of this label to equal this one")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from speechclip_plus_tpu_torch.ops import fused_keyword as fk

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]

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

    gen = torch.Generator(device="cuda").manual_seed(0)
    outputs = {}
    if args.kernel == "k3":
        rows = k3_rows(torch, fk, gen, median_ms)
    else:
        temp = torch.full((), 0.1, device="cuda") if args.device_temp else 0.1
        rows = k3b_rows(torch, fk, gen, median_ms, temp, outputs)
    for kern, row in rows:
        row = {"label": args.label, "card": card, "kernel": args.kernel,
               "temperature": "device tensor" if args.device_temp else "float", **row}
        if args.profile:
            row["kernels_ms"] = kernel_ms(torch, kern)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    differ = []
    for (dtype, n), (dx, dt) in outputs.items():
        if args.dump:
            os.makedirs(args.dump, exist_ok=True)
            torch.save({"dx": dx, "dt": dt},
                       os.path.join(args.dump, f"{args.label}_{dtype}_{n}.pt"))
        if args.same_as:
            ref = torch.load(os.path.join(args.dump, f"{args.same_as}_{dtype}_{n}.pt"))
            same = torch.equal(ref["dx"], dx) and torch.equal(ref["dt"], dt)
            print(json.dumps({"label": args.label, "same_as": args.same_as, "dtype": dtype,
                              "n": n, "bit_identical": same,
                              "dx_max_abs_diff": (ref["dx"] - dx).abs().max().item(),
                              "dt_abs_diff": abs(ref["dt"].item() - dt.item())}), flush=True)
            differ += [] if same else [(dtype, n)]
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
