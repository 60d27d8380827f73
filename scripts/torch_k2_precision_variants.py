"""What K2's per-tile precision costs and buys on the card (PyTorch/CUDA port).

The attention backward (`speechclip_plus_tpu_torch/csrc/attention_bwd.cuh`)
multiplies a tile in one TF32 pass and takes the error-compensated passes only
where a weight of the tile exceeds `PRECISE_ABOVE`, or everywhere past
`PRECISE_BEYOND_T` keys. This script times the
kernel as it is and with that decision edited, each variant built from an
edited copy of the sources in a temporary directory (the checkout is not
touched), in bf16 at the hybrid+ branch's shapes (B=128, H=8, dh=96, T=320 and
321, dropout 0.1 and 0) or at the shapes `--shape B,T,D,H` names (repeatable),
against the twin as `chip_smoke.py` does:

    tile          the kernel as it is
    tile_only     the choice per tile at every T (no PRECISE_BEYOND_T)
    novote        one pass everywhere, the decision and the other path removed
    never         the decision kept, the threshold never met
    always        the threshold always met (one wasted pass of q k^T a tile)
    precise_only  the compensated passes everywhere, no first pass
    above=X       the kernel with the threshold at X (for example above=0.125)

Run from the root of the checkout, on a machine with an H100 and nvcc:

    python3 scripts/torch_k2_precision_variants.py [--shape B,T,D,H ...] [variant ...]

A variant whose error passes the tolerance of `chip_smoke.compare` prints its
row; one that misses it prints FAILED with the error.
"""
import math
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = ("tile", "tile_only", "novote", "never", "always", "precise_only")
DECIDE = "bool precise = P3 || ALL_PRECISE;"
LONG = "p.T > PRECISE_BEYOND_T"
VOTE = "if (precise || !__any_sync(0xffffffffu, z_max > LOG_PRECISE_ABOVE)) break;"


def edited(src: str, name: str) -> str:
    start = src.index("constexpr float LOG_PRECISE_ABOVE = ")
    line = src[start:src.index("\n", start)]
    threshold = lambda log: src.replace(line, f"constexpr float LOG_PRECISE_ABOVE = {log};")
    if name == "tile":
        return src
    if name == "novote":
        return src.replace(VOTE, "break;")
    if name == "never":
        return threshold("1e30f")
    if name == "always":
        return threshold("-1e37f")
    if name == "tile_only":
        return src.replace(LONG, "false")
    if name == "precise_only":
        return src.replace(DECIDE, "bool precise = true;")
    if name.startswith("above="):
        return threshold(f"{math.log(float(name[6:])):.7f}f")
    raise SystemExit(f"unknown variant {name!r}; one of {VARIANTS} or above=X")


def run_variant(name: str, shapes) -> None:
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import torch
    from speechclip_plus_tpu_torch.utils import cuda_build

    tmp = tempfile.mkdtemp()
    try:
        csrc = os.path.join(tmp, "csrc")
        shutil.copytree(cuda_build._CSRC, csrc)
        path = os.path.join(csrc, "attention_bwd.cuh")
        with open(path) as f:
            src = f.read()
        assert VOTE in src and DECIDE in src and LONG in src, "attention_bwd.cuh has changed"
        with open(path, "w") as f:
            f.write(edited(src, name))
        cuda_build._CSRC, cuda_build._BUILD_DIR = csrc, os.path.join(tmp, "build")
        import chip_smoke
        from speechclip_plus_tpu_torch.nn import fused_attention_block as fab
        from speechclip_plus_tpu_torch.nn import fused_attention_block_vjp as vjp

        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        gen = torch.Generator(device="cuda").manual_seed(17)
        for shape in shapes:
            for p in (0.1, 0.0):
                try:
                    chip_smoke.check_attention_bwd(torch, fab, vjp, torch.bfloat16, p, gen, shape,
                                                   what=name)
                except chip_smoke.SmokeFailure as e:
                    print(f"[kernel] K2 {name} {shape} p={p}: FAILED: {e}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    args, shapes = sys.argv[1:], []
    while "--shape" in args:
        i = args.index("--shape")
        shapes.append(tuple(int(v) for v in args[i + 1].split(",")))
        del args[i:i + 2]
    shapes = shapes or [(128, 320, 768, 8), (128, 321, 768, 8)]
    if len(args) == 2 and args[0] == "--one":
        run_variant(args[1], shapes)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    rc, flags = 0, [f for s in shapes for f in ("--shape", ",".join(map(str, s)))]
    for name in args or VARIANTS:  # one process a variant: a process loads one build
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--one", name,
                              *flags]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
