"""Build and load the port's hand-written CUDA kernels.

Each `csrc/*.cu` file is compiled by its own `nvcc -c` for `sm_90a`, all
started together, and the objects are linked into one shared library with a
plain C interface, loaded with `ctypes` at first use. The library is named
by a hash of the sources, the headers and the flags, so it is rebuilt only
when they change. The build directory is `build/kernels/` at the root of
the checkout (listed in `.gitignore`). Nothing here runs at import time:
machines without `nvcc` import this module and never call `kernels()`.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

__all__ = ["KernelBuildError", "kernels", "build_seconds", "check"]

_CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_CSRC)), "build", "kernels")
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# --split-compile=0: a source's kernels are optimised on as many threads as
# there are cores, not one after the other
_FLAGS = [*_ARCH, "-std=c++17", "-O3", "--split-compile=0", "-Xcompiler", "-fPIC",
          "-Xptxas", "-v"]

_lib = None
_build_seconds = 0.0


class KernelBuildError(RuntimeError):
    """nvcc failed or could not be found; the message carries its stderr."""


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _sources():
    srcs = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for path in sorted(srcs + glob.glob(os.path.join(_CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return srcs, h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    u = ctypes.c_uint
    lib.sc_fab_gemm.argtypes = [p, p, p, p, i, i, i, i, f, i, i, i, p]
    i64p = ctypes.POINTER(ctypes.c_int64)  # host array of element strides
    lib.sc_fab_attention.argtypes = [p, p, p, i, i, i, i, i, p, i, p, p, u, f, p, i, i, p]
    lib.sc_fused_attention.argtypes = [p, p, p, p, i64p, p, i, i, i, i, i, f, p, u, f, i, i, p]
    lib.sc_flash_attention.argtypes = [p, p, p, p, i64p, p, p, i, i, i, i, i, f, p]
    lib.sc_conv0.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    lib.sc_conv0_gn_gelu.argtypes = [p, p, p, p, f, p, p, p, i, i, i, i, i, i, p]
    lib.sc_fab_attention_bwd.argtypes = [p, p, p, i, p, p, p, p, p, u, f, f, p, i, i, i, i, i, p]
    lib.sc_vq_fwd_rows.argtypes = [p, p, p, i, i, i, i, i, i, p, p, p, p, p, p, p, p, i, p]
    lib.sc_vq_combine.argtypes = [p, p, i, i, p, p, p, p, p]
    lib.sc_vq_fwd_cols.argtypes = [p, p, p, i, i, i, i, i, i, p, p, p, p, p]
    lib.sc_vq_bwd.argtypes = [p, p, p, p, p, i, i, i, p, i, i, i, p, p, p, p, p, i, i, p]
    for fn in (lib.sc_fab_gemm, lib.sc_fab_attention, lib.sc_fab_attention_bwd,
               lib.sc_fused_attention, lib.sc_flash_attention, lib.sc_conv0,
               lib.sc_conv0_gn_gelu, lib.sc_vq_fwd_rows, lib.sc_vq_combine, lib.sc_vq_fwd_cols, lib.sc_vq_bwd):
        fn.restype = ctypes.c_int
    lib.sc_error_string.argtypes = [i]
    lib.sc_error_string.restype = ctypes.c_char_p


def kernels() -> ctypes.CDLL:
    """The loaded kernel library; builds it on the first call if needed."""
    global _lib, _build_seconds
    if _lib is not None:
        return _lib
    srcs, digest = _sources()
    os.makedirs(_BUILD_DIR, exist_ok=True)
    so = os.path.join(_BUILD_DIR, f"libspeechclip_kernels_{digest}.so")
    if not os.path.exists(so):
        t0 = time.perf_counter()
        nvcc = _nvcc()
        tmpdir = tempfile.mkdtemp(dir=_BUILD_DIR)
        procs = []
        try:
            objs = [os.path.join(tmpdir, os.path.basename(src) + ".o") for src in srcs]
            procs = [subprocess.Popen([nvcc, *_FLAGS, "-c", src, "-o", obj],
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True) for src, obj in zip(srcs, objs)]

            def finish(proc):  # one thread a compiler, so that each is timed on its own
                _, err = proc.communicate()
                return err, time.perf_counter() - t0

            with ThreadPoolExecutor(len(procs)) as pool:
                done = list(pool.map(finish, procs))
            logs = []
            for src, proc, (err, seconds) in zip(srcs, procs, done):
                logs.append(f"== {os.path.basename(src)} ({seconds:.1f} s)\n{err}")
                if proc.returncode != 0:
                    raise KernelBuildError(f"nvcc failed ({proc.returncode}) on {src}:\n{err}")
            tmp = os.path.join(tmpdir, "lib.so")
            link = subprocess.run([nvcc, *_ARCH, "-shared", "-o", tmp, *objs],
                                  capture_output=True, text=True)
            if link.returncode != 0:
                raise KernelBuildError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
            with open(so + ".log", "w") as f:  # -Xptxas -v: registers, smem, spills
                f.write("\n".join(logs))
            os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
            shutil.rmtree(tmpdir, ignore_errors=True)
        _build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(so)
    _declare(lib)
    _lib = lib
    return lib


def build_seconds() -> float:
    """Seconds the nvcc build took in this process (0 if it was cached)."""
    return _build_seconds


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a non-zero cudaError_t."""
    if err != 0:
        msg = kernels().sc_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
