"""Build and load the hand-written CUDA kernels.

The sources under ``csrc/`` are compiled at first use with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, placed in the
package's ``build/`` directory (not tracked by git), and loaded with ctypes.
Nothing here runs at import time: the CPU tests import every module on
machines with no ``nvcc``.

Flags that matter for agreement with the plain PyTorch version:
``--fmad=false`` (no fused multiply-add contraction: a contracted
``disc > 0`` or ``t < t_best`` flips a hit decision and the path after it is
a different path) and no ``--use_fast_math`` (IEEE division and square root,
the accurate ``sinf cosf logf expf``).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("render_kernel.cu",)
HEADERS = ("hashrng.cuh",)
LIB_NAME = "librt_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lib = None
build_seconds = None  # seconds the last build in this process took
build_log = ""        # what nvcc printed (register and spill counts)


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def build() -> str:
    """Compile csrc/*.cu into build/librt_kernels.so; returns its path.
    Rebuilds when a source is newer than the library."""
    global build_seconds, build_log
    srcs = [os.path.join(CSRC, s) for s in SOURCES]
    deps = srcs + [os.path.join(CSRC, h) for h in HEADERS]
    so = os.path.join(BUILD_DIR, LIB_NAME)
    if (os.path.exists(so)
            and os.path.getmtime(so) >= max(os.path.getmtime(d) for d in deps)):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-I", CSRC, "-o", tmp, *srcs]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{build_log}")
    os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    """The kernels' shared library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp = ctypes.c_void_p
        # 10 scene tables, params (host pointer), out_rgb, out_n, stream
        lib.rt_render_launch.argtypes = [vp] * 10 + [vp, vp, vp, vp]
        lib.rt_render_launch.restype = ctypes.c_int
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def error_string(err: int) -> str:
    return load().rt_error_string(err).decode()
