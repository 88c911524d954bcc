"""Build and load the hand-written CUDA kernels.

The sources under ``csrc/`` are compiled at first use with ``nvcc`` for
``sm_90a``, one ``nvcc`` process per source, all started together, and linked
into one shared library with a plain C interface, placed in the package's
``build/`` directory (not tracked by git), and loaded with ctypes. Nothing
here runs at import time: the CPU tests import every module on machines with
no ``nvcc``.

Flags that matter for agreement with the plain PyTorch version:
``--fmad=false`` (no fused multiply-add contraction: a contracted
``disc > 0`` or ``t < t_best`` flips a hit decision and the path after it is
a different path) and no ``--use_fast_math`` (IEEE division and square root,
the accurate ``sinf cosf logf expf``).

``LAUNCHES`` counts the launches of each kernel, by kernel name: a wrapper
adds one where it launches its kernel and nowhere else.
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
SOURCES = ("render_kernel.cu", "gather_kernel.cu", "perlin_kernel.cu",
           "probe_kernel.cu")
HEADERS = ("hashrng.cuh",)
LIB_NAME = "librt_kernels.so"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xcompiler",
              "-fPIC")

LAUNCHES = {"render_kernel": 0, "record_kernel": 0, "hit_kernel": 0,
            "gather_kernel": 0, "gather_cols_kernel": 0,
            "scatter_sum_kernel": 0, "scatter_match_kernel": 0,
            "radix_sort_kernel": 0,
            "segment_sum_kernel": 0,
            "perlin_kernel": 0, "perlin_backward_kernel": 0,
            # the hardware probes (probes.py, csrc/probe_kernel.cu)
            "smem_scalar_kernel": 0, "row_broadcast_kernel": 0,
            "gather_probe_kernel": 0, "gather_2d_kernel": 0,
            "sphere_loop_kernel": 0, "sphere_immediate_kernel": 0,
            "sphere_mxu_kernel": 0, "sphere_mxu_tc_kernel": 0}

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
    Rebuilds when a source is newer than the library. Each source compiles
    in its own nvcc process, all at once; one more nvcc call links them."""
    global build_seconds, build_log
    srcs = [os.path.join(CSRC, s) for s in SOURCES]
    deps = srcs + [os.path.join(CSRC, h) for h in HEADERS]
    so = os.path.join(BUILD_DIR, LIB_NAME)
    if (os.path.exists(so)
            and os.path.getmtime(so) >= max(os.path.getmtime(d) for d in deps)):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o")
            for s in srcs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I", CSRC, "-c", "-o", o, s],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s, o in zip(srcs, objs)]
    logs, failed = [], []
    for s, pr in zip(SOURCES, procs):
        out, _ = pr.communicate()
        logs.append(f"== {s}\n{out}")
        if pr.returncode != 0:
            failed.append(f"{s} ({pr.returncode})")
    tmp = f"{so}.{tag}"
    try:
        if not failed:
            res = subprocess.run([nvcc, *ARCH, "-shared", "-o", tmp, *objs],
                                 capture_output=True, text=True)
            logs.append(f"== link\n{res.stdout}{res.stderr}")
            if res.returncode != 0:
                failed.append(f"link ({res.returncode})")
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{build_log}")
    os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    """The kernels' shared library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # 15 scene tables, img_f, params and plan (host pointers), out_rgb,
        # out_n, counters, stream
        lib.rt_render_launch.argtypes = [vp] * 15 + [vp] * 7
        lib.rt_render_launch.restype = ci
        # noise, image, bvh, stage_bytes, out (4 int32, host pointer)
        lib.rt_render_occupancy.argtypes = [ci, ci, ci, ci, vp]
        lib.rt_render_occupancy.restype = ci
        # kernel (1 record, 2 hit), bvh, stage_bytes, out (4 int32, host
        # pointer)
        lib.rt_search_occupancy.argtypes = [ci, ci, ci, vp]
        lib.rt_search_occupancy.restype = ci
        # 15 scene tables, params and plan (host pointers), out_rec,
        # counters, stream
        lib.rt_record_launch.argtypes = [vp] * 15 + [vp] * 5
        lib.rt_record_launch.restype = ci
        # 15 scene tables, params, ox oy oz dx dy dz time pix samp alive, n,
        # bounce, out, counters, stream
        lib.rt_hit_launch.argtypes = [vp] * 15 + [vp] * 11 + [cll, ci, vp,
                                                              vp, vp]
        lib.rt_hit_launch.restype = ci
        # col, n, idx, R, elem, out, stream
        lib.rt_gather_launch.argtypes = [vp, ci, vp, cll, ci, vp, vp]
        lib.rt_gather_launch.restype = ci
        # tab, K, n, idx, R, elem, out, stream
        lib.rt_gather_cols_launch.argtypes = [vp, ci, ci, vp, cll, ci, vp, vp]
        lib.rt_gather_cols_launch.restype = ci
        # ct, idx, R, n, K, is_double, B, chunk, W, Wc, cpw, rows, partial,
        # out, stream
        lib.rt_scatter_sum_launch.argtypes = [vp, vp, cll, ci, ci, ci, ci,
                                              cll, ci, ci, ci, ci, vp, vp, vp]
        lib.rt_scatter_sum_launch.restype = ci
        # ct, idx, R, n, K, is_double, B, chunk, partial, out, stream
        lib.rt_scatter_match_launch.argtypes = [vp, vp, cll, ci, ci, ci, ci,
                                                cll, vp, vp, vp]
        lib.rt_scatter_match_launch.restype = ci
        # idx, R, n, widths (host pointer), passes, vals, K, elem, keys_out,
        # vals_out, keys_tmp, vals_tmp, counts, totals, stream
        lib.rt_radix_sort_launch.argtypes = ([vp, cll, ci, vp, ci, vp, ci, ci]
                                             + [vp] * 7)
        lib.rt_radix_sort_launch.restype = ci
        # svals, skey, R, n, K, is_double, out, carry, tail_key, stream
        lib.rt_segment_sum_launch.argtypes = [vp, vp, cll, ci, ci, ci, vp, vp,
                                              vp, vp]
        lib.rt_segment_sum_launch.restype = ci
        # rv, perm_x, perm_y, perm_z, px, py, pz, R, depth, is_double, out,
        # stream
        lib.rt_perlin_launch.argtypes = [vp] * 7 + [cll, ci, ci, vp, vp]
        lib.rt_perlin_launch.restype = ci
        # rv, perm_x, perm_y, perm_z, px, py, pz, g, R, depth, is_double,
        # want_p, want_rv, d_px, d_py, d_pz, acc, d_rv, stream
        lib.rt_perlin_backward_launch.argtypes = ([vp] * 8
                                                  + [cll, ci, ci, ci, ci]
                                                  + [vp] * 6)
        lib.rt_perlin_backward_launch.restype = ci
        lib.rt_perlin_backward_acc_words.argtypes = [ci]
        lib.rt_perlin_backward_acc_words.restype = ci
        # probes: tab, n, space, out, total, stream
        lib.rt_probe_smem_scalar_launch.argtypes = [vp, ci, ci, vp, cll, vp]
        lib.rt_probe_row_broadcast_launch.argtypes = [vp, ci, ci, vp, cll,
                                                      vp]
        # tab, stride, reps, space, out, total, stream
        lib.rt_probe_gather_launch.argtypes = [vp, ci, ci, ci, vp, cll, vp]
        # tab, reps, space, out, total, stream
        lib.rt_probe_gather_2d_launch.argtypes = [vp, ci, ci, vp, cll, vp]
        # sph, S, o, d, R, reps, space, out, stream
        lib.rt_probe_sphere_loop_launch.argtypes = [vp, ci, vp, vp, cll, ci,
                                                    ci, vp, vp]
        # S, o, d, R, reps, out, stream
        lib.rt_probe_sphere_immediate_launch.argtypes = [ci, vp, vp, cll, ci,
                                                         vp, vp]
        # cm, r2, S, o, d, R, reps, tensor_cores, out, prods, stream
        lib.rt_probe_sphere_mxu_launch.argtypes = [vp, vp, ci, vp, vp, cll,
                                                   ci, ci, vp, vp, vp]
        for fn in ("smem_scalar", "row_broadcast", "gather", "gather_2d",
                   "sphere_loop", "sphere_immediate", "sphere_mxu"):
            getattr(lib, f"rt_probe_{fn}_launch").restype = ci
        lib.rt_error_string.argtypes = [ci]
        lib.rt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def error_string(err: int) -> str:
    return load().rt_error_string(err).decode()


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({error_string(err)})")
