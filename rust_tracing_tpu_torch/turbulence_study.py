"""Measurements behind the turbulence backward's d_ranvec sum
(``csrc/perlin_kernel.cu``, ``perlin_backward_kernel``), on one GPU:

  python -m rust_tracing_tpu_torch.turbulence_study atomics
      shared-memory integer atomics: 2^22 lanes x 56 steps x 3 adds at
      random rows of a 256 x 3 table, 32- and 64-bit, with and without
      copies of the table a lane, and the SASS atomic each compiles to;
  python -m rust_tracing_tpu_torch.turbulence_study trees PARENT [CHANGE]
      two checkouts in turns (PARENT, CHANGE, CHANGE, PARENT), each in a
      fresh process: the backward at 2^22 lanes (both outputs, positions
      only) and the forward by the profiler, and the two_perlin_spheres
      (400x225 @ 32 spp) and final_scene (200x200 @ 4 spp) gradients
      (three runs' seconds, peak memory, the backward's and the forward's
      device time). CHANGE defaults to this file's checkout.

Each prints JSON, with the card's name and power limit. Not imported by
the package (only ``card`` by probe_study): the ``trees`` workers import
the package of the checkout they measure."""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from collections import Counter

HERE = os.path.dirname(os.path.abspath(__file__))
LANES = 1 << 22

ATOMICS_CU = r"""
#include <cuda_runtime.h>

// lane l adds 3 words a step at a random row of replica l % REP
template <typename T, int REP, int ATOM>
__global__ void __launch_bounds__(256)
    atom_bench(long long R, int steps, unsigned long long* out) {
    extern __shared__ __align__(16) unsigned char sm[];
    T* tab = reinterpret_cast<T*>(sm);
    for (int i = threadIdx.x; i < 768 * REP; i += 256) tab[i] = 0;
    __syncthreads();
    const int rep = threadIdx.x % REP;
    T reg = 0;
    for (long long base = (long long)blockIdx.x * 256; base < R;
         base += (long long)gridDim.x * 256) {
        const long long i = base + threadIdx.x;
        unsigned x = (unsigned)i * 2654435761u + 12345u;
        const T v = (T)((i & 7) + 1);
        for (int s = 0; s < steps; ++s) {
            x ^= x << 13;
            x ^= x >> 17;
            x ^= x << 5;
            const int h = (x >> 8) & 255;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                if (ATOM)
                    atomicAdd(&tab[(3 * h + c) * REP + rep], v);
                else
                    reg += (T)h * v;
            }
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 768 * REP; i += 256)
        if (tab[i]) atomicAdd(out + (i / REP), (unsigned long long)tab[i]);
    if (!ATOM && reg == 12345) atomicAdd(out, 1ull);
}

template <typename T, int REP, int ATOM>
int run(long long R, int steps, void* out, void* st, int* per_sm) {
    const int smem = 768 * REP * sizeof(T);
    cudaFuncSetAttribute(atom_bench<T, REP, ATOM>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int dev = 0, nsm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, atom_bench<T, REP, ATOM>, 256, smem);
    atom_bench<T, REP, ATOM><<<nsm * *per_sm, 256, smem, (cudaStream_t)st>>>(
        R, steps, (unsigned long long*)out);
    return (int)cudaGetLastError();
}

extern "C" int atom_run(int variant, long long R, int steps, void* out,
                        void* st, int* per_sm) {
    switch (variant) {
        case 0: return run<unsigned, 1, 0>(R, steps, out, st, per_sm);
        case 1: return run<unsigned, 1, 1>(R, steps, out, st, per_sm);
        case 2: return run<unsigned long long, 1, 1>(R, steps, out, st, per_sm);
        case 3: return run<unsigned, 4, 1>(R, steps, out, st, per_sm);
        case 4: return run<unsigned long long, 4, 1>(R, steps, out, st, per_sm);
        case 5: return run<unsigned, 8, 1>(R, steps, out, st, per_sm);
        case 6: return run<unsigned long long, 8, 1>(R, steps, out, st, per_sm);
        case 7: return run<unsigned long long, 16, 1>(R, steps, out, st, per_sm);
        case 8: return run<unsigned, 32, 1>(R, steps, out, st, per_sm);
    }
    return -1;
}
"""
ATOMIC_VARIANTS = ("u32, no atomics (the hash loop alone)", "u32", "u64",
                   "u32 x4 copies", "u64 x4 copies", "u32 x8 copies",
                   "u64 x8 copies", "u64 x16 copies", "u32 x32 copies")


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _event_ms(fn, reps):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def atomics():
    """2^22 x 168 shared-memory adds, each variant timed twice (in one
    order, then the other) by CUDA events over 10 launches."""
    sys.path.insert(0, os.path.dirname(HERE))
    import torch
    from rust_tracing_tpu_torch.runtime import kernels

    nvcc = kernels._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        src, lib = os.path.join(tmp, "atom.cu"), os.path.join(tmp, "atom.so")
        with open(src, "w") as f:
            f.write(ATOMICS_CU)
        subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", lib, src],
                       check=True)
        dump = subprocess.run(
            [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", lib],
            capture_output=True, text=True).stdout
        sass, fn = {}, None
        for line in dump.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
            for op in re.findall(r"\b(ATOMS\.[A-Z0-9.]+)", line):
                sass.setdefault(fn, Counter())[op] += 1
        so = ctypes.CDLL(lib)
        so.atom_run.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_void_p]
        out = torch.zeros(768, dtype=torch.int64, device="cuda")
        per_sm = ctypes.c_int()
        res = {"card": card(), "lanes": LANES, "adds_a_lane": 168,
               "sass": {k: dict(v) for k, v in sass.items()}, "ms": {}}
        order = list(range(len(ATOMIC_VARIANTS)))
        for rnd in range(2):
            for v in (order if rnd == 0 else order[::-1]):
                def go():
                    err = so.atom_run(v, LANES, 56, out.data_ptr(),
                                      torch.cuda.current_stream().cuda_stream,
                                      ctypes.byref(per_sm))
                    if err:
                        raise RuntimeError(f"atom_run {v}: error {err}")
                res["ms"].setdefault(ATOMIC_VARIANTS[v], []).append(
                    _event_ms(go, 10))
                res.setdefault("blocks_an_sm", {})[ATOMIC_VARIANTS[v]] = \
                    per_sm.value
    print(json.dumps(res, indent=1))


def one(tree):
    """The measurements of ``trees`` with the package of checkout ``tree``,
    printed as one line starting with TREE."""
    # run as a script: its own directory is first on the path, and the
    # package's modules must not stand in for top-level ones
    sys.path[:] = [os.path.abspath(tree)] + [
        p for p in sys.path if os.path.abspath(p or ".") != HERE]
    import dataclasses

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import rust_tracing_tpu_torch as rt
    from rust_tracing_tpu_torch import grad as tg
    from rust_tracing_tpu_torch.models import builders
    from rust_tracing_tpu_torch.ops import perlin
    from rust_tracing_tpu_torch.ops import perlin_fused as pf
    from rust_tracing_tpu_torch.runtime import kernels

    kernels.load()

    def device_ms(fn, reps, key=None):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        sel = [e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and (key is None or key in e.name)]
        return sum(sel) / 1e3 / reps, len(sel)

    out = {"tree": os.path.abspath(tree)}
    rv, px, py, pz = perlin.make_tables(5)
    tabs = (torch.from_numpy(rv).cuda(),
            *[torch.from_numpy(q).cuda() for q in (px, py, pz)])
    pts = np.random.default_rng(7).uniform(-300, 300, (3, LANES))
    pos = [torch.from_numpy(a.astype(np.float32)).cuda() for a in pts]
    g = torch.from_numpy(np.random.default_rng(8).standard_normal(
        LANES).astype(np.float32)).cuda()
    out["bwd_ms"] = device_ms(
        lambda: pf.turbulence_backward_kernel(*tabs, *pos, g), 10)[0]
    out["bwd_positions_only_ms"] = device_ms(
        lambda: pf.turbulence_backward_kernel(*tabs, *pos, g, want_rv=False),
        10)[0]
    out["fwd_ms"] = device_ms(lambda: pf.turbulence_kernel(*tabs, *pos),
                              10)[0]
    for name, width, spp in (("two_perlin_spheres", 400, 32),
                             ("final_scene", 200, 4)):
        b, settings = getattr(builders, name)()
        settings = dataclasses.replace(settings, image_width=width,
                                       samples_per_pixel=spp, max_depth=8)
        scene = rt.compile_scene(b, device="cuda")
        camera = rt.Camera.create(settings)

        def run():
            return tg.loss_and_grad(scene, camera, lambda im, p: im.mean(),
                                    seed=6, linear_loss=True)

        run()
        torch.cuda.synchronize()
        secs = []
        for _ in range(3):
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 1e9
        bwd, n_bwd = device_ms(run, 1, "perlin_backward")
        fwd, n_fwd = device_ms(run, 1, "perlin_kernel")
        out[name] = dict(seconds=secs, peak_gb=peak, bwd_device_ms=bwd,
                         bwd_kernels=n_bwd, fwd_device_ms=fwd,
                         fwd_kernels=n_fwd)
    print("TREE " + json.dumps(out), flush=True)


def trees(parent, change=os.path.dirname(HERE)):
    """``one`` in each checkout, in turns, each in a fresh process, after
    both checkouts' kernels are built."""
    build = ("import sys; sys.path.insert(0, sys.argv[1]); from "
             "rust_tracing_tpu_torch.runtime import kernels; kernels.load()")
    for p in [subprocess.Popen([sys.executable, "-c", build, t])
              for t in (parent, change)]:
        if p.wait():
            raise SystemExit("a build failed")
    res = {"card": card(), "runs": []}
    for t in (parent, change, change, parent):
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "one",
                            t], capture_output=True, text=True)
        line = [ln for ln in p.stdout.splitlines() if ln.startswith("TREE ")]
        if p.returncode or not line:
            raise SystemExit(f"{t}: exit {p.returncode}\n{p.stdout[-3000:]}"
                             f"\n{p.stderr[-3000:]}")
        res["runs"].append(json.loads(line[0][5:]))
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    cmd, args = sys.argv[1], sys.argv[2:]
    {"atomics": atomics, "trees": trees, "one": one}[cmd](*args)
