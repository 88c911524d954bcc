"""BVH construction: pointer-free, array-encoded, built host-side.

The reference builds a pointer-based binary BVH at startup by recursive
median-split on a random axis (src/bvh.rs:31-66: pick axis, sort by bbox min,
split at the median) and traverses it recursively (bvh.rs:91-112). The
array form is a *flattened* tree in DFS preorder with skip links
(SURVEY.md §3.3): interleaved node arrays where a box hit advances to the
next node (the left child) and a miss jumps the whole subtree — a stackless
traversal that vectorizes over rays.

Build order matches bvh.rs semantics (seeded random axis, stable median
split); closest-hit pruning via the running best-t reproduces the reference's
tightening of the right child's interval (bvh.rs:99).

Primitive AABBs follow the reference:
- sphere: center +- r, motion blur unions both endpoint boxes (sphere.rs:23-46);
- quad: corner box padded to min thickness 1e-4 (quad.rs:41-43, aabb.rs:35-53).

A native C++ builder (runtime/bvh_builder.cpp) provides the same layout for
large scenes; this numpy version is the reference implementation and fallback.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

PAD_DELTA = 1e-4  # aabb.rs:36


@dataclasses.dataclass
class FlatBVH:
    node_min: np.ndarray  # (N,3) f
    node_max: np.ndarray  # (N,3) f
    skip: np.ndarray  # (N,) i32 — index to jump to when the box misses
    prim_type: np.ndarray  # (N,) i32 — -1 internal, 0 sphere, 1 quad
    prim_idx: np.ndarray  # (N,) i32 — index into the primitive SoA


def primitive_boxes(builder) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(box_min, box_max, prim_type, prim_idx) for all visible primitives."""
    mins, maxs, types, idxs = [], [], [], []
    for i in range(builder.num_spheres):
        c = np.asarray(builder.sph_center[i], np.float64)
        r = abs(builder.sph_radius[i])
        lo, hi = c - r, c + r
        cv = np.asarray(builder.sph_cvec[i], np.float64)
        if np.any(cv != 0.0):  # with_target: union of both endpoint boxes
            lo = np.minimum(lo, c + cv - r)
            hi = np.maximum(hi, c + cv + r)
        mins.append(lo); maxs.append(hi); types.append(0); idxs.append(i)
    for i in range(builder.num_quads):
        q = np.asarray(builder.quad_q[i], np.float64)
        u = np.asarray(builder.quad_u[i], np.float64)
        v = np.asarray(builder.quad_v[i], np.float64)
        corners = np.stack([q, q + u, q + v, q + u + v])
        lo, hi = corners.min(0), corners.max(0)
        thin = (hi - lo) < PAD_DELTA  # pad planar boxes (quad.rs:42)
        lo = np.where(thin, lo - PAD_DELTA / 2, lo)
        hi = np.where(thin, hi + PAD_DELTA / 2, hi)
        mins.append(lo); maxs.append(hi); types.append(1); idxs.append(i)
    if not mins:
        return (np.zeros((0, 3)), np.zeros((0, 3)),
                np.zeros(0, np.int32), np.zeros(0, np.int32))
    return (np.stack(mins), np.stack(maxs),
            np.asarray(types, np.int32), np.asarray(idxs, np.int32))


def build_native(box_min, box_max, prim_type, prim_idx, seed=0):
    """Native C++ builder (runtime/bvh_builder.cpp); None if unavailable."""
    import ctypes

    from ..runtime import load_library

    lib = load_library("bvh_builder")
    if lib is None or len(prim_idx) == 0:
        return None
    n = len(prim_idx)
    total = 2 * n - 1
    node_min = np.empty((total, 3), np.float64)
    node_max = np.empty((total, 3), np.float64)
    skip = np.empty(total, np.int32)
    out_type = np.empty(total, np.int32)
    out_idx = np.empty(total, np.int32)
    bmin = np.ascontiguousarray(box_min, np.float64)
    bmax = np.ascontiguousarray(box_max, np.float64)
    pt = np.ascontiguousarray(prim_type, np.int32)
    pi = np.ascontiguousarray(prim_idx, np.int32)
    c_dp = ctypes.POINTER(ctypes.c_double)
    c_ip = ctypes.POINTER(ctypes.c_int32)
    got = lib.rt_build_bvh(
        ctypes.c_int32(n),
        bmin.ctypes.data_as(c_dp), bmax.ctypes.data_as(c_dp),
        pt.ctypes.data_as(c_ip), pi.ctypes.data_as(c_ip),
        ctypes.c_uint64(seed),
        node_min.ctypes.data_as(c_dp), node_max.ctypes.data_as(c_dp),
        skip.ctypes.data_as(c_ip), out_type.ctypes.data_as(c_ip),
        out_idx.ctypes.data_as(c_ip))
    if got != total:
        return None
    return FlatBVH(node_min=node_min, node_max=node_max, skip=skip,
                   prim_type=out_type, prim_idx=out_idx)


def build(box_min: np.ndarray, box_max: np.ndarray, prim_type: np.ndarray,
          prim_idx: np.ndarray, seed: int = 0, native: bool = True) -> FlatBVH:
    """Flatten a median-split BVH over the given primitive boxes.

    Prefers the native C++ builder; falls back to the numpy reference
    implementation below (identical layout contract; split-axis RNG streams
    differ so trees differ per seed, hit results don't).
    """
    if native:
        flat = build_native(box_min, box_max, prim_type, prim_idx, seed)
        if flat is not None:
            return flat
    n = len(prim_idx)
    rng = np.random.default_rng(seed)

    node_min, node_max, skip, ntype, nidx = [], [], [], [], []

    def emit(lo, hi, ptype, pidx):
        node_min.append(lo); node_max.append(hi)
        skip.append(-1); ntype.append(ptype); nidx.append(pidx)
        return len(skip) - 1

    def rec(order: np.ndarray) -> int:
        """Emit the subtree for primitives ``order``; returns its node id."""
        lo = box_min[order].min(0)
        hi = box_max[order].max(0)
        if len(order) == 1:
            p = order[0]
            return emit(box_min[p], box_max[p], prim_type[p], prim_idx[p])
        me = emit(lo, hi, -1, -1)
        axis = int(rng.integers(0, 3))  # bvh.rs:32
        key = box_min[order][:, axis]
        sorted_order = order[np.argsort(key, kind="stable")]
        half = len(order) // 2
        rec(sorted_order[:half])
        rec(sorted_order[half:])
        skip[me] = len(skip)  # jump past the whole subtree
        return me

    if n:
        import sys
        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 4 * n + 100))
        rec(np.arange(n))
        sys.setrecursionlimit(old)

    N = len(skip)
    skip_arr = np.asarray(skip, np.int64)
    # leaves and any unset skips fall through to "next node"
    unset = skip_arr < 0
    skip_arr[unset] = np.arange(N)[unset] + 1
    return FlatBVH(
        node_min=np.asarray(node_min, np.float64).reshape(N, 3),
        node_max=np.asarray(node_max, np.float64).reshape(N, 3),
        skip=skip_arr.astype(np.int32),
        prim_type=np.asarray(ntype, np.int32),
        prim_idx=np.asarray(nidx, np.int32),
    )


def build_for(builder, seed: int = 0) -> FlatBVH:
    return build(*primitive_boxes(builder), seed=seed)
