"""Fused forward render: host side, CUDA kernel wrapper and plain version.

Replaces rust_tracing_tpu/ops/megakernel.py (the Pallas kernel built by
``_make_kernel`` and called through ``_get_call``, render mode with the
brute-force primitive loop). The whole render of a pixel range — camera
rays, closest hit over spheres and quads, constant media, five-material
scatter, emission, every texture family, spp accumulation — is ONE launch
of the hand-written CUDA kernel in ``csrc/render_kernel.cu``. The noise and
image families are the reference kernel's own approximations (its
``has_noise``/``has_image`` arms): hash-lattice turbulence instead of the
permutation tables, and a box-filtered mip of the image sampled at a sphere
UV from polynomial acos/atan2. Deferred shading (renderer.render_deferred)
is the path that shades them at full fidelity.

The same file holds the path recorder (``record_kernel``, the reference
kernel's record mode): the same trace, writing the winner record
``kind<<24 | idx`` of every (pixel, sample, bounce) for the replay pipeline
(ops/replay.py, grad.py); and the one-bounce hit kernel (``hit_kernel``, the
reference kernel's hit mode), the search of the sorted deferred wavefront
(ops/wavefront.py). Past ``BVH_KERNEL_THRESHOLD`` primitives (or with
``use_bvh``) all three walk a BVH instead of testing every primitive: the
reference kernel's BVH branch, over the card's tree (``widen_kernel_bvh``
of a ``build_kernel_bvh`` tree, laid out by ``pack_wide``; its plain walk
is ``walk_wide_plain``).

Three layers live here:

- ``pack_scene``: a CompiledScene's valid primitives as plain row-major
  ``(N, F)`` tables (f64 host arithmetic rounded once to f32, the same
  arithmetic as the reference pack) and, with a tree, its node and primitive
  stream tables; cached per (scene, use_bvh) on the device;
- ``render_kernel``, ``record_kernel`` and ``hit_kernel``: the wrappers that
  launch the CUDA kernels on CUDA tensors (or raise) and count their launches
  in ``LAUNCHES``;
- ``render_fast_plain``, ``record_paths_plain`` and ``hit_records_plain``:
  the same functions as tensor code over all lanes at once, with the
  kernel's arithmetic in the kernel's order (one shared search,
  ``_closest_surface`` and ``_media``). They are what runs for tensors on the
  CPU and what the kernels are held against on the card. The plain search
  tests every primitive whatever ``use_bvh`` says and returns the first
  minimum in (t, kind, idx) order, the brute loop's winner, which the BVH
  walk's tie rule returns too: an answer that does not depend on the tree.

Camera, spp, depth, primitive counts, seed, pixel range and sample offset
are runtime arguments of the kernel, so one compiled library serves every
scene and camera, and pixels are written in image order.

Every random draw is addressed by (seed, pixel, sample, bounce, site) through
ops/hashrng.py (csrc/hashrng.cuh in the kernel), never by launch geometry:
rendering a frame in pixel ranges or sample ranges gives the same numbers.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import math
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import QUAD_DENOM_EPS, T_MIN
from ..models.scene import (DIELECTRIC, DIFFUSE_LIGHT, ISOTROPIC, LAMBERTIAN,
                            MED_BOX, METAL, TEX_CHECKER, TEX_IMAGE, TEX_NOISE)
from ..runtime.kernels import LAUNCHES
from . import hashrng
from .hashrng import CounterRng

# Primitive count from which the kernels walk the kernel BVH instead of the
# brute-force loop (the default of every entry's ``use_bvh``). Copied as a
# policy constant: it was measured on a TPU; the card's own crossover is in
# PERF.md (chip_smoke.py, phase crossover).
BVH_KERNEL_THRESHOLD = 1024

# Leaf runs of the kernel BVH hold up to this many primitives.
BVH_LEAF_SIZE = 16

# The card's tree (``widen_kernel_bvh``): the kernel BVH collapsed into nodes
# of BVH_WIDTH children, walked near child first with a stack of WALK_STACK
# entries a thread (csrc/render_kernel.cu mirrors all three). The binary
# tree it collapses has leaves of BVH_CARD_LEAF_SIZE primitives. Width and
# leaf size are the card's own, chosen by measurement (PERF.md §6): on
# final_scene's fused frame single-primitive leaves beat leaves of 2, 4, 8
# and 16, and 4-wide nodes beat 8-wide ones at every leaf size. The walk
# reads the tree through the read-only path: final_scene's (237 KB) fits no
# block's shared memory, and its leaf-16 tree (17 KB) staged there measured
# slower than through L1.
BVH_WIDTH = 4
BVH_CARD_LEAF_SIZE = 1
WALK_STACK = 48
EMPTY_SLOT = -(1 << 31)
# The card's boxes are the binary tree's, widened outward by this share of
# the scene's scale (its largest coordinate plus its diagonal) and rounded
# outward to f32: a primitive's f32 hit may lie a few ulps of that scale
# outside its exact box, and the slab test's own f32 rounding moves the
# box's faces by as much, so an exact box can drop a winner that grazes a
# face or edge. A larger box only adds visits.
BOX_PAD = 2.0 ** -17

# Lanes x primitives per step of the plain search: bounds its temporaries.
SEARCH_CHUNK = 1 << 23

# The render kernel's launch (csrc/render_kernel.cu): blocks of
# RENDER_THREADS threads; a group of ``samples_per_group(spp)`` consecutive
# threads traces one pixel, at most RENDER_MAX_GROUP (a warp).
RENDER_THREADS = 128
RENDER_MAX_GROUP = 32

# The recorder's launch (csrc/render_kernel.cu): blocks of RECORD_THREADS
# threads, one thread a (pixel, sample), a warp 32 consecutive pixels of one
# sample (``record_plan``).
RECORD_THREADS = 128

# Shared memory a block of the brute-loop render kernel (and recorder) may
# stage its scene tables in (``render_plan``, ``record_plan``). Registers
# let an H100 SM hold 8 blocks of the staged render kernel (63 a thread); 8
# x (24 KB + the 1 KB a block reserves) fit its 228 KB, so staging costs no
# occupancy.
STAGE_BUDGET_BYTES = 24 * 1024

# Bytes a row of each table that the brute-loop render kernel stages, in the
# order it stages them, with the RenderParams count (or table) of its rows.
_STAGED_ROWS = (("sph_f", 32, "n_spheres"), ("sph_m", 4, "n_spheres"),
                ("quad_f", 64, "n_quads"), ("quad_m", 4, "n_quads"),
                ("med_f", 96, "n_media"), ("med_i", 8, "n_media"),
                ("mat_f", 20, "mat_f"), ("mat_i", 8, "mat_f"),
                ("tex_f", 16, "tex_f"), ("tex_i", 12, "tex_f"))

# f32 origin offset along the normal after a surface scatter.
ORIGIN_EPS_ABS = 1e-4
ORIGIN_EPS_REL = 2e-4

SPH_F, QUAD_F, MED_F = 8, 16, 24

# In-kernel image textures sample a box-filtered mip of at most this many
# texels (the reference's limit, megakernel.py:83). The table stays in global
# memory: 32768 texels x 12 bytes do not fit a block's shared memory.
IMG_MAX_TEXELS = 32768

# Constants of the in-kernel noise and UV arms (megakernel.py:404-503), as the
# reference writes them; float literals round from double to f32 once.
NOISE_SALT = 0x5EED
_PI = math.pi
_ATAN_COEF = (-0.005020576, 0.025330155, -0.060872567, 0.100020881,
              -0.140477845, 0.199740231, -0.333322323, 0.999999923)
_ACOS_COEF = (-0.0012624911, 0.0066700901, -0.0170881256, 0.0308918810,
              -0.0501743046, 0.0889789874, -0.2145988016, 1.5707963050)


# ------------------------------------------------------------- scene packing
@dataclasses.dataclass
class PackedScene:
    """Host-side numpy pack of a CompiledScene. Only VALID primitives are
    packed (no masks in the hot loop); empty families keep one zero row so
    every table has a valid pointer."""

    sph_f: np.ndarray   # (S,8) f32: cx cy cz r2 inv_r mvx mvy mvz
    sph_m: np.ndarray   # (S,) i32 material id
    quad_f: np.ndarray  # (Q,16) f32: q(3) u(3) v(3) n(3) w(3) d
    quad_m: np.ndarray  # (Q,) i32
    med_f: np.ndarray   # (M,24) f32: R(9) trans(3) lo(3) hi(3) c(3) r2 nid pad
    med_i: np.ndarray   # (M,2) i32: type mat
    mat_f: np.ndarray   # (N,5) f32: alb_r alb_g alb_b fuzz ir
    mat_i: np.ndarray   # (N,2) i32: type tex
    tex_f: np.ndarray   # (T,4) f32: rgb_r rgb_g rgb_b scale (inv or noise)
    tex_i: np.ndarray   # (T,3) i32: type even odd
    img_f: np.ndarray   # (3,IH,IW) f32: mipped image texels r g b
    bvh_f: np.ndarray   # (N,6) f32: node min xyz, max xyz
    bvh_i: np.ndarray   # (N,4) i32: skip start count scount (count 0: inner)
    prim_i: np.ndarray  # (P,2) i32: kind (0 sphere, 1 quad) idx, leaf order
    # the card's tree (``pack_wide``; one zero row each without a tree)
    wbvh: np.ndarray    # (U,4) i32: wide nodes and leaf headers
    wsph_f: np.ndarray  # (S,8) f32: sphere rows in leaf order
    wsph_i: np.ndarray  # (S,) i32: their packed indices
    wquad_f: np.ndarray  # (Q,16) f32: quad rows in leaf order
    wquad_i: np.ndarray  # (Q,) i32
    n_spheres: int = 0
    n_quads: int = 0
    n_media: int = 0
    has_checker: bool = False
    has_noise: bool = False
    has_image: bool = False
    img_h: int = 1
    img_w: int = 1
    use_bvh: bool = False  # the tables hold a tree
    n_nodes: int = 1

    # the kernels' pointer arguments, in order (the render kernel also takes
    # ``img_f``). The binary tree's tables (``bvh_f``, ``bvh_i``,
    # ``prim_i``) are the reference's layout, from which the card's
    # derives: no kernel reads them.
    TABLES = ("sph_f", "sph_m", "quad_f", "quad_m", "med_f", "med_i",
              "mat_f", "mat_i", "tex_f", "tex_i", "wbvh", "wsph_f", "wsph_i",
              "wquad_f", "wquad_i")


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def pack_scene(scene, bvh=None) -> PackedScene:
    """Pack a CompiledScene (and a ``KernelBVH`` of it, if given, with the
    card's tree: ``widen_kernel_bvh`` of the scene's kernel BVH with leaves
    of BVH_CARD_LEAF_SIZE) into the kernel's tables. Derived quantities
    (r^2, 1/r, quad normal, w, d) are computed in float64 from the scene's
    f32 leaves and rounded once, exactly as the reference pack does."""
    f64 = lambda a: _np(a).astype(np.float64)
    sv = _np(scene.sph_valid)
    qv = _np(scene.quad_valid)
    mv = _np(scene.med_valid)

    c = f64(scene.sph_center)[sv]
    r = f64(scene.sph_radius)[sv]
    cv = f64(scene.sph_cvec)[sv]
    S = len(r)
    sph_f = np.zeros((max(S, 1), SPH_F), np.float32)
    if S:
        sph_f[:S, 0:3] = c
        sph_f[:S, 3] = r * r
        sph_f[:S, 4] = 1.0 / np.where(np.abs(r) < 1e-12, 1e-12, r)
        sph_f[:S, 5:8] = cv
    sph_m = np.zeros(max(S, 1), np.int32)
    sph_m[:S] = _np(scene.sph_mat)[sv]

    q = f64(scene.quad_q)[qv]
    u = f64(scene.quad_u)[qv]
    v = f64(scene.quad_v)[qv]
    Q = len(q)
    quad_f = np.zeros((max(Q, 1), QUAD_F), np.float32)
    if Q:
        n = np.cross(u, v)
        nlen2 = np.maximum((n * n).sum(-1, keepdims=True), 1e-30)
        normal = n / np.sqrt(nlen2)
        w = n / nlen2
        d = (normal * q).sum(-1)
        quad_f[:Q, 0:3] = q
        quad_f[:Q, 3:6] = u
        quad_f[:Q, 6:9] = v
        quad_f[:Q, 9:12] = normal
        quad_f[:Q, 12:15] = w
        quad_f[:Q, 15] = d
    quad_m = np.zeros(max(Q, 1), np.int32)
    quad_m[:Q] = _np(scene.quad_mat)[qv]

    M = int(mv.sum())
    med_f = np.zeros((max(M, 1), MED_F), np.float32)
    med_i = np.zeros((max(M, 1), 2), np.int32)
    if M:
        med_f[:M, 0:9] = f64(scene.med_rot)[mv].reshape(M, 9)
        med_f[:M, 9:12] = f64(scene.med_trans)[mv]
        med_f[:M, 12:15] = f64(scene.med_lo)[mv]
        med_f[:M, 15:18] = f64(scene.med_hi)[mv]
        med_f[:M, 18:21] = f64(scene.med_sph_center)[mv]
        med_f[:M, 21] = f64(scene.med_sph_radius)[mv] ** 2
        med_f[:M, 22] = f64(scene.med_neg_inv_density)[mv]
        med_i[:M, 0] = _np(scene.med_type)[mv]
        med_i[:M, 1] = _np(scene.med_mat)[mv]

    mat_f = np.concatenate(
        [f64(scene.mat_albedo), f64(scene.mat_fuzz)[:, None],
         f64(scene.mat_ir)[:, None]], axis=1).astype(np.float32)
    mat_i = np.stack([_np(scene.mat_type), _np(scene.mat_tex)],
                     axis=1).astype(np.int32)

    tex_types = _np(scene.tex_type)
    # inv_scale (checker) and noise_scale (noise) are never both non-zero
    tex_scale = f64(scene.tex_inv_scale) + f64(scene.tex_noise_scale)
    tex_f = np.concatenate([f64(scene.tex_rgb), tex_scale[:, None]],
                           axis=1).astype(np.float32)
    tex_i = np.stack([tex_types, _np(scene.tex_even), _np(scene.tex_odd)],
                     axis=1).astype(np.int32)

    # image texture: box-filter mip to <= IMG_MAX_TEXELS (megakernel.py:
    # 214-225), f64 means rounded once
    has_image = bool(scene.has_image)
    img = f64(scene.image)
    ih, iw = img.shape[0], img.shape[1]
    if has_image and ih * iw > IMG_MAX_TEXELS:
        f = int(np.ceil(np.sqrt(ih * iw / IMG_MAX_TEXELS)))
        ch, cw = (ih // f) * f, (iw // f) * f
        img = img[:ch, :cw].reshape(ch // f, f, cw // f, f, 3).mean((1, 3))
        ih, iw = img.shape[0], img.shape[1]
    img_f = np.ascontiguousarray(
        img.reshape(-1, 3).T.astype(np.float32).reshape(3, ih, iw))

    # the kernel BVH (megakernel.py:204-213) and the card's tree; one zero
    # row each without them
    if bvh is not None:
        bvh_f = np.concatenate([bvh.node_min, bvh.node_max],
                               -1).astype(np.float32)
        bvh_i = np.stack([bvh.skip, bvh.leaf_start, bvh.leaf_count,
                          bvh.leaf_scount], -1).astype(np.int32)
        prim_i = bvh.prim_stream.astype(np.int32)
        wide = pack_wide(widen_kernel_bvh(
            build_kernel_bvh(scene, BVH_CARD_LEAF_SIZE)), sph_f, quad_f)
    else:
        bvh_f = np.zeros((1, 6), np.float32)
        bvh_i = np.zeros((1, 4), np.int32)
        prim_i = np.zeros((1, 2), np.int32)
        wide = dict(wbvh=np.zeros((1, 4), np.int32),
                    wsph_f=np.zeros((1, SPH_F), np.float32),
                    wsph_i=np.zeros(1, np.int32),
                    wquad_f=np.zeros((1, QUAD_F), np.float32),
                    wquad_i=np.zeros(1, np.int32))

    return PackedScene(
        sph_f=sph_f, sph_m=sph_m, quad_f=quad_f, quad_m=quad_m,
        med_f=med_f, med_i=med_i, mat_f=mat_f, mat_i=mat_i,
        tex_f=tex_f, tex_i=tex_i, img_f=img_f,
        bvh_f=bvh_f, bvh_i=bvh_i, prim_i=prim_i, **wide,
        n_spheres=S, n_quads=Q, n_media=M,
        has_checker=bool((tex_types == TEX_CHECKER).any()),
        has_noise=bool((tex_types == TEX_NOISE).any()),
        has_image=has_image, img_h=ih, img_w=iw,
        use_bvh=bvh is not None, n_nodes=bvh_i.shape[0],
    )


@dataclasses.dataclass
class KernelBVH:
    """Flat skip-link tree with contiguous leaf runs over a reordered
    primitive stream: models/bvh.py's layout specialised for the kernels."""

    node_min: np.ndarray     # (N,3) f64
    node_max: np.ndarray     # (N,3) f64
    skip: np.ndarray         # (N,) i32: next node when the box is missed
    leaf_start: np.ndarray   # (N,) i32
    leaf_count: np.ndarray   # (N,) i32, 0 for an inner node
    leaf_scount: np.ndarray  # (N,) i32: leading sphere count of the leaf run
    prim_stream: np.ndarray  # (P,2) i32: kind idx, leaf order, spheres first


def prim_boxes(scene):
    """(box_min, box_max, kind, index) of the scene's valid primitives in
    float64 (models/bvh.py::primitive_boxes over the packed indices: kind 0
    sphere, 1 quad)."""
    from ..models import bvh as bvh_mod

    sv = _np(scene.sph_valid)
    qv = _np(scene.quad_valid)

    class _B:  # bvh_mod.primitive_boxes over the valid primitives only
        sph_center = _np(scene.sph_center)[sv]
        sph_radius = _np(scene.sph_radius)[sv]
        sph_cvec = _np(scene.sph_cvec)[sv]
        quad_q = _np(scene.quad_q)[qv]
        quad_u = _np(scene.quad_u)[qv]
        quad_v = _np(scene.quad_v)[qv]
        num_spheres = int(sv.sum())
        num_quads = int(qv.sum())

    return bvh_mod.primitive_boxes(_B)


def build_kernel_bvh(scene,
                     leaf_size: int = BVH_LEAF_SIZE) -> Optional[KernelBVH]:
    """Median-split BVH over the scene's valid primitives, flattened in
    preorder with skip links, whose leaves hold runs of up to ``leaf_size``
    primitives stored contiguously in a reordered stream, spheres first: the
    kernel tests a leaf with two typed loops (megakernel.py:255-349).

    The split axis is the box's largest extent. The tree decides which
    primitives a ray tests, never which one wins. None for a scene without
    primitives."""
    box_min, box_max, ptype, pidx = prim_boxes(scene)
    n = len(pidx)
    if n == 0:
        return None
    node_min, node_max, skip, lstart, lcount, lscount = [], [], [], [], [], []
    stream = []

    def emit(lo, hi, start, count, scount=0):
        node_min.append(lo)
        node_max.append(hi)
        skip.append(-1)
        lstart.append(start)
        lcount.append(count)
        lscount.append(scount)
        return len(skip) - 1

    def rec(order):
        lo = box_min[order].min(0)
        hi = box_max[order].max(0)
        if len(order) <= leaf_size:
            start = len(stream)
            sph = [q for q in order if ptype[q] == 0]
            qds = [q for q in order if ptype[q] != 0]
            stream.extend((0, int(pidx[q])) for q in sph)
            stream.extend((1, int(pidx[q])) for q in qds)
            return emit(lo, hi, start, len(order), len(sph))
        me = emit(lo, hi, 0, 0)
        axis = int(np.argmax(hi - lo))
        ordered = order[np.argsort(box_min[order][:, axis], kind="stable")]
        half = len(order) // 2
        rec(ordered[:half])
        rec(ordered[half:])
        skip[me] = len(skip)  # past the whole subtree
        return me

    rec(np.arange(n))  # depth ~log2(n / leaf_size): no recursion limit
    N = len(skip)
    skip_arr = np.asarray(skip, np.int64)
    unset = skip_arr < 0  # leaves fall through to the next node
    skip_arr[unset] = np.arange(N)[unset] + 1
    return KernelBVH(
        node_min=np.asarray(node_min, np.float64).reshape(N, 3),
        node_max=np.asarray(node_max, np.float64).reshape(N, 3),
        skip=skip_arr.astype(np.int32),
        leaf_start=np.asarray(lstart, np.int32),
        leaf_count=np.asarray(lcount, np.int32),
        leaf_scount=np.asarray(lscount, np.int32),
        prim_stream=np.asarray(stream, np.int32).reshape(-1, 2),
    )


@dataclasses.dataclass
class WideBVH:
    """The kernel BVH collapsed into nodes of up to W = BVH_WIDTH children
    (``widen_kernel_bvh``): the card's tree. Child slots are packed to the
    front of a node; a missing child is ``EMPTY_SLOT``."""

    lo: np.ndarray       # (N,3,W) f32: each child's box min, rows x y z
    hi: np.ndarray       # (N,3,W) f32: each child's box max
    ref: np.ndarray      # (N,W) i32: wide node j >= 0, leaf ~l, EMPTY_SLOT
    leaf: np.ndarray     # (L,4) i32: sphere row start, count, quad row
    #                      start, count (rows in leaf order)
    sph_idx: np.ndarray  # (S,) i32: packed sphere index of each leaf row
    quad_idx: np.ndarray  # (Q,) i32: packed quad index of each leaf row
    depth: int           # inner nodes on the longest root-to-leaf path


def _f32_toward(x: np.ndarray, inf: float) -> np.ndarray:
    """float64 ``x`` rounded to f32 toward ``inf`` (+inf or -inf)."""
    y = x.astype(np.float32)
    off = (y > x) if inf < 0 else (y < x)
    return np.where(off, np.nextafter(y, np.float32(inf)), y)


def widen_kernel_bvh(bvh: KernelBVH) -> WideBVH:
    """Collapse the binary kernel BVH into a tree of up to BVH_WIDTH
    children a node, for the card's walk (csrc/render_kernel.cu,
    ``closest_surface<MODE, true>``).

    A wide node takes the two children of a binary inner node and replaces
    the inner child of largest surface area (the first of equal ones) by its
    own two children, in place, until it holds BVH_WIDTH or only leaves.
    Every wide child is a node of the binary tree, with that node's box
    widened by BOX_PAD of the scene's scale and rounded outward to f32.
    Leaves are the binary leaves, numbered in preorder, so their rows stay
    contiguous runs in the binary stream's order, spheres first."""
    width = BVH_WIDTH
    scale = (np.abs(np.concatenate([bvh.node_min[0], bvh.node_max[0]])).max()
             + np.linalg.norm(bvh.node_max[0] - bvh.node_min[0]))
    pad = BOX_PAD * scale
    lo_b = _f32_toward(bvh.node_min - pad, -np.inf)
    hi_b = _f32_toward(bvh.node_max + pad, np.inf)
    ext = bvh.node_max - bvh.node_min
    area = (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
            + ext[:, 2] * ext[:, 0])
    lcount, skip = bvh.leaf_count, bvh.skip

    def children(i):
        kids = [i + 1, int(skip[i + 1])]
        while len(kids) < width:
            inner = [k for k in kids if lcount[k] == 0]
            if not inner:
                break
            j = max(inner, key=lambda k: (area[k], -kids.index(k)))
            at = kids.index(j)
            kids[at:at + 1] = [j + 1, int(skip[j + 1])]
        return kids

    nodes, leaves = [], []

    def build(kids, depth):
        me = len(nodes)
        nodes.append(None)
        refs, deepest = [], depth
        for k in kids:
            if lcount[k] > 0:
                refs.append(~len(leaves))
                leaves.append(k)
            else:
                j, d = build(children(k), depth + 1)
                refs.append(j)
                deepest = max(deepest, d)
        nodes[me] = (kids, refs)
        return me, deepest

    _, depth = build([0] if lcount[0] > 0 else children(0), 1)
    N, L = len(nodes), len(leaves)
    lo = np.zeros((N, 3, width), np.float32)
    hi = np.zeros((N, 3, width), np.float32)
    ref = np.full((N, width), EMPTY_SLOT, np.int32)
    for j, (kids, refs) in enumerate(nodes):
        lo[j, :, :len(kids)] = lo_b[kids].T
        hi[j, :, :len(kids)] = hi_b[kids].T
        ref[j, :len(kids)] = refs
    leaf = np.zeros((L, 4), np.int32)
    sph, quad = [], []
    for l, k in enumerate(leaves):
        s, c, sc = (int(bvh.leaf_start[k]), int(bvh.leaf_count[k]),
                    int(bvh.leaf_scount[k]))
        leaf[l] = (len(sph), sc, len(quad), c - sc)
        sph.extend(bvh.prim_stream[s:s + sc, 1])
        quad.extend(bvh.prim_stream[s + sc:s + c, 1])
    return WideBVH(lo=lo, hi=hi, ref=ref, leaf=leaf,
                   sph_idx=np.asarray(sph, np.int32),
                   quad_idx=np.asarray(quad, np.int32), depth=depth)


def pack_wide(wide: WideBVH, sph_f: np.ndarray, quad_f: np.ndarray) -> dict:
    """The card's tables of a wide tree: ``wbvh``, one int32 table of
    16-byte units, the nodes (each 7W/4 units: the children's min x, y, z,
    max x, y, z rows of W f32 each, then their W refs) followed by the leaf
    headers (one unit each); a ref is the unit offset of a wide node, or
    ``~unit`` of a leaf header. And the leaf rows: the packed sphere and
    quad rows gathered in leaf order (``wsph_f``, ``wquad_f``) with their
    packed indices (``wsph_i``, ``wquad_i``: the tie key and the winner's
    row)."""
    N, _, W = wide.lo.shape
    if (W - 1) * wide.depth > WALK_STACK:
        raise ValueError(f"a tree {wide.depth} nodes deep needs "
                         f"{(W - 1) * wide.depth} stack entries, the walk has "
                         f"{WALK_STACK}")
    units = 7 * W // 4
    words = np.zeros((N * 7 * W + 4 * len(wide.leaf),), np.int32)
    body = words[:N * 7 * W].reshape(N, 7, W)
    body[:, 0:3] = wide.lo.view(np.int32)
    body[:, 3:6] = wide.hi.view(np.int32)
    body[:, 6] = np.where(wide.ref >= 0, wide.ref * units,
                          np.where(wide.ref == EMPTY_SLOT, EMPTY_SLOT,
                                   ~(N * units + ~wide.ref)))
    words[N * 7 * W:] = wide.leaf.reshape(-1)

    def rows(table, idx, width):
        out = table[idx] if len(idx) else np.zeros((1, width), np.float32)
        return np.ascontiguousarray(out)

    return dict(wbvh=words.reshape(-1, 4),
                wsph_f=rows(sph_f, wide.sph_idx, SPH_F),
                wsph_i=wide.sph_idx if len(wide.sph_idx) else
                np.zeros(1, np.int32),
                wquad_f=rows(quad_f, wide.quad_idx, QUAD_F),
                wquad_i=wide.quad_idx if len(wide.quad_idx) else
                np.zeros(1, np.int32))


def walk_wide_plain(tables: dict, ox, oy, oz, dx, dy, dz, time):
    """The card's walk of the wide tree, ray by ray in numpy f32, reading
    the device tables (``wbvh``, the leaf rows) as the kernel does: the
    plain version of its visiting order and counters. Children are taken
    in order of slab entry t, equal t by slot; a node popped from the stack
    is skipped when its entry t exceeds t_best; a primitive wins with the
    tie rule (smaller t, or equal t and lower (kind, idx)). numpy does not
    contract multiply-adds, and rounds each f32 operation as the kernel
    does.

    Returns (rec (n,) int32 ``kind<<24 | idx`` of the closest surface, 0 on
    a miss; t (n,) f32; counters (n,3) int32: child boxes tested, spheres
    tested, quads tested)."""
    f32 = np.float32
    width = BVH_WIDTH
    words = _np(tables["wbvh"]).reshape(-1)
    fw = words.view(np.float32)
    sph, sid = _np(tables["wsph_f"]), _np(tables["wsph_i"])
    quad, qid = _np(tables["wquad_f"]), _np(tables["wquad_i"])
    ray = [_np(a).astype(np.float32) for a in (ox, oy, oz, dx, dy, dz, time)]
    n = len(ray[0])
    rec = np.zeros(n, np.int32)
    t_out = np.full(n, np.inf, np.float32)
    counts = np.zeros((n, 3), np.int32)
    t_min, tiny, eps = f32(T_MIN), f32(1e-30), f32(QUAD_DENOM_EPS)
    for k in range(n):
        o = np.array([ray[0][k], ray[1][k], ray[2][k]], np.float32)
        d = np.array([ray[3][k], ray[4][k], ray[5][k]], np.float32)
        tm = ray[6][k]
        inv = f32(1.0) / np.where(np.abs(d) < tiny, tiny, d)
        a_len = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        inv_a = f32(1.0) / max(a_len, tiny)
        t_best, best = f32(np.inf), 0
        visits = n_sph = n_quad = 0
        stack, cur = [], 0
        while True:
            if cur >= 0:
                base = 4 * int(cur)
                ref = words[base + 6 * width:base + 7 * width]
                m = int((ref != EMPTY_SLOT).sum())
                box = fw[base:base + 6 * width].reshape(6, width)[:, :m]
                t0 = (box[0:3] - o[:, None]) * inv[:, None]
                t1 = (box[3:6] - o[:, None]) * inv[:, None]
                mn, mx = np.minimum(t0, t1), np.maximum(t0, t1)
                tmn = np.maximum(np.maximum(mn[0], mn[1]),
                                 np.maximum(mn[2], t_min))
                tmx = np.minimum(np.minimum(mx[0], mx[1]),
                                 np.minimum(mx[2], t_best))
                visits += m
                hits = sorted((c for c in range(m) if tmx[c] >= tmn[c]),
                              key=lambda c: (tmn[c], c))
                if hits:
                    stack.extend((int(ref[c]), tmn[c])
                                 for c in reversed(hits[1:]))
                    cur = int(ref[hits[0]])
                    continue
            else:
                s0, cs, q0, cq = (int(v) for v in
                                  words[4 * ~cur:4 * ~cur + 4])
                cand = []
                if cs:
                    s = sph[s0:s0 + cs]
                    ocx = o[0] - (s[:, 0] + s[:, 5] * tm)
                    ocy = o[1] - (s[:, 1] + s[:, 6] * tm)
                    ocz = o[2] - (s[:, 2] + s[:, 7] * tm)
                    half_b = ocx * d[0] + ocy * d[1] + ocz * d[2]
                    c = ocx * ocx + ocy * ocy + ocz * ocz - s[:, 3]
                    disc = half_b * half_b - a_len * c
                    sq = np.sqrt(np.maximum(disc, f32(0.0)))
                    r1 = (-half_b - sq) * inv_a
                    r2 = (-half_b + sq) * inv_a
                    t = np.where(r1 > t_min, r1,
                                 np.where(r2 > t_min, r2, f32(np.inf)))
                    t = np.where(disc > f32(0.0), t, f32(np.inf))
                    cand += [(t[j], (1 << 24) | int(sid[s0 + j]))
                             for j in range(cs)]
                if cq:
                    q = quad[q0:q0 + cq]
                    nx, ny, nz = q[:, 9], q[:, 10], q[:, 11]
                    denom = nx * d[0] + ny * d[1] + nz * d[2]
                    safe = np.where(np.abs(denom) < tiny, tiny, denom)
                    t = (q[:, 15] - (nx * o[0] + ny * o[1] + nz * o[2])) / safe
                    hx = o[0] + t * d[0] - q[:, 0]
                    hy = o[1] + t * d[1] - q[:, 1]
                    hz = o[2] + t * d[2] - q[:, 2]
                    ux, uy, uz = q[:, 3], q[:, 4], q[:, 5]
                    vx, vy, vz = q[:, 6], q[:, 7], q[:, 8]
                    wx, wy, wz = q[:, 12], q[:, 13], q[:, 14]
                    alpha = (wx * (hy * vz - hz * vy)
                             + wy * (hz * vx - hx * vz)
                             + wz * (hx * vy - hy * vx))
                    beta = (wx * (uy * hz - uz * hy)
                            + wy * (uz * hx - ux * hz)
                            + wz * (ux * hy - uy * hx))
                    ok = ((np.abs(denom) >= eps) & (t >= t_min)
                          & (alpha >= 0) & (alpha <= 1)
                          & (beta >= 0) & (beta <= 1))
                    t = np.where(ok, t, f32(np.inf))
                    cand += [(t[j], (2 << 24) | int(qid[q0 + j]))
                             for j in range(cq)]
                for t, key in cand:  # the kernel's order: spheres, quads
                    if t < t_best or (t == t_best and key < best):
                        t_best, best = t, key
                n_sph += cs
                n_quad += cq
            cur = None
            while stack:
                r, t = stack.pop()
                if not t > t_best:
                    cur = r
                    break
            if cur is None:
                break
        rec[k] = best if np.isfinite(t_best) else 0
        t_out[k] = t_best
        counts[k] = (visits, n_sph, n_quad)
    return rec, t_out, counts


def n_prims(scene) -> int:
    """Valid spheres plus valid quads."""
    return int(_np(scene.sph_valid).sum() + _np(scene.quad_valid).sum())


def _use_bvh(scene, use_bvh: Optional[bool]) -> bool:
    return n_prims(scene) >= BVH_KERNEL_THRESHOLD if use_bvh is None \
        else bool(use_bvh)


def _tex_reaches_image(scene, tex_ids) -> bool:
    """True if any texture id in ``tex_ids`` samples the image texture,
    directly or through one checker nesting level (all that SceneBuilder allows)."""
    tex_type = _np(scene.tex_type)
    tex_even = _np(scene.tex_even)
    tex_odd = _np(scene.tex_odd)
    for t in np.unique(np.asarray(tex_ids)):
        if tex_type[t] == TEX_IMAGE:
            return True
        if tex_type[t] == TEX_CHECKER and (
                tex_type[tex_even[t]] == TEX_IMAGE
                or tex_type[tex_odd[t]] == TEX_IMAGE):
            return True
    return False


def supports(scene) -> bool:
    """Fused-kernel coverage policy, as in the reference: every scene family
    except an image texture routed to a quad or medium material (only sphere
    UVs are tracked in the kernel)."""
    if not scene.has_image:
        return True
    nonsphere_mats = []
    if scene.has_quads:
        qv = _np(scene.quad_valid)
        nonsphere_mats.append(_np(scene.quad_mat)[qv])
    if scene.has_media:
        mv = _np(scene.med_valid)
        nonsphere_mats.append(_np(scene.med_mat)[mv])
    if not nonsphere_mats:
        return True
    mats = np.unique(np.concatenate(nonsphere_mats))
    return not _tex_reaches_image(scene, _np(scene.mat_tex)[mats])


# ------------------------------------------------------- device-table cache
# Packing and uploading are pure functions of the scene, so they are cached by
# object identity. The cache is bounded: dead weakrefs are swept and the
# oldest entry evicted, so a loop that compiles a scene per step cannot leak
# device memory.
_pack_cache: "collections.OrderedDict" = collections.OrderedDict()
_PACK_CACHE_MAX = 8  # (id(scene), use_bvh) -> (weakref, packed, tables)


def _packed_dev(scene, use_bvh: bool = False) -> Tuple[PackedScene, dict]:
    """(packed, tables) for a scene: the host pack (with the kernel BVH when
    ``use_bvh``) and its tables as contiguous tensors on the scene's device.
    ``packed.use_bvh`` says whether a tree exists (a scene without
    primitives has none)."""
    key = (id(scene), bool(use_bvh))
    ent = _pack_cache.get(key)
    if ent is not None and ent[0]() is scene:
        _pack_cache.move_to_end(key)
        return ent[1], ent[2]
    for k in [k for k, e in _pack_cache.items() if e[0]() is None]:
        del _pack_cache[k]
    while len(_pack_cache) >= _PACK_CACHE_MAX:
        _pack_cache.popitem(last=False)
    packed = pack_scene(scene, build_kernel_bvh(scene) if use_bvh else None)
    dev = scene.device
    host = {name: getattr(packed, name)
            for name in PackedScene.TABLES + ("img_f",)}
    # the reference tree's nodes, two 16-byte rows each as the reference
    # kernel reads them: no kernel of the port reads them, only the check of
    # the pack against the reference's (tests/test_torch_bvh.py)
    host["bvh_f"] = np.pad(packed.bvh_f, ((0, 0), (0, 2)))
    tables = {name: torch.from_numpy(a).to(dev).contiguous()
              for name, a in host.items()}
    _pack_cache[key] = (weakref.ref(scene), packed, tables)
    return packed, tables


# ------------------------------------------------------------ kernel params
class RenderParams(ctypes.Structure):
    """Runtime arguments of the render kernel; mirrors ``RenderParams`` in
    csrc/render_kernel.cu field for field (all 4-byte fields, no padding)."""

    _fields_ = [
        ("center", ctypes.c_float * 3),
        ("pixel00", ctypes.c_float * 3),
        ("delta_u", ctypes.c_float * 3),
        ("delta_v", ctypes.c_float * 3),
        ("disk_u", ctypes.c_float * 3),
        ("disk_v", ctypes.c_float * 3),
        ("background", ctypes.c_float * 3),
        ("has_defocus", ctypes.c_int),
        ("width", ctypes.c_int),
        ("height", ctypes.c_int),
        ("spp", ctypes.c_int),
        ("max_depth", ctypes.c_int),
        ("n_spheres", ctypes.c_int),
        ("n_quads", ctypes.c_int),
        ("n_media", ctypes.c_int),
        ("seed", ctypes.c_int),
        ("pixel_base", ctypes.c_int),
        ("pixel_count", ctypes.c_int),
        ("sample_offset", ctypes.c_int),
        ("has_noise", ctypes.c_int),
        ("has_image", ctypes.c_int),
        ("img_h", ctypes.c_int),
        ("img_w", ctypes.c_int),
        ("use_bvh", ctypes.c_int),
        ("n_nodes", ctypes.c_int),
    ]


def make_params(camera, packed: PackedScene, seed: int, spp: int,
                max_depth: int, sample_offset: int = 0, pixel_base: int = 0,
                pixel_count: Optional[int] = None) -> RenderParams:
    """Camera constants rounded from f64 to f32, counts and the runtime
    scalars. ``seed`` is reduced to its low 32 bits and carried as int32."""
    w, h = camera.image_width, camera.image_height
    if pixel_count is None:
        pixel_count = w * h - pixel_base
    if not (0 <= pixel_base and pixel_count >= 1
            and pixel_base + pixel_count <= w * h):
        raise ValueError(f"pixel range [{pixel_base}, {pixel_base}+"
                         f"{pixel_count}) outside the {w}x{h} frame")
    if spp < 1:
        raise ValueError(f"spp must be >= 1, got {spp}")
    f3 = lambda a: (ctypes.c_float * 3)(*[float(x) for x in np.asarray(a)])
    return RenderParams(
        center=f3(camera.center), pixel00=f3(camera.pixel00_loc),
        delta_u=f3(camera.pixel_delta_u), delta_v=f3(camera.pixel_delta_v),
        disk_u=f3(camera.defocus_disk_u), disk_v=f3(camera.defocus_disk_v),
        background=f3(camera.background),
        has_defocus=int(camera.defocus_angle > 0.0),
        width=w, height=h, spp=int(spp), max_depth=int(max_depth),
        n_spheres=packed.n_spheres, n_quads=packed.n_quads,
        n_media=packed.n_media, seed=hashrng._i32(int(seed)),
        pixel_base=int(pixel_base), pixel_count=int(pixel_count),
        sample_offset=int(sample_offset), has_noise=int(packed.has_noise),
        has_image=int(packed.has_image), img_h=packed.img_h,
        img_w=packed.img_w, use_bvh=int(packed.use_bvh),
        n_nodes=packed.n_nodes)


def search_params(packed: PackedScene, seed: int) -> RenderParams:
    """The runtime arguments the hit kernel reads: primitive counts, the
    seed (low 32 bits, as int32) and the tree's. Camera and frame fields are
    unused there and hold a 1x1 frame."""
    return RenderParams(
        width=1, height=1, spp=1, max_depth=1, pixel_count=1,
        n_spheres=packed.n_spheres, n_quads=packed.n_quads,
        n_media=packed.n_media, seed=hashrng._i32(int(seed)),
        img_h=packed.img_h, img_w=packed.img_w,
        use_bvh=int(packed.use_bvh), n_nodes=packed.n_nodes)


# table -> (dtype, trailing shape, the count in RenderParams it must cover)
_TABLE_SPEC = {
    "sph_f": (torch.float32, (SPH_F,), "n_spheres"),
    "sph_m": (torch.int32, (), "n_spheres"),
    "quad_f": (torch.float32, (QUAD_F,), "n_quads"),
    "quad_m": (torch.int32, (), "n_quads"),
    "med_f": (torch.float32, (MED_F,), "n_media"),
    "med_i": (torch.int32, (2,), "n_media"),
    "mat_f": (torch.float32, (5,), None),
    "mat_i": (torch.int32, (2,), None),
    "tex_f": (torch.float32, (4,), None),
    "tex_i": (torch.int32, (3,), None),
    "wbvh": (torch.int32, (4,), None),
    "wsph_f": (torch.float32, (SPH_F,), None),
    "wsph_i": (torch.int32, (), None),
    "wquad_f": (torch.float32, (QUAD_F,), None),
    "wquad_i": (torch.int32, (), None),
}


def _check_tables(tables: dict, p: RenderParams) -> torch.device:
    """Device, dtype, shape and contiguity of the tables a kernel is about to
    read through raw pointers; returns their common device."""
    dev = tables["sph_f"].device
    for name in PackedScene.TABLES:
        dtype, tail, count = _TABLE_SPEC[name]
        t = tables[name]
        if t.device != dev:
            raise ValueError(f"table {name} on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"table {name} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"table {name} is not contiguous")
        rows = max(1, getattr(p, count)) if count else 1
        if tuple(t.shape[1:]) != tail or t.shape[0] < rows:
            raise ValueError(f"table {name} has shape {tuple(t.shape)}, "
                             f"expected (>={rows}, *{tail})")
    return dev


def _check_image(tables: dict, p: RenderParams, dev) -> torch.Tensor:
    """The render kernel's image table: f32 ``(3, img_h, img_w)``."""
    img = tables["img_f"]
    if (img.device != dev or img.dtype != torch.float32
            or not img.is_contiguous()
            or tuple(img.shape) != (3, p.img_h, p.img_w)):
        raise ValueError(f"table img_f is {tuple(img.shape)} {img.dtype} on "
                         f"{img.device}, expected contiguous f32 "
                         f"(3, {p.img_h}, {p.img_w}) on {dev}")
    return img


class RenderPlan(ctypes.Structure):
    """How the render kernel is launched; mirrors ``RenderPlan`` in
    csrc/render_kernel.cu. ``group``: threads a pixel. ``stage_bytes``: 0,
    or the shared memory a block of the brute loop stages the scene tables
    in, with ``mat_rows`` and ``tex_rows`` rows of the material and texture
    tables."""

    _fields_ = [("group", ctypes.c_int), ("stage_bytes", ctypes.c_int),
                ("mat_rows", ctypes.c_int), ("tex_rows", ctypes.c_int)]


def samples_per_group(spp: int) -> int:
    """Threads that trace one pixel's samples together, a round of one
    sample each at a time: the largest power of two up to RENDER_MAX_GROUP
    whose last round leaves at most an eighth of ``spp`` lanes idle (1 when
    none does: one thread a pixel)."""
    g = RENDER_MAX_GROUP
    while g > 1 and -(-spp // g) * g - spp > spp / 8:
        g //= 2
    return g


def stage_bytes(tables: dict, p: RenderParams) -> int:
    """Shared memory the brute-loop render kernel needs to stage the scene
    tables it loops over: each table's rows (``_STAGED_ROWS``) at a 16-byte
    boundary, the kernel's layout."""
    total = 0
    for _, row, count in _STAGED_ROWS:
        rows = getattr(p, count) if count.startswith("n_") \
            else tables[count].shape[0]
        total += -(-rows * row // 16) * 16
    return total


def render_plan(tables: dict, p: RenderParams) -> RenderPlan:
    """The render kernel's launch for these tables and params: the group
    from ``p.spp``; the tables staged in shared memory when the brute loop
    reads them and they fit STAGE_BUDGET_BYTES, else read from global
    memory (the BVH walk's always)."""
    mat_rows, tex_rows = tables["mat_f"].shape[0], tables["tex_f"].shape[0]
    if (tables["mat_i"].shape[0] != mat_rows
            or tables["tex_i"].shape[0] != tex_rows):
        raise ValueError("material or texture tables disagree in rows")
    nbytes = stage_bytes(tables, p)
    staged = not p.use_bvh and nbytes <= STAGE_BUDGET_BYTES
    return RenderPlan(group=samples_per_group(p.spp),
                      stage_bytes=nbytes if staged else 0,
                      mat_rows=mat_rows, tex_rows=tex_rows)


class RecordPlan(ctypes.Structure):
    """How the recorder is launched; mirrors ``RecordPlan`` in
    csrc/render_kernel.cu. ``blocks`` of RECORD_THREADS threads (the launch
    refuses a count other than its own); ``stage_bytes``, ``mat_rows``,
    ``tex_rows`` as for ``RenderPlan``."""

    _fields_ = [("blocks", ctypes.c_int), ("stage_bytes", ctypes.c_int),
                ("mat_rows", ctypes.c_int), ("tex_rows", ctypes.c_int)]


def record_plan(tables: dict, p: RenderParams) -> RecordPlan:
    """The recorder's launch for these tables and params: one thread a
    (pixel, sample) of the pixel range (``record_threads``), the tables
    staged as ``render_plan`` stages them."""
    warps = -(-p.pixel_count // 32) * p.spp
    rp = render_plan(tables, p)
    return RecordPlan(blocks=-(-warps * 32 // RECORD_THREADS),
                      stage_bytes=rp.stage_bytes, mat_rows=rp.mat_rows,
                      tex_rows=rp.tex_rows)


def record_threads(plan: RecordPlan, p: RenderParams):
    """The recorder's thread map, as ``record_kernel`` computes it: for each
    thread of the grid, the local pixel and the sample it traces (warp g:
    sample g % spp of pixels 32 (g // spp) + lane), and whether that pixel
    lies in the range (else the thread exits). Returns (local, sample,
    live) int64/bool arrays of blocks x RECORD_THREADS."""
    t = np.arange(plan.blocks * RECORD_THREADS, dtype=np.int64)
    warp = t >> 5
    local = (warp // p.spp) * 32 + (t & 31)
    return local, warp % p.spp, local < p.pixel_count


def render_occupancy(p: RenderParams, plan: RenderPlan) -> dict:
    """The card's resources for the render kernel's instantiation that
    ``p`` and ``plan`` pick: blocks an SM holds, registers and local memory
    (spills and stack) a thread. Needs the kernel library (a card)."""
    from ..runtime import kernels

    out = (ctypes.c_int * 4)()
    kernels.check(kernels.load().rt_render_occupancy(
        p.has_noise, p.has_image, p.use_bvh, plan.stage_bytes, out),
        "render occupancy")
    return dict(blocks_per_sm=out[0], registers=out[1], local_bytes=out[2],
                threads=out[3], group=plan.group,
                stage_bytes=plan.stage_bytes)


def search_occupancy(kernel: str, use_bvh: bool,
                     stage_bytes: int = 0) -> dict:
    """The card's resources for ``record_kernel`` (with ``stage_bytes`` > 0
    its staged brute loop, at that much shared memory) or ``hit_kernel``,
    with or without the BVH walk: blocks an SM holds, registers and local
    memory a thread, threads a block. Needs the kernel library (a card)."""
    from ..runtime import kernels

    out = (ctypes.c_int * 4)()
    which = {"record_kernel": 1, "hit_kernel": 2}[kernel]
    kernels.check(kernels.load().rt_search_occupancy(
        which, int(use_bvh), stage_bytes, out), f"{kernel} occupancy")
    return dict(blocks_per_sm=out[0], registers=out[1], local_bytes=out[2],
                threads=out[3], stage_bytes=stage_bytes)


def _counter_ptr(counters: Optional[torch.Tensor], rows: int, dev) -> int:
    """Pointer of a walk-counter buffer ((rows, 3) int32 on ``dev``), or 0."""
    if counters is None:
        return 0
    if (counters.device != dev or counters.dtype != torch.int32
            or not counters.is_contiguous()
            or tuple(counters.shape) != (rows, 3)):
        raise ValueError(f"counters are {tuple(counters.shape)} "
                         f"{counters.dtype} on {counters.device}, expected "
                         f"contiguous int32 ({rows}, 3) on {dev}")
    return counters.data_ptr()


def render_kernel(tables: dict, p: RenderParams,
                  counters: Optional[torch.Tensor] = None,
                  plan: Optional[RenderPlan] = None):
    """One launch of the CUDA render kernel over pixels
    ``[p.pixel_base, p.pixel_base + p.pixel_count)``.

    ``tables`` are the packed scene tables (and the image table ``img_f``)
    as contiguous CUDA tensors; ``p.has_noise``, ``p.has_image`` and
    ``p.use_bvh`` select the kernel's instantiation. With ``p.use_bvh``,
    ``counters`` ((pixel_count, 3) int32, optional) receives each pixel's
    BVH node visits, sphere tests and quad tests; it changes no result.
    Returns ``(rgb (count,3) f32, n (count,) i32)``: the per-pixel mean
    radiance over ``p.spp`` samples and the number of scene queries traced.
    ``plan`` (default ``render_plan(tables, p)``) sets the threads a pixel
    and whether the tables are staged in shared memory; it changes no
    result. Launches on the current stream and does not synchronise.
    Tensors that are not on a CUDA device are refused: the caller picks the
    plain version for those."""
    dev = _check_tables(tables, p)
    if dev.type != "cuda":
        raise ValueError(f"render_kernel needs CUDA tensors, got {dev}")
    img = _check_image(tables, p, dev)
    cnt = _counter_ptr(counters, p.pixel_count, dev)
    plan = plan or render_plan(tables, p)
    from ..runtime import kernels

    lib = kernels.load()
    with torch.cuda.device(dev):
        rgb = torch.empty((p.pixel_count, 3), dtype=torch.float32, device=dev)
        n = torch.empty((p.pixel_count,), dtype=torch.int32, device=dev)
        err = lib.rt_render_launch(
            *[tables[name].data_ptr() for name in PackedScene.TABLES],
            img.data_ptr(), ctypes.byref(p), ctypes.byref(plan),
            rgb.data_ptr(), n.data_ptr(), cnt,
            torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["render_kernel"] += 1
    kernels.check(err, "render kernel")
    return rgb, n


def record_kernel(tables: dict, p: RenderParams,
                  counters: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of the CUDA path recorder over the pixel range of ``p``
    (``p.use_bvh`` picks the BVH walk; ``record_plan`` the launch). With
    ``p.use_bvh``, ``counters`` ((pixel_count, 3) int32, optional) is set to
    each pixel's BVH node visits, sphere tests and quad tests summed over
    its samples.

    Returns ``(p.max_depth, p.spp, p.pixel_count)`` int32 packed winner
    records (``kind<<24 | idx``; 0 for a miss or a dead path), depth-major.
    Launches on the current stream and does not synchronise. Tensors that are
    not on a CUDA device are refused."""
    dev = _check_tables(tables, p)
    if dev.type != "cuda":
        raise ValueError(f"record_kernel needs CUDA tensors, got {dev}")
    if p.max_depth < 1:
        raise ValueError(f"max_depth must be >= 1, got {p.max_depth}")
    cnt = _counter_ptr(counters, p.pixel_count, dev)
    if counters is not None:
        counters.zero_()  # the kernel adds each sample's counts
    plan = record_plan(tables, p)
    from ..runtime import kernels

    lib = kernels.load()
    with torch.cuda.device(dev):
        rec = torch.empty((p.max_depth, p.spp, p.pixel_count),
                          dtype=torch.int32, device=dev)
        err = lib.rt_record_launch(
            *[tables[name].data_ptr() for name in PackedScene.TABLES],
            ctypes.byref(p), ctypes.byref(plan), rec.data_ptr(), cnt,
            torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["record_kernel"] += 1
    kernels.check(err, "record kernel")
    return rec


_LANE_DTYPES = (torch.float32,) * 7 + (torch.int32, torch.int32, torch.bool)
_LANE_NAMES = ("ox", "oy", "oz", "dx", "dy", "dz", "time", "pix", "samp",
               "alive")


def _check_lanes(lanes, dev) -> int:
    """The hit search's ten (n,) lane tensors: f32 ray, int32 pixel and
    sample ids, bool alive, contiguous, on ``dev``. Returns n."""
    n = lanes[0].shape[0] if lanes[0].dim() == 1 else -1
    for name, t, dt in zip(_LANE_NAMES, lanes, _LANE_DTYPES):
        if (t.device != dev or t.dtype != dt or t.dim() != 1
                or t.shape[0] != n or not t.is_contiguous()):
            raise ValueError(f"lane {name} is {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, expected contiguous {dt} ({n},) "
                             f"on {dev}")
    return n


def hit_kernel(tables: dict, p: RenderParams, ox, oy, oz, dx, dy, dz, time,
               pix, samp, alive, bounce: int,
               counters: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of the CUDA hit kernel (one bounce's closest hit over
    supplied rays, media included; ``p.use_bvh`` picks the BVH walk).

    The lanes are (n,) tensors: ray origin, direction and time f32, pixel
    and sample ids int32 (they address the medium draws with ``p.seed`` and
    ``bounce``), ``alive`` bool. Returns (n,) int32 winner records
    ``kind<<24 | idx``, 0 for a miss or a dead lane. ``counters`` as for
    ``render_kernel``, one row a lane. Launches on the current stream and
    does not synchronise. Tensors that are not on a CUDA device are
    refused."""
    dev = _check_tables(tables, p)
    if dev.type != "cuda":
        raise ValueError(f"hit_kernel needs CUDA tensors, got {dev}")
    lanes = (ox, oy, oz, dx, dy, dz, time, pix, samp, alive)
    n = _check_lanes(lanes, dev)
    if n < 1:
        raise ValueError("hit_kernel needs at least one lane")
    cnt = _counter_ptr(counters, n, dev)
    from ..runtime import kernels

    lib = kernels.load()
    with torch.cuda.device(dev):
        out = torch.empty((n,), dtype=torch.int32, device=dev)
        err = lib.rt_hit_launch(
            *[tables[name].data_ptr() for name in PackedScene.TABLES],
            ctypes.byref(p), *[t.data_ptr() for t in lanes], n, int(bounce),
            out.data_ptr(), cnt, torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["hit_kernel"] += 1
    kernels.check(err, "hit kernel")
    return out


# ----------------------------------------------------------- plain version
def _sel3(cond, a, b):
    return tuple(torch.where(cond, x, y) for x, y in zip(a, b))


def _f32(v: float) -> float:
    """A Python float rounded to the nearest f32 value."""
    return float(np.float32(v))


def _hash_grad(hx, hy, hz, salt: int):
    """Lattice gradient in [-1,1]^3 from integer corner coordinates
    (megakernel.py:448-464): the RNG's mixer on a hash of the corner, uint32
    arithmetic emulated in int32 as in ops/hashrng.py."""
    i32 = hashrng._i32
    h = (hx * i32(0x9E3779B1) + hy * i32(0x85EBCA77) + hz * i32(0xC2B2AE3D)
         + i32(salt))
    unit = hashrng._bits_to_unit_float
    gx = 2.0 * unit(hashrng._mix(h)) - 1.0
    gy = 2.0 * unit(hashrng._mix(h + i32(0x01000193))) - 1.0
    gz = 2.0 * unit(hashrng._mix(h + i32(0x02000193 & 0xFFFFFFFF))) - 1.0
    return gx, gy, gz


def _noise(px, py, pz):
    """Hash-lattice Perlin gradient noise (megakernel.py:467-491)."""
    fx, fy, fz = torch.floor(px), torch.floor(py), torch.floor(pz)
    ux, uy, uz = px - fx, py - fy, pz - fz
    sx = ux * ux * (3.0 - 2.0 * ux)
    sy = uy * uy * (3.0 - 2.0 * uy)
    sz = uz * uz * (3.0 - 2.0 * uz)
    ix, iy, iz = fx.to(torch.int32), fy.to(torch.int32), fz.to(torch.int32)
    acc = torch.zeros_like(px)
    for di in (0, 1):
        wx = sx if di else 1.0 - sx
        for dj in (0, 1):
            wy = sy if dj else 1.0 - sy
            for dk in (0, 1):
                wz = sz if dk else 1.0 - sz
                gx, gy, gz = _hash_grad(ix + di, iy + dj, iz + dk, NOISE_SALT)
                dot = gx * (ux - di) + gy * (uy - dj) + gz * (uz - dk)
                acc = acc + wx * wy * wz * dot
    return acc


def _turbulence(px, py, pz, depth: int = 7):
    """perlin.rs:52-64 over the hash lattice: |sum of w^k noise(2^k p)|."""
    acc = torch.zeros_like(px)
    w = 1.0
    s = 1.0
    for _ in range(depth):
        acc = acc + w * _noise(px * s, py * s, pz * s)
        w *= 0.5
        s *= 2.0
    return torch.abs(acc)


def _poly(coefs, x):
    p = torch.full_like(x, _f32(coefs[0]))
    for c in coefs[1:]:
        p = p * x + _f32(c)
    return p


def _atan_poly(r):
    """atan(r) for r in [0, 1]: odd polynomial in r^2 (megakernel.py:404-
    416)."""
    return _poly(_ATAN_COEF, r * r) * r


def _atan2(y, x):
    """atan2 from the [0, 1] core (megakernel.py:419-429)."""
    ax, ay = x.abs(), y.abs()
    mx, mn = torch.maximum(ax, ay), torch.minimum(ax, ay)
    a = _atan_poly(mn / torch.clamp(mx, min=1e-30))
    a = torch.where(ay > ax, _f32(_PI / 2) - a, a)
    a = torch.where(x < 0.0, _f32(_PI) - a, a)
    return torch.where(y < 0.0, -a, a)


def _arccos(x):
    """acos(x), Abramowitz-Stegun 4.4.45 (megakernel.py:432-444)."""
    xa = torch.clamp(x, -1.0, 1.0).abs()
    a = _poly(_ACOS_COEF, xa) * torch.sqrt(torch.clamp(1.0 - xa, min=0.0))
    return torch.where(x < 0.0, _f32(_PI) - a, a)


def render_fast_plain(tables: dict, p: RenderParams):
    """Plain PyTorch version of ``render_kernel``: same inputs, same two
    outputs, as tensor code over all pixels of the range at once. A Python
    loop over samples and bounces; every primitive tested for every lane
    (``_closest_surface``, whatever ``p.use_bvh`` says); the same media,
    scatter and texture arithmetic, written with the same operations in the
    same order (explicit multiply-adds, no matmul, no pow, no fused
    multiply-add)."""
    return _trace_plain(tables, p, record=False)


def record_paths_plain(tables: dict, p: RenderParams) -> torch.Tensor:
    """Plain PyTorch version of ``record_kernel``: the same trace as
    ``render_fast_plain`` (one shared program), returning the
    ``(max_depth, spp, pixel_count)`` int32 winner records instead of
    radiance."""
    if p.max_depth < 1:
        raise ValueError(f"max_depth must be >= 1, got {p.max_depth}")
    return _trace_plain(tables, p, record=True)


def record_walk_plain(tables: dict, p: RenderParams) -> np.ndarray:
    """Plain version of ``record_kernel``'s walk counters: the paths of
    ``record_paths_plain``, each live bounce's ray walked by
    ``walk_wide_plain``, summed per pixel over samples and bounces. Returns
    (pixel_count, 3) int64: node boxes, spheres and quads tested."""
    host = {k: tables[k].cpu() for k in ("wbvh", "wsph_f", "wsph_i",
                                         "wquad_f", "wquad_i")}
    counts = np.zeros((p.pixel_count, 3), dtype=np.int64)

    def walk(o, d, rtime, alive):
        live = alive.nonzero()[:, 0]
        if live.numel():
            _, _, c = walk_wide_plain(
                host, *[x[live].cpu() for x in (*o, *d, rtime)])
            np.add.at(counts, live.cpu().numpy(), c)

    _trace_plain(tables, p, record=True, on_bounce=walk)
    return counts


def _sphere_t(sph, ox, oy, oz, dx, dy, dz, rtime, a_len, inv_a):
    """t of every (lane, sphere) pair, inf where the ray misses (sphere.rs:
    59-89 + the moving-centre lerp; strict bounds, near root first): the
    kernel's sphere test, broadcast over ``sph`` rows (S,8) and (L,1) lanes.
    A root counts against an open window (T_MIN, inf), so each sphere's t
    does not depend on the primitives tested before it."""
    col = lambda k: sph[:, k]
    ccx = col(0) + col(5) * rtime
    ccy = col(1) + col(6) * rtime
    ccz = col(2) + col(7) * rtime
    ocx, ocy, ocz = ox - ccx, oy - ccy, oz - ccz
    half_b = ocx * dx + ocy * dy + ocz * dz
    c = ocx * ocx + ocy * ocy + ocz * ocz - col(3)
    disc = half_b * half_b - a_len * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    r1 = (-half_b - sq) * inv_a
    rr2 = (-half_b + sq) * inv_a
    ok1 = (r1 > T_MIN) & (r1 < math.inf)
    ok2 = (rr2 > T_MIN) & (rr2 < math.inf)
    root = torch.where(ok1, r1, rr2)
    return torch.where((disc > 0.0) & (ok1 | ok2), root, math.inf)


def _quad_t(quad, ox, oy, oz, dx, dy, dz):
    """t of every (lane, quad) pair, inf where the ray misses (quad.rs:
    96-133: inclusive bounds, no back-face culling), as the kernel's quad
    test computes it."""
    col = lambda k: quad[:, k]
    nx, ny, nz = col(9), col(10), col(11)
    denom = nx * dx + ny * dy + nz * dz
    safe = torch.where(denom.abs() < 1e-30, 1e-30, denom)
    t = (col(15) - (nx * ox + ny * oy + nz * oz)) / safe
    hx = ox + t * dx - col(0)
    hy = oy + t * dy - col(1)
    hz = oz + t * dz - col(2)
    ux, uy, uz = col(3), col(4), col(5)
    vx, vy, vz = col(6), col(7), col(8)
    wx, wy, wz = col(12), col(13), col(14)
    alpha = (wx * (hy * vz - hz * vy) + wy * (hz * vx - hx * vz)
             + wz * (hx * vy - hy * vx))
    beta = (wx * (uy * hz - uz * hy) + wy * (uz * hx - ux * hz)
            + wz * (ux * hy - uy * hx))
    hit = ((denom.abs() >= QUAD_DENOM_EPS)
           & (t >= T_MIN) & (t < math.inf)
           & (alpha >= 0.0) & (alpha <= 1.0)
           & (beta >= 0.0) & (beta <= 1.0))
    return torch.where(hit, t, math.inf)


def _closest_surface(tables: dict, p: RenderParams, ox, oy, oz, dx, dy, dz,
                     rtime, alive):
    """Closest sphere or quad of every lane, testing every primitive: the
    plain version of the kernels' search, brute loop and BVH walk alike.

    The winner is the first minimum in (t, kind, idx) order, spheres before
    quads, index order inside each kind. That is the brute loop's winner
    (spheres then quads, accepting only ``t < t_best``: each primitive's t
    comes from the same f32 operations whatever was tested before it) and
    the BVH walk's (its tie rule). Lanes go in chunks of ``SEARCH_CHUNK``
    lanes x primitives.

    Returns (t_best, mat, nx, ny, nz, rec, a_len, inv_a): t_best is inf on a
    miss and T_MIN on a dead lane (the media test then finds nothing); mat
    and rec (kind<<24 | idx) are int64; the normal is outward, (0, 0, 1) on
    a miss."""
    a_len = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / torch.clamp(a_len, min=1e-30)
    R, dev = ox.shape[0], ox.device
    S, Q = p.n_spheres, p.n_quads
    sph, quad = tables["sph_f"], tables["quad_f"]
    t_win = torch.full((R,), math.inf, dtype=torch.float32, device=dev)
    j_win = torch.zeros(R, dtype=torch.int64, device=dev)
    step = max(1, SEARCH_CHUNK // max(S + Q, 1))
    for l0 in range(0, R if S + Q else 0, step):
        sl = slice(l0, l0 + step)
        lane = [v[sl, None] for v in (ox, oy, oz, dx, dy, dz)]
        parts = []
        if S:
            parts.append(_sphere_t(sph[:S], *lane, rtime[sl, None],
                                   a_len[sl, None], inv_a[sl, None]))
        if Q:
            parts.append(_quad_t(quad[:Q], *lane))
        t = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        j = torch.argmin(t, dim=1)  # the first minimum
        t_win[sl] = t.gather(1, j[:, None])[:, 0]
        j_win[sl] = j
    hit = torch.isfinite(t_win) & alive
    t_best = torch.where(hit, t_win,
                         torch.where(alive, math.inf, T_MIN).to(torch.float32))
    is_sph = hit & (j_win < S)
    is_quad = hit & (j_win >= S)
    # the winner's normal and material, from its own row with the kernel's
    # operations
    si = torch.where(is_sph, j_win, 0)
    qi = torch.where(is_quad, j_win - S, 0)
    srow, qrow = sph[si], quad[qi]
    root = torch.where(is_sph, t_win, 0.0)
    ccx = srow[:, 0] + srow[:, 5] * rtime
    ccy = srow[:, 1] + srow[:, 6] * rtime
    ccz = srow[:, 2] + srow[:, 7] * rtime
    zero = torch.zeros_like(ox)
    nx = torch.where(is_sph, (ox + root * dx - ccx) * srow[:, 4],
                     torch.where(is_quad, qrow[:, 9], zero))
    ny = torch.where(is_sph, (oy + root * dy - ccy) * srow[:, 4],
                     torch.where(is_quad, qrow[:, 10], zero))
    nz = torch.where(is_sph, (oz + root * dz - ccz) * srow[:, 4],
                     torch.where(is_quad, qrow[:, 11], zero + 1.0))
    mat = torch.where(is_sph, tables["sph_m"][si].long(),
                      torch.where(is_quad, tables["quad_m"][qi].long(), 0))
    rec = torch.where(is_sph, (1 << 24) | si,
                      torch.where(is_quad, (2 << 24) | qi, 0))
    return t_best, mat, nx, ny, nz, rec, a_len, inv_a


def _media_rows(tables: dict, p: RenderParams):
    """(row as floats, type, material) of every packed medium, on the
    host."""
    med_f = tables["med_f"].detach().cpu().numpy()
    med_i = tables["med_i"].detach().cpu().numpy()
    return [([float(x) for x in med_f[i]], int(med_i[i, 0]), int(med_i[i, 1]))
            for i in range(p.n_media)]


def _media(media, ox, oy, oz, dx, dy, dz, a_len, inv_a, rngb, t_best, w_mat,
           w_rec):
    """Constant media (constant_medium.rs:34-71) after the surface search:
    boundary entry and exit in closed form, exponential free flight from
    draw ``SITE_MEDIUM + i``. A medium wins only where its scatter point is
    nearer than the winner so far. Returns (t_best, mat, rec, is_med)."""
    w_is_med = torch.zeros(ox.shape, dtype=torch.bool, device=ox.device)
    fzero = torch.zeros_like(ox)
    for i, (m, kind, mat) in enumerate(media):
        if kind == MED_BOX:
            rx, ry, rz = ox - m[9], oy - m[10], oz - m[11]
            lo_ = (m[0] * rx + m[1] * ry + m[2] * rz,
                   m[3] * rx + m[4] * ry + m[5] * rz,
                   m[6] * rx + m[7] * ry + m[8] * rz)
            ld_ = (m[0] * dx + m[1] * dy + m[2] * dz,
                   m[3] * dx + m[4] * dy + m[5] * dz,
                   m[6] * dx + m[7] * dy + m[8] * dz)
            entry = fzero - float("inf")
            exit_ = fzero + float("inf")
            for ax in range(3):
                oo, dd2 = lo_[ax], ld_[ax]
                invd = 1.0 / torch.where(dd2.abs() < 1e-30, 1e-30, dd2)
                t0 = (m[12 + ax] - oo) * invd
                t1 = (m[15 + ax] - oo) * invd
                entry = torch.maximum(entry, torch.minimum(t0, t1))
                exit_ = torch.minimum(exit_, torch.maximum(t0, t1))
            okb = entry < exit_
        else:
            ocx, ocy, ocz = ox - m[18], oy - m[19], oz - m[20]
            half_b = ocx * dx + ocy * dy + ocz * dz
            c = ocx * ocx + ocy * ocy + ocz * ocz - m[21]
            disc = half_b * half_b - a_len * c
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            entry = (-half_b - sq) * inv_a
            exit_ = (-half_b + sq) * inv_a
            okb = disc > 0.0
        entry = torch.clamp(entry, min=T_MIN)
        exit_ = torch.minimum(exit_, t_best)
        okb = okb & (entry < exit_)
        ray_len = torch.sqrt(a_len)
        dist_in = (exit_ - entry) * ray_len
        u = torch.clamp(rngb.uniform(hashrng.SITE_MEDIUM + i), min=1e-12)
        hd = m[22] * torch.log(u)
        okb = okb & (hd <= dist_in)
        t_m = entry + hd / ray_len
        hit = okb & (t_m < t_best)
        t_best = torch.where(hit, t_m, t_best)
        w_mat = torch.where(hit, mat, w_mat)
        w_rec = torch.where(hit, (3 + i) << 24, w_rec)
        w_is_med = w_is_med | hit
    return t_best, w_mat, w_rec, w_is_med


def hit_records_plain(tables: dict, p: RenderParams, ox, oy, oz, dx, dy, dz,
                      time, pix, samp, alive, bounce: int) -> torch.Tensor:
    """Plain PyTorch version of ``hit_kernel``: one bounce of the plain
    trace in record mode over the given lanes. Returns (n,) int32 records,
    0 for a miss or a dead lane."""
    _check_tables(tables, p)
    rngb = CounterRng(p.seed, pix, samp, int(bounce))
    t_best, w_mat, _, _, _, w_rec, a_len, inv_a = _closest_surface(
        tables, p, ox, oy, oz, dx, dy, dz, time, alive)
    t_best, _, w_rec, _ = _media(_media_rows(tables, p), ox, oy, oz, dx, dy,
                                 dz, a_len, inv_a, rngb, t_best, w_mat, w_rec)
    return torch.where(torch.isfinite(t_best) & alive, w_rec,
                       0).to(torch.int32)


def _trace_plain(tables: dict, p: RenderParams, record: bool,
                 on_bounce=None):
    dev = _check_tables(tables, p)
    media = _media_rows(tables, p)
    mat_f, tex_f = tables["mat_f"], tables["tex_f"]
    mat_i, tex_i = tables["mat_i"].long(), tables["tex_i"].long()
    has_checker = bool((tex_i[:, 0] == TEX_CHECKER).any())
    # the recorder shades nothing, so it never evaluates noise or images
    has_noise = bool(p.has_noise) and not record
    has_image = bool(p.has_image) and not record
    if has_image:
        img = _check_image(tables, p, dev).reshape(3, -1)
        n_texels = p.img_h * p.img_w

    f32 = lambda v: float(np.float32(v))
    cx, cy, cz = (f32(v) for v in p.center)
    p00x, p00y, p00z = (f32(v) for v in p.pixel00)
    dux, duy, duz = (f32(v) for v in p.delta_u)
    dvx, dvy, dvz = (f32(v) for v in p.delta_v)
    ddux, dduy, dduz = (f32(v) for v in p.disk_u)
    ddvx, ddvy, ddvz = (f32(v) for v in p.disk_v)
    bg_r, bg_g, bg_b = (f32(v) for v in p.background)
    seed, max_depth = p.seed, p.max_depth

    P = p.pixel_count
    pid = torch.arange(p.pixel_base, p.pixel_base + P, dtype=torch.int32,
                       device=dev)
    pi = (pid % p.width).to(torch.float32)
    pj = torch.div(pid, p.width, rounding_mode="floor").to(torch.float32)
    fzero = torch.zeros(P, dtype=torch.float32, device=dev)

    def tex_value(tid, hpx, hpy, hpz, tex_u, tex_v):
        turb = []  # the hash turbulence at p, computed once per bounce

        def leaf(t):
            r, g, b = tex_f[t, 0], tex_f[t, 1], tex_f[t, 2]
            if has_noise:
                # marble: sin(scale*z + 10*turb(p,7))*0.5+0.5
                # (texture.rs:107-111)
                if not turb:
                    turb.append(_turbulence(hpx, hpy, hpz))
                marble = (torch.sin(tex_f[t, 3] * hpz + 10.0 * turb[0])
                          * 0.5 + 0.5)
                is_noise = tex_i[t, 0] == TEX_NOISE
                r = torch.where(is_noise, marble, r)
                g = torch.where(is_noise, marble, g)
                b = torch.where(is_noise, marble, b)
            if has_image:
                # nearest texel of the mip, u clamp, v flip
                # (texture.rs:83-93); out-of-range rows read 0
                uc = torch.clamp(tex_u, 0.0, 1.0)
                vc = 1.0 - torch.clamp(tex_v, 0.0, 1.0)
                ti = (uc * (p.img_w - 1)).to(torch.int32)
                tj = (vc * (p.img_h - 1)).to(torch.int32)
                lin = tj * p.img_w + ti
                ok = (lin >= 0) & (lin < n_texels)
                texel = torch.where(
                    ok, img[:, lin.clamp(0, n_texels - 1).long()], 0.0)
                is_img = tex_i[t, 0] == TEX_IMAGE
                r = torch.where(is_img, texel[0], r)
                g = torch.where(is_img, texel[1], g)
                b = torch.where(is_img, texel[2], b)
            return r, g, b

        r, g, b = leaf(tid)
        if has_checker:
            inv = tex_f[tid, 3]
            fsum = (torch.floor(inv * hpx) + torch.floor(inv * hpy)
                    + torch.floor(inv * hpz))
            even_sel = torch.remainder(fsum, 2.0) == 0.0  # floored modulus
            child = torch.where(even_sel, tex_i[tid, 1], tex_i[tid, 2])
            cr, cg, cb = leaf(child)
            is_chk = tex_i[tid, 0] == TEX_CHECKER
            r = torch.where(is_chk, cr, r)
            g = torch.where(is_chk, cg, g)
            b = torch.where(is_chk, cb, b)
        return r, g, b

    def camera_ray(s_glob):
        rng = CounterRng(seed, pid, s_glob)
        jx = rng.uniform(hashrng.SITE_PIXEL_JX) - 0.5
        jy = rng.uniform(hashrng.SITE_PIXEL_JY) - 0.5
        sx = p00x + (pi + jx) * dux + (pj + jy) * dvx
        sy = p00y + (pi + jx) * duy + (pj + jy) * dvy
        sz = p00z + (pi + jx) * duz + (pj + jy) * dvz
        if p.has_defocus:
            ca, sa = rng.in_unit_disk(hashrng.SITE_DEFOCUS_R,
                                      hashrng.SITE_DEFOCUS_TH)
            nox = cx + ca * ddux + sa * ddvx
            noy = cy + ca * dduy + sa * ddvy
            noz = cz + ca * dduz + sa * ddvz
        else:
            nox, noy, noz = fzero + cx, fzero + cy, fzero + cz
        return (nox, noy, noz, sx - nox, sy - noy, sz - noz,
                rng.uniform(hashrng.SITE_TIME))

    def trace_bounce(o, d, rtime, tp, rad, alive, depth_left_ok, rngb):
        ox, oy, oz = o
        dx, dy, dz = d
        t_best, w_mat, w_nx, w_ny, w_nz, w_rec, a_len, inv_a = \
            _closest_surface(tables, p, ox, oy, oz, dx, dy, dz, rtime, alive)
        t_best, w_mat, w_rec, w_is_med = _media(
            media, ox, oy, oz, dx, dy, dz, a_len, inv_a, rngb, t_best, w_mat,
            w_rec)

        hit_any = torch.isfinite(t_best) & alive
        # the record is taken before the emitter and depth short-cuts
        rec = torch.where(hit_any, w_rec, 0).to(torch.int32)
        miss = alive & ~hit_any
        tp_r, tp_g, tp_b = tp
        rad_r, rad_g, rad_b = rad
        # background on miss (renderer.rs:152-154)
        rad_r = rad_r + torch.where(miss, tp_r * bg_r, 0.0)
        rad_g = rad_g + torch.where(miss, tp_g * bg_g, 0.0)
        rad_b = rad_b + torch.where(miss, tp_b * bg_b, 0.0)

        t_safe = torch.where(hit_any, t_best, 0.0)
        hpx = ox + t_safe * dx
        hpy = oy + t_safe * dy
        hpz = oz + t_safe * dz

        # flip normal toward the ray (hittable.rs:22-37); a medium's
        # "normal" is the ray direction -> front_face False
        mx = torch.where(w_is_med, dx, w_nx)
        my = torch.where(w_is_med, dy, w_ny)
        mz = torch.where(w_is_med, dz, w_nz)
        ndotd = torch.where(w_is_med, a_len,
                            w_nx * dx + w_ny * dy + w_nz * dz)
        front = ndotd < 0.0
        sign = torch.where(front, 1.0, -1.0)
        nx_, ny_, nz_ = sign * mx, sign * my, sign * mz

        m_type = mat_i[w_mat, 0]
        fuzz = mat_f[w_mat, 3]
        ir = mat_f[w_mat, 4]
        is_lam = m_type == LAMBERTIAN
        is_metal = m_type == METAL
        is_diel = m_type == DIELECTRIC
        is_light = m_type == DIFFUSE_LIGHT
        is_iso = m_type == ISOTROPIC

        m_tex = mat_i[w_mat, 1]
        al_r, al_g, al_b = mat_f[w_mat, 0], mat_f[w_mat, 1], mat_f[w_mat, 2]
        if has_image:
            # sphere UV from the outward normal (sphere.rs:48-52):
            # theta = acos(-n.y), phi = atan2(-n.z, n.x) + pi
            theta = _arccos(-w_ny)
            phi = _atan2(-w_nz, w_nx) + _f32(_PI)
            tex_u = phi * _f32(1.0 / (2.0 * _PI))
            tex_v = theta * _f32(1.0 / _PI)
        else:
            tex_u = tex_v = fzero
        tex_r, tex_g, tex_b = tex_value(m_tex, hpx, hpy, hpz, tex_u, tex_v)

        # emission (material.rs:114-122), pre-scatter throughput
        em = hit_any & is_light
        rad_r = rad_r + torch.where(em, tp_r * tex_r, 0.0)
        rad_g = rad_g + torch.where(em, tp_g * tex_g, 0.0)
        rad_b = rad_b + torch.where(em, tp_b * tex_b, 0.0)

        # scatter
        uvx, uvy, uvz = rngb.unit_vector(hashrng.SITE_SCATTER_Z,
                                         hashrng.SITE_SCATTER_PHI)
        inv_len = torch.rsqrt(torch.clamp(a_len, min=1e-30))
        udx, udy, udz = dx * inv_len, dy * inv_len, dz * inv_len

        # Lambertian: n + unit, near-zero fallback (material.rs:26-42)
        ldx_, ldy_, ldz_ = nx_ + uvx, ny_ + uvy, nz_ + uvz
        nz_fb = ((ldx_.abs() < 1e-8) & (ldy_.abs() < 1e-8)
                 & (ldz_.abs() < 1e-8))
        ldx_ = torch.where(nz_fb, nx_, ldx_)
        ldy_ = torch.where(nz_fb, ny_, ldy_)
        ldz_ = torch.where(nz_fb, nz_, ldz_)

        # Metal: mirror + fuzz ball (material.rs:53-64)
        fx, fy, fz = rngb.in_unit_sphere(hashrng.SITE_FUZZ_Z,
                                         hashrng.SITE_FUZZ_PHI,
                                         hashrng.SITE_FUZZ_R)
        rdot = udx * nx_ + udy * ny_ + udz * nz_
        mdx = udx - 2.0 * rdot * nx_ + fuzz * fx
        mdy = udy - 2.0 * rdot * ny_ + fuzz * fy
        mdz = udz - 2.0 * rdot * nz_ + fuzz * fz
        metal_ok = (mdx * nx_ + mdy * ny_ + mdz * nz_) > 0.0

        # Dielectric (material.rs:80-104). Integer powers are repeated
        # multiplication: x^2 = x*x, x^5 = x * ((x*x) * (x*x)).
        ratio = torch.where(front, 1.0 / ir, ir)
        cos_t = torch.clamp(-(udx * nx_ + udy * ny_ + udz * nz_), max=1.0)
        sin_sq = torch.clamp(1.0 - cos_t * cos_t, min=0.0)
        cannot = ratio * ratio * sin_sq > 1.0
        r0s = (1.0 - ratio) / (1.0 + ratio)
        r0 = r0s * r0s
        omc = 1.0 - cos_t
        omc2 = omc * omc
        refl = r0 + (1.0 - r0) * (omc * (omc2 * omc2))
        coin = rngb.uniform(hashrng.SITE_SCHLICK)
        do_refl = cannot | (refl > coin)
        rpx = ratio * (udx + cos_t * nx_)
        rpy = ratio * (udy + cos_t * ny_)
        rpz = ratio * (udz + cos_t * nz_)
        plen = torch.clamp(1.0 - (rpx * rpx + rpy * rpy + rpz * rpz), min=0.0)
        par = -torch.sqrt(plen)
        rfx, rfy, rfz = rpx + par * nx_, rpy + par * ny_, rpz + par * nz_
        rlx = udx - 2.0 * rdot * nx_
        rly = udy - 2.0 * rdot * ny_
        rlz = udz - 2.0 * rdot * nz_
        ddx = torch.where(do_refl, rlx, rfx)
        ddy = torch.where(do_refl, rly, rfy)
        ddz = torch.where(do_refl, rlz, rfz)

        lam_or_iso = is_lam | is_iso
        new_dx = torch.where(lam_or_iso, torch.where(is_iso, uvx, ldx_),
                             torch.where(is_metal, mdx, ddx))
        new_dy = torch.where(lam_or_iso, torch.where(is_iso, uvy, ldy_),
                             torch.where(is_metal, mdy, ddy))
        new_dz = torch.where(lam_or_iso, torch.where(is_iso, uvz, ldz_),
                             torch.where(is_metal, mdz, ddz))

        scattered = (is_metal & metal_ok) | (~is_metal & ~is_light)
        # the path dies when its max_depth-th segment ends
        # (renderer.rs:140-142: accumulated radiance stays, the rest is black)
        scat = hit_any & scattered
        if not depth_left_ok:
            scat = scat & False

        one = fzero + 1.0
        at_r = torch.where(is_metal, al_r, torch.where(is_diel, one, tex_r))
        at_g = torch.where(is_metal, al_g, torch.where(is_diel, one, tex_g))
        at_b = torch.where(is_metal, al_b, torch.where(is_diel, one, tex_b))
        tp_r = torch.where(scat, tp_r * at_r, tp_r)
        tp_g = torch.where(scat, tp_g * at_g, tp_g)
        tp_b = torch.where(scat, tp_b * at_b, tp_b)

        # f32 origin offset along the normal, media excluded; sign(0) == 0
        side = torch.sign(new_dx * nx_ + new_dy * ny_ + new_dz * nz_)
        mag = torch.maximum(hpx.abs(), torch.maximum(hpy.abs(), hpz.abs()))
        eps = ORIGIN_EPS_ABS + ORIGIN_EPS_REL * mag
        off = torch.where(w_is_med, 0.0, side * eps)
        o = _sel3(scat, (hpx + off * nx_, hpy + off * ny_, hpz + off * nz_),
                  (ox, oy, oz))
        d = _sel3(scat, (new_dx, new_dy, new_dz), (dx, dy, dz))
        return o, d, (tp_r, tp_g, tp_b), (rad_r, rad_g, rad_b), scat, rec

    if record:
        recs = torch.zeros((max(max_depth, 1), p.spp, P), dtype=torch.int32,
                           device=dev)
    acc = [fzero, fzero, fzero]
    acc_n = torch.zeros(P, dtype=torch.int32, device=dev)
    for si in range(p.spp):
        s_glob = si + p.sample_offset
        nox, noy, noz, ndx, ndy, ndz, rtime = camera_ray(s_glob)
        o, d = (nox, noy, noz), (ndx, ndy, ndz)
        tp = (fzero + 1.0, fzero + 1.0, fzero + 1.0)
        rad = (fzero, fzero, fzero)
        alive = torch.ones(P, dtype=torch.bool, device=dev)
        d_i = 0
        while True:
            acc_n = acc_n + alive.to(torch.int32)
            if on_bounce is not None:
                on_bounce(o, d, rtime, alive)
            rngb = CounterRng(seed, pid, s_glob, d_i)
            o, d, tp, rad, scat, rec = trace_bounce(
                o, d, rtime, tp, rad, alive, d_i + 1 < max_depth, rngb)
            if record:
                recs[d_i, si] = rec  # dead lanes record 0 (no hit)
            # a path that did not scatter is finished: flush its radiance
            died = alive & ~scat
            acc = [a + torch.where(died, r, 0.0) for a, r in zip(acc, rad)]
            alive = scat
            d_i += 1
            if d_i >= max_depth or not bool(alive.any()):
                break
    if record:
        return recs
    inv = 1.0 / p.spp
    rgb = torch.stack([a * inv for a in acc], dim=-1)
    return rgb, acc_n


# ------------------------------------------------------------ entry points
def render_pixels(scene, camera, seed: int = 0, spp: Optional[int] = None,
                  max_depth: Optional[int] = None, sample_offset: int = 0,
                  pixel_base: int = 0, pixel_count: Optional[int] = None,
                  use_bvh: Optional[bool] = None):
    """Fused render of a contiguous range of flat pixel ids (``j*w + i``)
    over samples ``sample_offset .. sample_offset + spp``, on the scene's
    device: one launch of the CUDA kernel for a scene on a CUDA device, the
    plain version for a scene on the CPU. ``use_bvh`` (default: from
    ``BVH_KERNEL_THRESHOLD`` primitives on) makes the kernel walk the kernel
    BVH; the result is the same.

    Returns tensors ``(rgb (count,3) f32 mean radiance, n (count,) i32 scene
    queries)`` on that device."""
    spp = spp or camera.samples_per_pixel
    max_depth = max_depth or camera.max_depth
    packed, tables = _packed_dev(scene, _use_bvh(scene, use_bvh))
    p = make_params(camera, packed, seed, spp, max_depth, sample_offset,
                    pixel_base, pixel_count)
    if scene.device.type == "cpu":
        return render_fast_plain(tables, p)
    return render_kernel(tables, p)


def render_fast(scene, camera, seed: int = 0, spp: Optional[int] = None,
                max_depth: Optional[int] = None, sample_offset: int = 0,
                use_bvh: Optional[bool] = None, with_stats: bool = False):
    """Fused offline render -> (H,W,3) float32 linear image (numpy).

    With ``with_stats``, returns (image, rays_traced) where rays_traced is
    the exact number of scene queries, summed in int64 on the device.

    Requires supports(scene)."""
    w, h = camera.image_width, camera.image_height
    rgb, n = render_pixels(scene, camera, seed=seed, spp=spp,
                           max_depth=max_depth, sample_offset=sample_offset,
                           use_bvh=use_bvh)
    nrays = n.sum(dtype=torch.int64)
    image = rgb.reshape(h, w, 3).cpu().numpy()
    if with_stats:
        return image, int(nrays.item())
    return image


def record_paths(scene, camera, seed: int, spp: int, max_depth: int,
                 sample_offset: int = 0, use_bvh: Optional[bool] = None,
                 pixel_base: int = 0,
                 pixel_count: Optional[int] = None) -> torch.Tensor:
    """Winner records of every (pixel, sample, bounce) over global samples
    ``sample_offset .. sample_offset + spp`` and flat pixel ids
    ``pixel_base .. pixel_base + pixel_count`` (default: the whole frame):
    the search half of the record/replay gradient (ops/replay.py). Returns
    ``(max_depth, spp, pixel_count)`` int32 on the scene's device,
    depth-major (replay reads bounce rows): one launch of the CUDA recorder
    for a scene on a CUDA device, its plain version for a scene on the CPU.
    Records carry no texture work, so every texture family is served.
    ``use_bvh`` as for ``render_pixels``."""
    packed, tables = _packed_dev(scene, _use_bvh(scene, use_bvh))
    p = make_params(camera, packed, seed, spp, max_depth, sample_offset,
                    pixel_base, pixel_count)
    if scene.device.type == "cpu":
        return record_paths_plain(tables, p)
    return record_kernel(tables, p)


def render_fast_sharded(scene, camera, mesh, seed: int = 0,
                        spp: Optional[int] = None,
                        max_depth: Optional[int] = None,
                        use_bvh: Optional[bool] = None,
                        with_stats: bool = False):
    """Fused render over a (rays, sample) mesh of ranks
    (parallel/mesh.py): the reference's SPMD megakernel
    (``render_fast_sharded``, ``_get_sharded_call``, ``_reassemble``).

    Each rank launches the render kernel once, on its rays-shard's pixel
    range and its sample range ``sample_idx * spp/n_sample`` onwards; the
    pixel range and the sample offset are runtime arguments, so one compiled
    kernel serves every rank. Each rank writes its per-pixel means into a
    zero full frame, and one all-reduce (sum) over every rank assembles the
    image, divided by ``n_sample``: the reference's psum of the means over
    the sample axis, fused with its reassembly. The ray count is one int64
    all-reduce. The RNG is addressed by (seed, pixel, sample), never by the
    rank, so a rays-only mesh gives ``render_fast``'s image bit for bit
    (``x + 0 = x``) and a split sample axis agrees to the rounding of the
    means' sum.

    Every rank returns the (H,W,3) float32 image (numpy), and with
    ``with_stats`` the exact int64 ray count of the whole mesh. Requires
    supports(scene) and ``spp % n_sample == 0``."""
    from ..parallel.mesh import shard_range

    spp = spp or camera.samples_per_pixel
    max_depth = max_depth or camera.max_depth
    if spp % mesh.n_sample:
        raise ValueError(f"spp={spp} not divisible by sample axis "
                         f"{mesh.n_sample}")
    if scene.device.type != mesh.device.type:
        raise ValueError(f"scene is on {scene.device}, the mesh's rank on "
                         f"{mesh.device}")
    spp_local = spp // mesh.n_sample
    w, h = camera.image_width, camera.image_height
    base, count = shard_range(w * h, mesh)
    rgb = torch.zeros((0, 3), dtype=torch.float32, device=scene.device)
    nrays = torch.zeros((1,), dtype=torch.int64, device=scene.device)
    if count:
        rgb, n = render_pixels(scene, camera, seed=seed, spp=spp_local,
                               max_depth=max_depth,
                               sample_offset=mesh.sample_idx * spp_local,
                               pixel_base=base, pixel_count=count,
                               use_bvh=use_bvh)
        nrays += n.sum(dtype=torch.int64)
    frame = mesh.assemble(rgb, base, w * h)
    mesh.all_reduce(nrays)
    if mesh.n_sample > 1:
        frame = frame / mesh.n_sample
    image = frame.reshape(h, w, 3).cpu().numpy()
    if with_stats:
        return image, int(nrays.item())
    return image


def hit_records(scene, seed: int, ox, oy, oz, dx, dy, dz, time, pix, samp,
                alive, bounce: int,
                use_bvh: Optional[bool] = None) -> torch.Tensor:
    """One bounce's winner records over the given lanes (see
    ``hit_kernel``): one launch of the CUDA hit kernel for a scene on a CUDA
    device, its plain version for a scene on the CPU. ``use_bvh`` as for
    ``render_pixels``."""
    packed, tables = _packed_dev(scene, _use_bvh(scene, use_bvh))
    p = search_params(packed, seed)
    lanes = (ox, oy, oz, dx, dy, dz, time, pix, samp, alive)
    if scene.device.type == "cpu":
        return hit_records_plain(tables, p, *lanes, bounce)
    return hit_kernel(tables, p, *lanes, bounce)
