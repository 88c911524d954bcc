"""Scene compiler: freeze a :class:`SceneBuilder` into device tensors.

PyTorch counterpart of rust_tracing_tpu/models/compile.py: the same field
names, padding rules (primitive tables padded to a multiple of 8 rows with
validity masks, media/material/texture tables to at least one row) and
``has_*`` flags, as a dataclass of tensors on an explicit device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..config import resolve_device
from ..ops import perlin as perlin_ops
from ..ops.linalg import cross, dot, length_squared
from . import scene as scene_mod


def _pad_to(n: int, multiple: int) -> int:
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def _pad_arr(a: np.ndarray, n: int, fill=0.0) -> np.ndarray:
    pad = n - a.shape[0]
    if pad == 0:
        return a
    width = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, width, constant_values=fill)


@dataclasses.dataclass(frozen=True, eq=False)
class CompiledScene:
    """Frozen device-side scene. All leaves are torch tensors on one device;
    the ``has_*`` flags are plain Python bools."""

    # spheres (reference: src/sphere.rs)
    sph_center: torch.Tensor  # (S,3)
    sph_radius: torch.Tensor  # (S,)
    sph_cvec: torch.Tensor  # (S,3) motion-blur center delta (sphere.rs:34-46)
    sph_mat: torch.Tensor  # (S,) int32
    sph_valid: torch.Tensor  # (S,) bool
    # quads (reference: src/quad.rs; normal/d/w precomputed as in quad.rs:23-38)
    quad_q: torch.Tensor  # (Q,3)
    quad_u: torch.Tensor  # (Q,3)
    quad_v: torch.Tensor  # (Q,3)
    quad_mat: torch.Tensor  # (Q,) int32
    quad_valid: torch.Tensor  # (Q,) bool
    # constant media (reference: src/constant_medium.rs)
    med_type: torch.Tensor  # (M,) int32: 0 sphere, 1 box
    med_sph_center: torch.Tensor  # (M,3)
    med_sph_radius: torch.Tensor  # (M,)
    med_rot: torch.Tensor  # (M,3,3) world->local rotation
    med_trans: torch.Tensor  # (M,3)
    med_lo: torch.Tensor  # (M,3) local box min
    med_hi: torch.Tensor  # (M,3) local box max
    med_neg_inv_density: torch.Tensor  # (M,)
    med_mat: torch.Tensor  # (M,) int32 (isotropic phase material)
    med_valid: torch.Tensor  # (M,) bool
    # materials (reference: src/material.rs)
    mat_type: torch.Tensor  # (N,) int32
    mat_tex: torch.Tensor  # (N,) int32
    mat_albedo: torch.Tensor  # (N,3) metal albedo
    mat_fuzz: torch.Tensor  # (N,)
    mat_ir: torch.Tensor  # (N,)
    # textures (reference: src/texture.rs)
    tex_type: torch.Tensor  # (T,) int32
    tex_rgb: torch.Tensor  # (T,3)
    tex_inv_scale: torch.Tensor  # (T,)
    tex_even: torch.Tensor  # (T,) int32 child texture id
    tex_odd: torch.Tensor  # (T,) int32
    tex_noise_scale: torch.Tensor  # (T,)
    tex_image: torch.Tensor  # (T,) int32 image id
    image: torch.Tensor  # (H,W,3) linear float; (1,1,3) dummy if unused
    # Perlin tables (reference: src/perlin.rs:14-25)
    perlin_ranvec: torch.Tensor  # (256,3)
    perlin_px: torch.Tensor  # (256,) int32
    perlin_py: torch.Tensor  # (256,) int32
    perlin_pz: torch.Tensor  # (256,) int32
    # misc
    background: torch.Tensor  # (3,)
    # flattened BVH (models/bvh.py); (1,)-dummies when has_bvh is False
    bvh_min: torch.Tensor  # (N,3)
    bvh_max: torch.Tensor  # (N,3)
    bvh_skip: torch.Tensor  # (N,) int32
    bvh_ptype: torch.Tensor  # (N,) int32: -1 internal, 0 sphere, 1 quad
    bvh_pidx: torch.Tensor  # (N,) int32
    # static trace-time pruning flags (which texture families exist)
    has_image: bool = dataclasses.field(default=False)
    has_noise: bool = dataclasses.field(default=False)
    has_checker: bool = dataclasses.field(default=False)
    has_media: bool = dataclasses.field(default=False)
    has_bvh: bool = dataclasses.field(default=False)
    # static material-family flags: a scene without metals never evaluates the
    # fuzz-ball sampler, without dielectrics never evaluates Schlick/refract,
    # etc. — the trace-time analog of the reference's per-hit dyn dispatch
    # (material.rs:11-16) that prunes whole transcendental subgraphs instead
    # of masking them (big deal for the O(rays) replay backward pass).
    has_metal: bool = dataclasses.field(default=True)
    has_dielectric: bool = dataclasses.field(default=True)
    has_isotropic: bool = dataclasses.field(default=True)
    has_lights: bool = dataclasses.field(default=True)
    # static primitive-family flags: tables are padded to >=8 rows even when
    # a family is absent, so shape alone can't prune — these let the replay
    # hit reconstruction (ops/replay.py) drop a whole family's winner-t/
    # normal/UV subgraph (cornell has no spheres: the quadratic + UV chain
    # and its transpose are pure waste there).
    has_spheres: bool = dataclasses.field(default=True)
    has_quads: bool = dataclasses.field(default=True)

    @property
    def num_spheres(self) -> int:
        return self.sph_radius.shape[0]

    @property
    def num_quads(self) -> int:
        return self.quad_mat.shape[0]

    @property
    def device(self) -> torch.device:
        return self.sph_center.device

    def quad_frame(self):
        """Derived quad quantities (reference: src/quad.rs:23-38), computed
        from ``quad_q/u/v`` on every call so that gradients reach them:
        ``(normal (Q,3), d (Q,), w (Q,3))``."""
        n = cross(self.quad_u, self.quad_v)
        nlen2 = torch.clamp(length_squared(n), min=1e-30)[:, None]
        normal = n / torch.sqrt(nlen2)
        d = dot(normal, self.quad_q)
        w = n / nlen2
        return normal, d, w

    def replace(self, **fields) -> "CompiledScene":
        """A copy with the given fields replaced."""
        return dataclasses.replace(self, **fields)


_FLAG_NAMES = tuple(
    f.name for f in dataclasses.fields(CompiledScene) if f.type == "bool")
_INT_FIELDS = frozenset((
    "sph_mat", "quad_mat", "med_type", "med_mat", "mat_type", "mat_tex",
    "tex_type", "tex_even", "tex_odd", "tex_image", "perlin_px", "perlin_py",
    "perlin_pz", "bvh_skip", "bvh_ptype", "bvh_pidx"))
_BOOL_FIELDS = frozenset(("sph_valid", "quad_valid", "med_valid"))


def scene_from_numpy(fields: Dict[str, np.ndarray], flags: Dict[str, bool],
                     device=None, dtype=torch.float32) -> CompiledScene:
    """Build a :class:`CompiledScene` from its leaves given as numpy arrays
    (one entry per tensor field) and its ``has_*`` flags. Float leaves are cast
    to ``dtype``, id leaves to int32, masks to bool; everything lands on
    ``device`` (``None`` = the GPU). This is how parameters cross from another
    implementation of the same scene format without sharing any object."""
    dev = resolve_device(device)
    leaves = {}
    for f in dataclasses.fields(CompiledScene):
        if f.name in _FLAG_NAMES:
            continue
        a = np.asarray(fields[f.name])
        if f.name in _BOOL_FIELDS:
            t = torch.from_numpy(np.array(a, dtype=np.bool_))
        elif f.name in _INT_FIELDS:
            t = torch.from_numpy(np.array(a, dtype=np.int32))
        else:
            t = torch.from_numpy(np.array(a, dtype=np.float64)).to(dtype)
        leaves[f.name] = t.to(dev)
    unknown = set(flags) - set(_FLAG_NAMES)
    if unknown:
        raise KeyError(f"unknown scene flags: {sorted(unknown)}")
    return CompiledScene(**leaves, **{k: bool(v) for k, v in flags.items()})


def grad_to_numpy(g: CompiledScene) -> Dict[str, np.ndarray]:
    """The tensor fields of a CompiledScene (for example a gradient returned
    by ``grad.loss_and_grad``) as numpy arrays, one entry per field, so they
    can be compared field by field with another implementation's."""
    return {f.name: getattr(g, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(CompiledScene)
            if f.name not in _FLAG_NAMES}


# Policy constant copied from the JAX package, where it was measured on a TPU
# (brute force beat the lockstep BVH walk far past the CPU crossover). It keeps
# the compiled scenes identical across the two packages and awaits its own
# measurement on the GPU.
BVH_AUTO_THRESHOLD = 16384


def compile_scene(
    builder: scene_mod.SceneBuilder,
    dtype=torch.float32,
    pad_multiple: int = 8,
    perlin_seed: int = 0,
    use_bvh: Optional[bool] = None,
    bvh_seed: int = 0,
    device=None,
) -> CompiledScene:
    b = builder

    # --- spheres
    S = _pad_to(b.num_spheres, pad_multiple)
    sph_center = _pad_arr(np.asarray(b.sph_center, np.float64).reshape(-1, 3), S)
    sph_radius = _pad_arr(np.asarray(b.sph_radius, np.float64).reshape(-1), S)
    sph_cvec = _pad_arr(np.asarray(b.sph_cvec, np.float64).reshape(-1, 3), S)
    sph_mat = _pad_arr(np.asarray(b.sph_mat, np.int32).reshape(-1), S)
    sph_valid = _pad_arr(np.ones(b.num_spheres, dtype=bool), S, fill=False)

    # --- quads
    Q = _pad_to(b.num_quads, pad_multiple)
    quad_q = _pad_arr(np.asarray(b.quad_q, np.float64).reshape(-1, 3), Q)
    # Padded quads get unit u/v so the derived frame stays finite.
    quad_u = _pad_arr(np.asarray(b.quad_u, np.float64).reshape(-1, 3), Q)
    quad_v = _pad_arr(np.asarray(b.quad_v, np.float64).reshape(-1, 3), Q)
    quad_u[b.num_quads :, 0] = 1.0
    quad_v[b.num_quads :, 1] = 1.0
    quad_mat = _pad_arr(np.asarray(b.quad_mat, np.int32).reshape(-1), Q)
    quad_valid = _pad_arr(np.ones(b.num_quads, dtype=bool), Q, fill=False)

    # --- media (pad to >= 1)
    M = max(1, b.num_media)
    med_type = _pad_arr(np.asarray(b.med_type, np.int32).reshape(-1), M)
    med_sph_center = _pad_arr(np.asarray(b.med_sph_center, np.float64).reshape(-1, 3), M)
    med_sph_radius = _pad_arr(np.asarray(b.med_sph_radius, np.float64).reshape(-1), M)
    med_rot = _pad_arr(
        np.asarray(b.med_rot, np.float64).reshape(-1, 3, 3)
        if b.num_media
        else np.zeros((0, 3, 3)),
        M,
    )
    if b.num_media < M:
        med_rot[b.num_media :] = np.eye(3)
    med_trans = _pad_arr(np.asarray(b.med_trans, np.float64).reshape(-1, 3), M)
    med_lo = _pad_arr(np.asarray(b.med_lo, np.float64).reshape(-1, 3), M)
    med_hi = _pad_arr(np.asarray(b.med_hi, np.float64).reshape(-1, 3), M)
    med_nid = _pad_arr(
        np.asarray(b.med_neg_inv_density, np.float64).reshape(-1), M, fill=-1.0
    )
    med_mat = _pad_arr(np.asarray(b.med_mat, np.int32).reshape(-1), M)
    med_valid = _pad_arr(np.ones(b.num_media, dtype=bool), M, fill=False)

    # --- materials / textures (pad to >= 1)
    N = max(1, len(b.mat_type))
    T = max(1, len(b.tex_type))

    image = b.images[0] if b.images else np.zeros((1, 1, 3), np.float32)
    assert len(b.images) <= 1, "one image texture per scene for now"

    ranvec, px, py, pz = perlin_ops.make_tables(perlin_seed)

    # --- BVH (auto for big scenes; media stay outside the tree)
    n_prims = b.num_spheres + b.num_quads
    if use_bvh is None:
        use_bvh = n_prims >= BVH_AUTO_THRESHOLD
    if use_bvh and n_prims > 0:
        from . import bvh as bvh_mod

        flat = bvh_mod.build_for(b, seed=bvh_seed)
        bvh_arrays = (flat.node_min, flat.node_max, flat.skip,
                      flat.prim_type, flat.prim_idx)
    else:
        use_bvh = False
        bvh_arrays = (np.zeros((1, 3)), np.zeros((1, 3)),
                      np.ones(1, np.int32), -np.ones(1, np.int32),
                      np.zeros(1, np.int32))

    fields = dict(
        sph_center=sph_center,
        sph_radius=sph_radius,
        sph_cvec=sph_cvec,
        sph_mat=sph_mat,
        sph_valid=sph_valid,
        quad_q=quad_q,
        quad_u=quad_u,
        quad_v=quad_v,
        quad_mat=quad_mat,
        quad_valid=quad_valid,
        med_type=med_type,
        med_sph_center=med_sph_center,
        med_sph_radius=med_sph_radius,
        med_rot=med_rot,
        med_trans=med_trans,
        med_lo=med_lo,
        med_hi=med_hi,
        med_neg_inv_density=med_nid,
        med_mat=med_mat,
        med_valid=med_valid,
        mat_type=_pad_arr(np.asarray(b.mat_type, np.int32).reshape(-1), N),
        mat_tex=_pad_arr(np.asarray(b.mat_tex, np.int32).reshape(-1), N),
        mat_albedo=_pad_arr(np.asarray(b.mat_albedo, np.float64).reshape(-1, 3), N),
        mat_fuzz=_pad_arr(np.asarray(b.mat_fuzz, np.float64).reshape(-1), N),
        mat_ir=_pad_arr(np.asarray(b.mat_ir, np.float64).reshape(-1), N, fill=1.0),
        tex_type=_pad_arr(np.asarray(b.tex_type, np.int32).reshape(-1), T),
        tex_rgb=_pad_arr(np.asarray(b.tex_rgb, np.float64).reshape(-1, 3), T),
        tex_inv_scale=_pad_arr(np.asarray(b.tex_inv_scale, np.float64).reshape(-1), T),
        tex_even=_pad_arr(np.asarray(b.tex_even, np.int32).reshape(-1), T),
        tex_odd=_pad_arr(np.asarray(b.tex_odd, np.int32).reshape(-1), T),
        tex_noise_scale=_pad_arr(
            np.asarray(b.tex_noise_scale, np.float64).reshape(-1), T),
        tex_image=_pad_arr(np.asarray(b.tex_image, np.int32).reshape(-1), T),
        image=image,
        perlin_ranvec=ranvec,
        perlin_px=px,
        perlin_py=py,
        perlin_pz=pz,
        background=np.asarray(b.background),
        bvh_min=bvh_arrays[0],
        bvh_max=bvh_arrays[1],
        bvh_skip=bvh_arrays[2],
        bvh_ptype=bvh_arrays[3],
        bvh_pidx=bvh_arrays[4],
    )
    flags = dict(
        has_image=bool(b.images),
        has_noise=scene_mod.TEX_NOISE in b.tex_type,
        has_checker=scene_mod.TEX_CHECKER in b.tex_type,
        has_media=b.num_media > 0,
        has_bvh=bool(use_bvh),
        has_metal=scene_mod.METAL in b.mat_type,
        has_dielectric=scene_mod.DIELECTRIC in b.mat_type,
        has_isotropic=scene_mod.ISOTROPIC in b.mat_type,
        has_lights=scene_mod.DIFFUSE_LIGHT in b.mat_type,
        has_spheres=b.num_spheres > 0,
        has_quads=b.num_quads > 0,
    )
    return scene_from_numpy(fields, flags, device=device, dtype=dtype)
