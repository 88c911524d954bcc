"""Scene intermediate representation: arrays, not objects.

The reference scene is a frozen ``Arc<dyn Hittable>`` pointer graph traversed
by threads (src/hittable.rs:45-79). The array redesign compiles the scene
host-side into flat structure-of-arrays tables traversed by vectorized
kernels:

- **Primitives** (sphere src/sphere.rs, quad src/quad.rs) become SoA arrays
  with integer material ids.
- **Instancing** (``Translate`` src/hittable.rs:81-111, ``RotateY``
  src/hittable.rs:113-193) is *baked at compile time*: rigid transforms map
  spheres to spheres and quads to quads, so the hot path carries zero per-ray
  inverse transforms.
- **Materials** (src/material.rs) and **textures** (src/texture.rs) become
  type-coded parameter tables; dynamic trait dispatch becomes branchless
  masked selects in the kernels.
- **Constant media** (src/constant_medium.rs) become dedicated boundary
  primitives (sphere / oriented box) with closed-form entry/exit, instead of
  re-walking the BVH twice per query.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from ..utils import color as color_util

# Material type codes (reference: src/material.rs)
LAMBERTIAN = 0  # material.rs:26-42
METAL = 1  # material.rs:53-64
DIELECTRIC = 2  # material.rs:80-104
DIFFUSE_LIGHT = 3  # material.rs:114-122
ISOTROPIC = 4  # material.rs:132-138

# Texture type codes (reference: src/texture.rs)
TEX_SOLID = 0  # texture.rs:16-36
TEX_CHECKER = 1  # texture.rs:59-70
TEX_IMAGE = 2  # texture.rs:76-93
TEX_NOISE = 3  # texture.rs:107-111

# Medium boundary type codes
MED_SPHERE = 0
MED_BOX = 1

Color = Tuple[float, float, float]


def rotation_y(degrees: float) -> np.ndarray:
    """Object->world rotation about Y (reference: src/hittable.rs:172-184)."""
    th = np.deg2rad(degrees)
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


@dataclasses.dataclass(frozen=True)
class Transform:
    """Rigid instancing transform: rotate about Y then translate.

    Composition order matches the reference's wrapper nesting
    ``Translate(RotateY(obj, angle), offset)`` (e.g. src/main.rs cornell_box).
    """

    rotate_y_deg: float = 0.0
    translate: Color = (0.0, 0.0, 0.0)

    def matrix(self) -> np.ndarray:
        return rotation_y(self.rotate_y_deg)

    def apply_point(self, p: np.ndarray) -> np.ndarray:
        return p @ self.matrix().T + np.asarray(self.translate)

    def apply_vector(self, v: np.ndarray) -> np.ndarray:
        return v @ self.matrix().T


IDENTITY = Transform()


class SceneBuilder:
    """Host-side scene construction API.

    Mirrors the constructive surface of the reference scene builders
    (src/main.rs:56-639) — spheres, quads, cubes, media, 5 materials,
    4 textures — but emits flat arrays instead of an object graph.
    """

    def __init__(self, background: Color = (0.0, 0.0, 0.0)):
        self.background = tuple(background)
        # textures
        self.tex_type: List[int] = []
        self.tex_rgb: List[Color] = []
        self.tex_inv_scale: List[float] = []
        self.tex_even: List[int] = []
        self.tex_odd: List[int] = []
        self.tex_noise_scale: List[float] = []
        self.tex_image: List[int] = []
        self.images: List[np.ndarray] = []
        # materials
        self.mat_type: List[int] = []
        self.mat_tex: List[int] = []
        self.mat_albedo: List[Color] = []
        self.mat_fuzz: List[float] = []
        self.mat_ir: List[float] = []
        # spheres
        self.sph_center: List[np.ndarray] = []
        self.sph_radius: List[float] = []
        self.sph_cvec: List[np.ndarray] = []
        self.sph_mat: List[int] = []
        # quads
        self.quad_q: List[np.ndarray] = []
        self.quad_u: List[np.ndarray] = []
        self.quad_v: List[np.ndarray] = []
        self.quad_mat: List[int] = []
        # media
        self.med_type: List[int] = []
        self.med_sph_center: List[np.ndarray] = []
        self.med_sph_radius: List[float] = []
        self.med_rot: List[np.ndarray] = []  # world->local rotation
        self.med_trans: List[np.ndarray] = []
        self.med_lo: List[np.ndarray] = []
        self.med_hi: List[np.ndarray] = []
        self.med_neg_inv_density: List[float] = []
        self.med_mat: List[int] = []

    # ---------------------------------------------------------------- textures
    def _add_texture(self, ttype, rgb=(0, 0, 0), inv_scale=0.0, even=0, odd=0,
                     noise_scale=0.0, image=0) -> int:
        self.tex_type.append(ttype)
        self.tex_rgb.append(tuple(rgb))
        self.tex_inv_scale.append(inv_scale)
        self.tex_even.append(even)
        self.tex_odd.append(odd)
        self.tex_noise_scale.append(noise_scale)
        self.tex_image.append(image)
        return len(self.tex_type) - 1

    def solid_texture(self, rgb: Color) -> int:
        """reference: src/texture.rs:16-36."""
        return self._add_texture(TEX_SOLID, rgb=rgb)

    def checker_texture(self, scale: float, even, odd) -> int:
        """3-D world-space checker (reference: src/texture.rs:59-70).

        ``even``/``odd`` may be colors or texture ids of non-checker textures
        (one level of nesting, which covers every reference scene).
        """
        if not isinstance(even, (int, np.integer)):
            even = self.solid_texture(even)
        if not isinstance(odd, (int, np.integer)):
            odd = self.solid_texture(odd)
        assert self.tex_type[even] != TEX_CHECKER
        assert self.tex_type[odd] != TEX_CHECKER
        return self._add_texture(TEX_CHECKER, inv_scale=1.0 / scale, even=even, odd=odd)

    def image_texture(self, image_rgb8: np.ndarray) -> int:
        """Image texture from a uint8 HxWx3 array.

        Decoded through gamma_to_linear like the reference
        (src/texture.rs:83-93 + src/color.rs:21-27); sampling is
        nearest-neighbor with u clamp and v flip, done in the kernel.
        """
        img = color_util.rgb8_to_color(image_rgb8[..., :3]).astype(np.float32)
        self.images.append(img)
        return self._add_texture(TEX_IMAGE, image=len(self.images) - 1)

    def noise_texture(self, scale: float) -> int:
        """Perlin marble texture (reference: src/texture.rs:107-111)."""
        return self._add_texture(TEX_NOISE, noise_scale=scale)

    # --------------------------------------------------------------- materials
    def _add_material(self, mtype, tex=0, albedo=(0, 0, 0), fuzz=0.0, ir=1.0) -> int:
        self.mat_type.append(mtype)
        self.mat_tex.append(tex)
        self.mat_albedo.append(tuple(albedo))
        self.mat_fuzz.append(fuzz)
        self.mat_ir.append(ir)
        return len(self.mat_type) - 1

    def _tex_id(self, tex_or_color) -> int:
        if isinstance(tex_or_color, (int, np.integer)):
            return int(tex_or_color)
        return self.solid_texture(tex_or_color)

    def lambertian(self, albedo) -> int:
        """Texture id or color — reference: src/material.rs:26-42."""
        return self._add_material(LAMBERTIAN, tex=self._tex_id(albedo))

    def metal(self, albedo: Color, fuzz: float) -> int:
        """reference: src/material.rs:53-64."""
        return self._add_material(METAL, albedo=albedo, fuzz=fuzz)

    def dielectric(self, ir: float) -> int:
        """reference: src/material.rs:80-104."""
        return self._add_material(DIELECTRIC, ir=ir)

    def diffuse_light(self, emit) -> int:
        """Texture id or color — reference: src/material.rs:114-122."""
        return self._add_material(DIFFUSE_LIGHT, tex=self._tex_id(emit))

    def isotropic(self, albedo) -> int:
        """reference: src/material.rs:132-138."""
        return self._add_material(ISOTROPIC, tex=self._tex_id(albedo))

    def _check_mat(self, mat: int) -> None:
        if not 0 <= mat < len(self.mat_type):
            raise ValueError(f"material id {mat} out of range "
                             f"(have {len(self.mat_type)} materials)")

    @staticmethod
    def _check_finite(name, value) -> None:
        a = np.asarray(value, np.float64)
        if not np.all(np.isfinite(a)):
            raise ValueError(f"{name} must be finite, got {value}")

    # ---------------------------------------------------------------- geometry
    def add_sphere(self, center: Color, radius: float, mat: int,
                   target: Optional[Color] = None,
                   transform: Transform = IDENTITY) -> None:
        """Static or motion-blurred sphere (reference: src/sphere.rs:23-46).

        ``target`` sets the t=1 center for motion blur (``with_target``);
        ``transform`` is baked into the center (rigid transforms preserve
        spheres, replacing the reference's per-ray Translate/RotateY).
        A negative radius is allowed (the book's hollow-glass-shell trick:
        it flips the outward normal); zero or non-finite is rejected.
        """
        self._check_mat(mat)
        self._check_finite("sphere center", center)
        self._check_finite("sphere radius", radius)
        if radius == 0.0:
            raise ValueError("sphere radius must be nonzero")
        c = transform.apply_point(np.asarray(center, dtype=np.float64))
        cvec = np.zeros(3)
        if target is not None:
            cvec = transform.apply_point(np.asarray(target, np.float64)) - c
        self.sph_center.append(c)
        self.sph_radius.append(float(radius))
        self.sph_cvec.append(cvec)
        self.sph_mat.append(mat)

    def add_quad(self, q: Color, u: Color, v: Color, mat: int,
                 transform: Transform = IDENTITY) -> None:
        """Parallelogram (reference: src/quad.rs:23-38), transform baked."""
        self._check_mat(mat)
        self._check_finite("quad q/u/v", (tuple(q), tuple(u), tuple(v)))
        if np.linalg.norm(np.cross(np.asarray(u, np.float64),
                                   np.asarray(v, np.float64))) == 0.0:
            raise ValueError("quad edge vectors u, v must span a plane "
                             "(cross product is zero)")
        self.quad_q.append(transform.apply_point(np.asarray(q, np.float64)))
        self.quad_u.append(transform.apply_vector(np.asarray(u, np.float64)))
        self.quad_v.append(transform.apply_vector(np.asarray(v, np.float64)))
        self.quad_mat.append(mat)

    def add_cube(self, a: Color, b: Color, mat: int,
                 transform: Transform = IDENTITY) -> None:
        """Axis-aligned box as 6 quads (reference: src/quad.rs:45-93),
        instancing transform baked into each face."""
        lo = np.minimum(np.asarray(a, np.float64), np.asarray(b, np.float64))
        hi = np.maximum(np.asarray(a, np.float64), np.asarray(b, np.float64))
        dx = np.array([hi[0] - lo[0], 0.0, 0.0])
        dy = np.array([0.0, hi[1] - lo[1], 0.0])
        dz = np.array([0.0, 0.0, hi[2] - lo[2]])
        # Face order matches quad.rs:56-92 (front, right, back, left, top, bottom).
        self.add_quad((lo[0], lo[1], hi[2]), dx, dy, mat, transform)
        self.add_quad((hi[0], lo[1], hi[2]), -dz, dy, mat, transform)
        self.add_quad((hi[0], lo[1], lo[2]), -dx, dy, mat, transform)
        self.add_quad((lo[0], lo[1], lo[2]), dz, dy, mat, transform)
        self.add_quad((lo[0], hi[1], hi[2]), dx, -dz, mat, transform)
        self.add_quad((lo[0], lo[1], lo[2]), dx, dz, mat, transform)

    # ------------------------------------------------------------------- media
    def add_sphere_medium(self, center: Color, radius: float, density: float,
                          albedo, transform: Transform = IDENTITY) -> None:
        """Constant-density medium with a spherical boundary
        (reference: src/constant_medium.rs:14-31 wrapping a Sphere)."""
        if not (density > 0.0 and np.isfinite(density)):
            raise ValueError(f"medium density must be > 0, got {density}")
        mat = self.isotropic(albedo)
        self.med_type.append(MED_SPHERE)
        self.med_sph_center.append(
            transform.apply_point(np.asarray(center, np.float64)))
        self.med_sph_radius.append(float(radius))
        self.med_rot.append(np.eye(3))
        self.med_trans.append(np.zeros(3))
        self.med_lo.append(np.zeros(3))
        self.med_hi.append(np.zeros(3))
        self.med_neg_inv_density.append(-1.0 / density)
        self.med_mat.append(mat)

    def add_box_medium(self, a: Color, b: Color, density: float, albedo,
                       transform: Transform = IDENTITY) -> None:
        """Constant-density medium bounded by a (possibly rotated+translated)
        box (reference: cornell_smoke, src/main.rs cube + RotateY + Translate
        wrapped in ConstantMedium). The boundary keeps its local frame; rays
        are transformed world->local for the slab entry/exit test."""
        if not (density > 0.0 and np.isfinite(density)):
            raise ValueError(f"medium density must be > 0, got {density}")
        mat = self.isotropic(albedo)
        lo = np.minimum(np.asarray(a, np.float64), np.asarray(b, np.float64))
        hi = np.maximum(np.asarray(a, np.float64), np.asarray(b, np.float64))
        self.med_type.append(MED_BOX)
        self.med_sph_center.append(np.zeros(3))
        self.med_sph_radius.append(0.0)
        self.med_rot.append(transform.matrix().T)  # world->local = R^T
        self.med_trans.append(np.asarray(transform.translate, np.float64))
        self.med_lo.append(lo)
        self.med_hi.append(hi)
        self.med_neg_inv_density.append(-1.0 / density)
        self.med_mat.append(mat)

    # ------------------------------------------------------------------ counts
    @property
    def num_spheres(self) -> int:
        return len(self.sph_radius)

    @property
    def num_quads(self) -> int:
        return len(self.quad_mat)

    @property
    def num_media(self) -> int:
        return len(self.med_mat)
