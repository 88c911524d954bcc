"""The reference's scene description, its camera, and the tables the
reference traces. Each configuration's scene is built by
``scenes/<scene>.py`` (``build(cfg)``) from these pieces.

A scene is built in float64 on the host (the book's constructions: quads,
boxes as six quads, spheres, constant media, materials and textures, an
instance transform baked in), its parameters rounded once to float32 (the
precision the configuration states), and the derived quantities (sphere
r^2 and 1/r, quad normal, w and d, the image's box-filtered mip) worked out
again in float64 from those float32 values and rounded once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# material and texture codes
LAMBERTIAN, METAL, DIELECTRIC, DIFFUSE_LIGHT, ISOTROPIC = 0, 1, 2, 3, 4
TEX_SOLID, TEX_CHECKER, TEX_IMAGE, TEX_NOISE = 0, 1, 2, 3
# the fused render samples an image texture from a mip of at most this many
# texels
IMG_MAX_TEXELS = 32768


def rotation_y(degrees: float) -> np.ndarray:
    th = np.deg2rad(degrees)
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


@dataclasses.dataclass(frozen=True)
class Transform:
    """Rotate about y, then translate (``Translate(RotateY(obj))``)."""

    rotate_y_deg: float = 0.0
    translate: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    def point(self, p):
        return (np.asarray(p, np.float64) @ rotation_y(self.rotate_y_deg).T
                + np.asarray(self.translate, np.float64))

    def vector(self, v):
        return np.asarray(v, np.float64) @ rotation_y(self.rotate_y_deg).T


IDENTITY = Transform()


class Scene:
    """Lists of primitives, materials and textures, in the order added."""

    def __init__(self, background=(0.0, 0.0, 0.0)):
        self.background = tuple(background)
        self.tex: List[tuple] = []   # (type, rgb, noise scale)
        self.mat: List[tuple] = []   # (type, tex, albedo, fuzz, ir)
        self.spheres: List[tuple] = []  # (center, radius, cvec, mat)
        self.quads: List[tuple] = []    # (q, u, v, mat)
        self.media: List[tuple] = []    # (center, radius, neg_inv_density, mat)
        self.image: Optional[np.ndarray] = None

    def texture(self, ttype, rgb=(0.0, 0.0, 0.0), noise_scale=0.0) -> int:
        self.tex.append((ttype, tuple(rgb), noise_scale))
        return len(self.tex) - 1

    def material(self, mtype, tex=0, albedo=(0.0, 0.0, 0.0), fuzz=0.0,
                 ir=1.0) -> int:
        self.mat.append((mtype, tex, tuple(albedo), fuzz, ir))
        return len(self.mat) - 1

    def lambertian(self, rgb_or_tex) -> int:
        tex = (rgb_or_tex if isinstance(rgb_or_tex, int)
               else self.texture(TEX_SOLID, rgb_or_tex))
        return self.material(LAMBERTIAN, tex)

    def light(self, rgb) -> int:
        return self.material(DIFFUSE_LIGHT, self.texture(TEX_SOLID, rgb))

    def quad(self, q, u, v, mat, xf: Transform = IDENTITY) -> None:
        self.quads.append((xf.point(q), xf.vector(u), xf.vector(v), mat))

    def box(self, a, b, mat, xf: Transform = IDENTITY) -> None:
        """Six faces, in the book's order: front, right, back, left, top,
        bottom."""
        lo = np.minimum(np.asarray(a, np.float64), np.asarray(b, np.float64))
        hi = np.maximum(np.asarray(a, np.float64), np.asarray(b, np.float64))
        dx = np.array([hi[0] - lo[0], 0.0, 0.0])
        dy = np.array([0.0, hi[1] - lo[1], 0.0])
        dz = np.array([0.0, 0.0, hi[2] - lo[2]])
        self.quad((lo[0], lo[1], hi[2]), dx, dy, mat, xf)
        self.quad((hi[0], lo[1], hi[2]), -dz, dy, mat, xf)
        self.quad((hi[0], lo[1], lo[2]), -dx, dy, mat, xf)
        self.quad((lo[0], lo[1], lo[2]), dz, dy, mat, xf)
        self.quad((lo[0], hi[1], hi[2]), dx, -dz, mat, xf)
        self.quad((lo[0], lo[1], lo[2]), dx, dz, mat, xf)

    def sphere(self, center, radius, mat, target=None,
               xf: Transform = IDENTITY) -> None:
        c = xf.point(center)
        cvec = np.zeros(3) if target is None else xf.point(target) - c
        self.spheres.append((c, float(radius), cvec, mat))

    def sphere_medium(self, center, radius, density, albedo) -> None:
        mat = self.material(ISOTROPIC, self.texture(TEX_SOLID, albedo))
        self.media.append((np.asarray(center, np.float64), float(radius),
                           -1.0 / density, mat))


# ------------------------------------------------------------------ camera
@dataclasses.dataclass(frozen=True)
class View:
    """The camera of a frame: float32 constants and the frame's size."""

    width: int
    height: int
    center: Tuple[float, float, float]
    pixel00: Tuple[float, float, float]
    delta_u: Tuple[float, float, float]
    delta_v: Tuple[float, float, float]
    background: Tuple[float, float, float]


def view(cfg: Dict) -> View:
    """The book's camera (camera.rs:54-110) in float64, its constants
    rounded once to float32. ``cfg`` holds image_width, aspect_ratio, vfov,
    look_from, look_at, vup, focus_dist and background."""
    width = int(cfg["image_width"])
    height = int(width / cfg["aspect_ratio"])
    look_from = np.asarray(cfg["look_from"], np.float64)
    look_at = np.asarray(cfg["look_at"], np.float64)
    vup = np.asarray(cfg.get("vup", (0.0, 1.0, 0.0)), np.float64)
    focus = float(cfg.get("focus_dist", 10.0))
    h = math.tan(math.radians(cfg["vfov"]) / 2.0)
    vp_h = 2.0 * h * focus
    vp_w = vp_h * (width / height)
    w = look_from - look_at
    w = w / np.linalg.norm(w)
    u = np.cross(vup, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    vp_u, vp_v = vp_w * u, -vp_h * v
    du, dv = vp_u / width, vp_v / height
    upper_left = look_from - focus * w - vp_u * 0.5 - vp_v * 0.5
    p00 = upper_left + 0.5 * (du + dv)
    f3 = lambda a: tuple(float(np.float32(x)) for x in a)
    return View(width, height, f3(look_from), f3(p00), f3(du), f3(dv),
                f3(cfg["background"]))


# ------------------------------------------------------------------ tables
def f32(a) -> np.ndarray:
    """float64 of the float32 rounding: a parameter as the configuration
    states it."""
    return np.asarray(a, np.float64).astype(np.float32).astype(np.float64)


def tables(s: Scene, device, dtype=torch.float32) -> Dict:
    """Row tables of the scene on ``device`` in ``dtype``: spheres (cx cy
    cz r2 1/r mvx mvy mvz), quads (q u v normal w d), materials (albedo
    fuzz ir | type tex), textures (rgb noise-scale | type), the image's mip
    (3, h, w), and the media as Python rows."""
    S, Q = len(s.spheres), len(s.quads)
    sph = np.zeros((max(S, 1), 8))
    if S:
        c = f32([x[0] for x in s.spheres])
        r = f32([x[1] for x in s.spheres])
        sph[:S, 0:3] = c
        sph[:S, 3] = r * r
        sph[:S, 4] = 1.0 / np.where(np.abs(r) < 1e-12, 1e-12, r)
        sph[:S, 5:8] = f32([x[2] for x in s.spheres])
    quad = np.zeros((max(Q, 1), 16))
    if Q:
        q = f32([x[0] for x in s.quads])
        u = f32([x[1] for x in s.quads])
        v = f32([x[2] for x in s.quads])
        n = np.cross(u, v)
        nlen2 = np.maximum((n * n).sum(-1, keepdims=True), 1e-30)
        normal = n / np.sqrt(nlen2)
        quad[:Q, 0:3], quad[:Q, 3:6], quad[:Q, 6:9] = q, u, v
        quad[:Q, 9:12] = normal
        quad[:Q, 12:15] = n / nlen2
        quad[:Q, 15] = (normal * q).sum(-1)
    mat_f = np.array([(*m[2], m[3], m[4]) for m in s.mat], np.float64)
    tex_f = np.array([(*t[1], t[2]) for t in s.tex], np.float64)
    img = (np.zeros((1, 1, 3)) if s.image is None
           else np.asarray(s.image, np.float64))
    ih, iw = img.shape[:2]
    if s.image is not None and ih * iw > IMG_MAX_TEXELS:
        f = int(np.ceil(np.sqrt(ih * iw / IMG_MAX_TEXELS)))
        ch, cw = (ih // f) * f, (iw // f) * f
        img = img[:ch, :cw].reshape(ch // f, f, cw // f, f, 3).mean((1, 3))
        ih, iw = img.shape[:2]
    img_f = img.reshape(-1, 3).T.astype(np.float32).reshape(3, ih, iw)

    def dev(a, dt=None):
        return torch.as_tensor(np.asarray(a, np.float32)).to(
            device=device, dtype=dt or dtype)

    def ints(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    media = [([float(np.float32(x)) for x in m[0]],
              float(np.float32(f32(m[1]) ** 2)),
              float(np.float32(m[2])), m[3]) for m in s.media]
    return dict(
        sph=dev(sph), sph_m=ints([x[3] for x in s.spheres] or [0]),
        quad=dev(quad), quad_m=ints([x[3] for x in s.quads] or [0]),
        n_spheres=S, n_quads=Q,
        mat_f=dev(mat_f), mat_type=ints([m[0] for m in s.mat]),
        mat_tex=ints([m[1] for m in s.mat]),
        tex_f=dev(tex_f), tex_type=ints([t[0] for t in s.tex]),
        img=dev(img_f), img_h=ih, img_w=iw,
        has_noise=any(t[0] == TEX_NOISE for t in s.tex),
        has_image=s.image is not None,
        media=media, dtype=dtype)
