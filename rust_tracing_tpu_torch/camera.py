"""Thin-lens camera with antialiasing jitter, defocus blur and shutter time.

PyTorch counterpart of rust_tracing_tpu/camera.py (reference camera:
src/camera.rs:54-137): all viewport precomputation happens host-side in
float64 at construction; ``get_rays`` is a vectorized primary-ray generator
over a flat batch of pixel ids drawing every random number from the counter
RNG.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from .config import RenderSettings, degrees_to_radians, resolve_device
from .ops import hashrng


@dataclasses.dataclass(frozen=True, eq=False)
class Camera:
    """Precomputed camera basis (reference: src/camera.rs:54-110)."""

    image_width: int
    image_height: int
    samples_per_pixel: int
    max_depth: int
    background: Tuple[float, float, float]
    center: np.ndarray
    pixel00_loc: np.ndarray
    pixel_delta_u: np.ndarray
    pixel_delta_v: np.ndarray
    defocus_angle: float
    defocus_disk_u: np.ndarray
    defocus_disk_v: np.ndarray

    @staticmethod
    def create(settings: RenderSettings) -> "Camera":
        s = settings
        image_height = s.image_height

        look_from = np.asarray(s.look_from, dtype=np.float64)
        look_at = np.asarray(s.look_at, dtype=np.float64)
        vup = np.asarray(s.vup, dtype=np.float64)

        theta = degrees_to_radians(s.vfov)
        h = math.tan(theta / 2.0)
        viewport_height = 2.0 * h * s.focus_dist
        # reference: src/camera.rs:75 — width from the *integer* height ratio.
        viewport_width = viewport_height * (s.image_width / image_height)

        w = look_from - look_at
        w = w / np.linalg.norm(w)
        u = np.cross(vup, w)
        u = u / np.linalg.norm(u)
        v = np.cross(w, u)

        viewport_u = viewport_width * u
        viewport_v = -viewport_height * v

        center = look_from
        pixel_delta_u = viewport_u / s.image_width
        pixel_delta_v = viewport_v / image_height

        viewport_upper_left = (
            center - s.focus_dist * w - viewport_u * 0.5 - viewport_v * 0.5
        )
        pixel00_loc = viewport_upper_left + 0.5 * (pixel_delta_u + pixel_delta_v)

        defocus_radius = s.focus_dist * math.tan(
            degrees_to_radians(s.defocus_angle / 2.0)
        )
        return Camera(
            image_width=s.image_width,
            image_height=image_height,
            samples_per_pixel=s.samples_per_pixel,
            max_depth=s.max_depth,
            background=tuple(s.background),
            center=center,
            pixel00_loc=pixel00_loc,
            pixel_delta_u=pixel_delta_u,
            pixel_delta_v=pixel_delta_v,
            defocus_angle=float(s.defocus_angle),
            defocus_disk_u=u * defocus_radius,
            defocus_disk_v=v * defocus_radius,
        )

    def constants(self, dtype=torch.float32, device=None) -> "CameraConstants":
        return constants_from_numpy(
            center=self.center, pixel00_loc=self.pixel00_loc,
            pixel_delta_u=self.pixel_delta_u, pixel_delta_v=self.pixel_delta_v,
            defocus_disk_u=self.defocus_disk_u,
            defocus_disk_v=self.defocus_disk_v,
            defocus_angle=self.defocus_angle, image_width=self.image_width,
            dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True, eq=False)
class CameraConstants:
    """Device-side camera constants."""

    center: torch.Tensor
    pixel00_loc: torch.Tensor
    pixel_delta_u: torch.Tensor
    pixel_delta_v: torch.Tensor
    defocus_disk_u: torch.Tensor
    defocus_disk_v: torch.Tensor
    defocus_angle: float
    image_width: int


def constants_from_numpy(center, pixel00_loc, pixel_delta_u, pixel_delta_v,
                         defocus_disk_u, defocus_disk_v, defocus_angle,
                         image_width, dtype=torch.float32,
                         device=None) -> CameraConstants:
    """Camera constants from numpy vectors (each cast from float64 to
    ``dtype``) on ``device`` (``None`` = the GPU)."""
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float64)).to(dtype).to(dev)

    return CameraConstants(
        center=t(center), pixel00_loc=t(pixel00_loc),
        pixel_delta_u=t(pixel_delta_u), pixel_delta_v=t(pixel_delta_v),
        defocus_disk_u=t(defocus_disk_u), defocus_disk_v=t(defocus_disk_v),
        defocus_angle=float(defocus_angle), image_width=int(image_width))


def get_rays(cam: CameraConstants, seed, pixel_ids: torch.Tensor, sample):
    """Generate one primary ray per entry of ``pixel_ids`` (flat ``j*w + i``).

    Faithful to reference src/camera.rs:112-137:
    - jitter uniformly in the pixel square (:133-137),
    - origin on the defocus disk iff ``defocus_angle > 0`` (:117-121),
    - a *fresh uniform shutter time per ray, always* (:123).

    All draws come from the counter RNG addressed by
    ``(seed, pixel_id, sample, site)`` (ops/hashrng.py).

    Returns ``(origin[R,3], direction[R,3], time[R])``.
    """
    dtype = cam.center.dtype
    i = (pixel_ids % cam.image_width).to(dtype)
    j = torch.div(pixel_ids, cam.image_width, rounding_mode="floor").to(dtype)

    r = hashrng.CounterRng(seed, pixel_ids, sample, device=pixel_ids.device)
    px = r.uniform(hashrng.SITE_PIXEL_JX).to(dtype) - 0.5
    py = r.uniform(hashrng.SITE_PIXEL_JY).to(dtype) - 0.5

    pixel_sample = (
        cam.pixel00_loc
        + (i + px)[..., None] * cam.pixel_delta_u
        + (j + py)[..., None] * cam.pixel_delta_v
    )

    if cam.defocus_angle <= 0.0:
        origin = cam.center + torch.zeros_like(pixel_sample)
    else:
        dx, dy = r.in_unit_disk(hashrng.SITE_DEFOCUS_R, hashrng.SITE_DEFOCUS_TH)
        origin = (
            cam.center
            + dx.to(dtype)[..., None] * cam.defocus_disk_u
            + dy.to(dtype)[..., None] * cam.defocus_disk_v
        )

    direction = pixel_sample - origin
    time = r.uniform(hashrng.SITE_TIME).to(dtype)
    return origin, direction, time
