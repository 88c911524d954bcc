"""Global configuration and render settings.

PyTorch counterpart of rust_tracing_tpu/config.py: the same constants and the
same :class:`RenderSettings` defaults (reference: src/camera.rs:22-37), with
the compute dtype defaulting to ``torch.float32``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

# Default compute dtype for device kernels (the reference computes in f64,
# src/common.rs:1; the hand-written CUDA kernel is f32 only).
DEFAULT_DTYPE = torch.float32

PI = math.pi

# Shadow-acne epsilon for secondary rays (reference: src/renderer.rs:144 uses
# Interval::new(0.001, INFINITY)).
T_MIN = 1e-3

# Parallel-ray rejection epsilon for quads (reference: src/quad.rs:110-112).
QUAD_DENOM_EPS = 1e-8

# Constant-medium re-hit offset (reference: src/constant_medium.rs:38).
MEDIUM_REHIT_EPS = 1e-4

# Lambertian near-zero scatter fallback epsilon (reference: src/vec3.rs near_zero,
# material.rs:32-37).
NEAR_ZERO_EPS = 1e-8


def degrees_to_radians(degrees: float) -> float:
    """reference: src/common.rs:5-8."""
    return degrees * PI / 180.0


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU. The CPU is used only when the caller names it;
    with no card and no explicit ``device="cpu"`` this raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rust_tracing_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run the plain PyTorch path")
    return dev


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Camera + render configuration.

    Field-for-field equivalent of ``CameraSettings`` with the same defaults
    (reference: src/camera.rs:22-37).
    """

    aspect_ratio: float = 16.0 / 9.0
    image_width: int = 400
    samples_per_pixel: int = 100
    max_depth: int = 50
    vfov: float = 90.0
    look_from: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    look_at: Tuple[float, float, float] = (0.0, 0.0, -1.0)
    vup: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    defocus_angle: float = 0.0
    focus_dist: float = 10.0
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    @property
    def image_height(self) -> int:
        # reference: src/camera.rs:69 (integer truncation, min clamp implicit)
        return int(self.image_width / self.aspect_ratio)
