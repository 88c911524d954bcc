"""Gamma-2.2 color conversion (reference: src/color.rs).

NB the reference uses a 2.2 power curve, *not* the book's sqrt
(src/color.rs:3-10), and quantizes with ``(256 * clamp(c, 0, 0.999)) as u8``
(src/color.rs:12-19). Both quirks are preserved bit-for-bit here.
"""

from __future__ import annotations

import numpy as np

GAMMA = 2.2


def linear_to_gamma(c):
    """reference: src/color.rs:3-6. Works on numpy arrays."""
    return c ** (1.0 / GAMMA)


def gamma_to_linear(c):
    """reference: src/color.rs:7-10."""
    return c**GAMMA


def color_to_rgb8(color: np.ndarray) -> np.ndarray:
    """Float linear color ``[..., 3]`` -> uint8 — reference: src/color.rs:12-19."""
    c = linear_to_gamma(np.clip(np.asarray(color), 0.0, None))
    return (256.0 * np.clip(c, 0.0, 0.999)).astype(np.uint8)


def rgb8_to_color(rgb: np.ndarray) -> np.ndarray:
    """uint8 ``[..., 3]`` -> float linear color — reference: src/color.rs:21-27."""
    return gamma_to_linear(np.asarray(rgb, dtype=np.float64) / 255.0)
