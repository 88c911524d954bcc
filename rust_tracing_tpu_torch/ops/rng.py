"""Closed-form random samplers over an explicit ``torch.Generator``.

PyTorch counterpart of rust_tracing_tpu/ops/rng.py. The reference renderer
draws from a thread-local OS-seeded PRNG with rejection loops (reference:
src/vec3.rs:42-88); every sampler here is closed-form and has the same
distribution (documented per function). Each draws from the generator it is
given, on that generator's device, so a fixed seed gives a fixed stream.

No path of the renderer draws from these: the integrator addresses its
random numbers by (seed, pixel, sample, bounce, site) through
``ops/hashrng.py``. The streams are PyTorch's, not JAX's threefry streams,
so they agree with the reference in law, not in bits.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def uniform(gen: torch.Generator, shape: Tuple[int, ...],
            dtype=torch.float32, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """U[minval, maxval) — reference's ``rand::random::<FP>()``."""
    u = torch.rand(shape, generator=gen, dtype=dtype, device=gen.device)
    return u * (maxval - minval) + minval


def random_unit_vector(gen: torch.Generator, shape: Tuple[int, ...],
                       dtype=torch.float32) -> torch.Tensor:
    """Uniform direction on the unit sphere, shape ``shape + (3,)``.

    Reference (src/vec3.rs:63-66) rejects points outside the unit ball then
    normalizes — the result is exactly uniform on S^2. Normalized Gaussian
    triples have the same law, with no rejection loop.
    """
    v = torch.randn(tuple(shape) + (3,), generator=gen, dtype=dtype,
                    device=gen.device)
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    # Guard the measure-zero all-zeros draw.
    return v / torch.clamp(norm, min=1e-12)


def random_in_unit_sphere(gen: torch.Generator, shape: Tuple[int, ...],
                          dtype=torch.float32) -> torch.Tensor:
    """Uniform point in the unit ball, shape ``shape + (3,)``.

    Reference (src/vec3.rs:54-61) rejection-samples the cube. Equivalent
    closed form: uniform direction scaled by U^(1/3).
    """
    d = random_unit_vector(gen, shape, dtype)
    r = uniform(gen, tuple(shape) + (1,), dtype) ** (1.0 / 3.0)
    return d * r


def random_in_unit_disk(gen: torch.Generator, shape: Tuple[int, ...],
                        dtype=torch.float32) -> torch.Tensor:
    """Uniform point in the unit disk (z=0), shape ``shape + (3,)``.

    Reference (src/vec3.rs:77-88) rejection-samples the square. Equivalent
    closed form: polar with r = sqrt(U).
    """
    r = torch.sqrt(uniform(gen, shape, dtype))
    theta = uniform(gen, shape, dtype, maxval=2.0 * math.pi)
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta),
                        torch.zeros_like(r)], dim=-1)


def random_on_hemisphere(gen: torch.Generator, normal: torch.Tensor,
                         dtype=torch.float32) -> torch.Tensor:
    """Uniform direction on the hemisphere around ``normal`` (reference:
    src/vec3.rs:67-74). ``normal`` lies on the generator's device."""
    d = random_unit_vector(gen, normal.shape[:-1], dtype)
    flip = torch.sum(d * normal, dim=-1, keepdim=True) > 0.0
    return torch.where(flip, d, -d)
