"""Vector math on ``[..., 3]`` tensors.

PyTorch counterpart of rust_tracing_tpu/ops/linalg.py (reference type
``Vec3``, src/vec3.rs:8-13). Points, directions and colours are plain
``[..., 3]`` tensors; every contraction is written as explicit
left-associated multiply-adds, never ``matmul``/``einsum``, so the array path
and the component path (dense ``(R,)`` lanes) give the same bits.
"""

from __future__ import annotations

import torch


def dot(a, b):
    """3-vector dot product; the last axis must be exactly 3
    (reference: src/vec3.rs:104-107)."""
    if a.shape[-1] != 3 or b.shape[-1] != 3:
        raise ValueError(f"dot expects [..., 3] vectors, got "
                         f"{tuple(a.shape)} . {tuple(b.shape)}")
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def length_squared(v):
    return dot(v, v)


def length(v):
    return torch.sqrt(length_squared(v))


def normalize(v, eps=0.0):
    """reference: src/vec3.rs:133-135. ``eps`` guards zero vectors when >0."""
    n = length(v)[..., None]
    if eps:
        n = torch.clamp(n, min=eps)
    return v / n


def cross(a, b):
    """reference: src/vec3.rs:137-143."""
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def reflect(v, n):
    """Mirror ``v`` about normal ``n`` (reference: src/vec3.rs:91-93)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv, n, etai_over_etat):
    """Snell refraction of unit vector ``uv`` (reference: src/vec3.rs:96-101);
    ``etai_over_etat`` is a scalar or a ``[...]`` tensor."""
    cos_theta = torch.clamp(dot(-uv, n), max=1.0)
    eta = torch.as_tensor(etai_over_etat, dtype=uv.dtype, device=uv.device)
    if eta.ndim:
        eta = eta[..., None]
    r_out_perp = eta * (uv + cos_theta[..., None] * n)
    # grad-safe sqrt: guard the total-internal-reflection boundary where
    # 1 - |perp|^2 touches 0
    s = torch.abs(1.0 - length_squared(r_out_perp))
    ok = s > 1e-20
    par = -torch.sqrt(torch.where(ok, s, 1.0)) * ok
    return r_out_perp + par[..., None] * n


def ray_at(origin, direction, t):
    """reference: src/ray.rs:30-32."""
    return origin + t[..., None] * direction
