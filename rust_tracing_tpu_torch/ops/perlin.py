"""Perlin gradient noise with XOR-hashed permutation tables.

Port of rust_tracing_tpu/ops/perlin.py (reference: src/perlin.rs): 256 random
gradient vectors in [-1,1]^3 that are *not normalized* (perlin.rs:16-25),
three independent permutation tables (perlin.rs:74-79), lattice hash
``perm_x[i&255] ^ perm_y[j&255] ^ perm_z[k&255]`` (perlin.rs:41-44), Hermite
smoothed trilinear dot-product interpolation (perlin.rs:81-100) and
turbulence = |sum w^k noise(2^k p)| (perlin.rs:52-64).

``turbulence_c`` is the plain PyTorch version of the turbulence kernel
(ops/perlin_fused.py, csrc/perlin_kernel.cu), which does the same f32
operations in the same order: floor, Hermite ``u*u*(3-2u)``, the corner loop
di -> dj -> dk, octave accumulation with ``weight *= 0.5; s *= 2``, then
``abs``. The permutation lookups are integer gathers; the three gradient
lookups of a corner go through ``tgather_group``, so the backward into
``ranvec`` is the deterministic reduction (ops/lanegather.py) and never
``index_put_``'s atomics. ``turbulence_vjp_c`` is the plain version of the
backward kernel: its gradient by explicit formulas in the kernel's per-lane
order.
"""

from __future__ import annotations

import numpy as np
import torch

from .tgather import tgather, tgather_group

POINT_COUNT = 256


def make_tables(seed: int = 0):
    """Host-side table generation (reference: src/perlin.rs:14-25,66-79)."""
    rng = np.random.default_rng(seed)
    ranvec = rng.uniform(-1.0, 1.0, size=(POINT_COUNT, 3))
    perms = [rng.permutation(POINT_COUNT).astype(np.int32) for _ in range(3)]
    return ranvec, perms[0], perms[1], perms[2]


def noise_c(ranvec, perm_x, perm_y, perm_z, px, py, pz):
    """Component-form Perlin noise: dense lanes in and out
    (perlin.rs:27-49 + :81-100)."""
    fx, fy, fz = torch.floor(px), torch.floor(py), torch.floor(pz)
    ix, iy, iz = fx.to(torch.int32), fy.to(torch.int32), fz.to(torch.int32)
    ux, uy, uz = px - fx, py - fy, pz - fz
    # Hermite smoothing u*u*(3-2u) (perlin.rs:82-84)
    sx = ux * ux * (3.0 - 2.0 * ux)
    sy = uy * uy * (3.0 - 2.0 * uy)
    sz = uz * uz * (3.0 - 2.0 * uz)
    cols = (ranvec[:, 0], ranvec[:, 1], ranvec[:, 2])

    hxs = [tgather(perm_x, (ix + di) & 255) for di in (0, 1)]
    hys = [tgather(perm_y, (iy + dj) & 255) for dj in (0, 1)]
    hzs = [tgather(perm_z, (iz + dk) & 255) for dk in (0, 1)]
    acc = torch.zeros_like(px)
    for di in (0, 1):
        wx = sx if di == 1 else 1.0 - sx
        for dj in (0, 1):
            wy = sy if dj == 1 else 1.0 - sy
            for dk in (0, 1):
                wz = sz if dk == 1 else 1.0 - sz
                h = hxs[di] ^ hys[dj] ^ hzs[dk]  # perlin.rs:41-44
                rx, ry, rz = tgather_group(cols, h)
                dot = rx * (ux - di) + ry * (uy - dj) + rz * (uz - dk)
                acc = acc + wx * wy * wz * dot
    return acc


def noise(ranvec, perm_x, perm_y, perm_z, p):
    """Perlin noise at points ``p[..., 3]`` -> ``[...]`` in roughly [-1, 1]."""
    return noise_c(ranvec.to(p.dtype), perm_x, perm_y, perm_z,
                   p[..., 0], p[..., 1], p[..., 2])


def octave_sum_c(ranvec, perm_x, perm_y, perm_z, px, py, pz, depth: int = 7):
    """The signed octave sum ``sum_k 0.5^k noise(2^k p)`` of
    :func:`turbulence_c`."""
    acc = torch.zeros_like(px)
    weight = 1.0
    s = 1.0
    for _ in range(depth):
        acc = acc + weight * noise_c(ranvec, perm_x, perm_y, perm_z,
                                     px * s, py * s, pz * s)
        weight *= 0.5
        s *= 2.0
    return acc


def turbulence_c(ranvec, perm_x, perm_y, perm_z, px, py, pz, depth: int = 7):
    """Component form of :func:`turbulence` (perlin.rs:52-64): the plain
    version of the turbulence kernel."""
    return torch.abs(octave_sum_c(ranvec, perm_x, perm_y, perm_z, px, py, pz,
                                  depth))


def turbulence_vjp_c(ranvec, perm_x, perm_y, perm_z, px, py, pz, g,
                     depth: int = 7, want_terms: bool = True):
    """Vector-Jacobian product of :func:`turbulence_c` for the cotangent
    ``g``, by explicit formulas in the backward kernel's per-lane order
    (csrc/perlin_kernel.cu, ``perlin_backward_kernel``): the sign of the
    octave sum (+1 where it is 0, as the reference's ``jnp.abs``
    differentiates; ``torch.abs`` would give 0), then over
    octaves and corners the Hermite weights' derivative ``6u(1-u)``, the
    ``(u - d)`` offsets and the octave's scale ``s``; ``floor`` contributes
    nothing. Returns ``(d_px, d_py, d_pz, terms)``: ``terms`` is, when
    ``want_terms``, one ``(h, c)`` a octave, ``h`` the ``(8, R)`` hashes of
    its corners and ``c`` the ``(3, 8, R)`` contributions to ``ranvec[h]``
    (else None); their sum is the gradient of ``ranvec``. Not
    differentiable."""
    with torch.no_grad():
        acc = octave_sum_c(ranvec, perm_x, perm_y, perm_z, px, py, pz, depth)
        gs = g * torch.where(acc >= 0, 1.0, -1.0).to(acc.dtype)
        dx, dy, dz = (torch.zeros_like(px) for _ in range(3))
        terms = [] if want_terms else None
        w, s = 1.0, 1.0
        for _ in range(depth):
            qx, qy, qz = px * s, py * s, pz * s
            fx, fy, fz = torch.floor(qx), torch.floor(qy), torch.floor(qz)
            ix, iy, iz = (f.to(torch.int32) for f in (fx, fy, fz))
            ux, uy, uz = qx - fx, qy - fy, qz - fz
            sx = ux * ux * (3.0 - 2.0 * ux)
            sy = uy * uy * (3.0 - 2.0 * uy)
            sz = uz * uz * (3.0 - 2.0 * uz)
            dsx = 6.0 * ux * (1.0 - ux)
            dsy = 6.0 * uy * (1.0 - uy)
            dsz = 6.0 * uz * (1.0 - uz)
            hxs = [tgather(perm_x, (ix + d) & 255) for d in (0, 1)]
            hys = [tgather(perm_y, (iy + d) & 255) for d in (0, 1)]
            hzs = [tgather(perm_z, (iz + d) & 255) for d in (0, 1)]
            cw = gs * w
            nx, ny, nz = (torch.zeros_like(px) for _ in range(3))
            hs, cs = [], []
            for di in (0, 1):
                wx, dwx = (sx, dsx) if di else (1.0 - sx, -dsx)
                ox = ux - di
                for dj in (0, 1):
                    wy, dwy = (sy, dsy) if dj else (1.0 - sy, -dsy)
                    oy = uy - dj
                    for dk in (0, 1):
                        wz, dwz = (sz, dsz) if dk else (1.0 - sz, -dsz)
                        oz = uz - dk
                        h = hxs[di] ^ hys[dj] ^ hzs[dk]
                        r = ranvec[h.long()]
                        rx, ry, rz = r[..., 0], r[..., 1], r[..., 2]
                        dot = rx * ox + ry * oy + rz * oz
                        wgt = wx * wy * wz
                        nx = nx + (dwx * wy * wz * dot + wgt * rx)
                        ny = ny + (wx * dwy * wz * dot + wgt * ry)
                        nz = nz + (wx * wy * dwz * dot + wgt * rz)
                        if want_terms:
                            cc = cw * wgt
                            hs.append(h)
                            cs.append(torch.stack([cc * ox, cc * oy,
                                                   cc * oz]))
            dx = dx + cw * nx * s
            dy = dy + cw * ny * s
            dz = dz + cw * nz * s
            if want_terms:
                terms.append((torch.stack(hs), torch.stack(cs, 1)))
            w *= 0.5
            s *= 2.0
    return dx, dy, dz, terms


def turbulence(ranvec, perm_x, perm_y, perm_z, p, depth: int = 7):
    """reference: src/perlin.rs:52-64 (absolute value of the octave sum)."""
    return turbulence_c(ranvec.to(p.dtype), perm_x, perm_y, perm_z,
                        p[..., 0], p[..., 1], p[..., 2], depth)
