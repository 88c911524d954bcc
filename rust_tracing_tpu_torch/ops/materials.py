"""Branchless material response: scatter and emission over a type-coded table.

PyTorch counterpart of rust_tracing_tpu/ops/materials.py (reference trait
``Material::{scatter, emitted}``, src/material.rs:11-16): the material
families a scene holds are computed over all rays and selected by type code.

- Lambertian: normal + random unit vector, near-zero fallback to the normal
  (material.rs:26-42);
- Metal: mirror of the normalized incoming direction + fuzz * point in the
  unit ball, absorbed when the fuzzed ray dips below the surface
  (material.rs:53-64);
- Dielectric: Schlick reflectance coin + total internal reflection, unit
  attenuation (material.rs:74-104);
- DiffuseLight: never scatters, emits its texture (material.rs:114-122);
- Isotropic: uniform sphere phase function (material.rs:132-138).

Component form (``scatter_and_emit_c``, dense ``(R,)`` lanes) with the array
wrapper ``scatter_and_emit``. Family pruning follows the scene's static
``has_*`` flags, as in the reference; draws are site-addressed, so skipping an
absent family's draws shifts no other stream. Integer powers are repeated
multiplication (x**2 = x*x), whose forward and backward give the same bits as
the reference's ``integer_pow``.

The reference names its RNG draws for a save-only-these remat policy inside
a per-bounce checkpoint; the port keeps no per-bounce checkpoint
(grad.py), so the draws are plain tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import NEAR_ZERO_EPS
from ..models.scene import DIELECTRIC, DIFFUSE_LIGHT, ISOTROPIC, METAL
from . import hashrng
from .textures import texture_value_c
from .tgather import tgather


class Scatter(NamedTuple):
    direction: torch.Tensor  # (R,3) new ray direction
    attenuation: torch.Tensor  # (R,3)
    scattered: torch.Tensor  # (R,) bool: False = absorbed or pure emitter
    emitted: torch.Tensor  # (R,3)


class ScatterC(NamedTuple):
    """Component-form scatter result: ten dense (R,) lanes."""

    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    ar: torch.Tensor
    ag: torch.Tensor
    ab: torch.Tensor
    scattered: torch.Tensor
    er: torch.Tensor
    eg: torch.Tensor
    eb: torch.Tensor


def scatter_and_emit_c(scene, rngb, d_in_x, d_in_y, d_in_z,
                       nx, ny, nz, front_face, mat_id, u, v,
                       px, py, pz) -> ScatterC:
    """Component-form material evaluation for rays with hit components.
    ``rngb`` is the per-bounce CounterRng; the draw sites mirror the fused
    kernel's, so both paths consume identical random streams."""
    dtype = d_in_x.dtype
    mtype = tgather(scene.mat_type, mat_id)
    tex_id = tgather(scene.mat_tex, mat_id)

    uvx, uvy, uvz = (c.to(dtype) for c in rngb.unit_vector(
        hashrng.SITE_SCATTER_Z, hashrng.SITE_SCATTER_PHI))

    tex_r, tex_g, tex_b = texture_value_c(scene, tex_id, u, v, px, py, pz)

    # Lambertian (material.rs:26-42)
    ldx, ldy, ldz = nx + uvx, ny + uvy, nz + uvz
    near_zero = ((torch.abs(ldx) < NEAR_ZERO_EPS)
                 & (torch.abs(ldy) < NEAR_ZERO_EPS)
                 & (torch.abs(ldz) < NEAR_ZERO_EPS))
    ldx = torch.where(near_zero, nx, ldx)
    ldy = torch.where(near_zero, ny, ldy)
    ldz = torch.where(near_zero, nz, ldz)

    is_metal = mtype == METAL
    is_diel = mtype == DIELECTRIC
    is_light = mtype == DIFFUSE_LIGHT
    is_iso = mtype == ISOTROPIC

    if scene.has_metal or scene.has_dielectric:
        inv_len = 1.0 / torch.clamp(
            torch.sqrt(d_in_x * d_in_x + d_in_y * d_in_y + d_in_z * d_in_z),
            min=1e-30)
        udx, udy, udz = d_in_x * inv_len, d_in_y * inv_len, d_in_z * inv_len
        rdot = udx * nx + udy * ny + udz * nz
        rlx = udx - 2.0 * rdot * nx  # reflect (vec3.rs:91-93)
        rly = udy - 2.0 * rdot * ny
        rlz = udz - 2.0 * rdot * nz

    dir_x, dir_y, dir_z = ldx, ldy, ldz
    if scene.has_isotropic:
        # Isotropic (material.rs:132-138): fresh uniform direction
        dir_x = torch.where(is_iso, uvx, dir_x)
        dir_y = torch.where(is_iso, uvy, dir_y)
        dir_z = torch.where(is_iso, uvz, dir_z)
    if scene.has_dielectric:
        # Dielectric (material.rs:80-104)
        coin = rngb.uniform(hashrng.SITE_SCHLICK).to(dtype)
        ir = tgather(scene.mat_ir, mat_id)
        ratio = torch.where(front_face, 1.0 / ir, ir)
        cos_theta = torch.clamp(-(udx * nx + udy * ny + udz * nz), max=1.0)
        sin_sq = 1.0 - cos_theta * cos_theta
        sin_theta = (torch.sqrt(torch.where(sin_sq > 0, sin_sq, 1.0))
                     * (sin_sq > 0))
        cannot_refract = ratio * sin_theta > 1.0
        r0h = (1.0 - ratio) / (1.0 + ratio)
        r0 = r0h * r0h  # Schlick (material.rs:74-78)
        omc = 1.0 - cos_theta
        omc2 = omc * omc
        # x**5 as the reference's integer_pow lowers it: x * (x^2)^2
        reflectance = r0 + (1.0 - r0) * (omc * (omc2 * omc2))
        do_reflect = cannot_refract | (reflectance > coin)
        # refract (vec3.rs:96-101) with the total-internal-reflection guard
        rpx = ratio * (udx + cos_theta * nx)
        rpy = ratio * (udy + cos_theta * ny)
        rpz = ratio * (udz + cos_theta * nz)
        s = torch.abs(1.0 - (rpx * rpx + rpy * rpy + rpz * rpz))
        ok = s > 1e-20
        par = -torch.sqrt(torch.where(ok, s, 1.0)) * ok
        rfx = rpx + par * nx
        rfy = rpy + par * ny
        rfz = rpz + par * nz
        dir_x = torch.where(is_diel, torch.where(do_reflect, rlx, rfx), dir_x)
        dir_y = torch.where(is_diel, torch.where(do_reflect, rly, rfy), dir_y)
        dir_z = torch.where(is_diel, torch.where(do_reflect, rlz, rfz), dir_z)
    if scene.has_metal:
        # Metal (material.rs:53-64)
        fx, fy, fz = (c.to(dtype) for c in rngb.in_unit_sphere(
            hashrng.SITE_FUZZ_Z, hashrng.SITE_FUZZ_PHI, hashrng.SITE_FUZZ_R))
        fuzz = tgather(scene.mat_fuzz, mat_id)
        mdx = rlx + fuzz * fx
        mdy = rly + fuzz * fy
        mdz = rlz + fuzz * fz
        metal_ok = (mdx * nx + mdy * ny + mdz * nz) > 0.0
        dir_x = torch.where(is_metal, mdx, dir_x)
        dir_y = torch.where(is_metal, mdy, dir_y)
        dir_z = torch.where(is_metal, mdz, dir_z)

    ar, ag, ab = tex_r, tex_g, tex_b
    if scene.has_metal:
        ar = torch.where(is_metal, tgather(scene.mat_albedo[:, 0], mat_id), ar)
        ag = torch.where(is_metal, tgather(scene.mat_albedo[:, 1], mat_id), ag)
        ab = torch.where(is_metal, tgather(scene.mat_albedo[:, 2], mat_id), ab)
    if scene.has_dielectric:
        one = torch.ones_like(ar)
        ar = torch.where(is_diel, one, ar)
        ag = torch.where(is_diel, one, ag)
        ab = torch.where(is_diel, one, ab)

    scattered = ~is_light
    if scene.has_metal:
        scattered = torch.where(is_metal, metal_ok, scattered)

    # emission (material.rs:114-122): DiffuseLight only, whatever the face
    zero = torch.zeros_like(ar)
    if scene.has_lights:
        er = torch.where(is_light, tex_r, zero)
        eg = torch.where(is_light, tex_g, zero)
        eb = torch.where(is_light, tex_b, zero)
    else:
        er = eg = eb = zero

    return ScatterC(dir_x, dir_y, dir_z, ar, ag, ab, scattered, er, eg, eb)


def scatter_and_emit(scene, rngb, d_in, hit) -> Scatter:
    """Array wrapper over :func:`scatter_and_emit_c` for the ``[..., 3]``
    integrator path; values equal the component path's bit for bit."""
    s = scatter_and_emit_c(
        scene, rngb, d_in[..., 0], d_in[..., 1], d_in[..., 2],
        hit.normal[..., 0], hit.normal[..., 1], hit.normal[..., 2],
        hit.front_face, hit.mat_id, hit.u, hit.v,
        hit.p[..., 0], hit.p[..., 1], hit.p[..., 2])
    return Scatter(
        direction=torch.stack([s.dx, s.dy, s.dz], dim=-1),
        attenuation=torch.stack([s.ar, s.ag, s.ab], dim=-1),
        scattered=s.scattered,
        emitted=torch.stack([s.er, s.eg, s.eb], dim=-1),
    )
