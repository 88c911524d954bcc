"""Closest hit: brute-force sphere, quad and constant-medium intersection.

PyTorch counterpart of rust_tracing_tpu/ops/intersect.py: each primitive
type is intersected as one batched tensor op over (rays x primitives) and
the winner is a masked argmin. Constant media (src/constant_medium.rs:34-71)
use closed-form entry/exit of their convex boundaries.

Autodiff structure, as in the reference: the (rays x primitives) search,
which primitive wins and which root is taken, is piecewise constant in the
scene parameters, so it runs under ``torch.no_grad()``, which records no
graph for it.
The winner's t, hit point, normal and UV are then recomputed from the live
tensors, O(rays), with its parameters gathered through ``tgather``. The
backward pass never holds or transposes the (rays x primitives) broadcast.

Semantics preserved from the reference: t_min = 0.001 (renderer.rs:144);
near root then far root with strict bounds (sphere.rs:59-89); quad
parallel-ray rejection |denom| < 1e-8, inclusive [0,1]^2 inside test, no
back-face culling (quad.rs:96-133); moving centre lerped by ray time; sphere
UV from the outward normal (sphere.rs:48-52), quad UV = (alpha, beta); the
normal flipped toward the ray with front_face recorded (hittable.rs:22-37).
Every 3-component contraction is an explicit multiply-add (ops/linalg.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import QUAD_DENOM_EPS, T_MIN
from . import hashrng
from . import linalg as la
from .tgather import tgather, tgather_group

BIG = math.inf


class Hit(NamedTuple):
    """Vectorized HitRecord (reference: src/hittable.rs:11-19)."""

    hit: torch.Tensor  # (R,) bool: any surface or medium hit
    t: torch.Tensor  # (R,)
    p: torch.Tensor  # (R,3)
    normal: torch.Tensor  # (R,3), flipped toward the ray
    front_face: torch.Tensor  # (R,) bool
    mat_id: torch.Tensor  # (R,) int32
    u: torch.Tensor  # (R,)
    v: torch.Tensor  # (R,)
    is_surface: torch.Tensor  # (R,) bool: False for medium scatter events


def _full(like, value):
    return torch.full_like(like, value)


def _safe_div(a, b, eps=1e-30):
    return a / torch.where(torch.abs(b) < eps,
                           torch.where(b < 0, _full(b, -eps), _full(b, eps)),
                           b)


def _safe_sqrt(x, valid):
    """sqrt with NaN-free gradients: lanes where ``valid`` is False compute
    sqrt(1), so reverse mode never meets d/dx sqrt(0) = inf through the
    unselected branch of a ``where``."""
    return torch.sqrt(torch.where(valid, x, 1.0))


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for an (n, 3) table as (R, 3), through one packed
    differentiable gather."""
    return torch.stack(tgather_group(tuple(table.unbind(1)), idx), dim=-1)


def _take(arr, idx):
    return torch.gather(arr, 1, idx[:, None].long())[:, 0]


def sphere_closest(scene, origin, direction, time, t_max):
    """Closest valid sphere hit per ray -> (t (R,), idx (R,) int32), t = inf
    where no sphere is hit (reference: src/sphere.rs:59-89 with the
    moving-centre lerp)."""
    with torch.no_grad():
        o_, d_, t_ = origin, direction, time
        center_t = (scene.sph_center[None, :, :]
                    + scene.sph_cvec[None, :, :] * t_[:, None, None])
        oc = o_[:, None, :] - center_t
        a = la.length_squared(d_)[:, None]
        half_b = la.dot(oc, d_[:, None, :])
        r = scene.sph_radius
        c = la.length_squared(oc) - (r * r)[None, :]
        disc = half_b * half_b - a * c
        sqrtd = _safe_sqrt(disc, disc > 0.0)
        root1 = _safe_div(-half_b - sqrtd, a)
        root2 = _safe_div(-half_b + sqrtd, a)
        # strict `surrounds` (interval.rs:44-46, used by sphere.rs:77-83)
        ok1 = (root1 > T_MIN) & (root1 < t_max[:, None])
        ok2 = (root2 > T_MIN) & (root2 < t_max[:, None])
        root = torch.where(ok1, root1, root2)
        valid = (disc > 0.0) & (ok1 | ok2) & scene.sph_valid[None, :]
        t = torch.where(valid, root, BIG)
        idx = torch.argmin(t, dim=-1).to(torch.int32)
        has_hit = _take(valid, idx)
        far_root = ~_take(ok1, idx)

    # differentiable O(R) recompute of the winner's t
    cw = (_rows(scene.sph_center, idx)
          + _rows(scene.sph_cvec, idx) * time[:, None])
    ocw = origin - cw
    aw = la.length_squared(direction)
    hbw = la.dot(ocw, direction)
    rw = tgather(scene.sph_radius, idx)
    cwq = la.length_squared(ocw) - rw * rw
    discw = hbw * hbw - aw * cwq
    sqw = _safe_sqrt(discw, has_hit & (discw > 0))
    sign = torch.where(far_root, _full(sqw, 1.0), _full(sqw, -1.0))
    t_w = _safe_div(-hbw + sign * sqw, aw)
    t_best = torch.where(has_hit, t_w, BIG)
    return t_best, idx


def quad_closest(scene, origin, direction, time, t_max):
    """Closest valid quad hit per ray -> (t, idx, alpha, beta), t = inf on a
    miss (reference: src/quad.rs:96-133)."""
    normal, d_plane, w = scene.quad_frame()
    with torch.no_grad():
        n_, dp_, w_ = normal, d_plane, w
        o_, d_ = origin, direction
        denom = la.dot(n_[None, :, :], d_[:, None, :])
        n_dot_o = la.dot(n_[None, :, :], o_[:, None, :])
        t = _safe_div(dp_[None, :] - n_dot_o, denom)
        p = o_[:, None, :] + t[..., None] * d_[:, None, :]
        planar = p - scene.quad_q[None, :, :]
        alpha = la.dot(w_[None, :, :],
                       la.cross(planar, scene.quad_v[None, :, :]))
        beta = la.dot(w_[None, :, :],
                      la.cross(scene.quad_u[None, :, :], planar))
        # inclusive `contains` (interval.rs:41-43, used by quad.rs:115)
        valid = ((torch.abs(denom) >= QUAD_DENOM_EPS)
                 & (t >= T_MIN) & (t <= t_max[:, None])
                 & (alpha >= 0.0) & (alpha <= 1.0)
                 & (beta >= 0.0) & (beta <= 1.0)
                 & scene.quad_valid[None, :])
        t = torch.where(valid, t, BIG)
        idx = torch.argmin(t, dim=-1).to(torch.int32)
        has_hit = _take(valid, idx)

    # differentiable O(R) recompute for the winning quad: one packed gather
    cols = tgather_group(
        tuple(normal.unbind(1)) + (d_plane,) + tuple(w.unbind(1))
        + tuple(scene.quad_q.unbind(1)) + tuple(scene.quad_u.unbind(1))
        + tuple(scene.quad_v.unbind(1)), idx)
    nw = torch.stack(cols[0:3], dim=-1)
    dw = cols[3]
    ww = torch.stack(cols[4:7], dim=-1)
    qw = torch.stack(cols[7:10], dim=-1)
    uw = torch.stack(cols[10:13], dim=-1)
    vw = torch.stack(cols[13:16], dim=-1)
    denw = la.dot(nw, direction)
    tw = _safe_div(dw - la.dot(nw, origin), denw)
    pw = origin + tw[:, None] * direction
    plw = pw - qw
    alw = la.dot(ww, la.cross(plw, vw))
    bew = la.dot(ww, la.cross(uw, plw))
    t_best = torch.where(has_hit, tw, BIG)
    return t_best, idx, alw, bew


def medium_candidates(scene, origin, direction, time, t_surf, rngb):
    """Stochastic scatter candidates of every constant medium
    (reference: src/constant_medium.rs:34-71): entry/exit of the convex
    boundary, entry clamped to t_min, exit clamped to the closest surface,
    exponential free flight. Medium ``i`` draws at site ``SITE_MEDIUM + i``
    of the per-bounce RNG ``rngb``. Returns (t (R,), mat (R,) int32), t = inf
    where no medium scatters."""
    t = medium_scatter_t(scene, origin, direction, t_surf, rngb)
    idx = torch.argmin(t, dim=-1).to(torch.int32)
    return _take(t, idx), tgather(scene.med_mat, idx)


def medium_scatter_t(scene, origin, direction, t_surf, rngb):
    """(R, M) scatter t of every ray in every medium (inf where it does not
    scatter there): the candidates ``medium_candidates`` takes the nearest
    of, and whose argmin replay.record_from_hitfn records."""
    M = scene.med_neg_inv_density.shape[0]
    dtype = origin.dtype

    # sphere boundaries: both quadratic roots
    oc = origin[:, None, :] - scene.med_sph_center[None, :, :]
    a = la.length_squared(direction)[:, None]
    half_b = la.dot(oc, direction[:, None, :])
    rad = scene.med_sph_radius
    c = la.length_squared(oc) - (rad * rad)[None, :]
    disc = half_b * half_b - a * c
    sqrtd = _safe_sqrt(disc, disc > 0.0)
    s_entry = _safe_div(-half_b - sqrtd, a)
    s_exit = _safe_div(-half_b + sqrtd, a)
    s_ok = disc > 0.0

    # box boundaries: slab test in the boundary's local frame
    o_rel = origin[:, None, :] - scene.med_trans[None, :, :]  # (R,M,3)
    rot = scene.med_rot[None, :, :, :]
    o_l = la.dot(rot, o_rel[:, :, None, :])                   # (R,M,3)
    d_l = la.dot(rot, direction[:, None, None, :])
    inv_d = _safe_div(torch.ones_like(d_l), d_l)
    t0 = (scene.med_lo[None, :, :] - o_l) * inv_d
    t1 = (scene.med_hi[None, :, :] - o_l) * inv_d
    b_entry = torch.amax(torch.minimum(t0, t1), dim=-1)
    b_exit = torch.amin(torch.maximum(t0, t1), dim=-1)
    b_ok = b_entry < b_exit

    is_box = scene.med_type[None, :] == 1
    entry = torch.where(is_box, b_entry, s_entry)
    exit_ = torch.where(is_box, b_exit, s_exit)
    ok = torch.where(is_box, b_ok, s_ok) & scene.med_valid[None, :]

    entry = torch.clamp(entry, min=T_MIN)
    exit_ = torch.minimum(exit_, t_surf[:, None])
    ok = ok & (entry < exit_)

    ray_len = la.length(direction)[:, None]
    dist_inside = (exit_ - entry) * ray_len
    u = torch.stack([rngb.uniform(hashrng.SITE_MEDIUM + i) for i in range(M)],
                    dim=-1).to(dtype)
    u = torch.clamp(u, min=1e-12)
    hit_dist = scene.med_neg_inv_density[None, :] * torch.log(u)
    ok = ok & (hit_dist <= dist_inside)

    return torch.where(ok, entry + hit_dist / ray_len, BIG)


def _sphere_uv(n):
    """reference: src/sphere.rs:48-52. Pole and axis-degenerate lanes are
    where-guarded so gradients stay finite (acos'(+-1) and atan2(0, 0))."""
    y = torch.clamp(-n[..., 1], -1.0, 1.0)
    interior = torch.abs(y) < 1.0 - 1e-7
    theta = torch.where(interior, torch.acos(torch.where(interior, y, 0.0)),
                        torch.where(y > 0, _full(y, 0.0), _full(y, math.pi)))
    xz_deg = (torch.abs(n[..., 0]) + torch.abs(n[..., 2])) < 1e-12
    phi = torch.where(
        xz_deg, 0.0,
        torch.atan2(torch.where(xz_deg, 0.0, -n[..., 2]),
                    torch.where(xz_deg, 1.0, n[..., 0]))) + math.pi
    return phi / (2.0 * math.pi), theta / math.pi


def closest_hit(scene, origin, direction, time, rngb) -> Hit:
    """Full closest-hit query: spheres, quads and constant media, brute
    force (the reference's ``world.hit(r, (0.001, inf))``, renderer.rs:144):
    surfaces first, then medium candidates clamped by the surface hit."""
    R = origin.shape[0]
    t_max0 = torch.full((R,), BIG, dtype=origin.dtype, device=origin.device)
    t_sph, i_sph = sphere_closest(scene, origin, direction, time, t_max0)
    t_quad, i_quad, alpha, beta = quad_closest(scene, origin, direction, time,
                                               t_max0)
    return assemble_hit(scene, origin, direction, time, rngb,
                        t_sph, i_sph, t_quad, i_quad, alpha, beta)


def assemble_hit(scene, origin, direction, time, rngb,
                 t_sph, i_sph, t_quad, i_quad, alpha, beta) -> Hit:
    """Combine the per-type winners with media sampling into a Hit."""
    t_surf = torch.minimum(t_sph, t_quad)
    t_med, med_mat = medium_candidates(scene, origin, direction, time, t_surf,
                                       rngb)

    # a medium wins iff strictly closer than the surface winner (its
    # candidate is already clamped to the surface window)
    med_wins = t_med < t_surf
    sph_wins = (~med_wins) & (t_sph <= t_quad) & torch.isfinite(t_sph)
    quad_wins = (~med_wins) & (~sph_wins) & torch.isfinite(t_quad)
    any_hit = med_wins | sph_wins | quad_wins

    t = torch.where(med_wins, t_med, torch.where(sph_wins, t_sph, t_quad))
    t = torch.where(any_hit, t, torch.zeros_like(t))  # finite grads on a miss
    p = la.ray_at(origin, direction, t)

    # sphere attributes of the winners
    c_best = _rows(scene.sph_center, i_sph) + _rows(scene.sph_cvec, i_sph) \
        * time[:, None]
    r_best = torch.clamp(tgather(scene.sph_radius, i_sph), min=1e-12)
    sph_outward = (p - c_best) / r_best[:, None]
    sph_u, sph_v = _sphere_uv(sph_outward)

    # quad attributes of the winners
    normal_all, _, _ = scene.quad_frame()
    quad_outward = _rows(normal_all, i_quad)

    outward = torch.where(sph_wins[:, None], sph_outward, quad_outward)
    # a medium's outward normal is the ray direction (constant_medium.rs:
    # 50-58): front_face false, normal = -direction
    outward = torch.where(med_wins[:, None], direction, outward)

    front_face = la.dot(direction, outward) < 0.0  # hittable.rs:22-37
    normal = torch.where(front_face[:, None], outward, -outward)

    u = torch.where(sph_wins, sph_u, torch.where(quad_wins, alpha, 0.0))
    v = torch.where(sph_wins, sph_v, torch.where(quad_wins, beta, 0.0))

    mat_id = torch.where(
        med_wins, med_mat,
        torch.where(sph_wins, tgather(scene.sph_mat, i_sph),
                    tgather(scene.quad_mat, i_quad))).to(torch.int32)

    return Hit(hit=any_hit, t=t, p=p, normal=normal, front_face=front_face,
               mat_id=mat_id, u=u, v=v, is_surface=~med_wins)
