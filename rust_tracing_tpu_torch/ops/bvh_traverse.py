"""Stackless BVH traversal, vectorised over rays: the tensor integrator's
closest hit for scenes compiled with a BVH.

PyTorch counterpart of rust_tracing_tpu/ops/bvh_traverse.py. The reference
renderer traverses its pointer tree recursively per ray, tightening the
search interval with each hit found (src/bvh.rs:91-112). Here every ray walks
the flattened skip-link tree (models/bvh.py) in lockstep, one pointer a
lane: a box hit advances to the next node in preorder (the left child), a
miss jumps the subtree through its skip link, and each leaf's primitive is
tested with the running best t as the window, the stackless form of
bvh.rs:99's ``[min, hit_left.t]`` tightening. The loop runs until every
lane's pointer is past the end.

This is tensor code for the tensor integrator (``render(use_megakernel=
False)``, the direct gradient). The kernels walk their own tree
(ops/megakernel.py::build_kernel_bvh, kernel B4).
"""

from __future__ import annotations

import torch

from ..config import QUAD_DENOM_EPS, T_MIN
from . import linalg as la
from .intersect import BIG, Hit, _rows, _safe_div, _safe_sqrt, assemble_hit
from .tgather import tgather, tgather_group


def _slab_hit(o, inv_d, nmin, nmax, t_lo, t_hi):
    """AABB slab test (aabb.rs:64-84) with per-axis swap, against the
    window [t_lo, t_hi], closed: ``t_max >= t_min`` passes. A quad's box is
    padded to 1e-4 in its flat axis, which in f32 is less than one step of t
    at cornell_box's scale (t ~ 135, step 1.5e-5): entry and exit round to
    the same t. The reference's strict ``t_max > t_min`` then drops the
    quad (its closest_hit_bvh misses 116 of 522 hits of cornell's 24x24
    camera rays, test_torch_bvh.py); the closed test keeps it."""
    t0 = (nmin - o) * inv_d
    t1 = (nmax - o) * inv_d
    near = torch.minimum(t0, t1)
    far = torch.maximum(t0, t1)
    tmn = torch.clamp(torch.amax(near, dim=-1), min=t_lo)
    tmx = torch.minimum(torch.amin(far, dim=-1), t_hi)
    return tmx >= tmn


def _sphere_hit_one(center, cvec, radius, origin, direction, time, t_best):
    """One sphere per ray, its parameters gathered per lane (sphere.rs:
    59-89): t, or inf where the ray misses it inside (T_MIN, t_best)."""
    oc = origin - (center + cvec * time[:, None])
    a = la.length_squared(direction)
    half_b = la.dot(oc, direction)
    c = la.length_squared(oc) - radius * radius
    disc = half_b * half_b - a * c
    sq = _safe_sqrt(disc, disc > 0.0)
    root1 = _safe_div(-half_b - sq, a)
    root2 = _safe_div(-half_b + sq, a)
    ok1 = (root1 > T_MIN) & (root1 < t_best)
    ok2 = (root2 > T_MIN) & (root2 < t_best)
    root = torch.where(ok1, root1, root2)
    return torch.where((disc > 0.0) & (ok1 | ok2), root, BIG)


def _quad_plane(n, d_plane, origin, direction):
    """(denom, t) of the ray against the quad's plane."""
    denom = la.dot(n, direction)
    return denom, _safe_div(d_plane - la.dot(n, origin), denom)


def _quad_uv(w, q, u, v, origin, direction, t):
    """(alpha, beta) of the plane hit at t in the quad's frame."""
    planar = origin + t[:, None] * direction - q
    return (la.dot(w, la.cross(planar, v)), la.dot(w, la.cross(u, planar)))


def _quad_hit_one(n, d_plane, w, q, u, v, origin, direction, t_best):
    """One quad per ray (quad.rs:96-133): t, or inf where the ray misses it
    inside [T_MIN, t_best] (the reference's ``t <= t_best`` here)."""
    denom, t = _quad_plane(n, d_plane, origin, direction)
    alpha, beta = _quad_uv(w, q, u, v, origin, direction, t)
    valid = ((torch.abs(denom) >= QUAD_DENOM_EPS)
             & (t >= T_MIN) & (t <= t_best)
             & (alpha >= 0.0) & (alpha <= 1.0)
             & (beta >= 0.0) & (beta <= 1.0))
    return torch.where(valid, t, BIG)


def traverse(scene, origin, direction, time):
    """Walk the BVH for a flat ray batch (no gradient is recorded).

    Returns (t_best, type_best, idx_best): type -1 miss, 0 sphere, 1 quad.
    A later primitive replaces the best only with a strictly smaller t."""
    with torch.no_grad():
        R = origin.shape[0]
        N = scene.bvh_skip.shape[0]
        dev = origin.device
        inv_d = _safe_div(torch.ones_like(direction), direction)
        normal, d_plane, w = scene.quad_frame()
        ptr = torch.zeros(R, dtype=torch.int64, device=dev)
        t_best = torch.full_like(time, BIG)
        ty_best = torch.full((R,), -1, dtype=torch.int32, device=dev)
        ix_best = torch.zeros(R, dtype=torch.int32, device=dev)
        while bool((ptr < N).any()):
            active = ptr < N
            pc = torch.clamp(ptr, max=N - 1)
            ptype = scene.bvh_ptype[pc]
            pidx = scene.bvh_pidx[pc].long()
            box_hit = active & _slab_hit(origin, inv_d, scene.bvh_min[pc],
                                         scene.bvh_max[pc], T_MIN, t_best)
            si = torch.where(ptype == 0, pidx, 0)
            qi = torch.where(ptype == 1, pidx, 0)
            t_s = _sphere_hit_one(scene.sph_center[si], scene.sph_cvec[si],
                                  scene.sph_radius[si], origin, direction,
                                  time, t_best)
            t_q = _quad_hit_one(normal[qi], d_plane[qi], w[qi],
                                scene.quad_q[qi], scene.quad_u[qi],
                                scene.quad_v[qi], origin, direction, t_best)
            t_cand = torch.where(box_hit & (ptype == 0), t_s,
                                 torch.where(box_hit & (ptype == 1), t_q,
                                             BIG))
            better = t_cand < t_best
            t_best = torch.where(better, t_cand, t_best)
            ty_best = torch.where(better, ptype, ty_best)
            ix_best = torch.where(better, pidx.to(torch.int32), ix_best)
            ptr = torch.where(active, torch.where(
                box_hit, ptr + 1, scene.bvh_skip[pc].long()), ptr)
    return t_best, ty_best, ix_best


def closest_hit_bvh(scene, origin, direction, time, rngb) -> Hit:
    """BVH replacement for intersect.closest_hit (the same winners, up to
    exact ties, which the tree may visit in another order).

    The walk is a discrete search and runs detached (``traverse``); the
    winner's t, and a quad winner's (alpha, beta), are then recomputed from
    its parameters gathered through ``tgather``, O(R) and differentiable,
    against a window just past the t found."""
    t_sg, ty_best, ix_best = traverse(scene, origin.detach(),
                                      direction.detach(), time.detach())
    sph_win = ty_best == 0
    quad_win = ty_best == 1
    i_sph = torch.where(sph_win, ix_best, 0)
    i_quad = torch.where(quad_win, ix_best, 0)

    window = torch.where(torch.isfinite(t_sg), t_sg * (1 + 1e-5) + 1e-5, BIG)
    t_s = _sphere_hit_one(_rows(scene.sph_center, i_sph),
                          _rows(scene.sph_cvec, i_sph),
                          tgather(scene.sph_radius, i_sph), origin, direction,
                          time, window)
    normal, d_plane, w = scene.quad_frame()
    cols = tgather_group(
        tuple(normal.unbind(1)) + (d_plane,) + tuple(w.unbind(1))
        + tuple(scene.quad_q.unbind(1)) + tuple(scene.quad_u.unbind(1))
        + tuple(scene.quad_v.unbind(1)), i_quad)
    nw, dw, ww, qw, uw, vw = (torch.stack(cols[0:3], dim=-1), cols[3],
                              torch.stack(cols[4:7], dim=-1),
                              torch.stack(cols[7:10], dim=-1),
                              torch.stack(cols[10:13], dim=-1),
                              torch.stack(cols[13:16], dim=-1))
    t_q = _quad_hit_one(nw, dw, ww, qw, uw, vw, origin, direction, window)
    t_sph = torch.where(sph_win, t_s, BIG)
    t_quad = torch.where(quad_win, t_q, BIG)

    # the winning quad's (alpha, beta) for its UV (quad.rs:131)
    t_w = torch.where(quad_win, t_q, torch.where(sph_win, t_s, 0.0))
    alpha, beta = _quad_uv(ww, qw, uw, vw, origin, direction, t_w)
    return assemble_hit(scene, origin, direction, time, rngb,
                        t_sph, i_sph, t_quad, i_quad, alpha, beta)


def auto_closest_hit(scene):
    """The closest-hit function of a compiled scene: ``closest_hit_bvh``
    for a scene with a BVH, else None (the integrator's brute force)."""
    return closest_hit_bvh if scene.has_bvh else None
