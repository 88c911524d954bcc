"""Search-free differentiable path replay from recorded hit winners.

PyTorch counterpart of rust_tracing_tpu/ops/replay.py. The expensive part of
differentiable rendering is re-running the (rays x primitives) closest-hit
search under autodiff, yet the search is piecewise constant in the scene
parameters: its only output that matters is WHICH primitive won. So:

  1. **Record** (not differentiable): the recorder kernel
     (ops/megakernel.record_paths) traces the paths and writes one packed
     int32 per (pixel, sample, bounce), the winner's kind and index.
     ``records_xla`` produces the same records with the tensor search.
  2. **Replay** (differentiable, O(rays)): every continuous quantity (winner
     t, hit point, normal, UV, medium scatter distance, scatter directions,
     attenuations, emission) is re-derived from the recorded winner's
     parameters and the same counter-RNG draws, with no search.

Both passes address randomness by (seed, pixel, sample, bounce, site), so the
replay reproduces the direct estimator and its gradient is the same
detached-discrete gradient.

Record encoding (int32): kind * 2^24 + idx, with kind 0 = miss, 1 = sphere,
2 = quad, 3 + m = constant medium m.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import T_MIN
from . import hashrng, intersect
from . import linalg as la
from .materials import scatter_and_emit, scatter_and_emit_c
from .tgather import tgather, tgather_group

KIND_MISS = 0
KIND_SPHERE = 1
KIND_QUAD = 2
KIND_MEDIUM = 3  # kind = KIND_MEDIUM + medium index
_IDX_BITS = 24
_IDX_MASK = (1 << _IDX_BITS) - 1


def pack_record(kind, idx):
    return ((kind.to(torch.int32) << _IDX_BITS)
            | (idx.to(torch.int32) & _IDX_MASK))


def unpack_record(rec):
    return rec >> _IDX_BITS, rec & _IDX_MASK


def record_from_hitfn(scene, origin, direction, time, rngb, hit_fn=None):
    """One bounce's records through the tensor search (the CPU oracle of
    the recorder kernel). As in the reference, the winner is classified by
    the brute-force per-type search whatever ``hit_fn`` is; ``hit_fn`` is
    accepted for the reference's signature and not evaluated (the
    reference's result of it is dead code too)."""
    with torch.no_grad():  # records are data: nothing here is tracked
        sc, o, d, t = scene, origin, direction, time
        # classify the winner the way assemble_hit does: medium/sphere/quad
        big = torch.full_like(t, intersect.BIG)
        t_sph, i_sph = intersect.sphere_closest(sc, o, d, t, big)
        t_quad, i_quad, _, _ = intersect.quad_closest(sc, o, d, t, big)
        t_surf = torch.minimum(t_sph, t_quad)
        if scene.has_media:
            t_med, _ = intersect.medium_candidates(sc, o, d, t, t_surf, rngb)
            med_wins = t_med < t_surf
            med_idx = _winning_medium(sc, o, d, t, t_surf, rngb)
        else:
            med_wins = torch.zeros(t.shape, dtype=torch.bool, device=t.device)
            med_idx = torch.zeros(t.shape, dtype=torch.int32, device=t.device)
        sph_wins = (~med_wins) & (t_sph <= t_quad) & torch.isfinite(t_sph)
        quad_wins = (~med_wins) & (~sph_wins) & torch.isfinite(t_quad)
        kind = torch.where(
            med_wins, KIND_MEDIUM + med_idx,
            torch.where(sph_wins, KIND_SPHERE,
                        torch.where(quad_wins, KIND_QUAD, KIND_MISS)))
        idx = torch.where(sph_wins, i_sph, torch.where(quad_wins, i_quad, 0))
        return pack_record(kind, idx)


def _winning_medium(scene, origin, direction, time, t_surf, rngb):
    """Index of the medium with the smallest valid scatter t (the argmin of
    intersect.medium_candidates)."""
    t = intersect.medium_scatter_t(scene, origin, direction, t_surf, rngb)
    return torch.argmin(t, dim=-1).to(torch.int32)


class HitC(NamedTuple):
    """Component-form hit record: dense (R,) lanes."""

    hit: torch.Tensor
    t: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    nx: torch.Tensor
    ny: torch.Tensor
    nz: torch.Tensor
    front_face: torch.Tensor
    mat_id: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    is_surface: torch.Tensor


def _sphere_uv_c(nx, ny, nz):
    """Component form of intersect._sphere_uv (sphere.rs:48-52) with the same
    pole and axis guards."""
    y = torch.clamp(-ny, -1.0, 1.0)
    interior = torch.abs(y) < 1.0 - 1e-7
    theta = torch.where(
        interior, torch.acos(torch.where(interior, y, 0.0)),
        torch.where(y > 0, torch.zeros_like(y), torch.full_like(y, math.pi)))
    xz_deg = (torch.abs(nx) + torch.abs(nz)) < 1e-12
    phi = torch.where(
        xz_deg, 0.0,
        torch.atan2(torch.where(xz_deg, 0.0, -nz),
                    torch.where(xz_deg, 1.0, nx))) + math.pi
    return phi / (2.0 * math.pi), theta / math.pi


def hit_from_record_c(scene, ox, oy, oz, dx, dy, dz, time, rngb,
                      rec) -> HitC:
    """Differentiable O(R) component-form hit reconstruction of recorded
    winners."""
    kind, idx = unpack_record(rec)
    is_sph = kind == KIND_SPHERE
    is_quad = kind == KIND_QUAD
    is_med = kind >= KIND_MEDIUM
    med_idx = torch.where(is_med, kind - KIND_MEDIUM, 0)
    any_hit = kind != KIND_MISS

    i_sph = torch.where(is_sph, idx, 0)
    i_quad = torch.where(is_quad, idx, 0)

    a = dx * dx + dy * dy + dz * dz
    zero = torch.zeros_like(ox)
    dtype = ox.dtype

    # sphere winner t (near root if valid else far; sphere.rs:59-89), pruned
    # when the scene has no spheres
    if scene.has_spheres:
        # one packed gather of every sphere column, the material id riding
        # along as a detached float (ids below 2^24 round-trip exactly)
        c0x, c0y, c0z, cvx, cvy, cvz, r_s, mat_sph_f = tgather_group(
            (scene.sph_center[:, 0], scene.sph_center[:, 1],
             scene.sph_center[:, 2], scene.sph_cvec[:, 0],
             scene.sph_cvec[:, 1], scene.sph_cvec[:, 2], scene.sph_radius,
             scene.sph_mat.to(dtype).detach()),
            i_sph)
        cwx = c0x + cvx * time
        cwy = c0y + cvy * time
        cwz = c0z + cvz * time
        ocx, ocy, ocz = ox - cwx, oy - cwy, oz - cwz
        hb = ocx * dx + ocy * dy + ocz * dz
        cq = ocx * ocx + ocy * ocy + ocz * ocz - r_s * r_s
        disc = hb * hb - a * cq
        sq = intersect._safe_sqrt(disc, is_sph & (disc > 0))
        r1 = intersect._safe_div(-hb - sq, a)
        r2 = intersect._safe_div(-hb + sq, a)
        t_s = torch.where(r1 > T_MIN, r1, r2)
    else:
        cwx = cwy = cwz = zero
        r_s = zero
        t_s = zero

    # quad winner t, alpha, beta (quad.rs:96-133), pruned likewise
    if scene.has_quads:
        normal_all, d_plane, w_all = scene.quad_frame()
        (nwx, nwy, nwz, dpl, qqx, qqy, qqz, qux, quy, quz,
         qvx, qvy, qvz, wx, wy, wz, mat_quad_f) = tgather_group(
            (normal_all[:, 0], normal_all[:, 1], normal_all[:, 2], d_plane,
             scene.quad_q[:, 0], scene.quad_q[:, 1], scene.quad_q[:, 2],
             scene.quad_u[:, 0], scene.quad_u[:, 1], scene.quad_u[:, 2],
             scene.quad_v[:, 0], scene.quad_v[:, 1], scene.quad_v[:, 2],
             w_all[:, 0], w_all[:, 1], w_all[:, 2],
             scene.quad_mat.to(dtype).detach()),
            i_quad)
        denw = nwx * dx + nwy * dy + nwz * dz
        t_q = intersect._safe_div(dpl - (nwx * ox + nwy * oy + nwz * oz),
                                  denw)
        plx = ox + t_q * dx - qqx
        ply = oy + t_q * dy - qqy
        plz = oz + t_q * dz - qqz
        alpha = (wx * (ply * qvz - plz * qvy) + wy * (plz * qvx - plx * qvz)
                 + wz * (plx * qvy - ply * qvx))
        beta = (wx * (quy * plz - quz * ply) + wy * (quz * plx - qux * plz)
                + wz * (qux * ply - quy * plx))
    else:
        nwx = nwy = nwz = zero
        t_q = alpha = beta = zero
        mat_quad_f = zero

    # medium winner t (constant_medium.rs:34-71, recorded medium only),
    # pruned for scenes without media
    if scene.has_media:
        t_m = _medium_t_c(scene, ox, oy, oz, dx, dy, dz, a, rngb, med_idx)
    else:
        t_m = torch.zeros_like(t_s)

    t = torch.where(is_med, t_m, torch.where(is_sph, t_s,
                                             torch.where(is_quad, t_q, 0.0)))
    px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz

    if scene.has_spheres:
        # division (not a reciprocal multiply), as the direct path's
        # assemble_hit, so replay and direct agree bit for bit
        r_best = torch.clamp(r_s, min=1e-12)
        sox = (px - cwx) / r_best
        soy = (py - cwy) / r_best
        soz = (pz - cwz) / r_best
        sph_u, sph_v = _sphere_uv_c(sox, soy, soz)
    else:
        sox = soy = soz = zero
        sph_u = sph_v = zero

    outx = torch.where(is_med, dx, torch.where(is_sph, sox, nwx))
    outy = torch.where(is_med, dy, torch.where(is_sph, soy, nwy))
    outz = torch.where(is_med, dz, torch.where(is_sph, soz, nwz))
    front_face = (dx * outx + dy * outy + dz * outz) < 0.0
    sign = torch.where(front_face, torch.ones_like(outx),
                       torch.full_like(outx, -1.0))
    nx, ny, nz = sign * outx, sign * outy, sign * outz

    u = torch.where(is_sph, sph_u, torch.where(is_quad, alpha, 0.0))
    v = torch.where(is_sph, sph_v, torch.where(is_quad, beta, 0.0))
    mat_sph = (mat_sph_f.to(torch.int32) if scene.has_spheres else i_sph)
    mat_quad = (mat_quad_f.to(torch.int32) if scene.has_quads else i_quad)
    mat_id = torch.where(
        is_med, tgather(scene.med_mat, med_idx),
        torch.where(is_sph, mat_sph, mat_quad)).to(torch.int32)

    return HitC(hit=any_hit, t=t, px=px, py=py, pz=pz, nx=nx, ny=ny, nz=nz,
                front_face=front_face, mat_id=mat_id, u=u, v=v,
                is_surface=~is_med)


def hit_from_record(scene, origin, direction, time, rngb,
                    rec) -> intersect.Hit:
    """Array wrapper over :func:`hit_from_record_c`."""
    h = hit_from_record_c(scene, origin[:, 0], origin[:, 1], origin[:, 2],
                          direction[:, 0], direction[:, 1], direction[:, 2],
                          time, rngb, rec)
    return intersect.Hit(
        hit=h.hit, t=h.t, p=torch.stack([h.px, h.py, h.pz], dim=-1),
        normal=torch.stack([h.nx, h.ny, h.nz], dim=-1),
        front_face=h.front_face, mat_id=h.mat_id, u=h.u, v=h.v,
        is_surface=h.is_surface)


def _medium_t_c(scene, ox, oy, oz, dx, dy, dz, a, rngb, med_idx):
    """The recorded medium's scatter t, component form: entry of its
    boundary plus the exponential free flight. The recorder already made sure
    the scatter point lies before the surface."""
    orx = ox - tgather(scene.med_trans[:, 0], med_idx)
    ory = oy - tgather(scene.med_trans[:, 1], med_idx)
    orz = oz - tgather(scene.med_trans[:, 2], med_idx)
    rot = scene.med_rot.reshape(-1, 9)
    b_entry = torch.full_like(ox, -math.inf)
    b_exit = torch.full_like(ox, math.inf)
    for ax in range(3):
        r0 = tgather(rot[:, 3 * ax + 0], med_idx)
        r1 = tgather(rot[:, 3 * ax + 1], med_idx)
        r2 = tgather(rot[:, 3 * ax + 2], med_idx)
        o_l = r0 * orx + r1 * ory + r2 * orz
        d_l = r0 * dx + r1 * dy + r2 * dz
        inv_d = intersect._safe_div(torch.ones_like(d_l), d_l)
        t0 = (tgather(scene.med_lo[:, ax], med_idx) - o_l) * inv_d
        t1 = (tgather(scene.med_hi[:, ax], med_idx) - o_l) * inv_d
        b_entry = torch.maximum(b_entry, torch.minimum(t0, t1))
        b_exit = torch.minimum(b_exit, torch.maximum(t0, t1))

    mcx = ox - tgather(scene.med_sph_center[:, 0], med_idx)
    mcy = oy - tgather(scene.med_sph_center[:, 1], med_idx)
    mcz = oz - tgather(scene.med_sph_center[:, 2], med_idx)
    half_b = mcx * dx + mcy * dy + mcz * dz
    rad = tgather(scene.med_sph_radius, med_idx)
    c = mcx * mcx + mcy * mcy + mcz * mcz - rad * rad
    disc = half_b * half_b - a * c
    sq = intersect._safe_sqrt(disc, disc > 0)
    s_entry = intersect._safe_div(-half_b - sq, a)

    is_box = tgather(scene.med_type, med_idx) == 1
    entry = torch.clamp(torch.where(is_box, b_entry, s_entry), min=T_MIN)

    ray_len = torch.sqrt(a)
    # the same draw the search consumed for this medium (site SITE_MEDIUM+m),
    # selected over the scene's (small) medium count
    M = scene.med_neg_inv_density.shape[0]
    u = torch.zeros_like(entry)
    for m in range(M):
        u = torch.where(med_idx == m, rngb.uniform(hashrng.SITE_MEDIUM + m)
                        .to(entry.dtype), u)
    u = torch.clamp(u, min=1e-12)
    hd = tgather(scene.med_neg_inv_density, med_idx) * torch.log(u)
    return entry + hd / torch.clamp(ray_len, min=1e-30)


def bounce_c(scene, rngb, rec, ox, oy, oz, dx, dy, dz, time,
             tr, tg, tb, rr, rg, rb, alive):
    """One replay bounce in component form: reconstruct the recorded winner,
    shade, advance the path. Returns (ox, oy, oz, dx, dy, dz, tr, tg, tb, rr,
    rg, rb, scat) where ``scat`` is the lane's aliveness after the bounce."""
    h = hit_from_record_c(scene, ox, oy, oz, dx, dy, dz, time, rngb, rec)

    miss = alive & ~h.hit
    bg_r, bg_g, bg_b = (scene.background[0], scene.background[1],
                        scene.background[2])
    rr = rr + torch.where(miss, tr * bg_r, 0.0)
    rg = rg + torch.where(miss, tg * bg_g, 0.0)
    rb = rb + torch.where(miss, tb * bg_b, 0.0)

    s = scatter_and_emit_c(scene, rngb, dx, dy, dz,
                           h.nx, h.ny, h.nz, h.front_face, h.mat_id,
                           h.u, h.v, h.px, h.py, h.pz)
    live_hit = alive & h.hit
    rr = rr + torch.where(live_hit, tr * s.er, 0.0)
    rg = rg + torch.where(live_hit, tg * s.eg, 0.0)
    rb = rb + torch.where(live_hit, tb * s.eb, 0.0)

    scat = live_hit & s.scattered
    tr = torch.where(scat, tr * s.ar, tr)
    tg = torch.where(scat, tg * s.ag, tg)
    tb = torch.where(scat, tb * s.ab, tb)

    # f32 origin offset (see ops/integrator.py), media excluded
    side = torch.sign(s.dx * h.nx + s.dy * h.ny + s.dz * h.nz)
    scale = torch.maximum(torch.abs(h.px),
                          torch.maximum(torch.abs(h.py), torch.abs(h.pz)))
    eps = 1e-4 + 2e-4 * scale
    off = torch.where(h.is_surface, side * eps, 0.0)
    ox = torch.where(scat, h.px + off * h.nx, ox)
    oy = torch.where(scat, h.py + off * h.ny, oy)
    oz = torch.where(scat, h.pz + off * h.nz, oz)
    dx = torch.where(scat, s.dx, dx)
    dy = torch.where(scat, s.dy, dy)
    dz = torch.where(scat, s.dz, dz)
    return ox, oy, oz, dx, dy, dz, tr, tg, tb, rr, rg, rb, scat


def trace_replay(scene, origin, direction, time, rng_idx, records,
                 max_depth: int):
    """Search-free differentiable counterpart of integrator.trace: the hits
    of bounce ``d`` come from ``records[d]`` ((max_depth, R) int32) instead of
    a scene search. Component form throughout: 14 dense (R,) lanes.

    The reference wraps each bounce in a checkpoint with a save-the-RNG
    policy; the port keeps every bounce's tensors for the backward pass
    (its per-sample-chunk checkpoint in grad.py bounds them to one chunk),
    which changes no value.

    Returns (radiance (R,3), scene queries (R,) int32) like
    integrator.trace."""
    seed, pixel_ids, sample = rng_idx
    ox, oy, oz = origin[:, 0], origin[:, 1], origin[:, 2]
    dx, dy, dz = direction[:, 0], direction[:, 1], direction[:, 2]
    one = torch.ones_like(ox)
    zero = torch.zeros_like(ox)
    tr = tg = tb = one
    rr = rg = rb = zero
    alive = time < torch.inf
    nb = torch.zeros(time.shape, dtype=torch.int32, device=time.device)
    for depth_i in range(max_depth):
        rngb = hashrng.CounterRng(seed, pixel_ids, sample, depth_i,
                                  device=ox.device)
        nb = nb + alive.to(torch.int32)
        (ox, oy, oz, dx, dy, dz, tr, tg, tb, rr, rg, rb, alive) = bounce_c(
            scene, rngb, records[depth_i], ox, oy, oz, dx, dy, dz, time,
            tr, tg, tb, rr, rg, rb, alive)
    return torch.stack([rr, rg, rb], dim=-1), nb


def records_xla(scene, cam, pixel_ids, seed, spp: int, max_depth: int,
                hit_fn=None, sample_offset: int = 0):
    """(max_depth, spp, R) records through the tensor search, covering
    global samples ``sample_offset .. sample_offset + spp``: the CPU oracle of
    the recorder kernel (the reference's name is kept). Depth-major, like
    the kernel's output."""
    from ..camera import get_rays

    out = []
    with torch.no_grad():
        for s in range(spp):
            s = s + sample_offset
            o, d, t = get_rays(cam, seed, pixel_ids, s)
            tp_alive = t < torch.inf
            recs = []
            for depth_i in range(max_depth):
                rngb = hashrng.CounterRng(seed, pixel_ids, s, depth_i,
                                          device=o.device)
                rec = record_from_hitfn(scene, o, d, t, rngb, hit_fn)
                hit = hit_from_record(scene, o, d, t, rngb, rec)
                sc = scatter_and_emit(scene, rngb, d, hit)
                scat = tp_alive & hit.hit & sc.scattered
                side = torch.sign(la.dot(sc.direction, hit.normal))[:, None]
                scale = torch.amax(torch.abs(hit.p), dim=-1, keepdim=True)
                eps = 1e-4 + 2e-4 * scale
                new_o = hit.p + torch.where(hit.is_surface[:, None],
                                            side * hit.normal * eps, 0.0)
                o = torch.where(scat[:, None], new_o, o)
                d = torch.where(scat[:, None], sc.direction, d)
                # dead lanes keep producing records; mask them to MISS so
                # the replay treats them alike
                recs.append(torch.where(tp_alive, rec, 0))
                tp_alive = scat
            out.append(torch.stack(recs))
    return torch.stack(out, dim=1)
