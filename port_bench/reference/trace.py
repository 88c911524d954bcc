"""The path tracer as plain tensor code over lanes of (pixel, sample).

Each lane is one camera sample, traced to its end: closest hit over every
sphere and quad (the first minimum in (t, kind, index) order), the constant
media after it, emission, the five materials' scatter, the f32 origin
offset, at most ``max_depth`` scene queries. The fused render's texture
arithmetic: the hash-lattice turbulence for noise, the nearest texel of the
image's mip at a sphere UV from polynomial acos and atan2. Every operation
is an explicit multiply or add in the order the book's code writes it.

``trace`` returns each lane's radiance, its scene queries and, with
``record``, the winner of every bounce as ``kind << 24 | index`` (kind 1 a
sphere, 2 a quad, 3 + m medium m, 0 a miss or a finished path).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import rng as R
from .scenes import (DIELECTRIC, DIFFUSE_LIGHT, ISOTROPIC, LAMBERTIAN, METAL,
                     TEX_IMAGE, TEX_NOISE)

T_MIN = 1e-3
QUAD_DENOM_EPS = 1e-8
ORIGIN_EPS_ABS = 1e-4
ORIGIN_EPS_REL = 2e-4
NOISE_SALT = 0x5EED
# lanes x primitives of one broadcast test
SEARCH_CHUNK = 1 << 23
_PI = math.pi
_ATAN_COEF = (-0.005020576, 0.025330155, -0.060872567, 0.100020881,
              -0.140477845, 0.199740231, -0.333322323, 0.999999923)
_ACOS_COEF = (-0.0012624911, 0.0066700901, -0.0170881256, 0.0308918810,
              -0.0501743046, 0.0889789874, -0.2145988016, 1.5707963050)


def _f(v: float) -> float:
    return float(np.float32(v))


def _hash_grad(hx, hy, hz, salt, dtype):
    h = (hx * R.i32(0x9E3779B1) + hy * R.i32(0x85EBCA77)
         + hz * R.i32(0xC2B2AE3D) + R.i32(salt))
    g = lambda x: 2.0 * R.unit_float(R.mix(x)).to(dtype) - 1.0
    return (g(h), g(h + R.i32(0x01000193)), g(h + R.i32(0x02000193)))


def _noise(px, py, pz):
    fx, fy, fz = torch.floor(px), torch.floor(py), torch.floor(pz)
    ux, uy, uz = px - fx, py - fy, pz - fz
    sx = ux * ux * (3.0 - 2.0 * ux)
    sy = uy * uy * (3.0 - 2.0 * uy)
    sz = uz * uz * (3.0 - 2.0 * uz)
    ix, iy, iz = fx.to(torch.int32), fy.to(torch.int32), fz.to(torch.int32)
    acc = torch.zeros_like(px)
    for di in (0, 1):
        wx = sx if di else 1.0 - sx
        for dj in (0, 1):
            wy = sy if dj else 1.0 - sy
            for dk in (0, 1):
                wz = sz if dk else 1.0 - sz
                gx, gy, gz = _hash_grad(ix + di, iy + dj, iz + dk,
                                        NOISE_SALT, px.dtype)
                dot = gx * (ux - di) + gy * (uy - dj) + gz * (uz - dk)
                acc = acc + wx * wy * wz * dot
    return acc


def turbulence(px, py, pz, depth: int = 7):
    """|sum over octaves of 2^-k noise(2^k p)| (perlin.rs:52-64)."""
    acc = torch.zeros_like(px)
    w = s = 1.0
    for _ in range(depth):
        acc = acc + w * _noise(px * s, py * s, pz * s)
        w *= 0.5
        s *= 2.0
    return torch.abs(acc)


def _poly(coefs, x):
    p = torch.full_like(x, _f(coefs[0]))
    for c in coefs[1:]:
        p = p * x + _f(c)
    return p


def _atan2(y, x):
    ax, ay = x.abs(), y.abs()
    mx, mn = torch.maximum(ax, ay), torch.minimum(ax, ay)
    r = mn / torch.clamp(mx, min=1e-30)
    a = _poly(_ATAN_COEF, r * r) * r
    a = torch.where(ay > ax, _f(_PI / 2) - a, a)
    a = torch.where(x < 0.0, _f(_PI) - a, a)
    return torch.where(y < 0.0, -a, a)


def _arccos(x):
    xa = torch.clamp(x, -1.0, 1.0).abs()
    a = _poly(_ACOS_COEF, xa) * torch.sqrt(torch.clamp(1.0 - xa, min=0.0))
    return torch.where(x < 0.0, _f(_PI) - a, a)


def _sphere_t(sph, ox, oy, oz, dx, dy, dz, rtime, a_len, inv_a):
    ccx = sph[:, 0] + sph[:, 5] * rtime
    ccy = sph[:, 1] + sph[:, 6] * rtime
    ccz = sph[:, 2] + sph[:, 7] * rtime
    ocx, ocy, ocz = ox - ccx, oy - ccy, oz - ccz
    half_b = ocx * dx + ocy * dy + ocz * dz
    c = ocx * ocx + ocy * ocy + ocz * ocz - sph[:, 3]
    disc = half_b * half_b - a_len * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    r1 = (-half_b - sq) * inv_a
    r2 = (-half_b + sq) * inv_a
    ok1 = (r1 > T_MIN) & (r1 < math.inf)
    ok2 = (r2 > T_MIN) & (r2 < math.inf)
    return torch.where((disc > 0.0) & (ok1 | ok2),
                       torch.where(ok1, r1, r2), math.inf)


def _quad_t(quad, ox, oy, oz, dx, dy, dz):
    nx, ny, nz = quad[:, 9], quad[:, 10], quad[:, 11]
    denom = nx * dx + ny * dy + nz * dz
    safe = torch.where(denom.abs() < 1e-30, 1e-30, denom)
    t = (quad[:, 15] - (nx * ox + ny * oy + nz * oz)) / safe
    hx = ox + t * dx - quad[:, 0]
    hy = oy + t * dy - quad[:, 1]
    hz = oz + t * dz - quad[:, 2]
    ux, uy, uz = quad[:, 3], quad[:, 4], quad[:, 5]
    vx, vy, vz = quad[:, 6], quad[:, 7], quad[:, 8]
    wx, wy, wz = quad[:, 12], quad[:, 13], quad[:, 14]
    alpha = (wx * (hy * vz - hz * vy) + wy * (hz * vx - hx * vz)
             + wz * (hx * vy - hy * vx))
    beta = (wx * (uy * hz - uz * hy) + wy * (uz * hx - ux * hz)
            + wz * (ux * hy - uy * hx))
    hit = ((denom.abs() >= QUAD_DENOM_EPS) & (t >= T_MIN) & (t < math.inf)
           & (alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0) & (beta <= 1.0))
    return torch.where(hit, t, math.inf)


def closest_surface(tb, ox, oy, oz, dx, dy, dz, rtime, alive):
    """Closest sphere or quad of each lane over every primitive. Returns
    (t, material, outward normal, record, |d|^2, 1/|d|^2); t is inf on a
    miss and T_MIN on a finished lane."""
    a_len = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / torch.clamp(a_len, min=1e-30)
    L = ox.shape[0]
    S, Q = tb["n_spheres"], tb["n_quads"]
    sph, quad = tb["sph"], tb["quad"]
    t_win = torch.full((L,), math.inf, dtype=ox.dtype, device=ox.device)
    j_win = torch.zeros(L, dtype=torch.int64, device=ox.device)
    step = max(1, SEARCH_CHUNK // max(S + Q, 1))
    for l0 in range(0, L, step):
        sl = slice(l0, l0 + step)
        lane = [v[sl, None] for v in (ox, oy, oz, dx, dy, dz)]
        parts = []
        if S:
            parts.append(_sphere_t(sph[:S], *lane, rtime[sl, None],
                                   a_len[sl, None], inv_a[sl, None]))
        if Q:
            parts.append(_quad_t(quad[:Q], *lane))
        t = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
        j = torch.argmin(t, dim=1)
        t_win[sl] = t.gather(1, j[:, None])[:, 0]
        j_win[sl] = j
    hit = torch.isfinite(t_win) & alive
    t_best = torch.where(hit, t_win, torch.where(alive, math.inf, T_MIN)
                         .to(ox.dtype))
    is_s = hit & (j_win < S)
    is_q = hit & (j_win >= S)
    si = torch.where(is_s, j_win, 0)
    qi = torch.where(is_q, j_win - S, 0)
    srow, qrow = sph[si], quad[qi]
    root = torch.where(is_s, t_win, 0.0)
    ccx = srow[:, 0] + srow[:, 5] * rtime
    ccy = srow[:, 1] + srow[:, 6] * rtime
    ccz = srow[:, 2] + srow[:, 7] * rtime
    zero = torch.zeros_like(ox)
    nx = torch.where(is_s, (ox + root * dx - ccx) * srow[:, 4],
                     torch.where(is_q, qrow[:, 9], zero))
    ny = torch.where(is_s, (oy + root * dy - ccy) * srow[:, 4],
                     torch.where(is_q, qrow[:, 10], zero))
    nz = torch.where(is_s, (oz + root * dz - ccz) * srow[:, 4],
                     torch.where(is_q, qrow[:, 11], zero + 1.0))
    mat = torch.where(is_s, tb["sph_m"][si],
                      torch.where(is_q, tb["quad_m"][qi], 0))
    rec = torch.where(is_s, (1 << 24) | si,
                      torch.where(is_q, (2 << 24) | qi, 0))
    return t_best, mat, nx, ny, nz, rec, a_len, inv_a


def media(tb, ox, oy, oz, dx, dy, dz, a_len, inv_a, rngb, t_best, w_mat,
          w_rec):
    """Constant media with a spherical boundary (constant_medium.rs:34-71):
    a medium wins where its exponential free flight ends before the winner
    so far."""
    w_med = torch.zeros(ox.shape, dtype=torch.bool, device=ox.device)
    for i, (c, r2, nid, mat) in enumerate(tb["media"]):
        ocx, ocy, ocz = ox - c[0], oy - c[1], oz - c[2]
        half_b = ocx * dx + ocy * dy + ocz * dz
        cc = ocx * ocx + ocy * ocy + ocz * ocz - r2
        disc = half_b * half_b - a_len * cc
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        entry = torch.clamp((-half_b - sq) * inv_a, min=T_MIN)
        exit_ = torch.minimum((-half_b + sq) * inv_a, t_best)
        ok = (disc > 0.0) & (entry < exit_)
        ray_len = torch.sqrt(a_len)
        dist_in = (exit_ - entry) * ray_len
        u = torch.clamp(rngb.uniform(R.SITE_MEDIUM + i), min=1e-12)
        hd = nid * torch.log(u)
        ok = ok & (hd <= dist_in)
        t_m = entry + hd / ray_len
        hit = ok & (t_m < t_best)
        t_best = torch.where(hit, t_m, t_best)
        w_mat = torch.where(hit, mat, w_mat)
        w_rec = torch.where(hit, (3 + i) << 24, w_rec)
        w_med = w_med | hit
    return t_best, w_mat, w_rec, w_med


def _texture(tb, tid, hpx, hpy, hpz, tex_u, tex_v, shade):
    tex_f = tb["tex_f"]
    r, g, b = tex_f[tid, 0], tex_f[tid, 1], tex_f[tid, 2]
    if shade and tb["has_noise"]:
        marble = (torch.sin(tex_f[tid, 3] * hpz
                            + 10.0 * turbulence(hpx, hpy, hpz)) * 0.5 + 0.5)
        is_n = tb["tex_type"][tid] == TEX_NOISE
        r, g, b = (torch.where(is_n, marble, x) for x in (r, g, b))
    if shade and tb["has_image"]:
        ih, iw = tb["img_h"], tb["img_w"]
        img = tb["img"].reshape(3, -1)
        uc = torch.clamp(tex_u, 0.0, 1.0)
        vc = 1.0 - torch.clamp(tex_v, 0.0, 1.0)
        lin = ((vc * (ih - 1)).to(torch.int32) * iw
               + (uc * (iw - 1)).to(torch.int32))
        ok = (lin >= 0) & (lin < ih * iw)
        texel = torch.where(ok, img[:, lin.clamp(0, ih * iw - 1).long()], 0.0)
        is_i = tb["tex_type"][tid] == TEX_IMAGE
        r, g, b = (torch.where(is_i, texel[k], x)
                   for k, x in enumerate((r, g, b)))
    return r, g, b


def camera_rays(view, seed, pix, samp, dtype):
    """Jittered camera rays of lanes (pix, samp) (camera.rs:112-137), with
    no defocus: origin, direction, shutter time."""
    rng = R.Rng(seed, pix, samp, dtype=dtype)
    pi = (pix % view.width).to(dtype)
    pj = torch.div(pix, view.width, rounding_mode="floor").to(dtype)
    jx = rng.uniform(R.SITE_PIXEL_JX) - 0.5
    jy = rng.uniform(R.SITE_PIXEL_JY) - 0.5
    c, p0, du, dv = view.center, view.pixel00, view.delta_u, view.delta_v
    s = [p0[k] + (pi + jx) * du[k] + (pj + jy) * dv[k] for k in range(3)]
    zero = torch.zeros(pix.shape, dtype=dtype, device=pix.device)
    o = [zero + c[k] for k in range(3)]
    return o, [s[k] - o[k] for k in range(3)], rng.uniform(R.SITE_TIME)


def trace(tb, view, seed: int, pix, samp, max_depth: int, record=False):
    """Trace lanes (pix, samp) (int32 tensors of one length) to their end.
    Returns (radiance (L, 3), scene queries (L,) int32) and, with
    ``record``, the (max_depth, L) int32 winners."""
    dtype = tb["dtype"]
    mat_f, tex_f = tb["mat_f"], tb["tex_f"]
    bg = view.background
    (ox, oy, oz), (dx, dy, dz), rtime = camera_rays(view, seed, pix, samp,
                                                    dtype)
    L = pix.shape[0]
    zero = torch.zeros(L, dtype=dtype, device=pix.device)
    tp = [zero + 1.0] * 3
    rad = [zero] * 3
    alive = torch.ones(L, dtype=torch.bool, device=pix.device)
    nb = torch.zeros(L, dtype=torch.int32, device=pix.device)
    recs = []
    shade = not record
    for d_i in range(max_depth):
        nb = nb + alive.to(torch.int32)
        rngb = R.Rng(seed, pix, samp, d_i, dtype=dtype)
        t_best, w_mat, w_nx, w_ny, w_nz, w_rec, a_len, inv_a = \
            closest_surface(tb, ox, oy, oz, dx, dy, dz, rtime, alive)
        t_best, w_mat, w_rec, w_med = media(
            tb, ox, oy, oz, dx, dy, dz, a_len, inv_a, rngb, t_best, w_mat,
            w_rec)
        hit = torch.isfinite(t_best) & alive
        recs.append(torch.where(hit, w_rec, 0).to(torch.int32))
        miss = alive & ~hit
        rad = [r + torch.where(miss, t * b, 0.0)
               for r, t, b in zip(rad, tp, bg)]
        t_safe = torch.where(hit, t_best, 0.0)
        hpx, hpy, hpz = ox + t_safe * dx, oy + t_safe * dy, oz + t_safe * dz
        mx = torch.where(w_med, dx, w_nx)
        my = torch.where(w_med, dy, w_ny)
        mz = torch.where(w_med, dz, w_nz)
        ndotd = torch.where(w_med, a_len, w_nx * dx + w_ny * dy + w_nz * dz)
        front = ndotd < 0.0
        sign = torch.where(front, 1.0, -1.0)
        nx, ny, nz = sign * mx, sign * my, sign * mz

        m_type = tb["mat_type"][w_mat]
        fuzz, ir = mat_f[w_mat, 3], mat_f[w_mat, 4]
        is_metal = m_type == METAL
        is_diel = m_type == DIELECTRIC
        is_light = m_type == DIFFUSE_LIGHT
        is_iso = m_type == ISOTROPIC
        if shade and tb["has_image"]:
            theta = _arccos(-w_ny)
            phi = _atan2(-w_nz, w_nx) + _f(_PI)
            tex_u, tex_v = phi * _f(1.0 / (2.0 * _PI)), theta * _f(1.0 / _PI)
        else:
            tex_u = tex_v = zero
        tex = _texture(tb, tb["mat_tex"][w_mat], hpx, hpy, hpz, tex_u, tex_v,
                       shade)
        em = hit & is_light
        rad = [r + torch.where(em, t * x, 0.0)
               for r, t, x in zip(rad, tp, tex)]

        uvx, uvy, uvz = rngb.unit_vector(R.SITE_SCATTER_Z, R.SITE_SCATTER_PHI)
        inv_len = torch.rsqrt(torch.clamp(a_len, min=1e-30))
        udx, udy, udz = dx * inv_len, dy * inv_len, dz * inv_len
        lx, ly, lz = nx + uvx, ny + uvy, nz + uvz
        nzf = (lx.abs() < 1e-8) & (ly.abs() < 1e-8) & (lz.abs() < 1e-8)
        lx, ly, lz = (torch.where(nzf, n, l)
                      for n, l in ((nx, lx), (ny, ly), (nz, lz)))
        fx, fy, fz = rngb.in_unit_sphere(R.SITE_FUZZ_Z, R.SITE_FUZZ_PHI,
                                         R.SITE_FUZZ_R)
        rdot = udx * nx + udy * ny + udz * nz
        mdx = udx - 2.0 * rdot * nx + fuzz * fx
        mdy = udy - 2.0 * rdot * ny + fuzz * fy
        mdz = udz - 2.0 * rdot * nz + fuzz * fz
        metal_ok = (mdx * nx + mdy * ny + mdz * nz) > 0.0
        ratio = torch.where(front, 1.0 / ir, ir)
        cos_t = torch.clamp(-(udx * nx + udy * ny + udz * nz), max=1.0)
        sin_sq = torch.clamp(1.0 - cos_t * cos_t, min=0.0)
        cannot = ratio * ratio * sin_sq > 1.0
        r0s = (1.0 - ratio) / (1.0 + ratio)
        r0 = r0s * r0s
        omc = 1.0 - cos_t
        omc2 = omc * omc
        refl = r0 + (1.0 - r0) * (omc * (omc2 * omc2))
        do_refl = cannot | (refl > rngb.uniform(R.SITE_SCHLICK))
        rpx = ratio * (udx + cos_t * nx)
        rpy = ratio * (udy + cos_t * ny)
        rpz = ratio * (udz + cos_t * nz)
        par = -torch.sqrt(torch.clamp(
            1.0 - (rpx * rpx + rpy * rpy + rpz * rpz), min=0.0))
        rfx, rfy, rfz = rpx + par * nx, rpy + par * ny, rpz + par * nz
        rlx = udx - 2.0 * rdot * nx
        rly = udy - 2.0 * rdot * ny
        rlz = udz - 2.0 * rdot * nz
        ddx = torch.where(do_refl, rlx, rfx)
        ddy = torch.where(do_refl, rly, rfy)
        ddz = torch.where(do_refl, rlz, rfz)
        lam_iso = (m_type == LAMBERTIAN) | is_iso
        ndx = torch.where(lam_iso, torch.where(is_iso, uvx, lx),
                          torch.where(is_metal, mdx, ddx))
        ndy = torch.where(lam_iso, torch.where(is_iso, uvy, ly),
                          torch.where(is_metal, mdy, ddy))
        ndz = torch.where(lam_iso, torch.where(is_iso, uvz, lz),
                          torch.where(is_metal, mdz, ddz))
        scat = hit & ((is_metal & metal_ok) | (~is_metal & ~is_light))
        if d_i + 1 >= max_depth:
            scat = scat & False
        one = zero + 1.0
        att = [torch.where(is_metal, mat_f[w_mat, k],
                           torch.where(is_diel, one, tex[k]))
               for k in range(3)]
        tp = [torch.where(scat, t * a, t) for t, a in zip(tp, att)]
        side = torch.sign(ndx * nx + ndy * ny + ndz * nz)
        mag = torch.maximum(hpx.abs(), torch.maximum(hpy.abs(), hpz.abs()))
        off = torch.where(w_med, 0.0,
                          side * (ORIGIN_EPS_ABS + ORIGIN_EPS_REL * mag))
        ox = torch.where(scat, hpx + off * nx, ox)
        oy = torch.where(scat, hpy + off * ny, oy)
        oz = torch.where(scat, hpz + off * nz, oz)
        dx = torch.where(scat, ndx, dx)
        dy = torch.where(scat, ndy, dy)
        dz = torch.where(scat, ndz, dz)
        alive = scat
        if not bool(alive.any()):
            recs += [torch.zeros_like(recs[0])] * (max_depth - d_i - 1)
            break
    out = torch.stack(rad, dim=-1), nb
    return out + (torch.stack(recs),) if record else out


def pixel_means(tb, view, seed: int, pixels, sample0: int, spp: int,
                max_depth: int, lanes: int = 1 << 21):
    """Mean radiance and summed scene queries of ``pixels`` over samples
    ``sample0 .. sample0 + spp``: the samples added in sample order, the sum
    times float(1/spp). Returns ((P, 3), (P,) int64)."""
    P = pixels.shape[0]
    dtype = tb["dtype"]
    acc = torch.zeros((P, 3), dtype=dtype, device=pixels.device)
    rays = torch.zeros(P, dtype=torch.int64, device=pixels.device)
    k = max(1, lanes // P)
    for s0 in range(0, spp, k):
        kk = min(k, spp - s0)
        pix = pixels.repeat(kk)
        samp = (sample0 + s0 + torch.arange(kk, dtype=torch.int32,
                                            device=pixels.device)
                ).repeat_interleave(P)
        rad, nb = trace(tb, view, seed, pix, samp, max_depth)
        rad = rad.reshape(kk, P, 3)
        for i in range(kk):
            acc = acc + rad[i]
        rays += nb.reshape(kk, P).sum(0, dtype=torch.int64)
    return acc * (1.0 / spp), rays
