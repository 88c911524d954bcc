"""Gradient of a frame's mean radiance with respect to a scene's float
parameters, by record and replay, for scenes of quads lit by diffuse lights
with solid textures and Lambertian surfaces (the Cornell box).

The search is piecewise constant in the parameters, so it is not
differentiated: ``trace.trace(record=True)`` records each bounce's winner,
and the replay re-derives from the winner's own parameters everything that
is continuous in them (the quad's normal and plane, t, the hit point, the
scatter direction, attenuation and emission) with the same random draws.
The gradient of the mean over every (pixel, sample) is the sum of each
chunk's gradient; the loss and the gradients are accumulated in float64.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import rng as R
from . import scenes as S
from .trace import camera_rays, trace

def leaves(scene: S.Scene, device, dtype) -> Dict[str, torch.Tensor]:
    """The parameters the replay differentiates, rounded to float32 as the
    configuration states them, then cast to ``dtype``."""
    for m in scene.mat:
        if m[0] not in (S.LAMBERTIAN, S.DIFFUSE_LIGHT):
            raise ValueError("the gradient reference shades Lambertian "
                             "surfaces and diffuse lights only")
    if scene.spheres or scene.media or scene.image is not None or any(
            t[0] != S.TEX_SOLID for t in scene.tex):
        raise ValueError("the gradient reference takes quads and solid "
                         "textures only")
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(
        device=device, dtype=dtype)
    return dict(quad_q=f([x[0] for x in scene.quads]),
                quad_u=f([x[1] for x in scene.quads]),
                quad_v=f([x[2] for x in scene.quads]),
                tex_rgb=f([t[1] for t in scene.tex]),
                background=f(scene.background))


def _safe_div(a, b, eps=1e-30):
    return a / torch.where(b.abs() < eps,
                           torch.where(b < 0, -eps, eps).to(b.dtype), b)


def _quad_table(lv, quad_m, mat_tex):
    """Per quad: its unit normal, its plane's offset and its texture's
    colour, (Q, 7), from the leaves."""
    q, u, v = lv["quad_q"], lv["quad_u"], lv["quad_v"]
    n = torch.linalg.cross(u, v)
    nlen2 = torch.clamp((n * n).sum(-1), min=1e-30)[:, None]
    normal = n / torch.sqrt(nlen2)
    colour = lv["tex_rgb"][mat_tex[quad_m]]
    return torch.cat([normal, (normal * q).sum(-1, keepdim=True), colour], 1)


def replay(lv, quad_m, mat_type, mat_tex, view, seed, pix, samp, recs,
           max_depth):
    """Radiance (L, 3) and scene queries (L,) of lanes (pix, samp) along
    the recorded winners ``recs`` (max_depth, L), differentiable in the
    leaves ``lv``. A lane reads its quad's row as a one-hot product, so
    the backward pass sums over lanes by a matrix product rather than by
    atomic adds into a few rows."""
    dtype = lv["quad_q"].dtype
    (ox, oy, oz), (dx, dy, dz), _ = camera_rays(view, seed, pix, samp, dtype)
    table = _quad_table(lv, quad_m, mat_tex)
    light_q = mat_type[quad_m] == S.DIFFUSE_LIGHT
    Q = table.shape[0]
    bg = lv["background"]
    L = pix.shape[0]
    one = torch.ones(L, dtype=dtype, device=pix.device)
    tp = [one] * 3
    rad = [torch.zeros_like(one)] * 3
    alive = torch.ones(L, dtype=torch.bool, device=pix.device)
    nb = torch.zeros(L, dtype=torch.int32, device=pix.device)
    for d_i in range(max_depth):
        nb = nb + alive.to(torch.int32)
        rec = recs[d_i].long()
        kind, idx = rec >> 24, rec & ((1 << 24) - 1)
        hit = kind == 2
        if bool(((kind != 0) & ~hit).any()):
            raise ValueError("a record names a primitive other than a quad")
        qi = torch.where(hit, idx, 0)
        onehot = (qi[:, None] == torch.arange(Q, device=pix.device)) & \
            hit[:, None]
        row = onehot.to(dtype) @ table
        nwx, nwy, nwz, dpl = row[:, 0], row[:, 1], row[:, 2], row[:, 3]
        t = _safe_div(dpl - (nwx * ox + nwy * oy + nwz * oz),
                      nwx * dx + nwy * dy + nwz * dz)
        t = torch.where(hit, t, 0.0)
        px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
        front = (dx * nwx + dy * nwy + dz * nwz) < 0.0
        sgn = torch.where(front, 1.0, -1.0).to(dtype)
        nx, ny, nz = sgn * nwx, sgn * nwy, sgn * nwz
        miss = alive & ~hit
        rad = [r + torch.where(miss, t_ * bg[k], 0.0)
               for k, (r, t_) in enumerate(zip(rad, tp))]
        live = alive & hit
        light = light_q[qi]
        rad = [r + torch.where(live & light, t_ * row[:, 4 + k], 0.0)
               for k, (r, t_) in enumerate(zip(rad, tp))]
        rngb = R.Rng(seed, pix, samp, d_i, dtype=dtype)
        uvx, uvy, uvz = rngb.unit_vector(R.SITE_SCATTER_Z,
                                         R.SITE_SCATTER_PHI)
        lx, ly, lz = nx + uvx, ny + uvy, nz + uvz
        nzf = (lx.abs() < 1e-8) & (ly.abs() < 1e-8) & (lz.abs() < 1e-8)
        lx, ly, lz = (torch.where(nzf, a, b)
                      for a, b in ((nx, lx), (ny, ly), (nz, lz)))
        scat = live & ~light
        tp = [torch.where(scat, t_ * row[:, 4 + k], t_)
              for k, t_ in enumerate(tp)]
        side = torch.sign(lx * nx + ly * ny + lz * nz)
        mag = torch.maximum(px.abs(), torch.maximum(py.abs(), pz.abs()))
        off = side * (1e-4 + 2e-4 * mag)
        ox = torch.where(scat, px + off * nx, ox)
        oy = torch.where(scat, py + off * ny, oy)
        oz = torch.where(scat, pz + off * nz, oz)
        dx = torch.where(scat, lx, dx)
        dy = torch.where(scat, ly, dy)
        dz = torch.where(scat, lz, dz)
        alive = scat
    return torch.stack(rad, dim=-1), nb


def mean_and_grad(scene: S.Scene, view, seed: int, spp: int, max_depth: int,
                  device, dtype=torch.float32, lanes: int = 1 << 21):
    """(loss, gradients by leaf name as float64 numpy, scene queries) of the
    frame's mean radiance over every pixel and channel and samples
    ``0 .. spp``. The lanes go in chunks of whole samples of every pixel,
    about ``lanes`` a chunk."""
    tb = S.tables(scene, device, dtype)
    lv = {k: x.detach().requires_grad_(True)
          for k, x in leaves(scene, device, dtype).items()}
    quad_m = tb["quad_m"]
    n_pix = view.width * view.height
    pixels = torch.arange(n_pix, dtype=torch.int32, device=device)
    denom = float(n_pix) * 3.0 * spp
    grads = {k: np.zeros(x.shape) for k, x in lv.items()}
    loss = 0.0
    rays = 0
    k = max(1, lanes // n_pix)  # whole samples of every pixel a chunk
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for s0 in range(0, spp, k):
            kk = min(k, spp - s0)
            pix = pixels.repeat(kk)
            samp = (s0 + torch.arange(kk, dtype=torch.int32, device=device)
                    ).repeat_interleave(n_pix)
            with torch.no_grad():
                _, _, recs = trace(tb, view, seed, pix, samp, max_depth,
                                   record=True)
            rad, nb = replay(lv, quad_m, tb["mat_type"], tb["mat_tex"],
                             view, seed, pix, samp, recs, max_depth)
            gs = torch.autograd.grad(rad.sum(), list(lv.values()),
                                     allow_unused=True)
            for name, g in zip(lv, gs):
                if g is not None:
                    grads[name] += g.double().cpu().numpy() / denom
            loss += float(rad.detach().double().sum()) / denom
            rays += int(nb.sum(dtype=torch.int64))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return loss, grads, rays
