"""Tensor path-tracing integrator: a loop over bounce depth.

PyTorch counterpart of rust_tracing_tpu/ops/integrator.py. The reference
integrator is the recursion ``ray_color`` (src/renderer.rs:139-155), whose
radiance is the product-sum L = E0 + A0*(E1 + A1*(...)); here it is carried
iteratively:

    carry = (origin, direction, throughput, radiance, alive)
    per step: radiance += throughput * emitted        (renderer.rs:145)
              miss     -> radiance += throughput * background; kill
              absorb   -> kill                        (scatter None, :150)
              else       throughput *= attenuation; advance ray (:148)
    depth exhausted with live rays -> contributes nothing (:140-142)

Ray time is fixed per sample across all bounces (material.rs ``with_time``).
This is the differentiable (direct) path: every step is tensor code on the
scene's device, with the table lookups through ``tgather``.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import hashrng, intersect
from . import linalg as la
from .materials import scatter_and_emit

# scale-aware secondary-ray origin offset (f32 self-intersection guard)
_ORIGIN_EPS_ABS = 1e-4
_ORIGIN_EPS_REL = 2e-4


def trace(scene, origin, direction, time, rng_idx, max_depth: int,
          closest_hit_fn=None, remat: bool = False,
          with_occupancy: bool = False):
    """Trace a flat batch of rays to completion.

    ``origin``/``direction`` (R,3), ``time`` (R,); ``rng_idx`` is the
    ``(seed, pixel_ids, sample)`` address prefix of the counter RNG, whose
    per-bounce scope is ``CounterRng(seed, pixel_id, sample, bounce)``.
    ``closest_hit_fn`` overrides the brute-force search
    (``hit_fn(scene, origin, direction, time, rngb) -> intersect.Hit``).
    ``remat`` recomputes each bounce in the backward pass instead of keeping
    its tensors (``torch.utils.checkpoint`` per bounce).

    Returns radiance (R,3) and the scene queries of each ray (R,) int32; with
    ``with_occupancy`` also the (max_depth,) int32 count of live rays
    entering each bounce.
    """
    hit_fn = closest_hit_fn or intersect.closest_hit
    seed, pixel_ids, sample = rng_idx

    def step(o, d, tp, rad, alive, nb, depth_i):
        rngb = hashrng.CounterRng(seed, pixel_ids, sample, depth_i,
                                  device=o.device)
        hit = hit_fn(scene, o, d, time, rngb)
        nb = nb + alive.to(torch.int32)

        miss = alive & ~hit.hit
        rad = rad + torch.where(miss[:, None], tp * scene.background, 0.0)

        s = scatter_and_emit(scene, rngb, d, hit)
        live_hit = alive & hit.hit
        rad = rad + torch.where(live_hit[:, None], tp * s.emitted, 0.0)

        scat = live_hit & s.scattered
        tp = torch.where(scat[:, None], tp * s.attenuation, tp)

        # f32 robustness: offset the new origin along the geometric normal,
        # signed by the side the scattered ray leaves on, with a scale-aware
        # epsilon; media scatter mid-flight and get no offset
        side = torch.sign(la.dot(s.direction, hit.normal))[:, None]
        scale = torch.amax(torch.abs(hit.p), dim=-1, keepdim=True)
        eps = _ORIGIN_EPS_ABS + _ORIGIN_EPS_REL * scale
        new_o = hit.p + torch.where(hit.is_surface[:, None],
                                    side * hit.normal * eps, 0.0)

        o = torch.where(scat[:, None], new_o, o)
        d = torch.where(scat[:, None], s.direction, d)
        return o, d, tp, rad, scat, nb

    o, d = origin, direction
    tp = torch.ones_like(origin)
    rad = torch.zeros_like(origin)
    alive = time < torch.inf
    nb = torch.zeros(time.shape, dtype=torch.int32, device=time.device)
    occ = []
    for depth_i in range(max_depth):
        occ.append(alive.sum(dtype=torch.int32))
        if remat:
            o, d, tp, rad, alive, nb = checkpoint(
                step, o, d, tp, rad, alive, nb, depth_i, use_reentrant=False)
        else:
            o, d, tp, rad, alive, nb = step(o, d, tp, rad, alive, nb, depth_i)
    # depth exhausted -> black contribution (renderer.rs:140-142)
    if with_occupancy:
        return rad, nb, torch.stack(occ) if occ else torch.zeros(
            0, dtype=torch.int32, device=time.device)
    return rad, nb
