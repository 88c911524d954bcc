"""Sorted deferred wavefront renderer: the big-scene path (final_scene).

PyTorch counterpart of rust_tracing_tpu/ops/wavefront.py. Per bounce:

  SORT the live lanes by a coherence key (direction octant, then an origin
  Morton code; dead lanes last)
  -> the hit kernel (ops/megakernel.hit_kernel, kernel B3, walking the kernel
     BVH, B4, past BVH_KERNEL_THRESHOLD primitives) over the sorted lanes
  -> shading in tensor code (ops/replay.bounce_c, the replay's bounce, whose
     table lookups and noise run the gather and turbulence kernels).

On the card the sort is what makes the BVH walk coherent: a warp of the hit
kernel then holds rays that walk the same subtrees. Dead lanes sort to the
end, and once the live share falls below ``COMPACT_BELOW`` the buffer is cut
to its live prefix, so deep bounces shade and search only live lanes.

The RNG is addressed by the (pixel, sample) ids of each lane, derived from
the lane's original id ``orig`` that rides with it: a permutation never
changes a random stream. ``exact=True`` (the default): a lane's radiance is
per-path arithmetic wherever the lane sits; lanes dropped by compaction keep
their radiance, and at the end of a chunk every lane returns to its original
order and joins one sample sum (grad._sum_samples). The image is then bit
for bit the direct estimator's (grad.radiance_mean_rays) whatever the sort
or the compaction did. ``exact=False`` sums dropped lanes per pixel as they
leave (the deterministic reduction ops/lanegather.scatter_sum_cols): the
same per-path values, another float association.

Bounces run in segments of ``SEG_BOUNCES`` (2 for the first four bounces,
which kill the most lanes); the host reads the live count once per segment.
There is no jit to fuse a segment as the reference does; the segments only
set how often the host waits for the device.
"""

from __future__ import annotations

import time as _time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import grad as grad_mod
from ..camera import get_rays
from ..utils import metrics
from . import hashrng
from . import lanegather as lg
from . import megakernel as mk
from . import replay as replay_mod

# Lanes (samples x pixels) a chunk holds at once. Copied from the reference,
# which sized it for a TPU v5e's memory; it sets the chunks, and so the float
# association of the sample sum.
WAVEFRONT_LANE_BUDGET = 1 << 22

# Scenes at or past this primitive count render on the sorted wavefront under
# render()'s auto policy (final_scene has 3407). Copied as a policy constant:
# it was measured on a TPU; the card's own crossover is in PERF.md.
WAVEFRONT_PRIM_THRESHOLD = 1024

# Compact (cut the buffer to its live prefix) when the live share of the
# buffer falls below this.
COMPACT_BELOW = 0.4

# Bounces between two host reads of the live count (after the first four).
SEG_BOUNCES = 4

_DEAD_KEY = 0x7FFFFFFF


def _spread3(x):
    """Spread the low 10 bits of x so consecutive bits land 3 apart
    (Morton), in int32."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _sort_key(ox, oy, oz, dx, dy, dz, alive, lo, inv_ext):
    """int32 coherence key: direction octant (3 bits), then a 27-bit origin
    Morton code over the scene box; dead lanes key to INT32_MAX and sort to
    the end."""
    i32 = torch.int32
    oct_ = ((dx < 0).to(i32) + 2 * (dy < 0).to(i32) + 4 * (dz < 0).to(i32))

    def cell(o, k):
        q = torch.clamp((o - lo[k]) * inv_ext[k], 0.0, 0.999999)
        return _spread3((q * 512.0).to(i32))

    m = cell(ox, 0) | (cell(oy, 1) << 1) | (cell(oz, 2) << 2)
    key = (oct_ << 27) | (m & 0x07FFFFFF)
    return torch.where(alive, key, _DEAD_KEY)


def _scene_bounds(scene) -> Tuple[np.ndarray, np.ndarray]:
    """World box of the valid primitives on the host (lo, 1/extent), for the
    Morton quantisation. Its quality moves only the sort's locality, never a
    value."""
    los, his = [], []
    sv = mk._np(scene.sph_valid)
    if sv.any():
        c = mk._np(scene.sph_center)[sv].astype(np.float64)
        r = np.abs(mk._np(scene.sph_radius)[sv]).astype(np.float64)[:, None]
        r = np.minimum(r, 100.0)  # clip huge boundary and fog spheres
        los.append((c - r).min(0))
        his.append((c + r).max(0))
    qv = mk._np(scene.quad_valid)
    if qv.any():
        q, u, v = (mk._np(a)[qv].astype(np.float64)
                   for a in (scene.quad_q, scene.quad_u, scene.quad_v))
        pts = np.concatenate([q, q + u, q + v, q + u + v])
        los.append(pts.min(0))
        his.append(pts.max(0))
    if not los:
        return np.zeros(3), np.ones(3)
    lo = np.min(los, axis=0)
    hi = np.max(his, axis=0)
    return lo, 1.0 / np.maximum(hi - lo, 1e-6)


class Lanes(NamedTuple):
    """The wavefront's state, one entry a lane. ``orig`` is the lane's id in
    its chunk, ``(sample - samp_base) * n_pix + pixel``: the pixel and the
    sample ride with it."""

    orig: torch.Tensor   # int32
    ox: torch.Tensor     # f32 ray
    oy: torch.Tensor
    oz: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    time: torch.Tensor
    tr: torch.Tensor     # f32 throughput
    tg: torch.Tensor
    tb: torch.Tensor
    rr: torch.Tensor     # f32 radiance gathered so far
    rg: torch.Tensor
    rb: torch.Tensor
    alive: torch.Tensor  # bool


def chunk_samples(spp: int, n_pix: int) -> int:
    """Samples a chunk holds: as many as ``WAVEFRONT_LANE_BUDGET`` lanes
    allow, moved down to a divisor of spp (one chunk size for every chunk)
    when one lies within a factor of two."""
    k = max(1, min(spp, WAVEFRONT_LANE_BUDGET // n_pix))
    for d in range(k, 0, -1):
        if spp % d == 0:
            return d if d >= max(1, k // 2) else k
    return k


def initial_lanes(cam, seed: int, n_pix: int, samp_base: int,
                  k: int) -> Lanes:
    """Camera rays of samples ``samp_base .. samp_base + k`` of every pixel,
    lanes sample-major (the direct estimator's wavefront, grad._wavefront)."""
    dev = cam.center.device
    pix, samp = grad_mod._wavefront(
        torch.arange(n_pix, dtype=torch.int32, device=dev), samp_base, k)
    o, d, t = get_rays(cam, seed, pix, samp)
    R = pix.shape[0]
    one = torch.ones(R, dtype=torch.float32, device=dev)
    zero = torch.zeros(R, dtype=torch.float32, device=dev)
    c = lambda a: a.contiguous()
    return Lanes(torch.arange(R, dtype=torch.int32, device=dev),
                 c(o[:, 0]), c(o[:, 1]), c(o[:, 2]),
                 c(d[:, 0]), c(d[:, 1]), c(d[:, 2]), c(t),
                 one, one, one, zero, zero, zero,
                 torch.ones(R, dtype=torch.bool, device=dev))


def lane_ids(lanes: Lanes, n_pix: int, samp_base: int):
    """(pixel, sample) int32 ids of every lane, from ``orig``."""
    pix = lanes.orig % n_pix
    samp = samp_base + torch.div(lanes.orig, n_pix, rounding_mode="floor")
    return pix, samp


def sort_lanes(lanes: Lanes, lo, inv_ext) -> Lanes:
    """The lanes in the order of their coherence key, stably: one
    ``torch.sort`` of the key, then one gather of all 15 columns (floats
    carried by their bits as int32)."""
    key = _sort_key(lanes.ox, lanes.oy, lanes.oz, lanes.dx, lanes.dy,
                    lanes.dz, lanes.alive, lo, inv_ext)
    perm = torch.sort(key, stable=True).indices
    cols = [lanes.orig] + [a.view(torch.int32) for a in lanes[1:14]] \
        + [lanes.alive.to(torch.int32)]
    moved = torch.stack(cols).index_select(1, perm)
    return Lanes(moved[0].contiguous(),
                 *[moved[i].view(torch.float32).contiguous()
                   for i in range(1, 14)],
                 moved[14] != 0)


def step(scene, lanes: Lanes, seed: int, bounce: int, n_pix: int,
         samp_base: int, use_bvh: Optional[bool] = None) -> Lanes:
    """One bounce of every lane: the hit search (megakernel.hit_records:
    the hit kernel on a GPU, its plain version on the CPU), then the
    replay's shading of the winners."""
    pix, samp = lane_ids(lanes, n_pix, samp_base)
    rec = mk.hit_records(scene, seed, lanes.ox, lanes.oy, lanes.oz, lanes.dx,
                         lanes.dy, lanes.dz, lanes.time, pix, samp,
                         lanes.alive, bounce, use_bvh=use_bvh)
    rngb = hashrng.CounterRng(seed, pix, samp, bounce, device=pix.device)
    (ox, oy, oz, dx, dy, dz, tr, tg, tb, rr, rg, rb, alive) = \
        replay_mod.bounce_c(scene, rngb, rec, *lanes[1:])
    return Lanes(lanes.orig, ox, oy, oz, dx, dy, dz, lanes.time, tr, tg, tb,
                 rr, rg, rb, alive)


def _unsort_reduce(parts, R: int, k: int, n_pix: int):
    """Radiance of every lane back in original lane order (each ``orig``
    once), then the direct estimator's sequential sample sum: (n_pix, 3)."""
    orig = torch.cat([p[0] for p in parts]).long()
    rad = torch.cat([torch.stack(p[1:], dim=-1) for p in parts])
    full = torch.empty((R, 3), dtype=rad.dtype, device=rad.device)
    full.index_copy_(0, orig, rad)
    return grad_mod._sum_samples(full, k, n_pix)


def _bank_by_pixel(lanes: Lanes, sl: slice, n_pix: int):
    """Per-pixel sums (n_pix, 3) of the radiance of lanes ``sl``, by the
    deterministic reduction."""
    pix = lanes.orig[sl] % n_pix
    ct = torch.stack([lanes.rr[sl], lanes.rg[sl], lanes.rb[sl]])
    return lg.scatter_sum_cols(ct, pix, n_pix).T


def render_sorted(scene, camera, seed: int = 0, spp: Optional[int] = None,
                  max_depth: Optional[int] = None, sort: bool = True,
                  sample_offset: int = 0, use_bvh: Optional[bool] = None,
                  exact: bool = True, sort_every: int = 1):
    """Sorted deferred wavefront render on the scene's device -> ((H, W, 3)
    float64 linear image, RenderStats).

    ``sort`` orders the lanes by their coherence key before every
    ``sort_every``-th bounce (not bounce 0: camera rays arrive in pixel
    order, coherent already) and enables compaction; ``use_bvh`` as for
    megakernel.render_pixels. ``exact`` (default True): the image equals the
    direct estimator's bit for bit as f32 at any ``sort`` setting;
    ``exact=False`` sums lanes per pixel as compaction drops them (another
    float association). Samples run in chunks of at most
    ``WAVEFRONT_LANE_BUDGET`` lanes, preferring a divisor of spp."""
    from ..renderer import RenderStats

    spp = spp or camera.samples_per_pixel
    max_depth = max_depth or camera.max_depth
    w, h = camera.image_width, camera.image_height
    n_pix = w * h
    dev = scene.device
    cam = camera.constants(torch.float32, device=dev)
    k = chunk_samples(spp, n_pix)
    lo, inv_ext = (tuple(float(x) for x in a) for a in _scene_bounds(scene))

    t0 = _time.perf_counter()
    acc = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    chunks = compactions = 0
    with torch.no_grad():
        for c0 in range(0, spp, k):
            kk = min(k, spp - c0)
            samp_base = sample_offset + c0
            lanes = initial_lanes(cam, seed, n_pix, samp_base, kk)
            R = lanes.orig.shape[0]
            dropped = []  # exact mode: (orig, rr, rg, rb) of cut lanes
            depth = 0
            while depth < max_depth:
                nb = min(2 if depth < 4 else SEG_BOUNCES, max_depth - depth)
                for b in range(depth, depth + nb):
                    if sort and b > 0 and b % sort_every == 0:
                        lanes = sort_lanes(lanes, lo, inv_ext)
                    nrays += lanes.alive.sum(dtype=torch.int64)
                    lanes = step(scene, lanes, seed, b, n_pix, samp_base,
                                 use_bvh)
                depth += nb
                if depth >= max_depth:
                    break
                na = int(lanes.alive.sum().item())  # one host read a segment
                if na == 0:
                    break
                cur = lanes.orig.shape[0]
                if sort and na < COMPACT_BELOW * cur:
                    # live lanes sort to a prefix; cut the dead tail
                    lanes = sort_lanes(lanes, lo, inv_ext)
                    tail = slice(na, cur)
                    if exact:
                        dropped.append((lanes.orig[tail], lanes.rr[tail],
                                        lanes.rg[tail], lanes.rb[tail]))
                    else:
                        acc = acc + _bank_by_pixel(lanes, tail, n_pix)
                    lanes = Lanes(*[a[:na] for a in lanes])
                    compactions += 1
            if exact:
                acc = acc + _unsort_reduce(
                    dropped + [(lanes.orig, lanes.rr, lanes.rg, lanes.rb)],
                    R, kk, n_pix)
            else:
                acc = acc + _bank_by_pixel(lanes, slice(None), n_pix)
            chunks += 1
        # the mean in f32 on the device: bit for bit the direct estimator's
        image = (acc / spp).cpu().numpy().astype(np.float64).reshape(h, w, 3)
    stats = RenderStats(seconds=_time.perf_counter() - t0,
                        rays=int(nrays.item()))
    metrics.emit("render", path="wavefront_sorted", device=str(dev), spp=spp,
                 width=w, height=h, seconds=stats.seconds, rays=stats.rays,
                 rays_per_sec=stats.rays_per_sec, sort=sort, exact=exact,
                 chunks=chunks, compactions=compactions)
    return image, stats
