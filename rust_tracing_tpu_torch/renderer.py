"""Offline and progressive render entry points.

PyTorch counterpart of rust_tracing_tpu/renderer.py. ``render`` keeps the
reference's auto policy: the sorted deferred wavefront for big scenes
(ops/wavefront.py, from ``WAVEFRONT_PRIM_THRESHOLD`` primitives on), deferred
shading for image/noise scenes, the fused kernel for the rest.

The fused path is the same on both devices: a scene on a CUDA device renders
through the hand-written CUDA kernel, a scene on the CPU through the kernel's
plain PyTorch version (ops/megakernel.py). ``use_megakernel=False``, a custom
``hit_fn`` or float64 take the tensor integrator (ops/integrator.py) over
pixel chunks (``render_chunk``), the estimator the gradient differentiates;
a scene compiled with a BVH searches it there (ops/bvh_traverse.py).
Deferred shading (``render_deferred``) records the winners with the recorder
kernel and shades them with the differentiable replay (ops/replay.py): the
same estimator as the tensor integrator, bit for bit.
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Optional, Tuple

import numpy as np
import torch

from .camera import Camera, CameraConstants, get_rays
from .config import resolve_device
from .ops import integrator, megakernel, wavefront
from .ops.bvh_traverse import auto_closest_hit
from .ops.wavefront import WAVEFRONT_PRIM_THRESHOLD
from .utils import metrics


@dataclasses.dataclass
class RenderStats:
    seconds: float = 0.0
    rays: int = 0

    @property
    def rays_per_sec(self) -> float:
        return self.rays / self.seconds if self.seconds > 0 else 0.0


def _auto_chunk(scene, target_bytes: int = 192 * 1024 * 1024) -> int:
    """Pixel-chunk size such that the widest per-ray broadcast fits
    ``target_bytes``: brute force holds (rays x spheres) and (rays x quads)
    temporaries, media (rays x media x 3) for the slab test."""
    per_ray = 0
    if scene.has_bvh:
        per_ray += 16 * 4 * 4  # ~16 gathered f32 rows live per step
    else:
        per_ray += (scene.num_spheres + scene.num_quads) * 4 * 8
    if scene.has_media:
        per_ray += scene.med_mat.shape[0] * 3 * 4 * 6  # (R,M,3) temporaries
    per_ray = max(per_ray, 64)
    chunk = max(1024, min(1 << 16, target_bytes // per_ray))
    return max(1024, (chunk // 1024) * 1024)


def render_chunk(scene, cam: CameraConstants, pixel_ids, seed: int,
                 sample_offset: int, spp: int, max_depth: int, hit_fn=None):
    """Sum of ``spp`` radiance samples for each pixel id over global sample
    indices ``sample_offset .. sample_offset + spp``, added in sample order,
    through the tensor integrator. The RNG is addressed by (seed, pixel,
    sample), so the result does not depend on how pixels are chunked.

    Returns (radiance sum (C,3), rays traced as an int64 scalar)."""
    C = pixel_ids.shape[0]
    acc = torch.zeros((C, 3), dtype=cam.center.dtype, device=pixel_ids.device)
    nrays = torch.zeros((), dtype=torch.int64, device=pixel_ids.device)
    for s in range(spp):
        sample = sample_offset + s
        o, d, t = get_rays(cam, seed, pixel_ids, sample)
        rad, nb = integrator.trace(scene, o, d, t, (seed, pixel_ids, sample),
                                   max_depth, closest_hit_fn=hit_fn)
        acc = acc + rad
        nrays = nrays + nb.sum(dtype=torch.int64)
    return acc, nrays


def measure_occupancy(scene, camera: Camera, n_pixels: int = 8192,
                      spp: int = 8, max_depth: Optional[int] = None,
                      seed: int = 0, hit_fn=None) -> np.ndarray:
    """Per-bounce live-ray fraction on a strided sample of at most
    ``n_pixels`` pixels, through the tensor integrator: ``fraction[d]`` is
    the share of lanes still tracing when bounce d begins. The area under
    the curve is the occupancy a dense depth loop achieves, the signal for
    compaction and sample-major batching. ``hit_fn`` replaces the
    brute-force search. Runs on the scene's device."""
    max_depth = max_depth or camera.max_depth
    total = camera.image_width * camera.image_height
    n = min(n_pixels, total)
    stride = max(1, total // n)
    dev = scene.device
    ids = torch.arange(0, n * stride, stride, dtype=torch.int32,
                       device=dev) % total
    cam = camera.constants(scene.background.dtype, device=dev)
    occ = torch.zeros((max_depth,), dtype=torch.int32, device=dev)
    with torch.no_grad():
        for s in range(spp):
            o, d, t = get_rays(cam, seed, ids, s)
            _, _, occ_s = integrator.trace(scene, o, d, t, (seed, ids, s),
                                           max_depth, closest_hit_fn=hit_fn,
                                           with_occupancy=True)
            occ = occ + occ_s
    frac = occ.cpu().numpy().astype(np.float64) / (n * spp)
    metrics.emit("occupancy", per_bounce=[round(float(x), 4) for x in frac],
                 mean=float(frac.mean()))
    return frac


def use_megakernel_default(scene, dtype, hit_fn) -> bool:
    """Fast-path policy: the fused render serves every scene it supports in
    f32 with no custom hit function, on the GPU (CUDA kernel) and on the CPU
    (its plain version) alike."""
    return (hit_fn is None and dtype == torch.float32
            and megakernel.supports(scene))


def use_wavefront_default(scene) -> bool:
    """Big scenes (final_scene) take the sorted deferred wavefront."""
    return megakernel.n_prims(scene) >= WAVEFRONT_PRIM_THRESHOLD


def use_deferred_default(scene) -> bool:
    """Deferred shading (record + replay) is the path for image and noise
    textures, which the fused kernel only approximates."""
    return scene.has_image or scene.has_noise


def auto_path(scene, dtype=torch.float32, hit_fn=None) -> str:
    """The path ``render`` takes under its auto policy
    (``use_megakernel=None``), by the name its metrics event gives it:
    ``"wavefront_sorted"``, ``"deferred"``, ``"megakernel"`` (the fused
    render) or ``"tensor_wavefront"``."""
    if not use_megakernel_default(scene, dtype, hit_fn):
        return "tensor_wavefront"
    if use_wavefront_default(scene):
        return "wavefront_sorted"
    if use_deferred_default(scene):
        return "deferred"
    return "megakernel"


def render_deferred(scene, camera: Camera, seed: int = 0,
                    spp: Optional[int] = None,
                    max_depth: Optional[int] = None, sample_offset: int = 0
                    ) -> Tuple[np.ndarray, RenderStats]:
    """Deferred-shading render: the recorder (ops/megakernel.record_paths,
    kernel B2 on a GPU) runs the search and writes every bounce's winner,
    then the replay (grad.radiance_mean_replay_rays) shades the recorded
    winners at full fidelity: full-resolution image textures and the exact
    Perlin table turbulence (kernel B7 on a GPU). The image equals the
    tensor integrator's (``use_megakernel=False``) bit for bit.

    spp is cut into slices whose records stay under
    ``grad.RECORD_BUDGET_ENTRIES``; slice means are added with weight
    ``k/spp``. The ray count is an exact int64."""
    from . import grad as grad_mod

    spp = spp or camera.samples_per_pixel
    max_depth = max_depth or camera.max_depth
    w, h = camera.image_width, camera.image_height
    n_pix = w * h
    dev = scene.device
    cam = camera.constants(torch.float32, device=dev)
    pixel_ids = torch.arange(n_pix, dtype=torch.int32, device=dev)
    spp_chunk = max(1, min(
        spp, grad_mod.RECORD_BUDGET_ENTRIES // (max_depth * n_pix)))

    t0 = _time.perf_counter()
    acc = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    rays = 0
    with torch.no_grad():
        for c0 in range(0, spp, spp_chunk):
            k = min(spp_chunk, spp - c0)
            recs = megakernel.record_paths(scene, camera, seed, k, max_depth,
                                           sample_offset=sample_offset + c0)
            m, nb = grad_mod.radiance_mean_replay_rays(
                scene, cam, pixel_ids, seed, recs, k, max_depth,
                sample_base=sample_offset + c0)
            del recs
            acc = acc + m * (k / spp)
            rays += int(nb)
    # int(nb) copies each slice's count to the host, which waits for it
    image = acc.cpu().numpy().astype(np.float64).reshape(h, w, 3)
    stats = RenderStats(seconds=_time.perf_counter() - t0, rays=rays)
    metrics.emit("render", path="deferred", device=str(dev), spp=spp,
                 width=w, height=h, seconds=stats.seconds, rays=stats.rays,
                 rays_per_sec=stats.rays_per_sec)
    return image, stats


def render(scene, camera: Camera, seed: int = 0, spp: Optional[int] = None,
           max_depth: Optional[int] = None, hit_fn=None, dtype=torch.float32,
           progress=None, use_megakernel: Optional[bool] = None,
           sample_offset: int = 0, device=None,
           pixel_chunk: Optional[int] = None
           ) -> Tuple[np.ndarray, RenderStats]:
    """Offline render -> (image (H,W,3) linear float64 numpy, stats).

    ``device=None`` means the GPU; the CPU runs only on ``device="cpu"``.
    The scene must already live on that device (``compile_scene(...,
    device=...)``): nothing is moved silently. ``hit_fn`` replaces the
    tensor integrator's closest-hit search (``intersect.closest_hit`` by
    default); ``pixel_chunk`` sets its pixels per chunk.
    """
    dev = resolve_device(device)
    if scene.device.type != dev.type:
        raise ValueError(
            f"scene is on {scene.device} but render was asked for {dev}; "
            "compile the scene with the same device")
    spp = spp or camera.samples_per_pixel
    max_depth = max_depth or camera.max_depth

    if use_megakernel is None:
        path = auto_path(scene, dtype, hit_fn)
        if path == "wavefront_sorted":
            # big scenes: per-bounce coherence sort, hit kernel (B3 walking
            # the BVH, B4), shading by the replay
            return wavefront.render_sorted(scene, camera, seed=seed, spp=spp,
                                           max_depth=max_depth,
                                           sample_offset=sample_offset)
        if path == "deferred":
            return render_deferred(scene, camera, seed=seed, spp=spp,
                                   max_depth=max_depth,
                                   sample_offset=sample_offset)
        use_megakernel = path == "megakernel"
    if not use_megakernel:
        return _render_tensor(scene, camera, seed, spp, max_depth, hit_fn,
                              dtype, progress, sample_offset, pixel_chunk)

    t0 = _time.perf_counter()
    image, nrays = megakernel.render_fast(scene, camera, seed=seed, spp=spp,
                                          max_depth=max_depth,
                                          sample_offset=sample_offset,
                                          with_stats=True)
    # render_fast copies the image to the host, which waits for the device
    stats = RenderStats(seconds=_time.perf_counter() - t0, rays=int(nrays))
    metrics.emit("render", path="megakernel", device=str(scene.device),
                 spp=spp, width=camera.image_width,
                 height=camera.image_height, seconds=stats.seconds,
                 rays=stats.rays, rays_per_sec=stats.rays_per_sec)
    if progress is not None:
        n = camera.image_width * camera.image_height
        progress(n, n)
    return image.astype(np.float64), stats


def _render_tensor(scene, camera, seed, spp, max_depth, hit_fn, dtype,
                   progress, sample_offset, pixel_chunk):
    """The tensor-integrator render over pixel chunks (the tail chunk padded
    with the last pixel)."""
    if hit_fn is None:
        hit_fn = auto_closest_hit(scene)
    w, h = camera.image_width, camera.image_height
    dev = scene.device
    cam = camera.constants(dtype, device=dev)
    n_pixels = w * h
    chunk = min(pixel_chunk or _auto_chunk(scene), n_pixels)
    out = np.zeros((n_pixels, 3), np.float64)
    stats = RenderStats()
    t0 = _time.perf_counter()
    with torch.no_grad():
        for start in range(0, n_pixels, chunk):
            ids = np.minimum(np.arange(start, start + chunk, dtype=np.int32),
                             n_pixels - 1)
            acc, nrays = render_chunk(scene, cam,
                                      torch.from_numpy(ids).to(dev), seed,
                                      sample_offset, spp, max_depth, hit_fn)
            n_valid = min(chunk, n_pixels - start)
            out[start:start + n_valid] = acc.cpu().numpy()[:n_valid]
            stats.rays += int(nrays)
            if progress is not None:
                progress(start + n_valid, n_pixels)
    stats.seconds = _time.perf_counter() - t0
    metrics.emit("render", path="tensor_wavefront", device=str(dev), spp=spp,
                 width=w, height=h, seconds=stats.seconds, rays=stats.rays,
                 rays_per_sec=stats.rays_per_sec)
    return (out / spp).reshape(h, w, 3), stats


@dataclasses.dataclass
class ProgressiveState:
    """Checkpointable accumulation state: the (buffer, count, seed) triple the
    reference's live renderer keeps implicitly (renderer.rs:97-117)."""

    accum: np.ndarray  # (H,W,3) running mean
    num_samples: int
    seed: int


def progressive_init(camera: Camera, seed: int = 0) -> ProgressiveState:
    return ProgressiveState(
        accum=np.zeros((camera.image_height, camera.image_width, 3), np.float64),
        num_samples=0,
        seed=seed,
    )


def progressive_step(scene, camera: Camera, state: ProgressiveState,
                     samples: int = 1, max_depth: Optional[int] = None,
                     pixel_chunk: Optional[int] = None, hit_fn=None,
                     dtype=torch.float32, device=None) -> ProgressiveState:
    """Add ``samples`` new samples per pixel with incremental-mean update
    (renderer.rs:114: avg += (new - avg) / n). ``pixel_chunk`` and
    ``hit_fn`` are passed to ``render``.

    Samples are addressed globally by index, so a progressive render (and
    one resumed from a checkpoint) accumulates the same sample set as a
    single offline render of the same total spp."""
    img, _ = render(scene, camera, seed=state.seed, spp=samples,
                    max_depth=max_depth, hit_fn=hit_fn, dtype=dtype,
                    sample_offset=state.num_samples, device=device,
                    pixel_chunk=pixel_chunk)
    n1 = state.num_samples + samples
    accum = state.accum + (img - state.accum) * (samples / n1)
    return ProgressiveState(accum=accum, num_samples=n1, seed=state.seed)
