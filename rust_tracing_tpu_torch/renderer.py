"""Offline and progressive render entry points.

PyTorch counterpart of rust_tracing_tpu/renderer.py. ``render`` keeps the
reference's auto policy (fused kernel for the scenes it supports, sorted
wavefront for big scenes, deferred shading for image/noise scenes); the
branches that are not ported yet raise NotImplementedError naming what is
missing and never route to another path silently.

The fused path is the same on both devices: a scene on a CUDA device renders
through the hand-written CUDA kernel, a scene on the CPU through the kernel's
plain PyTorch version (ops/megakernel.py).
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Optional, Tuple

import numpy as np
import torch

from .camera import Camera
from .config import resolve_device
from .ops import megakernel
from .utils import metrics

# Primitive count from which the reference renders through its sorted
# deferred wavefront instead of the fused kernel. Copied as a policy constant:
# it was measured on a TPU and awaits its own measurement on the GPU.
WAVEFRONT_PRIM_THRESHOLD = 1024


@dataclasses.dataclass
class RenderStats:
    seconds: float = 0.0
    rays: int = 0

    @property
    def rays_per_sec(self) -> float:
        return self.rays / self.seconds if self.seconds > 0 else 0.0


def use_megakernel_default(scene, dtype, hit_fn) -> bool:
    """Fast-path policy: the fused render serves every scene it supports in
    f32 with no custom hit function, on the GPU (CUDA kernel) and on the CPU
    (its plain version) alike."""
    return (hit_fn is None and dtype == torch.float32
            and megakernel.supports(scene))


def _n_prims(scene) -> int:
    return int(scene.sph_valid.sum().item() + scene.quad_valid.sum().item())


def use_wavefront_default(scene) -> bool:
    """Big scenes (final_scene) take the sorted deferred wavefront."""
    return _n_prims(scene) >= WAVEFRONT_PRIM_THRESHOLD


def use_deferred_default(scene) -> bool:
    """Deferred shading (record + replay) is the path for image and noise
    textures, which the fused kernel only approximates."""
    return scene.has_image or scene.has_noise


def render_deferred(scene, camera: Camera, seed: int = 0,
                    spp: Optional[int] = None,
                    max_depth: Optional[int] = None, sample_offset: int = 0):
    raise NotImplementedError(
        "deferred shading (path recorder kernel + replay shading, the path "
        "for image and noise textures) is not ported yet")


def render(scene, camera: Camera, seed: int = 0, spp: Optional[int] = None,
           max_depth: Optional[int] = None, hit_fn=None, dtype=torch.float32, progress=None,
           use_megakernel: Optional[bool] = None, sample_offset: int = 0,
           device=None) -> Tuple[np.ndarray, RenderStats]:
    """Offline render -> (image (H,W,3) linear float64 numpy, stats).

    ``device=None`` means the GPU; the CPU runs only on ``device="cpu"``.
    The scene must already live on that device (``compile_scene(...,
    device=...)``): nothing is moved silently.
    """
    dev = resolve_device(device)
    if scene.device.type != dev.type:
        raise ValueError(
            f"scene is on {scene.device} but render was asked for {dev}; "
            "compile the scene with the same device")
    spp = spp or camera.samples_per_pixel
    max_depth = max_depth or camera.max_depth

    if hit_fn is not None:
        raise NotImplementedError(
            "hit_fn: custom closest-hit functions belong to the tensor "
            "wavefront integrator, which is not ported yet")
    if dtype != torch.float32:
        raise NotImplementedError(
            f"dtype={dtype}: only float32 is ported (the float64 path is the "
            "tensor wavefront integrator, not ported yet)")
    if use_megakernel is None:
        use_megakernel = use_megakernel_default(scene, dtype, hit_fn)
        if use_megakernel and use_wavefront_default(scene):
            raise NotImplementedError(
                f"scene has {_n_prims(scene)} primitives (>= "
                f"{WAVEFRONT_PRIM_THRESHOLD}): the sorted deferred wavefront "
                "(wavefront.render_sorted) is not ported yet")
        if use_megakernel and use_deferred_default(scene):
            return render_deferred(scene, camera, seed=seed, spp=spp,
                                   max_depth=max_depth,
                                   sample_offset=sample_offset)
    if not use_megakernel:
        raise NotImplementedError(
            "use_megakernel=False: the tensor wavefront integrator is not "
            "ported yet; only the fused render path is")

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
                     dtype=torch.float32, device=None) -> ProgressiveState:
    """Add ``samples`` new samples per pixel with incremental-mean update
    (renderer.rs:114: avg += (new - avg) / n).

    Samples are addressed globally by index, so a progressive render
    accumulates the same sample set as a single offline render of the same
    total spp."""
    img, _ = render(scene, camera, seed=state.seed, spp=samples,
                    max_depth=max_depth, dtype=dtype,
                    sample_offset=state.num_samples, device=device)
    n1 = state.num_samples + samples
    accum = state.accum + (img - state.accum) * (samples / n1)
    return ProgressiveState(accum=accum, num_samples=n1, seed=state.seed)
