"""Distributed record/replay gradient: the training path over a mesh.

PyTorch counterpart of rust_tracing_tpu/parallel/grad_dist.py, the sharded
form of ``grad.loss_and_grad``:

1. every rank RECORDS the winners of its own pixel range x sample range,
   with the same recorder as one device (kernel B2 on a GPU, its plain
   version on the CPU; the pixel range and the sample offset are runtime
   arguments) or with the tensor search (``recorder="xla"``);
2. every rank REPLAYS its block differentiably (ops/replay.py, with the
   gathers B5/B6 and their deterministic transpose, and B7 on noise
   scenes);
3. the gradients are summed over every rank by ONE explicit all-reduce
   (see parallel/render_dist.py for why exactly once).

The pixel ranges are contiguous row-major ranges (``mesh.shard_range``), so
the records a rank replays are the records it made: no record crosses
ranks. The collectives are the mean image's all-reduce, the ray count's and
the gradients'. The RNG is addressed by (seed, pixel, sample, bounce,
site), never by the rank, so the distributed loss and gradient equal
``grad.loss_and_grad``'s up to the association of float sums.

Each rank runs ``loss_and_grad``'s two-pass accumulation over sample
slices whose records stay under ``grad.RECORD_BUDGET_ENTRIES``: pass 1 makes
the block's mean image (the render kernel B1 where it is the same estimator,
else the replay, without a graph), the frame is assembled and the loss
cotangent taken once; pass 2 records each slice again and accumulates its
VJP.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import grad as grad_mod
from ..camera import Camera
from ..ops import megakernel as mk
from ..ops import replay as replay_mod
from ..ops.bvh_traverse import auto_closest_hit
from . import mesh as mesh_mod
from .render_dist import all_reduce_grads

RECORDERS = ("auto", "kernel", "xla")


def _records(scene, camera, cam, recorder: str, seed: int, spp: int,
             max_depth: int, sample_offset: int, base: int, count: int):
    """(max_depth, spp, count) records of pixels ``base .. base+count``."""
    if recorder == "kernel":
        return mk.record_paths(scene, camera, seed, spp, max_depth,
                               sample_offset=sample_offset, pixel_base=base,
                               pixel_count=count)
    pid = torch.arange(base, base + count, dtype=torch.int32,
                       device=scene.device)
    return replay_mod.records_xla(scene, cam, pid, seed, spp, max_depth,
                                  auto_closest_hit(scene),
                                  sample_offset=sample_offset)


def replay_loss_and_grad(scene, camera: Camera, mesh, target_image,
                         seed: int = 0, spp: Optional[int] = None,
                         max_depth: Optional[int] = None,
                         recorder: str = "auto", dtype=torch.float32):
    """Distributed (loss, grad, rays) of the SSE ``sum((img - target)^2)``
    over the whole frame, through the record/replay pipeline.

    ``recorder``: ``"kernel"`` (the recorder on the rank's range: kernel B2
    on a GPU, its plain version on the CPU), ``"xla"`` (the tensor search,
    the reference's name) or ``"auto"`` (``"kernel"`` whenever the fused
    render supports the scene, on every device).

    Every rank returns the same (loss, grad CompiledScene, rays): the loss a
    0-d tensor, the gradient's float fields summed over the mesh (int and
    bool fields hold zeros), rays the exact int64 scene-query count of the
    whole mesh."""
    spp = spp or camera.samples_per_pixel
    max_depth = max_depth or camera.max_depth
    if recorder not in RECORDERS:
        raise ValueError(f"recorder must be one of {RECORDERS}, got "
                         f"{recorder!r}")
    if spp % mesh.n_sample:
        raise ValueError(f"spp={spp} not divisible by sample axis "
                         f"{mesh.n_sample}")
    if recorder == "auto":
        recorder = "kernel" if mk.supports(scene) else "xla"
    spp_local = spp // mesh.n_sample
    sample_base = mesh.sample_idx * spp_local
    dev = scene.device
    n_pix = camera.image_width * camera.image_height
    base, count = mesh_mod.shard_range(n_pix, mesh)
    cam = camera.constants(dtype, device=dev)
    pid = torch.arange(base, base + count, dtype=torch.int32, device=dev)
    target = torch.as_tensor(
        np.asarray(target_image, np.float64).reshape(-1, 3),
        dtype=cam.center.dtype, device=dev)

    def sse(img, _pid):
        d = img - target
        return torch.sum(d * d)

    def records(k, s0):
        return _records(scene, camera, cam, recorder, seed, k, max_depth,
                        sample_base + s0, base, count)

    leaves = grad_mod._float_leaves(scene)
    live = scene.replace(**leaves)
    k_max = max(1, min(spp_local, grad_mod.RECORD_BUDGET_ENTRIES
                       // (max_depth * max(count, 1))))
    slices = [(c0, min(k_max, spp_local - c0))
              for c0 in range(0, spp_local if count else 0, k_max)]

    # ---- pass 1: this block's mean image, the frame assembled, the loss
    # and its cotangent on this block
    m_local = torch.zeros((count, 3), dtype=cam.center.dtype, device=dev)
    if count and recorder == "kernel" and not (scene.has_noise
                                               or scene.has_image):
        m_local, _ = mk.render_pixels(
            scene, camera, seed=seed, spp=spp_local, max_depth=max_depth,
            sample_offset=sample_base, pixel_base=base, pixel_count=count)
        m_local = m_local.to(cam.center.dtype)
    else:
        with torch.no_grad():
            for c0, k in slices:
                m, _ = grad_mod.radiance_mean_replay_rays(
                    scene, cam, pid, seed, records(k, c0), k, max_depth,
                    sample_base=sample_base + c0)
                m_local = m_local + m * (k / spp_local)
    img = mesh.assemble(m_local, base, n_pix)
    if mesh.n_sample > 1:
        img = img / mesh.n_sample
    loss, g_img = grad_mod._image_cotangent(sse, img, None)
    ct_local = g_img[base:base + count] / mesh.n_sample

    # ---- pass 2: record each slice again and accumulate its VJP
    grads = {n: torch.zeros_like(t) for n, t in leaves.items()}
    nrays = 0
    for c0, k in slices:
        ct = (ct_local * (k / spp_local)).to(cam.center.dtype)
        _, nr, dg = grad_mod._chunk_vjp(live, leaves, cam, pid, seed,
                                        records(k, c0), ct,
                                        sample_base + c0, k, max_depth)
        nrays += int(nr)
        grads = {n: grads[n] + dg[n] for n in grads}
    grads = all_reduce_grads(mesh, grads)
    nrays = int(mesh.all_reduce(torch.tensor([nrays], dtype=torch.int64,
                                             device=dev)).item())
    grad = scene.replace(**{
        f.name: grads[f.name] if f.name in grads
        else torch.zeros_like(getattr(scene, f.name))
        for f in dataclasses.fields(scene)
        if isinstance(getattr(scene, f.name), torch.Tensor)})
    return loss, grad, nrays


def make_replay_train_step(mesh, camera: Camera, spp: int, max_depth: int,
                           learning_rate: float = 1.0,
                           trainable: Tuple[str, ...] = ("tex_rgb",
                                                         "mat_albedo"),
                           recorder: str = "auto", dtype=torch.float32):
    """``step(scene, target_image (H,W,3), seed=0)`` -> (scene', loss): one
    SGD step on the ``trainable`` fields over the distributed record/replay
    gradient (record the rank's block, replay its VJP, one gradient
    all-reduce)."""

    def step(scene, target_image, seed: int = 0):
        loss, g, _ = replay_loss_and_grad(
            scene, camera, mesh, target_image, seed=seed, spp=spp,
            max_depth=max_depth, recorder=recorder, dtype=dtype)
        updates = {name: (getattr(scene, name)
                          - learning_rate * getattr(g, name)).detach()
                   for name in trainable}
        return scene.replace(**updates), loss

    return step
