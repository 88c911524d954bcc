"""Distributed render and differentiable train step over a mesh of ranks.

PyTorch counterpart of rust_tracing_tpu/parallel/render_dist.py. Each rank
traces its (pixel shard x sample range) block with the single-device code;
one all-reduce assembles the image, and one all-reduce sums the parameter
gradients. Scene tables are replicated: every rank holds the same scene.

Gradients are summed exactly once, explicitly. The reference gets that sum
from ``shard_map``'s transpose of a replicated input (and warns that an
explicit psum there double-counts); here each rank's graph covers only its
own block, so the one all-reduce after the local backward is the whole
gradient:

1. every rank all-reduces its detached forward sums into the full mean
   image M, so every rank computes the same loss with no further
   collective;
2. each rank backpropagates its local graph with the cotangent
   ``dL/dM / spp`` on its own pixels;
3. one all-reduce (sum) of the flattened parameter gradients.
"""

from __future__ import annotations

import time as _time
from typing import Optional, Tuple

import numpy as np
import torch

from ..camera import Camera
from ..grad import _grads
from ..ops import megakernel as mk
from ..renderer import _auto_chunk, render_chunk, use_megakernel_default
from ..utils import metrics
from . import mesh as mesh_mod


def _local_radiance_sum(scene, cam, pixel_ids, seed: int, sample_base: int,
                        spp_local: int, max_depth: int, hit_fn=None):
    """(sum of radiance samples ``sample_base .. sample_base + spp_local``
    for this rank's pixel ids, int64 ray count), through the tensor
    integrator. The RNG is addressed by (seed, pixel, sample); the rank
    never enters it."""
    return render_chunk(scene, cam, pixel_ids, seed, sample_base, spp_local,
                        max_depth, hit_fn)


def all_reduce_grads(mesh, grads: dict) -> dict:
    """Sum every gradient over every rank with ONE all-reduce of their
    concatenation (grouped by dtype: one collective for an f32 scene)."""
    out = dict(grads)
    by_dtype = {}
    for name, g in grads.items():
        by_dtype.setdefault(g.dtype, []).append(name)
    for names in by_dtype.values():
        flat = torch.cat([grads[n].reshape(-1) for n in names])
        mesh.all_reduce(flat)
        i = 0
        for n in names:
            k = grads[n].numel()
            out[n] = flat[i:i + k].reshape(grads[n].shape)
            i += k
    return out


def make_distributed_renderer(mesh, spp: int, max_depth: int, hit_fn=None):
    """``fn(scene, cam, pixel_ids, seed)`` -> (P,3) mean radiance of every
    pixel id, on every rank. ``pixel_ids`` is the same (P,) list on every
    rank; each rays-shard traces its contiguous part of it, in chunks of
    ``renderer._auto_chunk`` pixels, over its sample range."""
    n_sample = mesh.n_sample
    if spp % n_sample:
        raise ValueError(f"spp={spp} not divisible by sample axis "
                         f"{n_sample}")
    spp_local = spp // n_sample

    def fn(scene, cam, pixel_ids, seed: int):
        n_total = pixel_ids.shape[0]
        base, count = mesh_mod.shard_range(n_total, mesh)
        chunk = _auto_chunk(scene)
        acc = torch.zeros((count, 3), dtype=cam.center.dtype,
                          device=pixel_ids.device)
        with torch.no_grad():
            for c0 in range(0, count, chunk):
                ids = pixel_ids[base + c0:base + min(count, c0 + chunk)]
                acc[c0:c0 + ids.shape[0]], _ = _local_radiance_sum(
                    scene, cam, ids, seed, mesh.sample_idx * spp_local,
                    spp_local, max_depth, hit_fn)
        return mesh.assemble(acc, base, n_total) / spp

    return fn


def render_distributed(scene, camera: Camera, mesh=None, seed: int = 0,
                       spp: Optional[int] = None,
                       max_depth: Optional[int] = None, hit_fn=None,
                       dtype=torch.float32,
                       use_megakernel: Optional[bool] = None) -> np.ndarray:
    """Full-image distributed render -> (H,W,3) linear float64 (numpy, as
    ``renderer.render``) on every rank.

    The fused path (``megakernel.render_fast_sharded``: one kernel launch a
    rank) serves every scene the fused render supports in f32 with no
    custom ``hit_fn`` when spp splits evenly over the sample axis; the
    tensor integrator (``make_distributed_renderer``) serves the rest, with
    spp rounded up to a multiple of the sample axis. ``mesh=None`` is the
    1x1 mesh on the GPU."""
    mesh = mesh or mesh_mod.make_mesh()
    spp = spp or camera.samples_per_pixel
    max_depth = max_depth or camera.max_depth
    if use_megakernel is None:
        use_megakernel = (use_megakernel_default(scene, dtype, hit_fn)
                          and spp % mesh.n_sample == 0)
    if use_megakernel:
        t0 = _time.perf_counter()
        img, nrays = mk.render_fast_sharded(scene, camera, mesh, seed=seed,
                                            spp=spp, max_depth=max_depth,
                                            with_stats=True)
        dt = _time.perf_counter() - t0
        metrics.emit("render_distributed", path="megakernel_sharded",
                     mesh=mesh.shape, spp=spp, seconds=dt, rays=nrays,
                     rays_per_sec=nrays / dt if dt > 0 else 0.0)
        return img.astype(np.float64)

    if hit_fn is None:
        from ..ops.bvh_traverse import auto_closest_hit

        hit_fn = auto_closest_hit(scene)
    if spp % mesh.n_sample:
        spp = spp + (mesh.n_sample - spp % mesh.n_sample)
    w, h = camera.image_width, camera.image_height
    pixel_ids = torch.arange(w * h, dtype=torch.int32, device=scene.device)
    render_fn = make_distributed_renderer(mesh, spp, max_depth, hit_fn)
    img = render_fn(scene, camera.constants(dtype, device=scene.device),
                    pixel_ids, seed)
    return img.cpu().numpy().astype(np.float64).reshape(h, w, 3)


def make_distributed_train_step(mesh, spp: int, max_depth: int,
                                learning_rate: float = 1.0, hit_fn=None,
                                trainable: Tuple[str, ...] = ("tex_rgb",
                                                             "mat_albedo")):
    """``step(scene, cam, pixel_ids, target (P,3), seed)`` -> (scene', loss):
    one SGD step on the ``trainable`` float fields of the SSE between the
    (P,3) mean image of ``pixel_ids`` and ``target``, differentiating
    through the tensor integrator (the direct estimator; the record/replay
    step is ``grad_dist.make_replay_train_step``). Every rank passes the
    same arguments and gets the same result."""
    n_sample = mesh.n_sample
    if spp % n_sample:
        raise ValueError(f"spp={spp} not divisible by sample axis "
                         f"{n_sample}")
    spp_local = spp // n_sample

    def step(scene, cam, pixel_ids, target, seed: int):
        n_total = pixel_ids.shape[0]
        base, count = mesh_mod.shard_range(n_total, mesh)
        leaves = {n: getattr(scene, n).detach().requires_grad_(True)
                  for n in trainable
                  if getattr(scene, n).is_floating_point()}
        live = scene.replace(**leaves)
        with torch.enable_grad():
            acc, _ = _local_radiance_sum(
                live, cam, pixel_ids[base:base + count], seed,
                mesh.sample_idx * spp_local, spp_local, max_depth, hit_fn)
            mean = (mesh.assemble(acc.detach(), base, n_total) / spp
                    ).requires_grad_(True)
            loss = torch.sum((mean - target) ** 2)
            (g_mean,) = torch.autograd.grad(loss, mean)
            grads = _grads(acc, leaves, g_mean[base:base + count] / spp)
        grads = all_reduce_grads(mesh, grads)
        new = {n: (getattr(scene, n) - learning_rate * grads[n]).detach()
               for n in leaves}
        return scene.replace(**new), loss.detach()

    return step
