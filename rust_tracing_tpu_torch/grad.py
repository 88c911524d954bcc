"""Differentiable rendering: gradients of radiance w.r.t. scene parameters.

PyTorch counterpart of rust_tracing_tpu/grad.py: reverse-mode gradients of a
loss of the rendered image w.r.t. every float leaf of the CompiledScene
(sphere centres and radii, albedos, texture colours, media densities, ...).

The RNG is fixed per (seed, pixel, sample, bounce), so the Monte-Carlo
estimator is a deterministic function of the scene. Discrete decisions
(closest-hit winner, material branch, Schlick coin, medium scatter or not)
are piecewise constant in the parameters; autodiff flows through the
continuous quantities (t, hit points, normals, attenuations) within each
region. This matches finite differences of the same fixed-RNG estimator away
from the decision boundaries; the silhouette boundary term is not estimated.

Two estimators, as in the reference:

- direct (``use_recorder=False``): the tensor integrator (ops/integrator.py)
  searches and shades under autodiff;
- record/replay (``use_recorder`` on, the default on every device): the
  recorder (ops/megakernel.record_paths: the CUDA kernel on a GPU, its plain
  version on the CPU) records every bounce's winner, and the differentiable
  pass replays them (ops/replay.py) with O(rays) work. A workload whose
  records exceed ``RECORD_BUDGET_ENTRIES`` runs as two-pass gradient
  accumulation over sample slices.

Float sums whose order is part of the result: samples are added strictly in
sample order (``_sum_samples``), chunks in chunk order, and the mean is
divided by spp at the end; the slice cotangent is scaled by k/spp. The ray
count is an exact int64 (the reference sums f32).
"""

from __future__ import annotations

import dataclasses
import time as _time
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .camera import Camera, CameraConstants, get_rays
from .ops import integrator
from .ops import megakernel as mk
from .ops import replay as replay_mod
from .ops.bvh_traverse import auto_closest_hit
from .utils import metrics

# Flattened (sample x pixel) wavefront budget: the largest ray batch one
# bounce holds at once. Copied from the reference, which sized it (and
# RECORD_BUDGET_ENTRIES below) for a TPU v5e's memory. Both decide how the
# samples are sliced, and so the float association of the result.
REPLAY_RAY_BUDGET = 1 << 22

# Bound on the record entries (int32) held on the device at once; past it
# the gradient runs as two-pass accumulation over sample slices.
RECORD_BUDGET_ENTRIES = 1 << 26


def _sum_samples(rad, k: int, C: int):
    """Sum a flattened (k*C, 3) radiance batch over its k samples in a
    strictly sequential association: s0 + s1 + ... + s_{k-1}. Every
    estimator (direct, replay, fused kernel) shares this one order."""
    rad = rad.reshape(k, C, 3)
    acc = rad[0]
    for i in range(1, k):
        acc = acc + rad[i]
    return acc


def _needs_graph(scene) -> bool:
    """Whether autograd is recording a graph of the scene's leaves that a
    per-chunk checkpoint can shorten. Not under a torch.func transform
    (jacrev, vjp, grad), which refuses checkpoint's saved-tensor hooks."""
    if torch._C._functorch.peek_interpreter_stack() is not None:
        return False
    return torch.is_grad_enabled() and any(
        isinstance(v, torch.Tensor) and v.requires_grad
        for v in vars(scene).values())


def _chunked_mean(scene, pixel_ids, spp: int, sample_chunk: int, dtype,
                  chunk_rad):
    """Shared sample-flattening driver of both estimators: ``sample_chunk``
    samples per wavefront, chunk sums added in chunk order, divided by spp
    at the end. ``chunk_rad(s0, k)`` -> (radiance sum (C,3), int64 ray
    count). Each chunk is checkpointed when a graph is being built, so the
    backward pass holds one chunk's tensors at a time."""
    C = pixel_ids.shape[0]
    K = min(sample_chunk, spp)
    acc = torch.zeros((C, 3), dtype=dtype, device=pixel_ids.device)
    nrays = torch.zeros((), dtype=torch.int64, device=pixel_ids.device)
    run = chunk_rad
    if _needs_graph(scene):
        def run(s0, k):
            return checkpoint(chunk_rad, s0, k, use_reentrant=False)
    n_full = spp // K
    for c in range(n_full):
        rad, nb = run(c * K, K)
        acc, nrays = acc + rad, nrays + nb
    rem = spp - n_full * K
    if rem:
        rad, nb = run(n_full * K, rem)
        acc, nrays = acc + rad, nrays + nb
    return acc / spp, nrays


def _wavefront(pixel_ids, s0: int, k: int):
    """(pixel, sample) ids of a k-sample wavefront: samples major."""
    C = pixel_ids.shape[0]
    pix = pixel_ids.repeat(k)
    samp = s0 + torch.arange(k, dtype=torch.int32,
                             device=pixel_ids.device).repeat_interleave(C)
    return pix, samp


def radiance_mean_rays(scene, cam: CameraConstants, pixel_ids, seed: int,
                       spp: int, max_depth: int, hit_fn=None,
                       remat: bool = False,
                       sample_chunk: Optional[int] = None):
    """(mean radiance (C,3), rays traced) over ``spp`` fixed-RNG samples of
    the direct estimator. Differentiable w.r.t. the scene's tensors. The
    direct path holds the (rays x primitives) search, so its chunk budget is
    scaled down by the primitive count."""
    C = pixel_ids.shape[0]
    if sample_chunk is None:
        n_prims = scene.sph_radius.shape[0] + scene.quad_mat.shape[0]
        budget = max(1 << 14, REPLAY_RAY_BUDGET // max(1, n_prims // 8))
        sample_chunk = max(1, min(spp, budget // max(C, 1)))

    def chunk_rad(s0: int, k: int):
        pix, samp = _wavefront(pixel_ids, s0, k)
        o, d, t = get_rays(cam, seed, pix, samp)
        rad, nb = integrator.trace(scene, o, d, t, (seed, pix, samp),
                                   max_depth, closest_hit_fn=hit_fn,
                                   remat=remat)
        return _sum_samples(rad, k, C), nb.sum(dtype=torch.int64)

    return _chunked_mean(scene, pixel_ids, spp, sample_chunk,
                         cam.center.dtype, chunk_rad)


def radiance_mean(scene, cam: CameraConstants, pixel_ids, seed: int,
                  spp: int, max_depth: int, hit_fn=None):
    """Mean radiance per pixel over ``spp`` fixed-RNG samples, (C,3)."""
    return radiance_mean_rays(scene, cam, pixel_ids, seed, spp, max_depth,
                              hit_fn)[0]


def radiance_mean_replay_rays(scene, cam: CameraConstants, pixel_ids,
                              seed: int, records, spp: int, max_depth: int,
                              sample_chunk: Optional[int] = None,
                              sample_base: int = 0):
    """Search-free differentiable radiance mean from recorded winners
    (ops/replay.py). ``records`` is (max_depth, spp, C) int32 aligned with
    ``pixel_ids``. ``sample_base`` offsets the global sample indices (RNG
    address and camera jitter) while the records stay slice-local: the
    gradient accumulation records and replays the spp axis in slices.
    Samples are flattened into the ray batch, ``sample_chunk`` per wavefront
    (default: as many as fit REPLAY_RAY_BUDGET)."""
    C = pixel_ids.shape[0]
    if sample_chunk is None:
        sample_chunk = max(1, min(spp, REPLAY_RAY_BUDGET // max(C, 1)))

    def chunk_rad(s0: int, k: int):
        pix, samp = _wavefront(pixel_ids, sample_base + s0, k)
        o, d, t = get_rays(cam, seed, pix, samp)
        # depth-major records: a bounce row of the chunk is a reshape
        recs = records[:, s0:s0 + k].reshape(max_depth, k * C)
        rad, nb = replay_mod.trace_replay(scene, o, d, t, (seed, pix, samp),
                                          recs, max_depth)
        return _sum_samples(rad, k, C), nb.sum(dtype=torch.int64)

    return _chunked_mean(scene, pixel_ids, spp, sample_chunk,
                         cam.center.dtype, chunk_rad)


def _is_identity_pixels(pixel_ids, n_pix: int) -> bool:
    """True when ``pixel_ids`` is exactly arange(n_pix), the full frame in
    order."""
    if pixel_ids.shape[0] != n_pix:
        return False
    return bool(torch.equal(pixel_ids.long(), torch.arange(
        n_pix, dtype=torch.int64, device=pixel_ids.device)))


def get_records(scene, camera: Camera, seed: int, spp: int, max_depth: int,
                pixel_ids=None, hit_fn=None, dtype=torch.float32,
                sample_offset: int = 0, prefer_kernel: bool = True):
    """Per-(sample, bounce) winner records of global samples
    ``sample_offset .. sample_offset + spp`` for the replay pipeline, as
    (max_depth, spp, len(pixel_ids)) int32 on the scene's device.

    The recorder (ops/megakernel.record_paths: the CUDA kernel on a GPU, its
    plain version on the CPU) runs over the whole frame, subset by
    ``pixel_ids`` afterwards. ``prefer_kernel=False`` takes the tensor
    search instead (``replay.records_xla``), which a custom ``hit_fn``
    needs. Records are data, not a differentiable quantity."""
    n_pix = camera.image_width * camera.image_height
    if prefer_kernel and mk.supports(scene):
        recs = mk.record_paths(scene, camera, seed, spp, max_depth,
                               sample_offset=sample_offset)
        if pixel_ids is not None and not _is_identity_pixels(pixel_ids,
                                                            n_pix):
            recs = recs.index_select(2, pixel_ids.long())
        return recs
    cam = camera.constants(dtype, device=scene.device)
    if pixel_ids is None:
        pixel_ids = torch.arange(n_pix, dtype=torch.int32,
                                 device=scene.device)
    return replay_mod.records_xla(scene, cam, pixel_ids, seed, spp,
                                  max_depth, hit_fn,
                                  sample_offset=sample_offset)


def _float_leaves(scene) -> Dict[str, torch.Tensor]:
    """Fresh leaf copies (requires_grad) of the scene's float tensors."""
    return {f.name: getattr(scene, f.name).detach().requires_grad_(True)
            for f in dataclasses.fields(scene)
            if isinstance(getattr(scene, f.name), torch.Tensor)
            and getattr(scene, f.name).is_floating_point()}


def _grads(out, leaves: Dict[str, torch.Tensor], grad_outputs=None):
    """d out / d leaf for every leaf; zeros where ``out`` does not depend on
    it."""
    names = list(leaves)
    if not out.requires_grad:
        return {n: torch.zeros_like(leaves[n]) for n in names}
    gs = torch.autograd.grad(out, [leaves[n] for n in names],
                             grad_outputs=grad_outputs, allow_unused=True)
    return {n: (g if g is not None else torch.zeros_like(leaves[n]))
            for n, g in zip(names, gs)}


def loss_and_grad(scene, camera: Camera, loss_fn: Callable, seed: int = 0,
                  spp: Optional[int] = None, max_depth: Optional[int] = None,
                  pixel_ids=None, hit_fn=None, dtype=torch.float32,
                  with_rays: bool = False, remat: bool = False,
                  use_recorder: Optional[bool] = None,
                  linear_loss: bool = False):
    """(loss, d loss / d scene) for ``loss_fn(image_flat (C,3), pixel_ids)``.

    ``pixel_ids`` defaults to the full image. The gradient is returned as a
    CompiledScene whose float fields hold gradients and whose int/bool
    fields hold zeros. With ``with_rays``, returns (loss, grad, rays) where
    rays is the exact forward scene-query count (the backward pass replays
    the same paths, so forward+backward rays/s is measured against it).

    ``use_recorder`` selects the record/replay estimator: ``None`` means on,
    on every device (the CPU runs the recorder's plain version, so it runs
    the same pipeline as the GPU); ``False`` is the direct estimator.

    ``linear_loss``: the caller asserts d loss / d image is constant (mean
    or weighted-sum losses). The sliced path then skips its forward render:
    the cotangent is taken at a zero image and the loss at the image the
    slices reconstruct. A linearity probe rejects a nonlinear loss
    (ValueError).

    ``remat`` recomputes each bounce of the direct estimator in the backward
    pass; it changes memory, not values.
    """
    spp = spp or camera.samples_per_pixel
    max_depth = max_depth or camera.max_depth
    custom_hit = hit_fn is not None
    if hit_fn is None:  # a scene compiled with a BVH searches it
        hit_fn = auto_closest_hit(scene)
    dev = scene.device
    cam = camera.constants(dtype, device=dev)
    if pixel_ids is None:
        pixel_ids = torch.arange(camera.image_width * camera.image_height,
                                 dtype=torch.int32, device=dev)
    C = pixel_ids.shape[0]
    if linear_loss:
        _check_linear_loss(loss_fn, pixel_ids, C, cam.center.dtype)

    leaves = _float_leaves(scene)
    live = scene.replace(**leaves)
    if use_recorder is None:
        use_recorder = True

    if use_recorder and spp * max_depth * C > RECORD_BUDGET_ENTRIES:
        if remat:
            warnings.warn(
                "loss_and_grad: remat is ignored on the sliced accumulation "
                "path (each sample chunk is already checkpointed); results "
                "are identical, only memory differs.", stacklevel=2)
        loss, nrays, grads = _chunked_recorder_vag(
            scene, live, leaves, camera, loss_fn, seed, spp, max_depth,
            pixel_ids, hit_fn, dtype, cam, linear_loss=linear_loss,
            allow_kernel=not custom_hit)
    else:
        records = None
        if use_recorder:
            records = get_records(scene, camera, seed, spp, max_depth,
                                  pixel_ids=pixel_ids, hit_fn=hit_fn,
                                  dtype=dtype, prefer_kernel=not custom_hit)
        loss, nrays, grads = _vag(live, leaves, cam, pixel_ids, seed,
                                  records, spp, max_depth, hit_fn, remat,
                                  loss_fn)
    grad = scene.replace(**{
        f.name: grads[f.name] if f.name in grads
        else torch.zeros_like(getattr(scene, f.name))
        for f in dataclasses.fields(scene)
        if isinstance(getattr(scene, f.name), torch.Tensor)})
    if with_rays:
        return loss, grad, int(nrays)
    return loss, grad


def _check_linear_loss(loss_fn, pixel_ids, C, dtype):
    """``linear_loss=True`` asserts that d loss / d image is constant;
    misuse would silently give a wrong loss and gradient. For an affine
    loss, loss(2x) - 2 loss(x) + loss(0) is zero: three tiny loss
    evaluations make misuse fail loudly."""
    dev = pixel_ids.device
    x = (torch.arange(C * 3, dtype=torch.float32, device=dev)
         * 0.6180339887) % 1.0
    x = x.reshape(C, 3).to(dtype)
    with torch.no_grad():
        l0 = float(loss_fn(torch.zeros_like(x), pixel_ids))
        l1 = float(loss_fn(x, pixel_ids))
        l2 = float(loss_fn(2.0 * x, pixel_ids))
    resid = abs(l2 - 2.0 * l1 + l0)
    scale = max(abs(l1 - l0), abs(l0), 1e-30)
    if not resid <= 1e-3 * scale + 1e-12:  # 'not <=' also catches NaN
        raise ValueError(
            "loss_and_grad(linear_loss=True): loss_fn failed the linearity "
            f"probe (|l(2x)-2l(x)+l(0)| = {resid:.3e} vs scale {scale:.3e}). "
            "linear_loss requires d loss/d image to be CONSTANT (mean / "
            "weighted-sum losses); drop the flag for nonlinear losses.")


def _image_cotangent(loss_fn, img, pixel_ids):
    """(loss, d loss / d img) at ``img``."""
    img = img.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = loss_fn(img, pixel_ids)
        if not loss.requires_grad:
            return loss.detach(), torch.zeros_like(img)
        (g,) = torch.autograd.grad(loss, img)
    return loss.detach(), g


def _chunked_recorder_vag(scene, live, leaves, camera, loss_fn, seed, spp,
                          max_depth, pixel_ids, hit_fn, dtype, cam,
                          linear_loss=False, allow_kernel=True):
    """Two-pass gradient accumulation for record/replay workloads whose
    records do not fit at once:

      1. forward: the full-spp mean image, from the fused render kernel (B1)
         for the solid/checker families, where it is the same estimator as
         the replay, else by the sliced replay forward; the loss cotangent
         d loss / d image is taken once at that image;
      2. backward: for each sample slice, record (at ``sample_offset``) and
         accumulate the slice's VJP with cotangent (k/spp) * d loss/d image.
         Radiance is linear in the per-slice means, so the accumulated VJPs
         are the full-workload gradient up to the float association of the
         slice partition.

    With ``linear_loss`` pass 1 is skipped: the cotangent is taken at a zero
    image and the loss at the image the slices reconstruct.
    ``allow_kernel=False`` (custom hit_fn) uses the tensor search for the
    forward and the records.

    Returns (loss, rays, grads by leaf name)."""
    C = pixel_ids.shape[0]
    spp_chunk = max(1, min(spp, RECORD_BUDGET_ENTRIES // (max_depth * C)))

    # ---- pass 1: full-spp forward mean + loss cotangent
    if linear_loss:
        zero_img = torch.zeros((C, 3), dtype=cam.center.dtype,
                               device=pixel_ids.device)
        _, g_img = _image_cotangent(loss_fn, zero_img, pixel_ids)
    else:
        kernel_exact = not (scene.has_noise or scene.has_image)
        if allow_kernel and kernel_exact and mk.supports(scene):
            img_full = mk.render_fast(scene, camera, seed=seed, spp=spp,
                                      max_depth=max_depth)
            img_flat = torch.from_numpy(img_full.reshape(-1, 3)).to(
                device=pixel_ids.device, dtype=cam.center.dtype)[
                    pixel_ids.long()]
        else:  # sliced replay forward: the estimator being differentiated
            img_flat = torch.zeros((C, 3), dtype=cam.center.dtype,
                                   device=pixel_ids.device)
            with torch.no_grad():
                for c0 in range(0, spp, spp_chunk):
                    k = min(spp_chunk, spp - c0)
                    recs = get_records(scene, camera, seed, k, max_depth,
                                       pixel_ids=pixel_ids, hit_fn=hit_fn,
                                       dtype=dtype, sample_offset=c0,
                                       prefer_kernel=allow_kernel)
                    m, _ = radiance_mean_replay_rays(
                        scene, cam, pixel_ids, seed, recs, k, max_depth,
                        sample_base=c0)
                    img_flat = img_flat + m * (k / spp)
        loss, g_img = _image_cotangent(loss_fn, img_flat, pixel_ids)

    # ---- pass 2: accumulate the slices' VJPs (+ the image when linear)
    grads = None
    nrays = 0
    img_acc = None
    for c0 in range(0, spp, spp_chunk):
        k = min(spp_chunk, spp - c0)
        recs = get_records(scene, camera, seed, k, max_depth,
                           pixel_ids=pixel_ids, hit_fn=hit_fn, dtype=dtype,
                           sample_offset=c0, prefer_kernel=allow_kernel)
        ct = (g_img * (k / spp)).to(cam.center.dtype)
        img_k, nr, dg = _chunk_vjp(live, leaves, cam, pixel_ids, seed, recs,
                                   ct, c0, k, max_depth)
        del recs
        nrays += int(nr)
        grads = dg if grads is None else {n: grads[n] + dg[n] for n in grads}
        if linear_loss:
            w_img = img_k * (k / spp)
            img_acc = w_img if img_acc is None else img_acc + w_img
    if linear_loss:
        with torch.no_grad():
            loss = loss_fn(img_acc, pixel_ids)
    return loss, nrays, grads


def _chunk_vjp(live, leaves, cam, pixel_ids, seed, records, ct, sample_base,
               spp, max_depth):
    """VJP of one sample slice's replay mean with an external cotangent:
    (image, rays, grads by leaf name)."""
    with torch.enable_grad():
        img, nr = radiance_mean_replay_rays(live, cam, pixel_ids, seed,
                                            records, spp, max_depth,
                                            sample_base=sample_base)
        dg = _grads(img, leaves, grad_outputs=ct)
    return img.detach(), nr, dg


def _vag(live, leaves, cam, pixel_ids, seed, records, spp, max_depth,
         hit_fn, remat, loss_fn):
    """Value and gradient of the single-shot path: ``records is None``
    selects the direct estimator."""
    with torch.enable_grad():
        if records is not None:
            img, nrays = radiance_mean_replay_rays(
                live, cam, pixel_ids, seed, records, spp, max_depth)
        else:
            img, nrays = radiance_mean_rays(live, cam, pixel_ids, seed, spp,
                                            max_depth, hit_fn, remat=remat)
        loss = loss_fn(img, pixel_ids)
        grads = _grads(loss, leaves)
    return loss.detach(), int(nrays), grads


def l2_to_target(target_flat):
    """Convenience loss: mean squared error to a target image (C,3)."""
    t = torch.as_tensor(target_flat)

    def loss(img, pixel_ids):
        d = img - t.to(img.device)
        return torch.mean(d * d)

    return loss


def fit_scene(scene, camera: Camera, target_image: np.ndarray, steps: int,
              learning_rates: dict, seed: int = 0, spp: int = 16,
              max_depth: int = 4, log_every: int = 0,
              resample: bool = True):
    """Tiny inverse-rendering loop: SGD on selected scene leaves.

    ``learning_rates`` maps CompiledScene field names to step sizes; other
    leaves stay frozen. ``resample=False`` keeps the RNG fixed across steps
    (a deterministic objective). Returns (scene, losses)."""
    dtype = scene.background.dtype
    target = torch.as_tensor(np.asarray(target_image).reshape(-1, 3),
                             dtype=dtype, device=scene.device)
    loss_fn = l2_to_target(target)
    losses = []
    for step in range(steps):
        t0 = _time.perf_counter()
        loss, g, nrays = loss_and_grad(scene, camera, loss_fn,
                                       seed=seed + step if resample else seed,
                                       spp=spp, max_depth=max_depth,
                                       dtype=dtype, with_rays=True)
        scene = scene.replace(**{
            name: (getattr(scene, name) - lr * getattr(g, name)).detach()
            for name, lr in learning_rates.items()})
        losses.append(float(loss))
        dt = _time.perf_counter() - t0
        metrics.emit("train_step", step=step, loss=float(loss), seconds=dt,
                     rays=nrays, rays_per_sec=nrays / dt if dt > 0 else 0.0)
        if log_every and step % log_every == 0:
            print(f"step {step}: loss {float(loss):.6f}")
    return scene, losses
