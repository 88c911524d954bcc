"""Kind ``grad_steps``: ``grad.loss_and_grad`` of the frame's mean radiance
with respect to every float leaf, a new seed each step, one client in a
closed loop. A step ends with a synchronize and a gradient leaf copied to
the host.

Parameters of the mix: ``spp``, the samples a step; ``call``: keyword
arguments of ``loss_and_grad`` (``linear_loss``); ``with_rays`` is always
on.

The check (``numbers``): the whole frame's loss (``loss_gap``, relative),
every float leaf's gradient (``grad_gap``, ``check.leaf_gap``) and the
exact scene queries (``rays_gap``), against ``reference.grad``.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from port_bench import check, driver
from port_bench.reference import grad as ref_grad
from port_bench.reference import scenes as ref_scenes


def draw(d, k: int):
    return driver.Unit(int(d.rng.integers(driver.SEED_SPACE)), 0, d.spp, 0,
                       0.0, {})


def image_mean(img, pixel_ids):
    return img.mean()


def run(drv, u):
    grad = drv.prog["grad"]
    drv.sync()
    t0 = time.perf_counter()
    with drv.span("loss_and_grad"):
        loss, g, rays = grad.loss_and_grad(
            drv.scene, drv.camera, image_mean, seed=u.seed, spp=u.spp,
            max_depth=drv.depth, with_rays=True, **drv.mix.get("call", {}))
    with drv.span("copy"):
        drv.sync()
        g.tex_rgb.cpu()
    secs = time.perf_counter() - t0
    leaves = {f.name: getattr(g, f.name).detach().double().cpu().numpy()
              for f in dataclasses.fields(g)
              if isinstance(getattr(g, f.name), torch.Tensor)
              and getattr(g, f.name).is_floating_point()}
    return dataclasses.replace(u, rays=int(rays), seconds=secs,
                               kept=dict(loss=float(loss), grads=leaves))


def _reference(cell, units, device, dtype):
    scene = check.reference_scene(cell)
    view = ref_scenes.view(cell.cfg)
    for u in units:
        yield ref_grad.mean_and_grad(scene, view, u.seed, u.spp,
                                     int(cell.cfg["max_depth"]), device,
                                     dtype)


def numbers(cell, units, n_pix: int, device, dtype=torch.float32):
    loss_gap = grad_gap = rays_gap = 0.0
    for u, (loss, grads, rays) in zip(units, _reference(cell, units, device,
                                                        dtype)):
        loss_gap = check.worst(loss_gap, abs(u.kept["loss"] - loss)
                               / abs(loss))
        grad_gap = check.worst(grad_gap, check.leaf_gap(u.kept["grads"],
                                                        grads))
        rays_gap = check.worst(rays_gap, abs(u.rays - rays) / rays)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "rays_gap": rays_gap}


def answer(cell, units, n_pix: int, device, dtype):
    return [dataclasses.replace(u, rays=rays, kept=dict(loss=loss,
                                                        grads=grads))
            for u, (loss, grads, rays) in zip(units, _reference(
                cell, units, device, dtype))]
