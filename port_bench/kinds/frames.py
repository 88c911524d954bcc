"""Kind ``frames``: frames or slices through ``renderer.render``, one client
in a closed loop.

Parameters of the mix: ``spp``, the samples a call (``"config"``: the
configuration's); ``progressive``: false, every frame takes its own seed
and samples from 0; true, one seed a run, slice k takes samples from
``spp * k`` (wrapping at the configuration's samples per pixel), and the
host keeps the running mean ``accum += (img - accum) * spp / n``;
``call``: keyword arguments of ``render`` (``use_megakernel``);
``check.pixels``: the pixels of a unit the reference recomputes.

The check (``numbers``): the sampled pixels' mean radiance over the unit's
own seed and samples (``pixel_gap``: the largest gap over the pixels'
channels, over the pixels' mean), and the frame's scene queries a sample
against the sampled pixels' (``rays_gap``, relative).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from port_bench import check, driver
from port_bench.reference import scenes as ref_scenes
from port_bench.reference import trace as ref_trace


def draw(d, k: int):
    if d.mix["progressive"]:
        seed = d.run_seed
        sample0 = (k * d.spp) % int(d.cfg["samples_per_pixel"])
    else:
        seed, sample0 = int(d.rng.integers(driver.SEED_SPACE)), 0
    pixels = np.sort(d.rng.choice(d.n_pix, int(d.mix["check"]["pixels"]),
                                  replace=False))
    return driver.Unit(seed, sample0, d.spp, 0, 0.0, dict(pixels=pixels))


def run(drv, u):
    t0 = time.perf_counter()
    with drv.span("render"):
        img, stats = drv.prog["renderer"].render(
            drv.scene, drv.camera, seed=u.seed, spp=u.spp,
            sample_offset=u.sample0, device=drv.dev,
            **drv.mix.get("call", {}))
    secs = time.perf_counter() - t0
    flat = img.reshape(-1, 3)
    if drv.mix["progressive"]:
        with drv.span("accumulate"):
            _accumulate(drv.state, flat, u)
    pixels = u.kept["pixels"]
    return dataclasses.replace(u, rays=int(stats.rays), seconds=secs,
                               kept=dict(pixels=pixels,
                                         values=flat[pixels].copy()))


def _accumulate(st, flat, u):
    """accum += (img - accum) * spp / n, in buffers allocated once: a fresh
    15 MB array a slice would page-fault anew."""
    if "accum" not in st:
        st["accum"] = np.zeros_like(flat)
        st["delta"] = np.empty_like(flat)
        st["n"] = 0
    if u.sample0 == 0:
        st["accum"].fill(0.0)
        st["n"] = 0
    st["n"] += u.spp
    np.subtract(flat, st["accum"], out=st["delta"])
    st["delta"] *= u.spp / st["n"]
    st["accum"] += st["delta"]


def _reference(cell, units, device, dtype):
    """The reference's mean radiance and queries of each unit's pixels."""
    tb = ref_scenes.tables(check.reference_scene(cell), device, dtype)
    view = ref_scenes.view(cell.cfg)
    for u in units:
        pixels = torch.as_tensor(u.kept["pixels"], dtype=torch.int32,
                                 device=device)
        yield ref_trace.pixel_means(tb, view, u.seed, pixels, u.sample0,
                                    u.spp, int(cell.cfg["max_depth"]))


def numbers(cell, units, n_pix: int, device, dtype=torch.float32):
    pixel_gap = rays_gap = 0.0
    for u, (rgb, rays) in zip(units, _reference(cell, units, device, dtype)):
        ref = rgb.double().cpu().numpy()
        got = u.kept["values"]
        gap = np.abs(got - ref).max() / max(np.abs(ref).mean(), 1e-6)
        pixel_gap = check.worst(pixel_gap, gap)
        ref_rate = float(rays.sum()) / (len(u.kept["pixels"]) * u.spp)
        got_rate = u.rays / (n_pix * u.spp)
        rays_gap = check.worst(rays_gap, abs(got_rate - ref_rate) / ref_rate)
    return {"pixel_gap": pixel_gap, "rays_gap": rays_gap}


def answer(cell, units, n_pix: int, device, dtype):
    out = []
    for u, (rgb, rays) in zip(units, _reference(cell, units, device, dtype)):
        # the frame's queries, scaled from the sampled pixels'
        total = int(round(float(rays.sum()) * n_pix / len(u.kept["pixels"])))
        out.append(dataclasses.replace(u, rays=total, kept=dict(
            pixels=u.kept["pixels"], values=rgb.double().cpu().numpy())))
    return out
