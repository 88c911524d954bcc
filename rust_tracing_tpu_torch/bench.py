"""Headline benchmark of the port: forward+backward rays/s on one card for
the Cornell box (600x600 @ 200 spp, depth 8), the counterpart of the
repository's ``bench.py``.

Run: ``python -m rust_tracing_tpu_torch.bench`` (on the GPU; ``run(...,
device="cpu")`` runs the kernels' plain versions). Prints ONE JSON line:
``{"metric", "value", "unit", "vs_baseline", "aux"}``, with the reference's
metric name and the same denominator: 20 Mrays/s, the documented estimate
of the Rust reference on a multi-core CPU (BASELINE.md).

What runs (``run``):
  1. forward+backward (HEADLINE): ``grad.loss_and_grad`` of the image mean
     (``linear_loss=True``) w.r.t. every float scene leaf over the full
     frame: the recorder (B2) and the differentiable replay, in sample
     slices. One warm-up call, then ``repeats`` timed calls, each closed by
     ``torch.cuda.synchronize()`` and a copy of a gradient leaf to the host.
     rays/s = the exact int64 count of forward scene queries (the backward
     replays the same paths) over the timed calls' seconds.
  2. forward (aux): ``render()`` of the same frame (the fused render, B1),
     exact rays.
  3. forward+backward with the nonlinear loss ``grad.l2_to_target`` of that
     image (aux): pass 1 renders the frame with B1 for the cotangent.
  4. parity (aux): the fused render against the tensor integrator
     (``use_megakernel=True`` / ``False``) at 200 px @ 512 spp as a
     mean-image ratio; target |1 - r| < 1 %. Unlike the reference, which
     skips it off the TPU, both paths run on every device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from typing import Optional

import torch

from . import grad as grad_mod
from . import renderer
from .camera import Camera
from .config import resolve_device
from .models import builders
from .models.compile import compile_scene
from .runtime import kernels

REFERENCE_CPU_RAYS_PER_SEC = 20e6  # documented estimate, see BASELINE.md
METRIC = "cornell600_200spp_fwdbwd_rays_per_sec_per_chip"

WIDTH = 600
SPP = 200
MAX_DEPTH = 8
PARITY_WIDTH = 200
PARITY_SPP = 512
REPEATS = 2


def card_line(dev: torch.device) -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` prints them; None
    on the CPU."""
    if dev.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_grad(scene, camera, loss_fn, seed: int, spp: int, max_depth: int,
               linear: bool):
    """One ``loss_and_grad`` call on the host clock, closed by a
    synchronize and a copy of a gradient leaf to the host: (loss, rays,
    seconds, kernel launches of the call)."""
    dev = scene.device
    before = dict(kernels.LAUNCHES)
    _sync(dev)
    t0 = time.perf_counter()
    loss, g, rays = grad_mod.loss_and_grad(
        scene, camera, loss_fn, seed=seed, spp=spp, max_depth=max_depth,
        with_rays=True, linear_loss=linear)
    _sync(dev)
    g.tex_rgb.cpu()
    secs = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                if v != before[k]}
    return float(loss), rays, secs, launches


def _mean_loss(im, pixel_ids):
    return im.mean()


def run(width: int = WIDTH, spp: int = SPP, max_depth: int = MAX_DEPTH,
        parity_width: int = PARITY_WIDTH, parity_spp: int = PARITY_SPP,
        repeats: int = REPEATS, device=None) -> dict:
    """The benchmark at the given sizes -> the result line as a dict (the
    CLI prints it). The timed headline calls use seeds 1..repeats, the
    warm-up seed 0."""
    dev = resolve_device(device)
    b, settings = builders.cornell_box()
    settings = dataclasses.replace(settings, image_width=width,
                                   samples_per_pixel=spp, max_depth=max_depth)
    scene = compile_scene(b, device=dev)
    camera = Camera.create(settings)
    n_samples = width * settings.image_height * spp

    # ---- forward (aux): render() of the same frame, after a warm-up
    renderer.render(scene, camera, device=dev)
    img, stats = renderer.render(scene, camera, seed=1, device=dev)

    # ---- parity: the fused render against the tensor integrator
    pcam = Camera.create(dataclasses.replace(
        settings, image_width=parity_width, samples_per_pixel=parity_spp))
    img_mk, st_mk = renderer.render(scene, pcam, seed=7, use_megakernel=True,
                                    device=dev)
    img_t, st_t = renderer.render(scene, pcam, seed=7, use_megakernel=False,
                                  device=dev)
    parity_ratio = float(img_mk.mean() / img_t.mean())

    # ---- forward+backward (HEADLINE), linear loss
    warm = timed_grad(scene, camera, _mean_loss, 0, spp, max_depth, True)
    calls = [timed_grad(scene, camera, _mean_loss, i + 1, spp, max_depth,
                        True) for i in range(repeats)]
    grad_rays = sum(c[1] for c in calls)
    grad_secs = sum(c[2] for c in calls)
    fwdbwd_rays_per_sec = grad_rays / grad_secs

    # ---- forward+backward, the nonlinear (L2) loss: its pass 1 renders
    # the frame with B1; the headline's warm-up has paid first-use costs
    l2_fn = grad_mod.l2_to_target(torch.as_tensor(
        img.reshape(-1, 3), dtype=torch.float32, device=dev))
    l2_calls = [timed_grad(scene, camera, l2_fn, i + 1, spp, max_depth,
                           False) for i in range(repeats)]
    fwdbwd_l2_rays_per_sec = (sum(c[1] for c in l2_calls)
                              / sum(c[2] for c in l2_calls))

    path = renderer.auto_path(scene)
    return {
        "metric": METRIC,
        "value": round(fwdbwd_rays_per_sec),
        "unit": "rays/s",
        "vs_baseline": round(fwdbwd_rays_per_sec
                             / REFERENCE_CPU_RAYS_PER_SEC, 4),
        "aux": {
            "fwdbwd_workload": f"{width}x{settings.image_height}@{spp}spp "
                               f"d{max_depth} full frame, all scene params",
            "fwdbwd_l2_rays_per_sec": round(fwdbwd_l2_rays_per_sec),
            "forward_rays_per_sec": round(stats.rays_per_sec),
            "forward_vs_baseline": round(
                stats.rays_per_sec / REFERENCE_CPU_RAYS_PER_SEC, 4),
            "forward_seconds": round(stats.seconds, 3),
            "forward_path": path,
            "parity_ratio_megakernel_vs_xla": parity_ratio,
            "avg_bounces": round(stats.rays / n_samples, 3),
            "device": device_name(dev),
            # beside the reference's keys
            "nvidia_smi": card_line(dev),
            "fwdbwd_seeds": [i + 1 for i in range(repeats)],
            "fwdbwd_seconds": [c[2] for c in calls],
            "fwdbwd_rays": [c[1] for c in calls],
            "fwdbwd_loss": [c[0] for c in calls],
            "fwdbwd_launches": [c[3] for c in calls],
            "fwdbwd_first_call_seconds": warm[2],
            "fwdbwd_l2_seconds": [c[2] for c in l2_calls],
            "fwdbwd_l2_launches": [c[3] for c in l2_calls],
            "forward_rays": stats.rays,
            "parity_workload": f"{parity_width}x{pcam.image_height}"
                               f"@{parity_spp}spp d{max_depth} seed 7",
            "parity_seconds": {"megakernel": st_mk.seconds,
                               "tensor_wavefront": st_t.seconds},
            "parity_rays": {"megakernel": st_mk.rays,
                            "tensor_wavefront": st_t.rays},
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)  # --help; the reference's constants, no options
    print(json.dumps(run()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
