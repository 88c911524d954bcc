#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
device and the CUDA toolkit (``nvcc``), builds the hand-written kernels from
``rust_tracing_tpu_torch/csrc/`` and drives the port's main path through the
entry points a user would call. Every phase prints one JSON line; any failure
exits non-zero. Without a CUDA device it exits non-zero and prints no result.

Phases:
  device     card name and power limit (nvidia-smi), torch and CUDA versions
  build      seconds to compile the kernel library at first use
  exact      closed-form cases through the kernel (background, emitter)
  kernels    the CUDA render kernel against its plain PyTorch version ON THE
             CARD, same inputs, on four scenes at a small frame and on
             cornell_box at the main path's 600x600 frame with spp cut
  main_path  render() of cornell_box at 600x600, 4096 spp, depth 8
  cli        the command-line entry point writes a PNG

Tolerance of `kernels` and its reason. The kernel is built without fused
multiply-add contraction and without fast math, and does the plain version's
f32 operations in the plain version's order; `sinf cosf logf expf rsqrtf`
come from the same device library PyTorch's CUDA ops call. So almost every
pixel is expected equal to a few ulp: a pixel counts as equal when
|kernel - plain| <= 1e-5 + 1e-5 * |plain| in all three channels. Where one
ulp in a transcendental flips a hit decision the path after it is a different
path and the pixel differs freely, so what is bounded is the SHARE of such
pixels (<= 0.5 %), the share of pixels whose ray count differs (<= 0.5 %) and
the ratio of the mean images (within 1e-3 of 1). On an H100 the share seen is
0; a build with multiply-add contraction left on shows 1.2 % on random_balls.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device available; the port's main path runs "
          "on the GPU only", file=sys.stderr)
    sys.exit(1)

import rust_tracing_tpu_torch as rt  # noqa: E402
from rust_tracing_tpu_torch import cli  # noqa: E402
from rust_tracing_tpu_torch.models import builders  # noqa: E402
from rust_tracing_tpu_torch.ops import megakernel as mk  # noqa: E402
from rust_tracing_tpu_torch.runtime import kernels  # noqa: E402
from rust_tracing_tpu_torch.utils.image_io import write_png  # noqa: E402

DEVICE = "cuda"

# Published peaks of one H100 SXM (NVIDIA data sheet): float32 outside the
# tensor cores, and device memory bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Operation count of the render, from this run's data: each traced ray tests
# every sphere and quad (~25 flop a test, the reference's own estimate) and is
# shaded once (normal flip, material, scatter sampling, origin offset: ~120
# flop); each sample generates one camera ray (~60 flop).
FLOP_PER_PRIM_TEST = 25
FLOP_PER_BOUNCE_SHADE = 120
FLOP_PER_CAMERA_RAY = 60

PIX_ATOL, PIX_RTOL = 1e-5, 1e-5
MAX_DIVERGED_SHARE = 0.005
MAX_MEAN_RATIO_ERR = 1e-3

MAIN_SPP_TIME_BUDGET_S = 120.0
# where to keep the main path's PNG for a look; unset = not kept
OUT_DIR = os.environ.get("RT_SMOKE_OUT")


def say(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, reps):
    """Mean milliseconds of ``fn`` over ``reps`` runs, by CUDA events, after
    one warm-up run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(tables, p, n_rays):
    """Least time the card could take for this render: the larger of bytes
    moved (each table read once, 16 bytes written a pixel) over the memory
    rate and operations over the float32 rate."""
    n_bytes = sum(t.numel() * t.element_size() for t in tables.values())
    n_bytes += p.pixel_count * 16
    flop = (n_rays * ((p.n_spheres + p.n_quads) * FLOP_PER_PRIM_TEST
                      + FLOP_PER_BOUNCE_SHADE)
            + p.pixel_count * p.spp * FLOP_PER_CAMERA_RAY)
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_flop = flop / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_flop), ("bytes" if t_bytes > t_flop else "operations")


def scene_inputs(name, width, spp, depth, seed=0):
    b, settings = getattr(builders, name)()
    settings = dataclasses.replace(settings, image_width=width,
                                   samples_per_pixel=spp, max_depth=depth)
    scene = rt.compile_scene(b, device=DEVICE)
    camera = rt.Camera.create(settings)
    packed, tables = mk._packed_dev(scene)
    p = mk.make_params(camera, packed, seed, spp, depth)
    return scene, camera, tables, p


def compare(name, width, spp, depth, reps_kernel=3):
    """Kernel vs plain version on the card, same inputs."""
    scene, camera, tables, p = scene_inputs(name, width, spp, depth, seed=11)
    rgb_k, n_k = mk.render_kernel(tables, p)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rgb_p, n_p = mk.render_fast_plain(tables, p)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    kernel_ms = time_ms(lambda: mk.render_kernel(tables, p), reps_kernel)

    if not (torch.isfinite(rgb_k).all() and torch.isfinite(rgb_p).all()):
        fail(f"{name}: non-finite radiance")
    diff = (rgb_k - rgb_p).abs()
    beyond = (diff > PIX_ATOL + PIX_RTOL * rgb_p.abs()).any(dim=-1)
    n_rays = int(n_k.sum(dtype=torch.int64).item())
    b_ms, b_by = bound_ms(tables, p, n_rays)
    res = dict(
        scene=name, width=camera.image_width, height=camera.image_height,
        spp=spp, depth=depth, spheres=p.n_spheres, quads=p.n_quads,
        media=p.n_media, rays=n_rays,
        rays_plain=int(n_p.sum(dtype=torch.int64).item()),
        pixels_ray_count_differs=int((n_k != n_p).sum().item()),
        pixels_bitwise_equal=int((rgb_k == rgb_p).all(dim=-1).sum().item()),
        pixels=p.pixel_count,
        max_abs_err=float(diff.max().item()),
        mean_abs_err=float(diff.mean().item()),
        share_beyond_tol=float(beyond.float().mean().item()),
        mean_ratio=float((rgb_k.mean() / rgb_p.mean()).item()),
        kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    say("kernels", **res)
    if res["share_beyond_tol"] > MAX_DIVERGED_SHARE:
        fail(f"{name}: {res['share_beyond_tol']:.4f} of pixels beyond "
             f"tolerance (limit {MAX_DIVERGED_SHARE})")
    if res["pixels_ray_count_differs"] > MAX_DIVERGED_SHARE * p.pixel_count:
        fail(f"{name}: ray counts differ in "
             f"{res['pixels_ray_count_differs']} pixels")
    if abs(res["mean_ratio"] - 1.0) > MAX_MEAN_RATIO_ERR:
        fail(f"{name}: mean-image ratio {res['mean_ratio']}")
    return res


def phase_exact():
    # background-only scene equals the background
    b = rt.SceneBuilder(background=(0.2, 0.4, 0.8))
    scene = rt.compile_scene(b, device=DEVICE)
    cam = rt.Camera.create(rt.RenderSettings(
        image_width=32, aspect_ratio=2.0, samples_per_pixel=2, max_depth=3,
        background=(0.2, 0.4, 0.8)))
    img = mk.render_fast(scene, cam)
    np.testing.assert_allclose(
        img, np.broadcast_to([0.2, 0.4, 0.8], img.shape), rtol=1e-6)
    # an emitter quad in front of the camera: its colour at the centre pixel,
    # black at the corner
    b = rt.SceneBuilder(background=(0, 0, 0))
    b.add_quad((-1, -1, 2), (2, 0, 0), (0, 2, 0), b.diffuse_light((3, 2, 1)))
    scene = rt.compile_scene(b, device=DEVICE)
    cam = rt.Camera.create(rt.RenderSettings(
        image_width=32, aspect_ratio=1.0, samples_per_pixel=2, max_depth=2,
        vfov=60.0, look_from=(0, 0, 0), look_at=(0, 0, 2)))
    img = mk.render_fast(scene, cam)
    np.testing.assert_allclose(img[16, 16], [3, 2, 1], rtol=1e-6)
    np.testing.assert_allclose(img[0, 0], 0, atol=1e-7)
    say("exact", background="ok", emitter="ok")


def gamma_mean(img):
    g = np.clip(np.clip(img, 0, None) ** (1 / 2.2), 0, 0.999)
    return float(g.mean())


def main():
    t_start = time.perf_counter()
    card = gpu_line()
    say("device", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0))

    kernels.load()
    regs = [ln.strip() for ln in kernels.build_log.splitlines()
            if "registers" in ln or "spill" in ln]
    say("build", seconds=kernels.build_seconds, sources=list(kernels.SOURCES),
        ptxas=regs[-4:])

    phase_exact()

    # the kernel against its plain version, four scene families, small frame
    compare("cornell_box", 64, 16, 8)
    compare("cornell_smoke", 64, 16, 8)
    compare("two_spheres", 64, 16, 8)
    compare("random_balls", 64, 8, 8)
    # and at the shapes the main path gives it (600x600 frame, depth 8, the
    # same tables), with spp cut so the plain version ends in seconds
    at_main = compare("cornell_box", 600, 16, 8)

    # ---- main path: render() through the package's normal entry point
    b, settings = builders.cornell_box()
    est_s = at_main["kernel_ms"] / 1e3 / at_main["spp"] \
        * settings.samples_per_pixel
    spp = settings.samples_per_pixel
    while est_s * spp / settings.samples_per_pixel > MAIN_SPP_TIME_BUDGET_S \
            and spp > 512:
        spp //= 2  # cut spp, never the 600x600 frame or the depth
    settings = dataclasses.replace(settings, samples_per_pixel=spp)
    scene = rt.compile_scene(b, device=DEVICE)
    camera = rt.Camera.create(settings)
    for k in mk.LAUNCHES:
        mk.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    img, stats = rt.render(scene, camera)
    torch.cuda.synchronize()
    launches = dict(mk.LAUNCHES)
    if launches["render_kernel"] < 1:
        fail("main path did not launch render_kernel")
    if img.shape != (600, 600, 3) or not np.isfinite(img).all():
        fail(f"main path image {img.shape} not finite 600x600x3")
    gmean = gamma_mean(img)
    packed, tables = mk._packed_dev(scene)
    p_main = mk.make_params(camera, packed, 0, spp, camera.max_depth)
    main_bound, main_by = bound_ms(tables, p_main, stats.rays)
    say("main_path", scene="cornell_box", width=600, height=600, spp=spp,
        spp_of_scene=builders.cornell_box()[1].samples_per_pixel,
        depth=camera.max_depth, seconds=stats.seconds, rays=stats.rays,
        mrays_per_s=stats.rays_per_sec / 1e6, gamma_mean=gmean,
        launches=launches, bound_ms=main_bound, bound_by=main_by,
        roofline_share=main_bound / (stats.seconds * 1e3))
    if not 0.24 <= gmean <= 0.27:
        fail(f"cornell gamma mean {gmean} outside 0.24-0.27")
    if OUT_DIR:
        os.makedirs(OUT_DIR, exist_ok=True)
        write_png(os.path.join(OUT_DIR, "cornell_main.png"), img)

    # ---- CLI
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cli_cornell")
        rc = cli.main(["-s", "6", "--width", "200", "--spp", "64", "-o", out])
        if rc != 0 or not os.path.exists(out + ".png"):
            fail(f"cli returned {rc} or wrote no PNG")
        say("cli", rc=rc, png_bytes=os.path.getsize(out + ".png"))

    say("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [{
        "name": "render_kernel", "route": "cuda",
        "source": "rust_tracing_tpu_torch/csrc/render_kernel.cu",
        "replaces": "rust_tracing_tpu/ops/megakernel.py:1262",
        "launches": launches["render_kernel"],
        "max_abs_err": at_main["max_abs_err"],
        "ms": at_main["kernel_ms"], "plain_ms": at_main["plain_ms"],
        "bound_ms": at_main["bound_ms"], "bound_by": at_main["bound_by"],
        "library_ms": None,
        "shape": "cornell_box 600x600 depth 8 spp 16 (main-path frame and "
                 "tables, spp cut for the plain version)",
        "main_path_ms": stats.seconds * 1e3, "main_path_spp": spp,
        "main_path_bound_ms": main_bound,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
