"""Command-line interface.

Mirrors the reference CLI surface (src/main.rs:40-54) for the offline render:
``--scene`` (0-8) and ``--output``, plus spp/size/depth overrides, seeds,
metrics, the device and the gradient self-check ``--grad-check``. The render
runs on the GPU unless ``--device cpu`` is given.

Run: ``python -m rust_tracing_tpu_torch -s 6 -o cornell``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rust_tracing_tpu_torch",
        description="PyTorch/CUDA path tracer (capabilities of rust-tracing)")
    p.add_argument("-s", "--scene", type=int, default=0,
                   help="scene index (0:random balls, 1:two spheres, 2:earth, "
                        "3:perlin spheres, 4:quads, 5:simple light, "
                        "6:cornell box, 7:cornell smoke, 8:final scene)")
    p.add_argument("-o", "--output", type=str, default="output",
                   help="output file name (without .png)")
    p.add_argument("--spp", type=int, default=None, help="override samples/pixel")
    p.add_argument("--width", type=int, default=None, help="override image width")
    p.add_argument("--max-depth", type=int, default=None, help="override bounce depth")
    p.add_argument("--seed", type=int, default=0, help="RNG seed")
    p.add_argument("--scene-seed", type=int, default=0,
                   help="seed for randomized scene content (scenes 0 and 8)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default is the GPU, 'cpu' runs the "
                        "plain PyTorch path")
    p.add_argument("--metrics", type=str, nargs="?", const="1", default=None,
                   metavar="FILE",
                   help="emit one JSON metrics line per render: to stderr, "
                        "or appended to FILE")
    p.add_argument("--grad-check", action="store_true",
                   help="before rendering, validate the differentiable "
                        "pipeline on this scene: autodiff gradient vs "
                        "central finite differences of the same fixed-RNG "
                        "estimator, printed and exit-status-gated")
    return p


def grad_check(scene, camera, seed: int) -> bool:
    """Autodiff vs central finite differences of the same fixed-RNG direct
    estimator (spp 8, depth <= 4, ~2048 pixels). The RNG is addressed by
    counters, so the estimator is deterministic in the parameters and finite
    differences are exact up to float arithmetic and curvature. Probes the
    strongest coordinates of the smooth parameter families; a family whose
    gradient is zero on this scene falls through to the next. Prints one
    line per coordinate and a verdict; returns False on FAIL."""
    import numpy as np
    import torch

    from . import grad as grad_mod

    dev = scene.device
    n_pix = camera.image_width * camera.image_height
    stride = max(1, n_pix // 2048)
    pixel_ids = torch.arange(0, n_pix, stride, dtype=torch.int32, device=dev)
    spp_c, depth_c = 8, min(4, camera.max_depth)
    dtype = scene.background.dtype
    cam = camera.constants(dtype, device=dev)

    def loss_fn(im, pid):
        return torch.mean(im)

    def loss_at(s):
        with torch.no_grad():
            img, _ = grad_mod.radiance_mean_rays(s, cam, pixel_ids, seed,
                                                 spp_c, depth_c)
        return float(loss_fn(img, pixel_ids))

    _, g = grad_mod.loss_and_grad(scene, camera, loss_fn, seed=seed,
                                  spp=spp_c, max_depth=depth_c,
                                  pixel_ids=pixel_ids, dtype=dtype,
                                  use_recorder=False)
    ok, checked, eps = True, 0, 1e-2
    for field in ("tex_rgb", "mat_albedo", "tex_noise_scale",
                  "med_neg_inv_density"):
        g_f = getattr(g, field).detach().cpu().numpy().astype(np.float64)
        base = getattr(scene, field)
        arr = base.detach().cpu().numpy().astype(np.float64)
        for lin in np.argsort(np.abs(g_f).ravel())[::-1][:3]:
            if abs(g_f.ravel()[lin]) < 1e-7:
                continue
            delta = eps * (np.arange(arr.size).reshape(arr.shape) == lin)

            def moved(sign):
                t = torch.from_numpy(arr + sign * delta).to(base.dtype)
                return scene.replace(**{field: t.to(dev)})

            fd = (loss_at(moved(1.0)) - loss_at(moved(-1.0))) / (2 * eps)
            ad = g_f.ravel()[lin]
            rel = abs(fd - ad) / max(abs(fd), 1e-12)
            idx = list(np.unravel_index(lin, arr.shape))
            print(f"grad-check {field}{[int(i) for i in idx]}: ad={ad:+.6e} "
                  f"fd={fd:+.6e} rel_err={rel:.3e}")
            ok &= rel < 5e-2 or abs(fd - ad) < 1e-6
            checked += 1
        if checked >= 3:
            break
    verdict = "OK" if ok and checked else (
        "SKIP (no smooth nonzero-gradient parameter at this config)" if ok
        else "FAIL")
    print(f"grad-check: {verdict} ({checked} coordinates)")
    return ok


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    print(f"Args: {args}")

    from . import Camera, compile_scene, render
    from .config import resolve_device
    from .models import builders
    from .utils.image_io import write_png
    from .utils.progress import ProgressBar

    if args.metrics:
        from .utils import metrics as metrics_mod

        metrics_mod.enable(None if args.metrics == "1" else args.metrics)

    device = resolve_device(args.device)

    t0 = time.perf_counter()
    b, settings = builders.build_scene(args.scene, seed=args.scene_seed)
    overrides = {}
    if args.width:
        overrides["image_width"] = args.width
    if args.spp:
        overrides["samples_per_pixel"] = args.spp
    if args.max_depth:
        overrides["max_depth"] = args.max_depth
    if overrides:
        settings = dataclasses.replace(settings, **overrides)
    scene = compile_scene(b, device=device)
    camera = Camera.create(settings)
    print(f"Scene compile: {time.perf_counter() - t0:.2f}s "
          f"({b.num_spheres} spheres, {b.num_quads} quads, {b.num_media} media; "
          f"{camera.image_width}x{camera.image_height} @ "
          f"{camera.samples_per_pixel}spp depth {camera.max_depth}) on {device}")

    if args.grad_check and not grad_check(scene, camera, args.seed):
        return 1

    out_png = f"{args.output}.png"
    bar = ProgressBar(camera.image_width * camera.image_height)
    image, stats = render(scene, camera, seed=args.seed, progress=bar,
                          device=device)
    print(f"Render time: {stats.seconds:.2f}s "
          f"({stats.rays_per_sec / 1e6:.2f} Mrays/s)")

    t0 = time.perf_counter()
    write_png(out_png, image)
    print(f"PNG encoding: {time.perf_counter() - t0:.2f}s -> {out_png}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
