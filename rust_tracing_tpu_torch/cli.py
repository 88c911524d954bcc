"""Command-line interface.

Mirrors the reference CLI surface (src/main.rs:40-54) for the offline render:
``--scene`` (0-8) and ``--output``, plus spp/size/depth overrides, seeds,
metrics and the device. The render runs on the GPU unless ``--device cpu`` is
given.

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
    return p


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
