"""Command-line interface.

Mirrors the reference CLI surface (src/main.rs:40-54): ``--live``,
``--scene`` (0-8) and ``--output``, plus spp/size/depth overrides, seeds,
metrics, the device, checkpoint/resume of the live mode, the occupancy
report, a profiler trace, the distributed render (``--distributed``,
``--multihost``, ``--sample-parallelism``) and the gradient self-check
``--grad-check``. The render runs on the GPU unless ``--device cpu`` is
given.

Run: ``python -m rust_tracing_tpu_torch -s 6 -o cornell``; over the GPUs of
a host: ``torchrun --standalone --nproc-per-node N -m rust_tracing_tpu_torch
--distributed -s 6`` (rank 0 writes the PNG).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rust_tracing_tpu_torch",
        description="PyTorch/CUDA path tracer (capabilities of rust-tracing)")
    p.add_argument("-l", "--live", action="store_true",
                   help="progressive rendering mode: accumulate 1-sample "
                        "passes, write preview PNGs as they refine")
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
    p.add_argument("--distributed", action="store_true",
                   help="shard pixels/samples over the ranks that torchrun "
                        "started (without torchrun: a 1x1 mesh)")
    p.add_argument("--multihost", action="store_true",
                   help="require torchrun's environment for the rendezvous "
                        "and fail fast without it; implies --distributed")
    p.add_argument("--sample-parallelism", type=int, default=1,
                   help="ranks cooperating on the spp axis")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="write a torch.profiler trace of the render into "
                        "DIR")
    p.add_argument("--report-occupancy", action="store_true",
                   help="print per-bounce live-ray fractions (wavefront "
                        "divergence telemetry) before rendering")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="progressive checkpoint file (.npz) to save/resume")
    p.add_argument("--checkpoint-every", type=int, default=32,
                   help="samples between checkpoint writes in --live mode")
    p.add_argument("--preview-every", type=int, default=8,
                   help="samples between preview PNG writes in --live mode")
    p.add_argument("--dtype", choices=("float32", "float64"),
                   default="float32")
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


def _live(scene, camera, args, device, dtype, out_png, rank) -> int:
    """Progressive render, 1 sample a pass, with preview PNGs and
    checkpoints; resumes from ``--checkpoint`` when the file exists."""
    from .renderer import progressive_init, progressive_step
    from .utils import checkpoint as ckpt
    from .utils.image_io import write_png
    from .utils.viewer import TerminalViewer

    state = None
    if args.checkpoint and os.path.exists(args.checkpoint):
        # a present but unreadable checkpoint is an error, not a silent
        # restart that would throw away paid-for samples
        state = ckpt.load(args.checkpoint)
        if state.accum.shape[:2] != (camera.image_height, camera.image_width):
            raise SystemExit(
                f"checkpoint {args.checkpoint} is {state.accum.shape[1]}x"
                f"{state.accum.shape[0]} but the render is "
                f"{camera.image_width}x{camera.image_height}")
        print(f"Resumed {args.checkpoint} at {state.num_samples} spp")
    if state is None:
        state = progressive_init(camera, seed=args.seed)
    writer = rank == 0
    viewer = TerminalViewer() if writer else TerminalViewer(force=False)
    t0 = time.perf_counter()
    while state.num_samples < camera.samples_per_pixel:
        state = progressive_step(scene, camera, state, samples=1,
                                 dtype=dtype, device=device)
        n = state.num_samples
        status = (f"spp {n}/{camera.samples_per_pixel} "
                  f"({time.perf_counter() - t0:.1f}s)")
        viewer.show(state.accum, status)
        if not viewer.enabled:
            print(f"\r{status}", end="", file=sys.stderr)
        if not writer:
            continue
        if n % args.preview_every == 0 or n == camera.samples_per_pixel:
            write_png(out_png, state.accum)
        if args.checkpoint and n % args.checkpoint_every == 0:
            ckpt.save(args.checkpoint, state)
    print(file=sys.stderr)
    if writer:
        if args.checkpoint:
            ckpt.save(args.checkpoint, state)
        write_png(out_png, state.accum)
        print(f"Wrote {out_png} at {state.num_samples} spp")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    print(f"Args: {args}")

    import torch
    import torch.distributed as dist

    from .config import resolve_device
    from .parallel import mesh as mesh_mod

    if args.metrics:
        from .utils import metrics as metrics_mod

        metrics_mod.enable(None if args.metrics == "1" else args.metrics)

    if args.multihost:
        # fail fast: without torchrun's rendezvous variables there is
        # nothing to join, and a guessed one would hang
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing:
            raise SystemExit(f"--multihost needs torchrun's environment; "
                             f"{', '.join(missing)} not set")
        args.distributed = True
    if args.distributed and "WORLD_SIZE" in os.environ:
        device = mesh_mod.init_distributed(device=args.device)
        print(f"distributed: rank {dist.get_rank()}/"
              f"{dist.get_world_size()} on {device}")
    else:
        device = resolve_device(args.device)
    try:
        return _main(args, device, torch.float32 if args.dtype == "float32"
                     else torch.float64)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _main(args, device, dtype) -> int:
    import torch.distributed as dist

    from . import Camera, compile_scene, render
    from .models import builders
    from .utils.image_io import write_png
    from .utils.progress import ProgressBar

    rank = dist.get_rank() if dist.is_initialized() else 0
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
    scene = compile_scene(b, dtype=dtype, device=device)
    camera = Camera.create(settings)
    print(f"Scene compile: {time.perf_counter() - t0:.2f}s "
          f"({b.num_spheres} spheres, {b.num_quads} quads, {b.num_media} media; "
          f"{camera.image_width}x{camera.image_height} @ "
          f"{camera.samples_per_pixel}spp depth {camera.max_depth}) on {device}")

    if args.grad_check and not grad_check(scene, camera, args.seed):
        return 1

    if args.report_occupancy:
        from .renderer import measure_occupancy

        occ = measure_occupancy(scene, camera, seed=args.seed)
        frac = " ".join(f"{x:.3f}" for x in occ)
        print(f"occupancy per bounce: {frac} (mean {occ.mean():.3f})")

    out_png = f"{args.output}.png"
    if args.live:
        return _live(scene, camera, args, device, dtype, out_png, rank)

    prof = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
    with prof if prof is not None else contextlib.nullcontext():
        if args.distributed:
            from .parallel.mesh import make_mesh
            from .parallel.render_dist import render_distributed

            mesh = make_mesh(args.sample_parallelism, device=device)
            print(f"Mesh: {mesh.shape} over {mesh.size} rank(s)")
            t0 = time.perf_counter()
            image = render_distributed(scene, camera, mesh, seed=args.seed,
                                       dtype=dtype)
            print(f"Render time: {time.perf_counter() - t0:.2f}s")
        else:
            bar = ProgressBar(camera.image_width * camera.image_height)
            image, stats = render(scene, camera, seed=args.seed, dtype=dtype,
                                  progress=bar, device=device)
            print(f"Render time: {stats.seconds:.2f}s "
                  f"({stats.rays_per_sec / 1e6:.2f} Mrays/s)")
    if prof is not None:
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, f"trace_rank{rank}.json")
        prof.export_chrome_trace(trace)
        print(f"Profiler trace written to {trace}")

    if rank == 0:
        t0 = time.perf_counter()
        write_png(out_png, image)
        print(f"PNG encoding: {time.perf_counter() - t0:.2f}s -> {out_png}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
