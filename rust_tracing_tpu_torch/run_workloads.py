"""The nine reference workloads through the port's ``render()``, the
counterpart of the repository's ``scripts/run_workloads.py``.

Every workload (scene x spp x depth as pinned in reference main.rs, at each
scene's own resolution) goes through ``render()``, which picks the path
by the port's policy: the fused render (B1), deferred shading (B2 and the
replay) for noise and image scenes, or the sorted wavefront (B3/B4 and the
replay) for final_scene. Each row names that path and the card. The table
is written after every row (a partial run keeps its rows), with one PNG a
scene, under ``artifacts/torch/`` (not tracked) by default.

Usage (on the GPU; ``run(..., device="cpu")`` runs the kernels' plain
versions):
    python -m rust_tracing_tpu_torch.run_workloads                 # all nine
    python -m rust_tracing_tpu_torch.run_workloads --scenes 6 7    # subset
    python -m rust_tracing_tpu_torch.run_workloads --scale-spp 0.5
    python -m rust_tracing_tpu_torch.run_workloads --scene8-spp 64
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Iterable, Optional

import numpy as np

from . import renderer
from .bench import card_line, device_name
from .camera import Camera
from .config import resolve_device
from .models import builders
from .models.compile import compile_scene
from .runtime import kernels
from .utils.color import linear_to_gamma
from .utils.image_io import write_png

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(_REPO, "artifacts", "torch")
TABLE_NAME = "workloads.json"

# (scene idx) -> (name, spp, max_depth) straight from reference main.rs;
# resolution comes from each scene's RenderSettings (models/builders.py).
WORKLOADS = {
    0: ("random_balls", 128, 8),
    1: ("two_spheres", 128, 8),
    2: ("earth", 128, 8),
    3: ("two_perlin_spheres", 128, 8),
    4: ("quads", 128, 8),
    5: ("simple_light", 1024, 8),
    6: ("cornell_box", 4096, 8),
    7: ("cornell_smoke", 4096, 8),
    8: ("final_scene", 8192, 40),
}


def gamma_mean(img: np.ndarray) -> float:
    """Mean of the gamma-encoded image, clamped as the PNG encodes it: the
    statistic the reference screenshots are held to."""
    return float(np.clip(linear_to_gamma(np.clip(img, 0, None)), 0,
                         0.999).mean())


def run(scenes: Iterable[int] = tuple(range(9)), scale_spp: float = 1.0,
        scene8_spp: Optional[int] = None, out: Optional[str] = None,
        out_dir: str = OUT_DIR, device=None) -> dict:
    """Render each workload of ``scenes`` -> the table (also written to
    ``out``, default ``out_dir/workloads.json``, after every row, and one
    PNG a scene into ``out_dir``). Each row is timed after a warm-up render
    of the same workload, except final_scene at its full spp (hours: its
    one warm-up would double it; its chunks amortize first-use costs)."""
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    out_path = out or os.path.join(out_dir, TABLE_NAME)
    results = {"device": device_name(dev), "nvidia_smi": card_line(dev),
               "scale_spp": scale_spp, "rows": []}
    for idx in scenes:
        name, spp, depth = WORKLOADS[idx]
        spp = max(1, int(spp * scale_spp))
        spp_note = None
        if idx == 8 and scene8_spp:
            spp_note = f"sustained-rate row at {scene8_spp}spp of 8192"
            spp = scene8_spp
        b, settings = builders.build_scene(idx)
        settings = dataclasses.replace(settings, samples_per_pixel=spp,
                                       max_depth=depth)
        scene = compile_scene(b, device=dev)
        camera = Camera.create(settings)
        w, h = camera.image_width, camera.image_height
        path = renderer.auto_path(scene)
        print(f"[{idx}] {name} {w}x{h}@{spp}spp d{depth} ({path}) ...",
              flush=True)
        warmed = idx != 8 or scene8_spp is not None
        if warmed:
            renderer.render(scene, camera, seed=0, spp=spp, max_depth=depth,
                            device=dev)
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        # render() returns a host image, so the clock stops after the device
        img, stats = renderer.render(scene, camera, seed=0, spp=spp,
                                     max_depth=depth, device=dev)
        dt = time.perf_counter() - t0
        launches = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                    if v != before[k]}
        row = {"scene": idx, "name": name,
               "workload": f"{w}x{h}@{spp}spp d{depth}", "path": path,
               "device": results["device"], "seconds": dt,
               "traced_mrays_per_sec": stats.rays / dt / 1e6,
               "rays": int(stats.rays), "compile_excluded": warmed,
               "gamma_mean": gamma_mean(img), "finite":
               bool(np.isfinite(img).all()), "launches": launches}
        if spp_note:
            row["note"] = spp_note
        results["rows"].append(row)
        print(f"    {dt:.2f}s  {row['traced_mrays_per_sec']:.1f} Mrays/s  "
              f"gamma mean {row['gamma_mean']:.4f}", flush=True)
        write_png(os.path.join(out_dir, f"{name}.png"), img)
        with open(out_path, "w") as f:  # write-as-you-go: partial runs count
            json.dump(results, f, indent=1)
    print(f"wrote {out_path}", flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenes", type=int, nargs="*", default=list(range(9)))
    ap.add_argument("--scale-spp", type=float, default=1.0)
    ap.add_argument("--scene8-spp", type=int, default=None,
                    help="spp override for final_scene only (the full 8192 "
                         "is a long run; a reduced-spp row measures the "
                         "same sustained rate and is marked as such)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run(args.scenes, args.scale_spp, args.scene8_spp, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
