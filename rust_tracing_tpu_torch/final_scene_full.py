"""final_scene at the full reference workload (800x800 @ 8192 spp, depth
40, main.rs:624-636) as resumable sample slices, the counterpart of the
repository's ``scripts/final_scene_full.py``.

A single render is tens of minutes of card time that one kill throws away.
This module renders ``--slice-spp`` samples at a time through ``render()``
with ``sample_offset`` (samples are addressed globally, so the slices are
the samples of one render), keeps the float64 running mean, and after every
slice writes, each by a write to a temporary file and a rename:

  - ``final_scene_full_state.npz``: running mean, slices done, rays,
    seconds, workload and slice size (one file: always consistent);
  - ``final_scene_full_progress.json`` and ``final_scene.png``.

Running it again resumes from the recorded slice count; ``--fresh``
restarts. On completion the row is merged into the workload table of
``run_workloads`` (``workloads.json`` in the same directory,
``artifacts/torch/`` by default).

Usage (on the GPU; ``run(..., device="cpu")`` runs the kernels' plain
versions):
    python -m rust_tracing_tpu_torch.final_scene_full [--slice-spp 128]
        [--spp 8192] [--max-depth 40] [--fresh]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np

from . import renderer
from .bench import device_name
from .camera import Camera
from .config import resolve_device
from .models import builders
from .models.compile import compile_scene
from .run_workloads import OUT_DIR, TABLE_NAME
from .utils.image_io import write_png

STATE_NAME = "final_scene_full_state.npz"
PROGRESS_NAME = "final_scene_full_progress.json"
PNG_NAME = "final_scene.png"


def _atomic_write(path: str, write_fn) -> None:
    """``write_fn(file)`` into a temporary file, then rename it over
    ``path``: a kill leaves the previous consistent file on disk."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        write_fn(f)
    os.replace(tmp, path)


def _load_state(path: str, workload: str, slice_spp: int):
    """(slices done, rays, seconds, running mean) of a saved state of the
    same workload and slice size, or None."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as st:
        if (str(st["workload"]) != workload
                or int(st["slice_spp"]) != slice_spp):
            return None
        return (int(st["slices_done"]), int(st["rays"]), float(st["seconds"]),
                st["accum"].copy())


def run(spp: int = 8192, slice_spp: int = 128, max_depth: int = 40,
        fresh: bool = False, out_dir: str = OUT_DIR, device=None,
        stop_after: Optional[int] = None,
        image_width: Optional[int] = None) -> dict:
    """Render final_scene in slices into ``out_dir``, resuming a saved state
    of the same workload unless ``fresh``. ``stop_after`` returns after that
    many slices of this call (a kill between slices); ``image_width``
    overrides the frame's width (a small frame for a test). Returns the
    progress record (``complete`` once every slice is in) with the image
    (``accum``, float64 (H, W, 3))."""
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    state_path = os.path.join(out_dir, STATE_NAME)
    b, settings = builders.build_scene(8)
    over = dict(samples_per_pixel=spp, max_depth=max_depth)
    if image_width is not None:
        over["image_width"] = image_width
    settings = dataclasses.replace(settings, **over)
    scene = compile_scene(b, device=dev)
    camera = Camera.create(settings)
    w, h = camera.image_width, camera.image_height
    n_slices = (spp + slice_spp - 1) // slice_spp
    workload = f"{w}x{h}@{spp}spp d{max_depth}"

    done, rays, seconds = 0, 0, 0.0
    accum = np.zeros((h, w, 3), np.float64)
    saved = None if fresh else _load_state(state_path, workload, slice_spp)
    if saved is not None:
        done, rays, seconds, accum = saved
        print(f"resuming at slice {done}/{n_slices} "
              f"({seconds:.0f}s, {rays / 1e9:.2f}G rays so far)", flush=True)

    path = renderer.auto_path(scene)

    def status():
        return {"workload": workload, "slice_spp": slice_spp,
                "slices_done": done, "n_slices": n_slices, "rays": rays,
                "seconds": seconds, "path": path, "device": device_name(dev),
                "complete": done == n_slices}

    end = n_slices if stop_after is None else min(n_slices, done + stop_after)
    for s in range(done, end):
        k = min(slice_spp, spp - s * slice_spp)
        t0 = time.perf_counter()
        # render() returns a host image, so the clock stops after the device
        img, stats = renderer.render(scene, camera, seed=0, spp=k,
                                     max_depth=max_depth,
                                     sample_offset=s * slice_spp, device=dev)
        dt = time.perf_counter() - t0
        # incremental mean over the global sample index (renderer.rs:114)
        n0 = s * slice_spp
        accum += (img - accum) * (k / (n0 + k))
        rays += int(stats.rays)
        seconds += dt
        done = s + 1
        _atomic_write(state_path, lambda f: np.savez(
            f, accum=accum, slices_done=done, rays=rays, seconds=seconds,
            workload=workload, slice_spp=slice_spp))
        write_png(os.path.join(out_dir, PNG_NAME), accum)
        progress = dict(status(), traced_mrays_per_sec=rays / seconds / 1e6)
        _atomic_write(os.path.join(out_dir, PROGRESS_NAME),
                      lambda f: f.write(json.dumps(progress, indent=1)
                                        .encode()))
        print(f"slice {done}/{n_slices}: {dt:.1f}s "
              f"{stats.rays / dt / 1e6:.2f} Mrays/s "
              f"(cum {rays / seconds / 1e6:.2f} Mrays/s, "
              f"eta {(n_slices - done) * seconds / done / 60:.0f} min)",
              flush=True)

    result = dict(status(), accum=accum)
    if done == n_slices:
        _merge_row(os.path.join(out_dir, TABLE_NAME), result)
    return result


def _merge_row(table_path: str, res: dict) -> None:
    """Put final_scene's row (scene 8) into the workload table."""
    table = {"rows": []}
    if os.path.exists(table_path):
        with open(table_path) as f:
            table = json.load(f)
    table["rows"] = [r for r in table.get("rows", []) if r.get("scene") != 8]
    table["rows"].append({
        "scene": 8, "name": "final_scene", "workload": res["workload"],
        "path": res["path"], "device": res["device"],
        "seconds": res["seconds"],
        "traced_mrays_per_sec": res["rays"] / res["seconds"] / 1e6,
        "rays": res["rays"], "compile_excluded": False,
        "note": f"rendered as {res['n_slices']} resumable "
                f"{res['slice_spp']}-spp slices (global sample addressing; "
                "float64 running mean)"})
    with open(table_path, "w") as f:
        json.dump(table, f, indent=1)
    print(f"merged the final_scene row into {table_path}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spp", type=int, default=8192)
    ap.add_argument("--slice-spp", type=int, default=128)
    ap.add_argument("--max-depth", type=int, default=40)
    ap.add_argument("--fresh", action="store_true",
                    help="ignore existing progress and restart")
    args = ap.parse_args(argv)
    res = run(args.spp, args.slice_spp, args.max_depth, args.fresh)
    print(f"DONE: {res['seconds']:.0f}s total, "
          f"{res['rays'] / res['seconds'] / 1e6:.2f} Mrays/s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
