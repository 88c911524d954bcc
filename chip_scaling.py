#!/usr/bin/env python3
"""Multi-GPU check of the PyTorch/CUDA port: one rank a card under NCCL.

Run from the repository root on a host with two or more NVIDIA GPUs:
``python3 chip_scaling.py``. It builds the kernels, then for 1, 2, 4, ...
ranks (up to the host's cards) starts one process a card
(``parallel.launch.run_ranks``, NCCL, rank r on cuda:r) and runs

  render  ``megakernel.render_fast_sharded`` (what ``render_distributed``
          calls) of cornell_box 600x600 @ 4096 spp, depth 8, on the Wx1
          mesh and, from 2 ranks on, on the (W/2)x2 mesh (the sample axis
          split);
  grad    ``grad_dist.replay_loss_and_grad`` of cornell_box 600x600 @ 200
          spp, depth 8 (the SSE to a fixed target) on the Wx1 mesh;

and holds every result against the one-rank run: the rays-only frame bit
for bit; the split sample axis within SPLIT_RTOL (below); the gradient's
loss to rtol 2e-5 and each float leaf to rtol 5e-4 / atol 2e-5 of its
largest |g| (chip_smoke.py's tolerances and reasons); ray counts equal.
Times are host-clock seconds from a point all ranks leave together (an
all-reduce) to the slowest rank's synchronised end, after one warm-up call
(the gradient's: the fastest of GRAD_REPS repetitions); beside the render,
each rank's kernel time alone over its range (CUDA events), which shows
how evenly the rows split the work. Prints one JSON line a run and the cards' names and power limits;
exits non-zero when a check fails, and without two CUDA devices.
"""

import subprocess
import time

import numpy as np
import torch

import chip_smoke as cs
from rust_tracing_tpu_torch.ops import megakernel as mk
from rust_tracing_tpu_torch.parallel import grad_dist
from rust_tracing_tpu_torch.parallel.launch import run_ranks
from rust_tracing_tpu_torch.parallel.mesh import make_mesh, shard_range

RENDER_SPP, GRAD_SPP, DEPTH = 4096, 200, 8
TIMEOUT_S = 600.0
GRAD_REPS = 3  # host-bound: the run's time is the fastest repetition
# The split sample axis adds the means of two halves where one rank sums all
# spp samples in sequence. Radiance is non-negative, and a sequential f32 sum
# of n such terms is within (n-1) * 2^-24 of their sum relative, so the two
# means differ by at most about 1.5 * spp * 2^-24 relative: 3.7e-4 at 4096
# spp (tests/test_parallel.py's rtol 3e-6 is for 8 spp).
SPLIT_RTOL = 2 * RENDER_SPP * 2.0 ** -24


def _timed(mesh, device, fn):
    """(result, seconds): fn() from a common start to the slowest rank's
    synchronised end."""
    flag = torch.zeros((1,), device=device)
    mesh.all_reduce(flag)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, _gather(mesh, device, time.perf_counter() - t0).max()


def _gather(mesh, device, x: float) -> np.ndarray:
    """Every rank's ``x``, by rank (a sum of one-hot rows)."""
    row = torch.zeros((mesh.size,), dtype=torch.float64, device=device)
    row[mesh.rank] = x
    return mesh.all_reduce(row).cpu().numpy()


def rank_run(device, sps, target):
    out = {}
    scene, camera = cs.cornell(600, RENDER_SPP, device)
    for sp in sps:
        mesh = make_mesh(sp, device=device)
        mk.render_fast_sharded(scene, camera, mesh, seed=3, spp=16 * sp)
        (img, rays), secs = _timed(mesh, device, lambda: mk.render_fast_sharded(
            scene, camera, mesh, with_stats=True))
        # this rank's kernel alone (no collective): the rows' imbalance
        base, count = shard_range(camera.image_width * camera.image_height,
                                  mesh)
        ms = cs.time_ms(lambda: mk.render_pixels(
            scene, camera, sample_offset=mesh.sample_idx * RENDER_SPP // sp,
            spp=RENDER_SPP // sp, pixel_base=base, pixel_count=count), 1)
        out["render", sp] = dict(img=img if mesh.rank == 0 else None,
                                 rays=rays, seconds=secs,
                                 rank_kernel_ms=_gather(mesh, device, ms))
    gscene, gcam = cs.cornell(600, GRAD_SPP, device)
    mesh = make_mesh(device=device)
    grad_dist.replay_loss_and_grad(gscene, gcam, mesh, target, seed=1,
                                   spp=2, max_depth=DEPTH)
    torch.cuda.reset_peak_memory_stats()
    reps = []
    for _ in range(GRAD_REPS):
        (loss, g, rays), secs = _timed(mesh, device, lambda: (
            grad_dist.replay_loss_and_grad(gscene, gcam, mesh, target,
                                           seed=1, spp=GRAD_SPP,
                                           max_depth=DEPTH)))
        reps.append(secs)
    out["grad"] = dict(loss=float(loss), leaves=cs.float_leaves(g),
                       rays=rays, seconds=min(reps), rep_seconds=reps,
                       peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return out


def main():
    n_dev = torch.cuda.device_count()
    if n_dev < 2:
        cs.fail(f"chip_scaling needs two or more CUDA devices, found {n_dev}")
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cs.say("device", nvidia_smi=cards.splitlines(), torch=torch.__version__,
           cuda=torch.version.cuda, count=n_dev)
    cs.kernels.load()
    scene, camera = cs.cornell(600, 16)
    target = mk.render_fast(scene, camera, seed=99)
    worlds = [w for w in (1, 2, 4, 8) if w <= n_dev]
    res = {}
    for w in worlds:
        sps = [1, 2] if w > 1 else [1]
        t0 = time.perf_counter()
        res[w] = run_ranks(rank_run, w, backend="nccl", timeout_s=TIMEOUT_S,
                           args=(sps, target))
        start_s = time.perf_counter() - t0
        one = res[1][0]
        for sp in sps:
            r = res[w][0]["render", sp]
            ref = one["render", 1]
            err = np.abs(r["img"].astype(np.float64) - ref["img"])
            rel = float((err / np.maximum(np.abs(ref["img"]), 1e-30)).max())
            if sp == 1:
                ok = bool(np.array_equal(r["img"], ref["img"]))
            else:
                ok = bool((err <= SPLIT_RTOL * np.abs(ref["img"])).all())
            ok = ok and r["rays"] == ref["rays"]
            cs.say("render", ranks=w, mesh=[w // sp, sp], spp=RENDER_SPP,
                   seconds=r["seconds"],
                   rank_kernel_ms=r["rank_kernel_ms"].tolist(),
                   speedup=ref["seconds"] / r["seconds"],
                   rays=r["rays"], max_abs_err=float(err.max()),
                   max_rel_err=rel, equal_to_one_rank=ok)
            if not ok:
                cs.fail(f"{w} ranks, sample axis {sp}: frame differs")
        d, d1 = res[w][0]["grad"], one["grad"]
        within = all(
            bool((np.abs(d["leaves"][f] - b) <= 5e-4 * np.abs(b)
                  + 2e-5 * np.abs(b).max()).all())
            for f, b in d1["leaves"].items())
        ok = (abs(d["loss"] - d1["loss"]) <= 2e-5 * abs(d1["loss"])
              and within and d["rays"] == d1["rays"])
        cs.say("grad", ranks=w, mesh=[w, 1], spp=GRAD_SPP,
               seconds=d["seconds"], rep_seconds=d["rep_seconds"],
               speedup=d1["seconds"] / d["seconds"],
               loss=d["loss"], rays=d["rays"],
               peak_mem_gb=[r["grad"]["peak_mem_gb"] for r in res[w]],
               equal_to_one_rank=ok, spawn_seconds=start_s)
        if not ok:
            cs.fail(f"{w} ranks: gradient differs from one rank's")
    print(cards, flush=True)


if __name__ == "__main__":
    main()
