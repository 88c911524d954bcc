"""Entry points of the port: a one-card render step and a multi-rank dry
run, the counterparts of the repository's ``__graft_entry__.py``.

``entry()`` gives (fn, args) for one spp batch of ``grad.radiance_mean`` on
the flagship cornell_box scene. ``dryrun_multichip(n)`` runs one sharded
render, one distributed train step and one distributed record/replay train
step over ``n`` ranks (``parallel.launch.run_ranks``), each rank a fresh
interpreter that runs ``_dryrun_rank`` of this module.

Run on the GPU: ``python -m rust_tracing_tpu_torch.entry [N]`` (N ranks,
default 2); ``dryrun_multichip(n, device="cpu")`` runs them under gloo
on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from .camera import Camera
from .config import resolve_device
from .models import builders
from .models.compile import compile_scene

DRYRUN_TIMEOUT_S = 300.0
# The dry run's frame and step, as the reference's (__graft_entry__.py)
DRY_WIDTH, DRY_SPP, DRY_DEPTH, DRY_LR = 16, 4, 3, 0.01


def _flagship(image_width: int = 64, spp: int = 2, max_depth: int = 4,
              device=None):
    """(scene, camera) of cornell_box at the given size on ``device``."""
    b, settings = builders.cornell_box()
    settings = dataclasses.replace(settings, image_width=image_width,
                                   samples_per_pixel=spp, max_depth=max_depth)
    return (compile_scene(b, device=resolve_device(device)),
            Camera.create(settings))


def entry(device=None):
    """(fn, example_args): one spp batch of radiance for a flat pixel chunk
    of the flagship: ``fn(scene, cam, pixel_ids, seed)`` -> (1024, 3) mean
    radiance over 2 samples at depth 4 (the tensor integrator, with the
    table gathers B5/B6 on a GPU)."""
    from .grad import radiance_mean

    scene, camera = _flagship(device=device)
    cam = camera.constants(torch.float32, device=scene.device)
    pixel_ids = torch.arange(1024, dtype=torch.int32, device=scene.device)
    seed = 0

    def fn(scene, cam, pixel_ids, seed):
        return radiance_mean(scene, cam, pixel_ids, seed, spp=2, max_depth=4)

    return fn, (scene, cam, pixel_ids, seed)


def rank_layout(n_devices: int, device=None) -> dict:
    """How ``dryrun_multichip`` places its ranks, as ``chip_smoke.py``'s
    distributed phase does: on the CPU under gloo; on a card each when the
    host has ``n_devices`` cards (NCCL); else all on card 0 under gloo
    (NCCL refuses two ranks on one card)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return dict(device="cpu", backend="gloo")
    if torch.cuda.device_count() >= n_devices:
        return dict(device=None, backend="nccl")
    return dict(device="cuda:0", backend="gloo")


def _dryrun_rank(device, n_devices: int) -> dict:
    """One rank of ``dryrun_multichip``: the sharded forward held against
    one rank's ``render_chunk``, one direct train step and one record/replay
    train step, each gated; returns this rank's numbers."""
    from .parallel import grad_dist, render_dist
    from .parallel.mesh import make_mesh
    from .renderer import render_chunk

    sample_par = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(sample_par, device=device)
    scene, camera = _flagship(DRY_WIDTH, DRY_SPP, DRY_DEPTH, device=device)
    cam = camera.constants(torch.float32, device=scene.device)
    n_pix = camera.image_width * camera.image_height
    pixel_ids = torch.arange(n_pix, dtype=torch.int32, device=scene.device)

    # forward render sharded over the mesh, against a single-rank render of
    # the same (seed, pixel, sample) addresses: the RNG never sees the rank,
    # so the only tolerance is the float sum across the sample axis
    render_fn = render_dist.make_distributed_renderer(mesh, spp=DRY_SPP,
                                                      max_depth=DRY_DEPTH)
    target = render_fn(scene, cam, pixel_ids, 0)
    if tuple(target.shape) != (n_pix, 3):
        raise RuntimeError(f"sharded render shape {tuple(target.shape)}")
    with torch.no_grad():
        single, _ = render_chunk(scene, cam, pixel_ids, 0, 0, DRY_SPP,
                                 DRY_DEPTH)
    np.testing.assert_allclose(target.cpu().numpy(),
                               single.cpu().numpy() / DRY_SPP,
                               rtol=2e-5, atol=2e-6)

    # full training step: forward + backward + gradient all-reduce + SGD
    step = render_dist.make_distributed_train_step(
        mesh, spp=DRY_SPP, max_depth=DRY_DEPTH, learning_rate=DRY_LR)
    new_scene, loss = step(scene, cam, pixel_ids, target, 1)
    loss = float(loss)
    # the target IS a render of this scene at seed 0; a step at seed 1 has
    # a small finite loss (Monte-Carlo noise), not garbage
    if not 0.0 <= loss < 1e4:
        raise RuntimeError(f"implausible train-step loss {loss}")

    # the record/replay train step: recorder (B2 on a GPU), replay VJP,
    # one gradient all-reduce
    target_img = target.cpu().numpy().reshape(camera.image_height,
                                              camera.image_width, 3)
    rstep = grad_dist.make_replay_train_step(
        mesh, camera, spp=DRY_SPP, max_depth=DRY_DEPTH,
        learning_rate=DRY_LR)
    new_scene_r, loss_r = rstep(scene, target_img, seed=1)
    loss_r = float(loss_r)
    if not 0.0 <= loss_r < 1e6:
        raise RuntimeError(f"implausible replay train-step loss {loss_r}")
    for s in (new_scene, new_scene_r):
        if not bool(torch.isfinite(s.tex_rgb).all()):
            raise RuntimeError("a train step left a non-finite texture")
    return dict(rank=mesh.rank, mesh=mesh.shape, loss=loss,
                replay_loss=loss_r, device=str(scene.device))


def dryrun_multichip(n_devices: int, device=None,
                     timeout_s: float = DRYRUN_TIMEOUT_S) -> list:
    """One sharded render (held against one rank's), one distributed train
    step and one distributed record/replay train step over ``n_devices``
    ranks (a 2-wide sample axis when n is even), each rank a process
    (``rank_layout``). A rank that fails a gate, fails, or outlasts
    ``timeout_s`` raises here with every rank's output tail. Returns the
    ranks' dicts."""
    # the rank function by its package name, also when this module runs
    # as __main__ (python -m), so that a fresh interpreter can import it
    from . import entry as this_module
    from .parallel.launch import run_ranks

    layout = rank_layout(n_devices, device)
    if layout["device"] != "cpu":
        from .runtime import kernels

        kernels.load()  # build here once, not in every rank
    out = run_ranks(this_module._dryrun_rank, n_devices,
                    backend=layout["backend"],
                    device=layout["device"], timeout_s=timeout_s,
                    args=(n_devices,))
    r0 = out[0]
    print(f"dryrun_multichip({n_devices}): mesh={r0['mesh']} "
          f"loss={r0['loss']:.6f} replay_loss={r0['replay_loss']:.6f} "
          "sharded==single OK", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the port's entry point on one "
                                 "card, then its multi-rank dry run")
    ap.add_argument("n_devices", type=int, nargs="?", default=2)
    args = ap.parse_args(argv)
    fn, fargs = entry()
    out = fn(*fargs)
    print(f"entry: radiance {tuple(out.shape)} finite="
          f"{bool(torch.isfinite(out).all())} on {out.device}", flush=True)
    dryrun_multichip(args.n_devices)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
