"""What the ranks of tests/test_torch_parallel.py run. Each rank is a fresh
interpreter started by rust_tracing_tpu_torch.parallel.launch.run_ranks, so
this module imports the port only, never JAX (tests/torch_port_helpers.py
and tests/conftest.py do)."""

import dataclasses
import time

import numpy as np
import torch

import rust_tracing_tpu_torch as T
from rust_tracing_tpu_torch.models import builders
from rust_tracing_tpu_torch.models.compile import grad_to_numpy
from rust_tracing_tpu_torch.ops import megakernel as mk
from rust_tracing_tpu_torch.parallel import grad_dist, render_dist
from rust_tracing_tpu_torch.parallel.mesh import make_mesh

SPP, DEPTH = 4, 3


def cornell(device, width=16):
    b, s = builders.cornell_box()
    s = dataclasses.replace(s, image_width=width, samples_per_pixel=SPP,
                            max_depth=DEPTH)
    return T.compile_scene(b, device=device), T.Camera.create(s)


def noise_scene(device):
    """tests/test_parallel.py::_scene: a checker ground, a metal sphere and
    a noise sphere."""
    b = T.SceneBuilder(background=(0.6, 0.7, 1.0))
    b.add_sphere((0, -100.5, -2), 100.0, b.lambertian(
        b.checker_texture(0.4, (0.8, 0.7, 0.2), (0.2, 0.3, 0.7))))
    b.add_sphere((0, 0, -2), 0.5, b.metal((0.9, 0.8, 0.7), 0.05))
    b.add_sphere((-1.1, 0, -2), 0.5, b.lambertian(b.noise_texture(3.0)))
    s = T.RenderSettings(
        aspect_ratio=1.0, image_width=16, samples_per_pixel=8, max_depth=4,
        vfov=60.0, look_from=(0, 0, 1), look_at=(0, 0, -2),
        background=(0.6, 0.7, 1.0))
    return T.compile_scene(b, device=device), T.Camera.create(s)


def _grad(scene, cam, mesh, target, recorder="auto", seed=7, spp=SPP,
          depth=DEPTH):
    loss, g, rays = grad_dist.replay_loss_and_grad(
        scene, cam, mesh, target, seed=seed, spp=spp, max_depth=depth,
        recorder=recorder)
    return float(loss), grad_to_numpy(g), rays


def two_ranks(device, target, noise_target):
    """World 2: the sharded render (fused and tensor paths) on the 2x1 and
    1x2 meshes, the replay gradient with both recorders on both, one direct
    train step on 1x2,
    the noise scene's gradient and six replay train steps."""
    torch.set_num_threads(1)
    scene, cam = cornell(device)
    out = {}
    for sp in (1, 2):
        mesh = make_mesh(sp, device=device)
        out["render", sp] = mk.render_fast_sharded(scene, cam, mesh, seed=5,
                                                   with_stats=True)
        out["tensor_render", sp] = render_dist.render_distributed(
            scene, cam, mesh, seed=5, use_megakernel=False)
        for rec in ("kernel", "xla"):
            out["grad", sp, rec] = _grad(scene, cam, mesh, target, rec)
    mesh = make_mesh(2, device=device)
    n_pix = cam.image_width * cam.image_height
    step = render_dist.make_distributed_train_step(
        mesh, spp=SPP, max_depth=DEPTH, learning_rate=0.1)
    new, loss = step(scene, cam.constants(device=device),
                     torch.arange(n_pix, dtype=torch.int32),
                     torch.zeros((n_pix, 3)), 0)
    out["train"] = (float(loss), new.tex_rgb.numpy())

    nscene, ncam = noise_scene(device)
    out["noise_grad"] = _grad(nscene, ncam, mesh, noise_target, seed=3,
                              spp=8, depth=4)
    wrong = nscene.tex_rgb.clone()
    wrong[1] = torch.tensor([0.1, 0.1, 0.9])
    s = nscene.replace(tex_rgb=wrong)
    fit = grad_dist.make_replay_train_step(
        mesh, ncam, spp=SPP, max_depth=DEPTH, learning_rate=0.004,
        trainable=("tex_rgb",), recorder="xla")
    losses = []
    for _ in range(6):
        s, loss = fit(s, noise_target, seed=0)
        losses.append(float(loss))
    out["fit_losses"] = losses
    return out


def four_ranks(device, target):
    """World 4: the sharded render on the 4x1 and 2x2 meshes and the replay
    gradient on 2x2."""
    torch.set_num_threads(1)
    scene, cam = cornell(device)
    out = {}
    for sp in (1, 2):
        out["render", sp] = mk.render_fast_sharded(
            scene, cam, make_mesh(sp, device=device), seed=5,
            with_stats=True)
    out["grad", 2] = _grad(scene, cam, make_mesh(2, device=device), target)
    return out


def raise_on_rank_one(device):
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    return dist.get_rank()


def hang_on_rank_one(device):
    import torch.distributed as dist

    if dist.get_rank() == 1:
        time.sleep(60)
    return dist.get_rank()
