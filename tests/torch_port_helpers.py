"""Shared helpers of the tests/test_torch_*.py files: the same scenes built
in both packages, parameters carried across as numpy arrays, and the image
comparison with its stated tolerance."""

import dataclasses

import numpy as np
import torch

import rust_tracing_tpu as J
import rust_tracing_tpu_torch as T
from rust_tracing_tpu.models import builders as jbuilders
from rust_tracing_tpu_torch.models import builders as tbuilders
from rust_tracing_tpu_torch.models import compile as tcompile

torch.set_num_threads(1)

FLAGS = tcompile._FLAG_NAMES


def scene_to_numpy(jscene):
    """(fields, flags) of a JAX CompiledScene as numpy arrays / bools."""
    fields, flags = {}, {}
    for f in dataclasses.fields(jscene):
        v = getattr(jscene, f.name)
        if f.name in FLAGS:
            flags[f.name] = bool(v)
        else:
            fields[f.name] = np.asarray(v)
    return fields, flags


def carry_scene(jscene):
    """The port's CompiledScene (on the CPU) from a JAX CompiledScene."""
    fields, flags = scene_to_numpy(jscene)
    return tcompile.scene_from_numpy(fields, flags, device="cpu")


def mixed_builder(M):
    """metal + dielectric + box medium + motion blur, defocus camera: the
    scene of tests/test_megakernel.py::test_media_and_materials_smoke, with a
    sphere medium added so both boundary kinds run."""
    b = M.SceneBuilder(background=(0.6, 0.7, 1.0))
    b.add_sphere((0, -100.5, -2), 100.0, b.lambertian((0.5, 0.5, 0.5)))
    b.add_sphere((0, 0, -2), 0.5, b.metal((0.9, 0.8, 0.7), 0.3))
    b.add_sphere((1.1, 0, -2), 0.5, b.dielectric(1.5))
    b.add_sphere((-1.1, 0.2, -2), 0.3, b.lambertian((0.8, 0.2, 0.2)),
                 target=(-1.1, 0.5, -2))
    b.add_box_medium((-0.4, -0.5, -2.6), (0.4, 0.5, -1.6), 0.7, (1, 1, 1))
    b.add_sphere_medium((1.0, 1.0, -2.5), 0.6, 0.9, (0.2, 0.4, 0.9))
    s = M.RenderSettings(
        image_width=24, aspect_ratio=1.0, samples_per_pixel=4, max_depth=4,
        vfov=60.0, look_from=(0, 0, 1), look_at=(0, 0, -2),
        defocus_angle=1.0, focus_dist=3.0, background=(0.6, 0.7, 1.0))
    return b, s


def bvh_builder(M):
    """tests/test_wavefront.py::_bvh_scene: 31 spheres, a cube (6 quads)
    and a box medium; enough for a real BVH walk."""
    rng = np.random.default_rng(0)
    b = M.SceneBuilder(background=(0.6, 0.7, 1.0))
    b.add_sphere((0, -100.5, -2), 100.0, b.lambertian((0.5, 0.5, 0.5)))
    for i in range(30):
        p = rng.uniform(-2, 2, 3)
        p[1] = rng.uniform(-0.4, 0.8)
        p[2] = -2 + rng.uniform(-1.5, 1.5)
        m = [b.lambertian(tuple(rng.uniform(0.1, 0.9, 3))),
             b.metal((0.8, 0.7, 0.6), 0.2), b.dielectric(1.5)][i % 3]
        b.add_sphere(tuple(p), 0.25, m)
    b.add_cube((-0.5, -0.5, -3.2), (0.5, 0.5, -2.6),
               b.lambertian((0.7, 0.3, 0.2)))
    b.add_box_medium((1.0, -0.5, -2.0), (1.8, 0.5, -1.2), 0.6, (1, 1, 1))
    s = M.RenderSettings(
        image_width=24, aspect_ratio=1.0, samples_per_pixel=4, max_depth=4,
        vfov=60.0, look_from=(0, 0, 1), look_at=(0, 0, -2),
        background=(0.6, 0.7, 1.0))
    return b, s


def texture_builder(M):
    """Every texture family: solid, noise, image, and checkers whose
    children are noise, image and solid; a sphere each (image on a
    sphere, as the fused kernel requires)."""
    img = (np.arange(8 * 16 * 3).reshape(8, 16, 3) * 11 % 256).astype(
        np.uint8)
    b = M.SceneBuilder(background=(0.5, 0.6, 0.9))
    noise = b.noise_texture(2.0)
    image = b.image_texture(img)
    b.add_sphere((0, 0, 2), 1.0, b.lambertian(image))
    b.add_sphere((0, -101, 2), 100.0, b.lambertian(noise))
    b.add_sphere((1.6, 0.2, 2.6), 0.6,
                 b.lambertian(b.checker_texture(0.4, noise, (0.8, 0.2, 0.1))))
    b.add_sphere((-1.5, 0.1, 2.4), 0.5,
                 b.lambertian(b.checker_texture(0.3, (0.1, 0.7, 0.2), image)))
    b.add_sphere((0.2, 1.4, 2.8), 0.4, b.diffuse_light((4.0, 4.0, 4.0)))
    s = M.RenderSettings(
        image_width=16, aspect_ratio=1.0, samples_per_pixel=2, max_depth=3,
        vfov=70.0, look_from=(0, 0, 0), look_at=(0, 0, 2),
        background=(0.5, 0.6, 0.9))
    return b, s


def both(name, **overrides):
    """(jax scene, jax camera, torch scene, torch camera) for a named scene
    ('mixed', 'textures' or a builder name) at a small size."""
    if name in ("mixed", "textures"):
        make = mixed_builder if name == "mixed" else texture_builder
        jb, js = make(J)
        tb, ts = make(T)
    else:
        jb, js = getattr(jbuilders, name)()
        tb, ts = getattr(tbuilders, name)()
    js = dataclasses.replace(js, **overrides)
    ts = dataclasses.replace(ts, **overrides)
    return (J.compile_scene(jb), J.Camera.create(js),
            T.compile_scene(tb, device="cpu"), T.Camera.create(ts))


# Image tolerance between the two frameworks on the CPU, and its reason. Both
# draw the same random streams and do the same f32 operations in the same
# order, so pixels normally agree bitwise; but XLA's CPU code may contract a
# multiply-add or use another sin/cos/log/exp than PyTorch's, and one ulp in a
# hit decision (disc > 0, t < t_best, alpha <= 1) sends that sample down a
# different path. So: a pixel counts as equal within 1e-5 + 1e-5*|ref|, the
# SHARE of pixels beyond that is bounded (2 %), the mean images agree to
# 1e-3, and ray counts must be equal whenever no pixel diverged.
PIX_ATOL, PIX_RTOL = 1e-5, 1e-5
MAX_DIVERGED_SHARE = 0.02
MAX_MEAN_RATIO_ERR = 1e-3

# Per-pixel tolerance for the noise (marble) texture against JIT-compiled
# JAX. XLA's CPU compiler contracts the marble's argument scale*z + 10*turb
# into one fused multiply-add, which the port (like its CUDA kernels) never
# does. On a far ground sphere |scale*z| reaches ~1e3, where one ulp of the
# argument is 6e-5: sin carries it into the texture and the throughput.
# Measured: 1.1e-4 at most on two_perlin_spheres at 16 px; no path diverges.
MARBLE_PIX_TOL = 1e-3


def assert_images_agree(img, ref, rays=None, ref_rays=None, pix_tol=None):
    img = np.asarray(img, np.float64)
    ref = np.asarray(ref, np.float64)
    assert img.shape == ref.shape
    assert np.isfinite(img).all()
    atol, rtol = (PIX_ATOL, PIX_RTOL) if pix_tol is None else (pix_tol,
                                                                pix_tol)
    beyond = (np.abs(img - ref) > atol + rtol * np.abs(ref)).any(-1)
    assert beyond.mean() <= MAX_DIVERGED_SHARE, (
        f"{beyond.sum()} of {beyond.size} pixels beyond tolerance")
    assert abs(img.mean() / ref.mean() - 1.0) <= MAX_MEAN_RATIO_ERR
    if rays is not None and not beyond.any():
        assert int(rays) == int(ref_rays)
