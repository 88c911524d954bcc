"""The port's gradient (grad.py) on the CPU: ``loss_and_grad`` against the
JAX package's, the sliced accumulation against the single-shot path, a
float64 finite-difference check, the CLI's ``--grad-check`` and the fitting
loop.

Tolerances and their reasons. Against JAX the loss agrees to 1e-6 relative
and every float leaf's gradient to 1e-5 of that leaf's largest |g|: the
estimators are the same, but the image mean and the backward sums (the
transpose of each table gather, the broadcast reductions) add in another
order than XLA's. Sliced == single-shot to rtol 2e-5: the slices partition
the sample sum (the reference's own tolerance, tests/test_replay.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rust_tracing_tpu as J
import rust_tracing_tpu_torch as T
from rust_tracing_tpu import grad as jgrad
from rust_tracing_tpu_torch import cli
from rust_tracing_tpu_torch import grad as tg
from rust_tracing_tpu_torch.models.compile import grad_to_numpy
from torch_port_helpers import both, texture_builder

W = [1.0, 2.0, 0.5]


@pytest.fixture(scope="module")
def cornell():
    return both("cornell_box", image_width=16, samples_per_pixel=4,
                max_depth=4)


@pytest.fixture(scope="module")
def jax_grad(cornell):
    """The reference's (loss, gradient) of the cornell fixture, seed 5."""
    jscene, jcam, _, _ = cornell
    return jgrad.loss_and_grad(
        jscene, jcam, lambda im, p: jnp.mean(im * jnp.asarray(W)), seed=5)


def _assert_matches_jax(tl, g, jax_grad, no_grad=()):
    """Loss to 1e-6 relative, each float leaf within 1e-5 of its largest
    |g|; int/bool fields and the fields of ``no_grad`` hold zeros."""
    jl, jg = jax_grad
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    got = grad_to_numpy(g)
    for f in got:
        ref = np.asarray(getattr(jg, f))
        if f in no_grad or not np.issubdtype(ref.dtype, np.floating):
            assert not got[f].any(), f
            continue
        scale = max(np.abs(ref).max(), 1e-30)
        np.testing.assert_allclose(got[f], ref, rtol=0, atol=1e-5 * scale,
                                   err_msg=f)
    assert np.abs(got["tex_rgb"]).max() > 0
    assert np.abs(got["tex_rgb"][3]).max() > 0  # the light's emission row


def test_loss_and_grad_matches_jax(cornell, jax_grad):
    _, _, tscene, tcam = cornell
    tl, g, rays = tg.loss_and_grad(
        tscene, tcam, lambda im, p: torch.mean(im * torch.tensor(W)), seed=5,
        with_rays=True)
    assert isinstance(rays, int) and rays > 0
    _assert_matches_jax(tl, g, jax_grad)


def test_sliced_accumulation_equals_single_shot(cornell, monkeypatch):
    _, _, scene, cam = cornell

    def l2(im, p):
        d = im - 0.25
        return torch.mean(d * d)

    l1, g1 = tg.loss_and_grad(scene, cam, l2, seed=3, spp=8, max_depth=4)
    # a budget below one sample's records: one slice of 3 samples at a time
    monkeypatch.setattr(tg, "RECORD_BUDGET_ENTRIES", 3 * 4 * 256)
    l2_, g2 = tg.loss_and_grad(scene, cam, l2, seed=3, spp=8, max_depth=4)
    np.testing.assert_allclose(float(l1), float(l2_), rtol=1e-6)
    np.testing.assert_allclose(g1.tex_rgb.numpy(), g2.tex_rgb.numpy(),
                               rtol=2e-5, atol=1e-7)

    def mean(im, p):
        return im.mean()

    l3, g3 = tg.loss_and_grad(scene, cam, mean, seed=3, spp=8, max_depth=4)
    l4, g4 = tg.loss_and_grad(scene, cam, mean, seed=3, spp=8, max_depth=4,
                              linear_loss=True)
    np.testing.assert_allclose(float(l3), float(l4), rtol=1e-6)
    np.testing.assert_allclose(g3.tex_rgb.numpy(), g4.tex_rgb.numpy(),
                               rtol=2e-5, atol=1e-7)
    with pytest.raises(ValueError, match="linearity probe"):
        tg.loss_and_grad(scene, cam, l2, spp=2, max_depth=2,
                         linear_loss=True)


def _mini_cornell_solid():
    """tests/test_grad.py::_mini_cornell with its two noise textures made
    solid (noise waits for its kernel): a box, a checker floor, a light and
    a sphere."""
    b = T.SceneBuilder(background=(0.0, 0.0, 0.0))
    back = b.lambertian((0.7, 0.6, 0.5))
    checker = b.lambertian(b.checker_texture(0.5, (0.8, 0.8, 0.2),
                                             (0.1, 0.1, 0.4)))
    red = b.lambertian((0.65, 0.05, 0.05))
    b.add_quad((-2, -2, 4), (4, 0, 0), (0, 4, 0), back)
    b.add_quad((-2, -2, 0), (0, 0, 4), (0, 4, 0), red)
    b.add_quad((-2, -2, 0), (4, 0, 0), (0, 0, 4), checker)
    b.add_quad((-1, 1.9, 1), (2, 0, 0), (0, 0, 2), b.diffuse_light((6, 6, 6)))
    b.add_sphere((0.3, -1.2, 2.0), 0.8, b.lambertian((0.3, 0.5, 0.7)))
    settings = T.RenderSettings(
        aspect_ratio=1.0, image_width=16, samples_per_pixel=8, max_depth=4,
        vfov=60.0, look_from=(0.0, 0.0, -3.0), look_at=(0.0, 0.0, 2.0),
        background=(0.0, 0.0, 0.0))
    return b, settings


@pytest.mark.parametrize("index", [(1, 0), (5, 0)],
                         ids=["checker_even_red", "light_red"])
def test_autodiff_matches_finite_differences(index):
    """float64 central differences of the fixed-RNG estimator with the
    masking rule of tests/test_grad.py: pixels whose value jumps by more
    than 30*eps flipped a discrete decision and are left out of both sides
    (they must stay sparse)."""
    b, s = _mini_cornell_solid()
    scene = T.compile_scene(b, dtype=torch.float64, device="cpu")
    cam = T.Camera.create(s)
    c = cam.constants(torch.float64, device="cpu")
    pid = torch.arange(256, dtype=torch.int32)
    eps = 1e-5

    def render(sc):
        with torch.no_grad():
            return tg.radiance_mean(sc, c, pid, 3, 8, 4).numpy()

    arr = scene.tex_rgb.numpy().copy()
    up, dn = arr.copy(), arr.copy()
    up[index] += eps
    dn[index] -= eps
    img_p = render(scene.replace(tex_rgb=torch.from_numpy(up)))
    img_m = render(scene.replace(tex_rgb=torch.from_numpy(dn)))
    jump = np.abs(img_p - img_m).max(-1) > 30 * eps
    assert (~jump).sum() >= 0.95 * jump.size
    fd = float(((img_p - img_m) / (2 * eps))[~jump].mean())
    mask = torch.from_numpy((~jump).astype(np.float64))
    n_keep = float(mask.sum())

    def loss_fn(img, p):
        return torch.sum(img * mask[:, None]) / (n_keep * 3)

    _, g = tg.loss_and_grad(scene, cam, loss_fn, seed=3, spp=8, max_depth=4,
                            dtype=torch.float64)
    ad = float(g.tex_rgb[index])
    assert fd != 0.0 and np.isfinite(ad)
    assert abs(fd - ad) <= max(0.03 * max(abs(fd), abs(ad)), 1e-7)


def test_texture_replay_gradient_equals_direct():
    """Every texture family (noise, image, checkers with noise and image
    children): the record/replay gradient (the recorder's plain version, the
    turbulence Function's backward, the image gather's reduction) equals the
    direct estimator's, every leaf within 1e-6 of its largest |g| (the
    replay reduces some broadcasts in another shape, test_torch_replay.py),
    and the image, Perlin table and noise-scale gradients are non-zero."""
    b, s = texture_builder(T)
    s = dataclasses.replace(s, image_width=10, samples_per_pixel=2)
    scene = T.compile_scene(b, device="cpu")
    cam = T.Camera.create(s)

    def loss_fn(im, p):
        return torch.mean(im * torch.tensor(W))

    l1, g1 = tg.loss_and_grad(scene, cam, loss_fn, seed=2)
    l2, g2 = tg.loss_and_grad(scene, cam, loss_fn, seed=2,
                              use_recorder=False)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
    a, r = grad_to_numpy(g1), grad_to_numpy(g2)
    for f in a:
        scale = max(np.abs(r[f]).max(), 1e-30)
        np.testing.assert_allclose(a[f], r[f], rtol=0, atol=1e-6 * scale,
                                   err_msg=f)
    for f in ("image", "perlin_ranvec", "tex_noise_scale", "sph_center"):
        assert np.isfinite(a[f]).all() and np.abs(a[f]).max() > 0, f


def _mini_cornell_noise(M=T, width=12):
    """tests/test_grad.py::_mini_cornell (in package M; at a smaller frame
    by default): a marble back wall, a checker floor and a marble sphere,
    where the continuous channel geometry -> hit point -> marble makes
    geometry gradients non-zero."""
    b = M.SceneBuilder(background=(0.0, 0.0, 0.0))
    marble = b.lambertian(b.noise_texture(2.0))
    checker = b.lambertian(b.checker_texture(0.5, (0.8, 0.8, 0.2),
                                             (0.1, 0.1, 0.4)))
    red = b.lambertian((0.65, 0.05, 0.05))
    b.add_quad((-2, -2, 4), (4, 0, 0), (0, 4, 0), marble)
    b.add_quad((-2, -2, 0), (0, 0, 4), (0, 4, 0), red)
    b.add_quad((-2, -2, 0), (4, 0, 0), (0, 0, 4), checker)
    b.add_quad((-1, 1.9, 1), (2, 0, 0), (0, 0, 2), b.diffuse_light((6, 6, 6)))
    b.add_sphere((0.3, -1.2, 2.0), 0.8, b.lambertian(b.noise_texture(3.0)))
    settings = M.RenderSettings(
        aspect_ratio=1.0, image_width=width, samples_per_pixel=4,
        max_depth=3, vfov=60.0, look_from=(0.0, 0.0, -3.0),
        look_at=(0.0, 0.0, 2.0), background=(0.0, 0.0, 0.0))
    return b, settings


@pytest.mark.parametrize("field,index", [("sph_center", (0, 0)),
                                         ("tex_noise_scale", (0,))],
                         ids=["sphere_x", "marble_scale"])
def test_noise_gradient_matches_finite_differences(field, index):
    """float64 central differences through the marble texture (the
    turbulence Function's backward into the hit point, and the noise scale),
    with the jump masking of test_autodiff_matches_finite_differences."""
    b, s = _mini_cornell_noise()
    scene = T.compile_scene(b, dtype=torch.float64, device="cpu")
    cam = T.Camera.create(s)
    c = cam.constants(torch.float64, device="cpu")
    n = cam.image_width * cam.image_height
    pid = torch.arange(n, dtype=torch.int32)
    eps = 1e-6

    def render(sc):
        with torch.no_grad():
            return tg.radiance_mean(sc, c, pid, 3, 4, 3).numpy()

    arr = getattr(scene, field).numpy().copy()
    up, dn = arr.copy(), arr.copy()
    up[index] += eps
    dn[index] -= eps
    img_p = render(scene.replace(**{field: torch.from_numpy(up)}))
    img_m = render(scene.replace(**{field: torch.from_numpy(dn)}))
    jump = np.abs(img_p - img_m).max(-1) > 300 * eps
    assert (~jump).sum() >= 0.95 * jump.size
    fd = float(((img_p - img_m) / (2 * eps))[~jump].mean())
    mask = torch.from_numpy((~jump).astype(np.float64))
    n_keep = float(mask.sum())

    def loss_fn(img, p):
        return torch.sum(img * mask[:, None]) / (n_keep * 3)

    _, g = tg.loss_and_grad(scene, cam, loss_fn, seed=3, spp=4, max_depth=3,
                            dtype=torch.float64)
    ad = float(getattr(g, field)[index])
    assert fd != 0.0 and np.isfinite(ad)
    assert abs(fd - ad) <= max(0.03 * max(abs(fd), abs(ad)), 1e-7)


def test_cli_grad_check_on_cpu(tmp_path, capsys):
    rc = cli.main(["-s", "6", "--width", "16", "--spp", "1", "--max-depth",
                   "3", "--grad-check", "--device", "cpu",
                   "-o", str(tmp_path / "gc")])
    out = capsys.readouterr().out
    assert rc == 0 and "grad-check: OK" in out


def test_fit_scene_lowers_the_loss():
    b, s = _mini_cornell_solid()
    s = dataclasses.replace(s, image_width=12, samples_per_pixel=4)
    scene0 = T.compile_scene(b, device="cpu")
    cam = T.Camera.create(s)
    c = cam.constants(device="cpu")
    pid = torch.arange(144, dtype=torch.int32)
    with torch.no_grad():
        target = tg.radiance_mean(scene0, c, pid, 0, 4, 3)
    wrong = scene0.tex_rgb.clone()
    wrong[1] = torch.tensor([0.2, 0.2, 0.9])
    scene, losses = tg.fit_scene(
        scene0.replace(tex_rgb=wrong), cam, target.numpy().reshape(12, 12, 3),
        steps=4, learning_rates={"tex_rgb": 6.0}, spp=4, max_depth=3,
        resample=False)
    assert losses[-1] < losses[0]
    err = (scene.tex_rgb[1] - scene0.tex_rgb[1]).abs().max()
    assert err < (wrong[1] - scene0.tex_rgb[1]).abs().max()


def test_bvh_scene_gradient_matches_jax(cornell, jax_grad):
    """loss_and_grad of cornell_box compiled with a BVH, by the direct
    estimator, which searches the tree (closest_hit_bvh), against the
    reference's gradient of the same scene. The reference's side searches
    by brute force: its own closest_hit_bvh drops cornell's thin wall quads
    in f32 (test_torch_bvh.py::test_closest_hit_bvh_keeps_thin_quads); the
    port's finds the brute search's winners."""
    _, _, _, tcam = cornell
    b, _ = T.models.builders.cornell_box()
    tscene = T.compile_scene(b, use_bvh=True, device="cpu")
    assert tscene.has_bvh
    tl, g = tg.loss_and_grad(
        tscene, tcam, lambda im, p: torch.mean(im * torch.tensor(W)), seed=5,
        use_recorder=False)
    _assert_matches_jax(tl, g, jax_grad, no_grad=("bvh_min", "bvh_max"))


def test_jacfwd_through_textured_scene():
    """The port of tests/test_grad.py::test_jacfwd_through_textured_scene:
    torch.func.jacfwd of the replay image's row mean (the middle row of the
    24 px noise scene, seed 3, 4 spp, depth 3, float64) w.r.t. ``tex_rgb``,
    through the batching rules of tgather, tgather_cols and the turbulence
    Function, against jax.jacfwd of the reference's replay and against the
    port's own jacrev, rtol 1e-10 (the reference's own tolerance). Both
    replay the port's records (equal to the reference's:
    test_torch_replay.py)."""
    tb, ts = _mini_cornell_noise(T, 24)
    scene = T.compile_scene(tb, dtype=torch.float64, device="cpu")
    cam = T.Camera.create(ts)
    c = cam.constants(torch.float64, device="cpu")
    pid = 24 * 12 + torch.arange(24, dtype=torch.int32)
    recs = tg.get_records(scene, cam, 3, 4, 3, pixel_ids=pid,
                          dtype=torch.float64)

    def f(tex_rgb):
        img, _ = tg.radiance_mean_replay_rays(scene.replace(tex_rgb=tex_rgb),
                                              c, pid, 3, recs, 4, 3)
        return img.mean(-1)

    j_fwd = torch.func.jacfwd(f)(scene.tex_rgb).numpy()
    j_rev = torch.func.jacrev(f)(scene.tex_rgb).numpy()
    jb, js = _mini_cornell_noise(J, 24)
    jscene = J.compile_scene(jb, dtype=jnp.float64)
    jcam = J.Camera.create(js).constants(jnp.float64)
    jpid, jrecs = jnp.asarray(pid.numpy()), jnp.asarray(recs.numpy())

    def jf(tex_rgb):
        img, _ = jgrad.radiance_mean_replay_rays(
            dataclasses.replace(jscene, tex_rgb=tex_rgb), jcam, jpid,
            jnp.uint32(3), jrecs, 4, 3)
        return jnp.mean(img, axis=-1)

    ref = np.asarray(jax.jit(jax.jacfwd(jf))(jscene.tex_rgb))
    assert np.isfinite(j_fwd).all() and np.abs(j_fwd).max() > 0
    np.testing.assert_allclose(j_fwd, ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(j_fwd, j_rev, rtol=1e-10, atol=1e-12)
