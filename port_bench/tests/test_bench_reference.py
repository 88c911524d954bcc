"""The plain reference on known small cases, and against the program's own
plain version (its CPU path) at tiny sizes: the same numbers bit for bit."""

import math

import numpy as np
import pytest
import torch

from port_bench import check, driver
from port_bench.lookup import find_cell
from port_bench.reference import grad as RG
from port_bench.reference import rng as R
from port_bench.reference import scenes as RS
from port_bench.reference import trace as RT


def test_rng_draws_are_addressed_not_sequential():
    pix = torch.arange(4, dtype=torch.int32)
    a = R.Rng(3, pix, torch.full((4,), 5, dtype=torch.int32)).uniform(1)
    b = R.Rng(3, pix, 5).uniform(1)
    assert torch.equal(a, b)
    assert bool(((a >= 0) & (a < 1)).all()) and len(set(a.tolist())) == 4
    # fmix32 of 0 is 0: the all-zero address draws exactly 0
    assert float(R.Rng(0, 0, 0).uniform(0)) == 0.0


def test_camera_center_ray_and_frame():
    cfg = dict(image_width=2, aspect_ratio=1.0, vfov=90.0,
               look_from=(0.0, 0.0, 0.0), look_at=(0.0, 0.0, -1.0),
               focus_dist=1.0, background=(0.0, 0.0, 0.0))
    v = RS.view(cfg)
    # the two pixel centres of row 0 sit at x = -/+0.5, y = +0.5, z = -1
    assert v.pixel00 == pytest.approx((-0.5, 0.5, -1.0))
    assert v.delta_u == pytest.approx((1.0, 0.0, 0.0))
    assert v.delta_v == pytest.approx((0.0, -1.0, 0.0))


def _one_quad_scene():
    s = RS.Scene()
    s.quad((-1, -1, -2), (2, 0, 0), (0, 2, 0), s.light((4.0, 2.0, 1.0)))
    return s


def test_a_ray_into_a_light_quad_returns_its_emission():
    cfg = dict(image_width=1, aspect_ratio=1.0, vfov=10.0,
               look_from=(0.0, 0.0, 0.0), look_at=(0.0, 0.0, -1.0),
               focus_dist=1.0, background=(0.0, 0.0, 0.0))
    tb = RS.tables(_one_quad_scene(), "cpu")
    pix = torch.zeros(8, dtype=torch.int32)
    samp = torch.arange(8, dtype=torch.int32)
    rad, nb, recs = RT.trace(tb, RS.view(cfg), 1, pix, samp, 4, record=True)
    assert torch.equal(rad, torch.tensor([[4.0, 2.0, 1.0]] * 8))
    assert nb.tolist() == [1] * 8  # a light does not scatter
    assert recs[0].tolist() == [2 << 24] * 8 and not recs[1:].any()


def test_quad_t_hand_computed():
    tb = RS.tables(_one_quad_scene(), "cpu")
    z = torch.zeros(1)
    t = RT._quad_t(tb["quad"][:1], z, z, z, z, z, z - 1.0)
    assert float(t) == 2.0
    t_miss = RT._quad_t(tb["quad"][:1], z + 5.0, z, z, z, z, z - 1.0)
    assert math.isinf(float(t_miss))


def test_bfloat16_reference_runs_in_bfloat16():
    cell = find_cell(check_root(), "cornell_box.offline")
    tb = RS.tables(check.reference_scene(cell), "cpu", torch.bfloat16)
    v = RS.view(dict(image_width=8, aspect_ratio=1.0, vfov=40.0,
                     look_from=(278.0, 278.0, -800.0),
                     look_at=(278.0, 278.0, 0.0), background=(0, 0, 0)))
    rgb, rays = RT.pixel_means(tb, v, 5, torch.arange(64, dtype=torch.int32),
                               0, 2, 4)
    assert rgb.dtype == torch.bfloat16 and int(rays.sum()) > 64


@pytest.mark.parametrize("name, width, spp, depth, offset", [
    ("cornell_box", 16, 3, 8, 0),
    ("final_scene", 12, 2, 8, 4096),
])
def test_reference_equals_the_programs_plain_render(name, width, spp, depth,
                                                    offset):
    from rust_tracing_tpu_torch import renderer
    cell = find_cell(check_root(), name + (".offline" if name == "cornell_box"
                                           else ".progressive"))
    cell.cfg.update(image_width=width, max_depth=depth)
    cfg = cell.cfg
    scene, cam = driver.build_program_scene(driver.program(), cfg,
                                            torch.device("cpu"))
    img, st = renderer.render(scene, cam, seed=99, spp=spp,
                              sample_offset=offset, use_megakernel=True,
                              device="cpu")
    tb = RS.tables(check.reference_scene(cell), "cpu")
    pix = torch.arange(width * width, dtype=torch.int32)
    rgb, rays = RT.pixel_means(tb, RS.view(cfg), 99, pix, offset, spp, depth)
    assert np.array_equal(img.reshape(-1, 3), rgb.double().numpy())
    assert st.rays == int(rays.sum())


def test_gradient_reference_against_the_program():
    from rust_tracing_tpu_torch import grad
    cell = find_cell(check_root(), "cornell_box.grad")
    cell.cfg.update(image_width=16, max_depth=4)
    cfg = cell.cfg
    scene, cam = driver.build_program_scene(driver.program(), cfg,
                                            torch.device("cpu"))
    loss, g, rays = grad.loss_and_grad(scene, cam, lambda im, p: im.mean(),
                                       seed=4, spp=2, max_depth=4,
                                       with_rays=True, linear_loss=True)
    rl, rg, rr = RG.mean_and_grad(check.reference_scene(cell),
                                  RS.view(cfg), 4, 2, 4, "cpu")
    assert rays == rr
    assert float(loss) == pytest.approx(rl, rel=1e-5)
    got = {k: getattr(g, k).double().numpy() for k in rg}
    assert check.leaf_gap(got, rg) < 1e-5
    # Lambertian throughput is the albedo alone: the image depends on the
    # colours and not on where the quads lie
    assert np.abs(rg["tex_rgb"]).max() > 0 and not np.abs(rg["quad_q"]).any()


def check_root():
    from .conftest import ROOT
    return ROOT


def test_reference_equals_the_programs_plain_render_on_the_earth():
    """A run of pixels of final_scene's 800x800 frame that sees the image
    texture's sphere (pixel 318475, sample 950 of seed 1103316063 once
    exposed a wrong polynomial coefficient of the reference's atan2)."""
    from rust_tracing_tpu_torch.ops import megakernel as mk
    cell = find_cell(check_root(), "final_scene.progressive")
    cfg = cell.cfg
    scene, cam = driver.build_program_scene(driver.program(), cfg,
                                            torch.device("cpu"))
    base, count, seed, s0 = 318475 - 16, 32, 1103316063, 950
    rgb_p, n_p = mk.render_pixels(scene, cam, seed=seed, spp=2,
                                  max_depth=40, sample_offset=s0,
                                  pixel_base=base, pixel_count=count)
    tb = RS.tables(check.reference_scene(cell), "cpu")
    pix = torch.arange(base, base + count, dtype=torch.int32)
    rgb_r, n_r = RT.pixel_means(tb, RS.view(cfg), seed, pix, s0, 2, 40)
    assert torch.equal(rgb_p, rgb_r) and torch.equal(n_p.long(), n_r)
