"""The port's tensor integrator (ops/integrator.py, ``render(...,
use_megakernel=False)``) on the CPU against the JAX package's
``render(use_megakernel=False)`` and against the port's own fused path.

Against JAX the images and ray counts are expected bit for bit: both do the
same f32 operations in the same order on the same random streams. Against the
fused path the paths and ray counts are the same, but the fused kernel scales
its f32 sample sum by f32(1/spp) while ``render`` divides the f32 sum by spp
in float64, so pixels agree to the image tolerance of
``torch_port_helpers.assert_images_agree``."""

import dataclasses

import numpy as np
import pytest
import torch

import rust_tracing_tpu as J
import rust_tracing_tpu_torch as T
from rust_tracing_tpu import renderer as jrenderer
from rust_tracing_tpu_torch import renderer as trenderer
from rust_tracing_tpu_torch.camera import get_rays
from rust_tracing_tpu_torch.models import builders as tbuilders
from rust_tracing_tpu_torch.ops import integrator, intersect
from torch_port_helpers import assert_images_agree, both

SMALL = dict(image_width=16, samples_per_pixel=3, max_depth=4)


@pytest.mark.parametrize("name", ["cornell_box", "cornell_smoke"])
def test_tensor_render_matches_jax_and_fused(name):
    jscene, jcam, tscene, tcam = both(name, **SMALL)
    ref, ref_stats = J.render(jscene, jcam, seed=3, use_megakernel=False)
    img, stats = T.render(tscene, tcam, seed=3, use_megakernel=False,
                          device="cpu")
    np.testing.assert_array_equal(img, np.asarray(ref))
    assert stats.rays == ref_stats.rays > 0
    fused, fused_stats = T.render(tscene, tcam, seed=3, device="cpu")
    assert_images_agree(img, fused, stats.rays, fused_stats.rays)


def test_hit_fn_and_pixel_chunks():
    """A custom closest-hit function is what the integrator calls; chunking
    the pixels changes no bit."""
    _, _, scene, cam = both("cornell_box", **SMALL)
    calls = []

    def hit_fn(*args):
        calls.append(args[1].shape[0])
        return intersect.closest_hit(*args)

    ref, _ = T.render(scene, cam, seed=1, use_megakernel=False, device="cpu")
    img, _ = T.render(scene, cam, seed=1, hit_fn=hit_fn, pixel_chunk=100,
                      device="cpu")
    np.testing.assert_array_equal(img, ref)
    assert calls and set(calls) == {100}


def test_float64_matches_jax():
    b, s = tbuilders.cornell_box()
    s = dataclasses.replace(s, **SMALL)
    jb, _ = J.models.builders.cornell_box()
    jscene = J.compile_scene(jb, dtype=np.float64)
    tscene = T.compile_scene(b, dtype=torch.float64, device="cpu")
    ref, ref_stats = J.render(jscene, J.Camera.create(s), seed=2,
                              dtype=np.float64)
    img, stats = T.render(tscene, T.Camera.create(s), seed=2,
                          dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(img, np.asarray(ref), rtol=1e-12, atol=1e-14)
    assert stats.rays == ref_stats.rays


def test_trace_occupancy_and_remat():
    """with_occupancy counts the live rays entering each bounce (the
    first is every ray); remat recomputes bounces without changing a value
    or a gradient."""
    _, _, scene, cam = both("cornell_box", **SMALL)
    c = cam.constants(torch.float32, device="cpu")
    pid = torch.arange(256, dtype=torch.int32)
    o, d, t = get_rays(c, 5, pid, 0)
    leaves = {"tex_rgb": scene.tex_rgb.clone().requires_grad_(True)}
    live = scene.replace(**leaves)
    out = {}
    for remat in (False, True):
        rad, nb, occ = integrator.trace(live, o, d, t, (5, pid, 0), 4,
                                        remat=remat, with_occupancy=True)
        (g,) = torch.autograd.grad(rad.sum(), leaves["tex_rgb"])
        out[remat] = (rad, nb, occ, g)
    rad, nb, occ, g = out[False]
    assert occ[0] == 256 and (occ[1:] <= occ[:-1]).all()
    assert int(occ.sum()) == int(nb.sum())
    for a, b in zip(out[False], out[True]):
        assert torch.equal(a, b)


def test_auto_chunk_matches_jax():
    for name in ("cornell_box", "cornell_smoke", "two_spheres"):
        jscene, _, tscene, _ = both(name, **SMALL)
        assert trenderer._auto_chunk(tscene) == jrenderer._auto_chunk(jscene)
