"""The fused render of the port (its plain PyTorch version, which is what a
CPU tensor runs) against the JAX package on the CPU: the Pallas kernel in
interpret mode and the XLA wavefront path, which the JAX tests assert bitwise
equal to that kernel."""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

import rust_tracing_tpu as J
import rust_tracing_tpu_torch as T
from rust_tracing_tpu.ops import megakernel as jmk
from rust_tracing_tpu_torch.models import builders as tbuilders
from rust_tracing_tpu_torch.ops import megakernel as tmk
from torch_port_helpers import assert_images_agree, both, carry_scene


def test_background_exact():
    b = T.SceneBuilder(background=(0.2, 0.4, 0.8))
    scene = T.compile_scene(b, device="cpu")
    cam = T.Camera.create(T.RenderSettings(
        image_width=32, aspect_ratio=2.0, samples_per_pixel=2, max_depth=3,
        background=(0.2, 0.4, 0.8)))
    img, rays = tmk.render_fast(scene, cam, with_stats=True)
    assert img.shape == (16, 32, 3) and img.dtype == np.float32
    np.testing.assert_allclose(
        img, np.broadcast_to([0.2, 0.4, 0.8], img.shape), rtol=1e-6)
    assert rays == 16 * 32 * 2  # every sample misses at its first query


def test_emitter_exact():
    b = T.SceneBuilder(background=(0, 0, 0))
    b.add_quad((-1, -1, 2), (2, 0, 0), (0, 2, 0), b.diffuse_light((3, 2, 1)))
    scene = T.compile_scene(b, device="cpu")
    cam = T.Camera.create(T.RenderSettings(
        image_width=32, aspect_ratio=1.0, samples_per_pixel=2, max_depth=2,
        vfov=60.0, look_from=(0, 0, 0), look_at=(0, 0, 2)))
    img = tmk.render_fast(scene, cam)
    np.testing.assert_allclose(img[16, 16], [3, 2, 1], rtol=1e-6)
    np.testing.assert_allclose(img[0, 0], 0, atol=1e-7)


def test_plain_matches_pallas_interpret_one_tile():
    """32x32 = one tile of the Pallas kernel, run in interpret mode as the
    JAX package's own tests run it; a negative i32 seed on both sides."""
    jscene, jcam, tscene, tcam = both("cornell_box", image_width=32,
                                      samples_per_pixel=2, max_depth=3)
    ref, ref_rays = jmk.render_fast(jscene, jcam, seed=-7, interpret=True,
                                    with_stats=True)
    img, rays = tmk.render_fast(tscene, tcam, seed=-7, with_stats=True)
    assert_images_agree(img, ref, rays, ref_rays)


@pytest.mark.parametrize("name,kw", [
    ("cornell_box", dict(image_width=24, samples_per_pixel=4, max_depth=4)),
    ("cornell_smoke", dict(image_width=24, samples_per_pixel=4, max_depth=4)),
    ("two_spheres", dict(image_width=32, samples_per_pixel=4, max_depth=4)),
    ("mixed", {}),
])
def test_plain_matches_xla_path(name, kw):
    jscene, jcam, tscene, tcam = both(name, **kw)
    ref, ref_stats = J.render(jscene, jcam, seed=3, use_megakernel=False)
    img, rays = tmk.render_fast(tscene, tcam, seed=3, with_stats=True)
    assert_images_agree(img, np.asarray(ref), rays, ref_stats.rays)


def test_carried_scene_renders_like_compiled_scene():
    """A scene whose leaves crossed as numpy arrays renders bit for bit like
    the one the port compiled itself."""
    jscene, _, tscene, tcam = both("mixed")
    a = tmk.render_fast(tscene, tcam, seed=1)
    b = tmk.render_fast(carry_scene(jscene), tcam, seed=1)
    np.testing.assert_array_equal(a, b)


def _cornell(width=16, spp=4, depth=3):
    b, s = tbuilders.cornell_smoke()
    s = dataclasses.replace(s, image_width=width, samples_per_pixel=spp,
                            max_depth=depth)
    return T.compile_scene(b, device="cpu"), T.Camera.create(s)


def test_pixel_range_split_exact():
    """The RNG is addressed by pixel id, never by launch geometry: any split
    of the frame into pixel ranges gives the same numbers."""
    scene, cam = _cornell()
    rgb, n = tmk.render_pixels(scene, cam, seed=5)
    assert rgb.shape == (256, 3) and n.shape == (256,)
    assert n.dtype == torch.int32
    parts = [tmk.render_pixels(scene, cam, seed=5, pixel_base=b0,
                               pixel_count=c)
             for b0, c in ((0, 7), (7, 100), (107, 149))]
    assert torch.equal(torch.cat([p[0] for p in parts]), rgb)
    assert torch.equal(torch.cat([p[1] for p in parts]), n)


def test_sample_offset_split_exact():
    """Samples are addressed globally: the f32 sum, in sample order, of
    one-sample renders at growing offsets IS the offline accumulator."""
    scene, cam = _cornell()
    rgb, n = tmk.render_pixels(scene, cam, seed=5, spp=4)
    acc = torch.zeros_like(rgb)
    n_sum = torch.zeros_like(n)
    for k in range(4):
        r1, n1 = tmk.render_pixels(scene, cam, seed=5, spp=1, sample_offset=k)
        acc = acc + r1
        n_sum = n_sum + n1
    assert torch.equal(acc * (1.0 / 4), rgb)
    assert torch.equal(n_sum, n)


def test_depth_budget_counts_rays():
    """max_depth=1: exactly one scene query a sample, no scatter."""
    scene, cam = _cornell(spp=3, depth=1)
    _, n = tmk.render_pixels(scene, cam, max_depth=1)
    assert (n == 3).all()


def test_render_kernel_refuses_cpu_tensors():
    """The kernel wrapper launches or raises; it never computes on the CPU."""
    scene, cam = _cornell()
    packed, tables = tmk._packed_dev(scene)
    p = tmk.make_params(cam, packed, 0, 1, 2)
    before = dict(tmk.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        tmk.render_kernel(tables, p)
    assert tmk.LAUNCHES == before


def test_params_mirror_kernel_struct_and_validate():
    scene, cam = _cornell()
    packed, tables = tmk._packed_dev(scene)
    assert tmk._packed_dev(scene)[1] is tables  # cached per scene
    p = tmk.make_params(cam, packed, -3, 2, 5, sample_offset=9, pixel_base=4,
                        pixel_count=10)
    assert ctypes.sizeof(p) == 39 * 4  # 21 floats + 18 ints, no padding
    assert (p.has_noise, p.has_image, p.img_h, p.img_w) == (0, 0, 1, 1)
    assert (p.use_bvh, p.n_nodes) == (0, 1)
    assert (p.seed, p.spp, p.max_depth, p.sample_offset) == (-3, 2, 5, 9)
    assert (p.n_spheres, p.n_quads, p.n_media) == (0, 6, 2)
    assert tmk.make_params(cam, packed, 0xFFFFFFFD, 1, 1).seed == -3
    with pytest.raises(ValueError, match="pixel range"):
        tmk.make_params(cam, packed, 0, 1, 1, pixel_base=250, pixel_count=10)
    bad = dict(tables, quad_f=tables["quad_f"].double())
    with pytest.raises(TypeError, match="quad_f"):
        tmk.render_fast_plain(bad, p)


@pytest.mark.parametrize("name", ["two_perlin_spheres", "earth"])
def test_noise_and_image_families_render(name):
    """The fused render's own noise and image families (hash-lattice
    turbulence, the image mip at a polynomial sphere UV) render finite
    pixels, and every ray is counted."""
    b, s = getattr(tbuilders, name)()
    cam = T.Camera.create(dataclasses.replace(s, image_width=8,
                                              samples_per_pixel=1))
    scene = T.compile_scene(b, device="cpu")
    packed, _ = tmk._packed_dev(scene)
    assert packed.has_noise == (name == "two_perlin_spheres")
    assert packed.has_image == (name == "earth")
    img, rays = tmk.render_fast(scene, cam, with_stats=True)
    assert img.shape == (4, 8, 3) and np.isfinite(img).all()
    assert img.mean() > 0.05 and rays >= 32


def test_bvh_sized_scene_renders():
    """A scene at BVH_KERNEL_THRESHOLD primitives renders with the tree by
    default, and cornell with a forced tree: both equal the brute render
    (the plain search does not depend on the tree; the tree is packed)."""
    b = T.SceneBuilder(background=(0.5, 0.5, 0.5))
    mat = b.lambertian((0.5, 0.5, 0.5))
    for i in range(tmk.BVH_KERNEL_THRESHOLD):
        b.add_sphere((i % 32 - 16, i // 32 - 16, -40.0), 0.4, mat)
    cam = T.Camera.create(T.RenderSettings(image_width=8, samples_per_pixel=1,
                                           max_depth=3))
    for scene, forced in ((T.compile_scene(b, device="cpu"), None),
                          (_cornell()[0], True)):
        img, rays = tmk.render_fast(scene, cam, use_bvh=forced,
                                    with_stats=True)
        packed, _ = tmk._packed_dev(scene, True)
        assert packed.use_bvh
        assert packed.prim_i.shape[0] == tmk.n_prims(scene)
        ref, ref_rays = tmk.render_fast(scene, cam, use_bvh=False,
                                        with_stats=True)
        np.testing.assert_array_equal(img, ref)
        assert rays == ref_rays and np.isfinite(img).all()


def test_render_groups_cover_each_sample_once():
    """The render kernel's threads a pixel from spp: a power of two up to a
    warp whose rounds of one sample a lane cover the pixel's spp samples
    with at most an eighth of them idle in the last round, the widest such
    (one thread a pixel when none is). The kernel's mapping of lanes and
    rounds to samples is held bit for bit against the plain version on the
    card at every width this picks (chip_smoke.py's B1 compares)."""
    spps = (1, 2, 3, 16, 23, 32, 4096)
    groups = [tmk.samples_per_group(s) for s in spps]
    assert groups == [1, 2, 1, 16, 8, 32, 32]
    for spp, g in zip(spps, groups):
        idle = -(-spp // g) * g - spp
        assert g == 1 or idle <= spp / 8
        wider = min(2 * g, tmk.RENDER_MAX_GROUP)
        assert wider == g or -(-spp // wider) * wider - spp > spp / 8


def test_table_staging_choice_by_bytes():
    """The brute-loop kernel stages its tables in shared memory when their
    16-byte aligned rows fit STAGE_BUDGET_BYTES; a larger scene and a BVH
    launch read them from global memory."""
    b, s = tbuilders.cornell_box()
    cam = T.Camera.create(dataclasses.replace(s, image_width=8))
    cornell = T.compile_scene(b, device="cpu")
    packed, tables = tmk._packed_dev(cornell)
    p = tmk.make_params(cam, packed, 0, 4096, 8)
    # 18 quads x 64 B, their 18 material ids (72 -> 80 B), 4 materials
    # (80 + 32 B) and 4 textures (64 + 48 B)
    assert tmk.stage_bytes(tables, p) == 1152 + 80 + 80 + 32 + 64 + 48
    plan = tmk.render_plan(tables, p)
    assert (plan.group, plan.stage_bytes, plan.mat_rows, plan.tex_rows) == \
        (32, 1456, 4, 4)
    packed, tables = tmk._packed_dev(cornell, True)
    p = tmk.make_params(cam, packed, 0, 1, 8)
    assert tmk.render_plan(tables, p).stage_bytes == 0
    assert tmk.render_plan(tables, p).group == 1
    b, s = tbuilders.random_balls()
    balls = T.compile_scene(b, device="cpu")
    packed, tables = tmk._packed_dev(balls)
    p = tmk.make_params(cam, packed, 0, 23, 8)
    assert tmk.stage_bytes(tables, p) > tmk.STAGE_BUDGET_BYTES
    assert tmk.render_plan(tables, p).stage_bytes == 0


@pytest.mark.parametrize("base,count,spp", [(0, 4096, 1), (1000, 1537, 23),
                                            (17, 31, 3)])
def test_record_plan_covers_each_pixel_sample_once(base, count, spp):
    """The recorder's launch (one thread a (pixel, sample), a warp 32
    consecutive pixels of one sample) over a pixel range of a 64x64 frame,
    whole or starting and ending mid-row: each (pixel, sample) of the range
    exactly once and nothing outside it, the warps' pixels consecutive. Its
    tables are staged by bytes as the render kernel's are: cornell's 1456 B,
    not random_balls' nor a BVH launch's. The records themselves are held
    bit for bit against the plain version on the card (chip_smoke.py)."""
    b, s = tbuilders.cornell_box()
    cam = T.Camera.create(dataclasses.replace(s, image_width=64))
    cornell = T.compile_scene(b, device="cpu")
    packed, tables = tmk._packed_dev(cornell)
    p = tmk.make_params(cam, packed, 0, spp, 8, 0, base, count)
    plan = tmk.record_plan(tables, p)
    local, sample, live = tmk.record_threads(plan, p)
    assert plan.blocks * tmk.RECORD_THREADS == local.size
    assert live.sum() == count * spp
    pairs = local[live] * spp + sample[live]
    np.testing.assert_array_equal(np.sort(pairs), np.arange(count * spp))
    warp_local = local.reshape(-1, 32)
    assert (np.diff(warp_local, axis=1) == 1).all()
    assert (sample.reshape(-1, 32) == sample.reshape(-1, 32)[:, :1]).all()
    rp = tmk.render_plan(tables, p)
    assert (plan.stage_bytes, plan.mat_rows, plan.tex_rows) == \
        (rp.stage_bytes, rp.mat_rows, rp.tex_rows) == (1456, 4, 4)
    packed, tables = tmk._packed_dev(cornell, True)
    p = tmk.make_params(cam, packed, 0, spp, 8, 0, base, count)
    assert tmk.record_plan(tables, p).stage_bytes == 0
    b, s = tbuilders.random_balls()
    packed, tables = tmk._packed_dev(T.compile_scene(b, device="cpu"))
    p = tmk.make_params(cam, packed, 0, spp, 8, 0, base, count)
    assert tmk.record_plan(tables, p).stage_bytes == 0
