"""The sorted deferred wavefront of the port (ops/wavefront.py) and its hit
search (ops/megakernel.hit_records, the plain version of kernel B3) on the
CPU, against the JAX package: the hit kernel's records in Pallas interpret
mode, and the direct estimator the wavefront must reproduce.

Tolerances and their reasons. Records are integers: equal. The wavefront
only permutes lanes and cuts dead ones; every lane's radiance is the same
per-path arithmetic as the direct estimator's and rejoins the same
sequential sample sum, so the images are equal as f32, with equal ray
counts (the reference's own contract, tests/test_wavefront.py). Banked mode
sums dropped lanes per pixel in another order: rtol 3e-6, atol 3e-7 (the
reference's bound).

Where a path is deep (the mixed scene at depth 8), XLA's JIT on the CPU
changes the reference's own arithmetic (it fuses and contracts), and one
pixel in a few hundred takes another path. Such cases are held bit for bit
against the port's direct estimator (itself held against JAX by
test_torch_integrator.py), and against jitted JAX with
torch_port_helpers.assert_images_agree. final_scene is held bit for bit
against the reference run op by op (``jax.disable_jit``), which costs about
16 s, most of it compiling each primitive op once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rust_tracing_tpu as J
import rust_tracing_tpu_torch as T
from rust_tracing_tpu import grad as jgrad
from rust_tracing_tpu.ops import megakernel as jmk
from rust_tracing_tpu_torch import grad as tg
from rust_tracing_tpu_torch import renderer
from rust_tracing_tpu_torch.models import builders as tbuilders
from rust_tracing_tpu_torch.ops import megakernel as tmk
from rust_tracing_tpu_torch.ops import wavefront
from torch_port_helpers import assert_images_agree, bvh_builder

SEED = 3


@pytest.fixture(scope="module")
def mixed():
    jb, js = bvh_builder(J)
    tb, ts = bvh_builder(T)
    return (J.compile_scene(jb), J.Camera.create(js),
            T.compile_scene(tb, device="cpu"), T.Camera.create(ts))


_direct_cache = {}


def _jax_direct(jscene, jcam, spp, depth, sample_chunk=None, seed=SEED,
                jit=True):
    """The reference's direct estimator (mean (C,3) f32, rays), once per
    argument set in this module; ``jit=False`` runs it op by op."""
    key = (id(jscene), spp, depth, sample_chunk, seed, jit)
    if key not in _direct_cache:
        n = jcam.image_width * jcam.image_height
        with jax.disable_jit(not jit):
            m, r = jgrad.radiance_mean_rays(
                jscene, jcam.constants(jnp.float32),
                jnp.arange(n, dtype=jnp.int32), jnp.uint32(seed), spp, depth,
                sample_chunk=sample_chunk)
            _direct_cache[key] = (np.asarray(m, np.float32), int(float(r)))
    return _direct_cache[key]


def _assert_bitwise(img, ref, ref_rays, rays):
    np.testing.assert_array_equal(
        np.asarray(img, np.float32).reshape(-1, 3), ref)
    assert rays == ref_rays


def _port_direct(tscene, tcam, spp, depth, seed=SEED):
    """The port's direct estimator (tensor integrator), (C,3) f32 and rays."""
    n = tcam.image_width * tcam.image_height
    m, r = tg.radiance_mean_rays(tscene, tcam.constants(device="cpu"),
                                 torch.arange(n, dtype=torch.int32), seed,
                                 spp, depth, sample_chunk=spp)
    return m.numpy(), int(r)


# ------------------------------------------------------------ hit records
@pytest.fixture(scope="module")
def tile(mixed):
    """One 1024-lane tile of the mixed scene: the camera rays of sample 0
    (24x24 pixels, then sample 1 of the first 448), every 9th lane dead;
    and the same lanes after one bounce of the port's wavefront."""
    _, _, tscene, tcam = mixed
    cam = tcam.constants(device="cpu")
    n_pix = tcam.image_width * tcam.image_height
    lanes = wavefront.initial_lanes(cam, SEED, n_pix, 0, 2)
    lanes = wavefront.Lanes(*[a[:1024] for a in lanes])
    alive = lanes.alive.clone()
    alive[::9] = False
    lanes = lanes._replace(alive=alive)
    after = wavefront.step(tscene, lanes, SEED, 0, n_pix, 0)
    return n_pix, {0: lanes, 1: after}


def _records(tscene, lanes, n_pix, bounce, use_bvh):
    pix, samp = wavefront.lane_ids(lanes, n_pix, 0)
    return tmk.hit_records(tscene, SEED, *lanes[1:8], pix, samp, lanes.alive,
                           bounce, use_bvh=use_bvh)


@pytest.mark.parametrize("use_bvh", [False, True], ids=["brute", "bvh"])
def test_hit_records_match_pallas_interpret(mixed, tile, use_bvh):
    """Plain hit records == the Pallas hit kernel's (interpret mode) on one
    tile at bounces 0 and 1, medium winners included; a permutation of the
    lanes permutes the records and changes nothing else."""
    jscene, jcam, tscene, _ = mixed
    n_pix, by_bounce = tile
    fn, dev_args = jmk.hit_kernel_call(jscene, jcam, 8, use_bvh=use_bvh,
                                       interpret=True)
    fn = jax.jit(fn)
    kinds = set()
    for bounce, lanes in by_bounce.items():
        got = _records(tscene, lanes, n_pix, bounce, use_bvh)
        pix, samp = wavefront.lane_ids(lanes, n_pix, 0)
        blk = lambda a: jnp.asarray(a.numpy().reshape(8, 128))
        ref = fn(*dev_args, jnp.asarray([SEED, bounce, 0], jnp.int32),
                 *[blk(a) for a in lanes[1:8]], blk(pix), blk(samp),
                 blk(lanes.alive.float()))[0]
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(ref).reshape(-1))
        kinds |= set((got >> 24).tolist())
        perm = torch.from_numpy(np.random.default_rng(bounce).permutation(
            lanes.orig.shape[0]))
        shuffled = wavefront.Lanes(*[a[perm] for a in lanes])
        assert torch.equal(_records(tscene, shuffled, n_pix, bounce, use_bvh),
                           got[perm])
    assert {0, 1, 2, 3} <= kinds  # misses, spheres, quads, the medium


# ------------------------------------------- mirrors of tests/test_wavefront
@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
def test_wavefront_bitwise_equals_direct(mixed, sort):
    jscene, jcam, tscene, tcam = mixed
    ref, ref_rays = _jax_direct(jscene, jcam, 4, 4, sample_chunk=4)
    img, st = wavefront.render_sorted(tscene, tcam, seed=SEED, sort=sort,
                                      use_bvh=True)
    _assert_bitwise(img, ref, ref_rays, st.rays)


def test_wavefront_exact_compaction_bitwise(mixed, monkeypatch):
    """exact=True with compaction forced at every segment: the cut lanes
    keep their radiance and rejoin the one original-order sum (depth 8:
    against the port's direct estimator bit for bit, see the module
    docstring)."""
    jscene, jcam, tscene, tcam = mixed
    monkeypatch.setattr(wavefront, "COMPACT_BELOW", 1.01)
    monkeypatch.setattr(wavefront, "SEG_BOUNCES", 2)
    ref, ref_rays = _jax_direct(jscene, jcam, 4, 8, sample_chunk=4)
    events = []
    monkeypatch.setattr(wavefront.metrics, "emit",
                        lambda ev, **kw: events.append(kw))
    img, st = wavefront.render_sorted(tscene, tcam, seed=SEED, max_depth=8,
                                      use_bvh=True, exact=True)
    assert events[-1]["compactions"] >= 3
    _assert_bitwise(img, *_port_direct(tscene, tcam, 4, 8), st.rays)
    assert_images_agree(img.reshape(-1, 3), ref, st.rays, ref_rays)


def test_wavefront_banked_matches(mixed, monkeypatch):
    """exact=False: lanes cut by compaction are summed per pixel as they
    leave; the same per-path values in another association."""
    jscene, jcam, tscene, tcam = mixed
    monkeypatch.setattr(wavefront, "COMPACT_BELOW", 1.01)
    ref, ref_rays = _jax_direct(jscene, jcam, 4, 4, sample_chunk=4)
    img, st = wavefront.render_sorted(tscene, tcam, seed=SEED, use_bvh=True,
                                      exact=False)
    np.testing.assert_allclose(np.asarray(img).reshape(-1, 3), ref,
                               rtol=3e-6, atol=3e-7)
    assert st.rays == ref_rays


def test_wavefront_spp_chunking_and_depth_exit(monkeypatch):
    """Two sample chunks, and the early exit when every lane dies before
    the depth budget (a black background ends every miss)."""
    def build(M):
        b = M.SceneBuilder(background=(0.0, 0.0, 0.0))
        b.add_quad((-1, -1, 2), (2, 0, 0), (0, 2, 0),
                   b.diffuse_light((3, 2, 1)))
        return b, M.RenderSettings(
            image_width=16, aspect_ratio=1.0, samples_per_pixel=4,
            max_depth=8, vfov=60.0, look_from=(0, 0, 0), look_at=(0, 0, 2))

    jb, js = build(J)
    tb, ts = build(T)
    monkeypatch.setattr(wavefront, "WAVEFRONT_LANE_BUDGET", 16 * 16 * 2)
    events = []
    monkeypatch.setattr(wavefront.metrics, "emit",
                        lambda ev, **kw: events.append(kw))
    img, st = wavefront.render_sorted(T.compile_scene(tb, device="cpu"),
                                      T.Camera.create(ts), seed=1,
                                      use_bvh=True)
    assert events[-1]["chunks"] == 2
    ref, ref_rays = _jax_direct(J.compile_scene(jb), J.Camera.create(js), 4,
                                8, sample_chunk=2, seed=1)
    _assert_bitwise(img, ref, ref_rays, st.rays)


# ------------------------------------------------------------ final_scene
def test_final_scene_auto_policy_equals_jax_direct():
    """final_scene (3407 primitives) through render()'s auto policy takes
    the sorted wavefront, and equals the direct estimator bit for bit as
    f32 with equal rays: the port's, and the reference's run op by op (see
    the module docstring)."""
    import dataclasses

    from rust_tracing_tpu.models import builders as jbuilders

    over = dict(image_width=8, samples_per_pixel=1, max_depth=4)
    jb, js = jbuilders.final_scene()
    tb, ts = tbuilders.final_scene()
    tscene = T.compile_scene(tb, device="cpu")
    assert renderer.use_wavefront_default(tscene)
    tcam = T.Camera.create(dataclasses.replace(ts, **over))
    img, st = T.render(tscene, tcam, seed=SEED, device="cpu")
    _assert_bitwise(img, *_port_direct(tscene, tcam, 1, 4), st.rays)
    ref, ref_rays = _jax_direct(
        J.compile_scene(jb), J.Camera.create(dataclasses.replace(js, **over)),
        1, 4, sample_chunk=1, jit=False)
    _assert_bitwise(img, ref, ref_rays, st.rays)
