"""The port's BVH pieces on the CPU: the kernel BVH and its packed tables
against the JAX package's, the plain search (the plain version of the
kernels' brute loop and BVH walk) against the sequential primitive loop it
replaced, and the tensor integrator's BVH closest hit against the
reference's.

Tolerances and their reasons. Trees, tables and records are exact. The
vectorised search does each primitive's test with the loop's f32 operations
in the loop's order, so t, normal, material and record are equal bit for
bit. closest_hit_bvh: winners equal, t within 4 ulp (XLA fuses the
reference's recompute, as for intersect.closest_hit in
test_torch_intersect.py)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rust_tracing_tpu as J
import rust_tracing_tpu_torch as T
from rust_tracing_tpu.models import builders as jbuilders
from rust_tracing_tpu.ops import bvh_traverse as jbt
from rust_tracing_tpu.ops import hashrng as jrng
from rust_tracing_tpu.ops import megakernel as jmk
from rust_tracing_tpu_torch.config import QUAD_DENOM_EPS, T_MIN
from rust_tracing_tpu_torch.models import builders as tbuilders
from rust_tracing_tpu_torch.ops import bvh_traverse as tbt
from rust_tracing_tpu_torch.ops import hashrng as trng
from rust_tracing_tpu_torch.ops import megakernel as tmk
from torch_port_helpers import bvh_builder


@pytest.mark.parametrize("name", ["random_balls", "final_scene"])
def test_kernel_bvh_and_tables_match_jax(name):
    jb, _ = getattr(jbuilders, name)()
    tb, _ = getattr(tbuilders, name)()
    jscene = J.compile_scene(jb)
    tscene = T.compile_scene(tb, device="cpu")
    jt = jmk.build_kernel_bvh(jscene)
    tt = tmk.build_kernel_bvh(tscene)
    for f in ("node_min", "node_max", "skip", "leaf_start", "leaf_count",
              "leaf_scount", "prim_stream"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f),
                                      err_msg=f)
    jp = jmk.pack_scene(jscene, jt)
    packed, tables = tmk._packed_dev(tscene, True)
    for f in ("bvh_f", "bvh_i", "prim_i"):
        np.testing.assert_array_equal(getattr(packed, f), getattr(jp, f),
                                      err_msg=f)
    assert packed.use_bvh and packed.n_nodes == jp.bvh_i.shape[0]
    assert packed.prim_i.shape[0] == tmk.n_prims(tscene)
    # the device table: two 16-byte rows a node
    assert tuple(tables["bvh_f"].shape) == (packed.n_nodes, 8)
    if name == "final_scene":
        assert (packed.n_nodes, packed.prim_i.shape[0]) == (511, 3407)


def _closest_surface_loop(tables, p, ox, oy, oz, dx, dy, dz, rtime, alive):
    """The sequential plain search the vectorised one replaced (one masked
    update a primitive, in the kernel's brute order): its oracle."""
    izero = torch.zeros(ox.shape, dtype=torch.int64)
    fzero = torch.zeros_like(ox)
    a_len = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / torch.clamp(a_len, min=1e-30)
    t_best = torch.where(alive, float("inf"), T_MIN).to(torch.float32)
    w_mat, w_nx, w_ny, w_nz, w_rec = izero, fzero, fzero, fzero + 1.0, izero
    sph = tables["sph_f"].numpy()
    quad = tables["quad_f"].numpy()
    for i in range(p.n_spheres):
        s = [float(x) for x in sph[i]]
        m = int(tables["sph_m"][i])
        ccx = s[0] + s[5] * rtime
        ccy = s[1] + s[6] * rtime
        ccz = s[2] + s[7] * rtime
        ocx, ocy, ocz = ox - ccx, oy - ccy, oz - ccz
        half_b = ocx * dx + ocy * dy + ocz * dz
        c = ocx * ocx + ocy * ocy + ocz * ocz - s[3]
        disc = half_b * half_b - a_len * c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        r1 = (-half_b - sq) * inv_a
        rr2 = (-half_b + sq) * inv_a
        ok1 = (r1 > T_MIN) & (r1 < t_best)
        ok2 = (rr2 > T_MIN) & (rr2 < t_best)
        root = torch.where(ok1, r1, rr2)
        hit = (disc > 0.0) & (ok1 | ok2)
        t_best = torch.where(hit, root, t_best)
        w_mat = torch.where(hit, m, w_mat)
        w_nx = torch.where(hit, (ox + root * dx - ccx) * s[4], w_nx)
        w_ny = torch.where(hit, (oy + root * dy - ccy) * s[4], w_ny)
        w_nz = torch.where(hit, (oz + root * dz - ccz) * s[4], w_nz)
        w_rec = torch.where(hit, (1 << 24) | i, w_rec)
    for i in range(p.n_quads):
        q = [float(x) for x in quad[i]]
        m = int(tables["quad_m"][i])
        nx, ny, nz = q[9], q[10], q[11]
        denom = nx * dx + ny * dy + nz * dz
        safe = torch.where(denom.abs() < 1e-30, 1e-30, denom)
        t = (q[15] - (nx * ox + ny * oy + nz * oz)) / safe
        hx = ox + t * dx - q[0]
        hy = oy + t * dy - q[1]
        hz = oz + t * dz - q[2]
        alpha = (q[12] * (hy * q[8] - hz * q[7])
                 + q[13] * (hz * q[6] - hx * q[8])
                 + q[14] * (hx * q[7] - hy * q[6]))
        beta = (q[12] * (q[4] * hz - q[5] * hy)
                + q[13] * (q[5] * hx - q[3] * hz)
                + q[14] * (q[3] * hy - q[4] * hx))
        hit = ((denom.abs() >= QUAD_DENOM_EPS) & (t >= T_MIN) & (t < t_best)
               & (alpha >= 0.0) & (alpha <= 1.0)
               & (beta >= 0.0) & (beta <= 1.0))
        t_best = torch.where(hit, t, t_best)
        w_mat = torch.where(hit, m, w_mat)
        w_nx = torch.where(hit, nx, w_nx)
        w_ny = torch.where(hit, ny, w_ny)
        w_nz = torch.where(hit, nz, w_nz)
        w_rec = torch.where(hit, (2 << 24) | i, w_rec)
    return t_best, w_mat, w_nx, w_ny, w_nz, w_rec, a_len, inv_a


def test_vectorised_search_equals_sequential_loop(monkeypatch):
    """random_balls (488 spheres) plus six quads of a cube, on camera rays
    and on scattered rays from inside the scene, a few lanes dead; lane
    chunks smaller than the batch."""
    b, s = tbuilders.random_balls()
    b.add_cube((-1.0, 0.0, -1.0), (1.0, 2.0, 1.0), b.lambertian((0.5,) * 3))
    scene = T.compile_scene(b, device="cpu")
    cam = T.Camera.create(s.__class__(**{**s.__dict__, "image_width": 24}))
    packed, tables = tmk._packed_dev(scene)
    p = tmk.search_params(packed, 0)
    c = cam.constants(device="cpu")
    n = cam.image_width * cam.image_height
    o, d, t = T.get_rays(c, 1, torch.arange(n, dtype=torch.int32), 0)
    rng = np.random.default_rng(4)
    ro = torch.from_numpy(rng.uniform(-8, 8, (n, 3)).astype(np.float32))
    ro[:, 1] = torch.from_numpy(rng.uniform(0.1, 2.0, n).astype(np.float32))
    rd = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    alive = torch.from_numpy(rng.random(n) > 0.05)
    monkeypatch.setattr(tmk, "SEARCH_CHUNK", 100 * (p.n_spheres + p.n_quads))
    for org, dirs in ((o, d), (ro, rd)):
        lanes = [org[:, 0], org[:, 1], org[:, 2], dirs[:, 0], dirs[:, 1],
                 dirs[:, 2], t, alive]
        got = tmk._closest_surface(tables, p, *lanes)
        ref = _closest_surface_loop(tables, p, *lanes)
        for name, a, b_ in zip(("t", "mat", "nx", "ny", "nz", "rec", "a",
                                "inv_a"), got, ref):
            assert a.dtype == b_.dtype, name
            assert torch.equal(a, b_), name
        hits = torch.isfinite(got[0]) & alive
        assert 0 < int(hits.sum()) < n
        assert int(((got[5] >> 24) == 2).sum()) > 0  # quads win somewhere


def test_closest_hit_bvh_matches_jax():
    """The tensor integrator's BVH search (scene compiled with a BVH)
    against the reference's, on random rays into and out of the mixed
    scene: winners equal, t within 4 ulp."""
    jb, js = bvh_builder(J)
    tb, ts = bvh_builder(T)
    jscene = J.compile_scene(jb, use_bvh=True)
    tscene = T.compile_scene(tb, use_bvh=True, device="cpu")
    np.testing.assert_array_equal(tscene.bvh_skip.numpy(),
                                  np.asarray(jscene.bvh_skip))
    rng = np.random.default_rng(2)
    n = 256
    org = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    org[:, 2] += 1.0
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs[: n // 2, 2] = -np.abs(dirs[: n // 2, 2]) - 1.0  # toward the scene
    tim = rng.random(n).astype(np.float32)
    pix = np.arange(n, dtype=np.int32)
    jh = jax.jit(lambda sc, o, d, t_: jbt.closest_hit_bvh(
        sc, o, d, t_, jrng.CounterRng(jnp.uint32(3), jnp.asarray(pix), 0,
                                      1)))(jscene, jnp.asarray(org),
                                           jnp.asarray(dirs),
                                           jnp.asarray(tim))
    th = tbt.closest_hit_bvh(tscene, torch.from_numpy(org),
                             torch.from_numpy(dirs), torch.from_numpy(tim),
                             trng.CounterRng(3, torch.from_numpy(pix), 0, 1))
    for f in ("hit", "mat_id", "is_surface", "front_face"):
        np.testing.assert_array_equal(getattr(th, f).numpy(),
                                      np.asarray(getattr(jh, f)), err_msg=f)
    hit = th.hit.numpy()
    assert 0.2 < hit.mean() < 1.0
    jt = np.asarray(jh.t)[hit]
    np.testing.assert_allclose(th.t.numpy()[hit], jt, rtol=0,
                               atol=4 * np.spacing(np.abs(jt)).max())
    assert not math.isnan(float(th.t.sum()))

    # the card's walk (its plain version: the wide tree, near child first)
    # on the same rays: where the reference's winner is a surface, the same
    # material at the same t (4 ulp); where it misses, a miss. Rays whose
    # reference winner is a medium event in front are not compared.
    packed, tables = tmk._packed_dev(tscene, True)
    rec, t_w, _ = tmk.walk_wide_plain(
        {k: tables[k] for k in ("wbvh", "wsph_f", "wsph_i", "wquad_f",
                                "wquad_i")},
        *org.T, *dirs.T, tim)
    kind, idx = rec >> 24, rec & 0xFFFFFF
    mat = np.where(kind == 1, packed.sph_m[np.where(kind == 1, idx, 0)],
                   packed.quad_m[np.where(kind == 2, idx, 0)])
    surf = np.asarray(jh.hit) & np.asarray(jh.is_surface)
    miss = ~np.asarray(jh.hit)
    assert surf.sum() > n // 4 and miss.sum() > 0
    np.testing.assert_array_equal(kind[miss], 0)
    assert (kind[surf] > 0).all()
    np.testing.assert_array_equal(mat[surf], np.asarray(jh.mat_id)[surf])
    js = np.asarray(jh.t)[surf]
    np.testing.assert_allclose(t_w[surf], js, rtol=0,
                               atol=4 * np.spacing(np.abs(js)).max())


def test_closest_hit_bvh_keeps_thin_quads():
    """cornell_box's walls are quads whose padded boxes are thinner than one
    f32 step of t at the camera's distance: the port's closed slab test
    finds every hit of the brute search, where the reference's strict test
    drops some (ROADMAP Queue C)."""
    import dataclasses

    from rust_tracing_tpu_torch.ops import intersect as tint

    jb, js = jbuilders.cornell_box()
    tb, ts = tbuilders.cornell_box()
    js = dataclasses.replace(js, image_width=24)
    ts = dataclasses.replace(ts, image_width=24)
    n = 24 * 24
    tscene = T.compile_scene(tb, use_bvh=True, device="cpu")
    pid = torch.arange(n, dtype=torch.int32)
    o, d, t = T.get_rays(T.Camera.create(ts).constants(device="cpu"), 0, pid,
                         0)
    rng = trng.CounterRng(0, pid, 0, 0)
    brute = tint.closest_hit(T.compile_scene(tb, device="cpu"), o, d, t, rng)
    walk = tbt.closest_hit_bvh(tscene, o, d, t, rng)
    assert torch.equal(walk.hit, brute.hit)
    assert torch.equal(walk.mat_id, brute.mat_id)
    assert torch.equal(walk.t, brute.t)

    jscene = J.compile_scene(jb, use_bvh=True)
    jpid = jnp.arange(n, dtype=jnp.int32)
    jo, jd, jt = J.get_rays(J.Camera.create(js).constants(jnp.float32),
                            jnp.uint32(0), jpid, 0)
    jh = jax.jit(lambda sc, o_, d_, t_: jbt.closest_hit_bvh(
        sc, o_, d_, t_, jrng.CounterRng(jnp.uint32(0), jpid, 0, 0)))(
            jscene, jo, jd, jt)
    assert int(brute.hit.sum()) == 522
    assert int(np.asarray(jh.hit).sum()) == 406  # the reference's shortfall
