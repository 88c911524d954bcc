"""The port's closest-hit search (ops/intersect.py) and material response
(ops/materials.py) on the CPU against the JAX package, on random rays and
random hits made with numpy.

Winners (which primitive, medium or miss; material id; front face) must be
equal. t, hit point and normal are recomputed from the winner with the same
f32 operations in the same order; they are held to 4 ulp (rtol 5e-7, and an
absolute 4 ulp of the largest magnitude of the quantity, since a hit point
on a wall at x = 0 of a 555-unit box inherits the rounding of 555) because
XLA fuses the jitted reference and may contract or reorder a multiply-add
that PyTorch keeps as written. A sphere's UV comes from its normal through
acos and atan2, which magnify the normal's rounding near the poles and the
seam: rtol 2e-5 there. Scatter directions and attenuations like the hit
point."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_tracing_tpu.ops import hashrng as jrng
from rust_tracing_tpu.ops import intersect as jix
from rust_tracing_tpu.ops import materials as jmat
from rust_tracing_tpu.ops import replay as jrep
from rust_tracing_tpu_torch.ops import hashrng as trng
from rust_tracing_tpu_torch.ops import intersect as tix
from rust_tracing_tpu_torch.ops import materials as tmat
from rust_tracing_tpu_torch.ops import replay as trep
from torch_port_helpers import both

RTOL = 5e-7
N_RAYS = 512


def _close(got, ref, err_msg="", rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    atol = 4 * np.spacing(np.float32(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol,
                               err_msg=err_msg)


def _jrng(seed, pid, sample, bounce):
    return jrng.CounterRng(jnp.uint32(seed), pid, sample, bounce)


# the JAX side runs jitted: one compile instead of an eager dispatch per op
_j_hit = jax.jit(lambda s, o, d, t, pid: jix.closest_hit(
    s, o, d, t, _jrng(4, pid, 2, 1)))
_j_rec = jax.jit(lambda s, o, d, t, pid: jrep.record_from_hitfn(
    s, o, d, t, _jrng(4, pid, 2, 1)))
_j_scatter = jax.jit(lambda s, pid, *a: jmat.scatter_and_emit_c(
    s, _jrng(9, pid, 0, 2), *a))


def _rays(name, seed):
    """Rays from random points inside the scene's box toward random
    directions, with random shutter times."""
    rng = np.random.default_rng(seed)
    if name == "cornell_smoke":
        o = rng.uniform(20.0, 530.0, (N_RAYS, 3))
    else:
        o = rng.uniform(-1.5, 1.5, (N_RAYS, 3)) + np.array([0, 0.3, -1.5])
    d = rng.standard_normal((N_RAYS, 3))
    t = rng.uniform(0.0, 1.0, N_RAYS)
    return o.astype(np.float32), d.astype(np.float32), t.astype(np.float32)


@pytest.fixture(scope="module", params=["cornell_smoke", "mixed"])
def case(request):
    name = request.param
    kw = {} if name == "mixed" else dict(image_width=16)
    jscene, _, tscene, _ = both(name, **kw)
    o, d, t = _rays(name, 11)
    pid = np.arange(N_RAYS, dtype=np.int32)
    tr = trng.CounterRng(4, torch.from_numpy(pid), 2, 1)
    jh = _j_hit(jscene, o, d, t, pid)
    th = tix.closest_hit(tscene, torch.from_numpy(o), torch.from_numpy(d),
                         torch.from_numpy(t), tr)
    return dict(jscene=jscene, tscene=tscene, o=o, d=d, t=t, pid=pid, tr=tr,
                jh=jh, th=th)


def test_closest_hit_winners_and_geometry(case):
    jh, th = case["jh"], case["th"]
    for f in ("hit", "mat_id", "front_face", "is_surface"):
        np.testing.assert_array_equal(getattr(th, f).numpy(),
                                      np.asarray(getattr(jh, f)), err_msg=f)
    assert th.hit.any() and (~th.hit).any()
    for f in ("t", "p", "normal"):
        _close(getattr(th, f).numpy(), getattr(jh, f), f)
    for f in ("u", "v"):
        _close(getattr(th, f).numpy(), getattr(jh, f), f, rtol=2e-5)


def test_records_of_random_rays_equal(case):
    """The packed winner record of every ray (kind<<24 | idx) is equal, and
    the component-form reconstruction from it gives the search's hit."""
    jrec = np.asarray(_j_rec(case["jscene"], case["o"], case["d"],
                             case["t"], case["pid"]))
    trec = trep.record_from_hitfn(
        case["tscene"], torch.from_numpy(case["o"]),
        torch.from_numpy(case["d"]), torch.from_numpy(case["t"]), case["tr"])
    np.testing.assert_array_equal(trec.numpy(), jrec)
    hr = trep.hit_from_record(case["tscene"], torch.from_numpy(case["o"]),
                              torch.from_numpy(case["d"]),
                              torch.from_numpy(case["t"]), case["tr"], trec)
    th = case["th"]
    np.testing.assert_array_equal(hr.hit.numpy(), th.hit.numpy())
    np.testing.assert_array_equal(hr.mat_id.numpy(), th.mat_id.numpy())
    live = th.hit.numpy()
    _close(hr.p.numpy()[live], th.p.numpy()[live])


def test_search_is_detached_and_recompute_differentiable(case):
    """Gradients reach the winner's parameters through the O(R) recompute
    only, finite and without NaN from the masked branches."""
    scene = case["tscene"]
    leaves = {f: getattr(scene, f).detach().requires_grad_(True)
              for f in ("sph_center", "sph_radius", "quad_q", "quad_u",
                        "quad_v", "med_neg_inv_density")}
    live = scene.replace(**leaves)
    h = tix.closest_hit(live, torch.from_numpy(case["o"]),
                        torch.from_numpy(case["d"]),
                        torch.from_numpy(case["t"]), case["tr"])
    loss = (h.t * h.hit).sum() + h.p.sum()
    gs = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    assert all(g is None or torch.isfinite(g).all() for g in gs)
    assert any(g is not None and g.abs().sum() > 0 for g in gs)


@pytest.mark.parametrize("name", ["mixed", "cornell_smoke"])
def test_scatter_and_emit_on_random_hits(name):
    """Every material family of the scene on random unit normals, random
    incoming directions, random material ids and faces."""
    kw = {} if name == "mixed" else dict(image_width=16)
    jscene, _, tscene, _ = both(name, **kw)
    rng = np.random.default_rng(5)
    n = rng.standard_normal((N_RAYS, 3))
    n = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
    d = rng.standard_normal((N_RAYS, 3)).astype(np.float32)
    p = rng.uniform(-2, 2, (N_RAYS, 3)).astype(np.float32)
    u, v = (rng.uniform(0, 1, N_RAYS).astype(np.float32) for _ in range(2))
    ff = rng.uniform(size=N_RAYS) < 0.5
    mat = rng.integers(0, np.asarray(jscene.mat_type).shape[0],
                       N_RAYS).astype(np.int32)
    pid = np.arange(N_RAYS, dtype=np.int32)
    js = _j_scatter(
        jscene, pid, *[jnp.asarray(d[:, k]) for k in range(3)],
        *[jnp.asarray(n[:, k]) for k in range(3)], jnp.asarray(ff),
        jnp.asarray(mat), jnp.asarray(u), jnp.asarray(v),
        *[jnp.asarray(p[:, k]) for k in range(3)])
    ts = tmat.scatter_and_emit_c(
        tscene, trng.CounterRng(9, torch.from_numpy(pid), 0, 2),
        *[torch.from_numpy(d[:, k].copy()) for k in range(3)],
        *[torch.from_numpy(n[:, k].copy()) for k in range(3)],
        torch.from_numpy(ff), torch.from_numpy(mat), torch.from_numpy(u),
        torch.from_numpy(v), *[torch.from_numpy(p[:, k].copy())
                               for k in range(3)])
    np.testing.assert_array_equal(ts.scattered.numpy(),
                                  np.asarray(js.scattered))
    for f in ("dx", "dy", "dz", "ar", "ag", "ab", "er", "eg", "eb"):
        _close(getattr(ts, f).numpy(), getattr(js, f), f)
