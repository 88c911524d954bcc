"""The port's Perlin noise (ops/perlin.py) and its turbulence Function
(ops/perlin_fused.py, whose CPU forward is the plain version of the CUDA
kernel) against the JAX package on the CPU.

Tolerances and their reasons. Values: the JAX functions run unjitted (op by
op, as the reference's own primitive evaluates on the CPU), so both sides do
the same f32 operations in the same order and agree bit for bit; the
float64 oracle of tests/oracles.py to 1e-5 (f32 rounding of a 7-octave
sum). Gradients: the backward sums of the two frameworks (the transpose of
each table gather, the octave chain) add in different orders, so each input's
gradient agrees within 1e-5 of its largest |g|; the float64 gradcheck holds
the Function's backward against its own finite differences."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles
from rust_tracing_tpu.ops import perlin as jperlin
from rust_tracing_tpu.ops import perlin_tpu
from rust_tracing_tpu_torch.ops import perlin as tperlin
from rust_tracing_tpu_torch.ops import perlin_fused

N = 512


@pytest.fixture(scope="module")
def tables():
    rv, px, py, pz = tperlin.make_tables(3)
    return rv.astype(np.float32), px, py, pz


def _points(seed, scale, n=N):
    rng = np.random.default_rng(seed)
    return rng.uniform(-scale, scale, (3, n)).astype(np.float32)


def _torch_tabs(tables):
    rv, px, py, pz = tables
    return (torch.from_numpy(rv),) + tuple(torch.from_numpy(q)
                                           for q in (px, py, pz))


def test_make_tables_equal_reference():
    for a, b in zip(tperlin.make_tables(7), jperlin.make_tables(7)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scale", [2.0, 300.0], ids=["cells", "wide"])
def test_noise_and_turbulence_match_jax(tables, scale):
    """Negative lattice cells and final_scene's coordinate range: bitwise
    against the reference's noise_c and its turbulence primitive
    (perlin_tpu.turbulence, which on the CPU evaluates perlin.turbulence_c
    op by op)."""
    p = _points(1, scale)
    tt, tp = _torch_tabs(tables), [torch.from_numpy(a) for a in p]
    jt, jp = [jnp.asarray(a) for a in tables], [jnp.asarray(a) for a in p]
    with jax.disable_jit():
        ref_n = np.asarray(jperlin.noise_c(*jt, *jp))
    ref_t = np.asarray(perlin_tpu.turbulence(*jt, *jp))
    np.testing.assert_array_equal(tperlin.noise_c(*tt, *tp).numpy(), ref_n)
    got = perlin_fused.turbulence(*tt, *tp)
    np.testing.assert_array_equal(got.numpy(), ref_t)
    np.testing.assert_array_equal(
        tperlin.turbulence(tt[0], *tt[1:], torch.from_numpy(p.T.copy())
                           ).numpy(), ref_t)


def test_turbulence_matches_oracle(tables):
    rv, px, py, pz = tables
    p = _points(2, 5.0, 64)
    got = perlin_fused.turbulence(*_torch_tabs(tables),
                                  *[torch.from_numpy(a) for a in p]).numpy()
    ref = [oracles.perlin_turbulence(rv.astype(np.float64), px, py, pz,
                                     p[:, i].astype(np.float64))
           for i in range(p.shape[1])]
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_turbulence_gradients_match_jax(tables):
    """The Function's backward (the plain version's gradient) against
    jax.vjp of the reference's turbulence_c, w.r.t. the gradient table and
    the three position components. Three octaves: the octave loop is the
    same code at every depth, and each octave costs the unjitted reference
    a few hundred dispatches."""
    rv, px, py, pz = tables
    p = _points(4, 3.0)
    ct = np.random.default_rng(5).normal(size=N).astype(np.float32)
    with jax.disable_jit():
        _, vjp = jax.vjp(lambda r, x, y, z: jperlin.turbulence_c(
            r, jnp.asarray(px), jnp.asarray(py), jnp.asarray(pz), x, y, z,
            depth=3), jnp.asarray(rv), *[jnp.asarray(a) for a in p])
        ref = [np.asarray(g) for g in vjp(jnp.asarray(ct))]
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (rv, p[0], p[1], p[2])]
    out = perlin_fused.turbulence(leaves[0], torch.from_numpy(px),
                                  torch.from_numpy(py), torch.from_numpy(pz),
                                  *leaves[1:], depth=3)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(ct))
    for name, g, r in zip(("ranvec", "px", "py", "pz"), got, ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-5 * np.abs(r).max(), err_msg=name)


def test_turbulence_gradcheck_float64(tables):
    """float64 finite differences of the Function on 16 lanes, w.r.t. the
    gradient table and the positions (a random projection of the Jacobian,
    gradcheck's fast mode)."""
    rv, px, py, pz = tables
    p = _points(6, 2.0, 16).astype(np.float64)
    args = [torch.from_numpy(rv.astype(np.float64)).requires_grad_(),
            torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(pz)]
    args += [torch.from_numpy(a).requires_grad_() for a in p]
    assert torch.autograd.gradcheck(perlin_fused.turbulence, tuple(args),
                                    fast_mode=True, eps=1e-6, atol=1e-6)


def test_turbulence_kernel_refuses_cpu_tensors(tables):
    """The kernel wrapper launches or raises; a CPU tensor never reaches
    it through the Function, which runs the plain version."""
    tt = _torch_tabs(tables)
    p = [torch.zeros(4) for _ in range(3)]
    before = dict(perlin_fused.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        perlin_fused.turbulence_kernel(*tt, *p)
    perlin_fused.turbulence(*tt, *p)
    assert perlin_fused.LAUNCHES == before
    with pytest.raises(TypeError, match="f32 or f64"):
        perlin_fused.turbulence(*tt, *[q.half() for q in p])


def test_turbulence_vmap_and_jacfwd_match_jax(tables):
    """torch.func.vmap of the turbulence Function over batched points
    (flattened into one launch's lanes) against jax.vmap of the reference
    primitive, bit for bit (f32, unjitted); jacfwd w.r.t. the positions and
    a jvp along a gradient-table tangent (float64) against jitted JAX's,
    and jacrev against jacfwd, to float64 rounding. Three octaves, as in
    test_turbulence_gradients_match_jax."""
    rv, px, py, pz = tables
    tt, jt = _torch_tabs(tables), [jnp.asarray(a) for a in tables]
    p = np.random.default_rng(8).uniform(-3, 3, (3, 2, 16)).astype(np.float32)
    got = torch.func.vmap(lambda x, y, z: perlin_fused.turbulence(
        *tt, x, y, z, depth=3), in_dims=(0, 0, None))(
        *[torch.from_numpy(a) for a in (p[0], p[1], p[2, 0])])
    ref = jax.vmap(lambda x, y, z: perlin_tpu.turbulence(*jt, x, y, z,
                                                         depth=3),
                   in_axes=(0, 0, None))(
        *[jnp.asarray(a) for a in (p[0], p[1], p[2, 0])])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    q = p[:, 0, :8].astype(np.float64)
    rv64 = rv.astype(np.float64)
    tan = np.random.default_rng(9).standard_normal(rv64.shape)

    def tf(r, x):
        return perlin_fused.turbulence(r, *tt[1:], x,
                                       *[torch.from_numpy(a) for a in q[1:]],
                                       depth=3)

    def jf(r, x):
        return perlin_tpu.turbulence(r, *jt[1:], x,
                                     *[jnp.asarray(a) for a in q[1:]],
                                     depth=3)

    r, x = torch.from_numpy(rv64), torch.from_numpy(q[0])
    fwd = torch.func.jacfwd(tf, argnums=1)(r, x)
    ref = np.asarray(jax.jit(jax.jacfwd(jf, argnums=1))(jnp.asarray(rv64),
                                                        jnp.asarray(q[0])))
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(fwd.numpy(), ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(torch.func.jacrev(tf, argnums=1)(r, x).numpy(),
                               ref, rtol=1e-12, atol=1e-12)
    _, dt = torch.func.jvp(lambda v: tf(v, x), (r,), (torch.from_numpy(tan),))
    _, jdt = jax.jit(lambda v, t: jax.jvp(lambda u: jf(u, jnp.asarray(q[0])),
                                          (v,), (t,)))(jnp.asarray(rv64),
                                                       jnp.asarray(tan))
    np.testing.assert_allclose(dt.numpy(), np.asarray(jdt), rtol=1e-12,
                               atol=1e-12)


def _lattice_points(seed, n=N):
    """Lanes of every kind the backward must get right: random points, points
    on an integer lattice plane of one axis (u = 0 there at every octave: the
    floor's step and the Hermite weight's zero slope), whole lattice points
    and the origin (the octave sum is 0 there: abs's derivative is 0)."""
    p = _points(seed, 3.0, n)
    q = n // 4
    p[0, :q] = np.round(p[0, :q])               # x on a lattice plane
    p[:, q:2 * q] = np.round(p[:, q:2 * q])     # lattice points: acc == 0
    p[:, 2 * q:2 * q + 8] = 0.0                 # masked lanes
    return p


def test_turbulence_backward_plain_matches_jax_on_lattice(tables):
    """turbulence_backward_plain against jax.vjp of the reference's
    turbulence_c at lanes on lattice planes, lattice points and the origin
    (where acc == 0), with random lanes beside them; tolerance as in
    test_turbulence_gradients_match_jax (1e-5 of the largest |g|: the two
    frameworks' sums add in different orders). On a lattice point each
    octave's noise is exactly 0; jnp.abs differentiates as
    select(acc >= 0, g, -g) there, and so does the port."""
    rv, px, py, pz = tables
    p = _lattice_points(10)
    ct = np.random.default_rng(11).normal(size=N).astype(np.float32)
    tt = _torch_tabs(tables)
    pos = [torch.from_numpy(a) for a in p]
    with torch.no_grad():
        acc = tperlin.octave_sum_c(tt[0], *tt[1:], *pos, depth=3)
    q = N // 4
    assert (acc[q:2 * q] == 0).all() and (acc[:q] != 0).all()
    with jax.disable_jit():
        _, vjp = jax.vjp(lambda r, x, y, z: jperlin.turbulence_c(
            r, jnp.asarray(px), jnp.asarray(py), jnp.asarray(pz), x, y, z,
            depth=3), jnp.asarray(rv), *[jnp.asarray(a) for a in p])
        ref = [np.asarray(g) for g in vjp(jnp.asarray(ct))]
    got = perlin_fused.turbulence_backward_plain(*tt, *pos,
                                                 torch.from_numpy(ct), depth=3)
    for name, g, r in zip(("ranvec", "px", "py", "pz"), got, ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-5 * np.abs(r).max(), err_msg=name)
    assert (got[1][q:2 * q] != 0).any()


def test_turbulence_backward_plain_matches_autograd(tables):
    """The explicit backward against torch.autograd of turbulence_plain (the
    Function's backward before the kernel, a recompute under torch.func.vjp)
    in float64 at depth 7, w.r.t. each leaf alone and all together: the
    derivative of u*u*(3-2u) written as 6u(1-u) and the corner sums in
    another order differ only by float64 rounding, so 1e-12 of the largest
    |g|. Where the octave sum is 0, torch.abs's derivative is 0 and the
    reference's (and the port's) is +1: there the autograd side takes the
    reference's rule, and on every other lane the old backward's values
    hold as they are."""
    rv, px, py, pz = tables
    p = _lattice_points(12, 256).astype(np.float64)
    ct = torch.from_numpy(np.random.default_rng(13).normal(size=256))
    tt = (torch.from_numpy(rv.astype(np.float64)),) + _torch_tabs(tables)[1:]
    leaves = [tt[0].clone().requires_grad_()] + [
        torch.from_numpy(a).requires_grad_() for a in p]
    got = perlin_fused.turbulence_backward_plain(
        *tt, *[torch.from_numpy(a) for a in p], ct)
    acc = tperlin.octave_sum_c(leaves[0], *tt[1:], *leaves[1:])
    nonzero = (acc != 0).detach()
    old = torch.autograd.grad(torch.abs(acc), leaves[1:], ct,
                              retain_graph=True)
    ref = torch.autograd.grad(torch.where(acc >= 0, acc, -acc), leaves, ct)
    for name, g, r in zip(("ranvec", "px", "py", "pz"), got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0,
                                   atol=1e-12 * r.abs().max().item(),
                                   err_msg=name)
    assert not nonzero.all()
    for g, r in zip(got[1:], old):
        np.testing.assert_allclose(g[nonzero].numpy(), r[nonzero].numpy(),
                                   rtol=0, atol=1e-12 * r.abs().max().item())
    # the Function asks the backward only for what autograd needs
    for k in range(4):
        xs = [t.detach().requires_grad_(i == k) for i, t in
              enumerate(leaves)]
        o = perlin_fused.turbulence(xs[0], *tt[1:], *xs[1:])
        (g,) = torch.autograd.grad(o, [xs[k]], ct)
        np.testing.assert_array_equal(g.numpy(), got[k].numpy())


def test_turbulence_jacrev_matches_jax(tables):
    """torch.func.jacrev of the Function w.r.t. the positions and ranvec (16
    lanes, depth 3, float64): the backward's vmap rule under jacrev's
    batched cotangents, against jax.jacrev of the reference primitive, to
    float64 rounding."""
    rv, px, py, pz = tables
    p = _points(14, 3.0, 16).astype(np.float64)
    tt, jt = _torch_tabs(tables), [jnp.asarray(a) for a in tables]
    rv64 = rv.astype(np.float64)

    def tf(r, x):
        return perlin_fused.turbulence(r, *tt[1:], x,
                                       *[torch.from_numpy(a) for a in p[1:]],
                                       depth=3)

    def jf(r, x):
        return perlin_tpu.turbulence(r, *jt[1:], x,
                                     *[jnp.asarray(a) for a in p[1:]],
                                     depth=3)

    got = torch.func.jacrev(tf, argnums=(0, 1))(torch.from_numpy(rv64),
                                                torch.from_numpy(p[0]))
    ref = jax.jit(jax.jacrev(jf, argnums=(0, 1)))(jnp.asarray(rv64),
                                                  jnp.asarray(p[0]))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert np.abs(r).max() > 0
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-12, atol=1e-12)


def _backward_inputs(tables, seed, dtype=np.float32, n=N, g_scale=1.0):
    rv, px, py, pz = tables
    tt = (torch.from_numpy(rv.astype(dtype)),) + _torch_tabs(tables)[1:]
    pos = [torch.from_numpy(a) for a in _points(seed, 3.0, n).astype(dtype)]
    g = np.random.default_rng(seed + 1).normal(size=n) * g_scale
    return tt, pos, torch.from_numpy(g.astype(dtype))


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_backward_ranvec_fixed_sum_is_order_free(tables, dtype):
    """d_ranvec of the plain version (the kernel's fixed-point sum: each term
    rounded once to an integer, integers added exactly) has the same bits
    when the lanes come in another order; the position gradients move with
    their lanes."""
    tt, pos, g = _backward_inputs(tables, 20, dtype)
    perm = torch.from_numpy(np.random.default_rng(22).permutation(N))
    got = perlin_fused.turbulence_backward_plain(*tt, *pos, g)
    shuf = perlin_fused.turbulence_backward_plain(
        *tt, *[p[perm] for p in pos], g[perm])
    assert torch.equal(shuf[0], got[0])
    for a, b in zip(shuf[1:], got[1:]):
        assert torch.equal(a, b[perm])


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_backward_ranvec_within_quantization_bound(tables, dtype):
    """Against the exact sum of the same terms (math.fsum of their float64
    values), each entry is off by at most its n nonzero terms' rounding,
    half a unit of 2^-k each (f64: of 2^-(k + 32)), plus the conversion's
    two roundings through float64 (2 units of the type)."""
    tt, pos, g = _backward_inputs(tables, 24, dtype)
    got = perlin_fused.turbulence_backward_plain(*tt, *pos, g)[0]
    _, _, _, terms = tperlin.turbulence_vjp_c(tt[0], *tt[1:], *pos, g)
    idx = torch.cat([h.reshape(-1) for h, _ in terms]).numpy()
    vals = torch.cat([c.reshape(3, -1) for _, c in terms], 1).double()
    vals = vals.numpy()
    exact = np.array([[math.fsum(vals[a, idx == e]) for a in range(3)]
                      for e in range(256)])
    n = np.array([[np.count_nonzero(vals[a, idx == e]) for a in range(3)]
                  for e in range(256)])
    ka, kb = perlin_fused.fixed_scale(N, float(g.abs().max()), got.dtype)
    frac = ka + kb + (0 if dtype == np.float32 else 32)
    unit = 2.0 ** -24 if dtype == np.float32 else 2.0 ** -53
    quant = n * 2.0 ** -(frac + 1)
    bound = quant + 2 * unit * (np.abs(exact) + quant)
    err = np.abs(got.numpy().astype(np.float64) - exact)
    assert (err <= bound).all(), (err / bound).max()
    assert np.abs(exact).max() > 0


def test_backward_fixed_scale_edges(tables):
    """The scale: at R = 2^22 and the largest f32 |g|, 16 R max|g| terms of
    the largest size still sum to under 2^63 as integers; g == 0 gives a
    zero d_ranvec, a non-finite g a NaN one; max|g| at f32's smallest
    normal a finite one (k past f32's exponent range: two factors)."""
    R, gmax = 1 << 22, float(np.finfo(np.float32).max)
    ka, kb = perlin_fused.fixed_scale(R, gmax, torch.float32)
    (q,) = perlin_fused._quantize(torch.tensor([gmax], dtype=torch.float32),
                                  ka, kb)
    assert 0 < 16 * R * int(q) < 2 ** 63
    assert 16 * R * math.ldexp(gmax, ka + kb) <= 2.0 ** 62
    tt, pos, g = _backward_inputs(tables, 26, n=64)
    zero = perlin_fused.turbulence_backward_plain(*tt, *pos, 0 * g)[0]
    assert torch.equal(zero, torch.zeros_like(zero))
    bad = g.clone()
    bad[3] = math.inf
    assert perlin_fused.turbulence_backward_plain(*tt, *pos,
                                                  bad)[0].isnan().all()
    tiny = float(np.finfo(np.float32).tiny)
    g = g / g.abs().max() * tiny
    ka, kb = perlin_fused.fixed_scale(64, float(g.abs().max()),
                                      torch.float32)
    assert kb > 0
    got = perlin_fused.turbulence_backward_plain(*tt, *pos, g)[0]
    assert torch.isfinite(got).all() and (got != 0).any()
