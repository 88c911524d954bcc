"""The port's differentiable table gathers (ops/tgather.py, ops/lanegather.py)
on the CPU, where they run their kernels' plain versions, against the JAX
package's tgather primitives: forward values, reverse mode against
``jax.vjp`` and forward mode against a gather of the tangent.

Tolerance of the backward and its reason: the transpose sums the cotangents
of each table row; the port's CPU sum (a dense masked ``sum`` up to 64 rows,
``index_add_`` above) and XLA's reduce add them in different orders, so rows
agree to float32 rounding of a sum of ~R/n terms: rtol 1e-5 plus an absolute
1e-6 of the largest row (float64: 1e-12)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_tracing_tpu.ops import tgather as jtg
from rust_tracing_tpu_torch.ops import lanegather as lg
from rust_tracing_tpu_torch.ops import tgather as ttg

R = 3000
TOL = {np.float32: (1e-5, 1e-6), np.float64: (1e-12, 1e-12)}


def _inputs(n, dtype, seed=0):
    rng = np.random.default_rng(seed + n)
    col = rng.standard_normal(n).astype(dtype)
    idx = rng.integers(0, n, R).astype(np.int32)
    ct = rng.standard_normal(R).astype(dtype)
    return col, idx, ct


def _close(got, ref, dtype):
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=atol * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [4, 64, 488])
def test_tgather_value_and_vjp(n, dtype):
    """Tables of 4 and 64 rows take the dense transpose, 488 the segment
    sum."""
    col, idx, ct = _inputs(n, dtype)
    out, vjp = jax.vjp(lambda c: jtg.tgather(c, jnp.asarray(idx)),
                       jnp.asarray(col))
    (ref_g,) = vjp(jnp.asarray(ct))
    tcol = torch.from_numpy(col).requires_grad_(True)
    tout = ttg.tgather(tcol, torch.from_numpy(idx))
    np.testing.assert_array_equal(tout.detach().numpy(), np.asarray(out))
    np.testing.assert_array_equal(tout.detach().numpy(), col[idx])
    (g,) = torch.autograd.grad(tout, tcol, torch.from_numpy(ct))
    _close(g.numpy(), np.asarray(ref_g), dtype)


@pytest.mark.parametrize("n", [4, 64, 488])
def test_tgather_cols_and_group_value_and_vjp(n):
    dtype = np.float32
    rng = np.random.default_rng(7 + n)
    cols = [rng.standard_normal(n).astype(dtype) for _ in range(3)]
    idx = rng.integers(0, n, R).astype(np.int32)
    cts = [rng.standard_normal(R).astype(dtype) for _ in range(3)]
    outs, vjp = jax.vjp(
        lambda *c: jtg.tgather_cols(c, jnp.asarray(idx)),
        *[jnp.asarray(c) for c in cols])
    ref_g = vjp(tuple(jnp.asarray(c) for c in cts))
    tcols = [torch.from_numpy(c).requires_grad_(True) for c in cols]
    for fn in (ttg.tgather_cols, ttg.tgather_group):
        touts = fn(tuple(tcols), torch.from_numpy(idx))
        for t, o in zip(touts, outs):
            np.testing.assert_array_equal(t.detach().numpy(), np.asarray(o))
        gs = torch.autograd.grad(touts, tcols,
                                 [torch.from_numpy(c) for c in cts])
        for g, r in zip(gs, ref_g):
            _close(g.numpy(), np.asarray(r), dtype)


def test_jvp_is_a_gather_of_the_tangent():
    col, idx, _ = _inputs(64, np.float64)
    tan = np.random.default_rng(3).standard_normal(64)
    tidx = torch.from_numpy(idx)
    out, dout = torch.func.jvp(lambda c: ttg.tgather(c, tidx),
                               (torch.from_numpy(col),),
                               (torch.from_numpy(tan),))
    np.testing.assert_array_equal(out.numpy(), col[idx])
    np.testing.assert_array_equal(dout.numpy(), tan[idx])
    _, douts = torch.func.jvp(
        lambda c: ttg.tgather_cols((c, 2.0 * c), tidx),
        (torch.from_numpy(col),), (torch.from_numpy(tan),))
    np.testing.assert_array_equal(douts[0].numpy(), tan[idx])
    np.testing.assert_array_equal(douts[1].numpy(), 2.0 * tan[idx])


def test_integer_tables_gather_without_gradient():
    idx = torch.tensor([[0, 3], [3, 1]], dtype=torch.int32)
    tab = torch.tensor([5, 6, 7, 8], dtype=torch.int32)
    out = ttg.tgather(tab, idx)
    assert out.dtype == torch.int32 and not out.requires_grad
    np.testing.assert_array_equal(out.numpy(), [[5, 8], [8, 6]])
    a, b = ttg.tgather_cols((tab, tab + 1), idx[0])
    np.testing.assert_array_equal(a.numpy(), [5, 8])
    np.testing.assert_array_equal(b.numpy(), [6, 9])
    # a material id riding a float gather round-trips exactly below 2^24
    ids = torch.tensor([0, 1, (1 << 24) - 1], dtype=torch.int32)
    back = ttg.tgather(ids.to(torch.float32), torch.tensor([2, 0]))
    assert back.to(torch.int32).tolist() == [(1 << 24) - 1, 0]


def test_plain_versions_out_of_range_and_regimes():
    """The kernels' plain versions: out-of-range rows gather 0 and are
    dropped by the sum; the dense and segment regimes give the same sums."""
    col = torch.arange(1.0, 5.0)
    idx = torch.tensor([-1, 0, 3, 4, 9], dtype=torch.int32)
    np.testing.assert_array_equal(lg.gather_plain(col, idx).numpy(),
                                  [0, 1, 4, 0, 0])
    ct = torch.ones(1, 5)
    np.testing.assert_array_equal(lg.scatter_sum_plain(ct, idx, 4).numpy(),
                                  [[1, 0, 0, 1]])
    big = lg.TGATHER_DENSE_MAX + 1
    rng = np.random.default_rng(1)
    idx = torch.from_numpy(rng.integers(0, big, 500).astype(np.int32))
    ct = torch.from_numpy(rng.standard_normal(500))
    dense = torch.stack([torch.where(idx == r, ct, 0.0).sum()
                         for r in range(big)])
    np.testing.assert_allclose(lg.scatter_sum(ct, idx, big).numpy(),
                               dense.numpy(), rtol=1e-12, atol=1e-12)
    assert lg.scatter_blocks(3_960_000) == (484, 8182)


def test_kernel_wrappers_refuse_cpu_tensors():
    """On a CPU tensor the dispatchers take the plain version; the kernel
    wrappers themselves launch on CUDA tensors only."""
    col, idx = torch.arange(4.0), torch.tensor([1, 2], dtype=torch.int32)
    for call in (lambda: lg.gather_kernel(col, idx),
                 lambda: lg.gather_cols_kernel(col[None], idx),
                 lambda: lg.scatter_sum_kernel(col[None, :2], idx, 4),
                 lambda: lg.scatter_match_kernel(col[None, :2], idx, 4),
                 lambda: lg.segment_sum_kernel(col[None, :2], idx, 4),
                 lambda: lg.radix_sort_kernel(idx, 4, col[None, :2])):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            call()


def test_radix_digits_from_rows():
    """The reductions' host-side choices. Tables of at most
    SCATTER_TILE_MAX_ROWS rows take the tile kernel (8 warps in min(K, 8)
    column groups; passes only past 227 KB of lane copies). Larger ones take
    the segment sum when they span two or more of the match kernel's row
    tiles (3072 f32 rows, 1536 f64) and more than 2 of an element's values
    are read over them, else the match kernel. The segment sum's
    radix sort: as few passes of at most RADIX_MAX_BITS as the bits of the
    largest key (n, the out-of-range rows) need; sorting digit by digit,
    lowest first, gives its plain version's stable order."""
    assert lg.use_tile_kernel(4) and lg.use_tile_kernel(64)
    assert not lg.use_tile_kernel(65)
    use = lg.use_segment_sum
    assert not any(use(n, K, 4) for n in (1, 2048, 2408, 3072)
                   for K in (1, 3, 17))
    assert not use(3073, 1, 4) and not use(6144, 1, 4)
    assert use(3073, 3, 4) and use(6145, 1, 4) and use(524288, 1, 4)
    assert not use(1536, 3, 8) and not use(3072, 1, 8)
    assert use(1537, 3, 8) and use(3073, 1, 8)
    wave = 3_960_000
    assert lg.scatter_plan(wave, 24, 17, 4) == dict(
        blocks=1024, chunk=3868, warps=8, groups=8, slices=1, cpw=3, rows=24,
        passes=1, smem_bytes=8 * 3 * 24 * 33 * 4)
    assert lg.scatter_plan(wave, 4, 1, 4)["blocks"] == 484
    assert lg.scatter_plan(wave, 4, 3, 8)["warps"] == 6
    assert lg.scatter_plan(wave, 488, 17, 4)["passes"] == 9
    assert lg.radix_digits(1) == (1,)
    assert lg.radix_digits(524288) == (7, 7, 6)
    for k in (1, 9, 10, 19):
        for n in (1 << k, (1 << k) + 1, (1 << k) - 1):
            w = lg.radix_digits(n)
            assert sum(w) == n.bit_length() and max(w) - min(w) <= 1
            assert max(w) <= lg.RADIX_MAX_BITS
            assert len(w) == -(-n.bit_length() // lg.RADIX_MAX_BITS)
    rng = np.random.default_rng(3)
    for n in (1, 256, 257, 70000):
        idx = rng.integers(-3, n + 3, 5000).astype(np.int32)
        keys = np.where((idx >= 0) & (idx < n), idx, n)
        order, shift = np.arange(idx.size), 0
        for width in lg.radix_digits(n):
            digit = (keys[order] >> shift) & ((1 << width) - 1)
            order = order[np.argsort(digit, kind="stable")]
            shift += width
        pos = torch.arange(idx.size, dtype=torch.float64)[None]
        skey, spos = lg.radix_sort_plain(torch.from_numpy(idx), n, pos)
        np.testing.assert_array_equal(spos[0].numpy(), order)
        np.testing.assert_array_equal(skey.numpy(), keys[order])


# The card's reduction gate (chip_smoke.py SUM_TOL): a row within this share
# of its sum of |cotangent| of the exact sum.
SUM_TOL = 1e-6


@pytest.mark.parametrize("R", [1, lg.SCATTER_CHUNK - 1, lg.SCATTER_CHUNK + 1])
@pytest.mark.parametrize("K", [1, 3, 17])
def test_scatter_sum_ordered_plain(K, R):
    """The tile kernel's summation order in tensor code
    (``scatter_sum_ordered_plain``, which the card holds the kernel to bit
    for bit) against the plain transpose and the JAX reference's
    (``jax.vjp`` of ``tgather``, column by column), out-of-range indices
    dropped: exact
    on integer-valued cotangents (every order sums them exactly); on normal
    ones within SUM_TOL of each row's sum of |cotangent| of the float64 sum,
    and within the module's float32 tolerance of the reference's. R of 1,
    and one less and one more than SCATTER_CHUNK: one block with warp slices
    left empty, one block, two blocks; K of 17 takes the smaller block."""
    n = 24
    rng = np.random.default_rng(7 * K + R)
    idx = rng.integers(-2, n + 2, R).astype(np.int32)
    ints = rng.integers(-8, 9, (K, R)).astype(np.float32)
    ct = rng.standard_normal((K, R)).astype(np.float32)
    tidx = torch.from_numpy(idx)
    ordered = lg.scatter_sum_ordered_plain(torch.from_numpy(ints), tidx, n)
    np.testing.assert_array_equal(
        ordered.numpy(),
        lg.scatter_sum_plain(torch.from_numpy(ints), tidx, n).numpy())
    got = lg.scatter_sum_ordered_plain(torch.from_numpy(ct), tidx, n).numpy()
    ok = (idx >= 0) & (idx < n)
    onehot = (idx[ok, None] == np.arange(n)).astype(np.float64)
    exact = ct[:, ok].astype(np.float64) @ onehot
    scale = np.abs(ct[:, ok]).astype(np.float64) @ onehot
    assert (np.abs(got - exact) <= SUM_TOL * scale).all()
    _, vjp = jax.vjp(lambda c: jtg.tgather(c, jnp.asarray(idx)),
                     jnp.zeros(n, jnp.float32))
    ref = np.stack([np.asarray(vjp(jnp.asarray(c))[0]) for c in ct])
    _close(got, ref, np.float32)
    plan = lg.scatter_plan(R, n, K, 4)
    assert plan["warps"] == (6 if K == 3 else 8) and plan["passes"] == 1


@pytest.mark.parametrize("dims", [(0, None), (None, 0), (1, 0)],
                         ids=["table", "index", "both"])
def test_vmap_matches_jax_vmap(dims):
    """torch.func.vmap of tgather and tgather_cols (float64) over a batched
    table, a batched index, or both, against jax.vmap of the reference
    primitives' batching rules: the same gathered bits."""
    rng = np.random.default_rng(11)
    B, K, n = 4, 3, 70
    col = rng.standard_normal((B, n))
    tab = rng.standard_normal((B, K, n))
    idx = rng.integers(0, n, (B, 50)).astype(np.int32)
    args = [col if dims[0] == 0 else col[0], idx if dims[1] == 0 else idx[0]]
    targs = [tab if dims[0] == 0 else tab[0], args[1]]
    if dims == (1, 0):
        args[0], targs[0] = col.T.copy(), np.moveaxis(tab, 0, 2).copy()
        tdims = (2, 0)
    else:
        tdims = dims
    got = torch.func.vmap(ttg.tgather, in_dims=dims)(
        *[torch.from_numpy(a) for a in args])
    ref = jax.vmap(jtg.tgather, in_axes=dims)(*[jnp.asarray(a) for a in args])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    got = torch.func.vmap(lambda t, i: torch.stack(ttg.tgather_cols(
        tuple(t), i)), in_dims=tdims)(*[torch.from_numpy(a) for a in targs])
    ref = jax.vmap(lambda t, i: jnp.stack(jtg.tgather_cols(tuple(t), i)),
                   in_axes=tdims)(*[jnp.asarray(a) for a in targs])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_jacfwd_and_jacrev_match_jax():
    """torch.func.jacfwd of tgather and tgather_cols (a vmap over the jvp,
    whose batched tangent table takes the batching rule) against
    jax.jacfwd, and jacrev (a vmap over the transpose) against both."""
    col, idx, _ = _inputs(64, np.float64)
    idx = idx[:200]
    tab = np.random.default_rng(5).standard_normal((3, 64))
    tidx, jidx = torch.from_numpy(idx), jnp.asarray(idx)

    def f(c):
        return ttg.tgather(c, tidx) * 2.0

    def g(t):
        return torch.stack(ttg.tgather_cols(tuple(t), tidx))

    for fn, jfn, x in (
            (f, lambda c: jtg.tgather(c, jidx) * 2.0, col),
            (g, lambda t: jnp.stack(jtg.tgather_cols(tuple(t), jidx)), tab)):
        ref = np.asarray(jax.jacfwd(jfn)(jnp.asarray(x)))
        np.testing.assert_array_equal(
            torch.func.jacfwd(fn)(torch.from_numpy(x)).numpy(), ref)
        np.testing.assert_array_equal(
            torch.func.jacrev(fn)(torch.from_numpy(x)).numpy(), ref)
