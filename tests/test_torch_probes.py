"""The port's hardware probes (rust_tracing_tpu_torch/probes.py) on the CPU,
where each probe runs its kernel's plain version, against the JAX probes of
scripts/tpu_probe.py (imported by file path; its Pallas kernels run in
interpret mode through a test-scoped patch of ``pallas_call``).

Tolerances and their reasons. P1-P4 sum integers or copy table entries: bit
for bit. P5/P6 do f32 arithmetic: interpret mode runs the kernel as one
jitted XLA computation, and XLA's CPU compiler contracts its multiply-adds
(``hb*hb - a*c``, the dot products) into fused multiply-adds, which the
port (like its CUDA kernels, built with ``--fmad=false``) never does. So
against interpret mode the hits must be the same rays and each hit's t
agree to 1e-3 relative (seen: 110 of 1024 rays differ, by at most 8.8e-5);
and the same kernel evaluated op by op (``pallas_call`` replaced by an
eager evaluation of the kernel body, no fusion; seen equal to numpy's f32)
must equal the plain version bit for bit. P7's products are XLA dots in
interpret mode: the same hit rays, t to 1e-3 relative (seen: 1.3e-4)."""

import contextlib
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_tracing_tpu_torch import probes
from rust_tracing_tpu_torch.runtime.kernels import LAUNCHES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, REPS = 64, 2
T_RTOL = 1e-3


@pytest.fixture(scope="module")
def tp():
    spec = importlib.util.spec_from_file_location(
        "tpu_probe", os.path.join(REPO, "scripts", "tpu_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(tp, monkeypatch):
    monkeypatch.setattr(tp.pl, "pallas_call",
                        functools.partial(tp.pl.pallas_call, interpret=True))
    return tp


class _Ref:
    """A mutable stand-in for a Pallas ref: the kernel body's reads and
    writes as plain jnp indexing."""

    def __init__(self, a):
        self.a = a

    def __getitem__(self, k):
        return self.a[k]

    def __setitem__(self, k, v):
        self.a = self.a.at[k].set(v)


def _eager_pallas_call(kernel, out_shape, **_):
    def call(*args):
        refs = [_Ref(jnp.asarray(a)) for a in args]
        out = _Ref(jnp.zeros(out_shape.shape, out_shape.dtype))
        with jax.disable_jit():
            kernel(*refs, out)
        return out.a
    return call


def _rays(tp):
    return [torch.from_numpy(np.array(a)) for a in tp._mk_rays()]


def _mxu_draws(S):
    """P7's own draws (scripts/tpu_probe.py sphere_mxu), as torch."""
    k = jax.random.PRNGKey(0)
    o = jax.random.normal(k, (1024, 8), jnp.float32)
    d = jax.random.normal(jax.random.fold_in(k, 1), (1024, 8), jnp.float32)
    cm = jax.random.normal(jax.random.fold_in(k, 2), (8, S), jnp.float32)
    r2 = np.ones((8, S), np.float32)
    return [torch.from_numpy(np.array(a)) for a in (cm, r2, o, d)]


@pytest.mark.parametrize("n", [128, 1024, 65536])
def test_smem_scalar_matches_jax(interpret, n):
    """P1: the index-order f32 sum; at 65536 entries 2147421200.0, not the
    exact 2147450880."""
    ref = np.asarray(interpret.smem_scalar(n))
    got = probes.smem_scalar(n, "global", device="cpu").numpy()
    np.testing.assert_array_equal(got, ref)
    if n == 65536:
        assert got[0, 0] == np.float32(2147421200.0)


@pytest.mark.parametrize("probe", ["P2", "P3", "P4"])
def test_row_and_gather_probes_match_jax(interpret, probe):
    if probe == "P2":
        ref, got = interpret.vmem_row_broadcast(256), \
            probes.vmem_row_broadcast(256, device="cpu")
    elif probe == "P3":
        ref, got = interpret.vmem_gather(), probes.vmem_gather(device="cpu")
    else:
        ref, got = interpret.vmem_gather_2d(), \
            probes.vmem_gather_2d(device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@contextlib.contextmanager
def _flushed_subnormals():
    """PyTorch's CPU arithmetic with subnormals flushed to zero, as XLA's
    CPU code runs, on one thread (the flush is a per-thread setting)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    assert torch.set_flush_denormal(True)
    try:
        yield
    finally:
        torch.set_flush_denormal(False)
        torch.set_num_threads(threads)


@pytest.mark.parametrize("case", ["smem", "immediate", "smem-edge",
                                  "immediate-edge"])
def test_sphere_loops_match_jax(tp, monkeypatch, case):
    """P5/P6 at S = 64, reps = 2: bit for bit against the kernel body
    evaluated op by op. On the JAX probe's own rays 15.6 % of the rays hit,
    so the comparison is not vacuous; P5 also to the contraction tolerance
    against interpret mode (P6's unrolled kernel is the same arithmetic,
    and costs interpret mode's compiler seconds).

    The edge case runs the tile of ``probes.edge_rays`` (built, not drawn:
    zero and subnormal directions, origins at sphere centres, grazes whose
    disc is +0.0 or subnormal), given to the JAX probe in place of its own
    draws (``_mk_rays``). XLA's CPU code flushes subnormals to zero, so the
    plain version runs flushed there too. With IEEE subnormals, as on the
    card, it equals numpy's f32 arithmetic instead, and differs from the
    flushed result on every ray whose closest hit has a subnormal disc."""
    probe, _, rays = case.partition("-")
    if rays == "edge":
        o, d = probes.edge_rays()
        monkeypatch.setattr(tp, "_mk_rays", lambda: (jnp.asarray(o.numpy()),
                                                     jnp.asarray(d.numpy())))
    else:
        o, d = _rays(tp)
    fn = (tp.sphere_loop_smem if probe == "smem"
          else tp.sphere_loop_immediate)
    port = (functools.partial(probes.sphere_loop_smem, S, REPS)
            if probe == "smem"
            else functools.partial(probes.sphere_loop_immediate, S, REPS))
    if rays == "edge":
        with _flushed_subnormals():
            got = port(o, d).numpy()
        ieee = port(o, d).numpy()
        tab = probes.sphere_table(S).numpy()
        O, D = o.reshape(3, -1).numpy(), d.reshape(3, -1).numpy()
        t, k = probes._first_hit_np(tab, O, D)
        np.testing.assert_array_equal(ieee.reshape(-1), t)
        disc = probes.sphere_terms_np(tab, O, D)[0]
        closest = disc[k, np.arange(k.size)]
        sub = (t < probes.NO_HIT) & (closest > 0) & (
            closest < np.finfo(np.float32).tiny)
        assert sub.sum() >= 300 and (ieee.reshape(-1) != got.reshape(-1))[
            sub].all()
        assert (disc == 0).sum() > 10000
    else:
        got = port(o, d).numpy()
        assert 0.1 < (got < probes.NO_HIT).mean() < 0.5
        if probe == "smem":
            monkeypatch.setattr(tp.pl, "pallas_call", functools.partial(
                tp.pl.pallas_call, interpret=True))
            ref_jit = np.asarray(fn(S, REPS))
            hit = got < probes.NO_HIT
            np.testing.assert_array_equal(ref_jit < probes.NO_HIT, hit)
            np.testing.assert_allclose(got[hit], ref_jit[hit], rtol=T_RTOL)
    monkeypatch.setattr(tp.pl, "pallas_call", _eager_pallas_call)
    np.testing.assert_array_equal(got, np.asarray(fn(S, REPS)))


def test_sphere_mxu_matches_jax(interpret):
    """P7's f32 plain version at S = 64, reps = 2 on the JAX probe's own
    draws: the same rays hit (61 %), t to 1e-3 relative."""
    cm, r2, o, d = _mxu_draws(S)
    ref = np.asarray(interpret.sphere_mxu(S, REPS))
    got = probes.sphere_mxu(cm, r2, o, d, REPS).numpy()
    hit = got < probes.NO_HIT
    assert 0.5 < hit.mean() < 0.7
    np.testing.assert_array_equal(ref < probes.NO_HIT, hit)
    np.testing.assert_allclose(got[hit], ref[hit], rtol=T_RTOL)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 as ``cvt.rna.tf32.f32`` does: to nearest, ties
    away from zero, 10 stored mantissa bits."""
    b = x.numpy().view(np.uint32)
    return torch.from_numpy(((b + np.uint32(0x1000))
                             & np.uint32(0xFFFFE000)).view(np.float32))


def test_tf32_gate_holds_emulated_tensor_cores():
    """The TF32 gate on the tensor-core variant's arithmetic emulated here
    (operands rounded to TF32, exact products, f32 sums): the products stay
    within TF32_PROD_RTOL, every ray whose t moves by more than 1e-3 is one
    the gate's bound lets move, and the gate is not vacuous (rays move, and
    not every ray is at risk)."""
    cm, r2, o, d = probes.mxu_inputs(0, probes.SPHERES, device="cpu")
    cmr, orr, drr = (_tf32(x) for x in (cm, o, d))
    prods = torch.stack([probes._rows_dot(drr, cmr),
                         probes._rows_dot(orr, cmr)])
    a, o2 = probes._rows_norm2(d), probes._rows_norm2(o)
    t, _, ok = probes._mxu_t(prods[0], prods[1], a, o2, r2[0:1])
    t_tc = torch.where(ok, t, probes.NO_HIT).amin(1, keepdim=True)
    gate = probes.tf32_gate(cm, r2, o, d, t_tc, prods)
    assert gate["ok"], gate
    assert gate["prod_err_over_abs_sum"] > 0.25 * probes.TF32_PROD_RTOL
    assert 0 < gate["moved_share"] <= gate["at_risk_share"] < 1
    # f32 products move nothing
    exact = probes.tf32_gate(cm, r2, o, d,
                             probes.sphere_mxu_plain(cm, r2, o, d, 1),
                             probes.mxu_products_plain(cm, o, d))
    assert exact["ok"] and exact["moved_share"] == 0


def _one_division_a_ray(cm, r2, o, d):
    """The P7 kernels' arithmetic (csrc/probe_kernel.cu mxu_step): per pair
    num = -hd - root (the root of 1 where disc <= 0), a hit where disc > 0
    and num >= thr; per ray the least num over the hits divided by a, once.
    numpy f32 on the plain version's products; one round (the rounds are
    identical)."""
    hd, a, disc, _ = probes._mxu_pairs(cm, r2[0], o, d)
    thr = probes.mxu_threshold_np(a[:, 0])[:, None]
    with np.errstate(all="ignore"):
        num = -hd - np.sqrt(np.where(disc > 0, disc, np.float32(1.0)))
        best = np.where((disc > 0) & (num >= thr), num,
                        np.float32(np.inf)).min(1)
        return np.fmin(np.float32(probes.NO_HIT), best / a[:, 0])


@pytest.mark.parametrize("tile", ["sweep", "edge"])
def test_one_division_a_ray_is_the_plain_version(tile):
    """P7's kernels divide once a ray a round, by a threshold on num: bit
    for bit ``sphere_mxu_plain`` on the sweep's inputs (S = 256) and on the
    edge tile, which holds what it says: t on the float below 1e-3f, on it
    and above it (a hit, the ray's closest), -hd on the threshold and the
    floats beside it with disc > 0, disc +0.0 with hd != 0, a positive
    subnormal disc at the ray's closest hit, zero directions; 80 rays, a
    multiple of 16 but not of 32."""
    inputs = (probes.mxu_inputs(0, probes.SPHERES, device="cpu")
              if tile == "sweep" else probes.mxu_edge_inputs())
    cm, r2, o, d = (x.numpy() for x in inputs)
    want = probes.sphere_mxu_plain(*inputs, 1).numpy()[:, 0]
    np.testing.assert_array_equal(_one_division_a_ray(cm, r2, o, d), want)
    if tile == "sweep":
        assert 0.8 < (want < probes.NO_HIT).mean() < 0.9
        return
    R, n = o.shape[0], probes.EDGE_CASE_RAYS
    assert R == probes.MXU_EDGE_RAYS and R % 16 == 0 and R % 32
    hd, a, disc, t = probes._mxu_pairs(cm, r2[0], o, d)
    thr = probes.mxu_threshold_np(a[:, 0])
    pos = disc > 0
    tiny = np.finfo(np.float32).tiny
    lo, hi = (np.nextafter(probes.T_MIN, np.float32(x)) for x in (0, 1))
    for i, case in enumerate(probes.MXU_EDGE_CASES):
        rows = slice(i * n, (i + 1) * n)
        if case.startswith("t "):
            target = (lo, probes.T_MIN, hi)[i]
            assert (pos[rows] & (t[rows] == target)).any(1).all(), case
        elif case.startswith("-hd "):
            th = thr[rows, None]
            target = (np.nextafter(th, np.float32(0)), th,
                      np.nextafter(th, np.float32(np.inf)))[i - 3]
            assert (pos[rows] & (-hd[rows] == target)).any(1).all(), case
        elif case == "disc +0":
            assert ((disc[rows] == 0) & (hd[rows] != 0)).any(1).all()
        elif case == "disc subnormal":
            near = np.where(pos & (t > probes.T_MIN), t, np.inf)[rows]
            j = near.argmin(1)
            dj = disc[rows][np.arange(n), j]
            assert (np.isfinite(near.min(1)) & (dj > 0) & (dj < tiny)).all()
        else:
            assert (a[rows] == 0).all() and (thr[rows] == 2.0 ** -149).all()
    # the threshold's edge decides: the float above 1e-3f is the closest
    # hit, 1e-3f itself and the float below are not hits
    assert (want[2 * n:3 * n] == hi).all()
    assert not np.isin(want[:2 * n], (lo, probes.T_MIN)).any()


def test_mxu_threshold_is_least():
    """The kernels' threshold is the least f32 whose IEEE f32 quotient by a
    exceeds 1e-3f, for a spread of a: +0 (the least subnormal: x / 0 =
    inf), subnormal, just above the least normal, 1, large, random over
    every exponent; no float passes where a is +inf or NaN (NaN)."""
    g = np.random.default_rng(0)
    a = np.concatenate([
        np.array([0.0, 1e-45, 1e-40, 1.1754944e-38, 1.1754945e-38, 1.0,
                  1.0e4, 178571.4, 3.0e38, 3.4028235e38], np.float32),
        g.integers(1, 0x7F800000, 20000, dtype=np.uint32).view(np.float32)])
    thr = probes.mxu_threshold_np(a)
    below = np.nextafter(thr, np.float32(-np.inf))
    with np.errstate(all="ignore"):
        assert (thr / a > probes.T_MIN).all()
        assert not (below / a > probes.T_MIN).any()
    assert thr[0] == np.float32(2.0 ** -149) and thr[5] == np.nextafter(
        probes.T_MIN, np.float32(1))
    assert np.isnan(probes.mxu_threshold_np(
        np.array([np.inf, np.nan], np.float32))).all()


def test_limits_refusals_and_sweep_listing():
    """Sizes that do not fit a memory space raise before any launch and
    are listed by the sweep from the same limit function; the kernel
    wrappers refuse CPU tensors; P3's strides have the stated bank
    conflicts."""
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="does not fit constant"):
        probes.smem_scalar(65536, "constant", device="cpu")
    with pytest.raises(ValueError, match="does not fit shared"):
        probes.check_fits("shared", probes.SHARED_FLOATS + 1)
    assert probes.fits("constant", 16384) and probes.fits("global", 1 << 30)
    _, skip = probes.variants()
    assert skip == [("P1", "smem_scalar", "constant", 65536),
                    ("P1", "smem_scalar", "shared", 65536)]
    tab = torch.arange(8.0)
    o, d = torch.zeros(3, 8, 128), torch.ones(3, 8, 128)
    cm, r2, ro, rd = probes.mxu_inputs(0, 8, device="cpu")
    # P3/P4 refuse a reps beyond the staged copy (the table and its first
    # MAX_GATHERS - 1 entries again) and a stride that is not an integer
    # before anything else; a stride is taken mod 256, so -3 is taken
    t3, t4 = probes.gather_table("cpu"), probes.gather_2d_table("cpu")
    for call in (lambda: probes.vmem_gather_kernel(
                     t3, "shared", reps=probes.MAX_GATHERS + 1),
                 lambda: probes.vmem_gather_kernel(t3, "global", reps=0),
                 lambda: probes.vmem_gather_2d_kernel(
                     t4, "shared", reps=probes.MAX_GATHERS + 1)):
        with pytest.raises(ValueError, match="reps must be in 1..64"):
            call()
    for stride in (2.5, "13", None, True):
        with pytest.raises(TypeError, match="stride must be an integer"):
            probes.vmem_gather_kernel(t3, "shared", stride)
    for call in (lambda: probes.vmem_gather_kernel(t3, "shared", -3,
                                                   probes.MAX_GATHERS),
                 lambda: probes.vmem_gather_2d_kernel(t4, "global",
                                                      probes.MAX_GATHERS)):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            call()
    for call in (lambda: probes.smem_scalar_kernel(tab, "global"),
                 lambda: probes.vmem_gather_kernel(
                     probes.gather_table("cpu"), "shared"),
                 lambda: probes.sphere_loop_kernel(
                     probes.sphere_table(4), o, d, 1, "global"),
                 lambda: probes.sphere_immediate_kernel(64, o, d, 1),
                 lambda: probes.sphere_mxu_kernel(cm, r2, ro, rd, 1, True)):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            call()
    assert LAUNCHES == before
    assert [probes.bank_conflict_ways(s) for s in probes.GATHER_STRIDES] \
        == [1, 2, 8, 8]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            probes.main([])


def test_bounds_count_the_function():
    """The bounds count what each probe's function needs, not what its
    kernel does: P1/P2 one n-term sum a tile over the n entries it sums,
    whose n dependent adds are a chain (one fold a tile, tiles x n reads, is
    the read count, the rate's numerator); P3/P4 the table entries the index
    touches (P4 at one gather: each lane's 8 rows 7 r + 13 l are distinct,
    8 x 128 entries); P5-P7 their tests' operations issued one a lane
    slot."""
    tiles, n = 1024, 16384
    out_bytes = 4 * tiles * probes.TILE
    count, _, flop, tc, n_bytes = probes.work("P1", "constant", n, tiles)
    assert (count, flop, tc, n_bytes) == (tiles * n, tiles * n, 0,
                                          4 * n + out_bytes)
    assert probes.bound_ms(flop, n_bytes, tc)[1] == "bytes"
    chain = probes.chain_floor_ms(n)
    assert probes.bound_ms(flop, n_bytes, tc, chain) == (chain, "chain")
    count, _, flop, tc, n_bytes = probes.work("P2", "shared", 256, tiles)
    assert (count, n_bytes) == (tiles * 256, 4 * 256 + out_bytes)
    assert probes.bound_ms(flop, n_bytes, tc,
                           probes.chain_floor_ms(256))[1] == "bytes"
    assert probes.touched_entries("P4") == 8 * 128
    idx = probes.gather_index().numpy()
    assert probes.touched_entries("P3") == len(np.unique(idx))
    assert probes.touched_entries("P3", 64) == probes.GATHER_N
    assert probes.work("P4", "shared", 256, tiles, 64)[4] == (
        4 * probes.touched_entries("P4", 64) + out_bytes)
    # P5/P6: 25 f32 operations a sphere test, each its own instruction
    # (--fmad=false), one a lane slot: 12.84 ms at 1024 tiles, S = 256, 64
    # rounds on 132 SMs, twice what the 67 TFLOP/s peak alone gives
    tests = tiles * probes.TILE * 256 * probes.REPS
    for probe, variant in (("P5", "constant"), ("P6", "immediate")):
        count, _, flop, tc, n_bytes = probes.work(probe, variant, 256, tiles)
        assert (count, flop) == (tests, tests * probes.FLOP_PER_SPHERE_TEST)
        issue = probes.issue_floor_ms(flop)
        assert issue == pytest.approx(12.84, abs=0.005)
        assert probes.bound_ms(flop, n_bytes, tc, issue_ms=issue) == (
            issue, "issue")
        ops_ms, by = probes.bound_ms(flop, n_bytes, tc)
        assert by == "operations" and issue == pytest.approx(2 * ops_ms,
                                                             rel=0.01)
    # P7 a pair: f32 products 2 x (8 multiplies + 7 adds) and the epilogue's
    # 13 (no division: that is the ray's), issued one a lane slot, 5 a ray a
    # round (threshold, division, min), 30 a ray (norms): 22.09 ms; TF32:
    # the epilogue's 13 on the lanes (6.69 ms), the products' 32 a pair on
    # the tensor cores (1.11 ms at 495 TFLOP/s)
    R = tiles * probes.MXU_RAYS
    tests = R * 256 * probes.REPS
    rays = R * probes.REPS * 5 + R * 30
    for variant, f32, on_tc, ms in (("f32", 43, 0, 22.09),
                                    ("tf32", 13, 32, 6.69)):
        count, _, flop, tc, n_bytes = probes.work("P7", variant, 256, tiles)
        assert (count, flop, tc) == (tests, tests * f32 + rays, tests * on_tc)
        issue = probes.issue_floor_ms(flop)
        assert issue == pytest.approx(ms, abs=0.005)
        assert probes.bound_ms(flop, n_bytes, tc, issue_ms=issue) == (
            issue, "issue")
    assert tc / probes.PEAK_TF32_FLOPS * 1e3 == pytest.approx(1.11, abs=0.01)
    assert "P7" in probes.ISSUE_PROBES
    # P3/P4's shared variants: their wavefronts, one a clock an SM, 1024
    # tiles x 32 warps x 64 gathers on 132 SMs at 1980 MHz, 8.02 us where a
    # warp's gather is one wavefront (P3 stride 13, P4), as many times more
    # as the stride's bank conflicts; the __ldg variants: the adds' issue,
    # 63 a thread one a lane slot, 1.97 us
    floor = probes.smem_floor_ms(tiles * 32 * 64)
    assert floor == pytest.approx(8.02e-3, abs=5e-6)
    for stride, ways in zip(probes.GATHER_STRIDES, (1, 2, 8, 8)):
        v = f"shared/stride{stride}"
        assert probes.gather_wavefronts("P3", v, tiles, 64) == (
            tiles * 32 * 64 * ways)
        ms, by = probes.gather_bound("P3", v, tiles, 64)
        assert by == "smem" and ms == pytest.approx(ways * floor, rel=1e-12)
    assert probes.gather_bound("P4", "shared", tiles, 64) == (
        pytest.approx(floor, rel=1e-12), "smem")
    issue = probes.issue_floor_ms(tiles * probes.TILE * 63)
    assert issue == pytest.approx(1.975e-3, abs=1e-6)
    for probe, v in (("P3", "global/stride13"), ("P3", "global/stride32"),
                     ("P4", "global")):
        assert probes.gather_wavefronts(probe, v, tiles, 64) == 0
        assert probes.gather_bound(probe, v, tiles, 64) == (
            pytest.approx(issue, rel=1e-12), "issue")


def test_chain_floor_is_linear_in_n():
    """P1/P2's chain floor is n dependent adds at the measured latency and
    the card's SM clock, linear in n; P1 at 16 384 entries ~33 us."""
    per_add = probes.FADD_LATENCY_CLOCKS / probes.SM_CLOCK_HZ * 1e3
    for n in (1, 128, 256, 16384, 65536):
        assert probes.chain_floor_ms(n) == pytest.approx(n * per_add,
                                                         rel=1e-12)
    assert probes.chain_floor_ms(2 * 4096) == pytest.approx(
        2 * probes.chain_floor_ms(4096), rel=1e-12)
    assert 0.03 < probes.chain_floor_ms(16384) < 0.04


def _staged_gathers(probe, stride, reps, tiles, blocks):
    """P3's and P4's kernels (csrc/probe_kernel.cu ``gather_probe_kernel``,
    ``gather_2d_kernel``) emulated in numpy f32, shared variant: blocks of
    32 warps, warp g = w * blocks + b of the grid's W taking units g,
    g + W, ...; a unit 32 lanes of one row of one tile; the staged copy the
    table followed by its first MAX_GATHERS - 1 entries (rows) again, read
    at s[base + k] with no wrap (numpy raises past its end); unsigned index
    arithmetic, the stride taken mod 256 as the wrapper does; the sum in
    order. Every output element written once."""
    n, lanes = probes.GATHER_N, probes.LANES
    if probe == "P3":
        tab = probes.gather_table("cpu").numpy()[:, 0]
    else:
        tab = probes.gather_2d_table("cpu").numpy()
    staged = np.concatenate([tab, tab[:probes.MAX_GATHERS - 1]])
    stride = np.uint32(stride % n)
    warps, units = 32 * blocks, tiles * probes.TILE // 32
    out = np.full(tiles * probes.TILE, np.nan, np.float32)
    lane = np.arange(32, dtype=np.uint32)
    for w in range(32):
        for b in range(blocks):
            u = np.arange(w * blocks + b, units, warps,
                          dtype=np.uint32)[:, None]
            l = u % np.uint32(lanes // 32) * np.uint32(32) + lane
            r = u % np.uint32(32) // np.uint32(lanes // 32)
            base = (np.uint32(7) * r + stride * l) & np.uint32(n - 1)
            if probe == "P3":
                read = lambda k: staged[base + np.uint32(k)]  # noqa: E731
            else:
                read = lambda k: staged[base + np.uint32(k), l]  # noqa: E731
            acc = read(0)
            for k in range(1, reps):
                acc = acc + read(k)
            at = u * np.uint32(32) + lane
            assert np.isnan(out[at]).all()
            out[at] = acc
    assert not np.isnan(out).any()
    return out.reshape(tiles, probes.ROWS, lanes)


@pytest.mark.parametrize("gathers", [1, probes.MAX_GATHERS])
@pytest.mark.parametrize("probe,stride", [("P3", 13), ("P3", 2), ("P3", 16),
                                          ("P3", 32), ("P3", -3),
                                          ("P4", 13)])
def test_wrap_free_staged_gathers_equal_plain(probe, stride, gathers):
    """The shared kernels' indexing, a staged copy with no wrap read at
    s[base + k] by a persistent grid's warps (5 tiles over 2 blocks: warps
    take 2 or 3 units), equals the plain version bit for bit at strides
    13/2/16/32 (and -3, taken mod 256), at one gather and at the most the
    wrappers allow (MAX_GATHERS, the timed call's 64)."""
    tiles = 5
    got = _staged_gathers(probe, stride, gathers, tiles, blocks=2)
    if probe == "P3":
        want = probes.vmem_gather_plain(probes.gather_table("cpu"), stride,
                                        gathers, tiles)
    else:
        want = probes.vmem_gather_2d_plain(probes.gather_2d_table("cpu"),
                                           gathers, tiles)
    np.testing.assert_array_equal(got, want.numpy())
    assert probes.MAX_GATHERS == probes.GATHER_TIMING_REPS
