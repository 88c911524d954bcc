"""Counter RNG of the port against the JAX package: bits exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_tracing_tpu.ops import hashrng as jrng
from rust_tracing_tpu_torch.ops import hashrng as trng

N = 8192
ULP1 = float(np.spacing(np.float32(1.0)))  # one ulp at 1.0


def _addresses(seed=0):
    rs = np.random.default_rng(seed)
    return (rs.integers(-2**31, 2**31, N).astype(np.int32),   # seeds, <0 too
            rs.integers(0, 2**31, N).astype(np.int32),        # pixels
            rs.integers(0, 1 << 20, N).astype(np.int32),      # samples
            rs.integers(0, 64, N).astype(np.int32))           # bounces


def _pair(arity):
    a = _addresses()[:arity]
    return (jrng.CounterRng(*[jnp.asarray(x) for x in a]),
            trng.CounterRng(*[torch.from_numpy(x) for x in a]))


def test_site_ids_and_weights_match():
    for name in dir(jrng):
        if name.startswith("SITE_"):
            assert getattr(trng, name) == getattr(jrng, name), name
    assert trng._W == jrng._W and trng._SITE_MULT == jrng._SITE_MULT


@pytest.mark.parametrize("arity", [3, 4])
def test_uniform_bits_exact(arity):
    rj, rt = _pair(arity)
    for site in (1, 2, 3, 4, 5, 10, 11, 12, 13, 14, 15, 64, 65, 300):
        a = np.asarray(rj.uniform(site))
        b = rt.uniform(site).numpy()
        assert b.dtype == np.float32
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
        assert (b >= 0).all() and (b < 1).all()


@pytest.mark.parametrize("seed", [0, 7, 0x7FFFFFFF, 0xDEADBEEF, -1, -12345])
def test_scalar_components_fold_like_uint32(seed):
    """Python-int address components (negative i32 seeds included) give the
    bits of their uint32 reinterpretation."""
    pix = _addresses()[1]
    rj = jrng.CounterRng(jnp.uint32(seed & 0xFFFFFFFF), jnp.asarray(pix), 3, 2)
    rt = trng.CounterRng(seed, torch.from_numpy(pix), 3, 2)
    a = np.asarray(rj.uniform(jrng.SITE_SCATTER_Z))
    b = rt.uniform(trng.SITE_SCATTER_Z).numpy()
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def test_int64_tensor_components_wrap():
    pix = torch.from_numpy(_addresses()[1])
    big = pix.to(torch.int64) + (1 << 32)  # same low 32 bits
    a = trng.CounterRng(5, pix, 1).uniform(1)
    b = trng.CounterRng(5, big, 1).uniform(1)
    assert torch.equal(a, b)


@pytest.mark.parametrize("name,sites", [
    ("unit_vector", (10, 11)),
    ("in_unit_sphere", (12, 13, 14)),
    ("in_unit_disk", (3, 4)),
])
def test_composites_within_2ulp(name, sites):
    """sqrt/sin/cos/exp/log differ between the two libraries by an ulp; the
    composites are bounded by 2 ulp of 1.0 (their range is [-1, 1])."""
    rj, rt = _pair(4)
    for a, b in zip(getattr(rj, name)(*sites), getattr(rt, name)(*sites)):
        a, b = np.asarray(a), b.numpy()
        assert np.abs(a - b).max() <= 2 * ULP1
