"""The port's closed-form samplers (ops/rng.py) on the CPU, held by the
distribution laws of tests/test_math_core.py::TestRng at the same sample
counts and thresholds, and against the JAX package's samplers by a
two-sample comparison: the empirical radius quantiles (0.3, 0.6, 0.9) of
20 000 draws each agree to 0.02 (about six standard errors of their
difference). The streams are PyTorch's and JAX's own, so no bits are
compared."""

import jax
import numpy as np
import pytest
import torch

from rust_tracing_tpu.ops import rng as jrng
from rust_tracing_tpu_torch.ops import rng as trng

N = 20000


def _gen(seed):
    return torch.Generator(device="cpu").manual_seed(seed)


def test_uniform_range_and_mean():
    u = trng.uniform(_gen(4), (N,), minval=-1.0, maxval=3.0).numpy()
    assert u.dtype == np.float32 and u.min() >= -1.0 and u.max() < 3.0
    assert abs(u.mean() - 1.0) < 0.04  # 4 sd of the mean of U[-1, 3)


def test_unit_vector_on_sphere():
    v = trng.random_unit_vector(_gen(0), (N,)).numpy()
    np.testing.assert_allclose(np.linalg.norm(v, axis=-1), 1.0, atol=1e-5)
    # uniform on S^2: mean ~ 0, second moment = I/3
    assert np.abs(v.mean(0)).max() < 0.02
    np.testing.assert_allclose((v[:, :, None] * v[:, None, :]).mean(0),
                               np.eye(3) / 3, atol=0.01)


def test_in_unit_sphere_radius_law():
    v = trng.random_in_unit_sphere(_gen(1), (N,)).numpy()
    r = np.linalg.norm(v, axis=-1)
    assert r.max() <= 1.0
    # P(R <= r) = r^3 for the uniform ball
    for q in (0.3, 0.6, 0.9):
        assert abs((r <= q).mean() - q**3) < 0.015


def test_in_unit_disk():
    v = trng.random_in_unit_disk(_gen(2), (N,)).numpy()
    assert np.all(v[:, 2] == 0.0)
    r = np.linalg.norm(v[:, :2], axis=-1)
    assert r.max() <= 1.0
    for q in (0.3, 0.6, 0.9):
        assert abs((r <= q).mean() - q**2) < 0.015


def test_on_hemisphere():
    n = torch.tensor([0.0, 0.0, 1.0]).expand(5000, 3)
    v = trng.random_on_hemisphere(_gen(3), n).numpy()
    assert (v[:, 2] > 0).all()
    np.testing.assert_allclose(np.linalg.norm(v, axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("name,radius", [
    ("random_in_unit_sphere", lambda v: np.linalg.norm(v, axis=-1)),
    ("random_in_unit_disk", lambda v: np.linalg.norm(v[:, :2], axis=-1)),
])
def test_radius_quantiles_match_jax(name, radius):
    r_t = radius(getattr(trng, name)(_gen(5), (N,)).numpy())
    draw = jax.jit(getattr(jrng, name), static_argnums=1)
    r_j = radius(np.asarray(draw(jax.random.PRNGKey(5), (N,))))
    qs = (0.3, 0.6, 0.9)
    np.testing.assert_allclose(np.quantile(r_t, qs), np.quantile(r_j, qs),
                               atol=0.02)
