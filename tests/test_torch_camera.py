"""Camera of the port against the JAX package."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rust_tracing_tpu as J
import rust_tracing_tpu_torch as T
from rust_tracing_tpu.camera import get_rays as jget_rays
from rust_tracing_tpu.models import builders as jbuilders
from rust_tracing_tpu_torch.camera import constants_from_numpy, get_rays
from rust_tracing_tpu_torch.models import builders as tbuilders

VEC_FIELDS = ("center", "pixel00_loc", "pixel_delta_u", "pixel_delta_v",
              "defocus_disk_u", "defocus_disk_v")


def _cams(name, width):
    js = dataclasses.replace(getattr(jbuilders, name)()[1], image_width=width)
    ts = dataclasses.replace(getattr(tbuilders, name)()[1], image_width=width)
    return J.Camera.create(js), T.Camera.create(ts)


@pytest.mark.parametrize("name", ["cornell_box", "random_balls", "quads"])
def test_camera_basis_equal(name):
    """Host-side float64 precomputation: exactly equal."""
    jc, tc = _cams(name, 40)
    for f in dataclasses.fields(jc):
        a, b = getattr(jc, f.name), getattr(tc, f.name)
        if f.name in VEC_FIELDS:
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f.name


def test_settings_defaults_equal():
    a = dataclasses.asdict(J.RenderSettings())
    b = dataclasses.asdict(T.RenderSettings())
    assert a == b
    assert J.RenderSettings().image_height == T.RenderSettings().image_height


@pytest.mark.parametrize("name", ["cornell_box", "random_balls"])
def test_get_rays_within_2ulp(name):
    """cornell (pinhole) and the random_balls defocus camera. XLA may contract
    the pixel-sample multiply-adds and its sqrt/sin/cos differ by an ulp, so
    each component is bounded by 2 ulp of the largest magnitude involved."""
    jc, tc = _cams(name, 48)
    n = jc.image_width * jc.image_height
    rs = np.random.default_rng(1)
    ids = rs.integers(0, n, 4096).astype(np.int32)
    jconst = jc.constants(jnp.float32)
    # constants cross as numpy arrays of the JAX leaves
    tconst = constants_from_numpy(
        **{f: np.asarray(getattr(jconst, f)) for f in VEC_FIELDS},
        defocus_angle=jconst.defocus_angle, image_width=jconst.image_width,
        device="cpu")
    for f in VEC_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(jconst, f)),
            getattr(tc.constants(device="cpu"), f).numpy())
    for sample in (0, 5):
        jo, jd, jt = jget_rays(jconst, jnp.uint32(9), jnp.asarray(ids), sample)
        to, td, tt = get_rays(tconst, 9, torch.from_numpy(ids), sample)
        np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
        for a, b in ((jo, to), (jd, td)):
            a, b = np.asarray(a), b.numpy()
            assert a.shape == b.shape == (4096, 3)
            scale = np.float32(max(np.abs(a).max(),
                                   np.abs(jc.pixel00_loc).max()))
            assert np.abs(a - b).max() <= 2 * np.spacing(scale)


def test_constants_default_device_needs_a_card():
    """device=None means the GPU: without one it raises, it does not fall
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal cannot be shown")
    _, tc = _cams("cornell_box", 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        tc.constants()
