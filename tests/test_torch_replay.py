"""Record/replay in the port (ops/replay.py, the recorder's plain version in
ops/megakernel.py) on the CPU: the winner records against the JAX package's
``records_xla`` and its Pallas recorder in interpret mode, exactly; and
inside the port, replay against the direct estimator.

Replay equals direct bit for bit in images and ray counts, and in the
gradients of every leaf whose cotangent both paths sum through the same
gathers (tex_rgb, mat_albedo, sph_center, quad_u). The background's
gradient is summed over all rays in two shapes, a (R,3) column reduction in
the direct path and three (R,) reductions in the replay, so it is held to
rtol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_tracing_tpu.ops import megakernel as jmk
from rust_tracing_tpu.ops import replay as jreplay
from rust_tracing_tpu_torch import grad as tg
from rust_tracing_tpu_torch.ops import megakernel as tmk
from rust_tracing_tpu_torch.ops import replay as treplay
from torch_port_helpers import both

_j_records = jax.jit(jreplay.records_xla, static_argnums=(4, 5))


@pytest.mark.parametrize("name,kw", [
    ("cornell_box", dict(image_width=16, samples_per_pixel=2, max_depth=4)),
    ("cornell_smoke", dict(image_width=16, samples_per_pixel=1,
                           max_depth=4)),
    ("mixed", dict(samples_per_pixel=1)),
])
def test_records_equal_jax_and_recorder(name, kw):
    """port records_xla == JAX records_xla == the recorder's plain version,
    every record, at a sample offset."""
    jscene, jcam, tscene, tcam = both(name, **kw)
    n = jcam.image_width * jcam.image_height
    spp, depth = jcam.samples_per_pixel, jcam.max_depth
    ref = np.asarray(_j_records(jscene, jcam.constants(jnp.float32),
                                jnp.arange(n, dtype=jnp.int32),
                                jnp.uint32(7), spp, depth, None, 3))
    pid = torch.arange(n, dtype=torch.int32)
    port = treplay.records_xla(tscene, tcam.constants(device="cpu"), pid, 7,
                               spp, depth, sample_offset=3)
    plain = tmk.record_paths(tscene, tcam, 7, spp, depth, sample_offset=3)
    assert plain.shape == (depth, spp, n) and plain.dtype == torch.int32
    np.testing.assert_array_equal(port.numpy(), ref)
    np.testing.assert_array_equal(plain.numpy(), ref)
    kinds = set(np.unique(ref >> 24).tolist())
    assert {0, 2 if name != "mixed" else 1} <= kinds
    if name != "cornell_box":
        assert max(kinds) >= treplay.KIND_MEDIUM  # a medium won somewhere


def test_recorder_plain_equals_pallas_interpret():
    jscene, jcam, tscene, tcam = both("cornell_box", image_width=8,
                                      samples_per_pixel=2, max_depth=3)
    ref = np.asarray(jmk.record_paths(jscene, jcam, -5, 2, 3, interpret=True))
    np.testing.assert_array_equal(
        tmk.record_paths(tscene, tcam, -5, 2, 3).numpy(), ref)


def test_pack_unpack_roundtrip():
    kind = torch.tensor([0, 1, 2, 3, 5], dtype=torch.int32)
    idx = torch.tensor([0, 7, (1 << 24) - 1, 0, 0], dtype=torch.int32)
    k, i = treplay.unpack_record(treplay.pack_record(kind, idx))
    assert k.tolist() == kind.tolist() and i.tolist() == idx.tolist()


@pytest.mark.parametrize("name", ["cornell_box", "cornell_smoke"])
def test_replay_equals_direct(name):
    _, _, scene, cam = both(name, image_width=16, samples_per_pixel=3,
                            max_depth=4)
    c = cam.constants(device="cpu")
    pid = torch.arange(256, dtype=torch.int32)
    recs = treplay.records_xla(scene, c, pid, 5, 3, 4)
    img_r, n_r = tg.radiance_mean_replay_rays(scene, c, pid, 5, recs, 3, 4)
    img_d, n_d = tg.radiance_mean_rays(scene, c, pid, 5, 3, 4)
    assert torch.equal(img_r, img_d)
    assert int(n_r) == int(n_d) > 0


def test_replay_gradients_equal_direct():
    _, _, scene, cam = both("cornell_box", image_width=16,
                            samples_per_pixel=4, max_depth=4)
    w = torch.tensor([1.0, 2.0, 0.5])

    def loss_fn(im, p):
        return torch.mean(im * w)

    l1, g1 = tg.loss_and_grad(scene, cam, loss_fn, seed=5, spp=4,
                              max_depth=4, use_recorder=False)
    l2, g2 = tg.loss_and_grad(scene, cam, loss_fn, seed=5, spp=4,
                              max_depth=4, use_recorder=True)
    assert float(l1) == float(l2)
    assert g1.tex_rgb.abs().max() > 0
    for f in ("tex_rgb", "mat_albedo", "sph_center", "quad_u"):
        assert torch.equal(getattr(g1, f), getattr(g2, f)), f
    np.testing.assert_allclose(g1.background.numpy(), g2.background.numpy(),
                               rtol=1e-6)
