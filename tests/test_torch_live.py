"""The port's live mode on the CPU: checkpoint round trip and resume
exactness (tests/test_live.py), checkpoints read across the two packages,
the terminal viewer's frames and the occupancy telemetry against the JAX
package's, and the CLI's --live --checkpoint resume.

Tolerances: a resumed render continues the same sample streams with the
same float64 update, so it equals the uninterrupted one bit for bit; the
progressive mean against the offline render agrees to the reference's
rtol 3e-6 / atol 3e-7 (another association of the same samples). Frames
and occupancy fractions are equal exactly (integers, and strings of them).
"""

import dataclasses

import numpy as np
import pytest

import rust_tracing_tpu as J
import rust_tracing_tpu_torch as T
from rust_tracing_tpu import renderer as jrenderer
from rust_tracing_tpu.utils import checkpoint as jckpt
from rust_tracing_tpu.utils import viewer as jviewer
from rust_tracing_tpu_torch import cli
from rust_tracing_tpu_torch.renderer import (measure_occupancy,
                                             progressive_init,
                                             progressive_step)
from rust_tracing_tpu_torch.utils import checkpoint as ckpt
from rust_tracing_tpu_torch.utils.viewer import TerminalViewer, frame_ansi


def _build(M):
    """tests/test_live.py::_scene."""
    b = M.SceneBuilder(background=(0.5, 0.6, 0.9))
    b.add_sphere((0, -100.5, -2), 100.0, b.lambertian((0.4, 0.6, 0.3)))
    b.add_sphere((0, 0, -2), 0.5, b.metal((0.9, 0.8, 0.7), 0.1))
    s = M.RenderSettings(
        aspect_ratio=1.0, image_width=16, samples_per_pixel=6, max_depth=3,
        vfov=60.0, look_from=(0, 0, 1), look_at=(0, 0, -2),
        background=(0.5, 0.6, 0.9))
    return b, s


def _scene():
    b, s = _build(T)
    return T.compile_scene(b, device="cpu"), T.Camera.create(s)


def test_checkpoint_roundtrip_and_resume_exactness(tmp_path):
    scene, camera = _scene()
    path = str(tmp_path / "st.npz")
    st = progressive_init(camera, seed=9)
    for _ in range(3):
        st = progressive_step(scene, camera, st, device="cpu")
    ckpt.save(path, st)
    loaded = ckpt.load(path)
    assert loaded.num_samples == 3 and loaded.seed == 9
    np.testing.assert_array_equal(loaded.accum, st.accum)
    for _ in range(3):
        loaded = progressive_step(scene, camera, loaded, device="cpu")
        st = progressive_step(scene, camera, st, device="cpu")
    np.testing.assert_array_equal(loaded.accum, st.accum)
    offline, _ = T.render(scene, camera, seed=9, spp=6, device="cpu")
    np.testing.assert_allclose(loaded.accum, offline, rtol=3e-6, atol=3e-7)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    """The same .npz keys: a checkpoint of either package loads in the
    other, every field equal."""
    rng = np.random.default_rng(3)
    state = T.progressive_init(T.Camera.create(_build(T)[1]), seed=11)
    state = dataclasses.replace(state, num_samples=5,
                                accum=rng.random(state.accum.shape))
    path = str(tmp_path / "c.npz")
    save, load = ((ckpt.save, jckpt.load) if writer == "port"
                  else (jckpt.save, ckpt.load))
    save(path, state)
    got = load(path)
    assert (got.num_samples, got.seed) == (5, 11)
    np.testing.assert_array_equal(got.accum, state.accum)


@pytest.mark.parametrize("shape,cols,rows", [((24, 24), 12, 8),
                                             ((9, 40), 30, 6),
                                             ((50, 17), None, None)])
def test_frame_ansi_equals_jax(shape, cols, rows):
    img = np.random.default_rng(7).random(shape + (3,)) * 1.3
    got = frame_ansi(img, cols=cols, rows=rows)
    assert got == jviewer.frame_ansi(img, cols=cols, rows=rows)
    assert "\x1b[38;2;" in got and "▀" in got


def test_viewer_disabled_outside_tty(capsys):
    TerminalViewer().show(np.zeros((8, 8, 3)), "status")
    assert capsys.readouterr().out == ""


def test_measure_occupancy_equals_jax():
    b, s = _build(J)
    jocc = jrenderer.measure_occupancy(J.compile_scene(b),
                                       J.Camera.create(s), n_pixels=100,
                                       spp=3, seed=4)
    scene, camera = _scene()
    occ = measure_occupancy(scene, camera, n_pixels=100, spp=3, seed=4)
    np.testing.assert_array_equal(occ, np.asarray(jocc))
    assert occ[0] == 1.0 and occ[-1] < 1.0


def _run(tmp_path, name, spp, extra=()):
    out = str(tmp_path / name)
    rc = cli.main(["-s", "6", "--width", "16", "--spp", str(spp),
                   "--max-depth", "3", "--device", "cpu", "--live",
                   "--checkpoint-every", "2", "--preview-every", "2",
                   "-o", out, *extra])
    assert rc == 0
    return out


def test_cli_live_checkpoint_resume(tmp_path):
    """A live render stopped at 3 spp and resumed to 6 ends on the
    uninterrupted 6-spp render's buffer bit for bit; a present but
    unreadable checkpoint is an error."""
    ck, ck_full = str(tmp_path / "ck.npz"), str(tmp_path / "full.npz")
    _run(tmp_path, "a", 3, ("--checkpoint", ck))
    assert ckpt.load(ck).num_samples == 3
    _run(tmp_path, "a", 6, ("--checkpoint", ck))
    out = _run(tmp_path, "b", 6, ("--checkpoint", ck_full))
    resumed, full = ckpt.load(ck), ckpt.load(ck_full)
    assert resumed.num_samples == full.num_samples == 6
    np.testing.assert_array_equal(resumed.accum, full.accum)
    assert (tmp_path / "a.png").read_bytes() == open(out + ".png",
                                                     "rb").read()
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"not a checkpoint")
    with pytest.raises(ValueError):
        _run(tmp_path, "c", 2, ("--checkpoint", str(bad)))


def test_cli_occupancy_and_profile(tmp_path, capsys):
    rc = cli.main(["-s", "6", "--width", "8", "--spp", "1", "--max-depth",
                   "2", "--device", "cpu", "--report-occupancy",
                   "--profile", str(tmp_path / "prof"),
                   "-o", str(tmp_path / "o")])
    assert rc == 0
    assert "occupancy per bounce: 1.000" in capsys.readouterr().out
    assert (tmp_path / "prof" / "trace_rank0.json").stat().st_size > 0
