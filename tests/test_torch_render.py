"""The forward render as a whole: ``render`` of the port on the CPU against the JAX
package's ``render``, the progressive renderer, the CLI, deferred shading of
the noise and image scenes, the BVH and sorted-wavefront branches, and the
port's independence from JAX."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import rust_tracing_tpu as J
import rust_tracing_tpu_torch as T
from rust_tracing_tpu_torch import cli, renderer
from rust_tracing_tpu_torch.models import builders as tbuilders
from torch_port_helpers import MARBLE_PIX_TOL, assert_images_agree, both

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _small(name="cornell_box", width=16, spp=4, depth=3):
    b, s = getattr(tbuilders, name)()
    s = dataclasses.replace(s, image_width=width, samples_per_pixel=spp,
                            max_depth=depth)
    return T.compile_scene(b, device="cpu"), T.Camera.create(s)


@pytest.mark.parametrize("name", ["cornell_box", "quads"])
def test_render_matches_jax_render(name):
    """Entry point to entry point, settings taken from the camera."""
    jscene, jcam, tscene, tcam = both(name, image_width=20,
                                      samples_per_pixel=3, max_depth=4)
    ref, ref_stats = J.render(jscene, jcam, seed=2)
    img, stats = T.render(tscene, tcam, seed=2, device="cpu")
    assert img.dtype == np.float64 and img.shape == (20, 20, 3)
    assert stats.seconds > 0 and stats.rays_per_sec > 0
    assert_images_agree(img, np.asarray(ref), stats.rays, ref_stats.rays)


def test_auto_policy_takes_the_fused_path_on_cpu():
    scene, cam = _small()
    assert renderer.use_megakernel_default(scene, torch.float32, None)
    assert not renderer.use_wavefront_default(scene)
    assert not renderer.use_deferred_default(scene)
    auto, _ = T.render(scene, cam, device="cpu")
    forced, _ = T.render(scene, cam, device="cpu", use_megakernel=True)
    np.testing.assert_array_equal(auto, forced)


def test_progress_callback_and_metrics(tmp_path, monkeypatch):
    from rust_tracing_tpu_torch.utils import metrics

    scene, cam = _small()
    path = tmp_path / "m.jsonl"
    metrics.enable(str(path))
    seen = []
    try:
        T.render(scene, cam, device="cpu", progress=lambda d, t: seen.append((d, t)))
    finally:
        monkeypatch.setenv("RT_METRICS", "0")
        metrics._sink = None
    assert seen == [(256, 256)]
    line = path.read_text().strip().splitlines()[-1]
    assert '"event": "render"' in line and '"path": "megakernel"' in line


def test_progressive_equals_offline():
    """Progressive steps address samples globally, so they accumulate the
    offline render's sample set; the running mean is taken in float64 in
    another order than the kernel's f32 sum, hence the reference's tolerance
    (tests/test_live.py)."""
    scene, cam = _small(spp=6)
    st = T.progressive_init(cam, seed=9)
    for _ in range(3):
        st = T.progressive_step(scene, cam, st, samples=2, device="cpu")
    assert st.num_samples == 6 and st.seed == 9
    offline, _ = T.render(scene, cam, seed=9, spp=6, device="cpu")
    np.testing.assert_allclose(st.accum, offline, rtol=3e-6, atol=3e-7)
    # one step of all samples IS the offline render
    one = T.progressive_step(scene, cam, T.progressive_init(cam, seed=9),
                             samples=6, device="cpu")
    np.testing.assert_array_equal(one.accum, offline)


def test_default_device_needs_a_card():
    """No 'cuda if available else cpu': with no card and no device='cpu' the
    entry points raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal cannot be shown")
    b, _ = tbuilders.cornell_box()
    with pytest.raises(RuntimeError, match="CUDA"):
        T.compile_scene(b)
    scene, cam = _small()
    with pytest.raises(RuntimeError, match="CUDA"):
        T.render(scene, cam)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["-s", "6", "--width", "8", "--spp", "1", "-o", "unused"])


def _big_scene():
    b = T.SceneBuilder(background=(0.5, 0.5, 0.5))
    mat = b.lambertian((0.5, 0.5, 0.5))
    for i in range(renderer.WAVEFRONT_PRIM_THRESHOLD):
        b.add_sphere((i % 32, i // 32, -40.0), 0.4, mat)
    return T.compile_scene(b, device="cpu")


@pytest.mark.parametrize("case", ["hit_fn", "wavefront"])
def test_bvh_and_wavefront_branches_render(case):
    """The tensor render of a scene compiled with a BVH (its default hit
    function is closest_hit_bvh) equals the brute render; a scene of
    WAVEFRONT_PRIM_THRESHOLD spheres takes the sorted wavefront under the
    auto policy and equals the tensor integrator. Both bit for bit as f32,
    with equal ray counts."""
    _, cam = _small(width=12, spp=2, depth=3)
    if case == "hit_fn":
        b, _ = tbuilders.cornell_box()
        scene = T.compile_scene(b, use_bvh=True, device="cpu")
        ref_scene = T.compile_scene(b, device="cpu")
        img, st = T.render(scene, cam, device="cpu", use_megakernel=False)
    else:
        scene = ref_scene = _big_scene()
        assert renderer.use_wavefront_default(scene)
        events = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(renderer.wavefront.metrics, "emit",
                       lambda ev, **kw: events.append(kw))
            img, st = T.render(scene, cam, device="cpu")
        assert events[-1]["path"] == "wavefront_sorted"
    ref, ref_st = T.render(ref_scene, cam, device="cpu", use_megakernel=False)
    np.testing.assert_array_equal(img.astype(np.float32),
                                  ref.astype(np.float32))
    assert st.rays == ref_st.rays and img.mean() > 0.01


@pytest.mark.parametrize("case", [
    "use_megakernel_false", "float64", "deferred_noise", "deferred_image",
    "render_deferred", "fused_noise"])
def test_texture_branches_render(case):
    """The noise and image families render on every path of the port: the
    tensor integrator (f32 and float64), deferred shading under the auto
    policy and called directly, and the fused kernel's own noise."""
    kw = {}
    if case == "use_megakernel_false":
        scene, cam = _small("two_perlin_spheres")
        kw = dict(use_megakernel=False)
    elif case == "float64":
        b, s = tbuilders.earth()
        s = dataclasses.replace(s, image_width=8, samples_per_pixel=1,
                                max_depth=2)
        scene = T.compile_scene(b, dtype=torch.float64, device="cpu")
        cam = T.Camera.create(s)
        kw = dict(dtype=torch.float64)
    elif case in ("deferred_noise", "fused_noise", "render_deferred"):
        scene, cam = _small("two_perlin_spheres")
        kw = dict(use_megakernel=True) if case == "fused_noise" else {}
    elif case == "deferred_image":
        scene, cam = _small("earth")
    if case == "render_deferred":
        img, stats = renderer.render_deferred(scene, cam)
    else:
        img, stats = T.render(scene, cam, device="cpu", **kw)
    assert img.shape == (cam.image_height, cam.image_width, 3)
    assert np.isfinite(img).all() and img.mean() > 0.05
    assert stats.rays >= cam.image_width * cam.image_height


@pytest.fixture(scope="module")
def texture_scenes():
    return {name: _small(name, spp=3)
            for name in ("two_perlin_spheres", "simple_light", "earth")}


@pytest.mark.parametrize("name", ["two_perlin_spheres", "simple_light",
                                  "earth"])
def test_deferred_equals_tensor_integrator(texture_scenes, name):
    """Deferred shading (recorder + replay) is the tensor integrator's
    estimator: images and ray counts equal bit for bit, as replay equals
    direct in the reference. The auto policy takes it for these scenes. The
    tensor render divides its f32 sample sums by spp in float64 on the host,
    deferred shading in f32, so the two images are equal as f32."""
    scene, cam = texture_scenes[name]
    assert renderer.use_deferred_default(scene)
    img, stats = T.render(scene, cam, seed=4, device="cpu")
    direct, dstats = T.render(scene, cam, seed=4, device="cpu",
                              use_megakernel=False)
    np.testing.assert_array_equal(img.astype(np.float32),
                                  direct.astype(np.float32))
    assert stats.rays == dstats.rays


def test_deferred_matches_jax_direct_estimator():
    """Against the reference's direct estimator (its deferred path's
    contract), on a scene of every texture family: the image on a sphere,
    the marble on a far ground sphere, checkers with noise and image
    children. The marble carries XLA's contracted argument
    (torch_port_helpers.MARBLE_PIX_TOL)."""
    import jax.numpy as jnp

    from rust_tracing_tpu import grad as jgrad

    jscene, jcam, tscene, tcam = both("textures", image_width=16,
                                      samples_per_pixel=2, max_depth=3)
    n_pix = tcam.image_width * tcam.image_height
    ref, ref_rays = jgrad.radiance_mean_rays(
        jscene, jcam.constants(jnp.float32),
        jnp.arange(n_pix, dtype=jnp.int32), jnp.uint32(3), 2, 3)
    img, stats = T.render(tscene, tcam, seed=3, device="cpu")
    assert renderer.use_deferred_default(tscene)
    assert_images_agree(img.reshape(-1, 3), np.asarray(ref), stats.rays,
                        int(float(ref_rays)), pix_tol=MARBLE_PIX_TOL)


def test_progressive_deferred_equals_offline(texture_scenes):
    """Progressive steps of a noise scene go through deferred shading with
    a sample offset and accumulate the offline render's sample set."""
    scene, cam = texture_scenes["simple_light"]
    st = T.progressive_init(cam, seed=2)
    for _ in range(3):
        st = T.progressive_step(scene, cam, st, samples=1, device="cpu")
    offline, _ = T.render(scene, cam, seed=2, spp=3, device="cpu")
    np.testing.assert_allclose(st.accum, offline, rtol=3e-6, atol=3e-7)


def test_cli_renders_texture_scene_on_cpu(tmp_path, capsys):
    out = str(tmp_path / "simple_light")
    rc = cli.main(["-s", "5", "--device", "cpu", "--width", "32", "--spp",
                   "4", "-o", out])
    assert rc == 0 and os.path.exists(out + ".png")
    assert "Mrays/s" in capsys.readouterr().out


def test_scene_on_other_device_is_refused():
    """render moves nothing silently: the scene must live on the device the
    render is asked for."""
    scene, cam = _small()
    with pytest.raises(ValueError, match="scene is on cpu"):
        T.render(scene, cam, device="meta")


def test_cli_writes_png_on_cpu(tmp_path, capsys):
    out = str(tmp_path / "cornell")
    rc = cli.main(["-s", "6", "--width", "16", "--spp", "2", "--max-depth",
                   "3", "--seed", "4", "--device", "cpu", "-o", out])
    assert rc == 0
    from PIL import Image

    with Image.open(out + ".png") as im:
        assert im.size == (16, 16) and im.mode == "RGB"
        px = np.asarray(im)
    assert px.max() > 0  # the light is in view
    text = capsys.readouterr().out
    assert "18 quads" in text and "Mrays/s" in text
    # the PNG is the gamma-encoded render of the same settings
    scene, cam = _small(width=16, spp=2, depth=3)
    img, _ = T.render(scene, cam, seed=4, device="cpu")
    from rust_tracing_tpu_torch.utils.color import color_to_rgb8

    np.testing.assert_array_equal(px, color_to_rgb8(img))


def test_cli_unknown_scene():
    with pytest.raises(ValueError, match="unknown scene index"):
        cli.main(["-s", "12", "--device", "cpu"])


def test_port_imports_without_jax():
    """The package and chip_smoke import with ``jax`` and ``rust_tracing_tpu``
    blocked; chip_smoke then refuses to run without a CUDA device."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['rust_tracing_tpu'] = None\n"
        "import torch\n"
        "import rust_tracing_tpu_torch as T\n"
        "from rust_tracing_tpu_torch import cli, renderer, camera, grad\n"
        "from rust_tracing_tpu_torch.ops import megakernel, hashrng, perlin\n"
        "from rust_tracing_tpu_torch.ops import perlin_fused\n"
        "from rust_tracing_tpu_torch.ops import linalg, lanegather, tgather\n"
        "from rust_tracing_tpu_torch.ops import intersect, textures\n"
        "from rust_tracing_tpu_torch.ops import materials, integrator, replay\n"
        "from rust_tracing_tpu_torch.ops import wavefront, bvh_traverse\n"
        "from rust_tracing_tpu_torch.models import builders, bvh, compile\n"
        "from rust_tracing_tpu_torch.runtime import kernels\n"
        "b, s = builders.build_scene(6)\n"
        "sc = T.compile_scene(b, device='cpu')\n"
        "s = s.__class__(**{**s.__dict__, 'image_width': 8})\n"
        "grad.loss_and_grad(sc, T.Camera.create(s), lambda im, p: im.mean(),"
        " spp=1, max_depth=2)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('rust_tracing_tpu.')]\n"
        "assert not [m for m in bad if sys.modules[m] is not None], bad\n"
        "print('PORT_OK')\n"
        "torch.cuda.is_available = lambda: True\n"
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke',"
        " 'chip_smoke.py')\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "assert callable(mod.main)\n"
        "print('SMOKE_IMPORT_OK')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "PORT_OK" in res.stdout and "SMOKE_IMPORT_OK" in res.stdout


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal cannot be shown")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
