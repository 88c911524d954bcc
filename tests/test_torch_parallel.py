"""The port's multi-rank path on the CPU (parallel/, megakernel.
render_fast_sharded): ranks are processes under gloo, started by
``parallel.launch.run_ranks`` and running tests/torch_rank_workers.py,
held against the JAX package on a mesh of the same shape (its virtual CPU
devices, tests/conftest.py) and against the port's own one-rank results.

Tolerances and their reasons. A rays-only mesh gives every pixel its whole
sample range on one rank, and the all-reduce adds zeros to it: bit for bit,
with equal ray counts. A split sample axis adds the ranks' f32 means, as the
reference's psum does: rtol 3e-6, atol 3e-7 (tests/test_parallel.py). The
distributed gradient is held to tests/test_parallel.py's tolerances: loss
rtol 2e-5, each float leaf rtol 5e-4 and atol 2e-5 of its largest |g|; the
direct train step to rtol 1e-4 (loss) and rtol 1e-3, atol 1e-6 (the updated
texture). The port's ray counts equal its one-rank count; the reference's
may be larger, since it traces clamped duplicate pixels of its 32x32 tiles.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rust_tracing_tpu_torch as T
import torch_rank_workers as W
from rust_tracing_tpu.ops import megakernel as jmk
from rust_tracing_tpu.parallel import grad_dist as jgrad_dist
from rust_tracing_tpu.parallel import mesh as jmesh
from rust_tracing_tpu.parallel import render_dist as jrender_dist
from rust_tracing_tpu_torch import cli
from rust_tracing_tpu_torch import grad as tg
from rust_tracing_tpu_torch.models.compile import grad_to_numpy
from rust_tracing_tpu_torch.ops import megakernel as mk
from rust_tracing_tpu_torch.parallel import mesh as tmesh
from rust_tracing_tpu_torch.parallel.launch import run_ranks
from torch_port_helpers import both

RANK_TIMEOUT_S = 240.0
GRAD_FIELDS = ("tex_rgb", "sph_center", "sph_radius", "quad_q", "quad_u",
               "mat_albedo", "mat_fuzz", "background")


def _sse(target):
    t = torch.as_tensor(target.reshape(-1, 3), dtype=torch.float32)
    return lambda img, pid: torch.sum((img - t) ** 2)


@pytest.fixture(scope="module")
def setup():
    jscene, jcam, tscene, tcam = both("cornell_box", image_width=16,
                                      samples_per_pixel=W.SPP,
                                      max_depth=W.DEPTH)
    target, _ = T.render(tscene, tcam, seed=99, device="cpu")
    nscene, ncam = W.noise_scene("cpu")
    noise_target, _ = T.render(nscene, ncam, seed=0, spp=W.SPP,
                               max_depth=W.DEPTH, device="cpu")
    return dict(jscene=jscene, jcam=jcam, tscene=tscene, tcam=tcam,
                target=target, noise_target=noise_target)


def _jmesh(n_dev, sp):
    return jmesh.make_mesh(jax.devices()[:n_dev], sample_parallelism=sp)


@pytest.fixture(scope="module")
def results(setup):
    """Everything the module compares, computed once: the two spawns (2
    and 4 ranks) run while this process computes the JAX references and the
    port's one-rank results."""
    jscene, jcam = setup["jscene"], setup["jcam"]
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        two = ex.submit(run_ranks, W.two_ranks, 2, device="cpu",
                        timeout_s=RANK_TIMEOUT_S,
                        args=(setup["target"], setup["noise_target"]))
        four = ex.submit(run_ranks, W.four_ranks, 4, device="cpu",
                         timeout_s=RANK_TIMEOUT_S, args=(setup["target"],))
        out = {}
        for n_dev, sp in ((2, 1), (4, 2)):
            out["jax_render", sp] = jmk.render_fast_sharded(
                jscene, jcam, _jmesh(n_dev, sp), seed=5, interpret=True,
                with_stats=True)
        for sp in (1, 2):
            out["jax_grad", sp] = jgrad_dist.replay_loss_and_grad(
                jscene, jcam, _jmesh(2, sp), setup["target"], seed=7,
                spp=W.SPP, max_depth=W.DEPTH, recorder="xla")
        n_pix = 16 * 16
        step = jrender_dist.make_distributed_train_step(
            _jmesh(2, 2), spp=W.SPP, max_depth=W.DEPTH, learning_rate=0.1)
        out["jax_train"] = step(jscene, jcam.constants(jnp.float32),
                                jnp.arange(n_pix, dtype=jnp.int32),
                                jnp.zeros((n_pix, 3), jnp.float32),
                                jnp.uint32(0))
        out["img"], out["rays"] = mk.render_fast(
            setup["tscene"], setup["tcam"], seed=5, with_stats=True)
        loss, g, out["grad_rays"] = tg.loss_and_grad(
            setup["tscene"], setup["tcam"], _sse(setup["target"]), seed=7,
            with_rays=True)
        out["loss"], out["grad"] = float(loss), grad_to_numpy(g)
        out["ranks2"], out["ranks4"] = two.result(), four.result()
    return out


# ------------------------------------------------------------------- mesh
@pytest.mark.parametrize("world,sp", [(1, 1), (2, 1), (2, 2), (4, 2),
                                      (8, 4)])
def test_mesh_coordinates(world, sp):
    """Rank r sits at (r // sp, r % sp); the rays-shards' ranges tile the
    frame in order, and the ranks of one rays-shard share a range."""
    n_pix = 37 * 23
    seen = {}
    for r in range(world):
        m = tmesh.Mesh(n_rays=world // sp, n_sample=sp, rank=r,
                       device=torch.device("cpu"))
        assert (m.rays_idx, m.sample_idx) == (r // sp, r % sp)
        assert m.shape == {"rays": world // sp, "sample": sp}
        assert m.size == world
        seen.setdefault(m.rays_idx, set()).add(tmesh.shard_range(n_pix, m))
    ranges = [seen[i].pop() for i in range(world // sp)]
    assert all(not s for s in seen.values())
    assert ranges[0][0] == 0
    for (b0, c0), (b1, _) in zip(ranges, ranges[1:]):
        assert b0 + c0 == b1
    assert ranges[-1][0] + ranges[-1][1] == n_pix


@pytest.mark.parametrize("n_pix,n_rays", [(256, 2), (257, 4), (3, 4),
                                          (360000, 3)])
def test_shard_range_partitions(n_pix, n_rays):
    counts = []
    for r in range(n_rays):
        m = tmesh.Mesh(n_rays, 1, r, torch.device("cpu"))
        base, count = tmesh.shard_range(n_pix, m)
        assert base == sum(counts)
        counts.append(count)
    assert sum(counts) == n_pix and max(counts) - min(counts) <= 1


def test_make_mesh_without_process_group():
    m = tmesh.make_mesh(device="cpu")
    assert (m.n_rays, m.n_sample, m.rank) == (1, 1, 0)
    assert tmesh.shard_range(100, m) == (0, 100)
    with pytest.raises(ValueError):
        tmesh.make_mesh(sample_parallelism=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tmesh.make_mesh()  # the GPU is the default; none here


def test_init_distributed_refuses_a_missing_device(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        tmesh.init_distributed()
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", str(torch.cuda.device_count()))
    with pytest.raises(RuntimeError):
        tmesh.init_distributed()
    with pytest.raises(RuntimeError):
        tmesh.init_distributed(device=f"cuda:{torch.cuda.device_count()}")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("base,count", [(0, 256), (0, 100), (100, 156),
                                        (37, 1)])
def test_record_paths_pixel_range_equals_full_frame_rows(setup, base, count):
    """The recorder over a pixel range gives the full frame's records of
    those pixels (the rank's records in grad_dist)."""
    scene, cam = setup["tscene"], setup["tcam"]
    full = mk.record_paths(scene, cam, 7, 2, W.DEPTH, sample_offset=1)
    part = mk.record_paths(scene, cam, 7, 2, W.DEPTH, sample_offset=1,
                           pixel_base=base, pixel_count=count)
    assert part.shape == (W.DEPTH, 2, count)
    assert torch.equal(part, full[:, :, base:base + count])


# ---------------------------------------------------------- sharded render
def test_sharded_render_rays_only_equals_jax(results):
    """2x1: bit for bit the reference's render_fast_sharded (its Pallas
    kernel in interpret mode) on a 2-device mesh, on every rank."""
    jimg, jrays = results["jax_render", 1]
    for img, rays in (r["render", 1] for r in results["ranks2"]):
        np.testing.assert_array_equal(img, np.asarray(jimg))
        assert rays == int(jrays)


def test_sharded_render_sample_split_matches_jax(results):
    """2x2: the ranks' means summed over the sample axis, as the
    reference's psum over a 2x2 mesh."""
    jimg, jrays = results["jax_render", 2]
    for img, rays in (r["render", 2] for r in results["ranks4"]):
        np.testing.assert_allclose(img, np.asarray(jimg), rtol=3e-6,
                                   atol=3e-7)
        assert rays == int(jrays)


@pytest.mark.parametrize("world,sp", [(2, 1), (2, 2), (4, 1), (4, 2)])
def test_sharded_render_equals_render_fast(results, world, sp):
    for img, rays in (r["render", sp] for r in results[f"ranks{world}"]):
        if sp == 1:
            np.testing.assert_array_equal(img, results["img"])
        else:
            np.testing.assert_allclose(img, results["img"], rtol=3e-6,
                                       atol=3e-7)
        assert rays == results["rays"]


@pytest.mark.parametrize("sp", [1, 2])
def test_tensor_path_render_distributed_equals_render(setup, results, sp):
    """render_distributed's tensor-integrator path (use_megakernel=False)
    against the port's one-rank tensor render: the same per-pixel sample
    sums; one rank divides in float64, the mesh in f32 (rtol 1e-6), and a
    split sample axis adds two f32 sums first (rtol 3e-6, atol 3e-7)."""
    ref, _ = T.render(setup["tscene"], setup["tcam"], seed=5,
                      use_megakernel=False, device="cpu")
    for r in results["ranks2"]:
        img = r["tensor_render", sp]
        assert img.dtype == np.float64 and img.shape == ref.shape
        if sp == 1:
            np.testing.assert_allclose(img, ref, rtol=1e-6, atol=0)
        else:
            np.testing.assert_allclose(img, ref, rtol=3e-6, atol=3e-7)


# -------------------------------------------------------- replay gradient
def _assert_grads_agree(g, ref, fields=GRAD_FIELDS):
    for f in fields:
        a = np.asarray(g[f], np.float64)
        b = np.asarray(ref[f], np.float64)
        scale = np.abs(b).max() + 1e-12
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=2e-5 * scale,
                                   err_msg=f)
    assert np.abs(np.asarray(g["tex_rgb"])).max() > 0


@pytest.mark.parametrize("recorder", ["kernel", "xla"])
@pytest.mark.parametrize("sp", [1, 2])
def test_replay_loss_and_grad_matches_jax(results, sp, recorder):
    jl, jg, jrays = results["jax_grad", sp]
    ref = {f: np.asarray(getattr(jg, f)) for f in GRAD_FIELDS}
    for loss, g, rays in (r["grad", sp, recorder]
                          for r in results["ranks2"]):
        np.testing.assert_allclose(loss, float(jl), rtol=2e-5)
        _assert_grads_agree(g, ref)
        assert rays == results["grad_rays"]
        assert jrays >= rays


def test_gradient_is_summed_once(results):
    """One rank, 2x1, 1x2 and 2x2 give the same gradient: |g| does not grow
    with the number of ranks (a second sum would double it)."""
    ref = results["grad"]
    runs = ([r["grad", sp, "kernel"] for r in results["ranks2"]
             for sp in (1, 2)] + [r["grad", 2] for r in results["ranks4"]])
    for loss, g, rays in runs:
        np.testing.assert_allclose(loss, results["loss"], rtol=2e-5)
        _assert_grads_agree(g, ref)
        ratio = np.abs(g["tex_rgb"]).max() / np.abs(ref["tex_rgb"]).max()
        assert abs(ratio - 1.0) < 1e-3
        assert rays == results["grad_rays"]


def test_train_step_matches_jax(setup, results):
    """make_distributed_train_step (the direct estimator) on a 1x2 mesh:
    one SGD step of the SSE to a zero target, against the reference's."""
    jnew, jloss = results["jax_train"]
    for loss, tex in (r["train"] for r in results["ranks2"]):
        np.testing.assert_allclose(loss, float(jloss), rtol=1e-4)
        np.testing.assert_allclose(tex, np.asarray(jnew.tex_rgb), rtol=1e-3,
                                   atol=1e-6)
        moved = np.abs(tex - setup["tscene"].tex_rgb.numpy()).max()
        assert moved > 0


def test_noise_scene_gradient_equals_one_rank(setup, results):
    """tests/test_parallel.py's scene (checker and noise textures: the
    replay runs the turbulence's plain version) on 1x2 against the port's
    one-rank loss_and_grad."""
    nscene, ncam = W.noise_scene("cpu")
    loss, g, rays = tg.loss_and_grad(nscene, ncam,
                                     _sse(setup["noise_target"]), seed=3,
                                     with_rays=True)
    for dloss, dg, drays in (r["noise_grad"] for r in results["ranks2"]):
        np.testing.assert_allclose(dloss, float(loss), rtol=2e-5)
        _assert_grads_agree(dg, grad_to_numpy(g),
                            GRAD_FIELDS[:2] + ("tex_noise_scale",
                                               "mat_albedo", "background"))
        assert drays == rays


def test_replay_train_step_reduces_loss(results):
    """tests/test_parallel.py::test_replay_train_step_reduces_loss on 1x2:
    six steps from a wrong checker colour."""
    r0, r1 = results["ranks2"]
    assert r0["fit_losses"][-1] < r0["fit_losses"][0] * 0.2, r0["fit_losses"]
    assert r0["fit_losses"] == r1["fit_losses"]


# --------------------------------------------------------------- launcher
@pytest.mark.parametrize("fn,timeout_s,err", [
    (W.raise_on_rank_one, RANK_TIMEOUT_S, RuntimeError),
    (W.hang_on_rank_one, 6.0, TimeoutError)])
def test_run_ranks_fails_on_a_failed_or_hung_rank(fn, timeout_s, err):
    with pytest.raises(err, match="rank 1"):
        run_ranks(fn, 2, device="cpu", timeout_s=timeout_s)


# -------------------------------------------------------------------- CLI
def test_cli_distributed_without_torchrun(tmp_path, monkeypatch):
    """--distributed with no torchrun environment renders on a 1x1 mesh:
    the same PNG as the plain render; --multihost fails fast."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    common = ["-s", "6", "--width", "16", "--spp", "2", "--max-depth", "3",
              "--device", "cpu"]
    assert cli.main(common + ["--distributed", "-o",
                              str(tmp_path / "d")]) == 0
    assert cli.main(common + ["-o", str(tmp_path / "p")]) == 0
    assert ((tmp_path / "d.png").read_bytes()
            == (tmp_path / "p.png").read_bytes())
    with pytest.raises(SystemExit, match="torchrun"):
        cli.main(common + ["--multihost", "-o", str(tmp_path / "m")])
