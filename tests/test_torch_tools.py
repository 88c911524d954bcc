"""The port's tools on the CPU (bench.py, entry.py, final_scene_full.py),
held against the JAX package and against themselves.

- The bench at 16 px, 2 spp, depth 3 (parity 8 px @ 4 spp): its line has
  the reference's keys, metric name and denominator (bench.py); its
  headline loss agrees with the reference's ``loss_and_grad(...,
  with_rays=True, linear_loss=True)`` at the same seed to rtol 1e-6 (the
  loss tolerance of test_torch_grad.py::_assert_matches_jax: the same
  estimator, another summation order), and its ray count equals the
  reference's as an integer.
- The entry's fn over its 1024 pixel ids against
  ``__graft_entry__.entry()``'s fn over the same ids (imported by path; not
  edited), to torch_port_helpers.assert_images_agree's image tolerance.
  The first 64 (the top row of the 64 px frame) are black in both.
- ``dryrun_multichip(2, device="cpu")``: two ranks under gloo with its own
  gates (sharded == one rank to rtol 2e-5 / atol 2e-6, plausible losses),
  started at the module's first test so it runs beside the others.
- final_scene in slices: stopped after one slice and resumed, it equals an
  uninterrupted run bit for bit (a float64 running mean saved losslessly),
  and ``render(spp=2)`` of the same frame to rtol 1e-6 (an f32 sum of two
  samples against their float64 mean; radiance is never negative, so the
  error is relative).
- Every entry point raises without a card unless ``device="cpu"``.
"""

import concurrent.futures
import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rust_tracing_tpu as J
import rust_tracing_tpu_torch as T
from rust_tracing_tpu import grad as jgrad
from rust_tracing_tpu.models import builders as jbuilders
from rust_tracing_tpu_torch import bench, entry, final_scene_full
from rust_tracing_tpu_torch import run_workloads
from rust_tracing_tpu_torch.models import builders as tbuilders
from torch_port_helpers import assert_images_agree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 240.0
BENCH_SIZE = dict(width=16, spp=2, max_depth=3, parity_width=8,
                  parity_spp=4, repeats=1)


def _by_path(name):
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", os.path.join(REPO, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def dryrun():
    """The two-rank dry run, started before this module's first test and
    read by test_dryrun_multichip_on_cpu."""
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        yield ex.submit(entry.dryrun_multichip, 2, device="cpu",
                        timeout_s=RANK_TIMEOUT_S)


def test_bench_line_matches_jax():
    ref_bench = _by_path("bench")
    res = bench.run(device="cpu", **BENCH_SIZE)
    line = json.loads(json.dumps(res))
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "aux"}
    assert line["metric"] == "cornell600_200spp_fwdbwd_rays_per_sec_per_chip"
    assert line["unit"] == "rays/s"
    assert bench.REFERENCE_CPU_RAYS_PER_SEC == \
        ref_bench.REFERENCE_CPU_RAYS_PER_SEC
    aux = line["aux"]
    assert {"fwdbwd_workload", "fwdbwd_l2_rays_per_sec",
            "forward_rays_per_sec", "forward_vs_baseline", "forward_seconds",
            "forward_path", "parity_ratio_megakernel_vs_xla", "avg_bounces",
            "device"} <= set(aux)
    assert aux["forward_path"] == "megakernel" and aux["device"] == "cpu"
    assert abs(1.0 - aux["parity_ratio_megakernel_vs_xla"]) < 0.01
    assert aux["fwdbwd_seeds"] == [1]
    rays, secs = aux["fwdbwd_rays"][0], aux["fwdbwd_seconds"][0]
    assert line["value"] == round(rays / secs)

    b, s = jbuilders.cornell_box()
    s = dataclasses.replace(s, image_width=16, samples_per_pixel=2,
                            max_depth=3)
    jloss, _, jrays = jgrad.loss_and_grad(
        J.compile_scene(b), J.Camera.create(s), lambda im, p: jnp.mean(im),
        seed=1, spp=2, max_depth=3, with_rays=True, linear_loss=True)
    np.testing.assert_allclose(aux["fwdbwd_loss"][0], float(jloss),
                               rtol=1e-6)
    assert isinstance(rays, int) and rays == int(float(jrays))


def test_entry_matches_graft_entry():
    fn, (scene, cam, pixel_ids, seed) = entry.entry(device="cpu")
    assert tuple(pixel_ids.shape) == (1024,)
    got = fn(scene, cam, pixel_ids, seed).numpy()
    jfn, (jscene, jcam, jpix, jseed) = _by_path("__graft_entry__").entry()
    ref = np.asarray(jax.jit(jfn)(jscene, jcam, jpix, jseed))
    # the first 64 ids (the frame's top row) are black at this size; the
    # whole chunk holds the lit pixels
    assert not ref[:64].any() and not got[:64].any()
    assert_images_agree(got, ref)


def test_dryrun_multichip_on_cpu(dryrun):
    out = dryrun.result()
    assert [r["rank"] for r in out] == [0, 1]
    for r in out:
        assert r["mesh"] == {"rays": 1, "sample": 2} and r["device"] == "cpu"
        assert r["loss"] == out[0]["loss"]
        assert r["replay_loss"] == out[0]["replay_loss"]


def test_final_scene_slices_resume_bitwise(tmp_path):
    kw = dict(spp=2, slice_spp=1, max_depth=4, device="cpu", image_width=16)
    first = final_scene_full.run(out_dir=str(tmp_path / "cut"),
                                 stop_after=1, **kw)
    assert first["slices_done"] == 1 and not first["complete"]
    resumed = final_scene_full.run(out_dir=str(tmp_path / "cut"), **kw)
    whole = final_scene_full.run(out_dir=str(tmp_path / "whole"), **kw)
    assert resumed["complete"] and whole["complete"]
    assert resumed["path"] == "wavefront_sorted"
    np.testing.assert_array_equal(resumed["accum"], whole["accum"])
    assert resumed["rays"] == whole["rays"]
    for name in (final_scene_full.PNG_NAME, run_workloads.TABLE_NAME):
        assert os.path.exists(tmp_path / "cut" / name)

    b, s = tbuilders.final_scene()
    s = dataclasses.replace(s, image_width=16, max_depth=4)
    img, stats = T.render(T.compile_scene(b, device="cpu"),
                          T.Camera.create(s), seed=0, spp=2, device="cpu")
    np.testing.assert_allclose(whole["accum"], img, rtol=1e-6, atol=0)
    assert whole["rays"] == stats.rays


@pytest.mark.parametrize("call", [
    lambda: bench.run(**BENCH_SIZE),
    lambda: entry.entry(),
    lambda: entry.dryrun_multichip(2),
    lambda: run_workloads.run(scenes=()),
    lambda: final_scene_full.run(spp=1, slice_spp=1),
], ids=["bench", "entry", "dryrun_multichip", "run_workloads",
        "final_scene_full"])
def test_entry_points_need_a_card_by_default(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_port_imports_nothing_of_the_reference():
    """No module of the port imports jax, the JAX package, the reference's
    bench or entry point, or anything under scripts/ (the tools' modules
    included); tests/test_torch_render.py runs the package without JAX."""
    import ast

    banned = {"jax", "rust_tracing_tpu", "bench", "__graft_entry__",
              "scripts"}
    pkg = os.path.join(REPO, "rust_tracing_tpu_torch")
    found = []
    for root, _, files in os.walk(pkg):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            for node in ast.walk(ast.parse(open(path).read())):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    mods = [node.module]
                else:
                    continue
                found += [(path, m) for m in mods
                          if m.split(".")[0] in banned]
    assert not found, found
