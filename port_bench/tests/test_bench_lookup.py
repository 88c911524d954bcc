"""BENCHMARK.json against the contract's shape, and every piece of a cell
found by name: a cell added by files and an entry alone runs."""

import json
import os
import re
import shutil

import pytest

from port_bench import harness, lookup

from .conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_spec_keys_and_names(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in spec[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for c in spec["configs"]:
        assert c["file"].startswith(spec["paths"][0] + "/")
        assert all(NAME.match(k) for k in c["reduced"])


def test_every_cell_has_its_files_and_metrics(spec):
    for w in spec["workloads"]:
        cell = lookup.find_cell(ROOT, w["name"])
        for f in ("draw", "run", "numbers", "answer"):
            assert callable(getattr(cell.kind, f))
        assert callable(cell.module("scenes", cell.cfg["scene"]).build)
        assert set(cell.limits) and all(v >= 0 for v in cell.limits.values())
        e2e = harness.end_to_end_of(cell)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert harness.per_layer_of(cell)
        for m in e2e + harness.per_layer_of(cell):
            assert callable(harness.load_reader(cell.base, m["name"]))


# main.rs scene 3 (quads), in the reference's terms: five Lambertian quads
QUADS_SCENE = """
from port_bench.reference.scenes import Scene


def build(cfg):
    s = Scene(cfg["background"])
    for q, u, v, rgb in [((-3, -2, 5), (0, 0, -4), (0, 4, 0), (1.0, 0.2, 0.2)),
                         ((-2, -2, 0), (4, 0, 0), (0, 4, 0), (0.2, 1.0, 0.2)),
                         ((3, -2, 1), (0, 0, 4), (0, 4, 0), (0.2, 0.2, 1.0)),
                         ((-2, 3, 1), (4, 0, 0), (0, 0, 4), (1.0, 0.5, 0.0)),
                         ((-2, -3, 5), (4, 0, 0), (0, 0, -4), (0.2, 0.8, 0.8))]:
        s.quad(q, u, v, s.lambertian(rgb))
    return s
"""

QUADS_CONFIG = {
    "scene": "quads", "precision": "float32", "image_width": 16,
    "aspect_ratio": 1.0, "samples_per_pixel": 4, "max_depth": 8,
    "vfov": 80.0, "look_from": [0.0, 0.0, 9.0], "look_at": [0.0, 0.0, 0.0],
    "vup": [0.0, 1.0, 0.0], "defocus_angle": 0.0, "focus_dist": 10.0,
    "background": [0.7, 0.8, 1.0], "geometry_seed": None}

# a new loop: each frame as two renders of half its samples, averaged on
# the host; drawn and judged as the frames kind draws and judges a frame
HALVES_KIND = """
import dataclasses
import time

from port_bench.kinds import frames

draw, numbers, answer = frames.draw, frames.numbers, frames.answer


def run(drv, u):
    h = u.spp // 2
    t0 = time.perf_counter()
    parts = [drv.prog["renderer"].render(
        drv.scene, drv.camera, seed=u.seed, spp=n, sample_offset=s0,
        device=drv.dev) for s0, n in ((u.sample0, h), (u.sample0 + h, u.spp - h))]
    flat = ((parts[0][0] * h + parts[1][0] * (u.spp - h)) / u.spp).reshape(-1, 3)
    p = u.kept["pixels"]
    return dataclasses.replace(
        u, rays=sum(int(st.rays) for _, st in parts),
        seconds=time.perf_counter() - t0,
        kept=dict(pixels=p, values=flat[p].copy()))
"""


@pytest.mark.parametrize("new", ["mix", "scene_and_kind"])
def test_a_cell_added_by_files_and_an_entry_alone(tmp_path, new):
    """A new cell by new files and entries in BENCHMARK.json, and no file
    of the harness edited: a new mix of a kind the harness has on a
    configuration it has; or a new scene (the reference's builder and its
    configuration) under a new kind of traffic."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "port_bench"), root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    pb = root / "port_bench"
    if new == "mix":
        name, config = "cornell_box.dummy", "cornell_box"
        mix = {"kind": "frames", "spp": 3, "call": {"use_megakernel": True},
               "progressive": True, "check": {"units": 2, "pixels": 256},
               "trace": {"units": 2}}
        limits = {"pixel_gap": 0.0, "rays_gap": 0.0}
    else:
        name, config = "quads.halves", "quads"
        (pb / "scenes/quads.py").write_text(QUADS_SCENE)
        (pb / "kinds/halves.py").write_text(HALVES_KIND)
        (pb / "configs/quads.json").write_text(json.dumps(QUADS_CONFIG))
        spec["configs"].append({
            "name": "quads", "source": "main.rs scene 3 (quads)",
            "file": "port_bench/configs/quads.json", "reduced": [],
            "why": "a test's configuration"})
        mix = {"kind": "halves", "spp": 4, "progressive": False,
               "check": {"units": 2, "pixels": 256}, "trace": {"units": 2}}
        limits = {"pixel_gap": 1e-5, "rays_gap": 0.0}
    spec["workloads"].append({"name": name, "config": config,
                              "traffic": name.split(".")[1], "chips": 1,
                              "why": "a test's cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "cornell_box.offline" in m.get("workloads", []):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    (pb / "traffic" / (name.split(".")[1] + ".json")).write_text(
        json.dumps(mix))
    (pb / "limits" / (name + ".json")).write_text(json.dumps(limits))
    cell = lookup.find_cell(str(root), name)
    assert cell.mix == mix
    res, lines = harness.run_cell(str(root), name, 7, 0.2, False, 0.0,
                                  device="cpu",
                                  overrides={"cfg": {"image_width": 16}})
    assert res["correct"], lines
    assert res["attempted"] >= 1
    assert set(res["metrics"]) == {"offline_samples_per_s", "setup_s"}
    assert list(res)[-1] == "checks"
