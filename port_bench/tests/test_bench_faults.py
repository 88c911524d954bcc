"""A whole run on the CPU (the harness's look for a card skipped) with the
timed path broken underneath: ``correct`` comes out false for each fault a
cell can have, and true with the program as it is."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from port_bench import driver, harness

from .conftest import ROOT


def _run(cell, tiny, prog=None, seed=21, trace=False):
    res, lines = harness.run_cell(ROOT, cell, seed, 0.1, trace, 0.0,
                                  device="cpu", overrides=tiny(cell),
                                  program=prog)
    return res


def _with(prog, **mods):
    out = dict(prog)
    for name, fns in mods.items():
        out[name] = types.SimpleNamespace(**{
            k: getattr(prog[name], k) for k in dir(prog[name])
            if not k.startswith("__")})
        for k, fn in fns.items():
            setattr(out[name], k, fn)
    return out


def _render_faults(prog):
    render = prog["renderer"].render
    first = {}

    def altered(*a, **k):
        img, st = render(*a, **k)
        return img * (1.0 + 1e-3), st

    def half(*a, spp, **k):  # half the samples, the mean over the rest
        return render(*a, spp=max(1, spp // 2), **k)

    def unchanged(*a, **k):  # every call returns the first call's frame
        if "img" not in first:
            first["img"] = render(*a, **k)
        return first["img"]

    return {"altered": altered, "half": half, "unchanged": unchanged}


def _grad_faults(prog):
    lg = prog["grad"].loss_and_grad

    def zero_leaves(g):
        return g.replace(**{f.name: getattr(g, f.name) * 0
                            for f in dataclasses.fields(g)
                            if isinstance(getattr(g, f.name), torch.Tensor)
                            and getattr(g, f.name).is_floating_point()})

    def unchanged(*a, **k):  # the gradient state left as it was: zero
        loss, g, rays = lg(*a, **k)
        return loss, zero_leaves(g), rays

    def half(*a, spp, **k):
        return lg(*a, spp=max(1, spp // 2), **k)

    def altered(*a, **k):
        loss, g, rays = lg(*a, **k)
        return loss, g.replace(tex_rgb=g.tex_rgb * (1.0 + 1e-2)), rays

    return {"altered": altered, "half": half, "unchanged": unchanged}


@pytest.mark.parametrize("cell", ["cornell_box.offline",
                                  "final_scene.progressive",
                                  "cornell_box.grad"])
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(cell, trace, tiny):
    res = _run(cell, tiny, trace=trace)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    if trace:  # the traced run's own keys, before the checks
        assert res["trace_cost"]["units"] == res["attempted"]
        assert list(res)[-3:] == ["trace_cost", "breakdown", "checks"]


@pytest.mark.parametrize("cell", ["cornell_box.offline",
                                  "final_scene.progressive"])
@pytest.mark.parametrize("fault", ["altered", "half", "unchanged"])
def test_render_fault_is_not_correct(cell, fault, tiny):
    prog = driver.program()
    broken = _with(prog, renderer={"render": _render_faults(prog)[fault]})
    res = _run(cell, tiny, broken)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["altered", "half", "unchanged"])
def test_grad_fault_is_not_correct(fault, tiny):
    prog = driver.program()
    broken = _with(prog, grad={"loss_and_grad": _grad_faults(prog)[fault]})
    res = _run("cornell_box.grad", tiny, broken)
    assert not res["correct"], res["checks"]
    assert np.isfinite(res["attempted"])
