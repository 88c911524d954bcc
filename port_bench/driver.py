"""The load generator's frame: one client in a closed loop, driving the
program under test as a traffic mix says.

A mix (``traffic/<mix>.json``) names its ``kind``, a module
``kinds/<kind>.py`` (found by name, see ``lookup``) with four functions:

- ``draw(d: Draws, k) -> Unit``: unit k's seeds, samples and the pixels its
  check will read, from the run's ``--seed`` alone, with no program;
- ``run(drv: Driver, unit) -> Unit``: that unit through the program, with
  its scene queries, its seconds on the host clock and the answers the
  check compares;
- ``numbers(cell, units, n_pix, device, dtype) -> {name: value}``: those
  answers against the plain reference (``check``);
- ``answer(cell, units, n_pix, device, dtype) -> units``: the reference in
  ``dtype`` put in the program's place (the control).

The mix's other keys are the kind's parameters; ``call`` holds keyword
arguments passed through to the program's entry as they stand. A run and
the control draw their units by the same ``Draws``, so a seed's units are
the same in both.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

SEED_SPACE = 1 << 31
SPAN_PREFIX = "port_bench."


@dataclasses.dataclass
class Unit:
    """One frame, slice or step that the window completed."""

    seed: int
    sample0: int
    spp: int
    rays: int
    seconds: float
    kept: Dict  # the pixels the check reads; then the program's answers


def program():
    """The program's modules (imported here, not at import time, so that
    the harness's tests can load this module alone)."""
    from rust_tracing_tpu_torch import grad, renderer
    from rust_tracing_tpu_torch.camera import Camera
    from rust_tracing_tpu_torch.config import RenderSettings
    from rust_tracing_tpu_torch.models import builders
    from rust_tracing_tpu_torch.models.compile import compile_scene
    from rust_tracing_tpu_torch.runtime import kernels
    return dict(grad=grad, renderer=renderer, Camera=Camera,
                RenderSettings=RenderSettings, builders=builders,
                compile_scene=compile_scene, kernels=kernels)


SETTING_KEYS = ("image_width", "aspect_ratio", "samples_per_pixel",
                "max_depth", "vfov", "look_from", "look_at", "vup",
                "defocus_angle", "focus_dist", "background")


def build_program_scene(prog, cfg: Dict, device):
    """The program's scene and camera for a configuration: its builder of
    the same name, compiled on ``device``, and the configuration's camera
    settings."""
    fn = getattr(prog["builders"], cfg["scene"])
    b, _ = (fn(seed=cfg["geometry_seed"]) if cfg.get("geometry_seed")
            is not None else fn())
    settings = prog["RenderSettings"](**{
        k: tuple(cfg[k]) if isinstance(cfg[k], list) else cfg[k]
        for k in SETTING_KEYS if k in cfg})
    scene = prog["compile_scene"](b, device=device)
    return scene, prog["Camera"].create(settings)


def frame_size(cfg: Dict):
    """(width, height) of the configuration's frame, as the reference's
    camera (``reference.scenes.view``) takes them."""
    width = int(cfg["image_width"])
    return width, int(width / cfg["aspect_ratio"])


class Draws:
    """What a run draws from its seed: a seed for the run, then each unit's
    draws in order (``kind.draw``). Needs nothing of the program."""

    def __init__(self, cell, seed: int):
        self.cell, self.cfg, self.mix = cell, cell.cfg, cell.mix
        self.kind = cell.kind
        self.rng = np.random.default_rng(seed)
        self.run_seed = int(self.rng.integers(SEED_SPACE))
        self.width, self.height = frame_size(self.cfg)
        self.n_pix = self.width * self.height
        self.spp = (int(self.cfg["samples_per_pixel"])
                    if self.mix["spp"] == "config" else int(self.mix["spp"]))
        self.depth = int(self.cfg["max_depth"])

    def draw(self, k: int) -> Unit:
        return self.kind.draw(self, k)


class Driver(Draws):
    """Runs the units of a mix through the program and keeps, for each,
    what its check needs."""

    def __init__(self, cell, device, seed: int, prog):
        super().__init__(cell, seed)
        self.dev, self.prog = device, prog
        self.scene, self.camera = build_program_scene(prog, self.cfg, device)
        got = (self.camera.image_width, self.camera.image_height)
        if got != (self.width, self.height):
            raise SystemExit(f"the program's frame {got} is not the "
                             f"configuration's {(self.width, self.height)}")
        self.state: Dict = {}  # a kind's state across units
        self.spans = None      # (name, start_s, end_s) while traced

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span on the clock of the profiler's events (Unix time),
        kept while ``spans`` is a list."""
        if self.spans is None:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((SPAN_PREFIX + name, t0 * 1e-9,
                               time.time_ns() * 1e-9))

    def unit(self, k: int) -> Unit:
        return self.kind.run(self, self.draw(k))

    def window(self, seconds: float) -> List[Unit]:
        """Units back to back until ``seconds`` have passed; the last unit
        started runs to its end."""
        units: List[Unit] = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            units.append(self.unit(len(units)))
        self.window_s = time.perf_counter() - t0
        return units
