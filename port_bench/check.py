"""The comparison that decides ``correct``: what the window's calls answered
against the plain reference (``reference/``), which builds its own scene
from the configuration (``scenes/<scene>.py``) and imports nothing of the
program.

After the window, a sample of its units drawn from the run's seed is
recomputed by the reference; the mix's kind (``kinds/<kind>.py``) says
which numbers are compared and how. Each number has a limit
(``limits/<cell>.json``); a number that is not finite, or above its limit,
makes the run not correct.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch


def reference_scene(cell):
    """The reference's scene of the cell's configuration."""
    return cell.module("scenes", cell.cfg["scene"]).build(cell.cfg)


def numbers(cell, units, n_pix: int, device,
            dtype=torch.float32) -> Dict[str, float]:
    return cell.kind.numbers(cell, units, n_pix, device, dtype)


def leaf_gap(got: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]) -> float:
    """The worst leaf: the norm of (program - reference) over the larger of
    the reference leaf's norm and the median norm of the leaves the
    reference moves. A reference leaf shorter than the program's (the
    program pads its tables) is padded with zeros; a leaf the reference
    does not have is zero there."""
    norms = [float(np.linalg.norm(g)) for g in ref.values()]
    moved = [n for n in norms if n > 0]
    median = float(np.median(moved)) if moved else 0.0
    out = 0.0
    for name, g in got.items():
        r = np.zeros_like(g)
        if name in ref:
            rr = ref[name]
            r[tuple(slice(0, s) for s in rr.shape)] = rr
        den = max(float(np.linalg.norm(r)), median)
        diff = float(np.linalg.norm(g - r))
        out = worst(out, diff / den if den > 0 else
                    (0.0 if diff == 0 else math.inf))
    for name in ref:
        if name not in got:
            return math.inf
    return out


def worst(a: float, b: float) -> float:
    """The larger of two gaps, a NaN counting as infinite."""
    b = math.inf if b != b else b
    return max(a, b)


def pick(units: List, count: int, rng: np.random.Generator) -> List:
    """``count`` of the units, drawn from the seed."""
    if len(units) <= count:
        return list(units)
    return [units[i] for i in sorted(rng.choice(len(units), count,
                                                replace=False))]


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(math.isfinite(values[k]) and values[k] <= limits[k]
               for k in limits)
