"""Perlin permutation/gradient tables (host side).

Port of ``make_tables`` from rust_tracing_tpu/ops/perlin.py: 256 random
gradient vectors in [-1,1]^3 that are *not normalized* (perlin.rs:16-25) and
three independent permutation tables (perlin.rs:74-79). ``compile_scene``
carries them as scene fields; the noise evaluation itself is not ported yet.
"""

from __future__ import annotations

import numpy as np

POINT_COUNT = 256


def make_tables(seed: int = 0):
    """Host-side table generation (reference: src/perlin.rs:14-25,66-79)."""
    rng = np.random.default_rng(seed)
    ranvec = rng.uniform(-1.0, 1.0, size=(POINT_COUNT, 3))
    perms = [rng.permutation(POINT_COUNT).astype(np.int32) for _ in range(3)]
    return ranvec, perms[0], perms[1], perms[2]
