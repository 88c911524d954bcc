"""Checkpoint and resume of progressive renders.

PyTorch counterpart of rust_tracing_tpu/utils/checkpoint.py, with the same
``.npz`` keys (``accum``, ``num_samples``, ``seed``), so a checkpoint of
either package resumes in the other. The reference renderer keeps its
(buffer, sample count) pair only in memory (src/renderer.rs:97-117); here
the state is explicit: (running mean, sample count, RNG seed). Samples are
addressed by global index, so a resumed render continues the same sample
streams and ends on the uninterrupted render's image bit for bit.

``save`` writes a temporary file beside ``path`` and renames it over
``path``, so a process killed while saving leaves the previous checkpoint
whole.
"""

from __future__ import annotations

import os

import numpy as np

from ..renderer import ProgressiveState


def save(path: str, state: ProgressiveState) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, accum=state.accum,
                            num_samples=np.int64(state.num_samples),
                            seed=np.int64(state.seed))
    os.replace(tmp, path)


def load(path: str) -> ProgressiveState:
    with np.load(path) as z:
        return ProgressiveState(accum=z["accum"].copy(),
                                num_samples=int(z["num_samples"]),
                                seed=int(z["seed"]))
