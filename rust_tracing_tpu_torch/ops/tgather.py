"""Differentiable table gather with a deterministic backward.

PyTorch counterpart of rust_tracing_tpu/ops/tgather.py. ``col[idx]`` of a big
index vector into a small parameter table is the basic lookup of the scene's
structure-of-arrays layout; every float-table lookup on the differentiable
ray paths goes through ``tgather``. As ``torch.autograd.Function``s:

- forward: ``col[idx]``, kernel B5 (``gather_kernel``) on a CUDA tensor and
  its plain version on the CPU (ops/lanegather.py);
- backward: the transpose, a sum of the cotangent into the n-row table
  (``scatter_sum_kernel`` on CUDA, deterministic; the reference's dense
  masked sum / segment sum on the CPU). ``index_add_`` on CUDA would reorder
  the float sums from run to run;
- jvp: a gather of the tangent table (the op is linear in ``col``), so
  ``torch.func.jvp`` works.

Integer tables take the same forward and have no gradient. ``tgather_cols``
gathers K same-length columns at one index in one launch (kernel B6) and
``tgather_group`` picks it for more than one column.

Not ported yet: the reference's ``shard_map`` varying-axes plumbing and its
batching rule (``vmap``/``jacfwd``); they come with the multi-GPU slice.
"""

from __future__ import annotations

import torch

from . import lanegather
from .lanegather import TGATHER_DENSE_MAX  # noqa: F401  (reference name)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(col, idx):
        return lanegather.gather(col, idx)

    @staticmethod
    def setup_context(ctx, inputs, output):
        col, idx = inputs
        ctx.n = col.shape[0]
        ctx.save_for_backward(idx)
        ctx.save_for_forward(idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return lanegather.scatter_sum(g, idx, ctx.n), None

    @staticmethod
    def jvp(ctx, dcol, _didx):
        (idx,) = ctx.saved_tensors
        return lanegather.gather(dcol, idx)


class _GatherCols(torch.autograd.Function):
    @staticmethod
    def forward(tab, idx):
        return lanegather.gather_cols(tab, idx)

    @staticmethod
    def setup_context(ctx, inputs, output):
        tab, idx = inputs
        ctx.n = tab.shape[1]
        ctx.save_for_backward(idx)
        ctx.save_for_forward(idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return lanegather.scatter_sum_cols(g, idx, ctx.n), None

    @staticmethod
    def jvp(ctx, dtab, _didx):
        (idx,) = ctx.saved_tensors
        return lanegather.gather_cols(dtab, idx)


def tgather(col: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``col[idx]``: 1-D table lookup, differentiable w.r.t. a float
    ``col`` in both modes."""
    if not col.is_floating_point():
        return lanegather.gather(col, idx)
    return _Gather.apply(col, idx)


def tgather_cols(cols, idx: torch.Tensor):
    """Gather ``len(cols)`` same-length 1-D tables at one shared index in
    one launch; returns a tuple of per-column results (each ``idx.shape``).
    Differentiable w.r.t. every float column, like :func:`tgather`."""
    tab = torch.stack(tuple(cols))
    out = (_GatherCols.apply(tab, idx) if tab.is_floating_point()
           else lanegather.gather_cols(tab, idx))
    return tuple(out[k] for k in range(len(cols)))


def tgather_group(cols, idx: torch.Tensor):
    """``tuple(col[idx] for col in cols)``: one multi-column gather for more
    than one column, else :func:`tgather`. The reference picks by table and
    index size, against the TPU's serial gather; on the GPU the packed
    gather reads the index once whatever the size."""
    if len(cols) > 1:
        return tgather_cols(cols, idx)
    return (tgather(cols[0], idx),)
