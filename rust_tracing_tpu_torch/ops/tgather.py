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
  ``torch.func.jvp`` works;
- vmap: the reference's batching rules (``_tgather_batch``,
  ``_tgcols_batch``), so ``torch.func.vmap`` and ``jacfwd`` work. A batched
  table (jacfwd's tangents) is one gather of a ``(B*K, n)`` column table at
  the shared index (kernel B6 on CUDA); a batched index is flattened and
  gathered once; both batched, row b's index is offset by ``b*n`` into the
  flattened table. Each is one launch of a deterministic gather, and the
  jvp goes through the Function again, so a batched tangent reaches these
  rules and not the kernel wrapper.

Integer tables take the same forward and have no gradient. ``tgather_cols``
gathers K same-length columns at one index in one launch (kernel B6) and
``tgather_group`` picks it for more than one column.

The reference's ``shard_map`` varying-axes plumbing has no counterpart: the
port's ranks are processes, each gathering from its own copy of the table.
"""

from __future__ import annotations

import torch

from . import lanegather
from .lanegather import TGATHER_DENSE_MAX  # noqa: F401  (reference name)


def _offset_rows(idx: torch.Tensor, B: int, n: int) -> torch.Tensor:
    """Index ``idx[b]`` of row b of a ``(B, n)`` table as an index into the
    flattened ``(B*n,)`` table; out-of-range entries stay out of range."""
    if B * n >= 2 ** 31:
        raise ValueError(f"a batch of {B} tables of {n} rows exceeds the "
                         f"gathers' int32 index")
    base = torch.arange(B, dtype=torch.int64, device=idx.device) * n
    base = base.reshape((B,) + (1,) * (idx.ndim - 1))
    ok = (idx >= 0) & (idx < n)
    return torch.where(ok, idx.long() + base, -1)


class _ScatterSum(torch.autograd.Function):
    """The gathers' transpose, ``ct`` ``(K, *idx.shape)`` -> ``(K, n)``, as
    a Function: under vmap (jacrev's batched cotangents) its rule folds the
    batch into the K columns of one launch of the reduction kernels."""

    @staticmethod
    def forward(ct, idx, n):
        return lanegather.scatter_sum_cols(ct, idx, n)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[1])

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return _GatherCols.apply(g, idx), None, None

    @staticmethod
    def vmap(info, in_dims, ct, idx, n):
        dct, didx, _ = in_dims
        ct = ct.movedim(dct, 0) if dct is not None else ct.expand(
            (info.batch_size,) + ct.shape)                   # (B, K, ...)
        B, K = ct.shape[:2]
        if didx is None:
            out = _ScatterSum.apply(ct.reshape((B * K,) + ct.shape[2:]), idx,
                                    n)
            return out.reshape(B, K, n), 0
        flat = _offset_rows(idx.movedim(didx, 0), B, n)
        out = _ScatterSum.apply(ct.transpose(0, 1), flat, B * n)
        return out.reshape(K, B, n), 1


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
        return _ScatterSum.apply(g[None], idx, ctx.n)[0], None

    @staticmethod
    def jvp(ctx, dcol, _didx):
        (idx,) = ctx.saved_tensors
        return _Gather.apply(dcol, idx)

    @staticmethod
    def vmap(info, in_dims, col, idx):
        dcol, didx = in_dims
        if dcol is None:
            return _Gather.apply(col, idx.movedim(didx, 0)), 0
        col = col.movedim(dcol, 0)                              # (B, n)
        if didx is None:
            return _GatherCols.apply(col, idx), 0
        flat = _offset_rows(idx.movedim(didx, 0), *col.shape)
        return _Gather.apply(col.reshape(-1), flat), 0


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
        return _ScatterSum.apply(g, idx, ctx.n), None

    @staticmethod
    def jvp(ctx, dtab, _didx):
        (idx,) = ctx.saved_tensors
        return _GatherCols.apply(dtab, idx)

    @staticmethod
    def vmap(info, in_dims, tab, idx):
        dtab, didx = in_dims
        if dtab is None:
            return _GatherCols.apply(tab, idx.movedim(didx, 0)), 1
        tab = tab.movedim(dtab, 0)                              # (B, K, n)
        B, K, n = tab.shape
        if didx is None:
            out = _GatherCols.apply(tab.reshape(B * K, n), idx)
            return out.reshape((B, K) + tuple(idx.shape)), 0
        flat = _offset_rows(idx.movedim(didx, 0), B, n)
        return _GatherCols.apply(tab.transpose(0, 1).reshape(K, B * n),
                                 flat), 1


def _through_function(tab: torch.Tensor) -> bool:
    """Float tables go through the autograd Functions; so does every table
    under a torch.func transform, whose wrapped tensors reach a kernel only
    after the Function has unwrapped them (an integer table gathered at an
    index derived from a batched or dual point, e.g. Perlin's permutations
    under jacfwd)."""
    return (tab.is_floating_point()
            or torch._C._functorch.peek_interpreter_stack() is not None)


def tgather(col: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``col[idx]``: 1-D table lookup, differentiable w.r.t. a float
    ``col`` in both modes."""
    if _through_function(col):
        return _Gather.apply(col, idx)
    return lanegather.gather(col, idx)


def tgather_cols(cols, idx: torch.Tensor):
    """Gather ``len(cols)`` same-length 1-D tables at one shared index in
    one launch; returns a tuple of per-column results (each ``idx.shape``).
    Differentiable w.r.t. every float column, like :func:`tgather`."""
    tab = torch.stack(tuple(cols))
    out = (_GatherCols.apply(tab, idx) if _through_function(tab)
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
