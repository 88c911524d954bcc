"""Table gathers and their transpose: CUDA kernel wrappers and plain versions.

Replaces rust_tracing_tpu/ops/lanegather.py (the Pallas lane gathers
``_kernel``/``lane_gather`` and ``_kernel_cols``/``lane_gather_cols``) and
supplies the transpose of both (``_reduce_cotangent`` of
rust_tracing_tpu/ops/tgather.py). The kernels are hand-written CUDA C++ in
``csrc/gather_kernel.cu``:

- ``gather``: ``out[i] = col[idx[i]]`` for a 1-D table (kernel B5);
- ``gather_cols``: ``out[k, i] = tab[k, idx[i]]`` for a ``(K, n)`` table,
  the index read once (kernel B6);
- ``scatter_sum``: ``d[k, r] = sum of ct[k, i] over idx[i] == r``, the
  transpose of both, deterministic (no float atomics; the summation order is
  stated in the source and fixed by the launch, ``scatter_plan``, which
  depends on the index count, rows, columns and dtype alone):
  ``scatter_sum_kernel`` (the tile kernel) for small tables
  (``use_tile_kernel``; ``scatter_sum_ordered_plain`` is its order in tensor
  code), ``scatter_match_kernel`` for mid-size ones, ``segment_sum_kernel``
  for large ones (``use_segment_sum``: by rows, columns and dtype):
  ``radix_sort_kernel``
  (a stable LSD radix sort of the index over the bits of the row count,
  written here, carrying the cotangents along) and one pass over the sorted
  runs.

Each takes its device from its inputs: on CUDA tensors it launches its
kernel (or raises), on CPU tensors it runs its plain version. Out-of-range
indices gather 0 and are dropped by the sum.
"""

from __future__ import annotations

import ctypes

import torch

from ..runtime.kernels import LAUNCHES

# The reference's lane-gather thresholds. They are the TPU's: they guard
# against XLA's serial lowering of a one-element gather there, which the GPU
# does not have, so the port launches its gather kernels at every table size
# and index count. Kept for reading the reference; nothing here selects by
# them.
LANE_GATHER_MAX_N = 8192
LANE_GATHER_MIN_N = 65
LANE_GATHER_MIN_R = 4096

# Largest table whose plain transpose is the dense masked sum (the
# reference's rule); larger tables take index_add_, deterministic on the CPU.
TGATHER_DENSE_MAX = 64

# The reduction kernels cut R into block slices of at most SCATTER_CHUNK
# elements and at most SCATTER_MAX_BLOCKS blocks (the match kernel: by R
# alone). A tile-kernel block of fewer than 8 element slices (one per
# column group) takes that many 1/8ths of SCATTER_CHUNK, so that a warp
# walks ~1024 elements: its launch, and so its summation order, depends on
# R, K and the dtype alone.
SCATTER_CHUNK = 8192
SCATTER_MAX_BLOCKS = 1024

# The tile kernel (csrc/gather_kernel.cu: SS_MAX_WARPS, SS_SMEM_BYTES): a
# block's SCATTER_MAX_WARPS warps are min(K, 8) column groups x the element
# slices that fill 8; a lane keeps its own copy of each (column, row) sum of
# a pass in shared memory, and a warp one sum of each for the epilogue: 33
# elements a (warp, column, row), at most SCATTER_SMEM_BYTES a block (an
# H100's 227 KB); a warp's columns and rows that do not fit take more passes.
SCATTER_MAX_WARPS = 8
SCATTER_SMEM_BYTES = 232448
# The match kernel (csrc/gather_kernel.cu: SM_SMEM_BYTES / SM_WARPS) holds a
# row tile of this many bytes a warp in shared memory: 3072 f32 rows, 1536
# f64. A table with more rows is summed tile by tile, each tile re-reading
# the block's slice of the index and the cotangents.
SCATTER_TILE_BYTES = 12 * 1024
# The segment sum reads each element a fixed number of times (its sort
# passes); the match kernel reads its index once and its K values once a row
# tile. The segment sum takes the tables whose match kernel would read an
# element's values more than once (two or more row tiles) and more than
# this many of them in all.
SCATTER_SORT_MIN_VALUES = 2
# The tile kernel's 32 lane copies a row bound the warps an SM holds; it
# takes the tables of at most this many rows. On an H100 (chip_smoke.py's
# scatter_routes: 4-8192 rows, 1-17 columns, f32 and f64, device time) the
# three forms so routed were the fastest in every cell at 3.96 M indices
# (one replay wavefront; PERF.md).
SCATTER_TILE_MAX_ROWS = 64

# The radix sort (csrc/gather_kernel.cu): digits of at most this many bits a
# pass (a scatter pass over 2^10 digits took 2.4x one over 2^7 on an H100),
# and this many elements a block.
RADIX_MAX_BITS = 8
RADIX_TILE = 4096

_ELEM = {torch.float32: 4, torch.int32: 4, torch.float64: 8, torch.int64: 8}


def _index(idx: torch.Tensor, dev: torch.device) -> torch.Tensor:
    if idx.device != dev:
        raise ValueError(f"index on {idx.device}, table on {dev}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"index must be int32 or int64, got {idx.dtype}")
    return idx.reshape(-1).to(torch.int32).contiguous()


def _launch_args(dev):
    from ..runtime import kernels

    return kernels, kernels.load(), torch.cuda.current_stream(dev).cuda_stream


# ----------------------------------------------------------------- gathers
def gather_plain(col: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of ``gather_kernel``."""
    n = col.shape[0]
    ok = (idx >= 0) & (idx < n)
    return torch.where(ok, col[idx.clamp(0, n - 1).long()],
                       torch.zeros((), dtype=col.dtype, device=col.device))


def gather_kernel(col: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """One launch of the CUDA gather: ``col[idx]`` for a 1-D CUDA table of a
    4- or 8-byte dtype, any-shape index. Does not synchronise."""
    dev = col.device
    if dev.type != "cuda":
        raise ValueError(f"gather_kernel needs CUDA tensors, got {dev}")
    if col.ndim != 1 or col.dtype not in _ELEM:
        raise TypeError(f"gather_kernel takes a 1-D f32/f64/i32/i64 table, "
                        f"got {tuple(col.shape)} {col.dtype}")
    flat = _index(idx, dev)
    col = col.contiguous()
    out = torch.empty(flat.shape, dtype=col.dtype, device=dev)
    if flat.numel():
        kernels, lib, stream = _launch_args(dev)
        with torch.cuda.device(dev):
            err = lib.rt_gather_launch(col.data_ptr(), col.shape[0],
                                       flat.data_ptr(), flat.numel(),
                                       _ELEM[col.dtype], out.data_ptr(),
                                       stream)
        LAUNCHES["gather_kernel"] += 1
        kernels.check(err, "gather kernel")
    return out.reshape(idx.shape)


def gather(col: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``col[idx]`` (0 out of range): the kernel on CUDA, the plain version
    on the CPU."""
    if col.device.type == "cpu":
        return gather_plain(col, idx)
    return gather_kernel(col, idx)


def gather_cols_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of ``gather_cols_kernel``."""
    return torch.stack([gather_plain(tab[k], idx)
                        for k in range(tab.shape[0])])


def gather_cols_kernel(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """One launch of the CUDA multi-column gather: ``tab[:, idx]`` for a
    ``(K, n)`` CUDA table, the index read once. Returns ``(K, *idx.shape)``.
    Does not synchronise."""
    dev = tab.device
    if dev.type != "cuda":
        raise ValueError(f"gather_cols_kernel needs CUDA tensors, got {dev}")
    if tab.ndim != 2 or tab.dtype not in _ELEM:
        raise TypeError(f"gather_cols_kernel takes a (K, n) f32/f64/i32/i64 "
                        f"table, got {tuple(tab.shape)} {tab.dtype}")
    flat = _index(idx, dev)
    tab = tab.contiguous()
    K, n = tab.shape
    out = torch.empty((K, flat.numel()), dtype=tab.dtype, device=dev)
    if flat.numel():
        kernels, lib, stream = _launch_args(dev)
        with torch.cuda.device(dev):
            err = lib.rt_gather_cols_launch(tab.data_ptr(), K, n,
                                            flat.data_ptr(), flat.numel(),
                                            _ELEM[tab.dtype], out.data_ptr(),
                                            stream)
        LAUNCHES["gather_cols_kernel"] += 1
        kernels.check(err, "gather_cols kernel")
    return out.reshape((K,) + tuple(idx.shape))


def gather_cols(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``tab[:, idx]``: the kernel on CUDA, the plain version on the CPU."""
    if tab.device.type == "cpu":
        return gather_cols_plain(tab, idx)
    return gather_cols_kernel(tab, idx)


# --------------------------------------------------------------- transpose
def _reduce_plain(ct: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """The reference's ``_reduce_cotangent`` for one column: a dense masked
    sum for tables of at most TGATHER_DENSE_MAX rows, else a segment sum
    (``index_add_``; out-of-range indices dropped)."""
    ct_f, idx_f = ct.reshape(-1), idx.reshape(-1)
    if n <= TGATHER_DENSE_MAX:
        seg = torch.arange(n, dtype=idx_f.dtype, device=idx_f.device)
        mask = idx_f[None, :] == seg[:, None]                   # (n, R)
        return torch.where(mask, ct_f[None, :], 0.0).sum(dim=1)
    ok = (idx_f >= 0) & (idx_f < n)
    out = torch.zeros(n, dtype=ct.dtype, device=ct.device)
    return out.index_add_(0, idx_f[ok].long(), ct_f[ok])


def scatter_sum_plain(ct: torch.Tensor, idx: torch.Tensor,
                      n: int) -> torch.Tensor:
    """Plain version of ``scatter_sum_kernel``: ``ct`` is ``(K, *idx.shape)``,
    returns ``(K, n)``."""
    return torch.stack([_reduce_plain(ct[k], idx, n)
                        for k in range(ct.shape[0])])


def scatter_blocks(R: int, per_block: int = SCATTER_CHUNK):
    """(blocks, elements a block) of the reduction kernels for R elements,
    at most ``per_block`` a block unless that takes over SCATTER_MAX_BLOCKS
    blocks."""
    B = max(1, min(-(-R // per_block), SCATTER_MAX_BLOCKS))
    return B, -(-R // B)


def scatter_plan(R: int, n: int, K: int, elem: int) -> dict:
    """The tile kernel's launch for R elements of K columns of ``elem``-byte
    cotangents into n rows, which fixes its summation order: ``blocks`` of
    ``warps`` warps, ``chunk`` elements a block; the warps are ``groups``
    column groups (group g: columns g, g + groups, ...) x ``slices`` parts
    of the block's elements; each pass holds ``cpw`` of a warp's columns and
    ``rows`` rows (``passes`` in all)."""
    Wc = min(K, SCATTER_MAX_WARPS)
    We = SCATTER_MAX_WARPS // Wc
    B, chunk = scatter_blocks(R, SCATTER_CHUNK * We // SCATTER_MAX_WARPS)
    W = Wc * We
    ncw = -(-K // Wc)                        # columns of the fullest group
    cap = SCATTER_SMEM_BYTES // (33 * elem)  # (warp, column, row) entries
    cpw = max(1, min(ncw, cap // (W * n)))
    rows = min(n, cap // (W * cpw))
    return dict(blocks=B, chunk=chunk, warps=W, groups=Wc, slices=We,
                cpw=cpw, rows=rows, passes=-(-ncw // cpw) * -(-n // rows),
                smem_bytes=W * cpw * rows * 33 * elem)


# Elements of lane copies ``scatter_sum_ordered_plain`` holds at once.
ORDERED_PLAIN_ENTRIES = 1 << 26


def _butterfly(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The kernel's fixed sum over 32 lanes along ``dim``: lane l + lane
    l + 16 for l < 16, then + 8, + 4, + 2, + 1 (csrc/gather_kernel.cu:
    lane_butterfly)."""
    for h in (16, 8, 4, 2, 1):
        x = x.narrow(dim, 0, h) + x.narrow(dim, h, h)
    return x.squeeze(dim)


def scatter_sum_ordered_plain(ct: torch.Tensor, idx: torch.Tensor,
                              n: int) -> torch.Tensor:
    """``scatter_sum_plain`` summed in ``scatter_sum_kernel``'s order, so
    that the kernel equals it bit for bit: each lane's stream of its element
    slice in element order, the lanes by the fixed butterfly, the slices in
    order, then the blocks (lane l: blocks l, l + 32, ...; the butterfly).
    ``ct`` ``(K, *idx.shape)`` f32 or f64 -> ``(K, n)``."""
    K = ct.shape[0]
    flat = idx.reshape(-1).long()
    R = flat.numel()
    dev, dt = ct.device, ct.dtype
    if R == 0:
        return torch.zeros((K, n), dtype=dt, device=dev)
    plan = scatter_plan(R, n, K, ct.element_size())
    # a column's order does not depend on its group: its element slices
    # take the place of warps
    B, chunk, W = plan["blocks"], plan["chunk"], plan["slices"]
    wchunk = -(-chunk // W)
    steps = -(-wchunk // 32)
    ar = lambda m: torch.arange(m, device=dev)  # noqa: E731
    wlo = ar(B)[:, None] * chunk + ar(W)[None, :] * wchunk          # (B, W)
    whi = torch.minimum(wlo + wchunk,
                        torch.clamp((ar(B)[:, None] + 1) * chunk, max=R))
    lane = ar(32)
    slot = ar(B * W * 32)                    # (block, warp, lane) of a step
    cols = ct.reshape(K, R)
    M = -(-B // 32)
    out = []
    # rows a few at a time (each row's order is its own): the lane copies
    # of a chunk hold at most ORDERED_PLAIN_ENTRIES elements
    span = max(1, ORDERED_PLAIN_ENTRIES // (K * B * W * 32))
    for r0 in range(0, n, span):
        m = min(span, n - r0)
        acc = torch.zeros((K, B * W * 32, m + 1), dtype=dt, device=dev)
        for t in range(steps):
            e = (wlo[:, :, None] + 32 * t + lane).reshape(-1)
            ok = e < whi[:, :, None].expand(B, W, 32).reshape(-1)
            e = e.clamp(max=R - 1)
            row = torch.where(ok, flat[e] - r0, -1)
            row = torch.where((row >= 0) & (row < m), row, m)  # m: dropped
            acc[:, slot, row] = acc[:, slot, row] + torch.where(
                ok, cols[:, e], 0)
        lanes = _butterfly(acc[:, :, :m].reshape(K, B, W, 32, m), 3)
        blk = lanes[:, :, 0]
        for w in range(1, W):
            blk = blk + lanes[:, :, w]                              # (K, B, m)
        pad = torch.zeros((K, M * 32 - B, m), dtype=dt, device=dev)
        blk = torch.cat([blk, pad], 1).reshape(K, M, 32, m)
        run = blk[:, 0]
        for i in range(1, M):
            run = run + blk[:, i]
        out.append(_butterfly(run, 1))
    return torch.cat(out, 1)


def scatter_sum_kernel(ct: torch.Tensor, idx: torch.Tensor,
                       n: int) -> torch.Tensor:
    """One launch of the CUDA reduction (two kernels, one call): ``ct`` f32
    or f64 of shape ``(K, *idx.shape)``; returns ``(K, n)``, equal bit for
    bit to ``scatter_sum_ordered_plain``. Same bits on every call. Does not
    synchronise."""
    dev = ct.device
    if dev.type != "cuda":
        raise ValueError(f"scatter_sum_kernel needs CUDA tensors, got {dev}")
    if ct.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"scatter_sum_kernel sums f32 or f64, got {ct.dtype}")
    flat = _index(idx, dev)
    R = flat.numel()
    if tuple(ct.shape[1:]) != tuple(idx.shape):
        raise ValueError(f"cotangent {tuple(ct.shape)} does not match index "
                         f"{tuple(idx.shape)}")
    K = ct.shape[0]
    if not (R and n and K):
        return torch.zeros((K, n), dtype=ct.dtype, device=dev)
    ct2 = ct.reshape(K, R).contiguous()
    out = torch.empty((K, n), dtype=ct.dtype, device=dev)
    plan = scatter_plan(R, n, K, ct.element_size())
    partial = torch.empty((K, plan["blocks"], n), dtype=ct.dtype, device=dev)
    kernels, lib, stream = _launch_args(dev)
    with torch.cuda.device(dev):
        err = lib.rt_scatter_sum_launch(
            ct2.data_ptr(), flat.data_ptr(), R, n, K,
            int(ct.dtype == torch.float64), plan["blocks"], plan["chunk"],
            plan["warps"], plan["groups"], plan["cpw"], plan["rows"],
            partial.data_ptr(), out.data_ptr(), stream)
    LAUNCHES["scatter_sum_kernel"] += 1
    kernels.check(err, "scatter_sum kernel")
    return out


def scatter_match_kernel(ct: torch.Tensor, idx: torch.Tensor,
                         n: int) -> torch.Tensor:
    """One launch of the CUDA match kernel (two kernels, one call), the
    reduction for tables of a few hundred to a few thousand rows: ``ct`` f32
    or f64 of shape ``(K, *idx.shape)``; returns ``(K, n)``. Same bits on
    every call (the order is fixed by the index count and stated in the
    source). Does not synchronise."""
    dev = ct.device
    if dev.type != "cuda":
        raise ValueError(f"scatter_match_kernel needs CUDA tensors, got {dev}")
    if ct.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"scatter_match_kernel sums f32 or f64, got "
                        f"{ct.dtype}")
    flat = _index(idx, dev)
    R = flat.numel()
    if tuple(ct.shape[1:]) != tuple(idx.shape):
        raise ValueError(f"cotangent {tuple(ct.shape)} does not match index "
                         f"{tuple(idx.shape)}")
    K = ct.shape[0]
    if not (R and n and K):
        return torch.zeros((K, n), dtype=ct.dtype, device=dev)
    ct2 = ct.reshape(K, R).contiguous()
    out = torch.empty((K, n), dtype=ct.dtype, device=dev)
    B, chunk = scatter_blocks(R)
    partial = torch.empty((K, B, n), dtype=ct.dtype, device=dev)
    kernels, lib, stream = _launch_args(dev)
    with torch.cuda.device(dev):
        err = lib.rt_scatter_match_launch(
            ct2.data_ptr(), flat.data_ptr(), R, n, K,
            int(ct.dtype == torch.float64), B, chunk, partial.data_ptr(),
            out.data_ptr(), stream)
    LAUNCHES["scatter_match_kernel"] += 1
    kernels.check(err, "scatter_match kernel")
    return out


def use_tile_kernel(n: int) -> bool:
    """Whether a reduction into ``n`` rows takes the tile kernel (lane
    copies; else the match kernel or the segment sum)."""
    return n <= SCATTER_TILE_MAX_ROWS


def use_segment_sum(n: int, K: int, elem: int) -> bool:
    """Whether the reduction of K columns of ``elem``-byte cotangents into
    ``n`` rows takes the segment sum rather than the match kernel: two or
    more of the match kernel's row tiles, and more than
    SCATTER_SORT_MIN_VALUES of an element's values read over them."""
    tiles = -(-n // (SCATTER_TILE_BYTES // elem))
    return tiles >= 2 and K * tiles > SCATTER_SORT_MIN_VALUES


def radix_digits(n: int) -> tuple:
    """Digit widths, lowest first, of the radix sort of row keys 0..n (n is
    the key of out-of-range rows): the bits of n in as few passes of at most
    RADIX_MAX_BITS as they need, of near-equal width."""
    bits = max(1, int(n).bit_length())
    passes = -(-bits // RADIX_MAX_BITS)
    width, wider = divmod(bits, passes)
    return tuple(width + (p < wider) for p in range(passes))


def radix_sort_plain(idx: torch.Tensor, n: int, vals: torch.Tensor):
    """Plain version of ``radix_sort_kernel``: the index's rows stably
    sorted, rows outside [0, n) keyed n (last), as int32, and the ``(K, R)``
    value columns ``vals`` in the same order."""
    flat = idx.reshape(-1)
    keys = torch.where((flat >= 0) & (flat < n), flat, n)
    skey, perm = torch.sort(keys, stable=True)
    return skey.to(torch.int32), vals[:, perm]


def radix_sort_kernel(idx: torch.Tensor, n: int, vals: torch.Tensor):
    """One launch of the CUDA radix sort (three kernels a pass, one call):
    ``radix_sort_plain``'s outputs for a CUDA index and ``(K, R)`` value
    columns of a 4- or 8-byte dtype. Does not synchronise."""
    dev = idx.device
    if dev.type != "cuda" or vals.device != dev:
        raise ValueError(f"radix_sort_kernel needs CUDA tensors, got {dev} "
                         f"and {vals.device}")
    flat = _index(idx, dev)
    R = flat.numel()
    if n < 1 or R >= 1 << 31:
        raise ValueError(f"radix_sort_kernel sorts under 2^31 indices into "
                         f">= 1 rows, got {R} into {n}")
    if vals.ndim != 2 or vals.shape[1] != R or vals.dtype not in _ELEM:
        raise TypeError(f"radix_sort_kernel carries (K, {R}) values of a "
                        f"4- or 8-byte dtype, got {tuple(vals.shape)} "
                        f"{vals.dtype}")
    widths = radix_digits(n)
    vals = vals.contiguous()
    keys = torch.empty(R, dtype=torch.int32, device=dev)
    out = torch.empty_like(vals)
    if R:
        tmp_k, tmp_v = torch.empty_like(keys), torch.empty_like(vals)
        digits = 1 << max(widths)
        counts = torch.empty(digits * -(-R // RADIX_TILE), dtype=torch.int32,
                             device=dev)
        totals = torch.empty(digits, dtype=torch.int32, device=dev)
        kernels, lib, stream = _launch_args(dev)
        with torch.cuda.device(dev):
            err = lib.rt_radix_sort_launch(
                flat.data_ptr(), R, n, (ctypes.c_int * len(widths))(*widths),
                len(widths), vals.data_ptr(), vals.shape[0],
                _ELEM[vals.dtype], keys.data_ptr(), out.data_ptr(),
                tmp_k.data_ptr(), tmp_v.data_ptr(), counts.data_ptr(),
                totals.data_ptr(), stream)
        LAUNCHES["radix_sort_kernel"] += 1
        kernels.check(err, "radix_sort kernel")
    return keys, out


def segment_sum_kernel(ct: torch.Tensor, idx: torch.Tensor,
                       n: int) -> torch.Tensor:
    """The reduction for tables with many rows: ``radix_sort_kernel`` sorts
    the index with the cotangent columns, then one launch of the CUDA
    segment sum adds the sorted runs (two kernels: pieces of runs a warp,
    then the runs that span warps). ``ct`` f32 or f64 of shape
    ``(K, *idx.shape)``; returns ``(K, n)``. Same bits on every call (each
    row's order of summation depends on the index alone). Launches only this
    repo's kernels and the fill of ``torch.zeros``. Does not synchronise."""
    dev = ct.device
    if dev.type != "cuda":
        raise ValueError(f"segment_sum_kernel needs CUDA tensors, got {dev}")
    if ct.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"segment_sum_kernel sums f32 or f64, got {ct.dtype}")
    flat = _index(idx, dev)
    R = flat.numel()
    if tuple(ct.shape[1:]) != tuple(idx.shape):
        raise ValueError(f"cotangent {tuple(ct.shape)} does not match index "
                         f"{tuple(idx.shape)}")
    K = ct.shape[0]
    out = torch.zeros((K, n), dtype=ct.dtype, device=dev)
    if R and n and K:
        skey, svals = radix_sort_kernel(flat, n, ct.reshape(K, R))
        warps = -(-R // 32)
        carry = torch.empty((K, warps), dtype=ct.dtype, device=dev)
        tail_key = torch.empty(warps, dtype=torch.int32, device=dev)
        kernels, lib, stream = _launch_args(dev)
        with torch.cuda.device(dev):
            err = lib.rt_segment_sum_launch(
                svals.data_ptr(), skey.data_ptr(), R, n, K,
                int(ct.dtype == torch.float64), out.data_ptr(),
                carry.data_ptr(), tail_key.data_ptr(), stream)
        LAUNCHES["segment_sum_kernel"] += 1
        kernels.check(err, "segment_sum kernel")
    return out


def scatter_sum_cols(ct: torch.Tensor, idx: torch.Tensor,
                     n: int) -> torch.Tensor:
    """Transpose of ``gather_cols``: ``ct`` ``(K, *idx.shape)`` -> ``(K, n)``;
    a kernel on CUDA (``use_segment_sum``), the plain version on the CPU."""
    if ct.device.type == "cpu":
        return scatter_sum_plain(ct, idx, n)
    if use_tile_kernel(n):
        return scatter_sum_kernel(ct, idx, n)
    if use_segment_sum(n, ct.shape[0], ct.element_size()):
        return segment_sum_kernel(ct, idx, n)
    return scatter_match_kernel(ct, idx, n)


def scatter_sum(ct: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Transpose of ``gather``: ``ct`` of ``idx``'s shape -> ``(n,)``."""
    return scatter_sum_cols(ct[None], idx, n)[0]
