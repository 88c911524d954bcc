"""Hardware probes of the H100 for the scene-in-fast-memory kernel design.

Counterpart of scripts/tpu_probe.py, whose seven Pallas probes (P1-P7) ask
the TPU where a scene table can live and what a sphere test costs there. The
same questions on this card are: which memory space serves a table that
every thread of a warp reads at the same index (``__constant__``, shared
memory, ``__ldg`` global memory, or immediates compiled into the kernel),
what a per-thread gather costs, and whether a tensor-core sphere test pays.
Each probe keeps the reference's function name and computes the
reference's function; the kernels are hand-written CUDA C++ in
``csrc/probe_kernel.cu``.

For every probe this module holds:

- a kernel wrapper (``*_kernel``): launches the CUDA kernel for CUDA
  tensors, raises for any other tensor, counts its launches in ``LAUNCHES``;
- its plain PyTorch version (``*_plain``): what CPU tensors run, what the
  CPU tests hold against the JAX probe, and what ``chip_smoke.py`` holds the
  kernel against on the card;
- an entry point with the reference's name that makes the probe's table,
  checks that it fits the memory space (``fits``), and runs the kernel on
  the card or the plain version on the CPU (``device=None`` means the card
  and raises without one).

Inputs are arguments: the rays ``o, d`` of P5/P6 and P7's ``cm, r2, o, d``.
The tables are the reference's: ``arange`` tables for P1-P4 and P5/P6's
spheres ``arange(4S, float32) * 0.01``.

Shapes. The reference shape is one (8, 128) tile (P1-P6) or 1024 rays (P7):
the bitwise check. ``tiles`` repeats the tile: with 1024 tiles (2^20
threads or rays; P1/P2 1024 warps, one fold a tile) every SM of the card is
busy, which is the timing shape; one tile alone would occupy one SM of 132
and measure latency.

``python -m rust_tracing_tpu_torch.probes`` runs the sweep on the card (the
reference's ``__main__``) and prints one JSON line per (probe, variant,
size).
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import numpy as np
import torch

from .config import resolve_device
from .runtime.kernels import LAUNCHES

ROWS, LANES = 8, 128
TILE = ROWS * LANES

# Memory spaces a probe table can live in. The card's limits stand in for
# the TPU's question "how big can SMEM be": 64 KB of __constant__ data, and
# 227 KB (232 448 bytes) of shared memory a block.
SPACES = ("constant", "shared", "global")
CONSTANT_FLOATS = 16384
SHARED_FLOATS = 232448 // 4
SPACE_CODE = {"constant": 0, "shared": 1, "global": 2}

SMEM_SIZES = (128, 1024, 4096, 16384, 65536)  # P1, the reference's sizes
ROW_N = 256                                    # P2, the reference's rows
GATHER_N = 256                                 # P3/P4 table rows
GATHER_STRIDE = 13                             # the reference's lane stride
# P3's lane strides. Over 32 four-byte banks a warp's 32 lanes gather
# (7 r + s l) % 256: stride 13 is conflict-free, 2 gives 2-way conflicts and
# 16 and 32 give 8-way conflicts (a 256-entry column has 8 entries a bank);
# ``bank_conflict_ways`` counts them.
GATHER_STRIDES = (13, 2, 16, 32)
SPHERES, REPS = 256, 64                        # P5-P7, the reference's sweep
IMMEDIATE_SPHERES = (64, 256)                  # P6's compiled sphere counts
MXU_RAYS, MXU_K = 1024, 8                      # P7's rays and padded xyz
FILL_TILES = 1024                              # the card-filling shape
GATHER_TIMING_REPS = 64                        # gathers a thread when timed
# P3/P4 stage their table once a block, followed by its first
# MAX_GATHERS - 1 entries (rows) again, so that the gather at offset k reads
# s[base + k] with no wrap: reps is at most MAX_GATHERS.
MAX_GATHERS = 64
NO_HIT = 1e30

# Published peaks of one H100 SXM (NVIDIA data sheet): float32 outside the
# tensor cores, dense TF32 on the tensor cores, device memory bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
# Operations, counted from csrc/probe_kernel.cu, each issued as an
# instruction of its own (--fmad=false: no multiply and add fuse). A sphere
# test (P5, P6): 3 subtractions, hb 5, c 6, disc 3, max, sqrt, the
# subtraction and the division of t, 3 compares and a select. P7 a (ray,
# sphere) pair: two 8-term products (8 multiplies and 7 adds each) and the
# kernels' epilogue, which leaves the division to the ray (c 3, disc 3, a
# select in place of the max, sqrt, num = -hd - root, 2 compares, min and
# select); a ray a round: the threshold's multiply and its check (a
# division and a compare), the division of the least num and the min into
# the ray's t; a ray: two 8-term squared norms. On the tensor cores (P7's
# TF32 variant) a product is 8 multiply-adds, 16 operations in the unit of
# their peak.
FLOP_PER_SPHERE_TEST = 25
FLOP_PER_MXU_PRODUCTS = 30
FLOP_PER_MXU_EPILOGUE = 13
FLOP_PER_MXU_RAY_ROUND = 5
FLOP_PER_MXU_RAY = 30
TC_FLOP_PER_MXU_PRODUCTS = 32

# P7's tensor-core variant rounds each operand of the two products to TF32
# (cvt.rna: 10 stored mantissa bits, relative error <= 2^-11), so a product
# term is off by at most 2^-10 + 2^-22 of its size; both variants add the 8
# terms in f32 (at most 8 roundings of 2^-24, and the tensor core's own
# accumulation, which NVIDIA does not specify as round-to-nearest), which
# 2^-18 of the terms' absolute sum covers. A product of the two variants
# therefore differs by at most TF32_PROD_RTOL * sum_k |x_k| |cm_kj|. The
# same bound, carried through the epilogue, says which rays' t may move by
# more than TF32_T_RTOL (``mxu_at_risk``).
TF32_PROD_RTOL = 2.0 ** -10 + 2.0 ** -18
TF32_T_RTOL = 1e-3

# P5-P7 issue each f32 operation of a sphere test as an instruction of its
# own: the sources build with --fmad=false, so no multiply and add fuse into
# one FMA, and the 67 TFLOP/s peak (an FMA counted as two operations) is out
# of reach. Their bound has a fourth term, the lanes' issue: one operation a
# lane a clock, FP32_LANES_PER_SM lanes on each SM at SM_CLOCK_HZ (P7's TF32
# variant: its epilogue, thresholds and norms; its products go to the
# tensor cores).
# SM_COUNT is the H100 SXM's; the sweep reads the card's own.
SM_COUNT = 132
FP32_LANES_PER_SM = 128
ISSUE_PROBES = ("P5", "P6", "P7")

# P1/P2 fold a tile's sum in index order: n dependent f32 adds, whatever the
# card's rates, so their bound has a third term, the chain. The latency of a
# dependent FADD, in SM clocks, was measured on an NVIDIA H100 80GB HBM3
# (700 W) by a clock64() chain of 65 536 adds (PERF.md, Findings); the clock
# is the card's maximum SM clock (nvidia-smi clocks.max.sm).
FADD_LATENCY_CLOCKS = 4
SM_CLOCK_HZ = 1980e6
FOLD_PROBES = ("P1", "P2")
# P3/P4's shared variants are bound by shared memory's wavefronts: one a
# clock an SM (the model of B7's smem floor), a warp's 4-byte gather taking
# as many as its lanes' bank conflicts (``bank_conflict_ways``; P4: 1).
GATHER_PROBES = ("P3", "P4")
# Tile counts of the persistent kernels' extra check (P1-P4): odd, so never
# a multiple of a grid's warps, and 9001 beyond the warps that fit the card
# (132 SMs x 64), so warps take several tiles (P1/P2 a tile a warp, P3/P4
# 32 elements of a tile a warp).
UNEVEN_TILES = (133, 9001)
UNEVEN_PROBES = FOLD_PROBES + GATHER_PROBES
RAGGED = 5  # the extra check also folds a table this much shorter
HOLD_TRIES = 4  # time_ms: holds of the stream, each 4x the last


def chain_floor_ms(n: int) -> float:
    """The least time of one index-order fold of n f32 values: n dependent
    adds at FADD_LATENCY_CLOCKS each, at SM_CLOCK_HZ. Tiles fold in
    parallel, so it is the floor of a P1/P2 call."""
    return n * FADD_LATENCY_CLOCKS / SM_CLOCK_HZ * 1e3


def issue_floor_ms(flop: float, sms: int = SM_COUNT) -> float:
    """The least time of ``flop`` f32 operations issued one a lane slot:
    ``sms`` SMs of FP32_LANES_PER_SM lanes at SM_CLOCK_HZ (P5-P7)."""
    return flop / (sms * FP32_LANES_PER_SM * SM_CLOCK_HZ) * 1e3


def smem_floor_ms(wavefronts: float, sms: int = SM_COUNT) -> float:
    """The least time of ``wavefronts`` shared-memory wavefronts, one a
    clock on each of ``sms`` SMs at SM_CLOCK_HZ (P3/P4's shared
    variants)."""
    return wavefronts / (sms * SM_CLOCK_HZ) * 1e3


def fits(space: str, n_floats: int) -> bool:
    """Whether a table of ``n_floats`` f32 fits memory space ``space`` on
    the card: __constant__ holds 16 384, shared memory 58 112 a block,
    global memory any."""
    if space not in SPACE_CODE:
        raise ValueError(f"space must be one of {SPACES}, got {space!r}")
    if space == "constant":
        return n_floats <= CONSTANT_FLOATS
    if space == "shared":
        return n_floats <= SHARED_FLOATS
    return True


def check_fits(space: str, n_floats: int) -> None:
    """Raise ValueError when the table does not fit ``space``; nothing is
    launched then."""
    if not fits(space, n_floats):
        limit = CONSTANT_FLOATS if space == "constant" else SHARED_FLOATS
        raise ValueError(f"a table of {n_floats} f32 does not fit {space} "
                         f"memory ({limit} f32 at most)")


def bank_conflict_ways(stride: int, row: int = 0) -> int:
    """Shared-memory bank conflict degree of P3's gather from a contiguous
    256-entry column: the most distinct addresses that one warp's 32 lanes
    ask of one 4-byte bank (1 = conflict-free)."""
    idx = (7 * row + stride * np.arange(32)) % GATHER_N
    return max(len(set(idx[idx % 32 == b])) for b in range(32))


# ------------------------------------------------------------- plumbing
def _cuda_f32(name, *tensors):
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name} needs CUDA tensors, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes f32 tensors, got {t.dtype}")
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on different devices")
    return dev


def _launch(name, fn, dev, *args):
    from .runtime import kernels

    lib = kernels.load()
    with torch.cuda.device(dev):
        err = getattr(lib, fn)(*args,
                               torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES[name] += 1
    kernels.check(err, name)


def _tiled(value: torch.Tensor, tiles: int) -> torch.Tensor:
    """(8, 128) -> (8, 128) for one tile, else (tiles, 8, 128)."""
    if tiles == 1:
        return value.contiguous()
    return value.expand((tiles, ROWS, LANES)).contiguous()


def _tile_out(tiles: int, dev) -> torch.Tensor:
    if tiles < 1:
        raise ValueError(f"tiles must be >= 1, got {tiles}")
    shape = (ROWS, LANES) if tiles == 1 else (tiles, ROWS, LANES)
    return torch.empty(shape, dtype=torch.float32, device=dev)


def _shared_or_global(name: str, space: str) -> None:
    if space not in ("shared", "global"):
        raise ValueError(f"{name} reads from shared or global memory, got "
                         f"{space!r}")


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (P1/P2's folds and
    P5's sphere loop read it as float4, P4 stages it so): a view that
    starts elsewhere is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _fold(values: torch.Tensor) -> torch.Tensor:
    """The f32 sum of a 1-D tensor in index order, one add a step."""
    s = torch.zeros((), dtype=torch.float32, device=values.device)
    for v in values.unbind():
        s = s + v
    return s


def _is_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


# ------------------------------------------------ P1: scalar table reads
def smem_scalar_plain(tab: torch.Tensor, tiles: int = 1) -> torch.Tensor:
    """Plain version of ``smem_scalar_kernel``: the f32 sum of ``tab`` in
    index order (the reference's ``fori_loop``), broadcast to the tiles."""
    return _tiled(_fold(tab).expand(ROWS, LANES), tiles)


def smem_scalar_kernel(tab: torch.Tensor, space: str,
                       tiles: int = 1) -> torch.Tensor:
    """One warp a tile folds ``tab[0..n)`` in index order from memory space
    ``space`` and fills the tile with the sum; ``tiles`` (8, 128) tiles."""
    dev = _cuda_f32("smem_scalar_kernel", tab)
    if tab.ndim != 1 or tab.numel() < 1:
        raise ValueError(f"smem_scalar_kernel takes a 1-D table, got "
                         f"{tuple(tab.shape)}")
    n = tab.numel()
    check_fits(space, n)
    tab = _aligned16(tab)
    out = _tile_out(tiles, dev)
    _launch("smem_scalar_kernel", "rt_probe_smem_scalar_launch", dev,
            tab.data_ptr(), n, SPACE_CODE[space], out.data_ptr(),
            tiles * TILE)
    return out


def smem_scalar(n: int, space: str = "constant",
                device=None) -> torch.Tensor:
    """P1 (scripts/tpu_probe.py ``smem_scalar``): the sum of
    ``arange(n, float32)`` read one scalar a step, broadcast to a tile.
    At n = 65536 the f32 sum is 2147421200.0, not the exact 2147450880."""
    check_fits(space, n)
    tab = torch.arange(n, dtype=torch.float32, device=resolve_device(device))
    if _is_cpu(tab):
        return smem_scalar_plain(tab)
    return smem_scalar_kernel(tab, space)


# ------------------------------------------- P2: row reads + broadcast
def vmem_row_broadcast_plain(tab: torch.Tensor,
                             tiles: int = 1) -> torch.Tensor:
    """Plain version of ``vmem_row_broadcast_kernel``: the sum of
    ``tab[i, 0]`` in row order, broadcast to the tiles."""
    return _tiled(_fold(tab[:, 0]).expand(ROWS, LANES), tiles)


def vmem_row_broadcast_kernel(tab: torch.Tensor, space: str,
                              tiles: int = 1) -> torch.Tensor:
    """One warp a tile reads row i of the (n, 128) table whole, one float4
    a lane (from ``space``: shared or global), and adds lane 0's first value
    after a broadcast, n rows in order; the sum fills the tile."""
    dev = _cuda_f32("vmem_row_broadcast_kernel", tab)
    if tab.ndim != 2 or tab.shape[1] != LANES or tab.shape[0] < 1:
        raise ValueError(f"vmem_row_broadcast_kernel takes an (n, {LANES}) "
                         f"table, got {tuple(tab.shape)}")
    _shared_or_global("vmem_row_broadcast_kernel", space)
    check_fits(space, tab.numel())
    tab = _aligned16(tab)
    out = _tile_out(tiles, dev)
    _launch("row_broadcast_kernel", "rt_probe_row_broadcast_launch", dev,
            tab.data_ptr(), tab.shape[0], SPACE_CODE[space], out.data_ptr(),
            tiles * TILE)
    return out


def vmem_row_broadcast(n: int = ROW_N, space: str = "shared",
                       device=None) -> torch.Tensor:
    """P2 (``vmem_row_broadcast``): the same sum as P1 over the rows of an
    (n, 128) table whose row i holds i."""
    check_fits(space, n * LANES)
    dev = resolve_device(device)
    tab = torch.arange(n, dtype=torch.float32, device=dev)[:, None].repeat(
        1, LANES)
    if _is_cpu(tab):
        return vmem_row_broadcast_plain(tab)
    return vmem_row_broadcast_kernel(tab, space)


# ------------------------------------------------- P3 / P4: gathers
def gather_index(stride: int = GATHER_STRIDE,
                 device="cpu") -> torch.Tensor:
    """The probes' (8, 128) gather index ``(7 row + stride lane) % 256``."""
    r = torch.arange(ROWS, dtype=torch.int64, device=device)[:, None]
    lane = torch.arange(LANES, dtype=torch.int64, device=device)[None, :]
    return (7 * r + stride * lane) % GATHER_N


def _gather_sum(pick, idx, reps):
    """``pick((idx + 0) % 256) + pick((idx + 1) % 256) + ...`` in order;
    ``reps`` = 1 is the reference's single gather."""
    acc = pick(idx)
    for k in range(1, reps):
        acc = acc + pick((idx + k) % GATHER_N)
    return acc


def vmem_gather_plain(tab: torch.Tensor, stride: int = GATHER_STRIDE,
                      reps: int = 1, tiles: int = 1) -> torch.Tensor:
    """Plain version of ``vmem_gather_kernel``: ``tab[idx, 0]`` (summed
    over ``reps`` offsets of the index), broadcast to the tiles."""
    col = tab[:, 0]
    idx = gather_index(stride, tab.device)
    return _tiled(_gather_sum(lambda i: col[i], idx, reps), tiles)


def _gather_reps(name: str, space: str, reps: int) -> int:
    """Refuse a space P3/P4 do not read from, and a ``reps`` beyond what
    their staged copy covers (1..MAX_GATHERS), before any launch."""
    _shared_or_global(name, space)
    if isinstance(reps, bool) or not isinstance(reps, (int, np.integer)):
        raise TypeError(f"{name}: reps must be an integer, got {reps!r}")
    if not 1 <= reps <= MAX_GATHERS:
        raise ValueError(f"{name}: reps must be in 1..{MAX_GATHERS} (the "
                         f"staged table repeats its first {MAX_GATHERS - 1} "
                         f"entries), got {reps}")
    return int(reps)


def vmem_gather_kernel(tab: torch.Tensor, space: str,
                       stride: int = GATHER_STRIDE, reps: int = 1,
                       tiles: int = 1) -> torch.Tensor:
    """Each thread gathers ``tab[idx, 0]`` from column 0 of the (256, 128)
    table, staged in shared memory or read with ``__ldg``; ``reps`` > 1
    (at most MAX_GATHERS) adds the gathers at ``reps`` offsets of the
    index, in order (to time the gather and its bank conflicts, not the
    launch). The index is mod 256, so the stride is taken mod 256 here (a
    negative stride reads as its residue); a stride that is not an integer
    is refused. Blocks of 32 warps, as many as fit the card at once, stage
    the column once and take 32 elements of a tile a warp."""
    reps = _gather_reps("vmem_gather_kernel", space, reps)
    if isinstance(stride, bool) or not isinstance(stride, (int, np.integer)):
        raise TypeError(f"vmem_gather_kernel: stride must be an integer, "
                        f"got {stride!r}")
    dev = _cuda_f32("vmem_gather_kernel", tab)
    if tuple(tab.shape) != (GATHER_N, LANES):
        raise ValueError(f"vmem_gather_kernel takes a ({GATHER_N}, {LANES}) "
                         f"table, got {tuple(tab.shape)}")
    tab = tab.contiguous()
    out = _tile_out(tiles, dev)
    _launch("gather_probe_kernel", "rt_probe_gather_launch", dev,
            tab.data_ptr(), int(stride) % GATHER_N, reps, SPACE_CODE[space],
            out.data_ptr(), tiles * TILE)
    return out


def gather_table(device):
    """P3's (256, 128) table, row i holding i."""
    return torch.arange(GATHER_N, dtype=torch.float32,
                        device=device)[:, None].repeat(1, LANES)


def vmem_gather(space: str = "shared", stride: int = GATHER_STRIDE,
                device=None) -> torch.Tensor:
    """P3 (``vmem_gather``): a per-thread gather from one 256-entry column
    (row i holds i) at ``(7 row + stride lane) % 256``."""
    tab = gather_table(resolve_device(device))
    if _is_cpu(tab):
        return vmem_gather_plain(tab, stride)
    return vmem_gather_kernel(tab, space, stride)


def gather_2d_table(device):
    """P4's (256, 128) table holding ``row + 1000 lane``."""
    return (torch.arange(GATHER_N, dtype=torch.float32, device=device)[:, None]
            + torch.arange(LANES, dtype=torch.float32, device=device)[None, :]
            * 1000)


def vmem_gather_2d_plain(tab: torch.Tensor, reps: int = 1,
                         tiles: int = 1) -> torch.Tensor:
    """Plain version of ``vmem_gather_2d_kernel``: ``take_along_axis(tab,
    idx, 0)``, each lane down its own column."""
    idx = gather_index(GATHER_STRIDE, tab.device)
    out = _gather_sum(lambda i: torch.take_along_dim(tab, i, 0), idx, reps)
    return _tiled(out, tiles)


def vmem_gather_2d_kernel(tab: torch.Tensor, space: str, reps: int = 1,
                          tiles: int = 1) -> torch.Tensor:
    """Each thread gathers ``tab[idx, lane]`` from the whole (256, 128)
    table, staged in shared memory (128 KB and its first ``reps`` - 1 rows
    again, by 16-byte loads, once a block) or read with ``__ldg``;
    ``reps`` as for ``vmem_gather_kernel``."""
    reps = _gather_reps("vmem_gather_2d_kernel", space, reps)
    dev = _cuda_f32("vmem_gather_2d_kernel", tab)
    if tuple(tab.shape) != (GATHER_N, LANES):
        raise ValueError(f"vmem_gather_2d_kernel takes a ({GATHER_N}, "
                         f"{LANES}) table, got {tuple(tab.shape)}")
    tab = _aligned16(tab)
    out = _tile_out(tiles, dev)
    _launch("gather_2d_kernel", "rt_probe_gather_2d_launch", dev,
            tab.data_ptr(), reps, SPACE_CODE[space], out.data_ptr(),
            tiles * TILE)
    return out


def vmem_gather_2d(space: str = "shared", device=None) -> torch.Tensor:
    """P4 (``vmem_gather_2d``): the gather down each lane's own column of a
    (256, 128) table holding ``row + 1000 lane``."""
    tab = gather_2d_table(resolve_device(device))
    if _is_cpu(tab):
        return vmem_gather_2d_plain(tab)
    return vmem_gather_2d_kernel(tab, space)


# ---------------------------------------------- P5 / P6: sphere loops
def sphere_table(S: int, device="cpu") -> torch.Tensor:
    """The reference's spheres: ``arange(4S, float32) * 0.01``, as
    (cx, cy, cz, r2) quadruples."""
    return torch.arange(4 * S, dtype=torch.float32, device=device) * 0.01


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root on every device, as the kernels'
    ``sqrtf``: PyTorch's vectorised float sqrt on the CPU is off by an ulp
    for ~0.7 % of inputs; the double root of an f32 rounded once to f32 is
    exact."""
    return torch.sqrt(x.double()).float()


def _check_rays(name, o, d):
    if o.shape != d.shape or o.ndim < 2 or o.shape[0] != 3:
        raise ValueError(f"{name} takes rays o, d of one shape (3, ...), got "
                         f"{tuple(o.shape)} and {tuple(d.shape)}")


def sphere_loop_plain(sph: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                      reps: int) -> torch.Tensor:
    """Plain version of the sphere loops (P5, P6): the closest-hit t of
    each ray over the spheres of ``sph``, ``reps`` rounds. The reference's
    operations in its order, every sphere at once; the loop's running
    ``where(ok & (t < best), t, best)`` is the exact minimum over the hits,
    so each round is a min-reduction, bit for bit the loop."""
    _check_rays("sphere_loop_plain", o, d)
    shape = (-1,) + (1,) * (o.ndim - 1)
    cx, cy, cz, r2 = (sph[j::4].reshape(shape) for j in range(4))
    ox, oy, oz = o
    dx, dy, dz = d
    a = dx * dx + dy * dy + dz * dz
    best = torch.full(o.shape[1:], NO_HIT, dtype=torch.float32,
                      device=o.device)
    for _ in range(reps):
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        hb = ocx * dx + ocy * dy + ocz * dz
        c = ocx * ocx + ocy * ocy + ocz * ocz - r2
        disc = hb * hb - a * c
        t = (-hb - _sqrt_rn(torch.clamp_min(disc, 0.0))) / a
        ok = (disc > 0.0) & (t > 1e-3)
        best = torch.minimum(best, torch.where(ok, t, NO_HIT).amin(0))
    return best


def sphere_loop_kernel(sph: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                       reps: int, space: str) -> torch.Tensor:
    """One thread a ray: the brute loop over the spheres of ``sph`` read
    from ``space`` (constant, shared or global), ``reps`` rounds. Returns
    ``o.shape[1:]``."""
    dev = _cuda_f32("sphere_loop_kernel", sph, o, d)
    _check_rays("sphere_loop_kernel", o, d)
    if sph.ndim != 1 or sph.numel() % 4 or sph.numel() == 0:
        raise ValueError(f"sphere_loop_kernel takes a (4S,) sphere table, "
                         f"got {tuple(sph.shape)}")
    check_fits(space, sph.numel())
    o, d, sph = o.contiguous(), d.contiguous(), _aligned16(sph)
    out = torch.empty(o.shape[1:], dtype=torch.float32, device=dev)
    _launch("sphere_loop_kernel", "rt_probe_sphere_loop_launch", dev,
            sph.data_ptr(), sph.numel() // 4, o.data_ptr(), d.data_ptr(),
            out.numel(), int(reps), SPACE_CODE[space], out.data_ptr())
    return out


def sphere_loop_smem(S: int, reps: int, o: torch.Tensor, d: torch.Tensor,
                     space: str = "constant") -> torch.Tensor:
    """P5 (``sphere_loop_smem``): S spheres read from a table in
    ``space``; the kernel for CUDA rays, the plain version for CPU rays."""
    check_fits(space, 4 * S)
    sph = sphere_table(S, o.device)
    if _is_cpu(o):
        return sphere_loop_plain(sph, o, d, reps)
    return sphere_loop_kernel(sph, o, d, reps, space)


def sphere_immediate_kernel(S: int, o: torch.Tensor, d: torch.Tensor,
                            reps: int) -> torch.Tensor:
    """The brute loop with the spheres compiled into the kernel as
    immediates (``float(k) * 0.01f``, folded by nvcc to the table's f32
    values), one instantiation per S in ``IMMEDIATE_SPHERES``."""
    dev = _cuda_f32("sphere_immediate_kernel", o, d)
    _check_rays("sphere_immediate_kernel", o, d)
    if S not in IMMEDIATE_SPHERES:
        raise ValueError(f"sphere_immediate_kernel is compiled for S in "
                         f"{IMMEDIATE_SPHERES}, got {S}")
    o, d = o.contiguous(), d.contiguous()
    out = torch.empty(o.shape[1:], dtype=torch.float32, device=dev)
    _launch("sphere_immediate_kernel", "rt_probe_sphere_immediate_launch",
            dev, int(S), o.data_ptr(), d.data_ptr(), out.numel(), int(reps),
            out.data_ptr())
    return out


def sphere_loop_immediate(S: int, reps: int, o: torch.Tensor,
                          d: torch.Tensor) -> torch.Tensor:
    """P6 (``sphere_loop_immediate``): P5's loop with the spheres as
    compile-time immediates; the plain version is P5's."""
    if _is_cpu(o):
        return sphere_loop_plain(sphere_table(S, o.device), o, d, reps)
    return sphere_immediate_kernel(S, o, d, reps)


# ------------------------------------------- P7: leaf-batched products
def _rows_dot(x: torch.Tensor, cm: torch.Tensor) -> torch.Tensor:
    """``x @ cm`` for (R, 8) x (8, S), each entry summed over k in index
    order from the first product (the f32 kernel's order)."""
    acc = x[:, 0:1] * cm[0:1, :]
    for k in range(1, x.shape[1]):
        acc = acc + x[:, k:k + 1] * cm[k:k + 1, :]
    return acc


def _rows_norm2(x: torch.Tensor) -> torch.Tensor:
    """Each row's sum of squares, (R, 1), in index order."""
    acc = x[:, 0:1] * x[:, 0:1]
    for k in range(1, x.shape[1]):
        acc = acc + x[:, k:k + 1] * x[:, k:k + 1]
    return acc


def _mxu_t(hd, ho, a, o2, c2):
    """The reference's placeholder algebra on the two products: each
    (ray, sphere)'s t, and whether it counts as a hit."""
    c = o2 - 2.0 * ho + c2
    disc = hd * hd - a * c
    t = (-hd - _sqrt_rn(torch.clamp_min(disc, 0.0))) / a
    return t, disc, (disc > 0.0) & (t > 1e-3)


# The reference's hit test t > 1e-3, in f32 (a Python float meets an f32
# tensor as an f32, as in the kernels' t > 1e-3f). The kernels of P7 divide
# once a ray a round: ok = disc > 0 && num >= thr, num = -hd - root, with
# thr the least f32 whose IEEE quotient by a exceeds T_MIN. IEEE division
# by a > 0 is monotone in the numerator, so num >= thr iff num / a > T_MIN,
# and the least num over the hits, divided by a, is the least t.
T_MIN = np.float32(1e-3)
THRESHOLD_STEPS = 4  # ulps either way from T_MIN * a (numpy: at most 2)


def mxu_threshold_np(a: np.ndarray) -> np.ndarray:
    """The least f32 x with ``x / a > T_MIN`` (IEEE f32 division), per entry
    of the f32 array ``a`` (>= +0; a ray's d . d), as the kernels find it:
    from ``T_MIN * a``, down while the float below still exceeds, then up
    until one exceeds, each at most THRESHOLD_STEPS ulps. NaN where no float
    does (a = +inf or NaN). a = +0 gives the least subnormal (x / 0 = inf)."""
    a = np.asarray(a, np.float32)
    with np.errstate(all="ignore"):
        x = T_MIN * a
        down = np.ones(a.shape, bool)
        for _ in range(THRESHOLD_STEPS):
            below = np.nextafter(x, np.float32(-np.inf))
            down &= below / a > T_MIN
            x = np.where(down, below, x)
        for _ in range(THRESHOLD_STEPS):
            x = np.where(x / a > T_MIN, x, np.nextafter(x, np.float32(np.inf)))
        return np.where(x / a > T_MIN, x, np.float32(np.nan))


def _check_mxu(name, cm, r2, o, d):
    if (cm.ndim != 2 or cm.shape[0] != MXU_K or r2.shape != cm.shape
            or o.ndim != 2 or o.shape[1] != MXU_K or d.shape != o.shape):
        raise ValueError(f"{name} takes cm, r2 ({MXU_K}, S) and o, d "
                         f"(R, {MXU_K}), got {tuple(cm.shape)}, "
                         f"{tuple(r2.shape)}, {tuple(o.shape)}, "
                         f"{tuple(d.shape)}")


def sphere_mxu_plain(cm: torch.Tensor, r2: torch.Tensor, o: torch.Tensor,
                     d: torch.Tensor, reps: int) -> torch.Tensor:
    """Plain version of ``sphere_mxu_kernel`` (f32): per round the products
    ``d @ cm`` and ``o @ cm`` summed in index order, the reference's
    placeholder algebra, the min over spheres; (R, 1)."""
    _check_mxu("sphere_mxu_plain", cm, r2, o, d)
    a, o2 = _rows_norm2(d), _rows_norm2(o)
    c2 = r2[0:1, :]
    best = torch.full((o.shape[0], 1), NO_HIT, dtype=torch.float32,
                      device=o.device)
    for _ in range(reps):
        t, _, ok = _mxu_t(_rows_dot(d, cm), _rows_dot(o, cm), a, o2, c2)
        best = torch.minimum(best, torch.where(ok, t, NO_HIT).amin(
            1, keepdim=True))
    return best


def sphere_mxu_kernel(cm: torch.Tensor, r2: torch.Tensor, o: torch.Tensor,
                      d: torch.Tensor, reps: int, tensor_cores: bool = False,
                      products: bool = False):
    """P7 on the card. ``tensor_cores=False``: one thread a ray, both
    products in f32 on the CUDA cores in index order (bit for bit the plain
    version). ``tensor_cores=True``: one warp per 16 rays, the products as
    ``mma.sync`` m16n8k8 TF32 tiles, the epilogue in f32. Returns t (R, 1),
    and with ``products`` also the two products of the first round, (2, R,
    S), for the TF32 gate."""
    dev = _cuda_f32("sphere_mxu_kernel", cm, r2, o, d)
    _check_mxu("sphere_mxu_kernel", cm, r2, o, d)
    R, S = o.shape[0], cm.shape[1]
    if tensor_cores and (R % 16 or S % 8):
        raise ValueError(f"the tensor-core variant takes R % 16 == 0 and "
                         f"S % 8 == 0, got R={R}, S={S}")
    if products and not tensor_cores:
        raise ValueError("only the tensor-core variant writes its products")
    cm, r2, o, d = (t.contiguous() for t in (cm, r2, o, d))
    out = torch.empty((R, 1), dtype=torch.float32, device=dev)
    prods = (torch.empty((2, R, S), dtype=torch.float32, device=dev)
             if products else None)
    name = "sphere_mxu_tc_kernel" if tensor_cores else "sphere_mxu_kernel"
    _launch(name, "rt_probe_sphere_mxu_launch", dev, cm.data_ptr(),
            r2.data_ptr(), S, o.data_ptr(), d.data_ptr(), R, int(reps),
            int(tensor_cores), out.data_ptr(),
            prods.data_ptr() if products else None)
    return (out, prods) if products else out


def sphere_mxu(cm: torch.Tensor, r2: torch.Tensor, o: torch.Tensor,
               d: torch.Tensor, reps: int,
               tensor_cores: bool = False) -> torch.Tensor:
    """P7 (``sphere_mxu``): the leaf-batched sphere test as two products,
    placeholder algebra (throughput only); the kernel for CUDA tensors, the
    f32 plain version for CPU tensors."""
    if _is_cpu(o):
        return sphere_mxu_plain(cm, r2, o, d, reps)
    return sphere_mxu_kernel(cm, r2, o, d, reps, tensor_cores)


def mxu_products_plain(cm, o, d) -> torch.Tensor:
    """The f32 variant's two products, (2, R, S)."""
    return torch.stack([_rows_dot(d, cm), _rows_dot(o, cm)])


def mxu_at_risk(cm, r2, o, d, rtol=TF32_PROD_RTOL) -> torch.Tensor:
    """Rays (R,) whose t may move by more than TF32_T_RTOL relative when
    each product moves by up to ``rtol`` of its terms' absolute sum. The
    product bound is carried through the epilogue (plus the f32 rounding of
    c and disc): each sphere's t lies in [t_min, t_max]; a sphere that may
    be a hit (disc may be > 0, t_max > 1e-3) bounds the ray's t from below
    by max(t_min, 1e-3), one that is surely a hit bounds it from above by
    t_max. Both variants' t lie between the ray's two bounds."""
    hd, ho = mxu_products_plain(cm, o, d)
    a, o2 = _rows_norm2(d), _rows_norm2(o)
    c2 = r2[0:1, :]
    t, disc, _ = _mxu_t(hd, ho, a, o2, c2)
    eps = 2.0 ** -23
    e_d = rtol * _rows_dot(d.abs(), cm.abs())
    c = o2 - 2.0 * ho + c2
    e_c = (2.0 * rtol * _rows_dot(o.abs(), cm.abs())
           + eps * (o2 + 2.0 * ho.abs() + c2.abs()))
    e_disc = (2.0 * hd.abs() * e_d + e_d * e_d + a * e_c
              + 2 * eps * (hd * hd + (a * c).abs()))
    sq = _sqrt_rn(torch.clamp_min(disc, 0.0))
    sq_hi = _sqrt_rn(torch.clamp_min(disc + e_disc, 0.0))
    sq_lo = _sqrt_rn(torch.clamp_min(disc - e_disc, 0.0))
    pos = disc > e_disc
    slack = 1 + 2.0 ** -10
    e_t = (e_d + e_disc / torch.where(pos, sq + sq_lo, 1.0)) / a * slack
    t_min = torch.where(pos, t - e_t, (-hd - e_d - sq_hi) / a * slack)
    t_max = torch.where(pos, t + e_t, (-hd + e_d) / a * slack)
    t_min = t_min - 4 * eps * t.abs()
    t_max = t_max + 4 * eps * t.abs()
    may = (disc + e_disc > 0) & (t_max > 1e-3)
    sure = pos & (t_min > 1e-3)
    lo = torch.where(may, torch.clamp_min(t_min, 1e-3), NO_HIT).amin(1)
    hi = torch.where(sure, t_max, NO_HIT).amin(1)
    best = torch.where((disc > 0) & (t > 1e-3), t, NO_HIT).amin(1)
    return (hi - lo) > TF32_T_RTOL * best


def tf32_gate(cm, r2, o, d, t_tc, prods_tc, reps=1, t_ref=None) -> dict:
    """The tensor-core variant's gate against the f32 plain version: every
    product within TF32_PROD_RTOL of its terms' absolute sum, and every ray
    whose t moved by more than TF32_T_RTOL relative among the rays that
    ``mxu_at_risk`` allows to move."""
    ref_p = mxu_products_plain(cm, o, d)
    scale = torch.stack([_rows_dot(d.abs(), cm.abs()),
                         _rows_dot(o.abs(), cm.abs())])
    ratio = ((prods_tc - ref_p).abs() / scale.clamp_min(1e-30)).max().item()
    if t_ref is None:
        t_ref = sphere_mxu_plain(cm, r2, o, d, reps)
    t_ref = t_ref.reshape(-1)
    moved = (t_tc.reshape(-1) - t_ref).abs() > TF32_T_RTOL * t_ref.abs()
    risk = mxu_at_risk(cm, r2, o, d)
    ok = ratio <= TF32_PROD_RTOL and not bool((moved & ~risk).any())
    return dict(prod_err_over_abs_sum=ratio, prod_rtol=TF32_PROD_RTOL,
                moved_share=float(moved.float().mean()),
                at_risk_share=float(risk.float().mean()),
                moved_outside_risk=int((moved & ~risk).sum()), ok=ok)


# ------------------------------------------------------------- the sweep
def rays(seed: int, tiles: int = 1, device=None):
    """P5/P6's rays: o, d (3, 8, 128) standard normal from numpy's
    generator ``seed``, repeated to (3, tiles, 8, 128) for tiles > 1."""
    g = np.random.default_rng(seed)
    o, d = (torch.from_numpy(g.standard_normal((3, ROWS, LANES)).astype(
        np.float32)).to(resolve_device(device)) for _ in range(2))
    if tiles > 1:
        o, d = (x[:, None].expand(3, tiles, ROWS, LANES).contiguous()
                for x in (o, d))
    return o, d


def _terms_np(cx, cy, cz, r2, o, d):
    """(disc, t) of spheres (cx, cy, cz, r2) against rays o, d (3, ...),
    broadcast, in numpy f32 with IEEE subnormals: the sphere test's
    operations in the plain version's order."""
    ox, oy, oz = o
    dx, dy, dz = d
    a = dx * dx + dy * dy + dz * dz
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    hb = ocx * dx + ocy * dy + ocz * dz
    c = ocx * ocx + ocy * ocy + ocz * ocz - r2
    disc = hb * hb - a * c
    with np.errstate(all="ignore"):
        t = (-hb - np.sqrt(np.maximum(disc, np.float32(0.0)))) / a
    return disc, t


def sphere_terms_np(sph: np.ndarray, o: np.ndarray, d: np.ndarray):
    """(disc, t) of every (sphere, ray) pair, (S, R), for the (4S,) table
    sph and rays o, d (3, R), in numpy f32 (``_terms_np``)."""
    return _terms_np(*(sph[j::4][:, None] for j in range(4)), o, d)


def _first_hit_np(sph, o, d):
    """Each ray's closest hit (t, sphere) over one round, numpy f32."""
    disc, t = sphere_terms_np(sph, o, d)
    t = np.where((disc > 0) & (t > np.float32(1e-3)), t, np.float32(NO_HIT))
    return t.min(0), t.argmin(0)


# The edge tile's directions: a graze's d = GRAZE_SCALE e_u gives a =
# 2^-120 and disc = 2^-120 x (a residual of f32 roundings near 1), so a
# positive disc there is subnormal; SUBNORMAL_SCALE makes every component
# of a direction subnormal (a and hb^2 underflow to 0).
GRAZE_SCALE = 2.0 ** -60
SUBNORMAL_SCALE = 2.0 ** -130
EDGE_OFFSETS = 8  # a graze's perpendicular offset: sqrt(r2) +- this many ulps


@functools.lru_cache(maxsize=1)
def _grazes():
    """Rays that graze a sphere of ``sphere_table(SPHERES)`` (built, not
    drawn): from one unit behind sphere k's centre along +-x, +-y or +-z,
    offset along another axis by f32 values around sqrt(r2_k), direction
    GRAZE_SCALE along the first axis. Returns o, d (3, N), each ray's
    sphere k, its geometry (direction, offset axis, sphere) as one index,
    and its disc on k, each (N,)."""
    S = SPHERES
    tab = sphere_table(S).numpy()
    cen, r2 = tab.reshape(S, 4)[:, :3], tab.reshape(S, 4)[:, 3]
    combos = [(u, su, p, sp) for u in range(3) for su in (1, -1)
              for p in range(3) if p != u for sp in (1, -1)]
    y0 = np.sqrt(r2.astype(np.float64)).astype(np.float32)
    steps = np.arange(-EDGE_OFFSETS, EDGE_OFFSETS + 1)
    y = (y0[:, None] + steps * np.spacing(y0)[:, None]).astype(np.float32)
    o = np.broadcast_to(cen[None, :, None, :],
                        (len(combos), S, len(steps), 3)).copy()
    d = np.zeros_like(o)
    for m, (u, su, p, sp) in enumerate(combos):
        o[m, ..., u] -= np.float32(su)
        o[m, ..., p] += np.float32(sp) * y
        d[m, ..., u] = np.float32(su * GRAZE_SCALE)
    pair = np.broadcast_to(np.arange(len(combos) * S).reshape(-1, S, 1),
                           o.shape[:3]).reshape(-1)
    k = pair % S
    o, d = o.reshape(-1, 3).T.copy(), d.reshape(-1, 3).T.copy()
    disc = _terms_np(*tab.reshape(S, 4)[k].T, o, d)[0]  # on its own sphere
    return o, d, k, pair, disc


def _spread(idx: np.ndarray, n: int) -> np.ndarray:
    """n entries of idx spread evenly over it (all of it if shorter)."""
    if len(idx) <= n:
        return idx
    return idx[np.linspace(0, len(idx) - 1, n).round().astype(np.int64)]


def edge_rays(seed: int = 0, device="cpu"):
    """One extra (8, 128) tile of P5/P6 rays for the branches of the sphere
    test, built (only the origins of rows 0-2 and the directions of rows
    1-2 are drawn, standard normal from numpy's generator ``seed``):
    row 0 zero directions (a = 0, disc = +0 on every sphere, t NaN); row 1
    subnormal directions (lanes 0-63: a = 0, disc = +0) and tiny normal ones
    (lanes 64-127, GRAZE_SCALE: a = 2^-120, subnormal discs); row 2 origins
    at the centres of spheres 0-127; rows 3-4 grazes whose disc on their
    sphere is +0.0 exactly; rows 5-7 grazes whose disc is subnormal and
    positive, first those whose graze is the ray's closest hit among 64
    spheres, then among 256 (``IMMEDIATE_SPHERES``). Returns o, d (3, 8,
    128)."""
    o, d, k, pair, disc = _grazes()
    g = np.random.default_rng(seed)
    tile_o = g.standard_normal((3, ROWS, LANES)).astype(np.float32)
    tile_d = g.standard_normal((3, ROWS, LANES)).astype(np.float32)
    tile_d[:, 0] = 0.0
    tile_d[:, 1, :64] *= np.float32(SUBNORMAL_SCALE)
    tile_d[:, 1, 64:] *= np.float32(GRAZE_SCALE)
    tile_o[:, 2] = sphere_table(LANES).numpy().reshape(LANES, 4)[:, :3].T
    zero = np.flatnonzero(disc == 0)
    sub = np.flatnonzero((disc > 0) & (disc < np.finfo(np.float32).tiny))
    picks = []
    for S in IMMEDIATE_SPHERES:
        tab = sphere_table(S).numpy()
        cand = sub[k[sub] < S]
        # the first candidate of each (direction, offset axis, sphere) says
        # whether that geometry's graze is the closest hit; then all of
        # those that are
        first = cand[np.unique(pair[cand], return_index=True)[1]]
        t, win = _first_hit_np(tab, o[:, first], d[:, first])
        cand = cand[np.isin(pair[cand],
                            pair[first[(t < NO_HIT) & (win == k[first])]])]
        t, win = _first_hit_np(tab, o[:, cand], d[:, cand])
        picks.append(cand[(t < NO_HIT) & (win == k[cand])][:3 * LANES // 2])
    rest = np.setdiff1d(sub, np.concatenate(picks))
    sub_rows = np.concatenate(picks + [_spread(rest, 3 * LANES)])[:3 * LANES]
    rows = np.concatenate([_spread(zero, 2 * LANES), sub_rows])
    tile_o[:, 3:] = o[:, rows].reshape(3, 5, LANES)
    tile_d[:, 3:] = d[:, rows].reshape(3, 5, LANES)
    return (torch.from_numpy(tile_o).to(device),
            torch.from_numpy(tile_d).to(device))


def mxu_inputs(seed: int, S: int = SPHERES, tiles: int = 1, device=None):
    """P7's inputs from numpy's generator ``seed``: cm (8, S) and o, d
    (1024, 8) standard normal, r2 ones (the reference's draws' shapes); o,
    d repeated ``tiles`` times along the rays."""
    g = np.random.default_rng(seed)
    dev = resolve_device(device)
    o, d = (torch.from_numpy(g.standard_normal((MXU_RAYS, MXU_K)).astype(
        np.float32)).to(dev) for _ in range(2))
    cm = torch.from_numpy(g.standard_normal((MXU_K, S)).astype(
        np.float32)).to(dev)
    r2 = torch.ones((MXU_K, S), dtype=torch.float32, device=dev)
    if tiles > 1:
        o, d = o.repeat(tiles, 1), d.repeat(tiles, 1)
    return cm, r2, o, d


# P7's edge tile (``mxu_edge_inputs``): EDGE_CASE_RAYS rays of each case
# below, built against the sweep's spheres, then the sweep's own rays up to
# MXU_EDGE_RAYS: a multiple of 16 (the TF32 variant's tile) but not of 32,
# so that the last warp and the f32 variant's one block are ragged.
EDGE_CASE_RAYS = 4
MXU_EDGE_RAYS = 80
MXU_EDGE_CASES = ("t below T_MIN", "t on T_MIN", "t above T_MIN",
                  "-hd below thr", "-hd on thr", "-hd above thr",
                  "disc +0", "disc subnormal", "d zero")


def _mxu_pairs(cm, c2, o, d):
    """(hd, a, disc, t) of every (ray, sphere) pair, numpy f32 (R, S) (a
    (R, 1)), for spheres cm (8, S), c2 (S,) and rays o, d (R, 8): the plain
    version's helpers (``sphere_mxu_plain``) on the CPU."""
    cm, c2, o, d = (torch.from_numpy(np.array(x, np.float32))
                    for x in (cm, c2, o, d))
    hd, a = _rows_dot(d, cm), _rows_norm2(d)
    t, disc, _ = _mxu_t(hd, _rows_dot(o, cm), a, _rows_norm2(o), c2)
    return hd.numpy(), a.numpy(), disc.numpy(), t.numpy()


def _across(col, g):
    """A drawn unit vector orthogonal to ``col``."""
    w = g.standard_normal(len(col))
    w -= (w @ col) / (col @ col) * col
    return w / np.linalg.norm(w)


def _closest(hd, a, disc, t, row, j):
    """Whether sphere j gives row's least t > T_MIN, and no other does."""
    hit = (disc[row] > 0) & (t[row] > T_MIN)
    return bool(hit[j]) and (t[row][hit] == t[row, j]).sum() == 1 \
        and t[row, j] == t[row][hit].min()


def _edge_t_rays(cm, c2, g):
    """Rays whose t on a sphere j with disc > 0 is the float below T_MIN,
    T_MIN, or the float above (then j the ray's one closest hit): the
    threshold's edge. d = alpha u + beta w (u along cm_j, w across it)
    places -hd and a so that at t = T_MIN the root is 3/4 of -hd and c is
    5/4, where an ulp of c moves t by about an ulp; o = f e_m (m the largest
    |cm_mj|) sets c to each float near 5/4, f from c = f^2 - 2 f cm_mj + c2."""
    rho, ct, eps = 0.75, 1.25, float(T_MIN)
    a_t = ct * (1 - rho) / ((1 + rho) * eps ** 2)
    hd_t = eps * a_t / (1 - rho)
    targets = (np.nextafter(T_MIN, np.float32(0)), T_MIN,
               np.nextafter(T_MIN, np.float32(1)))
    found = [[] for _ in targets]
    for j in range(cm.shape[1]):
        col = cm[:, j].astype(np.float64)
        alpha = -hd_t / np.linalg.norm(col)
        if a_t <= alpha ** 2:
            continue
        d = (alpha * col / np.linalg.norm(col)
             + np.sqrt(a_t - alpha ** 2) * _across(col, g)).astype(np.float32)
        m = int(np.argmax(np.abs(col)))
        cv = ct + np.arange(-64, 65) * 2.0 ** -23
        f = col[m] - np.sign(col[m]) * np.sqrt(col[m] ** 2 - c2[j] + cv)
        o = np.zeros((len(f), MXU_K), np.float32)
        o[:, m] = f
        D = np.broadcast_to(d, o.shape)
        terms = _mxu_pairs(cm, c2, o, D)
        disc, t = terms[2][:, j], terms[3][:, j]
        for i, target in enumerate(targets):
            rows = [r for r in np.flatnonzero((disc > 0) & (t == target))
                    if i < 2 or _closest(*terms, r, j)]
            if rows and len(found[i]) < EDGE_CASE_RAYS:
                found[i].append((o[rows[0]], d))
        if min(map(len, found)) == EDGE_CASE_RAYS:
            return found
    raise RuntimeError("no rays found for the threshold's edge")


def _edge_hd_rays(cm, c2, g):
    """Rays whose -hd on a sphere j with disc > 0 is the float below the
    threshold thr(a), thr, or the float above: the edge of -hd >= thr,
    which a hit needs (num <= -hd). d[:7] places -hd near T_MIN a at a ~ 10^4, d[7] moves hd by about
    a quarter ulp a step; o = cm_j makes c = c2_j - |cm_j|^2 < 0, so disc >
    0. None is a hit (num < -hd when disc > 0)."""
    a_t = 1e4
    hd_t = float(T_MIN) * a_t
    found = [[] for _ in range(3)]
    for j in range(cm.shape[1]):
        col = cm[:, j].astype(np.float64)
        if col @ col <= c2[j] or abs(col[-1]) < 0.25:
            continue
        head = col[:-1]
        alpha = -hd_t / np.linalg.norm(head)
        d = np.zeros(MXU_K, np.float32)
        d[:-1] = (alpha * head / np.linalg.norm(head)
                  + np.sqrt(a_t - alpha ** 2) * _across(head, g))
        o = cm[:, j].copy()
        hd, a = _mxu_pairs(cm, c2, o[None], d[None])[:2]
        acc, thr = hd[0, j], mxu_threshold_np(a[0, 0])
        step = np.spacing(np.float32(hd_t)) / 4 / abs(col[-1])
        for i, target in enumerate((np.nextafter(thr, np.float32(0)), thr,
                                    np.nextafter(thr, np.float32(np.inf)))):
            f0 = (-float(target) - float(acc)) / col[-1]
            D = np.broadcast_to(d, (65, MXU_K)).copy()
            D[:, -1] = f0 + np.arange(-32, 33) * step
            hd, a_row, disc, _ = _mxu_pairs(cm, c2, np.broadcast_to(
                o, D.shape), D)
            thr_row = mxu_threshold_np(a_row[:, 0])
            want = (np.nextafter(thr_row, np.float32(0)), thr_row,
                    np.nextafter(thr_row, np.float32(np.inf)))[i]
            ok = (disc[:, j] > 0) & (-hd[:, j] == want)
            rows = np.flatnonzero(ok)
            if len(rows) and len(found[i]) < EDGE_CASE_RAYS:
                found[i].append((o, D[rows[0]]))
        if min(map(len, found)) == EDGE_CASE_RAYS:
            return found
    raise RuntimeError("no rays found for the edge of -hd >= thr")


def _edge_disc_rays(cm, c2):
    """Rays whose disc on a sphere j is +0.0 with hd != 0, and rays whose
    closest hit has a positive subnormal disc, EDGE_CASE_RAYS each. d = s e_k
    with s = -sign(cm_kj) (a = 1, hd = -|cm_kj|: disc = +0 where c is hd *
    hd) or s 2^-62 (a = 2^-124: c one or three ulps under cm_kj^2 gives a
    disc of that many subnormal steps, and every sphere whose c is within
    1/4 of its cm_kj^2 has a subnormal disc); o = f e_m (m the largest
    |cm_mj|) sets c to the float, f stepping a quarter ulp of c."""
    zero, sub = [], []
    tiny = np.finfo(np.float32).tiny
    for j in range(cm.shape[1]):
        col = cm[:, j].astype(np.float64)
        m = int(np.argmax(np.abs(col)))
        for k in range(MXU_K):
            sq = cm[k, j] * cm[k, j]
            if not 0.3 <= sq <= 1.9 or col[m] ** 2 < c2[j] - 0.3:
                continue
            for n, scale in ((0, 1.0), (1, 2.0 ** -62), (3, 2.0 ** -62)):
                if (len(sub) if n else len(zero)) == EDGE_CASE_RAYS:
                    continue
                target = sq
                for _ in range(n):
                    target = np.nextafter(target, np.float32(0))
                d = np.zeros(MXU_K, np.float32)
                d[k] = -np.sign(col[k]) * scale
                f0 = col[m] - np.sign(col[m]) * np.sqrt(
                    col[m] ** 2 - c2[j] + float(target))
                o = np.zeros((129, MXU_K), np.float32)
                o[:, m] = f0 + np.arange(-64, 65) * 2.0 ** -26 / abs(
                    f0 - col[m])
                hd, a, disc, t = _mxu_pairs(cm, c2, o,
                                               np.broadcast_to(d, o.shape))
                if n == 0:
                    rows = np.flatnonzero(disc[:, j] == 0)
                    if len(rows):
                        zero.append((o[rows[0]], d))
                    continue
                hit = (disc > 0) & (t > T_MIN)
                near = np.where(hit, t, np.float32(np.inf)).argmin(1)
                dn = disc[np.arange(len(o)), near]
                rows = np.flatnonzero(hit.any(1) & (dn > 0) & (dn < tiny)
                                      & (disc[:, j] > 0) & (disc[:, j] < tiny))
                if len(rows):
                    sub.append((o[rows[0]], d))
            if len(zero) == len(sub) == EDGE_CASE_RAYS:
                return [zero, sub]
    raise RuntimeError("no rays found for a +0 or subnormal disc")


@functools.lru_cache(maxsize=2)
def _mxu_edge_np(seed):
    cm, r2, o, d = (x.numpy() for x in mxu_inputs(seed, device="cpu"))
    g = np.random.default_rng(seed)
    zero_d = [(x, np.zeros(MXU_K, np.float32)) for x in o[-EDGE_CASE_RAYS:]]
    cases = (_edge_t_rays(cm, r2[0], g) + _edge_hd_rays(cm, r2[0], g)
             + _edge_disc_rays(cm, r2[0]) + [zero_d])
    rays = [r for case in cases for r in case]
    eo = np.stack([r[0] for r in rays] + list(o[:MXU_EDGE_RAYS - len(rays)]))
    ed = np.stack([r[1] for r in rays] + list(d[:MXU_EDGE_RAYS - len(rays)]))
    return cm, r2, eo.astype(np.float32), ed.astype(np.float32)


def mxu_edge_inputs(seed: int = 0, device="cpu"):
    """P7's edge tile: the sweep's cm, r2 (``mxu_inputs(seed)``) and
    MXU_EDGE_RAYS rays o, d (R, 8), built, not drawn, EDGE_CASE_RAYS of each
    of MXU_EDGE_CASES in that order: t on the float below T_MIN, on T_MIN and
    above it; -hd on the float below the threshold thr(a), on it and above
    it; disc +0.0 with hd != 0; disc positive and subnormal; a zero
    direction (a = +0: thr is the least subnormal, t = num / 0); then the
    sweep's own rays to fill the tile."""
    return tuple(torch.from_numpy(x).to(device) for x in _mxu_edge_np(seed))


def time_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn`` by CUDA events after a warm-up: over
    ``reps`` calls, or as many more (up to 200) as take ~10 ms, so that a
    kernel of microseconds is not timed by one launch's jitter. A Python
    call takes tens of microseconds on the host, longer than a short
    kernel, so the stream is held by a sleep kernel (``torch.cuda._sleep``)
    for about twice the host time of the calls while the host enqueues
    them: the events then time the device's work back to back, not the
    host's gaps. If the device had reached the start event before the host
    had enqueued every call, the hold was too short: the calls are timed
    again under a hold four times longer, HOLD_TRIES times at most."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    fn()
    end.record()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    n = max(reps, min(200, int(10.0 / max(start.elapsed_time(end), 0.05))))
    hold_s = 2 * n * host_s + 1e-3
    for _ in range(HOLD_TRIES):
        torch.cuda._sleep(int(hold_s * SM_CLOCK_HZ))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        held = not start.query()
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / n
        hold_s *= 4
    raise RuntimeError(f"time_ms: the host did not enqueue {n} calls within "
                       f"a {hold_s / 4:.3f} s hold of the stream")


def variants():
    """Every (probe, function, variant, size) of the sweep that fits, and
    the (space, size) pairs that do not fit, from ``fits``."""
    run, skip = [], []
    for n in SMEM_SIZES:
        for space in SPACES:
            (run if fits(space, n) else skip).append(
                ("P1", "smem_scalar", space, n))
    for space in ("shared", "global"):
        (run if fits(space, ROW_N * LANES) else skip).append(
            ("P2", "vmem_row_broadcast", space, ROW_N))
    for space in ("shared", "global"):
        for stride in GATHER_STRIDES:
            run.append(("P3", "vmem_gather", f"{space}/stride{stride}",
                        GATHER_N))
    for space in ("shared", "global"):
        run.append(("P4", "vmem_gather_2d", space, GATHER_N))
    for space in SPACES:
        (run if fits(space, 4 * SPHERES) else skip).append(
            ("P5", "sphere_loop_smem", space, SPHERES))
    for S in IMMEDIATE_SPHERES:
        run.append(("P6", "sphere_loop_immediate", "immediate", S))
    for variant in ("f32", "tf32"):
        run.append(("P7", "sphere_mxu", variant, SPHERES))
    return run, skip


def _stride(variant: str) -> int:
    return int(variant.split("/stride")[1])


def case(probe, variant, size, seed, tiles, dev, gathers=1):
    """(kernel call, plain call) of one sweep case at ``tiles`` tiles.
    P3/P4 add their gathers at ``gathers`` index offsets (1 is the
    reference's function); the other probes ignore it."""
    if probe == "P1":
        tab = torch.arange(size, dtype=torch.float32, device=dev)
        return (lambda: smem_scalar_kernel(tab, variant, tiles),
                lambda: smem_scalar_plain(tab, tiles))
    if probe == "P2":
        tab = torch.arange(size, dtype=torch.float32,
                           device=dev)[:, None].repeat(1, LANES)
        return (lambda: vmem_row_broadcast_kernel(tab, variant, tiles),
                lambda: vmem_row_broadcast_plain(tab, tiles))
    if probe == "P3":
        space, stride = variant.split("/")[0], _stride(variant)
        tab = gather_table(dev)
        return (lambda: vmem_gather_kernel(tab, space, stride, gathers,
                                           tiles),
                lambda: vmem_gather_plain(tab, stride, gathers, tiles))
    if probe == "P4":
        tab = gather_2d_table(dev)
        return (lambda: vmem_gather_2d_kernel(tab, variant, gathers, tiles),
                lambda: vmem_gather_2d_plain(tab, gathers, tiles))
    if probe in ("P5", "P6"):
        o, d = rays(seed, tiles, dev)
        sph = sphere_table(size, dev)
        if probe == "P5":
            kern = lambda: sphere_loop_kernel(sph, o, d, REPS, variant)
        else:
            kern = lambda: sphere_immediate_kernel(size, o, d, REPS)
        return kern, lambda: sphere_loop_plain(sph, o, d, REPS)
    cm, r2, o, d = mxu_inputs(seed, size, tiles, dev)
    return (lambda: sphere_mxu_kernel(cm, r2, o, d, REPS, variant == "tf32"),
            lambda: sphere_mxu_plain(cm, r2, o, d, REPS))


def timed_gathers(probe) -> int:
    """Gathers a thread in the timed call: GATHER_TIMING_REPS for P3/P4
    (to time the gather, not the launch), else 1."""
    return GATHER_TIMING_REPS if probe in ("P3", "P4") else 1


def touched_entries(probe, gathers=1) -> int:
    """Distinct table entries that P3's or P4's function reads over one
    tile at ``gathers`` index offsets: P3 rows of column 0, P4 (row, lane)
    pairs."""
    idx = gather_index().numpy()
    rows = np.stack([(idx + k) % GATHER_N for k in range(gathers)])
    if probe == "P3":
        return len(np.unique(rows))
    return len(np.unique(rows * LANES + np.arange(LANES)))


def work(probe, variant, size, tiles, gathers=1):
    """(count, unit, f32 flop, tensor-core flop, bytes) of one call at
    ``tiles`` tiles. The count is what the kernel does, the rate's
    numerator: reads (P1-P4; P1/P2 one fold a tile, a warp reading the n
    entries or rows at one address each step) or sphere tests (P5-P7).
    The operations and bytes are what the function needs, the bound's:
    P1/P2 one n-term sum a tile, over the table entries it sums (P2:
    column 0); P3/P4 the adds of ``gathers`` gathers and the
    entries the index touches (``touched_entries``); the sphere probes
    their tests' operations, counted from the kernels. Each input byte is
    read once and each output byte written once. P3/P4's shared variants
    are also bound by their wavefronts (``gather_wavefronts``,
    ``gather_bound``)."""
    threads = tiles * TILE
    out_bytes = 4 * threads
    if probe in ("P1", "P2"):
        return (tiles * size, "G reads/s", tiles * size, 0,
                4 * size + out_bytes)
    if probe in ("P3", "P4"):
        return (threads * gathers, "G reads/s", threads * (gathers - 1), 0,
                4 * touched_entries(probe, gathers) + out_bytes)
    if probe in ("P5", "P6"):
        tests = threads * size * REPS
        return (tests, "G prim-tests/s", tests * FLOP_PER_SPHERE_TEST, 0,
                4 * 4 * size + 7 * out_bytes)
    R = tiles * MXU_RAYS
    tests = R * size * REPS
    epi = (tests * FLOP_PER_MXU_EPILOGUE + R * REPS * FLOP_PER_MXU_RAY_ROUND
           + R * FLOP_PER_MXU_RAY)
    n_bytes = 4 * (2 * MXU_K * size + 2 * MXU_K * R + R)
    if variant == "tf32":
        return (tests, "G prim-tests/s", epi,
                tests * TC_FLOP_PER_MXU_PRODUCTS, n_bytes)
    return (tests, "G prim-tests/s", epi + tests * FLOP_PER_MXU_PRODUCTS, 0,
            n_bytes)


def gather_wavefronts(probe, variant, tiles, gathers=1) -> int:
    """Shared-memory wavefronts of one P3/P4 call at ``tiles`` tiles: a
    warp-gather of a shared variant takes ``bank_conflict_ways`` of its
    stride (P4: lane l reads bank l % 32, conflict-free), the same for every
    warp and offset (an offset or a row shifts the lanes' indices
    together); the ``__ldg`` variants read no shared memory."""
    if probe not in GATHER_PROBES or not variant.startswith("shared"):
        return 0
    ways = bank_conflict_ways(_stride(variant)) if probe == "P3" else 1
    return tiles * (TILE // 32) * gathers * ways


def bound_ms(flop, n_bytes, tc_flop=0.0, chain_ms=0.0, issue_ms=0.0,
             smem_ms=0.0):
    """(ms, 'operations', 'bytes', 'chain', 'issue' or 'smem'): the largest
    of the f32 operations over the f32 peak (or the tensor-core operations
    over the TF32 peak, where larger), the bytes over the memory rate,
    ``chain_ms``, the floor of a chain of dependent adds
    (``chain_floor_ms``; P1/P2), ``issue_ms``, the floor of issuing the f32
    operations one a lane slot (``issue_floor_ms``; P3-P7), and
    ``smem_ms``, the floor of the shared-memory wavefronts
    (``smem_floor_ms``; P3/P4's shared variants)."""
    t_ops = max(flop / PEAK_FP32_FLOPS, tc_flop / PEAK_TF32_FLOPS) * 1e3
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    return max((t_bytes, "bytes"), (t_ops, "operations"), (chain_ms, "chain"),
               (issue_ms, "issue"), (smem_ms, "smem"), key=lambda b: b[0])


def gather_bound(probe, variant, tiles, gathers=1, sms=SM_COUNT):
    """``bound_ms`` of one P3/P4 call: bytes, operations, the adds' issue
    (``gathers`` - 1 a thread) and, for a shared variant, its
    wavefronts."""
    _, _, flop, tc_flop, n_bytes = work(probe, variant, GATHER_N, tiles,
                                        gathers)
    return bound_ms(flop, n_bytes, tc_flop,
                    issue_ms=issue_floor_ms(flop, sms),
                    smem_ms=smem_floor_ms(gather_wavefronts(
                        probe, variant, tiles, gathers), sms))


def uneven_check(probe, variant, size, seed, dev, plain_tile) -> dict:
    """The persistent kernels (P1-P4) at UNEVEN_TILES tiles, every tile bit
    for bit the plain version of one tile: grids whose warps do not divide
    the work, warps that take several tiles. P1/P2 with the table of
    ``size`` and of ``size - RAGGED`` entries (rows: folds with a ragged
    tail), P3/P4 at one gather and at ``timed_gathers``."""
    if probe in FOLD_PROBES:
        cases = [(size, 1), (size - RAGGED, 1)]
    else:
        cases = [(size, 1), (size, timed_gathers(probe))]
    ok = True
    for n, gathers in cases:
        want = plain_tile(probe, variant, n, gathers)
        for tiles in UNEVEN_TILES:
            got = case(probe, variant, n, seed, tiles, dev, gathers)[0]()
            ok = ok and bool(torch.equal(got, want.expand_as(got)))
    row = dict(uneven_tiles=list(UNEVEN_TILES), uneven_equal=ok)
    if probe in FOLD_PROBES:
        row["ragged_size"] = size - RAGGED
    return row


def edge_check(probe, variant, size, dev) -> dict:
    """The sphere probes' kernels on their edge tiles against the plain
    version there. P5/P6 on ``edge_rays`` (zero and subnormal directions,
    origins at centres, grazes with disc +0.0 or subnormal), bit for bit.
    P7 on ``mxu_edge_inputs`` (t on 1e-3f and the floats beside it, -hd on
    the threshold and beside it, disc +0.0 or subnormal, zero directions,
    80 rays): the f32 variant bit for bit, the TF32 variant by
    ``tf32_gate`` (its numbers as ``edge_gate_*``)."""
    if probe == "P7":
        cm, r2, o, d = mxu_edge_inputs(device=dev)
        want = sphere_mxu_plain(cm, r2, o, d, REPS)
        if variant == "f32":
            got = sphere_mxu_kernel(cm, r2, o, d, REPS)
            return dict(edge_equal=bool(torch.equal(got, want)))
        t_tc, prods = sphere_mxu_kernel(cm, r2, o, d, REPS, True, True)
        gate = tf32_gate(cm, r2, o, d, t_tc, prods, REPS, want)
        return dict(edge_equal=gate.pop("ok"),
                    **{f"edge_gate_{k}": v for k, v in gate.items()})
    o, d = edge_rays(device=dev)
    sph = sphere_table(size, dev)
    want = sphere_loop_plain(sph, o, d, REPS)
    if probe == "P5":
        got = sphere_loop_kernel(sph, o, d, REPS, variant)
    else:
        got = sphere_immediate_kernel(size, o, d, REPS)
    return dict(edge_equal=bool(torch.equal(got, want)))


def sweep(seed: int = 0, emit=None):
    """Run every probe variant on the card. First at the reference shape
    (one tile, or 1024 rays; P3/P4 one gather a thread) against its plain
    version: bit for bit, the TF32 variant by ``tf32_gate``. Then the timed
    call at FILL_TILES tiles (P3/P4 ``timed_gathers`` gathers a thread),
    every tile bit for bit the plain version of one tile at the same
    gathers (the TF32 variant: its own one-tile output), and timed by CUDA
    events; P1-P4 also at uneven tile counts (P1/P2 and a ragged size;
    ``uneven_check``), P5-P7 on their edge tiles (``edge_check``).
    ``equal`` holds every check; P3-P7's bounds count the card's own SMs
    (P3/P4's shared variants also their wavefronts, ``smem_floor_ms``).
    Returns one dict per (probe, variant, size) and one per pair that does
    not fit its memory space (from ``fits``); ``emit`` (e.g. ``print``) gets
    each as a JSON line."""
    dev = resolve_device(None)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    run, skip = variants()
    rows = []

    def out(row):
        rows.append(row)
        if emit is not None:
            emit(json.dumps(row))

    for probe, fn, space, n in skip:
        out(dict(probe=probe, function=fn, variant=space, size=n, fits=False,
                 limit_floats=(CONSTANT_FLOATS if space == "constant"
                               else SHARED_FLOATS)))
    plains = {}

    def plain_tile(probe, variant, size, gathers):
        """The plain version of one tile, shared by the variants that
        compute the same function."""
        key = ("P5" if probe == "P6" else probe, size,
               _stride(variant) if probe == "P3" else None,
               gathers if probe in ("P3", "P4") else 1)
        if key not in plains:
            plains[key] = case(probe, variant, size, seed, 1, dev,
                               gathers)[1]()
        return plains[key]

    for probe, fn, variant, size in run:
        row = dict(probe=probe, function=fn, variant=variant, size=size,
                   fits=True)
        want = plain_tile(probe, variant, size, 1)
        kern = case(probe, variant, size, seed, 1, dev)[0]
        got = kern()
        if probe == "P7" and variant == "tf32":
            cm, r2, o, d = mxu_inputs(seed, size, 1, dev)
            t_tc, prods = sphere_mxu_kernel(cm, r2, o, d, REPS, True, True)
            gate = tf32_gate(cm, r2, o, d, t_tc, prods, REPS, want)
            ref_ok = gate.pop("ok") and bool(torch.equal(got, t_tc))
            row.update({f"gate_{k}": v for k, v in gate.items()})
            want, err = got, 0.0
        else:
            ref_ok = bool(torch.equal(got, want))
            err = float((got - want).abs().max())
        if probe == "P3":
            row["bank_conflict_ways"] = bank_conflict_ways(_stride(variant))
        gathers = timed_gathers(probe)
        if gathers > 1:
            want = plain_tile(probe, variant, size, gathers)
        kern = case(probe, variant, size, seed, FILL_TILES, dev, gathers)[0]
        got = kern().reshape((FILL_TILES,) + tuple(want.shape))
        tiles_ok = bool(torch.equal(got, want.expand_as(got)))
        err = max(err, float((got - want).abs().max()))
        del got
        chain_ms = chain_floor_ms(size) if probe in FOLD_PROBES else 0.0
        if probe in UNEVEN_PROBES:
            row.update(uneven_check(probe, variant, size, seed, dev,
                                    plain_tile))
            tiles_ok = tiles_ok and row["uneven_equal"]
        if probe in ISSUE_PROBES:
            row.update(edge_check(probe, variant, size, dev))
            tiles_ok = tiles_ok and row["edge_equal"]
        ms = time_ms(kern, 3)
        count, unit, flop, tc_flop, n_bytes = work(probe, variant, size,
                                                    FILL_TILES, gathers)
        issue = probe in ISSUE_PROBES + GATHER_PROBES
        issue_ms = issue_floor_ms(flop, sms) if issue else 0.0
        smem_ms = smem_floor_ms(gather_wavefronts(probe, variant, FILL_TILES,
                                                  gathers), sms)
        b_ms, b_by = bound_ms(flop, n_bytes, tc_flop, chain_ms, issue_ms,
                              smem_ms)
        row.update(equal=ref_ok and tiles_ok, reference_equal=ref_ok,
                   tiles_equal=tiles_ok, max_abs_err=err, tiles=FILL_TILES,
                   ms=ms, rate=count / ms / 1e6, rate_unit=unit,
                   bound_ms=b_ms, bound_by=b_by)
        if probe in FOLD_PROBES:
            row["chain_floor_ms"] = chain_ms
        if issue:
            row.update(issue_floor_ms=issue_ms, sms=sms)
        if smem_ms:
            row["smem_floor_ms"] = smem_ms
        if gathers > 1:
            row["gathers_a_thread"] = gathers
        out(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m rust_tracing_tpu_torch.probes",
        description="Run the H100 probes (scripts/tpu_probe.py's P1-P7) on "
                    "the card: one JSON line per (probe, variant, size).")
    ap.add_argument("--seed", type=int, default=0,
                    help="numpy seed of the rays and P7's inputs")
    args = ap.parse_args(argv)
    resolve_device(None)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "count": torch.cuda.device_count()}), flush=True)
    rows = sweep(args.seed, emit=lambda s: print(s, flush=True))
    bad = [r for r in rows if r["fits"] and not r["equal"]]
    for r in bad:
        print(f"probes: {r['probe']} {r['variant']} size {r['size']} "
              f"differs from its plain version", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
