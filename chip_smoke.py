#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
device and the CUDA toolkit (``nvcc``), builds the hand-written kernels from
``rust_tracing_tpu_torch/csrc/`` and drives the port's main paths through the
entry points a user would call. Every phase prints one JSON line; any failure
exits non-zero. Without a CUDA device it exits non-zero and prints no result.

Phases:
  device     card name and power limit (nvidia-smi), torch and CUDA versions
  build      seconds to compile the kernel library at first use
  exact      closed-form cases through the render kernel
  kernels    every CUDA kernel against its plain PyTorch version ON THE CARD,
             same inputs: the render kernel (B1; a group of threads a pixel,
             its resources and waves on each line) and the path recorder (B2;
             a thread a (pixel, sample)) on four scenes at a small frame (B1
             also at 1, 2, 23 and 32 spp, one sample a thread up to a warp a
             pixel, and over a pixel range that starts mid-row) and on
             cornell_box at 600x600 at 32 spp (the main path's warp a pixel;
             B1 with its tables staged and through __ldg); B2 also at the
             gradient's 23-spp slice (timed, with its resources and waves),
             over a range that starts and ends mid-row, at 1 spp, and on
             simple_light's own 600x337 frame;
             the render kernel's noise and image families (B8) and the
             recorder on two_perlin_spheres, simple_light and earth, B8 at
             32 spp (a warp a pixel) and on simple_light's own 600x337
             frame; the gathers (B5, B6) and their transpose (the
             reduction, bit for bit its order in tensor code) on tables of 4
             to 3407 rows and 3.96 M indices, at 3.96 M - 37 indices with
             out-of-range ones, in f64, and on the cornell gradient's first
             replay bounce (its tex_rgb reduction and its quads' index, each
             beside a random index of the same shape), the match kernel
             (mid-size tables) against its plain version, and
             its sorted form (the radix sort and the segment sum, f32 and
             f64, time by kernel, beside the match kernel) on 1024 to
             524 288 rows; the three forms timed around their crossovers
             (scatter_routes: which scatter_sum_cols picks); the Perlin
             turbulence kernel (B7) at 2^22 lanes (its shared-memory
             wavefront floor, and two_perlin_spheres' first replay bounce)
             and its backward kernel (perlin_backward_kernel: positions and
             d_ranvec's fixed-point sum bit for bit, also on 2^22 - 37
             lanes, f64 and two_perlin_spheres' first backward call; two
             launches and a lane-permuted launch equal; d_ranvec within
             its quantization bound and near the plain version's own
             error; timed by kernel, and positions only)
  main_path  render() of cornell_box at 600x600, 4096 spp, depth 8
  cli        the command-line entry point writes a PNG
  deferred_path
             render() (auto policy: deferred shading, B2 + replay with B7)
             of simple_light at 600x337, 1024 spp, depth 8, then of
             two_perlin_spheres and earth at 1200x675, 128 spp, depth 8;
             on a small frame of each, deferred == the tensor integrator bit
             for bit; each full frame's gamma mean against the fused render
  fused_textures
             render(use_megakernel=True) of simple_light at its own settings
             through B8
  grad_textures
             loss_and_grad() of two_perlin_spheres and earth at 400x225,
             32 spp, depth 8 w.r.t. every float leaf (two_perlin_spheres
             through perlin_backward_kernel, its device time by the
             profiler in one more run)
  grad_path  loss_and_grad() of cornell_box at 600x600, 200 spp, depth 8
             w.r.t. every float scene leaf (the record/replay gradient), then
             the L2 loss of the same workload
  profile    device time by kernel of one grad_path run (torch.profiler)
  census     that run's reduction calls by (route, columns, rows, indices,
             dtype): calls and device ms; fails if none took the tile kernel
  train      fit_scene() on cornell_box 600x600 @ 16 spp: the loss falls
  grad_check the CLI's --grad-check on the card
  grad_final (below) also runs its gradient with the reductions routed by
             lanegather.use_segment_sum and by rows alone (the segment sum
             past 2048 rows), ROUTE_PAIRS pairs in alternating order:
             seconds and their medians, the reductions' device ms and each
             form's launches
  BVH slice (final_scene):
  kernels    the render kernel and the recorder with the BVH walk (B4) against
             their plain versions (which test every primitive) on
             final_scene at 64 px, 200x200 (depth 40) and 32 px at the fused
             render's 32 spp (a warp a pixel), and on random_balls and
             cornell_box with a forced tree; the recorder's walk counters on
             final_scene and cornell_box (a pixel range) at 16 px; the hit kernel (B3) against its plain
             version on final_scene's 800x800 camera rays (bounce 0) and on
             the sorted lanes of a wavefront chunk (bounce 1), and on
             cornell_box's 600x600 camera rays without a tree; on
             COUNTER_LANES lanes of each final_scene state, B3's per-lane
             walk counters against the plain walk's
             (megakernel.walk_wide_plain); B3's time on a whole chunk (4 spp
             x 800x800 lanes) at bounce 0 and at bounce 8, sorted, sorted
             and cut to its live prefix, and unsorted, with its bound from
             its own walk counters
  crossover  the render kernel brute force against the BVH walk at 4 spp:
             random_balls 600x337 and final_scene 200x200 (depth 40)
  wavefront_path
             on final_scene 64 px: render() (auto: the sorted wavefront),
             render_sorted(sort=False), render_sorted with compaction at
             every segment, the tensor integrator and render_deferred, all
             equal bit for bit; then render() of final_scene at 800x800,
             depth 40, 32 spp, and the fused render (B1+B4+B8) of the same
             frame with its bound from its walk counters; that frame equals
             the brute loop's render of it bit for bit (pixels and ray
             counts)
  profile    device time by kernel of one chunk of that frame (the
             wavefront) and the device's busy share
  grad_final loss_and_grad() of final_scene at 200x200, 4 spp, depth 8
  cli_final  the CLI renders final_scene (-s 8) at 200x200, 8 spp
  Multi-GPU slice (ranks are processes started by parallel.launch.run_ranks
  after the kernels are built here; a rank that fails or outlasts
  DIST_TIMEOUT_S fails the run):
  distributed
             (a) NCCL, world size 1 (a 1x1 mesh): render_distributed of
             cornell_box 600x600 at the main path's spp, depth 8, against
             render_fast, and the sharded route's render kernel against its
             plain version at DIST_B1_SPP; (b) two ranks under gloo sharing the
             one card (mesh 2x1), the frame at DIST_CUT_SPP against
             render_fast, and each rank's kernel against its plain version
             over its pixel range at 64 px; (d) on those two ranks,
             replay_loss_and_grad of cornell_box 600x600 @ 200 spp depth 8
             (an SSE) against one rank's loss_and_grad; (c) four ranks under
             gloo sharing the card (mesh 2x2), the frame against
             render_fast; (e) the CLI with --distributed under torchrun
             (one process, NCCL) against the CLI alone (which also reports
             the occupancy and writes a profiler trace). Ranks sharing one
             card check correctness: they are no faster than one rank, and
             no scaling is measured here.
  live       the CLI's --live --checkpoint at 200 px, 1024 spp, killed once
             its checkpoint holds 32 samples, resumed in this process, and
             an uninterrupted live render
  Probe slice (scripts/tpu_probe.py's P1-P7 as H100 probes):
  probes     the probes' entry point (probes.sweep, what `python -m
             rust_tracing_tpu_torch.probes` runs): every variant (memory
             space, lane stride, compiled sphere count, f32 or TF32 products)
             at the reference shape against its plain version, then at
             1024 tiles (P3/P4 64 gathers a thread) tile by tile against the
             plain version of one tile, P1-P4 also at 133 and 9001 tiles
             (odd, so no grid's warps divide them; 9001 past the warps the
             card holds; P1/P2 also at a ragged size, P3/P4 at 1 and 64
             gathers), P5/P6 also on an edge tile
             (probes.edge_rays: zero and subnormal directions, origins at
             sphere centres, grazes with disc +0.0 or subnormal), P7 on its
             own (probes.mxu_edge_inputs: t on 1e-3f and the floats beside
             it, -hd on the hit threshold and beside it, disc +0.0 or
             subnormal, zero directions, 80 rays), and timed on a held
             stream (probes.time_ms: device time, not the host's dispatch);
             each kernels-line entry is its variant's sweep row, with the
             plain version's and the library call's times (P1/P2: the chain
             floor, P3-P7: the lane-issue floor on this card's SMs, P3/P4's
             shared variants: the smem wavefront floor, and bound_by beside
             them)
  torch_func torch.func.jacfwd and jacrev of the replay image's row mean
             w.r.t. tex_rgb (24 px noise scene, float64) on the card,
             through the batching rules of the gathers (gather_cols_kernel
             for jacfwd's batched tables, scatter_sum_kernel for jacrev's
             batched cotangents), against each other and the CPU's
  Tools slice (the counterparts of bench.py, __graft_entry__.py,
  scripts/run_workloads.py and scripts/final_scene_full.py):
  bench      bench.run() at the reference's sizes (cornell_box 600x600 @ 200
             spp depth 8): the line the CLI prints, with the reference's
             keys; its two timed gradients count grad_path's exact rays for
             the same seeds and launch record_kernel 9 times each; the fused
             render within 1 % of the tensor integrator at 200 px @
             BENCH_PARITY_SPP spp (the CLI's 512 spp: ~46 s more)
  entry      entry()'s fn on the card (1024 pixels, finite, through
             gather_kernel); dryrun_multichip(2), both ranks on the card
  workloads  run_workloads.run(): the nine reference workloads at their own
             frames, spp x WORKLOAD_SCALE (final_scene WORKLOAD_SCENE8_SPP);
             each row names its path, which launched its kernel; cornell's
             gamma mean in 0.24-0.27
  final_scene_full
             final_scene_full.run() at 800x800 depth 40, two slices of
             FSF_SLICE_SPP: stopped after one and resumed, bit for bit an
             uninterrupted run (image and PNG)

Bounds (the kernels line's bound_ms): the larger of the bytes a call must
move over 3.35 TB/s and its counted float32 operations at one a lane slot
(the card's SMs x 128 lanes x 1980 MHz, ops_ms), since the kernels are
built with --fmad=false; the probes' own bounds are probes.py's.

Tolerances and their reasons.
- Render kernel: built without fused multiply-add contraction and without
  fast math, it does the plain version's f32 operations in the plain
  version's order, and adds each pixel's samples in sample order whatever
  thread traced them: every pixel and every ray count must be equal to the
  plain version's, bit for bit. Scenes with the noise and image families
  (B8) also call `sinf cosf logf expf` (the same device library PyTorch's
  CUDA ops call) on more values; for them a pixel counts as equal when
  |kernel - plain| <= 1e-5 + 1e-5 * |plain|, and what is bounded is the
  SHARE of other pixels (<= 0.5 %), of pixels whose ray count differs
  (<= 0.5 %) and the ratio of the mean images (within 1e-3 of 1). Seen on
  an H100: 0; a build with contraction left on shows 1.2 % on random_balls.
- Recorder: records are integers, and every record must be equal. With
  the BVH walk, its per-pixel walk counters (summed over the samples with
  integer atomics) must equal the plain walk's over the same paths.
- Gathers: a gather copies bits; equal to the plain version and to
  torch.index_select bit for bit.
- Reduction (both forms): with integer-valued cotangents every partial sum
  is exact, so the kernel must equal the plain version bit for bit; with
  normal-valued cotangents the two add the same terms in different orders,
  so each row may differ by at most 1e-6 of the sum of |cotangent| over the
  row (f32 rounding of a blocked sum stays far below). Two calls must give
  the same bits, and the tile kernel must equal its order in tensor code
  (lanegather.scatter_sum_ordered_plain: each lane's stream in element
  order, the lanes by a fixed butterfly, the warps and blocks in order) bit
  for bit. The radix sort is stable: equal to torch.sort(stable=True) and a
  gather of the columns, bit for bit. The segment sum may launch nothing
  but its own kernels and torch.zeros' fill.
- grad_path: the loss (the image mean, linear_loss) must equal the mean of
  the render kernel's image at the same seed, spp and depth to rtol 1e-5:
  the same estimator, summed in another association (per-slice float means
  weighted by k/spp, against one f32 sample sum per pixel).
- Turbulence kernel: no transcendental, no contraction; bit for bit.
  Its backward: the same, and d_ranvec is an integer sum of terms each
  rounded once at a scale both versions derive from R and max|g|
  (perlin_fused.fixed_scale), so it too is bit for bit, in any order of
  the lanes. Against the exact sum it is held within its quantization
  bound (_bwd_fixed_bound), no larger than the limit of a float fold over
  warp tables and block partials (_bwd_fold_limit) at these sizes, and
  within 4x the error of the terms' sum in lane order.
- Render kernel with noise/image (B8): the render kernel's tolerances; its
  `sinf` for the marble is the device library's, as torch.sin's on the card.
- deferred_path: deferred shading and the tensor integrator are one
  estimator (replay == direct), so on a frame both take in one sample slice
  and one pixel chunk the images are equal as f32, bit for bit. Against the
  fused render, whose noise is another random instance (hash lattice) and
  whose image is a mip, the gamma means' ratio lies within 0.08 of 1 for the
  noise scenes (the reference's bound on two noise instances,
  tests/test_megakernel.py) and within 0.01 for earth (its mip gate).
- grad_textures: the loss equals the deferred render's image mean at the
  same seed to rtol 1e-5 (the same estimator, another summation).
- BVH walk (B4) in the render kernel, the recorder and the hit kernel: its
  tie rule returns the brute loop's winner whatever order the tree visits
  primitives in, and the plain version tests every primitive. So every
  pixel must be equal bit for bit, every ray count and every record equal;
  what box pruning could still drop (a hit exactly on its node box's face)
  is counted in those numbers, not hidden by a tolerance. The walk's
  counters are integers: every lane's must equal the plain walk's, which
  does the kernel's slab and primitive arithmetic in f32 in its order.
- wavefront_path: the wavefront permutes and cuts lanes and shades with the
  replay: equal to the tensor integrator and to deferred shading bit for bit
  (as f32) with equal ray counts. Against the fused render (hash-lattice
  noise, mipped image) the gamma means' ratio must lie in 0.9-1.1.
- grad_final: the loss equals the deferred render's image mean to 1e-5.
- distributed: the RNG never sees the rank, and a rays-only mesh gives each
  pixel its whole sample range on one rank, where the all-reduce adds zeros:
  bit for bit equal to render_fast, ray counts equal. A split sample axis
  (2x2) adds two f32 means, as the reference's psum does: rtol 3e-6, atol
  3e-7 (tests/test_parallel.py). The distributed gradient partitions the
  samples into other slices than one rank does: loss rtol 2e-5, each float
  leaf rtol 5e-4 and atol 2e-5 of its largest |g| (tests/test_parallel.py),
  ray counts equal. The CLI's PNG under torchrun equals the CLI's alone.
- live: a resumed render repeats the same float64 updates on the same
  samples: its buffer and PNG equal the uninterrupted render's bit for bit.
- probes: P1-P6 and P7's f32 variant do the plain version's f32 operations
  in its order (sums in index order, IEEE sqrt and division, no
  contraction; the min over spheres is exact): bit for bit at the
  reference shape and in every tile of the timed shape (P5-P7 also on
  their edge tiles, subnormals kept on both sides; P7 divides once a ray,
  by a threshold that is exact: probes.mxu_threshold_np). P7's TF32
  variant, also on the edge tile:
  each product within probes.TF32_PROD_RTOL of its terms' absolute sum
  (operands rounded to TF32, 2^-11 each, plus the f32 sums), and every ray
  whose t moved by more than 1e-3 relative among the rays that this product
  bound, carried through the epilogue, allows to move (probes.tf32_gate).
- torch_func: the card's and the CPU's Jacobians replay the same records
  with the same float64 operations in other summation orders (the
  reductions' partial sums): rtol 1e-10, atol 1e-12, the tolerance of
  tests/test_grad.py::test_jacfwd_through_textured_scene; jacfwd against
  jacrev on the card to the same tolerance.
"""

import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device available; the port's main path runs "
          "on the GPU only", file=sys.stderr)
    sys.exit(1)

import rust_tracing_tpu_torch as rt  # noqa: E402
from rust_tracing_tpu_torch import bench  # noqa: E402
from rust_tracing_tpu_torch import cli  # noqa: E402
from rust_tracing_tpu_torch import entry  # noqa: E402
from rust_tracing_tpu_torch import final_scene_full  # noqa: E402
from rust_tracing_tpu_torch import grad as tg  # noqa: E402
from rust_tracing_tpu_torch import probes  # noqa: E402
from rust_tracing_tpu_torch import renderer  # noqa: E402
from rust_tracing_tpu_torch import run_workloads  # noqa: E402
from rust_tracing_tpu_torch.models import builders  # noqa: E402
from rust_tracing_tpu_torch.ops import lanegather as lg  # noqa: E402
from rust_tracing_tpu_torch.ops import megakernel as mk  # noqa: E402
from rust_tracing_tpu_torch.ops import perlin  # noqa: E402
from rust_tracing_tpu_torch.ops import perlin_fused as pf  # noqa: E402
from rust_tracing_tpu_torch.ops import wavefront as wf  # noqa: E402
from rust_tracing_tpu_torch.models.compile import grad_to_numpy  # noqa: E402
from rust_tracing_tpu_torch.parallel import grad_dist  # noqa: E402
from rust_tracing_tpu_torch.parallel import render_dist  # noqa: E402
from rust_tracing_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from rust_tracing_tpu_torch.parallel.mesh import (make_mesh,  # noqa: E402
                                                  shard_range)
from rust_tracing_tpu_torch.runtime import kernels  # noqa: E402
from rust_tracing_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from rust_tracing_tpu_torch.utils import metrics  # noqa: E402
from rust_tracing_tpu_torch.utils.image_io import write_png  # noqa: E402

DEVICE = "cuda"

# Device memory bandwidth of one H100 SXM (NVIDIA data sheet). Counted
# float32 operations are bounded by the lanes' issue, not by the data
# sheet's 67 TFLOP/s: that rate counts a fused multiply-add as two
# operations, and the kernels are built with --fmad=false, so each counted
# multiply and add is an instruction of its own and takes one lane slot
# (ops_ms: probes.issue_floor_ms on this card's SMs, 128 lanes an SM at
# 1980 MHz, as P5-P7's bounds).
PEAK_BYTES_PER_S = 3.35e12

# Operation count of the render, from this run's data: each traced ray tests
# every sphere and quad (~25 flop a test, the reference's own estimate) and is
# shaded once (normal flip, material, scatter sampling, origin offset: ~120
# flop); each sample generates one camera ray (~60 flop).
FLOP_PER_PRIM_TEST = 25
FLOP_PER_BOUNCE_SHADE = 120
FLOP_PER_CAMERA_RAY = 60
# Perlin turbulence, counted from csrc/perlin_kernel.cu: per octave 15
# operations (3 scalings, 3 floors, 3 fractions, 6 of the Hermite weights)
# and per corner 14 (3 weight products, 3 offsets, 5 of the dot product, 3
# of the accumulation); 7 octaves x 8 corners.
TURB_OPS = 7 * (15 + 8 * 14)
# Its backward, counted from perlin_backward_kernel: pass 1 is the forward's
# octave sum, then the sign and g * sign (2); pass 2 per octave 15 as above,
# 9 of the Hermite derivatives 6u(1-u), 1 of the octave's cotangent and 9
# of the position sums, and per corner 35 (3 offsets, 5 of the dot, 2 of
# the weight, 18 of the noise gradient, 4 of the ranvec terms, 3 of the
# table adds).
TURB_BWD_OPS = TURB_OPS + 2 + 7 * (15 + 9 + 1 + 9 + 8 * 35)
# B8's hash turbulence adds per corner three hashes of ~11 integer
# operations each (3 multiplies, 3 adds, the 5-step mixer) and 3 of the
# gradient's scale; its marble 6 more. The image arm's polynomial UV is ~45.
FLOP_PER_NOISE_SHADE = 7 * (15 + 8 * (14 + 3 * 11 + 3)) + 6
FLOP_PER_IMAGE_SHADE = 45
# The BVH walk's slab test, counted from csrc/render_kernel.cu
# (closest_surface<MODE, true>): 6 subtractions, 6 multiplies, 12 min/max and
# one compare a node box tested. A visited leaf's primitive tests count
# FLOP_PER_PRIM_TEST each, from the kernels' own counters.
OPS_PER_SLAB = 25
# lanes of final_scene whose per-lane walk counters must equal the plain
# walk's (megakernel.walk_wide_plain), camera rays and a sorted chunk
COUNTER_LANES = 4096

PIX_ATOL, PIX_RTOL = 1e-5, 1e-5
MAX_DIVERGED_SHARE = 0.005
MAX_MEAN_RATIO_ERR = 1e-3
SUM_TOL = 1e-6      # reduction: share of the row's sum of |cotangent|
LOSS_RTOL = 1e-5    # grad_path loss against the render kernel's image mean

MAIN_SPP_TIME_BUDGET_S = 120.0
GRAD_SPP, GRAD_DEPTH = 200, 8          # bench.py's headline workload
TABLE_ROWS = (4, 18, 24, 64, 488, 3407)  # 24: cornell's padded quad table
N_INDEX = 11 * 360000  # the main path's replay wavefront: 11 samples x 600^2
TRAIN_LR = 8.0
TURB_LANES = 1 << 22    # the replay wavefront's budget (grad.REPLAY_RAY_BUDGET)
TURB_RANGE = 300.0      # positions in [-300, 300]^3
TEXTURE_SCENES = ("two_perlin_spheres", "simple_light", "earth")
NOISE_MEAN_TOL, IMAGE_MEAN_TOL = 0.08, 0.01
GRAD_TEX_WIDTH, GRAD_TEX_SPP = 400, 32
SEG_ROWS = (1024, 2048, 3407, 8192, 16384, 65536, 524288)  # 524288: earth
# the three forms of the reduction around their crossovers: table rows
# (4: cornell's texture table; 24: its quad table; 2408: final_scene's),
# columns (17: a quad table's; 8: a material table's), and indices (one
# replay wavefront; final_scene 200x200 @ 4 spp's lanes, the grad_final
# phase's)
ROUTE_ROWS = (4, 24, 64, 128, 256, 488, 1024, 2048, 2408, 3407, 4096, 8192)
ROUTE_COLS = (1, 3, 8, 17)
ROUTE_INDICES = (N_INDEX, 200 * 200 * 4)
ROUTE_PAIRS = 6         # grad_final under each route, in alternating order
FINAL_SPP = 32          # final_scene's frame: its own 800x800, depth 40
# B1's row at the main path's frame: the spp cut for the plain version, at
# the same group width as the main path's 4096 spp (a warp a pixel)
B1_MAIN_SPP = 32
CROSS_SPP = 4
GAMMA_RATIO_TOL = 0.1   # wavefront vs the fused render's noise and mip
DEEP_BOUNCE = 8
# distributed phase: ranks are processes; a rank that fails or outlasts its
# time limit fails the phase
DIST_TIMEOUT_S = 300.0
DIST_CUT_SPP = 64       # 2x1 and 2x2 on one shared card: correctness runs
DIST_B1_SPP = 32        # the sharded B1 row: kernel against plain version
SPLIT_RTOL, SPLIT_ATOL = 3e-6, 3e-7   # the sample axis: sum of f32 means
DIST_LOSS_RTOL, DIST_GRAD_RTOL, DIST_GRAD_ATOL = 2e-5, 5e-4, 2e-5
# workloads phase: the nine reference workloads at their own frames, spp
# scaled by WORKLOAD_SCALE (cornell_box 1024, so its gamma gate applies) and
# final_scene at WORKLOAD_SCENE8_SPP; a row's path must have launched its
# kernel
WORKLOAD_SCALE, WORKLOAD_SCENE8_SPP = 0.25, 8
PATH_KERNEL = {"megakernel": "render_kernel", "deferred": "record_kernel",
               "wavefront_sorted": "hit_kernel"}
FSF_SLICE_SPP = 4       # final_scene_full phase: two slices of this many spp
# bench phase: the headline at the reference's sizes; the parity frame's spp
# cut from the CLI's 512 (there the tensor integrator takes ~46 s alone)
BENCH_PARITY_SPP = 64
# live phase: cornell at 200 px, killed once its checkpoint holds this many
# samples, then resumed
LIVE_WIDTH, LIVE_SPP, LIVE_KILL_AT, LIVE_CKPT_EVERY = 200, 1024, 32, 16
REPO = os.path.dirname(os.path.abspath(__file__))
# where to keep the main path's PNG for a look; unset = not kept
OUT_DIR = os.environ.get("RT_SMOKE_OUT")


def say(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, reps):
    """Mean milliseconds of ``fn`` over ``reps`` runs, by CUDA events, after
    one warm-up run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_events(prof):
    """(name, device microseconds) of every device kernel, copy and fill a
    torch.profiler run recorded."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


# The profiler's device clock drifts early against its host clock as a
# process ages (~5 ms after ~8 min; more after long profiles), and it drops
# device work stamped before its trace's start: a profile first waits this
# long, and one that lost a kernel is taken again after a wait ten times
# longer (profiled_events).
PROFILE_SETTLE_S = 0.05
PROFILE_TRIES = 3
PROFILES = {"taken": 0, "dropped": 0}


def profiled_events(fn, reps):
    """(name, device microseconds) of the device work of ``reps`` calls of
    ``fn`` after a warm-up, from torch.profiler. The calls launch the same
    work each time, so every name must come ``reps`` times a whole number:
    a profile where one does not lost some of it, and is taken again, up to
    PROFILE_TRIES times; then the run fails."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_SETTLE_S * 10 ** attempt)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = _kernel_events(prof)
        counts = {}
        for name, _ in events:
            counts[name] = counts.get(name, 0) + 1
        short = {n: c for n, c in counts.items() if c % reps}
        PROFILES["taken"] += 1
        if events and not short:
            return events
        PROFILES["dropped"] += 1
        say("profile_dropped", reps=reps, events=len(events),
            short={_kernel_name(n): c for n, c in short.items()})
    fail(f"the profiler lost device work in {PROFILE_TRIES} profiles running")


def device_ms(fn, reps):
    """Mean device time of one call of ``fn``, in ms: the summed duration
    of the device work it launches over ``reps`` calls (profiled_events).
    Unlike CUDA events around a loop of calls, this does not include the
    host's time between launches."""
    return sum(us for _, us in profiled_events(fn, reps)) / 1e3 / reps


def once_ms(fn):
    """Milliseconds of one run of ``fn`` on the host clock, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def reset_launches():
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0


def bytes_bound(n_bytes):
    return n_bytes / PEAK_BYTES_PER_S * 1e3, "bytes"


def ops_ms(n_ops):
    """Least milliseconds of ``n_ops`` float32 operations, one a lane slot
    on every SM of the card."""
    return probes.issue_floor_ms(
        n_ops, torch.cuda.get_device_properties(0).multi_processor_count)


def search_flop(n_rays, p, walk=None):
    """Operations of the closest-surface search of ``n_rays`` rays: every
    primitive tested (brute), or, with ``walk`` = the BVH walk's summed
    counters (node visits, sphere tests, quad tests) of this run, the slab
    tests and the primitive tests it made."""
    if walk is None:
        return n_rays * (p.n_spheres + p.n_quads) * FLOP_PER_PRIM_TEST
    return walk[0] * OPS_PER_SLAB + (walk[1] + walk[2]) * FLOP_PER_PRIM_TEST


def bound_ms(tables, p, n_rays, shade=True, shades=(0, 0), walk=None):
    """Least time the card could take for this trace: the larger of bytes
    moved (each table read once, each output written once) over the memory
    rate and operations over the lanes' issue rate (ops_ms). The render
    writes 16 bytes a pixel and shades every bounce; the recorder
    (shade=False) writes 4 bytes per (pixel, sample, bounce) and shades
    nothing and reads no image.
    ``shades`` = (bounces shaded by a noise texture, by an image texture)
    in this run's paths (``texture_shades``); ``walk`` as for
    ``search_flop``."""
    read = mk.PackedScene.TABLES + (("img_f",) if shade else ())
    n_bytes = sum(tables[k].numel() * tables[k].element_size() for k in read)
    if shade:
        n_bytes += p.pixel_count * 16
    else:
        n_bytes += p.pixel_count * p.spp * p.max_depth * 4
    flop = (search_flop(n_rays, p, walk)
            + n_rays * (FLOP_PER_BOUNCE_SHADE if shade else 0)
            + p.pixel_count * p.spp * FLOP_PER_CAMERA_RAY
            + shades[0] * FLOP_PER_NOISE_SHADE
            + shades[1] * FLOP_PER_IMAGE_SHADE)
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_flop = ops_ms(flop)
    return max(t_bytes, t_flop), ("bytes" if t_bytes > t_flop else "operations")


def scene_inputs(name, width, spp, depth, seed=0, sample_offset=0,
                 use_bvh=False, pixel_base=0, pixel_count=None):
    b, settings = getattr(builders, name)()
    settings = dataclasses.replace(settings, image_width=width,
                                   samples_per_pixel=spp, max_depth=depth)
    scene = rt.compile_scene(b, device=DEVICE)
    camera = rt.Camera.create(settings)
    packed, tables = mk._packed_dev(scene, use_bvh)
    p = mk.make_params(camera, packed, seed, spp, depth, sample_offset,
                       pixel_base, pixel_count)
    return scene, camera, tables, p


def spills(kernel, *flags):
    """Spill stores in bytes that ptxas reported (-Xptxas -v, the build log)
    for ``kernel``'s instantiation with these template flags."""
    mangled = f"{kernel}I" + "".join(f"Lb{int(f)}E" for f in flags)
    lines = kernels.build_log.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry" in ln and mangled in ln:
            for nxt in lines[i + 1:i + 4]:
                if "spill stores" in nxt:
                    return int(nxt.split("bytes spill stores")[0]
                               .split(",")[-1])
    return None


def occupancy(p, plan):
    """The render kernel's resources for this launch and the waves of its
    grid: warps over the warps the card holds at once."""
    occ = mk.render_occupancy(p, plan)
    warps = -(-p.pixel_count * plan.group // 32)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    resident = sms * occ["blocks_per_sm"] * mk.RENDER_THREADS // 32
    return dict(occ, warps=warps, waves=warps / resident,
                spill_stores=spills(
                    "render_kernel", p.has_noise, p.has_image, p.use_bvh,
                    plan.stage_bytes > 0))


def texture_shades(tables, p):
    """(noise, image) shaded bounces of the paths of ``p``: the winners the
    recorder reports (the render traces the same paths) whose material's
    texture is noise or image, a checker counted by either child. Sample
    slices keep the records under grad.RECORD_BUDGET_ENTRIES."""
    sph_m, quad_m = tables["sph_m"], tables["quad_m"]
    med_m = tables["med_i"][:, 1].contiguous()
    tex_i = tables["tex_i"]
    mat_tex = tables["mat_i"][:, 1].contiguous()
    step = max(1, tg.RECORD_BUDGET_ENTRIES // (p.max_depth * p.pixel_count))
    counts = [0, 0]
    for s0 in range(0, p.spp, step):
        q = type(p).from_buffer_copy(p)
        q.spp, q.sample_offset = min(step, p.spp - s0), p.sample_offset + s0
        rec = mk.record_kernel(tables, q).reshape(-1)
        kind, idx = rec >> 24, rec & 0xFFFFFF
        mat = torch.where(
            kind == 1, sph_m[idx.clamp(max=sph_m.numel() - 1)],
            torch.where(kind == 2, quad_m[idx.clamp(max=quad_m.numel() - 1)],
                        med_m[(kind - 3).clamp(0, med_m.numel() - 1)]))
        del idx
        tex = mat_tex[mat]
        del mat
        kinds = [tex_i[tex, 0], tex_i[tex_i[tex, 1], 0],
                 tex_i[tex_i[tex, 2], 0]]
        is_chk = kinds[0] == mk.TEX_CHECKER
        for k, code in enumerate((mk.TEX_NOISE, mk.TEX_IMAGE)):
            uses = (kinds[0] == code) | (is_chk & ((kinds[1] == code)
                                                   | (kinds[2] == code)))
            counts[k] += int(((kind > 0) & uses).sum().item())
        del rec, kind, tex, kinds
    return tuple(counts)


def walk_counts(counters):
    """Summed (node visits, sphere tests, quad tests) of a counter buffer."""
    return [int(x) for x in counters.sum(0, dtype=torch.int64).tolist()]


def compare(name, width, spp, depth, reps_kernel=3, use_bvh=False,
            pixel_base=0, pixel_count=None, unstaged=False):
    """Render kernel vs plain version on the card, same inputs. With
    ``use_bvh`` the kernel walks the BVH and its counters give the bound.
    Without the noise and image families every pixel and ray count must be
    equal (the samples are added in the plain version's order). With
    ``unstaged`` the same brute-loop launch with the tables read through
    __ldg instead of shared memory is held to the same gate and timed."""
    scene, camera, tables, p = scene_inputs(name, width, spp, depth, seed=11,
                                            use_bvh=use_bvh,
                                            pixel_base=pixel_base,
                                            pixel_count=pixel_count)
    plan = mk.render_plan(tables, p)
    counters = torch.zeros((p.pixel_count, 3), dtype=torch.int32,
                           device=DEVICE) if use_bvh else None
    rgb_k, n_k = mk.render_kernel(tables, p, counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rgb_p, n_p = mk.render_fast_plain(tables, p)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    kernel_ms = time_ms(lambda: mk.render_kernel(tables, p), reps_kernel)
    strict = use_bvh or not (p.has_noise or p.has_image)
    extra = {}
    if unstaged:
        ldg = mk.RenderPlan.from_buffer_copy(plan)
        ldg.stage_bytes = 0
        rgb_u, n_u = mk.render_kernel(tables, p, plan=ldg)
        extra = dict(
            unstaged_bitwise_equal=bool(torch.equal(rgb_u, rgb_p)
                                        and torch.equal(n_u, n_p)),
            unstaged_ms=time_ms(lambda: mk.render_kernel(tables, p,
                                                         plan=ldg),
                                reps_kernel),
            unstaged_occupancy=occupancy(p, ldg))

    if not (torch.isfinite(rgb_k).all() and torch.isfinite(rgb_p).all()):
        fail(f"{name}: non-finite radiance")
    diff = (rgb_k - rgb_p).abs()
    beyond = (diff > PIX_ATOL + PIX_RTOL * rgb_p.abs()).any(dim=-1)
    n_rays = int(n_k.sum(dtype=torch.int64).item())
    shades = texture_shades(tables, p) if (p.has_noise or p.has_image) \
        else (0, 0)
    walk = walk_counts(counters) if use_bvh else None
    b_ms, b_by = bound_ms(tables, p, n_rays, shades=shades, walk=walk)
    if walk is not None:
        extra["walk_per_ray"] = [w / n_rays for w in walk]
    res = dict(
        kernel="render_kernel", has_noise=p.has_noise, has_image=p.has_image,
        use_bvh=p.use_bvh, nodes=p.n_nodes, walk=walk,
        noise_shades=shades[0], image_shades=shades[1],
        scene=name, width=camera.image_width, height=camera.image_height,
        spp=spp, depth=depth, pixel_base=p.pixel_base, spheres=p.n_spheres,
        quads=p.n_quads, media=p.n_media, rays=n_rays,
        rays_plain=int(n_p.sum(dtype=torch.int64).item()),
        pixels_ray_count_differs=int((n_k != n_p).sum().item()),
        pixels_bitwise_equal=int((rgb_k == rgb_p).all(dim=-1).sum().item()),
        pixels=p.pixel_count,
        max_abs_err=float(diff.max().item()),
        mean_abs_err=float(diff.mean().item()),
        share_beyond_tol=float(beyond.float().mean().item()),
        mean_ratio=float((rgb_k.mean() / rgb_p.mean()).item()),
        kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        bitwise_gate=strict, occupancy=occupancy(p, plan), **extra)
    say("kernels", **res)
    if strict and (res["pixels_bitwise_equal"] != p.pixel_count
                   or res["pixels_ray_count_differs"]):
        fail(f"{name} @ {spp} spp: the kernel differs from the plain version "
             f"in {p.pixel_count - res['pixels_bitwise_equal']} pixels, ray "
             f"counts in {res['pixels_ray_count_differs']}")
    if unstaged and not extra["unstaged_bitwise_equal"]:
        fail(f"{name} @ {spp} spp: the kernel reading its tables through "
             "__ldg differs from the plain version")
    if res["share_beyond_tol"] > MAX_DIVERGED_SHARE:
        fail(f"{name}: {res['share_beyond_tol']:.4f} of pixels beyond "
             f"tolerance (limit {MAX_DIVERGED_SHARE})")
    if res["pixels_ray_count_differs"] > MAX_DIVERGED_SHARE * p.pixel_count:
        fail(f"{name}: ray counts differ in "
             f"{res['pixels_ray_count_differs']} pixels")
    if abs(res["mean_ratio"] - 1.0) > MAX_MEAN_RATIO_ERR:
        fail(f"{name}: mean-image ratio {res['mean_ratio']}")
    return res


def record_occupancy(tables, p):
    """The recorder's resources for this launch (record_plan: staged or
    not) and the waves of its grid: warps over the warps the card holds at
    once."""
    plan = mk.record_plan(tables, p)
    occ = mk.search_occupancy("record_kernel", bool(p.use_bvh),
                              plan.stage_bytes)
    warps = plan.blocks * mk.RECORD_THREADS // 32
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    resident = sms * occ["blocks_per_sm"] * mk.RECORD_THREADS // 32
    return dict(occ, blocks=plan.blocks, warps=warps, waves=warps / resident,
                spill_stores=spills("record_kernel", p.use_bvh,
                                    plan.stage_bytes > 0))


def compare_records(name, width, spp, depth, sample_offset, timed=False,
                    use_bvh=False, pixel_base=0, pixel_count=None,
                    counters=False):
    """Path recorder vs its plain version on the card: every record equal.
    With ``counters`` (a BVH launch) the kernel's per-pixel walk counters,
    summed over the samples, must equal the plain walk's
    (megakernel.record_walk_plain). With ``timed``, also the kernel's time
    by CUDA events, its resources and waves, and its bound, whose ray count
    comes from the render kernel's per-pixel count of the same paths (both
    trace them through the same device functions)."""
    scene, camera, tables, p = scene_inputs(name, width, spp, depth, seed=3,
                                            sample_offset=sample_offset,
                                            use_bvh=use_bvh,
                                            pixel_base=pixel_base,
                                            pixel_count=pixel_count)
    cnt = torch.zeros((p.pixel_count, 3), dtype=torch.int32,
                      device=DEVICE) if counters else None
    rec_k = mk.record_kernel(tables, p, cnt)
    torch.cuda.synchronize()
    rec_p, plain_ms = once_ms(lambda: mk.record_paths_plain(tables, p))
    differ = int((rec_k != rec_p).sum().item())
    res = dict(kernel="record_kernel", scene=name, width=camera.image_width,
               height=camera.image_height, spp=spp, depth=depth,
               use_bvh=p.use_bvh, pixel_base=p.pixel_base,
               pixels=p.pixel_count,
               staged=mk.record_plan(tables, p).stage_bytes,
               sample_offset=sample_offset, records=rec_k.numel(),
               records_differ=differ,
               nonzero=int((rec_k != 0).sum().item()),
               max_abs_err=float((rec_k.long() - rec_p.long()).abs().max()
                                 .item()),
               plain_ms=plain_ms)
    if counters:
        walk = mk.record_walk_plain(tables, p)
        got = cnt.cpu().numpy()
        res["pixels_counters_differ"] = int((got != walk).any(1).sum())
        res["walk"] = [int(x) for x in got.sum(0)]
    if timed:
        _, n = mk.render_kernel(tables, p)
        n_rays = int(n.sum(dtype=torch.int64).item())
        res["kernel_ms"] = time_ms(lambda: mk.record_kernel(tables, p), 3)
        res["rays"] = n_rays
        res["bound_ms"], res["bound_by"] = bound_ms(tables, p, n_rays,
                                                    shade=False)
        res["occupancy"] = record_occupancy(tables, p)
    say("kernels", **res)
    if differ:
        fail(f"record_kernel: {differ} records of {name} differ from the "
             f"plain version")
    if res.get("pixels_counters_differ"):
        fail(f"record_kernel: walk counters of {name} differ from the plain "
             f"walk's in {res['pixels_counters_differ']} pixels")
    return res


def compare_gathers(reps=10):
    """B5 and B6 against their plain versions and torch.index_select: equal
    bits; times at every table size, f32 and i32."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1)
    out = {}
    for n in TABLE_ROWS:
        idx = torch.randint(0, n, (N_INDEX,), device=DEVICE,
                            dtype=torch.int32, generator=gen)
        idx_l = idx.long()
        for dt in (torch.float32, torch.int32):
            col = (torch.randn(n, device=DEVICE, generator=gen) * 1e3).to(dt)
            got = lg.gather_kernel(col, idx)
            _, plain_ms = once_ms(lambda: lg.gather_plain(col, idx))
            same = (torch.equal(got, lg.gather_plain(col, idx))
                    and torch.equal(got, col.index_select(0, idx_l)))
            ms = device_ms(lambda: lg.gather_kernel(col, idx), reps)
            call = time_ms(lambda: lg.gather_kernel(col, idx), reps)
            lib = device_ms(lambda: col.index_select(0, idx_l), reps)
            b_ms, b_by = bytes_bound(N_INDEX * (4 + 4) + n * 4)
            res = dict(kernel="gather_kernel", rows=n, dtype=str(dt),
                       indices=N_INDEX, bitwise_equal=same, kernel_ms=ms,
                       call_ms=call, plain_ms=plain_ms, library_ms=lib,
                       bound_ms=b_ms, bound_by=b_by)
            say("kernels", **res)
            if not same:
                fail(f"gather_kernel differs at {n} rows, {dt}")
            out[("gather", n, dt)] = res
            for K in (8, 17):
                tab = (torch.randn(K, n, device=DEVICE, generator=gen)
                       * 1e3).to(dt)
                got = lg.gather_cols_kernel(tab, idx)
                _, plain_ms = once_ms(lambda: lg.gather_cols_plain(tab, idx))
                same = (torch.equal(got, lg.gather_cols_plain(tab, idx))
                        and torch.equal(got, tab.index_select(1, idx_l)))
                ms = device_ms(lambda: lg.gather_cols_kernel(tab, idx), reps)
                call = time_ms(lambda: lg.gather_cols_kernel(tab, idx), reps)
                lib = device_ms(lambda: tab.index_select(1, idx_l), reps)
                b_ms, b_by = bytes_bound(N_INDEX * (4 + 4 * K) + K * n * 4)
                res = dict(kernel="gather_cols_kernel", rows=n, columns=K,
                           dtype=str(dt), indices=N_INDEX,
                           bitwise_equal=same, kernel_ms=ms, call_ms=call,
                           plain_ms=plain_ms, library_ms=lib, bound_ms=b_ms,
                           bound_by=b_by)
                say("kernels", **res)
                if not same:
                    fail(f"gather_cols_kernel differs at {n} rows, K={K}, "
                         f"{dt}")
                out[("cols", n, K, dt)] = res
    return out


@contextlib.contextmanager
def recorded_reductions(keep=False):
    """Within the block, every call of the reduction's three forms (the tile
    kernel, the match kernel, the segment sum) is appended to the yielded
    list as (route, K, n, R, dtype), with its cotangent and index when
    ``keep``."""
    calls = []
    tile, match = lg.scatter_sum_kernel, lg.scatter_match_kernel
    seg = lg.segment_sum_kernel

    def wrap(route, fn):
        def call(ct, idx, n):
            calls.append((route, ct.shape[0], n, idx.numel(), str(ct.dtype))
                         + ((ct.clone(), idx.clone()) if keep else ()))
            return fn(ct, idx, n)
        return call

    lg.scatter_sum_kernel = wrap("tile", tile)
    lg.scatter_match_kernel = wrap("match", match)
    lg.segment_sum_kernel = wrap("segment", seg)
    try:
        yield calls
    finally:
        lg.scatter_sum_kernel, lg.scatter_match_kernel = tile, match
        lg.segment_sum_kernel = seg


def replay_reductions():
    """The cornell gradient's first replay bounce (grad_path's scene and
    depth, one replay chunk: 11 spp, 3 960 000 lanes): the cotangent and
    index of the backward's last reduction, bounce 0's tex_rgb column (the
    shape of every reduction of that gradient, by phase_profile's census),
    and the index of the first 17-column gather, bounce 0's quads (their
    table gets no cotangent from a mean loss of this scene: its radiance
    does not depend on the geometry)."""
    b, settings = builders.cornell_box()
    scene = rt.compile_scene(b, device=DEVICE)
    camera = rt.Camera.create(settings)
    got = {}
    cols = lg.gather_cols_kernel

    def cols_rec(tab, idx):
        if tab.shape[0] == 17 and "quad_idx" not in got:
            got["quad_idx"], got["quad_n"] = idx.clone(), tab.shape[1]
        return cols(tab, idx)

    lg.gather_cols_kernel = cols_rec
    try:
        with recorded_reductions(keep=True) as calls:
            tg.loss_and_grad(scene, camera, lambda im, p: im.mean(), seed=4,
                             spp=11, max_depth=GRAD_DEPTH, linear_loss=True)
            torch.cuda.synchronize()
    finally:
        lg.gather_cols_kernel = cols
    route, K, n, R, _, ct, idx = calls[-1]
    got.update(ct=ct, idx=idx, n=n, route=route)
    return got


def check_reduction(label, ct, idx, n, ints=None, reps=5, form="tile"):
    """One reduction cell of the tile kernel (``form`` "tile": bit for bit
    its order in tensor code, lanegather.scatter_sum_ordered_plain) or the
    match kernel ("match"): repeatable, within SUM_TOL of each row's sum of
    |cotangent| of the plain version, exact on integer-valued cotangents
    ``ints`` where given; device and call times beside the plain version's,
    index_add_'s (in-range elements) and the bound (the index and the
    in-range cotangents read once, the table written once)."""
    K, R, es = ct.shape[0], idx.numel(), ct.element_size()
    kernel = REDUCTION_FORMS[form]
    got = kernel(ct, idx, n)
    ordered = form != "tile" or torch.equal(
        got, lg.scatter_sum_ordered_plain(ct, idx, n))
    repeat = torch.equal(got, kernel(ct, idx, n))
    exact = ints is None or torch.equal(kernel(ints, idx, n),
                                        lg.scatter_sum_plain(ints, idx, n))
    ref, plain_ms = once_ms(lambda: lg.scatter_sum_plain(ct, idx, n))
    scale = lg.scatter_sum_plain(ct.abs(), idx, n)
    err = (got - ref).abs()
    within = bool((err <= SUM_TOL * scale).all())
    flat = idx.reshape(-1).long()
    ok = (flat >= 0) & (flat < n)
    keep, cts = flat[ok], ct.reshape(K, R)[:, ok]
    lib = device_ms(lambda: torch.zeros(
        (K, n), device=DEVICE, dtype=ct.dtype).index_add_(1, keep, cts), reps)
    b_ms, b_by = bytes_bound(R * 4 + keep.numel() * K * es + K * n * es)
    res = dict(kernel=f"scatter_{'sum' if form == 'tile' else form}_kernel",
               check=label, rows=n, columns=K, indices=R,
               in_range=keep.numel(), dtype=str(ct.dtype),
               plan=lg.scatter_plan(R, n, K, es) if form == "tile" else None,
               bitwise_equal_ordered=ordered if form == "tile" else None,
               exact_on_integers=exact, bitwise_repeatable=repeat,
               within_tol=within, max_abs_err=float(err.max().item()),
               max_err_over_abs_sum=float((err / scale.clamp(
                   min=1e-30)).max().item()),
               kernel_ms=device_ms(lambda: kernel(ct, idx, n), reps),
               call_ms=time_ms(lambda: kernel(ct, idx, n), reps),
               plain_ms=plain_ms, library_ms=lib, bound_ms=b_ms,
               bound_by=b_by)
    say("kernels", **res)
    if not (ordered and exact and repeat and within):
        fail(f"{res['kernel']} ({label}) at {n} rows, K={K}: "
             f"bitwise_ordered={ordered} exact={exact} repeatable={repeat} "
             f"within_tol={within}")
    return res


def compare_reductions(reps=5):
    """The tile kernel against its order in tensor code (bit for bit) and
    its plain version on a random index of one replay wavefront, with 1 and
    17 columns, at the table sizes it takes (TABLE_ROWS up to
    SCATTER_TILE_MAX_ROWS) and at 488 rows (passes over row tiles); at an
    index count that is no multiple of SCATTER_CHUNK with out-of-range
    indices; in float64; and on the cornell gradient's first replay bounce
    (its tex_rgb reduction, the main path's shape, and its quads' index with
    random cotangents), each beside a random index of the same shape. The
    match kernel against its plain version at the larger TABLE_ROWS (and
    in phase_grad_final at that gradient's own shape)."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(2)
    out = {}

    def ints_like(shape):
        return torch.randint(-8, 9, shape, device=DEVICE,
                             generator=gen).to(torch.float32)

    for n in TABLE_ROWS:
        idx = torch.randint(0, n, (N_INDEX,), device=DEVICE,
                            dtype=torch.int32, generator=gen)
        for K in (1, 17):
            ct = torch.randn(K, N_INDEX, device=DEVICE, generator=gen)
            ints = ints_like((K, N_INDEX))
            if lg.use_tile_kernel(n) or (n, K) == (488, 17):
                out[(n, K)] = check_reduction("random", ct, idx, n, ints,
                                              reps)
            if not lg.use_tile_kernel(n):
                out[("match", n, K)] = check_reduction(
                    "random", ct, idx, n, ints, reps, form="match")
    R = N_INDEX - 37
    idx = torch.randint(-3, 24 + 3, (R,), device=DEVICE, dtype=torch.int32,
                        generator=gen)
    for K in (1, 17):
        ct = torch.randn(K, R, device=DEVICE, generator=gen)
        check_reduction("out of range, R mod SCATTER_CHUNK != 0", ct, idx, 24,
                        ints_like((K, R)), reps)
    ct = torch.randn(3, R, device=DEVICE, generator=gen, dtype=torch.float64)
    check_reduction("float64", ct, idx, 24, None, reps)

    real = replay_reductions()
    ct, idx, n = real["ct"], real["idx"], real["n"]
    rnd = torch.randint(0, n, idx.shape, device=DEVICE, dtype=torch.int32,
                        generator=gen)
    out["real"] = check_reduction("cornell replay bounce 0, tex_rgb", ct,
                                  idx, n, ints_like(tuple(ct.shape)), reps)
    out["real"]["route"] = real["route"]
    out["real_random"] = check_reduction("random index, tex_rgb's shape", ct,
                                         rnd, n, None, reps)
    qi, qn = real["quad_idx"], real["quad_n"]
    qct = torch.randn((17,) + tuple(qi.shape), device=DEVICE, generator=gen)
    qrnd = torch.randint(0, qn, qi.shape, device=DEVICE, dtype=torch.int32,
                         generator=gen)
    out["quad"] = check_reduction("cornell replay bounce 0, quad index", qct,
                                  qi, qn, ints_like(tuple(qct.shape)), reps)
    out["quad_random"] = check_reduction("random index, quad shape", qct,
                                         qrnd, qn, None, reps)
    return out


def _kernel_name(name):
    """A device event's kernel name without its namespace, template
    arguments and parameters (``void ns::k<float>(...)`` -> ``k``)."""
    head = name.replace("(anonymous namespace)::", "").split("(")[0]
    return head.split("<")[0].split("::")[-1].strip().split(" ")[-1]


# device work the segment-sum call may launch: its own kernels and the fill
# of torch.zeros (allocations launch nothing else)
SEG_ALLOWED = ("radix_hist_kernel", "radix_scan_kernel",
               "radix_scatter_kernel", "segment_sum_kernel",
               "segment_carry_kernel", "FillFunctor")


def pipeline_ms(fn, reps):
    """Device ms of one call of ``fn``, in all and by kernel (torch.profiler
    over ``reps`` calls after a warm-up), and the device work it launched
    that is neither one of the segment sum's kernels nor a fill."""
    by, other = {}, set()
    for name, us in profiled_events(fn, reps):
        key = _kernel_name(name)
        by[key] = by.get(key, 0.0) + us / 1e3 / reps
        if not any(a in name for a in SEG_ALLOWED):
            other.add(name[:120])
    return sum(by.values()), by, sorted(other)


def compare_segment_sums(reps=3):
    """The segment sum (its own stable radix sort of the index, then one
    pass over the sorted runs) against its plain version: exact on
    integer-valued cotangents, within SUM_TOL on normal ones, bitwise
    repeatable, f32 and f64; device time by kernel of the pipeline, beside
    the match kernel and index_add_, 3 columns (an image's r g b) and one replay wavefront. The
    call may launch only the repo's kernels and torch.zeros' fill."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(4)
    out = {}
    for n in SEG_ROWS:
        idx = torch.randint(0, n, (N_INDEX,), device=DEVICE,
                            dtype=torch.int32, generator=gen)
        idx_l = idx.long()
        ints = torch.randint(-8, 9, (3, N_INDEX), device=DEVICE,
                             generator=gen).to(torch.float32)
        exact = torch.equal(lg.segment_sum_kernel(ints, idx, n),
                            lg.scatter_sum_plain(ints, idx, n))
        # the sort alone, carrying the 3 cotangent columns: its plain
        # version is torch.sort(stable=True) and a gather of the columns
        vals = torch.randn(3, N_INDEX, device=DEVICE, generator=gen)
        keys, svals = lg.radix_sort_kernel(idx, n, vals)
        (keys_p, svals_p), sort_plain_ms = once_ms(
            lambda: lg.radix_sort_plain(idx, n, vals))
        sort = dict(
            kernel="radix_sort_kernel", rows=n, indices=N_INDEX, columns=3,
            digits=list(lg.radix_digits(n)),
            bitwise_equal=bool(torch.equal(keys, keys_p)
                               and torch.equal(svals, svals_p)),
            kernel_ms=device_ms(lambda: lg.radix_sort_kernel(idx, n, vals),
                                reps),
            plain_ms=sort_plain_ms,
            library_ms=device_ms(lambda: torch.sort(idx, stable=True), reps))
        # the index and the columns read once, the keys and columns written
        sort["bound_ms"], sort["bound_by"] = bytes_bound(N_INDEX * 2 * 16)
        say("kernels", **sort)
        if not sort["bitwise_equal"]:
            fail(f"radix_sort_kernel at {n} rows differs from a stable sort")
        out[(n, "sort")] = sort
        for dt in (torch.float32, torch.float64):
            ct = torch.randn(3, N_INDEX, device=DEVICE, generator=gen,
                             dtype=dt)
            got = lg.segment_sum_kernel(ct, idx, n)
            repeat = torch.equal(got, lg.segment_sum_kernel(ct, idx, n))
            ref, plain_ms = once_ms(lambda: lg.scatter_sum_plain(ct, idx, n))
            scale = lg.scatter_sum_plain(ct.abs(), idx, n)
            err = (got - ref).abs()
            within = bool((err <= SUM_TOL * scale).all())
            ms, by_kernel, other = pipeline_ms(
                lambda: lg.segment_sum_kernel(ct, idx, n), reps)
            call = time_ms(lambda: lg.segment_sum_kernel(ct, idx, n), reps)
            tile_ms = device_ms(lambda: lg.scatter_match_kernel(ct, idx, n),
                                reps)
            tile_call = time_ms(lambda: lg.scatter_match_kernel(ct, idx, n),
                                reps)
            lib = device_ms(lambda: torch.zeros(
                (3, n), device=DEVICE, dtype=dt).index_add_(1, idx_l, ct),
                reps)
            es = ct.element_size()
            b_ms, b_by = bytes_bound(N_INDEX * (4 + es * 3) + 3 * n * es)
            res = dict(kernel="segment_sum_kernel", rows=n, columns=3,
                       dtype=str(dt), indices=N_INDEX,
                       exact_on_integers=exact, bitwise_repeatable=repeat,
                       within_tol=within, max_abs_err=float(err.max().item()),
                       kernel_ms=ms, kernel_ms_by_kernel=by_kernel,
                       call_ms=call, match_kernel_ms=tile_ms,
                       match_call_ms=tile_call, plain_ms=plain_ms,
                       library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                       other_device_work=other)
            say("kernels", **res)
            if not (exact and repeat and within):
                fail(f"segment_sum_kernel at {n} rows, {dt}: exact={exact} "
                     f"repeatable={repeat} within_tol={within}")
            if other:
                fail(f"segment_sum_kernel at {n} rows launched device work "
                     f"other than its own kernels and fills: {other}")
            out[(n, dt)] = res
    return out


def reduction_form(n, K, elem):
    """The form lanegather.scatter_sum_cols gives a reduction: "tile",
    "match" or "segment"."""
    if lg.use_tile_kernel(n):
        return "tile"
    return "segment" if lg.use_segment_sum(n, K, elem) else "match"


REDUCTION_FORMS = {"tile": lambda *a: lg.scatter_sum_kernel(*a),
                   "match": lambda *a: lg.scatter_match_kernel(*a),
                   "segment": lambda *a: lg.segment_sum_kernel(*a)}


def scatter_routes(reps=5):
    """The three forms of the reduction at the table sizes around their
    crossovers: device time (torch.profiler) and call time (CUDA events over
    back-to-back calls, host launches included) of the tile kernel, the
    match kernel and the segment sum at ROUTE_ROWS x ROUTE_COLS x
    ROUTE_INDICES, f32, and f64 at 1 and 3 columns; which one
    scatter_sum_cols picks (reduction_form), and what the picks lose in
    device time against the fastest form in each cell."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(5)
    cells, lost = [], 0.0
    for R in ROUTE_INDICES:
        for n in ROUTE_ROWS:
            idx = torch.randint(0, n, (R,), device=DEVICE, dtype=torch.int32,
                                generator=gen)
            for dt, cols in ((torch.float32, ROUTE_COLS),
                             (torch.float64, (1, 3))):
                for K in cols:
                    ct = torch.randn(K, R, device=DEVICE, generator=gen,
                                     dtype=dt)
                    ms = {f: device_ms(lambda: fn(ct, idx, n), reps)
                          for f, fn in REDUCTION_FORMS.items()}
                    call = {f"{f}_call_ms": time_ms(lambda: fn(ct, idx, n),
                                                    reps)
                            for f, fn in REDUCTION_FORMS.items()}
                    pick = reduction_form(n, K, ct.element_size())
                    fastest = min(ms, key=ms.get)
                    lost += ms[pick] - ms[fastest]
                    cells.append(dict(indices=R, rows=n, columns=K,
                                      dtype=str(dt), **{
                                          f"{f}_ms": t for f, t in ms.items()},
                                      **call, picks=pick, fastest=fastest))
    wrong = [c for c in cells if c["picks"] != c["fastest"]]
    say("kernels", check="scatter_routes", cells=cells,
        picks_slower_in=len(wrong), of=len(cells), ms_lost=lost)
    return cells


def sm_clock_mhz():
    """The card's maximum SM clock (nvidia-smi), in MHz."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])


def _load_wavefronts(addr, banks, lanes):
    """Wavefronts of one warp-wide shared-memory load per row of ``addr``
    (a row = a warp's 32 lane addresses, in units of the access width):
    ``lanes`` lanes are served together (32 for a 32-bit load, 8 for a
    128-bit one), and a group of them costs the largest number of distinct
    addresses any one of its ``banks`` banks (bank groups) holds; equal
    addresses broadcast."""
    a = addr.reshape(-1, lanes).sort(dim=1).values
    first = torch.ones_like(a, dtype=torch.int32)
    first[:, 1:] = (a[:, 1:] != a[:, :-1]).to(torch.int32)
    per_bank = torch.zeros((a.shape[0], banks), dtype=torch.int32,
                           device=a.device)
    per_bank.scatter_add_(1, (a % banks).long(), first)
    return int(per_bank.max(dim=1).values.sum())


def smem_wavefronts(tabs, pos, depth=pf.DEPTH):
    """Shared-memory wavefronts of perlin_kernel's gathers (f32) for these
    lanes, by warps of 32 consecutive lanes: (counted, conflict_free).
    Each octave a lane reads 3 packed permutation words (32-bit, word
    a * 256 + (i & 255) of axis a) and 8 replicated gradient rows (128-bit,
    slot 8 h + lane % 8). Conflict-free, a warp-octave costs 3 x 1 + 8 x 4
    wavefronts. The staging (~0.6 % more) is left out."""
    perms = tabs[1:]
    R = pos[0].numel() // 32 * 32
    xyz = [p.reshape(-1)[:R] for p in pos]
    slot_lane = (torch.arange(R, device=xyz[0].device) % 8).to(torch.int32)
    counted = 0
    s = 1.0
    for _ in range(depth):
        cells = [torch.floor(p * s).to(torch.int32) & 255 for p in xyz]
        hs = []
        for a, (c, q) in enumerate(zip(cells, perms)):
            counted += _load_wavefronts(a * 256 + c, 32, 32)
            hs.append((q[c.long()], q[((c + 1) & 255).long()]))
        for di in (0, 1):
            for dj in (0, 1):
                for dk in (0, 1):
                    h = hs[0][di] ^ hs[1][dj] ^ hs[2][dk]
                    counted += _load_wavefronts(h * 8 + slot_lane, 8, 8)
        s *= 2.0
    return counted, R // 32 * depth * (3 + 8 * 4)


def real_bounce_lanes():
    """Tables and positions of two_perlin_spheres' first replay bounce at
    the texture gradient's frame (GRAD_TEX_WIDTH @ GRAD_TEX_SPP): the first
    turbulence call of its deferred render."""
    from rust_tracing_tpu_torch.ops import textures

    seen = []
    orig = textures.perlin_fused.turbulence

    def keep(*a, **k):
        if not seen:
            seen.append([t.detach().clone() for t in a[:7]])
        return orig(*a, **k)

    scene, camera = texture_scene("two_perlin_spheres", width=GRAD_TEX_WIDTH,
                                  spp=GRAD_TEX_SPP, depth=GRAD_DEPTH)
    textures.perlin_fused.turbulence = keep
    try:
        rt.render(scene, camera, seed=6)
    finally:
        textures.perlin_fused.turbulence = orig
    return seen[0][:4], seen[0][4:]


def turb_inputs(dtype=torch.float32, lanes=TURB_LANES):
    """The turbulence compares' inputs: seeded tables, positions over
    [-300, 300]^3 (negative lattice cells and final_scene's coordinate
    range), a seeded normal cotangent."""
    rv, px, py, pz = perlin.make_tables(5)
    tabs = (torch.from_numpy(rv).to(dtype).to(DEVICE),
            *[torch.from_numpy(q).to(DEVICE) for q in (px, py, pz)])
    pts = np.random.default_rng(7).uniform(-TURB_RANGE, TURB_RANGE,
                                           (3, lanes)).astype(np.float32)
    pos = [torch.from_numpy(a).to(dtype).to(DEVICE) for a in pts]
    g = torch.from_numpy(np.random.default_rng(8).standard_normal(
        lanes).astype(np.float32)).to(dtype).to(DEVICE)
    return tabs, pos, g


def smem_floor_ms(wavefronts):
    """One wavefront a clock on every SM at the card's maximum SM clock."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return wavefronts / (n_sm * sm_clock_mhz() * 1e6) * 1e3


def compare_perlin(reps=10):
    """The turbulence kernel (B7) against its plain version at the replay
    wavefront's size: bit for bit, f32 (and f64 on fewer lanes); timed
    there and on two_perlin_spheres' first replay bounce; its shared-memory wavefront floor beside the
    operation bound."""
    tabs, pos, _ = turb_inputs()
    got = pf.turbulence_kernel(*tabs, *pos)
    ref, plain_ms = once_ms(lambda: pf.turbulence_plain(*tabs, *pos))
    tabs64, pos64, _ = turb_inputs(torch.float64, 65536)
    same64 = torch.equal(pf.turbulence_kernel(*tabs64, *pos64),
                         pf.turbulence_plain(*tabs64, *pos64))
    ms = device_ms(lambda: pf.turbulence_kernel(*tabs, *pos), reps)
    call = time_ms(lambda: pf.turbulence_kernel(*tabs, *pos), reps)
    t_ops = ops_ms(TURB_LANES * TURB_OPS)
    t_bytes, _ = bytes_bound(TURB_LANES * 16 + 4 * 256 * 4)
    counted, free = smem_wavefronts(tabs, pos)
    rb_tabs, rb_pos = real_bounce_lanes()
    rb_ms = device_ms(lambda: pf.turbulence_kernel(*rb_tabs, *rb_pos), reps)
    rb_same = torch.equal(pf.turbulence_kernel(*rb_tabs, *rb_pos),
                          pf.turbulence_plain(*rb_tabs, *rb_pos))
    rb_counted, rb_free = smem_wavefronts(rb_tabs, rb_pos)
    res = dict(kernel="perlin_kernel", lanes=TURB_LANES, range=TURB_RANGE,
               ops_per_lane=TURB_OPS,
               differ=int((got != ref).sum().item()),
               f64_bitwise_equal=same64,
               max_abs_err=float((got - ref).abs().max().item()),
               finite=bool(torch.isfinite(got).all()),
               kernel_ms=ms, call_ms=call, plain_ms=plain_ms,
               bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops > t_bytes else "bytes",
               bound_ops_ms=t_ops, bound_bytes_ms=t_bytes, library_ms=None,
               sm_clock_mhz=sm_clock_mhz(),
               smem_wavefronts=counted, smem_wavefronts_conflict_free=free,
               smem_floor_ms=smem_floor_ms(counted),
               smem_floor_conflict_free_ms=smem_floor_ms(free),
               real_bounce=dict(
                   scene="two_perlin_spheres", width=GRAD_TEX_WIDTH,
                   spp=GRAD_TEX_SPP, lanes=rb_pos[0].numel(),
                   kernel_ms=rb_ms, bitwise_equal=rb_same,
                   smem_floor_ms=smem_floor_ms(rb_counted),
                   smem_floor_conflict_free_ms=smem_floor_ms(rb_free)))
    say("kernels", **res)
    if res["differ"] or not same64 or not res["finite"] or not rb_same:
        fail(f"perlin_kernel: {res['differ']} of {TURB_LANES} lanes differ "
             f"from the plain version (f64 equal: {same64}, real bounce "
             f"equal: {rb_same})")
    return res


def _bwd_fold_limit(R, depth, dtype):
    """The limit on d_ranvec's error of a float fold in a fixed order, in
    units of a row's sum of |terms|: the longest chain of additions a term
    goes through when a warp's lanes are summed by hash (<= 31), each warp
    table adds a step at a time, 7 warp tables are added, then the
    partials of min(396, R / 256) blocks; times the unit of roundoff. The
    fixed-point bound (_bwd_fixed_bound) must be no larger at the compared
    sizes."""
    blocks = min(396, max(1, -(-R // 256)))
    iters = -(-R // (blocks * 256))
    adds = 31 + iters * depth * 8 + 7 + blocks - 1
    return adds * (2.0 ** -24 if dtype == torch.float32 else 2.0 ** -53)


def _bwd_fixed_bound(R, g, dtype, exact, exact_err, n_terms):
    """Bound on |kernel - S| per d_ranvec entry for the fixed-point sum
    (pf.fixed_scale): each of an entry's n terms is rounded once, by at most
    half a unit of 2^-k (f64: of 2^-(k + 32), its second word), and the
    integer sum is exact; the conversion to the type rounds at most twice
    (through float64), 2 units of roundoff. S is known to within
    ``exact_err`` of ``exact``."""
    ka, kb = pf.fixed_scale(R, float(g.abs().max()), dtype)
    frac = ka + kb + (0 if dtype == torch.float32 else 32)
    quant = n_terms * 2.0 ** -(frac + 1)
    unit = 2.0 ** -24 if dtype == torch.float32 else 2.0 ** -53
    return quant + exact_err + 2 * unit * (exact.abs() + quant + exact_err)


def _fsum_rows(terms):
    """The exact sum of each d_ranvec entry's float64 terms, rounded once
    (math.fsum): f64's reference, where a float64 sum of the terms would
    itself be no more precise than the kernel."""
    idx = torch.cat([h.reshape(-1) for h, _ in terms]).long().cpu().numpy()
    vals = torch.cat([c.reshape(3, -1) for _, c in terms], 1).double()
    vals = vals.cpu().numpy()
    order = np.argsort(idx, kind="stable")
    edges = np.searchsorted(idx[order], np.arange(257))
    out = torch.zeros((256, 3), dtype=torch.float64)
    for e in range(256):
        seg = order[edges[e]:edges[e + 1]]
        for a in range(3):
            out[e, a] = math.fsum(vals[a, seg])
    return out


# d_ranvec's error against the exact sum may be at most this many times the
# plain version's own, as the CPU computes it (the same terms summed in f32
# term by term, each by index_add_ in lane order: one fixed order, which no
# routing of the card's reductions moves). A lost or doubled term of typical
# size (|g| ~ 1, weights ~ 0.1) is ~1e3 times the roundoff of either.
BWD_PLAIN_ERR_MULTIPLE = 4.0


def _by_kernel_ms(fn, reps):
    """Device ms a call of ``fn`` by kernel name (profiled_events)."""
    out = {}
    for name, us in profiled_events(fn, reps):
        k = _kernel_name(name)
        out[k] = out.get(k, 0.0) + us / 1e3 / reps
    return out


def real_backward_lanes():
    """Tables, positions and cotangent of two_perlin_spheres' first
    turbulence backward call in the texture gradient (GRAD_TEX_WIDTH @
    GRAD_TEX_SPP, mean loss), as phase_grad_textures runs it."""
    seen = []
    orig = pf.turbulence_backward_kernel

    def keep(*a, **k):
        if not seen:
            seen.append([t.detach().clone() for t in a[:8]])
        return orig(*a, **k)

    scene, camera = texture_scene("two_perlin_spheres", width=GRAD_TEX_WIDTH,
                                  spp=GRAD_TEX_SPP, depth=GRAD_DEPTH)
    pf.turbulence_backward_kernel = keep
    try:
        tg.loss_and_grad(scene, camera, lambda im, p: im.mean(), seed=6,
                         linear_loss=True)
    finally:
        pf.turbulence_backward_kernel = orig
    return seen[0][:4], seen[0][4:7], seen[0][7]


def compare_perlin_backward(reps=10):
    """The turbulence backward kernel against its plain version on the
    forward compare's inputs (f32 at 2^22 lanes and at 2^22 - 37, f64 at
    65 536): d_px, d_py, d_pz and d_ranvec bit for bit (the plain version
    repeats the fixed-point sum); two launches, and a launch on the lanes
    in a random order, equal bit for bit; d_ranvec against the exact sum of
    its terms (float64; f64: math.fsum) within _bwd_fixed_bound, a bound no
    larger than _bwd_fold_limit, and within BWD_PLAIN_ERR_MULTIPLE times the
    error of the terms' f32 (f64) sum in lane order on the CPU. Timed at
    2^22 lanes, both outputs and positions only, by kernel, and on
    two_perlin_spheres' first backward call of its texture gradient (bit
    for bit there too), with its bound."""
    out = []
    for dtype, lanes in ((torch.float32, TURB_LANES),
                         (torch.float32, TURB_LANES - 37),
                         (torch.float64, 65536)):
        tabs, pos, g = turb_inputs(dtype, lanes)
        got = pf.turbulence_backward_kernel(*tabs, *pos, g)
        again = pf.turbulence_backward_kernel(*tabs, *pos, g)
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(9)
        perm = torch.randperm(lanes, device=DEVICE, generator=gen)
        shuf = pf.turbulence_backward_kernel(*tabs, *[p[perm] for p in pos],
                                             g[perm])
        permuted = torch.equal(shuf[0], got[0]) and all(
            torch.equal(a, b[perm]) for a, b in zip(shuf[1:], got[1:]))
        del shuf, again
        ref, plain_ms = once_ms(
            lambda: pf.turbulence_backward_plain(*tabs, *pos, g))
        differ = sum(int((a != b).sum()) for a, b in zip(got[1:], ref[1:]))
        rv_differ = int((got[0] != ref[0]).sum())
        _, _, _, terms = perlin.turbulence_vjp_c(tabs[0], *tabs[1:], *pos, g)
        exact = torch.zeros((256, 3), dtype=torch.float64, device=DEVICE)
        mag = torch.zeros_like(exact)
        n_terms = torch.zeros_like(exact)
        plain_rv = torch.zeros((256, 3), dtype=dtype)
        for h, c in terms:
            idx, c64 = h.reshape(-1).long(), c.reshape(3, -1).double().t()
            exact.index_add_(0, idx, c64)
            mag.index_add_(0, idx, c64.abs())
            n_terms.index_add_(0, idx, (c64 != 0).double())
            plain_rv = plain_rv + lg.scatter_sum_plain(
                c.reshape(3, -1).cpu(), h.reshape(-1).cpu(), 256).t()
        if dtype == torch.float32:
            # the float64 sum's own error: (n - 1) units of a row's |terms|
            exact_err = n_terms * 2.0 ** -53 * mag
        else:
            exact = _fsum_rows(terms).to(DEVICE)
            exact_err = 2.0 ** -53 * exact.abs()
        del terms
        bound = _bwd_fixed_bound(lanes, g, dtype, exact, exact_err, n_terms)
        fold_limit = _bwd_fold_limit(lanes, pf.DEPTH, dtype) * mag
        err = (got[0].double() - exact).abs()
        unit = 2.0 ** -24 if dtype == torch.float32 else 2.0 ** -53
        plain_err = float((plain_rv.to(DEVICE).double() - exact).abs().max())
        # a floor of one unit of the largest entry, should the plain sum be
        # exact
        near_plain = float(err.max()) <= BWD_PLAIN_ERR_MULTIPLE * max(
            plain_err, unit * float(exact.abs().max()))
        res = dict(kernel="perlin_backward_kernel", dtype=str(dtype),
                   lanes=lanes, d_p_differ=differ,
                   d_ranvec_differ=rv_differ, repeat_bitwise=repeat,
                   permuted_bitwise=permuted,
                   fixed_scale=pf.fixed_scale(lanes, float(g.abs().max()),
                                              dtype),
                   d_ranvec_max_abs_err=float(err.max()),
                   d_ranvec_err_over_bound=float((err / bound).max()),
                   d_ranvec_bound_over_fold_limit=float((bound / fold_limit).max()),
                   d_ranvec_plain_max_abs_err=plain_err,
                   d_ranvec_err_over_plain=float(err.max()) / plain_err
                   if plain_err else None,
                   d_ranvec_plain_multiple=BWD_PLAIN_ERR_MULTIPLE,
                   d_ranvec_absmax=float(exact.abs().max()),
                   plain_ms=plain_ms,
                   finite=all(bool(torch.isfinite(t).all()) for t in got))
        if not out:
            both = _by_kernel_ms(
                lambda: pf.turbulence_backward_kernel(*tabs, *pos, g), reps)
            res["kernel_ms"] = sum(both.values())
            res["sections_ms"] = both
            res["kernel_ms_positions_only"] = device_ms(
                lambda: pf.turbulence_backward_kernel(*tabs, *pos, g,
                                                      want_rv=False), reps)
            t_ops = ops_ms(lanes * TURB_BWD_OPS)
            t_bytes, _ = bytes_bound(lanes * 28 + 3 * 256 * 4 * 2
                                     + 3 * 256 * 4)
            res.update(ops_per_lane=TURB_BWD_OPS, bound_ms=max(t_ops, t_bytes),
                       bound_by="operations" if t_ops > t_bytes else "bytes",
                       bound_ops_ms=t_ops, bound_bytes_ms=t_bytes,
                       max_abs_err=res["d_ranvec_max_abs_err"],
                       library_ms=None)
            rb_tabs, rb_pos, rb_g = real_backward_lanes()
            rb = pf.turbulence_backward_kernel(*rb_tabs, *rb_pos, rb_g)
            rb_ref = pf.turbulence_backward_plain(*rb_tabs, *rb_pos, rb_g)
            res["real_bounce"] = dict(
                scene="two_perlin_spheres", width=GRAD_TEX_WIDTH,
                spp=GRAD_TEX_SPP, lanes=rb_g.numel(),
                g_absmax=float(rb_g.abs().max()),
                bitwise_equal=all(torch.equal(a, b)
                                  for a, b in zip(rb, rb_ref)),
                kernel_ms=device_ms(lambda: pf.turbulence_backward_kernel(
                    *rb_tabs, *rb_pos, rb_g), reps),
                kernel_ms_positions_only=device_ms(
                    lambda: pf.turbulence_backward_kernel(
                        *rb_tabs, *rb_pos, rb_g, want_rv=False), reps))
        say("kernels", **res)
        if (differ or rv_differ or not repeat or not permuted
                or not res["finite"] or not (err <= bound).all()
                or not (bound <= fold_limit).all() or not near_plain
                or not res.get("real_bounce", {}).get("bitwise_equal", True)):
            fail(f"perlin_backward_kernel ({dtype}, {lanes} lanes): {differ} "
                 f"position gradients and {rv_differ} d_ranvec entries "
                 f"differ from the plain version, repeat equal {repeat}, "
                 f"permuted equal {permuted}, d_ranvec error "
                 f"{res['d_ranvec_err_over_bound']} of its bound (bound "
                 f"{res['d_ranvec_bound_over_fold_limit']} of the fold's), "
                 f"{res['d_ranvec_err_over_plain']} x the plain version's, "
                 f"real bounce {res.get('real_bounce')}")
        out.append(res)
    return out[0]


def hit_args(lanes, n_pix, samp_base=0):
    """The hit search's ten lane tensors of a wavefront state."""
    pix, samp = wf.lane_ids(lanes, n_pix, samp_base)
    return (*lanes[1:8], pix, samp, lanes.alive)


def hit_bound_ms(tables, p, n_lanes, rays, walk):
    """Least time of one hit-kernel launch: the larger of bytes (the tables
    read once, 33 bytes of lane input and 4 of record a lane) over the
    memory rate and operations (the search as ``search_flop``, plus 120 a
    live ray for its set-up and media) over the lanes' issue rate."""
    n_bytes = sum(tables[k].numel() * tables[k].element_size()
                  for k in mk.PackedScene.TABLES) + n_lanes * (7 * 4 + 4 + 4
                                                              + 1 + 4)
    flop = search_flop(rays, p, walk) + rays * FLOP_PER_BOUNCE_SHADE
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_flop = ops_ms(flop)
    return max(t_bytes, t_flop), ("bytes" if t_bytes > t_flop else "operations")


def check_hits(label, tables, p, lanes, n_pix, bounce, compare=True,
               timed=False):
    """The hit kernel (B3) on a wavefront state's lanes, with its walk
    counters. ``compare``: against its plain version on the same lanes
    (every record equal) and on a random permutation of them (the records
    permute). ``timed``: its time by CUDA events and the bound from the
    counters (with the walk also the counters a ray and the kernel's
    resources). Returns (result, records)."""
    args = hit_args(lanes, n_pix)
    n = args[0].shape[0]
    counters = torch.zeros((n, 3), dtype=torch.int32, device=DEVICE)
    rec_k = mk.hit_kernel(tables, p, *args, bounce, counters)
    rays = int(lanes.alive.sum().item())
    walk = walk_counts(counters) if p.use_bvh else None
    res = dict(kernel="hit_kernel", check=label, use_bvh=p.use_bvh,
               lanes=n, alive=rays, bounce=bounce, walk=walk)
    if compare:
        torch.cuda.synchronize()
        rec_p, plain_ms = once_ms(
            lambda: mk.hit_records_plain(tables, p, *args, bounce))
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(bounce)
        perm = torch.randperm(n, device=DEVICE, generator=gen)
        rec_perm = mk.hit_kernel(tables, p,
                                 *[a[perm].contiguous() for a in args], bounce)
        kind = rec_k >> 24
        res.update(
            records_differ=int((rec_k != rec_p).sum().item()),
            permuted_records_differ=int((rec_perm != rec_k[perm])
                                        .sum().item()),
            winners={"miss": int((kind == 0).sum().item()),
                     "sphere": int((kind == 1).sum().item()),
                     "quad": int((kind == 2).sum().item()),
                     "medium": int((kind >= 3).sum().item())},
            max_abs_err=float((rec_k.long() - rec_p.long()).abs().max()
                              .item()),
            plain_ms=plain_ms)
    if timed:
        res["kernel_ms"] = time_ms(
            lambda: mk.hit_kernel(tables, p, *args, bounce), 5)
        res["bound_ms"], res["bound_by"] = hit_bound_ms(tables, p, n, rays,
                                                        walk)
        if p.use_bvh:
            res["walk_per_ray"] = [w / max(rays, 1) for w in walk]
            res["occupancy"] = mk.search_occupancy("hit_kernel", True)
    say("kernels", **res)
    if compare and (res["records_differ"] or res["permuted_records_differ"]):
        fail(f"hit_kernel ({label}): {res['records_differ']} records differ "
             f"from the plain version, {res['permuted_records_differ']} "
             "after a permutation")
    return res, rec_k


def check_walk_counters(label, tables, p, lanes, n_pix, bounce):
    """hit_kernel<true>'s per-lane walk counters against the plain walk's
    (megakernel.walk_wide_plain: the kernel's visiting order, stack and tie
    rule in numpy f32) on COUNTER_LANES live lanes drawn with a seed: equal
    lane by lane, so the card ran the designed traversal and not only one
    that finds the same winners. Where the kernel's record is a sphere or a
    quad (no medium in front), the plain walk's winner must be the same."""
    live = lanes.alive.nonzero()[:, 0]
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(bounce)
    pick = live[torch.randperm(live.numel(), device=DEVICE,
                               generator=gen)[:COUNTER_LANES]].sort().values
    sub = [a[pick].contiguous() for a in hit_args(lanes, n_pix)]
    n = pick.numel()
    counters = torch.zeros((n, 3), dtype=torch.int32, device=DEVICE)
    rec = mk.hit_kernel(tables, p, *sub, bounce, counters).cpu().numpy()
    host = {k: tables[k].cpu() for k in ("wbvh", "wsph_f", "wsph_i",
                                         "wquad_f", "wquad_i")}
    t0 = time.perf_counter()
    rec_w, _, cnt_w = mk.walk_wide_plain(host, *[a.cpu() for a in sub[:7]])
    plain_s = time.perf_counter() - t0
    cnt = counters.cpu().numpy()
    surface = ((rec >> 24) == 1) | ((rec >> 24) == 2)
    res = dict(kernel="hit_kernel", check=f"walk counters, {label}",
               bounce=bounce, lanes=n,
               lanes_counters_differ=int((cnt != cnt_w).any(1).sum()),
               surface_records_differ=int((rec[surface]
                                           != rec_w[surface]).sum()),
               surface_records=int(surface.sum()),
               walk_per_ray=[float(x) for x in cnt.mean(0)], plain_s=plain_s)
    say("kernels", **res)
    if res["lanes_counters_differ"] or res["surface_records_differ"]:
        fail(f"hit_kernel walk ({label}): counters differ from the plain "
             f"walk's in {res['lanes_counters_differ']} lanes, surface "
             f"winners in {res['surface_records_differ']}")
    return res


def phase_hits():
    """B3 against its plain version on final_scene's own frame (800x800,
    with the tree) and cornell_box's (600x600, brute); then its time on the
    main path's first chunk at bounce 0 and at a deep bounce, on the lanes
    sorted (as the wavefront runs it), sorted and cut to the live prefix,
    and unsorted (render_sorted(sort=False)'s lanes): what the sort buys."""
    seed = 7
    scene, camera = texture_scene("final_scene")
    n_pix = camera.image_width * camera.image_height
    cam = camera.constants(device=DEVICE)
    packed, tables = mk._packed_dev(scene, True)
    p = mk.search_params(packed, seed)
    lo, inv = (tuple(float(x) for x in a) for a in wf._scene_bounds(scene))
    with torch.no_grad():
        lanes0 = wf.initial_lanes(cam, seed, n_pix, 0, 1)
        check_hits("final_scene camera rays, 1 spp", tables, p, lanes0,
                   n_pix, 0)
        check_walk_counters("final_scene camera rays", tables, p, lanes0,
                            n_pix, 0)
        lanes1 = wf.sort_lanes(wf.step(scene, lanes0, seed, 0, n_pix, 0),
                               lo, inv)
        check_hits("final_scene sorted lanes of a wavefront chunk", tables,
                   p, lanes1, n_pix, 1)
        check_walk_counters("final_scene sorted bounce-1 lanes", tables, p,
                            lanes1, n_pix, 1)
        del lanes0, lanes1

        cscene, ccam = texture_scene("cornell_box")
        c_packed, c_tables = mk._packed_dev(cscene)
        c_npix = ccam.image_width * ccam.image_height
        check_hits("cornell_box camera rays, 1 spp, brute", c_tables,
                   mk.search_params(c_packed, seed),
                   wf.initial_lanes(ccam.constants(device=DEVICE), seed,
                                    c_npix, 0, 1), c_npix, 0)

        k = wf.chunk_samples(FINAL_SPP, n_pix)
        chunk = wf.initial_lanes(cam, seed, n_pix, 0, k)
        at0, _ = check_hits(f"final_scene first chunk ({k} spp), bounce 0",
                            tables, p, chunk, n_pix, 0, timed=True)
        ordered, unsorted = chunk, chunk
        for b in range(DEEP_BOUNCE):
            if b > 0:
                ordered = wf.sort_lanes(ordered, lo, inv)
            ordered = wf.step(scene, ordered, seed, b, n_pix, 0)
            unsorted = wf.step(scene, unsorted, seed, b, n_pix, 0)
        ordered = wf.sort_lanes(ordered, lo, inv)
        na = int(ordered.alive.sum().item())
        deep, recs = {}, {}
        for name, ln in (("sorted", ordered),
                         ("sorted_live_prefix",
                          wf.Lanes(*[a[:na] for a in ordered])),
                         ("unsorted", unsorted)):
            deep[name], recs[name] = check_hits(
                f"first chunk, bounce {DEEP_BOUNCE}, {name}", tables, p, ln,
                n_pix, DEEP_BOUNCE, compare=False, timed=True)
        # the same lanes in two orders: the same records, lane by lane
        rec_u = recs["unsorted"]
        by_orig = torch.empty_like(rec_u)
        by_orig[ordered.orig.long()] = recs["sorted"]
        differ = int((by_orig[unsorted.orig.long()] != rec_u).sum().item())
    say("kernels", kernel="hit_kernel", check="sorted vs unsorted records",
        bounce=DEEP_BOUNCE, lanes=int(rec_u.numel()), alive=na,
        records_differ=differ,
        sorted_over_unsorted=deep["sorted"]["kernel_ms"]
        / deep["unsorted"]["kernel_ms"])
    if differ:
        fail(f"hit_kernel: sorted and unsorted lanes give {differ} other "
             "records")
    return at0, deep


def phase_crossover():
    """The render kernel's brute loop against its BVH walk at 4 spp on a
    scene below the threshold and on final_scene: the card's own data for
    BVH_KERNEL_THRESHOLD. Both give the same image, bit for bit."""
    out = {}
    for name, width, depth in (("random_balls", 600, 8),
                               ("final_scene", 200, 40)):
        res = {}
        for use_bvh in (False, True):
            _, camera, tables, p = scene_inputs(name, width, CROSS_SPP, depth,
                                                seed=11, use_bvh=use_bvh)
            rgb, n = mk.render_kernel(tables, p)
            res["bvh" if use_bvh else "brute"] = (
                time_ms(lambda: mk.render_kernel(tables, p), 3), rgb, n)
        (b_ms, b_rgb, b_n), (w_ms, w_rgb, w_n) = res["brute"], res["bvh"]
        same = bool(torch.equal(b_rgb, w_rgb) and torch.equal(b_n, w_n))
        out[name] = dict(scene=name, width=camera.image_width,
                         height=camera.image_height, spp=CROSS_SPP,
                         depth=p.max_depth, prims=p.n_spheres + p.n_quads,
                         nodes=p.n_nodes, brute_ms=b_ms, bvh_ms=w_ms,
                         bvh_over_brute=w_ms / b_ms, images_equal=same,
                         rays=int(w_n.sum(dtype=torch.int64).item()))
        say("crossover", **out[name])
        if not same:
            fail(f"crossover {name}: brute and BVH renders differ")
    return out


def capture_render_events(fn):
    """Run ``fn``, returning its result and the ``render`` metrics events
    it emitted (chunks and compactions of the wavefront)."""
    events = []
    emit = metrics.emit
    metrics.emit = lambda ev, **kw: events.append(kw)
    try:
        out = fn()
    finally:
        metrics.emit = emit
    return out, events


def phase_wavefront():
    """render() of final_scene (auto: the sorted wavefront, B3 with B4).
    On 64 px every other route gives the same image bit for bit; then the
    scene's own 800x800 frame at depth 40, FINAL_SPP spp, and the fused
    render (B1+B4+B8) of the same frame."""
    scene, camera = texture_scene("final_scene", width=64, spp=4, depth=8)
    ref, ref_st = rt.render(scene, camera, seed=5, use_megakernel=False)
    ref = ref.astype(np.float32)
    routes = {"render_auto": lambda: rt.render(scene, camera, seed=5),
              "unsorted": lambda: wf.render_sorted(scene, camera, seed=5,
                                                   sort=False),
              "deferred": lambda: renderer.render_deferred(scene, camera,
                                                           seed=5)}
    checks = {}
    for name, fn in routes.items():
        img, st = fn()
        checks[name] = dict(
            pixels_differ=int((img.astype(np.float32) != ref).any(-1).sum()),
            rays=st.rays)
    old = wf.COMPACT_BELOW
    wf.COMPACT_BELOW = 1.01  # cut the dead tail at every segment
    try:
        (img, st), ev = capture_render_events(
            lambda: wf.render_sorted(scene, camera, seed=5, exact=True))
    finally:
        wf.COMPACT_BELOW = old
    checks["compacting"] = dict(
        pixels_differ=int((img.astype(np.float32) != ref).any(-1).sum()),
        rays=st.rays, compactions=ev[-1]["compactions"])
    say("wavefront_path", check="equals_tensor_integrator", scene=
        "final_scene", width=64, spp=4, depth=8, rays_tensor=ref_st.rays,
        routes=checks)
    for name, r in checks.items():
        if r["pixels_differ"] or r["rays"] != ref_st.rays:
            fail(f"final_scene 64 px: {name} differs from the tensor "
                 f"integrator in {r['pixels_differ']} pixels (rays "
                 f"{r['rays']} vs {ref_st.rays})")

    scene, camera = texture_scene("final_scene", spp=FINAL_SPP)
    torch.cuda.reset_peak_memory_stats()
    (img, stats, launches), ev = capture_render_events(
        lambda: timed_render(scene, camera))
    peak = torch.cuda.max_memory_allocated()
    res = dict(scene="final_scene", width=camera.image_width,
               height=camera.image_height, spp=FINAL_SPP,
               depth=camera.max_depth, path=ev[-1]["path"],
               seconds=stats.seconds, rays=stats.rays,
               mrays_per_s=stats.rays_per_sec / 1e6,
               chunks=ev[-1]["chunks"], compactions=ev[-1]["compactions"],
               launches=launches, peak_mem_gb=peak / 1e9,
               finite=bool(np.isfinite(img).all()), gamma_mean=gamma_mean(img))
    if img.shape != (800, 800, 3) or not res["finite"]:
        fail(f"final_scene image {img.shape} not finite 800x800x3")
    if res["path"] != "wavefront_sorted" or launches["hit_kernel"] < 1:
        fail("final_scene render() did not run the wavefront's hit kernel")
    fused, f_stats, f_launches = timed_render(scene, camera,
                                              use_megakernel=True)
    # the fused render's bound from its own walk (one more launch with the
    # counters, after the timed one) and its shaded noise and image bounces
    packed, tables = mk._packed_dev(scene, True)
    p = mk.make_params(camera, packed, 0, FINAL_SPP, camera.max_depth)
    counters = torch.zeros((p.pixel_count, 3), dtype=torch.int32,
                           device=DEVICE)
    rgb_w, n_w = mk.render_kernel(tables, p, counters)
    walk = walk_counts(counters)
    fused_kernel_ms = time_ms(lambda: mk.render_kernel(tables, p), 3)
    shades = texture_shades(tables, p)
    f_bound, f_by = bound_ms(tables, p, f_stats.rays, shades=shades,
                             walk=walk)
    # the full-frame gate: the brute loop's render of the same frame
    b_packed, b_tables = mk._packed_dev(scene, False)
    p_b = mk.make_params(camera, b_packed, 0, FINAL_SPP, camera.max_depth)
    (rgb_b, n_b), brute_ms = once_ms(lambda: mk.render_kernel(b_tables, p_b))
    gate = dict(
        pixels_differ=int((rgb_w != rgb_b).any(-1).sum().item()),
        ray_counts_differ=int((n_w != n_b).sum().item()),
        render_image_differs=int(
            (rgb_w.reshape(fused.shape).cpu().numpy() != fused).any(-1)
            .sum()),
        brute_ms=brute_ms, spp=FINAL_SPP)
    res.update(fused_seconds=f_stats.seconds, fused_rays=f_stats.rays,
               fused_kernel_ms=fused_kernel_ms,
               fused_walk=walk, fused_walk_per_ray=[w / f_stats.rays
                                                    for w in walk],
               fused_shades=shades, fused_bound_ms=f_bound,
               fused_bound_by=f_by,
               fused_vs_brute=gate,
               fused_occupancy=occupancy(p, mk.render_plan(tables, p)),
               fused_roofline_share=f_bound / (f_stats.seconds * 1e3),
               fused_mrays_per_s=f_stats.rays_per_sec / 1e6,
               fused_launches=f_launches, fused_gamma_mean=gamma_mean(fused),
               gamma_mean_ratio=res["gamma_mean"] / gamma_mean(fused),
               ratio_tol=GAMMA_RATIO_TOL)
    say("wavefront_path", **res)
    if f_launches["render_kernel"] < 1 or not np.isfinite(fused).all():
        fail("the fused final_scene render did not launch render_kernel")
    if any(gate[k] for k in ("pixels_differ", "ray_counts_differ",
                             "render_image_differs")):
        fail(f"fused final_scene: the walk's frame differs from the brute "
             f"loop's in {gate['pixels_differ']} pixels and "
             f"{gate['ray_counts_differ']} ray counts (render() image: "
             f"{gate['render_image_differs']} pixels)")
    if abs(res["gamma_mean_ratio"] - 1.0) > GAMMA_RATIO_TOL:
        fail(f"final_scene gamma mean {res['gamma_mean']} vs the fused "
             f"render's {res['fused_gamma_mean']}")
    if OUT_DIR:
        os.makedirs(OUT_DIR, exist_ok=True)
        write_png(os.path.join(OUT_DIR, "final_scene.png"), img)
    profile_wavefront(scene, camera, res["seconds"] / res["chunks"])
    return res


def profile_wavefront(scene, camera, chunk_s):
    """Device time by kernel of one chunk of the final_scene frame through
    the wavefront (torch.profiler), and the device's busy share of that
    chunk's wall time (one stream: the kernels' summed time is the busy
    time). ``chunk_s``: an unprofiled chunk's seconds, for the overhead."""
    from torch.profiler import ProfilerActivity, profile

    k = wf.chunk_samples(FINAL_SPP, camera.image_width * camera.image_height)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wf.render_sorted(scene, camera, spp=k)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_name = {}
    for name, us in _kernel_events(prof):
        t, c = by_name.get(name, (0.0, 0))
        by_name[name] = (t + us / 1e3, c + 1)
    total = sum(t for t, _ in by_name.values())
    groups = {g: 0.0 for g in ("hit_kernel", "perlin_kernel", "gather",
                               "sort", "other")}
    for name, (t, _) in by_name.items():
        low = name.lower()
        g = ("hit_kernel" if "hit_kernel" in name else
             "perlin_kernel" if "perlin_kernel" in name else
             "gather" if "gather" in low else
             "sort" if "sort" in low or "radix" in low else "other")
        groups[g] += t
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    say("profile", scene="final_scene", path="wavefront_sorted", spp=k,
        chunk_s_unprofiled=chunk_s, wall_s_profiled=wall,
        device_ms_total=total, device_busy_share=total / (wall * 1e3),
        device_busy_share_unprofiled=total / (chunk_s * 1e3),
        device_ms_by_group=groups, kernel_launches=sum(
            c for _, c in by_name.values()),
        top=[dict(kernel=n[:100], ms=t, count=c) for n, (t, c) in top])


def phase_grad_final():
    """loss_and_grad of final_scene (mean loss): records from B2 walking
    the BVH, replay with B5/B6/B7; the loss equals the deferred render's
    image mean."""
    scene, camera = texture_scene("final_scene", width=200, spp=4, depth=8)
    img, _ = renderer.render_deferred(scene, camera, seed=6)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, g, rays = tg.loss_and_grad(scene, camera, lambda im, p: im.mean(),
                                     seed=6, with_rays=True,
                                     linear_loss=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    ref = float(img.astype(np.float64).mean())
    rel = abs(float(loss) - ref) / abs(ref)
    finite = {f.name: bool(torch.isfinite(getattr(g, f.name)).all())
              for f in dataclasses.fields(g)
              if isinstance(getattr(g, f.name), torch.Tensor)
              and getattr(g, f.name).is_floating_point()}
    res = dict(scene="final_scene", width=200, height=200, spp=4, depth=8,
               loss=float(loss), deferred_image_mean=ref, loss_rel_err=rel,
               rays=rays, seconds=secs, fwdbwd_rays_per_s=rays / secs,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=launches, all_finite=all(finite.values()),
               sph_center_grad_absmax=float(g.sph_center.abs().max()))
    res["routes"] = route_ab(lambda: tg.loss_and_grad(
        scene, camera, lambda im, p: im.mean(), seed=6, linear_loss=True))
    say("grad_final", **res)
    # the match kernel against its plain version at the shape of this
    # gradient's match calls that took the most device time (the census)
    rows = [r for r in res["routes"]["use_segment_sum"]["census"]["rows"]
            if r["route"] == "match"]
    if rows:
        r = max(rows, key=lambda r: r["device_ms"])
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(8)
        K, n, R = r["columns"], r["rows"], r["indices"]
        idx = torch.randint(0, n, (R,), device=DEVICE, dtype=torch.int32,
                            generator=gen)
        res["match_check"] = check_reduction(
            "grad_final's match shape, random index",
            torch.randn(K, R, device=DEVICE, generator=gen), idx, n,
            torch.randint(-8, 9, (K, R), device=DEVICE,
                          generator=gen).to(torch.float32), form="match")
    if not rel <= LOSS_RTOL:
        fail(f"final_scene: loss {float(loss)} vs deferred mean {ref}")
    if not res["all_finite"]:
        fail(f"final_scene: non-finite gradient leaves: {finite}")
    if launches["record_kernel"] < 1:
        fail("grad_final did not launch record_kernel")
    if launches["scatter_match_kernel"] < 1 or not rows:
        fail("grad_final did not launch scatter_match_kernel")
    return res


def _rows_2048(n, K, elem):
    """A rule by rows alone, set at the 3-column crossover: the segment sum
    past 2048 rows, whatever the columns and dtype."""
    return n > 2048


def route_ab(run, pairs=ROUTE_PAIRS):
    """``run()`` with the reductions routed by lanegather.use_segment_sum
    and by rows alone (_rows_2048): host seconds of ``pairs`` pairs of
    runs, each pair in the other order than the one before, and their
    medians; then one profiled run of each (censused_profile): the device
    ms of the reductions' kernels and of all its device work, the launches
    of each form and the reductions' census."""
    rules = {"use_segment_sum": lg.use_segment_sum, "rows_2048": _rows_2048}
    out = {name: dict(seconds=[]) for name in rules}
    try:
        for i in range(pairs):
            order = list(rules) if i % 2 == 0 else list(rules)[::-1]
            for name in order:
                lg.use_segment_sum = rules[name]
                _, ms = once_ms(run)
                out[name]["seconds"].append(ms / 1e3)
        for name in rules:
            out[name]["median_seconds"] = float(np.median(
                out[name]["seconds"]))
        for name, rule in rules.items():
            lg.use_segment_sum = rule

            def counted():
                reset_launches()
                return run()
            _, prof, out[name]["census"] = censused_profile(counted)
            ev = _kernel_events(prof)
            out[name].update(
                device_ms=sum(us for _, us in ev) / 1e3,
                reduction_device_ms=sum(
                    us for k, us in ev if any(
                        a in k for a in ("scatter_sum", "scatter_match",
                                         "radix_", "segment_"))) / 1e3,
                perlin_backward_device_ms=sum(
                    us for k, us in ev if "perlin_backward" in k) / 1e3,
                launches={k: kernels.LAUNCHES[k] for k in (
                    "scatter_sum_kernel", "scatter_match_kernel",
                    "radix_sort_kernel", "segment_sum_kernel")})
    finally:
        lg.use_segment_sum = rules["use_segment_sum"]
    return out


def phase_exact():
    # background-only scene equals the background
    b = rt.SceneBuilder(background=(0.2, 0.4, 0.8))
    scene = rt.compile_scene(b, device=DEVICE)
    cam = rt.Camera.create(rt.RenderSettings(
        image_width=32, aspect_ratio=2.0, samples_per_pixel=2, max_depth=3,
        background=(0.2, 0.4, 0.8)))
    img = mk.render_fast(scene, cam)
    np.testing.assert_allclose(
        img, np.broadcast_to([0.2, 0.4, 0.8], img.shape), rtol=1e-6)
    # an emitter quad in front of the camera: its colour at the centre pixel,
    # black at the corner
    b = rt.SceneBuilder(background=(0, 0, 0))
    b.add_quad((-1, -1, 2), (2, 0, 0), (0, 2, 0), b.diffuse_light((3, 2, 1)))
    scene = rt.compile_scene(b, device=DEVICE)
    cam = rt.Camera.create(rt.RenderSettings(
        image_width=32, aspect_ratio=1.0, samples_per_pixel=2, max_depth=2,
        vfov=60.0, look_from=(0, 0, 0), look_at=(0, 0, 2)))
    img = mk.render_fast(scene, cam)
    np.testing.assert_allclose(img[16, 16], [3, 2, 1], rtol=1e-6)
    np.testing.assert_allclose(img[0, 0], 0, atol=1e-7)
    say("exact", background="ok", emitter="ok")


def gamma_mean(img):
    g = np.clip(np.clip(img, 0, None) ** (1 / 2.2), 0, 0.999)
    return float(g.mean())


def phase_main_path(at_main):
    """render() through the package's normal entry point."""
    b, settings = builders.cornell_box()
    est_s = at_main["kernel_ms"] / 1e3 / at_main["spp"] \
        * settings.samples_per_pixel
    spp = settings.samples_per_pixel
    while est_s * spp / settings.samples_per_pixel > MAIN_SPP_TIME_BUDGET_S \
            and spp > 512:
        spp //= 2  # cut spp, never the 600x600 frame or the depth
    settings = dataclasses.replace(settings, samples_per_pixel=spp)
    scene = rt.compile_scene(b, device=DEVICE)
    camera = rt.Camera.create(settings)
    reset_launches()
    torch.cuda.synchronize()
    img, stats = rt.render(scene, camera)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if launches["render_kernel"] < 1:
        fail("main path did not launch render_kernel")
    if img.shape != (600, 600, 3) or not np.isfinite(img).all():
        fail(f"main path image {img.shape} not finite 600x600x3")
    gmean = gamma_mean(img)
    packed, tables = mk._packed_dev(scene)
    p_main = mk.make_params(camera, packed, 0, spp, camera.max_depth)
    main_bound, main_by = bound_ms(tables, p_main, stats.rays)
    occ = occupancy(p_main, mk.render_plan(tables, p_main))
    say("main_path", scene="cornell_box", width=600, height=600, spp=spp,
        spp_of_scene=builders.cornell_box()[1].samples_per_pixel,
        depth=camera.max_depth, seconds=stats.seconds, rays=stats.rays,
        mrays_per_s=stats.rays_per_sec / 1e6, gamma_mean=gmean,
        launches=launches, bound_ms=main_bound, bound_by=main_by,
        roofline_share=main_bound / (stats.seconds * 1e3), occupancy=occ)
    if not 0.24 <= gmean <= 0.27:
        fail(f"cornell gamma mean {gmean} outside 0.24-0.27")
    if OUT_DIR:
        os.makedirs(OUT_DIR, exist_ok=True)
        write_png(os.path.join(OUT_DIR, "cornell_main.png"), img)
    return dict(seconds=stats.seconds, spp=spp, bound=main_bound,
                launches=launches["render_kernel"], occupancy=occ)


def texture_scene(name, width=None, spp=None, depth=None):
    b, settings = getattr(builders, name)()
    over = {k: v for k, v in (("image_width", width),
                              ("samples_per_pixel", spp),
                              ("max_depth", depth)) if v is not None}
    settings = dataclasses.replace(settings, **over)
    return rt.compile_scene(b, device=DEVICE), rt.Camera.create(settings)


def timed_render(scene, camera, **kw):
    """render() with every launch count set to 0 just before and read just
    after; the host clock around it ends in the image's copy to the host."""
    reset_launches()
    torch.cuda.synchronize()
    img, stats = rt.render(scene, camera, **kw)
    torch.cuda.synchronize()
    return img, stats, dict(kernels.LAUNCHES)


def phase_deferred_path(fused_images):
    """Deferred shading through render()'s auto policy at each scene's own
    settings; correctness gates on the card. ``fused_images`` holds fused
    renders of these frames already made (by name)."""
    # (a) deferred == the tensor integrator on a small frame of each scene
    exact = {}
    for name in TEXTURE_SCENES:
        scene, camera = texture_scene(name, width=64, spp=8, depth=8)
        img_d, st_d = rt.render(scene, camera, seed=5)
        img_t, st_t = rt.render(scene, camera, seed=5, use_megakernel=False)
        exact[name] = dict(
            pixels_differ=int((img_d.astype(np.float32)
                               != img_t.astype(np.float32)).any(-1).sum()),
            rays=st_d.rays, rays_tensor=st_t.rays)
    say("deferred_path", check="deferred_equals_tensor_integrator",
        width=64, spp=8, depth=8, scenes=exact)
    for name, r in exact.items():
        if r["pixels_differ"] or r["rays"] != r["rays_tensor"]:
            fail(f"{name}: deferred render differs from the tensor "
                 f"integrator in {r['pixels_differ']} pixels")

    out = {}
    for name in TEXTURE_SCENES:
        scene, camera = texture_scene(name)
        img, stats, launches = timed_render(scene, camera)
        n_pix = camera.image_width * camera.image_height
        fused = fused_images.get(name)
        if fused is None:
            fused, _ = rt.render(scene, camera, use_megakernel=True)
        g, gf = gamma_mean(img), gamma_mean(fused)
        tol = NOISE_MEAN_TOL if scene.has_noise else IMAGE_MEAN_TOL
        res = dict(
            scene=name, width=camera.image_width,
            height=camera.image_height, spp=camera.samples_per_pixel,
            depth=camera.max_depth, seconds=stats.seconds, rays=stats.rays,
            mrays_per_s=stats.rays_per_sec / 1e6, launches=launches,
            record_slices=launches["record_kernel"],
            spp_per_slice=tg.RECORD_BUDGET_ENTRIES // (camera.max_depth
                                                      * n_pix),
            finite=bool(np.isfinite(img).all()), gamma_mean=g,
            fused_gamma_mean=gf, gamma_mean_ratio=g / gf,
            mean_ratio=float(img.mean() / fused.mean()), ratio_tol=tol)
        say("deferred_path", **res)
        if img.shape != (camera.image_height, camera.image_width, 3) \
                or not res["finite"]:
            fail(f"{name}: deferred image {img.shape} not finite")
        if launches["record_kernel"] < 1:
            fail(f"{name}: deferred render did not launch record_kernel")
        if scene.has_noise and launches["perlin_kernel"] < 1:
            fail(f"{name}: deferred render did not launch perlin_kernel")
        if scene.has_image and launches["gather_cols_kernel"] < 1:
            fail(f"{name}: deferred render did not gather image texels")
        if abs(g / gf - 1.0) > tol:
            fail(f"{name}: gamma mean {g} vs fused render's {gf} "
                 f"(ratio tolerance {tol})")
        out[name] = res
    return out


def phase_fused_textures():
    """render(use_megakernel=True) of simple_light at its own settings: one
    launch of the render kernel's noise instantiation (B8)."""
    scene, camera = texture_scene("simple_light")
    img, stats, launches = timed_render(scene, camera, use_megakernel=True)
    packed, tables = mk._packed_dev(scene)
    p = mk.make_params(camera, packed, 0, camera.samples_per_pixel,
                       camera.max_depth)
    shades = texture_shades(tables, p)
    b_ms, b_by = bound_ms(tables, p, stats.rays, shades=shades)
    res = dict(scene="simple_light", width=camera.image_width,
               height=camera.image_height, spp=camera.samples_per_pixel,
               depth=camera.max_depth, seconds=stats.seconds,
               rays=stats.rays, mrays_per_s=stats.rays_per_sec / 1e6,
               gamma_mean=gamma_mean(img), launches=launches,
               noise_shades=shades[0], bound_ms=b_ms, bound_by=b_by,
               roofline_share=b_ms / (stats.seconds * 1e3))
    say("fused_textures", **res)
    if launches["render_kernel"] < 1:
        fail("fused_textures did not launch render_kernel")
    if not np.isfinite(img).all():
        fail("fused_textures image not finite")
    return res, img


def phase_grad_textures():
    """loss_and_grad of the noise and image scenes (mean loss, linear),
    w.r.t. every float leaf; then the reduction at the image's size."""
    out = {}
    for name, leaf in (("two_perlin_spheres", "perlin_ranvec"),
                       ("earth", "image")):
        scene, camera = texture_scene(name, width=GRAD_TEX_WIDTH,
                                      spp=GRAD_TEX_SPP, depth=GRAD_DEPTH)
        img, _ = rt.render(scene, camera, seed=6)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, g, rays = tg.loss_and_grad(scene, camera,
                                         lambda im, p: im.mean(), seed=6,
                                         with_rays=True, linear_loss=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        ref = float(img.astype(np.float64).mean())
        rel = abs(float(loss) - ref) / abs(ref)
        grads = {f.name: getattr(g, f.name) for f in dataclasses.fields(g)
                 if isinstance(getattr(g, f.name), torch.Tensor)
                 and getattr(g, f.name).is_floating_point()}
        finite = {k: bool(torch.isfinite(t).all()) for k, t in grads.items()}
        res = dict(scene=name, width=camera.image_width,
                   height=camera.image_height, spp=GRAD_TEX_SPP,
                   depth=GRAD_DEPTH, loss=float(loss),
                   deferred_image_mean=ref, loss_rel_err=rel, rays=rays,
                   seconds=secs, fwdbwd_rays_per_s=rays / secs,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   launches=launches, leaf=leaf,
                   leaf_grad_absmax=float(grads[leaf].abs().max()),
                   all_finite=all(finite.values()))
        if name == "two_perlin_spheres":
            # the backward's device time in one more run, by the profiler
            _, prof, _ = censused_profile(lambda: tg.loss_and_grad(
                scene, camera, lambda im, p: im.mean(), seed=6,
                linear_loss=True))
            ev = [us for k, us in _kernel_events(prof)
                  if "perlin_backward" in k]
            res.update(perlin_backward_device_ms=sum(ev) / 1e3,
                       perlin_backward_events=len(ev))
        say("grad_textures", **res)
        if not rel <= LOSS_RTOL:
            fail(f"{name}: loss {float(loss)} vs deferred image mean {ref}")
        if not all(finite.values()):
            fail(f"{name}: non-finite gradient leaves: {finite}")
        if not res["leaf_grad_absmax"] > 0:
            fail(f"{name}: the {leaf} gradient is zero")
        if name == "two_perlin_spheres" and (
                launches["perlin_kernel"] < 1
                or launches["perlin_backward_kernel"] < 1):
            fail("grad_textures did not launch perlin_kernel and "
                 "perlin_backward_kernel")
        if name == "earth" and (launches["segment_sum_kernel"] < 1
                                or launches["radix_sort_kernel"] < 1):
            fail("grad_textures did not reduce the image gradient through "
                 "radix_sort_kernel and segment_sum_kernel")
        out[name] = res

    return out


def headline(scene, camera, seed, loss_fn, linear):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, g, rays = tg.loss_and_grad(scene, camera, loss_fn, seed=seed,
                                     spp=GRAD_SPP, max_depth=GRAD_DEPTH,
                                     with_rays=True, linear_loss=linear)
    torch.cuda.synchronize()
    return loss, g, rays, time.perf_counter() - t0


def phase_grad_path():
    """The headline gradient workload through loss_and_grad."""
    b, settings = builders.cornell_box()
    scene = rt.compile_scene(b, device=DEVICE)
    camera = rt.Camera.create(settings)

    def mean_loss(im, p):
        return im.mean()

    # first call: builds nothing, but pays PyTorch's first-use costs
    _, _, _, warm_s = headline(scene, camera, 0, mean_loss, True)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    loss, g, rays, secs = headline(scene, camera, 1, mean_loss, True)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    _, _, rays2, secs2 = headline(scene, camera, 2, mean_loss, True)

    img = mk.render_fast(scene, camera, seed=1, spp=GRAD_SPP,
                         max_depth=GRAD_DEPTH)
    b1_mean = float(img.astype(np.float64).mean())
    rel = abs(float(loss) - b1_mean) / abs(b1_mean)
    leaves = {f: getattr(g, f) for f in ("sph_center", "sph_radius",
                                         "sph_cvec", "quad_q", "quad_u",
                                         "quad_v", "mat_albedo", "mat_fuzz",
                                         "mat_ir", "tex_rgb", "background",
                                         "med_neg_inv_density")}
    finite = {f: bool(torch.isfinite(t).all()) for f, t in leaves.items()}
    tex = g.tex_rgb
    res = dict(scene="cornell_box", width=600, height=600, spp=GRAD_SPP,
               depth=GRAD_DEPTH, loss=float(loss), b1_image_mean=b1_mean,
               loss_rel_err=rel, rays=rays, seconds=secs,
               fwdbwd_rays_per_s=rays / secs, seconds_rep2=secs2,
               rays_rep2=rays2,
               fwdbwd_rays_per_s_rep2=rays2 / secs2, first_call_s=warm_s,
               peak_mem_gb=peak / 1e9, launches=launches,
               tex_rgb_grad=tex.tolist(),
               geometry_grad_absmax={f: float(leaves[f].abs().max())
                                     for f in ("quad_q", "quad_u", "quad_v")})
    say("grad_path", **res)
    if launches["record_kernel"] != 9:
        fail(f"grad_path launched record_kernel {launches['record_kernel']} "
             "times, expected 9 sample slices")
    for k in ("gather_kernel", "gather_cols_kernel", "scatter_sum_kernel"):
        if launches[k] < 1:
            fail(f"grad_path did not launch {k}")
    if not rel <= LOSS_RTOL:
        fail(f"loss {float(loss)} vs render kernel image mean {b1_mean}")
    if not all(finite.values()):
        fail(f"non-finite gradient leaves: {finite}")
    if not (tex.abs().max() > 0 and tex[3].abs().max() > 0):
        fail("tex_rgb gradient (or the light's emission row) is zero")

    # the L2 loss of bench.py: a nonlinear loss takes the render kernel's
    # forward for its cotangent (pass 1) before the sliced backward
    l2 = tg.l2_to_target(torch.from_numpy(img.reshape(-1, 3)).to(DEVICE))
    reset_launches()
    l2_loss, g2, rays_l2, secs_l2 = headline(scene, camera, 3, l2, False)
    say("grad_path", loss_kind="l2_to_target", loss=float(l2_loss),
        rays=rays_l2, seconds=secs_l2, fwdbwd_rays_per_s=rays_l2 / secs_l2,
        launches=dict(kernels.LAUNCHES))
    if not (np.isfinite(float(l2_loss))
            and bool(torch.isfinite(g2.tex_rgb).all())):
        fail("L2 loss or its gradient is not finite")
    if kernels.LAUNCHES["render_kernel"] < 1:
        fail("the L2 loss did not take the render kernel's forward")
    return res, scene, camera


# The reductions' device kernels, by route: the tile kernel's two, the
# match kernel's two, the segment sum's radix passes (three kernels each)
# and its two.
TILE_KERNELS = ("scatter_sum_partial", "scatter_sum_final")
MATCH_KERNELS = ("scatter_match_partial", "scatter_match_final")
RADIX_KERNELS = ("radix_hist_kernel", "radix_scan_kernel",
                 "radix_scatter_kernel")
SEGMENT_KERNELS = ("segment_sum_kernel", "segment_carry_kernel")


def reduction_census(calls, prof):
    """The reduction calls of a profiled run (``recorded_reductions``) by
    (route, K, n, R, dtype): count and device ms, each call's kernels taken
    from the profile's device events in launch order (all work runs on one
    stream, so the i-th scatter_sum_partial is the i-th tile call's).
    ``matched`` is false when the profile lacks a call's kernel."""
    from torch.autograd import DeviceType

    queues = {k: [] for k in (TILE_KERNELS + MATCH_KERNELS + RADIX_KERNELS
                              + SEGMENT_KERNELS)}
    for _, name, us in sorted(
            (e.time_range.start, _kernel_name(e.name), e.time_range.elapsed_us())
            for e in prof.events() if e.device_type == DeviceType.CUDA):
        if name in queues:
            queues[name].append(us)
    rows, matched = {}, True
    for route, K, n, R, dt in calls:
        names = {"tile": TILE_KERNELS, "match": MATCH_KERNELS}.get(route) or (
            RADIX_KERNELS * len(lg.radix_digits(n)) + SEGMENT_KERNELS)
        ms = 0.0
        for k in names:
            matched &= bool(queues[k])
            ms += queues[k].pop(0) / 1e3 if queues[k] else 0.0
        key = (route, K, n, R, dt)
        c, t = rows.get(key, (0, 0.0))
        rows[key] = (c + 1, t + ms)
    return dict(
        calls=len(calls), device_ms=sum(t for _, t in rows.values()),
        matched=matched,
        unmatched_events={k: len(v) for k, v in queues.items() if v},
        rows=[dict(route=r, columns=K, rows=n, indices=R, dtype=dt, calls=c,
                   device_ms=t)
              for (r, K, n, R, dt), (c, t) in sorted(
                  rows.items(), key=lambda kv: -kv[1][1])])


def censused_profile(run):
    """``run()`` once under torch.profiler with its reduction calls recorded:
    (its result, the profile, the census). A census whose calls lost a
    kernel event, or whose profile holds reduction kernels no call claims,
    would read low: the profile is taken again, after a longer settle, up to
    PROFILE_TRIES times; then the run fails."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(PROFILE_TRIES):
        with recorded_reductions() as calls, profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_SETTLE_S * 10 ** attempt)
            out = run()
            torch.cuda.synchronize()
        census = reduction_census(calls, prof)
        PROFILES["taken"] += 1
        if census["matched"] and not census["unmatched_events"]:
            return out, prof, census
        PROFILES["dropped"] += 1
        say("profile_dropped", census_calls=census["calls"],
            matched=census["matched"],
            unmatched_events=census["unmatched_events"])
    fail(f"the profiler lost reduction kernels in {PROFILE_TRIES} censused "
         "profiles running")


def phase_profile(scene, camera, run_s):
    """Device time by kernel over one grad_path run, and the device's busy
    share of that run's wall time (kernels run one at a time on the one
    stream, so their summed time is the busy time), and its reductions'
    census (censused_profile). Then the stages of an unprofiled run of
    ``run_s`` seconds."""
    (_, _, rays, wall_s), prof, census = censused_profile(
        lambda: headline(scene, camera, 4, lambda im, p: im.mean(), True))
    say("census", scene="cornell_box", width=600, height=600, spp=GRAD_SPP,
        depth=GRAD_DEPTH, **census)
    if not any(r["route"] == "tile" for r in census["rows"]):
        fail("the cornell gradient launched no scatter_sum kernel")
    by_name = {}
    for name, us in _kernel_events(prof):
        t, c = by_name.get(name, (0.0, 0))
        by_name[name] = (t + us / 1e3, c + 1)
    total = sum(t for t, _ in by_name.values())
    ours = {k: 0.0 for k in ("record_kernel", "gather_kernel",
                             "gather_cols_kernel", "scatter_sum")}
    for name, (t, _) in by_name.items():
        for k in ours:
            if k in name:
                ours[k] += t
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]

    # the same slices by stage on the host clock: records (B2) alone, and
    # the replay forward alone (no graph); the rest of a run is the
    # backward, with its checkpoint recompute of the forward
    pid = torch.arange(camera.image_width * camera.image_height,
                       dtype=torch.int32, device=DEVICE)
    cam_c = camera.constants(device=DEVICE)
    k_max = tg.RECORD_BUDGET_ENTRIES // (GRAD_DEPTH * pid.numel())
    rec_ms = fwd_ms = 0.0
    for c0 in range(0, GRAD_SPP, k_max):
        k = min(k_max, GRAD_SPP - c0)
        recs, ms = once_ms(lambda: tg.get_records(
            scene, camera, 4, k, GRAD_DEPTH, pixel_ids=pid, sample_offset=c0))
        rec_ms += ms
        with torch.no_grad():
            _, ms = once_ms(lambda: tg.radiance_mean_replay_rays(
                scene, cam_c, pid, 4, recs, k, GRAD_DEPTH, sample_base=c0))
        fwd_ms += ms
        del recs
    say("profile", wall_s_profiled=wall_s, rays=rays,
        device_ms_total=total, device_busy_share=total / (wall_s * 1e3),
        ours_ms=ours, other_ms=total - sum(ours.values()),
        stages_ms=dict(records=rec_ms, replay_forward=fwd_ms,
                       backward_with_recompute=run_s * 1e3 - rec_ms - fwd_ms),
        top=[dict(kernel=k[:100], ms=t, count=c) for k, (t, c) in top])
    return census


def phase_train():
    b, settings = builders.cornell_box()
    settings = dataclasses.replace(settings, samples_per_pixel=16)
    scene = rt.compile_scene(b, device=DEVICE)
    camera = rt.Camera.create(settings)
    target = mk.render_fast(scene, camera, seed=0, spp=16, max_depth=8)
    wrong = scene.tex_rgb.clone()
    true_red = wrong[0].clone()
    wrong[0] = torch.tensor([0.3, 0.3, 0.3], device=DEVICE)
    t0 = time.perf_counter()
    fitted, losses = tg.fit_scene(scene.replace(tex_rgb=wrong), camera,
                                  target, steps=3,
                                  learning_rates={"tex_rgb": TRAIN_LR},
                                  spp=16, max_depth=8, resample=False)
    torch.cuda.synchronize()
    say("train", scene="cornell_box", width=600, height=600, spp=16,
        depth=8, lr=TRAIN_LR, losses=losses,
        seconds=time.perf_counter() - t0,
        red_wall_start=[0.3, 0.3, 0.3], red_wall_end=fitted.tex_rgb[0]
        .tolist(), red_wall_true=true_red.tolist())
    if not losses[2] < losses[0]:
        fail(f"train: loss did not fall: {losses}")


def phase_grad_check():
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(buf):
        rc = cli.main(["-s", "6", "--width", "64", "--grad-check",
                       "-o", os.path.join(tmp, "gc")])
    text = buf.getvalue()
    lines = [ln for ln in text.splitlines() if ln.startswith("grad-check")]
    say("grad_check", rc=rc, lines=lines)
    if rc != 0 or "grad-check: OK" not in text:
        fail("cli --grad-check did not pass on the card")


# ----------------------------------------------------------- distributed
def cornell(width, spp, device=DEVICE):
    b, settings = builders.cornell_box()
    settings = dataclasses.replace(settings, image_width=width,
                                   samples_per_pixel=spp)
    return rt.compile_scene(b, device=device), rt.Camera.create(settings)


def float_leaves(g):
    return {k: v for k, v in grad_to_numpy(g).items()
            if np.issubdtype(v.dtype, np.floating)}


def rank_world1(device, spp):
    """(a) NCCL, world size 1 (a 1x1 mesh, the card to itself):
    render_distributed of the main path's frame, its metrics line, and the
    sharded route's B1 against its plain version at DIST_B1_SPP."""
    scene, camera = cornell(600, spp, device)
    mesh = make_mesh(device=device)
    with tempfile.TemporaryDirectory() as tmp:
        mpath = os.path.join(tmp, "metrics.jsonl")
        metrics.enable(mpath)
        render_dist.render_distributed(scene, camera, mesh, seed=2, spp=16)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = render_dist.render_distributed(scene, camera, mesh)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        with open(mpath) as f:
            events = [json.loads(ln) for ln in f]
    ev = [e for e in events if e["event"] == "render_distributed"][-1]
    ref, ref_rays = mk.render_fast(scene, camera, with_stats=True)
    packed, tables = mk._packed_dev(scene)
    p = mk.make_params(camera, packed, 0, spp, camera.max_depth)
    b_ms, b_by = bound_ms(tables, p, ev["rays"])

    # the route's kernel on this rank's share (the whole frame on 1x1)
    p16 = mk.make_params(camera, packed, 11, DIST_B1_SPP, camera.max_depth)
    img16, rays16 = mk.render_fast_sharded(scene, camera, mesh, seed=11,
                                           spp=DIST_B1_SPP, with_stats=True)
    ms16 = time_ms(lambda: mk.render_fast_sharded(
        scene, camera, mesh, seed=11, spp=DIST_B1_SPP), 3)
    (rgb_p, n_p), plain_ms = once_ms(lambda: mk.render_fast_plain(tables,
                                                                  p16))
    rgb_p = rgb_p.reshape(img16.shape).cpu().numpy()
    b16, b16_by = bound_ms(tables, p16, rays16)
    return dict(
        seconds=secs, spp=spp, pixels=camera.image_width * camera.image_height,
        rays=ev["rays"], metrics_path=ev["path"],
        metrics_mesh=ev["mesh"], launches=launches,
        bitwise_equal=bool(np.array_equal(img, ref.astype(np.float64))),
        rays_equal=ev["rays"] == ref_rays, bound_ms=b_ms, bound_by=b_by,
        b1=dict(spp=DIST_B1_SPP, ms=ms16, plain_ms=plain_ms, rays=rays16,
                rays_plain=int(n_p.sum(dtype=torch.int64).item()),
                max_abs_err=float(np.abs(img16 - rgb_p).max()),
                pixels_bitwise_equal=int((img16 == rgb_p).all(-1).sum()),
                bound_ms=b16, bound_by=b16_by))


def rank_two(device, cut_spp, target):
    """(b) and (d): two ranks under gloo on one shared card, mesh 2x1."""
    mesh = make_mesh(device=device)
    scene, camera = cornell(600, cut_spp, device)
    reset_launches()
    img, rays = mk.render_fast_sharded(scene, camera, mesh, with_stats=True)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)

    # this rank's B1 against its plain version over the same range, 64 px
    s64, c64 = cornell(64, 16, device)
    packed, tables = mk._packed_dev(s64)
    base, count = shard_range(c64.image_width * c64.image_height, mesh)
    p = mk.make_params(c64, packed, 11, 16, c64.max_depth, 0, base, count)
    rgb_k, n_k = mk.render_kernel(tables, p)
    rgb_p, n_p = mk.render_fast_plain(tables, p)
    b1 = dict(pixel_base=base, pixel_count=count,
              max_abs_err=float((rgb_k - rgb_p).abs().max().item()),
              pixels_bitwise_equal=int((rgb_k == rgb_p).all(-1).sum()
                                       .item()),
              ray_counts_differ=int((n_k != n_p).sum().item()))

    # (d) the distributed record/replay gradient, after a small warm-up
    gscene, gcam = cornell(600, GRAD_SPP, device)
    grad_dist.replay_loss_and_grad(gscene, gcam, mesh, target, seed=1,
                                   spp=2, max_depth=GRAD_DEPTH)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, g, grays = grad_dist.replay_loss_and_grad(
        gscene, gcam, mesh, target, seed=1, spp=GRAD_SPP,
        max_depth=GRAD_DEPTH)
    torch.cuda.synchronize()
    gsecs = time.perf_counter() - t0
    return dict(rank=mesh.rank, img=img, rays=rays, launches=launches,
                b1=b1, grad=dict(loss=float(loss), leaves=float_leaves(g),
                                 rays=grays, seconds=gsecs,
                                 peak_mem_gb=torch.cuda.max_memory_allocated()
                                 / 1e9, launches=dict(kernels.LAUNCHES)))


def rank_four(device, cut_spp):
    """(c) four ranks under gloo on one shared card, mesh 2x2."""
    mesh = make_mesh(2, device=device)
    scene, camera = cornell(600, cut_spp, device)
    reset_launches()
    img, rays = mk.render_fast_sharded(scene, camera, mesh, with_stats=True)
    torch.cuda.synchronize()
    return dict(rank=mesh.rank, mesh=mesh.shape, img=img, rays=rays,
                launches=dict(kernels.LAUNCHES))


def phase_distributed(main):
    """The sharded render and the distributed gradient over
    torch.distributed. Several ranks on the one card check correctness;
    they are no faster than one rank, and no scaling is claimed."""
    # (a) NCCL, world 1, the main path's frame
    a = run_ranks(rank_world1, 1, backend="nccl", timeout_s=DIST_TIMEOUT_S,
                  args=(main["spp"],))[0]
    say("distributed", check="nccl_world1_render_distributed",
        scene="cornell_box", width=600, height=600, spp=a["spp"], depth=8,
        mesh=a["metrics_mesh"], path=a["metrics_path"], seconds=a["seconds"],
        main_path_seconds=main["seconds"],
        over_main_path=a["seconds"] / main["seconds"], rays=a["rays"],
        bitwise_equal=a["bitwise_equal"], rays_equal=a["rays_equal"],
        launches=a["launches"], bound_ms=a["bound_ms"], b1=a["b1"])
    if not (a["bitwise_equal"] and a["rays_equal"]):
        fail("render_distributed (NCCL, world 1) differs from render_fast")
    if a["launches"]["render_kernel"] != 1:
        fail(f"render_distributed launched render_kernel "
             f"{a['launches']['render_kernel']} times, expected 1")
    if a["b1"]["pixels_bitwise_equal"] != a["pixels"] or \
            a["b1"]["rays"] != a["b1"]["rays_plain"]:
        fail("the sharded route's B1 differs from its plain version")

    scene, camera = cornell(600, DIST_CUT_SPP)
    ref, ref_rays = mk.render_fast(scene, camera, with_stats=True)
    target = mk.render_fast(scene, camera, seed=99, spp=16)

    # (b) + (d): two ranks sharing the card under gloo, mesh 2x1
    two = run_ranks(rank_two, 2, backend="gloo", device="cuda:0",
                    timeout_s=DIST_TIMEOUT_S, args=(DIST_CUT_SPP, target))
    for r in two:
        eq = bool(np.array_equal(r["img"], ref))
        say("distributed", check="gloo_2x1_render", rank=r["rank"],
            spp=DIST_CUT_SPP, bitwise_equal=eq, rays=r["rays"],
            rays_single=ref_rays, launches=r["launches"], b1_64px=r["b1"])
        if not eq or r["rays"] != ref_rays:
            fail(f"2x1 rank {r['rank']}: image or rays differ from "
                 "render_fast")
        if r["launches"]["render_kernel"] != 1:
            fail(f"2x1 rank {r['rank']} launched render_kernel "
                 f"{r['launches']['render_kernel']} times")
        if (r["b1"]["pixels_bitwise_equal"] != r["b1"]["pixel_count"]
                or r["b1"]["ray_counts_differ"]):
            fail(f"2x1 rank {r['rank']}: B1 differs from its plain version")

    gscene, gcam = cornell(600, GRAD_SPP)
    t_flat = torch.from_numpy(target.reshape(-1, 3)).to(DEVICE)

    def sse(img, pid):
        d = img - t_flat
        return torch.sum(d * d)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss1, g1, rays1 = tg.loss_and_grad(gscene, gcam, sse, seed=1,
                                        spp=GRAD_SPP, max_depth=GRAD_DEPTH,
                                        with_rays=True)
    torch.cuda.synchronize()
    secs1 = time.perf_counter() - t0
    ref_leaves = float_leaves(g1)
    for r in two:
        d = r["grad"]
        errs = {}
        for f, b in ref_leaves.items():
            scale = float(np.abs(b).max())
            err = np.abs(d["leaves"][f].astype(np.float64) - b)
            lim = DIST_GRAD_RTOL * np.abs(b) + DIST_GRAD_ATOL * scale
            errs[f] = dict(max_abs_err=float(err.max()), max_abs=scale,
                           within=bool((err <= lim).all()))
        loss_rel = abs(d["loss"] - float(loss1)) / abs(float(loss1))
        say("distributed", check="gloo_2x1_replay_loss_and_grad",
            rank=r["rank"], scene="cornell_box", width=600, height=600,
            spp=GRAD_SPP, depth=GRAD_DEPTH, loss=d["loss"],
            loss_single=float(loss1), loss_rel_err=loss_rel,
            rays=d["rays"], rays_single=rays1, seconds=d["seconds"],
            single_rank_seconds=secs1, peak_mem_gb=d["peak_mem_gb"],
            launches=d["launches"], leaves=errs)
        if not loss_rel <= DIST_LOSS_RTOL:
            fail(f"distributed loss {d['loss']} vs one rank {float(loss1)}")
        bad = [f for f, e in errs.items() if not e["within"]]
        if bad:
            fail(f"distributed gradient differs from one rank's in {bad}")
        if d["rays"] != rays1:
            fail(f"distributed gradient rays {d['rays']} vs {rays1}")
        if d["launches"]["record_kernel"] < 1:
            fail("the distributed gradient did not launch record_kernel")

    # (c) four ranks sharing the card under gloo, mesh 2x2
    four = run_ranks(rank_four, 4, backend="gloo", device="cuda:0",
                     timeout_s=DIST_TIMEOUT_S, args=(DIST_CUT_SPP,))
    for r in four:
        err = np.abs(r["img"].astype(np.float64) - ref)
        ok = bool((err <= SPLIT_ATOL + SPLIT_RTOL * np.abs(ref)).all())
        say("distributed", check="gloo_2x2_render", rank=r["rank"],
            mesh=r["mesh"], spp=DIST_CUT_SPP, max_abs_err=float(err.max()),
            bitwise_equal=bool(np.array_equal(r["img"], ref)),
            within_tol=ok, rays=r["rays"], rays_single=ref_rays,
            launches=r["launches"])
        if not ok or r["rays"] != ref_rays:
            fail(f"2x2 rank {r['rank']}: image or rays beyond tolerance")
        if r["launches"]["render_kernel"] != 1:
            fail(f"2x2 rank {r['rank']} launched render_kernel "
                 f"{r['launches']['render_kernel']} times")

    # (e) the CLI under torchrun, one process, against the CLI alone
    with tempfile.TemporaryDirectory() as tmp:
        args = ["-s", "6", "--width", "200", "--spp", "64"]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [REPO] + [p for p in os.environ.get("PYTHONPATH", "")
                      .split(os.pathsep) if p]))
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "1", "-m", "rust_tracing_tpu_torch",
             "--distributed", *args, "-o", os.path.join(tmp, "tr")],
            env=env, capture_output=True, text=True,
            timeout=DIST_TIMEOUT_S)
        tr_s = time.perf_counter() - t0
        # the CLI alone, with the occupancy report and a profiler trace, in
        # a process of its own as a user runs it: in this process, minutes
        # old by now, the profiler's device timestamps have drifted ~5 ms
        # early against its host clock, and it drops device work stamped
        # before the trace's start, as the first kernels of a short
        # profiled render are
        prof_dir = os.path.join(tmp, "prof")
        alone = subprocess.run(
            [sys.executable, "-m", "rust_tracing_tpu_torch", *args,
             "--report-occupancy", "--profile", prof_dir, "-o",
             os.path.join(tmp, "plain")],
            env=env, capture_output=True, text=True, timeout=DIST_TIMEOUT_S)
        rc = alone.returncode
        tr_png = os.path.join(tmp, "tr.png")
        same = (res.returncode == 0 and rc == 0 and os.path.exists(tr_png)
                and open(tr_png, "rb").read()
                == open(os.path.join(tmp, "plain.png"), "rb").read())
        trace = os.path.join(prof_dir, "trace_rank0.json")
        traced = (os.path.exists(trace)
                  and "render_kernel" in open(trace).read())
        occ = [ln for ln in alone.stdout.splitlines()
               if ln.startswith("occupancy per bounce")]
        say("distributed", check="cli_torchrun", rc=res.returncode,
            seconds=tr_s, png_equals_cli=same,
            mesh_line=[ln for ln in res.stdout.splitlines()
                       if ln.startswith(("Mesh", "distributed"))],
            profile_has_render_kernel=traced, occupancy=occ)
        if not same:
            fail(f"torchrun --distributed CLI: rc {res.returncode}, CLI "
                 f"alone rc {rc}, PNG equal {same}\n{res.stdout[-2000:]}"
                 f"{res.stderr[-2000:]}{alone.stderr[-2000:]}")
        if not (traced and occ):
            fail("the CLI's --profile trace holds no render_kernel, or "
                 "--report-occupancy printed nothing")
    return dict(a=a, two=two, four=four, single_grad_s=secs1)


def phase_live():
    """--live --checkpoint: a CLI process killed once its checkpoint holds
    LIVE_KILL_AT samples, resumed to LIVE_SPP; equal bit for bit to an
    uninterrupted live render."""
    args = ["-s", "6", "--width", str(LIVE_WIDTH), "--spp", str(LIVE_SPP),
            "--live", "--checkpoint-every", str(LIVE_CKPT_EVERY),
            "--preview-every", "64"]
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck.npz")
        env = dict(os.environ, PYTHONPATH=REPO)
        with open(os.path.join(tmp, "log"), "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "rust_tracing_tpu_torch", *args,
                 "--checkpoint", ck, "-o", os.path.join(tmp, "a")],
                env=env, stdout=log, stderr=log)
            deadline = time.monotonic() + DIST_TIMEOUT_S
            killed_at = None
            try:
                while time.monotonic() < deadline and proc.poll() is None:
                    if os.path.exists(ck) and \
                            ckpt.load(ck).num_samples >= LIVE_KILL_AT:
                        proc.kill()
                        killed_at = ckpt.load(ck).num_samples
                        break
                    time.sleep(0.02)
            finally:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
        if killed_at is None or killed_at >= LIVE_SPP:
            with open(os.path.join(tmp, "log")) as f:
                tail = f.read()[-2000:]
            fail(f"live: the render was not killed mid-way (checkpoint at "
                 f"{killed_at}, rc {proc.returncode})\n{tail}")
        quiet = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(quiet), \
                contextlib.redirect_stderr(quiet):
            rc_resume = cli.main(args + ["--checkpoint", ck, "-o",
                                         os.path.join(tmp, "a")])
            t1 = time.perf_counter()
            rc_full = cli.main(args + ["--checkpoint",
                                       os.path.join(tmp, "full.npz"),
                                       "-o", os.path.join(tmp, "b")])
        t2 = time.perf_counter()
        resumed = ckpt.load(ck)
        full = ckpt.load(os.path.join(tmp, "full.npz"))
        equal = bool(np.array_equal(resumed.accum, full.accum))
        png_equal = (open(os.path.join(tmp, "a.png"), "rb").read()
                     == open(os.path.join(tmp, "b.png"), "rb").read())
        gm = gamma_mean(full.accum)
        say("live", scene="cornell_box", width=LIVE_WIDTH, spp=LIVE_SPP,
            killed_at_spp=killed_at, kill_rc=proc.returncode,
            resumed_spp=resumed.num_samples, rc_resume=rc_resume,
            rc_full=rc_full, bitwise_equal=equal, png_equal=png_equal,
            resume_seconds=t1 - t0, uninterrupted_seconds=t2 - t1,
            gamma_mean=gm)
        if not (rc_resume == 0 and rc_full == 0 and equal and png_equal
                and resumed.num_samples == LIVE_SPP):
            fail("live: the resumed render differs from the uninterrupted "
                 "one")


# probes phase: each kernels-line entry of the H100 probes (csrc/
# probe_kernel.cu, scripts/tpu_probe.py P1-P7): (probe, kernel, the line of
# its pallas_call, the variant it reports, size). The variant is the memory
# space that stands for the TPU probe's own (SMEM scalars -> __constant__,
# VMEM -> shared memory); P1 at the largest size every space holds.
PROBE_ENTRIES = (
    ("P1", "smem_scalar_kernel", 50, "constant", 16384),
    ("P2", "row_broadcast_kernel", 69, "shared", probes.ROW_N),
    ("P3", "gather_probe_kernel", 86, "shared/stride13", probes.GATHER_N),
    ("P4", "gather_2d_kernel", 104, "shared", probes.GATHER_N),
    ("P5", "sphere_loop_kernel", 148, "constant", probes.SPHERES),
    ("P6", "sphere_immediate_kernel", 184, "immediate", probes.SPHERES),
    ("P7", "sphere_mxu_kernel", 223, "f32", probes.SPHERES),
)


def probe_library_ms(probe, variant, size, tiles, gathers):
    """One PyTorch call computing the probe's function at the timed shape,
    timed like the kernels (probes.time_ms); None where no call does
    (P5-P7). P1/P2: torch.sum of the table (its order differs: time only;
    one sum, where the probes fold once a tile). P3/P4: embedding_bag's sum
    of the gathers at the timed index offsets, whose integer sums are exact
    in any order: it must equal the kernel's tile."""
    if probe == "P1":
        tab = torch.arange(size, dtype=torch.float32, device=DEVICE)
        return probes.time_ms(lambda: tab.sum(), 10)
    if probe == "P2":
        tab = torch.arange(size, dtype=torch.float32,
                           device=DEVICE)[:, None].repeat(1, probes.LANES)
        return probes.time_ms(lambda: tab[:, 0].sum(), 10)
    if probe not in ("P3", "P4"):
        return None
    idx = probes.gather_index(probes.GATHER_STRIDE, DEVICE)
    bags = (idx[..., None] + torch.arange(gathers, device=DEVICE)) \
        % probes.GATHER_N
    if probe == "P3":
        weight = probes.gather_table(DEVICE)[:, :1].contiguous()
    else:
        weight = probes.gather_2d_table(DEVICE).reshape(-1, 1)
        bags = bags * probes.LANES + torch.arange(
            probes.LANES, device=DEVICE)[:, None]
    bags = bags.expand(tiles, *bags.shape).reshape(-1, gathers)
    lib = lambda: torch.nn.functional.embedding_bag(bags, weight, mode="sum")
    want = probes.case(probe, variant, size, 0, 1, DEVICE, gathers)[1]()
    if not torch.equal(lib()[:probes.TILE].reshape(want.shape), want):
        fail(f"probes: embedding_bag does not compute {probe}'s function")
    return probes.time_ms(lib, 10)


def phase_probes():
    """The H100 probes: their entry point's sweep (probes.sweep: every
    variant at the reference shape against its plain version, then the
    timed call at FILL_TILES tiles tile by tile against the plain version
    of one tile), with the launch counts reset just before and read just
    after. Each kernels-line entry is its variant's sweep row, with the
    plain version's time at the timed shape and the library call's."""
    if torch.backends.cuda.matmul.allow_tf32:
        fail("probes: TF32 matmuls are on; the port never turns them on")
    reset_launches()
    t0 = time.perf_counter()
    rows = probes.sweep(seed=0)
    sweep_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    for r in rows:
        say("probes", **r)
    bad = [f"{r['probe']} {r['variant']} {r['size']}" for r in rows
           if r["fits"] and not r["equal"]]
    if bad:
        fail(f"probes: kernel differs from its plain version: {bad}")
    unchecked = [f"{r['probe']} {r['variant']} {r['size']}" for r in rows
                 if r["fits"] and r["probe"] in probes.UNEVEN_PROBES
                 and r.get("uneven_tiles") != list(probes.UNEVEN_TILES)]
    if unchecked:
        fail(f"probes: persistent kernels not held at uneven tile counts: "
             f"{unchecked}")
    unchecked = [f"{r['probe']} {r['variant']} {r['size']}" for r in rows
                 if r["fits"] and r["probe"] in probes.ISSUE_PROBES
                 and "edge_equal" not in r]
    if unchecked:
        fail(f"probes: sphere loops not held on the edge tile: {unchecked}")
    names = [e[1] for e in PROBE_ENTRIES] + ["sphere_mxu_tc_kernel"]
    idle = [k for k in names if launches[k] < 1]
    if idle:
        fail(f"probes: the sweep never launched {idle}")
    by = {(r["probe"], r["variant"], r["size"]): r for r in rows if r["fits"]}
    T = probes.FILL_TILES
    entries = []
    for probe, name, line, variant, size in PROBE_ENTRIES:
        r = by[(probe, variant, size)]
        gathers = probes.timed_gathers(probe)
        _, plain_ms = once_ms(probes.case(probe, variant, size, 0, T, DEVICE,
                                          gathers)[1])
        torch.cuda.empty_cache()
        entry = dict(
            name=name, route="cuda",
            source="rust_tracing_tpu_torch/csrc/probe_kernel.cu",
            replaces=f"scripts/tpu_probe.py:{line}",
            launches=launches[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=plain_ms, bound_ms=r["bound_ms"],
            bound_by=r["bound_by"],
            library_ms=probe_library_ms(probe, variant, size, T, gathers),
            shape=f"{probe} {r['function']} {variant} size {size}, {T} tiles"
                  + (f", {gathers} gathers a thread" if gathers > 1 else ""),
            rate=r["rate"], rate_unit=r["rate_unit"])
        if probe in probes.UNEVEN_PROBES:
            entry.update(uneven_tiles=r["uneven_tiles"],
                         uneven_equal=r["uneven_equal"])
        if probe in probes.FOLD_PROBES:
            entry.update(chain_floor_ms=r["chain_floor_ms"],
                         ragged_size=r["ragged_size"])
        if probe in probes.GATHER_PROBES:
            entry.update(issue_floor_ms=r["issue_floor_ms"], sms=r["sms"],
                         smem_floor_ms=r["smem_floor_ms"])
        if probe in probes.ISSUE_PROBES:
            entry.update(issue_floor_ms=r["issue_floor_ms"], sms=r["sms"],
                         edge_equal=r["edge_equal"])
        if probe in ("P1", "P5"):
            entry["ms_by_space"] = {
                sp: by[(probe, sp, size)]["ms"] for sp in probes.SPACES}
        if probe == "P7":
            entry.update(probe_tf32(launches, by[("P7", "tf32", size)]))
        say("probes", check="entry", **entry)
        entries.append(entry)
    say("probes", check="phase", sweep_seconds=sweep_s,
        seconds=time.perf_counter() - t0)
    return entries


def probe_tf32(launches, row):
    """P7's tensor-core variant from its sweep row (time, bound, gate, the
    edge tile's gate), and the two products by torch.matmul (TF32 off)
    beside."""
    cm, r2, o, d = probes.mxu_inputs(0, probes.SPHERES, probes.FILL_TILES,
                                     DEVICE)
    return dict(
        tf32_kernel="sphere_mxu_tc_kernel",
        tf32_launches=launches["sphere_mxu_tc_kernel"], tf32_ms=row["ms"],
        tf32_bound_ms=row["bound_ms"], tf32_bound_by=row["bound_by"],
        tf32_issue_floor_ms=row["issue_floor_ms"],
        tf32_edge_equal=row["edge_equal"],
        **{f"tf32_{k}": v for k, v in row.items()
           if k.startswith(("gate_", "edge_gate_"))},
        library_products_ms=probes.time_ms(
            lambda: (torch.matmul(d, cm), torch.matmul(o, cm)), 3))


# torch_func phase: the noise scene of tests/test_grad.py's jacfwd test at
# 24 px, seed 3, 4 spp, depth 3, float64; the middle row's pixels
JAC_WIDTH, JAC_SEED, JAC_SPP, JAC_DEPTH = 24, 3, 4, 3
JAC_RTOL, JAC_ATOL = 1e-10, 1e-12


def jac_scene():
    """A marble back wall, a red wall, a checker floor, a light and a
    marble sphere (tests/test_grad.py::_mini_cornell)."""
    b = rt.SceneBuilder(background=(0.0, 0.0, 0.0))
    marble = b.lambertian(b.noise_texture(2.0))
    checker = b.lambertian(b.checker_texture(0.5, (0.8, 0.8, 0.2),
                                             (0.1, 0.1, 0.4)))
    b.add_quad((-2, -2, 4), (4, 0, 0), (0, 4, 0), marble)
    b.add_quad((-2, -2, 0), (0, 0, 4), (0, 4, 0),
               b.lambertian((0.65, 0.05, 0.05)))
    b.add_quad((-2, -2, 0), (4, 0, 0), (0, 0, 4), checker)
    b.add_quad((-1, 1.9, 1), (2, 0, 0), (0, 0, 2), b.diffuse_light((6, 6, 6)))
    b.add_sphere((0.3, -1.2, 2.0), 0.8, b.lambertian(b.noise_texture(3.0)))
    settings = rt.RenderSettings(
        aspect_ratio=1.0, image_width=JAC_WIDTH,
        samples_per_pixel=JAC_SPP, max_depth=JAC_DEPTH, vfov=60.0,
        look_from=(0.0, 0.0, -3.0), look_at=(0.0, 0.0, 2.0),
        background=(0.0, 0.0, 0.0))
    return b, settings


def phase_torch_func():
    """jacfwd and jacrev through the replay on the card (launch counts
    reset just before, read just after: the batching rules' kernels must
    have run) against each other and against the same on the CPU; both
    devices replay the CPU recorder's records."""
    b, settings = jac_scene()
    cam = rt.Camera.create(settings)
    pid = JAC_WIDTH * (JAC_WIDTH // 2) + torch.arange(JAC_WIDTH,
                                                      dtype=torch.int32)
    recs = None
    jac = {}
    for dev in ("cpu", DEVICE):
        scene = rt.compile_scene(b, dtype=torch.float64, device=dev)
        c = cam.constants(torch.float64, device=dev)
        if recs is None:
            recs = tg.get_records(scene, cam, JAC_SEED, JAC_SPP, JAC_DEPTH,
                                  pixel_ids=pid, dtype=torch.float64)
        p, r = pid.to(dev), recs.to(dev)

        def f(tex_rgb):
            img, _ = tg.radiance_mean_replay_rays(
                scene.replace(tex_rgb=tex_rgb), c, p, JAC_SEED, r, JAC_SPP,
                JAC_DEPTH)
            return img.mean(-1)

        if dev == DEVICE:
            torch.cuda.synchronize()
            reset_launches()
        t0 = time.perf_counter()
        fwd = torch.func.jacfwd(f)(scene.tex_rgb)
        rev = torch.func.jacrev(f)(scene.tex_rgb)
        if dev == DEVICE:
            torch.cuda.synchronize()
            launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        jac[dev] = (fwd.cpu(), rev.cpu(), time.perf_counter() - t0)
    (fc, rc, cpu_s), (fg, rg, gpu_s) = jac["cpu"], jac[DEVICE]

    def err(a, b):
        return float((a - b).abs().max())

    ok = (bool(torch.isfinite(fg).all()) and float(fg.abs().max()) > 0
          and all(torch.allclose(a, b, rtol=JAC_RTOL, atol=JAC_ATOL)
                  for a, b in ((fg, rg), (fg, fc), (rg, rc))))
    say("torch_func", shape=tuple(fg.shape), launches=launches,
        fwd_rev_max_abs_err=err(fg, rg), fwd_cpu_max_abs_err=err(fg, fc),
        rev_cpu_max_abs_err=err(rg, rc), max_abs_jacobian=float(
            fg.abs().max()), rtol=JAC_RTOL, atol=JAC_ATOL, ok=ok,
        cuda_seconds=gpu_s, cpu_seconds=cpu_s)
    if not ok:
        fail("torch_func: the card's jacfwd/jacrev disagree with each other "
             "or with the CPU's")
    idle = [k for k in ("gather_cols_kernel", "scatter_sum_kernel")
            if not launches.get(k)]
    if idle:
        fail(f"torch_func: the batching rules never launched {idle}")



# ------------------------------------------------- the tools (bench, entry,
# run_workloads, final_scene_full)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "aux"}
BENCH_AUX_KEYS = {"fwdbwd_workload", "fwdbwd_l2_rays_per_sec",
                  "forward_rays_per_sec", "forward_vs_baseline",
                  "forward_seconds", "forward_path",
                  "parity_ratio_megakernel_vs_xla", "avg_bounces", "device"}


def phase_bench(grad):
    """bench.run() at the reference's sizes, what `python -m
    rust_tracing_tpu_torch.bench` prints, the parity frame at
    BENCH_PARITY_SPP: its line parses with the reference's keys, its timed
    calls (seeds 1 and 2) count grad_path's exact rays for those seeds and
    launch record_kernel 9 times each (one a sample slice), and the fused
    render's mean is within 1 % of the tensor integrator's."""
    t0 = time.perf_counter()
    line = json.loads(json.dumps(bench.run(parity_spp=BENCH_PARITY_SPP)))
    say("bench", seconds=time.perf_counter() - t0, **line)
    aux = line["aux"]
    if set(line) != BENCH_KEYS or not BENCH_AUX_KEYS <= set(aux) \
            or line["metric"] != bench.METRIC:
        fail(f"bench line keys {sorted(line)}, aux {sorted(aux)}")
    if aux["fwdbwd_seeds"] != [1, 2] or \
            aux["fwdbwd_rays"] != [grad["rays"], grad["rays_rep2"]]:
        fail(f"bench rays {aux['fwdbwd_rays']} (seeds "
             f"{aux['fwdbwd_seeds']}) vs grad_path's "
             f"{[grad['rays'], grad['rays_rep2']]}")
    if not abs(1.0 - aux["parity_ratio_megakernel_vs_xla"]) < 0.01:
        fail(f"bench parity {aux['parity_ratio_megakernel_vs_xla']}")
    counts = [c.get("record_kernel", 0) for c in aux["fwdbwd_launches"]]
    if counts != [9, 9]:
        fail(f"bench headline calls launched record_kernel {counts} times, "
             "expected 9 sample slices each")
    if aux["forward_path"] != "megakernel":
        fail(f"bench forward took {aux['forward_path']}")
    return line


def phase_entry():
    """entry()'s fn on the card (its gathers through gather_kernel), then
    dryrun_multichip(2) with both ranks on the card (gloo, sharing it)."""
    fn, args = entry.entry()
    torch.cuda.synchronize()
    reset_launches()
    out, ms = once_ms(lambda: fn(*args))
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    t0 = time.perf_counter()
    ranks = entry.dryrun_multichip(2)
    dry_s = time.perf_counter() - t0
    finite = bool(torch.isfinite(out).all())
    say("entry", shape=tuple(out.shape), finite=finite, ms=ms,
        launches=launches, device=str(out.device),
        dryrun_layout=entry.rank_layout(2), dryrun_seconds=dry_s,
        dryrun=ranks)
    if tuple(out.shape) != (1024, 3) or not finite or out.device.type != \
            "cuda":
        fail(f"entry fn gave {tuple(out.shape)} finite={finite} on "
             f"{out.device}")
    if not launches.get("gather_kernel"):
        fail("entry fn did not launch gather_kernel")
    if len(ranks) != 2 or not all(r["device"].startswith("cuda")
                                  for r in ranks):
        fail(f"dryrun_multichip(2) ranks: {ranks}")


def phase_workloads():
    """run_workloads.run(): the nine reference workloads at their own frames
    and cut spp through render(); every row finite, named by its path, and
    that path's kernel launched; cornell_box's gamma mean in 0.24-0.27 at
    512 spp or more."""
    with tempfile.TemporaryDirectory() as tmp:
        table = run_workloads.run(scale_spp=WORKLOAD_SCALE,
                                  scene8_spp=WORKLOAD_SCENE8_SPP,
                                  out_dir=OUT_DIR or tmp)
    rows = table["rows"]
    for row in rows:
        say("workloads", **row)
    if [r["scene"] for r in rows] != list(range(9)):
        fail(f"workloads: rows {[r['scene'] for r in rows]}")
    for r in rows:
        if not (r["rays"] > 0 and r["finite"]
                and r["launches"].get(PATH_KERNEL.get(r["path"], ""))):
            fail(f"workloads row {r['name']}: rays {r['rays']}, finite "
                 f"{r['finite']}, path {r['path']}, launches "
                 f"{r['launches']}")
        spp = int(r["workload"].split("@")[1].split("spp")[0])
        if r["name"] == "cornell_box" and spp >= 512 and \
                not 0.24 <= r["gamma_mean"] <= 0.27:
            fail(f"workloads: cornell gamma mean {r['gamma_mean']}")
    return rows


def phase_final_scene_full():
    """final_scene_full.run() at final_scene's 800x800, depth 40, two
    slices of FSF_SLICE_SPP: stopped after the first slice and resumed, the
    image (float64 running mean) and the PNG equal an uninterrupted run's
    bit for bit."""
    kw = dict(spp=2 * FSF_SLICE_SPP, slice_spp=FSF_SLICE_SPP, max_depth=40)
    with tempfile.TemporaryDirectory() as tmp:
        cut, whole = os.path.join(tmp, "cut"), os.path.join(tmp, "whole")
        reset_launches()
        first = final_scene_full.run(out_dir=cut, stop_after=1, **kw)
        resumed = final_scene_full.run(out_dir=cut, **kw)
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        straight = final_scene_full.run(out_dir=whole, **kw)
        png = [open(os.path.join(d, final_scene_full.PNG_NAME), "rb").read()
               for d in (cut, whole)]
    same = bool(np.array_equal(resumed["accum"], straight["accum"]))
    say("final_scene_full", workload=resumed["workload"],
        slice_spp=FSF_SLICE_SPP, path=resumed["path"],
        first_slices=first["slices_done"], resumed_complete=resumed[
            "complete"], bitwise_equal=same, png_equal=png[0] == png[1],
        rays=resumed["rays"], rays_uninterrupted=straight["rays"],
        seconds=resumed["seconds"], seconds_uninterrupted=straight[
            "seconds"], launches=launches,
        gamma_mean=run_workloads.gamma_mean(resumed["accum"]))
    if first["slices_done"] != 1 or first["complete"] or not \
            resumed["complete"]:
        fail("final_scene_full did not stop after one slice and resume")
    if not (same and png[0] == png[1]
            and resumed["rays"] == straight["rays"]):
        fail("final_scene_full: the resumed image differs from an "
             "uninterrupted run")
    if not launches.get(PATH_KERNEL.get(resumed["path"], "")):
        fail(f"final_scene_full: path {resumed['path']}, launches "
             f"{launches}")


def b1_compares():
    """The render kernel against its plain version, four scene families at
    a small frame (one, a few and many samples a pixel: every group width
    samples_per_group picks, 1 to 32 threads a pixel; a pixel range that
    starts mid-row), and at the main path's shapes (600x600 frame, depth 8,
    the same tables, a warp a pixel) with spp cut so the plain version ends
    in seconds, its tables staged in shared memory and read through
    __ldg."""
    for name, spp in (("cornell_box", 16), ("cornell_smoke", 16),
                      ("two_spheres", 16), ("random_balls", 8),
                      ("cornell_box", 1), ("cornell_box", 2),
                      ("cornell_box", 23), ("cornell_box", 32)):
        compare(name, 64, spp, 8)
    compare("cornell_smoke", 64, 23, 8, pixel_base=5 * 64 + 17,
            pixel_count=1500)
    return compare("cornell_box", 600, B1_MAIN_SPP, 8, unstaged=True)


def render_resources():
    """Registers, local memory, shared memory and blocks an SM of every
    render kernel instantiation (staged: at the full staging budget), and
    of the recorder's and the hit kernel's, with and without the walk."""
    out = {}
    for noise in (0, 1):
        for image in (0, 1):
            for route in ("ldg", "staged", "bvh"):
                p = mk.RenderParams(has_noise=noise, has_image=image,
                                    use_bvh=int(route == "bvh"))
                plan = mk.RenderPlan(group=32, stage_bytes=(
                    mk.STAGE_BUDGET_BYTES if route == "staged" else 0))
                occ = mk.render_occupancy(p, plan)
                out[f"noise{noise}_image{image}_{route}"] = dict(
                    {k: occ[k] for k in ("registers", "local_bytes",
                                         "blocks_per_sm")},
                    shared_bytes=plan.stage_bytes,
                    spill_stores=spills("render_kernel", noise, image,
                                        route == "bvh", route == "staged"))
    for kernel, route, bvh, smem in (
            ("record_kernel", "brute", 0, 0),
            ("record_kernel", "staged", 0, mk.STAGE_BUDGET_BYTES),
            ("record_kernel", "bvh", 1, 0), ("hit_kernel", "brute", 0, 0),
            ("hit_kernel", "bvh", 1, 0)):
        occ = mk.search_occupancy(kernel, bool(bvh), smem)
        flags = (bvh, smem > 0) if kernel == "record_kernel" else (bvh,)
        out[f"{kernel}_{route}"] = dict(
            {k: occ[k] for k in ("registers", "local_bytes",
                                 "blocks_per_sm")},
            shared_bytes=smem, spill_stores=spills(kernel, *flags))
    return out


def main():
    t_start = time.perf_counter()
    card = gpu_line()
    say("device", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0))

    kernels.load()
    regs = [ln.strip() for ln in kernels.build_log.splitlines()
            if "registers" in ln or "spill" in ln or ln.startswith("==")
            or "Compiling entry" in ln]
    say("build", seconds=kernels.build_seconds, sources=list(kernels.SOURCES),
        ptxas=regs, render_kernel=render_resources())

    phase_exact()

    at_main = b1_compares()

    # the recorder against its plain version: the same scenes at a small
    # frame, cornell_box 600x600 at two sample offsets, and one full sample
    # slice of the gradient path (23 spp at offset 23), timed
    for name in ("cornell_box", "cornell_smoke", "two_spheres",
                 "random_balls"):
        compare_records(name, 64, 4, 8, 0)
    for off in (0, 23):
        compare_records("cornell_box", 600, 4, 8, off)
    rec_main = compare_records("cornell_box", 600, 23, 8, 23, timed=True)
    # a range that starts and ends mid-row (the sharded recorder's case),
    # one sample a pixel, and a frame whose pixel count is no multiple of a
    # block (simple_light's own 600x337 at the gradient's 23 spp slice)
    compare_records("cornell_box", 600, 4, 8, 0, pixel_base=1000,
                    pixel_count=4097)
    compare_records("cornell_box", 64, 1, 8, 0)
    compare_records("simple_light", 600, 23, 8, 0)

    # the render kernel's noise and image families (B8) and the recorder on
    # the texture scenes, then B8 at simple_light's own 600x337 frame and
    # depth with spp cut so the plain version ends in seconds
    for name in TEXTURE_SCENES:
        compare(name, 64, 16, 8)
        compare_records(name, 64, 4, 8, 0)
    compare("simple_light", 32, 32, 8)     # the fused render's warp a pixel
    at_fused = compare("simple_light", 600, 4, 8)

    # the BVH walk (B4) in the render kernel and the recorder against the
    # plain search: final_scene (past the threshold, with its noise and
    # image families) at 64 px and at 200x200 to its own depth 40, and
    # random_balls (spheres) and cornell_box (leaves of thin coplanar quads)
    # with a forced tree
    compare("final_scene", 64, 4, 8, use_bvh=True)
    compare_records("final_scene", 64, 4, 8, 0, use_bvh=True)
    compare("random_balls", 64, 8, 8, use_bvh=True)
    compare_records("random_balls", 64, 4, 8, 0, use_bvh=True)
    compare("cornell_box", 64, 4, 8, use_bvh=True)
    compare_records("cornell_box", 64, 4, 8, 0, use_bvh=True)
    # the walk's per-pixel counters, summed over the samples by the
    # recorder, against the plain walk of the same paths
    compare_records("final_scene", 16, 2, 8, 0, use_bvh=True, counters=True)
    compare_records("cornell_box", 16, 3, 8, 0, use_bvh=True, counters=True,
                    pixel_base=37, pixel_count=150)
    at_final = compare("final_scene", 200, 4, 40, use_bvh=True)
    # the fused final_scene render's group width, a warp a pixel (depth
    # cut: the plain version's sample loop takes a minute at depth 40)
    compare("final_scene", 32, FINAL_SPP, 8, use_bvh=True)

    gathers = compare_gathers()
    sums = compare_reductions()
    segs = compare_segment_sums()
    scatter_routes()
    turb = compare_perlin()
    turb_bwd = compare_perlin_backward()
    hits0, hits_deep = phase_hits()
    cross = phase_crossover()

    main = phase_main_path(at_main)

    # ---- CLI
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cli_cornell")
        rc = cli.main(["-s", "6", "--width", "200", "--spp", "64", "-o", out])
        if rc != 0 or not os.path.exists(out + ".png"):
            fail(f"cli returned {rc} or wrote no PNG")
        say("cli", rc=rc, png_bytes=os.path.getsize(out + ".png"))

    fused_tex, fused_img = phase_fused_textures()
    deferred = phase_deferred_path({"simple_light": fused_img})
    grad_tex = phase_grad_textures()

    grad, scene, camera = phase_grad_path()
    census = phase_profile(scene, camera, grad["seconds_rep2"])
    phase_train()
    phase_grad_check()

    final = phase_wavefront()
    say("crossover", check="wavefront_vs_fused", scene="final_scene",
        width=800, height=800, spp=FINAL_SPP, depth=40,
        wavefront_s=final["seconds"], fused_s=final["fused_seconds"],
        wavefront_over_fused=final["seconds"] / final["fused_seconds"])
    grad_final = phase_grad_final()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cli_final")
        rc = cli.main(["-s", "8", "--width", "200", "--spp", "8", "-o", out])
        if rc != 0 or not os.path.exists(out + ".png"):
            fail(f"cli -s 8 returned {rc} or wrote no PNG")
        say("cli_final", rc=rc, png_bytes=os.path.getsize(out + ".png"))

    dist_res = phase_distributed(main)
    phase_live()
    probe_entries = phase_probes()
    phase_torch_func()

    # ---- the tools: the bench, the entry point, the workload tools
    phase_bench(grad)
    phase_entry()
    phase_workloads()
    phase_final_scene_full()

    say("total", seconds=time.perf_counter() - t_start,
        grad_final_s=grad_final["seconds"])
    g5 = gathers[("gather", 4, torch.float32)]
    g6 = gathers[("cols", 24, 17, torch.float32)]
    rd = sums[(24, 17)]
    real = sums["real"]
    mt = grad_final["match_check"]
    seg = segs[(524288, torch.float32)]
    srt = segs[(524288, "sort")]
    gl = grad["launches"]
    say("profiler", **PROFILES)
    print(json.dumps({"kernels": [{
        "name": "render_kernel", "route": "cuda",
        "source": "rust_tracing_tpu_torch/csrc/render_kernel.cu",
        "replaces": "rust_tracing_tpu/ops/megakernel.py:1262",
        "launches": main["launches"],
        "max_abs_err": at_main["max_abs_err"],
        "ms": at_main["kernel_ms"], "plain_ms": at_main["plain_ms"],
        "bound_ms": at_main["bound_ms"], "bound_by": at_main["bound_by"],
        "library_ms": None,
        "shape": f"cornell_box 600x600 depth 8 spp {B1_MAIN_SPP} (main-path "
                 "frame, tables and group width, spp cut for the plain "
                 "version)",
        "main_path_ms": main["seconds"] * 1e3, "main_path_spp": main["spp"],
        "main_path_bound_ms": main["bound"],
        "main_path_occupancy": main["occupancy"],
    }, {
        "name": "record_kernel", "route": "cuda",
        "source": "rust_tracing_tpu_torch/csrc/render_kernel.cu",
        "replaces": "rust_tracing_tpu/ops/megakernel.py:1050",
        "launches": gl["record_kernel"],
        "max_abs_err": rec_main["max_abs_err"],
        "ms": rec_main["kernel_ms"], "plain_ms": rec_main["plain_ms"],
        "bound_ms": rec_main["bound_ms"], "bound_by": rec_main["bound_by"],
        "library_ms": None,
        "shape": "cornell_box 600x600 depth 8, one 23-spp sample slice of "
                 "the gradient path (offset 23)",
        "occupancy": rec_main["occupancy"],
    }, {
        "name": "gather_kernel", "route": "cuda",
        "source": "rust_tracing_tpu_torch/csrc/gather_kernel.cu",
        "replaces": "rust_tracing_tpu/ops/lanegather.py:64",
        "launches": gl["gather_kernel"], "max_abs_err": 0.0,
        "ms": g5["kernel_ms"], "plain_ms": g5["plain_ms"],
        "bound_ms": g5["bound_ms"], "bound_by": g5["bound_by"],
        "library_ms": g5["library_ms"],
        "shape": f"f32 table of 4 rows (cornell's texture and material "
                 f"tables), {N_INDEX} indices (one replay wavefront)",
    }, {
        "name": "gather_cols_kernel", "route": "cuda",
        "source": "rust_tracing_tpu_torch/csrc/gather_kernel.cu",
        "replaces": "rust_tracing_tpu/ops/lanegather.py:112",
        "launches": gl["gather_cols_kernel"], "max_abs_err": 0.0,
        "ms": g6["kernel_ms"], "plain_ms": g6["plain_ms"],
        "bound_ms": g6["bound_ms"], "bound_by": g6["bound_by"],
        "library_ms": g6["library_ms"],
        "shape": f"f32 (17, 24) quad column table (cornell), {N_INDEX} "
                 "indices",
    }, {
        "name": "scatter_sum_kernel", "route": "cuda",
        "source": "rust_tracing_tpu_torch/csrc/gather_kernel.cu",
        "replaces": "rust_tracing_tpu/ops/tgather.py:65",
        "launches": gl["scatter_sum_kernel"],
        "max_abs_err": real["max_abs_err"],
        "ms": real["kernel_ms"], "plain_ms": real["plain_ms"],
        "bound_ms": real["bound_ms"], "bound_by": real["bound_by"],
        "library_ms": real["library_ms"],
        "shape": f"f32 cotangent ({real['columns']}, {real['indices']}) into "
                 f"{real['rows']} rows: cornell's first replay bounce, its "
                 "tex_rgb column (the shape of every reduction of the "
                 "gradient, by the census); bit for bit "
                 "lanegather.scatter_sum_ordered_plain",
        "random_index_ms": sums["real_random"]["kernel_ms"],
        "census": census["rows"], "census_device_ms": census["device_ms"],
        "quad_table": {k: rd[k] for k in (
            "kernel_ms", "plain_ms", "bound_ms", "library_ms",
            "max_abs_err", "plan")},
        "quad_table_shape": f"f32 cotangent (17, {N_INDEX}) into the (17, "
                            "24) quad column table, random index",
        "quad_real_index_ms": sums["quad"]["kernel_ms"],
        "launches_grad_final": grad_final["launches"]["scatter_sum_kernel"],
    }, {
        "name": "scatter_match_kernel", "route": "cuda",
        "source": "rust_tracing_tpu_torch/csrc/gather_kernel.cu",
        "replaces": "rust_tracing_tpu/ops/tgather.py:65",
        "launches": grad_final["launches"]["scatter_match_kernel"],
        "max_abs_err": mt["max_abs_err"],
        "ms": mt["kernel_ms"], "plain_ms": mt["plain_ms"],
        "bound_ms": mt["bound_ms"], "bound_by": mt["bound_by"],
        "library_ms": mt["library_ms"],
        "shape": f"f32 cotangent ({mt['columns']}, {mt['indices']}) into "
                 f"{mt['rows']} rows, random index: the shape of grad_final's "
                 "match calls that took the most device time (its census); "
                 "launches from grad_final, final_scene 200x200 @ 4 spp",
        "census_grad_final": grad_final["routes"]["use_segment_sum"][
            "census"]["rows"],
    }, {
        "name": "segment_sum_kernel", "route": "cuda",
        "source": "rust_tracing_tpu_torch/csrc/gather_kernel.cu",
        "replaces": "rust_tracing_tpu/ops/tgather.py:65",
        "launches": grad_tex["earth"]["launches"]["segment_sum_kernel"],
        "max_abs_err": seg["max_abs_err"],
        "ms": seg["kernel_ms"], "plain_ms": seg["plain_ms"],
        "bound_ms": seg["bound_ms"], "bound_by": seg["bound_by"],
        "library_ms": seg["library_ms"],
        "shape": f"f32 cotangent (3, {N_INDEX}) into earth's (3, 524288) "
                 "image table, sort included; launches from grad_textures, "
                 "earth 400x225 @ 32 spp",
        "ms_by_kernel": seg["kernel_ms_by_kernel"],
        "launches_grad_final": grad_final["launches"]["segment_sum_kernel"],
    }, {
        "name": "radix_sort_kernel", "route": "cuda",
        "source": "rust_tracing_tpu_torch/csrc/gather_kernel.cu",
        "replaces": "rust_tracing_tpu/ops/tgather.py:65",
        "launches": grad_tex["earth"]["launches"]["radix_sort_kernel"],
        "max_abs_err": 0.0 if srt["bitwise_equal"] else None,
        "ms": srt["kernel_ms"], "plain_ms": srt["plain_ms"],
        "bound_ms": srt["bound_ms"], "bound_by": srt["bound_by"],
        "library_ms": srt["library_ms"],
        "shape": f"{N_INDEX} int32 indices into 524288 rows carrying 3 f32 "
                 f"columns, {len(srt['digits'])} passes {srt['digits']} (the "
                 "segment sum's sort); library call torch.sort(stable=True) "
                 "of the index, keys and int64 permutation only",
    }, {
        "name": "perlin_kernel", "route": "cuda",
        "source": "rust_tracing_tpu_torch/csrc/perlin_kernel.cu",
        "replaces": "rust_tracing_tpu/ops/perlin_tpu.py:106",
        "launches": deferred["simple_light"]["launches"]["perlin_kernel"],
        "max_abs_err": turb["max_abs_err"],
        "ms": turb["kernel_ms"], "plain_ms": turb["plain_ms"],
        "bound_ms": turb["bound_ms"], "bound_by": turb["bound_by"],
        "library_ms": None,
        "shape": f"f32, {TURB_LANES} lanes over [-{TURB_RANGE}, "
                 f"{TURB_RANGE}]^3 (the replay wavefront's budget); "
                 "launches from deferred_path, simple_light 600x337 @ 1024 "
                 "spp",
        "smem_floor_ms": turb["smem_floor_ms"],
        "smem_floor_conflict_free_ms": turb["smem_floor_conflict_free_ms"],
        "sm_clock_mhz": turb["sm_clock_mhz"],
        "real_bounce": turb["real_bounce"],
    }, {
        "name": "perlin_backward_kernel", "route": "cuda",
        "source": "rust_tracing_tpu_torch/csrc/perlin_kernel.cu",
        "replaces": "rust_tracing_tpu/ops/perlin_tpu.py:164",
        "launches": grad_tex["two_perlin_spheres"]["launches"][
            "perlin_backward_kernel"],
        "max_abs_err": turb_bwd["max_abs_err"],
        "ms": turb_bwd["kernel_ms"], "plain_ms": turb_bwd["plain_ms"],
        "bound_ms": turb_bwd["bound_ms"], "bound_by": turb_bwd["bound_by"],
        "library_ms": None,
        "shape": f"f32, {TURB_LANES} lanes over [-{TURB_RANGE}, "
                 f"{TURB_RANGE}]^3, both outputs (d_px/d_py/d_pz and "
                 "d_ranvec bit for bit; max_abs_err of d_ranvec against its "
                 "terms summed in float64); replaces the reference's jvp "
                 "(XLA, no Pallas kernel); ms = scale + main + final "
                 "kernels and the scratch's memset; launches from "
                 f"grad_textures, two_perlin_spheres {GRAD_TEX_WIDTH}x225 @ "
                 f"{GRAD_TEX_SPP} spp",
        "kernel_ms_positions_only": turb_bwd["kernel_ms_positions_only"],
        "sections_ms": turb_bwd["sections_ms"],
        "real_bounce": turb_bwd["real_bounce"],
        "grad_device_ms": {
            "two_perlin_spheres": grad_tex["two_perlin_spheres"][
                "perlin_backward_device_ms"],
            "final_scene": grad_final["routes"]["use_segment_sum"][
                "perlin_backward_device_ms"]},
    }, {
        "name": "render_kernel_textures", "route": "cuda",
        "source": "rust_tracing_tpu_torch/csrc/render_kernel.cu",
        "replaces": "rust_tracing_tpu/ops/megakernel.py:1262",
        "launches": fused_tex["launches"]["render_kernel"],
        "max_abs_err": at_fused["max_abs_err"],
        "ms": at_fused["kernel_ms"], "plain_ms": at_fused["plain_ms"],
        "bound_ms": at_fused["bound_ms"], "bound_by": at_fused["bound_by"],
        "library_ms": None,
        "shape": "render_kernel<noise> (B8): simple_light 600x337 depth 8 "
                 "spp 4 (its own frame, spp cut for the plain version)",
        "main_path_ms": fused_tex["seconds"] * 1e3,
        "main_path_spp": fused_tex["spp"],
        "main_path_bound_ms": fused_tex["bound_ms"],
    }, {
        "name": "hit_kernel", "route": "cuda",
        "source": "rust_tracing_tpu_torch/csrc/render_kernel.cu",
        "replaces": "rust_tracing_tpu/ops/megakernel.py:1037",
        "launches": final["launches"]["hit_kernel"],
        "max_abs_err": hits0["max_abs_err"],
        "ms": hits0["kernel_ms"], "plain_ms": hits0["plain_ms"],
        "bound_ms": hits0["bound_ms"], "bound_by": hits0["bound_by"],
        "library_ms": None,
        "shape": f"hit_kernel<BVH>: final_scene, the main path's first chunk "
                 f"({hits0['lanes']} lanes, bounce 0)",
        "walk_per_ray": hits0["walk_per_ray"],
        "occupancy": hits0["occupancy"],
        "bounce8": {k: {f: v[f] for f in (
            "lanes", "kernel_ms", "bound_ms", "walk_per_ray")}
            for k, v in hits_deep.items()},
        "main_path_ms": final["seconds"] * 1e3,
        "main_path_spp": FINAL_SPP,
    }, {
        "name": "render_kernel_bvh", "route": "cuda",
        "source": "rust_tracing_tpu_torch/csrc/render_kernel.cu",
        "replaces": "rust_tracing_tpu/ops/megakernel.py:738",
        "launches": final["fused_launches"]["render_kernel"],
        "max_abs_err": at_final["max_abs_err"],
        "ms": at_final["kernel_ms"], "plain_ms": at_final["plain_ms"],
        "bound_ms": at_final["bound_ms"], "bound_by": at_final["bound_by"],
        "library_ms": None,
        "shape": "render_kernel<noise,image,BVH> (B1+B4+B8): final_scene "
                 "200x200 spp 4 depth 40 (its depth, frame and spp cut for "
                 "the plain version); launches from the fused 800x800 "
                 f"render; brute loop at this shape "
                 f"{cross['final_scene']['brute_ms']:.3f} ms",
        "walk_per_ray": at_final["walk_per_ray"],
        "main_path_ms": final["fused_seconds"] * 1e3,
        "main_path_spp": FINAL_SPP,
        "main_path_kernel_ms": final["fused_kernel_ms"],
        "main_path_bound_ms": final["fused_bound_ms"],
        "main_path_walk_per_ray": final["fused_walk_per_ray"],
        "main_path_vs_brute": final["fused_vs_brute"],
        "occupancy": final["fused_occupancy"],
    }, {
        "name": "render_kernel_sharded", "route": "cuda",
        "source": "rust_tracing_tpu_torch/csrc/render_kernel.cu",
        "replaces": "rust_tracing_tpu/ops/megakernel.py:1382",
        "launches": dist_res["a"]["launches"]["render_kernel"],
        "max_abs_err": dist_res["a"]["b1"]["max_abs_err"],
        "ms": dist_res["a"]["b1"]["ms"],
        "plain_ms": dist_res["a"]["b1"]["plain_ms"],
        "bound_ms": dist_res["a"]["b1"]["bound_ms"],
        "bound_by": dist_res["a"]["b1"]["bound_by"],
        "library_ms": None,
        "shape": f"megakernel.render_fast_sharded on a 1x1 mesh (NCCL, "
                 f"world 1): cornell_box 600x600 depth 8 spp {DIST_B1_SPP}, "
                 "the rank's share = the frame; ms includes the all-reduce "
                 "and the copy to the host; launches from render_distributed "
                 f"at {dist_res['a']['spp']} spp; 2x1 and 2x2 on one shared "
                 "card launched 1 a rank (correctness runs, no scaling)",
        "main_path_ms": dist_res["a"]["seconds"] * 1e3,
        "main_path_spp": dist_res["a"]["spp"],
        "main_path_bound_ms": dist_res["a"]["bound_ms"],
        "launches_by_rank_2x1": [r["launches"]["render_kernel"]
                                 for r in dist_res["two"]],
        "launches_by_rank_2x2": [r["launches"]["render_kernel"]
                                 for r in dist_res["four"]],
    }] + probe_entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
