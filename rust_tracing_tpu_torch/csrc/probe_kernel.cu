// Hardware probes for Hopper (sm_90a), written by hand: the counterparts of
// the seven Pallas probes of scripts/tpu_probe.py (P1-P7), which ask where a
// scene table should live and what a sphere test costs. Host side and plain
// versions: rust_tracing_tpu_torch/probes.py.
//
// On the TPU the question was SMEM scalars vs VMEM rows vs immediates vs the
// MXU. On this card a table that every thread of a warp reads at the same
// index can live in
//   - __constant__ memory (64 KB, c_tab below): one broadcast a warp from
//     the constant cache;
//   - shared memory (up to 227 KB a block), staged by each block first;
//   - global memory through the read-only path (__ldg), cached in L1/L2;
//   - the instruction stream, as immediates of a kernel compiled for one
//     scene (P6).
// Each kernel computes the reference probe's function. P1 and P2 run the
// TPU's shape: one fold a tile, by one warp (the reference's fori_loop on
// the scalar core), then the tile's 1024 outputs written as 8 float4 stores
// a lane; blocks of FOLD_WARPS warps take tiles in a grid-stride loop, and
// a shared table is staged once a block. P3, P4: one thread a (8, 128) tile
// element, a warp 32 elements of a tile; blocks of GATHER_WARPS warps take
// them in a grid-stride loop, and a shared table is staged once a block.
// P5-P7: one thread a ray (P7's TF32 variant one warp per 32 rays). What
// bounds each:
//   P1, P2  n dependent adds a tile, in index order (a chain: n times the
//           add's latency), with the loads a batch ahead; where a space's
//           loads take longer than a batch's adds (__ldg, __constant__),
//           the chain waits for them. P2 also reads its 512-byte rows whole;
//   P3, P4  shared memory's wavefronts, one a clock an SM: a warp's gather
//           takes one (P4; P3 at stride 13) or as many as its lanes' bank
//           conflicts (P3 at strides 2, 16, 32), one LDS and one FADD a
//           gather from a staged copy with no wrap; the __ldg variants are
//           bound by L1's gathers (their floor counts the adds' issue and
//           the bytes);
//   P5, P6  25 f32 operations a sphere test, each an instruction of its
//           own (no contraction): the lanes' issue; a sphere is one
//           16-byte read (P5), and its test has no slow path for a miss;
//   P7      two 8-term products a (ray, sphere) on CUDA cores (f32 variant:
//           30 operations, the lanes' issue) or tensor cores (TF32 variant:
//           its epilogue's issue), and the epilogue, one division a ray a
//           round and no slow path for a miss.
//
// Built like every source here with --fmad=false and without fast math:
// the sphere tests do the reference's f32 operations in its order, with
// IEEE sqrtf and division (P7: the division's threshold, exact), so they
// equal the plain versions bit for bit.
// The TF32 variant of P7 is the one exception by design: its products are
// tf32 and are held to a derived tolerance (probes.py TF32_PROD_RTOL).
//
// c_tab is one __constant__ buffer shared by P1 and P5: the wrapper copies
// the table into it on the launch stream before the kernel (launches on one
// stream are ordered; two streams launching these probes concurrently would
// race on it).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int TILE = 1024;           // one (8, 128) tile
constexpr int LANES = 128;
constexpr int GATHER_N = 256;
constexpr int CONST_FLOATS = 16384;  // 64 KB
constexpr int SHARED_MAX_BYTES = 232448;
constexpr int SPACE_CONSTANT = 0, SPACE_SHARED = 1, SPACE_GLOBAL = 2;
constexpr int MXU_K = 8;
constexpr int MXU_F32_THREADS = 256;
constexpr int MXU_TC_WARPS = 4;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float NO_HIT = 1e30f;
constexpr int FOLD_WARPS = 8;        // P1/P2: warps a block, one tile a warp
constexpr int FOLD_THREADS = 32 * FOLD_WARPS;
constexpr int FOLD_QUADS = 8;        // P1: float4s a batch
constexpr int ROW_BATCH = 8;         // P2: rows a batch
constexpr int FOLD_DEPTH = 2;        // P1/P2: batches in registers at once

__constant__ __align__(16) float c_tab[CONST_FLOATS];

template <int SPACE>
__device__ __forceinline__ float tab_at(const float* __restrict__ g,
                                        const float* s, int i) {
    if (SPACE == SPACE_CONSTANT) return c_tab[i];
    if (SPACE == SPACE_SHARED) return s[i];
    return __ldg(g + i);
}

// ------------------------------------------------------------ P1 / P2
// Copy n floats of a 16-byte aligned global table into this block's shared
// memory, 16 bytes a load, the tail by scalars. The stride is a constant
// (blocks of THREADS), so the compiler unrolls the copy and keeps several
// loads in flight.
template <int THREADS>
__device__ __forceinline__ void stage4(float4* s, const float* __restrict__ g,
                                       int n) {
    const float4* g4 = reinterpret_cast<const float4*>(g);
    for (int i = threadIdx.x; i < n / 4; i += THREADS)
        s[i] = __ldg(g4 + i);
    float* s1 = reinterpret_cast<float*>(s);
    for (int i = n / 4 * 4 + threadIdx.x; i < n; i += THREADS)
        s1[i] = __ldg(g + i);
    __syncthreads();
}

// Fill tile t's 1024 outputs with v: 8 coalesced float4 stores a lane.
__device__ __forceinline__ void fill_tile(float* __restrict__ out,
                                          long long t, float v, int lane) {
    float4* o = reinterpret_cast<float4*>(out + t * TILE);
    const float4 q = make_float4(v, v, v, v);
#pragma unroll
    for (int k = 0; k < TILE / 128; ++k) o[k * 32 + lane] = q;
}

// The folds of P1 and P2 take their table in batches of K float4s a lane
// through a ring of FOLD_DEPTH register buffers: batch b + FOLD_DEPTH - 1
// is loaded before batch b's adds, so that only the chain of adds waits.
// The loop has no branch around a load (a batch past the end is clamped to
// the last one and never added): the compiler moves a guarded load after
// the adds that follow it, and the chain then waits out a load's latency
// every batch. load(v, b) fills v with batch b; add(acc, v) adds it.
template <int K, typename Load, typename Add>
__device__ __forceinline__ float ring_fold(int batches, Load load, Add add) {
    float acc = 0.0f;
    if (batches == 0) return acc;
    const int last = batches - 1;
    float4 r[FOLD_DEPTH][K];
#pragma unroll
    for (int j = 0; j < FOLD_DEPTH - 1; ++j) load(r[j], min(j, last));
    int b = 0;
    for (; b + FOLD_DEPTH <= batches; b += FOLD_DEPTH) {
#pragma unroll
        for (int j = 0; j < FOLD_DEPTH; ++j) {
            load(r[(j + FOLD_DEPTH - 1) % FOLD_DEPTH],
                 min(b + j + FOLD_DEPTH - 1, last));
            add(acc, r[j]);
        }
    }
#pragma unroll
    for (int j = 0; j < FOLD_DEPTH - 1; ++j)
        if (b + j < batches) add(acc, r[j]);
    return acc;
}

// Batch b of P1's table: FOLD_QUADS float4s, the same address in every lane
// (one broadcast a load).
template <int SPACE>
__device__ __forceinline__ void load_quads(float4 (&v)[FOLD_QUADS],
                                           const float* __restrict__ g,
                                           const float4* s, int b) {
#pragma unroll
    for (int k = 0; k < FOLD_QUADS; ++k) {
        const int i = b * FOLD_QUADS + k;
        if (SPACE == SPACE_CONSTANT)
            v[k] = reinterpret_cast<const float4*>(c_tab)[i];
        else if (SPACE == SPACE_SHARED)
            v[k] = s[i];
        else
            v[k] = __ldg(reinterpret_cast<const float4*>(g) + i);
    }
}

__device__ __forceinline__ void add_quads(float& acc,
                                          const float4 (&v)[FOLD_QUADS]) {
#pragma unroll
    for (int k = 0; k < FOLD_QUADS; ++k) {
        acc += v[k].x;
        acc += v[k].y;
        acc += v[k].z;
        acc += v[k].w;
    }
}

// P1's fold: acc = +0.0f, acc += tab[i] for i = 0 .. n-1, the reference's
// order; whole batches through the ring, the tail by scalars.
template <int SPACE>
__device__ __forceinline__ float fold(const float* __restrict__ g,
                                      const float4* s, int n) {
    const int batches = n / (4 * FOLD_QUADS);
    float acc = ring_fold<FOLD_QUADS>(
        batches,
        [&](float4 (&v)[FOLD_QUADS], int b) { load_quads<SPACE>(v, g, s, b); },
        [](float& a, const float4 (&v)[FOLD_QUADS]) { add_quads(a, v); });
    const float* s1 = reinterpret_cast<const float*>(s);
    for (int i = batches * 4 * FOLD_QUADS; i < n; ++i)
        acc += tab_at<SPACE>(g, s1, i);
    return acc;
}

// P1: each warp folds tab[0..n) for its tiles (the reference's fori_loop
// over SMEM scalars) and fills them with the sum.
template <int SPACE>
__global__ void __launch_bounds__(FOLD_THREADS, 1)
    smem_scalar_kernel(const float* __restrict__ tab, int n,
                       float* __restrict__ out, long long tiles) {
    extern __shared__ float4 s_quads[];
    if (SPACE == SPACE_SHARED) stage4<FOLD_THREADS>(s_quads, tab, n);
    const int lane = threadIdx.x & 31;
    const long long warps = (long long)gridDim.x * FOLD_WARPS;
    for (long long t = (long long)blockIdx.x * FOLD_WARPS + threadIdx.x / 32;
         t < tiles; t += warps)
        fill_tile(out, t, fold<SPACE>(tab, s_quads, n), lane);
}

// 16-byte loads that the compiler may not narrow: the probe measures the
// whole row read.
__device__ __forceinline__ float4 ld_global_v4(const float4* p) {
    float4 v;
    asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "l"(p)
                 : "memory");
    return v;
}

__device__ __forceinline__ float4 ld_shared_v4(const float4* p) {
    float4 v;
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "r"(a)
                 : "memory");
    return v;
}

// Lane `lane`'s float4 of row i of the (n, 128) table.
template <int SPACE>
__device__ __forceinline__ float4 row_at(const float4* g, const float4* s,
                                         int i, int lane) {
    const int k = i * (LANES / 4) + lane;
    return SPACE == SPACE_SHARED ? ld_shared_v4(s + k) : ld_global_v4(g + k);
}

// Batch b of P2's rows: ROW_BATCH rows, whole, one float4 a lane.
template <int SPACE>
__device__ __forceinline__ void load_rows(float4 (&v)[ROW_BATCH],
                                          const float4* g, const float4* s,
                                          int b, int lane) {
#pragma unroll
    for (int k = 0; k < ROW_BATCH; ++k)
        v[k] = row_at<SPACE>(g, s, b * ROW_BATCH + k, lane);
}

// Each row's tab[i, 0] is lane 0's x: broadcast it to the warp, add it.
__device__ __forceinline__ void add_rows(float& acc,
                                         const float4 (&v)[ROW_BATCH]) {
    float x[ROW_BATCH];
#pragma unroll
    for (int k = 0; k < ROW_BATCH; ++k)
        x[k] = __shfl_sync(FULL_MASK, v[k].x, 0);
#pragma unroll
    for (int k = 0; k < ROW_BATCH; ++k) acc += x[k];
}

// P2's fold: step i reads row i whole and adds tab[i, 0], i = 0 .. n-1 from
// acc = +0.0f (the reference's (1, 128) VMEM row read and [0, 0]
// broadcast); whole batches through the ring, the tail row by row.
template <int SPACE>
__device__ __forceinline__ float row_fold(const float4* g, const float4* s,
                                          int n, int lane) {
    const int batches = n / ROW_BATCH;
    float acc = ring_fold<ROW_BATCH>(
        batches,
        [&](float4 (&v)[ROW_BATCH], int b) {
            load_rows<SPACE>(v, g, s, b, lane);
        },
        [](float& a, const float4 (&v)[ROW_BATCH]) { add_rows(a, v); });
    for (int i = batches * ROW_BATCH; i < n; ++i)
        acc += __shfl_sync(FULL_MASK, row_at<SPACE>(g, s, i, lane).x, 0);
    return acc;
}

// P2: each warp folds the rows for its tiles and fills them with the sum.
template <int SPACE>
__global__ void __launch_bounds__(FOLD_THREADS, 1)
    row_broadcast_kernel(const float* __restrict__ tab, int n,
                         float* __restrict__ out, long long tiles) {
    extern __shared__ float4 s_rows[];
    if (SPACE == SPACE_SHARED) stage4<FOLD_THREADS>(s_rows, tab, n * LANES);
    const float4* rows = reinterpret_cast<const float4*>(tab);
    const int lane = threadIdx.x & 31;
    const long long warps = (long long)gridDim.x * FOLD_WARPS;
    for (long long t = (long long)blockIdx.x * FOLD_WARPS + threadIdx.x / 32;
         t < tiles; t += warps)
        fill_tile(out, t, row_fold<SPACE>(rows, s_rows, n, lane), lane);
}

// ------------------------------------------------------------- P3 / P4
// Element (r, l) of a tile gathers at idx = (7 r + stride l) % 256 (the
// reference's index, stride 13); with reps > 1 it adds the gathers at
// idx, idx + 1, ... (mod 256) in order, so that the gathers, and the bank
// conflicts of a stride, and not the launch, are what is timed. Over 32
// banks a warp's lanes hit distinct banks at stride 13; stride 2 gives
// 2-way, 16 and 32 give 8-way conflicts on the 256-entry shared column.
//
// Blocks of GATHER_WARPS warps, only as many as fit the card at once, each
// stage their table once, then take units of work in a grid-stride loop:
// a unit is 32 consecutive elements of one tile (one row's 32 lanes, as a
// warp of a one-tile block had them, so a warp's bank conflicts are the
// stride's). Unit u goes to warp u % W of the grid's W warps, counted
// across the blocks first, so every block, and every SM, gets nearly as
// many units (1024 tiles do not divide over 132 SMs; 32 768 units nearly
// do). The staged copy is the table followed by its first MAX_GATHERS - 1
// entries (rows) again: the gather at offset k reads s[base + k] with no
// wrap, unrolled one LDS at an immediate offset and one FADD.
constexpr int MAX_GATHERS = 64;
constexpr int GATHER_WARPS = 32;
constexpr int GATHER_THREADS = 32 * GATHER_WARPS;
constexpr int UNIT_LANES = 32;                 // elements a unit
constexpr int UNITS_A_TILE = TILE / UNIT_LANES;
constexpr unsigned GATHER_MASK = GATHER_N - 1;  // % 256 of an unsigned
constexpr unsigned P4_STRIDE = 13;

// This lane's element of unit u: tile u / 32, element (u % 32) * 32 +
// lane, so its output is out[32 u + lane]. Its lane l and index base
// (7 r + stride l) % 256, in unsigned arithmetic.
__device__ __forceinline__ unsigned unit_lane(unsigned u) {
    return (u % (LANES / UNIT_LANES)) * UNIT_LANES + threadIdx.x % 32;
}

__device__ __forceinline__ unsigned unit_base(unsigned u, unsigned stride) {
    const unsigned r = u % UNITS_A_TILE / (LANES / UNIT_LANES);
    return (7u * r + stride * unit_lane(u)) & GATHER_MASK;
}

// read(0) + read(1) + ... in order: REPS gathers unrolled, or `reps` at
// run time where REPS is 0.
template <int REPS, typename Read>
__device__ __forceinline__ float gather_sum(Read read, int reps) {
    float acc = read(0);
    if (REPS > 0) {
#pragma unroll
        for (int k = 1; k < REPS; ++k) acc += read(k);
    } else {
        for (int k = 1; k < reps; ++k) acc += read(k);
    }
    return acc;
}

// P3: column 0 of the (256, 128) table; shared stages that column and its
// first MAX_GATHERS - 1 entries again.
template <int SPACE, int REPS>
__global__ void __launch_bounds__(GATHER_THREADS)
    gather_probe_kernel(const float* __restrict__ tab, unsigned stride,
                        int reps, float* __restrict__ out, unsigned units) {
    __shared__ float s_col[GATHER_N + MAX_GATHERS - 1];
    if (SPACE == SPACE_SHARED) {
        for (int i = threadIdx.x; i < GATHER_N + MAX_GATHERS - 1;
             i += GATHER_THREADS)
            s_col[i] = __ldg(tab + (i & GATHER_MASK) * LANES);
        __syncthreads();
    }
    const unsigned warps = gridDim.x * GATHER_WARPS;
    for (unsigned u = threadIdx.x / 32 * gridDim.x + blockIdx.x; u < units;
         u += warps) {
        const unsigned base = unit_base(u, stride);
        float acc;
        if (SPACE == SPACE_SHARED) {
            const float* p = s_col + base;
            acc = gather_sum<REPS>([&](int k) { return p[k]; }, reps);
        } else {
            acc = gather_sum<REPS>([&](int k) {
                return __ldg(tab + ((base + k) & GATHER_MASK) * LANES);
            }, reps);
        }
        out[(size_t)u * UNIT_LANES + threadIdx.x % 32] = acc;
    }
}

// Copy `rows` rows (256 <= rows < 256 + MAX_GATHERS) of the (256, 128)
// table into shared memory, row i from row i % 256, by 16-byte __ldg
// loads, ~10 a thread in flight (one bulk copy of the Tensor Memory
// Accelerator for the block, completed on an mbarrier, measured 3 us
// slower a call on an H100).
__device__ __forceinline__ void stage_rows(float* s,
                                           const float* __restrict__ g,
                                           int rows) {
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* s4 = reinterpret_cast<float4*>(s);
    const int quads = GATHER_N * LANES / 4;
    for (int i = threadIdx.x; i < rows * (LANES / 4); i += GATHER_THREADS)
        s4[i] = __ldg(g4 + (i & (quads - 1)));
    __syncthreads();
}

// P4: take_along_axis down each lane's own column of the whole table;
// shared stages all of it (128 KB) and its first reps - 1 rows again. Lane
// l reads bank l % 32 whatever the row: conflict-free.
template <int SPACE, int REPS>
__global__ void __launch_bounds__(GATHER_THREADS)
    gather_2d_kernel(const float* __restrict__ tab, int reps,
                     float* __restrict__ out, unsigned units) {
    extern __shared__ float4 s_table[];  // 16-byte aligned
    float* s_tab = reinterpret_cast<float*>(s_table);
    if (SPACE == SPACE_SHARED) stage_rows(s_tab, tab, GATHER_N + reps - 1);
    const unsigned warps = gridDim.x * GATHER_WARPS;
    for (unsigned u = threadIdx.x / 32 * gridDim.x + blockIdx.x; u < units;
         u += warps) {
        const unsigned l = unit_lane(u), base = unit_base(u, P4_STRIDE);
        float acc;
        if (SPACE == SPACE_SHARED) {
            const float* p = s_tab + base * LANES + l;
            acc = gather_sum<REPS>([&](int k) { return p[k * LANES]; }, reps);
        } else {
            const float* g = tab + l;
            acc = gather_sum<REPS>([&](int k) {
                return __ldg(g + ((base + k) & GATHER_MASK) * LANES);
            }, reps);
        }
        out[(size_t)u * UNIT_LANES + threadIdx.x % 32] = acc;
    }
}

// ------------------------------------------------------------- P5 / P6
// The rounds of P5-P7 are identical, so nvcc would hoist each round's
// sphere tests (which do not depend on the running minimum) out of the
// round loop, or keep them across rounds in spilled registers, and time
// something else than reps rounds of tests. An empty asm that "changes" a
// round's inputs keeps every round's tests in it; it costs no instruction.
__device__ __forceinline__ void launder(float& x) {
    asm volatile("" : "+f"(x));
}
__device__ __forceinline__ void launder(uint32_t& x) {
    asm volatile("" : "+r"(x));
}

// One ray of P5/P6: origin, direction and a = d . d.
struct Ray {
    float ox, oy, oz, dx, dy, dz, a;
};

// Ray g of the (3, R) component planes o and d.
__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d,
                                        long long R, long long g) {
    Ray r;
    r.ox = o[g], r.oy = o[R + g], r.oz = o[2 * R + g];
    r.dx = d[g], r.dy = d[R + g], r.dz = d[2 * R + g];
    r.a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
    return r;
}

__device__ __forceinline__ void launder(Ray& r) {
    launder(r.ox), launder(r.oy), launder(r.oz);
    launder(r.dx), launder(r.dy), launder(r.dz), launder(r.a);
}

// P5/P6's launch and windows, chosen by measurement (PERF.md, Findings):
// blocks of 1024 threads (256 were 3-12 % slower); P5's __constant__ loop
// and P6's unrolled code are read by a block's warps together, a window of
// CONST_WINDOW spheres or CODE_WINDOW tests between two barriers. The card's
// constant cache nearest the SM holds 2 KB (34 clocks a read; 104 past it):
// warps that drift apart over P5's 4 KB table miss it on nearly every read
// (112 ms against 24.1 with the barriers). P6's round is 53 KB of code at
// S = 64 and 204 KB at S = 256, which the instruction cache does not hold:
// without the barriers S = 256 ran 13 % slower a test than S = 64.
constexpr int SPHERE_THREADS = 1024;
constexpr int CONST_WINDOW = 32;
constexpr int CODE_WINDOW = 32;

// One sphere test of the reference's loop (scripts/tpu_probe.py
// sphere_loop_smem) on sphere s = (cx, cy, cz, r2), its operations in its
// order. A miss's t is never used (ok needs disc > 0), so where disc <= 0
// the root is taken of 1.0f instead of the reference's max(disc, 0) = +0:
// IEEE sqrtf leaves its fast path through a called subroutine for +0 and
// for subnormals, and in a warp whose lanes mostly miss (95 % of the
// sweep's pairs) every test would run both paths. Each positive disc keeps
// its own root (a subnormal one by the slow path, as before), so every hit's
// t, and the result, are the reference's bit for bit. With VOTE a warp
// none of whose lanes has disc > 0 skips the root, the division and the
// compares (a third of the sweep's (warp, sphere) pairs at S = 256); the
// warp must be whole. P6's straight-line code runs slower with the vote.
template <bool VOTE>
__device__ __forceinline__ float sphere_step(const Ray& r, const float4 s,
                                             float tbest) {
    const float ocx = r.ox - s.x, ocy = r.oy - s.y, ocz = r.oz - s.z;
    const float hb = ocx * r.dx + ocy * r.dy + ocz * r.dz;
    const float c = ocx * ocx + ocy * ocy + ocz * ocz - s.w;
    const float disc = hb * hb - r.a * c;
    const bool pos = disc > 0.0f;
    if (VOTE && !__any_sync(FULL_MASK, pos)) return tbest;
    const float t = (-hb - sqrtf(pos ? disc : 1.0f)) / r.a;
    return (pos && t > 1e-3f && t < tbest) ? t : tbest;
}

// Sphere i of P5's table, one 16-byte read from SPACE.
template <int SPACE>
__device__ __forceinline__ float4 sphere_at(const float4* __restrict__ g,
                                            const float4* s, int i) {
    if (SPACE == SPACE_CONSTANT)
        return reinterpret_cast<const float4*>(c_tab)[i];
    if (SPACE == SPACE_SHARED) return s[i];
    return __ldg(g + i);
}

// P5: one thread a ray; S spheres (cx, cy, cz, r2) read from SPACE, a
// sphere a float4, reps rounds. o and d are (3, R) component planes. Every
// lane of a block runs the loop (a lane past R repeats ray R - 1 and writes
// nothing), so the warps stay whole for the vote and the barriers.
template <int SPACE>
__global__ void __launch_bounds__(SPHERE_THREADS)
    sphere_loop_kernel(const float* __restrict__ sph, int S,
                       const float* __restrict__ o,
                       const float* __restrict__ d, long long R, int reps,
                       float* __restrict__ out) {
    extern __shared__ float4 s_sph[];
    if (SPACE == SPACE_SHARED) stage4<SPHERE_THREADS>(s_sph, sph, 4 * S);
    const float4* g4 = reinterpret_cast<const float4*>(sph);
    const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    Ray r = load_ray(o, d, R, g < R ? g : R - 1);
    float tbest = NO_HIT;
    for (int rep = 0; rep < reps; ++rep) {
        launder(r);
        if (SPACE == SPACE_CONSTANT) {
            for (int i0 = 0; i0 < S; i0 += CONST_WINDOW) {
                const int i1 = min(S, i0 + CONST_WINDOW);
#pragma unroll 8
                for (int i = i0; i < i1; ++i)
                    tbest = sphere_step<true>(
                        r, sphere_at<SPACE>(g4, s_sph, i), tbest);
                __syncthreads();
            }
        } else {
#pragma unroll 8
            for (int i = 0; i < S; ++i)
                tbest = sphere_step<true>(
                    r, sphere_at<SPACE>(g4, s_sph, i), tbest);
        }
    }
    if (g < R) out[g] = tbest;
}

// P6: the same loop with the S spheres compiled in. The sphere loop is
// unrolled, so every value float(k) * 0.01f is a constant that nvcc folds
// (round to nearest, as numpy's arange(4S, float32) * 0.01) and places in
// the instructions; a barrier every CODE_WINDOW tests.
template <int S>
__global__ void __launch_bounds__(SPHERE_THREADS)
    sphere_immediate_kernel(const float* __restrict__ o,
                            const float* __restrict__ d, long long R,
                            int reps, float* __restrict__ out) {
    const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    Ray r = load_ray(o, d, R, g < R ? g : R - 1);
    float tbest = NO_HIT;
#pragma unroll 1
    for (int rep = 0; rep < reps; ++rep) {
        launder(r);
#pragma unroll
        for (int i = 0; i < S; ++i) {
            tbest = sphere_step<false>(r,
                                       make_float4(float(4 * i) * 0.01f,
                                                   float(4 * i + 1) * 0.01f,
                                                   float(4 * i + 2) * 0.01f,
                                                   float(4 * i + 3) * 0.01f),
                                       tbest);
            if ((i + 1) % CODE_WINDOW == 0 && i + 1 < S) __syncthreads();
        }
    }
    if (g < R) out[g] = tbest;
}

// ------------------------------------------------------------------- P7
// The reference's placeholder algebra on the two products hd = d . cm_j and
// ho = o . cm_j: c = o2 - 2 ho + c2, disc = hd hd - a c, t = (-hd -
// sqrt(max(disc, 0))) / a, a hit where disc > 0 and t > 1e-3f, the least t
// of a round kept. Both kernels divide once a ray a round instead of once a
// pair: IEEE division by a >= 0 is monotone in the numerator, so with num =
// -hd - root, t > 1e-3f iff num >= thr, the least float whose quotient by a
// exceeds 1e-3f (hit_threshold; probes.py mxu_threshold_np), and the least
// t is the least num over the hits divided by a: every ray's t the plain
// version's, bit for bit. The root is taken of disc > 0 ? disc : 1 (IEEE
// sqrtf of +0 leaves its fast path by a called subroutine, and ~90 % of the
// sweep's pairs have disc <= 0; a miss's root is never used). num <= -hd,
// so disc > 0 && -hd >= thr is needed for a hit and known before the root;
// a warp vote on it that skips the root measured as fast (f32) and 2 %
// slower (TF32) (PERF.md, Findings), so every pair takes the root.
constexpr int THRESHOLD_STEPS = 4;  // numpy, 7 M values of a: at most 2
                                    // steps up, none down

// The least float x with x / a > 1e-3f (IEEE division), from 1e-3f * a: down
// while the float below still exceeds, then up until one does; NaN where no
// float does (a = +inf or NaN), so that no num passes.
__device__ __forceinline__ float hit_threshold(float a) {
    const float inf = __int_as_float(0x7f800000);
    float x = 1e-3f * a;
    for (int i = 0; i < THRESHOLD_STEPS; ++i) {
        const float below = nextafterf(x, -inf);
        if (!(__fdiv_rn(below, a) > 1e-3f)) break;
        x = below;
    }
    for (int i = 0; i < THRESHOLD_STEPS && !(__fdiv_rn(x, a) > 1e-3f); ++i)
        x = nextafterf(x, inf);
    return __fdiv_rn(x, a) > 1e-3f ? x : __int_as_float(0x7fffffff);
}

// One (ray, sphere) pair: best, the least num of the round's hits so far,
// updated.
__device__ __forceinline__ float mxu_step(float hd, float ho, float a,
                                          float o2, float c2, float thr,
                                          float best) {
    const float c = o2 - 2.0f * ho + c2;
    const float disc = hd * hd - a * c;
    const float num = -hd - sqrtf(disc > 0.0f ? disc : 1.0f);
    return (disc > 0.0f && num >= thr) ? fminf(best, num) : best;
}

// Sum over k of x[k] * y[k * stride] in index order, from the first product.
__device__ __forceinline__ float dot8(const float* __restrict__ x,
                                      const float* y, int stride) {
    float acc = x[0] * y[0];
#pragma unroll
    for (int k = 1; k < MXU_K; ++k) acc = acc + x[k] * y[k * stride];
    return acc;
}

// The TF32 kernel's A tiles a warp: two, so that one B fragment feeds 4
// mma (one tile a warp measured 10 % slower; PERF.md, Findings).
constexpr int MXU_TC_TILES = 2;

// f32 variant: one thread a ray, both products on the CUDA cores in index
// order. Each block stages the table sphere-major, three 16-byte rows a
// sphere (cm[0..3][j], cm[4..7][j], (c2[j], 0, 0, 0)), read by three
// warp-uniform LDS.128 a pair.
__global__ void __launch_bounds__(MXU_F32_THREADS)
    sphere_mxu_f32_kernel(const float* __restrict__ cm,
                          const float* __restrict__ r2, int S,
                          const float* __restrict__ o,
                          const float* __restrict__ d, long long R, int reps,
                          float* __restrict__ out) {
    extern __shared__ float4 s_sph[];
    for (int j = threadIdx.x; j < S; j += blockDim.x) {
        float v[MXU_K];
#pragma unroll
        for (int k = 0; k < MXU_K; ++k) v[k] = __ldg(cm + k * S + j);
        s_sph[3 * j] = make_float4(v[0], v[1], v[2], v[3]);
        s_sph[3 * j + 1] = make_float4(v[4], v[5], v[6], v[7]);
        s_sph[3 * j + 2] = make_float4(__ldg(r2 + j), 0.0f, 0.0f, 0.0f);
    }
    __syncthreads();
    const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= R) return;
    float dr[MXU_K], orow[MXU_K];
#pragma unroll
    for (int k = 0; k < MXU_K; ++k) {
        dr[k] = __ldg(d + g * MXU_K + k);
        orow[k] = __ldg(o + g * MXU_K + k);
    }
    float a = dot8(dr, dr, 1), o2 = dot8(orow, orow, 1);
    float tmin = NO_HIT;
    for (int r = 0; r < reps; ++r) {
#pragma unroll
        for (int k = 0; k < MXU_K; ++k) launder(dr[k]), launder(orow[k]);
        launder(a), launder(o2);
        const float thr = hit_threshold(a);
        float best = __int_as_float(0x7f800000);
#pragma unroll 4
        for (int j = 0; j < S; ++j) {
            const float4 p = s_sph[3 * j], q = s_sph[3 * j + 1];
            const float cj[MXU_K] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
            best = mxu_step(dot8(dr, cj, 1), dot8(orow, cj, 1), a, o2,
                            s_sph[3 * j + 2].x, thr, best);
        }
        tmin = fminf(tmin, best / a);
    }
    out[g] = tmin;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

// D = A (16x8, row) * B (8x8, col), tf32 inputs, f32 accumulate from 0.
__device__ __forceinline__ void mma_tf32(float (&dd)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %11, %12, %13};"
        : "=f"(dd[0]), "=f"(dd[1]), "=f"(dd[2]), "=f"(dd[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
          "f"(0.0f), "f"(0.0f), "f"(0.0f), "f"(0.0f));
}

// TF32 variant: one warp per MXU_TC_TILES tiles of 16 rays. The m16n8k8
// fragments (PTX ISA): with gid = lane / 4 and tig = lane % 4, A holds (row
// gid | gid + 8, col tig | tig + 4), B holds (row tig | tig + 4, col gid), D
// holds (row gid | gid + 8, col 2 tig | 2 tig + 1). The rays' d and o rows
// are the A tiles (loaded once); each block stages cm once, rounded to tf32
// and in the B fragment's order (step s, lane l: (cm[tig][8 s + gid],
// cm[tig + 4][8 s + gid]), one conflict-free 64-bit read a step), and c2 as
// pairs (the thread's two columns, one 64-bit read). The epilogue runs on
// the four D elements a thread holds of each tile; the quad of threads
// sharing a row takes the least num by shuffles, then divides once. A row
// past R repeats row R - 1 and is not written. PRODS writes the first
// round's products, (2, R, S).
template <bool PRODS>
__global__ void __launch_bounds__(32 * MXU_TC_WARPS)
    sphere_mxu_tc_kernel(const float* __restrict__ cm,
                         const float* __restrict__ r2, int S,
                         const float* __restrict__ o,
                         const float* __restrict__ d, long long R, int reps,
                         float* __restrict__ out, float* __restrict__ prods) {
    extern __shared__ uint2 s_b[];
    float2* s_c2 = reinterpret_cast<float2*>(s_b + 4 * S);
    for (int i = threadIdx.x; i < 4 * S; i += blockDim.x) {
        const int col = (i >> 5) * 8 + ((i & 31) >> 2), k = i & 3;
        s_b[i] = make_uint2(to_tf32(__ldg(cm + k * S + col)),
                            to_tf32(__ldg(cm + (k + 4) * S + col)));
    }
    for (int i = threadIdx.x; i < S / 2; i += blockDim.x)
        s_c2[i] = make_float2(__ldg(r2 + 2 * i), __ldg(r2 + 2 * i + 1));
    __syncthreads();
    constexpr int T = MXU_TC_TILES;
    const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
    const long long base =
        ((long long)blockIdx.x * MXU_TC_WARPS + (threadIdx.x >> 5)) * 16 * T;
    if (base >= R) return;
    long long rows[T][2];
    uint32_t ad[T][4], ao[T][4];
    float a[T][2], o2[T][2], tmin[T][2];
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            rows[t][h] = base + 16 * t + 8 * h + gid;
            const long long r = rows[t][h] < R ? rows[t][h] : R - 1;
            float dr[MXU_K], orow[MXU_K];
#pragma unroll
            for (int k = 0; k < MXU_K; ++k) {
                dr[k] = __ldg(d + r * MXU_K + k);
                orow[k] = __ldg(o + r * MXU_K + k);
            }
            a[t][h] = dot8(dr, dr, 1);
            o2[t][h] = dot8(orow, orow, 1);
            tmin[t][h] = NO_HIT;
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                ad[t][h + 2 * q] = to_tf32(dr[tig + 4 * q]);
                ao[t][h + 2 * q] = to_tf32(orow[tig + 4 * q]);
            }
        }
    }
    for (int rep = 0; rep < reps; ++rep) {
        float thr[T][2], best[T][2];
#pragma unroll
        for (int t = 0; t < T; ++t) {
#pragma unroll
            for (int i = 0; i < 4; ++i) launder(ad[t][i]), launder(ao[t][i]);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                launder(a[t][h]), launder(o2[t][h]);
                thr[t][h] = hit_threshold(a[t][h]);
                best[t][h] = __int_as_float(0x7f800000);
            }
        }
        for (int s = 0; s < S / 8; ++s) {
            const uint2 bb = s_b[32 * s + lane];
            const uint32_t b[2] = {bb.x, bb.y};
            const float2 c2 = s_c2[4 * s + tig];
#pragma unroll
            for (int t = 0; t < T; ++t) {
                float hd[4], ho[4];
                mma_tf32(hd, ad[t], b);
                mma_tf32(ho, ao[t], b);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int h = e >> 1;
                    if (PRODS && rep == 0 && rows[t][h] < R) {
                        const long long col = 8 * s + 2 * tig + (e & 1);
                        prods[rows[t][h] * S + col] = hd[e];
                        prods[(R + rows[t][h]) * S + col] = ho[e];
                    }
                    best[t][h] = mxu_step(hd[e], ho[e], a[t][h], o2[t][h],
                                          e & 1 ? c2.y : c2.x, thr[t][h],
                                          best[t][h]);
                }
            }
        }
#pragma unroll
        for (int t = 0; t < T; ++t) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                float v = best[t][h];
                v = fminf(v, __shfl_xor_sync(FULL_MASK, v, 1));
                v = fminf(v, __shfl_xor_sync(FULL_MASK, v, 2));
                tmin[t][h] = fminf(tmin[t][h], v / a[t][h]);
            }
        }
    }
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h)
            if (tig == 0 && rows[t][h] < R) out[rows[t][h]] = tmin[t][h];
}

// --------------------------------------------------------------- launch
int blocks_of(long long n, int per_block) {
    return (int)((n + per_block - 1) / per_block);
}

template <typename K>
cudaError_t allow_shared(K kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}

// Place a table for `space`: __constant__ gets a copy on the stream.
cudaError_t place(int space, const void* tab, int n, size_t* smem,
                  cudaStream_t st) {
    *smem = 0;
    if (space == SPACE_CONSTANT) {
        if (n > CONST_FLOATS) return cudaErrorInvalidValue;
        return cudaMemcpyToSymbolAsync(c_tab, tab, (size_t)n * sizeof(float),
                                       0, cudaMemcpyDeviceToDevice, st);
    }
    if (space == SPACE_SHARED) {
        *smem = (size_t)n * sizeof(float);
        if (*smem > (size_t)SHARED_MAX_BYTES) return cudaErrorInvalidValue;
        return cudaSuccess;
    }
    return space == SPACE_GLOBAL ? cudaSuccess : cudaErrorInvalidValue;
}

#define RT_TRY(expr)                           \
    do {                                       \
        const cudaError_t e_ = (expr);         \
        if (e_ != cudaSuccess) return (int)e_; \
    } while (0)

int sm_count() {
    static int n = 0;
    if (n == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    }
    return n;
}

// The blocks of `threads` threads with `smem` bytes each that fit the card
// at once, for kernel K: the occupancy API's blocks an SM x SMs, asked
// again only when smem changes.
template <auto K>
cudaError_t fit_blocks(int threads, size_t smem, long long* fit) {
    static long long n = 0;
    static size_t n_smem = 0;
    cudaError_t e = allow_shared(K, smem);
    if (e != cudaSuccess) return e;
    if (n == 0 || n_smem != smem) {
        int per_sm = 0;
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, K, threads,
                                                          smem);
        if (e != cudaSuccess) return e;
        n = (long long)sm_count() * (per_sm > 0 ? per_sm : 1);
        n_smem = smem;
    }
    *fit = n;
    return cudaSuccess;
}

// Blocks of `warps` warps for `work` warps' worth of work: no more than
// fit at once, past which the warps stride over it.
template <auto K>
cudaError_t grid_for(long long work, int warps, size_t smem, int* nb) {
    long long fit;
    const cudaError_t e = fit_blocks<K>(32 * warps, smem, &fit);
    if (e != cudaSuccess) return e;
    const long long want = (work + warps - 1) / warps;
    *nb = (int)(want < fit ? want : fit);
    return cudaSuccess;
}

// Launch fold kernel K (P1, P2) for `tiles` tiles: one warp a tile.
template <auto K>
int launch_fold(const float* tab, int n, float* out, long long tiles,
                size_t smem, cudaStream_t st) {
    int nb;
    RT_TRY(grid_for<K>(tiles, FOLD_WARPS, smem, &nb));
    K<<<nb, FOLD_THREADS, smem, st>>>(tab, n, out, tiles);
    return (int)cudaGetLastError();
}

// P3/P4 take whole tiles, 32 elements a unit, and at most MAX_GATHERS
// gathers (the staged copy's extra entries); REPS = MAX_GATHERS is
// unrolled, any other count runs the loop.
bool gather_args_ok(int reps, int space, long long total) {
    return reps >= 1 && reps <= MAX_GATHERS && total >= 1
           && total % TILE == 0 && total / UNIT_LANES <= INT_MAX / 2
           && (space == SPACE_SHARED || space == SPACE_GLOBAL);
}

template <int SPACE, int REPS>
int launch_gather(const float* t, int stride, int reps, float* y,
                  long long units, cudaStream_t st) {
    int nb;
    RT_TRY((grid_for<gather_probe_kernel<SPACE, REPS>>(units, GATHER_WARPS,
                                                      0, &nb)));
    gather_probe_kernel<SPACE, REPS><<<nb, GATHER_THREADS, 0, st>>>(
        t, (unsigned)stride, reps, y, (unsigned)units);
    return (int)cudaGetLastError();
}

template <int SPACE, int REPS>
int launch_gather_2d(const float* t, int reps, float* y, long long units,
                     cudaStream_t st) {
    // shared: the table and its first reps - 1 rows again
    const size_t smem = SPACE == SPACE_SHARED
        ? (size_t)(GATHER_N + reps - 1) * LANES * sizeof(float) : 0;
    int nb;
    RT_TRY((grid_for<gather_2d_kernel<SPACE, REPS>>(units, GATHER_WARPS,
                                                   smem, &nb)));
    gather_2d_kernel<SPACE, REPS><<<nb, GATHER_THREADS, smem, st>>>(
        t, reps, y, (unsigned)units);
    return (int)cudaGetLastError();
}

// P1/P2 take whole tiles and a 16-byte aligned table (float4 loads).
bool fold_args_ok(const void* tab, int n, long long total) {
    return n >= 1 && total >= 1 && total % TILE == 0
           && reinterpret_cast<uintptr_t>(tab) % 16 == 0;
}

template <int SPACE>
int launch_sphere_loop(const float* sph, int S, const float* o,
                       const float* d, long long R, int reps, float* out,
                       size_t smem, cudaStream_t st) {
    RT_TRY(allow_shared(sphere_loop_kernel<SPACE>, smem));
    sphere_loop_kernel<SPACE>
        <<<blocks_of(R, SPHERE_THREADS), SPHERE_THREADS, smem, st>>>(
            sph, S, o, d, R, reps, out);
    return (int)cudaGetLastError();
}

}  // namespace

// P1: out (total,) = the index-order sum of tab[0..n), from `space`, in
// total / 1024 tiles.
extern "C" int rt_probe_smem_scalar_launch(const void* tab, int n, int space,
                                           void* out, long long total,
                                           void* stream) {
    if (!fold_args_ok(tab, n, total)) return (int)cudaErrorInvalidValue;
    (void)cudaGetLastError();
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    size_t smem;
    RT_TRY(place(space, tab, n, &smem, st));
    const float* t = static_cast<const float*>(tab);
    float* y = static_cast<float*>(out);
    const long long tiles = total / TILE;
    if (space == SPACE_CONSTANT)
        return launch_fold<smem_scalar_kernel<SPACE_CONSTANT>>(t, n, y, tiles,
                                                              smem, st);
    if (space == SPACE_SHARED)
        return launch_fold<smem_scalar_kernel<SPACE_SHARED>>(t, n, y, tiles,
                                                            smem, st);
    return launch_fold<smem_scalar_kernel<SPACE_GLOBAL>>(t, n, y, tiles, smem,
                                                        st);
}

// P2: out (total,) = sum of tab[i, 0] over the rows of an (n, 128) table,
// read as float4 rows from shared or global memory, in total / 1024 tiles.
extern "C" int rt_probe_row_broadcast_launch(const void* tab, int n,
                                             int space, void* out,
                                             long long total, void* stream) {
    if (!fold_args_ok(tab, n, total)
        || (space != SPACE_SHARED && space != SPACE_GLOBAL))
        return (int)cudaErrorInvalidValue;
    (void)cudaGetLastError();
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    size_t smem;
    RT_TRY(place(space, tab, n * LANES, &smem, st));
    const float* t = static_cast<const float*>(tab);
    float* y = static_cast<float*>(out);
    const long long tiles = total / TILE;
    if (space == SPACE_SHARED)
        return launch_fold<row_broadcast_kernel<SPACE_SHARED>>(t, n, y, tiles,
                                                              smem, st);
    return launch_fold<row_broadcast_kernel<SPACE_GLOBAL>>(t, n, y, tiles,
                                                          smem, st);
}

// P3: out (total,) = tab[idx, 0] of a (256, 128) table (summed over reps
// offsets), idx = (7 r + stride l) % 256, 0 <= stride < 256.
extern "C" int rt_probe_gather_launch(const void* tab, int stride, int reps,
                                      int space, void* out, long long total,
                                      void* stream) {
    if (!gather_args_ok(reps, space, total) || stride < 0
        || stride >= GATHER_N)
        return (int)cudaErrorInvalidValue;
    (void)cudaGetLastError();
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* t = static_cast<const float*>(tab);
    float* y = static_cast<float*>(out);
    const long long units = total / UNIT_LANES;
    if (space == SPACE_SHARED)
        return reps == MAX_GATHERS
            ? launch_gather<SPACE_SHARED, MAX_GATHERS>(t, stride, reps, y,
                                                       units, st)
            : launch_gather<SPACE_SHARED, 0>(t, stride, reps, y, units, st);
    return reps == MAX_GATHERS
        ? launch_gather<SPACE_GLOBAL, MAX_GATHERS>(t, stride, reps, y, units,
                                                   st)
        : launch_gather<SPACE_GLOBAL, 0>(t, stride, reps, y, units, st);
}

// P4: out (total,) = tab[idx, l] of a (256, 128) table (summed over reps
// offsets); the table 16-byte aligned (staged as float4s).
extern "C" int rt_probe_gather_2d_launch(const void* tab, int reps, int space,
                                         void* out, long long total,
                                         void* stream) {
    if (!gather_args_ok(reps, space, total)
        || reinterpret_cast<uintptr_t>(tab) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    (void)cudaGetLastError();
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* t = static_cast<const float*>(tab);
    float* y = static_cast<float*>(out);
    const long long units = total / UNIT_LANES;
    if (space == SPACE_SHARED)
        return reps == MAX_GATHERS
            ? launch_gather_2d<SPACE_SHARED, MAX_GATHERS>(t, reps, y, units,
                                                          st)
            : launch_gather_2d<SPACE_SHARED, 0>(t, reps, y, units, st);
    return reps == MAX_GATHERS
        ? launch_gather_2d<SPACE_GLOBAL, MAX_GATHERS>(t, reps, y, units, st)
        : launch_gather_2d<SPACE_GLOBAL, 0>(t, reps, y, units, st);
}

// P5: out (R,) = the closest hit of rays (3, R) over S spheres from `space`
// (shared and global read the table as float4s: it must be 16-byte aligned).
extern "C" int rt_probe_sphere_loop_launch(const void* sph, int S,
                                           const void* o, const void* d,
                                           long long R, int reps, int space,
                                           void* out, void* stream) {
    if (S < 1 || R < 1 || reps < 0
        || (space != SPACE_CONSTANT
            && reinterpret_cast<uintptr_t>(sph) % 16 != 0))
        return (int)cudaErrorInvalidValue;
    (void)cudaGetLastError();
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    size_t smem;
    RT_TRY(place(space, sph, 4 * S, &smem, st));
    const float* s = static_cast<const float*>(sph);
    const float* po = static_cast<const float*>(o);
    const float* pd = static_cast<const float*>(d);
    float* y = static_cast<float*>(out);
    if (space == SPACE_CONSTANT)
        return launch_sphere_loop<SPACE_CONSTANT>(s, S, po, pd, R, reps, y,
                                                  smem, st);
    if (space == SPACE_SHARED)
        return launch_sphere_loop<SPACE_SHARED>(s, S, po, pd, R, reps, y,
                                                smem, st);
    return launch_sphere_loop<SPACE_GLOBAL>(s, S, po, pd, R, reps, y, smem,
                                            st);
}

// P6: P5 with the spheres compiled in, S = 64 or 256.
extern "C" int rt_probe_sphere_immediate_launch(int S, const void* o,
                                                const void* d, long long R,
                                                int reps, void* out,
                                                void* stream) {
    if (R < 1 || reps < 0) return (int)cudaErrorInvalidValue;
    (void)cudaGetLastError();
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* po = static_cast<const float*>(o);
    const float* pd = static_cast<const float*>(d);
    float* y = static_cast<float*>(out);
    const int nb = blocks_of(R, SPHERE_THREADS);
    if (S == 64)
        sphere_immediate_kernel<64>
            <<<nb, SPHERE_THREADS, 0, st>>>(po, pd, R, reps, y);
    else if (S == 256)
        sphere_immediate_kernel<256>
            <<<nb, SPHERE_THREADS, 0, st>>>(po, pd, R, reps, y);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

// P7: out (R,) = the min over S spheres of the placeholder algebra on
// d @ cm and o @ cm, for rays o, d (R, 8) and cm, r2 (8, S); f32 CUDA-core
// or TF32 tensor-core products. prods (2, R, S) or null (TF32 only).
extern "C" int rt_probe_sphere_mxu_launch(const void* cm, const void* r2,
                                          int S, const void* o,
                                          const void* d, long long R,
                                          int reps, int tensor_cores,
                                          void* out, void* prods,
                                          void* stream) {
    if (S < 1 || R < 1 || reps < 0) return (int)cudaErrorInvalidValue;
    (void)cudaGetLastError();
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* pc = static_cast<const float*>(cm);
    const float* pr = static_cast<const float*>(r2);
    const float* po = static_cast<const float*>(o);
    const float* pd = static_cast<const float*>(d);
    float* y = static_cast<float*>(out);
    if (tensor_cores) {
        if (R % 16 || S % 8) return (int)cudaErrorInvalidValue;
        // cm as tf32 B fragments (8 bytes a lane a step) and c2 (4 bytes a
        // sphere)
        const size_t smem = (size_t)S * (4 * sizeof(uint2) + sizeof(float));
        if (smem > (size_t)SHARED_MAX_BYTES) return (int)cudaErrorInvalidValue;
        const int nb = blocks_of(R, 16 * MXU_TC_TILES * MXU_TC_WARPS);
        float* pp = static_cast<float*>(prods);
        if (pp != nullptr) {
            RT_TRY(allow_shared(sphere_mxu_tc_kernel<true>, smem));
            sphere_mxu_tc_kernel<true><<<nb, 32 * MXU_TC_WARPS, smem, st>>>(
                pc, pr, S, po, pd, R, reps, y, pp);
        } else {
            RT_TRY(allow_shared(sphere_mxu_tc_kernel<false>, smem));
            sphere_mxu_tc_kernel<false><<<nb, 32 * MXU_TC_WARPS, smem, st>>>(
                pc, pr, S, po, pd, R, reps, y, pp);
        }
        return (int)cudaGetLastError();
    }
    if (prods != nullptr) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)S * 3 * sizeof(float4);  // 3 rows a sphere
    if (smem > (size_t)SHARED_MAX_BYTES) return (int)cudaErrorInvalidValue;
    RT_TRY(allow_shared(sphere_mxu_f32_kernel, smem));
    sphere_mxu_f32_kernel<<<blocks_of(R, MXU_F32_THREADS), MXU_F32_THREADS,
                            smem, st>>>(pc, pr, S, po, pd, R, reps, y);
    return (int)cudaGetLastError();
}
