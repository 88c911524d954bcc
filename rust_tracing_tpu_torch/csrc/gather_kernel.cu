// Table gathers and their deterministic transpose, for Hopper (sm_90a),
// written by hand.
//
// gather_kernel replaces the Pallas lane gather `_kernel` of
// rust_tracing_tpu/ops/lanegather.py (`lane_gather`), gather_cols_kernel its
// multi-column form `_kernel_cols` (`lane_gather_cols`), and
// scatter_sum_kernel the transpose of both (`_reduce_cotangent` in
// rust_tracing_tpu/ops/tgather.py, which the JAX package leaves to XLA).
//
// Gathers: out[i] = (0 <= idx[i] < n) ? col[idx[i]] : 0, and for a row-major
// (K, n) table out[k, i] = tab[k, idx[i]] with the index read once. A gather
// copies bits, so one template per element size serves f32, i32 (4 bytes)
// and f64 (8 bytes). Grid-stride loops; the index reads and output writes of
// a warp are consecutive, i.e. coalesced. The table is NOT staged in shared
// memory: the path's tables are a few KB and stay in L1/L2 after the first
// touches, read through the read-only path (`__ldg`). Bound: bytes (index
// read once, output written once); the table reads hit cache.
//
// Reduction (the tile kernel, scatter_sum_partial + scatter_sum_final):
// d_col[k, r] = sum of ct[k, i] over i with idx[i] == r, out of range indices
// dropped, for all K columns in one launch. It must give the same bits on
// every call (replay gradients are compared with direct ones, and a run must
// repeat), so there are no float atomics anywhere. The launch shape comes
// from (R, n, K, element size) alone (ops/lanegather.py::scatter_plan):
// B blocks, each a contiguous slice of `chunk` elements; a block's W warps
// are Wc column groups x We element slices (Wc = min(K, 8), We = 8 / Wc):
// warp (g, q) sums the columns g, g + Wc, ... over the q-th contiguous part
// of the block's slice. Summation order of every (column, row):
//   1. Lane l of a warp walks the elements lo + l, lo + l + 32, ... of its
//      part in order (32 interleaved streams: a warp's index and cotangent
//      loads are 128-byte lines) and adds each element whose row is r to its
//      OWN shared-memory copy of the row sum, laid out [column][row][lane]:
//      whatever the keys, the 32 lanes of a step touch 32 different banks,
//      so no match, shuffle or atomic is needed. O(1) instructions per
//      (element, column).
//   2. At the end of the slice the 32 lane copies of each (column, row) are
//      added in a fixed butterfly (lane l + lane l^16, then ^8, ^4, ^2, ^1;
//      lane 0's value), and the block adds the column's We parts in order:
//      one partial per (column, block, row).
//   3. scatter_sum_final: one warp a (column, row); lane l adds the partials
//      of blocks l, l + 32, ... in order, then the same butterfly.
// ops/lanegather.py::scatter_sum_ordered_plain is this order in tensor
// code, so the card's gate is bit for bit; integer-valued cotangents sum
// exactly in any order. The index is read from device memory once for all
// the columns (the Wc groups of a block re-read its slice of it from cache).
// The copies take 33 x 4 bytes (f32) per (warp, column, row) of a pass, up
// to 227 KB a block: where a warp's columns and rows do not fit, the kernel
// makes passes over column rounds and row tiles, each re-reading the slice;
// and the copies bound the warps an SM holds. The tables the route sends
// here (<= 64 rows) fit one row pass; the row-tile loop is kept all the
// same: taking it out (rows = n, keys compared with n) changed nvcc's code
// for every instantiation, and on an H100 the f32 (17, 24) reduction took
// 0.263 ms against 0.184, f64 (1, 4) 0.030 against 0.022 (PERF.md, "Row-
// tile passes"). It also serves direct calls with more rows. So the tile
// kernel is for small tables (cornell's 4 texture rows: all of its
// gradient's reductions); ops/lanegather.py sends larger ones to the match
// kernel (one row-sum copy a warp, below) or the segment sum (further
// below), by rows, columns and dtype as they measured fastest. Bound:
// bytes, 4 + K x 4 (f32) read per element; the instruction work (a load, a
// shared load, an add and a shared store per element and column, plus per
// block a butterfly per (warp, column, row)) is below that at the shapes it
// takes.
//
// The same reduction for larger tables (an image texture's 524 288 texels,
// final_scene's 2408 quads), where the tile kernel would re-read its slice
// once per row tile and keep K * B * n partials, is a stable sort of the
// index by rows followed by one pass over the sorted runs. Both are written here; no library sort.
//  - radix_*_kernel: a stable LSD radix sort of the keys (the index, with rows
//    outside [0, n) given the key n, which sorts last and is dropped) over the
//    bits of n only, in passes of at most RADIX_MAX_BITS (3 passes of 7, 7
//    and 6 bits for 524 288 rows), carrying the K cotangent columns along. A pass:
//    radix_hist_kernel counts each tile's digits (integer atomics on shared
//    memory: exact in any order), radix_scan_kernel turns the counts into each
//    (digit, tile)'s first output slot, and radix_scatter_kernel places each
//    element: a tile is cut into contiguous warp slices, a warp walks its
//    slice 32 elements a step, lanes with the same digit find each other (one
//    ballot a digit bit) and take consecutive slots in lane order. Elements of
//    one digit keep their order: tile by tile, warp by warp, step by step,
//    lane by lane. The block orders its tile in shared memory first, so its
//    stores go out in runs of one digit, not to 32 scattered slots a step.
//  - segment_sum_kernel: one thread a sorted position, a warp 32 of them. A
//    row's run is cut by the warps into pieces; the first lane of a piece adds
//    the piece's cotangents in position order (0 + c_j + c_j+1 + ..., read by
//    shuffles). A run that spans warps is its first piece's sum + the next
//    warps' piece sums (segment_carry_kernel: in warp order up to
//    SEG_SHORT_CHAIN of them, else lane-strided and a fixed butterfly). Rows
//    without elements keep the zero the wrapper allocated them.
// So every row's order of summation is a function of the index alone: the
// same bits on every call, exact sums on integer-valued cotangents, no float
// atomics. Bytes: each sort pass reads the keys twice (count, place) and
// the columns once and writes both; the sum reads the sorted keys and
// columns once, in order. Moving the columns with the keys replaces a gather
// of each cotangent at a random position (a 32-byte sector for 4 or 8 useful
// bytes) by two streaming copies. What bounds it on an H100 is not those
// bytes (1.5-2.1 TB/s a pass): the scatter pass's cost an element grows with
// the digit's bits (one ballot a bit; runs of one digit in the stores of
// RADIX_TILE / 2^bits elements). Which of the two, unprofiled (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int G_THREADS = 256;
// the tile kernel: at most this many warps a block, this much shared memory
// (ops/lanegather.py::SCATTER_MAX_WARPS, SCATTER_SMEM_BYTES)
constexpr int SS_MAX_WARPS = 8;
constexpr int SS_SMEM_BYTES = 232448;
// the match kernel: warps a block, shared memory of row sums a block
constexpr int SM_WARPS = 4;
constexpr int SM_THREADS = 32 * SM_WARPS;
constexpr int SM_SMEM_BYTES = 48 * 1024;
constexpr int SEG_THREADS = 256;
constexpr int RADIX_WARPS = 8;
constexpr int RADIX_THREADS = 32 * RADIX_WARPS;
constexpr int RADIX_TILE = 4096;  // elements a block; ops/lanegather.py
constexpr int RADIX_SLICE = RADIX_TILE / RADIX_WARPS;
constexpr int RADIX_ITEMS = RADIX_SLICE / 32;
constexpr int RADIX_MAX_BITS = 8;  // ops/lanegather.py::RADIX_MAX_BITS
constexpr int RADIX_MAX_DIGITS = 1 << RADIX_MAX_BITS;
constexpr int HIST_TILES = 8;  // tiles a block of radix_hist_kernel counts
constexpr int HIST_THREADS = 1024;
// blocks of radix_scatter_kernel an SM holds: registers capped for 3 (their
// shared memory is 32 KB of values and 10 KB of digit slots at most)
constexpr int RADIX_SCATTER_BLOCKS = 3;
// carry chains of up to this many warps are added by one thread
constexpr int SEG_SHORT_CHAIN = 8;
constexpr unsigned FULL_MASK = 0xffffffffu;

template <typename T>
__global__ void __launch_bounds__(G_THREADS)
    gather_kernel(const T* __restrict__ col, int n,
                  const int* __restrict__ idx, long long R,
                  T* __restrict__ out) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < R;
         i += stride) {
        const int j = __ldg(idx + i);
        out[i] = (j >= 0 && j < n) ? __ldg(col + j) : T(0);
    }
}

template <typename T>
__global__ void __launch_bounds__(G_THREADS)
    gather_cols_kernel(const T* __restrict__ tab, int K, int n,
                       const int* __restrict__ idx, long long R,
                       T* __restrict__ out) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < R;
         i += stride) {
        const int j = __ldg(idx + i);
        const bool ok = j >= 0 && j < n;
        for (int k = 0; k < K; ++k)
            out[(size_t)k * R + i] = ok ? __ldg(tab + (size_t)k * n + j) : T(0);
    }
}

// The fixed butterfly over a warp's lanes: lane 0 gets
// ((x0 + x16) + (x8 + x24)) + ... (every lane adds its own value first; the
// add is commutative, so both lanes of a pair hold the same bits).
template <typename T>
__device__ __forceinline__ T lane_butterfly(T x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        x = x + __shfl_xor_sync(FULL_MASK, x, off);
    return x;
}

// One block of the tile kernel (see the header). Its W = Wc x We warps:
// warp w serves column group g = w % Wc (columns g, g + Wc, g + 2 Wc, ...)
// over element slice q = w / Wc of the block's chunk. A pass holds, per
// warp, `cpw` of its group's columns (from column round j0) and `rows` rows
// (from r0); CG columns a lane loads at once (1, 2, 4 or 8, the smallest
// that covers cpw, else 8) for U element steps (8, or 4 at 8 columns).
// Shared memory: W x cpw x rows x 32 lane copies, then W x cpw x rows warp
// sums.
template <typename T, int CG>
__global__ void __launch_bounds__(32 * SS_MAX_WARPS)
    scatter_sum_partial(const T* __restrict__ ct, const int* __restrict__ idx,
                        long long R, int n, int K, int Wc, int cpw, int rows,
                        long long chunk, T* __restrict__ partial) {
    constexpr int U = CG <= 4 ? 8 : 4;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int W = blockDim.x >> 5, We = W / Wc;
    const int B = gridDim.x, b = blockIdx.x;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = warp % Wc, q = warp / Wc;
    const int ncw = (K + Wc - 1) / Wc;  // columns of group 0, the most
    const int items = cpw * rows;       // (column, row) entries of a pass
    T* copies = reinterpret_cast<T*>(smem_raw);  // [W][items][32]
    T* wsum = copies + (size_t)W * items * 32;   // [W][items]
    T* mine = copies + (size_t)warp * items * 32 + lane;
    const long long lo = (long long)b * chunk;
    const long long hi = lo + chunk < R ? lo + chunk : R;
    const long long wchunk = (chunk + We - 1) / We;
    const long long wlo = lo + q * wchunk;
    const long long whi = wlo + wchunk < hi ? wlo + wchunk : hi;

    for (int j0 = 0; j0 < ncw; j0 += cpw) {
        // this warp's columns of the pass: g + (j0 + j) Wc < K, j < nj
        const int left = (K - g + Wc - 1) / Wc - j0;
        const int nj = left < 0 ? 0 : (left < cpw ? left : cpw);
        for (int r0 = 0; r0 < n; r0 += rows) {
            const int nr = n - r0 < rows ? n - r0 : rows;
            for (int e = threadIdx.x; e < W * items * 32; e += blockDim.x)
                copies[e] = T(0);
            __syncthreads();
            for (long long base = wlo; base < whi; base += 32 * U) {
                // the index and the first CG columns load together: no
                // value load waits for its key
                int key[U];
                T v[U][CG];
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    const long long i = base + 32 * u + lane;
                    key[u] = i < whi ? __ldg(idx + i) : -1;
                }
                for (int j1 = 0; j1 < nj; j1 += CG) {
#pragma unroll
                    for (int u = 0; u < U; ++u)
#pragma unroll
                        for (int m = 0; m < CG; ++m)
                            v[u][m] =
                                base + 32 * u + lane < whi && j1 + m < nj
                                    ? __ldg(ct
                                            + (size_t)(g + (j0 + j1 + m) * Wc)
                                                  * R
                                            + base + 32 * u + lane)
                                    : T(0);
                    if (j1 == 0) {  // after the loads have gone out
#pragma unroll
                        for (int u = 0; u < U; ++u)
                            key[u] = key[u] >= r0 && key[u] < r0 + nr
                                         ? key[u] - r0
                                         : -1;
                    }
                    // in element order for each (column, row): u ascends
#pragma unroll
                    for (int u = 0; u < U; ++u)
#pragma unroll
                        for (int m = 0; m < CG; ++m)
                            if (key[u] >= 0 && j1 + m < nj) {
                                T* a = mine
                                       + ((size_t)(j1 + m) * rows + key[u]) * 32;
                                *a = *a + v[u][m];
                            }
                }
            }
            __syncthreads();
            // every warp's lane copies of the pass: any warp sums any
            for (int t = warp; t < W * items; t += W) {
                const T s = lane_butterfly(copies[(size_t)t * 32 + lane]);
                if (lane == 0) wsum[t] = s;
            }
            __syncthreads();
            // a group's element slices in slice order: one thread a
            // (group, column of the pass, row)
            for (int t = threadIdx.x; t < Wc * items; t += blockDim.x) {
                const int gg = t / items, e = t % items;
                const int j = e / rows, r = e % rows;
                const int c = gg + (j0 + j) * Wc;
                if (r >= nr || c >= K) continue;
                T s = wsum[gg * items + e];
                for (int qq = 1; qq < We; ++qq)
                    s = s + wsum[(qq * Wc + gg) * items + e];
                partial[((size_t)c * B + b) * n + r0 + r] = s;
            }
            __syncthreads();
        }
    }
}

// out[k, r]: one warp a (column, row); lane l adds the partials of blocks
// l, l + 32, ... in block order, then lane_butterfly.
template <typename T>
__global__ void __launch_bounds__(G_THREADS)
    scatter_sum_final(const T* __restrict__ partial, int B, int n, int K,
                      T* __restrict__ out) {
    const long long t = ((long long)blockIdx.x * G_THREADS + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (t >= (long long)K * n) return;  // the whole warp
    const int k = (int)(t / n), r = (int)(t % n);
    const T* p = partial + (size_t)k * B * n + r;
    T s = T(0);
    for (int b = lane; b < B; b += 32) s = s + __ldg(p + (size_t)b * n);
    s = lane_butterfly(s);
    if (lane == 0) out[t] = s;
}

// The match kernel (scatter_match_partial + scatter_match_final), for
// tables of a few hundred to a few thousand rows, where the tile kernel's
// 32 lane copies of every row no longer fit beside enough warps. Grid
// (B, K), blocks of SM_WARPS warps, B and the block slices as the tile
// kernel's by R alone; each warp keeps ONE shared-memory copy of its row
// sums (SM_SMEM_BYTES / SM_WARPS a warp: 3072 f32 rows, 1536 f64; larger
// tables in row tiles, each re-reading the slice). Summation order of every
// (column, row), fixed by R alone:
//   1. A warp walks its slice 32 elements at a time, in order. In each step
//      the lanes holding the same row find each other (__match_any_sync);
//      each group is summed in lane order (0 + v_l0 + v_l1 + ...), and its
//      lowest lane adds that sum to the warp's row sum. Groups of one step
//      have distinct rows, and only this warp writes its row sums. The warp
//      folds over its groups' set bits only, as many steps as its largest
//      group (1-3 for a random index into hundreds of rows), not 32.
//   2. At the end of the slice the block adds its warps' row sums in warp
//      order and writes one partial per (column, block, row).
//   3. scatter_match_final adds the B partials of each row in block order.
// Bound: bytes (the index and the column read once a column and row tile).
template <typename T>
__global__ void __launch_bounds__(SM_THREADS)
    scatter_match_partial(const T* __restrict__ ct, const int* __restrict__ idx,
                          long long R, int n, int tile_rows, long long chunk,
                          T* __restrict__ partial) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* hist = reinterpret_cast<T*>(smem_raw);  // SM_WARPS x tile_rows
    const int k = blockIdx.y;
    const int B = gridDim.x, b = blockIdx.x;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const T* ctk = ct + (size_t)k * R;
    const long long lo = (long long)b * chunk;
    const long long hi = lo + chunk < R ? lo + chunk : R;
    const long long wchunk = (chunk + SM_WARPS - 1) / SM_WARPS;
    const long long wlo = lo + warp * wchunk;
    const long long whi = wlo + wchunk < hi ? wlo + wchunk : hi;
    T* mine = hist + warp * tile_rows;

    for (int r0 = 0; r0 < n; r0 += tile_rows) {
        const int rows = n - r0 < tile_rows ? n - r0 : tile_rows;
        for (int r = threadIdx.x; r < SM_WARPS * tile_rows; r += SM_THREADS)
            hist[r] = T(0);
        __syncthreads();
        // the loop bound is the same for all lanes: every lane takes part in
        // the warp-wide match and shuffles
        for (long long base = wlo; base < whi; base += 32) {
            const long long i = base + lane;
            int key = -1;
            T v = T(0);
            if (i < whi) {
                const int j = __ldg(idx + i);
                if (j >= r0 && j < r0 + rows) {
                    key = j - r0;
                    v = __ldg(ctk + i);
                }
            }
            const unsigned peers = __match_any_sync(FULL_MASK, key);
            const int steps = (int)__reduce_max_sync(
                FULL_MASK, key >= 0 ? (unsigned)__popc(peers) : 0u);
            unsigned rest = peers;
            T acc = T(0);
            for (int t = 0; t < steps; ++t) {
                const T vs = __shfl_sync(FULL_MASK, v,
                                         rest ? __ffs(rest) - 1 : lane);
                if (rest) {
                    acc = acc + vs;
                    rest &= rest - 1u;
                }
            }
            if (key >= 0 && lane == __ffs(peers) - 1)
                mine[key] = mine[key] + acc;
            __syncwarp();
        }
        __syncthreads();
        for (int r = threadIdx.x; r < rows; r += SM_THREADS) {
            T s = hist[r];
            for (int w = 1; w < SM_WARPS; ++w) s = s + hist[w * tile_rows + r];
            partial[((size_t)k * B + b) * n + r0 + r] = s;
        }
        __syncthreads();
    }
}

template <typename T>
__global__ void __launch_bounds__(G_THREADS)
    scatter_match_final(const T* __restrict__ partial, int B, int n, int K,
                        T* __restrict__ out) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)K * n) return;
    const int k = (int)(t / n), r = (int)(t % n);
    const T* p = partial + (size_t)k * B * n + r;
    T s = p[0];
    for (int b = 1; b < B; ++b) s = s + p[(size_t)b * n];
    out[t] = s;
}

// The sort key of element i: the index itself after the first pass (`raw`
// 0); on the first pass rows outside [0, n) become n.
__device__ __forceinline__ int radix_key(const int* __restrict__ keys,
                                         long long i, int n, int raw) {
    const int k = __ldg(keys + i);
    return (raw && (k < 0 || k >= n)) ? n : k;
}

// counts[d * B + b] = elements of tile b (RADIX_TILE elements from
// b * RADIX_TILE) whose digit (key >> shift) & (D - 1) is d. A block counts
// HIST_TILES tiles, so that its writes of a digit's counts fill whole
// sectors.
__global__ void __launch_bounds__(HIST_THREADS)
    radix_hist_kernel(const int* __restrict__ keys, long long R, int n,
                      int raw, int shift, int D, int B,
                      int* __restrict__ counts) {
    __shared__ int hist[HIST_TILES][RADIX_MAX_DIGITS];
    for (int d = threadIdx.x; d < HIST_TILES * RADIX_MAX_DIGITS;
         d += HIST_THREADS)
        (&hist[0][0])[d] = 0;
    __syncthreads();
    const int b0 = blockIdx.x * HIST_TILES;
    const long long lo = (long long)b0 * RADIX_TILE;
    const long long hi = lo + (long long)HIST_TILES * RADIX_TILE < R
                             ? lo + (long long)HIST_TILES * RADIX_TILE
                             : R;
    for (long long i = lo + threadIdx.x; i < hi; i += HIST_THREADS)
        atomicAdd(&hist[(i - lo) / RADIX_TILE]
                       [(radix_key(keys, i, n, raw) >> shift) & (D - 1)],
                  1);
    __syncthreads();
    for (int e = threadIdx.x; e < HIST_TILES * D; e += HIST_THREADS) {
        const int d = e / HIST_TILES, t = e % HIST_TILES;
        if (b0 + t < B) counts[(size_t)d * B + b0 + t] = hist[t][d];
    }
}

// Inclusive sum over the lanes 0..lane of a warp.
__device__ __forceinline__ int warp_inclusive_sum(int x, int lane) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(FULL_MASK, x, off);
        if (lane >= off) x += y;
    }
    return x;
}

// One warp a digit d, in place: counts[d * B + b] becomes the number of
// elements of digit d in the tiles before b; totals[d] their number in all.
__global__ void __launch_bounds__(RADIX_THREADS)
    radix_scan_kernel(int* __restrict__ counts, int B, int D,
                      int* __restrict__ totals) {
    const int d = blockIdx.x * RADIX_WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (d >= D) return;  // the whole warp
    int* c = counts + (size_t)d * B;
    int carry = 0;
    for (int b0 = 0; b0 < B; b0 += 32) {
        const int b = b0 + lane;
        const int v = b < B ? c[b] : 0;
        const int x = warp_inclusive_sum(v, lane);
        if (b < B) c[b] = carry + x - v;
        carry += __shfl_sync(FULL_MASK, x, 31);
    }
    if (lane == 0) totals[d] = carry;
}

// Lanes of the warp whose `digit` (of `width` bits) equals this lane's, among
// the lanes whose `valid` is the same: one ballot a bit (instead of
// __match_any_sync, which the card issues far more slowly).
__device__ __forceinline__ unsigned match_digit(int digit, int width,
                                                bool valid) {
    const unsigned v = __ballot_sync(FULL_MASK, valid);
    unsigned peers = valid ? v : ~v;
    for (int b = 0; b < width; ++b) {
        const bool bit = (digit >> b) & 1;
        const unsigned m = __ballot_sync(FULL_MASK, bit);
        peers &= bit ? m : ~m;
    }
    return peers;
}

// One stable pass over keys and their K value columns (V: the values' bits,
// 4 or 8 bytes). Element i of tile b goes to slot
//   (elements of smaller digits) + (elements of its digit in earlier tiles)
//   + (in earlier warp slices of its tile) + (in earlier steps of its slice)
//   + (in lower lanes of its step).
// A lane holds its RADIX_ITEMS elements of the slice (step q: element
// lo + 32 q + lane) in registers from the start, so a warp's loads are all
// in flight at once. The block places its tile in shared memory in output
// order (digit by digit), then writes each run out with consecutive threads
// on consecutive slots: the keys, then each value column the same way.
template <typename V>
__global__ void __launch_bounds__(RADIX_THREADS, RADIX_SCATTER_BLOCKS)
    radix_scatter_kernel(const int* __restrict__ keys, long long R, int n,
                         int raw, int shift, int width,
                         const int* __restrict__ counts,
                         const int* __restrict__ totals,
                         int* __restrict__ keys_out,
                         const V* __restrict__ vals, int K,
                         V* __restrict__ vals_out) {
    extern __shared__ __align__(16) unsigned char radix_smem[];
    V* tile = reinterpret_cast<V*>(radix_smem);  // RADIX_TILE values or keys
    int(*slot)[RADIX_MAX_DIGITS] = reinterpret_cast<int(*)[RADIX_MAX_DIGITS]>(
        radix_smem + RADIX_TILE * sizeof(V));
    int* local = &slot[RADIX_WARPS][0];  // the tile's first slot of a digit
    int* first = local + RADIX_MAX_DIGITS;  // its global slot
    int* warp_sum = first + RADIX_MAX_DIGITS;  // 2 x RADIX_WARPS
    int* tile_key = reinterpret_cast<int*>(tile);
    const int D = 1 << width;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const unsigned lower = (1u << lane) - 1u;
    const long long t0 = (long long)blockIdx.x * RADIX_TILE;
    const long long lo = t0 + (long long)warp * RADIX_SLICE;
    const long long hi = lo + RADIX_SLICE < R ? lo + RADIX_SLICE : R;
    const int count = (int)(R - t0 < RADIX_TILE ? R - t0 : RADIX_TILE);

    int key[RADIX_ITEMS];
#pragma unroll
    for (int q = 0; q < RADIX_ITEMS; ++q) {
        const long long i = lo + 32 * q + lane;
        key[q] = i < hi ? radix_key(keys, i, n, raw) : 0;
    }
    for (int d = threadIdx.x; d < D; d += RADIX_THREADS)
        for (int w = 0; w < RADIX_WARPS; ++w) slot[w][d] = 0;
    __syncthreads();

    // the warp's count of each digit in its slice; a step's groups have
    // distinct digits, and only this warp touches its row of `slot`
    unsigned peers[RADIX_ITEMS];
#pragma unroll
    for (int q = 0; q < RADIX_ITEMS; ++q) {
        const bool ok = lo + 32 * q + lane < hi;
        const int digit = (key[q] >> shift) & (D - 1);
        peers[q] = match_digit(digit, width, ok);
        if (ok && lane == __ffs(peers[q]) - 1)
            slot[warp][digit] += __popc(peers[q]);
        __syncwarp();
    }
    __syncthreads();

    // exclusive sums over the digits of the totals (the digit's first global
    // slot) and of the tile's counts (its first slot in the tile); each
    // thread four digits in a row
    constexpr int PER = RADIX_MAX_DIGITS / RADIX_THREADS;
    int vg[PER], vl[PER], sg = 0, sl = 0;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
        const int d = threadIdx.x * PER + q;
        vg[q] = sg;
        vl[q] = sl;
        if (d < D) {
            sg += __ldg(totals + d);
            for (int w = 0; w < RADIX_WARPS; ++w) sl += slot[w][d];
        }
    }
    const int xg = warp_inclusive_sum(sg, lane);
    const int xl = warp_inclusive_sum(sl, lane);
    if (lane == 31) {
        warp_sum[warp] = xg;
        warp_sum[RADIX_WARPS + warp] = xl;
    }
    __syncthreads();
    int bg = xg - sg, bl = xl - sl;
    for (int w = 0; w < warp; ++w) {
        bg += warp_sum[w];
        bl += warp_sum[RADIX_WARPS + w];
    }
#pragma unroll
    for (int q = 0; q < PER; ++q) {
        const int d = threadIdx.x * PER + q;
        if (d >= D) continue;
        local[d] = bl + vl[q];
        first[d] = bg + vg[q]
                   + __ldg(counts + (size_t)d * gridDim.x + blockIdx.x);
        int run = bl + vl[q];
        for (int w = 0; w < RADIX_WARPS; ++w) {
            const int c = slot[w][d];
            slot[w][d] = run;
            run += c;
        }
    }
    __syncthreads();
    // each element's slot in the tile
    int li[RADIX_ITEMS];
#pragma unroll
    for (int q = 0; q < RADIX_ITEMS; ++q) {
        const bool ok = lo + 32 * q + lane < hi;
        const int digit = (key[q] >> shift) & (D - 1);
        li[q] = ok ? slot[warp][digit] + __popc(peers[q] & lower) : -1;
        __syncwarp();
        if (ok && lane == __ffs(peers[q]) - 1)
            slot[warp][digit] += __popc(peers[q]);
        __syncwarp();
    }
#pragma unroll
    for (int q = 0; q < RADIX_ITEMS; ++q)
        if (li[q] >= 0) tile_key[li[q]] = key[q];
    __syncthreads();
    // the tile's slot s goes to global slot dst[m] (s = threadIdx.x + m *
    // RADIX_THREADS)
    int dst[RADIX_ITEMS];
#pragma unroll
    for (int m = 0; m < RADIX_ITEMS; ++m) {
        const int s = threadIdx.x + m * RADIX_THREADS;
        dst[m] = -1;
        if (s < count) {
            const int k = tile_key[s];
            const int digit = (k >> shift) & (D - 1);
            dst[m] = first[digit] + s - local[digit];
            keys_out[dst[m]] = k;
        }
    }
    for (int c = 0; c < K; ++c) {
        const V* in = vals + (size_t)c * R;
        V v[RADIX_ITEMS];
#pragma unroll
        for (int q = 0; q < RADIX_ITEMS; ++q)
            v[q] = li[q] >= 0 ? __ldg(in + lo + 32 * q + lane) : V(0);
        __syncthreads();
#pragma unroll
        for (int q = 0; q < RADIX_ITEMS; ++q)
            if (li[q] >= 0) tile[li[q]] = v[q];
        __syncthreads();
        V* o = vals_out + (size_t)c * R;
#pragma unroll
        for (int m = 0; m < RADIX_ITEMS; ++m)
            if (dst[m] >= 0) o[dst[m]] = tile[threadIdx.x + m * RADIX_THREADS];
    }
}

// The segment sum over the sorted keys `skey` (key n: dropped) and the
// values sorted with them, `svals` (K x R). Warp w holds the sorted
// positions [32 w, 32 w + 32), one a lane; a run of one row is cut by the
// warps into pieces. Each piece is summed by its first lane in position
// order (0 + c_j + c_j+1 + ..., the other lanes' values read by shuffles).
// A piece that starts its run writes its sum to the row; a piece that
// continues a run from an earlier warp (it starts at lane 0) writes it to
// `carry` (K x W). The warp's last piece, when it starts a run that goes on
// into the next warp, names the row in `tail_key` (else -1) for
// segment_carry_kernel.
template <typename T>
__global__ void __launch_bounds__(SEG_THREADS)
    segment_sum_kernel(const T* __restrict__ svals,
                       const int* __restrict__ skey, long long R, int n,
                       int K, T* __restrict__ out, T* __restrict__ carry,
                       int* __restrict__ tail_key) {
    const long long j = (long long)blockIdx.x * SEG_THREADS + threadIdx.x;
    const int lane = threadIdx.x & 31;
    const long long j0 = j - lane, w = j0 >> 5, W = (R + 31) >> 5;
    if (j0 >= R) return;  // the whole warp
    const int key = j < R ? __ldg(skey + j) : n;
    const int before = j0 > 0 ? __ldg(skey + j0 - 1) : -1;
    const int after = j0 + 32 < R ? __ldg(skey + j0 + 32) : -1;
    const int up = __shfl_up_sync(FULL_MASK, key, 1);
    const bool head = lane == 0 || key != up;
    const bool run_head = key != (lane == 0 ? before : up);
    const unsigned above =
        __ballot_sync(FULL_MASK, head) & ~((2u << lane) - 1u);
    const int len = (above ? __ffs(above) - 1 : 32) - lane;  // on heads
    const bool live = head && key < n;
    const int span = __reduce_max_sync(FULL_MASK, head ? len : 0);
    for (int k = 0; k < K; ++k) {
        const T v = key < n ? __ldg(svals + (size_t)k * R + j) : T(0);
        T acc = T(0);
        for (int off = 0; off < span; ++off) {
            const T y = __shfl_down_sync(FULL_MASK, v, off);
            if (off < len) acc = acc + y;
        }
        if (live) {
            if (run_head)
                out[(size_t)k * n + key] = acc;
            else
                carry[(size_t)k * W + w] = acc;
        }
    }
    if (head && !above)
        tail_key[w] = live && run_head && after == key ? key : -1;
}

// For each warp w whose last piece starts a run that goes on: the row's sum
// is that piece's sum + the sum of the following warps' carries while the
// run goes on (the chain). A chain of up to SEG_SHORT_CHAIN carries is added
// by w's thread in warp order. A longer one is added by the whole warp, the
// chains one at a time: lane l adds carries l, l + 32, ... in order, and the
// lane sums are added in a fixed butterfly. Which order a chain gets
// depends on its length alone.
template <typename T>
__global__ void __launch_bounds__(SEG_THREADS)
    segment_carry_kernel(const int* __restrict__ skey, long long R, int n,
                         int K, const T* __restrict__ carry,
                         const int* __restrict__ tail_key,
                         T* __restrict__ out) {
    const long long w = (long long)blockIdx.x * SEG_THREADS + threadIdx.x;
    const int lane = threadIdx.x & 31;
    const long long W = (R + 31) >> 5;
    const int mine = w < W ? __ldg(tail_key + w) : -1;
    // the chain is warps w + 1 .. end - 1: those whose first position the
    // run reaches (keys ascend, so they are a prefix)
    long long end = w + 1;
    if (mine >= 0)
        while (end < W && end - w <= SEG_SHORT_CHAIN
               && __ldg(skey + end * 32) == mine)
            ++end;
    const bool long_chain = mine >= 0 && end - w > SEG_SHORT_CHAIN;
    if (mine >= 0 && !long_chain)
        for (int k = 0; k < K; ++k) {
            T acc = out[(size_t)k * n + mine];
            for (long long v = w + 1; v < end; ++v)
                acc = acc + __ldg(carry + (size_t)k * W + v);
            out[(size_t)k * n + mine] = acc;
        }
    unsigned todo = __ballot_sync(FULL_MASK, long_chain);
    while (todo) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1u;
        const int key = __shfl_sync(FULL_MASK, mine, src);
        const long long v0 = __shfl_sync(FULL_MASK, w, src) + 1;
        long long e = v0;
        for (;;) {
            const long long v = e + lane;
            const unsigned m = __ballot_sync(
                FULL_MASK, v < W && __ldg(skey + v * 32) == key);
            e += __popc(m);
            if (m != FULL_MASK) break;
        }
        for (int k = 0; k < K; ++k) {
            T acc = T(0);
            for (long long v = v0 + lane; v < e; v += 32)
                acc = acc + __ldg(carry + (size_t)k * W + v);
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                acc = acc + __shfl_xor_sync(FULL_MASK, acc, off);
            if (lane == 0)
                out[(size_t)k * n + key] = out[(size_t)k * n + key] + acc;
        }
    }
}

int gather_blocks(long long R) {
    const long long b = (R + G_THREADS - 1) / G_THREADS;
    return (int)(b < 132 * 16 ? (b < 1 ? 1 : b) : 132 * 16);
}

template <typename T>
int launch_gather(const void* col, int n, const void* idx, long long R,
                  void* out, cudaStream_t st) {
    gather_kernel<T><<<gather_blocks(R), G_THREADS, 0, st>>>(
        static_cast<const T*>(col), n, static_cast<const int*>(idx), R,
        static_cast<T*>(out));
    return (int)cudaGetLastError();
}

template <typename T>
int launch_gather_cols(const void* tab, int K, int n, const void* idx,
                       long long R, void* out, cudaStream_t st) {
    gather_cols_kernel<T><<<gather_blocks(R), G_THREADS, 0, st>>>(
        static_cast<const T*>(tab), K, n, static_cast<const int*>(idx), R,
        static_cast<T*>(out));
    return (int)cudaGetLastError();
}

template <typename T, int CG>
int launch_scatter_partial(const void* ct, const void* idx, long long R, int n,
                           int K, int B, long long chunk, int W, int Wc,
                           int cpw, int rows, size_t smem, void* partial,
                           cudaStream_t st) {
    // above 48 KB only after opting in, once a process
    static bool opted = false;
    if (!opted) {
        const int err = (int)cudaFuncSetAttribute(
            scatter_sum_partial<T, CG>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, SS_SMEM_BYTES);
        if (err != 0) return err;
        opted = true;
    }
    scatter_sum_partial<T, CG><<<B, 32 * W, smem, st>>>(
        static_cast<const T*>(ct), static_cast<const int*>(idx), R, n, K, Wc,
        cpw, rows, chunk, static_cast<T*>(partial));
    return (int)cudaGetLastError();
}

template <typename T>
int launch_scatter_sum(const void* ct, const void* idx, long long R, int n,
                       int K, int B, long long chunk, int W, int Wc, int cpw,
                       int rows, void* partial, void* out, cudaStream_t st) {
    const size_t smem = (size_t)W * cpw * rows * 33 * sizeof(T);
    if (smem > (size_t)SS_SMEM_BYTES) return (int)cudaErrorInvalidValue;
    int err;
    if (cpw == 1)
        err = launch_scatter_partial<T, 1>(ct, idx, R, n, K, B, chunk, W, Wc,
                                           cpw, rows, smem, partial, st);
    else if (cpw == 2)
        err = launch_scatter_partial<T, 2>(ct, idx, R, n, K, B, chunk, W, Wc,
                                           cpw, rows, smem, partial, st);
    else if (cpw <= 4)
        err = launch_scatter_partial<T, 4>(ct, idx, R, n, K, B, chunk, W, Wc,
                                           cpw, rows, smem, partial, st);
    else
        err = launch_scatter_partial<T, 8>(ct, idx, R, n, K, B, chunk, W, Wc,
                                           cpw, rows, smem, partial, st);
    if (err != 0) return err;
    const long long threads = (long long)K * n * 32;
    scatter_sum_final<T><<<(int)((threads + G_THREADS - 1) / G_THREADS),
                           G_THREADS, 0, st>>>(static_cast<const T*>(partial),
                                               B, n, K, static_cast<T*>(out));
    return (int)cudaGetLastError();
}

template <typename T>
int launch_scatter_match(const void* ct, const void* idx, long long R, int n,
                         int K, int B, long long chunk, void* partial,
                         void* out, cudaStream_t st) {
    int tile_rows = SM_SMEM_BYTES / (SM_WARPS * (int)sizeof(T));
    if (tile_rows > n) tile_rows = n;
    const size_t smem = (size_t)SM_WARPS * tile_rows * sizeof(T);
    scatter_match_partial<T><<<dim3(B, K), SM_THREADS, smem, st>>>(
        static_cast<const T*>(ct), static_cast<const int*>(idx), R, n,
        tile_rows, chunk, static_cast<T*>(partial));
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    const long long total = (long long)K * n;
    scatter_match_final<T><<<(int)((total + G_THREADS - 1) / G_THREADS),
                             G_THREADS, 0, st>>>(
        static_cast<const T*>(partial), B, n, K, static_cast<T*>(out));
    return (int)cudaGetLastError();
}

template <typename T>
int launch_segment_sum(const void* svals, const void* skey, long long R,
                       int n, int K, void* out, void* carry, void* tail_key,
                       cudaStream_t st) {
    const long long W = (R + 31) / 32;
    segment_sum_kernel<T><<<(unsigned)((R + SEG_THREADS - 1) / SEG_THREADS),
                            SEG_THREADS, 0, st>>>(
        static_cast<const T*>(svals), static_cast<const int*>(skey), R, n, K,
        static_cast<T*>(out), static_cast<T*>(carry),
        static_cast<int*>(tail_key));
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    segment_carry_kernel<T><<<(unsigned)((W + SEG_THREADS - 1) / SEG_THREADS),
                              SEG_THREADS, 0, st>>>(
        static_cast<const int*>(skey), R, n, K,
        static_cast<const T*>(carry), static_cast<const int*>(tail_key),
        static_cast<T*>(out));
    return (int)cudaGetLastError();
}

// The radix sort's passes for values of V's size (see rt_radix_sort_launch).
template <typename V>
int launch_radix_sort(const int* idx, long long R, int n, const int* widths,
                      int passes, const V* vals, int K, int* keys_out,
                      V* vals_out, int* keys_tmp, V* vals_tmp, int* counts,
                      int* totals, cudaStream_t st) {
    const int smem = (int)(RADIX_TILE * sizeof(V))
                     + (int)sizeof(int) * ((RADIX_WARPS + 2) * RADIX_MAX_DIGITS
                                           + 2 * RADIX_WARPS);
    int err = (int)cudaFuncSetAttribute(
        radix_scatter_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != 0) return err;
    const int B = (int)((R + RADIX_TILE - 1) / RADIX_TILE);
    const int* keys = idx;
    int shift = 0;
    for (int p = 0; p < passes; ++p) {
        // the last pass writes the output; passes alternate buffers
        const bool to_out = (passes - 1 - p) % 2 == 0;
        int* ko = to_out ? keys_out : keys_tmp;
        V* vo = to_out ? vals_out : vals_tmp;
        const int D = 1 << widths[p], raw = p == 0;
        radix_hist_kernel<<<(B + HIST_TILES - 1) / HIST_TILES, HIST_THREADS,
                            0, st>>>(keys, R, n, raw, shift, D, B, counts);
        radix_scan_kernel<<<(D + RADIX_WARPS - 1) / RADIX_WARPS,
                            RADIX_THREADS, 0, st>>>(counts, B, D, totals);
        radix_scatter_kernel<V><<<B, RADIX_THREADS, smem, st>>>(
            keys, R, n, raw, shift, widths[p], counts, totals, ko, vals, K,
            vo);
        err = (int)cudaGetLastError();
        if (err != 0) return err;
        keys = ko;
        vals = vo;
        shift += widths[p];
    }
    return 0;
}

}  // namespace

// All entry points launch on `stream`, do not synchronise and return
// cudaGetLastError(). `idx` is int32; `elem` is the element size in bytes.

// out[i] = col[idx[i]] (0 out of range), 4- or 8-byte elements.
extern "C" int rt_gather_launch(const void* col, int n, const void* idx,
                                long long R, int elem, void* out,
                                void* stream) {
    if (n < 1 || R < 1) return (int)cudaErrorInvalidValue;
    (void)cudaGetLastError();
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (elem == 4) return launch_gather<uint32_t>(col, n, idx, R, out, st);
    if (elem == 8)
        return launch_gather<unsigned long long>(col, n, idx, R, out, st);
    return (int)cudaErrorInvalidValue;
}

// out[k, i] = tab[k, idx[i]] for a row-major (K, n) table; out is (K, R).
extern "C" int rt_gather_cols_launch(const void* tab, int K, int n,
                                     const void* idx, long long R, int elem,
                                     void* out, void* stream) {
    if (K < 1 || n < 1 || R < 1) return (int)cudaErrorInvalidValue;
    (void)cudaGetLastError();
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (elem == 4)
        return launch_gather_cols<uint32_t>(tab, K, n, idx, R, out, st);
    if (elem == 8)
        return launch_gather_cols<unsigned long long>(tab, K, n, idx, R, out,
                                                      st);
    return (int)cudaErrorInvalidValue;
}

// out[k, r] = sum of ct[k, i] over idx[i] == r, for ct (K, R) float
// (is_double 0) or double (1), every entry of out written. The plan
// (ops/lanegather.py::scatter_plan): B blocks of W warps in Wc column
// groups, block b sums elements [b * chunk, (b + 1) * chunk), in passes of
// `cpw` columns a warp and `rows` rows. `partial` is scratch of K * B * n
// elements.
extern "C" int rt_scatter_sum_launch(const void* ct, const void* idx,
                                     long long R, int n, int K, int is_double,
                                     int B, long long chunk, int W, int Wc,
                                     int cpw, int rows, void* partial,
                                     void* out, void* stream) {
    if (n < 1 || K < 1 || R < 1 || B < 1 || chunk < 1
        || (long long)B * chunk < R || W < 1 || W > SS_MAX_WARPS || Wc < 1
        || Wc > K || W % Wc != 0 || cpw < 1 || cpw > (K + Wc - 1) / Wc
        || rows < 1 || rows > n)
        return (int)cudaErrorInvalidValue;
    (void)cudaGetLastError();
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_double)
        return launch_scatter_sum<double>(ct, idx, R, n, K, B, chunk, W, Wc,
                                          cpw, rows, partial, out, st);
    return launch_scatter_sum<float>(ct, idx, R, n, K, B, chunk, W, Wc, cpw,
                                     rows, partial, out, st);
}

// out[k, r] = sum of ct[k, i] over idx[i] == r by the match kernel, for ct
// (K, R) float (is_double 0) or double (1), every entry of out written.
// `partial` is scratch of K * B * n elements; block b sums elements
// [b * chunk, (b + 1) * chunk).
extern "C" int rt_scatter_match_launch(const void* ct, const void* idx,
                                       long long R, int n, int K,
                                       int is_double, int B, long long chunk,
                                       void* partial, void* out,
                                       void* stream) {
    if (n < 1 || K < 1 || R < 1 || B < 1 || chunk < 1
        || (long long)B * chunk < R || K > 65535)
        return (int)cudaErrorInvalidValue;
    (void)cudaGetLastError();
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_double)
        return launch_scatter_match<double>(ct, idx, R, n, K, B, chunk,
                                            partial, out, st);
    return launch_scatter_match<float>(ct, idx, R, n, K, B, chunk, partial,
                                       out, st);
}

// Stable sort of the int32 index `idx` (R elements) by row, rows outside
// [0, n) keyed n, carrying K value columns `vals` (K x R, `elem` 4 or 8
// bytes each) along: `passes` LSD passes of digit widths `widths` (a host
// array, lowest digit first, summing to at least the bits of n). Writes the
// sorted keys to keys_out (R int32) and the values in the same order to
// vals_out (K x R); keys_tmp / vals_tmp are scratch of the same sizes,
// `counts` scratch of 2^max(widths) * ceil(R / RADIX_TILE) int32, `totals`
// of 2^max(widths).
extern "C" int rt_radix_sort_launch(const void* idx, long long R, int n,
                                    const int* widths, int passes,
                                    const void* vals, int K, int elem,
                                    void* keys_out, void* vals_out,
                                    void* keys_tmp, void* vals_tmp,
                                    void* counts, void* totals,
                                    void* stream) {
    if (n < 1 || R < 1 || R > 0x7FFFFFFFLL || passes < 1 || K < 0
        || (elem != 4 && elem != 8))
        return (int)cudaErrorInvalidValue;
    int bits = 0;
    for (int p = 0; p < passes; ++p) {
        if (widths[p] < 1 || widths[p] > RADIX_MAX_BITS)
            return (int)cudaErrorInvalidValue;
        bits += widths[p];
    }
    if (bits < 31 && (n >> bits) != 0) return (int)cudaErrorInvalidValue;
    (void)cudaGetLastError();
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* ix = static_cast<const int*>(idx);
    int* ko = static_cast<int*>(keys_out);
    int* kt = static_cast<int*>(keys_tmp);
    int* c = static_cast<int*>(counts);
    int* t = static_cast<int*>(totals);
    if (elem == 4)
        return launch_radix_sort<uint32_t>(
            ix, R, n, widths, passes, static_cast<const uint32_t*>(vals), K,
            ko, static_cast<uint32_t*>(vals_out), kt,
            static_cast<uint32_t*>(vals_tmp), c, t, st);
    return launch_radix_sort<unsigned long long>(
        ix, R, n, widths, passes, static_cast<const unsigned long long*>(vals),
        K, ko, static_cast<unsigned long long*>(vals_out), kt,
        static_cast<unsigned long long*>(vals_tmp), c, t, st);
}

// out[k, r] = sum of ct[k, i] over idx[i] == r, for ct (K, R) float
// (is_double 0) or double (1), from the sorted keys `skey` and the values
// sorted with them, `svals` (K x R), that rt_radix_sort_launch wrote. `out`
// (K, n) holds zeros: rows without elements are not written. `carry` is
// scratch of K * ceil(R / 32) elements, `tail_key` of ceil(R / 32) int32.
extern "C" int rt_segment_sum_launch(const void* svals, const void* skey,
                                     long long R, int n, int K, int is_double,
                                     void* out, void* carry, void* tail_key,
                                     void* stream) {
    if (n < 1 || K < 1 || R < 1 || R > 0x7FFFFFFFLL)
        return (int)cudaErrorInvalidValue;
    (void)cudaGetLastError();
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_double)
        return launch_segment_sum<double>(svals, skey, R, n, K, out, carry,
                                          tail_key, st);
    return launch_segment_sum<float>(svals, skey, R, n, K, out, carry,
                                     tail_key, st);
}
