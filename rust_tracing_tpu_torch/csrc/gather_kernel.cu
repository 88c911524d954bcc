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
// Reduction: d_col[k, r] = sum of ct[k, i] over i with idx[i] == r, out of
// range indices dropped. It must give the same bits on every call (replay
// gradients are compared with direct ones, and a run must repeat), so there
// are no float atomics anywhere. Summation order, fixed by R alone:
//   1. R is cut into B contiguous block slices (B = ceil(R / chunk)); a block's
//      slice is cut into SS_WARPS contiguous warp slices.
//   2. A warp walks its slice 32 elements at a time, in order. In each step
//      the lanes holding the same row find each other (__match_any_sync); each
//      group is summed in lane order (0 + v_l0 + v_l1 + ...), and its lowest
//      lane adds that sum to the warp's own shared-memory row sum. Groups of
//      one step have distinct rows, and only this warp writes its row sums.
//   3. At the end of the slice the block adds its warps' row sums in warp
//      order and writes one partial per (column, block, row).
//   4. scatter_sum_final adds the B partials of each row in block order.
// Tables with more rows than fit shared memory are processed in row tiles,
// each tile re-reading the slice: work is O(R) per tile plus O(B n) for the
// partials. Bound: bytes (8 bytes read per element: the cotangent and its
// index).
//
// segment_sum_kernel is the same reduction for tables with many rows (an
// image texture's 524 288 texels), where the tile loop re-reads the slice
// once per 3072 rows and the partials take K * B * n elements. The wrapper
// sorts the index stably (torch.sort(stable=True): equal rows keep their
// positions in ascending order), so the order of the sum depends on the
// index alone: one warp per row finds its run in the sorted index by binary
// search, lane l adds the run's elements l, l+32, ... in order, and the 32
// lane sums are added in a fixed shuffle tree. No atomics; out of range
// indices fall outside every row's run and are dropped. Bound: bytes (the
// sorted index and its permutation, and one gather of each cotangent).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int G_THREADS = 256;
constexpr int SS_WARPS = 4;
constexpr int SS_THREADS = 32 * SS_WARPS;
constexpr int SS_SMEM_BYTES = 48 * 1024;
constexpr int SEG_THREADS = 256;
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

template <typename T>
__global__ void __launch_bounds__(SS_THREADS)
    scatter_sum_partial(const T* __restrict__ ct, const int* __restrict__ idx,
                        long long R, int n, int tile_rows, long long chunk,
                        T* __restrict__ partial) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* hist = reinterpret_cast<T*>(smem_raw);  // SS_WARPS x tile_rows
    const int k = blockIdx.y;
    const int B = gridDim.x, b = blockIdx.x;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const T* ctk = ct + (size_t)k * R;
    const long long lo = (long long)b * chunk;
    const long long hi = lo + chunk < R ? lo + chunk : R;
    const long long wchunk = (chunk + SS_WARPS - 1) / SS_WARPS;
    const long long wlo = lo + warp * wchunk;
    const long long whi = wlo + wchunk < hi ? wlo + wchunk : hi;
    T* mine = hist + warp * tile_rows;

    for (int r0 = 0; r0 < n; r0 += tile_rows) {
        const int rows = n - r0 < tile_rows ? n - r0 : tile_rows;
        for (int r = threadIdx.x; r < SS_WARPS * tile_rows; r += SS_THREADS)
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
            const unsigned peers = __match_any_sync(0xffffffffu, key);
            T acc = T(0);
#pragma unroll
            for (int s = 0; s < 32; ++s) {
                const T vs = __shfl_sync(0xffffffffu, v, s);
                if (peers & (1u << s)) acc = acc + vs;
            }
            if (key >= 0 && lane == __ffs(peers) - 1)
                mine[key] = mine[key] + acc;
            __syncwarp();
        }
        __syncthreads();
        for (int r = threadIdx.x; r < rows; r += SS_THREADS) {
            T s = hist[r];
            for (int w = 1; w < SS_WARPS; ++w) s = s + hist[w * tile_rows + r];
            partial[((size_t)k * B + b) * n + r0 + r] = s;
        }
        __syncthreads();
    }
}

template <typename T>
__global__ void __launch_bounds__(G_THREADS)
    scatter_sum_final(const T* __restrict__ partial, int B, int n, int K,
                      T* __restrict__ out) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)K * n) return;
    const int k = (int)(t / n), r = (int)(t % n);
    const T* p = partial + (size_t)k * B * n + r;
    T s = p[0];
    for (int b = 1; b < B; ++b) s = s + p[(size_t)b * n];
    out[t] = s;
}

// First position in the ascending array a[0, R) whose value is >= key.
__device__ __forceinline__ long long lower_bound(const int* __restrict__ a,
                                                 long long R, int key) {
    long long lo = 0, hi = R;
    while (lo < hi) {
        const long long mid = (lo + hi) >> 1;
        if (__ldg(a + mid) < key)
            lo = mid + 1;
        else
            hi = mid;
    }
    return lo;
}

// out[k, r] = sum over the run of row r in the sorted index `sidx` of
// ct[k, perm[i]]; one warp per row, grid-stride over rows.
template <typename T>
__global__ void __launch_bounds__(SEG_THREADS)
    segment_sum_kernel(const T* __restrict__ ct, const int* __restrict__ sidx,
                       const long long* __restrict__ perm, long long R, int n,
                       int K, T* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const long long warps = (long long)gridDim.x * (SEG_THREADS / 32);
    // the row is the same for all lanes of a warp: every lane takes part in
    // the shuffles
    for (long long r = (long long)blockIdx.x * (SEG_THREADS / 32)
                       + (threadIdx.x >> 5);
         r < n; r += warps) {
        long long lo = 0, hi = 0;
        if (lane == 0) {
            lo = lower_bound(sidx, R, (int)r);
            hi = lower_bound(sidx, R, (int)r + 1);
        }
        lo = __shfl_sync(FULL_MASK, lo, 0);
        hi = __shfl_sync(FULL_MASK, hi, 0);
        for (int k = 0; k < K; ++k) {
            const T* ctk = ct + (size_t)k * R;
            T acc = T(0);
            for (long long i = lo + lane; i < hi; i += 32)
                acc = acc + __ldg(ctk + __ldg(perm + i));
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                acc = acc + __shfl_down_sync(FULL_MASK, acc, off);
            if (lane == 0) out[(size_t)k * n + r] = acc;
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

template <typename T>
int launch_scatter_sum(const void* ct, const void* idx, long long R, int n,
                       int K, int B, long long chunk, void* partial, void* out,
                       cudaStream_t st) {
    int tile_rows = SS_SMEM_BYTES / (SS_WARPS * (int)sizeof(T));
    if (tile_rows > n) tile_rows = n;
    const size_t smem = (size_t)SS_WARPS * tile_rows * sizeof(T);
    scatter_sum_partial<T><<<dim3(B, K), SS_THREADS, smem, st>>>(
        static_cast<const T*>(ct), static_cast<const int*>(idx), R, n,
        tile_rows, chunk, static_cast<T*>(partial));
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    const long long total = (long long)K * n;
    scatter_sum_final<T><<<(int)((total + G_THREADS - 1) / G_THREADS),
                           G_THREADS, 0, st>>>(static_cast<const T*>(partial),
                                               B, n, K, static_cast<T*>(out));
    return (int)cudaGetLastError();
}

template <typename T>
int launch_segment_sum(const void* ct, const void* sidx, const void* perm,
                       long long R, int n, int K, void* out, cudaStream_t st) {
    const long long rows_per_block = SEG_THREADS / 32;
    long long blocks = (n + rows_per_block - 1) / rows_per_block;
    if (blocks > 132 * 16) blocks = 132 * 16;
    segment_sum_kernel<T><<<(int)blocks, SEG_THREADS, 0, st>>>(
        static_cast<const T*>(ct), static_cast<const int*>(sidx),
        static_cast<const long long*>(perm), R, n, K, static_cast<T*>(out));
    return (int)cudaGetLastError();
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
// (is_double 0) or double (1). `partial` is scratch of K * B * n elements;
// block b sums elements [b * chunk, (b + 1) * chunk).
extern "C" int rt_scatter_sum_launch(const void* ct, const void* idx,
                                     long long R, int n, int K, int is_double,
                                     int B, long long chunk, void* partial,
                                     void* out, void* stream) {
    if (n < 1 || K < 1 || R < 1 || B < 1 || chunk < 1
        || (long long)B * chunk < R)
        return (int)cudaErrorInvalidValue;
    (void)cudaGetLastError();
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_double)
        return launch_scatter_sum<double>(ct, idx, R, n, K, B, chunk, partial,
                                          out, st);
    return launch_scatter_sum<float>(ct, idx, R, n, K, B, chunk, partial, out,
                                     st);
}

// out[k, r] = sum of ct[k, i] over idx[i] == r, for ct (K, R) float
// (is_double 0) or double (1), from the stably sorted index `sidx` (int32)
// and its permutation `perm` (int64): sidx[i] = idx[perm[i]].
extern "C" int rt_segment_sum_launch(const void* ct, const void* sidx,
                                     const void* perm, long long R, int n,
                                     int K, int is_double, void* out,
                                     void* stream) {
    if (n < 1 || K < 1 || R < 1) return (int)cudaErrorInvalidValue;
    (void)cudaGetLastError();
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_double)
        return launch_segment_sum<double>(ct, sidx, perm, R, n, K, out, st);
    return launch_segment_sum<float>(ct, sidx, perm, R, n, K, out, st);
}
