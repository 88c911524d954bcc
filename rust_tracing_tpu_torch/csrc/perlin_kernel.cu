// Perlin turbulence kernels for Hopper (sm_90a), written by hand.
//
// perlin_kernel<T> replaces the Pallas kernel of
// rust_tracing_tpu/ops/perlin_tpu.py (`_kernel`, called through
// `turbulence`): the exact table Perlin turbulence
// |sum_{k<depth} 0.5^k noise(2^k p)| of src/perlin.rs:52-64 over a flat
// array of lanes, in one launch. perlin_backward_kernel<T> (+
// perlin_backward_final<T>) is its vector-Jacobian product, which the
// reference leaves to XLA (perlin_tpu.py:164, `_turb_jvp`).
//
// What bounds the forward on this card: shared-memory wavefronts, not
// operations. A lane gathers, each octave, 3 permutation words and 8
// gradient rows at data-dependent indices into 256-entry tables; 32 lanes
// at random indices hit the same bank at different addresses ~3 times a
// gather. The design removes the conflicts of the gradient rows, which are
// most of the loads:
// - the gradient table is a 16-byte row (x, y, z, 0) a hash, read with one
//   128-bit load a corner, and replicated REP times: lane l reads replica
//   l % REP at 16-byte slot REP*h + l % REP, so (f32, REP = 8) the 8 lanes
//   of a quarter-warp, which one wavefront of a 128-bit load serves, fall in
//   8 distinct bank groups whatever their hashes: 4 wavefronts a corner;
// - per axis the pair (perm[i], perm[(i+1) & 255]) is one 32-bit word, so
//   an octave reads 3 permutation words instead of 6;
// - each block builds this layout itself from the raw tables (ranvec (256,
//   3) in the positions' type, three int32 permutations), so the wrapper
//   does no per-call packing.
// Blocks of 512 threads (256 measured ~5 % slower), at most as many as fit
// the card at once, each striding over the lanes.
// f32: 8 replicas, 32 KB; f64: rows of 32 bytes (two 128-bit loads), 4
// replicas, 32 KB, 2-way conflicts left (f64 is on no main path).
//
// The backward: pass 1 recomputes the octave sum with the forward's own
// operations for its sign (+1 at acc == 0, as the reference's jnp.abs
// differentiates: select(acc >= 0, g, -g)); pass 2 runs over octaves and corners with the Hermite
// weight derivative 6u(1-u), the (u - d) offsets and the octave's scale s
// (floor contributes nothing). d_ranvec is deterministic, with no atomics:
// every step (octave, corner) a warp groups its lanes by hash
// (__match_any_sync), the lowest lane of a group adds its peers'
// contributions in lane order and adds the sum to the warp's own table;
// the block adds its warp tables in warp order into one partial a block;
// perlin_backward_final adds the partials in block order over a grid that
// depends on R only. Two runs give the same bits.
//
// Arithmetic contract with the plain PyTorch versions (ops/perlin.py,
// `turbulence_c` and `turbulence_vjp_c`): the same operations in the same
// order. Forward: floor, Hermite u*u*(3-2u), the corner loop di -> dj -> dk
// with acc = acc + wx*wy*wz*dot, octave accumulation acc = acc + w *
// noise(p * s) with w *= 0.5, s *= 2, then fabs. No transcendental is used;
// build with `--fmad=false` so no multiply-add is contracted. The forward
// and d_px, d_py, d_pz are equal bit for bit.
//
// Positions are expected finite and within int32 after scaling by
// 2^(depth-1): the caller replaces lanes that need no value with 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int PERLIN_N = 256;
constexpr int THREADS = 512;
constexpr int BWD_THREADS = 256;
constexpr int BWD_WARPS = BWD_THREADS / 32;
// the backward's fixed grid: partials are added in block order, so the
// grid depends on R only, never on the card
constexpr int BWD_MAX_BLOCKS = 396;

// A gradient-table row: one 16-byte slot in f32, two in f64.
template <typename T>
struct Tab;

template <>
struct Tab<float> {
    static constexpr int REP = 8;
    using Slot = float4;
    static constexpr int SLOTS = 1;  // 16-byte slots a row
    __device__ static __forceinline__ void put(Slot* t, int row, float x,
                                               float y, float z) {
        t[row] = make_float4(x, y, z, 0.f);
    }
    __device__ static __forceinline__ void get(const Slot* t, int row,
                                               float& x, float& y, float& z) {
        const float4 r = t[row];
        x = r.x;
        y = r.y;
        z = r.z;
    }
};

template <>
struct Tab<double> {
    static constexpr int REP = 4;
    using Slot = double2;
    static constexpr int SLOTS = 2;
    __device__ static __forceinline__ void put(Slot* t, int row, double x,
                                               double y, double z) {
        t[2 * row] = make_double2(x, y);
        t[2 * row + 1] = make_double2(z, 0.0);
    }
    __device__ static __forceinline__ void get(const Slot* t, int row,
                                               double& x, double& y,
                                               double& z) {
        const double2 a = t[2 * row], b = t[2 * row + 1];
        x = a.x;
        y = a.y;
        z = b.x;
    }
};

template <typename T>
__host__ __device__ constexpr int tab_bytes() {
    return PERLIN_N * Tab<T>::REP * Tab<T>::SLOTS * 16;
}
constexpr int PERM_BYTES = 3 * PERLIN_N * 4;

// Builds the block's tables in shared memory: the replicated gradient rows
// from rv (256, 3) row-major, and the packed permutation pairs.
template <typename T>
__device__ void stage(const T* __restrict__ rv, const int* __restrict__ permx,
                      const int* __restrict__ permy,
                      const int* __restrict__ permz,
                      typename Tab<T>::Slot* stab, unsigned* spair) {
    for (int i = threadIdx.x; i < 3 * PERLIN_N; i += blockDim.x) {
        const int a = i >> 8, j = i & 255;
        const int* p = a == 0 ? permx : (a == 1 ? permy : permz);
        spair[i] = (unsigned)(__ldg(p + j) & 255)
                   | ((unsigned)(__ldg(p + ((j + 1) & 255)) & 255) << 16);
    }
    for (int i = threadIdx.x; i < PERLIN_N * Tab<T>::REP; i += blockDim.x) {
        const int h = i / Tab<T>::REP;
        Tab<T>::put(stab, i, __ldg(rv + 3 * h), __ldg(rv + 3 * h + 1),
                    __ldg(rv + 3 * h + 2));
    }
}

// One octave's lattice: fractions, Hermite weights, the 2 x 2 x 2 hashes.
template <typename T>
struct Cell {
    T ux, uy, uz, sx, sy, sz;
    int hx[2], hy[2], hz[2];
};

template <typename T>
__device__ __forceinline__ Cell<T> cell(const unsigned* spair, T px, T py,
                                        T pz) {
    Cell<T> c;
    const T fx = floor(px), fy = floor(py), fz = floor(pz);
    const int ix = (int)fx, iy = (int)fy, iz = (int)fz;
    c.ux = px - fx;
    c.uy = py - fy;
    c.uz = pz - fz;
    c.sx = c.ux * c.ux * (T(3) - T(2) * c.ux);
    c.sy = c.uy * c.uy * (T(3) - T(2) * c.uy);
    c.sz = c.uz * c.uz * (T(3) - T(2) * c.uz);
    const unsigned wx = spair[ix & 255];
    const unsigned wy = spair[PERLIN_N + (iy & 255)];
    const unsigned wz = spair[2 * PERLIN_N + (iz & 255)];
    c.hx[0] = wx & 0xffff;
    c.hx[1] = wx >> 16;
    c.hy[0] = wy & 0xffff;
    c.hy[1] = wy >> 16;
    c.hz[0] = wz & 0xffff;
    c.hz[1] = wz >> 16;
    return c;
}

template <typename T>
__device__ __forceinline__ T noise(const unsigned* spair,
                                   const typename Tab<T>::Slot* stab, int rep,
                                   T px, T py, T pz) {
    const Cell<T> c = cell<T>(spair, px, py, pz);
    T acc = T(0);
#pragma unroll
    for (int di = 0; di < 2; ++di) {
        const T wx = di ? c.sx : T(1) - c.sx;
#pragma unroll
        for (int dj = 0; dj < 2; ++dj) {
            const T wy = dj ? c.sy : T(1) - c.sy;
#pragma unroll
            for (int dk = 0; dk < 2; ++dk) {
                const T wz = dk ? c.sz : T(1) - c.sz;
                const int h = c.hx[di] ^ c.hy[dj] ^ c.hz[dk];
                T rx, ry, rz;
                Tab<T>::get(stab, h * Tab<T>::REP + rep, rx, ry, rz);
                const T dot = rx * (c.ux - T(di)) + ry * (c.uy - T(dj))
                              + rz * (c.uz - T(dk));
                acc = acc + wx * wy * wz * dot;
            }
        }
    }
    return acc;
}

template <typename T>
__device__ __forceinline__ T octave_sum(const unsigned* spair,
                                        const typename Tab<T>::Slot* stab,
                                        int rep, T x, T y, T z, int depth) {
    T acc = T(0);
    T w = T(1), s = T(1);
    for (int o = 0; o < depth; ++o) {
        acc = acc + w * noise<T>(spair, stab, rep, x * s, y * s, z * s);
        w = w * T(0.5);
        s = s * T(2);
    }
    return acc;
}

// rv (256, 3) gradient rows; permx/y/z (256,) int32; px, py, pz, out (R,).
// Dynamic shared memory: tab_bytes<T>() + PERM_BYTES.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    perlin_kernel(const T* __restrict__ rv, const int* __restrict__ permx,
                  const int* __restrict__ permy, const int* __restrict__ permz,
                  const T* __restrict__ px, const T* __restrict__ py,
                  const T* __restrict__ pz, long long R, int depth,
                  T* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem[];
    auto* stab = reinterpret_cast<typename Tab<T>::Slot*>(smem);
    auto* spair = reinterpret_cast<unsigned*>(smem + tab_bytes<T>());
    stage<T>(rv, permx, permy, permz, stab, spair);
    __syncthreads();
    const int rep = threadIdx.x % Tab<T>::REP;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < R;
         i += stride) {
        const T x = __ldg(px + i), y = __ldg(py + i), z = __ldg(pz + i);
        out[i] = fabs(octave_sum<T>(spair, stab, rep, x, y, z, depth));
    }
}

// Adds the step's contributions (cx, cy, cz) of the warp's lanes to the
// warp's table at their hashes; key < 0 adds nothing. Every lane of the
// warp calls it. The lowest lane of each group of equal keys adds its
// peers' values in lane order.
template <typename T>
__device__ __forceinline__ void fold(T* wtab, T* wscr, int lane, int key,
                                     T cx, T cy, T cz) {
    __syncwarp();  // the previous step's reads of wscr are done
    wscr[3 * lane] = cx;
    wscr[3 * lane + 1] = cy;
    wscr[3 * lane + 2] = cz;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    __syncwarp();
    if (key >= 0 && lane == __ffs(peers) - 1) {
        T ax = cx, ay = cy, az = cz;
        for (unsigned m = peers & (peers - 1); m; m &= m - 1) {
            const int l = __ffs(m) - 1;
            ax = ax + wscr[3 * l];
            ay = ay + wscr[3 * l + 1];
            az = az + wscr[3 * l + 2];
        }
        wtab[3 * key] = wtab[3 * key] + ax;
        wtab[3 * key + 1] = wtab[3 * key + 1] + ay;
        wtab[3 * key + 2] = wtab[3 * key + 2] + az;
    }
}

// g (R,) cotangent of the turbulence; d_px, d_py, d_pz (R,) written when
// want_p; partial (gridDim.x, 256, 3) written when want_rv. Dynamic shared
// memory: tab_bytes<T>() + PERM_BYTES, plus, when want_rv, BWD_WARPS
// tables of 256 x 3 and BWD_WARPS scratch rows of 32 x 3 T.
template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
    perlin_backward_kernel(const T* __restrict__ rv,
                           const int* __restrict__ permx,
                           const int* __restrict__ permy,
                           const int* __restrict__ permz,
                           const T* __restrict__ px, const T* __restrict__ py,
                           const T* __restrict__ pz, const T* __restrict__ g,
                           long long R, int depth, int want_p, int want_rv,
                           T* __restrict__ d_px, T* __restrict__ d_py,
                           T* __restrict__ d_pz, T* __restrict__ partial) {
    extern __shared__ __align__(16) unsigned char smem[];
    auto* stab = reinterpret_cast<typename Tab<T>::Slot*>(smem);
    auto* spair = reinterpret_cast<unsigned*>(smem + tab_bytes<T>());
    T* tabs = reinterpret_cast<T*>(smem + tab_bytes<T>() + PERM_BYTES);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    T* wtab = tabs + warp * 3 * PERLIN_N;
    T* wscr = tabs + BWD_WARPS * 3 * PERLIN_N + warp * 3 * 32;
    stage<T>(rv, permx, permy, permz, stab, spair);
    if (want_rv)
        for (int i = threadIdx.x; i < BWD_WARPS * 3 * PERLIN_N;
             i += BWD_THREADS)
            tabs[i] = T(0);
    __syncthreads();
    const int rep = threadIdx.x % Tab<T>::REP;
    const long long stride = (long long)gridDim.x * BWD_THREADS;
    // the loop bound is the same for the whole block: every lane takes part
    // in the warp-wide match of each step
    for (long long base = (long long)blockIdx.x * BWD_THREADS; base < R;
         base += stride) {
        const long long i = base + threadIdx.x;
        const bool valid = i < R;
        const T x = valid ? __ldg(px + i) : T(0);
        const T y = valid ? __ldg(py + i) : T(0);
        const T z = valid ? __ldg(pz + i) : T(0);
        const T gi = valid ? __ldg(g + i) : T(0);
        // pass 1: the forward's octave sum, for its sign
        const T acc = octave_sum<T>(spair, stab, rep, x, y, z, depth);
        const T sg = acc >= T(0) ? T(1) : T(-1);
        const T gs = gi * sg;
        const bool adds = valid && gs != T(0);
        // pass 2
        T dx = T(0), dy = T(0), dz = T(0);
        T w = T(1), s = T(1);
        for (int o = 0; o < depth; ++o) {
            const Cell<T> c = cell<T>(spair, x * s, y * s, z * s);
            const T dsx = T(6) * c.ux * (T(1) - c.ux);
            const T dsy = T(6) * c.uy * (T(1) - c.uy);
            const T dsz = T(6) * c.uz * (T(1) - c.uz);
            const T cw = gs * w;
            T nx = T(0), ny = T(0), nz = T(0);
#pragma unroll
            for (int di = 0; di < 2; ++di) {
                const T wx = di ? c.sx : T(1) - c.sx;
                const T dwx = di ? dsx : -dsx;
                const T ox = c.ux - T(di);
#pragma unroll
                for (int dj = 0; dj < 2; ++dj) {
                    const T wy = dj ? c.sy : T(1) - c.sy;
                    const T dwy = dj ? dsy : -dsy;
                    const T oy = c.uy - T(dj);
#pragma unroll
                    for (int dk = 0; dk < 2; ++dk) {
                        const T wz = dk ? c.sz : T(1) - c.sz;
                        const T dwz = dk ? dsz : -dsz;
                        const T oz = c.uz - T(dk);
                        const int h = c.hx[di] ^ c.hy[dj] ^ c.hz[dk];
                        T rx, ry, rz;
                        Tab<T>::get(stab, h * Tab<T>::REP + rep, rx, ry, rz);
                        const T dot = rx * ox + ry * oy + rz * oz;
                        const T wgt = wx * wy * wz;
                        nx = nx + (dwx * wy * wz * dot + wgt * rx);
                        ny = ny + (wx * dwy * wz * dot + wgt * ry);
                        nz = nz + (wx * wy * dwz * dot + wgt * rz);
                        if (want_rv) {
                            const T cc = cw * wgt;
                            fold<T>(wtab, wscr, lane, adds ? h : -1, cc * ox,
                                    cc * oy, cc * oz);
                        }
                    }
                }
            }
            dx = dx + cw * nx * s;
            dy = dy + cw * ny * s;
            dz = dz + cw * nz * s;
            w = w * T(0.5);
            s = s * T(2);
        }
        if (valid && want_p) {
            d_px[i] = dx;
            d_py[i] = dy;
            d_pz[i] = dz;
        }
    }
    if (!want_rv) return;
    __syncthreads();
    for (int r = threadIdx.x; r < 3 * PERLIN_N; r += BWD_THREADS) {
        T t = tabs[r];
        for (int wp = 1; wp < BWD_WARPS; ++wp)
            t = t + tabs[wp * 3 * PERLIN_N + r];
        partial[(size_t)blockIdx.x * 3 * PERLIN_N + r] = t;
    }
}

// d_ranvec (256, 3) = the sum of B partials in block order.
template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
    perlin_backward_final(const T* __restrict__ partial, int B,
                          T* __restrict__ out) {
    const int r = blockIdx.x * BWD_THREADS + threadIdx.x;
    if (r >= 3 * PERLIN_N) return;
    T t = partial[r];
    for (int b = 1; b < B; ++b) t = t + partial[(size_t)b * 3 * PERLIN_N + r];
    out[r] = t;
}

int backward_blocks(long long R) {
    const long long b = (R + BWD_THREADS - 1) / BWD_THREADS;
    return (int)(b < 1 ? 1 : (b > BWD_MAX_BLOCKS ? BWD_MAX_BLOCKS : b));
}

int sm_count() {
    static int n = 0;
    if (n == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    }
    return n;
}

// Blocks of perlin_kernel<T> that fit the card at once, into `cap`
// (worked out once a type: the block and its shared memory are fixed).
template <typename T>
cudaError_t perlin_grid_cap(long long& cap) {
    static long long fit = 0;
    if (fit == 0) {
        int per_sm = 0;
        const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, perlin_kernel<T>, THREADS, tab_bytes<T>() + PERM_BYTES);
        if (e != cudaSuccess) return e;
        fit = (long long)sm_count() * (per_sm > 0 ? per_sm : 1);
    }
    cap = fit;
    return cudaSuccess;
}

template <typename T>
int launch_perlin(const void* rv, const void* permx, const void* permy,
                  const void* permz, const void* px, const void* py,
                  const void* pz, long long R, int depth, void* out,
                  cudaStream_t st) {
    long long fit = 0;
    const cudaError_t e = perlin_grid_cap<T>(fit);
    if (e != cudaSuccess) return (int)e;
    long long blocks = (R + THREADS - 1) / THREADS;
    if (blocks > fit) blocks = fit;
    perlin_kernel<T><<<(int)blocks, THREADS, tab_bytes<T>() + PERM_BYTES,
                       st>>>(
        static_cast<const T*>(rv), static_cast<const int*>(permx),
        static_cast<const int*>(permy), static_cast<const int*>(permz),
        static_cast<const T*>(px), static_cast<const T*>(py),
        static_cast<const T*>(pz), R, depth, static_cast<T*>(out));
    return (int)cudaGetLastError();
}

template <typename T>
size_t backward_smem(int want_rv) {
    return tab_bytes<T>() + PERM_BYTES
           + (want_rv ? (size_t)BWD_WARPS * 3 * (PERLIN_N + 32) * sizeof(T)
                      : 0);
}

template <typename T>
int launch_perlin_backward(const void* rv, const void* permx,
                           const void* permy, const void* permz,
                           const void* px, const void* py, const void* pz,
                           const void* g, long long R, int depth, int want_p,
                           int want_rv, void* d_px, void* d_py, void* d_pz,
                           void* partial, void* d_rv, cudaStream_t st) {
    const size_t smem = backward_smem<T>(want_rv);
    // the larger of the two sizes, allowed once a type
    static const cudaError_t allowed = cudaFuncSetAttribute(
        perlin_backward_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)backward_smem<T>(1));
    if (allowed != cudaSuccess) return (int)allowed;
    cudaError_t e;
    const int B = backward_blocks(R);
    perlin_backward_kernel<T><<<B, BWD_THREADS, smem, st>>>(
        static_cast<const T*>(rv), static_cast<const int*>(permx),
        static_cast<const int*>(permy), static_cast<const int*>(permz),
        static_cast<const T*>(px), static_cast<const T*>(py),
        static_cast<const T*>(pz), static_cast<const T*>(g), R, depth, want_p,
        want_rv, static_cast<T*>(d_px), static_cast<T*>(d_py),
        static_cast<T*>(d_pz), static_cast<T*>(partial));
    e = cudaGetLastError();
    if (e != cudaSuccess || !want_rv) return (int)e;
    perlin_backward_final<T>
        <<<(3 * PERLIN_N + BWD_THREADS - 1) / BWD_THREADS, BWD_THREADS, 0,
           st>>>(static_cast<const T*>(partial), B, static_cast<T*>(d_rv));
    return (int)cudaGetLastError();
}

}  // namespace

// Blocks of the backward's grid for R lanes (partial has that many rows of
// 256 x 3). A function of R only.
extern "C" int rt_perlin_backward_blocks(long long R) {
    return backward_blocks(R);
}

// Turbulence of R lanes on `stream`, f32 (is_double 0) or f64 (1). `rv` is the (256, 3) gradient table in the positions' type,
// permx/y/z the (256,) int32 permutation tables. Does not synchronise.
// Returns cudaGetLastError().
extern "C" int rt_perlin_launch(const void* rv, const void* permx,
                                const void* permy, const void* permz,
                                const void* px, const void* py, const void* pz,
                                long long R, int depth, int is_double,
                                void* out, void* stream) {
    if (R < 1 || depth < 1) return (int)cudaErrorInvalidValue;
    (void)cudaGetLastError();
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_double)
        return launch_perlin<double>(rv, permx, permy, permz, px, py, pz, R,
                                     depth, out, st);
    return launch_perlin<float>(rv, permx, permy, permz, px, py, pz, R, depth,
                                out, st);
}

// The turbulence's vector-Jacobian product for the cotangent g (R,): d_px,
// d_py, d_pz (R,) when want_p, d_rv (256, 3) when want_rv, through
// `partial` (rt_perlin_backward_blocks(R) x 256 x 3 scratch). Types and
// tables as rt_perlin_launch. Does not synchronise.
extern "C" int rt_perlin_backward_launch(
    const void* rv, const void* permx, const void* permy, const void* permz,
    const void* px, const void* py, const void* pz, const void* g,
    long long R, int depth, int is_double, int want_p, int want_rv,
    void* d_px, void* d_py, void* d_pz, void* partial, void* d_rv,
    void* stream) {
    if (R < 1 || depth < 1) return (int)cudaErrorInvalidValue;
    (void)cudaGetLastError();
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_double)
        return launch_perlin_backward<double>(
            rv, permx, permy, permz, px, py, pz, g, R, depth, want_p, want_rv,
            d_px, d_py, d_pz, partial, d_rv, st);
    return launch_perlin_backward<float>(rv, permx, permy, permz, px, py, pz,
                                         g, R, depth, want_p, want_rv, d_px,
                                         d_py, d_pz, partial, d_rv, st);
}
