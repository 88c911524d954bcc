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
// differentiates: select(acc >= 0, g, -g)); pass 2 runs over octaves and
// corners with the Hermite weight derivative 6u(1-u), the (u - d) offsets
// and the octave's scale s (floor contributes nothing).
// d_ranvec is an order-free fixed-point sum: each term t (3 a corner, 168 a
// lane at depth 7) is scaled by 2^k and rounded once to an integer
// (Fixed<T>::quantize), and integers are summed exactly, so the result has
// the same bits whatever the order of the additions, the grid or the card.
// A block adds the integers' 16-bit limbs into its own shared tables with
// 32-bit integer atomics (add_fixed; no carries, see LIMBS), drains them
// into registers every few iterations, and adds its sums into `acc` by one
// 64-bit global integer atomic a word; perlin_backward_final converts the
// 768 sums to T. No float atomics. The scale: every term has |t| <= |g_i|
// * 0.5^octave (the weights lie in [0, 1], |u - d| <= 1), so the terms of
// one entry sum to at most 16 * R * max|g| < 2^(4 + ceil(log2 R) + e) for
// max|g| < 2^e; with k = 58 - ceil(log2 R) - e the integers sum to under
// 2^62 + 4 * depth * R: no int64 overflows (f64's second word, |q| <= 2^31
// a term, needs depth * R < 2^29). perlin_backward_scale finds max|g|
// first (an integer atomicMax of its bits). The grid is the blocks that
// fit the card (4 of 256 threads an SM in f32, by shared memory).
// What bounds it: the shared-memory pipe. At 2^22 f32 lanes with every g
// nonzero a lane issues 336 32-bit atomics (2 limbs x 168 terms: ~0.4 ms
// at the rate turbulence_study.py atomics measures on an H100) beside
// both passes' table loads; chip_smoke.py measures (NVIDIA H100 80GB
// HBM3, 700 W) 1.12 ms with d_ranvec, 0.51 without, against 0.19 ms by
// operations. A warp whose lanes all have g == 0 skips both passes: the
// texture gradient's calls are mostly such warps.
//
// Arithmetic contract with the plain PyTorch versions (ops/perlin.py,
// `turbulence_c` and `turbulence_vjp_c`): the same operations in the same
// order. Forward: floor, Hermite u*u*(3-2u), the corner loop di -> dj -> dk
// with acc = acc + wx*wy*wz*dot, octave accumulation acc = acc + w *
// noise(p * s) with w *= 0.5, s *= 2, then fabs. No transcendental is used;
// build with `--fmad=false` so no multiply-add is contracted. The forward,
// d_px, d_py, d_pz and d_ranvec (whose scaling, rounding and conversion
// ops/perlin_fused.py repeats: `fixed_scale`, `_quantize`, `_fixed_value`)
// are equal bit for bit.
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
// d_ranvec's entries: 256 rows x 3
constexpr int ACC_WORDS = 3 * PERLIN_N;

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

// d_ranvec's fixed-point sum. Fixed<T>::quantize turns a term t into WORDS
// integers; Fixed<T>::value turns their sums back into T. Both are
// repeated op by op in ops/perlin_fused.py (`_quantize`, `_fixed_value`).
// With k from fixed_exponent, a term is y = (t * 2^ka) * 2^kb, k = ka + kb,
// both factors powers of two in T's range (an exact scaling unless y is
// subnormal); f32 sums rint(y), f64 rint(y) and rint((y - rint(y)) * 2^32),
// a second word of 32 more fraction bits.
template <typename T>
struct Fixed;

template <>
struct Fixed<float> {
    static constexpr int WORDS = 1;
    static constexpr int KMIN = -126, KMAX = 127;
    __device__ static __forceinline__ float pow2(int e) {
        return __int_as_float((e + 127) << 23);
    }
    __device__ static __forceinline__ void quantize(float t, float sa,
                                                    float sb, long long* q) {
        q[0] = __float2ll_rn((t * sa) * sb);
    }
};

template <>
struct Fixed<double> {
    static constexpr int WORDS = 2;
    static constexpr int KMIN = -1022, KMAX = 1023;
    __device__ static __forceinline__ double pow2(int e) {
        return __longlong_as_double((long long)(e + 1023) << 52);
    }
    __device__ static __forceinline__ void quantize(double t, double sa,
                                                    double sb, long long* q) {
        const double y = (t * sa) * sb;
        const double hi = rint(y);
        q[0] = __double2ll_rn(hi);
        q[1] = __double2ll_rn((y - hi) * 4294967296.0);
    }
};

// The scale of the fixed-point sum: k = 58 - ceil(log2 R) - e, where
// max|g| < 2^e (frexp's exponent; 0 for max|g| == 0). Split as k = ka + kb
// with ka clamped to T's normal exponents. Returns false when max|g| is not
// finite (d_ranvec is then NaN). `gmax` holds the bits of max|g|.
template <typename T>
__device__ __forceinline__ bool fixed_exponent(unsigned long long gmax,
                                               long long R, int& ka, int& kb) {
    int e = 0;
    if (sizeof(T) == 4) {
        const float m = __uint_as_float((unsigned)gmax);
        if (!(m <= 3.402823466e38f)) return false;
        frexpf(m, &e);
    } else {
        const double m = __longlong_as_double((long long)gmax);
        if (!(m <= 1.7976931348623157e308)) return false;
        frexp(m, &e);
    }
    const int r = 64 - __clzll((unsigned long long)(R - 1));
    const int k = 58 - r - e;
    ka = k < Fixed<T>::KMIN ? Fixed<T>::KMIN
                            : (k > Fixed<T>::KMAX ? Fixed<T>::KMAX : k);
    kb = k - ka;
    return true;
}

// The block tables: each of the 768 x WORDS integer sums is kept as three
// 32-bit words a sign, limbs of the magnitudes: bits 0-15, 16-31 and 32-63.
// Hopper's 64-bit shared-memory atomicAdd is a compare-and-swap loop
// (ATOMS.CAST.SPIN.64, ~7.6x the time of the 32-bit one, a single
// ATOMS.ADD, for random adds on an H100: turbulence_study.py atomics).
// 16-bit limbs need no carry, and so no atomic whose result is waited for
// (a 32-bit low word with its carry measured slower), and a word takes
// 65 536 adds before it could overflow: the block drains its tables into
// registers every drain_iters(depth) iterations. The third limb is added only where a
// magnitude reaches 2^32 (rare: it sums to < 2^30, since a word's |q| sum
// to < 2^62).
constexpr int LIMBS = 3;

__device__ __forceinline__ void add_fixed(unsigned* tab, int word,
                                          long long q) {
    const int at = q < 0 ? word + ACC_WORDS : word;
    const unsigned long long m = q < 0 ? 0ull - (unsigned long long)q
                                       : (unsigned long long)q;
    atomicAdd(tab + at, (unsigned)m & 0xffffu);
    atomicAdd(tab + at + 2 * ACC_WORDS, ((unsigned)m >> 16) & 0xffffu);
    if (m >> 32) atomicAdd(tab + at + 4 * ACC_WORDS, (unsigned)(m >> 32));
}

// Block iterations (of BWD_THREADS lanes) between drains: a limb word gets
// at most 8 x depth adds a lane, each < 2^16, so 32 / depth iterations
// stay under 2^32 (depth <= 32).
__host__ __device__ constexpr int drain_iters(int depth) {
    return 32 / depth;
}

// Adds the block tables' sums of the words this thread owns (word
// threadIdx.x + BWD_THREADS * u of sum v = u / 3) into `sums` and zeroes
// them. Every thread of the block calls it.
template <int W>
__device__ __forceinline__ void drain(unsigned* tab, long long* sums) {
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 3 * W; ++u) {
        const int j = threadIdx.x + BWD_THREADS * (u % 3);
        unsigned* t = tab + (u / 3) * 2 * LIMBS * ACC_WORDS + j;
        long long v = 0;
#pragma unroll
        for (int sgn = 0; sgn < 2; ++sgn) {
            unsigned* ts = t + sgn * ACC_WORDS;
            const unsigned long long m =
                (unsigned long long)ts[0]
                + ((unsigned long long)ts[2 * ACC_WORDS] << 16)
                + ((unsigned long long)ts[4 * ACC_WORDS] << 32);
            v = sgn ? v - (long long)m : v + (long long)m;
            ts[0] = ts[2 * ACC_WORDS] = ts[4 * ACC_WORDS] = 0u;
        }
        sums[u] += v;
    }
    __syncthreads();
}

// Bits of max|g| over g (R,) into *gmax (zeroed by the launcher): the scale
// of the fixed-point sum. An integer atomicMax a block: |g|'s bits order as
// its values.
template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
    perlin_backward_scale(const T* __restrict__ g, long long R,
                          unsigned long long* __restrict__ gmax) {
    __shared__ unsigned long long wmax[BWD_WARPS];
    unsigned long long m = 0;
    for (long long i = (long long)blockIdx.x * BWD_THREADS + threadIdx.x;
         i < R; i += (long long)gridDim.x * BWD_THREADS) {
        unsigned long long b;
        if (sizeof(T) == 4)
            b = __float_as_uint((float)__ldg(g + i)) & 0x7fffffffu;
        else
            b = (unsigned long long)__double_as_longlong((double)__ldg(g + i))
                & 0x7fffffffffffffffull;
        m = b > m ? b : m;
    }
    for (int o = 16; o; o >>= 1) {
        const unsigned long long v = __shfl_xor_sync(0xffffffffu, m, o);
        m = v > m ? v : m;
    }
    if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < BWD_WARPS; ++w) m = wmax[w] > m ? wmax[w] : m;
        atomicMax(gmax, m);
    }
}

// g (R,) cotangent of the turbulence; d_px, d_py, d_pz (R,) written when
// want_p; when want_rv, acc (ACC_WORDS * WORDS words, then max|g|'s bits)
// gains this block's integer sums, by one 64-bit global atomicAdd a word.
// Dynamic shared memory: tab_bytes<T>() + PERM_BYTES, plus, when want_rv,
// the block tables (backward_smem).
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
                           T* __restrict__ d_pz,
                           unsigned long long* __restrict__ acc) {
    constexpr int W = Fixed<T>::WORDS;
    extern __shared__ __align__(16) unsigned char smem[];
    auto* stab = reinterpret_cast<typename Tab<T>::Slot*>(smem);
    auto* spair = reinterpret_cast<unsigned*>(smem + tab_bytes<T>());
    // sum v's limb l of sign s for word j at ((v * LIMBS + l) * 2 + s) *
    // ACC_WORDS + j
    unsigned* tab = reinterpret_cast<unsigned*>(smem + tab_bytes<T>()
                                                + PERM_BYTES);
    stage<T>(rv, permx, permy, permz, stab, spair);
    int ka = 0, kb = 0;
    bool fold = false;
    if (want_rv) {
        for (int i = threadIdx.x; i < 2 * LIMBS * W * ACC_WORDS;
             i += BWD_THREADS)
            tab[i] = 0u;
        fold = fixed_exponent<T>(acc[W * ACC_WORDS], R, ka, kb);
    }
    __syncthreads();
    const T sa = Fixed<T>::pow2(ka), sb = Fixed<T>::pow2(kb);
    const int rep = threadIdx.x % Tab<T>::REP;
    const int iters = drain_iters(depth);
    long long sums[3 * W] = {};
    const long long stride = (long long)gridDim.x * BWD_THREADS;
    // the loop bound is the same for the whole block: every thread takes
    // part in the drains
    int it = 0;
    for (long long base = (long long)blockIdx.x * BWD_THREADS; base < R;
         base += stride) {
        const long long i = base + threadIdx.x;
        const bool valid = i < R;
        const T x = valid ? __ldg(px + i) : T(0);
        const T y = valid ? __ldg(py + i) : T(0);
        const T z = valid ? __ldg(pz + i) : T(0);
        const T gi = valid ? __ldg(g + i) : T(0);
        T dx = T(0), dy = T(0), dz = T(0);
        // a lane with g == 0 has d_p == +0 (0 + (+-0) is +0 for the finite
        // sums of finite positions) and no d_ranvec terms: a warp of them
        // skips both passes
        if (__any_sync(0xffffffffu, gi != T(0))) {
            // pass 1: the forward's octave sum, for its sign
            const T acc1 = octave_sum<T>(spair, stab, rep, x, y, z, depth);
            const T sg = acc1 >= T(0) ? T(1) : T(-1);
            const T gs = gi * sg;
            const bool adds = fold && gs != T(0);
            // pass 2
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
                            Tab<T>::get(stab, h * Tab<T>::REP + rep, rx, ry,
                                        rz);
                            const T dot = rx * ox + ry * oy + rz * oz;
                            const T wgt = wx * wy * wz;
                            nx = nx + (dwx * wy * wz * dot + wgt * rx);
                            ny = ny + (wx * dwy * wz * dot + wgt * ry);
                            nz = nz + (wx * wy * dwz * dot + wgt * rz);
                            if (adds) {
                                const T cc = cw * wgt;
                                const T t[3] = {cc * ox, cc * oy, cc * oz};
#pragma unroll
                                for (int a = 0; a < 3; ++a) {
                                    long long q[W];
                                    Fixed<T>::quantize(t[a], sa, sb, q);
#pragma unroll
                                    for (int v = 0; v < W; ++v)
                                        add_fixed(
                                            tab + v * 2 * LIMBS * ACC_WORDS,
                                            3 * h + a, q[v]);
                                }
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
        }
        if (valid && want_p) {
            d_px[i] = dx;
            d_py[i] = dy;
            d_pz[i] = dz;
        }
        if (fold && ++it == iters) {
            drain<W>(tab, sums);
            it = 0;
        }
    }
    if (!fold) return;
    drain<W>(tab, sums);
#pragma unroll
    for (int u = 0; u < 3 * W; ++u)
        if (sums[u])
            atomicAdd(acc + (u / 3) * ACC_WORDS + threadIdx.x
                          + BWD_THREADS * (u % 3),
                      (unsigned long long)sums[u]);
}

// d_ranvec (256, 3) in T from the integer sums acc (WORDS x 768 words, then
// max|g|'s bits): one thread an entry.
template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
    perlin_backward_final(const unsigned long long* __restrict__ acc,
                          long long R, T* __restrict__ out) {
    constexpr int W = Fixed<T>::WORDS;
    const int j = blockIdx.x * BWD_THREADS + threadIdx.x;
    if (j >= ACC_WORDS) return;
    int ka, kb;
    if (!fixed_exponent<T>(acc[W * ACC_WORDS], R, ka, kb)) {
        out[j] = T(NAN);
        return;
    }
    const long long q0 = (long long)acc[j];
    double v;
    if (W == 1) {
        v = __ll2double_rn(q0);
    } else {
        // q0 + q1 / 2^32: carry q1's whole part into q0 first
        const long long q1 = (long long)acc[ACC_WORDS + j];
        v = __ll2double_rn(q0 + (q1 >> 32))
            + __ll2double_rn(q1 & 0xffffffffll) * (1.0 / 4294967296.0);
    }
    out[j] = T((v * ldexp(1.0, -ka)) * ldexp(1.0, -kb));
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
           + (want_rv ? (size_t)2 * LIMBS * Fixed<T>::WORDS * ACC_WORDS * 4
                      : 0);
}

// Blocks of perlin_backward_kernel<T> that fit the card at once, with and
// without the block tables (worked out once a type).
template <typename T>
cudaError_t backward_grid_cap(int want_rv, long long& cap) {
    static long long fit[2] = {0, 0};
    if (fit[want_rv] == 0) {
        // the larger of the two sizes, allowed once a type
        cudaError_t e = cudaFuncSetAttribute(
            perlin_backward_kernel<T>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)backward_smem<T>(1));
        if (e != cudaSuccess) return e;
        int per_sm = 0;
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, perlin_backward_kernel<T>, BWD_THREADS,
            backward_smem<T>(want_rv));
        if (e != cudaSuccess) return e;
        fit[want_rv] = (long long)sm_count() * (per_sm > 0 ? per_sm : 1);
    }
    cap = fit[want_rv];
    return cudaSuccess;
}

template <typename T>
int launch_perlin_backward(const void* rv, const void* permx,
                           const void* permy, const void* permz,
                           const void* px, const void* py, const void* pz,
                           const void* g, long long R, int depth, int want_p,
                           int want_rv, void* d_px, void* d_py, void* d_pz,
                           void* acc, void* d_rv, cudaStream_t st) {
    if (want_rv && drain_iters(depth) < 1) return (int)cudaErrorInvalidValue;
    long long fit = 0;
    cudaError_t e = backward_grid_cap<T>(want_rv, fit);
    if (e != cudaSuccess) return (int)e;
    long long blocks = (R + BWD_THREADS - 1) / BWD_THREADS;
    auto* a = static_cast<unsigned long long*>(acc);
    const long long gmax = Fixed<T>::WORDS * ACC_WORDS;
    if (want_rv) {
        e = cudaMemsetAsync(acc, 0, (gmax + 1) * 8, st);
        if (e != cudaSuccess) return (int)e;
        const long long sb = blocks < sm_count() * 4 ? blocks : sm_count() * 4;
        perlin_backward_scale<T><<<(int)sb, BWD_THREADS, 0, st>>>(
            static_cast<const T*>(g), R, a + gmax);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    if (blocks > fit) blocks = fit;
    perlin_backward_kernel<T>
        <<<(int)blocks, BWD_THREADS, backward_smem<T>(want_rv), st>>>(
            static_cast<const T*>(rv), static_cast<const int*>(permx),
            static_cast<const int*>(permy), static_cast<const int*>(permz),
            static_cast<const T*>(px), static_cast<const T*>(py),
            static_cast<const T*>(pz), static_cast<const T*>(g), R, depth,
            want_p, want_rv, static_cast<T*>(d_px), static_cast<T*>(d_py),
            static_cast<T*>(d_pz), a);
    e = cudaGetLastError();
    if (e != cudaSuccess || !want_rv) return (int)e;
    perlin_backward_final<T>
        <<<(ACC_WORDS + BWD_THREADS - 1) / BWD_THREADS, BWD_THREADS, 0, st>>>(
            a, R, static_cast<T*>(d_rv));
    return (int)cudaGetLastError();
}

}  // namespace

// 64-bit words of the backward's scratch `acc`: the integer sums of
// d_ranvec (768 a word of the fixed-point type) and max|g|'s bits.
extern "C" int rt_perlin_backward_acc_words(int is_double) {
    return (is_double ? Fixed<double>::WORDS : Fixed<float>::WORDS)
               * ACC_WORDS + 1;
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
// d_py, d_pz (R,) when want_p, d_rv (256, 3) when want_rv, through `acc`
// (rt_perlin_backward_acc_words(is_double) 64-bit words of scratch). Types
// and tables as rt_perlin_launch. Does not synchronise.
extern "C" int rt_perlin_backward_launch(
    const void* rv, const void* permx, const void* permy, const void* permz,
    const void* px, const void* py, const void* pz, const void* g,
    long long R, int depth, int is_double, int want_p, int want_rv,
    void* d_px, void* d_py, void* d_pz, void* acc, void* d_rv,
    void* stream) {
    if (R < 1 || depth < 1) return (int)cudaErrorInvalidValue;
    (void)cudaGetLastError();
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_double)
        return launch_perlin_backward<double>(
            rv, permx, permy, permz, px, py, pz, g, R, depth, want_p, want_rv,
            d_px, d_py, d_pz, acc, d_rv, st);
    return launch_perlin_backward<float>(rv, permx, permy, permz, px, py, pz,
                                         g, R, depth, want_p, want_rv, d_px,
                                         d_py, d_pz, acc, d_rv, st);
}
