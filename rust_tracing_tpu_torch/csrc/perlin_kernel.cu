// Perlin turbulence kernel for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas kernel of rust_tracing_tpu/ops/perlin_tpu.py
// (`_kernel`, called through `turbulence`): the exact table Perlin
// turbulence |sum_{k<depth} 0.5^k noise(2^k p)| of src/perlin.rs:52-64 over a
// flat array of lanes, in one launch.
//
// Design for this card: one thread per lane (grid-stride). The four 256-entry
// tables (perm_x, perm_y, perm_z as int, and the three gradient columns) are
// staged once per block in shared memory, 4 KB in f32, where the TPU kernel
// keeps them as row-replicated VMEM tiles and gathers with masked lane
// shuffles. Each lookup is then one shared-memory load; the octave and corner
// loops run in registers. Bound: operations. A lane reads 12 bytes and writes
// 4 (f32); its work is depth x (15 + 8 x 14) flop plus 8 x 3 + 6 table loads a
// octave.
//
// Arithmetic contract with the plain PyTorch version (ops/perlin.py,
// `turbulence_c`): the same operations in the same order, floor, Hermite
// u*u*(3-2u), the corner loop di -> dj -> dk with acc = acc + wx*wy*wz*dot,
// octave accumulation acc = acc + w * noise(p * s) with w *= 0.5, s *= 2,
// then fabs. No transcendental is used; build with `--fmad=false` so no
// multiply-add is contracted (a contracted u*u*(3-2u) is the most likely
// single-ulp difference). The result is equal bit for bit.
//
// Positions are expected finite and within int32 after scaling by
// 2^(depth-1): the caller replaces lanes that need no value with 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int PERLIN_N = 256;
constexpr int P_THREADS = 256;

template <typename T>
__device__ __forceinline__ T noise(const int* __restrict__ sperm,
                                   const T* __restrict__ srv, T px, T py,
                                   T pz) {
    const T fx = floor(px), fy = floor(py), fz = floor(pz);
    const int ix = (int)fx, iy = (int)fy, iz = (int)fz;
    const T ux = px - fx, uy = py - fy, uz = pz - fz;
    const T sx = ux * ux * (T(3) - T(2) * ux);
    const T sy = uy * uy * (T(3) - T(2) * uy);
    const T sz = uz * uz * (T(3) - T(2) * uz);
    int hx[2], hy[2], hz[2];
#pragma unroll
    for (int d = 0; d < 2; ++d) {
        hx[d] = sperm[(ix + d) & 255];
        hy[d] = sperm[PERLIN_N + ((iy + d) & 255)];
        hz[d] = sperm[2 * PERLIN_N + ((iz + d) & 255)];
    }
    T acc = T(0);
#pragma unroll
    for (int di = 0; di < 2; ++di) {
        const T wx = di ? sx : T(1) - sx;
#pragma unroll
        for (int dj = 0; dj < 2; ++dj) {
            const T wy = dj ? sy : T(1) - sy;
#pragma unroll
            for (int dk = 0; dk < 2; ++dk) {
                const T wz = dk ? sz : T(1) - sz;
                const int h = hx[di] ^ hy[dj] ^ hz[dk];
                const T dot = srv[h] * (ux - T(di))
                              + srv[PERLIN_N + h] * (uy - T(dj))
                              + srv[2 * PERLIN_N + h] * (uz - T(dk));
                acc = acc + wx * wy * wz * dot;
            }
        }
    }
    return acc;
}

// rv (3, 256) gradient columns x y z; perm (3, 256) int32; px, py, pz, out
// (R,).
template <typename T>
__global__ void __launch_bounds__(P_THREADS)
    perlin_kernel(const T* __restrict__ rv, const int* __restrict__ perm,
                  const T* __restrict__ px, const T* __restrict__ py,
                  const T* __restrict__ pz, long long R, int depth,
                  T* __restrict__ out) {
    __shared__ int sperm[3 * PERLIN_N];
    __shared__ T srv[3 * PERLIN_N];
    for (int i = threadIdx.x; i < 3 * PERLIN_N; i += P_THREADS) {
        sperm[i] = __ldg(perm + i);
        srv[i] = __ldg(rv + i);
    }
    __syncthreads();
    const long long stride = (long long)gridDim.x * P_THREADS;
    for (long long i = (long long)blockIdx.x * P_THREADS + threadIdx.x; i < R;
         i += stride) {
        const T x = __ldg(px + i), y = __ldg(py + i), z = __ldg(pz + i);
        T acc = T(0);
        T w = T(1), s = T(1);
        for (int o = 0; o < depth; ++o) {
            acc = acc + w * noise<T>(sperm, srv, x * s, y * s, z * s);
            w = w * T(0.5);
            s = s * T(2);
        }
        out[i] = fabs(acc);
    }
}

template <typename T>
int launch_perlin(const void* rv, const void* perm, const void* px,
                  const void* py, const void* pz, long long R, int depth,
                  void* out, cudaStream_t st) {
    long long blocks = (R + P_THREADS - 1) / P_THREADS;
    if (blocks > 132 * 16) blocks = 132 * 16;
    perlin_kernel<T><<<(int)blocks, P_THREADS, 0, st>>>(
        static_cast<const T*>(rv), static_cast<const int*>(perm),
        static_cast<const T*>(px), static_cast<const T*>(py),
        static_cast<const T*>(pz), R, depth, static_cast<T*>(out));
    return (int)cudaGetLastError();
}

}  // namespace

// Turbulence of R lanes on `stream`, f32 (is_double 0) or f64 (1). `rv` is the
// (3, 256) gradient table in the positions' type, `perm` the (3, 256) int32
// permutation tables. Does not synchronise. Returns cudaGetLastError().
extern "C" int rt_perlin_launch(const void* rv, const void* perm,
                                const void* px, const void* py, const void* pz,
                                long long R, int depth, int is_double,
                                void* out, void* stream) {
    if (R < 1 || depth < 1) return (int)cudaErrorInvalidValue;
    (void)cudaGetLastError();
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_double)
        return launch_perlin<double>(rv, perm, px, py, pz, R, depth, out, st);
    return launch_perlin<float>(rv, perm, px, py, pz, R, depth, out, st);
}
