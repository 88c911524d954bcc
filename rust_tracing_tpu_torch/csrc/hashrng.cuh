// Counter-based RNG: the same function as ops/hashrng.py, on uint32_t.
//
// Every draw is addressed by (seed, pixel, sample, bounce, site) and produced
// by the murmur3 fmix32 finalizer, so the kernel consumes bit for bit the
// streams of the plain PyTorch version. Site ids must match ops/hashrng.py.
#pragma once

#include <stdint.h>

namespace rt {

constexpr uint32_t RNG_W0 = 0x9E3779B1u;  // seed
constexpr uint32_t RNG_W1 = 0x85EBCA77u;  // pixel
constexpr uint32_t RNG_W2 = 0xC2B2AE3Du;  // global sample index
constexpr uint32_t RNG_W3 = 0x27D4EB2Fu;  // bounce
constexpr uint32_t RNG_SITE_MULT = 0x01000193u;

constexpr uint32_t SITE_PIXEL_JX = 1;
constexpr uint32_t SITE_PIXEL_JY = 2;
constexpr uint32_t SITE_DEFOCUS_R = 3;
constexpr uint32_t SITE_DEFOCUS_TH = 4;
constexpr uint32_t SITE_TIME = 5;
constexpr uint32_t SITE_SCATTER_Z = 10;
constexpr uint32_t SITE_SCATTER_PHI = 11;
constexpr uint32_t SITE_FUZZ_Z = 12;
constexpr uint32_t SITE_FUZZ_PHI = 13;
constexpr uint32_t SITE_FUZZ_R = 14;
constexpr uint32_t SITE_SCHLICK = 15;
constexpr uint32_t SITE_MEDIUM = 64;  // medium i draws at SITE_MEDIUM + i

// f32(6.283185307179586), the value the plain version multiplies by
constexpr float RNG_TWO_PI = 6.283185307179586f;

__device__ __forceinline__ uint32_t rng_mix(uint32_t h) {
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return h;
}

// 32 random bits -> f32 in [0, 1) via mantissa stuffing (exact).
__device__ __forceinline__ float rng_bits_to_unit_float(uint32_t h) {
    return __uint_as_float((h >> 9) | 0x3F800000u) - 1.0f;
}

struct CounterRng {
    uint32_t base;

    // camera scope: (seed, pixel, sample)
    __device__ CounterRng(uint32_t seed, uint32_t pixel, uint32_t sample)
        : base(seed * RNG_W0 + pixel * RNG_W1 + sample * RNG_W2) {}
    // bounce scope: (seed, pixel, sample, bounce)
    __device__ CounterRng(uint32_t seed, uint32_t pixel, uint32_t sample,
                          uint32_t bounce)
        : base(seed * RNG_W0 + pixel * RNG_W1 + sample * RNG_W2
               + bounce * RNG_W3) {}

    __device__ __forceinline__ float uniform(uint32_t site) const {
        return rng_bits_to_unit_float(rng_mix(base + site * RNG_SITE_MULT));
    }

    // Uniform direction on S^2, closed form.
    __device__ __forceinline__ void unit_vector(uint32_t site_z,
                                                uint32_t site_phi, float& x,
                                                float& y, float& z) const {
        z = 1.0f - 2.0f * uniform(site_z);
        const float phi = RNG_TWO_PI * uniform(site_phi);
        const float s = sqrtf(fmaxf(1.0f - z * z, 0.0f));
        x = s * cosf(phi);
        y = s * sinf(phi);
    }

    // Uniform point in the unit ball: direction x U^(1/3), the cube root as
    // exp(log(u)/3) with u >= 1e-30 (not cbrtf: the plain version does this).
    __device__ __forceinline__ void in_unit_sphere(uint32_t site_z,
                                                   uint32_t site_phi,
                                                   uint32_t site_r, float& x,
                                                   float& y, float& z) const {
        float ux, uy, uz;
        unit_vector(site_z, site_phi, ux, uy, uz);
        const float u = fmaxf(uniform(site_r), 1e-30f);
        const float r = expf(logf(u) * (float)(1.0 / 3.0));
        x = r * ux;
        y = r * uy;
        z = r * uz;
    }

    // Uniform point in the unit disk: polar with r = sqrt(U).
    __device__ __forceinline__ void in_unit_disk(uint32_t site_r,
                                                 uint32_t site_th, float& x,
                                                 float& y) const {
        const float r = sqrtf(uniform(site_r));
        const float th = RNG_TWO_PI * uniform(site_th);
        x = r * cosf(th);
        y = r * sinf(th);
    }
};

}  // namespace rt
