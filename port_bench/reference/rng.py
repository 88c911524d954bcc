"""Counter-based RNG: every draw addressed by (seed, pixel, sample, bounce,
site) and produced by the murmur3 finaliser of the address.

uint32 lanes live in int32 tensors: add and multiply wrap like uint32, a
logical right shift is an arithmetic shift and a mask. Floats come from the
mantissa stuffed with 23 random bits, as float32; callers cast them.
"""

from __future__ import annotations

import torch

TWO_PI = 6.283185307179586
_W = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1)
_SITE_MULT = 0x01000193

SITE_PIXEL_JX = 1
SITE_PIXEL_JY = 2
SITE_TIME = 5
SITE_SCATTER_Z = 10
SITE_SCATTER_PHI = 11
SITE_FUZZ_Z = 12
SITE_FUZZ_PHI = 13
SITE_FUZZ_R = 14
SITE_SCHLICK = 15
SITE_MEDIUM = 64


def i32(v: int) -> int:
    """The int32 value with the low 32 bits of ``v``."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def srl(h: torch.Tensor, k: int) -> torch.Tensor:
    return (h >> k) & ((1 << (32 - k)) - 1)


def mix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ srl(h, 16)
    h = h * i32(0x85EBCA6B)
    h = h ^ srl(h, 13)
    h = h * i32(0xC2B2AE35)
    h = h ^ srl(h, 16)
    return h


def unit_float(h: torch.Tensor) -> torch.Tensor:
    """32 random bits -> float32 in [0, 1)."""
    return (srl(h, 9) | 0x3F800000).view(torch.float32) - 1.0


class Rng:
    """Draws of one address prefix: ``seed`` an int, the others int32
    tensors of one shape or ints."""

    def __init__(self, *indices, dtype=torch.float32):
        const, base = 0, None
        for k, ix in enumerate(indices):
            if isinstance(ix, torch.Tensor):
                term = ix.to(torch.int32) * i32(_W[k])
                base = term if base is None else base + term
            else:
                const = (const + int(ix) * _W[k]) & 0xFFFFFFFF
        if base is None:
            base = torch.zeros((), dtype=torch.int32)
        self.base = base + i32(const)
        self.dtype = dtype

    def uniform(self, site: int) -> torch.Tensor:
        return unit_float(mix(self.base + i32(site * _SITE_MULT))).to(
            self.dtype)

    def unit_vector(self, site_z: int, site_phi: int):
        z = 1.0 - 2.0 * self.uniform(site_z)
        phi = TWO_PI * self.uniform(site_phi)
        s = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        return s * torch.cos(phi), s * torch.sin(phi), z

    def in_unit_sphere(self, site_z: int, site_phi: int, site_r: int):
        ux, uy, uz = self.unit_vector(site_z, site_phi)
        u = torch.clamp(self.uniform(site_r), min=1e-30)
        r = torch.exp(torch.log(u) * (1.0 / 3.0))
        return r * ux, r * uy, r * uz
