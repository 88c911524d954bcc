"""Counter-based RNG shared by the plain PyTorch path and the CUDA kernel.

Port of rust_tracing_tpu/ops/hashrng.py, bit-exact. Every random draw in a
render is addressed by ``(seed, pixel_id, sample, bounce, site)`` and produced
by a murmur3-style integer finalizer, a pure function of the address, so
renders do not depend on launch geometry, pixel ranges or sample splits, and
the kernel (csrc/hashrng.cuh, the same function on ``uint32_t``) draws the
same streams as this module.

torch has no usable uint32 arithmetic, so the 32-bit lanes live in int32:
add and multiply wrap in two's complement exactly like uint32, and a logical
right shift is an arithmetic shift followed by a mask of the sign-extended
bits. Floats come from ``.view(torch.float32)`` of the stuffed mantissa.

Site constants: each *call site* in the per-bounce program uses a fixed site
id below, NOT a sequential counter, so optional draws (defocus off, media
masked out) never shift later sites between paths or scenes.
"""

from __future__ import annotations

import torch

_TWO_PI = 6.283185307179586

# Weights folding each address component into the base counter.
_W = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1)
_SITE_MULT = 0x01000193  # FNV prime, spreads site ids

# ---- site ids (shared contract between camera.py, ops/megakernel.py and
# csrc/render_kernel.cu; keep in sync or streams diverge) -------------------
SITE_PIXEL_JX = 1
SITE_PIXEL_JY = 2
SITE_DEFOCUS_R = 3
SITE_DEFOCUS_TH = 4
SITE_TIME = 5
# per-bounce sites
SITE_SCATTER_Z = 10      # unit vector z
SITE_SCATTER_PHI = 11    # unit vector phi
SITE_FUZZ_Z = 12         # metal fuzz ball: unit vector z
SITE_FUZZ_PHI = 13       # metal fuzz ball: unit vector phi
SITE_FUZZ_R = 14         # metal fuzz ball: radius U^(1/3)
SITE_SCHLICK = 15        # dielectric reflect/refract coin
SITE_MEDIUM = 64         # medium i draws at SITE_MEDIUM + i


def _i32(v: int) -> int:
    """Python int -> the int32 value with the same low 32 bits."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor -> int32 tensor holding its low 32 bits."""
    if x.dtype == torch.int32:
        return x
    return (x.to(torch.int64) & 0xFFFFFFFF).add(1 << 31).remainder(
        1 << 32).sub(1 << 31).to(torch.int32)


def _srl(h: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int32 lanes."""
    return (h >> k) & ((1 << (32 - k)) - 1)


def _mix(h: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 finalizer (public constants) on int32 lanes."""
    h = h ^ _srl(h, 16)
    h = h * _i32(0x85EBCA6B)
    h = h ^ _srl(h, 13)
    h = h * _i32(0xC2B2AE35)
    h = h ^ _srl(h, 16)
    return h


def _bits_to_unit_float(h: torch.Tensor) -> torch.Tensor:
    """32 random bits -> f32 in [0, 1) via mantissa stuffing (exact)."""
    mant = _srl(h, 9) | 0x3F800000
    return mant.view(torch.float32) - 1.0


class CounterRng:
    """RNG scoped to an address prefix (e.g. ``(seed, pixel, sample, bounce)``).

    ``indices`` are Python ints or integer tensors (broadcast together); draws
    return f32 tensors of the broadcast shape. Use ``uniform(site)`` with an
    explicit site id for single draws; the composite samplers consume fixed
    site pairs.
    """

    def __init__(self, *indices, device=None):
        const = 0  # Python-int components fold on the host, mod 2^32
        base = None
        for i, ix in enumerate(indices):
            if isinstance(ix, torch.Tensor):
                term = _as_i32(ix) * _i32(_W[i])
                base = term if base is None else base + term
            else:
                const = (const + int(ix) * _W[i]) & 0xFFFFFFFF
        if base is None:
            base = torch.zeros((), dtype=torch.int32, device=device)
        self.base = base + _i32(const)

    def uniform(self, site: int) -> torch.Tensor:
        h = _mix(self.base + _i32(site * _SITE_MULT))
        return _bits_to_unit_float(h)

    def unit_vector(self, site_z: int, site_phi: int):
        """Uniform direction on S^2 (component tuple, closed form)."""
        z = 1.0 - 2.0 * self.uniform(site_z)
        phi = _TWO_PI * self.uniform(site_phi)
        s = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        return s * torch.cos(phi), s * torch.sin(phi), z

    def in_unit_sphere(self, site_z: int, site_phi: int, site_r: int):
        """Uniform point in the unit ball: direction x U^(1/3), the cube root
        taken as exp(log(u)/3) like the reference (not cbrt)."""
        ux, uy, uz = self.unit_vector(site_z, site_phi)
        u = torch.clamp(self.uniform(site_r), min=1e-30)
        r = torch.exp(torch.log(u) * (1.0 / 3.0))
        return r * ux, r * uy, r * uz

    def in_unit_disk(self, site_r: int, site_th: int):
        """Uniform point in the unit disk: polar with r = sqrt(U)."""
        r = torch.sqrt(self.uniform(site_r))
        th = _TWO_PI * self.uniform(site_th)
        return r * torch.cos(th), r * torch.sin(th)
