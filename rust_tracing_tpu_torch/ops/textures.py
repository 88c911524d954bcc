"""Texture evaluation over type-coded texture tables.

PyTorch counterpart of rust_tracing_tpu/ops/textures.py for the solid and
checker families (reference: src/texture.rs:16-70): every texture type the
scene holds is evaluated over all rays and the per-ray value selected by type
code, in component form (dense ``(R,)`` lanes). Float lookups go through
``tgather`` so that gradients reach ``tex_rgb``.

The noise (Perlin marble) and image families are not ported yet: noise waits
for the Perlin turbulence kernel (the reference's B7, ops/perlin_tpu.py) and
both wait for the deferred-shading slice. A scene that holds either raises
NotImplementedError here.
"""

from __future__ import annotations

import torch

from ..models.scene import TEX_CHECKER
from .tgather import tgather


def _check_families(scene):
    if scene.has_noise:
        raise NotImplementedError(
            "noise textures in the tensor integrator are not ported yet: they "
            "wait for the Perlin turbulence kernel (B7, ops/perlin_tpu.py of "
            "the reference) and the deferred-shading slice")
    if scene.has_image:
        raise NotImplementedError(
            "image textures in the tensor integrator are not ported yet: they "
            "wait for the deferred-shading slice")


def _leaf_value_c(scene, tid, u, v, px, py, pz):
    """(r, g, b) of non-checker textures for ids ``tid``: solid colours
    (texture.rs:16-36), one column gather per channel."""
    _check_families(scene)
    r = tgather(scene.tex_rgb[:, 0], tid)
    g = tgather(scene.tex_rgb[:, 1], tid)
    b = tgather(scene.tex_rgb[:, 2], tid)
    return r, g, b


def texture_value_c(scene, tid, u, v, px, py, pz):
    """Component-form texture evaluation -> ``(r, g, b)`` dense lanes."""
    r, g, b = _leaf_value_c(scene, tid, u, v, px, py, pz)

    if scene.has_checker:
        # 3-D world-space parity of floor(p / scale) (texture.rs:59-70): int32
        # sum of the floors, floored modulus (Python semantics, like jnp's %)
        inv = tgather(scene.tex_inv_scale, tid)
        fsum = (torch.floor(inv * px).to(torch.int32)
                + torch.floor(inv * py).to(torch.int32)
                + torch.floor(inv * pz).to(torch.int32))
        is_even = fsum % 2 == 0
        er, eg, eb = _leaf_value_c(scene, tgather(scene.tex_even, tid), u, v,
                                   px, py, pz)
        orr, og, ob = _leaf_value_c(scene, tgather(scene.tex_odd, tid), u, v,
                                    px, py, pz)
        is_chk = tgather(scene.tex_type, tid) == TEX_CHECKER
        r = torch.where(is_chk, torch.where(is_even, er, orr), r)
        g = torch.where(is_chk, torch.where(is_even, eg, og), g)
        b = torch.where(is_chk, torch.where(is_even, eb, ob), b)

    return r, g, b


def texture_value(scene, tid, u, v, p):
    """Evaluate texture ids ``tid`` at (u, v, p) -> ``[..., 3]``."""
    r, g, b = texture_value_c(scene, tid, u, v, p[..., 0], p[..., 1],
                              p[..., 2])
    return torch.stack([r, g, b], dim=-1)
