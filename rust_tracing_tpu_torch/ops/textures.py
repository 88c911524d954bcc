"""Texture evaluation over type-coded texture tables.

PyTorch counterpart of rust_tracing_tpu/ops/textures.py (reference:
src/texture.rs): every texture type the scene holds is evaluated over all
rays and the per-ray value selected by type code, in component form (dense
``(R,)`` lanes). Static ``has_*`` flags of the compiled scene prune whole
families, so a solid/checker scene never pays for Perlin octaves.

Float lookups go through ``ops/tgather.py`` so that gradients reach
``tex_rgb``, ``tex_noise_scale`` and ``image`` through the deterministic
reduction; the noise turbulence is the fused kernel of ops/perlin_fused.py
(kernel B7 on a GPU), whose backward reaches ``perlin_ranvec`` and the hit
point.

The reference evaluates the image lookup and the turbulence only on 512-lane
blocks that need them (``sparse_blocked``), a workaround for XLA's serial
lowering of gathers on the TPU. Here both are evaluated densely; the inputs
of lanes that need no value are replaced by 0 first, so a missed ray's
position never reaches the kernel or a float-to-int conversion, and needed
lanes keep exactly the values the reference computes.
"""

from __future__ import annotations

import torch

from ..models.scene import TEX_CHECKER, TEX_IMAGE, TEX_NOISE
from . import perlin_fused
from .tgather import tgather, tgather_group


def _image_texels(image, lin):
    """(r, g, b) texels of ``image (H, W, 3)`` at flat rows ``lin``: one
    multi-column gather over the ``(3, H*W)`` channel columns."""
    cols = image.reshape(-1, 3).t()
    return tgather_group((cols[0], cols[1], cols[2]), lin)


def _leaf_value_c(scene, tid, u, v, px, py, pz, turb=None):
    """(r, g, b) of non-checker textures (solid/image/noise) for ids
    ``tid``."""
    # solid (texture.rs:16-36): per-channel column gathers
    r = tgather(scene.tex_rgb[:, 0], tid)
    g = tgather(scene.tex_rgb[:, 1], tid)
    b = tgather(scene.tex_rgb[:, 2], tid)
    ttype = tgather(scene.tex_type, tid)

    if scene.has_image:
        # Nearest-neighbour, u clamp, v flip, gamma-decoded at load
        # (texture.rs:83-93; decode in models/scene.py image_texture).
        h, w = scene.image.shape[0], scene.image.shape[1]
        is_img = ttype == TEX_IMAGE
        uc = torch.clamp(torch.where(is_img, u, 0.0), 0.0, 1.0)
        vc = 1.0 - torch.clamp(torch.where(is_img, v, 0.0), 0.0, 1.0)
        i = (uc * (w - 1)).to(torch.int32)
        j = (vc * (h - 1)).to(torch.int32)
        # other lanes read row -1: a gather returns 0 there and the
        # transpose drops it, so their (zero) cotangents never pile onto
        # one texel's row
        tr, tg, tb = _image_texels(scene.image,
                                   torch.where(is_img, j * w + i, -1))
        r = torch.where(is_img, tr, r)
        g = torch.where(is_img, tg, g)
        b = torch.where(is_img, tb, b)

    if scene.has_noise:
        # Marble: sin(scale*z + 10*turbulence(p,7))*0.5+0.5 (texture.rs:107-111).
        scale = tgather(scene.tex_noise_scale, tid)
        marble = torch.sin(scale * pz + 10.0 * turb) * 0.5 + 0.5
        is_noise = ttype == TEX_NOISE
        r = torch.where(is_noise, marble, r)
        g = torch.where(is_noise, marble, g)
        b = torch.where(is_noise, marble, b)

    return r, g, b


def _needs_noise(scene, tid):
    """Lanes whose texture chain can reach the noise marble: the texture
    itself, or (checker) either child."""
    ttype = tgather(scene.tex_type, tid)
    need = ttype == TEX_NOISE
    if scene.has_checker:
        is_chk = ttype == TEX_CHECKER
        for child in (scene.tex_even, scene.tex_odd):
            ct = tgather(scene.tex_type, tgather(child, tid))
            need = need | (is_chk & (ct == TEX_NOISE))
    return need


def texture_value_c(scene, tid, u, v, px, py, pz):
    """Component-form texture evaluation -> ``(r, g, b)`` dense lanes."""
    turb = None
    if scene.has_noise:
        # the 7-octave turbulence once for every lane, the kernel on a GPU;
        # lanes whose texture chain does not reach the noise get position 0
        need = _needs_noise(scene, tid)
        qx, qy, qz = (torch.where(need, q, 0.0) for q in (px, py, pz))
        turb = perlin_fused.turbulence(scene.perlin_ranvec, scene.perlin_px,
                                       scene.perlin_py, scene.perlin_pz,
                                       qx, qy, qz, depth=7)

    r, g, b = _leaf_value_c(scene, tid, u, v, px, py, pz, turb)

    if scene.has_checker:
        # 3-D world-space parity of floor(p / scale) (texture.rs:59-70): int32
        # sum of the floors, floored modulus (Python semantics, like jnp's %)
        inv = tgather(scene.tex_inv_scale, tid)
        fsum = (torch.floor(inv * px).to(torch.int32)
                + torch.floor(inv * py).to(torch.int32)
                + torch.floor(inv * pz).to(torch.int32))
        is_even = fsum % 2 == 0
        er, eg, eb = _leaf_value_c(scene, tgather(scene.tex_even, tid), u, v,
                                   px, py, pz, turb)
        orr, og, ob = _leaf_value_c(scene, tgather(scene.tex_odd, tid), u, v,
                                    px, py, pz, turb)
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
