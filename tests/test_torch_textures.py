"""The port's texture evaluation (ops/textures.py) with the noise and image
families, and the fused render's image mip and texture arms
(ops/megakernel.py), against the JAX package on the CPU.

Tolerances and their reasons. Texture values: the JAX functions run unjitted,
so the lookups and the turbulence agree bit for bit; the marble's sin is
XLA's on one side and PyTorch's on the other, which differ by an ulp or two,
so values agree within 4.8e-7 (4 ulp of 1.0; positions are kept within a few
units so the sin argument carries no larger error). Gradients within 1e-5
of each leaf's largest |g| (the backward sums add in another order). Packed
tables: exact shapes and floats to 1 ulp (a mean of f64 texels rounded
once on both sides). The fused render's plain version against the Pallas
kernel in interpret mode: ``assert_images_agree``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rust_tracing_tpu as J
import rust_tracing_tpu_torch as T
from rust_tracing_tpu.ops import megakernel as jmk
from rust_tracing_tpu.ops import textures as jtex
from rust_tracing_tpu_torch.ops import megakernel as tmk
from rust_tracing_tpu_torch.ops import textures as ttex
from torch_port_helpers import (assert_images_agree, both, carry_scene,
                                texture_builder)

VALUE_ATOL = 4.8e-7


@pytest.fixture(scope="module")
def scenes():
    jb, _ = texture_builder(J)
    jscene = J.compile_scene(jb)
    return jscene, carry_scene(jscene)


def _lanes(scene, R, seed):
    rng = np.random.default_rng(seed)
    T_ = scene.tex_type.shape[0]
    return (rng.integers(0, T_, R).astype(np.int32),
            *rng.uniform(-0.2, 1.2, (2, R)).astype(np.float32),
            *rng.uniform(-3.0, 3.0, (3, R)).astype(np.float32))


def test_texture_values_block_sparse_match_jax(scenes):
    """At R = 65536 the reference takes its block-sparse path; the port
    evaluates densely with the inputs of unneeded lanes set to 0."""
    jscene, tscene = scenes
    lanes = _lanes(tscene, 65536, 3)
    with jax.disable_jit():
        ref = jtex.texture_value_c(jscene, *[jnp.asarray(a) for a in lanes])
    got = ttex.texture_value_c(tscene, *[torch.from_numpy(a) for a in lanes])
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=VALUE_ATOL)


def test_texture_values_and_gradients_match_jax(scenes):
    """Dense lanes (R = 100): the values, and d (weighted values) / d
    (texture colours, noise scales, the image, the Perlin gradient table,
    positions)."""
    jscene, tscene = scenes
    tid, u, v, px, py, pz = _lanes(tscene, 100, 7)
    w = np.random.default_rng(8).normal(size=(3, 100)).astype(np.float32)
    names = ("tex_rgb", "tex_noise_scale", "image", "perlin_ranvec")

    def jf(leaves, x, y, z):
        sc = dataclasses.replace(jscene, **dict(zip(names, leaves)))
        return jnp.stack(jtex.texture_value_c(
            sc, jnp.asarray(tid), jnp.asarray(u), jnp.asarray(v), x, y, z))

    with jax.disable_jit():
        ref_val, vjp = jax.vjp(jf, [getattr(jscene, n) for n in names],
                               *map(jnp.asarray, (px, py, pz)))
        ref = vjp(jnp.asarray(w))
    ref = [np.asarray(a) for a in ref[0]] + [np.asarray(a) for a in ref[1:]]
    leaves = {n: getattr(tscene, n).clone().requires_grad_() for n in names}
    pos = [torch.from_numpy(a).requires_grad_() for a in (px, py, pz)]
    val = torch.stack(ttex.texture_value_c(
        tscene.replace(**leaves), torch.from_numpy(tid), torch.from_numpy(u),
        torch.from_numpy(v), *pos))
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(ref_val),
                               rtol=0, atol=VALUE_ATOL)
    got = torch.autograd.grad(val, list(leaves.values()) + pos,
                              torch.from_numpy(w))
    for name, gt, rf in zip(names + ("px", "py", "pz"), got, ref):
        assert np.abs(rf).max() > 0, name
        np.testing.assert_allclose(gt.numpy(), rf, rtol=0,
                                   atol=1e-5 * np.abs(rf).max(), err_msg=name)


def test_pack_scene_image_mip_matches_reference():
    """earth's procedural 1024x512 image: the 4x box-filter mip to 128x256
    = IMG_MAX_TEXELS texels, against the reference's lane-gather chunks."""
    jscene, _, tscene, _ = both("earth", image_width=8)
    ref = jmk.pack_scene(jscene)
    got = tmk.pack_scene(tscene)
    assert (got.img_h, got.img_w) == (ref.img_h, ref.img_w) == (128, 256)
    assert got.img_f.shape == (3, 128, 256) and got.img_f.dtype == np.float32
    n = ref.img_h * ref.img_w
    ref_cols = ref.img_tab[:, :, 0, :].reshape(3, -1)[:, :n]
    np.testing.assert_array_max_ulp(got.img_f.reshape(3, n), ref_cols, 1)
    assert got.has_image and not got.has_noise
    small = tmk.pack_scene(carry_scene(J.compile_scene(texture_builder(J)[0])))
    assert (small.img_h, small.img_w) == (8, 16) and small.has_noise


def test_fused_plain_matches_pallas_interpret():
    """The fused render's plain version with both in-kernel families (hash
    noise, mipped image at a polynomial sphere UV) against the Pallas kernel
    in interpret mode, as the JAX package's own tests run it."""
    jb, js = texture_builder(J)
    tb, ts = texture_builder(T)
    jscene, jcam = J.compile_scene(jb), J.Camera.create(js)
    tscene = T.compile_scene(tb, device="cpu")
    tcam = T.Camera.create(ts)
    ref, ref_rays = jmk.render_fast(jscene, jcam, seed=3, interpret=True,
                                    with_stats=True)
    img, rays = tmk.render_fast(tscene, tcam, seed=3, with_stats=True)
    assert_images_agree(img, np.asarray(ref), rays, ref_rays)


def test_fused_uv_and_hash_noise_match_reference():
    """The in-kernel helpers one by one against the reference's, unjitted:
    the hash gradients bit for bit, the polynomial acos/atan2 within 2 ulp
    (PyTorch's CPU sqrt is not always correctly rounded: 1 ulp seen at 1 of
    256 lanes; the card's is). The hash turbulence is held through the whole
    render above."""
    rng = np.random.default_rng(9)
    x, y = rng.uniform(-1.2, 1.2, (2, 256)).astype(np.float32)
    ij = rng.integers(-300, 300, (3, 256)).astype(np.int32)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    with jax.disable_jit():
        jx, jy = jnp.asarray(x), jnp.asarray(y)
        np.testing.assert_array_max_ulp(tmk._atan2(ty, tx).numpy(),
                                        np.asarray(jmk._atan2(jy, jx)), 2)
        np.testing.assert_array_max_ulp(tmk._arccos(tx).numpy(),
                                        np.asarray(jmk._arccos(jx)), 2)
        pairs = list(zip(tmk._hash_grad(*map(torch.from_numpy, ij), 0x5EED),
                         jmk._hash_grad(*map(jnp.asarray, ij), 0x5EED)))
    for got, ref in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
