"""Scene IR, compiler, builders and pack of the port against the JAX
package: every field, flag and table exactly equal."""

import dataclasses

import numpy as np
import pytest
import torch

import rust_tracing_tpu as J
import rust_tracing_tpu_torch as T
from rust_tracing_tpu.models import builders as jbuilders
from rust_tracing_tpu.models import scene as jscene_mod
from rust_tracing_tpu.ops import megakernel as jmk
from rust_tracing_tpu_torch.models import builders as tbuilders
from rust_tracing_tpu_torch.models import bvh as tbvh
from rust_tracing_tpu_torch.models import scene as tscene_mod
from rust_tracing_tpu_torch.ops import megakernel as tmk
from torch_port_helpers import (FLAGS, carry_scene, mixed_builder,
                                scene_to_numpy)


def _assert_scene_equal(jscene, tscene):
    fields, flags = scene_to_numpy(jscene)
    for name, ref in fields.items():
        got = getattr(tscene, name)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        got = got.numpy()
        assert got.shape == ref.shape, name
        assert got.dtype == ref.dtype, (name, got.dtype, ref.dtype)
        np.testing.assert_array_equal(got, ref, err_msg=name)
    for name in FLAGS:
        assert getattr(tscene, name) is flags[name], name


def test_type_codes_equal():
    for name in ("LAMBERTIAN", "METAL", "DIELECTRIC", "DIFFUSE_LIGHT",
                 "ISOTROPIC", "TEX_SOLID", "TEX_CHECKER", "TEX_NOISE",
                 "TEX_IMAGE", "MED_SPHERE", "MED_BOX"):
        assert getattr(tscene_mod, name) == getattr(jscene_mod, name)
    assert tbuilders.SCENE_NAMES == jbuilders.SCENE_NAMES


@pytest.mark.parametrize("index", range(9))
def test_all_nine_scenes_compile_equal(index):
    jb, js = jbuilders.build_scene(index)
    tb, ts = tbuilders.build_scene(index)
    assert dataclasses.asdict(js) == dataclasses.asdict(ts)
    _assert_scene_equal(J.compile_scene(jb), T.compile_scene(tb, device="cpu"))


def test_scene_seed_changes_random_scenes_alike():
    jb, _ = jbuilders.build_scene(0, seed=5)
    tb, _ = tbuilders.build_scene(0, seed=5)
    _assert_scene_equal(J.compile_scene(jb), T.compile_scene(tb, device="cpu"))


def test_compile_with_bvh_equal():
    """use_bvh=True goes through the host BVH builder (native or numpy)."""
    jb, _ = jbuilders.cornell_box()
    tb, _ = tbuilders.cornell_box()
    js = J.compile_scene(jb, use_bvh=True, bvh_seed=3)
    ts = T.compile_scene(tb, use_bvh=True, bvh_seed=3, device="cpu")
    assert ts.has_bvh
    _assert_scene_equal(js, ts)


def test_numpy_bvh_invariants():
    tb, _ = tbuilders.quads()
    flat = tbvh.build(*tbvh.primitive_boxes(tb), seed=1, native=False)
    n = tb.num_spheres + tb.num_quads
    assert len(flat.skip) == 2 * n - 1
    assert sorted(flat.prim_idx[flat.prim_type >= 0]) == list(range(n))
    assert (flat.skip > np.arange(len(flat.skip))).all()


def test_scene_from_numpy_carries_every_leaf():
    jb, _ = mixed_builder(J)
    jscene = J.compile_scene(jb)
    _assert_scene_equal(jscene, carry_scene(jscene))


def test_build_scene_unknown_index():
    with pytest.raises(ValueError, match="unknown scene index"):
        tbuilders.build_scene(9)


# the scenes the fused kernel renders, the mixed scene, and two it refuses
PACKED = ["random_balls", "two_spheres", "quads", "cornell_box",
          "cornell_smoke", "mixed", "earth", "two_perlin_spheres"]


@pytest.mark.parametrize("name", PACKED)
def test_pack_scene_tables_equal(name):
    """Plain (N,F) tables equal the JAX pack after un-chunking its
    row-replicated lane-gather tiles (``tab[:, c, 0, :]``)."""
    if name == "mixed":
        jb, tb = mixed_builder(J)[0], mixed_builder(T)[0]
    else:
        jb, tb = getattr(jbuilders, name)()[0], getattr(tbuilders, name)()[0]
    jp = jmk.pack_scene(J.compile_scene(jb))
    tp = tmk.pack_scene(T.compile_scene(tb, device="cpu"))
    for f in ("sph_f", "sph_m", "quad_f", "quad_m", "med_i"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f), f)
        assert getattr(tp, f).dtype == getattr(jp, f).dtype
    np.testing.assert_array_equal(tp.med_f, jp.med_f)
    assert (tp.n_spheres, tp.n_quads, tp.n_media) == (
        jp.n_spheres, jp.n_quads, jp.n_media)
    assert (tp.has_checker, tp.has_noise, tp.has_image) == (
        jp.has_checker, jp.has_noise, jp.has_image)

    def unchunk(tab, n):  # (F, C, 8, 128) -> (F, n)
        return np.concatenate([tab[:, c, 0, :] for c in range(tab.shape[1])],
                              axis=1)[:, :n]

    n_mat, n_tex = tp.mat_f.shape[0], tp.tex_f.shape[0]
    jm = unchunk(jp.mat_tab, n_mat)  # type tex alb_r alb_g alb_b fuzz ir
    np.testing.assert_array_equal(tp.mat_i.T.astype(np.float32), jm[0:2])
    np.testing.assert_array_equal(tp.mat_f.T, jm[2:7])
    jt = unchunk(jp.tex_tab, n_tex)  # type even odd r g b scale
    np.testing.assert_array_equal(tp.tex_i.T.astype(np.float32), jt[0:3])
    np.testing.assert_array_equal(tp.tex_f.T, jt[3:7])
    assert tp.mat_i.dtype == tp.tex_i.dtype == np.int32


def test_supports_matches_reference():
    img8 = (np.arange(4 * 8 * 3).reshape(4, 8, 3) * 7 % 256).astype(np.uint8)

    def build(M, attach):
        b = M.SceneBuilder(background=(0.1, 0.1, 0.1))
        tex = b.image_texture(img8)
        if attach == "quad":
            b.add_quad((-1, -1, 2), (2, 0, 0), (0, 2, 0), b.lambertian(tex))
        elif attach == "quad_checker":
            chk = b.checker_texture(0.5, tex, b.solid_texture((1, 1, 1)))
            b.add_quad((-1, -1, 2), (2, 0, 0), (0, 2, 0), b.lambertian(chk))
        elif attach == "medium":
            b.add_sphere_medium((0, 0, 2), 1.0, 0.5, tex)
        else:
            b.add_sphere((0, 0, 2), 1.0, b.lambertian(tex))
        return b

    for attach in ("sphere", "quad", "quad_checker", "medium"):
        want = jmk.supports(J.compile_scene(build(J, attach)))
        got = tmk.supports(T.compile_scene(build(T, attach), device="cpu"))
        assert got is want, attach
