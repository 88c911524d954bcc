"""The card's tree on the CPU, numpy and torch only: the wide tree that
``megakernel.widen_kernel_bvh`` collapses from the kernel BVH, its device
tables (``pack_wide``), and the plain walk of it (``walk_wide_plain``: the
kernel's visiting order, stack, tie rule and counters) against the brute
search (``_closest_surface``, which tests every primitive). The plain walk
against the JAX package's search is in
test_torch_bvh.py::test_closest_hit_bvh_matches_jax.

Tolerances: none. Trees, tables, counters, winners and t are exact. The
brute search runs with a correctly rounded f32 square root (the double
root rounded once), as the card's and numpy's are: PyTorch's vectorised
float square root on the CPU is off by an ulp on some inputs, which a
root's cancellation can carry into many ulps of t."""

import dataclasses

import numpy as np
import pytest
import torch

import rust_tracing_tpu_torch as T
from rust_tracing_tpu_torch.models import builders as tbuilders
from rust_tracing_tpu_torch.ops import megakernel as tmk
from rust_tracing_tpu_torch.ops import wavefront as twf

torch.set_num_threads(1)

SCENES = ("random_balls", "final_scene", "cornell_box")
WIDE_TABLES = ("wbvh", "wsph_f", "wsph_i", "wquad_f", "wquad_i")


# (scene, rays) of the plain walk's tests: few enough for a loop in Python
WALK_CASES = [("random_balls", 200), ("final_scene", 240), ("cornell_box", 400)]


@pytest.fixture(scope="module")
def scenes():
    """name -> (scene, settings, the binary tree the card's collapses,
    packed, tables), every scene with a tree (cornell_box's is forced: 18
    thin coplanar quads)."""
    out = {}
    for name in SCENES:
        b, s = getattr(tbuilders, name)()
        scene = T.compile_scene(b, device="cpu")
        packed, tables = tmk._packed_dev(scene, True)
        card = tmk.build_kernel_bvh(scene, tmk.BVH_CARD_LEAF_SIZE)
        out[name] = (scene, s, card, packed, tables)
    return out


def _subtree_prims(wide, j):
    """(sphere rows, quad rows) in leaf order under wide node j's slots,
    one pair a slot."""
    out = []
    for ref in wide.ref[j]:
        if ref == tmk.EMPTY_SLOT:
            break
        if ref < 0:
            s0, ns, q0, nq = wide.leaf[~ref]
            out.append((list(range(s0, s0 + ns)), list(range(q0, q0 + nq))))
        else:
            sph, quad = [], []
            for s, q in _subtree_prims(wide, ref):
                sph += s
                quad += q
            out.append((sph, quad))
    return out


@pytest.mark.parametrize("name", SCENES)
def test_wide_tree_covers_every_primitive_once(scenes, name):
    """Every packed sphere and quad is in exactly one leaf, leaves keep the
    binary stream's order (spheres first within a leaf), every node and
    leaf is reached once from the root, slots are filled from the front."""
    scene, _, bvh, packed, _ = scenes[name]
    wide = tmk.widen_kernel_bvh(bvh)
    stream = bvh.prim_stream
    np.testing.assert_array_equal(wide.sph_idx, stream[stream[:, 0] == 0, 1])
    np.testing.assert_array_equal(wide.quad_idx, stream[stream[:, 0] == 1, 1])
    assert sorted(wide.sph_idx) == list(range(packed.n_spheres))
    assert sorted(wide.quad_idx) == list(range(packed.n_quads))
    refs = wide.ref[wide.ref != tmk.EMPTY_SLOT]
    assert sorted(refs[refs >= 0]) == list(range(1, len(wide.ref)))
    assert sorted(~refs[refs < 0]) == list(range(len(wide.leaf)))
    filled = wide.ref != tmk.EMPTY_SLOT
    assert filled[:, 0].all()
    assert (filled[:, :-1] >= filled[:, 1:]).all()  # no hole before a child
    starts = np.cumsum(np.r_[0, wide.leaf[:-1, 1]]), \
        np.cumsum(np.r_[0, wide.leaf[:-1, 3]])
    np.testing.assert_array_equal(wide.leaf[:, 0], starts[0])
    np.testing.assert_array_equal(wide.leaf[:, 2], starts[1])
    assert (wide.leaf[:, 1] + wide.leaf[:, 3]
            <= tmk.BVH_CARD_LEAF_SIZE).all()
    assert wide.ref.shape[1] == tmk.BVH_WIDTH
    assert (tmk.BVH_WIDTH - 1) * wide.depth <= tmk.WALK_STACK


@pytest.mark.parametrize("name", SCENES)
def test_child_boxes_contain_their_primitives(scenes, name):
    """A child's f32 box contains the exact (float64) box of every
    primitive under it, widened by BOX_PAD of the scene's scale: the
    outward rounding and the pad hold."""
    scene, _, bvh, _, _ = scenes[name]
    wide = tmk.widen_kernel_bvh(bvh)
    box_min, box_max, kind, idx = tmk.prim_boxes(scene)
    root = np.concatenate([bvh.node_min[0], bvh.node_max[0]])
    pad = tmk.BOX_PAD * (np.abs(root).max()
                         + np.linalg.norm(root[3:] - root[:3]))
    lo32, hi32 = box_min - pad, box_max + pad
    row = {(int(k), int(i)): r for r, (k, i) in enumerate(zip(kind, idx))}
    checked = 0
    for j in range(len(wide.ref)):
        for c, (sph, quad) in enumerate(_subtree_prims(wide, j)):
            rows = [row[(0, int(wide.sph_idx[s]))] for s in sph] + \
                   [row[(1, int(wide.quad_idx[q]))] for q in quad]
            assert rows
            assert (wide.lo[j, :, c][None] <= lo32[rows]).all()
            assert (wide.hi[j, :, c][None] >= hi32[rows]).all()
            checked += 1
    assert checked == len(wide.ref) - 1 + len(wide.leaf)


@pytest.mark.parametrize("name", SCENES)
def test_leaf_rows_and_device_layout(scenes, name):
    """The leaf-ordered rows are the packed rows gathered by the binary
    tree's stream (the card's ``prim_i``), with their packed indices; the
    device table holds each node's boxes and refs (unit offsets of nodes,
    ~unit of a leaf header) and then the leaf headers."""
    _, _, bvh, packed, tables = scenes[name]
    wide = tmk.widen_kernel_bvh(bvh)
    prim_i = bvh.prim_stream
    sph = prim_i[prim_i[:, 0] == 0, 1]
    quad = prim_i[prim_i[:, 0] == 1, 1]
    for rows, idx, got, got_i in ((packed.sph_f, sph, "wsph_f", "wsph_i"),
                                  (packed.quad_f, quad, "wquad_f",
                                   "wquad_i")):
        # an empty family keeps one zero row, as the packed tables do
        assert tables[got].shape[0] == tables[got_i].shape[0] \
            == max(len(idx), 1)
        np.testing.assert_array_equal(tables[got].numpy()[:len(idx)],
                                      rows[idx])
        np.testing.assert_array_equal(tables[got_i].numpy()[:len(idx)], idx)
    W = tmk.BVH_WIDTH
    units = 7 * W // 4
    N = len(wide.ref)
    words = tables["wbvh"].numpy().reshape(-1)
    assert words.size == N * 7 * W + 4 * len(wide.leaf)
    body = words[:N * 7 * W].reshape(N, 7, W)
    np.testing.assert_array_equal(body[:, 0:3].view(np.float32), wide.lo)
    np.testing.assert_array_equal(body[:, 3:6].view(np.float32), wide.hi)
    ref = body[:, 6]
    inner, leaf = wide.ref >= 0, (wide.ref < 0) & (wide.ref != tmk.EMPTY_SLOT)
    np.testing.assert_array_equal(ref[inner], wide.ref[inner] * units)
    np.testing.assert_array_equal(~ref[leaf], N * units + ~wide.ref[leaf])
    np.testing.assert_array_equal(words[N * 7 * W:].reshape(-1, 4), wide.leaf)


def _rays(scene, settings, name, n, seed):
    """n seeded rays: camera rays of a small frame, and rays from points
    inside the scene's box in every direction octant."""
    rng = np.random.default_rng(seed)
    cam = T.Camera.create(dataclasses.replace(settings, image_width=24))
    n_pix = cam.image_width * cam.image_height
    pid = torch.from_numpy(np.sort(rng.choice(n_pix, n // 2, replace=False))
                           .astype(np.int32))
    o, d, t = T.get_rays(cam.constants(device="cpu"), seed, pid, 0)
    lo, inv = twf._scene_bounds(scene)
    hi = lo + 1.0 / inv
    m = n - n // 2
    ro = torch.from_numpy(rng.uniform(lo, hi, (m, 3)).astype(np.float32))
    rd = torch.from_numpy(rng.normal(size=(m, 3)).astype(np.float32))
    rt = torch.from_numpy(rng.random(m).astype(np.float32))
    o, d, t = torch.cat([o, ro]), torch.cat([d, rd]), torch.cat([t, rt])
    return o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], t


@pytest.fixture(scope="module")
def walks(scenes):
    """name -> (rays, the plain walk's (rec, t, counters)) for WALK_CASES,
    each walked once."""
    out = {}
    for name, n in WALK_CASES:
        scene, settings, _, _, tables = scenes[name]
        lanes = _rays(scene, settings, name, n, seed=3)
        out[name] = lanes, tmk.walk_wide_plain(
            {k: tables[k] for k in WIDE_TABLES}, *lanes)
    return out


@pytest.mark.parametrize("name,n", WALK_CASES)
def test_plain_walk_returns_brute_winners(scenes, walks, name, n,
                                          monkeypatch):
    """The plain walk of the wide tree, ray by ray (the kernel's order,
    pruning and counters), returns the brute search's winner on every ray,
    and its t; its counters count what it tested."""
    sqrt = torch.sqrt
    monkeypatch.setattr(torch, "sqrt", lambda x: sqrt(x.double()).float())
    scene, settings, _, packed, tables = scenes[name]
    lanes, (rec, t, counts) = walks[name]
    assert len(rec) == n
    p = tmk.search_params(packed, 0)
    alive = torch.ones(n, dtype=torch.bool)
    t_b, _, _, _, _, rec_b, _, _ = tmk._closest_surface(tables, p, *lanes,
                                                        alive)
    np.testing.assert_array_equal(rec, rec_b.numpy())
    t_b = t_b.numpy()
    hit = np.isfinite(t_b)
    assert 0 < hit.sum() < n
    np.testing.assert_array_equal(t, t_b)
    # every ray tests at least the root's children; no ray tests more
    # primitives than the scene holds
    root = tmk.widen_kernel_bvh(scenes[name][2]).ref[0]
    assert (counts[:, 0] >= (root != tmk.EMPTY_SLOT).sum()).all()
    assert (counts[:, 1] <= packed.n_spheres).all()
    assert (counts[:, 2] <= packed.n_quads).all()
    if name == "cornell_box":  # every thin-quad hit of the brute search
        assert (rec >> 24 == 2).sum() == (rec_b.numpy() >> 24 == 2).sum()


@pytest.mark.parametrize("name", SCENES)
def test_walk_plan_and_stack_limit(scenes, name):
    """A BVH launch reads every table through the read-only path (no
    staged bytes) with a warp a pixel at 32 spp, where the brute loop of
    the same scene stages its tables when they fit; a tree deeper than the
    walk's stack holds is refused."""
    scene, settings, bvh, packed, tables = scenes[name]
    cam = T.Camera.create(dataclasses.replace(settings, image_width=8))
    p = tmk.make_params(cam, packed, 0, 32, 8)
    plan = tmk.render_plan(tables, p)
    assert (plan.group, plan.stage_bytes) == (32, 0)
    brute, b_tables = tmk._packed_dev(scene)
    pb = tmk.make_params(cam, brute, 0, 32, 8)
    nbytes = tmk.stage_bytes(b_tables, pb)
    assert tmk.render_plan(b_tables, pb).stage_bytes == (
        nbytes if nbytes <= tmk.STAGE_BUDGET_BYTES else 0)
    wide = tmk.widen_kernel_bvh(bvh)
    tmk.pack_wide(wide, packed.sph_f, packed.quad_f)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmk, "WALK_STACK", (tmk.BVH_WIDTH - 1) * wide.depth - 1)
        with pytest.raises(ValueError, match="stack"):
            tmk.pack_wide(wide, packed.sph_f, packed.quad_f)
