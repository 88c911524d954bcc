// Forward path-tracing render kernel, path recorder and one-bounce hit kernel
// for Hopper (sm_90a), written by hand.
//
// render_kernel replaces the Pallas kernel of rust_tracing_tpu/ops/
// megakernel.py (`_make_kernel.kernel`, render mode): the whole render of a
// pixel range in one launch. record_kernel replaces the same Pallas kernel's
// record mode and hit_kernel its hit mode (see their own comments). The
// kernel's BVH branch (B4, megakernel.py:712-776) is the `BVH` template flag
// of every kernel here: `closest_surface<MODE, true>` walks the kernel BVH
// instead of looping over every primitive. Camera ray, closest hit over spheres
// and quads, constant media, five-material scatter, emission, solid/checker
// textures, spp accumulation. The noise and image texture families (the
// reference kernel's `has_noise`/`has_image` arms, megakernel.py:404-503,
// 593-626, 922-928) are compiled in only where a scene holds them: the
// render kernel is a template on both flags and the host picks the
// instantiation, so a scene without them runs code without them.
//
// Design for this card, not carried over from the TPU tile by tile:
//  - render_kernel is parallel over pixels AND samples. A group of G
//    consecutive threads (G = 1, 2, ..., 32, picked by the host from spp so
//    that few lanes idle: ops/megakernel.py::samples_per_group) traces one
//    pixel: in round r, lane l traces sample r*G + l. After each round every
//    lane of the group reads the round's G radiances (__shfl_sync) and adds
//    them to the pixel's running sum in sample order, `acc = acc + rad_s`:
//    the f32 sum of a one-thread-a-pixel loop and of the plain version, bit
//    for bit. A sample's path depends on (seed, pixel, sample, bounce, site)
//    only, never on which thread traces it. Ray counts and walk counters are
//    integers, summed over the group in any order. A 600x600 frame at 4096
//    spp is 360 000 warps, ~100 waves of the card's resident warps: the last,
//    partial wave is a few percent of the frame. (One thread a pixel made
//    5 625 blocks of 64 threads, ~3 waves of equally long blocks, the last a
//    quarter full for a whole wave's time.) The TPU kernel regenerates dead
//    lanes to keep a 1024-lane vector full and adds finished samples per
//    pixel in sample order: the same sums.
//  - record_kernel is one thread a (pixel, sample): it sums nothing across
//    samples, so a warp traces one sample of 32 consecutive pixels and each
//    bounce's store is one 128-byte run of that sample's plane (see its
//    comment). hit_kernel is one thread a lane.
//  - Scene tables: the brute-loop render kernel and recorder stage the
//    sphere, quad, medium, material and texture rows in shared memory once a
//    block when they fit the host's byte budget (megakernel.
//    STAGE_BUDGET_BYTES, small enough that registers, not shared memory,
//    bound the blocks an SM holds) and read them with plain loads: the
//    threads of a warp read the same row at once, a broadcast. Larger tables, the BVH instantiations' tree and
//    scene rows and the image are read from global memory through the
//    read-only path (`__ldg`, vector loads of whole rows).
//  - BVH (B4): each thread walks the card's tree, the reference's binary
//    tree collapsed into nodes of BVH_WIDTH children (ops/megakernel.py::
//    widen_kernel_bvh, pack_wide), near child first with a short stack (see
//    closest_surface). The TPU kernel walks one skip-link pointer per
//    1024-lane tile and descends wherever any lane's box test passes (its
//    vector unit has no per-lane control flow); a GPU thread descends only
//    where its own ray hits the box. The tree is read through L1 (`__ldg`),
//    a node's children's boxes in one run of 16-byte units; the leaf rows
//    lie in global memory in leaf order, each a run of whole rows with no
//    index to chase. The wavefront (ops/wavefront.py) sorts rays before
//    hit_kernel so that a warp's threads walk the same subtrees. Bound:
//    operations (slab tests and primitive tests).
//  - Camera, spp, depth, primitive counts, seed, pixel range and sample offset
//    are runtime arguments: one compiled library serves every scene and camera.
//  - Bound: operations. The kernel reads a few KB of tables and writes 16 bytes
//    a pixel; its work is rays x primitives x ~25 flop plus shading.
//
// Arithmetic contract with the plain PyTorch version (ops/megakernel.py,
// `render_fast_plain`): the same f32 operations in the same order. Build with
// `--fmad=false` and without `--use_fast_math`: a contracted multiply-add in
// `disc > 0`, `alpha <= 1` or `t < t_best` flips a hit decision and the path
// after it is a different path, not a slightly different number. Division and
// square root are IEEE; `sinf cosf logf expf rsqrtf` are the device library's,
// which PyTorch's CUDA ops call too. Integer powers are written as repeated
// multiplication in this order: x^2 = x*x, x^5 = x * ((x*x) * (x*x)).
// `fmaxf`/`fminf` drop a NaN operand where the plain version would propagate
// it; no operand here can be NaN for finite scenes and rays.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hashrng.cuh"

namespace rt {

// Mirrors ops/megakernel.py::RenderParams field for field.
struct RenderParams {
    float center[3];
    float pixel00[3];
    float delta_u[3];
    float delta_v[3];
    float disk_u[3];
    float disk_v[3];
    float background[3];
    int has_defocus;
    int width, height, spp, max_depth;
    int n_spheres, n_quads, n_media;
    int seed;
    int pixel_base, pixel_count, sample_offset;
    int has_noise, has_image;  // pick the render kernel's instantiation
    int img_h, img_w;          // the mipped image table's shape
    int use_bvh;               // pick the BVH instantiation (B4)
    int n_nodes;               // nodes of the binary tree (>= 1)
};

// The scene's tables, as the host passes them.
struct SceneTables {
    const float4* sph_f;  // (S,8)  cx cy cz r2 | inv_r mvx mvy mvz
    const int* sph_m;     // (S,)
    const float4* quad_f; // (Q,16) q(3) u(3) v(3) n(3) w(3) d
    const int* quad_m;    // (Q,)
    const float* med_f;   // (M,24) R(9) trans(3) lo(3) hi(3) c(3) r2 nid pad
    const int* med_i;     // (M,2)  type mat
    const float* mat_f;   // (N,5)  alb_r alb_g alb_b fuzz ir
    const int* mat_i;     // (N,2)  type tex
    const float* tex_f;   // (T,4)  rgb_r rgb_g rgb_b scale
    const int* tex_i;     // (T,3)  type even odd
    const float* img_f;   // (3, IH*IW) mipped image texels r g b; render only
    const float4* wbvh;   // the card's tree: wide nodes, then leaf headers
    const float4* wsph_f; // (S,8)  sphere rows in leaf order
    const int* wsph_i;    // (S,)   their packed sphere index
    const float4* wquad_f;// (Q,16) quad rows in leaf order
    const int* wquad_i;   // (Q,)   their packed quad index
};

// The tables as a kernel reads them. STAGED: the brute loop's rows
// (spheres, quads, media, materials, textures) lie in shared memory and `ld`
// is a plain load; else `ld` reads global memory through the read-only
// path. The image, the tree and the leaf rows are never staged: they are
// read with __ldg directly.
template <bool STAGED>
struct Tables : SceneTables {
    template <typename T>
    __device__ __forceinline__ T ld(const T* q) const {
        if constexpr (STAGED)
            return *q;
        else
            return __ldg(q);
    }
};

// What a trace computes. RENDER shades and accumulates radiance; RECORD
// (record_kernel: winner ids per bounce) and HIT (hit_kernel: one-bounce
// search) reuse the same device functions and track which primitive won. The
// record is taken right after the search, before the emitter and depth
// short-cuts, so a bounce that ends its path still records its winner.
enum Mode { MODE_RENDER = 0, MODE_RECORD = 1, MODE_HIT = 2 };

constexpr float T_MIN = 1e-3f;
constexpr float QUAD_DENOM_EPS = 1e-8f;
constexpr float ORIGIN_EPS_ABS = 1e-4f;
constexpr float ORIGIN_EPS_REL = 2e-4f;

// material type codes (models/scene.py); 2 is DIELECTRIC, the last branch
constexpr int LAMBERTIAN = 0, METAL = 1, DIFFUSE_LIGHT = 3, ISOTROPIC = 4;
constexpr int TEX_CHECKER = 1, TEX_IMAGE = 2, TEX_NOISE = 3;
constexpr int MED_BOX = 1;

struct Ray {
    float ox, oy, oz, dx, dy, dz, time;
};

struct Hit {
    float t_best;
    float nx, ny, nz;
    int mat;
    bool is_med;
    int kind, idx;  // winner record (1 sphere, 2 quad, 3+m medium); not
                    // RENDER, except in the BVH walk, whose ties read them
};

// Work of the BVH walk of one thread: node boxes it tested (a wide node's
// children each), spheres and quads it tested. Written out only where the
// caller asks (the bound).
struct WalkCount {
    int visits, spheres, quads;
};

// The card's tree (ops/megakernel.py::widen_kernel_bvh, pack_wide): one
// table of 16-byte units. A node is NODE_UNITS units: its children's min x,
// y, z and max x, y, z rows of BVH_WIDTH f32 each, then their BVH_WIDTH
// refs; a ref is a node's unit offset (>= 0), ~unit of a leaf header
// (sphere row start, sphere count, quad row start, quad count), or
// EMPTY_SLOT after the last child. WALK_STACK bounds the stack: the host
// refuses a tree deeper than it holds ((BVH_WIDTH - 1) x depth entries).
constexpr int BVH_WIDTH = 4;
constexpr int NODE_UNITS = 7 * BVH_WIDTH / 4;
constexpr int WALK_STACK = 48;
constexpr int EMPTY_SLOT = (int)0x80000000;

// The BVH walk's acceptance rule (TIE): a primitive wins when its t is
// smaller, or equal with a lower (kind, idx). The brute loop visits spheres
// then quads in index order and accepts only `t < t_best`, so it returns the
// first minimum in (t, kind, idx) order; with this rule the walk returns the
// same winner whatever order the tree visits the primitives in. The "no
// winner" state has kind 0, the lowest key, so a tie never beats it.
__device__ __forceinline__ bool beats(float t, int kind, int idx,
                                      const Hit& h) {
    return t < h.t_best
           || (t == h.t_best && ((kind << 24) | idx) < ((h.kind << 24) | h.idx));
}

// sphere.rs:59-89 + moving-centre lerp: strict bounds, near root preferred.
template <int MODE, class Tab>
__device__ __forceinline__ void sphere_test(const Tab& sc, int i,
                                            const Ray& r, float a_len,
                                            float inv_a, Hit& h) {
    const float4 s0 = sc.ld(sc.sph_f + 2 * i);
    const float4 s1 = sc.ld(sc.sph_f + 2 * i + 1);
    const float ccx = s0.x + s1.y * r.time;
    const float ccy = s0.y + s1.z * r.time;
    const float ccz = s0.z + s1.w * r.time;
    const float r2 = s0.w, inv_r = s1.x;
    const float ocx = r.ox - ccx, ocy = r.oy - ccy, ocz = r.oz - ccz;
    const float half_b = ocx * r.dx + ocy * r.dy + ocz * r.dz;
    const float c = ocx * ocx + ocy * ocy + ocz * ocz - r2;
    const float disc = half_b * half_b - a_len * c;
    if (!(disc > 0.0f)) return;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const float r1 = (-half_b - sq) * inv_a;
    const float rr2 = (-half_b + sq) * inv_a;
    const bool ok1 = (r1 > T_MIN) && (r1 < h.t_best);
    const bool ok2 = (rr2 > T_MIN) && (rr2 < h.t_best);
    if (!(ok1 || ok2)) return;
    const float root = ok1 ? r1 : rr2;
    h.t_best = root;
    h.mat = sc.ld(sc.sph_m + i);
    h.nx = (r.ox + root * r.dx - ccx) * inv_r;
    h.ny = (r.oy + root * r.dy - ccy) * inv_r;
    h.nz = (r.oz + root * r.dz - ccz) * inv_r;
    h.is_med = false;
    if (MODE != MODE_RENDER) {
        h.kind = 1;
        h.idx = i;
    }
}

// quad.rs:96-133: inclusive bounds, no back-face culling.
template <int MODE, class Tab>
__device__ __forceinline__ void quad_test(const Tab& sc, int i,
                                          const Ray& r, Hit& h) {
    const float4 a = sc.ld(sc.quad_f + 4 * i);      // qx qy qz ux
    const float4 b = sc.ld(sc.quad_f + 4 * i + 1);  // uy uz vx vy
    const float4 c = sc.ld(sc.quad_f + 4 * i + 2);  // vz nx ny nz
    const float4 e = sc.ld(sc.quad_f + 4 * i + 3);  // wx wy wz d
    const float nx = c.y, ny = c.z, nz = c.w;
    const float denom = nx * r.dx + ny * r.dy + nz * r.dz;
    const float safe = fabsf(denom) < 1e-30f ? 1e-30f : denom;
    const float t = (e.w - (nx * r.ox + ny * r.oy + nz * r.oz)) / safe;
    if (!((fabsf(denom) >= QUAD_DENOM_EPS) && (t >= T_MIN) && (t < h.t_best)))
        return;
    const float hx = r.ox + t * r.dx - a.x;
    const float hy = r.oy + t * r.dy - a.y;
    const float hz = r.oz + t * r.dz - a.z;
    const float ux = a.w, uy = b.x, uz = b.y;
    const float vx = b.z, vy = b.w, vz = c.x;
    const float wx = e.x, wy = e.y, wz = e.z;
    const float alpha = wx * (hy * vz - hz * vy) + wy * (hz * vx - hx * vz)
                        + wz * (hx * vy - hy * vx);
    const float beta = wx * (uy * hz - uz * hy) + wy * (uz * hx - ux * hz)
                       + wz * (ux * hy - uy * hx);
    if (!((alpha >= 0.0f) && (alpha <= 1.0f) && (beta >= 0.0f)
          && (beta <= 1.0f)))
        return;
    h.t_best = t;
    h.mat = sc.ld(sc.quad_m + i);
    h.nx = nx;
    h.ny = ny;
    h.nz = nz;
    h.is_med = false;
    if (MODE != MODE_RENDER) {
        h.kind = 2;
        h.idx = i;
    }
}

// The walk's sphere test of leaf row k (the sphere test's f32 operations in
// its order): the tie rule `beats` decides, and only the winner's t, kind
// and packed index are kept; its normal and material are read once the
// walk ends (closest_surface).
template <class Tab>
__device__ __forceinline__ void leaf_sphere(const Tab& sc, int k, const Ray& r,
                                            float a_len, float inv_a, Hit& h) {
    const float4 s0 = __ldg(sc.wsph_f + 2 * k);
    const float4 s1 = __ldg(sc.wsph_f + 2 * k + 1);
    const int i = __ldg(sc.wsph_i + k);
    const float ccx = s0.x + s1.y * r.time;
    const float ccy = s0.y + s1.z * r.time;
    const float ccz = s0.z + s1.w * r.time;
    const float ocx = r.ox - ccx, ocy = r.oy - ccy, ocz = r.oz - ccz;
    const float half_b = ocx * r.dx + ocy * r.dy + ocz * r.dz;
    const float c = ocx * ocx + ocy * ocy + ocz * ocz - s0.w;
    const float disc = half_b * half_b - a_len * c;
    if (!(disc > 0.0f)) return;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const float r1 = (-half_b - sq) * inv_a;
    const float rr2 = (-half_b + sq) * inv_a;
    const bool ok1 = (r1 > T_MIN) && beats(r1, 1, i, h);
    const bool ok2 = (rr2 > T_MIN) && beats(rr2, 1, i, h);
    if (!(ok1 || ok2)) return;
    h.t_best = ok1 ? r1 : rr2;
    h.kind = 1;
    h.idx = i;
}

// The walk's quad test of leaf row k (the quad test's operations).
template <class Tab>
__device__ __forceinline__ void leaf_quad(const Tab& sc, int k, const Ray& r,
                                          Hit& h) {
    const float4 a = __ldg(sc.wquad_f + 4 * k);      // qx qy qz ux
    const float4 b = __ldg(sc.wquad_f + 4 * k + 1);  // uy uz vx vy
    const float4 c = __ldg(sc.wquad_f + 4 * k + 2);  // vz nx ny nz
    const float4 e = __ldg(sc.wquad_f + 4 * k + 3);  // wx wy wz d
    const int i = __ldg(sc.wquad_i + k);
    const float nx = c.y, ny = c.z, nz = c.w;
    const float denom = nx * r.dx + ny * r.dy + nz * r.dz;
    const float safe = fabsf(denom) < 1e-30f ? 1e-30f : denom;
    const float t = (e.w - (nx * r.ox + ny * r.oy + nz * r.oz)) / safe;
    if (!((fabsf(denom) >= QUAD_DENOM_EPS) && (t >= T_MIN)
          && beats(t, 2, i, h)))
        return;
    const float hx = r.ox + t * r.dx - a.x;
    const float hy = r.oy + t * r.dy - a.y;
    const float hz = r.oz + t * r.dz - a.z;
    const float ux = a.w, uy = b.x, uz = b.y;
    const float vx = b.z, vy = b.w, vz = c.x;
    const float wx = e.x, wy = e.y, wz = e.z;
    const float alpha = wx * (hy * vz - hz * vy) + wy * (hz * vx - hx * vz)
                        + wz * (hx * vy - hy * vx);
    const float beta = wx * (uy * hz - uz * hy) + wy * (uz * hx - ux * hz)
                       + wz * (ux * hy - uy * hx);
    if (!((alpha >= 0.0f) && (alpha <= 1.0f) && (beta >= 0.0f)
          && (beta <= 1.0f)))
        return;
    h.t_best = t;
    h.kind = 2;
    h.idx = i;
}

// Closest surface. Brute force (BVH false): all spheres, then all quads; a
// later equal t never replaces an earlier winner (`t < t_best`).
//
// BVH (B4, megakernel.py:712-776): a walk of the card's tree, near child
// first. A wide node's children are slab-tested one after another (their
// boxes side by side: one node read serves them all); the hit ones are
// ordered by entry t, equal t by slot, the nearest taken next and the rest
// pushed far first on a stack of (ref, entry t) in local memory. A popped
// entry is skipped when its entry t exceeds t_best, the same closed test
// `tmx >= tmn` again, since tmx takes min(.., t_best). A leaf tests its
// spheres then its quads, rows in leaf order. The slab test is the
// reference's (:742-756), with 1/d clamped at 1e-30 (:725-727), but closed
// (`tmx >= tmn`, as ops/bvh_traverse.py::_slab_hit): a leaf of coplanar
// quads has a box thinner than one f32 step of t, whose entry and exit round
// to the same t, and the reference's strict test drops it. Every box is a
// node box of the binary tree widened outward (megakernel.BOX_PAD), so a
// primitive's f32 hit lies inside its leaf's box even where it grazes a face
// or an edge, and the TIE rule makes the winner the brute loop's whatever
// order the tree visits primitives in; chip_smoke.py counts any record and
// pixel that still differs from the brute search, and holds the counters to
// the plain walk's (megakernel.walk_wide_plain).
//
// What bounds it on this card: not operations (the binary skip-link walk it
// replaced ran final_scene's fused frame at 1.4 % of them) but the latency
// of dependent loads and the warp's divergence. Near-first order shrinks
// t_best early, so fewer boxes and leaves pass; single-primitive leaves
// (megakernel.BVH_CARD_LEAF_SIZE) turn primitive tests, with their square
// root and division, into slab tests; a node's children are one node read
// through L1 (final_scene's 237 KB tree fits no block's shared memory, and
// a 17 KB tree staged there measured slower than through L1); a leaf's rows
// are read by
// their leaf-order row, not through an index that must arrive first; the
// winner's normal and material are read once, after the walk, not at every
// closer hit.
template <int MODE, bool BVH = false, class Tab>
__device__ __forceinline__ void closest_surface(const Tab& sc,
                                                const RenderParams& p,
                                                const Ray& r, float a_len,
                                                float inv_a, Hit& h,
                                                WalkCount& wc) {
    h.t_best = INFINITY;
    h.nx = 0.0f;
    h.ny = 0.0f;
    h.nz = 1.0f;
    h.mat = 0;
    h.is_med = false;
    h.kind = 0;
    h.idx = 0;
    if constexpr (!BVH) {
        for (int i = 0; i < p.n_spheres; ++i)
            sphere_test<MODE>(sc, i, r, a_len, inv_a, h);
        for (int i = 0; i < p.n_quads; ++i) quad_test<MODE>(sc, i, r, h);
    } else {
        const float inv_dx = 1.0f / (fabsf(r.dx) < 1e-30f ? 1e-30f : r.dx);
        const float inv_dy = 1.0f / (fabsf(r.dy) < 1e-30f ? 1e-30f : r.dy);
        const float inv_dz = 1.0f / (fabsf(r.dz) < 1e-30f ? 1e-30f : r.dz);
        int stack_ref[WALK_STACK];
        float stack_t[WALK_STACK];
        int sp = 0;
        int cur = 0;  // the root node
        for (;;) {
            if (cur >= 0) {
                const float* f = reinterpret_cast<const float*>(sc.wbvh + cur);
                const int* fi = reinterpret_cast<const int*>(f);
                float tk[BVH_WIDTH];
                int sk[BVH_WIDTH], rk[BVH_WIDTH];
                int nh = 0;
#pragma unroll
                for (int c = 0; c < BVH_WIDTH; ++c) {
                    rk[c] = __ldg(fi + 6 * BVH_WIDTH + c);
                    tk[c] = INFINITY;
                    sk[c] = c + BVH_WIDTH;  // a miss sorts after every hit
                    if (rk[c] != EMPTY_SLOT) {
                        ++wc.visits;
                        const float t0x = (__ldg(f + c) - r.ox) * inv_dx;
                        const float t1x =
                            (__ldg(f + 3 * BVH_WIDTH + c) - r.ox) * inv_dx;
                        const float t0y =
                            (__ldg(f + BVH_WIDTH + c) - r.oy) * inv_dy;
                        const float t1y =
                            (__ldg(f + 4 * BVH_WIDTH + c) - r.oy) * inv_dy;
                        const float t0z =
                            (__ldg(f + 2 * BVH_WIDTH + c) - r.oz) * inv_dz;
                        const float t1z =
                            (__ldg(f + 5 * BVH_WIDTH + c) - r.oz) * inv_dz;
                        const float tmn =
                            fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                  fmaxf(fminf(t0z, t1z), T_MIN));
                        const float tmx =
                            fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                                  fminf(fmaxf(t0z, t1z), h.t_best));
                        if (tmx >= tmn) {
                            tk[c] = tmn;
                            sk[c] = c;
                            ++nh;
                        }
                    }
                }
                // odd-even transposition sort by (entry t, slot): registers
#pragma unroll
                for (int round = 0; round < BVH_WIDTH; ++round) {
#pragma unroll
                    for (int i = round & 1; i + 1 < BVH_WIDTH; i += 2) {
                        if (tk[i + 1] < tk[i]
                            || (tk[i + 1] == tk[i] && sk[i + 1] < sk[i])) {
                            const float t = tk[i];
                            tk[i] = tk[i + 1];
                            tk[i + 1] = t;
                            const int s = sk[i];
                            sk[i] = sk[i + 1];
                            sk[i + 1] = s;
                            const int q = rk[i];
                            rk[i] = rk[i + 1];
                            rk[i + 1] = q;
                        }
                    }
                }
                if (nh > 0) {
#pragma unroll
                    for (int i = BVH_WIDTH - 1; i >= 1; --i) {
                        if (i < nh) {
                            stack_ref[sp] = rk[i];
                            stack_t[sp] = tk[i];
                            ++sp;
                        }
                    }
                    cur = rk[0];
                    continue;
                }
            } else {
                const int4 leaf =
                    __ldg(reinterpret_cast<const int4*>(sc.wbvh) + ~cur);
                for (int k = leaf.x; k < leaf.x + leaf.y; ++k)
                    leaf_sphere(sc, k, r, a_len, inv_a, h);
                for (int k = leaf.z; k < leaf.z + leaf.w; ++k)
                    leaf_quad(sc, k, r, h);
                wc.spheres += leaf.y;
                wc.quads += leaf.w;
            }
            // pop the nearest entry still in reach
            while (sp > 0 && stack_t[sp - 1] > h.t_best) --sp;
            if (sp == 0) break;
            --sp;
            cur = stack_ref[sp];
        }
        // the winner's normal and material, from its own row with the
        // sphere and quad tests' operations
        if constexpr (MODE != MODE_HIT) {
            if (h.kind == 1) {
                const float4 s0 = sc.ld(sc.sph_f + 2 * h.idx);
                const float4 s1 = sc.ld(sc.sph_f + 2 * h.idx + 1);
                const float ccx = s0.x + s1.y * r.time;
                const float ccy = s0.y + s1.z * r.time;
                const float ccz = s0.z + s1.w * r.time;
                h.nx = (r.ox + h.t_best * r.dx - ccx) * s1.x;
                h.ny = (r.oy + h.t_best * r.dy - ccy) * s1.x;
                h.nz = (r.oz + h.t_best * r.dz - ccz) * s1.x;
                h.mat = sc.ld(sc.sph_m + h.idx);
            } else if (h.kind == 2) {
                const float4 c = sc.ld(sc.quad_f + 4 * h.idx + 2);
                h.nx = c.y;
                h.ny = c.z;
                h.nz = c.w;
                h.mat = sc.ld(sc.quad_m + h.idx);
            }
        }
    }
}

// Constant media (constant_medium.rs:34-71): boundary entry/exit in closed
// form, exponential free flight. The boundary kind is a runtime switch per
// medium. A medium wins only if its scatter point is nearer than the surface.
template <int MODE, class Tab>
__device__ __forceinline__ void media_test(const Tab& sc,
                                           const RenderParams& p, const Ray& r,
                                           float a_len, float inv_a,
                                           const CounterRng& rngb, Hit& h) {
    for (int i = 0; i < p.n_media; ++i) {
        const float* m = sc.med_f + 24 * i;
        float entry, exit_;
        bool okb;
        if (sc.ld(sc.med_i + 2 * i) == MED_BOX) {
            const float rx = r.ox - sc.ld(m + 9);
            const float ry = r.oy - sc.ld(m + 10);
            const float rz = r.oz - sc.ld(m + 11);
            float lo[3], ld[3];
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                const float m0 = sc.ld(m + 3 * k), m1 = sc.ld(m + 3 * k + 1),
                            m2 = sc.ld(m + 3 * k + 2);
                lo[k] = m0 * rx + m1 * ry + m2 * rz;
                ld[k] = m0 * r.dx + m1 * r.dy + m2 * r.dz;
            }
            entry = -INFINITY;
            exit_ = INFINITY;
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                const float invd =
                    1.0f / (fabsf(ld[k]) < 1e-30f ? 1e-30f : ld[k]);
                const float t0 = (sc.ld(m + 12 + k) - lo[k]) * invd;
                const float t1 = (sc.ld(m + 15 + k) - lo[k]) * invd;
                entry = fmaxf(entry, fminf(t0, t1));
                exit_ = fminf(exit_, fmaxf(t0, t1));
            }
            okb = entry < exit_;
        } else {
            const float ocx = r.ox - sc.ld(m + 18);
            const float ocy = r.oy - sc.ld(m + 19);
            const float ocz = r.oz - sc.ld(m + 20);
            const float half_b = ocx * r.dx + ocy * r.dy + ocz * r.dz;
            const float c = ocx * ocx + ocy * ocy + ocz * ocz - sc.ld(m + 21);
            const float disc = half_b * half_b - a_len * c;
            const float sq = sqrtf(fmaxf(disc, 0.0f));
            entry = (-half_b - sq) * inv_a;
            exit_ = (-half_b + sq) * inv_a;
            okb = disc > 0.0f;
        }
        entry = fmaxf(entry, T_MIN);
        exit_ = fminf(exit_, h.t_best);
        okb = okb && (entry < exit_);
        const float ray_len = sqrtf(a_len);
        const float dist_in = (exit_ - entry) * ray_len;
        const float u = fmaxf(rngb.uniform(SITE_MEDIUM + (uint32_t)i), 1e-12f);
        const float hd = sc.ld(m + 22) * logf(u);
        okb = okb && (hd <= dist_in);
        const float t_m = entry + hd / ray_len;
        if (okb && (t_m < h.t_best)) {
            h.t_best = t_m;
            h.mat = sc.ld(sc.med_i + 2 * i + 1);
            h.is_med = true;
            if (MODE != MODE_RENDER) {
                h.kind = 3 + i;
                h.idx = 0;
            }
        }
    }
}

// ---- the noise family (B8): hash-lattice Perlin turbulence
// (megakernel.py:448-503). The corner gradients come from the RNG's mixer
// applied to a hash of the integer corner, not from permutation tables: a
// fresh random instance of the same texture family. Same operations in the
// same order as the plain version's `_hash_grad`, `_noise`, `_turbulence`.
constexpr uint32_t NOISE_SALT = 0x5EEDu;

__device__ __forceinline__ void hash_grad(int hx, int hy, int hz, float& gx,
                                          float& gy, float& gz) {
    const uint32_t h = (uint32_t)hx * 0x9E3779B1u + (uint32_t)hy * 0x85EBCA77u
                       + (uint32_t)hz * 0xC2B2AE3Du + NOISE_SALT;
    gx = 2.0f * rng_bits_to_unit_float(rng_mix(h)) - 1.0f;
    gy = 2.0f * rng_bits_to_unit_float(rng_mix(h + 0x01000193u)) - 1.0f;
    gz = 2.0f * rng_bits_to_unit_float(rng_mix(h + 0x02000193u)) - 1.0f;
}

__device__ __forceinline__ float hash_noise(float px, float py, float pz) {
    const float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
    const float ux = px - fx, uy = py - fy, uz = pz - fz;
    const float sx = ux * ux * (3.0f - 2.0f * ux);
    const float sy = uy * uy * (3.0f - 2.0f * uy);
    const float sz = uz * uz * (3.0f - 2.0f * uz);
    const int ix = (int)fx, iy = (int)fy, iz = (int)fz;
    float acc = 0.0f;
#pragma unroll
    for (int di = 0; di < 2; ++di) {
        const float wx = di ? sx : 1.0f - sx;
#pragma unroll
        for (int dj = 0; dj < 2; ++dj) {
            const float wy = dj ? sy : 1.0f - sy;
#pragma unroll
            for (int dk = 0; dk < 2; ++dk) {
                const float wz = dk ? sz : 1.0f - sz;
                float gx, gy, gz;
                hash_grad(ix + di, iy + dj, iz + dk, gx, gy, gz);
                const float dot = gx * (ux - (float)di) + gy * (uy - (float)dj)
                                  + gz * (uz - (float)dk);
                acc = acc + wx * wy * wz * dot;
            }
        }
    }
    return acc;
}

// perlin.rs:52-64: |sum of 0.5^k noise(2^k p)|, seven octaves
__device__ __forceinline__ float hash_turbulence(float px, float py,
                                                 float pz) {
    float acc = 0.0f, w = 1.0f, s = 1.0f;
#pragma unroll 1
    for (int o = 0; o < 7; ++o) {
        acc = acc + w * hash_noise(px * s, py * s, pz * s);
        w = w * 0.5f;
        s = s * 2.0f;
    }
    return fabsf(acc);
}

// ---- the image family (B8): polynomial acos/atan2 for the sphere UV
// (megakernel.py:404-444). Constants are the reference's decimal literals
// rounded from double to float, as the plain version rounds them.
__device__ __forceinline__ float atan_poly(float r) {
    const float r2 = r * r;
    float p = (float)-0.005020576;
    p = p * r2 + (float)0.025330155;
    p = p * r2 + (float)-0.060872567;
    p = p * r2 + (float)0.100020881;
    p = p * r2 + (float)-0.140477845;
    p = p * r2 + (float)0.199740231;
    p = p * r2 + (float)-0.333322323;
    p = p * r2 + (float)0.999999923;
    return p * r;
}

__device__ __forceinline__ float atan2_poly(float y, float x) {
    const float ax = fabsf(x), ay = fabsf(y);
    const float mx = fmaxf(ax, ay), mn = fminf(ax, ay);
    const float r = mn / fmaxf(mx, 1e-30f);
    float a = atan_poly(r);
    if (ay > ax) a = (float)(3.141592653589793 / 2) - a;
    if (x < 0.0f) a = (float)3.141592653589793 - a;
    return y < 0.0f ? -a : a;
}

__device__ __forceinline__ float acos_poly(float x) {
    const float xa = fabsf(fminf(fmaxf(x, -1.0f), 1.0f));
    float p = (float)-0.0012624911;
    p = p * xa + (float)0.0066700901;
    p = p * xa + (float)-0.0170881256;
    p = p * xa + (float)0.0308918810;
    p = p * xa + (float)-0.0501743046;
    p = p * xa + (float)0.0889789874;
    p = p * xa + (float)-0.2145988016;
    p = p * xa + (float)1.5707963050;
    const float a = p * sqrtf(fmaxf(1.0f - xa, 0.0f));
    return x < 0.0f ? (float)3.141592653589793 - a : a;
}

// Texture value at world point (hx, hy, hz) with sphere UV (tu, tv). The
// checker's parity is a FLOORED modulus (fsum - 2*floor(fsum/2)): fmodf would
// be wrong for negative sums. Children of a checker are leaves (SceneBuilder
// nests one level); a leaf is solid, or noise/image where the flag is on.
// Image: nearest texel of the mipped table, u clamped, v flipped
// (texture.rs:83-93). Noise: marble sin(scale*z + 10*turb(p))*0.5+0.5
// (texture.rs:107-111).
template <bool NOISE, bool IMAGE, class Tab>
__device__ __forceinline__ void tex_value(const Tab& sc,
                                          const RenderParams& p, int tid,
                                          float hx, float hy, float hz,
                                          float tu, float tv, float& tr,
                                          float& tg, float& tb) {
    int leaf = tid;
    if (sc.ld(sc.tex_i + 3 * tid) == TEX_CHECKER) {
        const float inv = sc.ld(sc.tex_f + 4 * tid + 3);
        const float fsum = floorf(inv * hx) + floorf(inv * hy) + floorf(inv * hz);
        const bool even = (fsum - 2.0f * floorf(fsum * 0.5f)) == 0.0f;
        leaf = even ? sc.ld(sc.tex_i + 3 * tid + 1) : sc.ld(sc.tex_i + 3 * tid + 2);
    }
    if (NOISE || IMAGE) {
        const int type = sc.ld(sc.tex_i + 3 * leaf);
        if (NOISE && type == TEX_NOISE) {
            const float scale = sc.ld(sc.tex_f + 4 * leaf + 3);
            const float marble =
                sinf(scale * hz + 10.0f * hash_turbulence(hx, hy, hz)) * 0.5f
                + 0.5f;
            tr = tg = tb = marble;
            return;
        }
        if (IMAGE && type == TEX_IMAGE) {
            const float uc = fminf(fmaxf(tu, 0.0f), 1.0f);
            const float vc = 1.0f - fminf(fmaxf(tv, 0.0f), 1.0f);
            const int ti = (int)(uc * (float)(p.img_w - 1));
            const int tj = (int)(vc * (float)(p.img_h - 1));
            const int n = p.img_h * p.img_w;
            const int lin = tj * p.img_w + ti;
            const bool ok = lin >= 0 && lin < n;
            tr = ok ? __ldg(sc.img_f + lin) : 0.0f;
            tg = ok ? __ldg(sc.img_f + n + lin) : 0.0f;
            tb = ok ? __ldg(sc.img_f + 2 * n + lin) : 0.0f;
            return;
        }
    }
    tr = sc.ld(sc.tex_f + 4 * leaf);
    tg = sc.ld(sc.tex_f + 4 * leaf + 1);
    tb = sc.ld(sc.tex_f + 4 * leaf + 2);
}

struct Path {
    Ray ray;
    float tp_r, tp_g, tp_b;     // throughput
    float rad_r, rad_g, rad_b;  // radiance gathered by this sample so far
};

// One bounce of a live path: closest hit, media, emission, scatter, advance.
// Returns true if the path scattered and goes on. `rec` receives the packed
// winner record `kind<<24 | idx` (0 on a miss) outside RENDER mode.
template <int MODE, bool NOISE = false, bool IMAGE = false, bool BVH = false,
          class Tab>
__device__ __forceinline__ bool trace_bounce(const Tab& sc,
                                             const RenderParams& p, Path& s,
                                             bool depth_left_ok,
                                             const CounterRng& rngb, int& rec,
                                             WalkCount& wc) {
    const Ray& r = s.ray;
    const float a_len = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
    const float inv_a = 1.0f / fmaxf(a_len, 1e-30f);
    Hit h;
    closest_surface<MODE, BVH>(sc, p, r, a_len, inv_a, h, wc);
    media_test<MODE>(sc, p, r, a_len, inv_a, rngb, h);

    rec = 0;
    if (!isfinite(h.t_best)) {
        // miss: background (renderer.rs:152-154)
        if (MODE == MODE_RENDER) {
            s.rad_r = s.rad_r + s.tp_r * p.background[0];
            s.rad_g = s.rad_g + s.tp_g * p.background[1];
            s.rad_b = s.rad_b + s.tp_b * p.background[2];
        }
        return false;
    }
    if (MODE != MODE_RENDER) rec = (h.kind << 24) | h.idx;

    const float hpx = r.ox + h.t_best * r.dx;
    const float hpy = r.oy + h.t_best * r.dy;
    const float hpz = r.oz + h.t_best * r.dz;

    // flip the normal toward the ray (hittable.rs:22-37); a medium's "normal"
    // is the ray direction, so front_face is false there
    const float mx = h.is_med ? r.dx : h.nx;
    const float my = h.is_med ? r.dy : h.ny;
    const float mz = h.is_med ? r.dz : h.nz;
    const float ndotd =
        h.is_med ? a_len : (h.nx * r.dx + h.ny * r.dy + h.nz * r.dz);
    const bool front = ndotd < 0.0f;
    const float sign = front ? 1.0f : -1.0f;
    const float nx = sign * mx, ny = sign * my, nz = sign * mz;

    const int m_type = sc.ld(sc.mat_i + 2 * h.mat);
    float tex_r = 0.0f, tex_g = 0.0f, tex_b = 0.0f;
    if (MODE == MODE_RENDER) {
        float tu = 0.0f, tv = 0.0f;
        if (IMAGE) {
            // sphere UV from the outward normal (sphere.rs:48-52):
            // theta = acos(-n.y), phi = atan2(-n.z, n.x) + pi
            const float theta = acos_poly(-h.ny);
            const float phi =
                atan2_poly(-h.nz, h.nx) + (float)3.141592653589793;
            tu = phi * (float)(1.0 / (2.0 * 3.141592653589793));
            tv = theta * (float)(1.0 / 3.141592653589793);
        }
        tex_value<NOISE, IMAGE>(sc, p, sc.ld(sc.mat_i + 2 * h.mat + 1), hpx,
                                hpy, hpz, tu, tv, tex_r, tex_g, tex_b);
        if (m_type == DIFFUSE_LIGHT) {
            // emission (material.rs:114-122), pre-scatter throughput
            s.rad_r = s.rad_r + s.tp_r * tex_r;
            s.rad_g = s.rad_g + s.tp_g * tex_g;
            s.rad_b = s.rad_b + s.tp_b * tex_b;
        }
    }
    if (m_type == DIFFUSE_LIGHT || !depth_left_ok) return false;

    const float inv_len = rsqrtf(fmaxf(a_len, 1e-30f));
    const float udx = r.dx * inv_len, udy = r.dy * inv_len, udz = r.dz * inv_len;
    float new_dx, new_dy, new_dz;
    float at_r = tex_r, at_g = tex_g, at_b = tex_b;

    if (m_type == LAMBERTIAN || m_type == ISOTROPIC) {
        float uvx, uvy, uvz;
        rngb.unit_vector(SITE_SCATTER_Z, SITE_SCATTER_PHI, uvx, uvy, uvz);
        if (m_type == ISOTROPIC) {
            new_dx = uvx;
            new_dy = uvy;
            new_dz = uvz;
        } else {
            // n + unit, near-zero fallback (material.rs:26-42)
            new_dx = nx + uvx;
            new_dy = ny + uvy;
            new_dz = nz + uvz;
            if (fabsf(new_dx) < 1e-8f && fabsf(new_dy) < 1e-8f
                && fabsf(new_dz) < 1e-8f) {
                new_dx = nx;
                new_dy = ny;
                new_dz = nz;
            }
        }
    } else if (m_type == METAL) {
        // mirror + fuzz ball (material.rs:53-64)
        float fx, fy, fz;
        rngb.in_unit_sphere(SITE_FUZZ_Z, SITE_FUZZ_PHI, SITE_FUZZ_R, fx, fy, fz);
        const float fuzz = sc.ld(sc.mat_f + 5 * h.mat + 3);
        const float rdot = udx * nx + udy * ny + udz * nz;
        new_dx = udx - 2.0f * rdot * nx + fuzz * fx;
        new_dy = udy - 2.0f * rdot * ny + fuzz * fy;
        new_dz = udz - 2.0f * rdot * nz + fuzz * fz;
        if (!((new_dx * nx + new_dy * ny + new_dz * nz) > 0.0f)) return false;
        at_r = sc.ld(sc.mat_f + 5 * h.mat);
        at_g = sc.ld(sc.mat_f + 5 * h.mat + 1);
        at_b = sc.ld(sc.mat_f + 5 * h.mat + 2);
    } else {
        // dielectric (material.rs:80-104); ir pads with 1.0
        const float ir = sc.ld(sc.mat_f + 5 * h.mat + 4);
        const float ratio = front ? 1.0f / ir : ir;
        const float rdot = udx * nx + udy * ny + udz * nz;
        const float cos_t = fminf(-rdot, 1.0f);
        const float sin_sq = fmaxf(1.0f - cos_t * cos_t, 0.0f);
        const bool cannot = ratio * ratio * sin_sq > 1.0f;
        const float r0s = (1.0f - ratio) / (1.0f + ratio);
        const float r0 = r0s * r0s;
        const float omc = 1.0f - cos_t;
        const float omc2 = omc * omc;
        const float refl = r0 + (1.0f - r0) * (omc * (omc2 * omc2));
        const float coin = rngb.uniform(SITE_SCHLICK);
        if (cannot || (refl > coin)) {
            new_dx = udx - 2.0f * rdot * nx;
            new_dy = udy - 2.0f * rdot * ny;
            new_dz = udz - 2.0f * rdot * nz;
        } else {
            const float rpx = ratio * (udx + cos_t * nx);
            const float rpy = ratio * (udy + cos_t * ny);
            const float rpz = ratio * (udz + cos_t * nz);
            const float plen =
                fmaxf(1.0f - (rpx * rpx + rpy * rpy + rpz * rpz), 0.0f);
            const float par = -sqrtf(plen);
            new_dx = rpx + par * nx;
            new_dy = rpy + par * ny;
            new_dz = rpz + par * nz;
        }
        at_r = 1.0f;
        at_g = 1.0f;
        at_b = 1.0f;
    }

    if (MODE == MODE_RENDER) {
        s.tp_r = s.tp_r * at_r;
        s.tp_g = s.tp_g * at_g;
        s.tp_b = s.tp_b * at_b;
    }

    // f32 origin offset along the normal, media excluded; sign(0) is 0
    const float sdot = new_dx * nx + new_dy * ny + new_dz * nz;
    const float side = sdot > 0.0f ? 1.0f : (sdot < 0.0f ? -1.0f : 0.0f);
    const float mag = fmaxf(fabsf(hpx), fmaxf(fabsf(hpy), fabsf(hpz)));
    const float eps = ORIGIN_EPS_ABS + ORIGIN_EPS_REL * mag;
    const float off = h.is_med ? 0.0f : side * eps;
    s.ray.ox = hpx + off * nx;
    s.ray.oy = hpy + off * ny;
    s.ray.oz = hpz + off * nz;
    s.ray.dx = new_dx;
    s.ray.dy = new_dy;
    s.ray.dz = new_dz;
    return true;
}

// camera.rs:112-137: pixel jitter, defocus disk, shutter time.
__device__ __forceinline__ void camera_ray(const RenderParams& p, uint32_t pid,
                                           float pi, float pj, uint32_t s_glob,
                                           Ray& r) {
    const CounterRng rng((uint32_t)p.seed, pid, s_glob);
    const float jx = rng.uniform(SITE_PIXEL_JX) - 0.5f;
    const float jy = rng.uniform(SITE_PIXEL_JY) - 0.5f;
    const float sx = p.pixel00[0] + (pi + jx) * p.delta_u[0] + (pj + jy) * p.delta_v[0];
    const float sy = p.pixel00[1] + (pi + jx) * p.delta_u[1] + (pj + jy) * p.delta_v[1];
    const float sz = p.pixel00[2] + (pi + jx) * p.delta_u[2] + (pj + jy) * p.delta_v[2];
    if (p.has_defocus) {
        float ca, sa;
        rng.in_unit_disk(SITE_DEFOCUS_R, SITE_DEFOCUS_TH, ca, sa);
        r.ox = p.center[0] + ca * p.disk_u[0] + sa * p.disk_v[0];
        r.oy = p.center[1] + ca * p.disk_u[1] + sa * p.disk_v[1];
        r.oz = p.center[2] + ca * p.disk_u[2] + sa * p.disk_v[2];
    } else {
        r.ox = p.center[0];
        r.oy = p.center[1];
        r.oz = p.center[2];
    }
    r.dx = sx - r.ox;
    r.dy = sy - r.oy;
    r.dz = sz - r.oz;
    r.time = rng.uniform(SITE_TIME);
}

constexpr unsigned FULL_MASK = 0xffffffffu;

// Write a thread's walk counts to row `i` of `counters` ((rows, 3) int32)
// when the caller passed one; only BVH instantiations count.
template <bool BVH>
__device__ __forceinline__ void put_counts(int* counters, size_t i,
                                           const WalkCount& wc) {
    if constexpr (BVH) {
        if (counters != nullptr) {
            counters[3 * i] = wc.visits;
            counters[3 * i + 1] = wc.spheres;
            counters[3 * i + 2] = wc.quads;
        }
    }
}

// How the host launches render_kernel; mirrors ops/megakernel.py::RenderPlan.
// group: threads a pixel (1, 2, 4, 8, 16 or 32). stage_bytes: 0 (tables read
// through __ldg), or the shared memory a block of the brute loop stages its
// tables in; then mat_rows and tex_rows rows of the material and texture
// tables are staged.
struct RenderPlan {
    int group, stage_bytes, mat_rows, tex_rows;
};

// How the host launches record_kernel; mirrors ops/megakernel.py::
// RecordPlan. blocks: of RECORD_THREADS threads (the launch checks it
// against its own count); stage_bytes, mat_rows, tex_rows as for RenderPlan.
struct RecordPlan {
    int blocks, stage_bytes, mat_rows, tex_rows;
};

constexpr int RENDER_THREADS = 128;

// Copy `bytes` (a multiple of 4) from global memory to `dst` with the whole
// block; returns where they went and moves `dst` on to the next 16-byte
// boundary (ops/megakernel.py::stage_bytes counts the same layout).
__device__ __forceinline__ const void* stage(const void* src, int bytes,
                                             unsigned char*& dst) {
    const int* s = static_cast<const int*>(src);
    int* d = reinterpret_cast<int*>(dst);
    for (int w = threadIdx.x; w < bytes / 4; w += blockDim.x)
        d[w] = __ldg(s + w);
    const void* at = dst;
    dst += (bytes + 15) & ~15;
    return at;
}

// Stage the brute loop's tables (spheres, quads, media, materials,
// textures) in the block's dynamic shared memory and point `sc` at them.
__device__ __forceinline__ void stage_tables(Tables<true>& sc,
                                             const SceneTables& g,
                                             const RenderParams& p,
                                             int mat_rows, int tex_rows) {
    extern __shared__ __align__(16) unsigned char staged[];
    unsigned char* at = staged;
    sc.sph_f = static_cast<const float4*>(stage(g.sph_f, 32 * p.n_spheres, at));
    sc.sph_m = static_cast<const int*>(stage(g.sph_m, 4 * p.n_spheres, at));
    sc.quad_f = static_cast<const float4*>(stage(g.quad_f, 64 * p.n_quads, at));
    sc.quad_m = static_cast<const int*>(stage(g.quad_m, 4 * p.n_quads, at));
    sc.med_f = static_cast<const float*>(stage(g.med_f, 96 * p.n_media, at));
    sc.med_i = static_cast<const int*>(stage(g.med_i, 8 * p.n_media, at));
    sc.mat_f = static_cast<const float*>(stage(g.mat_f, 20 * mat_rows, at));
    sc.mat_i = static_cast<const int*>(stage(g.mat_i, 8 * mat_rows, at));
    sc.tex_f = static_cast<const float*>(stage(g.tex_f, 16 * tex_rows, at));
    sc.tex_i = static_cast<const int*>(stage(g.tex_i, 12 * tex_rows, at));
    __syncthreads();
}

// out_rgb (pixel_count,3): mean radiance over spp samples, f32 sum in sample
// order times f32(1/spp). out_n (pixel_count,): scene queries traced.
// Thread t of the grid works for local pixel t / G as lane t % G (see the
// header); the group's lane 0 writes the pixel. STAGED (brute loop only):
// the tables lie in shared memory.
template <bool NOISE, bool IMAGE, bool BVH, bool STAGED>
__global__ void __launch_bounds__(RENDER_THREADS)
    render_kernel(SceneTables g, RenderParams p, RenderPlan plan,
                  float* __restrict__ out_rgb, int* __restrict__ out_n,
                  int* __restrict__ counters) {
    static_assert(!(BVH && STAGED), "the walk's tables are not staged");
    Tables<STAGED> sc{g};
    if constexpr (STAGED) stage_tables(sc, g, p, plan.mat_rows, plan.tex_rows);

    const int G = plan.group;
    const long long t = (long long)blockIdx.x * RENDER_THREADS + threadIdx.x;
    const int lane = (int)(t % G);
    const long long local = t / G;
    // every thread runs every round: a group's shuffles need all its lanes
    const bool pix_ok = local < p.pixel_count;
    const int pid = p.pixel_base + (pix_ok ? (int)local : 0);
    const float pi = (float)(pid % p.width), pj = (float)(pid / p.width);

    float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
    int n = 0;
    WalkCount wc = {0, 0, 0};
    for (int s0 = 0; s0 < p.spp; s0 += G) {
        float rad_r = 0.0f, rad_g = 0.0f, rad_b = 0.0f;
        if (pix_ok && s0 + lane < p.spp) {
            const uint32_t s_glob = (uint32_t)(s0 + lane + p.sample_offset);
            Path s;
            camera_ray(p, (uint32_t)pid, pi, pj, s_glob, s.ray);
            s.tp_r = s.tp_g = s.tp_b = 1.0f;
            s.rad_r = s.rad_g = s.rad_b = 0.0f;
            for (int d = 0;; ++d) {
                ++n;
                const CounterRng rngb((uint32_t)p.seed, (uint32_t)pid, s_glob,
                                      (uint32_t)d);
                int rec;
                if (!trace_bounce<MODE_RENDER, NOISE, IMAGE, BVH>(
                        sc, p, s, d + 1 < p.max_depth, rngb, rec, wc))
                    break;
            }
            rad_r = s.rad_r;
            rad_g = s.rad_g;
            rad_b = s.rad_b;
        }
        // add the round's samples s0 .. s0+G-1 in sample order
        const int live = p.spp - s0 < G ? p.spp - s0 : G;
        for (int k = 0; k < G; ++k) {
            const float vr = __shfl_sync(FULL_MASK, rad_r, k, G);
            const float vg = __shfl_sync(FULL_MASK, rad_g, k, G);
            const float vb = __shfl_sync(FULL_MASK, rad_b, k, G);
            if (k < live) {
                acc_r = acc_r + vr;
                acc_g = acc_g + vg;
                acc_b = acc_b + vb;
            }
        }
    }
    for (int off = G >> 1; off > 0; off >>= 1) {
        n += __shfl_xor_sync(FULL_MASK, n, off, G);
        if constexpr (BVH) {
            wc.visits += __shfl_xor_sync(FULL_MASK, wc.visits, off, G);
            wc.spheres += __shfl_xor_sync(FULL_MASK, wc.spheres, off, G);
            wc.quads += __shfl_xor_sync(FULL_MASK, wc.quads, off, G);
        }
    }
    if (!pix_ok || lane != 0) return;
    const float inv = (float)(1.0 / (double)p.spp);
    out_rgb[3 * local] = acc_r * inv;
    out_rgb[3 * local + 1] = acc_g * inv;
    out_rgb[3 * local + 2] = acc_b * inv;
    out_n[local] = n;
    put_counts<BVH>(counters, (size_t)local, wc);
}

// Path recorder (replaces the Pallas kernel's record mode,
// rust_tracing_tpu/ops/megakernel.py:1050-1077): the same trace as
// render_kernel through trace_bounce<MODE_RECORD>, which skips texture and
// radiance work and reports the winner `kind<<24 | idx` (1 sphere, 2 quad,
// 3+m medium m) of every bounce. After a path dies (miss, emitter, absorbed
// metal ray, or its max_depth-th segment) every later bounce of that sample
// records 0, as the reference's `alive` carry and records_xla's
// `where(tp_alive, rec, 0)` do.
//
// out (max_depth, spp, pixel_count) int32, depth-major, written in place:
// replay reads one (spp * pixels) bounce row at a time, so no transpose or
// unswizzle follows.
//
// Thread map: one thread a (pixel, sample) on a 1-D grid over the pixel
// range only (ops/megakernel.py::record_plan mirrors it). Warp g of the
// grid traces sample g % spp of the 32 consecutive local pixels
// 32 (g / spp) .. 32 (g / spp) + 31, so each bounce's store of a warp is one
// 128-byte run of a sample plane. (One thread a pixel with its samples one
// after another made 5 625 blocks of 64 threads for a 600x600 slice, ~2.7
// waves of equally long blocks; the last wave ran a whole slice partly
// empty.) A record depends on (seed, pixel, sample, bounce, site) only, never
// on the thread that traces it, so the records are the same bits as one
// thread a pixel's and the plain version's. The brute loop's tables are
// staged in shared memory when they fit the host's budget (STAGED, as
// render_kernel); the BVH walk reads the tree through L1. Walk counters
// (BVH only) are per-pixel sums over the samples: integer atomics, exact in
// any order. Bound: operations (the same primitive tests as render_kernel
// without the shading); it writes 4 bytes per (pixel, sample, bounce).
constexpr int RECORD_THREADS = 128;

template <bool BVH, bool STAGED>
__global__ void __launch_bounds__(RECORD_THREADS)
    record_kernel(SceneTables g, RenderParams p, RecordPlan plan,
                  int* __restrict__ out, int* __restrict__ counters) {
    static_assert(!(BVH && STAGED), "the walk's tables are not staged");
    Tables<STAGED> sc{g};
    if constexpr (STAGED) stage_tables(sc, g, p, plan.mat_rows, plan.tex_rows);
    const long long t = (long long)blockIdx.x * RECORD_THREADS + threadIdx.x;
    const long long warp = t >> 5;
    const int si = (int)(warp % p.spp);
    const long long local = (warp / p.spp) * 32 + (t & 31);
    if (local >= p.pixel_count) return;
    const int pid = p.pixel_base + (int)local;
    const float pi = (float)(pid % p.width), pj = (float)(pid / p.width);
    const size_t plane = (size_t)p.pixel_count;
    WalkCount wc = {0, 0, 0};

    const uint32_t s_glob = (uint32_t)(si + p.sample_offset);
    Path s;
    camera_ray(p, (uint32_t)pid, pi, pj, s_glob, s.ray);
    s.tp_r = s.tp_g = s.tp_b = 1.0f;
    s.rad_r = s.rad_g = s.rad_b = 0.0f;
    bool alive = true;
    for (int d = 0; d < p.max_depth; ++d) {
        int rec = 0;
        if (alive) {
            const CounterRng rngb((uint32_t)p.seed, (uint32_t)pid, s_glob,
                                  (uint32_t)d);
            alive = trace_bounce<MODE_RECORD, false, false, BVH>(
                sc, p, s, d + 1 < p.max_depth, rngb, rec, wc);
        }
        out[((size_t)d * p.spp + si) * plane + local] = rec;
    }
    if constexpr (BVH) {
        if (counters != nullptr) {
            atomicAdd(counters + 3 * local, wc.visits);
            atomicAdd(counters + 3 * local + 1, wc.spheres);
            atomicAdd(counters + 3 * local + 2, wc.quads);
        }
    }
}

// One-bounce closest hit over supplied rays (B3; replaces the Pallas
// kernel's hit mode, rust_tracing_tpu/ops/megakernel.py:1037-1048, host side
// `hit_kernel_call` :1533-1561): the search half of trace_bounce<MODE_HIT>,
// surfaces (brute or the BVH walk) then media, for the sorted deferred
// wavefront (ops/wavefront.py), which shades the winners in tensor code.
// The medium draws come from the counter RNG addressed by (seed, pix[lane],
// samp[lane], bounce): launch geometry never enters it, so a permutation of
// the lanes permutes the output and changes nothing else.
// out[lane] = alive && hit ? kind<<24 | idx : 0 (:1027-1031).
// Bound: operations (slab and primitive tests); it reads 37 bytes a lane and
// writes 4.
constexpr int HIT_BLOCK = 128;

// One thread a lane, in lane order: a warp holds consecutive lanes, which
// the wavefront sorted to walk the same subtrees. (A persistent grid that
// strides over the lanes measured 1.1-1.2x slower on a final_scene chunk at
// 17 waves and no faster at one: a persistent block's lanes are fixed in
// advance and its slowest rays hold its slot, where the hardware hands a
// freed slot to the next block; PERF.md §6.) Each lane's record depends on
// its own inputs only.
template <bool BVH>
__global__ void __launch_bounds__(HIT_BLOCK)
    hit_kernel(SceneTables g, RenderParams p, const float* __restrict__ ox,
               const float* __restrict__ oy, const float* __restrict__ oz,
               const float* __restrict__ dx, const float* __restrict__ dy,
               const float* __restrict__ dz, const float* __restrict__ time,
               const int* __restrict__ pix, const int* __restrict__ samp,
               const bool* __restrict__ alive, long long n, int bounce,
               int* __restrict__ out, int* __restrict__ counters) {
    const Tables<false> sc{g};
    const long long i = (long long)blockIdx.x * HIT_BLOCK + threadIdx.x;
    if (i >= n) return;
    WalkCount wc = {0, 0, 0};
    int rec = 0;
    if (alive[i]) {
        Ray r;
        r.ox = ox[i];
        r.oy = oy[i];
        r.oz = oz[i];
        r.dx = dx[i];
        r.dy = dy[i];
        r.dz = dz[i];
        r.time = time[i];
        const float a_len = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
        const float inv_a = 1.0f / fmaxf(a_len, 1e-30f);
        Hit h;
        closest_surface<MODE_HIT, BVH>(sc, p, r, a_len, inv_a, h, wc);
        const CounterRng rngb((uint32_t)p.seed, (uint32_t)pix[i],
                              (uint32_t)samp[i], (uint32_t)bounce);
        media_test<MODE_HIT>(sc, p, r, a_len, inv_a, rngb, h);
        if (isfinite(h.t_best)) rec = (h.kind << 24) | h.idx;
    }
    out[i] = rec;
    put_counts<BVH>(counters, (size_t)i, wc);
}

}  // namespace rt

namespace {

// The 15 scene tables of ops/megakernel.py::PackedScene.TABLES, in order.
#define RT_TABLE_ARGS                                                        \
    const void *sph_f, const void *sph_m, const void *quad_f,                \
        const void *quad_m, const void *med_f, const void *med_i,            \
        const void *mat_f, const void *mat_i, const void *tex_f,             \
        const void *tex_i, const void *wbvh, const void *wsph_f,             \
        const void *wsph_i, const void *wquad_f, const void *wquad_i
#define RT_TABLES sph_f, sph_m, quad_f, quad_m, med_f, med_i, mat_f, mat_i,  \
                  tex_f, tex_i, wbvh, wsph_f, wsph_i, wquad_f, wquad_i

rt::SceneTables make_tables(RT_TABLE_ARGS, const void* img_f) {
    rt::SceneTables sc;
    sc.sph_f = static_cast<const float4*>(sph_f);
    sc.sph_m = static_cast<const int*>(sph_m);
    sc.quad_f = static_cast<const float4*>(quad_f);
    sc.quad_m = static_cast<const int*>(quad_m);
    sc.med_f = static_cast<const float*>(med_f);
    sc.med_i = static_cast<const int*>(med_i);
    sc.mat_f = static_cast<const float*>(mat_f);
    sc.mat_i = static_cast<const int*>(mat_i);
    sc.tex_f = static_cast<const float*>(tex_f);
    sc.tex_i = static_cast<const int*>(tex_i);
    sc.img_f = static_cast<const float*>(img_f);
    sc.wbvh = static_cast<const float4*>(wbvh);
    sc.wsph_f = static_cast<const float4*>(wsph_f);
    sc.wsph_i = static_cast<const int*>(wsph_i);
    sc.wquad_f = static_cast<const float4*>(wquad_f);
    sc.wquad_i = static_cast<const int*>(wquad_i);
    return sc;
}

// The pixel range is non-empty and inside the frame, spp >= 1.
bool range_ok(const rt::RenderParams& p) {
    return p.width >= 1 && p.height >= 1 && p.pixel_count >= 1
           && p.pixel_base >= 0 && p.spp >= 1
           && (long long)p.pixel_base + p.pixel_count
                  <= (long long)p.width * p.height;
}

// Blocks of record_kernel for the pixel range and spp: one thread a
// (pixel, sample), a warp 32 pixels of one sample (see the kernel); -1 if the
// grid would exceed 2^31 - 1 blocks.
long long record_blocks(const rt::RenderParams& p) {
    const long long warps = ((long long)p.pixel_count + 31) / 32 * p.spp;
    const long long blocks =
        (warps * 32 + rt::RECORD_THREADS - 1) / rt::RECORD_THREADS;
    return blocks > 0x7FFFFFFFLL ? -1 : blocks;
}

// The render kernel's instantiation for the flags of the params and plan.
template <bool NOISE, bool IMAGE>
const void* render_fn(bool bvh, bool staged) {
    if (bvh) return (const void*)rt::render_kernel<NOISE, IMAGE, true, false>;
    if (staged)
        return (const void*)rt::render_kernel<NOISE, IMAGE, false, true>;
    return (const void*)rt::render_kernel<NOISE, IMAGE, false, false>;
}

const void* render_fn(int noise, int image, int bvh, int staged) {
    if (noise && image) return render_fn<true, true>(bvh, staged);
    if (noise) return render_fn<true, false>(bvh, staged);
    if (image) return render_fn<false, true>(bvh, staged);
    return render_fn<false, false>(bvh, staged);
}

// record_kernel (which 1: the walk, the staged brute loop or the brute loop
// through __ldg) or hit_kernel (which 2), with or without the walk.
const void* search_fn(int which, int bvh, int staged) {
    if (which == 1) {
        if (bvh) return (const void*)rt::record_kernel<true, false>;
        return staged ? (const void*)rt::record_kernel<false, true>
                      : (const void*)rt::record_kernel<false, false>;
    }
    return bvh ? (const void*)rt::hit_kernel<true>
               : (const void*)rt::hit_kernel<false>;
}

// out[0] blocks an SM holds with `threads` threads and `smem` bytes of
// dynamic shared memory, out[1] registers a thread, out[2] local memory a
// thread in bytes (spills and stack), out[3] threads.
int resources(const void* fn, int threads, int smem, int* out) {
    cudaFuncAttributes attr;
    int err = (int)cudaFuncGetAttributes(&attr, fn);
    if (err != 0) return err;
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fn,
                                                             threads, smem);
    out[1] = attr.numRegs;
    out[2] = (int)attr.localSizeBytes;
    out[3] = threads;
    return err;
}

}  // namespace

// Launch the render kernel on `stream` over pixels
// [params->pixel_base, params->pixel_base + params->pixel_count). `params`
// and `plan` are host pointers (rt::RenderParams, rt::RenderPlan): the
// params' has_noise/has_image/use_bvh flags and the plan's stage_bytes pick
// the instantiation, the plan's group the threads a pixel; `img_f` is the
// (3, img_h * img_w) image table. `counters` is null, or (pixel_count, 3)
// int32 that a BVH instantiation fills with each pixel's walk counts. Does
// not synchronise. Returns cudaGetLastError().
extern "C" int rt_render_launch(RT_TABLE_ARGS, const void* img_f,
                                const void* params, const void* plan_ptr,
                                void* out_rgb, void* out_n, void* counters,
                                void* stream) {
    rt::RenderParams p = *static_cast<const rt::RenderParams*>(params);
    rt::RenderPlan plan = *static_cast<const rt::RenderPlan*>(plan_ptr);
    rt::SceneTables sc = make_tables(RT_TABLES, img_f);
    const int g = plan.group;
    if (!range_ok(p) || p.img_h < 1 || p.img_w < 1
        || p.n_nodes < 1 || g < 1 || g > 32 || (g & (g - 1)) != 0
        || plan.stage_bytes < 0 || plan.stage_bytes > 48 * 1024
        || (plan.stage_bytes > 0 && p.use_bvh) || plan.mat_rows < 1
        || plan.tex_rows < 1)
        return (int)cudaErrorInvalidValue;
    const long long blocks =
        ((long long)p.pixel_count * g + rt::RENDER_THREADS - 1)
        / rt::RENDER_THREADS;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    float* rgb = static_cast<float*>(out_rgb);
    int* n = static_cast<int*>(out_n);
    int* cnt = static_cast<int*>(counters);
    void* args[] = {&sc, &p, &plan, &rgb, &n, &cnt};
    (void)cudaGetLastError();  // clear a stale error of an earlier call
    const cudaError_t err = cudaLaunchKernel(
        render_fn(p.has_noise, p.has_image, p.use_bvh, plan.stage_bytes > 0),
        dim3((unsigned)blocks), dim3(rt::RENDER_THREADS), args,
        (size_t)plan.stage_bytes, static_cast<cudaStream_t>(stream));
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The resources of the render kernel's instantiation for these flags (at
// RENDER_THREADS threads and `stage_bytes` of shared memory): see
// resources(). Returns a CUDA error code.
extern "C" int rt_render_occupancy(int noise, int image, int bvh,
                                   int stage_bytes, int* out) {
    return resources(render_fn(noise, image, bvh, stage_bytes > 0),
                     rt::RENDER_THREADS, stage_bytes, out);
}

// The resources of record_kernel (which 1; staged when `stage_bytes` > 0,
// with that much dynamic shared memory) or hit_kernel (which 2), with or
// without the walk: see resources(). Returns a CUDA error code.
extern "C" int rt_search_occupancy(int which, int bvh, int stage_bytes,
                                   int* out) {
    if ((which != 1 && which != 2) || stage_bytes < 0
        || (stage_bytes > 0 && (which != 1 || bvh)))
        return (int)cudaErrorInvalidValue;
    return resources(search_fn(which, bvh, stage_bytes > 0),
                     which == 1 ? rt::RECORD_THREADS : rt::HIT_BLOCK,
                     stage_bytes, out);
}

// Launch the path recorder on `stream` over the same pixel range; `params`
// and `plan` are host pointers (rt::RenderParams, rt::RecordPlan: its
// blocks must be record_blocks(params), its stage_bytes > 0 picks the staged
// brute loop); `out_rec` holds max_depth * spp * pixel_count int32;
// `counters` null, or (pixel_count, 3) int32 holding zeros, to which a BVH
// instantiation adds each pixel's walk counts over its samples. Does not
// synchronise. Returns cudaGetLastError().
extern "C" int rt_record_launch(RT_TABLE_ARGS, const void* params,
                                const void* plan_ptr, void* out_rec,
                                void* counters, void* stream) {
    rt::RenderParams p = *static_cast<const rt::RenderParams*>(params);
    rt::RecordPlan plan = *static_cast<const rt::RecordPlan*>(plan_ptr);
    rt::SceneTables sc = make_tables(RT_TABLES, nullptr);
    if (!range_ok(p) || p.max_depth < 1 || p.n_nodes < 1
        || plan.blocks != record_blocks(p) || plan.stage_bytes < 0
        || plan.stage_bytes > 48 * 1024 || (plan.stage_bytes > 0 && p.use_bvh)
        || plan.mat_rows < 1 || plan.tex_rows < 1)
        return (int)cudaErrorInvalidValue;
    int* out = static_cast<int*>(out_rec);
    int* cnt = static_cast<int*>(counters);
    void* args[] = {&sc, &p, &plan, &out, &cnt};
    (void)cudaGetLastError();
    const cudaError_t err = cudaLaunchKernel(
        search_fn(1, p.use_bvh, plan.stage_bytes > 0),
        dim3((unsigned)plan.blocks), dim3(rt::RECORD_THREADS), args,
        (size_t)plan.stage_bytes, static_cast<cudaStream_t>(stream));
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// Launch the one-bounce hit kernel on `stream` over `n` lanes, one thread a
// lane: ox..time f32, pix and samp int32, alive bool, each (n,); `out` (n,)
// int32 records; `counters` null or (n, 3) int32 as for the render. Only
// `params`' counts, seed and BVH fields are read. Does not synchronise.
// Returns cudaGetLastError().
extern "C" int rt_hit_launch(RT_TABLE_ARGS, const void* params,
                             const void* ox, const void* oy, const void* oz,
                             const void* dx, const void* dy, const void* dz,
                             const void* time, const void* pix,
                             const void* samp, const void* alive, long long n,
                             int bounce, void* out, void* counters,
                             void* stream) {
    const rt::RenderParams p = *static_cast<const rt::RenderParams*>(params);
    const rt::SceneTables sc = make_tables(RT_TABLES, nullptr);
    if (n < 1 || p.n_nodes < 1) return (int)cudaErrorInvalidValue;
    const long long blocks = (n + rt::HIT_BLOCK - 1) / rt::HIT_BLOCK;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const auto f = [](const void* q) { return static_cast<const float*>(q); };
    const auto i = [](const void* q) { return static_cast<const int*>(q); };
    (void)cudaGetLastError();
    if (p.use_bvh)
        rt::hit_kernel<true><<<(unsigned)blocks, rt::HIT_BLOCK, 0, st>>>(
            sc, p, f(ox), f(oy), f(oz), f(dx), f(dy), f(dz), f(time), i(pix),
            i(samp), static_cast<const bool*>(alive), n, bounce,
            static_cast<int*>(out), static_cast<int*>(counters));
    else
        rt::hit_kernel<false><<<(unsigned)blocks, rt::HIT_BLOCK, 0, st>>>(
            sc, p, f(ox), f(oy), f(oz), f(dx), f(dy), f(dz), f(time), i(pix),
            i(samp), static_cast<const bool*>(alive), n, bounce,
            static_cast<int*>(out), static_cast<int*>(counters));
    return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
