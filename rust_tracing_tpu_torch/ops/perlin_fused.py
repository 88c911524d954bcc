"""Fused Perlin turbulence: CUDA kernel wrappers and autograd Functions.

Counterpart of rust_tracing_tpu/ops/perlin_tpu.py, whose Pallas kernel
(``_kernel``, called through ``turbulence``) fuses the whole 7-octave
turbulence of the exact table noise into one dispatch. Here it is the
hand-written CUDA kernel of ``csrc/perlin_kernel.cu`` (kernel B7): one thread
per lane, the gradient rows replicated in shared memory so that a warp's
128-bit loads meet no bank conflict, seven octaves x eight corners in
registers. Its plain version is ``ops/perlin.py::turbulence_c``, which it
equals bit for bit (same f32 or f64 operations in the same order, built
without multiply-add contraction). The backward is a kernel too
(``perlin_backward_kernel``, which the reference leaves to XLA); its plain
version is ``turbulence_backward_plain``.

``turbulence`` is a ``torch.autograd.Function``:

- forward: the kernel for CUDA tensors, the plain version for CPU tensors;
- backward: ``_TurbulenceBackward``, the backward kernel for CUDA tensors
  and its plain version for CPU tensors. It saves only the inputs.
  Gradients reach ``px, py, pz`` and ``ranvec``; the permutation tables are
  integers. Its vmap rule (jacrev's batched cotangents) runs one call a
  batch row. It is not differentiable twice;
- jvp: the plain version's jvp (``torch.func.jvp``), as the reference's
  ``_turb_jvp`` takes its tangent from the XLA formulation;
- vmap: the reference's batching rule ``_turb_batch``, for batched points:
  the batch dims move to the front and are flattened into the lane axis,
  one launch for the whole batch. The tables are shared; a batched table is
  refused. With the jvp, ``torch.func.jacfwd`` runs through the Function.
"""

from __future__ import annotations

import math

import torch

from ..runtime.kernels import LAUNCHES
from . import perlin

DEPTH = 7


def _check(ranvec, perms, pts):
    dev = pts[0].device
    dtype = pts[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"turbulence takes f32 or f64 positions, got {dtype}")
    for p in pts:
        if p.device != dev or p.dtype != dtype or p.shape != pts[0].shape:
            raise ValueError("px, py, pz must share device, dtype and shape")
    if ranvec.shape != (perlin.POINT_COUNT, 3) or ranvec.device != dev:
        raise ValueError(f"ranvec must be ({perlin.POINT_COUNT}, 3) on {dev}, "
                         f"got {tuple(ranvec.shape)} on {ranvec.device}")
    for q in perms:
        if (q.shape != (perlin.POINT_COUNT,) or q.device != dev
                or q.is_floating_point()):
            raise ValueError(f"permutation tables must be integer "
                             f"({perlin.POINT_COUNT},) on {dev}")
    return dev, dtype


def _tables(ranvec, perms, dtype):
    """The kernels' table arguments: ranvec (256, 3) in the positions'
    type, the permutations as int32; copies only where those differ."""
    return ((ranvec.detach().to(dtype).contiguous(),)
            + tuple(q.to(torch.int32).contiguous() for q in perms))


def _cuda_only(name, dev, depth):
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")


def turbulence_kernel(ranvec, perm_x, perm_y, perm_z, px, py, pz,
                      depth: int = DEPTH) -> torch.Tensor:
    """One launch of the CUDA turbulence kernel over every lane of
    ``px, py, pz`` (any shape, f32 or f64 CUDA tensors). Returns a tensor
    of their shape. Launches on the current stream and does not
    synchronise. CPU tensors are refused: the caller picks the plain
    version for those."""
    dev, dtype = _check(ranvec, (perm_x, perm_y, perm_z), (px, py, pz))
    _cuda_only("turbulence_kernel", dev, depth)
    from ..runtime import kernels

    flat = [p.reshape(-1).contiguous() for p in (px, py, pz)]
    tabs = _tables(ranvec, (perm_x, perm_y, perm_z), dtype)
    out = torch.empty(flat[0].shape, dtype=dtype, device=dev)
    R = flat[0].numel()
    if R:
        lib = kernels.load()
        with torch.cuda.device(dev):
            err = lib.rt_perlin_launch(
                *[t.data_ptr() for t in tabs], *[f.data_ptr() for f in flat],
                R, int(depth), int(dtype == torch.float64), out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        LAUNCHES["perlin_kernel"] += 1
        kernels.check(err, "perlin kernel")
    return out.reshape(px.shape)


def turbulence_plain(ranvec, perm_x, perm_y, perm_z, px, py, pz,
                     depth: int = DEPTH) -> torch.Tensor:
    """Plain version of ``turbulence_kernel`` (ops/perlin.py)."""
    return perlin.turbulence_c(ranvec.to(px.dtype), perm_x, perm_y, perm_z,
                               px, py, pz, depth=depth)


def turbulence_backward_kernel(ranvec, perm_x, perm_y, perm_z, px, py, pz,
                               g, depth: int = DEPTH, want_p: bool = True,
                               want_rv: bool = True):
    """One call of the CUDA backward: the turbulence's vector-Jacobian
    product for the cotangent ``g`` (the positions' shape). Returns
    ``(d_ranvec, d_px, d_py, d_pz)``, None where not asked; ``d_ranvec``
    is (256, 3) in the positions' type, the fixed-point sum of
    ``fixed_scale`` (the same bits whatever the order of its additions).
    When ``want_rv``: ``perlin_backward_scale`` (max|g|),
    ``perlin_backward_kernel`` over the blocks that fit the card, and
    ``perlin_backward_final`` (the 768 integer sums to floats), through
    one small int64 scratch; else the main kernel alone. Launches on the
    current stream and does not synchronise; CPU tensors are refused."""
    dev, dtype = _check(ranvec, (perm_x, perm_y, perm_z), (px, py, pz, g))
    _cuda_only("turbulence_backward_kernel", dev, depth)
    from ..runtime import kernels

    flat = [p.reshape(-1).contiguous() for p in (px, py, pz, g)]
    tabs = _tables(ranvec, (perm_x, perm_y, perm_z), dtype)
    R = flat[0].numel()
    f64 = dtype == torch.float64
    if want_rv and depth > FIXED_MAX_DEPTH:
        raise ValueError(f"the kernel's d_ranvec takes depth <= "
                         f"{FIXED_MAX_DEPTH}, got {depth}")
    if want_rv and f64 and R * depth >= FIXED_F64_MAX_LANE_OCTAVES:
        raise ValueError(f"f64 d_ranvec takes R * depth < "
                         f"{FIXED_F64_MAX_LANE_OCTAVES}, got {R * depth}")
    d_p = [torch.empty(flat[0].shape, dtype=dtype, device=dev)
           for _ in range(3)] if want_p else [None] * 3
    # no lanes, no launch: d_ranvec is then 0
    d_rv = ((torch.empty if R else torch.zeros)(
        (perlin.POINT_COUNT, 3), dtype=dtype, device=dev)
        if want_rv else None)
    if R and (want_p or want_rv):
        lib = kernels.load()
        acc = (torch.empty(lib.rt_perlin_backward_acc_words(int(f64)),
                           dtype=torch.int64, device=dev)
               if want_rv else None)

        def ptr(t):
            return t.data_ptr() if t is not None else None

        with torch.cuda.device(dev):
            err = lib.rt_perlin_backward_launch(
                *[t.data_ptr() for t in tabs], *[f.data_ptr() for f in flat],
                R, int(depth), int(f64), int(want_p), int(want_rv),
                *[ptr(t) for t in d_p], ptr(acc), ptr(d_rv),
                torch.cuda.current_stream(dev).cuda_stream)
        LAUNCHES["perlin_backward_kernel"] += 1
        kernels.check(err, "perlin backward kernel")
    d_p = [d.reshape(px.shape) if d is not None else None for d in d_p]
    return (d_rv, *d_p)


# f64's second fixed-point word holds up to 2^31 a term, 8 terms a lane and
# octave: its int64 sum stays exact while R * depth < 2^29.
FIXED_F64_MAX_LANE_OCTAVES = 1 << 29
# the kernel's block tables take 8 x depth adds of < 2^16 a lane into a
# 32-bit word, a block of 256 lanes at least once between drains
# (csrc/perlin_kernel.cu, drain_iters)
FIXED_MAX_DEPTH = 32


def fixed_scale(R: int, gmax: float, dtype):
    """The fixed-point scale of d_ranvec's sum (``csrc/perlin_kernel.cu``,
    ``fixed_exponent``): each term t is summed as the integer rint(t *
    2^k), k = 58 - ceil(log2 R) - e where max|g| < 2^e (frexp's exponent).
    Every term has |t| <= |g| 0.5^octave, so the terms of one entry sum to
    less than 16 R max|g| < 2^(62 - k): no int64 sum overflows. Returns
    (ka, kb), k = ka + kb with ka clamped to ``dtype``'s normal exponents
    (so 2^ka and 2^kb are both numbers of that type), or None when max|g|
    is not finite."""
    if not math.isfinite(gmax):
        return None
    k = 58 - (R - 1).bit_length() - math.frexp(gmax)[1]
    lo, hi = (-126, 127) if dtype == torch.float32 else (-1022, 1023)
    ka = min(max(k, lo), hi)
    return ka, k - ka


def _quantize(t, ka, kb):
    """The integers of the terms ``t`` (the kernel's ``Fixed<T>::
    quantize``): f32 one int64, rint(t * 2^ka * 2^kb); f64 two, that
    rint and the rint of the remainder's next 32 bits."""
    y = (t * 2.0 ** ka) * 2.0 ** kb
    q = torch.round(y)
    if t.dtype == torch.float32:
        return (q.to(torch.int64),)
    return q.to(torch.int64), torch.round((y - q) * 2.0 ** 32).to(torch.int64)


def _fixed_value(sums, ka, kb, dtype):
    """The kernel's ``perlin_backward_final``: the integer sums (one or two
    int64 tensors) back to ``dtype``, through float64."""
    if len(sums) == 1:
        v = sums[0].to(torch.float64)
    else:
        q0, q1 = sums
        v = ((q0 + (q1 >> 32)).to(torch.float64)
             + (q1 & 0xFFFFFFFF).to(torch.float64) * 2.0 ** -32)
    return ((v * 2.0 ** -ka) * 2.0 ** -kb).to(dtype)


def turbulence_backward_plain(ranvec, perm_x, perm_y, perm_z, px, py, pz,
                              g, depth: int = DEPTH, want_p: bool = True,
                              want_rv: bool = True):
    """Plain version of ``turbulence_backward_kernel``: the per-lane
    formulas of ``perlin.turbulence_vjp_c``, whose ``ranvec`` terms are
    scaled and rounded as the kernel does (``fixed_scale``, ``_quantize``),
    summed exactly by int64 ``index_add_`` and converted back
    (``_fixed_value``): equal to the kernel bit for bit, ``d_ranvec``
    included. ``d_ranvec`` is 0 with no lanes and NaN where max|g| is not
    finite."""
    dx, dy, dz, terms = perlin.turbulence_vjp_c(
        ranvec.detach().to(px.dtype), perm_x, perm_y, perm_z, px, py, pz, g,
        depth, want_terms=want_rv)
    d_rv = None
    if want_rv:
        shape = (perlin.POINT_COUNT, 3)
        scale = (fixed_scale(g.numel(), float(g.abs().max()), px.dtype)
                 if g.numel() else (0, 0))
        if scale is None:
            d_rv = torch.full(shape, math.nan, dtype=px.dtype,
                              device=px.device)
        else:
            sums = None
            for h, c in terms:
                qs = _quantize(c.reshape(3, -1).t(), *scale)
                if sums is None:
                    sums = [torch.zeros(shape, dtype=torch.int64,
                                        device=px.device) for _ in qs]
                for acc, q in zip(sums, qs):
                    acc.index_add_(0, h.reshape(-1).long(), q)
            d_rv = _fixed_value(sums, *scale, px.dtype)
    return (d_rv,) + ((dx, dy, dz) if want_p else (None, None, None))


class _TurbulenceBackward(torch.autograd.Function):
    """The turbulence's backward as a Function: the kernel for CUDA tensors,
    its plain version for CPU tensors. Under vmap (jacrev's batched
    cotangents) its rule runs one call a batch row. Returns the requested
    gradients only, in the order d_ranvec, d_px, d_py, d_pz."""

    @staticmethod
    def forward(ranvec, perm_x, perm_y, perm_z, px, py, pz, g, depth,
                want_p, want_rv):
        run = (turbulence_backward_plain if px.device.type == "cpu"
               else turbulence_backward_kernel)
        got = run(ranvec, perm_x, perm_y, perm_z, px, py, pz, g, depth,
                  want_p, want_rv)
        return tuple(t for t in got if t is not None)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, ranvec, perm_x, perm_y, perm_z, px, py, pz, g,
             depth, want_p, want_rv):
        args = (ranvec, perm_x, perm_y, perm_z, px, py, pz, g)
        rows = [_TurbulenceBackward.apply(
            *[a if d is None else a.select(d, b)
              for a, d in zip(args, in_dims[:8])],
            depth, want_p, want_rv) for b in range(info.batch_size)]
        out = tuple(torch.stack(col) for col in zip(*rows))
        return out, (0,) * len(out)


class _Turbulence(torch.autograd.Function):
    @staticmethod
    def forward(ranvec, perm_x, perm_y, perm_z, px, py, pz, depth):
        if px.device.type == "cpu":
            return turbulence_plain(ranvec, perm_x, perm_y, perm_z, px, py,
                                    pz, depth)
        return turbulence_kernel(ranvec, perm_x, perm_y, perm_z, px, py, pz,
                                 depth)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ranvec, perm_x, perm_y, perm_z, px, py, pz, depth = inputs
        ctx.depth = depth
        ctx.save_for_backward(ranvec, perm_x, perm_y, perm_z, px, py, pz)
        ctx.save_for_forward(ranvec, perm_x, perm_y, perm_z, px, py, pz)

    @staticmethod
    def backward(ctx, g):
        ranvec, perm_x, perm_y, perm_z, px, py, pz = ctx.saved_tensors
        want_rv = ctx.needs_input_grad[0]
        want_p = any(ctx.needs_input_grad[4:7])
        if not (want_rv or want_p):
            return (None,) * 8
        got = list(_TurbulenceBackward.apply(
            ranvec, perm_x, perm_y, perm_z, px, py, pz, g, ctx.depth, want_p,
            want_rv))
        d_rv = got.pop(0).to(ranvec.dtype) if want_rv else None
        d_px, d_py, d_pz = (
            got[i] if want_p and ctx.needs_input_grad[4 + i] else None
            for i in range(3))
        return d_rv, None, None, None, d_px, d_py, d_pz, None

    @staticmethod
    def jvp(ctx, d_rv, _dpx, _dpy, _dpz, d_px, d_py, d_pz, _ddepth):
        ranvec, perm_x, perm_y, perm_z, px, py, pz = ctx.saved_tensors
        primals = (ranvec, px, py, pz)
        tangents = tuple(torch.zeros_like(p) if t is None else t
                         for p, t in zip(primals, (d_rv, d_px, d_py, d_pz)))

        def plain(rv, x, y, z):
            return turbulence_plain(rv, perm_x, perm_y, perm_z, x, y, z,
                                    ctx.depth)

        return torch.func.jvp(plain, primals, tangents)[1]

    @staticmethod
    def vmap(info, in_dims, ranvec, perm_x, perm_y, perm_z, px, py, pz,
             depth):
        if any(d is not None for d in in_dims[:4]):
            raise ValueError("turbulence batches over the points only; the "
                             "ranvec and permutation tables are shared")
        B = info.batch_size
        pts = [p.movedim(d, 0) if d is not None else p.expand((B,) + p.shape)
               for p, d in zip((px, py, pz), in_dims[4:7])]
        out = _Turbulence.apply(ranvec, perm_x, perm_y, perm_z,
                                *[p.reshape(-1) for p in pts], depth)
        return out.reshape(pts[0].shape), 0


def turbulence(ranvec, perm_x, perm_y, perm_z, px, py, pz,
               depth: int = DEPTH) -> torch.Tensor:
    """Exact table Perlin turbulence (perlin.rs:52-64) of component-form
    positions: the CUDA kernel on a GPU, its plain version on the CPU; equal
    bit for bit. Differentiable w.r.t. ``ranvec`` and the positions."""
    _check(ranvec, (perm_x, perm_y, perm_z), (px, py, pz))
    return _Turbulence.apply(ranvec, perm_x, perm_y, perm_z, px, py, pz,
                             depth)
