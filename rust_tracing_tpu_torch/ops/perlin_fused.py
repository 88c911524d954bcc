"""Fused Perlin turbulence: CUDA kernel wrapper and autograd Function.

Counterpart of rust_tracing_tpu/ops/perlin_tpu.py, whose Pallas kernel
(``_kernel``, called through ``turbulence``) fuses the whole 7-octave
turbulence of the exact table noise into one dispatch. Here it is the
hand-written CUDA kernel of ``csrc/perlin_kernel.cu`` (kernel B7): one thread
per lane, the four 256-entry tables staged in shared memory, seven octaves x
eight corners in registers. Its plain version is ``ops/perlin.py::
turbulence_c``, which it equals bit for bit (same f32 or f64 operations in
the same order, built without multiply-add contraction).

``turbulence`` is a ``torch.autograd.Function``:

- forward: the kernel for CUDA tensors, the plain version for CPU tensors;
- backward: the gradient of the plain version, recomputed by
  ``torch.func.vjp`` (the reference's primitive delegates its jvp to the
  XLA formulation the same way and has no backward kernel), so that it
  also runs under vmap (jacrev's batched cotangents). Gradients
  reach ``px, py, pz`` and ``ranvec``; the permutation tables are integers;
- jvp: the plain version's jvp (``torch.func.jvp``), as the reference's
  ``_turb_jvp`` takes its tangent from the XLA formulation;
- vmap: the reference's batching rule ``_turb_batch``, for batched points:
  the batch dims move to the front and are flattened into the lane axis,
  one launch for the whole batch. The tables are shared; a batched table is
  refused. With the jvp, ``torch.func.jacfwd`` runs through the Function.
"""

from __future__ import annotations

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


def turbulence_kernel(ranvec, perm_x, perm_y, perm_z, px, py, pz,
                      depth: int = DEPTH) -> torch.Tensor:
    """One launch of the CUDA turbulence kernel over every lane of
    ``px, py, pz`` (any shape, f32 or f64 CUDA tensors). Returns a tensor of
    their shape. Launches on the current stream and does not synchronise.
    CPU tensors are refused: the caller picks the plain version for those."""
    dev, dtype = _check(ranvec, (perm_x, perm_y, perm_z), (px, py, pz))
    if dev.type != "cuda":
        raise ValueError(f"turbulence_kernel needs CUDA tensors, got {dev}")
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    from ..runtime import kernels

    flat = [p.reshape(-1).contiguous() for p in (px, py, pz)]
    rv = ranvec.detach().to(dtype).t().contiguous()          # (3, 256)
    perms = torch.stack([q.to(torch.int32) for q in (perm_x, perm_y, perm_z)]
                        ).contiguous()                         # (3, 256)
    out = torch.empty(flat[0].shape, dtype=dtype, device=dev)
    R = flat[0].numel()
    if R:
        lib = kernels.load()
        with torch.cuda.device(dev):
            err = lib.rt_perlin_launch(
                rv.data_ptr(), perms.data_ptr(), *[f.data_ptr() for f in flat],
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
        leaves = (ranvec, px, py, pz)
        asked = [i for i, j in enumerate((0, 4, 5, 6))
                 if ctx.needs_input_grad[j]]

        def plain(*vals):
            full = list(leaves)
            for i, v in zip(asked, vals):
                full[i] = v
            return turbulence_plain(full[0], perm_x, perm_y, perm_z,
                                    *full[1:], ctx.depth)

        _, vjp = torch.func.vjp(plain, *[leaves[i] for i in asked])
        got = dict(zip(asked, vjp(g)))
        d_rv, d_px, d_py, d_pz = (got.get(i) for i in range(4))
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
