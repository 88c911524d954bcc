"""render_kernel_roofline: 100 x the least time of the traced frames'
fused renders over render_kernel's device time. The operations are a brute
search's (every query against every primitive, every query shaded, every
camera ray made) from the frames' queries; the bytes are each pixel's
16-byte write and each primitive's row read once. The primitives are the
reference scene's, counted by the benchmark. Only a scene the kernel
searches by brute force (fewer than yardstick.BRUTE_MAX_PRIMS primitives)
is read: a walked tree does not test every primitive."""

from port_bench import check, yardstick


def read(ctx):
    if not ctx.device_events or not ctx.units:
        return None
    scene = check.reference_scene(ctx.cell)
    n_prims = len(scene.spheres) + len(scene.quads)
    if n_prims >= yardstick.BRUTE_MAX_PRIMS:
        return None
    secs = sum(e - s for name, s, e in ctx.device_events
               if yardstick.kernel_name(name) == "render_kernel")
    if secs <= 0:
        return None
    cam = yardstick.samples(ctx.units, ctx.n_pix)
    rays = sum(u.rays for u in ctx.units)
    ops = yardstick.brute_render_ops(cam, rays, n_prims)
    n_bytes = len(ctx.units) * (ctx.n_pix * 16 + n_prims * 64)
    return yardstick.roofline_pct(ops, n_bytes, secs, ctx.device_kind)
