"""Measurements behind the probe kernels of ``csrc/probe_kernel.cu``, on one
GPU:

  python -m rust_tracing_tpu_torch.probe_study [p7|gathers] [--parent DIR]
      [--out DIR]

builds this checkout's probe_kernel.cu ("change") and DIR's ("parent"),
each alone into its own library (one nvcc each, all at once); for each
library prints the studied kernels' registers and spills (ptxas) and a SASS
summary of each kernel's inner loop (the innermost loop around the reads
the study names: its opcodes, reads, adds and integer operations, and the
opcodes banned there), writing the whole listing to
OUT/<study>_<name>.sass; checks every library and times the studied
kernels of every library in turns (the libraries in order, then in
reverse) by ``probes.time_ms``. Prints JSON lines, the card's name and
power limit first and last.

``p7`` (``sphere_mxu_f32_kernel``, ``sphere_mxu_tc_kernel``): the pair
loop (around ``LDS``/``HMMA``; banned: the division's ``MUFU.RCP`` and
``FCHK``, ``F2F``, ``I2F``, ``LDG``); checks on the sweep's inputs at one
tile and at 1024 tiles and on the edge tile (f32: bit for bit the plain
version; TF32: ``probes.tf32_gate``, and its t bit for bit the first
library's TF32 t).

``gathers`` (P3 ``gather_probe_kernel``, P4 ``gather_2d_kernel``): the
gather loop (around ``LDS``/``LDG``; banned in a shared variant's loop: an
integer division's ``IMAD.HI`` and ``I2F``/``F2I``), with each opcode a
gather; checks every variant of the sweep (P3 both spaces at strides
13/2/16/32, P4 both spaces) bit for bit against the plain version of one
tile at one tile and one gather, and at FILL_TILES and UNEVEN_TILES tiles
at 1 and ``GATHER_TIMING_REPS`` gathers; times each at FILL_TILES tiles and
``GATHER_TIMING_REPS`` gathers, with its smem floor.

The other probes in turns: ``python -m rust_tracing_tpu_torch.probes`` in
each checkout."""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import subprocess

import torch

from . import probes
from .runtime import kernels
from .turbulence_study import card

HERE = os.path.dirname(os.path.abspath(__file__))
# per study: the kernels, the reads that mark its inner loop, the opcodes
# that must not be in that loop
STUDIES = {
    "p7": dict(kernels=("sphere_mxu_f32_kernel", "sphere_mxu_tc_kernel"),
               reads=r"\b(LDS|HMMA)\b",
               banned=("MUFU.RCP", "FCHK", "F2F", "I2F", "LDG")),
    "gathers": dict(kernels=("gather_probe_kernel", "gather_2d_kernel"),
                    reads=r"\b(LDS|LDG)\b",
                    banned=("IMAD.HI", "I2F", "F2I")),
}
# integer opcodes (the index arithmetic of a gather loop)
INT_OPS = ("IMAD", "IADD", "ISETP", "IABS", "IMNMX", "LOP", "SHF", "LEA",
           "SEL", "SGXT", "PRMT", "BMSK")


def _emit(**row):
    print(json.dumps(row), flush=True)


def _build(libs, out_dir, study):
    """{name: source} -> {name: ctypes library}, one nvcc each, all at
    once; each build's ptxas lines and SASS summary for the study's kernels
    are emitted."""
    nvcc = kernels._nvcc()
    procs = {}
    for name, src in libs.items():
        so = os.path.join(out_dir, f"{study}_{name}.so")
        procs[name] = so, subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-shared", "-Xptxas", "-v", "-o",
             so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    loaded = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-4000:]}")
        _emit(library=name, ptxas=_ptxas(log, STUDIES[study]["kernels"]))
        lib = ctypes.CDLL(so)
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rt_probe_sphere_mxu_launch.argtypes = [vp, vp, ci, vp, vp, cll,
                                                   ci, ci, vp, vp, vp]
        lib.rt_probe_gather_launch.argtypes = [vp, ci, ci, ci, vp, cll, vp]
        lib.rt_probe_gather_2d_launch.argtypes = [vp, ci, ci, vp, cll, vp]
        for fn in ("sphere_mxu", "gather", "gather_2d"):
            getattr(lib, f"rt_probe_{fn}_launch").restype = ci
        loaded[name] = lib
        _emit(library=name, sass=_sass(so, os.path.join(
            out_dir, f"{study}_{name}.sass"), study))
    return loaded


def _ptxas(log, names):
    """{kernel instantiation: 'registers, spills'} of the kernels named."""
    res, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
        elif fn and any(k in fn for k in names):
            if "bytes spill" in line:
                res[fn] = line.split(":", 1)[-1].strip()
            m = re.search(r"Used (\d+) registers", line)
            if m:
                res[fn] = f"{m.group(1)} registers; {res.get(fn, '')}"
    return res


def _sass(so, path, study):
    """The study's kernels' SASS (written to ``path``): for each, its
    instruction count and its inner loop's opcodes."""
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    txt = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                         text=True, check=True).stdout
    summary, listing = _inner_loops(txt, **STUDIES[study])
    with open(path, "w") as f:
        f.write("\n".join(listing))
    return summary


def _inner_loops(txt, kernels, reads, banned):
    """({kernel: summary}, [its listing]) of the named kernels in
    cuobjdump's ``txt``. The inner loop: of the backward branches around a
    ``reads`` instruction and no shared-memory store (not a staging loop),
    the largest of those that hold no other (an unrolled loop's remainder
    is a smaller sibling)."""
    ins_re = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
    summary, listing = {}, []
    for blk in re.split(r"\n\s*Function : ", txt)[1:]:
        name = blk.split("\n", 1)[0].strip()
        if not any(k in name for k in kernels):
            continue
        listing.append(f"Function : {blk}")
        ins = [(int(m.group(1), 16), m.group(2).strip())
               for m in ins_re.finditer(blk)]
        loops = []
        for addr, s in ins:
            m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", s)
            if m and int(m.group(1), 16) < addr:
                loops.append((int(m.group(1), 16), addr))
        at = [a for a, s in ins if re.search(reads, s)]
        stores = [a for a, s in ins if re.search(r"\bSTS\b", s)]
        around = [(lo, hi) for lo, hi in loops
                  if any(lo <= a <= hi for a in at)
                  and not any(lo <= a <= hi for a in stores)]
        inner = [(lo, hi) for lo, hi in around
                 if not any(lo <= a and b <= hi and (a, b) != (lo, hi)
                            for a, b in around)]
        lo, hi = max(inner, key=lambda r: r[1] - r[0], default=(0, -1))
        body = [s for a, s in ins if lo <= a <= hi]
        ops = collections.Counter(
            re.sub(r"^@!?U?P\w+\s+", "", s).split()[0] for s in body)
        n_reads = sum(n for op, n in ops.items()
                      if re.search(reads, op))
        n_int = sum(n for op, n in ops.items() if op.startswith(INT_OPS))
        summary[name] = dict(
            instructions=len(ins), loop=[hex(lo), hex(hi)],
            loop_instructions=len(body), reads=n_reads,
            fadd=ops.get("FADD", 0), int_ops=n_int,
            a_read=(dict(instructions=len(body) / n_reads,
                         fadd=ops.get("FADD", 0) / n_reads,
                         int_ops=n_int / n_reads) if n_reads else None),
            banned_in_loop={op: n for op, n in ops.items()
                            if op.startswith(banned)},
            loop_ops=dict(ops.most_common()))
    return summary, listing


# ------------------------------------------------------------------- P7
def _mxu_call(lib, cm, r2, o, d, tc, prods=None):
    out = torch.empty((o.shape[0], 1), dtype=torch.float32, device=o.device)
    err = lib.rt_probe_sphere_mxu_launch(
        cm.data_ptr(), r2.data_ptr(), cm.shape[1], o.data_ptr(), d.data_ptr(),
        o.shape[0], probes.REPS, int(tc), out.data_ptr(),
        None if prods is None else prods.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch error {kernels.error_string(err)}")
    return out


def p7(loaded):
    """P7's two kernels in every library: checks, then times in turns."""
    dev = torch.device("cuda")
    T = probes.FILL_TILES
    one = probes.mxu_inputs(0, probes.SPHERES, 1, dev)
    full = probes.mxu_inputs(0, probes.SPHERES, T, dev)
    edge = probes.mxu_edge_inputs(device=dev)
    want = {k: probes.sphere_mxu_plain(*x, probes.REPS)
            for k, x in (("one", one), ("edge", edge))}
    first_tc = {}
    for name, lib in loaded.items():
        f32 = {k: _mxu_call(lib, *x, False) for k, x in
               (("one", one), ("full", full), ("edge", edge))}
        tc = {k: _mxu_call(lib, *x, True) for k, x in
              (("one", one), ("full", full), ("edge", edge))}
        gates = {}
        for k, x in (("one", one), ("edge", edge)):
            R, S = x[2].shape[0], probes.SPHERES
            prods = torch.empty((2, R, S), dtype=torch.float32, device=dev)
            t_tc = _mxu_call(lib, *x, True, prods)
            gates[k] = probes.tf32_gate(*x, t_tc, prods, probes.REPS, want[k])
            gates[k]["t_equal_timed_call"] = bool(torch.equal(t_tc, tc[k]))
        first_tc = first_tc or tc
        _emit(library=name, check=dict(
            f32_one=bool(torch.equal(f32["one"], want["one"])),
            f32_every_tile=bool(torch.equal(
                f32["full"].reshape(T, -1),
                want["one"].reshape(1, -1).expand(T, -1))),
            f32_edge=bool(torch.equal(f32["edge"], want["edge"])),
            tf32_gate_one=gates["one"], tf32_gate_edge=gates["edge"],
            tf32_every_tile=bool(torch.equal(
                tc["full"].reshape(T, -1),
                tc["one"].reshape(1, -1).expand(T, -1))),
            tf32_t_equal_first_library={
                k: bool(torch.equal(tc[k], first_tc[k])) for k in tc}))
        del f32, tc
    names = list(loaded)
    for turn, order in enumerate((names, names[::-1])):
        for name in order:
            for tc in (False, True):
                ms = probes.time_ms(
                    lambda: _mxu_call(loaded[name], *full, tc), 3)
                _emit(library=name, variant="tf32" if tc else "f32",
                      turn=turn, ms=ms)


# ---------------------------------------------------------------- P3/P4
def _gather_variants():
    """(probe, space, stride) of the sweep's P3 and P4 variants."""
    return ([("P3", space, stride) for space in ("shared", "global")
             for stride in probes.GATHER_STRIDES]
            + [("P4", space, probes.GATHER_STRIDE)
               for space in ("shared", "global")])


def _gather_call(lib, probe, space, stride, reps, tiles, tab):
    out = torch.empty((tiles, probes.ROWS, probes.LANES),
                      dtype=torch.float32, device=tab.device)
    code, st = probes.SPACE_CODE[space], torch.cuda.current_stream().cuda_stream
    if probe == "P3":
        err = lib.rt_probe_gather_launch(tab.data_ptr(), stride, reps, code,
                                         out.data_ptr(), out.numel(), st)
    else:
        err = lib.rt_probe_gather_2d_launch(tab.data_ptr(), reps, code,
                                            out.data_ptr(), out.numel(), st)
    if err:
        raise RuntimeError(f"launch error {kernels.error_string(err)}")
    return out


def gathers(loaded):
    """P3's and P4's kernels in every library: checks at 1, FILL_TILES and
    UNEVEN_TILES tiles, then the timed shape in turns, with its floors."""
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    G, T = probes.GATHER_TIMING_REPS, probes.FILL_TILES
    tabs = {"P3": probes.gather_table(dev), "P4": probes.gather_2d_table(dev)}
    want = {}
    for probe, space, stride in _gather_variants():
        for reps in (1, G):
            if probe == "P3":
                want[probe, stride, reps] = probes.vmem_gather_plain(
                    tabs[probe], stride, reps)
            else:
                want[probe, stride, reps] = probes.vmem_gather_2d_plain(
                    tabs[probe], reps)
    for name, lib in loaded.items():
        checks = {}
        for probe, space, stride in _gather_variants():
            call = lambda reps, tiles: _gather_call(  # noqa: E731
                lib, probe, space, stride, reps, tiles, tabs[probe])
            ok = {"one": bool(torch.equal(call(1, 1)[0],
                                          want[probe, stride, 1]))}
            for tiles in (T,) + probes.UNEVEN_TILES:
                for reps in (1, G):
                    w = want[probe, stride, reps]
                    ok[f"{tiles}x{reps}"] = bool(torch.equal(
                        call(reps, tiles), w.expand(tiles, *w.shape)))
            checks[f"{probe} {space}/stride{stride}"] = ok
        _emit(library=name, check=checks,
              equal=all(all(v.values()) for v in checks.values()))
    names = list(loaded)
    for turn, order in enumerate((names, names[::-1])):
        for name in order:
            for probe, space, stride in _gather_variants():
                ms = probes.time_ms(lambda: _gather_call(
                    loaded[name], probe, space, stride, G, T, tabs[probe]), 3)
                variant = (f"{space}/stride{stride}" if probe == "P3"
                           else space)
                b_ms, b_by = probes.gather_bound(probe, variant, T, G, sms)
                _emit(library=name, probe=probe, variant=variant, turn=turn,
                      ms=ms, bound_ms=b_ms, bound_by=b_by,
                      smem_floor_ms=probes.smem_floor_ms(
                          probes.gather_wavefronts(probe, variant, T, G),
                          sms))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m rust_tracing_tpu_torch."
                                 "probe_study", description=__doc__.split(
                                     "\n\n")[0])
    ap.add_argument("study", nargs="?", default="p7", choices=list(STUDIES))
    ap.add_argument("--parent", help="a checkout of the parent commit")
    ap.add_argument("--out", default=os.path.join(HERE, "build",
                                                  "probe_study"),
                    help="where the libraries and SASS listings go")
    args = ap.parse_args(argv)
    probes.resolve_device(None)
    os.makedirs(args.out, exist_ok=True)
    libs = {}
    if args.parent:
        libs["parent"] = os.path.join(args.parent, "rust_tracing_tpu_torch",
                                      "csrc", "probe_kernel.cu")
    libs["change"] = os.path.join(HERE, "csrc", "probe_kernel.cu")
    _emit(card=card(), study=args.study, libraries=libs)
    loaded = _build(libs, args.out, args.study)
    (p7 if args.study == "p7" else gathers)(loaded)
    _emit(card=card())


if __name__ == "__main__":
    main()
