"""Measurements behind P7's kernels (``csrc/probe_kernel.cu``,
``sphere_mxu_f32_kernel`` and ``sphere_mxu_tc_kernel``), on one GPU:

  python -m rust_tracing_tpu_torch.probe_study [--parent DIR] [--out DIR]

builds this checkout's probe_kernel.cu ("change") and DIR's ("parent"),
each alone into its own library (one nvcc each, both at once); for each
library prints the P7 kernels' registers and spills (ptxas) and a SASS
summary of each kernel's pair loop (the innermost loop that reads shared
memory or issues an mma, LDS or HMMA; its opcodes, and the division's,
conversions' and global reads' instructions in it),
writing the whole listing to DIR/p7_<name>.sass; checks every library on
the sweep's inputs at one tile and at 1024 tiles and on the edge tile (f32:
bit for bit the plain version; TF32: ``probes.tf32_gate``, and its t bit
for bit the first library's TF32 t); then times both variants of every
library in turns (the libraries in order, then in reverse) by
``probes.time_ms``. Prints JSON lines, the card's name and power limit
first and last. The other probes in turns: ``python -m
rust_tracing_tpu_torch.probes`` in each checkout."""

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
KERNELS = ("sphere_mxu_f32_kernel", "sphere_mxu_tc_kernel")
# SASS opcodes that must not be in a pair loop: the division (reciprocal and
# its range check), a tf32 conversion, a global read
BANNED = ("MUFU.RCP", "FCHK", "F2F", "I2F", "LDG")


def _emit(**row):
    print(json.dumps(row), flush=True)


def _build(libs, out_dir):
    """{name: source} -> {name: ctypes library}, one nvcc each, all at once;
    each build's ptxas lines for the P7 kernels are emitted."""
    nvcc = kernels._nvcc()
    procs = {}
    for name, src in libs.items():
        so = os.path.join(out_dir, f"p7_{name}.so")
        procs[name] = so, subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-shared", "-Xptxas", "-v",
             "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    loaded = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-4000:]}")
        _emit(library=name, ptxas=_ptxas(log))
        lib = ctypes.CDLL(so)
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rt_probe_sphere_mxu_launch.argtypes = [vp, vp, ci, vp, vp, cll,
                                                   ci, ci, vp, vp, vp]
        lib.rt_probe_sphere_mxu_launch.restype = ci
        loaded[name] = lib
        _emit(library=name, sass=_sass(so, os.path.join(
            out_dir, f"p7_{name}.sass")))
    return loaded


def _ptxas(log):
    """{kernel instantiation: 'registers, spills'} of the P7 kernels."""
    res, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
        elif fn and any(k in fn for k in KERNELS):
            if "bytes spill" in line:
                res[fn] = line.split(":", 1)[-1].strip()
            m = re.search(r"Used (\d+) registers", line)
            if m:
                res[fn] = f"{m.group(1)} registers; {res.get(fn, '')}"
    return res


def _sass(so, path):
    """The P7 kernels' SASS (written to ``path``): for each, its
    instruction count and its pair loop's opcodes and banned ones."""
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    txt = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                         text=True, check=True).stdout
    summary, listing = _pair_loops(txt)
    with open(path, "w") as f:
        f.write("\n".join(listing))
    return summary


def _pair_loops(txt):
    """({kernel: summary}, [its listing]) of the P7 kernels in cuobjdump's
    ``txt``."""
    ins_re = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
    summary, listing = {}, []
    for blk in re.split(r"\n\s*Function : ", txt)[1:]:
        name = blk.split("\n", 1)[0].strip()
        if not any(k in name for k in KERNELS):
            continue
        listing.append(f"Function : {blk}")
        ins = [(int(m.group(1), 16), m.group(2).strip())
               for m in ins_re.finditer(blk)]
        loops = []
        for addr, s in ins:
            m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", s)
            if m and int(m.group(1), 16) < addr:
                loops.append((int(m.group(1), 16), addr))
        # the pair loop: of the backward branches around a shared read or
        # an mma (the threshold's loops have neither, the staging loop only
        # writes shared memory), the largest of those that hold no other
        # (an unrolled loop's remainder is a smaller sibling)
        reads = [a for a, s in ins if re.search(r"\b(LDS|HMMA)\b", s)]
        around = [(lo, hi) for lo, hi in loops
                  if any(lo <= a <= hi for a in reads)]
        inner = [(lo, hi) for lo, hi in around
                 if not any(lo <= a and b <= hi and (a, b) != (lo, hi)
                            for a, b in around)]
        lo, hi = max(inner, key=lambda r: r[1] - r[0], default=(0, -1))
        body = [s for a, s in ins if lo <= a <= hi]
        ops = collections.Counter(
            re.sub(r"^@!?U?P\w+\s+", "", s).split()[0] for s in body)
        summary[name] = dict(
            instructions=len(ins), loop=[hex(lo), hex(hi)],
            loop_instructions=len(body),
            banned_in_loop={op: n for op, n in ops.items()
                            if op.startswith(BANNED)},
            loop_ops=dict(ops.most_common()))
    return summary, listing


def _call(lib, cm, r2, o, d, tc, prods=None):
    out = torch.empty((o.shape[0], 1), dtype=torch.float32, device=o.device)
    err = lib.rt_probe_sphere_mxu_launch(
        cm.data_ptr(), r2.data_ptr(), cm.shape[1], o.data_ptr(), d.data_ptr(),
        o.shape[0], probes.REPS, int(tc), out.data_ptr(),
        None if prods is None else prods.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch error {kernels.error_string(err)}")
    return out


def p7(args):
    """See the module's docstring."""
    os.makedirs(args.out, exist_ok=True)
    libs = {}
    if args.parent:
        libs["parent"] = os.path.join(args.parent, "rust_tracing_tpu_torch",
                                      "csrc", "probe_kernel.cu")
    libs["change"] = os.path.join(HERE, "csrc", "probe_kernel.cu")
    _emit(card=card(), libraries=libs)
    loaded = _build(libs, args.out)
    dev = torch.device("cuda")
    T = probes.FILL_TILES
    one = probes.mxu_inputs(0, probes.SPHERES, 1, dev)
    full = probes.mxu_inputs(0, probes.SPHERES, T, dev)
    edge = probes.mxu_edge_inputs(device=dev)
    want = {k: probes.sphere_mxu_plain(*x, probes.REPS)
            for k, x in (("one", one), ("edge", edge))}
    first_tc = {}
    for name, lib in loaded.items():
        f32 = {k: _call(lib, *x, False) for k, x in
               (("one", one), ("full", full), ("edge", edge))}
        tc = {k: _call(lib, *x, True) for k, x in
              (("one", one), ("full", full), ("edge", edge))}
        gates = {}
        for k, x in (("one", one), ("edge", edge)):
            R, S = x[2].shape[0], probes.SPHERES
            prods = torch.empty((2, R, S), dtype=torch.float32, device=dev)
            t_tc = _call(lib, *x, True, prods)
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
                    lambda: _call(loaded[name], *full, tc), 3)
                _emit(library=name, variant="tf32" if tc else "f32",
                      turn=turn, ms=ms)
    _emit(card=card())


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m rust_tracing_tpu_torch."
                                 "probe_study", description=__doc__.split(
                                     "\n\n")[0])
    ap.add_argument("--parent", help="a checkout of the parent commit")
    ap.add_argument("--out", default=os.path.join(HERE, "build", "p7_study"),
                    help="where the libraries and SASS listings go")
    args = ap.parse_args(argv)
    probes.resolve_device(None)
    p7(args)


if __name__ == "__main__":
    main()
