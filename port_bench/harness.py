"""One run of one cell: set-up, warm-up, the measured (or traced) window,
the comparison with the reference, and the result line.

Everything is found by name (``lookup``): the cell in ``BENCHMARK.json``,
its configuration's file, its mix and the mix's kind, its reference scene,
its limits, and a reader ``metrics/<metric>.py`` for each metric, end to
end and per layer. A reader is a module with ``read(ctx) -> float | None``;
``ctx`` is the ``Context`` below. None means the reader found nothing to
read, and the metric is left out of the line.

The traced run (``--trace 1``) profiles the card's activity alone (no
host operators: recording each of a gradient step's ~1e5 host operators
would double the step and read as idle device time), and keeps its host
spans itself on the clock of the profiler's events. Before the traced
units it runs as many untraced, and reports both times (``trace_cost``).
"""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from . import check, driver, lookup, yardstick
from .driver import SPAN_PREFIX

FORBIDDEN = ("jax", "jaxlib", "flax", "rust_tracing_tpu")
PROFILE_TRIES = 3
PROFILE_SETTLE_S = 0.05


def load_reader(base: str, name: str):
    return lookup.module(base, "metrics", name).read


def end_to_end_of(cell: lookup.Cell) -> List[Dict]:
    return [m for m in cell.spec["end_to_end"]
            if "workloads" not in m or cell.name in m["workloads"]]


def per_layer_of(cell: lookup.Cell) -> List[Dict]:
    reported = {m["name"] for m in end_to_end_of(cell)}
    return [m for m in cell.spec["per_layer"]
            if (cell.name in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


@dataclasses.dataclass
class Context:
    """What a metric reader reads."""

    cell: lookup.Cell
    units: List                # the window's units (driver.Unit)
    window_s: float            # the window on the host clock
    setup_s: float
    peak_bytes: int            # device memory peak inside the window
    device_kind: str
    n_pix: int
    # the traced run only: device intervals, host spans, window
    device_events: Optional[List] = None   # (name, start_s, end_s)
    spans: Optional[List] = None           # (name, start_s, end_s)
    trace_window: Optional[tuple] = None   # (start_s, end_s)


def _device_kind(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _device_events(prof):
    """The profile's device intervals (kernels, copies, fills), in seconds
    of Unix time."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            s = e.start_ns() * 1e-9
            out.append((e.name(), s, s + e.duration_ns() * 1e-9))
    return out


def traced_window(drv, n_units: int, launches: Dict[str, int]):
    """``n_units`` units untraced, timed, then ``n_units`` more under
    torch.profiler. A profile that lacks a launch the program counted is
    taken again after a longer settle, up to PROFILE_TRIES times. Returns
    (traced units, device events, spans, window, trace cost)."""
    t0 = time.perf_counter()
    plain = [drv.unit(k) for k in range(n_units)]
    drv.sync()
    plain_s = time.perf_counter() - t0
    k0 = len(plain)
    acts = ([ProfilerActivity.CUDA] if drv.dev.type == "cuda"
            else [ProfilerActivity.CPU])
    for attempt in range(PROFILE_TRIES):
        before = dict(launches)
        drv.spans = []
        with profile(activities=acts) as prof:
            time.sleep(PROFILE_SETTLE_S * 10 ** attempt)
            w0 = time.time_ns()
            units = [drv.unit(k0 + k) for k in range(n_units)]
            drv.sync()
            w1 = time.time_ns()
        k0 += n_units
        spans, drv.spans = drv.spans, None
        win = (w0 * 1e-9, w1 * 1e-9)
        counted = {k: v - before.get(k, 0) for k, v in launches.items()}
        dev_events = _device_events(prof)
        counts: Dict[str, int] = {}
        for name, _, _ in dev_events:
            k = yardstick.kernel_name(name)
            counts[k] = counts.get(k, 0) + 1
        missing = yardstick.missing_launches(counted, counts)
        if not missing or drv.dev.type != "cuda":
            break
        print(f"profile lacks launches {missing}; taking it again",
              file=sys.stderr)
    cost = {"traced_s": win[1] - win[0], "untraced_s": plain_s,
            "units": n_units}
    return units, dev_events, spans, win, cost


def breakdown(ctx: Context) -> Dict:
    """The ten device operations that took most time and the ten host spans
    that the device waited longest under."""
    by_op: Dict[str, float] = {}
    for name, s, e in ctx.device_events:
        k = (name.split(" (")[0] if name.startswith(("Memcpy", "Memset"))
             else yardstick.kernel_name(name) or name)
        by_op[k] = by_op.get(k, 0.0) + (e - s)
    gaps = yardstick.idle_gaps([(s, e) for _, s, e in ctx.device_events],
                               ctx.trace_window)
    inner = sorted((e - s, n, s, e) for n, s, e in ctx.spans)
    by_span: Dict[str, float] = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        name = next((n for _, n, s, e in inner if s <= mid <= e),
                    SPAN_PREFIX + "between_calls")
        by_span[name] = by_span.get(name, 0.0) + (g1 - g0)
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_op), "idle_gaps": top(by_span)}


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, t0: float, device=None,
             overrides: Optional[Dict] = None, program=None):
    """One run. Returns (result line as a dict, the check's lines).
    ``overrides`` ({"cfg": {...}, "mix": {...}}) and ``program`` (a
    replacement of ``driver.program()``'s modules) serve the harness's own
    tests at small sizes on the CPU."""
    cell = lookup.find_cell(root, workload)
    for part in ("cfg", "mix"):
        getattr(cell, part).update((overrides or {}).get(part, {}))
    dev = torch.device(device or "cuda")
    prog = program or driver.program()
    rng = np.random.default_rng([seed, 1])
    drv = driver.Driver(cell, dev, seed, prog)
    launches = prog["kernels"].LAUNCHES
    drv.unit(0)  # warm-up: this cell's shapes, every kernel built
    drv.sync()
    peak_setup = _peak(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t0
    ctx_extra, extra, lines = {}, {}, []
    if trace:
        units, dev_events, spans, win, cost = traced_window(
            drv, int(cell.mix["trace"]["units"]), launches)
        window_s = win[1] - win[0]
        ctx_extra = dict(device_events=dev_events, spans=spans,
                         trace_window=win)
        extra["trace_cost"] = cost
        lines.append(f"traced {cost['units']} units in "
                     f"{cost['traced_s']:.4f} s, untraced "
                     f"{cost['untraced_s']:.4f} s")
        if dev_events:
            lines.append(
                "device ops from {:.4f} s after the window's start to "
                "{:.4f} s before its end".format(
                    min(s for _, s, _ in dev_events) - win[0],
                    win[1] - max(e for _, _, e in dev_events)))
    else:
        units = drv.window(seconds)
        window_s = drv.window_s
    drv.sync()
    peak_window = _peak(dev)
    ctx = Context(cell=cell, units=units, window_s=window_s,
                  setup_s=setup_s, peak_bytes=peak_window,
                  device_kind=_device_kind(dev), n_pix=drv.n_pix,
                  **ctx_extra)

    metrics: Dict[str, Dict] = {}
    wanted = per_layer_of(cell) if trace else end_to_end_of(cell)
    for m in wanted:
        value = load_reader(cell.base, m["name"])(ctx)
        if value is None and not trace:
            raise SystemExit(f"end-to-end metric {m['name']} read nothing")
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_line = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": ctx.device_kind,
                   "count": int(cell.entry["chips"]),
                   "memory_peak_bytes": max(peak_setup, peak_window)}
    if trace:
        busy = yardstick.union_seconds(
            [(s, e) for _, s, e in ctx.device_events], ctx.trace_window)
        device_line.update(busy_s=busy, window_s=window_s)
        extra["breakdown"] = breakdown(ctx)

    # the comparison, after the window, with the program's state freed
    n_pix = drv.n_pix
    del drv, ctx
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checked = check.pick(units, int(cell.mix["check"]["units"]), rng)
    t_check = time.perf_counter()
    values = check.numbers(cell, checked, n_pix, dev)
    correct = check.verdict(values, cell.limits)
    secs = sorted(u.seconds for u in units)
    lines += [f"unit seconds min {secs[0]:.4f} median "
              f"{secs[len(secs) // 2]:.4f} max {secs[-1]:.4f} over "
              f"{len(units)}; first {units[0].seconds:.4f} last "
              f"{units[-1].seconds:.4f}",
              f"reference took {time.perf_counter() - t_check:.3f} s for "
              f"{len(checked)} of {len(units)} units"]
    lines += [f"check {k} {float(values[k])!r} limit {cell.limits[k]!r}"
              for k in cell.limits]
    result = {"correct": correct, "attempted": len(units),
              "failed": 0 if correct else len(checked),
              "metrics": metrics, "device": device_line, **extra,
              "checks": {k: {"value": values[k], "limit": cell.limits[k]}
                         for k in cell.limits}}
    return result, lines


def _peak(dev) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" \
        else 0


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def json_safe(x):
    """Non-finite floats as strings, so the line stays JSON."""
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    if isinstance(x, dict):
        return {k: json_safe(v) for k, v in x.items()}
    if isinstance(x, list):
        return [json_safe(v) for v in x]
    return x
