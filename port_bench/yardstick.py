"""The benchmark's own arithmetic: rates, percentiles, the device's busy
union, the roofline's operations and the card's peaks, and the check that a
profile holds every launch the program counted. The program under test
supplies only events, counts and kernel names; nothing here reads its code.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# NVIDIA H100 SXM5 (80 GB HBM3), the data sheet's numbers at 700 W: 132
# SMs of 128 float32 lanes at a 1980 MHz boost clock, 3.35 TB/s of HBM.
# The port's kernels are built with --fmad=false, so each multiply and each
# add is its own instruction: one float32 operation a lane slot, half the
# published 67 TFLOP/s that counts an FMA as two.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"sms": 132, "lanes": 128, "clock_hz": 1.98e9,
                              "bytes_per_s": 3.35e12},
}

# Operations of the fused render (the port's kernels' own accounting): a
# camera ray, a shaded scene query, one primitive test of a brute search.
OPS_CAMERA_RAY = 60
OPS_SHADED_BOUNCE = 120
OPS_PRIM_TEST = 25
# the fused render walks a tree from this many primitives on (the port's
# BVH_KERNEL_THRESHOLD when the benchmark was written); below it, it tests
# every primitive, and the brute count is the work the inputs need
BRUTE_MAX_PRIMS = 1024


def rate(total: float, seconds: float) -> float:
    """All the work of a window over all its seconds."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return total / seconds


def samples(units, n_pix: int) -> int:
    """Camera samples of frames or slices: pixels x samples per pixel."""
    return sum(n_pix * u.spp for u in units)


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_seconds(intervals: Iterable[Tuple[float, float]],
                  window: Tuple[float, float]) -> float:
    """Length of the union of (start, end) intervals clipped to
    ``window``, in the intervals' unit."""
    w0, w1 = window
    spans = sorted((max(a, w0), min(b, w1)) for a, b in intervals)
    total, cur0, cur1 = 0.0, None, None
    for a, b in spans:
        if b <= a:
            continue
        if cur1 is None or a > cur1:
            if cur1 is not None:
                total += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    if cur1 is not None:
        total += cur1 - cur0
    return total


def idle_pct(intervals: Iterable[Tuple[float, float]],
             window: Tuple[float, float]) -> float:
    """100 x the share of ``window`` that no interval covers."""
    w0, w1 = window
    return 100.0 * (1.0 - union_seconds(intervals, window) / (w1 - w0))


def idle_gaps(intervals: Iterable[Tuple[float, float]],
              window: Tuple[float, float]) -> List[Tuple[float, float]]:
    """The (start, end) stretches of ``window`` that no interval covers."""
    w0, w1 = window
    gaps, t = [], w0
    for a, b in sorted(intervals):
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    return gaps


def lane_ops_per_s(device_kind: str) -> float:
    p = PEAKS[device_kind]
    return p["sms"] * p["lanes"] * p["clock_hz"]


def brute_render_ops(camera_rays: int, rays: int, n_prims: int) -> int:
    """Operations a fused render needs: every camera ray made, every scene
    query shaded, and every query tested against every primitive."""
    return (camera_rays * OPS_CAMERA_RAY + rays * OPS_SHADED_BOUNCE
            + rays * n_prims * OPS_PRIM_TEST)


def roofline_pct(ops: float, n_bytes: float, seconds: float,
                 device_kind: str) -> Optional[float]:
    """100 x the least time (operations at one a lane slot, or bytes at the
    memory rate, whichever is longer) over the measured device time."""
    if seconds <= 0 or device_kind not in PEAKS:
        return None
    bound = max(ops / lane_ops_per_s(device_kind),
                n_bytes / PEAKS[device_kind]["bytes_per_s"])
    return 100.0 * bound / seconds


def kernel_name(name: str) -> str:
    """A device kernel's name without namespace, template arguments and
    parameters: ``void ns::k<float>(...)`` -> ``k``."""
    head = name.replace("(anonymous namespace)::", "").split("(")[0]
    return head.split("<")[0].split("::")[-1].strip().split(" ")[-1]


# each counter of the program's launch counts -> the device kernels one
# counted launch starts, by name
COUNTED_KERNELS = {
    "render_kernel": ("render_kernel",),
    "record_kernel": ("record_kernel",),
    "hit_kernel": ("hit_kernel",),
    "gather_kernel": ("gather_kernel",),
    "gather_cols_kernel": ("gather_cols_kernel",),
    "scatter_sum_kernel": ("scatter_sum_partial",),
    "scatter_match_kernel": ("scatter_match_partial",),
    "segment_sum_kernel": ("segment_sum_kernel",),
    "perlin_kernel": ("perlin_kernel",),
}

# every hand-written kernel of the port's csrc/ that a render or a
# gradient launches
HAND_KERNELS = frozenset((
    "render_kernel", "record_kernel", "hit_kernel", "gather_kernel",
    "gather_cols_kernel", "scatter_sum_partial", "scatter_sum_final",
    "scatter_match_partial", "scatter_match_final", "radix_hist_kernel",
    "radix_scan_kernel", "radix_scatter_kernel", "segment_sum_kernel",
    "segment_carry_kernel", "perlin_kernel", "perlin_backward_scale",
    "perlin_backward_kernel", "perlin_backward_final"))


def missing_launches(counted: Dict[str, int],
                     kernel_counts: Dict[str, int]) -> Dict[str, int]:
    """Launches the program counted that the profile lacks: by counter,
    how many of its kernels' events are missing (a complete profile gives
    an empty dict)."""
    out = {}
    for counter, n in counted.items():
        for k in COUNTED_KERNELS.get(counter, ()):
            short = n - kernel_counts.get(k, 0)
            if n and short > 0:
                out[k] = short
    return out
