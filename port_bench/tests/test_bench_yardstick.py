"""The benchmark's arithmetic on synthetic events and hand-counted work."""

import math
import types

import pytest

from port_bench import yardstick as Y


def test_rate_is_all_work_over_all_time():
    assert Y.rate(600, 2.0) == 300.0
    with pytest.raises(ValueError):
        Y.rate(1, 0.0)


@pytest.mark.parametrize("q, want", [(0, 1.0), (50, 50.5), (95, 95.05),
                                     (100, 100.0)])
def test_percentile_interpolates_like_numpy(q, want):
    xs = [float(i) for i in range(100, 0, -1)]
    assert Y.percentile(xs, q) == pytest.approx(want)


def test_union_merges_overlaps_and_clips_to_the_window():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7), (9.0, 12.0)]
    assert Y.union_seconds(iv, (1.0, 10.0)) == pytest.approx(2 + 1 + 1)
    assert Y.union_seconds([], (0.0, 1.0)) == 0.0


def test_samples_and_idle_share_hand_counted():
    units = [types.SimpleNamespace(spp=4), types.SimpleNamespace(spp=64)]
    assert Y.samples(units, 100) == 6800
    # busy 2..5 and 4..6 of the window 0..10: 4 s of 10 busy
    assert Y.idle_pct([(2.0, 5.0), (4.0, 6.0)], (0.0, 10.0)) == \
        pytest.approx(60.0)


def test_idle_gaps_are_the_window_minus_the_union():
    iv = [(1.0, 2.0), (1.5, 3.0), (5.0, 6.0)]
    gaps = Y.idle_gaps(iv, (0.0, 8.0))
    assert gaps == [(0.0, 1.0), (3.0, 5.0), (6.0, 8.0)]
    busy = Y.union_seconds(iv, (0.0, 8.0))
    assert busy + sum(b - a for a, b in gaps) == pytest.approx(8.0)


def test_brute_render_ops_hand_counted():
    # 2x2 pixels, 3 samples: 12 camera rays; 30 queries against 18 quads
    ops = Y.brute_render_ops(camera_rays=12, rays=30, n_prims=18)
    assert ops == 12 * 60 + 30 * 120 + 30 * 18 * 25


def test_roofline_takes_the_larger_bound():
    kind = "NVIDIA H100 80GB HBM3"
    lane = 132 * 128 * 1.98e9
    # operations bound: 1 s of lane slots measured in 4 s
    assert Y.roofline_pct(lane, 0, 4.0, kind) == pytest.approx(25.0)
    # bytes bound: 3.35e12 bytes is one second
    assert Y.roofline_pct(1.0, 3.35e12, 2.0, kind) == pytest.approx(50.0)
    assert Y.roofline_pct(1.0, 1.0, 1.0, "cpu") is None


@pytest.mark.parametrize("name, short", [
    ("void record_kernel<false, true>(SceneTables, RenderParams)",
     "record_kernel"),
    ("void (anonymous namespace)::scatter_sum_partial<float, 4>(float const*)",
     "scatter_sum_partial"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<float>>(int, at::native::FillFunctor<float>)",
     "vectorized_elementwise_kernel"),
])
def test_kernel_name(name, short):
    assert Y.kernel_name(name) == short


def test_missing_launches_reads_a_complete_profile_as_complete():
    counted = {"record_kernel": 9, "scatter_sum_kernel": 3, "hit_kernel": 0}
    full = {"record_kernel": 9, "scatter_sum_partial": 3,
            "scatter_sum_final": 3}
    assert Y.missing_launches(counted, full) == {}
    short = dict(full, record_kernel=7)
    assert Y.missing_launches(counted, short) == {"record_kernel": 2}


def test_peaks_table_is_the_data_sheet():
    p = Y.PEAKS["NVIDIA H100 80GB HBM3"]
    assert p["sms"] * p["lanes"] * p["clock_hz"] * 2 == pytest.approx(
        66.9e12, rel=1e-3)
    assert not math.isnan(p["bytes_per_s"])
