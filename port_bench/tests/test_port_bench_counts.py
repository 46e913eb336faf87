"""The byte counts of the kernels' rooflines against PERF.md's section
6: segment_add_rows 2.27 MB for one scan and 145.0 MB for a B = 64 fleet
step, occupancy_update 0.326 MB and 20.9 MB."""

import pytest

from port_bench.harness import trace


@pytest.mark.parametrize("kernel, one_scan, b64", [
    ("segment_add_rows", (720, 40_000, 7), (46_080, 2_560_000, 7)),
    ("occupancy_update", (720, 40_000, 1), (46_080, 2_560_000, 64)),
])
def test_call_bytes_match_the_recorded_counts(kernel, one_scan, b64):
    # MB as recorded, each within half a unit of its last digit.
    want = {"segment_add_rows": ((2.27, 0.005), (145.0, 0.05)),
            "occupancy_update": ((0.326, 0.0005), (20.9, 0.05))}[kernel]
    c = trace.count(kernel)
    for shape, (mb, half) in zip((one_scan, b64), want):
        assert abs(c.call_bytes(*shape) / 1e6 - mb) <= half


def test_a_fleet_step_counts_its_calls():
    fuser = {"ndt": {"resolution": 0.5, "size_x": 100.0, "size_y": 100.0,
                     "sensor_range": 30.0, "max_points_per_scan": 720}}
    seg = trace.count("segment_add_rows")
    occ = trace.count("occupancy_update")
    # The local map is 126 x 126 cells (2 x (30 + 1.5) m at 0.5 m).
    assert seg.step_bytes(fuser, 64) == (
        seg.call_bytes(46_080, 64 * 126 * 126, 7)
        + seg.call_bytes(46_080, 2_560_000, 7))
    assert occ.step_bytes(fuser, 64) == occ.call_bytes(46_080, 2_560_000, 64)
