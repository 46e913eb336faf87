"""The harness's arithmetic: the 95th percentile over every chunk, the
device's busy time as a union of overlapping intervals, the idle gaps
and their attribution to host operations."""

import pytest

from port_bench.harness import main, trace


def test_p95_is_taken_over_all_values():
    # 200 chunks: the 190th smallest is the 95th percentile, so ten slow
    # chunks among the 200 set it.
    lat = [0.05] * 189 + [0.06] + [1.0] * 10
    assert main.p95(lat) == 0.06
    assert main.p95(lat + [1.0]) == 1.0
    assert main.p95([0.2]) == 0.2


def test_busy_time_is_a_union_not_a_sum():
    iv = [(0.0, 1.0), (0.5, 1.5), (0.6, 0.7), (2.0, 3.0), (2.5, 2.6)]
    assert trace.union_s(iv) == pytest.approx(2.5)
    assert sum(e - s for s, e in iv) > 2.5


def test_idle_gaps_cover_the_window_outside_the_intervals():
    iv = [(1.0, 2.0), (1.5, 3.0), (5.0, 6.0)]
    assert trace.idle_gaps(iv, 0.0, 7.0) == [(0.0, 1.0), (3.0, 5.0),
                                            (6.0, 7.0)]
    assert trace.idle_gaps([(0.0, 7.0)], 0.0, 7.0) == []


def test_gaps_are_named_by_the_innermost_host_operation():
    host = [("outer", 0.0, 10.0), ("inner", 2.0, 4.0), ("other", 6.0, 6.5)]
    got = trace._attribute([(2.5, 3.5), (4.5, 5.5), (11.0, 12.0)], host)
    assert got == [("inner", 1.0), ("outer", 1.0),
                   ("host outside torch ops", 1.0)]


def test_jax_names_are_compared_whole(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "ndt_feature_graph_tpu_torch_probe",
                        types.ModuleType("x"))
    assert main.jax_modules() == []
    monkeypatch.setitem(sys.modules, "ndt_feature_graph_tpu.core",
                        types.ModuleType("y"))
    assert main.jax_modules() == ["ndt_feature_graph_tpu"]
