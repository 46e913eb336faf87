"""The control: the plain reference put in the program's place with its
map (statistics, occupancy and the table made from them) held in
bfloat16, the nearest precision below the float32 (TF32 off) the
configurations state that changes this arithmetic, has to come out not
correct (calibrate.Control).  On the card, at a size a test run holds
(the cell's own size is run by `python3 port_bench/calibrate.py`,
PERF.md gives its readings)."""

import importlib.util
import time

import pytest

from port_bench.harness import cell as cell_mod
from port_bench.harness import main

spec = importlib.util.spec_from_file_location(
    "port_bench_calibrate", cell_mod.BENCH / "calibrate.py")
calibrate = importlib.util.module_from_spec(spec)
spec.loader.exec_module(calibrate)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["feat_fleet_b512_chunk4",
                                  "ndt_fleet_b512_chunk4"])
@pytest.mark.parametrize("seed", [2 ** 31 + 21, 2 ** 31 + 22, 2 ** 31 + 23])
def test_the_control_is_not_correct(card, name, seed):
    c = cell_mod.load(name)
    c.mix = dict(c.mix, robots=64)
    out = main.execute(c, seed, 2.0, False, time.perf_counter(), card,
                       server_cls=calibrate.Control)
    assert not out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["feat_fleet_b512_chunk4",
                                  "ndt_fleet_b512_chunk4"])
def test_the_program_is_correct(card, name):
    c = cell_mod.load(name)
    c.mix = dict(c.mix, robots=64)
    out = main.execute(c, 2 ** 31 + 24, 2.0, False, time.perf_counter(),
                       card)
    assert out["correct"], out["checks"]
