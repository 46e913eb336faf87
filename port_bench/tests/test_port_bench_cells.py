"""The benchmark's files: every configuration and cell loads by name,
each configuration file is the preset it names, and BENCHMARK.json keeps
to the shape the harness reads."""

import dataclasses
import json

import pytest

from port_bench.harness import cell as cell_mod
from port_bench.harness import check

SPEC = json.loads((cell_mod.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    c = cell_mod.load(name)
    assert c.name == name and c.chips == 1
    assert c.mix["loop_steps"] % c.mix["chunk_steps"] == 0
    e2e = {m["name"] for m in c.end_to_end}
    assert e2e >= {"scans_per_s", "latency_ms_p95", "peak_mem_gib",
                   "setup_s"}
    # Any other is one of them under a bound of its own: `<metric>.<tag>`.
    assert {m.split(".")[0] for m in e2e} == {
        "scans_per_s", "latency_ms_p95", "peak_mem_gib", "setup_s"}
    assert c.limits and set(c.limits) <= set(check.NUMBERS)
    names = {m["name"] for m in c.per_layer}
    assert ("features_us_per_step" in names) == c.features
    for m in c.per_layer:
        assert (cell_mod.BENCH / "metrics" / f"{m['name']}.py").exists()


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cell_mod.load("no_such_cell")


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_configuration_is_its_preset(entry):
    from ndt_feature_graph_tpu_torch.models import presets

    cfg = json.loads((cell_mod.ROOT / entry["file"]).read_text())
    feat = entry["name"] == "fleet_feature_slam"
    assert cfg["fuser"] == dataclasses.asdict(
        presets.fleet_serving(features=feat))
    assert cfg["fuser"]["matcher"]["use_feat"] == feat


def test_every_config_and_traffic_is_used():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        assert (cell_mod.BENCH / "traffic" / f"{w['traffic']}.json").exists()
