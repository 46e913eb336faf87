"""A cell's files, found by the names in BENCHMARK.json: its workload
entry, its configuration (`configs/<config>.json`), its traffic mix
(`traffic/<traffic>.json`), its limits (`limits/<cell>.json`), and the
per-layer metrics it reports."""

from __future__ import annotations

import dataclasses
import json
import pathlib

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict       # the configuration file
    mix: dict          # the traffic mix file
    limits: dict       # the correctness limits: {number: limit}
    end_to_end: list   # the BENCHMARK.json entries this cell reports
    per_layer: list

    @property
    def features(self) -> bool:
        return self.config["fuser"]["matcher"]["use_feat"]


def _load(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json; raises KeyError for a
    cell that is not there."""
    spec = _load(root / "BENCHMARK.json")
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    configs = {c["name"]: c for c in spec["configs"]}
    return Cell(
        name=name, chips=w["chips"],
        config=_load(root / configs[w["config"]]["file"]),
        mix=_load(BENCH / "traffic" / f"{w['traffic']}.json"),
        limits=_load(BENCH / "limits" / f"{name}.json"),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)])
