"""Readings for a cell's correctness limits, on the card:

    python3 port_bench/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 --stale-seeds 3 --seconds 5

runs the program on `--seeds` seeds, then the control on
`--control-seeds` more and the program with its gather table's refresh
left out (`Stale`) on `--stale-seeds` more, in one process, each a whole
run of the cell at its own size (its traffic, its window, its check),
and prints one JSON line a run with every number the check computes,
none judged.  A limit lies above the largest reading of the program and
below the smallest of the control, or for `table_gap`, which the
control's table, built from its own map, cannot fail, of the stale
table (PERF.md gives the readings).

The control is the plain reference put in the program's place with the
state a step carries, its map (statistics and occupancy, and the table
made from them), held in bfloat16: the configurations state float32
with TF32 off, and the nearest precision below that changes this
arithmetic (TF32 matmuls change nothing here: the only matmuls are the
K = 2 point transforms, which cuBLAS runs outside the tensor cores).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from port_bench.harness import cell as cell_mod  # noqa: E402
from port_bench.harness import main, serve  # noqa: E402
from port_bench.harness.check import NUMBERS, reference_params  # noqa: E402
from port_bench.reference import d2d  # noqa: E402
from port_bench.reference import fuser as ref  # noqa: E402


class Control(serve.Server):
    """The reference in the program's place: every robot's first state
    and steps from port_bench/reference, its map held in bfloat16."""

    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        self.rp = reference_params(cell.config)

    def _lower(self, st):
        g = st.grid
        grid = dataclasses.replace(g, **{
            f: getattr(g, f).to(torch.bfloat16).to(torch.float32)
            for f in ("count", "psum", "outer", "occ")})
        return dataclasses.replace(
            st, grid=grid, packed=d2d.packed_from_grid(grid, self.rp.ndt))

    def initial_states(self):
        f = self.fleet
        return self._lower(ref.initialize(
            self.rp, f.init_pose, torch.zeros_like(f.init_pose),
            f.init_ranges, f.init_hit))

    def chunk(self, states, c):
        s0 = (c * self.k) % self.loop
        traj, scores = [], []
        with torch.no_grad():
            for t in range(self.k):
                x = [v[:, s0 + t] for v in self.inputs]
                kw = (dict(ranges=x[1], hit=x[2], u=x[3]) if self.cell.features
                      else dict(pts=x[1], mask=x[2]))
                states, pose, score, _ = ref.step(self.rp, states, x[0], **kw)
                states = self._lower(states)
                traj.append(pose)
                scores.append(score)
        return states, torch.stack(traj, 1), torch.stack(scores, 1)


class Stale(serve.Server):
    """The program with its gather table's refresh left out: each chunk
    returns the table it was given."""

    def chunk(self, states, c):
        new, traj, scores = super().chunk(states, c)
        if hasattr(new, "base"):
            new = dataclasses.replace(new, base=dataclasses.replace(
                new.base, packed=states.base.packed))
        else:
            new = dataclasses.replace(new, packed=states.packed)
        return new, traj, scores


def readings(cell, seeds, seconds, server_cls, device):
    """One run a seed: (seed, {number: value}) each."""
    for seed in seeds:
        out = main.execute(cell, seed, seconds, False, time.perf_counter(),
                           device, server_cls=server_cls)
        yield seed, {n: c["value"] for n, c in out["checks"].items()}


def main_(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--stale-seeds", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--first-seed", type=int, default=2 ** 31 + 101)
    args = ap.parse_args(argv)
    cell = cell_mod.load(args.workload)
    cell.limits = {n: math.inf for n in NUMBERS}
    device = torch.device("cuda")
    i = 0
    for side, cls, n in (("program", serve.Server, args.seeds),
                         ("control", Control, args.control_seeds),
                         ("stale", Stale, args.stale_seeds)):
        ss = [args.first_seed + 7919 * j for j in range(i, i + n)]
        i += n
        for seed, vals in readings(cell, ss, args.seconds, cls, device):
            print(json.dumps({"side": side, "seed": seed, **vals}),
                  flush=True)


if __name__ == "__main__":
    main_()
