"""The comparison that decides `correct`: the plain reference
(port_bench/reference) replays the checked chunks of the sampled robots
on the same inputs and judges what the timed path served.

The reference cannot run a robot's whole patrol in a run's time, so it
follows the program from the program's own state: every checked chunk
of the window starts from the copy of the sampled robots' state taken
before the program served it, and each step takes the served pose into
the reference's state and map (the registration's stop is chaotic: a
rounding moves it by a step, PERF.md).  From that copy the reference
takes the poses and the map's statistics and occupancy only: it builds
the gather table again from the statistics, and the previous scan's
features again from the previous scan.  The start is checked by itself:
the reference builds its own first states from scan 0 and replays the
first chunk from them.

Numbers, each the widest over the checked robots and steps:
  pose_gap_m       distance between a served position and the one the
                   reference's own registration gives from the same state
  heading_gap_rad  difference between their headings
  objective_gap    the reference's joint objective at the served pose less
                   its value at its own pose (score units)
  score_gap        |served score - the reference's objective at the served
                   pose| / |that objective| (steps that fell back to the
                   odometry prediction left out: their score is of a pose
                   not served)
  map_stats_gap    the map statistics (point counts, point sums, outer
                   products) against the reference's, relative L1 a robot,
                   in the first states and after every checked chunk
  occupancy_gap    the log-odds occupancy, likewise
  table_gap        the program's gather table against the table the
                   reference builds from the program's own statistics,
                   relative L1 a row, in the first states and after every
                   checked chunk
A cell's limits file names the numbers it is judged by.
"""

from __future__ import annotations

import math

import torch

from port_bench.harness.serve import tree_map
from port_bench.reference import d2d, features
from port_bench.reference import fuser as ref
from port_bench.reference.config import (
    FeatureParams, FuserParams, MatcherParams, MotionParams, NDTMapParams)
from port_bench.reference.ndt_map import NDTGrid

ANSWERS = ("pose_gap_m", "heading_gap_rad", "objective_gap", "score_gap")
NUMBERS = ANSWERS + ("map_stats_gap", "occupancy_gap", "table_gap")


def reference_params(config: dict) -> FuserParams:
    f = dict(config["fuser"])
    return FuserParams(
        ndt=NDTMapParams(**f.pop("ndt")),
        matcher=MatcherParams(**f.pop("matcher")),
        features=FeatureParams(**f.pop("features")),
        motion=MotionParams(**f.pop("motion")), **f)


def reference_state(p: FuserParams, st, prev) -> ref.State:
    """The reference's State at a copy of a program state (a FuserState,
    a FeatureFuserState around one, or the control's reference State):
    its poses and its map's statistics and occupancy, the gather table
    built again from them, and with the feature term the features of
    the previous scan `prev` (ranges, hit) computed again."""
    base = getattr(st, "base", st)
    g = base.grid
    grid = NDTGrid(origin=g.origin, count=g.count, psum=g.psum,
                   outer=g.outer, occ=g.occ)
    out = ref.State(
        Tnow=base.Tnow, Todom=base.Todom, Tlast_fuse=base.Tlast_fuse,
        sensor_pose=base.sensor_pose, grid=grid,
        packed=d2d.packed_from_grid(grid, p.ndt))
    if p.matcher.use_feat:
        out.prev_feats = features._detect_plain(p.features, *prev)
        out.prev_desc = features._describe_plain(p.features, out.prev_feats,
                                                 *prev)
    return out


class Inputs:
    """The sampled robots' inputs, as the program got them."""

    def __init__(self, server):
        idx = server.sample_idx
        self.k, self.loop = server.k, server.loop
        self.features = server.cell.features
        self.steps = tuple(x.index_select(0, idx) for x in server.inputs)
        f = server.fleet
        self.init = (f.init_pose.index_select(0, idx),
                     f.init_ranges.index_select(0, idx),
                     f.init_hit.index_select(0, idx))

    def prev(self, c: int):
        """The scan before chunk c's first step (ranges, hit), or None
        without the feature term: scan 0 before the patrol's first step,
        which the loop's last step repeats."""
        if not self.features:
            return None
        s = ((c * self.k) - 1) % self.loop
        return self.steps[1][:, s], self.steps[2][:, s]

    def step(self, c: int, t: int):
        """Keyword arguments of reference step t of chunk c."""
        s = (c * self.k) % self.loop + t
        x = [v[:, s] for v in self.steps]
        if self.features:
            return dict(Tmotion=x[0], ranges=x[1], hit=x[2], u=x[3])
        return dict(Tmotion=x[0], pts=x[1], mask=x[2])


def _rel_l1(a, b):
    """Per robot ||a - b||_1 / ||b||_1 over all but the first dim."""
    a, b = a.flatten(1).double(), b.flatten(1).double()
    return ((a - b).abs().sum(1) / b.abs().sum(1).clamp(min=1e-30))


def map_gaps(p: FuserParams, prog, want: ref.State) -> dict:
    """The widest relative L1 gaps over the robots of a copy of the
    program's state `prog` from the reference's `want`: of the
    statistics, of the occupancy, and of each row of the program's
    gather table from the row built again from its own statistics
    (infinite where one is not finite)."""
    base = getattr(prog, "base", prog)
    g, w = base.grid, want.grid
    stats = torch.stack([_rel_l1(x, y) for x, y in (
        (g.count, w.count), (g.psum, w.psum), (g.outer, w.outer))])
    occ = _rel_l1(g.occ, w.occ)
    table = base.packed.double()
    rows = d2d.packed_from_grid(NDTGrid(
        origin=g.origin, count=g.count, psum=g.psum, outer=g.outer,
        occ=g.occ), p.ndt).double()
    rows = ((table - rows).abs().sum(-1)
            / rows.abs().sum(-1).clamp(min=1e-30))
    return {n: float(v.max()) if torch.isfinite(v).all() else math.inf
            for n, v in (("map_stats_gap", stats), ("occupancy_gap", occ),
                         ("table_gap", rows))}


def replay(p: FuserParams, inputs: Inputs, groups, gaps: dict):
    """The reference's K steps of every checked chunk at once, the
    chunks' robots side by side: `groups` holds (chunk, state before it,
    served poses (K, S, 3), scores (K, S)) each.  Each served pose and
    score is held against the reference's own, every answer's gaps
    appended to `gaps`.  Returns the state after the chunks."""
    st = tree_map(lambda *xs: torch.cat(xs), *(g[1] for g in groups))
    dev = st.Tnow.device
    for t in range(inputs.k):
        mine = torch.cat([g[2][t] for g in groups]).to(dev)
        scores = torch.cat([g[3][t] for g in groups]).to(dev)
        kws = [inputs.step(g[0], t) for g in groups]
        st, pose, _, obj = ref.step(
            p, st, follow=mine,
            **{k: torch.cat([kw[k] for kw in kws]) for k in kws[0]})
        dxy = torch.linalg.vector_norm(mine[:, :2] - pose[:, :2], dim=-1)
        dth = torch.remainder(mine[:, 2] - pose[:, 2] + math.pi,
                              2 * math.pi) - math.pi
        j = obj.at_pose(mine)
        dobj = j - obj.at_pose(pose)
        solved = (mine - obj.T_pred).abs().amax(-1) > 0
        dsc = torch.where(solved, (scores - j).abs() / j.abs().clamp(min=1.0),
                          0.0)
        for name, v in (("pose_gap_m", dxy), ("heading_gap_rad", dth.abs()),
                        ("objective_gap", dobj), ("score_gap", dsc)):
            gaps[name].append(torch.nan_to_num(v.double(), nan=math.inf,
                                               posinf=math.inf).cpu())
    return st


def compare(config: dict, inputs: Inputs, window, first) -> dict:
    """The gaps of a served window.  `first` is the first chunk's
    Checked (served from the first states, whose copy is its `before`);
    the copies are moved to the card of the inputs."""
    p = reference_params(config)
    dev = inputs.init[0].device
    gaps = {name: [] for name in ANSWERS}
    chunks = [first] + list(window.checked)
    with torch.no_grad():
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        on_dev = lambda st: tree_map(lambda x: x.to(dev), st)  # noqa: E731
        st = ref.initialize(p, *inputs.init[:1],
                            torch.zeros_like(inputs.init[0]),
                            *inputs.init[1:])
        maps = [map_gaps(p, on_dev(first.before), st)]
        st = replay(p, inputs, [(first.chunk, st, first.poses, first.scores)]
                    + [(ch.chunk, reference_state(p, on_dev(ch.before),
                                                  inputs.prev(ch.chunk)),
                        ch.poses, ch.scores) for ch in window.checked], gaps)
        n = first.poses.shape[1]
        for i, ch in enumerate(chunks):
            maps.append(map_gaps(p, on_dev(ch.after), tree_map(
                lambda x: x[i * n:(i + 1) * n], st)))
    out = {k: max(m[k] for m in maps) for k in maps[0]}
    out.update((k, float(torch.cat(v).max())) for k, v in gaps.items())
    return out


def verdict(gaps: dict, limits: dict):
    """(correct, [(name, value, limit)]) over the numbers `limits` names:
    correct where each is at or under its limit (a NaN is over any)."""
    rows = [(n, gaps[n], lim) for n, lim in limits.items()]
    return all(v <= lim for _, v, lim in rows), rows
