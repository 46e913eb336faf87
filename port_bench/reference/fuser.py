"""The fleet step of the reference: the port's plain fuser (first scan,
joint registration, consistency gate, map update with the incremental
table refresh) and its feature half, for S streams at once, copied from
the port's plain path and cut to the settings the benchmark's
configurations state (no rolling map, the occupancy on every step).

A step's `Objective` is the joint objective it minimised, so that a
served pose can be scored by the reference's own objective, and a step
can follow served poses into its map.
"""

from __future__ import annotations

import dataclasses

import torch

from port_bench.reference import d2d, features, ndt_map, se2
from port_bench.reference.config import FuserParams
from port_bench.reference.ndt_map import CellList, NDTGrid


@dataclasses.dataclass
class State:
    """S streams' fuser state (leading (S,) on every field); the feature
    fields are None without the feature term."""

    Tnow: torch.Tensor         # (S, 3) vehicle pose in the submap frame
    Todom: torch.Tensor        # (S, 3) dead-reckoning pose
    Tlast_fuse: torch.Tensor   # (S, 3)
    sensor_pose: torch.Tensor  # (S, 3) laser in the vehicle frame
    grid: NDTGrid
    packed: torch.Tensor       # (S, H*W, 8)
    prev_feats: features.FeatureSet = None
    prev_desc: torch.Tensor = None


@dataclasses.dataclass
class Objective:
    """One step's joint objective of S lanes, as a function of the
    increment d (S, 3) over T_pred: (f, g, H)."""

    params: FuserParams
    T_pred: torch.Tensor
    src: CellList
    packed: torch.Tensor
    origins: torch.Tensor
    feat_src: CellList
    feat_tgt: CellList
    Q: torch.Tensor

    def __call__(self, d):
        p = self.params
        h, w = p.ndt.grid_h, p.ndt.grid_w
        b = d.shape[0]
        return d2d.newton_objective_batch_reference(
            d, self.T_pred, self.src, self.packed.reshape(b * h * w, 8),
            self.origins, torch.arange(b, device=d.device) * (h * w), h, w,
            p.ndt.resolution, p.matcher, self.feat_src, self.feat_tgt,
            self.Q, _bf16_rows(p))

    def at_pose(self, T):
        """The objective's value at the served poses T (S, 3)."""
        return self(se2.compose(T, se2.inverse(self.T_pred)))[0]


def _bf16_rows(p: FuserParams) -> bool:
    """The fleet step reads bfloat16 table rows from a windowed table."""
    return (p.gather_table_bf16
            and 0 < p.gather_window_cells < min(p.ndt.grid_h, p.ndt.grid_w))


def initialize(p: FuserParams, init_pose, sensor_pose, ranges, hit) -> State:
    """First scan of S streams: each submap centred on its initial pose,
    the scan inserted; with the feature term, its features."""
    pts, mask = features.scan_to_points(ranges, hit)
    world_T = se2.compose(init_pose, sensor_pose)
    world_pts = se2.transform_points(world_T, pts)
    grid = ndt_map.empty_grid(p.ndt, init_pose[..., :2])
    grid = ndt_map.add_points(grid, p.ndt, world_pts, mask)
    grid = ndt_map.update_occupancy(grid, p.ndt, world_T[..., :2], world_pts,
                                    mask)
    st = State(Tnow=init_pose, Todom=init_pose, Tlast_fuse=init_pose,
               sensor_pose=sensor_pose, grid=grid,
               packed=d2d.packed_from_grid(grid, p.ndt))
    if p.matcher.use_feat:
        st.prev_feats = features._detect_plain(p.features, ranges, hit)
        st.prev_desc = features._describe_plain(p.features, st.prev_feats,
                                                ranges, hit)
    return st


def _match_cells(p: FuserParams, sensor_pose, pts, mask) -> CellList:
    """The scan's local cell list in the vehicle frame, cut at the match
    cell budget."""
    size = 2.0 * (p.ndt.sensor_range + 3.0 * p.ndt.resolution)
    lp = p.ndt.replace(size_x=size, size_y=size)
    if lp.max_points_per_scan > lp.max_cells:
        raise ValueError("the reference lists a scan's touched cells only: "
                         "max_points_per_scan must not exceed max_cells")
    vpts = se2.transform_points(sensor_pose, pts)
    grid = ndt_map.empty_grid(
        lp, torch.zeros((*pts.shape[:-2], 2), device=pts.device))
    grid, touched = ndt_map.add_points_touched(grid, lp, vpts, mask)
    src = ndt_map.to_cell_list_touched(grid, lp, touched)
    nb = p.match_cell_budget
    return src.head(nb) if nb and nb < src.mask.shape[-1] else src


def step(p: FuserParams, st: State, Tmotion, ranges=None, hit=None, u=None,
         pts=None, mask=None, follow=None):
    """One scan of S streams: with the feature term from the scans
    (ranges, hit) and the RANSAC draws u (S, M, 2), else from the points
    (pts, mask).  Returns (new state, the reference's poses (S, 3), its
    scores (S,), the step's Objective).  With `follow` (S, 3) the step
    takes those poses, not its own, into the new state and the map."""
    m = p.matcher
    h, w = p.ndt.grid_h, p.ndt.grid_w
    b = Tmotion.shape[0]
    dev = Tmotion.device
    feat_src = feat_tgt = None
    if m.use_feat:
        pts, mask = features.scan_to_points(ranges, hit)
        feats = features._detect_plain(p.features, ranges, hit)
        desc = features._describe_plain(p.features, feats, ranges, hit)
        gate = features.OdometryGate(
            sensor_pose=st.sensor_pose, motion=Tmotion, prev_pose=st.Tnow,
            max_translation=p.max_translation_norm / 10.0,
            max_rotation=p.max_rotation_norm / 4.0,
            check=p.check_consistency, cov_xy=p.feature_cov_xy)
        res = features._match_sets_plain(p.features, st.prev_feats,
                                         st.prev_desc, feats, desc, u)
        feat_src, feat_tgt = features._gate_plain(res, st.prev_feats, feats,
                                                  gate)

    T_pred = se2.compose(st.Tnow, Tmotion)
    Todom = se2.compose(st.Todom, Tmotion)
    I_eps = se2.odometry_information(p.motion, Tmotion)
    Ainv = se2.adjoint_inverse(T_pred)
    obj = Objective(
        p, T_pred, _match_cells(p, st.sensor_pose, pts, mask) if m.use_ndt
        else None, st.packed, st.grid.origin, feat_src, feat_tgt,
        Ainv.transpose(-1, -2) @ I_eps @ Ainv if m.use_odom else None)
    d, score, _, _ = d2d.newton_match_batch(
        torch.zeros((b, 3), dtype=torch.float32, device=dev), m, obj)

    # Consistency gate: a registration too far from odometry falls back
    # to the odometry prediction.
    T_est = se2.compose(d, T_pred)
    diff = se2.sub(se2.sub(st.Tnow, T_est), Tmotion)
    bad = (torch.linalg.vector_norm(diff[..., :2], dim=-1)
           > p.max_translation_norm) | (
               torch.abs(diff[..., 2]) > p.max_rotation_norm)
    if p.force_odom_as_est:
        bad = torch.ones_like(bad)
    elif not p.check_consistency or p.all_matches_valid:
        bad = torch.zeros_like(bad)
    Tnow = torch.where(bad[..., None], T_pred, T_est)
    pose = Tnow
    if follow is not None:
        Tnow = follow

    world_T = se2.compose(Tnow, st.sensor_pose)
    world_pts = se2.transform_points(world_T, pts)
    grid, touched = ndt_map.add_points_touched(st.grid, p.ndt, world_pts,
                                               mask)
    packed = d2d.refresh_packed(st.packed, grid, p.ndt, touched)
    grid = ndt_map.update_occupancy(grid, p.ndt, world_T[..., :2], world_pts,
                                    mask)
    moved = se2.sub(st.Tlast_fuse, Tnow)
    fused = (torch.linalg.vector_norm(moved[..., :2], dim=-1) > 0.05) | (
        torch.abs(moved[..., 2]) > 0.01)
    new = State(Tnow=Tnow, Todom=Todom,
                Tlast_fuse=torch.where(fused[..., None], Tnow, st.Tlast_fuse),
                sensor_pose=st.sensor_pose, grid=grid, packed=packed)
    if m.use_feat:
        new.prev_feats, new.prev_desc = feats, desc
    return new, pose, score, obj
