"""Scan-to-submap fuser (port of ndt_feature_graph_tpu/fusion/fuser.py):
motion-model covariance -> local NDT build -> joint registration (NDT +
feature correspondences + odometry prior) -> consistency gate with
odometry fallback -> map update with an incremental refresh of the
packed registration table.

Every Newton trial's objective — D2D window term, paired feature term
and odometry term — is one launch of the CUDA kernel entry
`cuda_kernels.newton_objective`; on CPU tensors it is the sum of the
plain terms.  The reference's TPU gather layouts
(`gather_block`, `gather_window_cells`, `gather_table_bf16`) select
table shapes only; the port's kernel reads the packed table directly,
which is what those layouts are exact to.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ndt_feature_graph_tpu_torch.config import FuserParams, NDTMapParams
from ndt_feature_graph_tpu_torch.core import motion_model, se2
from ndt_feature_graph_tpu_torch.ops import cuda_kernels, d2d, ndt_map
from ndt_feature_graph_tpu_torch.ops.ndt_map import CellList, NDTGrid


def local_map_params(p: FuserParams) -> NDTMapParams:
    """Geometry of the per-scan local NDT (sensor_range + 3*resolution)."""
    size = 2.0 * (p.ndt.sensor_range + 3.0 * p.ndt.resolution)
    return p.ndt.replace(size_x=size, size_y=size)


@dataclasses.dataclass
class FuserState:
    """Per-submap fuser state.  Invariant: packed ==
    d2d.packed_from_grid(grid) (refreshed incrementally per scan)."""

    Tnow: torch.Tensor         # (3,) vehicle pose in submap frame
    Todom: torch.Tensor        # (3,) dead-reckoning pose
    Tlast_fuse: torch.Tensor   # (3,)
    sensor_pose: torch.Tensor  # (3,) laser in vehicle frame
    grid: NDTGrid
    packed: torch.Tensor       # (H*W, 8)
    n_updates: torch.Tensor    # int32


@dataclasses.dataclass
class UpdateInfo:
    score: torch.Tensor
    iterations: torch.Tensor
    converged: torch.Tensor
    fallback: torch.Tensor     # bool — consistency gate rejected the match
    T_est: torch.Tensor        # (3,) raw registration estimate


def check_params(params: FuserParams):
    """Reject configurations the port does not run (instead of the
    reference's silent behaviour)."""
    if params.rolling_map:
        raise NotImplementedError(
            "rolling_map (ndt_map.recenter) is not ported yet"
        )
    p = params.ndt
    wc = params.gather_window_cells
    if 0 < wc < min(p.grid_h, p.grid_w):
        # The reference's window table drops every cell outside a
        # wc x wc window around the predicted pose; the port reads the
        # full table, so it only agrees when the window covers the sensor
        # disc plus the match window.
        need = 2 * (math.ceil(p.sensor_range / p.resolution)
                    + params.matcher.n_neighbours) + 1
        if wc < need:
            raise ValueError(
                f"gather_window_cells={wc} does not cover the sensor disc "
                f"plus the match window ({need} cells)"
            )


def initialize(params: FuserParams, init_pose, sensor_pose, pts,
               mask) -> FuserState:
    """First scan: submap grid centred on the initial pose, cloud
    inserted."""
    check_params(params)
    init_pose = init_pose.to(torch.float32)
    sensor_pose = sensor_pose.to(torch.float32)
    world_T = se2.compose(init_pose, sensor_pose)
    world_pts = se2.transform_points(world_T, pts)
    grid = ndt_map.empty_grid(params.ndt, init_pose[:2])
    grid = ndt_map.add_points(grid, params.ndt, world_pts, mask)
    grid = ndt_map.update_occupancy(
        grid, params.ndt, world_T[:2], world_pts, mask
    )
    return FuserState(
        Tnow=init_pose, Todom=init_pose, Tlast_fuse=init_pose,
        sensor_pose=sensor_pose, grid=grid,
        packed=d2d.packed_from_grid(grid, params.ndt),
        n_updates=torch.ones((), dtype=torch.int32, device=pts.device),
    )


def _build_local_cells(params: FuserParams, sensor_pose, pts, mask):
    """Scan -> NDT cell list in the vehicle frame (touched-candidate
    compaction when the point capacity fits the cell capacity)."""
    lp = local_map_params(params)
    vpts = se2.transform_points(sensor_pose, pts)
    grid = ndt_map.empty_grid(lp, torch.zeros(2, device=pts.device))
    if lp.max_points_per_scan <= lp.max_cells:
        grid, touched = ndt_map.add_points_touched(grid, lp, vpts, mask)
        return ndt_map.to_cell_list_touched(grid, lp, touched), vpts
    grid = ndt_map.add_points(grid, lp, vpts, mask)
    return ndt_map.to_cell_list(grid, lp), vpts


def _increment_information(params: FuserParams, Tmotion, T_pred):
    """Motion information lifted into the global left-increment frame:
    I_d = Adj^-T I_eps Adj^-1 (closed-form Adj^-1)."""
    I_eps = motion_model.odometry_information(params.motion, Tmotion)
    Ainv = se2.adjoint_inverse(T_pred)
    return Ainv.T @ I_eps @ Ainv


def update(state: FuserState, params: FuserParams, Tmotion, pts, mask,
           feat_src: Optional[CellList] = None,
           feat_tgt: Optional[CellList] = None,
           update_map: bool = True):
    """One scan update.  Returns (new_state, UpdateInfo)."""
    check_params(params)
    m = params.matcher
    T_pred = se2.compose(state.Tnow, Tmotion)
    Todom = se2.compose(state.Todom, Tmotion)

    src, _ = _build_local_cells(params, state.sensor_pose, pts, mask)
    nb = params.match_cell_budget
    if nb and nb < src.means.shape[0]:
        src = src.head(nb)
    h, w = params.ndt.grid_h, params.ndt.grid_w
    res = params.ndt.resolution
    tgt_packed = state.packed
    tgt_origin = state.grid.origin
    Q = _increment_information(params, Tmotion, T_pred)
    use_feat = m.use_feat and feat_src is not None and feat_tgt is not None

    def fgh_fn(d):
        return cuda_kernels.newton_objective(
            d, T_pred, src if m.use_ndt else None, tgt_packed, tgt_origin,
            h, w, res, m, feat_src if use_feat else None,
            feat_tgt if use_feat else None, Q if m.use_odom else None,
        )

    d, score, itr, conv = d2d.newton_match(
        fgh_fn, torch.zeros(3, dtype=torch.float32, device=pts.device), m
    )
    return _finalize_update(state, params, Tmotion, T_pred, Todom, d,
                            score, itr, conv, pts, mask, update_map)


def _finalize_update(state: FuserState, params: FuserParams, Tmotion,
                     T_pred, Todom, d, score, itr, conv, pts, mask,
                     update_map: bool):
    """Consistency gate, map update + incremental packed refresh,
    bookkeeping."""
    T_est = se2.compose(d, T_pred)
    rel_est = se2.sub(state.Tnow, T_est)
    diff = se2.sub(rel_est, Tmotion)
    bad = (torch.linalg.vector_norm(diff[:2]) > params.max_translation_norm
           ) | (torch.abs(diff[2]) > params.max_rotation_norm)
    if params.force_odom_as_est:
        use_fallback = torch.ones_like(bad)
    elif params.check_consistency and not params.all_matches_valid:
        use_fallback = bad
    else:
        use_fallback = torch.zeros_like(bad)
    Tnow = torch.where(use_fallback, T_pred, T_est)

    grid = state.grid
    packed = state.packed
    if update_map:
        world_T = se2.compose(Tnow, state.sensor_pose)
        world_pts = se2.transform_points(world_T, pts)
        grid, touched = ndt_map.add_points_touched(
            grid, params.ndt, world_pts, mask
        )
        packed = d2d.refresh_packed(packed, grid, params.ndt, touched)
        grid = ndt_map.update_occupancy(
            grid, params.ndt, world_T[:2], world_pts, mask
        )

    moved = se2.sub(state.Tlast_fuse, Tnow)
    fused = (torch.linalg.vector_norm(moved[:2]) > 0.05) | (
        torch.abs(moved[2]) > 0.01
    )
    new_state = FuserState(
        Tnow=Tnow, Todom=Todom,
        Tlast_fuse=torch.where(fused, Tnow, state.Tlast_fuse),
        sensor_pose=state.sensor_pose, grid=grid, packed=packed,
        n_updates=state.n_updates + 1,
    )
    info = UpdateInfo(score=score, iterations=itr, converged=conv,
                      fallback=use_fallback, T_est=T_est)
    return new_state, info
