"""Scan-to-submap fuser (port of ndt_feature_graph_tpu/fusion/fuser.py):
motion-model covariance -> local NDT build -> joint registration (NDT +
feature correspondences + odometry prior) -> consistency gate with
odometry fallback -> rolling-map recentre -> map update with an
incremental refresh of the packed registration table.  `update` serves
one stream, `update_batch` B independent streams in one step (fleet
serving): the same functions over a leading stream dimension, no loop
over streams.

Each registration — the damped-Newton minimisation of the D2D window
term, the paired feature term and the odometry term — is one launch of
a CUDA kernel entry: `cuda_kernels.newton_solve` for one stream,
`cuda_kernels.newton_solve_batch` for all B streams of a fleet step; on
CPU tensors it is d2d.newton_match[_batch] over the sum of the plain
terms.  The reference's TPU
gather layouts (`gather_block`, `gather_window_cells`) select table
shapes only; the port's kernel reads the packed table directly, which
is what those layouts are exact to.  `gather_table_bf16` changes the
numbers (the reference rounds its windowed table to bfloat16 with
cell-relative means): the port reproduces it as a row mode of the
kernel, on exactly where the reference turns it on (`_bf16_rows`).
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
    d2d.packed_from_grid(grid) (refreshed incrementally per scan).  A
    fleet's state is the same class with a leading stream dimension on
    every field."""

    Tnow: torch.Tensor         # (..., 3) vehicle pose in submap frame
    Todom: torch.Tensor        # (..., 3) dead-reckoning pose
    Tlast_fuse: torch.Tensor   # (..., 3)
    sensor_pose: torch.Tensor  # (..., 3) laser in vehicle frame
    grid: NDTGrid
    packed: torch.Tensor       # (..., H*W, 8)
    n_updates: torch.Tensor    # (...,) int32


@dataclasses.dataclass
class UpdateInfo:
    score: torch.Tensor
    iterations: torch.Tensor
    converged: torch.Tensor
    fallback: torch.Tensor     # bool — consistency gate rejected the match
    T_est: torch.Tensor        # (3,) raw registration estimate


def _windowed(params: FuserParams) -> bool:
    """Does the reference bound its gather table to a sensor window?"""
    p = params.ndt
    return 0 < params.gather_window_cells < min(p.grid_h, p.grid_w)


def check_params(params: FuserParams):
    """Reject configurations the port cannot reproduce (instead of the
    reference's silent behaviour)."""
    if _windowed(params):
        # The reference's window table drops every cell outside a
        # wc x wc window around the predicted pose; the port reads the
        # full table, so it only agrees when the window covers the sensor
        # disc plus the match window.
        p = params.ndt
        wc = params.gather_window_cells
        need = 2 * (math.ceil(p.sensor_range / p.resolution)
                    + params.matcher.n_neighbours) + 1
        if wc < need:
            raise ValueError(
                f"gather_window_cells={wc} does not cover the sensor disc "
                f"plus the match window ({need} cells)"
            )


def _bf16_rows(params: FuserParams, batch: bool) -> bool:
    """Does the reference read bfloat16 table rows here?  Only from a
    windowed table: the single-stream update builds one only as a
    win-block table (`gather_block`), the fleet step in either layout."""
    return (params.gather_table_bf16 and _windowed(params)
            and (batch or params.gather_block))


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
    compaction when the point capacity fits the cell capacity).  Leading
    dims of sensor_pose (..., 3), pts (..., P, 2), mask (..., P) are
    independent streams."""
    lp = local_map_params(params)
    vpts = se2.transform_points(sensor_pose, pts)
    grid = ndt_map.empty_grid(
        lp, torch.zeros((*pts.shape[:-2], 2), device=pts.device))
    if lp.max_points_per_scan <= lp.max_cells:
        grid, touched = ndt_map.add_points_touched(grid, lp, vpts, mask)
        return ndt_map.to_cell_list_touched(grid, lp, touched), vpts
    grid = ndt_map.add_points(grid, lp, vpts, mask)
    return ndt_map.to_cell_list(grid, lp), vpts


def _match_cells(params: FuserParams, sensor_pose, pts, mask) -> CellList:
    """The matcher's source cells: the scan's local cell list cut at
    `match_cell_budget`."""
    src, _ = _build_local_cells(params, sensor_pose, pts, mask)
    nb = params.match_cell_budget
    if nb and nb < src.mask.shape[-1]:
        src = src.head(nb)
    return src


def _increment_information(params: FuserParams, Tmotion, T_pred):
    """Motion information lifted into the global left-increment frame:
    I_d = Adj^-T I_eps Adj^-1 (closed-form Adj^-1)."""
    I_eps = motion_model.odometry_information(params.motion, Tmotion)
    Ainv = se2.adjoint_inverse(T_pred)
    return Ainv.transpose(-1, -2) @ I_eps @ Ainv


def update(state: FuserState, params: FuserParams, Tmotion, pts, mask,
           feat_src: Optional[CellList] = None,
           feat_tgt: Optional[CellList] = None,
           update_map: bool = True):
    """One scan update.  Returns (new_state, UpdateInfo)."""
    check_params(params)
    m = params.matcher
    T_pred = se2.compose(state.Tnow, Tmotion)
    Todom = se2.compose(state.Todom, Tmotion)

    src = _match_cells(params, state.sensor_pose, pts, mask)
    h, w = params.ndt.grid_h, params.ndt.grid_w
    res = params.ndt.resolution
    tgt_packed = state.packed
    tgt_origin = state.grid.origin
    Q = _increment_information(params, Tmotion, T_pred)
    use_feat = m.use_feat and feat_src is not None and feat_tgt is not None
    bf16 = _bf16_rows(params, batch=False)

    d, score, itr, conv = cuda_kernels.newton_solve(
        torch.zeros(3, dtype=torch.float32, device=pts.device), T_pred,
        src if m.use_ndt else None, tgt_packed, tgt_origin, h, w, res, m,
        feat_src if use_feat else None, feat_tgt if use_feat else None,
        Q if m.use_odom else None, bf16)
    return _finalize_update(state, params, Tmotion, T_pred, Todom, d,
                            score, itr, conv, pts, mask, update_map)


def update_batch(states: FuserState, params: FuserParams, Tmotion, pts,
                 mask, feat_src: Optional[CellList] = None,
                 feat_tgt: Optional[CellList] = None,
                 update_map: bool = True, occ_on: Optional[bool] = None):
    """One scan update for B independent streams (fleet serving): what
    `update` does per stream, as one step.  states: a FuserState with a
    leading (B,) on every field; Tmotion (B, 3); pts (B, P, 2); mask
    (B, P); feat_src / feat_tgt: (B, C) paired pseudo-cell lists.

    The B registrations are ONE launch of
    `cuda_kernels.newton_solve_batch` (d2d.newton_match_batch's result,
    each lane leaving at its own stop): lane b reads its own table at
    row offset b*H*W of the flat (B*H*W, 8) stack of the streams' packed
    tables.  The map operations scatter once into the flattened stack.

    `occ_on` is this step's place on the occupancy cadence
    (config.occ_every), a host bool decided before the scan loop
    (scan_driver._occ_flags); None: on.  Returns (new_states, infos)
    with the leading (B,)."""
    check_params(params)
    m = params.matcher
    h, w = params.ndt.grid_h, params.ndt.grid_w
    res = params.ndt.resolution
    b = states.Tnow.shape[0]
    dev = pts.device

    T_pred = se2.compose(states.Tnow, Tmotion)
    Todom = se2.compose(states.Todom, Tmotion)
    src_b = _match_cells(params, states.sensor_pose, pts, mask)
    Q_b = _increment_information(params, Tmotion, T_pred)
    packed_flat = states.packed.reshape(b * h * w, 8)
    row_offsets = torch.arange(b, device=dev) * (h * w)
    origins = states.grid.origin
    use_feat = m.use_feat and feat_src is not None and feat_tgt is not None
    bf16 = _bf16_rows(params, batch=True)

    d_b, score_b, itr_b, conv_b = cuda_kernels.newton_solve_batch(
        torch.zeros((b, 3), dtype=torch.float32, device=dev), T_pred,
        src_b if m.use_ndt else None, packed_flat, origins, row_offsets, h,
        w, res, m, feat_src if use_feat else None,
        feat_tgt if use_feat else None, Q_b if m.use_odom else None, bf16)

    # Occupancy cadence: when gated, the ray scatter runs here, after
    # the map update, on the steps that are on the cadence only.
    gate_occ = params.occ_every != 1 and update_map
    new_states, infos = _finalize_update(
        states, params, Tmotion, T_pred, Todom, d_b, score_b, itr_b, conv_b,
        pts, mask, update_map, update_occ=not gate_occ)
    if gate_occ and params.occ_every > 0 and (occ_on is None or occ_on):
        world_T = se2.compose(new_states.Tnow, new_states.sensor_pose)
        new_states = dataclasses.replace(
            new_states, grid=ndt_map.update_occupancy(
                new_states.grid, params.ndt, world_T[..., :2],
                se2.transform_points(world_T, pts), mask))
    return new_states, infos


def _finalize_update(state: FuserState, params: FuserParams, Tmotion,
                     T_pred, Todom, d, score, itr, conv, pts, mask,
                     update_map: bool, update_occ: bool = True):
    """Consistency gate, rolling-map recentre, map update + incremental
    packed refresh, bookkeeping — for one stream or, with a leading
    stream dimension on every argument, for a fleet."""
    T_est = se2.compose(d, T_pred)
    rel_est = se2.sub(state.Tnow, T_est)
    diff = se2.sub(rel_est, Tmotion)
    bad = (torch.linalg.vector_norm(diff[..., :2], dim=-1)
           > params.max_translation_norm
           ) | (torch.abs(diff[..., 2]) > params.max_rotation_norm)
    if params.force_odom_as_est:
        use_fallback = torch.ones_like(bad)
    elif params.check_consistency and not params.all_matches_valid:
        use_fallback = bad
    else:
        use_fallback = torch.zeros_like(bad)
    Tnow = torch.where(use_fallback[..., None], T_pred, T_est)

    grid = state.grid
    packed = state.packed
    if params.rolling_map:
        # If the vehicle left the margin, slide the window onto it by
        # whole cells; inside the margin the target is the window's own
        # centre, a zero shift and an exact no-op, so no branch and no
        # host read.  The packed table rolls in lockstep.
        p = params.ndt
        center = torch.stack([grid.origin[..., 0] + p.size_x / 2.0,
                              grid.origin[..., 1] + p.size_y / 2.0], -1)
        left = torch.linalg.vector_norm(Tnow[..., :2] - center, dim=-1) > (
            params.roll_margin)
        grid, packed = ndt_map.recenter_with_aux(
            grid, p, torch.where(left[..., None], Tnow[..., :2], center),
            packed, d2d.empty_pack_row(packed.device))
    if update_map:
        world_T = se2.compose(Tnow, state.sensor_pose)
        world_pts = se2.transform_points(world_T, pts)
        grid, touched = ndt_map.add_points_touched(
            grid, params.ndt, world_pts, mask
        )
        packed = d2d.refresh_packed(packed, grid, params.ndt, touched)
        if update_occ:
            grid = ndt_map.update_occupancy(
                grid, params.ndt, world_T[..., :2], world_pts, mask
            )

    moved = se2.sub(state.Tlast_fuse, Tnow)
    fused = (torch.linalg.vector_norm(moved[..., :2], dim=-1) > 0.05) | (
        torch.abs(moved[..., 2]) > 0.01
    )
    new_state = FuserState(
        Tnow=Tnow, Todom=Todom,
        Tlast_fuse=torch.where(fused[..., None], Tnow, state.Tlast_fuse),
        sensor_pose=state.sensor_pose, grid=grid, packed=packed,
        n_updates=state.n_updates + 1,
    )
    info = UpdateInfo(score=score, iterations=itr, converged=conv,
                      fallback=use_fallback, T_est=T_est)
    return new_state, info
