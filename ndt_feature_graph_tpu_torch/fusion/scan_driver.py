"""Sequence drivers (port of ndt_feature_graph_tpu/fusion/scan_driver.py):
the online graph-SLAM drivers (run_graph_sequence, run_graph_chunk,
unstack_bank), the single-stream drivers (run_sequence,
run_sequence_features) and the fleet drivers over B independent streams
(run_sequence_batch, run_sequence_features_batch).

The reference runs the whole sequence inside one XLA executable with
the node splits under lax.cond.  Here the scan loop is a Python loop
over device tensors, and every branch that the reference takes on
device is decided on the host BEFORE the loop: whether a scan splits
and whether it feeds the node feature map depend only on odometry and
counters (`split_schedule`), so the loop issues no per-scan host read.
Frozen nodes are written into a pre-allocated node bank.  The fleet
drivers decide the occupancy cadence the same way (`_occ_flags`).
"""

from __future__ import annotations

import numpy as np
import torch

from ndt_feature_graph_tpu_torch.config import FuserParams
from ndt_feature_graph_tpu_torch.core import motion_model, se2
from ndt_feature_graph_tpu_torch.fusion import feature_fuser, fuser
from ndt_feature_graph_tpu_torch.graph import node as node_mod
from ndt_feature_graph_tpu_torch.graph.node import map_tensors
from ndt_feature_graph_tpu_torch.io import dataset


def split_schedule(odom, dist_moved, update_count, split_dist,
                   max_nodes: int, fm_incr: int, stop_at_split: bool = False):
    """Host replay of the reference's per-scan decisions, in float32 as
    it computes them: dist2 = dist + |odom[:2]|; a scan splits when
    dist2 > split_dist and the bank has room (then dist and the count
    restart at 0); otherwise it feeds the feature map when the node's
    update count reaches a multiple of `fm_incr`.  With `stop_at_split`
    (run_graph_chunk's contract) the schedule ends at the first split,
    and dist and the count are those after the split scan, before the
    restart.

    Returns (split (T,) bool, insert (T,) bool, dist, count, n_splits);
    with `stop_at_split` the two arrays end at the split scan.
    """
    odom = np.asarray(odom, np.float32)
    t_len = odom.shape[0]
    split = np.zeros(t_len, bool)
    insert = np.zeros(t_len, bool)
    dist = np.float32(dist_moved)
    cnt = int(update_count)
    split_dist = np.float32(split_dist)
    nn = 0
    for t in range(t_len):
        x, y = odom[t, 0], odom[t, 1]
        dist2 = np.float32(dist + np.sqrt(np.float32(x * x + y * y)))
        cnt2 = cnt + 1
        if dist2 > split_dist and nn + 1 < max_nodes:
            split[t] = True
            if stop_at_split:
                return split[:t + 1], insert[:t + 1], float(dist2), cnt2, 1
            dist, cnt, nn = np.float32(0.0), 0, nn + 1
        else:
            insert[t] = cnt2 % fm_incr == 0
            dist, cnt = dist2, cnt2
    return split, insert, float(dist), cnt, nn


def run_graph_sequence(
    params: FuserParams,
    state: feature_fuser.FeatureFuserState,
    fmap: node_mod.FeatureMapBuffer,
    current_T,
    dist_moved,
    update_count,
    odom,
    ranges,
    hit,
    split_dist,
    max_nodes: int = 64,
    fm_incr: int = 4,
    link_source: str = "fuse",
    ransac_u=None,
    generator=None,
):
    """Online graph SLAM over a (T, ...) sequence: the per-scan feature
    pipeline + joint fusion + map update, and the node splits.  The scan
    that trips `split_dist` is fused into the old node, the node is
    frozen into the bank with its incremental edge, and a fresh fuser
    seeded with that same scan opens the next node.

    state: FeatureFuserState (scan 0 already consumed); fmap:
    FeatureMapBuffer; current_T (3,) active node origin; odom (T, 3);
    ranges (T, B); hit (T, B); ransac_u (T, M, 2) RANSAC draws, or None
    to draw them on the device from `generator`.

    Returns (state, fmap, bank, node_T_bank (n_frozen, 3), edge_rel
    (n_frozen, 3), edge_cov (n_frozen, 3, 3), traj (T, 3) global poses,
    current_T (3,), meta = (dist_moved, update_count, n_frozen)); the
    bank holds the n_frozen nodes this call froze.
    """
    dev = ranges.device
    t_len = ranges.shape[0]
    split, insert, dist, cnt, n_frozen = split_schedule(
        odom.cpu().numpy(), dist_moved, update_count, split_dist,
        max_nodes, fm_incr,
    )
    ransac_u = _draws(ransac_u, (t_len,), params, generator, dev)

    bank = map_tensors(
        lambda x: torch.zeros((n_frozen,) + x.shape, dtype=x.dtype,
                              device=dev),
        node_mod.empty_node(params, fmap.desc.shape[0], dev),
    )
    z = dict(dtype=torch.float32, device=dev)
    node_T_bank = torch.zeros((n_frozen, 3), **z)
    edge_rel = torch.zeros((n_frozen, 3), **z)
    edge_cov = torch.zeros((n_frozen, 3, 3), **z)

    st, fm = state, fmap
    cur_T = current_T.to(torch.float32)
    nn = 0
    traj = []
    for t in range(t_len):
        ns, fm, _info = _graph_step(params, st, fm, odom[t], ranges[t],
                                    hit[t], ransac_u[t], insert[t])
        traj.append(se2.compose(cur_T, ns.base.Tnow))
        if split[t]:
            frozen, rel, cov, new_T, st, fm = split_node(
                params, link_source, cur_T, ns, fm, ranges[t], hit[t])
            map_tensors(lambda b, v: b[nn].copy_(v), bank, frozen)
            node_T_bank[nn] = cur_T
            edge_rel[nn] = rel
            edge_cov[nn] = cov
            cur_T = new_T
            nn += 1
        else:
            st = ns
    assert nn == n_frozen
    traj = torch.stack(traj) if traj else torch.zeros((0, 3), **z)
    return (st, fm, bank, node_T_bank, edge_rel, edge_cov, traj, cur_T,
            (dist, cnt, n_frozen))


def _graph_step(params: FuserParams, st, fm, odom_t, ranges_t, hit_t, u_t,
                insert: bool):
    """One scan of the graph drivers: the feature pipeline, joint fusion
    and map update (feature_fuser.update: one `newton_solve` launch on
    the card), then, where the host schedule says so, the scan's
    features into the node's feature map at its sensor pose.  Returns
    (state, feature map, UpdateInfo)."""
    ns, info, _res = feature_fuser.update(st, params, odom_t, ranges_t,
                                          hit_t, u_t)
    if insert:
        fm = node_mod.insert_features(
            fm, ns.prev_feats, ns.prev_desc,
            se2.compose(ns.base.Tnow, ns.base.sensor_pose),
        )
    return ns, fm, info


def run_graph_chunk(
    params: FuserParams,
    state: feature_fuser.FeatureFuserState,
    fmap: node_mod.FeatureMapBuffer,
    dist_moved,
    update_count,
    odom,
    ranges,
    hit,
    active,
    split_dist,
    fm_incr: int = 4,
    ransac_u=None,
    generator=None,
):
    """The reference's chunk of the graph driver: up to K gated scans of
    the feature pipeline, stopping at the first node split.  The scan
    that trips `split_dist` is fused into the old node and does not feed
    its feature map; the scans after it are untouched, and so is every
    row from the first inactive one on (score 0, the trajectory row
    holds the last pose).  The host makes the split itself (split_node).

    Where the chunk stops depends on odometry only, so it is decided on
    the host before the loop (split_schedule): the odometry is read to
    the host once, the loop reads nothing back, and each
    processed scan is the per-scan step of run_graph_sequence (one
    `newton_solve` launch on the card).

    state: FeatureFuserState; fmap: FeatureMapBuffer; dist_moved: the
    distance moved in the active node; update_count: its updates so
    far; odom (K, 3); ranges, hit (K, B); active (K,) bool, a host array
    or tensor (padding flags of the last chunk); ransac_u (K, M, 2) RANSAC
    draws, row t for scan t, or None to draw one row per processed scan
    on the device from `generator`.

    Returns (state, fmap, traj (K, 3) node-local poses, scores (K,),
    meta): meta = [dist, count, processed, split_idx] float32 on the
    host, split_idx -1 without a split.
    """
    act = np.asarray(active.cpu() if torch.is_tensor(active) else active,
                     bool)
    odom_np = np.asarray(odom.cpu() if torch.is_tensor(odom) else odom,
                         np.float32)
    n_active = int(np.argmin(act)) if not act.all() else act.shape[0]
    # Two nodes: the chunk's one split always has room (the caller passes
    # an infinite split_dist when the bank is full).
    split, insert, dist, cnt, _ = split_schedule(
        odom_np[:n_active], dist_moved, update_count, split_dist, 2, fm_incr,
        stop_at_split=True)
    n = split.shape[0]
    split_idx = n - 1 if n and split[-1] else -1

    k_len = ranges.shape[0]
    u = _draws(ransac_u, (n,), params, generator, ranges.device)
    st, fm = state, fmap
    scores = torch.zeros(k_len, dtype=torch.float32, device=ranges.device)
    traj = []
    for t in range(n):
        st, fm, info = _graph_step(params, st, fm, odom[t], ranges[t], hit[t],
                                   u[t], insert[t])
        scores[t] = info.score
        traj.append(st.base.Tnow)
    traj += [st.base.Tnow] * (k_len - n)
    meta = torch.tensor([dist, cnt, n, split_idx], dtype=torch.float32)
    return st, fm, torch.stack(traj), scores, meta


def split_node(params: FuserParams, link_source: str, cur_T,
               ns: feature_fuser.FeatureFuserState, fm, ranges, hit):
    """A node split after the split scan was fused into the active node
    (`ns`): freeze it with the incremental edge (rel = fused or raw local
    odometry pose, motion-model covariance + 1e-4 I) and open the next
    node, a fresh fuser seeded with that same scan in the node-local
    (identity) frame whose feature map starts with the scan's features
    (already in ns.prev_feats / prev_desc).

    Returns (frozen node, rel, cov, new node origin, new state, new
    feature map)."""
    sp = ns.base.sensor_pose
    dev = sp.device
    frozen = node_mod.freeze_node(params, cur_T, ns.base, fm)
    rel = ns.base.Todom if link_source == "odom" else ns.base.Tnow
    cov = motion_model.measurement_cov(params.motion, rel) + torch.eye(
        3, device=dev) * 1e-4
    new_T = se2.compose(cur_T, ns.base.Tnow)
    pts, mask = dataset.scan_to_points(ranges, hit)
    zero = torch.zeros(3, device=dev)
    st = feature_fuser.FeatureFuserState(
        base=fuser.initialize(params, zero, sp, pts, mask),
        prev_feats=ns.prev_feats, prev_desc=ns.prev_desc, prev_pose=zero,
    )
    fm_capacity, desc_dim = fm.desc.shape
    fm_new = node_mod.insert_features(
        node_mod.empty_feature_map(fm_capacity, desc_dim, dev),
        ns.prev_feats, ns.prev_desc, sp,
    )
    return frozen, rel, cov, new_T, st, fm_new


def unstack_bank(bank, n: int):
    """The first `n` rows of a stacked node bank as per-node NodeData
    (views into the bank, on its device)."""
    return tuple(map_tensors(lambda a, i=i: a[i], bank) for i in range(n))


def _draws(ransac_u, shape, params: FuserParams, generator, device):
    """The given RANSAC draws, or `shape + (M, 2)` uniforms drawn on the
    device from `generator`."""
    if ransac_u is not None:
        return ransac_u
    return torch.rand((*shape, params.features.ransac_hypotheses, 2),
                      generator=generator, device=device)


def run_sequence(params: FuserParams, state: fuser.FuserState, odom, pts,
                 mask):
    """Chain fuser.update over a (T, ...) sequence.  odom (T, 3); pts
    (T, P, 2); mask (T, P).  Returns (final_state, trajectory (T, 3),
    scores (T,))."""
    traj, scores = [], []
    for t in range(odom.shape[0]):
        state, info = fuser.update(state, params, odom[t], pts[t], mask[t])
        traj.append(state.Tnow)
        scores.append(info.score)
    return state, torch.stack(traj), torch.stack(scores)


def run_sequence_features(params: FuserParams,
                          state: feature_fuser.FeatureFuserState, odom,
                          ranges, hit, ransac_u=None, generator=None):
    """The full feature pipeline (detect + describe + RANSAC + joint
    fusion) chained over a (T, ...) sequence.  odom (T, 3); ranges, hit
    (T, beams); ransac_u (T, M, 2) or None to draw on the device.
    Returns (final_state, trajectory (T, 3), scores (T,))."""
    t_len = odom.shape[0]
    u = _draws(ransac_u, (t_len,), params, generator, ranges.device)
    traj, scores = [], []
    for t in range(t_len):
        state, info, _ = feature_fuser.update(state, params, odom[t],
                                              ranges[t], hit[t], u[t])
        traj.append(state.base.Tnow)
        scores.append(info.score)
    return state, torch.stack(traj), torch.stack(scores)


def _occ_flags(params: FuserParams, t: int):
    """Per-step occupancy-cadence flags of the fleet drivers
    (config.FuserParams.occ_every), on the host: step t of a call is on
    the cadence when t % occ_every == 0, so the cadence restarts with
    every call of these functions, as the reference's does."""
    k = params.occ_every
    if k <= 1:
        return [True] * t
    return [i % k == 0 for i in range(t)]


def _time_major(*xs):
    """(B, T, ...) inputs as contiguous (T, B, ...): one copy before the
    loop instead of a strided read per step."""
    return tuple(x.transpose(0, 1).contiguous() for x in xs)


def run_sequence_batch(params: FuserParams, states: fuser.FuserState, odom,
                       pts, mask):
    """Fleet driver: B independent streams, each a T-step sequence,
    through fuser.update_batch.  states: FuserState with a leading (B,);
    odom (B, T, 3); pts (B, T, P, 2); mask (B, T, P).  Returns
    (final_states, trajectories (B, T, 3), scores (B, T))."""
    odom, pts, mask = _time_major(odom, pts, mask)
    traj, scores = [], []
    for t, occ_on in enumerate(_occ_flags(params, odom.shape[0])):
        states, info = fuser.update_batch(
            states, params, odom[t], pts[t], mask[t], occ_on=occ_on)
        traj.append(states.Tnow)
        scores.append(info.score)
    return states, torch.stack(traj, 1), torch.stack(scores, 1)


def run_sequence_features_batch(params: FuserParams,
                                states: feature_fuser.FeatureFuserState,
                                odom, ranges, hit, ransac_u=None,
                                generator=None):
    """Full-pipeline fleet driver: B independent streams of the
    feature-aware pipeline through feature_fuser.update_batch.  states:
    FeatureFuserState with a leading (B,); odom (B, T, 3); ranges, hit
    (B, T, beams); ransac_u (B, T, M, 2) or None to draw on the device.
    Returns (final_states, trajectories (B, T, 3), scores (B, T))."""
    b, t_len = odom.shape[:2]
    u = _draws(ransac_u, (b, t_len), params, generator, ranges.device)
    odom, ranges, hit, u = _time_major(odom, ranges, hit, u)
    traj, scores = [], []
    for t, occ_on in enumerate(_occ_flags(params, t_len)):
        states, info, _ = feature_fuser.update_batch(
            states, params, odom[t], ranges[t], hit[t], u[t],
            occ_on=occ_on)
        traj.append(states.base.Tnow)
        scores.append(info.score)
    return states, torch.stack(traj, 1), torch.stack(scores, 1)
