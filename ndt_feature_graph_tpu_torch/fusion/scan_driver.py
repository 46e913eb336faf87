"""Online graph-SLAM sequence drivers (port of
ndt_feature_graph_tpu/fusion/scan_driver.py: run_graph_sequence,
run_graph_chunk, unstack_bank).

The reference runs the whole sequence inside one XLA executable with
the node splits under lax.cond.  Here the scan loop is a Python loop
over device tensors, and every branch that the reference takes on
device is decided on the host BEFORE the loop: whether a scan splits
and whether it feeds the node feature map depend only on odometry and
counters (`split_schedule`), so the loop issues no per-scan host read.
Frozen nodes are written into a pre-allocated node bank.
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
                   max_nodes: int, fm_incr: int):
    """Host replay of the reference's per-scan decisions, in float32 as
    it computes them: dist2 = dist + |odom[:2]|; a scan splits when
    dist2 > split_dist and the bank has room (then dist and the count
    restart at 0); otherwise it feeds the feature map when the node's
    update count reaches a multiple of `fm_incr`.

    Returns (split (T,) bool, insert (T,) bool, dist, count, n_splits).
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
    sp = state.base.sensor_pose
    split, insert, dist, cnt, n_frozen = split_schedule(
        odom.cpu().numpy(), dist_moved, update_count, split_dist,
        max_nodes, fm_incr,
    )
    if ransac_u is None:
        ransac_u = torch.rand(
            (t_len, params.features.ransac_hypotheses, 2),
            generator=generator, device=dev,
        )

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
        ns, _info, _res = feature_fuser.update(
            st, params, odom[t], ranges[t], hit[t], ransac_u[t]
        )
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
            if insert[t]:
                fm = node_mod.insert_features(
                    fm, ns.prev_feats, ns.prev_desc,
                    se2.compose(ns.base.Tnow, sp),
                )
    assert nn == n_frozen
    traj = torch.stack(traj) if traj else torch.zeros((0, 3), **z)
    return (st, fm, bank, node_T_bank, edge_rel, edge_cov, traj, cur_T,
            (dist, cnt, n_frozen))


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
