"""High-level pipelines (port of ndt_feature_graph_tpu/pipeline.py):
scan gating + graph building, then `NDTFeatureGraphSLAM.optimize_offline`
for the offline optimizer, and ATE evaluation."""

from __future__ import annotations

import time

import numpy as np
import torch

from ndt_feature_graph_tpu.config import SLAMParams
from ndt_feature_graph_tpu.io import tum
from ndt_feature_graph_tpu_torch.core import se2
from ndt_feature_graph_tpu_torch.graph.slam import NDTFeatureGraphSLAM
from ndt_feature_graph_tpu_torch.io import dataset as dataset_mod


def gate_scans(odom, min_incr_dist: float, min_incr_rot: float):
    """Motion gating in numpy (the ndt_graph_offline driver loop):
    accumulate odometry (T, 3) from scan 1 on, keep a scan once the
    accumulated motion exceeds `min_incr_dist` metres or `min_incr_rot`
    radians.  Returns (kept scan indices, their accumulated motions)."""
    odom = np.asarray(odom, np.float32)
    acc = np.zeros(3, np.float32)
    keep_idx, keep_acc = [], []
    for t in range(1, odom.shape[0]):
        acc = se2.compose_np(acc, odom[t])
        if (float(np.linalg.norm(acc[:2])) < min_incr_dist
                and abs(float(acc[2])) < min_incr_rot):
            continue
        keep_idx.append(t)
        keep_acc.append(acc)
        acc = np.zeros(3, np.float32)
    return keep_idx, keep_acc


def run_slam(params: SLAMParams, seq: dataset_mod.Sequence, seed: int = 0,
             min_incr_dist: float = None, min_incr_rot: float = None,
             verbose: bool = False, ransac_u=None, pair_u=None):
    """Online pass: scan gating + graph building, through
    run_sequence_chunked with online loop closure, else through
    run_sequence_device; the active node is frozen at the end.

    seq holds tensors on the device to run on.  ransac_u: optional
    (n_kept, M, 2) RANSAC draws of the kept scans; pair_u: optional list
    of the link proposals' draws (see NDTFeatureGraphSLAM.pair_u), both
    default to the generator.  Returns (slam, stats dict)."""
    mi = params.min_incr_dist if min_incr_dist is None else min_incr_dist
    mr = params.min_incr_rot if min_incr_rot is None else min_incr_rot
    dev = seq.ranges.device

    slam = NDTFeatureGraphSLAM(params, seed=seed)
    slam.pair_u = pair_u
    slam.initialize(seq.gt[0], torch.zeros(3, device=dev), seq.ranges[0],
                    seq.hit[0], t=0.0)
    keep_idx, keep_acc = gate_scans(seq.odom.cpu().numpy(), mi, mr)
    n_updates = len(keep_idx)

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    if n_updates:
        idx = torch.as_tensor([0] + keep_idx, device=dev)
        odom_g = torch.as_tensor(
            np.concatenate([np.zeros((1, 3), np.float32),
                            np.stack(keep_acc)]), device=dev)
        times = [0.0] + [float(t) for t in keep_idx]
        args = (odom_g, seq.ranges[idx], seq.hit[idx])
        if params.graph.online_loop_closure:
            slam.run_sequence_chunked(*args, times=times, ransac_u=ransac_u)
        else:
            slam.run_sequence_device(*args, times=times, ransac_u=ransac_u)
    slam.finalize_current_node()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    stats = {
        "n_scans": int(seq.gt.shape[0]),
        "n_updates": n_updates,
        "n_nodes": len(slam.nodes),
        "wall_s": wall,
        "scans_per_sec": n_updates / max(wall, 1e-9),
    }
    if verbose:
        print(stats)
    return slam, stats


def evaluate(slam: NDTFeatureGraphSLAM, seq: dataset_mod.Sequence,
             align: bool = False):
    """ATE of the online trajectory against ground truth at the update
    times."""
    est = np.stack(slam.trajectory)
    t_idx = np.asarray(slam.times, int)
    gt = seq.gt.cpu().numpy()[t_idx]
    return tum.ate_rmse(est, gt, align=align)
