"""CARMEN log -> Sequence adapter (port of
ndt_feature_graph_tpu/io/carmen.py): real-dataset ingestion for the SLAM
pipeline (the LaserBagReader role — readMultipleMeasurements +
getMotion, ndt_graph_offline.cpp:458-633 — for the classic public .clf
datasets), over the port's native parser (io/native.py)."""

from __future__ import annotations

import numpy as np
import torch

from ndt_feature_graph_tpu_torch import resolve_device
from ndt_feature_graph_tpu_torch.core import se2
from ndt_feature_graph_tpu_torch.io.dataset import Sequence
from ndt_feature_graph_tpu_torch.io.native import CarmenLog, read_carmen


def log_to_sequence(log: CarmenLog, max_range: float = 30.0,
                    device=None) -> Sequence:
    """Pack a parsed CARMEN log into a Sequence on `device` (the card
    unless given): hit mask from range validity, relative odometry from
    consecutive absolute odometry poses (getMotion semantics), the
    odometry chain as the (unknown) ground truth."""
    device = resolve_device(device)
    ranges = np.minimum(log.ranges, max_range)
    t, b = ranges.shape
    beam_idx = np.arange(b)[None, :]
    hit = (beam_idx < log.beam_counts[:, None]) & (
        log.ranges < max_range * 0.999
    )
    odom_abs = torch.as_tensor(log.odom_abs, device=device)
    rel = se2.sub(odom_abs[:-1], odom_abs[1:])
    odom = torch.cat([torch.zeros((1, 3), device=device), rel], 0)
    return Sequence(
        ranges=torch.as_tensor(ranges.astype(np.float32), device=device),
        hit=torch.as_tensor(hit, device=device),
        odom=odom,
        gt=odom_abs,  # no ground truth in CARMEN logs: dead-reckoning
    )


def read_carmen_sequence(path, max_range: float = 30.0,
                         device=None) -> Sequence:
    return log_to_sequence(read_carmen(path), max_range=max_range,
                           device=device)


def odometry_chain(seq: Sequence) -> np.ndarray:
    """(T, 3) float32 poses: the odometry composed from the first
    ground-truth pose, one compose a scan in float32 on the CPU, as the
    reference's writers do."""
    odom = seq.odom.detach().cpu().to(torch.float32)
    pose = seq.gt[0].detach().cpu().to(torch.float32)
    poses = [pose]
    for t in range(1, odom.shape[0]):
        pose = se2.compose(pose, odom[t])
        poses.append(pose)
    return torch.stack(poses).numpy()


def write_carmen(path, seq: Sequence, max_range: float = 30.0):
    """Export a Sequence as CARMEN FLASER records (odometry = the
    composed odometry chain): the reference's layout, line for line."""
    ranges = seq.ranges.cpu().numpy()
    hit = seq.hit.cpu().numpy()
    t_steps, b = ranges.shape
    poses = odometry_chain(seq)
    with open(path, "w") as f:
        f.write("# synthetic CARMEN log (ndt_feature_graph_tpu)\n")
        for t in range(t_steps):
            r = np.where(hit[t], ranges[t], max_range * 1.1)
            row = (
                ["FLASER", str(b)]
                + [f"{v:.4f}" for v in r]
                + ["0.0000", "0.0000", "0.0000"]
                + [f"{v:.6f}" for v in poses[t]]
                + [f"{100.0 + t:.4f}", "sim", f"{100.0 + t:.4f}"]
            )
            f.write(" ".join(row) + "\n")
