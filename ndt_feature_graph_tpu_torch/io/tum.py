"""TUM-format trajectory export + ATE evaluation.

The reference writes gt/est trajectories as TUM rows
`t x y z qx qy qz qw` (utils.h:243-259, transformToEval2dString;
publish_graph_message.cpp:373-394 writes gt_pose*.txt / est_pose*.txt)
for external evaluation; here the evaluator is built in.
"""

from __future__ import annotations

import numpy as np


def write_tum(path, times, poses):
    """poses: (T, 3) SE(2); quaternion from yaw."""
    poses = np.asarray(poses)
    times = np.asarray(times)
    with open(path, "w") as f:
        for t, p in zip(times, poses):
            half = p[2] * 0.5
            f.write(
                f"{t:.6f} {p[0]:.6f} {p[1]:.6f} 0.000000 "
                f"0.000000 0.000000 {np.sin(half):.6f} {np.cos(half):.6f}\n"
            )


def read_tum(path):
    rows = np.loadtxt(path)
    if rows.ndim == 1:
        rows = rows[None]
    t = rows[:, 0]
    xy = rows[:, 1:3]
    yaw = 2.0 * np.arctan2(rows[:, 6], rows[:, 7])
    return t, np.concatenate([xy, yaw[:, None]], -1)


def ate_rmse(est, gt, align=False):
    """Absolute trajectory error (translation RMSE).  With align=True,
    applies the optimal SE(2) alignment first (Horn/Umeyama closed
    form)."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    a, b = gt[:, :2], est[:, :2]
    if align:
        ca, cb = a.mean(0), b.mean(0)
        a0, b0 = a - ca, b - cb
        sxx = (b0[:, 0] * a0[:, 0] + b0[:, 1] * a0[:, 1]).sum()
        sxy = (b0[:, 0] * a0[:, 1] - b0[:, 1] * a0[:, 0]).sum()
        th = np.arctan2(sxy, sxx)
        R = np.array(
            [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
        )
        b = (R @ b0.T).T + ca
    return float(np.sqrt(np.mean(np.sum((a - b) ** 2, -1))))
