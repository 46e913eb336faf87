"""Euclidean distance transform by jump flooding (port of
ndt_feature_graph_tpu/ops/distance_field.py).

log2(n) rounds of eight masked shifts of the nearest-seed coordinates,
the same order of candidates and the same strict improvement test as
the reference, so the seeds — and the distances, which are square roots
of integers — come out equal.  The square root is taken in float64 and
rounded to float32: that is the correctly rounded float32 root on every
device (torch's vectorised float32 root on the CPU is not always).
"""

from __future__ import annotations

import torch


def distance_field(occupied):
    """occupied (H, W) bool -> (H, W) float32 distance in CELLS to the
    nearest occupied cell (0 inside obstacles, inf without any)."""
    h, w = occupied.shape
    dev = occupied.device
    yy = torch.arange(h, dtype=torch.int32, device=dev)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.int32, device=dev)[None, :].expand(h, w)
    big = 1 << 28
    sy = torch.where(occupied, yy, big)
    sx = torch.where(occupied, xx, big)

    def dist2(sy, sx):
        dy = (yy - sy).to(torch.float32)
        dx = (xx - sx).to(torch.float32)
        return torch.where(sy >= big, torch.inf, dy * dy + dx * dx)

    steps = []
    s = 1
    while s < max(h, w):
        s <<= 1
    s >>= 1
    while s >= 1:
        steps.append(s)
        s >>= 1
    for step in steps:
        best = dist2(sy, sx)
        for dy in (-step, 0, step):
            for dx in (-step, 0, step):
                if dy == 0 and dx == 0:
                    continue
                cy = torch.roll(sy, (dy, dx), (0, 1))
                cx = torch.roll(sx, (dy, dx), (0, 1))
                # Candidates rolled in from the far edge are not neighbours.
                valid = ((yy - dy >= 0) & (yy - dy < h)
                         & (xx - dx >= 0) & (xx - dx < w))
                d = torch.where(valid, dist2(cy, cx), torch.inf)
                better = d < best
                sy = torch.where(better, cy, sy)
                sx = torch.where(better, cx, sx)
                best = torch.minimum(best, d)
    return torch.sqrt(dist2(sy, sx).to(torch.float64)).to(torch.float32)
