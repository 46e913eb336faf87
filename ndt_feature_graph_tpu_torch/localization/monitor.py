"""Scan-pose quality and local pose adjustment (port of
ndt_feature_graph_tpu/localization/monitor.py).

The badness of a pose hypothesis is the median distance of the scan's
projected endpoints to the nearest obstacle in a precomputed distance
field; the brute-force local adjustment scores its (x, y, theta) grid of
candidates as one batch.
"""

from __future__ import annotations

import dataclasses

import torch

from ndt_feature_graph_tpu_torch.core import se2
from ndt_feature_graph_tpu_torch.ops import distance_field as df


@dataclasses.dataclass
class DistanceMap:
    origin: torch.Tensor       # (2,)
    resolution: torch.Tensor   # ()
    dist: torch.Tensor         # (H, W) metres to the nearest obstacle


def build_distance_map(occ_logodds, origin, resolution,
                       occupied_threshold=0.6) -> DistanceMap:
    """The distance field of the cells whose occupancy probability
    exceeds `occupied_threshold`; on the device of `occ_logodds`."""
    dev = occ_logodds.device
    occupied = torch.sigmoid(occ_logodds) > occupied_threshold
    return DistanceMap(
        origin=torch.as_tensor(origin, dtype=torch.float32, device=dev),
        resolution=torch.as_tensor(resolution, dtype=torch.float32,
                                   device=dev),
        dist=df.distance_field(occupied) * resolution,
    )


def nanmedian(x):
    """`jnp.nanmedian` along the last dim: the mean of the two middle
    values of the non-NaN entries when their count is even
    (`torch.nanmedian` returns the lower one), NaN when there are none."""
    srt = torch.sort(x, -1).values                 # NaN sorts last
    n = (~torch.isnan(x)).sum(-1, keepdim=True).to(x.dtype)
    q = 0.5 * (n - 1.0)
    lo = torch.maximum(torch.minimum(torch.floor(q), n - 1.0),
                       torch.zeros_like(q)).to(torch.int64)
    hi = torch.maximum(torch.minimum(torch.ceil(q), n - 1.0),
                       torch.zeros_like(q)).to(torch.int64)
    return ((torch.gather(srt, -1, lo) + torch.gather(srt, -1, hi))
            * 0.5)[..., 0]


def _endpoint_distances(dmap: DistanceMap, pose, pts, mask):
    """Field value under each endpoint of the scan at pose(s) (..., 3):
    5 m off the map, NaN for masked points."""
    world = se2.transform_points(pose, pts)
    rel = (world - dmap.origin) / dmap.resolution
    h, w = dmap.dist.shape
    ix = torch.floor(rel[..., 0]).to(torch.int32)
    iy = torch.floor(rel[..., 1]).to(torch.int32)
    inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    d = dmap.dist[iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
    return torch.where(inb & mask, d,
                       torch.where(mask, 5.0, torch.nan))


def badness(dmap: DistanceMap, pose, pts, mask):
    """Median endpoint distance to the nearest obstacle under `pose`
    (ScanPoseEvaluator::operator()).  Out-of-map endpoints count as
    far (5 m)."""
    return nanmedian(_endpoint_distances(dmap, pose, pts, mask))


def _linspace(a: float, b: float, n: int, device):
    """`jnp.linspace(a, b, n)` in float32: a (1 - t) + b t, t = i/(n-1),
    the last value b itself (XLA may contract the multiply-add, so a
    value can differ from the reference's in its last place)."""
    t = torch.arange(n - 1, dtype=torch.float32, device=device) / (n - 1)
    out = a * (1.0 - t) + b * t
    return torch.cat([out, torch.full((1,), b, device=device)])


def adjust_pose(dmap: DistanceMap, pose, pts, mask, search_xy=0.3,
                search_theta=0.15, nx=7, ny=7, ntheta=7):
    """Brute-force local pose refinement (ScanPoseEvaluator::adjustPose):
    all nx * ny * ntheta (dx, dy, dtheta) candidates scored as one
    batch; returns the best pose and its badness (the first of equal
    scores)."""
    dev = pts.device
    gx, gy, gt = torch.meshgrid(
        _linspace(-search_xy, search_xy, nx, dev),
        _linspace(-search_xy, search_xy, ny, dev),
        _linspace(-search_theta, search_theta, ntheta, dev), indexing="ij")
    poses = torch.stack([pose[0] + gx.reshape(-1), pose[1] + gy.reshape(-1),
                         se2.normalize_angle(pose[2] + gt.reshape(-1))], -1)
    scores = badness(dmap, poses, pts, mask)
    best = torch.argmin(scores)
    return poses[best], scores[best]
