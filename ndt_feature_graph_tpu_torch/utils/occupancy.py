"""Occupancy-grid export (port of
ndt_feature_graph_tpu/utils/occupancy.py): probability grid of one
submap or of a whole graph stitched at its node poses, a PGM writer in
place of nav_msgs/OccupancyGrid, and the integer origin shift of
moveOccupancyMap.  Host numpy, except each node's cell centres, which
are moved into the world frame on the nodes' device."""

from __future__ import annotations

import numpy as np
import torch

from ndt_feature_graph_tpu_torch.core import se2


def grid_probabilities(occ_logodds):
    """Log-odds -> occupancy probability in [0, 1]; 0.5 = unknown."""
    return torch.sigmoid(torch.as_tensor(occ_logodds))


def stitch_graph_occupancy(slam, resolution=None, padding=2.0):
    """Render every node's occupancy into one global grid at the current
    node-pose estimates.  Returns (grid (H, W) probability, origin,
    resolution); unknown cells stay at 0.5."""
    res = resolution or slam.params.fuser.ndt.resolution

    # Bounds over all transformed occupied / free cells.
    all_pts = []
    all_logodds = []
    for nd, T in zip(slam.nodes, slam.node_T):
        occ = nd.occ.cpu().numpy()
        ys, xs = np.nonzero(np.abs(occ) > 1e-6)
        if len(ys) == 0:
            continue
        origin = nd.occ_origin.cpu().numpy()
        centers = np.stack([origin[0] + (xs + 0.5) * res,
                            origin[1] + (ys + 0.5) * res], -1)
        dev = nd.occ.device
        world = se2.transform_points(
            torch.as_tensor(np.asarray(T), dtype=torch.float32, device=dev),
            torch.as_tensor(centers, dtype=torch.float32, device=dev))
        all_pts.append(world.cpu().numpy())
        all_logodds.append(occ[ys, xs])
    if not all_pts:
        return np.full((1, 1), 0.5), np.zeros(2), res

    pts = np.concatenate(all_pts)
    lo = np.concatenate(all_logodds)
    mn = pts.min(0) - padding
    mx = pts.max(0) + padding
    origin = mn
    w = int(np.ceil((mx[0] - mn[0]) / res))
    h = int(np.ceil((mx[1] - mn[1]) / res))
    acc = np.zeros((h, w), np.float64)
    ix = np.clip(((pts[:, 0] - origin[0]) / res).astype(int), 0, w - 1)
    iy = np.clip(((pts[:, 1] - origin[1]) / res).astype(int), 0, h - 1)
    np.add.at(acc, (iy, ix), lo)
    prob = 1.0 / (1.0 + np.exp(-acc))
    return prob.astype(np.float32), origin.astype(np.float32), res


def write_pgm(path, prob, unknown_band=(0.45, 0.55)):
    """map_server-style PGM: occupied black, free white, unknown grey."""
    img = np.full(prob.shape, 205, np.uint8)  # unknown grey
    img[prob < unknown_band[0]] = 254          # free
    img[prob > unknown_band[1]] = 0            # occupied
    img = img[::-1]  # PGM row 0 = top
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(img.tobytes())


def shift_origin(occ_logodds, origin, resolution, new_origin):
    """moveOccupancyMap semantics: re-anchor the grid to a new origin by
    an integer cell shift (content kept where the grids overlap)."""
    occ = np.asarray(occ_logodds)
    shift = np.round(
        (np.asarray(origin) - np.asarray(new_origin)) / resolution
    ).astype(int)
    out = np.zeros_like(occ)
    h, w = occ.shape
    sy, sx = shift[1], shift[0]
    ys0, ys1 = max(0, sy), min(h, h + sy)
    xs0, xs1 = max(0, sx), min(w, w + sx)
    out[ys0:ys1, xs0:xs1] = occ[ys0 - sy: ys1 - sy, xs0 - sx: xs1 - sx]
    snapped = np.asarray(origin) - shift * resolution
    return out, snapped
