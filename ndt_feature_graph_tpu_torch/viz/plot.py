"""Visualization (port of ndt_feature_graph_tpu/viz/plot.py): NDT cell
ellipses, occupancy, graph nodes and links, trajectories and MCL
particles drawn on matplotlib axes, and the one-call overview figure.
Tensors become numpy at this boundary.

The overview (`save_slam_overview`, what `cli slam --plot` writes) is
rasterized here with numpy and written as a PNG with zlib, because the
card's machine has no matplotlib: the occupied cells of every node, the
trajectories and the graph, in the reference figure's colours, without
its legend and node labels (no text).  The axes helpers need matplotlib
and take the caller's axes.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from ndt_feature_graph_tpu_torch.core import se2

OVERVIEW_PX = 1170            # the reference's 9 inch figure at 130 dpi
COLORS = {"cells": (153, 153, 153), "estimate": (31, 119, 180),
          "ground truth": (255, 127, 14), "graph": (0, 0, 0)}


def _np(x):
    """numpy view of a tensor (moved to the host) or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def plot_ndt_cells(ax, means, covs, mask, color="tab:blue", alpha=0.4,
                   n_sigma=2.0):
    """Covariance ellipses per cell (markerNDTCells equivalent)."""
    from matplotlib.patches import Ellipse

    means = _np(means).reshape(-1, 2)
    covs = _np(covs).reshape(-1, 2, 2)
    mask = _np(mask).reshape(-1)
    for mu, cov in zip(means[mask], covs[mask]):
        evals, evecs = np.linalg.eigh(cov)
        angle = np.degrees(np.arctan2(evecs[1, 1], evecs[0, 1]))
        ax.add_patch(Ellipse(
            mu, 2 * n_sigma * np.sqrt(max(evals[1], 1e-12)),
            2 * n_sigma * np.sqrt(max(evals[0], 1e-12)), angle=angle,
            facecolor=color, alpha=alpha, edgecolor="none"))


def plot_occupancy(ax, occ_logodds, origin, resolution, cmap="gray_r"):
    occ = 1.0 / (1.0 + np.exp(-_np(occ_logodds)))
    h, w = occ.shape
    origin = _np(origin)
    extent = [origin[0], origin[0] + w * resolution,
              origin[1], origin[1] + h * resolution]
    ax.imshow(occ, origin="lower", extent=extent, cmap=cmap, vmin=0, vmax=1,
              alpha=0.8)


def plot_pose(ax, pose, color="tab:red", length=0.5):
    pose = _np(pose)
    ax.plot(pose[0], pose[1], "o", color=color, ms=4)
    ax.arrow(pose[0], pose[1], length * np.cos(pose[2]),
             length * np.sin(pose[2]), head_width=0.12, color=color)


def plot_trajectories(ax, named_trajectories):
    """named_trajectories: dict name -> (T, 3) array."""
    for name, traj in named_trajectories.items():
        traj = _np(traj)
        ax.plot(traj[:, 0], traj[:, 1], label=name, lw=1.2)
    ax.legend(loc="best", fontsize=8)
    ax.set_aspect("equal")


def plot_graph(ax, node_T, links=None, link_mask=None):
    """Node poses and loop-closure links (publishMarkerNDTFeatureNodes /
    Links equivalent); `links` a LinkSet."""
    node_T = _np(node_T)
    ax.plot(node_T[:, 0], node_T[:, 1], "k.-", lw=0.8, ms=6)
    for i, p in enumerate(node_T):
        ax.annotate(str(i), p[:2], fontsize=7)
    if links is not None:
        ref, mov = _np(links.ref), _np(links.mov)
        keep = _np(link_mask if link_mask is not None else links.mask)
        for k in range(len(ref)):
            if keep[k]:
                a, b = node_T[ref[k]], node_T[mov[k]]
                ax.plot([a[0], b[0]], [a[1], b[1]], "g--", lw=1.0)


def plot_particles(ax, poses, logw=None, color="tab:orange"):
    """MCL particle cloud (markerParticlesNDTMCL3D equivalent)."""
    poses = _np(poses)
    if logw is not None:
        logw = _np(logw)
        w = np.exp(logw - logw.max())
        s = 2 + 18 * w / w.max()
    else:
        s = 4
    ax.scatter(poses[:, 0], poses[:, 1], s=s, c=color, alpha=0.5)


def write_png(path, rgb):
    """An (H, W, 3) uint8 image as an 8-bit RGB PNG (rows top to bottom)."""
    h, w, _ = rgb.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rgb.reshape(h, w * 3)], 1).tobytes()

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


class _Canvas:
    """A white square image over the world box of `points` (K, 2) with a
    5% margin, equal scale on both axes, y up."""

    def __init__(self, points, px=OVERVIEW_PX):
        lo, hi = points.min(0), points.max(0)
        span = float(max((hi - lo).max(), 1e-6)) * 1.1
        self.center = (lo + hi) / 2
        self.scale = (px - 1) / span
        self.px = px
        self.img = np.full((px, px, 3), 255, np.uint8)

    def dots(self, xy, color, r=1):
        c = (np.asarray(xy, np.float64) - self.center) * self.scale + (
            self.px - 1) / 2
        ix, iy = np.rint(c[:, 0]).astype(int), np.rint(c[:, 1]).astype(int)
        for dx in range(-r, r + 1):
            for dy in range(-r, r + 1):
                x, y = ix + dx, self.px - 1 - (iy + dy)
                ok = (x >= 0) & (x < self.px) & (y >= 0) & (y < self.px)
                self.img[y[ok], x[ok]] = color

    def line(self, xy, color):
        """A polyline through `xy` (K, 2), sampled every half pixel."""
        xy = np.asarray(xy, np.float64)
        for a, b in zip(xy[:-1], xy[1:]):
            n = int(np.linalg.norm(b - a) * self.scale * 2) + 2
            t = np.linspace(0.0, 1.0, n)[:, None]
            self.dots(a + t * (b - a), color, r=0)


def save_slam_overview(path, slam, gt=None):
    """One-call overview figure: the occupied cells of every node, the
    trajectories (estimate, ground truth) and the graph's nodes and
    chain, as a PNG."""
    res = slam.params.fuser.ndt.resolution
    cells = []
    for nd, T in zip(slam.nodes, slam.node_T):
        ys, xs = np.nonzero(_np(nd.occ) > 0.5)
        if len(ys) == 0:
            continue
        origin = _np(nd.occ_origin)
        centers = np.stack([origin[0] + (xs + 0.5) * res,
                            origin[1] + (ys + 0.5) * res], -1)
        cells.append(se2.transform_points(
            torch.as_tensor(_np(T), dtype=torch.float32),
            torch.as_tensor(centers, dtype=torch.float32)).numpy())
    trajs = {"estimate": np.stack(slam.trajectory)}
    if gt is not None:
        trajs["ground truth"] = _np(gt)
    nodes = np.stack(slam.node_T)
    everything = np.concatenate(
        cells + [t[:, :2] for t in trajs.values()] + [nodes[:, :2]])
    canvas = _Canvas(everything)
    for c in cells:
        canvas.dots(c, COLORS["cells"], r=1)
    for name in ("ground truth", "estimate"):
        if name in trajs:
            canvas.line(trajs[name][:, :2], COLORS[name])
    canvas.line(nodes[:, :2], COLORS["graph"])
    canvas.dots(nodes[:, :2], COLORS["graph"], r=3)
    write_png(path, canvas.img)
    return path
