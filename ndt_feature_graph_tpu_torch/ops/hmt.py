"""NDTMapHMT: a rolling NDT window that spills evicted cells to a host
tile store and recalls them exactly on revisit (port of
ndt_feature_graph_tpu/ops/hmt.py).

The live window is an NDTGrid on the device; the tile store is host
numpy, as in the reference.  A recentre — an event, not a per-scan
step — reads the window to the host once, moves whole cells, and copies
it back (1.3 MB at 200 x 200 cells).

Invariants, as the reference's:
  * The cell lattice is anchored at construction, every recentre
    shifts by whole cells, and the anchor / origin / shift arithmetic is
    float64 numpy with np.round (the new origin is cast to float32 only
    at the end), so global cell coordinates are exact.
  * A cell's content lives in exactly one place, the window or the
    store.  Spill and recall only ever add to zeros, so the window the
    port recalls is bit for bit the one it spilled.

Persistence: `save(dir)` / `HMTMap.load(dir)` write one NGF file per
tile, the window as active.ngf and a JSON manifest, the reference's
hmt_map_dir layout: a directory either package wrote loads in both.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ndt_feature_graph_tpu_torch.config import NDTMapParams
from ndt_feature_graph_tpu_torch.ops import ndt_map

FIELDS = ("count", "psum", "outer", "occ")


def _empty_tile(tc: int):
    return {
        "count": np.zeros((tc, tc), np.float32),
        "psum": np.zeros((tc, tc, 2), np.float32),
        "outer": np.zeros((tc, tc, 2, 2), np.float32),
        "occ": np.zeros((tc, tc), np.float32),
    }


def _tile_empty(tile) -> bool:
    return not (tile["count"].any() or tile["occ"].any())


class HMTMap:
    """Host-orchestrated rolling map with tile spill and recall.

    params: NDTMapParams of the rolling window; center (2,): the first
    window centre (world, a tensor: the window lives on its device);
    tile_cells: tile side in cells."""

    def __init__(self, params: NDTMapParams, center, tile_cells: int = 64):
        self.params = params
        self.tile_cells = int(tile_cells)
        self.grid = ndt_map.empty_grid(params, center.to(torch.float32))
        # World coordinates of global cell (0, 0)'s corner; every later
        # origin differs from it by whole cells.
        self.anchor = self.grid.origin.cpu().numpy().astype(np.float64)
        self.tiles: dict = {}  # (tx, ty) -> field dict

    # ---------------- live window ----------------

    def add_points(self, pts, mask):
        self.grid = ndt_map.add_points(self.grid, self.params, pts, mask)

    def update_occupancy(self, sensor_origin, pts, mask):
        self.grid = ndt_map.update_occupancy(self.grid, self.params,
                                             sensor_origin, pts, mask)

    def add_scan(self, sensor_origin, pts, mask, margin: float = 0.0):
        """The per-scan map update with window follow: recentre onto the
        sensor if it left the margin (margin > 0), then fuse the scan's
        world points.  sensor_origin (2,) or (3,) on the window's device
        (a host read when margin > 0)."""
        if margin > 0.0:
            self.follow(sensor_origin.cpu().numpy(), margin)
        self.add_points(pts, mask)
        self.update_occupancy(sensor_origin[:2], pts, mask)

    def cell_list(self) -> ndt_map.CellList:
        """The window's valid gaussians as a padded cell list."""
        return ndt_map.to_cell_list(self.grid, self.params)

    def center(self):
        origin = self.grid.origin.cpu().numpy().astype(np.float64)
        return origin + np.asarray([self.params.size_x / 2.0,
                                    self.params.size_y / 2.0])

    def follow(self, xy, margin: float) -> bool:
        """Recentre onto the world point xy (host, (2,) or more) if it
        lies more than `margin` from the window's centre (float64, as
        the reference).  Returns True if it did."""
        xy = np.asarray(xy)[:2]
        off = xy.astype(np.float64) - self.center()
        if float(np.hypot(off[0], off[1])) <= margin:
            return False
        self.recenter(xy)
        return True

    # ---------------- spill / recall ----------------

    def _g0(self, origin) -> np.ndarray:
        """Global integer cell coords (gx, gy) of window cell (0, 0)."""
        return np.round((np.asarray(origin, np.float64) - self.anchor)
                        / self.params.resolution).astype(np.int64)

    def _tile(self, tx: int, ty: int):
        key = (int(tx), int(ty))
        t = self.tiles.get(key)
        if t is None:
            t = _empty_tile(self.tile_cells)
            self.tiles[key] = t
        return t

    def recenter(self, new_center):
        """Shift the window onto `new_center` (world, host) by whole
        cells; spill evicted content to the tile store and recall stored
        content under the new footprint.  Zero shift is a no-op."""
        p = self.params
        res = p.resolution
        origin = self.grid.origin.cpu().numpy().astype(np.float64)
        cur_center = origin + np.asarray([p.size_x / 2.0, p.size_y / 2.0])
        shift = np.round((np.asarray(new_center, np.float64) - cur_center)
                         / res).astype(np.int64)
        sx, sy = int(shift[0]), int(shift[1])
        if sx == 0 and sy == 0:
            return
        dev = self.grid.count.device
        h, w = p.grid_h, p.grid_w
        count, psum, outer, occ = (getattr(self.grid, f).cpu().numpy()
                                   for f in FIELDS)

        # SPILL: old cell (y, x) survives iff (y - sy, x - sx) stays in
        # the window; evicted cells with content go to the store.
        iy = np.arange(h)[:, None]
        ix = np.arange(w)[None, :]
        survive = ((iy - sy >= 0) & (iy - sy < h)
                   & (ix - sx >= 0) & (ix - sx < w))
        content = (count > 0) | (occ != 0.0)
        g0 = self._g0(origin)
        tc = self.tile_cells
        ys, xs = np.nonzero(~survive & content)
        if ys.size:
            gx = g0[0] + xs
            gy = g0[1] + ys
            tx = gx // tc
            ty = gy // tc
            ox = (gx - tx * tc).astype(np.int64)
            oy = (gy - ty * tc).astype(np.int64)
            keys = tx * (1 << 32) + ty  # one scalar key per tile
            uniq, inv = np.unique(keys, return_inverse=True)
            for k in range(uniq.shape[0]):
                sel = inv == k
                tile = self._tile(tx[sel][0], ty[sel][0])
                o_y, o_x, s_y, s_x = oy[sel], ox[sel], ys[sel], xs[sel]
                # Exact: the stored cell is zero (exclusive residency).
                tile["count"][o_y, o_x] += count[s_y, s_x]
                tile["psum"][o_y, o_x] += psum[s_y, s_x]
                tile["outer"][o_y, o_x] += outer[s_y, s_x]
                tile["occ"][o_y, o_x] += occ[s_y, s_x]

        # SHIFT: new[y, x] = old[y + sy, x + sx] where in range.
        def mv(a):
            out = np.zeros_like(a)
            y0, y1 = max(0, -sy), min(h, h - sy)
            x0, x1 = max(0, -sx), min(w, w - sx)
            if y1 > y0 and x1 > x0:
                out[y0:y1, x0:x1] = a[y0 + sy:y1 + sy, x0 + sx:x1 + sx]
            return out

        count, psum, outer, occ = mv(count), mv(psum), mv(outer), mv(occ)

        # RECALL: stored content under the new footprint moves back in
        # (cells that never left are zero in the store, so adding over
        # the whole footprint is exact).
        ng0 = g0 + np.asarray([sx, sy])
        for key in list(self.tiles):
            ktx, kty = key
            gx0, gx1 = ktx * tc, (ktx + 1) * tc
            gy0, gy1 = kty * tc, (kty + 1) * tc
            ox0, ox1 = max(gx0, ng0[0]), min(gx1, ng0[0] + w)
            oy0, oy1 = max(gy0, ng0[1]), min(gy1, ng0[1] + h)
            if ox0 >= ox1 or oy0 >= oy1:
                continue
            tile = self.tiles[key]
            gsy = slice(int(oy0 - ng0[1]), int(oy1 - ng0[1]))
            gsx = slice(int(ox0 - ng0[0]), int(ox1 - ng0[0]))
            tsy = slice(int(oy0 - gy0), int(oy1 - gy0))
            tsx = slice(int(ox0 - gx0), int(ox1 - gx0))
            count[gsy, gsx] += tile["count"][tsy, tsx]
            psum[gsy, gsx] += tile["psum"][tsy, tsx]
            outer[gsy, gsx] += tile["outer"][tsy, tsx]
            occ[gsy, gsx] += tile["occ"][tsy, tsx]
            for f in FIELDS:
                tile[f][tsy, tsx] = 0.0
            if _tile_empty(tile):
                del self.tiles[key]

        new_origin = (origin + shift * res).astype(np.float32)
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        self.grid = ndt_map.NDTGrid(origin=t(new_origin), count=t(count),
                                    psum=t(psum), outer=t(outer), occ=t(occ))

    # ---------------- persistence (hmt_map_dir contract) ----------------

    def _tile_grid(self, key, tile, device=None):
        """A stored tile as an NDTGrid (numpy fields, or tensors on
        `device`) at its world origin."""
        tx, ty = key
        tc, res = self.tile_cells, self.params.resolution
        origin = (self.anchor + np.asarray([tx * tc * res, ty * tc * res])
                  ).astype(np.float32)
        fields = dict(origin=origin, **{f: tile[f] for f in FIELDS})
        if device is not None:
            fields = {k: torch.from_numpy(v).to(device)
                      for k, v in fields.items()}
        return ndt_map.NDTGrid(**fields)

    def save(self, dirpath):
        """Write the store and the live window to `dirpath`: one NGF file
        per tile, active.ngf and the hmt.json manifest."""
        from ndt_feature_graph_tpu_torch.io import native

        os.makedirs(dirpath, exist_ok=True)
        res = self.params.resolution
        names = {}
        for key, tile in self.tiles.items():
            name = f"tile_{key[0]}_{key[1]}.ngf"
            native.write_grid(os.path.join(dirpath, name),
                              self._tile_grid(key, tile), res)
            names[f"{key[0]},{key[1]}"] = name
        native.write_grid(os.path.join(dirpath, "active.ngf"), self.grid, res)
        with open(os.path.join(dirpath, "hmt.json"), "w") as f:
            json.dump({"anchor": list(map(float, self.anchor)),
                       "tile_cells": self.tile_cells, "resolution": res,
                       "tiles": names}, f)

    @classmethod
    def load(cls, dirpath, params: NDTMapParams, device=None) -> "HMTMap":
        """An HMTMap from a saved directory; the window on `device` (the
        card unless given)."""
        from ndt_feature_graph_tpu_torch.io import native

        with open(os.path.join(dirpath, "hmt.json")) as f:
            meta = json.load(f)
        self = cls.__new__(cls)
        self.params = params
        self.tile_cells = int(meta["tile_cells"])
        self.anchor = np.asarray(meta["anchor"], np.float64)
        self.grid, _ = native.read_grid(os.path.join(dirpath, "active.ngf"),
                                        device)
        self.tiles = {}
        for key, name in meta["tiles"].items():
            tx, ty = (int(v) for v in key.split(","))
            grid, _ = native.read_grid(os.path.join(dirpath, name), "cpu")
            self.tiles[(tx, ty)] = {f: getattr(grid, f).numpy()
                                    for f in FIELDS}
        return self

    # ---------------- whole-map view ----------------

    def stored_cell_count(self) -> int:
        return int(sum((t["count"] > 0).sum() for t in self.tiles.values()))

    def global_gaussians(self):
        """Finalized (means, covs) numpy over the live window and every
        stored tile (NDTMap::getAllCells over the whole HMT)."""
        dev = self.grid.count.device
        parts = [(self.grid, self.params)]
        res, tc = self.params.resolution, self.tile_cells
        tp = self.params.replace(size_x=tc * res, size_y=tc * res)
        parts += [(self._tile_grid(k, t, dev), tp)
                  for k, t in self.tiles.items()]
        means, covs = [], []
        for g, prm in parts:
            mean, cov, valid = ndt_map.finalize(g, prm)
            m = valid.reshape(-1)
            means.append(mean.reshape(-1, 2)[m].cpu().numpy())
            covs.append(cov.reshape(-1, 2, 2)[m].cpu().numpy())
        return np.concatenate(means, 0), np.concatenate(covs, 0)
