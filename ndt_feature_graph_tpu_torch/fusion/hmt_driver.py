"""HMT-backed fuser: the live submap is the rolling window of an
ops/hmt.HMTMap, the NDTFuserHMT with `beHMT` set (port of
ndt_feature_graph_tpu/fusion/hmt_driver.py).

The per-scan path is the port's fuser.update, through
scan_driver.run_sequence over chunks, with rolling_map off: the window
is world-fixed between recentres.  A recentre is a host event at a
chunk boundary: one read of the grid, the exact spill / recall of
ops/hmt.py, one copy back and a full packed-table rebuild.

The chunk bounds how far the vehicle moves between recentre checks:
keep chunk * max_step_m <= size/2 - sensor_range - recenter_margin, so
every scan's sensor disc stays inside the window.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from ndt_feature_graph_tpu_torch import resolve_device
from ndt_feature_graph_tpu_torch.config import FuserParams
from ndt_feature_graph_tpu_torch.fusion import fuser, scan_driver
from ndt_feature_graph_tpu_torch.ops import d2d, ndt_map
from ndt_feature_graph_tpu_torch.ops.hmt import HMTMap


class HMTFuser:
    """Host-orchestrated scan-to-submap fuser over an HMT map, on the
    device of `pts`.

    params: FuserParams with rolling_map off (the recentres are made
    here); recenter_margin: recentre once the vehicle is this far from
    the window's centre."""

    def __init__(self, params: FuserParams, init_pose, sensor_pose, pts,
                 mask, recenter_margin: float = 10.0, tile_cells: int = 64):
        if params.rolling_map:
            raise ValueError(
                "HMTFuser orchestrates recentres itself; set "
                "rolling_map=False (the in-loop roll drops cells)")
        self.params = params
        self.margin = float(recenter_margin)
        dev = pts.device
        init_pose = torch.as_tensor(init_pose, dtype=torch.float32,
                                    device=dev)
        self.state = fuser.initialize(
            params, init_pose,
            torch.as_tensor(sensor_pose, dtype=torch.float32, device=dev),
            pts, mask)
        # The HMTMap keeps the store and the lattice anchor; the fuser
        # state's grid is the one live window, handed to the HMTMap
        # around each recentre.  Both grids come from
        # empty_grid(params, init_pose[:2]): the same origin.
        self.hmt = HMTMap(params.ndt, init_pose[:2], tile_cells)
        self.n_recenters = 0
        self.recenter_times: list = []

    # ---------------- recentre event ----------------

    def maybe_recenter(self) -> bool:
        """Spill / recall recentre if the vehicle left the margin
        (HMTMap.follow).  Returns True if one happened."""
        pose = self.state.Tnow.cpu().numpy().astype(np.float64)
        t0 = time.perf_counter()
        self.hmt.grid = self.state.grid
        if not self.hmt.follow(pose, self.margin):
            return False
        self.state = dataclasses.replace(
            self.state, grid=self.hmt.grid,
            packed=d2d.packed_from_grid(self.hmt.grid, self.params.ndt))
        if self.hmt.grid.count.is_cuda:
            torch.cuda.synchronize()
        self.n_recenters += 1
        self.recenter_times.append(time.perf_counter() - t0)
        return True

    # ---------------- driving ----------------

    def update(self, Tmotion, pts, mask):
        """One scan: the recentre check, then fuser.update."""
        self.maybe_recenter()
        self.state, info = fuser.update(self.state, self.params, Tmotion,
                                        pts, mask)
        return info

    def run_sequence(self, odom, pts, mask, chunk: int = 16):
        """`chunk` scans at a time through scan_driver.run_sequence, with
        a recentre check between chunks.  odom (T, 3); pts (T, P, 2);
        mask (T, P).  Returns the trajectory (T, 3) as numpy."""
        t = int(odom.shape[0])
        out = []
        for s in range(0, t, chunk):
            e = min(s + chunk, t)
            self.maybe_recenter()
            self.state, traj, _ = scan_driver.run_sequence(
                self.params, self.state, odom[s:e], pts[s:e], mask[s:e])
            out.append(traj.cpu().numpy())
        return np.concatenate(out, 0) if out else np.zeros((0, 3))

    # ---------------- map views / persistence ----------------

    def window_cells_near(self, world_xy, radius: float) -> int:
        """Valid finalized cells of the LIVE window within `radius` of a
        world point (a diagnostic of recalled ground)."""
        mean, _, valid = ndt_map.finalize(self.state.grid, self.params.ndt)
        mm = mean[valid].cpu().numpy()
        d = np.linalg.norm(mm - np.asarray(world_xy, np.float32)[None, :],
                           axis=-1)
        return int((d <= radius).sum())

    def stored_cell_count(self) -> int:
        return self.hmt.stored_cell_count()

    def save(self, dirpath: str):
        """Persist the store, the live window and the pose (the
        hmt_map_dir contract plus the fuser pose)."""
        self.hmt.grid = self.state.grid
        self.hmt.save(dirpath)
        s = self.state
        with open(os.path.join(dirpath, "fuser.json"), "w") as f:
            json.dump({
                "Tnow": [float(v) for v in s.Tnow.cpu().numpy()],
                "Todom": [float(v) for v in s.Todom.cpu().numpy()],
                "sensor_pose": [float(v) for v in s.sensor_pose.cpu().numpy()],
                "n_updates": int(s.n_updates),
                "margin": self.margin,
            }, f)

    @classmethod
    def load(cls, dirpath: str, params: FuserParams,
             device=None) -> "HMTFuser":
        """Resume from a saved hmt_map_dir: store, window and pose, on
        `device` (the card unless given).  As in the reference,
        Tlast_fuse is not saved and restarts at Tnow."""
        dev = resolve_device(device)
        self = cls.__new__(cls)
        self.params = params
        self.hmt = HMTMap.load(dirpath, params.ndt, dev)
        with open(os.path.join(dirpath, "fuser.json")) as f:
            meta = json.load(f)
        self.margin = float(meta["margin"])
        pose = lambda k: torch.tensor(meta[k], dtype=torch.float32,  # noqa
                                      device=dev)
        self.state = fuser.FuserState(
            Tnow=pose("Tnow"), Todom=pose("Todom"), Tlast_fuse=pose("Tnow"),
            sensor_pose=pose("sensor_pose"), grid=self.hmt.grid,
            packed=d2d.packed_from_grid(self.hmt.grid, params.ndt),
            n_updates=torch.tensor(meta["n_updates"], dtype=torch.int32,
                                   device=dev),
        )
        self.n_recenters = 0
        self.recenter_times = []
        return self
