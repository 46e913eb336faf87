"""Pose logging and config descriptors (port of
ndt_feature_graph_tpu/utils/logging_ext.py).

- GraphLogger: the NDTFeatureGraphLogger role, per-update `x y theta
  stamp` rows appended to a log file.
- desc_string: a run identifier for output filenames, derived from the
  config tree (Params::getDescString); the same string as the
  reference's for equal parameters.
"""

from __future__ import annotations

import dataclasses

from ndt_feature_graph_tpu_torch.graph.slam import NDTFeatureGraphSLAM


class GraphLogger(NDTFeatureGraphSLAM):
    """Graph SLAM with per-update timestamped pose logging."""

    def __init__(self, params, log_path, seed: int = 0):
        super().__init__(params, seed=seed)
        self._log = open(log_path, "a")

    def _log_pose(self, pose, t):
        self._log.write(
            f"{pose[0]:.6f} {pose[1]:.6f} {pose[2]:.6f} {t:.6f}\n")
        self._log.flush()

    def initialize(self, *args, t=0.0, **kw):
        super().initialize(*args, t=t, **kw)
        self._log_pose(self.trajectory[-1], t)

    def update(self, *args, t=0.0, **kw):
        pose = super().update(*args, t=t, **kw)
        self._log_pose(pose, t)
        return pose

    def close(self):
        self._log.close()


def desc_string(params) -> str:
    """Flatten the config tree into a deterministic short identifier
    (getDescString semantics): every bool, int and float field in
    declaration order, nested dataclasses walked in place; at most 200
    characters."""
    parts = []

    def walk(obj):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if dataclasses.is_dataclass(v):
                walk(v)
            elif isinstance(v, bool):
                parts.append(f"{f.name}{int(v)}")
            elif isinstance(v, (int, float)):
                parts.append(f"{f.name}{v:g}")

    walk(params)
    return "_".join(parts)[:200]
