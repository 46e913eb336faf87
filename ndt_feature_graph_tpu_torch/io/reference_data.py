"""Reader for the reference's bundled demo graph (`data/FULL GRAPH` of
the reference implementation): the port's numpy copy of
ndt_feature_graph_tpu/io/reference_data.py, which takes the directory
as an argument (the JAX package's copy defaults to where its tests find
it).

The reference ships one real, reference-produced artifact: an 8-node
saved graph written by NDTFeatureNode::save (ndt_feature_node.h:100-127)
— per node a boost *text* archive `mapping<i>.T` (global pose),
`mapping<i>local_odom.T` (accumulated local odometry within the node),
`mapping<i>local_fuse.T` (accumulated fused local motion), an (empty)
binary `.feat` feature archive, and a top-level `mapping` params
archive written by NDTFeatureGraph::saveMap (ndt_feature_graph.cpp:
408-433).  The `.jff` NDT maps and rosbags are git-LFS-missing
upstream; the pose archives are complete and parsed here.

Format of a saved Affine3d (saveAffine3d, ndt_feature_node.h:18-26):
a boost text archive header (`22 serialization::archive 12` + class
tags) followed by the 16 doubles of the Eigen 4x4 matrix in Eigen's
native column-major order (translation at elements 12..14).

Edge semantics for rebuilding the pose graph (graph.cpp:180-258):
  - incremental link i -> i+1:  T_i^{-1} * T_{i+1}
  - odometry   link i -> i+1:  Tlocal_odom of node i (restarts at
    identity per node, so no difference needed)
  - fuse       link i -> i+1:  Tlocal_fuse of node i
"""

from __future__ import annotations

import os
import re
from typing import NamedTuple

import numpy as np

_FLOAT_RE = re.compile(r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?")


def load_affine3d_text(path: str) -> np.ndarray:
    """Parse one boost text archive of an Eigen::Affine3d -> (4, 4)."""
    with open(path) as f:
        toks = f.read().split()
    vals = [float(t) for t in toks if _FLOAT_RE.fullmatch(t)]
    if len(vals) < 16:
        raise ValueError(f"{path}: expected >=16 floats, got {len(vals)}")
    m = np.array(vals[-16:], np.float64).reshape(4, 4, order="F")
    return m


def affine_to_se2(m: np.ndarray) -> np.ndarray:
    """4x4 -> (x, y, yaw), robust-yaw semantics (utils.h:30-40)."""
    return np.array(
        [m[0, 3], m[1, 3], np.arctan2(m[1, 0], m[0, 0])], np.float64
    )


class DemoGraph(NamedTuple):
    T: np.ndarray            # (N, 3) global node poses
    local_odom: np.ndarray   # (N, 3) per-node accumulated odometry
    local_fuse: np.ndarray   # (N, 3) per-node accumulated fused motion
    T_mat: np.ndarray        # (N, 4, 4) raw matrices
    resolution: float
    map_size: tuple
    sensor_range: float
    sensor_pose: np.ndarray  # (3,) laser extrinsic


def load_demo_graph(dirpath: str, prefix: str = "mapping") -> DemoGraph:
    """Load every node of the saved graph (NDTFeatureGraph::load
    semantics, ndt_feature_graph.cpp:434-466, with nb_nodes discovered
    from the files on disk)."""
    n = 0
    while os.path.exists(os.path.join(dirpath, f"{prefix}{n}.T")):
        n += 1
    if n == 0:
        raise FileNotFoundError(f"no {prefix}<i>.T files in {dirpath}")

    mats, T, lo, lf = [], [], [], []
    for i in range(n):
        m = load_affine3d_text(os.path.join(dirpath, f"{prefix}{i}.T"))
        mats.append(m)
        T.append(affine_to_se2(m))
        lo.append(affine_to_se2(load_affine3d_text(
            os.path.join(dirpath, f"{prefix}{i}local_odom.T"))))
        lf.append(affine_to_se2(load_affine3d_text(
            os.path.join(dirpath, f"{prefix}{i}local_fuse.T"))))

    # Top-level params archive (saveMap, graph.cpp:408-433): fuser
    # params then motion params then the sensor-pose Affine3d.  Parsed
    # positionally after the archive header; the trailing 16 floats
    # are the sensor pose.
    res, size, srange = 0.5, (100.0, 100.0, 1.0), 30.0
    sensor_pose = np.zeros(3)
    params_path = os.path.join(dirpath, prefix)
    if os.path.exists(params_path):
        with open(params_path) as f:
            toks = f.read().split()
        vals = [float(t) for t in toks if _FLOAT_RE.fullmatch(t)]
        # After header ints: resolution, size_x, size_y, size_z,
        # sensor_range appear as the first non-integer block
        # (fuser Params serialization order, fuser_hmt.h:58-207).
        floats = [v for v in vals if not float(v).is_integer()]
        if len(floats) >= 2:
            res = floats[0]
        fvals = vals[-16:]
        m = np.array(fvals, np.float64).reshape(4, 4, order="F")
        sensor_pose = affine_to_se2(m)
        # size/range from the canonical positions if present
        try:
            ridx = vals.index(res)
            size = tuple(vals[ridx + 1:ridx + 4])
            srange = vals[ridx + 4]
        except (ValueError, IndexError):
            pass

    return DemoGraph(
        T=np.stack(T),
        local_odom=np.stack(lo),
        local_fuse=np.stack(lf),
        T_mat=np.stack(mats),
        resolution=res,
        map_size=size,
        sensor_range=srange,
        sensor_pose=sensor_pose,
    )
