"""State carried across between the JAX package and the port.

This system has no weights: what the two sides share is state.  The
`*_from_jax` functions take the JAX package's state as numpy arrays under
the JAX field names — a NamedTuple such as `jax.tree.map(np.asarray,
state)` or a nested mapping — and build the port's dataclasses on
`device`.  `to_numpy` goes back: a nested dict of numpy arrays under the
same field names (the port's dataclasses use the JAX names).  The JAX
FeatureFuserState's PRNG `key` has no port counterpart and is dropped.
A stacked (N, ...) JAX node bank goes through `node_from_jax` as one
node does; link and edge indices become int64.  `graph_from_jax` loads a
whole frozen JAX graph (bank, node poses, odometry edges) into a port
NDTFeatureGraphSLAM, and `tree_from_flat` reads such a bank back from an
npz of dotted field paths.

Nothing here imports jax.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from ndt_feature_graph_tpu_torch.features.detector import FeatureSet
from ndt_feature_graph_tpu_torch.fusion.feature_fuser import (
    FeatureFuserState,
)
from ndt_feature_graph_tpu_torch.fusion.fuser import FuserState
from ndt_feature_graph_tpu_torch.graph.links import LinkSet
from ndt_feature_graph_tpu_torch.graph.node import (
    FeatureMapBuffer, NodeData, map_tensors,
)
from ndt_feature_graph_tpu_torch.graph.optimize import EdgeList
from ndt_feature_graph_tpu_torch.graph.slam import NDTFeatureGraphSLAM
from ndt_feature_graph_tpu_torch.ops.d2d import PackedTarget
from ndt_feature_graph_tpu_torch.ops.ndt_map import CellList, NDTGrid


def _get(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _tensors(obj, names, device):
    return {n: torch.tensor(np.asarray(_get(obj, n)), device=device)
            for n in names}


def grid_from_jax(g, device=None) -> NDTGrid:
    return NDTGrid(**_tensors(g, ("origin", "count", "psum", "outer", "occ"),
                              device))


def cell_list_from_jax(c, device=None) -> CellList:
    return CellList(**_tensors(c, ("means", "covs", "mask"), device))


def feature_set_from_jax(f, device=None) -> FeatureSet:
    return FeatureSet(**_tensors(
        f, ("pts", "angles", "scales", "response", "mask"), device
    ))


def fuser_state_from_jax(s, device=None) -> FuserState:
    return FuserState(
        grid=grid_from_jax(_get(s, "grid"), device),
        **_tensors(s, ("Tnow", "Todom", "Tlast_fuse", "sensor_pose",
                       "packed", "n_updates"), device),
    )


def feature_fuser_state_from_jax(s, device=None) -> FeatureFuserState:
    return FeatureFuserState(
        base=fuser_state_from_jax(_get(s, "base"), device),
        prev_feats=feature_set_from_jax(_get(s, "prev_feats"), device),
        **_tensors(s, ("prev_desc", "prev_pose"), device),
    )


def feature_map_from_jax(b, device=None) -> FeatureMapBuffer:
    return FeatureMapBuffer(
        feats=feature_set_from_jax(_get(b, "feats"), device),
        **_tensors(b, ("desc", "write_idx"), device),
    )


def node_from_jax(n, device=None) -> NodeData:
    tgt = _get(n, "target")
    return NodeData(
        target=PackedTarget(**_tensors(tgt, ("origin", "packed"), device)),
        cells=cell_list_from_jax(_get(n, "cells"), device),
        feats=feature_set_from_jax(_get(n, "feats"), device),
        **_tensors(n, ("T", "Tlocal_odom", "Tlocal_fuse", "occ_origin",
                       "occ", "desc"), device),
    )


def _indices(obj, names, device):
    return {n: torch.tensor(np.asarray(_get(obj, n)), dtype=torch.int64,
                            device=device) for n in names}


def link_set_from_jax(ls, device=None) -> LinkSet:
    return LinkSet(**_indices(ls, ("ref", "mov"), device),
                   **_tensors(ls, ("T", "cov", "score", "mask"), device))


def edge_list_from_jax(e, device=None) -> EdgeList:
    is_odom = _get(e, "is_odom")
    return EdgeList(
        **_indices(e, ("i", "j"), device),
        **_tensors(e, ("meas", "info", "mask"), device),
        is_odom=None if is_odom is None else torch.tensor(
            np.asarray(is_odom), device=device),
    )


def tree_from_flat(flat: Mapping, prefix: str) -> dict:
    """The nested mapping stored under `prefix` in a flat mapping whose
    keys are dotted field paths ("prefix.target.packed"), such as an npz
    written from a flattened JAX tree."""
    out: dict = {}
    for key, value in flat.items():
        if not key.startswith(prefix + "."):
            continue
        *path, leaf = key[len(prefix) + 1:].split(".")
        d = out
        for name in path:
            d = d.setdefault(name, {})
        d[leaf] = value
    return out


def graph_from_jax(params, bank, node_T, edges, device=None):
    """A port NDTFeatureGraphSLAM holding a frozen JAX graph, ready for
    optimize_offline: `bank` a stacked (N, ...) JAX node bank, `node_T`
    (N, 3) the node poses, `edges` the odometry edges as (i, j, rel (3,),
    cov (3, 3))."""
    stacked = node_from_jax(bank, device)
    n = stacked.T.shape[0]
    slam = NDTFeatureGraphSLAM(params)
    slam.nodes = [map_tensors(lambda a, i=i: a[i], stacked)
                  for i in range(n)]
    slam.node_T = [np.asarray(t, np.float32).copy()
                   for t in np.asarray(node_T)]
    slam.odom_edges = [(int(i), int(j), np.asarray(rel, np.float32),
                        np.asarray(cov, np.float32))
                       for (i, j, rel, cov) in edges]
    return slam


def to_numpy(obj):
    """Port state (nested dataclasses of tensors) -> nested dict of numpy
    arrays under the same (JAX) field names."""
    if dataclasses.is_dataclass(obj):
        return {f.name: to_numpy(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    return obj.detach().cpu().numpy()
