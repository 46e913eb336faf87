"""Frozen submap node data (port of ndt_feature_graph_tpu/graph/node.py).

A node is one completed submap: its global pose, the fuser's local
poses, the packed NDT registration table, the compacted cell list,
occupancy and the accumulated node feature map.  Uniform shapes across
nodes, so nodes stack into an (N, ...) bank.
"""

from __future__ import annotations

import dataclasses

import torch

from ndt_feature_graph_tpu_torch.config import FuserParams
from ndt_feature_graph_tpu_torch.features.descriptor import descriptor_dim
from ndt_feature_graph_tpu_torch.features.detector import FeatureSet
from ndt_feature_graph_tpu_torch.fusion import fuser as fuser_mod
from ndt_feature_graph_tpu_torch.ops import d2d, ndt_map


@dataclasses.dataclass
class NodeData:
    T: torch.Tensor              # (3,) node frame -> global
    Tlocal_odom: torch.Tensor    # (3,)
    Tlocal_fuse: torch.Tensor    # (3,)
    target: d2d.PackedTarget     # packed NDT registration table
    cells: ndt_map.CellList      # compacted gaussians (node frame)
    occ_origin: torch.Tensor     # (2,)
    occ: torch.Tensor            # (H, W) log-odds
    feats: FeatureSet            # node feature map (node frame)
    desc: torch.Tensor           # (FM, D)


@dataclasses.dataclass
class FeatureMapBuffer:
    """Fixed-capacity ring of the active node's accumulated features."""

    feats: FeatureSet            # (FM, ...) node-frame interest points
    desc: torch.Tensor           # (FM, D)
    write_idx: torch.Tensor      # int32 ring pointer


def _feature_set(capacity: int, device) -> FeatureSet:
    z = dict(dtype=torch.float32, device=device)
    return FeatureSet(
        pts=torch.zeros((capacity, 2), **z),
        angles=torch.zeros(capacity, **z),
        scales=torch.ones(capacity, **z),
        response=torch.zeros(capacity, **z),
        mask=torch.zeros(capacity, dtype=torch.bool, device=device),
    )


def empty_feature_map(capacity: int, desc_dim: int,
                      device) -> FeatureMapBuffer:
    return FeatureMapBuffer(
        feats=_feature_set(capacity, device),
        desc=torch.full((capacity, desc_dim), 0.5, dtype=torch.float32,
                        device=device),
        write_idx=torch.zeros((), dtype=torch.int32, device=device),
    )


def insert_features(buf: FeatureMapBuffer, feats: FeatureSet, desc,
                    node_pose) -> FeatureMapBuffer:
    """Append one scan's features (sensor frame), moved by `node_pose`,
    into the ring; slots of invalid incoming features keep their old
    content."""
    moved = feats.transform(node_pose)
    f = feats.mask.shape[0]
    cap = buf.feats.mask.shape[0]
    slots = (buf.write_idx + torch.arange(f, device=desc.device)) % cap
    slots = slots.to(torch.int64)

    def scatter(old, new):
        keep = feats.mask.reshape((f,) + (1,) * (new.dim() - 1))
        return old.index_copy(0, slots, torch.where(keep, new, old[slots]))

    new_feats = FeatureSet(
        pts=scatter(buf.feats.pts, moved.pts),
        angles=scatter(buf.feats.angles, moved.angles),
        scales=scatter(buf.feats.scales, moved.scales),
        response=scatter(buf.feats.response, moved.response),
        mask=scatter(buf.feats.mask, moved.mask),
    )
    n_in = feats.mask.sum().to(torch.int32)
    return FeatureMapBuffer(
        feats=new_feats, desc=scatter(buf.desc, desc),
        write_idx=(buf.write_idx + n_in) % cap,
    )


def freeze_node(params: FuserParams, node_T, fstate: fuser_mod.FuserState,
                fmap: FeatureMapBuffer) -> NodeData:
    """Archive the active fuser into a NodeData (the packed table is
    maintained incrementally, so it is archived as is)."""
    return NodeData(
        T=node_T.to(torch.float32),
        Tlocal_odom=fstate.Todom,
        Tlocal_fuse=fstate.Tnow,
        target=d2d.PackedTarget(origin=fstate.grid.origin,
                                packed=fstate.packed),
        cells=ndt_map.to_cell_list(fstate.grid, params.ndt),
        occ_origin=fstate.grid.origin,
        occ=fstate.grid.occ,
        feats=fmap.feats,
        desc=fmap.desc,
    )


def map_tensors(fn, *trees):
    """Apply `fn` leaf-wise over matching nested dataclasses of tensors."""
    t0 = trees[0]
    if dataclasses.is_dataclass(t0):
        return type(t0)(**{
            f.name: map_tensors(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(t0)
        })
    return fn(*trees)


def stack_nodes(nodes) -> NodeData:
    """Stack a list of nodes into one (N, ...) NodeData bank (copies)."""
    return map_tensors(lambda *xs: torch.stack(xs), *nodes)


def empty_node(params: FuserParams, fm_capacity: int,
               device) -> NodeData:
    """Shape template of a node (the bank is this, stacked)."""
    h, w = params.ndt.grid_h, params.ndt.grid_w
    mc = params.ndt.max_cells
    z = dict(dtype=torch.float32, device=device)
    return NodeData(
        T=torch.zeros(3, **z),
        Tlocal_odom=torch.zeros(3, **z),
        Tlocal_fuse=torch.zeros(3, **z),
        target=d2d.PackedTarget(origin=torch.zeros(2, **z),
                                packed=torch.zeros((h * w, 8), **z)),
        cells=ndt_map.CellList(
            means=torch.zeros((mc, 2), **z),
            covs=torch.zeros((mc, 2, 2), **z),
            mask=torch.zeros(mc, dtype=torch.bool, device=device),
        ),
        occ_origin=torch.zeros(2, **z),
        occ=torch.zeros((h, w), **z),
        feats=_feature_set(fm_capacity, device),
        desc=torch.full((fm_capacity, descriptor_dim(params.features)),
                        0.5, **z),
    )
