"""Sharded all-pairs loop-closure proposal (port of
ndt_feature_graph_tpu/parallel/links_sharded.py).

The reference's O(N^2) link loop is embarrassingly parallel: the pair
list (and its RANSAC draws) shards over the mesh, the node bank is
replicated, and each rank runs graph/links.compute_links_batch on its
rows; the LinkSet's fields are gathered back.  A pair's result depends
on its own row only, so the gathered LinkSet is compute_links_batch's on
the same draws.
"""

from __future__ import annotations

import torch

from ndt_feature_graph_tpu_torch.config import FeatureParams
from ndt_feature_graph_tpu_torch.graph import links as links_mod
from ndt_feature_graph_tpu_torch.graph.node import NodeData
from ndt_feature_graph_tpu_torch.parallel import mesh as mesh_mod


def compute_links_sharded(mesh, fp: FeatureParams, resolution: float,
                          nodes: NodeData, pair_ref, pair_mov, pair_mask, u,
                          axis="dp") -> links_mod.LinkSet:
    """compute_links_batch with the pair axis sharded over mesh[axis]:
    every rank passes the full pair list and draws u (P, M, 2) and gets
    the LinkSet of the pairs padded (masked) to a multiple of the shard
    count, replicated."""
    n = mesh_mod.axis_size(mesh, axis)
    pad = lambda x, fill=0: mesh_mod.pad_to_multiple(x, n, fill=fill)  # noqa
    pair_ref, pair_mov = pad(pair_ref.to(torch.int64)), pad(
        pair_mov.to(torch.int64))
    pair_mask, u = pad(pair_mask, False), pad(u)
    shard = lambda x: mesh_mod.shard_rows(mesh, x, axis)  # noqa: E731
    part = links_mod.compute_links_batch(
        fp, resolution, nodes, shard(pair_ref), shard(pair_mov),
        shard(pair_mask), shard(u))
    gather = lambda x: mesh_mod.gather_rows(mesh, x, axis)  # noqa: E731
    p_tot = pair_ref.shape[0]
    eye = torch.eye(3, device=u.device) * 0.05
    return links_mod.LinkSet(
        ref=pair_ref, mov=pair_mov, T=gather(part.T),
        cov=eye.expand(p_tot, 3, 3).clone(), score=gather(part.score),
        mask=gather(part.mask))
