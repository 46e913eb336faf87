"""Distributed Schur-complement pose-graph solve (port of
ndt_feature_graph_tpu/parallel/schur_sharded.py), per Gauss-Newton
iteration:

  1. each rank assembles the normal equations of its EDGE shard, and an
     all-reduce gives every rank the global (H, b);
  2. each rank eliminates the interiors of its BLOCK shard, and an
     all-reduce sums the separator system's contributions;
  3. the small separator solve runs replicated;
  4. each rank back-substitutes its own blocks, and an all-reduce
     combines the deltas.

It is graph/schur.optimize_schur itself, run on the edge and block
shards with an all-reduce as its `reduce` hook: in a world of one rank
it is the single-device program.  Over several it agrees with
graph/schur.optimize_schur and graph/optimize.optimize to float32
rounding (the partial sums meet in another order).
"""

from __future__ import annotations

import dataclasses

from ndt_feature_graph_tpu_torch.graph import optimize as opt
from ndt_feature_graph_tpu_torch.graph import schur as schur_mod
from ndt_feature_graph_tpu_torch.parallel import mesh as mesh_mod
from ndt_feature_graph_tpu_torch.parallel.solver_sharded import shard_edges


def optimize_schur_sharded(mesh, poses, edges: opt.EdgeList,
                           part: schur_mod.Partition,
                           prior_information: float = 100.0,
                           iterations: int = 20, damping: float = 1e-6,
                           axis="dp"):
    """graph.schur.optimize_schur over mesh[axis]; the partition's block
    count must divide the shard count (make_partition with a multiple of
    it).  Returns the poses (N, 3), replicated."""
    n_shards = mesh_mod.axis_size(mesh, axis)
    if part.int_idx.shape[0] % n_shards:
        raise ValueError(f"{part.int_idx.shape[0]} blocks do not divide "
                         f"{n_shards} shards")
    local = dataclasses.replace(
        part, int_idx=mesh_mod.shard_rows(mesh, part.int_idx, axis),
        int_mask=mesh_mod.shard_rows(mesh, part.int_mask, axis))
    return schur_mod.optimize_schur(poses, shard_edges(mesh, edges, axis),
                                    local, prior_information, iterations,
                                    damping,
                                    reduce=mesh_mod.reducer(mesh, axis))
