"""Distributed pose-graph solve: edge-sharded normal-equation assembly
with an all-reduce (port of
ndt_feature_graph_tpu/parallel/solver_sharded.py).

The normal equations are a sum of per-edge contributions
(graph/optimize.assemble_normal_equations), so the O(E) linearization
shards over the mesh: each rank assembles its edge shard's (H, b), an
all-reduce gives every rank the global system, and the small dense
solve runs replicated.  It is graph/optimize.optimize itself, run on the
edge shard with an all-reduce as its `reduce` hook: in a world of one
rank it is the single-device program, and over several the ranks'
partial sums are added in another order than one device's scatter, so
results agree to float32 rounding.
"""

from __future__ import annotations

from ndt_feature_graph_tpu_torch.graph import optimize as opt
from ndt_feature_graph_tpu_torch.parallel import mesh as mesh_mod


def shard_edges(mesh, edges: opt.EdgeList, axis="dp") -> opt.EdgeList:
    """This rank's block of the edge list, padded with masked edges
    (0 -> 0, zero information) so that it divides the shard count."""
    def s(x, fill=0):
        return mesh_mod.shard_rows(mesh, x, axis, fill=fill)

    return opt.EdgeList(i=s(edges.i), j=s(edges.j), meas=s(edges.meas),
                        info=s(edges.info), mask=s(edges.mask, fill=False),
                        is_odom=None if edges.is_odom is None
                        else s(edges.is_odom, fill=True))


def optimize_sharded(mesh, poses, edges: opt.EdgeList,
                     prior_information: float = 100.0, iterations: int = 20,
                     damping: float = 1e-6, axis="dp"):
    """graph.optimize.optimize's Gauss-Newton with the edge set sharded
    over mesh[axis].  Every rank passes the full poses and edges and gets
    the optimized poses (N, 3) back (replicated, a device tensor)."""
    return opt.optimize(poses, shard_edges(mesh, edges, axis),
                        prior_information, iterations, damping,
                        reduce=mesh_mod.reducer(mesh, axis))[0]
