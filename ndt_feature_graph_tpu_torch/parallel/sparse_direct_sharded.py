"""Distributed sparse-direct (segment-Schur) pose-graph solve (port of
ndt_feature_graph_tpu/parallel/sparse_direct_sharded.py): the O(E)-memory
large-graph solver (graph/sparse_direct.py) over a mesh.

  1. EDGE shard: each rank linearizes its factors; the node-scattered
     diagonal blocks and gradient and the chain couplings are
     all-reduced (never a dense H).
  2. SEGMENT shard: each rank runs the block-Thomas elimination of its
     segments; the per-segment Schur contributions scatter into the
     (S, S, 3, 3) reduced system, all-reduced with the edge shard's
     separator couplings.
  3. The reduced separator solve runs replicated.
  4. Back-substitution per owned segment; the deltas are all-reduced.

The Levenberg-Marquardt accept / reject decision and the compensated
(double-single) position carry run replicated, and the LM loop reads
nothing back: a solve ends with its result on the device.  It is
graph/sparse_direct.optimize_direct itself, run on the edge and segment
shards with an all-reduce as its `reduce` hook (seven an iteration): in
a world of one rank it is the single-device program.  Over several it
agrees with it to float32 rounding (the partial sums meet in another
order).
"""

from __future__ import annotations

import dataclasses

import torch

from ndt_feature_graph_tpu_torch.graph import optimize as opt
from ndt_feature_graph_tpu_torch.graph import sparse_direct as sd
from ndt_feature_graph_tpu_torch.parallel import mesh as mesh_mod
from ndt_feature_graph_tpu_torch.parallel.solver_sharded import shard_edges


def pad_segments(part: sd.SegPartition, n_shards) -> sd.SegPartition:
    """Pad the segment batch with empty segments so that it divides the
    shard count (an empty segment contributes exactly zero)."""
    rem = (-part.idx.shape[0]) % n_shards
    if rem == 0:
        return part
    L = part.idx.shape[1]

    def pad(x, fill, shape):
        return torch.cat([x, torch.full(shape, fill, dtype=x.dtype,
                                        device=x.device)])

    return dataclasses.replace(
        part,
        idx=pad(part.idx, 0, (rem, L)),
        imask=pad(part.imask, False, (rem, L)),
        seg_len=pad(part.seg_len, 0, (rem,)),
        seg_left=pad(part.seg_left, -1, (rem,)),
        seg_right=pad(part.seg_right, -1, (rem,)),
    )


def optimize_direct_sharded(mesh, poses, edges: opt.EdgeList,
                            part: sd.SegPartition,
                            prior_information: float = 100.0,
                            iterations: int = 20, damping: float = 1e-6,
                            axis="dp"):
    """graph.sparse_direct.optimize_direct (no robust kernel) over
    mesh[axis].  Every rank passes the full graph and its segment layout
    (make_segments) and gets (poses (N, 3), chi2) back, replicated, as
    device tensors."""
    padded = pad_segments(part, mesh_mod.axis_size(mesh, axis))
    local = dataclasses.replace(padded, **{
        k: mesh_mod.shard_rows(mesh, getattr(padded, k), axis)
        for k in ("idx", "imask", "seg_len", "seg_left", "seg_right")})
    return sd.optimize_direct(poses, shard_edges(mesh, edges, axis), local,
                              prior_information, iterations, damping,
                              reduce=mesh_mod.reducer(mesh, axis))
