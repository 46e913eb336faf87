"""Link computation: loop-closure proposal, occupancy-overlap scoring,
D2D refinement, validation gates (port of
ndt_feature_graph_tpu/graph/links.py).

The reference's O(N^2) sequential pair loop is one batch over a padded
pair list: feature RANSAC over a leading batch of pairs, the overlap
score against the stacked node bank (one `overlap_score` launch on CUDA
tensors: the transform, gather, masks and a fixed-order sum of every
pair in one pass), and the batched Newton of every pair's D2D refinement
with its Hessian in one `newton_solve_batch` launch on CUDA tensors
(their plain twins on the CPU: the eager score
`cuda_kernels.overlap_score_reference`, summed by torch.sum).

Randomness: `compute_links_batch` takes the RANSAC draws `u` (P, M, 2),
one row of uniforms per pair, and `compute_link` one pair's (M, 2),
where the reference splits a key.
"""

from __future__ import annotations

import dataclasses

import torch

from ndt_feature_graph_tpu_torch.config import (
    FeatureParams, GraphParams, MatcherParams, NDTMapParams,
)
from ndt_feature_graph_tpu_torch.core import se2
from ndt_feature_graph_tpu_torch.features import ransac
from ndt_feature_graph_tpu_torch.graph.node import NodeData, map_tensors
from ndt_feature_graph_tpu_torch.ops import cuda_kernels, d2d
from ndt_feature_graph_tpu_torch.ops.ndt_map import CellList


@dataclasses.dataclass
class LinkSet:
    """Padded link arrays (NDTFeatureLink fields)."""

    ref: torch.Tensor     # (L,) int64
    mov: torch.Tensor     # (L,) int64
    T: torch.Tensor       # (L, 3) mov-node frame -> ref-node frame
    cov: torch.Tensor     # (L, 3, 3)
    score: torch.Tensor   # (L,) occupancy-overlap score (lower = better)
    mask: torch.Tensor    # (L,) bool


def occupancy_overlap_score(ref: NodeData, mov: NodeData, T,
                            resolution: float):
    """Overlap score of one node pair under T (overlapNDTOccupancyScore).
    Returns (score, n_overlap).  cuda_kernels.overlap_score on the two
    maps (on the card the kernel of the batch, so the pair gets the bits
    of its batch row)."""
    h, w = mov.occ.shape
    return cuda_kernels.overlap_score(
        ref.occ.reshape(-1), ref.occ_origin, None, None, T, h, w,
        resolution, mov_flat=mov.occ.reshape(-1), mov_origins=mov.occ_origin)


def compute_link(fp: FeatureParams, resolution: float, ref: NodeData,
                 mov: NodeData, u):
    """One pair's link proposal (computeLink): feature-map RANSAC -> T,
    then the occupancy-overlap score (1.0 without a valid RANSAC pose).
    u (M, 2): the pair's RANSAC draws.  Returns (T (3,), score,
    feat_valid, n_overlap).

    The same computation as the pair's row of compute_links_batch under
    the same draws.  The bits are the row's where torch computes a row
    in one order alone and in the batch: on the CPU for grids under
    32,768 cells (a longer single row is summed across threads) in
    batches under 32 pairs (torch evaluates atan2 / sin / cos of 32 or
    more values with vectorized routines, which round some RANSAC poses
    in another last bit).  Elsewhere the overlap score may part in its
    last bits (the plain score's torch.sum); on the card every output keeps its row's bits,
    the overlap kernel's order being a function of H*W alone (chip_smoke
    phase 16b)."""
    res = ransac.match_sets(fp, ref.feats, ref.desc, mov.feats, mov.desc, u)
    score, nb = occupancy_overlap_score(ref, mov, res.T, resolution)
    return res.T, torch.where(res.valid, score, 1.0), res.valid, nb


def _overlap_score_flat(occ_flat, occ_origins, ref_i, mov_i, T, h: int,
                        w: int, resolution: float):
    """occupancy_overlap_score for P pairs against the stacked bank:
    occ_flat (N*H*W,), occ_origins (N, 2), ref_i / mov_i (P,), T (P, 3).
    Returns (score (P,), n_overlap (P,)): cuda_kernels.overlap_score,
    one launch on the card."""
    return cuda_kernels.overlap_score(
        occ_flat, occ_origins, ref_i.to(torch.int64), mov_i.to(torch.int64),
        T.contiguous(), h, w, resolution)


def compute_links_batch(fp: FeatureParams, resolution: float,
                        nodes: NodeData, pair_ref, pair_mov, pair_mask,
                        u) -> LinkSet:
    """All-pairs link proposal in one batch (computeAllPossibleLinks):
    nodes is a stacked (N, ...) bank; pair_ref / pair_mov (P,) int;
    pair_mask (P,) bool; u (P, M, 2) RANSAC draws, one row per pair."""
    pair_ref = pair_ref.to(torch.int64)
    pair_mov = pair_mov.to(torch.int64)
    feats = lambda idx: map_tensors(lambda x: x[idx], nodes.feats)  # noqa
    res = ransac.match_sets(fp, feats(pair_ref), nodes.desc[pair_ref],
                            feats(pair_mov), nodes.desc[pair_mov], u)
    h, w = nodes.occ.shape[1], nodes.occ.shape[2]
    score, _ = _overlap_score_flat(nodes.occ.reshape(-1), nodes.occ_origin,
                                   pair_ref, pair_mov, res.T, h, w,
                                   resolution)
    p = pair_ref.shape[0]
    eye = torch.eye(3, device=res.T.device) * 0.05
    return LinkSet(
        ref=pair_ref, mov=pair_mov, T=res.T,
        cov=eye.expand(p, 3, 3).clone(),
        score=torch.where(res.valid, score, 1.0),
        mask=pair_mask & res.valid,
    )


def refine_links_d2d(map_params: NDTMapParams, m: MatcherParams,
                     nodes: NodeData, links: LinkSet,
                     src_budget: int = 0) -> LinkSet:
    """NDT D2D refinement of every link + covariance from the Hessian
    (updateLinksUsingNDTRegistration): the batched Newton
    (d2d.newton_match_batch) of the window term against the flat
    (N*H*W, 8) packed bank at a per-pair row offset, and each pair's
    Hessian at its result — one `newton_solve_batch` launch on CUDA
    tensors, a cluster a pair that leaves at the pair's own stop; on the
    CPU its plain twin, the lockstep then one more evaluation.

    src_budget > 0 keeps each pair's first `src_budget` source cells
    (cell lists are compacted, so any budget >= the bank's valid-cell
    count is exact; see source_cell_budget).  Masked lanes run too, and
    `mask & converged` is applied after."""
    h, w = map_params.grid_h, map_params.grid_w
    nb = src_budget if src_budget > 0 else nodes.cells.means.shape[1]
    mov = links.mov
    src_b = CellList(means=nodes.cells.means[mov, :nb],
                     covs=nodes.cells.covs[mov, :nb],
                     mask=nodes.cells.mask[mov, :nb])
    origins = nodes.target.origin[links.ref]
    packed_flat = nodes.target.packed.reshape(-1, 8)
    row_offsets = links.ref.to(torch.int64) * (h * w)
    T0 = links.T.contiguous()
    p_count = links.ref.shape[0]
    d_b, _score, _itr, conv, H_b = cuda_kernels.newton_solve_batch(
        torch.zeros((p_count, 3), dtype=torch.float32, device=T0.device),
        T0, src_b, packed_flat, origins, row_offsets, h, w,
        map_params.resolution, m, with_hessian=True)
    T = se2.compose(d_b, T0)
    cov = d2d.cov_from_hessian(H_b, m)
    return dataclasses.replace(links, T=T, cov=cov, mask=links.mask & conv)


def rescore_links(resolution: float, nodes: NodeData,
                  links: LinkSet) -> LinkSet:
    """Recompute the overlap scores for (refined) link transforms."""
    h, w = nodes.occ.shape[1], nodes.occ.shape[2]
    score, _ = _overlap_score_flat(nodes.occ.reshape(-1), nodes.occ_origin,
                                   links.ref, links.mov, links.T, h, w,
                                   resolution)
    return dataclasses.replace(links, score=score)


def source_cell_budget(nodes: NodeData, quantum: int = 64) -> int:
    """Exact source-cell budget for refine_links_d2d: the bank's max
    valid-cell count rounded up to `quantum`, clamped to the capacity.
    One host readback."""
    cap = int(nodes.cells.means.shape[1])
    maxc = int(nodes.cells.mask.sum(1).max())
    b = max(quantum, ((maxc + quantum - 1) // quantum) * quantum)
    return min(b, cap)


def valid_links(gp: GraphParams, node_T, links: LinkSet):
    """Validation gates (getValidLinks): overlap score, consistency with
    the current global estimates node_T (N, 3), minimum index
    separation, and finiteness (a degenerate registration can leave a
    non-finite pose or covariance).  Returns a bool mask over links."""
    Tg = se2.sub(node_T[links.ref], node_T[links.mov])
    d = torch.linalg.vector_norm(links.T[:, :2] - Tg[:, :2], dim=-1)
    a = se2.normalize_angle(links.T[:, 2] - Tg[:, 2]).abs()
    idx_dist = (links.ref - links.mov).abs()
    finite = (
        torch.isfinite(links.T).all(-1)
        & torch.isfinite(links.cov).all(-1).all(-1)
        & torch.isfinite(links.score)
    )
    return (
        links.mask
        & finite
        & (links.score <= gp.valid_max_score)
        & (d <= gp.valid_max_dist)
        & (a <= gp.valid_max_angular_dist)
        & (idx_dist >= gp.valid_min_idx_dist)
    )

