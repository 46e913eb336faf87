"""Link computation: loop-closure proposal, occupancy-overlap scoring,
D2D refinement, validation gates (port of
ndt_feature_graph_tpu/graph/links.py).

The reference's O(N^2) sequential pair loop is one batch over a padded
pair list: feature RANSAC over a leading batch of pairs, the overlap
score against the stacked node bank, and a lockstep batched Newton whose
D2D window term is the `fgh_dense_flat_batch` kernel entry on CUDA
tensors (its plain twin on the CPU).

Randomness: `compute_links_batch` takes the RANSAC draws `u` (P, M, 2),
one row of uniforms per pair, where the reference splits a key.
"""

from __future__ import annotations

import dataclasses

import torch

from ndt_feature_graph_tpu.config import (
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


def _cell_centers(h: int, w: int, resolution: float, device):
    """(H*W, 2) cell centres relative to the grid origin, row-major."""
    ys = (torch.arange(h, device=device, dtype=torch.float32) + 0.5) * (
        resolution)
    xs = (torch.arange(w, device=device, dtype=torch.float32) + 0.5) * (
        resolution)
    return torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)],
                       -1).reshape(-1, 2)


def _overlap(mov_occ_raw, mov_origin, ref_lookup, ref_origin, T, h: int,
             w: int, resolution: float):
    """Mean squared difference of rescaled occupancy over the cells
    where both maps carry information, 1.0 without overlap, batched over
    leading dims.  mov_occ_raw (..., H*W); origins (..., 2); T (..., 3);
    ref_lookup(flat (..., H*W)) -> the ref log-odds at those cells."""
    rel_c = _cell_centers(h, w, resolution, T.device)
    centers = mov_origin[..., None, :] + rel_c
    mov_occ = torch.sigmoid(mov_occ_raw)
    mov_has = mov_occ_raw.abs() > 1e-6

    tp = se2.transform_points(T, centers)
    rel = (tp - ref_origin[..., None, :]) / resolution
    ix = torch.floor(rel[..., 0]).to(torch.int64)
    iy = torch.floor(rel[..., 1]).to(torch.int64)
    inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    flat = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
    ref_occ_raw = ref_lookup(flat)
    ref_has = (ref_occ_raw.abs() > 1e-6) & inb
    ref_occ = torch.sigmoid(ref_occ_raw)

    both = mov_has & ref_has
    nb = both.sum(-1)
    diff2 = (mov_occ - ref_occ) ** 2
    s = torch.where(both, diff2, 0.0).sum(-1) / torch.clamp(nb, min=1)
    return torch.where(nb > 0, s, 1.0), nb


def occupancy_overlap_score(ref: NodeData, mov: NodeData, T,
                            resolution: float):
    """Overlap score of one node pair under T (overlapNDTOccupancyScore).
    Returns (score, n_overlap)."""
    h, w = mov.occ.shape
    return _overlap(mov.occ.reshape(-1), mov.occ_origin,
                    lambda flat: ref.occ.reshape(-1)[flat], ref.occ_origin,
                    T, h, w, resolution)


def _overlap_score_flat(occ_flat, occ_origins, ref_i, mov_i, T, h: int,
                        w: int, resolution: float):
    """occupancy_overlap_score for P pairs against the stacked bank:
    occ_flat (N*H*W,), occ_origins (N, 2), ref_i / mov_i (P,), T (P, 3).
    Returns (score (P,), n_overlap (P,))."""
    hw = h * w
    mov_occ_raw = occ_flat.reshape(-1, hw)[mov_i]
    ref_base = (ref_i.to(torch.int64) * hw)[:, None]
    return _overlap(mov_occ_raw, occ_origins[mov_i],
                    lambda flat: occ_flat[ref_base + flat],
                    occ_origins[ref_i], T, h, w, resolution)


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
    (updateLinksUsingNDTRegistration): one lockstep batched Newton
    (d2d.newton_match_batch) whose window term reads the flat (N*H*W, 8)
    packed bank at a per-pair row offset (the `fgh_dense_flat_batch`
    kernel entry on CUDA tensors).

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

    def fgh_batch(d_b):
        return cuda_kernels.fgh_dense_flat_batch(
            d_b, T0, src_b, packed_flat, origins, row_offsets,
            h, w, map_params.resolution, m.n_neighbours, m.lfd1, m.lfd2,
        )

    p_count = links.ref.shape[0]
    d_b, _score, _itr, conv = d2d.newton_match_batch(
        torch.zeros((p_count, 3), dtype=torch.float32, device=T0.device),
        m, fgh_batch,
    )
    T = se2.compose(d_b, T0)
    _, _, H_b = fgh_batch(d_b)
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

