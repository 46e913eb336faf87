"""Batched RANSAC feature-set matcher (port of
ndt_feature_graph_tpu/features/ransac.py: match_sets, to_paired_cells).

Fixed-budget parallel hypothesis fan-out: descriptor chi2 matrix ->
one candidate per moving point -> M two-point SE(2) hypotheses -> MSAC
scoring -> two Procrustes refinements on the winner's inliers.

Randomness: the reference draws the (M, 2) hypothesis uniforms from
`jax.random.uniform` under a key split per scan; torch cannot reproduce
that stream, so `match_sets` takes the draws `u` as an argument.

On CUDA tensors `match_sets` is one launch of the matcher kernel
(ops/cuda_kernels.py match_features, csrc/features.cu), and
`match_sets_gated` the same launch with the feature fuser's odometry gate
and paired pseudo-cells in its epilogue; on the CPU they are the plain
twins, `_match_sets_plain` and `_gate_plain`, the kernel's yardstick on
the card.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ndt_feature_graph_tpu_torch.config import FeatureParams
from ndt_feature_graph_tpu_torch.core import se2
from ndt_feature_graph_tpu_torch.features.detector import (
    FeatureSet, top_k_stable,
)
from ndt_feature_graph_tpu_torch.features.distance import (
    symmetric_chi2_matrix,
)
from ndt_feature_graph_tpu_torch.ops.ndt_map import CellList
from ndt_feature_graph_tpu_torch.ops.ndt_map import take_rows as _take


@dataclasses.dataclass
class MatchResult:
    T: torch.Tensor            # (3,) mov -> ref SE(2) transform
    score: torch.Tensor        # MSAC score (lower better)
    num_inliers: torch.Tensor  # int32
    corr_ref: torch.Tensor     # (C,) candidate ref indices
    corr_mov: torch.Tensor     # (C,) candidate mov indices
    corr_mask: torch.Tensor    # (C,) candidate validity
    inlier_mask: torch.Tensor  # (C,) inliers under final T
    valid: torch.Tensor        # bool — enough inliers for a pose


def _procrustes(a, b, w):
    """Weighted 2D rigid fit argmin_T sum w |a - T(b)|^2; a, b (..., C, 2),
    w (..., C).  Returns (..., 3)."""
    wsum = torch.clamp(w.sum(-1), min=1e-9)[..., None]
    ca = (a * w[..., None]).sum(-2) / wsum
    cb = (b * w[..., None]).sum(-2) / wsum
    a0 = a - ca[..., None, :]
    b0 = b - cb[..., None, :]
    sxx = (w * (b0[..., 0] * a0[..., 0] + b0[..., 1] * a0[..., 1])).sum(-1)
    sxy = (w * (b0[..., 0] * a0[..., 1] - b0[..., 1] * a0[..., 0])).sum(-1)
    theta = torch.atan2(sxy, sxx)
    c, s = torch.cos(theta), torch.sin(theta)
    tx = ca[..., 0] - (c * cb[..., 0] - s * cb[..., 1])
    ty = ca[..., 1] - (s * cb[..., 0] + c * cb[..., 1])
    return torch.stack([tx, ty, theta], -1)


def _apply(T, pts):
    """Poses T (..., 3) applied to points (..., 2)."""
    c, s = torch.cos(T[..., 2]), torch.sin(T[..., 2])
    x = c * pts[..., 0] - s * pts[..., 1] + T[..., 0]
    y = s * pts[..., 0] + c * pts[..., 1] + T[..., 1]
    return torch.stack([x, y], -1)


def _success_and_ratio(params: FeatureParams):
    """(p, w): the success probability and inlier ratio, clipped."""
    return (min(max(params.ransac_success_prob, 1e-6), 1.0 - 1e-9),
            min(max(params.ransac_inlier_ratio, 1e-6), 1.0 - 1e-9))


def hypothesis_budget(params: FeatureParams) -> int:
    """N = log(1-p) / log(1-w^2), the RANSAC stopping bound."""
    p_succ, w0 = _success_and_ratio(params)
    return int(math.ceil(math.log1p(-p_succ) / math.log1p(-w0 * w0)))


def adaptive_considered(params: FeatureParams, r2_raw, corr_mask, hyp_ok):
    """The adaptive variant's mask of hypotheses (..., M): hypothesis i
    counts only while i < N(best inlier ratio seen before i), a running
    max over the hypotheses since N(w) does not increase with w.  The
    bound is float32, as the reference's."""
    p_succ, w0 = _success_and_ratio(params)
    acc = params.ransac_acceptance
    n_cand = torch.clamp(corr_mask.sum(-1), min=1).to(torch.float32)
    inl_cnt = ((r2_raw < acc) & corr_mask[..., None, :]).sum(-1)
    ratio = torch.where(hyp_ok, inl_cnt / n_cand[..., None], 0.0)
    run = torch.cummax(torch.clamp(ratio, min=w0), -1).values
    run_prev = torch.cat([torch.full_like(run[..., :1], w0),
                          run[..., :-1]], -1)
    w2 = torch.clamp(run_prev * run_prev, 1e-9, 1.0 - 1e-6)
    bound = torch.tensor(math.log1p(-p_succ), dtype=torch.float32,
                         device=w2.device) / torch.log1p(-w2)
    m_hyp = r2_raw.shape[-2]
    return torch.arange(m_hyp, device=w2.device) < torch.ceil(bound)


@dataclasses.dataclass
class OdometryGate:
    """The feature fuser's check of a RANSAC pose against odometry and
    its pseudo-cells (fusion/feature_fuser.py): poses (..., 3) over the
    pair batch (or shared by it)."""

    sensor_pose: torch.Tensor   # laser in the vehicle frame
    motion: torch.Tensor        # the odometry motion, Tmotion
    prev_pose: torch.Tensor     # the previous scan's Tnow
    max_translation: float      # FuserParams.max_translation_norm / 10
    max_rotation: float         # FuserParams.max_rotation_norm / 4
    check: bool                 # FuserParams.check_consistency
    cov_xy: float               # the pseudo-cells' covariance, cov_xy * I


def match_sets(params: FeatureParams, ref: FeatureSet, ref_desc,
               mov: FeatureSet, mov_desc, u) -> MatchResult:
    """Estimate the SE(2) transform carrying `mov` features onto `ref`
    features.  `u` (..., M, 2) are the hypothesis draws, uniform in
    [0, 1).  Leading dims are a batch of independent set pairs (the
    reference vmaps this over link candidates): feature sets (..., F),
    descriptors (..., F, D); every result field gains the batch dims.
    CUDA tensors: cuda_kernels.match_features (one launch); CPU: the
    plain twin."""
    from ndt_feature_graph_tpu_torch.ops import cuda_kernels

    return cuda_kernels.match_features(params, ref, ref_desc, mov, mov_desc,
                                       u)


def match_sets_gated(params: FeatureParams, ref: FeatureSet, ref_desc,
                     mov: FeatureSet, mov_desc, u, gate: OdometryGate):
    """match_sets, then the feature fuser's odometry gate: the RANSAC
    pose (current sensor frame -> previous one) against the odometry in
    the vehicle frame, and the correspondences as paired fixed-covariance
    pseudo-cells in the world (`tgt`: the previous scan's points under
    prev_pose o sensor_pose) and vehicle (`src`) frames, masked to the
    inliers of a consistent, valid pose.  Returns (MatchResult, src,
    tgt).  CUDA tensors: ONE launch of the matcher kernel with the gate
    in its epilogue; CPU: the plain twins."""
    from ndt_feature_graph_tpu_torch.ops import cuda_kernels

    return cuda_kernels.match_features(params, ref, ref_desc, mov, mov_desc,
                                       u, gate=gate)


def _gate_plain(res: MatchResult, ref: FeatureSet, mov: FeatureSet,
                gate: OdometryGate):
    """The plain twin of match_sets_gated's gate: (src, tgt)."""
    sp = gate.sensor_pose
    T_feat_vehicle = se2.compose(se2.compose(sp, res.T), se2.inverse(sp))
    diff = se2.sub(T_feat_vehicle, gate.motion)
    consistent = (
        (torch.linalg.vector_norm(diff[..., :2], dim=-1)
         <= gate.max_translation)
        & (torch.abs(diff[..., 2]) <= gate.max_rotation)
    ) | (not gate.check)
    feats_ok = res.valid & consistent

    world_prev = se2.compose(gate.prev_pose, sp)
    tgt_pts = se2.transform_points(world_prev, _take(ref.pts, res.corr_ref))
    src_pts = se2.transform_points(sp, _take(mov.pts, res.corr_mov))
    # Materialised once per scan: the objective kernel reads the lists
    # of every Newton trial through plain pointers.
    covs = (torch.eye(2, dtype=torch.float32, device=res.T.device)
            * gate.cov_xy).expand(*res.corr_ref.shape, 2, 2).contiguous()
    pair_mask = res.inlier_mask & feats_ok[..., None]
    return (CellList(means=src_pts, covs=covs, mask=pair_mask),
            CellList(means=tgt_pts, covs=covs, mask=pair_mask))


def _match_sets_plain(params: FeatureParams, ref: FeatureSet, ref_desc,
                      mov: FeatureSet, mov_desc, u) -> MatchResult:
    """The plain twin of match_sets: eager operations over (..., M, C)
    tensors."""
    c_cap = params.max_correspondences
    m_hyp = params.ransac_hypotheses
    acc = params.ransac_acceptance
    dev = u.device

    dist = symmetric_chi2_matrix(ref_desc, mov_desc)
    bad = ~(ref.mask[..., :, None] & mov.mask[..., None, :])
    dist = torch.where(bad, math.inf, dist)

    best_ref = torch.argmin(dist, -2)                 # first min, as jnp
    best_d = dist.amin(-2)
    neg_topk, mov_sel = top_k_stable(-best_d, min(c_cap, best_d.shape[-1]))
    if mov_sel.shape[-1] < c_cap:
        padn = c_cap - mov_sel.shape[-1]
        mov_sel = torch.cat(
            [mov_sel, mov_sel.new_zeros(mov_sel.shape[:-1] + (padn,))], -1)
        neg_topk = torch.cat([neg_topk, neg_topk.new_full(
            neg_topk.shape[:-1] + (padn,), -math.inf)], -1)
    cd = -neg_topk
    corr_mov = mov_sel
    corr_ref = _take(best_ref, mov_sel)
    corr_mask = cd < params.ransac_dist_threshold

    a = _take(ref.pts, corr_ref)                              # (..., C, 2)
    b = _take(mov.pts, corr_mov)

    n_valid = corr_mask.sum(-1).to(torch.float32)
    pair_idx = torch.floor(
        u * torch.clamp(n_valid, min=1.0)[..., None, None]
    ).to(torch.int64).clamp(0, c_cap - 1)
    i0, i1 = pair_idx[..., 0], pair_idx[..., 1]
    a0, a1 = _take(a, i0), _take(a, i1)
    b0, b1 = _take(b, i0), _take(b, i1)
    da = a1 - a0
    db = b1 - b0
    seg_len = torch.linalg.vector_norm(db, dim=-1)
    theta = (torch.atan2(da[..., 1], da[..., 0])
             - torch.atan2(db[..., 1], db[..., 0]))
    ch, sh = torch.cos(theta), torch.sin(theta)
    tx = a0[..., 0] - (ch * b0[..., 0] - sh * b0[..., 1])
    ty = a0[..., 1] - (sh * b0[..., 0] + ch * b0[..., 1])
    hyp_T = torch.stack([tx, ty, theta], -1)                  # (..., M, 3)
    len_diff2 = (seg_len - torch.linalg.vector_norm(da, dim=-1)) ** 2
    hyp_ok = (
        (seg_len > 0.2)
        & (len_diff2 < params.ransac_rigidity * 4.0)
        & _take(corr_mask, i0) & _take(corr_mask, i1) & (i0 != i1)
    )

    proj = _apply(hyp_T[..., :, None, :], b[..., None, :, :])  # (..., M, C, 2)
    r2_raw = ((a[..., None, :, :] - proj) ** 2).sum(-1)
    r2 = torch.where(corr_mask[..., None, :], r2_raw, acc)
    msac = torch.clamp(r2, max=acc).sum(-1)
    msac = torch.where(hyp_ok, msac, math.inf)
    n_budget = hypothesis_budget(params)
    considered = torch.arange(m_hyp, device=dev) < min(max(n_budget, 1),
                                                        m_hyp)
    if params.ransac_adaptive:
        considered = considered & adaptive_considered(params, r2_raw,
                                                      corr_mask, hyp_ok)
    msac = torch.where(considered, msac, math.inf)

    best = torch.argmin(msac, -1)[..., None]
    T = _take(hyp_T, best)[..., 0, :]
    any_hyp = torch.isfinite(_take(msac, best)[..., 0])

    for _ in range(2):
        r2 = ((a - _apply(T[..., None, :], b)) ** 2).sum(-1)
        w = ((r2 < acc) & corr_mask).to(torch.float32)
        T = torch.where((w.sum(-1) >= 2)[..., None], _procrustes(a, b, w), T)
    T_fit = torch.where(any_hyp[..., None], T, 0.0)

    r2 = ((a - _apply(T_fit[..., None, :], b)) ** 2).sum(-1)
    inlier = (r2 < acc) & corr_mask & any_hyp[..., None]
    n_in = inlier.sum(-1).to(torch.int32)
    score = torch.where(corr_mask, torch.clamp(r2, max=acc), acc).sum(-1)
    return MatchResult(
        T=T_fit, score=score, num_inliers=n_in, corr_ref=corr_ref,
        corr_mov=corr_mov, corr_mask=corr_mask, inlier_mask=inlier,
        valid=any_hyp & (n_in >= 2),
    )


def to_paired_cells(result: MatchResult, ref: FeatureSet, mov: FeatureSet,
                    cov_xy: float = 2e-4):
    """RANSAC correspondences as paired fixed-covariance pseudo-cell lists
    for the fusion matcher: (src, tgt), the moving and the reference
    points of each candidate, covariance cov_xy * I, masked to the
    inliers.  Leading dims as match_sets'."""
    covs = (torch.eye(2, dtype=torch.float32, device=result.T.device)
            * cov_xy).expand(*result.corr_ref.shape, 2, 2).contiguous()
    tgt = CellList(means=_take(ref.pts, result.corr_ref), covs=covs,
                   mask=result.inlier_mask)
    src = CellList(means=_take(mov.pts, result.corr_mov), covs=covs,
                   mask=result.inlier_mask)
    return src, tgt
