"""Batched RANSAC feature-set matcher (port of
ndt_feature_graph_tpu/features/ransac.py: match_sets).

Fixed-budget parallel hypothesis fan-out: descriptor chi2 matrix ->
one candidate per moving point -> M two-point SE(2) hypotheses -> MSAC
scoring -> two Procrustes refinements on the winner's inliers.

Randomness: the reference draws the (M, 2) hypothesis uniforms from
`jax.random.uniform` under a key split per scan; torch cannot reproduce
that stream, so `match_sets` takes the draws `u` as an argument.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ndt_feature_graph_tpu.config import FeatureParams
from ndt_feature_graph_tpu_torch.features.detector import (
    FeatureSet, top_k_stable,
)
from ndt_feature_graph_tpu_torch.features.distance import (
    symmetric_chi2_matrix,
)


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


def _take(x, idx):
    """Per-batch gather along the item axis: x (*B, C, *r), idx (*B, M)
    -> (*B, M, *r) with out[..., k, :] = x[..., idx[..., k], :]."""
    nb = idx.dim() - 1
    rest = x.shape[nb + 1:]
    ix = idx.reshape(idx.shape + (1,) * len(rest))
    return torch.gather(x, nb, ix.expand(idx.shape + rest))


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


def hypothesis_budget(params: FeatureParams) -> int:
    """N = log(1-p) / log(1-w^2), the RANSAC stopping bound."""
    p_succ = min(max(params.ransac_success_prob, 1e-6), 1.0 - 1e-9)
    w0 = min(max(params.ransac_inlier_ratio, 1e-6), 1.0 - 1e-9)
    return int(math.ceil(math.log1p(-p_succ) / math.log1p(-w0 * w0)))


def match_sets(params: FeatureParams, ref: FeatureSet, ref_desc,
               mov: FeatureSet, mov_desc, u) -> MatchResult:
    """Estimate the SE(2) transform carrying `mov` features onto `ref`
    features.  `u` (..., M, 2) are the hypothesis draws, uniform in
    [0, 1).  Leading dims are a batch of independent set pairs (the
    reference vmaps this over link candidates): feature sets (..., F),
    descriptors (..., F, D); every result field gains the batch dims."""
    if params.ransac_adaptive:
        raise NotImplementedError(
            "ransac_adaptive is not ported (off in every shipped config)"
        )
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
