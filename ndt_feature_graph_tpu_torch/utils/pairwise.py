"""Pairwise scan utilities: frames, closed-form alignment, P2D
registration, extrinsic calibration (port of
ndt_feature_graph_tpu/utils/pairwise.py).

Covers the reference's small-tool surface:
  - NDTFeatureFrame + pairwise FLIRT match (ndt_feature_frame.h:19-52)
  - ICPwithCorrMatch: SVD alignment with known correspondences
    (utils.h:115-165)
  - P2D registration (NDTMatcherP2D role): scan points as isotropic
    pseudo-cells against an NDT map, minimised by the damped Newton over
    the analytic dense derivatives — one `newton_solve` launch a
    registration on the card
  - laser-to-base extrinsic search (laser2d_extrinsic_calibration.cpp:
    43-449): scoring a sensor-offset grid over scan pairs, the
    nearest-neighbour distances written out and taken in chunks of
    candidates
"""

from __future__ import annotations

import dataclasses

import torch

from ndt_feature_graph_tpu_torch.config import (
    FeatureParams, MatcherParams, NDTMapParams,
)
from ndt_feature_graph_tpu_torch.core import se2
from ndt_feature_graph_tpu_torch.features import descriptor, detector, ransac
from ndt_feature_graph_tpu_torch.io import dataset
from ndt_feature_graph_tpu_torch.ops import d2d
from ndt_feature_graph_tpu_torch.ops.ndt_map import CellList

# Elements of one chunk's (candidates, Nb, Na) distance block: 2^24
# floats (64 MB) a block, 32 candidates of a 720 x 720 pair.
CALIB_CHUNK_ELEMS = 1 << 24


@dataclasses.dataclass
class ScanFrame:
    """One scan bundle (NDTFeatureFrame): cloud + features + poses."""

    pts: torch.Tensor         # (P, 2) sensor frame
    mask: torch.Tensor        # (P,)
    feats: detector.FeatureSet
    desc: torch.Tensor
    odom: torch.Tensor        # (3,)
    gt: torch.Tensor          # (3,)


def make_frame(fp: FeatureParams, ranges, hit, odom=None, gt=None):
    """The frame of one scan, on the scan's device."""
    pts, mask = dataset.scan_to_points(ranges, hit)
    feats = detector.detect(fp, ranges, hit)
    desc = descriptor.describe(fp, feats, ranges, hit)
    pose = lambda p: (  # noqa: E731
        torch.zeros(3, device=ranges.device) if p is None
        else torch.as_tensor(p, dtype=torch.float32, device=ranges.device))
    return ScanFrame(pts=pts, mask=mask, feats=feats, desc=desc,
                     odom=pose(odom), gt=pose(gt))


def match_frames_flirt(fp: FeatureParams, ref: ScanFrame, mov: ScanFrame,
                       u):
    """Pairwise FLIRT RANSAC (ndtFeatureFrameMatchingFLIRT); `u`
    (M, 2) are the hypothesis draws, uniform in [0, 1)."""
    return ransac.match_sets(fp, ref.feats, ref.desc, mov.feats, mov.desc,
                             u)


def icp_with_corr(a_pts, b_pts, weights):
    """Closed-form SVD/Procrustes alignment with known correspondences
    (ICPwithCorrMatch, utils.h:115-165): argmin_T sum w |a - T(b)|^2."""
    return ransac._procrustes(a_pts, b_pts, weights)


def points_as_cells(pts, mask, point_cov=0.02**2):
    """Scan points -> isotropic pseudo-gaussians for P2D registration
    (the NDTMatcherP2D measurement model)."""
    cov = torch.eye(2, dtype=torch.float32, device=pts.device) * point_cov
    return CellList(means=pts, covs=cov.repeat(pts.shape[0], 1, 1),
                    mask=mask)


def match_p2d(tgt: d2d.DenseTarget, pts, mask, T_init,
              map_params: NDTMapParams, m: MatcherParams) -> d2d.NewtonResult:
    """Point-to-distribution registration (configs[0] of BASELINE.md):
    the points of one scan, as pseudo-cells, against the dense target
    from T_init.  The reference minimises d2d_score_dense with autodiff
    derivatives; here the analytic window term gives the same
    derivatives to rounding, and the whole registration is one
    `newton_solve` launch on the card (d2d.match_window).  The Newton
    loop projects its Hessians with d2d._psd_project's guard, in the
    kernel too: the reference's projection can leave a Hessian
    indefinite by rounding, and then stops at the start (2 of 9 of its
    runs from the canonical odometry moved by k * 1e-6 do; the port's
    unguarded projection does there too), where the guarded one
    converges to the reference's other runs' pose."""
    src = points_as_cells(pts.contiguous(), mask.contiguous())
    h, w = tgt.valid.shape
    return d2d.match_window(tgt.packed, tgt.origin, h, w,
                            map_params.resolution, src, T_init, m,
                            psd_guard=True)


def extrinsic_calibration_score(scan_a_pts, scan_a_mask, scan_b_pts,
                                scan_b_mask, rel_base_motion, offsets):
    """Score candidate laser->base extrinsics over a scan pair.

    For extrinsic E, points of scan b mapped through
    E^-1 ∘ (base motion) ∘ E should align with scan a: the score is the
    mean squared nearest-neighbour distance over b's valid points (the
    ScanPair::scoreICP objective, laser2d_extrinsic_calibration.cpp:
    85-120).  The (C, Nb, Na) squared distances are written out as
    differences (no |a|^2 + |b|^2 - 2ab expansion, which cancels in
    float32 and moves the minima), in chunks of candidates of at most
    CALIB_CHUNK_ELEMS elements.

    offsets: (C, 3) candidate extrinsics.  Returns (C,) scores."""
    rel = rel_base_motion.to(torch.float32)
    ax, ay = scan_a_pts[:, 0], scan_a_pts[:, 1]
    n_b, n_a = scan_b_pts.shape[0], scan_a_pts.shape[0]
    per = max(1, CALIB_CHUNK_ELEMS // max(n_b * n_a, 1))
    out = []
    for c in range(0, offsets.shape[0], per):
        E = offsets[c:c + per]                                    # (c, 3)
        T = se2.compose(se2.inverse(E), se2.compose(rel, E))
        moved = se2.transform_points(T, scan_b_pts)               # (c, Nb, 2)
        dx = moved[..., 0, None] - ax
        dy = moved[..., 1, None] - ay
        d2 = torch.where(scan_a_mask, dx * dx + dy * dy, torch.inf)
        nn = d2.amin(-1)                                          # (c, Nb)
        ok = scan_b_mask & torch.isfinite(nn)
        out.append(torch.where(ok, nn, 0.0).sum(-1)
                   / torch.clamp(ok.sum(-1), min=1))
    return torch.cat(out)


def candidate_grid(search_xy=0.5, search_theta=0.3, n=9, device=None):
    """The (n^3, 3) offset candidates: an n x n x n grid over
    [-search_xy, search_xy]^2 x [-search_theta, search_theta], x-major
    (torch.linspace: the reference's XLA linspace differs from it by an
    ulp at some candidates)."""
    lin = lambda r: torch.linspace(-r, r, n, dtype=torch.float32,  # noqa: E731
                                   device=device)
    gx, gy, gt = torch.meshgrid(lin(search_xy), lin(search_xy),
                                lin(search_theta), indexing="ij")
    return torch.stack([gx.ravel(), gy.ravel(), gt.ravel()], -1)


def calibrate_extrinsic(scan_pairs, rel_motions, search_xy=0.5,
                        search_theta=0.3, n=9):
    """Grid-search the laser extrinsic over several scan pairs (the
    calibration CLI's offset sweep).  scan_pairs: list of
    ((pts_a, mask_a), (pts_b, mask_b)); rel_motions: list of (3,) base
    motions.  Returns (best_offset (3,), scores (C,)); the first
    candidate wins a tie."""
    dev = scan_pairs[0][0][0].device
    cand = candidate_grid(search_xy, search_theta, n, dev)
    total = torch.zeros(cand.shape[0], device=dev)
    for ((pa, ma), (pb, mb)), rel in zip(scan_pairs, rel_motions):
        total = total + extrinsic_calibration_score(
            pa, ma, pb, mb,
            torch.as_tensor(rel, dtype=torch.float32, device=dev), cand)
    return cand[torch.argmin(total)], total
