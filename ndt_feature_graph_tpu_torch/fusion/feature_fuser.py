"""Feature-aware fuser: joint NDT + feature + odometry fusion per scan
(port of ndt_feature_graph_tpu/fusion/feature_fuser.py).

The previous scan's interest points are RANSAC-matched against the
current scan's, gated against odometry, turned into paired
fixed-covariance pseudo-cells and minimized jointly with the NDT and
odometry terms.  The RANSAC draws `u` (M, 2) are an argument: the
reference's per-scan PRNG key has no torch counterpart.  `update_batch`
is the same step for B independent streams at once (the reference vmaps
its feature half): every function here takes a leading stream dimension.
"""

from __future__ import annotations

import dataclasses

import torch

from ndt_feature_graph_tpu_torch.config import FuserParams
from ndt_feature_graph_tpu_torch.features import descriptor, detector, ransac
from ndt_feature_graph_tpu_torch.fusion import fuser
from ndt_feature_graph_tpu_torch.io import dataset


@dataclasses.dataclass
class FeatureFuserState:
    base: fuser.FuserState
    prev_feats: detector.FeatureSet   # sensor frame of the previous scan
    prev_desc: torch.Tensor           # (..., F, D)
    prev_pose: torch.Tensor           # (..., 3) Tnow at the previous scan


def initialize(params: FuserParams, init_pose, sensor_pose, ranges,
               hit) -> FeatureFuserState:
    pts, mask = dataset.scan_to_points(ranges, hit)
    base = fuser.initialize(params, init_pose, sensor_pose, pts, mask)
    feats = detector.detect(params.features, ranges, hit)
    desc = descriptor.describe(params.features, feats, ranges, hit)
    return FeatureFuserState(base=base, prev_feats=feats, prev_desc=desc,
                             prev_pose=base.Tnow)


def _prepare_features(state: FeatureFuserState, params: FuserParams,
                      Tmotion, ranges, hit, u):
    """Scan projection + detect + describe + RANSAC + odometry-
    consistency gate + paired pseudo-cells, for one stream or over a
    leading stream dimension (u then (..., M, 2)).  On the card the
    feature front end is three launches: the detector, the descriptor,
    and the matcher with the gate in its epilogue.

    Returns (pts, mask, feats, desc, feat_src, feat_tgt, res)."""
    fp = params.features
    pts, mask = dataset.scan_to_points(ranges, hit)
    feats = detector.detect(fp, ranges, hit)
    desc = descriptor.describe(fp, feats, ranges, hit)
    # RANSAC's T maps current sensor frame -> previous sensor frame;
    # the gate compares it with odometry in the vehicle frame.
    gate = ransac.OdometryGate(
        sensor_pose=state.base.sensor_pose, motion=Tmotion,
        prev_pose=state.prev_pose,
        max_translation=params.max_translation_norm / 10.0,
        max_rotation=params.max_rotation_norm / 4.0,
        check=params.check_consistency, cov_xy=params.feature_cov_xy)
    res, feat_src, feat_tgt = ransac.match_sets_gated(
        fp, state.prev_feats, state.prev_desc, feats, desc, u, gate)
    return pts, mask, feats, desc, feat_src, feat_tgt, res


def update(state: FeatureFuserState, params: FuserParams, Tmotion, ranges,
           hit, u, update_map: bool = True):
    """One scan update with feature matching; `u` (M, 2) are this scan's
    RANSAC draws.  Returns (new_state, UpdateInfo, MatchResult)."""
    pts, mask, feats, desc, feat_src, feat_tgt, res = _prepare_features(
        state, params, Tmotion, ranges, hit, u
    )
    base, info = fuser.update(state.base, params, Tmotion, pts, mask,
                              feat_src=feat_src, feat_tgt=feat_tgt,
                              update_map=update_map)
    new_state = FeatureFuserState(base=base, prev_feats=feats,
                                  prev_desc=desc, prev_pose=base.Tnow)
    return new_state, info, res


def update_batch(states: FeatureFuserState, params: FuserParams, Tmotion,
                 ranges, hit, u, update_map: bool = True, occ_on=None):
    """One full-pipeline scan update for B independent streams: the
    feature half over the stream dimension, the joint registration
    through fuser.update_batch with each stream's own feature pairs.
    states: (B, ...) on every field; Tmotion (B, 3); ranges, hit
    (B, beams); u (B, M, 2) the streams' RANSAC draws; `occ_on` as
    fuser.update_batch.  Returns (new_states, infos, match results)."""
    pts, mask, feats, desc, feat_src, feat_tgt, res = _prepare_features(
        states, params, Tmotion, ranges, hit, u
    )
    base, info = fuser.update_batch(states.base, params, Tmotion, pts, mask,
                                    feat_src=feat_src, feat_tgt=feat_tgt,
                                    update_map=update_map, occ_on=occ_on)
    new_states = FeatureFuserState(base=base, prev_feats=feats,
                                   prev_desc=desc, prev_pose=base.Tnow)
    return new_states, info, res
