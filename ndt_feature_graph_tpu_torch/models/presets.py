"""Model presets: the framework's named operating points (port of
ndt_feature_graph_tpu/models/presets.py; the same names, the same
parameters, the port's own dataclasses).

  p2d_registration    single scan-pair P2D registration
  ndt_odometry        sequential D2D odometry (NDT + odometry, no
                      features)
  feature_graph_slam  full graph SLAM with feature loop closures at the
                      canonical parameter set (0.5 m cells, 100x100 m,
                      30 m range)
  offline_mapper      offline mapping defaults (node split 2 m, the
                      offline validation gates)
  fleet_serving       multi-robot fleet serving: the batched drivers
                      (scan_driver.run_sequence_batch /
                      run_sequence_features_batch) with the reference's
                      sensor-window-bounded win-block bfloat16 gather
                      bank, which the port reads as bfloat16 rows of its
                      packed table (fuser._bf16_rows)
  mcl_localizer       NDT-MCL particle localization
  canonical_slam      feature_graph_slam at the canonical operating point
"""

from __future__ import annotations

from ndt_feature_graph_tpu_torch.config import (
    FeatureParams,
    FuserParams,
    GraphParams,
    MatcherParams,
    MotionParams,
    NDTMapParams,
    SLAMParams,
)


def _canonical_ndt(num_beams=720):
    return NDTMapParams(
        resolution=0.5,
        size_x=100.0,
        size_y=100.0,
        sensor_range=30.0,
        max_points_per_scan=max(num_beams, 512),
        max_cells=1024,
    )


def p2d_registration(num_beams=720) -> tuple:
    """(map params, matcher params) for single-pair P2D registration."""
    return _canonical_ndt(num_beams), MatcherParams()


def ndt_odometry(num_beams=720) -> FuserParams:
    """NDT + odometry scan-to-submap odometry (no features)."""
    return FuserParams(
        ndt=_canonical_ndt(num_beams),
        matcher=MatcherParams(use_feat=False),
        features=FeatureParams(num_beams=num_beams, max_range=30.0),
        motion=MotionParams(),
    )


def feature_graph_slam(
    num_beams=720, new_node_dist=10.0, max_nodes=64
) -> SLAMParams:
    """Full online graph SLAM (node split 10 m by default)."""
    return SLAMParams(
        fuser=FuserParams(
            ndt=_canonical_ndt(num_beams),
            matcher=MatcherParams(),
            features=FeatureParams(num_beams=num_beams, max_range=30.0),
            motion=MotionParams(),
        ),
        graph=GraphParams(
            new_node_transl_dist=new_node_dist, max_nodes=max_nodes
        ),
    )


def offline_mapper(num_beams=720) -> SLAMParams:
    """Offline mapping defaults (node split 2 m, offline gates)."""
    p = feature_graph_slam(num_beams, new_node_dist=2.0)
    return p.replace(
        graph=p.graph.replace(
            valid_max_score=0.1,
            valid_max_dist=1.0,
            valid_max_angular_dist=0.2,
            valid_min_idx_dist=2,
        )
    )


def fleet_serving(num_beams=720, features=True) -> FuserParams:
    """Multi-robot fleet serving operating point: the batched drivers
    with a 256-cell match budget and the 136-cell windowed win-block
    bfloat16 gather bank.  Serve large fleets through
    parallel/scaling.serve_fleet_interleaved for the per-robot latency
    contract."""
    return FuserParams(
        ndt=_canonical_ndt(num_beams),
        matcher=MatcherParams(use_feat=features),
        features=FeatureParams(num_beams=num_beams, max_range=30.0),
        motion=MotionParams(),
        match_cell_budget=256,
        gather_window_cells=136,
        gather_table_bf16=True,
        gather_block=True,
    )


def mcl_localizer(num_beams=720):
    """(map params, motion params) for NDT-MCL localization."""
    return _canonical_ndt(num_beams), MotionParams()


def canonical_slam() -> SLAMParams:
    return feature_graph_slam()
