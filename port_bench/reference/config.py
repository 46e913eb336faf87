"""The reference's parameters: a frozen copy of the port's parameter
dataclasses (the same names, fields and defaults).  The benchmark fills
them from a configuration file, as it fills the port's own."""

from __future__ import annotations

import dataclasses
import math

def _replace(obj, **kw):
    return dataclasses.replace(obj, **kw)


@dataclasses.dataclass(frozen=True)
class MotionParams:
    """Eliazar-style odometry covariance parameters.

    Same notation as the reference (motion_model.hpp:123-163): variance
    {C: sideways, D: forward, T: rotation} from {d: distance, t: rotation}.
    """

    Cd: float = 0.001
    Ct: float = 0.001
    Dd: float = 0.005
    Dt: float = 0.005
    Td: float = 0.001
    Tt: float = 0.001

    replace = _replace


@dataclasses.dataclass(frozen=True)
class NDTMapParams:
    """Fixed-shape dense NDT grid geometry.

    Replaces NDTMap/LazyGrid construction params (resolution, map sizes —
    ndt_feature_fuser_hmt.h:64-68) with a static (H, W) cell grid.
    """

    resolution: float = 0.5
    size_x: float = 70.0       # metres; submap extent (local maps are
    size_y: float = 70.0       # sensor_range + 3*resolution sized in the
    sensor_range: float = 30.0  # reference, fuser_hmt.h:232)
    min_points_per_cell: int = 3
    max_points_per_scan: int = 1024   # static capacity of a projected scan
    max_cells: int = 1024             # static capacity of compacted cell lists
    # Occupancy log-odds increments (ndt_map semantics: hit/miss updates
    # along beams; values chosen to saturate similarly to log-odds 0.6/0.4).
    occ_hit: float = 0.85
    occ_miss: float = -0.4
    occ_clamp: float = 10.0
    ray_samples: int = 48             # free-space samples per beam

    @property
    def grid_h(self) -> int:
        return int(round(self.size_y / self.resolution))

    @property
    def grid_w(self) -> int:
        return int(round(self.size_x / self.resolution))

    replace = _replace


@dataclasses.dataclass(frozen=True)
class MatcherParams:
    """D2D / fusion matcher knobs (matchFusion signature defaults,
    ndt_matcher_d2d_fusion.h:797-804; NDTMatcherD2D lfd scaling)."""

    itr_max: int = 30
    delta_score: float = 1e-4
    n_neighbours: int = 2
    step_control: bool = True
    line_search_evals: int = 10       # reference More-Thuente: maxfev=40
    lfd1: float = 1.0                 # Gaussian-overlap amplitude d1
    lfd2: float = 0.05                # Gaussian-overlap exponent scale d2
    use_ndt: bool = True
    use_feat: bool = True
    use_odom: bool = True             # soft-constraint Mahalanobis prior
    tikhonov: bool = False
    # Scale on the inverse-Hessian pose covariance (cov_from_hessian).
    # FITTED against Monte-Carlo re-registration spread at lidar-class
    # observation noise sigma = 0.03 m (geometric mean of MC/Hessian
    # diagonal ratios over 3 worlds x 96 trials = 0.59; with 0.6 every
    # measured ratio falls within 2x — tests/test_link_covariance.py).
    # CAVEAT: the NDT score Hessian is nearly noise-BLIND (curvature is
    # set by map structure/cell quantization, not sigma), while the
    # true estimator spread scales ~sigma^2 — measured ratios move
    # ~0.1 -> ~0.6 -> ~2 across sigma 0.01/0.03/0.06.  The fit is
    # calibrated AT 0.03; a sensor much cleaner/noisier than that
    # should rescale (the principled extension is the M-estimator
    # sandwich H^-1 J H^-1).  Solver safety never rests on this:
    # spd_info_np floors + link_info_eps cap the information.
    cov_scale: float = 0.6
    use_pallas: bool = False          # the JAX package's switch for its
                                      # Pallas kernel; not read by the
                                      # port, whose CUDA tensors always go
                                      # through ops/cuda_kernels.py.

    replace = _replace


@dataclasses.dataclass(frozen=True)
class FeatureParams:
    """FLIRT-equivalent feature stack parameters.

    Detector defaults mirror flirtlib_utils.h:15-35 (curvature detector
    scale=5 octaves, base sigma=0.2, step=1.4; peak finder 0.34/0.001) and
    the beta-grid descriptor 4x12 polar bins over rho in [0.02, 1.0]
    (flirtlib_utils.h:44-52).
    """

    num_beams: int = 720
    max_range: float = 30.0
    # Detector
    num_scales: int = 5
    base_sigma: float = 0.2
    sigma_step: float = 1.4
    peak_min_value: float = 0.34
    peak_min_diff: float = 0.001
    max_features: int = 32
    smooth_half_beams: int = 48   # static half-width of the arc-length
                                  # smoothing window (beams)
    # Descriptor (beta grid)
    min_rho: float = 0.02
    max_rho: float = 1.0
    rho_bins: int = 4
    phi_bins: int = 12
    # Descriptor statistic: "beta_mean" = per-bin Beta posterior mean
    # (one histogram); "hitmiss" = separately-normalized hit and miss
    # histograms concatenated (carries the evidence counts the way
    # flirtlib's BetaGrid does, conversions.cpp:234-258 — chi2 on the
    # concatenation equals the average of the per-histogram chi2s).
    # The recall study in EVAL.md justifies the default.
    descriptor_stat: str = "beta_mean"
    # RANSAC (fuser parameterization, fuser_hmt.h:213; flirtlib_ros and
    # startup_loc variants are produced via replace()).
    ransac_acceptance: float = 0.0599   # inlier residual^2 gate (m^2)
    ransac_success_prob: float = 0.9
    ransac_inlier_ratio: float = 0.1
    ransac_dist_threshold: float = 0.6  # descriptor chi2 gate
    ransac_rigidity: float = 0.0499
    ransac_hypotheses: int = 256        # padded parallel hypothesis capacity
    # flirtlib's adaptive success-probability termination flag (the
    # reference constructs every matcher with adaptive=false, e.g.
    # fuser_hmt.h:213); even when false the (success_prob, inlier_ratio)
    # pair sets the hypothesis budget N = log(1-p)/log(1-w^2).
    ransac_adaptive: bool = False
    max_correspondences: int = 64

    replace = _replace


@dataclasses.dataclass(frozen=True)
class FuserParams:
    """Scan-to-submap fuser (NDTFeatureFuserHMT::Params equivalents)."""

    ndt: NDTMapParams = NDTMapParams()
    matcher: MatcherParams = MatcherParams()
    features: FeatureParams = FeatureParams()
    motion: MotionParams = MotionParams()
    check_consistency: bool = True
    max_translation_norm: float = 1.0
    max_rotation_norm: float = math.pi / 4.0
    fuse_incomplete: bool = False
    force_odom_as_est: bool = False
    all_matches_valid: bool = False
    feature_cov_xy: float = 2e-4      # fixed pseudo-cell covariance,
    feature_cov_theta: float = 1e-4   # fuser_hmt.cpp:249
    feature_map_update_incr: int = 4  # append features every 4th update
                                      # (ndt_feature_map.h:64)
    # Rolling-map mode (NDTMapHMT equivalent): keep the submap window
    # following the vehicle instead of fixed in the world.  When the
    # vehicle drifts more than `roll_margin` metres from the window
    # centre, the grid is recentred on it by whole cells on device
    # (ops/ndt_map.recenter) — unbounded-trajectory tracking with one
    # fixed-shape grid (perception_oru NDTMapHMT tile window; disabled
    # in the reference's shipped configs, gustav_laser_tf.launch:47).
    rolling_map: bool = False
    roll_margin: float = 10.0
    # Sensor-window-bounded gather bank for the BATCHED fleet path
    # (fuser.update_batch): when > 0, each stream's win-row gather
    # table is built over a (gather_window_cells)^2 cell window
    # centred on the predicted pose (clamped inside the grid) instead
    # of the whole grid.  A scan only ever touches the sensor disc
    # (~2*sensor_range/resolution + window cells), so the full-map
    # table mostly holds rows no gather will read.  The port reads the
    # packed table directly and only checks the window's coverage
    # (fuser.check_params).  EXACT when the window covers every
    # source cell's (2n+1)^2 neighbourhood, i.e.
    #   gather_window_cells >= 2*(sensor_range/resolution
    #                             + n_neighbours + slack)
    # with slack covering Newton trial wander (trial poses beyond the
    # slack lose those cells' score contributions — the same effect as
    # leaving the map).  0 = full-grid table.
    gather_window_cells: int = 0
    # Store the fleet path's derived win-row table in bfloat16 with
    # CELL-RELATIVE means (mean - cell centre, bounded by resolution
    # so bf16 quantization is ~resolution/256 ~ 2 mm at 0.5 m;
    # absolute bf16 means at 100 m coordinates would quantize at
    # ~0.4 m and are never used).  A table layout of the JAX package;
    # the port's packed table stays float32.
    gather_table_bf16: bool = False
    # Win-BLOCK gather table for the fleet path (requires
    # gather_window_cells > 0): each table row carries a cell's whole
    # (2n+1)^2 neighbourhood, so the per-trial Newton gather issues
    # ONE row per source cell.  A table layout of the JAX package: the
    # port's kernel gathers the window rows from the packed table, which
    # is what that layout is exact to.
    gather_block: bool = False
    # Occupancy update cadence for the BATCH (fleet) drivers: the
    # log-odds ray scatter costs ray_samples (48) transactions per
    # beam — ~34.5k per stream per scan, ~50x the point-stats scatter
    # — and occupancy feeds only the graph overlap scores / map export
    # / badness monitor, never the registration.  1 = every scan
    # (reference parity, NDTMap per-scan update); k > 1 = the batch
    # drivers apply the occupancy update on every k-th scan only
    # (log-odds accumulate 1/k as fast — a serving-quality knob, not a
    # pose-accuracy one); 0 = occupancy off.  Single-stream paths
    # always update per scan.
    occ_every: int = 1
    # Static cell budget for the MATCHER's source cell list (the
    # per-scan local NDT): when > 0, registration uses only the first
    # `match_cell_budget` rows of the compacted CellList.  EXACT
    # whenever the scan's valid-cell count stays within the budget
    # (compaction puts valid cells first) — the padded max_cells
    # capacity is a safety bound, and at the canonical op point scans
    # fill ~10-20% of it, so the window gather (the per-scan hot cost)
    # was mostly masked padding.  bench.py verifies no scan exceeds
    # the budget before using it (honesty gate).  0 = full capacity.
    match_cell_budget: int = 0

    replace = _replace

