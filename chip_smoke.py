"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--out DIR]

Runs on a machine with a CUDA card and no JAX:

  1. prints the card (nvidia-smi name, power limit) and torch/CUDA versions;
  2. builds the CUDA kernels from csrc/ (nvcc, sm_90a) and times the build;
  3. holds each kernel entry against its plain PyTorch twin on the card at
     the main path's shapes — a real canonical fuser state's packed table
     with N=256 source cells x K=25 window cells, 64 feature pairs, the
     odometry information — plus edge cases (each term of the objective
     switched off in turn; all pairs masked; an empty feature list;
     windows of 9 and 49 cells; windows crossing the grid edge; two
     calls, identical bits), and times kernel vs plain in turns (plain,
     kernel, kernel, plain) beside the bound of the run's own inputs;
     then the whole registration `newton_solve` at that case against
     its plain twin and against the per-trial path (d2d.newton_match
     over `newton_objective`): each term off, step control off,
     bfloat16 rows, two calls identical, the per-trial path's bits and
     |Δd| within SOLVE_TOL of the plain twin (see held_to_all), times in
     turns beside the per-trial path's;
  4. drives the main path (NDTFeatureGraphSLAM.initialize +
     run_sequence_device) over the canonical 200-scan fixture with the
     JAX reference's RANSAC draws, checks that `newton_solve` launched
     once per registration, `segment_add_rows` once per statistics
     update and `occupancy_update` once per occupancy update (counted
     by `map_updates`), each feature kernel once a scan (detect and
     describe also at initialize: 200, 200 and 199 launches; each
     launch a call of its function, counted by `map_updates`, a check
     every phase that runs the map update or the features makes), and
     no other entry, that the
     frozen-node count matches JAX and that the trajectory stays within
     1 cm / 5 mrad of the JAX trajectory, and reports ATE and scans/s
     (one warm-up run, then the median of 3); the checked run counts
     its synchronising calls (torch.cuda.set_sync_debug_mode("warn")),
     none of them inside newton_solve, and records each registration's
     inputs for phase 3's replay: every registration through the
     kernel (the recorded bits again), the per-trial path and the plain
     twin, the kernel held to the per-trial path scan by scan;
     3e. the map update through its kernels (`segment_add_rows` for
         the statistics, `occupancy_update` for the occupancy;
         add_points_touched + update_occupancy of three canonical
         scans, into one grid and stacks of 3 and 64; the occupancy's
         edge cases, occupancy_cases, at 1, 3 and 64 grids, at the
         wrapper's cluster size, at 1-16 blocks a stream and on the
         two-pass path, and a 1,200 x 1,200 grid that takes the
         two-pass path by shape; a scatter
         with 5,000 entries on one cell; the segment sum's layouts,
         segment_layout_cases) on the card equals the CPU's
         bit for bit, equals the parent's path (the sorted index_put_
         statistics, the occupancy's plain twin through
         segment_add_rows) and repeats, one launch of each a scan; one
         scan's update and a B = 64 fleet step's timed in turns against
         the parent's path and the atomic index_add, with their device
         operations, and each kernel entry on those shapes beside its
         bound (segment_sum_checks: by the profiler's names only its
         two passes run, no sort, with each pass's time and a cold-L2
         time; occupancy_checks: one launch a call, timed also against
         the two-pass path, and the longest chain of the occupancy's
         rows); torch.sqrt of 2^20 float32
         values on the card equals numpy.sqrt (0 elements differ);
     3f. the feature front end's kernels (csrc/features.cu:
         `detect_features`, `describe_features`, `match_features`)
         against their plain twins (detector._detect_plain,
         descriptor._describe_plain, ransac._match_sets_plain and
         _gate_plain) on the card: detect and describe on the 200
         canonical scans in one call and scan by scan (a scan alone =
         its row), the hitmiss statistic, describe of the kernel's own
         features; match on the 199 consecutive pairs with the fixture's
         draws (a pair alone = its row), with the adaptive budget, and
         on the 171 candidate pairs of phase 9e's bank (128 features a
         node); the gate on the 199 pairs; a B = 64 fleet step through
         feature_fuser._prepare_features against the twins' path; a
         second call's bits; the same bits at every cluster size the
         wrappers choose (detect on 1, 32, 64, 100 and 200 scans a call,
         its arc and smoothed points too; match on 1, 20, 40 and 199
         pairs a call and the LC bank pair by pair), each scan and pair
         equal to its row; describe at 128, 256, 512 and 1,024 threads
         a feature equal to the wrapper's choice, and its bits on
         examples/describe_bits.py's inputs equal to the first design's
         (DESCRIBE_FIRST_DESIGN_SHA256); the stage splits of the feature
         kernels and the occupancy kernel (probe builds).  Selected beams, masks, scales,
         correspondences, inliers, counts and validity equal (a
         differing choice is named with the twin's own margin and must
         lie within FEATURE_ULPS); points and angles within 2e-5,
         responses rtol 1e-4, descriptors rtol 1e-5 / atol 1e-6, T
         within 1e-5, scores rtol 1e-5, the pseudo-cells within 1e-5.
         How ATen rounds on the card what the kernels mirror (a pair's
         vector_norm; exp, cos, sin, atan2, log1p against the kernels'
         CUDA library functions: rounding_probe).
         Device time in turns with the twins at the main path's shapes
         (one scan; one pair with the gate: the kernels line's times)
         and batched (200 scans, 32 and 64 as a fleet step's, 199 pairs,
         the LC bank), beside each bound; the stage split of the
         detector and the matcher at those shapes, from a probe build
         (examples/probe_feature_stages.py --stages, its own process);
     the three timed runs repeat the first run's trajectory bit for bit
     and its launch counts;
     3c. plain registration on that graph: d2d.match_d2d +
         covariance_d2d of its last frozen node against the final
         submap's packed table (the `fgh_dense_flat` entry), and
         `fgh_paired` on its own (the `pair_fgh_reduce` entry), kernel
         against plain;
  5. offline loop closure: builds bench.py's offline graph (a node every
     0.25 m) with pipeline.run_slam and checks its node count, then
     3b. holds the batched entry `fgh_dense_flat_batch` against its plain
         twin on that node bank at the offline shapes (the ~170 candidate
         pairs and 1024 lanes x the source-cell budget x K=25, an
         all-masked lane, a lane on the bank's last node, windows across
         the grid edge; determinism) and times kernel vs plain;
     5a. runs optimize_offline on the reference's own graph (its node
         bank, poses and edges, from canonical_lc.npz) with the JAX
         draws: the same candidate pairs and RANSAC poses, the refined
         links' summed D2D cost within 2% of JAX's, the kept-link set,
         the optimized node poses and the port's solve of JAX's own
         links (1 cm / 5 mrad);
     runs optimize_offline on the port's graph with the JAX draws and
     checks the kept-link set, the optimized node poses (1 cm / 5 mrad
     of the nearer of two JAX solutions: the record, and the record
     with the odometry moved by 1e-6, the reference's own spread) and
     node ATE (it halves and stays within 1 cm of JAX's); a link may
     be kept differently only where JAX's value lies within 1e-3 of a
     gate or the link's refined pose moved beyond 1 cm / 5 mrad from
     JAX's; prints the optimize_offline wall time (median of 3) and
     propose -> refine -> rescore pairs/s at B=256 and 1024;
  6. online loop closure (bench.py's bench_online_lc setting,
     run_sequence_chunked with chunk=64): trajectory and node poses
     within 1 cm / 5 mrad of JAX, the same node and loop-link counts,
     `newton_solve` and `fgh_dense_flat_batch` launched; scans/s
     (median of 3);
  7. fleet serving at bench.py's fleet operating point (the canonical
     parameters with bfloat16 gather rows; 40 scans of a 720-beam loop per
     stream, from canonical_fleet.npz), first
     3d. `newton_objective_batch` against its plain twin on the card at
         a fleet step's shapes, B = 8 and 64 lanes x 256 source cells x
         K=25 + 64 feature pairs + the odometry term per lane: each term
         off in turn, bfloat16 rows on and off, an all-masked lane, a
         lane with an empty feature list, a lane whose windows cross the
         grid's edge, two calls with identical bits, times in turns;
         and `newton_solve_batch` on those lanes against its plain twin
         and the per-trial lockstep path, lane by lane as phase 3;
     then the points-only driver run_sequence_batch at B = 8 against the
     JAX record (bfloat16 rows on and off: nine poses in ten within
     2 mm / 1 mrad, the tolerance the reference holds its own batch path
     to, none beyond 5 cm / 20 mrad — the LM stop test fires at rounding
     noise, see fleet_dev; the reference's own spread under an odometry
     change of 1e-6 / 1e-5, 2-3 mm here, is in the record and printed
     beside), at B = 32 and 64
     (streams 0-7 equal the B = 8 run's; at B = 32 a second run of the
     same inputs, and whether it repeats every trajectory, stream 21's
     with the reference's bistable scan among them) and at B = 32 with
     occ_every=4 (the same poses): only `newton_solve_batch`
     launches, once per fleet step; aggregate scans/s at each B
     (median of 3);
     7b. the full pipeline run_sequence_features_batch at B = 8 against
         the JAX record with its RANSAC draws, then B = 32;
     7c. serve_fleet_interleaved(group_size=8, time_chunk=8) and
         serve_fleet_grouped(group_size=8) over 20 streams (a padded last
         group): the same trajectories, equal to the matching streams of
         the B = 32 run;
  8. rolling_map: the first 60 scans of the main-path fixture through
     run_sequence_features with a 70 m window and a 0.6 m margin, so
     that the window recentres at least twice, against the same run on
     the CPU's plain versions; the packed table equals packed_from_grid
     of the final grid;
  9. offline optimization at scale (canonical_solver.npz, made from the
     JAX package by examples/make_torch_port_fixture.py --solver):
     (a) optimize_direct on bench.py's 570-node multi-loop graph, rebuilt
         from its numpy recipe (max_seg_len 64, 12 iterations, dcs):
         within 1 cm / 5 mrad of JAX's poses and 1% of its chi2;
     (b) the same on the reference's 4,000-node two-lap graph (stored;
         max_seg_len 128, 25 iterations).  After 25 iterations its LM
         still random-walks along a near-null mode of the graph: the
         reference's own poses move 0.3-0.6 m when its initial poses move
         by 1e-6, and over 32 such runs its ATE ratio spans 0.35-0.64 (3
         not under 0.6) and its chi2 0.12551-0.12767.  So every factor's
         relative pose is held to JAX's within 1 cm / 5 mrad (the
         reference's own runs agree to 0.06 mm), chi2 to the reference's
         range widened by TWO_LAP_RTOL, and the ATE must fall; the ATE
         ratio and the absolute distance are printed;
     (c) the two-lap recipe at 10,000 nodes with numpy noise, held to the
         reference's runs on the same input (the record has their chi2
         and ATE): chi2 and the ATE ratio within their ranges widened by
         TWO_LAP_RTOL.  At this size the solve raises the aligned ATE
         1.35x for the reference too (the laps' common drift is not
         observable from lap-to-lap closures), so the reference test's
         0.6 is printed, not required;
     for (a)-(c) the solve's wall time (median of 3 after a warm-up,
     each ending in a synchronisation) and the device operations of one
     LM iteration;
     (d) optimize_offline with solver="direct" and solver_max_seg_len=4
         on JAX's own loop-closure graph (as phase 5a), then its solve on
         JAX's links within 1 mm of JAX's direct solve;
     (e) _propose_links with link_group_nodes=8 (link_batch_size=16) on
         that bank with the JAX chunks' draws, by phase 5a's link rules;
     (f) that graph saved and loaded back: identical arrays;
     (g) the CLI in this process — slam --optimize, optimize, export-map,
         eval — on the canonical sequence written as a sequence npz: the
         `optimize` output within 1 cm / 5 mrad of the port's own
         optimize_offline of the same checkpoint;
     `fgh_dense_flat_batch` launches in (d), (e) and (g) are printed and
     must be > 0;
 10. localization at the canonical point (canonical_localize.npz, made
     from the JAX package by make_torch_port_fixture.py --localize):
     cli localize's map of the first half and 32-scan database, the
     distance field exactly, relocalize + badness of scan 67 on JAX's
     draws, MCL (512 particles) over the second half on JAX's recorded
     draws within the reference's own spread; MCL steps/s and the ms of
     relocalize, build_distance_map and adjust_pose (localization
     launches no kernel entry);
 11. the HMT tile store (canonical_hmt.npz, --hmt): HMTFuser over a
     481-scan out-and-back corridor at the canonical sensor against the
     JAX run, a save / load / spill / exact recall on the card, and a
     resume from the directory JAX wrote; scans/s and recentre ms;
     11b. the CLI's `localize` (tracking and --kidnapped) and `fuse`
     (plain, --hmt-dir, --resume) in this process on the canonical
     sequence;
 12. the simulator and the inputs (canonical_io.npz, made from the JAX
     package by make_torch_port_fixture.py --io):
     12a. bench.make_sequence()'s 200 x 720 corridor simulated on the card
          with the reference's recorded draws against canonical_200.npz:
          ground truth identical, odometry within 1e-6, ranges within
          2e-5 m and hits identical but on grazing and oblique beams
          (grazing_beams, counts printed); then the main path on it,
          within 1 cm / 5 mrad of the JAX trajectory, launching only
          `newton_solve`;
     12b. bench_offline_570's 7,040-scan multi-loop at 720 beams: the
          noise-free raycast at 64 recorded poses under the same rule;
          the simulator's scans/s (median of 3) and peak memory;
     12c. cli simulate -> cli slam, and the canonical sequence written
          as .clf and .bag by the port's writers through cli slam,
          within 1 cm / 5 mrad of the npz run;
 13. P2D registration and the calibration:
     13a. match_p2d of scan 20's 720 points against build_from_scan of
          scan 0 from the composed odometry: within 1 mm / 1 mrad of
          JAX's pose, both converged, `fgh_dense_flat` launched once per
          trial and no other entry; the entry at N = 720 x K = 25
          against its plain twin (identical bits on repeat, all-masked
          zero), timed in turns beside its bound;
     13b. cli calibrate at its defaults: the 343 scores within rtol
          1e-5 of JAX's and the best offset JAX's up to the candidates
          its scores cannot tell apart (the corridor leaves x and y
          unobservable: 49 tie); the ms of one calibration;
 14. the 6-DoF surface and the utilities (canonical_6dof.npz, made from
     the JAX package by make_torch_port_fixture.py --6dof):
     14a. se3 on the card against the CPU; match_d2d_3d, unclamped and
          with force2d, of three links the reference kept in the LC
          record's offline graph at their full padded cell lists (1,024
          x 1,024 pairs, lifted to z = 0 with z variance 0.01): within 1
          cm / 5 mrad of JAX's pose (or its own spread under a 1e-6
          start change), its covariance within 2% of its largest entry,
          the clamp within 2 cm / 20 mrad of the port's SE(2) D2D
          matcher on the pair (with the guarded PSD projection); ms,
          trials and peak memory of each registration;
          no kernel entry launches;
     14b. cli slam --plot --html on the canonical sequence (overview.png,
          viewer.html); the viewer's payload of the reference's LC graph
          and desc_string equal to the JAX record; a GraphLogger over 40
          scans with the JAX draws (a line a scan, its trajectory's
          poses, within 1 cm / 5 mrad of JAX's) and a device_trace;
 15. the multi-device programs in an NCCL world of one rank (NCCL refuses
     two ranks on one card, so no reduction crosses cards here), each
     equal bit for bit to the single-device program it shards: the
     dense and Schur solves at 570 nodes and optimize_direct_sharded at
     570, 4,000 and 10,000 nodes (its chi2 also within the reference's
     range at the last two), the sharded link proposals of phase 9e's
     bank (compute_links_batch on the same draws), the sharded fleet
     (run_sequence_batch; measure_fleet_throughput at 64 streams through
     the sharded path, whose newton_solve_batch launches are the
     kernels line's `launches_sharded_fleet`), the mesh placement
     names (global_put / global_get / sharded / replicated), and
     examples/multihost_worker_torch.py in an NCCL world of its own;
 16. the reference's last public entry points: (a) run_graph_chunk over
     the canonical 200 scans in chunks of 16, split_node between
     chunks, against phase 4: the trajectory, frozen nodes and their
     origins the same bits, one newton_solve launch a scan and no other
     entry (the kernels line's `launches_chunked`), scans/s of both
     paths in turns; (b) compute_link on each candidate pair of the
     reference's LC node bank equal to its compute_links_batch rows at
     batches of 4, 64 and 171 pairs (pose, validity, score and overlap
     count), the proposals launching `overlap_score` alone; then the
     overlap score at 1, 4, 64, 171 and 1,024 pairs: the kernel (by its
     size rule), its pair path and its group path (groups of the rule's
     size, 4 below 160 pairs) against the eager path + `row_sum` (the
     parent's) and the eager path + torch.sum, every cell index and
     count equal, the scores within OVERLAP_SCORE_TOL, every path's
     scores and counts equal to overlap_mirror (the pair path's order) bit for
     bit, device time in turns on a warm and a cold L2 beside the
     bound; the kernel against its numpy mirror
     (tests/test_torch_overlap.py) bit for bit on small grids and edge
     cases; compute_links_batch and rescore_links with the kernel and
     with the parent's path in turns, with their device operations; and
     `row_sum` against torch.sum on the eager overlap matrix; (c) HMTMap.add_scan over phase 11's
     first 64 scans equal to the map HMTFuser builds; (d)
     to_paired_cells and se2.dist / angular_dist, card against CPU;
 17. link refinement and the plain registrations in one launch:
     (a) the refinements recorded in phases 5 (optimize_offline), 9e
         (the grouped chunks) and 6 (the online proposals), each through
         refine_links_d2d (one `newton_solve_batch` launch with the
         Hessian at each lane's result, no synchronising call) and
         through the per-trial lockstep it replaces (a
         `fgh_dense_flat_batch` launch a trial, a stop read a 6-trial
         chunk, a launch for the Hessian): the lanes whose T, cov and
         mask keep the per-trial path's bits on every lane (the solve's
         LM step rounds as the lockstep's eager operations), but for
         lanes named where the lockstep itself is unstable, held as
         phase 3 holds the solves (held_to_all); the Hessian written
         the objective's at the result; the first four lanes of each
         call refined alone equal to their rows; the blocks a lane (by
         its shape) and the persistent clusters; for the largest call
         of each path every lane's trials, refine_links_d2d's ms in
         turns with the lockstep and the solve's launch alone;
     (b) match_d2d (phase 3c's case) and match_p2d (phase 13a's, the
         guarded projection in the kernel) in one `newton_solve` launch
         against their per-trial loops (poses within MATCH_ONE_TOL, the
         same trials), ms in turns; P2D within P2D_JAX_TOL of JAX's pose
         and converged from the record's eight perturbed starts;
 18. prints one JSON line of all kernel entries and, last, the result
     line.

A kernel's `ms` and `plain_ms` are device times (torch.profiler: the
summed time of the kernels a call launches, mean over many calls);
`events_ms` adds the host's launch gaps (CUDA events around a run of
calls).  `bound_ms` is the larger of the bytes the call must move (each
input read once: the distinct table rows its windows touch, its cell
lists, its scalars; 13 floats written) over 3.35 TB/s and its
operations (FLOPS_PER_PAIR for each unmasked, in-bounds, valid pair)
over 67 TFLOP/s: NVIDIA's H100 SXM figures; a solve's operations are
those of every trial it evaluates, lane by lane.  No single PyTorch
call computes a D2D entry, nor the overlap score, so their `library_ms`
is null (`overlap_score`'s `ms` / `plain_ms` are its and the eager path
+ `row_sum`'s on a cold L2, its `warm_ms` / `device_ms` beside them);
`row_sum`'s is torch.sum's (no path launches it since `overlap_score`:
its `yardstick_launches` are phase 16b's eager path), `segment_add_rows`'s index_add's (atomic on the card;
its entry also carries the sorted index_put_ path's time,
`sorted_ms`), `occupancy_update`'s the index_add of its plain twin's
entries (the scatter alone, not the ray build; its `plain_ms` is the
plain twin on the card, the parent's path).  The per-trial
objectives (`newton_objective[_batch]`) are the body of the solves and
no path's own launch any more: their `launches` are 0, and the launches
of the per-trial path that the script drives as the solves' yardstick
(phase 3's replay, phase 3d) stand apart as `yardstick_launches`.

Exits non-zero (and prints no result) without a CUDA card or if any
phase fails.  With --out DIR the details also go to DIR/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import importlib.util
import io
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from ndt_feature_graph_tpu_torch.config import (
    FeatureParams, FuserParams, GraphParams, MotionParams, NDTMapParams,
    SLAMParams,
)
from ndt_feature_graph_tpu_torch import cli, interop, pipeline
from ndt_feature_graph_tpu_torch.core import se2, se3
from ndt_feature_graph_tpu_torch.features import (
    descriptor, detector, ransac,
)
from ndt_feature_graph_tpu_torch.features import (
    distance as features_distance,
)
from ndt_feature_graph_tpu_torch.fusion import (
    feature_fuser, fuser, scan_driver,
)
from ndt_feature_graph_tpu_torch.graph import links as links_mod
from ndt_feature_graph_tpu_torch.graph import node as node_mod
from ndt_feature_graph_tpu_torch.graph import optimize as opt_mod
from ndt_feature_graph_tpu_torch.graph import schur, sparse_direct
from ndt_feature_graph_tpu_torch.graph.slam import NDTFeatureGraphSLAM
from ndt_feature_graph_tpu_torch.io import (
    carmen, dataset, rosbag, serialize, tum,
)
from ndt_feature_graph_tpu_torch.io.dataset import Sequence
from ndt_feature_graph_tpu_torch.models import presets
from ndt_feature_graph_tpu_torch.fusion.hmt_driver import HMTFuser
from ndt_feature_graph_tpu_torch.localization import mcl, monitor, place_rec
from ndt_feature_graph_tpu_torch.ops import (
    cuda_kernels, d2d, d2d3d, d2d_analytic, ndt_map,
)
from ndt_feature_graph_tpu_torch.ops.hmt import HMTMap
from ndt_feature_graph_tpu_torch.ops.ndt_map import CellList
from ndt_feature_graph_tpu_torch.parallel import (
    links_sharded, scaling, schur_sharded, solver_sharded,
    sparse_direct_sharded,
)
from ndt_feature_graph_tpu_torch.parallel import mesh as mesh_mod
from ndt_feature_graph_tpu_torch.utils import pairwise
from ndt_feature_graph_tpu_torch.utils.logging_ext import (
    GraphLogger, desc_string,
)
from ndt_feature_graph_tpu_torch.utils.timers import (
    StageTimers, device_trace,
)
from ndt_feature_graph_tpu_torch.viz import html as viz_html

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE_REL = "ndt_feature_graph_tpu_torch/data/canonical_200.npz"
FIXTURE = os.path.join(ROOT, FIXTURE_REL)
LC_FIXTURE_REL = "ndt_feature_graph_tpu_torch/data/canonical_lc.npz"
LC_FIXTURE = os.path.join(ROOT, LC_FIXTURE_REL)
FLEET_FIXTURE_REL = "ndt_feature_graph_tpu_torch/data/canonical_fleet.npz"
FLEET_FIXTURE = os.path.join(ROOT, FLEET_FIXTURE_REL)
FLEET_SIZES = (8, 32, 64)     # bench.py's fleet cells, points only
FLEET_FULL_SIZES = (8, 32)    # ... and of the full pipeline
FLEET_SERVE = dict(streams=20, group_size=8, time_chunk=8)
FLEET_STREAM = 21             # the B = 32 stream with the bistable scan
# Fleet trajectories and scores vs the JAX record and between runs on
# the card: the reference's own batch-path tolerances
# (tests/test_scan_driver.py) for nine tenths of the poses, and a bound
# on every pose (fleet_dev says why).
FLEET_XY_TOL, FLEET_TH_TOL = 2e-3, 1e-3
FLEET_XY_MAX, FLEET_TH_MAX = 5e-2, 2e-2
FLEET_SCORE_RTOL, FLEET_SCORE_ATOL = 3e-2, 1e-2
ROLLING = dict(scans=60, size_m=70.0, roll_margin=0.6)
OFFLINE_SPLIT_M = 0.25        # bench.py bench_offline's graph
LC_GRAPH = dict(online_loop_closure=True, valid_min_idx_dist=1,
                online_lc_candidate_dist=20.0)   # bench_online_lc's
BIG_B = 1024                  # the batch entry's widest check
RATE_B = (256, 1024)          # pairs/s batch widths (bench_offline's)
SOURCE = "ndt_feature_graph_tpu_torch/csrc/pair_fgh.cu"
REPLACES = "ndt_feature_graph_tpu/ops/pallas_kernels.py:149"
# The row-sum kernel ports no TPU kernel: the reference's overlap sum,
# which it leaves to XLA.
ROW_SUM_REPLACES = "ndt_feature_graph_tpu/graph/links.py:138"
# Nor does the map statistics' fixed-order sum: the reference's
# scatter, XLA's `.at[flat].add` (add_points_touched).
SEGMENT_SOURCE = "ndt_feature_graph_tpu_torch/csrc/segment_sum.cu"
SEGMENT_REPLACES = "ndt_feature_graph_tpu/ops/ndt_map.py:115"
# Nor does the occupancy update: the reference's ray scatter, XLA's
# `.at[flat].add(...).at[rflat].add(...)` in update_occupancy.
OCCUPANCY_SOURCE = "ndt_feature_graph_tpu_torch/csrc/occupancy.cu"
OCCUPANCY_REPLACES = "ndt_feature_graph_tpu/ops/ndt_map.py:166"
# Nor does the overlap score: the reference's occupancy_overlap_score /
# _overlap_score_flat, which it leaves to XLA (its sum: ROW_SUM_REPLACES).
OVERLAP_SOURCE = "ndt_feature_graph_tpu_torch/csrc/overlap.cu"
OVERLAP_REPLACES = "ndt_feature_graph_tpu/graph/links.py:99"
F_RTOL = 1e-4                 # tests/test_pallas_kernels.py tolerances
GH_RTOL, G_ATOL, H_ATOL = 2e-3, 1e-4, 1e-3
CANCEL_RTOL = 1e-3            # batch lanes: see compare()
XY_TOL, TH_TOL = 0.01, 0.005  # trajectory vs the JAX reference
MATCH_TOL, COV_RTOL = 1e-4, 1e-3   # match_d2d pose, covariance_d2d
HBM_BYTES_PER_S, F32_FLOP_PER_S = 3.35e12, 67e12   # H100 SXM data sheet
# A dependent float32 add takes 4 cycles; the H100 SXM's SM boost clock
# is 1,980 MHz (data sheet): the occupancy kernel's chain bound.
ADD_CYCLES, SM_CLOCK_HZ = 4, 1.98e9
# Operations of one pair, counted from pair_components in the source:
# ~165 multiplies and adds of the algebra and the sums, one divide and
# one exp counted as ~17 each.
FLOPS_PER_PAIR = 200
# Phases 12-13 (examples/make_torch_port_fixture.py --io): the simulator,
# the inputs, P2D registration and the extrinsic calibration.
IO_FIXTURE = os.path.join(ROOT, "ndt_feature_graph_tpu_torch/data/canonical_io.npz")
ML570 = dict(n_loops=10, steps_per_loop=704, radius=2.8)  # bench_offline_570
P2D_SOURCE = 20               # scan 20's points against the map of scan 0
P2D_TOL = 1e-3                # metres and radians, against JAX's pose
P2D_JAX_TOL = 1e-5            # phase 17b: P2D in one launch against JAX's
P2D_EPS = tuple(s * k * 1e-6 for k in range(1, 5) for s in (1, -1))
                              # ... the record's eight perturbed starts
MATCH_ONE_TOL = 1e-6          # phase 17b: one launch vs the per-trial loop
L2_FLUSH_BYTES = 256 << 20    # read before a cold-L2 time: 5x the H100's L2
CALIB_RTOL = 1e-5             # the calibration's summed scores
# The simulator against the reference (phase 12, tests/test_torch_simulator.py):
# ranges within RANGE_TOL metres and hits equal on every beam but the
# grazing and the oblique ones (grazing_beams), odometry within ODOM_TOL;
# under MAX_DIFFER of the beams may differ.
RANGE_TOL, ODOM_TOL, MAX_DIFFER = 2e-5, 1e-6, 1e-3
GRAZE_U, GRAZE_T = 1e-5, 1e-4
# An oblique beam's range moves beyond RANGE_TOL when its direction turns
# by this many ulps of its float32 angle (the frameworks' linspace differs
# by one at a few beams of a scan, as dataset.beam_angles says) and one of
# sin / cos.
ANGLE_ULPS = 2
CELL_BYTES = 8 + 16 + 1       # a cell's mean, covariance and mask
# newton_solve[_batch] against the per-trial path (the same objective
# kernel, the LM step in eager ops): |Δd| in metres and radians, unless
# the per-trial path itself moves that far when its start moves by
# SOLVE_EPS.
SOLVE_TOL, SOLVE_EPS = 1e-4, 1e-6


# Phase 9, offline at scale.  (a) bench.py's 570-node multi-loop graph
# (bench.py:518-551); (b) the reference's 4,000-node two-lap graph
# (tests/test_sparse_solver.py:169-219, its arrays in the record);
# (c) the two-lap recipe at 10,000 nodes with numpy noise; (d) the
# direct solver on the canonical loop-closure graph; (e) grouped link
# proposals on that bank.
# Phase 10, localization (cli.py cmd_localize at the canonical point), and
# phase 11, the HMT tile store (HMTFuser on an out-and-back corridor):
# examples/make_torch_port_fixture.py --localize / --hmt.
LOCALIZE_FIXTURE = os.path.join(
    ROOT, "ndt_feature_graph_tpu_torch/data/canonical_localize.npz")
HMT_FIXTURE = os.path.join(ROOT,
                           "ndt_feature_graph_tpu_torch/data/canonical_hmt.npz")
BADNESS_TOL = 1e-5            # metres
SQRT_N = 1 << 20              # fault 1: float32 roots checked on the card
SOLVER_FIXTURE_REL = "ndt_feature_graph_tpu_torch/data/canonical_solver.npz"
SOLVER_FIXTURE = os.path.join(ROOT, SOLVER_FIXTURE_REL)
MULTI_LOOP = dict(n_nodes=570, max_seg_len=64, iterations=12,
                  robust_kernel="dcs")
TWO_LAP = dict(n_nodes=4000, max_seg_len=128, iterations=25)
TWO_LAP_BIG = 10000
DIRECT_GRAPH = dict(solver="direct", solver_max_seg_len=4)
GROUPED_GRAPH = dict(link_batch_size=16, link_group_nodes=8)
DIRECT_TOL = 1e-3             # (d): the solve on JAX's links, metres
# (b), (c): the reference's own range of chi2 and of the ATE ratio over its
# runs from initial poses moved by k * 1e-6, widened by this much (the
# port's runs on the CPU reach 2.5% above the reference's highest chi2).
TWO_LAP_RTOL = 0.05


SIXDOF_FIXTURE_REL = "ndt_feature_graph_tpu_torch/data/canonical_6dof.npz"
SIXDOF_FIXTURE = os.path.join(ROOT, SIXDOF_FIXTURE_REL)
SIXDOF_LINKS = 3              # phase 14a: accepted links of the LC record
SIXDOF_Z_VAR = 0.01           # the lift of a planar cell (test_d2d3d.py)
PAYLOAD_MAX_CELLS = 50        # phase 14b: the viewer's subsampled payload
LOGGER_SCANS = 40             # phase 14b: the GraphLogger's scans
SCHUR_BLOCKS = 8              # phase 15: the Schur solve's blocks
CHUNK = 16                    # phase 16: run_graph_chunk's chunk length
CHUNK_TOL = 1e-5              # ... its poses past a scan that is not phase 4's
CHUNK_LINK_PAIRS = 64         # phase 16: the wider compute_links_batch
HMT_ADD_SCANS = 128           # phase 16: add_scan over phase 11's first scans


def lift_cells(means, covs, mask, compact=False):
    """Planar gaussians (N, 2), (N, 2, 2), (N,) as 3D cells: z = 0, z
    variance SIXDOF_Z_VAR (numpy, float32); `compact` drops the masked
    padding (whose pairs add exactly zero to the 6-DoF score)."""
    means, covs, mask = (np.asarray(x) for x in (means, covs, mask))
    if compact:
        means, covs, mask = means[mask], covs[mask], mask[mask]
    n = len(mask)
    m3 = np.zeros((n, 3), np.float32)
    m3[:, :2] = means
    c3 = np.zeros((n, 3, 3), np.float32)
    c3[:, :2, :2] = covs
    c3[:, 2, 2] = SIXDOF_Z_VAR
    return {"means": m3, "covs": c3, "mask": mask.astype(bool)}


def sixdof_links(lc):
    """Phase 14a's links: the first, middle and last link the reference
    kept in the LC record's offline graph."""
    kept = np.nonzero(lc["off_keep"])[0]
    return kept[np.linspace(0, len(kept) - 1, SIXDOF_LINKS).round().astype(
        int)]


def multi_loop_graph(n_nodes=570, seed=0):
    """bench.py's synthetic multi-loop pose graph (bench.py:518-551):
    eight laps of a 5 m circle, odometry between consecutive nodes and a
    closure from every node to the one a lap later, 1 cm measurement
    noise, 5 cm initial noise, information 100 I.  Returns (init (N, 3),
    i, j, meas (E, 3), info diagonal (E,)), numpy, float32."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 8 * 2 * np.pi, n_nodes)
    gt = np.stack([5 * np.cos(th), 5 * np.sin(th), np.zeros(n_nodes)],
                  -1).astype(np.float32)
    per_loop = n_nodes // 8
    li = np.arange(0, n_nodes - per_loop - 2)
    i = np.concatenate([np.arange(n_nodes - 1), li]).astype(np.int32)
    j = np.concatenate([np.arange(1, n_nodes), li + per_loop]).astype(
        np.int32)
    meas = np.zeros((i.shape[0], 3), np.float32)
    for k in range(i.shape[0]):
        d = gt[j[k]] - gt[i[k]]
        c, s = np.cos(gt[i[k], 2]), np.sin(gt[i[k], 2])
        meas[k] = [c * d[0] + s * d[1], -s * d[0] + c * d[1], d[2]]
    meas += rng.normal(0, 0.01, meas.shape).astype(np.float32)
    init = gt + rng.normal(0, 0.05, gt.shape).astype(np.float32)
    return init, i, j, meas, np.full(i.shape[0], 100.0, np.float32)


def two_lap_graph(n, seed=7, every=20):
    """The reference's two-lap square (tests/test_sparse_solver.py
    _two_lap_slam_problem) with numpy noise: 1 m steps, noisy odometry
    (5 mm, 0.5 mrad; information 50 I), clean lap-to-lap closures every
    `every` nodes (information 200 I), the drifted dead reckoning as the
    initial estimate.  Returns (gt, init, i, j, meas, info diagonal),
    numpy, float32."""
    rng = np.random.default_rng(seed)
    lap = n // 2
    side = lap // 4
    rels = []
    for _ in range(2):
        for _ in range(4):
            rels.extend([[1.0, 0.0, 0.0]] * (side - 1))
            rels.append([1.0, 0.0, np.pi / 2])
    rels = np.asarray(rels[: n - 1], np.float32)

    def chain(steps):
        out = [np.zeros(3, np.float32)]
        for r in steps:
            out.append(se2.compose_np(out[-1], r))
        return np.stack(out)

    gt = chain(rels)
    odo = (rels + rng.normal(0, 1, rels.shape)
           * [0.005, 0.005, 0.0005]).astype(np.float32)
    li = np.arange(0, lap, every)
    lj = li + lap
    i = np.concatenate([np.arange(n - 1), li]).astype(np.int32)
    j = np.concatenate([np.arange(1, n), lj]).astype(np.int32)
    meas = np.concatenate([odo, se2.sub_np(gt[li], gt[lj])])
    info = np.concatenate([np.full(n - 1, 50.0), np.full(len(li), 200.0)])
    return gt, chain(odo), i, j, meas, info.astype(np.float32)


def ate_aligned(p, gt):
    """RMSE after an SE(2) alignment (Umeyama, no scale) — the
    reference's metric for the two-lap graph, which removes the gauge
    mode a single-anchor graph only weakly observes."""
    P = np.asarray(p[:, :2], np.float64)
    G = np.asarray(gt[:, :2], np.float64)
    mp, mg = P.mean(0), G.mean(0)
    U, _, Vt = np.linalg.svd((P - mp).T @ (G - mg))
    R = Vt.T @ np.diag([1, np.sign(np.linalg.det(Vt.T @ U.T))]) @ U.T
    Pa = (P - mp) @ R.T + mg
    return float(np.sqrt(np.mean(np.sum((Pa - G) ** 2, -1))))


def canonical_slam_params(split_m=2.0, max_nodes=64, **graph) -> SLAMParams:
    """bench.canonical_params() (0.5 m cells, 100x100 m map, 30 m range,
    720 beams, 256-cell match budget, 136-cell f32 win-block gather) in
    the bench's graph setting (`graph`: further GraphParams fields) —
    rebuilt here because bench.py imports JAX."""
    fp = FuserParams(
        ndt=NDTMapParams(resolution=0.5, size_x=100.0, size_y=100.0,
                         sensor_range=30.0, max_points_per_scan=720,
                         max_cells=1024),
        features=FeatureParams(num_beams=720, max_range=30.0),
        match_cell_budget=256, gather_window_cells=136, gather_block=True,
    )
    return SLAMParams(fuser=fp, graph=GraphParams(
        new_node_transl_dist=split_m, max_nodes=max_nodes, **graph))


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps=200):
    """Mean ms per call by CUDA events over `reps` calls, after warm-up."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


PROFILE_WARMUP_S = 0.02   # device_by_kernel: calls before the profiled ones
SPIN_CYCLES = 20_000      # its spin kernels, ~10 us at 1,980 MHz


def device_ms(fn, reps=50, launches=None):
    """Mean device time per call, ms: the summed time of the kernels
    `fn` launches (torch.profiler), without the host's launch gaps.
    `launches`: as device_by_kernel's."""
    return sum(us for _, us in device_by_kernel(fn, reps, launches)
               .values()) * 1e-3


def cold_ms(fn, flush, reps=50):
    """Mean device time per call of `fn` on a cold L2, ms: `flush` runs
    before each call, and CUDA events bracket the call alone.  The flush
    outlasts the host's enqueueing of the call, so no launch gap falls
    between the events."""
    fn()
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in marks:
        flush()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in marks) / reps


def time_turns(kernel, plain, reps=50, plain_reps=10, label="plain",
               launches=None, plain_launches=None):
    """Kernel and plain version timed in turns (plain, kernel, kernel,
    plain) inside this one call.  Returns the means as {"ms",
    "plain_ms"} (device time) and {"events_ms", "plain_events_ms"}
    (with the host), and prints every reading; `label` names the
    other version; `launches` / `plain_launches`: the device operations
    a call of each must show in its profiles (device_by_kernel)."""
    dev_t = [device_ms(plain, plain_reps, plain_launches),
             device_ms(kernel, reps, launches),
             device_ms(kernel, reps, launches),
             device_ms(plain, plain_reps, plain_launches)]
    ev_t = [time_ms(plain, plain_reps), time_ms(kernel, reps),
            time_ms(kernel, reps), time_ms(plain, plain_reps)]
    fmt = lambda t: ", ".join(f"{x * 1e3:.2f}" for x in t)  # noqa: E731
    print(f"    device time, us ({label}, kernel, kernel, {label}): "
          f"{fmt(dev_t)}; with the host (CUDA events): {fmt(ev_t)}")
    return {"ms": (dev_t[1] + dev_t[2]) / 2,
            "plain_ms": (dev_t[0] + dev_t[3]) / 2,
            "events_ms": (ev_t[1] + ev_t[2]) / 2,
            "plain_events_ms": (ev_t[0] + ev_t[3]) / 2}


def bound(n_bytes, n_pairs):
    """The least time the card could take for a call that must move
    `n_bytes` and evaluate `n_pairs` pairs: {"bound_ms", "bound_by"}."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_pairs * FLOPS_PER_PAIR / F32_FLOP_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def window_work(d, T0, src, packed, origins, row_offsets, h, w, res, nb,
                lanes=False):
    """What the window term of this call needs, for its bound: (bytes
    of the distinct table rows the unmasked source cells' windows read
    plus the cell lists, pairs that are unmasked, in bounds and valid).
    Works for one lane or (B, ...) lanes; `lanes` gives the pairs of
    each lane, (B,)."""
    o = origins if origins.dim() == 1 else origins[:, None, :]
    _, iy0, ix0 = d2d_analytic.window_cells(d, T0, src, o, res)
    offs = torch.arange(-nb, nb + 1, device=d.device)
    iy = iy0[..., None, None] + offs[:, None]
    ix = ix0[..., None, None] + offs[None, :]
    inb = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    flat = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
    if row_offsets is not None:
        flat = flat + row_offsets[:, None, None, None]
    live = src.mask[..., None, None].expand_as(flat)
    rows = torch.unique(flat[live])
    valid = (packed[flat][..., 5] > 0.5) & inb & live
    n_bytes = 32 * rows.numel() + CELL_BYTES * src.mask.numel()
    if lanes:
        return n_bytes, valid.flatten(1).sum(1)
    return n_bytes, int(valid.sum())


def grazing_beams(segments, poses, num_beams, max_range):
    """(..., B) int8, by a float64 recomputation of dataset.raycast at
    the same float32 beam angles: 1 where the beam grazes (the nearest
    segment it reaches, u within GRAZE_U outside [0, 1] counting as
    reached, is met within GRAZE_U of an end; or its two nearest hits lie
    within GRAZE_T of each other; or its nearest hit lies within GRAZE_T
    of max_range); 2 where it is oblique (it meets its segment so
    obliquely that its range moves by more than RANGE_TOL when its
    direction turns by ANGLE_ULPS ulps of its float32 angle plus one of
    sin / cos, which the frameworks' linspace and trigonometry differ
    by); 0 elsewhere."""
    f64 = torch.float64
    host = lambda x: torch.tensor(np.asarray(  # noqa: E731
        x.cpu() if isinstance(x, torch.Tensor) else x))
    seg = host(segments).to(f64)
    P = host(poses).to(torch.float32)
    lead = P.shape[:-1]
    P = P.reshape(-1, 3)
    ang32 = P[:, 2:3] + dataset.beam_angles(num_beams, device="cpu")
    ang = ang32.to(f64)
    dx, dy = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
    x0, y0, x1, y1 = seg.unbind(-1)
    ex, ey = x1 - x0, y1 - y0
    denom = dx * -ey + dy * ex
    ok = denom.abs() > 1e-12
    safe = torch.where(ok, denom, 1.0)
    rx = (x0 - P[:, 0:1].to(f64))[:, None, :]
    ry = (y0 - P[:, 1:2].to(f64))[:, None, :]
    t = (rx * -ey + ry * ex) / safe
    u = (dx * ry - dy * rx) / safe
    reach = ok & (u >= -GRAZE_U) & (u <= 1 + GRAZE_U) & (t > 1e-6)
    near = torch.where(reach, t, torch.inf).topk(2, dim=-1, largest=False)
    t1, t2 = near.values[..., 0], near.values[..., 1]
    first = near.indices[..., :1]
    u1 = u.gather(-1, first)[..., 0]
    edge = (u1.abs() <= GRAZE_U) | ((u1 - 1).abs() <= GRAZE_U)
    hit = torch.isfinite(t1)
    graze = hit & (edge | (t2 - t1 <= GRAZE_T)
                   | ((t1 - max_range).abs() <= GRAZE_T))
    # dt/dangle = t (d . e) / (d x e) for the nearest segment.
    along = (dx * ex + dy * ey).gather(-1, first)[..., 0]
    across = denom.gather(-1, first)[..., 0].abs()
    turn = (ANGLE_ULPS * torch.from_numpy(
        np.spacing(np.abs(ang32.numpy()))).to(f64) + 2.0 ** -24)
    oblique = hit & (t1 < max_range) & (
        t1 * along.abs() * turn > RANGE_TOL * across)
    kind = torch.where(graze, 1, torch.where(oblique, 2, 0)).to(torch.int8)
    return kind.reshape(*lead, num_beams).numpy()


def check_beams(name, rng, hit, ref_rng, ref_hit, kind):
    """Every beam that differs from the reference (the hit flag, or the
    range beyond RANGE_TOL) grazes or is oblique (grazing_beams' `kind`),
    and under MAX_DIFFER of the beams differ.  Returns {"differ",
    "grazing", "oblique"}: the differing beams, and how many of them are
    of each kind."""
    rng, hit, ref_rng, ref_hit = (np.asarray(torch.as_tensor(x).cpu())
                                  for x in (rng, hit, ref_rng, ref_hit))
    differ = (hit != ref_hit) | (np.abs(rng - ref_rng) > RANGE_TOL)
    out = {"differ": int(differ.sum()),
           "grazing": int((differ & (kind == 1)).sum()),
           "oblique": int((differ & (kind == 2)).sum())}
    print(f"  {name}: {out['differ']} of {differ.size} beams differ from "
          f"the reference (ranges beyond {RANGE_TOL} m or hits): "
          f"{out['grazing']} grazing, {out['oblique']} oblique; "
          f"{int((kind == 1).sum())} grazing and {int((kind == 2).sum())} "
          f"oblique beams in all")
    unexplained = int((differ & (kind == 0)).sum())
    check(unexplained == 0,
          f"{name}: {unexplained} beams that neither graze nor are "
          f"oblique differ")
    check(out["differ"] < MAX_DIFFER * differ.size,
          f"{name}: {out['differ']} of {differ.size} beams differ")
    return out


def compare(name, got, ref, quiet=False, cancel=0.0, f_atol=1e-6):
    """Max abs error of (f, g, H) vs the plain version, within the
    stated tolerances (`f_atol`: the absolute part of f's, for an f that
    cancels between its terms).  `cancel` > 0 widens the absolute
    tolerance of g and H by that share of their largest entry.  Where
    source cells lie
    tens of metres from the lane's pose, one pair's theta-theta Hessian
    term is ~1e6 (lever arm squared times Sig^-1 ~ 1e3) and cancels
    inside the pair; the kernel and the plain version write that algebra
    differently, so each rounds at ~eps x 1e6 per pair, and over
    thousands of pairs an entry of a lane whose largest is ~1e5 differs
    by ~10 (measured 17 of 1.7e5 on the card)."""
    (f, g, H), (fr, gr, Hr) = got, ref
    f, g, H, fr, gr, Hr = (x.double().cpu().numpy()
                           for x in (f, g, H, fr, gr, Hr))
    g_atol = G_ATOL + cancel * float(np.abs(gr).max())
    h_atol = H_ATOL + cancel * float(np.abs(Hr).max())
    ok = (np.allclose(f, fr, rtol=F_RTOL, atol=f_atol)
          and np.allclose(g, gr, rtol=GH_RTOL, atol=g_atol)
          and np.allclose(H, Hr, rtol=GH_RTOL, atol=h_atol))
    err = float(max(np.abs(f - fr).max(), np.abs(g - gr).max(),
                    np.abs(H - Hr).max()))
    if not quiet:
        print(f"  {name}: max_abs_err {err:.3e} (f {float(f):.6f} vs "
              f"{float(fr):.6f})")
    check(ok, f"{name}: kernel disagrees with its plain version\n"
              f"f {f} vs {fr}\ng {g} vs {gr}\nH {H} vs {Hr}")
    return err


def random_pairs(n, dev, seed=0):
    """`n` random SPD Gaussian pairs (as tests/test_pallas_kernels.py)."""
    rng = np.random.default_rng(seed)
    mu = 0.5 * rng.standard_normal((n, 2))
    L = 0.2 * rng.standard_normal((n, 2, 2))
    Sig = L @ L.transpose(0, 2, 1) + 0.05 * np.eye(2)
    m_rot = 3.0 * rng.standard_normal((n, 2))
    Lc = 0.2 * rng.standard_normal((n, 2, 2))
    Crot = Lc @ Lc.transpose(0, 2, 1) + 0.02 * np.eye(2)
    ok = rng.random(n) < 0.7
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    return t(mu), t(Sig), t(m_rot), t(Crot), torch.as_tensor(ok, device=dev)


def feature_pairs(T0, dev, n=64, seed=0):
    """`n` feature pseudo-cells as feature_fuser builds them (fixed
    2e-4 covariances, about 60% of the pairs unmasked): source features
    in the vehicle frame and targets a few centimetres from where T0
    puts them."""
    rng = np.random.default_rng(seed)
    src = rng.normal(0, 5, (n, 2)).astype(np.float32)
    covs = np.tile(np.eye(2, dtype=np.float32) * 2e-4, (n, 1, 1))
    mask = rng.random(n) < 0.6
    x, y, th = T0.cpu().numpy()
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    tgt = (src @ rot.T + [x, y] + rng.normal(0, 0.03, (n, 2))).astype(
        np.float32)
    t = lambda x_, dt=torch.float32: torch.as_tensor(  # noqa: E731
        x_, dtype=dt, device=dev)
    return (CellList(t(src), t(covs), t(mask, torch.bool)),
            CellList(t(tgt), t(covs), t(mask, torch.bool)))


def trial_case(sp, fx, dev):
    """The inputs of one Newton trial of the main path: a canonical
    fuser state after scan 0, scan 1's local cells at full capacity
    (1,024), its predicted pose and odometry information, an increment
    and 64 feature pairs.  Returns (state, src, T0, Q, d, feat_src,
    feat_tgt)."""
    p = sp.fuser
    T = lambda x, dt=torch.float32: torch.as_tensor(x, dtype=dt, device=dev)
    pts0, mask0 = dataset.scan_to_points(T(fx["ranges"][0]),
                                         T(fx["hit"][0], torch.bool))
    state = fuser.initialize(p, torch.zeros(3, device=dev),
                             torch.zeros(3, device=dev), pts0, mask0)
    pts1, mask1 = dataset.scan_to_points(T(fx["ranges"][1]),
                                         T(fx["hit"][1], torch.bool))
    src, _ = fuser._build_local_cells(p, state.sensor_pose, pts1, mask1)
    T0 = se2.compose(state.Tnow, T(fx["odom"][1]))
    Q = fuser._increment_information(p, T(fx["odom"][1]), T0)
    return (state, src, T0, Q, T([0.02, -0.01, 0.004]),
            *feature_pairs(T0, dev))


def kernel_checks(sp, fx, dev):
    """Phase 3: the single-lane kernel entries vs their plain twins on
    the card.  Returns {entry: {"max_abs_err", and on a CUDA device
    "ms", "plain_ms", "events_ms", "plain_events_ms", "bound_ms",
    "bound_by"}}."""
    p = sp.fuser
    m = p.matcher
    h, w, res = p.ndt.grid_h, p.ndt.grid_w, p.ndt.resolution
    T = lambda x, dt=torch.float32: torch.as_tensor(x, dtype=dt, device=dev)
    state, src, T0, Q, d, feat_src, feat_tgt = trial_case(sp, fx, dev)
    src = src.head(p.match_cell_budget)
    n_valid = int(src.mask.sum())
    check(src.means.shape[0] == 256, "source list is not 256 cells")
    origin = state.grid.origin
    print(f"  packed table {tuple(state.packed.shape)}, N=256 source cells "
          f"({n_valid} valid) x K={(2 * m.n_neighbours + 1) ** 2}, "
          f"{int(feat_src.mask.sum())} of 64 feature pairs unmasked")

    def objective(src_, fs, ft, Q_, m_=m, packed=state.packed):
        args = (d, T0, src_, packed, origin, h, w, res, m_, fs, ft, Q_)
        return (cuda_kernels.newton_objective(*args),
                cuda_kernels.newton_objective_reference(*args))

    got, ref = objective(src, feat_src, feat_tgt, Q)
    err_obj = compare("newton_objective 256x25 + 64 pairs + Q", got, ref)
    again, _ = objective(src, feat_src, feat_tgt, Q)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "newton_objective is not deterministic")
    masked = dataclasses.replace(src, mask=torch.zeros_like(src.mask))
    no_feat = dataclasses.replace(feat_src,
                                  mask=torch.zeros_like(feat_src.mask))
    for name, args in (
            ("window off", (None, feat_src, feat_tgt, Q)),
            ("features off", (src, None, None, Q)),
            ("odometry off", (src, feat_src, feat_tgt, None)),
            ("all source cells masked", (masked, feat_src, feat_tgt, Q)),
            ("empty feature list", (src, no_feat, feat_tgt, Q)),
            ("K=9", (src, feat_src, feat_tgt, Q, m.replace(n_neighbours=1))),
            ("K=49", (src, feat_src, feat_tgt, Q,
                      m.replace(n_neighbours=3)))):
        err_obj = max(err_obj, compare(f"newton_objective, {name}",
                                       *objective(*args)))
    got, _ = objective(masked, no_feat, feat_tgt, None)
    check(all(float(x.abs().max()) == 0.0 for x in got),
          "newton_objective with every pair masked is not exactly zero")

    def dense(d_, src_, origin_, packed=state.packed):
        return (
            cuda_kernels.fgh_dense_flat(
                d_, T0, src_, packed, origin_, h, w, res,
                m.n_neighbours, m.lfd1, m.lfd2),
            d2d_analytic.fgh_dense_flat(
                d_, T0, src_, packed, origin_, 0, h, w, res, m),
        )

    err_dense = compare("fgh_dense_flat N=256 K=25", *dense(d, src, origin))
    k1, _ = dense(d, src, origin)
    k2, _ = dense(d, src, origin)
    check(all(torch.equal(a, b) for a, b in zip(k1, k2)),
          "fgh_dense_flat is not deterministic")
    got, ref = dense(d, masked, origin)
    check(all(float(x.abs().max()) == 0.0 for x in got),
          "all-masked fgh_dense_flat is not exactly zero")
    compare("fgh_dense_flat all masked", got, ref)
    # Roll the table's content 95 rows down and 90 columns left (the
    # mapped room starts at row 94, column 88) and move the origin with
    # it: the scan's cells now straddle the bottom and left grid edges,
    # next to real valid cells.
    edge_packed = state.packed.reshape(h, w, 8).roll(
        (-95, -90), (0, 1)).reshape(h * w, 8).contiguous()
    edge_origin = origin + T([90 * res, 95 * res])
    got, ref = dense(d, src, edge_origin, edge_packed)
    nb = m.n_neighbours
    _, iy0, ix0 = d2d_analytic.window_cells(d, T0, src, edge_origin, res)
    crossing = src.mask & (torch.minimum(iy0, ix0) < nb) & (
        torch.minimum(iy0, ix0) >= -nb)
    check(int(crossing.sum()) > 0 and float(ref[0]) < 0.0,
          "edge case has no window crossing the edge next to valid cells")
    print(f"  {int(crossing.sum())} source windows cross the grid edge")
    compare("fgh_dense_flat windows crossing the grid edge", got, ref)

    mu, Sig, m_rot, Crot, ok = random_pairs(64, dev)
    got = cuda_kernels.pair_fgh_reduce(mu, Sig, m_rot, Crot, ok, m.lfd1,
                                       m.lfd2)
    again = cuda_kernels.pair_fgh_reduce(mu, Sig, m_rot, Crot, ok, m.lfd1,
                                         m.lfd2)
    ref = cuda_kernels.pair_fgh_reduce_reference(mu, Sig, m_rot, Crot, ok,
                                                 m.lfd1, m.lfd2)
    err_pair = compare("pair_fgh_reduce 64 pairs", got, ref)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "pair_fgh_reduce is not deterministic")
    none = torch.zeros_like(ok)
    got = cuda_kernels.pair_fgh_reduce(mu, Sig, m_rot, Crot, none, m.lfd1,
                                       m.lfd2)
    check(all(float(x.abs().max()) == 0.0 for x in got),
          "all-masked pair_fgh_reduce is not exactly zero")

    out = {"newton_objective": {"max_abs_err": err_obj},
           "fgh_dense_flat": {"max_abs_err": err_dense},
           "pair_fgh_reduce": {"max_abs_err": err_pair}}
    if dev.type != "cuda":          # CPU rehearsal: no timing
        return out
    win_bytes, win_pairs = window_work(d, T0, src, state.packed, origin,
                                       None, h, w, res, nb)
    scalars, out_bytes = 4 * (3 + 3 + 2), 4 * 13
    n_feat = feat_src.mask.numel()
    feat_live = int((feat_src.mask & feat_tgt.mask).sum())
    bounds = {
        "newton_objective": bound(
            win_bytes + 2 * CELL_BYTES * n_feat + scalars + 4 * 9 + out_bytes,
            win_pairs + feat_live),
        "fgh_dense_flat": bound(win_bytes + scalars + out_bytes, win_pairs),
        "pair_fgh_reduce": bound(
            ok.numel() * (8 + 16 + 8 + 16 + 1) + out_bytes, int(ok.sum())),
    }
    calls = {
        "newton_objective": (
            lambda: cuda_kernels.newton_objective(
                d, T0, src, state.packed, origin, h, w, res, m, feat_src,
                feat_tgt, Q),
            lambda: cuda_kernels.newton_objective_reference(
                d, T0, src, state.packed, origin, h, w, res, m, feat_src,
                feat_tgt, Q),
        ),
        "fgh_dense_flat": (
            lambda: cuda_kernels.fgh_dense_flat(
                d, T0, src, state.packed, origin, h, w, res,
                m.n_neighbours, m.lfd1, m.lfd2),
            lambda: d2d_analytic.fgh_dense_flat(
                d, T0, src, state.packed, origin, 0, h, w, res, m),
        ),
        "pair_fgh_reduce": (
            lambda: cuda_kernels.pair_fgh_reduce(
                mu, Sig, m_rot, Crot, ok, m.lfd1, m.lfd2),
            lambda: cuda_kernels.pair_fgh_reduce_reference(
                mu, Sig, m_rot, Crot, ok, m.lfd1, m.lfd2),
        ),
    }
    for k, (kf, pf) in calls.items():
        print(f"  {k}: bound {bounds[k]['bound_ms'] * 1e3:.4f} us "
              f"({bounds[k]['bound_by']})")
        out[k].update(time_turns(kf, pf, 200, 20), **bounds[k])
    return out


def bank_lanes(bank, pairs, T0, budget, res, dev):
    """Inputs of the batch entry over `bank` (a stacked node bank): one
    lane per (ref, mov) pair at initial poses T0, with source lists cut
    at `budget` cells, plus three edge-case lanes appended: all source
    cells masked; against the bank's last node; and against a copy of
    the last node whose table is rolled so that its mapped cells start
    at row 0 / column 0, so source windows cross the grid edge next to
    valid cells (the copy joins the bank as one more node).

    Returns (d, T0, src, packed_flat, origins, row_offsets, lanes of the
    three cases)."""
    n, hw = bank.target.packed.shape[:2]
    h, w = bank.occ.shape[1:]
    ref = torch.as_tensor(pairs[:, 0], device=dev)
    mov = torch.as_tensor(pairs[:, 1], device=dev)
    last = n - 1
    tab = bank.target.packed[last].reshape(h, w, 8)
    valid = tab[..., 5] > 0.5
    r0 = int(valid.any(1).nonzero()[0])
    c0 = int(valid.any(0).nonzero()[0])
    edge = tab.roll((-r0, -c0), (0, 1)).reshape(hw, 8)
    packed = torch.cat([bank.target.packed.reshape(-1, 8), edge]).contiguous()
    origins_bank = torch.cat([bank.target.origin, (
        bank.target.origin[last] + res * torch.tensor(
            [c0, r0], dtype=torch.float32, device=dev))[None]])
    b = ref.shape[0]
    ref = torch.cat([ref, torch.tensor([0, last, n], device=dev)])
    mov = torch.cat([mov, torch.tensor([1, 0, last], device=dev)])
    T0 = torch.cat([torch.as_tensor(T0, dtype=torch.float32, device=dev),
                    torch.zeros((3, 3), device=dev)])
    src = CellList(*(x[mov, :budget].contiguous() for x in (
        bank.cells.means, bank.cells.covs, bank.cells.mask)))
    src.mask[b] = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    d = (torch.randn((b + 3, 3), generator=gen, device=dev)
         * torch.tensor([0.05, 0.05, 0.01], device=dev)).contiguous()
    return (d, T0.contiguous(), src, packed, origins_bank[ref].contiguous(),
            (ref * hw).contiguous(), (b, b + 1, b + 2))


def small_bank(sp, fx, dev):
    """A small node bank for checks of the batch entry away from the
    offline graph: four canonical nodes (fusers initialized on fixture
    scans 0, 50, 100, 150 in their node frames, frozen at the
    ground-truth poses), all ordered pairs and their relative poses.
    Returns (bank, pairs (12, 2), T0 (12, 3))."""
    p = sp.fuser
    t = lambda x, dt=torch.float32: torch.as_tensor(  # noqa: E731
        x, dtype=dt, device=dev)
    scans = (0, 50, 100, 150)
    fmap = node_mod.empty_feature_map(16, 48, dev)
    nodes = []
    for s in scans:
        pts, mask = dataset.scan_to_points(t(fx["ranges"][s]),
                                           t(fx["hit"][s], torch.bool))
        st = fuser.initialize(p, torch.zeros(3, device=dev),
                              torch.zeros(3, device=dev), pts, mask)
        nodes.append(node_mod.freeze_node(p, t(fx["gt"][s]), st, fmap))
    pairs = np.asarray([(i, j) for i in range(4) for j in range(4) if i != j])
    gt = t(fx["gt"][list(scans)])
    T0 = se2.sub(gt[pairs[:, 0]], gt[pairs[:, 1]]).cpu().numpy()
    return node_mod.stack_nodes(nodes), pairs, T0


def batch_kernel_checks(bank, pairs, T0, budget, sp, dev, times=True):
    """Phase 3b: `fgh_dense_flat_batch` against its plain twin at the
    offline shapes on a node bank: per-lane (f, g, H) at the stated
    tolerances, determinism (two calls, identical bits), the all-masked
    lane exactly zero, the last-node and grid-edge lanes nonzero.
    Returns the entry's {"max_abs_err"} and, with `times`, its times and
    bound as kernel_checks gives them."""
    p = sp.fuser
    m = p.matcher
    h, w, res = p.ndt.grid_h, p.ndt.grid_w, p.ndt.resolution
    d, T0, src, packed, origins, offs, (masked, last, edge) = bank_lanes(
        bank, pairs, T0, budget, res, dev)
    args = (d, T0, src, packed, origins, offs, h, w, res)
    kernel = lambda: cuda_kernels.fgh_dense_flat_batch(  # noqa: E731
        *args, m.n_neighbours, m.lfd1, m.lfd2)
    plain = lambda: d2d_analytic.fgh_dense_flat_batch(*args, m)  # noqa
    got, again, ref = kernel(), kernel(), plain()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "fgh_dense_flat_batch is not deterministic")
    lanes = d.shape[0]
    print(f"  B={lanes} lanes x N={budget} source cells x "
          f"K={(2 * m.n_neighbours + 1) ** 2}, bank of "
          f"{packed.shape[0] // (h * w)} nodes")
    err = max(compare(f"fgh_dense_flat_batch lane {k}",
                      tuple(x[k] for x in got), tuple(x[k] for x in ref),
                      quiet=k not in (0, masked, last, edge),
                      cancel=CANCEL_RTOL)
              for k in range(lanes))
    check(all(float(x[masked].abs().max()) == 0.0 for x in got),
          "all-masked lane of fgh_dense_flat_batch is not exactly zero")
    _, iy0, ix0 = d2d_analytic.window_cells(
        d[edge], T0[edge], CellList(src.means[edge], src.covs[edge],
                                    src.mask[edge]), origins[edge], res)
    crossing = src.mask[edge] & (torch.minimum(iy0, ix0) < m.n_neighbours)
    check(int(crossing.sum()) > 0 and float(ref[0][edge]) < 0.0
          and float(ref[0][last]) < 0.0,
          "edge lanes have no window crossing the edge next to valid cells")
    print(f"  max_abs_err over {lanes} lanes {err:.3e}; "
          f"{int(crossing.sum())} source windows cross the grid edge")
    out = {"max_abs_err": err}
    if not times:
        return out
    n_bytes, n_pairs = window_work(d, T0, src, packed, origins, offs, h, w,
                                   res, m.n_neighbours)
    out.update(bound(n_bytes + lanes * (4 * (3 + 3 + 2) + 8 + 4 * 13),
                     n_pairs))
    print(f"  fgh_dense_flat_batch B={lanes}: bound "
          f"{out['bound_ms'] * 1e3:.3f} us ({out['bound_by']}; "
          f"{n_bytes / 1e6:.2f} MB, {n_pairs} pairs)")
    out.update(time_turns(kernel, plain, 50, 3))
    return out


def solve_dev(a, b):
    """Per lane, the largest |difference| of two registrations' d (m and
    rad), (..., 3) tensors -> (...) numpy."""
    return (a - b).abs().amax(-1).cpu().numpy()


def start_spread(solve, d_init):
    """How far `solve` (a function of the start increment returning
    (d, score, trials, converged)) moves its d, lane by lane, when its
    start moves by SOLVE_EPS in each of four sign patterns: the
    reference registration's own sensitivity to rounding."""
    base = solve(d_init)[0]
    eps = torch.tensor([[1, 1, 1], [-1, -1, -1], [1, -1, 1], [-1, 1, -1]],
                       dtype=torch.float32, device=d_init.device) * SOLVE_EPS
    return np.max([solve(d_init + e)[0].sub(base).abs().amax(-1)
                   .cpu().numpy() for e in eps], 0)


def _near(got, other):
    """Per lane: (|Δd| of `got` from `other`, score's relative
    difference, whether both are within SOLVE_TOL / F_RTOL)."""
    dev_ = np.atleast_1d(solve_dev(got[0], other[0]))
    rel = np.atleast_1d(((got[1] - other[1]).abs()
                         / other[1].abs().clamp(min=1e-30)).cpu().numpy())
    return dev_, rel, (dev_ <= SOLVE_TOL) & (rel <= F_RTOL)


def held_to(name, got, other, other_solve, d_init, what, label="lane"):
    """Hold `newton_solve[_batch]`'s registrations `got` to `other`'s:
    the per-trial path (d2d.newton_match[_batch] over
    `newton_objective[_batch]`: the same objective kernel, the LM step
    in eager ops) or the plain twin (the same loop over the objective's
    plain version).  Every lane's d within SOLVE_TOL and its score
    within F_RTOL, except lanes where `other` itself moves d beyond
    SOLVE_TOL under a SOLVE_EPS change of its start (`other_solve`, from
    `d_init`): those are named, with both results, and held_to_all
    checks them against the other yardsticks.  `what` names `other` in
    the messages.  Prints the lanes with the same d, score and trials,
    the largest |Δd| and the lanes whose trial counts differ.  Returns
    {"max": the largest |Δd| over the lanes held, "max_all": over every
    lane, "excepted": the excepted lanes, "differ": the lanes whose
    trial counts differ, "same": the count of lanes with the same
    bits}."""
    dev_, rel, near = _near(got, other)
    k_tr = np.atleast_1d(got[2].cpu().numpy())
    o_tr = np.atleast_1d(other[2].cpu().numpy())
    differ = [int(i) for i in np.nonzero(k_tr != o_tr)[0]]
    same = int(np.count_nonzero((dev_ == 0) & (rel == 0) & (k_tr == o_tr)))
    over = np.nonzero(~near)[0]
    excepted = []
    if over.size:
        spread = np.atleast_1d(start_spread(other_solve, d_init))
        excepted = [int(i) for i in over if spread[i] > SOLVE_TOL]
        bad = [int(i) for i in over if spread[i] <= SOLVE_TOL]
        for i in over:
            print(f"    {label} {i}: kernel {got[0].reshape(-1, 3)[i].tolist()}"
                  f" ({k_tr[i]} trials), {what} "
                  f"{other[0].reshape(-1, 3)[i].tolist()} ({o_tr[i]}); the "
                  f"{what} moves {spread[i]:.2e} under a {SOLVE_EPS:g} start "
                  "change")
        check(not bad, f"{name}: {label}s {bad} deviate from the {what} "
                       f"beyond {SOLVE_TOL:g} / rtol {F_RTOL:g} though it is "
                       "stable there")
    held = np.ones(dev_.shape, bool)
    held[excepted] = False
    out = {"max": float(dev_[held].max(initial=0.0)),
           "max_all": float(dev_.max()), "excepted": excepted,
           "differ": differ, "same": same}
    print(f"  {name}: d, score and trials the {what}'s bits at {same} of "
          f"{dev_.size} {label}s; max |Δd| vs the {what} "
          f"{out['max']:.3e} (score rel "
          f"{float(rel[held].max(initial=0.0)):.1e}); trial counts differ at "
          f"{label}s {differ} (kernel {[int(k_tr[i]) for i in differ]}, "
          f"{what} {[int(o_tr[i]) for i in differ]}); beyond {SOLVE_TOL:g} "
          f"where the {what} is itself unstable: {excepted}"
          + (f" (up to {out['max_all']:.3e})" if excepted else ""))
    return out


def held_to_all(name, got, yardsticks, d_init, label="lane", backups=()):
    """Hold `got` to each of `yardsticks` ((what, result, solve)) by
    held_to, then check every lane that some held_to excepted: it must
    be within SOLVE_TOL / F_RTOL of another yardstick or of a result in
    `backups` ((what, result), consulted for those lanes only), or else
    reach a score no worse than every one of them (within F_RTOL): all
    minimise the same objective, so a lane where each yardstick is
    chaotic is still held to something.  Returns held_to's results."""
    outs = [held_to(name, got, other, solve, d_init, what, label)
            for what, other, solve in yardsticks]
    others = [(what, other) for what, other, _ in yardsticks] + list(backups)
    excepted = sorted(set().union(*(o["excepted"] for o in outs)))
    if not excepted:
        return outs
    nears = [_near(got, other)[2] for _, other in others]
    score = np.atleast_1d(got[1].cpu().numpy())
    for i in excepted:
        near = [what for (what, _), n in zip(others, nears) if n[i]]
        if near:
            print(f"    {label} {i}: within {SOLVE_TOL:g} of the "
                  f"{', '.join(near)}")
            continue
        mine = float(score[i])
        scores = {what: float(np.atleast_1d(other[1].cpu().numpy())[i])
                  for what, other in others}
        no_worse = all(mine <= s + F_RTOL * abs(s) for s in scores.values())
        print(f"    {label} {i}: near no yardstick; score {mine!r} against "
              f"{scores}")
        check(no_worse, f"{name}: {label} {i} is near no yardstick and "
                        f"scores worse than one ({mine!r}, {scores})")
    return outs


def solve_checks(sp, fx, dev, times=True):
    """Phase 3: `newton_solve` at phase 3's trial case (N=256 x K=25, 64
    feature pairs, the odometry term) against its plain twin on the card
    and against the per-trial path (held_to_all; the per-trial path's
    bits required: its eager LM step rounds as the kernel's), with each
    term switched off in turn, step control off and bfloat16 rows; two
    calls give identical bits.  Returns the entry's {"max_abs_err"}
    (|Δd| against the plain twin, over the lanes held),
    "plain_unstable" (the cases with lanes excepted) and, with `times`
    on a CUDA device, its times in turns (and the per-trial path's as
    "per_trial_ms") and its bound."""
    p = sp.fuser
    m = p.matcher
    h, w, res = p.ndt.grid_h, p.ndt.grid_w, p.ndt.resolution
    state, src, T0, Q, _, fs, ft = trial_case(sp, fx, dev)
    src = src.head(p.match_cell_budget)
    zero = torch.zeros(3, device=dev)
    base = (src, state.packed, state.grid.origin, h, w, res, m, fs, ft, Q)
    cases = {
        "all terms": base, "window off": (None, *base[1:]),
        "features off": (*base[:7], None, None, Q),
        "odometry off": (*base[:9], None),
        "step control off": (*base[:6], m.replace(step_control=False),
                             *base[7:]),
        "bf16 rows": (*base, True)}
    err, excepted = 0.0, []
    for name, args in cases.items():
        per_solve = per_trial_solve((zero, T0, *args))
        got = cuda_kernels.newton_solve(zero, T0, *args)
        again = cuda_kernels.newton_solve(zero, T0, *args)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              "newton_solve is not deterministic")

        def plain_solve(d0, args=args):
            return cuda_kernels.newton_solve_reference(d0, T0, *args)

        vs_per, vs = held_to_all(
            f"newton_solve, {name}", got,
            [("per-trial path", per_solve(zero), per_solve),
             ("plain twin", plain_solve(zero), plain_solve)], zero)
        check(vs_per["same"] == 1, f"newton_solve, {name}: not the per-trial "
                                "path's bits")
        err = max(err, vs["max"])
        if vs["excepted"]:
            excepted.append(f"{name}: |Δd| up to {vs['max_all']:.3e}")
    out = {"max_abs_err": err, "plain_unstable": excepted}
    if not times or dev.type != "cuda":
        return out
    got = cuda_kernels.newton_solve(zero, T0, *base)
    evals = int(got[2]) + 1
    win_bytes, win_pairs = window_work(got[0], T0, src, state.packed,
                                       state.grid.origin, None, h, w, res,
                                       m.n_neighbours)
    n_feat = fs.mask.numel()
    feat_live = int((fs.mask & ft.mask).sum())
    # The start, T0, origin, Q in; d, score, trials and the flag out.
    scalars = 4 * (3 + 3 + 2 + 9) + 4 * (3 + 1 + 1) + 1
    out.update(bound(win_bytes + 2 * CELL_BYTES * n_feat + scalars,
                     evals * (win_pairs + feat_live)), trials=evals - 1)
    print(f"  newton_solve: {evals} evaluations; bound "
          f"{out['bound_ms'] * 1e3:.4f} us ({out['bound_by']})")
    kernel = lambda: cuda_kernels.newton_solve(zero, T0, *base)  # noqa
    out.update(time_turns(
        kernel, lambda: cuda_kernels.newton_solve_reference(zero, T0, *base),
        100, 3))
    per = time_turns(kernel, lambda: per_trial_solve((zero, T0, *base))(zero),
                     100, 10, label="per-trial path")
    out.update(per_trial_ms=per["plain_ms"],
               per_trial_events_ms=per["plain_events_ms"])
    return out


def fleet_solve_checks(fp, seq, b, dev, times=True):
    """Phase 3d: `newton_solve_batch` at a fleet step's shapes (b lanes of
    fleet_trial_case, with its all-masked, featureless and edge lanes)
    against its plain twin on the card (the masked lockstep over the
    objective's plain version) and the per-trial lockstep path
    (held_to_all, lane by lane; its bits required on every lane), with
    bfloat16 rows on and off, each term
    off in turn and step control off; two calls give identical bits.
    Returns ({"max_abs_err", "plain_unstable"} as solve_checks and, with
    `times`, its times, the per-trial path's and its bound; the
    per-trial path's `newton_objective_batch` launches)."""
    m = fp.matcher
    h, w, res = fp.ndt.grid_h, fp.ndt.grid_w, fp.ndt.resolution
    _, T0, src, packed, origins, offs, fs, ft, Q = fleet_trial_case(
        fp, seq, b, dev)
    zero = torch.zeros((b, 3), device=dev)
    base = (T0, src, packed, origins, offs, h, w, res, m, fs, ft, Q)
    cases = {"bf16 rows": (*base, True), "f32 rows": (*base, False),
             "window off": (T0, None, *base[2:], True),
             "features off": (*base[:9], None, None, Q, True),
             "odometry off": (*base[:11], None, True),
             "step control off": (*base[:8], m.replace(step_control=False),
                                  *base[9:], True)}
    err, per_launches, excepted = 0.0, 0, []
    for name, args in cases.items():
        def per_solve(d0, args=args):
            return d2d.newton_match_batch(
                d0, args[8],
                lambda d: cuda_kernels.newton_objective_batch(d, *args))

        got = cuda_kernels.newton_solve_batch(zero, *args)
        again = cuda_kernels.newton_solve_batch(zero, *args)
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              "newton_solve_batch is not deterministic")
        before = cuda_kernels.LAUNCHES["newton_objective_batch"]
        per = per_solve(zero)
        per_launches += cuda_kernels.LAUNCHES["newton_objective_batch"] - (
            before)
        def plain_solve(d0, args=args):
            return cuda_kernels.newton_solve_batch_reference(d0, *args)

        vs_per, vs = held_to_all(
            f"newton_solve_batch B={b}, {name}", got,
            [("per-trial path", per, per_solve),
             ("plain twin", plain_solve(zero), plain_solve)], zero)
        check(vs_per["same"] == b, f"newton_solve_batch B={b}, {name}: "
                                   "not the per-trial path's bits")
        err = max(err, vs["max"])
        if vs["excepted"]:
            excepted.append(f"B={b}, {name}: lanes {vs['excepted']}, |Δd| "
                            f"up to {vs['max_all']:.3e}")
    out = {"max_abs_err": err, "plain_unstable": excepted}
    if not times or dev.type != "cuda":
        return out, per_launches
    args = (*base, True)
    got = cuda_kernels.newton_solve_batch(zero, *args)
    n_bytes, lane_pairs = window_work(got[0], T0, src, packed, origins, offs,
                                      h, w, res, m.n_neighbours, lanes=True)
    lane_pairs = lane_pairs + (fs.mask & ft.mask).sum(-1)
    evals = got[2].to(torch.int64) + 1
    per_lane = 4 * (3 + 3 + 2 + 9) + 8 + 4 * (3 + 1 + 1) + 1
    n_bytes += 2 * CELL_BYTES * fs.mask.numel() + b * per_lane
    lib = cuda_kernels.build()
    cluster = cuda_kernels._solve_cluster(lib, dev, b, src.mask.shape[-1],
                                          fs.mask.shape[-1])
    out.update(bound(n_bytes, int((evals * lane_pairs).sum())),
               trials_max=int(got[2].max()), cluster=cluster,
               resident_clusters=lib.ndtg_solve_max_clusters(
                   src.mask.shape[-1], fs.mask.shape[-1], cluster))
    print(f"  newton_solve_batch B={b}: {cluster} blocks a lane; the card "
          f"holds {out['resident_clusters']} such clusters at once")
    print(f"  newton_solve_batch B={b}: {int(evals.sum())} lane evaluations "
          f"(the slowest lane {int(evals.max())}); bound "
          f"{out['bound_ms'] * 1e3:.3f} us ({out['bound_by']})")
    kernel = lambda: cuda_kernels.newton_solve_batch(zero, *args)  # noqa
    out.update(time_turns(kernel, lambda: cuda_kernels
                          .newton_solve_batch_reference(zero, *args), 50, 2))
    per = time_turns(kernel, lambda: d2d.newton_match_batch(
        zero, m, lambda d: cuda_kernels.newton_objective_batch(d, *args)),
        50, 5, label="per-trial path")
    out.update(per_trial_ms=per["plain_ms"],
               per_trial_events_ms=per["plain_events_ms"])
    return out, per_launches


def _copy(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, CellList):
        return CellList(x.means.clone(), x.covs.clone(), x.mask.clone())
    return x


def _sync_warnings(caught):
    return sum("synchroniz" in str(w.message) for w in caught)


@contextlib.contextmanager
def recorded_solves(entry="newton_solve", copy=True):
    """Inside: every call of cuda_kernels.<entry> (`newton_solve` or
    `newton_solve_batch`) is kept as (arguments, result), and the
    synchronising calls made inside it under
    torch.cuda.set_sync_debug_mode("warn") are counted.  With `copy`
    the arguments and result are copies (the main path's registrations,
    for the replay); without, the arguments are not kept and the result
    is the entry's own tensors, unread.  Yields (calls, counts)."""
    calls, counts = [], {"in_solve": 0}
    inner = getattr(cuda_kernels, entry)

    def solve(*args):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = inner(*args)
        counts["in_solve"] += _sync_warnings(caught)
        if copy:
            calls.append((tuple(_copy(a) for a in args),
                          tuple(x.clone() for x in out)))
        else:
            calls.append((None, out))
        return out

    setattr(cuda_kernels, entry, solve)
    try:
        yield calls, counts
    finally:
        setattr(cuda_kernels, entry, inner)


# The link refinements of phases 5 (optimize_offline's checked run), 6
# (the online LC's checked run) and 9e (the grouped proposals), recorded
# for phase 17: each call's arguments (fresh tensors the paths do not
# write again, so no copy is taken).
REFINEMENTS = {"offline": [], "online": [], "grouped": []}


@contextlib.contextmanager
def recorded_refinements(path):
    """Inside: every call of links.refine_links_d2d is kept under
    REFINEMENTS[path] as (args, kwargs)."""
    inner = links_mod.refine_links_d2d

    def refine(*args, **kwargs):
        REFINEMENTS[path].append((args, kwargs))
        return inner(*args, **kwargs)

    links_mod.refine_links_d2d = refine
    try:
        yield REFINEMENTS[path]
    finally:
        links_mod.refine_links_d2d = inner


def replay_phase(calls, dev):
    """Phase 3, the replay: the main path's registrations from their
    recorded inputs, each through `newton_solve` (which repeats the
    recorded bits), the per-trial path the fuser ran before (d2d.newton_match
    over `newton_objective`) and the plain twin.  The kernel must give
    the per-trial path's bits on every scan (held_to_all also holds it
    there, with the plain twin as the backup of any scan excepted); the
    plain twin's
    deviation is printed.  Counts the per-trial path's
    `newton_objective` launches and its synchronising calls
    (torch.cuda.set_sync_debug_mode("warn")).  Returns a summary."""
    n = len(calls)
    d0 = torch.stack([a[0] for a, _ in calls])
    got, per, plain = [], [], []
    cuda_kernels.reset_launch_counts()
    per_syncs = 0
    for args, rec in calls:
        out = cuda_kernels.newton_solve(*args)
        check(all(torch.equal(x, y) for x, y in zip(out, rec)),
              "newton_solve does not repeat the main path's bits")
        got.append(out)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                per.append(per_trial_solve(args)(args[0]))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        per_syncs += _sync_warnings(caught)
        plain.append(cuda_kernels.newton_solve_reference(*args))
    launches = dict(cuda_kernels.LAUNCHES)
    stack = lambda rs: tuple(torch.stack([r[k] for r in rs])  # noqa: E731
                             for k in range(4))
    got, per, plain = stack(got), stack(per), stack(plain)

    def per_all(d_start):
        return stack([per_trial_solve(args)(d_start[i])
                      for i, (args, _) in enumerate(calls)])

    held, = held_to_all(f"replay of the main path's {n} registrations", got,
                        [("per-trial path", per, per_all)], d0,
                        label="registration", backups=[("plain twin", plain)])
    check(held["same"] == n, "the replayed registrations are not the "
                             "per-trial path's bits")
    dev_plain = float(np.max(solve_dev(got[0], plain[0])))
    plain_differ = int((got[2] != plain[2]).sum())
    print(f"  vs the plain twin: max |Δd| {dev_plain:.3e}, trial counts "
          f"differ at {plain_differ} of {n}; the per-trial path made "
          f"{launches['newton_objective']} newton_objective launches and "
          f"{per_syncs} synchronising calls ({per_syncs / n:.2f} a "
          f"registration); the kernel's trials {int(got[2].sum())}, the "
          f"per-trial path's {int(per[2].sum())}")
    return {"registrations": n, "max_dd_per_trial": held["max_all"],
            "scans_excepted": [i + 1 for i in held["excepted"]],
            "scans_trials_differ": [i + 1 for i in held["differ"]],
            "max_dd_plain": dev_plain, "plain_trials_differ": plain_differ,
            "per_trial_launches": launches["newton_objective"],
            "per_trial_syncs": per_syncs,
            "trials": int(got[2].sum()), "per_trial_trials":
            int(per[2].sum())}


def per_trial_solve(args):
    """The per-trial path of a recorded `newton_solve` call, as a
    function of the start increment."""
    return lambda d0: d2d.newton_match(
        lambda d: cuda_kernels.newton_objective(d, *args[1:]), d0, args[8])


def run_main_path(sp, fx, dev):
    """One run of the port's main path; returns (slam, seconds)."""
    T = lambda x, dt=torch.float32: torch.as_tensor(x, dtype=dt, device=dev)
    ranges, hit = T(fx["ranges"]), T(fx["hit"], torch.bool)
    odom, u = T(fx["odom"]), T(fx["ransac_u"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slam = NDTFeatureGraphSLAM(sp, seed=0)
    slam.initialize(T(fx["gt"][0]), torch.zeros(3, device=dev), ranges[0],
                    hit[0])
    slam.run_sequence_device(odom, ranges, hit, ransac_u=u)
    torch.cuda.synchronize()
    return slam, time.perf_counter() - t0


def sequence(fx, dev):
    T = lambda x, dt=torch.float32: torch.as_tensor(x, dtype=dt,  # noqa
                                                    device=dev)
    return Sequence(T(fx["ranges"]), T(fx["hit"], torch.bool),
                    T(fx["odom"]), T(fx["gt"]))


def node_ate(node_T, fx, lc):
    gt = fx["gt"][lc["off_node_scan"]]
    return float(np.sqrt(np.mean(np.sum(
        (node_T[:, :2] - gt[:len(node_T), :2]) ** 2, -1))))


def max_dev(a, b):
    """Max deviation of two pose arrays (..., 3): xy, wrapped theta."""
    dth = a[..., 2] - b[..., 2]
    return (float(np.abs(a[..., :2] - b[..., :2]).max()),
            float(np.abs(np.arctan2(np.sin(dth), np.cos(dth))).max()))


def gate_margin(gp, lc, k):
    """Distance of JAX's link k to its nearest validation gate (score,
    both distance gates and both angle gates), against JAX's final
    node poses."""
    nT = lc["off_node_T"]
    i, j = lc["off_link_ref"][k], lc["off_link_mov"][k]
    ci, si = np.cos(nT[i, 2]), np.sin(nT[i, 2])
    dx, dy = nT[j, :2] - nT[i, :2]
    exp = np.array([ci * dx + si * dy, -si * dx + ci * dy,
                    nT[j, 2] - nT[i, 2]])
    T = lc["off_link_T"][k]
    dist = np.linalg.norm(T[:2] - exp[:2])
    ang = abs(np.arctan2(np.sin(T[2] - exp[2]), np.cos(T[2] - exp[2])))
    return min(abs(lc["off_link_score"][k] - gp.valid_max_score),
               abs(dist - gp.valid_max_dist),
               abs(dist - gp.valid_max_dist_refine),
               abs(ang - gp.valid_max_angular_dist),
               abs(ang - gp.valid_max_angular_refine))


def link_moved(a, b):
    """Per link: do poses a and b (L, 3) differ by more than 1 cm /
    5 mrad (theta wrapped)?"""
    dth = a[:, 2] - b[:, 2]
    return ((np.abs(a[:, :2] - b[:, :2]).max(1) > XY_TOL)
            | (np.abs(np.arctan2(np.sin(dth), np.cos(dth))) > TH_TOL))


def check_kept_links(gp, lc, keep, link_T, mask):
    """The kept-link set against JAX's.  A link may be kept differently
    only where JAX's value lies within 1e-3 of a gate, or where the
    link's own refined pose moved beyond 1 cm / 5 mrad from JAX's: the
    refinement's spread (see check_refinement).  Names each such link;
    returns how many differ."""
    ref_T = lc["off_link_T"]
    moved = link_moved(link_T, ref_T) | (mask != lc["off_link_mask"])
    differ = np.flatnonzero(keep != lc["off_keep"])
    for k in differ:
        i, j = lc["off_link_ref"][k], lc["off_link_mov"][k]
        margin = gate_margin(gp, lc, k)
        print(f"  link ({i}, {j}): kept {bool(keep[k])}, JAX "
              f"{bool(lc['off_keep'][k])}; JAX value {margin:.2e} from its "
              f"gate; refined pose {np.round(link_T[k], 4)} vs JAX "
              f"{np.round(ref_T[k], 4)}")
        check(margin <= 1e-3 or moved[k],
              f"link ({i}, {j}) is kept differently from JAX with the same "
              "refined pose, away from every gate")
    print(f"  {int(keep.sum())} kept links (JAX {int(lc['off_keep'].sum())}"
          f", {len(differ)} differ)")
    return len(differ)


def link_costs(bank, ref, mov, T, sp):
    """The D2D cost of each link (ref, mov) at poses T (L, 3) on `bank`,
    by the plain batch twin."""
    p = sp.fuser
    h, w = p.ndt.grid_h, p.ndt.grid_w
    dev = bank.T.device
    ref, mov = (torch.as_tensor(x, device=dev) for x in (ref, mov))
    budget = links_mod.source_cell_budget(bank)
    src = CellList(*(x[mov, :budget].contiguous() for x in (
        bank.cells.means, bank.cells.covs, bank.cells.mask)))
    return d2d_analytic.fgh_dense_flat_batch(
        torch.zeros((len(ref), 3), device=dev),
        torch.as_tensor(T, dtype=torch.float32, device=dev), src,
        bank.target.packed.reshape(-1, 8), bank.target.origin[ref],
        ref * h * w, h, w, p.ndt.resolution, p.matcher)[0].cpu().numpy()


def check_refinement(slam, lc, sp):
    """The proposal of optimize_offline on JAX's own node bank: the same
    candidate pairs and valid mask; RANSAC poses within 1e-5 of JAX's
    (tests/test_torch_features.py); refined poses whose summed D2D cost
    lies within 2% of that of JAX's refined poses.  Lane by lane the
    refined poses may part: the batched Newton's cost is rough (a window
    cell switches where a moved cell crosses a cell edge), so float32
    sums in another order move lanes into other minima, as moving the
    reference's own RANSAC poses by 1e-6 does (off_link_T_eps; both
    counts are printed).  Returns (lanes moved, the reference's own
    count, the summed costs: port, JAX, JAX from RANSAC poses +
    1e-6)."""
    p = sp.fuser
    ls = slam.offline_links
    for k in ("ref", "mov", "mask"):
        check(np.array_equal(getattr(ls, k).cpu().numpy(),
                             lc["off_link_" + k]),
              f"proposed links: {k} differs from JAX")
    bank = node_mod.stack_nodes(slam.nodes)
    ransac_T = links_mod.compute_links_batch(
        p.features, p.ndt.resolution, bank, *slam.candidate_pairs(),
        torch.as_tensor(lc["off_pair_u"][0], device=slam.device),
    ).T.cpu().numpy()
    r_dev = float(np.abs(ransac_T - lc["off_ransac_T"]).max())
    port_T = ls.T.cpu().numpy()
    valid = lc["off_link_mask"]
    ref_T = lc["off_link_T"]
    n_port = int(link_moved(port_T, ref_T)[valid].sum())
    n_ref = int(link_moved(lc["off_link_T_eps"], ref_T)[valid].sum())
    costs = tuple(float(link_costs(bank, lc["off_link_ref"],
                                   lc["off_link_mov"], t, sp)[valid].sum())
                  for t in (port_T, ref_T, lc["off_link_T_eps"]))
    print(f"  RANSAC poses within {r_dev:.2e} of JAX; refined poses moved "
          f"beyond 1 cm / 5 mrad from JAX: {n_port} of {int(valid.sum())} "
          f"(the reference's own, from RANSAC poses + 1e-6: {n_ref}); "
          f"summed D2D cost {costs[0]:.2f}, JAX {costs[1]:.2f}, JAX from "
          f"RANSAC poses + 1e-6 {costs[2]:.2f}")
    check(r_dev <= 1e-5, "RANSAC poses differ from JAX beyond 1e-5")
    check(abs(costs[0] - costs[1]) <= 0.02 * abs(costs[1]),
          "the refined links' summed cost departs from JAX's beyond 2%")
    return n_port, n_ref, costs


def check_grouped(ls, sv, bank, sp, n=None):
    """Grouped link proposals against the JAX record (the first `n`
    candidate pairs, default all), by phase 5a's link rules: the same
    pairs and valid mask, and the refined poses' summed D2D cost within
    2% of that of JAX's; lanes may part where the batched Newton's rough
    cost lets float32 sums in another order move them (counted).
    Returns (lanes moved beyond 1 cm / 5 mrad, (port cost, JAX cost))."""
    n = len(sv["grp_ref"]) if n is None else n
    for k in ("ref", "mov", "mask"):
        check(np.array_equal(getattr(ls, k).cpu().numpy(),
                             sv["grp_" + k][:n]),
              f"grouped proposals: {k} differs from JAX")
    valid = sv["grp_mask"][:n]
    port_T = ls.T.cpu().numpy()
    moved = int(link_moved(port_T, sv["grp_T"][:n])[valid].sum())
    ref, mov = sv["grp_ref"][:n], sv["grp_mov"][:n]
    costs = tuple(float(link_costs(bank, ref, mov, t, sp)[valid].sum())
                  for t in (port_T, sv["grp_T"][:n]))
    print(f"  grouped proposals ({n} pairs): refined poses moved beyond "
          f"1 cm / 5 mrad from JAX: {moved} of {int(valid.sum())}; summed "
          f"D2D cost {costs[0]:.2f}, JAX {costs[1]:.2f}")
    check(abs(costs[0] - costs[1]) <= 0.02 * abs(costs[1]),
          "the grouped links' summed cost departs from JAX's beyond 2%")
    return moved, costs


def nearest_record(out, lc):
    """The JAX offline solution nearest to `out`: the record, or the
    record with the odometry moved by 1e-6 — the reference's own spread
    (its solve of this corridor lands centimetres apart under that
    change).  Returns (name, (xy, theta) deviation) after printing
    both."""
    devs = {"JAX": max_dev(out, lc["off_node_T"]),
            "JAX at odometry + 1e-6": max_dev(out, lc["off_alt_node_T"])}
    for name, (xy, th) in devs.items():
        print(f"  optimized node poses vs {name}: {xy * 100:.4f} cm / "
              f"{th * 1e3:.4f} mrad")
    near = min(devs, key=lambda k: devs[k][0])
    return near, devs[near]


def offline_on_jax_graph(sp, fx, lc, dev):
    """Phase 5a: optimize_offline on the reference's own graph, so that
    the slice is held to JAX on shared inputs."""
    gp = sp.graph
    edges = zip(lc["off_edge_ij"][:, 0], lc["off_edge_ij"][:, 1],
                lc["off_edge_rel"], lc["off_edge_cov"])
    slam = interop.graph_from_jax(
        sp, interop.tree_from_flat(lc, "off_bank"), lc["off_node_T_before"],
        edges, device=dev)
    slam.pair_u = [lc["off_pair_u"][0]]
    out = slam.optimize_offline().cpu().numpy()
    check(np.isfinite(out).all(), "optimized node poses are not finite")
    ls = slam.offline_links
    moved, moved_ref, costs = check_refinement(slam, lc, sp)
    differ = check_kept_links(gp, lc, slam.offline_keep,
                              ls.T.cpu().numpy(), ls.mask.cpu().numpy())
    near, (xy, th) = nearest_record(out, lc)
    check(xy <= XY_TOL and th <= TH_TOL,
          "optimized node poses deviate from JAX beyond 1 cm / 5 mrad")
    print(f"  node ATE: port {node_ate(out, fx, lc):.5f} m, JAX "
          f"{node_ate(lc['off_node_T'], fx, lc):.5f} m; nearest: {near}")
    # The solve alone: the port's fixpoint loop on JAX's own link set.
    slam.node_T = [t.copy() for t in lc["off_node_T_before"]]
    solved = slam.solve_links(interop.link_set_from_jax({
        k: lc["off_link_" + k] for k in
        ("ref", "mov", "T", "cov", "score", "mask")}, dev)).cpu().numpy()
    sxy, sth = max_dev(solved, lc["off_node_T"])
    same = bool((slam.offline_keep == lc["off_keep"]).all())
    print(f"  the port's fixpoint solve on JAX's links: kept set "
          f"{'equal' if same else 'DIFFERENT'}, node poses within "
          f"{sxy * 100:.4f} cm / {sth * 1e3:.4f} mrad of JAX")
    check(same and sxy <= XY_TOL and sth <= TH_TOL,
          "the solve on JAX's links deviates from JAX")
    return {"links_moved": moved, "links_moved_jax_1e-6": moved_ref,
            "link_cost_sums": costs,
            "kept_differ": differ, "nearest": near, "node_dev_xy_m": xy,
            "node_dev_theta_rad": th, "solve_on_jax_links_dev": (sxy, sth)}


def offline_phase(fx, lc, dev):
    """Phase 5: pipeline.run_slam + optimize_offline on bench.py's
    offline graph, against the JAX record; with phase 3b on its node
    bank and phase 5a on the reference's own graph.  Returns (summary,
    launches of the optimize_offline run, the batch entry's checks)."""
    sp = canonical_slam_params(OFFLINE_SPLIT_M, 64)
    check(repr(sp) == str(lc["off_params_repr"]),
          "canonical_lc.npz was made at other offline parameters")
    T = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    cuda_kernels.reset_launch_counts()
    with map_updates() as updates:
        slam, stats = pipeline.run_slam(sp, sequence(fx, dev), seed=0,
                                        ransac_u=T(lc["off_scan_u"]))
    if dev.type == "cuda":
        check_map_launches(dict(cuda_kernels.LAUNCHES), updates,
                           "run_slam")
    n_nodes, n_ref = len(slam.nodes), lc["off_node_T"].shape[0]
    check(n_nodes == n_ref, f"{n_nodes} nodes, JAX built {n_ref}")
    before = np.stack(slam.node_T)
    xy, th = max_dev(before, lc["off_node_T_before"])
    print(f"  graph: {n_nodes} nodes (JAX {n_ref}) from "
          f"{stats['n_updates']} gated scans; node poses before the "
          f"solve within {xy * 100:.4f} cm / {th * 1e3:.4f} mrad of JAX")

    bank = node_mod.stack_nodes(slam.nodes)
    budget = links_mod.source_cell_budget(bank)
    pairs = np.stack([lc["off_link_ref"], lc["off_link_mov"]], 1)
    print(f"phase 3b: fgh_dense_flat_batch vs plain on the card "
          f"({len(pairs)} candidate pairs, source budget {budget})")
    batch = batch_kernel_checks(bank, pairs, lc["off_link_T"], budget, sp,
                                dev)
    big = np.resize(pairs, (BIG_B, 2))
    err_big = batch_kernel_checks(
        bank, big, np.resize(lc["off_link_T"], (BIG_B, 3)), budget, sp, dev,
        times=False)["max_abs_err"]

    print("phase 5a: optimize_offline on JAX's own graph (node bank, poses "
          "and odometry edges from canonical_lc.npz)")
    on_jax = offline_on_jax_graph(sp, fx, lc, dev)

    print("phase 5: optimize_offline on the port's graph")

    def optimize():
        slam.node_T = [t.copy() for t in before]
        slam.pair_u = [lc["off_pair_u"][0]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = slam.optimize_offline().cpu().numpy()
        return out, time.perf_counter() - t0

    cuda_kernels.reset_launch_counts()
    with recorded_refinements("offline"):
        out, _ = optimize()
    launches = dict(cuda_kernels.LAUNCHES)
    print(f"  launches in optimize_offline: {launches}")
    check(launches["newton_solve_batch"] == len(REFINEMENTS["offline"]) > 0
          and launches["fgh_dense_flat_batch"] == 0,
          "optimize_offline did not refine in one newton_solve_batch launch "
          "a refinement")
    check(launches["overlap_score"] > 0 and launches["row_sum"] == 0,
          "optimize_offline did not score its links through overlap_score "
          "alone")
    check(launches["match_features"] > 0
          and launches["detect_features"] == 0
          and launches["describe_features"] == 0,
          "optimize_offline did not propose its links through "
          "match_features")
    check(np.isfinite(out).all(), "optimized node poses are not finite")
    ls = slam.offline_links
    differ = check_kept_links(sp.graph, lc, slam.offline_keep,
                              ls.T.cpu().numpy(), ls.mask.cpu().numpy())
    near, (xy, th) = nearest_record(out, lc)
    ate_before, ate = node_ate(before, fx, lc), node_ate(out, fx, lc)
    ate_ref = node_ate(lc["off_node_T"], fx, lc)
    print(f"  node ATE vs ground truth: before {ate_before:.5f} m; after "
          f"port {ate:.5f} m, JAX {ate_ref:.5f} m, JAX at odometry + 1e-6 "
          f"{node_ate(lc['off_alt_node_T'], fx, lc):.5f} m; nearest: {near}")
    check(xy <= XY_TOL and th <= TH_TOL,
          "optimized node poses deviate from JAX beyond 1 cm / 5 mrad")
    check(ate < 0.5 * ate_before and abs(ate - ate_ref) <= XY_TOL,
          "node ATE does not halve, or departs from JAX's by over 1 cm")
    runs = [optimize()[1] for _ in range(3)]
    print(f"  optimize_offline wall: {sorted(runs)[1]:.3f} s (median of 3: "
          f"{', '.join(f'{r:.3f}' for r in runs)})")

    p = sp.fuser
    all_pairs = np.asarray([(i, j) for i in range(n_nodes)
                            for j in range(i + 2, n_nodes)])

    def pairs_rate(b):
        idx = np.resize(all_pairs, (b, 2))
        ref, mov = T(idx[:, 0]), T(idx[:, 1])
        mask = torch.ones(b, dtype=torch.bool, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(b)

        def propose():
            """One batch, forced by a readback of every output."""
            u = torch.rand((b, p.features.ransac_hypotheses, 2),
                           generator=gen, device=dev)
            ls = links_mod.compute_links_batch(p.features, p.ndt.resolution,
                                               bank, ref, mov, mask, u)
            ls = links_mod.refine_links_d2d(p.ndt, p.matcher, bank, ls,
                                            src_budget=budget)
            ls = links_mod.rescore_links(p.ndt.resolution, bank, ls)
            float(ls.T.nansum() + ls.score.nansum() + ls.cov.nansum())

        propose()
        times_ = []
        for _ in range(3):
            t0 = time.perf_counter()
            propose()
            times_.append(time.perf_counter() - t0)
        return b / sorted(times_)[1], times_

    rates = {b: pairs_rate(b) for b in RATE_B}
    for b, (r, ts) in rates.items():
        print(f"  propose -> refine -> rescore at B={b}: {r:.1f} pairs/s "
              f"(median of 3: {', '.join(f'{t:.3f}' for t in ts)} s)")
    summary = {
        "nodes": n_nodes, "kept": int(slam.offline_keep.sum()),
        "kept_jax": int(lc["off_keep"].sum()), "kept_differ": differ,
        "nearest": near, "node_dev_xy_m": xy, "node_dev_theta_rad": th,
        "ate_before_m": ate_before, "ate_m": ate, "ate_jax_m": ate_ref,
        "on_jax_graph": on_jax, "optimize_s": runs,
        "pairs_per_s": {b: r for b, (r, _) in rates.items()},
        "batch_err_b1024": err_big,
    }
    return summary, launches, batch


def registration_phase(sp, slam, dev):
    """Phase 3c: the port's plain registration on the main-path graph,
    kernel against plain.  d2d.match_d2d + covariance_d2d of the last
    frozen node's cells against the final submap's packed table (the
    `fgh_dense_flat` entry: pose within MATCH_TOL, covariance within
    COV_RTOL of its largest entry), and cuda_kernels.fgh_paired on its
    own (the `pair_fgh_reduce` entry).  Returns the launches of these
    two paths."""
    p = sp.fuser
    m = p.matcher
    T = lambda x: torch.as_tensor(x, dtype=torch.float32,  # noqa: E731
                                  device=dev)
    tgt, cells, T_init = registration_inputs(sp, slam, dev)

    cuda_kernels.reset_launch_counts()
    got = d2d.match_d2d(tgt, cells, T_init, p.ndt, m)
    cov = d2d.covariance_d2d(tgt, cells, got.T, p.ndt, m)
    launches = dict(cuda_kernels.LAUNCHES)
    check(launches["newton_solve"] == 1 and launches["fgh_dense_flat"] == 1
          and sum(launches.values()) == 2,
          f"match_d2d + covariance_d2d launched {launches}, not one "
          "newton_solve and one fgh_dense_flat")

    def plain_fgh(T0):
        return lambda d: d2d_analytic.fgh_dense_flat(
            d, T0, cells, tgt.packed, tgt.origin, 0, p.ndt.grid_h,
            p.ndt.grid_w, p.ndt.resolution, m)

    zero = torch.zeros(3, device=dev)
    d_ref, f_ref, itr_ref, _ = d2d.newton_match(plain_fgh(T_init), zero, m)
    T_ref = se2.compose(d_ref, T_init)
    cov_ref = d2d.cov_from_hessian(plain_fgh(got.T)(zero)[2], m)
    xy, th = max_dev(got.T.cpu().numpy(), T_ref.cpu().numpy())
    cov_dev = float((cov - cov_ref).abs().max() / cov_ref.abs().max())
    print(f"  match_d2d of node {len(slam.nodes) - 1} "
          f"({int(cells.mask.sum())} cells) against the final submap: "
          f"{int(got.iterations)} trials (plain {int(itr_ref)}), "
          f"launches with covariance_d2d {launches}, "
          f"moved {float(got.d[:2].norm()) * 100:.3f} cm; kernel vs plain "
          f"pose {xy:.2e} m / {th:.2e} rad, score {float(got.score):.4f} "
          f"vs {float(f_ref):.4f}; covariance_d2d within {cov_dev:.2e} of "
          f"its largest entry")
    check(max(xy, th) <= MATCH_TOL,
          "match_d2d: kernel and plain poses differ beyond 1e-4")
    check(np.isfinite(cov.cpu().numpy()).all() and cov_dev <= COV_RTOL,
          "covariance_d2d: kernel and plain differ beyond 1e-3")

    feat_src, feat_tgt = feature_pairs(T_init, dev, seed=1)
    d = T([0.01, 0.02, -0.003])
    cuda_kernels.reset_launch_counts()
    got_p = cuda_kernels.fgh_paired(d, T_init, feat_src, feat_tgt, m)
    launches["pair_fgh_reduce"] = cuda_kernels.LAUNCHES["pair_fgh_reduce"]
    compare("fgh_paired on its own (64 feature pairs)", got_p,
            d2d_analytic.fgh_paired(d, T_init, feat_src, feat_tgt, m))
    check(launches["pair_fgh_reduce"] == 1,
          "fgh_paired did not launch pair_fgh_reduce once")
    return launches


def online_lc_run(sp, fx, lc, dev):
    T = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    seq = sequence(fx, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slam = NDTFeatureGraphSLAM(sp, seed=0)
    slam.pair_u = list(lc["on_pair_u"])
    slam.initialize(seq.gt[0], torch.zeros(3, device=dev), seq.ranges[0],
                    seq.hit[0])
    slam.run_sequence_chunked(seq.odom, seq.ranges, seq.hit, chunk=64,
                              ransac_u=T(lc["on_scan_u"]))
    torch.cuda.synchronize()
    return slam, time.perf_counter() - t0


def online_phase(fx, lc, dev):
    """Phase 6: online loop closure in bench.py's bench_online_lc
    setting, against the JAX record."""
    sp = canonical_slam_params(2.0, 64, **LC_GRAPH)
    check(repr(sp) == str(lc["on_params_repr"]),
          "canonical_lc.npz was made at other online-LC parameters")
    cuda_kernels.reset_launch_counts()
    with recorded_refinements("online"), map_updates() as updates:
        slam, _ = online_lc_run(sp, fx, lc, dev)
    launches = dict(cuda_kernels.LAUNCHES)
    check_map_launches(launches, updates, "the online-LC run")
    print(f"  launches in the online-LC run: {launches} (newton_solve_batch: "
          f"one a proposal's refinement, {len(REFINEMENTS['online'])})")
    for k in ("newton_solve", "newton_solve_batch"):
        check(launches[k] > 0,
              f"kernel {k} was not launched by the online-LC run")
    check(launches["newton_solve_batch"] == len(REFINEMENTS["online"])
          and launches["fgh_dense_flat_batch"] == 0,
          "the online LC's refinements are not one launch each")
    check(launches["overlap_score"] > 0 and launches["row_sum"] == 0,
          "the online LC did not score its proposals through overlap_score "
          "alone")
    traj = np.stack(slam.trajectory)
    check(traj.shape == lc["on_traj"].shape and np.isfinite(traj).all(),
          "online-LC trajectory not finite / of the wrong shape")
    n_ref = lc["on_node_T"].shape[0]
    links = [list(l[:2]) for l in slam.loop_links]
    check(len(slam.nodes) == n_ref and len(links) == len(lc["on_loop_links"]),
          f"{len(slam.nodes)} nodes / {len(links)} loop links, JAX "
          f"{n_ref} / {len(lc['on_loop_links'])}")
    xy, th = max_dev(traj, lc["on_traj"])
    nxy, nth = max_dev(np.stack(slam.node_T), lc["on_node_T"])
    print(f"  {len(slam.nodes)} nodes, {len(links)} loop links "
          f"(JAX {n_ref}, {len(lc['on_loop_links'])}); trajectory within "
          f"{xy * 100:.4f} cm / {th * 1e3:.4f} mrad, node poses within "
          f"{nxy * 100:.4f} cm / {nth * 1e3:.4f} mrad of JAX")
    check(max(xy, nxy) <= XY_TOL and max(th, nth) <= TH_TOL,
          "online-LC poses deviate from JAX beyond 1 cm / 5 mrad")
    runs = [online_lc_run(sp, fx, lc, dev)[1] for _ in range(3)]
    scans = fx["ranges"].shape[0] - 1
    print(f"  online LC: {scans / sorted(runs)[1]:.2f} scans/s (median of 3 "
          f"after the checked run: {', '.join(f'{r:.3f}' for r in runs)} s "
          f"for {scans} scans)")
    return {"scans_per_s": scans / sorted(runs)[1], "run_s": runs,
            "nodes": len(slam.nodes), "loop_links": len(links),
            "dev_xy_m": max(xy, nxy), "dev_theta_rad": max(th, nth)}, launches


def edge_rel_dev(a, b, i, j):
    """Largest difference between poses a and b (N, 3) in the relative
    pose of the factors (i, j): xy, wrapped theta."""
    d = se2.sub_np(a[i], a[j]) - se2.sub_np(b[i], b[j])
    return (float(np.abs(d[:, :2]).max()),
            float(np.abs(np.arctan2(np.sin(d[:, 2]), np.cos(d[:, 2]))).max()))


def solver_edges(i, j, meas, info_diag, dev):
    """An EdgeList on the card from numpy edges with information
    info_diag * I."""
    T = lambda x, dt=None: torch.as_tensor(x, dtype=dt,  # noqa: E731
                                           device=dev)
    eye = np.eye(3, dtype=np.float32)
    return opt_mod.EdgeList(
        i=T(np.asarray(i, np.int64)), j=T(np.asarray(j, np.int64)),
        meas=T(meas, torch.float32),
        info=T(np.asarray(info_diag, np.float32)[:, None, None] * eye),
        mask=torch.ones(len(i), dtype=torch.bool, device=dev))


def direct_solve(init, edges, seg, **kw):
    """What slam._solve's direct branch runs: the segment layout (on the
    host) and optimize_direct; ends in a synchronisation."""
    part = sparse_direct.make_segments(init.shape[0], edges, max_seg_len=seg)
    out = sparse_direct.optimize_direct(init, edges, part, **kw)
    torch.cuda.synchronize()
    return out, part


def ops_per_iteration(init, edges, seg, **kw):
    """Device operations (kernels, copies, sets) of one LM iteration of
    optimize_direct: a 3-iteration solve less a 1-iteration one, over
    two (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    counts = []
    for its in (1, 3):
        kw_its = dict(kw, iterations=its)
        direct_solve(init, edges, seg, **kw_its)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            direct_solve(init, edges, seg, **kw_its)
        counts.append(sum(e.count for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA))
    return (counts[1] - counts[0]) / 2


def scale_case(name, init_np, edges, seg, dev, **kw):
    """One phase-9 solve: its result, the wall time of a solve (median
    of 3 after a warm-up, each ending in a synchronisation), the device
    operations of one LM iteration and the longest segment."""
    init = torch.as_tensor(init_np, dtype=torch.float32, device=dev)
    (out, chi2), part = direct_solve(init, edges, seg, **kw)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        direct_solve(init, edges, seg, **kw)
        times.append(time.perf_counter() - t0)
    ops = ops_per_iteration(init, edges, seg, **kw)
    L = int(part.idx.shape[1])
    S = int(part.sep_ids.shape[0])
    print(f"  {name}: {init_np.shape[0]} nodes, {len(edges.i)} edges, "
          f"{S} separators, {part.idx.shape[0]} segments, L = {L}; solve "
          f"{sorted(times)[1] * 1e3:.1f} ms (median of 3: "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times)}); {ops:.0f} device "
          f"ops per LM iteration")
    return (out.cpu().numpy(), float(chi2),
            {"solve_s": times, "ops_per_iteration": ops, "L": L,
             "separators": S, "nodes": int(init_np.shape[0])})


def offline_scale_phase(fx, lc, dev):
    """Phase 9: offline optimization at scale on the card (the module
    docstring lists (a)-(g)).  Returns (summary, fgh_dense_flat_batch
    launches in (d), (e), (g))."""
    sv = dict(np.load(SOLVER_FIXTURE))
    summary, launches = {}, {}

    def held(name, out, chi2, ref, ref_chi2):
        xy, th = max_dev(out, ref)
        rel = abs(chi2 - float(ref_chi2)) / abs(float(ref_chi2))
        print(f"  {name} vs JAX: {xy * 100:.4f} cm / {th * 1e3:.4f} mrad; "
              f"chi2 {chi2:.5f} (JAX {float(ref_chi2):.5f}, {rel:.2e} "
              "relative)")
        check(np.isfinite(out).all() and xy <= XY_TOL and th <= TH_TOL,
              f"{name}: poses deviate from JAX beyond 1 cm / 5 mrad")
        check(rel <= 0.01, f"{name}: chi2 departs from JAX's beyond 1%")
        return {"dev_xy_m": xy, "dev_theta_rad": th, "chi2": chi2,
                "chi2_jax": float(ref_chi2)}

    print("phase 9a: optimize_direct, bench.py's 570-node multi-loop graph")
    init, i, j, meas, info = multi_loop_graph(MULTI_LOOP["n_nodes"])
    check(np.array_equal(init, sv["ml_init"])
          and np.array_equal(meas, sv["ml_meas"]),
          "the 570-node graph rebuilt here differs from the record's")
    out, chi2, st = scale_case(
        "570", init, solver_edges(i, j, meas, info, dev),
        MULTI_LOOP["max_seg_len"], dev, iterations=MULTI_LOOP["iterations"],
        robust_kernel=MULTI_LOOP["robust_kernel"])
    summary["a_570"] = {**st, **held("570", out, chi2, sv["ml_T"],
                                     sv["ml_chi2"])}

    def two_lap_case(name, gt, init, i, j, meas, info, ref_chi2, ref_ate,
                     steady):
        """The two-lap solve held to the reference's outcomes on the same
        input: `ref_chi2` and `ref_ate` (aligned ATE after) of its runs
        from the initial poses and from poses moved by k * 1e-6.  chi2
        must lie within the reference's own range widened by
        TWO_LAP_RTOL.  Where the reference's ATE is `steady` across its
        runs, the port's ATE ratio must lie in its range so widened;
        where it is not (the low mode's random walk, (b)), the ratio is
        printed beside the reference's range and the solve must lower
        the ATE."""
        out, chi2, st = scale_case(name, init, solver_edges(
            i, j, meas, info, dev), TWO_LAP["max_seg_len"], dev,
            iterations=TWO_LAP["iterations"])
        before, after = ate_aligned(init, gt), ate_aligned(out, gt)
        ratios = np.asarray(ref_ate) / before
        lo, hi = float(np.min(ref_chi2)), float(np.max(ref_chi2))
        r_lo, r_hi = float(ratios.min()), float(ratios.max())
        print(f"  {name}: aligned ATE {before:.4f} m -> {after:.4f} m "
              f"(x{after / before:.3f}; the reference x{r_lo:.3f}-"
              f"x{r_hi:.3f} over {len(ratios)} runs, "
              f"{int((ratios >= 0.6).sum())} of them not under x0.6); "
              f"chi2 {chi2:.5f} (the reference {lo:.5f}-{hi:.5f})")
        check(np.isfinite(chi2) and (1 - TWO_LAP_RTOL) * lo <= chi2
              <= (1 + TWO_LAP_RTOL) * hi,
              f"{name}: chi2 outside the reference's own range")
        if steady:
            check((1 - TWO_LAP_RTOL) * r_lo <= after / before
                  <= (1 + TWO_LAP_RTOL) * r_hi,
                  f"{name}: the ATE ratio is outside the reference's range")
        else:
            check(after < before, f"{name}: the solve did not lower the ATE")
        return out, chi2, {**st, "ate_before_m": before, "ate_m": after,
                           "ate_ratio_jax": [r_lo, r_hi],
                           "chi2_jax": [lo, hi]}

    print("phase 9b: optimize_direct, the reference's 4,000-node two-lap "
          "graph (stored)")
    tl = [sv["tl_" + k] for k in ("gt", "init", "i", "j", "meas", "info")]
    out, chi2, st = two_lap_case(
        "4000", *tl, np.append(sv["tl_eps_chi2"], sv["tl_chi2"]),
        np.append(sv["tl_eps_ate"], sv["tl_ate"][1]), steady=False)
    xy, th = max_dev(out, sv["tl_T"])
    rxy, rth = edge_rel_dev(out, sv["tl_T"], tl[2], tl[3])
    print(f"  4000 vs JAX: every factor's relative pose within "
          f"{rxy * 1e3:.4f} mm / {rth * 1e3:.4f} mrad; absolute poses "
          f"{xy:.3f} m / {th * 1e3:.3f} mrad apart along the low mode")
    check(rxy <= XY_TOL and rth <= TH_TOL,
          "4000: relative poses deviate from JAX beyond 1 cm / 5 mrad")
    summary["b_4000"] = {**st, "rel_dev_xy_m": rxy, "rel_dev_theta_rad": rth,
                         "abs_dev_xy_m": xy, "chi2": chi2}

    print(f"phase 9c: optimize_direct, the two-lap recipe at {TWO_LAP_BIG} "
          "nodes (numpy noise)")
    big = two_lap_graph(TWO_LAP_BIG)
    summary["c_10000"] = two_lap_case(
        str(TWO_LAP_BIG), *big, sv["big_chi2"], sv["big_ate"][1:],
        steady=True)[2]

    print("phase 9d: optimize_offline with solver=\"direct\" "
          f"(solver_max_seg_len={DIRECT_GRAPH['solver_max_seg_len']}) on "
          "JAX's own loop-closure graph")
    sp = canonical_slam_params(OFFLINE_SPLIT_M, 64)
    bank = interop.tree_from_flat(lc, "off_bank")

    def jax_graph(graph):
        params = sp.replace(graph=sp.graph.replace(**graph))
        edges = zip(lc["off_edge_ij"][:, 0], lc["off_edge_ij"][:, 1],
                    lc["off_edge_rel"], lc["off_edge_cov"])
        return params, interop.graph_from_jax(
            params, bank, lc["off_node_T_before"], edges, device=dev)

    sp_dir, slam = jax_graph(DIRECT_GRAPH)
    slam.pair_u = [lc["off_pair_u"][0]]
    cuda_kernels.reset_launch_counts()
    out = slam.optimize_offline().cpu().numpy()
    launches["d"] = cuda_kernels.LAUNCHES["newton_solve_batch"]
    check(cuda_kernels.LAUNCHES["fgh_dense_flat_batch"] == 0,
          "phase 9d refined links a trial at a time")
    before = lc["off_node_T_before"]
    print(f"  optimize_offline: {int(slam.offline_keep.sum())} kept links, "
          f"node ATE {node_ate(before, fx, lc):.5f} m -> "
          f"{node_ate(out, fx, lc):.5f} m; newton_solve_batch launches "
          f"{launches['d']}")
    check(np.isfinite(out).all() and launches["d"] > 0,
          "optimize_offline (direct) is not finite or launched no kernel")
    slam.node_T = [t.copy() for t in before]
    solved = slam.solve_links(interop.link_set_from_jax({
        k: lc["off_link_" + k] for k in
        ("ref", "mov", "T", "cov", "score", "mask")}, dev)).cpu().numpy()
    sxy, sth = max_dev(solved, sv["dir_node_T"])
    same = bool((slam.offline_keep == sv["dir_keep"]).all())
    print(f"  the direct solve on JAX's links: kept set "
          f"{'equal' if same else 'DIFFERENT'}, node poses within "
          f"{sxy * 1e3:.4f} mm / {sth * 1e3:.4f} mrad of JAX's direct solve")
    check(same and sxy <= DIRECT_TOL,
          "the direct solve on JAX's links departs from JAX's beyond 1 mm")
    summary["d_direct"] = {"kept": int(slam.offline_keep.sum()),
                           "solve_dev_xy_m": sxy, "solve_dev_theta_rad": sth,
                           "launches": launches["d"]}

    print("phase 9f: checkpoint round trip of that graph (save, load)")
    slam.trajectory = [t.copy() for t in before]
    slam.times = [float(k) for k in range(len(before))]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph.npz")
        t0 = time.perf_counter()
        slam.save(path)
        loaded = NDTFeatureGraphSLAM.load(path, sp_dir, device=dev)
        rt_s = time.perf_counter() - t0
    a, b = (node_mod.stack_nodes(g.nodes) for g in (slam, loaded))
    same = all(torch.equal(xa, xb) for (_, xa), (_, xb) in zip(
        serialize._leaves_with_path(a), serialize._leaves_with_path(b)))
    for k in ("node_T", "trajectory"):
        same &= np.array_equal(np.stack(getattr(slam, k)),
                               np.stack(getattr(loaded, k)))
    same &= all(e[0] == f[0] and e[1] == f[1] and np.array_equal(e[2], f[2])
                and np.array_equal(e[3], f[3])
                for e, f in zip(slam.odom_edges, loaded.odom_edges))
    same &= len(slam.odom_edges) == len(loaded.odom_edges)
    print(f"  {len(loaded.nodes)} nodes saved and loaded in {rt_s:.2f} s: "
          f"arrays {'identical' if same else 'DIFFERENT'}")
    check(same, "the checkpoint round trip changed an array")
    summary["f_checkpoint"] = {"identical": same, "round_trip_s": rt_s}

    print("phase 9e: grouped link proposals (link_group_nodes="
          f"{GROUPED_GRAPH['link_group_nodes']}, link_batch_size="
          f"{GROUPED_GRAPH['link_batch_size']}) on that bank")
    sp_grp, slam = jax_graph(GROUPED_GRAPH)
    slam.pair_u = list(sv["grp_pair_u"])
    stacked = node_mod.stack_nodes(slam.nodes)
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with recorded_refinements("grouped"):
        ls = slam._propose_links(stacked, *slam.candidate_pairs())
    torch.cuda.synchronize()
    grp_s = time.perf_counter() - t0
    launches["e"] = cuda_kernels.LAUNCHES["newton_solve_batch"]
    check(slam.pair_u == [], "the grouped proposals took another number "
          "of draws than JAX's chunks")
    moved, costs = check_grouped(ls, sv, stacked, sp_grp)
    print(f"  {len(sv['grp_pair_u'])} chunks in {grp_s:.2f} s (the wall "
          f"includes recording each chunk's inputs for phase 17); "
          f"newton_solve_batch launches {launches['e']}")
    check(launches["e"] == len(sv["grp_pair_u"])
          and cuda_kernels.LAUNCHES["fgh_dense_flat_batch"] == 0,
          "grouped proposals did not refine in one launch a chunk")
    summary["e_grouped"] = {"moved": moved, "costs": costs, "wall_s": grp_s,
                            "launches": launches["e"]}

    print("phase 9g: the CLI (slam --optimize, optimize, export-map, eval) "
          "on the canonical 200-scan sequence")
    summary["g_cli"], launches["g"] = cli_case(fx, dev)
    for k, v in launches.items():
        check(v > 0, f"phase 9{k} launched no newton_solve_batch")
    return summary, launches


def cli_case(fx, dev):
    """Phase 9g: the port's CLI in this process (so that its launches
    count) on the canonical sequence written as a sequence npz, at the
    canonical map and scan widths with bench.py's offline node spacing
    (the CLI's other flags at their defaults); the `optimize` output
    against the port's own optimize_offline of the same checkpoint."""
    flags = ["--map-size", "100", "--sensor-range", "30", "--num-beams",
             "720", "--max-cells", "1024", "--new-node-dist",
             str(OFFLINE_SPLIT_M)]
    with tempfile.TemporaryDirectory() as tmp:
        seqf = os.path.join(tmp, "seq.npz")
        np.savez_compressed(seqf, **{k: fx[k] for k in
                                     ("ranges", "hit", "odom", "gt")})
        d = os.path.join(tmp, "out")
        logs = {}
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        for name, argv in (
                ("slam", ["slam", "--dataset", seqf, "--out", d,
                          "--optimize"]),
                ("optimize", ["optimize", "--graph", f"{d}/graph.npz",
                              "--out", f"{d}/opt.tum"]),
                ("export", ["export-map", "--graph", f"{d}/graph.npz",
                            "--out", f"{d}/map.pgm"]),
                ("eval", ["eval", "--est", f"{d}/est.tum",
                          "--gt", f"{d}/gt.tum"])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli.main(argv + (flags if name != "eval" else []))
            logs[name] = buf.getvalue()
        wall = time.perf_counter() - t0
        n = cuda_kernels.LAUNCHES["newton_solve_batch"]
        check(cuda_kernels.LAUNCHES["fgh_dense_flat_batch"] == 0,
              "the CLI refined links a trial at a time")
        _, opt = tum.read_tum(f"{d}/opt.tum")
        _, nodes_opt = tum.read_tum(f"{d}/nodes_opt.tum")
        ev = json.loads(logs["eval"].strip().splitlines()[-1])
        ex = json.loads(logs["export"].strip().splitlines()[-1])
        ap = argparse.ArgumentParser()
        cli._add_common(ap)
        params = cli._params_from_args(ap.parse_args(flags))
        own = NDTFeatureGraphSLAM.load(f"{d}/graph.npz", params, device=dev)
        ref = own.optimize_offline().cpu().numpy()
        pgm = os.path.getsize(f"{d}/map.pgm")
    xy, th = max_dev(opt, ref)
    print(f"  {wall:.1f} s for the four commands; {len(nodes_opt)} nodes; "
          f"eval ATE {ev['ate_rmse_m']:.4f} m; map {ex['cells']} cells "
          f"({pgm} bytes); newton_solve_batch launches {n}; `optimize` "
          f"within {xy * 100:.4f} cm / {th * 1e3:.4f} mrad of the port's "
          "own optimize_offline of the same checkpoint")
    check(np.isfinite(opt).all() and np.isfinite(nodes_opt).all()
          and len(opt) == len(nodes_opt) and np.isfinite(ev["ate_rmse_m"]),
          "the CLI's outputs are not finite or of the wrong size")
    check(xy <= XY_TOL and th <= TH_TOL,
          "the CLI's optimized nodes deviate from optimize_offline")
    return {"wall_s": wall, "nodes": len(opt), "ate_m": ev["ate_rmse_m"],
            "dev_xy_m": xy, "dev_theta_rad": th, "launches": n}, n


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def fleet_trial_case(fp, seq, b, dev):
    """The inputs of one Newton trial of a fleet step of `b` streams: the
    fleet's states after scan 0, scan 1's source cells at the match
    budget, the predicted poses and odometry information, an increment
    and 64 feature pairs for each lane.  Lane 1 has every source cell
    masked, lane 2 an empty feature list, and lane 3 reads a table
    rolled so that its mapped cells start at row 0 / column 0: its
    windows cross the grid's edge next to valid cells.  Returns (d, T0,
    src, packed_flat, origins, row_offsets, feat_src, feat_tgt, Q)."""
    h, w, res = fp.ndt.grid_h, fp.ndt.grid_w, fp.ndt.resolution
    states, odom, pts, mask = scaling.build_fleet_inputs(fp, seq, b)
    T0 = se2.compose(states.Tnow, odom[:, 0])
    src = fuser._match_cells(fp, states.sensor_pose, pts[:, 0], mask[:, 0])
    Q = fuser._increment_information(fp, odom[:, 0], T0).contiguous()
    pairs = [feature_pairs(T0[i], dev, seed=i) for i in range(b)]
    fs, ft = (CellList(*(torch.stack([getattr(lane[k], f) for lane in pairs])
                         for f in ("means", "covs", "mask")))
              for k in (0, 1))
    src.mask[1] = False
    fs.mask[2] = False
    tab = states.packed[3].reshape(h, w, 8)
    valid = tab[..., 5] > 0.5
    r0 = int(valid.any(1).nonzero()[0])
    c0 = int(valid.any(0).nonzero()[0])
    packed = states.packed.clone()
    packed[3] = tab.roll((-r0, -c0), (0, 1)).reshape(h * w, 8)
    origins = states.grid.origin.clone()
    origins[3] += res * torch.tensor([c0, r0], dtype=torch.float32,
                                     device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(b)
    d = (torch.randn((b, 3), generator=gen, device=dev)
         * torch.tensor([0.05, 0.05, 0.01], device=dev)).contiguous()
    return (d, T0.contiguous(), src, packed.reshape(b * h * w, 8), origins,
            torch.arange(b, device=dev) * (h * w), fs, ft, Q)


def fleet_kernel_checks(fp, seq, b, dev, times=True):
    """Phase 3d: `newton_objective_batch` against its plain twin at a
    fleet step's shapes, `b` lanes: every lane's (f, g, H) at the stated
    tolerances (source cells lie up to 30 m from the pose here, so g and
    H get compare()'s cancellation allowance, as the other batch entry's
    lanes do) with bfloat16 rows on and off, each term off in turn,
    identical bits on repeat, the edge-case lanes of fleet_trial_case.
    Returns the entry's {"max_abs_err"} and, with `times`, its times
    (bfloat16 rows on, the fleet's mode) and bound."""
    m = fp.matcher
    h, w, res = fp.ndt.grid_h, fp.ndt.grid_w, fp.ndt.resolution
    d, T0, src, packed, origins, offs, fs, ft, Q = fleet_trial_case(
        fp, seq, b, dev)
    n_src, n_feat = src.mask.shape[1], fs.mask.shape[1]
    check(n_src == 256 and n_feat == 64, "fleet lanes are not 256 + 64")
    print(f"  B={b} lanes x N={n_src} source cells "
          f"({int(src.mask.sum(1).max())} valid at most) x "
          f"K={(2 * m.n_neighbours + 1) ** 2} + {n_feat} feature pairs + Q")

    def both(src_, fs_, ft_, Q_, bf16):
        args = (d, T0, src_, packed, origins, offs, h, w, res, m, fs_, ft_,
                Q_, bf16)
        return (cuda_kernels.newton_objective_batch(*args),
                cuda_kernels.newton_objective_batch_reference(*args))

    def lanes_err(name, got, ref):
        # A lane's f may cancel between its terms (the odometry term is
        # positive, the others negative: -0.23 from terms of ~20 seen on
        # the card), so f is held to F_RTOL of the lanes' largest |f|.
        f_atol = F_RTOL * float(ref[0].abs().max())
        return max(compare(f"newton_objective_batch {name}, lane {k}",
                           tuple(x[k] for x in got), tuple(x[k] for x in ref),
                           quiet=k > 3 or "off" in name, cancel=CANCEL_RTOL,
                           f_atol=f_atol)
                   for k in range(b))

    err = 0.0
    for bf16 in (False, True):
        rows = "bf16 rows" if bf16 else "f32 rows"
        got, ref = both(src, fs, ft, Q, bf16)
        err = max(err, lanes_err(rows, got, ref))
        again, _ = both(src, fs, ft, Q, bf16)
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              "newton_objective_batch is not deterministic")
        if bf16:
            f32 = both(src, fs, ft, Q, False)[0]
            check(not torch.equal(got[0], f32[0]),
                  "the bfloat16 row mode changes nothing")
        for name, args in (("window off", (None, fs, ft, Q)),
                           ("features off", (src, None, None, Q)),
                           ("odometry off", (src, fs, ft, None))):
            err = max(err, lanes_err(f"{rows}, {name}",
                                     *both(*args, bf16)))
    got, ref = both(src, None, None, None, True)
    check(float(got[0][1]) == 0.0 and float(got[2][1].abs().max()) == 0.0,
          "the all-masked lane's window term is not exactly zero")
    _, iy0, ix0 = d2d_analytic.window_cells(
        d[3], T0[3], CellList(src.means[3], src.covs[3], src.mask[3]),
        origins[3], res)
    crossing = src.mask[3] & (torch.minimum(iy0, ix0) < m.n_neighbours)
    check(int(crossing.sum()) > 0 and float(ref[0][3]) < 0.0,
          "lane 3 has no window crossing the edge next to valid cells")
    print(f"  max_abs_err over {b} lanes, all cases: {err:.3e}; "
          f"{int(crossing.sum())} source windows of lane 3 cross the edge")
    out = {"max_abs_err": err}
    if not times or dev.type != "cuda":
        return out
    n_bytes, n_pairs = window_work(d, T0, src, packed, origins, offs, h, w,
                                   res, m.n_neighbours)
    # Per lane: d, T0, origin, row offset, Q, the 13 outputs.
    per_lane = 4 * (3 + 3 + 2) + 8 + 4 * 9 + 4 * 13
    n_bytes += 2 * CELL_BYTES * fs.mask.numel() + b * per_lane
    n_pairs += int((fs.mask & ft.mask).sum())
    out.update(bound(n_bytes, n_pairs))
    print(f"  newton_objective_batch B={b}: bound "
          f"{out['bound_ms'] * 1e3:.3f} us ({out['bound_by']}; "
          f"{n_bytes / 1e6:.2f} MB, {n_pairs} pairs)")
    args = (d, T0, src, packed, origins, offs, h, w, res, m, fs, ft, Q, True)
    out.update(time_turns(
        lambda: cuda_kernels.newton_objective_batch(*args),
        lambda: cuda_kernels.newton_objective_batch_reference(*args), 50, 5))
    return out


def run_fleet(driver, fp, inputs, dev, **kw):
    """One run of a fleet driver, forced by a readback of a digest of
    every output and a device synchronisation.  Returns ((final states,
    trajectories, scores), seconds)."""
    sync(dev)
    t0 = time.perf_counter()
    out = driver(fp, *inputs, **kw)
    value = float(scaling.digest(*out))
    sync(dev)
    check(np.isfinite(value), "fleet outputs are not finite")
    return out, time.perf_counter() - t0


def fleet_rate(driver, fp, inputs, dev, **kw):
    """Aggregate scans/s of a fleet driver: the median of 3 runs (a run
    has come before as warm-up), each with the odometry moved by a
    further 1e-5 as the reference's bench does."""
    states, odom, *rest = inputs
    runs = [run_fleet(driver, fp, (states, odom + (k + 1) * 1e-5, *rest),
                      dev, **kw)[1] for k in range(3)]
    return odom.shape[0] * odom.shape[1] / sorted(runs)[1], runs


def fleet_spread(fl, path):
    """The reference's own (xy, theta) spread on the fleet record's
    `path` ("pts" or "feat"): how far its trajectories move when its
    odometry moves by 1e-6 or 1e-5 (`*_eps_traj`).  On this loop (0.78 m
    and 9 degrees a scan) one scan's registration lands millimetres
    elsewhere under such a change, and any reordered float32 sum does
    the same to the port."""
    spread = [max_dev(e, fl[f"{path}_traj"]) for e in fl[f"{path}_eps_traj"]]
    return tuple(max(s[k] for s in spread) for k in (0, 1))


def fleet_dev(name, traj, scores, ref_traj, ref_scores, spread):
    """Hold fleet trajectories (B, T, 3) and scores (B, T) to reference
    ones.  Nine poses in ten lie within 2 mm / 1 mrad, the tolerance the
    reference holds its small batch test to, and none further than 5 cm
    / 20 mrad; nine scores in ten within the reference's rtol 3e-2 /
    atol 1e-2.  Not every pose can be held to 2 mm: the LM stop test
    (an accepted step improving f by at most 1e-4, three float32 ulps
    of |f| ~ 500) fires at rounding noise, so here and there a scan's
    registration stops early, millimetres (measured up to 23 mm, with a
    score 15% worse) from where the same program lands when a sum
    rounds otherwise (the card and XLA order their sums differently);
    the next scans pull it back.  The reference's own `spread`
    (fleet_spread: what an odometry change of 1e-6 / 1e-5 does to it)
    is printed beside.  Returns the largest (xy, theta) deviation."""
    traj, scores = traj.cpu().numpy(), scores.cpu().numpy()
    check(traj.shape == ref_traj.shape and np.isfinite(traj).all(),
          f"{name}: trajectories {traj.shape} not finite / not "
          f"{ref_traj.shape}")
    xy = np.abs(traj[..., :2] - ref_traj[..., :2]).max(-1)
    dth = traj[..., 2] - ref_traj[..., 2]
    th = np.abs(np.arctan2(np.sin(dth), np.cos(dth)))
    s_ok = np.isclose(scores, ref_scores, rtol=FLEET_SCORE_RTOL,
                      atol=FLEET_SCORE_ATOL)
    q = lambda x: ", ".join(  # noqa: E731
        f"{np.percentile(x, p_) * 1e3:.3f}" for p_ in (50, 90, 99, 100))
    print(f"  {name}: xy mm at 50/90/99/100% of the poses {q(xy)}; theta "
          f"mrad {q(th)} (the reference's own spread: "
          f"{spread[0] * 1e3:.2f} mm / {spread[1] * 1e3:.2f} mrad); "
          f"{100 * s_ok.mean():.1f}% of the scores within rtol 3e-2")
    check(np.percentile(xy, 90) <= FLEET_XY_TOL
          and np.percentile(th, 90) <= FLEET_TH_TOL,
          f"{name}: over a tenth of the poses deviate beyond 2 mm / 1 mrad")
    check(xy.max() <= FLEET_XY_MAX and th.max() <= FLEET_TH_MAX,
          f"{name}: a pose deviates beyond 5 cm / 20 mrad")
    check(s_ok.mean() >= 0.9, f"{name}: over a tenth of the scores deviate "
                              "beyond rtol 3e-2 / atol 1e-2")
    return float(xy.max()), float(th.max())


def only_batch_entry(launches, name, steps, updates):
    """newton_solve_batch once a fleet step, segment_add_rows once a
    statistics update and occupancy_update once an occupancy update
    (each a whole stack of grids), and no other entry."""
    check_map_launches(launches, updates, name)
    check(launches["newton_solve_batch"] == steps
          and sum(launches.values()) == steps + counted_launches(launches),
          f"{name} launched {launches}: expected newton_solve_batch alone, "
          "once a fleet step, beside the map updates")


def fleet_points_phase(fp, fl, dev):
    """Phase 7: run_sequence_batch at B = 8 against the JAX record, then
    B = 32 and 64 and, at B = 32, the occ_every=4 cadence.  Returns
    (summary, launches of the checked B = 8 run, the B = 32
    trajectories)."""
    seq = sequence(fl, dev)
    steps = seq.odom.shape[0] - 1
    drv = scan_driver.run_sequence_batch
    h, w = fp.ndt.grid_h, fp.ndt.grid_w
    spread = fleet_spread(fl, "pts")
    summary = {"scans_per_s": {}, "run_s": {}, "jax_spread": spread}

    inputs = scaling.build_fleet_inputs(fp, seq, 8)
    cuda_kernels.reset_launch_counts()
    with map_updates() as updates:
        (finals, traj8, sc8), _ = run_fleet(drv, fp, inputs, dev)
    launches = dict(cuda_kernels.LAUNCHES)
    if dev.type == "cuda":
        only_batch_entry(launches, "run_sequence_batch", steps, updates)
    n = launches["newton_solve_batch"]
    print(f"  launches in the B=8 run: {launches} ({n / steps:.2f} per fleet "
          f"step: the step's registrations in one launch; "
          f"{launches['segment_add_rows'] / steps:.2f} segment_add_rows and "
          f"{launches['occupancy_update'] / steps:.2f} occupancy_update a "
          f"step for {updates['stats']} statistics and {updates['occ']} "
          f"occupancy updates of the whole stack)")
    summary["dev_bf16"] = fleet_dev("B=8, bf16 rows, vs JAX", traj8, sc8,
                                    fl["pts_traj"], fl["pts_scores"], spread)
    table = d2d.packed_from_grid(finals.grid, fp.ndt)
    t_dev = float((finals.packed - table).abs().max())
    check(t_dev <= 1e-4, f"final packed tables differ from "
                         f"packed_from_grid of the final grids by {t_dev}")
    check(int(finals.n_updates.min()) == steps + 1, "n_updates is off")
    state_mb = sum(x.numel() * x.element_size() for x in (
        finals.packed, finals.grid.count, finals.grid.psum,
        finals.grid.outer, finals.grid.occ)) / 1e6
    print(f"  final tables equal packed_from_grid within {t_dev:.1e}; "
          f"state on the device {state_mb:.1f} MB at B=8 "
          f"({h}x{w} cells a stream)")
    (_, t32, s32), _ = run_fleet(drv, fp.replace(gather_table_bf16=False),
                                 inputs, dev)
    summary["dev_f32"] = fleet_dev("B=8, f32 rows, vs JAX", t32, s32,
                                   fl["pts_f32_traj"], fl["pts_f32_scores"],
                                   spread)
    ref8 = (traj8.cpu().numpy(), sc8.cpu().numpy())
    mid, traj_mid = FLEET_SIZES[1], None
    for b in FLEET_SIZES:
        if b != 8:
            inputs = scaling.build_fleet_inputs(fp, seq, b)
            cuda_kernels.reset_launch_counts()
            (_, traj, sc), _ = run_fleet(drv, fp, inputs, dev)
            n = cuda_kernels.LAUNCHES["newton_solve_batch"]
            fleet_dev(f"B={b}, streams 0-7 vs the B=8 run", traj[:8],
                      sc[:8], *ref8, spread)
            if b == mid:
                traj_mid = (traj, sc)
                (_, rep, _), _ = run_fleet(drv, fp, inputs, dev)
                k = FLEET_STREAM
                same = torch.equal(rep, traj)
                s_xy, s_th = max_dev(rep[k].cpu().numpy(),
                                     traj[k].cpu().numpy())
                print(f"  B={b}, the same inputs again: every trajectory "
                      f"identical {same}; stream {k} (bistable in the "
                      f"reference) moved {s_xy * 1e3:.4f} mm / "
                      f"{s_th * 1e3:.4f} mrad")
                summary["repeat_identical"] = same
        rate, runs = fleet_rate(drv, fp, inputs, dev)
        summary["scans_per_s"][b], summary["run_s"][b] = rate, runs
        summary.setdefault("launches_per_step", {})[b] = n / steps
        print(f"  B={b}: {rate:.1f} aggregate scans/s (median of 3: "
              f"{', '.join(f'{r:.3f}' for r in runs)} s for {b} x {steps} "
              f"scans); {n / steps:.2f} launches per step")
        if b == mid:
            fp4 = fp.replace(occ_every=4)
            (_, t4, s4), _ = run_fleet(drv, fp4, inputs, dev)
            fleet_dev(f"B={b}, occ_every=4 vs occ_every=1", t4, s4,
                      traj.cpu().numpy(), sc.cpu().numpy(), spread)
            # In turns (1, 4, 4, 1): the host drifts inside a call.
            turns = [fleet_rate(drv, p_, inputs, dev)[0]
                     for p_ in (fp, fp4, fp4, fp)]
            summary["scans_per_s"][f"{b}_occ_turns_1441"] = turns
            print(f"  B={b}, aggregate scans/s in turns, occ_every = 1, 4, "
                  f"4, 1: {', '.join(f'{r:.1f}' for r in turns)}")
    return summary, launches, traj_mid


def fleet_full_phase(fp, fl, dev):
    """Phase 7b: run_sequence_features_batch at B = 8 against the JAX
    record with its RANSAC draws, then B = 32 (stream b draws as stream
    b % 8).  Returns (summary, launches of the checked run)."""
    seq = sequence(fl, dev)
    steps = seq.odom.shape[0] - 1
    drv = scan_driver.run_sequence_features_batch
    u8 = torch.as_tensor(fl["ransac_u"], device=dev)
    spread = fleet_spread(fl, "feat")
    summary = {"scans_per_s": {}, "run_s": {}, "jax_spread": spread}
    ref8 = None
    for b in FLEET_FULL_SIZES:
        inputs = scaling.build_fleet_feature_inputs(fp, seq, b)
        u = u8.repeat(b // 8, 1, 1, 1)
        cuda_kernels.reset_launch_counts()
        with map_updates() as updates:
            (_, traj, sc), _ = run_fleet(drv, fp, inputs, dev, ransac_u=u)
        if b == 8:
            launches = dict(cuda_kernels.LAUNCHES)
            if dev.type == "cuda":
                only_batch_entry(launches, "run_sequence_features_batch",
                                 steps, updates)
            print(f"  launches in the B=8 run: {launches}")
            summary["dev"] = fleet_dev("B=8 vs JAX", traj, sc,
                                       fl["feat_traj"], fl["feat_scores"],
                                       spread)
            ref8 = (traj.cpu().numpy(), sc.cpu().numpy())
        else:
            fleet_dev(f"B={b}, streams 0-7 vs the B=8 run", traj[:8],
                      sc[:8], *ref8, spread)
        rate, runs = fleet_rate(drv, fp, inputs, dev, ransac_u=u)
        summary["scans_per_s"][b], summary["run_s"][b] = rate, runs
        print(f"  B={b}: {rate:.1f} aggregate scans/s (median of 3: "
              f"{', '.join(f'{r:.3f}' for r in runs)} s for {b} x {steps} "
              f"scans)")
    return summary, launches


def fleet_serve_phase(fp, fl, traj_b32, sc_b32, dev):
    """Phase 7c: the interleaved and the grouped serving schedules over
    20 streams in groups of 8 (the last group padded)."""
    seq = sequence(fl, dev)
    n, g, c = (FLEET_SERVE[k] for k in ("streams", "group_size",
                                        "time_chunk"))
    inputs = scaling.build_fleet_inputs(fp, seq, n)
    (_, tg, sg), t_grouped = run_fleet(scaling.serve_fleet_grouped, fp,
                                       inputs, dev, group_size=g)
    (fi, ti, si), t_inter = run_fleet(scaling.serve_fleet_interleaved, fp,
                                      inputs, dev, group_size=g,
                                      time_chunk=c)
    check(ti.shape == (n, seq.odom.shape[0] - 1, 3)
          and fi.packed.shape[0] == n, "served fleet has the wrong shape")
    spread = fleet_spread(fl, "pts")
    fleet_dev("interleaved vs grouped", ti, si, tg.cpu().numpy(),
              sg.cpu().numpy(), spread)
    xy, th = fleet_dev(f"grouped vs streams 0-{n - 1} of the "
                       f"B={FLEET_SIZES[1]} run", tg, sg,
                       traj_b32[:n].cpu().numpy(),
                       sc_b32[:n].cpu().numpy(), spread)
    print(f"  grouped {t_grouped:.3f} s, interleaved {t_inter:.3f} s")
    return {"grouped_s": t_grouped, "interleaved_s": t_inter,
            "dev_vs_batch": (xy, th)}


def rolling_phase(fx, dev):
    """Phase 8: rolling_map on the main-path fixture's first scans
    through run_sequence_features, in a window small enough to recentre,
    against the same run on the CPU's plain versions."""
    n = ROLLING["scans"]
    fp = canonical_slam_params().fuser
    fp = fp.replace(ndt=fp.ndt.replace(size_x=ROLLING["size_m"],
                                       size_y=ROLLING["size_m"]),
                    rolling_map=True, roll_margin=ROLLING["roll_margin"])

    def run(device):
        T = lambda x, dt=torch.float32: torch.as_tensor(  # noqa: E731
            x, dtype=dt, device=device)
        ranges, hit = T(fx["ranges"][:n]), T(fx["hit"][:n], torch.bool)
        state = feature_fuser.initialize(fp, T(fx["gt"][0]),
                                         torch.zeros(3, device=device),
                                         ranges[0], hit[0])
        origin0 = state.base.grid.origin.clone()
        final, traj, scores = scan_driver.run_sequence_features(
            fp, state, T(fx["odom"][1:n]), ranges[1:], hit[1:],
            ransac_u=T(fx["ransac_u"][:n - 1]))
        return final, traj, origin0

    cuda_kernels.reset_launch_counts()
    with map_updates() as updates:
        final, traj, origin0 = run(dev)
    sync(dev)
    launches = dict(cuda_kernels.LAUNCHES)
    if dev.type == "cuda":
        check_map_launches(launches, updates, "rolling_map")
        check(launches["newton_solve"] == n - 1
              and sum(launches.values()) == launches["newton_solve"]
              + counted_launches(launches),
              f"run_sequence_features launched {launches}: expected "
              "newton_solve alone, once a scan, beside the map updates")
    cells = (final.base.grid.origin - origin0) / fp.ndt.resolution
    moved = int(cells.abs().max().round())
    table = d2d.packed_from_grid(final.base.grid, fp.ndt)
    t_dev = float((final.base.packed - table).abs().max())
    _, traj_cpu, _ = run(torch.device("cpu"))
    xy, th = max_dev(traj.cpu().numpy(), traj_cpu.numpy())
    print(f"  {n - 1} scans, the window moved by {moved} cells; packed "
          f"table within {t_dev:.1e} of packed_from_grid; trajectory "
          f"within {xy * 1e3:.4f} mm / {th * 1e3:.4f} mrad of the CPU's "
          f"plain versions; launches {launches}")
    check(np.isfinite(traj.cpu().numpy()).all(), "trajectory not finite")
    check(moved >= 2, "the window did not recentre twice")
    check(t_dev <= 1e-4, "the packed table left packed_from_grid")
    check(xy <= XY_TOL and th <= TH_TOL,
          "rolling-map trajectory deviates from the plain versions beyond "
          "1 cm / 5 mrad")
    return {"cells_moved": moved, "dev_xy_m": xy, "dev_theta_rad": th}


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


def atomic_scatter(bases, idx, vals):
    """The map scatter as the port made it before its fixed order: one
    `index_add` per field, atomic on the card.  Kept only to time the
    fixed-order ndt_map.scatter_add_rows against (`scatter_swapped`)."""
    return [b.index_add(0, idx, v) for b, v in zip(bases, vals)]


@contextlib.contextmanager
def scatter_swapped(fn):
    """ndt_map's map scatter replaced by `fn` inside the block."""
    fixed = ndt_map.scatter_add_rows
    ndt_map.scatter_add_rows = fn
    try:
        yield
    finally:
        ndt_map.scatter_add_rows = fixed


@contextlib.contextmanager
def map_updates():
    """Counts the map updates and the feature front end's calls made
    inside the block, {"stats": the calls of ndt_map.add_points_touched
    (add_points, build_from_scan and the fuser's local cell lists reach
    it), "occ": those of ndt_map.update_occupancy, "n": both; "detect",
    "describe", "match": those of detector.detect, descriptor.describe
    and ransac.match_sets / match_sets_gated}.  On the card each
    statistics update is one `segment_add_rows` launch, each occupancy
    update one `occupancy_update` call (its two passes), and each
    feature call one launch of its kernel."""
    count = {"n": 0, "stats": 0, "occ": 0, "detect": 0, "describe": 0,
             "match": 0}
    sites = [(ndt_map, "add_points_touched", "stats", True),
             (ndt_map, "update_occupancy", "occ", True),
             (detector, "detect", "detect", False),
             (descriptor, "describe", "describe", False),
             (ransac, "match_sets", "match", False),
             (ransac, "match_sets_gated", "match", False)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _, _ in sites]

    def counted(fn, kind, is_map):
        def call(*args, **kwargs):
            count["n"] += is_map
            count[kind] += 1
            return fn(*args, **kwargs)
        return call

    for (mod, name, kind, is_map), (_, _, fn) in zip(sites, saved):
        setattr(mod, name, counted(fn, kind, is_map))
    try:
        yield count
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


# The map update's kernel entries: the statistics' fixed-order sum and
# the occupancy update.
MAP_ENTRIES = ("segment_add_rows", "occupancy_update")


def map_launches(launches):
    return sum(launches[k] for k in MAP_ENTRIES)


def counted_launches(launches):
    """The launches `map_updates` accounts for: the map update's kernels
    and the feature front end's."""
    return map_launches(launches) + sum(launches[k] for k in FEATURE_ENTRIES)


def check_map_launches(launches, updates, what):
    """`segment_add_rows` launched exactly once a statistics update,
    `occupancy_update` once an occupancy update and each feature kernel
    once a call of its function in the run (`updates`: map_updates'
    counts), and the run updated its map."""
    check(launches["segment_add_rows"] == updates["stats"]
          and launches["occupancy_update"] == updates["occ"]
          and updates["n"] > 0,
          f"{what}: {launches['segment_add_rows']} segment_add_rows and "
          f"{launches['occupancy_update']} occupancy_update launches for "
          f"{updates['stats']} statistics and {updates['occ']} occupancy "
          "updates")
    check(all(launches[k] == updates[c] for k, c in zip(
        FEATURE_ENTRIES, ("detect", "describe", "match"))),
          f"{what}: feature kernel launches "
          f"{ {k: launches[k] for k in FEATURE_ENTRIES} } for "
          f"{updates['detect']} detect, {updates['describe']} describe and "
          f"{updates['match']} match calls")


def world_scan(fx, t, device, streams=0):
    """Canonical scan `t` in the world at its ground-truth pose: (points,
    mask, sensor position), made on the CPU and copied to `device`, so
    every device scatters the same inputs; with `streams`, a stack in
    which stream k's points are moved by 0.37 k m (the fleet's flat
    scatter)."""
    cpu = torch.device("cpu")
    T = lambda x, dt=torch.float32: torch.as_tensor(  # noqa: E731
        x, dtype=dt, device=cpu)
    pts, mask = dataset.scan_to_points(T(fx["ranges"][t]),
                                       T(fx["hit"][t], torch.bool))
    world = se2.transform_points(T(fx["gt"][t]), pts)
    sensor = T(fx["gt"][t][:2])
    if streams:
        world = torch.stack([world + 0.37 * k for k in range(streams)])
        mask = mask.expand(streams, -1)
        sensor = sensor.expand(streams, 2)
    return tuple(x.to(device) for x in (world, mask, sensor))


def map_update(grid, mp, world, mask, sensor):
    """One scan's map update: add_points_touched, then update_occupancy."""
    grid, _ = ndt_map.add_points_touched(grid, mp, world, mask)
    return ndt_map.update_occupancy(grid, mp, sensor, world, mask)


def map_update_case(mp, fx, device, streams=0, scans=(0, 2, 4)):
    """The map update of canonical scans at their ground-truth poses,
    scan after scan into one grid (or a stack of `streams` grids).
    Returns the fields as numpy."""
    lead = (streams,) if streams else ()
    grid = ndt_map.empty_grid(mp, torch.zeros(lead + (2,), device=device))
    for t in scans:
        grid = map_update(grid, mp, *world_scan(fx, t, device, streams))
    return {k: getattr(grid, k).cpu().numpy()
            for k in ("count", "psum", "outer", "occ")}


def occupancy_cases(mp, fx, streams=0, seed=5):
    """The occupancy update's cases, on the CPU: [(name, params, grid,
    sensor, points, mask)], canonical scan 2 (or a stack of `streams`,
    see world_scan) onto the map of scan 0, and around it each edge of
    the kernel's design: a base near +-occ_clamp (the chain's stop), the
    stop's other direction (occ_hit < 0 < occ_miss), no stop (occ_clamp
    = inf), a base of -0.0 (the dropped entries' +0.0) with zero
    constants, NaN points and points 1e11-1e12 m away (int32 casts out
    of range), a sensor outside the grid, 64-bit counters (720 x 100
    samples), and a 0.3 m grid of 25 x 30 cells with 7 samples a beam
    (divisions that round; the entries wrap around the rows)."""
    cpu = torch.device("cpu")
    lead = (streams,) if streams else ()
    grid = map_update(ndt_map.empty_grid(mp, torch.zeros(lead + (2,))), mp,
                      *world_scan(fx, 0, cpu, streams))
    world, mask, sensor = world_scan(fx, 2, cpu, streams)
    rng = np.random.default_rng(seed)
    c = np.float32(mp.occ_clamp)
    near = np.where(rng.random(grid.occ.shape) < 0.5,
                    np.sign(rng.standard_normal(grid.occ.shape)) * c,
                    rng.uniform(-c - 1.0, c + 1.0, grid.occ.shape))
    near = dataclasses.replace(
        grid, occ=torch.as_tensor(near, dtype=torch.float32))
    neg0 = dataclasses.replace(grid, occ=torch.full_like(grid.occ, -0.0))
    far = world.clone()
    far[..., 0::7, 0] = math.nan
    far[..., 3::11, :] = 1e12
    far[..., 5::13, 1] = -3e11
    far_mask = mask.clone()
    far_mask[..., 1::17] = False
    small = dataclasses.replace(mp, resolution=0.3, size_x=9.0, size_y=7.5,
                                ray_samples=7)
    small_grid = dataclasses.replace(
        ndt_map.empty_grid(small, sensor), occ=torch.full(
            lead + (small.grid_h, small.grid_w), -0.0))
    rp = dataclasses.replace
    return [
        ("canonical", mp, grid, sensor, world, mask),
        ("near the clamp", mp, near, sensor, world, mask),
        ("hit < 0 < miss", rp(mp, occ_hit=-0.3, occ_miss=0.55), near,
         sensor, world, mask),
        ("clamp inf", rp(mp, occ_clamp=math.inf), grid, sensor, world, mask),
        ("-0.0 base", mp, neg0, sensor, world, far_mask),
        ("-0.0 base, zero miss", rp(mp, occ_miss=0.0), neg0, sensor, world,
         mask),
        ("-0.0 base, -0.0 hit", rp(mp, occ_hit=-0.0), neg0, sensor, world,
         far_mask),
        ("NaN and far points", mp, grid, sensor, far, far_mask),
        ("sensor outside", mp, grid, sensor + torch.tensor([60.0, -45.0]),
         world, mask),
        ("64-bit counters", rp(mp, ray_samples=100), near, sensor, world,
         mask),
        ("0.3 m, 7 samples", small, small_grid, sensor, world, far_mask),
    ]


def long_run_case(dev, widths, n_rows=40_000, m=6_000, on_one=5_000,
                  seed=11):
    """A synthetic scatter in which one cell carries `on_one` of the `m`
    entries (random values over six decades, so the order of the adds
    shows in the bits): (bases, idx, vals) on the CPU and on `dev`."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_rows, m)
    idx[rng.permutation(m)[:on_one]] = n_rows // 2 + 17
    bases = [rng.standard_normal((n_rows, c)).astype(np.float32)
             for c in widths]
    vals = [(rng.standard_normal((m, c)) * 10.0 ** rng.integers(
        -3, 3, (m, 1))).astype(np.float32) for c in widths]
    cpu = ([torch.as_tensor(b) for b in bases], torch.as_tensor(idx),
           [torch.as_tensor(v) for v in vals])
    return cpu, ([b.to(dev) for b in cpu[0]], cpu[1].to(dev),
                 [v.to(dev) for v in cpu[2]])


def recorded_scatters(fn):
    """The (bases, idx, vals) of every map scatter that `fn` makes."""
    calls = []
    fixed = ndt_map.scatter_add_rows
    with scatter_swapped(lambda *a: calls.append(a) or fixed(*a)):
        fn()
    return calls


def scatter_bytes(bases, idx, vals):
    """Bytes a scatter must move: each base read and each output written
    once, each entry's values and index read once."""
    return (sum(2 * b.numel() * 4 + v.numel() * 4
                for b, v in zip(bases, vals)) + idx.numel() * 8)


def device_ops_per_call(fn, reps=20):
    """Mean number of device operations (kernels, copies, memsets) a
    call of `fn` launches (torch.profiler)."""
    return sum(n for n, _ in device_by_kernel(fn, reps).values())


def device_by_kernel(fn, reps=50, launches=None, tries=5):
    """{name: (launches, device us)} per call of `fn`, by the name of
    each device operation it runs: kernels, copies and memsets
    (torch.profiler).  The profiler can miss the first launches after
    it starts (it missed one scan's first kernel, and a B = 64
    scatter's first 40 calls): inside the profile, `fn` first runs for
    PROFILE_WARMUP_S, then a spin kernel (torch.cuda._sleep), the `reps`
    calls, and a second spin, and only what starts between the spins
    counts.  A profile that misses a spin, or, with `launches` (the
    device operations a call runs), sees another number between them,
    is taken again, up to `tries` times, and the phase fails if none
    does.  An operation's time is its start-to-end on the device: the
    profiler's self_device_time_total reads 0 for an event it marks
    asynchronous, which halved a kernel's mean in some profiles."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < PROFILE_WARMUP_S:
                fn()
            torch.cuda._sleep(SPIN_CYCLES)
            for _ in range(reps):
                fn()
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
        on_dev = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        spins = [i for i, e in enumerate(on_dev) if "spin_kernel" in e.name]
        calls = on_dev[spins[0] + 1:spins[1]] if len(spins) == 2 else None
        if calls is not None and (launches is None
                                  or len(calls) == launches * reps):
            out = {}
            for e in calls:
                n, us = out.get(e.name, (0, 0.0))
                out[e.name] = (n + 1, us + e.time_range.elapsed_us())
            return {k: (n / reps, us / reps) for k, (n, us) in out.items()}
        print(f"    the profiler saw {len(spins)} of 2 spins and "
              f"{'no' if calls is None else len(calls)} device operations "
              f"between them of {launches} x {reps}: taken again")
    raise PhaseError(f"no profile of {tries} saw {launches} device "
                     f"operations a call in {reps} calls between its spins")


def ops_per_call(fn, tries=3):
    """The device operations one call of `fn` runs: the most that
    `tries` profiles of one call see (the profiler can drop events,
    never add them)."""
    return max(round(sum(n for n, _ in device_by_kernel(fn, 1).values()))
               for _ in range(tries))


def segment_sum_checks(name, calls):
    """The `segment_add_rows` entry on the scatters `calls` of one map
    update (its statistics: the main path's shapes, or a fleet step's;
    the occupancy has a kernel of its own): the CPU's
    index_add bits (its plain version on the same inputs on the CPU:
    tolerance 0), the sorted index_put_ path's bits, identical
    bits on repeat, one counted launch a scatter; by the profiler's
    names, no device operation but its two passes (no sort, no copy,
    no memset), each once a scatter (the bucket pass where it has
    entries), in a profile that saw every launch; device time and time with the
    host in turns against the sorted path and against the plain version
    on the card (index_add, atomic: the one PyTorch call of the same
    function, `library_ms`), on a cold L2 against index_add, and each
    pass's device time, beside the bound of the bytes it must move."""
    before = cuda_kernels.LAUNCHES["segment_add_rows"]
    got = [cuda_kernels.segment_add_rows(*c) for c in calls]
    again = [cuda_kernels.segment_add_rows(*c) for c in calls]
    check(cuda_kernels.LAUNCHES["segment_add_rows"] == before
          + 2 * len(calls), f"{name}: not one launch a scatter")
    # Its passes a call: the bucket pass where a scatter has entries.
    n_bucket = sum(int(c[1].numel() > 0) for c in calls)
    n_launch = n_bucket + len(calls)
    srt = [ndt_map._scatter_add_rows_sorted(*c) for c in calls]
    err, n_diff, n_sorted = 0.0, 0, 0
    for c, g, a, o in zip(calls, got, again, srt):
        cpu = cuda_kernels.segment_add_rows_reference(
            [b.cpu() for b in c[0]], c[1].cpu(), [v.cpu() for v in c[2]])
        for x, y, z, w in zip(g, a, o, cpu):
            x = x.cpu()
            err = max(err, float((x - w).abs().max()))
            n_diff += int((_bits(x.numpy()) != _bits(w.numpy())).sum())
            n_diff += int(not torch.equal(x, y.cpu()))
            n_sorted += int((_bits(x.numpy()) != _bits(z.cpu().numpy())).sum())
    print(f"  {name}: {len(calls)} scatters ("
          + ", ".join(f"{c[1].shape[0]} entries x "
                      f"{sum(b.shape[1] for b in c[0])} channels on "
                      f"{c[0][0].shape[0]} rows" for c in calls)
          + f"); elements off the CPU's bits or not repeating {n_diff}, off "
          f"the sorted index_put_ path's {n_sorted}; max |kernel - CPU| "
          f"{err:.1e}")
    check(n_diff == 0 and n_sorted == 0,
          f"{name}: segment_add_rows is not the CPU's and the sorted "
          "path's bits")

    def kernel():
        return [cuda_kernels.segment_add_rows(*c) for c in calls]

    def plain():
        return [cuda_kernels.segment_add_rows_reference(*c) for c in calls]

    def sorted_path():
        return [ndt_map._scatter_add_rows_sorted(*c) for c in calls]

    # Exactly its passes: the profile sees n_launch device operations a
    # call, or is taken again (device_by_kernel).
    ops = device_by_kernel(kernel, launches=n_launch)
    n_ops = sum(n for n, _ in ops.values())
    n_pass = lambda part: sum(  # noqa: E731
        n for k, (n, _) in ops.items() if part in k)
    print(f"    device operations a call of the {len(calls)} scatters: "
          + ", ".join(f"{k[:60]} x {n:.1f}" for k, (n, _) in ops.items()))
    check(all("segment_add_rows" in k for k in ops)
          and n_pass("segment_add_rows_bucket_pass") == n_bucket
          and n_pass("segment_add_rows_row_pass") == len(calls),
          f"{name}: segment_add_rows ran another device operation than "
          f"its two passes (a sort, a copy, a memset), or not each pass "
          f"once a scatter: {sorted(ops)}")
    t_sorted = time_turns(kernel, sorted_path, 50, 50,
                          label="sorted index_put_", launches=n_launch,
                          plain_launches=ops_per_call(sorted_path))
    t_atomic = time_turns(kernel, plain, 50, 50, label="index_add",
                          launches=n_launch,
                          plain_launches=ops_per_call(plain))
    # On a cold L2 full of dirty lines, as a fleet step's other work
    # leaves it: a read-modify-write of L2_FLUSH_BYTES before each call.
    buf = torch.ones(L2_FLUSH_BYTES // 4, device=calls[0][1].device)
    cold = [cold_ms(f, lambda: buf.add_(1.0))
            for f in (plain, kernel, kernel, plain)]
    del buf
    print("    device time on a cold, dirty L2, us (index_add, kernel, "
          "kernel, index_add; CUDA events): "
          + ", ".join(f"{t * 1e3:.2f}" for t in cold))
    by_kernel = {k: us for k, (_, us) in ops.items()}
    own = sum(by_kernel.values())
    n_bytes = sum(scatter_bytes(*c) for c in calls)
    n_adds = sum(c[1].numel() * sum(b.shape[1] for b in c[0]) for c in calls)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_adds / F32_FLOP_PER_S
    out = {"max_abs_err": err, "tolerance": "bits (0)",
           "ms": (t_sorted["ms"] + t_atomic["ms"]) / 2,
           "plain_ms": t_atomic["plain_ms"],
           "events_ms": (t_sorted["events_ms"] + t_atomic["events_ms"]) / 2,
           "plain_events_ms": t_atomic["plain_events_ms"],
           "sorted_ms": t_sorted["plain_ms"],
           "sorted_events_ms": t_sorted["plain_events_ms"],
           "kernel_alone_ms": own * 1e-3,
           "bucket_pass_ms": sum(v for k, v in by_kernel.items()
                                 if "bucket_pass" in k) * 1e-3,
           "row_pass_ms": sum(v for k, v in by_kernel.items()
                              if "row_pass" in k) * 1e-3,
           "device_ops": n_ops,
           "cold_ms": (cold[1] + cold[2]) / 2,
           "library_cold_ms": (cold[0] + cold[3]) / 2,
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": n_bytes, "scatters": len(calls)}
    out["library_ms"] = out["plain_ms"]
    print(f"    device us: the entry {out['ms'] * 1e3:.2f} (bucket pass "
          f"{out['bucket_pass_ms'] * 1e3:.2f}, row pass "
          f"{out['row_pass_ms'] * 1e3:.2f}; by name: "
          + ", ".join(f"{k[:60]} {v:.2f}" for k, v in sorted(
              by_kernel.items(), key=lambda kv: -kv[1]))
          + f"), sorted index_put_ {out['sorted_ms'] * 1e3:.2f}, index_add "
          f"{out['plain_ms'] * 1e3:.2f}; with the host "
          f"{out['events_ms'] * 1e3:.2f} / "
          f"{out['sorted_events_ms'] * 1e3:.2f} / "
          f"{out['plain_events_ms'] * 1e3:.2f}; cold L2 "
          f"{out['cold_ms'] * 1e3:.2f} (index_add "
          f"{out['library_cold_ms'] * 1e3:.2f}); bound "
          f"{out['bound_ms'] * 1e3:.3f} ({out['bound_by']}: "
          f"{n_bytes / 1e6:.2f} MB)")
    return out


def segment_layout_cases(dev, widths):
    """The segment sum's layouts beyond the map's own scatters, at the
    map's 40,000 rows: [(name, (bases, idx, vals) on the CPU, the same
    on `dev`)]: every entry on one row (3,000, three tiles and six row
    chunks); a row block's entries in every one of five tiles; 1,300
    entries in one row block (three chunks); no entry; one entry;
    -0.0 bases with a third of the values -0.0; a stack of 8 grids' scan
    with 40% of its points dropped, their zeros at k mod the cells
    (ndt_map._drop_rows, the fleet's); rows past 16,384 row blocks of
    256 rows (the kernel's kMaxBuckets), so a bucket holds two row
    blocks (4,195,304 rows)."""
    rng = np.random.default_rng(sum(widths))
    n = 40_000
    cases = {
        "one row": (n, np.full(3_000, n // 2 + 17)),
        "multi-tile": (n, np.where(np.arange(5_000) % 7 == 0,
                                   rng.integers(512, 768, 5_000),
                                   rng.integers(0, n, 5_000))),
        "multi-chunk": (n, np.concatenate([rng.integers(256, 512, 1_300),
                                           rng.integers(0, n, 400)])),
        "M = 0": (n, np.zeros(0, np.int64)),
        "M = 1": (n, np.array([n - 1])),
        "-0.0 bases": (n, rng.integers(0, n // 4, 4_000)),
        "wide buckets": (16_384 * 256 + 1_000, np.concatenate([
            rng.integers(0, 16_384 * 256 + 1_000, 3_000),
            np.full(300, 16_384 * 256 + 999), np.full(300, 300)])),
    }
    out = []
    for name, (n_rows, idx) in cases.items():
        m = len(idx)
        bases = [rng.standard_normal((n_rows, c)).astype(np.float32)
                 for c in widths]
        vals = [(rng.standard_normal((m, c)) * 10.0 ** rng.integers(
            -3, 3, (m, 1))).astype(np.float32) for c in widths]
        if name == "-0.0 bases":
            bases = [np.full_like(b, -0.0) for b in bases]
            for v in vals:
                v[::3] = -0.0
        out.append((name, n_rows, idx, bases, vals))
    lead, cells, pts = (8,), 40_000, 720
    ok = torch.as_tensor(rng.random(lead + (pts,)) < 0.6)
    flat = torch.as_tensor(rng.integers(0, cells, lead + (pts,)))
    idx = torch.where(ok, flat + ndt_map._stream_offsets(lead, cells, "cpu"),
                      ndt_map._drop_rows(ok.shape, 8 * cells, "cpu"))
    vals = [(rng.standard_normal((8 * pts, c))
             * ok.reshape(-1, 1).numpy()).astype(np.float32) for c in widths]
    bases = [rng.standard_normal((8 * cells, c)).astype(np.float32)
             for c in widths]
    out.append(("dropped entries", 8 * cells, idx.reshape(-1).numpy(), bases,
                vals))
    cases = []
    for name, n_rows, idx, bases, vals in out:
        cpu = ([torch.as_tensor(b) for b in bases],
               torch.as_tensor(np.asarray(idx, np.int64)),
               [torch.as_tensor(v) for v in vals])
        cases.append((name, cpu, ([b.to(dev) for b in cpu[0]],
                                  cpu[1].to(dev),
                                  [v.to(dev) for v in cpu[2]])))
    return cases


def segment_layout_checks(dev):
    """segment_add_rows on every case of segment_layout_cases at the
    map's 1 + 2 + 4 channels and at one: the CPU's bits, the sorted
    path's (where there are entries, and where that path gives the
    CPU's bits: its sums start from +0.0, so a -0.0 base whose entries
    sum to a zero comes out +0.0 there), the same bits on repeat, one
    launch a call.  ({case: elements off, plus 1 if a repeat differs},
    {case: the sorted path's own elements off the CPU's bits})."""
    out, sorted_own = {}, {}
    for widths in ((1, 2, 4), (1,)):
        for name, (cb, ci, cv), (gb, gi, gv) in segment_layout_cases(
                dev, widths):
            before = cuda_kernels.LAUNCHES["segment_add_rows"]
            got = cuda_kernels.segment_add_rows(gb, gi, gv)
            again = cuda_kernels.segment_add_rows(gb, gi, gv)
            check(dev.type != "cuda"
                  or cuda_kernels.LAUNCHES["segment_add_rows"] == before + 2,
                  f"{name}: not one segment_add_rows launch a call")
            want = cuda_kernels.segment_add_rows_reference(cb, ci, cv)
            srt = (ndt_map._scatter_add_rows_sorted(gb, gi, gv)
                   if ci.numel() else want)
            off = own = 0
            for a, b, c, d in zip(got, again, want, srt):
                a_np, c_np = _bits(a.cpu().numpy()), _bits(c.numpy())
                d_np = _bits(d.cpu().numpy())
                off += int((a_np != c_np).sum())
                off += int(((a_np != d_np) & (d_np == c_np)).sum())
                off += int(not torch.equal(a, b))
                own += int((d_np != c_np).sum())
            out[f"{name}, channels {widths}"] = off
            sorted_own[f"{name}, channels {widths}"] = own
    return out, sorted_own


@contextlib.contextmanager
def occupancy_plain():
    """ndt_map.update_occupancy replaced by its plain twin inside the
    block: on the card the path the occupancy kernel replaced (the eager
    ray build, then scatter_add_rows: segment_add_rows)."""
    kernel = ndt_map.update_occupancy
    ndt_map.update_occupancy = ndt_map._update_occupancy_plain
    try:
        yield
    finally:
        ndt_map.update_occupancy = kernel


@contextlib.contextmanager
def occupancy_forced(k):
    """The occupancy kernel's cluster forced to k blocks a stream (raised
    to the fewest that hold a case's grid), or to the two-pass path
    (k = 0), inside the block."""
    rule = cuda_kernels.occupancy_cluster

    def forced(rows, wide, n_streams, resident):
        fewest = rule(rows, wide, 1 << 30, lambda _: 0)
        return 0 if k == 0 or fewest == 0 else max(k, fewest)

    cuda_kernels.occupancy_cluster = forced
    try:
        yield
    finally:
        cuda_kernels.occupancy_cluster = rule


OCCUPANCY_PATHS = (0, 1, 2, 4, 8, 16)   # two-pass, then blocks a stream


def occupancy_blocks(mp, mask, n_streams):
    """The blocks a stream of the wrapper's own choice for an update of
    n_streams grids by points with this mask (..., P) on the card."""
    n_pts, rows = mask.shape[-1], mp.grid_h * mp.grid_w
    wide = n_pts >= 2 ** 16 or n_pts * mp.ray_samples >= 2 ** 16
    return cuda_kernels.occupancy_cluster(
        rows, wide, n_streams, cuda_kernels._occupancy_resident(
            cuda_kernels.build(), mask.device, rows, wide))


def occupancy_case_checks(mp, fx, dev, streams=0, paths=()):
    """Every case of occupancy_cases through ndt_map.update_occupancy on
    `dev`, twice, against the plain twin on the CPU: {case: elements off
    the CPU's bits, plus 1 if the second call differs}, summed over the
    wrapper's own choice and each forced path of `paths`
    (occupancy_forced); on the card one `occupancy_update` call each."""
    out = {}
    for name, p, grid, sensor, pts, mask in occupancy_cases(mp, fx,
                                                            streams):
        want = _bits(ndt_map.update_occupancy(grid, p, sensor, pts,
                                              mask).occ.numpy())
        args = (node_mod.map_tensors(lambda x: x.to(dev), grid), p,
                sensor.to(dev), pts.to(dev), mask.to(dev))
        out[name] = 0
        for k in (None, *paths):
            with (contextlib.nullcontext() if k is None
                  else occupancy_forced(k)):
                before = cuda_kernels.LAUNCHES["occupancy_update"]
                a = ndt_map.update_occupancy(*args).occ
                b = ndt_map.update_occupancy(*args).occ
            check(dev.type != "cuda"
                  or cuda_kernels.LAUNCHES["occupancy_update"] == before + 2,
                  f"{name}: not one occupancy_update a call")
            out[name] += (int((_bits(a.cpu().numpy()) != want).sum())
                          + int(not torch.equal(a, b)))
    return out


def occupancy_checks(name, mp, grid, scan):
    """The `occupancy_update` entry on one map update's occupancy (grid:
    a map on the card, scan: its (points, mask, sensor)): the CPU's
    bits (its plain twin on the same inputs on the CPU: tolerance 0),
    the parent's path's bits, identical bits on repeat, one call an
    update; device time and time with the host in turns against the
    parent's path (the plain twin on the card: the eager ray build, the
    sort and segment_add_rows) and against the one PyTorch call of its
    scatter, an atomic index_add of the plain twin's entries (the
    scatter alone, not the ray build: `library_ms`), and against the
    parent's path on a cold L2; the kernel's own device time beside the
    bound of the bytes it must move, and its longest chain of adds (the
    row pass's count of adds, read back)."""
    world, mask, sensor = scan
    dev = world.device

    def kernel():
        return ndt_map.update_occupancy(grid, mp, sensor, world, mask)

    def parent():
        return ndt_map._update_occupancy_plain(grid, mp, sensor, world, mask)

    before = cuda_kernels.LAUNCHES["occupancy_update"]
    got, again = kernel().occ, kernel().occ
    check(cuda_kernels.LAUNCHES["occupancy_update"] == before + 2,
          f"{name}: not one occupancy_update a call")
    want = ndt_map.update_occupancy(
        node_mod.map_tensors(torch.Tensor.cpu, grid), mp, sensor.cpu(),
        world.cpu(), mask.cpu()).occ
    x, w_, par = got.cpu(), want, parent().occ.cpu()
    err = float((x - w_).abs().max())
    n_diff = (int((_bits(x.numpy()) != _bits(w_.numpy())).sum())
              + int(not torch.equal(got, again)))
    n_parent = int((_bits(x.numpy()) != _bits(par.numpy())).sum())
    chain = torch.zeros(grid.occ.numel(), dtype=torch.int32, device=dev)
    cuda_kernels.update_occupancy(grid, mp, sensor, world, mask, chain=chain)
    longest, adds = int(chain.max()), int(chain.sum())
    entries = recorded_scatters(parent)
    check(len(entries) == 1, f"{name}: the plain twin made "
                             f"{len(entries)} scatters, expected 1")

    def library():
        return atomic_scatter(*entries[0])

    print(f"  {name}: occupancy_update on {grid.occ.numel()} cells, "
          f"{entries[0][1].numel()} entries: elements off the CPU's bits or "
          f"not repeating {n_diff}, off the parent's path's {n_parent}; "
          f"max |kernel - CPU| {err:.1e}; longest chain {longest} adds "
          f"({adds} in all)")
    check(n_diff == 0 and n_parent == 0,
          f"{name}: occupancy_update is not the CPU's and the parent's bits")
    n_launch = ops_per_call(kernel)
    check(n_launch == 1, f"{name}: {n_launch} device operations a call, "
                         "expected the one cluster launch")

    def two_pass():
        with occupancy_forced(0):
            return kernel()

    t_p = time_turns(kernel, parent, 50, 50, label="parent's path",
                     launches=n_launch, plain_launches=ops_per_call(parent))
    t_l = time_turns(kernel, library, 50, 50, label="index_add alone",
                     launches=n_launch, plain_launches=ops_per_call(library))
    t_2 = time_turns(kernel, two_pass, 50, 50, label="two-pass path",
                     launches=n_launch, plain_launches=2)
    # On a cold L2 full of dirty lines, as a fleet step's statistics and
    # table refresh leave it: a read-modify-write of L2_FLUSH_BYTES before
    # each call.
    buf = torch.ones(L2_FLUSH_BYTES // 4, device=dev)
    cold = [cold_ms(f, lambda: buf.add_(1.0))
            for f in (parent, kernel, two_pass, kernel, two_pass, parent)]
    del buf
    print("    device time on a cold, dirty L2, us (parent's path, kernel, "
          "two-pass path, kernel, two-pass path, parent's path; CUDA "
          "events): " + ", ".join(f"{t * 1e3:.2f}" for t in cold))
    by_kernel = {k: us for k, (_, us) in device_by_kernel(
        kernel, launches=n_launch).items()}
    own = sum(v for k, v in by_kernel.items() if "occupancy" in k)
    n_streams = grid.occ.numel() // (mp.grid_h * mp.grid_w)
    n_pts = mask.numel()
    n_bytes = 8 * grid.occ.numel() + 9 * n_pts + 16 * n_streams
    # Operations: a sample's cell 13 (its position 7, the division t 1,
    # the cell 5), a hit's 4, a row's adds and its clamp (2).
    n_ops = (13 * n_pts * mp.ray_samples + 4 * n_pts + adds
             + 2 * grid.occ.numel())
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOP_PER_S
    out = {"max_abs_err": err, "tolerance": "bits (0)",
           "ms": (t_p["ms"] + t_l["ms"]) / 2,
           "plain_ms": t_p["plain_ms"],
           "events_ms": (t_p["events_ms"] + t_l["events_ms"]) / 2,
           "plain_events_ms": t_p["plain_events_ms"],
           "library_ms": t_l["plain_ms"],
           "library_events_ms": t_l["plain_events_ms"],
           "library_call": "index_add (atomic) of the plain twin's "
                           "entries: the scatter alone, not the ray build",
           "kernel_alone_ms": own * 1e-3,
           "cold_ms": (cold[1] + cold[3]) / 2,
           "plain_cold_ms": (cold[0] + cold[5]) / 2,
           "cluster": occupancy_blocks(mp, mask, n_streams),
           "two_pass_ms": t_2["plain_ms"],
           "two_pass_cold_ms": (cold[2] + cold[4]) / 2,
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": n_bytes, "longest_chain": longest, "chain_adds": adds,
           "chain_ms": longest * ADD_CYCLES / SM_CLOCK_HZ * 1e3,
           "entries": entries[0][1].numel()}
    print(f"    device us: occupancy_update {out['ms'] * 1e3:.2f} (its "
          f"kernels alone {own:.2f}; by name: "
          + ", ".join(f"{k[:40]} {v:.2f}" for k, v in sorted(
              by_kernel.items(), key=lambda kv: -kv[1]))
          + f"), the two-pass path {out['two_pass_ms'] * 1e3:.2f}, the "
          f"parent's path {out['plain_ms'] * 1e3:.2f}, index_add "
          f"alone {out['library_ms'] * 1e3:.2f}; with the host "
          f"{out['events_ms'] * 1e3:.2f} / "
          f"{out['plain_events_ms'] * 1e3:.2f} / "
          f"{out['library_events_ms'] * 1e3:.2f}; bound "
          f"{out['bound_ms'] * 1e3:.3f} ({out['bound_by']}: "
          f"{n_bytes / 1e6:.3f} MB); the longest chain's adds "
          f"{out['chain_ms'] * 1e3:.3f}")
    return out


def map_update_phase(sp, fx, dev):
    """Phase 3e: the map update on the card (ndt_map.add_points_touched
    through scatter_add_rows, the `segment_add_rows` kernel;
    ndt_map.update_occupancy, the `occupancy_update` kernel) equals the
    CPU's bit for bit on the same points, equals the parent's path (the
    statistics through the sorted index_put_ path, the occupancy through
    its plain twin) and repeats: one grid, a stack of 3 and a stack of
    64, three canonical scans, one launch a statistics update and one
    occupancy_update an occupancy update; every case of
    occupancy_cases at 1, 3 and 64 grids; a synthetic scatter with
    5,000 entries on one cell and the layouts of segment_layout_cases
    (one row, several tiles, several chunks, no entry and one, -0.0
    bases, dropped entries, wide buckets).  One scan's update and one B = 64 fleet
    step's, timed in turns against the parent's path and the atomic
    index_add (swapped in as the whole map scatter, the occupancy
    through its plain twin); each kernel entry's own checks and times
    at both shapes.  And torch's float32 sqrt on the card is correctly
    rounded (numpy's)."""
    mp = sp.fuser.ndt
    out = {}
    for streams in (0, 3, 64):
        cpu = map_update_case(mp, fx, torch.device("cpu"), streams)
        before = {k: cuda_kernels.LAUNCHES[k] for k in MAP_ENTRIES}
        card = map_update_case(mp, fx, dev, streams)
        again = map_update_case(mp, fx, dev, streams)
        n_launch = {k: cuda_kernels.LAUNCHES[k] - before[k]
                    for k in MAP_ENTRIES}
        diff = {k: int((_bits(card[k]) != _bits(cpu[k])).sum()) for k in cpu}
        off_parent = {}
        if dev.type == "cuda":      # sequential there; not on CPU threads
            with scatter_swapped(ndt_map._scatter_add_rows_sorted), \
                    occupancy_plain():
                srt = map_update_case(mp, fx, dev, streams)
            off_parent = {k: int((_bits(card[k]) != _bits(srt[k])).sum())
                          for k in cpu}
        rep = all(np.array_equal(_bits(card[k]), _bits(again[k]))
                  for k in card)
        print(f"  {streams or 1} grid(s), 3 scans: elements differing from "
              f"the CPU's bits {diff}, from the parent's path's "
              f"{off_parent}; a second run identical: {rep}; launches "
              f"{n_launch} (2 runs x 3 scans, one of each a scan)")
        check(rep and not any(diff.values()) and not any(
            off_parent.values()),
              "the map update on the card is not the CPU's bit for bit")
        check(dev.type != "cuda" or n_launch == {"segment_add_rows": 6,
                                                 "occupancy_update": 6},
              "the map update did not launch segment_add_rows once a "
              "statistics update and occupancy_update once an occupancy "
              "update")
        out[f"differing_{streams or 1}"] = diff
        cases = occupancy_case_checks(
            mp, fx, dev, streams,
            OCCUPANCY_PATHS if dev.type == "cuda" else ())
        print(f"  {streams or 1} grid(s), the occupancy cases at the "
              f"wrapper's cluster size, at every forced size "
              f"{OCCUPANCY_PATHS[1:]} and on the two-pass path: elements "
              f"off the CPU's bits or not repeating {cases}")
        check(not any(cases.values()),
              "occupancy_update departs from the CPU on a case")
        out[f"occupancy_cases_{streams or 1}"] = cases
    # A grid whose counters no cluster holds takes the two-pass path.
    big = dataclasses.replace(mp, size_x=6 * mp.size_x, size_y=6 * mp.size_y)
    rows = big.grid_h * big.grid_w
    cpu = map_update_case(big, fx, torch.device("cpu"), scans=(0,))
    card = map_update_case(big, fx, dev, scans=(0,))
    again = map_update_case(big, fx, dev, scans=(0,))
    off = sum(int((_bits(card[k]) != _bits(cpu[k])).sum())
              + int(not np.array_equal(_bits(card[k]), _bits(again[k])))
              for k in cpu)
    path = cuda_kernels.occupancy_cluster(rows, False, 1, lambda _: 0)
    print(f"  a {big.grid_h} x {big.grid_w} grid ({rows} cells; cluster "
          f"{path}: the two-pass path), scan 0: elements off the CPU's bits "
          f"or not repeating {off}")
    check(off == 0 and path == 0,
          "the two-pass path on a large grid departs from the CPU")
    out["occupancy_two_pass_grid"] = {"cells": rows, "off": off}
    if dev.type == "cuda":
        for widths in ((1, 2, 4), (1,)):
            (cb, ci, cv), (gb, gi, gv) = long_run_case(dev, widths)
            want = cuda_kernels.segment_add_rows_reference(cb, ci, cv)
            got = cuda_kernels.segment_add_rows(gb, gi, gv)
            again = cuda_kernels.segment_add_rows(gb, gi, gv)
            srt = ndt_map._scatter_add_rows_sorted(gb, gi, gv)
            same = all(np.array_equal(_bits(a.cpu().numpy()),
                                      _bits(b.numpy()))
                       and torch.equal(a, c) and torch.equal(a, d)
                       for a, b, c, d in zip(got, want, again, srt))
            print(f"  5,000 of 6,000 entries on one cell, channels "
                  f"{widths}: the CPU's bits, the sorted path's, repeats: "
                  f"{same}")
            check(same, "segment_add_rows departs from the CPU on a long run")
            out[f"long_run_{sum(widths)}"] = same
        layouts, sorted_own = segment_layout_checks(dev)
        print(f"  segment_add_rows' layouts (segment_layout_cases): elements "
              f"off the CPU's and the sorted path's bits or not repeating "
              f"{layouts}; the sorted path's own elements off the CPU's "
              f"bits {sorted_own}")
        check(not any(layouts.values()),
              "segment_add_rows departs from the CPU on a layout")
        out["segment_layouts"] = layouts
        out["segment_layouts_sorted_off_cpu"] = sorted_own
    r, h = torch.as_tensor(fx["ranges"]), torch.as_tensor(fx["hit"])
    pts_cpu = dataset.scan_to_points(r, h)[0].numpy()
    pts_card = dataset.scan_to_points(r.to(dev), h.to(dev))[0].cpu().numpy()
    out["scan_points_differing"] = int(
        (_bits(pts_card) != _bits(pts_cpu)).sum())
    print(f"  scan_to_points of the {r.shape[0]} canonical scans on "
          f"{dev.type}: {out['scan_points_differing']} coordinates differ "
          "from the CPU's bits")
    check(out["scan_points_differing"] == 0,
          "scan_to_points on the card is not the CPU's bit for bit")
    x = torch.rand(SQRT_N, device=dev) * 100.0
    ref = np.sqrt(x.cpu().numpy())
    n_sqrt = int((torch.sqrt(x).cpu().numpy() != ref).sum())
    n_cpu = int((torch.sqrt(x.cpu()).numpy() != ref).sum())
    print(f"  torch.sqrt on {SQRT_N} float32 values on {dev.type}: {n_sqrt} "
          f"differ from numpy.sqrt (torch's CPU build here: {n_cpu})")
    if dev.type == "cuda":
        check(n_sqrt == 0, "torch.sqrt on the card is not correctly rounded")
    out["sqrt_cpu_differing"] = n_cpu
    out["sqrt_differing"] = n_sqrt
    if dev.type != "cuda":
        return out, None, None
    checks, occ = {}, {}
    for name, streams in (("one scan", 0), ("B=64 fleet step", 64)):
        lead = (streams,) if streams else ()
        grid = map_update(ndt_map.empty_grid(mp, torch.zeros(
            lead + (2,), device=dev)), mp, *world_scan(fx, 0, dev, streams))
        scan = world_scan(fx, 2, dev, streams)

        def ordered(grid=grid, scan=scan):
            return map_update(grid, mp, *scan)

        def parent():
            with occupancy_plain():
                return ordered()

        def atomic():
            with scatter_swapped(atomic_scatter), occupancy_plain():
                return ordered()

        print(f"  {name}'s map update (add_points_touched + "
              f"update_occupancy, 720 points, 720 x 49 occupancy entries"
              f"{f' a stream, {streams} streams' if streams else ''}), "
              "the kernels vs the parent's path (the occupancy through "
              "segment_add_rows) and vs the atomic index_add:")
        t_p = time_turns(ordered, parent, 50, 50, label="parent's path")
        t_a = time_turns(ordered, atomic, 50, 50, label="index_add")
        key = "fleet64_" if streams else ""
        out.update({f"{key}ordered_us": (t_p["ms"] + t_a["ms"]) / 2 * 1e3,
                    f"{key}parent_us": t_p["plain_ms"] * 1e3,
                    f"{key}atomic_us": t_a["plain_ms"] * 1e3,
                    f"{key}ordered_events_us":
                        (t_p["events_ms"] + t_a["events_ms"]) / 2 * 1e3,
                    f"{key}parent_events_us": t_p["plain_events_ms"] * 1e3,
                    f"{key}atomic_events_us": t_a["plain_events_ms"] * 1e3,
                    f"{key}device_ops": device_ops_per_call(ordered),
                    f"{key}parent_device_ops": device_ops_per_call(parent)})
        print(f"    device operations a map update: "
              f"{out[f'{key}device_ops']:.1f} (the parent's path "
              f"{out[f'{key}parent_device_ops']:.1f})")
        checks[name] = segment_sum_checks(name, recorded_scatters(ordered))
        occ[name] = occupancy_checks(name, mp, grid, scan)
    main = dict(checks["one scan"])
    main["fleet64"] = checks["B=64 fleet step"]
    occ_main = dict(occ["one scan"])
    occ_main["fleet64"] = occ["B=64 fleet step"]
    return out, main, occ_main


def localize_phase(sp, fx, dev):
    """Phase 10: cli.py cmd_localize's two modes at the canonical point
    against the JAX record (canonical_localize.npz): the map of every
    second scan of the first half at ground-truth poses with a 32-scan
    database; the distance field exactly; relocalize of scan 67 on
    JAX's draws (the same stored scan and inliers, pose within
    1 cm / 5 mrad, badness within 1e-5 m); MCL with 512 particles over
    the second half on JAX's recorded draws: every estimate within the
    reference's own spread (its 31 runs with the odometry moved by
    +-k * 1e-6, k = 1..16), no more differing resampling decisions than
    the most those runs show (the effective sample size sits near n/2
    at a few steps), the final error within theirs.  Times MCL steps/s (median of 3 after a
    warm-up), relocalize, build_distance_map and adjust_pose."""
    lx = dict(np.load(LOCALIZE_FIXTURE))
    mp = sp.fuser.ndt
    fp_db = FeatureParams(num_beams=sp.fuser.features.num_beams,
                          max_range=mp.sensor_range)
    check(repr(mp) == str(lx["params_repr"])
          and repr(fp_db) == str(lx["features_repr"]),
          "canonical_localize.npz was made at other parameters")
    T = lambda x, dt=torch.float32: torch.as_tensor(  # noqa: E731
        x, dtype=dt, device=dev)
    ranges, hit = T(fx["ranges"]), T(fx["hit"], torch.bool)
    odom, gt = T(fx["odom"]), T(fx["gt"])
    split, q = int(lx["split"]), int(lx["query"])
    cuda_kernels.reset_launch_counts()
    updates = {"n": 0, "stats": 0, "occ": 0, "detect": 0, "describe": 0,
               "match": 0}

    grid = ndt_map.empty_grid(mp, torch.zeros(2, device=dev))
    db = place_rec.empty_database(fp_db, 32, dev)
    for t in lx["map_scans"]:
        pts, mask = dataset.scan_to_points(ranges[t], hit[t])
        world = se2.transform_points(gt[t], pts)
        with map_updates() as n_map:
            grid = ndt_map.add_points(grid, mp, world, mask)
            grid = ndt_map.update_occupancy(grid, mp, gt[t][:2], world,
                                            mask)
            db = place_rec.insert_scan(db, fp_db, gt[t], ranges[t], hit[t])
        for k in updates:
            updates[k] += n_map[k]
    check(int(db.mask.sum()) == int(lx["db_used"]),
          f"{int(db.mask.sum())} scans stored, JAX {int(lx['db_used'])}")
    tgt = d2d.make_dense_target(grid, mp)

    dmap = monitor.build_distance_map(grid.occ, grid.origin, mp.resolution)
    n_bad = int((dmap.dist.cpu().numpy() != lx["dist"]).sum())
    print(f"  {int(db.mask.sum())} scans stored; distance field "
          f"{tuple(dmap.dist.shape)}: {n_bad} cells differ from JAX's")
    check(n_bad == 0, "the distance field is not JAX's")
    u = T(lx["reloc_u"])
    with map_updates() as n_map:
        pose, best, n = place_rec.relocalize(db, fp_db, ranges[q], hit[q], u,
                                             min_num_matches=8)
    for k in updates:
        updates[k] += n_map[k]
    check(pose is not None and best == int(lx["reloc_best"])
          and n == int(lx["reloc_inliers"]),
          f"relocalize: stored scan {best}, {n} inliers; JAX "
          f"{int(lx['reloc_best'])}, {int(lx['reloc_inliers'])}")
    r_xy, r_th = max_dev(pose, lx["reloc_pose"])
    pts_q, mask_q = dataset.scan_to_points(ranges[q], hit[q])
    bad = float(monitor.badness(dmap, T(pose), pts_q, mask_q))
    adj, adj_score = monitor.adjust_pose(dmap, T(pose), pts_q, mask_q)
    a_xy, a_th = max_dev(adj.cpu().numpy(), lx["adjust_pose"])
    print(f"  scan {q} -> stored scan {best} with {n} inliers (JAX the "
          f"same); pose {r_xy * 1e3:.4f} mm / {r_th * 1e3:.4f} mrad from "
          f"JAX's; badness {bad:.6f} m (JAX {float(lx['reloc_badness']):.6f});"
          f" adjust_pose {a_xy * 1e3:.4f} mm / {a_th * 1e3:.4f} mrad, score "
          f"{float(adj_score):.6f} (JAX {float(lx['adjust_score']):.6f})")
    check(r_xy <= XY_TOL and r_th <= TH_TOL, "relocalized pose off JAX's")
    check(abs(bad - float(lx["reloc_badness"])) <= BADNESS_TOL,
          "badness off JAX's")
    check(abs(float(adj_score) - float(lx["adjust_score"])) <= BADNESS_TOL,
          "adjust_pose's badness off JAX's")

    draws = mcl.recorded_draws(T(lx["mcl_init_xy"]), T(lx["mcl_init_theta"]),
                               T(lx["mcl_noise"]), lx["mcl_resampled"],
                               T(lx["mcl_u0"]))

    def track():
        sync(dev)
        t0 = time.perf_counter()
        loc = mcl.MCL(mp, MotionParams(), tgt,
                      n_particles=int(lx["particles"]), draws=draws)
        loc.initialize(gt[split], spread_xy=0.5, spread_theta=0.2)
        est = [loc.step(odom[t], *dataset.scan_to_points(ranges[t], hit[t]))
               for t in range(split + 1, ranges.shape[0])]
        est = torch.stack(est)
        sync(dev)
        return est.cpu().numpy(), loc.resampled, time.perf_counter() - t0

    est, resampled, _ = track()
    ref, ref_eps = lx["mcl_est"], lx["mcl_est_eps"]    # eps: (31, S, 3)
    spread = max_dev(ref_eps, ref)
    tol = (max(spread[0], XY_TOL), max(spread[1], TH_TOL))
    dxy, dth = max_dev(est, ref)
    n_dec = int((np.asarray(resampled) != lx["mcl_resampled"]).sum())
    n_dec_eps = int((lx["mcl_resampled_eps"] != lx["mcl_resampled"]
                     ).sum(-1).max())
    gt_np = fx["gt"][split + 1:, :2]
    err = np.linalg.norm(est[:, :2] - gt_np, axis=1)
    err_eps = np.linalg.norm(ref_eps[..., :2] - gt_np, axis=-1)   # (31, S)
    ref_err = lx["mcl_err"]
    print(f"  MCL {int(lx['particles'])} particles, {len(est)} steps: "
          f"estimates within {dxy * 1e3:.3f} mm / {dth * 1e3:.3f} mrad of "
          f"JAX's (its own spread {spread[0] * 1e3:.3f} mm / "
          f"{spread[1] * 1e3:.3f} mrad); {n_dec} resampling decisions differ"
          f" (JAX's own runs: up to {n_dec_eps}); final error "
          f"{err[-1]:.4f} m (JAX {ref_err[-1]:.4f}, its perturbed runs "
          f"{', '.join(f'{e:.4f}' for e in err_eps[:, -1])}), "
          f"mean {err.mean():.4f} m (JAX {ref_err.mean():.4f})")
    check(dxy <= tol[0] and dth <= tol[1],
          "MCL estimates beyond the reference's own spread")
    check(n_dec <= n_dec_eps, "more resampling decisions differ than in "
                              "any of the reference's own runs")
    check(abs(err[-1] - ref_err[-1]) <= max(
        float(np.abs(err_eps[:, -1] - ref_err[-1]).max()), XY_TOL),
          "MCL final error beyond the reference's own spread")
    launches = dict(cuda_kernels.LAUNCHES)
    if dev.type == "cuda":
        check_map_launches(launches, updates, "the localization map")
    check(sum(launches.values()) == counted_launches(launches),
          f"localization launched kernel entries beside the map "
          f"updates: {launches}")
    out = {"mcl_dev": (dxy, dth), "jax_spread": spread,
           "resample_decisions_differing": n_dec,
           "final_error_m": float(err[-1]), "reloc": (best, n),
           "badness_m": bad}
    if dev.type != "cuda":
        return out
    runs = [track()[2] for _ in range(3)]
    steps = len(est)
    out["mcl_steps_per_s"] = steps / sorted(runs)[1]

    def ms(fn, reps=5):
        fn()
        ts = []
        for _ in range(reps):
            sync(dev)
            t0 = time.perf_counter()
            fn()
            sync(dev)
            ts.append(time.perf_counter() - t0)
        return sorted(ts)[reps // 2] * 1e3

    out["relocalize_ms"] = ms(lambda: place_rec.relocalize(
        db, fp_db, ranges[q], hit[q], u, min_num_matches=8))
    out["build_distance_map_ms"] = ms(lambda: monitor.build_distance_map(
        grid.occ, grid.origin, mp.resolution))
    out["adjust_pose_ms"] = ms(lambda: monitor.adjust_pose(
        dmap, T(pose), pts_q, mask_q))
    print(f"  MCL {out['mcl_steps_per_s']:.1f} steps/s (median of 3: "
          f"{', '.join(f'{r:.3f}' for r in runs)} s for {steps} steps); "
          f"relocalize {out['relocalize_ms']:.2f} ms (32 stored scans), "
          f"build_distance_map {out['build_distance_map_ms']:.2f} ms, "
          f"adjust_pose {out['adjust_pose_ms']:.2f} ms (343 candidates); "
          f"launches {launches}")
    return out


def _grid_np(g):
    return {k: getattr(g, k).cpu().numpy()
            for k in ("origin", "count", "psum", "outer", "occ")}


def _same_grid(a, b):
    return all(np.array_equal(_bits(a[k]), _bits(b[k])) for k in a)


def hmt_phase(dev):
    """Phase 11: HMTFuser on the out-and-back corridor of
    tests/test_hmt_driver.py at the canonical sensor (481 scans, margin
    10 m, 64-cell tiles, chunks of 16) against the JAX record
    (canonical_hmt.npz): the same recentres (each check lies 2 m from
    the margin); the trajectory within 1 cm / 5 mrad, the stored cells
    and the global_gaussians count equal, or within the reference's own
    spread where that is wider (the most its 31 runs with the odometry
    moved by +-k * 1e-6, k = 1..16, move from its run);
    `newton_solve` alone launched, once a scan; the port's directory
    saved after 240 scans loads
    back to the same window, which recentred away and back is recalled
    bit for bit; a fuser loaded from the directory JAX wrote resumes
    over 32 scans as JAX's did.  Prints scans/s and the recentre ms."""
    hx = dict(np.load(HMT_FIXTURE))
    fp = canonical_slam_params().fuser
    check(repr(fp) == str(hx["params_repr"]),
          "canonical_hmt.npz was made at other parameters")
    T = lambda x, dt=torch.float32: torch.as_tensor(  # noqa: E731
        x, dtype=dt, device=dev)
    pts, mask = dataset.scan_to_points(T(hx["ranges"]), T(hx["hit"],
                                                          torch.bool))
    odom, gt = T(hx["odom"]), T(hx["gt"])
    a, c, n_res = int(hx["save_at"]), int(hx["chunk"]), int(hx["resume"])
    kw = dict(recenter_margin=float(hx["margin"]),
              tile_cells=int(hx["tile_cells"]))
    with tempfile.TemporaryDirectory() as tmp:
        own, jdir = os.path.join(tmp, "port"), os.path.join(tmp, "jax")
        cuda_kernels.reset_launch_counts()
        sync(dev)
        with map_updates() as updates:
            t0 = time.perf_counter()
            hf = HMTFuser(fp, gt[0], torch.zeros(3, device=dev), pts[0],
                          mask[0], **kw)
            first = hf.run_sequence(odom[1:a + 1], pts[1:a + 1],
                                    mask[1:a + 1], chunk=c)
            sync(dev)
            t1 = time.perf_counter()
            hf.save(own)
            saved = _grid_np(hf.state.grid)
            t2 = time.perf_counter()
            rest = hf.run_sequence(odom[a + 1:], pts[a + 1:], mask[a + 1:],
                                   chunk=c)
            sync(dev)
            wall = (t1 - t0) + (time.perf_counter() - t2)
        launches = dict(cuda_kernels.LAUNCHES)
        traj = np.concatenate([first, rest])
        scans = traj.shape[0]
        n_obj = launches["newton_solve"]
        if dev.type == "cuda":
            check_map_launches(launches, updates, "the HMT run")
            check(n_obj == scans and sum(launches.values())
                  == n_obj + counted_launches(launches),
                  f"the HMT run launched {launches}: expected "
                  "newton_solve alone, once a scan, beside the map "
                  "updates")
        spread = max_dev(hx["traj_eps"], hx["traj"])
        tol = (max(spread[0], XY_TOL), max(spread[1], TH_TOL))
        dxy, dth = max_dev(traj, hx["traj"])
        hf.hmt.grid = hf.state.grid
        n_gauss = hf.hmt.global_gaussians()[0].shape[0]
        counts = {"stored cells": (hf.stored_cell_count(), "stored_cells"),
                  "gaussians": (n_gauss, "n_gauss")}
        rt = np.asarray(hf.recenter_times) * 1e3
        print(f"  {scans} scans in {wall:.3f} s ({scans / wall:.1f} scans/s,"
              f" {hf.n_recenters} recentres of {np.median(rt):.1f} ms "
              f"median, {rt.max():.1f} max); {n_obj} newton_solve "
              f"launches ({n_obj / scans:.2f} a scan); trajectory within "
              f"{dxy * 1e3:.3f} mm / {dth * 1e3:.3f} mrad of JAX's (its "
              f"own 31 runs with the odometry moved by +-k * 1e-6: "
              f"{spread[0] * 1e3:.3f} mm / {spread[1] * 1e3:.3f} mrad); "
              f"recentres {hf.n_recenters} (JAX {int(hx['n_recenters'])}, "
              f"its runs {hx['n_recenters_eps'].tolist()}), " + ", ".join(
                  f"{k} {v} (JAX {int(hx[r])}, its runs "
                  f"{hx[r + '_eps'].tolist()})"
                  for k, (v, r) in counts.items()))
        check(dxy <= tol[0] and dth <= tol[1],
              "HMT trajectory beyond 1 cm / 5 mrad and the reference's "
              "own spread")
        check(hf.n_recenters == int(hx["n_recenters"]),
              "the recentres differ from JAX's")
        for k, (v, r) in counts.items():
            own_spread = int(np.abs(hx[r + "_eps"] - hx[r]).max())
            check(abs(v - int(hx[r])) <= own_spread,
                  f"{k} beyond the reference's own spread")

        back = HMTFuser.load(own, fp, device=dev)
        check(_same_grid(_grid_np(back.state.grid), saved),
              "the saved window does not load back bit for bit")
        m = back.hmt
        stored = m.stored_cell_count()
        away = m.center() + np.asarray([0.0, 3.0 * fp.ndt.size_y])
        m.recenter(away)
        check(int(m.grid.count.sum()) == 0, "the window did not empty")
        m.recenter(away - np.asarray([0.0, 3.0 * fp.ndt.size_y]))
        exact = _same_grid(_grid_np(m.grid), saved)
        print(f"  saved after {a} scans and loaded: {stored} stored cells;"
              f" the window spilled whole and recalled: identical bits "
              f"{exact}")
        check(exact and m.stored_cell_count() == stored,
              "the recalled window is not the spilled one bit for bit")

        os.makedirs(jdir)
        for k, v in hx.items():
            if k.startswith("dir/"):
                with open(os.path.join(jdir, k[4:]), "wb") as f:
                    f.write(v.tobytes())
        with open(os.path.join(own, "hmt.json")) as f1, \
                open(os.path.join(jdir, "hmt.json")) as f2:
            same_tiles = (sorted(json.load(f1)["tiles"])
                          == sorted(json.load(f2)["tiles"]))
        hf2 = HMTFuser.load(jdir, fp, device=dev)
        check(torch.equal(hf2.state.Tlast_fuse, hf2.state.Tnow),
              "a loaded fuser does not restart Tlast_fuse at Tnow")
        sl = slice(a + 1, a + 1 + n_res)
        res = hf2.run_sequence(odom[sl], pts[sl], mask[sl], chunk=c)
        rxy, rth = max_dev(res, hx["resume_traj"])
        print(f"  loaded JAX's directory ({sum(k.startswith('dir/') for k in hx)}"
              f" files; the port's holds the same tiles: {same_tiles}) and "
              f"resumed {n_res} scans: within {rxy * 1e3:.3f} mm / "
              f"{rth * 1e3:.3f} mrad of JAX's resumed run")
        check(same_tiles, "the port's directory holds other tiles than JAX's")
        check(rxy <= XY_TOL and rth <= TH_TOL,
              "the run resumed from JAX's directory deviates from JAX's")
    return {"scans_per_s": scans / wall, "wall_s": wall,
            "recenter_ms": rt.tolist(), "n_recenters": hf.n_recenters,
            "stored_cells": hf.stored_cell_count(), "n_gauss": n_gauss,
            "dev": (dxy, dth),
            "jax_spread": spread, "resume_dev": (rxy, rth),
            "launches": launches}


def _cli_json(argv):
    """Run the port's CLI in this process; its last JSON line."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return json.loads([ln for ln in buf.getvalue().splitlines()
                       if ln.startswith("{")][-1])


def cli_localize_fuse_case(dev):
    """Phase 11b: the CLI's `localize` (tracking, --kidnapped) and `fuse`
    (plain, --hmt-dir, --resume) in this process on the canonical
    sequence, at the canonical map and scan widths; their draws are the
    card's own generators'.  Checks the outputs' sizes and finiteness,
    MCL's mean error under the reference test's 0.3 m, the kidnapped
    scan relocalized within 0.5 m, `newton_solve` launched by fuse."""
    flags = ["--map-size", "100", "--sensor-range", "30", "--num-beams",
             "720", "--max-cells", "1024"]
    pre = [] if dev.type == "cuda" else ["--device", "cpu"]
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        hmt = os.path.join(tmp, "hmt")
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        for name, argv in (
                ("localize", ["localize"]),
                ("kidnapped", ["localize", "--kidnapped"]),
                ("fuse", ["fuse", "--out", f"{tmp}/fuse"]),
                ("fuse_hmt", ["fuse", "--out", f"{tmp}/hmt_out",
                              "--hmt-dir", hmt]),
                ("fuse_resume", ["fuse", "--out", f"{tmp}/resume",
                                 "--hmt-dir", hmt, "--resume"])):
            runs[name] = _cli_json(pre + argv + ["--dataset", FIXTURE]
                                   + flags)
        wall = time.perf_counter() - t0
    n = cuda_kernels.LAUNCHES["newton_solve"]
    print(f"  {wall:.1f} s for the five commands; newton_solve "
          f"launches {n}")
    for name, r in runs.items():
        print(f"  {name}: {json.dumps(r)[:240]}")
    loc, kid = runs["localize"], runs["kidnapped"]
    check(loc["steps"] == 99 and np.isfinite(loc["mean_error_m"])
          and loc["mean_error_m"] < 0.3, "cli localize did not track")
    check(kid["relocalized"] and kid["position_error_m"] < 0.5,
          "cli localize --kidnapped did not relocalize")
    check(all(runs[k]["n_scans"] == 199 and np.isfinite(
        runs[k]["ate_rmse_m"]) for k in ("fuse", "fuse_hmt", "fuse_resume")),
        "cli fuse's outputs are not finite or of the wrong size")
    if dev.type == "cuda":
        check(n > 0, "cli fuse launched no newton_solve")
    return {"wall_s": wall, **runs, "newton_solve_launches": n}

def simulator_phase(sp, fx, io_fx, dev):
    """Phases 12a and 12b: the simulator on the card against the JAX
    package.  12a: bench.make_sequence()'s 200-scan corridor with the
    reference's recorded draws equals canonical_200.npz (ground truth
    exactly, odometry within ODOM_TOL, ranges and hits but for grazing and
    oblique beams), and the main path on the simulated sequence stays
    within 1 cm / 5 mrad of the JAX trajectory, launching only
    `newton_solve`.  12b: bench_offline_570's 7,040-scan multi-loop
    at 720 beams with a seeded generator: the noise-free raycast at the
    64 recorded poses against the reference's, the simulator's scans/s
    (median of 3, each ending in a synchronisation) and its peak
    memory."""
    t_steps = fx["gt"].shape[0]
    traj = dataset.corridor_trajectory(t_steps, x0=-2.5, x1=2.5, y=-4.5,
                                       device=dev)
    check(np.array_equal(traj.cpu().numpy(), fx["gt"]),
          "the corridor trajectory is not canonical_200.npz's")
    T = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    sim = dataset.simulate_sequence(traj, 720, 30.0,
                                    range_draws=T(io_fx["range_u"]),
                                    odom_draws=T(io_fx["odom_u"]), device=dev)
    check(np.array_equal(sim.gt.cpu().numpy(), fx["gt"]),
          "simulated ground truth differs from the reference's")
    odom_dev = float(np.abs(sim.odom.cpu().numpy() - fx["odom"]).max())
    print(f"  odometry within {odom_dev:.2e} of the reference's")
    check(odom_dev <= ODOM_TOL, "simulated odometry differs beyond 1e-6")
    kind = grazing_beams(dataset.default_world("cpu"), fx["gt"], 720, 30.0)
    beams = check_beams("canonical corridor, 200 x 720", sim.ranges, sim.hit,
                        fx["ranges"], fx["hit"], kind)
    sim_fx = dict(fx, ranges=sim.ranges, hit=sim.hit, odom=sim.odom)
    cuda_kernels.reset_launch_counts()
    with map_updates() as updates:
        slam, sec = run_main_path(sp, sim_fx, dev)
    launches = dict(cuda_kernels.LAUNCHES)
    traj_out = np.stack(slam.trajectory)
    xy, th = max_dev(traj_out, fx["traj"])
    print(f"  main path on the simulated sequence: {len(slam.nodes)} nodes "
          f"(JAX {fx['node_T'].shape[0]}), {xy * 100:.4f} cm / "
          f"{th * 1e3:.4f} mrad from the JAX trajectory, "
          f"{(t_steps - 1) / sec:.2f} scans/s, launches {launches}")
    check(traj_out.shape == fx["traj"].shape and xy <= XY_TOL
          and th <= TH_TOL, "the main path on the simulated sequence "
          "deviates from JAX's beyond 1 cm / 5 mrad")
    if dev.type == "cuda":
        check_map_launches(launches, updates,
                           "the main path on the simulated sequence")
    check(dev.type != "cuda" or launches["newton_solve"] > 0 and all(
        v == 0 for k, v in launches.items()
        if k not in ("newton_solve", *MAP_ENTRIES, *FEATURE_ENTRIES)),
        "the main path on the simulated sequence launched another entry")

    print("phase 12b: the simulator at bench_offline_570's scale")
    ml = dataset.multi_loop_trajectory(ML570["n_loops"],
                                       ML570["steps_per_loop"],
                                       radius=ML570["radius"], device=dev)
    world = dataset.default_world(dev)
    idx = io_fx["ray_idx"]
    rr, rh = dataset.raycast(world, ml[T(idx).long()], 720, 30.0)
    kind = grazing_beams(world, ml[T(idx).long()], 720, 30.0)
    beams_570 = check_beams(f"noise-free raycast at {len(idx)} of "
                            f"{ml.shape[0]} poses", rr, rh,
                            io_fx["ray_ranges"], io_fx["ray_hit"], kind)
    gen = torch.Generator(dev)
    times = []
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    base_mem = torch.cuda.memory_allocated(dev) if on_card else 0
    for _ in range(4):                      # a warm-up, then 3 timed
        gen.manual_seed(0)
        sync(dev)
        t0 = time.perf_counter()
        big = dataset.simulate_sequence(ml, 720, 30.0, generator=gen,
                                        device=dev)
        sync(dev)
        times.append(time.perf_counter() - t0)
    peak = (torch.cuda.max_memory_allocated(dev) if on_card else 0) - base_mem
    check(tuple(big.ranges.shape) == (ml.shape[0], 720)
          and bool(torch.isfinite(big.ranges).all())
          and bool(torch.isfinite(big.odom).all()),
          "the 7,040-scan simulation is not finite or of the wrong shape")
    med = sorted(times[1:])[1]
    print(f"  simulate_sequence, {ml.shape[0]} scans x 720 beams: "
          f"{ml.shape[0] / med:.0f} scans/s (median of 3: "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times[1:])} ms), peak "
          f"memory {peak / 2**20:.1f} MiB above the {base_mem / 2**20:.1f} "
          f"MiB held before")
    return {"canonical_beams": beams, "odom_dev": odom_dev,
            "main_path_dev_xy_m": xy, "main_path_dev_theta_rad": th,
            "main_path_launches": launches, "raycast_570_beams": beams_570,
            "sim_570_scans_per_s": ml.shape[0] / med, "sim_570_s": times[1:],
            "sim_570_peak_mib": peak / 2**20}


def inputs_phase(fx, dev):
    """Phase 12c: the inputs end to end in this process.  `cli simulate`
    then `cli slam` on what it wrote; the canonical sequence written as a
    CARMEN log and a bag by the port's writers, and `cli slam` on each
    and on the npz, at the canonical widths: the same node counts, and
    trajectories within 1 cm / 5 mrad of the npz run (CARMEN rounds
    ranges to 0.1 mm and the odometry chain to 1e-6)."""
    flags = ["--map-size", "100", "--sensor-range", "30", "--num-beams",
             "720", "--max-cells", "1024", "--new-node-dist", "2.0"]
    pre = [] if dev.type == "cuda" else ["--device", "cpu"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        seq = sequence(fx, dev)
        carmen.write_carmen(f"{tmp}/c.clf", seq, max_range=30.0)
        rosbag.write_bag(f"{tmp}/c.bag", seq, max_range=30.0)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(pre + ["simulate", "--out", f"{tmp}/sim.npz", "--steps",
                            "100", "--num-beams", "720", "--sensor-range",
                            "30"])
        out["simulate_s"] = time.perf_counter() - t0
        runs = {}
        for name, f in (("npz", FIXTURE), ("clf", f"{tmp}/c.clf"),
                        ("bag", f"{tmp}/c.bag"), ("sim", f"{tmp}/sim.npz")):
            cuda_kernels.reset_launch_counts()
            t0 = time.perf_counter()
            stats = _cli_json(pre + ["slam", "--dataset", f, "--out",
                                     f"{tmp}/{name}", *flags])
            wall = time.perf_counter() - t0
            _, est = tum.read_tum(f"{tmp}/{name}/est.tum")
            runs[name] = est
            launches = cuda_kernels.LAUNCHES["newton_solve"]
            out[name] = {**stats, "wall_s": wall, "launches": launches}
            print(f"  cli slam on {name}: {stats['n_updates']} updates, "
                  f"{stats['n_nodes']} nodes, ATE {stats['ate_rmse_m']:.4f} m, "
                  f"{wall:.1f} s, {launches} newton_solve launches")
            check(np.isfinite(est).all()
                  and (dev.type != "cuda" or launches > 0),
                  f"cli slam on {name}: not finite or no kernel launched")
        check(out["sim"]["n_updates"] == 99 and out["sim"]["ate_rmse_m"] < 0.5,
              "cli slam did not track the sequence cli simulate wrote")
        for name in ("clf", "bag"):
            xy, th = max_dev(runs[name], runs["npz"])
            out[name]["dev_xy_m"], out[name]["dev_theta_rad"] = xy, th
            print(f"  {name} run vs the npz run: {xy * 100:.4f} cm / "
                  f"{th * 1e3:.4f} mrad")
            check(out[name]["n_nodes"] == out["npz"]["n_nodes"]
                  and runs[name].shape == runs["npz"].shape
                  and xy <= XY_TOL and th <= TH_TOL,
                  f"cli slam on the {name} file deviates from the npz run")
    return out


def p2d_phase(sp, fx, io_fx, dev):
    """Phase 13a: P2D registration (BASELINE.md configs[0]) at the
    canonical parameters.  Target: build_from_scan of scan 0 in its own
    frame (200 x 200 cells); source: scan 20's 720 points; start: the
    composed odometry of scans 1-20.  match_p2d within P2D_TOL of the
    reference's pose, both converged, `fgh_dense_flat` launched once per
    trial and no other entry; then the entry at N = 720 x K = 25 against
    its plain twin on the card (two calls identical bits; an all-masked
    source exactly zero), timed in turns beside its bound.  Returns
    (record, the entry's checks at this shape)."""
    p = sp.fuser
    m = p.matcher
    T = lambda x, dt=torch.float32: torch.as_tensor(x, dtype=dt, device=dev)
    tgt, pts1, m1, T_init = p2d_inputs(sp, fx, io_fx, dev)
    pairwise.match_p2d(tgt, pts1, m1, T_init, p.ndt, m)     # warm-up
    times = []
    for k in range(3):
        if k == 0:
            cuda_kernels.reset_launch_counts()
        sync(dev)
        t0 = time.perf_counter()
        res = pairwise.match_p2d(tgt, pts1, m1, T_init, p.ndt, m)
        sync(dev)
        times.append(time.perf_counter() - t0)
        if k == 0:
            launches = dict(cuda_kernels.LAUNCHES)
    ms = sorted(times)[1] * 1e3
    trials = int(res.iterations)
    xy, th = max_dev(res.T.cpu().numpy()[None], io_fx["p2d_T"][None])
    print(f"  grid {tuple(tgt.valid.shape)}, {int(m1.sum())} of 720 points; "
          f"{trials} trials (JAX {int(io_fx['p2d_trials'])}), converged "
          f"{bool(res.converged)} (JAX {bool(io_fx['p2d_converged'])}), "
          f"score {float(res.score):.3f} (JAX {float(io_fx['p2d_score']):.3f})"
          f", {xy * 1e3:.4f} mm / {th * 1e3:.4f} mrad from JAX's pose; "
          f"{ms:.1f} ms (median of 3 after a warm-up: "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times)}); launches in the "
          f"first {launches}")
    eps_tr, eps_T = io_fx["p2d_eps_trials"], io_fx["p2d_eps_T"]
    moved = eps_tr > 1
    print(f"  the reference from starts moved by k * 1e-6: trials "
          f"{eps_tr.tolist()}; {int((~moved).sum())} of {len(eps_tr)} stop "
          f"at the start (an indefinite projected Hessian, which the "
          f"port's guarded projection avoids), the others within "
          f"{max_dev(eps_T[moved], io_fx['p2d_T'][None])[0] * 1e3:.4f} mm "
          f"of the record")
    check(bool(res.converged) and bool(io_fx["p2d_converged"]),
          "match_p2d did not converge")
    check(xy <= P2D_TOL and th <= P2D_TOL,
          "match_p2d deviates from JAX's pose beyond 1 mm / 1 mrad")
    # The whole registration, the guarded projection included, in one
    # launch.
    check(dev.type != "cuda" or launches["newton_solve"] == 1 and all(
        v == 0 for k, v in launches.items() if k != "newton_solve"),
        f"match_p2d launched {launches}, not one newton_solve")

    src = pairwise.points_as_cells(pts1, m1)
    hh, ww = tgt.valid.shape
    d = T([0.004, -0.003, 0.001])

    def kernel(src_=src):
        return cuda_kernels.fgh_dense_flat(
            d, T_init, src_, tgt.packed, tgt.origin, hh, ww,
            p.ndt.resolution, m.n_neighbours, m.lfd1, m.lfd2)

    def plain(src_=src):
        return d2d_analytic.fgh_dense_flat(
            d, T_init, src_, tgt.packed, tgt.origin, 0, hh, ww,
            p.ndt.resolution, m)

    err = compare(f"fgh_dense_flat N={src.mask.numel()} K=25 (P2D)",
                  kernel(), plain())
    a, b = kernel(), kernel()
    check(all(torch.equal(x, y) for x, y in zip(a, b)),
          "fgh_dense_flat at N=720 is not deterministic")
    masked = dataclasses.replace(src, mask=torch.zeros_like(src.mask))
    got = kernel(masked)
    check(all(float(x.abs().max()) == 0.0 for x in got),
          "all-masked fgh_dense_flat at N=720 is not exactly zero")
    compare("fgh_dense_flat N=720 all masked", got, plain(masked))
    win_bytes, win_pairs = window_work(d, T_init, src, tgt.packed,
                                       tgt.origin, None, hh, ww,
                                       p.ndt.resolution, m.n_neighbours)
    entry = {"max_abs_err": err, "launches": launches["fgh_dense_flat"],
             "launches_newton_solve": launches["newton_solve"],
             "cells": int(src.mask.numel()), "window_pairs": win_pairs,
             **bound(win_bytes + 4 * 8 + 4 * 13, win_pairs)}
    if dev.type == "cuda":          # a CPU rehearsal takes no times
        entry.update(time_turns(kernel, plain))
        print(f"  N=720: {entry['ms'] * 1e3:.2f} us against plain "
              f"{entry['plain_ms'] * 1e3:.2f} us, bound "
              f"{entry['bound_ms'] * 1e3:.4f} us ({entry['bound_by']}; "
              f"{win_pairs} valid pairs)")
    record = {"trials": trials, "converged": bool(res.converged),
              "dev_m": xy, "dev_rad": th, "ms": ms, "times_s": times,
              "launches": launches,
              "score": float(res.score), "jax_eps_trials":
              io_fx["p2d_eps_trials"].tolist()}
    return record, entry


def calibration_phase(fx, io_fx, dev):
    """Phase 13b: `cli calibrate` at its defaults (3 pairs, a 7^3 grid of
    343 candidates over +-0.4 m, +-0.25 rad) on the canonical sequence at
    720 beams.  The 343 summed scores within CALIB_RTOL of the JAX record
    and the best offset the reference's up to its ties: on this straight
    corridor the base motion is a translation, which leaves the
    extrinsic's x and y unobservable, so 49 candidates tie within 1e-7
    and the reference's own best moves among them under a 1e-6 change of
    the motions (the record's calib_eps_idx).  So the port's best must
    be among the candidates the JAX scores cannot tell from their best
    at CALIB_RTOL, and the JAX best among the port's; the ms of one
    calibration (median of 3)."""
    seq = sequence(fx, dev)
    pairs, rels = [], []
    for a, b in cli.calibration_pairs(seq.gt.shape[0], 3):
        pairs.append((dataset.scan_to_points(seq.ranges[a], seq.hit[a]),
                      dataset.scan_to_points(seq.ranges[b], seq.hit[b])))
        rels.append(se2.sub(seq.gt[a], seq.gt[b]))
    times = []
    for _ in range(4):
        sync(dev)
        t0 = time.perf_counter()
        best, scores = pairwise.calibrate_extrinsic(pairs, rels, 0.4, 0.25, 7)
        sync(dev)
        times.append(time.perf_counter() - t0)
    ms = sorted(times[1:])[1] * 1e3
    got = scores.cpu().numpy()
    ref = io_fx["calib_scores"]
    rel_err = float(np.max(np.abs(got - ref) / np.abs(ref)))
    ties_ref = np.flatnonzero(ref <= ref.min() * (1 + CALIB_RTOL))
    ties_got = np.flatnonzero(got <= got.min() * (1 + CALIB_RTOL))
    best_idx, ref_idx = int(np.argmin(got)), int(np.argmin(ref))
    pre = [] if dev.type == "cuda" else ["--device", "cpu"]
    cli_out = _cli_json(pre + ["calibrate", "--dataset", FIXTURE,
                               "--num-beams", "720"])
    print(f"  343 scores within {rel_err:.2e} of JAX's (rtol {CALIB_RTOL}); "
          f"best candidate {best_idx} {best.cpu().numpy()} (JAX {ref_idx} "
          f"{io_fx['calib_best']}); {len(ties_ref)} candidates tie with "
          f"JAX's best at that tolerance, {len(ties_got)} with the port's; "
          f"JAX's own best under 1e-6 changes: "
          f"{io_fx['calib_eps_idx'].tolist()}; cli calibrate "
          f"{cli_out['extrinsic']}; one calibration {ms:.1f} ms (median of 3)")
    check(rel_err <= CALIB_RTOL, "calibration scores differ from JAX's "
          "beyond rtol 1e-5")
    check(best_idx in ties_ref and ref_idx in ties_got,
          "the best offset is not JAX's, up to the candidates its scores "
          "cannot tell apart")
    check(np.allclose(cli_out["extrinsic"], best.cpu().numpy(), atol=0)
          and cli_out["candidates"] == 343,
          "cli calibrate does not report the calibration's best offset")
    return {"ms": ms, "times_s": times[1:], "score_rel_err": rel_err,
            "best_idx": best_idx, "jax_best_idx": ref_idx,
            "ties_jax": len(ties_ref), "ties_port": len(ties_got),
            "cli": cli_out}


def fleet_phases(dev):
    """Phases 3d, 7, 7b, 7c.  Returns (record, the checks of the
    objective's batch entry and of the solve's, the objective's launches
    on phase 3d's per-trial lockstep path, and every entry's launches in
    the checked B = 8 fleet run)."""
    fl = dict(np.load(FLEET_FIXTURE))
    fp = presets.fleet_serving()
    check(repr(fp) == str(fl["params_repr"]),
          "canonical_fleet.npz was made at other parameters than "
          "presets.fleet_serving")
    seq = sequence(fl, dev)
    print("phase 3d: newton_objective_batch vs plain on the card")
    small = fleet_kernel_checks(fp, seq, FLEET_SIZES[0], dev)
    checks = fleet_kernel_checks(fp, seq, FLEET_SIZES[-1], dev)
    checks["max_abs_err"] = max(checks["max_abs_err"], small["max_abs_err"])
    checks["b8"] = {k: v for k, v in small.items() if k != "max_abs_err"}
    print("phase 3d: newton_solve_batch vs plain and vs the per-trial path "
          "on the card")
    small, per8 = fleet_solve_checks(fp, seq, FLEET_SIZES[0], dev)
    solve, per64 = fleet_solve_checks(fp, seq, FLEET_SIZES[-1], dev)
    solve["max_abs_err"] = max(solve["max_abs_err"], small["max_abs_err"])
    solve["b8"] = {k: v for k, v in small.items() if k != "max_abs_err"}
    print("phase 7: points-only fleet (run_sequence_batch)")
    points, launches, mid_run = fleet_points_phase(fp, fl, dev)
    print("phase 7b: full-pipeline fleet (run_sequence_features_batch)")
    full, full_launches = fleet_full_phase(fp, fl, dev)
    print("phase 7c: serve_fleet_interleaved and serve_fleet_grouped, "
          f"{FLEET_SERVE['streams']} streams")
    serve = fleet_serve_phase(fp, fl, *mid_run, dev)
    record = {"points": points, "full": full, "serve": serve,
              "launches": {"points_b8": launches, "full_b8": full_launches}}
    return record, checks, solve, per8 + per64, launches


def pose6_dev(a, b):
    """Distance of two SE(3) poses (6,): translation (m), rotation angle
    of a^-1 b's rotation (rad)."""
    R = se3.rotmat(torch.as_tensor(a[3:])).T @ se3.rotmat(
        torch.as_tensor(b[3:]))
    cos_t = float(np.clip((float(torch.trace(R)) - 1) / 2, -1, 1))
    return float(np.linalg.norm(np.asarray(a[:3]) - b[:3])), float(
        np.arccos(cos_t))


def sixdof_phase(lc, dev):
    """Phase 14a: se3 on the card against the CPU, then match_d2d_3d of
    three accepted links of the LC record's offline graph at their full
    padded cell lists (1,024 x 1,024 pairs), unclamped and clamped
    (force2d), against the JAX record (made on the same cells without
    the padding, which adds exactly zero) within 1 cm / 5 mrad or the
    reference's own spread where wider; the clamp against the port's
    SE(2) D2D matcher on the same pair from the same start (its
    grid-window association against the cutoff's all pairs: 2 cm / 20
    mrad).  No kernel entry
    launches.  Returns the summary."""
    sx = dict(np.load(SIXDOF_FIXTURE))
    sp = canonical_slam_params(OFFLINE_SPLIT_M, 64)
    check(str(sx["params_repr"]) == repr(sp),
          "canonical_6dof.npz was made at other parameters")
    links = sixdof_links(lc)
    check(np.array_equal(links, sx["links"]),
          "phase 14a picks other links than the record")
    rng = np.random.default_rng(0)
    poses = np.concatenate([rng.normal(0, 3, (64, 3)),
                            rng.normal(0, 1, (64, 3))], 1).astype(np.float32)
    poses[0, 3:] = 0.0
    poses[1, 3:] = [0.0, 0.0, np.pi - 5e-4]
    errs = {"rotmat": 0.0, "compose": 0.0, "round_trip": 0.0}
    for a, b in zip(poses, poses[::-1]):
        ga, gb = (torch.as_tensor(x, device=dev) for x in (a, b))
        ca, cb = torch.as_tensor(a), torch.as_tensor(b)
        errs["rotmat"] = max(errs["rotmat"], float(
            (se3.rotmat(ga[3:]).cpu() - se3.rotmat(ca[3:])).abs().max()))
        errs["compose"] = max(errs["compose"], float(
            (se3.compose(ga, gb).cpu() - se3.compose(ca, cb)).abs().max()))
        back = se3.compose(se3.inverse(ga), se3.compose(ga, gb))
        errs["round_trip"] = max(errs["round_trip"], pose6_dev(
            back.cpu().numpy(), b)[0])
    print(f"  se3 on the card vs the CPU over 64 poses: rotmat "
          f"{errs['rotmat']:.2e}, compose {errs['compose']:.2e}; "
          f"inverse(a) . (a . b) returns b within {errs['round_trip']:.2e} m")
    check(errs["rotmat"] <= 1e-5 and errs["compose"] <= 1e-4
          and errs["round_trip"] <= 1e-3, "se3 on the card departs from "
          "the CPU")

    m, ndt = sp.fuser.matcher, sp.fuser.ndt

    def cells(k):
        c = lift_cells(lc["off_bank.cells.means"][k],
                       lc["off_bank.cells.covs"][k],
                       lc["off_bank.cells.mask"][k])
        return d2d3d.CellList3D(**{f: torch.as_tensor(v, device=dev)
                                   for f, v in c.items()})

    def se2_match(li):
        """The port's SE(2) D2D matcher (match_d2d's window term and
        Newton, one `newton_solve` launch) on the pair from the same
        start, with the guarded PSD projection: unguarded it stops at
        its start on link 94, the reference fault of ROADMAP queue 3.
        Its kernel launch (this is a comparison) is not counted."""
        r, mv = int(lc["off_link_ref"][li]), int(lc["off_link_mov"][li])
        t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
        tgt = d2d.PackedTarget(origin=t(lc["off_bank.target.origin"][r]),
                               packed=t(lc["off_bank.target.packed"][r]))
        src = CellList(*(t(lc[f"off_bank.cells.{f}"][mv])
                         for f in ("means", "covs", "mask")))
        T0 = t(lc["off_ransac_T"][li])
        return d2d.match_window(tgt.packed, tgt.origin, ndt.grid_h,
                                ndt.grid_w, ndt.resolution, src, T0, m,
                                psd_guard=True).T.cpu().numpy()

    summary = {"links": links.tolist(), "runs": []}
    # Warm-up: one derivative evaluation at the full shapes.
    d2d3d.d2d_fgh_3d(torch.zeros(6, device=dev),
                     torch.as_tensor(sx["T_init"][0], device=dev),
                     cells(lc["off_link_mov"][links[0]]),
                     cells(lc["off_link_ref"][links[0]]), m)
    launched = 0
    for k, li in enumerate(links):
        ref_i, mov_i = int(lc["off_link_ref"][li]), int(lc["off_link_mov"][li])
        tgt, src = cells(ref_i), cells(mov_i)
        T0 = torch.as_tensor(sx["T_init"][k], device=dev)
        for mode, force2d in (("6dof", False), ("2d", True)):
            torch.cuda.reset_peak_memory_stats(dev)
            cuda_kernels.reset_launch_counts()
            sync(dev)
            t0 = time.perf_counter()
            res = d2d3d.match_d2d_3d(tgt, src, T0, m, force2d=force2d)
            T = res.T.cpu().numpy()
            ms = (time.perf_counter() - t0) * 1e3
            launched += sum(cuda_kernels.LAUNCHES.values())
            peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
            xy, th = pose6_dev(T, sx[f"{mode}_T"][k])
            sxy, sth = (max(v) for v in zip(*(
                pose6_dev(e, sx[f"{mode}_T"][k])
                for e in sx[f"{mode}_eps_T"][k])))
            cov_ref = sx[f"{mode}_cov"][k]
            cov_dev = float(np.abs(res.cov.cpu().numpy() - cov_ref).max()
                            / np.abs(cov_ref).max())
            run = {"link": int(li), "mode": mode, "ms": ms,
                   "trials": int(res.iterations),
                   "trials_jax": int(sx[f"{mode}_trials"][k]),
                   "converged": bool(res.converged), "peak_mib": peak,
                   "dev_xy_m": xy, "dev_rot_rad": th, "jax_spread": [sxy, sth],
                   "cov_rel_dev": cov_dev}
            print(f"  link {li} ({ref_i} <- {mov_i}) {mode}: {ms:.1f} ms, "
                  f"{run['trials']} trials (JAX {run['trials_jax']}), peak "
                  f"{peak:.1f} MiB; {xy * 1e3:.4f} mm / {th * 1e3:.4f} mrad "
                  f"from JAX (its own spread {sxy * 1e3:.4f} mm / "
                  f"{sth * 1e3:.4f} mrad); covariance within {cov_dev:.2e} "
                  "of its largest entry")
            check(np.isfinite(T).all() and bool(res.converged)
                  and xy <= max(XY_TOL, sxy) and th <= max(TH_TOL, sth),
                  f"6-DoF link {li} {mode}: pose departs from JAX")
            check(cov_dev <= 2e-2, f"6-DoF link {li} {mode}: covariance "
                                   "departs from JAX")
            if force2d:
                check(bool((res.T[2:5] == 0).all()),
                      "force2d left z / roll / pitch non-zero")
                sxy2, sth2 = max_dev(se3.to_se2(res.T).cpu().numpy(),
                                     se2_match(li))
                run["se2_dev"] = [sxy2, sth2]
                print(f"    the clamp vs the SE(2) matcher: "
                      f"{sxy2 * 1e3:.3f} mm / {sth2 * 1e3:.3f} mrad")
                check(sxy2 <= 0.02 and sth2 <= 0.02,
                      f"link {li}: force2d departs from the SE(2) matcher")
            summary["runs"].append(run)
    print(f"  kernel launches of the 6-DoF registrations: {launched}")
    check(launched == 0, "the 6-DoF path launched a kernel entry")
    summary["se3_card_vs_cpu"] = errs
    return summary


def viewer_phase(fx, lc, dev):
    """Phase 14b: `cli slam --plot --html` on the canonical sequence (the
    main path's graph), the viewer's payload of the reference's LC graph
    in the port against the JAX record (whole and subsampled), the
    desc_string, a GraphLogger over the first LOGGER_SCANS scans with the
    JAX draws (a line a scan, its poses the port's trajectory and within
    1 cm / 5 mrad of the JAX trajectory) and a device_trace around one
    update; StageTimers time the stages.  Returns the summary."""
    sx = dict(np.load(SIXDOF_FIXTURE))
    timers = StageTimers()
    flags = ["--map-size", "100", "--sensor-range", "30", "--num-beams",
             "720", "--max-cells", "1024"]
    with tempfile.TemporaryDirectory() as tmp:
        seqf = os.path.join(tmp, "seq.npz")
        np.savez_compressed(seqf, **{k: fx[k] for k in
                                     ("ranges", "hit", "odom", "gt")})
        d = os.path.join(tmp, "out")
        with timers.stage("cli slam --plot --html"):
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(["slam", "--dataset", seqf, "--out", d, "--plot",
                          "--html", *flags])
        png = os.path.getsize(f"{d}/overview.png")
        with open(f"{d}/viewer.html") as f:
            text = f.read()
        with open(f"{d}/overview.png", "rb") as f:
            magic = f.read(4)
        payload = json.loads(text.split("const D = ", 1)[1].split(";\n", 1)[0])
        _, est = tum.read_tum(f"{d}/est.tum")
        check(magic == b"\x89PNG" and png > 1000, "overview.png is no PNG")
        check(len(payload["traj"]) == len(est)
              and len(payload["nodes"]) > 1 and "https://" not in text,
              "viewer.html does not describe the run")
        print(f"  cli slam --plot --html: overview.png {png} bytes, "
              f"viewer.html {len(text)} bytes ({len(payload['nodes'])} "
              f"nodes, {len(payload['traj'])} poses)")

        sp = canonical_slam_params(OFFLINE_SPLIT_M, 64)
        edges = zip(lc["off_edge_ij"][:, 0], lc["off_edge_ij"][:, 1],
                    lc["off_edge_rel"], lc["off_edge_cov"])
        slam = interop.graph_from_jax(sp, interop.tree_from_flat(
            lc, "off_bank"), lc["off_node_T_before"], edges, device=dev)
        slam.trajectory = [t.copy() for t in lc["off_node_T_before"]]
        dump = lambda p: json.dumps(p, separators=(",", ":"))  # noqa: E731
        with timers.stage("payload"):
            whole = dump(viz_html._graph_payload(slam))
        sub = dump(viz_html._graph_payload(
            slam, max_cells_per_node=PAYLOAD_MAX_CELLS))
        same = (whole == str(sx["payload"]), sub == str(sx["payload_sub"]))
        desc = desc_string(sp) == str(sx["desc_string"])
        print(f"  the viewer's payload of the reference's LC graph: "
              f"{len(whole)} characters, equal to the JAX record: "
              f"{same[0]}; with {PAYLOAD_MAX_CELLS} cells a node: {same[1]}; "
              f"desc_string equal: {desc}")
        check(all(same) and desc, "the payload or desc_string differs from "
                                  "the JAX record")

        n = LOGGER_SCANS
        seq = sequence(fx, dev)
        log_path = os.path.join(tmp, "poses.log")
        lg = GraphLogger(canonical_slam_params(float(fx["split_m"]),
                                               int(fx["max_nodes"])),
                         log_path)
        u = torch.as_tensor(fx["ransac_u"], device=dev)
        with timers.stage("GraphLogger", block_on=lg.trajectory):
            lg.initialize(seq.gt[0], torch.zeros(3, device=dev),
                          seq.ranges[0], seq.hit[0])
            for t in range(1, n - 1):
                lg.update(seq.odom[t], seq.ranges[t], seq.hit[t], t=float(t),
                          u=u[t - 1])
        trace_dir = os.path.join(tmp, "trace")
        with device_trace(trace_dir):
            lg.update(seq.odom[n - 1], seq.ranges[n - 1], seq.hit[n - 1],
                      t=float(n - 1), u=u[n - 2])
        lg.close()
        rows = np.loadtxt(log_path)
        traj = np.stack(lg.trajectory)
        trace = os.path.getsize(os.path.join(trace_dir, "trace.json"))
    log_dev = float(np.abs(rows[:, :3] - traj).max())
    xy, th = max_dev(traj, fx["traj"][:n])
    print(f"  GraphLogger over {n} scans: {rows.shape[0]} lines, poses "
          f"within {log_dev:.1e} of its trajectory, {xy * 1e3:.4f} mm / "
          f"{th * 1e3:.4f} mrad from JAX's; device_trace wrote {trace} "
          "bytes")
    check(rows.shape == (n, 4) and log_dev <= 1e-6 and xy <= XY_TOL
          and th <= TH_TOL and np.array_equal(rows[:, 3], np.arange(n)),
          "the GraphLogger's log departs from its run or from JAX")
    check(trace > 0, "device_trace wrote no trace")
    print("  " + timers.report().replace("\n", "\n  "))
    return {"png_bytes": png, "html_bytes": len(text),
            "payload_equal": list(same), "desc_string_equal": desc,
            "logger_dev_xy_m": xy, "logger_dev_theta_rad": th,
            "trace_bytes": trace,
            "stage_ms": {k: timers.mean_ms(k) for k in timers.totals}}


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def timed(fn, reps=3):
    """fn's result and the wall seconds of `reps` more calls (each ending
    in a synchronisation), after the first."""
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, times


def median(times):
    return sorted(times)[len(times) // 2]


def multidevice_phase(fx, lc, dev):
    """Phase 15: the multi-device programs in an NCCL world of one rank
    (one card: NCCL refuses two ranks on one GPU), each against the
    port's single-device program on the same inputs.  A sharded solver
    is the single-device solver's own body with an all-reduce as its
    reduction, so in a world of one rank it is held to it bit for bit:
    the dense and Schur solves of the 570-node graph and the direct
    solve at 570, 4,000 and 10,000 nodes (its chi2 also within the
    reference's range at the last two), the sharded link proposals
    of phase 9e's bank equal to compute_links_batch on the same draws,
    run_sequence_batch_sharded of 8 fleet streams equal to
    run_sequence_batch, and measure_fleet_throughput(n_devices=1,
    streams_per_device=64) through the sharded path (its
    newton_objective_batch launches are counted); then the multi-host
    worker in an NCCL world of its own.  Returns (summary, the fleet's
    launches)."""
    mesh_mod.init_distributed(f"localhost:{_free_port()}", 1, 0, device=dev)
    try:
        return _multidevice(fx, lc, dev)
    finally:
        torch.distributed.destroy_process_group()


def _multidevice(fx, lc, dev):
    sv = dict(np.load(SOLVER_FIXTURE))
    mesh = mesh_mod.make_mesh(1)
    check(torch.distributed.get_backend() == "nccl", "the world is not NCCL")
    summary = {}

    def held(name, out, ref, chi=None, ref_chi=None):
        dev_ = float(np.abs(out - ref).max())
        line = f"  {name}: sharded vs single {dev_:.2e}"
        if chi is not None:
            line += f"; chi2 {chi:.5f} vs {ref_chi:.5f}"
        print(line)
        check(np.isfinite(out).all() and np.array_equal(out, ref)
              and chi == ref_chi, f"{name}: in a world of one rank the "
              "sharded solve is not the single-device one bit for bit")
        return dev_

    init, i, j, meas, info = multi_loop_graph(MULTI_LOOP["n_nodes"])
    edges = solver_edges(i, j, meas, info, dev)
    p0 = torch.as_tensor(init, device=dev)
    its = MULTI_LOOP["iterations"]
    single = opt_mod.optimize(p0, edges, iterations=its)[0].cpu().numpy()
    out, ts = timed(lambda: solver_sharded.optimize_sharded(
        mesh, p0, edges, iterations=its))
    summary["dense_570"] = {"dev": held("optimize_sharded, 570 nodes",
                                        out.cpu().numpy(), single),
                            "solve_s": ts}
    blocks = schur.make_partition(p0.shape[0], edges, SCHUR_BLOCKS)
    single = schur.optimize_schur(p0, edges, blocks,
                                  iterations=its).cpu().numpy()
    out, ts = timed(lambda: schur_sharded.optimize_schur_sharded(
        mesh, p0, edges, blocks, iterations=its))
    summary["schur_570"] = {"dev": held("optimize_schur_sharded, 570 nodes",
                                        out.cpu().numpy(), single),
                            "solve_s": ts}

    def direct(name, init, edges, seg, its):
        p0 = torch.as_tensor(init, device=dev)
        part = sparse_direct.make_segments(p0.shape[0], edges,
                                           max_seg_len=seg)
        (p1, c1), t1 = timed(lambda: sparse_direct.optimize_direct(
            p0, edges, part, iterations=its))
        (p2, c2), t2 = timed(lambda: sparse_direct_sharded
                             .optimize_direct_sharded(mesh, p0, edges, part,
                                                      iterations=its))
        print(f"  optimize_direct_sharded, {name} nodes: "
              f"{median(t2) * 1e3:.1f} ms (single "
              f"{median(t1) * 1e3:.1f} ms, median of 3)")
        return (p2.cpu().numpy(), float(c2), p1.cpu().numpy(), float(c1),
                {"solve_s": t2, "single_solve_s": t1})

    out, chi, ref, ref_chi, st = direct("570", init, edges,
                                        MULTI_LOOP["max_seg_len"],
                                        MULTI_LOOP["iterations"])
    st["dev"] = held("optimize_direct_sharded, 570 nodes", out, ref, chi,
                     ref_chi)
    summary["direct_570"] = st
    tl = [sv["tl_" + k] for k in ("gt", "init", "i", "j", "meas", "info")]
    for name, (_, init, i, j, meas, info), chi_ref in (
            ("4000", tl, np.append(sv["tl_eps_chi2"], sv["tl_chi2"])),
            (str(TWO_LAP_BIG), two_lap_graph(TWO_LAP_BIG), sv["big_chi2"])):
        out, chi, ref, ref_chi, st = direct(
            name, init, solver_edges(i, j, meas, info, dev),
            TWO_LAP["max_seg_len"], TWO_LAP["iterations"])
        st["dev"] = held(f"optimize_direct_sharded, {name} nodes", out, ref,
                         chi, ref_chi)
        lo, hi = float(np.min(chi_ref)), float(np.max(chi_ref))
        print(f"    chi2 {chi:.5f}; the reference's {lo:.5f}-{hi:.5f}")
        check((1 - TWO_LAP_RTOL) * lo <= chi <= (1 + TWO_LAP_RTOL) * hi,
              f"optimize_direct_sharded, {name} nodes: chi2 outside the "
              "reference's range")
        summary[f"direct_{name}"] = {**st, "chi2": chi}

    sp_grp = canonical_slam_params(OFFLINE_SPLIT_M, 64, **GROUPED_GRAPH)
    edges_lc = zip(lc["off_edge_ij"][:, 0], lc["off_edge_ij"][:, 1],
                   lc["off_edge_rel"], lc["off_edge_cov"])
    slam = interop.graph_from_jax(sp_grp, interop.tree_from_flat(
        lc, "off_bank"), lc["off_node_T_before"], edges_lc, device=dev)
    stacked = node_mod.stack_nodes(slam.nodes)
    ref_i, mov_i, mask = slam.candidate_pairs()
    # Each pair's draws as phase 9e's chunk gave them (chunk c holds the
    # pairs grp_chunk_start[c] onwards, a row each).
    starts = list(sv["grp_chunk_start"]) + [ref_i.shape[0]]
    u = torch.as_tensor(np.concatenate([
        sv["grp_pair_u"][c][:e - s] for c, (s, e) in enumerate(
            zip(starts[:-1], starts[1:]))]), device=dev)
    check(u.shape[0] == ref_i.shape[0], "phase 9e's draws do not cover "
                                        "the candidate pairs")
    fp = sp_grp.fuser
    args = (fp.features, fp.ndt.resolution, stacked, ref_i, mov_i, mask, u)
    cuda_kernels.reset_launch_counts()
    one = links_mod.compute_links_batch(*args)
    ls, tl_s = timed(lambda: links_sharded.compute_links_sharded(mesh, *args))
    same = all(torch.equal(getattr(ls, f), getattr(one, f))
               for f in ("ref", "mov", "T", "score", "mask", "cov"))
    print(f"  compute_links_sharded over {ref_i.shape[0]} pairs of phase 9e's "
          f"bank: {median(tl_s) * 1e3:.1f} ms (median of 3), "
          f"{int(ls.mask.sum())} valid; equal to compute_links_batch: {same}")
    check(same, "the sharded links differ from compute_links_batch")
    check(cuda_kernels.LAUNCHES["overlap_score"] > 0
          and cuda_kernels.LAUNCHES["match_features"] > 0 and all(
              v == 0 for k, v in cuda_kernels.LAUNCHES.items()
              if k not in ("overlap_score", "match_features")),
          "the link proposals launched another entry than match_features "
          "and overlap_score")
    summary["links"] = {"pairs": int(ref_i.shape[0]), "equal": same,
                        "wall_s": tl_s}

    # The reference's placement names over this world's mesh.
    rows = mesh_mod.global_put(mesh, lc["off_node_T_before"], ("dp",))
    full = torch.as_tensor(lc["off_node_T_before"], device=dev)
    names_ok = (
        torch.equal(rows, mesh_mod.sharded(mesh, full))
        and np.array_equal(mesh_mod.global_get(mesh, rows),
                           lc["off_node_T_before"])
        and np.array_equal(mesh_mod.global_get(
            mesh, mesh_mod.global_put(mesh, lc["off_node_T_before"], ()), ()),
            lc["off_node_T_before"])
        and mesh_mod.replicated(mesh, full) is full)
    print(f"  global_put / global_get / sharded / replicated of the LC "
          f"graph's {full.shape[0]} node poses: read back equal {names_ok}")
    check(names_ok, "the mesh placement names do not read back")

    fl = dict(np.load(FLEET_FIXTURE))
    fpf = presets.fleet_serving()
    seq = sequence(fl, dev)
    inputs = scaling.build_fleet_inputs(fpf, seq, 8)
    _, traj1, sc1 = scan_driver.run_sequence_batch(fpf, *inputs)
    _, traj2, sc2 = scaling.run_sequence_batch_sharded(mesh, fpf, *inputs)
    same = torch.equal(traj1, traj2) and torch.equal(sc1, sc2)
    print(f"  run_sequence_batch_sharded, 8 streams: equal to "
          f"run_sequence_batch: {same}")
    check(same, "the sharded fleet differs from run_sequence_batch")
    cuda_kernels.reset_launch_counts()
    sps, times = scaling.measure_fleet_throughput(
        fpf, seq, n_devices=1, streams_per_device=FLEET_SIZES[-1], reps=3,
        mesh=mesh)
    launches = cuda_kernels.LAUNCHES["newton_solve_batch"]
    print(f"  measure_fleet_throughput(n_devices=1, streams_per_device="
          f"{FLEET_SIZES[-1]}) through the sharded path: {sps:.1f} aggregate "
          f"scans/s (runs {', '.join(f'{t:.3f}' for t in times)} s); "
          f"newton_solve_batch launches {launches}")
    check(np.isfinite(sps) and sps > 0 and launches > 0,
          "the sharded fleet measured nothing or launched no kernel")
    summary["fleet"] = {"scans_per_s": sps, "run_s": times,
                        "launches": launches}

    with tempfile.TemporaryDirectory() as tmp:
        out_npz = os.path.join(tmp, "rank0.npz")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.join(ROOT, "examples",
                                          "multihost_worker_torch.py"),
             "--rank", "0", "--world", "1", "--port", str(_free_port()),
             "--out", out_npz],
            capture_output=True, text=True, timeout=300, cwd=ROOT)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"the worker failed in an NCCL world:\n{proc.stdout[-2000:]}"
              f"{proc.stderr[-2000:]}")
        w = dict(np.load(out_npz))
    devs = {k: float(np.abs(w[k] - w[k + "_single"]).max()) for k in (
        "multi_loop48_dense", "multi_loop48_schur", "multi_loop48_direct",
        "two_lap200_direct")}
    fleet_same = np.array_equal(w["fleet_trajs"], w["fleet_single_trajs"])
    print(f"  examples/multihost_worker_torch.py in an NCCL world of one "
          f"rank: {wall:.1f} s; sharded vs single {devs}; fleet equal "
          f"{fleet_same}; mesh refusals {int(w['mesh_refusals'])} of 2")
    check(max(devs.values()) == 0.0 and fleet_same
          and int(w["mesh_refusals"]) == 2, "the NCCL worker's sharded "
                                            "programs depart")
    x = np.arange(36, dtype=np.float32).reshape(12, 3)   # the worker's
    check(float(w["mesh_names_ok"][0]) == 1.0
          and np.array_equal(w["mesh_names_get"], x)
          and np.array_equal(w["mesh_names_shard"], x)
          and np.array_equal(w["mesh_names_mask"], np.arange(12) % 3 == 0),
          "the worker's mesh placement names do not read back")
    summary["worker"] = {"wall_s": wall, "dev": devs}
    return summary, launches


def run_chunked(sp, fx, dev, chunk=CHUNK):
    """The main path through scan_driver.run_graph_chunk, `chunk` scans a
    call (the last call padded with inactive rows), with the host's part
    between calls as the reference's run_sequence_chunked makes it
    (graph/slam.py:183-225 of the JAX package): the chunk fuses the
    split scan into the old node, then split_node freezes it and opens
    the next.  Returns (trajectory (T, 3), frozen nodes, their origins
    (n, 3), seconds)."""
    T = lambda x, dt=torch.float32: torch.as_tensor(x, dtype=dt,  # noqa
                                                    device=dev)
    ranges, hit = T(fx["ranges"]), T(fx["hit"], torch.bool)
    odom, u = T(fx["odom"]), T(fx["ransac_u"])
    p, gp = sp.fuser, sp.graph
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slam = NDTFeatureGraphSLAM(sp, seed=0)
    slam.initialize(T(fx["gt"][0]), torch.zeros(3, device=dev), ranges[0],
                    hit[0])
    st, fm, cur_T = slam.state, slam.fmap, T(slam.current_T)
    dist, cnt = 0.0, 0
    traj, nodes, node_T = [], [], []
    t, t_total = 1, ranges.shape[0]
    while t < t_total:
        k = min(chunk, t_total - t)

        def rows(x, start):
            x = x[start:start + k]
            return torch.cat([x, x.new_zeros((chunk - k,) + x.shape[1:])])

        can_split = len(nodes) + 1 < gp.max_nodes
        st, fm, ctraj, _, meta = scan_driver.run_graph_chunk(
            p, st, fm, dist, cnt, rows(odom, t), rows(ranges, t),
            rows(hit, t), np.arange(chunk) < k,
            gp.new_node_transl_dist if can_split else math.inf,
            fm_incr=p.feature_map_update_incr, ransac_u=rows(u, t - 1))
        dist, cnt = float(meta[0]), int(meta[1])
        n_proc, split_idx = int(meta[2]), int(meta[3])
        traj += [se2.compose(cur_T, ctraj[i]) for i in range(n_proc)]
        if split_idx >= 0:
            s = t + split_idx
            frozen, _, _, new_T, st, fm = scan_driver.split_node(
                p, gp.incremental_link_source, cur_T, st, fm, ranges[s],
                hit[s])
            nodes.append(frozen)
            node_T.append(cur_T)
            cur_T, dist, cnt = new_T, 0.0, 0
        t += n_proc
    traj = np.concatenate([slam.current_T[None],
                           torch.stack(traj).cpu().numpy()])
    node_T = np.asarray([x.cpu().numpy() for x in node_T]).reshape(-1, 3)
    torch.cuda.synchronize()
    return traj, nodes, node_T, time.perf_counter() - t0


def _leaves(obj):
    out = []
    node_mod.map_tensors(lambda x: out.append(x) or x, obj)
    return out


def chunked_case(sp, fx, main_slam, dev):
    """Phase 16 (a): run_graph_chunk in chunks of CHUNK over the
    canonical 200 scans against phase 4's run_graph_sequence: one
    `newton_solve` launch a scan and no other entry; the trajectory,
    the frozen nodes and their origins the same bits (the per-scan step
    is the same code), or else the first scan that differs named and the
    rest held within CHUNK_TOL; scans/s of both paths in turns, median
    of 3 (the first chunked run is the checked one; the others repeat
    its bits)."""
    ref = np.stack(main_slam.trajectory)
    scans = ref.shape[0] - 1
    main_s, chunk_s, runs = [], [], []
    for _ in range(3):
        main_s.append(run_main_path(sp, fx, dev)[1])
        cuda_kernels.reset_launch_counts()
        with map_updates() as n_map:
            runs.append(run_chunked(sp, fx, dev))
        chunk_s.append(runs[-1][3])
        if len(runs) == 1:
            launches, updates = dict(cuda_kernels.LAUNCHES), n_map
    traj, nodes, node_T, _ = runs[0]
    repeat = all(np.array_equal(r[0], traj) for r in runs[1:])
    print(f"  launches: {launches} ({launches['newton_solve'] / scans:.2f} "
          f"newton_solve per scan)")
    if dev.type == "cuda":
        check_map_launches(launches, updates, "run_graph_chunk")
        check(launches["newton_solve"] == scans and sum(launches.values())
              == scans + counted_launches(launches),
              "run_graph_chunk did not launch newton_solve alone, once a "
              "scan, beside the map updates")
    check(traj.shape == ref.shape and np.isfinite(traj).all(),
          "the chunked trajectory is not finite / of the wrong shape")
    same_nodes = len(nodes) == len(main_slam.nodes) and all(
        torch.equal(a, b) for n1, n2 in zip(nodes, main_slam.nodes)
        for a, b in zip(_leaves(n1), _leaves(n2)))
    same_T = np.array_equal(node_T, np.reshape(main_slam.node_T, (-1, 3)))
    same = np.array_equal(traj, ref)
    first, rest = None, 0.0
    if not same:
        first = int(np.argmax(np.any(traj != ref, -1)))
        rest = max(max_dev(traj[first:], ref[first:]))
    print(f"  {len(nodes)} frozen nodes (phase 4: {len(main_slam.nodes)}); "
          f"trajectory equal to phase 4's bit for bit: {same}; frozen "
          f"nodes {same_nodes}, their origins {same_T}; the later runs "
          f"repeat it: {repeat}" + (
              "" if same else f"; first differing scan {first}, the rest "
              f"within {rest:.2e}"))
    check(repeat, "the chunked path does not repeat on the card")
    check(not same or (same_nodes and same_T),
          "frozen nodes differ from phase 4's while the trajectory does not")
    check(same or rest <= CHUNK_TOL,
          f"the chunked trajectory departs from phase 4's from scan {first}")
    print(f"  scans/s in turns, median of 3: run_graph_chunk "
          f"{scans / median(chunk_s):.2f} ({', '.join(f'{r:.3f}' for r in chunk_s)}"
          f" s), run_graph_sequence {scans / median(main_s):.2f} "
          f"({', '.join(f'{r:.3f}' for r in main_s)} s) for {scans} scans")
    return {"launches": launches, "same_bits": same,
            "same_nodes": same_nodes, "first_diff": first, "rest_dev": rest,
            "scans_per_s": scans / median(chunk_s), "run_s": chunk_s,
            "main_scans_per_s": scans / median(main_s), "main_run_s": main_s}


def link_bank(lc, dev):
    """Phase 16b's inputs: the reference's offline loop-closure graph
    (phase 9e's 20-node bank) on `dev`, its candidate pairs and RANSAC
    draws from a seeded generator.  Returns (params, slam, stacked bank,
    ref_i, mov_i, u)."""
    sp = canonical_slam_params(OFFLINE_SPLIT_M, 64, **GROUPED_GRAPH)
    edges = zip(lc["off_edge_ij"][:, 0], lc["off_edge_ij"][:, 1],
                lc["off_edge_rel"], lc["off_edge_cov"])
    slam = interop.graph_from_jax(sp, interop.tree_from_flat(
        lc, "off_bank"), lc["off_node_T_before"], edges, device=dev)
    ref_i, mov_i, _ = slam.candidate_pairs()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    u = torch.rand((ref_i.shape[0], sp.fuser.features.ransac_hypotheses, 2),
                   generator=gen, device=dev)
    return (sp, slam, node_mod.stack_nodes(slam.nodes), ref_i.to(dev),
            mov_i.to(dev), u)


def link_case(lc, dev):
    """Phase 16 (b): compute_link for each candidate pair of the
    reference's offline loop-closure graph (phase 9e's node bank, 20
    nodes: phase 6's online run freezes 2, one pair), against the rows
    of compute_links_batch on the same draws over the online proposal's
    batch (its first online_lc_max_candidates pairs), over
    CHUNK_LINK_PAIRS pairs and over all of them: the same pose,
    validity, score and overlap-count bits (the score is the
    `overlap_score` kernel's, its order a function of H*W alone), and
    the proposals launch `overlap_score` and no other entry.  Then the
    overlap score's costs (overlap_score_case)."""
    sp, slam, stacked, ref_i, mov_i, u = link_bank(lc, dev)
    fp, res = sp.fuser.features, sp.fuser.ndt.resolution
    n = int(ref_i.shape[0])
    h, w = stacked.occ.shape[1:]
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    cuda_kernels.reset_launch_counts()
    sizes = (sp.graph.online_lc_max_candidates, CHUNK_LINK_PAIRS, n)
    batches = {p: links_mod.compute_links_batch(
        fp, res, stacked, ref_i[:p], mov_i[:p], ones[:p], u[:p])
        for p in sizes}
    batch_nb = {p: links_mod._overlap_score_flat(
        stacked.occ.reshape(-1), stacked.occ_origin, ref_i[:p], mov_i[:p],
        b.T, h, w, res)[1] for p, b in batches.items()}
    ri, mi = ref_i.tolist(), mov_i.tolist()
    same_T = {p: True for p in sizes}
    same_score = {p: 0 for p in sizes}
    score_dev = {p: 0.0 for p in sizes}
    for k in range(n):
        T, score, valid, nb = links_mod.compute_link(
            fp, res, slam.nodes[ri[k]], slam.nodes[mi[k]], u[k])
        for p, b in batches.items():
            if k < p:
                same_T[p] &= (torch.equal(T, b.T[k])
                              and bool(valid) == bool(b.mask[k]))
                same_score[p] += int(torch.equal(score, b.score[k])
                                     and torch.equal(nb, batch_nb[p][k]))
                score_dev[p] = max(score_dev[p],
                                   float((score - b.score[k]).abs()))
    print(f"  compute_link over the {n} candidate pairs of the "
          f"{len(slam.nodes)}-node bank ({int(batches[n].mask.sum())} "
          f"valid) against the rows of compute_links_batch: " + "; ".join(
              f"{p} pairs: poses and validity equal {same_T[p]}, scores "
              f"and overlap counts equal at {same_score[p]} of {p}, within "
              f"{score_dev[p]:.2e}" for p in sizes))
    check(all(same_T.values()) and all(
        same_score[p] == p for p in sizes),
          "compute_link differs from its compute_links_batch row")
    check(cuda_kernels.LAUNCHES["overlap_score"] > 0
          and cuda_kernels.LAUNCHES["match_features"] > 0 and all(
              v == 0 for k, v in cuda_kernels.LAUNCHES.items()
              if k not in ("overlap_score", "match_features")),
          "the link proposals launched another entry than match_features "
          "and overlap_score")
    launches = cuda_kernels.LAUNCHES["overlap_score"]
    scores = overlap_score_case(
        stacked, ref_i, mov_i, batches[n], res, fp, u, ones,
        (1, sizes[0], CHUNK_LINK_PAIRS, n, BIG_B))
    return {"pairs": n, "poses_equal": {str(p): e for p, e in same_T.items()},
            "scores_equal": {str(p): e for p, e in same_score.items()},
            "score_dev": {str(p): e for p, e in score_dev.items()},
            "launches": launches, "overlap_score": scores}


# The overlap score's operations a cell, counted from csrc/overlap.cu:
# every cell's known test; a cell the moving map knows: its centre (4),
# move (6), rel (4), floors and bounds (6); a cell both maps know: two
# sigmoids (an exp and a divide counted as ~17 each, FLOPS_PER_PAIR's
# rule), the difference, its square and the add.
OVERLAP_OPS_CELL, OVERLAP_OPS_KNOWN, OVERLAP_OPS_BOTH = 1, 20, 73


def overlap_bound(stacked, ref_i, mov_i, nb):
    """The least time of the overlap score of these pairs on this card:
    the bytes of the distinct maps the pairs read (each node's H*W
    log-odds and its origin once) plus the indices, poses and outputs,
    against the operations this run's maps need (OVERLAP_OPS_*:
    the known moving cells and the overlap counts `nb`).  Returns
    bound()'s dict and the work."""
    hw = stacked.occ[0].numel()
    nodes = torch.unique(torch.cat([ref_i, mov_i]))
    p = ref_i.shape[0]
    n_bytes = nodes.numel() * (hw + 2) * 4 + p * (8 + 8 + 12 + 4 + 8)
    known = (stacked.occ.reshape(-1, hw).abs() > 1e-6).sum(1)[mov_i]
    ops = (p * hw * OVERLAP_OPS_CELL + int(known.sum()) * OVERLAP_OPS_KNOWN
           + int(nb.sum()) * OVERLAP_OPS_BOTH)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "operations": ops}


@contextlib.contextmanager
def overlap_group_forced(group):
    """Inside: cuda_kernels.overlap_score takes groups of `group` pairs
    (0: the pair path) whatever its size rule says."""
    rule = cuda_kernels.overlap_group
    cuda_kernels.overlap_group = lambda n_pairs: group
    try:
        yield
    finally:
        cuda_kernels.overlap_group = rule


def overlap_score_case(stacked, ref_i, mov_i, links, res, fp, u, ones,
                       sizes, rounds=5):
    """The link paths' overlap score at each of `sizes` pairs (the
    candidate pairs of the bank under their RANSAC poses, repeated to
    BIG_B): the `overlap_score` kernel against the eager path it
    replaced (cuda_kernels.overlap_score_reference with the `row_sum`
    kernel, the parent's path on the card) and the eager path with
    torch.sum: the differing cell indices (the kernel's `cells` against
    the eager path's) and counts, the largest score difference of the
    timed call (which must equal the `cells` call's bits), and the time of
    one call of each, in turns, median of `rounds`: CUDA events around
    the call after a synchronisation (what a call holds the card, the
    host's launches and the wrapper's Python included), the same after
    two reads of L2_FLUSH_BYTES (cold_ms: a cold L2; the eager path's
    ~60 launches outlast the reads, so its cold time keeps host gaps),
    and the device time by the profiler (the sum of the call's
    operations, warm); beside the bound of the kernel's inputs.  Then the link paths themselves with the
    kernel and with the eager path + `row_sum`, in turns (compute_links_batch at the
    online batch, rescore_links at all pairs), with their device
    operations; and `row_sum` on rescore_links' eager overlap matrix
    (row_sum_checks: its warm comparison with torch.sum).  Returns the
    numbers; the kernel's row of the `kernels` line from the 171-pair
    case."""
    h, w = stacked.occ.shape[1:]
    occ_flat, origins = stacked.occ.reshape(-1), stacked.occ_origin
    n = ref_i.shape[0]
    row_sum = cuda_kernels.row_sum
    torch_sum = lambda x: x.sum(-1)  # noqa: E731

    def eager(rs):
        return lambda r, m, T: cuda_kernels.overlap_score_reference(
            occ_flat, origins, r, m, T, h, w, res, sum_rows=rs)

    def path(group):
        def fn(r, m, T):
            with overlap_group_forced(group):
                return cuda_kernels.overlap_score(occ_flat, origins, r, m, T,
                                                  h, w, res)
        return fn

    lib = cuda_kernels.build()
    fns = {"kernel": lambda r, m, T: cuda_kernels.overlap_score(
               occ_flat, origins, r, m, T, h, w, res),
           "pair path": path(0), "group path": None,
           "eager + row_sum": eager(row_sum),
           "eager + torch.sum": eager(torch_sum)}
    order = list(fns) + list(fns)[::-1]
    buf = torch.ones(L2_FLUSH_BYTES // 4, device=occ_flat.device)
    before = cuda_kernels.LAUNCHES["row_sum"]
    out = {}
    for p in sizes:
        idx = torch.arange(p, device=ref_i.device) % n
        r, m = ref_i[idx].contiguous(), mov_i[idx].contiguous()
        T = links.T[idx].contiguous()
        args = (r, m, T)
        group = cuda_kernels.overlap_group(p) or 4
        fns["group path"] = path(group)
        score, nb, cells = cuda_kernels.overlap_score(
            occ_flat, origins, r, m, T, h, w, res, cells=True)
        e_cells = overlap_cells_eager(origins, r, m, T, h, w, res)
        outs = {k: fn(*args) for k, fn in fns.items()}
        # The timed call (no cell indices, the kernel's early return for
        # vectors the moving map does not know) against the eager paths,
        # and against the call that wrote the cell indices.
        k_score, k_nb = outs["kernel"]
        same = torch.equal(k_score, score) and torch.equal(k_nb, nb)
        diff = {k: float((o[0] - k_score).abs().max())
                for k, o in outs.items() if k != "kernel"}
        nb_off = {k: int((o[1] != k_nb).sum())
                  for k, o in outs.items() if k != "kernel"}
        cells_off = int((cells.long() != e_cells).sum())
        del cells, e_cells
        # Both kernel paths against the kernel's numpy mirror (the pair
        # path's order) with the card's transcendentals.
        m_score, m_nb, _ = overlap_mirror(
            stacked.occ.reshape(-1, h * w).cpu().numpy(),
            origins.cpu().numpy(), r.cpu().numpy(), m.cpu().numpy(),
            T.cpu().numpy(), h, w, res,
            fns=torch_transcendentals(occ_flat.device))
        mirror_off = {k: int((o[0].cpu().numpy().view(np.uint32)
                              != m_score.view(np.uint32)).sum()
                             + (o[1].cpu().numpy() != m_nb).sum())
                      for k, o in outs.items()
                      if k in ("kernel", "pair path", "group path")}
        wall = {k: [] for k in fns}
        for _ in range(rounds):
            for k in order:
                fn = fns[k]
                torch.cuda.synchronize()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn(*args)
                b.record()
                torch.cuda.synchronize()
                wall[k].append(a.elapsed_time(b))
        warm = {k: median(v) for k, v in wall.items()}
        cold = {k: [] for k in fns}
        for k in order:
            # Two reads: the kernel's wrapper takes ~0.1 ms of the host,
            # longer than one read of the buffer.
            cold[k].append(cold_ms(lambda k=k: fns[k](*args),
                                   lambda: (buf.amax(), buf.amax()),
                                   reps=rounds))
        cold = {k: sum(v) / len(v) for k, v in cold.items()}
        prof = {k: [] for k in fns}
        for k in order:
            prof[k].append(device_ms(lambda k=k: fns[k](*args), reps=rounds))
        prof = {k: sum(v) / len(v) for k, v in prof.items()}
        # The parent's sum alone on this size's eager overlap matrix.
        seen = []
        cuda_kernels.overlap_score_reference(
            occ_flat, origins, r, m, T, h, w, res,
            sum_rows=lambda x: seen.append(x) or row_sum(x))
        sums = [device_ms(fn, reps=rounds) for fn in (
            lambda: cuda_kernels.row_sum(seen[0]),
            lambda: seen[0].sum(-1), lambda: seen[0].sum(-1),
            lambda: cuda_kernels.row_sum(seen[0]))]
        del seen
        prof["row_sum alone"] = (sums[0] + sums[3]) / 2
        prof["torch.sum alone"] = (sums[1] + sums[2]) / 2
        bnd = overlap_bound(stacked, r, m, nb)
        out[p] = {"warm_ms": warm, "cold_ms": cold, "device_ms": prof,
                  "warm_readings_ms": wall, "score_diff": diff,
                  "nb_off": nb_off, "cells_off": cells_off,
                  "cells_call_equal": same, "group": group,
                  "mirror_off": mirror_off,
                  "overlap_cells": int(nb.sum()), **bnd}
        print(f"  overlap score, {p} pairs of {h} x {w} cells: "
              + " / ".join(fns) + ", us: warm L2 (CUDA "
              f"events, median of {rounds} in turns) " + " / ".join(
                  f"{v * 1e3:.2f}" for v in warm.values())
              + "; cold L2 " + " / ".join(f"{v * 1e3:.2f}"
                                          for v in cold.values())
              + "; profiler " + " / ".join(f"{v * 1e3:.2f}"
                                           for v in prof.values())
              + " (and row_sum / torch.sum alone on the eager matrix)"
              + f"; bound {bnd['bound_ms'] * 1e3:.3f} ({bnd['bound_by']}: "
              f"{bnd['bytes'] / 1e6:.2f} MB, {bnd['operations'] / 1e6:.1f} "
              f"Mop); cell indices off the eager path's {cells_off} of "
              f"{p * h * w}, counts off {nb_off}, scores within {diff}, "
              f"the timed call = the cell indices' call: {same}; "
              f"groups of {group} on the group path; scores and counts "
              f"off overlap_mirror: {mirror_off}")
        check(not any(mirror_off.values()),
              "an overlap kernel path departs from overlap_mirror")
        check(same, "the overlap kernel's timed call and its call with "
              "cell indices give different scores or counts")
        check(cells_off == 0 and not any(nb_off.values()),
              "the overlap kernel's cell indices or counts differ from the "
              "eager path's")
        check(all(d <= OVERLAP_SCORE_TOL for d in diff.values()),
              "the overlap kernel's scores part from the eager path's "
              "beyond 1e-6")
        check(cold["kernel"] >= bnd["bound_ms"],
              "the overlap kernel's cold time lies below its bound")
    del buf

    print("  the mirror of the kernel (tests/test_torch_overlap.py) on the "
          "card at small grids and edge cases:")
    mirror = {}
    for (hh, ww), pp, edge in (((37, 53), 17, None), ((200, 200), 3, None),
                               ((40, 40), 6, "cell edges"),
                               ((40, 40), 6, "thresholds")):
        key = f"{hh}x{ww} x {pp}" + (f" {edge}" if edge else "")
        mirror[key] = overlap_case_checks(hh, ww, pp, 0, occ_flat.device,
                                          edge)
        print(f"    {key}: {mirror[key]}")
        check(mirror[key]["mirror_off"] == 0 and mirror[key]["cells_off"]
              == 0 and mirror[key]["repeat"] and mirror[key]["alone"],
              f"the overlap kernel departs from its mirror ({key})")

    # The link paths with the kernel and with the parent's eager path.
    p_on = sizes[1]
    paths = {"compute_links_batch_" + str(p_on): lambda: (
        links_mod.compute_links_batch(fp, res, stacked, ref_i[:p_on],
                                      mov_i[:p_on], ones[:p_on], u[:p_on])),
             "rescore_links_" + str(n): lambda: links_mod.rescore_links(
                 res, stacked, links)}
    flat = links_mod._overlap_score_flat
    plain_flat = lambda oc, og, r, m, T, hh, ww, rr: (  # noqa: E731
        cuda_kernels.overlap_score_reference(oc, og, r.long(), m.long(), T,
                                             hh, ww, rr))
    path_ms = {k: {"kernel": [], "eager + row_sum": []} for k in paths}
    path_ops = {}
    for variant in ("kernel", "eager + row_sum", "eager + row_sum",
                    "kernel"):
        links_mod._overlap_score_flat = (flat if variant == "kernel"
                                         else plain_flat)
        try:
            for k, call in paths.items():
                for _ in range(rounds):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    call()
                    torch.cuda.synchronize()
                    path_ms[k][variant].append(
                        (time.perf_counter() - t0) * 1e3)
                if (k, variant) not in path_ops:
                    path_ops[(k, variant)] = ops_per_call(call)
        finally:
            links_mod._overlap_score_flat = flat
    path_ms = {k: {v: median(t) for v, t in d.items()}
               for k, d in path_ms.items()}
    print("  the link paths, ms with the host (median of "
          f"{2 * rounds} in turns) and device operations a call, kernel / "
          "eager + row_sum: " + "; ".join(
              f"{k} {d['kernel']:.3f} / {d['eager + row_sum']:.3f} ms, "
              f"{path_ops[(k, 'kernel')]} / "
              f"{path_ops[(k, 'eager + row_sum')]} ops"
              for k, d in path_ms.items()))

    # row_sum's own verdict against torch.sum, on the eager path's
    # overlap matrix of rescore_links (the parent's path).
    seen = []
    cuda_kernels.overlap_score_reference(
        occ_flat, origins, ref_i, mov_i, links.T.contiguous(), h, w, res,
        sum_rows=lambda x: seen.append(x) or row_sum(x))
    row = row_sum_checks(seen[0])
    full = out[n]
    kernel_row = {
        "max_abs_err": full["score_diff"]["eager + row_sum"],
        "ms": full["cold_ms"]["kernel"],
        "plain_ms": full["cold_ms"]["eager + row_sum"],
        "warm_ms": full["warm_ms"]["kernel"],
        "warm_plain_ms": full["warm_ms"]["eager + row_sum"],
        "device_ms": full["device_ms"]["kernel"],
        "plain_device_ms": full["device_ms"]["eager + row_sum"],
        "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
        "pairs": int(n), "cells": int(h * w)}
    return {"sizes": {str(k): v for k, v in out.items()}, "mirror": mirror,
            "paths_ms": path_ms,
            "path_ops": {f"{k} {v}": n_ops for (k, v), n_ops in
                         path_ops.items()},
            "kernel": kernel_row, "row_sum": row,
            "row_sum_yardstick_launches":
                cuda_kernels.LAUNCHES["row_sum"] - before}


def row_sum_checks(x):
    """The `row_sum` entry on the eager path's overlap matrix of
    rescore_links (pairs x H*W cells): against its plain twin torch.sum
    (the max |difference|; the orders differ), identical bits on repeat
    and for a row alone, times in turns beside the bound (each element
    read once from HBM).  The times are taken on a cold L2 (a read of
    L2_FLUSH_BYTES before each call: cold_ms), so that the bound holds;
    the eager path called it on a matrix it had just written, which 50
    MB of L2 holds (171 pairs: 27 MB), and that time is "warm_ms".  torch.sum is also the
    one PyTorch call of the same function (`library_ms`)."""
    got, again = cuda_kernels.row_sum(x), cuda_kernels.row_sum(x)
    plain = x.sum(-1)
    err = float((got - plain).abs().max())
    alone = torch.stack([cuda_kernels.row_sum(x[i]) for i in (0, -1)])
    check(torch.equal(got, again) and torch.equal(alone, got[[0, -1]]),
          "row_sum does not repeat its bits, or a row alone differs")
    check(err <= 1e-5 * float(plain.abs().max()) + 1e-6,
          "row_sum departs from torch.sum")
    n_bytes = 4 * x.numel() + 4 * x.shape[0]
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, x.numel() / F32_FLOP_PER_S
    out = {"max_abs_err": err, "rows": int(x.shape[0]),
           "cols": int(x.shape[1]),
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    kernel, plain = lambda: cuda_kernels.row_sum(x), lambda: x.sum(-1)
    buf = torch.ones(L2_FLUSH_BYTES // 4, device=x.device)
    cold = [cold_ms(f, buf.amax) for f in (plain, kernel, kernel, plain)]
    del buf
    readings = ", ".join(f"{t * 1e3:.2f}" for t in cold)
    print("    device time on a cold L2, us (torch.sum, kernel, kernel, "
          f"torch.sum; CUDA events): {readings}")
    warm = time_turns(kernel, plain, 50, 50, label="torch.sum, warm L2")
    out.update(ms=(cold[1] + cold[2]) / 2, plain_ms=(cold[0] + cold[3]) / 2,
               events_ms=warm["events_ms"],
               plain_events_ms=warm["plain_events_ms"],
               warm_ms=warm["ms"], warm_plain_ms=warm["plain_ms"])
    out["library_ms"] = out["plain_ms"]
    print(f"  row_sum on {tuple(x.shape)}, cold L2: {out['ms'] * 1e3:.2f} us "
          f"against torch.sum {out['plain_ms'] * 1e3:.2f} us, bound "
          f"{out['bound_ms'] * 1e3:.2f} us ({out['bound_by']}); warm L2 "
          f"{out['warm_ms'] * 1e3:.2f} / {out['warm_plain_ms'] * 1e3:.2f} "
          f"us; max |difference| {err:.2e}")
    check(out["ms"] >= out["bound_ms"],
          "row_sum's cold time lies below its bound")
    return out


# csrc/overlap.cu's layout: threads a block, cells a vector, the portable
# cluster size; and the threshold above which a map knows a cell.
OVERLAP_THREADS, OVERLAP_VEC, OVERLAP_MAX_CLUSTER = 256, 4, 8
OVERLAP_HAS = np.float32(1e-6)
OVERLAP_SCORE_TOL = 1e-6      # the kernel's score against the eager path's


def overlap_cluster(hw):
    """Blocks of a pair's cluster at `hw` cells (overlap.cu cluster_of)."""
    n_vec = -(-hw // OVERLAP_VEC)
    return max(1, min(OVERLAP_MAX_CLUSTER, -(-n_vec // OVERLAP_THREADS)))


def fma32(a, b, c):
    """float32 a * b + c rounded once, elementwise: the product is exact
    in float64, TwoSum gives the float64 sum's error, and where that sum
    lies on a float32 midpoint the error decides the side."""
    a, b, c = (np.asarray(x, np.float64) for x in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    r = s.astype(np.float32)
    r64 = r.astype(np.float64)
    other = np.nextafter(r, np.where(s > r64, np.inf, -np.inf).astype(
        np.float32))
    tie = (s != r64) & (s == (r64 + other.astype(np.float64)) / 2) & (e != 0)
    return np.where(tie & ((e > 0) == (other > r)), other, r)


def _cell_index(x):
    """floor(x) as the card's float -> int cast (cvt.rzi): NaN -> 0,
    saturated to int32."""
    f = np.floor(x).astype(np.float64)
    f = np.where(np.isnan(f), 0.0, np.clip(f, -2.0 ** 31, 2.0 ** 31 - 1))
    return f.astype(np.int64)


def numpy_transcendentals():
    f32 = np.float32
    return (np.cos, np.sin, lambda x: f32(1) / (f32(1) + np.exp(-x)))


def torch_transcendentals(dev):
    """cos, sin and sigmoid of a float32 numpy array by torch on `dev`:
    on the card ATen's cosf, sinf and 1 / (1 + expf(-x)), the calls the
    overlap kernel makes."""
    def on(fn):
        return lambda x: fn(torch.as_tensor(np.asarray(x, np.float32),
                                            device=dev)).cpu().numpy()
    return on(torch.cos), on(torch.sin), on(torch.sigmoid)


def overlap_mirror(occ, origins, ref_i, mov_i, T, h, w, res, fns=None):
    """csrc/overlap.cu in numpy: every operation rounded as the kernel
    rounds it and the adds in its order (each thread's four lanes over
    its vectors, (a0 + a1) + (a2 + a3), the warp tree, the block's warps,
    the cluster's blocks).  occ (N, H*W) float32 log-odds, origins (N,
    2), ref_i / mov_i (P,), T (P, 3).  Returns (score (P,) float32,
    nb (P,) int64, cells (P, H*W) int64: each moving cell's flat index
    into the reference map, -1 out of bounds).  `fns`: (cos, sin,
    sigmoid) of float32 arrays; torch_transcendentals(card) gives the
    kernel's bits, numpy's are the default."""
    f32 = np.float32
    cos_fn, sin_fn, sigmoid = fns or numpy_transcendentals()
    hw = h * w
    occ = np.asarray(occ, f32).reshape(-1, hw)
    origins = np.asarray(origins, f32).reshape(-1, 2)
    T = np.asarray(T, f32).reshape(-1, 3)
    res32 = f32(res)
    inv = f32(1) / res32
    sig = np.asarray(sigmoid(occ), f32)
    cos, sin = (np.asarray(fn(T[:, 2]), f32) for fn in (cos_fn, sin_fn))
    cx = (np.arange(w, dtype=f32) + f32(0.5)) * res32
    cy = (np.arange(h, dtype=f32) + f32(0.5)) * res32
    n_cl = overlap_cluster(hw)
    threads = n_cl * OVERLAP_THREADS
    n_vec = -(-hw // OVERLAP_VEC)
    steps = -(-n_vec // threads)
    p = T.shape[0]
    score = np.empty(p, f32)
    nb = np.empty(p, np.int64)
    cells = np.empty((p, hw), np.int64)
    for k in range(p):
        mi, ri = int(mov_i[k]), int(ref_i[k])
        x = np.broadcast_to((origins[mi, 0] + cx)[None, :], (h, w)).ravel()
        y = np.broadcast_to((origins[mi, 1] + cy)[:, None], (h, w)).ravel()
        c, s = cos[k], sin[k]
        tx = fma32(-s, y, c * x) + T[k, 0]
        ty = fma32(c, y, s * x) + T[k, 1]
        ix = _cell_index((tx - origins[ri, 0]) * inv)
        iy = _cell_index((ty - origins[ri, 1]) * inv)
        inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        flat = np.where(inb, iy * w + ix, 0)
        cells[k] = np.where(inb, flat, -1)
        both = ((np.abs(occ[mi]) > OVERLAP_HAS) & inb
                & (np.abs(occ[ri][flat]) > OVERLAP_HAS))
        d = sig[mi] - sig[ri][flat]
        v = np.zeros(steps * threads * OVERLAP_VEC, f32)
        v[:hw] = np.where(both, d * d, f32(0))
        v = v.reshape(steps, threads, OVERLAP_VEC)
        acc = np.zeros((threads, OVERLAP_VEC), f32)
        for j in range(steps):
            acc = acc + v[j]
        t = ((acc[:, 0] + acc[:, 1]) + (acc[:, 2] + acc[:, 3])).reshape(
            n_cl, OVERLAP_THREADS // 32, 32)
        for off in (16, 8, 4, 2, 1):
            t[..., :off] = t[..., :off] + t[..., off:2 * off]
        warps = t[..., 0]
        block = warps[:, 0].copy()
        for j in range(1, warps.shape[1]):
            block = block + warps[:, j]
        total = block[0]
        for j in range(1, n_cl):
            total = total + block[j]
        nb[k] = int(both.sum())
        score[k] = total / f32(nb[k]) if nb[k] > 0 else f32(1)
    return score, nb, cells


def overlap_cells_eager(origins, ref_i, mov_i, T, h, w, res):
    """The eager score's (cuda_kernels.overlap_score_reference's) flat
    reference index of each moving cell, -1 out of bounds, by its own
    operations: what the kernel's `cells` output is held to."""
    centers = origins[mov_i][..., None, :] + cuda_kernels._cell_centers(
        h, w, res, T.device)
    tp = se2.transform_points(T, centers)
    rel = (tp - origins[ref_i][..., None, :]) / res
    ix = torch.floor(rel[..., 0]).to(torch.int64)
    iy = torch.floor(rel[..., 1]).to(torch.int64)
    inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    return torch.where(inb, iy * w + ix, -1)


OVERLAP_EDGE_CASES = ("no overlap", "out of bounds", "far out of bounds",
                      "thresholds", "cell edges")


def overlap_case(h, w, n_pairs, seed, edge=None, res=0.5):
    """Inputs of the overlap score, numpy: (occ (N, H*W) float32, origins
    (N, 2), ref_i (P,), mov_i (P,), T (P, 3), res).  A bank of nodes
    whose maps know ~40% of their cells (log-odds in [-3, 3]), origins
    near the grid's centre at the origin and poses within 3 m and 0.6
    rad, so that most pairs overlap; `edge` one of OVERLAP_EDGE_CASES:
    node 0's map all unknown (its pairs score 1.0 with no overlap),
    every pose moving every cell off the map (by 1 km, or by 3e9 m,
    beyond int32), log-odds at exactly +-1e-6 (unknown), the next float
    above (known), and -0.0, or poses of half a cell on grids whose
    origins are whole cells apart (every centre lands on a cell
    edge)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    n_nodes = max(2, min(n_pairs + 1, 6))
    occ = np.where(rng.random((n_nodes, h * w)) < 0.4,
                   rng.uniform(-3, 3, (n_nodes, h * w)), 0.0).astype(f32)
    origins = (-np.array([w, h]) * res / 2 + rng.uniform(
        -2, 2, (n_nodes, 2))).astype(f32)
    ref_i = rng.integers(0, n_nodes, n_pairs)
    mov_i = (ref_i + rng.integers(1, n_nodes, n_pairs)) % n_nodes
    T = rng.uniform([-3, -3, -0.6], [3, 3, 0.6], (n_pairs, 3)).astype(f32)
    if edge == "no overlap":
        occ[0] = 0.0
        ref_i[::2] = 0
        mov_i[::2] = 1
    elif edge == "out of bounds":
        T[:, :2] = rng.choice([-1e3, 1e3], (n_pairs, 2))
    elif edge == "far out of bounds":
        T[:, :2] = rng.choice([-3e9, 3e9], (n_pairs, 2))
    elif edge == "thresholds":
        pick = rng.integers(0, 5, occ.shape)
        lo = OVERLAP_HAS
        vals = np.array([lo, -lo, np.nextafter(lo, f32(1)),
                         -np.nextafter(lo, f32(1)), -0.0], f32)
        occ = np.where(rng.random(occ.shape) < 0.5, vals[pick], occ)
    elif edge == "cell edges":
        origins = (np.round(origins / res) * res).astype(f32)
        T[:, :2] = rng.choice([-0.5, 0.5], (n_pairs, 2)) * res
        T[:, 2] = 0.0
    elif edge is not None:
        raise ValueError(f"no overlap edge case {edge!r}")
    return occ, origins, ref_i, mov_i, T, res


def overlap_case_checks(h, w, n_pairs, seed, dev, edge=None):
    """The overlap kernel on one overlap_case on the card: against
    overlap_mirror with the card's transcendentals (score bits, counts,
    cell indices), against the eager path on the card
    (cuda_kernels.overlap_score_reference: cell indices and counts; the
    score's largest difference), on repeat, and the first and last pair scored
    alone (occupancy_overlap_score's one-pair form) against their rows.
    Returns the numbers of elements that differ ("mirror_off",
    "cells_off", "nb_off"), "score_dev", "repeat", "alone" and
    "launches" (kernel launches of the calls, five)."""
    occ, origins, ref_i, mov_i, T, res = overlap_case(h, w, n_pairs, seed,
                                                      edge)
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    bank, o, r, m, tt = t(occ), t(origins), t(ref_i), t(mov_i), t(T)
    args = (bank.reshape(-1), o, r, m, tt, h, w, res)
    before = cuda_kernels.LAUNCHES["overlap_score"]
    score, nb, cells = cuda_kernels.overlap_score(*args, cells=True)
    again = cuda_kernels.overlap_score(*args)
    alone = [cuda_kernels.overlap_score(
        bank[ref_i[k]], o[ref_i[k]], None, None, tt[k], h, w, res,
        mov_flat=bank[mov_i[k]], mov_origins=o[mov_i[k]])
        for k in (0, n_pairs - 1)]
    launches = cuda_kernels.LAUNCHES["overlap_score"] - before
    m_score, m_nb, m_cells = overlap_mirror(
        occ, origins, ref_i, mov_i, T, h, w, res,
        fns=torch_transcendentals(dev))
    e_score, e_nb = cuda_kernels.overlap_score_reference(*args)
    e_cells = overlap_cells_eager(o, r, m, tt, h, w, res)
    got = score.cpu().numpy()
    return {
        "mirror_off": int((got.view(np.uint32) != m_score.view(np.uint32))
                          .sum() + (nb.cpu().numpy() != m_nb).sum()
                          + (cells.cpu().numpy() != m_cells).sum()),
        "cells_off": int((cells.long() != e_cells).sum()),
        "nb_off": int((nb != e_nb).sum()),
        "score_dev": float((score - e_score).abs().max()),
        "repeat": torch.equal(score, again[0]) and torch.equal(nb, again[1]),
        "alone": all(torch.equal(a[0], score[k]) and torch.equal(a[1], nb[k])
                     for a, k in zip(alone, (0, n_pairs - 1))),
        "launches": launches}


def hmt_add_scan_case(dev):
    """Phase 16 (c): HMTMap.add_scan over phase 11's first HMT_ADD_SCANS
    scans (the window first spills cells into the tile store after
    scan 100), at the fuser's world poses, against the map HMTFuser
    builds over them.  The two recentre at other scans (add_scan checks
    every scan, the fuser every chunk), so HMTFuser's window is moved onto
    add_scan's centre first: then window and tile store are the same
    bits, since every scan's contribution lands inside both windows and
    spill and recall only ever add to zeros."""
    hx = dict(np.load(HMT_FIXTURE))
    fp = canonical_slam_params().fuser
    n, c = HMT_ADD_SCANS, int(hx["chunk"])
    T = lambda x, dt=torch.float32: torch.as_tensor(  # noqa: E731
        x, dtype=dt, device=dev)
    pts, mask = dataset.scan_to_points(T(hx["ranges"][:n]),
                                       T(hx["hit"][:n], torch.bool))
    odom, gt = T(hx["odom"][:n]), T(hx["gt"][:n])
    margin, tc = float(hx["margin"]), int(hx["tile_cells"])
    hf = HMTFuser(fp, gt[0], torch.zeros(3, device=dev), pts[0], mask[0],
                  recenter_margin=margin, tile_cells=tc)
    poses = torch.cat([gt[:1], T(hf.run_sequence(odom[1:], pts[1:], mask[1:],
                                                 chunk=c))])
    m = HMTMap(fp.ndt, gt[0][:2], tile_cells=tc)
    origins = set()
    for k in range(n):
        world_T = se2.compose(poses[k], hf.state.sensor_pose)
        m.add_scan(world_T[:2], se2.transform_points(world_T, pts[k]),
                   mask[k], margin=margin)
        origins.add(tuple(m.grid.origin.tolist()))
    hf.hmt.grid = hf.state.grid
    hf.hmt.recenter(m.center())
    same_window = _same_grid(_grid_np(hf.hmt.grid), _grid_np(m.grid))
    same_tiles = sorted(hf.hmt.tiles) == sorted(m.tiles) and all(
        np.array_equal(_bits(hf.hmt.tiles[key][f]), _bits(m.tiles[key][f]))
        for key in m.tiles for f in ("count", "psum", "outer", "occ"))
    n_cells = int(m.cell_list().mask.sum())
    stored = m.stored_cell_count()
    print(f"  add_scan over {n} scans ({len(origins) - 1} recentres; the "
          f"fuser's {hf.n_recenters}): window equal to HMTFuser's bit for "
          f"bit {same_window}, tile store {same_tiles} "
          f"({stored} stored cells); cell_list {n_cells} "
          f"cells, grid shape {tuple(m.grid.shape)}")
    check(stored > 0, "add_scan spilled no cell: the tile store is not "
                      "compared")
    check(same_window and same_tiles and n_cells > 0,
          "HMTMap.add_scan differs from the map HMTFuser builds")
    return {"scans": n, "recentres": len(origins) - 1,
            "fuser_recentres": hf.n_recenters, "same_window": same_window,
            "same_tiles": same_tiles, "stored_cells": stored,
            "cells": n_cells}


def helpers_case(fx, dev):
    """Phase 16 (d): to_paired_cells of a RANSAC result between scans 0
    and 1 and se2.dist / angular_dist on random poses: card against
    CPU, bit for bit (gathers), within 2 ulp of the distance (the
    card's norm rounds in another order) and 1e-6 rad."""
    from ndt_feature_graph_tpu_torch.features import (
        describe, detect, match_sets,
    )
    from ndt_feature_graph_tpu_torch.features.ransac import (
        MatchResult, to_paired_cells,
    )

    fp = canonical_slam_params().fuser.features
    cpu = torch.device("cpu")
    ranges, hit = torch.as_tensor(fx["ranges"][:2]), torch.as_tensor(
        fx["hit"][:2], dtype=torch.bool)
    feats = detect(fp, ranges, hit)
    desc = describe(fp, feats, ranges, hit)
    one = lambda x, i: node_mod.map_tensors(lambda v: v[i], x)  # noqa
    res = match_sets(fp, one(feats, 0), desc[0], one(feats, 1), desc[1],
                     torch.as_tensor(fx["ransac_u"][0]))
    on = lambda x: node_mod.map_tensors(lambda v: v.to(dev), x)  # noqa
    want = to_paired_cells(res, one(feats, 0), one(feats, 1))
    got = to_paired_cells(MatchResult(**{
        f.name: getattr(res, f.name).to(dev)
        for f in dataclasses.fields(MatchResult)}), on(one(feats, 0)),
        on(one(feats, 1)))
    paired = all(torch.equal(a.cpu(), b) for g, w in zip(got, want)
                 for a, b in zip(_leaves(g), _leaves(w)))
    rng = np.random.default_rng(0)
    a, b = (np.concatenate([rng.normal(0, 20, (4096, 2)),
                            rng.uniform(-np.pi, np.pi, (4096, 1))], -1)
            .astype(np.float32) for _ in range(2))
    devs = {}
    for name, ulps in (("dist", 2), ("angular_dist", None)):
        fn = getattr(se2, name)
        want_v = fn(torch.as_tensor(a, device=cpu),
                    torch.as_tensor(b, device=cpu))
        diff = (fn(torch.as_tensor(a, device=dev),
                   torch.as_tensor(b, device=dev)).cpu() - want_v).abs()
        if ulps:   # in units of the CPU value's float32 spacing
            diff = diff / torch.finfo(torch.float32).eps / want_v.abs().clamp(
                min=1.0)
        devs[name] = float(diff.max())
    print(f"  to_paired_cells ({int(want[0].mask.sum())} inlier pairs): "
          f"card equal to CPU {paired}; se2.dist card vs CPU "
          f"{devs['dist']:.2f} ulp, angular_dist {devs['angular_dist']:.1e} "
          f"rad")
    check(paired and int(want[0].mask.sum()) > 0,
          "to_paired_cells differs between card and CPU")
    check(devs["dist"] <= 2 and devs["angular_dist"] <= 1e-6,
          "se2.dist / angular_dist depart")
    return {"paired_equal": paired, "se2_dev": devs}


def entry_points_phase(sp, fx, main_slam, lc, dev):
    """Phase 16: the reference's last public entry points on the card."""
    print("phase 16a: run_graph_chunk, the canonical 200 scans in chunks "
          f"of {CHUNK}, against phase 4")
    chunked = chunked_case(sp, fx, main_slam, dev)
    print("phase 16b: compute_link on the reference's LC node bank")
    link = link_case(lc, dev)
    print(f"phase 16c: HMTMap.add_scan over phase 11's first "
          f"{HMT_ADD_SCANS} scans")
    hmt_add = hmt_add_scan_case(dev)
    print("phase 16d: to_paired_cells, se2.dist / angular_dist")
    helpers = helpers_case(fx, dev)
    return {"chunked": chunked, "compute_link": link, "hmt_add_scan": hmt_add,
            "helpers": helpers}



# Phase 17: the refinements and the plain registrations in one launch
# against the per-trial paths they replace.

def refine_args(map_params, m, nodes, links, src_budget=0):
    """The arguments of links.refine_links_d2d's solve: (T0, src_b,
    packed_flat, origins, row_offsets, h, w, resolution, m), built as
    refine_links_d2d builds them."""
    h, w = map_params.grid_h, map_params.grid_w
    nb = src_budget if src_budget > 0 else nodes.cells.means.shape[1]
    mov = links.mov
    src_b = CellList(means=nodes.cells.means[mov, :nb],
                     covs=nodes.cells.covs[mov, :nb],
                     mask=nodes.cells.mask[mov, :nb])
    return (links.T.contiguous(), src_b, nodes.target.packed.reshape(-1, 8),
            nodes.target.origin[links.ref],
            links.ref.to(torch.int64) * (h * w), h, w,
            map_params.resolution, m)


def per_trial_refine(map_params, m, nodes, links, src_budget=0):
    """The refinement as the port ran it before it was one launch: the
    lockstep d2d.newton_match_batch over one `fgh_dense_flat_batch`
    launch a trial (a read of the stop flag a 6-trial chunk), then one
    more launch for the Hessian at the result.  Returns (LinkSet, (d,
    score, trials, converged, H))."""
    T0, src_b, packed, origins, offs, h, w, res, m = refine_args(
        map_params, m, nodes, links, src_budget)

    def fgh(d_b):
        return cuda_kernels.fgh_dense_flat_batch(
            d_b, T0, src_b, packed, origins, offs, h, w, res,
            m.n_neighbours, m.lfd1, m.lfd2)

    zero = torch.zeros((T0.shape[0], 3), dtype=torch.float32,
                       device=T0.device)
    d, score, itr, conv = d2d.newton_match_batch(zero, m, fgh)
    H = fgh(d)[2]
    out = dataclasses.replace(
        links, T=se2.compose(d, T0), cov=d2d.cov_from_hessian(H, m),
        mask=links.mask & conv)
    return out, (d, score, itr, conv, H)


def _lanes_equal(a, b):
    """Per lane of (L, ...) tensors: equal bits (NaN equal to NaN)."""
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return same.reshape(a.shape[0], -1).all(-1)


ALONE_LANES = 4   # phase 17a: lanes of each call refined alone


def alone_lanes(sargs, solve):
    """How many of the first ALONE_LANES lanes of a link solve's batch
    keep their row's bits (d, score, trials, converged, H) when solved
    alone: the link solve sizes a lane's cluster by its shape alone."""
    T0, src_b, packed, origins, offs, h, w, res, m = sargs
    same = 0
    for i in range(min(T0.shape[0], ALONE_LANES)):
        one = CellList(*(x[i:i + 1] for x in (src_b.means, src_b.covs,
                                               src_b.mask)))
        got = cuda_kernels.newton_solve_batch(
            torch.zeros((1, 3), device=T0.device), T0[i:i + 1], one, packed,
            origins[i:i + 1], offs[i:i + 1], h, w, res, m, with_hessian=True)
        same += all(bool(_lanes_equal(g, x[i:i + 1])[0])
                    for g, x in zip(got, solve))
    return same


def refinement_case(name, calls, dev, times=True):
    """Phase 17a on the recorded refinements of one path: each call once
    through links.refine_links_d2d (one `newton_solve_batch` launch, no
    synchronising call) and once through the per-trial lockstep
    (per_trial_refine).  The solve's LM step rounds as the lockstep's
    eager operations do, over the same objective, so T, cov and mask
    must keep the lockstep's bits on every lane, and the Hessian the
    solve writes must be the bits of `fgh_dense_flat_batch` at the
    returned increment.  A lane that parts is excused only where the
    lockstep itself moves beyond SOLVE_TOL under a SOLVE_EPS change of
    its start (start_spread): it is named and held by held_to_all (link
    refinement is chaotic, PERF.md §6).  Also the summed score within 2%
    of the lockstep's, and the lanes that stop at their start on each
    side counted.  Prints the clusters the card holds at once against
    the lanes.  Times the largest call in turns.  Returns a summary."""
    lib = cuda_kernels.build()
    out = {"calls": len(calls), "lanes": 0, "bits_equal": 0,
           "hessian_equal": 0, "alone_equal": 0, "launches": 0,
           "per_trial_launches": 0,
           "syncs": 0, "per_trial_syncs": 0, "excepted": [], "waves": [],
           "score": 0.0, "per_trial_score": 0.0, "start_stopped": 0,
           "per_trial_start_stopped": 0}
    for k, (args, kwargs) in enumerate(calls):
        cuda_kernels.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                got = links_mod.refine_links_d2d(*args, **kwargs)
            syncs = _sync_warnings(caught)
            launches = dict(cuda_kernels.LAUNCHES)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                per, per_out = per_trial_refine(*args, **kwargs)
            per_syncs = _sync_warnings(caught)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        check(launches["newton_solve_batch"] == 1
              and sum(launches.values()) == 1,
              f"{name} refinement {k} launched {launches}, not one "
              "newton_solve_batch")
        out["launches"] += 1
        out["per_trial_launches"] += cuda_kernels.LAUNCHES[
            "fgh_dense_flat_batch"]
        out["syncs"] += syncs
        out["per_trial_syncs"] += per_syncs
        check(syncs == 0, f"{name} refinement {k} synchronised {syncs} "
                          "times")
        sargs = refine_args(*args, **kwargs)
        T0, src_b, packed, origins, offs, h, w, res, m = sargs
        lanes = T0.shape[0]
        zero = torch.zeros((lanes, 3), device=dev)
        solve = cuda_kernels.newton_solve_batch(zero, *sargs,
                                                with_hessian=True)
        check(torch.equal(got.T, se2.compose(solve[0], T0))
              and torch.equal(got.mask, args[3].mask & solve[3]),
              f"{name} refinement {k} is not its newton_solve_batch launch")

        def per_solve(d0, sargs=sargs):
            T0, src_b, packed, origins, offs, h, w, res, m = sargs
            return d2d.newton_match_batch(
                d0, m, lambda d: cuda_kernels.fgh_dense_flat_batch(
                    d, T0, src_b, packed, origins, offs, h, w, res,
                    m.n_neighbours, m.lfd1, m.lfd2))

        H_at = cuda_kernels.fgh_dense_flat_batch(
            solve[0], T0, src_b, packed, origins, offs, h, w, res,
            m.n_neighbours, m.lfd1, m.lfd2)[2]
        h_same = _lanes_equal(solve[4], H_at)
        out["hessian_equal"] += int(h_same.sum())
        check(bool(h_same.all()),
              f"{name} refinement {k}: the Hessian written at lanes "
              f"{(~h_same).nonzero()[:, 0].tolist()} is not the "
              "objective's at the returned increment")
        same = (_lanes_equal(got.T, per.T) & _lanes_equal(got.cov, per.cov)
                & (got.mask == per.mask))
        out["lanes"] += lanes
        out["bits_equal"] += int(same.sum())
        n_src = src_b.mask.shape[-1]
        cluster, resident = cuda_kernels._link_cluster(lib, dev, n_src, 0)
        if lanes > resident:
            out["waves"].append({"call": k, "lanes": lanes,
                                 "resident": resident})
        if k == 0 or lanes > resident:
            print(f"    {name} refinement {k}: {lanes} lanes x {n_src} "
                  f"source cells, {cluster} blocks a lane (the per-trial "
                  f"yardstick's too); {min(lanes, resident)} persistent "
                  f"clusters (the card holds {resident}) take the lanes")
        alone = alone_lanes(sargs, solve)
        out["alone_equal"] += alone
        check(alone == min(lanes, ALONE_LANES),
              f"{name} refinement {k}: a link refined alone parts from "
              "its row of the batch")
        if not bool(same.all()):
            parted = (~same).nonzero()[:, 0].tolist()
            spread = start_spread(per_solve, zero)
            bad = [i for i in parted if spread[i] <= SOLVE_TOL]
            print(f"    {name} refinement {k}: lanes {parted} part from "
                  "the per-trial lockstep's bits; it moves "
                  f"{[float(spread[i]) for i in parted]} under a "
                  f"{SOLVE_EPS:g} start change")
            check(not bad, f"{name} refinement {k}: lanes {bad} part from "
                           "the per-trial lockstep's bits though it is "
                           "stable there")
            keep = torch.tensor(parted, device=dev)
            held_to_all(
                f"{name} refinement {k}", tuple(x[keep] for x in solve[:4]),
                [("per-trial lockstep", tuple(x[keep] for x in per_out[:4]),
                  lambda d0: tuple(x[keep] for x in per_solve(
                      zero.index_put((keep,), d0))))], zero[keep])
            out["excepted"] += [(k, i) for i in parted]
        out["score"] += float(solve[1].sum())
        out["per_trial_score"] += float(per_out[1].sum())
        for side, r in (("start_stopped", solve),
                        ("per_trial_start_stopped", per_out)):
            out[side] += int(((r[2] == 1) & (r[0] == 0).all(-1)).sum())
    print(f"  {name}: {out['calls']} refinements, {out['lanes']} lanes: "
          f"T, cov and mask equal to the per-trial lockstep's bits at "
          f"{out['bits_equal']} lanes; the Hessian written equal to the "
          f"objective's at the result at {out['hessian_equal']}; parted "
          f"where the lockstep is itself unstable: {out['excepted']}; "
          f"lanes stopping at their start {out['start_stopped']} "
          f"(per-trial: {out['per_trial_start_stopped']}); summed score "
          f"{out['score']:.2f} (per-trial: {out['per_trial_score']:.2f}); "
          f"launches {out['launches']} "
          f"(per-trial: {out['per_trial_launches']} fgh_dense_flat_batch), "
          f"synchronising calls {out['syncs']} (per-trial: "
          f"{out['per_trial_syncs']})")
    check(abs(out["score"] - out["per_trial_score"])
          <= 0.02 * abs(out["per_trial_score"]),
          f"{name}: the refinements' summed score departs from the "
          "per-trial lockstep's beyond 2%")
    if times and calls:
        k = max(range(len(calls)),
                key=lambda i: calls[i][0][3].ref.shape[0])
        args, kwargs = calls[k]
        out["timed_lanes"] = int(args[3].ref.shape[0])
        # The bound: each lane's distinct table rows and source cells
        # read once, its scalars and its Hessian; FLOPS_PER_PAIR for
        # each valid pair at its result, in each of its evaluations.
        sargs = refine_args(*args, **kwargs)
        T0, src_b, packed, origins, offs, h, w, res, m = sargs
        lanes = T0.shape[0]
        solve = cuda_kernels.newton_solve_batch(
            torch.zeros((lanes, 3), device=dev), *sargs, with_hessian=True)
        n_bytes, lane_pairs = window_work(solve[0], T0, src_b, packed,
                                          origins, offs, h, w, res,
                                          m.n_neighbours, lanes=True)
        evals = solve[2].to(torch.int64) + 1
        out.update(bound(n_bytes + lanes * (4 * (3 + 3 + 2 + 9) + 8
                                            + 4 * (3 + 1 + 1) + 1),
                         int((evals * lane_pairs).sum())))
        cluster, resident = cuda_kernels._link_cluster(
            lib, dev, src_b.mask.shape[-1], 0)
        out["timed_lane_trials"] = solve[2].tolist()
        out["timed_blocks"] = cluster
        out["timed_clusters"] = min(lanes, resident)
        print(f"    {name}, {out['timed_lanes']} lanes: "
              f"{int(evals.sum())} evaluations; bound "
              f"{out['bound_ms'] * 1e3:.4f} us ({out['bound_by']}); "
              f"{cluster} blocks a lane on {out['timed_clusters']} "
              f"clusters; trials a lane {out['timed_lane_trials']}")
        t = time_turns(lambda: links_mod.refine_links_d2d(*args, **kwargs),
                       lambda: per_trial_refine(*args, **kwargs), 20, 3,
                       label="per-trial lockstep")
        out.update(t)
        # The solve alone (one launch), without refine_links_d2d's
        # covariances (d2d.cov_from_hessian, eager) and poses.
        zero = torch.zeros((lanes, 3), device=dev)
        out["solve_ms"] = device_ms(lambda: cuda_kernels.newton_solve_batch(
            zero, *sargs, with_hessian=True), 20, launches=1)
        print(f"    {name}, {out['timed_lanes']} lanes: refine_links_d2d "
              f"{t['ms'] * 1e3:.1f} us device / {t['events_ms'] * 1e3:.1f} "
              f"us with the host, of which the newton_solve_batch launch "
              f"{out['solve_ms'] * 1e3:.1f} us; per-trial lockstep "
              f"{t['plain_ms'] * 1e3:.1f} / {t['plain_events_ms'] * 1e3:.1f}")
    return out


def registration_inputs(sp, slam, dev):
    """Phase 3c's match_d2d case (the last frozen node against the final
    submap) from the main path's graph: (tgt, cells, T_init), the node's
    frame in the final submap's frame from the graph."""
    base = slam.state.base
    tgt = d2d.PackedTarget(origin=base.grid.origin, packed=base.packed)
    node = slam.nodes[-1]
    T = lambda x: torch.as_tensor(x, dtype=torch.float32,  # noqa: E731
                                  device=dev)
    T_init = se2.sub(T(slam.current_T), T(slam.node_T[-1]))
    cells = CellList(*(x.contiguous() for x in (
        node.cells.means, node.cells.covs, node.cells.mask)))
    return tgt, cells, T_init


def p2d_inputs(sp, fx, io_fx, dev):
    """Phase 13a's P2D case: (target, scan 20's points, mask, T_init)."""
    p = sp.fuser
    T = lambda x, dt=torch.float32: torch.as_tensor(x, dtype=dt, device=dev)
    r, h = T(fx["ranges"]), T(fx["hit"], torch.bool)
    pts0, m0 = dataset.scan_to_points(r[0], h[0])
    pts1, m1 = dataset.scan_to_points(r[P2D_SOURCE], h[P2D_SOURCE])
    zero2 = torch.zeros(2, device=dev)
    tgt = d2d.make_dense_target(
        ndt_map.build_from_scan(p.ndt, zero2, zero2, pts0, m0), p.ndt)
    return tgt, pts1, m1, T(io_fx["p2d_T_init"])


def per_trial_match(packed, origin, h, w, res, src, T_init, m, guard,
                    d0=None):
    """A plain registration as the port ran it before it was one launch:
    d2d.newton_match over one `fgh_dense_flat` launch a trial, from the
    increment d0 (default zero).  Returns (T, score, trials,
    converged)."""
    d0 = torch.zeros(3, device=T_init.device) if d0 is None else d0
    d, f, itr, conv = d2d.newton_match(
        lambda d: cuda_kernels.fgh_dense_flat(
            d, T_init, src, packed, origin, h, w, res, m.n_neighbours,
            m.lfd1, m.lfd2), d0, m, guard)
    return se2.compose(d, T_init), f, itr, conv


def match_case(name, one, per, times=True):
    """Phase 17b: a registration in one launch (`one`, returning a
    NewtonResult) against its per-trial loop (`per(d0=None)`, returning
    (T, score, trials, converged)), with one `newton_solve` launch: the
    pose within MATCH_ONE_TOL of the per-trial loop's and the same
    trials and convergence; or, where the per-trial loop itself is
    unsteady — its pose moves beyond MATCH_ONE_TOL, or its trial count
    changes, when its start moves by SOLVE_EPS in each of four sign
    patterns (its LM stop test fires at rounding noise) — the pose
    within twice that spread (at least MATCH_ONE_TOL) and the trials
    within the counts it took.  Times in turns."""
    cuda_kernels.reset_launch_counts()
    got = one()
    launches = dict(cuda_kernels.LAUNCHES)
    ref = per()
    dev_ = torch.device("cuda", 0) if got.T.is_cuda else got.T.device
    xy, th = max_dev(got.T.cpu().numpy()[None], ref[0].cpu().numpy()[None])
    out = {"trials": int(got.iterations), "per_trial_trials": int(ref[2]),
           "dev_m": xy, "dev_rad": th}
    print(f"  {name}: one launch {int(got.iterations)} trials (per-trial "
          f"{int(ref[2])}), converged {bool(got.converged)} "
          f"({bool(ref[3])}), pose {xy:.2e} m / {th:.2e} rad from the "
          f"per-trial loop's; launches {launches}")
    check(launches["newton_solve"] == 1 and sum(launches.values()) == 1,
          f"{name}: not one newton_solve launch")
    steady = (max(xy, th) <= MATCH_ONE_TOL
              and int(got.iterations) == int(ref[2]))
    if not steady:
        eps = torch.tensor([[1, 1, 1], [-1, -1, -1], [1, -1, 1],
                            [-1, 1, -1]], dtype=torch.float32,
                           device=dev_) * SOLVE_EPS
        moved = [per(e) for e in eps]
        spread = max(max(max_dev(r[0].cpu().numpy()[None],
                                 ref[0].cpu().numpy()[None]))
                     for r in moved)
        trials = sorted({int(r[2]) for r in moved} | {int(ref[2])})
        out.update(per_trial_spread=spread, per_trial_trials_moved=trials)
        print(f"    the per-trial loop from starts moved by {SOLVE_EPS:g}: "
              f"pose within {spread:.2e}, trials {trials}")
        check(max(xy, th) <= max(MATCH_ONE_TOL, 2 * spread)
              and trials[0] <= int(got.iterations) <= trials[-1]
              and (spread > MATCH_ONE_TOL or len(trials) > 1),
              f"{name}: the one-launch registration departs from its "
              "per-trial loop beyond the loop's own spread")
    check(bool(got.converged) == bool(ref[3]),
          f"{name}: converged differs from the per-trial loop")
    if times:
        out.update(time_turns(one, per, 20, 5, label="per-trial loop"))
    return out


def solve_bound(name, res, src, packed, origin, h, w, resol, m):
    """The bound of one registration's `newton_solve` launch
    (`res`: its MatchResult): the distinct table rows its windows touch
    at the result and its source cells read once, its scalars; and
    FLOPS_PER_PAIR for each valid pair at the result, in each of its
    trials + 1 evaluations."""
    zero = torch.zeros(3, device=res.T.device)
    n_bytes, pairs = window_work(zero, res.T, src, packed, origin, None, h,
                                 w, resol, m.n_neighbours)
    evals = int(res.iterations) + 1
    out = bound(n_bytes + 4 * (3 + 3 + 2) + 4 * (3 + 1 + 1) + 1,
                evals * pairs)
    print(f"    {name}: {evals} evaluations of {pairs} valid pairs; bound "
          f"{out['bound_ms'] * 1e3:.4f} us ({out['bound_by']})")
    return out


def one_launch_phase(sp, slam, fx, io_fx, dev):
    """Phase 17: (a) link refinement in one `newton_solve_batch` launch
    against the per-trial lockstep on the recorded refinements of
    phases 5, 9e and 6; (b) match_d2d (phase 3c's case) and match_p2d
    (phase 13a's, with the guarded projection in the kernel) in one
    `newton_solve` launch against their per-trial loops, P2D against
    JAX's pose and from the record's eight perturbed starts."""
    out = {}
    print("phase 17a: link refinement in one launch against the per-trial "
          "lockstep")
    for path in ("offline", "grouped", "online"):
        out[path] = refinement_case(path, REFINEMENTS[path], dev)
    print("phase 17b: match_d2d and P2D in one launch against their "
          "per-trial loops")
    p = sp.fuser
    m = p.matcher
    tgt, cells, T_init = registration_inputs(sp, slam, dev)
    args = (tgt.packed, tgt.origin, p.ndt.grid_h, p.ndt.grid_w,
            p.ndt.resolution)
    out["match_d2d"] = match_case(
        "match_d2d", lambda: d2d.match_d2d(tgt, cells, T_init, p.ndt, m),
        lambda d0=None: per_trial_match(*args, cells, T_init, m, False, d0))
    out["match_d2d"].update(solve_bound(
        "match_d2d", d2d.match_d2d(tgt, cells, T_init, p.ndt, m), cells,
        *args, m))
    ptgt, pts, mask, T0 = p2d_inputs(sp, fx, io_fx, dev)
    src = pairwise.points_as_cells(pts, mask)
    hh, ww = ptgt.valid.shape
    pargs = (ptgt.packed, ptgt.origin, hh, ww, p.ndt.resolution)
    lib = cuda_kernels.build()
    n_src = src.mask.shape[0]
    cluster = cuda_kernels._solve_cluster(lib, dev, 1, n_src, 0)
    print(f"  P2D: {n_src} point-cells, {cluster} blocks, "
          f"{lib.ndtg_solve_smem(n_src, 0, cluster)} bytes of dynamic "
          "shared memory a block")
    out["p2d"] = match_case(
        "match_p2d", lambda: pairwise.match_p2d(ptgt, pts, mask, T0, p.ndt,
                                                m),
        lambda d0=None: per_trial_match(*pargs, src, T0, m, True, d0))
    out["p2d"].update(solve_bound(
        "match_p2d", pairwise.match_p2d(ptgt, pts, mask, T0, p.ndt, m), src,
        *pargs, m))
    runs = []
    for e in (0.0,) + P2D_EPS:
        cuda_kernels.reset_launch_counts()
        res = pairwise.match_p2d(ptgt, pts, mask, T0 + e, p.ndt, m)
        runs.append((e, int(res.iterations), bool(res.converged),
                     max_dev(res.T.cpu().numpy()[None],
                             io_fx["p2d_T"][None])[0],
                     dict(cuda_kernels.LAUNCHES)["newton_solve"]))
    print("  P2D from the record's start + e: " + "; ".join(
        f"e={e:+.0e}: {tr} trials, converged {c}, {xy * 1e3:.4f} mm from "
        f"JAX's pose" for e, tr, c, xy, _ in runs))
    check(all(c and n == 1 for _, _, c, _, n in runs),
          "P2D does not converge in one launch from every perturbed start")
    check(runs[0][3] <= P2D_JAX_TOL,
          "P2D departs from JAX's pose beyond 0.01 mm")
    out["p2d"]["runs"] = [{"e": e, "trials": tr, "converged": c,
                           "dev_jax_m": xy} for e, tr, c, xy, _ in runs]
    return out


# Phase 3f: the feature front end's kernels (csrc/features.cu) against
# their plain twins.
FEATURES_SOURCE = "ndt_feature_graph_tpu_torch/csrc/features.cu"
# The reference's functions, which it leaves to XLA (no TPU kernel).
FEATURE_REPLACES = {
    "detect_features": "ndt_feature_graph_tpu/features/detector.py:50",
    "describe_features": "ndt_feature_graph_tpu/features/descriptor.py:24",
    "match_features": "ndt_feature_graph_tpu/features/ransac.py:67",
}
FEATURE_ENTRIES = tuple(FEATURE_REPLACES)
FEATURE_ULPS = 4              # a differing discrete choice's margin
F64_FLOP_PER_S = 34e12        # H100 SXM data sheet, float64 outside MMA


def feature_rows(fs, idx):
    """The FeatureSet's rows `idx` (an index or a slice of the batch)."""
    return detector.FeatureSet(**{f.name: getattr(fs, f.name)[idx]
                                  for f in dataclasses.fields(fs)})


def ulps(a, b):
    """|a - b| in float32 units in the last place of the larger."""
    a, b = np.float32(a), np.float32(b)
    return float(abs(np.float64(a) - np.float64(b))
                 / np.spacing(max(abs(a), abs(b), np.float32(1e-30))))


def compare_detect(name, got, want):
    """The kernel's FeatureSet against the twin's: the selected beams
    (their points' bits), masks and scales equal, or else each differing
    slot named with the twin's own margin (the gap between its response
    and its neighbour's in the twin's order, in ulps), which must be
    within FEATURE_ULPS; points and angles within 2e-5, responses rtol
    1e-4.  Returns (summary, max abs error)."""
    g = {f.name: getattr(got, f.name).cpu() for f in dataclasses.fields(got)}
    w = {f.name: getattr(want, f.name).cpu()
         for f in dataclasses.fields(want)}
    slot_diff = ((g["pts"] != w["pts"]).any(-1) | (g["mask"] != w["mask"])
                 | (g["scales"] != w["scales"]))
    named = []
    for idx in torch.nonzero(slot_diff).tolist():
        *scan, s = idx
        resp = w["response"][tuple(scan)]
        gaps = [ulps(resp[s], resp[k]) for k in (s - 1, s + 1)
                if 0 <= k < resp.shape[-1]]
        named.append({"scan": scan, "slot": s, "margin_ulps": min(gaps)})
    m = w["mask"] & g["mask"]
    err_pts = float((g["pts"] - w["pts"]).abs()[m].max()) if m.any() else 0.0
    err_ang = float((g["angles"] - w["angles"]).abs()[m].max()) \
        if m.any() else 0.0
    rel = ((g["response"] - w["response"]).abs()
           / w["response"].abs().clamp(min=1e-6))
    err_resp = float(rel.max())
    bits = {k: int((g[k] != w[k]).sum()) for k in g}
    print(f"    {name}: {int(slot_diff.sum())} slots differ in beam, mask or "
          f"scale {named[:4]}; points within {err_pts:.2e}, angles "
          f"{err_ang:.2e}, responses rtol {err_resp:.2e}; entries off the "
          f"twin's bits {bits}")
    check(all(d["margin_ulps"] <= FEATURE_ULPS for d in named),
          f"{name}: a selection differs from the twin's beyond "
          f"{FEATURE_ULPS} ulps: {named[:8]}")
    check(err_pts <= 2e-5 and err_ang <= 2e-5 and err_resp <= 1e-4,
          f"{name}: points / angles / responses beyond 2e-5 / 2e-5 / rtol "
          "1e-4 of the twin's")
    return ({"slots_differing": named, "pts_err": err_pts,
             "angle_err": err_ang, "response_rtol": err_resp,
             "entries_off_bits": bits},
            max(err_pts, err_ang, float((g["response"] - w["response"])
                                        .abs().max())))


def compare_desc(name, got, want):
    """Descriptors within rtol 1e-5 / atol 1e-6 of the twin's."""
    g, w = got.cpu(), want.cpu()
    err = float((g - w).abs().max())
    ok = bool(((g - w).abs() <= 1e-6 + 1e-5 * w.abs()).all())
    off = int((g != w).sum())
    print(f"    {name}: max |diff| {err:.2e}, {off} of {w.numel()} entries "
          "off the twin's bits")
    check(ok, f"{name}: beyond rtol 1e-5 / atol 1e-6 of the twin's")
    return {"max_abs_err": err, "entries_off_bits": off}, err


def match_margins(fp, ref, ref_desc, mov, mov_desc, want, pairs, kind):
    """The twin's own margin (ulps) at each differing pair: for the
    correspondences the least gap between two candidate distances of the
    pair (a column's two nearest, two moving features' nearest), for the
    inliers the least |r2 - acceptance| under the twin's pose."""
    out = []
    for p in pairs:
        if kind == "corr":
            d = features_distance.symmetric_chi2_matrix(ref_desc[p],
                                                        mov_desc[p])
            good = ref.mask[p][:, None] & mov.mask[p][None, :]
            d = torch.where(good, d, math.inf).cpu().numpy()
            col = np.sort(d, 0)
            best = np.sort(col[0][np.isfinite(col[0])])
            gaps = [ulps(a, b) for a, b in zip(best[:-1], best[1:])]
            gaps += [ulps(col[0, j], col[1, j]) for j in range(d.shape[1])
                     if np.isfinite(col[1, j])]
        else:
            a = ref.pts[p][want.corr_ref[p]]
            b = mov.pts[p][want.corr_mov[p]]
            r2 = ((a - ransac._apply(want.T[p][None], b)) ** 2).sum(-1)
            gaps = [ulps(x, fp.ransac_acceptance) for x in r2.cpu().numpy()]
        out.append({"pair": int(p), "margin_ulps": min(gaps)})
    return out


def compare_match(name, fp, got, want, inputs):
    """The kernel's MatchResult against the twin's on the same inputs:
    correspondences, masks, inliers, counts and validity equal (or each
    differing pair named with the twin's own margin, within
    FEATURE_ULPS); T within 1e-5, the score rtol 1e-5.  Returns
    (summary, max abs error)."""
    disc = ("corr_ref", "corr_mov", "corr_mask", "inlier_mask",
            "num_inliers", "valid")
    diff = {}
    for k in disc:
        d = getattr(got, k) != getattr(want, k)
        diff[k] = (d.reshape(d.shape[0], -1).any(-1) if d.dim() > 1
                   else d.reshape(-1))
    corr = diff["corr_ref"] | diff["corr_mov"] | diff["corr_mask"]
    inl = (diff["inlier_mask"] | diff["num_inliers"] | diff["valid"]) & ~corr
    named = (match_margins(fp, *inputs, want, torch.nonzero(corr).flatten()
                           .tolist(), "corr")
             + match_margins(fp, *inputs, want, torch.nonzero(inl).flatten()
                             .tolist(), "inliers"))
    err_T = float((got.T - want.T).abs().max())
    rel = float(((got.score - want.score).abs()
                 / want.score.abs().clamp(min=1e-6)).max())
    bits = {k: int((getattr(got, k) != getattr(want, k)).sum())
            for k in ("T", "score", *disc)}
    print(f"    {name}: {int(corr.sum())} pairs differ in correspondences, "
          f"{int(inl.sum())} in inliers {named[:4]}; T within {err_T:.2e}, "
          f"score rtol {rel:.2e}; entries off the twin's bits {bits}")
    check(all(d["margin_ulps"] <= FEATURE_ULPS for d in named),
          f"{name}: a discrete choice differs from the twin's beyond "
          f"{FEATURE_ULPS} ulps: {named[:8]}")
    check(err_T <= 1e-5 and rel <= 1e-5,
          f"{name}: T / score beyond 1e-5 / rtol 1e-5 of the twin's")
    return ({"pairs_differing": named, "T_err": err_T, "score_rtol": rel,
             "entries_off_bits": bits},
            max(err_T, float((got.score - want.score).abs().max())))


def prepare_plain(state, params, Tmotion, ranges, hit, u):
    """feature_fuser._prepare_features through the plain twins (the
    parent's path): (feats, desc, res, src, tgt)."""
    fp = params.features
    feats = detector._detect_plain(fp, ranges, hit)
    desc = descriptor._describe_plain(fp, feats, ranges, hit)
    res = ransac._match_sets_plain(fp, state.prev_feats, state.prev_desc,
                                   feats, desc, u)
    gate = fuser_gate(state, params, Tmotion)
    return (feats, desc, res, *ransac._gate_plain(res, state.prev_feats,
                                                  feats, gate))


def fuser_gate(state, params, Tmotion):
    return ransac.OdometryGate(
        sensor_pose=state.base.sensor_pose, motion=Tmotion,
        prev_pose=state.prev_pose,
        max_translation=params.max_translation_norm / 10.0,
        max_rotation=params.max_rotation_norm / 4.0,
        check=params.check_consistency, cov_xy=params.feature_cov_xy)


def compare_gate(name, got, want):
    """The gate's pseudo-cells against the twin's: masks equal, means
    within 1e-5, covariances equal."""
    (gs, gt), (ws, wt) = got, want
    err = max(float((gs.means - ws.means).abs().max()),
              float((gt.means - wt.means).abs().max()))
    off = int((gs.means != ws.means).sum() + (gt.means != wt.means).sum())
    masks = int((gs.mask != ws.mask).sum())
    print(f"    {name}: pair masks differ at {masks}, {int(ws.mask.sum())} "
          f"kept; means within {err:.2e} ({off} entries off the twin's "
          "bits)")
    check(masks == 0 and torch.equal(gs.covs, ws.covs) and err <= 1e-5,
          f"{name}: the pseudo-cells differ from the twin's")
    return {"mask_differ": masks, "means_err": err, "entries_off_bits": off}


def window_entries(fp, ranges, hit):
    """The detector's (beam, window beam) pairs on one polyline piece of
    hit beams, summed over the scans: its exps and float64 sums."""
    b, half = fp.num_beams, fp.smooth_half_beams
    jump = (ranges - torch.roll(ranges, 1, -1)).abs() > 0.5
    jump[..., 0] = False
    jump = jump | ~hit | ~torch.roll(hit, 1, -1)
    sid = torch.cumsum(jump.to(torch.int32), -1)
    ar = torch.arange(b, device=ranges.device)
    nidx = (ar[:, None] + torch.arange(-half, half + 1, device=ranges.device)
            ).clamp(0, b - 1)
    return int(((sid[..., nidx] == sid[..., None]) & hit[..., nidx]).sum())


def detect_bound(fp, ranges, hit):
    """The detector's least time on the card for these scans: per window
    entry and scale an exp and three float32 products (f32) and three
    float64 fused multiply-adds; per (scale, beam) ~40 float32 operations
    (two searches, the turning angle, the peak test); the bytes of the
    scans, the beam directions and the outputs."""
    n = ranges.numel() // fp.num_beams
    e = window_entries(fp, ranges, hit)
    s = fp.num_scales
    t_ops = (e * s * 4 + n * s * fp.num_beams * 40) / F32_FLOP_PER_S \
        + e * s * 6 / F64_FLOP_PER_S
    n_bytes = n * fp.num_beams * 5 + fp.num_beams * 8 \
        + n * fp.max_features * 21
    t_bytes = n_bytes / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "window_entries": e}


def describe_bound(fp, feats, ranges, hit):
    """The descriptor's: per valid feature, ~25 operations a hit beam
    (its rotation, radius, angle, bin) and ~20 a beam (its chord), ~25 a
    chord sample; the bytes of the scans, features and descriptors."""
    valid = int(feats.mask.sum())
    hits = int((feats.mask[..., None] & hit[..., None, :]).sum())
    beams = valid * fp.num_beams
    ops = hits * 25 + beams * 20 + beams * 8 * 25
    n_f = feats.mask.numel()
    n = ranges.numel() // fp.num_beams
    n_bytes = n * fp.num_beams * 5 + n_f * 17 + n_f * fp.rho_bins \
        * fp.phi_bins * 4
    t_ops, t_bytes = ops / F32_FLOP_PER_S, n_bytes / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes}


def match_bound(fp, n_pairs, f1, f2, d, gate=False):
    """The matcher's: per pair ~6 operations a descriptor entry of the
    chi2 matrix, ~14 a hypothesis residual; the bytes of the two sets,
    the draws and the result (and the pseudo-cells)."""
    c, m = fp.max_correspondences, fp.ransac_hypotheses
    ops = n_pairs * (f1 * f2 * d * 6 + m * c * 14)
    n_bytes = n_pairs * ((f1 + f2) * (d * 4 + 9) + m * 8 + c * 18 + 21
                         + (c * 33 + 36 if gate else 0))
    t_ops, t_bytes = ops / F32_FLOP_PER_S, n_bytes / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes}


def rounding_probe(dev):
    """How ATen rounds on the card what the feature kernels mirror: the
    count of 2^17 values where a pair's vector_norm differs from each
    candidate formula, and of 2^20 where ATen's exp, cos, sin, atan2 and
    log1p differ from the CUDA library's functions in the kernels'
    library (ndtg_features_math_probe)."""
    rng = np.random.default_rng(0)
    d = rng.standard_normal((1 << 17, 2)).astype(np.float32)
    card = torch.linalg.vector_norm(torch.as_tensor(d, device=dev),
                                    dim=-1).cpu().numpy()
    x, y = d[:, 0], d[:, 1]
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    f32 = lambda v: np.sqrt(v.astype(np.float32))  # noqa: E731
    out = {"vector_norm": {
        "sqrt(fma(y, y, x * x))": int((f32((x * x).astype(np.float64)
                                           + y64 * y64) != card).sum()),
        "sqrt(fma(x, x, y * y))": int((f32((y * y).astype(np.float64)
                                           + x64 * x64) != card).sum()),
        "sqrt(x * x + y * y)": int((np.sqrt(x * x + y * y) != card).sum())}}
    lib = cuda_kernels.build()
    n = 1 << 20
    a = torch.as_tensor((rng.standard_normal(n) * 3).astype(np.float32),
                        device=dev)
    b = torch.as_tensor((rng.standard_normal(n) * 3).astype(np.float32),
                        device=dev)
    tails = -torch.as_tensor(rng.uniform(0, 110, n).astype(np.float32),
                             device=dev)      # the window's exp arguments
    lp = -torch.as_tensor(rng.uniform(0, 0.99, n).astype(np.float32),
                          device=dev)
    for name, f, x_, aten in (("exp", 0, tails, torch.exp(tails)),
                              ("cos", 1, a, torch.cos(a)),
                              ("sin", 2, a, torch.sin(a)),
                              ("atan2", 3, a, torch.atan2(a, b)),
                              ("log1p", 4, lp, torch.log1p(lp))):
        got = torch.empty_like(x_)
        with torch.cuda.device(dev):
            err = lib.ndtg_features_math_probe(
                x_.data_ptr(), b.data_ptr(), got.data_ptr(), n, f,
                torch.cuda.current_stream(dev).cuda_stream)
        check(err == 0, f"the maths probe did not launch: {err}")
        out[name] = int((got != aten).sum())
    return out


def feature_phase(sp, fx, lc, fl, dev):
    """Phase 3f (see the module docstring).  Returns (summary, {entry:
    kernels-line fields})."""
    fp = sp.fuser.features
    T = lambda x, dt=torch.float32: torch.as_tensor(  # noqa: E731
        x, dtype=dt, device=dev)
    R, H, U = T(fx["ranges"]), T(fx["hit"], torch.bool), T(fx["ransac_u"])
    n = R.shape[0]
    out, err = {}, {k: 0.0 for k in FEATURE_ENTRIES}
    if dev.type == "cuda":
        out["rounding_probe"] = rounding_probe(dev)
        print(f"    ATen on the card: a pair's vector_norm off each formula, "
              f"and its exp, cos, sin, atan2, log1p off the kernels' CUDA "
              f"library functions: {out['rounding_probe']}")
    before = dict(cuda_kernels.LAUNCHES)

    def keep(entry, res):
        err[entry] = max(err[entry], res[1])
        return res[0]

    # Detect and describe: the 200 scans as one batch and one by one.
    fk = detector.detect(fp, R, H)
    ft = detector._detect_plain(fp, R, H)
    out["detect_batch"] = keep("detect_features", compare_detect(
        f"detect, {n} scans in one call", fk, ft))
    if dev.type == "cuda":
        _, arcs, smoothed = cuda_kernels.detect_features(fp, R, H,
                                                         intermediates=True)
        _, arc_t, _, sms_t = detector._smoothing_plain(fp, R, H)
        sm_t = torch.stack(sms_t, -3)
        out["detect_intermediates"] = {
            "arc_entries_off_bits": int((arcs != arc_t).sum()),
            "smoothed_entries_off_bits": int((smoothed != sm_t).sum()),
            "smoothed_max_abs_diff": float((smoothed - sm_t).abs().max())}
        print(f"    the kernel's cumulative arc and smoothed points against "
              f"the twin's: {out['detect_intermediates']} of {arcs.numel()} "
              f"and {smoothed.numel()}")
    one_k = [detector.detect(fp, R[i], H[i]) for i in range(n)]
    one_t = [detector._detect_plain(fp, R[i], H[i]) for i in range(n)]
    stack = lambda sets: detector.FeatureSet(**{  # noqa: E731
        f.name: torch.stack([getattr(s, f.name) for s in sets])
        for f in dataclasses.fields(detector.FeatureSet)})
    out["detect_per_scan"] = keep("detect_features", compare_detect(
        "detect, scan by scan", stack(one_k), stack(one_t)))
    same = all(torch.equal(getattr(stack(one_k), f.name),
                           getattr(fk, f.name))
               for f in dataclasses.fields(fk))
    print(f"    the kernel's scan alone = its row of the batch: {same}")
    check(same, "detect: a scan's bits depend on its batch")
    if dev.type == "cuda":
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        sizes = {}
        for m in (1, 32, 64, 100, n):
            parts = [cuda_kernels.detect_features(fp, R[i:i + m], H[i:i + m],
                                                  intermediates=True)
                     for i in range(0, n, m)]
            rows = all(torch.equal(torch.cat([getattr(p[0], f.name)
                                              for p in parts]),
                                   getattr(fk, f.name))
                       for f in dataclasses.fields(fk))
            inter = (torch.equal(torch.cat([p[1] for p in parts]), arcs)
                     and torch.equal(torch.cat([p[2] for p in parts]),
                                     smoothed))
            sizes[m] = {"cluster": cuda_kernels.detect_cluster(m, sms),
                        "rows_equal": rows, "intermediates_equal": inter}
        print(f"    detect at every cluster size (scans a call: blocks a "
              f"scan, each scan and its arc and smoothed points equal to "
              f"its row): {sizes}")
        check(all(v["rows_equal"] and v["intermediates_equal"]
                  for v in sizes.values()),
              "detect: a scan's bits depend on the cluster size")
        out["detect_cluster_sizes"] = sizes
    dk = descriptor.describe(fp, ft, R, H)
    dt = descriptor._describe_plain(fp, ft, R, H)
    out["describe_batch"] = keep("describe_features", compare_desc(
        f"describe, {n} scans' twin features in one call", dk, dt))
    dk1 = torch.stack([descriptor.describe(fp, feature_rows(ft, i), R[i],
                                           H[i]) for i in range(n)])
    dt1 = torch.stack([descriptor._describe_plain(fp, feature_rows(ft, i),
                                                  R[i], H[i])
                       for i in range(n)])
    out["describe_per_scan"] = keep("describe_features", compare_desc(
        "describe, scan by scan", dk1, dt1))
    check(torch.equal(dk1, dk), "describe: a scan's bits depend on its "
                                "batch")
    hm = dataclasses.replace(fp, descriptor_stat="hitmiss")
    out["describe_hitmiss"] = keep("describe_features", compare_desc(
        "describe, hitmiss statistic", descriptor.describe(hm, ft, R, H),
        descriptor._describe_plain(hm, ft, R, H)))
    out["describe_end_to_end"] = keep("describe_features", compare_desc(
        "describe of the kernel's own features", descriptor.describe(
            fp, fk, R, H), dt))
    if dev.type == "cuda":
        out["describe_block_sizes"] = describe_size_checks(fp, hm, ft, R, H,
                                                           dk, dk1)
        out["describe_first_design"] = describe_first_design_checks(dev)

    # Match: the 199 consecutive pairs with the fixture's draws, then the
    # 171 candidate pairs of phase 9e's bank, on the twin's sets.
    ref, mov = feature_rows(ft, slice(0, n - 1)), feature_rows(ft,
                                                               slice(1, n))
    inputs = (ref, dt[:-1], mov, dt[1:])
    mk = ransac.match_sets(fp, *inputs, U)
    mt = ransac._match_sets_plain(fp, *inputs, U)
    out["match_consecutive"] = keep("match_features", compare_match(
        f"match, {n - 1} consecutive pairs", fp, mk, mt, inputs))
    m1 = [ransac.match_sets(fp, feature_rows(ft, i), dt[i],
                            feature_rows(ft, i + 1), dt[i + 1], U[i])
          for i in range(n - 1)]
    same = all(torch.equal(getattr(r, f.name), getattr(mk, f.name)[i])
               for i, r in enumerate(m1)
               for f in dataclasses.fields(ransac.MatchResult))
    print(f"    a pair alone = its row of the batch: {same}")
    check(same, "match: a pair's bits depend on its batch")
    if dev.type == "cuda":
        sizes = {}
        for m in (1, 20, 40, n - 1):
            parts = [ransac.match_sets(
                fp, feature_rows(ft, slice(i, min(i + m, n - 1))),
                dt[i:min(i + m, n - 1)],
                feature_rows(ft, slice(i + 1, min(i + m, n - 1) + 1)),
                dt[i + 1:min(i + m, n - 1) + 1], U[i:min(i + m, n - 1)])
                for i in range(0, n - 1, m)]
            sizes[m] = {
                "cluster": cuda_kernels.match_cluster(m, sms),
                "rows_equal": all(
                    torch.equal(torch.cat([getattr(p, f.name)
                                           for p in parts]),
                                getattr(mk, f.name))
                    for f in dataclasses.fields(ransac.MatchResult))}
        print(f"    match at every cluster size (pairs a call: blocks a "
              f"pair, each pair equal to its row): {sizes}")
        check(all(v["rows_equal"] for v in sizes.values()),
              "match: a pair's bits depend on the cluster size")
        out["match_cluster_sizes"] = sizes
    ap = dataclasses.replace(fp, ransac_adaptive=True)
    out["match_adaptive"] = keep("match_features", compare_match(
        "match, the adaptive budget", ap, ransac.match_sets(ap, *inputs, U),
        ransac._match_sets_plain(ap, *inputs, U), inputs))
    lsp, _, bank, ref_i, mov_i, lu = link_bank(lc, dev)
    lfp = lsp.fuser.features
    lin = (feature_rows(bank.feats, ref_i), bank.desc[ref_i],
           feature_rows(bank.feats, mov_i), bank.desc[mov_i])
    lk = ransac.match_sets(lfp, *lin, lu)
    out["match_lc_bank"] = keep("match_features", compare_match(
        f"match, {ref_i.shape[0]} candidate pairs of the LC bank "
        f"({lin[0].mask.shape[-1]} features a node)", lfp, lk,
        ransac._match_sets_plain(lfp, *lin, lu), lin))
    if dev.type == "cuda":
        one = [ransac.match_sets(lfp, *[
            feature_rows(x, slice(i, i + 1)) if isinstance(
                x, detector.FeatureSet) else x[i:i + 1] for x in lin],
            lu[i:i + 1]) for i in range(ref_i.shape[0])]
        lc_sizes = {
            "batch_cluster": cuda_kernels.match_cluster(ref_i.shape[0], sms),
            "alone_cluster": cuda_kernels.match_cluster(1, sms),
            "rows_equal": all(
                torch.equal(torch.cat([getattr(o, k.name) for o in one]),
                            getattr(lk, k.name))
                for k in dataclasses.fields(ransac.MatchResult))}
        print(f"    the LC bank pair by pair against its batch: {lc_sizes}")
        check(lc_sizes["rows_equal"],
              "match: an LC pair's bits depend on the cluster size")
        out["match_cluster_sizes"]["lc_bank"] = lc_sizes

    # The main path's gated call on each consecutive pair, and a B = 64
    # fleet step through feature_fuser._prepare_features.
    prev = T(fx["traj"][:-1])
    motion = se2.sub(prev, T(fx["traj"][1:]))
    gate = ransac.OdometryGate(
        sensor_pose=torch.zeros(3, device=dev), motion=motion,
        prev_pose=prev, max_translation=sp.fuser.max_translation_norm / 10,
        max_rotation=sp.fuser.max_rotation_norm / 4,
        check=sp.fuser.check_consistency, cov_xy=sp.fuser.feature_cov_xy)
    gk = ransac.match_sets_gated(fp, *inputs, U, gate)
    out["gate_consecutive"] = compare_gate(
        f"gate, {n - 1} consecutive pairs", gk[1:], ransac._gate_plain(
            mt, ref, mov, gate))
    fleet_fp = presets.fleet_serving()
    seq = sequence(fl, dev)
    states, odom, fr, fh = scaling.build_fleet_feature_inputs(fleet_fp, seq,
                                                              64)
    fu = T(np.resize(fl["ransac_u"], (64,) + fl["ransac_u"].shape[1:])
           [:, 0])
    step = (states, fleet_fp, odom[:, 0], fr[:, 0], fh[:, 0], fu)
    got = feature_fuser._prepare_features(*step)
    want = prepare_plain(*step)
    out["fleet_b64"] = {
        "detect": keep("detect_features", compare_detect(
            "B = 64 fleet step: detect", got[2], want[0]))}
    out["fleet_b64"]["describe"] = keep("describe_features", compare_desc(
        "B = 64 fleet step: describe", got[3], want[1]))
    out["fleet_b64"]["match"] = keep("match_features", compare_match(
        "B = 64 fleet step: match", fleet_fp.features, got[6], want[2],
        (states.prev_feats, states.prev_desc, want[0], want[1])))
    out["fleet_b64"]["gate"] = compare_gate(
        "B = 64 fleet step: gate", got[4:6], want[3:5])
    again = feature_fuser._prepare_features(*step)
    rep = all(torch.equal(a, b) for x, y in zip(got[2:], again[2:])
              for a, b in zip(_leaves(x), _leaves(y)))
    print(f"    a second call repeats the first's bits: {rep}")
    check(rep, "the feature kernels do not repeat their bits")
    out["repeat_bits"] = rep
    launched = {k: cuda_kernels.LAUNCHES[k] - before[k]
                for k in FEATURE_ENTRIES}
    print(f"    kernel launches of these checks: {launched}")

    # Device time in turns (twin, kernel, kernel, twin) at the main
    # path's shapes (one scan, one gated pair) and batched.
    print("    times at the main path's shapes (one scan; one pair with "
          "the gate):")
    k0 = 5
    one_gate = dataclasses.replace(gate, motion=motion[k0], prev_pose=prev[k0])
    f0, d0 = feature_rows(ft, k0), dt[k0]
    f1, d1 = feature_rows(ft, k0 + 1), dt[k0 + 1]
    cases = {
        "detect_features": (
            lambda: detector.detect(fp, R[k0 + 1], H[k0 + 1]),
            lambda: detector._detect_plain(fp, R[k0 + 1], H[k0 + 1]),
            detect_bound(fp, R[k0 + 1], H[k0 + 1])),
        "describe_features": (
            lambda: descriptor.describe(fp, f1, R[k0 + 1], H[k0 + 1]),
            lambda: descriptor._describe_plain(fp, f1, R[k0 + 1], H[k0 + 1]),
            describe_bound(fp, f1, R[k0 + 1], H[k0 + 1])),
        "match_features": (
            lambda: ransac.match_sets_gated(fp, f0, d0, f1, d1, U[k0],
                                            one_gate),
            lambda: ransac._gate_plain(ransac._match_sets_plain(
                fp, f0, d0, f1, d1, U[k0]), f0, f1, one_gate),
            match_bound(fp, 1, 32, 32, d0.shape[-1], gate=True)),
    }
    lines = {}
    for k, (kern, plain, bnd) in cases.items():
        print(f"    {k}:")
        t = time_turns(kern, plain, label="plain twin", launches=1)
        lines[k] = {"max_abs_err": err[k], **t, **bnd,
                    "path": "the main path's feature front end "
                            "(feature_fuser._prepare_features; "
                            "feature_fuser.initialize)"}
    print(f"    batched ({n} scans; {n - 1} pairs; the LC bank's pairs):")
    batched = {
        "detect_200": (lambda: detector.detect(fp, R, H),
                       lambda: detector._detect_plain(fp, R, H),
                       detect_bound(fp, R, H)),
        "detect_32": (lambda: detector.detect(fp, R[:32], H[:32]),
                      lambda: detector._detect_plain(fp, R[:32], H[:32]),
                      detect_bound(fp, R[:32], H[:32])),
        "detect_64": (lambda: detector.detect(fp, R[:64], H[:64]),
                      lambda: detector._detect_plain(fp, R[:64], H[:64]),
                      detect_bound(fp, R[:64], H[:64])),
        "describe_200": (lambda: descriptor.describe(fp, ft, R, H),
                         lambda: descriptor._describe_plain(fp, ft, R, H),
                         describe_bound(fp, ft, R, H)),
        "match_199": (lambda: ransac.match_sets(fp, *inputs, U),
                      lambda: ransac._match_sets_plain(fp, *inputs, U),
                      match_bound(fp, n - 1, 32, 32, d0.shape[-1])),
        "match_lc_bank": (
            lambda: ransac.match_sets(lfp, *lin, lu),
            lambda: ransac._match_sets_plain(lfp, *lin, lu),
            match_bound(lfp, ref_i.shape[0], lin[0].mask.shape[-1],
                        lin[2].mask.shape[-1], lin[1].shape[-1])),
    }
    for k, (kern, plain, bnd) in batched.items():
        print(f"    {k}:")
        out[f"time_{k}"] = {**time_turns(kern, plain, reps=20, plain_reps=3,
                                         label="plain twin", launches=1),
                            **bnd}
    out["launches_of_checks"] = launched
    if dev.type == "cuda":
        split = stage_split()
        out["stage_split"] = split
        for k, case in (("detect_features", "detect one scan"),
                        ("describe_features", "describe one scan"),
                        ("match_features", "match one pair with the gate")):
            lines[k]["stages_us"] = split[case]
    return out, lines


DESCRIBE_THREADS = (128, 256, 512, 1024)
# sha256 of the descriptor kernel's output bits of the first design (one
# block of 128 threads a feature, each binning and adding its own beams)
# on examples/describe_bits.py's inputs, on an NVIDIA H100 80GB HBM3: the
# redesign keeps that order of adds, so it must give the same bits.
DESCRIBE_FIRST_DESIGN_SHA256 = {
    "batch": "18d42c750f0fc8db2180c63e133046657f93d24c7839409f2954fcb1"
             "f6f5e19c",
    "per_scan": "18d42c750f0fc8db2180c63e133046657f93d24c7839409f2954fcb1"
                "f6f5e19c",
    "hitmiss": "b90039ef6642cb05e2ebaf164c400809938748feca47f4da4b60a868dce"
               "416f2",
    "fleet_b64": "93d1a2f4770016e76d5d02aab422a7914e0fac3d15ca04130794133540"
                 "b63f29",
}


def describe_size_checks(fp, hm, ft, R, H, dk, dk1):
    """describe_features at every block size (describe_threads forced):
    the 200 scans in one call, scan by scan and the hitmiss statistic,
    each equal to the wrapper's own choice's bits."""
    rule = cuda_kernels.describe_threads
    own_hm = descriptor.describe(hm, ft, R, H)
    out = {}
    for t in DESCRIBE_THREADS:
        cuda_kernels.describe_threads = lambda *_, t=t: t
        try:
            out[t] = bool(
                torch.equal(descriptor.describe(fp, ft, R, H), dk)
                and torch.equal(torch.stack([descriptor.describe(
                    fp, feature_rows(ft, i), R[i], H[i])
                    for i in range(R.shape[0])]), dk1)
                and torch.equal(descriptor.describe(hm, ft, R, H), own_hm))
        finally:
            cuda_kernels.describe_threads = rule
    print(f"    describe at every block size (threads a feature: batch, "
          f"scan by scan and hitmiss equal to the wrapper's own choice, "
          f"{rule(R.shape[0] * ft.mask.shape[-1], cuda_kernels._sm_count(R.device))} "
          f"threads for the batch): {out}")
    check(all(out.values()), "describe: the bits depend on the block size")
    return out


def describe_first_design_checks(dev):
    """The kernel's bits on examples/describe_bits.py's inputs (the 200
    scans batched and scan by scan, hitmiss, a B = 64 fleet step) against
    the first design's recorded sha256: {case: equal}."""
    spec = importlib.util.spec_from_file_location(
        "describe_bits", os.path.join(ROOT, "examples", "describe_bits.py"))
    bits = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bits)
    got = bits.outputs(dev)
    out = {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
           == DESCRIBE_FIRST_DESIGN_SHA256[k] for k, v in got.items()}
    print(f"    describe against the first design's bits (sha256 of "
          f"{ {k: v.size for k, v in got.items()} } entries): {out}")
    check(all(out.values()),
          "describe: the bits are not the first design's")
    return out


def stage_split():
    """The feature kernels' stage split at phase 3f's shapes and the
    occupancy kernel's phases at phase 3e's:
    examples/probe_feature_stages.py --stages and
    examples/probe_occupancy.py --stages, each in a process of its own
    (a probe build of the kernels' library, built once).  {case: {stage:
    mean µs over the blocks}}."""
    out = {}
    for script in ("probe_feature_stages.py", "probe_occupancy.py"):
        proc = subprocess.run(
            [sys.executable, os.path.join(ROOT, "examples", script),
             "--stages"], capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0,
              f"the stage probe failed: {proc.stderr[-2000:]}")
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                rec = json.loads(line)
                name = rec["case"]
                if "phases" in rec:
                    name = f"occupancy {name}"
                    stages = {st["phase"]: st["mean_us"]
                              for st in rec["phases"]}
                else:
                    stages = {st["stage"]: st["mean_us"]
                              for st in rec["stages"]}
                out[name] = stages
                print(f"    stages of {name}, µs (mean over "
                      f"{rec['blocks']} blocks): {stages}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for chip_smoke.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    dev = torch.device("cuda", 0)
    gpu = gpu_line()
    print(f"gpu: {gpu}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    print("phase 2: build")
    t0 = time.perf_counter()
    cuda_kernels.build()
    build_s = time.perf_counter() - t0
    print(f"  built {SOURCE}, {SEGMENT_SOURCE}, {OCCUPANCY_SOURCE}, "
          f"{OVERLAP_SOURCE} and {FEATURES_SOURCE} for sm_90a in "
          f"{build_s:.2f} s")
    for line in cuda_kernels.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    fx = dict(np.load(FIXTURE))
    sp = canonical_slam_params(float(fx["split_m"]), int(fx["max_nodes"]))
    check(repr(sp) == str(fx["params_repr"]),
          "the fixture was made at other parameters than canonical_slam_params")
    print("phase 3: kernels vs plain on the card")
    checks = kernel_checks(sp, fx, dev)
    print("phase 3: newton_solve vs plain and vs the per-trial path on the "
          "card")
    checks["newton_solve"] = solve_checks(sp, fx, dev)
    print("phase 3e: the map update (segment_add_rows, occupancy_update), "
          "card vs CPU and vs the parent's path; float32 sqrt")
    (map_update, checks["segment_add_rows"],
     checks["occupancy_update"]) = map_update_phase(sp, fx, dev)
    lc = dict(np.load(LC_FIXTURE))
    print("phase 3f: the feature front end (detect_features, "
          "describe_features, match_features) vs the plain twins")
    t3f = time.perf_counter()
    features, feature_lines = feature_phase(
        sp, fx, lc, dict(np.load(FLEET_FIXTURE)), dev)
    checks.update(feature_lines)
    checks["occupancy_update"]["stages_us"] = (
        features["stage_split"]["occupancy one scan"])
    features["wall_s"] = time.perf_counter() - t3f
    print(f"  phase 3f took {features['wall_s']:.1f} s")

    print("phase 4: main path, canonical 200-scan fixture")
    cuda_kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught, \
                recorded_solves() as (calls, in_solve), \
                map_updates() as updates:
            warnings.simplefilter("always")
            slam, _ = run_main_path(sp, fx, dev)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches = dict(cuda_kernels.LAUNCHES)
    scans = fx["ranges"].shape[0] - 1
    syncs = _sync_warnings(caught) + in_solve["in_solve"]
    print(f"  launches in the main-path run: {launches} "
          f"({launches['newton_solve'] / scans:.2f} newton_solve per scan: "
          f"one per registration)")
    print(f"  synchronising calls in the main-path run "
          f"(set_sync_debug_mode): {syncs} ({syncs / scans:.2f} a scan), "
          f"{in_solve['in_solve']} of them inside newton_solve")
    print(f"  segment_add_rows launches: {launches['segment_add_rows']} for "
          f"{updates['stats']} statistics updates ("
          f"{launches['segment_add_rows'] / scans:.2f} a scan: the scan's "
          f"cell list, its points; each new node's first scan); "
          f"occupancy_update: {launches['occupancy_update']} for "
          f"{updates['occ']} occupancy updates")
    print(f"  feature kernels: detect_features "
          f"{launches['detect_features']}, describe_features "
          f"{launches['describe_features']}, match_features "
          f"{launches['match_features']} (one each a scan, the first scan's "
          f"detect and describe in initialize)")
    check(launches["newton_solve"] == scans == len(calls),
          "newton_solve was not launched once per registration")
    check_map_launches(launches, updates, "the main path")
    check(launches["detect_features"] == launches["describe_features"]
          == scans + 1 and launches["match_features"] == scans,
          "the feature kernels did not launch once a scan")
    check(all(v == 0 for k, v in launches.items()
              if k not in ("newton_solve", *MAP_ENTRIES, *FEATURE_ENTRIES)),
          "the main path launched another entry than newton_solve, the "
          "map update's segment_add_rows and occupancy_update and the "
          "feature kernels")
    check(in_solve["in_solve"] == 0, "newton_solve synchronised")
    traj = np.stack(slam.trajectory)
    check(traj.shape == fx["traj"].shape and np.isfinite(traj).all(),
          f"trajectory {traj.shape} not finite / not {fx['traj'].shape}")
    n_nodes, n_ref = len(slam.nodes), int(fx["node_T"].shape[0])
    check(n_nodes == n_ref, f"{n_nodes} frozen nodes, JAX froze {n_ref}")
    dev_xy = float(np.abs(traj[:, :2] - fx["traj"][:, :2]).max())
    dth = traj[:, 2] - fx["traj"][:, 2]
    dev_th = float(np.abs(np.arctan2(np.sin(dth), np.cos(dth))).max())
    node_dev = float(np.abs(np.stack(slam.node_T) - fx["node_T"]).max())
    ate = float(np.sqrt(np.mean(np.sum(
        (traj[:, :2] - fx["gt"][:, :2]) ** 2, -1))))
    ate_ref = float(np.sqrt(np.mean(np.sum(
        (fx["traj"][:, :2] - fx["gt"][:, :2]) ** 2, -1))))
    print(f"  {n_nodes} frozen nodes (JAX {n_ref}); max deviation from the "
          f"JAX trajectory: xy {dev_xy * 100:.4f} cm, theta "
          f"{dev_th * 1e3:.4f} mrad; node_T {node_dev:.2e}")
    print(f"  ATE vs ground truth: port {ate:.5f} m, JAX {ate_ref:.5f} m")
    check(dev_xy <= XY_TOL and dev_th <= TH_TOL,
          "trajectory deviates from the JAX reference beyond 1 cm / 5 mrad")

    runs, same = [], True
    for _ in range(3):
        cuda_kernels.reset_launch_counts()
        again, sec = run_main_path(sp, fx, dev)
        runs.append(sec)
        same &= (np.array_equal(np.stack(again.trajectory), traj)
                 and dict(cuda_kernels.LAUNCHES) == launches)
    med = sorted(runs)[1]
    print(f"  scans/s: {scans / med:.2f} (median of 3 runs after the "
          f"warm-up: {', '.join(f'{r:.3f}' for r in runs)} s for "
          f"{scans} scans); the three runs repeat the first's trajectory "
          f"bit for bit and its launch counts: {same}")
    check(same, "the main path does not repeat on the card")

    print("phase 3: the main path's registrations replayed (kernel, "
          "per-trial path, plain)")
    replay = replay_phase(calls, dev)
    replay["main_path_syncs"] = syncs
    del calls

    print("phase 3c: plain registration on the main-path graph "
          "(match_d2d, covariance_d2d, fgh_paired)")
    reg_launches = registration_phase(sp, slam, dev)

    print("phase 5: offline graph, canonical corridor, a node every "
          f"{OFFLINE_SPLIT_M} m (pipeline.run_slam)")
    offline, off_launches, checks["fgh_dense_flat_batch"] = offline_phase(
        fx, lc, dev)
    print("phase 6: online loop closure, canonical corridor "
          "(run_sequence_chunked, chunk=64)")
    online, on_launches = online_phase(fx, lc, dev)
    (fleet, checks["newton_objective_batch"], checks["newton_solve_batch"],
     per_trial_batch, fleet_run) = fleet_phases(dev)
    print("phase 8: rolling_map (run_sequence_features, "
          f"{ROLLING['size_m']:.0f} m window)")
    rolling = rolling_phase(fx, dev)
    print("phase 9: offline at scale (the segment-Schur solver, grouped "
          "proposals, checkpoints, the CLI)")
    scale, scale_launches = offline_scale_phase(fx, lc, dev)
    print("phase 10: localization at the canonical point (cli localize's "
          "two modes)")
    localization = localize_phase(sp, fx, dev)
    print("phase 11: the HMT tile store (HMTFuser, out-and-back corridor)")
    hmt = hmt_phase(dev)
    print("phase 11b: the CLI's localize and fuse on the canonical sequence")
    hmt["cli"] = cli_localize_fuse_case(dev)

    io_fx = dict(np.load(IO_FIXTURE))
    check(str(io_fx["params_repr"]) == repr(sp.fuser),
          "canonical_io.npz was made at other parameters than "
          "canonical_slam_params().fuser")
    print("phase 12a: the simulator against JAX (bench.make_sequence, "
          "200 x 720, the reference's draws)")
    simulator = simulator_phase(sp, fx, io_fx, dev)
    print("phase 12c: the inputs end to end (cli simulate, .clf, .bag)")
    inputs = inputs_phase(fx, dev)
    print("phase 13a: P2D registration (match_p2d, scan 20 on the map of "
          "scan 0)")
    p2d, checks["fgh_dense_flat"]["p2d"] = p2d_phase(sp, fx, io_fx, dev)
    print("phase 13b: extrinsic calibration (cli calibrate at its defaults)")
    calibration = calibration_phase(fx, io_fx, dev)
    print("phase 14a: 6-DoF registration (se3, match_d2d_3d on three "
          "accepted links of the LC graph)")
    sixdof = sixdof_phase(lc, dev)
    print("phase 14b: the utilities and plots (cli slam --plot --html, the "
          "viewer's payload, desc_string, GraphLogger, device_trace)")
    viewer = viewer_phase(fx, lc, dev)
    print("phase 15: the multi-device programs in an NCCL world of one rank")
    multidevice, md_launches = multidevice_phase(fx, lc, dev)
    entry_points = entry_points_phase(sp, fx, slam, lc, dev)
    print("phase 17: link refinement, match_d2d and P2D in one launch")
    t17 = time.perf_counter()
    one_launch = one_launch_phase(sp, slam, fx, io_fx, dev)
    one_launch["wall_s"] = time.perf_counter() - t17
    print(f"  phase 17 took {one_launch['wall_s']:.1f} s")
    link_scores = entry_points["compute_link"]["overlap_score"]
    checks["overlap_score"] = link_scores["kernel"]
    checks["row_sum"] = link_scores["row_sum"]

    # Each entry's launches on the path that uses it, counted from 0
    # just before that path: the main path, plain registration
    # (covariance_d2d; fgh_paired), optimize_offline's overlap sums, and
    # the B = 8 fleet run; the other paths of an entry (match_d2d and
    # P2D, link refinement offline, grouped and online, the rank-sharded
    # fleet of phase 15, the chunked driver) in fields of their own.
    # The per-trial entries (the objectives, the window batch) are the
    # body of newton_solve[_batch] or its per-trial yardstick and no
    # path launches them (0, as phases 4, 5, 6 and the fleet run
    # check); the per-trial paths that chip_smoke drives as yardsticks
    # (phase 3's replay, phase 3d, phase 17a) launch them, and those
    # launches stand in `yardstick_launches`, apart.
    path_launches = {
        "newton_objective": launches["newton_objective"],
        "fgh_dense_flat": reg_launches["fgh_dense_flat"],
        "pair_fgh_reduce": reg_launches["pair_fgh_reduce"],
        "fgh_dense_flat_batch": off_launches["fgh_dense_flat_batch"],
        "newton_objective_batch": fleet_run["newton_objective_batch"],
        "newton_solve": launches["newton_solve"],
        "newton_solve_batch": fleet_run["newton_solve_batch"],
        "row_sum": off_launches["row_sum"],
        "segment_add_rows": launches["segment_add_rows"],
        "occupancy_update": launches["occupancy_update"],
        "overlap_score": off_launches["overlap_score"],
        **{k: launches[k] for k in FEATURE_ENTRIES},
    }
    yardstick = {"newton_objective": replay["per_trial_launches"],
                 "row_sum": link_scores["row_sum_yardstick_launches"],
                 "newton_objective_batch": per_trial_batch,
                 "fgh_dense_flat_batch": sum(
                     one_launch[k]["per_trial_launches"]
                     for k in ("offline", "grouped", "online"))}
    for k, v in path_launches.items():
        if k not in yardstick:
            check(v > 0, f"kernel {k} was launched by no path")
    kernels = [{
        "name": k, "route": "cuda", "source": SOURCE, "replaces": REPLACES,
        "launches": path_launches[k], "library_ms": None, **checks[k],
    } for k in path_launches]
    by_name = {k["name"]: k for k in kernels}
    for k, path in (("newton_objective", "none: the body of newton_solve; "
                     "yardstick_launches are the per-trial path of phase "
                     "3's replay"),
                    ("newton_objective_batch", "none: the body of "
                     "newton_solve_batch; yardstick_launches are phase "
                     "3d's per-trial lockstep path"),
                    ("fgh_dense_flat_batch", "none: link refinement runs "
                     "in newton_solve_batch; yardstick_launches are phase "
                     "17a's per-trial lockstep path"),
                    ("row_sum", "none: the link paths score through "
                     "overlap_score; yardstick_launches are phase 16b's "
                     "eager path + row_sum")):
        by_name[k].update(path=path, yardstick_launches=yardstick[k])
    by_name["newton_solve_batch"]["launches_sharded_fleet"] = md_launches
    by_name["newton_solve_batch"]["launches_refinement"] = {
        k: one_launch[k]["launches"] for k in ("offline", "grouped",
                                                "online")}
    by_name["newton_solve_batch"]["refinement_ms"] = {
        k: {"lanes": one_launch[k]["timed_lanes"],
            "blocks": one_launch[k]["timed_blocks"],
            "solve_ms": one_launch[k]["solve_ms"],
            "refine_links_d2d_ms": one_launch[k]["ms"],
            "bound_ms": one_launch[k]["bound_ms"]}
        for k in ("offline", "grouped", "online")
        if "solve_ms" in one_launch[k]}
    by_name["newton_solve"]["launches_chunked"] = (
        entry_points["chunked"]["launches"]["newton_solve"])
    by_name["newton_solve"]["launches_match"] = {
        "match_d2d": reg_launches["newton_solve"],
        "match_p2d": p2d["launches"]["newton_solve"]}
    by_name["fgh_dense_flat"]["path"] = (
        "covariance_d2d (match_d2d and P2D run in newton_solve)")
    by_name["row_sum"].update(source=SOURCE, replaces=ROW_SUM_REPLACES)
    by_name["overlap_score"].update(
        source=OVERLAP_SOURCE, replaces=OVERLAP_REPLACES,
        path="the link paths' overlap score: optimize_offline's launches "
             "(compute_links_batch and rescore_links); online LC's and "
             "phase 16b's compute_link / compute_links_batch in fields of "
             "their own",
        launches_online_lc=on_launches["overlap_score"],
        launches_link_case=entry_points["compute_link"]["launches"])
    for k, src, where, what in (
            ("segment_add_rows", SEGMENT_SOURCE, SEGMENT_REPLACES,
             "every statistics update (add_points_touched)"),
            ("occupancy_update", OCCUPANCY_SOURCE, OCCUPANCY_REPLACES,
             "every occupancy update (update_occupancy), one cluster "
             "launch (two passes, one launch counted, on a grid too large "
             "for a cluster)")):
        by_name[k].update(
            source=src, replaces=where,
            path=f"{what}: the main path's launches; the chunked "
                 "driver's, the B = 8 fleet run's and online LC's in "
                 "fields of their own",
            launches_chunked=entry_points["chunked"]["launches"][k],
            launches_fleet_b8=fleet_run[k],
            launches_online_lc=on_launches[k])
    for k in FEATURE_ENTRIES:
        by_name[k].update(
            source=FEATURES_SOURCE, replaces=FEATURE_REPLACES[k],
            launches_chunked=entry_points["chunked"]["launches"][k],
            launches_fleet_full_b8=fleet["launches"]["full_b8"][k],
            launches_online_lc=on_launches[k],
            launches_optimize_offline=off_launches[k])
    record = {
        "gpu": gpu, "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": build_s, "kernels": kernels,
        "replay": replay,
        "main_path": {"scans_per_s": scans / med, "run_s": runs,
                      "nodes": n_nodes, "dev_xy_m": dev_xy,
                      "dev_theta_rad": dev_th, "node_T_dev": node_dev,
                      "ate_m": ate, "ate_jax_m": ate_ref,
                      "runs_repeat": same},
        "map_update": map_update, "features": features,
        "localization": localization, "hmt": hmt,
        "offline": offline, "online_lc": online, "fleet": fleet,
        "rolling_map": rolling, "offline_scale": scale,
        "simulator": simulator, "inputs": inputs, "p2d": p2d,
        "calibration": calibration, "sixdof": sixdof, "viewer": viewer,
        "multidevice": multidevice, "entry_points": entry_points,
        "one_launch": one_launch,
        "launches": {"main_path": launches, "registration": reg_launches,
                     "optimize_offline": off_launches,
                     "online_lc": on_launches,
                     "offline_scale_fgh_dense_flat_batch": scale_launches,
                     "sharded_fleet_newton_solve_batch": md_launches,
                     "chunked": entry_points["chunked"]["launches"]},
    }
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(f"{gpu}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
