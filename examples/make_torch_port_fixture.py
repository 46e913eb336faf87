"""Write the canonical fixtures the PyTorch port's chip smoke test reads.

The port runs on a machine without JAX, so this script runs the JAX
reference on the CPU once, at the canonical operating point
(`bench.canonical_params()`, `bench.make_sequence()`: 0.5 m cells on a
100x100 m map, 30 m range, 720 beams, the 200-scan corridor, node split
every 2 m, max_nodes=64), after the `bench.verify_cell_budget` gate, and
saves what the port needs to be held against it:

  ranges, hit, odom, gt          the sequence
  ransac_u (T-1, M, 2)           the RANSAC draws JAX used, per scan
  traj, node_T, edge_rel         the JAX trajectory and graph
  max_cells                      the largest local-NDT cell count seen
  params_repr                    repr() of the SLAMParams the reference ran

    JAX_PLATFORMS=cpu python examples/make_torch_port_fixture.py \
        [--out ndt_feature_graph_tpu_torch/data/canonical_200.npz]

With --lc it writes the loop-closure record instead
(ndt_feature_graph_tpu_torch/data/canonical_lc.npz; it reuses the
sequence of canonical_200.npz, which it checks): on the same corridor,

  off_*   the offline graph of bench.py's bench_offline (a node every
          0.25 m): pipeline.run_slam + optimize_offline, with the scan
          and pair draws, node poses before and after, the proposed
          LinkSet and the final keep mask, each node's scan index; the
          RANSAC poses before refinement (off_ransac_T) and the refined
          poses from RANSAC poses moved by 1e-6 (off_link_T_eps: the
          refinement's own spread); the frozen graph itself (off_bank.*,
          the stacked node bank flattened by field, and off_edge_*, the
          odometry edges), so that the port can run optimize_offline on
          the reference's own graph; and off_alt_*, the optimized poses
          and keep mask of the same run with the odometry offset by 1e-6
          (the reference's own spread);
  on_*    bench.py's bench_online_lc setting (a node every 2 m, online
          loop closure, valid_min_idx_dist=1, candidates within 20 m):
          run_sequence_chunked(chunk=64), with the scan and pair draws
          (and the splits whose proposals took them), the trajectory,
          node poses and loop links.

With --fleet it writes the fleet record
(ndt_feature_graph_tpu_torch/data/canonical_fleet.npz): one 40-scan,
720-beam loop sequence made as parallel/scaling.build_fleet_inputs makes
it (`loop_trajectory(40, radius=5.0)`, seed 0), and for B = 8 streams at
bench.py's fleet operating point (`bench.fleet_params`)

  ranges, hit, odom, gt          the sequence (every stream starts at gt[0])
  pts_traj, pts_scores           run_sequence_batch, bfloat16 gather rows
  pts_f32_traj, pts_f32_scores   the same with gather_table_bf16 off
  ransac_u (B, T-1, M, 2)        the streams' RANSAC draws
  feat_traj, feat_scores         run_sequence_features_batch
  pts_eps_traj, feat_eps_traj    (2, B, T-1, 3) the same two runs with the
                                 odometry moved by 1e-6 and by 1e-5: the
                                 reference's own spread at this operating
                                 point (a scan of this loop registers
                                 millimetres elsewhere under such a change)
  params_repr                    repr() of the fleet FuserParams

With --solver it writes the offline-at-scale record
(ndt_feature_graph_tpu_torch/data/canonical_solver.npz), made with the
JAX package's own solvers and proposals:

  ml_*    bench.py's 570-node multi-loop graph (`chip_smoke.multi_loop_graph`,
          the numpy recipe of bench.py:518-551): its initial poses and
          measurements (so that the rebuild is checked), and
          sparse_direct.optimize_direct's poses and chi2 (max_seg_len 64,
          12 iterations, dcs);
  tl_*    the 4,000-node two-lap graph of tests/test_sparse_solver.py
          (its noise comes from jax.random, so the problem is stored:
          initial poses, edges, information as the scalar diagonal,
          ground truth) and the direct solve's poses and chi2
          (max_seg_len 128, 25 iterations), with the aligned ATE before
          and after, and the chi2 and ATE of the same solve from initial
          poses moved by k * 1e-6, k = 1..31 (the reference's own spread);
  big_*   the reference's chi2 and aligned ATE (before, then after) on
          chip_smoke's 10,000-node two-lap graph, from init + k * 1e-6,
          k = 0..6;
  dir_*   optimize_offline's fixpoint loop with solver="direct" and
          solver_max_seg_len=4 on the loop-closure record's own graph and
          its proposed links (canonical_lc.npz off_*): node poses and the
          final keep mask;
  grp_*   _propose_links with link_batch_size=16, link_group_nodes=8 on
          that node bank: the chunk bounds, the chunks' replayed draws and
          the LinkSet.

With --localize it writes the localization record
(ndt_feature_graph_tpu_torch/data/canonical_localize.npz), cli.py
cmd_localize's two modes on canonical_200.npz's sequence at the
canonical parameters: the map of every second scan of the first half at
ground-truth poses (map_scans), with a scan database of capacity 32;

  dist                    the distance field of that map (metres)
  reloc_*                 relocalize of scan `query` (67): its draws
                          reloc_u (K, M, 2), best index, inliers, pose,
                          its badness, and adjust_pose from that pose
  mcl_*                   MCL (512 particles) over the second half: every
                          draw in key-chain order (mcl_draws), the
                          resampling decisions, the estimates, and both
                          again with the odometry moved by +-k * 1e-6,
                          k = 1..16, 31 runs (mcl_*_eps: the
                          reference's own spread)

With --hmt it writes the HMT record
(ndt_feature_graph_tpu_torch/data/canonical_hmt.npz): the out-and-back
corridor of tests/test_hmt_driver.py at the canonical sensor (x_end 60 m,
0.5 m steps, 481 scans, 720 beams, 30 m range) through HMTFuser at the
canonical parameters (margin 10 m, 64-cell tiles, chunks of 16):

  ranges, hit, odom, gt   the sequence
  traj, n_recenters,      the run, its recentres, stored cells and
  stored_cells, n_gauss   global_gaussians count at the end
  traj_eps, ..._eps       the same with the odometry moved by
                          +-k * 1e-6, k = 1..16, 31 runs (the
                          reference's own spread)
  check_off               the vehicle's offset from the window centre at
                          every recentre check
  dir/<file>              the HMT directory the run saved after save_at
                          scans, file by file (uint8)
  resume_traj             a fuser loaded from it, over the next `resume`
                          scans

With --io it writes the simulator, P2D and calibration record
(ndt_feature_graph_tpu_torch/data/canonical_io.npz; it checks that the
sequence it replays is canonical_200.npz's):

  range_u, odom_u         the draws of bench.make_sequence()'s
                          simulate_sequence (key 0): the range normals
                          (200, 720) and the odometry normals (199, 3)
  ray_idx, ray_ranges,    the noise-free raycast, 720 beams at 30 m, at
  ray_hit                 64 evenly sampled poses of bench_offline_570's
                          trajectory (multi_loop_trajectory(10, 704,
                          radius=2.8), 7,040 poses)
  p2d_*                   match_p2d at the canonical parameters: scan
                          20's points against build_from_scan of scan 0
                          (centred on its sensor, in its frame) from the
                          composed odometry of scans 1-20 (p2d_T_init):
                          the pose, score, trials and converged flag;
                          p2d_eps_T, p2d_eps_trials: the same from starts
                          moved by +-k * 1e-6, k = 1..4 (the reference
                          stops at its start in some of them)
  calib_scores,           cli.py cmd_calibrate at its defaults (3 pairs,
  calib_best              a 7^3 grid over +-0.4 m, +-0.25 rad) on the
                          sequence: the 343 summed scores and the best
                          offset
  calib_eps_idx           the best candidate's index with the base
                          motions moved by +-k * 1e-6, k = 1..4 (the
                          corridor's motion is a translation, so x and y
                          of the extrinsic are unobservable: 49
                          candidates tie to 1e-7 and the reference's own
                          best moves among them)

With --6dof it writes the 6-DoF and viewer record
(ndt_feature_graph_tpu_torch/data/canonical_6dof.npz), made on the
loop-closure record's offline graph (canonical_lc.npz off_*):

  links, T_init           chip_smoke.sixdof_links: three links the
                          reference kept, and their RANSAC poses lifted to
                          SE(3) (the registrations' start)
  {6dof,2d}_T, _d,        ops/d2d3d.match_d2d_3d of each link's moving
  _score, _trials,        node cells onto its reference node cells (both
  _converged, _cov        lifted by chip_smoke.lift_cells, the masked
                          padding dropped: it adds exactly zero), with
                          force2d False and True
  {6dof,2d}_eps_T         (3, 8, 6) the same from starts moved by
                          +-k * 1e-6, k = 1..4 (the reference's own spread)
  payload, payload_sub    viz/html._graph_payload of that graph (poses
                          before the solve, as the trajectory too) as
                          JSON, whole and with chip_smoke.PAYLOAD_MAX_CELLS
                          cells a node
  desc_string             utils/logging_ext.desc_string of its parameters
  params_repr             repr() of those SLAMParams

`replay_ransac_draws` is the replay of the JAX key chain, shared with
the port's parity tests; `recording_slam_class` logs the keys a JAX run
really takes, against which the replay is checked.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import NamedTuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "ndt_feature_graph_tpu_torch", "data")
DEFAULT_OUT = os.path.join(DATA, "canonical_200.npz")
LC_OUT = os.path.join(DATA, "canonical_lc.npz")
FLEET_OUT = os.path.join(DATA, "canonical_fleet.npz")
SOLVER_OUT = os.path.join(DATA, "canonical_solver.npz")
LOCALIZE_OUT = os.path.join(DATA, "canonical_localize.npz")
HMT_OUT = os.path.join(DATA, "canonical_hmt.npz")
IO_OUT = os.path.join(DATA, "canonical_io.npz")
SIXDOF_OUT = os.path.join(DATA, "canonical_6dof.npz")
# The --io record: bench_offline_570's trajectory, the raycast's poses, the
# P2D scans and cmd_calibrate's defaults.
IO = dict(ml_loops=10, ml_steps=704, ml_radius=2.8, ray_poses=64,
          p2d_target=0, p2d_source=20, calib_pairs=3, calib_xy=0.4,
          calib_theta=0.25, calib_grid=7)
LOCALIZE = dict(particles=512, capacity=32, min_matches=8, reloc_seed=1,
                mcl_seed=0)
# The odometry offsets of a record's perturbed runs (the reference's own
# spread): +-k * 1e-6, k = 1..16, 31 runs.
EPS_RUNS = tuple(s * k * 1e-6 for k in range(1, 17) for s in (1, -1))[:31]
# The out-and-back corridor of tests/test_hmt_driver.py at the canonical
# sensor (its world recipe unchanged but for the length); the JAX run
# saves its directory after `save_at` scans, and a fuser loaded from it
# resumes over `resume` scans.
HMT = dict(seed=0, x_end=60.0, step=0.5, obstacles=16, margin=10.0,
           tile_cells=64, chunk=16, save_at=240, resume=32)
FLEET_B = 8
FLEET_EPS = (1e-6, 1e-5)    # odometry offsets of the fleet record's spread
SPLIT_M = 2.0
MAX_NODES = 64
SEED = 0
ALT_ODOM = 1e-6     # odometry offset (m, rad) of the second offline record
TL_EPS, N_EPS = 1e-6, 31  # the two-lap solves' spread: init + k * TL_EPS
N_EPS_BIG = 7             # ... at 10,000 nodes (k = 0..6)


class Replay(NamedTuple):
    """The replayed key chain of one JAX SLAM run."""

    scan_u: np.ndarray      # (T-1, M, 2) RANSAC draws, one row per scan
    fuser_keys: np.ndarray  # (T-1, 2) the fuser key after each scan
    pair_u: list            # (P, M, 2) draws of each link proposal
    pair_keys: list         # the SLAM subkey of each link proposal
    key: np.ndarray         # (2,) the SLAM key at the end


def _pair_uniforms(key, p, m_hyp):
    """The draws of a P-pair link proposal under `key`: split into P
    pair keys, each drawing from the first half of its own split (as
    links.compute_links_batch -> ransac.match_sets)."""
    import jax

    keys = jax.random.split(key, p)
    return np.asarray(jax.vmap(
        lambda k: jax.random.uniform(jax.random.split(k)[0], (m_hyp, 2))
    )(keys), np.float32)


def replay_ransac_draws(seed, odom, sparams, lc_splits=(), pair_counts=()):
    """Replay the JAX key chain of `NDTFeatureGraphSLAM(sparams, seed)`
    driven over `odom` (T, 3), scan 0 consumed by initialize.

    The SLAM key is split once at initialize (the fuser's key) and once
    per node split (the new fuser's key); each scan splits the fuser key
    and draws its (M, 2) RANSAC uniforms from the first half of a split
    of the scan key.  Where the splits fall depends only on odometry
    (`split_schedule`).  An online loop-closure proposal after the
    split of ordinal n (n in `lc_splits`) then takes the next SLAM key
    for its online_lc_max_candidates pairs; each entry P of
    `pair_counts` is one later offline proposal chunk of P pairs
    (`offline_pair_counts`)."""
    import jax

    from ndt_feature_graph_tpu_torch.fusion.scan_driver import (
        split_schedule,
    )

    p, gp = sparams.fuser, sparams.graph
    m_hyp = p.features.ransac_hypotheses
    split, _, _, _, _ = split_schedule(
        np.asarray(odom)[1:], 0.0, 0, gp.new_node_transl_dist,
        gp.max_nodes, p.feature_map_update_incr,
    )
    key = jax.random.PRNGKey(seed)
    key, fkey = jax.random.split(key)
    draws, keys, pair_u, pair_keys = [], [], [], []

    def proposal(key, n_pairs):
        key, sub = jax.random.split(key)
        pair_keys.append(np.asarray(sub))
        pair_u.append(_pair_uniforms(sub, n_pairs, m_hyp))
        return key

    n_split = 0
    for s in split:
        fkey, sub = jax.random.split(fkey)
        ki, _ = jax.random.split(sub)
        draws.append(np.asarray(jax.random.uniform(ki, (m_hyp, 2))))
        if s:
            key, fkey = jax.random.split(key)
            if n_split in lc_splits:
                key = proposal(key, gp.online_lc_max_candidates)
            n_split += 1
        keys.append(np.asarray(fkey))
    for n_pairs in pair_counts:
        key = proposal(key, n_pairs)
    return Replay(np.stack(draws).astype(np.float32), np.stack(keys),
                  pair_u, pair_keys, np.asarray(key))


def offline_pair_counts(n_pairs: int, link_batch_size: int):
    """Pairs per proposal chunk of slam._propose_links."""
    b = link_batch_size
    if b <= 0 or n_pairs <= b:
        return [n_pairs]
    return [b] * (-(-n_pairs // b))


def recording_slam_class():
    """A JAX NDTFeatureGraphSLAM subclass that logs (calling method, key)
    in `key_log` for every key its _split_key hands out."""
    from ndt_feature_graph_tpu.graph.slam import NDTFeatureGraphSLAM

    class RecordingSLAM(NDTFeatureGraphSLAM):
        def __init__(self, params, seed=0):
            super().__init__(params, seed=seed)
            self.key_log = []

        def _split_key(self):
            sub = super()._split_key()
            self.key_log.append((sys._getframe(1).f_code.co_name,
                                 np.asarray(sub)))
            return sub

    return RecordingSLAM


def recording_mcl_class():
    """A JAX MCL subclass that logs every key its _sub hands out and, per
    step, whether it resampled (a step that resamples takes two keys)."""
    from ndt_feature_graph_tpu.localization import mcl

    class RecordingMCL(mcl.MCL):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.keys, self.resampled, self.estimates = [], [], []

        def _sub(self):
            k = super()._sub()
            self.keys.append(k)
            return k

        def step(self, *a):
            n0 = len(self.keys)
            est = super().step(*a)
            self.resampled.append(len(self.keys) - n0 == 2)
            self.estimates.append(np.asarray(est))
            return est

    return RecordingMCL


def mcl_draws(rec):
    """The draws a RecordingMCL run took, as the port's MCL replays them
    (mcl.recorded_draws): init_xy (n, 2) and init_theta (n, 1) uniform in
    [-1, 1), noise (S, n, 3) standard normals, resampled (S,), u0 (R,)
    uniform in [0, 1/n)."""
    import jax

    n = rec.n
    k1, k2 = jax.random.split(rec.keys[0])
    out = dict(
        init_xy=jax.random.uniform(k1, (n, 2), minval=-1.0, maxval=1.0),
        init_theta=jax.random.uniform(k2, (n, 1), minval=-1.0, maxval=1.0),
        noise=[], resampled=np.asarray(rec.resampled, bool), u0=[])
    keys = iter(rec.keys[1:])
    for did in rec.resampled:
        out["noise"].append(jax.random.normal(next(keys), (n, 3)))
        if did:
            out["u0"].append(jax.random.uniform(next(keys), (), minval=0.0,
                                                maxval=1.0 / n))
    out["noise"] = np.stack(out["noise"]) if out["noise"] else np.zeros(
        (0, n, 3))
    out["u0"] = np.asarray(out["u0"], np.float32).reshape(-1)
    return {k: np.asarray(v) for k, v in out.items()}


def relocalize_draws(key, capacity, m_hyp):
    """The RANSAC draws (K, M, 2) of place_rec.relocalize under `key`:
    one key split per stored scan, each drawing as match_sets does."""
    return _pair_uniforms(key, capacity, m_hyp)


def lc_splits_of(key_log):
    """Ordinals of the node splits after which an online loop-closure
    proposal took a key, from a recording_slam key log."""
    out, n = [], -1
    for name, _ in key_log:
        if name == "_finish_split":
            n += 1
        elif name == "_try_online_loop_closure":
            out.append(n)
    return out


def flatten_tree(tree, prefix):
    """A NamedTuple tree of arrays as {"prefix.field.sub": numpy array}
    (interop.tree_from_flat reads it back)."""
    if hasattr(tree, "_fields"):
        out = {}
        for name in tree._fields:
            out.update(flatten_tree(getattr(tree, name), f"{prefix}.{name}"))
        return out
    return {prefix: np.asarray(tree)}


def record_offline(slam, verbose=False):
    """Run the JAX slam.optimize_offline, recording the proposed LinkSet
    and the keep mask of every fixpoint solve (the last is the final
    kept-link set).  Returns (optimized node poses, LinkSet as numpy,
    keep masks)."""
    import jax

    keeps, sets = [], []
    edges_from = slam._edges_from

    def recorded(link_set, keep, node_T):
        sets.append(link_set)
        keeps.append(np.asarray(keep))
        return edges_from(link_set, keep, node_T)

    slam._edges_from = recorded
    out = np.asarray(slam.optimize_offline(verbose=verbose))
    del slam._edges_from
    return out, jax.tree.map(np.asarray, sets[0]), keeps


def make_lc_fixture(out, seq, fp):
    """The loop-closure record (see the module docstring)."""
    import jax
    import jax.numpy as jnp

    from ndt_feature_graph_tpu import pipeline as jpipe
    from ndt_feature_graph_tpu.config import GraphParams, SLAMParams
    from ndt_feature_graph_tpu.graph import links as jlinks
    from ndt_feature_graph_tpu.graph import node as jnode
    from ndt_feature_graph_tpu_torch.fusion.scan_driver import (
        split_schedule,
    )
    from ndt_feature_graph_tpu_torch.pipeline import gate_scans
    from chip_smoke import LC_GRAPH, OFFLINE_SPLIT_M

    seqn = jax.tree.map(np.asarray, seq)
    with np.load(DEFAULT_OUT) as ref:
        for k in ("ranges", "hit", "odom", "gt"):
            if not np.array_equal(ref[k], getattr(seqn, k)):
                raise SystemExit(f"{DEFAULT_OUT} holds another {k}")

    sp_off = SLAMParams(fuser=fp, graph=GraphParams(
        new_node_transl_dist=OFFLINE_SPLIT_M, max_nodes=MAX_NODES))
    off, stats = jpipe.run_slam(sp_off, seq, seed=SEED)
    before = np.stack(off.node_T)
    bank = flatten_tree(jax.tree.map(np.asarray,
                                     jnode.stack_nodes(off.nodes)), "off_bank")
    key_before = np.asarray(off._key)
    pairs = off.candidate_pairs()
    n_pairs = int(np.asarray(pairs[2]).sum())
    after, links, keeps = record_offline(off, verbose=True)
    keep_idx, keep_acc = gate_scans(seqn.odom, sp_off.min_incr_dist,
                                    sp_off.min_incr_rot)
    odom_g = np.concatenate([np.zeros((1, 3), np.float32),
                             np.stack(keep_acc)])
    rep_off = replay_ransac_draws(
        SEED, odom_g, sp_off,
        pair_counts=offline_pair_counts(n_pairs, sp_off.graph.link_batch_size))
    if not np.array_equal(
            replay_ransac_draws(SEED, odom_g, sp_off).key, key_before):
        raise SystemExit("offline: the replayed SLAM key is not JAX's")
    # The proposal's stages: the RANSAC poses, and the refinement's own
    # spread (the refined poses from RANSAC poses moved by 1e-6).
    if len(rep_off.pair_keys) != 1:
        raise SystemExit("offline: the record expects one proposal chunk")
    stacked = jnode.stack_nodes(off.nodes)
    ransac = jlinks.compute_links_batch(
        fp.features, fp.ndt.resolution, stacked, *pairs,
        jnp.asarray(rep_off.pair_keys[0]))
    budget = jlinks.source_cell_budget(stacked)
    refine = lambda ls: jlinks.refine_links_d2d(  # noqa: E731
        fp.ndt, fp.matcher, stacked, ls, src_budget=budget)
    if not np.array_equal(np.asarray(refine(ransac).T), links.T):
        raise SystemExit("offline: the replayed proposal is not JAX's")
    link_T_eps = refine(ransac._replace(T=ransac.T + ALT_ODOM)).T
    gp = sp_off.graph
    split = split_schedule(odom_g[1:], 0.0, 0, gp.new_node_transl_dist,
                           gp.max_nodes, fp.feature_map_update_incr)[0]
    node_scan = [0] + [keep_idx[i] for i in np.flatnonzero(split)]

    # The same offline problem with the odometry moved by 1 um: on this
    # corridor the reference's own solve lands centimetres away from the
    # record (a second basin), the spread any reordered float32 sum sees.
    alt, _ = jpipe.run_slam(sp_off, seq._replace(odom=seq.odom + ALT_ODOM),
                            seed=SEED)
    alt_after, _, alt_keeps = record_offline(alt)

    sp_on = SLAMParams(fuser=fp, graph=GraphParams(
        new_node_transl_dist=SPLIT_M, max_nodes=MAX_NODES, **LC_GRAPH))
    on = recording_slam_class()(sp_on, seed=SEED)
    on.initialize(seq.gt[0], jnp.zeros(3), seq.ranges[0], seq.hit[0])
    traj = on.run_sequence_chunked(seq.odom, seq.ranges, seq.hit, chunk=64)
    lcs = lc_splits_of(on.key_log)
    rep_on = replay_ransac_draws(SEED, seqn.odom, sp_on, lc_splits=lcs)
    logged = [k for n, k in on.key_log if n == "_try_online_loop_closure"]
    if not (len(logged) == len(rep_on.pair_keys) and all(
            np.array_equal(a, b) for a, b in zip(logged, rep_on.pair_keys))
            and np.array_equal(rep_on.key, np.asarray(on._key))):
        raise SystemExit("online: the replayed keys are not JAX's")

    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    np.savez_compressed(
        out,
        off_scan_u=rep_off.scan_u, off_pair_u=np.stack(rep_off.pair_u),
        off_node_T_before=f32(before), off_node_T=f32(after),
        off_link_ref=np.asarray(links.ref, np.int64),
        off_link_mov=np.asarray(links.mov, np.int64),
        off_link_T=f32(links.T), off_link_cov=f32(links.cov),
        off_link_score=f32(links.score), off_link_mask=links.mask,
        off_ransac_T=f32(ransac.T), off_link_T_eps=f32(link_T_eps),
        off_keep=keeps[-1], off_node_scan=np.asarray(node_scan, np.int64),
        off_alt_node_T=f32(alt_after), off_alt_keep=alt_keeps[-1],
        off_n_updates=np.int32(stats["n_updates"]),
        off_edge_ij=np.asarray([e[:2] for e in off.odom_edges], np.int64),
        off_edge_rel=f32([e[2] for e in off.odom_edges]),
        off_edge_cov=f32([e[3] for e in off.odom_edges]),
        **bank,
        off_params_repr=np.str_(repr(sp_off)),
        on_scan_u=rep_on.scan_u,
        on_pair_u=np.stack(rep_on.pair_u) if rep_on.pair_u else np.zeros(
            (0, gp.online_lc_max_candidates, 1, 2), np.float32),
        on_lc_splits=np.asarray(lcs, np.int64),
        on_traj=f32(traj), on_node_T=f32(np.stack(on.node_T)),
        on_loop_links=np.asarray([l[:2] for l in on.loop_links],
                                 np.int64).reshape(-1, 2),
        on_params_repr=np.str_(repr(sp_on)),
    )
    print(f"wrote {out}: offline {len(off.nodes)} nodes, {n_pairs} pairs, "
          f"{int(keeps[-1].sum())} kept links; online {len(on.nodes)} "
          f"nodes, {len(lcs)} proposals, {len(on.loop_links)} loop links")


def jax_graph_from_lc(lc, sparams, seed=SEED):
    """A JAX NDTFeatureGraphSLAM holding the loop-closure record's frozen
    offline graph (its node bank, poses before the solve and odometry
    edges), as chip_smoke's phase 5a gives it to the port."""
    import jax.numpy as jnp

    from ndt_feature_graph_tpu.features.detector import FeatureSet
    from ndt_feature_graph_tpu.graph import node as jnode
    from ndt_feature_graph_tpu.graph.slam import NDTFeatureGraphSLAM
    from ndt_feature_graph_tpu.ops import d2d as jd2d
    from ndt_feature_graph_tpu.ops import ndt_map as jnm

    a = lambda k: jnp.asarray(lc["off_bank." + k])  # noqa: E731
    bank = jnode.NodeData(
        T=a("T"), Tlocal_odom=a("Tlocal_odom"), Tlocal_fuse=a("Tlocal_fuse"),
        target=jd2d.PackedTarget(origin=a("target.origin"),
                                 packed=a("target.packed")),
        cells=jnm.CellList(a("cells.means"), a("cells.covs"),
                           a("cells.mask")),
        occ_origin=a("occ_origin"), occ=a("occ"),
        feats=FeatureSet(*(a("feats." + k) for k in FeatureSet._fields)),
        desc=a("desc"))
    slam = NDTFeatureGraphSLAM(sparams, seed=seed)
    n = bank.T.shape[0]
    slam.nodes = [jax_tree_map(lambda x, k=k: x[k], bank) for k in range(n)]
    slam.node_T = [t.copy() for t in lc["off_node_T_before"]]
    slam.odom_edges = [(int(i), int(j), r, c) for (i, j), r, c in zip(
        lc["off_edge_ij"], lc["off_edge_rel"], lc["off_edge_cov"])]
    return slam


def jax_tree_map(fn, tree):
    import jax

    return jax.tree.map(fn, tree)


def make_solver_fixture(out, fp):
    """The offline-at-scale record (see the module docstring)."""
    import jax
    import jax.numpy as jnp

    from ndt_feature_graph_tpu.config import GraphParams, SLAMParams
    from ndt_feature_graph_tpu.graph import links as jlinks
    from ndt_feature_graph_tpu.graph import node as jnode
    from ndt_feature_graph_tpu.graph import optimize as jopt
    from ndt_feature_graph_tpu.graph import sparse_direct as jsd
    from ndt_feature_graph_tpu_torch.graph.slam import group_bounds
    from chip_smoke import (DIRECT_GRAPH, GROUPED_GRAPH, MULTI_LOOP,
                            TWO_LAP, TWO_LAP_BIG, ate_aligned,
                            multi_loop_graph, two_lap_graph)

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_sparse_solver import _two_lap_slam_problem

    def solve(init, i, j, meas, info_diag, seg, **kw):
        e = len(i)
        edges = jopt.EdgeList(
            i=jnp.asarray(i, jnp.int32), j=jnp.asarray(j, jnp.int32),
            meas=jnp.asarray(meas),
            info=jnp.asarray(info_diag[:, None, None] * np.eye(3, dtype=
                                                               np.float32)),
            mask=jnp.ones(e, bool))
        part = jsd.make_segments(init.shape[0], edges, max_seg_len=seg)
        p, chi = jsd.optimize_direct(jnp.asarray(init), edges, part, **kw)
        return np.asarray(p, np.float32), np.float32(chi)

    rec = {}
    ml = multi_loop_graph(MULTI_LOOP["n_nodes"])
    rec["ml_init"], _, _, rec["ml_meas"], _ = ml
    rec["ml_T"], rec["ml_chi2"] = solve(
        *ml, MULTI_LOOP["max_seg_len"], iterations=MULTI_LOOP["iterations"],
        robust_kernel=MULTI_LOOP["robust_kernel"])
    print(f"570 nodes: chi2 {rec['ml_chi2']:.4f}")

    n = TWO_LAP["n_nodes"]
    gt, init, edges = _two_lap_slam_problem(n)
    info = np.asarray(edges.info)
    info_diag = info[:, 0, 0]
    if not np.array_equal(info, info_diag[:, None, None] * np.eye(3)):
        raise SystemExit("two-lap information is not c * I")
    rec.update(tl_gt=np.asarray(gt, np.float32),
               tl_init=np.asarray(init, np.float32),
               tl_i=np.asarray(edges.i, np.int32),
               tl_j=np.asarray(edges.j, np.int32),
               tl_meas=np.asarray(edges.meas, np.float32),
               tl_info=info_diag.astype(np.float32))
    rec["tl_T"], rec["tl_chi2"] = solve(
        rec["tl_init"], rec["tl_i"], rec["tl_j"], rec["tl_meas"],
        rec["tl_info"], TWO_LAP["max_seg_len"],
        iterations=TWO_LAP["iterations"])
    rec["tl_ate"] = np.float32([ate_aligned(rec["tl_init"], rec["tl_gt"]),
                                ate_aligned(rec["tl_T"], rec["tl_gt"])])
    print(f"4000 nodes: chi2 {rec['tl_chi2']:.4f}, ATE {rec['tl_ate']}")
    # The reference's own spread: the same solve from initial poses moved
    # by k * 1e-6 (its low mode random-walks; see chip_smoke phase 9b).
    eps = [solve(rec["tl_init"] + k * TL_EPS, rec["tl_i"], rec["tl_j"],
                 rec["tl_meas"], rec["tl_info"], TWO_LAP["max_seg_len"],
                 iterations=TWO_LAP["iterations"])
           for k in range(1, N_EPS + 1)]
    rec["tl_eps_chi2"] = np.float32([c for _, c in eps])
    rec["tl_eps_ate"] = np.float32([ate_aligned(p, rec["tl_gt"])
                                    for p, _ in eps])
    print(f"  under init + k * {TL_EPS}: chi2 {rec['tl_eps_chi2']}, ATE "
          f"{rec['tl_eps_ate']}")

    # (c) has no stored problem (chip_smoke makes it with numpy); the
    # reference's chi2 and aligned ATE on it, from init + k * 1e-6.
    gt, init, i, j, meas, info = two_lap_graph(TWO_LAP_BIG)
    big = [solve(init + k * TL_EPS, i, j, meas, info, TWO_LAP["max_seg_len"],
                 iterations=TWO_LAP["iterations"])
           for k in range(N_EPS_BIG)]
    rec["big_chi2"] = np.float32([c for _, c in big])
    rec["big_ate"] = np.float32([ate_aligned(init, gt)]
                                + [ate_aligned(p, gt) for p, _ in big])
    print(f"{TWO_LAP_BIG} nodes: chi2 {rec['big_chi2']}, ATE "
          f"{rec['big_ate']}")

    from chip_smoke import OFFLINE_SPLIT_M

    lc = dict(np.load(LC_OUT))
    base = SLAMParams(fuser=fp, graph=GraphParams(
        new_node_transl_dist=OFFLINE_SPLIT_M, max_nodes=MAX_NODES))
    if repr(base) != str(lc["off_params_repr"]):
        raise SystemExit(f"{LC_OUT} was made at other offline parameters")
    links = jlinks.LinkSet(**{k: jnp.asarray(lc["off_link_" + k]) for k in
                              ("ref", "mov", "T", "cov", "score", "mask")})
    sp_dir = SLAMParams(fuser=base.fuser,
                        graph=base.graph.replace(**DIRECT_GRAPH))
    slam = jax_graph_from_lc(lc, sp_dir)
    slam._propose_links = lambda *a: links
    after, _, keeps = record_offline(slam)
    rec.update(dir_node_T=after.astype(np.float32), dir_keep=keeps[-1])
    print(f"direct solve on the record's links: {int(keeps[-1].sum())} "
          "kept links")

    sp_grp = SLAMParams(fuser=base.fuser,
                        graph=base.graph.replace(**GROUPED_GRAPH))
    cls = recording_slam_class()
    slam = jax_graph_from_lc(lc, sp_grp)
    rslam = cls(sp_grp, seed=SEED)
    rslam.nodes, rslam.node_T = slam.nodes, slam.node_T
    rslam.odom_edges = slam.odom_edges
    stacked = jnode.stack_nodes(rslam.nodes)
    pairs = rslam.candidate_pairs()
    ls = rslam._propose_links(stacked, *pairs)
    m_hyp = base.fuser.features.ransac_hypotheses
    key = jax.random.PRNGKey(SEED)
    pair_u = []
    for _, sub in rslam.key_log:
        key, want = jax.random.split(key)
        if not np.array_equal(np.asarray(want), sub):
            raise SystemExit("grouped: the replayed keys are not JAX's")
        pair_u.append(_pair_uniforms(want, GROUPED_GRAPH["link_batch_size"],
                                     m_hyp))
    ref_np = np.asarray(pairs[0])
    chunk_start = [s for s, _ in group_bounds(
        ref_np, np.asarray(pairs[1]), np.asarray(pairs[2]),
        GROUPED_GRAPH["link_batch_size"],
        max(2, GROUPED_GRAPH["link_group_nodes"]))]
    if len(chunk_start) != len(pair_u):
        raise SystemExit("grouped: chunk count differs from the draws")
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    rec.update(grp_pair_u=np.stack(pair_u),
               grp_chunk_start=np.asarray(chunk_start, np.int64),
               grp_ref=np.asarray(ls.ref, np.int64),
               grp_mov=np.asarray(ls.mov, np.int64), grp_T=f32(ls.T),
               grp_cov=f32(ls.cov), grp_score=f32(ls.score),
               grp_mask=np.asarray(ls.mask))
    print(f"grouped proposals: {len(pair_u)} chunks, "
          f"{int(np.asarray(ls.mask).sum())} valid links of {len(ref_np)}")
    np.savez_compressed(out, **rec)
    print(f"wrote {out} ({os.path.getsize(out) / 1e6:.2f} MB)")


def _loc_map(mp, fp_db, seq, split):
    """cmd_localize's map and scan database (JAX)."""
    import jax.numpy as jnp

    from ndt_feature_graph_tpu.core import se2
    from ndt_feature_graph_tpu.io import dataset
    from ndt_feature_graph_tpu.localization import place_rec
    from ndt_feature_graph_tpu.ops import ndt_map

    grid = ndt_map.empty_grid(mp, jnp.zeros(2))
    db = place_rec.empty_database(fp_db, capacity=LOCALIZE["capacity"])
    for t in range(0, split, 2):
        pts, mask = dataset.scan_to_points(seq.ranges[t], seq.hit[t])
        world = se2.transform_points(seq.gt[t], pts)
        grid = ndt_map.add_points(grid, mp, world, mask)
        grid = ndt_map.update_occupancy(grid, mp, seq.gt[t][:2], world, mask)
        db = place_rec.insert_scan(db, fp_db, seq.gt[t], seq.ranges[t],
                                   seq.hit[t])
    return grid, db


def make_localize_fixture(out, seq, params):
    """The localization record (see the module docstring)."""
    import jax
    import jax.numpy as jnp

    from ndt_feature_graph_tpu.config import FeatureParams, MotionParams
    from ndt_feature_graph_tpu.io import dataset
    from ndt_feature_graph_tpu.localization import monitor, place_rec
    from ndt_feature_graph_tpu.ops import d2d

    mp = params.ndt
    fp_db = FeatureParams(num_beams=params.features.num_beams,
                          max_range=mp.sensor_range)
    t_total = int(seq.gt.shape[0])
    split = t_total // 2
    grid, db = _loc_map(mp, fp_db, seq, split)
    tgt = d2d.make_dense_target(grid, mp)

    q = split // 3 * 2 + 1
    key = jax.random.PRNGKey(LOCALIZE["reloc_seed"])
    pose, best, n = place_rec.relocalize(
        db, fp_db, seq.ranges[q], seq.hit[q], key,
        min_num_matches=LOCALIZE["min_matches"])
    if pose is None:
        raise SystemExit(f"localize: scan {q} did not relocalize ({n})")
    dmap = monitor.build_distance_map(grid.occ, grid.origin, mp.resolution)
    pts_q, mask_q = dataset.scan_to_points(seq.ranges[q], seq.hit[q])
    bad = float(monitor.badness(dmap, jnp.asarray(pose), pts_q, mask_q))
    adj, adj_score = monitor.adjust_pose(dmap, jnp.asarray(pose), pts_q,
                                         mask_q)

    def track(eps):
        rec = recording_mcl_class()(mp, MotionParams(), tgt,
                                    n_particles=LOCALIZE["particles"],
                                    seed=LOCALIZE["mcl_seed"])
        rec.initialize(seq.gt[split], spread_xy=0.5, spread_theta=0.2)
        for t in range(split + 1, t_total):
            pts, mask = dataset.scan_to_points(seq.ranges[t], seq.hit[t])
            rec.step(seq.odom[t] + eps, pts, mask)
        return rec

    rec = track(0.0)
    recs_eps = [track(e) for e in EPS_RUNS]
    est = np.stack(rec.estimates)
    est_eps = np.stack([np.stack(r.estimates) for r in recs_eps])
    gt = np.asarray(seq.gt)[split + 1:]
    err = np.linalg.norm(est[:, :2] - gt[:, :2], axis=1)
    dr = mcl_draws(rec)
    np.savez_compressed(
        out, map_scans=np.arange(0, split, 2), split=np.int32(split),
        query=np.int32(q), db_used=np.int32(int(jnp.sum(db.mask))),
        dist=np.asarray(dmap.dist, np.float32),
        reloc_u=relocalize_draws(key, LOCALIZE["capacity"],
                                 fp_db.ransac_hypotheses),
        reloc_best=np.int32(best), reloc_inliers=np.int32(n),
        reloc_pose=np.asarray(pose, np.float32),
        reloc_badness=np.float32(bad),
        adjust_pose=np.asarray(adj, np.float32),
        adjust_score=np.float32(adj_score),
        **{f"mcl_{k}": v for k, v in dr.items()},
        mcl_est=est.astype(np.float32),
        mcl_est_eps=est_eps.astype(np.float32),
        mcl_resampled_eps=np.asarray([r.resampled for r in recs_eps], bool),
        mcl_err=err.astype(np.float32),
        params_repr=np.str_(repr(mp)), features_repr=np.str_(repr(fp_db)),
        particles=np.int32(LOCALIZE["particles"]),
    )
    dth = est_eps[..., 2] - est[:, 2]
    n_dec = [int((np.asarray(r.resampled) != dr["resampled"]).sum())
             for r in recs_eps]
    print(f"wrote {out}: {int(jnp.sum(db.mask))} stored scans; scan {q} -> "
          f"stored {best} with {n} inliers, badness {bad:.4f} m; MCL "
          f"{len(est)} steps, {int(dr['resampled'].sum())} resampled, final "
          f"error {err[-1]:.4f} m, mean {err.mean():.4f} m; the odometry moved "
          f"by {EPS_RUNS} moves the estimates by "
          f"{np.abs(est_eps[..., :2] - est[:, :2]).max():.2e} m / "
          f"{np.abs(np.arctan2(np.sin(dth), np.cos(dth))).max():.2e} rad and "
          f"{n_dec} resampling decisions")


def hmt_sequence(seed, x_end, step, obstacles=16, num_beams=720,
                 max_range=30.0):
    """tests/test_hmt_driver.py's out-and-back corridor drive (the out
    leg from -x_end to +x_end, then back), at the given sensor."""
    import jax
    import jax.numpy as jnp

    from ndt_feature_graph_tpu.io import dataset

    n = int(round(2 * x_end / step)) + 1
    xs = np.linspace(-x_end, x_end, n)
    out = np.stack([xs, np.zeros(n), np.zeros(n)], -1)
    traj = jnp.asarray(np.concatenate([out, out[-2::-1]]).astype(np.float32))
    world = dataset.random_world(seed, half_x=x_end + 3.0, half_y=4.0,
                                 n_obstacles=obstacles,
                                 keepout=np.asarray(traj[:, :2]),
                                 clearance=1.0)
    return dataset.simulate_sequence(
        jax.random.PRNGKey(seed), traj, num_beams=num_beams,
        max_range=max_range, segments=world,
        odom_noise=(0.004, 0.004, 0.002))


def make_hmt_fixture(out, params):
    """The HMT record (see the module docstring)."""
    import tempfile

    import jax
    import jax.numpy as jnp

    from ndt_feature_graph_tpu.fusion.hmt_driver import HMTFuser
    from ndt_feature_graph_tpu.io import dataset

    h = HMT
    seq = hmt_sequence(h["seed"], h["x_end"], h["step"], h["obstacles"],
                       params.features.num_beams, params.ndt.sensor_range)
    pts, mask = jax.vmap(dataset.scan_to_points)(seq.ranges, seq.hit)
    a, c = h["save_at"], h["chunk"]

    def run(eps, save_dir=None):
        offs = []

        class Recording(HMTFuser):
            def maybe_recenter(self):
                pose = np.asarray(self.state.Tnow, np.float64)
                offs.append(float(np.hypot(*(pose[:2] - self._center()))))
                return super().maybe_recenter()

        hf = Recording(params, seq.gt[0], jnp.zeros(3), pts[0], mask[0],
                       recenter_margin=h["margin"],
                       tile_cells=h["tile_cells"])
        odom = seq.odom + eps
        first = hf.run_sequence(odom[1:a + 1], pts[1:a + 1],
                                mask[1:a + 1], chunk=c)
        if save_dir is not None:
            hf.save(save_dir)
        rest = hf.run_sequence(odom[a + 1:], pts[a + 1:], mask[a + 1:],
                               chunk=c)
        return hf, np.concatenate([first, rest]), np.asarray(offs)

    with tempfile.TemporaryDirectory() as d:
        hf, traj, offs = run(0.0, d)
        files = {f"dir/{name}": np.frombuffer(
            open(os.path.join(d, name), "rb").read(), np.uint8)
            for name in sorted(os.listdir(d))}
        hf2 = HMTFuser.load(d, params)
        sl = slice(a + 1, a + 1 + h["resume"])
        resume = hf2.run_sequence(seq.odom[sl], pts[sl], mask[sl], chunk=c)
    def n_gauss(f):
        f.hmt.grid = f.state.grid
        return f.hmt.global_gaussians()[0].shape[0]

    eps_runs = [run(e)[:2] for e in EPS_RUNS]
    traj_eps = np.stack([t for _, t in eps_runs])
    means = np.zeros((n_gauss(hf), 2))
    dth = traj_eps[..., 2] - traj[:, 2]
    np.savez_compressed(
        out, ranges=np.asarray(seq.ranges, np.float32),
        hit=np.asarray(seq.hit, bool), odom=np.asarray(seq.odom, np.float32),
        gt=np.asarray(seq.gt, np.float32), traj=traj.astype(np.float32),
        n_recenters=np.int32(hf.n_recenters),
        stored_cells=np.int32(hf.stored_cell_count()),
        n_gauss=np.int32(means.shape[0]),
        traj_eps=traj_eps.astype(np.float32),
        n_recenters_eps=np.int32([f.n_recenters for f, _ in eps_runs]),
        stored_cells_eps=np.int32([f.stored_cell_count()
                                   for f, _ in eps_runs]),
        n_gauss_eps=np.int32([n_gauss(f) for f, _ in eps_runs]),
        check_off=offs.astype(np.float32),
        resume_traj=np.asarray(resume, np.float32),
        params_repr=np.str_(repr(params)),
        **{k: np.int32(v) if isinstance(v, int) else np.float32(v)
           for k, v in h.items()}, **files)
    print(f"wrote {out}: {traj.shape[0]} poses, {hf.n_recenters} recentres, "
          f"{hf.stored_cell_count()} stored cells, {means.shape[0]} "
          f"gaussians, {len(files)} files; checks "
          f"{np.abs(offs - h['margin']).min():.3f} m from the margin at the "
          f"closest; the odometry moved by {EPS_RUNS}: recentres "
          f"{[f.n_recenters for f, _ in eps_runs]}, stored cells "
          f"{[f.stored_cell_count() for f, _ in eps_runs]}, gaussians "
          f"{[n_gauss(f) for f, _ in eps_runs]}, the trajectory moves by "
          f"{np.abs(traj_eps[..., :2] - traj[:, :2]).max():.2e} m / "
          f"{np.abs(np.arctan2(np.sin(dth), np.cos(dth))).max():.2e} rad")


def simulator_draws(key, t_steps, num_beams):
    """The standard normals dataset.simulate_sequence draws under `key`:
    (range draws (T, B), odometry draws (T-1, 3)), float32."""
    import jax

    k1, k2 = jax.random.split(key)
    keys = jax.random.split(k1, t_steps)
    rng = jax.vmap(lambda k: jax.random.normal(k, (num_beams,)))(keys)
    return (np.asarray(rng, np.float32),
            np.asarray(jax.random.normal(k2, (t_steps - 1, 3)), np.float32))


def calibration_pairs(seq, n_pairs):
    """cli.py cmd_calibrate's scan pairs: (k, k + step) for the first
    `n_pairs` multiples k of step = T // (n_pairs + 1)."""
    t_total = int(seq.gt.shape[0])
    step = max(1, t_total // (n_pairs + 1))
    return [(k, k + step) for k in range(
        0, min(n_pairs * step, t_total - step), step)]


def make_io_fixture(out, params):
    import jax
    import jax.numpy as jnp

    import bench
    from ndt_feature_graph_tpu.core import se2
    from ndt_feature_graph_tpu.io import dataset
    from ndt_feature_graph_tpu.ops import d2d, ndt_map
    from ndt_feature_graph_tpu.utils import pairwise

    seq = bench.make_sequence()
    with np.load(DEFAULT_OUT) as ref:
        for k in ("ranges", "hit", "odom", "gt"):
            if not np.array_equal(np.asarray(getattr(seq, k)), ref[k]):
                raise SystemExit(f"io: bench.make_sequence's {k} is not "
                                 "canonical_200.npz's")
    t_steps, nb = seq.ranges.shape
    range_u, odom_u = simulator_draws(jax.random.PRNGKey(0), t_steps, nb)

    traj = dataset.multi_loop_trajectory(
        IO["ml_loops"], IO["ml_steps"], radius=IO["ml_radius"])
    ray_idx = np.linspace(0, traj.shape[0] - 1, IO["ray_poses"]).round(
    ).astype(np.int32)
    world = dataset.default_world()
    ray_r, ray_h = jax.vmap(
        lambda p: dataset.raycast(world, p, nb, params.ndt.sensor_range)
    )(traj[ray_idx])

    i0, i1 = IO["p2d_target"], IO["p2d_source"]
    pts0, m0 = dataset.scan_to_points(seq.ranges[i0], seq.hit[i0])
    grid = ndt_map.build_from_scan(params.ndt, jnp.zeros(2), jnp.zeros(2),
                                   pts0, m0)
    tgt = d2d.make_dense_target(grid, params.ndt)
    T_init = jnp.zeros(3)
    for t in range(i0 + 1, i1 + 1):
        T_init = se2.compose(T_init, seq.odom[t])
    pts1, m1 = dataset.scan_to_points(seq.ranges[i1], seq.hit[i1])
    p2d = pairwise.match_p2d(tgt, pts1, m1, T_init, params.ndt,
                             params.matcher)
    # The reference's own spread: from a start moved by k * 1e-6 it
    # either converges or stops at the start (an indefinite projected
    # Hessian, the port's d2d._psd_project says how).
    p2d_eps = [pairwise.match_p2d(tgt, pts1, m1, T_init + e, params.ndt,
                                  params.matcher) for e in EPS_RUNS[:8]]

    pairs, rels = [], []
    for a, b in calibration_pairs(seq, IO["calib_pairs"]):
        pairs.append((dataset.scan_to_points(seq.ranges[a], seq.hit[a]),
                      dataset.scan_to_points(seq.ranges[b], seq.hit[b])))
        rels.append(np.asarray(se2.sub(seq.gt[a], seq.gt[b])))
    calib = lambda rs: pairwise.calibrate_extrinsic(  # noqa: E731
        pairs, rs, search_xy=IO["calib_xy"], search_theta=IO["calib_theta"],
        n=IO["calib_grid"])
    best, scores = calib(rels)
    # On this straight corridor the base motion is a translation, which
    # leaves the extrinsic's x, y unobservable: the reference's own best
    # moves among the tied candidates under a 1e-6 change of the motions.
    eps_idx = [int(np.argmin(np.asarray(calib([r + e for r in rels])[1])))
               for e in EPS_RUNS[:8]]

    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.savez_compressed(
        out, range_u=range_u, odom_u=odom_u, ray_idx=ray_idx,
        ray_ranges=np.asarray(ray_r, np.float32),
        ray_hit=np.asarray(ray_h, bool),
        p2d_T_init=np.asarray(T_init, np.float32),
        p2d_T=np.asarray(p2d.T, np.float32),
        p2d_score=np.float32(p2d.score),
        p2d_trials=np.int32(p2d.iterations),
        p2d_converged=np.bool_(p2d.converged),
        p2d_eps_T=np.stack([np.asarray(r.T, np.float32) for r in p2d_eps]),
        p2d_eps_trials=np.asarray([int(r.iterations) for r in p2d_eps],
                                  np.int32),
        calib_scores=np.asarray(scores, np.float32),
        calib_best=np.asarray(best, np.float32),
        calib_eps_idx=np.asarray(eps_idx, np.int32),
        params_repr=np.str_(repr(params)),
    )
    print(f"wrote {out}: P2D {int(p2d.iterations)} trials, converged "
          f"{bool(p2d.converged)}, score {float(p2d.score):.4f}; best "
          f"offset {np.asarray(best)}, under 1e-6 changes {eps_idx}")


def make_6dof_fixture(out, params):
    """The 6-DoF and viewer record (see the module docstring)."""
    import json

    import jax
    import jax.numpy as jnp

    from chip_smoke import (
        OFFLINE_SPLIT_M, PAYLOAD_MAX_CELLS, lift_cells, sixdof_links,
    )
    from ndt_feature_graph_tpu.config import GraphParams, SLAMParams
    from ndt_feature_graph_tpu.ops import d2d3d
    from ndt_feature_graph_tpu.utils.logging_ext import desc_string
    from ndt_feature_graph_tpu.viz import html

    lc = dict(np.load(LC_OUT))
    sparams = SLAMParams(fuser=params, graph=GraphParams(
        new_node_transl_dist=OFFLINE_SPLIT_M, max_nodes=MAX_NODES))
    if repr(sparams) != str(lc["off_params_repr"]):
        raise SystemExit("6dof: canonical_lc.npz was made at other "
                         "parameters")
    links = sixdof_links(lc)
    cells = lambda k: d2d3d.CellList3D(**{  # noqa: E731
        f: jnp.asarray(v) for f, v in lift_cells(
            lc["off_bank.cells.means"][k], lc["off_bank.cells.covs"][k],
            lc["off_bank.cells.mask"][k], compact=True).items()})
    T_init = np.zeros((len(links), 6), np.float32)
    T_init[:, :2] = lc["off_ransac_T"][links, :2]
    T_init[:, 5] = lc["off_ransac_T"][links, 2]
    rec = {"links": links.astype(np.int32), "T_init": T_init}
    m = params.matcher
    for mode, force2d in (("6dof", False), ("2d", True)):
        res, eps = [], []
        for k, li in enumerate(links):
            tgt, src = cells(lc["off_link_ref"][li]), cells(
                lc["off_link_mov"][li])
            run = lambda T0: d2d3d.match_d2d_3d(  # noqa: E731
                tgt, src, jnp.asarray(T0), m, force2d=force2d)
            res.append(jax.tree.map(np.asarray, run(T_init[k])))
            eps.append([np.asarray(run(T_init[k] + e).T)
                        for e in EPS_RUNS[:8]])
            print(f"6dof: {mode} link {li}: {int(res[-1].iterations)} "
                  f"trials, T {res[-1].T}")
        for f, key in (("T", "T"), ("d", "d"), ("score", "score"),
                       ("iterations", "trials"), ("converged", "converged"),
                       ("cov", "cov")):
            rec[f"{mode}_{key}"] = np.stack([getattr(r, f) for r in res])
        rec[f"{mode}_eps_T"] = np.asarray(eps, np.float32)

    slam = jax_graph_from_lc(lc, sparams)
    slam.trajectory = [t.copy() for t in lc["off_node_T_before"]]
    dump = lambda p: json.dumps(p, separators=(",", ":"))  # noqa: E731
    rec["payload"] = np.str_(dump(html._graph_payload(slam)))
    rec["payload_sub"] = np.str_(dump(html._graph_payload(
        slam, max_cells_per_node=PAYLOAD_MAX_CELLS)))
    rec["desc_string"] = np.str_(desc_string(sparams))
    rec["params_repr"] = np.str_(repr(sparams))
    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.savez_compressed(out, **rec)
    print(f"wrote {out}: links {links.tolist()}, payload "
          f"{len(str(rec['payload']))} characters")


def replay_fleet_draws(seed, n_streams, t_steps, m_hyp):
    """The RANSAC draws of scaling.build_fleet_feature_inputs' streams
    over `t_steps` scans: stream b's key is the b-th split of
    PRNGKey(seed + 2); each scan splits it and draws (M, 2) uniforms
    from the first half of a split of the scan key.  Returns (draws
    (B, T, M, 2), the streams' keys after the last scan)."""
    import jax

    def stream(key):
        def scan(key, _):
            key, sub = jax.random.split(key)
            ki, _ = jax.random.split(sub)
            return key, jax.random.uniform(ki, (m_hyp, 2))

        return jax.lax.scan(scan, key, None, length=t_steps)

    keys, u = jax.vmap(stream)(
        jax.random.split(jax.random.PRNGKey(seed + 2), n_streams))
    return np.asarray(u, np.float32), np.asarray(keys)


def make_fleet_fixture(out, params):
    """The fleet record (see the module docstring)."""
    import jax

    import bench
    from ndt_feature_graph_tpu.fusion import scan_driver
    from ndt_feature_graph_tpu.io import dataset
    from ndt_feature_graph_tpu.parallel import scaling

    fp = bench.fleet_params(params)
    t, beams = bench.FLEET_T, fp.features.num_beams
    seq = dataset.simulate_sequence(
        jax.random.PRNGKey(SEED), dataset.loop_trajectory(t, radius=5.0),
        num_beams=beams, max_range=fp.ndt.sensor_range)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731

    states, odom, pts, mask = scaling.build_fleet_inputs(
        fp, FLEET_B, t_steps=t, num_beams=beams, seed=SEED)
    if not np.array_equal(np.asarray(odom[0]), np.asarray(seq.odom[1:])):
        raise SystemExit("fleet: build_fleet_inputs made another sequence")
    _, traj, scores = scan_driver.run_sequence_batch(fp, states, odom, pts,
                                                     mask)
    _, traj32, scores32 = scan_driver.run_sequence_batch(
        fp.replace(gather_table_bf16=False), states, odom, pts, mask)
    traj_eps = [scan_driver.run_sequence_batch(fp, states, odom + e, pts,
                                               mask)[1] for e in FLEET_EPS]

    fstates, odom, ranges, hit = scaling.build_fleet_feature_inputs(
        fp, FLEET_B, t_steps=t, num_beams=beams, seed=SEED)
    finals, ftraj, fscores = scan_driver.run_sequence_features_batch(
        fp, fstates, odom, ranges, hit)
    ftraj_eps = [scan_driver.run_sequence_features_batch(
        fp, fstates, odom + e, ranges, hit)[1] for e in FLEET_EPS]
    u, keys = replay_fleet_draws(SEED, FLEET_B, t - 1,
                                 fp.features.ransac_hypotheses)
    if not np.array_equal(keys, np.asarray(finals.key)):
        raise SystemExit("fleet: the replayed stream keys are not JAX's")

    np.savez_compressed(
        out, ranges=f32(seq.ranges), hit=np.asarray(seq.hit, bool),
        odom=f32(seq.odom), gt=f32(seq.gt),
        pts_traj=f32(traj), pts_scores=f32(scores),
        pts_f32_traj=f32(traj32), pts_f32_scores=f32(scores32),
        ransac_u=u, feat_traj=f32(ftraj), feat_scores=f32(fscores),
        pts_eps_traj=f32(traj_eps), feat_eps_traj=f32(ftraj_eps),
        params_repr=np.str_(repr(fp)),
    )

    def spread(a, b):
        return np.abs(f32(a)[..., :2] - f32(b)[..., :2]).max()

    print(f"wrote {out}: {FLEET_B} streams x {t - 1} scans; bf16 rows move "
          f"the poses by {spread(traj, traj32):.2e} m; the odometry moved "
          f"by {FLEET_EPS} moves them by "
          f"{[float(spread(traj, x)) for x in traj_eps]} m (points) and "
          f"{[float(spread(ftraj, x)) for x in ftraj_eps]} m (features)")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out")
    ap.add_argument("--lc", action="store_true",
                    help="write the loop-closure record")
    ap.add_argument("--solver", action="store_true",
                    help="write the offline-at-scale record")
    ap.add_argument("--fleet", action="store_true",
                    help="write the fleet record")
    ap.add_argument("--localize", action="store_true",
                    help="write the localization record")
    ap.add_argument("--hmt", action="store_true",
                    help="write the HMT record")
    ap.add_argument("--io", action="store_true",
                    help="write the simulator, P2D and calibration record")
    ap.add_argument("--6dof", dest="sixdof", action="store_true",
                    help="write the 6-DoF registration and viewer record")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    import jax.numpy as jnp

    sys.path.insert(0, ROOT)
    import bench
    from ndt_feature_graph_tpu.config import GraphParams, SLAMParams
    from ndt_feature_graph_tpu.graph.slam import NDTFeatureGraphSLAM

    if args.fleet:
        return make_fleet_fixture(args.out or FLEET_OUT,
                                  bench.canonical_params())
    if args.hmt:
        return make_hmt_fixture(args.out or HMT_OUT, bench.canonical_params())
    if args.io:
        return make_io_fixture(args.out or IO_OUT, bench.canonical_params())
    if args.sixdof:
        return make_6dof_fixture(args.out or SIXDOF_OUT,
                                 bench.canonical_params())
    if args.localize:
        return make_localize_fixture(args.out or LOCALIZE_OUT,
                                     bench.make_sequence(),
                                     bench.canonical_params())
    seq = bench.make_sequence()
    max_cells, fp = bench.verify_cell_budget(bench.canonical_params(), seq)
    if fp.match_cell_budget != bench.MATCH_CELL_BUDGET:
        raise SystemExit(f"cell budget gate failed: {max_cells} cells")
    if args.lc:
        return make_lc_fixture(args.out or LC_OUT, seq, fp)
    if args.solver:
        return make_solver_fixture(args.out or SOLVER_OUT, fp)
    args.out = args.out or DEFAULT_OUT
    sparams = SLAMParams(
        fuser=fp,
        graph=GraphParams(new_node_transl_dist=SPLIT_M,
                          max_nodes=MAX_NODES),
    )
    slam = NDTFeatureGraphSLAM(sparams, seed=SEED)
    slam.initialize(seq.gt[0], jnp.zeros(3), seq.ranges[0], seq.hit[0])
    traj = slam.run_sequence_device(seq.odom, seq.ranges, seq.hit)
    draws = replay_ransac_draws(SEED, seq.odom, sparams).scan_u

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(
        args.out,
        ranges=np.asarray(seq.ranges, np.float32),
        hit=np.asarray(seq.hit, bool),
        odom=np.asarray(seq.odom, np.float32),
        gt=np.asarray(seq.gt, np.float32),
        ransac_u=draws,
        traj=np.asarray(traj, np.float32),
        node_T=np.asarray(np.stack(slam.node_T), np.float32),
        edge_rel=np.asarray(np.stack([e[2] for e in slam.odom_edges]),
                            np.float32),
        max_cells=np.int32(max_cells),
        split_m=np.float32(SPLIT_M),
        max_nodes=np.int32(MAX_NODES),
        params_repr=np.str_(repr(sparams)),
    )
    print(f"wrote {args.out}: {traj.shape[0]} poses, "
          f"{len(slam.nodes)} nodes, max cells {max_cells}")


if __name__ == "__main__":
    main()
