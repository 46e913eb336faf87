"""The whole loop-closure slice against the JAX reference, on the
drifty-odometry loop of test_graph_slam.py / test_online_loop_closure.py
(100 scans around a 5 m loop, 360 beams, 40x40 m submaps, a node every
3 m, odometry forced as the estimate and biased by 3.5 mrad per scan):
`pipeline.run_slam` + `optimize_offline`, and `run_slam` with online
loop closure (run_sequence_chunked), each with the reference's RANSAC
draws replayed from its key chain.

The loop keeps its size: shrunk to 60 scans it turns chaotic — one
candidate link ((2, 7)) registers into another basin after the
trajectories differ by float32 rounding, and the node poses of the two
frameworks part by metres (measured).  At this size they agree.

Tolerances: node poses and trajectories atol 2e-3 (the optimized poses
of a solve over links refined in float32, measured 4.2e-4; the online
trajectory, measured 8.9e-4); link sets and node counts equal.  The
port also has to pass the reference's own assertions: the node ATE
against ground truth at least halves and ends under 0.25 m.
"""

import copy
import functools
import importlib.util
import pathlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_feature_graph_tpu import pipeline as jpipe
from ndt_feature_graph_tpu.config import (
    FeatureParams, FuserParams, GraphParams, NDTMapParams, SLAMParams,
)
from ndt_feature_graph_tpu.io import dataset as jds
from ndt_feature_graph_tpu.io import tum
from ndt_feature_graph_tpu_torch import interop
from ndt_feature_graph_tpu_torch import pipeline as tpipe
from ndt_feature_graph_tpu_torch.fusion.scan_driver import split_schedule
from ndt_feature_graph_tpu_torch.graph import node as node_mod
from ndt_feature_graph_tpu_torch.graph import sparse_direct
from ndt_feature_graph_tpu_torch.graph.slam import NDTFeatureGraphSLAM
from ndt_feature_graph_tpu_torch.io.dataset import Sequence

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "make_torch_port_fixture",
    ROOT / "examples" / "make_torch_port_fixture.py")
fixture_gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixture_gen)

ATOL = 2e-3
OFFLINE = SLAMParams(
    fuser=FuserParams(
        ndt=NDTMapParams(resolution=0.5, size_x=40.0, size_y=40.0,
                         sensor_range=15.0, max_points_per_scan=512,
                         max_cells=512),
        features=FeatureParams(num_beams=360, max_range=15.0),
        force_odom_as_est=True,
    ),
    graph=GraphParams(new_node_transl_dist=3.0, max_nodes=24,
                      valid_max_dist=3.0, valid_max_angular_dist=0.6,
                      valid_max_score=0.2),
)
ONLINE = OFFLINE.replace(
    graph=OFFLINE.graph.replace(online_loop_closure=True))
# The port runs on its own dataclasses.
T_OFFLINE = interop.params_from_jax(OFFLINE)
T_ONLINE = interop.params_from_jax(ONLINE)


@functools.lru_cache(maxsize=None)
def _seq():
    traj = jds.loop_trajectory(100, radius=5.0)
    seq = jds.simulate_sequence(
        jax.random.PRNGKey(43), traj, num_beams=360, max_range=15.0,
        odom_noise=(0.004, 0.004, 0.002))
    seq = seq._replace(odom=seq.odom + jnp.array([0.0, 0.0, 0.0035]))
    return jax.tree.map(np.asarray, seq)


def _tseq():
    s = _seq()
    return Sequence(*(torch.tensor(getattr(s, k))
                      for k in ("ranges", "hit", "odom", "gt")))


@functools.lru_cache(maxsize=None)
def _gated():
    """Gated odometry (as run_slam sees it) and each node's scan index."""
    s = _seq()
    keep_idx, keep_acc = tpipe.gate_scans(s.odom, OFFLINE.min_incr_dist,
                                          OFFLINE.min_incr_rot)
    odom_g = np.concatenate([np.zeros((1, 3), np.float32),
                             np.stack(keep_acc)])
    gp = OFFLINE.graph
    split = split_schedule(odom_g[1:], 0.0, 0, gp.new_node_transl_dist,
                           gp.max_nodes, 4)[0]
    return odom_g, [0] + [keep_idx[i] for i in np.flatnonzero(split)]


def _node_ate(node_T):
    gt = _seq().gt[_gated()[1]]
    return tum.ate_rmse(node_T, gt[:len(node_T)])


@functools.lru_cache(maxsize=None)
def _jax_offline():
    slam, _ = jpipe.run_slam(OFFLINE, _seq(), seed=0)
    before = np.stack(slam.node_T)
    n_pairs = int(np.asarray(slam.candidate_pairs()[2]).sum())
    out, links, keeps = fixture_gen.record_offline(slam)
    return slam, before, out, links, keeps[-1], n_pairs


@functools.lru_cache(maxsize=None)
def _offline_replay():
    _, _, _, _, _, n_pairs = _jax_offline()
    return fixture_gen.replay_ransac_draws(
        0, _gated()[0], OFFLINE,
        pair_counts=fixture_gen.offline_pair_counts(
            n_pairs, OFFLINE.graph.link_batch_size))


@functools.lru_cache(maxsize=None)
def _port_offline():
    rep = _offline_replay()
    slam, stats = tpipe.run_slam(T_OFFLINE, _tseq(), seed=0,
                                 ransac_u=torch.tensor(rep.scan_u),
                                 pair_u=list(rep.pair_u))
    before = np.stack(slam.node_T)
    out = slam.optimize_offline().numpy()
    return slam, before, out, stats


@functools.lru_cache(maxsize=None)
def _jax_online():
    cls = fixture_gen.recording_slam_class()
    with mock.patch.object(jpipe, "NDTFeatureGraphSLAM", cls):
        slam, _ = jpipe.run_slam(ONLINE, _seq(), seed=0)
    return slam, fixture_gen.replay_ransac_draws(
        0, _gated()[0], ONLINE,
        lc_splits=fixture_gen.lc_splits_of(slam.key_log))


@functools.lru_cache(maxsize=None)
def _port_online():
    _, rep = _jax_online()
    slam, _ = tpipe.run_slam(T_ONLINE, _tseq(), seed=0,
                             ransac_u=torch.tensor(rep.scan_u),
                             pair_u=list(rep.pair_u))
    return slam


def test_offline_loop_closure_matches_jax():
    jslam, jbefore, jout, jlinks, jkeep, _ = _jax_offline()
    tslam, tbefore, tout, stats = _port_offline()
    assert len(tslam.nodes) == len(jslam.nodes) == stats["n_nodes"] >= 8
    np.testing.assert_allclose(tbefore, jbefore, atol=ATOL)
    ls = tslam.offline_links
    np.testing.assert_array_equal(ls.ref.numpy(), jlinks.ref)
    np.testing.assert_array_equal(ls.mov.numpy(), jlinks.mov)
    np.testing.assert_array_equal(ls.mask.numpy(), jlinks.mask)
    np.testing.assert_array_equal(tslam.offline_keep, jkeep)
    assert jkeep.sum() >= 3
    np.testing.assert_allclose(ls.T.numpy()[jkeep], jlinks.T[jkeep],
                               atol=ATOL)
    np.testing.assert_allclose(tout, jout, atol=ATOL)
    np.testing.assert_allclose(np.stack(tslam.node_T), jout, atol=ATOL)


def test_solve_links_on_jax_links_matches_jax():
    """The fixpoint loop alone (validate -> solve, graduated schedule) on
    the reference's own LinkSet and initial poses: the same kept set,
    poses atol 1e-4 (float32 LU solves on both sides)."""
    _, jbefore, jout, jlinks, jkeep, _ = _jax_offline()
    tslam = copy.copy(_port_offline()[0])
    tslam.node_T = [t.copy() for t in jbefore]
    out = tslam.solve_links(interop.link_set_from_jax(jlinks, "cpu")).numpy()
    np.testing.assert_array_equal(tslam.offline_keep, jkeep)
    np.testing.assert_allclose(out, jout, atol=1e-4)


def test_optimize_offline_on_the_jax_graph_matches_jax():
    """optimize_offline on the reference's own frozen graph (node bank,
    poses before the solve, odometry edges) carried over by
    interop.graph_from_jax, the bank through the npz layout of
    make_torch_port_fixture.flatten_tree / interop.tree_from_flat, with
    the reference's pair draws: the same LinkSet mask and kept set, kept
    links' poses and the optimized node poses atol ATOL."""
    from ndt_feature_graph_tpu.graph import node as jnode

    jslam, jbefore, jout, jlinks, jkeep, _ = _jax_offline()
    flat = fixture_gen.flatten_tree(
        jax.tree.map(np.asarray, jnode.stack_nodes(jslam.nodes)), "bank")
    edges = [(i, j, np.asarray(rel), np.asarray(cov))
             for (i, j, rel, cov) in jslam.odom_edges]
    tslam = interop.graph_from_jax(
        T_OFFLINE, interop.tree_from_flat(flat, "bank"), jbefore, edges,
        device="cpu")
    assert tslam.device == torch.device("cpu")
    tslam.pair_u = list(_offline_replay().pair_u)
    out = tslam.optimize_offline().numpy()
    ls = tslam.offline_links
    np.testing.assert_array_equal(ls.mask.numpy(), jlinks.mask)
    np.testing.assert_array_equal(tslam.offline_keep, jkeep)
    np.testing.assert_allclose(ls.T.numpy()[jkeep], jlinks.T[jkeep],
                               atol=ATOL)
    np.testing.assert_allclose(out, jout, atol=ATOL)


def test_offline_loop_closure_halves_node_ate():
    _, _, jout, _, _, _ = _jax_offline()
    _, before, out, _ = _port_offline()
    err_before, err_after = _node_ate(before), _node_ate(out)
    print("node ATE before/after (port, JAX after):", err_before,
          err_after, _node_ate(jout))
    assert err_after < 0.25, (err_before, err_after)
    assert err_after < err_before * 0.5, (err_before, err_after)


def test_online_loop_closure_matches_jax():
    jslam, _ = _jax_online()
    tslam = _port_online()
    assert len(tslam.nodes) == len(jslam.nodes)
    assert [l[:2] for l in tslam.loop_links] == [
        l[:2] for l in jslam.loop_links]
    assert len(tslam.loop_links) >= 1
    np.testing.assert_allclose(np.stack(tslam.trajectory),
                               np.stack(jslam.trajectory), atol=ATOL)
    np.testing.assert_allclose(np.stack(tslam.node_T),
                               np.stack(jslam.node_T), atol=ATOL)
    assert tpipe.evaluate(tslam, _tseq()) == pytest.approx(
        jpipe.evaluate(jslam, _seq()), abs=ATOL)


def test_online_loop_closure_halves_node_ate():
    """Against the same run without loop closure (whose nodes are the
    offline run's nodes before optimization: odometry is the estimate)."""
    _, before, _, _ = _port_offline()
    err_off = _node_ate(before)
    err_on = _node_ate(np.stack(_port_online().node_T))
    print("node ATE without/with online LC (port):", err_off, err_on)
    assert err_on < 0.25, (err_off, err_on)
    assert err_on < err_off * 0.5, (err_off, err_on)


def test_update_per_scan_matches_the_chunked_driver():
    """`update` scan by scan (the reference's per-scan API) over the
    first 75 scans, four online loop-closure proposals and the first
    accepted link included, against the reference's chunked trajectory.
    The two drivers log one entry differently in the reference itself:
    at a split scan whose proposal was accepted, update() logs the
    solved new node origin, the chunked driver the pose before the solve
    (measured: 0.34 m apart at scan 72).  That entry is left out."""
    jslam, rep = _jax_online()
    s, odom_g = _tseq(), torch.tensor(_gated()[0])
    slam = NDTFeatureGraphSLAM(T_ONLINE, seed=0)
    slam.pair_u = list(rep.pair_u)
    slam.initialize(s.gt[0], torch.zeros(3), s.ranges[0], s.hit[0])
    solved = []
    for t in range(1, 75):
        n_links = len(slam.loop_links)
        slam.update(odom_g[t], s.ranges[t], s.hit[t],
                    u=torch.tensor(rep.scan_u[t - 1]))
        if len(slam.loop_links) > n_links:
            solved.append(t)
            np.testing.assert_allclose(slam.trajectory[-1], slam.current_T)
    assert len(rep.pair_u) - len(slam.pair_u) == 4 and solved == [72]
    assert [l[:2] for l in slam.loop_links] == [jslam.loop_links[0][:2]]
    keep = np.setdiff1d(np.arange(75), solved)
    np.testing.assert_allclose(np.stack(slam.trajectory)[keep],
                               np.stack(jslam.trajectory)[keep], atol=ATOL)


def test_unported_options_raise():
    """The options the port does not run raise instead of taking another
    path; those ported since run: the segment-Schur solve (solver="direct",
    and "auto" beyond solver_dense_max_nodes) and grouped link proposals
    (tests/test_torch_sparse_solvers.py holds both to JAX), adaptive
    RANSAC (tests/test_torch_pairwise.py) and the rolling map."""
    tslam = _port_offline()[0]
    node_T = torch.tensor(np.stack(tslam.node_T))
    edges = tslam._edges_from(None, None)
    n = node_T.shape[0]
    for gp in (T_OFFLINE.graph.replace(solver="direct"),
               T_OFFLINE.graph.replace(solver_dense_max_nodes=4)):
        got, chi2 = tslam._solve(gp, node_T, edges)
        ref, _ = sparse_direct.optimize_direct(
            node_T, edges, sparse_direct.make_segments(
                n, edges, gp.solver_max_seg_len),
            prior_information=gp.prior_information,
            iterations=gp.gn_iterations, damping=gp.gn_damping,
            robust_kernel=gp.robust_kernel, robust_delta=gp.robust_delta)
        np.testing.assert_array_equal(got.numpy(), ref.numpy())
        assert np.isfinite(float(chi2))
    tslam.params = T_OFFLINE.replace(graph=T_OFFLINE.graph.replace(
        link_group_nodes=8, link_batch_size=4))
    pair_u, tslam.pair_u = tslam.pair_u, None
    try:
        stacked = node_mod.stack_nodes(tslam.nodes)
        pairs = tslam.candidate_pairs()
        ls = tslam._propose_links(stacked, *pairs)
        for got, want in zip((ls.ref, ls.mov), pairs[:2]):
            np.testing.assert_array_equal(got.numpy(), want.numpy())
        assert not (ls.mask & ~pairs[2]).any() and ls.mask.any()
    finally:
        tslam.params, tslam.pair_u = T_OFFLINE, pair_u
    # ransac_adaptive is ported: the same two calls run.
    adaptive = T_OFFLINE.fuser.replace(
        features=T_OFFLINE.fuser.features.replace(ransac_adaptive=True))
    slam = NDTFeatureGraphSLAM(T_OFFLINE.replace(fuser=adaptive))
    s = _tseq()
    slam.initialize(s.gt[0], torch.zeros(3), s.ranges[0], s.hit[0])
    slam.update(s.odom[1], s.ranges[1], s.hit[1])
    assert np.isfinite(np.asarray(slam.trajectory[-1])).all()
    # rolling_map is ported: the same two calls run.
    slam = NDTFeatureGraphSLAM(T_OFFLINE.replace(
        fuser=T_OFFLINE.fuser.replace(rolling_map=True)))
    slam.initialize(s.gt[0], torch.zeros(3), s.ranges[0], s.hit[0])
    slam.update(s.odom[1], s.ranges[1], s.hit[1])
    assert np.isfinite(np.asarray(slam.trajectory[-1])).all()
