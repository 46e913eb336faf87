"""Whole-slice parity of the port's online graph SLAM with the JAX
reference: `NDTFeatureGraphSLAM.initialize` + `run_sequence_device` over
the test_graph_chunked.py geometry (40x40 m, 360 beams, 15 m range, a
28-scan loop, a node split every 3 m), with the reference's RANSAC draws
replayed from its key chain.

Tolerances as test_graph_chunked.py: trajectory and node poses atol 1e-3
(the joint cost is flat to float32 rounding over ~1e-4 m, so reordered
sums drift the chained poses by that much: measured 0.95 mm at most);
node count equal.
The JAX side runs once on its flat gather path and once on its canonical
win-block table (`gather_block=True, gather_window_cells=76`), which the
port replaces by reading the packed table directly.
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_feature_graph_tpu.config import (
    FeatureParams, FuserParams, GraphParams, NDTMapParams, SLAMParams,
)
from ndt_feature_graph_tpu.graph.slam import NDTFeatureGraphSLAM as JSLAM
from ndt_feature_graph_tpu.io import dataset as jds
from ndt_feature_graph_tpu_torch import interop
from ndt_feature_graph_tpu_torch.fusion.scan_driver import split_schedule
from ndt_feature_graph_tpu_torch.graph.slam import NDTFeatureGraphSLAM as TSLAM

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL = 1e-3


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


fixture_gen = _load("make_torch_port_fixture",
                    ROOT / "examples" / "make_torch_port_fixture.py")
chip_smoke = _load("chip_smoke", ROOT / "chip_smoke.py")


def _params(block: bool) -> SLAMParams:
    fp = FuserParams(
        ndt=NDTMapParams(resolution=0.5, size_x=40.0, size_y=40.0,
                         sensor_range=15.0, max_points_per_scan=360,
                         max_cells=512),
        features=FeatureParams(num_beams=360, max_range=15.0),
    )
    if block:
        fp = fp.replace(gather_block=True, gather_window_cells=76)
    return SLAMParams(fuser=fp, graph=GraphParams(new_node_transl_dist=3.0,
                                                  max_nodes=16))


@functools.lru_cache(maxsize=None)
def _seq():
    traj = jds.loop_trajectory(28, radius=5.0)
    return jax.tree.map(np.asarray, jds.simulate_sequence(
        jax.random.PRNGKey(11), traj, num_beams=360, max_range=15.0))


@functools.lru_cache(maxsize=None)
def _jax_run(block: bool):
    seq = _seq()
    slam = JSLAM(_params(block), seed=0)
    slam.initialize(jnp.asarray(seq.gt[0]), jnp.zeros(3),
                    jnp.asarray(seq.ranges[0]), jnp.asarray(seq.hit[0]))
    slam.run_sequence_device(jnp.asarray(seq.odom), jnp.asarray(seq.ranges),
                             jnp.asarray(seq.hit))
    return slam


@functools.lru_cache(maxsize=None)
def _draws():
    return fixture_gen.replay_ransac_draws(0, _seq().odom, _params(False))


@functools.lru_cache(maxsize=None)
def _port_run(block: bool):
    seq = _seq()
    t = lambda x, dt=torch.float32: torch.tensor(x, dtype=dt)  # noqa
    slam = TSLAM(interop.params_from_jax(_params(block)), seed=0)
    slam.initialize(t(seq.gt[0]), torch.zeros(3), t(seq.ranges[0]),
                    t(seq.hit[0], torch.bool))
    slam.run_sequence_device(t(seq.odom), t(seq.ranges),
                             t(seq.hit, torch.bool),
                             ransac_u=torch.tensor(_draws()[0]))
    return slam


@pytest.mark.parametrize("block", [False, True], ids=["flat", "win_block"])
def test_run_sequence_device_matches_jax(block):
    ref, got = _jax_run(block), _port_run(block)
    assert len(ref.nodes) >= 1
    assert len(got.nodes) == len(ref.nodes)
    assert len(got.trajectory) == len(ref.trajectory) == 28
    np.testing.assert_allclose(np.stack(got.trajectory),
                               np.stack(ref.trajectory), atol=ATOL)
    np.testing.assert_allclose(np.stack(got.node_T), np.stack(ref.node_T),
                               atol=ATOL)
    # An edge is the split scan's pose in its node's frame: its error
    # adds the node pose's and the scan's, each within ATOL.
    for eg, er in zip(got.odom_edges, ref.odom_edges):
        assert eg[:2] == er[:2]
        np.testing.assert_allclose(eg[2], np.asarray(er[2]), atol=2 * ATOL)
        np.testing.assert_allclose(eg[3], np.asarray(er[3]), atol=ATOL)
    assert got.distance_moved == pytest.approx(ref.distance_moved, abs=1e-5)
    assert got.n_updates_in_node == ref.n_updates_in_node
    np.testing.assert_allclose(got.global_pose(), ref.global_pose(),
                               atol=ATOL)


def test_frozen_nodes_match_jax():
    """The frozen node payloads, up to what the trajectory's sub-
    millimetre drift does to a map: a point that lies that close to a
    cell edge lands in the neighbouring cell, which moves that cell's
    mean by centimetres and its occupancy by a whole hit or miss.  So
    per node: the valid flags agree on >= 98% of the cells valid on
    either side (measured: all but 1 of ~150), means to 5 mm and
    covariances to 1e-3 on >= 95% of the cells valid on both (measured:
    all but 3 of 95), occupancy to 1e-3 on >= 97% of the observed cells
    (measured 99%), and the feature maps, which bin nothing, everywhere."""
    ref, got = _jax_run(False), _port_run(False)
    for nr, ng in zip(ref.nodes, got.nodes):
        np.testing.assert_allclose(ng.T.numpy(), np.asarray(nr.T), atol=ATOL)
        a, b = np.asarray(nr.target.packed), ng.target.packed.numpy()
        va, vb = a[:, 5] > 0.5, b[:, 5] > 0.5
        assert (va == vb)[va | vb].mean() >= 0.98
        both = va & vb
        same = ((np.abs(a[both, :2] - b[both, :2]).max(-1) <= 5e-3)
                & (np.abs(a[both, 2:5] - b[both, 2:5]).max(-1) <= ATOL))
        assert same.mean() >= 0.95, same.mean()
        oa, ob = np.asarray(nr.occ), ng.occ.numpy()
        seen = (oa != 0) | (ob != 0)
        assert (np.abs(oa - ob)[seen] <= ATOL).mean() >= 0.97
        fm = np.asarray(nr.feats.mask)
        np.testing.assert_array_equal(ng.feats.mask.numpy(), fm)
        np.testing.assert_allclose(ng.feats.pts.numpy()[fm],
                                   np.asarray(nr.feats.pts)[fm], atol=ATOL)
        np.testing.assert_allclose(ng.desc.numpy()[fm],
                                   np.asarray(nr.desc)[fm], atol=ATOL)


def test_ransac_key_replay_matches_jax_keys():
    """The replayed key chain against the reference's own: the fuser key
    after every scan of the per-scan host loop (`update`, the same PRNG
    stream as run_sequence_device), and the final keys of the device
    run."""
    seq = _seq()
    p = _params(False)
    draws, keys = _draws()[:2]
    assert draws.shape == (27, p.fuser.features.ransac_hypotheses, 2)
    ref = JSLAM(p, seed=0)
    ref.initialize(jnp.asarray(seq.gt[0]), jnp.zeros(3),
                   jnp.asarray(seq.ranges[0]), jnp.asarray(seq.hit[0]))
    for t in range(1, 28):
        ref.update(jnp.asarray(seq.odom[t]), jnp.asarray(seq.ranges[t]),
                   jnp.asarray(seq.hit[t]))
        np.testing.assert_array_equal(np.asarray(ref.state.key),
                                      keys[t - 1], f"scan {t}")
    dev = _jax_run(False)
    np.testing.assert_array_equal(np.asarray(dev.state.key), keys[-1])
    assert len(ref.nodes) == len(dev.nodes)


def test_split_schedule_matches_jax_splits():
    """The host-side split/feature-map schedule against the reference's
    own counters after the device run."""
    seq = _seq()
    gp = _params(False).graph
    split, insert, dist, cnt, n = split_schedule(
        seq.odom[1:], 0.0, 0, gp.new_node_transl_dist, gp.max_nodes, 4)
    ref = _jax_run(False)
    assert n == len(ref.nodes) == int(split.sum())
    assert cnt == ref.n_updates_in_node
    assert dist == pytest.approx(ref.distance_moved, abs=1e-6)
    assert not (split & insert).any()
    # At node capacity the schedule stops splitting.
    split1, _, _, _, n1 = split_schedule(seq.odom[1:], 0.0, 0,
                                         gp.new_node_transl_dist, 1, 4)
    assert n1 == 0 and not split1.any()


def test_chip_smoke_runs_the_fixture_operating_point():
    """chip_smoke.py rebuilds bench.canonical_params() without JAX; the
    committed fixture records the parameters the JAX reference ran."""
    with np.load(ROOT / chip_smoke.FIXTURE_REL) as fx:
        sp = chip_smoke.canonical_slam_params(float(fx["split_m"]),
                                              int(fx["max_nodes"]))
        assert repr(sp) == str(fx["params_repr"])
        t = fx["ranges"].shape[0]
        assert fx["ransac_u"].shape == (
            t - 1, sp.fuser.features.ransac_hypotheses, 2)
        assert fx["traj"].shape == (t, 3)
        assert int(fx["max_cells"]) <= sp.fuser.match_cell_budget
