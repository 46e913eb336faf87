"""Parity of the port's chunked graph driver (fusion/scan_driver.py:
run_graph_chunk) with the JAX reference's, at tests/test_graph_chunked.py's
geometry (40x40 m, 360 beams, 15 m range, the 28-scan loop of radius 5 m,
K = 8 scans a chunk), both starting from the reference's state after
`NDTFeatureGraphSLAM.initialize`, with the reference's RANSAC draws
replayed from its fuser key.

Three chunks, one parametrised test: no split (split_dist infinite, as
the reference's orchestrator passes at node capacity), a split at the
third scan (3 m, every scan moves ~1.12 m) after a feature-map insert,
and a padded last chunk (five active rows, three zero rows).

Tolerances: meta atol 1e-3; trajectory atol 1e-3 (test_graph_chunked.py's,
as tests/test_torch_slam.py: reordered float32 sums move the chained
poses by ~1e-4 m) and scores rtol 2e-4 (the port's score of scan 2 is
1.10e-4 off while its pose is 1.5e-4 m off; the reference's own score
of scan 2 moves 3.1e-5 under +-1e-6 m of odometry, 4.2e-4 under -2e-6 m
and 1.7e-4 under -3e-6 m: examples/measure_chunk_spread.py --reference).  On the rows where the
reference itself moves by more than that under a +-1e-6 m change of
the chunk's odometry, the row's tolerance gains twice that spread (two
samples of it: twice covers a move in another direction).  Measured on
the CPU: the trajectory of scan 5 (the reference moves it by 1.45 mm,
the port differs by 1.56 mm) and of scan 8 (1.007 mm, the port 0.93
mm); the scores of scan 5 (0.13%, the port 0.12%) and of scans 6-8 of
the unsplit chunk (0.79%, 0.05%, 0.05%; the port 0.77%, 0.02%, 0.07%).
Padding rows repeat the last processed row, on both sides.
Against the port's own run_graph_sequence over the
same scans, every tensor is equal bit for bit: the per-scan step is the
same code.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_feature_graph_tpu.config import (
    FeatureParams, FuserParams, GraphParams, NDTMapParams, SLAMParams,
)
from ndt_feature_graph_tpu.fusion import scan_driver as jsd
from ndt_feature_graph_tpu.graph.slam import NDTFeatureGraphSLAM as JSLAM
from ndt_feature_graph_tpu.io import dataset as jds
from ndt_feature_graph_tpu_torch import interop
from ndt_feature_graph_tpu_torch.core import se2
from ndt_feature_graph_tpu_torch.fusion import scan_driver as tsd
from ndt_feature_graph_tpu_torch.graph import node as tnode
from ndt_feature_graph_tpu_torch.graph.node import map_tensors

torch.set_num_threads(2)
K = 8
FM_INCR = 4
ATOL = 1e-3
SCORE_RTOL = 2e-4

SP = SLAMParams(
    fuser=FuserParams(
        ndt=NDTMapParams(resolution=0.5, size_x=40.0, size_y=40.0,
                         sensor_range=15.0, max_points_per_scan=360,
                         max_cells=512),
        features=FeatureParams(num_beams=360, max_range=15.0),
    ),
    graph=GraphParams(new_node_transl_dist=3.0, max_nodes=16),
)
P = SP.fuser
TP = interop.params_from_jax(P)

# case: (split_dist, update_count, active rows)
CASES = {
    "no_split": (math.inf, 1, K),
    "split": (3.0, 2, K),
    "padded": (math.inf, 1, 5),
}


@functools.lru_cache(maxsize=None)
def _start():
    """The loop, and the reference's state, feature map and fuser key
    after initialize on scan 0."""
    seq = jax.tree.map(np.asarray, jds.simulate_sequence(
        jax.random.PRNGKey(11), jds.loop_trajectory(28, radius=5.0),
        num_beams=360, max_range=15.0))
    slam = JSLAM(SP, seed=0)
    slam.initialize(jnp.asarray(seq.gt[0]), jnp.zeros(3),
                    jnp.asarray(seq.ranges[0]), jnp.asarray(seq.hit[0]))
    return seq, slam.state, slam.fmap


def _chunk_inputs(n_active):
    """Scans 1..n_active, zero-padded to K rows, and the active flags."""
    seq = _start()[0]
    pad = K - n_active

    def rows(x):
        x = x[1:1 + n_active]
        return np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])

    return (rows(seq.odom.astype(np.float32)),
            rows(seq.ranges.astype(np.float32)), rows(seq.hit),
            np.arange(K) < n_active)


def _draws(key, n):
    """The reference fuser's draws for n scans from its key: each scan
    splits the key and draws from the first half of a split of its
    subkey (feature_fuser.update -> ransac.match_sets)."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(
            jax.random.split(sub)[0], (P.features.ransac_hypotheses, 2))))
    return np.stack(out).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_chunk(case, eps=0.0):
    split_dist, cnt, n_active = CASES[case]
    _, state, fmap = _start()
    odom, ranges, hit, active = _chunk_inputs(n_active)
    odom[:n_active, :2] += np.float32(eps)
    out = jsd.run_graph_chunk(
        P, state, fmap, jnp.float32(0.0), jnp.int32(cnt), jnp.asarray(odom),
        jnp.asarray(ranges), jnp.asarray(hit), jnp.asarray(active),
        jnp.float32(split_dist), fm_incr=FM_INCR)
    return jax.tree.map(np.asarray, out)


def _port_start():
    _, state, fmap = _start()
    return (interop.feature_fuser_state_from_jax(jax.tree.map(np.asarray,
                                                              state), "cpu"),
            interop.feature_map_from_jax(jax.tree.map(np.asarray, fmap),
                                         "cpu"))


def _flat(obj):
    leaves = []
    map_tensors(lambda x: leaves.append(x) or x, obj)
    return leaves


def _assert_same_bits(a, b):
    la, lb = _flat(a), _flat(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


@pytest.mark.parametrize("case", list(CASES))
def test_run_graph_chunk_matches_jax_and_run_graph_sequence(case):
    split_dist, cnt, n_active = CASES[case]
    _, jstate, _ = _start()
    odom, ranges, hit, active = _chunk_inputs(n_active)
    u = torch.tensor(_draws(jstate.key, K))
    t = torch.tensor
    st0, fm0 = _port_start()
    st, fm, traj, scores, meta = tsd.run_graph_chunk(
        TP, st0, fm0, 0.0, cnt, t(odom), t(ranges), t(hit), t(active),
        split_dist, fm_incr=FM_INCR, ransac_u=u)

    j_st, j_fm, j_traj, j_scores, j_meta = _jax_chunk(case)
    n_proc = int(j_meta[2])
    assert meta.dtype == torch.float32 and meta.shape == (4,)
    np.testing.assert_allclose(meta.numpy(), j_meta, atol=ATOL)
    np.testing.assert_array_equal(meta.numpy()[2:], j_meta[2:])
    assert (int(j_meta[3]) >= 0) == (case == "split")
    # The reference's own spread, per row, counted where it exceeds the
    # tolerance.
    moved = [_jax_chunk(case, e) for e in (1e-6, -1e-6)]
    assert all(int(m[4][2]) == n_proc for m in moved)
    d_traj = np.max([np.abs(m[2] - j_traj) for m in moved], 0)[:n_proc]
    d_score = np.max([np.abs(m[3] - j_scores) for m in moved], 0)[:n_proc]
    traj_tol = ATOL + np.where(d_traj > ATOL, 2 * d_traj, 0.0)
    score_tol = SCORE_RTOL * np.abs(j_scores[:n_proc])
    score_tol = score_tol + np.where(d_score > score_tol, 2 * d_score, 0.0)
    assert np.all(np.abs(traj.numpy()[:n_proc] - j_traj[:n_proc]) <= traj_tol)
    assert np.all(np.abs(scores.numpy()[:n_proc] - j_scores[:n_proc])
                  <= score_tol)
    np.testing.assert_array_equal(j_traj[n_proc:], np.broadcast_to(
        j_traj[n_proc - 1], (K - n_proc, 3)))
    assert not scores[n_proc:].any() and not j_scores[n_proc:].any()
    assert np.all(np.abs(st.base.Tnow.numpy() - j_st.base.Tnow)
                  <= traj_tol[n_proc - 1])
    np.testing.assert_array_equal(fm.write_idx.numpy(), j_fm.write_idx)
    np.testing.assert_array_equal(fm.feats.mask.numpy(), j_fm.feats.mask)

    # The same scans through run_graph_sequence (the split, if any, then
    # frozen into its bank): the same bits.
    sl = slice(0, n_proc)
    st_s, fm_s, bank, _, _, _, traj_s, _, meta_s = tsd.run_graph_sequence(
        TP, st0, fm0, torch.zeros(3), 0.0, cnt, t(odom[sl]), t(ranges[sl]),
        t(hit[sl]), split_dist, max_nodes=64, fm_incr=FM_INCR,
        ransac_u=u[sl])
    assert torch.equal(traj_s, se2.compose(torch.zeros(3), traj[sl]))
    assert torch.equal(traj[n_proc:], traj[n_proc - 1].expand(K - n_proc, 3))
    if case == "split":
        assert meta_s[2] == 1
        _assert_same_bits(
            tnode.freeze_node(TP, torch.zeros(3), st.base, fm),
            tsd.unstack_bank(bank, 1)[0])
    else:
        assert meta_s == (float(meta[0]), int(meta[1]), 0)
        _assert_same_bits(st, st_s)
        _assert_same_bits(fm, fm_s)
