"""Parity of the port's fuser, feature fuser and node bookkeeping with the
JAX reference, on state carried across by `interop`: the JAX side runs
`initialize` and its updates, each JAX state goes through
`jax.tree.map(np.asarray, ...)`, and both sides update that same state
with the same scan.

Tolerances.  Grid statistics and tables rtol 1e-5 / atol 1e-5 (the
covariance rows cancel).  Poses: fuser.update's Tnow atol 1e-5 after
the first and the second scan (measured 8.3e-6 and 9.5e-6).
feature_fuser.update adds the port's own detect/describe/RANSAC, whose
feature points differ from the reference's by float32 trigonometry ulps
(tests/test_torch_features.py); the stiff paired-feature term passes
that on to the pose, so Tnow is held to 3e-5 there (measured 2.0e-5).
Trial counts are equal on both steps of feature_fuser.update and on the
first of fuser.update.  On the second fuser step the LM stop test (an
accepted step improving f by at most delta_score = 1e-4, about seven
float32 ulps at |f| ~ 200) fires at rounding noise: the port stops after
3 trials, the reference after 11, at poses 9.5e-6 apart, so there only
`converged` is compared.  The map then takes the scan at these poses:
points 15 m out move by up to ~2e-4, so the packed tables are held to
1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_feature_graph_tpu.config import (
    FeatureParams, FuserParams, NDTMapParams,
)
from ndt_feature_graph_tpu.core import se2 as jse2
from ndt_feature_graph_tpu.features.descriptor import descriptor_dim
from ndt_feature_graph_tpu.fusion import feature_fuser as jff
from ndt_feature_graph_tpu.fusion import fuser as jfu
from ndt_feature_graph_tpu.graph import node as jnode
from ndt_feature_graph_tpu.io import dataset as jds
from ndt_feature_graph_tpu_torch import interop
from ndt_feature_graph_tpu_torch.core import se2 as tse2
from ndt_feature_graph_tpu_torch.fusion import feature_fuser as tff
from ndt_feature_graph_tpu_torch.fusion import fuser as tfu
from ndt_feature_graph_tpu_torch.graph import node as tnode
from ndt_feature_graph_tpu_torch.ops import d2d as td2d

torch.set_num_threads(2)

P = FuserParams(
    ndt=NDTMapParams(resolution=0.5, size_x=40.0, size_y=40.0,
                     sensor_range=15.0, max_points_per_scan=360,
                     max_cells=512),
    features=FeatureParams(num_beams=360, max_range=15.0),
)
TP = interop.params_from_jax(P)      # the port's own dataclasses
FUSER_ATOL, FEATURE_FUSER_ATOL, TABLE_ATOL = 1e-5, 3e-5, 1e-4


def _np(x):
    return jax.tree.map(np.asarray, x)


def _t(x):
    return torch.tensor(np.asarray(x))


@functools.lru_cache(maxsize=None)
def _seq():
    traj = jds.loop_trajectory(28, radius=5.0)
    return jds.simulate_sequence(jax.random.PRNGKey(11), traj,
                                 num_beams=360, max_range=15.0)


@functools.lru_cache(maxsize=None)
def _jax_states():
    """JAX feature-fuser states after initialize and after scans 1, 2
    (per-scan RANSAC draws replayed from the state keys)."""
    seq = _seq()
    st = jff.initialize(P, jnp.zeros(3), jnp.zeros(3), seq.ranges[0],
                        seq.hit[0], jax.random.PRNGKey(3))
    states, infos, draws = [st], [], []
    for t in (1, 2):
        _, sub = jax.random.split(st.key)
        ki, _ = jax.random.split(sub)
        draws.append(jax.random.uniform(ki, (P.features.ransac_hypotheses,
                                             2)))
        st, info, _ = jff.update(st, P, seq.odom[t], seq.ranges[t],
                                 seq.hit[t])
        states.append(st)
        infos.append(info)
    return states, infos, draws


def _close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=rtol,
                               atol=atol)


def test_fuser_initialize_matches_jax():
    seq = _seq()
    pts, mask = jds.scan_to_points(seq.ranges[0], seq.hit[0])
    init = np.asarray([1.0, -0.5, 0.3], np.float32)
    js = jfu.initialize(P, jnp.asarray(init), jnp.zeros(3), pts, mask)
    ts = tfu.initialize(TP, _t(init), torch.zeros(3), _t(pts), _t(mask))
    np.testing.assert_array_equal(np.asarray(js.grid.count),
                                  ts.grid.count.numpy())
    _close(js.grid.origin, ts.grid.origin, 0, 0)
    _close(js.grid.psum, ts.grid.psum)
    _close(js.grid.occ, ts.grid.occ)
    _close(js.packed, ts.packed)
    assert int(ts.n_updates) == int(js.n_updates)


@pytest.mark.parametrize("step", [1, 2])
def test_fuser_update_matches_jax(step):
    """fuser.update from the reference's state before scan `step`, with
    the reference's scan points and feature pairs."""
    seq = _seq()
    states, _, _ = _jax_states()
    jst = states[step - 1]
    pts, mask, _, _, _, fsrc, ftgt, _ = jff._prepare_features(
        jst, P, seq.odom[step], seq.ranges[step], seq.hit[step])
    js, jinfo = jfu.update(jst.base, P, seq.odom[step], pts, mask, fsrc,
                           ftgt)
    ts, tinfo = tfu.update(
        interop.fuser_state_from_jax(_np(jst.base), "cpu"), TP, _t(seq.odom[step]),
        _t(pts), _t(mask), interop.cell_list_from_jax(_np(fsrc), "cpu"),
        interop.cell_list_from_jax(_np(ftgt), "cpu"))
    np.testing.assert_allclose(ts.Tnow.numpy(), np.asarray(js.Tnow),
                               rtol=0, atol=FUSER_ATOL)
    assert bool(tinfo.converged) == bool(jinfo.converged)
    assert bool(tinfo.fallback) == bool(jinfo.fallback)
    if step == 1:
        assert int(tinfo.iterations) == int(jinfo.iterations)
    np.testing.assert_array_equal(np.asarray(js.grid.count),
                                  ts.grid.count.numpy())
    _close(js.packed, ts.packed, atol=TABLE_ATOL)
    # The incremental table invariant holds on the port's own state.
    np.testing.assert_array_equal(
        ts.packed.numpy(),
        td2d.refresh_packed(ts.packed, ts.grid, TP.ndt,
                            torch.arange(P.ndt.grid_h * P.ndt.grid_w)
                            ).numpy())


@pytest.mark.parametrize("step", [1, 2])
def test_feature_fuser_update_matches_jax(step):
    """feature_fuser.update (detect + describe + RANSAC with the
    reference's draws + joint fusion) from the reference's state before
    scan `step`."""
    seq = _seq()
    states, infos, draws = _jax_states()
    ts = interop.feature_fuser_state_from_jax(_np(states[step - 1]),
                                              "cpu")
    ts, tinfo, _ = tff.update(ts, TP, _t(seq.odom[step]),
                              _t(seq.ranges[step]), _t(seq.hit[step]),
                              _t(draws[step - 1]))
    js, jinfo = states[step], infos[step - 1]
    np.testing.assert_allclose(ts.base.Tnow.numpy(),
                               np.asarray(js.base.Tnow), rtol=0,
                               atol=FEATURE_FUSER_ATOL)
    np.testing.assert_allclose(ts.prev_pose.numpy(),
                               np.asarray(js.prev_pose), rtol=0,
                               atol=FEATURE_FUSER_ATOL)
    assert bool(tinfo.converged) == bool(jinfo.converged)
    assert int(tinfo.iterations) == int(jinfo.iterations)
    np.testing.assert_array_equal(np.asarray(js.prev_feats.mask),
                                  ts.prev_feats.mask.numpy())


def test_check_params_rejects_unported_modes():
    tfu.check_params(TP.replace(rolling_map=True))     # ported
    with pytest.raises(ValueError):
        tfu.check_params(TP.replace(gather_window_cells=40,
                                   gather_block=True))
    tfu.check_params(TP.replace(gather_window_cells=76, gather_block=True))


def test_feature_map_and_freeze_node_match_jax():
    states, _, _ = _jax_states()
    st = states[2]
    cap, dd = 16, descriptor_dim(P.features)
    pose = jse2.compose(st.base.Tnow, st.base.sensor_pose)
    jb = jnode.empty_feature_map(cap, dd)
    tb = tnode.empty_feature_map(cap, dd, "cpu")
    tst = interop.feature_fuser_state_from_jax(_np(st), "cpu")
    for _ in range(3):                     # wraps the 16-slot ring
        jb = jnode.insert_features(jb, st.prev_feats, st.prev_desc, pose)
        tb = tnode.insert_features(tb, tst.prev_feats, tst.prev_desc,
                                   tse2.compose(tst.base.Tnow,
                                                tst.base.sensor_pose))
    np.testing.assert_array_equal(np.asarray(jb.write_idx),
                                  tb.write_idx.numpy())
    np.testing.assert_array_equal(np.asarray(jb.feats.mask),
                                  tb.feats.mask.numpy())
    _close(jb.feats.pts, tb.feats.pts)
    _close(jb.desc, tb.desc, 0, 0)

    node_T = np.asarray([2.0, 1.0, 0.5], np.float32)
    jn = jnode.freeze_node(P, jnp.asarray(node_T), st.base, jb)
    tn = tnode.freeze_node(TP, _t(node_T), tst.base, tb)
    got = interop.to_numpy(tn)
    m = np.asarray(jn.cells.mask)
    np.testing.assert_array_equal(m, got["cells"]["mask"])
    _close(np.asarray(jn.cells.means)[m], _t(got["cells"]["means"][m]))
    _close(np.asarray(jn.cells.covs)[m], _t(got["cells"]["covs"][m]))
    for name in ("T", "Tlocal_odom", "Tlocal_fuse", "occ_origin", "occ"):
        _close(getattr(jn, name), _t(got[name]), 0, 0)
    _close(jn.target.packed, _t(got["target"]["packed"]), 0, 0)
    back = interop.node_from_jax(got, "cpu")
    assert torch.equal(back.target.packed, tn.target.packed)
