"""Parity of the port's whole Newton-trial objective and of its plain
D2D registration with the JAX reference, on the CPU.

`cuda_kernels.newton_objective` is the one entry the fuser calls per
Newton trial; on CPU tensors it is `newton_objective_reference`, the sum
of the plain window, paired-feature and odometry terms.  It is held to
the JAX sum of `d2d_analytic.fgh_dense_flat + fgh_paired +
fgh_mahalanobis` (fusion/fuser.py:fgh_fn) with each term switched off in
turn, at the tolerances test_torch_d2d.py states for the terms (f rtol
1e-4; g, H rtol 2e-3: sums over thousands of pairs in another order).

`d2d.match_d2d` / `covariance_d2d` run the window term alone against the
packed table; the JAX ones run it against the DenseTarget of the same
grid.  The pose is held to 2e-5 and the trial count to the reference's
(the real-cost Newton case of test_torch_d2d.py), the score to the
window term's 1e-4 (without the odometry term the minimum is less sharp:
measured 2.5e-5 relative at poses 2e-5 apart); the covariance to 2e-3
of its largest entry (Jacobi rotations against LAPACK's eigh on a
Hessian that agrees to 2e-3).

The kernel itself needs a CUDA card: tests/test_torch_cuda.py.
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
from ndt_feature_graph_tpu.fusion import feature_fuser as jff
from ndt_feature_graph_tpu.fusion import fuser as jfu
from ndt_feature_graph_tpu.io import dataset as jds
from ndt_feature_graph_tpu.ops import d2d as jd2d
from ndt_feature_graph_tpu.ops import d2d_analytic as jda
from ndt_feature_graph_tpu_torch import interop
from ndt_feature_graph_tpu_torch.fusion import fuser as tfu
from ndt_feature_graph_tpu_torch.ops import cuda_kernels
from ndt_feature_graph_tpu_torch.ops import d2d as td2d

torch.set_num_threads(2)

P = FuserParams(
    ndt=NDTMapParams(resolution=0.5, size_x=40.0, size_y=40.0,
                     sensor_range=15.0, max_points_per_scan=360,
                     max_cells=512),
    features=FeatureParams(num_beams=360, max_range=15.0),
)
M = P.matcher
TP = interop.params_from_jax(P)      # the port's own dataclasses
TM = TP.matcher
H_, W_ = P.ndt.grid_h, P.ndt.grid_w
RES = P.ndt.resolution
TERMS = ["all", "no_window", "no_features", "no_odometry", "window_only",
         "none"]


def _np(x):
    return jax.tree.map(np.asarray, x)


@functools.lru_cache(maxsize=None)
def _case():
    """The reference's own inputs of the second scan's registration on
    the test loop: fuser state, source cells, predicted pose, feature
    pairs from its RANSAC, odometry information."""
    traj = jds.loop_trajectory(28, radius=5.0)
    seq = jds.simulate_sequence(jax.random.PRNGKey(11), traj,
                                num_beams=360, max_range=15.0)
    st = jff.initialize(P, jnp.zeros(3), jnp.zeros(3), seq.ranges[0],
                        seq.hit[0], jax.random.PRNGKey(3))
    pts, mask, _, _, _, fsrc, ftgt, _ = jff._prepare_features(
        st, P, seq.odom[1], seq.ranges[1], seq.hit[1])
    src, _ = jfu._build_local_cells(P, st.base.sensor_pose, pts, mask)
    T0 = jse2.compose(st.base.Tnow, seq.odom[1])
    Q = jfu._increment_information(P, seq.odom[1], T0)
    assert int(np.asarray(fsrc.mask & ftgt.mask).sum()) >= 3
    return st.base, src, T0, Q, fsrc, ftgt


def _torch_case():
    state, src, T0, Q, fsrc, ftgt = _case()
    cells = lambda c: interop.cell_list_from_jax(_np(c), "cpu")  # noqa: E731
    return (interop.fuser_state_from_jax(_np(state), "cpu"), cells(src),
            torch.tensor(np.asarray(T0)), torch.tensor(np.asarray(Q)),
            cells(fsrc), cells(ftgt))


def _jax_objective(d, window, features, odometry):
    state, src, T0, Q, fsrc, ftgt = _case()
    f, g, H = jnp.float32(0.0), jnp.zeros(3), jnp.zeros((3, 3))
    if window:
        a = jda.fgh_dense_flat(d, T0, src, state.packed, state.grid.origin,
                               0, H_, W_, RES, M)
        f, g, H = f + a[0], g + a[1], H + a[2]
    if features:
        a = jda.fgh_paired(d, T0, fsrc, ftgt, M)
        f, g, H = f + a[0], g + a[1], H + a[2]
    if odometry:
        a = jda.fgh_mahalanobis(d, Q)
        f, g, H = f + a[0], g + a[1], H + a[2]
    return f, g, H


def _switches(terms):
    return {"all": (True, True, True), "no_window": (False, True, True),
            "no_features": (True, False, True),
            "no_odometry": (True, True, False),
            "window_only": (True, False, False),
            "none": (False, False, False)}[terms]


def _port_args(window, features, odometry):
    tstate, tsrc, tT0, tQ, tfs, tft = _torch_case()
    return (tT0, tsrc if window else None, tstate.packed,
            tstate.grid.origin, H_, W_, RES, TM, tfs if features else None,
            tft if features else None, tQ if odometry else None)


@pytest.mark.parametrize("terms", TERMS)
def test_newton_objective_reference_matches_jax_sum(terms):
    window, features, odometry = _switches(terms)
    d = np.asarray([0.03, -0.05, 0.012], np.float32)
    ref = _jax_objective(jnp.asarray(d), window, features, odometry)
    got = cuda_kernels.newton_objective_reference(
        torch.tensor(d), *_port_args(window, features, odometry))
    f, g, H = (np.asarray(x, np.float64) for x in ref)
    np.testing.assert_allclose(float(got[0]), float(f), rtol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), g, rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), H, rtol=2e-3, atol=1e-3)
    if terms == "none":
        assert float(got[0]) == 0.0 and float(got[2].abs().max()) == 0.0
    else:
        assert float(np.abs(H).max()) > 0.0


@pytest.mark.parametrize("terms", TERMS)
def test_newton_objective_on_cpu_is_the_reference(terms):
    """On CPU tensors the entry is its plain version, bit for bit, and
    counts no launch."""
    args = _port_args(*_switches(terms))
    d = torch.tensor([0.01, -0.02, 0.003])
    cuda_kernels.reset_launch_counts()
    got = cuda_kernels.newton_objective(d, *args)
    ref = cuda_kernels.newton_objective_reference(d, *args)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert set(cuda_kernels.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("bf16_rows", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("terms", TERMS)
def test_batch_reference_equals_the_single_lane_reference(terms, bf16_rows):
    """newton_objective_batch_reference is newton_objective_reference
    lane by lane: three lanes with their own increment, pose, source
    list (lane 1 all masked), feature lists, odometry information and
    row offset into a stack of three tables (lane 2's shifted with its
    origin).  f to 1e-6 relative, g and H to 1e-5 of their largest entry
    (the lanes' sums run over the same pairs in the same order; the
    batched einsums may round differently)."""
    window, features, odometry = _switches(terms)
    tstate, tsrc, tT0, tQ, tfs, tft = _torch_case()
    hw = H_ * W_
    shifted = tstate.packed.reshape(H_, W_, 8).roll((3, -2), (0, 1))
    packed = torch.cat([tstate.packed, tstate.packed,
                        shifted.reshape(hw, 8)])
    origins = torch.stack([tstate.grid.origin, tstate.grid.origin,
                           tstate.grid.origin + RES * torch.tensor(
                               [2.0, -3.0])])
    offs = torch.arange(3) * hw
    d = torch.tensor([[0.03, -0.05, 0.012], [-0.02, 0.01, -0.004],
                      [0.0, 0.04, 0.02]])
    T0 = tT0 + torch.tensor([[0.0, 0.0, 0.0], [0.01, 0.0, 0.002],
                             [-0.02, 0.01, 0.0]])
    stack = lambda c: type(c)(*(torch.stack([x] * 3) for x in (  # noqa: E731
        c.means, c.covs, c.mask)))
    src, fs, ft = stack(tsrc), stack(tfs), stack(tft)
    src.mask[1] = False
    fs.means[2] += 0.01
    Q = torch.stack([tQ, 2.0 * tQ, tQ.T.contiguous()])
    lane = lambda c, i: type(c)(c.means[i], c.covs[i], c.mask[i])  # noqa
    got = cuda_kernels.newton_objective_batch_reference(
        d, T0, src if window else None, packed, origins, offs, H_, W_, RES,
        TM, fs if features else None, ft if features else None,
        Q if odometry else None, bf16_rows)
    for i in range(3):
        ref = cuda_kernels.newton_objective_reference(
            d[i], T0[i], lane(src, i) if window else None,
            packed[i * hw:(i + 1) * hw], origins[i], H_, W_, RES, TM,
            lane(fs, i) if features else None,
            lane(ft, i) if features else None,
            Q[i] if odometry else None, bf16_rows)
        np.testing.assert_allclose(float(got[0][i]), float(ref[0]),
                                   rtol=1e-6, atol=1e-6)
        for k in (1, 2):
            np.testing.assert_allclose(
                got[k][i].numpy(), ref[k].numpy(), rtol=0,
                atol=1e-5 * max(float(ref[k].abs().max()), 1e-3))
    if bf16_rows and window:
        plain = cuda_kernels.newton_objective_batch_reference(
            d, T0, src, packed, origins, offs, H_, W_, RES, TM, None, None,
            None, False)
        rounded = cuda_kernels.newton_objective_batch_reference(
            d, T0, src, packed, origins, offs, H_, W_, RES, TM, None, None,
            None, True)
        assert not torch.equal(plain[0], rounded[0])
        assert float(rounded[0][1]) == 0.0          # the all-masked lane


def test_newton_objective_rejects_bad_arguments():
    tT0, tsrc, packed, origin, *rest = _port_args(True, True, True)
    with pytest.raises(ValueError, match="go together"):
        cuda_kernels.newton_objective(
            torch.zeros(3), tT0, tsrc, packed, origin, H_, W_, RES, TM,
            feat_src=rest[-3])
    meta = torch.zeros(3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_kernels.newton_objective(meta, meta, None, None, None, H_, W_,
                                      RES, TM)


def test_fuser_update_sums_the_terms_in_the_reference_order():
    """fuser.update's objective on the CPU is the sum window + paired +
    odometry of the plain terms, as before the terms shared a launch:
    one registration from the reference's state lands within 1e-5 of the
    reference's pose with its trial count."""
    state, _, _, _, fsrc, ftgt = _case()
    tstate, _, _, _, tfs, tft = _torch_case()
    traj = jds.loop_trajectory(28, radius=5.0)
    seq = jds.simulate_sequence(jax.random.PRNGKey(11), traj,
                                num_beams=360, max_range=15.0)
    pts, mask = jds.scan_to_points(seq.ranges[1], seq.hit[1])
    js, jinfo = jfu.update(state, P, seq.odom[1], pts, mask, fsrc, ftgt)
    t = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    ts, tinfo = tfu.update(tstate, TP, t(seq.odom[1]), t(pts), t(mask), tfs,
                           tft)
    np.testing.assert_allclose(ts.Tnow.numpy(), np.asarray(js.Tnow),
                               rtol=0, atol=1e-5)
    assert int(tinfo.iterations) == int(jinfo.iterations)
    assert bool(tinfo.converged) == bool(jinfo.converged)


@functools.lru_cache(maxsize=None)
def _registration():
    """The reference's match_d2d + covariance_d2d of the second scan's
    cells against the first scan's map, from a pose 6 cm / 15 mrad off
    the odometry prediction."""
    state, src, T0, _, _, _ = _case()
    tgt = jd2d.make_dense_target(state.grid, P.ndt)
    T_init = T0 + jnp.asarray([0.05, -0.03, 0.015], jnp.float32)
    res = jd2d.match_d2d(tgt, src, T_init, P.ndt, M)
    cov = jd2d.covariance_d2d(tgt, src, res.T, P.ndt, M)
    return T_init, res, cov


def test_match_d2d_matches_jax():
    T_init, ref, _ = _registration()
    tstate, tsrc, _, _, _, _ = _torch_case()
    tgt = td2d.PackedTarget(origin=tstate.grid.origin, packed=tstate.packed)
    got = td2d.match_d2d(tgt, tsrc, torch.tensor(np.asarray(T_init)),
                         TP.ndt, TM)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(ref.T), atol=2e-5)
    np.testing.assert_allclose(got.d.numpy(), np.asarray(ref.d), atol=2e-5)
    np.testing.assert_allclose(float(got.score), float(ref.score),
                               rtol=1e-4)
    assert int(got.iterations) == int(ref.iterations)
    assert bool(got.converged) == bool(ref.converged)
    # The registration moved the pose back towards the prediction.
    assert float(np.abs(np.asarray(ref.d)).max()) > 0.01


def test_covariance_d2d_matches_jax():
    _, res, ref = _registration()
    tstate, tsrc, _, _, _, _ = _torch_case()
    tgt = td2d.PackedTarget(origin=tstate.grid.origin, packed=tstate.packed)
    got = td2d.covariance_d2d(tgt, tsrc, torch.tensor(np.asarray(res.T)),
                              TP.ndt, TM).numpy()
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, atol=2e-3 * np.abs(ref).max())
    np.testing.assert_array_equal(got, got.T)
    assert np.linalg.eigvalsh(got.astype(np.float64)).min() > 0.0
