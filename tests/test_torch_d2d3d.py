"""The port's 6-DoF D2D registration (ops/d2d3d.py) against the JAX
package on the same numpy inputs: the score with its autodiff gradient
and Hessian (torch.func against jax.grad / jax.jacfwd), the Hessian
against a float64 central difference, the chunked pair sum, and
match_d2d_3d with and without the planar clamp (force2d), the clamp also
against the port's SE(2) matcher on a real scan pair.

Tolerances: f rtol 1e-5 and g, H 1e-4 of their largest entry (float32
sums of N x M pair terms in two orders); the float64 Hessian within
1e-6 of the central difference of the gradient (step 1e-5).  Poses
within 1 mm / 1 mrad of the reference: its LM stop test (score change <=
1e-4 at |f| ~ 50, a few float32 ulps) can fire a trial earlier or later
after a reordered sum, which moves the pose by at most 0.2 mm here; so
trial counts are not held, and the covariance is held to 2% of its
largest entry.  The clamp against the SE(2) matcher (a grid-window
association against the cutoff's all pairs): within 2 cm / 20 mrad,
the reference's own bound for its clamp against the truth
(tests/test_d2d3d.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_feature_graph_tpu.config import (
    FeatureParams, FuserParams, MatcherParams, NDTMapParams,
)
from ndt_feature_graph_tpu.core import se2 as jse2
from ndt_feature_graph_tpu.core import se3 as jse3
from ndt_feature_graph_tpu.fusion import fuser as jfu
from ndt_feature_graph_tpu.io import dataset as jds
from ndt_feature_graph_tpu.ops import d2d3d as jd3
from ndt_feature_graph_tpu.ops import ndt_map as jnm
from ndt_feature_graph_tpu_torch import interop
from ndt_feature_graph_tpu_torch.core import se3 as tse3
from ndt_feature_graph_tpu_torch.ops import d2d as td2d
from ndt_feature_graph_tpu_torch.ops import d2d3d as td3

torch.set_num_threads(2)
M = MatcherParams(itr_max=40, lfd2=0.2)
TM = interop.params_from_jax(M)
CUTOFF = 3.0
XY_TOL, TH_TOL = 1e-3, 1e-3


def _scene(rng, n=40):
    """tests/test_d2d3d.py's random 3D scene (n gaussians)."""
    means = rng.normal(0, 4.0, (n, 3)).astype(np.float32)
    covs = np.zeros((n, 3, 3), np.float32)
    for i in range(n):
        A = rng.normal(0, 0.15, (3, 3))
        covs[i] = A @ A.T + np.eye(3) * 0.01
    return {"means": means, "covs": covs, "mask": np.ones(n, bool)}


def _jax(c):
    return jd3.CellList3D(**{k: jnp.asarray(v) for k, v in c.items()})


def _torch(c, dtype=torch.float32):
    t = interop.cell_list3d_from_jax(c, device="cpu")
    return td3.CellList3D(t.means.to(dtype), t.covs.to(dtype), t.mask)


@functools.lru_cache(maxsize=None)
def _pair():
    """A target scene and the source it becomes under the inverse of a
    6-DoF pose, as numpy lists."""
    rng = np.random.default_rng(1)
    tgt = _scene(rng)
    true = np.concatenate([rng.uniform(-0.4, 0.4, 3),
                           rng.uniform(-0.12, 0.12, 3)]).astype(np.float32)
    src = _jax(tgt).transform(jse3.inverse(jnp.asarray(true)))
    return tgt, {k: np.asarray(v) for k, v in src._asdict().items()}, true


@jax.jit
def _fgh_jax(d, T0, src, tgt):
    def f(dd):
        return jd3.d2d_score_3d(dd, T0, src, tgt, M, CUTOFF)

    return f(d), jax.grad(f)(d), jax.jacfwd(jax.grad(f))(d)


@pytest.mark.parametrize("d", [np.zeros(6, np.float32),
                               np.asarray([0.05, -0.02, 0.01, 0.02, -0.01,
                                           0.03], np.float32)])
def test_score_gradient_hessian_match_jax(d):
    tgt, src, _ = _pair()
    T0 = np.asarray([0.1, 0.0, -0.05, 0.0, 0.01, -0.02], np.float32)
    jf, jg, jH = (np.asarray(x) for x in _fgh_jax(
        jnp.asarray(d), jnp.asarray(T0), _jax(src), _jax(tgt)))
    f, g, H = td3.d2d_fgh_3d(torch.tensor(d), torch.tensor(T0), _torch(src),
                             _torch(tgt), TM, CUTOFF)
    assert np.isfinite(H.numpy()).all()
    np.testing.assert_allclose(float(f), float(jf), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), jg, atol=1e-4 * np.abs(jg).max())
    np.testing.assert_allclose(H.numpy(), jH, atol=1e-4 * np.abs(jH).max())
    np.testing.assert_allclose(
        float(td3.d2d_score_3d(torch.tensor(d), torch.tensor(T0),
                               _torch(src), _torch(tgt), TM, CUTOFF)),
        float(jf), rtol=1e-5)


def test_hessian_matches_central_difference_float64():
    """The forward-over-reverse Hessian in float64 against the central
    difference of the autodiff gradient."""
    tgt, src, _ = _pair()
    s, t = _torch(src, torch.float64), _torch(tgt, torch.float64)
    T0 = torch.zeros(6, dtype=torch.float64)
    d = torch.tensor([0.03, -0.01, 0.02, 0.01, -0.02, 0.04],
                     dtype=torch.float64)
    _, _, H = td3.d2d_fgh_3d(d, T0, s, t, TM, CUTOFF)
    h = 1e-5
    fd = torch.stack([
        (td3.d2d_fgh_3d(d + h * e, T0, s, t, TM, CUTOFF)[1]
         - td3.d2d_fgh_3d(d - h * e, T0, s, t, TM, CUTOFF)[1]) / (2 * h)
        for e in torch.eye(6, dtype=torch.float64)], 1)
    np.testing.assert_allclose(H.numpy(), fd.numpy(),
                               atol=1e-6 * float(H.abs().max()))


def test_pair_chunks_sum_to_the_whole(monkeypatch):
    """Splitting the pairs into source-row chunks (PAIR_CHUNK) gives the
    unsplit (f, g, H) up to the order of the sums."""
    tgt, src, _ = _pair()
    args = (torch.tensor([0.02, 0.01, 0.0, 0.01, 0.0, -0.02]),
            torch.zeros(6), _torch(src), _torch(tgt), TM, CUTOFF)
    whole = td3.d2d_fgh_3d(*args)
    monkeypatch.setattr(td3, "PAIR_CHUNK", 7 * 40)      # 6 chunks of 7 rows
    parts = td3.d2d_fgh_3d(*args)
    for a, b in zip(parts, whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))


def _close_pose(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[:3], want[:3], atol=XY_TOL)
    R = (tse3.rotmat(torch.tensor(got[3:])).T
         @ tse3.rotmat(torch.tensor(want[3:]))).numpy()
    assert np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)) <= TH_TOL


@pytest.mark.parametrize("force2d", [False, True])
def test_match_d2d_3d_matches_jax(force2d):
    """Registration of the source onto the target from the identity: the
    reference's pose and covariance; unclamped it recovers the 6-DoF
    truth (the reference's bounds: 3 cm, 0.02 rad)."""
    tgt, src, true = _pair()
    ref = jd3.match_d2d_3d(_jax(tgt), _jax(src), jnp.zeros(6), M,
                           cutoff=CUTOFF, force2d=force2d)
    got = td3.match_d2d_3d(_torch(tgt), _torch(src), torch.zeros(6), TM,
                           cutoff=CUTOFF, force2d=force2d)
    _close_pose(got.T.numpy(), ref.T)
    assert bool(got.converged) == bool(ref.converged)
    np.testing.assert_allclose(float(got.score), float(ref.score),
                               rtol=1e-4)
    cov = np.asarray(ref.cov)
    np.testing.assert_allclose(got.cov.numpy(), cov,
                               atol=2e-2 * np.abs(cov).max())
    assert np.linalg.eigvalsh(got.cov.numpy().astype(np.float64)).min() > 0
    if force2d:
        np.testing.assert_array_equal(got.T.numpy()[2:5], 0.0)
    else:
        assert np.linalg.norm(got.T.numpy()[:3] - true[:3]) < 0.03


@functools.lru_cache(maxsize=None)
def _planar_case():
    """A real scan pair: the reference's fuser map of scan 0 of a small
    loop and scan 1's local cells at the odometry prediction, lifted to
    3D (z = 0, z variance 0.01) with the padding dropped."""
    p = FuserParams(
        ndt=NDTMapParams(resolution=0.5, size_x=40.0, size_y=40.0,
                         sensor_range=15.0, max_points_per_scan=360,
                         max_cells=512),
        features=FeatureParams(num_beams=360, max_range=15.0))
    traj = jds.loop_trajectory(28, radius=5.0)
    seq = jds.simulate_sequence(jax.random.PRNGKey(11), traj,
                                num_beams=360, max_range=15.0)
    pts0, m0 = jds.scan_to_points(seq.ranges[0], seq.hit[0])
    state = jfu.initialize(p, jnp.zeros(3), jnp.zeros(3), pts0, m0)
    pts1, m1 = jds.scan_to_points(seq.ranges[1], seq.hit[1])
    src, _ = jfu._build_local_cells(p, jnp.zeros(3), pts1, m1)
    tgt = jnm.to_cell_list(state.grid, p.ndt)
    T0 = np.asarray(jse2.compose(state.Tnow, seq.odom[1]), np.float32)

    def lift(c):
        keep = np.asarray(c.mask)
        n = int(keep.sum())
        means = np.zeros((n, 3), np.float32)
        means[:, :2] = np.asarray(c.means)[keep]
        covs = np.zeros((n, 3, 3), np.float32)
        covs[:, :2, :2] = np.asarray(c.covs)[keep]
        covs[:, 2, 2] = 0.01
        return {"means": means, "covs": covs, "mask": np.ones(n, bool)}

    return p, state, jax.tree.map(np.asarray, src), lift(tgt), lift(src), T0


def test_force2d_matches_the_se2_matcher():
    """The planar clamp on a real scan pair against the port's SE(2)
    d2d.match_d2d of the same cells on the same map (and against the
    reference's clamp)."""
    p, state, src2, tgt3, src3, T0 = _planar_case()
    T6 = np.asarray([T0[0], T0[1], 0, 0, 0, T0[2]], np.float32)
    ref = jd3.match_d2d_3d(_jax(tgt3), _jax(src3), jnp.asarray(T6), p.matcher,
                           force2d=True)
    tp = interop.params_from_jax(p)
    got = td3.match_d2d_3d(_torch(tgt3), _torch(src3), torch.tensor(T6),
                           tp.matcher, force2d=True)
    _close_pose(got.T.numpy(), ref.T)
    tstate = interop.fuser_state_from_jax(jax.tree.map(np.asarray, state),
                                          device="cpu")
    se2_res = td2d.match_d2d(
        td2d.PackedTarget(origin=tstate.grid.origin, packed=tstate.packed),
        interop.cell_list_from_jax(src2, device="cpu"), torch.tensor(T0),
        tp.ndt, tp.matcher)
    planar = tse3.to_se2(got.T).numpy()
    se2_T = se2_res.T.numpy()
    assert np.abs(planar[:2] - se2_T[:2]).max() <= 0.02
    dth = planar[2] - se2_T[2]
    assert abs(np.arctan2(np.sin(dth), np.cos(dth))) <= 0.02
