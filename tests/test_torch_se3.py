"""The port's SE(3) pose math (core/se3.py) and the 3x3 <-> 6x6 covariance
lifts and SE(2) covariance propagation (core/motion_model.py) against the
JAX package on the same numpy inputs (float32).

rotmat and rotvec_from_matrix are held on every branch: rotmat's generic
and Taylor branches (squared angle above / below 1e-8, and exactly 0),
the log map's small-angle (below 1e-4), generic and near-pi (within
1e-3 of pi) branches, with angles clear of the thresholds (an input
within an ulp of one may take another branch in XLA and torch) and exact
cases on each branch.  The forward-over-reverse Hessian through rotmat
(what the 6-DoF matcher takes at its start d = 0) is finite and the
reference's.

Tolerances: 2e-6 on rotation matrices and composed poses (float32
transcendentals of two libraries), 1e-5 on log maps of generic angles
and on points; the near-pi log map 2e-5 (its axis comes from a float32
square root of the symmetric part's diagonal); covariance algebra 1e-6
relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_feature_graph_tpu.core import motion_model as jmm
from ndt_feature_graph_tpu.core import se3 as jse3
from ndt_feature_graph_tpu_torch.core import motion_model as tmm
from ndt_feature_graph_tpu_torch.core import se3 as tse3

torch.set_num_threads(2)


def _both(fn_j, fn_t, *args):
    j = np.asarray(jax.jit(fn_j)(*(jnp.asarray(a) for a in args)))
    t = fn_t(*(torch.tensor(a) for a in args)).numpy()
    return j, t


def _rotvecs(rng, angles):
    axes = rng.normal(size=(len(angles), 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    return (axes * np.asarray(angles)[:, None]).astype(np.float32)


ANGLES = {
    "taylor": [0.0, 1e-6, 5e-5, 9e-5],          # t^2 < 1e-8
    "generic": [1e-3, 0.05, 0.7, 1.5, 2.5, 3.0],
    "near_pi": [np.pi - 5e-4, np.pi - 1e-4, np.pi],
}


@pytest.mark.parametrize("branch", ANGLES)
def test_rotmat_matches_jax(branch):
    rv = _rotvecs(np.random.default_rng(0), ANGLES[branch])
    j, t = _both(jse3.rotmat, tse3.rotmat, rv)
    np.testing.assert_allclose(t, j, atol=2e-6)
    np.testing.assert_allclose(t @ np.swapaxes(t, -1, -2),
                               np.broadcast_to(np.eye(3), t.shape), atol=2e-6)


@pytest.mark.parametrize("branch,tol", [("small", 1e-5), ("generic", 1e-5),
                                        ("near_pi", 2e-5)])
def test_rotvec_from_matrix_matches_jax(branch, tol):
    """Both sides log the same float32 matrix: the small branch at angles
    below 1e-4, the near-pi branch above pi - 1e-3, and exact cases: the
    identity, a quarter turn, half turns about each axis and about a
    diagonal (an argmax tie)."""
    angles = {"small": [0.0, 1e-6, 3e-5, 8e-5],
              "generic": [2e-4, 0.1, 1.0, 2.0, 3.0, 3.1],
              "near_pi": [np.pi - 8e-4, np.pi - 2e-4, np.pi]}[branch]
    rv = _rotvecs(np.random.default_rng(1), angles)
    exact = {"small": [np.eye(3)],
             "generic": [np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]])],
             "near_pi": [np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]),
                         np.diag([-1.0, -1, 1]),
                         np.outer([1.0, 1, 0], [1.0, 1, 0]) - np.eye(3)]}
    mats = [np.asarray(jse3.rotmat(jnp.asarray(r)))
            for r in rv.astype(np.float32)] + exact[branch]
    for R in mats:
        R = np.asarray(R, np.float32)
        j, t = _both(jse3.rotvec_from_matrix, tse3.rotvec_from_matrix, R)
        np.testing.assert_allclose(t, j, atol=tol)
        # And the round trip holds on both.
        np.testing.assert_allclose(tse3.rotmat(torch.tensor(t)).numpy(), R,
                                   atol=5e-4)


def _poses(rng, n, rot_scale=1.0):
    return np.concatenate([rng.normal(0, 3.0, (n, 3)),
                           rng.normal(0, rot_scale, (n, 3))],
                          1).astype(np.float32)


def test_compose_inverse_sub_match_jax():
    rng = np.random.default_rng(2)
    a, b = _poses(rng, 12), _poses(rng, 12)
    a[0, 3:] = 0.0                      # identity rotation
    b[1, 3:] = [0.0, 0.0, np.pi - 5e-4]  # near a half turn
    for x, y in zip(a, b):
        for fj, ft in ((jse3.compose, tse3.compose), (jse3.sub, tse3.sub)):
            j, t = _both(fj, ft, x, y)
            np.testing.assert_allclose(t, j, atol=2e-5)
        j, t = _both(jse3.inverse, tse3.inverse, x)
        np.testing.assert_allclose(t, j, atol=2e-6)


def test_points_covs_and_planar_embedding_match_jax():
    rng = np.random.default_rng(3)
    pose = _poses(rng, 1)[0]
    pts = rng.normal(0, 2.0, (7, 3)).astype(np.float32)
    A = rng.normal(0, 0.3, (7, 3, 3))
    covs = (A @ np.swapaxes(A, 1, 2)).astype(np.float32)
    j, t = _both(jse3.transform_points, tse3.transform_points, pose, pts)
    np.testing.assert_allclose(t, j, atol=1e-5)
    j, t = _both(jse3.rotate_covs, tse3.rotate_covs, pose, covs)
    np.testing.assert_allclose(t, j, atol=1e-5)
    p2 = np.asarray([0.3, -1.2, 2.9], np.float32)
    j, t = _both(jse3.from_se2, tse3.from_se2, p2)
    np.testing.assert_array_equal(t, j)
    j, t = _both(jse3.to_se2, tse3.to_se2, pose)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(tse3.identity().numpy(),
                                  np.asarray(jse3.identity()))
    j, t = _both(jse3._skew, tse3._skew, pts)
    np.testing.assert_array_equal(t, j)


def test_rotmat_hessian_is_finite_at_zero():
    """jacfwd(grad) of a scalar through rotmat at d = 0, where the
    generic branch is untaken: finite (the floored angle) and the
    reference's."""
    rng = np.random.default_rng(4)
    v = rng.normal(size=(5, 3)).astype(np.float32)
    w = rng.normal(size=(5, 3)).astype(np.float32)

    def fj(rv):
        return jnp.sum((jnp.asarray(v) @ jse3.rotmat(rv).T) * w)

    def ft(rv):
        return ((torch.tensor(v) @ tse3.rotmat(rv).T) * torch.tensor(w)).sum()

    for rv in (np.zeros(3, np.float32), np.full(3, 1e-5, np.float32),
               np.asarray([0.3, -0.2, 0.5], np.float32)):
        hj = np.asarray(jax.jit(jax.jacfwd(jax.grad(fj)))(jnp.asarray(rv)))
        ht = torch.func.jacfwd(torch.func.grad(ft))(torch.tensor(rv)).numpy()
        assert np.isfinite(ht).all()
        np.testing.assert_allclose(ht, hj, atol=1e-4 * max(1, abs(hj).max()))


def test_covariance_lifts_and_composition_match_jax():
    rng = np.random.default_rng(5)
    A = rng.normal(0, 0.2, (4, 3, 3))
    cov3 = (A @ np.swapaxes(A, 1, 2)).astype(np.float32)
    B = rng.normal(0, 0.2, (4, 6, 6))
    cov6 = (B @ np.swapaxes(B, 1, 2)).astype(np.float32)
    for fj, ft, x in ((jmm.cov3_to_cov6, tmm.cov3_to_cov6, cov3),
                      (jmm.cov6_to_cov3, tmm.cov6_to_cov3, cov6),
                      (jmm.cov3_to_cov6, tmm.cov3_to_cov6, cov3[0]),
                      (jmm.cov6_to_cov3, tmm.cov6_to_cov3, cov6[0])):
        j, t = _both(fj, ft, x)
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(
        tmm.cov6_to_cov3(tmm.cov3_to_cov6(torch.tensor(cov3))).numpy(), cov3)
    ma = np.concatenate([rng.normal(0, 2, (4, 2)), rng.uniform(-3, 3, (4, 1))],
                        1).astype(np.float32)
    mb = np.concatenate([rng.normal(0, 2, (4, 2)), rng.uniform(-3, 3, (4, 1))],
                        1).astype(np.float32)
    jm, jc = jmm.compose_pose_cov(*(jnp.asarray(x) for x in (ma, cov3, mb,
                                                             cov3[::-1])))
    tm, tc = tmm.compose_pose_cov(*(torch.tensor(x.copy()) for x in (
        ma, cov3, mb, cov3[::-1])))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=2e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-6 * np.abs(np.asarray(jc)).max())
