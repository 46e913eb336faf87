"""Parity of the port's pose-graph optimizer (graph/optimize.py) with the
JAX reference on small graphs: an odometry chain, a drifted loop with
loop closures (one of them an outlier) and a graph with masked edges,
for each robust kernel.

Tolerances: `spd_info_np` is the same numpy code, so equal.  Residuals,
Jacobians and the normal equations are float32 elementwise math and sums
of a few terms: rtol 1e-5, atol 1e-4 on H (entries up to ~1e4).  The
solved poses: atol 1e-4 — both sides solve the damped normal equations
in float32 by LU, twenty iterations; measured differences stay below
1e-5 m here.  The robust weights of the masked median: rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_feature_graph_tpu.graph import optimize as jopt
from ndt_feature_graph_tpu_torch import interop
from ndt_feature_graph_tpu_torch.graph import optimize as topt

torch.set_num_threads(2)
KERNELS = ["none", "huber", "dcs"]


def _rel(a, b):
    """Pose of b in a's frame (float64 numpy)."""
    c, s = np.cos(a[2]), np.sin(a[2])
    dx, dy = b[0] - a[0], b[1] - a[1]
    t = b[2] - a[2]
    return np.array([c * dx + s * dy, -s * dx + c * dy,
                     np.arctan2(np.sin(t), np.cos(t))])


def _graph(kind, seed=0):
    """(initial poses (N, 3), edge dict of numpy arrays) for one of the
    three test graphs."""
    rng = np.random.default_rng(seed)
    n = 12
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    gt = np.stack([4 * np.cos(th), 4 * np.sin(th), th + np.pi / 2], -1)
    if kind == "chain":
        gt = np.stack([np.arange(n) * 1.0, 0.1 * np.arange(n) ** 1.5,
                       0.05 * np.arange(n)], -1)
    ei, ej = list(range(n - 1)), list(range(1, n))
    odo = [True] * (n - 1)
    if kind != "chain":
        ei += [0, 2, 9, 4]
        ej += [n - 1, n - 2, 1, 10]
        odo += [False] * 4
    meas = np.stack([_rel(gt[i], gt[j]) for i, j in zip(ei, ej)])
    meas += rng.normal(0, [0.02, 0.02, 0.005], meas.shape)
    if kind != "chain":
        meas[-1] += [1.5, -1.0, 0.4]          # a wrong loop closure
    info = np.stack([np.diag([50.0, 50.0, 200.0])] * len(ei))
    info[~np.asarray(odo)] = np.diag([400.0, 400.0, 900.0])
    mask = np.ones(len(ei), bool)
    if kind == "masked":
        mask[[3, len(ei) - 2]] = False
        meas[3] += [5.0, 5.0, 1.0]            # garbage under the mask
    # Initial estimate: odometry dead reckoning with a heading drift.
    init = [gt[0]]
    for k in range(n - 1):
        a, r = init[-1], meas[k] + [0.0, 0.0, 0.03]
        c, s = np.cos(a[2]), np.sin(a[2])
        init.append([a[0] + c * r[0] - s * r[1], a[1] + s * r[0] + c * r[1],
                     a[2] + r[2]])
    edges = dict(i=np.asarray(ei, np.int32), j=np.asarray(ej, np.int32),
                 meas=meas.astype(np.float32), info=info.astype(np.float32),
                 mask=mask, is_odom=np.asarray(odo))
    return np.asarray(init, np.float32), edges


def _both(kind):
    poses, e = _graph(kind)
    je = jopt.EdgeList(**{k: jnp.asarray(v) for k, v in e.items()})
    return (jnp.asarray(poses), je, torch.tensor(poses),
            interop.edge_list_from_jax(e))


def test_spd_info_np_matches_jax():
    rng = np.random.default_rng(1)
    covs = [rng.normal(size=(3, 3)) for _ in range(5)]
    covs = [c @ c.T for c in covs] + [
        np.diag([1e-9, -1e-7, 2.0]), np.full((3, 3), np.nan),
        np.diag([np.inf, 1.0, 1.0])]
    for c in covs:
        for eps in (1e-6, 1e-4):
            np.testing.assert_array_equal(topt.spd_info_np(c, eps),
                                          jopt.spd_info_np(c, eps))


@pytest.mark.parametrize("kind", ["chain", "loop", "masked"])
def test_residual_jacobians_normal_equations_match_jax(kind):
    jp, je, tp, te = _both(kind)
    r_j = jopt.edge_residual(jp[je.i], jp[je.j], je.meas)
    r_t = topt.edge_residual(tp[te.i], tp[te.j], te.meas)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-5,
                               atol=1e-6)
    import jax
    Ji_j, Jj_j = jax.vmap(jopt._edge_jacobians)(jp[je.i], jp[je.j], je.meas)
    Ji_t, Jj_t = topt._edge_jacobians(tp[te.i], tp[te.j], te.meas)
    np.testing.assert_allclose(Ji_t.numpy(), np.asarray(Ji_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(Jj_t.numpy(), np.asarray(Jj_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(topt.edge_is_loop(te).numpy(),
                                  np.asarray(jopt.edge_is_loop(je)))
    n = jp.shape[0]
    H_j, b_j = jopt.assemble_normal_equations(jp, je, n)
    H_t, b_t = topt.assemble_normal_equations(tp, te, n)
    np.testing.assert_allclose(H_t.numpy(), np.asarray(H_j), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("kind", ["loop", "masked"])
def test_robust_edge_scale_matches_jax(kind, kernel):
    jp, je, tp, te = _both(kind)
    r_j = jopt.edge_residual(jp[je.i], jp[je.j], je.meas)
    r_t = topt.edge_residual(tp[te.i], tp[te.j], te.meas)
    for delta in (1.0, 30.0):
        sj, rj = jopt.robust_edge_scale(r_j, je, kernel, delta)
        st, rt = topt.robust_edge_scale(r_t, te, kernel, delta)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5)
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-5)
    with pytest.raises(ValueError):
        topt.robust_edge_scale(r_t, te, "cauchy", 1.0)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("kind", ["chain", "loop", "masked"])
def test_optimize_matches_jax(kind, kernel):
    jp, je, tp, te = _both(kind)
    out_j, chi_j = jopt.optimize(jp, je, iterations=20,
                                 robust_kernel=kernel, robust_delta=1.0)
    out_t, chi_t = topt.optimize(tp, te, iterations=20,
                                 robust_kernel=kernel, robust_delta=1.0)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-4)
    np.testing.assert_allclose(float(chi_t), float(chi_j), rtol=1e-3,
                               atol=1e-3)
    if kind != "chain":
        # The solve moves the drifted loop: it is not the initial guess.
        assert np.abs(out_t.numpy() - tp.numpy()).max() > 0.05


def test_optimize_guards_inactive_nodes():
    """Padded nodes with no edge (the online solve's static shapes) get
    a unit diagonal and stay where they are, finite."""
    poses, e = _graph("chain")
    pad = np.concatenate([poses, np.zeros((4, 3), np.float32)])
    je = jopt.EdgeList(**{k: jnp.asarray(v) for k, v in e.items()})
    out_j, _ = jopt.optimize(jnp.asarray(pad), je, iterations=5)
    out_t, _ = topt.optimize(torch.tensor(pad),
                             interop.edge_list_from_jax(e), iterations=5)
    assert np.isfinite(out_t.numpy()).all()
    np.testing.assert_array_equal(out_t.numpy()[-4:], 0.0)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-4)
