"""Parity of the port's registration core (ops/d2d.py, d2d_analytic.py,
cuda_kernels.py) with the JAX reference.

Tolerances: the pair-derivative reduction as tests/test_pallas_kernels.py
(f rtol 1e-4; g, H rtol 2e-3) — sums over thousands of pairs in another
order; table rows and window indices exact.  The Newton minimizer is
held to equal trial counts and `converged` on costs both frameworks
evaluate identically.  On a real D2D cost the LM stop test (score change
<= delta_score = 1e-4 at |f| ~ 200, about seven float32 ulps) sits at
rounding noise, so a reordered sum can move the stop by a trial: there
the pose is held to 2e-5 and the trial count to the reference's on the
first scan of the test loop.

The kernels themselves need a CUDA card: tests/test_torch_cuda.py holds
them against these plain versions there.
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
from ndt_feature_graph_tpu.fusion import fuser as jfu
from ndt_feature_graph_tpu.io import dataset as jds
from ndt_feature_graph_tpu.ops import d2d as jd2d
from ndt_feature_graph_tpu.ops import d2d_analytic as jda
from ndt_feature_graph_tpu.ops import ndt_map as jnm
from ndt_feature_graph_tpu.ops import pallas_kernels
from ndt_feature_graph_tpu_torch import interop
from ndt_feature_graph_tpu_torch.ops import cuda_kernels
from ndt_feature_graph_tpu_torch.ops import d2d as td2d
from ndt_feature_graph_tpu_torch.ops import d2d_analytic as tda
from ndt_feature_graph_tpu_torch.ops import ndt_map as tnm

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


def _np(x):
    return jax.tree.map(np.asarray, x)


@functools.lru_cache(maxsize=None)
def _case():
    """A real fuser state (JAX initialize on scan 0 of the test loop) and
    the next scan's local NDT cells, predicted pose and cost pieces."""
    traj = jds.loop_trajectory(28, radius=5.0)
    seq = jds.simulate_sequence(jax.random.PRNGKey(11), traj,
                                num_beams=360, max_range=15.0)
    pts0, m0 = jds.scan_to_points(seq.ranges[0], seq.hit[0])
    state = jfu.initialize(P, jnp.zeros(3), jnp.zeros(3), pts0, m0)
    pts1, m1 = jds.scan_to_points(seq.ranges[1], seq.hit[1])
    src, _ = jfu._build_local_cells(P, jnp.zeros(3), pts1, m1)
    T0 = jse2.compose(state.Tnow, seq.odom[1])
    Q = jfu._increment_information(P, seq.odom[1], T0)
    return state, src, T0, Q, seq


def _torch_case():
    state, src, T0, Q, _ = _case()
    return (interop.fuser_state_from_jax(_np(state), device="cpu"),
            interop.cell_list_from_jax(_np(src), device="cpu"),
            torch.tensor(np.asarray(T0)), torch.tensor(np.asarray(Q)))


def _assert_fgh(got, ref):
    f, g, H = (np.asarray(x, np.float64) for x in ref)
    np.testing.assert_allclose(float(got[0]), float(f), rtol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), g, rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), H, rtol=2e-3, atol=1e-3)


def _random_pairs(seed, n, k):
    rng = np.random.default_rng(seed)
    mu = (0.5 * rng.standard_normal((n, k, 2))).astype(np.float32)
    L = 0.2 * rng.standard_normal((n, k, 2, 2))
    Sig = (L @ L.transpose(0, 1, 3, 2) + 0.05 * np.eye(2)).astype(np.float32)
    m_rot = (3.0 * rng.standard_normal((n, 1, 2))).astype(np.float32)
    Lc = 0.2 * rng.standard_normal((n, 1, 2, 2))
    Crot = (Lc @ Lc.transpose(0, 1, 3, 2)
            + 0.02 * np.eye(2)).astype(np.float32)
    ok = rng.random((n, k)) < 0.7
    return mu, Sig, m_rot, Crot, ok


@pytest.mark.parametrize("n,k", [(70, 25), (3, 7)])
def test_pair_reduce_reference_matches_pallas(n, k):
    """The plain twin of the kernel against the Pallas kernel in
    interpret mode, including sizes that do not fill a tile."""
    args = _random_pairs(n, n, k)
    ref = pallas_kernels.pair_fgh_reduce(
        *(jnp.asarray(a) for a in args), 1.0, 0.05, interpret=True
    )
    got = cuda_kernels.pair_fgh_reduce_reference(
        *(torch.tensor(a) for a in args), 1.0, 0.05
    )
    _assert_fgh(got, ref)


def test_cpu_wrappers_use_the_plain_twins():
    """On CPU tensors the wrappers call their plain versions (and count
    no launch)."""
    cuda_kernels.reset_launch_counts()
    args = [torch.tensor(a) for a in _random_pairs(5, 4, 25)]
    a = cuda_kernels.pair_fgh_reduce(*args, 1.0, 0.05)
    b = cuda_kernels.pair_fgh_reduce_reference(*args, 1.0, 0.05)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    tstate, tsrc, tT0, _ = _torch_case()
    d = torch.tensor([0.01, -0.02, 0.003])
    a = cuda_kernels.fgh_dense_flat(d, tT0, tsrc, tstate.packed,
                                    tstate.grid.origin, H_, W_, RES,
                                    M.n_neighbours, M.lfd1, M.lfd2)
    b = tda.fgh_dense_flat(d, tT0, tsrc, tstate.packed, tstate.grid.origin,
                           0, H_, W_, RES, TM)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert cuda_kernels.LAUNCHES == {"newton_objective": 0,
                                     "fgh_dense_flat": 0,
                                     "pair_fgh_reduce": 0,
                                     "fgh_dense_flat_batch": 0,
                                     "newton_objective_batch": 0,
                                     "newton_solve": 0,
                                     "newton_solve_batch": 0,
                                     "row_sum": 0,
                                     "segment_add_rows": 0,
                                     "occupancy_update": 0,
                                     "overlap_score": 0,
                                     "detect_features": 0,
                                     "describe_features": 0,
                                     "match_features": 0}


def test_wrappers_reject_other_devices():
    meta = torch.zeros(3, device="meta")
    with pytest.raises(ValueError):
        cuda_kernels.pair_fgh_reduce(
            torch.zeros(4, 2, device="meta"),
            torch.zeros(4, 2, 2, device="meta"),
            torch.zeros(4, 2, device="meta"),
            torch.zeros(4, 2, 2, device="meta"),
            torch.zeros(4, dtype=torch.bool, device="meta"), 1.0, 0.05)
    src = tnm.CellList(torch.zeros(4, 2, device="meta"),
                       torch.zeros(4, 2, 2, device="meta"),
                       torch.zeros(4, dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError):
        cuda_kernels.fgh_dense_flat(meta, meta, src,
                                    torch.zeros(16, 8, device="meta"),
                                    torch.zeros(2, device="meta"), 4, 4,
                                    0.5, 2, 1.0, 0.05)
    src_b = tnm.CellList(*(x[None] for x in (src.means, src.covs,
                                              src.mask)))
    with pytest.raises(ValueError):
        cuda_kernels.fgh_dense_flat_batch(
            meta[None], meta[None], src_b, torch.zeros(16, 8, device="meta"),
            torch.zeros(1, 2, device="meta"),
            torch.zeros(1, dtype=torch.int64, device="meta"), 4, 4, 0.5, 2,
            1.0, 0.05)


@pytest.mark.parametrize("d", [(0.0, 0.0, 0.0), (0.05, -0.08, 0.02)])
def test_fgh_dense_flat_matches_jax_flat_and_block(d):
    """The port's one D2D window path against the reference's flat path
    and its canonical win-block table (f32: exact to each other)."""
    state, src, T0, _, _ = _case()
    tstate, tsrc, tT0, _ = _torch_case()
    dj = jnp.asarray(d, jnp.float32)
    got = tda.fgh_dense_flat(torch.tensor(d, dtype=torch.float32), tT0,
                             tsrc, tstate.packed, tstate.grid.origin, 0, H_,
                             W_, RES, TM)
    flat = jda.fgh_dense_flat(dj, T0, src, state.packed, state.grid.origin,
                              0, H_, W_, RES, M)
    _assert_fgh(got, flat)
    wc = 76
    blk, cell0 = jd2d.build_window_block_tables(
        state.packed[None], state.grid.origin[None], T0[None, :2], H_, W_,
        M.n_neighbours, wc, RES)
    fb, gb, Hb = jda.fgh_dense_block_batch(
        dj[None], T0[None], jax.tree.map(lambda x: x[None], src),
        blk.reshape(-1, blk.shape[-1]), cell0, state.grid.origin[None], wc,
        RES, M)
    _assert_fgh(got, (fb[0], gb[0], Hb[0]))


def test_gather_windows_flat_matches_jax():
    state, _, _, _, _ = _case()
    rng = np.random.default_rng(0)
    iy0 = rng.integers(-4, H_ + 4, (50,)).astype(np.int32)
    ix0 = rng.integers(-4, W_ + 4, (50,)).astype(np.int32)
    jm, jc, jv = jd2d.gather_windows_flat(state.packed, H_, W_,
                                          jnp.asarray(iy0), jnp.asarray(ix0),
                                          2)
    tm, tc, tv = td2d.gather_windows_flat(
        torch.tensor(np.asarray(state.packed)), H_, W_,
        torch.tensor(iy0, dtype=torch.int64),
        torch.tensor(ix0, dtype=torch.int64), 2)
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


def test_fgh_paired_and_mahalanobis_match_jax():
    rng = np.random.default_rng(1)
    c = 64
    means_s = rng.normal(0, 5, (c, 2)).astype(np.float32)
    means_t = (means_s + rng.normal(0, 0.05, (c, 2))).astype(np.float32)
    covs = np.tile(np.eye(2, dtype=np.float32) * 2e-4, (c, 1, 1))
    mask = rng.random(c) < 0.6
    T0 = np.asarray([0.3, -0.2, 0.1], np.float32)
    d = np.asarray([0.01, 0.02, -0.005], np.float32)
    js = jnm.CellList(jnp.asarray(means_s), jnp.asarray(covs), jnp.asarray(mask))
    jt = jnm.CellList(jnp.asarray(means_t), jnp.asarray(covs), jnp.asarray(mask))
    ts = tnm.CellList(torch.tensor(means_s), torch.tensor(covs),
                      torch.tensor(mask))
    tt = tnm.CellList(torch.tensor(means_t), torch.tensor(covs),
                      torch.tensor(mask))
    ref = jda.fgh_paired(jnp.asarray(d), jnp.asarray(T0), js, jt, M)
    _assert_fgh(tda.fgh_paired(torch.tensor(d), torch.tensor(T0), ts, tt, TM),
                ref)
    _assert_fgh(cuda_kernels.fgh_paired(torch.tensor(d), torch.tensor(T0),
                                        ts, tt, TM), ref)
    _, _, _, Q, _ = _case()
    _assert_fgh(tda.fgh_mahalanobis(torch.tensor(d), torch.tensor(
        np.asarray(Q))), jda.fgh_mahalanobis(jnp.asarray(d), Q))


def test_psd_project_matches_jax():
    rng = np.random.default_rng(2)
    for _ in range(20):
        A = rng.normal(0, 3, (3, 3)).astype(np.float32)
        H = (A + A.T).astype(np.float32)
        np.testing.assert_allclose(
            float(td2d._min_eig_sym3(torch.tensor(H))),
            float(jd2d._min_eig_sym3(jnp.asarray(H))), rtol=1e-4,
            atol=1e-4)
        np.testing.assert_allclose(
            td2d._psd_project(torch.tensor(H)).numpy(),
            np.asarray(jd2d._psd_project(jnp.asarray(H))), rtol=1e-4,
            atol=1e-4)


def _bowl(seed):
    """A smooth Gaussian-well cost that both frameworks evaluate with the
    same float32 operations: f = -a exp(-e'Ae/2) + d'Qd, e = d - c."""
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(3, 3)).astype(np.float32)
    A = (L @ L.T + 0.5 * np.eye(3)).astype(np.float32)
    c = rng.normal(scale=0.8, size=3).astype(np.float32)
    amp = np.float32(rng.uniform(5, 20))
    Q = (np.eye(3) * rng.uniform(0.01, 1)).astype(np.float32)

    def make(xp, outer, t):
        A_, c_, Q_ = t(A), t(c), t(Q)

        def fgh(d):
            e = d - c_
            Ae = A_ @ e
            E = xp.exp(-0.5 * (e @ Ae))
            return (-amp * E + d @ Q_ @ d, amp * E * Ae + 2 * Q_ @ d,
                    amp * E * (A_ - outer(Ae, Ae)) + 2 * Q_)
        return fgh

    return (make(jnp, jnp.outer, jnp.asarray),
            make(torch, torch.outer, torch.tensor))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("step_control", [True, False])
def test_newton_match_trials_match_jax(seed, step_control):
    m = MatcherParams(step_control=step_control)
    fj, ft = _bowl(seed)
    dj, sj, ij, cj = jax.jit(
        lambda: jd2d.newton_match(None, jnp.zeros(3), m, fj))()
    dt, st, it, ct = td2d.newton_match(ft, torch.zeros(3),
                                       interop.params_from_jax(m))
    assert int(it) == int(ij)
    assert bool(ct) == bool(cj)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-6)
    np.testing.assert_allclose(float(st), float(sj), rtol=1e-6)


def test_newton_match_real_cost_matches_jax():
    """The fuser's joint D2D + odometry cost of the first scan."""
    state, src, T0, Q, _ = _case()
    tstate, tsrc, tT0, tQ = _torch_case()

    def fj(d):
        a = jda.fgh_dense_flat(d, T0, src, state.packed, state.grid.origin,
                               0, H_, W_, RES, M)
        b = jda.fgh_mahalanobis(d, Q)
        return a[0] + b[0], a[1] + b[1], a[2] + b[2]

    def ft(d):
        a = cuda_kernels.fgh_dense_flat(d, tT0, tsrc, tstate.packed,
                                        tstate.grid.origin, H_, W_, RES,
                                        M.n_neighbours, M.lfd1, M.lfd2)
        b = tda.fgh_mahalanobis(d, tQ)
        return a[0] + b[0], a[1] + b[1], a[2] + b[2]

    dj, sj, ij, cj = jax.jit(
        lambda: jd2d.newton_match(None, jnp.zeros(3), M, fj))()
    dt, st, it, ct = td2d.newton_match(ft, torch.zeros(3), TM)
    assert bool(ct) == bool(cj)
    assert int(it) == int(ij)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=2e-5)
    np.testing.assert_allclose(float(st), float(sj), rtol=1e-5)


def test_packed_table_and_refresh_match_jax():
    """packed_from_grid and the incremental refresh after a second scan,
    against the reference and against a full re-finalize."""
    state, _, T0, _, seq = _case()
    tstate, _, _, _ = _torch_case()
    # Covariance rows come from (outer - n mean mean^T) / (n - 1): the
    # cancellation turns ulp differences of the mean into ~4e-6 absolute.
    np.testing.assert_allclose(
        td2d.packed_from_grid(tstate.grid, TP.ndt).numpy(),
        np.asarray(state.packed), rtol=1e-5, atol=1e-5)
    pts, mask = jds.scan_to_points(seq.ranges[1], seq.hit[1])
    wpts = jse2.transform_points(T0, pts)
    jg, jf = jnm.add_points_touched(state.grid, P.ndt, wpts, mask)
    jp = jd2d.refresh_packed(state.packed, jg, P.ndt, jf)
    tg, tf = tnm.add_points_touched(tstate.grid, TP.ndt,
                                    torch.tensor(np.asarray(wpts)),
                                    torch.tensor(np.asarray(mask)))
    tp = td2d.refresh_packed(tstate.packed, tg, TP.ndt, tf)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-5)
    # Invariant: refreshing the touched rows of the port's own table
    # equals re-finalizing the whole grid, bit for bit.
    tp_own = td2d.refresh_packed(td2d.packed_from_grid(tstate.grid, TP.ndt),
                                 tg, TP.ndt, tf)
    np.testing.assert_array_equal(
        tp_own.numpy(), td2d.packed_from_grid(tg, TP.ndt).numpy())
    np.testing.assert_array_equal(
        td2d.empty_pack_row("cpu").numpy(), np.asarray(jd2d.empty_pack_row()))
