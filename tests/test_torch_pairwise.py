"""The port's score functions (ops/d2d.py), `fgh_dense`, utils/pairwise.py
(P2D registration, closed-form alignment, extrinsic calibration),
`build_from_scan` / `occupancy_rescaled` and adaptive RANSAC against the
JAX package's on the CPU, with the same numpy inputs: 360-beam scans of
a simulated loop, 40 x 40 m maps.

Tolerances: scores rtol 1e-5, atol 1e-6 (the sums run in another
order); fgh_dense against the reference's fgh_dense and its Pallas
reduction (`pair_fgh_reduce(interpret=True)`, as
tests/test_pallas_kernels.py runs it): f rtol 1e-5, g and H rtol 1e-4
(atol 1e-4 of the largest entry, where an entry cancels); match_p2d
within 1 mm / 1 mrad with both converged (the reference takes autodiff
derivatives, the port the analytic ones: equal to rounding; the port's
Newton loop guards its PSD projection, d2d._psd_project);
icp_with_corr atol 1e-5; calibration scores rtol 1e-5 and the same best
candidate where it is unique; the map built from a scan equal to the
reference's (counts, sums, occupancy) and its rescaled occupancy within
1e-7; adaptive RANSAC with the reference's draws: the same
correspondences and inliers, the pose within 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_feature_graph_tpu.config import (
    FeatureParams, MatcherParams, NDTMapParams,
)
from ndt_feature_graph_tpu.core import se2 as jse2
from ndt_feature_graph_tpu.features import descriptor as jdesc
from ndt_feature_graph_tpu.features import detector as jdet
from ndt_feature_graph_tpu.features import ransac as jr
from ndt_feature_graph_tpu.io import dataset as jds
from ndt_feature_graph_tpu.ops import d2d as jd2d
from ndt_feature_graph_tpu.ops import d2d_analytic as jda
from ndt_feature_graph_tpu.ops import ndt_map as jnm
from ndt_feature_graph_tpu.ops import pallas_kernels
from ndt_feature_graph_tpu.utils import pairwise as jpw
from ndt_feature_graph_tpu_torch import interop
from ndt_feature_graph_tpu_torch.features import ransac as tr
from ndt_feature_graph_tpu_torch.ops import cuda_kernels
from ndt_feature_graph_tpu_torch.ops import d2d as td2d
from ndt_feature_graph_tpu_torch.ops import d2d_analytic as tda
from ndt_feature_graph_tpu_torch.ops import ndt_map as tnm
from ndt_feature_graph_tpu_torch.ops.ndt_map import CellList
from ndt_feature_graph_tpu_torch.utils import pairwise as tpw

torch.set_num_threads(2)
MP = NDTMapParams(resolution=0.5, size_x=40.0, size_y=40.0,
                  sensor_range=15.0, max_points_per_scan=360, max_cells=512)
M = MatcherParams()
TMP, TM = interop.params_from_jax(MP), interop.params_from_jax(M)
FP = FeatureParams(num_beams=360, max_range=15.0)
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-6
F_RTOL, GH_RTOL = 1e-5, 1e-4
T = lambda x: torch.tensor(np.asarray(x))  # noqa: E731


@functools.lru_cache(maxsize=None)
def _seq():
    traj = jds.loop_trajectory(30, radius=4.5)
    s = jds.simulate_sequence(jax.random.PRNGKey(3), traj, num_beams=360,
                              max_range=15.0)
    return jax.tree.map(np.asarray, s)


def _points(k):
    s = _seq()
    pts, mask = jds.scan_to_points(jnp.asarray(s.ranges[k]),
                                   jnp.asarray(s.hit[k]))
    return np.asarray(pts), np.asarray(mask)


@functools.lru_cache(maxsize=None)
def _target(k=0):
    """The reference's map of scan k in its sensor frame, as its
    DenseTarget (numpy) and the port's DenseTarget of the same arrays."""
    pts, mask = _points(k)
    g = jnm.build_from_scan(MP, jnp.zeros(2), jnp.zeros(2),
                            jnp.asarray(pts), jnp.asarray(mask))
    jt = jax.tree.map(np.asarray, jd2d.make_dense_target(g, MP))
    tt = td2d.DenseTarget(T(jt.origin), T(jt.means), T(jt.covs),
                          T(jt.valid), T(jt.packed))
    return jt, tt


def _source(k, n_cells=None):
    """Scan k's points as P2D pseudo-cells (both packages), optionally
    with a mask of every third point off."""
    pts, mask = _points(k)
    if n_cells == "thinned":
        mask = mask & (np.arange(mask.size) % 3 != 0)
    j = jpw.points_as_cells(jnp.asarray(pts), jnp.asarray(mask))
    t = tpw.points_as_cells(T(pts), T(mask))
    np.testing.assert_array_equal(t.covs.numpy(), np.asarray(j.covs))
    return j, t


def _pose(k0, k1, off=(0.04, -0.03, 0.01)):
    s = _seq()
    return np.asarray(jse2.sub(s.gt[k0], s.gt[k1])) + np.asarray(
        off, np.float32)


@pytest.mark.parametrize("k", [3, 8])
def test_build_from_scan_and_occupancy_match_jax(k):
    pts, mask = _points(k)
    center = np.array([0.7, -1.2], np.float32)
    g = jnm.build_from_scan(MP, jnp.asarray(center), jnp.zeros(2),
                            jnp.asarray(pts), jnp.asarray(mask))
    t = tnm.build_from_scan(TMP, T(center), torch.zeros(2), T(pts), T(mask))
    for f in ("origin", "count", "psum", "occ"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(g, f)), f)
    np.testing.assert_allclose(t.outer.numpy(), np.asarray(g.outer),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tnm.occupancy_rescaled(t).numpy(),
                               np.asarray(jnm.occupancy_rescaled(g)),
                               rtol=0, atol=1e-7)


def test_pair_score_matches_jax():
    rng = np.random.default_rng(0)
    mu = rng.normal(size=(50, 2)).astype(np.float32)
    L = rng.normal(size=(50, 2, 2)).astype(np.float32) * 0.3
    cov = (L @ L.transpose(0, 2, 1) + 0.01 * np.eye(2)).astype(np.float32)
    np.testing.assert_allclose(
        td2d.pair_score(T(mu), T(cov), M.lfd1, M.lfd2).numpy(),
        np.asarray(jd2d.pair_score(mu, cov, M.lfd1, M.lfd2)),
        rtol=SCORE_RTOL, atol=SCORE_ATOL)


@pytest.mark.parametrize("src_k,off", [(2, (0.04, -0.03, 0.01)),
                                       (5, (-0.2, 0.1, -0.05)),
                                       (9, (0.0, 0.0, 0.0))])
def test_dense_scores_match_jax(src_k, off):
    jt, tt = _target()
    js, ts = _source(src_k, "thinned")
    T0 = _pose(0, src_k, off)
    d = np.array([0.01, -0.02, 0.003], np.float32)
    want = float(jd2d.d2d_score_dense(jnp.asarray(d), jnp.asarray(T0), js,
                                      jd2d.DenseTarget(*jt), MP, M))
    got = float(td2d.d2d_score_dense(T(d), T(T0), ts, tt, TMP, TM))
    np.testing.assert_allclose(got, want, rtol=SCORE_RTOL, atol=SCORE_ATOL)
    assert want < -1.0
    h, w = jt.valid.shape
    flat = float(td2d.d2d_score_dense_flat(
        T(d), T(T0), ts, tt.packed, tt.origin, 0, h, w, MP.resolution, TM))
    jflat = float(jd2d.d2d_score_dense_flat(
        jnp.asarray(d), jnp.asarray(T0), js, jnp.asarray(jt.packed),
        jnp.asarray(jt.origin), 0, h, w, MP.resolution, M))
    np.testing.assert_allclose(flat, jflat, rtol=SCORE_RTOL,
                               atol=SCORE_ATOL)
    np.testing.assert_allclose(flat, got, rtol=SCORE_RTOL, atol=SCORE_ATOL)


def test_paired_and_mahalanobis_scores_match_jax():
    rng = np.random.default_rng(4)
    n = 40
    mk = lambda: (rng.normal(0, 4, (n, 2)).astype(np.float32),  # noqa
                  np.tile(np.eye(2, dtype=np.float32) * 2e-2, (n, 1, 1)),
                  rng.random(n) < 0.7)
    (sm, sc, sk), (tm_, tc, tk) = mk(), mk()
    d = np.array([0.1, -0.2, 0.05], np.float32)
    T0 = np.array([0.5, 0.3, -0.4], np.float32)
    want = float(jd2d.d2d_score_paired(
        jnp.asarray(d), jnp.asarray(T0), jnm.CellList(sm, sc, sk),
        jnm.CellList(tm_, tc, tk), M))
    got = float(td2d.d2d_score_paired(
        T(d), T(T0), CellList(T(sm), T(sc), T(sk)),
        CellList(T(tm_), T(tc), T(tk)), TM))
    np.testing.assert_allclose(got, want, rtol=SCORE_RTOL, atol=SCORE_ATOL)
    Q = rng.normal(size=(3, 3)).astype(np.float32)
    np.testing.assert_allclose(
        float(td2d.mahalanobis_score(T(d), T(Q))),
        float(jd2d.mahalanobis_score(jnp.asarray(d), jnp.asarray(Q))),
        rtol=SCORE_RTOL, atol=SCORE_ATOL)


def _fgh_close(got, want):
    (f, g, H), (fr, gr, Hr) = ([np.asarray(x, np.float64) for x in v]
                               for v in (got, want))
    np.testing.assert_allclose(f, fr, rtol=F_RTOL, atol=SCORE_ATOL)
    for x, xr in ((g, gr), (H, Hr)):
        np.testing.assert_allclose(x, xr, rtol=GH_RTOL,
                                   atol=GH_RTOL * np.abs(xr).max())


@pytest.mark.parametrize("src_k,off", [(2, (0.04, -0.03, 0.01)),
                                       (6, (-0.1, 0.15, 0.04))])
def test_fgh_dense_matches_jax_and_the_pallas_reduction(src_k, off):
    jt, tt = _target()
    js, ts = _source(src_k)
    T0 = _pose(0, src_k, off)
    d = np.array([0.01, -0.02, 0.003], np.float32)
    jtgt = jd2d.DenseTarget(*jt)
    want = jda.fgh_dense(jnp.asarray(d), jnp.asarray(T0), js, jtgt, MP, M)
    before = dict(cuda_kernels.LAUNCHES)
    got = tda.fgh_dense(T(d), T(T0), ts, tt, TMP, TM)
    assert dict(cuda_kernels.LAUNCHES) == before   # the CPU's plain twin
    _fgh_close(got, want)
    # The reference's Pallas kernel on the same gathered pairs.
    moved = js.transform(jd2d._apply_increment(jnp.asarray(d),
                                               jnp.asarray(T0)))
    rel = (moved.means - jtgt.origin) / MP.resolution
    ix0 = jnp.floor(rel[..., 0]).astype(jnp.int32)
    iy0 = jnp.floor(rel[..., 1]).astype(jnp.int32)
    tmeans, tcovs, tvalid = jd2d.gather_windows(jtgt, iy0, ix0,
                                                M.n_neighbours)
    pallas = pallas_kernels.pair_fgh_reduce(
        moved.means[:, None, :] - tmeans,
        moved.covs[:, None, :, :] + tcovs,
        (moved.means - jnp.asarray(d)[:2])[:, None, :],
        moved.covs[:, None, :, :], tvalid & moved.mask[:, None],
        M.lfd1, M.lfd2, interpret=True)
    _fgh_close(got, pallas)
    # ... and the gathered windows are the port's.
    _, tiy, tix = tda.window_cells(T(d), T(T0), ts, tt.origin,
                                   MP.resolution)
    twin = td2d.gather_windows(tt, tiy, tix, M.n_neighbours)
    np.testing.assert_array_equal(twin[2].numpy(), np.asarray(tvalid))


@pytest.mark.parametrize("src_k,off", [(3, (0.05, -0.04, 0.02)),
                                       (6, (-0.06, 0.05, -0.02)),
                                       (10, (0.0, 0.0, 0.0))])
def test_match_p2d_matches_jax(src_k, off):
    jt, tt = _target()
    pts, mask = _points(src_k)
    T0 = _pose(0, src_k, off)
    jres = jpw.match_p2d(jd2d.DenseTarget(*jt), jnp.asarray(pts),
                         jnp.asarray(mask), jnp.asarray(T0), MP, M)
    tres = tpw.match_p2d(tt, T(pts), T(mask), T(T0), TMP, TM)
    assert bool(jres.converged) and bool(tres.converged)
    jT, tT = np.asarray(jres.T), tres.T.numpy()
    assert np.abs(tT[:2] - jT[:2]).max() <= 1e-3
    assert abs(float(jse2.normalize_angle(tT[2] - jT[2]))) <= 1e-3
    np.testing.assert_allclose(float(tres.score), float(jres.score),
                               rtol=1e-4)
    # It registers: the pose comes back to the ground truth's.
    gt_rel = _pose(0, src_k, (0, 0, 0))
    assert np.abs(tT[:2] - gt_rel[:2]).max() < 0.05


def test_guarded_psd_projection_leaves_no_indefinite_hessian():
    """With the guard (match_p2d's), the projected Hessian plus the
    smallest LM damping (1e-3) is positive definite for every indefinite
    Hessian of a random sample at the scales registration meets (entries
    1 to 1e4), and stays the reference's projection to float32 rounding;
    without it, the port's projection is the one the other paths have
    always taken."""
    rng = np.random.default_rng(1)
    n = 20000
    L = rng.normal(size=(n, 3, 3)) * 10 ** rng.uniform(0, 4, (n, 1, 1))
    H = (L + L.transpose(0, 2, 1)).astype(np.float32)
    H = H[np.linalg.eigvalsh(H.astype(np.float64))[:, 0] < 0]
    low = lambda x: np.linalg.eigvalsh(  # noqa: E731
        x.astype(np.float64) + 1e-3 * np.eye(3))[:, 0]
    guarded = td2d._psd_project(torch.tensor(H), guard=True).numpy()
    plain = td2d._psd_project(torch.tensor(H)).numpy()
    ref = np.asarray(jax.vmap(jd2d._psd_project)(jnp.asarray(H)))
    assert len(H) > 10000 and (low(guarded) > 0).all()
    assert (low(plain) <= 0).any() and (low(ref) <= 0).any()
    for x in (guarded, plain):
        np.testing.assert_allclose(x, ref, rtol=0,
                                   atol=1e-5 * np.abs(H).max())
    shift = np.clip(-td2d._min_eig_sym3(torch.tensor(H)).numpy(), 0, None)
    np.testing.assert_array_equal(plain, (torch.tensor(H) + torch.tensor(
        shift)[:, None, None] * torch.eye(3)).numpy())


def test_icp_with_corr_matches_jax():
    rng = np.random.default_rng(6)
    b = rng.normal(0, 3, (60, 2)).astype(np.float32)
    pose = np.array([0.4, -0.7, 0.3], np.float32)
    a = np.asarray(jse2.transform_points(jnp.asarray(pose), b)) + rng.normal(
        0, 0.01, b.shape).astype(np.float32)
    w = (rng.random(60) < 0.8).astype(np.float32)
    want = np.asarray(jpw.icp_with_corr(jnp.asarray(a), jnp.asarray(b),
                                        jnp.asarray(w)))
    got = tpw.icp_with_corr(T(a), T(b), T(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, pose, atol=0.02)


@pytest.mark.parametrize("chunk_elems", [1 << 24, 50_000])
def test_extrinsic_calibration_matches_jax(chunk_elems, monkeypatch):
    """Three pairs of the loop, seven scans apart: the summed scores of
    the 7^3 grid, and the same, unique best candidate; in one chunk of
    candidates a pair, and in many."""
    monkeypatch.setattr(tpw, "CALIB_CHUNK_ELEMS", chunk_elems)
    s = _seq()
    pairs_j, pairs_t, rels = [], [], []
    for k in (0, 7, 14):
        (pa, ma), (pb, mb) = _points(k), _points(k + 7)
        pairs_j.append(((jnp.asarray(pa), jnp.asarray(ma)),
                        (jnp.asarray(pb), jnp.asarray(mb))))
        pairs_t.append(((T(pa), T(ma)), (T(pb), T(mb))))
        rels.append(np.asarray(jse2.sub(s.gt[k], s.gt[k + 7])))
    jbest, jscores = jpw.calibrate_extrinsic(pairs_j, rels, 0.4, 0.25, 7)
    cand = tpw.candidate_grid(0.4, 0.25, 7)
    tscores = sum(tpw.extrinsic_calibration_score(*pt[0], *pt[1], T(r),
                                                  cand)
                  for pt, r in zip(pairs_t, rels))
    tbest, tscores2 = tpw.calibrate_extrinsic(pairs_t, [T(r) for r in rels],
                                              0.4, 0.25, 7)
    jscores = np.asarray(jscores)
    np.testing.assert_allclose(tscores.numpy(), jscores, rtol=1e-5)
    np.testing.assert_allclose(tscores2.numpy(), jscores, rtol=1e-5)
    # The reference's candidates are its XLA linspace's: within an ulp.
    xs = np.asarray(jnp.linspace(-0.4, 0.4, 7))
    np.testing.assert_allclose(cand[::49, 0].numpy(), xs, rtol=0, atol=1e-7)
    ties = np.flatnonzero(jscores <= jscores.min() * (1 + 1e-5))
    assert ties.tolist() == [int(np.argmin(jscores))]
    assert int(torch.argmin(tscores2)) == ties[0]
    np.testing.assert_allclose(tbest.numpy(), np.asarray(jbest), atol=1e-7)


def _features(pose, key):
    r, h = jds.raycast(jds.default_world(), jnp.asarray(pose, jnp.float32),
                       360, 15.0)
    r = r + 0.01 * jax.random.normal(key, r.shape) * h
    f = jdet.detect(FP, r, h)
    return f, jdesc.describe(FP, f, r, h)


_ADAPTIVE = {
    "fuser": FP,
    "flirtlib_ros": FP.replace(ransac_success_prob=0.95,
                               ransac_inlier_ratio=0.4,
                               ransac_dist_threshold=0.4,
                               ransac_rigidity=0.0384),
    "startup": FP.replace(ransac_success_prob=0.98, ransac_inlier_ratio=0.4,
                          ransac_dist_threshold=0.4,
                          ransac_rigidity=0.0384),
}


@pytest.mark.parametrize("case", ["budget", "recall3", "recall11"])
@pytest.mark.parametrize("variant", sorted(_ADAPTIVE))
def test_ransac_adaptive_matches_jax(case, variant):
    """tests/test_features.py's cases (its budget pair, and pairs of its
    recall scenario) with the adaptive stopping bound on, the reference's
    draws injected."""
    if case == "budget":
        pose1 = jnp.array([0.0, -4.0, 0.3])
        pose2 = jnp.array([0.6, -3.8, 0.55])
        k1 = k2 = None
        key = jax.random.PRNGKey(4)
        (f1, d1), (f2, d2) = (
            (jdet.detect(FP, *r), jdesc.describe(FP, jdet.detect(FP, *r), *r))
            for r in (jds.raycast(jds.default_world(), p, 360, 15.0)
                      for p in (pose1, pose2)))
    else:
        seed = int(case[6:])
        _, traj = jds.random_loop_scenario(seed, n_steps=40)
        rng = np.random.default_rng(1000 + seed)
        pose1 = traj[rng.integers(len(traj))]
        off = jnp.asarray([rng.uniform(-0.5, 0.5), rng.uniform(-0.5, 0.5),
                           rng.uniform(-0.3, 0.3)], jnp.float32)
        pose2 = jse2.compose(pose1, off)
        k1, k2, key = jax.random.split(jax.random.PRNGKey(seed), 3)
        (f1, d1), (f2, d2) = _features(pose1, k1), _features(pose2, k2)
    fp = _ADAPTIVE[variant].replace(ransac_adaptive=True)
    u = jax.random.uniform(jax.random.split(key)[0],
                           (fp.ransac_hypotheses, 2))
    jres = jr.match_sets(fp, f1, d1, f2, d2, key)
    to = lambda f: interop.feature_set_from_jax(  # noqa: E731
        jax.tree.map(np.asarray, f), "cpu")
    tres = tr.match_sets(interop.params_from_jax(fp), to(f1), T(d1), to(f2),
                         T(d2), T(u))
    for name in ("corr_ref", "corr_mov", "corr_mask", "inlier_mask",
                 "num_inliers", "valid"):
        np.testing.assert_array_equal(getattr(tres, name).numpy(),
                                      np.asarray(getattr(jres, name)), name)
    np.testing.assert_allclose(tres.T.numpy(), np.asarray(jres.T),
                               atol=1e-5)
    np.testing.assert_allclose(float(tres.score), float(jres.score),
                               rtol=1e-5, atol=1e-6)


def test_ransac_adaptive_bound_is_the_references():
    """The adaptive mask on its own: hypotheses stop at the float32
    bound ceil(log1p(-p) / log1p(-w^2)) of the best inlier ratio before
    them, a running max, batched over leading dims."""
    fp = _ADAPTIVE["flirtlib_ros"].replace(ransac_adaptive=True)
    tfp = interop.params_from_jax(fp)
    rng = np.random.default_rng(0)
    m_hyp, c = 12, 10
    r2 = rng.uniform(0, 2 * fp.ransac_acceptance, (2, m_hyp, c)).astype(
        np.float32)
    corr = rng.random((2, c)) < 0.8
    ok = rng.random((2, m_hyp)) < 0.9
    got = tr.adaptive_considered(tfp, T(r2), T(corr), T(ok)).numpy()
    p = fp.ransac_success_prob
    for b in range(2):
        inl = ((r2[b] < fp.ransac_acceptance) & corr[b]).sum(-1)
        ratio = np.where(ok[b], inl / np.float32(max(corr[b].sum(), 1)), 0)
        run = np.maximum.accumulate(np.maximum(ratio, np.float32(
            fp.ransac_inlier_ratio)).astype(np.float32))
        prev = np.concatenate([[np.float32(fp.ransac_inlier_ratio)],
                               run[:-1]]).astype(np.float32)
        w2 = np.clip(prev * prev, np.float32(1e-9), np.float32(1 - 1e-6))
        bound = np.float32(np.log1p(-p)) / np.log1p(-w2)
        np.testing.assert_array_equal(got[b], np.arange(m_hyp) < np.ceil(
            bound))
