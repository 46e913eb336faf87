"""Parity of the port's localization (ops/distance_field.py,
localization/{monitor,mcl,place_rec}.py, the dense target of ops/d2d.py)
with the JAX reference: the six scenarios of tests/test_localization.py
run through both packages on the same numpy inputs and the reference's
own draws (replayed from its key chain), plus per-function cases.

Tolerances: distance fields exact (square roots of integers, correctly
rounded on both sides); grids and targets 1e-5 (scatter and finalize
rounding, tests/test_torch_ndt_map.py); badness 1e-6 m (a median of
field values); MCL estimates within the reference's own spread under
a 1e-6 change of the odometry, measured here (the log-likelihood sums
and the resampling CDF round differently, and a comb tooth within
rounding of a CDF step picks the neighbouring particle); RANSAC poses
1e-4 m / rad.
"""

import dataclasses
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_feature_graph_tpu.config import (
    FeatureParams, MotionParams, NDTMapParams,
)
from ndt_feature_graph_tpu.core import se2 as jse2
from ndt_feature_graph_tpu.io import dataset as jds
from ndt_feature_graph_tpu.io import serialize as jser
from ndt_feature_graph_tpu.localization import mcl as jmcl
from ndt_feature_graph_tpu.localization import monitor as jmon
from ndt_feature_graph_tpu.localization import place_rec as jpr
from ndt_feature_graph_tpu.ops import d2d as jd2d
from ndt_feature_graph_tpu.ops import distance_field as jdf
from ndt_feature_graph_tpu.ops import ndt_map as jnm
from ndt_feature_graph_tpu_torch import interop
from ndt_feature_graph_tpu_torch.localization import mcl, monitor, place_rec
from ndt_feature_graph_tpu_torch.ops import d2d, distance_field, ndt_map

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "make_torch_port_fixture",
    ROOT / "examples" / "make_torch_port_fixture.py")
fixture_gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixture_gen)

MAP = NDTMapParams(resolution=0.5, size_x=24.0, size_y=24.0,
                   sensor_range=15.0, max_points_per_scan=512, max_cells=512)
TMAP = interop.params_from_jax(MAP)
FP = FeatureParams(num_beams=360, max_range=15.0)
TFP = interop.params_from_jax(FP)
TMP = interop.params_from_jax(MotionParams())
CPU = torch.device("cpu")
POSES = [(0.0, -4.5, 0.0), (2.0, -4.5, 1.0), (-2.0, -4.0, 2.0),
         (0.0, 0.0, 0.5)]


def t(x, dt=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dt)


def _scan(pose):
    p = jnp.asarray(pose, jnp.float32)
    rng, hit = jds.raycast(jds.default_world(), p, 360, 15.0)
    return np.asarray(rng), np.asarray(hit)


def _points(rng, hit):
    pts, mask = jds.scan_to_points(jnp.asarray(rng), jnp.asarray(hit))
    return np.asarray(pts), np.asarray(mask)


@functools.lru_cache(maxsize=None)
def _world_grids():
    """The reference test's map (scans from four poses fused at their
    true poses) built by both packages from the same points."""
    jg = jnm.empty_grid(MAP, jnp.zeros(2))
    tg = ndt_map.empty_grid(TMAP, torch.zeros(2))
    for pose in POSES:
        p = np.asarray(pose, np.float32)
        pts, mask = _points(*_scan(pose))
        world = np.asarray(jse2.transform_points(jnp.asarray(p), pts))
        jg = jnm.add_points(jg, MAP, jnp.asarray(world), jnp.asarray(mask))
        jg = jnm.update_occupancy(jg, MAP, jnp.asarray(p[:2]),
                                  jnp.asarray(world), jnp.asarray(mask))
        tg = ndt_map.add_points(tg, TMAP, t(world), t(mask, torch.bool))
        tg = ndt_map.update_occupancy(tg, TMAP, t(p[:2]), t(world),
                                      t(mask, torch.bool))
    return jg, tg


def _dmaps():
    jg, tg = _world_grids()
    return (jmon.build_distance_map(jg.occ, jg.origin, MAP.resolution),
            monitor.build_distance_map(tg.occ, tg.origin, TMAP.resolution))


# ---- the six scenarios of tests/test_localization.py ----

def test_distance_field_exact_small():
    occ = np.zeros((16, 16), bool)
    occ[8, 8] = True
    d = distance_field.distance_field(t(occ, torch.bool)).numpy()
    np.testing.assert_array_equal(
        d, np.asarray(jdf.distance_field(jnp.asarray(occ))))
    assert d[8, 8] == 0.0 and d[8, 12] == 4.0 and d[5, 4] == 5.0


def test_distance_field_multiple_seeds():
    occ = np.zeros((32, 32), bool)
    occ[4, 4] = occ[28, 28] = True
    d = distance_field.distance_field(t(occ, torch.bool)).numpy()
    np.testing.assert_array_equal(
        d, np.asarray(jdf.distance_field(jnp.asarray(occ))))
    ys, xs = np.mgrid[0:32, 0:32]
    ref = np.minimum(np.hypot(ys - 4, xs - 4), np.hypot(ys - 28, xs - 28))
    np.testing.assert_allclose(d, ref, atol=1e-4)


def test_scan_pose_evaluator():
    jdm, tdm = _dmaps()
    np.testing.assert_array_equal(tdm.dist.numpy(), np.asarray(jdm.dist))
    true_pose = np.asarray([0.5, -4.0, 0.3], np.float32)
    pts, mask = _points(*_scan(true_pose))
    for off in ([0, 0, 0], [1.5, 1.0, 0.4], [0.2, -0.15, 0.05]):
        pose = true_pose + np.asarray(off, np.float32)
        jb = float(jmon.badness(jdm, jnp.asarray(pose), pts, mask))
        tb = float(monitor.badness(tdm, t(pose), t(pts),
                                   t(mask, torch.bool)))
        assert abs(tb - jb) <= 1e-6, (off, tb, jb)
    good = float(monitor.badness(tdm, t(true_pose), t(pts),
                                 t(mask, torch.bool)))
    bad = float(monitor.badness(tdm, t(true_pose + [1.5, 1.0, 0.4]),
                                t(pts), t(mask, torch.bool)))
    assert good < 0.3 and bad > good * 2
    off_pose = true_pose + np.asarray([0.2, -0.15, 0.05], np.float32)
    ja, js = jmon.adjust_pose(jdm, jnp.asarray(off_pose), pts, mask)
    ta, ts = monitor.adjust_pose(tdm, t(off_pose), t(pts),
                                 t(mask, torch.bool))
    assert abs(float(ts) - float(js)) <= 1e-6
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-6)
    assert float(ts) <= float(monitor.badness(
        tdm, t(off_pose), t(pts), t(mask, torch.bool))) + 1e-6


def _mcl_sequence():
    traj = jds.corridor_trajectory(20, x0=-3.0, x1=2.0, y=-4.5)
    return jds.simulate_sequence(jax.random.PRNGKey(0), traj,
                                 num_beams=360, max_range=15.0)


def _jax_mcl(seq, tgt, odom_eps=0.0):
    rec = fixture_gen.recording_mcl_class()(MAP, MotionParams(), tgt,
                                            n_particles=512, seed=1)
    rec.initialize(seq.gt[0], spread_xy=0.5, spread_theta=0.2)
    for k in range(1, seq.gt.shape[0]):
        pts, mask = jds.scan_to_points(seq.ranges[k], seq.hit[k])
        rec.step(seq.odom[k] + odom_eps, pts, mask)
    return rec


@functools.lru_cache(maxsize=None)
def _mcl_runs():
    """JAX's run (recorded), its run with the odometry moved by 1e-6
    (the reference's own spread) and the port's run on JAX's draws."""
    seq = _mcl_sequence()
    jg, tg = _world_grids()
    jt = jd2d.make_dense_target(jg, MAP)
    rec = _jax_mcl(seq, jt)
    eps = _jax_mcl(seq, jt, 1e-6)
    dr = fixture_gen.mcl_draws(rec)
    loc = mcl.MCL(TMAP, TMP, d2d.make_dense_target(tg, TMAP),
                  n_particles=512, draws=mcl.recorded_draws(
                      t(dr["init_xy"]), t(dr["init_theta"]), t(dr["noise"]),
                      dr["resampled"], t(dr["u0"])))
    loc.initialize(t(np.asarray(seq.gt[0])), spread_xy=0.5,
                   spread_theta=0.2)
    est = []
    for k in range(1, seq.gt.shape[0]):
        pts, mask = _points(seq.ranges[k], seq.hit[k])
        est.append(loc.step(t(seq.odom[k]), t(pts),
                            t(mask, torch.bool)).numpy())
    return seq, rec, eps, np.stack(est), loc


def _pose_dev(a, b):
    dth = a[..., 2] - b[..., 2]
    return max(float(np.abs(a[..., :2] - b[..., :2]).max()),
               float(np.abs(np.arctan2(np.sin(dth), np.cos(dth))).max()))


def test_mcl_tracks_and_localizes():
    """The port's MCL on the reference's draws: the same resampling
    decisions, every estimate within the reference's own spread (its
    run with the odometry moved by 1e-6, at least 1e-4), and the
    reference test's tracking bound."""
    seq, rec, eps, est, loc = _mcl_runs()
    ref = np.stack(rec.estimates)
    spread = max(_pose_dev(np.stack(eps.estimates), ref), 1e-4)
    assert loc.resampled == rec.resampled and any(loc.resampled)
    assert _pose_dev(est, ref) <= spread, (_pose_dev(est, ref), spread)
    errs = np.linalg.norm(est[:, :2] - np.asarray(seq.gt)[1:, :2], axis=1)
    assert np.mean(errs[10:]) < 0.3, errs


def test_place_recognition_roundtrip():
    jdb = jpr.empty_database(FP, capacity=8)
    tdb = place_rec.empty_database(TFP, 8, device="cpu")
    stored = [(0.0, -4.5, 0.0), (5.0, -4.5, 1.5), (-6.0, 0.0, 2.0),
              (5.0, 5.0, -2.0)]
    for p in stored:
        rng, hit = _scan(p)
        jdb = jpr.insert_scan(jdb, FP, jnp.asarray(p, jnp.float32), rng, hit)
        tdb = place_rec.insert_scan(tdb, TFP, t(p), t(rng),
                                    t(hit, torch.bool))
    assert int(tdb.mask.sum()) == 4
    _db_close(jdb, tdb)
    tdb2 = place_rec.insert_scan(tdb, TFP, t([0.1, -4.4, 0.2]), t(rng),
                                 t(hit, torch.bool))
    assert int(tdb2.mask.sum()) == 4
    query = np.asarray([5.3, -4.3, 1.7], np.float32)
    _relocalize_both(jdb, tdb, query, jax.random.PRNGKey(2))


def test_scan_database_persists(tmp_path):
    """Save and load (bit-exact), then relocalize from the loaded
    database and keep inserting, as the reference test does."""
    tdb = place_rec.empty_database(TFP, 8, device="cpu")
    for p in [(0.0, -4.5, 0.0), (5.0, -4.5, 1.5), (-6.0, 0.0, 2.0)]:
        rng, hit = _scan(p)
        tdb = place_rec.insert_scan(tdb, TFP, t(p), t(rng),
                                    t(hit, torch.bool))
    path = tmp_path / "scan_db.npz"
    place_rec.save_database(path, tdb)
    tdb2 = place_rec.load_database(path, TFP, device="cpu")
    for a, b in zip(_leaves(tdb), _leaves(tdb2)):
        assert torch.equal(a, b)
    jdb2 = jpr.load_database(path, FP)
    query = np.asarray([5.3, -4.3, 1.7], np.float32)
    _relocalize_both(jdb2, tdb2, query, jax.random.PRNGKey(2))
    rng, hit = _scan((5.0, 5.0, -2.0))
    tdb3 = place_rec.insert_scan(tdb2, TFP, t([5.0, 5.0, -2.0]), t(rng),
                                 t(hit, torch.bool))
    assert int(tdb3.mask.sum()) == 4


# ---- per-function cases ----

def _leaves(db):
    return [db.poses, *(getattr(db.feats, f.name)
                        for f in dataclasses.fields(db.feats)),
            db.desc, db.mask]


def _db_close(jdb, tdb):
    jl = [jdb.poses, *jdb.feats, jdb.desc, jdb.mask]
    for a, b in zip(jl, _leaves(tdb)):
        np.testing.assert_allclose(b.numpy().astype(np.float64),
                                   np.asarray(a, np.float64), atol=1e-4)


def _relocalize_both(jdb, tdb, query, key):
    rng, hit = _scan(query)
    jpose, jbest, jn = jpr.relocalize(jdb, FP, rng, hit, key,
                                      min_num_matches=5)
    u = fixture_gen.relocalize_draws(key, tdb.poses.shape[0],
                                     FP.ransac_hypotheses)
    tpose, tbest, tn = place_rec.relocalize(tdb, TFP, t(rng),
                                            t(hit, torch.bool), t(u),
                                            min_num_matches=5)
    assert (tbest, tn) == (jbest, jn) and tpose is not None
    np.testing.assert_allclose(tpose, jpose, atol=1e-4)
    np.testing.assert_allclose(tpose[:2], query[:2], atol=0.5)


def test_database_crosses_packages(tmp_path):
    """A database the JAX package saved loads in the port, and one the
    port saved loads in the JAX package, leaf for leaf."""
    jdb = jpr.empty_database(FP, capacity=4)
    tdb = place_rec.empty_database(TFP, 4, device="cpu")
    for p in [(0.0, -4.5, 0.0), (5.0, -4.5, 1.5)]:
        rng, hit = _scan(p)
        jdb = jpr.insert_scan(jdb, FP, jnp.asarray(p, jnp.float32), rng, hit)
        tdb = place_rec.insert_scan(tdb, TFP, t(p), t(rng),
                                    t(hit, torch.bool))
    jpr.save_database(tmp_path / "jax.npz", jdb)
    place_rec.save_database(tmp_path / "port.npz", tdb)
    from_jax = place_rec.load_database(tmp_path / "jax.npz", TFP,
                                       device="cpu")
    for a, b in zip([jdb.poses, *jdb.feats, jdb.desc, jdb.mask],
                    _leaves(from_jax)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    from_port = jpr.load_database(tmp_path / "port.npz", FP)
    for a, b in zip(jax.tree.leaves(from_port), _leaves(tdb)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    with np.load(tmp_path / "jax.npz") as a, \
            np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)


def test_dense_target_matches_jax():
    jg, tg = _world_grids()
    jt = jd2d.make_dense_target(jg, MAP)
    tt = d2d.make_dense_target(tg, TMAP)
    np.testing.assert_array_equal(tt.valid.numpy(), np.asarray(jt.valid))
    for a, b in ((jt.means, tt.means), (jt.covs, tt.covs),
                 (jt.packed, tt.packed)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)
    h, w = TMAP.grid_h, TMAP.grid_w
    back = d2d.dense_from_packed(d2d.PackedTarget(tt.origin, tt.packed), h, w)
    assert torch.equal(back.means, tt.means)
    assert torch.equal(back.valid, tt.valid)
    # The table keeps c01 for both off-diagonal entries.
    for i, j in ((0, 0), (0, 1), (1, 1)):
        assert torch.equal(back.covs[..., i, j], tt.covs[..., i, j])
    assert torch.equal(back.covs[..., 1, 0], tt.covs[..., 0, 1])


@pytest.mark.parametrize("seed", [0, 1])
def test_distance_field_matches_jax_on_a_map(seed):
    """Random obstacles on a non-square grid (edges, ties): exact."""
    occ = np.random.default_rng(seed).random((37, 52)) < 0.02
    np.testing.assert_array_equal(
        distance_field.distance_field(t(occ, torch.bool)).numpy(),
        np.asarray(jdf.distance_field(jnp.asarray(occ))))


@pytest.mark.parametrize("n_valid", [6, 7])
def test_badness_median_of_an_even_count(n_valid):
    """jnp.nanmedian averages the two middle values of an even count;
    torch.nanmedian returns the lower one.  The port's median is the
    reference's on both counts."""
    _, tdm = _dmaps()
    jdm, _ = _dmaps()
    pose = np.asarray([0.5, -4.0, 0.3], np.float32)
    pts, mask = _points(*_scan(pose))
    mask = mask.copy()
    keep = np.flatnonzero(mask)[::37][:n_valid]
    mask[:] = False
    mask[keep] = True
    jb = float(jmon.badness(jdm, jnp.asarray(pose), pts, mask))
    tb = float(monitor.badness(tdm, t(pose), t(pts), t(mask, torch.bool)))
    assert tb == jb
    d = monitor._endpoint_distances(tdm, t(pose), t(pts),
                                    t(mask, torch.bool))
    lower = float(torch.nanmedian(d))
    assert (lower != tb) == (n_valid % 2 == 0
                             and len(set(d[keep].tolist())) > 1)


def test_particle_functions_match_jax():
    """init_uniform, predict, weight, resample and estimate, each on the
    reference's inputs and draws."""
    jg, tg = _world_grids()
    jt, tt = jd2d.make_dense_target(jg, MAP), d2d.make_dense_target(tg, TMAP)
    key = jax.random.PRNGKey(5)
    k_init, k_pred, k_res = jax.random.split(key, 3)
    center = jnp.asarray([0.0, -4.5, 0.1])
    jp = jmcl.init_uniform(k_init, 256, center, 0.5, 0.2)
    k1, k2 = jax.random.split(k_init)
    u_xy = jax.random.uniform(k1, (256, 2), minval=-1.0, maxval=1.0)
    u_th = jax.random.uniform(k2, (256, 1), minval=-1.0, maxval=1.0)
    tp = mcl.init_uniform(t(u_xy), t(u_th), t(center), 0.5, 0.2)
    np.testing.assert_array_equal(tp.poses.numpy(), np.asarray(jp.poses))

    motion = jnp.asarray([0.3, 0.02, 0.05])
    jp = jmcl.predict(k_pred, jp, motion, MotionParams())
    tp = mcl.predict(t(jax.random.normal(k_pred, (256, 3))), tp, t(motion),
                     TMP)
    np.testing.assert_allclose(tp.poses.numpy(), np.asarray(jp.poses),
                               atol=1e-6)

    pts, mask = _points(*_scan((0.3, -4.4, 0.15)))
    jp = jmcl.weight(jp, jt, MAP, pts, mask)
    tp = mcl.weight(tp, tt, TMAP, t(pts), t(mask, torch.bool))
    np.testing.assert_allclose(tp.logw.numpy(), np.asarray(jp.logw),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(mcl.estimate(tp).numpy(),
                               np.asarray(jmcl.estimate(jp)), atol=1e-5)
    np.testing.assert_allclose(
        float(mcl.effective_sample_size(tp)),
        float(jmcl.effective_sample_size(jp)), rtol=1e-4)

    # Resampling from the same weights: equal picks except where a comb
    # tooth lies within rounding of a CDF step.
    jp = jp._replace(logw=jnp.asarray(tp.logw.numpy()))
    u0 = jax.random.uniform(k_res, (), minval=0.0, maxval=1.0 / 256)
    jr = np.asarray(jmcl.resample(k_res, jp).poses)
    tr = mcl.resample(t(u0), tp).poses.numpy()
    w = np.exp(tp.logw.numpy() - tp.logw.numpy().max())
    cdf = np.cumsum(w / w.sum())
    us = float(u0) + np.arange(256) / 256
    near = np.abs(us[:, None] - cdf[None, :]).min(1) < 1e-6
    differs = np.abs(tr - jr).max(1) > 0
    assert not (differs & ~near).any()
    assert len(np.unique(tr, axis=0)) < 200     # it did resample


def test_mcl_generator_draws_are_reproducible():
    """Without recorded draws MCL draws from its own generator: the same
    seed gives the same run."""
    _, tg = _world_grids()
    tt = d2d.make_dense_target(tg, TMAP)
    seq = _mcl_sequence()
    runs = []
    for _ in range(2):
        loc = mcl.MCL(TMAP, TMP, tt, n_particles=128, seed=3)
        loc.initialize(t(np.asarray(seq.gt[0])), 0.5, 0.2)
        pts, mask = _points(seq.ranges[1], seq.hit[1])
        runs.append(loc.step(t(seq.odom[1]), t(pts), t(mask, torch.bool)))
    assert torch.equal(runs[0], runs[1])
    # A recorded run without an offset for a step that resamples: that
    # offset comes from the generator.
    noise = torch.zeros(1, 128, 3)
    loc = mcl.MCL(TMAP, TMP, tt, n_particles=128, seed=3,
                  draws=mcl.recorded_draws(torch.zeros(128, 2),
                                           torch.zeros(128, 1), noise,
                                           [False], []))
    loc.initialize(t(np.asarray(seq.gt[0])), 0.5, 0.2)
    loc.particles.poses[:96] += 3.0       # most particles lost
    est = loc.step(t(seq.odom[1]), t(pts), t(mask, torch.bool))
    assert loc.resampled == [True] and torch.isfinite(est).all()
