"""Parity of the port's HMT tile store (ops/hmt.py), its fuser
(fusion/hmt_driver.py) and NGF codec (io/native.py) with the JAX
reference: the seven cases of tests/test_hmt.py and the two of
tests/test_hmt_driver.py through both packages on the same numpy
inputs, plus tile directories crossing packages in both directions.

Exactness: within one package spill and recall only add to zeros, so
the port's recalled window is its spilled window bit for bit, as the
reference's is.  Across packages the grids agree to the scatter's
rounding (tests/test_torch_ndt_map.py: counts exact, sums 1e-5),
the tile keys and stored-cell counts exactly; driver trajectories
within 1 cm / 5 mrad; an NGF file written from the same arrays is the
same bytes.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_feature_graph_tpu.config import (
    FeatureParams, FuserParams, NDTMapParams,
)
from ndt_feature_graph_tpu.fusion import fuser as jfuser
from ndt_feature_graph_tpu.fusion import scan_driver as jdriver
from ndt_feature_graph_tpu.fusion.hmt_driver import HMTFuser as JHMTFuser
from ndt_feature_graph_tpu.io import dataset as jds
from ndt_feature_graph_tpu.io import native as jnative
from ndt_feature_graph_tpu.ops import hmt as jhmt
from ndt_feature_graph_tpu.ops import ndt_map as jnm
from ndt_feature_graph_tpu_torch import interop
from ndt_feature_graph_tpu_torch.fusion import fuser, scan_driver
from ndt_feature_graph_tpu_torch.fusion.hmt_driver import HMTFuser
from ndt_feature_graph_tpu_torch.io import native
from ndt_feature_graph_tpu_torch.ops import hmt, ndt_map

torch.set_num_threads(2)
FIELDS = ("origin", "count", "psum", "outer", "occ")
XY_TOL, TH_TOL = 0.01, 0.005
SMALL = NDTMapParams(resolution=0.5, size_x=20.0, size_y=20.0,
                     sensor_range=10.0, max_points_per_scan=256,
                     max_cells=256, ray_samples=16)
TSMALL = interop.params_from_jax(SMALL)
PARAMS = FuserParams(
    ndt=NDTMapParams(resolution=0.5, size_x=20.0, size_y=20.0,
                     sensor_range=6.0, max_points_per_scan=256,
                     max_cells=256),
    features=FeatureParams(num_beams=180, max_range=6.0))
TPARAMS = interop.params_from_jax(PARAMS)
MARGIN = 2.0


def t(x, dt=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dt)


def _arrays(grid):
    return {k: np.array(getattr(grid, k) if not isinstance(
        getattr(grid, k), torch.Tensor) else getattr(grid, k).numpy())
        for k in FIELDS}


def _identical(a, b):
    for k in FIELDS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _close(a, b):
    """Port vs JAX: origin and counts exact, sums to rounding."""
    for k in FIELDS:
        tol = 0 if k in ("origin", "count") else 1e-4
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=tol,
                                   err_msg=k)


def _maps(seed=0, tile_cells=16):
    """The reference test's populated map in both packages."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-8.0, 8.0, (256, 2)).astype(np.float32)
    jm = jhmt.HMTMap(SMALL, (0.0, 0.0), tile_cells=tile_cells)
    jm.add_points(jnp.asarray(pts), jnp.ones(256, bool))
    jm.update_occupancy(jnp.zeros(2), jnp.asarray(pts), jnp.ones(256, bool))
    tm = hmt.HMTMap(TSMALL, torch.zeros(2), tile_cells=tile_cells)
    tm.add_points(t(pts), torch.ones(256, dtype=torch.bool))
    tm.update_occupancy(torch.zeros(2), t(pts),
                        torch.ones(256, dtype=torch.bool))
    return jm, tm


def _drive(ms, centers):
    for c in centers:
        c = (float(c), 0.0) if np.ndim(c) == 0 else tuple(map(float, c))
        for m in ms:
            m.recenter(c)


def _stores_match(jm, tm):
    assert sorted(jm.tiles) == sorted(tm.tiles)
    assert jm.stored_cell_count() == tm.stored_cell_count()
    for key in jm.tiles:
        for f in ("count", "psum", "outer", "occ"):
            np.testing.assert_allclose(tm.tiles[key][f], jm.tiles[key][f],
                                       rtol=1e-5, atol=1e-4)


# ---- the seven cases of tests/test_hmt.py ----

@pytest.mark.parametrize("margin", [0.0, 2.0], ids=["fixed", "follow"])
def test_add_scan_and_cell_list_match_jax(margin):
    """HMTMap.add_scan over five scans of a sensor moving 1.5 m a scan:
    the window stays put without a margin and follows the sensor (two
    recentres, spilling to the store) with one; then cell_list and the
    grid's shape."""
    rng = np.random.default_rng(3)
    jm = jhmt.HMTMap(SMALL, (0.0, 0.0), tile_cells=16)
    tm = hmt.HMTMap(TSMALL, torch.zeros(2), tile_cells=16)
    origins = []
    for k in range(5):
        origin = np.asarray([1.5 * k, 0.2 * k], np.float32)
        pts = (origin + rng.uniform(-8.0, 8.0, (256, 2))).astype(
            np.float32)
        mask = rng.random(256) < 0.9
        jm.add_scan(jnp.asarray(origin), jnp.asarray(pts), jnp.asarray(mask),
                    margin=margin)
        tm.add_scan(t(origin), t(pts), t(mask, torch.bool), margin=margin)
        origins.append(tuple(tm.grid.origin.tolist()))
    assert len(set(origins)) == (3 if margin else 1)
    _close(_arrays(tm.grid), _arrays(jm.grid))
    _stores_match(jm, tm)
    assert (tm.stored_cell_count() > 0) == (margin > 0)
    assert tm.grid.shape == jm.grid.shape == (SMALL.grid_h, SMALL.grid_w)
    jc, tc = jm.cell_list(), tm.cell_list()
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    assert tc.mask.sum() > 50
    ok = tc.mask.numpy()
    np.testing.assert_allclose(tc.means.numpy()[ok], np.asarray(jc.means)[ok],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tc.covs.numpy()[ok], np.asarray(jc.covs)[ok],
                               rtol=1e-4, atol=1e-5)


def test_zero_shift_noop():
    jm, tm = _maps()
    before = _arrays(tm.grid)
    _drive([jm, tm], [0])
    _identical(before, _arrays(tm.grid))
    assert not tm.tiles and not jm.tiles


def test_spill_then_exact_recall():
    jm, tm = _maps()
    before = _arrays(tm.grid)
    _close(before, _arrays(jm.grid))
    _drive([jm, tm], (10, 20, 30, 40))
    away = _arrays(tm.grid)
    assert away["count"].sum() == 0.0 and np.all(away["occ"] == 0.0)
    assert tm.stored_cell_count() > 0
    _stores_match(jm, tm)
    _drive([jm, tm], (30, 20, 10, 0))
    _identical(before, _arrays(tm.grid))
    assert tm.stored_cell_count() == 0 and not tm.tiles


def test_recall_is_not_reobservation():
    jm, tm = _maps(seed=3, tile_cells=8)
    before = _arrays(tm.grid)
    for c in ((7, 5), (15, 11), (24, 19)):
        _drive([jm, tm], [c])
        _close(_arrays(tm.grid), _arrays(jm.grid))
        _stores_match(jm, tm)
    _drive([jm, tm], ((15, 11), (7, 5), (0, 0)))
    _identical(before, _arrays(tm.grid))


def test_partial_overlap_keeps_live_and_stored_disjoint():
    jm, tm = _maps()
    before = _arrays(tm.grid)
    _drive([jm, tm], [10])
    live = _arrays(tm.grid)
    stored = sum(x["count"].sum() for x in tm.tiles.values())
    np.testing.assert_allclose(live["count"].sum() + stored,
                               before["count"].sum())
    assert live["count"].sum() > 0 and stored > 0
    w = TSMALL.grid_w
    np.testing.assert_array_equal(live["count"][:, :w - 20],
                                  before["count"][:, 20:])
    _stores_match(jm, tm)


def test_accumulation_after_recall():
    jm, tm = _maps()
    before = _arrays(tm.grid)
    _drive([jm, tm], (10, 20, 10, 0))
    pts = np.asarray([[1.2, 1.2]], np.float32)
    tm.add_points(t(pts), torch.ones(1, dtype=torch.bool))
    jm.add_points(jnp.asarray(pts), jnp.ones(1, bool))
    after = _arrays(tm.grid)
    iy, ix = ndt_map.cell_index(TSMALL, t(after["origin"]), t(pts))
    iy, ix = int(iy[0]), int(ix[0])
    assert after["count"][iy, ix] == before["count"][iy, ix] + 1
    _close(after, _arrays(jm.grid))


def test_save_load_roundtrip(tmp_path):
    jm, tm = _maps()
    before = _arrays(tm.grid)
    _drive([jm, tm], (10, 20, 30))
    d = str(tmp_path / "hmt_map_dir")
    tm.save(d)
    tm2 = hmt.HMTMap.load(d, TSMALL, device="cpu")
    assert tm2.stored_cell_count() == tm.stored_cell_count()
    _identical(_arrays(tm.grid), _arrays(tm2.grid))
    _drive([tm2], (20, 10, 0))
    _identical(before, _arrays(tm2.grid))


def test_global_gaussians_cover_live_and_stored():
    jm, tm = _maps()
    means_before, _ = tm.global_gaussians()
    _drive([jm, tm], [10])
    means_after, covs_after = tm.global_gaussians()
    a = means_before[np.lexsort(means_before.T)]
    b = means_after[np.lexsort(means_after.T)]
    np.testing.assert_allclose(a, b, atol=1e-5)
    jmeans, jcovs = jm.global_gaussians()
    assert jmeans.shape == means_after.shape
    np.testing.assert_allclose(b, jmeans[np.lexsort(jmeans.T)], atol=1e-5)


# ---- across packages ----

def test_tile_directory_crosses_packages(tmp_path):
    """A tile directory JAX wrote loads in the port, and one the port
    wrote loads in JAX; driving both back recalls exactly; NGF files of
    the same arrays are the same bytes."""
    jm, tm = _maps()
    before_j, before_t = _arrays(jm.grid), _arrays(tm.grid)
    _drive([jm, tm], (10, 20, 30))
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jm.save(jd)
    tm.save(td)
    with open(os.path.join(jd, "hmt.json")) as a, \
            open(os.path.join(td, "hmt.json")) as b:
        ja, tb = json.load(a), json.load(b)
    assert ja == tb
    from_jax = hmt.HMTMap.load(jd, TSMALL, device="cpu")
    from_port = jhmt.HMTMap.load(td, SMALL)
    _identical(_arrays(from_jax.grid), _arrays(jm.grid))
    _identical(_arrays(from_port.grid), _arrays(tm.grid))
    _drive([from_jax], (20, 10, 0))
    _drive([from_port], (20, 10, 0))
    _identical(_arrays(from_jax.grid), before_j)
    _identical(_arrays(from_port.grid), before_t)
    # The same arrays through both codecs: identical files.
    native.write_grid(tmp_path / "a.ngf", tm.grid, 0.5)
    jnative.write_grid(str(tmp_path / "b.ngf"),
                       jnm.NDTGrid(**{k: jnp.asarray(v) for k, v in
                                      _arrays(tm.grid).items()}), 0.5)
    assert (tmp_path / "a.ngf").read_bytes() == \
        (tmp_path / "b.ngf").read_bytes()


# ---- the two cases of tests/test_hmt_driver.py ----

def make_out_and_back(seed=0, x_end=21.0, step=0.5):
    """tests/test_hmt_driver.py's corridor drive out and back."""
    n = int(round(2 * x_end / step)) + 1
    xs = np.linspace(-x_end, x_end, n)
    out = np.stack([xs, np.zeros(n), np.zeros(n)], -1)
    traj = jnp.asarray(np.concatenate([out, out[-2::-1]]).astype(np.float32))
    keep = np.asarray(traj[:, :2])
    world = jds.random_world(seed, half_x=x_end + 3.0, half_y=4.0,
                             n_obstacles=16, keepout=keep, clearance=1.0)
    return jds.simulate_sequence(jax.random.PRNGKey(seed), traj,
                                 num_beams=180, max_range=6.0,
                                 segments=world,
                                 odom_noise=(0.004, 0.004, 0.002))


def _inputs(seq):
    pts, mask = jax.vmap(jds.scan_to_points)(seq.ranges, seq.hit)
    return (np.asarray(seq.odom), np.asarray(pts), np.asarray(mask),
            np.asarray(seq.gt))


@functools.lru_cache(maxsize=None)
def _jax_driver(chunk, eps=0.0):
    odom, pts, mask, gt = _inputs(make_out_and_back())
    half = gt.shape[0] // 2
    stop = int(np.argmin(np.abs(gt[half:, 0]))) + half
    jf = JHMTFuser(PARAMS, gt[0], jnp.zeros(3), jnp.asarray(pts[0]),
                   jnp.asarray(mask[0]), recenter_margin=MARGIN)
    jtraj = jf.run_sequence(jnp.asarray(odom[1:stop] + eps),
                            jnp.asarray(pts[1:stop]),
                            jnp.asarray(mask[1:stop]), chunk=chunk)
    return (odom, pts, mask, gt, stop), jf, np.asarray(jtraj)


def _driver_runs(chunk):
    (odom, pts, mask, gt, stop), jf, jtraj = _jax_driver(chunk)
    tf = HMTFuser(TPARAMS, t(gt[0]), torch.zeros(3), t(pts[0]),
                  t(mask[0], torch.bool), recenter_margin=MARGIN)
    ttraj = tf.run_sequence(t(odom[1:stop]), t(pts[1:stop]),
                            t(mask[1:stop], torch.bool), chunk=chunk)
    return (odom, pts, mask, gt, stop), (jf, jtraj), (tf, ttraj)


def _poses_close(a, b):
    dth = a[:, 2] - b[:, 2]
    assert np.abs(a[:, :2] - b[:, :2]).max() <= XY_TOL
    assert np.abs(np.arctan2(np.sin(dth), np.cos(dth))).max() <= TH_TOL


@pytest.mark.parametrize("chunk", [4, 3])
def test_hmt_driver_recalls_and_tracks(chunk):
    """The reference test's drive (chunk 4) and the same with chunk 3.
    At chunk 4 the vehicle moves exactly the 2 m margin between checks,
    so the recentre test falls within 1-2 mm of its edge: the
    reference's own count is 21, and 19 with the odometry moved by
    +-1e-6 (the same 187 stored cells).  There the port's count must be
    one of the reference's; at chunk 3 the checks are 0.45 m from the
    edge, and the counts must be equal."""
    (odom, pts, mask, gt, stop), (jf, jtraj), (tf, traj) = _driver_runs(
        chunk)
    _poses_close(traj, jtraj)
    counts = {jf.n_recenters}
    if chunk == 4:
        counts.add(_jax_driver(chunk, 1e-6)[1].n_recenters)
    assert tf.n_recenters in counts and tf.n_recenters >= 8
    assert tf.stored_cell_count() == jf.stored_cell_count() > 100
    near = lambda f: (f.window_cells_near((-8.0, -4.0), 2.0)  # noqa
                      + f.window_cells_near((-8.0, 4.0), 2.0))
    # Recalled ground is in the window.  (The count near a probe is not
    # compared with JAX's: poses millimetres apart put a few points in
    # other cells; the recall's exactness is test_spill_then_exact_recall.)
    assert near(tf) > (5 if chunk == 4 else 0)
    # Control: the rolling map drops that ground.
    drop = TPARAMS.replace(rolling_map=True, roll_margin=MARGIN)
    st = fuser.initialize(drop, t(gt[0]), torch.zeros(3), t(pts[0]),
                          t(mask[0], torch.bool))
    st, _, _ = scan_driver.run_sequence(drop, st, t(odom[1:stop]),
                                        t(pts[1:stop]),
                                        t(mask[1:stop], torch.bool))
    mean, _, valid = ndt_map.finalize(st.grid, drop.ndt)
    mm = mean[valid].numpy()
    for probe in ((-8.0, -4.0), (-8.0, 4.0)):
        assert (np.linalg.norm(mm - np.asarray(probe), axis=-1) <= 2.0
                ).sum() == 0
    err = np.linalg.norm(traj[:, :2] - gt[1:stop, :2], axis=-1)
    assert err[-1] < 0.3 and np.max(err) < 0.6


def test_hmt_driver_save_load_roundtrip(tmp_path):
    """The port resumes from a directory it wrote and from one JAX
    wrote; the resumed run matches JAX's resumed run.  Tlast_fuse is not
    saved and restarts at Tnow in both (the reference's trait)."""
    seq = make_out_and_back(seed=3, x_end=12.0)
    odom, pts, mask, gt = _inputs(seq)
    h = gt.shape[0] // 2
    jf = JHMTFuser(PARAMS, gt[0], jnp.zeros(3), jnp.asarray(pts[0]),
                   jnp.asarray(mask[0]), recenter_margin=MARGIN)
    jf.run_sequence(jnp.asarray(odom[1:h]), jnp.asarray(pts[1:h]),
                    jnp.asarray(mask[1:h]), chunk=4)
    tf = HMTFuser(TPARAMS, t(gt[0]), torch.zeros(3), t(pts[0]),
                  t(mask[0], torch.bool), recenter_margin=MARGIN)
    tf.run_sequence(t(odom[1:h]), t(pts[1:h]), t(mask[1:h], torch.bool),
                    chunk=4)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jf.save(jd)
    tf.save(td)
    own = HMTFuser.load(td, TPARAMS, device="cpu")
    assert own.stored_cell_count() == tf.stored_cell_count()
    assert torch.equal(own.state.Tnow, tf.state.Tnow)
    assert torch.equal(own.state.grid.count, tf.state.grid.count)
    assert torch.equal(own.state.Tlast_fuse, own.state.Tnow)
    from_jax = HMTFuser.load(jd, TPARAMS, device="cpu")
    jf2 = JHMTFuser.load(jd, PARAMS)
    assert from_jax.stored_cell_count() == jf2.stored_cell_count()
    sl = slice(h, h + 8)
    jt = jf2.run_sequence(jnp.asarray(odom[sl]), jnp.asarray(pts[sl]),
                          jnp.asarray(mask[sl]), chunk=4)
    tt = from_jax.run_sequence(t(odom[sl]), t(pts[sl]),
                               t(mask[sl], torch.bool), chunk=4)
    own.run_sequence(t(odom[sl]), t(pts[sl]), t(mask[sl], torch.bool),
                     chunk=4)
    assert np.isfinite(own.state.Tnow.numpy()).all()
    _poses_close(tt, np.asarray(jt))


def test_hmt_fuser_update_per_scan_matches_jax():
    """HMTFuser.update (a recentre check before every scan, then
    fuser.update) over the first 24 scans of the drive, against JAX's."""
    (odom, pts, mask, gt, _), _, _ = _jax_driver(3)
    jf = JHMTFuser(PARAMS, gt[0], jnp.zeros(3), jnp.asarray(pts[0]),
                   jnp.asarray(mask[0]), recenter_margin=MARGIN)
    tf = HMTFuser(TPARAMS, t(gt[0]), torch.zeros(3), t(pts[0]),
                  t(mask[0], torch.bool), recenter_margin=MARGIN)
    jt, tt = [], []
    for k in range(1, 25):
        jf.update(jnp.asarray(odom[k]), jnp.asarray(pts[k]),
                  jnp.asarray(mask[k]))
        tf.update(t(odom[k]), t(pts[k]), t(mask[k], torch.bool))
        jt.append(np.asarray(jf.state.Tnow))
        tt.append(tf.state.Tnow.numpy())
    _poses_close(np.stack(tt), np.stack(jt))
    assert tf.n_recenters == jf.n_recenters > 0
