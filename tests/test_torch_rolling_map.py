"""Parity of the port's rolling map with the JAX reference on the CPU:
`ndt_map.recenter` / `recenter_with_aux` (a zero shift, partial shifts,
a shift off the map; exact, and over a stack of grids exactly what the
single-grid function gives stream by stream) and the recentre branch of
the fuser, on the cases of tests/test_fuser.py (a window much smaller
than the traverse keeps tracking; the incremental packed table survives
the recentres).

Tolerances.  recenter moves values and computes one origin: exact.  The
fuser runs are held to 2 mm / 1 mrad of the reference's trajectory, the
fleet drivers' tolerance (measured 1.12 mm / 0.09 mrad over the 49 scans
of the traverse; the 12-scan case is bistable in the reference itself,
see its test), the packed table to 1e-4 of packed_from_grid as in the
reference's own test.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_feature_graph_tpu.config import FuserParams, NDTMapParams
from ndt_feature_graph_tpu.fusion import fuser as jfu
from ndt_feature_graph_tpu.fusion import scan_driver as jsd
from ndt_feature_graph_tpu.io import dataset as jds
from ndt_feature_graph_tpu.ops import d2d as jd2d
from ndt_feature_graph_tpu.ops import ndt_map as jnm
from ndt_feature_graph_tpu_torch import interop
from ndt_feature_graph_tpu_torch.fusion import fuser as tfu
from ndt_feature_graph_tpu_torch.fusion import scan_driver as tsd
from ndt_feature_graph_tpu_torch.graph.node import map_tensors
from ndt_feature_graph_tpu_torch.ops import d2d as td2d
from ndt_feature_graph_tpu_torch.ops import ndt_map as tnm

torch.set_num_threads(2)

MAP = NDTMapParams(resolution=0.5, size_x=16.0, size_y=16.0,
                   sensor_range=8.0, max_points_per_scan=512, max_cells=512)
TMAP = interop.params_from_jax(MAP)
FIELDS = ("origin", "count", "psum", "outer", "occ")
# New centres relative to the grid's own: none, under half a cell (rounds
# to none), whole cells along x, along both axes, and off the map.
SHIFTS = {"zero": (0.0, 0.0), "under_half_a_cell": (0.2, -0.24),
          "partial_x": (2.6, 0.0), "partial_xy": (-3.1, 4.4),
          "off_the_map": (40.0, -3.0)}


def _np(x):
    return jax.tree.map(np.asarray, x)


def _t(x):
    return torch.tensor(np.asarray(x))


@functools.lru_cache(maxsize=None)
def _grid():
    """A populated JAX grid with occupancy and its packed table."""
    seq = jds.simulate_sequence(
        jax.random.PRNGKey(4), jds.loop_trajectory(3, radius=2.0),
        num_beams=360, max_range=8.0)
    pts, mask = jds.scan_to_points(seq.ranges[1], seq.hit[1])
    c = jnp.asarray([0.3, -0.2])
    g = jnm.add_points(jnm.empty_grid(MAP, c), MAP, pts, mask)
    g = jnm.update_occupancy(g, MAP, c, pts, mask)
    return g, jd2d.packed_from_grid(g, MAP)


def _center(g):
    return np.asarray(g.origin) + np.asarray([MAP.size_x / 2, MAP.size_y / 2],
                                             np.float32)


@pytest.mark.parametrize("shift", list(SHIFTS))
def test_recenter_with_aux_matches_jax(shift):
    jg, jpacked = _grid()
    target = (_center(jg) + np.asarray(SHIFTS[shift], np.float32))
    ref_g, ref_aux = jnm.recenter_with_aux(
        jg, MAP, jnp.asarray(target), jpacked, jd2d.empty_pack_row())
    tg = interop.grid_from_jax(_np(jg), "cpu")
    got_g, got_aux = tnm.recenter_with_aux(
        tg, TMAP, torch.tensor(target), _t(jpacked),
        td2d.empty_pack_row("cpu"))
    for name in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ref_g, name)),
                                      getattr(got_g, name).numpy(), name)
    np.testing.assert_array_equal(np.asarray(ref_aux), got_aux.numpy())
    moved = shift not in ("zero", "under_half_a_cell")
    assert torch.equal(got_g.origin, tg.origin) != moved
    if not moved:       # an exact no-op
        assert all(torch.equal(getattr(got_g, n), getattr(tg, n))
                   for n in FIELDS)
        assert torch.equal(got_aux, _t(jpacked))
    if shift == "off_the_map":
        assert float(got_g.count.sum()) == 0.0
        assert torch.equal(got_aux, td2d.empty_pack_row("cpu").expand(
            MAP.grid_h * MAP.grid_w, 8))
    else:
        assert float(got_g.count.sum()) > 0.0
    # The moved table is the moved grid's own table (the reference's
    # rows against the port's finalize: 1e-4, covariance rows cancel).
    np.testing.assert_allclose(
        got_aux.numpy(), td2d.packed_from_grid(got_g, TMAP).numpy(),
        rtol=0, atol=1e-4)
    plain = tnm.recenter(tg, TMAP, torch.tensor(target))
    assert all(torch.equal(getattr(plain, n), getattr(got_g, n))
               for n in FIELDS)
    np.testing.assert_array_equal(
        np.asarray(jnm.recenter(jg, MAP, jnp.asarray(target)).occ),
        plain.occ.numpy())


def test_recenter_over_a_stack_equals_the_single_grid_function():
    """Every stream of a stack shifts by its own device integer."""
    jg, jpacked = _grid()
    tg = interop.grid_from_jax(_np(jg), "cpu")
    names = list(SHIFTS)
    targets = torch.tensor(np.stack([
        _center(jg) + np.asarray(SHIFTS[n], np.float32) for n in names]))
    stack = map_tensors(lambda x: x.expand(len(names), *x.shape).contiguous(),
                        tg)
    aux = _t(jpacked).expand(len(names), -1, -1).contiguous()
    fill = td2d.empty_pack_row("cpu")
    got_g, got_aux = tnm.recenter_with_aux(stack, TMAP, targets, aux, fill)
    for i in range(len(names)):
        one_g, one_aux = tnm.recenter_with_aux(tg, TMAP, targets[i],
                                               _t(jpacked), fill)
        for name in FIELDS:
            assert torch.equal(getattr(one_g, name),
                               getattr(got_g, name)[i]), (names[i], name)
        assert torch.equal(one_aux, got_aux[i]), names[i]


def _roll_case(rolling: bool):
    """tests/test_fuser.py's rolling-map traverse: a 16 m window, a 24 m
    corridor run in the warehouse world."""
    p = FuserParams(ndt=MAP, rolling_map=rolling, roll_margin=3.0)
    traj = jds.corridor_trajectory(50, x0=-12.0, x1=12.0, y=-4.5)
    seq = jds.simulate_sequence(jax.random.PRNGKey(2), traj, num_beams=360,
                                max_range=8.0,
                                segments=jds.warehouse_world())
    pts, mask = jax.vmap(jds.scan_to_points)(seq.ranges, seq.hit)
    state = jfu.initialize(p, seq.gt[0], jnp.zeros(3), pts[0], mask[0])
    return p, seq, pts, mask, state


def _ate(est, gt):
    return float(np.sqrt(np.mean(np.sum((est[:, :2] - gt[:, :2]) ** 2, -1))))


def _port_run(p, seq, pts, mask, state):
    return tsd.run_sequence(
        interop.params_from_jax(p),
        interop.fuser_state_from_jax(_np(state), "cpu"), _t(seq.odom[1:]),
        _t(pts[1:]), _t(mask[1:]))


def test_rolling_map_tracks_beyond_window_like_jax():
    """The window follows the vehicle on the device: the port tracks as
    the reference does, the window really moved, the map stayed
    populated; the same window fixed in the world loses the vehicle."""
    p, seq, pts, mask, state = _roll_case(True)
    _, jtraj, _ = _np(jsd.run_sequence(p, state, seq.odom[1:], pts[1:],
                                       mask[1:]))
    final, traj, _ = _port_run(p, seq, pts, mask, state)
    traj = traj.numpy()
    dth = traj[:, 2] - jtraj[:, 2]
    assert np.abs(traj[:, :2] - jtraj[:, :2]).max() <= 2e-3
    assert np.abs(np.arctan2(np.sin(dth), np.cos(dth))).max() <= 1e-3
    gt = np.asarray(seq.gt)[1:]
    err = _ate(traj, gt)
    assert err < 0.25, err
    assert float(final.grid.origin[0]) > 0.0
    assert float(final.grid.count.sum()) > 100.0
    np.testing.assert_allclose(
        final.packed.numpy(),
        td2d.packed_from_grid(final.grid,
                              interop.params_from_jax(p).ndt).numpy(),
        rtol=0, atol=1e-4)

    fixed = _roll_case(False)
    _, traj2, _ = _port_run(*fixed)
    assert _ate(traj2.numpy(), gt) > err


def test_incremental_packed_survives_recentres_like_jax():
    """tests/test_fuser.py's second case (a 16 m window under a 15 m
    sensor, margin 2 m, 12 scans): after every update the packed table
    equals packed_from_grid and at least one update recentres.  With
    most of each scan off the window the registration has two nearby
    minima: the reference's own run lands up to 3.7 mm / 1.5 mrad away
    when its odometry moves by 1e-6, and the port up to 4.0 mm / 1.5 mrad
    from the first run, at most 0.64 mm / 0.32 mrad from the nearer of
    the two (measured).  So each pose is held to 2 mm / 1 mrad of the
    nearer of the reference's two runs."""
    p = FuserParams(
        ndt=MAP.replace(sensor_range=15.0), rolling_map=True,
        roll_margin=2.0)
    tp = interop.params_from_jax(p)
    traj = jds.corridor_trajectory(12, x0=-6.0, x1=4.0, y=-4.5)
    seq = jds.simulate_sequence(jax.random.PRNGKey(3), traj, num_beams=360,
                                max_range=15.0)
    pts0, m0 = jds.scan_to_points(seq.ranges[0], seq.hit[0])
    js = jfu.initialize(p, seq.gt[0], jnp.zeros(3), pts0, m0)
    js_eps = js
    ts = interop.fuser_state_from_jax(_np(js), "cpu")
    rolled = 0
    for t in range(1, seq.gt.shape[0]):
        pts, m = jds.scan_to_points(seq.ranges[t], seq.hit[t])
        before = ts.grid.origin
        js, _ = jfu.update(js, p, seq.odom[t], pts, m)
        js_eps, _ = jfu.update(js_eps, p, seq.odom[t] + 1e-6, pts, m)
        ts, _ = tfu.update(ts, tp, _t(seq.odom[t]), _t(pts), _t(m))
        rolled += int(not torch.equal(ts.grid.origin, before))
        np.testing.assert_array_equal(ts.grid.origin.numpy(),
                                      np.asarray(js.grid.origin))
        dev = np.stack([np.abs(ts.Tnow.numpy() - np.asarray(j.Tnow))
                        for j in (js, js_eps)])
        over = np.maximum(dev[:, :2].max(1) / 2e-3, dev[:, 2] / 1e-3)
        assert over.min() <= 1.0, (t, dev)
        np.testing.assert_allclose(
            ts.packed.numpy(),
            td2d.packed_from_grid(ts.grid, tp.ndt).numpy(), rtol=0,
            atol=1e-4)
    assert rolled >= 1
    np.testing.assert_array_equal(ts.grid.count.numpy() > 0,
                                  np.asarray(js.grid.count) > 0)
