"""Parity of the port's fleet path with the JAX reference on the CPU, at
tests/test_scan_driver.py's small size (80x80 grid, 360 beams, 8 scans,
B = 3 streams with the odometry jittered per stream): the map operations
over a stack of grids, the plain whole-trial objective of a fleet step
(`newton_objective_batch_reference`, with the bfloat16 row mode), one
`fuser.update_batch` and one `feature_fuser.update_batch` step, the
sequence drivers, the occupancy cadence, the serving schedules of
`parallel/scaling.py`, the presets, and `fuser.update` with
`gather_table_bf16`.  The JAX side's state goes through
`jax.tree.map(np.asarray, ...)` and `interop`; every JAX run is shared
through the module-scoped fixture.

Tolerances.  Drivers: trajectories 2 mm in x, y and 1 mrad in theta,
scores rtol 3e-2 / atol 1e-2 — what the reference holds its own batch
path to against its single-stream driver (tests/test_scan_driver.py:
cross-executable float32 noise perturbs the LM trial acceptance and
compounds over the map updates; measured here 0.43 mm / 0.38 mrad and
2.8% on the scores).  The objective: f rtol 1e-5 with f32 rows
(measured 4.4e-7), g and H rtol 2e-3 with atol 1e-4 / 1e-3, the
tolerances tests/test_torch_objective.py states for sums over thousands
of pairs taken in another order (measured here 4.4e-7 and 6.2e-7 of
their largest entry); with bfloat16 rows the same and f rtol 1e-4: both
sides round the same rows at the same places (measured 2.2e-7).  Map
operations over a stack against the single-grid port functions: exact.
"""

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
from ndt_feature_graph_tpu.fusion import scan_driver as jsd
from ndt_feature_graph_tpu.io import dataset as jds
from ndt_feature_graph_tpu.models import presets as jpresets
from ndt_feature_graph_tpu.ops import d2d as jd2d
from ndt_feature_graph_tpu.ops import d2d_analytic as jda
from ndt_feature_graph_tpu.ops import ndt_map as jnm
from ndt_feature_graph_tpu.parallel import scaling as jscaling
from ndt_feature_graph_tpu_torch import interop
from ndt_feature_graph_tpu_torch.fusion import feature_fuser as tff
from ndt_feature_graph_tpu_torch.fusion import fuser as tfu
from ndt_feature_graph_tpu_torch.fusion import scan_driver as tsd
from ndt_feature_graph_tpu_torch.graph.node import map_tensors
from ndt_feature_graph_tpu_torch.io import dataset as tds
from ndt_feature_graph_tpu_torch.models import presets as tpresets
from ndt_feature_graph_tpu_torch.ops import cuda_kernels
from ndt_feature_graph_tpu_torch.ops import d2d as td2d
from ndt_feature_graph_tpu_torch.ops import ndt_map as tnm
from ndt_feature_graph_tpu_torch.parallel import scaling as tscaling

torch.set_num_threads(2)

P = FuserParams(
    ndt=NDTMapParams(resolution=0.5, size_x=40.0, size_y=40.0,
                     sensor_range=15.0, max_points_per_scan=512,
                     max_cells=512),
    features=FeatureParams(num_beams=360, max_range=15.0),
)
# 72 cells cover 2 * (15 m / 0.5 m + 2) + 1 = 65: the window tables are
# exact there (tests/test_scan_driver.py).
P_BF16 = P.replace(gather_window_cells=72, gather_block=True,
                   gather_table_bf16=True)
B, T_STEPS = 3, 8
H_, W_, RES = P.ndt.grid_h, P.ndt.grid_w, P.ndt.resolution
XY_TOL, TH_TOL = 2e-3, 1e-3
SCORE_TOL = dict(rtol=3e-2, atol=1e-2)


def _np(x):
    return jax.tree.map(np.asarray, x)


def _t(x):
    return torch.tensor(np.asarray(x))


def _tp(p):
    return interop.params_from_jax(p)


def _stack(x, b=B):
    return jax.tree.map(lambda a: jnp.stack([a] * b), x)


def _draws(keys, t_steps):
    """The RANSAC draws of streams whose FeatureFuserState keys are
    `keys` (B, 2) over `t_steps` scans: (B, T, M, 2)."""
    m_hyp = P.features.ransac_hypotheses
    out = []
    for key in keys:
        row = []
        for _ in range(t_steps):
            key, sub = jax.random.split(key)
            row.append(jax.random.uniform(jax.random.split(sub)[0],
                                          (m_hyp, 2)))
        out.append(jnp.stack(row))
    return np.asarray(jnp.stack(out))


def _make_fleet():
    """The reference's fleet inputs: stacked states, jittered odometry,
    scans, the streams' RANSAC draws."""
    traj = jds.corridor_trajectory(T_STEPS + 1, x0=-6.0, x1=-3.0, y=-4.5)
    seq = jds.simulate_sequence(jax.random.PRNGKey(0), traj, num_beams=360,
                                max_range=15.0)
    pts_all, mask_all = jax.vmap(jds.scan_to_points)(seq.ranges, seq.hit)
    state0 = jfu.initialize(P, seq.gt[0], jnp.zeros(3), pts_all[0],
                            mask_all[0])
    jitter = 1e-3 * jnp.arange(B)[:, None, None]
    odom = jnp.stack([seq.odom[1:]] * B) + jitter
    fstate0 = jff.initialize(P, seq.gt[0], jnp.zeros(3), seq.ranges[0],
                             seq.hit[0], jax.random.PRNGKey(1))
    fstates = _stack(fstate0)._replace(
        key=jax.random.split(jax.random.PRNGKey(5), B))
    f = dict(seq=seq, state0=state0, states=_stack(state0), odom=odom,
             pts=jnp.stack([pts_all[1:]] * B),
             mask=jnp.stack([mask_all[1:]] * B), fstate0=fstate0,
             fstates=fstates, ranges=jnp.stack([seq.ranges[1:]] * B),
             hit=jnp.stack([seq.hit[1:]] * B),
             u=_draws(fstates.key, T_STEPS), runs={})
    return f


@pytest.fixture(scope="module")
def fleet():
    """The reference's fleet inputs and its runs, made once."""
    return _make_fleet()


def _jax_run(fleet, p):
    """The reference's run_sequence_batch under `p`, made once."""
    if p not in fleet["runs"]:
        fleet["runs"][p] = _np(jsd.run_sequence_batch(
            p, fleet["states"], fleet["odom"], fleet["pts"], fleet["mask"]))
    return fleet["runs"][p]


def _port_inputs(fleet):
    return (interop.fuser_state_from_jax(_np(fleet["states"]), "cpu"),
            _t(fleet["odom"]), _t(fleet["pts"]), _t(fleet["mask"]))


def _port_run(fleet, p):
    return tsd.run_sequence_batch(_tp(p), *_port_inputs(fleet))


def _poses_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    dth = got[..., 2] - ref[..., 2]
    assert np.abs(got[..., :2] - ref[..., :2]).max() <= XY_TOL
    assert np.abs(np.arctan2(np.sin(dth), np.cos(dth))).max() <= TH_TOL


PRESETS = ["p2d_registration", "ndt_odometry", "feature_graph_slam",
           "offline_mapper", "fleet_serving", "mcl_localizer",
           "canonical_slam"]


@pytest.mark.parametrize("name", PRESETS)
def test_presets_match_jax(name):
    """Every preset is the reference's, in the port's own dataclasses."""
    ref, got = getattr(jpresets, name)(), getattr(tpresets, name)()
    assert repr(got) == repr(ref)
    if isinstance(ref, tuple):
        assert got == tuple(_tp(x) for x in ref)
    else:
        assert got == _tp(ref)
    if name == "fleet_serving":
        assert repr(tpresets.fleet_serving(360, features=False)) == repr(
            jpresets.fleet_serving(360, features=False))
        assert tfu._bf16_rows(got, batch=True)


@pytest.mark.parametrize("features", [False, True])
def test_build_fleet_inputs_match_jax(features):
    """The port's fleet inputs from the reference's simulated sequence
    equal the reference's own (same replication, same 1e-4 * stream
    index odometry jitter)."""
    t = 5
    seq = jds.simulate_sequence(
        jax.random.PRNGKey(0), jds.loop_trajectory(t, radius=5.0),
        num_beams=360, max_range=P.ndt.sensor_range)
    tseq = tds.Sequence(*(_t(x) for x in (seq.ranges, seq.hit, seq.odom,
                                          seq.gt)))
    if features:
        ref = jscaling.build_fleet_feature_inputs(P, B, t_steps=t)
        got = tscaling.build_fleet_feature_inputs(_tp(P), tseq, B)
        rbase, gbase = ref[0].base, got[0].base
        np.testing.assert_array_equal(np.asarray(ref[0].prev_feats.mask),
                                      got[0].prev_feats.mask.numpy())
    else:
        ref = jscaling.build_fleet_inputs(P, B, t_steps=t)
        got = tscaling.build_fleet_inputs(_tp(P), tseq, B)
        rbase, gbase = ref[0], got[0]
    np.testing.assert_array_equal(np.asarray(ref[1]), got[1].numpy())
    assert got[1].shape == (B, t - 1, 3)
    assert float((got[1][2] - got[1][0]).abs().max()) > 1e-4
    for r, g in zip(ref[2:], got[2:]):
        np.testing.assert_allclose(np.asarray(r), g.numpy(), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(rbase.grid.count),
                                  gbase.grid.count.numpy())
    # The port's scan points differ by float32 trigonometry ulps and the
    # covariance rows cancel: tables to 1e-4, as tests/test_torch_fuser.py.
    np.testing.assert_allclose(np.asarray(rbase.packed),
                               gbase.packed.numpy(), rtol=1e-5, atol=1e-4)
    assert gbase.packed.shape == (B, H_ * W_, 8)
    assert all(x.is_contiguous() for x in (gbase.packed, gbase.grid.occ))


def _stacked_scans(fleet):
    """Three different scans as one stack: world points (B, P, 2) with
    some off the grid and a NaN, masks, grid centres, sensor origins."""
    pts = np.array(fleet["pts"][0, :B])
    mask = np.array(fleet["mask"][0, :B])
    pts[1, :5] += 25.0
    pts[2, 7] = np.nan
    mask[0, 5:12] = False
    centers = np.asarray([[0.3, -0.2], [-1.0, 0.7], [0.0, 0.0]], np.float32)
    return pts, mask, centers, centers + 0.1


def _grid_at(g, i):
    return map_tensors(lambda x: x[i], g)


def test_batched_map_ops_equal_the_single_grid_ops(fleet):
    """add_points_touched, update_occupancy, the cell lists and the
    packed refresh over a stack of grids give, stream by stream, exactly
    what the single-grid functions give."""
    pts, mask, centers, origins = _stacked_scans(fleet)
    tp = _tp(P).ndt
    tpts, tmask = torch.tensor(pts), torch.tensor(mask)
    g0 = tnm.empty_grid(tp, torch.tensor(centers))
    g, touched = tnm.add_points_touched(g0, tp, tpts, tmask)
    g = tnm.update_occupancy(g, tp, torch.tensor(origins), tpts, tmask)
    packed = td2d.refresh_packed(td2d.packed_from_grid(g0, tp), g, tp,
                                 touched)
    cells_t = tnm.to_cell_list_touched(g, tp, touched)
    cells = tnm.to_cell_list(g, tp)
    for i in range(B):
        s0 = tnm.empty_grid(tp, torch.tensor(centers[i]))
        s, st = tnm.add_points_touched(s0, tp, tpts[i], tmask[i])
        s = tnm.update_occupancy(s, tp, torch.tensor(origins[i]), tpts[i],
                                 tmask[i])
        assert torch.equal(st, touched[i])
        for name in ("origin", "count", "psum", "outer", "occ"):
            assert torch.equal(getattr(s, name), getattr(g, name)[i]), name
        assert torch.equal(
            td2d.refresh_packed(td2d.packed_from_grid(s0, tp), s, tp, st),
            packed[i])
        for one, many in ((tnm.to_cell_list_touched(s, tp, st), cells_t),
                          (tnm.to_cell_list(s, tp), cells)):
            for name in ("means", "covs", "mask"):
                assert torch.equal(getattr(one, name),
                                   getattr(many, name)[i]), name
    assert torch.equal(packed, td2d.packed_from_grid(g, tp))
    assert int(cells.mask.sum(1).min()) > 20


def test_batched_map_ops_match_jax(fleet):
    """The same stack against the reference's vmapped functions; cell
    lists on the masked prefix only (the padded rows differ by design)."""
    pts, mask, centers, origins = _stacked_scans(fleet)
    tp = _tp(P).ndt

    def one(c, o, p, m):
        g, touched = jnm.add_points_touched(jnm.empty_grid(P.ndt, c), P.ndt,
                                            p, m)
        g = jnm.update_occupancy(g, P.ndt, o, p, m)
        return g, touched, jnm.to_cell_list_touched(g, P.ndt, touched)

    jg, jt, jc = jax.vmap(one)(jnp.asarray(centers), jnp.asarray(origins),
                               jnp.asarray(pts), jnp.asarray(mask))
    tpts, tmask = torch.tensor(pts), torch.tensor(mask)
    g, touched = tnm.add_points_touched(
        tnm.empty_grid(tp, torch.tensor(centers)), tp, tpts, tmask)
    g = tnm.update_occupancy(g, tp, torch.tensor(origins), tpts, tmask)
    cells = tnm.to_cell_list_touched(g, tp, touched)
    np.testing.assert_array_equal(np.asarray(jt), touched.numpy())
    np.testing.assert_array_equal(np.asarray(jg.count), g.count.numpy())
    np.testing.assert_allclose(np.asarray(jg.psum), g.psum.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(jg.occ), g.occ.numpy(), atol=1e-5)
    m = np.asarray(jc.mask)
    np.testing.assert_array_equal(m, cells.mask.numpy())
    np.testing.assert_allclose(np.asarray(jc.means)[m],
                               cells.means.numpy()[m], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(jc.covs)[m],
                               cells.covs.numpy()[m], rtol=1e-5, atol=1e-6)


def _trial(fleet, p):
    """The reference's inputs of the first fleet step's Newton trial
    under `p`, and its (f, g, H) function of the increments with the
    window, paired and odometry terms switched as asked."""
    fst, m = fleet["fstates"], p.matcher
    Tm = fleet["odom"][:, 0]
    pts, mask, _, _, _, fsrc, ftgt, _ = jax.vmap(
        lambda st, tm, r, h: jff._prepare_features(st, p, tm, r, h))(
            fst, Tm, fleet["ranges"][:, 0], fleet["hit"][:, 0])
    T0 = jax.vmap(jse2.compose)(fst.base.Tnow, Tm)
    src = jax.vmap(lambda sp, q, mk: jfu._build_local_cells(p, sp, q,
                                                            mk)[0])(
        fst.base.sensor_pose, pts, mask)
    Q = jax.vmap(lambda tm, tp: jfu._increment_information(p, tm, tp))(Tm,
                                                                      T0)
    origins = fst.base.grid.origin
    wc = p.gather_window_cells
    windowed = 0 < wc < min(H_, W_)
    if windowed:
        block, cell0 = jd2d.build_window_block_tables(
            fst.base.packed, origins, T0[:, :2], H_, W_, m.n_neighbours, wc,
            RES, bf16=p.gather_table_bf16)
        block = block.reshape(-1, block.shape[-1])

    def fgh(d, window, features, odometry):
        f = jnp.zeros(B)
        g, H = jnp.zeros((B, 3)), jnp.zeros((B, 3, 3))
        if window and windowed:
            a = jda.fgh_dense_block_batch(
                d, T0, src, block, cell0, origins, wc, RES, m,
                rel_means=p.gather_table_bf16)
        elif window:
            a = jda.fgh_dense_flat_batch(
                d, T0, src, fst.base.packed.reshape(-1, 8), origins,
                jnp.arange(B) * (H_ * W_), H_, W_, RES, m)
        if window:
            f, g, H = f + a[0], g + a[1], H + a[2]
        if features:
            a = jax.vmap(lambda d_, t_, s_, g_: jda.fgh_paired(
                d_, t_, s_, g_, m))(d, T0, fsrc, ftgt)
            f, g, H = f + a[0], g + a[1], H + a[2]
        if odometry:
            Qs = Q + Q.transpose(0, 2, 1)
            f = f + jnp.einsum("bi,bij,bj->b", d, Q, d)
            g = g + jnp.einsum("bij,bj->bi", Qs, d)
            H = H + Qs
        return f, g, H

    cells = lambda c: interop.cell_list_from_jax(_np(c), "cpu")  # noqa: E731
    assert int(np.asarray(fsrc.mask & ftgt.mask).sum(1).min()) >= 3
    port = dict(T0=_t(T0), src=cells(src), Q=_t(Q), fs=cells(fsrc),
                ft=cells(ftgt),
                packed=_t(fst.base.packed).reshape(-1, 8),
                origins=_t(origins),
                offs=torch.arange(B) * (H_ * W_))
    return fgh, port


D_B = np.asarray([[0.03, -0.05, 0.012], [-0.02, 0.01, -0.004],
                  [0.0, 0.04, 0.02]], np.float32)
SWITCHES = {"all": (True, True, True), "no_window": (False, True, True),
            "no_features": (True, False, True),
            "no_odometry": (True, True, False)}


@pytest.mark.parametrize("terms", list(SWITCHES))
@pytest.mark.parametrize("rows", ["f32", "bf16"])
def test_newton_objective_batch_reference_matches_jax(fleet, rows, terms):
    """The plain whole-trial objective of a fleet step against the
    reference's fgh_dense_block_batch (its win-block table, bfloat16 with
    cell-relative means for `bf16`) + vmapped fgh_paired + the odometry
    einsums, each term off in turn."""
    p = P_BF16 if rows == "bf16" else P
    fgh, a = _trial(fleet, p)
    window, features, odometry = SWITCHES[terms]
    ref = fgh(jnp.asarray(D_B), window, features, odometry)
    m = _tp(p).matcher
    got = cuda_kernels.newton_objective_batch_reference(
        torch.tensor(D_B), a["T0"], a["src"] if window else None,
        a["packed"], a["origins"], a["offs"], H_, W_, RES, m,
        a["fs"] if features else None, a["ft"] if features else None,
        a["Q"] if odometry else None, rows == "bf16")
    f, g, H = (np.asarray(x, np.float64) for x in ref)
    np.testing.assert_allclose(got[0].numpy(), f,
                               rtol=1e-4 if rows == "bf16" else 1e-5)
    np.testing.assert_allclose(got[1].numpy(), g, rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), H, rtol=2e-3, atol=1e-3)
    assert got[0].shape == (B,) and got[2].shape == (B, 3, 3)


def test_bf16_rows_change_the_objective_like_the_reference(fleet):
    """The bfloat16 row mode moves f by what it moves the reference's:
    the rounding is reproduced, not just tolerated."""
    fgh32, a = _trial(fleet, P)
    fgh16, _ = _trial(fleet, P_BF16)
    d = jnp.asarray(D_B)
    ref = np.asarray(fgh16(d, True, False, False)[0], np.float64) - \
        np.asarray(fgh32(d, True, False, False)[0], np.float64)
    m = _tp(P).matcher
    args = (torch.tensor(D_B), a["T0"], a["src"], a["packed"], a["origins"],
            a["offs"], H_, W_, RES, m, None, None, None)
    got = (cuda_kernels.newton_objective_batch_reference(*args, True)[0]
           - cuda_kernels.newton_objective_batch_reference(*args, False)[0])
    assert np.abs(ref).min() > 1e-4
    np.testing.assert_allclose(got.numpy(), ref, rtol=0.05, atol=2e-4)


def test_newton_objective_batch_on_cpu_is_the_reference(fleet):
    """On CPU tensors the entry is its plain version, bit for bit, and
    counts no launch; bad arguments raise."""
    _, a = _trial(fleet, P)
    m = _tp(P).matcher
    args = (torch.tensor(D_B), a["T0"], a["src"], a["packed"], a["origins"],
            a["offs"], H_, W_, RES, m, a["fs"], a["ft"], a["Q"], True)
    cuda_kernels.reset_launch_counts()
    got = cuda_kernels.newton_objective_batch(*args)
    ref = cuda_kernels.newton_objective_batch_reference(*args)
    assert all(torch.equal(x, y) for x, y in zip(got, ref))
    assert set(cuda_kernels.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError, match="go together"):
        cuda_kernels.newton_objective_batch(*args[:10], a["fs"], None)
    meta = torch.zeros((B, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_kernels.newton_objective_batch(meta, meta, None, None, None,
                                            None, H_, W_, RES, m)


@pytest.mark.parametrize("p", [P, P_BF16], ids=["f32", "bf16"])
def test_fuser_update_batch_step_matches_jax(fleet, p):
    """One fuser.update_batch step from the reference's stacked state."""
    js, jinfo = jfu.update_batch(fleet["states"], p, fleet["odom"][:, 0],
                                 fleet["pts"][:, 0], fleet["mask"][:, 0])
    states, odom, pts, mask = _port_inputs(fleet)
    ts, tinfo = tfu.update_batch(states, _tp(p), odom[:, 0], pts[:, 0],
                                 mask[:, 0])
    np.testing.assert_allclose(ts.Tnow.numpy(), np.asarray(js.Tnow),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(tinfo.score.numpy(), np.asarray(jinfo.score),
                               rtol=1e-4)
    np.testing.assert_array_equal(tinfo.converged.numpy(),
                                  np.asarray(jinfo.converged))
    np.testing.assert_array_equal(tinfo.fallback.numpy(),
                                  np.asarray(jinfo.fallback))
    np.testing.assert_array_equal(ts.grid.count.numpy(),
                                  np.asarray(js.grid.count))
    np.testing.assert_allclose(ts.packed.numpy(), np.asarray(js.packed),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ts.grid.occ.numpy(), np.asarray(js.grid.occ),
                               atol=1e-5)
    assert ts.n_updates.tolist() == [2] * B
    back = interop.to_numpy(ts)
    assert back["grid"]["occ"].shape == (B, H_, W_)
    again = interop.fuser_state_from_jax(back, "cpu")
    assert torch.equal(again.packed, ts.packed)


def test_feature_fuser_update_batch_step_matches_jax(fleet):
    """One full-pipeline fleet step with the reference's draws."""
    js, jinfo, jres = jff.update_batch(
        fleet["fstates"], P, fleet["odom"][:, 0], fleet["ranges"][:, 0],
        fleet["hit"][:, 0])
    ts, tinfo, tres = tff.update_batch(
        interop.feature_fuser_state_from_jax(_np(fleet["fstates"]), "cpu"),
        _tp(P), _t(fleet["odom"][:, 0]), _t(fleet["ranges"][:, 0]),
        _t(fleet["hit"][:, 0]), torch.tensor(fleet["u"][:, 0]))
    np.testing.assert_allclose(ts.base.Tnow.numpy(),
                               np.asarray(js.base.Tnow), rtol=0, atol=3e-5)
    np.testing.assert_array_equal(tres.inlier_mask.numpy(),
                                  np.asarray(jres.inlier_mask))
    np.testing.assert_array_equal(ts.prev_feats.mask.numpy(),
                                  np.asarray(js.prev_feats.mask))
    np.testing.assert_allclose(ts.prev_desc.numpy(),
                               np.asarray(js.prev_desc), atol=1e-4)
    assert torch.equal(ts.prev_pose, ts.base.Tnow)
    np.testing.assert_array_equal(tinfo.converged.numpy(),
                                  np.asarray(jinfo.converged))


@pytest.mark.parametrize("p", [P, P_BF16], ids=["f32", "bf16"])
def test_run_sequence_batch_matches_jax(fleet, p):
    _, jtraj, jscores = _jax_run(fleet, p)
    finals, traj, scores = _port_run(fleet, p)
    assert traj.shape == (B, T_STEPS, 3) and scores.shape == (B, T_STEPS)
    _poses_close(traj, jtraj)
    np.testing.assert_allclose(scores.numpy(), jscores, **SCORE_TOL)
    assert torch.equal(finals.Tnow, traj[:, -1])
    # Streams are distinct work, and the table invariant holds.
    assert float((traj[1] - traj[0]).abs().max()) > 1e-4
    # (to 1e-4, as the reference's test of its own incremental table:
    # the refresh and the full finalize vectorise differently and the
    # covariance rows cancel; measured 3.8e-6)
    np.testing.assert_allclose(
        finals.packed.numpy(),
        td2d.packed_from_grid(finals.grid, _tp(p).ndt).numpy(), atol=1e-4)


def test_bf16_rows_move_the_fleet_poses_like_the_reference(fleet):
    """gather_table_bf16 is not ignored: it moves the port's poses, by
    about what it moves the reference's."""
    ref = np.abs(_jax_run(fleet, P_BF16)[1] - _jax_run(fleet, P)[1]).max()
    got = float((_port_run(fleet, P_BF16)[1]
                 - _port_run(fleet, P)[1]).abs().max())
    assert ref > 1e-5 and got > 1e-5
    assert got < 10 * ref + 1e-4


def test_run_sequence_features_batch_matches_jax(fleet):
    _, jtraj, jscores = _np(jsd.run_sequence_features_batch(
        P, fleet["fstates"], fleet["odom"], fleet["ranges"], fleet["hit"]))
    finals, traj, scores = tsd.run_sequence_features_batch(
        _tp(P), interop.feature_fuser_state_from_jax(_np(fleet["fstates"]),
                                                     "cpu"),
        _t(fleet["odom"]), _t(fleet["ranges"]), _t(fleet["hit"]),
        ransac_u=torch.tensor(fleet["u"]))
    _poses_close(traj, jtraj)
    np.testing.assert_allclose(scores.numpy(), jscores, **SCORE_TOL)
    assert torch.equal(finals.prev_pose, traj[:, -1])
    # Without draws the function makes its own, from the generator.
    gen = torch.Generator().manual_seed(3)
    _, own, _ = tsd.run_sequence_features_batch(
        _tp(P), interop.feature_fuser_state_from_jax(_np(fleet["fstates"]),
                                                     "cpu"),
        _t(fleet["odom"][:, :2]), _t(fleet["ranges"][:, :2]),
        _t(fleet["hit"][:, :2]), generator=gen)
    assert own.shape == (B, 2, 3) and bool(torch.isfinite(own).all())


def test_single_stream_drivers_match_jax(fleet):
    """run_sequence and run_sequence_features on stream 1."""
    _, jtraj, jscores = _np(jsd.run_sequence(
        P, fleet["state0"], fleet["odom"][1], fleet["pts"][1],
        fleet["mask"][1]))
    _, traj, scores = tsd.run_sequence(
        _tp(P), interop.fuser_state_from_jax(_np(fleet["state0"]), "cpu"),
        _t(fleet["odom"][1]), _t(fleet["pts"][1]), _t(fleet["mask"][1]))
    _poses_close(traj, jtraj)
    np.testing.assert_allclose(scores.numpy(), jscores, **SCORE_TOL)
    fst = jax.tree.map(lambda x: x[1], fleet["fstates"])
    _, jtraj, jscores = _np(jsd.run_sequence_features(
        P, fst, fleet["odom"][1], fleet["ranges"][1], fleet["hit"][1]))
    _, traj, scores = tsd.run_sequence_features(
        _tp(P), interop.feature_fuser_state_from_jax(_np(fst), "cpu"),
        _t(fleet["odom"][1]), _t(fleet["ranges"][1]), _t(fleet["hit"][1]),
        ransac_u=torch.tensor(fleet["u"][1]))
    _poses_close(traj, jtraj)
    np.testing.assert_allclose(scores.numpy(), jscores, **SCORE_TOL)


@pytest.mark.parametrize("occ_every", [0, 1, 4])
def test_occupancy_cadence_matches_jax(fleet, occ_every):
    """occ_every gates only the occupancy ray scatter: the port's poses
    and scores are those of occ_every=1 bit for bit, and its log-odds are
    the reference's at the same cadence (0: never after initialize)."""
    p = P.replace(occ_every=occ_every)
    jfinals, jtraj, _ = _jax_run(fleet, p)
    finals, traj, scores = _port_run(fleet, p)
    _, traj1, scores1 = _port_run(fleet, P)
    assert torch.equal(traj, traj1) and torch.equal(scores, scores1)
    _poses_close(traj, jtraj)
    # A ray sample on a cell boundary lands in the neighbouring cell
    # when the pose moves by 1e-5, so a few cells differ by whole
    # hit/miss increments (measured 47 of 19,200 at occ_every=1, 17 at
    # 4, none at 0): at most 0.5% of the cells may.
    off = np.abs(finals.grid.occ.numpy() - jfinals.grid.occ) > 1e-4
    assert off.mean() <= 5e-3
    assert (np.abs(finals.grid.occ.numpy()).sum() > 0) == (
        np.abs(jfinals.grid.occ).sum() > 0)
    if occ_every == 0:
        assert not off.any()
        np.testing.assert_array_equal(finals.grid.occ[0].numpy(),
                                      np.asarray(fleet["state0"].grid.occ))
    assert tsd._occ_flags(_tp(p), 6) == np.asarray(
        jsd._occ_flags(p, 6)).tolist()


def test_served_fleet_interleaved_equals_grouped_and_jax(fleet):
    """Groups of 2 over 3 streams (a padded last group): the interleaved
    schedule equals the grouped one bit for bit at occ_every=1, both
    equal the one-batch driver and the reference's grouped serving."""
    inputs = _port_inputs(fleet)
    tp = _tp(P)
    gf, gt, gs = tscaling.serve_fleet_grouped(tp, *inputs, group_size=2)
    nf, nt, ns = tscaling.serve_fleet_interleaved(tp, *inputs, group_size=2,
                                                  time_chunk=3)
    assert gt.shape == (B, T_STEPS, 3) and gf.packed.shape[0] == B
    assert torch.equal(gt, nt) and torch.equal(gs, ns)
    assert torch.equal(gf.grid.occ, nf.grid.occ)
    _, bt, _ = _port_run(fleet, P)
    _poses_close(gt, bt)
    _, jt, js = _np(jscaling.serve_fleet_grouped(
        P, fleet["states"], fleet["odom"], fleet["pts"], fleet["mask"],
        group_size=2))
    _poses_close(gt, jt)
    np.testing.assert_allclose(gs.numpy(), js, **SCORE_TOL)


def test_interleaved_restarts_the_occupancy_cadence(fleet):
    """With occ_every=4 and time_chunk=3 the cadence restarts in every
    chunk, as the reference's does: the log-odds differ from the grouped
    schedule's, the poses do not."""
    inputs = _port_inputs(fleet)
    tp = _tp(P.replace(occ_every=4))
    gf, gt, _ = tscaling.serve_fleet_grouped(tp, *inputs, group_size=2)
    nf, nt, _ = tscaling.serve_fleet_interleaved(tp, *inputs, group_size=2,
                                                 time_chunk=3)
    assert torch.equal(gt, nt)
    assert float((gf.grid.occ - nf.grid.occ).abs().max()) > 0.0


def test_fleet_throughput_measurement(fleet):
    """One device's measurement and report; n_devices=2 shards the fleet
    over the process group's mesh, so without a group it asks for one
    (tests/test_torch_parallel.py runs it in gloo worlds)."""
    seq = fleet["seq"]
    tseq = tds.Sequence(*(_t(x)[:4] for x in (seq.ranges, seq.hit, seq.odom,
                                              seq.gt)))
    rate, times = tscaling.measure_fleet_throughput(
        _tp(P), tseq, streams_per_device=2, reps=1)
    assert rate > 0.0 and len(times) == 1
    rows = tscaling.scaling_report(_tp(P), tseq, streams_per_device=2,
                                   reps=1)
    assert rows[0]["devices"] == 1 and rows[0]["efficiency"] == 1.0
    with pytest.raises(RuntimeError, match="init_distributed"):
        tscaling.measure_fleet_throughput(_tp(P), tseq, n_devices=2)


def test_fuser_update_with_bf16_rows_matches_jax(fleet):
    """The single-stream update reads bfloat16 rows where the reference
    does (gather_block, a window, gather_table_bf16), two steps from the
    reference's state: the first pose within 1e-5 (measured 1.9e-6), the
    second within 1e-4 (measured 4.5e-5: the LM stop test fires at
    rounding noise there, 4 trials against 15, as it does with f32 rows,
    where the same step lands 2.1e-5 away).  The flag is not ignored:
    the first pose differs from the f32 rows' by more than that."""
    js = fleet["state0"]
    ts = interop.fuser_state_from_jax(_np(js), "cpu")
    for t, atol in ((0, 1e-5), (1, 1e-4)):
        args = (fleet["odom"][1, t], fleet["pts"][1, t], fleet["mask"][1, t])
        if t == 0:
            t32, _ = tfu.update(ts, _tp(P), *(_t(x) for x in args))
        js, _ = jfu.update(js, P_BF16, *args)
        ts, _ = tfu.update(ts, _tp(P_BF16), *(_t(x) for x in args))
        np.testing.assert_allclose(ts.Tnow.numpy(), np.asarray(js.Tnow),
                                   rtol=0, atol=atol)
        if t == 0:
            assert float((ts.Tnow - t32.Tnow).abs().max()) > 1e-5


def test_check_params_on_gather_modes():
    """rolling_map and the bfloat16 rows run; a window too small for the
    sensor disc raises; the bfloat16 flag without a window is the
    reference's f32 path."""
    tp = _tp(P)
    tfu.check_params(tp.replace(rolling_map=True))
    tfu.check_params(_tp(P_BF16))
    with pytest.raises(ValueError):
        tfu.check_params(tp.replace(gather_window_cells=40,
                                    gather_table_bf16=True))
    assert tfu._bf16_rows(_tp(P_BF16), batch=False)
    assert tfu._bf16_rows(_tp(P_BF16.replace(gather_block=False)),
                          batch=True)
    assert not tfu._bf16_rows(_tp(P_BF16.replace(gather_block=False)),
                              batch=False)
    assert not tfu._bf16_rows(tp.replace(gather_table_bf16=True),
                              batch=True)
