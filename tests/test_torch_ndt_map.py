"""Parity of the PyTorch port's NDT grid (ops/ndt_map.py) with the JAX
reference on simulated scans: grid statistics, occupancy, finalize and
the fixed-size compactions.  Statistics rtol 1e-5 (scatter-add order
differs), indices exact; cell lists are compared on the masked prefix
only — the padded rows differ by design (to_cell_list_touched pads with
candidate cap-1 stats, the reference's own inconsistency)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_feature_graph_tpu.config import NDTMapParams
from ndt_feature_graph_tpu.io import dataset as jds
from ndt_feature_graph_tpu.ops import ndt_map as jnm
from ndt_feature_graph_tpu_torch import interop
from ndt_feature_graph_tpu_torch.ops import ndt_map as tnm

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-6

PARAMS = NDTMapParams(
    resolution=0.5, size_x=40.0, size_y=40.0, sensor_range=15.0,
    max_points_per_scan=360, max_cells=512,
)
TPARAMS = interop.params_from_jax(PARAMS)   # the port's own dataclass


@functools.lru_cache(maxsize=None)
def _sequence(seed):
    traj = jds.loop_trajectory(6, radius=5.0)
    return jds.simulate_sequence(jax.random.PRNGKey(seed), traj,
                                 num_beams=360, max_range=15.0)


def _scan(seed=0, t=1, nan=False):
    """A simulated 360-beam scan as numpy points + mask, with some points
    off the grid, some masked and (optionally) NaN glitches."""
    seq = _sequence(seed)
    pts, mask = jds.scan_to_points(seq.ranges[t], seq.hit[t])
    pts, mask = np.array(pts), np.array(mask)
    pts[:5] += 25.0                                   # off the grid
    mask[5:12] = False
    if nan:
        pts[12:15] = np.nan
        mask[12:15] = True
    return pts, mask


def _grids(pts, mask, center=(0.3, -0.2)):
    c = np.asarray(center, np.float32)
    jg, jf = jnm.add_points_touched(jnm.empty_grid(PARAMS, jnp.asarray(c)),
                                    PARAMS, jnp.asarray(pts),
                                    jnp.asarray(mask))
    tg, tf = tnm.add_points_touched(tnm.empty_grid(TPARAMS, torch.tensor(c)),
                                    TPARAMS, torch.tensor(pts),
                                    torch.tensor(mask))
    return jg, jf, tg, tf


def _close(j, t, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("nan", [False, True])
def test_add_points_touched_matches_jax(nan):
    pts, mask = _scan(nan=nan)
    jg, jf, tg, tf = _grids(pts, mask)
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    _close(jg.origin, tg.origin, rtol=0, atol=0)
    np.testing.assert_array_equal(np.asarray(jg.count), tg.count.numpy())
    _close(jg.psum, tg.psum, atol=1e-5)
    _close(jg.outer, tg.outer, atol=1e-4)
    assert np.isfinite(tg.outer.numpy()).all()


def test_update_occupancy_matches_jax():
    pts, mask = _scan(nan=True)
    jg, _, tg, _ = _grids(pts, mask)
    origin = np.asarray([0.1, -0.1], np.float32)
    jg = jnm.update_occupancy(jg, PARAMS, jnp.asarray(origin),
                              jnp.asarray(pts), jnp.asarray(mask))
    tg = tnm.update_occupancy(tg, TPARAMS, torch.tensor(origin),
                              torch.tensor(pts), torch.tensor(mask))
    _close(jg.occ, tg.occ, atol=1e-5)
    assert np.abs(tg.occ.numpy()).max() > 0.5


def _reference_cov_spread(pts, mask, jc, orders=8, center=(0.3, -0.2)):
    """Largest change of the reference's own finalized covariances when
    the same points are summed in other orders: the sample covariance
    outer/n - mean mean^T cancels in float32 (cells metres from the
    origin, covariances ~1e-3), so any change of a sum's rounding moves
    it by ~1e-5."""
    rng = np.random.default_rng(0)
    c = jnp.asarray(np.asarray(center, np.float32))
    spread = 0.0
    for _ in range(orders):
        perm = rng.permutation(len(pts))
        g, _ = jnm.add_points_touched(jnm.empty_grid(PARAMS, c), PARAMS,
                                      jnp.asarray(pts[perm]),
                                      jnp.asarray(mask[perm]))
        spread = max(spread, float(np.abs(
            np.asarray(jnm.finalize(g, PARAMS)[1]) - np.asarray(jc)).max()))
    return spread


def test_finalize_matches_jax():
    """Means and the valid mask at the module's tolerances; covariances
    to the reference's own spread under a reordering of the same points
    (1.5e-5 over four orders, 2.0e-5 over twelve).  The port's CPU result
    itself moves that much in some processes: there torch's float32 sqrt
    returns a 12-bit approximation over half the grid (ROADMAP queue 3),
    which this cancellation turns into 1.35e-5 of covariance."""
    pts, mask = _scan(seed=1)
    jg, _, tg, _ = _grids(pts, mask)
    jm, jc, jv = jnm.finalize(jg, PARAMS)
    tm, tc, tv = tnm.finalize(tg, TPARAMS)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    assert tv.numpy().sum() > 20
    _close(jm, tm)
    spread = _reference_cov_spread(pts, mask, jc)
    assert 1e-6 < spread < 1e-4
    _close(jc, tc, atol=max(ATOL, spread))


def test_condition_cov_matches_jax():
    rng = np.random.default_rng(0)
    L = rng.normal(0, 0.2, (200, 2, 2)).astype(np.float32)
    covs = L @ L.transpose(0, 2, 1)
    covs[:20, 0, 1] = covs[:20, 1, 0] = 0.0          # degenerate branch
    covs[20:30] = np.diag([1e-4, 0.3]).astype(np.float32)
    je, jv = jnm._sym_eig_2x2(jnp.asarray(covs))
    te, tv = tnm._sym_eig_2x2(torch.tensor(covs))
    _close(je, te, atol=1e-6)
    _close(jv, tv, atol=1e-6)
    _close(jnm.condition_cov(jnp.asarray(covs)),
           tnm.condition_cov(torch.tensor(covs)))


@pytest.mark.parametrize("touched", [False, True])
def test_cell_lists_match_jax(touched):
    pts, mask = _scan(seed=2)
    jg, jf, tg, tf = _grids(pts, mask)
    if touched:
        a = jnm.to_cell_list_touched(jg, PARAMS, jf)
        b = tnm.to_cell_list_touched(tg, TPARAMS, tf)
    else:
        a = jnm.to_cell_list(jg, PARAMS)
        b = tnm.to_cell_list(tg, TPARAMS)
    m = np.asarray(a.mask)
    np.testing.assert_array_equal(m, b.mask.numpy())
    assert m.sum() > 20
    _close(np.asarray(a.means)[m], b.means[b.mask])
    _close(np.asarray(a.covs)[m], b.covs[b.mask])


@pytest.mark.parametrize("n_set", [0, 7, 40, 200])
def test_nonzero_fixed_matches_jnp(n_set):
    rng = np.random.default_rng(n_set)
    flags = np.zeros(300, bool)
    flags[rng.choice(300, n_set, replace=False)] = True
    for size, fill in ((64, 299), (512, 63)):
        ref = jnp.nonzero(jnp.asarray(flags), size=size,
                          fill_value=fill)[0]
        got = tnm.nonzero_fixed(torch.tensor(flags), size, fill)
        np.testing.assert_array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("n_vals", [10, 300])
def test_unique_fixed_matches_jnp(n_vals):
    rng = np.random.default_rng(n_vals)
    vals = rng.integers(0, n_vals, 360)
    vals[rng.random(360) < 0.2] = 1600             # the h*w sentinel
    for size in (32, 512):
        ref = jnp.unique(jnp.asarray(vals), size=size, fill_value=1600)
        got = tnm.unique_fixed(torch.tensor(vals), size, 1600)
        np.testing.assert_array_equal(np.asarray(ref), got.numpy())


def _index_add_update(g, params, pts, mask, sensor):
    """The map update as written before the fixed-order scatter: one
    `index_add` per field (hits, then misses, for the occupancy), the
    serial CPU loop whose bits the port must keep."""
    h, w = params.grid_h, params.grid_w
    iy, ix = tnm.cell_index(params, g.origin[..., None, :], pts)
    ok = mask & torch.isfinite(pts).all(-1) & tnm.in_bounds(params, iy, ix)
    offs = tnm._stream_offsets(pts.shape[:-2], h * w, pts.device)
    fi = (torch.where(ok, iy * w + ix, h * w - 1).to(torch.int64)
          + offs).reshape(-1)
    ptsm = torch.where(ok[..., None], pts, 0.0)
    op = ptsm[..., :, None] * ptsm[..., None, :]
    count = g.count.reshape(-1).index_add(0, fi, ok.reshape(-1).float())
    psum = g.psum.reshape(-1, 2).index_add(0, fi, ptsm.reshape(-1, 2))
    outer = g.outer.reshape(-1, 2, 2).index_add(0, fi, op.reshape(-1, 2, 2))
    g = tnm.NDTGrid(g.origin, count.reshape(g.count.shape),
                    psum.reshape(g.psum.shape), outer.reshape(g.outer.shape),
                    g.occ)
    s = (torch.arange(params.ray_samples, dtype=torch.float32) + 0.5
         ) / params.ray_samples
    so = sensor[..., None, None, :]
    ray = so + s[:, None] * (pts[..., :, None, :] - so)
    riy, rix = tnm.cell_index(params, g.origin[..., None, None, :], ray)
    rok = mask[..., None] & tnm.in_bounds(params, riy, rix)
    rok = rok & ~((riy == iy[..., None]) & (rix == ix[..., None]))
    rflat = torch.where(rok, riy * w + rix, h * w - 1).flatten(-2)
    occ = g.occ.reshape(-1).index_add(
        0, fi, torch.where(ok, params.occ_hit, 0.0).reshape(-1)
    ).index_add(0, (rflat + offs).reshape(-1),
                torch.where(rok, params.occ_miss, 0.0).reshape(-1))
    occ = occ.reshape(g.occ.shape).clamp(-params.occ_clamp,
                                         params.occ_clamp)
    return tnm.NDTGrid(g.origin, g.count, g.psum, g.outer, occ)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("streams", [0, 3])
def test_fixed_order_scatter_keeps_the_cpu_bits(streams):
    """The fixed-order map update (ops/ndt_map.scatter_add_rows) gives
    the CPU bits of the earlier one-`index_add`-per-field update, bit
    for bit, over five scans into one grid and into a stack of three
    (the fleet's flat scatter with per-stream offsets)."""
    lead = (streams,) if streams else ()
    center = torch.zeros(lead + (2,))
    g = tnm.empty_grid(TPARAMS, center)
    ref = tnm.empty_grid(TPARAMS, center)
    for t in range(1, 6):
        pts, mask = _scan(seed=2, t=t, nan=t == 3)
        pts, mask = torch.tensor(pts), torch.tensor(mask)
        sensor = torch.tensor([0.2, -0.1])
        if streams:
            pts = torch.stack([pts + 0.37 * k for k in range(streams)])
            mask = mask.expand(streams, -1)
            sensor = sensor.expand(streams, 2)
        g = tnm.add_points(g, TPARAMS, pts, mask)
        g = tnm.update_occupancy(g, TPARAMS, sensor, pts, mask)
        ref = _index_add_update(ref, TPARAMS, pts, mask, sensor)
    for k in ("count", "psum", "outer", "occ"):
        assert torch.equal(_bits(getattr(g, k)), _bits(getattr(ref, k))), k
    assert float(g.count.sum()) > 100 and float(g.occ.abs().max()) > 0.5


@pytest.mark.parametrize("widths", [(1,), (1, 2, 4)])
def test_sorted_scatter_branch_matches_index_add(widths):
    """The card's branch of scatter_add_rows (each touched cell's old row
    first, then the entries, summed by a stable sort; untouched cells
    keep their rows) gives index_add's bits where its accumulating
    `index_put_` is sequential, as it is on one CPU thread: one channel
    (padded to two) and the map's 1 + 2 + 4."""
    rng = np.random.default_rng(3)
    n, m = 300, 5000
    idx = torch.tensor(rng.integers(0, 40, m))
    bases = [torch.tensor(rng.standard_normal((n, c)), dtype=torch.float32)
             for c in widths]
    vals = [torch.tensor(rng.standard_normal((m, c)), dtype=torch.float32)
            for c in widths]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = tnm._scatter_add_rows_sorted(bases, idx, vals)
    finally:
        torch.set_num_threads(threads)
    for a, b in zip(got, tnm.scatter_add_rows(bases, idx, vals)):
        assert torch.equal(_bits(a), _bits(b))
