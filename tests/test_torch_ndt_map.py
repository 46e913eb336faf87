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
