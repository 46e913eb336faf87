"""Parity of the port's feature stack (features/) with the JAX reference
on simulated 360-beam scans: the detector's selected beams and masks
exactly, its values rtol 1e-5 (atol 2e-5 on angles and points: the
beam trigonometry differs at ulp level; responses rtol 1e-4, see
below); descriptors rtol 1e-5 on the
same features; RANSAC with the reference's own draws injected — the
same correspondences and inliers, the same pose to 1e-5."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_feature_graph_tpu.config import FeatureParams
from ndt_feature_graph_tpu.features import descriptor as jdesc
from ndt_feature_graph_tpu.features import detector as jdet
from ndt_feature_graph_tpu.features import distance as jdist
from ndt_feature_graph_tpu.features import ransac as jr
from ndt_feature_graph_tpu.io import dataset as jds
from ndt_feature_graph_tpu_torch import interop
from ndt_feature_graph_tpu_torch.features import descriptor as tdesc
from ndt_feature_graph_tpu_torch.features import detector as tdet
from ndt_feature_graph_tpu_torch.features import distance as tdist
from ndt_feature_graph_tpu_torch.features import ransac as tr

torch.set_num_threads(2)
FP = FeatureParams(num_beams=360, max_range=15.0)
TFP = interop.params_from_jax(FP)    # the port's own dataclass


@functools.lru_cache(maxsize=None)
def _sequence():
    traj = jds.loop_trajectory(28, radius=5.0)
    return jds.simulate_sequence(jax.random.PRNGKey(11), traj,
                                 num_beams=360, max_range=15.0)


def _scan(t):
    seq = _sequence()
    return np.asarray(seq.ranges[t]), np.asarray(seq.hit[t])


def _feats(t):
    r, h = _scan(t)
    jf = jdet.detect(FP, jnp.asarray(r), jnp.asarray(h))
    return jf, jdesc.describe(FP, jf, jnp.asarray(r), jnp.asarray(h))


@pytest.mark.parametrize("t", [0, 5, 13])
def test_detect_matches_jax(t):
    r, h = _scan(t)
    jf = jdet.detect(FP, jnp.asarray(r), jnp.asarray(h))
    tf = tdet.detect(TFP, torch.tensor(r), torch.tensor(h))
    m = np.asarray(jf.mask)
    np.testing.assert_array_equal(m, tf.mask.numpy())
    assert m.sum() >= 5
    # Same beams selected, in the same order: their detection scales are
    # equal and their points agree to the trigonometry's ulps.  Values
    # are compared on the valid features (padding rows are unused).
    np.testing.assert_array_equal(np.asarray(jf.scales), tf.scales.numpy())
    np.testing.assert_allclose(np.asarray(jf.pts)[m], tf.pts.numpy()[m],
                               rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(jf.angles)[m],
                               tf.angles.numpy()[m], rtol=1e-5, atol=2e-5)
    # The response is the angle between differences of neighbouring
    # smoothed points: the subtraction cancels, so ulp-level point
    # differences show at ~2.5e-5 relative.
    np.testing.assert_allclose(np.asarray(jf.response),
                               tf.response.numpy(), rtol=1e-4, atol=1e-6)


def test_top_k_stable_orders_ties_like_lax():
    x = np.asarray([0.0, 3.0, 0.0, 3.0, 1.0, 0.0, 0.0, 2.0], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 6)
    tv, ti = tdet.top_k_stable(torch.tensor(x), 6)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


@pytest.mark.parametrize("stat", ["beta_mean", "hitmiss"])
def test_describe_matches_jax(stat):
    fp = FP.replace(descriptor_stat=stat)
    r, h = _scan(7)
    jf = jdet.detect(fp, jnp.asarray(r), jnp.asarray(h))
    jd = jdesc.describe(fp, jf, jnp.asarray(r), jnp.asarray(h))
    tfp = interop.params_from_jax(fp)
    td = tdesc.describe(tfp, interop.feature_set_from_jax(
        jax.tree.map(np.asarray, jf), "cpu"), torch.tensor(r),
        torch.tensor(h))
    assert td.shape == (fp.max_features, tdesc.descriptor_dim(tfp))
    np.testing.assert_allclose(np.asarray(jd), td.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_chi2_matrix_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.random((32, 48)).astype(np.float32)
    b = rng.random((20, 48)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(jdist.symmetric_chi2_matrix(jnp.asarray(a),
                                               jnp.asarray(b))),
        tdist.symmetric_chi2_matrix(torch.tensor(a), torch.tensor(b)).numpy(),
        rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("pair", [(0, 1), (4, 5), (9, 12), (3, 20)])
def test_match_sets_with_injected_draws(pair):
    """Matched and unrelated scan pairs; the hypothesis uniforms are the
    reference's own (key split as feature_fuser.update does)."""
    (jref, jrd), (jmov, jmd) = _feats(pair[0]), _feats(pair[1])
    key = jax.random.PRNGKey(sum(pair))
    ki, _ = jax.random.split(key)
    u = jax.random.uniform(ki, (FP.ransac_hypotheses, 2))
    jres = jr.match_sets(FP, jref, jrd, jmov, jmd, key)
    to = lambda f: interop.feature_set_from_jax(  # noqa: E731
        jax.tree.map(np.asarray, f), "cpu")
    tres = tr.match_sets(TFP, to(jref), torch.tensor(np.asarray(jrd)),
                         to(jmov), torch.tensor(np.asarray(jmd)),
                         torch.tensor(np.asarray(u)))
    for name in ("corr_ref", "corr_mov", "corr_mask", "inlier_mask",
                 "num_inliers", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(jres, name)),
                                      getattr(tres, name).numpy(), name)
    np.testing.assert_allclose(np.asarray(jres.T), tres.T.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(float(jres.score), float(tres.score),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("pair", [(0, 1), (3, 20)])
def test_to_paired_cells_matches_jax(pair):
    """The paired pseudo-cells of a RANSAC result, from the port's own
    result and from the reference's carried over by interop: the same
    gathered points, the same fixed covariance, the inlier mask."""
    (jref, jrd), (jmov, jmd) = _feats(pair[0]), _feats(pair[1])
    key = jax.random.PRNGKey(sum(pair))
    u = jax.random.uniform(jax.random.split(key)[0], (FP.ransac_hypotheses, 2))
    jres = jr.match_sets(FP, jref, jrd, jmov, jmd, key)
    want = jax.tree.map(np.asarray, jr.to_paired_cells(jres, jref, jmov))
    to = lambda f: interop.feature_set_from_jax(  # noqa: E731
        jax.tree.map(np.asarray, f), "cpu")
    carried = interop.match_result_from_jax(jax.tree.map(np.asarray, jres),
                                            "cpu")
    for name in ("T", "score", "num_inliers", "corr_ref", "corr_mov",
                 "corr_mask", "inlier_mask", "valid"):
        np.testing.assert_array_equal(getattr(carried, name).numpy(),
                                      np.asarray(getattr(jres, name)), name)
    own = tr.match_sets(TFP, to(jref), torch.tensor(np.asarray(jrd)),
                        to(jmov), torch.tensor(np.asarray(jmd)),
                        torch.tensor(np.asarray(u)))
    for res in (carried, own):
        got = tr.to_paired_cells(res, to(jref), to(jmov))
        for g, w in zip(got, want):
            for name in ("means", "covs", "mask"):
                np.testing.assert_array_equal(getattr(g, name).numpy(),
                                              getattr(w, name), name)
    assert want[0].mask.sum() >= (2 if pair == (0, 1) else 0)

