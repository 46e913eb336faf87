"""Parity of the port's loop-closure link pipeline (graph/links.py, the
batched RANSAC, d2d.newton_match_batch, d2d.cov_from_hessian and
d2d_analytic.fgh_dense_flat_batch) with the JAX reference, on a small
JAX node bank carried over by `interop`: six submaps of the 28-scan loop
of test_torch_slam.py (40x40 m, 360 beams), each a fuser initialized on
one scan in its node frame with the features of three scans, and the
reference's own RANSAC draws replayed from its key.

Tolerances, each with its reason:
  * RANSAC: the same correspondences, inliers and validity; pose 1e-5
    (test_torch_features.py).
  * overlap scores: 1e-5 — the sigmoid and the float32 transform of the
    cell centres round differently by ulps; a cell centre that lands on
    a cell edge may flip one cell (none does here).
  * fgh_dense_flat_batch: as tests/test_pallas_kernels.py (f rtol 1e-4;
    g, H rtol 2e-3): the sums over ~3,000 pairs run in another order.
  * refined links: pose 2e-4, covariance 2e-3 relative to its largest
    entry: the batched Newton stops at rounding noise (score change <=
    1e-4 at |f| ~ 100, see test_torch_d2d.py), so a lane may take one
    trial more or less; lanes in flat cost valleys are held to the
    reference's cost instead (see the test).
  * cov_from_hessian: Jacobi rotations against LAPACK's eigh, both
    float32 — 1e-3 of the largest covariance entry on Hessians with
    condition numbers up to 1e4; exact for the degenerate ones (zero:
    the floor; NaN: NaN).
"""

import functools
import importlib.util
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_feature_graph_tpu.config import (
    FeatureParams, FuserParams, GraphParams, MatcherParams, NDTMapParams,
)
from ndt_feature_graph_tpu.core import se2 as jse2
from ndt_feature_graph_tpu.features import descriptor as jdesc
from ndt_feature_graph_tpu.features import detector as jdet
from ndt_feature_graph_tpu.fusion import fuser as jfu
from ndt_feature_graph_tpu.graph import links as jl
from ndt_feature_graph_tpu.graph import node as jnode
from ndt_feature_graph_tpu.io import dataset as jds
from ndt_feature_graph_tpu.ops import d2d as jd2d
from ndt_feature_graph_tpu.ops import d2d_analytic as jda
from ndt_feature_graph_tpu.ops import ndt_map as jnm
from ndt_feature_graph_tpu_torch import interop
from ndt_feature_graph_tpu_torch.graph import links as tl
from ndt_feature_graph_tpu_torch.graph.node import map_tensors
from ndt_feature_graph_tpu_torch.ops import cuda_kernels
from ndt_feature_graph_tpu_torch.ops import d2d as td2d
from ndt_feature_graph_tpu_torch.ops import d2d_analytic as tda
from ndt_feature_graph_tpu_torch.ops.ndt_map import CellList

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "make_torch_port_fixture",
    ROOT / "examples" / "make_torch_port_fixture.py")
fixture_gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixture_gen)

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
NODE_SCANS = (0, 5, 10, 15, 20, 24)
KEY = jax.random.PRNGKey(5)


def _np(x):
    return jax.tree.map(np.asarray, x)


@functools.lru_cache(maxsize=None)
def _bank():
    """A stacked JAX node bank and its pair list (all i < j)."""
    traj = jds.loop_trajectory(28, radius=5.0)
    seq = jds.simulate_sequence(jax.random.PRNGKey(11), traj,
                                num_beams=360, max_range=15.0)
    fm_cap = 128
    dim = jdesc.descriptor_dim(P.features)
    nodes = []
    for s in NODE_SCANS:
        pts, m = jds.scan_to_points(seq.ranges[s], seq.hit[s])
        st = jfu.initialize(P, jnp.zeros(3), jnp.zeros(3), pts, m)
        fmap = jnode.empty_feature_map(fm_cap, dim)
        for k in range(s, min(s + 3, 28)):
            f = jdet.detect(P.features, seq.ranges[k], seq.hit[k])
            d = jdesc.describe(P.features, f, seq.ranges[k], seq.hit[k])
            fmap = jnode.insert_features(fmap, f, d,
                                         jse2.sub(seq.gt[s], seq.gt[k]))
        nodes.append(jnode.freeze_node(P, seq.gt[s], st, fmap))
    stacked = jnode.stack_nodes(nodes)
    n = len(nodes)
    pairs = np.asarray([(i, j) for i in range(n) for j in range(i + 1, n)])
    return stacked, pairs, np.asarray(seq.gt)[list(NODE_SCANS)]


@functools.lru_cache(maxsize=None)
def _jax_links():
    stacked, pairs, _ = _bank()
    ref, mov = jnp.asarray(pairs[:, 0]), jnp.asarray(pairs[:, 1])
    mask = jnp.ones(len(pairs), bool).at[3].set(False)
    ls = jl.compute_links_batch(P.features, RES, stacked, ref, mov, mask, KEY)
    budget = jl.source_cell_budget(stacked)
    refined = jl.refine_links_d2d(P.ndt, M, stacked, ls, src_budget=budget)
    return ls, refined, jl.rescore_links(RES, stacked, refined), budget


def _tbank():
    return interop.node_from_jax(_np(_bank()[0]), "cpu")


def _u(p):
    return torch.tensor(fixture_gen._pair_uniforms(
        KEY, p, P.features.ransac_hypotheses))


def test_compute_links_batch_matches_jax():
    stacked, pairs, _ = _bank()
    ls_j = _jax_links()[0]
    mask = np.ones(len(pairs), bool)
    mask[3] = False
    ls_t = tl.compute_links_batch(TP.features, RES, _tbank(),
                                  torch.tensor(pairs[:, 0]),
                                  torch.tensor(pairs[:, 1]),
                                  torch.tensor(mask), _u(len(pairs)))
    np.testing.assert_array_equal(ls_t.mask.numpy(), np.asarray(ls_j.mask))
    assert ls_t.mask.sum() >= 5
    np.testing.assert_allclose(ls_t.T.numpy(), np.asarray(ls_j.T), atol=1e-5)
    np.testing.assert_allclose(ls_t.score.numpy(), np.asarray(ls_j.score),
                               atol=1e-5)
    np.testing.assert_array_equal(ls_t.cov.numpy(), np.asarray(ls_j.cov))


def test_compute_link_equals_batch_row_and_matches_jax():
    """One pair's proposal (compute_link) under that pair's draws: the
    bits of its row of compute_links_batch over the bank's 15 pairs (on
    the CPU a row of this grid's 6,400 cells is summed in one order
    alone and in a batch; see links.compute_link), and the reference's
    compute_link under the pair's key."""
    stacked, pairs, _ = _bank()
    bank = _tbank()
    p = len(pairs)
    u = _u(p)
    r, m = torch.tensor(pairs[:, 0]), torch.tensor(pairs[:, 1])
    batch = tl.compute_links_batch(TP.features, RES, bank, r, m,
                                   torch.ones(p, dtype=torch.bool), u)
    node = lambda i: map_tensors(lambda x: x[i], bank)  # noqa: E731
    jnode_ = lambda i: jax.tree.map(lambda x: x[i], stacked)  # noqa: E731
    keys = jax.random.split(KEY, p)
    for k in range(p):
        T, score, valid, nb = tl.compute_link(TP.features, RES, node(r[k]),
                                              node(m[k]), u[k])
        assert torch.equal(T, batch.T[k])
        assert torch.equal(score, batch.score[k])
        assert bool(valid) == bool(batch.mask[k])
        jT, js, jv, jn = jl.compute_link(P.features, RES, jnode_(pairs[k, 0]),
                                         jnode_(pairs[k, 1]), keys[k])
        assert bool(valid) == bool(jv) and int(nb) == int(jn)
        np.testing.assert_allclose(T.numpy(), np.asarray(jT), atol=1e-5)
        np.testing.assert_allclose(float(score), float(js), atol=1e-5)
    assert batch.mask.sum() >= 5


def test_match_sets_batch_equals_per_pair():
    """The batched RANSAC over pairs gives each pair what the per-scan
    call gives it."""
    from ndt_feature_graph_tpu_torch.features import ransac as tr
    from ndt_feature_graph_tpu_torch.graph.node import map_tensors

    bank = _tbank()
    _, pairs, _ = _bank()
    u = _u(len(pairs))
    r, m = torch.tensor(pairs[:, 0]), torch.tensor(pairs[:, 1])
    feats = lambda i: map_tensors(lambda x: x[i], bank.feats)  # noqa
    batch = tr.match_sets(TP.features, feats(r), bank.desc[r], feats(m),
                          bank.desc[m], u)
    for k in (0, 4, 9):
        one = tr.match_sets(TP.features, feats(r[k]), bank.desc[r[k]],
                            feats(m[k]), bank.desc[m[k]], u[k])
        for name in ("corr_ref", "corr_mov", "corr_mask", "inlier_mask",
                     "num_inliers", "valid"):
            np.testing.assert_array_equal(getattr(batch, name)[k].numpy(),
                                          getattr(one, name).numpy(), name)
        np.testing.assert_allclose(batch.T[k].numpy(), one.T.numpy(),
                                   atol=1e-6)


def test_overlap_scores_match_jax():
    stacked, pairs, _ = _bank()
    ls_j = _jax_links()[2]
    bank = _tbank()
    got = tl.rescore_links(RES, bank, interop.link_set_from_jax(_np(ls_j),
                                                            "cpu"))
    np.testing.assert_allclose(got.score.numpy(), np.asarray(ls_j.score),
                               atol=1e-5)
    nodes = [jax.tree.map(lambda x, k=k: x[k], stacked) for k in (0, 1)]
    T = ls_j.T[0]
    sj, nj = jl.occupancy_overlap_score(nodes[0], nodes[1], T, RES)
    tn = [interop.node_from_jax(_np(n), "cpu") for n in nodes]
    st, nt = tl.occupancy_overlap_score(tn[0], tn[1],
                                        torch.tensor(np.asarray(T)), RES)
    assert int(nt) == int(nj) > 0
    np.testing.assert_allclose(float(st), float(sj), atol=1e-5)


def _lanes(seed=0):
    """Batch-entry inputs on the bank: lanes over the pairs plus an
    all-masked lane and a lane against the bank's last node."""
    stacked, pairs, _ = _bank()
    ls_j = _jax_links()[0]
    budget = _jax_links()[3]
    rng = np.random.default_rng(seed)
    ref = np.concatenate([pairs[:, 0], [0, len(NODE_SCANS) - 1]])
    mov = np.concatenate([pairs[:, 1], [1, 0]])
    T0 = np.concatenate([np.asarray(ls_j.T), np.zeros((2, 3), np.float32)])
    d = (rng.normal(0, [0.05, 0.05, 0.01], T0.shape)).astype(np.float32)
    cells = _np(stacked.cells)
    src = [np.array(getattr(cells, k)[mov, :budget])
           for k in ("means", "covs", "mask")]
    src[2][-2] = False                                   # all-masked lane
    origins = np.asarray(stacked.target.origin)[ref]
    return d, T0, src, origins, (ref * H_ * W_).astype(np.int64)


def test_fgh_dense_flat_batch_matches_jax():
    d, T0, src, origins, offs = _lanes()
    stacked = _bank()[0]
    packed = np.asarray(stacked.target.packed).reshape(-1, 8)
    f_j, g_j, H_j = jda.fgh_dense_flat_batch(
        jnp.asarray(d), jnp.asarray(T0),
        jnm.CellList(*(jnp.asarray(x) for x in src)),
        jnp.asarray(packed), jnp.asarray(origins),
        jnp.asarray(offs.astype(np.int32)), H_, W_, RES, M)
    tsrc = CellList(*(torch.tensor(x) for x in src))
    got = cuda_kernels.fgh_dense_flat_batch(
        torch.tensor(d), torch.tensor(T0), tsrc, torch.tensor(packed),
        torch.tensor(origins), torch.tensor(offs), H_, W_, RES,
        M.n_neighbours, M.lfd1, M.lfd2)
    f_t, g_t, H_t = got
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=2e-3,
                               atol=1e-4)
    np.testing.assert_allclose(H_t.numpy(), np.asarray(H_j), rtol=2e-3,
                               atol=1e-3)
    assert float(f_t[-2]) == 0.0 and float(H_t[-2].abs().max()) == 0.0
    assert float(f_t[-1]) < 0.0
    # Each lane equals the single-lane term at its own row offset.
    k = 7
    one = tda.fgh_dense_flat(torch.tensor(d[k]), torch.tensor(T0[k]),
                             CellList(*(torch.tensor(x[k]) for x in src)),
                             torch.tensor(packed), torch.tensor(origins[k]),
                             int(offs[k]), H_, W_, RES, TM)
    np.testing.assert_allclose(float(one[0]), float(f_t[k]), rtol=1e-6)
    assert cuda_kernels.LAUNCHES["fgh_dense_flat_batch"] == 0


def _d2d_cost(T, links):
    """The reference's D2D cost of each link's refined pose."""
    stacked, _, _ = _bank()
    budget = _jax_links()[3]
    mov, ref = np.asarray(links.mov), np.asarray(links.ref)
    src = jnm.CellList(stacked.cells.means[mov, :budget],
                       stacked.cells.covs[mov, :budget],
                       stacked.cells.mask[mov, :budget])
    return np.asarray(jda.fgh_dense_flat_batch(
        jnp.zeros((len(mov), 3)), jnp.asarray(T), src,
        stacked.target.packed.reshape(-1, 8), stacked.target.origin[ref],
        jnp.asarray(ref * H_ * W_), H_, W_, RES, M)[0])


def test_refine_links_d2d_matches_jax():
    """Most lanes land on the reference's pose.  A lane whose cost is
    flat along a valley (weak overlap) may stop elsewhere in it after
    reordered float32 sums (measured: 2 of 15 lanes, 7-8 cm apart, their
    Newton scores equal to 5e-5): there the port's pose must score
    within 2% of the reference's pose in the reference's own cost.  The
    window cost jumps where a moved cell crosses a cell edge (one pair
    moves it by up to lfd1), so re-evaluating a pose even through
    compose(0, T) can move it by ~0.4 (measured 1.5% on lane 2)."""
    ls_j, refined_j, _, budget = _jax_links()
    assert tl.source_cell_budget(_tbank()) == budget
    got = tl.refine_links_d2d(TP.ndt, TM, _tbank(),
                              interop.link_set_from_jax(_np(ls_j), "cpu"),
                              src_budget=budget)
    np.testing.assert_array_equal(got.mask.numpy(),
                                  np.asarray(refined_j.mask))
    Tj = np.asarray(refined_j.T)
    same = np.abs(got.T.numpy() - Tj).max(1) <= 2e-4
    assert same.sum() >= 12, same
    f_port, f_ref = _d2d_cost(got.T.numpy(), ls_j), _d2d_cost(Tj, ls_j)
    assert (f_port <= f_ref + 0.02 * np.abs(f_ref)).all(), (f_port, f_ref)
    cj = np.asarray(refined_j.cov)[same]
    scale = np.abs(cj).max((1, 2), keepdims=True)
    np.testing.assert_allclose(got.cov.numpy()[same] / scale, cj / scale,
                               atol=2e-3)


def test_valid_links_match_jax_with_a_non_finite_link():
    _, _, ls_j, _ = _jax_links()
    _, _, gt_nodes = _bank()
    ls = jax.tree.map(np.array, ls_j)._replace(
        mask=np.ones(len(_bank()[1]), bool))
    ls.T[1] = np.nan
    ls.cov[2, 0, 0] = np.inf
    gp = GraphParams(valid_max_dist=1.0, valid_min_idx_dist=1,
                     valid_max_score=0.3)
    node_T = gt_nodes.astype(np.float32)
    ref = np.asarray(jl.valid_links(gp, jnp.asarray(node_T), jax.tree.map(
        jnp.asarray, ls)))
    got = tl.valid_links(interop.params_from_jax(gp), torch.tensor(node_T),
                         interop.link_set_from_jax(ls, "cpu")).numpy()
    np.testing.assert_array_equal(got, ref)
    assert not got[1] and not got[2] and got.sum() >= 3


def _bowls(b, seed=0):
    """B independent Gaussian-well costs f = -a exp(-e'Ae/2) + q|d|^2,
    e = d - c (as test_torch_d2d._bowl), written with the same float32
    elementwise operations in both frameworks."""
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(b, 3, 3)).astype(np.float32)
    A = (L @ L.transpose(0, 2, 1) + 0.5 * np.eye(3)).astype(np.float32)
    c = rng.normal(scale=0.8, size=(b, 3)).astype(np.float32)
    amp = rng.uniform(5, 20, (b, 1)).astype(np.float32)
    q = rng.uniform(0.01, 1, (b, 1)).astype(np.float32)
    eye = np.eye(3, dtype=np.float32)

    def make(xp, t):
        A_, c_, amp_, q_, eye_ = t(A), t(c), t(amp), t(q), t(eye)

        def fgh(d):
            e = d - c_
            Ae = (A_ * e[:, None, :]).sum(-1)
            E = amp_ * xp.exp(-0.5 * (e * Ae).sum(-1, keepdims=True))
            f = (-E + q_ * (d * d).sum(-1, keepdims=True))[:, 0]
            H = E[:, :, None] * (A_ - Ae[:, :, None] * Ae[:, None, :])
            return f, E * Ae + 2 * q_ * d, H + 2 * q_[:, :, None] * eye_
        return fgh

    return make(jnp, jnp.asarray), make(torch, torch.tensor)


@pytest.mark.parametrize("step_control", [True, False])
def test_newton_match_batch_matches_jax(step_control):
    m = MatcherParams(step_control=step_control)
    fj, ft = _bowls(12)
    dj, sj, ij, cj = jax.jit(
        lambda: jd2d.newton_match_batch(jnp.zeros((12, 3)), m, fj))()
    dt, st, it, ct = td2d.newton_match_batch(
        torch.zeros(12, 3), interop.params_from_jax(m), ft)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5)


def test_cov_from_hessian_matches_jax_and_passes_nan():
    rng = np.random.default_rng(4)
    Hs = []
    for cond in (1.0, 1e2, 1e4):
        Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        w = np.geomspace(1.0, cond, 3) * rng.uniform(1, 50)
        Hs.append((Q * w) @ Q.T)
    Hs += [np.zeros((3, 3)), np.diag([3.0, -2.0, 1e-8]),
           np.full((3, 3), np.nan), np.diag([5.0, 5.0, 5.0])]
    H = np.asarray(Hs, np.float32)
    m = MatcherParams()
    ref = np.asarray(jax.vmap(lambda h: jd2d.cov_from_hessian(h, m))(
        jnp.asarray(H)))
    got = td2d.cov_from_hessian(torch.tensor(H),
                                interop.params_from_jax(m)).numpy()
    fin = np.isfinite(ref).all((1, 2))
    np.testing.assert_array_equal(np.isfinite(got).all((1, 2)), fin)
    assert not fin[5] and fin.sum() == len(Hs) - 1
    scale = np.abs(ref[fin]).max((1, 2), keepdims=True)
    np.testing.assert_allclose(got[fin] / scale, ref[fin] / scale, atol=1e-3)
    np.testing.assert_allclose(got[3], np.eye(3) * 0.6e6, rtol=1e-6)


# The link solve's order (csrc/pair_fgh.cu objective_partials at a lane's
# cluster size, which link_cluster sets by the lane's shape alone): a
# float32 numpy mirror of the window term's adds.  A lane's C blocks of
# eight warps take its source cells i = warp + t * (8 C) in groups of g =
# min(32, ceil(N / (8 C))) a warp; a group's (cell, window cell) pairs
# are laid flat, pair q = j K + k on lane q % 32 in ascending q; each
# lane adds its pairs in order, then the warp's shuffle tree, the
# block's warps in order, the cluster's blocks in rank order.  The
# per-pair terms are the plain version's (d2d_analytic._pair_fgh, float32
# on the CPU); only the order is the kernel's.  Tolerance against the
# plain twin (its sum over all pairs at once): f 1e-5, g and H 1e-4
# relative to the lane's largest entry, the two orders' rounding over
# ~3,000 float32 terms.
WARPS = 8      # csrc/pair_fgh.cu kObjectiveThreads / 32


def _pair_terms(d, T0, src, packed, origins, offs):
    """Per-pair (B, N, K, 10) terms (s, g0..g2, h00 h01 h02 h11 h12 h22)
    of the window term and their mask (B, N, K), the plain version's."""
    moved, iy0, ix0 = tda.window_cells(d, T0, src, origins[:, None, :], RES)
    t_means, t_covs, t_valid = td2d.gather_windows_flat(
        packed, H_, W_, iy0, ix0, TM.n_neighbours, offs[:, None, None])
    mu = moved.means[..., :, None, :] - t_means
    Sig = moved.covs[..., :, None, :, :] + t_covs
    m_rot = (moved.means - d[..., None, :2])[..., :, None, :]
    s, g, H = tda._pair_fgh(mu, Sig, m_rot, moved.covs[..., :, None, :, :],
                            TM.lfd1, TM.lfd2)
    comps = torch.cat([s[..., None], g, H[..., [0, 0, 0, 1, 1, 2],
                                         [0, 1, 2, 1, 2, 2]]], -1)
    ok = t_valid & moved.mask[..., None]
    return comps.numpy(), ok.numpy()


def _lane_order_sum(comps, ok, cluster):
    """The 10 sums of one lane (comps (N, K, 10), ok (N, K)) in the
    link solve's order at `cluster` blocks."""
    n, k = ok.shape
    n_warps = cluster * WARPS
    g = min(32, -(-n // n_warps))
    f32 = np.float32
    blocks = []
    for rank in range(cluster):
        warp_sums = []
        for lw in range(WARPS):
            w = rank * WARPS + lw
            lanes = np.zeros((32, 10), f32)
            t0 = 0
            while w + t0 * n_warps < n:
                for q in range(g * k):
                    j, kk = divmod(q, k)
                    i = w + (t0 + j) * n_warps
                    if j < g and i < n and ok[i, kk]:
                        lanes[q % 32] = lanes[q % 32] + comps[i, kk]
                t0 += g
            for off in (16, 8, 4, 2, 1):
                lanes[:off] = lanes[:off] + lanes[off:2 * off]
            warp_sums.append(lanes[0])
        acc = np.zeros(10, f32)
        for x in warp_sums:
            acc = acc + x
        blocks.append(acc)
    total = np.zeros(10, f32)
    for x in blocks:
        total = total + x
    return total


def _order_lanes(n_lanes):
    """n_lanes lanes of the bank's link inputs (the test bank's lanes
    repeated), as numpy terms."""
    d, T0, src, origins, offs = _lanes()
    idx = np.arange(n_lanes) % d.shape[0]
    packed = np.asarray(_bank()[0].target.packed).reshape(-1, 8)
    return _pair_terms(torch.tensor(d[idx]), torch.tensor(T0[idx]),
                       CellList(*(torch.tensor(x[idx]) for x in src)),
                       torch.tensor(packed), torch.tensor(origins[idx]),
                       torch.tensor(offs[idx]))


@pytest.mark.parametrize("n_lanes", [1, 4, 171])
def test_link_order_is_a_function_of_the_lane_shape(n_lanes):
    """At 1, 4 and 171 lanes each lane's blocks and summation order are
    those of link_cluster at its shape: the mirror's sums of lane k in
    the batch equal lane k's alone bit for bit, whatever the batch; the
    per-trial rule the link solve left (blocks = the card's resident
    blocks // lanes, 396 on the H100) gave lanes of the 171-lane batch
    other blocks, and other bits, than a lane alone."""
    comps, ok = _order_lanes(n_lanes)
    n_src = ok.shape[1]
    cluster = cuda_kernels.link_cluster(n_src, 0, 8)
    assert cluster == min(8, -(-n_src // WARPS))
    old_rule = max(1, min(cluster, 396 // n_lanes))
    alone = _order_lanes(1)
    want = _lane_order_sum(alone[0][0], alone[1][0], cluster)
    got = _lane_order_sum(comps[0], ok[0], cluster)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    if n_lanes == 171:
        assert old_rule == 2
        assert not np.array_equal(
            _lane_order_sum(comps[0], ok[0], old_rule).view(np.uint32),
            want.view(np.uint32))


@pytest.mark.parametrize("cluster", [1, 2, 8])
def test_link_order_mirror_matches_the_plain_twin(cluster):
    """The mirror's sums at 1, 2 and 8 blocks against
    fgh_dense_flat_batch's plain twin on every lane of the bank, within
    the stated tolerance."""
    d, T0, src, origins, offs = _lanes()
    packed = torch.tensor(np.asarray(_bank()[0].target.packed).reshape(
        -1, 8))
    tsrc = CellList(*(torch.tensor(x) for x in src))
    f, g, H = cuda_kernels.fgh_dense_flat_batch(
        torch.tensor(d), torch.tensor(T0), tsrc, packed,
        torch.tensor(origins), torch.tensor(offs), H_, W_, RES,
        TM.n_neighbours, TM.lfd1, TM.lfd2)
    comps, ok = _pair_terms(torch.tensor(d), torch.tensor(T0), tsrc, packed,
                            torch.tensor(origins), torch.tensor(offs))
    for b in range(d.shape[0]):
        got = _lane_order_sum(comps[b], ok[b], cluster)
        want = np.concatenate([[float(f[b])], g[b].numpy(),
                               H[b].numpy()[[0, 0, 0, 1, 1, 2],
                                            [0, 1, 2, 1, 2, 2]]])
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
        scale = max(float(np.abs(want[1:]).max()), 1e-6)
        np.testing.assert_allclose(got[1:] / scale, want[1:] / scale,
                                   atol=1e-4)


# Distributed shared memory (cluster.map_shared_rank) may be touched only
# once every block of the cluster has started, which a kernel knows after
# its first cluster barrier: cluster.sync(), or the wait of a split
# barrier whose arrive comes at the kernel's entry.  A textual check of
# each kernel of csrc/: its first access, directly or through a device
# function that accesses before a barrier of its own, comes after its
# first barrier, and every split arrive has its wait.
_CSRC = pathlib.Path(cuda_kernels.__file__).resolve().parents[1] / "csrc"
_BARRIER = re.compile(r"\.sync\(\)|barrier\.cluster\.wait")
_FUNC = re.compile(r"(__global__|__device__)[^;{}]*?\b(?!__launch_bounds__)"
                   r"(\w+)\s*\([^;{}]*\)[^;{}]*\{")


def _functions(text):
    """{name: (is_kernel, body)} of the __global__ / __device__ functions
    defined in `text` (comments removed)."""
    out = {}
    for m in _FUNC.finditer(text):
        depth, i = 1, m.end()
        while depth:
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            i += 1
        out[m.group(2)] = (m.group(1) == "__global__", text[m.end():i])
    return out


def _first(pattern, body):
    m = re.search(pattern, body)
    return m.start() if m else len(body)


@pytest.mark.parametrize("source", sorted(p.name for p in _CSRC.glob("*.cu")))
def test_cluster_kernels_touch_peers_only_after_a_barrier(source):
    text = (_CSRC / source).read_text()
    text = re.sub(r"//[^\n]*|/\*.*?\*/", "", text, flags=re.S)
    funcs = _functions(text)
    early = {"map_shared_rank"}
    changed = True
    while changed:
        changed = False
        for name, (_, body) in funcs.items():
            access = _first(r"\b(%s)\b" % "|".join(early), body)
            if name not in early and access < _first(_BARRIER, body):
                early.add(name)
                changed = True
    kernels = {n: b for n, (k, b) in funcs.items() if k}
    assert kernels
    for name, body in kernels.items():
        assert name not in early, name
        arrives = len(re.findall(r"barrier\.cluster\.arrive", body))
        waits = len(re.findall(r"barrier\.cluster\.wait", body))
        assert (arrives == 0) == (waits == 0), name
