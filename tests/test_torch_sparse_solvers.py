"""Parity of the port's large-graph solvers with the JAX reference:
graph/sparse.py (edge blocks, PCG), graph/sparse_direct.py (segment
Schur) and graph/schur.py (blocked Schur), and the solver dispatch of
graph/slam.py, on graphs of at most 200 nodes made with numpy.

Tolerances: the host layouts (`make_segments`, `make_partition`) and the
compensated update `two_sum_update` are exact.  One linear solve on the
same EdgeBlocks: 1e-4 relative to the solution's largest entry where the
reference's own float32 solve lies within half of that of the float64
solution (both sides eliminate in float32 with their own 3x3 inverses
and LU).  Elsewhere the reference's error is larger — 7e-4 on the
two-lap chain (condition 3.8e6), 3.7e-4 for the chain-preconditioned PCG
on the random graph — so the port is held to the float64 solution,
within twice the reference's own error.  The
whole solvers: poses within 5e-4, chi2 within 1e-3 relative — the
reference's own tolerances against its dense solve
(tests/test_sparse_solver.py).
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_feature_graph_tpu.config import GraphParams as JGraphParams
from ndt_feature_graph_tpu.graph import optimize as jopt
from ndt_feature_graph_tpu.graph import schur as jschur
from ndt_feature_graph_tpu.graph import sparse as jsparse
from ndt_feature_graph_tpu.graph import sparse_direct as jsd
from ndt_feature_graph_tpu_torch import interop
from ndt_feature_graph_tpu_torch.config import GraphParams, SLAMParams
from ndt_feature_graph_tpu_torch.graph import node as node_mod
from ndt_feature_graph_tpu_torch.graph import schur as tschur
from ndt_feature_graph_tpu_torch.graph import sparse as tsparse
from ndt_feature_graph_tpu_torch.graph import sparse_direct as tsd
from ndt_feature_graph_tpu_torch.graph.slam import NDTFeatureGraphSLAM

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
POSE_ATOL, CHI2_RTOL, SOLVE_RTOL = 5e-4, 1e-3, 1e-4


def _rel(a, b):
    c, s = np.cos(a[2]), np.sin(a[2])
    dx, dy = b[0] - a[0], b[1] - a[1]
    t = b[2] - a[2]
    return np.array([c * dx + s * dy, -s * dx + c * dy,
                     np.arctan2(np.sin(t), np.cos(t))])


def _compose(a, r):
    c, s = np.cos(a[2]), np.sin(a[2])
    return np.array([a[0] + c * r[0] - s * r[1], a[1] + s * r[0] + c * r[1],
                     a[2] + r[2]])


def random_graph(n, n_loop, seed=0, pad=0):
    """A random odometry chain with short loop closures (the reference's
    tests/test_parallel.random_graph, drawn with numpy), its initial
    estimate 0.1 m / rad off the truth (node 0 exact); `pad` masked
    garbage edges to two phantom nodes appended after the graph."""
    rng = np.random.default_rng(seed)
    rels = np.concatenate([rng.uniform(-1, 1, (n - 1, 2)),
                           rng.uniform(-0.4, 0.4, (n - 1, 1))], -1)
    gt = [np.zeros(3)]
    for r in rels:
        gt.append(_compose(gt[-1], r))
    gt = np.stack(gt)
    li = rng.integers(0, n - 3, n_loop)
    lj = li + 2
    ei = np.concatenate([np.arange(n - 1), li])
    ej = np.concatenate([np.arange(1, n), lj])
    meas = np.concatenate([rels, [_rel(gt[a], gt[b]) for a, b in
                                  zip(li, lj)]])
    info = np.tile(np.eye(3)[None] * 50.0, (len(ei), 1, 1))
    init = gt + np.concatenate([np.zeros((1, 3)),
                                rng.normal(0, 0.1, (n - 1, 3))])
    mask = np.ones(len(ei), bool)
    if pad:
        init = np.concatenate([init, [[7.0, -3.0, 0.5], [1.0, 2.0, 3.0]]])
        ei = np.concatenate([ei, np.full(pad, n)])
        ej = np.concatenate([ej, np.full(pad, n + 1)])
        meas = np.concatenate([meas, np.full((pad, 3), 99.0)])
        info = np.concatenate([info, np.tile(np.eye(3)[None], (pad, 1, 1))])
        mask = np.concatenate([mask, np.zeros(pad, bool)])
    edges = dict(i=ei.astype(np.int32), j=ej.astype(np.int32),
                 meas=meas.astype(np.float32), info=info.astype(np.float32),
                 mask=mask)
    return gt.astype(np.float32), init.astype(np.float32), edges


def two_lap_graph(n, seed=7, every=20):
    """The reference's two-lap square (tests/test_sparse_solver.py
    _two_lap_slam_problem) with numpy noise: noisy odometry, clean
    lap-to-lap closures every `every` nodes, the drifted dead reckoning
    as the initial estimate."""
    rng = np.random.default_rng(seed)
    lap = n // 2
    side = lap // 4
    rels = []
    for _ in range(2):
        for _ in range(4):
            rels.extend([[1.0, 0.0, 0.0]] * (side - 1))
            rels.append([1.0, 0.0, np.pi / 2])
    rels = np.asarray(rels[: n - 1])
    gt = [np.zeros(3)]
    for r in rels:
        gt.append(_compose(gt[-1], r))
    gt = np.stack(gt)
    odo = rels + rng.normal(0, 1, rels.shape) * [0.005, 0.005, 0.0005]
    li = np.arange(0, lap, every)
    lj = li + lap
    ei = np.concatenate([np.arange(n - 1), li])
    ej = np.concatenate([np.arange(1, n), lj])
    meas = np.concatenate([odo, [_rel(gt[a], gt[b]) for a, b in
                                 zip(li, lj)]])
    info = np.concatenate([np.tile(np.eye(3)[None] * 50.0, (n - 1, 1, 1)),
                           np.tile(np.eye(3)[None] * 200.0, (len(li), 1, 1))])
    drifted = [np.zeros(3)]
    for r in odo:
        drifted.append(_compose(drifted[-1], r))
    edges = dict(i=ei.astype(np.int32), j=ej.astype(np.int32),
                 meas=meas.astype(np.float32), info=info.astype(np.float32),
                 mask=np.ones(len(ei), bool))
    return (gt.astype(np.float32), np.stack(drifted).astype(np.float32),
            edges)


GRAPHS = {
    "random32": lambda: random_graph(32, 12, seed=0),
    "padded16": lambda: random_graph(16, 4, seed=3, pad=5),
    "two_lap200": lambda: two_lap_graph(200, every=10),
}


def _both(init, e):
    je = jopt.EdgeList(**{k: jnp.asarray(v) for k, v in e.items()})
    return (jnp.asarray(init), je, torch.tensor(init),
            interop.edge_list_from_jax(dict(e, is_odom=None), "cpu"))


def _t(x):
    return torch.tensor(np.asarray(x))


def _rel_close(j, t, rtol):
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    scale = max(np.abs(j).max(), 1e-12)
    assert np.abs(j - t).max() <= rtol * scale, (np.abs(j - t).max(), scale)


@pytest.mark.parametrize("graph,seg", [("random32", 4), ("random32", 8),
                                       ("padded16", 6), ("two_lap200", 128),
                                       ("two_lap200", 3)])
def test_make_segments_equals_jax(graph, seg):
    _, init, e = GRAPHS[graph]()
    n = init.shape[0]
    _, je, _, te = _both(init, e)
    a = jsd.make_segments(n, je, max_seg_len=seg)
    b = tsd.make_segments(n, te, max_seg_len=seg)
    for name in a._fields:
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      getattr(b, name).numpy())
    assert int(b.seg_len.max()) <= seg


@pytest.mark.parametrize("graph,blocks", [("random32", 4), ("padded16", 3),
                                          ("two_lap200", 8)])
def test_make_partition_equals_jax(graph, blocks):
    _, init, e = GRAPHS[graph]()
    n = init.shape[0]
    _, je, _, te = _both(init, e)
    a = jschur.make_partition(n, je, blocks)
    b = tschur.make_partition(n, te, blocks)
    for name in ("assign", "sep_idx", "sep_mask", "int_idx", "int_mask"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      getattr(b, name).numpy())
    assert a.n_blocks == b.n_blocks


def test_two_sum_update_bit_exact():
    rng = np.random.default_rng(0)
    hi = (rng.uniform(-1, 1, 4096) * 10.0 ** rng.integers(-2, 4, 4096))
    hi = hi.astype(np.float32)
    lo = (rng.normal(0, 1, 4096) * np.abs(hi) * 1e-8).astype(np.float32)
    b = (rng.normal(0, 1, 4096) * 10.0 ** rng.integers(-6, 2, 4096))
    b = b.astype(np.float32)
    jh, jl = jsparse.two_sum_update(jnp.asarray(hi), jnp.asarray(lo),
                                    jnp.asarray(b))
    th, tl = tsparse.two_sum_update(_t(hi), _t(lo), _t(b))
    np.testing.assert_array_equal(np.asarray(jh), th.numpy())
    np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
    assert np.any(tl.numpy() != 0.0)


@pytest.mark.parametrize("robust", ["none", "dcs"])
def test_linearize_edges_matches_jax(robust):
    _, init, e = GRAPHS["two_lap200"]()
    jp, je, tp, te = _both(init, e)
    lo = (np.random.default_rng(1).normal(0, 1e-6, (init.shape[0], 2))
          .astype(np.float32))
    ja = jsparse.linearize_edges(jp, je, 100.0, 1e-2, jp[0],
                                 p_lo=jnp.asarray(lo), robust_kernel=robust)
    ta = tsparse.linearize_edges(tp, te, 100.0, torch.tensor(1e-2), tp[0],
                                 p_lo=_t(lo), robust_kernel=robust)
    for name in ja._fields:
        _rel_close(getattr(ja, name), getattr(ta, name), 1e-5)
    _rel_close(jsparse.edge_residual_hl(jp, jnp.asarray(lo), je),
               tsparse.edge_residual_hl(tp, _t(lo), te), 1e-5)


def _blocks(init, e):
    """The reference's EdgeBlocks at `init`, and the same on the port's
    side (converted, so that both solves see identical blocks)."""
    jp, je, _, te = _both(init, e)
    jb = jsparse.linearize_edges(jp, je, 100.0, 1e-6, jp[0],
                                 robust_kernel="dcs")
    tb = tsparse.EdgeBlocks(**{k: _t(getattr(jb, k)) for k in jb._fields})
    return je, jb, te, tb


def _solve64(tb, te):
    """The float64 dense solution of H x = b for the same blocks, and the
    condition number of H."""
    n = tb.D.shape[0]
    H = np.zeros((n, n, 3, 3))
    H[np.arange(n), np.arange(n)] = tb.D.double().numpy()
    Hij = tb.Hij.double().numpy()
    for e, (i, j) in enumerate(zip(te.i.numpy(), te.j.numpy())):
        if te.mask[e]:
            H[i, j] += Hij[e]
            H[j, i] += Hij[e].T
    Hd = H.transpose(0, 2, 1, 3).reshape(3 * n, 3 * n)
    x = np.linalg.solve(Hd, tb.b.double().numpy().reshape(-1))
    return x.reshape(n, 3), np.linalg.cond(Hd)


def _check_solve(x_j, x_t, tb, te):
    """A linear solve against JAX's on the same blocks: no further from
    the float64 solution than twice the reference's own float32 error (or
    SOLVE_RTOL), and within SOLVE_RTOL of JAX's wherever JAX's own error
    is below half of that."""
    x64, cond = _solve64(tb, te)
    x_j, x_t = np.asarray(x_j), x_t.numpy()
    scale = np.abs(x64).max()
    err_j = np.abs(x_j - x64).max() / scale
    err_t = np.abs(x_t - x64).max() / scale
    assert err_t <= max(2.0 * err_j, SOLVE_RTOL), (err_t, err_j, cond)
    if err_j < 0.5 * SOLVE_RTOL:
        _rel_close(x_j, x_t, SOLVE_RTOL)


@pytest.mark.parametrize("graph,seg", [("random32", 8), ("padded16", 6),
                                       ("two_lap200", 16)])
def test_solve_normal_equations_matches_jax(graph, seg):
    _, init, e = GRAPHS[graph]()
    n = init.shape[0]
    je, jb, te, tb = _blocks(init, e)
    x_j = jax.jit(lambda *a: jsd.solve_normal_equations(*a, n))(
        jb, je, jsd.make_segments(n, je, seg))
    x_t = tsd.solve_normal_equations(tb, te, tsd.make_segments(n, te, seg),
                                     n)
    _check_solve(x_j, x_t, tb, te)


@pytest.mark.parametrize("graph,prec", [("random32", "chain"),
                                        ("random32", "jacobi"),
                                        ("two_lap200", "jacobi")])
def test_pcg_matches_jax(graph, prec):
    _, init, e = GRAPHS[graph]()
    n = init.shape[0]
    je, jb, te, tb = _blocks(init, e)
    jpa, tpa = None, None
    if prec == "chain":
        jc = jsparse.chain_preconditioner(jb, je, n)
        tc = tsparse.chain_preconditioner(tb, te, n)
        _rel_close(jc.dtilde_inv, tc.dtilde_inv, 1e-4)
        _rel_close(jc.C, tc.C, 1e-5)
        r = np.random.default_rng(2).normal(0, 1, (n, 3)).astype(np.float32)
        _rel_close(jsparse.apply_chain_prec(jc, jnp.asarray(r)),
                   tsparse.apply_chain_prec(tc, _t(r)), 1e-4)

        def jpa(r):
            return jsparse.apply_chain_prec(jc, r)

        def tpa(r):
            return tsparse.apply_chain_prec(tc, r)
    x_j = jax.jit(lambda jb, je: jsparse.pcg(jb, je, jb.b, 150,
                                             prec_apply=jpa))(jb, je)
    x_t = tsparse.pcg(tb, te, tb.b, 150, prec_apply=tpa)
    if graph == "two_lap200":
        # 150 Jacobi iterations do not converge on a 200-node chain: the
        # iterates themselves must agree.
        _rel_close(x_j, x_t, SOLVE_RTOL)
    else:
        _check_solve(x_j, x_t, tb, te)
    _rel_close(jsparse.hvp(jb, je, x_j), tsparse.hvp(tb, te, _t(x_j)), 1e-5)


def _check_solution(jp, jchi, tp, tchi, n_real=None):
    jp, tp = np.asarray(jp), tp.numpy()
    np.testing.assert_allclose(tp, jp, atol=POSE_ATOL)
    if jchi is not None:
        np.testing.assert_allclose(float(tchi), float(jchi),
                                   rtol=CHI2_RTOL, atol=1e-6)
    assert np.isfinite(tp).all()


@pytest.mark.parametrize("graph,seg,robust", [
    ("random32", 8, "none"), ("random32", 8, "dcs"),
    ("padded16", 6, "huber"), ("two_lap200", 128, "none"),
    ("two_lap200", 16, "dcs"),
])
def test_optimize_direct_matches_jax(graph, seg, robust):
    gt, init, e = GRAPHS[graph]()
    n = init.shape[0]
    jp, je, tp, te = _both(init, e)
    its = 25
    ja = jsd.optimize_direct(jp, je, jsd.make_segments(n, je, seg),
                             iterations=its, robust_kernel=robust)
    ta = tsd.optimize_direct(tp, te, tsd.make_segments(n, te, seg),
                             iterations=its, robust_kernel=robust)
    _check_solution(*ja, *ta)
    if graph == "padded16":          # the phantom nodes do not move
        np.testing.assert_allclose(ta[0].numpy()[16:], init[16:], atol=1e-5)


@pytest.mark.parametrize("graph,prec", [("random32", "chain"),
                                        ("random32", "jacobi"),
                                        ("padded16", "chain")])
def test_optimize_pcg_matches_jax(graph, prec):
    gt, init, e = GRAPHS[graph]()
    jp, je, tp, te = _both(init, e)
    ja = jsparse.optimize_pcg(jp, je, iterations=15, cg_iterations=150,
                              preconditioner=prec)
    ta = tsparse.optimize_pcg(tp, te, iterations=15, cg_iterations=150,
                              preconditioner=prec)
    _check_solution(*ja, *ta)
    if graph == "padded16":
        np.testing.assert_allclose(ta[0].numpy()[16:], init[16:], atol=1e-6)


@pytest.mark.parametrize("graph,blocks", [("random32", 4), ("padded16", 3),
                                          ("two_lap200", 5)])
def test_optimize_schur_matches_jax(graph, blocks):
    _, init, e = GRAPHS[graph]()
    n = init.shape[0]
    jp, je, tp, te = _both(init, e)
    ja = jschur.optimize_schur(jp, je, jschur.make_partition(n, je, blocks),
                               iterations=15)
    ta = tschur.optimize_schur(tp, te, tschur.make_partition(n, te, blocks),
                               iterations=15)
    _check_solution(ja, None, ta, None)


@pytest.mark.parametrize("solver,dense_max", [("auto", 64), ("direct", 512),
                                              ("auto", 512)])
def test_solve_dispatch(solver, dense_max):
    """slam._solve: the segment-Schur branch under solver="direct" and
    under "auto" beyond solver_dense_max_nodes (200 nodes here), the
    dense solve otherwise — each against the JAX dispatch."""
    gt, init, e = GRAPHS["two_lap200"]()
    jp, je, tp, te = _both(init, e)
    kw = dict(solver=solver, solver_dense_max_nodes=dense_max,
              solver_max_seg_len=32, gn_iterations=12)
    jgp = JGraphParams(**kw)
    tgp = GraphParams(**kw)
    from ndt_feature_graph_tpu.graph.slam import NDTFeatureGraphSLAM as JSLAM
    from ndt_feature_graph_tpu.config import SLAMParams as JSLAMParams

    ja = JSLAM(JSLAMParams(graph=jgp))._solve(jgp, jp, je)
    ta = NDTFeatureGraphSLAM(SLAMParams(graph=tgp))._solve(tgp, tp, te)
    _check_solution(*ja, *ta)
    direct = solver == "direct" or init.shape[0] > dense_max
    if direct:
        ref = tsd.optimize_direct(
            tp, te, tsd.make_segments(200, te, 32), iterations=12,
            prior_information=tgp.prior_information, damping=tgp.gn_damping,
            robust_kernel=tgp.robust_kernel, robust_delta=tgp.robust_delta)
        np.testing.assert_array_equal(ta[0].numpy(), ref[0].numpy())


def test_grouped_proposals_match_jax_record():
    """_propose_links with link_group_nodes > 0 on the canonical
    loop-closure bank (canonical_lc.npz) against the JAX grouped record
    (canonical_solver.npz), over its first three chunks (20 pairs, more
    than one batch of 16, each chunk against its own sub-bank of at most
    8 nodes) with the chunks' replayed draws: phase 5a's link rules
    (chip_smoke.check_grouped)."""
    lc = dict(np.load(chip_smoke.LC_FIXTURE))
    sv = dict(np.load(chip_smoke.SOLVER_FIXTURE))
    sp = chip_smoke.canonical_slam_params(chip_smoke.OFFLINE_SPLIT_M, 64)
    sp = sp.replace(graph=sp.graph.replace(**chip_smoke.GROUPED_GRAPH))
    edges = zip(lc["off_edge_ij"][:, 0], lc["off_edge_ij"][:, 1],
                lc["off_edge_rel"], lc["off_edge_cov"])
    slam = interop.graph_from_jax(sp, interop.tree_from_flat(lc, "off_bank"),
                                  lc["off_node_T_before"], edges,
                                  device="cpu")
    n = int(sv["grp_chunk_start"][3])
    slam.pair_u = list(sv["grp_pair_u"][:3])
    bank = node_mod.stack_nodes(slam.nodes)
    ref, mov, mask = slam.candidate_pairs()
    ls = slam._propose_links(bank, ref[:n], mov[:n], mask[:n])
    assert slam.pair_u == []            # one draw per chunk
    moved, _ = chip_smoke.check_grouped(ls, sv, bank, sp, n)
    assert moved <= n // 2
