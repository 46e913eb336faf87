"""Link refinement and the plain registrations as one launch each, on the
CPU, where the entries are their plain twins.

(a) links.refine_links_d2d (now `newton_solve_batch` with the Hessian at
    each lane's result), d2d.match_d2d and pairwise.match_p2d (now
    `newton_solve`, P2D with the guarded projection) give the bits of
    the per-trial loops they replace, frozen here as the port ran them:
    the lockstep d2d.newton_match_batch over the window term's plain
    version, then one more evaluation for the Hessian; d2d.newton_match
    over it, guarded for P2D.
(b) The solve's Hessian output is the objective's Hessian at the
    returned increment: a mirror of the kernel's bookkeeping (the H of
    the accepted increment and of the best one, picked by the
    best-score fallback as lm_finish picks the increment) against the
    plain twin's evaluation there, on refinement lanes and on a lane
    built so that the fallback fires (a step that climbs, accepted).
(c) The `row_sum` entry's plain twin is torch.sum.

The kernels themselves run on the card: tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from ndt_feature_graph_tpu_torch.config import MatcherParams
from ndt_feature_graph_tpu_torch.core import se2
from ndt_feature_graph_tpu_torch.graph import links as tl
from ndt_feature_graph_tpu_torch.ops import cuda_kernels
from ndt_feature_graph_tpu_torch.ops import d2d as td2d
from ndt_feature_graph_tpu_torch.ops import d2d_analytic as tda
from ndt_feature_graph_tpu_torch.ops.ndt_map import CellList
from ndt_feature_graph_tpu_torch.utils import pairwise as tpw

import test_torch_links as L
import test_torch_pairwise as PW

torch.set_num_threads(2)


def _window_fgh(T0, src, packed, origins, offs, h, w, res, m):
    """The window term's plain version as the per-trial entries ran it on
    the CPU (their MatcherParams carried n, lfd1, lfd2 alone)."""
    mp = MatcherParams(n_neighbours=m.n_neighbours, lfd1=m.lfd1, lfd2=m.lfd2)
    if offs is None:
        return lambda d: tda.fgh_dense_flat(d, T0, src, packed, origins, 0,
                                            h, w, res, mp)
    return lambda d: tda.fgh_dense_flat_batch(d, T0, src, packed, origins,
                                              offs, h, w, res, mp)


def _per_trial_refine(map_params, m, nodes, links, src_budget=0):
    """refine_links_d2d as the port ran it before it was one launch."""
    h, w = map_params.grid_h, map_params.grid_w
    nb = src_budget if src_budget > 0 else nodes.cells.means.shape[1]
    mov = links.mov
    src_b = CellList(means=nodes.cells.means[mov, :nb],
                     covs=nodes.cells.covs[mov, :nb],
                     mask=nodes.cells.mask[mov, :nb])
    T0 = links.T.contiguous()
    fgh = _window_fgh(T0, src_b, nodes.target.packed.reshape(-1, 8),
                      nodes.target.origin[links.ref],
                      links.ref.to(torch.int64) * (h * w), h, w,
                      map_params.resolution, m)
    d_b, _, _, conv = td2d.newton_match_batch(
        torch.zeros((links.ref.shape[0], 3)), m, fgh)
    return (se2.compose(d_b, T0), td2d.cov_from_hessian(fgh(d_b)[2], m),
            links.mask & conv)


def _bank_links():
    bank = L._tbank()
    pairs = L._bank()[1]
    mask = torch.ones(len(pairs), dtype=torch.bool)
    mask[3] = False
    ls = tl.compute_links_batch(L.TP.features, L.RES, bank,
                                torch.tensor(pairs[:, 0]),
                                torch.tensor(pairs[:, 1]), mask,
                                L._u(len(pairs)))
    return bank, ls


@pytest.mark.parametrize("budget", ["source_cell_budget", "capacity"])
def test_refine_links_d2d_on_cpu_is_the_per_trial_lockstep(budget):
    """(a): T, cov and mask bit for bit, at the exact source budget and at
    the lists' full capacity; no launch is counted."""
    bank, ls = _bank_links()
    nb = tl.source_cell_budget(bank) if budget == "source_cell_budget" else 0
    cuda_kernels.reset_launch_counts()
    got = tl.refine_links_d2d(L.TP.ndt, L.TM, bank, ls, src_budget=nb)
    assert not any(cuda_kernels.LAUNCHES.values())
    T, cov, mask = _per_trial_refine(L.TP.ndt, L.TM, bank, ls, nb)
    assert torch.equal(got.T, T) and torch.equal(got.mask, mask)
    assert torch.equal(torch.nan_to_num(got.cov, 7.0),
                       torch.nan_to_num(cov, 7.0))
    assert torch.equal(got.ref, ls.ref) and torch.equal(got.score, ls.score)


@pytest.mark.parametrize("src_k,off", [(3, (0.05, -0.04, 0.02)),
                                       (6, (-0.06, 0.05, -0.02))])
@pytest.mark.parametrize("kind", ["match_d2d", "match_p2d"])
def test_plain_registrations_on_cpu_are_the_per_trial_loop(kind, src_k, off):
    """(a): the pose, score, trials and convergence bit for bit (P2D with
    the guarded projection, match_d2d without), no launch counted."""
    _, tt = PW._target()
    pts, mask = (torch.tensor(x) for x in PW._points(src_k))
    T0 = torch.tensor(PW._pose(0, src_k, off))
    src = tpw.points_as_cells(pts, mask)
    h, w = tt.valid.shape
    cuda_kernels.reset_launch_counts()
    if kind == "match_p2d":
        got = tpw.match_p2d(tt, pts, mask, T0, PW.TMP, PW.TM)
    else:
        got = td2d.match_d2d(td2d.PackedTarget(tt.origin, tt.packed), src,
                             T0, PW.TMP, PW.TM)
    assert not any(cuda_kernels.LAUNCHES.values())
    fgh = _window_fgh(T0, src, tt.packed, tt.origin, None, h, w,
                      PW.TMP.resolution, PW.TM)
    d, f, itr, conv = td2d.newton_match(fgh, torch.zeros(3), PW.TM,
                                        psd_guard=kind == "match_p2d")
    for a, b in ((got.d, d), (got.score, f), (got.iterations, itr),
                 (got.converged, conv), (got.T, se2.compose(d, T0))):
        assert torch.equal(a, b)


def _lockstep_with_hessian(d_init_b, m, fgh_batch, psd_guard=False):
    """d2d.newton_match_batch with the solve kernel's Hessian
    bookkeeping: the H of the current increment (replaced on an accept)
    and of the best one (replaced with it), the fallback picking one as
    it picks the increment.  Returns (d, score, trials, converged, H,
    whether the fallback fired)."""
    b = d_init_b.shape[0]
    eye = torch.eye(3)
    d = d_init_b
    f, g, H = fgh_batch(d)
    lam = torch.full((b,), 1e-3)
    best_d, best_f, best_H = d, f, H
    itr = torch.zeros(b, dtype=torch.int32)
    stop = torch.zeros(b, dtype=torch.bool)
    for c in range(td2d.trial_budget(m) // td2d.TRIAL_CHUNK):
        if c and bool(stop.all()):
            break
        for _ in range(td2d.TRIAL_CHUNK):
            Hp = td2d._psd_project(H, psd_guard)
            grad_vanished = torch.linalg.vector_norm(g, dim=-1) <= (
                m.delta_score)
            delta = -torch.linalg.solve_ex(
                Hp + lam[:, None, None] * eye, g[..., None])[0][..., 0]
            f_new, g_new, H_new = fgh_batch(d + delta)
            accept = (f_new <= f + 1e-4 * (delta * g).sum(-1)) & ~stop
            d_next = torch.where(accept[:, None], d + delta, d)
            f_next = torch.where(accept, f_new, f)
            g_next = torch.where(accept[:, None], g_new, g)
            H_next = torch.where(accept[:, None, None], H_new, H)
            if m.step_control:
                lam_new = torch.where(
                    accept, torch.clamp(lam * 0.33, min=1e-6), lam * 6.0)
                lam_new = torch.where(stop, lam, lam_new)
            else:
                lam_new = torch.full_like(lam, 1e-6)
            better = f_next < best_f
            best_f = torch.where(better, f_next, best_f)
            best_d = torch.where(better[:, None], d_next, best_d)
            best_H = torch.where(better[:, None, None], H_next, best_H)
            stop_new = stop | grad_vanished | (lam_new > 1e7) | (
                accept & (f - f_new <= m.delta_score))
            itr = torch.where(stop, itr, itr + 1)
            d, f, g, H, lam, stop = (d_next, f_next, g_next, H_next,
                                     lam_new, stop_new)
    use_best = f > best_f
    return (torch.where(use_best[:, None], best_d, d),
            torch.where(use_best, best_f, f), itr, stop,
            torch.where(use_best[:, None, None], best_H, H), use_best)


def _climbing_lane():
    """A one-lane objective whose first step climbs and is accepted: a
    Hessian of entries ~1e7 with one negative eigenvalue, which the
    unguarded projection (its smallest eigenvalue rounded in float32)
    leaves indefinite beyond the damping, and a gradient along that
    direction, so the step's slope is positive; the trial's f rises by
    half the Armijo allowance, every later trial is rejected.  The
    objective is a table of its evaluation points (the start, the first
    trial point it is asked for, anything else), so the plain twin's
    evaluation at the returned increment reads the table too.  Returns
    (matcher params, a maker of a fresh objective)."""
    m = MatcherParams()
    for seed in range(400):
        rng = np.random.default_rng(seed)
        U, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        ev = np.array([-1.0, 2.0, 3.0]) * 1e7 * rng.uniform(0.5, 2.0, 3)
        H0 = torch.tensor(((U * ev) @ U.T).astype(np.float32))
        H0 = 0.5 * (H0 + H0.T)
        g0 = torch.tensor((U[:, 0] * 1e3).astype(np.float32))
        A = td2d._psd_project(H0[None])[0] + 1e-3 * torch.eye(3)
        delta = -torch.linalg.solve(A, g0)
        dg = float((delta * g0).sum())
        if dg > 0 and torch.isfinite(delta).all():
            break
    else:
        raise AssertionError("no climbing case among the seeds")
    f0 = torch.tensor(-10.0)
    f1 = f0 + 0.5e-4 * dg
    assert f1 > f0
    H1 = torch.diag(torch.tensor([4.0, 5.0, 6.0]))
    g1 = torch.tensor([0.5, -0.25, 0.125])

    def make():
        seen = []

        def fgh(d_b):
            fs, gs, Hs = [], [], []
            for d in d_b:
                if not d.any():
                    f, g, H = f0, g0, H0
                else:
                    if not seen:
                        seen.append(d.clone())
                    f, g, H = ((f1, g1, H1) if torch.equal(d, seen[0])
                               else (torch.tensor(1e30), g1, H1))
                fs.append(f)
                gs.append(g)
                Hs.append(H)
            return torch.stack(fs), torch.stack(gs), torch.stack(Hs)
        return fgh

    return m, make


@pytest.mark.parametrize("case", ["refinement_lanes", "fallback_fires"])
def test_solve_hessian_is_the_objective_at_the_result(case):
    """(b): the kernel's Hessian bookkeeping gives, lane by lane, the bits
    of the plain twin's evaluation at the returned increment, also where
    the best-score fallback returns an earlier increment."""
    if case == "refinement_lanes":
        bank, ls = _bank_links()
        h, w = L.TP.ndt.grid_h, L.TP.ndt.grid_w
        nb = tl.source_cell_budget(bank)
        mov = ls.mov
        src_b = CellList(*(x[mov, :nb] for x in (
            bank.cells.means, bank.cells.covs, bank.cells.mask)))
        args = (ls.T.contiguous(), src_b, bank.target.packed.reshape(-1, 8),
                bank.target.origin[ls.ref], ls.ref * (h * w), h, w, L.RES,
                L.TM)
        zero = torch.zeros((ls.ref.shape[0], 3))
        plain = cuda_kernels.newton_solve_batch_reference(
            zero, *args, with_hessian=True)
        assert all(torch.equal(a, b) for a, b in zip(
            plain, cuda_kernels.newton_solve_batch(zero, *args,
                                                   with_hessian=True)))
        mirror = _lockstep_with_hessian(
            zero, L.TM,
            lambda d: cuda_kernels.newton_objective_batch_reference(d, *args))
    else:
        m, make = _climbing_lane()
        zero = torch.zeros((1, 3))
        fgh = make()
        d, f, itr, conv = td2d.newton_match_batch(zero, m, fgh)
        plain = (d, f, itr, conv, fgh(d)[2])
        mirror = _lockstep_with_hessian(zero, m, make())
        assert bool(mirror[5].all())        # the fallback fired
    for a, b in zip(mirror[:5], plain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("guard", [False, True])
def test_newton_solve_on_cpu_takes_the_guard(guard):
    """newton_solve with `psd_guard` on the CPU is d2d.newton_match with
    the guard over the objective's plain version."""
    _, tt = PW._target()
    pts, mask = (torch.tensor(x) for x in PW._points(6))
    T0 = torch.tensor(PW._pose(0, 6, (-0.06, 0.05, -0.02)))
    src = tpw.points_as_cells(pts, mask)
    h, w = tt.valid.shape
    args = (T0, src, tt.packed, tt.origin, h, w, PW.TMP.resolution, PW.TM)
    got = cuda_kernels.newton_solve(torch.zeros(3), *args, psd_guard=guard)
    fgh = _window_fgh(T0, src, tt.packed, tt.origin, None, h, w,
                      PW.TMP.resolution, PW.TM)
    want = td2d.newton_match(fgh, torch.zeros(3), PW.TM, psd_guard=guard)
    assert len(got) == 4 and all(torch.equal(a, b)
                                 for a, b in zip(got, want))


@pytest.mark.parametrize("shape", [(1, 40000), (6, 1600), (2, 3, 7)])
def test_row_sum_on_cpu_is_torch_sum(shape):
    """(c): the overlap sum's entry on a CPU tensor is torch.sum over the
    last dim, bit for bit, and counts no launch; the eager overlap score
    (cuda_kernels.overlap_score_reference) sums through it."""
    x = torch.tensor(np.random.default_rng(0).random(shape, np.float32))
    cuda_kernels.reset_launch_counts()
    assert torch.equal(cuda_kernels.row_sum(x), x.sum(-1))
    assert not any(cuda_kernels.LAUNCHES.values())


def test_row_sum_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_kernels.row_sum(torch.zeros((2, 3), device="meta"))
