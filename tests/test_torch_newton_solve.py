"""The whole-registration entries `cuda_kernels.newton_solve` (one
stream) and `newton_solve_batch` (a fleet step) on the CPU, where they
are their plain twins: d2d.newton_match[_batch] over the objective
references, the arithmetic the CPU ran before the entries existed.

(a) On CPU tensors each entry equals its plain twin and the Newton loop
    over the objective reference bit for bit, with every term switched
    on and off and with step control on and off, and counts no launch.
(b) The CUDA kernel lets each lane leave at its own stop.  A plain loop
    with that control flow (each lane alone, from its first evaluation
    to its stop or the budget) equals the masked lockstep of
    d2d.newton_match_batch bit for bit on fleet lanes whose trial counts
    differ: once a lane stops, every update of the lockstep is a no-op.
(c) newton_solve against the reference's newton_match over the same
    terms: the pose within 2e-5, the score rtol 1e-5, the same trial
    count and convergence (tests/test_torch_d2d.py's real-cost
    tolerances).  newton_solve_batch against the reference's Newton of
    fuser.update_batch (d2d.newton_match_batch over its fgh_batch): the
    score rtol 1e-4 and the same convergence (tests/test_torch_fleet.py's
    one-step tolerances), the pose within 2e-4.  The pose is held
    looser than one stream's because the LM stop test (an accepted step
    that improves f by at most 1e-4, a few float32 ulps of |f|) fires
    at rounding noise: two of these six lanes stop 2-8 trials apart on
    the two sides and land up to 9e-5 apart (measured), as
    tests/test_torch_fleet.py's drivers note.
(d) A float32 numpy mirror of the kernel's LM step, written in the
    kernel's operation order, which is that of torch's eager operations
    on the card (each operation rounded on its own, sums of 3 and 9 in
    torch's CUDA order, a division by a Python scalar as a product with
    its reciprocal, the 3x3 solve by an LU with reciprocal multipliers
    and fused multiply-adds), against the first two trial points of
    d2d.newton_match_batch on random SPD and indefinite Hessians.
    Torch's CPU operations round otherwise (LAPACK's solve, vectorised
    sums), so the trial points are held to 1e-6 x cond(A) of their size,
    and the decisions (accept, λ) must agree.

The kernel itself runs on the card: tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_feature_graph_tpu.config import MatcherParams
from ndt_feature_graph_tpu.core import se2 as jse2
from ndt_feature_graph_tpu.fusion import feature_fuser as jff
from ndt_feature_graph_tpu.fusion import fuser as jfu
from ndt_feature_graph_tpu.io import dataset as jds
from ndt_feature_graph_tpu.ops import d2d as jd2d
from ndt_feature_graph_tpu.ops import d2d_analytic as jda
from ndt_feature_graph_tpu_torch import interop
from ndt_feature_graph_tpu_torch.ops import cuda_kernels
from ndt_feature_graph_tpu_torch.ops import d2d as td2d

from test_torch_fleet import P, P_BF16, H_, W_, RES, _np, _t, _tp
from test_torch_objective import (
    TERMS, _jax_objective, _port_args, _switches,
)

torch.set_num_threads(2)

B_FLEET = 6
T_STEPS = 2
POSE_ATOL, SCORE_RTOL = 2e-5, 1e-5
BATCH_POSE_ATOL, BATCH_SCORE_RTOL = 2e-4, 1e-4


def _lanes(p, window=True, features=True, odometry=True):
    """A fleet step of B_FLEET streams (tests/test_torch_fleet.py's
    fleet, with the odometry jittered by 2 cm x the stream's index so
    that the lanes need different numbers of trials): the port's
    arguments of newton_objective_batch, and the reference's fgh_batch
    over the same inputs as fuser.update_batch forms it (its bfloat16
    win-block table under P_BF16) with its matcher parameters."""
    traj = jds.corridor_trajectory(T_STEPS + 1, x0=-6.0, x1=-3.0, y=-4.5)
    seq = jds.simulate_sequence(jax.random.PRNGKey(0), traj, num_beams=360,
                                max_range=15.0)
    fst0 = jff.initialize(p, seq.gt[0], jnp.zeros(3), seq.ranges[0],
                          seq.hit[0], jax.random.PRNGKey(1))
    fst = jax.tree.map(lambda a: jnp.stack([a] * B_FLEET), fst0)
    Tm = seq.odom[1] + 2e-2 * jnp.arange(B_FLEET)[:, None] * jnp.asarray(
        [1.0, -0.5, 0.2])
    pts, mask, _, _, _, fsrc, ftgt, _ = jax.vmap(
        lambda st, tm: jff._prepare_features(st, p, tm, seq.ranges[1],
                                             seq.hit[1]))(fst, Tm)
    T0 = jax.vmap(jse2.compose)(fst.base.Tnow, Tm)
    src = jax.vmap(lambda sp, q, mk: jfu._build_local_cells(p, sp, q,
                                                            mk)[0])(
        fst.base.sensor_pose, pts, mask)
    Q = jax.vmap(lambda tm, tp: jfu._increment_information(p, tm, tp))(
        Tm, T0)
    packed = fst.base.packed.reshape(-1, 8)
    origins = fst.base.grid.origin
    offs = jnp.arange(B_FLEET) * (H_ * W_)
    m = p.matcher
    wc = p.gather_window_cells
    if p.gather_table_bf16:
        block, cell0 = jd2d.build_window_block_tables(
            fst.base.packed, origins, T0[:, :2], H_, W_, m.n_neighbours, wc,
            RES, bf16=True)
        block = block.reshape(-1, block.shape[-1])

    def fgh_batch(d):
        f = jnp.zeros(B_FLEET)
        g, H = jnp.zeros((B_FLEET, 3)), jnp.zeros((B_FLEET, 3, 3))
        if window and p.gather_table_bf16:
            a = jda.fgh_dense_block_batch(d, T0, src, block, cell0, origins,
                                          wc, RES, m, rel_means=True)
        elif window:
            a = jda.fgh_dense_flat_batch(d, T0, src, packed, origins, offs,
                                         H_, W_, RES, m)
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
    port = (_t(T0), cells(src) if window else None, _t(packed),
            _t(origins), torch.arange(B_FLEET) * (H_ * W_), H_, W_, RES,
            _tp(p).matcher, cells(fsrc) if features else None,
            cells(ftgt) if features else None, _t(Q) if odometry else None)
    return port, fgh_batch, m


_LANES = {}


def _fleet_lanes(rows, terms="all", step_control=True):
    key = (rows, terms, step_control)
    if key not in _LANES:
        p = P_BF16 if rows == "bf16" else P
        p = p.replace(matcher=p.matcher.replace(step_control=step_control))
        _LANES[key] = _lanes(p, *_switches(terms))
    return _LANES[key]


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("step_control", [True, False])
@pytest.mark.parametrize("terms", TERMS)
def test_newton_solve_on_cpu_is_the_plain_loop(terms, step_control):
    """(a), one stream: the entry, its plain twin and d2d.newton_match
    over newton_objective_reference give the same bits."""
    args = list(_port_args(*_switches(terms)))
    args[7] = args[7].replace(step_control=step_control)
    zero = torch.zeros(3)
    cuda_kernels.reset_launch_counts()
    got = cuda_kernels.newton_solve(zero, *args)
    assert set(cuda_kernels.LAUNCHES.values()) == {0}
    assert _same(got, cuda_kernels.newton_solve_reference(zero, *args))
    loop = td2d.newton_match(
        lambda d: cuda_kernels.newton_objective_reference(d, *args), zero,
        args[7])
    assert _same(got, loop)
    assert got[0].shape == (3,) and got[2].dtype == torch.int32
    assert got[3].dtype == torch.bool


@pytest.mark.parametrize("step_control", [True, False])
@pytest.mark.parametrize("terms", ["all", "no_window", "no_features",
                                   "no_odometry"])
@pytest.mark.parametrize("rows", ["f32", "bf16"])
def test_newton_solve_batch_on_cpu_is_the_lockstep(rows, terms,
                                                   step_control):
    """(a), a fleet step: the entry, its plain twin and the lockstep
    d2d.newton_match_batch over newton_objective_batch_reference give
    the same bits (bf16: the reference's bfloat16 row mode)."""
    port, _, _ = _fleet_lanes(rows, terms, step_control)
    args = (*port, rows == "bf16")
    zero = torch.zeros((B_FLEET, 3))
    cuda_kernels.reset_launch_counts()
    got = cuda_kernels.newton_solve_batch(zero, *args)
    assert set(cuda_kernels.LAUNCHES.values()) == {0}
    assert _same(got, cuda_kernels.newton_solve_batch_reference(zero, *args))
    loop = td2d.newton_match_batch(
        zero, port[8],
        lambda d: cuda_kernels.newton_objective_batch_reference(d, *args))
    assert _same(got, loop)
    assert got[0].shape == (B_FLEET, 3) and got[2].shape == (B_FLEET,)


def test_newton_solve_rejects_bad_arguments():
    args = _port_args(True, True, True)
    with pytest.raises(ValueError, match="go together"):
        cuda_kernels.newton_solve(torch.zeros(3), *args[:8], args[8], None)
    meta = torch.zeros(3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_kernels.newton_solve(meta, meta, None, None, None, H_, W_, RES,
                                  args[7])
    port, _, _ = _fleet_lanes("f32")
    with pytest.raises(ValueError, match="go together"):
        cuda_kernels.newton_solve_batch(torch.zeros((B_FLEET, 3)),
                                        *port[:9], port[9], None)
    meta = torch.zeros((B_FLEET, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_kernels.newton_solve_batch(meta, meta, None, None, None, None,
                                        H_, W_, RES, port[8])


def _per_lane_exit(d_init_b, m, fgh_batch):
    """The kernel's control flow in plain PyTorch: each lane alone, from
    its first evaluation until its own stop or the trial budget, then
    the best-score fallback.  The LM step is d2d.newton_match_batch's,
    written without the stop masks (a running lane has not stopped); it
    runs on B rows that all hold the lane's state, so every operation
    takes the path it takes in the lockstep, and the objective of row b
    is lane b's (the lanes' sums are independent)."""
    n = d_init_b.shape[0]
    eye = torch.eye(3)
    outs = []
    for b in range(n):
        def take(x, b=b):
            return x[b:b + 1].expand(n, *x.shape[1:]).contiguous()

        d = take(d_init_b)
        f, g, H = (take(x) for x in fgh_batch(d))
        lam = torch.full((n,), 1e-3)
        best_d, best_f = d, f
        itr = torch.zeros(n, dtype=torch.int32)
        stop = torch.zeros(n, dtype=torch.bool)
        trials = 0
        while not bool(stop[0]) and trials < td2d.trial_budget(m):
            Hp = td2d._psd_project(H)
            grad_vanished = torch.linalg.vector_norm(g, dim=-1) <= (
                m.delta_score)
            delta = -torch.linalg.solve_ex(
                Hp + lam[:, None, None] * eye, g[..., None])[0][..., 0]
            f_new, g_new, H_new = (take(x) for x in fgh_batch(d + delta))
            accept = f_new <= f + 1e-4 * (delta * g).sum(-1)
            d_next = torch.where(accept[:, None], d + delta, d)
            f_next = torch.where(accept, f_new, f)
            g_next = torch.where(accept[:, None], g_new, g)
            H_next = torch.where(accept[:, None, None], H_new, H)
            if m.step_control:
                lam_new = torch.where(
                    accept, torch.clamp(lam * 0.33, min=1e-6), lam * 6.0)
            else:
                lam_new = torch.full_like(lam, 1e-6)
            better = f_next < best_f
            best_f = torch.where(better, f_next, best_f)
            best_d = torch.where(better[:, None], d_next, best_d)
            stop = grad_vanished | (lam_new > 1e7) | (
                accept & (f - f_new <= m.delta_score))
            itr = itr + 1
            trials += 1
            d, f, g, H, lam = d_next, f_next, g_next, H_next, lam_new
        use_best = f > best_f
        outs.append((torch.where(use_best[:, None], best_d, d)[0],
                     torch.where(use_best, best_f, f)[0], itr[0], stop[0]))
    return tuple(torch.stack(x) for x in zip(*outs))


@pytest.mark.parametrize("step_control", [True, False])
@pytest.mark.parametrize("rows", ["f32", "bf16"])
def test_per_lane_exit_equals_the_lockstep(rows, step_control):
    """(b): lanes that leave at their own stop give the lockstep's bits,
    on lanes whose trial counts differ (with λ held at its floor, every
    lane of this step runs the whole budget)."""
    port, _, _ = _fleet_lanes(rows, "all", step_control)
    args = (*port, rows == "bf16")
    m = port[8]
    zero = torch.zeros((B_FLEET, 3))

    def fgh(d):
        return cuda_kernels.newton_objective_batch_reference(d, *args)

    lock = td2d.newton_match_batch(zero, m, fgh)
    exit_ = _per_lane_exit(zero, m, fgh)
    assert len(set(lock[2].tolist())) >= (2 if step_control else 1)
    assert _same(exit_, lock)


@pytest.mark.parametrize("step_control", [True, False])
@pytest.mark.parametrize("rows", ["f32", "bf16"])
def test_newton_solve_batch_matches_jax(rows, step_control):
    """(c): the fleet step's registrations against the reference's
    Newton of fuser.update_batch over the same inputs."""
    port, fgh_j, m = _fleet_lanes(rows, "all", step_control)
    dj, sj, ij, cj = jax.jit(lambda: jd2d.newton_match_batch(
        jnp.zeros((B_FLEET, 3)), m, fgh_j))()
    dt, st, it, ct = cuda_kernels.newton_solve_batch(
        torch.zeros((B_FLEET, 3)), *port, rows == "bf16")
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj),
                               atol=BATCH_POSE_ATOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj),
                               rtol=BATCH_SCORE_RTOL)


@pytest.mark.parametrize("step_control", [True, False])
def test_newton_solve_matches_jax(step_control):
    """(c), one stream: against the reference's newton_match over the
    window, paired and odometry terms (fusion/fuser.py:fgh_fn)."""
    args = list(_port_args(True, True, True))   # the case, made eagerly
    args[7] = args[7].replace(step_control=step_control)
    m = MatcherParams(step_control=step_control)
    dj, sj, ij, cj = jax.jit(lambda: jd2d.newton_match(
        None, jnp.zeros(3), m,
        lambda d: _jax_objective(d, True, True, True)))()
    dt, st, it, ct = cuda_kernels.newton_solve(torch.zeros(3), *args)
    assert int(it) == int(ij) and bool(ct) == bool(cj)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=POSE_ATOL)
    np.testing.assert_allclose(float(st), float(sj), rtol=SCORE_RTOL)


# ---- (d): the kernel's LM step, mirrored in float32 numpy -------------

F = np.float32


def _sum3(a, b, c, t=F):
    """csrc/pair_fgh.cu sum3: torch's CUDA order for three values."""
    return t(t(a + c) + b)


def _sum9(e, t=F):
    """csrc/pair_fgh.cu sum9: torch's CUDA order for nine values."""
    t0 = t(t(e[0] + e[8]) + e[4])
    return t(t(t0 + t(e[2] + e[6])) + t(t(e[1] + e[5]) + t(e[3] + e[7])))


def _min_eig_sym3(H):
    """csrc/pair_fgh.cu min_eig_sym3, operation by operation."""
    q = F(_sum3(H[0, 0], H[1, 1], H[2, 2]) * F(F(1) / F(3)))
    qz = F(q * F(0))
    B = np.empty((3, 3), F)
    for i in range(3):
        for j in range(3):
            B[i, j] = F(H[i, j] - (q if i == j else qz))
    flat = B.reshape(-1)
    p2 = F(_sum9([F(x * x) for x in flat]) * F(F(1) / F(6)))
    p = F(np.sqrt(max(p2, F(1e-30))))
    det = F(F(F(B[0, 0] * F(F(B[1, 1] * B[2, 2]) - F(B[1, 2] * B[2, 1])))
              - F(B[0, 1] * F(F(B[1, 0] * B[2, 2]) - F(B[1, 2] * B[2, 0]))))
            + F(B[0, 2] * F(F(B[1, 0] * B[2, 1]) - F(B[1, 1] * B[2, 0]))))
    r = F(min(max(F(det / F(F(F(F(2) * p) * p) * p)), F(-1)), F(1)))
    phi = F(F(np.arccos(r)) * F(F(1) / F(3)))
    lam_min = F(q + F(F(F(2) * p) * F(np.cos(F(phi + F(2.0943951023931953))))))
    return q if p2 < F(1e-28) else lam_min


def _min_eig_sym3_f64(H):
    """csrc/pair_fgh.cu min_eig_sym3_f64: min_eig_sym3 on H's float64
    copy, operation by operation."""
    D = np.float64
    H = H.astype(D)
    q = _sum3(H[0, 0], H[1, 1], H[2, 2], D) * D(1.0 / 3.0)
    B = H - np.diag([q, q, q]) - (1 - np.eye(3)) * D(q * 0.0)
    p2 = _sum9([x * x for x in B.reshape(-1)], D) * D(1.0 / 6.0)
    p = np.sqrt(max(p2, D(1e-30)))
    det = ((B[0, 0] * (B[1, 1] * B[2, 2] - B[1, 2] * B[2, 1])
            - B[0, 1] * (B[1, 0] * B[2, 2] - B[1, 2] * B[2, 0]))
           + B[0, 2] * (B[1, 0] * B[2, 1] - B[1, 1] * B[2, 0]))
    r = min(max(det / (((D(2) * p) * p) * p), D(-1)), D(1))
    phi = np.arccos(r) * D(1.0 / 3.0)
    lam_min = q + (D(2) * p) * np.cos(phi + D(2.0943951023931953))
    return q if p2 < D(1e-28) else lam_min


def _psd_shift(H, guard):
    """csrc/pair_fgh.cu psd_shift: the negative part of the smallest
    eigenvalue; with the guard in float64 plus td2d.PSD_ROUNDING of the
    largest shifted diagonal entry, rounded to float32."""
    if not guard:
        return max(F(-_min_eig_sym3(H)), F(0))
    shift = max(-_min_eig_sym3_f64(H), 0.0)
    diag = float(np.abs(np.diag(H).astype(np.float64)).max())
    if shift > 0:
        shift = shift + td2d.PSD_ROUNDING * (diag + shift)
    return F(shift)


def _fma(a, b, c):
    """a * b + c rounded once to float32 (through float64: the product
    is exact there, the sum is rounded twice, which changes the float32
    result only in rare ties)."""
    return F(np.float64(a) * np.float64(b) + np.float64(c))


def _lu_solve3(A, y):
    """csrc/pair_fgh.cu lu_solve3: getrf's pivoting, multipliers by the
    pivot's reciprocal, fused multiply-add updates, then getrs's two
    triangular solves column by column."""
    A = A.astype(F).copy()
    perm = [0, 1, 2]
    for k in range(3):
        piv = k
        for i in range(k + 1, 3):
            if abs(A[i, k]) > abs(A[piv, k]):
                piv = i
        A[[k, piv]] = A[[piv, k]]
        perm[k], perm[piv] = perm[piv], perm[k]
        rcp = F(F(1) / A[k, k])
        for i in range(k + 1, 3):
            A[i, k] = F(A[i, k] * rcp)
            for j in range(k + 1, 3):
                A[i, j] = _fma(-A[i, k], A[k, j], A[i, j])
    z = np.array([y[i] for i in perm], F)
    for j in range(3):
        for i in range(j + 1, 3):
            z[i] = _fma(-z[j], A[i, j], z[i])
    for j in (2, 1, 0):
        z[j] = F(z[j] / A[j, j])
        for i in range(j):
            z[i] = _fma(-z[j], A[i, j], z[i])
    return z


def _trial_point(d, g, H, lam, delta_score, guard=False):
    """The next trial point of the kernel's lm_step: (d + delta, delta,
    grad_vanished, A); `guard` projects as psd_guard does."""
    shift = _psd_shift(H, guard)
    A = np.empty((3, 3), F)
    for i in range(3):
        for j in range(3):
            diag = i == j
            A[i, j] = F(F(H[i, j] + (shift if diag else F(shift * F(0))))
                        + (lam if diag else F(lam * F(0))))
    gg = _sum3(F(g[0] * g[0]), F(g[1] * g[1]), F(g[2] * g[2]))
    delta = -_lu_solve3(A, g)
    return (np.array([F(d[i] + delta[i]) for i in range(3)], F), delta,
            bool(F(np.sqrt(gg)) <= F(delta_score)), A)


def _after_trial(f, g, delta, lam, f_new, step_control):
    """lm_step's accept and λ after a trial."""
    dg = _sum3(F(delta[0] * g[0]), F(delta[1] * g[1]), F(delta[2] * g[2]))
    accept = bool(f_new <= F(f + F(F(1e-4) * dg)))
    if not step_control:
        lam = F(1e-6)
    elif accept:
        lam = max(F(lam * F(0.33)), F(1e-6))
    else:
        lam = F(lam * F(6))
    return accept, lam


def _random_case(seed, kind):
    """A first evaluation (f, g, H) with a random Hessian (SPD, or with
    one negative eigenvalue), and a second whose f accepts or rejects
    the first step."""
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    ev = np.exp(rng.uniform(-2, 4, 3))
    if kind == "indefinite":
        ev[rng.integers(3)] *= -rng.uniform(0.05, 1.0)
    H = (U * ev) @ U.T
    H = (0.5 * (H + H.T)).astype(F)
    g = (rng.standard_normal(3) * 10.0 ** rng.uniform(-2, 1)).astype(F)
    H1 = H + (0.1 * rng.standard_normal((3, 3))).astype(F)
    H1 = (0.5 * (H1 + H1.T)).astype(F)
    g1 = (rng.standard_normal(3)).astype(F)
    return F(-10.0), g, H, g1, H1


@pytest.mark.parametrize("step_control", [True, False])
@pytest.mark.parametrize("outcome", ["accept", "reject"])
@pytest.mark.parametrize("kind", ["spd", "indefinite"])
@pytest.mark.parametrize("seed", range(4))
def test_lm_step_mirror_matches_newton_match_batch(seed, kind, outcome,
                                                   step_control):
    """(d): the mirror's first two trial points against those
    d2d.newton_match_batch evaluates, from the same evaluations."""
    f0, g0, H0, g1, H1 = _random_case(seed, kind)
    m = interop.params_from_jax(MatcherParams(step_control=step_control))
    p1, delta, gv, A = _trial_point(np.zeros(3, F), g0, H0, F(1e-3),
                                    m.delta_score)
    dg = float(np.dot(delta.astype(np.float64), g0.astype(np.float64)))
    f1 = F(f0 + 1e-4 * dg - 1.0) if outcome == "accept" else F(f0 + 1.0)
    seen = []

    def fgh(d):
        seen.append(d[0].numpy().copy())
        if len(seen) == 1:
            f, g, H = f0, g0, H0
        elif len(seen) == 2:
            f, g, H = f1, g1, H1
        else:                      # a point that every later trial rejects
            f, g, H = F(1e30), g1, H1
        return (torch.tensor([f]), torch.tensor(g)[None],
                torch.tensor(H)[None])

    td2d.newton_match_batch(torch.zeros((1, 3)), m, fgh)
    accept, lam = _after_trial(f0, g0, delta, F(1e-3), f1, step_control)
    assert accept == (outcome == "accept")
    d1 = p1 if accept else np.zeros(3, F)
    g, H = (g1, H1) if accept else (g0, H0)
    p2, _, _, A2 = _trial_point(d1, g, H, lam, m.delta_score)

    def tol(A_, x):
        return 1e-6 * np.linalg.cond(A_.astype(np.float64)) * np.abs(x).max()

    tol1 = tol(A, p1)
    np.testing.assert_allclose(seen[1], p1, rtol=0, atol=tol1)
    if not gv:                  # the lane went on to a second trial
        np.testing.assert_allclose(seen[2], p2, rtol=0,
                                   atol=tol1 + tol(A2, p2 - d1))


@pytest.mark.parametrize("kind", ["spd", "indefinite", "large"])
@pytest.mark.parametrize("seed", range(4))
def test_lm_step_mirror_with_the_guard_matches_newton_match_batch(seed,
                                                                  kind):
    """(d) with the guarded projection (P2D's, `psd_guard`): the mirror's
    first two trial points against those of d2d.newton_match_batch(...,
    psd_guard=True), from the same evaluations; "large" scales an
    indefinite Hessian to entries ~1e6, where the float32 eigenvalue's
    rounding exceeds the damping and the guard's float64 shift decides
    the step.  The guarded shift itself against d2d._psd_project's to
    one float32 ulp of the diagonal."""
    f0, g0, H0, g1, H1 = _random_case(seed, "spd" if kind == "spd"
                                      else "indefinite")
    if kind == "large":
        H0 = (H0 * F(1e6 / np.abs(H0).max())).astype(F)
    m = interop.params_from_jax(MatcherParams())
    got = td2d._psd_project(torch.tensor(H0)[None], guard=True)[0].numpy()
    shift = _psd_shift(H0, True)
    want = (H0 + shift * np.eye(3, dtype=F)).astype(F)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 ** -23 * np.abs(np.diag(H0)).max())
    p1, delta, gv, A = _trial_point(np.zeros(3, F), g0, H0, F(1e-3),
                                    m.delta_score, guard=True)
    assert np.linalg.eigvalsh(A.astype(np.float64))[0] > 0
    f1 = F(f0 - 1.0)
    seen = []

    def fgh(d):
        seen.append(d[0].numpy().copy())
        f, g, H = ((f0, g0, H0) if len(seen) == 1 else (f1, g1, H1)
                   if len(seen) == 2 else (F(1e30), g1, H1))
        return (torch.tensor([f]), torch.tensor(g)[None],
                torch.tensor(H)[None])

    td2d.newton_match_batch(torch.zeros((1, 3)), m, fgh, psd_guard=True)
    accept, lam = _after_trial(f0, g0, delta, F(1e-3), f1, True)
    d1 = p1 if accept else np.zeros(3, F)
    g, H = (g1, H1) if accept else (g0, H0)
    p2, _, _, A2 = _trial_point(d1, g, H, lam, m.delta_score, guard=True)

    def tol(A_, x):
        return 1e-6 * np.linalg.cond(A_.astype(np.float64)) * np.abs(x).max()

    tol1 = tol(A, p1)
    np.testing.assert_allclose(seen[1], p1, rtol=0, atol=tol1)
    if not gv:
        np.testing.assert_allclose(seen[2], p2, rtol=0,
                                   atol=tol1 + tol(A2, p2 - d1))
