"""6-DoF NDT D2D registration (port of ndt_feature_graph_tpu/ops/d2d3d.py):
the reference's vestigial 3D matcher surface.

3D gaussian cell lists, the Magnusson D2D cost under an SE(3) left
increment, a damped-Newton (LM) minimizer over the 6-vector and the
repo's one covariance convention lifted to 6x6.  Association is
list-vs-list: every (source, target) pair within a Euclidean cutoff.

Derivatives come from autodiff, as in the reference: torch.func.grad and
torch.func.jacfwd over it (forward-over-reverse).  So the score is
written functionally (no out=, no in-place op), or jacfwd fails or drops
tangents.  The Hessian carries 6 tangents through (N, M, 3, 3)
intermediates, so the pairs are taken PAIR_CHUNK at a time over source
rows and the chunks' (f, g, H) summed: the score is a sum over source
cells, so the split is exact up to the order of the sums.  No kernel
entry: the reference computes all of it outside its Pallas kernel.
"""

from __future__ import annotations

import dataclasses

import torch

from ndt_feature_graph_tpu_torch.config import MatcherParams
from ndt_feature_graph_tpu_torch.core import se3

# Source-target pairs per derivative evaluation: bounds the Hessian's
# (rows, M, 3, 3) x 6-tangent intermediates (3.4 GB at 2^20 on the H100;
# 2^18 took 0.9 GB and 4x the time, host-bound on dispatch:
# examples/profile_torch_port.py --sixdof).
PAIR_CHUNK = 1 << 20


@dataclasses.dataclass
class CellList3D:
    """Padded 3D gaussian list."""

    means: torch.Tensor   # (N, 3)
    covs: torch.Tensor    # (N, 3, 3)
    mask: torch.Tensor    # (N,) bool

    def transform(self, pose):
        return CellList3D(means=se3.transform_points(pose, self.means),
                          covs=se3.rotate_covs(pose, self.covs),
                          mask=self.mask)

    def rows(self, s: int, e: int):
        return CellList3D(self.means[s:e], self.covs[s:e], self.mask[s:e])


def _inv3(S):
    """Closed-form inverse of symmetric 3x3 (..., 3, 3) via the
    adjugate."""
    a, b, c = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    d, e = S[..., 1, 1], S[..., 1, 2]
    f = S[..., 2, 2]
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.clamp(det, min=1e-18)
    D = a * f - c * c
    E = b * c - a * e
    F = a * d - b * b
    rows = [torch.stack(r, -1) for r in ((A, B, C), (B, D, E), (C, E, F))]
    return torch.stack(rows, -2) * inv_det[..., None, None]


def d2d_score_3d(d, T0, src: CellList3D, tgt: CellList3D, m: MatcherParams,
                 cutoff: float = 2.0):
    """Total 6-DoF D2D score under the pose compose(d, T0): over (source
    cell, target cell) pairs within `cutoff` metres, the sum of
    -d1 exp(-d2/2 mu^T (Sig1 + Sig2)^-1 mu).  Differentiable in d (6,).

    The increment is applied DIRECTLY (Rodrigues on d's rotation vector
    acting on the T0-transformed cells), not through se3.compose, whose
    matrix log map has an unbounded derivative at the identity: autodiff
    through the untaken branch would put NaN into the derivatives at the
    starting point d = 0."""
    base = src.transform(T0)
    R = se3.rotmat(d[3:6])
    means = base.means @ R.T + d[0:3]
    covs = torch.einsum("ij,njk,lk->nil", R, base.covs, R)
    mu = means[:, None, :] - tgt.means[None, :, :]            # (N, M, 3)
    dist2 = (mu * mu).sum(-1)
    ok = (base.mask[:, None] & tgt.mask[None, :]
          & (dist2 <= cutoff * cutoff))
    A = _inv3(covs[:, None] + tgt.covs[None, :])
    # The quadratic form as an elementwise product and sum: as an einsum
    # it becomes batched 3x3 matmuls (cuBLAS gemv / gemm launches) under
    # torch.func, which took 80% of a registration's device time on the
    # H100 (examples/profile_torch_port.py --sixdof).
    q = (mu[..., :, None] * A * mu[..., None, :]).sum((-2, -1))
    s = -m.lfd1 * torch.exp(-0.5 * m.lfd2 * q)
    return torch.where(ok, s, 0.0).sum()


def fgh_of(score_fn):
    """d -> (f, g (6,), H (6, 6)) of a scalar function of the 6-vector,
    by torch.func: the gradient by reverse mode, the Hessian by forward
    mode over it."""
    def grad_aux(d):
        g, f = torch.func.grad_and_value(score_fn)(d)
        return g, (f, g)

    def fgh(d):
        H, (f, g) = torch.func.jacfwd(grad_aux, has_aux=True)(d)
        return f, g, H

    return fgh


def d2d_fgh_3d(d, T0, src: CellList3D, tgt: CellList3D, m: MatcherParams,
               cutoff: float = 2.0, mask6=None):
    """(f, g, H) of d2d_score_3d(d * mask6, ...) at d, summed over chunks
    of PAIR_CHUNK source-target pairs."""
    rows = max(1, PAIR_CHUNK // max(tgt.means.shape[0], 1))
    f = g = H = 0.0
    for s in range(0, src.means.shape[0], rows):
        part = src.rows(s, s + rows)

        def score(dd, part=part):
            if mask6 is not None:
                dd = dd * mask6
            return d2d_score_3d(dd, T0, part, tgt, m, cutoff)

        fc, gc, Hc = fgh_of(score)(d)
        f, g, H = f + fc, g + gc, H + Hc
    return f, g, H


def newton_match_6dof(fgh_fn, d_init, m: MatcherParams):
    """Damped-Newton (LM) minimizer over the 6-DoF increment, the 6-vector
    twin of d2d.newton_match: the reference's fixed budget of 2*itr_max
    trials in chunks of 6 (a chunk always runs whole), one fgh evaluation
    a trial whose derivatives are reused on acceptance, Armijo
    acceptance, damping x0.33 on accept and x6 on reject, masked updates
    once `stop` is set, and the best-score fallback.  Host sync: one read
    of `stop` per 6-trial chunk; the remaining chunks are skipped once it
    is set, as the reference's lax.cond skips them.  `fgh_fn((6,)) ->
    (f, g (6,), H (6, 6))`.  Returns (d, score, trials, converged) as
    device tensors."""
    max_trials = 2 * m.itr_max
    dev = d_init.device
    lam_min, lam_max = 1e-6, 1e7
    eye = torch.eye(6, dtype=torch.float32, device=dev)

    d = d_init.to(torch.float32)
    f, g, H = fgh_fn(d)
    lam = torch.tensor(1e-2, dtype=torch.float32, device=dev)
    best_d, best_f = d, f
    itr = torch.zeros((), dtype=torch.int32, device=dev)
    stop = torch.zeros((), dtype=torch.bool, device=dev)

    trial_chunk = 6
    n_chunks = -(-max_trials // trial_chunk)
    for c in range(n_chunks):
        if c and bool(stop):
            break
        for _ in range(trial_chunk):
            grad_vanished = torch.linalg.vector_norm(g) <= m.delta_score
            delta = -torch.linalg.solve_ex(H + lam * eye,
                                           g[:, None])[0][:, 0]
            f_new, g_new, H_new = fgh_fn(d + delta)
            accept = (f_new <= f + 1e-4 * (delta * g).sum()) & ~stop
            d_next = torch.where(accept, d + delta, d)
            f_next = torch.where(accept, f_new, f)
            g_next = torch.where(accept, g_new, g)
            H_next = torch.where(accept, H_new, H)
            lam_new = torch.where(accept, torch.clamp(lam * 0.33,
                                                      min=lam_min),
                                  lam * 6.0)
            lam_new = torch.where(stop, lam, lam_new)
            better = f_next < best_f
            best_f = torch.where(better, f_next, best_f)
            best_d = torch.where(better, d_next, best_d)
            score_converged = accept & (f - f_new <= m.delta_score)
            stop_new = (stop | grad_vanished | (lam_new > lam_max)
                        | score_converged)
            itr = torch.where(stop, itr, itr + 1)
            d, f, g, H, lam, stop = (d_next, f_next, g_next, H_next,
                                     lam_new, stop_new)
    use_best = f > best_f
    return (torch.where(use_best, best_d, d), torch.where(use_best, best_f, f),
            itr, stop)


@dataclasses.dataclass
class Match3DResult:
    d: torch.Tensor           # (6,) increment
    T: torch.Tensor           # (6,) final pose
    score: torch.Tensor
    iterations: torch.Tensor
    converged: torch.Tensor
    cov: torch.Tensor         # (6, 6) pose covariance


def match_d2d_3d(tgt: CellList3D, src: CellList3D, T_init, m: MatcherParams,
                 cutoff: float = 2.0, force2d: bool = False) -> Match3DResult:
    """Full 6-DoF D2D registration (NDTMatcherD2D::match in its native
    6-DoF form).  `force2d=True` is the reference's planar clamp: z, roll
    and pitch of the increment are projected out every trial, leaving the
    SE(2) subproblem inside the 6-DoF machinery.  The pose covariance is
    d2d.cov_from_hessian's convention lifted to 6x6: cov_scale times the
    inverse of the eigenvalue-floored Hessian, symmetrized."""
    dev = T_init.device
    T_init = T_init.to(torch.float32)
    mask6 = torch.tensor([1.0, 1.0, 0.0, 0.0, 0.0, 1.0] if force2d
                         else [1.0] * 6, dtype=torch.float32, device=dev)

    def fgh(d):
        return d2d_fgh_3d(d, T_init, src, tgt, m, cutoff, mask6)

    d, f, itr, conv = newton_match_6dof(
        fgh, torch.zeros(6, dtype=torch.float32, device=dev), m)
    d = d * mask6
    H = fgh(d)[2]
    if force2d:
        # Fix the projected-out axes so the floored inverse stays
        # well defined.
        H = H * mask6[:, None] * mask6[None, :] + torch.diag(
            (1.0 - mask6) * 1e6)
    evals, evecs = torch.linalg.eigh(0.5 * (H + H.T))
    evals = torch.clamp(evals, min=1e-6)
    cov = (evecs / evals[None, :]) @ evecs.T
    cov = m.cov_scale * 0.5 * (cov + cov.T)
    return Match3DResult(d=d, T=se3.compose(d, T_init), score=f,
                         iterations=itr, converged=conv, cov=cov)
