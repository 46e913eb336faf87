"""NDT distribution-to-distribution registration core (port of
ndt_feature_graph_tpu/ops/d2d.py: the packed registration table, the
flat window gather, and the damped-Newton minimizer).

The registration target is the (H*W, 8) channel-packed table
[mean_x, mean_y, c00, c01, c11, valid, 0, 0] — one 32-byte row per
cell, read as two float4 loads by the CUDA kernel.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ndt_feature_graph_tpu.config import MatcherParams, NDTMapParams
from ndt_feature_graph_tpu_torch.core import se2
from ndt_feature_graph_tpu_torch.ops import ndt_map


@dataclasses.dataclass
class PackedTarget:
    """Registration target: grid origin + the (H*W, 8) packed table."""

    origin: torch.Tensor   # (2,)
    packed: torch.Tensor   # (H * W, 8)


def pack_rows(mean, cov, valid):
    """Channel-pack per-cell fields with any leading shape into rows
    (..., 8)."""
    z = torch.zeros(valid.shape, dtype=torch.float32, device=valid.device)
    return torch.stack(
        [
            mean[..., 0], mean[..., 1],
            cov[..., 0, 0], cov[..., 0, 1], cov[..., 1, 1],
            valid.to(torch.float32), z, z,
        ],
        -1,
    )


def empty_pack_row(device=None):
    """The packed row of a never-observed cell (what finalize_stats gives
    zero statistics)."""
    return torch.tensor([0.0, 0.0, 1e-3, 0.0, 1e-3, 0.0, 0.0, 0.0],
                        dtype=torch.float32, device=device)


def packed_from_grid(grid: ndt_map.NDTGrid, params: NDTMapParams):
    """Full (H*W, 8) packed table from a grid."""
    mean, cov, valid = ndt_map.finalize(grid, params)
    return pack_rows(mean, cov, valid).reshape(-1, 8)


def refresh_packed(packed, grid: ndt_map.NDTGrid, params: NDTMapParams,
                   flat_idx):
    """Re-finalize only the packed rows of the cells a scan touched
    (`flat_idx` from add_points_touched, sentinel h*w for dropped
    points).  The sentinel is clamped onto cell h*w-1, whose row is then
    rewritten with its own current value — exact, no extra buffer.
    Duplicate indices write identical rows."""
    h, w = params.grid_h, params.grid_w
    fi = flat_idx.clamp(max=h * w - 1)
    n = grid.count.reshape(-1)[fi]
    ps = grid.psum.reshape(-1, 2)[fi]
    op = grid.outer.reshape(-1, 2, 2)[fi]
    mean, cov, valid = ndt_map.finalize_stats(n, ps, op, params)
    return packed.index_copy(0, fi, pack_rows(mean, cov, valid))


def gather_windows_flat(packed_flat, h: int, w: int, iy0, ix0, n: int,
                        row_offset=0):
    """Window gather against a flat packed table.  Returns (t_means
    (..., K, 2), t_covs (..., K, 2, 2), t_valid (..., K)), K = (2n+1)^2;
    a window cell off the grid is clamped for the read and masked.  The
    window is dy-major (k = (dy+n)*(2n+1) + dx+n), as in the reference's
    gather and the kernel."""
    offs = torch.arange(-n, n + 1, device=iy0.device)
    dy, dx = offs.repeat_interleave(2 * n + 1), offs.repeat(2 * n + 1)
    iy = iy0[..., None] + dy
    ix = ix0[..., None] + dx
    inb = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    flat = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
    rows = packed_flat[row_offset + flat]
    c00, c01, c11 = rows[..., 2], rows[..., 3], rows[..., 4]
    t_covs = torch.stack(
        [torch.stack([c00, c01], -1), torch.stack([c01, c11], -1)], -2
    )
    return rows[..., 0:2], t_covs, (rows[..., 5] > 0.5) & inb


def _apply_increment(d, T0):
    """Left global-frame increment: T = Trans(dx,dy) Rot(dtheta) ∘ T0."""
    return se2.compose(d, T0)


def _det3(B):
    return (
        B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2]
                        - B[..., 1, 2] * B[..., 2, 1])
        - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2]
                          - B[..., 1, 2] * B[..., 2, 0])
        + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1]
                          - B[..., 1, 1] * B[..., 2, 0])
    )


def _min_eig_sym3(H):
    """Smallest eigenvalue of a symmetric 3x3 matrix, closed form
    (trigonometric method; determinant by cofactors — no factorization,
    no device sync)."""
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    q = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1) / 3.0
    B = H - q[..., None, None] * eye
    p2 = (B * B).sum((-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    r = torch.clamp(_det3(B) / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    return torch.where(p2 < 1e-28, q, lam_min)


def _psd_project(H):
    """Diagonal shift by the negative part of the smallest eigenvalue."""
    shift = torch.clamp(-_min_eig_sym3(H), min=0.0)
    return H + shift[..., None, None] * torch.eye(3, dtype=H.dtype,
                                                  device=H.device)


def newton_match(fgh_fn, d_init, m: MatcherParams):
    """Damped-Newton (Levenberg-Marquardt) minimizer over one 3-DoF
    increment: newton_match_batch with one lane.  `fgh_fn((3,)) -> (f,
    g (3,), H (3, 3))`.  Returns (d, score_best, trials, converged) as
    device tensors."""
    d, f, itr, stop = newton_match_batch(
        d_init[None], m,
        lambda d_b: tuple(x[None] for x in fgh_fn(d_b[0])))
    return d[0], f[0], itr[0], stop[0]


def newton_match_batch(d_init_b, m: MatcherParams, fgh_fn_batch):
    """B independent damped-Newton (Levenberg-Marquardt) minimizations
    over 3-DoF increments, advancing in lockstep with per-lane masks —
    the reference's fixed-budget trial loop: 2*itr_max trials spent in
    chunks of 6 (a chunk always runs whole), one fgh evaluation per
    trial whose derivatives are reused as the next linearization on
    acceptance, masked updates once a lane's `stop` is set, and the
    best-score fallback.  `fgh_fn_batch((B, 3)) -> (f (B,), g (B, 3),
    H (B, 3, 3))` evaluates every lane in one call.

    Host sync: one read of `stop.all()` per 6-trial chunk; the remaining
    chunks are skipped once EVERY lane has stopped, as the reference's
    lax.cond does (a stopped lane's updates are masked, so results,
    trial counts and `converged` are those of the whole budget).

    Returns (d (B, 3), score (B,), trials (B,), converged (B,))."""
    b = d_init_b.shape[0]
    max_trials = 2 * m.itr_max
    dev = d_init_b.device
    lam_min, lam_max = 1e-6, 1e7
    eye = torch.eye(3, dtype=torch.float32, device=dev)

    d = d_init_b.to(torch.float32)
    f, g, H = fgh_fn_batch(d)
    lam = torch.full((b,), 1e-3, dtype=torch.float32, device=dev)
    best_d, best_f = d, f
    itr = torch.zeros(b, dtype=torch.int32, device=dev)
    stop = torch.zeros(b, dtype=torch.bool, device=dev)

    trial_chunk = 6
    n_chunks = -(-max_trials // trial_chunk)
    for c in range(n_chunks):
        if c and bool(stop.all()):
            break
        for _ in range(trial_chunk):
            Hp = _psd_project(H)
            grad_vanished = torch.linalg.vector_norm(g, dim=-1) <= (
                m.delta_score)
            delta = -torch.linalg.solve_ex(
                Hp + lam[:, None, None] * eye, g[..., None])[0][..., 0]
            f_new, g_new, H_new = fgh_fn_batch(d + delta)
            accept = (f_new <= f + 1e-4 * (delta * g).sum(-1)) & ~stop

            d_next = torch.where(accept[:, None], d + delta, d)
            f_next = torch.where(accept, f_new, f)
            g_next = torch.where(accept[:, None], g_new, g)
            H_next = torch.where(accept[:, None, None], H_new, H)
            if m.step_control:
                lam_new = torch.where(
                    accept, torch.clamp(lam * 0.33, min=lam_min), lam * 6.0
                )
                lam_new = torch.where(stop, lam, lam_new)
            else:
                lam_new = torch.full_like(lam, lam_min)

            better = f_next < best_f
            best_f = torch.where(better, f_next, best_f)
            best_d = torch.where(better[:, None], d_next, best_d)

            score_converged = accept & (f - f_new <= m.delta_score)
            stop_new = stop | grad_vanished | (lam_new > lam_max) | (
                score_converged
            )
            itr = torch.where(stop, itr, itr + 1)
            d, f, g, H, lam, stop = (
                d_next, f_next, g_next, H_next, lam_new, stop_new
            )

    use_best = f > best_f
    return (torch.where(use_best[:, None], best_d, d),
            torch.where(use_best, best_f, f), itr, stop)


def _jacobi_eigh3(H, sweeps: int = 6):
    """Eigen-decomposition of symmetric 3x3 matrices (..., 3, 3) by
    cyclic Jacobi rotations: (eigenvalues (..., 3), eigenvectors
    (..., 3, 3) as columns).  Elementwise tensor ops only, so a
    non-finite input comes out non-finite instead of raising, and the
    device is never synchronised (torch.linalg.eigh checks its
    convergence flag on the host)."""
    A = 0.5 * (H + H.transpose(-1, -2))
    V = torch.eye(3, dtype=H.dtype, device=H.device).expand(A.shape).clone()
    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            apq = A[..., p, q]
            app, aqq = A[..., p, p], A[..., q, q]
            small = apq.abs() <= 1e-30
            theta = (aqq - app) / (2.0 * torch.where(small, 1.0, apq))
            t = torch.sign(theta) / (theta.abs()
                                     + torch.sqrt(theta * theta + 1.0))
            t = torch.where(small, 0.0, torch.where(theta == 0, 1.0, t))
            c = 1.0 / torch.sqrt(t * t + 1.0)
            s = t * c
            J = torch.eye(3, dtype=H.dtype, device=H.device).expand(
                A.shape).clone()
            J[..., p, p] = c
            J[..., q, q] = c
            J[..., p, q] = s
            J[..., q, p] = -s
            A = J.transpose(-1, -2) @ A @ J
            V = V @ J
    return torch.diagonal(A, dim1=-2, dim2=-1), V


def cov_from_hessian(H, m: MatcherParams):
    """THE pose-covariance convention (reference d2d.cov_from_hessian):
    cov_scale * H^-1 with the Hessian eigenvalues floored at 1e-6,
    symmetrized.  Batched over leading dims; a non-finite Hessian (a
    degenerate pair) gives a non-finite covariance, which
    links.valid_links drops, without raising."""
    evals, evecs = _jacobi_eigh3(H)
    evals = torch.clamp(evals, min=1e-6)
    cov = (evecs / evals[..., None, :]) @ evecs.transpose(-1, -2)
    cov = 0.5 * (cov + cov.transpose(-1, -2))
    return m.cov_scale * cov
