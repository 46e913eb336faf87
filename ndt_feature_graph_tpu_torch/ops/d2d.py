"""NDT distribution-to-distribution registration core (port of
ndt_feature_graph_tpu/ops/d2d.py: the packed registration table, the
flat window gather, the damped-Newton minimizer, plain D2D
registration with its covariance: match_d2d, covariance_d2d, the dense
target that localization and P2D registration read, and the score-only
functions: pair_score, d2d_score_dense[_flat], d2d_score_paired,
mahalanobis_score).

The registration target is the (H*W, 8) channel-packed table
[mean_x, mean_y, c00, c01, c11, valid, 0, 0] — one 32-byte row per
cell, read as two float4 loads by the CUDA kernel.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ndt_feature_graph_tpu_torch.config import MatcherParams, NDTMapParams
from ndt_feature_graph_tpu_torch.core import se2
from ndt_feature_graph_tpu_torch.ops import ndt_map


@dataclasses.dataclass
class PackedTarget:
    """Registration target: grid origin + the (H*W, 8) packed table."""

    origin: torch.Tensor   # (2,)
    packed: torch.Tensor   # (H * W, 8)


@dataclasses.dataclass
class DenseTarget:
    """Finalized target fields as dense grids beside the packed table
    (MCL's `weight` and the scan-pose monitor read the grids)."""

    origin: torch.Tensor   # (2,)
    means: torch.Tensor    # (H, W, 2)
    covs: torch.Tensor     # (H, W, 2, 2)
    valid: torch.Tensor    # (H, W) bool
    packed: torch.Tensor   # (H * W, 8)


def unpack_fields(packed, h: int, w: int):
    """Inverse of _pack_fields: (means (H,W,2), covs (H,W,2,2),
    valid (H,W)) sliced out of the packed channels."""
    g = packed.reshape(h, w, 8)
    c00, c01, c11 = g[..., 2], g[..., 3], g[..., 4]
    covs = torch.stack([torch.stack([c00, c01], -1),
                        torch.stack([c01, c11], -1)], -2)
    return g[..., 0:2], covs, g[..., 5] > 0.5


def dense_from_packed(pt: PackedTarget, h: int, w: int) -> DenseTarget:
    """The DenseTarget view of a PackedTarget."""
    means, covs, valid = unpack_fields(pt.packed, h, w)
    return DenseTarget(pt.origin, means, covs, valid, pt.packed)


def _pack_fields(means, covs, valid):
    """(H, W) fields -> the (H*W, 8) packed table."""
    return pack_rows(means, covs, valid).flatten(0, 1)


def make_dense_target(grid: ndt_map.NDTGrid,
                      params: NDTMapParams) -> DenseTarget:
    means, covs, valid = ndt_map.finalize(grid, params)
    return DenseTarget(grid.origin, means, covs, valid,
                       _pack_fields(means, covs, valid))


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


_EMPTY_ROW = {}       # device -> the packed row of an empty cell


def empty_pack_row(device):
    """The packed row of a never-observed cell (what finalize_stats gives
    zero statistics): the fill of ndt_map.recenter_with_aux.  Made once
    per device, so a scan makes no host-to-device copy."""
    device = torch.device(device)
    row = _EMPTY_ROW.get(device)
    if row is None:
        row = torch.tensor([0.0, 0.0, 1e-3, 0.0, 1e-3, 0.0, 0.0, 0.0],
                           dtype=torch.float32, device=device)
        _EMPTY_ROW[device] = row
    return row


def packed_from_grid(grid: ndt_map.NDTGrid, params: NDTMapParams):
    """Full (..., H*W, 8) packed table from a grid (a stack of grids)."""
    mean, cov, valid = ndt_map.finalize(grid, params)
    return pack_rows(mean, cov, valid).flatten(-3, -2)


def refresh_packed(packed, grid: ndt_map.NDTGrid, params: NDTMapParams,
                   flat_idx):
    """Re-finalize only the packed rows of the cells a scan touched
    (`flat_idx` (..., P) from add_points_touched, sentinel h*w for
    dropped points; leading dims index a stack of grids and tables).
    The sentinel is clamped onto cell h*w-1, whose row is then rewritten
    with its own current value — exact, no extra buffer.  Duplicate
    indices write identical rows."""
    h, w = params.grid_h, params.grid_w
    fi = flat_idx.clamp(max=h * w - 1)
    mean, cov, valid = ndt_map.finalize_stats(
        *ndt_map._stats_at(grid, fi), params)
    rows = (fi + ndt_map._stream_offsets(fi.shape[:-1], h * w,
                                         fi.device)).reshape(-1)
    return packed.reshape(-1, 8).index_copy(
        0, rows, pack_rows(mean, cov, valid).reshape(-1, 8)
    ).reshape(packed.shape)


def bf16_rows(rows, cx, cy):
    """Packed rows (..., 8) as the reference's bfloat16 table holds
    them: the two mean channels made relative to the cell's world centre
    (cx, cy), all 8 channels rounded to bfloat16 (to nearest even), and
    the centre added back in float32."""
    rel = torch.cat([(rows[..., 0] - cx)[..., None],
                     (rows[..., 1] - cy)[..., None], rows[..., 2:]], -1)
    q = rel.to(torch.bfloat16).to(torch.float32)
    return torch.cat([(q[..., 0] + cx)[..., None],
                      (q[..., 1] + cy)[..., None], q[..., 2:]], -1)


def gather_windows_flat(packed_flat, h: int, w: int, iy0, ix0, n: int,
                        row_offset=0, bf16_cells=None):
    """Window gather against a flat packed table.  Returns (t_means
    (..., K, 2), t_covs (..., K, 2, 2), t_valid (..., K)), K = (2n+1)^2;
    a window cell off the grid is clamped for the read and masked.  The
    window is dy-major (k = (dy+n)*(2n+1) + dx+n), as in the reference's
    gather and the kernel.  `bf16_cells` = (origin broadcastable to
    (..., 2), resolution) switches the bfloat16 row mode on (bf16_rows):
    a cell's centre is origin + (cell index + 0.5) * resolution."""
    offs = torch.arange(-n, n + 1, device=iy0.device)
    dy, dx = offs.repeat_interleave(2 * n + 1), offs.repeat(2 * n + 1)
    iy = iy0[..., None] + dy
    ix = ix0[..., None] + dx
    inb = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    iyc, ixc = iy.clamp(0, h - 1), ix.clamp(0, w - 1)
    rows = packed_flat[row_offset + (iyc * w + ixc)]
    if bf16_cells is not None:
        origin, res = bf16_cells
        rows = bf16_rows(
            rows,
            origin[..., 0, None] + (ixc.to(torch.float32) + 0.5) * res,
            origin[..., 1, None] + (iyc.to(torch.float32) + 0.5) * res)
    c00, c01, c11 = rows[..., 2], rows[..., 3], rows[..., 4]
    t_covs = torch.stack(
        [torch.stack([c00, c01], -1), torch.stack([c01, c11], -1)], -2
    )
    return rows[..., 0:2], t_covs, (rows[..., 5] > 0.5) & inb


def _apply_increment(d, T0):
    """Left global-frame increment: T = Trans(dx,dy) Rot(dtheta) ∘ T0."""
    return se2.compose(d, T0)


def gather_windows(tgt: DenseTarget, iy0, ix0, n: int):
    """Each source cell's (2n+1)^2 target window rows, in one gather of
    the dense target's packed table (gather_windows_flat)."""
    h, w = tgt.valid.shape
    return gather_windows_flat(tgt.packed, h, w, iy0, ix0, n)


def pair_score(mu_d, cov_sum, lfd1, lfd2):
    """Gaussian-overlap score of one cell pair,
    -d1 * exp(-d2/2 * mu^T (Sigma1 + Sigma2)^{-1} mu) (the Magnusson 2009
    D2D cost); batched over leading dims, 2x2 inverse in closed form."""
    a = cov_sum[..., 0, 0]
    b = cov_sum[..., 0, 1]
    c = cov_sum[..., 1, 1]
    det = a * c - b * b
    inv_det = 1.0 / torch.clamp(det, min=1e-12)
    x, y = mu_d[..., 0], mu_d[..., 1]
    mahal = (c * x * x - 2.0 * b * x * y + a * y * y) * inv_det
    return -lfd1 * torch.exp(-0.5 * lfd2 * mahal)


def _window_score(moved: ndt_map.CellList, t_means, t_covs, t_valid,
                  m: MatcherParams):
    mu_d = moved.means[:, None, :] - t_means
    cov_sum = moved.covs[:, None, :, :] + t_covs
    s = pair_score(mu_d, cov_sum, m.lfd1, m.lfd2)
    ok = t_valid & moved.mask[:, None]
    return torch.where(ok, s, 0.0).sum()


def d2d_score_dense(d, T0, src: ndt_map.CellList, tgt: DenseTarget,
                    map_params: NDTMapParams, m: MatcherParams):
    """Total D2D score of the source cell list against the dense target
    under pose `_apply_increment(d, T0)`."""
    from ndt_feature_graph_tpu_torch.ops import d2d_analytic

    moved, iy0, ix0 = d2d_analytic.window_cells(d, T0, src, tgt.origin,
                                                map_params.resolution)
    return _window_score(
        moved, *gather_windows(tgt, iy0, ix0, m.n_neighbours), m)


def d2d_score_dense_flat(d, T0, src: ndt_map.CellList, packed_flat, origin,
                         row_offset, h: int, w: int, resolution: float,
                         m: MatcherParams):
    """d2d_score_dense against a target selected by `row_offset` out of a
    flat packed table ((H*W, 8), or a stacked bank as (N*H*W, 8)): the
    score-only counterpart of d2d_analytic.fgh_dense_flat."""
    from ndt_feature_graph_tpu_torch.ops import d2d_analytic

    moved, iy0, ix0 = d2d_analytic.window_cells(d, T0, src, origin,
                                                resolution)
    return _window_score(moved, *gather_windows_flat(
        packed_flat, h, w, iy0, ix0, m.n_neighbours, row_offset), m)


def d2d_score_paired(d, T0, src: ndt_map.CellList, tgt: ndt_map.CellList,
                     m: MatcherParams):
    """Correspondence-restricted D2D (NDTMatcherFeatureD2D semantics):
    src[i] scores only against tgt[i]."""
    moved = src.transform(_apply_increment(d, T0))
    s = pair_score(moved.means - tgt.means, moved.covs + tgt.covs,
                   m.lfd1, m.lfd2)
    return torch.where(src.mask & tgt.mask, s, 0.0).sum()


def mahalanobis_score(d, Q):
    """Soft odometry constraint d^T Q d on the accumulated increment
    (computeScoreMahalanobis, fusion.h:25-28; no 1/2 factor)."""
    return d @ Q @ d


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


# The share of the largest shifted diagonal entry that a shift by
# `_psd_project(H, guard=True)` adds: four float32 ulps, which cover the
# rounding of the diagonal the shift is added to.
PSD_ROUNDING = 4 * 2.0 ** -23


def _psd_project(H, guard: bool = False):
    """Diagonal shift by the negative part of the smallest eigenvalue.

    As the reference takes it, the smallest eigenvalue of the float32
    result lies within rounding of zero, on either side; where it falls
    below minus the LM damping, the damped step climbs, the Armijo test
    accepts it (the step's slope is positive) and the score test stops
    the minimisation at once, at its start.  The reference does so too:
    its P2D registration from the canonical odometry stops at the start
    in 2 of 9 runs whose start moves by k * 1e-6.  `guard` makes the
    result PSD in float32: the eigenvalue is taken in float64 and a shift
    carries PSD_ROUNDING of the largest shifted diagonal entry."""
    if not guard:
        shift = torch.clamp(-_min_eig_sym3(H), min=0.0)
        return H + shift[..., None, None] * torch.eye(3, dtype=H.dtype,
                                                      device=H.device)
    f64 = torch.float64
    shift = torch.clamp(-_min_eig_sym3(H.to(f64)), min=0.0)
    diag = torch.diagonal(H, dim1=-2, dim2=-1).to(f64).abs().amax(-1)
    shift = torch.where(shift > 0, shift + PSD_ROUNDING * (diag + shift),
                        shift)
    return H + shift.to(H.dtype)[..., None, None] * torch.eye(
        3, dtype=H.dtype, device=H.device)


TRIAL_CHUNK = 6       # trials a chunk of newton_match_batch runs whole


def trial_budget(m: MatcherParams) -> int:
    """Trials a lane that never stops runs: 2*itr_max rounded up to
    whole chunks of TRIAL_CHUNK."""
    return TRIAL_CHUNK * -(-2 * m.itr_max // TRIAL_CHUNK)


def newton_match(fgh_fn, d_init, m: MatcherParams, psd_guard: bool = False):
    """Damped-Newton (Levenberg-Marquardt) minimizer over one 3-DoF
    increment: newton_match_batch with one lane.  `fgh_fn((3,)) -> (f,
    g (3,), H (3, 3))`.  Returns (d, score_best, trials, converged) as
    device tensors."""
    d, f, itr, stop = newton_match_batch(
        d_init[None], m,
        lambda d_b: tuple(x[None] for x in fgh_fn(d_b[0])), psd_guard)
    return d[0], f[0], itr[0], stop[0]


def newton_match_batch(d_init_b, m: MatcherParams, fgh_fn_batch,
                       psd_guard: bool = False):
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
    trial counts and `converged` are those of the whole budget).  For
    the same reason a lane may leave at its own stop:
    cuda_kernels.newton_solve[_batch], which runs this loop over the
    fuser's objective in one launch, gives the lockstep's result.

    `psd_guard` projects the Hessians with _psd_project's guard.

    Returns (d (B, 3), score (B,), trials (B,), converged (B,))."""
    b = d_init_b.shape[0]
    dev = d_init_b.device
    lam_min, lam_max = 1e-6, 1e7
    eye = torch.eye(3, dtype=torch.float32, device=dev)

    d = d_init_b.to(torch.float32)
    f, g, H = fgh_fn_batch(d)
    lam = torch.full((b,), 1e-3, dtype=torch.float32, device=dev)
    best_d, best_f = d, f
    itr = torch.zeros(b, dtype=torch.int32, device=dev)
    stop = torch.zeros(b, dtype=torch.bool, device=dev)

    for c in range(trial_budget(m) // TRIAL_CHUNK):
        if c and bool(stop.all()):
            break
        for _ in range(TRIAL_CHUNK):
            Hp = _psd_project(H, psd_guard)
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


@dataclasses.dataclass
class NewtonResult:
    d: torch.Tensor           # (3,) final increment
    T: torch.Tensor           # (3,) final pose (increment ∘ T0)
    score: torch.Tensor       # final (best) score
    iterations: torch.Tensor  # int32 trial count
    converged: torch.Tensor   # bool


def match_window(packed, origin, h: int, w: int, resolution: float,
                 src: ndt_map.CellList, T_init, m: MatcherParams,
                 psd_guard: bool = False) -> NewtonResult:
    """The damped-Newton registration of the cell list `src` from
    initial pose T_init against a packed (H*W, 8) table with grid
    origin `origin`, the window term alone: one `newton_solve` launch on
    CUDA tensors (newton_match over the term's plain version on the
    CPU).  `psd_guard` projects the Hessians with _psd_project's guard."""
    from ndt_feature_graph_tpu_torch.ops import cuda_kernels

    T_init = T_init.to(torch.float32)
    d, f, itr, conv = cuda_kernels.newton_solve(
        torch.zeros(3, dtype=torch.float32, device=T_init.device), T_init,
        src, packed, origin, h, w, resolution, m, psd_guard=psd_guard)
    return NewtonResult(d=d, T=_apply_increment(d, T_init), score=f,
                        iterations=itr, converged=conv)


def match_d2d(tgt: PackedTarget, src: ndt_map.CellList, T_init,
              map_params: NDTMapParams, m: MatcherParams) -> NewtonResult:
    """Plain D2D registration of the cell list `src` from initial pose
    T_init against the packed table of `tgt` (the reference's match_d2d
    on the DenseTarget of the same grid): the window term alone, one
    `newton_solve` launch on the card (match_window)."""
    return match_window(tgt.packed, tgt.origin, map_params.grid_h,
                        map_params.grid_w, map_params.resolution, src,
                        T_init, m)


def covariance_d2d(tgt: PackedTarget, src: ndt_map.CellList, T,
                   map_params: NDTMapParams, m: MatcherParams):
    """Pose covariance (3, 3) from the inverse Hessian of the D2D window
    cost at the estimate T (cov_from_hessian's convention): one
    `fgh_dense_flat` launch on CUDA tensors."""
    from ndt_feature_graph_tpu_torch.ops import cuda_kernels

    T = T.to(torch.float32)
    _, _, H = cuda_kernels.fgh_dense_flat(
        torch.zeros(3, dtype=torch.float32, device=T.device), T, src,
        tgt.packed, tgt.origin, map_params.grid_h, map_params.grid_w,
        map_params.resolution, m.n_neighbours, m.lfd1, m.lfd2)
    return cov_from_hessian(H, m)


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
