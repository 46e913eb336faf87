"""D2D registration: a frozen copy of the port's plain packed table,
window gather, analytic derivatives and the lockstep damped-Newton
solve over the joint objective (D2D window + paired features +
odometry)."""

from __future__ import annotations

import math
from typing import Optional

import torch

from port_bench.reference import ndt_map, se2
from port_bench.reference.config import MatcherParams, NDTMapParams
from port_bench.reference.ndt_map import CellList

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


TRIAL_CHUNK = 6       # trials a chunk of newton_match_batch runs whole


def trial_budget(m: MatcherParams) -> int:
    """Trials a lane that never stops runs: 2*itr_max rounded up to
    whole chunks of TRIAL_CHUNK."""
    return TRIAL_CHUNK * -(-2 * m.itr_max // TRIAL_CHUNK)


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



def _inv2(Sig):
    a = Sig[..., 0, 0]
    b = Sig[..., 0, 1]
    c = Sig[..., 1, 1]
    inv_det = 1.0 / torch.clamp(a * c - b * b, min=1e-12)
    return torch.stack(
        [
            torch.stack([c * inv_det, -b * inv_det], -1),
            torch.stack([-b * inv_det, a * inv_det], -1),
        ],
        -2,
    )


def _mv(A, v):
    return torch.einsum("...ij,...j->...i", A, v)


def _dot(a, b):
    return (a * b).sum(-1)


def _pair_fgh(mu, Sig, m_rot, Crot, lfd1, lfd2):
    """Per-pair (score, grad (3,), hess (3, 3)), batched over leading
    dims.  mu: (..., 2) mean difference; Sig: (..., 2, 2) summed
    covariance; m_rot: moved source mean minus d's translation; Crot:
    rotated source covariance."""
    A = _inv2(Sig)
    Amu = _mv(A, mu)
    q = _dot(mu, Amu)

    mu_t = torch.stack([-m_rot[..., 1], m_rot[..., 0]], -1)   # G (R m)
    mu_tt = -m_rot

    k00 = Crot[..., 0, 0]
    k01 = Crot[..., 0, 1]
    k11 = Crot[..., 1, 1]
    S = torch.stack(
        [
            torch.stack([-2.0 * k01, k00 - k11], -1),
            torch.stack([k00 - k11, 2.0 * k01], -1),
        ],
        -2,
    )
    GKG = torch.stack(
        [torch.stack([k11, -k01], -1), torch.stack([-k01, k00], -1)], -2
    )
    S2d = -2.0 * Crot + 2.0 * GKG

    ASA_mu = _mv(A, _mv(S, Amu))
    q_x = 2.0 * Amu[..., 0]
    q_y = 2.0 * Amu[..., 1]
    q_t = 2.0 * _dot(Amu, mu_t) - _dot(mu, ASA_mu)
    q_grad = torch.stack([q_x, q_y, q_t], -1)

    h_xx = 2.0 * A[..., 0, 0]
    h_xy = 2.0 * A[..., 0, 1]
    h_yy = 2.0 * A[..., 1, 1]
    A_mu_t = _mv(A, mu_t)
    h_xt = 2.0 * A_mu_t[..., 0] - 2.0 * ASA_mu[..., 0]
    h_yt = 2.0 * A_mu_t[..., 1] - 2.0 * ASA_mu[..., 1]
    t1 = 2.0 * _dot(mu_t, A_mu_t)
    t2 = 2.0 * _dot(Amu, mu_tt)
    t3 = -4.0 * _dot(ASA_mu, mu_t)
    ASASA_mu = _mv(A, _mv(S, ASA_mu))
    AS2A_mu = _mv(A, _mv(S2d, Amu))
    t4 = _dot(mu, 2.0 * ASASA_mu - AS2A_mu)
    h_tt = t1 + t2 + t3 + t4

    q_hess = torch.stack(
        [
            torch.stack([h_xx, h_xy, h_xt], -1),
            torch.stack([h_xy, h_yy, h_yt], -1),
            torch.stack([h_xt, h_yt, h_tt], -1),
        ],
        -2,
    )

    a = 0.5 * lfd2
    E = torch.exp(-a * q)
    s = -lfd1 * E
    g = (lfd1 * a) * E[..., None] * q_grad
    H = (lfd1 * a) * E[..., None, None] * (
        q_hess - a * q_grad[..., :, None] * q_grad[..., None, :]
    )
    return s, g, H


def _masked_sum(s, g, H, ok, n_sum=None):
    """Masked sum of per-pair (s, g, H) over the last `n_sum` pair dims
    of `ok` (default: all of them)."""
    okf = ok.to(torch.float32)
    n_sum = ok.dim() if n_sum is None else n_sum
    dims = tuple(range(ok.dim() - n_sum, ok.dim()))
    return (
        (s * okf).sum(dims),
        (g * okf[..., None]).sum(dims),
        (H * okf[..., None, None]).sum(dims),
    )


def _fgh_reduce(d, moved: CellList, t_means, t_covs, t_valid,
                m: MatcherParams):
    """Per-pair fgh over gathered (..., N, K) windows, masked sum over
    (N, K); d (..., 3)."""
    mu = moved.means[..., :, None, :] - t_means
    Sig = moved.covs[..., :, None, :, :] + t_covs
    m_rot = (moved.means - d[..., None, :2])[..., :, None, :]
    ok = t_valid & moved.mask[..., None]
    s, g, H = _pair_fgh(mu, Sig, m_rot, moved.covs[..., :, None, :, :],
                        m.lfd1, m.lfd2)
    return _masked_sum(s, g, H, ok, 2)


def window_cells(d, T0, src: CellList, origin, resolution: float):
    """Move the source cells to T = d ∘ T0 and find each moved mean's
    window centre cell (floor of the grid-relative position)."""
    moved = src.transform(_apply_increment(d, T0))
    rel = (moved.means - origin) / resolution
    ix0 = torch.floor(rel[..., 0]).to(torch.int64)
    iy0 = torch.floor(rel[..., 1]).to(torch.int64)
    return moved, iy0, ix0


def fgh_dense_flat_batch(d_b, T0_b, src_b: CellList, packed_flat, origins,
                         row_offsets, h: int, w: int, resolution: float,
                         m: MatcherParams, bf16_rows: bool = False):
    """fgh_dense_flat for B lanes at once, each with its own increment
    d_b (B, 3), initial pose T0_b (B, 3), source cells src_b (B, N, ...),
    target origin origins (B, 2) and row offset row_offsets (B,) into
    one flat (R, 8) packed bank.  Returns (f (B,), g (B, 3),
    H (B, 3, 3))."""
    moved, iy0, ix0 = window_cells(d_b, T0_b, src_b, origins[:, None, :],
                                   resolution)
    t_means, t_covs, t_valid = gather_windows_flat(
        packed_flat, h, w, iy0, ix0, m.n_neighbours,
        row_offsets.to(torch.int64)[:, None, None],
        (origins[:, None, :], resolution) if bf16_rows else None,
    )
    return _fgh_reduce(d_b, moved, t_means, t_covs, t_valid, m)


def paired_inputs(d, T0, src: CellList, tgt: CellList):
    """Pair inputs (mu, Sig, m_rot, Crot, ok) of the correspondence-
    restricted cost: src[i] scores only against tgt[i].  Leading dims of
    d, T0 and the lists are lanes."""
    moved = src.transform(_apply_increment(d, T0))
    return (
        moved.means - tgt.means,
        moved.covs + tgt.covs,
        moved.means - d[..., None, :2],
        moved.covs,
        src.mask & tgt.mask,
    )


def fgh_paired(d, T0, src: CellList, tgt: CellList, m: MatcherParams):
    """Analytic (score, grad, Hessian) of the paired cost, summed over
    the pairs of each lane."""
    mu, Sig, m_rot, Crot, ok = paired_inputs(d, T0, src, tgt)
    s, g, H = _pair_fgh(mu, Sig, m_rot, Crot, m.lfd1, m.lfd2)
    return _masked_sum(s, g, H, ok, 1)


def fgh_mahalanobis(d, Q):
    """(d^T Q d, (Q+Q^T) d, Q+Q^T) — the soft odometry constraint, per
    lane over leading dims."""
    Qs = Q + Q.transpose(-1, -2)
    if d.dim() == 1:
        return d @ Q @ d, Qs @ d, Qs
    return (torch.einsum("...i,...ij,...j->...", d, Q, d), _mv(Qs, d), Qs)



def newton_objective_batch_reference(
        d_b, T0_b, src_b: Optional[CellList], packed_flat, origins,
        row_offsets, h: int, w: int, res: float, m: MatcherParams,
        feat_src_b: Optional[CellList] = None,
        feat_tgt_b: Optional[CellList] = None, Q_b=None,
        bf16_rows: bool = False):
    """Plain PyTorch `newton_objective_batch`: per lane the sum, in this
    order, of the window term (fgh_dense_flat_batch), the
    paired feature term of the lane's own lists (fgh_paired
    over the lanes) and the lane's odometry term (f += d.Q.d, g +=
    (Q+Q^T) d, H += Q+Q^T); None switches a term off."""
    terms = []
    if src_b is not None:
        terms.append(fgh_dense_flat_batch(
            d_b, T0_b, src_b, packed_flat, origins, row_offsets, h, w, res,
            m, bf16_rows))
    if feat_src_b is not None:
        terms.append(fgh_paired(d_b, T0_b, feat_src_b,
                                             feat_tgt_b, m))
    if Q_b is not None:
        terms.append(fgh_mahalanobis(d_b, Q_b))
    return _sum_terms(terms, d_b)


def _sum_terms(terms, d):
    """The (f, g, H) terms added in their order; zeros of d's lanes if
    there is none."""
    if not terms:
        lead = d.shape[:-1]
        return (torch.zeros(lead, device=d.device),
                torch.zeros((*lead, 3), device=d.device),
                torch.zeros((*lead, 3, 3), device=d.device))
    f, g, H = terms[0]
    for f_i, g_i, H_i in terms[1:]:
        f, g, H = f + f_i, g + g_i, H + H_i
    return f, g, H
