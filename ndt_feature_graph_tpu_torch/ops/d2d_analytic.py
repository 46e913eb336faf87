"""Analytic D2D derivatives: score + gradient + Hessian in one pass over
cell pairs (port of ndt_feature_graph_tpu/ops/d2d_analytic.py, plain
PyTorch).

These are the plain versions.  On CUDA tensors the main path reaches
the same sums through the hand-written kernel (ops/cuda_kernels.py);
these functions are its twins on the CPU and its reference on the card.

Derivation (SE(2) left-increment p = (dx, dy, dtheta) at evaluation
point d, per pair with pretransformed source gaussian (m, C) and target
(mu2, S2)): mu = R m + t - mu2, Sig = R C R^T + S2, A = Sig^-1,
q = mu^T A mu, s = -d1 exp(-(d2/2) q); gradient and Hessian of q follow
from the rotation generator G = [[0,-1],[1,0]] acting on m_rot and
Crot — see the reference module's docstring for the full expansion.
"""

from __future__ import annotations

import torch

from ndt_feature_graph_tpu.config import MatcherParams
from ndt_feature_graph_tpu_torch.ops import d2d
from ndt_feature_graph_tpu_torch.ops.ndt_map import CellList


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
    moved = src.transform(d2d._apply_increment(d, T0))
    rel = (moved.means - origin) / resolution
    ix0 = torch.floor(rel[..., 0]).to(torch.int64)
    iy0 = torch.floor(rel[..., 1]).to(torch.int64)
    return moved, iy0, ix0


def fgh_dense_flat(d, T0, src: CellList, packed_flat, origin, row_offset,
                   h: int, w: int, resolution: float, m: MatcherParams):
    """Analytic (score, grad, Hessian) of the D2D window cost of `src`
    moved by d ∘ T0 against the flat packed table at `row_offset`."""
    moved, iy0, ix0 = window_cells(d, T0, src, origin, resolution)
    t_means, t_covs, t_valid = d2d.gather_windows_flat(
        packed_flat, h, w, iy0, ix0, m.n_neighbours, row_offset
    )
    return _fgh_reduce(d, moved, t_means, t_covs, t_valid, m)


def fgh_dense_flat_batch(d_b, T0_b, src_b: CellList, packed_flat, origins,
                         row_offsets, h: int, w: int, resolution: float,
                         m: MatcherParams):
    """fgh_dense_flat for B lanes at once, each with its own increment
    d_b (B, 3), initial pose T0_b (B, 3), source cells src_b (B, N, ...),
    target origin origins (B, 2) and row offset row_offsets (B,) into
    one flat (R, 8) packed bank.  Returns (f (B,), g (B, 3),
    H (B, 3, 3))."""
    moved, iy0, ix0 = window_cells(d_b, T0_b, src_b, origins[:, None, :],
                                   resolution)
    t_means, t_covs, t_valid = d2d.gather_windows_flat(
        packed_flat, h, w, iy0, ix0, m.n_neighbours,
        row_offsets.to(torch.int64)[:, None, None],
    )
    return _fgh_reduce(d_b, moved, t_means, t_covs, t_valid, m)


def paired_inputs(d, T0, src: CellList, tgt: CellList):
    """Pair inputs (mu, Sig, m_rot, Crot, ok) of the correspondence-
    restricted cost: src[i] scores only against tgt[i]."""
    moved = src.transform(d2d._apply_increment(d, T0))
    return (
        moved.means - tgt.means,
        moved.covs + tgt.covs,
        moved.means - d[:2],
        moved.covs,
        src.mask & tgt.mask,
    )


def fgh_paired(d, T0, src: CellList, tgt: CellList, m: MatcherParams):
    """Analytic (score, grad, Hessian) of the paired cost."""
    mu, Sig, m_rot, Crot, ok = paired_inputs(d, T0, src, tgt)
    s, g, H = _pair_fgh(mu, Sig, m_rot, Crot, m.lfd1, m.lfd2)
    return _masked_sum(s, g, H, ok)


def fgh_mahalanobis(d, Q):
    """(d^T Q d, (Q+Q^T) d, Q+Q^T) — the soft odometry constraint."""
    Qs = Q + Q.T
    return d @ Q @ d, Qs @ d, Qs
