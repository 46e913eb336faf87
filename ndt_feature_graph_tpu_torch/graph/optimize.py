"""SE(2) pose-graph optimizer: batched Gauss-Newton (port of
ndt_feature_graph_tpu/graph/optimize.py).

Factors are linearized in batch (analytic Jacobians over the edge axis),
scattered into the dense block normal equations and solved densely.
Edge measurement convention: meas = pose of node j in node i's frame,
meas ≈ inv(T_i) ∘ T_j.

Precision: the reference solves in float32 (its TPU matmuls are forced
to float32; a reduced-precision solve moved nodes 17,703 m).  Here the
solve is float32 too, and the package switches TF32 off at import.
The scatter-adds of the normal equations are atomic on CUDA, so their
sum order varies from run to run there.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ndt_feature_graph_tpu_torch.core import se2


def spd_info_np(cov, eps: float = 1e-6):
    """Host-side information matrix from a (possibly f32-noisy)
    covariance: symmetrize in f64, floor the eigenvalues at `eps`,
    invert in the eigenbasis.  Symmetric positive definite with
    eigenvalues <= 1/eps; a non-finite covariance (a degenerate
    registration) claims only the floor information."""
    c = np.asarray(cov, np.float64)
    c = 0.5 * (c + c.T)
    if not np.isfinite(c).all():
        return (np.eye(c.shape[0]) * eps).astype(np.float32)
    w, v = np.linalg.eigh(c)
    w = np.maximum(w, eps)
    return ((v / w) @ v.T).astype(np.float32)


@dataclasses.dataclass
class EdgeList:
    """Padded factor list."""

    i: torch.Tensor          # (E,) int64 ref node
    j: torch.Tensor          # (E,) int64 mov node
    meas: torch.Tensor       # (E, 3) relative pose (j in i's frame)
    info: torch.Tensor       # (E, 3, 3) information matrix
    mask: torch.Tensor       # (E,) bool
    # (E,) bool, True for odometry-chain factors (exempt from robust
    # reweighting); None classifies |i - j| == 1 as odometry.
    is_odom: Optional[torch.Tensor] = None


def edge_is_loop(edges: EdgeList):
    """(E,) bool: which factors are loop closures."""
    if edges.is_odom is not None:
        return ~edges.is_odom
    return (edges.i - edges.j).abs() != 1


def edge_residual(Ti, Tj, meas):
    """r = (inv(Ti) ∘ Tj) ⊖ meas with wrapped angle."""
    pred = se2.sub(Ti, Tj)
    return torch.cat(
        [pred[..., :2] - meas[..., :2],
         se2.normalize_angle(pred[..., 2:] - meas[..., 2:])], -1)


def _edge_jacobians(Ti, Tj, meas):
    """Analytic Jacobians of edge_residual wrt Ti and Tj, (..., 3, 3)
    each."""
    ci, si = torch.cos(Ti[..., 2]), torch.sin(Ti[..., 2])
    dx = Tj[..., 0] - Ti[..., 0]
    dy = Tj[..., 1] - Ti[..., 1]
    z, o = torch.zeros_like(ci), torch.ones_like(ci)
    Ji = torch.stack([
        torch.stack([-ci, -si, -si * dx + ci * dy], -1),
        torch.stack([si, -ci, -ci * dx - si * dy], -1),
        torch.stack([z, z, -o], -1),
    ], -2)
    Jj = torch.stack([
        torch.stack([ci, si, z], -1),
        torch.stack([-si, ci, z], -1),
        torch.stack([z, z, o], -1),
    ], -2)
    return Ji, Jj


def robust_edge_scale(r, edges: EdgeList, kernel: str, delta: float):
    """IRLS weights for loop-closure factors: "none", "huber" (delta =
    Mahalanobis-norm threshold) or "dcs" (Dynamic Covariance Scaling,
    delta = Phi lower bound).  Phi is median-adaptive: max(delta, median
    loop-edge chi2).  Returns (scale (E,), rho (E,)); odometry factors
    stay quadratic."""
    chi2_e = torch.einsum("ei,eij,ej->e", r, edges.info, r)
    if kernel == "none":
        return torch.ones_like(chi2_e), chi2_e
    is_loop = edge_is_loop(edges)
    act = is_loop & edges.mask
    # Masked median of the loop-edge chi2: inactive slots sort to +inf
    # (a stable sort, as the reference's).
    vals = torch.sort(torch.where(act, chi2_e, torch.inf), stable=True)[0]
    cnt = act.sum()
    med = vals[torch.clamp((cnt - 1) // 2, 0, chi2_e.shape[0] - 1)]
    med = torch.where(cnt > 0, med, delta)
    delta_eff = torch.clamp(med, min=delta)
    if kernel == "huber":
        d = torch.sqrt(delta_eff)
        u = torch.sqrt(torch.clamp(chi2_e, min=1e-12))
        w = torch.clamp(d / u, max=1.0)
        rho = torch.where(chi2_e <= delta_eff, chi2_e,
                          2.0 * d * u - delta_eff)
    elif kernel == "dcs":
        s = torch.clamp(2.0 * delta_eff / (delta_eff + chi2_e), max=1.0)
        w = s * s
        rho = s * s * chi2_e + 2.0 * delta_eff * (1.0 - s) ** 2
    else:
        raise ValueError(f"unknown robust kernel {kernel!r}")
    return torch.where(is_loop, w, 1.0), torch.where(is_loop, rho, chi2_e)


def assemble_normal_equations(p, edges: EdgeList, n: int, info_scale=None):
    """Batched factor linearization into dense block normal equations:
    H (n, n, 3, 3) and b (n, 3).  `info_scale` (E,) scales each edge's
    information (IRLS weights)."""
    Ti, Tj = p[edges.i], p[edges.j]
    r = edge_residual(Ti, Tj, edges.meas)
    Ji, Jj = _edge_jacobians(Ti, Tj, edges.meas)
    info = edges.info * edges.mask[:, None, None].to(p.dtype)
    if info_scale is not None:
        info = info * info_scale[:, None, None]
    Hii = torch.einsum("eki,ekl,elj->eij", Ji, info, Ji)
    Hjj = torch.einsum("eki,ekl,elj->eij", Jj, info, Jj)
    Hij = torch.einsum("eki,ekl,elj->eij", Ji, info, Jj)
    bi = torch.einsum("eki,ekl,el->ei", Ji, info, r)
    bj = torch.einsum("eki,ekl,el->ei", Jj, info, r)

    H = torch.zeros((n, n, 3, 3), dtype=p.dtype, device=p.device)
    H.index_put_((edges.i, edges.i), Hii, accumulate=True)
    H.index_put_((edges.j, edges.j), Hjj, accumulate=True)
    H.index_put_((edges.i, edges.j), Hij, accumulate=True)
    H.index_put_((edges.j, edges.i), Hij.transpose(-1, -2), accumulate=True)
    b = torch.zeros((n, 3), dtype=p.dtype, device=p.device)
    b.index_put_((edges.i,), bi, accumulate=True)
    b.index_put_((edges.j,), bj, accumulate=True)
    return H, b


def _prior_residual(p, prior_pose):
    rp = p[0] - prior_pose
    return torch.cat([rp[:2], se2.normalize_angle(rp[2:])])


def _identity(x):
    return x


@dataclasses.dataclass(frozen=True)
class Reduction:
    """How the partial sums of a solver meet.  On one device the solver
    holds every term already: `sum` is the identity and the device
    leads.  A multi-device program (parallel/) runs the same body on
    its shards with an all-reduce as `sum`, and only its `lead` device
    adds the replicated terms into its partial sums before the sum, so
    that they count once."""

    sum: Callable = _identity
    lead: bool = True


ONE_DEVICE = Reduction()


def check_reduction(reduce: Reduction, robust_kernel):
    """A robust kernel's median loop-edge chi2 is a statistic of the
    whole edge list: no shard of it can compute it."""
    if reduce != ONE_DEVICE and robust_kernel != "none":
        raise ValueError(f"robust kernel {robust_kernel!r} over a shard of "
                         "the edges")


def optimize(poses, edges: EdgeList, prior_information: float = 100.0,
             iterations: int = 20, damping: float = 1e-6,
             robust_kernel: str = "none", robust_delta: float = 1.0,
             reduce: Reduction = ONE_DEVICE):
    """Gauss-Newton over all node poses (N, 3).  Node 0 is softly pinned
    with `prior_information * I` at its initial value; loop-closure
    factors optionally get a robust kernel by IRLS each iteration.
    Unconstrained (inactive) nodes get a unit diagonal, tested on the
    UNDAMPED diagonal, before damping.  Returns (poses, final robust
    chi2) as device tensors; no host sync (`solve_ex`).  Over several
    devices `edges` is this device's shard of them and `reduce` sums
    the partial sums (parallel/solver_sharded.py)."""
    check_reduction(reduce, robust_kernel)
    n = poses.shape[0]
    dim = 3 * n
    dev, dt = poses.device, poses.dtype
    prior_pose = poses[0].clone()
    eye = torch.eye(dim, dtype=dt, device=dev)

    def chi2(p):
        r = edge_residual(p[edges.i], p[edges.j], edges.meas)
        _, rho = robust_edge_scale(r, edges, robust_kernel, robust_delta)
        c = reduce.sum(torch.where(edges.mask, rho, 0.0).sum())
        rp = _prior_residual(p, prior_pose)
        return c + prior_information * (rp * rp).sum()

    p = poses
    for _ in range(iterations):
        scale = None
        if robust_kernel != "none":
            r = edge_residual(p[edges.i], p[edges.j], edges.meas)
            scale, _ = robust_edge_scale(r, edges, robust_kernel,
                                         robust_delta)
        H, b = assemble_normal_equations(p, edges, n, info_scale=scale)
        H, b = reduce.sum(H), reduce.sum(b)
        H[0, 0] += prior_information * torch.eye(3, dtype=dt, device=dev)
        b[0] += prior_information * _prior_residual(p, prior_pose)
        Hd = H.permute(0, 2, 1, 3).reshape(dim, dim)
        Hd = Hd + torch.diag((torch.diagonal(Hd) < 1e-8).to(dt))
        Hd = Hd + damping * eye
        delta = -torch.linalg.solve_ex(Hd, b.reshape(dim))[0].reshape(n, 3)
        p = p + delta
        p = torch.cat([p[:, :2], se2.normalize_angle(p[:, 2:])], -1)
    return p, chi2(p)
