"""Matrix-free sparse pose-graph solve: Gauss-Newton + preconditioned
conjugate gradients (port of ndt_feature_graph_tpu/graph/sparse.py).

Each Gauss-Newton step keeps only the per-edge Hessian blocks (Hii,
Hjj, Hij: O(E) memory) and solves the normal equations by PCG whose
mat-vec is a gather / scatter over the edge list; the dense (N, N, 3, 3)
system is never formed.  The per-edge blocks are also what the exact
segment-Schur solve (graph/sparse_direct.py) eliminates.

Float32 throughout, TF32 off (package import).  The node scatter-adds
are `index_put_(accumulate=True)`, whose summation order on the card is
not the reference's sequential order: results agree to rounding.  The
compensated arithmetic (`two_sum_update`, `edge_residual_hl`) is written
op by op in eager PyTorch, where no op is reassociated or fused into a
multiply-add; it must not go under torch.compile.

The reference's `lax.scan`s become Python loops over the scanned axis
(the chain preconditioner's Thomas recurrences over the nodes, the
fixed-trip PCG and Gauss-Newton loops); their convergence tests stay
device tensors under torch.where, so no loop reads the device.
"""

from __future__ import annotations

import dataclasses

import torch

from ndt_feature_graph_tpu_torch.core import se2
from ndt_feature_graph_tpu_torch.graph import optimize as opt


@dataclasses.dataclass
class EdgeBlocks:
    """Per-edge linearized factor blocks (the sparse Hessian)."""

    Hii: torch.Tensor     # (E, 3, 3)
    Hjj: torch.Tensor     # (E, 3, 3)
    Hij: torch.Tensor     # (E, 3, 3)
    b: torch.Tensor       # (N, 3) gradient
    D: torch.Tensor       # (N, 3, 3) diagonal blocks incl. prior + damping
    Dinv: torch.Tensor    # (N, 3, 3) block-Jacobi preconditioner
    D_base: torch.Tensor  # (N, 3, 3) prior + damping (+ inactive guard)


def two_sum_update(hi, lo, b):
    """Compensated (double-single) update: (hi, lo) + b with the float32
    rounding error of the add kept in lo (Knuth two-sum, renormalised).
    One rounded op per line: bit-exact to the reference."""
    s = hi + b
    bb = s - hi
    err = (hi - (s - bb)) + (b - bb)
    lo2 = lo + err
    hi2 = s + lo2
    lo3 = lo2 - (hi2 - s)
    return hi2, lo3


def edge_residual_hl(p, p_lo, edges: opt.EdgeList):
    """Edge residual with compensated xy differences: p_lo (N, 2) carries
    each position's float32 correction, so tj - ti keeps full relative
    accuracy at local scale on maps hundreds of metres wide."""
    dxy = ((p[edges.j, :2] - p[edges.i, :2])
           + (p_lo[edges.j] - p_lo[edges.i]))
    th_i = p[edges.i, 2]
    c, s = torch.cos(th_i), torch.sin(th_i)
    local = torch.stack([c * dxy[:, 0] + s * dxy[:, 1],
                         -s * dxy[:, 0] + c * dxy[:, 1]], -1)
    dth = se2.normalize_angle(p[edges.j, 2] - th_i - edges.meas[:, 2])
    return torch.cat([local - edges.meas[:, :2], dth[:, None]], -1)


def _scatter_rows(n, idx_vals, like):
    """(n, ...) zeros with each (idx (E,), vals (E, ...)) added at idx."""
    out = torch.zeros((n,) + like.shape[1:], dtype=like.dtype,
                      device=like.device)
    for idx, vals in idx_vals:
        out.index_put_((idx,), vals, accumulate=True)
    return out


def linearize_edges_raw(p, edges: opt.EdgeList, n, p_lo=None,
                        info_scale=None):
    """Per-edge factor linearization without prior or damping: returns
    (Hii, Hjj, Hij, D_edges, b_edges), the last two the node-scattered
    diagonal blocks and gradient of these edges.  info_scale: optional
    (E,) IRLS weights (opt.robust_edge_scale)."""
    Ti, Tj = p[edges.i], p[edges.j]
    if p_lo is None:
        r = opt.edge_residual(Ti, Tj, edges.meas)
    else:
        r = edge_residual_hl(p, p_lo, edges)
    Ji, Jj = opt._edge_jacobians(Ti, Tj, edges.meas)
    info = edges.info * edges.mask[:, None, None].to(p.dtype)
    if info_scale is not None:
        info = info * info_scale[:, None, None]
    Hii = torch.einsum("eki,ekl,elj->eij", Ji, info, Ji)
    Hjj = torch.einsum("eki,ekl,elj->eij", Jj, info, Jj)
    Hij = torch.einsum("eki,ekl,elj->eij", Ji, info, Jj)
    bi = torch.einsum("eki,ekl,el->ei", Ji, info, r)
    bj = torch.einsum("eki,ekl,el->ei", Jj, info, r)
    b = _scatter_rows(n, ((edges.i, bi), (edges.j, bj)), bi)
    D = _scatter_rows(n, ((edges.i, Hii), (edges.j, Hjj)), Hii)
    return Hii, Hjj, Hij, D, b


def finalize_blocks(p, D, b, Hii, Hjj, Hij, prior_information, damping,
                    prior_pose) -> EdgeBlocks:
    """Add the node-0 prior (prior_information * I), the damping (a float
    or a 0-d tensor) and the inactive-node guard to the accumulated
    (D, b)."""
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    rp = opt._prior_residual(p, prior_pose)
    D = D.clone()
    b = b.clone()
    D[0] += prior_information * eye
    b[0] += prior_information * rp
    # Unconstrained (padded / inactive) nodes get a unit block: the
    # system stays SPD and their update is exactly zero (b is 0 there).
    deg = torch.einsum("nii->n", D)
    inactive = (deg < 1e-8)[:, None, None]
    D_base = torch.zeros_like(D)
    D_base[0] += prior_information * eye
    D_base = torch.where(inactive, eye, D_base + damping * eye)
    D = torch.where(inactive, eye, D + damping * eye)
    Dinv = torch.linalg.inv_ex(D)[0]
    return EdgeBlocks(Hii=Hii, Hjj=Hjj, Hij=Hij, b=b, D=D, Dinv=Dinv,
                      D_base=D_base)


def linearize_edges(p, edges: opt.EdgeList, prior_information, damping,
                    prior_pose, p_lo=None, robust_kernel="none",
                    robust_delta=1.0,
                    reduce: opt.Reduction = opt.ONE_DEVICE) -> EdgeBlocks:
    """Batched factor linearization kept in edge-block (sparse) form:
    the math of opt.assemble_normal_equations without the dense scatter.
    p_lo: (N, 2) compensated position corrections (edge_residual_hl);
    robust_kernel: IRLS loop-closure reweighting; reduce: the sum of the
    node-scattered blocks over the devices when `edges` is a shard (the
    per-edge blocks stay the shard's)."""
    n = p.shape[0]
    scale = None
    if robust_kernel != "none":
        if p_lo is None:
            r = opt.edge_residual(p[edges.i], p[edges.j], edges.meas)
        else:
            r = edge_residual_hl(p, p_lo, edges)
        scale, _ = opt.robust_edge_scale(r, edges, robust_kernel,
                                         robust_delta)
    Hii, Hjj, Hij, D, b = linearize_edges_raw(p, edges, n, p_lo=p_lo,
                                              info_scale=scale)
    D, b = reduce.sum(D), reduce.sum(b)
    return finalize_blocks(p, D, b, Hii, Hjj, Hij, prior_information,
                           damping, prior_pose)


def hvp(blocks: EdgeBlocks, edges: opt.EdgeList, v):
    """H @ v without forming H: the diagonal blocks (prior, damping and
    the guard included) from blocks.D, the cross terms per edge."""
    out = torch.einsum("nij,nj->ni", blocks.D, v)
    out.index_put_((edges.i,), torch.einsum("eij,ej->ei", blocks.Hij,
                                            v[edges.j]), accumulate=True)
    out.index_put_((edges.j,), torch.einsum("eji,ej->ei", blocks.Hij,
                                            v[edges.i]), accumulate=True)
    return out


@dataclasses.dataclass
class ChainPrec:
    """Block-Thomas factorization of the block-tridiagonal part of H:
    the diagonal blocks plus the couplings of sequential edges
    (|i - j| == 1), the odometry chain.  PCG preconditioned with its
    exact solve only corrects for the loop closures."""

    dtilde_inv: torch.Tensor  # (N, 3, 3) inverses of eliminated diagonals
    C: torch.Tensor           # (N-1, 3, 3) super-diagonal H[k, k+1]


def chain_coupling(Hij, edges: opt.EdgeList, n):
    """C[k] = H[k, k+1] accumulated from the sequential edges."""
    diff = edges.j - edges.i
    fwd = (diff == 1) & edges.mask
    bwd = (diff == -1) & edges.mask
    kf = torch.clamp(edges.i, 0, max(n - 2, 0))
    kb = torch.clamp(edges.j, 0, max(n - 2, 0))
    return _scatter_rows(max(n - 1, 1), (
        (kf, torch.where(fwd[:, None, None], Hij, 0.0)),
        (kb, torch.where(bwd[:, None, None], Hij.transpose(-1, -2), 0.0)),
    ), Hij)


def chain_preconditioner(blocks: EdgeBlocks, edges: opt.EdgeList,
                         n) -> ChainPrec:
    """Forward block elimination of the chain-only Hessian (+ prior and
    damping): d~_k = D_k - C_{k-1}^T d~_{k-1}^-1 C_{k-1}.  Nodes no chain
    edge touches keep their full diagonal block."""
    C = chain_coupling(blocks.Hij, edges, n)
    diff = edges.j - edges.i
    chain = ((diff == 1) | (diff == -1)) & edges.mask
    w = chain[:, None, None].to(blocks.D.dtype)
    D_c = _scatter_rows(n, ((edges.i, blocks.Hii * w),
                            (edges.j, blocks.Hjj * w)), blocks.Hii)
    deg = torch.einsum("nii->n", D_c)
    D_c = torch.where((deg < 1e-8)[:, None, None], blocks.D,
                      D_c + blocks.D_base)
    prev = torch.zeros((3, 3), dtype=C.dtype, device=C.device)
    out = []
    for k in range(n):
        dt = D_c[k]
        if k > 0:
            dt = dt - C[k - 1].T @ prev @ C[k - 1]
        prev = torch.linalg.inv_ex(dt)[0]
        out.append(prev)
    return ChainPrec(dtilde_inv=torch.stack(out), C=C)


def apply_chain_prec(prec: ChainPrec, r):
    """Solve M z = r with the Thomas factorization (two O(N) sweeps)."""
    n = r.shape[0]
    C, dinv = prec.C, prec.dtilde_inv
    y = [r[0]]
    for k in range(1, n):
        y.append(r[k] - C[k - 1].T @ (dinv[k - 1] @ y[-1]))
    x = [None] * n
    x[n - 1] = dinv[n - 1] @ y[n - 1]
    for k in range(n - 2, -1, -1):
        x[k] = dinv[k] @ (y[k] - C[k] @ x[k + 1])
    return torch.stack(x)


def pcg(blocks: EdgeBlocks, edges: opt.EdgeList, rhs, cg_iterations,
        prec_apply=None, tol=1e-10):
    """PCG for H x = rhs, a fixed number of masked iterations (an
    iteration after convergence changes nothing).  prec_apply maps a
    residual to the preconditioned residual; default block-Jacobi."""
    if prec_apply is None:
        def prec_apply(res):
            return torch.einsum("nij,nj->ni", blocks.Dinv, res)

    x = torch.zeros_like(rhs)
    r = rhs
    z = prec_apply(r)
    p = z
    rz = (r * z).sum()
    rhs_norm = (rhs * rhs).sum()
    active = torch.ones((), dtype=torch.bool, device=rhs.device)
    for _ in range(cg_iterations):
        Hp = hvp(blocks, edges, p)
        pHp = (p * Hp).sum()
        alpha = rz / torch.where(pHp == 0.0, 1.0, pHp)
        x1 = x + alpha * p
        r1 = r - alpha * Hp
        z1 = prec_apply(r1)
        rz1 = (r1 * z1).sum()
        beta = rz1 / torch.where(rz == 0.0, 1.0, rz)
        p1 = z1 + beta * p
        done = (r1 * r1).sum() <= tol * tol * rhs_norm
        x = torch.where(active, x1, x)
        r = torch.where(active, r1, r)
        p = torch.where(active, p1, p)
        rz = torch.where(active, rz1, rz)
        active = active & ~done
    return x


def robust_chi2(p, p_lo, edges: opt.EdgeList, prior_pose,
                prior_information, robust_kernel, robust_delta,
                reduce: opt.Reduction = opt.ONE_DEVICE):
    """The robust objective: edge rho summed over the active edges plus
    the prior term.  p_lo None: the plain residual.  reduce: the edge
    sum over the devices when `edges` is a shard."""
    if p_lo is None:
        r = opt.edge_residual(p[edges.i], p[edges.j], edges.meas)
    else:
        r = edge_residual_hl(p, p_lo, edges)
    _, rho = opt.robust_edge_scale(r, edges, robust_kernel, robust_delta)
    rp = opt._prior_residual(p, prior_pose)
    return (reduce.sum(torch.where(edges.mask, rho, 0.0).sum())
            + prior_information * (rp * rp).sum())


def optimize_pcg(poses, edges: opt.EdgeList, prior_information=100.0,
                 iterations=20, cg_iterations=100, damping=1e-6,
                 preconditioner="chain", robust_kernel="none",
                 robust_delta=1.0):
    """Gauss-Newton with a matrix-free PCG inner solve; the contract of
    opt.optimize: returns (poses, chi2) as device tensors.
    preconditioner: "chain" (exact Thomas solve of the odometry chain)
    or "jacobi" (per-node 3x3 blocks)."""
    prior_pose = poses[0].clone()
    n = poses.shape[0]
    p = poses
    for _ in range(iterations):
        blocks = linearize_edges(p, edges, prior_information, damping,
                                 prior_pose, robust_kernel=robust_kernel,
                                 robust_delta=robust_delta)
        prec_apply = None
        if preconditioner == "chain":
            prec = chain_preconditioner(blocks, edges, n)

            def prec_apply(res, prec=prec):
                return apply_chain_prec(prec, res)
        delta = -pcg(blocks, edges, blocks.b, cg_iterations,
                     prec_apply=prec_apply)
        p = p + delta
        p = torch.cat([p[:, :2], se2.normalize_angle(p[:, 2:])], -1)
    return p, robust_chi2(p, None, edges, prior_pose, prior_information,
                          robust_kernel, robust_delta)
