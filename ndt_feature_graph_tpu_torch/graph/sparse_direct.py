"""Sparse direct pose-graph solve: segment-Schur elimination (port of
ndt_feature_graph_tpu/graph/sparse_direct.py).

A SLAM pose graph is a block-tridiagonal odometry chain plus a sparse
set of loop closures:

  separators S = closure endpoints + node 0 + every max_seg_len-th node
  interiors    = the chain segments between consecutive separators

Each segment's interior system is block-tridiagonal and independent of
the others: a block-Thomas recurrence eliminates it, every segment at
once (segments are the leading dimension of each step, the reference's
vmap).  Each segment couples to at most its two bounding separators, so
its Schur contribution is a pair of 3x3-block outer products; the
reduced separator system (3S x 3S) is dense and solved by
torch.linalg.solve in float32, as the reference solves it outside any
kernel.  The split every max_seg_len nodes bounds the recurrence depth
L, which bounds both float32 rounding growth and the number of steps.

Device ops: the Thomas recurrence is a Python loop of L steps forward
(four ops and one batched 3x3 inverse each) and L steps back (three
ops); the Levenberg-Marquardt loop keeps its accept / reject decision
and damping on the card (torch.where), so a solve reads the card once,
at the end.  Scatter-adds with repeated indices use
`index_put_(accumulate=True)`: on the card their summation order is not
the reference's sequential one, so results agree to float32 rounding.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ndt_feature_graph_tpu_torch.core import se2
from ndt_feature_graph_tpu_torch.graph import optimize as opt
from ndt_feature_graph_tpu_torch.graph import sparse


@dataclasses.dataclass
class SegPartition:
    """Host-precomputed static elimination structure (device tensors)."""

    sep_ids: torch.Tensor    # (S,) separator node ids (sorted)
    sep_of: torch.Tensor     # (N,) node -> separator index, -1 if interior
    idx: torch.Tensor        # (B, L) interior node ids per segment (padded)
    imask: torch.Tensor      # (B, L) bool
    seg_len: torch.Tensor    # (B,)
    seg_left: torch.Tensor   # (B,) separator index left of the segment
    seg_right: torch.Tensor  # (B,) separator index right of it, -1 if none


def make_segments(n_nodes, edges: opt.EdgeList,
                  max_seg_len: int = 256) -> SegPartition:
    """Separator extraction and segment layout on the host (the
    reference's numpy as it is, after one read of the edge indices):
    separators are the endpoints of every non-sequential edge, node 0,
    and one every max_seg_len nodes inside long runs.  Returns int64 /
    bool tensors on the edges' device."""
    ei = edges.i.cpu().numpy()
    ej = edges.j.cpu().numpy()
    em = edges.mask.cpu().numpy()
    nonchain = em & (np.abs(ei.astype(np.int64) - ej) != 1)
    sep = np.zeros(n_nodes, bool)
    sep[ei[nonchain]] = True
    sep[ej[nonchain]] = True
    sep[0] = True
    run = 0
    for k in range(n_nodes):
        if sep[k]:
            run = 0
        else:
            run += 1
            if run >= max_seg_len:
                sep[k] = True
                run = 0

    sep_ids = np.nonzero(sep)[0].astype(np.int32)
    sep_of = np.full(n_nodes, -1, np.int32)
    sep_of[sep_ids] = np.arange(len(sep_ids), dtype=np.int32)

    # Maximal runs of interior nodes.
    segs = []
    k = 0
    while k < n_nodes:
        if sep[k]:
            k += 1
            continue
        start = k
        while k < n_nodes and not sep[k]:
            k += 1
        segs.append((start, k - start))
    if not segs:
        segs = [(0, 0)]  # dummy empty segment keeps shapes non-degenerate

    B = len(segs)
    L = max(max(ln for _, ln in segs), 1)
    idx = np.zeros((B, L), np.int32)
    imask = np.zeros((B, L), bool)
    seg_len = np.zeros(B, np.int32)
    seg_left = np.zeros(B, np.int32)
    seg_right = np.full(B, -1, np.int32)
    for b, (start, ln) in enumerate(segs):
        cols = np.arange(L)
        idx[b] = np.clip(start + cols, 0, n_nodes - 1)
        imask[b, :ln] = True
        seg_len[b] = ln
        seg_left[b] = sep_of[start - 1] if (ln > 0 and start > 0) else -1
        end = start + ln
        seg_right[b] = sep_of[end] if (ln > 0 and end < n_nodes) else -1
    t = lambda a: torch.as_tensor(a.astype(np.int64),  # noqa: E731
                                  device=edges.i.device)
    return SegPartition(sep_ids=t(sep_ids), sep_of=t(sep_of), idx=t(idx),
                        imask=torch.as_tensor(imask, device=edges.i.device),
                        seg_len=t(seg_len), seg_left=t(seg_left),
                        seg_right=t(seg_right))


chain_coupling = sparse.chain_coupling


def sep_coupling(Hij, edges: opt.EdgeList, sep_of, S):
    """Off-diagonal H_SS blocks from the edges whose endpoints are both
    separators: (S, S, 3, 3), the diagonal coming from blocks.D."""
    si = sep_of[edges.i]
    sj = sep_of[edges.j]
    both = (si >= 0) & (sj >= 0) & edges.mask
    w = both[:, None, None].to(Hij.dtype)
    si, sj = torch.clamp(si, min=0), torch.clamp(sj, min=0)
    H_SS = torch.zeros((S, S, 3, 3), dtype=Hij.dtype, device=Hij.device)
    H_SS.index_put_((si, sj), Hij * w, accumulate=True)
    H_SS.index_put_((sj, si), Hij.transpose(-1, -2) * w, accumulate=True)
    return H_SS


def _thomas_solve(D, C, rhs):
    """Block-tridiagonal solve of a batch of (padded) segments.

    D (B, L, 3, 3) diagonal blocks, C (B, L-1, 3, 3) super-diagonal
    (C[:, k] = A[k, k+1]), rhs (B, L, 3, R).  Masked trailing positions
    carry D = I, C = 0, rhs = 0 (decoupled identity rows).  The
    recurrence runs over L; every op covers all B segments."""
    L = D.shape[1]
    dtinv, y = [], []
    for k in range(L):
        if k == 0:
            dt, yk = D[:, 0], rhs[:, 0]
        else:
            G = C[:, k - 1].transpose(-1, -2) @ dtinv[-1]
            dt = D[:, k] - G @ C[:, k - 1]
            yk = rhs[:, k] - G @ y[-1]
        dtinv.append(torch.linalg.inv_ex(dt)[0])
        y.append(yk)
    x = [None] * L
    x[L - 1] = dtinv[L - 1] @ y[L - 1]
    for k in range(L - 2, -1, -1):
        x[k] = dtinv[k] @ (y[k] - C[:, k] @ x[k + 1])
    return torch.stack(x, 1)


def segment_eliminate(D_nodes, b_nodes, C_chain, idx, imask, seg_len,
                      seg_right, n):
    """Per-segment interior elimination (block Thomas), all segments at
    once.  Returns the per-segment Schur / right-hand-side contributions
    (dS_LL, dS_LR, dS_RL, dS_RR, dr_L, dr_R) and the (z, Y_L, Y_R) that
    back-substitution needs."""
    B, L = idx.shape
    dev, dtype = D_nodes.device, D_nodes.dtype
    eye = torch.eye(3, dtype=dtype, device=dev)
    has = (seg_len > 0)[:, None, None]
    has_r = (seg_right >= 0)[:, None, None]
    D = torch.where(imask[..., None, None], D_nodes[idx], eye)
    # Intra-segment couplings: C_chain between consecutive members.
    cm = (torch.arange(L - 1, device=dev)[None] < (seg_len - 1)[:, None])
    Cseg = torch.where(cm[..., None, None],
                       C_chain[torch.clamp(idx[:, :-1], 0, max(n - 2, 0))],
                       0.0)
    last_pos = torch.clamp(seg_len - 1, 0, L - 1)
    first = idx[:, 0]
    last = idx.gather(1, last_pos[:, None])[:, 0]
    # e_L = H[sepL, first]; e_R = H[last, sepR].
    e_L = torch.where(has, C_chain[torch.clamp(first - 1, 0, max(n - 2, 0))],
                      0.0)
    e_R = torch.where(has & has_r,
                      C_chain[torch.clamp(last, 0, max(n - 2, 0))], 0.0)

    onehot_last = (torch.arange(L, device=dev)[None]
                   == (seg_len - 1)[:, None]).to(dtype)       # (B, L)
    rhs = torch.zeros((B, L, 3, 7), dtype=dtype, device=dev)
    rhs[:, :, :, 0] = torch.where(imask[..., None], b_nodes[idx], 0.0)
    rhs[:, 0, :, 1:4] = e_L.transpose(-1, -2)
    rhs[:, :, :, 4:7] += onehot_last[..., None, None] * e_R[:, None]

    X = _thomas_solve(D, Cseg, rhs)                            # (B, L, 3, 7)
    z = X[..., 0]
    Y_L = X[..., 1:4]
    Y_R = X[..., 4:7]
    Y_L_last = torch.einsum("bl,blij->bij", onehot_last, Y_L)
    Y_R_last = torch.einsum("bl,blij->bij", onehot_last, Y_R)
    z_last = torch.einsum("bl,bli->bi", onehot_last, z)

    e_Rt = e_R.transpose(-1, -2)
    dS_LL = e_L @ Y_L[:, 0]
    dS_LR = e_L @ Y_R[:, 0]
    dS_RL = e_Rt @ Y_L_last
    dS_RR = e_Rt @ Y_R_last
    dr_L = (e_L @ z[:, 0, :, None])[..., 0]
    dr_R = (e_Rt @ z_last[..., None])[..., 0]
    return dS_LL, dS_LR, dS_RL, dS_RR, dr_L, dr_R, z, Y_L, Y_R


def scatter_segment_contribs(H_SS, b_S, contribs, seg_left, seg_right):
    """Subtract the per-segment Schur / right-hand-side contributions
    from the reduced system (in place; also returned)."""
    dS_LL, dS_LR, dS_RL, dS_RR, dr_L, dr_R = contribs
    li = torch.clamp(seg_left, min=0)
    ri = torch.clamp(seg_right, min=0)
    H_SS.index_put_((li, li), -dS_LL, accumulate=True)
    H_SS.index_put_((li, ri), -dS_LR, accumulate=True)
    H_SS.index_put_((ri, li), -dS_RL, accumulate=True)
    H_SS.index_put_((ri, ri), -dS_RR, accumulate=True)
    b_S.index_put_((li,), -dr_L, accumulate=True)
    b_S.index_put_((ri,), -dr_R, accumulate=True)
    return H_SS, b_S


def reduced_solve(H_SS, b_S):
    """Dense reduced solve (float32 LU, no host sync); a zero diagonal
    entry (an unconstrained separator dof) gets a unit pivot."""
    S = b_S.shape[0]
    Sd = H_SS.permute(0, 2, 1, 3).reshape(3 * S, 3 * S)
    diag = torch.diagonal(Sd)
    Sd = Sd + torch.diag((diag < 1e-8).to(Sd.dtype))
    return torch.linalg.solve_ex(Sd, b_S.reshape(-1))[0].reshape(S, 3)


def segment_backsub(z, Y_L, Y_R, xS, seg_left, seg_right):
    """x_I = z - Y_L xS_L - Y_R xS_R per segment."""
    xS_L = xS[torch.clamp(seg_left, min=0)]                       # (B, 3)
    xS_R = torch.where((seg_right >= 0)[:, None],
                       xS[torch.clamp(seg_right, min=0)], 0.0)
    return (z - torch.einsum("blij,bj->bli", Y_L, xS_L)
            - torch.einsum("blij,bj->bli", Y_R, xS_R))


def solve_normal_equations(blocks: sparse.EdgeBlocks, edges: opt.EdgeList,
                           part: SegPartition, n,
                           reduce: opt.Reduction = opt.ONE_DEVICE):
    """Solve H x = b exactly (blocks carry H sparsely, b = blocks.b).
    Over several devices `edges` and the segments of `part` (idx, imask,
    seg_len, seg_left, seg_right) are this device's shards, `reduce`
    sums the partial sums, and blocks.D and blocks.b are the summed
    ones."""
    S = part.sep_ids.shape[0]
    C_chain = reduce.sum(chain_coupling(blocks.Hij, edges, n))

    # Reduced system: separator-separator coupling plus their diagonals
    # (the lead device's), less the segments' Schur contributions.
    H_SS = sep_coupling(blocks.Hij, edges, part.sep_of, S)
    if reduce.lead:
        ar = torch.arange(S, device=H_SS.device)
        H_SS.index_put_((ar, ar), blocks.D[part.sep_ids], accumulate=True)
        b_S = blocks.b[part.sep_ids]
    else:
        b_S = torch.zeros((S, 3), dtype=H_SS.dtype, device=H_SS.device)

    *contribs, z, Y_L, Y_R = segment_eliminate(
        blocks.D, blocks.b, C_chain, part.idx, part.imask, part.seg_len,
        part.seg_right, n)
    H_SS, b_S = scatter_segment_contribs(H_SS, b_S, contribs,
                                         part.seg_left, part.seg_right)
    xS = reduced_solve(reduce.sum(H_SS), reduce.sum(b_S))

    x_I = segment_backsub(z, Y_L, Y_R, xS, part.seg_left, part.seg_right)
    x = torch.zeros((n, 3), dtype=xS.dtype, device=xS.device)
    x.index_put_((part.idx.reshape(-1),),
                 torch.where(part.imask.reshape(-1, 1), x_I.reshape(-1, 3),
                             0.0), accumulate=True)
    x = reduce.sum(x)
    x[part.sep_ids] = xS
    return x


def optimize_direct(poses, edges: opt.EdgeList, part: SegPartition,
                    prior_information=100.0, iterations=20, damping=1e-6,
                    robust_kernel="none", robust_delta=1.0,
                    reduce: opt.Reduction = opt.ONE_DEVICE):
    """Levenberg-Marquardt with the exact segment-Schur solve; the
    contract of opt.optimize: returns (poses, chi2) as device tensors.
    Positions carry a compensated (double-single) correction term, so
    edge residuals keep full relative accuracy on large maps.  A step is
    accepted when it does not raise chi2 (damping x0.3, floored at
    `damping`), else rejected (damping x8, capped at 1e4).  Over
    several devices `edges` and the segments of `part` are this device's
    shards and `reduce` sums the partial sums
    (parallel/sparse_direct_sharded.py); the decision runs replicated."""
    opt.check_reduction(reduce, robust_kernel)
    n = poses.shape[0]
    prior_pose = poses[0].clone()

    def chi2(p, p_lo):
        return sparse.robust_chi2(p, p_lo, edges, prior_pose,
                                  prior_information, robust_kernel,
                                  robust_delta, reduce=reduce)

    p = poses
    p_lo = torch.zeros((n, 2), dtype=poses.dtype, device=poses.device)
    lam = torch.tensor(1e-2, dtype=poses.dtype, device=poses.device)
    chi_prev = chi2(p, p_lo)
    for _ in range(iterations):
        blocks = sparse.linearize_edges(
            p, edges, prior_information, lam, prior_pose, p_lo=p_lo,
            robust_kernel=robust_kernel, robust_delta=robust_delta,
            reduce=reduce)
        delta = -solve_normal_equations(blocks, edges, part, n, reduce)
        xy, xy_lo = sparse.two_sum_update(p[:, :2], p_lo, delta[:, :2])
        th = se2.normalize_angle(p[:, 2] + delta[:, 2])
        trial = torch.cat([xy, th[:, None]], -1)
        chi_t = chi2(trial, xy_lo)
        accept = chi_t <= chi_prev
        p = torch.where(accept, trial, p)
        p_lo = torch.where(accept, xy_lo, p_lo)
        lam = torch.where(accept, torch.clamp(lam * 0.3, min=damping),
                          torch.clamp(lam * 8.0, max=1e4))
        chi_prev = torch.where(accept, chi_t, chi_prev)
    return p, chi_prev
