"""Blocked Schur-complement pose-graph solve (port of
ndt_feature_graph_tpu/graph/schur.py).

Nodes partition into contiguous keyframe blocks; nodes touched by
cross-block edges form the separator.  Interiors of different blocks
never couple directly, so each block's interior eliminates on its own
(all blocks at once: blocks are the leading dimension of the batched
solves), the reduced separator system is solved densely, and the
interiors back-substitute.  It forms the dense (N, N, 3, 3) normal
equations, O(N^2): a graph of tens to hundreds of nodes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ndt_feature_graph_tpu_torch.core import se2
from ndt_feature_graph_tpu_torch.graph import optimize as opt


@dataclasses.dataclass
class Partition:
    """Static block structure (host-precomputed from the edge list)."""

    assign: torch.Tensor     # (N,) node -> block
    sep_idx: torch.Tensor    # (S,) separator node ids (padded)
    sep_mask: torch.Tensor   # (S,) bool
    int_idx: torch.Tensor    # (B, I) interior node ids per block (padded)
    int_mask: torch.Tensor   # (B, I) bool
    n_blocks: int


def make_partition(n_nodes, edges: opt.EdgeList, n_blocks) -> Partition:
    """Contiguous keyframe partition and separator extraction on the host
    (the reference's numpy as it is); tensors on the edges' device."""
    ei = edges.i.cpu().numpy()
    ej = edges.j.cpu().numpy()
    em = edges.mask.cpu().numpy()
    assign = np.minimum(np.arange(n_nodes) * n_blocks // n_nodes,
                        n_blocks - 1)
    cross = (assign[ei] != assign[ej]) & em
    sep = np.zeros(n_nodes, bool)
    sep[ei[cross]] = True
    sep[ej[cross]] = True
    sep[0] = True  # prior anchor lives in the separator system

    sep_ids = np.nonzero(sep)[0]
    s_cap = max(len(sep_ids), 1)
    sep_idx = np.zeros(s_cap, np.int32)
    sep_idx[: len(sep_ids)] = sep_ids
    sep_mask = np.zeros(s_cap, bool)
    sep_mask[: len(sep_ids)] = True

    int_lists = [np.nonzero((assign == b) & ~sep)[0]
                 for b in range(n_blocks)]
    i_cap = max(max((len(x) for x in int_lists), default=1), 1)
    int_idx = np.zeros((n_blocks, i_cap), np.int32)
    int_mask = np.zeros((n_blocks, i_cap), bool)
    for b, ids in enumerate(int_lists):
        int_idx[b, : len(ids)] = ids
        int_mask[b, : len(ids)] = True
    dev = edges.i.device
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return Partition(assign=t(assign.astype(np.int64)),
                     sep_idx=t(sep_idx.astype(np.int64)),
                     sep_mask=t(sep_mask),
                     int_idx=t(int_idx.astype(np.int64)),
                     int_mask=t(int_mask), n_blocks=n_blocks)


def _gather_block(H, rows, cols):
    """H (n, n, 3, 3) -> dense (..., 3R, 3C) for index lists rows (..., R)
    and cols (..., C) with the same leading dims."""
    sub = H[rows[..., :, None], cols[..., None, :]]        # (..., R, C, 3, 3)
    r, c = sub.shape[-4], sub.shape[-3]
    return sub.transpose(-3, -2).reshape(sub.shape[:-4] + (3 * r, 3 * c))


def block_eliminate(H, b_vec, part: Partition, damping):
    """Interior elimination of every block at once.  Returns
    (schur_contrib (B, 3S, 3S), rhs_contrib (B, 3S), (H_II, H_IS, b_I))."""
    iidx, imask = part.int_idx, part.int_mask
    nb = iidx.shape[0]
    mi = imask.repeat_interleave(3, dim=1)                  # (B, 3I)
    H_II = _gather_block(H, iidx, iidx)
    # Masked-out rows/cols -> identity (no effect on the Schur term).
    eye = torch.eye(H_II.shape[-1], dtype=H.dtype, device=H.device)
    H_II = torch.where(mi[:, :, None] & mi[:, None, :], H_II,
                       eye) + damping * eye
    H_IS = _gather_block(H, iidx, part.sep_idx.expand(nb, -1))
    H_IS = torch.where(mi[:, :, None], H_IS, 0.0)
    b_I = torch.where(mi, b_vec[iidx].reshape(nb, -1), 0.0)

    H_II_inv_IS = torch.linalg.solve_ex(H_II, H_IS)[0]
    H_II_inv_bI = torch.linalg.solve_ex(H_II, b_I[..., None])[0][..., 0]
    H_SIt = H_IS.transpose(-1, -2)
    schur = H_SIt @ H_II_inv_IS
    rhs = (H_SIt @ H_II_inv_bI[..., None])[..., 0]
    return schur, rhs, (H_II, H_IS, b_I)


def optimize_schur(poses, edges: opt.EdgeList, part: Partition,
                   prior_information=100.0, iterations=20, damping=1e-6,
                   reduce: opt.Reduction = opt.ONE_DEVICE):
    """Gauss-Newton with blocked Schur elimination; returns the poses
    (N, 3) (the reference returns no chi2 here).  Over several devices
    `edges` and the blocks of `part` (int_idx, int_mask) are this
    device's shards and `reduce` sums the partial sums
    (parallel/schur_sharded.py); the separator solve is replicated."""
    n = poses.shape[0]
    dev, dt = poses.device, poses.dtype
    prior_pose = poses[0].clone()
    sep = part.sep_idx
    ms = part.sep_mask.repeat_interleave(3)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    p = poses
    for _ in range(iterations):
        H, b = opt.assemble_normal_equations(p, edges, n)
        H, b = reduce.sum(H), reduce.sum(b)
        H[0, 0] += prior_information * eye3
        b[0] += prior_information * opt._prior_residual(p, prior_pose)

        schur_c, rhs_c, (H_II, H_IS, b_I) = block_eliminate(H, b, part,
                                                            damping)
        H_SS = _gather_block(H, sep, sep)
        eye_s = torch.eye(H_SS.shape[0], dtype=dt, device=dev)
        H_SS = torch.where(ms[:, None] & ms[None, :], H_SS,
                           eye_s) + damping * eye_s
        b_S = torch.where(ms, b[sep].reshape(-1), 0.0)

        S = H_SS - reduce.sum(schur_c.sum(0))
        r = b_S - reduce.sum(rhs_c.sum(0))
        # Guard any unconstrained separator dof.
        S = S + torch.diag((torch.diagonal(S) < 1e-8).to(dt))
        dS = -torch.linalg.solve_ex(S, r)[0]

        # Back-substitution, every block at once.
        dI = -torch.linalg.solve_ex(
            H_II, (b_I + (H_IS @ dS[:, None])[..., 0])[..., None])[0][..., 0]

        delta = torch.zeros((n, 3), dtype=dt, device=dev)
        delta.index_put_((part.int_idx.reshape(-1),), torch.where(
            part.int_mask.reshape(-1, 1), dI.reshape(-1, 3), 0.0),
            accumulate=True)
        delta = reduce.sum(delta)
        delta.index_put_((sep,), torch.where(ms, dS, 0.0).reshape(-1, 3),
                         accumulate=True)
        p = p + delta
        p = torch.cat([p[:, :2], se2.normalize_angle(p[:, 2:])], -1)
    return p
