"""Histogram distances (port of ndt_feature_graph_tpu/features/distance.py)."""

from __future__ import annotations

import torch


def symmetric_chi2_matrix(a, b, eps=1e-9):
    """Pairwise symmetric chi-square distance between sum-normalized
    histogram rows: a (..., F1, D), b (..., F2, D) -> (..., F1, F2),
    d(p, q) = 0.5 * sum_i (p_i - q_i)^2 / (p_i + q_i), in [0, 1]."""
    an = a / torch.clamp(a.sum(-1, keepdim=True), min=eps)
    bn = b / torch.clamp(b.sum(-1, keepdim=True), min=eps)
    diff = an[..., :, None, :] - bn[..., None, :, :]
    s = an[..., :, None, :] + bn[..., None, :, :]
    return 0.5 * (diff * diff / (s + eps)).sum(-1)
