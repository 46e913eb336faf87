"""SE(2) geometry on batched (..., 3) pose tensors (x, y, theta).

Port of ndt_feature_graph_tpu/core/se2.py: same functions, same
broadcasting over leading dims.
"""

from __future__ import annotations

import numpy as np
import torch


def normalize_angle(a):
    """Wrap angle(s) to (-pi, pi]."""
    return torch.atan2(torch.sin(a), torch.cos(a))


def rotmat(theta):
    """(...,) -> (..., 2, 2) rotation matrices."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack(
        [torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2
    )


def compose(a, b):
    """a ∘ b: apply b in the frame of a."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = a[..., 0] + b[..., 0] * ca - b[..., 1] * sa
    y = a[..., 1] + b[..., 0] * sa + b[..., 1] * ca
    t = normalize_angle(a[..., 2] + b[..., 2])
    return torch.stack([x, y, t], -1)


def compose_np(a, b):
    """Host-side numpy compose (identical math to `compose`)."""
    ca, sa = np.cos(a[..., 2]), np.sin(a[..., 2])
    x = a[..., 0] + b[..., 0] * ca - b[..., 1] * sa
    y = a[..., 1] + b[..., 0] * sa + b[..., 1] * ca
    t = a[..., 2] + b[..., 2]
    t = np.arctan2(np.sin(t), np.cos(t))
    return np.stack([x, y, t], -1).astype(np.float32)


def sub_np(origin, pose):
    """Host-side numpy float32 `sub` (identical math)."""
    origin = np.asarray(origin, np.float32)
    pose = np.asarray(pose, np.float32)
    co, so = np.cos(origin[..., 2]), np.sin(origin[..., 2])
    dx = pose[..., 0] - origin[..., 0]
    dy = pose[..., 1] - origin[..., 1]
    t = pose[..., 2] - origin[..., 2]
    return np.stack([dx * co + dy * so, -dx * so + dy * co,
                     np.arctan2(np.sin(t), np.cos(t))], -1).astype(np.float32)


def inverse(a):
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = -(a[..., 0] * ca + a[..., 1] * sa)
    y = -(-a[..., 0] * sa + a[..., 1] * ca)
    return torch.stack([x, y, -a[..., 2]], -1)


def sub(origin, pose):
    """Relative pose of `pose` in `origin`'s frame: inverse(origin) ∘ pose."""
    co, so = torch.cos(origin[..., 2]), torch.sin(origin[..., 2])
    dx = pose[..., 0] - origin[..., 0]
    dy = pose[..., 1] - origin[..., 1]
    x = dx * co + dy * so
    y = -dx * so + dy * co
    t = normalize_angle(pose[..., 2] - origin[..., 2])
    return torch.stack([x, y, t], -1)


def transform_points(pose, pts):
    """Apply pose (..., 3) to points (..., P, 2)."""
    R = rotmat(pose[..., 2])
    return torch.einsum("...ij,...pj->...pi", R, pts) + pose[..., None, :2]


def rotate_covs(theta, covs):
    """R Sigma R^T for (..., 2, 2) covariances."""
    R = rotmat(theta)
    return torch.einsum("...ij,...pjk,...lk->...pil", R, covs, R)


def adjoint(pose):
    """Adjoint of SE(2): maps local twists to global twists, (..., 3, 3)."""
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    x, y = pose[..., 0], pose[..., 1]
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    row0 = torch.stack([c, -s, y], -1)
    row1 = torch.stack([s, c, -x], -1)
    row2 = torch.stack([z, z, o], -1)
    return torch.stack([row0, row1, row2], -2)


def adjoint_inverse(pose):
    """Closed-form inverse of `adjoint(pose)` (= adjoint of the inverse
    pose): [R^T, -R^T t; 0, 1] with t = (y, -x) — no LU factorization,
    so no device sync on CUDA."""
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    x, y = pose[..., 0], pose[..., 1]
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    row0 = torch.stack([c, s, s * x - c * y], -1)
    row1 = torch.stack([-s, c, s * y + c * x], -1)
    row2 = torch.stack([z, z, o], -1)
    return torch.stack([row0, row1, row2], -2)
