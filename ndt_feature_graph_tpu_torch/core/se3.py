"""SE(3) pose math for the 6-DoF registration surface (port of
ndt_feature_graph_tpu/core/se3.py).

Representation: pose = (6,) float32 [tx, ty, tz, rx, ry, rz] with the
rotation as a rotation VECTOR (axis * angle): closed-form Rodrigues both
ways.  Every function is functional (no in-place op), so torch.func
transforms (grad, jacfwd) run through it.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def identity(dtype=torch.float32, device=None):
    return torch.zeros(6, dtype=dtype, device=device)


def _skew(v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([
        torch.stack([o, -z, y], -1),
        torch.stack([z, o, -x], -1),
        torch.stack([-y, x, o], -1),
    ], -2)


def rotmat(rv):
    """Rodrigues: rotation vector (..., 3) -> matrix (..., 3, 3),
    Taylor-guarded at small angles (sin t / t, (1 - cos t) / t^2).

    The generic branch's angle is FLOORED before use: torch.where routes
    values and first derivatives correctly, but forward-over-reverse
    autodiff (the 6-DoF matcher's Hessian) evaluates the untaken
    branch's derivatives too, and 1/t^k at t = 0 is inf, so 0 * inf =
    NaN would land in the selected result.  With the floor every branch
    has finite derivatives of all orders at the origin."""
    t2 = (rv * rv).sum(-1)
    t2s = torch.clamp(t2, min=_EPS)
    t = torch.sqrt(t2s)
    big = t2 > _EPS
    # The Taylor branches' constants are tensors of rv's dtype: under
    # torch.func's forward-over-reverse mode a product of the untaken
    # branch with a Python float gets a float64 tangent, which a later
    # matmul then refuses.
    c = lambda x: torch.tensor(x, dtype=rv.dtype, device=rv.device)  # noqa
    a = torch.where(big, torch.sin(t) / t, c(1.0) - t2 / c(6.0))
    b = torch.where(big, (1.0 - torch.cos(t)) / t2s, c(0.5) - t2 / c(24.0))
    K = _skew(rv)
    eye = torch.eye(3, dtype=rv.dtype, device=rv.device)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def rotvec_from_matrix(R):
    """Log map: rotation matrix (3, 3) -> rotation vector (3,), with the
    small-angle (t < 1e-4) and near-pi (t > pi - 1e-3) branches."""
    tr = R[0, 0] + R[1, 1] + R[2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    t = torch.arccos(cos_t)
    # Generic branch: axis from the skew part.
    w = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                     R[1, 0] - R[0, 1]])
    generic = w * (t / torch.clamp(2.0 * torch.sin(t), min=_EPS))
    small = 0.5 * w * (1.0 + t * t / 6.0)
    # Near pi: axis from the symmetric part's diagonal, sign from w.
    B = (R + torch.eye(3, dtype=R.dtype, device=R.device)) * 0.5
    d = torch.sqrt(torch.clamp(torch.diagonal(B), min=0.0))
    k = torch.argmax(d)
    col = B[:, k] / torch.clamp(d[k], min=_EPS)
    axis = col / torch.clamp(torch.linalg.vector_norm(col), min=_EPS)
    sign = torch.where((axis * w).sum() < 0.0, -1.0, 1.0)
    near_pi = axis * sign * t
    out = torch.where(t < 1e-4, small, generic)
    return torch.where(t > math.pi - 1e-3, near_pi, out)


def compose(a, b):
    """a ∘ b (apply b, then a), both (6,)."""
    Ra = rotmat(a[3:6])
    Rb = rotmat(b[3:6])
    t = Ra @ b[0:3] + a[0:3]
    return torch.cat([t, rotvec_from_matrix(Ra @ Rb)])


def inverse(a):
    R = rotmat(a[3:6])
    return torch.cat([-(R.T @ a[0:3]), -a[3:6]])


def sub(origin, pose):
    """Relative pose: origin^-1 ∘ pose."""
    return compose(inverse(origin), pose)


def transform_points(pose, pts):
    """Apply pose (6,) to points (..., 3)."""
    return pts @ rotmat(pose[3:6]).T + pose[0:3]


def rotate_covs(pose, covs):
    """R C R^T for covs (..., 3, 3)."""
    R = rotmat(pose[3:6])
    return torch.einsum("ij,...jk,lk->...il", R, covs, R)


def from_se2(pose2):
    """Embed an SE(2) pose (3,) [x, y, theta] in SE(3) (the z = 0
    plane)."""
    z = torch.zeros(3, dtype=pose2.dtype, device=pose2.device)
    return torch.cat([pose2[0:2], z, pose2[2:3]])


def to_se2(pose6):
    """Project an (approximately planar) SE(3) pose to SE(2)."""
    return torch.stack([pose6[0], pose6[1], pose6[5]])
