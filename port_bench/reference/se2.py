"""SE(2) algebra and the odometry information: a frozen copy of the
port's plain float32 arithmetic."""

from __future__ import annotations

import math

import torch

from port_bench.reference.config import MotionParams

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



def measurement_cov(params: MotionParams, rel_pose):
    """Diagonal 3x3 covariance of a relative motion (..., 3) ->
    (..., 3, 3): var_forward = Dd*d^2 + Dt*r^2, var_side = Cd*d^2 +
    Ct*r^2, var_theta = Td*d^2 + Tt*r^2."""
    d2 = rel_pose[..., 0] ** 2 + rel_pose[..., 1] ** 2
    r2 = rel_pose[..., 2] ** 2
    vx = params.Dd * d2 + params.Dt * r2
    vy = params.Cd * d2 + params.Ct * r2
    vt = params.Td * d2 + params.Tt * r2
    return torch.diag_embed(torch.stack([vx, vy, vt], -1))


def odometry_information(params: MotionParams, rel_pose, floor=1e-6):
    """Inverse measurement covariance (3x3) with a variance floor so the
    information stays finite for zero motion."""
    cov = measurement_cov(params, rel_pose)
    diag = torch.diagonal(cov, dim1=-2, dim2=-1) + floor
    return torch.diag_embed(1.0 / diag)

