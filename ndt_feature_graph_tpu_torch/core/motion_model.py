"""Odometry motion model (port of ndt_feature_graph_tpu/core/motion_model.py):
the Eliazar-style measurement covariance, its information, the 3x3 <->
6x6 covariance lifts and SE(2) covariance propagation."""

from __future__ import annotations

import torch

from ndt_feature_graph_tpu_torch.config import MotionParams
from ndt_feature_graph_tpu_torch.core import se2


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


def cov3_to_cov6(cov3):
    """Lift a 3x3 (x, y, theta) covariance to the reference's 6x6 layout
    (x, y, z, roll, pitch, yaw) with identity on the dead axes."""
    batch = cov3.shape[:-2]
    cov6 = torch.eye(6, dtype=cov3.dtype, device=cov3.device).expand(
        batch + (6, 6)).clone()
    cov6[..., :2, :2] = cov3[..., :2, :2]
    cov6[..., :2, 5] = cov3[..., :2, 2]
    cov6[..., 5, :2] = cov3[..., 2, :2]
    cov6[..., 5, 5] = cov3[..., 2, 2]
    return cov6


def cov6_to_cov3(cov6):
    """The inverse lift: the (x, y, yaw) rows and columns of a 6x6
    covariance."""
    keep = torch.tensor([0, 1, 5], device=cov6.device)
    return cov6.index_select(-2, keep).index_select(-1, keep)


def compose_pose_cov(mean_a, cov_a, mean_b, cov_b):
    """Compound (mean, cov) ∘ (mean, cov) with Jacobian propagation:
    J1 = d(a∘b)/da, J2 = d(a∘b)/db; cov = J1 Ca J1' + J2 Cb J2'.
    Returns (mean, cov)."""
    mean = se2.compose(mean_a, mean_b)
    c, s = torch.cos(mean_a[..., 2]), torch.sin(mean_a[..., 2])
    bx, by = mean_b[..., 0], mean_b[..., 1]
    z, o = torch.zeros_like(c), torch.ones_like(c)
    J1 = torch.stack([
        torch.stack([o, z, -s * bx - c * by], -1),
        torch.stack([z, o, c * bx - s * by], -1),
        torch.stack([z, z, o], -1),
    ], -2)
    J2 = torch.stack([
        torch.stack([c, -s, z], -1),
        torch.stack([s, c, z], -1),
        torch.stack([z, z, o], -1),
    ], -2)
    cov = (J1 @ cov_a @ J1.transpose(-1, -2)
           + J2 @ cov_b @ J2.transpose(-1, -2))
    return mean, cov


def odometry_information(params: MotionParams, rel_pose, floor=1e-6):
    """Inverse measurement covariance (3x3) with a variance floor so the
    information stays finite for zero motion."""
    cov = measurement_cov(params, rel_pose)
    diag = torch.diagonal(cov, dim1=-2, dim2=-1) + floor
    return torch.diag_embed(1.0 / diag)
