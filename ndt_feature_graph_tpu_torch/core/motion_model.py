"""Odometry motion model (port of ndt_feature_graph_tpu/core/motion_model.py:
measurement_cov, odometry_information)."""

from __future__ import annotations

import torch

from ndt_feature_graph_tpu_torch.config import MotionParams


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
