"""Scan plumbing (port of ndt_feature_graph_tpu/io/dataset.py:
scan_to_points) plus a numpy/npz sequence loader.

The simulator stays in the JAX package; its numpy output (or an npz
written by `save_sequence` there) feeds the port.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ndt_feature_graph_tpu_torch import resolve_device


@dataclasses.dataclass
class Sequence:
    """A recorded run: per-step scan + odometry + ground truth."""

    ranges: torch.Tensor     # (T, B) beam ranges (max_range where no hit)
    hit: torch.Tensor        # (T, B) bool
    odom: torch.Tensor       # (T, 3) relative motion, local frame
    gt: torch.Tensor         # (T, 3) ground-truth absolute poses


_ANGLES = {}   # (num_beams, fov, device) -> (B,) float32 beam angles


def beam_angles(num_beams: int, fov: float = 2.0 * math.pi,
                device=None):
    """Beam angles of a `num_beams` scan over `fov`: the reference's
    `jnp.linspace(-fov/2, fov/2, num_beams, endpoint=False)` in float32.

    XLA evaluates that linspace as start*(1 - i*r) + i*(stop*r), r =
    f32(1/num), contracted into fused multiply-adds.  The FMAs are
    reproduced here in float64 (an f32 x f32 product is exact there,
    so each is rounded once, to double, then to float32).  XLA's own
    result is not fixed bit for bit: its vectorised body and scalar tail
    round differently, so the eager and the jitted linspace disagree in
    a few entries (5 of 720); this helper matches either to one ulp.
    Cached per device, so the scan loop makes no host-to-device copy.
    `device=None` is the CUDA card (resolve_device)."""
    key = (num_beams, float(fov), resolve_device(device))
    out = _ANGLES.get(key)
    if out is None:
        f32, f64 = torch.float32, torch.float64
        start = torch.tensor(-fov / 2, dtype=f32).to(f64)
        rec = torch.tensor(1.0, dtype=f32) / torch.tensor(
            float(num_beams), dtype=f32)
        c2 = (torch.tensor(fov / 2, dtype=f32) * rec).to(f64)
        i = torch.arange(num_beams, dtype=f32).to(f64)
        one_minus = (1.0 - i * rec.to(f64)).to(f32).to(f64)
        first = (start * one_minus).to(f32).to(f64)
        out = (first + i * c2).to(f32).to(key[2])
        _ANGLES[key] = out
    return out


def scan_to_points(ranges, hit, fov=2.0 * math.pi):
    """Polar scan -> (B, 2) points in the sensor frame + mask."""
    angles = beam_angles(ranges.shape[-1], fov, ranges.device)
    pts = torch.stack(
        [ranges * torch.cos(angles), ranges * torch.sin(angles)], -1
    )
    return pts, hit


def load_sequence(path, device=None) -> Sequence:
    """Load a sequence npz (keys ranges, hit, odom, gt) onto `device`
    (None: the CUDA card, raising where there is none)."""
    device = resolve_device(device)
    with np.load(path) as d:
        return Sequence(
            ranges=torch.as_tensor(d["ranges"], dtype=torch.float32,
                                   device=device),
            hit=torch.as_tensor(d["hit"], dtype=torch.bool, device=device),
            odom=torch.as_tensor(d["odom"], dtype=torch.float32,
                                 device=device),
            gt=torch.as_tensor(d["gt"], dtype=torch.float32, device=device),
        )
