"""Synthetic datasets and sequence plumbing (port of
ndt_feature_graph_tpu/io/dataset.py).

Segment worlds and raycast lidar with exact ground truth (the role of
flirtlib_ros's simulate_scans.cpp:50-155), the trajectories the benches
drive, `scan_to_points`, and the npz sequence files (`save_sequence` /
`load_sequence`: the reference's keys, so a file either package wrote
loads in the other).

The worlds and trajectories are the reference's numpy, returned as
float32 tensors: equal to the reference's bit for bit.  `raycast` casts
every pose's beams against every segment, in chunks of scans.  The
reference draws the simulator's noise from jax.random, which torch
cannot reproduce: `simulate_sequence` takes the draws as tensors (then
its arithmetic is the reference's), or draws them from an explicit
torch.Generator.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ndt_feature_graph_tpu_torch import resolve_device
from ndt_feature_graph_tpu_torch.core import se2


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


_DIRECTIONS = {}   # (num_beams, fov, device) -> the beams' (cos, sin)


def beam_directions(num_beams: int, fov: float = 2.0 * math.pi,
                    device=None):
    """(cos, sin) of `beam_angles` in float32 as the CPU computes them,
    on `device`: every device takes the CPU's bits (the card's own
    float32 cos / sin round otherwise, by an ulp).  Cached per device as
    the angles are, so the scan loop makes no host-to-device copy.
    `device=None` is the CUDA card (resolve_device)."""
    key = (num_beams, float(fov), resolve_device(device))
    out = _DIRECTIONS.get(key)
    if out is None:
        ang = beam_angles(num_beams, fov, "cpu")
        out = tuple(x.to(key[2]) for x in (torch.cos(ang), torch.sin(ang)))
        _DIRECTIONS[key] = out
    return out


def scan_to_points(ranges, hit, fov=2.0 * math.pi):
    """Polar scan -> (B, 2) points in the sensor frame + mask: each
    range times its beam's direction (`beam_directions`, the CPU's
    float32 cos / sin), one float32 product a coordinate, so the card's
    points are the CPU's bit for bit."""
    cos, sin = beam_directions(ranges.shape[-1], fov, ranges.device)
    pts = torch.stack([ranges * cos, ranges * sin], -1)
    return pts, hit


# Scans a raycast takes at once: a (256, B, S) block of intermediates, 16
# MB each at 720 beams and 22 segments.
RAYCAST_CHUNK = 256


def raycast(segments, poses, num_beams: int, max_range: float,
            fov: float = 2.0 * math.pi):
    """Cast `num_beams` rays from each pose (..., 3) against the segment
    world (S, 4) [x0, y0, x1, y1].  Returns (ranges (..., B), hit
    (..., B)): the nearest hit along each beam, max_range where there is
    none within it.  Fully vectorized over (scans, beams, segments), in
    chunks of RAYCAST_CHUNK scans (scans are independent, so the
    chunking changes no result).

    A beam's angle is pose[2] + beam_angles; its direction is the cosine
    and sine taken in float64 and rounded to float32, which equals the
    reference's float32 cos / sin more often than torch's own float32
    functions do, and is the same on the CPU and the card.  The rest is the reference's float32 arithmetic."""
    lead = poses.shape[:-1]
    poses = poses.reshape(-1, 3).to(torch.float32)
    segments = segments.to(device=poses.device, dtype=torch.float32)
    x0, y0, x1, y1 = segments.unbind(-1)               # (S,)
    ex, ey = x1 - x0, y1 - y0
    base = beam_angles(num_beams, fov, poses.device)
    ranges, hits = [], []
    for c in range(0, poses.shape[0], RAYCAST_CHUNK):
        p = poses[c:c + RAYCAST_CHUNK]
        ang = (p[:, 2:3] + base).to(torch.float64)
        dx = torch.cos(ang).to(torch.float32)[..., None]   # (C, B, 1)
        dy = torch.sin(ang).to(torch.float32)[..., None]
        # Solve o + t*d = p0 + u*e for t (ray) and u in [0, 1].
        denom = dx * -ey + dy * ex                          # (C, B, S)
        ok = torch.abs(denom) > 1e-9
        safe = torch.where(ok, denom, 1e-9)
        rx = (x0 - p[:, 0:1])[:, None, :]                   # (C, 1, S)
        ry = (y0 - p[:, 1:2])[:, None, :]
        t = (rx * -ey + ry * ex) / safe
        u = (dx * ry - dy * rx) / safe
        valid = ok & (u >= 0) & (u <= 1) & (t > 1e-6)
        rng = torch.where(valid, t, math.inf).amin(-1)
        hit = rng < max_range
        ranges.append(torch.where(hit, rng, max_range))
        hits.append(hit)
    return (torch.cat(ranges).reshape(*lead, num_beams),
            torch.cat(hits).reshape(*lead, num_beams))


def simulate_sequence(waypoint_poses, num_beams=720, max_range=30.0,
                      segments=None, range_noise=0.01,
                      odom_noise=(0.01, 0.01, 0.004), *, generator=None,
                      range_draws=None, odom_draws=None,
                      device=None) -> Sequence:
    """Drive through `waypoint_poses` (T, 3); record noisy scans, noisy
    relative odometry and the ground truth, on `device` (the card unless
    given).

    The noise is `range_noise * range_draws` on the beams that hit and
    `odom_draws * odom_noise` on the relative odometry, with standard
    normal draws (T, B) and (T-1, 3): passed in (the reference's own
    draws reproduce its sequence up to the raycast) or, where one is
    None, drawn from `generator` (a torch.Generator on `device`), the
    range draws first."""
    device = resolve_device(device)
    f32 = torch.float32
    segs = default_world(device) if segments is None else torch.as_tensor(
        segments, dtype=f32, device=device)
    gt = torch.as_tensor(waypoint_poses, dtype=f32, device=device)

    def draws(given, shape):
        if given is not None:
            return torch.as_tensor(given, dtype=f32, device=device)
        if generator is None:
            raise ValueError("simulate_sequence: pass a torch.Generator "
                             "or the draws")
        return torch.randn(shape, generator=generator, dtype=f32,
                           device=device)

    rng, hit = raycast(segs, gt, num_beams, max_range)
    rng = rng + range_noise * draws(range_draws, rng.shape) * hit
    rel = se2.sub(gt[:-1], gt[1:])
    noise = draws(odom_draws, rel.shape) * torch.tensor(
        odom_noise, dtype=f32, device=device)
    odom = torch.cat([torch.zeros((1, 3), dtype=f32, device=device),
                      rel + noise])
    return Sequence(ranges=rng, hit=hit, odom=odom, gt=gt)


def save_sequence(path, seq: Sequence):
    """The reference's sequence npz (keys ranges, hit, odom, gt)."""
    np.savez_compressed(
        path,
        ranges=seq.ranges.cpu().numpy(),
        hit=seq.hit.cpu().numpy(),
        odom=seq.odom.cpu().numpy(),
        gt=seq.gt.cpu().numpy(),
    )


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


def _tensor(a, device):
    """A numpy world or trajectory as float32 on `device` (the card
    unless given): the reference's jnp.asarray(..., jnp.float32)."""
    return torch.as_tensor(np.asarray(a, np.float32),
                           device=resolve_device(device))


def default_world(device=None):
    """A ~20x14 m office-like room with interior walls and pillars.
    Segments as (S, 4) [x0, y0, x1, y1]."""
    segs = [
        # Outer walls
        (-10, -7, 10, -7), (10, -7, 10, 7), (10, 7, -10, 7), (-10, 7, -10, -7),
        # Interior partitions
        (-4, -7, -4, -2), (-4, 2, -4, 7), (3, -7, 3, 0), (3, 3, 3, 7),
        (-4, 2, 0, 2), (6, 3, 10, 3),
        # Pillars (small squares)
        (-7, -3, -6, -3), (-6, -3, -6, -2), (-6, -2, -7, -2), (-7, -2, -7, -3),
        (6, -4, 7, -4), (7, -4, 7, -3), (7, -3, 6, -3), (6, -3, 6, -4),
        (0, 5, 1, 5), (1, 5, 1, 6), (1, 6, 0, 6), (0, 6, 0, 5),
    ]
    return _tensor(segs, device)


def warehouse_world(device=None):
    """A second, sparser world: long corridors + shelving rows —
    geometry-poor along the corridor axis."""
    segs = [
        (-15, -6, 15, -6), (15, -6, 15, 6), (15, 6, -15, 6),
        (-15, 6, -15, -6),
        # shelf rows
        (-10, -3, -2, -3), (-10, -2.4, -2, -2.4),
        (2, -3, 10, -3), (2, -2.4, 10, -2.4),
        (-10, 1, -2, 1), (-10, 1.6, -2, 1.6),
        (2, 1, 10, 1), (2, 1.6, 10, 1.6),
    ]
    return _tensor(segs, device)


def loop_trajectory(n_steps=120, radius=5.0, center=(0.0, -0.5),
                    device=None):
    """A closed loop around the room (revisits the start — exercises
    loop closure)."""
    a = np.linspace(0, 2 * np.pi, n_steps)
    x = center[0] + radius * np.cos(a)
    y = center[1] + 0.65 * radius * np.sin(a)
    theta = np.unwrap(np.arctan2(np.gradient(y), np.gradient(x)))
    return _tensor(np.stack([x, y, theta], -1), device)


def _point_segment_dist(points, seg):
    """Min distance from each point (K, 2) to one segment [x0,y0,x1,y1]."""
    p0 = np.asarray(seg[:2], np.float64)
    e = np.asarray(seg[2:], np.float64) - p0
    ee = float(e @ e)
    d = points - p0
    t = np.clip((d @ e) / max(ee, 1e-12), 0.0, 1.0)
    proj = p0 + t[:, None] * e
    return np.sqrt(((points - proj) ** 2).sum(-1))


def random_world(seed, half_x=10.0, half_y=7.0, n_obstacles=12,
                 keepout=None, clearance=1.0, device=None):
    """Randomized segment world: outer rectangle + random interior stub
    walls and box pillars, from numpy's generator seeded with `seed`.

    keepout: optional (K, 2) points (e.g. a trajectory) every interior
    obstacle must stay `clearance` away from, so driven paths remain
    collision-free by construction.
    """
    rng = np.random.default_rng(seed)
    hx, hy = float(half_x), float(half_y)
    segs = [
        (-hx, -hy, hx, -hy), (hx, -hy, hx, hy),
        (hx, hy, -hx, hy), (-hx, hy, -hx, -hy),
    ]
    keep = None if keepout is None else np.asarray(keepout, np.float64)

    def admissible(cand):
        if keep is None:
            return True
        return all(
            _point_segment_dist(keep, s).min() > clearance for s in cand
        )

    placed = 0
    for _ in range(n_obstacles * 8):
        if placed >= n_obstacles:
            break
        if rng.random() < 0.4:
            # Stub wall attached to one outer wall, running inward.
            side = rng.integers(4)
            length = rng.uniform(0.15, 0.5) * (hy if side < 2 else hx) * 2
            if side == 0:    # bottom, going up
                x = rng.uniform(-hx * 0.8, hx * 0.8)
                cand = [(x, -hy, x, -hy + length)]
            elif side == 1:  # top, going down
                x = rng.uniform(-hx * 0.8, hx * 0.8)
                cand = [(x, hy, x, hy - length)]
            elif side == 2:  # left, going right
                y = rng.uniform(-hy * 0.8, hy * 0.8)
                cand = [(-hx, y, -hx + length, y)]
            else:            # right, going left
                y = rng.uniform(-hy * 0.8, hy * 0.8)
                cand = [(hx, y, hx - length, y)]
        else:
            # Box pillar.
            w = rng.uniform(0.4, 1.6)
            h = rng.uniform(0.4, 1.6)
            cx = rng.uniform(-hx + 1 + w, hx - 1 - w)
            cy = rng.uniform(-hy + 1 + h, hy - 1 - h)
            x0, x1 = cx - w / 2, cx + w / 2
            y0, y1 = cy - h / 2, cy + h / 2
            cand = [
                (x0, y0, x1, y0), (x1, y0, x1, y1),
                (x1, y1, x0, y1), (x0, y1, x0, y0),
            ]
        if admissible(cand):
            segs.extend(cand)
            placed += 1
    return _tensor(segs, device)


def random_loop_scenario(seed, n_steps=80, half_x=10.0, half_y=7.0,
                         device=None):
    """A randomized (world, loop-trajectory) pair: ellipse loop with
    randomized radii/center/phase, world obstacles placed clear of it."""
    rng = np.random.default_rng(seed)
    rx = rng.uniform(0.45, 0.65) * half_x
    ry = rng.uniform(0.45, 0.65) * half_y
    cx = rng.uniform(-0.15, 0.15) * half_x
    cy = rng.uniform(-0.15, 0.15) * half_y
    phase = rng.uniform(0, 2 * np.pi)
    a = np.linspace(0, 2 * np.pi, n_steps) + phase
    x = cx + rx * np.cos(a)
    y = cy + ry * np.sin(a)
    theta = np.unwrap(np.arctan2(np.gradient(y), np.gradient(x)))
    traj = _tensor(np.stack([x, y, theta], -1), device)
    world = random_world(
        seed, half_x=half_x, half_y=half_y,
        keepout=np.stack([x, y], -1), clearance=1.1, device=device,
    )
    return world, traj


def multi_loop_trajectory(n_loops=3, steps_per_loop=120, radius=5.0,
                          center=(0.0, -0.5), ry_scale=0.65, device=None):
    """`n_loops` consecutive revolutions of the ellipse loop — long
    trajectories that revisit the same places repeatedly."""
    n_steps = n_loops * steps_per_loop
    a = np.linspace(0, 2 * np.pi * n_loops, n_steps)
    x = center[0] + radius * np.cos(a)
    y = center[1] + ry_scale * radius * np.sin(a)
    theta = np.unwrap(np.arctan2(np.gradient(y), np.gradient(x)))
    return _tensor(np.stack([x, y, theta], -1), device)


def corridor_trajectory(n_steps=60, x0=-8.0, x1=8.0, y=-4.5, device=None):
    """Straight drive along the lower corridor."""
    x = np.linspace(x0, x1, n_steps)
    y_arr = np.full(n_steps, y)
    theta = np.zeros(n_steps)
    return _tensor(np.stack([x, y_arr, theta], -1), device)
