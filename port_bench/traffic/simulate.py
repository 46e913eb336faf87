"""The benchmark's traffic generator: a fleet of lidar robots, each
patrolling a closed loop through a random world of its own, simulated on
the card from one seed.

A frozen copy of the port's simulator (io/dataset.py: `random_world`,
`random_loop_scenario`, `raycast`, `simulate_sequence`), so that a change
to the port's simulator cannot move the yardstick.  Two departures, both
for a fleet: the worlds of all robots are drawn together on the card
from one torch.Generator (the port draws one world at a time from numpy),
and the loop leaves out its repeated end point, so that its last scan is
followed by its first and a robot patrols it for as long as a run lasts.
Each mix file (`traffic/<name>.json`) sets the fleet and the scenes; the
configuration sets the sensor (beams, range).
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass
class Fleet:
    """B robots' patrols of L scans, stored in serving order: step s is
    scan (s + 1) % L of the loop, so that scan 0 (stored last) starts
    every robot and the steps repeat in a cycle of L."""

    init_pose: torch.Tensor   # (B, 3) ground-truth pose of scan 0
    init_ranges: torch.Tensor  # (B, beams)
    init_hit: torch.Tensor    # (B, beams)
    odom: torch.Tensor        # (B, L, 3) noisy relative odometry of each step
    ranges: torch.Tensor      # (B, L, beams)
    hit: torch.Tensor         # (B, L, beams)
    gt: torch.Tensor          # (B, L, 3) ground-truth poses of each step
    ransac_u: torch.Tensor    # (B, L, M, 2) RANSAC draws, or None


def beam_angles(num_beams: int, fov: float, device):
    """The port's beam angles: linspace(-fov/2, fov/2, num_beams,
    endpoint=False) in float32, each fused multiply-add rounded as the
    reference's XLA rounds it."""
    f32, f64 = torch.float32, torch.float64
    start = torch.tensor(-fov / 2, dtype=f32).to(f64)
    rec = torch.tensor(1.0, dtype=f32) / torch.tensor(float(num_beams),
                                                      dtype=f32)
    c2 = (torch.tensor(fov / 2, dtype=f32) * rec).to(f64)
    i = torch.arange(num_beams, dtype=f32).to(f64)
    one_minus = (1.0 - i * rec.to(f64)).to(f32).to(f64)
    first = (start * one_minus).to(f32).to(f64)
    return (first + i * c2).to(f32).to(device)


def _uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                       dtype=torch.float64, device=device)


def _segment_dist(points, segs):
    """Distance of points (B, K, 2) to segments (B, S, 4): (B, S, K)."""
    p0 = segs[..., None, :2]
    e = segs[..., None, 2:] - p0
    d = points[:, None] - p0
    ee = (e * e).sum(-1).clamp(min=1e-12)
    t = ((d * e).sum(-1) / ee).clamp(0.0, 1.0)
    return torch.linalg.vector_norm(d - t[..., None] * e, dim=-1)


def loops(gen, n: int, steps: int, half_x: float, half_y: float, device):
    """n ellipse loops of `steps` poses each (B, L, 3), float64: random
    radii, centre and phase as random_loop_scenario draws them, the end
    point left out, the heading the tangent's."""
    rx = _uniform(gen, (n, 1), 0.45, 0.65, device) * half_x
    ry = _uniform(gen, (n, 1), 0.45, 0.65, device) * half_y
    cx = _uniform(gen, (n, 1), -0.15, 0.15, device) * half_x
    cy = _uniform(gen, (n, 1), -0.15, 0.15, device) * half_y
    phase = _uniform(gen, (n, 1), 0.0, 2 * math.pi, device)
    a = phase + torch.arange(steps, dtype=torch.float64,
                             device=device) * (2 * math.pi / steps)
    x, y = cx + rx * torch.cos(a), cy + ry * torch.sin(a)
    theta = torch.atan2(ry * torch.cos(a), -rx * torch.sin(a))
    return torch.stack([x, y, theta], -1)


def worlds(gen, keepout, half_x: float, half_y: float, n_obstacles: int,
           clearance: float, device):
    """n random segment worlds (B, 4 + 4 * n_obstacles, 4), float64, as
    random_world builds them: the outer rectangle, then up to
    `n_obstacles` stub walls (40%) and box pillars, each kept only where
    it stays `clearance` from every point of the robot's `keepout`
    (B, K, 2), in 8 * n_obstacles tries.  A robot's unused slots are
    zero-length segments, which no beam hits."""
    n = keepout.shape[0]
    hx, hy = float(half_x), float(half_y)
    outer = torch.tensor([(-hx, -hy, hx, -hy), (hx, -hy, hx, hy),
                          (hx, hy, -hx, hy), (-hx, hy, -hx, -hy)],
                         dtype=torch.float64, device=device)
    segs = torch.zeros((n, n_obstacles, 4, 4), dtype=torch.float64,
                       device=device)
    placed = torch.zeros(n, dtype=torch.long, device=device)
    rows = torch.arange(n, device=device)
    for _ in range(8 * n_obstacles):
        u = _uniform(gen, (n, 8), 0.0, 1.0, device)
        stub = u[:, 0] < 0.4
        # Stub wall: a side, a length, a place along the side.
        side = torch.clamp((u[:, 1] * 4).long(), max=3)
        span = torch.where(side < 2, torch.full_like(u[:, 2], hy),
                           torch.full_like(u[:, 2], hx)) * 2
        length = (0.15 + 0.35 * u[:, 2]) * span
        along_x = -hx * 0.8 + 1.6 * hx * u[:, 3]
        along_y = -hy * 0.8 + 1.6 * hy * u[:, 3]
        z = torch.zeros_like(length)
        stub_seg = torch.stack([
            torch.stack([along_x, z - hy, along_x, -hy + length], -1),
            torch.stack([along_x, z + hy, along_x, hy - length], -1),
            torch.stack([z - hx, along_y, -hx + length, along_y], -1),
            torch.stack([z + hx, along_y, hx - length, along_y], -1),
        ], 1)[rows, side]
        # Box pillar: a size, a centre clear of the outer walls.
        w = 0.4 + 1.2 * u[:, 4]
        h = 0.4 + 1.2 * u[:, 5]
        px = (-hx + 1 + w) + (2 * hx - 2 - 2 * w) * u[:, 6]
        py = (-hy + 1 + h) + (2 * hy - 2 - 2 * h) * u[:, 7]
        x0, x1, y0, y1 = px - w / 2, px + w / 2, py - h / 2, py + h / 2
        box = torch.stack([torch.stack([x0, y0, x1, y0], -1),
                           torch.stack([x1, y0, x1, y1], -1),
                           torch.stack([x1, y1, x0, y1], -1),
                           torch.stack([x0, y1, x0, y0], -1)], 1)
        one = torch.cat([stub_seg[:, None],
                         stub_seg[:, None, :2].repeat(1, 3, 2)], 1)
        cand = torch.where(stub[:, None, None], one, box)      # (B, 4, 4)
        ok = (_segment_dist(keepout, cand).amin(-1) > clearance).all(-1)
        take = ok & (placed < n_obstacles)
        slot = placed.clamp(max=n_obstacles - 1)
        segs[rows, slot] = torch.where(take[:, None, None], cand,
                                       segs[rows, slot])
        placed = placed + take.long()
    return torch.cat([outer.expand(n, 4, 4), segs.flatten(1, 2)], 1)


def raycast(segments, poses, num_beams: int, max_range: float, fov: float,
            chunk: int = 2 ** 25):
    """The port's raycast for a fleet: each robot's poses (B, L, 3)
    against its own segments (B, S, 4).  Returns (ranges, hit)
    (B, L, beams), float32: the nearest hit along each beam, max_range
    where there is none within it, in the port's float32 arithmetic with
    the beam's direction taken in float64.  Robots are cast a few at a
    time, so that no intermediate exceeds `chunk` elements."""
    b, t_len = poses.shape[:2]
    base = beam_angles(num_beams, fov, poses.device)
    segs = segments.to(torch.float32)
    step = max(1, chunk // (t_len * num_beams * segs.shape[1]))
    out_r, out_h = [], []
    for r0 in range(0, b, step):
        p = poses[r0:r0 + step].to(torch.float32)            # (R, L, 3)
        s = segs[r0:r0 + step, None, None]                   # (R, 1, 1, S, 4)
        x0, y0, x1, y1 = s.unbind(-1)
        ex, ey = x1 - x0, y1 - y0
        ang = (p[..., 2:3] + base).to(torch.float64)
        dx = torch.cos(ang).to(torch.float32)[..., None]    # (R, L, B, 1)
        dy = torch.sin(ang).to(torch.float32)[..., None]
        denom = dx * -ey + dy * ex
        ok = torch.abs(denom) > 1e-9
        safe = torch.where(ok, denom, 1e-9)
        rx = x0 - p[..., 0, None, None]
        ry = y0 - p[..., 1, None, None]
        t = (rx * -ey + ry * ex) / safe
        u = (dx * ry - dy * rx) / safe
        valid = ok & (u >= 0) & (u <= 1) & (t > 1e-6)
        rng = torch.where(valid, t, math.inf).amin(-1)
        hit = rng < max_range
        out_r.append(torch.where(hit, rng, max_range))
        out_h.append(hit)
    return torch.cat(out_r), torch.cat(out_h)


def _sub(origin, pose):
    """The port's se2.sub: `pose` in `origin`'s frame, float32."""
    co, so = torch.cos(origin[..., 2]), torch.sin(origin[..., 2])
    dx = pose[..., 0] - origin[..., 0]
    dy = pose[..., 1] - origin[..., 1]
    t = pose[..., 2] - origin[..., 2]
    return torch.stack([dx * co + dy * so, -dx * so + dy * co,
                        torch.atan2(torch.sin(t), torch.cos(t))], -1)


def make_fleet(mix: dict, num_beams: int, max_range: float, seed: int,
               ransac_hypotheses: int, device) -> Fleet:
    """The fleet of a traffic mix, from `seed`, on `device`: worlds,
    loops and noise drawn from one torch.Generator there, in a fixed
    order, so one seed gives the same fleet and every robot its own
    world and loop.  `ransac_hypotheses` > 0 adds the RANSAC draws of
    every step (uniform in [0, 1))."""
    gen = torch.Generator(device)
    gen.manual_seed(seed)
    n, steps = mix["robots"], mix["loop_steps"]
    fov = 2.0 * math.pi * mix["fov_turns"]
    gt64 = loops(gen, n, steps, mix["half_x"], mix["half_y"], device)
    segs = worlds(gen, gt64[..., :2], mix["half_x"], mix["half_y"],
                  mix["obstacles"], mix["clearance"], device)
    gt = gt64.to(torch.float32)
    ranges, hit = raycast(segs, gt, num_beams, max_range, fov)
    ranges = ranges + mix["range_noise"] * torch.randn(
        ranges.shape, generator=gen, device=device) * hit
    # Step s moves from scan s to scan s + 1 (mod L): stored in serving
    # order, scan 0 last.
    nxt = torch.roll(gt, -1, 1)
    odom = _sub(gt, nxt) + torch.randn(
        (n, steps, 3), generator=gen, device=device) * torch.tensor(
            mix["odom_noise"], dtype=torch.float32, device=device)
    u = None
    if ransac_hypotheses:
        u = torch.rand((n, steps, ransac_hypotheses, 2), generator=gen,
                       device=device)
    return Fleet(init_pose=gt[:, 0].contiguous(),
                 init_ranges=ranges[:, 0].contiguous(),
                 init_hit=hit[:, 0].contiguous(), odom=odom,
                 ranges=torch.roll(ranges, -1, 1),
                 hit=torch.roll(hit, -1, 1), gt=nxt, ransac_u=u)
