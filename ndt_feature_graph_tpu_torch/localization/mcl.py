"""NDT Monte-Carlo localization: a batched particle filter on an NDT map
(port of ndt_feature_graph_tpu/localization/mcl.py).

Particle scoring is one (P, points) gather and Gaussian likelihood
batch; systematic resampling is an inverse-CDF lookup (searchsorted)
over sorted uniforms.

Randomness: each function takes its draws as tensors (init_uniform the
uniforms in [-1, 1), predict standard normals, resample the offset u0),
so a run can replay the reference's draws.  `MCL` takes them from its
own seeded CPU `torch.Generator`, moved to its device (the same draws
on the CPU and the card), or step by step from a recorded run
(`recorded_draws` rebuilds the steps from the reference's key chain:
one key at `initialize`, one per `predict`, one per `resample` on the
steps that resample).
"""

from __future__ import annotations

import dataclasses

import torch

from ndt_feature_graph_tpu_torch.config import MotionParams, NDTMapParams
from ndt_feature_graph_tpu_torch.core import motion_model, se2
from ndt_feature_graph_tpu_torch.ops import d2d


@dataclasses.dataclass
class ParticleSet:
    poses: torch.Tensor    # (P, 3)
    logw: torch.Tensor     # (P,)

    @property
    def num(self):
        return self.poses.shape[0]


def init_uniform(u_xy, u_theta, center, spread_xy=1.0, spread_theta=0.3):
    """Particles spread uniformly around `center` (3,): u_xy (n, 2) and
    u_theta (n, 1) uniform in [-1, 1)."""
    xy = center[:2] + spread_xy * u_xy
    th = center[2] + spread_theta * u_theta
    return ParticleSet(poses=torch.cat([xy, th], -1),
                       logw=torch.zeros(u_xy.shape[0], device=u_xy.device))


def predict(noise, particles: ParticleSet, Tmotion, mp: MotionParams):
    """Sample the motion model: compose each particle with Tmotion plus
    `noise` (P, 3) standard normals scaled by the Eliazar deviations."""
    cov = motion_model.measurement_cov(mp, Tmotion)
    std = torch.sqrt(torch.diagonal(cov) + 1e-8)
    moved = se2.compose(particles.poses, Tmotion + noise * std)
    return dataclasses.replace(particles, poses=moved)


def weight(particles: ParticleSet, tgt: d2d.DenseTarget,
           map_params: NDTMapParams, pts, mask, subsample: int = 4):
    """Per-particle log-likelihood, normalised: every `subsample`-th scan
    point projected by each particle pose and scored under the NDT cell
    Gaussian it lands in (NDT-MCL's point-to-distribution measurement
    model), one (P, points) batch."""
    sp = pts[::subsample]
    sm = mask[::subsample]
    h, w = tgt.valid.shape
    world = se2.transform_points(particles.poses, sp)      # (P, S, 2)
    rel = (world - tgt.origin) / map_params.resolution
    ix = torch.floor(rel[..., 0]).to(torch.int32)
    iy = torch.floor(rel[..., 1]).to(torch.int32)
    inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    flat = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
    mu = tgt.means.reshape(-1, 2)[flat]
    cov = tgt.covs.reshape(-1, 2, 2)[flat]
    valid = tgt.valid.reshape(-1)[flat] & inb & sm
    dvec = world - mu
    a, b, c = cov[..., 0, 0], cov[..., 0, 1], cov[..., 1, 1]
    det = torch.clamp(a * c - b * b, min=1e-12)
    x, y = dvec[..., 0], dvec[..., 1]
    mahal = (c * x * x - 2 * b * x * y + a * y * y) / det
    ll = torch.where(valid, 0.1 + 0.9 * torch.exp(-0.5 * mahal), 0.1)
    logw = torch.sum(torch.log(ll) * sm, -1)
    return dataclasses.replace(particles,
                               logw=logw - torch.logsumexp(logw, 0))


def _normalised_weights(particles: ParticleSet):
    w = torch.exp(particles.logw - torch.max(particles.logw))
    return w / torch.sum(w)


def resample(u0, particles: ParticleSet):
    """Systematic resampling by inverse CDF; u0 () uniform in [0, 1/n).
    A comb tooth within rounding of a CDF step can pick the neighbouring
    particle where the cumulative sum is taken in another order."""
    n = particles.num
    cdf = torch.cumsum(_normalised_weights(particles), 0)
    us = u0 + torch.arange(n, dtype=torch.float32, device=cdf.device) / n
    idx = torch.searchsorted(cdf, us, side="left").clamp(0, n - 1)
    return ParticleSet(poses=particles.poses[idx],
                       logw=torch.zeros(n, device=cdf.device))


def estimate(particles: ParticleSet):
    """Weighted mean pose (circular mean for theta)."""
    w = _normalised_weights(particles)
    xy = torch.sum(particles.poses[:, :2] * w[:, None], 0)
    s = torch.sum(torch.sin(particles.poses[:, 2]) * w)
    c = torch.sum(torch.cos(particles.poses[:, 2]) * w)
    return torch.cat([xy, torch.atan2(s, c)[None]])


def effective_sample_size(particles: ParticleSet):
    w = _normalised_weights(particles)
    return 1.0 / torch.sum(w * w)


@dataclasses.dataclass
class RecordedDraws:
    """The draws of a recorded run, by step: init_xy (n, 2) and
    init_theta (n, 1) uniform in [-1, 1), noise (S, n, 3) standard
    normals, u0 (S,) the resampling offset of each step that resampled
    (None where the recorded run did not)."""

    init_xy: torch.Tensor
    init_theta: torch.Tensor
    noise: torch.Tensor
    u0: list


def recorded_draws(init_xy, init_theta, noise, resampled, u0):
    """RecordedDraws from a run's draws in key-chain order: u0 (R,) holds
    the offsets of the R steps whose flag in `resampled` (S,) is set."""
    it = iter(u0)
    return RecordedDraws(init_xy, init_theta, noise,
                         [next(it) if bool(r) else None for r in resampled])


class MCL:
    """Host wrapper: predict -> weight -> resample when the effective
    sample size falls under n/2 (a host read each step) -> estimate.

    On the device of `tgt`.  With `draws` (RecordedDraws) each step
    takes the recorded run's draws; a step that resamples where the
    recorded run did not (its effective sample size within rounding of
    n/2) draws its offset from the generator."""

    def __init__(self, map_params: NDTMapParams, mp: MotionParams,
                 tgt: d2d.DenseTarget, n_particles=512, seed=0,
                 draws: RecordedDraws = None):
        self.map_params = map_params
        self.mp = mp
        self.tgt = tgt
        self.n = n_particles
        self.device = tgt.packed.device
        # A CPU generator, its draws moved to the device: a seed gives
        # the same particles on every device (torch's CUDA generator
        # draws other numbers than its CPU one).
        self.generator = torch.Generator("cpu")
        self.generator.manual_seed(seed)
        self.draws = draws
        self.particles = None
        self.resampled = []      # the host's decision at each step

    def _uniform(self, *shape, lo=-1.0, hi=1.0):
        u = torch.rand(shape, generator=self.generator).to(self.device)
        return lo + (hi - lo) * u

    def initialize(self, center, spread_xy=1.0, spread_theta=0.3):
        if self.draws is None:
            u_xy, u_th = self._uniform(self.n, 2), self._uniform(self.n, 1)
        else:
            u_xy, u_th = self.draws.init_xy, self.draws.init_theta
        center = torch.as_tensor(center, dtype=torch.float32,
                                 device=self.device)
        self.particles = init_uniform(u_xy, u_th, center, spread_xy,
                                      spread_theta)

    def step(self, Tmotion, pts, mask):
        s = len(self.resampled)
        if self.draws is None:
            noise = torch.randn((self.n, 3),
                                generator=self.generator).to(self.device)
        else:
            noise = self.draws.noise[s]
        self.particles = predict(noise, self.particles, Tmotion, self.mp)
        self.particles = weight(self.particles, self.tgt, self.map_params,
                                pts, mask)
        do = float(effective_sample_size(self.particles)) < self.n / 2
        self.resampled.append(do)
        if do:
            u0 = None if self.draws is None else self.draws.u0[s]
            if u0 is None:
                u0 = self._uniform(lo=0.0, hi=1.0 / self.n).reshape(())
            self.particles = resample(u0, self.particles)
        return estimate(self.particles)
