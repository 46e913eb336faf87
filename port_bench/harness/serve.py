"""The system under test, driven as a server: B robots' states built by
the port's own initialisers, then served chunk after chunk through the
port's fleet driver, each chunk ending when the host holds its poses.

The harness takes from the port (ndt_feature_graph_tpu_torch) only
what this module calls, its parameter classes, its initialisers and its
two fleet drivers, and, in a traced run, its kernels' launch counters.
"""

from __future__ import annotations

import dataclasses
import random
import time

import torch

from port_bench.reference.features import scan_to_points
from port_bench.traffic import simulate

SAMPLED_ROBOTS = 16     # robots whose answers the reference checks
SAMPLED_CHUNKS = 8      # window chunks checked besides the first


def tree_map(fn, *trees):
    """`fn` leaf by leaf over matching nested dataclasses of tensors
    (None leaves stay None)."""
    t0 = trees[0]
    if dataclasses.is_dataclass(t0):
        return type(t0)(**{f.name: tree_map(fn, *(getattr(t, f.name)
                                                  for t in trees))
                           for f in dataclasses.fields(t0)})
    return None if t0 is None else fn(*trees)


def program_params(config: dict):
    """The port's FuserParams of a configuration file."""
    from ndt_feature_graph_tpu_torch import config as c

    f = dict(config["fuser"])
    return c.FuserParams(
        ndt=c.NDTMapParams(**f.pop("ndt")),
        matcher=c.MatcherParams(**f.pop("matcher")),
        features=c.FeatureParams(**f.pop("features")),
        motion=c.MotionParams(**f.pop("motion")), **f)


@dataclasses.dataclass
class Checked:
    """One checked chunk: its index, host copies of the sampled robots'
    state before it and after it, their served poses (K, S, 3) and
    scores (K, S)."""

    chunk: int
    before: object
    after: object
    poses: torch.Tensor
    scores: torch.Tensor


class Server:
    """One cell's fleet on the card: traffic, states, and the calls of
    the fleet driver.  `chunk(c)` serves chunk c of the patrol (steps
    c*K .. c*K+K-1, modulo the loop)."""

    def __init__(self, cell, seed: int, device):
        from ndt_feature_graph_tpu_torch.fusion import scan_driver

        self.cell = cell
        self.device = device
        self.params = program_params(cell.config)
        self.b = cell.mix["robots"]
        self.k = cell.mix["chunk_steps"]
        self.loop = cell.mix["loop_steps"]
        if self.loop % self.k:
            raise ValueError(f"{cell.name}: loop_steps {self.loop} is not a "
                             f"multiple of chunk_steps {self.k}")
        fp = self.params.features
        self.fleet = simulate.make_fleet(
            cell.mix, fp.num_beams, self.params.ndt.sensor_range, seed,
            fp.ransac_hypotheses if cell.features else 0, device)
        rng = random.Random(seed)
        self.sample = sorted(rng.sample(range(self.b),
                                        min(SAMPLED_ROBOTS, self.b)))
        self.sample_idx = torch.tensor(self.sample, device=device)
        self.rng = rng
        f = self.fleet
        if cell.features:
            self.inputs = (f.odom, f.ranges, f.hit, f.ransac_u)
            self.driver = scan_driver.run_sequence_features_batch
        else:
            pts, mask = scan_to_points(f.ranges, f.hit)
            self.inputs = (f.odom, pts, mask)
            self.driver = scan_driver.run_sequence_batch
            self.fleet = dataclasses.replace(f, ranges=None)

    def initial_states(self):
        """The B states, each from the port's own initialiser on its
        robot's scan 0, written into one preallocated stack."""
        from ndt_feature_graph_tpu_torch.fusion import feature_fuser, fuser

        f = self.fleet
        zero = torch.zeros(3, device=f.init_pose.device)
        out = None
        for i in range(self.b):
            if self.cell.features:
                st = feature_fuser.initialize(self.params, f.init_pose[i],
                                              zero, f.init_ranges[i],
                                              f.init_hit[i])
            else:
                pts, mask = scan_to_points(f.init_ranges[i], f.init_hit[i])
                st = fuser.initialize(self.params, f.init_pose[i], zero, pts,
                                      mask)
            if out is None:
                out = tree_map(lambda x: x.new_empty((self.b, *x.shape)), st)
            tree_map(lambda o, x: o[i].copy_(x), out, st)
        return out

    def chunk(self, states, c: int):
        """One call of the fleet driver on chunk c: (states, traj (B, K,
        3), scores (B, K))."""
        s0 = (c * self.k) % self.loop
        return self.driver(self.params, states,
                           *(x[:, s0:s0 + self.k] for x in self.inputs))

    def sync(self):
        """Wait for the card (nothing on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def sampled(self, states):
        """A copy of the sampled robots' states in host memory, so that
        the card's peak holds none of the check's state."""
        return tree_map(lambda x: x.index_select(0, self.sample_idx).cpu(),
                        states)

    def checked(self, c: int, before, states, traj, scores) -> Checked:
        """Chunk c's Checked, from the copy taken before it, the states
        it returned and its served poses (on the host) and scores."""
        return Checked(c, before, self.sampled(states),
                       traj[self.sample].transpose(0, 1),
                       scores.index_select(0, self.sample_idx).T.cpu())

    def plan_checks(self, first_chunk: int, seconds: float,
                    chunk_s: float) -> set:
        """The window chunks the reference checks, drawn before the
        window: SAMPLED_CHUNKS at a fixed stride over nine tenths of the
        chunks a window of `seconds` holds at `chunk_s` a chunk (a warm
        chunk's time), from an offset drawn from the seed."""
        span = max(SAMPLED_CHUNKS, int(0.9 * seconds / max(chunk_s, 1e-9)))
        stride = span // SAMPLED_CHUNKS
        start = first_chunk + self.rng.randrange(stride)
        return {start + i * stride for i in range(SAMPLED_CHUNKS)}


@dataclasses.dataclass
class Window:
    """What a served window leaves: per chunk the latency (call to poses
    on the host) and the host span (call to the driver's return), the
    window's length less the check's copies, the scans served, the
    non-finite poses and the checked chunks."""

    latency_s: list
    host_s: list
    seconds: float
    scans: int
    bad_poses: int
    checked: list
    chunks: int


def serve(server: Server, states, first_chunk: int, seconds: float,
          checks: set):
    """Serve chunks from `first_chunk` until `seconds` have passed since
    the first call: each chunk's poses are read back to the host, where
    the robots get them.  Around each chunk in `checks` the sampled
    robots' state is copied to the host; the time the copies take is
    left out of the window."""
    lat, host, checked = [], [], []
    bad = 0
    copy_s = 0.0
    c = first_chunk
    t_start = time.perf_counter()
    while True:
        before = None
        if c in checks:
            server.sync()
            t = time.perf_counter()
            before = server.sampled(states)
            copy_s += time.perf_counter() - t
        t0 = time.perf_counter()
        states, traj, scores = server.chunk(states, c)
        t1 = time.perf_counter()
        poses = traj.cpu()
        t2 = time.perf_counter()
        lat.append(t2 - t0)
        host.append(t1 - t0)
        bad += int((~torch.isfinite(poses)).any(-1).sum())
        if before is not None:
            server.sync()
            t = time.perf_counter()
            checked.append(server.checked(c, before, states, poses, scores))
            copy_s += time.perf_counter() - t
        c += 1
        if time.perf_counter() - t_start - copy_s >= seconds:
            break
    n = c - first_chunk
    return states, Window(latency_s=lat, host_s=host,
                          seconds=time.perf_counter() - t_start - copy_s,
                          scans=n * server.b * server.k, bad_poses=bad,
                          checked=checked, chunks=n)
