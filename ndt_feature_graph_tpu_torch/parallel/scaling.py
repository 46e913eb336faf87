"""Fleet serving on one device (port of
ndt_feature_graph_tpu/parallel/scaling.py): fleet inputs, the grouped and
the interleaved serving schedules over scan_driver.run_sequence_batch,
and the throughput measurement.

A fleet is B independent scan streams whose state is one FuserState (or
FeatureFuserState) with a leading (B,) on every field.  The inputs
replicate one sequence with a per-stream odometry jitter, as the
reference's do: a loaded one (io.dataset.Sequence), or, without one, the
reference's loop (`loop_trajectory(t_steps, radius=5.0)`) simulated with
noise from a torch.Generator seeded with `seed` (the reference draws from
jax.random, so the noise differs).  Over several devices the streams
are sharded by rank (`run_sequence_batch_sharded`, parallel/mesh.py's
contract): each rank runs its own streams, and the trajectories and
scores are gathered.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ndt_feature_graph_tpu_torch import resolve_device
from ndt_feature_graph_tpu_torch.config import FuserParams
from ndt_feature_graph_tpu_torch.fusion import (
    feature_fuser, fuser, scan_driver,
)
from ndt_feature_graph_tpu_torch.graph.node import map_tensors
from ndt_feature_graph_tpu_torch.io import dataset
from ndt_feature_graph_tpu_torch.io.dataset import Sequence
from ndt_feature_graph_tpu_torch.parallel import mesh as mesh_mod
from ndt_feature_graph_tpu_torch.utils.timers import digest


def replicate(tree, n: int):
    """A state (or any nested dataclass of tensors) stacked `n` times
    along a new leading stream dimension."""
    return map_tensors(lambda x: x.expand(n, *x.shape).contiguous(), tree)


def _stream_inputs(seq: Sequence, n_streams: int, *per_scan):
    """Scans 1.. of `seq` replicated over the streams: the odometry with
    the per-stream jitter 1e-4 * stream index on every component (so the
    streams are distinct work), and each of `per_scan` as it is."""
    dev = seq.odom.device
    jitter = 1e-4 * torch.arange(n_streams, device=dev)[:, None, None]
    odom = seq.odom[1:].expand(n_streams, -1, -1) + jitter
    return (odom, *(x[1:].expand(n_streams, *x[1:].shape).contiguous()
                    for x in per_scan))


def simulated_sequence(params: FuserParams, t_steps: int = 20,
                       num_beams: int = 360, seed: int = 0,
                       device=None) -> Sequence:
    """The fleet's stream when no sequence is given: the reference's
    `loop_trajectory(t_steps, radius=5.0)` through the default world at
    the map's sensor range, its noise from a torch.Generator on `device`
    (the card unless given) seeded with `seed`."""
    device = resolve_device(device)
    gen = torch.Generator(device)
    gen.manual_seed(seed)
    return dataset.simulate_sequence(
        dataset.loop_trajectory(t_steps, radius=5.0, device=device),
        num_beams=num_beams, max_range=params.ndt.sensor_range,
        generator=gen, device=device)


def build_fleet_inputs(params: FuserParams, seq: Optional[Sequence],
                       n_streams: int, t_steps: int = 20,
                       num_beams: int = 360, seed: int = 0, device=None):
    """Inputs of the points-only fleet driver from a (T, ...) sequence:
    (states, odom (B, T-1, 3), pts (B, T-1, P, 2), mask (B, T-1, P)),
    every stream initialized on scan 0 at the sequence's first pose.
    Without `seq`, the stream is `simulated_sequence(params, t_steps,
    num_beams, seed, device)`."""
    if seq is None:
        seq = simulated_sequence(params, t_steps, num_beams, seed, device)
    pts_all, mask_all = dataset.scan_to_points(seq.ranges, seq.hit)
    zero = torch.zeros(3, device=seq.odom.device)
    state = fuser.initialize(params, seq.gt[0], zero, pts_all[0],
                             mask_all[0])
    return (replicate(state, n_streams),
            *_stream_inputs(seq, n_streams, pts_all, mask_all))


def build_fleet_feature_inputs(params: FuserParams, seq: Optional[Sequence],
                               n_streams: int, t_steps: int = 20,
                               num_beams: int = 360, seed: int = 0,
                               device=None):
    """Inputs of the full-pipeline fleet driver: (states, odom (B, T-1,
    3), ranges (B, T-1, beams), hit (B, T-1, beams)); without `seq` as
    build_fleet_inputs.  The streams' RANSAC draws are an argument of
    run_sequence_features_batch."""
    if seq is None:
        seq = simulated_sequence(params, t_steps, num_beams, seed, device)
    zero = torch.zeros(3, device=seq.odom.device)
    state = feature_fuser.initialize(params, seq.gt[0], zero, seq.ranges[0],
                                     seq.hit[0])
    return (replicate(state, n_streams),
            *_stream_inputs(seq, n_streams, seq.ranges, seq.hit))


def _shard_streams(mesh, axis, *trees):
    """This rank's streams of each tree (every tensor's leading axis)."""
    n = mesh_mod.axis_size(mesh, axis)
    b = trees[-1].shape[0]
    if b % n:
        raise ValueError(f"{b} streams do not divide {n} shards")
    return tuple(map_tensors(lambda x: mesh_mod.shard_rows(mesh, x, axis), t)
                 for t in trees)


def run_sequence_batch_sharded(mesh, params: FuserParams, states, odom, pts,
                               mask, axis="dp"):
    """scan_driver.run_sequence_batch with the B streams sharded over
    mesh[axis] (B a multiple of the shard count): every rank passes the
    whole fleet and runs its own streams.  Returns (this rank's final
    states, trajectories (B, T, 3), scores (B, T)); the last two
    gathered, so replicated."""
    local = _shard_streams(mesh, axis, states, odom, pts, mask)
    finals, trajs, scores = scan_driver.run_sequence_batch(params, *local)
    return (finals, mesh_mod.gather_rows(mesh, trajs, axis),
            mesh_mod.gather_rows(mesh, scores, axis))


def measure_fleet_throughput(params: FuserParams, seq: Sequence,
                             n_devices: int = 1, streams_per_device: int = 4,
                             reps: int = 5, mesh=None, axis="dp"):
    """Sustained aggregate scans/s of run_sequence_batch over
    n_devices * streams_per_device streams of `seq`.  Each repetition
    perturbs the odometry, ends in a readback of a digest of every
    output and a device synchronisation; one forced warm-up first.

    With a mesh (default for n_devices > 1: make_mesh(n_devices) over the
    initialized world), the streams are sharded by rank,
    streams_per_device each, and n_devices must equal the shard count
    along `axis`: every rank times its own streams, and the aggregate is
    the all-reduced scan count over the slowest rank's median time.
    Returns (scans_per_sec, this rank's sorted times)."""
    if mesh is None and n_devices != 1:
        mesh = mesh_mod.make_mesh(n_devices, axis)
    if mesh is not None and mesh_mod.axis_size(mesh, axis) != n_devices:
        raise ValueError(f"n_devices={n_devices} on a mesh of "
                         f"{mesh_mod.axis_size(mesh, axis)} shards")
    n_streams = n_devices * streams_per_device
    states, odom, pts, mask = build_fleet_inputs(params, seq, n_streams)
    if mesh is not None:
        states, odom, pts, mask = _shard_streams(mesh, axis, states, odom,
                                                 pts, mask)

    def run(odom_k):
        out = scan_driver.run_sequence_batch(params, states, odom_k, pts,
                                             mask)
        value = float(digest(*out))
        if odom.device.type == "cuda":
            torch.cuda.synchronize(odom.device)
        return value

    run(odom)
    times = []
    for k in range(reps):
        odom_k = odom + (k + 1) * 1e-5
        t0 = time.perf_counter()
        run(odom_k)
        times.append(time.perf_counter() - t0)
    times.sort()
    stats = torch.tensor([odom.shape[0] * odom.shape[1],
                          times[len(times) // 2]], dtype=torch.float64)
    if mesh is not None:
        dev = odom.device
        scans = mesh_mod.psum(mesh, stats[:1].to(dev), axis)
        slowest = stats[1:].to(dev)
        torch.distributed.all_reduce(slowest, torch.distributed.ReduceOp.MAX,
                                     group=mesh_mod.axis_group(mesh, axis))
        stats = torch.cat([scans, slowest]).cpu()
    return float(stats[0] / stats[1]), times


def scaling_report(params: FuserParams, seq: Sequence, device_counts=(1,),
                   **kw):
    """Throughput + efficiency table over device counts: 1 runs on this
    rank's device alone, any other count is the initialized world's
    (make_mesh raises for a count that is not the world's size)."""
    rows = []
    base = None
    for n in device_counts:
        sps, _ = measure_fleet_throughput(params, seq, n, **kw)
        if base is None:
            base = sps / n
        rows.append({"devices": n, "scans_per_sec": round(sps, 1),
                     "efficiency": round(sps / (n * base), 3)})
    return rows


def _groups(b: int, group_size: int):
    return [(s, min(s + group_size, b)) for s in range(0, b, group_size)]


def _take(x, s: int, e: int, group_size: int):
    """Streams s..e of x, padded to `group_size` by replicating stream
    s (the group's first)."""
    pad = group_size - (e - s)
    sl = x[s:e]
    if pad:
        sl = torch.cat([sl, x[s:s + 1].expand(pad, *x.shape[1:])])
    return sl


def serve_fleet_grouped(params: FuserParams, states, odom, pts, mask,
                        group_size: int = 8):
    """Serve a fleet of independent scan streams in groups of
    `group_size` through scan_driver.run_sequence_batch, each group over
    its whole sequence before the next starts (the last partial group is
    padded by replicating its first stream, the padding's outputs
    dropped).  Fine for batch replay; for live serving use
    serve_fleet_interleaved.  Returns (final_states, trajectories,
    scores) shaped like run_sequence_batch over the whole fleet."""
    outs = []
    for s, e in _groups(states.Tnow.shape[0], group_size):
        res = scan_driver.run_sequence_batch(
            params, map_tensors(lambda x: _take(x, s, e, group_size), states),
            *(_take(x, s, e, group_size) for x in (odom, pts, mask)))
        outs.append(tuple(map_tensors(lambda x: x[:e - s], r) for r in res))
    return tuple(map_tensors(lambda *xs: torch.cat(xs), *rs)
                 for rs in zip(*outs))


def serve_fleet_interleaved(params: FuserParams, states, odom, pts, mask,
                            group_size: int = 8, time_chunk: int = 8):
    """serve_fleet_grouped with a per-robot latency contract: fixed
    `time_chunk`-scan slices are round-robined across the groups, so
    every stream advances by time_chunk scans each rotation and the
    worst-case staleness is one rotation, whatever the sequence length.
    Per stream the arithmetic is the grouped path's (the chunk boundary
    only splits the scan loop), except that the occupancy cadence
    (config.occ_every) restarts with every chunk, as in the reference:
    `grid.occ` differs from the grouped path's when time_chunk is not a
    multiple of occ_every; poses do not.  Returns (final_states,
    trajectories, scores) like run_sequence_batch over the whole
    fleet."""
    b, t = odom.shape[:2]
    bounds = _groups(b, group_size)
    g_states = [map_tensors(lambda x: _take(x, s, e, group_size), states)
                for s, e in bounds]
    chunks = [[] for _ in bounds]          # per group: (traj, scores)
    for c0 in range(0, t, time_chunk):
        c1 = min(c0 + time_chunk, t)
        for gi, (s, e) in enumerate(bounds):
            g_states[gi], traj, scores = scan_driver.run_sequence_batch(
                params, g_states[gi],
                *(_take(x[:, c0:c1], s, e, group_size)
                  for x in (odom, pts, mask)))
            chunks[gi].append((traj, scores))
    finals = map_tensors(
        lambda *xs: torch.cat(xs),
        *(map_tensors(lambda x: x[:e - s], st)
          for (s, e), st in zip(bounds, g_states)))
    trajs, scores = (
        torch.cat([torch.cat([c[k] for c in chunks[gi]], 1)[:e - s]
                   for gi, (s, e) in enumerate(bounds)])
        for k in (0, 1))
    return finals, trajs, scores
