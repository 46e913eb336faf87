"""The traced run: a profile of a few chunks served after the window,
reduced to what the per-layer readers (port_bench/metrics/<name>.py)
read.

The profiler can miss the first launches after it starts, so the traced
chunks lie between two spin kernels, after one chunk that runs inside
the profile untraced, and only device operations between the spins
count (the method of the port's chip_smoke.device_by_kernel).  Device
time is the union of the intervals of kernels, copies and memsets, never
a sum of `self_device_time_total`, which reads 0 for asynchronous
events.
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib.util
import json
import re

import torch

from port_bench.harness.cell import BENCH

SPIN_CYCLES = 20_000      # ~10 us at 1,980 MHz
TRACED_STEPS = 16         # fleet steps between the spins
WALK = 20_000             # host operations searched back from a gap


@dataclasses.dataclass
class Trace:
    """What a traced run read: the device operations between the spins
    as (name, start_s, end_s), the steps they served, the traced window
    and the device's busy time in it, the window's host spans (driver
    call to its return, seconds, summed) and steps, the port's launch
    counters over the traced chunks, the idle gaps, and the cell."""

    ops: list
    steps: int
    window_s: float
    busy_s: float
    host_s: float
    host_steps: int
    launches: dict
    gaps: list
    cell: object
    peaks: dict

    def kernel_s(self, pattern: str) -> float:
        """Device seconds of the kernels whose names `pattern` (a regular
        expression) matches; None if none of them ran."""
        pat = re.compile(pattern)
        hits = [e - s for n, s, e in self.ops if pat.search(n)]
        return sum(hits) if hits else None


def union_s(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def idle_gaps(intervals, lo: float, hi: float):
    """The stretches of [lo, hi] that no interval covers, as (start,
    end)."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [g for g in out if g[1] > g[0]]


def profile(server, states, c0: int, cell, host_s: float, host_steps: int):
    """Serve chunks from c0 under the profiler, after the window: one
    chunk untraced inside the profile, then a spin kernel, the chunks of
    at least TRACED_STEPS steps that are traced, a second spin.  Every
    chunk's poses are read back as in the window.  Returns (states, the
    Trace); raises if the profile saw no two spins."""
    from ndt_feature_graph_tpu_torch.ops import cuda_kernels
    from torch.profiler import ProfilerActivity, profile as torch_profile

    n = max(1, -(-TRACED_STEPS // server.k))
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for i in range(1 + n):
            if i == 1:
                torch.cuda._sleep(SPIN_CYCLES)
                before = dict(cuda_kernels.LAUNCHES)
            states, traj, _ = server.chunk(states, c0 + i)
            traj.cpu()
        torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in cuda_kernels.LAUNCHES.items()}
    evs = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    dev = sorted(((e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
                  for e in evs if e.device_type == cuda), key=lambda x: x[1])
    spins = [i for i, (name, _, _) in enumerate(dev)
             if "spin_kernel" in name]
    if len(spins) != 2:
        raise RuntimeError(f"the profile saw {len(spins)} of 2 spins")
    lo, hi = dev[spins[0]][2], dev[spins[1]][1]
    ops = dev[spins[0] + 1:spins[1]]
    iv = [(s, e) for _, s, e in ops]
    host = [(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
            for e in evs if e.device_type != cuda]
    return states, Trace(
        ops=ops, steps=n * server.k, window_s=hi - lo,
        busy_s=union_s([(max(s, lo), min(e, hi)) for s, e in iv]),
        host_s=host_s, host_steps=host_steps, launches=launches,
        gaps=_attribute(idle_gaps(iv, lo, hi), host), cell=cell,
        peaks=_load("peaks.json"))


def _load(name):
    with open(BENCH / name) as f:
        return json.load(f)


def _attribute(gaps, host):
    """Each idle gap named by the innermost host operation running at its
    middle, the one that started last among those that span it ("host
    outside torch ops" where none does: Python between operations)."""
    host = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    out = []
    for s, e in gaps:
        mid = (s + e) / 2
        name = "host outside torch ops"
        hi = bisect.bisect_right(starts, mid)
        for j in range(hi - 1, max(hi - WALK, 0) - 1, -1):
            if host[j][2] >= mid:
                name = host[j][0]
                break
        out.append((name, e - s))
    return out


def breakdown(tr: Trace) -> dict:
    """The 10 device operations that took most time, and the 10 host
    operations under which the device idled longest, in seconds."""
    ops, gaps = {}, {}
    for n, s, e in tr.ops:
        ops[n] = ops.get(n, 0.0) + (e - s)
    for n, d in tr.gaps:
        gaps[n] = gaps.get(n, 0.0) + d
    top = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                           key=lambda kv: -kv[1])[:10]
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def _module(path):
    spec = importlib.util.spec_from_file_location(
        "port_bench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def count(kernel: str):
    """The byte count of `kernel` and the pattern of its device kernels'
    names, counts/<kernel>.py."""
    return _module(BENCH / "counts" / f"{kernel}.py")


def roofline_pct(tr: Trace, kernel: str):
    """`kernel`'s share of its HBM roofline over the traced steps: the
    bytes its calls need (counts/<kernel>.py) at the peak bandwidth,
    over its device time; None where it did not run, or ran another
    number of calls than its count describes."""
    c = count(kernel)
    t = tr.kernel_s(c.KERNEL_RE)
    if not t or tr.launches.get(kernel) != c.CALLS_PER_STEP * tr.steps:
        return None
    need = c.step_bytes(tr.cell.config["fuser"], tr.cell.mix["robots"])
    return 100.0 * need * tr.steps / tr.peaks["hbm_bytes_per_s"] / t


def read_metrics(tr: Trace) -> dict:
    """Each per-layer metric of the cell from its reader,
    metrics/<name>.py; a reader that returns None is left out."""
    out = {}
    for m in tr.cell.per_layer:
        v = _module(BENCH / "metrics" / f"{m['name']}.py").read(tr)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
