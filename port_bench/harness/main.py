"""One run of a cell: set-up (traffic, the port's states, the warm
chunks), the measured window, the check against the reference, one JSON
line.

With --trace 0 the line holds the cell's end-to-end metrics; with
--trace 1 a few more chunks run under the profiler after the window, and
the line holds the per-layer metrics, the device's busy time and the
breakdown.  Every run checks what it served and prints each compared
number beside its limit, last on standard error and last in the line.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from port_bench.harness import cell as cell_mod
from port_bench.harness import check, serve, trace

JAX_NAMES = {"jax", "jaxlib", "flax", "ndt_feature_graph_tpu"}


def p95(values) -> float:
    """The 95th percentile by nearest rank: the smallest value with at
    least 95% of the values at or under it."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def jax_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & JAX_NAMES)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def warm(server, states):
    """The warm chunks: every shape the window serves, built and run.
    Returns (states, the first chunk's Checked, the last chunk's
    seconds)."""
    first = None
    before = server.sampled(states)
    for c in range(server.cell.mix["warm_chunks"]):
        t0 = time.perf_counter()
        states, traj, scores = server.chunk(states, c)
        poses = traj.cpu()
        chunk_s = time.perf_counter() - t0
        if c == 0:
            first = server.checked(0, before, states, poses, scores)
    return states, first, chunk_s


def execute(cell, seed: int, seconds: float, traced: bool, t_start,
            device, server_cls=serve.Server):
    """A run of `cell` on `device` after the look for a card: the result
    line's object.  On the CPU (the harness's tests) the memory reading
    is 0 and the device is named "cpu"."""
    on_card = device.type == "cuda"
    t0 = time.perf_counter()
    server = server_cls(cell, seed, device)
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t1 = time.perf_counter()
    states = server.initial_states()
    if on_card:
        torch.cuda.synchronize(device)
    t2 = time.perf_counter()
    states, first, chunk_s = warm(server, states)
    t3 = time.perf_counter()
    setup_s = t3 - t_start
    print(f"set-up {setup_s:.3f} s: start {t0 - t_start:.3f}, traffic "
          f"{t1 - t0:.3f}, states {t2 - t1:.3f}, warm chunks {t3 - t2:.3f}",
          file=sys.stderr)

    c0 = cell.mix["warm_chunks"]
    checks = server.plan_checks(c0, seconds, chunk_s)
    states, win = serve.serve(server, states, c0, seconds, checks)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    tr = None
    if traced:
        states, tr = trace.profile(server, states, c0 + win.chunks, cell,
                                   sum(win.host_s), win.chunks * server.k)
    inputs = check.Inputs(server)
    del states, server
    if on_card:
        torch.cuda.empty_cache()
    t4 = time.perf_counter()
    gaps = check.compare(cell.config, inputs, win, first)
    print(f"window {win.seconds:.3f} s, {win.chunks} chunks; check "
          f"{time.perf_counter() - t4:.3f} s", file=sys.stderr)
    correct, rows = check.verdict(gaps, cell.limits)
    correct = correct and win.bad_poses == 0

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    if tr is None:
        metrics = {
            "scans_per_s": win.scans / win.seconds,
            "latency_ms_p95": 1e3 * p95(win.latency_s),
            "peak_mem_gib": peak / 2 ** 30,
            "setup_s": setup_s}
        # `<metric>.<tag>` is <metric> again, under a bound of its own
        # for the cells it lists.
        metrics = {m["name"]: {"value": metrics[m["name"].split(".")[0]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    else:
        metrics = trace.read_metrics(tr)
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
    out = {"correct": correct, "attempted": win.scans,
           "failed": win.bad_poses, "metrics": metrics, "device": dev}
    if tr is not None:
        out["breakdown"] = trace.breakdown(tr)
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return out


def main(argv, t_start) -> int:
    args = parse(argv)
    cell = cell_mod.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < (
            cell.chips):
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = execute(cell, args.seed, args.seconds, bool(args.trace), t_start,
                  torch.device("cuda"))
    found = jax_modules()
    if found:
        print("loaded in this process: " + ", ".join(found), file=sys.stderr)
        return 3
    for n, c in out["checks"].items():
        print(f"{n} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
