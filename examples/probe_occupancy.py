"""Phase split of the occupancy update (`cuda_kernels.update_occupancy`,
csrc/occupancy.cu) on one CUDA card.

    python3 examples/probe_occupancy.py [--split | --stages] [--out DIR]

The cases are chip_smoke.py phase 3e's: canonical scan 2's occupancy
update (720 points x 48 samples at the ground-truth pose) on the map of
scan 0, into one 200 x 200 grid ("one scan") and into a stack of 64
("B=64").  `--split`: for each case and each path, the wrapper's own
(one cluster launch a stream where its counters fit) and the two-pass
path (a count launch into a global counter buffer, then a row launch;
forced by chip_smoke.occupancy_forced(0)), it prints the device µs a
call of each kernel by name (torch.profiler) on a warm L2 and on a
cold one (a read-modify-write of chip_smoke.L2_FLUSH_BYTES before each
call; the flush's own kernels left out), and the whole call's µs by
CUDA events, warm and cold.  Each path's output is first held to the
CPU's bits.

`--stages` rebuilds the library with -DNDTG_STAGE_PROBE (under
build/probe_kernels/, the build of examples/probe_feature_stages.py
--stages) and reads the cluster kernel's NDTG_STAGE stamps (each
block's SM clock and the global timer at the end of each phase: the
counters zeroed, the counts (with the wait for the other blocks'
zeroing), the cluster barrier, the rows), for each case once after a
warm-up: each phase's mean and largest µs over the blocks, the spread
of the blocks' first stamps and the time from the first block's first
stamp to the last block's last.  With
neither flag both run, `--split` first.

One JSON line per reading; with --out DIR also DIR/probe_occupancy.jsonl.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from ndt_feature_graph_tpu_torch.ops import cuda_kernels, ndt_map  # noqa: E402

PROBE_BLOCKS, PROBE_STAGES = 4096, 16     # csrc/stage_probe.cuh's arrays


def cases(dev):
    """{name: (params, grid, (points, mask, sensor))}: phase 3e's."""
    fx = dict(np.load(chip_smoke.FIXTURE))
    mp = chip_smoke.canonical_slam_params(float(fx["split_m"]),
                                          int(fx["max_nodes"])).fuser.ndt
    out = {}
    for name, streams in (("one scan", 0), ("B=64", 64)):
        lead = (streams,) if streams else ()
        grid = chip_smoke.map_update(ndt_map.empty_grid(mp, torch.zeros(
            lead + (2,), device=dev)), mp, *chip_smoke.world_scan(
                fx, 0, dev, streams))
        out[name] = (mp, grid, chip_smoke.world_scan(fx, 2, dev, streams))
    return out


def by_name(fn, before=None, reps=50):
    """{kernel name: (launches, device µs)} a call, from one profile of
    `reps` calls; `before` runs ahead of each call and its own device
    operations (by name) are left out."""
    from torch.profiler import ProfilerActivity, profile

    skip = set()
    if before is not None:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            before()
            torch.cuda.synchronize()
        skip = {e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA}
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.name in skip:
            continue
        n, us = out.get(e.name, (0, 0.0))
        out[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return {k: (n / reps, us / reps) for k, (n, us) in out.items()}


def split(case, mp, grid, scan, path, emit):
    world, mask, sensor = scan

    def call():
        return cuda_kernels.update_occupancy(grid, mp, sensor, world, mask)

    want = ndt_map.update_occupancy(
        chip_smoke.node_mod.map_tensors(torch.Tensor.cpu, grid), mp,
        sensor.cpu(), world.cpu(), mask.cpu()).occ
    got = call().occ.cpu()
    off = int((chip_smoke._bits(got.numpy())
               != chip_smoke._bits(want.numpy())).sum())
    chip_smoke.check(off == 0, f"{case}, {path}: {off} elements off the "
                               "CPU's bits")
    buf = torch.ones(chip_smoke.L2_FLUSH_BYTES // 4, device=grid.occ.device)

    def flush():
        buf.add_(1.0)

    warm = by_name(call)
    cold = by_name(call, flush)
    emit({"case": case, "path": path,
          "cluster": chip_smoke.occupancy_blocks(
              mp, mask, mask.numel() // mask.shape[-1]),
          "warm_us_by_kernel": {k: us for k, (_, us) in warm.items()},
          "cold_us_by_kernel": {k: us for k, (_, us) in cold.items()},
          "launches_by_kernel": {k: n for k, (n, _) in warm.items()},
          "warm_events_us": chip_smoke.time_ms(call) * 1e3,
          "cold_events_us": chip_smoke.cold_ms(call, flush) * 1e3})


def stages(all_cases, emit):
    """The cluster kernel's phase stamps in a probe build."""
    cuda_kernels.NVCC_FLAGS = [*cuda_kernels.NVCC_FLAGS, "-DNDTG_STAGE_PROBE"]
    cuda_kernels.BUILD_DIR = pathlib.Path(ROOT) / "build" / "probe_kernels"
    cuda_kernels._lib = None
    lib = cuda_kernels.build()
    lib.ndtg_occupancy_probe_read.argtypes = [cuda_kernels.ctypes.c_void_p] * 2
    lib.ndtg_occupancy_probe_read.restype = cuda_kernels.ctypes.c_int
    clock = np.zeros(PROBE_BLOCKS * PROBE_STAGES, np.int64)
    ns = np.zeros(PROBE_BLOCKS * 2, np.int64)
    names = {1: "zero the counters", 2: "count", 3: "cluster barrier",
             4: "row"}

    def read():
        err = lib.ndtg_occupancy_probe_read(clock.ctypes.data,
                                            ns.ctypes.data)
        chip_smoke.check(err == 0, f"probe read failed: {err}")
        return (clock.reshape(PROBE_BLOCKS, PROBE_STAGES).copy(),
                ns.reshape(PROBE_BLOCKS, 2).copy())

    for case, (mp, grid, (world, mask, sensor)) in all_cases.items():
        def call():
            return cuda_kernels.update_occupancy(grid, mp, sensor, world,
                                                 mask)

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        read()
        call()
        torch.cuda.synchronize()
        clk, t_ns = read()
        live = clk[:, 0] != 0
        clk, t_ns = clk[live], t_ns[live]
        span_ns = t_ns[:, 1] - t_ns[:, 0]
        ghz = float((clk[:, 4] - clk[:, 0]).sum() / max(span_ns.sum(), 1))
        phases = []
        for k in sorted(names):
            d = (clk[:, k] - clk[:, k - 1]).astype(np.float64)
            phases.append({"phase": names[k],
                           "mean_us": float(d.mean()) / ghz / 1e3,
                           "max_us": float(d.max()) / ghz / 1e3})
        emit({"case": case, "blocks": int(live.sum()),
              "cycles_per_ns": ghz,
              "span_mean_us": float(span_ns.mean()) / 1e3,
              "span_max_us": float(span_ns.max()) / 1e3,
              "start_skew_us": float(t_ns[:, 0].max() - t_ns[:, 0].min())
              / 1e3,
              "first_start_to_last_end_us":
                  float(t_ns[:, 1].max() - t_ns[:, 0].min()) / 1e3,
              "phases": phases})


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--stages", action="store_true")
    ap.add_argument("--out", help="directory for the JSON lines")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_occupancy: no CUDA device")
    dev = torch.device("cuda", 0)
    out = None
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        out = open(os.path.join(args.out, "probe_occupancy.jsonl"), "a")
    head = {"tree": ROOT, "gpu": chip_smoke.gpu_line()}

    def emit(rec):
        line = json.dumps({**head, **rec})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    all_cases = cases(dev)
    if args.split or not args.stages:
        for case, (mp, grid, scan) in all_cases.items():
            split(case, mp, grid, scan, "wrapper's own", emit)
            with chip_smoke.occupancy_forced(0):
                split(case, mp, grid, scan, "two-pass", emit)
    if args.stages or not args.split:
        stages(all_cases, emit)


if __name__ == "__main__":
    main()
