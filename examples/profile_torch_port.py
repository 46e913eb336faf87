"""Where the PyTorch port spends its time on one CUDA card.

    python3 examples/profile_torch_port.py [--scans 80] [--out DIR]
    python3 examples/profile_torch_port.py --offline [--out DIR]

Runs the main path of chip_smoke.py (NDTFeatureGraphSLAM.initialize +
run_sequence_device over the first `--scans` scans of the canonical
fixture, which holds its first node split at scan 76) once to warm up, once
timed without the profiler, and once under torch.profiler.
Prints the device operations ranked by device time, the host operations
ranked by host time, the device busy share (summed kernel time over the
profiled wall time) and the device operations per scan; writes the
tables to DIR/torch_port_profile.txt with `--out DIR`.

With --offline it does the same for optimize_offline on chip_smoke.py's
offline graph (phase 5), and first times its stages one by one, each
ending in a device synchronisation: the RANSAC proposal with the overlap
score, the batched Newton refinement, the rescoring, and the fixpoint
loop of validation and pose-graph solves.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def report(prof, gpu, wall, wall_prof, per, count, out, name):
    """Print and save the profile tables and the busy-share summary."""
    events = prof.key_averages()
    on_dev = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in on_dev)
    launches = sum(e.count for e in on_dev)
    by_dev = events.table(sort_by="self_device_time_total", row_limit=25)
    by_cpu = events.table(sort_by="self_cpu_time_total", row_limit=25)
    summary = {
        "gpu": gpu, per: count, "wall_s": wall,
        "wall_profiled_s": wall_prof,
        "device_busy_s": dev_us * 1e-6,
        "device_busy_share": dev_us * 1e-6 / wall_prof,
        f"device_ops_per_{per[:-1]}": launches / count,
    }
    print(gpu)
    print(by_dev)
    print(by_cpu)
    print(json.dumps(summary))
    if out:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, name), "w") as f:
            f.write(f"{gpu}\n{by_dev}\n{by_cpu}\n{json.dumps(summary)}\n")


def offline(dev, gpu, fx, out):
    """Stage times and the profile of optimize_offline (phase 5)."""
    import time

    from ndt_feature_graph_tpu_torch import pipeline
    from ndt_feature_graph_tpu_torch.graph import links as links_mod
    from ndt_feature_graph_tpu_torch.graph import node as node_mod

    lc = dict(np.load(chip_smoke.LC_FIXTURE))
    sp = chip_smoke.canonical_slam_params(chip_smoke.OFFLINE_SPLIT_M, 64)
    p = sp.fuser
    slam, _ = pipeline.run_slam(sp, chip_smoke.sequence(fx, dev), seed=0,
                                ransac_u=torch.as_tensor(lc["off_scan_u"],
                                                         device=dev))
    before = [t.copy() for t in slam.node_T]

    def reset():
        slam.node_T = [t.copy() for t in before]
        slam.pair_u = [lc["off_pair_u"][0]]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    for rep in range(2):                       # the first one warms up
        reset()
        stages = {}
        bank, stages["stack_nodes"] = timed(
            lambda: node_mod.stack_nodes(slam.nodes))
        budget, stages["source_cell_budget"] = timed(
            lambda: links_mod.source_cell_budget(bank))
        ref, mov, mask = slam.candidate_pairs()
        ls, stages["propose (RANSAC + overlap)"] = timed(
            lambda: links_mod.compute_links_batch(
                p.features, p.ndt.resolution, bank, ref, mov, mask,
                slam._pair_draws(ref.shape[0])))
        ls, stages["refine (batched Newton)"] = timed(
            lambda: links_mod.refine_links_d2d(p.ndt, p.matcher, bank, ls,
                                               src_budget=budget))
        ls, stages["rescore (overlap)"] = timed(
            lambda: links_mod.rescore_links(p.ndt.resolution, bank, ls))
        _, stages["fixpoint (validate + solve)"] = timed(
            lambda: slam.solve_links(ls))
    total = sum(stages.values())
    for k, v in stages.items():
        print(f"  {k}: {v * 1e3:.2f} ms ({100 * v / total:.1f}%)")
    print(f"  total {total * 1e3:.2f} ms")

    reset()
    _, wall = timed(slam.optimize_offline)
    reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_prof = timed(slam.optimize_offline)
    report(prof, gpu, wall, wall_prof, "runs", 1, out,
           "torch_port_offline_profile.txt")
    if out:
        with open(os.path.join(out, "torch_port_offline_stages.json"),
                  "w") as f:
            json.dump({"gpu": gpu, "stages_s": stages}, f, indent=1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scans", type=int, default=80)
    ap.add_argument("--offline", action="store_true",
                    help="profile optimize_offline instead")
    ap.add_argument("--out", help="directory for the profile files")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_port: no CUDA device")
    dev = torch.device("cuda", 0)
    gpu = chip_smoke.gpu_line()
    fx = dict(np.load(chip_smoke.FIXTURE))
    if args.offline:
        return offline(dev, gpu, fx, args.out)
    sp = chip_smoke.canonical_slam_params(float(fx["split_m"]),
                                          int(fx["max_nodes"]))
    for k in ("ranges", "hit", "odom", "gt"):
        fx[k] = fx[k][:args.scans]
    fx["ransac_u"] = fx["ransac_u"][:args.scans - 1]
    scans = fx["ranges"].shape[0] - 1

    chip_smoke.run_main_path(sp, fx, dev)                  # warm-up
    _, wall = chip_smoke.run_main_path(sp, fx, dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_prof = chip_smoke.run_main_path(sp, fx, dev)

    report(prof, gpu, wall, wall_prof, "scans", scans, args.out,
           "torch_port_profile.txt")


if __name__ == "__main__":
    main()
