"""Where the PyTorch port spends its time on one CUDA card.

    python3 examples/profile_torch_port.py [--scans 80] [--out DIR]
    python3 examples/profile_torch_port.py --offline [--out DIR]
    python3 examples/profile_torch_port.py --wall-only [--runs 5] [--tree DIR]
    python3 examples/profile_torch_port.py --fleet B [--full] [--out DIR]
    python3 examples/profile_torch_port.py --solver [--out DIR]
    python3 examples/profile_torch_port.py --localize [--out DIR]
    python3 examples/profile_torch_port.py --map-update [--scans 80] [--tree DIR]
    python3 examples/profile_torch_port.py --sixdof [--out DIR]

Runs the main path of chip_smoke.py (NDTFeatureGraphSLAM.initialize +
run_sequence_device over the first `--scans` scans of the canonical
fixture, which holds its first node split at scan 76) once to warm up, once
timed without the profiler, and once under torch.profiler.
Prints the device operations ranked by device time, the host operations
ranked by host time, the device busy share (summed kernel time over the
profiled wall time), the device operations per scan, the Newton trials
per scan (the `trials` that `newton_solve` returns: each registration
is one launch) and one registration of chip_smoke.py's phase 3 timed in
turns (the kernel, the per-trial path the fuser ran before — d2d.newton_match
over `newton_objective` —, the per-trial path, the kernel): ms a
registration with the host and the device operations of each; writes
the tables to DIR/torch_port_profile.txt with `--out DIR`.  Every
profile's summary also gives the map update's device time and share:
the "map_update" range (ndt_map.add_points_touched, update_occupancy),
the "map_occupancy" range (update_occupancy alone) and the
"map_scatter" range (ndt_map.scatter_add_rows), each the device time of
the operations inside it plus the hand-written kernels' that it runs
(the segment sum's, the occupancy kernel's launch), which
torch.profiler sees outside any operation (ctypes launches); and the
"features" range (feature_fuser._prepare_features: a scan's, or a fleet
step's, feature front end), its device time and share with the three
feature kernels, and its device operations a scan (or step).

With --wall-only it runs the main path `--runs` times after a warm-up
without the profiler (which takes minutes over 200 scans) and prints the
wall times and scans/s.  `--tree DIR` takes chip_smoke.py and the port
from another checkout (say, the parent commit unpacked under build/), so
that two versions can be timed in turns inside one call; only
--wall-only is sure to work against an older tree.

With --fleet B it profiles the fleet path of chip_smoke.py's phase 7:
scan_driver.run_sequence_batch (with --full, run_sequence_features_batch)
over B streams of the fleet record's 39 scans at presets.fleet_serving():
device operations per fleet step, Newton trials per step (from the
`trials` that `newton_solve_batch` returns: the slowest lane's, which
the masked lockstep would run, and the lanes' mean), the busy share,
the aggregate scans/s of the unprofiled run and the device time by
operation.

With --solver it profiles the segment-Schur solve of chip_smoke.py's
phase 9 (sparse_direct.optimize_direct on the 570-node multi-loop graph,
the 4,000-node two-lap graph of the solver record and the 10,000-node
two-lap recipe): per graph the unprofiled wall of a solve, the device
operations per LM iteration, the busy share and the device time by
operation.

With --localize it profiles the MCL tracking of chip_smoke.py's phase
10 (512 particles over the canonical sequence's second half, on the
localization record's draws): device operations per step, the busy
share, steps/s of the unprofiled run and the device time by operation.

With --map-update it times the map update's kernels (the statistics
through ndt_map.scatter_add_rows, the segment_add_rows kernel; the
occupancy through the occupancy_update kernel) against the parent's
path (the occupancy through its plain twin,
ndt_map._update_occupancy_plain, and so through segment_add_rows) and
the atomic `index_add` (both scatters, the occupancy through its plain
twin), in turns (kernel, parent, atomic, atomic, parent, kernel) inside
one process: chip_smoke.py phase 3e (one scan's map update and a B = 64
step's, device time) and the main path's scans/s over `--scans` scans
(the median of 3 runs after a warm-up per turn), then the same for the
fleet at B = 64: one fleet step's map update over the stack of 64 grids
and the points-only fleet's aggregate scans/s (chip_smoke.py phase 7).

With --sixdof it profiles one 6-DoF registration of chip_smoke.py's
phase 14a (match_d2d_3d of the second of its links at the full padded
cell lists, 1,024 x 1,024 pairs): the wall and peak memory of a
registration in chunks of 2^18 pairs and in one chunk of 2^20 (the
ops/d2d3d.py PAIR_CHUNK), in turns, then, at PAIR_CHUNK, the device
operations per trial, the busy share and the device time by operation.

With --offline it does the same for optimize_offline on chip_smoke.py's
offline graph (phase 5), and first times its stages one by one, each
ending in a device synchronisation: the RANSAC proposal with the overlap
score, the batched Newton refinement, the rescoring, and the fixpoint
loop of validation and pose-graph solves.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if "--tree" in sys.argv:                # before chip_smoke is imported
    ROOT = os.path.abspath(sys.argv[sys.argv.index("--tree") + 1])
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


# annotated_map_update's ranges
RANGES = ("map_update", "map_scatter", "map_occupancy", "features")


@contextlib.contextmanager
def annotated_map_update():
    """The map update's functions inside profiler ranges: "map_update"
    around ndt_map.add_points_touched and update_occupancy,
    "map_occupancy" around update_occupancy alone, "map_scatter" around
    ndt_map.scatter_add_rows (the fixed-order sum: the kernel's two
    passes, an older tree's sort and kernel, or its sorted index_put_
    path; since the occupancy kernel only the statistics' on the card),
    so a profile reads their share of device time, whichever tree it
    runs; and "features" around feature_fuser._prepare_features, a
    scan's feature front end (the scan's points, detect, describe, RANSAC,
    the odometry gate and the pseudo-cells: the three feature kernels,
    or a parent tree's eager operations)."""
    from torch.profiler import record_function

    from ndt_feature_graph_tpu_torch.fusion import feature_fuser
    from ndt_feature_graph_tpu_torch.ops import ndt_map

    names = {"add_points_touched": ("map_update",),
             "update_occupancy": ("map_update", "map_occupancy"),
             "scatter_add_rows": ("map_scatter",),
             "_prepare_features": ("features",)}
    saved = {(mod, k): getattr(mod, k)
             for mod in (ndt_map, feature_fuser) for k in names
             if hasattr(mod, k)}

    def ranged(fn, ranges):
        def call(*args, **kwargs):
            with contextlib.ExitStack() as stack:
                for name in ranges:
                    stack.enter_context(record_function(name))
                return fn(*args, **kwargs)
        return call

    for (mod, k), fn in saved.items():
        setattr(mod, k, ranged(fn, names[k]))
    try:
        yield
    finally:
        for (mod, k), fn in saved.items():
            setattr(mod, k, fn)


def device_ops(prof):
    """(operations on the device, their summed time in us) of a profile;
    the device-side spans of annotated_map_update's ranges are no
    operations."""
    on_dev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.key not in RANGES]
    return (sum(e.count for e in on_dev),
            sum(e.self_device_time_total for e in on_dev))


def range_ops(prof, name):
    """Device operations launched by the operations inside the CPU range
    `name` (ATen's kernels, copies and memsets; the hand-written kernels,
    which no operation owns, are counted apart)."""
    n = 0
    for e in prof.events():
        if e.name != name or e.device_type != torch.autograd.DeviceType.CPU:
            continue
        stack = list(e.cpu_children)
        while stack:
            c = stack.pop()
            n += len(c.kernels)
            stack.extend(c.cpu_children)
    return n


def registration_turns(sp, fx, dev, reps=50):
    """One registration of chip_smoke.py's phase 3 case (256 source
    cells, 64 feature pairs, odometry), the kernel (`newton_solve`) and
    the per-trial path (d2d.newton_match over `newton_objective`) in
    turns: kernel, per-trial, per-trial, kernel, each the mean ms of
    `reps` registrations ending in a synchronisation; then the device
    operations and device us of a registration of each (the means of
    20 under the profiler)."""
    from ndt_feature_graph_tpu_torch.ops import cuda_kernels, d2d

    p = sp.fuser
    state, src, T0, Q, _, fs, ft = chip_smoke.trial_case(sp, fx, dev)
    args = (src.head(p.match_cell_budget), state.packed, state.grid.origin,
            p.ndt.grid_h, p.ndt.grid_w, p.ndt.resolution, p.matcher, fs, ft,
            Q)
    zero = torch.zeros(3, device=dev)
    kernel = lambda: cuda_kernels.newton_solve(zero, T0, *args)  # noqa
    per = lambda: d2d.newton_match(  # noqa: E731
        lambda d: cuda_kernels.newton_objective(d, T0, *args), zero,
        p.matcher)

    def wall(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    def ops(fn, n=20):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        launches, us = device_ops(prof)
        return launches / n, us / n

    turns = [wall(kernel), wall(per), wall(per), wall(kernel)]
    (k_ops, k_us), (p_ops, p_us) = ops(kernel), ops(per)
    out = {"turns_ms_kernel_per_per_kernel": turns,
           "kernel_device_ops": k_ops, "kernel_device_us": k_us,
           "per_trial_device_ops": p_ops, "per_trial_device_us": p_us,
           "trials": int(kernel()[2]), "per_trial_trials": int(per()[2])}
    print(json.dumps({"registration": out}))
    return out


def report(prof, gpu, wall, wall_prof, per, count, out, name, extra=None):
    """Print and save the profile tables and the busy-share summary."""
    events = prof.key_averages()
    launches, dev_us = device_ops(prof)
    by_dev = events.table(sort_by="self_device_time_total", row_limit=25)
    by_cpu = events.table(sort_by="self_cpu_time_total", row_limit=25)
    summary = {
        "gpu": gpu, per: count, "wall_s": wall,
        "wall_profiled_s": wall_prof,
        "device_busy_s": dev_us * 1e-6,
        "device_busy_share": dev_us * 1e-6 / wall_prof,
        f"device_ops_per_{per[:-1]}": launches / count,
        **(extra or {}),
    }
    # The map update's device time: the device time of the operations
    # inside its CPU-side ranges, plus the hand-written kernels inside
    # it, which the profiler attributes to no operation (ctypes
    # launches): the segment sum's (of one channel: a parent tree's
    # occupancy scatter; of more: the statistics') and the occupancy
    # kernel's (one cluster launch, or its two passes); the feature kernels' (by name, wherever they
    # ran: the first scan's detect and describe run in initialize) belong
    # to "features".
    own = {"stats": 0.0, "occ": 0.0, "feat": 0.0}
    feat_launches = 0
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "segment_add_rows" in e.key:
            own["occ" if "kernel<1>" in e.key else "stats"] += (
                e.self_device_time_total)
        elif "occupancy_" in e.key:
            own["occ"] += e.self_device_time_total
        elif "features_" in e.key:
            own["feat"] += e.self_device_time_total
            feat_launches += e.count
    parts = {RANGES[0]: ("stats", "occ"), RANGES[1]: ("stats",),
             RANGES[2]: ("occ",), RANGES[3]: ("feat",)}
    # A parent tree's occupancy scatter runs inside "map_scatter" too.
    if any("kernel<1>" in e.key for e in events):
        parts[RANGES[1]] = ("stats", "occ")
    for e in events:
        if (e.key in RANGES
                and e.device_type == torch.autograd.DeviceType.CPU):
            us = e.device_time_total + sum(own[k] for k in parts[e.key])
            summary[f"{e.key}_device_us"] = us
            summary[f"{e.key}_share"] = us / dev_us
    summary[f"features_device_ops_per_{per[:-1]}"] = (
        range_ops(prof, "features") + feat_launches) / count
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


def fleet(dev, gpu, b, full, out):
    """The profile of one fleet run of `b` streams (phase 7 / 7b)."""
    from ndt_feature_graph_tpu_torch.fusion import scan_driver
    from ndt_feature_graph_tpu_torch.models import presets
    from ndt_feature_graph_tpu_torch.ops import cuda_kernels
    from ndt_feature_graph_tpu_torch.parallel import scaling

    fl = dict(np.load(chip_smoke.FLEET_FIXTURE))
    fp = presets.fleet_serving()
    seq = chip_smoke.sequence(fl, dev)
    kw = {}
    if full:
        drv = scan_driver.run_sequence_features_batch
        inputs = scaling.build_fleet_feature_inputs(fp, seq, b)
        kw["ransac_u"] = torch.as_tensor(
            np.resize(fl["ransac_u"], (b, *fl["ransac_u"].shape[1:])),
            device=dev)
    else:
        drv = scan_driver.run_sequence_batch
        inputs = scaling.build_fleet_inputs(fp, seq, b)
    steps = inputs[1].shape[1]
    chip_smoke.run_fleet(drv, fp, inputs, dev, **kw)       # warm-up
    cuda_kernels.reset_launch_counts()
    with chip_smoke.recorded_solves("newton_solve_batch",
                                    copy=False) as (calls, _):
        _, wall = chip_smoke.run_fleet(drv, fp, inputs, dev, **kw)
    trials = torch.stack([out[2] for _, out in calls]).double()
    launches = cuda_kernels.LAUNCHES["newton_solve_batch"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_prof = chip_smoke.run_fleet(drv, fp, inputs, dev, **kw)
    name = f"torch_port_fleet_{'full_' if full else ''}b{b}_profile.txt"
    report(prof, gpu, wall, wall_prof, "steps", steps, out, name,
           {"streams": b, "driver": drv.__name__,
            "aggregate_scans_per_s": b * steps / wall,
            "newton_solve_batch_per_step": launches / steps,
            "newton_trials_per_step_slowest_lane":
                float(trials.amax(1).mean()),
            "newton_trials_per_step_mean_lane": float(trials.mean())})


def solver(dev, gpu, out):
    """The profile of one optimize_direct solve per phase-9 graph."""
    sv = dict(np.load(chip_smoke.SOLVER_FIXTURE))
    ml = chip_smoke.multi_loop_graph(chip_smoke.MULTI_LOOP["n_nodes"])
    big = chip_smoke.two_lap_graph(chip_smoke.TWO_LAP_BIG)[1:]
    cases = {
        "570": (ml, chip_smoke.MULTI_LOOP),
        "4000": ([sv["tl_" + k] for k in ("init", "i", "j", "meas",
                                           "info")], chip_smoke.TWO_LAP),
        str(chip_smoke.TWO_LAP_BIG): (big, chip_smoke.TWO_LAP),
    }
    for name, ((init, i, j, meas, info), cfg) in cases.items():
        edges = chip_smoke.solver_edges(i, j, meas, info, dev)
        p0 = torch.as_tensor(init, device=dev)
        kw = {k: v for k, v in cfg.items()
              if k in ("iterations", "robust_kernel")}

        def solve():
            t0 = time.perf_counter()
            chip_smoke.direct_solve(p0, edges, cfg["max_seg_len"], **kw)
            return time.perf_counter() - t0

        solve()                                          # warm-up
        wall = solve()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall_prof = solve()
        print(f"== {name} nodes")
        report(prof, gpu, wall, wall_prof, "iterations", kw["iterations"],
               out, f"torch_port_solver_{name}_profile.txt",
               {"nodes": len(init), "edges": len(i)})


def localize(dev, gpu, fx, out):
    """The profile of phase 10's MCL tracking run."""
    from ndt_feature_graph_tpu_torch.config import MotionParams
    from ndt_feature_graph_tpu_torch.io import dataset
    from ndt_feature_graph_tpu_torch.localization import mcl
    from ndt_feature_graph_tpu_torch.ops import d2d, ndt_map

    lx = dict(np.load(chip_smoke.LOCALIZE_FIXTURE))
    mp = chip_smoke.canonical_slam_params().fuser.ndt
    T = lambda x, dt=torch.float32: torch.as_tensor(  # noqa: E731
        x, dtype=dt, device=dev)
    ranges, hit = T(fx["ranges"]), T(fx["hit"], torch.bool)
    odom, gt = T(fx["odom"]), T(fx["gt"])
    grid = ndt_map.empty_grid(mp, torch.zeros(2, device=dev))
    for t in lx["map_scans"]:
        pts, mask = dataset.scan_to_points(ranges[t], hit[t])
        world = chip_smoke.se2.transform_points(gt[t], pts)
        grid = ndt_map.add_points(grid, mp, world, mask)
        grid = ndt_map.update_occupancy(grid, mp, gt[t][:2], world, mask)
    tgt = d2d.make_dense_target(grid, mp)
    draws = mcl.recorded_draws(T(lx["mcl_init_xy"]), T(lx["mcl_init_theta"]),
                               T(lx["mcl_noise"]), lx["mcl_resampled"],
                               T(lx["mcl_u0"]))
    split = int(lx["split"])
    steps = ranges.shape[0] - split - 1

    def track():
        chip_smoke.sync(dev)
        t0 = time.perf_counter()
        loc = mcl.MCL(mp, MotionParams(), tgt,
                      n_particles=int(lx["particles"]), draws=draws)
        loc.initialize(gt[split], spread_xy=0.5, spread_theta=0.2)
        for t in range(split + 1, ranges.shape[0]):
            loc.step(odom[t], *dataset.scan_to_points(ranges[t], hit[t]))
        chip_smoke.sync(dev)
        return time.perf_counter() - t0

    track()                                                # warm-up
    wall = track()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof = track()
    report(prof, gpu, wall, wall_prof, "steps", steps, out,
           "torch_port_localize_profile.txt",
           {"particles": int(lx["particles"]), "steps_per_s": steps / wall})


def sixdof(dev, gpu, out):
    """Phase 14a's second link: chunk sizes in turns, then a profile."""
    from ndt_feature_graph_tpu_torch.ops import d2d3d

    lc = dict(np.load(chip_smoke.LC_FIXTURE))
    sx = dict(np.load(chip_smoke.SIXDOF_FIXTURE))
    k = 1
    li = int(sx["links"][k])
    m = chip_smoke.canonical_slam_params(chip_smoke.OFFLINE_SPLIT_M,
                                         64).fuser.matcher

    def cells(n):
        c = chip_smoke.lift_cells(lc["off_bank.cells.means"][n],
                                  lc["off_bank.cells.covs"][n],
                                  lc["off_bank.cells.mask"][n])
        return d2d3d.CellList3D(**{f: torch.as_tensor(v, device=dev)
                                   for f, v in c.items()})

    tgt, src = cells(lc["off_link_ref"][li]), cells(lc["off_link_mov"][li])
    T0 = torch.as_tensor(sx["T_init"][k], device=dev)

    def register():
        chip_smoke.sync(dev)
        t0 = time.perf_counter()
        res = d2d3d.match_d2d_3d(tgt, src, T0, m)
        chip_smoke.sync(dev)
        return res, time.perf_counter() - t0

    default = d2d3d.PAIR_CHUNK
    register()                                             # warm-up
    turns = []
    for chunk in (1 << 18, 1 << 20, 1 << 20, 1 << 18):
        d2d3d.PAIR_CHUNK = chunk
        torch.cuda.reset_peak_memory_stats(dev)
        res, wall = register()
        turns.append({"pair_chunk": chunk, "wall_s": wall,
                      "peak_mib": torch.cuda.max_memory_allocated(dev)
                      / 2 ** 20, "trials": int(res.iterations)})
        print(json.dumps(turns[-1]))
    d2d3d.PAIR_CHUNK = default
    res, wall = register()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_prof = register()
    trials = int(res.iterations)
    report(prof, gpu, wall, wall_prof, "trials", trials, out,
           "torch_port_sixdof_profile.txt",
           {"link": li, "pairs": src.means.shape[0] * tgt.means.shape[0],
            "turns": turns, "note": "two derivative evaluations beyond "
            "the trials: the start and the covariance's Hessian"})


def map_update(dev, gpu, sp, fx):
    """The map update's kernels against the parent's path (the occupancy
    through its plain twin) and the atomic index_add, in turns: one
    scan's map update (chip_smoke.py phase 3e) and the main path, then
    one fleet step's map update over the stack of B = 64 grids and the
    points-only fleet's aggregate scans/s at B = 64 (phase 7)."""
    from ndt_feature_graph_tpu_torch.core import se2
    from ndt_feature_graph_tpu_torch.fusion import scan_driver
    from ndt_feature_graph_tpu_torch.io import dataset
    from ndt_feature_graph_tpu_torch.models import presets
    from ndt_feature_graph_tpu_torch.ops import ndt_map
    from ndt_feature_graph_tpu_torch.parallel import scaling

    def path(name):
        """The map update's version `name`, swapped in by a context."""
        stack = contextlib.ExitStack()
        if name != "kernel":
            stack.enter_context(chip_smoke.occupancy_plain())
        if name == "atomic":
            stack.enter_context(
                chip_smoke.scatter_swapped(chip_smoke.atomic_scatter))
        return stack

    names = ("kernel", "parent", "atomic", "atomic", "parent", "kernel")
    unit = chip_smoke.map_update_phase(sp, fx, dev)[0]
    scans = fx["ranges"].shape[0] - 1
    turns = []
    for name in names:
        with path(name):
            chip_smoke.run_main_path(sp, fx, dev)          # warm-up
            walls = [chip_smoke.run_main_path(sp, fx, dev)[1]
                     for _ in range(3)]
        turns.append((name, scans / sorted(walls)[1], walls))
        print(f"  main path, {name} path: {turns[-1][1]:.2f} scans/s "
              f"(median of {', '.join(f'{w:.3f}' for w in walls)} s)")

    fl = dict(np.load(chip_smoke.FLEET_FIXTURE))
    fp = presets.fleet_serving()
    b = chip_smoke.FLEET_SIZES[-1]
    T = lambda x, dt=torch.float32: torch.as_tensor(  # noqa: E731
        x, dtype=dt, device=dev)
    pts, mask = dataset.scan_to_points(T(fl["ranges"][2]),
                                       T(fl["hit"][2], torch.bool))
    world = se2.transform_points(T(fl["gt"][2]), pts)
    world = torch.stack([world + 0.37 * k for k in range(b)])
    mask, sensor = mask.expand(b, -1), T(fl["gt"][2][:2]).expand(b, 2)
    grid = ndt_map.empty_grid(fp.ndt, sensor)

    def ordered():
        g, _ = ndt_map.add_points_touched(grid, fp.ndt, world, mask)
        return ndt_map.update_occupancy(g, fp.ndt, sensor, world, mask)

    def atomic():
        with path("atomic"):
            return ordered()

    def parent():
        with path("parent"):
            return ordered()

    print(f"  one fleet step's map update over {b} grids of "
          f"{fp.ndt.grid_h}x{fp.ndt.grid_w} cells, the kernels vs the "
          "parent's path and vs the atomic index_add:")
    t_p = chip_smoke.time_turns(ordered, parent, 20, 20, label="parent")
    t = chip_smoke.time_turns(ordered, atomic, 20, 20, label="atomic")
    fleet_unit = {"ordered_us": (t["ms"] + t_p["ms"]) / 2 * 1e3,
                  "parent_us": t_p["plain_ms"] * 1e3,
                  "atomic_us": t["plain_ms"] * 1e3}
    seq = chip_smoke.sequence(fl, dev)
    inputs = scaling.build_fleet_inputs(fp, seq, b)
    drv = scan_driver.run_sequence_batch
    fleet_turns = []
    for name in names:
        with path(name):
            chip_smoke.run_fleet(drv, fp, inputs, dev)     # warm-up
            rate, walls = chip_smoke.fleet_rate(drv, fp, inputs, dev)
        fleet_turns.append((name, rate, walls))
        print(f"  fleet B={b}, {name} path: {rate:.1f} aggregate "
              f"scans/s (median of {', '.join(f'{w:.3f}' for w in walls)}"
              " s)")
    print(json.dumps({"gpu": gpu, "tree": ROOT, "scans": scans,
                      "map_update": unit, "main_path_turns": turns,
                      f"fleet_b{b}_map_update": fleet_unit,
                      f"fleet_b{b}_turns": fleet_turns}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scans", type=int, default=80)
    ap.add_argument("--offline", action="store_true",
                    help="profile optimize_offline instead")
    ap.add_argument("--solver", action="store_true",
                    help="profile the segment-Schur solves of phase 9")
    ap.add_argument("--fleet", type=int, metavar="B",
                    help="profile a fleet run of B streams instead")
    ap.add_argument("--full", action="store_true",
                    help="with --fleet: the full feature pipeline")
    ap.add_argument("--wall-only", action="store_true",
                    help="time the main path without the profiler")
    ap.add_argument("--runs", type=int, default=5,
                    help="timed runs of --wall-only")
    ap.add_argument("--tree", help="checkout to take chip_smoke.py and "
                    "the port from (default: this one)")
    ap.add_argument("--localize", action="store_true",
                    help="profile phase 10's MCL tracking instead")
    ap.add_argument("--map-update", action="store_true",
                    help="time the fixed-order map scatter against the "
                    "atomic one, in turns")
    ap.add_argument("--sixdof", action="store_true",
                    help="profile a 6-DoF registration of phase 14a")
    ap.add_argument("--out", help="directory for the profile files")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_port: no CUDA device")
    with annotated_map_update():
        run(args)


def run(args):
    dev = torch.device("cuda", 0)
    gpu = chip_smoke.gpu_line()
    if args.fleet:
        return fleet(dev, gpu, args.fleet, args.full, args.out)
    if args.solver:
        return solver(dev, gpu, args.out)
    if args.sixdof:
        return sixdof(dev, gpu, args.out)
    fx = dict(np.load(chip_smoke.FIXTURE))
    if args.offline:
        return offline(dev, gpu, fx, args.out)
    if args.localize:
        return localize(dev, gpu, fx, args.out)
    sp = chip_smoke.canonical_slam_params(float(fx["split_m"]),
                                          int(fx["max_nodes"]))
    for k in ("ranges", "hit", "odom", "gt"):
        fx[k] = fx[k][:args.scans]
    fx["ransac_u"] = fx["ransac_u"][:args.scans - 1]
    scans = fx["ranges"].shape[0] - 1
    if args.map_update:
        return map_update(dev, gpu, sp, fx)

    if args.wall_only:
        chip_smoke.run_main_path(sp, fx, dev)              # warm-up
        walls = [chip_smoke.run_main_path(sp, fx, dev)[1]
                 for _ in range(args.runs)]
        print(json.dumps({
            "gpu": gpu, "tree": ROOT, "scans": scans, "wall_s": walls,
            "scans_per_s_median": scans / sorted(walls)[len(walls) // 2]}))
        return

    from ndt_feature_graph_tpu_torch.ops import cuda_kernels

    chip_smoke.run_main_path(sp, fx, dev)                  # warm-up
    cuda_kernels.reset_launch_counts()
    with chip_smoke.recorded_solves("newton_solve", copy=False) as (calls, _):
        _, wall = chip_smoke.run_main_path(sp, fx, dev)
    trials = int(torch.stack([out[2] for _, out in calls]).sum())
    launches = cuda_kernels.LAUNCHES["newton_solve"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_prof = chip_smoke.run_main_path(sp, fx, dev)

    reg = registration_turns(sp, fx, dev)
    report(prof, gpu, wall, wall_prof, "scans", scans, args.out,
           "torch_port_profile.txt",
           {"scans_per_s": scans / wall, "newton_trials_per_scan":
            trials / scans, "newton_solve_per_scan": launches / scans,
            "registration": reg})


if __name__ == "__main__":
    main()
