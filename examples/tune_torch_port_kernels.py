"""Launch-shape sweep of the port's objective kernel on one CUDA card.

    python3 examples/tune_torch_port_kernels.py [--out DIR]
                                  [--fleet | --solve | --features | --occupancy
                                   | --links | --overlap]

Builds csrc/pair_fgh.cu at 256, 512 and 1024 threads per block
(-DNDTG_OBJECTIVE_THREADS) and, for each, times the entries at the
shapes chip_smoke.py checks them at, with the cluster size forced to 1,
2, 4 and 8 blocks per lane beside the wrapper's own choice:

  * `newton_objective` and `fgh_dense_flat` on one lane of 256 source
    cells (the main path's budget) and `newton_objective` on 1,024 (the
    cell list's capacity), 64 feature pairs, K = 25;
  * `fgh_dense_flat_batch` on 174 and 1,027 lanes of 192 source cells
    against a bank of four canonical nodes;
  * `newton_objective_batch` on 8, 32 and 64 lanes of 256 source cells
    and 64 feature pairs (a fleet step of chip_smoke.py's phase 3d,
    bfloat16 rows), at 256 threads; `--fleet` times this entry alone.

`--solve` times `newton_solve_batch` alone, at the build's own block
size, on phase 3d's fleet step of 8, 32 and 64 lanes (bfloat16 rows)
with the cluster forced to 1-8 blocks per lane beside the wrapper's own
choice, each held first against its plain twin (chip_smoke.held_to_all;
a disagreement is recorded, not raised) and printed with the clusters
of that size the card holds at once (`ndtg_solve_max_clusters`).

`--features` times `detect_features` alone with its cluster forced to
1, 2, 4 and 8 blocks a scan on 1, 32, 64 and 200 canonical scans a call,
`match_features` with 1, 2 and 4 blocks a pair on one consecutive
pair with the odometry gate (the main path's call), the 199 pairs and
the LC bank's 171 pairs of 128 features, and `describe_features` with
128, 256, 512 and 1,024 threads a feature on one scan's features and the
200 scans'; the sizes in turns, three rounds, each forced size's result
held bit for bit against the wrapper's own choice's (`detect_cluster`,
`match_cluster`, `describe_threads`).

`--links` times link refinement (`newton_solve_batch` with the
Hessians, the link solve) alone at its three shapes
(examples/probe_link_stages.py's offline 171, grouped 16 and online 4
lanes of the LC bank) with a lane's cluster forced to 2, 4 and 8 blocks
beside the wrapper's own choice (`link_cluster`), built at 3 and 4
blocks an SM (-DNDTG_LINK_MIN_BLOCKS), and in a build of up to 16
(-DNDTG_LINK_MAX_CLUSTER=16, non-portable), three rounds in turns; each
size of the default build first held through chip_smoke.refinement_case
(every lane's bits against the per-trial lockstep at that size, four
lanes alone against their rows).  `--overlap` times `overlap_score` alone on the LC
bank's candidate pairs at 1, 4, 16, 64, 128, 171, 256, 512 and 1,024 pairs:
the pair path and the group path at 1, 2, 4 and 8 pairs a group,
beside the size rule's own choice, with the group kernel built at 3, 4
and 6 blocks an SM (-DNDTG_OVERLAP_GROUP_BLOCKS), three rounds in
turns, each held bit for bit to the pair path's.

`--occupancy` times `occupancy_update` alone on phase 3e's update
(canonical scan 2 on scan 0's map) of one grid and of stacks of 8 and
64, with csrc/occupancy.cu built at 512 and 1,024 threads a cluster
block (-DNDTG_OCCUPANCY_THREADS) and the cluster forced to 1, 2, 4, 8
and 16 blocks a stream where the counters fit, and to the two-pass
path; the sizes in turns, three
rounds, warm (torch.profiler) and on a cold L2 (CUDA events), each held
to the wrapper's own choice's bits and the CPU's, with the clusters of
that size the card holds at once (`ndtg_occupancy_max_clusters`).

Times are device times per call (torch.profiler, as chip_smoke.py's
`ms`).  Every forced shape is first held against the plain version.
One JSON line per reading; with --out DIR they also go to
DIR/tune_torch_port_kernels.jsonl.  It is how the block size in the
source and the block- and cluster-size rules in ops/cuda_kernels.py were
chosen.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import probe_feature_stages  # noqa: E402  (beside this script)
from ndt_feature_graph_tpu_torch.features import detector  # noqa: E402
from ndt_feature_graph_tpu_torch.ops import cuda_kernels, ndt_map  # noqa: E402

THREADS = (256, 512, 1024)
CLUSTERS = (None, 1, 2, 4, 8)       # None: the wrapper's own choice
OCCUPANCY_THREADS = (512, 1024)     # the occupancy cluster's block sizes
BUDGET = 192                        # source cells per batched lane
OVERLAP_GROUP_BLOCKS = (3, 4, 6)    # the group kernel's blocks an SM
LINK_MIN_BLOCKS = (3, 4)            # the link solve's blocks an SM


def rebuild(threads):
    """Load the library built at `threads` threads per block."""
    cuda_kernels._lib = None
    cuda_kernels._RESIDENT_BLOCKS.clear()
    cuda_kernels._SOLVE_CLUSTER.clear()
    cuda_kernels._LINK_CLUSTER.clear()
    cuda_kernels.NVCC_FLAGS = [
        f for f in cuda_kernels.NVCC_FLAGS
        if not f.startswith("-DNDTG_OBJECTIVE_THREADS")
    ] + [f"-DNDTG_OBJECTIVE_THREADS={threads}"]
    lib = cuda_kernels.build()
    if lib.ndtg_objective_threads() != threads:
        raise RuntimeError(f"built {lib.ndtg_objective_threads()} threads")


def solve_sweep(fp, seq, dev, emit):
    """`newton_solve_batch` at each forced cluster size (see --solve)."""
    own_choice = cuda_kernels._solve_cluster
    lib = cuda_kernels.build()
    m = fp.matcher
    h, w, res = fp.ndt.grid_h, fp.ndt.grid_w, fp.ndt.resolution
    for lanes in chip_smoke.FLEET_SIZES:
        a = chip_smoke.fleet_trial_case(fp, seq, lanes, dev)
        call = (*a[1:6], h, w, res, m, *a[6:], True)
        zero = torch.zeros((lanes, 3), device=dev)
        n_src, n_feat = a[2].mask.shape[-1], a[6].mask.shape[-1]

        def plain(d0, call=call):
            return cuda_kernels.newton_solve_batch_reference(d0, *call)

        for cluster in (None, *range(1, lib.ndtg_max_cluster() + 1)):
            force = own_choice(lib, dev, lanes, n_src, n_feat) \
                if cluster is None else cluster
            cuda_kernels._solve_cluster = lambda *_, c=force: c
            try:
                got = cuda_kernels.newton_solve_batch(zero, *call)
                try:
                    chip_smoke.held_to_all(
                        f"B={lanes}, {force} blocks a lane", got,
                        [("plain twin", plain(zero), plain)], zero)
                    agrees = True
                except chip_smoke.PhaseError as e:
                    print(f"  disagrees: {e}")
                    agrees = False
                us = 1e3 * chip_smoke.device_ms(
                    lambda: cuda_kernels.newton_solve_batch(zero, *call), 20)
            finally:
                cuda_kernels._solve_cluster = own_choice
            emit(entry="newton_solve_batch", lanes=lanes, n_src=n_src,
                 n_feat=n_feat, cluster=cluster, blocks_a_lane=force,
                 agrees_with_plain=agrees,
                 resident_clusters=lib.ndtg_solve_max_clusters(
                     n_src, n_feat, force),
                 trials_max=int(got[2].max()), device_us=us)


def links_sweep(dev, emit, rounds=3):
    """Link refinement at each forced cluster size (see --links)."""
    import probe_link_stages
    own = cuda_kernels._link_cluster
    flags = cuda_kernels.NVCC_FLAGS
    refs = probe_link_stages.refinements(dev)
    try:
        for most, min_blocks in [(8, k) for k in LINK_MIN_BLOCKS] + [
                (16, LINK_MIN_BLOCKS[-1])]:
            cuda_kernels._lib = None
            cuda_kernels._LINK_CLUSTER.clear()
            cuda_kernels.NVCC_FLAGS = [
                *flags, f"-DNDTG_LINK_MIN_BLOCKS={min_blocks}"] + (
                [f"-DNDTG_LINK_MAX_CLUSTER={most}"] if most != 8 else [])
            lib = cuda_kernels.build()
            sizes = (None, 2, 4, 8) if most == 8 else (16,)
            for name, (args, kwargs) in refs.items():
                sargs = chip_smoke.refine_args(*args, **kwargs)
                n_src = sargs[1].mask.shape[-1]
                zero = torch.zeros((sargs[0].shape[0], 3), device=dev)
                times, seen = {k: [] for k in sizes}, {}
                for _ in range(rounds):
                    for k in sizes:
                        cuda_kernels._link_cluster = own if k is None else (
                            lambda lib_, d, s, f, k=k:
                            (k, lib_.ndtg_link_max_clusters(s, f, k)))
                        try:
                            if k not in seen:
                                out = cuda_kernels.newton_solve_batch(
                                    zero, *sargs, with_hessian=True)
                                held = (chip_smoke.refinement_case(
                                    name, [(args, kwargs)], dev,
                                    times=False) if most == 8
                                    and min_blocks == LINK_MIN_BLOCKS[-1]
                                    else None)
                                seen[k] = (out, held)
                            times[k].append(1e3 * chip_smoke.device_ms(
                                lambda: cuda_kernels.newton_solve_batch(
                                    zero, *sargs, with_hessian=True), 20))
                        finally:
                            cuda_kernels._link_cluster = own
                for k in sizes:
                    out, held = seen[k]
                    emit(entry="link_solve", case=name,
                         lanes=int(zero.shape[0]), n_src=n_src,
                         blocks_an_sm=min_blocks,
                         blocks=k or own(lib, dev, n_src, 0)[0],
                         own_choice=k is None,
                         resident_clusters=lib.ndtg_link_max_clusters(
                             n_src, 0, k or own(lib, dev, n_src, 0)[0]),
                         trials_max=int(out[2].max()),
                         trials_sum=int(out[2].sum()),
                         lanes_equal_to_lockstep=(
                             held["bits_equal"] if held else None),
                         alone_equal=held["alone_equal"] if held else None,
                         device_us=times[k])
    finally:
        cuda_kernels.NVCC_FLAGS = flags
        cuda_kernels._lib = None
        cuda_kernels._LINK_CLUSTER.clear()


def overlap_sweep(dev, emit, rounds=3):
    """`overlap_score` on each path and layout (see --overlap), the group
    kernel built at each of OVERLAP_GROUP_BLOCKS blocks an SM."""
    flags = cuda_kernels.NVCC_FLAGS
    try:
        for blocks in OVERLAP_GROUP_BLOCKS:
            cuda_kernels._lib = None
            cuda_kernels.NVCC_FLAGS = [
                *flags, f"-DNDTG_OVERLAP_GROUP_BLOCKS={blocks}"]
            overlap_layouts(dev, emit, blocks, rounds)
    finally:
        cuda_kernels.NVCC_FLAGS = flags
        cuda_kernels._lib = None


def overlap_layouts(dev, emit, blocks, rounds):
    from ndt_feature_graph_tpu_torch.graph import links as links_mod
    lc = dict(np.load(chip_smoke.LC_FIXTURE))
    sp, _, stacked, ref_i, mov_i, u = chip_smoke.link_bank(lc, dev)
    res = sp.fuser.ndt.resolution
    ls = links_mod.compute_links_batch(
        sp.fuser.features, res, stacked, ref_i, mov_i,
        torch.ones(ref_i.shape[0], dtype=torch.bool, device=dev), u)
    h, w = stacked.occ.shape[1:]
    occ, origins = stacked.occ.reshape(-1), stacked.occ_origin
    layouts = [("rule", None), ("pair path", 0)] + [
        (f"group path, {g} pairs a group", g) for g in (1, 2, 4, 8)]
    for pairs in (1, 4, 16, 64, 128, 171, 256, 512, 1024):
        idx = torch.arange(pairs, device=dev) % ref_i.shape[0]
        r, m = ref_i[idx].contiguous(), mov_i[idx].contiguous()
        T = ls.T[idx].contiguous()
        with chip_smoke.overlap_group_forced(0):
            want = cuda_kernels.overlap_score(occ, origins, r, m, T, h, w,
                                              res)
        times = {name: [] for name, _ in layouts}
        same = {}
        for _ in range(rounds):
            for name, group in layouts:
                def fn(group=group):
                    if group is None:
                        return cuda_kernels.overlap_score(
                            occ, origins, r, m, T, h, w, res)
                    with chip_smoke.overlap_group_forced(group):
                        return cuda_kernels.overlap_score(
                            occ, origins, r, m, T, h, w, res)
                got = fn()
                same[name] = (torch.equal(got[0], want[0])
                              and torch.equal(got[1], want[1]))
                times[name].append(1e3 * chip_smoke.device_ms(fn, 50))
        for name, _ in layouts:
            emit(entry="overlap_score", pairs=pairs, layout=name,
                 group_blocks_an_sm=blocks,
                 equal_to_pair_path=same[name], device_us=times[name])


def features_sweep(dev, emit, rounds=3):
    """`detect_features` and `match_features` at each forced cluster size
    (see --features)."""
    fx = dict(np.load(chip_smoke.FIXTURE))
    fp = chip_smoke.canonical_slam_params(float(fx["split_m"]),
                                          int(fx["max_nodes"])).fuser.features
    R = torch.as_tensor(fx["ranges"], dtype=torch.float32, device=dev)
    H = torch.as_tensor(fx["hit"], dtype=torch.bool, device=dev)
    cases = probe_feature_stages.inputs(dev)
    sweeps = [("detect_features", "detect_cluster", (1, 2, 4, 8), f"{n} scans",
               lambda n=n: detector.detect(fp, R[:n], H[:n]))
              for n in (1, 32, 64, R.shape[0])]
    sweeps += [("match_features", "match_cluster", (1, 2, 4), name, fn)
               for name, (kind, fn) in cases.items() if kind == "match"]
    sweeps += [("describe_features", "describe_threads",
                (128, 256, 512, 1024), name, fn)
               for name, (kind, fn) in cases.items() if kind == "describe"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def fields(x):
        x = x[0] if isinstance(x, tuple) else x
        if isinstance(x, torch.Tensor):
            return [x]
        return [getattr(x, f.name) for f in dataclasses.fields(x)]

    for entry, rule, sizes, case, fn in sweeps:
        key = "threads" if rule == "describe_threads" else "blocks"
        own = fields(fn())
        seen = {}
        times = {k: [] for k in sizes}
        for _ in range(rounds):
            for k in sizes:
                rule_fn = getattr(cuda_kernels, rule)
                setattr(cuda_kernels, rule, lambda *_, k=k: k)
                try:
                    seen[k] = all(torch.equal(a, b)
                                  for a, b in zip(fields(fn()), own))
                    times[k].append(1e3 * chip_smoke.device_ms(fn, 20))
                finally:
                    setattr(cuda_kernels, rule, rule_fn)
        for k in sizes:
            emit(entry=entry, case=case, **{key: k}, sms=sms,
                 equal_to_own_choice=seen[k], device_us=times[k])


def occupancy_sweep(dev, emit, rounds=3):
    """`occupancy_update` at each block size and forced cluster size (see
    --occupancy)."""
    flags = cuda_kernels.NVCC_FLAGS
    try:
        for threads in OCCUPANCY_THREADS:
            cuda_kernels._lib = None
            cuda_kernels._OCC_RESIDENT.clear()
            cuda_kernels.NVCC_FLAGS = [
                *flags, f"-DNDTG_OCCUPANCY_THREADS={threads}"]
            occupancy_sizes(dev, emit, threads, rounds)
    finally:
        cuda_kernels.NVCC_FLAGS = flags
        cuda_kernels._lib = None
        cuda_kernels._OCC_RESIDENT.clear()


def occupancy_sizes(dev, emit, threads, rounds):
    fx = dict(np.load(chip_smoke.FIXTURE))
    mp = chip_smoke.canonical_slam_params(float(fx["split_m"]),
                                          int(fx["max_nodes"])).fuser.ndt
    lib = cuda_kernels.build()
    rows = mp.grid_h * mp.grid_w
    rule = cuda_kernels.occupancy_cluster
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sizes = [k for k in (1, 2, 4, 8, 16)
             if cuda_kernels.occupancy_block_rows(rows, k) * 8
             <= cuda_kernels.OCCUPANCY_MAX_SMEM]
    for streams in (0, 8, 64):
        lead = (streams,) if streams else ()
        grid = chip_smoke.map_update(ndt_map.empty_grid(mp, torch.zeros(
            lead + (2,), device=dev)), mp, *chip_smoke.world_scan(
                fx, 0, dev, streams))
        world, mask, sensor = chip_smoke.world_scan(fx, 2, dev, streams)

        def fn():
            return ndt_map.update_occupancy(grid, mp, sensor, world, mask)

        own = fn().occ
        want = ndt_map.update_occupancy(
            chip_smoke.node_mod.map_tensors(torch.Tensor.cpu, grid), mp,
            sensor.cpu(), world.cpu(), mask.cpu()).occ
        seen, times, cold = {}, {k: [] for k in (0, *sizes)}, {}
        buf = torch.ones(chip_smoke.L2_FLUSH_BYTES // 4, device=dev)
        for _ in range(rounds):
            for k in (0, *sizes):
                cuda_kernels.occupancy_cluster = lambda *_, k=k: k
                try:
                    got = fn().occ
                    seen[k] = (torch.equal(got, own)
                               and torch.equal(got.cpu(), want))
                    times[k].append(1e3 * chip_smoke.device_ms(fn, 20))
                    cold.setdefault(k, []).append(1e3 * chip_smoke.cold_ms(
                        fn, lambda: buf.add_(1.0), 20))
                finally:
                    cuda_kernels.occupancy_cluster = rule
        del buf
        for k in (0, *sizes):
            emit(entry="occupancy_update", streams=streams or 1,
                 threads=threads, blocks=k or "two-pass", sms=sms,
                 own_choice=rule(rows, False, streams or 1,
                                 cuda_kernels._occupancy_resident(
                                     lib, dev, rows, False)),
                 resident_clusters=(lib.ndtg_occupancy_max_clusters(rows, k, 0)
                                    if k else None),
                 equal_to_own_choice_and_cpu=seen[k], device_us=times[k],
                 cold_events_us=cold[k])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for the JSON lines")
    ap.add_argument("--fleet", action="store_true",
                    help="sweep `newton_objective_batch` alone")
    ap.add_argument("--solve", action="store_true",
                    help="sweep `newton_solve_batch` alone")
    ap.add_argument("--features", action="store_true",
                    help="sweep the feature detector's and matcher's "
                         "cluster sizes and the descriptor's block size "
                         "alone")
    ap.add_argument("--occupancy", action="store_true",
                    help="sweep the occupancy kernel's cluster size alone")
    ap.add_argument("--links", action="store_true",
                    help="sweep the link solve's cluster size alone")
    ap.add_argument("--overlap", action="store_true",
                    help="sweep the overlap score's paths alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tune_torch_port_kernels: no CUDA device")
    dev = torch.device("cuda", 0)
    gpu = chip_smoke.gpu_line()
    fx = dict(np.load(chip_smoke.FIXTURE))
    fl = dict(np.load(chip_smoke.FLEET_FIXTURE))
    fleet_p = chip_smoke.presets.fleet_serving()
    fleet_seq = chip_smoke.sequence(fl, dev)
    sp = chip_smoke.canonical_slam_params(float(fx["split_m"]),
                                          int(fx["max_nodes"]))
    p = sp.fuser
    m = p.matcher
    h, w, res = p.ndt.grid_h, p.ndt.grid_w, p.ndt.resolution
    state, src_full, T0, Q, d, fs, ft = chip_smoke.trial_case(sp, fx, dev)
    bank, pairs, T0_b = chip_smoke.small_bank(sp, fx, dev)
    own_choice = cuda_kernels._objective_cluster
    own_link = cuda_kernels._link_cluster
    lines = []

    def emit(**rec):
        rec = {"gpu": gpu, **rec}
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    if args.solve:
        solve_sweep(fleet_p, fleet_seq, dev, emit)
    if args.features:
        features_sweep(dev, emit)
    if args.occupancy:
        occupancy_sweep(dev, emit)
    if args.links:
        links_sweep(dev, emit)
    if args.overlap:
        overlap_sweep(dev, emit)
    alone = (args.solve or args.features or args.occupancy or args.links
             or args.overlap)
    for threads in () if alone else THREADS[:1] if args.fleet \
            else THREADS:
        rebuild(threads)
        for cluster in CLUSTERS:
            cuda_kernels._objective_cluster = own_choice if cluster is None \
                else (lambda *a, c=cluster: c)
            # fgh_dense_flat_batch sizes its lanes as the link solve does.
            cuda_kernels._link_cluster = own_link if cluster is None \
                else (lambda *a, c=cluster: (c, 1))
            for n_src in () if args.fleet else (256, 1024):
                src = src_full.head(n_src)
                a = (d, T0, src, state.packed, state.grid.origin, h, w, res,
                     m, fs, ft, Q)
                chip_smoke.compare(
                    "", cuda_kernels.newton_objective(*a),
                    cuda_kernels.newton_objective_reference(*a), quiet=True)
                emit(entry="newton_objective", threads=threads,
                     cluster=cluster, n_src=n_src, device_us=1e3 *
                     chip_smoke.device_ms(
                         lambda: cuda_kernels.newton_objective(*a)))
            src = src_full.head(256)
            if not args.fleet:
                emit(entry="fgh_dense_flat", threads=threads,
                     cluster=cluster, n_src=256,
                     device_us=1e3 * chip_smoke.device_ms(
                         lambda: cuda_kernels.fgh_dense_flat(
                             d, T0, src, state.packed, state.grid.origin, h,
                             w, res, m.n_neighbours, m.lfd1, m.lfd2)))
            for lanes in () if args.fleet else (171, 1024):
                idx = np.resize(np.arange(len(pairs)), lanes)
                chip_smoke.batch_kernel_checks(
                    bank, pairs[idx], T0_b[idx], BUDGET, sp, dev, times=False)
                b = chip_smoke.bank_lanes(bank, pairs[idx], T0_b[idx],
                                          BUDGET, res, dev)[:6]
                emit(entry="fgh_dense_flat_batch", threads=threads,
                     cluster=cluster, lanes=lanes + 3, n_src=BUDGET,
                     device_us=1e3 * chip_smoke.device_ms(
                         lambda: cuda_kernels.fgh_dense_flat_batch(
                             *b, h, w, res, m.n_neighbours, m.lfd1, m.lfd2),
                         20))
            for lanes in chip_smoke.FLEET_SIZES if threads == 256 else ():
                a = chip_smoke.fleet_trial_case(fleet_p, fleet_seq, lanes,
                                                dev)
                call = (*a[:6], h, w, res, m, *a[6:], True)
                for k, (x, y) in enumerate(zip(
                        zip(*cuda_kernels.newton_objective_batch(*call)),
                        zip(*cuda_kernels.newton_objective_batch_reference(
                            *call)))):
                    chip_smoke.compare(f"lane {k}", x, y, quiet=True,
                                       cancel=chip_smoke.CANCEL_RTOL)
                emit(entry="newton_objective_batch", threads=threads,
                     cluster=cluster, lanes=lanes, n_src=256, n_feat=64,
                     device_us=1e3 * chip_smoke.device_ms(
                         lambda: cuda_kernels.newton_objective_batch(*call),
                         20))
    cuda_kernels._objective_cluster = own_choice
    cuda_kernels._link_cluster = own_link
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "tune_torch_port_kernels.jsonl"),
                  "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)


if __name__ == "__main__":
    main()
