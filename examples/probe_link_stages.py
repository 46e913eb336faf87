"""Stage split and times of the link paths' two kernels on one CUDA card:
link refinement (`newton_solve_batch` with the Hessians) and the overlap
score (`overlap_score`).

    python3 examples/probe_link_stages.py [--stages] [--times] [--out DIR]

The cases, from the package's canonical fixtures:

  * link refinement at its three shapes: "offline", the 171 candidate
    pairs of data/canonical_lc.npz's 20-node bank under their RANSAC
    poses (chip_smoke.link_bank, compute_links_batch) at
    links.source_cell_budget of the bank; "grouped", the first chunk of
    _propose_links with link_group_nodes = 8 and link_batch_size = 16 on
    that bank (chip_smoke phase 9e's); "online", the first proposal of
    the online loop-closing run over the canonical corridor (chip_smoke
    phase 6's, run_sequence_chunked);
  * the main path's registration, chip_smoke phase 3's (`newton_solve`
    on 256 source cells, 64 feature pairs and the odometry term), the
    yardstick of a trial;
  * the fleet's B = 64 step (chip_smoke phase 3d's `newton_solve_batch`
    without Hessians) under --times;
  * `overlap_score` on the bank's candidate pairs at 1, 4, 64, 128,
    171, 256, 512 and 1,024 pairs (the 171 repeated), warm and after a
    256 MiB read (cold L2).

`--stages` rebuilds the kernels' library with -DNDTG_STAGE_PROBE (under
build/probe_kernels/) so that the NDTG_LAP marks of csrc/pair_fgh.cu and
csrc/overlap.cu sum each block's SM cycles (clock64, thread 0) by stage
over its rounds (a solve's trials, the overlap's vector batches), and
prints, for each case, each stage's mean cycles and µs a round (a trial
of a lane, a pair's block) over the blocks, the probe build's device µs
a call, and, for each refinement lane, its trials, valid source cells,
budget and blocks.  The probe build is slower than the normal one: read
its shares.

`--times` times, in the normal build, each case's device µs a call by
CUDA events over repeated calls (warm, five rounds; the overlap also on
a cold L2) and by the profiler's kernel time (two rounds).  Run a copy
of this script from another commit's checkout, in turns with this one, to
compare the two (it reads only entry points both have).  With neither
flag both run, `--times` first.

One JSON line per case; with --out DIR also DIR/probe_link_stages.jsonl.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import re
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from ndt_feature_graph_tpu_torch import interop  # noqa: E402
from ndt_feature_graph_tpu_torch.graph import links as links_mod  # noqa
from ndt_feature_graph_tpu_torch.graph import node as node_mod  # noqa: E402
from ndt_feature_graph_tpu_torch.models import presets  # noqa: E402
from ndt_feature_graph_tpu_torch.ops import cuda_kernels  # noqa: E402

PROBE_BLOCKS, PROBE_STAGES = 4096, 16     # csrc/stage_probe.cuh's arrays
MARK = re.compile(r'NDTG_LAP\((\d+), "([a-z]+): ([^"]+)"\)')
OVERLAP_SIZES = (1, 4, 64, 128, 171, 256, 512, 1024)
ROUNDS = 5


def stage_names(source):
    """{kernel: {stage: name}} from the NDTG_LAP marks of `source`."""
    out = {}
    for k, kernel, name in MARK.findall(pathlib.Path(source).read_text()):
        out.setdefault(kernel, {})[int(k)] = name
    return out


def refinements(dev):
    """{shape: (args, kwargs)} of refine_links_d2d at the three link
    shapes (module docstring)."""
    lc = dict(np.load(chip_smoke.LC_FIXTURE))
    sp, _, stacked, ref_i, mov_i, u = chip_smoke.link_bank(lc, dev)
    n = ref_i.shape[0]
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    ls = links_mod.compute_links_batch(sp.fuser.features,
                                       sp.fuser.ndt.resolution, stacked,
                                       ref_i, mov_i, ones, u)
    out = {"offline": ((sp.fuser.ndt, sp.fuser.matcher, stacked, ls),
                       {"src_budget": links_mod.source_cell_budget(
                           stacked)})}
    sv = dict(np.load(chip_smoke.SOLVER_FIXTURE))
    gsp = chip_smoke.canonical_slam_params(chip_smoke.OFFLINE_SPLIT_M, 64)
    gsp = gsp.replace(graph=gsp.graph.replace(**chip_smoke.GROUPED_GRAPH))
    edges = zip(lc["off_edge_ij"][:, 0], lc["off_edge_ij"][:, 1],
                lc["off_edge_rel"], lc["off_edge_cov"])
    slam = interop.graph_from_jax(gsp, interop.tree_from_flat(
        lc, "off_bank"), lc["off_node_T_before"], edges, device=dev)
    slam.pair_u = list(sv["grp_pair_u"])
    with chip_smoke.recorded_refinements("grouped") as calls:
        slam._propose_links(node_mod.stack_nodes(slam.nodes),
                            *slam.candidate_pairs())
    out["grouped"] = calls[0]
    fx = dict(np.load(chip_smoke.FIXTURE))
    osp = chip_smoke.canonical_slam_params(2.0, 64, **chip_smoke.LC_GRAPH)
    with chip_smoke.recorded_refinements("online") as calls:
        chip_smoke.online_lc_run(osp, fx, lc, dev)
    out["online"] = calls[0]
    return out


def solve_lanes(args, kwargs):
    """The refinement's solve arguments and (lanes, n_src, valid cells
    a lane)."""
    sargs = chip_smoke.refine_args(*args, **kwargs)
    src = sargs[1]
    return sargs, src.mask.shape[0], src.mask.shape[1], \
        src.mask.sum(1).tolist()


def cases(dev):
    """{name: (kernel, fn, lane info or None)}."""
    out = {}
    for shape, (args, kwargs) in refinements(dev).items():
        sargs, lanes, n_src, valid = solve_lanes(args, kwargs)
        zero = torch.zeros((lanes, 3), device=dev)
        out[f"refinement {shape}, {lanes} lanes"] = (
            "solve", lambda z=zero, s=sargs: cuda_kernels.newton_solve_batch(
                z, *s, with_hessian=True),
            {"lanes": lanes, "budget": n_src, "valid_cells": valid})
    fx = dict(np.load(chip_smoke.FIXTURE))
    sp = chip_smoke.canonical_slam_params(float(fx["split_m"]),
                                          int(fx["max_nodes"]))
    p = sp.fuser
    state, src, T0, Q, _, fs, ft = chip_smoke.trial_case(sp, fx, dev)
    src = src.head(p.match_cell_budget)
    zero3 = torch.zeros(3, device=dev)
    out["main-path registration"] = (
        "solve", lambda: cuda_kernels.newton_solve(
            zero3, T0, src, state.packed, state.grid.origin, p.ndt.grid_h,
            p.ndt.grid_w, p.ndt.resolution, p.matcher, fs, ft, Q), None)
    lc = dict(np.load(chip_smoke.LC_FIXTURE))
    lsp, _, stacked, ref_i, mov_i, u = chip_smoke.link_bank(lc, dev)
    n = ref_i.shape[0]
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    ls = links_mod.compute_links_batch(lsp.fuser.features,
                                       lsp.fuser.ndt.resolution, stacked,
                                       ref_i, mov_i, ones, u)
    h, w = stacked.occ.shape[1:]
    occ, origins = stacked.occ.reshape(-1), stacked.occ_origin
    for pairs in OVERLAP_SIZES:
        idx = torch.arange(pairs, device=dev) % n
        r, m = ref_i[idx].contiguous(), mov_i[idx].contiguous()
        T = ls.T[idx].contiguous()
        out[f"overlap {pairs} pairs"] = (
            "overlap", lambda r=r, m=m, T=T: cuda_kernels.overlap_score(
                occ, origins, r, m, T, h, w, lsp.fuser.ndt.resolution),
            None)
    return out


def fleet_case(dev):
    """Phase 3d's B = 64 fleet solve (bf16 rows, every term)."""
    fl = dict(np.load(chip_smoke.FLEET_FIXTURE))
    fp = presets.fleet_serving()
    seq = chip_smoke.sequence(fl, dev)
    b = chip_smoke.FLEET_SIZES[-1]
    _, T0, src, packed, origins, offs, fs, ft, Q = \
        chip_smoke.fleet_trial_case(fp, seq, b, dev)
    zero = torch.zeros((b, 3), device=dev)
    m = fp.matcher
    return (f"fleet solve, B = {b}", lambda: cuda_kernels.newton_solve_batch(
        zero, T0, src, packed, origins, offs, fp.ndt.grid_h, fp.ndt.grid_w,
        fp.ndt.resolution, m, fs, ft, Q, True))


def events_us(fn, reps=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) * 1e3 / reps


def times(all_cases, dev, emit):
    """Each case's device µs a call, ROUNDS rounds."""
    buf = torch.ones(chip_smoke.L2_FLUSH_BYTES // 4, device=dev)

    def flush():
        buf.add_(1.0)

    for name, (kernel, fn, _) in all_cases.items():
        warm = [events_us(fn, 20 if kernel == "solve" else 200)
                for _ in range(ROUNDS)]
        rec = {"case": name, "warm_us": warm,
               "profiler_us": [chip_smoke.device_ms(fn, 20) * 1e3
                               for _ in range(2)]}
        if kernel == "overlap":
            rec["cold_us"] = [chip_smoke.cold_ms(fn, flush, 50) * 1e3
                              for _ in range(ROUNDS)]
        emit(rec)


def stage_times(all_cases, emit):
    lib = cuda_kernels.build()
    readers = {"solve": lib.ndtg_solve_probe_read,
               "overlap": lib.ndtg_overlap_probe_read}
    for fn in readers.values():
        fn.argtypes = [cuda_kernels.ctypes.c_void_p] * 2
        fn.restype = cuda_kernels.ctypes.c_int
    src = {p.name: p for p in cuda_kernels.SOURCES}
    names = {**stage_names(src["pair_fgh.cu"]),
             **stage_names(src["overlap.cu"])}
    clock = np.zeros(PROBE_BLOCKS * PROBE_STAGES, np.int64)
    ns = np.zeros(PROBE_BLOCKS * 2, np.int64)

    def read(kernel):
        err = readers[kernel](clock.ctypes.data, ns.ctypes.data)
        if err:
            raise RuntimeError(f"probe read failed: {err}")
        return (clock.reshape(PROBE_BLOCKS, PROBE_STAGES).copy(),
                ns.reshape(PROBE_BLOCKS, 2).copy())

    # A refinement runs the link solve (its own marks and the trial body's
    # "solve" marks 1-2), the main path's registration newton_solve; the
    # overlap score the group path where overlap_score's rule takes it.
    stage_sets = {"solve": names["solve"],
                  "link": {**names["solve"], **names["link"]},
                  "overlap": names["overlap"], "group": names["group"]}
    for name, (kernel, fn, lanes) in all_cases.items():
        marks = stage_sets["link" if lanes is not None else kernel]
        if kernel == "overlap" and cuda_kernels.overlap_group(
                int(name.split()[1])):
            marks = stage_sets["group"]
        us = events_us(fn)
        torch.cuda.synchronize()
        read(kernel)
        res = fn()
        torch.cuda.synchronize()
        clk, t_ns = read(kernel)
        rounds = clk[:, PROBE_STAGES - 1]
        live = rounds > 0
        clk, t_ns, rounds = clk[live], t_ns[live], rounds[live]
        span_ns = (t_ns[:, 1] - t_ns[:, 0]).astype(np.float64)
        span_clk = clk[:, :PROBE_STAGES - 1].sum(1)
        ghz = float(span_clk.sum() / max(span_ns.sum(), 1))
        stages = []
        for k in sorted(marks):
            per_round = clk[:, k] / rounds
            stages.append({"stage": marks[k],
                           "mean_cycles": float(per_round.mean()),
                           "max_cycles": float(per_round.max()),
                           "mean_us": float(per_round.mean()) / ghz / 1e3})
        rec = {"case": name, "probe_build_events_us": us,
               "blocks": int(live.sum()), "cycles_per_ns": ghz,
               "rounds_mean": float(rounds.mean()),
               "block_span_mean_us": float(span_ns.mean()) / 1e3,
               "block_span_max_us": float(span_ns.max()) / 1e3,
               "stages": stages}
        if lanes is not None:
            trials = res[2].tolist()
            blocks = cuda_kernels._link_cluster(
                lib, res[0].device, lanes["budget"], 0)[0]
            rec["lanes"] = [{"trials": t, "valid_cells": int(v),
                             "budget": lanes["budget"], "blocks": blocks}
                            for t, v in zip(trials, lanes["valid_cells"])]
        emit(rec)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stages", action="store_true")
    ap.add_argument("--times", action="store_true")
    ap.add_argument("--out", help="directory for the JSON lines")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_link_stages: no CUDA device")
    dev = torch.device("cuda", 0)
    out = None
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        out = open(os.path.join(args.out, "probe_link_stages.jsonl"), "a")
    head = {"tree": ROOT, "gpu": chip_smoke.gpu_line()}

    def emit(rec):
        line = json.dumps({**head, **rec})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    all_cases = cases(dev)
    if args.times or not args.stages:
        name, fn = fleet_case(dev)
        times({**all_cases, name: ("solve", fn, None)}, dev, emit)
    if args.stages or not args.times:
        cuda_kernels.NVCC_FLAGS = [*cuda_kernels.NVCC_FLAGS,
                                   "-DNDTG_STAGE_PROBE"]
        cuda_kernels.BUILD_DIR = pathlib.Path(ROOT) / "build" / \
            "probe_kernels"
        cuda_kernels._lib = None
        stage_times(all_cases, emit)


if __name__ == "__main__":
    main()
