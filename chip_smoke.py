"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--out DIR]

Runs on a machine with a CUDA card and no JAX:

  1. prints the card (nvidia-smi name, power limit) and torch/CUDA versions;
  2. builds the CUDA kernels from csrc/ (nvcc, sm_90a) and times the build;
  3. holds each kernel entry against its plain PyTorch twin on the card at
     the main path's shapes — a real canonical fuser state's packed table
     with N=256 source cells x K=25 window cells, 64 feature pairs — plus
     edge cases (all pairs masked; windows crossing the grid edge), and
     times kernel vs plain;
  4. drives the main path (NDTFeatureGraphSLAM.initialize +
     run_sequence_device) over the canonical 200-scan fixture with the
     JAX reference's RANSAC draws, checks that both kernel entries
     launched, that the frozen-node count matches JAX and that the
     trajectory stays within 1 cm / 5 mrad of the JAX trajectory, and
     reports ATE and scans/s (one warm-up run, then the median of 3);
  5. offline loop closure: builds bench.py's offline graph (a node every
     0.25 m) with pipeline.run_slam and checks its node count, then
     3b. holds the batched entry `fgh_dense_flat_batch` against its plain
         twin on that node bank at the offline shapes (the ~170 candidate
         pairs and 1024 lanes x the source-cell budget x K=25, an
         all-masked lane, a lane on the bank's last node, windows across
         the grid edge; determinism) and times kernel vs plain;
     5a. runs optimize_offline on the reference's own graph (its node
         bank, poses and edges, from canonical_lc.npz) with the JAX
         draws: the same candidate pairs and RANSAC poses, the refined
         links' summed D2D cost within 2% of JAX's, the kept-link set,
         the optimized node poses and the port's solve of JAX's own
         links (1 cm / 5 mrad);
     runs optimize_offline on the port's graph with the JAX draws and
     checks the kept-link set, the optimized node poses (1 cm / 5 mrad
     of the nearer of two JAX solutions: the record, and the record
     with the odometry moved by 1e-6, the reference's own spread) and
     node ATE (it halves and stays within 1 cm of JAX's); a link may
     be kept differently only where JAX's value lies within 1e-3 of a
     gate or the link's refined pose moved beyond 1 cm / 5 mrad from
     JAX's; prints the optimize_offline wall time (median of 3) and
     propose -> refine -> rescore pairs/s at B=256 and 1024;
  6. online loop closure (bench.py's bench_online_lc setting,
     run_sequence_chunked with chunk=64): trajectory and node poses
     within 1 cm / 5 mrad of JAX, the same node and loop-link counts, all
     three kernel entries launched; scans/s (median of 3);
  7. prints a JSON line per kernel and, last, the result line.

Exits non-zero (and prints no result) without a CUDA card or if any
phase fails.  With --out DIR the details also go to DIR/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ndt_feature_graph_tpu.config import (
    FeatureParams, FuserParams, GraphParams, NDTMapParams, SLAMParams,
)
from ndt_feature_graph_tpu_torch import interop, pipeline
from ndt_feature_graph_tpu_torch.core import se2
from ndt_feature_graph_tpu_torch.fusion import fuser
from ndt_feature_graph_tpu_torch.graph import links as links_mod
from ndt_feature_graph_tpu_torch.graph import node as node_mod
from ndt_feature_graph_tpu_torch.graph.slam import NDTFeatureGraphSLAM
from ndt_feature_graph_tpu_torch.io import dataset
from ndt_feature_graph_tpu_torch.io.dataset import Sequence
from ndt_feature_graph_tpu_torch.ops import cuda_kernels, d2d_analytic
from ndt_feature_graph_tpu_torch.ops.ndt_map import CellList

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE_REL = "ndt_feature_graph_tpu_torch/data/canonical_200.npz"
FIXTURE = os.path.join(ROOT, FIXTURE_REL)
LC_FIXTURE_REL = "ndt_feature_graph_tpu_torch/data/canonical_lc.npz"
LC_FIXTURE = os.path.join(ROOT, LC_FIXTURE_REL)
OFFLINE_SPLIT_M = 0.25        # bench.py bench_offline's graph
LC_GRAPH = dict(online_loop_closure=True, valid_min_idx_dist=1,
                online_lc_candidate_dist=20.0)   # bench_online_lc's
BIG_B = 1024                  # the batch entry's widest check
RATE_B = (256, 1024)          # pairs/s batch widths (bench_offline's)
SOURCE = "ndt_feature_graph_tpu_torch/csrc/pair_fgh.cu"
REPLACES = "ndt_feature_graph_tpu/ops/pallas_kernels.py:149"
F_RTOL = 1e-4                 # tests/test_pallas_kernels.py tolerances
GH_RTOL, G_ATOL, H_ATOL = 2e-3, 1e-4, 1e-3
CANCEL_RTOL = 1e-3            # batch lanes: see compare()
XY_TOL, TH_TOL = 0.01, 0.005  # trajectory vs the JAX reference


def canonical_slam_params(split_m=2.0, max_nodes=64, **graph) -> SLAMParams:
    """bench.canonical_params() (0.5 m cells, 100x100 m map, 30 m range,
    720 beams, 256-cell match budget, 136-cell f32 win-block gather) in
    the bench's graph setting (`graph`: further GraphParams fields) —
    rebuilt here because bench.py imports JAX."""
    fp = FuserParams(
        ndt=NDTMapParams(resolution=0.5, size_x=100.0, size_y=100.0,
                         sensor_range=30.0, max_points_per_scan=720,
                         max_cells=1024),
        features=FeatureParams(num_beams=720, max_range=30.0),
        match_cell_budget=256, gather_window_cells=136, gather_block=True,
    )
    return SLAMParams(fuser=fp, graph=GraphParams(
        new_node_transl_dist=split_m, max_nodes=max_nodes, **graph))


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps=200):
    """Mean ms per call by CUDA events over `reps` calls, after warm-up."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps=50):
    """Mean device time per call, ms: the summed time of the kernels
    `fn` launches (torch.profiler), without the host's launch gaps."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    on_dev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.self_device_time_total for e in on_dev) * 1e-3 / reps


def compare(name, got, ref, quiet=False, cancel=0.0):
    """Max abs error of (f, g, H) vs the plain version, within the
    stated tolerances.  `cancel` > 0 widens the absolute tolerance of g
    and H by that share of their largest entry.  Where source cells lie
    tens of metres from the lane's pose, one pair's theta-theta Hessian
    term is ~1e6 (lever arm squared times Sig^-1 ~ 1e3) and cancels
    inside the pair; the kernel and the plain version write that algebra
    differently, so each rounds at ~eps x 1e6 per pair, and over
    thousands of pairs an entry of a lane whose largest is ~1e5 differs
    by ~10 (measured 17 of 1.7e5 on the card)."""
    (f, g, H), (fr, gr, Hr) = got, ref
    f, g, H, fr, gr, Hr = (x.double().cpu().numpy()
                           for x in (f, g, H, fr, gr, Hr))
    g_atol = G_ATOL + cancel * float(np.abs(gr).max())
    h_atol = H_ATOL + cancel * float(np.abs(Hr).max())
    ok = (np.allclose(f, fr, rtol=F_RTOL, atol=1e-6)
          and np.allclose(g, gr, rtol=GH_RTOL, atol=g_atol)
          and np.allclose(H, Hr, rtol=GH_RTOL, atol=h_atol))
    err = float(max(np.abs(f - fr).max(), np.abs(g - gr).max(),
                    np.abs(H - Hr).max()))
    if not quiet:
        print(f"  {name}: max_abs_err {err:.3e} (f {float(f):.6f} vs "
              f"{float(fr):.6f})")
    check(ok, f"{name}: kernel disagrees with its plain version\n"
              f"f {f} vs {fr}\ng {g} vs {gr}\nH {H} vs {Hr}")
    return err


def random_pairs(n, dev, seed=0):
    """`n` random SPD Gaussian pairs (as tests/test_pallas_kernels.py)."""
    rng = np.random.default_rng(seed)
    mu = 0.5 * rng.standard_normal((n, 2))
    L = 0.2 * rng.standard_normal((n, 2, 2))
    Sig = L @ L.transpose(0, 2, 1) + 0.05 * np.eye(2)
    m_rot = 3.0 * rng.standard_normal((n, 2))
    Lc = 0.2 * rng.standard_normal((n, 2, 2))
    Crot = Lc @ Lc.transpose(0, 2, 1) + 0.02 * np.eye(2)
    ok = rng.random(n) < 0.7
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    return t(mu), t(Sig), t(m_rot), t(Crot), torch.as_tensor(ok, device=dev)


def kernel_checks(sp, fx, dev):
    """Phase 3: each kernel entry vs its plain twin on the card."""
    p = sp.fuser
    m = p.matcher
    h, w, res = p.ndt.grid_h, p.ndt.grid_w, p.ndt.resolution
    T = lambda x, dt=torch.float32: torch.as_tensor(x, dtype=dt, device=dev)
    pts0, mask0 = dataset.scan_to_points(T(fx["ranges"][0]),
                                         T(fx["hit"][0], torch.bool))
    state = fuser.initialize(p, torch.zeros(3, device=dev),
                             torch.zeros(3, device=dev), pts0, mask0)
    pts1, mask1 = dataset.scan_to_points(T(fx["ranges"][1]),
                                         T(fx["hit"][1], torch.bool))
    src, _ = fuser._build_local_cells(p, state.sensor_pose, pts1, mask1)
    src = src.head(p.match_cell_budget)
    n_valid = int(src.mask.sum())
    check(src.means.shape[0] == 256, "source list is not 256 cells")
    T0 = se2.compose(state.Tnow, T(fx["odom"][1]))
    d = T([0.02, -0.01, 0.004])
    print(f"  packed table {tuple(state.packed.shape)}, N=256 source cells "
          f"({n_valid} valid) x K={(2 * m.n_neighbours + 1) ** 2}")

    def dense(d_, src_, origin, packed=state.packed):
        return (
            cuda_kernels.fgh_dense_flat(
                d_, T0, src_, packed, origin, h, w, res,
                m.n_neighbours, m.lfd1, m.lfd2),
            d2d_analytic.fgh_dense_flat(
                d_, T0, src_, packed, origin, 0, h, w, res, m),
        )

    origin = state.grid.origin
    err_dense = compare("fgh_dense_flat N=256 K=25", *dense(d, src, origin))
    k1 = cuda_kernels.fgh_dense_flat(d, T0, src, state.packed, origin, h, w,
                                     res, m.n_neighbours, m.lfd1, m.lfd2)
    k2 = cuda_kernels.fgh_dense_flat(d, T0, src, state.packed, origin, h, w,
                                     res, m.n_neighbours, m.lfd1, m.lfd2)
    check(all(torch.equal(a, b) for a, b in zip(k1, k2)),
          "fgh_dense_flat is not deterministic")
    masked = dataclasses.replace(src, mask=torch.zeros_like(src.mask))
    got, ref = dense(d, masked, origin)
    check(all(float(x.abs().max()) == 0.0 for x in got),
          "all-masked fgh_dense_flat is not exactly zero")
    compare("fgh_dense_flat all masked", got, ref)
    # Roll the table's content 95 rows down and 90 columns left (the
    # mapped room starts at row 94, column 88) and move the origin with
    # it: the scan's cells now straddle the bottom and left grid edges,
    # next to real valid cells.
    edge_packed = state.packed.reshape(h, w, 8).roll(
        (-95, -90), (0, 1)).reshape(h * w, 8).contiguous()
    edge_origin = origin + T([90 * res, 95 * res])
    got, ref = dense(d, src, edge_origin, edge_packed)
    nb = m.n_neighbours
    _, iy0, ix0 = d2d_analytic.window_cells(d, T0, src, edge_origin, res)
    crossing = src.mask & (torch.minimum(iy0, ix0) < nb) & (
        torch.minimum(iy0, ix0) >= -nb)
    check(int(crossing.sum()) > 0 and float(ref[0]) < 0.0,
          "edge case has no window crossing the edge next to valid cells")
    print(f"  {int(crossing.sum())} source windows cross the grid edge")
    compare("fgh_dense_flat windows crossing the grid edge", got, ref)

    mu, Sig, m_rot, Crot, ok = random_pairs(64, dev)
    got = cuda_kernels.pair_fgh_reduce(mu, Sig, m_rot, Crot, ok, m.lfd1,
                                       m.lfd2)
    ref = cuda_kernels.pair_fgh_reduce_reference(mu, Sig, m_rot, Crot, ok,
                                                 m.lfd1, m.lfd2)
    err_pair = compare("pair_fgh_reduce 64 pairs", got, ref)
    none = torch.zeros_like(ok)
    got = cuda_kernels.pair_fgh_reduce(mu, Sig, m_rot, Crot, none, m.lfd1,
                                       m.lfd2)
    check(all(float(x.abs().max()) == 0.0 for x in got),
          "all-masked pair_fgh_reduce is not exactly zero")

    if dev.type != "cuda":          # CPU rehearsal: no timing
        return {"fgh_dense_flat": err_dense, "pair_fgh_reduce": err_pair}, {}
    calls = {
        "fgh_dense_flat": (
            lambda: cuda_kernels.fgh_dense_flat(
                d, T0, src, state.packed, origin, h, w, res,
                m.n_neighbours, m.lfd1, m.lfd2),
            lambda: d2d_analytic.fgh_dense_flat(
                d, T0, src, state.packed, origin, 0, h, w, res, m),
        ),
        "pair_fgh_reduce": (
            lambda: cuda_kernels.pair_fgh_reduce(
                mu, Sig, m_rot, Crot, ok, m.lfd1, m.lfd2),
            lambda: cuda_kernels.pair_fgh_reduce_reference(
                mu, Sig, m_rot, Crot, ok, m.lfd1, m.lfd2),
        ),
    }
    times = {k: (time_ms(kf), time_ms(pf)) for k, (kf, pf) in calls.items()}
    for k, (kt, pt) in times.items():
        print(f"  {k}: kernel {kt * 1e3:.1f} us, plain {pt * 1e3:.1f} us "
              f"per call (CUDA events, mean of 200)")
    for k, (kf, pf) in calls.items():
        print(f"  {k}: device time kernel {device_ms(kf) * 1e3:.2f} us, "
              f"plain {device_ms(pf) * 1e3:.2f} us per call "
              f"(torch.profiler, mean of 50)")
    return {"fgh_dense_flat": err_dense, "pair_fgh_reduce": err_pair}, times


def bank_lanes(bank, pairs, T0, budget, res, dev):
    """Inputs of the batch entry over `bank` (a stacked node bank): one
    lane per (ref, mov) pair at initial poses T0, with source lists cut
    at `budget` cells, plus three edge-case lanes appended: all source
    cells masked; against the bank's last node; and against a copy of
    the last node whose table is rolled so that its mapped cells start
    at row 0 / column 0, so source windows cross the grid edge next to
    valid cells (the copy joins the bank as one more node).

    Returns (d, T0, src, packed_flat, origins, row_offsets, lanes of the
    three cases)."""
    n, hw = bank.target.packed.shape[:2]
    h, w = bank.occ.shape[1:]
    ref = torch.as_tensor(pairs[:, 0], device=dev)
    mov = torch.as_tensor(pairs[:, 1], device=dev)
    last = n - 1
    tab = bank.target.packed[last].reshape(h, w, 8)
    valid = tab[..., 5] > 0.5
    r0 = int(valid.any(1).nonzero()[0])
    c0 = int(valid.any(0).nonzero()[0])
    edge = tab.roll((-r0, -c0), (0, 1)).reshape(hw, 8)
    packed = torch.cat([bank.target.packed.reshape(-1, 8), edge]).contiguous()
    origins_bank = torch.cat([bank.target.origin, (
        bank.target.origin[last] + res * torch.tensor(
            [c0, r0], dtype=torch.float32, device=dev))[None]])
    b = ref.shape[0]
    ref = torch.cat([ref, torch.tensor([0, last, n], device=dev)])
    mov = torch.cat([mov, torch.tensor([1, 0, last], device=dev)])
    T0 = torch.cat([torch.as_tensor(T0, dtype=torch.float32, device=dev),
                    torch.zeros((3, 3), device=dev)])
    src = CellList(*(x[mov, :budget].contiguous() for x in (
        bank.cells.means, bank.cells.covs, bank.cells.mask)))
    src.mask[b] = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    d = (torch.randn((b + 3, 3), generator=gen, device=dev)
         * torch.tensor([0.05, 0.05, 0.01], device=dev)).contiguous()
    return (d, T0.contiguous(), src, packed, origins_bank[ref].contiguous(),
            (ref * hw).contiguous(), (b, b + 1, b + 2))


def batch_kernel_checks(bank, pairs, T0, budget, sp, dev, times=True):
    """Phase 3b: `fgh_dense_flat_batch` against its plain twin at the
    offline shapes on a node bank: per-lane (f, g, H) at the stated
    tolerances, determinism (two calls, identical bits), the all-masked
    lane exactly zero, the last-node and grid-edge lanes nonzero.
    Returns (max_abs_err, (kernel ms, plain ms) or None)."""
    p = sp.fuser
    m = p.matcher
    h, w, res = p.ndt.grid_h, p.ndt.grid_w, p.ndt.resolution
    d, T0, src, packed, origins, offs, (masked, last, edge) = bank_lanes(
        bank, pairs, T0, budget, res, dev)
    args = (d, T0, src, packed, origins, offs, h, w, res)
    kernel = lambda: cuda_kernels.fgh_dense_flat_batch(  # noqa: E731
        *args, m.n_neighbours, m.lfd1, m.lfd2)
    plain = lambda: d2d_analytic.fgh_dense_flat_batch(*args, m)  # noqa
    got, again, ref = kernel(), kernel(), plain()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "fgh_dense_flat_batch is not deterministic")
    lanes = d.shape[0]
    print(f"  B={lanes} lanes x N={budget} source cells x "
          f"K={(2 * m.n_neighbours + 1) ** 2}, bank of "
          f"{packed.shape[0] // (h * w)} nodes")
    err = max(compare(f"fgh_dense_flat_batch lane {k}",
                      tuple(x[k] for x in got), tuple(x[k] for x in ref),
                      quiet=k not in (0, masked, last, edge),
                      cancel=CANCEL_RTOL)
              for k in range(lanes))
    check(all(float(x[masked].abs().max()) == 0.0 for x in got),
          "all-masked lane of fgh_dense_flat_batch is not exactly zero")
    _, iy0, ix0 = d2d_analytic.window_cells(
        d[edge], T0[edge], CellList(src.means[edge], src.covs[edge],
                                    src.mask[edge]), origins[edge], res)
    crossing = src.mask[edge] & (torch.minimum(iy0, ix0) < m.n_neighbours)
    check(int(crossing.sum()) > 0 and float(ref[0][edge]) < 0.0
          and float(ref[0][last]) < 0.0,
          "edge lanes have no window crossing the edge next to valid cells")
    print(f"  max_abs_err over {lanes} lanes {err:.3e}; "
          f"{int(crossing.sum())} source windows cross the grid edge")
    if not times:
        return err, None
    kt, pt = time_ms(kernel, 50), time_ms(plain, 5)
    print(f"  fgh_dense_flat_batch B={lanes}: kernel {kt * 1e3:.1f} us, "
          f"plain {pt * 1e3:.1f} us per call (CUDA events)")
    print(f"  fgh_dense_flat_batch B={lanes}: device time kernel "
          f"{device_ms(kernel, 20) * 1e3:.2f} us, plain "
          f"{device_ms(plain, 3) * 1e3:.2f} us per call (torch.profiler)")
    return err, (kt, pt)


def run_main_path(sp, fx, dev):
    """One run of the port's main path; returns (slam, seconds)."""
    T = lambda x, dt=torch.float32: torch.as_tensor(x, dtype=dt, device=dev)
    ranges, hit = T(fx["ranges"]), T(fx["hit"], torch.bool)
    odom, u = T(fx["odom"]), T(fx["ransac_u"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slam = NDTFeatureGraphSLAM(sp, seed=0)
    slam.initialize(T(fx["gt"][0]), torch.zeros(3, device=dev), ranges[0],
                    hit[0])
    slam.run_sequence_device(odom, ranges, hit, ransac_u=u)
    torch.cuda.synchronize()
    return slam, time.perf_counter() - t0


def sequence(fx, dev):
    T = lambda x, dt=torch.float32: torch.as_tensor(x, dtype=dt,  # noqa
                                                    device=dev)
    return Sequence(T(fx["ranges"]), T(fx["hit"], torch.bool),
                    T(fx["odom"]), T(fx["gt"]))


def node_ate(node_T, fx, lc):
    gt = fx["gt"][lc["off_node_scan"]]
    return float(np.sqrt(np.mean(np.sum(
        (node_T[:, :2] - gt[:len(node_T), :2]) ** 2, -1))))


def max_dev(a, b):
    """Max deviation of two pose arrays (..., 3): xy, wrapped theta."""
    dth = a[..., 2] - b[..., 2]
    return (float(np.abs(a[..., :2] - b[..., :2]).max()),
            float(np.abs(np.arctan2(np.sin(dth), np.cos(dth))).max()))


def gate_margin(gp, lc, k):
    """Distance of JAX's link k to its nearest validation gate (score,
    both distance gates and both angle gates), against JAX's final
    node poses."""
    nT = lc["off_node_T"]
    i, j = lc["off_link_ref"][k], lc["off_link_mov"][k]
    ci, si = np.cos(nT[i, 2]), np.sin(nT[i, 2])
    dx, dy = nT[j, :2] - nT[i, :2]
    exp = np.array([ci * dx + si * dy, -si * dx + ci * dy,
                    nT[j, 2] - nT[i, 2]])
    T = lc["off_link_T"][k]
    dist = np.linalg.norm(T[:2] - exp[:2])
    ang = abs(np.arctan2(np.sin(T[2] - exp[2]), np.cos(T[2] - exp[2])))
    return min(abs(lc["off_link_score"][k] - gp.valid_max_score),
               abs(dist - gp.valid_max_dist),
               abs(dist - gp.valid_max_dist_refine),
               abs(ang - gp.valid_max_angular_dist),
               abs(ang - gp.valid_max_angular_refine))


def link_moved(a, b):
    """Per link: do poses a and b (L, 3) differ by more than 1 cm /
    5 mrad (theta wrapped)?"""
    dth = a[:, 2] - b[:, 2]
    return ((np.abs(a[:, :2] - b[:, :2]).max(1) > XY_TOL)
            | (np.abs(np.arctan2(np.sin(dth), np.cos(dth))) > TH_TOL))


def check_kept_links(gp, lc, keep, link_T, mask):
    """The kept-link set against JAX's.  A link may be kept differently
    only where JAX's value lies within 1e-3 of a gate, or where the
    link's own refined pose moved beyond 1 cm / 5 mrad from JAX's: the
    refinement's spread (see check_refinement).  Names each such link;
    returns how many differ."""
    ref_T = lc["off_link_T"]
    moved = link_moved(link_T, ref_T) | (mask != lc["off_link_mask"])
    differ = np.flatnonzero(keep != lc["off_keep"])
    for k in differ:
        i, j = lc["off_link_ref"][k], lc["off_link_mov"][k]
        margin = gate_margin(gp, lc, k)
        print(f"  link ({i}, {j}): kept {bool(keep[k])}, JAX "
              f"{bool(lc['off_keep'][k])}; JAX value {margin:.2e} from its "
              f"gate; refined pose {np.round(link_T[k], 4)} vs JAX "
              f"{np.round(ref_T[k], 4)}")
        check(margin <= 1e-3 or moved[k],
              f"link ({i}, {j}) is kept differently from JAX with the same "
              "refined pose, away from every gate")
    print(f"  {int(keep.sum())} kept links (JAX {int(lc['off_keep'].sum())}"
          f", {len(differ)} differ)")
    return len(differ)


def link_costs(bank, lc, T, sp):
    """The D2D cost of each candidate link of the record at poses T
    (L, 3) on `bank`, by the plain batch twin."""
    p = sp.fuser
    h, w = p.ndt.grid_h, p.ndt.grid_w
    dev = bank.T.device
    ref, mov = (torch.as_tensor(lc["off_link_" + k], device=dev)
                for k in ("ref", "mov"))
    budget = links_mod.source_cell_budget(bank)
    src = CellList(*(x[mov, :budget].contiguous() for x in (
        bank.cells.means, bank.cells.covs, bank.cells.mask)))
    return d2d_analytic.fgh_dense_flat_batch(
        torch.zeros((len(ref), 3), device=dev),
        torch.as_tensor(T, dtype=torch.float32, device=dev), src,
        bank.target.packed.reshape(-1, 8), bank.target.origin[ref],
        ref * h * w, h, w, p.ndt.resolution, p.matcher)[0].cpu().numpy()


def check_refinement(slam, lc, sp):
    """The proposal of optimize_offline on JAX's own node bank: the same
    candidate pairs and valid mask; RANSAC poses within 1e-5 of JAX's
    (tests/test_torch_features.py); refined poses whose summed D2D cost
    lies within 2% of that of JAX's refined poses.  Lane by lane the
    refined poses may part: the batched Newton's cost is rough (a window
    cell switches where a moved cell crosses a cell edge), so float32
    sums in another order move lanes into other minima, as moving the
    reference's own RANSAC poses by 1e-6 does (off_link_T_eps; both
    counts are printed).  Returns (lanes moved, the reference's own
    count, the summed costs: port, JAX, JAX from RANSAC poses +
    1e-6)."""
    p = sp.fuser
    ls = slam.offline_links
    for k in ("ref", "mov", "mask"):
        check(np.array_equal(getattr(ls, k).cpu().numpy(),
                             lc["off_link_" + k]),
              f"proposed links: {k} differs from JAX")
    bank = node_mod.stack_nodes(slam.nodes)
    ransac = links_mod.compute_links_batch(
        p.features, p.ndt.resolution, bank, *slam.candidate_pairs(),
        torch.as_tensor(lc["off_pair_u"][0], device=slam.device),
    ).T.cpu().numpy()
    r_dev = float(np.abs(ransac - lc["off_ransac_T"]).max())
    port_T = ls.T.cpu().numpy()
    valid = lc["off_link_mask"]
    ref_T = lc["off_link_T"]
    n_port = int(link_moved(port_T, ref_T)[valid].sum())
    n_ref = int(link_moved(lc["off_link_T_eps"], ref_T)[valid].sum())
    costs = tuple(float(link_costs(bank, lc, t, sp)[valid].sum()) for t in (
        port_T, ref_T, lc["off_link_T_eps"]))
    print(f"  RANSAC poses within {r_dev:.2e} of JAX; refined poses moved "
          f"beyond 1 cm / 5 mrad from JAX: {n_port} of {int(valid.sum())} "
          f"(the reference's own, from RANSAC poses + 1e-6: {n_ref}); "
          f"summed D2D cost {costs[0]:.2f}, JAX {costs[1]:.2f}, JAX from "
          f"RANSAC poses + 1e-6 {costs[2]:.2f}")
    check(r_dev <= 1e-5, "RANSAC poses differ from JAX beyond 1e-5")
    check(abs(costs[0] - costs[1]) <= 0.02 * abs(costs[1]),
          "the refined links' summed cost departs from JAX's beyond 2%")
    return n_port, n_ref, costs


def nearest_record(out, lc):
    """The JAX offline solution nearest to `out`: the record, or the
    record with the odometry moved by 1e-6 — the reference's own spread
    (its solve of this corridor lands centimetres apart under that
    change).  Returns (name, (xy, theta) deviation) after printing
    both."""
    devs = {"JAX": max_dev(out, lc["off_node_T"]),
            "JAX at odometry + 1e-6": max_dev(out, lc["off_alt_node_T"])}
    for name, (xy, th) in devs.items():
        print(f"  optimized node poses vs {name}: {xy * 100:.4f} cm / "
              f"{th * 1e3:.4f} mrad")
    near = min(devs, key=lambda k: devs[k][0])
    return near, devs[near]


def offline_on_jax_graph(sp, fx, lc, dev):
    """Phase 5a: optimize_offline on the reference's own graph, so that
    the slice is held to JAX on shared inputs."""
    gp = sp.graph
    edges = zip(lc["off_edge_ij"][:, 0], lc["off_edge_ij"][:, 1],
                lc["off_edge_rel"], lc["off_edge_cov"])
    slam = interop.graph_from_jax(
        sp, interop.tree_from_flat(lc, "off_bank"), lc["off_node_T_before"],
        edges, device=dev)
    slam.pair_u = [lc["off_pair_u"][0]]
    out = slam.optimize_offline().cpu().numpy()
    check(np.isfinite(out).all(), "optimized node poses are not finite")
    ls = slam.offline_links
    moved, moved_ref, costs = check_refinement(slam, lc, sp)
    differ = check_kept_links(gp, lc, slam.offline_keep,
                              ls.T.cpu().numpy(), ls.mask.cpu().numpy())
    near, (xy, th) = nearest_record(out, lc)
    check(xy <= XY_TOL and th <= TH_TOL,
          "optimized node poses deviate from JAX beyond 1 cm / 5 mrad")
    print(f"  node ATE: port {node_ate(out, fx, lc):.5f} m, JAX "
          f"{node_ate(lc['off_node_T'], fx, lc):.5f} m; nearest: {near}")
    # The solve alone: the port's fixpoint loop on JAX's own link set.
    slam.node_T = [t.copy() for t in lc["off_node_T_before"]]
    solved = slam.solve_links(interop.link_set_from_jax({
        k: lc["off_link_" + k] for k in
        ("ref", "mov", "T", "cov", "score", "mask")}, dev)).cpu().numpy()
    sxy, sth = max_dev(solved, lc["off_node_T"])
    same = bool((slam.offline_keep == lc["off_keep"]).all())
    print(f"  the port's fixpoint solve on JAX's links: kept set "
          f"{'equal' if same else 'DIFFERENT'}, node poses within "
          f"{sxy * 100:.4f} cm / {sth * 1e3:.4f} mrad of JAX")
    check(same and sxy <= XY_TOL and sth <= TH_TOL,
          "the solve on JAX's links deviates from JAX")
    return {"links_moved": moved, "links_moved_jax_1e-6": moved_ref,
            "link_cost_sums": costs,
            "kept_differ": differ, "nearest": near, "node_dev_xy_m": xy,
            "node_dev_theta_rad": th, "solve_on_jax_links_dev": (sxy, sth)}


def offline_phase(fx, lc, dev):
    """Phase 5: pipeline.run_slam + optimize_offline on bench.py's
    offline graph, against the JAX record; with phase 3b on its node
    bank and phase 5a on the reference's own graph.  Returns (summary,
    launches of the optimize_offline run, batch-entry error, times)."""
    sp = canonical_slam_params(OFFLINE_SPLIT_M, 64)
    check(repr(sp) == str(lc["off_params_repr"]),
          "canonical_lc.npz was made at other offline parameters")
    T = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    slam, stats = pipeline.run_slam(sp, sequence(fx, dev), seed=0,
                                    ransac_u=T(lc["off_scan_u"]))
    n_nodes, n_ref = len(slam.nodes), lc["off_node_T"].shape[0]
    check(n_nodes == n_ref, f"{n_nodes} nodes, JAX built {n_ref}")
    before = np.stack(slam.node_T)
    xy, th = max_dev(before, lc["off_node_T_before"])
    print(f"  graph: {n_nodes} nodes (JAX {n_ref}) from "
          f"{stats['n_updates']} gated scans; node poses before the "
          f"solve within {xy * 100:.4f} cm / {th * 1e3:.4f} mrad of JAX")

    bank = node_mod.stack_nodes(slam.nodes)
    budget = links_mod.source_cell_budget(bank)
    pairs = np.stack([lc["off_link_ref"], lc["off_link_mov"]], 1)
    print(f"phase 3b: fgh_dense_flat_batch vs plain on the card "
          f"({len(pairs)} candidate pairs, source budget {budget})")
    err, times = batch_kernel_checks(bank, pairs, lc["off_link_T"], budget,
                                     sp, dev)
    big = np.resize(pairs, (BIG_B, 2))
    err_big, _ = batch_kernel_checks(
        bank, big, np.resize(lc["off_link_T"], (BIG_B, 3)), budget, sp, dev,
        times=False)

    print("phase 5a: optimize_offline on JAX's own graph (node bank, poses "
          "and odometry edges from canonical_lc.npz)")
    on_jax = offline_on_jax_graph(sp, fx, lc, dev)

    print("phase 5: optimize_offline on the port's graph")

    def optimize():
        slam.node_T = [t.copy() for t in before]
        slam.pair_u = [lc["off_pair_u"][0]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = slam.optimize_offline().cpu().numpy()
        return out, time.perf_counter() - t0

    cuda_kernels.reset_launch_counts()
    out, _ = optimize()
    launches = dict(cuda_kernels.LAUNCHES)
    print(f"  launches in optimize_offline: {launches}")
    check(launches["fgh_dense_flat_batch"] > 0,
          "optimize_offline did not launch fgh_dense_flat_batch")
    check(np.isfinite(out).all(), "optimized node poses are not finite")
    ls = slam.offline_links
    differ = check_kept_links(sp.graph, lc, slam.offline_keep,
                              ls.T.cpu().numpy(), ls.mask.cpu().numpy())
    near, (xy, th) = nearest_record(out, lc)
    ate_before, ate = node_ate(before, fx, lc), node_ate(out, fx, lc)
    ate_ref = node_ate(lc["off_node_T"], fx, lc)
    print(f"  node ATE vs ground truth: before {ate_before:.5f} m; after "
          f"port {ate:.5f} m, JAX {ate_ref:.5f} m, JAX at odometry + 1e-6 "
          f"{node_ate(lc['off_alt_node_T'], fx, lc):.5f} m; nearest: {near}")
    check(xy <= XY_TOL and th <= TH_TOL,
          "optimized node poses deviate from JAX beyond 1 cm / 5 mrad")
    check(ate < 0.5 * ate_before and abs(ate - ate_ref) <= XY_TOL,
          "node ATE does not halve, or departs from JAX's by over 1 cm")
    runs = [optimize()[1] for _ in range(3)]
    print(f"  optimize_offline wall: {sorted(runs)[1]:.3f} s (median of 3: "
          f"{', '.join(f'{r:.3f}' for r in runs)})")

    p = sp.fuser
    all_pairs = np.asarray([(i, j) for i in range(n_nodes)
                            for j in range(i + 2, n_nodes)])

    def pairs_rate(b):
        idx = np.resize(all_pairs, (b, 2))
        ref, mov = T(idx[:, 0]), T(idx[:, 1])
        mask = torch.ones(b, dtype=torch.bool, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(b)

        def propose():
            """One batch, forced by a readback of every output."""
            u = torch.rand((b, p.features.ransac_hypotheses, 2),
                           generator=gen, device=dev)
            ls = links_mod.compute_links_batch(p.features, p.ndt.resolution,
                                               bank, ref, mov, mask, u)
            ls = links_mod.refine_links_d2d(p.ndt, p.matcher, bank, ls,
                                            src_budget=budget)
            ls = links_mod.rescore_links(p.ndt.resolution, bank, ls)
            float(ls.T.nansum() + ls.score.nansum() + ls.cov.nansum())

        propose()
        times_ = []
        for _ in range(3):
            t0 = time.perf_counter()
            propose()
            times_.append(time.perf_counter() - t0)
        return b / sorted(times_)[1], times_

    rates = {b: pairs_rate(b) for b in RATE_B}
    for b, (r, ts) in rates.items():
        print(f"  propose -> refine -> rescore at B={b}: {r:.1f} pairs/s "
              f"(median of 3: {', '.join(f'{t:.3f}' for t in ts)} s)")
    summary = {
        "nodes": n_nodes, "kept": int(slam.offline_keep.sum()),
        "kept_jax": int(lc["off_keep"].sum()), "kept_differ": differ,
        "nearest": near, "node_dev_xy_m": xy, "node_dev_theta_rad": th,
        "ate_before_m": ate_before, "ate_m": ate, "ate_jax_m": ate_ref,
        "on_jax_graph": on_jax, "optimize_s": runs,
        "pairs_per_s": {b: r for b, (r, _) in rates.items()},
        "batch_err_b1024": err_big,
    }
    return summary, launches, err, times


def online_lc_run(sp, fx, lc, dev):
    T = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    seq = sequence(fx, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slam = NDTFeatureGraphSLAM(sp, seed=0)
    slam.pair_u = list(lc["on_pair_u"])
    slam.initialize(seq.gt[0], torch.zeros(3, device=dev), seq.ranges[0],
                    seq.hit[0])
    slam.run_sequence_chunked(seq.odom, seq.ranges, seq.hit, chunk=64,
                              ransac_u=T(lc["on_scan_u"]))
    torch.cuda.synchronize()
    return slam, time.perf_counter() - t0


def online_phase(fx, lc, dev):
    """Phase 6: online loop closure in bench.py's bench_online_lc
    setting, against the JAX record."""
    sp = canonical_slam_params(2.0, 64, **LC_GRAPH)
    check(repr(sp) == str(lc["on_params_repr"]),
          "canonical_lc.npz was made at other online-LC parameters")
    cuda_kernels.reset_launch_counts()
    slam, _ = online_lc_run(sp, fx, lc, dev)
    launches = dict(cuda_kernels.LAUNCHES)
    print(f"  launches in the online-LC run: {launches}")
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched by the online-LC run")
    traj = np.stack(slam.trajectory)
    check(traj.shape == lc["on_traj"].shape and np.isfinite(traj).all(),
          "online-LC trajectory not finite / of the wrong shape")
    n_ref = lc["on_node_T"].shape[0]
    links = [list(l[:2]) for l in slam.loop_links]
    check(len(slam.nodes) == n_ref and len(links) == len(lc["on_loop_links"]),
          f"{len(slam.nodes)} nodes / {len(links)} loop links, JAX "
          f"{n_ref} / {len(lc['on_loop_links'])}")
    xy, th = max_dev(traj, lc["on_traj"])
    nxy, nth = max_dev(np.stack(slam.node_T), lc["on_node_T"])
    print(f"  {len(slam.nodes)} nodes, {len(links)} loop links "
          f"(JAX {n_ref}, {len(lc['on_loop_links'])}); trajectory within "
          f"{xy * 100:.4f} cm / {th * 1e3:.4f} mrad, node poses within "
          f"{nxy * 100:.4f} cm / {nth * 1e3:.4f} mrad of JAX")
    check(max(xy, nxy) <= XY_TOL and max(th, nth) <= TH_TOL,
          "online-LC poses deviate from JAX beyond 1 cm / 5 mrad")
    runs = [online_lc_run(sp, fx, lc, dev)[1] for _ in range(3)]
    scans = fx["ranges"].shape[0] - 1
    print(f"  online LC: {scans / sorted(runs)[1]:.2f} scans/s (median of 3 "
          f"after the checked run: {', '.join(f'{r:.3f}' for r in runs)} s "
          f"for {scans} scans)")
    return {"scans_per_s": scans / sorted(runs)[1], "run_s": runs,
            "nodes": len(slam.nodes), "loop_links": len(links),
            "dev_xy_m": max(xy, nxy), "dev_theta_rad": max(th, nth)}, launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for chip_smoke.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    dev = torch.device("cuda", 0)
    gpu = gpu_line()
    print(f"gpu: {gpu}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    print("phase 2: build")
    t0 = time.perf_counter()
    cuda_kernels.build()
    build_s = time.perf_counter() - t0
    print(f"  built {SOURCE} for sm_90a in {build_s:.2f} s")
    for line in cuda_kernels.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    fx = dict(np.load(FIXTURE))
    sp = canonical_slam_params(float(fx["split_m"]), int(fx["max_nodes"]))
    check(repr(sp) == str(fx["params_repr"]),
          "the fixture was made at other parameters than canonical_slam_params")
    print("phase 3: kernels vs plain on the card")
    errs, times = kernel_checks(sp, fx, dev)

    print("phase 4: main path, canonical 200-scan fixture")
    cuda_kernels.reset_launch_counts()
    slam, _ = run_main_path(sp, fx, dev)
    launches = dict(cuda_kernels.LAUNCHES)
    print(f"  launches in the main-path run: {launches}")
    for k in ("fgh_dense_flat", "pair_fgh_reduce"):
        check(launches[k] > 0, f"kernel {k} was not launched by the main path")
    traj = np.stack(slam.trajectory)
    check(traj.shape == fx["traj"].shape and np.isfinite(traj).all(),
          f"trajectory {traj.shape} not finite / not {fx['traj'].shape}")
    n_nodes, n_ref = len(slam.nodes), int(fx["node_T"].shape[0])
    check(n_nodes == n_ref, f"{n_nodes} frozen nodes, JAX froze {n_ref}")
    dev_xy = float(np.abs(traj[:, :2] - fx["traj"][:, :2]).max())
    dth = traj[:, 2] - fx["traj"][:, 2]
    dev_th = float(np.abs(np.arctan2(np.sin(dth), np.cos(dth))).max())
    node_dev = float(np.abs(np.stack(slam.node_T) - fx["node_T"]).max())
    ate = float(np.sqrt(np.mean(np.sum(
        (traj[:, :2] - fx["gt"][:, :2]) ** 2, -1))))
    ate_ref = float(np.sqrt(np.mean(np.sum(
        (fx["traj"][:, :2] - fx["gt"][:, :2]) ** 2, -1))))
    print(f"  {n_nodes} frozen nodes (JAX {n_ref}); max deviation from the "
          f"JAX trajectory: xy {dev_xy * 100:.4f} cm, theta "
          f"{dev_th * 1e3:.4f} mrad; node_T {node_dev:.2e}")
    print(f"  ATE vs ground truth: port {ate:.5f} m, JAX {ate_ref:.5f} m")
    check(dev_xy <= XY_TOL and dev_th <= TH_TOL,
          "trajectory deviates from the JAX reference beyond 1 cm / 5 mrad")

    runs = [run_main_path(sp, fx, dev)[1] for _ in range(3)]
    med = sorted(runs)[1]
    scans = fx["ranges"].shape[0] - 1
    print(f"  scans/s: {scans / med:.2f} (median of 3 runs after the "
          f"warm-up: {', '.join(f'{r:.3f}' for r in runs)} s for "
          f"{scans} scans)")

    lc = dict(np.load(LC_FIXTURE))
    print("phase 5: offline graph, canonical corridor, a node every "
          f"{OFFLINE_SPLIT_M} m (pipeline.run_slam)")
    offline, off_launches, errs["fgh_dense_flat_batch"], \
        times["fgh_dense_flat_batch"] = offline_phase(fx, lc, dev)
    print("phase 6: online loop closure, canonical corridor "
          "(run_sequence_chunked, chunk=64)")
    online, on_launches = online_phase(fx, lc, dev)

    # Each entry's launches in the path that uses it: the main path's two,
    # and optimize_offline's batch entry.
    path_launches = {**launches, "fgh_dense_flat_batch":
                     off_launches["fgh_dense_flat_batch"]}
    kernels = [{
        "name": k, "route": "cuda", "source": SOURCE, "replaces": REPLACES,
        "launches": path_launches[k], "max_abs_err": errs[k],
        "ms": times[k][0], "plain_ms": times[k][1],
    } for k in ("fgh_dense_flat", "pair_fgh_reduce", "fgh_dense_flat_batch")]
    record = {
        "gpu": gpu, "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": build_s, "kernels": kernels,
        "main_path": {"scans_per_s": scans / med, "run_s": runs,
                      "nodes": n_nodes, "dev_xy_m": dev_xy,
                      "dev_theta_rad": dev_th, "node_T_dev": node_dev,
                      "ate_m": ate, "ate_jax_m": ate_ref},
        "offline": offline, "online_lc": online,
        "launches": {"main_path": launches, "optimize_offline": off_launches,
                     "online_lc": on_launches},
    }
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(f"{gpu}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
