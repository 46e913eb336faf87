"""How far the chunked graph driver's scores and poses move against the
run they are compared with, and how far the run itself moves under an
odometry change of rounding size.

    python3 examples/measure_chunk_spread.py --card [--out DIR]
    python3 examples/measure_chunk_spread.py --inputs [--out DIR]
    JAX_PLATFORMS=cpu python examples/measure_chunk_spread.py --reference

--card (on a CUDA card; no JAX): scan_driver.run_graph_chunk over the
canonical fixture's scans 1-16 from the state after initialize on scan 0,
with the fixture's RANSAC draws (tests/test_torch_cuda.py's chunk test),
on the card and on the CPU twin.  Per scan: the card-vs-CPU gap of the
score (relative) and of the pose; the CPU run's own spread, its runs with
the chunk's odometry x and y moved by +-k * 1e-6 m (k = 1, 2) against
its unmoved run; and the card's own spread under +-1e-6 m.  A scan whose
card-vs-CPU gap lies outside both spreads is a fault of the kernel path,
not the chaos of the registration.  To tell the kernel's parts apart,
the card also runs the chunk with each registration through the
per-trial path (d2d.newton_match over `newton_objective`: the kernel's
objective, the LM step in eager operations) and through the plain twin
(newton_solve_reference: torch's operations on the card), and per scan
each run's score and pose against the CPU's are printed.

--inputs (on a CUDA card): where the card's scan 1 parts from the CPU's.
From the state after initialize on scan 0, on the card and on the CPU:
the largest difference of each input of scan 1's registration (the
state's packed table, the scan's points, the feature detection and
description, the RANSAC pose, the paired feature cells, the matcher's
source cells), then the registration's score on the CPU over the CPU's
inputs with each input in turn replaced by the card's.

--reference (on the CPU, with the JAX package):
tests/test_torch_graph_chunk.py's chunks (its 28-scan loop, its three
cases) through the reference's run_graph_chunk with the odometry moved
by +-k * 1e-6 m (k = 1, 2, 3), and the port's chunk: per row the
reference's own relative score spread and pose spread under each change,
beside the port's deviation from the reference.

Prints one line a scan and a JSON summary; with --out DIR it also writes
DIR/chunk_spread_<mode>.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CARD_EPS = (1e-6, -1e-6)
CPU_EPS = (1e-6, -1e-6, 2e-6, -2e-6)
REF_EPS = (1e-6, -1e-6, 2e-6, -2e-6, 3e-6, -3e-6)


def _card():
    import chip_smoke
    from ndt_feature_graph_tpu_torch.fusion import scan_driver
    from ndt_feature_graph_tpu_torch.graph.slam import NDTFeatureGraphSLAM
    from ndt_feature_graph_tpu_torch.ops import cuda_kernels

    if not torch.cuda.is_available():
        raise SystemExit("measure_chunk_spread --card: no CUDA device")
    fx = dict(np.load(chip_smoke.FIXTURE))
    sp = chip_smoke.canonical_slam_params(float(fx["split_m"]),
                                          int(fx["max_nodes"]))

    def run(dev, eps=0.0, solve=None):
        inner = cuda_kernels.newton_solve
        if solve is not None:
            cuda_kernels.newton_solve = solve
        try:
            return _run(dev, eps)
        finally:
            cuda_kernels.newton_solve = inner

    def _run(dev, eps):
        T = lambda x, dt=torch.float32: torch.as_tensor(  # noqa: E731
            x, dtype=dt, device=dev)
        ranges, hit = T(fx["ranges"][:17]), T(fx["hit"][:17], torch.bool)
        odom = fx["odom"][1:17].astype(np.float32).copy()
        odom[:, :2] += np.float32(eps)
        slam = NDTFeatureGraphSLAM(sp, seed=0)
        slam.initialize(T(fx["gt"][0]), torch.zeros(3, device=dev),
                        ranges[0], hit[0])
        _, _, traj, scores, meta = scan_driver.run_graph_chunk(
            sp.fuser, slam.state, slam.fmap, 0.0, 0, T(odom), ranges[1:],
            hit[1:], np.ones(16, bool), sp.graph.new_node_transl_dist,
            fm_incr=sp.fuser.feature_map_update_incr,
            ransac_u=T(fx["ransac_u"][:16]))
        n = int(meta[2])
        return traj.cpu().numpy()[:n], scores.cpu().numpy()[:n]

    dev = torch.device("cuda", 0)
    card, cpu = run(dev), run("cpu")
    cpu_eps = [run("cpu", e) for e in CPU_EPS]
    card_eps = [run(dev, e) for e in CARD_EPS]
    variants = {
        "per-trial": run(dev, solve=lambda *a: chip_smoke.per_trial_solve(
            a)(a[0])),
        "plain twin": run(dev, solve=cuda_kernels.newton_solve_reference)}
    n = min(len(card[1]), len(cpu[1]))

    def rel(a, b):
        return np.abs(a - b) / np.abs(b)

    def pose(a, b):
        return np.abs(a - b).max(-1)

    rows = []
    for i in range(n):
        row = {
            "scan": i + 1,
            "card_cpu_score_rel": float(rel(card[1][i], cpu[1][i])),
            "card_cpu_pose": float(pose(card[0][i], cpu[0][i])),
            "cpu_spread_score_rel": [float(rel(r[1][i], cpu[1][i]))
                                     for r in cpu_eps],
            "cpu_spread_pose": [float(pose(r[0][i], cpu[0][i]))
                                for r in cpu_eps],
            "card_spread_score_rel": [float(rel(r[1][i], card[1][i]))
                                      for r in card_eps],
        }
        for k, r in variants.items():
            row[f"{k}_cpu_score_rel"] = float(rel(r[1][i], cpu[1][i]))
            row[f"{k}_cpu_pose"] = float(pose(r[0][i], cpu[0][i]))
        row["scores"] = {"cpu": float(cpu[1][i]), "card": float(card[1][i]),
                         **{k: float(r[1][i]) for k, r in variants.items()}}
        spread = max(row["cpu_spread_score_rel"]
                     + row["card_spread_score_rel"])
        row["outside_spread"] = row["card_cpu_score_rel"] > spread
        rows.append(row)
        print(f"scan {i + 1:2d}: card-vs-CPU score "
              f"{row['card_cpu_score_rel']:.3e}"
              f" pose {row['card_cpu_pose']:.2e}; CPU spread (eps "
              f"{CPU_EPS}) score "
              + " ".join(f"{x:.2e}" for x in row["cpu_spread_score_rel"])
              + " pose " + " ".join(f"{x:.1e}" for x in row["cpu_spread_pose"])
              + "; card spread (eps "
              f"{CARD_EPS}) score "
              + " ".join(f"{x:.2e}" for x in row["card_spread_score_rel"])
              + ("  OUTSIDE" if row["outside_spread"] else ""))
        print("         against the CPU: " + "; ".join(
            f"{k} score {row[f'{k}_cpu_score_rel']:.3e} pose "
            f"{row[f'{k}_cpu_pose']:.2e}" for k in variants)
            + "; scores " + " ".join(f"{k} {v!r}"
                                     for k, v in row["scores"].items()))
    return {"mode": "card", "gpu": torch.cuda.get_device_name(0),
            "scans": n, "cpu_eps": CPU_EPS, "card_eps": CARD_EPS,
            "max_card_cpu_score_rel": max(r["card_cpu_score_rel"]
                                          for r in rows),
            "max_card_cpu_pose": max(r["card_cpu_pose"] for r in rows),
            "scans_outside_spread": [r["scan"] for r in rows
                                     if r["outside_spread"]],
            "rows": rows}


def _inputs():
    import chip_smoke
    from ndt_feature_graph_tpu_torch.fusion import feature_fuser, fuser
    from ndt_feature_graph_tpu_torch.graph.node import map_tensors
    from ndt_feature_graph_tpu_torch.graph.slam import NDTFeatureGraphSLAM

    if not torch.cuda.is_available():
        raise SystemExit("measure_chunk_spread --inputs: no CUDA device")
    fx = dict(np.load(chip_smoke.FIXTURE))
    sp = chip_smoke.canonical_slam_params(float(fx["split_m"]),
                                          int(fx["max_nodes"]))
    p = sp.fuser

    def inputs(dev):
        T = lambda x, dt=torch.float32: torch.as_tensor(  # noqa: E731
            x, dtype=dt, device=dev)
        slam = NDTFeatureGraphSLAM(sp, seed=0)
        slam.initialize(T(fx["gt"][0]), torch.zeros(3, device=dev),
                        T(fx["ranges"][0]), T(fx["hit"][0], torch.bool))
        st = slam.state
        odom, ranges = T(fx["odom"][1]), T(fx["ranges"][1])
        hit, u = T(fx["hit"][1], torch.bool), T(fx["ransac_u"][0])
        pts, mask, feats, desc, fs, ft, res = feature_fuser._prepare_features(
            st, p, odom, ranges, hit, u)
        src = fuser._match_cells(p, st.base.sensor_pose, pts, mask)
        return {"state": st, "odom": odom, "pts": pts, "mask": mask,
                "feats": feats, "desc": desc, "ransac_T": res.T,
                "feat_src": fs, "feat_tgt": ft, "src": src}

    card, cpu = inputs(torch.device("cuda", 0)), inputs("cpu")
    cpu_of = lambda v: map_tensors(lambda x: x.cpu(), v)  # noqa: E731

    def leaves(v):
        out = []
        map_tensors(lambda x: out.append(x) or x, v)
        return out

    diffs = {}
    for k in card:
        a, b = leaves(cpu_of(card[k])), leaves(cpu[k])
        diffs[k] = max((float((x.double() - y.double()).abs().max())
                        if x.numel() else 0.0) for x, y in zip(a, b))
        print(f"{k}: card vs CPU max |difference| {diffs[k]:.3e}")

    def score(swap=()):
        v = {k: (cpu_of(card[k]) if k in swap else cpu[k]) for k in cpu}
        _, info = fuser.update(v["state"].base, p, v["odom"], v["pts"],
                               v["mask"], v["feat_src"], v["feat_tgt"])
        return float(info.score)

    base = score()
    swaps = {k: score((k,)) for k in ("state", "pts", "feat_src",
                                      "feat_tgt")}
    swaps["feat_src+feat_tgt"] = score(("feat_src", "feat_tgt"))
    swaps["all"] = score(tuple(cpu))
    print(f"scan 1's score on the CPU: {base!r}; with the card's "
          + "; ".join(f"{k}: {v!r} ({abs(v - base) / abs(base):.2e})"
                      for k, v in swaps.items()))
    return {"mode": "inputs", "gpu": torch.cuda.get_device_name(0),
            "max_abs_diff": diffs, "score_cpu": base, "score_swapped": swaps}


def _reference():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import conftest  # noqa: F401  (JAX on the CPU, highest precision)
    import test_torch_graph_chunk as T

    out = {"mode": "reference", "eps": REF_EPS, "cases": {}}
    for case in T.CASES:
        split, cnt, n_active = T.CASES[case]
        ref = T._jax_chunk(case)
        n = int(ref[4][2])
        moved = [T._jax_chunk(case, e) for e in REF_EPS]
        _, jstate, _ = T._start()
        odom, ranges, hit, active = T._chunk_inputs(n_active)
        u = torch.tensor(T._draws(jstate.key, T.K))
        st0, fm0 = T._port_start()
        t = torch.tensor
        _, _, traj, scores, _ = T.tsd.run_graph_chunk(
            T.TP, st0, fm0, 0.0, cnt, t(odom), t(ranges), t(hit),
            t(active), split, fm_incr=T.FM_INCR, ransac_u=u)
        rows = []
        for i in range(n):
            s0 = float(ref[3][i])
            row = {"scan": i + 1,
                   "ref_spread_score_rel": [abs(float(m[3][i]) - s0)
                                            / abs(s0) for m in moved],
                   "ref_spread_pose": [float(np.abs(m[2][i] - ref[2][i])
                                             .max()) for m in moved],
                   "port_score_rel": abs(float(scores[i]) - s0) / abs(s0),
                   "port_pose": float(np.abs(traj[i].numpy()
                                             - ref[2][i]).max())}
            rows.append(row)
            print(f"{case} scan {i + 1}: port score "
                  f"{row['port_score_rel']:.3e}"
                  f" pose {row['port_pose']:.2e}; reference spread (eps "
                  f"{REF_EPS}) score "
                  + " ".join(f"{x:.2e}" for x in row["ref_spread_score_rel"])
                  + " pose "
                  + " ".join(f"{x:.1e}" for x in row["ref_spread_pose"]))
        out["cases"][case] = rows
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--card", action="store_true")
    mode.add_argument("--inputs", action="store_true")
    mode.add_argument("--reference", action="store_true")
    ap.add_argument("--out", help="directory for chunk_spread_<mode>.json")
    args = ap.parse_args()
    out = (_card() if args.card else _inputs() if args.inputs
           else _reference())
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out,
                               f"chunk_spread_{out['mode']}.json"), "w") as f:
            json.dump(out, f, indent=1)
    summary = {k: v for k, v in out.items() if k not in ("rows", "cases")}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
