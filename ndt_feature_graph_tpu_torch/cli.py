"""Command-line interface of the port (ndt_feature_graph_tpu/cli.py):

  simulate    a synthetic sequence (raycast lidar in the segment world),
              written as a sequence npz or a .bag
  slam        online graph SLAM over a sequence, optionally followed by
              the offline optimization (--optimize)
  optimize    offline loop closure on a graph checkpoint (flags mirror
              graph_opt.cpp:38-56)
  fuse        scan-to-map NDT odometry, optionally over the HMT tile
              store (--hmt-dir, --resume)
  localize    MCL tracking, or kidnapped-robot recovery (--kidnapped)
  calibrate   laser->base extrinsic grid search over scan pairs
  export-map  stitched occupancy PGM from a graph checkpoint
  eval        ATE between two TUM trajectory files

Sequences are a sequence npz, a CARMEN log (.clf / .log) or a ROS bag
(.bag); checkpoints, sequences and HMT directories are the reference's
files, and load in both packages.  `slam --plot` writes overview.png,
`slam --html` an interactive viewer.html.

Run:  python -m ndt_feature_graph_tpu_torch.cli [--device cpu] <cmd> --help
"""

from __future__ import annotations

import argparse
import json
import os


def _params_from_args(a):
    from ndt_feature_graph_tpu_torch.config import (
        FeatureParams, FuserParams, GraphParams, NDTMapParams, SLAMParams,
    )

    return SLAMParams(
        fuser=FuserParams(
            ndt=NDTMapParams(
                resolution=a.resolution, size_x=a.map_size,
                size_y=a.map_size, sensor_range=a.sensor_range,
                max_points_per_scan=max(a.num_beams, 512),
                max_cells=a.max_cells,
            ),
            features=FeatureParams(num_beams=a.num_beams,
                                   max_range=a.sensor_range),
        ),
        graph=GraphParams(
            new_node_transl_dist=a.new_node_dist, max_nodes=a.max_nodes,
            valid_max_score=a.max_score, valid_max_dist=a.max_dist,
            valid_max_angular_dist=a.max_angular_dist,
            valid_min_idx_dist=a.min_idx_dist,
            online_loop_closure=a.online_lc, solver=a.solver,
        ),
    )


def _add_common(p):
    p.add_argument("--resolution", type=float, default=0.5)
    p.add_argument("--map-size", type=float, default=40.0)
    p.add_argument("--sensor-range", type=float, default=15.0)
    p.add_argument("--num-beams", type=int, default=360)
    p.add_argument("--max-cells", type=int, default=512)
    p.add_argument("--new-node-dist", type=float, default=3.0)
    p.add_argument("--max-nodes", type=int, default=64)
    # getValidLinks gates (graph_opt.cpp:49-52 defaults).
    p.add_argument("--max-score", type=float, default=0.1)
    p.add_argument("--max-dist", type=float, default=1.0)
    p.add_argument("--max-angular-dist", type=float, default=0.2)
    p.add_argument("--min-idx-dist", type=int, default=2)
    p.add_argument(
        "--solver", choices=["auto", "dense", "direct"], default="auto",
        help="pose-graph solver: dense, exact segment-Schur (O(E) memory), "
             "or auto by node count",
    )
    p.add_argument(
        "--online-lc", action="store_true",
        help="close loops online at node splits (incremental solve)",
    )


def _load_sequence(path, device, max_range=30.0):
    """A sequence npz, CARMEN log (.clf / .log) or bag (.bag) on
    `device`; the logs' ranges are clipped at `max_range`."""
    from ndt_feature_graph_tpu_torch.io import dataset

    if path.endswith((".clf", ".log")):
        from ndt_feature_graph_tpu_torch.io import carmen

        return carmen.read_carmen_sequence(path, max_range=max_range,
                                           device=device)
    if path.endswith(".bag"):
        from ndt_feature_graph_tpu_torch.io import rosbag

        return rosbag.read_bag_sequence(path, max_range=max_range,
                                        device=device)[0]
    return dataset.load_sequence(path, device=device)


def cmd_simulate(a):
    """A synthetic sequence: the loop or corridor trajectory through the
    default world, its noise drawn on the device from a torch.Generator
    seeded with --seed (the reference draws from jax.random, so the same
    seed gives other noise)."""
    import torch

    from ndt_feature_graph_tpu_torch.io import dataset

    if a.trajectory == "loop":
        traj = dataset.loop_trajectory(a.steps, radius=a.radius,
                                       device=a.device)
    else:
        traj = dataset.corridor_trajectory(a.steps, device=a.device)
    gen = torch.Generator(a.device)
    gen.manual_seed(a.seed)
    seq = dataset.simulate_sequence(
        traj, num_beams=a.num_beams, max_range=a.sensor_range,
        odom_noise=(a.odom_noise, a.odom_noise, a.odom_noise / 2.5),
        generator=gen, device=a.device,
    )
    if a.out.endswith(".bag"):
        from ndt_feature_graph_tpu_torch.io import rosbag

        rosbag.write_bag(a.out, seq, max_range=a.sensor_range)
    else:
        dataset.save_sequence(a.out, seq)
    print(f"wrote {a.out}: {traj.shape[0]} steps, {a.num_beams} beams")


def _sync_beams(a, seq):
    """The dataset decides the beam count; the flag is only a default."""
    nb = int(seq.ranges.shape[1])
    if nb != a.num_beams:
        print(f"note: dataset has {nb} beams (flag said {a.num_beams})")
        a.num_beams = nb


def cmd_slam(a):
    import numpy as np

    from ndt_feature_graph_tpu_torch import pipeline
    from ndt_feature_graph_tpu_torch.io import tum

    seq = _load_sequence(a.dataset, a.device, a.sensor_range)
    _sync_beams(a, seq)
    slam, stats = pipeline.run_slam(_params_from_args(a), seq, verbose=True)
    stats["ate_rmse_m"] = pipeline.evaluate(slam, seq)
    print(json.dumps(stats))

    os.makedirs(a.out, exist_ok=True)
    gt = seq.gt.cpu().numpy()[np.asarray(slam.times, int)]
    tum.write_tum(os.path.join(a.out, "est.tum"), slam.times,
                  np.stack(slam.trajectory))
    tum.write_tum(os.path.join(a.out, "gt.tum"), slam.times, gt)
    slam.save(os.path.join(a.out, "graph.npz"))
    if a.plot:
        from ndt_feature_graph_tpu_torch.viz import plot

        plot.save_slam_overview(os.path.join(a.out, "overview.png"), slam,
                                gt=gt)
    if a.html:
        from ndt_feature_graph_tpu_torch.viz import html as viz_html

        viz_html.export_html(os.path.join(a.out, "viewer.html"), slam, gt=gt)
    if a.optimize:
        slam.optimize_offline(verbose=True)
        tum.write_tum(os.path.join(a.out, "nodes_opt.tum"),
                      list(range(len(slam.node_T))), np.stack(slam.node_T))
    print(f"outputs in {a.out}")


def cmd_optimize(a):
    import numpy as np

    from ndt_feature_graph_tpu_torch.graph.slam import NDTFeatureGraphSLAM
    from ndt_feature_graph_tpu_torch.io import tum

    slam = NDTFeatureGraphSLAM.load(a.graph, _params_from_args(a),
                                    device=a.device)
    print(f"loaded {len(slam.nodes)} nodes, "
          f"{len(slam.odom_edges)} odometry edges")
    before = np.stack(slam.node_T)
    out = slam.optimize_offline(verbose=True).cpu().numpy()
    print("max node move:", float(np.max(np.linalg.norm(
        out[:, :2] - before[:, :2], axis=1))))
    tum.write_tum(a.out, list(range(len(out))), out)
    print(f"wrote {a.out}")


def cmd_fuse(a):
    """Scan-to-submap NDT odometry (the NDTFuserHMT node); --hmt-dir
    keeps the live map in the HMT tile store (recentres spill evicted
    cells to it and recall revisited ground) and saves it there at the
    end; --resume continues from that directory."""
    import time

    import numpy as np
    import torch

    from ndt_feature_graph_tpu_torch.fusion import fuser, scan_driver
    from ndt_feature_graph_tpu_torch.fusion.hmt_driver import HMTFuser
    from ndt_feature_graph_tpu_torch.io import dataset, tum

    seq = _load_sequence(a.dataset, a.device, a.sensor_range)
    _sync_beams(a, seq)
    params = _params_from_args(a).fuser
    pts_all, mask_all = dataset.scan_to_points(seq.ranges, seq.hit)
    zero = torch.zeros(3, device=a.device)
    t0 = time.perf_counter()
    if a.hmt_dir:
        if a.resume and os.path.exists(os.path.join(a.hmt_dir, "hmt.json")):
            hf = HMTFuser.load(a.hmt_dir, params, device=a.device)
        else:
            hf = HMTFuser(params, seq.gt[0], zero, pts_all[0], mask_all[0],
                          recenter_margin=a.recenter_margin)
        traj = hf.run_sequence(seq.odom[1:], pts_all[1:], mask_all[1:],
                               chunk=a.chunk)
        hf.save(a.hmt_dir)
        extra = {"n_recenters": hf.n_recenters,
                 "stored_cells": hf.stored_cell_count(),
                 "recenter_s": [round(x, 3) for x in hf.recenter_times]}
    else:
        state = fuser.initialize(params, seq.gt[0], zero, pts_all[0],
                                 mask_all[0])
        _, traj, _ = scan_driver.run_sequence(
            params, state, seq.odom[1:], pts_all[1:], mask_all[1:])
        traj = traj.cpu().numpy()
        extra = {}
    wall = time.perf_counter() - t0
    n = traj.shape[0]
    gt = seq.gt[1:n + 1].cpu().numpy()
    ate = float(np.sqrt(np.mean(np.sum((traj[:, :2] - gt[:, :2]) ** 2,
                                       -1))))
    os.makedirs(a.out, exist_ok=True)
    tum.write_tum(os.path.join(a.out, "est.tum"), list(range(1, n + 1)),
                  traj)
    print(json.dumps({"n_scans": n, "wall_s": round(wall, 3),
                      "scans_per_sec": round(n / max(wall, 1e-9), 2),
                      "ate_rmse_m": round(ate, 4), **extra}))
    print(f"outputs in {a.out}")


def cmd_localize(a):
    """MCL tracking over the second half of a sequence, or (--kidnapped)
    relocalization by place recognition gated on scan-pose badness,
    against the map of the first half at ground-truth poses — the
    MCL-node and localization-monitor roles.  Draws come from
    torch.Generators seeded with 0 (MCL) and 1 (RANSAC), the constants
    of the reference's fixed keys."""
    import numpy as np
    import torch

    from ndt_feature_graph_tpu_torch.config import FeatureParams, MotionParams
    from ndt_feature_graph_tpu_torch.core import se2
    from ndt_feature_graph_tpu_torch.io import dataset
    from ndt_feature_graph_tpu_torch.localization import mcl, place_rec
    from ndt_feature_graph_tpu_torch.ops import d2d, ndt_map

    seq = _load_sequence(a.dataset, a.device, a.sensor_range)
    _sync_beams(a, seq)
    mp = _params_from_args(a).fuser.ndt
    t_total = int(seq.gt.shape[0])
    split = t_total // 2

    # The map of the first half at ground-truth poses.
    grid = ndt_map.empty_grid(mp, torch.zeros(2, device=a.device))
    fp = FeatureParams(num_beams=a.num_beams, max_range=a.sensor_range)
    db = place_rec.empty_database(fp, 32, a.device)
    for t in range(0, split, 2):
        pts, mask = dataset.scan_to_points(seq.ranges[t], seq.hit[t])
        world = se2.transform_points(seq.gt[t], pts)
        grid = ndt_map.add_points(grid, mp, world, mask)
        grid = ndt_map.update_occupancy(grid, mp, seq.gt[t][:2], world, mask)
        db = place_rec.insert_scan(db, fp, seq.gt[t], seq.ranges[t],
                                   seq.hit[t])

    if a.kidnapped:
        from ndt_feature_graph_tpu_torch.localization import monitor

        # The robot wakes up inside the mapped area, at a scan the
        # database does not hold (odd index).
        q = split // 3 * 2 + 1
        gen = torch.Generator(a.device)
        gen.manual_seed(1)
        u = torch.rand((db.poses.shape[0], fp.ransac_hypotheses, 2),
                       generator=gen, device=a.device)
        pose, _, n = place_rec.relocalize(db, fp, seq.ranges[q], seq.hit[q],
                                          u, min_num_matches=a.min_matches)
        badness = float("nan")
        if pose is not None:
            # Gate on scan-pose badness, as the localization monitor does
            # before publishing (localization_monitor_node.cpp:376-396).
            dmap = monitor.build_distance_map(grid.occ, grid.origin,
                                              mp.resolution)
            pts_q, mask_q = dataset.scan_to_points(seq.ranges[q],
                                                   seq.hit[q])
            badness = float(monitor.badness(
                dmap, torch.as_tensor(pose, device=a.device), pts_q, mask_q))
            if badness > a.max_badness:
                pose = None
        err = (float(np.linalg.norm(pose[:2] - seq.gt[q, :2].cpu().numpy()))
               if pose is not None else float("nan"))
        print(json.dumps({"relocalized": pose is not None, "inliers": n,
                          "badness_m": badness, "position_error_m": err}))
        return

    loc = mcl.MCL(mp, MotionParams(), d2d.make_dense_target(grid, mp),
                  n_particles=a.particles, seed=0)
    loc.initialize(seq.gt[split], spread_xy=0.5, spread_theta=0.2)
    errs = []
    for t in range(split + 1, t_total):
        pts, mask = dataset.scan_to_points(seq.ranges[t], seq.hit[t])
        est = loc.step(seq.odom[t], pts, mask)
        errs.append(float(torch.linalg.vector_norm(est[:2] - seq.gt[t][:2])))
    print(json.dumps({"steps": len(errs),
                      "mean_error_m": float(np.mean(errs)),
                      "final_error_m": errs[-1] if errs else None}))


def calibration_pairs(t_total: int, n_pairs: int):
    """The scan pairs `calibrate` scores: (k, k + step) for the first
    `n_pairs` multiples k of step = t_total // (n_pairs + 1)."""
    step = max(1, t_total // (n_pairs + 1))
    return [(k, k + step) for k in range(
        0, min(n_pairs * step, t_total - step), step)]


def cmd_calibrate(a):
    """Laser->base extrinsic grid search over scan pairs (the
    laser2d_extrinsic_calibration role)."""
    from ndt_feature_graph_tpu_torch.core import se2
    from ndt_feature_graph_tpu_torch.io import dataset
    from ndt_feature_graph_tpu_torch.utils import pairwise

    seq = _load_sequence(a.dataset, a.device, a.sensor_range)
    pairs, rels = [], []
    for i, j in calibration_pairs(int(seq.gt.shape[0]), a.pairs):
        pairs.append((dataset.scan_to_points(seq.ranges[i], seq.hit[i]),
                      dataset.scan_to_points(seq.ranges[j], seq.hit[j])))
        rels.append(se2.sub(seq.gt[i], seq.gt[j]))
    best, scores = pairwise.calibrate_extrinsic(
        pairs, rels, search_xy=a.search_xy, search_theta=a.search_theta,
        n=a.grid)
    print(json.dumps({"extrinsic": [float(x) for x in best.cpu()],
                      "candidates": int(scores.shape[0])}))


def cmd_export_map(a):
    """Stitched occupancy export from a graph checkpoint."""
    from ndt_feature_graph_tpu_torch.graph.slam import NDTFeatureGraphSLAM
    from ndt_feature_graph_tpu_torch.utils import occupancy

    slam = NDTFeatureGraphSLAM.load(a.graph, _params_from_args(a),
                                    device=a.device)
    prob, origin, res = occupancy.stitch_graph_occupancy(slam)
    occupancy.write_pgm(a.out, prob)
    print(json.dumps({"cells": list(prob.shape),
                      "origin": [float(x) for x in origin],
                      "resolution": res, "out": a.out}))


def cmd_eval(a):
    from ndt_feature_graph_tpu_torch.io import tum

    _, est = tum.read_tum(a.est)
    _, gt = tum.read_tum(a.gt)
    n = min(len(est), len(gt))
    print(json.dumps({
        "ate_rmse_m": tum.ate_rmse(est[:n], gt[:n]),
        "ate_rmse_aligned_m": tum.ate_rmse(est[:n], gt[:n], align=True),
        "poses": n,
    }))


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="ndt_feature_graph_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the port runs (default: the CUDA card)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("simulate", help="generate a synthetic sequence")
    p.add_argument("--out", required=True,
                   help="sequence npz, or a .bag")
    p.add_argument("--trajectory", choices=["loop", "corridor"],
                   default="loop")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--radius", type=float, default=5.0)
    p.add_argument("--num-beams", type=int, default=360)
    p.add_argument("--sensor-range", type=float, default=15.0)
    p.add_argument("--odom-noise", type=float, default=0.02)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_simulate)

    p = sub.add_parser("slam", help="run online graph SLAM")
    p.add_argument("--dataset", required=True,
                   help="sequence npz, .clf / .log or .bag")
    p.add_argument("--out", required=True)
    p.add_argument("--optimize", action="store_true")
    p.add_argument("--plot", action="store_true",
                   help="write an overview figure (overview.png)")
    p.add_argument("--html", action="store_true",
                   help="write an interactive viewer (viewer.html)")
    _add_common(p)
    p.set_defaults(fn=cmd_slam)

    p = sub.add_parser("optimize", help="offline loop-closure optimization")
    p.add_argument("--graph", required=True, help="graph.npz checkpoint")
    p.add_argument("--out", required=True, help="optimized nodes TUM file")
    _add_common(p)
    p.set_defaults(fn=cmd_optimize)

    p = sub.add_parser(
        "fuse", help="scan-to-submap NDT odometry (NDTFuserHMT node); "
        "--hmt-dir keeps the live map in the HMT tile store")
    p.add_argument("--dataset", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--hmt-dir", default=None,
                   help="HMT tile-store directory (beHMT + hmt_map_dir)")
    p.add_argument("--resume", action="store_true",
                   help="resume from an existing --hmt-dir")
    p.add_argument("--recenter-margin", type=float, default=10.0)
    p.add_argument("--chunk", type=int, default=16)
    _add_common(p)
    p.set_defaults(fn=cmd_fuse)

    p = sub.add_parser("localize",
                       help="MCL tracking / kidnapped-robot recovery")
    p.add_argument("--dataset", required=True)
    p.add_argument("--kidnapped", action="store_true")
    p.add_argument("--particles", type=int, default=512)
    p.add_argument("--min-matches", type=int, default=8)
    p.add_argument("--max-badness", type=float, default=0.5)
    _add_common(p)
    p.set_defaults(fn=cmd_localize)

    p = sub.add_parser("calibrate", help="laser extrinsic grid search")
    p.add_argument("--dataset", required=True)
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--search-xy", type=float, default=0.4)
    p.add_argument("--search-theta", type=float, default=0.25)
    p.add_argument("--grid", type=int, default=7)
    _add_common(p)
    p.set_defaults(fn=cmd_calibrate)

    p = sub.add_parser("export-map",
                       help="stitched occupancy PGM from a checkpoint")
    p.add_argument("--graph", required=True)
    p.add_argument("--out", required=True)
    _add_common(p)
    p.set_defaults(fn=cmd_export_map)

    p = sub.add_parser("eval", help="ATE between TUM files")
    p.add_argument("--est", required=True)
    p.add_argument("--gt", required=True)
    p.set_defaults(fn=cmd_eval)

    a = ap.parse_args(argv)
    if a.cmd != "eval":
        from ndt_feature_graph_tpu_torch import resolve_device

        # The card unless --device cpu; raises where there is none.
        a.device = resolve_device(None if a.device == "cuda" else "cpu")
    a.fn(a)


if __name__ == "__main__":
    main()
