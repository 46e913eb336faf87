"""Command-line interface of the port (ndt_feature_graph_tpu/cli.py):

  slam        online graph SLAM over a sequence npz, optionally followed
              by the offline optimization (--optimize)
  optimize    offline loop closure on a graph checkpoint (flags mirror
              graph_opt.cpp:38-56)
  export-map  stitched occupancy PGM from a graph checkpoint
  eval        ATE between two TUM trajectory files

Checkpoints and sequences are the reference's files: a graph.npz either
package wrote loads in both.  The subcommands simulate, fuse, localize
and calibrate, and .clf / .bag inputs, belong to later slices of the
port and exit with a message saying which.

Run:  python -m ndt_feature_graph_tpu_torch.cli [--device cpu] <cmd> --help
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# What each subcommand or input the port does not run yet waits for
# (ROADMAP.md, queue 1).
NOT_PORTED = {
    "simulate": "the simulator and I/O slice (ROADMAP queue 1, item 3)",
    "fuse": "the HMT slice (ROADMAP queue 1, item 2)",
    "localize": "the localization slice (ROADMAP queue 1, item 1)",
    "calibrate": "the simulator and I/O slice (ROADMAP queue 1, item 3: "
                 "utils/pairwise.py)",
    ".clf": "the simulator and I/O slice (ROADMAP queue 1, item 3: "
            "io/carmen.py)",
    ".log": "the simulator and I/O slice (ROADMAP queue 1, item 3: "
            "io/carmen.py)",
    ".bag": "the simulator and I/O slice (ROADMAP queue 1, item 3: "
            "io/rosbag.py)",
}


def _not_ported(what):
    sys.exit(f"ndt_feature_graph_tpu_torch: {what} is not ported yet; it "
             f"comes with {NOT_PORTED[what]}")


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


def _load_sequence(path, device):
    from ndt_feature_graph_tpu_torch.io import dataset

    for ext in (".clf", ".log", ".bag"):
        if path.endswith(ext):
            _not_ported(ext)
    return dataset.load_sequence(path, device=device)


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

    seq = _load_sequence(a.dataset, a.device)
    _sync_beams(a, seq)
    slam, stats = pipeline.run_slam(_params_from_args(a), seq, verbose=True)
    stats["ate_rmse_m"] = pipeline.evaluate(slam, seq)
    print(json.dumps(stats))

    os.makedirs(a.out, exist_ok=True)
    t_idx = np.asarray(slam.times, int)
    tum.write_tum(os.path.join(a.out, "est.tum"), slam.times,
                  np.stack(slam.trajectory))
    tum.write_tum(os.path.join(a.out, "gt.tum"), slam.times,
                  seq.gt.cpu().numpy()[t_idx])
    slam.save(os.path.join(a.out, "graph.npz"))
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

    p = sub.add_parser("slam", help="run online graph SLAM")
    p.add_argument("--dataset", required=True, help="sequence npz")
    p.add_argument("--out", required=True)
    p.add_argument("--optimize", action="store_true")
    _add_common(p)
    p.set_defaults(fn=cmd_slam)

    p = sub.add_parser("optimize", help="offline loop-closure optimization")
    p.add_argument("--graph", required=True, help="graph.npz checkpoint")
    p.add_argument("--out", required=True, help="optimized nodes TUM file")
    _add_common(p)
    p.set_defaults(fn=cmd_optimize)

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

    for name in ("simulate", "fuse", "localize", "calibrate"):
        sub.add_parser(name, add_help=False,
                       help=f"not ported yet ({NOT_PORTED[name]})")

    a, extra = ap.parse_known_args(argv)
    if a.cmd in NOT_PORTED:
        _not_ported(a.cmd)
    if extra:
        ap.error(f"unrecognized arguments: {' '.join(extra)}")
    if a.cmd in ("slam", "optimize", "export-map"):
        from ndt_feature_graph_tpu_torch import resolve_device

        # The card unless --device cpu; raises where there is none.
        a.device = resolve_device(None if a.device == "cuda" else "cpu")
    a.fn(a)


if __name__ == "__main__":
    main()
