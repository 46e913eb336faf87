"""MCL tracking error of `cli localize`'s setting over generator seeds.

    python3 examples/measure_mcl_seeds.py [--device cuda|cpu] [--seeds 8]
                                          [--tree DIR]

The map of every second scan of the canonical fixture's first half at
ground-truth poses, then MCL with 512 particles over the second half
(the CLI's `localize` at chip_smoke.py phase 11b's flags: 100 m map,
30 m range, 720 beams, 1,024 cells), once for each generator seed.
Prints one JSON line: each seed's mean and final position error (m).
Shows how far the seed alone moves the error that phase 11b holds to
0.3 m.  `--tree DIR` takes the port from another checkout (say, the
parent commit unpacked under build/).
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if "--tree" in sys.argv:                # before the port is imported
    ROOT = os.path.abspath(sys.argv[sys.argv.index("--tree") + 1])
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ndt_feature_graph_tpu_torch.config import (  # noqa: E402
    MotionParams, NDTMapParams,
)
from ndt_feature_graph_tpu_torch.core import se2  # noqa: E402
from ndt_feature_graph_tpu_torch.io import dataset  # noqa: E402
from ndt_feature_graph_tpu_torch.localization import mcl  # noqa: E402
from ndt_feature_graph_tpu_torch.ops import d2d, ndt_map  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "ndt_feature_graph_tpu_torch", "data", "canonical_200.npz")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--tree", help="checkout to take the port from")
    args = ap.parse_args()
    dev = torch.device(args.device)
    fx = dict(np.load(FIXTURE))
    T = lambda x, dt=torch.float32: torch.as_tensor(  # noqa: E731
        x, dtype=dt, device=dev)
    ranges, hit = T(fx["ranges"]), T(fx["hit"], torch.bool)
    odom, gt = T(fx["odom"]), T(fx["gt"])
    mp = NDTMapParams(resolution=0.5, size_x=100.0, size_y=100.0,
                      sensor_range=30.0, max_points_per_scan=720,
                      max_cells=1024)
    split = int(gt.shape[0]) // 2
    grid = ndt_map.empty_grid(mp, torch.zeros(2, device=dev))
    for t in range(0, split, 2):
        pts, mask = dataset.scan_to_points(ranges[t], hit[t])
        world = se2.transform_points(gt[t], pts)
        grid = ndt_map.add_points(grid, mp, world, mask)
        grid = ndt_map.update_occupancy(grid, mp, gt[t][:2], world, mask)
    tgt = d2d.make_dense_target(grid, mp)
    out = {}
    for seed in range(args.seeds):
        loc = mcl.MCL(mp, MotionParams(), tgt, n_particles=512, seed=seed)
        loc.initialize(gt[split], spread_xy=0.5, spread_theta=0.2)
        errs = []
        for t in range(split + 1, int(gt.shape[0])):
            pts, mask = dataset.scan_to_points(ranges[t], hit[t])
            est = loc.step(odom[t], pts, mask)
            errs.append(float(torch.linalg.vector_norm(est[:2] - gt[t][:2])))
        out[seed] = [round(float(np.mean(errs)), 4), round(errs[-1], 4)]
    print(json.dumps({"tree": ROOT, "device": str(dev),
                      "mean_final_by_seed": out}))


if __name__ == "__main__":
    main()
