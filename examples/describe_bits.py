"""The descriptor kernel's output bits on the card, for a comparison
between two checkouts.

    python3 examples/describe_bits.py --out A.npz [--against B.npz]

Runs `descriptor.describe` (the `describe_features` kernel) on one CUDA
card over the canonical 200 scans and their plain twin's features: the
200 scans in one call, scan by scan, with the hitmiss statistic, and a
B = 64 fleet step's descriptors (its streams' first step), and writes
them to A.npz.  Run from another checkout (a copy of this script placed
in that checkout's examples/), it writes that checkout's kernel's bits;
`--against B.npz` then counts the entries of each array whose bits
differ and exits 1 if any does.
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
from ndt_feature_graph_tpu_torch.features import (  # noqa: E402
    descriptor, detector)
from ndt_feature_graph_tpu_torch.models import presets  # noqa: E402
from ndt_feature_graph_tpu_torch.parallel import scaling  # noqa: E402


def outputs(dev):
    fx = dict(np.load(chip_smoke.FIXTURE))
    fp = chip_smoke.canonical_slam_params(float(fx["split_m"]),
                                          int(fx["max_nodes"])).fuser.features
    R = torch.as_tensor(fx["ranges"], dtype=torch.float32, device=dev)
    H = torch.as_tensor(fx["hit"], dtype=torch.bool, device=dev)
    ft = detector._detect_plain(fp, R, H)
    hm = dataclasses.replace(fp, descriptor_stat="hitmiss")
    fleet = presets.fleet_serving()
    ffp = fleet.features
    _, _, fr, fh = scaling.build_fleet_feature_inputs(
        fleet, chip_smoke.sequence(dict(np.load(chip_smoke.FLEET_FIXTURE)),
                                   dev), 64)
    fr, fh = fr[:, 0].contiguous(), fh[:, 0].contiguous()
    ff = detector._detect_plain(ffp, fr, fh)
    out = {
        "batch": descriptor.describe(fp, ft, R, H),
        "per_scan": torch.stack([descriptor.describe(
            fp, chip_smoke.feature_rows(ft, i), R[i], H[i])
            for i in range(R.shape[0])]),
        "hitmiss": descriptor.describe(hm, ft, R, H),
        "fleet_b64": descriptor.describe(ffp, ff, fr, fh),
    }
    return {k: v.cpu().numpy() for k, v in out.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--against")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("describe_bits: no CUDA device")
    got = outputs(torch.device("cuda", 0))
    np.savez(args.out, **got)
    if args.against:
        other = dict(np.load(args.against))
        off = {k: int((got[k].view(np.uint32)
                       != other[k].view(np.uint32)).sum()) for k in got}
        print(json.dumps({"gpu": chip_smoke.gpu_line(), "tree": ROOT,
                          "against": args.against,
                          "entries_off_bits": off,
                          "entries": {k: int(v.size)
                                      for k, v in got.items()}}))
        if any(off.values()):
            sys.exit(1)


if __name__ == "__main__":
    main()
