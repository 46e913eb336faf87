"""Stage split and host time of the feature kernels on one CUDA card.

    python3 examples/probe_feature_stages.py [--host | --stages] [--out DIR]

`--stages` rebuilds the kernels' library with -DNDTG_STAGE_PROBE (under
build/probe_kernels/), so that the NDTG_STAGE marks of
csrc/features.cu stamp each block's SM clock (clock64) at the end of each
stage, and the global timer at its first and last mark.  It then runs,
once each after a warm-up, the cases that chip_smoke.py phase 3f times:
`detect_features` on one canonical scan and on the 200 scans in one
call, `describe_features` on one scan's features and on the 200 scans'
in one call (the first 4,096 blocks stamp), `match_features` on one consecutive pair with the odometry gate
(the main path's call), on the 199 pairs and on the LC bank's 171 pairs
of 128 features; and prints each stage's cycles and µs (the mean over
the blocks that stamped it, and the largest), the marks' total, and the
probe build's device µs a call (CUDA events over 50 calls).  chip_smoke
runs this mode for the kernels line's `stages_us`.

`--host` times the wrappers with the host, at the main path's shapes
(one scan; one gated pair), in the normal build: the host µs a call of
`detect_features`, `describe_features` and `match_features` (enqueue
time of 300 calls, the card being faster than the host here; five runs),
then one synchronised call each, and the host µs of entering and leaving
`torch.cuda.device` on the current device (what `cuda_kernels._on`
skips).  To compare with another commit, run a copy of this script from
that commit's checkout, in turns with this one.  With neither flag both
run, `--host` first.

One JSON line per case; with --out DIR also DIR/probe_feature_stages.jsonl.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import re
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from ndt_feature_graph_tpu_torch.core import se2  # noqa: E402
from ndt_feature_graph_tpu_torch.features import (  # noqa: E402
    descriptor, detector, ransac)
from ndt_feature_graph_tpu_torch.ops import cuda_kernels  # noqa: E402

PROBE_BLOCKS, PROBE_STAGES = 4096, 16     # csrc/features.cu's probe arrays
MARK = re.compile(r'NDTG_STAGE\((\d+), "([a-z]+): ([^"]+)"\)')


def stage_names(source):
    """{kernel: {stage: name}} from the NDTG_STAGE marks of `source`."""
    out = {}
    for k, kernel, name in MARK.findall(pathlib.Path(source).read_text()):
        out.setdefault(kernel, {})[int(k)] = name
    return out


def inputs(dev):
    """The cases' inputs: the canonical scans, their twin features and
    descriptors, the gate of the main path's pair 5 -> 6, the LC bank."""
    fx = dict(np.load(chip_smoke.FIXTURE))
    sp = chip_smoke.canonical_slam_params(float(fx["split_m"]),
                                          int(fx["max_nodes"]))
    fp = sp.fuser.features
    T = lambda x, dt=torch.float32: torch.as_tensor(  # noqa: E731
        x, dtype=dt, device=dev)
    R, H, U = T(fx["ranges"]), T(fx["hit"], torch.bool), T(fx["ransac_u"])
    n = R.shape[0]
    ft = detector._detect_plain(fp, R, H)
    dt = descriptor._describe_plain(fp, ft, R, H)
    prev = T(fx["traj"][:-1])
    motion = se2.sub(prev, T(fx["traj"][1:]))
    k0 = 5
    gate = ransac.OdometryGate(
        sensor_pose=torch.zeros(3, device=dev), motion=motion[k0],
        prev_pose=prev[k0], max_translation=sp.fuser.max_translation_norm
        / 10, max_rotation=sp.fuser.max_rotation_norm / 4,
        check=sp.fuser.check_consistency, cov_xy=sp.fuser.feature_cov_xy)
    rows = chip_smoke.feature_rows
    f0, f1 = rows(ft, k0), rows(ft, k0 + 1)
    pairs = (rows(ft, slice(0, n - 1)), dt[:-1], rows(ft, slice(1, n)),
             dt[1:])
    lsp, _, bank, ref_i, mov_i, lu = chip_smoke.link_bank(
        dict(np.load(chip_smoke.LC_FIXTURE)), dev)
    lfp = lsp.fuser.features
    lin = (rows(bank.feats, ref_i), bank.desc[ref_i],
           rows(bank.feats, mov_i), bank.desc[mov_i])
    return {
        "detect one scan": (
            "detect", lambda: detector.detect(fp, R[k0 + 1], H[k0 + 1])),
        f"detect {n} scans": ("detect", lambda: detector.detect(fp, R, H)),
        "describe one scan": (
            "describe",
            lambda: descriptor.describe(fp, f1, R[k0 + 1], H[k0 + 1])),
        f"describe {n} scans": (
            "describe", lambda: descriptor.describe(fp, ft, R, H)),
        "match one pair with the gate": (
            "match", lambda: ransac.match_sets_gated(
                fp, f0, dt[k0], f1, dt[k0 + 1], U[k0], gate)),
        f"match {n - 1} pairs": (
            "match", lambda: ransac.match_sets(fp, *pairs, U)),
        f"match the LC bank's {ref_i.shape[0]} pairs": (
            "match", lambda: ransac.match_sets(lfp, *lin, lu)),
    }


def events_us(fn, reps=50):
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


def host_times(cases, emit):
    """The wrappers' host µs a call at the main path's shapes."""
    for name in ("detect one scan", "describe one scan",
                 "match one pair with the gate"):
        _, fn = cases[name]
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(300):
                fn()
            runs.append((time.perf_counter() - t0) / 300 * 1e6)
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        one = (time.perf_counter() - t0) * 1e6
        emit({"case": name, "host_us_a_call": runs,
              "synchronised_call_us": one})


def stage_times(cases, names, emit):
    lib = cuda_kernels.build()
    lib.ndtg_features_probe_read.argtypes = [cuda_kernels.ctypes.c_void_p] * 2
    lib.ndtg_features_probe_read.restype = cuda_kernels.ctypes.c_int
    clock = np.zeros(PROBE_BLOCKS * PROBE_STAGES, np.int64)
    ns = np.zeros(PROBE_BLOCKS * 2, np.int64)

    def read():
        err = lib.ndtg_features_probe_read(clock.ctypes.data, ns.ctypes.data)
        if err:
            raise RuntimeError(f"probe read failed: {err}")
        return (clock.reshape(PROBE_BLOCKS, PROBE_STAGES).copy(),
                ns.reshape(PROBE_BLOCKS, 2).copy())

    for name, (kernel, fn) in cases.items():
        if kernel not in names:
            continue
        us = events_us(fn)
        torch.cuda.synchronize()
        read()
        fn()
        torch.cuda.synchronize()
        clk, t_ns = read()
        live = clk[:, 0] != 0
        clk, t_ns = clk[live], t_ns[live]
        marks = sorted(names[kernel])
        # Each block's span to its own last mark (a cluster's other
        # blocks leave early).
        last = np.array([max(k for k in marks if row[k] != 0)
                         for row in clk])
        span_clk = clk[np.arange(len(clk)), last] - clk[:, marks[0]]
        span_ns = t_ns[:, 1] - t_ns[:, 0]
        ghz = float(span_clk.sum() / max(span_ns.sum(), 1))
        stages = []
        for a, b in zip(marks[:-1], marks[1:]):
            ok = (clk[:, a] != 0) & (clk[:, b] != 0)
            d = (clk[ok, b] - clk[ok, a]).astype(np.float64)
            stages.append({
                "stage": names[kernel][b], "blocks": int(ok.sum()),
                "mean_cycles": float(d.mean()) if ok.any() else 0.0,
                "max_cycles": float(d.max()) if ok.any() else 0.0,
                "mean_us": float(d.mean()) / ghz / 1e3 if ok.any() else 0.0})
        emit({"case": name, "probe_build_events_us": us,
              "blocks": int(live.sum()), "cycles_per_ns": ghz,
              "marks_mean_us": float(span_ns.mean()) / 1e3,
              "marks_max_us": float(span_ns.max()) / 1e3,
              "stages": stages})


def context_us(dev, reps=20000):
    """Host µs of entering and leaving torch.cuda.device(dev) on the
    current device, and of a nullcontext, in turns (five runs each)."""
    out = {"cuda_device": [], "nullcontext": []}
    for _ in range(5):
        for name, ctx in (("cuda_device", lambda: torch.cuda.device(dev)),
                          ("nullcontext", contextlib.nullcontext)):
            t0 = time.perf_counter()
            for _ in range(reps):
                with ctx():
                    pass
            out[name].append((time.perf_counter() - t0) / reps * 1e6)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", action="store_true")
    ap.add_argument("--stages", action="store_true")
    ap.add_argument("--out", help="directory for the JSON lines")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_feature_stages: no CUDA device")
    dev = torch.device("cuda", 0)
    out = None
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        out = open(os.path.join(args.out, "probe_feature_stages.jsonl"), "a")
    head = {"tree": ROOT, "gpu": chip_smoke.gpu_line()}

    def emit(rec):
        line = json.dumps({**head, **rec})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    cases = inputs(dev)
    if args.host or not args.stages:
        host_times(cases, emit)
        emit({"case": "torch.cuda.device context",
              "host_us": context_us(dev)})
    if args.stages or not args.host:
        cuda_kernels.NVCC_FLAGS = [*cuda_kernels.NVCC_FLAGS,
                                   "-DNDTG_STAGE_PROBE"]
        cuda_kernels.BUILD_DIR = pathlib.Path(ROOT) / "build" / \
            "probe_kernels"
        cuda_kernels._lib = None
        stage_times(cases, stage_names(next(
            p for p in cuda_kernels.SOURCES if p.name == "features.cu")),
            emit)


if __name__ == "__main__":
    main()
