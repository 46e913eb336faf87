"""Hand-written Hopper kernels of the registration hot path — the
counterpart of ndt_feature_graph_tpu/ops/pallas_kernels.py.

`csrc/pair_fgh.cu` holds three kernels that share one device function
for the per-pair D2D algebra (pallas_kernels._fgh_components); every
entry is ONE launch whose thread-block clusters reduce on the chip, in a
fixed order.  The two solve entries run a whole registration:

  * `newton_solve` — a registration: the damped-Newton minimisation of
    d2d.newton_match over the objective of `newton_objective`, a cluster
    that loops over its trials and runs the LM step between them on the
    chip; (d, score, trials, converged), no host read.  The main path's
    (fuser.update: every term), plain D2D (d2d.match_d2d) and P2D
    (pairwise.match_p2d, with the guarded PSD projection) registrations.
    Plain twin: `newton_solve_reference`.
  * `newton_solve_batch` — B registrations, a cluster per lane that
    leaves at the lane's own stop: a fleet step's (fuser.update_batch)
    and a batch of links' D2D refinement (links.refine_links_d2d, the
    window term alone, with the Hessian at each lane's result for its
    covariance: the link solve, a lane's cluster sized by its shape
    alone, `link_cluster`, on persistent clusters that take lanes from
    a device counter).  Plain twin: `newton_solve_batch_reference`
    (d2d.newton_match_batch's masked lockstep).

The others write one evaluation's (f, g, H) as 13 floats:

  * `newton_objective` — one Newton trial's objective, the body of
    `newton_solve`: the D2D window term (trial pose, moved source
    cells, their (2n+1)^2 window rows of the packed (H*W, 8) table,
    masks), the paired feature term (its pair inputs formed in the
    kernel) and the odometry term, summed in that order.  Plain twin:
    `newton_objective_reference`.
  * `fgh_dense_flat` — the window term alone: d2d.covariance_d2d's one
    evaluation.  Plain twin: d2d_analytic.fgh_dense_flat.
  * `fgh_dense_flat_batch` — the window term for B lanes against one
    flat (N*H*W, 8) node bank, each lane with its own row offset and its
    own cluster, sized as the link solve sizes it: one lockstep trial of
    link refinement, launched by no path since refinement runs in
    `newton_solve_batch`.  Plain twin: d2d_analytic.fgh_dense_flat_batch.
  * `newton_objective_batch` — one Newton trial of B streams, the body
    of `newton_solve_batch`: every term per lane (its own source list,
    row offset into the flat (B*H*W, 8) stack of the streams' tables,
    feature lists and odometry information), one launch for all B.
    Plain twin: `newton_objective_batch_reference`.
  * `pair_fgh_reduce` — the Pallas kernel's signature: masked sum of the
    pair derivatives of given pairs (`fgh_paired` on its own).  Plain
    twin: `pair_fgh_reduce_reference`.

`row_sum` (the eager overlap score's sum, overlap_score_reference) sums
each row of a matrix in one fixed order, one block a row; its plain twin
is torch.sum.  No path launches it since `overlap_score`.

`csrc/overlap.cu` holds `overlap_score`, the link paths' occupancy-
overlap score (links._overlap_score_flat, occupancy_overlap_score): a
thread-block cluster a pair (from `overlap_group`'s batch size, a
cluster a group of pairs of one moving node, which reads that map
once) moves each cell of the moving map, gathers the reference map's
log-odds and sums the squared sigmoid differences where both maps know
the cell, in one launch and one pass over the node bank, the order a
function of H*W alone on both paths.  Plain twin: the eager score,
`overlap_score_reference`.

`csrc/segment_sum.cu` holds `segment_add_rows`, the map statistics'
fixed-order sum (ndt_map.scatter_add_rows: every add_points_touched on
the card): each touched row summed in entry order onto its old value,
the CPU's index_add bits, in two launches and no sort: a bucket pass
groups each tile of entries by row block, stably, with integer counts,
and a row pass adds each row's run in entry order (its scratch is one
buffer a device and stream; each call writes what it reads).  Plain twin:
`segment_add_rows_reference` (index_add).

`csrc/occupancy.cu` holds `update_occupancy`, the map's occupancy
update (ndt_map.update_occupancy on the card): integer hit and miss
counts a cell, then each cell's adds in entry order from registers and
the clamp, the CPU's bits; one launch, a thread-block cluster a stream
whose counters live in the cluster's shared memory, wherever they fit
(`occupancy_cluster`), else a count pass and a row pass.  Plain twin:
ndt_map._update_occupancy_plain (the eager ray build through
scatter_add_rows).

`csrc/features.cu` holds the scan's feature front end in three kernels,
one launch each for a scan or a batch of scans / pairs:
`detect_features` (features/detector.py detect: a thread-block cluster
of up to 8 blocks a scan, `detect_cluster`, exchanging its smoothed
points and best responses through distributed shared memory),
`describe_features` (features/descriptor.py describe: one block of
up to 1,024 threads a feature, `describe_threads`; every thread bins,
then 128 partial sums replay the adds in a fixed order and a fixed tree
adds them) and `match_features`
(features/ransac.py match_sets: a cluster of up to 4 blocks a pair,
`match_cluster`, splitting the chi2 rows; with an `OdometryGate`,
match_sets_gated, the feature fuser's gate and paired pseudo-cells in
the same launch).  Their bits do not depend on the cluster or block
size.  Plain
twins: detector._detect_plain, descriptor._describe_plain,
ransac._match_sets_plain and ransac._gate_plain.

The sources are compiled with nvcc for sm_90a (one process a source,
started together) into one shared library with a plain C interface at
the first CUDA call (never at import: machines without nvcc import this
module fine), cached under build/kernels/ by a hash of the sources and
flags, and loaded with ctypes.

Dispatch rule: CPU tensors go to the plain PyTorch twin; CUDA tensors
launch the kernel or raise.  There is no fallback from the card.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import math
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Optional

import numpy as np
import torch

from ndt_feature_graph_tpu_torch.config import MatcherParams, NDTMapParams
from ndt_feature_graph_tpu_torch.config import FeatureParams
from ndt_feature_graph_tpu_torch.core import se2
from ndt_feature_graph_tpu_torch.features import descriptor, detector, ransac
from ndt_feature_graph_tpu_torch.io import dataset
from ndt_feature_graph_tpu_torch.ops import d2d, d2d_analytic, ndt_map
from ndt_feature_graph_tpu_torch.ops.ndt_map import CellList

_PKG = pathlib.Path(__file__).resolve().parents[1]
SOURCES = (_PKG / "csrc" / "pair_fgh.cu", _PKG / "csrc" / "segment_sum.cu",
           _PKG / "csrc" / "occupancy.cu", _PKG / "csrc" / "overlap.cu",
           _PKG / "csrc" / "features.cu")
HEADERS = (_PKG / "csrc" / "cluster_launch.cuh",
           _PKG / "csrc" / "stage_probe.cuh")
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

# Launch counts per entry: incremented only where a kernel launches.
LAUNCHES = {"newton_objective": 0, "fgh_dense_flat": 0,
            "pair_fgh_reduce": 0, "fgh_dense_flat_batch": 0,
            "newton_objective_batch": 0, "newton_solve": 0,
            "newton_solve_batch": 0, "row_sum": 0, "segment_add_rows": 0,
            "occupancy_update": 0, "overlap_score": 0,
            "detect_features": 0, "describe_features": 0,
            "match_features": 0}


_lib = None
build_log = ""        # nvcc/ptxas output of the build in this process


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc():
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME/bin/nvcc or PATH): the CUDA "
            "kernels are built from csrc/ at first use"
        )
    return path


def build():
    """Compile the sources of csrc/ (SOURCES) into one library (if this
    hash of the sources and flags is not built yet: editing any rebuilds
    it) and load it.  Each source is compiled by its own
    nvcc process, all started together, then linked.  Returns the
    ctypes library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    src = b"".join(p.read_bytes() for p in (*SOURCES, *HEADERS))
    key = hashlib.sha256(
        src + " ".join(NVCC_FLAGS + LINK_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / key[:16] / "libndtg_kernels.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=out.parent) as tmp_dir:
            objs = [os.path.join(tmp_dir, p.stem + ".o") for p in SOURCES]
            procs = [subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-c", "-o", o, str(p)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for p, o in zip(SOURCES, objs)]
            logs = [proc.communicate()[0] for proc in procs]
            build_log = "".join(logs)
            if any(proc.returncode != 0 for proc in procs):
                raise RuntimeError(f"nvcc failed:\n{build_log}")
            tmp = os.path.join(tmp_dir, out.name)
            proc = subprocess.run([_nvcc(), *LINK_FLAGS, "-o", tmp, *objs],
                                  capture_output=True, text=True)
            build_log += proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to link:\n{build_log}")
            os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    for fn in (lib.ndtg_max_cluster, lib.ndtg_pair_threads,
               lib.ndtg_objective_threads, lib.ndtg_objective_blocks_per_sm):
        fn.argtypes = []
        fn.restype = I
    lib.ndtg_objective.argtypes = [
        P, P, P, P, P, P, P, P, I, I, I, I, F, I, I,  # window term
        P, P, P, P, P, P, I,                          # paired term
        P, F, F, P, I, P,         # Q, lfd1, lfd2, out, cluster, stream
    ]
    lib.ndtg_objective.restype = I
    lib.ndtg_newton_solve.argtypes = [
        P, P, P, P, P, P, P, P, I, I, I, I, F, I, I,  # window term
        P, P, P, P, P, P, I,                          # paired term
        P, F, F,                                      # Q, lfd1, lfd2
        I, F, I, I,  # max_trials, delta_score, step_control, psd_guard
        P, P, P, P, P,     # d, score, trials, converged, H
        I, P,              # cluster, stream
    ]
    lib.ndtg_newton_solve.restype = I
    for fn in (lib.ndtg_solve_smem, lib.ndtg_solve_max_clusters,
               lib.ndtg_link_max_clusters):
        fn.argtypes = [I, I, I]
        fn.restype = I
    lib.ndtg_link_max_cluster.argtypes = []
    lib.ndtg_link_max_cluster.restype = I
    lib.ndtg_link_solve.argtypes = [
        *lib.ndtg_newton_solve.argtypes[:-2],
        P, I, I, P,        # queue, clusters, cluster, stream
    ]
    lib.ndtg_link_solve.restype = I
    lib.ndtg_pair_fgh_reduce.argtypes = [
        P, P, P, P, P, LL, F, F, P, I, P,
    ]
    lib.ndtg_pair_fgh_reduce.restype = I
    lib.ndtg_row_sum.argtypes = [P, LL, LL, P, P]
    lib.ndtg_row_sum.restype = I
    lib.ndtg_segment_max_channels.argtypes = []
    lib.ndtg_segment_max_channels.restype = I
    lib.ndtg_segment_scratch_words.argtypes = [LL, LL]
    lib.ndtg_segment_scratch_words.restype = LL
    lib.ndtg_segment_add_rows.argtypes = [P, LL, LL, I, P, P, P, P, P, P]
    lib.ndtg_segment_add_rows.restype = I
    lib.ndtg_occupancy_update.argtypes = [
        P, P, P, LL, P, LL, P, P, LL,  # occ, out, origin, sensor, points
        I, I, I, F, I,                 # P, h, w, resolution, samples
        F, F, F, F,                    # hit, miss, lo, hi
        P, I, P, I, P,                 # counts, wide, chain, cluster, stream
    ]
    lib.ndtg_occupancy_update.restype = I
    lib.ndtg_occupancy_max_clusters.argtypes = [LL, I, I]
    lib.ndtg_occupancy_max_clusters.restype = I
    lib.ndtg_overlap_cluster.argtypes = [LL]
    lib.ndtg_overlap_cluster.restype = I
    lib.ndtg_overlap_threads.argtypes = []
    lib.ndtg_overlap_threads.restype = I
    lib.ndtg_overlap_score.argtypes = [
        P, P, P, LL, P, P, P, LL,  # ref bank, origins, index, nodes; mov's
        P, LL, I, I, F, F,         # T, pairs, h, w, res, 1 / res
        P, P, P, P,                # score, nb, cells, stream
    ]
    lib.ndtg_overlap_score.restype = I
    lib.ndtg_overlap_group_score.argtypes = [
        P, P, P, LL, P, P, P, LL,  # ref bank, origins, index, nodes; mov's
        P, LL, I, I, F, F,         # T, pairs, h, w, res, 1 / res
        I, LL, P, P, P,            # group, clusters, score, nb, stream
    ]
    lib.ndtg_overlap_group_score.restype = I
    for fn in (lib.ndtg_features_max_scales, lib.ndtg_features_max_bins):
        fn.argtypes = []
        fn.restype = I
    lib.ndtg_features_max_smem.argtypes = []
    lib.ndtg_features_max_smem.restype = LL
    lib.ndtg_detect_smem.argtypes = [I, I]
    lib.ndtg_detect_smem.restype = LL
    lib.ndtg_describe_smem.argtypes = [I, I]
    lib.ndtg_describe_smem.restype = LL
    lib.ndtg_match_smem.argtypes = [I, I, I, I, I, I]
    lib.ndtg_match_smem.restype = LL
    lib.ndtg_detect_features.argtypes = [
        P, P, P, P, LL, I, I, I, I, P,  # ranges, hit, cos, sin; n, b, s, ...
        F, F, P, P, P, P, P, P, P,      # peaks; pts, ..., mask, arcs,
        I, P,                           # smoothed; cluster, stream
    ]
    lib.ndtg_detect_features.restype = I
    lib.ndtg_describe_features.argtypes = [
        P, P, P, P, P, P, P, P,         # scan, trig, the features
        LL, I, I, I, I, I,              # n, b, f, bins, hitmiss
        F, F, F, F, F, P,               # rho, 1 / sigma, 1 / bins, out
        I, P,                           # threads, stream
    ]
    lib.ndtg_describe_features.restype = I
    lib.ndtg_match_features.argtypes = [
        P, P, P, P, P, P, P,             # the two sets, the draws
        LL, LL, LL, LL, LL, LL, LL, LL,  # their strides a pair; pairs
        I, I, I, I, I, I, I,             # f1, f2, d, c, m, budget, adaptive
        F, F, F, F, F, F,                # acceptance ... eps
        P, P, P, LL, LL, LL, I, I, F, F, F,  # the gate
        P, P, P, P, P, P, P, P,          # the result
        P, P, P, P, I, P,                # the pseudo-cells; cluster, stream
    ]
    lib.ndtg_match_features.restype = I
    lib.ndtg_features_math_probe.argtypes = [P, P, P, LL, I, P]
    lib.ndtg_features_math_probe.restype = I
    _lib = lib
    return lib


_SYM_INDEX = {}       # device -> index of the 3x3 Hessian in the 10 sums


def _sym_index(device):
    """Index of the 3x3 Hessian in the 10 sums, made once per device: a
    fresh host-to-device copy per call would synchronise the stream."""
    sym = _SYM_INDEX.get(device)
    if sym is None:
        sym = torch.tensor([4, 5, 6, 5, 7, 8, 6, 8, 9], device=device)
        _SYM_INDEX[device] = sym
    return sym


def _unpack10(out):
    """(10,) [s, g0..g2, h00 h01 h02 h11 h12 h22] -> (f, g (3,), H (3,3));
    the plain versions' sums."""
    return out[0], out[1:4], out[_sym_index(out.device)].reshape(3, 3)


def _unpack13(out):
    """The kernels' (..., 13) output [f, g0..g2, H row-major] as views
    (f (...), g (..., 3), H (..., 3, 3)): no further launch."""
    return out[..., 0], out[..., 1:4], out[..., 4:13].unflatten(-1, (3, 3))


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_cells(name, cells: CellList, lead, device):
    """A CellList with leading shape `lead` (ending in its cell count);
    the kernel reads a mean as one float2 and a covariance as one
    float4."""
    f32 = torch.float32
    _check(f"{name}.means", cells.means, f32, (*lead, 2), device)
    _check(f"{name}.covs", cells.covs, f32, (*lead, 2, 2), device)
    _check(f"{name}.mask", cells.mask, torch.bool, lead, device)
    if cells.means.data_ptr() % 8 or cells.covs.data_ptr() % 16:
        raise ValueError(f"{name}: means must be 8-byte and covs 16-byte "
                         "aligned")


def _check_table(name, packed, rows, device):
    _check(name, packed, torch.float32, (rows, 8), device)
    if packed.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be 16-byte aligned")


def _cluster_blocks(lib, n_items: int, per_block: int) -> int:
    """Blocks of a cluster that `n_items` fill at `per_block` a block,
    within the portable cluster size."""
    return max(1, min(lib.ndtg_max_cluster(), -(-n_items // per_block)))


_RESIDENT_BLOCKS = {}     # device -> objective-kernel blocks it holds
_SMS = {}                 # device -> its multiprocessors


def _sm_count(device) -> int:
    sms = _SMS.get(device)
    if sms is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _SMS[device] = sms
    return sms


def _objective_cluster(lib, device, n_lanes: int, n_src: int,
                       n_feat: int) -> int:
    """Blocks per lane of the objective kernel: as many as give each of
    the lane's source cells a warp and each feature pair a thread, but
    no more than keep every lane's cluster on the card at once (measured
    on the H100: a second wave of clusters, and larger clusters, cost
    more than longer warps)."""
    resident = _RESIDENT_BLOCKS.get(device)
    if resident is None:
        resident = _sm_count(device) * lib.ndtg_objective_blocks_per_sm()
        _RESIDENT_BLOCKS[device] = resident
    threads = lib.ndtg_objective_threads()
    wanted = max(_cluster_blocks(lib, n_src, threads // 32),
                 _cluster_blocks(lib, n_feat, threads))
    return max(1, min(wanted, resident // n_lanes))


def link_cluster(n_src: int, n_feat: int, max_cluster: int,
                 threads: int = 256) -> int:
    """Blocks of a link lane's cluster (the link solve and its per-trial
    yardstick fgh_dense_flat_batch): as many as give each source cell a
    warp and each feature pair a thread, up to `max_cluster` — a
    function of the lane's shape and the card's cluster limit alone, not
    of how many lanes share the launch, so a link refined alone sums in
    the order of its row in any batch."""
    wanted = max(-(-n_src // (threads // 32)), -(-n_feat // threads), 1)
    return min(max_cluster, wanted)


_LINK_CLUSTER = {}    # (device, n_src, n_feat) -> (blocks a lane, resident)


def _link_cluster(lib, device, n_src: int, n_feat: int):
    """(blocks a lane, clusters the card holds at once) of the link
    solve: link_cluster's size, smaller only where that cluster cannot
    launch with the solve's shared memory.  Cached per shape."""
    key = (device, n_src, n_feat)
    out = _LINK_CLUSTER.get(key)
    if out is None:
        cluster = link_cluster(n_src, n_feat, lib.ndtg_link_max_cluster(),
                               lib.ndtg_objective_threads())
        with _on(device):
            resident = lib.ndtg_link_max_clusters(n_src, n_feat, cluster)
            while cluster > 1 and resident == 0:
                cluster -= 1
                resident = lib.ndtg_link_max_clusters(n_src, n_feat,
                                                      cluster)
        if resident == 0:
            raise RuntimeError("link solve: no cluster of the kernel fits "
                               f"{n_src} source cells, {n_feat} pairs")
        out = (cluster, resident)
        _LINK_CLUSTER[key] = out
    return out


_LINK_QUEUES = {}     # (device, stream) -> the link solve's lane counter


def _link_queue(device, stream: int):
    """The lane counter of link solves on (device, stream): two int32,
    zeroed once; each launch hands out its lanes from it and leaves it
    zero, and launches on one stream run one after another."""
    q = _LINK_QUEUES.get((device, stream))
    if q is None:
        q = torch.zeros(2, dtype=torch.int32, device=device)
        _LINK_QUEUES[(device, stream)] = q
    return q


def _raise_on(err: int, entry: str):
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA launch failed, cudaError {err}")


def _launch_objective(entry, d, T0, src, packed, origins, row_offsets,
                      h, w, res, n, lfd1, lfd2, feat_src=None,
                      feat_tgt=None, Q=None, bf16_rows=False, link=False):
    """One launch of the objective kernel on checked CUDA tensors; None
    switches a term off.  d (B, 3) or (3,): returns the (B, 13) or (13,)
    output.  `link`: a lane's cluster as the link solve sizes it
    (_link_cluster), else by _objective_cluster.  Counts the launch
    under `entry`."""
    dev = d.device
    lib = build()
    n_lanes = d.shape[0] if d.dim() == 2 else 1
    n_src = src.mask.shape[-1] if src is not None else 0
    n_feat = feat_src.mask.shape[-1] if feat_src is not None else 0
    out = torch.empty((*d.shape[:-1], 13), dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    cells = lambda c: (  # noqa: E731
        (None, None, None) if c is None
        else (c.means.data_ptr(), c.covs.data_ptr(), c.mask.data_ptr()))
    cluster = (_link_cluster(lib, dev, n_src, n_feat)[0] if link
               else _objective_cluster(lib, dev, n_lanes, n_src, n_feat))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ndtg_objective(
            d.data_ptr(), T0.data_ptr(), *cells(src), ptr(packed),
            ptr(origins), ptr(row_offsets), n_lanes, n_src, h, w,
            float(res), n, int(bf16_rows), *cells(feat_src),
            *cells(feat_tgt), n_feat,
            ptr(Q), float(lfd1), float(lfd2), out.data_ptr(),
            cluster, stream,
        )
    _raise_on(err, entry)
    LAUNCHES[entry] += 1
    return out


def newton_objective_reference(d, T0, src: Optional[CellList], packed,
                               origin, h: int, w: int, res: float,
                               m: MatcherParams,
                               feat_src: Optional[CellList] = None,
                               feat_tgt: Optional[CellList] = None,
                               Q=None, bf16_rows: bool = False):
    """Plain PyTorch `newton_objective`: the sum, in this order, of the
    D2D window term (d2d_analytic.fgh_dense_flat), the paired feature
    term (d2d_analytic.paired_inputs through pair_fgh_reduce_reference)
    and the odometry term (d2d_analytic.fgh_mahalanobis); None switches
    a term off, and with none left the objective is zero."""
    terms = []
    if src is not None:
        terms.append(d2d_analytic.fgh_dense_flat(
            d, T0, src, packed, origin, 0, h, w, res, m, bf16_rows))
    if feat_src is not None:
        terms.append(pair_fgh_reduce_reference(
            *d2d_analytic.paired_inputs(d, T0, feat_src, feat_tgt),
            m.lfd1, m.lfd2))
    if Q is not None:
        terms.append(d2d_analytic.fgh_mahalanobis(d, Q))
    return _sum_terms(terms, d)


def _sum_terms(terms, d):
    """The (f, g, H) terms added in their order; zeros of d's lanes if
    there is none."""
    if not terms:
        lead = d.shape[:-1]
        return (torch.zeros(lead, device=d.device),
                torch.zeros((*lead, 3), device=d.device),
                torch.zeros((*lead, 3, 3), device=d.device))
    f, g, H = terms[0]
    for f_i, g_i, H_i in terms[1:]:
        f, g, H = f + f_i, g + g_i, H + H_i
    return f, g, H


def newton_objective(d, T0, src: Optional[CellList], packed, origin,
                     h: int, w: int, res: float, m: MatcherParams,
                     feat_src: Optional[CellList] = None,
                     feat_tgt: Optional[CellList] = None, Q=None,
                     bf16_rows: bool = False):
    """(f, g (3,), H (3,3)) of one Newton trial's objective at increment
    d over initial pose T0: the D2D window cost of `src` against the
    packed (H*W, 8) table, plus the paired cost of the feature lists
    `feat_src` / `feat_tgt` (src[i] against tgt[i]), plus the odometry
    term d^T Q d — one kernel launch on CUDA tensors.  `src`, the
    feature lists (both or neither) and `Q` may each be None: that term
    is off.  `bf16_rows` reads the table rows as the reference's
    bfloat16 gather table holds them (d2d.bf16_rows)."""
    if (feat_src is None) != (feat_tgt is None):
        raise ValueError("newton_objective: feat_src and feat_tgt go "
                         "together")
    if d.device.type == "cpu":
        return newton_objective_reference(d, T0, src, packed, origin, h, w,
                                          res, m, feat_src, feat_tgt, Q,
                                          bf16_rows)
    if d.device.type != "cuda":
        raise ValueError(f"newton_objective: unsupported device {d.device}")
    dev = d.device
    f32 = torch.float32
    _check("d", d, f32, (3,), dev)
    _check("T0", T0, f32, (3,), dev)
    if src is not None:
        _check_cells("src", src, (src.mask.shape[0],), dev)
        _check_table("packed", packed, h * w, dev)
        _check("origin", origin, f32, (2,), dev)
    if feat_src is not None:
        n_feat = feat_src.mask.shape[0]
        _check_cells("feat_src", feat_src, (n_feat,), dev)
        _check_cells("feat_tgt", feat_tgt, (n_feat,), dev)
    if Q is not None:
        _check("Q", Q, f32, (3, 3), dev)
    out = _launch_objective(
        "newton_objective", d, T0, src,
        packed if src is not None else None,
        origin if src is not None else None, None, h, w, res,
        m.n_neighbours, m.lfd1, m.lfd2, feat_src, feat_tgt, Q, bf16_rows)
    return _unpack13(out)


def fgh_dense_flat(d, T0, src: CellList, packed, origin, h: int, w: int,
                   res: float, n: int, lfd1: float, lfd2: float):
    """(f, g (3,), H (3,3)) of the D2D window cost of `src` moved by
    d ∘ T0 against the packed (H*W, 8) table — d2d_analytic.fgh_dense_flat
    (row offset 0) in one kernel launch on CUDA tensors."""
    if d.device.type == "cpu":
        m = MatcherParams(n_neighbours=n, lfd1=lfd1, lfd2=lfd2)
        return d2d_analytic.fgh_dense_flat(
            d, T0, src, packed, origin, 0, h, w, res, m
        )
    if d.device.type != "cuda":
        raise ValueError(f"fgh_dense_flat: unsupported device {d.device}")
    dev = d.device
    f32 = torch.float32
    _check("d", d, f32, (3,), dev)
    _check("T0", T0, f32, (3,), dev)
    _check_cells("src", src, (src.mask.shape[0],), dev)
    _check_table("packed", packed, h * w, dev)
    _check("origin", origin, f32, (2,), dev)
    return _unpack13(_launch_objective(
        "fgh_dense_flat", d, T0, src, packed, origin, None, h, w, res, n,
        lfd1, lfd2))


MAX_LANES = 65535     # gridDim.y of the batched launch


def _check_lanes(entry, b):
    if not 0 < b <= MAX_LANES:
        raise ValueError(f"{entry}: {b} lanes, expected 1..{MAX_LANES}")


def newton_objective_batch_reference(
        d_b, T0_b, src_b: Optional[CellList], packed_flat, origins,
        row_offsets, h: int, w: int, res: float, m: MatcherParams,
        feat_src_b: Optional[CellList] = None,
        feat_tgt_b: Optional[CellList] = None, Q_b=None,
        bf16_rows: bool = False):
    """Plain PyTorch `newton_objective_batch`: per lane the sum, in this
    order, of the window term (d2d_analytic.fgh_dense_flat_batch), the
    paired feature term of the lane's own lists (d2d_analytic.fgh_paired
    over the lanes) and the lane's odometry term (f += d.Q.d, g +=
    (Q+Q^T) d, H += Q+Q^T); None switches a term off."""
    terms = []
    if src_b is not None:
        terms.append(d2d_analytic.fgh_dense_flat_batch(
            d_b, T0_b, src_b, packed_flat, origins, row_offsets, h, w, res,
            m, bf16_rows))
    if feat_src_b is not None:
        terms.append(d2d_analytic.fgh_paired(d_b, T0_b, feat_src_b,
                                             feat_tgt_b, m))
    if Q_b is not None:
        terms.append(d2d_analytic.fgh_mahalanobis(d_b, Q_b))
    return _sum_terms(terms, d_b)


def newton_objective_batch(
        d_b, T0_b, src_b: Optional[CellList], packed_flat, origins,
        row_offsets, h: int, w: int, res: float, m: MatcherParams,
        feat_src_b: Optional[CellList] = None,
        feat_tgt_b: Optional[CellList] = None, Q_b=None,
        bf16_rows: bool = False):
    """(f (B,), g (B, 3), H (B, 3, 3)) of one Newton trial of B streams:
    lane b's objective at increment d_b[b] over pose T0_b[b] is the D2D
    window cost of src_b[b] against the rows of the flat (R, 8) stack of
    packed tables from row_offsets[b] (int64) on, with grid origin
    origins[b], plus the paired cost of its own feature lists
    feat_src_b[b] / feat_tgt_b[b] ((B, C) cells), plus its odometry term
    with Q_b[b] ((B, 3, 3)) — one kernel launch for all B lanes on CUDA
    tensors, a cluster per lane.  `src_b`, the feature lists (both or
    neither) and `Q_b` may each be None: that term is off.  `bf16_rows`
    reads the table rows as the reference's bfloat16 gather table holds
    them (d2d.bf16_rows)."""
    if (feat_src_b is None) != (feat_tgt_b is None):
        raise ValueError("newton_objective_batch: feat_src_b and "
                         "feat_tgt_b go together")
    args = (d_b, T0_b, src_b, packed_flat, origins, row_offsets, h, w, res,
            m, feat_src_b, feat_tgt_b, Q_b, bf16_rows)
    if d_b.device.type == "cpu":
        return newton_objective_batch_reference(*args)
    if d_b.device.type != "cuda":
        raise ValueError(
            f"newton_objective_batch: unsupported device {d_b.device}")
    dev = d_b.device
    f32 = torch.float32
    if d_b.dim() != 2:
        raise ValueError(f"d_b: shape {tuple(d_b.shape)}, expected (B, 3)")
    b = d_b.shape[0]
    _check_lanes("newton_objective_batch", b)
    _check("d_b", d_b, f32, (b, 3), dev)
    _check("T0_b", T0_b, f32, (b, 3), dev)
    if src_b is not None:
        _check_cells("src_b", src_b, (b, src_b.mask.shape[-1]), dev)
        _check_table("packed_flat", packed_flat, packed_flat.shape[0], dev)
        _check("origins", origins, f32, (b, 2), dev)
        _check("row_offsets", row_offsets, torch.int64, (b,), dev)
    if feat_src_b is not None:
        lead = (b, feat_src_b.mask.shape[-1])
        _check_cells("feat_src_b", feat_src_b, lead, dev)
        _check_cells("feat_tgt_b", feat_tgt_b, lead, dev)
    if Q_b is not None:
        _check("Q_b", Q_b, f32, (b, 3, 3), dev)
    on = src_b is not None
    return _unpack13(_launch_objective(
        "newton_objective_batch", d_b, T0_b, src_b,
        packed_flat if on else None, origins if on else None,
        row_offsets if on else None, h, w, res, m.n_neighbours, m.lfd1,
        m.lfd2, feat_src_b, feat_tgt_b, Q_b, bf16_rows))


_SOLVE_CLUSTER = {}   # (device, n_lanes, n_src, n_feat) -> blocks a lane


def _solve_cluster(lib, device, n_lanes: int, n_src: int,
                   n_feat: int) -> int:
    """Blocks per lane of the solve kernel: the objective kernel's rule,
    so that a trial sums in the order `newton_objective[_batch]` sums
    it; smaller only where that cluster cannot launch with the solve's
    shared memory (ndtg_solve_max_clusters returns 0).  Where the card
    holds fewer such clusters than lanes at once (the query counts their
    placement in the GPCs), later lanes start as earlier ones retire:
    no cluster waits on another, so this costs time and cannot
    deadlock, and a smaller cluster would change the summation order.
    Cached per shape."""
    key = (device, n_lanes, n_src, n_feat)
    cluster = _SOLVE_CLUSTER.get(key)
    if cluster is None:
        cluster = _objective_cluster(lib, device, n_lanes, n_src, n_feat)
        with torch.cuda.device(device):
            while cluster > 1 and lib.ndtg_solve_max_clusters(
                    n_src, n_feat, cluster) == 0:
                cluster -= 1
        _SOLVE_CLUSTER[key] = cluster
    return cluster


def _launch_solve(entry, d_init, T0, src, packed, origins, row_offsets,
                  h, w, res, m: MatcherParams, feat_src=None,
                  feat_tgt=None, Q=None, bf16_rows=False, psd_guard=False,
                  with_hessian=False):
    """One launch of the solve kernel on checked CUDA tensors; None
    switches a term off.  d_init (B, 3) or (3,): returns (d, score,
    trials int32, converged bool), and with `with_hessian` the Hessian
    at d (..., 3, 3), with its leading shape: the link solve
    (ndtg_link_solve: a lane's cluster by its shape, persistent clusters
    taking lanes from a counter), else newton_solve_kernel.  Counts the
    launch under `entry`."""
    dev = d_init.device
    lib = build()
    lead = d_init.shape[:-1]
    n_lanes = d_init.shape[0] if d_init.dim() == 2 else 1
    n_src = src.mask.shape[-1] if src is not None else 0
    n_feat = feat_src.mask.shape[-1] if feat_src is not None else 0
    d = torch.empty((*lead, 3), dtype=torch.float32, device=dev)
    score = torch.empty(lead, dtype=torch.float32, device=dev)
    trials = torch.empty(lead, dtype=torch.int32, device=dev)
    conv = torch.empty(lead, dtype=torch.uint8, device=dev)
    hess = (torch.empty((*lead, 3, 3), dtype=torch.float32, device=dev)
            if with_hessian else None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    cells = lambda c: (  # noqa: E731
        (None, None, None) if c is None
        else (c.means.data_ptr(), c.covs.data_ptr(), c.mask.data_ptr()))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        common = (
            d_init.data_ptr(), T0.data_ptr(), *cells(src), ptr(packed),
            ptr(origins), ptr(row_offsets), n_lanes, n_src, h, w,
            float(res), m.n_neighbours, int(bf16_rows), *cells(feat_src),
            *cells(feat_tgt), n_feat, ptr(Q), float(m.lfd1), float(m.lfd2),
            d2d.trial_budget(m), float(m.delta_score), int(m.step_control),
            int(psd_guard), d.data_ptr(), score.data_ptr(), trials.data_ptr(),
            conv.data_ptr(), ptr(hess))
        if with_hessian:
            cluster, resident = _link_cluster(lib, dev, n_src, n_feat)
            err = lib.ndtg_link_solve(
                *common, _link_queue(dev, stream).data_ptr(),
                min(n_lanes, resident), cluster, stream)
        else:
            err = lib.ndtg_newton_solve(
                *common, _solve_cluster(lib, dev, n_lanes, n_src, n_feat),
                stream)
    _raise_on(err, entry)
    LAUNCHES[entry] += 1
    out = (d, score, trials, conv.view(torch.bool))
    return out + (hess,) if with_hessian else out


def newton_solve_reference(d_init, T0, src: Optional[CellList], packed,
                           origin, h: int, w: int, res: float,
                           m: MatcherParams,
                           feat_src: Optional[CellList] = None,
                           feat_tgt: Optional[CellList] = None, Q=None,
                           bf16_rows: bool = False, psd_guard: bool = False):
    """Plain PyTorch `newton_solve`: d2d.newton_match over
    `newton_objective_reference` (the eager LM step, one objective a
    trial, one host read of the stop flag a chunk of 6 trials)."""
    return d2d.newton_match(
        lambda d: newton_objective_reference(d, T0, src, packed, origin, h,
                                             w, res, m, feat_src, feat_tgt,
                                             Q, bf16_rows), d_init, m,
        psd_guard)


def newton_solve(d_init, T0, src: Optional[CellList], packed, origin,
                 h: int, w: int, res: float, m: MatcherParams,
                 feat_src: Optional[CellList] = None,
                 feat_tgt: Optional[CellList] = None, Q=None,
                 bf16_rows: bool = False, psd_guard: bool = False):
    """A whole registration: the damped-Newton (LM) minimisation from
    increment d_init (3,) over T0 of `newton_objective`'s objective (the
    same arguments and term switches), as d2d.newton_match computes it —
    one kernel launch on CUDA tensors, in which one thread-block cluster
    evaluates trial after trial and runs the LM step between them until
    the lane stops; no host read.  `psd_guard` projects the Hessians
    with d2d._psd_project's guard (P2D's).  Returns (d (3,), score,
    trials (int32), converged (bool)) as device tensors."""
    if (feat_src is None) != (feat_tgt is None):
        raise ValueError("newton_solve: feat_src and feat_tgt go together")
    args = (d_init, T0, src, packed, origin, h, w, res, m, feat_src,
            feat_tgt, Q, bf16_rows, psd_guard)
    if d_init.device.type == "cpu":
        return newton_solve_reference(*args)
    if d_init.device.type != "cuda":
        raise ValueError(f"newton_solve: unsupported device {d_init.device}")
    dev = d_init.device
    f32 = torch.float32
    _check("d_init", d_init, f32, (3,), dev)
    _check("T0", T0, f32, (3,), dev)
    if src is not None:
        _check_cells("src", src, (src.mask.shape[0],), dev)
        _check_table("packed", packed, h * w, dev)
        _check("origin", origin, f32, (2,), dev)
    if feat_src is not None:
        n_feat = feat_src.mask.shape[0]
        _check_cells("feat_src", feat_src, (n_feat,), dev)
        _check_cells("feat_tgt", feat_tgt, (n_feat,), dev)
    if Q is not None:
        _check("Q", Q, f32, (3, 3), dev)
    on = src is not None
    return _launch_solve(
        "newton_solve", d_init, T0, src, packed if on else None,
        origin if on else None, None, h, w, res, m, feat_src, feat_tgt, Q,
        bf16_rows, psd_guard)


def newton_solve_batch_reference(
        d_init_b, T0_b, src_b: Optional[CellList], packed_flat, origins,
        row_offsets, h: int, w: int, res: float, m: MatcherParams,
        feat_src_b: Optional[CellList] = None,
        feat_tgt_b: Optional[CellList] = None, Q_b=None,
        bf16_rows: bool = False, with_hessian: bool = False):
    """Plain PyTorch `newton_solve_batch`: d2d.newton_match_batch (the
    masked lockstep) over `newton_objective_batch_reference`, then with
    `with_hessian` one more evaluation at the result for its Hessians."""
    def fgh(d_b):
        return newton_objective_batch_reference(
            d_b, T0_b, src_b, packed_flat, origins, row_offsets, h, w, res,
            m, feat_src_b, feat_tgt_b, Q_b, bf16_rows)

    out = d2d.newton_match_batch(d_init_b, m, fgh)
    return out + (fgh(out[0])[2],) if with_hessian else out


def newton_solve_batch(
        d_init_b, T0_b, src_b: Optional[CellList], packed_flat, origins,
        row_offsets, h: int, w: int, res: float, m: MatcherParams,
        feat_src_b: Optional[CellList] = None,
        feat_tgt_b: Optional[CellList] = None, Q_b=None,
        bf16_rows: bool = False, with_hessian: bool = False):
    """B registrations (a fleet step's, a batch of links'): lane b
    minimises, from d_init_b[b], `newton_objective_batch`'s objective of
    lane b (the same arguments and term switches), as
    d2d.newton_match_batch computes it — one kernel launch for all B
    lanes on CUDA tensors, a cluster per lane that leaves at the lane's
    own stop (in the lockstep a stopped lane's updates are masked, so
    its result is the same).  Returns (d (B, 3), score (B,), trials (B,)
    int32, converged (B,) bool), and with `with_hessian` (link
    refinement's covariances) the Hessians (B, 3, 3) of the objective at
    d, written by the launch itself."""
    if (feat_src_b is None) != (feat_tgt_b is None):
        raise ValueError("newton_solve_batch: feat_src_b and feat_tgt_b "
                         "go together")
    args = (d_init_b, T0_b, src_b, packed_flat, origins, row_offsets, h, w,
            res, m, feat_src_b, feat_tgt_b, Q_b, bf16_rows, with_hessian)
    if d_init_b.device.type == "cpu":
        return newton_solve_batch_reference(*args)
    if d_init_b.device.type != "cuda":
        raise ValueError(
            f"newton_solve_batch: unsupported device {d_init_b.device}")
    dev = d_init_b.device
    f32 = torch.float32
    if d_init_b.dim() != 2:
        raise ValueError(f"d_init_b: shape {tuple(d_init_b.shape)}, "
                         "expected (B, 3)")
    b = d_init_b.shape[0]
    _check_lanes("newton_solve_batch", b)
    _check("d_init_b", d_init_b, f32, (b, 3), dev)
    _check("T0_b", T0_b, f32, (b, 3), dev)
    if src_b is not None:
        _check_cells("src_b", src_b, (b, src_b.mask.shape[-1]), dev)
        _check_table("packed_flat", packed_flat, packed_flat.shape[0], dev)
        _check("origins", origins, f32, (b, 2), dev)
        _check("row_offsets", row_offsets, torch.int64, (b,), dev)
    if feat_src_b is not None:
        lead = (b, feat_src_b.mask.shape[-1])
        _check_cells("feat_src_b", feat_src_b, lead, dev)
        _check_cells("feat_tgt_b", feat_tgt_b, lead, dev)
    if Q_b is not None:
        _check("Q_b", Q_b, f32, (b, 3, 3), dev)
    on = src_b is not None
    return _launch_solve(
        "newton_solve_batch", d_init_b, T0_b, src_b,
        packed_flat if on else None, origins if on else None,
        row_offsets if on else None, h, w, res, m, feat_src_b, feat_tgt_b,
        Q_b, bf16_rows, with_hessian=with_hessian)


def fgh_dense_flat_batch(d_b, T0_b, src_b: CellList, packed_flat, origins,
                         row_offsets, h: int, w: int, res: float, n: int,
                         lfd1: float, lfd2: float):
    """(f (B,), g (B, 3), H (B, 3, 3)) of B lanes of the D2D window term
    against one flat (R, 8) packed bank — d2d_analytic.
    fgh_dense_flat_batch in one launch, a cluster per lane, on CUDA
    tensors.  Lane b moves src_b[b] by d_b[b] ∘ T0_b[b] and reads the
    bank rows from row_offsets[b] (int64) on, with origin origins[b].
    One lockstep trial of link refinement, which runs whole in
    `newton_solve_batch`: this entry is its per-trial yardstick."""
    if d_b.device.type == "cpu":
        m = MatcherParams(n_neighbours=n, lfd1=lfd1, lfd2=lfd2)
        return d2d_analytic.fgh_dense_flat_batch(
            d_b, T0_b, src_b, packed_flat, origins, row_offsets, h, w, res, m
        )
    if d_b.device.type != "cuda":
        raise ValueError(
            f"fgh_dense_flat_batch: unsupported device {d_b.device}")
    dev = d_b.device
    b, n_src = src_b.mask.shape
    f32 = torch.float32
    _check("d_b", d_b, f32, (b, 3), dev)
    _check("T0_b", T0_b, f32, (b, 3), dev)
    _check_cells("src_b", src_b, (b, n_src), dev)
    _check_table("packed_flat", packed_flat, packed_flat.shape[0], dev)
    _check("origins", origins, f32, (b, 2), dev)
    _check("row_offsets", row_offsets, torch.int64, (b,), dev)
    _check_lanes("fgh_dense_flat_batch", b)
    return _unpack13(_launch_objective(
        "fgh_dense_flat_batch", d_b, T0_b, src_b, packed_flat, origins,
        row_offsets, h, w, res, n, lfd1, lfd2, link=True))


def _fgh_components(mu_x, mu_y, s00, s01, s11, mx, my, c00, c01, c11,
                    ok, lfd1, lfd2):
    """Elementwise per-pair (s, g0..g2, h00, h01, h02, h11, h12, h22),
    masked by `ok` — pallas_kernels._fgh_components, and the algebra of
    the CUDA device function."""
    det = torch.clamp(s00 * s11 - s01 * s01, min=1e-12)
    inv = 1.0 / det
    a00 = s11 * inv
    a01 = -s01 * inv
    a11 = s00 * inv
    amu_x = a00 * mu_x + a01 * mu_y
    amu_y = a01 * mu_x + a11 * mu_y
    q = mu_x * amu_x + mu_y * amu_y
    mt_x = -my
    mt_y = mx
    S00 = -2.0 * c01
    S01 = c00 - c11
    S11 = 2.0 * c01
    S2d00 = -2.0 * c00 + 2.0 * c11
    S2d01 = -4.0 * c01
    S2d11 = 2.0 * c00 - 2.0 * c11
    sa_x = S00 * amu_x + S01 * amu_y
    sa_y = S01 * amu_x + S11 * amu_y
    asa_x = a00 * sa_x + a01 * sa_y
    asa_y = a01 * sa_x + a11 * sa_y
    q_x = 2.0 * amu_x
    q_y = 2.0 * amu_y
    q_t = 2.0 * (amu_x * mt_x + amu_y * mt_y) - (mu_x * asa_x + mu_y * asa_y)
    amt_x = a00 * mt_x + a01 * mt_y
    amt_y = a01 * mt_x + a11 * mt_y
    h_xx = 2.0 * a00
    h_xy = 2.0 * a01
    h_yy = 2.0 * a11
    h_xt = 2.0 * amt_x - 2.0 * asa_x
    h_yt = 2.0 * amt_y - 2.0 * asa_y
    t1 = 2.0 * (mt_x * amt_x + mt_y * amt_y)
    t2 = 2.0 * (amu_x * (-mx) + amu_y * (-my))
    t3 = -4.0 * (asa_x * mt_x + asa_y * mt_y)
    sasa_x = S00 * asa_x + S01 * asa_y
    sasa_y = S01 * asa_x + S11 * asa_y
    asasa_x = a00 * sasa_x + a01 * sasa_y
    asasa_y = a01 * sasa_x + a11 * sasa_y
    s2a_x = S2d00 * amu_x + S2d01 * amu_y
    s2a_y = S2d01 * amu_x + S2d11 * amu_y
    as2a_x = a00 * s2a_x + a01 * s2a_y
    as2a_y = a01 * s2a_x + a11 * s2a_y
    t4 = mu_x * (2.0 * asasa_x - as2a_x) + mu_y * (2.0 * asasa_y - as2a_y)
    h_tt = t1 + t2 + t3 + t4
    alpha = 0.5 * lfd2
    E = torch.where(ok, torch.exp(-alpha * q), 0.0)
    k = lfd1 * alpha * E
    return (
        -lfd1 * E, k * q_x, k * q_y, k * q_t,
        k * (h_xx - alpha * q_x * q_x), k * (h_xy - alpha * q_x * q_y),
        k * (h_xt - alpha * q_x * q_t), k * (h_yy - alpha * q_y * q_y),
        k * (h_yt - alpha * q_y * q_t), k * (h_tt - alpha * q_t * q_t),
    )


def _broadcast_pairs(mu, Sig, m_rot, Crot, ok):
    shape = ok.shape
    return (
        mu.expand(shape + (2,)), Sig.expand(shape + (2, 2)),
        m_rot.expand(shape + (2,)), Crot.expand(shape + (2, 2)), ok,
    )


def pair_fgh_reduce_reference(mu, Sig, m_rot, Crot, ok, lfd1, lfd2):
    """Plain PyTorch `pair_fgh_reduce`: masked sum of the per-pair
    derivatives.  mu (..., 2); Sig (..., 2, 2); m_rot (..., 2) and Crot
    (..., 2, 2) broadcastable; ok (...) bool.  Returns (f, g (3,),
    H (3, 3))."""
    mu, Sig, m_rot, Crot, ok = _broadcast_pairs(mu, Sig, m_rot, Crot, ok)
    comps = _fgh_components(
        mu[..., 0], mu[..., 1], Sig[..., 0, 0], Sig[..., 0, 1],
        Sig[..., 1, 1], m_rot[..., 0], m_rot[..., 1], Crot[..., 0, 0],
        Crot[..., 0, 1], Crot[..., 1, 1], ok, lfd1, lfd2,
    )
    return _unpack10(torch.stack([c.sum() for c in comps]))


def pair_fgh_reduce(mu, Sig, m_rot, Crot, ok, lfd1, lfd2):
    """Fused masked reduction of the pair derivatives (the TPU kernel's
    signature), one launch on CUDA tensors.  Shapes as
    pair_fgh_reduce_reference."""
    if ok.device.type == "cpu":
        return pair_fgh_reduce_reference(mu, Sig, m_rot, Crot, ok, lfd1,
                                         lfd2)
    if ok.device.type != "cuda":
        raise ValueError(f"pair_fgh_reduce: unsupported device {ok.device}")
    dev = ok.device
    f32 = torch.float32
    for name, t in (("mu", mu), ("Sig", Sig), ("m_rot", m_rot),
                    ("Crot", Crot)):
        if t.dtype != f32 or t.device != dev:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                             f"float32 on {dev}")
    if ok.dtype != torch.bool:
        raise ValueError(f"ok: dtype {ok.dtype}, expected torch.bool")
    mu, Sig, m_rot, Crot, ok = (
        t.contiguous() for t in _broadcast_pairs(mu, Sig, m_rot, Crot, ok)
    )
    n_pairs = ok.numel()
    lib = build()
    out = torch.empty(13, dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ndtg_pair_fgh_reduce(
            mu.data_ptr(), Sig.data_ptr(), m_rot.data_ptr(),
            Crot.data_ptr(), ok.data_ptr(), n_pairs, float(lfd1),
            float(lfd2), out.data_ptr(),
            _cluster_blocks(lib, n_pairs, lib.ndtg_pair_threads()), stream,
        )
    _raise_on(err, "pair_fgh_reduce")
    LAUNCHES["pair_fgh_reduce"] += 1
    return _unpack13(out)


def fgh_paired(d, T0, src: CellList, tgt: CellList, m: MatcherParams):
    """d2d_analytic.fgh_paired on its own, with the reduction through
    `pair_fgh_reduce` (the kernel on CUDA tensors).  Inside a Newton
    trial the paired term rides in `newton_objective` instead."""
    mu, Sig, m_rot, Crot, ok = d2d_analytic.paired_inputs(d, T0, src, tgt)
    return pair_fgh_reduce(mu, Sig, m_rot, Crot, ok, m.lfd1, m.lfd2)


def row_sum(x):
    """The sum over the last dim of a float32 tensor (..., C) in one
    fixed order, whatever the leading shape: one launch of the row-sum
    kernel (a block a row) on CUDA tensors, torch.sum on the CPU."""
    if x.device.type == "cpu":
        return x.sum(-1)
    if x.device.type != "cuda":
        raise ValueError(f"row_sum: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"row_sum: dtype {x.dtype}, expected float32")
    if x.dim() < 1 or x.shape[-1] == 0:
        raise ValueError(f"row_sum: shape {tuple(x.shape)}, expected "
                         "(..., C) with C > 0")
    lead, n_cols = x.shape[:-1], x.shape[-1]
    rows = x.reshape(-1, n_cols).contiguous()
    out = torch.empty(rows.shape[0], dtype=torch.float32, device=x.device)
    if rows.shape[0] == 0:
        return out.reshape(lead)
    lib = build()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ndtg_row_sum(rows.data_ptr(), rows.shape[0], n_cols,
                               out.data_ptr(), stream)
    _raise_on(err, "row_sum")
    LAUNCHES["row_sum"] += 1
    return out.reshape(lead)


def _cell_centers(h: int, w: int, resolution: float, device):
    """(H*W, 2) cell centres relative to the grid origin, row-major."""
    ys = (torch.arange(h, device=device, dtype=torch.float32) + 0.5) * (
        resolution)
    xs = (torch.arange(w, device=device, dtype=torch.float32) + 0.5) * (
        resolution)
    return torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)],
                       -1).reshape(-1, 2)


def _overlap_eager(mov_occ_raw, mov_origin, ref_lookup, ref_origin, T,
                   h: int, w: int, resolution: float, sum_rows):
    """Mean squared difference of rescaled occupancy over the cells
    where both maps carry information, 1.0 without overlap, batched over
    leading dims.  mov_occ_raw (..., H*W); origins (..., 2); T (..., 3);
    ref_lookup(flat (..., H*W)) -> the ref log-odds at those cells;
    sum_rows: the sum over the cells (last dim)."""
    rel_c = _cell_centers(h, w, resolution, T.device)
    centers = mov_origin[..., None, :] + rel_c
    mov_occ = torch.sigmoid(mov_occ_raw)
    mov_has = mov_occ_raw.abs() > 1e-6

    tp = se2.transform_points(T, centers)
    rel = (tp - ref_origin[..., None, :]) / resolution
    ix = torch.floor(rel[..., 0]).to(torch.int64)
    iy = torch.floor(rel[..., 1]).to(torch.int64)
    inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    flat = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
    ref_occ_raw = ref_lookup(flat)
    ref_has = (ref_occ_raw.abs() > 1e-6) & inb
    ref_occ = torch.sigmoid(ref_occ_raw)

    both = mov_has & ref_has
    nb = both.sum(-1)
    diff2 = (mov_occ - ref_occ) ** 2
    s = sum_rows(torch.where(both, diff2, 0.0)) / torch.clamp(nb, min=1)
    return torch.where(nb > 0, s, 1.0), nb


def overlap_score_reference(occ_flat, occ_origins, ref_i, mov_i, T, h: int,
                            w: int, resolution: float, mov_flat=None,
                            mov_origins=None, sum_rows=None):
    """The plain version of overlap_score (its arguments): the eager
    score over (P, H*W) tensors, its sum over the cells `sum_rows`
    (default `row_sum`: torch.sum on the CPU, whose order for one row of
    more than 32,768 cells splits it across threads; the row-sum kernel
    on the card).  The CPU's path; on the card the kernel's yardstick
    (chip_smoke phase 16b), on no path."""
    if sum_rows is None:
        sum_rows = row_sum
    if mov_flat is None:
        mov_flat, mov_origins = occ_flat, occ_origins
    if ref_i is None:
        return _overlap_eager(mov_flat, mov_origins,
                              lambda flat: occ_flat[flat], occ_origins, T, h,
                              w, resolution, sum_rows)
    hw = h * w
    mov_occ_raw = mov_flat.reshape(-1, hw)[mov_i]
    ref_base = (ref_i.to(torch.int64) * hw)[:, None]
    return _overlap_eager(mov_occ_raw, mov_origins[mov_i],
                          lambda flat: occ_flat[ref_base + flat],
                          occ_origins[ref_i], T, h, w, resolution, sum_rows)


# csrc/overlap.cu's layout: threads a block, cells a vector, the largest
# cluster, blocks an SM (kMinBlocks), vectors a thread of the group path
# holds, moving nodes its count takes, pairs a group.
OVERLAP_THREADS, OVERLAP_VEC, OVERLAP_MAX_CLUSTER = 256, 4, 8
OVERLAP_BLOCKS_PER_SM = 6
OVERLAP_GROUP_MAX_VEC, OVERLAP_GROUP_MAX_NODES = 6, 4096
OVERLAP_GROUP_MAX = 8
# The size rule's thresholds, from tune_torch_port_kernels.py --overlap on
# the H100 (PERF.md section 6: at 128 pairs the pair path was the faster
# by 1-2%, at 171 groups of 4 by 9%, from 256 groups of 8): fewer pairs
# take the pair path, from OVERLAP_GROUP_MIN_PAIRS groups of 4, from
# OVERLAP_GROUP_WIDE_PAIRS groups of 8.
OVERLAP_GROUP_MIN_PAIRS, OVERLAP_GROUP_WIDE_PAIRS = 160, 256


def overlap_cluster(hw: int) -> int:
    """Blocks of a pair's cluster at `hw` cells (overlap.cu cluster_of):
    a block a 256 vectors of four cells, at most the portable 8."""
    n_vec = -(-hw // OVERLAP_VEC)
    return max(1, min(OVERLAP_MAX_CLUSTER, -(-n_vec // OVERLAP_THREADS)))


def overlap_group_fits(hw: int, n_mov: int) -> bool:
    """Whether the group path takes a grid of `hw` cells and a moving
    bank of `n_mov` maps (overlap.cu ndtg_overlap_group_fits): a
    thread's vectors fit its registers and the nodes the count."""
    n_vec = -(-hw // OVERLAP_VEC)
    threads = overlap_cluster(hw) * OVERLAP_THREADS
    return (-(-n_vec // threads) <= OVERLAP_GROUP_MAX_VEC
            and 1 <= n_mov <= OVERLAP_GROUP_MAX_NODES)


def overlap_group(n_pairs: int) -> int:
    """Pairs a group of the overlap kernel's group path, 0 for the pair
    path, by the batch's size: the pair path below
    OVERLAP_GROUP_MIN_PAIRS pairs (its eight blocks a pair fit one wave
    of the card up to ~100 pairs, and a group's search costs ~2 µs a
    block), groups of 4 below OVERLAP_GROUP_WIDE_PAIRS, else of 8.  Only the
    schedule depends on it: every pair's bits are the same on both paths
    and at every group size."""
    if n_pairs < OVERLAP_GROUP_MIN_PAIRS:
        return 0
    return 4 if n_pairs < OVERLAP_GROUP_WIDE_PAIRS else OVERLAP_GROUP_MAX


def overlap_groups(n_pairs: int, group: int, n_mov: int) -> int:
    """Clusters the group path launches: at least its groups, of which
    there are at most ceil(n_pairs / group) plus one a distinct moving
    key (a node, or the key of indices outside the bank)."""
    return min(n_pairs, -(-n_pairs // group) + min(n_mov + 1, n_pairs))


def overlap_score(occ_flat, occ_origins, ref_i, mov_i, T, h: int, w: int,
                  resolution: float, mov_flat=None, mov_origins=None,
                  cells: bool = False):
    """The link paths' occupancy-overlap score (links._overlap_score_flat,
    links.occupancy_overlap_score): for pair k, the mean squared
    difference of the sigmoid occupancies of node mov_i[k]'s map, moved
    by T[k], and node ref_i[k]'s, over the cells both know; 1.0 without
    overlap.  occ_flat (N*H*W,) float32 and occ_origins (N, 2): the bank;
    ref_i / mov_i (P,) int64; T (P, 3).  `mov_flat` / `mov_origins`: the
    moving maps from a bank of their own (else the same bank).  With
    ref_i = mov_i = None, one pair: occ_flat / mov_flat (H*W,) its two
    maps, the origins (2,), T (3,), and 0-d outputs.  Returns (score
    float32, n_overlap int64).

    On CUDA tensors: ONE launch of the overlap kernel (csrc/overlap.cu: a
    thread-block cluster a pair; the transform, the gather, the masks,
    the squared difference and a fixed-order sum in one pass, no
    intermediate; the order a function of H*W alone, so a pair alone
    gets the bits of its row in a batch); a pair whose index lies outside
    its bank gets score NaN and n_overlap -1.  `cells`: also return each
    moving cell's flat index into the reference map (P, H*W) int32, -1
    out of bounds, for a check against the eager path; CUDA only.

    Two paths, one order, so the same bits: the pair path (a cluster a
    pair) and, for the batches `overlap_group` sends there, the group
    path (a cluster a group of pairs of one moving node, reading its map
    once; the kernel finds the groups in mov_i itself).  `cells` and the
    one-pair form take the pair path.  On the CPU the plain version,
    overlap_score_reference (the eager score, its sum torch.sum)."""
    dev = T.device
    if dev.type == "cpu":
        if cells:
            raise ValueError("overlap_score: cells= needs CUDA tensors")
        return overlap_score_reference(
            occ_flat, occ_origins, ref_i, mov_i, T, h, w, resolution,
            mov_flat, mov_origins)
    if dev.type != "cuda":
        raise ValueError(f"overlap_score: unsupported device {dev}")
    one = ref_i is None and mov_i is None
    if (ref_i is None) != (mov_i is None):
        raise ValueError("overlap_score: ref_i and mov_i are both given "
                         "or both None")
    if mov_flat is None:
        mov_flat, mov_origins = occ_flat, occ_origins
    elif mov_origins is None:
        raise ValueError("overlap_score: mov_flat without mov_origins")
    hw = h * w
    if h < 1 or w < 1 or hw >= 2 ** 31:
        raise ValueError(f"overlap_score: a {h} x {w} grid, expected 1 to "
                         "2^31 - 1 cells")
    f32 = torch.float32
    banks = {}
    for name, flat, origins in (("occ", occ_flat, occ_origins),
                                ("mov", mov_flat, mov_origins)):
        n = 1 if one else flat.numel() // hw
        _check(f"overlap_score {name}_flat", flat, f32,
               (hw,) if one else (n * hw,), dev)
        _check(f"overlap_score {name}_origins", origins, f32,
               (2,) if one else (n, 2), dev)
        banks[name] = n
    n_pairs = 1 if one else ref_i.shape[0]
    _check("overlap_score T", T, f32, (3,) if one else (n_pairs, 3), dev)
    if not one:
        _check("overlap_score ref_i", ref_i, torch.int64, (n_pairs,), dev)
        _check("overlap_score mov_i", mov_i, torch.int64, (n_pairs,), dev)
    lead = () if one else (n_pairs,)
    score = torch.empty(lead, dtype=f32, device=dev)
    nb = torch.empty(lead, dtype=torch.int64, device=dev)
    idx = (torch.empty((n_pairs, hw), dtype=torch.int32, device=dev)
           if cells else None)
    if n_pairs == 0:
        return (score, nb, idx) if cells else (score, nb)
    lib = build()
    if n_pairs * lib.ndtg_overlap_cluster(hw) >= 2 ** 31:
        raise ValueError(f"overlap_score: {n_pairs} pairs of {hw} cells, "
                         "too many blocks for one launch")
    res32 = np.float32(resolution)
    # ATen divides by a Python float on the card as a product with its
    # float32 reciprocal.
    inv = float(np.float32(1.0) / res32)
    group = 0 if one or cells else overlap_group(n_pairs)
    if group and overlap_group_fits(hw, banks["mov"]):
        n_groups = overlap_groups(n_pairs, group, banks["mov"])
        with _on(dev):
            err = lib.ndtg_overlap_group_score(
                occ_flat.data_ptr(), occ_origins.data_ptr(), ref_i.data_ptr(),
                banks["occ"], mov_flat.data_ptr(), mov_origins.data_ptr(),
                mov_i.data_ptr(), banks["mov"], T.data_ptr(), n_pairs, h, w,
                float(res32), inv, group, n_groups, score.data_ptr(),
                nb.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(err, "overlap_score")
        LAUNCHES["overlap_score"] += 1
        return score, nb
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ndtg_overlap_score(
            occ_flat.data_ptr(), occ_origins.data_ptr(),
            None if one else ref_i.data_ptr(), banks["occ"],
            mov_flat.data_ptr(), mov_origins.data_ptr(),
            None if one else mov_i.data_ptr(), banks["mov"],
            T.data_ptr(), n_pairs, h, w, float(res32), inv, score.data_ptr(),
            nb.data_ptr(), None if idx is None else idx.data_ptr(), stream)
    _raise_on(err, "overlap_score")
    LAUNCHES["overlap_score"] += 1
    return (score, nb, idx) if cells else (score, nb)


def segment_add_rows_reference(bases, idx, vals):
    """The plain version of segment_add_rows: index_add per field, a
    serial loop over the entries on the CPU."""
    return [b.index_add(0, idx, v) for b, v in zip(bases, vals)]


def segment_add_rows(bases, idx, vals):
    """[base + the rows of val added at `idx`] for each (base (N, c),
    val (M, c)) float32 pair, one shared index idx (M,) int64 in
    [0, N): each row is its old value plus its entries added one after
    another in entry order, every add rounded once in float32 — the
    CPU's index_add.  New tensors; the bases are not changed.

    On CUDA tensors: TWO launches of the segment-sum kernel for all the
    pairs (up to 8 float channels in all), no sort and no float atomics:
    a bucket pass groups each tile of 1,024 entries by row block of 256
    rows, stably, and a row pass adds each row's entries in entry order
    onto its old row (csrc/segment_sum.cu); one launch when M = 0.  Its
    scratch is one buffer a (device, stream), grown as needed
    (`_stream_buffer`); nothing else is allocated but the outputs.  On
    the CPU, segment_add_rows_reference."""
    dev = idx.device
    if dev.type == "cpu":
        return segment_add_rows_reference(bases, idx, vals)
    if dev.type != "cuda":
        raise ValueError(f"segment_add_rows: unsupported device {dev}")
    n, m = len(bases), idx.shape[0]
    lib = build()
    n_rows = bases[0].shape[0] if bases else 0
    if n < 1 or n != len(vals):
        raise ValueError(f"segment_add_rows: {n} bases and {len(vals)} "
                         "values, expected as many of each, at least one")
    if m >= 2 ** 31 or n_rows >= 2 ** 31:
        raise ValueError(f"segment_add_rows: {m} entries on {n_rows} rows, "
                         "at most 2^31 - 1 of each")
    _check("segment_add_rows idx", idx, torch.int64, (m,), dev)
    for k, (b, v) in enumerate(zip(bases, vals)):
        if b.dim() != 2 or b.shape[1] < 1:
            raise ValueError(f"segment_add_rows: bases[{k}] of shape "
                             f"{tuple(b.shape)}, expected (N, c), c >= 1")
        _check(f"segment_add_rows bases[{k}]", b, torch.float32,
               (n_rows, b.shape[1]), dev)
        _check(f"segment_add_rows vals[{k}]", v, torch.float32,
               (m, b.shape[1]), dev)
    n_ch = sum(b.shape[1] for b in bases)
    if n_ch > lib.ndtg_segment_max_channels():
        raise ValueError(f"segment_add_rows: {n_ch} channels in all, at "
                         f"most {lib.ndtg_segment_max_channels()}")
    outs = [torch.empty(b.shape, dtype=torch.float32, device=dev)
            for b in bases]
    if n_rows == 0:
        return outs
    ptrs = lambda ts: (ctypes.c_void_p * n)(  # noqa: E731
        *[t.data_ptr() for t in ts])
    widths = (ctypes.c_int * n)(*[b.shape[1] for b in bases])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        # In any state: each call writes what it reads.
        scratch = _stream_buffer(
            _SEGMENT_SCRATCH, dev, stream,
            max(lib.ndtg_segment_scratch_words(m, n_rows), 2), torch.int32,
            zeroed=False)
        err = lib.ndtg_segment_add_rows(
            idx.data_ptr(), m, n_rows, n, ptrs(bases), ptrs(vals),
            ptrs(outs), widths, scratch.data_ptr(), stream)
    if err != 0:
        _SEGMENT_SCRATCH.pop((dev, stream), None)
    _raise_on(err, "segment_add_rows")
    LAUNCHES["segment_add_rows"] += 1
    return outs


_SEGMENT_SCRATCH = {}   # (device, stream) -> the segment sum's scratch
_OCC_COUNTS = {}        # (device, stream) -> the two-pass path's counters


def _stream_buffer(cache, dev, stream, n: int, dtype, zeroed: bool):
    """`cache`'s buffer for `stream`: `n` elements of `dtype` or more,
    grown as needed; a new one is zero where `zeroed` (its kernel leaves
    it so), else in any state.  The caller drops it from `cache` after
    a failed launch."""
    key = (dev, stream)
    buf = cache.get(key)
    if buf is None or buf.numel() < n:
        buf = (torch.zeros if zeroed else torch.empty)(n, dtype=dtype,
                                                       device=dev)
        cache[key] = buf
    return buf


def _rows_of(name, t, lead, dev):
    """`t` broadcast to (*lead, 2) float32 as an (n, 2) view with unit
    inner stride: (tensor, stride between rows)."""
    if t.device != dev or t.dtype != torch.float32:
        raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                         f"float32 on {dev}")
    try:
        rows = t.expand(*lead, 2).reshape(-1, 2)
    except RuntimeError as e:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{(*lead, 2)}") from e
    if rows.stride(1) != 1:
        rows = rows.contiguous()
    return rows, rows.stride(0)


OCCUPANCY_MAX_CLUSTER = 16      # csrc/occupancy.cu kMaxCluster
OCCUPANCY_MAX_SMEM = 232448     # csrc/occupancy.cu kMaxSmem


def occupancy_block_rows(rows: int, k: int) -> int:
    """The rows each block of a k-block cluster owns (csrc/occupancy.cu
    cluster_block_rows): ceil(rows / k) rounded up to a multiple of 4."""
    return (-(-rows // k) + 3) // 4 * 4


def occupancy_cluster(rows: int, wide: bool, n_streams: int,
                      resident) -> int:
    """Blocks of the occupancy kernel's cluster a stream of `rows` cells
    (h * w), or 0 for the two-pass path.  The fewest blocks whose shared
    memory holds the stream's counters and old values (4 + 4 bytes a
    row, 8 + 4 with 64-bit counters; at most OCCUPANCY_MAX_CLUSTER blocks
    of 227 KB; 0 where none does), raised to the most blocks (a power of
    two) whose clusters, one a stream, the card holds at once:
    resident(k) is the number of k-block clusters it holds
    (cudaOccupancyMaxActiveClusters; on an H100 at 1,024 threads 66, 30,
    15 and 7 for 2, 4, 8 and 16 blocks: 16 blocks for one stream, 8 for
    8 streams, 2 for 64)."""
    word = 8 if wide else 4
    fewest = 1
    while fewest <= OCCUPANCY_MAX_CLUSTER and (
            occupancy_block_rows(rows, fewest) * (word + 4)
            > OCCUPANCY_MAX_SMEM):
        fewest *= 2
    if fewest > OCCUPANCY_MAX_CLUSTER:
        return 0
    k = OCCUPANCY_MAX_CLUSTER
    while k > fewest and resident(k) < n_streams:
        k //= 2
    return k


_OCC_RESIDENT = {}      # (device, rows, k, wide) -> k-block clusters held


def _occupancy_resident(lib, dev, rows: int, wide: bool):
    """resident(k) of `occupancy_cluster` on `dev`, asked of the card once
    a shape (a failed query raises)."""
    def resident(k):
        key = (dev, rows, k, wide)
        n = _OCC_RESIDENT.get(key)
        if n is None:
            with _on(dev):
                n = lib.ndtg_occupancy_max_clusters(rows, k, int(wide))
            _raise_on(-n if n < 0 else 0, "update_occupancy (clusters held)")
            _OCC_RESIDENT[key] = n
        return n
    return resident


def update_occupancy(grid, params: NDTMapParams, sensor_origin, pts, mask,
                     chain=None):
    """ndt_map.update_occupancy: the grid (or stack of grids) with its
    `occ` updated along the beams of pts (..., P, 2) / mask (..., P)
    seen from sensor_origin (..., 2), then clamped.  A new tensor; the
    grid's is not changed.

    On CUDA tensors, the occupancy kernel (csrc/occupancy.cu: integer
    hit / miss counts a cell, then each row's adds in entry order and
    the clamp), the CPU's bits.  Where a stream's counters and old
    values fit a thread-block cluster's shared memory
    (`occupancy_cluster`: grids of up to 464,896 cells at 16 blocks, or
    309,888 with 64-bit counters), ONE launch, a cluster a stream, with
    no counter buffer in device memory; a larger grid takes the
    two-pass path (a count launch into a counter buffer kept a device
    and stream, then a row launch).  The choice is one of shapes, not a
    fallback.  With `chain`, an int32 tensor of one element a row, it
    also writes the number of adds each row's chain made.  On the CPU,
    ndt_map._update_occupancy_plain."""
    dev = pts.device
    if dev.type == "cpu":
        return ndt_map._update_occupancy_plain(grid, params, sensor_origin,
                                               pts, mask)
    if dev.type != "cuda":
        raise ValueError(f"update_occupancy: unsupported device {dev}")
    if pts.dim() < 2 or pts.shape[-1] != 2:
        raise ValueError(f"update_occupancy: points of shape "
                         f"{tuple(pts.shape)}, expected (..., P, 2)")
    lead, n_pts = tuple(pts.shape[:-2]), pts.shape[-2]
    h, w, samples = params.grid_h, params.grid_w, params.ray_samples
    n = math.prod(lead)
    n_rows = n * h * w
    if n_rows >= 2 ** 31 or n_pts * samples >= 2 ** 32 or samples < 1:
        raise ValueError(f"update_occupancy: {n_rows} cells, {n_pts} x "
                         f"{samples} samples: at most 2^31 - 1 cells, 2^32 "
                         "- 1 samples a stream, one sample a beam")
    pts = pts.contiguous()
    _check("update_occupancy pts", pts, torch.float32, (*lead, n_pts, 2),
           dev)
    mask = mask.contiguous()
    _check("update_occupancy mask", mask, torch.bool, (*lead, n_pts), dev)
    occ = grid.occ.contiguous()
    _check("update_occupancy occ", occ, torch.float32, (*lead, h, w), dev)
    origin, o_stride = _rows_of("update_occupancy origin", grid.origin,
                                lead, dev)
    sensor, s_stride = _rows_of("update_occupancy sensor_origin",
                                sensor_origin, lead, dev)
    if chain is not None:
        _check("update_occupancy chain", chain, torch.int32, (n_rows,), dev)
    out = torch.empty_like(occ)
    if n_rows == 0:
        return dataclasses.replace(grid, occ=out)
    lib = build()
    wide = n_pts >= 2 ** 16 or n_pts * samples >= 2 ** 16
    cluster = occupancy_cluster(h * w, wide, n,
                                _occupancy_resident(lib, dev, h * w, wide))
    with _on(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        counts = None
        if not cluster:
            # Zero: the row pass zeroes the counters it reads.
            counts = _stream_buffer(_OCC_COUNTS, dev, stream, n_rows,
                                    torch.int64, zeroed=True).data_ptr()
        err = lib.ndtg_occupancy_update(
            occ.data_ptr(), out.data_ptr(), origin.data_ptr(),
            o_stride, sensor.data_ptr(), s_stride, pts.data_ptr(),
            mask.data_ptr(), n, n_pts, h, w, params.resolution, samples,
            params.occ_hit, params.occ_miss, -params.occ_clamp,
            params.occ_clamp, counts, int(wide),
            None if chain is None else chain.data_ptr(), cluster, stream)
    if err != 0 and not cluster:
        # A pass that did not run leaves its counters as they are.
        _OCC_COUNTS.pop((dev, stream), None)
    _raise_on(err, "update_occupancy")
    LAUNCHES["occupancy_update"] += 1
    return dataclasses.replace(grid, occ=out)


_BEAM_TRIG = {}         # (beams, device) -> torch.cos / sin of the beam angles


def _beam_trig(num_beams: int, dev):
    """torch.cos and torch.sin of dataset.beam_angles on `dev`: the plain
    twins' own beam directions, made once a device (no copy a scan)."""
    key = (num_beams, dev)
    out = _BEAM_TRIG.get(key)
    if out is None:
        ang = dataset.beam_angles(num_beams, device=dev)
        out = (torch.cos(ang), torch.sin(ang))
        _BEAM_TRIG[key] = out
    return out


def _scan_inputs(entry, params: FeatureParams, ranges, hit):
    """(ranges, hit, leading shape, scans) of a CUDA call, contiguous."""
    dev = ranges.device
    b = params.num_beams
    if ranges.dim() < 1 or ranges.shape[-1] != b:
        raise ValueError(f"{entry}: ranges of shape {tuple(ranges.shape)}, "
                         f"expected (..., {b}) (FeatureParams.num_beams)")
    lead = tuple(ranges.shape[:-1])
    ranges = ranges.contiguous()
    _check(f"{entry} ranges", ranges, torch.float32, (*lead, b), dev)
    hit = hit.contiguous()
    _check(f"{entry} hit", hit, torch.bool, (*lead, b), dev)
    return ranges, hit, lead, math.prod(lead)


def _on(dev):
    """torch.cuda.device(dev), or nothing where `dev` is already the
    current device (the context costs host time every call)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


DETECT_MAX_CLUSTER = 8   # csrc/features.cu kMaxDetectCluster
MATCH_MAX_CLUSTER = 4    # csrc/features.cu kMaxMatchCluster


def _one_wave(n: int, most: int, sms: int) -> int:
    """The largest power of two up to `most` that keeps n x blocks within
    the card's `sms` SMs (one block an SM), else 1."""
    k = most
    while k > 1 and n * k > sms:
        k //= 2
    return k


def detect_cluster(n_scans: int, sms: int) -> int:
    """Blocks of the detector's cluster a scan on a card of `sms` SMs: up
    to 8 while the call fills the SMs once (on an H100: 8 at one scan, 4
    at 32, 2 at 64, 1 from 67; examples/tune_torch_port_kernels.py
    --features, PERF.md §6).  A scan's bits do not depend on it."""
    return _one_wave(n_scans, DETECT_MAX_CLUSTER, sms)


def match_cluster(n_pairs: int, sms: int) -> int:
    """Blocks of the matcher's cluster a pair on a card of `sms` SMs: up
    to 4 while the call fills the SMs once (4 at one pair, 1 at 199 and
    at the LC bank's 171 pairs; the same sweep).  The bits do not depend
    on it."""
    return _one_wave(n_pairs, MATCH_MAX_CLUSTER, sms)


DESCRIBE_MAX_THREADS = 1024     # csrc/features.cu kDescribeMaxThreads


def describe_threads(n_features: int, sms: int) -> int:
    """Threads of the descriptor's block a feature on a card of `sms`
    SMs: the most of 1,024, 512 and 256 that keep the call within 1,024
    threads an SM (one scan's 32 features: 1,024; 200 scans' 6,400: 256;
    on an H100 6.74-6.75 against 7.31-7.32 µs at 512 for one scan,
    72.52-72.61 against 90.47-90.52 at 128 and 111.30-111.34 at 512 for
    200 scans: examples/tune_torch_port_kernels.py --features).  The bits
    do not depend on it."""
    t = DESCRIBE_MAX_THREADS
    while t > 256 and -(-n_features // sms) * t > DESCRIBE_MAX_THREADS:
        t //= 2
    return t


def detect_features(params: FeatureParams, ranges, hit,
                    intermediates: bool = False):
    """features/detector.py detect: up to `max_features` interest points
    of each scan of ranges / hit (..., B) (B = params.num_beams), a
    FeatureSet with leading dims (...).

    On CUDA tensors: ONE launch of the detector kernel (csrc/features.cu:
    a thread-block cluster a scan, `detect_cluster` blocks each owning a
    share of the beams; the float64 arc and Gaussian sums, the searches,
    responses and peaks in shared memory, exchanged between the blocks,
    the top-K by counting ranks).  Limits: 1 to 8 scales (num_scales),
    1 <= max_features <= B, smooth_half_beams >= 0, and B * (34 + 12
    num_scales) + 256 bytes of shared memory within a block's 226 KB
    (2,459 beams at 5 scales);
    other parameters raise ValueError.  `intermediates`: also return the
    cumulative arc (..., B) and the smoothed points (..., S, B, 2), for a
    check against the plain twin's; CUDA only.  On the CPU the plain
    twin, detector._detect_plain."""
    dev = ranges.device
    if dev.type == "cpu":
        if intermediates:
            raise ValueError("detect_features: intermediates= needs CUDA "
                             "tensors")
        return detector._detect_plain(params, ranges, hit)
    if dev.type != "cuda":
        raise ValueError(f"detect_features: unsupported device {dev}")
    lib = build()
    b, s, f = params.num_beams, params.num_scales, params.max_features
    half = int(params.smooth_half_beams)
    if not 1 <= s <= lib.ndtg_features_max_scales():
        raise ValueError(f"detect_features: {s} scales, expected 1 to "
                         f"{lib.ndtg_features_max_scales()}")
    if not 1 <= f <= b or half < 0 or b >= 2 ** 31:
        raise ValueError(f"detect_features: {f} features of {b} beams, a "
                         f"half window of {half}: expected 1 <= features "
                         "<= beams and a half window >= 0")
    smem = lib.ndtg_detect_smem(b, s)
    if smem > lib.ndtg_features_max_smem():
        raise ValueError(f"detect_features: {b} beams at {s} scales need "
                         f"{smem} bytes of shared memory, at most "
                         f"{lib.ndtg_features_max_smem()}")
    ranges, hit, lead, n = _scan_inputs("detect_features", params, ranges,
                                        hit)
    if n >= 2 ** 31:
        raise ValueError(f"detect_features: {n} scans, at most 2^31 - 1")
    f32 = torch.float32
    out = detector.FeatureSet(
        pts=torch.empty((*lead, f, 2), dtype=f32, device=dev),
        angles=torch.empty((*lead, f), dtype=f32, device=dev),
        scales=torch.empty((*lead, f), dtype=f32, device=dev),
        response=torch.empty((*lead, f), dtype=f32, device=dev),
        mask=torch.empty((*lead, f), dtype=torch.bool, device=dev))
    arcs = smoothed = None
    if intermediates:
        arcs = torch.empty((*lead, b), dtype=f32, device=dev)
        smoothed = torch.empty((*lead, s, b, 2), dtype=f32, device=dev)
    if n == 0:
        return (out, arcs, smoothed) if intermediates else out
    cos, sin = _beam_trig(b, dev)
    # The twin's Python-float sigmas: the kernel rounds them to float32
    # and their reciprocals, taken in float64, too, as ATen does.
    sigmas = (ctypes.c_double * s)(
        *[params.base_sigma * params.sigma_step ** i for i in range(s)])
    cluster = detect_cluster(n, _sm_count(dev))
    with _on(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ndtg_detect_features(
            ranges.data_ptr(), hit.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), n, b, s, half, f, sigmas, params.peak_min_diff,
            params.peak_min_value, out.pts.data_ptr(), out.angles.data_ptr(),
            out.scales.data_ptr(), out.response.data_ptr(),
            out.mask.data_ptr(), None if arcs is None else arcs.data_ptr(),
            None if smoothed is None else smoothed.data_ptr(), cluster,
            stream)
    _raise_on(err, "detect_features")
    LAUNCHES["detect_features"] += 1
    return (out, arcs, smoothed) if intermediates else out


def describe_features(params: FeatureParams, feats, ranges, hit):
    """features/descriptor.py describe: the (..., F, D) descriptors of
    the features `feats` (..., F) of the scans ranges / hit (..., B),
    with the same leading dims.

    On CUDA tensors: ONE launch of the descriptor kernel
    (csrc/features.cu: one block of `describe_threads` threads a
    feature; every thread bins hits and chord samples, integer hit
    counts, then 128 partial miss sums replayed in a fixed order and a
    fixed tree; no one-hot tensor; the bits do not depend on the block
    size).  Limits: at most 64 bins (rho_bins * phi_bins), and the
    shared memory of 128 sums a bin and 20 bytes a beam within a block's
    226 KB (9,900 beams at 48 bins).  On the CPU the plain twin,
    descriptor._describe_plain."""
    dev = ranges.device
    if dev.type == "cpu":
        return descriptor._describe_plain(params, feats, ranges, hit)
    if dev.type != "cuda":
        raise ValueError(f"describe_features: unsupported device {dev}")
    lib = build()
    nb = params.rho_bins * params.phi_bins
    if params.rho_bins < 1 or params.phi_bins < 1 or (
            nb > lib.ndtg_features_max_bins()):
        raise ValueError(f"describe_features: {params.rho_bins} x "
                         f"{params.phi_bins} bins, at most "
                         f"{lib.ndtg_features_max_bins()}")
    if params.descriptor_stat not in ("beta_mean", "hitmiss"):
        raise ValueError(f"describe_features: descriptor_stat "
                         f"{params.descriptor_stat!r}")
    hitmiss = params.descriptor_stat == "hitmiss"
    smem = lib.ndtg_describe_smem(params.num_beams, nb)
    if smem > lib.ndtg_features_max_smem():
        raise ValueError(f"describe_features: {params.num_beams} beams at "
                         f"{nb} bins need {smem} bytes of shared memory, at "
                         f"most {lib.ndtg_features_max_smem()}")
    ranges, hit, lead, n = _scan_inputs("describe_features", params,
                                        ranges, hit)
    f = feats.mask.shape[-1]
    f32 = torch.float32
    fpts = feats.pts.contiguous()
    _check("describe_features feats.pts", fpts, f32, (*lead, f, 2), dev)
    fang = feats.angles.contiguous()
    _check("describe_features feats.angles", fang, f32, (*lead, f), dev)
    fscale = feats.scales.contiguous()
    _check("describe_features feats.scales", fscale, f32, (*lead, f), dev)
    fmask = feats.mask.contiguous()
    _check("describe_features feats.mask", fmask, torch.bool, (*lead, f),
           dev)
    if n * f >= 2 ** 31:
        raise ValueError(f"describe_features: {n} x {f} features, at most "
                         "2^31 - 1")
    out = torch.empty((*lead, f, 2 * nb if hitmiss else nb), dtype=f32,
                      device=dev)
    if n * f == 0:
        return out
    cos, sin = _beam_trig(params.num_beams, dev)
    with _on(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ndtg_describe_features(
            ranges.data_ptr(), hit.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), fpts.data_ptr(), fang.data_ptr(),
            fscale.data_ptr(), fmask.data_ptr(), n, params.num_beams, f,
            params.rho_bins, params.phi_bins, int(hitmiss), params.min_rho,
            params.max_rho,
            # ATen divides by a Python number on the card as a product
            # with its reciprocal, taken in float64, rounded to float32.
            float(np.float32(1.0 / params.base_sigma)),
            float(np.float32(1.0 / params.rho_bins)),
            float(np.float32(1.0 / (2 * math.pi))), out.data_ptr(),
            describe_threads(n * f, _sm_count(dev)), stream)
    _raise_on(err, "describe_features")
    LAUNCHES["describe_features"] += 1
    return out


def _pair_rows(name, t, lead, inner, dtype, dev):
    """`t` (..., *inner) broadcast to (*lead, *inner), as a tensor whose
    pairs are `stride` elements apart (0 where `t` is shared) over one
    contiguous inner block: (tensor, stride).  A broadcast costs no
    copy."""
    if t.device != dev or t.dtype != dtype:
        raise ValueError(f"{name}: {t.dtype} on {t.device}, expected {dtype} "
                         f"on {dev}")
    if t.shape == (*lead, *inner) and t.is_contiguous():
        return t, math.prod(inner)
    try:
        rows = t.expand(*lead, *inner).reshape(math.prod(lead), *inner)
    except RuntimeError as e:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{(*lead, *inner)}") from e
    if not rows[0].is_contiguous():
        rows = rows.contiguous()
    return rows, rows.stride(0)


def match_features(params: FeatureParams, ref, ref_desc, mov, mov_desc, u,
                   gate=None):
    """features/ransac.py match_sets over a batch of pairs (ref set ->
    mov set: FeatureSets (..., F1) / (..., F2), descriptors (..., F, D),
    draws u (..., M, 2); the leading dims broadcast): a MatchResult; with
    `gate` (a ransac.OdometryGate) also the odometry gate's paired
    pseudo-cells, (MatchResult, src, tgt), match_sets_gated's result.

    On CUDA tensors: ONE launch of the matcher kernel (csrc/features.cu:
    a cluster of `match_cluster` blocks a pair, each the chi2 distances
    and first minima of its share of the reference features; then one
    block: the stable top-C, the M hypotheses and their MSAC scores, the
    first minimum, two Procrustes fits and, with `gate`, the gate and the
    pseudo-cells); a set or a pose shared by the batch is read in place.
    Limits: F1, F2, D, C, M >= 1 and their shared memory within a
    block's 226 KB.  On the CPU the plain twins, ransac._match_sets_plain
    and ransac._gate_plain."""
    dev = u.device
    if dev.type == "cpu":
        res = ransac._match_sets_plain(params, ref, ref_desc, mov, mov_desc,
                                       u)
        if gate is None:
            return res
        return (res, *ransac._gate_plain(res, ref, mov, gate))
    if dev.type != "cuda":
        raise ValueError(f"match_features: unsupported device {dev}")
    lib = build()
    f1, f2 = ref.mask.shape[-1], mov.mask.shape[-1]
    d = ref_desc.shape[-1]
    c, m = params.max_correspondences, params.ransac_hypotheses
    if min(f1, f2, d, c, m) < 1 or mov_desc.shape[-1] != d:
        raise ValueError(f"match_features: {f1} and {f2} features, "
                         f"descriptors of {d} and {mov_desc.shape[-1]}, "
                         f"{c} correspondences, {m} hypotheses")
    try:
        lead = torch.broadcast_shapes(
            ref.mask.shape[:-1], ref_desc.shape[:-2], mov.mask.shape[:-1],
            mov_desc.shape[:-2], u.shape[:-2])
    except RuntimeError as e:
        raise ValueError(f"match_features: leading dims do not broadcast: "
                         f"{e}") from e
    n = math.prod(lead)
    if n >= 2 ** 31 // MATCH_MAX_CLUSTER:
        raise ValueError(f"match_features: {n} pairs, at most "
                         f"{2 ** 31 // MATCH_MAX_CLUSTER - 1}")
    cluster = match_cluster(n, _sm_count(dev))
    smem = lib.ndtg_match_smem(f1, f2, d, c, m, cluster)
    if smem > lib.ndtg_features_max_smem():
        raise ValueError(f"match_features: {smem} bytes of shared memory, "
                         f"at most {lib.ndtg_features_max_smem()}")
    f32, b8 = torch.float32, torch.bool
    res = ransac.MatchResult(
        T=torch.empty((*lead, 3), dtype=f32, device=dev),
        score=torch.empty(lead, dtype=f32, device=dev),
        num_inliers=torch.empty(lead, dtype=torch.int32, device=dev),
        corr_ref=torch.empty((*lead, c), dtype=torch.int64, device=dev),
        corr_mov=torch.empty((*lead, c), dtype=torch.int64, device=dev),
        corr_mask=torch.empty((*lead, c), dtype=b8, device=dev),
        inlier_mask=torch.empty((*lead, c), dtype=b8, device=dev),
        valid=torch.empty(lead, dtype=b8, device=dev))
    if gate is not None:
        mask = torch.empty((*lead, c), dtype=b8, device=dev)
        covs = torch.empty((*lead, c, 2, 2), dtype=f32, device=dev)
        src = CellList(means=torch.empty((*lead, c, 2), dtype=f32,
                                         device=dev), covs=covs, mask=mask)
        tgt = CellList(means=torch.empty((*lead, c, 2), dtype=f32,
                                         device=dev), covs=covs, mask=mask)
    if n == 0:
        return res if gate is None else (res, src, tgt)
    rows = [
        _pair_rows("match_features ref.pts", ref.pts, lead, (f1, 2), f32,
                   dev),
        _pair_rows("match_features ref.mask", ref.mask, lead, (f1,), b8,
                   dev),
        _pair_rows("match_features ref_desc", ref_desc, lead, (f1, d), f32,
                   dev),
        _pair_rows("match_features mov.pts", mov.pts, lead, (f2, 2), f32,
                   dev),
        _pair_rows("match_features mov.mask", mov.mask, lead, (f2,), b8,
                   dev),
        _pair_rows("match_features mov_desc", mov_desc, lead, (f2, d), f32,
                   dev),
        _pair_rows("match_features u", u, lead, (m, 2), f32, dev),
    ]
    if gate is None:
        g_args = (None, None, None, 0, 0, 0, 0, 1, 0.0, 0.0, 0.0)
        outs = (None, None, None, None)
    else:
        poses = [_pair_rows(f"match_features gate.{k}", getattr(gate, k),
                            lead, (3,), f32, dev)
                 for k in ("sensor_pose", "motion", "prev_pose")]
        g_args = (*[t.data_ptr() for t, _ in poses],
                  *[st for _, st in poses], 1, int(bool(gate.check)),
                  gate.max_translation, gate.max_rotation, gate.cov_xy)
        outs = (src.means.data_ptr(), tgt.means.data_ptr(),
                covs.data_ptr(), mask.data_ptr())
    p_succ, w0 = ransac._success_and_ratio(params)
    budget = min(max(ransac.hypothesis_budget(params), 1), m)
    with _on(dev):
        err = lib.ndtg_match_features(
            *[t.data_ptr() for t, _ in rows], *[st for _, st in rows], n,
            f1, f2, d, c, m, budget, int(params.ransac_adaptive),
            params.ransac_acceptance, params.ransac_dist_threshold,
            params.ransac_rigidity * 4.0, w0, math.log1p(-p_succ), 1e-9,
            *g_args, res.T.data_ptr(), res.score.data_ptr(),
            res.num_inliers.data_ptr(), res.corr_ref.data_ptr(),
            res.corr_mov.data_ptr(), res.corr_mask.data_ptr(),
            res.inlier_mask.data_ptr(), res.valid.data_ptr(), *outs, cluster,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "match_features")
    LAUNCHES["match_features"] += 1
    return res if gate is None else (res, src, tgt)
