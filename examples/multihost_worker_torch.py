"""One rank of the port's multi-device programs (the PyTorch counterpart of
examples/multihost_worker.py), for the distributed parity tests and the
card's smoke test.

Each process is one device of a torch.distributed world: gloo on the CPU
or NCCL on the card (parallel/mesh.init_distributed).  On a 1-D mesh
("dp") or a 2-D ("dcn", "ici") mesh of rows of two ranks, every rank
runs each sharded program on the same deterministic inputs, as the
shard contract asks (the full inputs everywhere, each rank its shard):

  dense, schur, direct   optimize_sharded, optimize_schur_sharded (8
                         blocks) and optimize_direct_sharded on
                         chip_smoke.multi_loop_graph(48) (87 edges: no
                         world of 2 or 4 divides them), and the direct
                         solve on chip_smoke.two_lap_graph(200, every=10);
  links (--graph)        compute_links_sharded over every candidate pair
                         of a graph checkpoint with each draw set of the
                         --draws npz (`u_<name>`, (P, M, 2));
  fleet                  run_sequence_batch_sharded over 8 simulated
                         streams (the 2-D mesh shards them over "dcn"
                         only) and measure_fleet_throughput on them;
  mesh names             global_put / global_get / sharded / replicated
                         on a small array (and their refusal of rows
                         the shard count does not divide).

Rank 0 also runs the single-device programs on the same inputs and
writes everything to --out (npz).  Every rank uses one CPU thread.

    python examples/multihost_worker_torch.py --rank R --world W \\
        --port P [--device cuda|cpu] [--mesh 1d|2d] \\
        [--graph graph.npz --draws draws.npz] --out out.npz
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOLVER_ITERATIONS = dict(dense=15, schur=15, direct=25)
SCHUR_BLOCKS = 8
FLEET = dict(streams=8, t_steps=4, num_beams=180)


def solver_graphs():
    """name -> (init (N, 3), i, j, meas (E, 3), info diagonal (E,),
    max_seg_len), numpy, the same on every rank."""
    import chip_smoke

    init, i, j, meas, info = chip_smoke.multi_loop_graph(48)
    _, tl_init, ti, tj, tmeas, tinfo = chip_smoke.two_lap_graph(200, every=10)
    return {"multi_loop48": (init, i, j, meas, info, 8),
            "two_lap200": (tl_init, ti, tj, tmeas, tinfo, 32)}


def fleet_params():
    """The reference worker's tiny fleet configuration."""
    from ndt_feature_graph_tpu_torch.config import FuserParams, NDTMapParams

    return FuserParams(ndt=NDTMapParams(
        resolution=0.5, size_x=20.0, size_y=20.0, sensor_range=8.0,
        max_points_per_scan=256, max_cells=128, ray_samples=16))


def link_params():
    """The reference worker's tiny SLAM configuration of the link leg."""
    from ndt_feature_graph_tpu_torch.config import (
        FeatureParams, GraphParams, SLAMParams,
    )

    return SLAMParams(fuser=fleet_params().replace(
        features=FeatureParams(num_beams=180, max_range=8.0)),
        graph=GraphParams(new_node_transl_dist=2.0, max_nodes=12))


def run_solvers(mesh, axis, dev, single):
    from chip_smoke import solver_edges
    from ndt_feature_graph_tpu_torch.graph import optimize as opt
    from ndt_feature_graph_tpu_torch.graph import schur
    from ndt_feature_graph_tpu_torch.graph import sparse_direct as sd
    from ndt_feature_graph_tpu_torch.parallel import (
        schur_sharded, solver_sharded, sparse_direct_sharded,
    )

    out = {}
    for name, (init, i, j, meas, info, seg) in solver_graphs().items():
        edges = solver_edges(i, j, meas, info, dev)
        p0 = torch.as_tensor(init, device=dev)
        part = sd.make_segments(p0.shape[0], edges, max_seg_len=seg)
        its = SOLVER_ITERATIONS["direct"]
        p, chi = sparse_direct_sharded.optimize_direct_sharded(
            mesh, p0, edges, part, iterations=its, axis=axis)
        out[f"{name}_direct"], out[f"{name}_direct_chi2"] = p, chi
        if single:
            p, chi = sd.optimize_direct(p0, edges, part, iterations=its)
            out[f"{name}_direct_single"] = p
            out[f"{name}_direct_single_chi2"] = chi
        if name != "multi_loop48":
            continue
        its = SOLVER_ITERATIONS["dense"]
        out[f"{name}_dense"] = solver_sharded.optimize_sharded(
            mesh, p0, edges, iterations=its, axis=axis)
        blocks = schur.make_partition(p0.shape[0], edges, SCHUR_BLOCKS)
        out[f"{name}_schur"] = schur_sharded.optimize_schur_sharded(
            mesh, p0, edges, blocks, iterations=SOLVER_ITERATIONS["schur"],
            axis=axis)
        if single:
            out[f"{name}_dense_single"] = opt.optimize(p0, edges,
                                                       iterations=its)[0]
            out[f"{name}_schur_single"] = schur.optimize_schur(
                p0, edges, blocks, iterations=SOLVER_ITERATIONS["schur"])
    return out


def run_links(mesh, axis, dev, graph, draws, single):
    from ndt_feature_graph_tpu_torch.graph import links as links_mod
    from ndt_feature_graph_tpu_torch.graph import node as node_mod
    from ndt_feature_graph_tpu_torch.graph.slam import NDTFeatureGraphSLAM
    from ndt_feature_graph_tpu_torch.parallel import links_sharded

    lp = link_params()
    slam = NDTFeatureGraphSLAM.load(graph, lp, device=dev)
    stacked = node_mod.stack_nodes(slam.nodes)
    ref, mov, mask = slam.candidate_pairs()
    args = (lp.fuser.features, lp.fuser.ndt.resolution, stacked, ref, mov,
            mask)
    out = {}
    with np.load(draws) as dr:
        for key in dr.files:
            u = torch.as_tensor(dr[key], device=dev)
            name = key[2:]
            ls = links_sharded.compute_links_sharded(mesh, *args, u,
                                                     axis=axis)
            for f in ("ref", "mov", "T", "score", "mask", "cov"):
                out[f"links_{name}_{f}"] = getattr(ls, f)
            if single:
                ls = links_mod.compute_links_batch(*args, u)
                for f in ("T", "score", "mask"):
                    out[f"links_{name}_single_{f}"] = getattr(ls, f)
    return out


def run_fleet(mesh, axis, dev, single):
    from ndt_feature_graph_tpu_torch.fusion import scan_driver
    from ndt_feature_graph_tpu_torch.parallel import mesh as mesh_mod
    from ndt_feature_graph_tpu_torch.parallel import scaling

    fp = fleet_params()
    seq = scaling.simulated_sequence(fp, FLEET["t_steps"],
                                     FLEET["num_beams"], seed=0, device=dev)
    inputs = scaling.build_fleet_inputs(fp, seq, FLEET["streams"])
    _, trajs, scores = scaling.run_sequence_batch_sharded(mesh, fp, *inputs,
                                                          axis=axis)
    n = mesh_mod.axis_size(mesh, axis)
    sps, _ = scaling.measure_fleet_throughput(
        fp, seq, n_devices=n, streams_per_device=FLEET["streams"] // n,
        reps=1, mesh=mesh, axis=axis)
    out = {"fleet_trajs": trajs, "fleet_scores": scores,
           "fleet_scans_per_sec": torch.tensor(sps)}
    if single:
        _, trajs, scores = scan_driver.run_sequence_batch(fp, *inputs)
        out["fleet_single_trajs"], out["fleet_single_scores"] = trajs, scores
    return out


def mesh_names_arrays():
    """The placement names' inputs: a (12, 3) float32 array and a bool
    mask of its rows."""
    return (np.arange(36, dtype=np.float32).reshape(12, 3),
            np.arange(12) % 3 == 0)


def mesh_names(mesh, axis, dev):
    """The reference's placement names over the mesh on mesh_names_arrays,
    the same on every rank: global_put / global_get with a row spec and
    an empty one, sharded, replicated; 11 rows, which no shard count of
    2 to 4 divides, must raise ValueError as the reference's do (over
    more than one shard).  Returns the number of ranks where every
    placement read back as it should, the gathered array and mask, and
    this rank's shard."""
    from ndt_feature_graph_tpu_torch.parallel import mesh as mesh_mod

    x, mask = mesh_names_arrays()
    spec = (axis,)
    rows = mesh_mod.global_put(mesh, x, spec)
    t = torch.as_tensor(x, device=dev)
    got = mesh_mod.global_get(mesh, rows, spec)
    got_mask = mesh_mod.global_get(mesh, mesh_mod.global_put(mesh, mask,
                                                             spec), spec)
    refused = 0
    for place in (lambda: mesh_mod.global_put(mesh, x[:11], spec),
                  lambda: mesh_mod.sharded(mesh, t[:11], axis)):
        try:
            place()
        except ValueError:
            refused += 1
    ok = (torch.equal(rows, mesh_mod.sharded(mesh, t, axis))
          and torch.equal(rows, mesh_mod.shard_rows(mesh, t, axis))
          and np.array_equal(got, x) and np.array_equal(got_mask, mask)
          and np.array_equal(mesh_mod.global_get(
              mesh, mesh_mod.global_put(mesh, x, ()), ()), x)
          and mesh_mod.replicated(mesh, t) is t
          and refused == (2 if mesh_mod.axis_size(mesh, axis) > 1 else 0))
    flag = torch.tensor([float(ok)], device=dev)
    return {"mesh_names_ok": mesh_mod.psum(mesh, flag, axis),
            "mesh_names_get": torch.as_tensor(got),
            "mesh_names_mask": torch.as_tensor(got_mask),
            "mesh_names_shard": rows}


def mesh_refusals(world):
    """How many of the two malformed meshes raise ValueError (a mesh
    smaller than the world; rows of 3 in a world of 4)."""
    from ndt_feature_graph_tpu_torch.parallel import mesh as mesh_mod

    refused = 0
    for make in (lambda: mesh_mod.make_mesh(world - 1 or 2),
                 lambda: mesh_mod.make_mesh_2d(local_size=3)):
        try:
            make()
        except ValueError:
            refused += 1
    return refused


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the card (default; raises without one) or the "
                         "CPU")
    ap.add_argument("--mesh", choices=["1d", "2d"], default="1d")
    ap.add_argument("--graph", help="graph checkpoint for the link leg")
    ap.add_argument("--draws", help="npz of link draws u_<name> (P, M, 2)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    torch.set_num_threads(1)

    import torch.distributed as dist

    from ndt_feature_graph_tpu_torch import resolve_device
    from ndt_feature_graph_tpu_torch.parallel import mesh as mesh_mod

    # The card unless --device cpu; raises where there is none.
    dev = resolve_device(None if args.device == "cuda" else "cpu")
    if dev.type == "cuda":
        dev = torch.device("cuda", args.rank % torch.cuda.device_count())
    mesh_mod.init_distributed(f"localhost:{args.port}", args.world,
                              args.rank, device=dev)
    try:
        if args.mesh == "2d":
            mesh = mesh_mod.make_mesh_2d(local_size=2)
            axis, fleet_axis = ("dcn", "ici"), "dcn"
        else:
            mesh = mesh_mod.make_mesh(args.world)
            axis = fleet_axis = "dp"
        single = args.rank == 0
        out = run_solvers(mesh, axis, dev, single)
        out["mesh_refusals"] = torch.tensor(mesh_refusals(args.world))
        out.update(mesh_names(mesh, axis, dev))
        print(f"rank {args.rank} solvers done", flush=True)
        if args.graph:
            out.update(run_links(mesh, axis, dev, args.graph, args.draws,
                                 single))
            print(f"rank {args.rank} links done", flush=True)
        out.update(run_fleet(mesh, fleet_axis, dev, single))
        print(f"rank {args.rank} fleet done", flush=True)
        if single:
            np.savez(args.out, **{k: v.detach().cpu().numpy()
                                  for k, v in out.items()})
    finally:
        dist.destroy_process_group()
    print(f"rank {args.rank} done", flush=True)


if __name__ == "__main__":
    main()
