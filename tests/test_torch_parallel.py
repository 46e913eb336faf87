"""The port's multi-device programs (parallel/) on torch.distributed worlds
of CPU processes (gloo), against the JAX package's single-device and
shard_map programs on the same inputs and against the port's own
single-device programs.

Two spawns of examples/multihost_worker_torch.py, each computing every
program in one go while this process computes the reference's results
(module fixture): a 4-rank world on a 1-D "dp" mesh, and a 2x2 ("dcn",
"ici") mesh whose programs shard over both axes (the fleet over "dcn"
alone: measure_fleet_throughput(n_devices=2)); each also runs the
reference's placement names (global_put / global_get / sharded /
replicated) on a small array, held to the reference's own on a mesh of
4 virtual devices.  The graphs are chip_smoke.multi_loop_graph(48) (87
edges, which no world of 2 or 4 divides) and
chip_smoke.two_lap_graph(200); the link leg runs on a small loop's
graph, built by the port and saved as a checkpoint that both packages
load, with the reference's draws for its single-device batch and for
its shard_map (which splits its key over the padded pair
count).  The JAX shard_maps run on 4 of conftest.py's 8 virtual
devices.  In a gloo world of one rank, formed in this process, each
sharded solver is held to its single-device twin bit for bit: it is the
same body with an all-reduce as its reduction.

Tolerances: poses within 2e-4 of every other solve of the same graph
(tests/test_parallel.py's atol: the ranks' partial sums meet in another
order than one device's scatter or XLA's psum), the direct solver's chi2
within 1e-3 relative; links: the RANSAC poses within 1e-4, scores within
1e-5, the same valid pairs; the fleet's trajectories equal (a stream's
arithmetic does not depend on the other streams).
"""

import importlib.util
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_feature_graph_tpu.graph import optimize as jopt
from ndt_feature_graph_tpu.graph import schur as jschur
from ndt_feature_graph_tpu.graph import sparse_direct as jsd
from ndt_feature_graph_tpu.parallel import mesh as jmesh
from ndt_feature_graph_tpu.parallel import schur_sharded as jschur_sh
from ndt_feature_graph_tpu.parallel import solver_sharded as jsolver_sh
from ndt_feature_graph_tpu.parallel import sparse_direct_sharded as jsd_sh
from ndt_feature_graph_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = ROOT / "examples" / "multihost_worker_torch.py"
POSE_ATOL, CHI2_RTOL = 2e-4, 1e-3
LINK_T_ATOL, LINK_SCORE_ATOL = 1e-4, 1e-5
SPAWN_TIMEOUT_S = 120
WORLDS = {"dp4": ["--mesh", "1d"], "mesh2x2": ["--mesh", "2d"]}
N_SHARDS = 4         # both worlds shard the solvers and links four ways


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


worker = _load("multihost_worker_torch", WORKER)
fixture_gen = _load("make_torch_port_fixture",
                    ROOT / "examples" / "make_torch_port_fixture.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _link_graph(path):
    """A small loop's graph at the reference worker's link parameters
    (tests/test_multihost.py's loop), built by the port on the CPU and
    saved as a checkpoint; returns the reference's slam loaded from it."""
    from ndt_feature_graph_tpu.config import (
        FeatureParams, FuserParams, GraphParams, NDTMapParams, SLAMParams,
    )
    from ndt_feature_graph_tpu.graph.slam import NDTFeatureGraphSLAM
    from ndt_feature_graph_tpu_torch.graph.slam import (
        NDTFeatureGraphSLAM as TSLAM,
    )
    from ndt_feature_graph_tpu_torch.io import dataset

    lp = SLAMParams(
        fuser=FuserParams(
            ndt=NDTMapParams(resolution=0.5, size_x=20.0, size_y=20.0,
                             sensor_range=8.0, max_points_per_scan=256,
                             max_cells=128, ray_samples=16),
            features=FeatureParams(num_beams=180, max_range=8.0)),
        graph=GraphParams(new_node_transl_dist=2.0, max_nodes=12))
    assert repr(lp) == repr(worker.link_params())
    gen = torch.Generator().manual_seed(7)
    seq = dataset.simulate_sequence(
        dataset.loop_trajectory(20, radius=4.0, device="cpu"),
        num_beams=180, max_range=8.0, generator=gen, device="cpu")
    slam = TSLAM(worker.link_params(), seed=0)
    slam.initialize(seq.gt[0], torch.zeros(3), seq.ranges[0], seq.hit[0])
    slam.run_sequence_chunked(seq.odom, seq.ranges, seq.hit, chunk=10)
    slam.finalize_current_node()
    slam.save(path)
    return NDTFeatureGraphSLAM.load(path, lp)


def _spawn(world, args, out, tmp):
    """Start one gloo world of `world` worker processes; `_wait` gives
    rank 0's npz."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return [subprocess.Popen(
        [sys.executable, str(WORKER), "--rank", str(r), "--world",
         str(world), "--port", str(port), "--device", "cpu", "--out",
         str(out), *args],
        cwd=str(tmp), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)], out


def _wait(spawned):
    procs, out = spawned
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0].decode(
                errors="replace"))
    except subprocess.TimeoutExpired:
        pytest.fail(f"a gloo world of {len(procs)} did not finish in "
                    f"{SPAWN_TIMEOUT_S} s")
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return dict(np.load(out))


def _jax_edges(i, j, meas, info):
    return jopt.EdgeList(
        i=jnp.asarray(i, jnp.int32), j=jnp.asarray(j, jnp.int32),
        meas=jnp.asarray(meas),
        info=jnp.asarray(np.asarray(info)[:, None, None] * np.eye(3),
                         jnp.float32),
        mask=jnp.ones(len(i), bool))


def _jax_references(slam, pair_count, key):
    """The reference's single-device and 4-device shard_map results on the
    worker's inputs."""
    from ndt_feature_graph_tpu.graph import links as jlinks
    from ndt_feature_graph_tpu.graph import node as jnode
    from ndt_feature_graph_tpu.parallel import links_sharded as jlinks_sh

    mesh = jmesh.make_mesh(N_SHARDS)
    ref = {}
    for name, (init, i, j, meas, info, seg) in worker.solver_graphs().items():
        edges = _jax_edges(i, j, meas, info)
        p0 = jnp.asarray(init)
        part = jsd.make_segments(p0.shape[0], edges, max_seg_len=seg)
        its = worker.SOLVER_ITERATIONS["direct"]
        p, chi = jsd.optimize_direct(p0, edges, part, iterations=its)
        ref[f"{name}_direct"] = (np.asarray(p), float(chi))
        p, chi = jsd_sh.optimize_direct_sharded(mesh, p0, edges, part,
                                                iterations=its)
        ref[f"{name}_direct_shard_map"] = (np.asarray(p), float(chi))
        if name != "multi_loop48":
            continue
        its = worker.SOLVER_ITERATIONS["dense"]
        ref[f"{name}_dense"] = np.asarray(jopt.optimize(p0, edges,
                                                        iterations=its)[0])
        ref[f"{name}_dense_shard_map"] = np.asarray(
            jsolver_sh.optimize_sharded(mesh, p0, edges, iterations=its))
        blocks = jschur.make_partition(p0.shape[0], edges,
                                       worker.SCHUR_BLOCKS)
        its = worker.SOLVER_ITERATIONS["schur"]
        ref[f"{name}_schur"] = np.asarray(jschur.optimize_schur(
            p0, edges, blocks, iterations=its))
        ref[f"{name}_schur_shard_map"] = np.asarray(
            jschur_sh.optimize_schur_sharded(mesh, p0, edges, blocks,
                                             iterations=its))

    lp = slam.params
    stacked = jnode.stack_nodes(slam.nodes)
    r, m, k = slam.candidate_pairs()
    assert int(r.shape[0]) == pair_count
    args = (lp.fuser.features, lp.fuser.ndt.resolution, stacked, r, m, k)
    ls = jlinks.compute_links_batch(*args, key)
    ref["links_single"] = {f: np.asarray(getattr(ls, f))
                           for f in ("T", "score", "mask")}
    ls = jlinks_sh.compute_links_sharded(mesh, *args, key)
    ref["links_padded"] = {f: np.asarray(getattr(ls, f))[:pair_count]
                           for f in ("T", "score", "mask")}
    ref.update(_jax_mesh_names())
    return ref


def _jax_mesh_names():
    """The reference's placement names on the worker's arrays over a mesh
    of 4 devices laid out as each world's: global_get of global_put /
    sharded / replicated, the first device's shard, and how many of
    global_put and sharded refuse 11 rows."""
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    x, mask = worker.mesh_names_arrays()
    meshes = {"dp4": (jmesh.make_mesh(N_SHARDS), "dp"),
              "mesh2x2": (Mesh(np.asarray(jax.devices()[:N_SHARDS]).reshape(
                  2, 2), ("dcn", "ici")), ("dcn", "ici"))}
    ref = {}
    for world, (mesh, axis) in meshes.items():
        rows = jmesh.global_put(mesh, x, P(axis))
        first = mesh.devices.flat[0]
        refused = 0
        for place in (lambda: jmesh.global_put(mesh, x[:11], P(axis)),
                      lambda: jmesh.sharded(mesh, x[:11], axis)):
            try:
                place()
            except ValueError:
                refused += 1
        ref[f"mesh_names_{world}"] = {
            "get": jmesh.global_get(mesh, rows),
            "mask": jmesh.global_get(mesh, jmesh.global_put(mesh, mask,
                                                            P(axis))),
            "sharded": jmesh.global_get(mesh, jmesh.sharded(mesh, x, axis)),
            "replicated": jmesh.global_get(mesh, jmesh.replicated(mesh, x)),
            "shard": next(np.asarray(s.data) for s in rows.addressable_shards
                          if s.device == first),
            "refused": refused}
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds run while this process computes the reference's
    results."""
    tmp = tmp_path_factory.mktemp("torch_parallel")
    slam = _link_graph(str(tmp / "graph.npz"))
    p = int(slam.candidate_pairs()[0].shape[0])
    key = jax.random.PRNGKey(3)
    m_hyp = slam.params.fuser.features.ransac_hypotheses
    p_tot = -(-p // N_SHARDS) * N_SHARDS
    np.savez(tmp / "draws.npz",
             u_single=fixture_gen._pair_uniforms(key, p, m_hyp),
             u_padded=fixture_gen._pair_uniforms(key, p_tot, m_hyp)[:p])
    spawned = {name: _spawn(4, [*args, "--graph", str(tmp / "graph.npz"),
                                "--draws", str(tmp / "draws.npz")],
                            tmp / f"{name}.npz", tmp)
               for name, args in WORLDS.items()}
    ref = _jax_references(slam, p, key)
    return {name: _wait(s) for name, s in spawned.items()}, ref, p


def _close(got, want, what):
    np.testing.assert_allclose(got, want, atol=POSE_ATOL, err_msg=what)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("solver", ["dense", "schur"])
def test_sharded_dense_and_schur_solves(runs, world, solver):
    """optimize_sharded / optimize_schur_sharded on the 48-node multi-loop
    graph (87 edges over 4 ranks, padded) against the port's and the
    reference's single-device solves and the reference's shard_map."""
    out, ref, _ = runs
    got = out[world][f"multi_loop48_{solver}"]
    assert np.isfinite(got).all()
    _close(got, out[world][f"multi_loop48_{solver}_single"], "port single")
    _close(got, ref[f"multi_loop48_{solver}"], "JAX single")
    _close(got, ref[f"multi_loop48_{solver}_shard_map"], "JAX shard_map")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("graph", ["multi_loop48", "two_lap200"])
def test_sharded_direct_solve(runs, world, graph):
    """optimize_direct_sharded (edge- and segment-sharded, padded segment
    batch) against optimize_direct of both packages and the reference's
    shard_map: poses and chi2."""
    out, ref, _ = runs
    o = out[world]
    got, chi = o[f"{graph}_direct"], float(o[f"{graph}_direct_chi2"])
    assert np.isfinite(got).all() and np.isfinite(chi)
    for what, (want, want_chi) in (
            ("port single", (o[f"{graph}_direct_single"],
                             float(o[f"{graph}_direct_single_chi2"]))),
            ("JAX single", ref[f"{graph}_direct"]),
            ("JAX shard_map", ref[f"{graph}_direct_shard_map"])):
        _close(got, want, what)
        assert abs(chi - want_chi) <= CHI2_RTOL * abs(want_chi), (
            what, chi, want_chi)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("draws", ["single", "padded"])
def test_sharded_links(runs, world, draws):
    """compute_links_sharded over every candidate pair (padded to the
    shard count) equals compute_links_batch on the same draws, and holds
    to the reference's batch (its own key split over the pairs) or its
    shard_map (split over the padded count)."""
    out, ref, p = runs
    o = out[world]
    name = f"links_{draws}"
    assert o[f"{name}_T"].shape[0] % N_SHARDS == 0
    assert not o[f"{name}_mask"][p:].any()
    np.testing.assert_array_equal(
        o[f"{name}_cov"], np.tile(np.eye(3, dtype=np.float32) * 0.05,
                                  (len(o[f"{name}_cov"]), 1, 1)))
    for f, tol in (("T", LINK_T_ATOL), ("score", LINK_SCORE_ATOL)):
        got = o[f"{name}_{f}"][:p]
        np.testing.assert_array_equal(got, o[f"{name}_single_{f}"])
        valid = ref[name]["mask"]
        np.testing.assert_allclose(got[valid], ref[name][f][valid], atol=tol)
    np.testing.assert_array_equal(o[f"{name}_mask"][:p],
                                  o[f"{name}_single_mask"])
    np.testing.assert_array_equal(o[f"{name}_mask"][:p], ref[name]["mask"])
    assert ref[name]["mask"].sum() >= 3


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_fleet_equals_one_rank(runs, world):
    """run_sequence_batch_sharded (4 shards of 2 streams; on the 2x2 mesh
    2 shards over "dcn") gives the one-rank run's trajectories and
    scores, and measure_fleet_throughput over the mesh returns a rate."""
    o = runs[0][world]
    np.testing.assert_array_equal(o["fleet_trajs"], o["fleet_single_trajs"])
    np.testing.assert_array_equal(o["fleet_scores"],
                                  o["fleet_single_scores"])
    assert np.isfinite(o["fleet_scans_per_sec"]) and (
        o["fleet_scans_per_sec"] > 0)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_refuses_a_part_of_the_world(runs, world):
    """make_mesh smaller than the world and make_mesh_2d with rows that do
    not divide it raise ValueError on every rank."""
    assert int(runs[0][world]["mesh_refusals"]) == 2


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_placement_names(runs, world):
    """The reference's global_put / global_get / sharded / replicated over
    the port's mesh against the reference's own on a mesh of 4 devices
    laid out as the world's: the full value at its global shape, the
    first shard, and both refusing rows the shard count does not
    divide (checked on every rank)."""
    out, ref, _ = runs
    o, want = out[world], ref[f"mesh_names_{world}"]
    assert float(o["mesh_names_ok"][0]) == 4.0
    assert want["refused"] == 2
    for f in ("sharded", "replicated"):
        np.testing.assert_array_equal(want[f], want["get"])
    np.testing.assert_array_equal(o["mesh_names_get"], want["get"])
    np.testing.assert_array_equal(o["mesh_names_mask"], want["mask"])
    np.testing.assert_array_equal(o["mesh_names_shard"], want["shard"])
    assert o["mesh_names_get"].dtype == want["get"].dtype
    assert o["mesh_names_mask"].dtype == want["mask"].dtype


def test_mesh_helpers_without_a_process_group():
    """pad_to_multiple as the reference's; init_distributed is a no-op for
    one process without an address; a mesh needs a process group."""
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    for mult, fill in ((4, 0), (5, 0), (3, -1)):
        np.testing.assert_array_equal(
            tmesh.pad_to_multiple(torch.tensor(x), mult, fill=fill).numpy(),
            np.asarray(jmesh.pad_to_multiple(jnp.asarray(x), mult,
                                             fill=fill)))
    tmesh.init_distributed()
    tmesh.init_distributed(num_processes=1)
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_distributed"):
        tmesh.make_mesh()


@pytest.mark.parametrize("graph", ["multi_loop48", "two_lap200"])
def test_partitions_carry_across(graph):
    """The host layouts the sharded Schur and direct solves split:
    the reference's make_partition / make_segments, carried over by
    interop, equal the port's own on the same edges."""
    from ndt_feature_graph_tpu_torch import interop
    from ndt_feature_graph_tpu_torch.graph import schur as tschur
    from ndt_feature_graph_tpu_torch.graph import sparse_direct as tsd

    init, i, j, meas, info, seg = worker.solver_graphs()[graph]
    jedges = _jax_edges(i, j, meas, info)
    tedges = interop.edge_list_from_jax(
        {k: np.asarray(v) for k, v in jedges._asdict().items()} | {
            "is_odom": None}, device="cpu")
    n = len(init)
    pairs = (
        (interop.seg_partition_from_jax(
            jax.tree.map(np.asarray, jsd.make_segments(n, jedges, seg)),
            device="cpu"), tsd.make_segments(n, tedges, max_seg_len=seg)),
        (interop.schur_partition_from_jax(
            jax.tree.map(np.asarray, jschur.make_partition(
                n, jedges, worker.SCHUR_BLOCKS)), device="cpu"),
         tschur.make_partition(n, tedges, worker.SCHUR_BLOCKS)))
    for got, want in pairs:
        for f in want.__dataclass_fields__:
            a, b = getattr(got, f), getattr(want, f)
            if isinstance(b, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(a, b), f
            else:
                assert a == b, f


@pytest.mark.parametrize("solver", ["dense", "schur", "direct"])
def test_one_rank_world_is_the_single_device_program(solver):
    """In a gloo world of one rank each sharded solver is the single-device
    solver with an all-reduce as its reduce hook: equal bit for bit, on
    the 48-node multi-loop graph (and the direct solver's chi2 too)."""
    import torch.distributed as dist

    from chip_smoke import solver_edges
    from ndt_feature_graph_tpu_torch.graph import optimize as topt
    from ndt_feature_graph_tpu_torch.graph import schur as tschur
    from ndt_feature_graph_tpu_torch.graph import sparse_direct as tsd
    from ndt_feature_graph_tpu_torch.parallel import (
        schur_sharded, solver_sharded, sparse_direct_sharded,
    )

    init, i, j, meas, info, seg = worker.solver_graphs()["multi_loop48"]
    edges = solver_edges(i, j, meas, info, "cpu")
    p0 = torch.as_tensor(init)
    its = worker.SOLVER_ITERATIONS[solver]
    if solver == "dense":
        want = (topt.optimize(p0, edges, iterations=its)[0],)
        run = lambda mesh: (solver_sharded.optimize_sharded(  # noqa: E731
            mesh, p0, edges, iterations=its),)
    elif solver == "schur":
        blocks = tschur.make_partition(len(init), edges, worker.SCHUR_BLOCKS)
        want = (tschur.optimize_schur(p0, edges, blocks, iterations=its),)
        run = lambda mesh: (schur_sharded.optimize_schur_sharded(  # noqa: E731
            mesh, p0, edges, blocks, iterations=its),)
    else:
        part = tsd.make_segments(len(init), edges, max_seg_len=seg)
        want = tsd.optimize_direct(p0, edges, part, iterations=its)
        run = lambda mesh: (  # noqa: E731
            sparse_direct_sharded.optimize_direct_sharded(
                mesh, p0, edges, part, iterations=its))
    tmesh.init_distributed(f"localhost:{_free_port()}", 1, 0, device="cpu",
                           timeout_s=SPAWN_TIMEOUT_S)
    try:
        got = run(tmesh.make_mesh(1))
    finally:
        torch.distributed.destroy_process_group()
    assert not dist.is_initialized()
    for g, w in zip(got, want):
        assert torch.isfinite(g).all() and torch.equal(g, w)
