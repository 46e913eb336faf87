"""The CUDA kernel entries of ops/cuda_kernels.py against their plain
PyTorch twins on the card: the whole registration (`newton_solve`, and
the fleet step's `newton_solve_batch`, also against the per-trial path
over the same objective kernel), the Newton-trial objective
(`newton_objective`, with the paired front end on its own), the window
term, the batch entry, the fleet step's `newton_objective_batch` and the
paired reduction; the map update's `segment_add_rows` against the CPU's
index_add bits and the sorted index_put_ path it replaced, and its
`occupancy_update` against the CPU's plain twin (at every cluster size
and on the two-pass path); the feature kernels against their plain
twins (the descriptor at every block size); the link paths'
`overlap_score` against tests/test_torch_overlap.py's numpy mirror (bit
for bit, on its pair path and its group path) and the eager path (cell
by cell); link refinement's lanes alone against their rows of the LC
bank's 171-lane batch; the sharded
dense solve in an NCCL world of one rank; and the chunked graph driver
against its CPU twin.  Marked `cuda`: they
skip without a CUDA card.  The file imports no JAX, so it also runs
where JAX is not installed (skip the JAX-importing conftest there):

    python3 -m pytest --noconftest tests/test_torch_cuda.py

Tolerances as tests/test_pallas_kernels.py (f rtol 1e-4; g, H rtol
2e-3): the kernel sums in another order than the plain version.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from ndt_feature_graph_tpu_torch.ops import cuda_kernels, ndt_map
from ndt_feature_graph_tpu_torch.ops.ndt_map import CellList

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 256, 257, 6400, 100_000])
def test_pair_fgh_reduce_matches_plain(cuda_device, n):
    """Sizes around the 256-thread block and many-block reductions."""
    args = chip_smoke.random_pairs(n, cuda_device, seed=n)
    before = cuda_kernels.LAUNCHES["pair_fgh_reduce"]
    got = cuda_kernels.pair_fgh_reduce(*args, 1.0, 0.05)
    again = cuda_kernels.pair_fgh_reduce(*args, 1.0, 0.05)
    ref = cuda_kernels.pair_fgh_reduce_reference(*args, 1.0, 0.05)
    chip_smoke.compare(f"pair_fgh_reduce n={n}", got, ref)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert cuda_kernels.LAUNCHES["pair_fgh_reduce"] == before + 2


@pytest.mark.cuda
def test_pair_fgh_reduce_broadcasts_like_pallas(cuda_device):
    """(N, K) pairs against (N, 1) source terms, as the D2D window term
    hands them to the Pallas kernel."""
    rng = np.random.default_rng(3)
    n, k = 64, 25
    L = 0.2 * rng.standard_normal((n, k, 2, 2))
    Lc = 0.2 * rng.standard_normal((n, 1, 2, 2))
    t = lambda x: torch.as_tensor(x, dtype=torch.float32,  # noqa: E731
                                  device=cuda_device)
    args = (t(0.5 * rng.standard_normal((n, k, 2))),
            t(L @ L.transpose(0, 1, 3, 2) + 0.05 * np.eye(2)),
            t(3.0 * rng.standard_normal((n, 1, 2))),
            t(Lc @ Lc.transpose(0, 1, 3, 2) + 0.02 * np.eye(2)),
            torch.as_tensor(rng.random((n, k)) < 0.7, device=cuda_device))
    chip_smoke.compare(
        "pair_fgh_reduce broadcast",
        cuda_kernels.pair_fgh_reduce(*args, 1.0, 0.05),
        cuda_kernels.pair_fgh_reduce_reference(*args, 1.0, 0.05))


@pytest.mark.cuda
def test_kernels_match_plain_at_main_path_shapes(cuda_device):
    """Both entries on a canonical fuser state (N=256 x K=25, 64 feature
    pairs, all masked, windows across the grid edge): chip_smoke.py's
    phase 3."""
    with np.load(chip_smoke.FIXTURE) as f:
        fx = dict(f)
    sp = chip_smoke.canonical_slam_params(float(fx["split_m"]),
                                          int(fx["max_nodes"]))
    out = chip_smoke.kernel_checks(sp, fx, cuda_device)
    assert set(out) == {"newton_objective", "fgh_dense_flat",
                        "pair_fgh_reduce"}
    for entry in out.values():
        assert entry["ms"] > entry["bound_ms"] > 0.0


def _trial(dev):
    from ndt_feature_graph_tpu_torch.ops import d2d_analytic

    with np.load(chip_smoke.FIXTURE) as f:
        fx = dict(f)
    sp = chip_smoke.canonical_slam_params(float(fx["split_m"]),
                                          int(fx["max_nodes"]))
    return sp.fuser, chip_smoke.trial_case(sp, fx, dev), d2d_analytic


@pytest.mark.cuda
@pytest.mark.parametrize("n_src", [256, 1024])
@pytest.mark.parametrize("n", [1, 2, 3], ids=["K9", "K25", "K49"])
def test_newton_objective_matches_plain(cuda_device, n, n_src):
    """The whole trial objective (window + 64 feature pairs + odometry)
    at the source list's budget and at its full capacity, for windows of
    9, 25 and 49 cells: one launch, identical bits on repeat."""
    p, (state, src, T0, Q, d, fs, ft), _ = _trial(cuda_device)
    m = p.matcher.replace(n_neighbours=n)
    args = (d, T0, src.head(n_src), state.packed, state.grid.origin,
            p.ndt.grid_h, p.ndt.grid_w, p.ndt.resolution, m, fs, ft, Q)
    cuda_kernels.reset_launch_counts()
    got = cuda_kernels.newton_objective(*args)
    again = cuda_kernels.newton_objective(*args)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES == {
        "newton_objective": 2, "fgh_dense_flat": 0, "pair_fgh_reduce": 0,
        "fgh_dense_flat_batch": 0, "newton_objective_batch": 0,
        "newton_solve": 0, "newton_solve_batch": 0, "row_sum": 0,
        "segment_add_rows": 0, "occupancy_update": 0, "overlap_score": 0,
        "detect_features": 0, "describe_features": 0, "match_features": 0}
    chip_smoke.compare(f"newton_objective K={(2 * n + 1) ** 2} N={n_src}",
                       got, cuda_kernels.newton_objective_reference(*args))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("n_pairs", [1, 64, 300, 5000])
def test_paired_front_end_matches_plain(cuda_device, n_pairs):
    """The paired term alone through newton_objective (pair inputs
    formed in the kernel) against d2d_analytic.fgh_paired, from one pair
    to lists that span several blocks of the cluster."""
    p, (state, _, T0, _, d, _, _), d2d_analytic = _trial(cuda_device)
    fs, ft = chip_smoke.feature_pairs(T0, cuda_device, n=n_pairs, seed=7)
    got = cuda_kernels.newton_objective(
        d, T0, None, None, None, p.ndt.grid_h, p.ndt.grid_w,
        p.ndt.resolution, p.matcher, fs, ft)
    again = cuda_kernels.newton_objective(
        d, T0, None, None, None, p.ndt.grid_h, p.ndt.grid_w,
        p.ndt.resolution, p.matcher, fs, ft)
    chip_smoke.compare(f"paired front end, {n_pairs} pairs", got,
                       d2d_analytic.fgh_paired(d, T0, fs, ft, p.matcher))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_newton_solve_matches_plain_and_the_per_trial_path(cuda_device):
    """The whole registration at chip_smoke.py's phase 3 case (N=256 x
    K=25, 64 feature pairs, odometry) against its plain twin and the
    per-trial path, each term off in turn, step control off, bfloat16
    rows; two calls give identical bits."""
    with np.load(chip_smoke.FIXTURE) as f:
        fx = dict(f)
    sp = chip_smoke.canonical_slam_params(float(fx["split_m"]),
                                          int(fx["max_nodes"]))
    cuda_kernels.reset_launch_counts()
    out = chip_smoke.solve_checks(sp, fx, cuda_device, times=False)
    assert out["max_abs_err"] <= chip_smoke.SOLVE_TOL
    assert cuda_kernels.LAUNCHES["newton_solve"] == 12


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [8, 64])
def test_newton_solve_batch_matches_plain_and_the_per_trial_path(
        cuda_device, lanes):
    """A fleet step's registrations at chip_smoke.py's phase 3d case
    (the fleet record, with its all-masked, featureless and edge lanes)
    against the plain lockstep and the per-trial lockstep path: each
    term off in turn, f32 and bfloat16 rows, step control off;
    identical bits on repeat."""
    fp, seq = _fleet(cuda_device)
    cuda_kernels.reset_launch_counts()
    out, per = chip_smoke.fleet_solve_checks(fp, seq, lanes, cuda_device,
                                             times=False)
    assert out["max_abs_err"] <= chip_smoke.SOLVE_TOL and per > 0
    assert cuda_kernels.LAUNCHES["newton_solve_batch"] == 12


@pytest.mark.cuda
def test_fuser_update_launches_one_objective_per_trial(cuda_device):
    """fuser.update on CUDA tensors registers in one `newton_solve`
    launch (the whole Newton loop on the card) and launches no other
    entry but `segment_add_rows`, once a statistics update (the scan's
    cell list, its points), and `occupancy_update`, once for its
    occupancy."""
    from ndt_feature_graph_tpu_torch.fusion import fuser
    from ndt_feature_graph_tpu_torch.io import dataset

    with np.load(chip_smoke.FIXTURE) as f:
        fx = dict(f)
    p, (state, _, T0, _, _, fs, ft), _ = _trial(cuda_device)
    t = lambda x, dt=torch.float32: torch.as_tensor(  # noqa: E731
        x, dtype=dt, device=cuda_device)
    pts, mask = dataset.scan_to_points(t(fx["ranges"][1]),
                                       t(fx["hit"][1], torch.bool))
    cuda_kernels.reset_launch_counts()
    with chip_smoke.map_updates() as updates:
        _, info = fuser.update(state, p, t(fx["odom"][1]), pts, mask, fs,
                               ft)
    assert cuda_kernels.LAUNCHES["newton_solve"] == 1
    assert cuda_kernels.LAUNCHES["segment_add_rows"] == updates["stats"] == 2
    assert cuda_kernels.LAUNCHES["occupancy_update"] == updates["occ"] == 1
    assert sum(cuda_kernels.LAUNCHES.values()) == 1 + 3
    assert int(info.iterations) >= 1


def _small_bank(dev):
    with np.load(chip_smoke.FIXTURE) as f:
        fx = dict(f)
    sp = chip_smoke.canonical_slam_params(float(fx["split_m"]),
                                          int(fx["max_nodes"]))
    return (sp, *chip_smoke.small_bank(sp, fx, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 12, 300])
def test_fgh_dense_flat_batch_matches_plain(cuda_device, lanes):
    """The batch entry against its plain twin on a canonical node bank:
    pair lanes plus an all-masked lane, a lane on the bank's last node
    and one whose windows cross the grid edge; two calls give identical
    bits (chip_smoke.py's phase 3b)."""
    from ndt_feature_graph_tpu_torch.graph import links

    sp, bank, pairs, T0 = _small_bank(cuda_device)
    idx = np.resize(np.arange(len(pairs)), lanes)
    before = cuda_kernels.LAUNCHES["fgh_dense_flat_batch"]
    out = chip_smoke.batch_kernel_checks(
        bank, pairs[idx], T0[idx], links.source_cell_budget(bank), sp,
        cuda_device, times=False)
    assert np.isfinite(out["max_abs_err"])
    assert cuda_kernels.LAUNCHES["fgh_dense_flat_batch"] == before + 2


def _fleet(dev):
    with np.load(chip_smoke.FLEET_FIXTURE) as f:
        fl = dict(f)
    return chip_smoke.presets.fleet_serving(), chip_smoke.sequence(fl, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [4, 8, 64, 200])
def test_newton_objective_batch_matches_plain(cuda_device, lanes):
    """The fleet step's entry against its plain twin at a fleet step's
    shapes (256 source cells x K=25 + 64 feature pairs + odometry per
    lane): bfloat16 rows on and off, each term off in turn, an
    all-masked lane, a lane with an empty feature list, a lane whose
    windows cross the grid's edge, identical bits on repeat
    (chip_smoke.py's phase 3d).  200 lanes leave each lane one block."""
    fp, seq = _fleet(cuda_device)
    cuda_kernels.reset_launch_counts()
    with chip_smoke.map_updates() as updates:
        out = chip_smoke.fleet_kernel_checks(fp, seq, lanes, cuda_device,
                                             times=False)
    torch.cuda.synchronize()
    assert np.isfinite(out["max_abs_err"])
    n = cuda_kernels.LAUNCHES["newton_objective_batch"]
    chip_smoke.check_map_launches(cuda_kernels.LAUNCHES, updates, "3d")
    n_map = chip_smoke.map_launches(cuda_kernels.LAUNCHES)
    assert n > 0 and sum(cuda_kernels.LAUNCHES.values()) == n + n_map


@pytest.mark.cuda
@pytest.mark.parametrize("features", [False, True])
def test_update_batch_launches_one_objective_per_trial(cuda_device,
                                                       features):
    """A fleet step on CUDA tensors registers its B streams in one
    `newton_solve_batch` launch and launches no other entry but
    `segment_add_rows`, once a statistics update of the whole stack
    (the streams' first scans, then the step's cell lists and points),
    `occupancy_update`, once an occupancy update of the stack, and with
    features each feature kernel once a call of its function (the first
    scans' detect and describe, then the step's three)."""
    from ndt_feature_graph_tpu_torch.fusion import feature_fuser, fuser
    from ndt_feature_graph_tpu_torch.parallel import scaling

    fp, seq = _fleet(cuda_device)
    cuda_kernels.reset_launch_counts()
    with chip_smoke.map_updates() as updates:
        if features:
            states, odom, ranges, hit = scaling.build_fleet_feature_inputs(
                fp, seq, 8)
            u = torch.rand((8, fp.features.ransac_hypotheses, 2),
                           device=cuda_device)
            _, info, _ = feature_fuser.update_batch(
                states, fp, odom[:, 0], ranges[:, 0], hit[:, 0], u)
        else:
            states, odom, pts, mask = scaling.build_fleet_inputs(fp, seq, 8)
            _, info = fuser.update_batch(states, fp, odom[:, 0], pts[:, 0],
                                         mask[:, 0])
    chip_smoke.check_map_launches(cuda_kernels.LAUNCHES, updates, "step")
    n_map = chip_smoke.map_launches(cuda_kernels.LAUNCHES)
    assert n_map == updates["n"] >= 3
    assert cuda_kernels.LAUNCHES["newton_solve_batch"] == 1
    assert sum(cuda_kernels.LAUNCHES.values()) == 1 + \
        chip_smoke.counted_launches(cuda_kernels.LAUNCHES)
    assert int(info.iterations.min()) >= 1


def _solver_graph(kind, dev):
    """A 200-node graph of chip_smoke's recipes on `dev`: the reference's
    two-lap square (closures every 10 nodes) or bench.py's multi-loop
    circle."""
    if kind == "two_lap":
        _, init, i, j, meas, info = chip_smoke.two_lap_graph(200, every=10)
    else:
        init, i, j, meas, info = chip_smoke.multi_loop_graph(200)
    return (torch.as_tensor(init, device=dev),
            chip_smoke.solver_edges(i, j, meas, info, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,seg,robust", [("two_lap", 16, "none"),
                                             ("two_lap", 128, "dcs"),
                                             ("multi_loop", 64, "dcs")])
def test_optimize_direct_on_the_card_matches_the_cpu(cuda_device, kind, seg,
                                                     robust):
    """The segment-Schur solve on the card against the port on the CPU at
    200 nodes: poses within 5e-4, chi2 within 1e-3 relative (the
    reference's tolerances against its dense solve; the card's
    scatter-adds sum in another order)."""
    from ndt_feature_graph_tpu_torch.graph import sparse_direct

    out = []
    for dev in (torch.device("cpu"), cuda_device):
        init, edges = _solver_graph(kind, dev)
        part = sparse_direct.make_segments(200, edges, max_seg_len=seg)
        p, chi2 = sparse_direct.optimize_direct(init, edges, part,
                                                iterations=25,
                                                robust_kernel=robust)
        out.append((p.cpu().numpy(), float(chi2)))
    (p_cpu, c_cpu), (p_gpu, c_gpu) = out
    np.testing.assert_allclose(p_gpu, p_cpu, atol=5e-4)
    np.testing.assert_allclose(c_gpu, c_cpu, rtol=1e-3)


def _solve64(blocks, edges):
    """The float64 dense solution of H x = b for EdgeBlocks on the CPU."""
    n = blocks.D.shape[0]
    H = np.zeros((n, n, 3, 3))
    H[np.arange(n), np.arange(n)] = blocks.D.double().numpy()
    Hij = blocks.Hij.double().numpy()
    for e, (i, j) in enumerate(zip(edges.i.numpy(), edges.j.numpy())):
        H[i, j] += Hij[e]
        H[j, i] += Hij[e].T
    x = np.linalg.solve(H.transpose(0, 2, 1, 3).reshape(3 * n, 3 * n),
                        blocks.b.double().numpy().reshape(-1))
    return x.reshape(n, 3)


@pytest.mark.cuda
def test_solvers_on_the_card_match_the_cpu(cuda_device):
    """One segment-Schur linear solve (within 1e-3 of the float64
    solution's scale: the float32 LU of its reduced system alone leaves
    1.6e-4 of its own float64 solve on the CPU, 2.7e-4 on the card, where
    the whole solve measured 8.1e-5 and 3.6e-4), PCG with the chain
    and the Jacobi preconditioner and the blocked Schur solve (poses
    within 5e-4; each converged: 10 Gauss-Newton iterations, 150 CG
    iterations, within 1e-6 of the dense solve on the CPU) on the card
    against the CPU at 200 nodes."""
    from ndt_feature_graph_tpu_torch.graph import schur, sparse
    from ndt_feature_graph_tpu_torch.graph import sparse_direct

    res = []
    for dev in (torch.device("cpu"), cuda_device):
        init, edges = _solver_graph("multi_loop", dev)
        blocks = sparse.linearize_edges(init, edges, 100.0, 1e-2, init[0],
                                        robust_kernel="dcs")
        if dev.type == "cpu":
            x64 = _solve64(blocks, edges)
        part = sparse_direct.make_segments(200, edges, max_seg_len=8)
        x = sparse_direct.solve_normal_equations(blocks, edges, part, 200)
        poses = [sparse.optimize_pcg(init, edges, iterations=10,
                                     cg_iterations=150,
                                     preconditioner=pre)[0]
                 for pre in ("chain", "jacobi")]
        poses.append(schur.optimize_schur(
            init, edges, schur.make_partition(200, edges, 4), iterations=10))
        res.append((x.cpu().numpy(), [p.cpu().numpy() for p in poses]))
    (x_cpu, p_cpu), (x_gpu, p_gpu) = res
    for a, b in zip(p_gpu, p_cpu):
        np.testing.assert_allclose(a, b, atol=5e-4)
    scale = np.abs(x64).max()
    for x in (x_cpu, x_gpu):
        assert np.abs(x - x64).max() <= 1e-3 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("streams", [0, 3, 64])
def test_map_update_repeats_and_equals_the_cpu(cuda_device, streams):
    """The map update on the card (the statistics through the
    fixed-order scatter, ops/ndt_map.scatter_add_rows: the
    `segment_add_rows` kernel; the occupancy through the
    `occupancy_update` kernel): the same canonical scans added to one
    grid (or a stack of 3 or 64) twice on the card give identical bits,
    and the CPU's, one launch of each a scan."""
    with np.load(chip_smoke.FIXTURE) as f:
        fx = dict(f)
    mp = chip_smoke.canonical_slam_params().fuser.ndt
    before = {k: cuda_kernels.LAUNCHES[k] for k in chip_smoke.MAP_ENTRIES}
    a = chip_smoke.map_update_case(mp, fx, cuda_device, streams)
    b = chip_smoke.map_update_case(mp, fx, cuda_device, streams)
    assert cuda_kernels.LAUNCHES["segment_add_rows"] == (
        before["segment_add_rows"] + 6)
    assert cuda_kernels.LAUNCHES["occupancy_update"] == (
        before["occupancy_update"] + 6)
    c = chip_smoke.map_update_case(mp, fx, torch.device("cpu"), streams)
    for k in a:
        assert np.array_equal(chip_smoke._bits(a[k]), chip_smoke._bits(b[k]))
        assert np.array_equal(chip_smoke._bits(a[k]), chip_smoke._bits(c[k]))


@pytest.mark.cuda
@pytest.mark.parametrize("streams", [0, 3, 64])
def test_occupancy_update_equals_the_cpu(cuda_device, streams):
    """The occupancy kernel against its plain twin on the CPU, bit for
    bit and on repeat, over chip_smoke.occupancy_cases (the cases of
    tests/test_torch_occupancy.py's mirror: the chain's stop both ways
    and none, -0.0 bases, NaN and far points, a sensor off the grid,
    64-bit counters, a 0.3 m grid), one call a launch counted."""
    with np.load(chip_smoke.FIXTURE) as f:
        fx = dict(f)
    mp = chip_smoke.canonical_slam_params().fuser.ndt
    off = chip_smoke.occupancy_case_checks(mp, fx, cuda_device, streams)
    assert not any(off.values()), off


@pytest.mark.cuda
@pytest.mark.parametrize("streams", [0, 3])
@pytest.mark.parametrize("path", chip_smoke.OCCUPANCY_PATHS,
                         ids=["two-pass", "k1", "k2", "k4", "k8", "k16"])
def test_occupancy_update_at_every_cluster_size(cuda_device, path, streams):
    """The occupancy kernel with its cluster forced to 1, 2, 4, 8 and 16
    blocks a stream (raised to the fewest that hold the grid) and on the
    two-pass path: the CPU's bits on every case and on repeat, one
    launch counted a call."""
    with np.load(chip_smoke.FIXTURE) as f:
        fx = dict(f)
    mp = chip_smoke.canonical_slam_params().fuser.ndt
    with chip_smoke.occupancy_forced(path):
        off = chip_smoke.occupancy_case_checks(mp, fx, cuda_device, streams)
    assert not any(off.values()), off


@pytest.mark.cuda
def test_occupancy_update_on_a_grid_too_large_for_a_cluster(cuda_device):
    """A 1,200 x 1,200 grid's counters fit no cluster: the shape rule
    takes the two-pass path, which gives the CPU's bits and repeats."""
    import dataclasses

    with np.load(chip_smoke.FIXTURE) as f:
        fx = dict(f)
    mp = chip_smoke.canonical_slam_params().fuser.ndt
    big = dataclasses.replace(mp, size_x=6 * mp.size_x, size_y=6 * mp.size_y)
    assert cuda_kernels.occupancy_cluster(
        big.grid_h * big.grid_w, False, 1, lambda _: 0) == 0
    want = chip_smoke.map_update_case(big, fx, torch.device("cpu"),
                                      scans=(0, 2))
    for _ in range(2):
        got = chip_smoke.map_update_case(big, fx, cuda_device, scans=(0, 2))
        for k in want:
            assert np.array_equal(chip_smoke._bits(got[k]),
                                  chip_smoke._bits(want[k])), k


@pytest.mark.cuda
def test_occupancy_update_refuses_bad_inputs(cuda_device):
    """float64 points and a mask of the wrong shape raise (no silent
    plain version on the card)."""
    mp = chip_smoke.canonical_slam_params().fuser.ndt
    grid = ndt_map.empty_grid(mp, torch.zeros(2, device=cuda_device))
    pts = torch.zeros(8, 2, device=cuda_device)
    mask = torch.ones(8, dtype=torch.bool, device=cuda_device)
    sensor = torch.zeros(2, device=cuda_device)
    with pytest.raises(ValueError):
        cuda_kernels.update_occupancy(grid, mp, sensor, pts.double(), mask)
    with pytest.raises(ValueError):
        cuda_kernels.update_occupancy(grid, mp, sensor, pts, mask[:4])


def _segment_case(widths, dev, n_rows, idx, seed):
    rng = np.random.default_rng(seed)
    m = len(idx)
    bases = [rng.standard_normal((n_rows, c)).astype(np.float32)
             for c in widths]
    vals = [(rng.standard_normal((m, c)) * 10.0 ** rng.integers(
        -3, 3, (m, 1))).astype(np.float32) for c in widths]
    cpu = ([torch.as_tensor(b) for b in bases],
           torch.as_tensor(np.asarray(idx, np.int64)),
           [torch.as_tensor(v) for v in vals])
    return cpu, ([b.to(dev) for b in cpu[0]], cpu[1].to(dev),
                 [v.to(dev) for v in cpu[2]])


SEGMENT_LAYOUTS = ("one row", "multi-tile", "multi-chunk", "M = 0", "M = 1",
                   "-0.0 bases", "wide buckets", "dropped entries")


@pytest.mark.cuda
@pytest.mark.parametrize("widths", [(1,), (2,), (4,), (1, 2, 4)],
                         ids=["w1", "w2", "w4", "w7"])
@pytest.mark.parametrize("case", [(1, 5), (1023, 4000), (1025, 4000),
                                  (40_000, 720), (40_000, 35_280),
                                  (5000, 0), *SEGMENT_LAYOUTS])
def test_segment_add_rows_is_index_add_on_the_cpu(cuda_device, widths,
                                                  case):
    """The kernel against index_add on the CPU, bit for bit, on repeat,
    and against the sorted index_put_ path on the card: rows around a
    row block's 1,024 and a bucket-pass tile's 1,024 entries, the map
    update's scatters, no entries, and chip_smoke.segment_layout_cases
    (every entry on one row, a row block's entries across tiles, more
    than a chunk in one row block, one entry, -0.0 bases, rows past
    4,096 row blocks, the fleet's dropped entries); one launch a
    call."""
    if isinstance(case, str):
        (cb, ci, cv), (gb, gi, gv) = {
            name: (c, g) for name, c, g in chip_smoke.segment_layout_cases(
                cuda_device, widths)}[case]
    else:
        n_rows, m = case
        rng = np.random.default_rng(n_rows + m)
        idx = np.clip(rng.normal(n_rows / 2, n_rows / 8 + 1, m).astype(
            np.int64), 0, n_rows - 1)
        (cb, ci, cv), (gb, gi, gv) = _segment_case(widths, cuda_device,
                                                   n_rows, idx, seed=m)
    before = cuda_kernels.LAUNCHES["segment_add_rows"]
    got = cuda_kernels.segment_add_rows(gb, gi, gv)
    again = cuda_kernels.segment_add_rows(gb, gi, gv)
    assert cuda_kernels.LAUNCHES["segment_add_rows"] == before + 2
    want = cuda_kernels.segment_add_rows_reference(cb, ci, cv)
    srt = (ndt_map._scatter_add_rows_sorted(gb, gi, gv) if ci.numel()
           else want)
    for a, b, c, d in zip(got, again, want, srt):
        assert torch.equal(a, b)
        assert np.array_equal(chip_smoke._bits(a.cpu().numpy()),
                              chip_smoke._bits(c.numpy()))
        assert torch.equal(a.cpu(), d.cpu())
    for a, b in zip(got, gb):
        assert a.data_ptr() != b.data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("widths", [(1,), (1, 2, 4)], ids=["w1", "w7"])
def test_segment_add_rows_long_run_and_streams(cuda_device, widths):
    """One cell carrying 5,000 of 6,000 entries (chip_smoke.long_run_case),
    and a stack of 64 grids' rows kept apart by the stream offset: the
    CPU's bits, on repeat."""
    (cb, ci, cv), (gb, gi, gv) = chip_smoke.long_run_case(cuda_device,
                                                          widths)
    rng = np.random.default_rng(5)
    idx = (rng.integers(0, 40_000, (64, 720))
           + np.arange(64)[:, None] * 40_000).ravel()
    cases = [((cb, ci, cv), (gb, gi, gv)),
             _segment_case(widths, cuda_device, 64 * 40_000, idx, seed=6)]
    for (cb, ci, cv), (gb, gi, gv) in cases:
        got = cuda_kernels.segment_add_rows(gb, gi, gv)
        again = cuda_kernels.segment_add_rows(gb, gi, gv)
        want = cuda_kernels.segment_add_rows_reference(cb, ci, cv)
        for a, b, c in zip(got, again, want):
            assert torch.equal(a, b)
            assert np.array_equal(chip_smoke._bits(a.cpu().numpy()),
                                  chip_smoke._bits(c.numpy()))


@pytest.mark.cuda
def test_scan_to_points_on_the_card_is_the_cpus(cuda_device):
    """The canonical scans' points on the card equal the CPU's bit for
    bit: the directions are the CPU's float32 cos / sin, cached on the
    card, and each coordinate one float32 product."""
    from ndt_feature_graph_tpu_torch.io import dataset

    with np.load(chip_smoke.FIXTURE) as f:
        fx = dict(f)
    r, h = torch.as_tensor(fx["ranges"]), torch.as_tensor(fx["hit"])
    card, _ = dataset.scan_to_points(r.to(cuda_device), h.to(cuda_device))
    cpu, _ = dataset.scan_to_points(r, h)
    assert torch.equal(card.cpu().view(torch.int32), cpu.view(torch.int32))


@pytest.mark.cuda
def test_mcl_seed_draws_the_cpus_particles_on_the_card(cuda_device):
    """MCL's seeded draws come from a CPU generator on every device: the
    same seed gives the card the CPU's initial particles and motion
    noise, bit for bit."""
    from ndt_feature_graph_tpu_torch.config import MotionParams
    from ndt_feature_graph_tpu_torch.localization import mcl
    from ndt_feature_graph_tpu_torch.ops import d2d

    mp = chip_smoke.canonical_slam_params().fuser.ndt

    def draws(dev):
        grid = ndt_map.empty_grid(mp, torch.zeros(2, device=dev))
        loc = mcl.MCL(mp, MotionParams(), d2d.make_dense_target(grid, mp),
                      n_particles=64, seed=3)
        loc.initialize(torch.tensor([1.0, -2.0, 0.3], device=dev))
        return (loc.particles.poses.cpu(),
                torch.randn((64, 3), generator=loc.generator))

    for a, b in zip(draws(cuda_device), draws("cpu")):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_sqrt_on_the_card_is_correctly_rounded(cuda_device):
    x = torch.rand(1 << 20, device=cuda_device) * 100.0
    assert np.array_equal(torch.sqrt(x).cpu().numpy(),
                          np.sqrt(x.cpu().numpy()))


@pytest.mark.cuda
def test_fgh_dense_flat_at_p2d_shape_matches_plain(cuda_device):
    """The window entry at P2D's shape (chip_smoke.py phase 13a): 720
    point-cells of canonical scan 20 against build_from_scan of scan 0,
    K=25: kernel against plain, two calls identical, all masked zero."""
    from ndt_feature_graph_tpu_torch.io import dataset
    from ndt_feature_graph_tpu_torch.ops import d2d, d2d_analytic, ndt_map
    from ndt_feature_graph_tpu_torch.utils import pairwise

    with np.load(chip_smoke.FIXTURE) as f:
        fx = dict(f)
    p = chip_smoke.canonical_slam_params().fuser
    m = p.matcher
    T = lambda x: torch.as_tensor(x, device=cuda_device)  # noqa: E731
    pts0, m0 = dataset.scan_to_points(T(fx["ranges"][0]), T(fx["hit"][0]))
    pts1, m1 = dataset.scan_to_points(T(fx["ranges"][20]), T(fx["hit"][20]))
    zero = torch.zeros(2, device=cuda_device)
    tgt = d2d.make_dense_target(
        ndt_map.build_from_scan(p.ndt, zero, zero, pts0, m0), p.ndt)
    src = pairwise.points_as_cells(pts1, m1)
    assert src.mask.numel() == 720
    d, T0 = T([0.004, -0.003, 0.001]), T([0.49, 0.01, 0.002])
    h, w = tgt.valid.shape
    run = lambda s: cuda_kernels.fgh_dense_flat(  # noqa: E731
        d, T0, s, tgt.packed, tgt.origin, h, w, p.ndt.resolution,
        m.n_neighbours, m.lfd1, m.lfd2)
    before = cuda_kernels.LAUNCHES["fgh_dense_flat"]
    got, again = run(src), run(src)
    assert cuda_kernels.LAUNCHES["fgh_dense_flat"] == before + 2
    chip_smoke.compare("fgh_dense_flat N=720", got,
                       d2d_analytic.fgh_dense_flat(
                           d, T0, src, tgt.packed, tgt.origin, 0, h, w,
                           p.ndt.resolution, m))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    masked = CellList(src.means, src.covs, torch.zeros_like(src.mask))
    assert all(float(x.abs().max()) == 0.0 for x in run(masked))


@pytest.mark.cuda
def test_simulator_on_the_card_matches_the_cpu(cuda_device):
    """The card's raycast and simulate_sequence (with given draws)
    against the CPU's on a loop through the default room: the ground
    truth and odometry's arithmetic is the same, the ranges within 2e-5 m
    and the hits equal but for grazing and oblique beams
    (chip_smoke.grazing_beams)."""
    from ndt_feature_graph_tpu_torch.io import dataset

    rng = np.random.default_rng(0)
    traj = dataset.loop_trajectory(80, radius=4.5, device="cpu")
    ru = torch.tensor(rng.standard_normal((80, 720)), dtype=torch.float32)
    ou = torch.tensor(rng.standard_normal((79, 3)), dtype=torch.float32)
    out = {dev: dataset.simulate_sequence(traj.to(dev), 720, 30.0,
                                          range_draws=ru.to(dev),
                                          odom_draws=ou.to(dev), device=dev)
           for dev in ("cpu", cuda_device)}
    cpu, card = out["cpu"], out[cuda_device]
    assert torch.equal(card.gt.cpu(), cpu.gt)
    np.testing.assert_allclose(card.odom.cpu().numpy(), cpu.odom.numpy(),
                               rtol=0, atol=chip_smoke.ODOM_TOL)
    kind = chip_smoke.grazing_beams(dataset.default_world("cpu"), traj, 720,
                                    30.0)
    chip_smoke.check_beams("card vs CPU", card.ranges, card.hit, cpu.ranges,
                           cpu.hit, kind)


@pytest.mark.cuda
def test_sharded_dense_solve_in_an_nccl_world(cuda_device):
    """optimize_sharded in an NCCL world of one rank (NCCL takes one rank
    a card) is optimize on the 48-node multi-loop graph, bit for bit:
    the same body with an all-reduce as its reduction."""
    import torch.distributed as dist

    from ndt_feature_graph_tpu_torch.graph import optimize as opt
    from ndt_feature_graph_tpu_torch.parallel import mesh as mesh_mod
    from ndt_feature_graph_tpu_torch.parallel import solver_sharded

    mesh_mod.init_distributed(f"localhost:{chip_smoke._free_port()}", 1, 0,
                              device=cuda_device)
    try:
        assert dist.get_backend() == "nccl"
        mesh = mesh_mod.make_mesh(1)
        init, i, j, meas, info = chip_smoke.multi_loop_graph(48)
        edges = chip_smoke.solver_edges(i, j, meas, info, cuda_device)
        p0 = torch.as_tensor(init, device=cuda_device)
        got = solver_sharded.optimize_sharded(mesh, p0, edges, iterations=15)
        want = opt.optimize(p0, edges, iterations=15)[0]
        assert torch.equal(got, want)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_run_graph_chunk_on_the_card_matches_the_cpu(cuda_device):
    """run_graph_chunk over the canonical fixture's scans 1-16 (a split at
    the fixture's node distance), on the card and on the CPU twin from
    the same initial state and draws: one `newton_solve` launch a
    processed scan, one `segment_add_rows` launch a statistics update,
    one `occupancy_update` an occupancy update, each feature kernel once
    a call of its function and no other entry, the same meta, poses within 1e-3 m / rad (the kernel
    sums in another order than the plain registration) and scores
    within rtol 1.4e-3.  Measured on the H100
    (examples/measure_chunk_spread.py --card and --inputs): the card's
    scan points and map statistics are the CPU's bit for bit, so scan
    1's gap is 8.0e-8 (the CPU's own spread under +-1e-6 m odometry
    8.5e-6; before the points were the CPU's, 9.1e-5); what remains is
    the registration's summation order on the card, which chaos then
    grows: 1.28e-3 at most (scan 16), every scan within the CPU's own
    spread (1.51e-3 there)."""
    from ndt_feature_graph_tpu_torch.fusion import scan_driver
    from ndt_feature_graph_tpu_torch.graph.slam import NDTFeatureGraphSLAM

    fx = dict(np.load(chip_smoke.FIXTURE))
    sp = chip_smoke.canonical_slam_params(float(fx["split_m"]),
                                          int(fx["max_nodes"]))
    out = {}
    for dev in ("cpu", cuda_device):
        T = lambda x, dt=torch.float32: torch.as_tensor(  # noqa: E731
            x, dtype=dt, device=dev)
        ranges, hit = T(fx["ranges"][:17]), T(fx["hit"][:17], torch.bool)
        slam = NDTFeatureGraphSLAM(sp, seed=0)
        slam.initialize(T(fx["gt"][0]), torch.zeros(3, device=dev), ranges[0],
                        hit[0])
        cuda_kernels.reset_launch_counts()
        with chip_smoke.map_updates() as updates:
            st, _, traj, scores, meta = scan_driver.run_graph_chunk(
                sp.fuser, slam.state, slam.fmap, 0.0, 0,
                T(fx["odom"][1:17]), ranges[1:], hit[1:], np.ones(16, bool),
                sp.graph.new_node_transl_dist,
                fm_incr=sp.fuser.feature_map_update_incr,
                ransac_u=T(fx["ransac_u"][:16]))
        out[str(dev)] = (traj.cpu().numpy(), scores.cpu().numpy(),
                         meta.numpy(), dict(cuda_kernels.LAUNCHES),
                         updates)
    cpu, card = out["cpu"], out[str(cuda_device)]
    n_proc = int(card[2][2])
    assert 1 <= n_proc <= 16
    chip_smoke.check_map_launches(card[3], card[4], "run_graph_chunk")
    n_map = chip_smoke.map_launches(card[3])
    assert n_map == card[4]["n"] >= 3 * n_proc
    assert card[3]["newton_solve"] == n_proc == sum(
        card[3].values()) - chip_smoke.counted_launches(card[3])
    assert not any(cpu[3].values())
    np.testing.assert_array_equal(card[2][1:], cpu[2][1:])
    np.testing.assert_allclose(card[2][0], cpu[2][0], atol=1e-6)
    np.testing.assert_allclose(card[0], cpu[0], rtol=0, atol=1e-3)
    np.testing.assert_allclose(card[1], cpu[1], rtol=1.4e-3)


@pytest.mark.cuda
def test_refine_links_d2d_is_one_launch_against_the_per_trial_lockstep(
        cuda_device):
    """Link refinement on the small canonical bank in one
    `newton_solve_batch` launch with no synchronising call, against the
    per-trial lockstep over `fgh_dense_flat_batch` (chip_smoke.py phase
    17a): T, cov and mask keep its bits on every lane, and the Hessian
    the solve writes is the objective's at the returned increment."""
    from ndt_feature_graph_tpu_torch.graph import links

    sp, bank, pairs, T0 = _small_bank(cuda_device)
    p = sp.fuser
    n = len(pairs)
    t = lambda x: torch.as_tensor(x, device=cuda_device)  # noqa: E731
    eye = torch.eye(3, device=cuda_device) * 0.05
    ls = links.LinkSet(
        ref=t(pairs[:, 0]), mov=t(pairs[:, 1]),
        T=t(T0).float() + t([0.03, -0.02, 0.01]),
        cov=eye.expand(n, 3, 3).clone(),
        score=torch.zeros(n, device=cuda_device),
        mask=torch.arange(n, device=cuda_device) != 3)
    call = ((p.ndt, p.matcher, bank, ls),
            {"src_budget": links.source_cell_budget(bank)})
    out = chip_smoke.refinement_case("small bank", [call], cuda_device,
                                     times=False)
    assert out["launches"] == 1 and out["syncs"] == 0
    assert out["per_trial_launches"] > 1 and out["lanes"] == n
    assert out["hessian_equal"] == n and out["bits_equal"] == n


@pytest.mark.cuda
def test_match_d2d_and_p2d_are_one_launch(cuda_device):
    """match_d2d and match_p2d (its guarded projection in the kernel) in
    one `newton_solve` launch against their per-trial loops over
    `fgh_dense_flat`, at chip_smoke.py phase 13a's P2D case (scan 20's
    720 points on the map of scan 0): poses within 1e-6 and the same
    trials, or within the per-trial loop's own spread
    (chip_smoke.match_case); P2D within 0.01 mm of JAX's recorded
    pose."""
    from ndt_feature_graph_tpu_torch.ops import d2d
    from ndt_feature_graph_tpu_torch.utils import pairwise

    with np.load(chip_smoke.FIXTURE) as f:
        fx = dict(f)
    with np.load(chip_smoke.IO_FIXTURE) as f:
        io_fx = dict(f)
    sp = chip_smoke.canonical_slam_params(float(fx["split_m"]),
                                          int(fx["max_nodes"]))
    p, m = sp.fuser, sp.fuser.matcher
    tgt, pts, mask, T0 = chip_smoke.p2d_inputs(sp, fx, io_fx, cuda_device)
    src = pairwise.points_as_cells(pts, mask)
    h, w = tgt.valid.shape
    args = (tgt.packed, tgt.origin, h, w, p.ndt.resolution)
    out = chip_smoke.match_case(
        "match_p2d", lambda: pairwise.match_p2d(tgt, pts, mask, T0, p.ndt, m),
        lambda d0=None: chip_smoke.per_trial_match(*args, src, T0, m, True,
                                                   d0),
        times=False)
    res = pairwise.match_p2d(tgt, pts, mask, T0, p.ndt, m)
    assert np.abs(res.T.cpu().numpy()[:2] - io_fx["p2d_T"][:2]).max() <= (
        chip_smoke.P2D_JAX_TOL)
    cells = src.head(256)
    chip_smoke.match_case(
        "match_d2d", lambda: d2d.match_d2d(
            d2d.PackedTarget(tgt.origin, tgt.packed), cells, T0, p.ndt, m),
        lambda d0=None: chip_smoke.per_trial_match(*args, cells, T0, m,
                                                   False, d0),
        times=False)
    assert out["trials"] > 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 40000), (171, 40000), (4, 7),
                                   (3, 5, 1000)])
def test_row_sum_repeats_and_a_row_alone_keeps_its_bits(cuda_device, shape):
    """The fixed-order row sum: identical bits on repeat and for a row
    summed alone, within float32 rounding of torch.sum, one launch."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    x = torch.rand(shape, generator=gen, device=cuda_device)
    before = cuda_kernels.LAUNCHES["row_sum"]
    got, again = cuda_kernels.row_sum(x), cuda_kernels.row_sum(x)
    assert cuda_kernels.LAUNCHES["row_sum"] == before + 2
    assert got.shape == shape[:-1] and torch.equal(got, again)
    flat = x.reshape(-1, shape[-1])
    alone = torch.stack([cuda_kernels.row_sum(r) for r in flat[[0, -1]]])
    assert torch.equal(alone, got.reshape(-1)[[0, -1]])
    want = x.double().sum(-1)
    assert float((got.double() - want).abs().max()) <= 1e-6 * shape[-1]


OVERLAP_SHAPES = [(20, 20), (40, 40), (37, 53), (200, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("edge", [None, *chip_smoke.OVERLAP_EDGE_CASES])
@pytest.mark.parametrize("n_pairs", [1, 3, 17])
@pytest.mark.parametrize("shape", OVERLAP_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_overlap_score_is_its_mirror_and_the_eager_path(cuda_device, shape,
                                                        n_pairs, edge):
    """The overlap kernel against tests/test_torch_overlap.py's numpy
    mirror (with the card's cosf, sinf and sigmoid) bit for bit, in score,
    count and every cell index; against the eager path on the card the
    same cell indices and counts, the score within OVERLAP_SCORE_TOL; the
    same bits on repeat and for the first and last pair alone; one launch
    a call."""
    h, w = shape
    out = chip_smoke.overlap_case_checks(h, w, n_pairs, h * 7 + n_pairs,
                                         cuda_device, edge)
    assert out["mirror_off"] == 0, out
    assert out["cells_off"] == 0 and out["nb_off"] == 0, out
    assert out["score_dev"] <= chip_smoke.OVERLAP_SCORE_TOL, out
    assert out["repeat"] and out["alone"] and out["launches"] == 4, out


@pytest.mark.cuda
def test_overlap_score_rows_are_the_pairs_alone_at_scale(cuda_device):
    """1,024 pairs of 200 x 200 cells (eight blocks a pair): every tenth
    pair scored alone equals its row bit for bit."""
    occ, origins, ref_i, mov_i, T, res = chip_smoke.overlap_case(
        200, 200, 1024, seed=1)
    t = lambda x: torch.as_tensor(x, device=cuda_device)  # noqa: E731
    bank, o = t(occ), t(origins)
    score, nb = cuda_kernels.overlap_score(
        bank.reshape(-1), o, t(ref_i), t(mov_i), t(T), 200, 200, res)
    assert (nb > 0).any()
    for k in range(0, 1024, 10):
        s1, n1 = cuda_kernels.overlap_score(
            bank[ref_i[k]], o[ref_i[k]], None, None, t(T[k]), 200, 200, res,
            mov_flat=bank[mov_i[k]], mov_origins=o[mov_i[k]])
        assert torch.equal(s1, score[k]) and torch.equal(n1, nb[k])


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [1, 400, 1024, 1028, 1961, 8192, 40000])
def test_overlap_cluster_is_the_mirrors(cuda_device, hw):
    lib = cuda_kernels.build()
    assert lib.ndtg_overlap_threads() == chip_smoke.OVERLAP_THREADS
    assert lib.ndtg_overlap_cluster(hw) == chip_smoke.overlap_cluster(hw)


@pytest.mark.cuda
def test_overlap_score_refuses_bad_inputs(cuda_device):
    """A float64 pose, int32 indices, a pose of the wrong shape, a bank
    on the CPU and a strided bank raise (no plain version on the card)."""
    occ, origins, ref_i, mov_i, T, res = chip_smoke.overlap_case(
        20, 20, 3, seed=0)
    t = lambda x: torch.as_tensor(x, device=cuda_device)  # noqa: E731
    args = [t(occ.reshape(-1)), t(origins), t(ref_i), t(mov_i), t(T)]
    bad = [(4, args[4].double()), (2, args[2].int()), (4, args[4][:, :2]),
           (0, args[0].cpu()), (0, t(np.repeat(occ.reshape(-1), 2))[::2])]
    for k, x in bad:
        a = list(args)
        a[k] = x
        with pytest.raises(ValueError):
            cuda_kernels.overlap_score(*a, 20, 20, res)
    before = cuda_kernels.LAUNCHES["overlap_score"]
    cuda_kernels.overlap_score(*args, 20, 20, res)
    assert cuda_kernels.LAUNCHES["overlap_score"] == before + 1


def _feature_inputs(dev, scans=slice(0, 8)):
    from ndt_feature_graph_tpu_torch.features import descriptor, detector

    with np.load(chip_smoke.FIXTURE) as f:
        fx = dict(f)
    sp = chip_smoke.canonical_slam_params(float(fx["split_m"]),
                                          int(fx["max_nodes"]))
    fp = sp.fuser.features
    r = torch.as_tensor(fx["ranges"][scans], device=dev)
    h = torch.as_tensor(fx["hit"][scans], device=dev)
    u = torch.as_tensor(fx["ransac_u"][scans], device=dev)
    feats = detector._detect_plain(fp, r, h)
    desc = descriptor._describe_plain(fp, feats, r, h)
    return sp, fp, r, h, u, feats, desc


@pytest.mark.cuda
def test_detect_features_matches_plain(cuda_device):
    """The detector kernel on canonical scans against its plain twin
    (chip_smoke.compare_detect's tolerances), a scan alone = its row,
    one launch a call, the same bits on repeat."""
    from ndt_feature_graph_tpu_torch.features import detector

    _, fp, r, h, _, want, _ = _feature_inputs(cuda_device)
    before = cuda_kernels.LAUNCHES["detect_features"]
    got = detector.detect(fp, r, h)
    again = detector.detect(fp, r, h)
    one = detector.detect(fp, r[3], h[3])
    assert cuda_kernels.LAUNCHES["detect_features"] == before + 3
    chip_smoke.compare_detect("detect", got, want)
    for f in ("pts", "angles", "scales", "response", "mask"):
        assert torch.equal(getattr(got, f), getattr(again, f))
        assert torch.equal(getattr(one, f), getattr(got, f)[3])


@pytest.mark.cuda
@pytest.mark.parametrize("stat", ["beta_mean", "hitmiss"])
def test_describe_features_matches_plain(cuda_device, stat):
    import dataclasses

    from ndt_feature_graph_tpu_torch.features import descriptor

    _, fp, r, h, _, feats, _ = _feature_inputs(cuda_device)
    fp = dataclasses.replace(fp, descriptor_stat=stat)
    got = descriptor.describe(fp, feats, r, h)
    chip_smoke.compare_desc(f"describe {stat}", got,
                            descriptor._describe_plain(fp, feats, r, h))
    assert torch.equal(got, descriptor.describe(fp, feats, r, h))


@pytest.mark.cuda
@pytest.mark.parametrize("threads", chip_smoke.DESCRIBE_THREADS)
def test_describe_features_bits_at_every_block_size(cuda_device, threads):
    """The descriptor kernel with 128 to 1,024 threads a feature: the
    wrapper's own choice's bits, batched, scan by scan and with the
    hitmiss statistic; one launch a call."""
    import dataclasses

    from ndt_feature_graph_tpu_torch.features import descriptor

    _, fp, r, h, _, feats, _ = _feature_inputs(cuda_device)
    hm = dataclasses.replace(fp, descriptor_stat="hitmiss")
    own = descriptor.describe(fp, feats, r, h)
    own_hm = descriptor.describe(hm, feats, r, h)
    rule = cuda_kernels.describe_threads
    cuda_kernels.describe_threads = lambda *_: threads
    try:
        before = cuda_kernels.LAUNCHES["describe_features"]
        got = descriptor.describe(fp, feats, r, h)
        got_hm = descriptor.describe(hm, feats, r, h)
        one = descriptor.describe(fp, chip_smoke.feature_rows(feats, 5),
                                  r[5], h[5])
        assert cuda_kernels.LAUNCHES["describe_features"] == before + 3
    finally:
        cuda_kernels.describe_threads = rule
    assert torch.equal(got, own) and torch.equal(got_hm, own_hm)
    assert torch.equal(one, own[5])


@pytest.mark.cuda
@pytest.mark.parametrize("adaptive", [False, True])
def test_match_features_matches_plain(cuda_device, adaptive):
    """Consecutive canonical pairs, batched, against the plain twin; the
    gated call's pseudo-cells against the plain gate."""
    import dataclasses

    from ndt_feature_graph_tpu_torch.features import ransac

    _, fp, _, _, u, feats, desc = _feature_inputs(cuda_device)
    fp = dataclasses.replace(fp, ransac_adaptive=adaptive)
    ref = chip_smoke.feature_rows(feats, slice(0, 7))
    mov = chip_smoke.feature_rows(feats, slice(1, 8))
    inputs = (ref, desc[:7], mov, desc[1:])
    got = ransac.match_sets(fp, *inputs, u[:7])
    want = ransac._match_sets_plain(fp, *inputs, u[:7])
    chip_smoke.compare_match("match", fp, got, want, inputs)
    gate = ransac.OdometryGate(
        sensor_pose=torch.zeros(3, device=cuda_device), motion=want.T,
        prev_pose=torch.zeros(7, 3, device=cuda_device),
        max_translation=0.1, max_rotation=0.19634954084936207, check=True,
        cov_xy=2e-4)
    res, src, tgt = ransac.match_sets_gated(fp, *inputs, u[:7], gate)
    chip_smoke.compare_gate("gate", (src, tgt),
                            ransac._gate_plain(want, ref, mov, gate))
    assert torch.equal(res.T, got.T)


@pytest.mark.cuda
def test_feature_kernels_refuse_what_they_do_not_take(cuda_device):
    """Nine scales, 65 bins, a float64 scan and a scan of the wrong
    width raise ValueError (no plain version on the card)."""
    import dataclasses

    from ndt_feature_graph_tpu_torch.features import descriptor, detector

    _, fp, r, h, _, feats, _ = _feature_inputs(cuda_device)
    with pytest.raises(ValueError):
        detector.detect(dataclasses.replace(fp, num_scales=9), r, h)
    with pytest.raises(ValueError):
        detector.detect(fp, r.double(), h)
    with pytest.raises(ValueError):
        detector.detect(fp, r[:, :700], h[:, :700])
    with pytest.raises(ValueError):
        descriptor.describe(dataclasses.replace(fp, rho_bins=5, phi_bins=13),
                            feats, r, h)


@pytest.mark.cuda
def test_feature_fuser_front_end_is_three_launches(cuda_device):
    """One full-pipeline scan update on the card: the detector, the
    descriptor and the matcher with its gate, one launch each."""
    from ndt_feature_graph_tpu_torch.fusion import feature_fuser

    sp, fp, r, h, u, _, _ = _feature_inputs(cuda_device)
    state = feature_fuser.initialize(sp.fuser, torch.zeros(3, device=r.device),
                                     torch.zeros(3, device=r.device), r[0],
                                     h[0])
    cuda_kernels.reset_launch_counts()
    feature_fuser._prepare_features(state, sp.fuser,
                                    torch.zeros(3, device=r.device), r[1],
                                    h[1], u[0])
    assert {k: cuda_kernels.LAUNCHES[k] for k in chip_smoke.FEATURE_ENTRIES} \
        == {k: 1 for k in chip_smoke.FEATURE_ENTRIES}
    assert sum(cuda_kernels.LAUNCHES.values()) == 3


@pytest.mark.cuda
def test_detect_features_same_bits_at_every_cluster_size(cuda_device):
    """The 200 canonical scans in calls of 1, 32, 64, 100 and 200 scans
    (8, 4, 2, 1 and 1 blocks a scan on an H100): every scan, its arc and
    its smoothed points equal their rows of the one-call batch, and the
    plain twin's arc and smoothed points bit for bit."""
    from ndt_feature_graph_tpu_torch.features import detector

    _, fp, r, h, _, _, _ = _feature_inputs(cuda_device, slice(0, 200))
    n = r.shape[0]
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    want = cuda_kernels.detect_features(fp, r, h, intermediates=True)
    _, arc_t, _, sms_t = detector._smoothing_plain(fp, r, h)
    assert torch.equal(want[1], arc_t)
    assert torch.equal(want[2], torch.stack(sms_t, -3))
    clusters = set()
    for m in (1, 32, 64, 100):
        clusters.add(cuda_kernels.detect_cluster(m, sms))
        parts = [cuda_kernels.detect_features(fp, r[i:i + m], h[i:i + m],
                                              intermediates=True)
                 for i in range(0, n, m)]
        for f in ("pts", "angles", "scales", "response", "mask"):
            assert torch.equal(torch.cat([getattr(p[0], f) for p in parts]),
                               getattr(want[0], f)), (m, f)
        assert torch.equal(torch.cat([p[1] for p in parts]), want[1]), m
        assert torch.equal(torch.cat([p[2] for p in parts]), want[2]), m
    assert len(clusters | {cuda_kernels.detect_cluster(n, sms)}) >= 3


@pytest.mark.cuda
def test_match_features_same_bits_at_every_cluster_size(cuda_device):
    """The 199 canonical pairs in calls of 1, 20, 40 and 199 pairs (4, 4,
    2 and 1 blocks a pair on an H100), gated and not: every pair equal to
    its row of the one-call batch."""
    import dataclasses

    from ndt_feature_graph_tpu_torch.features import ransac

    _, fp, _, _, u, feats, desc = _feature_inputs(cuda_device,
                                                  slice(0, 200))
    n = desc.shape[0]
    rows = lambda a, b: chip_smoke.feature_rows(feats, slice(a, b))  # noqa
    gate = ransac.OdometryGate(
        sensor_pose=torch.tensor([0.1, -0.05, 0.02], device=cuda_device),
        motion=torch.zeros(n - 1, 3, device=cuda_device),
        prev_pose=torch.zeros(n - 1, 3, device=cuda_device),
        max_translation=0.1, max_rotation=0.19634954084936207, check=True,
        cov_xy=2e-4)
    want = ransac.match_sets_gated(fp, rows(0, n - 1), desc[:-1],
                                   rows(1, n), desc[1:], u[:n - 1], gate)
    for m in (1, 20, 40):
        parts = []
        for i in range(0, n - 1, m):
            j = min(i + m, n - 1)
            g = dataclasses.replace(gate, motion=gate.motion[i:j],
                                    prev_pose=gate.prev_pose[i:j])
            parts.append(ransac.match_sets_gated(
                fp, rows(i, j), desc[i:j], rows(i + 1, j + 1),
                desc[i + 1:j + 1], u[i:j], g))
        for f in dataclasses.fields(ransac.MatchResult):
            assert torch.equal(torch.cat([getattr(p[0], f.name)
                                          for p in parts]),
                               getattr(want[0], f.name)), (m, f.name)
        for k in (1, 2):
            for f in ("means", "covs", "mask"):
                assert torch.equal(torch.cat([getattr(p[k], f)
                                              for p in parts]),
                                   getattr(want[k], f)), (m, k, f)


def _lc_links(dev):
    """The LC bank's 171 candidate links under their RANSAC poses
    (chip_smoke.link_bank, compute_links_batch) and the link solve's
    arguments at the bank's source-cell budget."""
    from ndt_feature_graph_tpu_torch.graph import links as links_mod
    lc = dict(np.load(chip_smoke.LC_FIXTURE))
    sp, _, stacked, ref_i, mov_i, u = chip_smoke.link_bank(lc, dev)
    ones = torch.ones(ref_i.shape[0], dtype=torch.bool, device=dev)
    ls = links_mod.compute_links_batch(sp.fuser.features,
                                       sp.fuser.ndt.resolution, stacked,
                                       ref_i, mov_i, ones, u)
    return stacked, ls, chip_smoke.refine_args(
        sp.fuser.ndt, sp.fuser.matcher, stacked, ls,
        links_mod.source_cell_budget(stacked))


@pytest.mark.cuda
@pytest.mark.parametrize("lane", [0, 9, 85, 170])
def test_link_refined_alone_is_its_row_of_the_batch(cuda_device, lane):
    """A link of the LC bank's 171 solved alone in the link solve (one
    lane, so one cluster) keeps the bits of its row of the 171-lane
    launch (45-odd persistent clusters taking lanes from the counter): d,
    score, trials, converged and the Hessian.  Two launches give the
    same bits, and the lane counter is left zero."""
    _, _, sargs = _lc_links(cuda_device)
    T0, src, packed, origins, offs, h, w, res, m = sargs
    n = T0.shape[0]
    zero = torch.zeros((n, 3), device=cuda_device)
    batch = cuda_kernels.newton_solve_batch(zero, *sargs, with_hessian=True)
    again = cuda_kernels.newton_solve_batch(zero, *sargs, with_hessian=True)
    assert all(torch.equal(a, b) for a, b in zip(batch, again))
    one = CellList(*(x[lane:lane + 1] for x in (src.means, src.covs,
                                                 src.mask)))
    alone = cuda_kernels.newton_solve_batch(
        zero[:1], T0[lane:lane + 1], one, packed, origins[lane:lane + 1],
        offs[lane:lane + 1], h, w, res, m, with_hessian=True)
    for a, b in zip(alone, batch):
        assert torch.equal(a[0], b[lane])
    torch.cuda.synchronize()
    for q in cuda_kernels._LINK_QUEUES.values():
        assert q.tolist() == [0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("group", [0, 1, 2, 4, 8])
@pytest.mark.parametrize("n_pairs", [1, 4, 171, 1024])
def test_overlap_paths_are_the_mirror_on_the_lc_bank(cuda_device, n_pairs,
                                                     group):
    """`overlap_score` on the LC bank's candidate pairs under their
    RANSAC poses (the 171 repeated to 1,024) on the pair path (group 0)
    and the group path at 1, 2, 4 and 8 pairs a group, and by the size
    rule: every score and count equal to overlap_mirror (the pair path's order)
    with the card's transcendentals, bit for bit."""
    stacked, ls, _ = _lc_links(cuda_device)
    h, w = stacked.occ.shape[1:]
    idx = torch.arange(n_pairs, device=cuda_device) % ls.ref.shape[0]
    r, mv = ls.ref[idx].contiguous(), ls.mov[idx].contiguous()
    T = ls.T[idx].contiguous()
    occ, origins = stacked.occ.reshape(-1), stacked.occ_origin
    res = 0.5
    m_score, m_nb, _ = chip_smoke.overlap_mirror(
        stacked.occ.reshape(-1, h * w).cpu().numpy(), origins.cpu().numpy(),
        r.cpu().numpy(), mv.cpu().numpy(), T.cpu().numpy(), h, w, res,
        fns=chip_smoke.torch_transcendentals(cuda_device))
    runs = [cuda_kernels.overlap_score(occ, origins, r, mv, T, h, w, res)]
    with chip_smoke.overlap_group_forced(group):
        runs.append(cuda_kernels.overlap_score(occ, origins, r, mv, T, h, w,
                                               res))
    for score, nb in runs:
        assert np.array_equal(score.cpu().numpy().view(np.uint32),
                              m_score.view(np.uint32))
        assert np.array_equal(nb.cpu().numpy(), m_nb)


@pytest.mark.cuda
@pytest.mark.parametrize("edge", [None, "no overlap", "out of bounds",
                                  "thresholds"])
@pytest.mark.parametrize("group", [1, 2, 8])
def test_overlap_group_path_is_the_mirror_on_edge_cases(cuda_device, group,
                                                        edge):
    """The group path against the mirror on chip_smoke.overlap_case's
    random banks of 40 x 40 and 37 x 53 cells (24 pairs), with their edge
    cases, and with moving and reference indices outside the bank (NaN
    and -1 for those pairs, as on the pair path)."""
    for h, w in ((40, 40), (37, 53)):
        occ, origins, ref_i, mov_i, T, res = chip_smoke.overlap_case(
            h, w, 24, h + group, edge)
        ref_i, mov_i = ref_i.copy(), mov_i.copy()
        ref_i[3], mov_i[5], mov_i[6] = 99, -1, occ.shape[0]
        t = lambda x: torch.as_tensor(x, device=cuda_device)  # noqa: E731
        args = (t(occ).reshape(-1), t(origins), t(ref_i), t(mov_i), t(T), h,
                w, res)
        with chip_smoke.overlap_group_forced(0):
            pair = cuda_kernels.overlap_score(*args)
        with chip_smoke.overlap_group_forced(group):
            got = cuda_kernels.overlap_score(*args)
        assert torch.equal(got[1], pair[1])
        assert np.array_equal(got[0].cpu().numpy().view(np.uint32),
                              pair[0].cpu().numpy().view(np.uint32))
        assert [int(pair[1][k]) for k in (3, 5, 6)] == [-1, -1, -1]
        ok = np.ones(24, bool)
        ok[[3, 5, 6]] = False
        m_score, m_nb, _ = chip_smoke.overlap_mirror(
            occ, origins, ref_i[ok], mov_i[ok], T[ok], h, w, res,
            fns=chip_smoke.torch_transcendentals(cuda_device))
        assert np.array_equal(got[0].cpu().numpy()[ok].view(np.uint32),
                              m_score.view(np.uint32))
        assert np.array_equal(got[1].cpu().numpy()[ok], m_nb)
