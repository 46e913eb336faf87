"""The replay of the JAX key chain (examples/make_torch_port_fixture.py)
against the keys a JAX run really takes, and the committed
loop-closure record (data/canonical_lc.npz) against the replay.

A recording subclass of the JAX NDTFeatureGraphSLAM logs every key its
`_split_key` hands out.  On the 28-scan loop of test_torch_slam.py with
online loop closure and a chunked offline proposal, the replayed keys —
the fuser keys of the scans, one per online proposal, one per offline
chunk, and the SLAM key left at the end — must equal the logged ones
bit for bit, and the replayed pair draws must equal the uniforms the
reference's `ransac.match_sets` draws under each pair key.  Exact
equality throughout: it is the same PRNG on the same keys.
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np

from ndt_feature_graph_tpu.config import (
    FeatureParams, FuserParams, GraphParams, NDTMapParams, SLAMParams,
)
from ndt_feature_graph_tpu.io import dataset as jds

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


fixture_gen = _load("make_torch_port_fixture",
                    ROOT / "examples" / "make_torch_port_fixture.py")
chip_smoke = _load("chip_smoke", ROOT / "chip_smoke.py")

PARAMS = SLAMParams(
    fuser=FuserParams(
        ndt=NDTMapParams(resolution=0.5, size_x=40.0, size_y=40.0,
                         sensor_range=15.0, max_points_per_scan=360,
                         max_cells=512),
        features=FeatureParams(num_beams=360, max_range=15.0),
    ),
    graph=GraphParams(new_node_transl_dist=3.0, max_nodes=16,
                      online_loop_closure=True, valid_min_idx_dist=1,
                      online_lc_candidate_dist=20.0, link_batch_size=8),
)


@functools.lru_cache(maxsize=None)
def _recorded_run():
    traj = jds.loop_trajectory(28, radius=5.0)
    seq = jax.tree.map(np.asarray, jds.simulate_sequence(
        jax.random.PRNGKey(11), traj, num_beams=360, max_range=15.0))
    slam = fixture_gen.recording_slam_class()(PARAMS, seed=0)
    slam.initialize(jnp.asarray(seq.gt[0]), jnp.zeros(3),
                    jnp.asarray(seq.ranges[0]), jnp.asarray(seq.hit[0]))
    slam.run_sequence_chunked(seq.odom, jnp.asarray(seq.ranges),
                              jnp.asarray(seq.hit), chunk=8)
    fuser_key = np.asarray(slam.state.key)
    slam.finalize_current_node()
    n_pairs = int(np.asarray(slam.candidate_pairs()[2]).sum())
    slam.optimize_offline()
    rep = fixture_gen.replay_ransac_draws(
        0, seq.odom, PARAMS,
        lc_splits=fixture_gen.lc_splits_of(slam.key_log),
        pair_counts=fixture_gen.offline_pair_counts(
            n_pairs, PARAMS.graph.link_batch_size))
    return slam, fuser_key, n_pairs, rep


def test_replayed_keys_match_a_recorded_run():
    slam, fuser_key, n_pairs, rep = _recorded_run()
    names = [n for n, _ in slam.key_log]
    n_lc = names.count("_try_online_loop_closure")
    n_chunks = names.count("run")
    assert n_lc >= 2 and n_chunks == -(-n_pairs // 8) >= 2
    logged = [k for n, k in slam.key_log
              if n in ("_try_online_loop_closure", "run")]
    assert len(rep.pair_keys) == len(logged) == n_lc + n_chunks
    for a, b in zip(rep.pair_keys, logged):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(rep.fuser_keys[-1], fuser_key)
    np.testing.assert_array_equal(rep.key, np.asarray(slam._key))
    assert [u.shape[0] for u in rep.pair_u] == (
        [PARAMS.graph.online_lc_max_candidates] * n_lc + [8] * n_chunks)


def test_replayed_pair_draws_equal_jax_uniforms():
    """Each row of a proposal's draws is what ransac.match_sets draws
    (ransac.py:117-118) under that pair's key of compute_links_batch's
    split (links.py:158), drawn here one key at a time."""
    _, _, _, rep = _recorded_run()
    m_hyp = PARAMS.fuser.features.ransac_hypotheses
    for key, u in zip(rep.pair_keys, rep.pair_u):
        keys = jax.random.split(jnp.asarray(key), u.shape[0])
        for p in (0, u.shape[0] - 1):
            ki, _ = jax.random.split(keys[p])
            np.testing.assert_array_equal(
                u[p], np.asarray(jax.random.uniform(ki, (m_hyp, 2))))


def test_canonical_lc_record_replays():
    """The committed record holds the replay of its own runs, at the
    parameters chip_smoke.py runs."""
    with np.load(chip_smoke.LC_FIXTURE) as f:
        lc = dict(f)
    with np.load(chip_smoke.FIXTURE) as f:
        fx = dict(f)
    sp_off = chip_smoke.canonical_slam_params(chip_smoke.OFFLINE_SPLIT_M, 64)
    sp_on = chip_smoke.canonical_slam_params(2.0, 64, **chip_smoke.LC_GRAPH)
    assert repr(sp_off) == str(lc["off_params_repr"])
    assert repr(sp_on) == str(lc["on_params_repr"])
    from ndt_feature_graph_tpu_torch.pipeline import gate_scans

    _, acc = gate_scans(fx["odom"], sp_off.min_incr_dist,
                        sp_off.min_incr_rot)
    odom_g = np.concatenate([np.zeros((1, 3), np.float32), np.stack(acc)])
    n_pairs = lc["off_link_ref"].shape[0]
    off = fixture_gen.replay_ransac_draws(0, odom_g, sp_off,
                                          pair_counts=[n_pairs])
    np.testing.assert_array_equal(lc["off_scan_u"], off.scan_u)
    np.testing.assert_array_equal(lc["off_pair_u"][0], off.pair_u[0])
    assert lc["off_node_T"].shape[0] == lc["off_node_scan"].shape[0]
    on = fixture_gen.replay_ransac_draws(
        0, fx["odom"], sp_on, lc_splits=list(lc["on_lc_splits"]))
    np.testing.assert_array_equal(lc["on_scan_u"], on.scan_u)
    np.testing.assert_array_equal(lc["on_pair_u"], np.stack(on.pair_u))
    assert lc["on_traj"].shape == fx["traj"].shape


def test_canonical_io_record_replays_the_canonical_sequence():
    """The simulator record (data/canonical_io.npz): its range and
    odometry draws, put through the reference's simulate_sequence
    arithmetic on its own noise-free raycast, rebuild canonical_200.npz's
    sequence bit for bit; its raycast at the 64 poses of bench_offline_570's
    trajectory is the reference's; its P2D start is the composed
    odometry of scans 1-20."""
    from ndt_feature_graph_tpu.core import se2 as jse2

    with np.load(chip_smoke.IO_FIXTURE) as f:
        io = dict(f)
    with np.load(chip_smoke.FIXTURE) as f:
        fx = dict(f)
    t_steps, nb = fx["ranges"].shape
    traj = jds.corridor_trajectory(t_steps, x0=-2.5, x1=2.5, y=-4.5)
    world = jds.default_world()
    clean, hit = jax.vmap(lambda p: jds.raycast(world, p, nb, 30.0))(traj)
    ranges = clean + 0.01 * jnp.asarray(io["range_u"]) * hit
    rel = jse2.sub(traj[:-1], traj[1:])
    odom = jnp.concatenate([jnp.zeros((1, 3)), rel + jnp.asarray(
        io["odom_u"]) * jnp.asarray((0.01, 0.01, 0.004))], 0)
    for got, want in ((ranges, fx["ranges"]), (hit, fx["hit"]),
                      (odom, fx["odom"]), (traj, fx["gt"])):
        np.testing.assert_array_equal(np.asarray(got), want)
    ml = jds.multi_loop_trajectory(**{
        "n_loops": chip_smoke.ML570["n_loops"],
        "steps_per_loop": chip_smoke.ML570["steps_per_loop"],
        "radius": chip_smoke.ML570["radius"]})
    assert ml.shape[0] == 7040 and io["ray_idx"][-1] == 7039
    rr, rh = jax.vmap(lambda p: jds.raycast(world, p, nb, 30.0))(
        ml[io["ray_idx"]])
    np.testing.assert_array_equal(np.asarray(rr), io["ray_ranges"])
    np.testing.assert_array_equal(np.asarray(rh), io["ray_hit"])
    T = jnp.zeros(3)
    for t in range(1, chip_smoke.P2D_SOURCE + 1):
        T = jse2.compose(T, jnp.asarray(fx["odom"][t]))
    np.testing.assert_array_equal(np.asarray(T), io["p2d_T_init"])
    assert io["calib_scores"].shape == (343,) and io["p2d_converged"]
