"""The port's simulator (io/dataset.py worlds, trajectories, raycast,
simulate_sequence, save_sequence; io/eval_sim.py; the fleet's simulated
stream) against the JAX package's on the CPU.

Tolerances: the worlds, trajectories and eval_sim's sequences are numpy
in both packages, so they are equal bit for bit.  The raycast takes an
ulp of sin / cos differently in each framework, so a simulated scan is
held to the reference's ranges within 2e-5 m and its hit flags exactly,
on every beam but the grazing and the oblique ones (chip_smoke.
grazing_beams, a float64 recomputation: a grazing beam passes within 1e-5
of a segment's end, has its two nearest hits within 1e-4 m or its hit
within 1e-4 m of the range limit; an oblique beam meets its segment so
obliquely that two ulps of its float32 angle move its range beyond
2e-5 m — the frameworks' linspace differs by an ulp at a few beams a
scan); every differing beam must be one of them, and under 0.1% may
differ.
With the reference's own draws (replayed from its key) simulate_sequence
gives its ground truth exactly and its odometry within 1e-6.  Draws from
a torch.Generator are held by their spread: the residuals' standard
deviation within 10% of the noise levels.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_feature_graph_tpu.config import (
    FeatureParams, FuserParams, NDTMapParams,
)
from ndt_feature_graph_tpu.core import se2 as jse2
from ndt_feature_graph_tpu.io import carmen as jcarmen
from ndt_feature_graph_tpu.io import dataset as jds
from ndt_feature_graph_tpu.io import eval_sim as jeval
from ndt_feature_graph_tpu.parallel import scaling as jscaling
from ndt_feature_graph_tpu_torch import interop
from ndt_feature_graph_tpu_torch.core import se2
from ndt_feature_graph_tpu_torch.graph.node import map_tensors
from ndt_feature_graph_tpu_torch.io import dataset as tds
from ndt_feature_graph_tpu_torch.io import eval_sim as teval
from ndt_feature_graph_tpu_torch.parallel import scaling as tscaling

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


chip_smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
fixture_gen = _load("make_torch_port_fixture",
                    ROOT / "examples" / "make_torch_port_fixture.py")
CPU = "cpu"

_WORLDS = {
    "default": (jds.default_world, tds.default_world, ()),
    "warehouse": (jds.warehouse_world, tds.warehouse_world, ()),
    "random": (jds.random_world, tds.random_world, (5,)),
}
_TRAJS = {
    "loop": (jds.loop_trajectory, tds.loop_trajectory, (37,),
             {"radius": 4.0}),
    "multi_loop": (jds.multi_loop_trajectory, tds.multi_loop_trajectory,
                   (3, 50), {"radius": 2.8}),
    "corridor": (jds.corridor_trajectory, tds.corridor_trajectory, (60,),
                 {"x0": -2.5, "x1": 2.5}),
}


@pytest.mark.parametrize("name", sorted(_WORLDS))
def test_worlds_equal_jax_bit_for_bit(name):
    jf, tf, args = _WORLDS[name]
    got = tf(*args, device=CPU)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jf(*args)))


@pytest.mark.parametrize("name", sorted(_TRAJS))
def test_trajectories_equal_jax_bit_for_bit(name):
    jf, tf, args, kw = _TRAJS[name]
    got = tf(*args, **kw, device=CPU)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jf(*args, **kw)))


@pytest.mark.parametrize("seed", [0, 3])
def test_random_loop_scenario_equals_jax(seed):
    jw, jt = jds.random_loop_scenario(seed, n_steps=40)
    tw, tt = tds.random_loop_scenario(seed, n_steps=40, device=CPU)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_random_world_keepout_equals_jax():
    keep = np.stack([np.linspace(-5, 5, 30), np.zeros(30)], -1)
    np.testing.assert_array_equal(
        tds.random_world(2, keepout=keep, clearance=1.2,
                         device=CPU).numpy(),
        np.asarray(jds.random_world(2, keepout=keep, clearance=1.2)))


def test_eval_sim_equals_jax_bit_for_bit():
    j = jeval.simulate(4, n_steps=24, num_beams=180)
    t = teval.simulate(4, n_steps=24, num_beams=180, device=CPU)
    for k in ("ranges", "hit", "odom", "gt"):
        got, want = getattr(t, k).numpy(), np.asarray(getattr(j, k))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _scenes():
    """(world, trajectory) pairs: the default room around its loop (the
    pillars' corners), a loop through the warehouse's shelf rows, a
    random world."""
    rw, rt = jds.random_loop_scenario(3, n_steps=40)
    return {
        "default_loop": (jds.default_world(),
                         jds.loop_trajectory(40, radius=4.5)),
        "warehouse": (jds.warehouse_world(),
                      jds.loop_trajectory(40, radius=9.0, center=(0, 0.3))),
        "random": (rw, rt),
    }


def _jax_raycast(world, traj, nb, max_range):
    r, h = jax.vmap(lambda p: jds.raycast(world, p, nb, max_range))(traj)
    return np.asarray(r), np.asarray(h)


@pytest.mark.parametrize("max_range", [8.0, 30.0])
@pytest.mark.parametrize("scene", ["default_loop", "warehouse", "random"])
def test_raycast_matches_jax_but_grazing_beams(scene, max_range,
                                               monkeypatch):
    world, traj = _scenes()[scene]
    nb = 360
    jr, jh = _jax_raycast(world, traj, nb, max_range)
    monkeypatch.setattr(tds, "RAYCAST_CHUNK", 7)   # several chunks
    tr, th = tds.raycast(torch.tensor(np.asarray(world)),
                         torch.tensor(np.asarray(traj)), nb, max_range)
    graze = chip_smoke.grazing_beams(np.asarray(world), np.asarray(traj), nb,
                                     max_range)
    chip_smoke.check_beams(scene, tr, th, jr, jh, graze)
    # One pose at a time gives the batch's rows.
    r5, h5 = tds.raycast(torch.tensor(np.asarray(world)),
                         torch.tensor(np.asarray(traj[5])), nb, max_range)
    assert torch.equal(r5, tr[5]) and torch.equal(h5, th[5])


def test_raycast_at_a_constant_heading_differs_where_linspace_does():
    """Along the warehouse's shelf corridor at a constant heading, the
    same beams meet the shelves obliquely at every pose.  Every beam that
    differs from the reference grazes, or is oblique with a float32 angle
    that differs from the reference's pose + linspace by an ulp."""
    world = jds.warehouse_world()
    traj = jds.corridor_trajectory(40, x0=-12, x1=12, y=-0.7)
    nb = 360
    jr, jh = _jax_raycast(world, traj, nb, 30.0)
    tr, th = tds.raycast(torch.tensor(np.asarray(world)),
                         torch.tensor(np.asarray(traj)), nb, 30.0)
    kind = chip_smoke.grazing_beams(np.asarray(world), np.asarray(traj), nb,
                                    30.0)
    jang = np.asarray(jax.vmap(lambda p: p[2] + jnp.linspace(
        -jnp.pi, jnp.pi, nb, endpoint=False))(traj))
    tang = (torch.tensor(np.asarray(traj))[:, 2:3]
            + tds.beam_angles(nb, device=CPU)).numpy()
    differ = (th.numpy() != jh) | (np.abs(tr.numpy() - jr)
                                   > chip_smoke.RANGE_TOL)
    explained = (kind == 1) | ((kind == 2) & (jang != tang))
    assert differ.any() and not (differ & ~explained).any()


def test_grazing_rule_names_a_pillar_corner_and_an_oblique_wall():
    """A beam aimed at a pillar's corner grazes; one at the middle of its
    face does neither; one meeting a long wall at 2 degrees, 5.7 m away,
    is oblique."""
    world = jds.default_world()
    corner = np.array([-6.0, -2.0])              # a corner of the pillar
    face = np.array([-6.0, -2.5])                # the middle of its face
    nb = 720
    ang = np.asarray(tds.beam_angles(nb, device=CPU), np.float64)
    out = []
    for target in (corner, face):
        origin = np.array([-2.0, -1.0])
        heading = np.arctan2(*(target - origin)[::-1]) - ang[100]
        pose = np.array([*origin, heading], np.float32)
        out.append(int(chip_smoke.grazing_beams(np.asarray(world), pose, nb,
                                                30.0)[100]))
    heading = np.float32(np.pi + np.radians(2.0) - ang[100])
    pose = np.array([9.5, -6.8, heading], np.float32)
    out.append(int(chip_smoke.grazing_beams(np.asarray(world), pose, nb,
                                            30.0)[100]))
    assert out == [1, 0, 2]


def _replayed(key, traj, nb):
    return fixture_gen.simulator_draws(key, traj.shape[0], nb)


@pytest.mark.parametrize("scene", ["default_loop", "random"])
def test_simulate_sequence_with_jax_draws_matches_jax(scene):
    world, traj = _scenes()[scene]
    nb, key = 360, jax.random.PRNGKey(7)
    js = jds.simulate_sequence(key, traj, num_beams=nb, max_range=15.0,
                               segments=world)
    ru, ou = _replayed(key, traj, nb)
    ts = tds.simulate_sequence(torch.tensor(np.asarray(traj)), nb, 15.0,
                               segments=torch.tensor(np.asarray(world)),
                               range_draws=torch.tensor(ru),
                               odom_draws=torch.tensor(ou), device=CPU)
    np.testing.assert_array_equal(ts.gt.numpy(), np.asarray(js.gt))
    np.testing.assert_allclose(ts.odom.numpy(), np.asarray(js.odom), rtol=0,
                               atol=chip_smoke.ODOM_TOL)
    graze = chip_smoke.grazing_beams(np.asarray(world), np.asarray(traj), nb,
                                     15.0)
    chip_smoke.check_beams(scene, ts.ranges, ts.hit, np.asarray(js.ranges),
                           np.asarray(js.hit), graze)


def test_simulate_sequence_generator_noise_has_the_stated_spread():
    traj = tds.corridor_trajectory(400, x0=-8.0, x1=8.0, device=CPU)
    nb, noise = 90, (0.01, 0.02, 0.004)
    gen = torch.Generator(CPU)
    gen.manual_seed(3)
    seq = tds.simulate_sequence(traj, nb, 30.0, range_noise=0.05,
                                odom_noise=noise, generator=gen, device=CPU)
    clean, hit = tds.raycast(tds.default_world(CPU), traj, nb, 30.0)
    assert torch.equal(seq.hit, hit) and bool(hit.any())
    res = (seq.ranges - clean)[hit]
    assert abs(float(res.std()) / 0.05 - 1) < 0.1
    assert torch.equal(seq.ranges[~hit], clean[~hit])
    odom_res = seq.odom[1:] - se2.sub(traj[:-1], traj[1:])
    for k in range(3):
        assert abs(float(odom_res[:, k].std()) / noise[k] - 1) < 0.1
    # The same seed gives the same sequence; the draws are a must.
    gen.manual_seed(3)
    again = tds.simulate_sequence(traj, nb, 30.0, range_noise=0.05,
                                  odom_noise=noise, generator=gen,
                                  device=CPU)
    assert torch.equal(again.ranges, seq.ranges)
    with pytest.raises(ValueError, match="Generator"):
        tds.simulate_sequence(traj, nb, 30.0, device=CPU)


def test_save_sequence_loads_in_jax(tmp_path):
    traj = tds.loop_trajectory(12, device=CPU)
    gen = torch.Generator(CPU)
    gen.manual_seed(0)
    seq = tds.simulate_sequence(traj, 90, 15.0, generator=gen, device=CPU)
    tds.save_sequence(tmp_path / "s.npz", seq)
    back = jds.load_sequence(tmp_path / "s.npz")
    for k in ("ranges", "hit", "odom", "gt"):
        np.testing.assert_array_equal(np.asarray(getattr(back, k)),
                                      getattr(seq, k).numpy())


def test_simulator_replays_canonical_record():
    """bench.make_sequence()'s 200 x 720 corridor from the recorded JAX
    draws (data/canonical_io.npz) equals canonical_200.npz under the
    grazing rule (chip_smoke phase 12a, here on the CPU)."""
    io = np.load(ROOT / "ndt_feature_graph_tpu_torch/data/canonical_io.npz")
    fx = np.load(chip_smoke.FIXTURE)
    traj = tds.corridor_trajectory(200, x0=-2.5, x1=2.5, y=-4.5, device=CPU)
    np.testing.assert_array_equal(traj.numpy(), fx["gt"])
    seq = tds.simulate_sequence(traj, 720, 30.0,
                                range_draws=torch.tensor(io["range_u"]),
                                odom_draws=torch.tensor(io["odom_u"]),
                                device=CPU)
    np.testing.assert_array_equal(seq.gt.numpy(), fx["gt"])
    np.testing.assert_allclose(seq.odom.numpy(), fx["odom"], rtol=0,
                               atol=chip_smoke.ODOM_TOL)
    graze = chip_smoke.grazing_beams(tds.default_world(CPU), traj, 720, 30.0)
    chip_smoke.check_beams("canonical", seq.ranges, seq.hit, fx["ranges"],
                           fx["hit"], graze)


@pytest.mark.parametrize("features", [False, True])
def test_fleet_inputs_without_a_sequence_have_jax_shapes(features):
    mp = NDTMapParams(resolution=0.5, size_x=40.0, size_y=40.0,
                      sensor_range=15.0, max_points_per_scan=360,
                      max_cells=512)
    jp = FuserParams(ndt=mp, features=FeatureParams(num_beams=360,
                                                    max_range=15.0))
    tp = interop.params_from_jax(jp)
    kw = dict(t_steps=5, num_beams=360, seed=0)
    build = ("build_fleet_feature_inputs" if features
             else "build_fleet_inputs")
    jout = getattr(jscaling, build)(jp, 3, **kw)
    tout = getattr(tscaling, build)(tp, None, 3, **kw, device=CPU)
    for j, t in zip(jout[1:], tout[1:]):
        assert tuple(t.shape) == tuple(np.shape(j))
    # The JAX states carried into the port's dataclasses have the port's
    # states' shapes, field by field (the port's state has no PRNG key).
    jstate = (interop.feature_fuser_state_from_jax if features
              else interop.fuser_state_from_jax)(
        jax.tree.map(lambda x: np.asarray(x)[0], jout[0]), device=CPU)
    shapes = []
    map_tensors(lambda a, b: shapes.append((tuple(a.shape),
                                            (3,) + tuple(b.shape))),
                tout[0], jstate)
    assert len(shapes) >= 8 and all(a == b for a, b in shapes)


def test_identity_and_pose_helpers_match_jax():
    rng = np.random.default_rng(0)
    p = rng.normal(size=(5, 3)).astype(np.float32)
    tp = torch.tensor(p)
    np.testing.assert_array_equal(se2.identity((2,)).numpy(),
                                  np.asarray(jse2.identity((2,))))
    np.testing.assert_allclose(se2.to_tum(torch.arange(5.0), tp).numpy(),
                               np.asarray(jse2.to_tum(jnp.arange(5.0),
                                                      jnp.asarray(p))),
                               rtol=0, atol=1e-6)


def test_simulator_and_readers_default_to_the_card(tmp_path):
    """Without `device` the worlds, trajectories, the simulator and the
    readers put their tensors on the CUDA card, and raise without one;
    `cli simulate` asks for the card unless --device cpu."""
    from ndt_feature_graph_tpu_torch import cli as tcli
    from ndt_feature_graph_tpu_torch.io import carmen

    jcarmen.write_carmen(str(tmp_path / "x.clf"), jds.simulate_sequence(
        jax.random.PRNGKey(0), jds.loop_trajectory(4), num_beams=90,
        max_range=15.0), max_range=15.0)
    calls = (lambda: tds.default_world(), lambda: tds.loop_trajectory(5),
             lambda: teval.simulate(0, n_steps=8, num_beams=90),
             lambda: carmen.read_carmen_sequence(tmp_path / "x.clf"))
    if torch.cuda.is_available():
        for call in calls:
            out = call()
            t = out if isinstance(out, torch.Tensor) else out.ranges
            assert t.device.type == "cuda"
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["simulate", "--out", str(tmp_path / "s.npz")])
