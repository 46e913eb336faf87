"""The port's CLI on the inputs of this slice against the JAX CLI on the
same files, the port on the CPU (`--device cpu`): `simulate` (npz and
.bag) followed by `slam`, `slam` on a CARMEN log and on a bag that the
reference's writers made, and `calibrate`.

`slam` runs with the reference's RANSAC draws, replayed from its key
chain (examples/make_torch_port_fixture.py), on a 44-scan loop where the
reference is steady (tests/test_torch_cli.py).  Tolerances: trajectories
within 1 cm / 5 mrad, the same node counts; the calibrated extrinsic
equal within 1e-6 (its candidate is the reference's, the only one within
1e-5 of the best score); the simulated file loads in the reference's
readers, and its noise has the stated spread.
"""

import contextlib
import functools
import importlib.util
import io
import json
import pathlib
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from ndt_feature_graph_tpu import cli as jcli
from ndt_feature_graph_tpu.core import se2 as jse2
from ndt_feature_graph_tpu.io import carmen as jcarmen
from ndt_feature_graph_tpu.io import dataset as jds
from ndt_feature_graph_tpu.io import rosbag as jbag
from ndt_feature_graph_tpu.utils import pairwise as jpw
from ndt_feature_graph_tpu_torch import cli as tcli
from ndt_feature_graph_tpu_torch import pipeline as tpipe
from ndt_feature_graph_tpu_torch.io import tum

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "make_torch_port_fixture",
    ROOT / "examples" / "make_torch_port_fixture.py")
fixture_gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixture_gen)
XY_TOL, TH_TOL = 0.01, 0.005
COMMON = ["--new-node-dist", "2.5", "--max-nodes", "16"]
STEPS = 44


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def _last_json(text):
    return json.loads([ln for ln in text.splitlines()
                       if ln.startswith("{")][-1])


def _replaying_run_slam():
    """pipeline.run_slam with the reference's scan draws for the gated
    scans, replayed from its key chain (seed 0)."""
    real = tpipe.run_slam

    def run_slam(params, seq, **kw):
        keep_idx, keep_acc = tpipe.gate_scans(
            seq.odom.numpy(), params.min_incr_dist, params.min_incr_rot)
        odom_g = np.concatenate([np.zeros((1, 3), np.float32),
                                 np.stack(keep_acc)])
        rep = fixture_gen.replay_ransac_draws(0, odom_g, params)
        return real(params, seq, ransac_u=torch.tensor(rep.scan_u), **kw)
    return mock.patch.object(tpipe, "run_slam", run_slam)


@functools.lru_cache(maxsize=None)
def _slam_outputs(tmp):
    """Both CLIs' `slam` on the reference's loop written as a CARMEN log
    and as a bag by the reference's writers, and on the sequence npz the
    port's `simulate` wrote; the port's `simulate` also writes the same
    sequence as a .bag."""
    tmp = pathlib.Path(tmp)
    seq = jds.simulate_sequence(jax.random.PRNGKey(2),
                                jds.loop_trajectory(STEPS, radius=4.5),
                                num_beams=360, max_range=15.0)
    files = {"clf": tmp / "run.clf", "bag": tmp / "run.bag",
             "sim": tmp / "sim.npz", "sim_bag": tmp / "sim.bag"}
    jcarmen.write_carmen(str(files["clf"]), seq, max_range=15.0)
    jbag.write_bag(str(files["bag"]), seq, max_range=15.0)
    sim = ["--steps", str(STEPS), "--radius", "4.5", "--num-beams", "360",
           "--sensor-range", "15", "--seed", "2"]
    logs = {"simulate": _run(tcli.main, ["--device", "cpu", "simulate",
                                         "--out", str(files["sim"]), *sim]),
            "simulate_bag": _run(tcli.main, [
                "--device", "cpu", "simulate", "--out",
                str(files["sim_bag"]), *sim])}
    out = {"files": files, "logs": logs}
    for name, main, pre in (("jax", jcli.main, []),
                            ("port", tcli.main, ["--device", "cpu"])):
        with contextlib.ExitStack() as stack:
            if name == "port":
                stack.enter_context(_replaying_run_slam())
            for kind in ("clf", "bag", "sim"):
                f, d = files[kind], tmp / name / kind
                out[name, kind] = (d, _last_json(_run(main, pre + [
                    "slam", "--dataset", str(f), "--out", str(d),
                    *COMMON])))
    return out


@pytest.fixture(scope="module")
def slam_outputs(tmp_path_factory):
    return _slam_outputs(str(tmp_path_factory.mktemp("cli_inputs")))


@pytest.mark.parametrize("kind", ["clf", "bag", "sim"])
def test_cli_slam_on_each_input_matches_jax(slam_outputs, kind):
    (jd, js), (td, ts) = slam_outputs["jax", kind], slam_outputs["port",
                                                                 kind]
    assert ts["n_nodes"] == js["n_nodes"] >= 3
    assert ts["n_updates"] == js["n_updates"]
    for name in ("est.tum", "gt.tum"):
        jt, jp = tum.read_tum(jd / name)
        tt, tp = tum.read_tum(td / name)
        np.testing.assert_array_equal(tt, jt)
        dth = tp[:, 2] - jp[:, 2]
        assert np.abs(tp[:, :2] - jp[:, :2]).max() <= XY_TOL, name
        assert np.abs(np.arctan2(np.sin(dth), np.cos(dth))).max() <= TH_TOL


def test_cli_logs_read_as_the_npz_they_were_written_from(slam_outputs):
    """The CARMEN log rounds ranges to 0.1 mm and the odometry chain to
    1e-6; the bag keeps float32 ranges: the port's slam on each stays
    within 1 cm / 5 mrad of its slam on the other."""
    (_, a), (_, b) = (slam_outputs["port", k] for k in ("clf", "bag"))
    assert a["n_nodes"] == b["n_nodes"]
    pa = tum.read_tum(slam_outputs["port", "clf"][0] / "est.tum")[1]
    pb = tum.read_tum(slam_outputs["port", "bag"][0] / "est.tum")[1]
    assert np.abs(pa[:, :2] - pb[:, :2]).max() <= XY_TOL


def test_cli_simulate_writes_what_both_packages_read(slam_outputs):
    files, logs = slam_outputs["files"], slam_outputs["logs"]
    assert f"wrote {files['sim']}: {STEPS} steps, 360 beams" in logs[
        "simulate"]
    npz = jds.load_sequence(str(files["sim"]))
    bag, _ = jbag.read_bag_sequence(str(files["sim_bag"]), max_range=15.0)
    gt = np.asarray(jds.loop_trajectory(STEPS, radius=4.5))
    np.testing.assert_array_equal(np.asarray(npz.gt), gt)
    assert np.asarray(npz.ranges).shape == (STEPS, 360)
    # The same seed gives the same scans in both files (the bag reader
    # drops returns beyond 0.999 of the range limit).
    hit = np.asarray(npz.hit) & (np.asarray(npz.ranges) < 15.0 * 0.999)
    np.testing.assert_array_equal(np.asarray(bag.hit), hit)
    np.testing.assert_allclose(np.asarray(bag.ranges)[hit],
                               np.asarray(npz.ranges)[hit], atol=1e-6)
    # The CLI's odometry noise: 0.02 m, 0.02 m, 0.008 rad.
    res = np.asarray(npz.odom)[1:] - np.asarray(jse2.sub(gt[:-1], gt[1:]))
    assert 0.6 < res[:, 0].std() / 0.02 < 1.4
    assert 0.6 < res[:, 2].std() / 0.008 < 1.4


def test_cli_calibrate_matches_jax(tmp_path):
    seq = jds.simulate_sequence(jax.random.PRNGKey(2),
                                jds.loop_trajectory(STEPS, radius=4.5),
                                num_beams=360, max_range=15.0)
    f = tmp_path / "seq.npz"
    jds.save_sequence(str(f), seq)
    argv = ["calibrate", "--dataset", str(f), "--num-beams", "360"]
    j = _last_json(_run(jcli.main, argv))
    t = _last_json(_run(tcli.main, ["--device", "cpu"] + argv))
    assert t["candidates"] == j["candidates"] == 343
    np.testing.assert_allclose(t["extrinsic"], j["extrinsic"], rtol=0,
                               atol=1e-6)
    # The best candidate is unique at the tolerance of the scores.
    pairs, rels = [], []
    for a, b in fixture_gen.calibration_pairs(seq, 3):
        pairs.append((jds.scan_to_points(seq.ranges[a], seq.hit[a]),
                      jds.scan_to_points(seq.ranges[b], seq.hit[b])))
        rels.append(np.asarray(jse2.sub(seq.gt[a], seq.gt[b])))
    _, scores = jpw.calibrate_extrinsic(pairs, rels, 0.4, 0.25, 7)
    scores = np.asarray(scores)
    assert (scores <= scores.min() * (1 + 1e-5)).sum() == 1
