"""The port's CLI (`python -m ndt_feature_graph_tpu_torch.cli`) against
the JAX package's on one small simulated loop, written as a
save_sequence npz: `slam --optimize`, `optimize` on the checkpoint it
wrote, `export-map` and `eval`, the port on the CPU (`--device cpu`).

The port runs with the reference's RANSAC draws, replayed from its key
chain (the online pass and the proposal after it; a fresh graph's
proposal for `optimize`).  The loop (44 scans, 4.5 m, nine nodes, four
kept links) is one where the reference's own link refinement is steady:
its kept links move by 0.014 mm when its RANSAC poses move by 1e-6.  On
others it is not (36 scans around 3.5 m: two of six kept links are
degenerate registrations that move 4-11 cm under that change, and the
optimized nodes of either framework 1-2 cm; the chaotic refinement of
ROADMAP queue 3).  Tolerances: TUM poses within 1 cm / 5 mrad;
occupancy probabilities of the stitched map within 1e-5; ATE within
1 cm.  slam --plot / --html write their files.

`fuse` (plain, --hmt-dir, --resume) runs on the reference's test
corridor (tests/test_io_cli.py); `localize` on a 60-scan loop where the
reference's MCL is steady (on others its final error moves 0.1 m under
a 1e-6 change of the odometry), its MCL and RANSAC draws the
reference's own (recorded from its run).
"""

import argparse
import contextlib
import functools
import importlib.util
import io
import json
import pathlib
import subprocess
import sys
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from ndt_feature_graph_tpu import cli as jcli
from ndt_feature_graph_tpu.graph.slam import NDTFeatureGraphSLAM as JSLAM
from ndt_feature_graph_tpu.io import dataset as jds
from ndt_feature_graph_tpu.utils import occupancy as jocc
from ndt_feature_graph_tpu_torch import cli as tcli
from ndt_feature_graph_tpu_torch import interop
from ndt_feature_graph_tpu_torch import pipeline as tpipe
from ndt_feature_graph_tpu_torch.graph.slam import NDTFeatureGraphSLAM
from ndt_feature_graph_tpu_torch.io import tum
from ndt_feature_graph_tpu_torch.utils import occupancy as tocc

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "make_torch_port_fixture",
    ROOT / "examples" / "make_torch_port_fixture.py")
fixture_gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixture_gen)
XY_TOL, TH_TOL = 0.01, 0.005
# The odometry offsets of the reference's perturbed localize runs (at
# +-3e-6 its MCL on this loop already lands 18 cm elsewhere).
LOCALIZE_EPS = (1e-6, -1e-6)
COMMON = ["--new-node-dist", "2.5", "--max-nodes", "16",
          "--max-dist", "3.0", "--max-angular-dist", "0.6",
          "--max-score", "0.2"]


def _run(main, argv):
    """Run a CLI's main in-process; returns its standard output."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def _last_json(text):
    return json.loads([ln for ln in text.splitlines()
                       if ln.startswith("{")][-1])


def _fresh_graph_draws(slam, m_hyp):
    """The draws of the first proposal of a graph made fresh (a loaded
    checkpoint): key PRNGKey(0), split once."""
    n = int(slam.candidate_pairs()[2].sum())
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    return [fixture_gen._pair_uniforms(sub, n, m_hyp)]


@functools.lru_cache(maxsize=None)
def _outputs(tmp):
    tmp = pathlib.Path(tmp)
    traj = jds.loop_trajectory(44, radius=4.5)
    seq = jds.simulate_sequence(jax.random.PRNGKey(2), traj, num_beams=360,
                                max_range=15.0)
    seqf = str(tmp / "seq.npz")
    jds.save_sequence(seqf, seq)
    out = {}
    for name, main, pre in (("jax", jcli.main, []),
                            ("port", tcli.main, ["--device", "cpu"])):
        d = tmp / name
        logs = {}
        if name == "port":
            real_run, real_load = tpipe.run_slam, NDTFeatureGraphSLAM.load

            def run_slam(params, seq, **kw):
                odom = seq.odom.numpy()
                keep_idx, keep_acc = tpipe.gate_scans(
                    odom, params.min_incr_dist, params.min_incr_rot)
                odom_g = np.concatenate([np.zeros((1, 3), np.float32),
                                         np.stack(keep_acc)])
                rep = fixture_gen.replay_ransac_draws(0, odom_g, params)
                slam, stats = real_run(params, seq,
                                       ransac_u=torch.tensor(rep.scan_u),
                                       **kw)
                n = int(slam.candidate_pairs()[2].sum())
                slam.pair_u = list(fixture_gen.replay_ransac_draws(
                    0, odom_g, params, pair_counts=[n]).pair_u)
                return slam, stats

            def load(path, params, **kw):
                slam = real_load(path, params, **kw)
                slam.pair_u = _fresh_graph_draws(
                    slam, params.fuser.features.ransac_hypotheses)
                return slam

            patches = [mock.patch.object(tpipe, "run_slam", run_slam),
                       mock.patch.object(NDTFeatureGraphSLAM, "load", load)]
        else:
            patches = []
        with contextlib.ExitStack() as stack:
            for p in patches:
                stack.enter_context(p)
            logs["slam"] = _run(main, pre + [
                "slam", "--dataset", seqf, "--out", str(d), "--optimize",
                *COMMON])
            logs["optimize"] = _run(main, pre + [
                "optimize", "--graph", str(d / "graph.npz"),
                "--out", str(d / "opt.tum"), *COMMON])
            logs["export"] = _run(main, pre + [
                "export-map", "--graph", str(d / "graph.npz"),
                "--out", str(d / "map.pgm"), *COMMON])
            logs["eval"] = _run(main, pre + [
                "eval", "--est", str(d / "est.tum"), "--gt",
                str(d / "gt.tum")])
        out[name] = (d, logs)
    return out


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    return _outputs(str(tmp_path_factory.mktemp("cli")))


def _poses_close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    dth = a[:, 2] - b[:, 2]
    assert np.abs(a[:, :2] - b[:, :2]).max() <= XY_TOL
    assert np.abs(np.arctan2(np.sin(dth), np.cos(dth))).max() <= TH_TOL


@pytest.mark.parametrize("name", ["est.tum", "gt.tum", "nodes_opt.tum",
                                  "opt.tum"])
def test_cli_trajectories_match_jax(outputs, name):
    (jd, _), (td, _) = outputs["jax"], outputs["port"]
    jt, jp = tum.read_tum(jd / name)
    tt, tp = tum.read_tum(td / name)
    np.testing.assert_allclose(tt, jt)
    _poses_close(tp, jp)


def test_cli_slam_stats_and_links_match_jax(outputs):
    (_, jl), (_, tl) = outputs["jax"], outputs["port"]
    js, ts = _last_json(jl["slam"]), _last_json(tl["slam"])
    assert ts["n_nodes"] == js["n_nodes"] >= 4
    assert ts["n_updates"] == js["n_updates"]
    assert abs(ts["ate_rmse_m"] - js["ate_rmse_m"]) <= XY_TOL
    # The fixpoint rounds kept the same links.
    rounds = [[ln for ln in log["optimize"].splitlines()
               if ln.startswith("fixpoint")] for log in (jl, tl)]
    assert rounds[0] == rounds[1] and rounds[0]


def test_cli_export_map_matches_jax(outputs):
    """The exported maps have the same size and an origin within the
    node poses' tolerance; stitched from the same checkpoint (JAX's),
    both frameworks give the same probabilities within 1e-5."""
    (jd, jl), (td, tl) = outputs["jax"], outputs["port"]
    je, te = _last_json(jl["export"]), _last_json(tl["export"])
    assert te["cells"] == je["cells"]
    np.testing.assert_allclose(te["origin"], je["origin"], atol=XY_TOL)
    head = lambda d: (d / "map.pgm").read_bytes()[:20]  # noqa: E731
    assert head(jd) == head(td)
    jp = jcli._params_from_args(argparse.Namespace(**_namespace()))
    jprob, jorigin, jres = jocc.stitch_graph_occupancy(
        JSLAM.load(jd / "graph.npz", jp))
    tprob, torigin, tres = tocc.stitch_graph_occupancy(
        NDTFeatureGraphSLAM.load(jd / "graph.npz",
                                 interop.params_from_jax(jp), device="cpu"))
    assert jprob.shape == tprob.shape and jres == tres
    np.testing.assert_allclose(tprob, jprob, atol=1e-5)
    np.testing.assert_allclose(torigin, jorigin, atol=1e-5)


def _namespace():
    """The CLI's common flags as parsed from COMMON (360 beams)."""
    ap = argparse.ArgumentParser()
    tcli._add_common(ap)
    return vars(ap.parse_args(COMMON))


def test_cli_eval_matches_jax(outputs):
    (_, jl), (_, tl) = outputs["jax"], outputs["port"]
    je, te = _last_json(jl["eval"]), _last_json(tl["eval"])
    assert te["poses"] == je["poses"]
    for k in ("ate_rmse_m", "ate_rmse_aligned_m"):
        assert abs(te[k] - je[k]) <= XY_TOL


@pytest.mark.parametrize("flag", ["--plot", "--html"])
def test_cli_unported_subcommands_name_their_slice(flag, tmp_path):
    """slam's --plot and --html (the reference's viz/), once the options
    of a later slice, now run: each writes its file (overview.png, a PNG;
    viewer.html, a self-contained viewer of the run's 16 poses) beside
    the run's other outputs, and nothing else of viz/."""
    seq = str(tmp_path / "seq.npz")
    small = ["--num-beams", "128", "--sensor-range", "6.0"]
    _run(tcli.main, ["--device", "cpu", "simulate", "--out", seq, "--steps",
                     "16", "--radius", "3.0", *small])
    out = tmp_path / "o"
    _run(tcli.main, ["--device", "cpu", "slam", "--dataset", seq, "--out",
                     str(out), flag, *small, "--map-size", "16",
                     "--max-cells", "128", "--new-node-dist", "1.5"])
    written = {"--plot": "overview.png", "--html": "viewer.html"}
    assert (out / written[flag]).stat().st_size > 1000
    other = [f for k, f in written.items() if k != flag][0]
    assert not (out / other).exists()
    if flag == "--plot":
        assert (out / "overview.png").read_bytes()[:4] == b"\x89PNG"
    else:
        text = (out / "viewer.html").read_text()
        assert "https://" not in text and '"traj":[[' in text
        assert text.count("],[") >= 15 and (out / "est.tum").exists()


def test_cli_runs_as_a_module_and_defaults_to_the_card():
    """`python -m ndt_feature_graph_tpu_torch.cli`: help works without a
    card; a subcommand that needs the device asks for the card by
    default and raises without one."""
    r = subprocess.run([sys.executable, "-m", "ndt_feature_graph_tpu_torch.cli",
                        "--help"], capture_output=True, text=True, cwd=ROOT)
    assert r.returncode == 0 and "export-map" in r.stdout
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(["export-map", "--graph", "g.npz", "--out", "m.pgm"])


def _jax_simulate(path, *args):
    jcli.main(["simulate", "--out", str(path), *args])


@functools.lru_cache(maxsize=None)
def _fuse_outputs(tmp):
    """Both CLIs' `fuse`: plain, --hmt-dir, then --resume from the
    directory; the port also resumes from a copy of JAX's directory."""
    import shutil

    tmp = pathlib.Path(tmp)
    seqf = tmp / "seq.npz"
    _jax_simulate(seqf, "--trajectory", "corridor", "--steps", "24",
                  "--num-beams", "180", "--sensor-range", "6", "--seed", "2")
    common = ["--map-size", "20", "--sensor-range", "6", "--num-beams",
              "180"]
    hmt_args = ["--recenter-margin", "2", "--chunk", "4"]
    full = dict(np.load(seqf))
    h = full["gt"].shape[0] // 2
    # The resumed run continues the drive: the first run fuses scans
    # 0..h into the store, the resumed one scans h..end from there.
    for tag, rows in (("first", slice(0, h + 1)), ("second", slice(h, None))):
        np.savez(tmp / f"seq_{tag}.npz", **{k: v[rows] for k, v in
                                            full.items()})
        eps = {k: v[rows] for k, v in full.items()}
        eps["odom"] = eps["odom"] + 1e-6
        np.savez(tmp / f"seq_{tag}_eps.npz", **eps)
    eps = dict(full, odom=full["odom"] + 1e-6)
    np.savez(tmp / "seq_eps.npz", **eps)
    out = {}
    for name, main, pre, f in (
            ("jax", jcli.main, [], seqf),
            ("jax_eps", jcli.main, [], tmp / "seq_eps.npz"),
            ("port", tcli.main, ["--device", "cpu"], seqf)):
        d = tmp / name
        part = lambda tag: f.parent / f.name.replace(  # noqa
            "seq", f"seq_{tag}")
        run = lambda tag, f, *extra: _last_json(_run(main, pre + [  # noqa
            "fuse", "--dataset", str(f), "--out", str(d / tag),
            *common, *extra]))
        logs = {"plain": run("plain", f),
                "hmt": run("hmt", part("first"), "--hmt-dir",
                           str(d / "hmt"), *hmt_args)}
        if name == "jax":
            shutil.copytree(d / "hmt", tmp / "jax_dir_for_port")
        logs["resume"] = run("resume", part("second"), "--hmt-dir",
                             str(d / "hmt"), *hmt_args, "--resume")
        out[name] = (d, logs)
    out["port_from_jax"] = (tmp / "port", _last_json(_run(tcli.main, [
        "--device", "cpu", "fuse", "--dataset",
        str(tmp / "seq_second.npz"), "--out",
        str(tmp / "port" / "resume_jax"), *common, "--hmt-dir",
        str(tmp / "jax_dir_for_port"), *hmt_args, "--resume"])))
    return out


@pytest.fixture(scope="module")
def fuse_outputs(tmp_path_factory):
    return _fuse_outputs(str(tmp_path_factory.mktemp("fuse")))


def _fuse_spread(fuse_outputs, tag, d=None):
    """The reference's own spread on `tag`: its run with the odometry
    moved by 1e-6 against its run, at least 1 cm / 5 mrad."""
    _, jt = tum.read_tum(fuse_outputs["jax"][0] / tag / "est.tum")
    _, et = tum.read_tum(fuse_outputs["jax_eps"][0] / tag / "est.tum")
    dth = et[:, 2] - jt[:, 2]
    return (max(XY_TOL, float(np.abs(et[:, :2] - jt[:, :2]).max())),
            max(TH_TOL, float(np.abs(np.arctan2(np.sin(dth),
                                                np.cos(dth))).max())))


def _within(a, b, tol):
    dth = a[:, 2] - b[:, 2]
    assert np.abs(a[:, :2] - b[:, :2]).max() <= tol[0]
    assert np.abs(np.arctan2(np.sin(dth), np.cos(dth))).max() <= tol[1]


@pytest.mark.parametrize("tag", ["plain", "hmt", "resume"])
def test_cli_fuse_matches_jax(fuse_outputs, tag):
    """fuse plain over the whole corridor, over the HMT store on its
    first half, then resumed from the store over its second half: the
    same trajectories (1 cm / 5 mrad, or the reference's own spread
    under a 1e-6 change of the odometry where that is wider), ATE,
    recentre and stored-cell counts.  The resumed run restarts
    Tlast_fuse at the saved Tnow, as the reference's does (it does not
    save Tlast_fuse)."""
    (jd, jl), (td, tl) = fuse_outputs["jax"], fuse_outputs["port"]
    _, jt = tum.read_tum(jd / tag / "est.tum")
    _, tt = tum.read_tum(td / tag / "est.tum")
    _within(tt, jt, _fuse_spread(fuse_outputs, tag))
    assert tl[tag]["n_scans"] == jl[tag]["n_scans"] > 10
    assert abs(tl[tag]["ate_rmse_m"] - jl[tag]["ate_rmse_m"]) <= XY_TOL
    for k in ("n_recenters", "stored_cells"):
        assert tl[tag].get(k) == jl[tag].get(k)
    if tag != "plain":
        assert tl[tag]["n_recenters"] > 0


def test_cli_fuse_resumes_from_a_directory_jax_wrote(fuse_outputs):
    (jd, jl), _ = fuse_outputs["jax"], fuse_outputs["port"]
    td, tl = fuse_outputs["port_from_jax"]
    _, jt = tum.read_tum(jd / "resume" / "est.tum")
    _, tt = tum.read_tum(td / "resume_jax" / "est.tum")
    _within(tt, jt, _fuse_spread(fuse_outputs, "resume"))
    assert tl["stored_cells"] == jl["resume"]["stored_cells"]


@functools.lru_cache(maxsize=None)
def _localize_outputs(tmp):
    """Both CLIs' `localize`, tracking and --kidnapped, the port on the
    reference's recorded MCL draws and its relocalization draws
    (PRNGKey(1), one split per stored scan)."""
    from ndt_feature_graph_tpu.localization import mcl as jmcl
    from ndt_feature_graph_tpu_torch.localization import mcl as tmcl
    from ndt_feature_graph_tpu_torch.localization import place_rec as tpr

    tmp = pathlib.Path(tmp)
    seqf = tmp / "seq.npz"
    _jax_simulate(seqf, "--steps", "60", "--radius", "5.0", "--seed", "1")
    full = dict(np.load(seqf))
    for i, e in enumerate(LOCALIZE_EPS):
        np.savez(tmp / f"seq_eps{i}.npz", **{**full, "odom": full["odom"] + e})
    args = ["--dataset", str(seqf), "--particles", "256"]
    rec_cls = fixture_gen.recording_mcl_class()
    runs = []

    class Recording(rec_cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            runs.append(self)

    with mock.patch.object(jmcl, "MCL", Recording):
        jax_track = _last_json(_run(jcli.main, ["localize", *args]))
    dr = fixture_gen.mcl_draws(runs[0])
    t = lambda x: torch.as_tensor(np.array(x))  # noqa: E731
    draws = tmcl.recorded_draws(t(dr["init_xy"]), t(dr["init_theta"]),
                           t(dr["noise"]), dr["resampled"], t(dr["u0"]))
    real_mcl, real_reloc = tmcl.MCL, tpr.relocalize
    ports = []

    def replaying_mcl(*a, **k):
        ports.append(real_mcl(*a, draws=draws, **k))
        return ports[-1]

    def relocalize(db, fp, ranges, hit, u, **k):
        ju = fixture_gen.relocalize_draws(jax.random.PRNGKey(1),
                                          u.shape[0], u.shape[1])
        return real_reloc(db, fp, ranges, hit, t(ju), **k)

    with mock.patch.object(tmcl, "MCL", replaying_mcl), \
            mock.patch.object(tpr, "relocalize", relocalize):
        port_track = _last_json(_run(tcli.main,
                                     ["--device", "cpu", "localize", *args]))
        port_kid = _last_json(_run(tcli.main, ["--device", "cpu", "localize",
                                               *args, "--kidnapped"]))
    jax_kid = _last_json(_run(jcli.main, ["localize", *args, "--kidnapped"]))
    jax_eps = [_last_json(_run(jcli.main, [
        "localize", "--dataset", str(tmp / f"seq_eps{i}.npz"),
        "--particles", "256"])) for i in range(len(LOCALIZE_EPS))]
    return (jax_track, port_track, runs[0].resampled, ports[0].resampled,
            jax_kid, port_kid, jax_eps)


@pytest.fixture(scope="module")
def localize_outputs(tmp_path_factory):
    return _localize_outputs(str(tmp_path_factory.mktemp("localize")))


def test_cli_localize_tracking_matches_jax(localize_outputs):
    """MCL tracking on the reference's draws: the same resampling
    decisions; mean and final error within the reference's own spread
    (the most its runs with the odometry moved by +-1e-6 move them), at
    least 5 mm: a comb tooth within rounding of a CDF step picks the
    neighbouring particle (the resampling trap), which moves an
    estimate by millimetres."""
    jt, tt, jres, tres = localize_outputs[:4]
    je = localize_outputs[6]
    assert tt["steps"] == jt["steps"] == 29
    assert tres == jres
    for k in ("mean_error_m", "final_error_m"):
        tol = max(max(abs(r[k] - jt[k]) for r in je), 5e-3)
        assert abs(tt[k] - jt[k]) <= tol, (k, tt[k], jt[k], tol)
    assert tt["mean_error_m"] < 0.3


def test_cli_localize_kidnapped_matches_jax(localize_outputs):
    """Relocalization by place recognition and the badness gate: the
    same outcome and inlier count; badness within 1e-5 m and the
    position error within 1 cm of the reference's."""
    jk, tk = localize_outputs[4:6]
    assert tk["relocalized"] == jk["relocalized"] is True
    assert tk["inliers"] == jk["inliers"] >= 8
    for k in ("badness_m", "position_error_m"):
        if np.isnan(jk[k]):
            assert np.isnan(tk[k])
        else:
            assert abs(tk[k] - jk[k]) <= (1e-5 if k == "badness_m"
                                          else XY_TOL)
