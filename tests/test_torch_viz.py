"""The port's utilities and plots against the JAX package: viz/plot.py (the
overview PNG), viz/html.py (the viewer's embedded payload),
utils/logging_ext.py (GraphLogger, desc_string) and utils/timers.py
(StageTimers, ThroughputMeter, force_readback, device_trace), and
`cli slam --plot --html`.

The payload is compared on one graph: the reference's small loop (the
one of tests/test_viz.py) frozen by the JAX package and carried into the
port (interop.graph_from_jax), with its trajectory and loop links;
cells are subsampled by numpy's default_rng(0) on both sides.  It must
be equal, as JSON.  desc_string must be the same string.  The
GraphLogger runs the reference's scans with its RANSAC draws (replayed
from its key chain): the logged poses within 1 mm / 1 mrad of the
reference's log (the tolerance of the port's other SLAM parity tests is
1 cm / 5 mrad) and equal to the port's own trajectory.
"""

import importlib.util
import json
import os
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_feature_graph_tpu.config import (
    FeatureParams, FuserParams, GraphParams, NDTMapParams, SLAMParams,
)
from ndt_feature_graph_tpu.graph.slam import NDTFeatureGraphSLAM as JSLAM
from ndt_feature_graph_tpu.io import dataset as jds
from ndt_feature_graph_tpu.utils import logging_ext as jlog
from ndt_feature_graph_tpu.utils import timers as jtimers
from ndt_feature_graph_tpu.viz import html as jhtml
from ndt_feature_graph_tpu_torch import cli as tcli
from ndt_feature_graph_tpu_torch import interop
from ndt_feature_graph_tpu_torch.utils import logging_ext as tlog
from ndt_feature_graph_tpu_torch.utils import timers as ttimers
from ndt_feature_graph_tpu_torch.viz import html as thtml
from ndt_feature_graph_tpu_torch.viz import plot as tplot

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "make_torch_port_fixture",
    ROOT / "examples" / "make_torch_port_fixture.py")
fixture_gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixture_gen)
POSE_TOL = 1e-3

PARAMS = SLAMParams(           # tests/test_viz.py's
    fuser=FuserParams(
        ndt=NDTMapParams(resolution=0.5, size_x=16.0, size_y=16.0,
                         sensor_range=6.0, max_points_per_scan=128,
                         max_cells=128, ray_samples=16),
        features=FeatureParams(num_beams=128, max_range=6.0, max_features=8,
                               ransac_hypotheses=32, max_correspondences=16),
    ),
    graph=GraphParams(new_node_transl_dist=1.5, max_nodes=8),
)


def _seq():
    traj = jds.loop_trajectory(24, radius=3.0)
    return jds.simulate_sequence(jax.random.PRNGKey(3), traj, num_beams=128,
                                 max_range=6.0)


_CACHE = {}


def _jax_slam():
    """The reference's small loop graph (tests/test_viz.py _tiny_slam)."""
    if "jax" not in _CACHE:
        seq = _seq()
        slam = JSLAM(PARAMS, seed=0)
        slam.initialize(seq.gt[0], jnp.zeros(3), seq.ranges[0], seq.hit[0])
        slam.run_sequence_chunked(seq.odom, seq.ranges, seq.hit, chunk=8)
        slam.finalize_current_node()
        _CACHE["jax"] = (slam, seq)
    return _CACHE["jax"]


def _port_graph(slam):
    """The reference's frozen graph in a port NDTFeatureGraphSLAM, with its
    trajectory and loop links."""
    from ndt_feature_graph_tpu.graph import node as jnode

    bank = jax.tree.map(np.asarray, jnode.stack_nodes(slam.nodes))
    port = interop.graph_from_jax(interop.params_from_jax(PARAMS), bank,
                                  np.stack(slam.node_T), slam.odom_edges,
                                  device="cpu")
    port.trajectory = [np.asarray(t, np.float32) for t in slam.trajectory]
    port.loop_links = [(int(l[0]), int(l[1])) + tuple(l[2:])
                       for l in slam.loop_links]
    return port


@pytest.mark.parametrize("max_cells", [4000, 20])
def test_html_payload_matches_jax(max_cells):
    """The embedded payload of the reference's graph, whole and with every
    node's cells subsampled to 20 by default_rng(0)."""
    slam, seq = _jax_slam()
    gt = np.asarray(seq.gt)
    want = jhtml._graph_payload(slam, gt, max_cells_per_node=max_cells)
    got = thtml._graph_payload(_port_graph(slam), gt,
                               max_cells_per_node=max_cells)
    assert json.dumps(got) == json.dumps(want)
    if max_cells == 20:
        assert all(len(n["cells"]) <= 20 for n in got["nodes"])
        assert any(len(n["cells"]) == 20 for n in got["nodes"])


def test_overview_png_and_viewer_html(tmp_path):
    slam, seq = _jax_slam()
    port = _port_graph(slam)
    gt = torch.tensor(np.asarray(seq.gt))
    tplot.save_slam_overview(tmp_path / "overview.png", port, gt=gt)
    assert (tmp_path / "overview.png").stat().st_size > 1000
    assert (tmp_path / "overview.png").read_bytes()[:4] == b"\x89PNG"
    thtml.export_html(tmp_path / "viewer.html", port, gt=gt)
    jhtml.export_html(tmp_path / "jax.html", slam, gt=np.asarray(seq.gt))
    text = (tmp_path / "viewer.html").read_text()
    assert "http://" not in text and "https://" not in text
    assert text == (tmp_path / "jax.html").read_text()
    m = re.search(r"const D = (\{.*?\});\n", text, re.S)
    assert len(json.loads(m.group(1))["nodes"]) == len(slam.nodes)


@pytest.mark.parametrize("params", ["default", "viz", "canonical"])
def test_desc_string_matches_jax(params):
    spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    p = {"default": SLAMParams(), "viz": PARAMS,
         "canonical": SLAMParams(fuser=bench.canonical_params())}[params]
    got = tlog.desc_string(interop.params_from_jax(p))
    assert got == jlog.desc_string(p)
    assert "resolution" in got and 0 < len(got) <= 200


def test_graph_logger_matches_jax(tmp_path):
    """GraphLogger over the loop's first 12 scans, one line a scan."""
    seq = jax.tree.map(np.asarray, _seq())
    n = 12
    jl = jlog.GraphLogger(PARAMS, str(tmp_path / "jax.log"))
    jl.initialize(jnp.asarray(seq.gt[0]), jnp.zeros(3),
                  jnp.asarray(seq.ranges[0]), jnp.asarray(seq.hit[0]))
    for t in range(1, n):
        jl.update(jnp.asarray(seq.odom[t]), jnp.asarray(seq.ranges[t]),
                  jnp.asarray(seq.hit[t]), t=0.1 * t)
    jl.close()
    draws = fixture_gen.replay_ransac_draws(0, seq.odom[:n], PARAMS).scan_u
    tl = tlog.GraphLogger(interop.params_from_jax(PARAMS),
                          str(tmp_path / "port.log"))
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    tl.initialize(f32(seq.gt[0]), torch.zeros(3), f32(seq.ranges[0]),
                  torch.tensor(seq.hit[0]))
    for t in range(1, n):
        tl.update(f32(seq.odom[t]), f32(seq.ranges[t]),
                  torch.tensor(seq.hit[t]), t=0.1 * t,
                  u=torch.tensor(draws[t - 1]))
    tl.close()
    want = np.loadtxt(tmp_path / "jax.log")
    got = np.loadtxt(tmp_path / "port.log")
    assert got.shape == want.shape == (n, 4)
    assert len(tl.nodes) == len(jl.nodes) >= 1
    np.testing.assert_array_equal(got[:, 3], want[:, 3])
    np.testing.assert_allclose(got[:, :3], want[:, :3], atol=POSE_TOL)
    np.testing.assert_allclose(got[:, :3], np.stack(tl.trajectory),
                               atol=5e-7)


def test_stage_timers_meter_readback_and_trace(tmp_path):
    """StageTimers accumulate and report as the reference's; a stage
    blocks on its tensors through force_readback, whose digest is the
    reference's; ThroughputMeter counts; device_trace writes a Chrome
    trace."""
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    tree = {"a": torch.tensor(x), "b": [torch.tensor(x > 5), None],
            "c": interop.cell_list_from_jax(
                {"means": x[:, :2], "covs": np.ones((3, 2, 2), np.float32),
                 "mask": x[:, 0] > 0}, device="cpu")}
    jtree = {"a": jnp.asarray(x), "b": [jnp.asarray(x > 5)],
             "c": {"means": jnp.asarray(x[:, :2]),
                   "covs": jnp.ones((3, 2, 2)), "mask": jnp.asarray(
                       x[:, 0] > 0)}}
    assert ttimers.force_readback(tree) == pytest.approx(
        jtimers.force_readback(jtree), rel=1e-6)
    t, j = ttimers.StageTimers(), jtimers.StageTimers()
    for timers in (t, j):
        for _ in range(3):
            with timers.stage("solve", block_on=tree["a"] * 2):
                pass
        with timers.stage("load"):
            pass
    assert dict(t.counts) == dict(j.counts) == {"solve": 3, "load": 1}
    assert [ln.split()[0] for ln in t.report().splitlines()] == [
        ln.split()[0] for ln in j.report().splitlines()] == ["load", "solve"]
    assert t.mean_ms("solve") > 0 and t.mean_ms("none") == 0.0
    meter = ttimers.ThroughputMeter()
    meter.tick(5)
    meter.tick()
    assert meter.n == 6 and meter.per_sec > 0
    with ttimers.device_trace(str(tmp_path / "trace")):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    trace = tmp_path / "trace" / "trace.json"
    assert trace.stat().st_size > 0
    assert "traceEvents" in json.loads(trace.read_text())


def test_cli_slam_plot_and_html(tmp_path):
    """`cli slam --plot --html` on a 16-scan loop written by `cli
    simulate`: overview.png and viewer.html, whose payload describes the
    run (its trajectory is est.tum's)."""
    seq = str(tmp_path / "seq.npz")
    tcli.main(["--device", "cpu", "simulate", "--out", seq, "--steps", "16",
               "--radius", "3.0", "--num-beams", "128", "--sensor-range",
               "6.0"])
    out = tmp_path / "o"
    tcli.main(["--device", "cpu", "slam", "--dataset", seq, "--out",
               str(out), "--plot", "--html", "--num-beams", "128",
               "--sensor-range", "6.0", "--map-size", "16", "--max-cells",
               "128", "--new-node-dist", "1.5", "--max-nodes", "8"])
    assert (out / "overview.png").read_bytes()[:4] == b"\x89PNG"
    text = (out / "viewer.html").read_text()
    payload = json.loads(re.search(r"const D = (\{.*?\});\n", text,
                                   re.S).group(1))
    est = np.loadtxt(out / "est.tum")
    assert len(payload["traj"]) == len(est) == 16
    np.testing.assert_allclose(np.asarray(payload["traj"])[:, :2],
                               est[:, 1:3], atol=1e-3)
    assert len(payload["nodes"]) >= 2 and len(payload["gt"]) == 16
    assert os.path.exists(out / "graph.npz")
