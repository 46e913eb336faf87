"""The port's inputs against the JAX package's on the CPU: the CARMEN
parser (native, and its plain twin),
io/carmen.py, io/rosbag.py, io/reference_data.py and the se2 matrix
forms.

Tolerances: what is numpy or text in both packages equals bit for bit
(ranges, hits, parsed logs, the demo graph's arrays, the files the
writers make); odometry that one framework's se2.sub derives from the
same absolute poses within 1e-6 (an ulp of sin / cos); se2 matrices
within 1e-6.
"""

import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_feature_graph_tpu.core import se2 as jse2
from ndt_feature_graph_tpu.io import carmen as jcarmen
from ndt_feature_graph_tpu.io import dataset as jds
from ndt_feature_graph_tpu.io import reference_data as jref
from ndt_feature_graph_tpu.io import rosbag as jbag
from ndt_feature_graph_tpu_torch.core import se2
from ndt_feature_graph_tpu_torch.io import carmen, native, reference_data
from ndt_feature_graph_tpu_torch.io import rosbag
from ndt_feature_graph_tpu_torch.io.dataset import Sequence

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"
ODOM_TOL = 1e-6


def _jseq():
    traj = jds.loop_trajectory(24, radius=4.0)
    return jds.simulate_sequence(jax.random.PRNGKey(3), traj, num_beams=180,
                                 max_range=15.0)


def _tseq(js):
    return Sequence(*(torch.tensor(np.asarray(x)) for x in js))


def _same_sequence(t, j, exact_odom=False):
    """The port's sequence equals the reference's: ranges, hits and
    ground truth bit for bit, odometry within ODOM_TOL."""
    for k in ("ranges", "hit", "gt"):
        got, want = getattr(t, k).numpy(), np.asarray(getattr(j, k))
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(t.odom.numpy(), np.asarray(j.odom), rtol=0,
                               atol=0 if exact_odom else ODOM_TOL)


def _sample_clf(path, n_scans=6, n_beams=12, robotlaser=False):
    """A CARMEN log of FLASER records (and a ROBOTLASER1 record)."""
    rng = np.random.default_rng(1)
    lines = ["# test log"]
    for k in range(n_scans):
        r = rng.uniform(0.5, 10.0, n_beams - k % 3)
        odom = [0.1 * k, 0.02 * k, 0.01 * k]
        lines.append(" ".join(
            ["FLASER", str(len(r))] + [f"{v:.4f}" for v in r]
            + ["0.0", "0.0", "0.0"] + [f"{v:.4f}" for v in odom]
            + [f"{100.0 + k:.4f}", "host", f"{100.0 + k:.4f}"]))
        lines.append(f"ODOM {0.1 * k} 0 0 0 0 0 {100.0 + k} host 0")
    if robotlaser:
        r = rng.uniform(0.5, 10.0, n_beams)
        lines.append(" ".join(
            ["ROBOTLASER1", "0", "-1.57", "3.14", "0.0175", "50.0", "0.01",
             "0", str(n_beams)] + [f"{v:.4f}" for v in r] + ["0"]
            + ["1.0", "2.0", "0.3", "1.1", "2.1", "0.35"]
            + ["0.1", "0.0", "0.0", "0.0", "0.0"]
            + ["200.5", "host", "200.5"]))
    path.write_text("\n".join(lines) + "\n")
    return path


def test_native_parser_equals_its_plain_twin(tmp_path):
    path = _sample_clf(tmp_path / "a.clf")
    got = native.read_carmen(path)
    want = native._read_carmen_py(path)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got.ranges.shape == (6, 12) and list(got.beam_counts) == [
        12, 11, 10, 12, 11, 10]


def test_native_parser_reads_robotlaser1(tmp_path):
    """ROBOTLASER1 records, which only the native parser reads: the
    robot pose is the odometry, the ranges and the stamp are the
    record's."""
    path = _sample_clf(tmp_path / "b.clf", robotlaser=True)
    got = native.read_carmen(path)
    plain = native._read_carmen_py(path)
    assert got.ranges.shape == (7, 12)
    for g, w in zip(got, plain):
        np.testing.assert_array_equal(g[:6], w)
    rec = path.read_text().splitlines()[-1].split()
    np.testing.assert_array_equal(got.ranges[6],
                                  np.asarray(rec[9:21], np.float32))
    np.testing.assert_array_equal(got.odom_abs[6],
                                  np.asarray([1.1, 2.1, 0.35], np.float32))
    assert got.beam_counts[6] == 12 and got.times[6] == 200.5


def test_native_parser_reads_edge_cases_as_the_reference(tmp_path):
    """Comments, blank lines and other records skipped; a truncated
    record, a nan, trailing text in a number and a zero count drop their
    record; exponents, a missing stamp (0) and CRLF read; "2.0" as the
    count reads 2 and then ".0" as the first range, as a C++ stream
    does.  The expected values are the reference's native parser's
    (native/carmen_parser.cpp) on this file."""
    path = tmp_path / "edge.clf"
    path.write_text(
        "# comment\n\n   \n"
        "FLASER 2 1 2 0 0 0 1 2 3 5 h 5\n"
        "ODOM 1 2 3 0 0 0 1 h 1\n"
        "FLASER 3 1.0 2.5\n"
        "FLASER 2 1e1 2.5E-1 0 0 0 -1.5e+0 .5 5. 1e3 h 1\n"
        "FLASER 2 nan 2 0 0 0 1 2 3 4 h 4\n"
        "FLASER 2.0 1 2 0 0 0 1 2 3 4 h 4\n"
        "FLASER 2 1.5abc 2 0 0 0 1 2 3 4 h 4\n"
        "FLASER 0 1 2\n"
        "FLASER 2 3 4 0 0 0 1 2 3\r\n")
    got = native.read_carmen(path)
    np.testing.assert_array_equal(got.ranges, np.array(
        [[1, 2], [10, 0.25], [0, 1], [3, 4]], np.float32))
    np.testing.assert_array_equal(got.beam_counts, [2, 2, 2, 2])
    np.testing.assert_array_equal(got.odom_abs, np.array(
        [[1, 2, 3], [-1.5, 0.5, 5], [0, 1, 2], [1, 2, 3]], np.float32))
    np.testing.assert_array_equal(got.times, [5.0, 1000.0, 3.0, 0.0])


def test_parser_build_failure_raises(tmp_path, monkeypatch):
    """No quiet fallback: a source that does not compile raises."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCES", (*native.SOURCES, bad))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.read_carmen(_sample_clf(tmp_path / "c.clf"))


def test_missing_log_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        native.read_carmen(tmp_path / "none.clf")


def test_clf_written_by_jax_reads_the_same_in_both(tmp_path):
    js = _jseq()
    path = tmp_path / "j.clf"
    jcarmen.write_carmen(str(path), js, max_range=15.0)
    _same_sequence(
        carmen.read_carmen_sequence(path, max_range=15.0, device=CPU),
        jcarmen.read_carmen_sequence(str(path), max_range=15.0))


def test_clf_written_by_the_port_reads_the_same_in_both(tmp_path):
    js = _jseq()
    tpath, jpath = tmp_path / "t.clf", tmp_path / "j.clf"
    carmen.write_carmen(tpath, _tseq(js), max_range=15.0)
    jcarmen.write_carmen(str(jpath), js, max_range=15.0)
    _same_sequence(
        carmen.read_carmen_sequence(tpath, max_range=15.0, device=CPU),
        jcarmen.read_carmen_sequence(str(tpath), max_range=15.0))
    # The port's writer composes the odometry chain in float32 as the
    # reference's does: the two files differ at most in the sixth
    # decimal of a pose.
    tl, jl = (native.read_carmen(p) for p in (tpath, jpath))
    np.testing.assert_array_equal(tl.ranges, jl.ranges)
    np.testing.assert_allclose(tl.odom_abs, jl.odom_abs, rtol=0, atol=2e-6)


def test_log_to_sequence_clips_and_masks():
    log = native.CarmenLog(
        ranges=np.array([[1.0, 40.0, 81.91], [2.0, 3.0, 81.91]], np.float32),
        beam_counts=np.array([2, 3], np.int32),
        odom_abs=np.array([[0, 0, 0], [0.5, 0.1, 0.2]], np.float32),
        times=np.zeros(2))
    t = carmen.log_to_sequence(log, max_range=30.0, device=CPU)
    _same_sequence(t, jcarmen.log_to_sequence(log, max_range=30.0))
    assert t.hit.tolist() == [[True, False, False], [True, True, False]]


def _bag_pair(tmp_path, writer, **kw):
    js = _jseq()
    path = tmp_path / "run.bag"
    if writer == "jax":
        jbag.write_bag(str(path), js, max_range=15.0, **kw)
    else:
        rosbag.write_bag(path, _tseq(js), max_range=15.0, **kw)
    return js, path


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_bag_reads_the_same_in_both(tmp_path, writer, compression):
    js, path = _bag_pair(tmp_path, writer, compression=compression)
    t, ts = rosbag.read_bag_sequence(path, max_range=15.0, device=CPU)
    j, jstamps = jbag.read_bag_sequence(str(path), max_range=15.0)
    _same_sequence(t, j)
    np.testing.assert_array_equal(ts, jstamps)
    # The round trip keeps the hits and the ranges of the hits.
    hit = np.asarray(js.hit)
    np.testing.assert_array_equal(t.hit.numpy(), hit)
    np.testing.assert_allclose(t.ranges.numpy()[hit],
                               np.asarray(js.ranges)[hit], atol=1e-6)


def test_bags_of_both_writers_are_the_same_file(tmp_path):
    js = _jseq()
    jbag.write_bag(str(tmp_path / "j.bag"), js, max_range=15.0)
    rosbag.write_bag(tmp_path / "t.bag", _tseq(js), max_range=15.0)
    j, t = rosbag.read_bag(tmp_path / "j.bag"), rosbag.read_bag(
        tmp_path / "t.bag")
    assert sorted(j) == sorted(t) == ["/odom", "/scan"]
    for (_, mj), (_, mt) in zip(j["/scan"], t["/scan"]):
        np.testing.assert_array_equal(mj["ranges"], mt["ranges"])
    pj = np.stack([m["pose"] for _, m in j["/odom"]])
    pt = np.stack([m["pose"] for _, m in t["/odom"]])
    np.testing.assert_allclose(pt, pj, rtol=0, atol=2e-6)


def test_bag_topic_listing_and_selection(tmp_path):
    js = _jseq()
    path = tmp_path / "named.bag"
    rosbag.write_bag(path, _tseq(js), scan_topic="/base_scan",
                     odom_topic="/robot/odom")
    assert rosbag._topic_types(path) == jbag._topic_types(str(path)) == {
        "/base_scan": rosbag.LASERSCAN_TYPE,
        "/robot/odom": rosbag.ODOM_TYPE,
    }
    t, _ = rosbag.read_bag_sequence(path, scan_topic="/base_scan",
                                    odom_topic="/robot/odom", device=CPU)
    assert tuple(t.ranges.shape) == tuple(js.ranges.shape)
    with pytest.raises(KeyError):
        rosbag.read_bag_sequence(path, scan_topic="/none", device=CPU)


def test_bag_nan_and_inf_ranges(tmp_path):
    """inf (no return) and NaN beams are masked out; the arrays stay
    finite, as in the reference."""
    js = _jseq()
    hit = np.asarray(js.hit)
    dirty = np.where(hit, np.asarray(js.ranges), np.inf).astype(np.float32)
    dirty[0, :5] = np.nan
    expect = hit.copy()
    expect[0, :5] = False
    seq = Sequence(torch.tensor(dirty), torch.ones(hit.shape, dtype=bool),
                   torch.tensor(np.asarray(js.odom)),
                   torch.tensor(np.asarray(js.gt)))
    path = tmp_path / "dirty.bag"
    rosbag.write_bag(path, seq, max_range=15.0)
    t, _ = rosbag.read_bag_sequence(path, max_range=15.0, device=CPU)
    j, _ = jbag.read_bag_sequence(str(path), max_range=15.0)
    assert np.isfinite(t.ranges.numpy()).all()
    np.testing.assert_array_equal(t.hit.numpy(), expect)
    _same_sequence(t, j)


def _archive(path, mat):
    """A boost text archive of an Eigen::Affine3d (saveAffine3d)."""
    vals = " ".join(repr(float(v)) for v in np.asarray(mat).ravel(order="F"))
    path.write_text(f"22 serialization::archive 12 0 0 {vals}\n")


def _demo_dir(tmp_path, n=4):
    rng = np.random.default_rng(2)
    d = tmp_path / "FULL GRAPH"
    d.mkdir()

    def mat(x, y, th):
        m = np.eye(4)
        m[:2, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
        m[:2, 3] = [x, y]
        m[2, 3] = 1e-3 * rng.normal()
        return m

    for i in range(n):
        for suffix in ("", "local_odom", "local_fuse"):
            _archive(d / f"mapping{i}{suffix}.T",
                     mat(*rng.normal(size=2) * 3, rng.uniform(-3, 3)))
    _archive(d / "mapping", mat(0.12, -0.05, 0.1))
    text = (d / "mapping").read_text().split()
    text[5:5] = ["0.25", "50.5", "50.5", "3.5", "22.5"]
    (d / "mapping").write_text(" ".join(text) + "\n")
    return d


def test_reference_data_loads_as_the_reference(tmp_path):
    d = _demo_dir(tmp_path)
    got = reference_data.load_demo_graph(str(d))
    want = jref.load_demo_graph(str(d))
    assert got._fields == want._fields
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert got.T.shape == (4, 3) and got.resolution == 0.25
    np.testing.assert_array_equal(
        reference_data.load_affine3d_text(str(d / "mapping2.T")),
        jref.load_affine3d_text(str(d / "mapping2.T")))
    with pytest.raises(FileNotFoundError):
        reference_data.load_demo_graph(str(tmp_path))


@pytest.mark.parametrize("shape", [(), (7,), (2, 3)])
def test_se2_matrix_round_trips_match_jax(shape):
    rng = np.random.default_rng(len(shape))
    p = rng.uniform(-3, 3, shape + (3,)).astype(np.float32)
    tp, jp = torch.tensor(p), jnp.asarray(p)
    for tf, jf in ((se2.to_matrix3, jse2.to_matrix3),
                   (se2.to_matrix4, jse2.to_matrix4)):
        np.testing.assert_allclose(tf(tp).numpy(), np.asarray(jf(jp)),
                                   rtol=0, atol=1e-6)
    m3 = se2.to_matrix3(tp)
    m4 = se2.to_matrix4(tp)
    np.testing.assert_allclose(se2.from_matrix3(m3).numpy(),
                               np.asarray(jse2.from_matrix3(jnp.asarray(
                                   m3.numpy()))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(se2.from_matrix4(m4).numpy(),
                               np.asarray(jse2.from_matrix4(jnp.asarray(
                                   m4.numpy()))), rtol=0, atol=1e-6)
    back = se2.from_matrix4(m4).numpy()
    d = np.arctan2(np.sin(back[..., 2] - p[..., 2]),
                   np.cos(back[..., 2] - p[..., 2]))
    np.testing.assert_allclose(back[..., :2], p[..., :2], atol=1e-6)
    np.testing.assert_allclose(d, 0.0, atol=1e-6)


def test_io_modules_import_no_jax():
    import subprocess
    import sys

    code = ("import sys; import ndt_feature_graph_tpu_torch.io.carmen, "
            "ndt_feature_graph_tpu_torch.io.rosbag, "
            "ndt_feature_graph_tpu_torch.io.eval_sim, "
            "ndt_feature_graph_tpu_torch.io.reference_data, "
            "ndt_feature_graph_tpu_torch.utils.pairwise; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.startswith('ndt_feature_graph_tpu.') "
            "or m == 'ndt_feature_graph_tpu']; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    assert shutil.which("g++")
