"""Parity of the PyTorch port's geometry, motion model and scan plumbing
with the JAX reference: the same numpy inputs through both sides, atol
1e-6 (float32 trigonometry differs at ulp level between XLA and
PyTorch's CPU kernels)."""

import dataclasses
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_feature_graph_tpu import config as jconfig
from ndt_feature_graph_tpu.config import MotionParams
from ndt_feature_graph_tpu.core import motion_model as jmm
from ndt_feature_graph_tpu.core import se2 as jse2
from ndt_feature_graph_tpu.io import dataset as jds
from ndt_feature_graph_tpu_torch import config as tconfig
from ndt_feature_graph_tpu_torch import interop
from ndt_feature_graph_tpu_torch.core import motion_model as tmm
from ndt_feature_graph_tpu_torch.core import se2 as tse2
from ndt_feature_graph_tpu_torch.io import dataset as tds

torch.set_num_threads(2)
ATOL = 1e-6


def _poses(rng, n, spread=5.0):
    p = rng.normal(0.0, spread, (n, 3)).astype(np.float32)
    p[:, 2] = rng.uniform(-np.pi, np.pi, n)
    return p


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=0, atol=atol)


@pytest.mark.parametrize(
    "name", ["compose", "sub", "inverse", "normalize_angle", "adjoint",
             "dist", "angular_dist"]
)
def test_se2_pose_ops_match_jax(name):
    rng = np.random.default_rng(0)
    a, b = _poses(rng, 64), _poses(rng, 64)
    if name == "angular_dist":   # heading differences beyond +-pi wrap
        assert (np.abs(a[:, 2] - b[:, 2]) > np.pi).sum() >= 8
    if name == "inverse":
        _close(jse2.inverse(jnp.asarray(a)), tse2.inverse(torch.tensor(a)))
    elif name == "normalize_angle":
        ang = rng.uniform(-20, 20, 256).astype(np.float32)
        _close(jse2.normalize_angle(jnp.asarray(ang)),
               tse2.normalize_angle(torch.tensor(ang)))
    elif name == "adjoint":
        _close(jse2.adjoint(jnp.asarray(a)), tse2.adjoint(torch.tensor(a)),
               atol=1e-5)
    else:
        fj, ft = getattr(jse2, name), getattr(tse2, name)
        _close(fj(jnp.asarray(a), jnp.asarray(b)),
               ft(torch.tensor(a), torch.tensor(b)), atol=1e-5)


def test_adjoint_inverse_matches_linalg_inv():
    rng = np.random.default_rng(1)
    a = _poses(rng, 32)
    ref = np.linalg.inv(np.asarray(jse2.adjoint(jnp.asarray(a)), np.float64))
    np.testing.assert_allclose(
        tse2.adjoint_inverse(torch.tensor(a)).numpy(), ref, atol=1e-5
    )


def test_points_and_covariances_match_jax():
    rng = np.random.default_rng(2)
    pose = _poses(rng, 1)[0]
    pts = rng.normal(0, 10, (100, 2)).astype(np.float32)
    L = rng.normal(0, 0.3, (100, 2, 2)).astype(np.float32)
    covs = L @ L.transpose(0, 2, 1)
    _close(jse2.transform_points(jnp.asarray(pose), jnp.asarray(pts)),
           tse2.transform_points(torch.tensor(pose), torch.tensor(pts)),
           atol=1e-5)
    _close(jse2.rotate_covs(jnp.asarray(pose[2]), jnp.asarray(covs)),
           tse2.rotate_covs(torch.tensor(pose[2]), torch.tensor(covs)))
    a, b = _poses(rng, 8), _poses(rng, 8)
    np.testing.assert_array_equal(jse2.compose_np(a, b),
                                  tse2.compose_np(a, b))


def test_motion_model_matches_jax():
    rng = np.random.default_rng(3)
    rel = rng.normal(0, 0.3, (50, 3)).astype(np.float32)
    mp = MotionParams()
    tmp = interop.params_from_jax(mp)
    _close(jmm.measurement_cov(mp, jnp.asarray(rel)),
           tmm.measurement_cov(tmp, torch.tensor(rel)))
    np.testing.assert_allclose(
        np.asarray(jmm.odometry_information(mp, jnp.asarray(rel))),
        tmm.odometry_information(tmp, torch.tensor(rel)).numpy(),
        rtol=1e-6,
    )


@pytest.mark.parametrize("beams", [360, 720])
def test_beam_angles_match_jnp_linspace(beams):
    """One helper holds the scan's beam angles.  XLA's float32 linspace
    is not fixed bit for bit (its eager and jitted forms differ in a few
    entries), so the port is held to one ulp of it."""
    ref = np.asarray(jnp.linspace(-np.pi, np.pi, beams, endpoint=False))
    got = tds.beam_angles(beams, device="cpu").numpy()
    ulps = np.abs(got.astype(np.float64) - ref) / np.spacing(np.abs(ref))
    assert ulps.max() <= 1.0
    assert (got != ref).sum() <= 5


def test_scan_to_points_matches_jax():
    rng = np.random.default_rng(4)
    ranges = rng.uniform(0.5, 30.0, 720).astype(np.float32)
    hit = rng.random(720) < 0.8
    pj, mj = jds.scan_to_points(jnp.asarray(ranges), jnp.asarray(hit))
    pt, mt = tds.scan_to_points(torch.tensor(ranges), torch.tensor(hit))
    _close(pj, pt, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(mj), mt.numpy())


def test_load_sequence_roundtrip(tmp_path):
    rng = np.random.default_rng(5)
    seq = jds.Sequence(
        ranges=rng.uniform(0, 30, (4, 16)).astype(np.float32),
        hit=rng.random((4, 16)) < 0.5,
        odom=rng.normal(0, 1, (4, 3)).astype(np.float32),
        gt=rng.normal(0, 1, (4, 3)).astype(np.float32),
    )
    path = tmp_path / "seq.npz"
    jds.save_sequence(path, seq)
    got = tds.load_sequence(path, device="cpu")
    for name in ("ranges", "hit", "odom", "gt"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(seq, name))
    assert got.hit.dtype == torch.bool


def test_loaders_default_to_the_card_and_raise_without_one(tmp_path):
    """`device=None` means the CUDA card: where there is none the loaders
    raise instead of landing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default lands on it")
    path = tmp_path / "seq.npz"
    np.savez(path, ranges=np.zeros((2, 8), np.float32),
             hit=np.zeros((2, 8), bool), odom=np.zeros((2, 3), np.float32),
             gt=np.zeros((2, 3), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tds.load_sequence(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tds.beam_angles(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.cell_list_from_jax({
            "means": np.zeros((1, 2), np.float32),
            "covs": np.zeros((1, 2, 2), np.float32),
            "mask": np.zeros(1, bool)})


PARAM_CLASSES = ["MotionParams", "NDTMapParams", "MatcherParams",
                 "FeatureParams", "FuserParams", "GraphParams", "SLAMParams"]


@pytest.mark.parametrize("name", PARAM_CLASSES)
def test_params_from_jax_round_trip(name):
    """Each class of the JAX config tree becomes the port's class of the
    same name with the same repr, at the defaults and at the canonical
    operating point's values."""
    jp = getattr(jconfig, name)()
    if name == "SLAMParams":
        jp = jconfig.SLAMParams(
            fuser=jconfig.FuserParams(
                ndt=jconfig.NDTMapParams(
                    resolution=0.5, size_x=100.0, size_y=100.0,
                    sensor_range=30.0, max_points_per_scan=720,
                    max_cells=1024),
                features=jconfig.FeatureParams(num_beams=720,
                                               max_range=30.0),
                match_cell_budget=256, gather_window_cells=136,
                gather_block=True),
            graph=jconfig.GraphParams(new_node_transl_dist=0.25,
                                      online_loop_closure=True))
    tp = interop.params_from_jax(jp)
    assert type(tp) is getattr(tconfig, name)
    assert repr(tp) == repr(jp)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    if name == "SLAMParams":
        assert type(tp.fuser.ndt) is tconfig.NDTMapParams
        assert (tp.fuser.ndt.grid_h, tp.fuser.ndt.grid_w) == (200, 200)
        assert tp.replace(min_incr_dist=0.5).min_incr_dist == 0.5


def test_params_from_jax_rejects_differing_fields():
    with pytest.raises(TypeError):
        interop.params_from_jax(3.0)
    odd = dataclasses.make_dataclass("MotionParams", [("Cd", float, 0.1)])
    with pytest.raises(ValueError, match="fields differ"):
        interop.params_from_jax(odd())


def test_port_imports_without_jax():
    """Importing every module of the port and chip_smoke leaves neither
    jax* nor the JAX package (ndt_feature_graph_tpu, any submodule) in
    sys.modules, and starts no CUDA; the package exports and the chunked
    graph driver import by their reference names."""
    code = (
        "import sys, importlib, pkgutil, torch\n"
        "from ndt_feature_graph_tpu_torch import (FuserParams, GraphParams,\n"
        "    MatcherParams, MotionParams, NDTMapParams)\n"
        "from ndt_feature_graph_tpu_torch.core import se2, motion_model\n"
        "from ndt_feature_graph_tpu_torch.features import (FeatureSet,\n"
        "    detect, describe, symmetric_chi2_matrix, MatchResult,\n"
        "    match_sets)\n"
        "from ndt_feature_graph_tpu_torch.models import (canonical_slam,\n"
        "    feature_graph_slam, mcl_localizer, ndt_odometry,\n"
        "    offline_mapper, p2d_registration)\n"
        "from ndt_feature_graph_tpu_torch.fusion.scan_driver import (\n"
        "    run_graph_chunk)\n"
        "assert not torch.cuda.is_initialized()\n"
        "import ndt_feature_graph_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "for m in ('models.presets', 'parallel.scaling', 'graph.sparse',\n"
        "          'graph.sparse_direct', 'graph.schur', 'io.serialize',\n"
        "          'utils.occupancy', 'cli', 'ops.distance_field',\n"
        "          'ops.hmt', 'io.native', 'fusion.hmt_driver',\n"
        "          'localization.mcl', 'localization.monitor',\n"
        "          'localization.place_rec', 'core.se3', 'ops.d2d3d',\n"
        "          'parallel.mesh', 'parallel.solver_sharded',\n"
        "          'parallel.schur_sharded',\n"
        "          'parallel.sparse_direct_sharded',\n"
        "          'parallel.links_sharded', 'utils.timers',\n"
        "          'utils.logging_ext', 'viz.plot', 'viz.html'):\n"
        "    assert p.__name__ + '.' + m in sys.modules, m\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'ndt_feature_graph_tpu'))\n"
        "assert not bad, bad\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "assert not torch.cuda.is_initialized()\n"
    )
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
