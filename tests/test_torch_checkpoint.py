"""Checkpoints between the JAX package and the port (io/serialize.py,
NDTFeatureGraphSLAM.save / load): the reference's frozen canonical graph
(the first nodes of the loop-closure record's node bank, with its
odometry edges) saved by one framework and loaded by the other.

Everything is compared bit for bit: leaves are stored as they are, and
a packed table rebuilt from means / covs / valid is the same float32
stack in both frameworks.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_feature_graph_tpu.config import (
    FeatureParams as JFeatureParams, FuserParams as JFuserParams,
    NDTMapParams as JNDTMapParams, SLAMParams as JSLAMParams,
)
from ndt_feature_graph_tpu.graph import node as jnode
from ndt_feature_graph_tpu.graph.slam import NDTFeatureGraphSLAM as JSLAM
from ndt_feature_graph_tpu.io import serialize as jser
from ndt_feature_graph_tpu_torch import interop
from ndt_feature_graph_tpu_torch.graph import node as node_mod
from ndt_feature_graph_tpu_torch.graph.slam import NDTFeatureGraphSLAM
from ndt_feature_graph_tpu_torch.io import serialize as tser

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "make_torch_port_fixture",
    ROOT / "examples" / "make_torch_port_fixture.py")
fixture_gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixture_gen)
N_NODES = 4

# The canonical width (chip_smoke.canonical_slam_params): 200 x 200
# cells, 1024 cells a node, 720 beams.
JPARAMS = JSLAMParams(fuser=JFuserParams(
    ndt=JNDTMapParams(resolution=0.5, size_x=100.0, size_y=100.0,
                      sensor_range=30.0, max_points_per_scan=720,
                      max_cells=1024),
    features=JFeatureParams(num_beams=720, max_range=30.0)))
TPARAMS = interop.params_from_jax(JPARAMS)


def _lc():
    d = dict(np.load(ROOT / "ndt_feature_graph_tpu_torch" / "data"
                     / "canonical_lc.npz"))
    n = N_NODES
    out = {k: v[:n] for k, v in d.items() if k.startswith("off_bank.")}
    out["off_node_T_before"] = d["off_node_T_before"][:n]
    keep = d["off_edge_ij"][:, 1] < n
    for k in ("off_edge_ij", "off_edge_rel", "off_edge_cov"):
        out[k] = d[k][keep]
    return out


def _graphs():
    """The same frozen graph in both frameworks, with a trajectory and
    times as the online pass leaves them."""
    lc = _lc()
    jslam = fixture_gen.jax_graph_from_lc(lc, JPARAMS)
    traj = np.cumsum(np.full((7, 3), 0.1, np.float32), 0)
    jslam.trajectory = [t.copy() for t in traj]
    jslam.times = [float(t) for t in range(7)]
    edges = zip(lc["off_edge_ij"][:, 0], lc["off_edge_ij"][:, 1],
                lc["off_edge_rel"], lc["off_edge_cov"])
    tslam = interop.graph_from_jax(TPARAMS,
                                   interop.tree_from_flat(lc, "off_bank"),
                                   lc["off_node_T_before"], edges,
                                   device="cpu")
    tslam.trajectory = [t.copy() for t in traj]
    tslam.times = [float(t) for t in range(7)]
    return jslam, tslam


def _leaves(slam, jax_side):
    """{checkpoint key: numpy leaf} of a graph's saved tree."""
    stacked = (jnode.stack_nodes(slam.nodes) if jax_side
               else node_mod.stack_nodes(slam.nodes))
    flat = (jax.tree_util.tree_flatten_with_path(stacked)[0] if jax_side
            else tser._leaves_with_path(stacked))
    out = {}
    for p, leaf in flat:
        key = "nodes/" + (jser._path_str(p) if jax_side else "/".join(p))
        out[key] = (np.asarray(leaf) if jax_side
                    else leaf.detach().cpu().numpy())
    out["node_T"] = np.stack(slam.node_T).astype(np.float32)
    out["trajectory"] = np.stack(slam.trajectory).astype(np.float32)
    out["times"] = np.asarray(slam.times, np.float32)
    for k, idx in (("odom_i", 0), ("odom_j", 1)):
        out[k] = np.asarray([e[idx] for e in slam.odom_edges], np.int32)
    out["odom_rel"] = np.stack([e[2] for e in slam.odom_edges])
    out["odom_cov"] = np.stack([e[3] for e in slam.odom_edges])
    return out


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_leaf_keys_equal_the_reference_paths():
    """The port's leaf keys are the strings the reference's _path_str
    makes, in the reference's flattening order."""
    jslam, tslam = _graphs()
    jkeys = [jser._path_str(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(
                 {"nodes": jnode.stack_nodes(jslam.nodes), "b": [1, 2],
                  "a": jnp.zeros(1)})[0]]
    tkeys = [tser._path_str(p) for p, _ in tser._leaves_with_path(
        {"nodes": node_mod.stack_nodes(tslam.nodes), "b": [1, 2],
         "a": torch.zeros(1)})]
    assert jkeys == tkeys
    assert "nodes/target/packed" in tkeys and "b/1" in tkeys


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    jslam, _ = _graphs()
    path = tmp_path / "jax_graph.npz"
    jslam.save(path)
    loaded = NDTFeatureGraphSLAM.load(path, TPARAMS, device="cpu")
    _assert_same(_leaves(jslam, True), _leaves(loaded, False))
    assert loaded.nodes[0].T.device.type == "cpu"


def test_port_checkpoint_loads_into_jax(tmp_path):
    jslam, tslam = _graphs()
    path = tmp_path / "port_graph.npz"
    tslam.save(path)
    loaded = JSLAM.load(path, JPARAMS)
    _assert_same(_leaves(tslam, False), _leaves(loaded, True))
    # The two frameworks write the same arrays under the same keys.
    jpath = tmp_path / "jax_graph.npz"
    jslam.save(jpath)
    with np.load(path) as a, np.load(jpath) as b:
        _assert_same(dict(a), dict(b))


def test_checkpoint_without_packed_derives_it(tmp_path):
    """A checkpoint from before the slim target (means / covs / valid
    stored, no packed table) loads through derive_packed, in the port as
    in the reference, to the packed table bit for bit."""
    jslam, _ = _graphs()
    path = tmp_path / "graph.npz"
    jslam.save(path)
    data = dict(np.load(path))
    packed = data.pop("nodes/target/packed")
    f = packed.reshape(N_NODES, 200, 200, 8)
    data["nodes/target/means"] = f[..., :2]
    data["nodes/target/covs"] = np.stack(
        [np.stack([f[..., 2], f[..., 3]], -1),
         np.stack([f[..., 3], f[..., 4]], -1)], -2)
    data["nodes/target/valid"] = f[..., 5] > 0.5
    old = tmp_path / "old_graph.npz"
    np.savez_compressed(old, **data)
    np.testing.assert_array_equal(
        tser.derive_packed("nodes/target/packed", np.load(old)), packed)
    np.testing.assert_array_equal(
        jser.derive_packed("nodes/target/packed", np.load(old)), packed)
    loaded = NDTFeatureGraphSLAM.load(old, TPARAMS, device="cpu")
    np.testing.assert_array_equal(
        node_mod.stack_nodes(loaded.nodes).target.packed.numpy(), packed)
    with pytest.raises(KeyError):
        tser.derive_packed("nodes/occ", np.load(old))


def test_pytree_round_trip_and_missing_leaf(tmp_path):
    """save_pytree / load_pytree on a mixed tree: dtypes and values come
    back; a leaf the file lacks raises without a derive handler."""
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.tensor([True, False]),
                       "c": torch.tensor(7, dtype=torch.int32)}}
    p = tmp_path / "t.npz"
    tser.save_pytree(p, tree)
    back = tser.load_pytree(p, {"a": torch.zeros(2, 3),
                                "nested": {"b": torch.zeros(2, dtype=bool),
                                           "c": torch.zeros((), dtype=
                                                            torch.int32)}})
    for k in ("a",):
        assert torch.equal(back[k], tree[k])
    assert torch.equal(back["nested"]["b"], tree["nested"]["b"])
    assert back["nested"]["c"].dtype == torch.int32
    assert int(back["nested"]["c"]) == 7
    with pytest.raises(KeyError, match="missing leaf"):
        tser.load_pytree(p, {"zz": torch.zeros(1)})
    # The reference reads the same file.
    jback = jser.load_pytree(p, jax.tree.map(
        lambda x: jnp.zeros(x.shape, x.numpy().dtype), tree))
    np.testing.assert_array_equal(np.asarray(jback["a"]), tree["a"].numpy())
