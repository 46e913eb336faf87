"""The port's public surface against the JAX reference's, read from the
sources with `ast` (neither package is imported).

A module's public names are its top-level functions, classes and their
methods, its top-level assignments (aliases), and the names it imports
with `from ... import` from outside the package (typing names and the
like); a package's `__init__.py` also re-exports what it imports from
the package.  Names starting with "_" are private.  Every public name of
the reference must have its namesake at the same place in the port,
except the deliberate non-ports below, each with its reason; an entry
that no longer excuses a missing name is stale and fails too.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = "ndt_feature_graph_tpu"
PORT_PKG = "ndt_feature_graph_tpu_torch"

_XLA_LAYOUT = ("an XLA gather layout: the port's fused gather reads the "
               "packed table, to which this layout is exact (bench.py:82-85)")

NOT_PORTED = {
    "ops.pallas_kernels:pair_fgh_reduce":
        "the Pallas kernel; its port is csrc/pair_fgh.cu, bound in "
        "ops/cuda_kernels.py",
    "ops.d2d:build_window_tables": _XLA_LAYOUT,
    "ops.d2d:build_window_block_tables": _XLA_LAYOUT,
    "ops.d2d:build_wide_table": _XLA_LAYOUT,
    "ops.d2d:wide_row_stride": _XLA_LAYOUT,
    "ops.d2d_analytic:fgh_dense_window_batch": _XLA_LAYOUT,
    "ops.d2d_analytic:fgh_dense_block_batch": _XLA_LAYOUT,
    "ops.d2d_analytic:fgh_dense_wide_batch": _XLA_LAYOUT,
    "graph.optimize:f32_matmul":
        "an XLA matmul precision pin; the port turns TF32 off in its "
        "__init__.py",
    "io.reference_data:DEMO_GRAPH_DIR":
        "an absolute path on the reference's own build machine; the "
        "port's load_demo_graph takes the directory as an argument",
}

# Names a module imports from outside the package for its own use: not
# API, wherever the reference imports them.
TYPING_IMPORTS = {
    "NamedTuple": "typing base of the reference's result tuples",
    "NamedSharding": "jax.sharding type",
    "P": "jax.sharding.PartitionSpec alias",
    "Mesh": "jax.sharding type",
    "shard_map": "JAX transform",
    "Ellipse": "matplotlib patch class",
    "annotations": "__future__ feature",
    "pl": "jax.experimental.pallas",
    "pltpu": "jax.experimental.pallas.tpu",
}


def _module_name(path, root):
    parts = list(path.relative_to(root).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def public_names(pkg):
    """{"module:name"} and {"module:name" imported from outside} of a
    package, by the rule of the module docstring."""
    root = ROOT / pkg
    names, external = set(), set()
    for path in sorted(root.rglob("*.py")):
        mod = _module_name(path, root)
        is_init = path.name == "__init__.py"
        for node in ast.parse(path.read_text()).body:
            found = []
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                found.append(node.name)
            elif isinstance(node, ast.ClassDef):
                found.append(node.name)
                found += [f"{node.name}.{b.name}" for b in node.body
                          if isinstance(b, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))]
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                found += [t.id for t in targets if isinstance(t, ast.Name)]
            elif isinstance(node, ast.ImportFrom):
                inside = node.level > 0 or (node.module or "").split(
                    ".")[0] == pkg
                if is_init or not inside:
                    for a in node.names:
                        found.append(a.asname or a.name)
                        if not inside:
                            external.add(f"{mod}:{a.asname or a.name}")
            names.update(f"{mod}:{n}" for n in found
                         if not n.split(".")[-1].startswith("_"))
    return names, external


def _excuse(name, external):
    """The allowlist entry that excuses a missing reference name."""
    if name in NOT_PORTED:
        return name
    bare = name.split(":", 1)[1]
    if name in external and bare in TYPING_IMPORTS:
        return bare
    return None


@pytest.fixture(scope="module")
def surfaces():
    return public_names(JAX_PKG), public_names(PORT_PKG)[0]


def test_every_public_reference_name_has_its_port(surfaces):
    (ref, external), port = surfaces
    assert len(ref) > 300
    missing = sorted(n for n in ref - port if _excuse(n, external) is None)
    assert not missing, f"public JAX names without a port: {missing}"


def test_no_stale_allowlist_entry(surfaces):
    """Each entry still excuses a reference name the port lacks: a name
    the port gained (or the reference dropped) must leave the list."""
    (ref, external), port = surfaces
    used = {_excuse(n, external) for n in ref - port}
    stale = sorted((set(NOT_PORTED) | set(TYPING_IMPORTS)) - used)
    assert not stale, f"allowlist entries that excuse nothing: {stale}"
    for name in NOT_PORTED:
        assert name in ref and name not in port, name


def test_the_walk_sees_what_it_should(surfaces):
    """The rule's own cases on names known to either side: defs,
    methods, properties, aliases, package exports, module imports."""
    (ref, external), port = surfaces
    for name in ("fusion.scan_driver:run_graph_chunk",
                 "ops.hmt:HMTMap.add_scan", "ops.ndt_map:NDTGrid.shape",
                 "graph.sparse_direct:chain_coupling", "features:match_sets",
                 ":FuserParams", "core:se2"):
        assert name in ref and name in port, name
    assert "ops.pallas_kernels:jnp" not in ref        # `import x as y`
    assert "graph.links:ndt_map" not in ref           # in-package module
    assert "ops.d2d:NamedTuple" in external
