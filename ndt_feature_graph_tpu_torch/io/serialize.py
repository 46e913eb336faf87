"""Checkpointing: a tree of tensors <-> npz (port of
ndt_feature_graph_tpu/io/serialize.py).

One self-describing npz per checkpoint, every leaf keyed by its path in
the tree: dataclass field names, dict keys and sequence indices joined
by "/" — the strings the reference's `_path_str` makes from
`jax.tree_util.tree_flatten_with_path`, whose NamedTuples carry the
same field names as the port's dataclasses.  So a checkpoint the JAX
package wrote loads here, and one written here loads there.  Loading
takes a template tree for structure, dtypes and device.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch


def _leaves_with_path(tree, path=()):
    """[(path tuple, leaf)] in the reference's flattening order: dict keys
    sorted, dataclass fields in declaration order, sequences by index."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = []
        for f in dataclasses.fields(tree):
            out += _leaves_with_path(getattr(tree, f.name), path + (f.name,))
        return out
    if isinstance(tree, Mapping):
        out = []
        for k in sorted(tree):
            out += _leaves_with_path(tree[k], path + (str(k),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _leaves_with_path(v, path + (str(i),))
        return out
    return [(path, tree)]


def _path_str(path):
    return "/".join(path) if path else "_root"


def _to_numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path, tree, exclude_suffixes=()):
    """Save every leaf keyed by its path; leaves whose key ends with one
    of `exclude_suffixes` are left out (a loader's `derive` rebuilds
    them)."""
    arrays = {}
    for p, leaf in _leaves_with_path(tree):
        key = _path_str(p)
        if any(key.endswith(s) for s in exclude_suffixes):
            continue
        arrays[key] = _to_numpy(leaf)
    np.savez_compressed(path, **arrays)


def _rebuild(tree, leaves):
    """`tree`'s structure with its leaves taken in order from the
    iterator `leaves`."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: _rebuild(getattr(tree, f.name), leaves)
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, Mapping):
        vals = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: vals[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def load_pytree(path, template, derive=None):
    """`template`'s structure with arrays from the file, as tensors of
    each template leaf's dtype on its device.  `derive(key, data)` is
    called for a leaf the file lacks; without it (or when it raises
    KeyError) a missing leaf raises KeyError."""
    out = []
    with np.load(path, allow_pickle=False) as data:
        for p, leaf in _leaves_with_path(template):
            key = _path_str(p)
            if key in data:
                arr = data[key]
            elif derive is not None:
                arr = derive(key, data)
            else:
                raise KeyError(f"checkpoint {path} missing leaf {key!r}")
            out.append(torch.as_tensor(np.asarray(arr), dtype=leaf.dtype,
                                       device=leaf.device))
    return _rebuild(template, iter(out))


def derive_packed(key, data):
    """`derive` handler for a target's packed table: rebuild the
    channel-packed (H*W, 8) rows from the sibling means / covs / valid
    arrays (d2d.pack_rows), for one target or a stacked node bank with a
    leading N axis — the checkpoints written before the slim target."""
    if not key.endswith("/packed"):
        raise KeyError(key)
    from ndt_feature_graph_tpu_torch.ops import d2d

    prefix = key[: -len("packed")]
    means, covs, valid = (torch.as_tensor(np.asarray(data[prefix + k]))
                          for k in ("means", "covs", "valid"))
    return d2d.pack_rows(means, covs, valid).flatten(-3, -2).numpy()
