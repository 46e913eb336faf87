"""Process groups, device meshes and the shard contract of the multi-device
programs (port of ndt_feature_graph_tpu/parallel/mesh.py).

The reference's programs are single-controller shard_maps; its multi-host
layout passes the FULL arrays on every process, and each process
contributes its own shards.  The port keeps that contract on
torch.distributed, one process per device:

  - every rank calls a sharded function with the full inputs;
  - each rank takes its own padded, masked shard (`shard_rows`);
  - the reference's psum is `dist.all_reduce(SUM)` over the axis' group,
    its out_specs=P(axis) is `gather_rows` (all_gather_into_tensor);
  - results come back replicated on every rank.

Axes: "dp" shards data (submaps, scan streams, link pairs, edges); the
2-D layout ("dcn", "ici") puts processes of different hosts on the outer
axis and a host's local devices on the inner one.  A sharded program
takes `axis` as one name or a tuple of names in mesh order (a tuple
shards over the product, row-major, as P(("dcn", "ici")) does).  A mesh
always spans the whole world: a smaller one raises.  The backend follows
the device: NCCL on CUDA tensors, gloo on the CPU.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ndt_feature_graph_tpu_torch import resolve_device
from ndt_feature_graph_tpu_torch.graph.optimize import Reduction


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, device=None, backend=None,
                     timeout_s: float = 120.0):
    """Join (or form) the default process group: the counterpart of
    jax.distributed.initialize.  `coordinator_address` "host:port" of rank
    0's store, `num_processes` the world size, `process_id` this rank.
    The backend is NCCL when the device (resolve_device(device): the card
    unless "cpu") is CUDA, else gloo; on NCCL the rank's card becomes
    the current device.  Idempotent; a no-op for one process with no
    address, as the reference's is.  Collectives that wait longer than
    `timeout_s` fail."""
    if dist.is_initialized():
        return
    if coordinator_address is None and (num_processes or 1) <= 1:
        return
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    rank = int(process_id or 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes or 1), rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))


def _device_type():
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _world(n):
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first")
    world = dist.get_world_size()
    if n is not None and n != world:
        raise ValueError(f"a mesh of {n} devices in a world of {world} "
                         "processes: a mesh spans the whole world")
    return world


def make_mesh(n_devices=None, axis="dp"):
    """1-D mesh over the world's processes, one device each."""
    n = _world(n_devices)
    return init_device_mesh(_device_type(), (n,), mesh_dim_names=(axis,))


def make_mesh_2d(axes=("dcn", "ici"), local_size=None):
    """2-D (process group, local device) mesh: rows are hosts (collectives
    across rows ride the inter-host network), columns a host's local
    devices.  `local_size`: processes per host (default: the host's card
    count under NCCL, the whole world under gloo).  Rows are
    consecutive ranks, so data laid out over (dcn, ici) keeps each
    host's shard on its own devices.  An uneven split raises."""
    world = _world(None)
    if local_size is None:
        local_size = (torch.cuda.device_count() if _device_type() == "cuda"
                      else world)
    if local_size < 1 or world % local_size:
        raise ValueError(f"uneven devices per host: {world} processes in "
                         f"rows of {local_size}; every host must "
                         "contribute the same local device count")
    return init_device_mesh(_device_type(), (world // local_size, local_size),
                            mesh_dim_names=tuple(axes))


def axis_tuple(axis):
    """Normalize an axis spec (name or tuple of names) to a tuple."""
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_size(mesh, axis):
    """Total shard count over one axis name or a tuple of names."""
    return int(np.prod([mesh.size(mesh.mesh_dim_names.index(a))
                        for a in axis_tuple(axis)]))


def axis_index(mesh, axis):
    """This rank's shard index along `axis` (row-major over a tuple)."""
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    idx = 0
    for a in axis_tuple(axis):
        k = names.index(a)
        idx = idx * mesh.size(k) + coord[k]
    return idx


def axis_group(mesh, axis):
    """The process group of the ranks that share every coordinate off
    `axis`: the collectives of a program sharded over `axis` run in it."""
    axes = axis_tuple(axis)
    names = mesh.mesh_dim_names
    order = [names.index(a) for a in axes]
    if order != sorted(order):
        raise ValueError(f"axes {axes} out of the mesh's order {names}")
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if len(axes) == len(names):
        return dist.group.WORLD
    raise ValueError(f"axes {axes}: one axis, or all of {names}")


def pad_to_multiple(x, multiple, axis=0, fill=0):
    """Pad dimension `axis` of a tensor so it divides evenly across
    shards."""
    rem = (-x.shape[axis]) % multiple
    if rem == 0:
        return x
    shape = list(x.shape)
    shape[axis] = rem
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype,
                                    device=x.device)], axis)


def shard_rows(mesh, x, axis="dp", fill=0):
    """This rank's rows of the full tensor x: x padded with `fill` to a
    multiple of the shard count, then the rank's contiguous block (the
    reference's global_put of P(axis))."""
    n = axis_size(mesh, axis)
    x = pad_to_multiple(x, n, fill=fill)
    rows = x.shape[0] // n
    k = axis_index(mesh, axis)
    return x[k * rows:(k + 1) * rows]


def gather_rows(mesh, x, axis="dp"):
    """Every shard's rows, concatenated in shard order, on every rank (the
    reference's global_get of an array sharded P(axis)).  bool tensors
    travel as uint8."""
    flag = x.dtype == torch.bool
    x = x.to(torch.uint8) if flag else x.contiguous()
    out = torch.empty((axis_size(mesh, axis) * x.shape[0],) + x.shape[1:],
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=axis_group(mesh, axis))
    return out.bool() if flag else out


def _spec_axis(spec):
    """The row axis of a placement spec: a tuple of axis names standing
    for the reference's P(...), the first entry naming the axis (or the
    tuple of axes) that shards rows, trailing Nones for replicated
    dimensions.  None for an empty spec (replicated).  A spec that
    shards any other dimension raises."""
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    if not spec:
        return None
    if len(spec) > 1 or spec[0] is None:
        raise ValueError(f"spec {spec}: the port shards rows only")
    return spec[0]


def replicated(mesh, x):
    """x placed replicated over the mesh: every rank holds the whole
    tensor, which is x itself (each rank passes the full value)."""
    return x


def sharded(mesh, x, axis="dp"):
    """x's rows sharded over `axis`: this rank's block (shard_rows).  As
    the reference's, a row count the shard count does not divide raises
    ValueError; pad first (pad_to_multiple) to place it."""
    n = axis_size(mesh, axis)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not divide into {n} "
                         f"shards over {axis}")
    return shard_rows(mesh, x, axis)


def global_put(mesh, x, spec):
    """The reference's placement of the full array x (every rank passes
    the same) under `spec` (see _spec_axis): the whole tensor for an
    empty spec, else this rank's rows (sharded: rows the shard count
    does not divide raise).  x may be numpy; it lands on the mesh's
    device type."""
    x = torch.as_tensor(x, device=mesh.device_type)
    axis = _spec_axis(spec)
    return replicated(mesh, x) if axis is None else sharded(mesh, x, axis)


def global_get(mesh, x, spec=("dp",)):
    """The full value of a placed tensor on every rank, at its global
    shape, as numpy: the shards gathered in order (gather_rows), or x
    itself when `spec` is empty (replicated)."""
    axis = _spec_axis(spec)
    full = x if axis is None else gather_rows(mesh, x, axis)
    return full.cpu().numpy()


def psum(mesh, x, axis="dp"):
    """The sum of x over the shards of `axis`, on every rank (in place on
    x, which is also returned)."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=axis_group(mesh, axis))
    return x


def reducer(mesh, axis="dp"):
    """The solvers' graph/optimize.Reduction over mesh[axis]: psum, and
    the axis' first shard leads."""
    return Reduction(sum=lambda x: psum(mesh, x, axis),
                     lead=axis_index(mesh, axis) == 0)
