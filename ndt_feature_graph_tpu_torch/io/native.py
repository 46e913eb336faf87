"""The NGF binary grid codec (port of the grid half of
ndt_feature_graph_tpu/io/native.py), over the port's own copy of the
native source, `native/gridio.cpp`.

The shared library is compiled with the local g++ at first use into
build/native/ at the repository root (keyed by a hash of the source)
and loaded with ctypes.  Files are byte for byte the reference's: a
grid or HMT tile directory written by either package loads in the
other.  Grids are read and written through numpy on the host; `read_grid`
puts the grid on the device it is asked for.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
from typing import Optional

import numpy as np
import torch

from ndt_feature_graph_tpu_torch import resolve_device
from ndt_feature_graph_tpu_torch.ops.ndt_map import NDTGrid

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "native" / "gridio.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-shared"]
_lib: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    """Build (if this source is not built yet) and load the codec."""
    global _lib
    if _lib is not None:
        return _lib
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / key[:16] / "libngf.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        proc = subprocess.run(
            [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp,
             str(SOURCE)], capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ngf_write.argtypes = [ctypes.c_char_p, I, I, P, F, P, P, P, P]
    lib.ngf_write.restype = I
    lib.ngf_header.argtypes = [ctypes.c_char_p, P, P, P, P]
    lib.ngf_header.restype = I
    lib.ngf_read.argtypes = [ctypes.c_char_p, P, P, P, P]
    lib.ngf_read.restype = I
    _lib = lib
    return lib


def _host(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(x, np.float32)


def write_grid(path, grid, resolution: float):
    """Write one grid (tensors or numpy arrays in NDTGrid's fields) as an
    NGF file."""
    lib = load()
    count = _host(grid.count)
    h, w = count.shape
    origin, psum, outer, occ = (_host(grid.origin), _host(grid.psum),
                                _host(grid.outer), _host(grid.occ))
    if (origin.shape != (2,) or psum.shape != (h, w, 2)
            or outer.shape != (h, w, 2, 2) or occ.shape != (h, w)):
        raise ValueError("write_grid takes one (H, W) grid")
    rc = lib.ngf_write(str(path).encode(), h, w, origin.ctypes.data,
                       resolution, count.ctypes.data, psum.ctypes.data,
                       outer.ctypes.data, occ.ctypes.data)
    if rc != 0:
        raise IOError(f"ngf_write({path}) failed: {rc}")


def read_grid(path, device=None):
    """Read an NGF file -> (NDTGrid on `device` (the card unless given),
    resolution)."""
    dev = resolve_device(device)
    lib = load()
    h, w = ctypes.c_int(), ctypes.c_int()
    origin = np.empty(2, np.float32)
    res = ctypes.c_float()
    rc = lib.ngf_header(str(path).encode(), ctypes.addressof(h),
                        ctypes.addressof(w), origin.ctypes.data,
                        ctypes.addressof(res))
    if rc != 0:
        raise IOError(f"ngf_header({path}) failed: {rc}")
    h, w = h.value, w.value
    count = np.empty((h, w), np.float32)
    psum = np.empty((h, w, 2), np.float32)
    outer = np.empty((h, w, 2, 2), np.float32)
    occ = np.empty((h, w), np.float32)
    rc = lib.ngf_read(str(path).encode(), count.ctypes.data,
                      psum.ctypes.data, outer.ctypes.data, occ.ctypes.data)
    if rc != 0:
        raise IOError(f"ngf_read({path}) failed: {rc}")
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return NDTGrid(t(origin), t(count), t(psum), t(outer), t(occ)), res.value
