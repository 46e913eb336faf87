"""The native host components (port of ndt_feature_graph_tpu/io/native.py):
the CARMEN log parser and the NGF binary grid codec, over the port's own
copies of the native sources, `native/carmen_parser.cpp` and
`native/gridio.cpp`.

The shared library is compiled from both with the local g++ at first use
into build/native/ at the repository root (keyed by a hash of the
sources and flags) and loaded with ctypes.  A failed build raises: there
is no fallback.  `_read_carmen_py` is the parser's plain Python twin,
which the tests hold the native parser against.  Grid files are byte for
byte the reference's: a grid or HMT tile directory written by either
package loads in the other.  Grids are read and written through numpy on
the host; `read_grid` puts the grid on the device it is asked for.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
from typing import NamedTuple, Optional

import numpy as np
import torch

from ndt_feature_graph_tpu_torch import resolve_device
from ndt_feature_graph_tpu_torch.ops.ndt_map import NDTGrid

_NATIVE = pathlib.Path(__file__).resolve().parents[1] / "native"
SOURCES = (_NATIVE / "gridio.cpp", _NATIVE / "carmen_parser.cpp")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-shared"]
_lib: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    """Build (if these sources are not built yet) and load the library;
    raises if the build fails."""
    global _lib
    if _lib is not None:
        return _lib
    src = b"".join(p.read_bytes() for p in SOURCES)
    key = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / key[:16] / "libndtg_native.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        proc = subprocess.run(
            [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp,
             *map(str, SOURCES)], capture_output=True, text=True)
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
    lib.clf_open.argtypes = [ctypes.c_char_p, P, P]
    lib.clf_open.restype = P
    lib.clf_fill.argtypes = [P, P, P, P, P, F]
    lib.clf_fill.restype = None
    lib.clf_close.argtypes = [P]
    lib.clf_close.restype = None
    _lib = lib
    return lib


class CarmenLog(NamedTuple):
    ranges: np.ndarray       # (T, B) float32, padded with max_range_pad
    beam_counts: np.ndarray  # (T,) int32
    odom_abs: np.ndarray     # (T, 3) float32 absolute odometry
    times: np.ndarray        # (T,) float64


def read_carmen(path, max_range_pad=81.91) -> CarmenLog:
    """Parse a CARMEN .clf log (FLASER / ROBOTLASER1 records) with the
    native parser."""
    lib = load()
    n, mb = ctypes.c_int(), ctypes.c_int()
    h = lib.clf_open(str(path).encode(), ctypes.addressof(n),
                     ctypes.addressof(mb))
    if not h:
        raise FileNotFoundError(path)
    try:
        t, b = n.value, mb.value
        ranges = np.empty((t, b), np.float32)
        counts = np.empty(t, np.int32)
        odom = np.empty((t, 3), np.float32)
        times = np.empty(t, np.float64)
        lib.clf_fill(h, ranges.ctypes.data, counts.ctypes.data,
                     odom.ctypes.data, times.ctypes.data, max_range_pad)
    finally:
        lib.clf_close(h)
    return CarmenLog(ranges, counts, odom, times)


def _read_carmen_py(path, max_range_pad=81.91) -> CarmenLog:
    """Plain Python twin of the native parser (FLASER records only)."""
    scans = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0] != "FLASER":
                continue
            n = int(parts[1])
            r = np.asarray(parts[2 : 2 + n], np.float32)
            odom = np.asarray(parts[2 + n + 3 : 2 + n + 6], np.float32)
            t = float(parts[2 + n + 6]) if len(parts) > 2 + n + 6 else 0.0
            scans.append((r, odom, t))
    if not scans:
        return CarmenLog(
            np.zeros((0, 0), np.float32),
            np.zeros(0, np.int32),
            np.zeros((0, 3), np.float32),
            np.zeros(0, np.float64),
        )
    mb = max(len(s[0]) for s in scans)
    t = len(scans)
    ranges = np.full((t, mb), max_range_pad, np.float32)
    counts = np.empty(t, np.int32)
    odom = np.empty((t, 3), np.float32)
    times = np.empty(t, np.float64)
    for k, (r, o, tt) in enumerate(scans):
        ranges[k, : len(r)] = r
        counts[k] = len(r)
        odom[k] = o
        times[k] = tt
    return CarmenLog(ranges, counts, odom, times)


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
