"""Hand-written Hopper kernels of the registration hot path — the
counterpart of ndt_feature_graph_tpu/ops/pallas_kernels.py.

`csrc/pair_fgh.cu` holds three entries that share one device function
for the per-pair D2D algebra (pallas_kernels._fgh_components):

  * `fgh_dense_flat` — the main path's D2D window term: per Newton trial
    ONE launch forms the trial pose, moves the source cells, gathers
    their (2n+1)^2 window rows from the packed (H*W, 8) table, masks and
    reduces to (f, g, H).  Plain twin: d2d_analytic.fgh_dense_flat.
  * `fgh_dense_flat_batch` — the same term for B lanes against one flat
    (N*H*W, 8) node bank, each lane with its own row offset: the lockstep
    Newton of loop-closure link refinement.  Plain twin:
    d2d_analytic.fgh_dense_flat_batch.
  * `pair_fgh_reduce` — the Pallas kernel's signature: masked sum of the
    pair derivatives of given pairs; serves the paired feature term.
    Plain twin: `pair_fgh_reduce_reference` below.

The source is compiled with nvcc for sm_90a into a shared library with a
plain C interface at the first CUDA call (never at import: machines
without nvcc import this module fine), cached under build/kernels/ by a
hash of the source, and loaded with ctypes.

Dispatch rule: CPU tensors go to the plain PyTorch twin; CUDA tensors
launch the kernel or raise.  There is no fallback from the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

from ndt_feature_graph_tpu.config import MatcherParams
from ndt_feature_graph_tpu_torch.ops import d2d_analytic
from ndt_feature_graph_tpu_torch.ops.ndt_map import CellList

_PKG = pathlib.Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "pair_fgh.cu"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# Launch counts per entry: incremented only where a kernel launches.
LAUNCHES = {"fgh_dense_flat": 0, "pair_fgh_reduce": 0,
            "fgh_dense_flat_batch": 0}

_lib = None
build_log = ""        # nvcc/ptxas output of the build in this process


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc():
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME/bin/nvcc or PATH): the CUDA "
            "kernels are built from csrc/ at first use"
        )
    return path


def build():
    """Compile csrc/pair_fgh.cu (if this source hash is not built yet)
    and load it.  Returns the ctypes library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / key[:16] / "libpair_fgh.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True, text=True,
        )
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed:\n{build_log}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.ndtg_block_threads.argtypes = []
    lib.ndtg_block_threads.restype = I
    lib.ndtg_fgh_dense_flat.argtypes = [
        P, P, P, P, P, P, P, LL, I, I, I, F, I, F, F, P, I, P, P,
    ]
    lib.ndtg_fgh_dense_flat.restype = I
    lib.ndtg_fgh_dense_flat_batch.argtypes = [
        P, P, P, P, P, P, P, P, I, I, I, I, F, I, F, F, P, I, P, P,
    ]
    lib.ndtg_fgh_dense_flat_batch.restype = I
    lib.ndtg_pair_fgh_reduce.argtypes = [
        P, P, P, P, P, LL, F, F, P, I, P, P,
    ]
    lib.ndtg_pair_fgh_reduce.restype = I
    _lib = lib
    return lib


_SYM_INDEX = {}       # device -> index of the 3x3 Hessian in the 10 sums


def _sym_index(device):
    """Index of the 3x3 Hessian in the 10 sums, made once per device: a
    fresh host-to-device copy per call would synchronise the stream."""
    sym = _SYM_INDEX.get(device)
    if sym is None:
        sym = torch.tensor([4, 5, 6, 5, 7, 8, 6, 8, 9], device=device)
        _SYM_INDEX[device] = sym
    return sym


def _unpack10(out):
    """(10,) [s, g0..g2, h00 h01 h02 h11 h12 h22] -> (f, g (3,), H (3,3))
    on the device."""
    return out[0], out[1:4], out[_sym_index(out.device)].reshape(3, 3)


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _blocks(lib, n_items: int) -> int:
    return max(1, math.ceil(n_items / lib.ndtg_block_threads()))


def _raise_on(err: int, entry: str):
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA launch failed, cudaError {err}")


def fgh_dense_flat(d, T0, src: CellList, packed, origin, h: int, w: int,
                   res: float, n: int, lfd1: float, lfd2: float):
    """(f, g (3,), H (3,3)) of the D2D window cost of `src` moved by
    d ∘ T0 against the packed (H*W, 8) table — d2d_analytic.fgh_dense_flat
    (row offset 0) in one kernel launch on CUDA tensors."""
    if d.device.type == "cpu":
        m = MatcherParams(n_neighbours=n, lfd1=lfd1, lfd2=lfd2)
        return d2d_analytic.fgh_dense_flat(
            d, T0, src, packed, origin, 0, h, w, res, m
        )
    if d.device.type != "cuda":
        raise ValueError(f"fgh_dense_flat: unsupported device {d.device}")
    dev = d.device
    n_src = src.means.shape[0]
    f32 = torch.float32
    _check("d", d, f32, (3,), dev)
    _check("T0", T0, f32, (3,), dev)
    _check("src.means", src.means, f32, (n_src, 2), dev)
    _check("src.covs", src.covs, f32, (n_src, 2, 2), dev)
    _check("src.mask", src.mask, torch.bool, (n_src,), dev)
    _check("packed", packed, f32, (h * w, 8), dev)
    _check("origin", origin, f32, (2,), dev)
    if packed.data_ptr() % 16:
        raise ValueError("packed: rows must be 16-byte aligned")
    lib = build()
    nblk = _blocks(lib, n_src * (2 * n + 1) ** 2)
    partials = torch.empty((nblk, 10), dtype=f32, device=dev)
    out = torch.empty(10, dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ndtg_fgh_dense_flat(
            d.data_ptr(), T0.data_ptr(), src.means.data_ptr(),
            src.covs.data_ptr(), src.mask.data_ptr(), packed.data_ptr(),
            origin.data_ptr(), 0, n_src, h, w, float(res), n,
            float(lfd1), float(lfd2), partials.data_ptr(), nblk,
            out.data_ptr(), stream,
        )
    _raise_on(err, "fgh_dense_flat")
    LAUNCHES["fgh_dense_flat"] += 1
    return _unpack10(out)


MAX_LANES = 65535     # gridDim.y of the batched launch


def fgh_dense_flat_batch(d_b, T0_b, src_b: CellList, packed_flat, origins,
                         row_offsets, h: int, w: int, res: float, n: int,
                         lfd1: float, lfd2: float):
    """(f (B,), g (B, 3), H (B, 3, 3)) of B lanes of the D2D window term
    against one flat (R, 8) packed bank — d2d_analytic.
    fgh_dense_flat_batch in one launch (plus the per-lane sum) on CUDA
    tensors.  Lane b moves src_b[b] by d_b[b] ∘ T0_b[b] and reads the
    bank rows from row_offsets[b] (int64) on, with origin origins[b]."""
    if d_b.device.type == "cpu":
        m = MatcherParams(n_neighbours=n, lfd1=lfd1, lfd2=lfd2)
        return d2d_analytic.fgh_dense_flat_batch(
            d_b, T0_b, src_b, packed_flat, origins, row_offsets, h, w, res, m
        )
    if d_b.device.type != "cuda":
        raise ValueError(
            f"fgh_dense_flat_batch: unsupported device {d_b.device}")
    dev = d_b.device
    b, n_src = src_b.mask.shape
    f32 = torch.float32
    _check("d_b", d_b, f32, (b, 3), dev)
    _check("T0_b", T0_b, f32, (b, 3), dev)
    _check("src_b.means", src_b.means, f32, (b, n_src, 2), dev)
    _check("src_b.covs", src_b.covs, f32, (b, n_src, 2, 2), dev)
    _check("src_b.mask", src_b.mask, torch.bool, (b, n_src), dev)
    _check("packed_flat", packed_flat, f32, (packed_flat.shape[0], 8), dev)
    _check("origins", origins, f32, (b, 2), dev)
    _check("row_offsets", row_offsets, torch.int64, (b,), dev)
    if packed_flat.data_ptr() % 16:
        raise ValueError("packed_flat: rows must be 16-byte aligned")
    if not 0 < b <= MAX_LANES:
        raise ValueError(f"fgh_dense_flat_batch: {b} lanes, expected "
                         f"1..{MAX_LANES}")
    lib = build()
    nblk = _blocks(lib, n_src * (2 * n + 1) ** 2)
    partials = torch.empty((b, nblk, 10), dtype=f32, device=dev)
    out = torch.empty((b, 10), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ndtg_fgh_dense_flat_batch(
            d_b.data_ptr(), T0_b.data_ptr(), src_b.means.data_ptr(),
            src_b.covs.data_ptr(), src_b.mask.data_ptr(),
            packed_flat.data_ptr(), origins.data_ptr(),
            row_offsets.data_ptr(), b, n_src, h, w, float(res), n,
            float(lfd1), float(lfd2), partials.data_ptr(), nblk,
            out.data_ptr(), stream,
        )
    _raise_on(err, "fgh_dense_flat_batch")
    LAUNCHES["fgh_dense_flat_batch"] += 1
    sym = _sym_index(dev)
    return out[:, 0], out[:, 1:4], out[:, sym].reshape(b, 3, 3)


def _fgh_components(mu_x, mu_y, s00, s01, s11, mx, my, c00, c01, c11,
                    ok, lfd1, lfd2):
    """Elementwise per-pair (s, g0..g2, h00, h01, h02, h11, h12, h22),
    masked by `ok` — pallas_kernels._fgh_components, and the algebra of
    the CUDA device function."""
    det = torch.clamp(s00 * s11 - s01 * s01, min=1e-12)
    inv = 1.0 / det
    a00 = s11 * inv
    a01 = -s01 * inv
    a11 = s00 * inv
    amu_x = a00 * mu_x + a01 * mu_y
    amu_y = a01 * mu_x + a11 * mu_y
    q = mu_x * amu_x + mu_y * amu_y
    mt_x = -my
    mt_y = mx
    S00 = -2.0 * c01
    S01 = c00 - c11
    S11 = 2.0 * c01
    S2d00 = -2.0 * c00 + 2.0 * c11
    S2d01 = -4.0 * c01
    S2d11 = 2.0 * c00 - 2.0 * c11
    sa_x = S00 * amu_x + S01 * amu_y
    sa_y = S01 * amu_x + S11 * amu_y
    asa_x = a00 * sa_x + a01 * sa_y
    asa_y = a01 * sa_x + a11 * sa_y
    q_x = 2.0 * amu_x
    q_y = 2.0 * amu_y
    q_t = 2.0 * (amu_x * mt_x + amu_y * mt_y) - (mu_x * asa_x + mu_y * asa_y)
    amt_x = a00 * mt_x + a01 * mt_y
    amt_y = a01 * mt_x + a11 * mt_y
    h_xx = 2.0 * a00
    h_xy = 2.0 * a01
    h_yy = 2.0 * a11
    h_xt = 2.0 * amt_x - 2.0 * asa_x
    h_yt = 2.0 * amt_y - 2.0 * asa_y
    t1 = 2.0 * (mt_x * amt_x + mt_y * amt_y)
    t2 = 2.0 * (amu_x * (-mx) + amu_y * (-my))
    t3 = -4.0 * (asa_x * mt_x + asa_y * mt_y)
    sasa_x = S00 * asa_x + S01 * asa_y
    sasa_y = S01 * asa_x + S11 * asa_y
    asasa_x = a00 * sasa_x + a01 * sasa_y
    asasa_y = a01 * sasa_x + a11 * sasa_y
    s2a_x = S2d00 * amu_x + S2d01 * amu_y
    s2a_y = S2d01 * amu_x + S2d11 * amu_y
    as2a_x = a00 * s2a_x + a01 * s2a_y
    as2a_y = a01 * s2a_x + a11 * s2a_y
    t4 = mu_x * (2.0 * asasa_x - as2a_x) + mu_y * (2.0 * asasa_y - as2a_y)
    h_tt = t1 + t2 + t3 + t4
    alpha = 0.5 * lfd2
    E = torch.where(ok, torch.exp(-alpha * q), 0.0)
    k = lfd1 * alpha * E
    return (
        -lfd1 * E, k * q_x, k * q_y, k * q_t,
        k * (h_xx - alpha * q_x * q_x), k * (h_xy - alpha * q_x * q_y),
        k * (h_xt - alpha * q_x * q_t), k * (h_yy - alpha * q_y * q_y),
        k * (h_yt - alpha * q_y * q_t), k * (h_tt - alpha * q_t * q_t),
    )


def _broadcast_pairs(mu, Sig, m_rot, Crot, ok):
    shape = ok.shape
    return (
        mu.expand(shape + (2,)), Sig.expand(shape + (2, 2)),
        m_rot.expand(shape + (2,)), Crot.expand(shape + (2, 2)), ok,
    )


def pair_fgh_reduce_reference(mu, Sig, m_rot, Crot, ok, lfd1, lfd2):
    """Plain PyTorch `pair_fgh_reduce`: masked sum of the per-pair
    derivatives.  mu (..., 2); Sig (..., 2, 2); m_rot (..., 2) and Crot
    (..., 2, 2) broadcastable; ok (...) bool.  Returns (f, g (3,),
    H (3, 3))."""
    mu, Sig, m_rot, Crot, ok = _broadcast_pairs(mu, Sig, m_rot, Crot, ok)
    comps = _fgh_components(
        mu[..., 0], mu[..., 1], Sig[..., 0, 0], Sig[..., 0, 1],
        Sig[..., 1, 1], m_rot[..., 0], m_rot[..., 1], Crot[..., 0, 0],
        Crot[..., 0, 1], Crot[..., 1, 1], ok, lfd1, lfd2,
    )
    return _unpack10(torch.stack([c.sum() for c in comps]))


def pair_fgh_reduce(mu, Sig, m_rot, Crot, ok, lfd1, lfd2):
    """Fused masked reduction of the pair derivatives (the TPU kernel's
    signature).  Shapes as pair_fgh_reduce_reference."""
    if ok.device.type == "cpu":
        return pair_fgh_reduce_reference(mu, Sig, m_rot, Crot, ok, lfd1,
                                         lfd2)
    if ok.device.type != "cuda":
        raise ValueError(f"pair_fgh_reduce: unsupported device {ok.device}")
    dev = ok.device
    f32 = torch.float32
    for name, t in (("mu", mu), ("Sig", Sig), ("m_rot", m_rot),
                    ("Crot", Crot)):
        if t.dtype != f32 or t.device != dev:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                             f"float32 on {dev}")
    if ok.dtype != torch.bool:
        raise ValueError(f"ok: dtype {ok.dtype}, expected torch.bool")
    mu, Sig, m_rot, Crot, ok = (
        t.contiguous() for t in _broadcast_pairs(mu, Sig, m_rot, Crot, ok)
    )
    n_pairs = ok.numel()
    lib = build()
    nblk = _blocks(lib, n_pairs)
    partials = torch.empty((nblk, 10), dtype=f32, device=dev)
    out = torch.empty(10, dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ndtg_pair_fgh_reduce(
            mu.data_ptr(), Sig.data_ptr(), m_rot.data_ptr(),
            Crot.data_ptr(), ok.data_ptr(), n_pairs, float(lfd1),
            float(lfd2), partials.data_ptr(), nblk, out.data_ptr(), stream,
        )
    _raise_on(err, "pair_fgh_reduce")
    LAUNCHES["pair_fgh_reduce"] += 1
    return _unpack10(out)


def fgh_paired(d, T0, src: CellList, tgt: CellList, m: MatcherParams):
    """d2d_analytic.fgh_paired with the reduction through
    `pair_fgh_reduce` (the kernel on CUDA tensors)."""
    mu, Sig, m_rot, Crot, ok = d2d_analytic.paired_inputs(d, T0, src, tgt)
    return pair_fgh_reduce(mu, Sig, m_rot, Crot, ok, m.lfd1, m.lfd2)
