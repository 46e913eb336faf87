"""The map's occupancy update on the CPU, against the design of its
card kernel (csrc/occupancy.cu) and the JAX reference.

* A numpy mirror of the kernel's algorithm — each ray's cells with the
  eager operations' float32 rounding, integer hit and miss counts a
  cell, then a row's chain (its hits, then its misses, each add rounded
  once, stopped in the last phase once the sum lies strictly beyond the
  clamp, tested every 8 adds), the dropped entries' +0.0 on a sum that
  ends as -0.0, torch's clamp — gives the plain update's bits (tolerance
  0) on every case of chip_smoke.occupancy_cases, one grid and a stack
  of 3.  The one-launch path's split of the counters over a cluster of
  1, 2, 4, 8 or 16 blocks a stream (each block owning a range of rows)
  gives the same bits, and the wrapper's shape rule picks the cluster
  path or the two-pass path.  The kernel itself runs only on the card
  (tests/test_torch_cuda.py holds it to the CPU's bits at 1, 3 and 64
  grids, at every cluster size and on the two-pass path).
* The chain's stop: for any (old, n_hit, n_miss, hit, miss, clamp) the
  stopped chain, clamped, is the whole chain, clamped.
* The whole update against the reference's update_occupancy at the
  map-update parity tolerance of tests/test_torch_fleet.py (atol 1e-5).
"""

import importlib.util
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ndt_feature_graph_tpu.config import NDTMapParams as JNDTMapParams
from ndt_feature_graph_tpu.ops import ndt_map as jnm
from ndt_feature_graph_tpu_torch.ops import cuda_kernels
from ndt_feature_graph_tpu_torch.ops import ndt_map as tnm

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

F32 = np.float32
INT_MIN = -2 ** 31
EXIT_EVERY = 8         # csrc/occupancy.cu kExitEvery


@pytest.fixture(scope="module")
def fx():
    with np.load(chip_smoke.FIXTURE) as f:
        return dict(f)


@pytest.fixture(scope="module")
def mp():
    return chip_smoke.canonical_slam_params().fuser.ndt


def _bits(x):
    return np.ascontiguousarray(x, dtype=F32).view(np.uint32)


def _cell(v, o, res):
    """floor((v - o) / res) in float32, cast to int32 as torch casts on
    the CPU: INT_MIN for NaN and out of range."""
    with np.errstate(invalid="ignore", over="ignore"):
        f = np.floor((v - o) / res)
    fits = (f >= -2.0 ** 31) & (f < 2.0 ** 31)
    out = np.full(f.shape, INT_MIN, np.int64)
    out[fits] = f[fits].astype(np.int64)
    return out


def _run(acc, v, n, last, lo, hi, beyond, adds):
    """n adds of v onto acc (rows in parallel), in blocks of EXIT_EVERY
    with the stop tested after each block on the rows where `last` (no
    later phase); then the tail."""
    if v == 0:
        sel = n > 0
        acc[sel] = acc[sel] + v
        adds[sel] += 1
        return
    stop = np.zeros(n.shape, bool)
    full = n // EXIT_EVERY * EXIT_EVERY
    for i in range(0, int(full.max(initial=0)), EXIT_EVERY):
        sel = np.flatnonzero((full > i) & ~stop)
        a = acc[sel]
        for _ in range(EXIT_EVERY):
            a = a + v
        acc[sel] = a
        out = sel[((a > hi) if v > 0 else (a < lo)) & last[sel]]
        stop[out] = beyond[out] = True
        adds[out] += i + EXIT_EVERY
    rem = np.where(stop, 0, n - full)
    for j in range(int(rem.max(initial=0))):
        sel = rem > j
        acc[sel] = acc[sel] + v
    adds[~stop] += n[~stop]


def chain(old, n_hit, n_miss, hit, miss, clamp):
    """The row pass on rows in parallel: (the sum before the clamp,
    whether it stopped beyond the clamp, the adds made)."""
    acc = np.array(old, F32, copy=True)
    beyond = np.zeros(acc.shape, bool)
    adds = np.zeros(acc.shape, np.int64)
    lo, hi = F32(-clamp), F32(clamp)
    _run(acc, F32(hit), n_hit, n_miss == 0, lo, hi, beyond, adds)
    _run(acc, F32(miss), n_miss, np.ones(acc.shape, bool), lo, hi, beyond,
         adds)
    return acc, beyond, adds


def torch_clamp(x, clamp):
    lo, hi = F32(-clamp), F32(clamp)
    x = np.where(x < lo, lo, x)
    return np.where(hi < x, hi, x)


def occupancy_entries(grid, p, sensor, pts, mask):
    """Each stream's kept hit and miss entries as cells of its grid
    (stream, cell), with the rounding of csrc/occupancy.cu, and the rows
    (k mod n_rows) that a dropped entry of the concatenation lands on."""
    h, w, S = p.grid_h, p.grid_w, p.ray_samples
    lead, P = pts.shape[:-2], pts.shape[-2]
    n = math.prod(lead)
    pts = pts.numpy().reshape(n, P, 2)
    valid = mask.numpy().reshape(n, P) & np.isfinite(pts).all(-1)
    org = np.broadcast_to(grid.origin.numpy(), (*lead, 2)).reshape(n, 2)
    so = np.broadcast_to(sensor.numpy(), (*lead, 2)).reshape(n, 2)
    res = F32(p.resolution)

    def inb(iy, ix):
        return (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)

    ix = _cell(pts[..., 0], org[:, None, 0], res)
    iy = _cell(pts[..., 1], org[:, None, 1], res)
    hit_ok = valid & inb(iy, ix)
    t = (np.arange(S, dtype=F32) + F32(0.5)) / F32(S)
    s4 = so[:, None, None, :]
    with np.errstate(invalid="ignore", over="ignore"):
        ray = s4 + t[:, None] * (pts[:, :, None, :] - s4)
    rix = _cell(ray[..., 0], org[:, None, None, 0], res)
    riy = _cell(ray[..., 1], org[:, None, None, 1], res)
    miss_ok = (valid[..., None] & inb(riy, rix)
               & ~((riy == iy[..., None]) & (rix == ix[..., None])))
    n_rows = n * h * w
    stream = np.arange(n)[:, None]
    hits = (np.broadcast_to(stream, iy.shape)[hit_ok], (iy * w + ix)[hit_ok])
    misses = (np.broadcast_to(stream[..., None], riy.shape)[miss_ok],
              (riy * w + rix)[miss_ok])
    keep = np.concatenate([hit_ok.ravel(), miss_ok.ravel()])
    dropped = np.zeros(n_rows, bool)
    dropped[np.flatnonzero(~keep) % n_rows] = True
    return hits, misses, dropped


def occupancy_rows(grid, p, n_hit, n_miss, dropped):
    """The row pass on every row's counts: (occ, adds a row)."""
    acc, beyond, adds = chain(grid.occ.numpy().reshape(-1), n_hit, n_miss,
                              p.occ_hit, p.occ_miss, p.occ_clamp)
    neg0 = ~beyond & (_bits(acc) == 0x80000000) & dropped
    acc[neg0] = 0.0
    return torch_clamp(acc, p.occ_clamp).reshape(grid.occ.shape), adds


def occupancy_mirror(grid, p, sensor, pts, mask):
    """(occ, adds a row) as csrc/occupancy.cu's two-pass path computes
    them: one counter a row of the whole stack."""
    (hs, hc), (ms, mc), dropped = occupancy_entries(grid, p, sensor, pts,
                                                    mask)
    rows = p.grid_h * p.grid_w
    n_rows = dropped.size
    n_hit = np.bincount(hs * rows + hc, minlength=n_rows)
    n_miss = np.bincount(ms * rows + mc, minlength=n_rows)
    return occupancy_rows(grid, p, n_hit, n_miss, dropped)


def cluster_mirror(grid, p, sensor, pts, mask, k):
    """(occ, adds a row) as the one-launch path computes them: a cluster
    of k blocks a stream, block j owning rows [j R, (j + 1) R) of its
    stream (R = cuda_kernels.occupancy_block_rows) and their counters;
    each entry counted at (its stream, its row's owner, the row's place
    in the owner's range); then each block's rows."""
    (hs, hc), (ms, mc), dropped = occupancy_entries(grid, p, sensor, pts,
                                                    mask)
    rows = p.grid_h * p.grid_w
    n = dropped.size // rows
    r = cuda_kernels.occupancy_block_rows(rows, k)
    assert r % 4 == 0 and k * r >= rows
    owned = np.zeros((2, n, k, r), np.int64)       # hits, misses
    for j, (st, cell) in enumerate(((hs, hc), (ms, mc))):
        np.add.at(owned[j], (st, cell // r, cell % r), 1)
    n_hit, n_miss = (owned[j].reshape(n, k * r)[:, :rows].reshape(-1)
                     for j in range(2))
    return occupancy_rows(grid, p, n_hit, n_miss, dropped)


def _cases(mp, fx, streams):
    return chip_smoke.occupancy_cases(mp, fx, streams)


@pytest.mark.parametrize("streams", [0, 3])
def test_mirror_gives_the_plain_bits(mp, fx, streams):
    """The kernel's algorithm, mirrored, equals the plain update bit for
    bit on every case; the stop keeps the canonical scan's chains short
    (79 adds at most; the sensor's cell takes 1,947 without the stop)."""
    for name, p, grid, sensor, pts, mask in _cases(mp, fx, streams):
        want = tnm.update_occupancy(grid, p, sensor, pts, mask).occ.numpy()
        got, adds = occupancy_mirror(grid, p, sensor, pts, mask)
        off = int((_bits(got) != _bits(want)).sum())
        assert off == 0, f"{name}: {off} elements off the plain bits"
        if name == "canonical":
            assert adds.max() < 128, adds.max()
        if name == "clamp inf":
            assert adds.max() > 1000, adds.max()


@pytest.mark.parametrize("streams", [0, 3])
@pytest.mark.parametrize("k", [1, 2, 4, 8, 16])
def test_cluster_ownership_gives_the_two_pass_bits(mp, fx, streams, k):
    """The one-launch path's split of the counters over a cluster of k
    blocks a stream gives occupancy_mirror's bits (tolerance 0) and its
    chains on every case, for one grid and a stack of 3."""
    for name, p, grid, sensor, pts, mask in _cases(mp, fx, streams):
        want, adds = occupancy_mirror(grid, p, sensor, pts, mask)
        got, got_adds = cluster_mirror(grid, p, sensor, pts, mask, k)
        off = int((_bits(got) != _bits(want)).sum())
        assert off == 0, f"{name}: {off} elements off the two-pass bits"
        assert np.array_equal(got_adds, adds), name


H100_RESIDENT = {1: 0, 2: 66, 4: 30, 8: 15, 16: 7}.get   # 1,024 threads


def test_cluster_or_two_pass_by_shape():
    """The wrapper's rule: the canonical 200 x 200 grid takes the
    cluster path with the most blocks a stream whose clusters the card
    holds at once (the H100's counts: 16 blocks for one stream, 8 up to
    15 streams, 4 up to 30, then 2: 40,000 rows need 2 blocks of 160
    KB), a grid whose counters and old values do not fit 16 blocks of
    227 KB the two-pass path; each chosen block's shared memory fits."""
    rule = cuda_kernels.occupancy_cluster
    got = [rule(40_000, False, n, H100_RESIDENT)
           for n in (1, 7, 8, 15, 16, 30, 31, 64, 66, 67, 200)]
    assert got == [16, 16, 8, 8, 4, 4, 2, 2, 2, 2, 2]
    most = cuda_kernels.OCCUPANCY_MAX_CLUSTER
    word = {False: 4, True: 8}
    for wide, fits in ((False, 464_896), (True, 309_888)):
        assert rule(fits, wide, 1, H100_RESIDENT) == most
        assert rule(fits + 4, wide, 1, H100_RESIDENT) == 0
        assert rule(1024 * 1024, wide, 64, H100_RESIDENT) == 0
        for rows in (1, 7, 40_000, 100_000, fits):
            for n in (1, 64, 1000):
                k = rule(rows, wide, n, H100_RESIDENT)
                assert k in (1, 2, 4, 8, 16)
                assert (cuda_kernels.occupancy_block_rows(rows, k)
                        * (word[wide] + 4)
                        <= cuda_kernels.OCCUPANCY_MAX_SMEM)


def test_neg_zero_rows_take_the_dropped_zero(mp, fx):
    """On a base of -0.0, rows that only dropped entries reach come out
    +0.0, the others -0.0 or their sums: both signs occur, so the
    mirror's rule is exercised both ways."""
    name, p, grid, sensor, pts, mask = _cases(mp, fx, 0)[4]
    assert name == "-0.0 base"
    got = tnm.update_occupancy(grid, p, sensor, pts, mask).occ.numpy()
    assert (_bits(got) == 0x80000000).sum() > 1000
    assert (_bits(got) == 0).sum() > 1000


def _full(old, n_hit, n_miss, hit, miss, clamp):
    acc = F32(old)
    for _ in range(n_hit):
        acc = acc + F32(hit)
    for _ in range(n_miss):
        acc = acc + F32(miss)
    return torch_clamp(np.array([acc], F32), clamp)[0]


_finite32 = st.floats(-30.0, 30.0, width=32)
_const32 = st.one_of(st.just(0.0), st.floats(-3.0, 3.0, width=32))


@settings(max_examples=300, deadline=None)
@given(old=st.one_of(_finite32, st.sampled_from([-10.0, 10.0, -0.0])),
       n_hit=st.integers(0, 40), n_miss=st.integers(0, 300),
       hit=_const32, miss=_const32,
       clamp=st.one_of(st.floats(0.0, 20.0, width=32), st.just(math.inf)))
def test_stopped_chain_equals_the_whole_chain(old, n_hit, n_miss, hit, miss,
                                              clamp):
    """The chain stopped beyond the clamp, clamped, is the whole chain,
    clamped, bit for bit."""
    acc, _, adds = chain(np.array([old], F32), np.array([n_hit]),
                         np.array([n_miss]), hit, miss, clamp)
    got = torch_clamp(acc, clamp)[0]
    assert _bits(got) == _bits(_full(old, n_hit, n_miss, hit, miss, clamp))
    assert adds[0] <= n_hit + n_miss


@pytest.mark.parametrize("case", ["canonical", "sensor outside",
                                  "NaN and far points"])
def test_update_matches_jax(mp, fx, case):
    """The port's update (the plain twin on the CPU) against the
    reference's on the same inputs; the mirror within the same
    tolerance."""
    name, p, grid, sensor, pts, mask = next(
        c for c in _cases(mp, fx, 0) if c[0] == case)
    jp = JNDTMapParams(**{f: getattr(p, f)
                          for f in JNDTMapParams.__dataclass_fields__})
    jg = jnm.empty_grid(jp, jnp.zeros(2))._replace(
        origin=jnp.asarray(grid.origin.numpy()),
        occ=jnp.asarray(grid.occ.numpy()))
    want = np.asarray(jnm.update_occupancy(
        jg, jp, jnp.asarray(sensor.numpy()), jnp.asarray(pts.numpy()),
        jnp.asarray(mask.numpy())).occ)
    got = tnm.update_occupancy(grid, p, sensor, pts, mask).occ.numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(
        occupancy_mirror(grid, p, sensor, pts, mask)[0], want, atol=1e-5)


def test_update_occupancy_refuses_other_devices(mp):
    """Neither CPU nor CUDA: raises (no silent plain version)."""
    grid = tnm.empty_grid(mp, torch.zeros(2, device="meta"))
    pts = torch.zeros(4, 2, device="meta")
    mask = torch.ones(4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_kernels.update_occupancy(grid, mp, torch.zeros(2, device="meta"),
                                      pts, mask)
