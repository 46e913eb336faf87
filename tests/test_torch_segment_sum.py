"""The map update's fixed-order sum and the scan directions, on the CPU.

* `scan_to_points` takes each beam's direction from the CPU's float32
  cos / sin, cached per device (`dataset.beam_directions`), so the card's
  points are the CPU's; on the canonical scans its points sit within one
  float32 ulp of the range (np.spacing) of JAX's jitted
  `scan_to_points`, with 10,357 of the 288,000 coordinates off JAX's
  bits, as before.
* A Python mirror of the segment-sum kernel's bookkeeping
  (csrc/segment_sum.cu: a stable sort, each block's span of sorted
  positions by the warp's 32-way lower-bound search, the first and last
  position of each row's run, the values staged in sorted order, the
  run added in order onto the old row)
  gives index_add's bits, over channel widths 1, 2, 4 and the map's
  1 + 2 + 4, a stack of streams, and one cell with thousands of
  entries.  The kernel itself runs only on the card
  (tests/test_torch_cuda.py).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_feature_graph_tpu.io import dataset as jds
from ndt_feature_graph_tpu_torch.io import dataset as tds
from ndt_feature_graph_tpu_torch.ops import cuda_kernels
from ndt_feature_graph_tpu_torch.ops import ndt_map as tnm

torch.set_num_threads(2)
FIXTURE = "ndt_feature_graph_tpu_torch/data/canonical_200.npz"
SEG_ROWS = 1024        # csrc/segment_sum.cu kSegRows: rows of a block
WARP = 32


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("num_beams,fov", [(720, 2 * math.pi),
                                           (360, 2 * math.pi),
                                           (1081, 1.5 * math.pi)])
def test_scan_directions_are_the_cpus(num_beams, fov):
    """scan_to_points' directions are the CPU's float32 cos / sin of
    `beam_angles`, computed once and cached: a scan of unit ranges gives
    them back bit for bit (tests/test_torch_cuda.py holds the card's
    points to the CPU's)."""
    ang = tds.beam_angles(num_beams, fov, "cpu")
    cos, sin = tds.beam_directions(num_beams, fov, "cpu")
    assert torch.equal(_bits(cos), _bits(torch.cos(ang)))
    assert torch.equal(_bits(sin), _bits(torch.sin(ang)))
    assert tds.beam_directions(num_beams, fov, "cpu")[0] is cos
    pts, _ = tds.scan_to_points(torch.ones(num_beams),
                                torch.ones(num_beams, dtype=torch.bool), fov)
    assert torch.equal(_bits(pts), _bits(torch.stack([cos, sin], -1)))


def test_scan_to_points_within_one_ulp_of_jax():
    """The canonical 200 scans: every coordinate within one float32 ulp
    of its range of JAX's (jitted, as the reference's pipelines run it),
    and the CPU's bits of before the directions were cached: 10,357 of
    the 288,000 coordinates differ from JAX's bits, before and after.
    (Directions taken in float64 and rounded once would leave 2,672, but
    move the chaotic trial counts and scores of seven parity tests;
    PERF.md §6.)"""
    with np.load(FIXTURE) as f:
        ranges, hit = f["ranges"], f["hit"]
    ref = np.asarray(jax.jit(jax.vmap(
        lambda r, h: jds.scan_to_points(r, h)[0]))(jnp.asarray(ranges),
                                                   jnp.asarray(hit)))
    r = torch.as_tensor(ranges)
    got = tds.scan_to_points(r, torch.as_tensor(hit))[0].numpy()
    ang = tds.beam_angles(ranges.shape[1], device="cpu")
    before = torch.stack([r * torch.cos(ang), r * torch.sin(ang)],
                         -1).numpy()
    a64 = ang.double()
    f64 = torch.stack([r * torch.cos(a64).float(), r * torch.sin(a64).float()],
                      -1).numpy()
    ulp = np.spacing(np.abs(ranges).astype(np.float32))[..., None]
    assert (np.abs(got.astype(np.float64) - ref) <= ulp).all()
    assert np.array_equal(got.view(np.int32), before.view(np.int32))
    n_diff, n_f64 = int((got != ref).sum()), int((f64 != ref).sum())
    print(f"coordinates off JAX's bits: {n_diff} of {got.size} (directions "
          f"in float64 rounded once: {n_f64})")
    assert 0 < n_f64 < n_diff <= 10_357


def warp_lower_bound(keys, v):
    """Mirror of segment_sum.cu warp_lower_bound: the first position of
    the ascending `keys` whose key is >= v, in 32-way steps."""
    lo, hi = 0, len(keys)
    lanes = np.arange(WARP)
    while lo < hi:
        step = (hi - lo + WARP - 1) // WARP
        q = lo + lanes * step
        below = (q < hi) & (keys[np.minimum(q, len(keys) - 1)] < v)
        k = int(below.sum())
        assert below[:k].all()              # the ballot is a prefix
        if k == 0:
            hi = lo
        else:
            nxt = lo + k * step
            if k < WARP and nxt < hi:
                hi = nxt
            lo += (k - 1) * step + 1
    return lo


def segment_sum_mirror(bases, idx, vals):
    """The kernel's bookkeeping in Python: sort the int32 indices
    stably, each block of SEG_ROWS rows finds its span of sorted
    positions, marks each row's run (first, last) and stages the
    entries' values in sorted order, and every touched row adds its
    run's staged values in order onto its old row (one float32 add a
    step, all rows of a step in one vector add)."""
    n_rows = bases[0].shape[0]
    keys, perm = torch.sort(idx.to(torch.int32), stable=True)
    k_np = keys.numpy()
    staged = [v[perm] for v in vals]
    first = np.zeros(n_rows, np.int64)
    last = np.full(n_rows, -1, np.int64)
    for r0 in range(0, n_rows, SEG_ROWS):
        p0 = warp_lower_bound(k_np, r0)
        p1 = warp_lower_bound(k_np, r0 + SEG_ROWS)
        p = np.arange(p0, p1)
        key = k_np[p0:p1]
        start = (p == p0) | (k_np[np.maximum(p - 1, 0)] != key)
        end = (p == p1 - 1) | (k_np[np.minimum(p + 1, len(k_np) - 1)] != key)
        first[key[start]] = p[start]
        last[key[end]] = p[end]
    rows = np.nonzero(last >= first)[0]
    length = last[rows] - first[rows] + 1
    outs = [b.clone() for b in bases]
    acc = [b[torch.as_tensor(rows)].clone() for b in bases]
    for j in range(int(length.max()) if len(rows) else 0):
        live = torch.as_tensor(np.nonzero(length > j)[0])
        at = torch.as_tensor(first[rows] + j)[live]
        for a, v in zip(acc, staged):
            a[live] = a[live] + v[at]
    for o, a in zip(outs, acc):
        o[torch.as_tensor(rows)] = a
    return outs


def _case(widths, n_rows, idx, seed):
    rng = np.random.default_rng(seed)
    m = len(idx)
    bases = [torch.tensor(rng.standard_normal((n_rows, c)),
                          dtype=torch.float32) for c in widths]
    vals = [torch.tensor(rng.standard_normal((m, c)) * 10.0 ** rng.integers(
        -3, 3, (m, 1)), dtype=torch.float32) for c in widths]
    return bases, torch.as_tensor(idx, dtype=torch.int64), vals


@pytest.mark.parametrize("widths", [(1,), (2,), (4,), (1, 2, 4)],
                         ids=["w1", "w2", "w4", "w7"])
@pytest.mark.parametrize("layout", ["one_grid", "streams", "long_run"])
def test_segment_sum_mirror_is_index_add(widths, layout):
    """The mirror equals index_add bit for bit: one 40 x 40 grid with
    clustered entries over several blocks; a stack of 3 streams whose
    rows are kept apart by the stream offset (the fleet's flat
    scatter); one cell carrying 5,000 of 6,000 entries.  Summing the
    same runs in reverse would change the bits, so the order is what is
    checked."""
    rng = np.random.default_rng(len(widths))
    if layout == "one_grid":
        n_rows = 1600
        idx = np.clip(rng.normal(800, 300, 4000).astype(np.int64), 0,
                      n_rows - 1)
    elif layout == "streams":
        n_rows = 3 * 1600
        idx = (rng.integers(0, 400, (3, 1500)) * 4
               + np.arange(3)[:, None] * 1600).ravel()
    else:
        n_rows = 2500
        idx = rng.integers(0, n_rows, 6000)
        idx[rng.permutation(6000)[:5000]] = 1234
    bases, idx_t, vals = _case(widths, n_rows, idx, seed=7)
    got = segment_sum_mirror(bases, idx_t, vals)
    want = cuda_kernels.segment_add_rows_reference(bases, idx_t, vals)
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))
    rev = cuda_kernels.segment_add_rows_reference(
        bases, idx_t.flip(0), [v.flip(0) for v in vals])
    assert any(not torch.equal(_bits(a), _bits(b)) for a, b in zip(rev, want))


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 1023, 1024, 5000])
def test_warp_lower_bound_mirror_is_searchsorted(n):
    """The kernel's 32-way search against numpy's lower bound, for
    values below, inside (with repeats) and above the keys."""
    rng = np.random.default_rng(n)
    keys = np.sort(rng.integers(0, max(n // 3, 1), n))
    for v in range(-2, max(n // 3, 1) + 3):
        assert warp_lower_bound(keys, v) == np.searchsorted(keys, v, "left")


def test_map_update_goes_through_segment_add_rows(monkeypatch):
    """add_points_touched and update_occupancy each call
    cuda_kernels.segment_add_rows once (all fields in one call), with
    the hits before the misses; on the CPU that is index_add and counts
    no launch."""
    calls = []
    plain = cuda_kernels.segment_add_rows

    def spy(bases, idx, vals):
        calls.append([b.shape[1] for b in bases])
        return plain(bases, idx, vals)

    monkeypatch.setattr(cuda_kernels, "segment_add_rows", spy)
    with np.load(FIXTURE) as f:
        r, h = torch.as_tensor(f["ranges"][3]), torch.as_tensor(f["hit"][3])
    p = tnm.NDTMapParams(resolution=0.5, size_x=40.0, size_y=40.0,
                         sensor_range=30.0, max_points_per_scan=720,
                         max_cells=1024)
    pts, mask = tds.scan_to_points(r, h)
    cuda_kernels.reset_launch_counts()
    g = tnm.build_from_scan(p, torch.zeros(2), torch.zeros(2), pts, mask)
    assert calls == [[1, 2, 4], [1]]
    assert not any(cuda_kernels.LAUNCHES.values())
    assert float(g.count.sum()) == float(mask.sum()) - float(
        (~tnm.in_bounds(p, *tnm.cell_index(p, g.origin, pts)) & mask).sum())


def test_segment_add_rows_refuses_other_devices():
    """Neither CPU nor CUDA: raises (no silent plain version)."""
    idx = torch.zeros(3, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_kernels.segment_add_rows(
            [torch.zeros((4, 1), device="meta")], idx,
            [torch.zeros((3, 1), device="meta")])
