"""The map update's fixed-order sum and the scan directions, on the CPU.

* `scan_to_points` takes each beam's direction from the CPU's float32
  cos / sin, cached per device (`dataset.beam_directions`), so the card's
  points are the CPU's; on the canonical scans its points sit within one
  float32 ulp of the range (np.spacing) of JAX's jitted
  `scan_to_points`, with 10,357 of the 288,000 coordinates off JAX's
  bits, as before.
* A numpy mirror of the segment-sum kernel's bookkeeping
  (csrc/segment_sum.cu, no sort: the bucket pass's per-warp ranks of a
  tile's entries by row block and its table of runs; the row pass's
  runs read tile by tile, each chunk ranked stably by row, each row's
  run added in entry order onto the old row) gives index_add's bits,
  over channel widths 1, 2, 4 and the map's 1 + 2 + 4, a stack of
  streams, one cell with thousands of entries, and the layouts of
  tile, chunk and bucket edges; the bucket pass places each tile's
  entries as a stable argsort by row block does.  The kernel itself
  runs only on the card (tests/test_torch_cuda.py).
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
# csrc/segment_sum.cu's sizes.
THREADS = 256          # kThreads: a block's threads
ROW_BLOCK = 256        # kRowBlock: rows of a row-pass block, 1 a thread
ROW_SHIFT = 8          # log2(ROW_BLOCK)
TILE = 1024            # kTile: entries of a bucket-pass tile
WARPS = 8              # kWarps
WARP_SPAN = 128        # kWarpSpan: tile entries a warp ranks
CHUNK = 512            # kChunk: entries of a row-pass chunk
MAX_BUCKETS = 16384    # kMaxBuckets
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


def bucket_shift(n_rows):
    """segment_sum.cu bucket_shift: row buckets of ROW_BLOCK << shift
    rows, at most MAX_BUCKETS of them."""
    shift = 0
    while ((n_rows - 1) >> (ROW_SHIFT + shift)) + 1 > MAX_BUCKETS:
        shift += 1
    return shift


def warp_rank(counter, keys, n_keys, warp):
    """Mirror of segment_sum.cu warp_rank for one warp's 32 lanes: each
    key's lanes add their number to the warp's field counter[key, warp]
    (keys >= n_keys are not counted); a lane's rank is the field before
    the add plus its lower peers.  Returns the ranks (32,)."""
    rank = np.zeros(WARP, np.int64)
    for key in np.unique(keys):
        lanes = np.nonzero(keys == key)[0]
        if key < n_keys:
            rank[lanes] = counter[key, warp] + np.arange(len(lanes))
            counter[key, warp] += len(lanes)
            assert counter[key, warp] <= 255      # an 8-bit field
    return rank


def bucket_pass_mirror(idx, n_rows):
    """The bucket pass in numpy: (table (tiles, buckets + 1), range
    (tiles, 2), ent (tiles * TILE, 2) of (entry position, row)); -1
    where the kernel writes nothing.  Tile t's digits span [lo, hi]
    (range[t]; (buckets, -1) for none), its counters are those digits'
    minus lo, and its table row holds the starts of digits lo .. hi + 1.
    Warp w of tile t ranks entries t TILE + w WARP_SPAN + ... in steps
    of 32; the warps' fields are apart, so taking the warps in any
    order gives the kernel's counters."""
    idx = np.asarray(idx, np.int64)
    m = len(idx)
    shift = bucket_shift(n_rows)
    n_buckets = ((n_rows - 1) >> (ROW_SHIFT + shift)) + 1
    tiles = -(-m // TILE)
    table = np.full((tiles, n_buckets + 1), -1, np.int64)
    rng_ = np.zeros((tiles, 2), np.int64)
    ent = np.full((tiles * TILE, 2), -1, np.int64)
    lanes = np.arange(WARP)
    for t in range(tiles):
        j = np.arange(t * TILE, min(m, (t + 1) * TILE))
        ok = (idx[j] >= 0) & (idx[j] < n_rows)
        digits = idx[j][ok] >> (ROW_SHIFT + shift)
        lo = int(digits.min()) if ok.any() else n_buckets
        hi = int(digits.max()) if ok.any() else -1
        rng_[t] = lo, hi
        n_digits = max(hi - lo + 2, 1)
        counter = np.zeros((n_digits, WARPS), np.int64)
        steps = []
        for w in range(WARPS):
            for s in range(WARP_SPAN // WARP):
                j = t * TILE + w * WARP_SPAN + s * WARP + lanes
                v = idx[np.minimum(j, m - 1)]
                ok = (j < m) & (v >= 0) & (v < n_rows)
                d = np.where(ok, (v >> (ROW_SHIFT + shift)) - lo, n_digits)
                steps.append((w, j, v, d, warp_rank(counter, d, n_digits - 1,
                                                    w)))
        starts = np.concatenate([[0], np.cumsum(counter.sum(1))[:-1]])
        if hi >= lo:
            table[t, lo:hi + 2] = starts
        for w, j, v, d, rank in steps:
            on = d < n_digits - 1
            below = counter[d[on], :w].sum(1)
            ent[t * TILE + starts[d[on]] + below + rank[on]] = np.stack(
                [j[on], v[on]], 1)
    return table, rng_, ent


def row_pass_mirror(bases, vals, table, rng_, ent, n_rows):
    """The row pass in numpy / torch: block b's list of its bucket's runs
    tile by tile (THREADS tiles a batch), in chunks of CHUNK entries,
    each chunk ranked by local row as the kernel ranks it (warp w takes
    span entries, span = the chunk over the threads, rounded up to 32),
    the values staged at start[row] + rank (start: the counts' exclusive
    sum in local-row order), then every row's run added in order onto
    its accumulator (one float32 add a step, all rows of a step in one
    vector add)."""
    shift = bucket_shift(n_rows)
    n_tiles = table.shape[0]
    outs = [b.clone() for b in bases]
    lanes = np.arange(WARP)
    for blk in range(-(-n_rows // ROW_BLOCK)):
        r0, q = blk * ROW_BLOCK, blk >> shift
        rows = slice(r0, min(n_rows, r0 + ROW_BLOCK))
        acc = [o[rows].clone() for o in outs]
        for tb in range(0, n_tiles, THREADS):
            tiles = np.arange(tb, min(n_tiles, tb + THREADS))
            mine = (rng_[tiles, 0] <= q) & (q <= rng_[tiles, 1])
            at = np.where(mine, table[tiles, q] + tiles * TILE, 0)
            n = np.where(mine, table[tiles, q + 1] - table[tiles, q], 0)
            pre = np.concatenate([[0], np.cumsum(n)[:-1]])
            total = int(n.sum())
            for j0 in range(0, total, CHUNK):
                n_c = min(CHUNK, total - j0)
                span = -(-n_c // THREADS) * WARP
                counter = np.zeros((ROW_BLOCK + 2, WARPS), np.int64)
                steps = []
                for w in range(WARPS):
                    for s in range(CHUNK // THREADS):
                        i = w * span + s * WARP + lanes
                        live = (s * WARP < span) & (i < n_c)
                        j = j0 + np.minimum(i, n_c - 1)
                        tile = np.searchsorted(pre, j, "right") - 1
                        e = ent[at[tile] + j - pre[tile]]
                        assert (e[live] >= 0).all()
                        local = e[:, 1] - r0
                        key = np.where(
                            live, np.where((local >= 0)
                                           & (local < ROW_BLOCK), local,
                                           ROW_BLOCK), ROW_BLOCK + 1)
                        steps.append((w, key, e[:, 0], warp_rank(
                            counter, key, ROW_BLOCK, w)))
                cnt = counter[:ROW_BLOCK].sum(1)
                start = np.concatenate([[0], np.cumsum(cnt)[:-1]])
                staged = [torch.zeros((n_c, v.shape[1])) for v in vals]
                filled = np.zeros(n_c, bool)
                for w, key, pos, rank in steps:
                    on = key < ROW_BLOCK
                    slot = (start[key[on]] + counter[key[on], :w].sum(1)
                            + rank[on])
                    assert not filled[slot].any()
                    filled[slot] = True
                    for st, v in zip(staged, vals):
                        st[torch.as_tensor(slot)] = v[torch.as_tensor(
                            pos[on])]
                for k in range(int(cnt.max())):
                    live = np.nonzero(cnt[:rows.stop - r0] > k)[0]
                    at_k = torch.as_tensor(start[live] + k)
                    live = torch.as_tensor(live)
                    for a, st in zip(acc, staged):
                        a[live] = a[live] + st[at_k]
        for o, a in zip(outs, acc):
            o[rows] = a
    return outs


def segment_sum_mirror(bases, idx, vals):
    """Both passes of the kernel's bookkeeping in numpy / torch."""
    n_rows = bases[0].shape[0]
    table, rng_, ent = bucket_pass_mirror(idx.numpy(), n_rows)
    return row_pass_mirror(bases, vals, table, rng_, ent, n_rows)


def _case(widths, n_rows, idx, seed):
    rng = np.random.default_rng(seed)
    m = len(idx)
    bases = [torch.tensor(rng.standard_normal((n_rows, c)),
                          dtype=torch.float32) for c in widths]
    vals = [torch.tensor(rng.standard_normal((m, c)) * 10.0 ** rng.integers(
        -3, 3, (m, 1)), dtype=torch.float32) for c in widths]
    return bases, torch.as_tensor(idx, dtype=torch.int64), vals


def _layout(layout, widths):
    """(bases, idx, vals) of a named layout, on the CPU."""
    rng = np.random.default_rng(len(widths))
    if layout == "one_grid":
        n_rows = 1600
        idx = np.clip(rng.normal(800, 300, 4000).astype(np.int64), 0,
                      n_rows - 1)
    elif layout == "streams":
        n_rows = 3 * 1600
        idx = (rng.integers(0, 400, (3, 1500)) * 4
               + np.arange(3)[:, None] * 1600).ravel()
    elif layout == "long_run":
        n_rows = 2500
        idx = rng.integers(0, n_rows, 6000)
        idx[rng.permutation(6000)[:5000]] = 1234
    elif layout == "one_row":          # every entry on one row
        n_rows = 700
        idx = np.full(1500, 300)
    elif layout == "multi_tile":       # a row block's entries in 4 tiles
        n_rows = 2000
        idx = rng.integers(0, n_rows, 3500)
        idx[::7] = rng.integers(512, 768, len(idx[::7]))
    elif layout == "multi_chunk":      # 1,300 entries in one row block
        n_rows = 1024
        idx = rng.integers(256, 512, 1300)
    elif layout == "m0":
        n_rows = 300
        idx = np.zeros(0, np.int64)
    elif layout == "m1":
        n_rows = 300
        idx = np.array([257])
    elif layout == "neg_zero":         # -0.0 bases, a third -0.0 values
        n_rows = 1000
        idx = rng.integers(0, n_rows, 3000)
    if layout == "dropped":            # the fleet's dropped entries
        lead, n_cells, n_pts = (3,), 30 * 20, 700
        ok = torch.as_tensor(rng.random(lead + (n_pts,)) < 0.6)
        flat = torch.as_tensor(rng.integers(0, n_cells, lead + (n_pts,)))
        fi = torch.where(ok, flat + tnm._stream_offsets(lead, n_cells, "cpu"),
                         tnm._drop_rows(ok.shape, 3 * n_cells, "cpu"))
        bases, idx_t, vals = _case(widths, 3 * n_cells, fi.reshape(-1), 7)
        vals = [v * ok.reshape(-1, 1) for v in vals]
        return bases, idx_t, vals
    bases, idx_t, vals = _case(widths, n_rows, idx, seed=7)
    if layout == "neg_zero":
        bases = [torch.full_like(b, -0.0) for b in bases]
        for v in vals:
            v[::3] = -0.0
    return bases, idx_t, vals


LAYOUTS = ["one_grid", "streams", "long_run", "one_row", "multi_tile",
           "multi_chunk", "m0", "m1", "neg_zero", "dropped"]


@pytest.mark.parametrize("widths", [(1,), (2,), (4,), (1, 2, 4)],
                         ids=["w1", "w2", "w4", "w7"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_segment_sum_mirror_is_index_add(widths, layout):
    """The mirror equals index_add bit for bit: one 40 x 40 grid with
    clustered entries over several blocks; a stack of 3 streams whose
    rows are kept apart by the stream offset (the fleet's flat
    scatter); one cell carrying 5,000 of 6,000 entries; every entry on
    one row; a row block's entries across several tiles; more entries in
    one row block than a chunk; no entry and one; -0.0 bases and values;
    a stack's dropped entries at k mod the cells.  Where a row takes
    more than one entry, summing the runs in reverse changes the bits,
    so the order is what is checked."""
    bases, idx_t, vals = _layout(layout, widths)
    got = segment_sum_mirror(bases, idx_t, vals)
    want = cuda_kernels.segment_add_rows_reference(bases, idx_t, vals)
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))
    if layout not in ("m0", "m1"):
        rev = cuda_kernels.segment_add_rows_reference(
            bases, idx_t.flip(0), [v.flip(0) for v in vals])
        assert any(not torch.equal(_bits(a), _bits(b))
                   for a, b in zip(rev, want))


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, TILE - 1, TILE, TILE + 1,
                               3 * TILE + 77])
def test_bucket_pass_places_as_stable_argsort(n):
    """The bucket pass's placement against numpy's stable argsort by row
    block, tile by tile: each tile's slice holds its entries' positions
    ordered by bucket, entry order within a bucket; its range is its
    least and greatest bucket, and its table row holds, over that range
    and one past it, the exclusive sum of the buckets' counts (nothing
    elsewhere); entries off the rows take no slot.  Indices over
    row-block edges (255, 256, 257, ...)."""
    rng = np.random.default_rng(n)
    n_rows = 5 * ROW_BLOCK + 3
    edges = np.array([0, ROW_BLOCK - 1, ROW_BLOCK, ROW_BLOCK + 1,
                      2 * ROW_BLOCK - 1, 2 * ROW_BLOCK, n_rows - 1, -1,
                      n_rows])
    idx = np.where(rng.random(n) < 0.5, rng.choice(edges, n),
                   rng.integers(0, n_rows, n))
    table, rng_, ent = bucket_pass_mirror(idx, n_rows)
    n_buckets = table.shape[1] - 1
    assert table.shape[0] == -(-n // TILE)
    for t in range(table.shape[0]):
        j = np.arange(t * TILE, min(n, (t + 1) * TILE))
        ok = (idx[j] >= 0) & (idx[j] < n_rows)
        digit = idx[j][ok] >> ROW_SHIFT
        want = j[ok][np.argsort(digit, kind="stable")]
        counts = np.bincount(digit, minlength=n_buckets)
        lo, hi = rng_[t]
        assert (lo, hi) == ((digit.min(), digit.max()) if ok.any()
                            else (n_buckets, -1))
        assert (table[t, :max(lo, 0)] == -1).all()
        assert (table[t, hi + 2:] == -1).all()
        assert np.array_equal(table[t, lo:hi + 2], np.concatenate(
            [[0], np.cumsum(counts)])[lo:hi + 2])
        got = ent[t * TILE:t * TILE + len(want)]
        assert np.array_equal(got[:, 0], want)
        assert np.array_equal(got[:, 1], idx[want])
        assert (ent[t * TILE + len(want):(t + 1) * TILE] == -1).all()


def test_bucket_shift_widens_buckets_past_max():
    """Up to MAX_BUCKETS row blocks a bucket is a row block; past it a
    bucket is 2^s row blocks, and the row pass keeps only its own rows
    of the bucket's run: the mirror at MAX_BUCKETS = 2 (a 4-block grid)
    still gives index_add's bits."""
    global MAX_BUCKETS
    assert bucket_shift(MAX_BUCKETS * ROW_BLOCK) == 0
    assert bucket_shift(MAX_BUCKETS * ROW_BLOCK + 1) == 1
    saved, MAX_BUCKETS = MAX_BUCKETS, 2
    try:
        assert bucket_shift(4 * ROW_BLOCK) == 1
        bases, idx_t, vals = _case((1, 2), 4 * ROW_BLOCK - 9, np.random.
                                   default_rng(3).integers(
                                       0, 4 * ROW_BLOCK - 9, 2500), seed=4)
        got = segment_sum_mirror(bases, idx_t, vals)
    finally:
        MAX_BUCKETS = saved
    want = cuda_kernels.segment_add_rows_reference(bases, idx_t, vals)
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))


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
