"""NDT grid builder (port of ndt_feature_graph_tpu/ops/ndt_map.py).

A dense, fixed-shape (H, W) cell grid of sufficient statistics (count,
sum, sum of outer products) plus occupancy log-odds, and a compact
padded cell-list view for registration sources.

Differences from the JAX reference, by construction:
  * No `mode="drop"` scatter in torch: contributions of dropped points
    are already zero, so each is added at a real cell of its own (entry
    k at cell k mod the stack's cells, `_drop_rows`), exact: x + 0.0 is
    x for every x but -0.0, which no cell holds (its sums start at
    +0.0, and x + y is -0.0 only when both are).  Spread so, they form
    no long run on one cell for the card's ordered sum to walk.
  * No fixed-size `unique` / `nonzero`: both are rebuilt as sort +
    adjacent difference + cumsum-scatter compaction at the static
    capacity, with the reference's ascending order and fill values —
    no data-dependent shapes, no device sync.
  * No vmap: every function takes a stack of grids (leading stream
    dimensions on every field) and scatters once into the flattened
    stack with a per-stream offset, so a fleet step costs one scatter,
    not one per stream.  Per stream the additions keep their order.
  * `recenter` shifts by a device integer with an index gather
    (`torch.roll` takes host integers, which would cost a host read).
  * The scatter-adds sum each cell's contributions one after another
    onto its old value, in the order of the points, on the CPU and on
    the card alike (`scatter_add_rows`: index_add on the CPU, the
    hand-written segment-sum kernel on the card, a bucket pass and a
    row pass a scatter, no sort; the occupancy update on the card is a
    kernel of its own, which counts each cell's hits and misses and
    adds them in that order): a map update repeats bit for bit, and
    the card's equals the CPU's.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ndt_feature_graph_tpu_torch.config import NDTMapParams
from ndt_feature_graph_tpu_torch.core import se2


@dataclasses.dataclass
class NDTGrid:
    """Dense NDT submap. origin = world coords of the (0, 0) cell corner.
    A stack of grids carries leading stream dimensions on every field."""

    origin: torch.Tensor     # (..., 2)
    count: torch.Tensor      # (..., H, W)
    psum: torch.Tensor       # (..., H, W, 2)
    outer: torch.Tensor      # (..., H, W, 2, 2)
    occ: torch.Tensor        # (..., H, W) log-odds occupancy

    @property
    def shape(self):
        return self.count.shape


@dataclasses.dataclass
class CellList:
    """Compact padded view of gaussians (registration sources)."""

    means: torch.Tensor      # (..., N, 2)
    covs: torch.Tensor       # (..., N, 2, 2)
    mask: torch.Tensor       # (..., N) bool

    def transform(self, pose):
        """mean' = T mean, cov' = R cov R^T."""
        return CellList(
            se2.transform_points(pose, self.means),
            se2.rotate_covs(pose[..., 2], self.covs),
            self.mask,
        )

    def head(self, n: int) -> "CellList":
        """The first `n` cells (of each list of a stack), contiguous."""
        return CellList(self.means[..., :n, :].contiguous(),
                        self.covs[..., :n, :, :].contiguous(),
                        self.mask[..., :n].contiguous())


def take_rows(x, idx):
    """Per-stream gather of rows: x (*L, R, *r), idx (*L, M) -> (*L, M,
    *r) with out[..., k, :] = x[..., idx[..., k], :]."""
    nl = idx.dim() - 1
    if nl == 0:
        return x[idx]
    rest = x.shape[nl + 1:]
    ix = idx.reshape(idx.shape + (1,) * len(rest))
    return torch.gather(x, nl, ix.expand(idx.shape + rest))


def _stream_offsets(lead, stride: int, device):
    """(*lead, 1) offsets of each stream's block of `stride` rows in the
    flattened stack ((1,) zeros for a single grid)."""
    n = math.prod(lead)
    return (torch.arange(n, device=device) * stride).reshape(*lead, 1)


def empty_grid(params: NDTMapParams, center) -> NDTGrid:
    """Empty grid centred on `center` (..., 2) world coords (a tensor:
    the grid lives on its device; leading dims give a stack of grids)."""
    h, w = params.grid_h, params.grid_w
    center = center.to(torch.float32)
    lead = center.shape[:-1]
    z = dict(dtype=torch.float32, device=center.device)
    return NDTGrid(
        origin=torch.stack([center[..., 0] - params.size_x / 2.0,
                            center[..., 1] - params.size_y / 2.0], -1),
        count=torch.zeros((*lead, h, w), **z),
        psum=torch.zeros((*lead, h, w, 2), **z),
        outer=torch.zeros((*lead, h, w, 2, 2), **z),
        occ=torch.zeros((*lead, h, w), **z),
    )


def cell_index(params: NDTMapParams, origin, pts):
    """Point (..., 2) -> (iy, ix) integer cell coords (floor(p/res));
    `origin` broadcasts against `pts`."""
    rel = (pts - origin) / params.resolution
    ix = torch.floor(rel[..., 0]).to(torch.int32)
    iy = torch.floor(rel[..., 1]).to(torch.int32)
    return iy, ix


def in_bounds(params: NDTMapParams, iy, ix):
    return (
        (iy >= 0) & (iy < params.grid_h) & (ix >= 0) & (ix < params.grid_w)
    )


def scatter_add_rows(bases, idx, vals):
    """[base + the rows of val added at `idx`] for each (base (N, c),
    val (M, c)) pair, one shared index (M,) in [0, N).  Every cell sums
    its contributions one after another onto its old value, in the
    order of `idx` — XLA's and the CPU's order — so a map update repeats
    bit for bit and the card gives the CPU's bits.

    That is cuda_kernels.segment_add_rows: `index_add` (a serial loop)
    on the CPU; on the card the hand-written segment-sum kernel for all
    the pairs, two launches and no sort: a bucket pass groups each tile
    of entries by block of rows, keeping entry order, and a row pass
    adds each touched cell's entries in entry order onto its old row.
    Nothing rests on the order in which torch's own scatters add
    (`index_add` adds with atomics on the card)."""
    # cuda_kernels imports this module (CellList), so it is imported
    # here, at the call.
    from ndt_feature_graph_tpu_torch.ops import cuda_kernels

    return cuda_kernels.segment_add_rows(
        [b.contiguous() for b in bases], idx.contiguous(),
        [v.contiguous() for v in vals])


def _scatter_add_rows_sorted(bases, idx, vals):
    """The card's branch of scatter_add_rows before the segment-sum
    kernel, on no path now: kept as the yardstick the kernel is timed
    and checked against (chip_smoke.py phase 3e).  Its sums start from
    +0.0, so a -0.0 row whose entries sum to a zero comes out +0.0
    where index_add keeps -0.0.  It relies on torch
    2.11's CUDA `index_put_(accumulate=True)` stable-sorting the indices
    and adding each index's entries sequentially for rows of 2 to 32
    floats (one channel is padded to two), which torch does not
    document (any device; on the CPU it is sequential only on one
    thread).  Its list holds 2M entries, not
    N + M, so its cost follows the points, not the grid stack: each
    touched cell sums in the slot of its first entry (an integer min
    over positions, exact in any order), where that entry's old row goes
    first; the other entries' old rows go to rows of their own past M,
    so no cell's run of entries grows."""
    m = idx.shape[0]
    widths = [b.shape[1] for b in bases]
    old = torch.cat(bases, 1)
    new = torch.cat(vals, 1)
    if old.shape[1] == 1:
        old = torch.cat([old, torch.zeros_like(old)], 1)
        new = torch.cat([new, torch.zeros_like(new)], 1)
    pos = torch.arange(m, device=idx.device)
    slot = torch.full((old.shape[0],), m, dtype=pos.dtype,
                      device=idx.device).scatter_reduce_(
                          0, idx, pos, "amin")[idx]
    acc = old.new_zeros((2 * m, old.shape[1])).index_put_(
        (torch.cat([torch.where(slot == pos, slot, m + pos), slot]),),
        torch.cat([old[idx], new]), accumulate=True)
    # Entries of one cell write the same summed row.
    rows = old.index_put((idx,), acc[slot])
    return list(rows[:, :sum(widths)].split(widths, 1))


def _drop_rows(shape, n_cells: int, device):
    """Cells for the dropped entries of an index of `shape`: entry k
    (flattened) at cell k mod n_cells."""
    k = torch.arange(math.prod(shape), device=device)
    return (k if k.numel() <= n_cells else k % n_cells).reshape(shape)


def add_points_touched(grid: NDTGrid, params: NDTMapParams, pts, mask):
    """Scatter a masked point batch (..., P, 2) into the sufficient
    statistics of a grid (or a stack of grids, one per leading index)
    and return the touched flat cell indices (..., P) within each grid
    (sentinel h*w for dropped points)."""
    iy, ix = cell_index(params, grid.origin[..., None, :], pts)
    # NaN guard: int casts of NaN are platform-defined and can pass the
    # bounds check.
    finite = torch.isfinite(pts).all(-1)
    ok = mask & finite & in_bounds(params, iy, ix)
    h, w = params.grid_h, params.grid_w
    flat = torch.where(ok, iy * w + ix, h * w).to(torch.int64)
    ptsm = torch.where(ok[..., None], pts, 0.0)
    # Dropped points carry zero contributions: each adds them at a cell
    # of its own instead of the reference's mode="drop".
    lead = pts.shape[:-2]
    fi = torch.where(ok, flat + _stream_offsets(lead, h * w, pts.device),
                     _drop_rows(ok.shape, math.prod(lead) * h * w,
                                pts.device)).reshape(-1)
    op = ptsm[..., :, None] * ptsm[..., None, :]
    count, psum, outer = scatter_add_rows(
        [grid.count.reshape(-1, 1), grid.psum.reshape(-1, 2),
         grid.outer.reshape(-1, 4)],
        fi, [ok.reshape(-1, 1).to(grid.count.dtype), ptsm.reshape(-1, 2),
             op.reshape(-1, 4)])
    count = count.reshape(grid.count.shape)
    psum = psum.reshape(grid.psum.shape)
    outer = outer.reshape(grid.outer.shape)
    return dataclasses.replace(grid, count=count, psum=psum,
                               outer=outer), flat


def add_points(grid: NDTGrid, params: NDTMapParams, pts, mask) -> NDTGrid:
    grid, _ = add_points_touched(grid, params, pts, mask)
    return grid


def update_occupancy(grid: NDTGrid, params: NDTMapParams, sensor_origin,
                     pts, mask) -> NDTGrid:
    """Log-odds occupancy along beams: endpoint cells get `occ_hit`,
    cells sampled along the ray (`ray_samples` per beam) get
    `occ_miss`, then every cell is clamped to +-`occ_clamp`.
    sensor_origin (..., 2), pts (..., P, 2), mask (..., P): leading dims
    index a stack of grids.

    cuda_kernels.update_occupancy: on the card the occupancy kernel (two
    launches, integer counts a cell, no sort), on the CPU
    _update_occupancy_plain; the same bits on both."""
    from ndt_feature_graph_tpu_torch.ops import cuda_kernels

    return cuda_kernels.update_occupancy(grid, params, sensor_origin, pts,
                                         mask)


def _update_occupancy_plain(grid: NDTGrid, params: NDTMapParams,
                            sensor_origin, pts, mask) -> NDTGrid:
    """The plain version of update_occupancy: the rays built eagerly,
    each cell taking its hits, then its misses, in point order through
    scatter_add_rows, then the clamp.  On the card it is the path the
    occupancy kernel replaced, kept as its yardstick (chip_smoke.py
    phase 3e)."""
    h, w = params.grid_h, params.grid_w
    iy, ix = cell_index(params, grid.origin[..., None, :], pts)
    mask = mask & torch.isfinite(pts).all(-1)
    ok = mask & in_bounds(params, iy, ix)
    flat = (iy * w + ix).to(torch.int64)

    s = (torch.arange(params.ray_samples, device=pts.device,
                      dtype=torch.float32) + 0.5) / params.ray_samples
    so = sensor_origin[..., None, None, :]
    ray = so + s[:, None] * (pts[..., :, None, :] - so)   # (..., P, S, 2)
    riy, rix = cell_index(params, grid.origin[..., None, None, :], ray)
    rok = mask[..., None] & in_bounds(params, riy, rix)
    rok = rok & ~((riy == iy[..., None]) & (rix == ix[..., None]))
    rflat = (riy * w + rix).flatten(-2).to(torch.int64)
    lead = pts.shape[:-2]
    offs = _stream_offsets(lead, h * w, pts.device)
    # Masked entries add exactly zero, each at a cell of its own; each
    # cell takes its hits, then its misses, in point order.
    keep = torch.cat([ok.reshape(-1), rok.reshape(-1)])
    idx = torch.cat([(flat + offs).reshape(-1), (rflat + offs).reshape(-1)])
    occ, = scatter_add_rows(
        [grid.occ.reshape(-1, 1)],
        torch.where(keep, idx, _drop_rows(keep.shape,
                                          math.prod(lead) * h * w,
                                          pts.device)),
        [torch.cat([torch.where(ok, params.occ_hit, 0.0).reshape(-1),
                    torch.where(rok, params.occ_miss, 0.0).reshape(-1)])[
                        :, None]])
    occ = occ.reshape(grid.occ.shape).clamp(-params.occ_clamp,
                                            params.occ_clamp)
    return dataclasses.replace(grid, occ=occ)


def _sym_eig_2x2(c):
    """Closed-form eigendecomposition of symmetric 2x2 matrices
    (..., 2, 2) -> (evals (..., 2) ascending, evecs (..., 2, 2))."""
    a = c[..., 0, 0]
    b = c[..., 0, 1]
    d = c[..., 1, 1]
    tr = a + d
    diff = a - d
    disc = torch.sqrt(diff * diff + 4.0 * b * b + 1e-20)
    l0 = 0.5 * (tr - disc)
    l1 = 0.5 * (tr + disc)
    big_b = torch.abs(b) > 1e-12
    one = torch.ones_like(a)
    zero = torch.zeros_like(a)
    vx = torch.where(big_b, b, torch.where(diff >= 0, one, zero))
    vy = torch.where(big_b, l1 - a, torch.where(diff >= 0, zero, one))
    n = torch.sqrt(vx * vx + vy * vy + 1e-20)
    v1 = torch.stack([vx / n, vy / n], -1)
    v0 = torch.stack([-v1[..., 1], v1[..., 0]], -1)
    return torch.stack([l0, l1], -1), torch.stack([v0, v1], -1)


def condition_cov(cov, min_eig_ratio=1e-3, min_eig_abs=1e-6):
    """Clamp the small eigenvalue to `min_eig_ratio` of the large one."""
    evals, evecs = _sym_eig_2x2(cov)
    lmax = torch.clamp(evals[..., 1], min=min_eig_abs)
    lmin = torch.maximum(evals[..., 0], min_eig_ratio * lmax)
    lam = torch.stack([lmin, lmax], -1)
    return torch.einsum("...ij,...j,...kj->...ik", evecs, lam, evecs)


def finalize_stats(count, psum, outer, params: NDTMapParams):
    """(mean, cov, valid) from sufficient statistics, batched over any
    leading dims: sample variance, valid where count >=
    min_points_per_cell and the conditioned covariance has a positive
    determinant; invalid cells get eye * 1e-3."""
    n = count
    valid = n >= params.min_points_per_cell
    nsafe = torch.clamp(n, min=1.0)
    mean = psum / nsafe[..., None]
    mm = mean[..., :, None] * mean[..., None, :]
    cov = (outer - nsafe[..., None, None] * mm) / torch.clamp(
        nsafe - 1.0, min=1.0
    )[..., None, None]
    cov = condition_cov(cov)
    det = cov[..., 0, 0] * cov[..., 1, 1] - cov[..., 0, 1] * cov[..., 1, 0]
    valid = valid & (det > 1e-12)
    eye = torch.eye(2, dtype=cov.dtype, device=cov.device) * 1e-3
    cov = torch.where(valid[..., None, None], cov, eye)
    return mean, cov, valid


def finalize(grid: NDTGrid, params: NDTMapParams):
    """(means (H,W,2), covs (H,W,2,2), valid (H,W))."""
    return finalize_stats(grid.count, grid.psum, grid.outer, params)


def nonzero_fixed(flags, size: int, fill_value: int):
    """`jnp.nonzero(flags, size=size, fill_value=fill_value)[0]` along
    the last dim of a bool tensor: ascending positions of the set
    entries, padded with `fill_value` — by cumsum-scatter compaction
    into a buffer with one sentinel slot (no data-dependent shape)."""
    n = flags.shape[-1]
    pos = torch.cumsum(flags.to(torch.int64), -1) - 1
    slot = torch.where(flags & (pos < size), pos, size)
    out = torch.full((*flags.shape[:-1], size + 1), fill_value,
                     dtype=torch.int64, device=flags.device)
    out.scatter_(-1, slot, torch.arange(n, device=flags.device).expand_as(
        slot))
    return out[..., :size]


def unique_fixed(values, size: int, fill_value: int):
    """`jnp.unique(values, size=size, fill_value=fill_value)` along the
    last dim of an integer tensor: the ascending distinct values, padded
    with `fill_value` — sort, keep the first of each run, compact."""
    srt = torch.sort(values, dim=-1).values
    first = torch.ones_like(srt, dtype=torch.bool)
    first[..., 1:] = srt[..., 1:] != srt[..., :-1]
    pos = torch.cumsum(first.to(torch.int64), -1) - 1
    slot = torch.where(first & (pos < size), pos, size)
    out = torch.full((*srt.shape[:-1], size + 1), fill_value,
                     dtype=srt.dtype, device=srt.device)
    out.scatter_(-1, slot, srt)
    return out[..., :size]


def to_cell_list(grid: NDTGrid, params: NDTMapParams) -> CellList:
    """Compact the valid gaussians (of each grid of a stack) into a
    fixed-capacity padded list."""
    mean, cov, valid = finalize(grid, params)
    h, w = params.grid_h, params.grid_w
    flat_valid = valid.flatten(-2)
    idx = nonzero_fixed(flat_valid, params.max_cells, h * w - 1)
    got = torch.arange(params.max_cells, device=idx.device) < (
        flat_valid.sum(-1, keepdim=True))
    return CellList(
        means=take_rows(mean.flatten(-3, -2), idx),
        covs=take_rows(cov.flatten(-4, -3), idx),
        mask=got,
    )


def _stats_at(grid: NDTGrid, idx):
    """(count, psum, outer) of the flat cells `idx` (..., M) of each
    grid."""
    return (take_rows(grid.count.flatten(-2), idx),
            take_rows(grid.psum.flatten(-3, -2), idx),
            take_rows(grid.outer.flatten(-4, -3), idx))


def to_cell_list_touched(grid: NDTGrid, params: NDTMapParams,
                         flat_touched) -> CellList:
    """to_cell_list for a grid built from ONE scan: finalize and compact
    only the unique touched candidates (same cells, same ascending
    order as to_cell_list whenever they fit max_cells; the padded rows
    differ)."""
    h, w = params.grid_h, params.grid_w
    cap = params.max_cells
    cand = unique_fixed(flat_touched, cap, h * w)
    mean, cov, valid = finalize_stats(
        *_stats_at(grid, cand.clamp(max=h * w - 1)), params)
    valid = valid & (cand < h * w)
    idx = nonzero_fixed(valid, cap, cap - 1)
    got = torch.arange(cap, device=idx.device) < valid.sum(-1, keepdim=True)
    return CellList(means=take_rows(mean, idx), covs=take_rows(cov, idx),
                    mask=got)


def recenter_with_aux(grid: NDTGrid, params: NDTMapParams, new_center,
                      aux=None, aux_fill=None):
    """Shift the grid window (each window of a stack) by whole cells so
    it is centred, to cell quantization, on `new_center` (..., 2) world
    coords — the rolling map.  Cells that stay inside keep their
    statistics and occupancy exactly, cells off the trailing edge are
    dropped, newly exposed cells start empty.  An optional companion
    (..., H*W, C) per-cell table `aux` (the fuser's packed table) moves
    in lockstep, exposed rows set to `aux_fill` (C,).  The shift is a
    device integer applied as an index gather: no host read; a zero
    shift is an exact no-op.  Returns (grid, aux or None)."""
    res = params.resolution
    h, w = params.grid_h, params.grid_w
    dev = grid.origin.device
    cur_center = torch.stack([grid.origin[..., 0] + params.size_x / 2.0,
                              grid.origin[..., 1] + params.size_y / 2.0], -1)
    shift = torch.round((new_center.to(grid.origin.dtype) - cur_center)
                        / res).to(torch.int64)         # (..., 2) = (sx, sy)
    new_origin = grid.origin + shift.to(grid.origin.dtype) * res
    # The cell at new index (iy, ix) held old index (iy + sy, ix + sx).
    iy = torch.arange(h, device=dev)[:, None] + shift[..., 1, None, None]
    ix = torch.arange(w, device=dev)[None, :] + shift[..., 0, None, None]
    keep = ((iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)).flatten(-2)
    src = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).flatten(-2)

    def mv(a, fill=0.0):
        """a (..., H*W, *r) moved; exposed cells get `fill`."""
        k = keep.reshape(keep.shape + (1,) * (a.dim() - keep.dim()))
        return torch.where(k, take_rows(a, src), fill)

    g = NDTGrid(
        origin=new_origin,
        count=mv(grid.count.flatten(-2)).reshape(grid.count.shape),
        psum=mv(grid.psum.flatten(-3, -2)).reshape(grid.psum.shape),
        outer=mv(grid.outer.flatten(-4, -3)).reshape(grid.outer.shape),
        occ=mv(grid.occ.flatten(-2)).reshape(grid.occ.shape),
    )
    return g, None if aux is None else mv(aux, aux_fill)


def occupancy_rescaled(grid: NDTGrid):
    """Occupancy in [0, 1] (NDTCell::getOccupancyRescaled): 0.5 is no
    information."""
    return torch.sigmoid(grid.occ)


def build_from_scan(params: NDTMapParams, center, sensor_origin, pts,
                    mask) -> NDTGrid:
    """One-shot: empty grid + points + occupancy (the per-scan local map
    `ndglobal`, fuser_hmt.cpp:195-232), through the fixed-order
    scatter."""
    g = empty_grid(params, center)
    g = add_points(g, params, pts, mask)
    return update_occupancy(g, params, sensor_origin, pts, mask)


def recenter(grid: NDTGrid, params: NDTMapParams, new_center) -> NDTGrid:
    """recenter_with_aux without a companion table."""
    return recenter_with_aux(grid, params, new_center)[0]
