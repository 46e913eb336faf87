"""The dense NDT grid: a frozen copy of the port's plain map arithmetic
(statistics, finalisation, cell lists, the log-odds occupancy), with
every scatter an `index_add` in entry order."""

from __future__ import annotations

import dataclasses
import math

import torch

from port_bench.reference import se2
from port_bench.reference.config import NDTMapParams

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
    order of `idx`: `index_add` on the CPU (a serial loop; on the card
    it adds with atomics, in any order), whatever device the tensors are
    on, so that the sums are the CPU's bits, which the port's map kernels
    reproduce."""
    dev = idx.device
    idx = idx.cpu()
    return [b.cpu().index_add(0, idx, v.cpu()).to(dev)
            for b, v in zip(bases, vals)]


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
    index a stack of grids.  Computed on the CPU whatever the device, so
    that a ray sample on a cell's edge falls where the CPU's arithmetic
    puts it (the card's contracts to a fused multiply-add), as in the
    port's occupancy kernel."""
    dev = pts.device
    cpu = dataclasses.replace(grid, origin=grid.origin.cpu(),
                              occ=grid.occ.cpu())
    occ = _update_occupancy_plain(cpu, params, sensor_origin.cpu(),
                                  pts.cpu(), mask.cpu()).occ
    return dataclasses.replace(grid, occ=occ.to(dev))


def _update_occupancy_plain(grid: NDTGrid, params: NDTMapParams,
                            sensor_origin, pts, mask) -> NDTGrid:
    """The plain version of update_occupancy: the rays built eagerly,
    each cell taking its hits, then its misses, in point order through
    scatter_add_rows, then the clamp."""
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

