"""NDT grid builder (port of ndt_feature_graph_tpu/ops/ndt_map.py).

A dense, fixed-shape (H, W) cell grid of sufficient statistics (count,
sum, sum of outer products) plus occupancy log-odds, and a compact
padded cell-list view for registration sources.

Differences from the JAX reference, by construction:
  * No `mode="drop"` scatter in torch: contributions of dropped points
    are already zero, so their index is clamped onto a real cell and
    the zero is added there (exact).
  * No fixed-size `unique` / `nonzero`: both are rebuilt as sort +
    adjacent difference + cumsum-scatter compaction at the static
    capacity, with the reference's ascending order and fill values —
    no data-dependent shapes, no device sync.
"""

from __future__ import annotations

import dataclasses

import torch

from ndt_feature_graph_tpu_torch.config import NDTMapParams
from ndt_feature_graph_tpu_torch.core import se2


@dataclasses.dataclass
class NDTGrid:
    """Dense NDT submap. origin = world coords of the (0, 0) cell corner."""

    origin: torch.Tensor     # (2,)
    count: torch.Tensor      # (H, W)
    psum: torch.Tensor       # (H, W, 2)
    outer: torch.Tensor      # (H, W, 2, 2)
    occ: torch.Tensor        # (H, W) log-odds occupancy


@dataclasses.dataclass
class CellList:
    """Compact padded view of gaussians (registration sources)."""

    means: torch.Tensor      # (N, 2)
    covs: torch.Tensor       # (N, 2, 2)
    mask: torch.Tensor       # (N,) bool

    def transform(self, pose):
        """mean' = T mean, cov' = R cov R^T."""
        return CellList(
            se2.transform_points(pose, self.means),
            se2.rotate_covs(pose[..., 2], self.covs),
            self.mask,
        )

    def head(self, n: int) -> "CellList":
        return CellList(self.means[:n], self.covs[:n], self.mask[:n])


def empty_grid(params: NDTMapParams, center) -> NDTGrid:
    """Empty grid centred on `center` (2,) world coords (a tensor: the
    grid lives on its device)."""
    h, w = params.grid_h, params.grid_w
    center = center.to(torch.float32)
    z = dict(dtype=torch.float32, device=center.device)
    return NDTGrid(
        origin=torch.stack([center[0] - params.size_x / 2.0,
                            center[1] - params.size_y / 2.0]),
        count=torch.zeros((h, w), **z),
        psum=torch.zeros((h, w, 2), **z),
        outer=torch.zeros((h, w, 2, 2), **z),
        occ=torch.zeros((h, w), **z),
    )


def cell_index(params: NDTMapParams, origin, pts):
    """Point (..., 2) -> (iy, ix) integer cell coords (floor(p/res))."""
    rel = (pts - origin) / params.resolution
    ix = torch.floor(rel[..., 0]).to(torch.int32)
    iy = torch.floor(rel[..., 1]).to(torch.int32)
    return iy, ix


def in_bounds(params: NDTMapParams, iy, ix):
    return (
        (iy >= 0) & (iy < params.grid_h) & (ix >= 0) & (ix < params.grid_w)
    )


def add_points_touched(grid: NDTGrid, params: NDTMapParams, pts, mask):
    """Scatter a masked point batch (P, 2) into the sufficient statistics
    and return the touched flat cell indices (sentinel h*w for dropped
    points)."""
    iy, ix = cell_index(params, grid.origin, pts)
    # NaN guard: int casts of NaN are platform-defined and can pass the
    # bounds check.
    finite = torch.isfinite(pts).all(-1)
    ok = mask & finite & in_bounds(params, iy, ix)
    h, w = params.grid_h, params.grid_w
    flat = torch.where(ok, iy * w + ix, h * w).to(torch.int64)
    ptsm = torch.where(ok[..., None], pts, 0.0)
    # Dropped points carry zero contributions: clamp their index onto a
    # real cell instead of the reference's mode="drop".
    fi = flat.clamp(max=h * w - 1)
    count = grid.count.reshape(-1).index_add(
        0, fi, ok.to(grid.count.dtype)
    ).reshape(h, w)
    psum = grid.psum.reshape(-1, 2).index_add(0, fi, ptsm).reshape(h, w, 2)
    op = ptsm[..., :, None] * ptsm[..., None, :]
    outer = grid.outer.reshape(-1, 2, 2).index_add(0, fi, op).reshape(
        h, w, 2, 2
    )
    return dataclasses.replace(grid, count=count, psum=psum,
                               outer=outer), flat


def add_points(grid: NDTGrid, params: NDTMapParams, pts, mask) -> NDTGrid:
    grid, _ = add_points_touched(grid, params, pts, mask)
    return grid


def update_occupancy(grid: NDTGrid, params: NDTMapParams, sensor_origin,
                     pts, mask) -> NDTGrid:
    """Log-odds occupancy along beams: endpoint cells get `occ_hit`,
    cells sampled along the ray (`ray_samples` per beam) get
    `occ_miss`."""
    h, w = params.grid_h, params.grid_w
    iy, ix = cell_index(params, grid.origin, pts)
    mask = mask & torch.isfinite(pts).all(-1)
    ok = mask & in_bounds(params, iy, ix)
    flat = torch.where(ok, iy * w + ix, h * w - 1).to(torch.int64)

    s = (torch.arange(params.ray_samples, device=pts.device,
                      dtype=torch.float32) + 0.5) / params.ray_samples
    ray = sensor_origin[None, None, :] + s[None, :, None] * (
        pts[:, None, :] - sensor_origin[None, None, :]
    )  # (P, S, 2)
    riy, rix = cell_index(params, grid.origin, ray)
    rok = mask[:, None] & in_bounds(params, riy, rix)
    rok = rok & ~((riy == iy[:, None]) & (rix == ix[:, None]))
    rflat = torch.where(rok, riy * w + rix, h * w - 1).reshape(-1).to(
        torch.int64
    )
    # Masked entries add exactly zero onto a clamped index.
    occ = grid.occ.reshape(-1).index_add(
        0, flat, torch.where(ok, params.occ_hit, 0.0)
    ).index_add(
        0, rflat, torch.where(rok.reshape(-1), params.occ_miss, 0.0)
    )
    occ = occ.reshape(h, w).clamp(-params.occ_clamp, params.occ_clamp)
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
    """`jnp.nonzero(flags, size=size, fill_value=fill_value)[0]` for a
    1-D bool tensor: ascending positions of the set entries, padded with
    `fill_value` — by cumsum-scatter compaction into a buffer with one
    sentinel slot (no data-dependent shape)."""
    n = flags.shape[0]
    pos = torch.cumsum(flags.to(torch.int64), 0) - 1
    slot = torch.where(flags & (pos < size), pos, size)
    out = torch.full((size + 1,), fill_value, dtype=torch.int64,
                     device=flags.device)
    out.scatter_(0, slot, torch.arange(n, device=flags.device))
    return out[:size]


def unique_fixed(values, size: int, fill_value: int):
    """`jnp.unique(values, size=size, fill_value=fill_value)` for a 1-D
    integer tensor: the ascending distinct values, padded with
    `fill_value` — sort, keep the first of each run, compact."""
    srt = torch.sort(values).values
    first = torch.ones_like(srt, dtype=torch.bool)
    first[1:] = srt[1:] != srt[:-1]
    pos = torch.cumsum(first.to(torch.int64), 0) - 1
    slot = torch.where(first & (pos < size), pos, size)
    out = torch.full((size + 1,), fill_value, dtype=srt.dtype,
                     device=srt.device)
    out.scatter_(0, slot, srt)
    return out[:size]


def to_cell_list(grid: NDTGrid, params: NDTMapParams) -> CellList:
    """Compact the valid gaussians into a fixed-capacity padded list."""
    mean, cov, valid = finalize(grid, params)
    h, w = params.grid_h, params.grid_w
    flat_valid = valid.reshape(-1)
    idx = nonzero_fixed(flat_valid, params.max_cells, h * w - 1)
    got = torch.arange(params.max_cells, device=idx.device) < flat_valid.sum()
    return CellList(
        means=mean.reshape(-1, 2)[idx],
        covs=cov.reshape(-1, 2, 2)[idx],
        mask=got,
    )


def to_cell_list_touched(grid: NDTGrid, params: NDTMapParams,
                         flat_touched) -> CellList:
    """to_cell_list for a grid built from ONE scan: finalize and compact
    only the unique touched candidates (same cells, same ascending
    order as to_cell_list whenever they fit max_cells)."""
    h, w = params.grid_h, params.grid_w
    cap = params.max_cells
    cand = unique_fixed(flat_touched, cap, h * w)
    safe = cand.clamp(max=h * w - 1)
    n = grid.count.reshape(-1)[safe]
    ps = grid.psum.reshape(-1, 2)[safe]
    op = grid.outer.reshape(-1, 2, 2)[safe]
    mean, cov, valid = finalize_stats(n, ps, op, params)
    valid = valid & (cand < h * w)
    idx = nonzero_fixed(valid, cap, cap - 1)
    got = torch.arange(cap, device=idx.device) < valid.sum()
    return CellList(means=mean[idx], covs=cov[idx], mask=got)
