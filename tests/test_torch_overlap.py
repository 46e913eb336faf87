"""The link paths' overlap score (cuda_kernels.overlap_score,
csrc/overlap.cu) on the CPU: chip_smoke.overlap_mirror, a numpy mirror of
the kernel (its rounding of each operation and its fixed order of adds),
against the port's eager score (cuda_kernels.overlap_score_reference,
the CPU's path) and the JAX package's occupancy_overlap_score / _overlap_score_flat,
on small banks made from a seed; and the CPU path's bits.  The card
tests (tests/test_torch_cuda.py) hold the kernel to the same mirror bit
for bit.

Tolerances, each with its reason:
  * mirror vs the eager path: the same cell indices and counts exactly
    (the mirror rounds the transform as the eager einsum does, a
    product then a fused multiply-add, on the CPU as on the card); the
    score within 1e-6 (OVERLAP_SCORE_TOL): the two sum the same squares
    in other orders.
  * mirror vs JAX: 1e-5 on the score, as tests/test_torch_links.py
    holds the overlap (sigmoid and transform round by ulps), and the
    same counts.
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_feature_graph_tpu.graph import links as jl
from ndt_feature_graph_tpu_torch.graph import links as tl
from ndt_feature_graph_tpu_torch.core import se2 as tse2
from ndt_feature_graph_tpu_torch.ops import cuda_kernels

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

SHAPES = [(20, 20), (40, 40), (37, 53), (200, 200)]
PAIRS = [1, 3, 17]
CPU_FNS = chip_smoke.torch_transcendentals(torch.device("cpu"))


def _torch_case(case):
    occ, origins, ref_i, mov_i, T, res = case
    return (torch.as_tensor(occ.reshape(-1)), torch.as_tensor(origins),
            torch.as_tensor(ref_i), torch.as_tensor(mov_i),
            torch.as_tensor(T), res)


def _eager(case, h, w):
    occ_flat, origins, ref_i, mov_i, T, res = _torch_case(case)
    return cuda_kernels.overlap_score_reference(occ_flat, origins, ref_i,
                                                mov_i, T, h, w, res)


def _jax_flat(case, h, w):
    occ, origins, ref_i, mov_i, T, res = case
    fn = jax.vmap(functools.partial(jl._overlap_score_flat, h=h, w=w,
                                    resolution=res),
                  in_axes=(None, None, 0, 0, 0))
    s, n = fn(jnp.asarray(occ.reshape(-1)), jnp.asarray(origins),
              jnp.asarray(ref_i, jnp.int32), jnp.asarray(mov_i, jnp.int32),
              jnp.asarray(T))
    return np.asarray(s), np.asarray(n)


def _check_against_eager(case, h, w):
    """The mirror (with torch's CPU transcendentals, the eager path's)
    against the eager score: cells and counts exactly, scores within
    OVERLAP_SCORE_TOL."""
    occ, origins, ref_i, mov_i, T, res = case
    score, nb, cells = chip_smoke.overlap_mirror(*case[:5], h, w, res,
                                                 fns=CPU_FNS)
    e_score, e_nb = _eager(case, h, w)
    _, o, r, m, t, _ = _torch_case(case)
    e_cells = chip_smoke.overlap_cells_eager(o, r, m, t, h, w, res)
    np.testing.assert_array_equal(cells, e_cells.numpy())
    np.testing.assert_array_equal(nb, e_nb.numpy())
    np.testing.assert_allclose(score, e_score.numpy(), rtol=0,
                               atol=chip_smoke.OVERLAP_SCORE_TOL)
    return score, nb


@pytest.mark.parametrize("n_pairs", PAIRS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mirror_matches_the_eager_path_and_jax(shape, n_pairs):
    """At grids of 400 to 40,000 cells (1,961: not a multiple of four,
    the kernel's scalar loads), one to seventeen pairs: the mirror's
    cells, counts and scores against the port's eager path; its counts
    and scores (numpy's transcendentals) against JAX's
    _overlap_score_flat."""
    h, w = shape
    case = chip_smoke.overlap_case(h, w, n_pairs, seed=h * 131 + n_pairs)
    score, nb = _check_against_eager(case, h, w)
    assert (nb > 0).any()
    np_score, np_nb, _ = chip_smoke.overlap_mirror(*case[:5], h, w, case[5])
    j_score, j_nb = _jax_flat(case, h, w)
    np.testing.assert_array_equal(np_nb, j_nb)
    np.testing.assert_allclose(np_score, j_score, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(np_nb, nb)


@pytest.mark.parametrize("shape", [(40, 40), (37, 53)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_mirror_matches_jax_one_pair(shape):
    """One pair against JAX's occupancy_overlap_score (its NodeData read
    for occ and occ_origin only)."""
    h, w = shape
    occ, origins, ref_i, mov_i, T, res = chip_smoke.overlap_case(
        h, w, 1, seed=5)
    score, nb, _ = chip_smoke.overlap_mirror(occ, origins, ref_i, mov_i, T,
                                             h, w, res)

    class Node:
        def __init__(self, k):
            self.occ = jnp.asarray(occ[k].reshape(h, w))
            self.occ_origin = jnp.asarray(origins[k])

    s, n = jl.occupancy_overlap_score(Node(ref_i[0]), Node(mov_i[0]),
                                      jnp.asarray(T[0]), res)
    assert int(n) == int(nb[0]) > 0
    np.testing.assert_allclose(float(s), score[0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("edge", chip_smoke.OVERLAP_EDGE_CASES)
@pytest.mark.parametrize("shape", [(20, 20), (37, 53)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_mirror_edge_cases(shape, edge):
    """No overlap (score 1.0, count 0), every cell moved off the map
    (also beyond int32), log-odds at exactly +-1e-6, the next float and
    -0.0, centres on cell edges: the mirror against the eager path and
    JAX."""
    h, w = shape
    case = chip_smoke.overlap_case(h, w, 6, seed=11, edge=edge)
    score, nb = _check_against_eager(case, h, w)
    j_score, j_nb = _jax_flat(case, h, w)
    np.testing.assert_array_equal(nb, j_nb)
    np.testing.assert_allclose(score, j_score, rtol=0, atol=1e-5)
    if edge == "no overlap":
        none = case[2] == 0
        assert none.any() and (nb[none] == 0).all()
        assert (score[none] == 1.0).all()
    if edge.endswith("out of bounds"):
        assert (nb == 0).all() and (score == 1.0).all()
    if edge == "thresholds":
        occ = case[0]
        assert (np.abs(occ) == chip_smoke.OVERLAP_HAS).any()
        assert (np.signbit(occ) & (occ == 0)).any()
    if edge == "cell edges":
        _, o, r, m, t, res = _torch_case(case)
        centers = o[m][:, None, :] + cuda_kernels._cell_centers(h, w, res,
                                                                "cpu")
        rel = (tse2.transform_points(t, centers) - o[r][:, None, :]) / res
        assert torch.equal(rel, torch.round(rel))


@pytest.mark.parametrize("shape", [(40, 40), (37, 53), (200, 200)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_mirror_row_is_the_pair_alone(shape):
    """The order is a function of H*W alone: each pair's row of a batch
    of 17 equals that pair scored alone, bit for bit."""
    h, w = shape
    occ, origins, ref_i, mov_i, T, res = chip_smoke.overlap_case(
        h, w, 17, seed=3)
    score, nb, cells = chip_smoke.overlap_mirror(occ, origins, ref_i, mov_i,
                                                 T, h, w, res)
    for k in (0, 8, 16):
        s1, n1, c1 = chip_smoke.overlap_mirror(
            occ, origins, ref_i[k:k + 1], mov_i[k:k + 1], T[k:k + 1], h, w,
            res)
        assert s1.view(np.uint32)[0] == score.view(np.uint32)[k]
        assert n1[0] == nb[k] and np.array_equal(c1[0], cells[k])


@pytest.mark.parametrize("hw,cluster", [(400, 1), (1024, 1), (1028, 2),
                                        (1961, 2), (8192, 8), (40000, 8)])
def test_cluster_is_a_function_of_the_grid(hw, cluster):
    """One block a 256 vectors of four cells, at most the portable 8."""
    assert chip_smoke.overlap_cluster(hw) == cluster


def test_fma32_rounds_once():
    """The mirror's fused multiply-add against exact rational arithmetic,
    on random values and on sums that fall on a float32 midpoint."""
    from fractions import Fraction
    rng = np.random.default_rng(0)
    a = rng.standard_normal(2000).astype(np.float32)
    b = rng.standard_normal(2000).astype(np.float32)
    c = rng.standard_normal(2000).astype(np.float32)
    # Products 2^-24 (1 -+ 2^-46) = 2^-24 -+ 2^-70 added to 1 or to
    # 1 + 2^-23: float64 rounds each sum onto a float32 midpoint, which
    # the remainder 2^-70 decides (rounding the float64 sum to float32
    # would take the even side every time).
    u = np.float32(2.0 ** -12) * (np.float32(1) + np.float32(2.0 ** -23))
    v = np.float32(2.0 ** -12) * (np.float32(1) - np.float32(2.0 ** -23))
    up = np.float32(1) + np.float32(2.0 ** -23)
    a[:3] = u
    b[:3] = np.array([-v, v, v], np.float32)
    c[:3] = np.array([up, 1, up], np.float32)
    got = chip_smoke.fma32(a, b, c)
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(exact))
        cands = [lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))]
        errs = [abs(Fraction(float(v)) - exact) for v in cands]
        best = min(errs)
        ties = [v for v, e in zip(cands, errs) if e == best]
        want = (ties[0] if len(ties) == 1 else
                [v for v in ties if not (v.view(np.uint32) & 1)][0])
        assert g == want, (x, y, z)


def _parent_overlap(mov_occ_raw, mov_origin, ref_lookup, ref_origin, T, h,
                    w, res):
    """The eager score as links._overlap computed it before the kernel,
    its sum over the cells torch.sum (the CPU's)."""
    ys = (torch.arange(h, dtype=torch.float32) + 0.5) * res
    xs = (torch.arange(w, dtype=torch.float32) + 0.5) * res
    rel_c = torch.stack([xs[None, :].expand(h, w),
                         ys[:, None].expand(h, w)], -1).reshape(-1, 2)
    centers = mov_origin[..., None, :] + rel_c
    mov_occ = torch.sigmoid(mov_occ_raw)
    mov_has = mov_occ_raw.abs() > 1e-6
    tp = tse2.transform_points(T, centers)
    rel = (tp - ref_origin[..., None, :]) / res
    ix = torch.floor(rel[..., 0]).to(torch.int64)
    iy = torch.floor(rel[..., 1]).to(torch.int64)
    inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    flat = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
    ref_occ_raw = ref_lookup(flat)
    ref_has = (ref_occ_raw.abs() > 1e-6) & inb
    ref_occ = torch.sigmoid(ref_occ_raw)
    both = mov_has & ref_has
    nb = both.sum(-1)
    diff2 = (mov_occ - ref_occ) ** 2
    s = torch.where(both, diff2, 0.0).sum(-1) / torch.clamp(nb, min=1)
    return torch.where(nb > 0, s, 1.0), nb


@pytest.mark.parametrize("shape", [(40, 40), (200, 200)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_cpu_path_keeps_the_parents_bits(shape):
    """On CPU tensors overlap_score (and so _overlap_score_flat and
    occupancy_overlap_score) is the eager score with torch.sum: the
    parent's expressions, bit for bit, and no launch."""
    h, w = shape
    hw = h * w
    occ_flat, origins, ref_i, mov_i, T, res = _torch_case(
        chip_smoke.overlap_case(h, w, 5, seed=2))
    cuda_kernels.reset_launch_counts()
    got = tl._overlap_score_flat(occ_flat, origins, ref_i, mov_i, T, h, w,
                                 res)
    ref_base = (ref_i.to(torch.int64) * hw)[:, None]
    want = _parent_overlap(occ_flat.reshape(-1, hw)[mov_i], origins[mov_i],
                           lambda flat: occ_flat[ref_base + flat],
                           origins[ref_i], T, h, w, res)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    bank = occ_flat.reshape(-1, h, w)
    one = cuda_kernels.overlap_score(
        bank[0].reshape(-1), origins[0], None, None, T[0], h, w, res,
        mov_flat=bank[1].reshape(-1), mov_origins=origins[1])
    want_one = _parent_overlap(bank[1].reshape(-1), origins[1],
                               lambda flat: bank[0].reshape(-1)[flat],
                               origins[0], T[0], h, w, res)
    assert all(torch.equal(a, b) for a, b in zip(one, want_one))
    assert one[0].shape == () and one[1].dtype == torch.int64
    assert not any(cuda_kernels.LAUNCHES.values())


def test_overlap_score_rejects_what_the_kernel_does_not_take():
    """Another device than the CPU or a card raises; so does asking for
    the kernel's cell indices on the CPU (no plain version of them)."""
    meta = torch.zeros(3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_kernels.overlap_score(meta, meta, None, None, meta, 1, 1, 0.5)
    occ_flat, origins, ref_i, mov_i, T, res = _torch_case(
        chip_smoke.overlap_case(20, 20, 2, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.overlap_score(occ_flat, origins, ref_i, mov_i, T, 20,
                                   20, res, cells=True)


def _group_search(mov_i, n_mov, group, k):
    """csrc/overlap.cu overlap_group_kernel's search for cluster k's
    group, in numpy: a key a pair (its moving node, n_mov outside the
    bank), the groups a key (ceil(count / group)) and their prefix in key
    order, then the key's pairs at positions [run * group, ...) in index
    order.  Returns (key, members) or (None, []) for an idle cluster."""
    mov_i = np.asarray(mov_i)
    key = np.where((mov_i >= 0) & (mov_i < n_mov), mov_i, n_mov)
    count = np.bincount(key, minlength=n_mov + 1)
    groups = -(-count // group)
    start = np.concatenate([[0], np.cumsum(groups)[:-1]])
    hit = np.nonzero((k >= start) & (k < start + groups))[0]
    if hit.size == 0:
        return None, []
    m = int(hit[0])
    first = (k - int(start[m])) * group
    pairs = np.nonzero(key == m)[0]
    return m, pairs[first:first + group].tolist()


@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("layout", ["offline", "online", "random",
                                    "outside"])
def test_group_search_covers_every_pair_once(layout, group):
    """The groups the overlap kernel's clusters find (the launch's
    overlap_groups clusters, the ones past the groups idle) cover every
    pair exactly once; each group's pairs share their moving key, come
    in index order and number at most `group`.  Layouts: the offline
    graph's candidate pairs of 20 nodes (i < j, 171 pairs) repeated to
    1,024, online LC's four candidates against one moving node, random
    pairs, and moving indices outside the bank."""
    rng = np.random.default_rng(group)
    n_mov = 20
    if layout == "offline":
        mov = np.array([j for i in range(20) for j in range(i + 1, 20)])
        mov = np.resize(mov, 1024)
    elif layout == "online":
        mov = np.full(4, 4)
        n_mov = 5
    elif layout == "random":
        mov = rng.integers(0, n_mov, 300)
    else:
        mov = rng.integers(-3, n_mov + 3, 300)
    n_clusters = cuda_kernels.overlap_groups(len(mov), group, n_mov)
    seen = []
    for k in range(n_clusters):
        key, members = _group_search(mov, n_mov, group, k)
        if key is None:
            continue
        assert 0 < len(members) <= group and members == sorted(members)
        keys = {int(m) if 0 <= m < n_mov else n_mov for m in mov[members]}
        assert keys == {key}
        seen += members
    assert sorted(seen) == list(range(len(mov)))


@pytest.mark.parametrize("n_pairs,hw,n_mov,path", [
    (1, 40000, 20, 0), (4, 40000, 5, 0), (64, 40000, 20, 0),
    (128, 40000, 20, 0), (159, 40000, 20, 0), (160, 40000, 20, 4),
    (171, 40000, 20, 4),
    (255, 40000, 20, 4), (256, 40000, 20, 8), (1024, 40000, 20, 8),
    (4096, 40000, 20, 8), (171, 1600, 20, 4), (171, 49152, 20, 4),
    (171, 49153, 20, 0), (171, 1_440_000, 20, 0), (171, 40000, 4096, 4),
    (171, 40000, 4097, 0)])
def test_overlap_size_rule(n_pairs, hw, n_mov, path):
    """The path overlap_score takes by P and H*W (and the moving bank's
    nodes): the pair path (0) below 160 pairs, for a grid whose vectors
    do not fit a thread's share of the group path (more than six a
    thread: beyond 49,152 cells) and for more than 4,096 moving nodes;
    else groups of 4 pairs below 256 pairs and of 8 from there."""
    group = cuda_kernels.overlap_group(n_pairs)
    fits = cuda_kernels.overlap_group_fits(hw, n_mov)
    assert (group if fits else 0) == path
    assert cuda_kernels.overlap_cluster(hw) == chip_smoke.overlap_cluster(hw)
