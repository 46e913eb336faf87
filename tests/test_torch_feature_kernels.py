"""The feature front end's kernels (cuda_kernels.detect_features,
describe_features, match_features; csrc/features.cu) on the CPU: a
torch-on-CPU mirror of each kernel's algorithm in the kernel's own order
of operations, held to the JAX package's functions on the canonical
fixture's first scans and pairs (720 beams, F = 32, C = 64, M = 256);
the dispatch (CPU tensors run the plain twins and launch nothing); the
gate epilogue against the reference's feature_fuser._prepare_features.
The card tests (tests/test_torch_cuda.py, chip_smoke.py) hold each
kernel to its plain twin.

The mirrors follow the kernels: the detector's cumulative arc in float64
(runs of three beams, a scan over the runs: `arc_runs`) and its window
sums in float64, each window in offset order, taken block by block of
the scan's cluster (`window_sums` over each block's beams), the
searches as a left binary search (torch.searchsorted), the responses,
peaks and the first-maximum scale, the top-K by counting ranks (a lower
index first among ties); the descriptor's bins per thread (beam t, t +
128, ... and the chord's 8 samples in order) and a fixed tree over the
128 threads (`mirror_describe`), and the kernel as it is built now
(`mirror_describe_replay`: every bin first, a byte a chord sample, at
any block size, then the 128 partial sums replayed in that order and
the same tree), which must give mirror_describe's bits; the matcher's row sums and chi2 sums in order, the first
minimum as the kernel's cluster takes it (each block's rows, 32 lanes
and a butterfly, then the blocks in order: `first_min_split`), the
stable top-C by rank, the MSAC sums over the C correspondences in
order, the first-minimum winner, the Procrustes sums as 32 lane
partials and a butterfly, the gate's poses.  Each product and sum
rounds once, as the kernels' (a division by a Python float as a product
with its reciprocal rounded to float32, as ATen's on the card).

Over all 200 canonical scans and 199 pairs, at every cluster size the
wrappers choose: the run-ordered arc equals a float64 cumsum's bits and
the split window sums the bits of the same weights summed in the plain
twin's order (float64 sums whose float32 roundings do not depend on the
order); the split first minimum keeps every choice of one block's
order.

Tolerances are tests/test_torch_features.py's: masks, scales, selected
beams, correspondences and inliers exactly; points and angles atol 2e-5;
responses rtol 1e-4; descriptors rtol 1e-5 / atol 1e-6; the pose atol
1e-5 and the score rtol 1e-5; the pseudo-cells atol 1e-5.  The responses
are held at rtol 1e-4 to the reference run in float64 (jax.enable_x64):
at 720 beams and 30 m the float32 reference's own rounding moves a
response by up to ~1e-4 relative (9.5e-5 on scan 1, against the mirror's
1.1e-5), so against the float32 reference that distance is added.
"""

import dataclasses
import functools
import math
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndt_feature_graph_tpu.config import FeatureParams, FuserParams
from ndt_feature_graph_tpu.features import descriptor as jdesc
from ndt_feature_graph_tpu.features import detector as jdet
from ndt_feature_graph_tpu.features import ransac as jr
from ndt_feature_graph_tpu.fusion import feature_fuser as jff
from ndt_feature_graph_tpu_torch import interop
from ndt_feature_graph_tpu_torch.features import descriptor as tdesc
from ndt_feature_graph_tpu_torch.features import detector as tdet
from ndt_feature_graph_tpu_torch.features import ransac as tr
from ndt_feature_graph_tpu_torch.io import dataset as tds
from ndt_feature_graph_tpu_torch.ops import cuda_kernels

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "ndt_feature_graph_tpu_torch" / "data" / "canonical_200.npz"
FP = FeatureParams(num_beams=720, max_range=30.0)   # the canonical point
TFP = interop.params_from_jax(FP)
SCANS = (0, 1, 2, 100)
PAIRS = ((0, 1), (1, 2), (99, 100), (0, 100))
DESCRIBE_THREADS = 128      # csrc/features.cu kDescribeThreads
RUN_THREADS = 256           # csrc/features.cu kScanRuns
SMS = 132                   # the H100's multiprocessors
F32 = np.float32


@functools.lru_cache(maxsize=None)
def _fixture():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in ("ranges", "hit", "ransac_u")}


def _scans(idx):
    fx = _fixture()
    return (torch.tensor(fx["ranges"][list(idx)]),
            torch.tensor(fx["hit"][list(idx)]))


@functools.lru_cache(maxsize=None)
def _jax_feats(t):
    fx = _fixture()
    r, h = jnp.asarray(fx["ranges"][t]), jnp.asarray(fx["hit"][t])
    f = jdet.detect(FP, r, h)
    return f, jdesc.describe(FP, f, r, h)


def _to_port(f):
    return interop.feature_set_from_jax(jax.tree.map(np.asarray, f), "cpu")


def _stack(sets):
    return tdet.FeatureSet(**{
        k.name: torch.stack([getattr(s, k.name) for s in sets])
        for k in dataclasses.fields(tdet.FeatureSet)})


def _recip(x):
    """ATen's reciprocal of a Python divisor on the card: taken in
    float64, rounded to float32 (0.2 * 1.4 ** 3 is the canonical scale
    where it differs from the float32 reciprocal of the float32 value)."""
    return float(F32(1.0 / x))


def fma32(a, b, c):
    """a * b + c rounded once (to float64, then float32: the double
    rounding differs from the kernel's fmaf only at float64 ties)."""
    return (a.double() * b.double() + c.double()).float()


def norm2(x, y):
    """torch.linalg.vector_norm of a pair as ATen rounds it on the card
    (the kernels' order; the CPU's fuses the second product)."""
    return torch.sqrt(x * x + y * y)


def ranks_desc(v):
    """Each entry's place in a stable descending order of the last dim:
    the count of larger values and of equal ones before it."""
    i = torch.arange(v.shape[-1])
    gt = (v[..., None, :] > v[..., :, None]).sum(-1)
    eq = ((v[..., None, :] == v[..., :, None])
          & (i[None, :] < i[:, None])).sum(-1)
    return gt + eq


def first_min(x):
    """Index of the first minimum of the last dim (a scan with a strict
    comparison, as the kernels')."""
    best = x[..., 0].clone()
    idx = torch.zeros(x.shape[:-1], dtype=torch.int64)
    for k in range(1, x.shape[-1]):
        less = x[..., k] < best
        best = torch.where(less, x[..., k], best)
        idx = torch.where(less, k, idx)
    return idx


def take(x, idx):
    return torch.gather(x, -1, idx)


def before(v, i, w, j):
    """(v, i) precedes (w, j) in a first-minimum scan."""
    return (v < w) | ((v == w) & (i < j))


def first_min_split(x, cluster):
    """(value, index) of the first minimum of the last dim as the match
    kernel takes it over a cluster: block r's rows [r ceil(n / cluster),
    ...), lane l of a warp its rows l, l + 32, ... in order, a butterfly
    over offsets 16 .. 1 keeping the lower row among equals, then the
    blocks in order (a later block only below)."""
    n = x.shape[-1]
    r1 = -(-n // cluster)
    big = torch.iinfo(torch.int64).max
    bv = bi = None
    for r in range(cluster):
        lo, hi = min(r * r1, n), min(r * r1 + r1, n)
        v = torch.full(x.shape[:-1] + (32,), math.inf)
        i = torch.full(x.shape[:-1] + (32,), big, dtype=torch.int64)
        for row in range(lo, hi):
            lane = (row - lo) % 32
            take_it = before(x[..., row], torch.tensor(row), v[..., lane],
                             i[..., lane])
            v[..., lane] = torch.where(take_it, x[..., row], v[..., lane])
            i[..., lane] = torch.where(take_it, row, i[..., lane])
        lanes = torch.arange(32)
        for o in (16, 8, 4, 2, 1):
            ov, oi = v[..., lanes ^ o], i[..., lanes ^ o]
            t = before(ov, oi, v, i)
            v, i = torch.where(t, ov, v), torch.where(t, oi, i)
        if r == 0:
            bv, bi = v[..., 0], i[..., 0]
        else:
            t = v[..., 0] < bv
            bv, bi = torch.where(t, v[..., 0], bv), torch.where(
                t, i[..., 0], bi)
    return bv, bi


# ---------------------------------------------------------------- detector

def scan_geometry(fp, ranges, hit):
    """The detector's points, segment lengths and piece ids (N, B)."""
    b = fp.num_beams
    ang = tds.beam_angles(b, device="cpu")
    px, py = ranges * torch.cos(ang), ranges * torch.sin(ang)
    seg = norm2(px - torch.roll(px, 1, -1), py - torch.roll(py, 1, -1))
    seg[..., 0] = 0.0
    jump = (ranges - torch.roll(ranges, 1, -1)).abs() > 0.5
    jump[..., 0] = False
    jump = jump | ~hit | ~torch.roll(hit, 1, -1)
    sid = torch.cumsum(jump.to(torch.int32), -1)
    return px, py, seg, sid


def _warp_scan(x):
    """Inclusive Hillis-Steele scan over the last dim (32 lanes): the
    kernel's shuffle-up scan, each step adding the value `o` lanes
    below."""
    x = x.clone()
    for o in (1, 2, 4, 8, 16):
        x[..., o:] = x[..., o:] + x[..., :-o].clone()
    return x


def arc_runs(seg):
    """The detector's cumulative arc (N, B) float32 in the kernel's
    order: each of RUN_THREADS threads adds its run of beams in float64,
    the runs' totals go through the block's exclusive scan (a warp scan,
    then one over the warps' totals), and each thread adds its run onto
    its offset."""
    n, b = seg.shape
    per = -(-b // RUN_THREADS)
    s64 = torch.nn.functional.pad(seg.double(), (0, per * RUN_THREADS - b))
    runs = s64.reshape(n, RUN_THREADS, per)
    tot = torch.zeros(n, RUN_THREADS, dtype=torch.float64)
    for k in range(per):
        tot = tot + runs[..., k]
    lanes = _warp_scan(tot.reshape(n, -1, 32))
    excl = torch.cat([torch.zeros_like(lanes[..., :1]), lanes[..., :-1]],
                     -1)
    warps = _warp_scan(torch.nn.functional.pad(lanes[..., -1],
                                               (0, 32 - lanes.shape[1])))
    before_w = torch.cat([torch.zeros_like(warps[..., :1]),
                          warps[..., :lanes.shape[1] - 1]], -1)
    off = (before_w[..., None] + excl).reshape(n, RUN_THREADS)
    out = torch.zeros(n, RUN_THREADS, per, dtype=torch.float64)
    for k in range(per):
        off = off + runs[..., k]
        out[..., k] = off
    return out.reshape(n, -1)[:, :b].float()


def window_sums(fp, px, py, cum, sid, hit, beams):
    """The smoothed points (S, N, len(beams), 2) of `beams`: each a
    (beam, scale) thread's float64 sums over the window in offset order
    (a window beam off the piece adds nothing), then the quotients."""
    b, n_s, half = fp.num_beams, fp.num_scales, fp.smooth_half_beams
    sig = [float(F32(fp.base_sigma * fp.sigma_step ** k))
           for k in range(n_s)]
    ar = torch.as_tensor(beams)
    inv = torch.tensor([_recip(x) for x in sig])[:, None, None]
    shape = (n_s, px.shape[0], ar.shape[0])
    ws, sx, sy = (torch.zeros(shape, dtype=torch.float64) for _ in range(3))
    for off in range(-half, half + 1):
        j = (ar + off).clamp(0, b - 1)
        same = (sid[..., j] == sid[..., ar]) & hit[..., j]
        q = (cum[..., j] - cum[..., ar]).abs() * inv         # (S, N, nb)
        w = torch.where(same, torch.exp(q * q * -0.5), 0.0).double()
        ws += w
        sx += w * px[..., j].double()
        sy += w * py[..., j].double()
    den = ws.clamp(min=1e-9)
    return torch.stack([(sx / den).float(), (sy / den).float()], -1)


def split_smoothing(fp, px, py, cum, sid, hit, cluster):
    """The smoothed points (S, N, B, 2) as a cluster of `cluster` blocks
    takes them: block r the beams [r ceil(B / cluster), ...)."""
    b = fp.num_beams
    per = -(-b // cluster)
    parts = [window_sums(fp, px, py, cum, sid, hit,
                         range(min(r * per, b), min(r * per + per, b)))
             for r in range(cluster)]
    return torch.cat(parts, 2)


def mirror_detect(fp, ranges, hit, cluster=8):
    """features_detect_kernel over scans (N, B), its window sums taken
    by a cluster of `cluster` blocks."""
    b, n_s, f = fp.num_beams, fp.num_scales, fp.max_features
    px, py, seg, sid = scan_geometry(fp, ranges, hit)
    cum = arc_runs(seg)
    sig = [float(F32(fp.base_sigma * fp.sigma_step ** k))
           for k in range(n_s)]
    ar = torch.arange(b)
    sm = split_smoothing(fp, px, py, cum, sid, hit, cluster)
    smx, smy = sm[..., 0], sm[..., 1]

    def search(k):
        fwd = torch.searchsorted(cum, cum + sig[k]).clamp(max=b - 1)
        bwd = torch.searchsorted(cum, cum - sig[k]).clamp(max=b - 1)
        return fwd, bwd

    resp = []
    for k in range(n_s):
        fwd, bwd = search(k)
        mx, my = smx[k], smy[k]
        fx, fy = take(mx, fwd) - mx, take(my, fwd) - my
        bx, by = mx - take(mx, bwd), my - take(my, bwd)
        dot = fx * bx + fy * by
        cross = bx * fy - by * fx
        curv = torch.atan2(cross, dot + 1e-12).abs()
        ok = (hit & take(hit, fwd) & take(hit, bwd)
              & (take(sid, fwd) == sid) & (take(sid, bwd) == sid)
              & (fwd > ar) & (bwd < ar))
        resp.append(torch.where(ok, curv, 0.0))
    best = torch.zeros_like(ranges)
    bsc = torch.zeros(ranges.shape, dtype=torch.int64)
    for k in range(n_s):
        v = resp[k]
        peak = ((v > torch.roll(v, 1, -1) + fp.peak_min_diff)
                & (v > torch.roll(v, -1, -1) + fp.peak_min_diff)
                & (v > fp.peak_min_value))
        pr = torch.where(peak, v, 0.0)
        if k == 0:
            best = pr
        else:
            up = pr > best
            best = torch.where(up, pr, best)
            bsc = torch.where(up, k, bsc)
    idx = torch.argsort(ranks_desc(best), -1)[..., :f]   # rank r -> beam
    k_sel = take(bsc, idx)
    tx = torch.zeros(idx.shape)
    ty = torch.zeros(idx.shape)
    for k in range(n_s):
        fwd, bwd = search(k)
        f_i, b_i = take(fwd, idx), take(bwd, idx)
        kx = take(smx[k], f_i) - take(smx[k], b_i)
        ky = take(smy[k], f_i) - take(smy[k], b_i)
        tx = torch.where(k_sel == k, kx, tx)
        ty = torch.where(k_sel == k, ky, ty)
    spx, spy = take(px, idx), take(py, idx)
    na = torch.atan2(tx, -ty)
    toward = torch.cos(na) * -spx + torch.sin(na) * -spy
    na = torch.where(toward < 0, na + math.pi, na)
    resp_sel = take(best, idx)
    scales = torch.tensor(sig)[k_sel]
    return tdet.FeatureSet(
        pts=torch.stack([spx, spy], -1),
        angles=torch.atan2(torch.sin(na), torch.cos(na)), scales=scales,
        response=resp_sel, mask=resp_sel > 0.0)


# -------------------------------------------------------------- descriptor

def _polar_bins(fp, rx, ry, ca, sa, rden):
    x = rx * ca - ry * sa
    y = rx * sa + ry * ca
    rho = torch.sqrt(x * x + y * y)
    phi = torch.atan2(y, x)
    ri = torch.floor((rho - fp.min_rho) / rden * fp.rho_bins).long()
    pi_ = torch.floor((phi + math.pi) * _recip(2 * math.pi)
                      * fp.phi_bins).long().clamp(0, fp.phi_bins - 1)
    ok = (ri >= 0) & (ri < fp.rho_bins)
    return ri.clamp(0, fp.rho_bins - 1) * fp.phi_bins + pi_, ok


def mirror_describe(fp, feats, ranges, hit):
    """features_describe_kernel over scans (N, B) and their (N, F)
    features: each thread's bins, then the tree."""
    nb = fp.rho_bins * fp.phi_bins
    b = fp.num_beams
    t_n = DESCRIBE_THREADS
    ang = tds.beam_angles(b, device="cpu")
    dx, dy = torch.cos(ang), torch.sin(ang)                   # (B,)
    fx, fy = feats.pts[..., 0:1], feats.pts[..., 1:2]         # (N, F, 1)
    fa = feats.angles[..., None]
    ca, sa = torch.cos(-fa), torch.sin(-fa)
    sup = (fp.max_rho * torch.sqrt(
        (feats.scales * _recip(fp.base_sigma)).clamp(min=1.0))).clamp(
            fp.max_rho, 4.0 * fp.max_rho)[..., None]
    rden = sup - fp.min_rho
    bin_w = (rden * _recip(fp.rho_bins)).clamp(min=1e-6)
    fm = feats.mask[..., None]
    r = ranges[..., None, :]                                  # (N, 1, B)
    hb, hok = _polar_bins(fp, r * dx - fx, r * dy - fy, ca, sa, rden)
    hok = hok & hit[..., None, :] & fm
    dp = fma32(dy, fy, dx * fx)
    disc = (dp * dp - (fx * fx + fy * fy)) + sup * sup
    root = torch.sqrt(disc.clamp(min=0.0))
    t0 = (dp - root).clamp(min=0.0)
    t1 = torch.minimum(dp + root, r * 0.999)
    chord = (t1 - t0).clamp(min=0.0)
    use = (disc > 0.0) & (chord > 1e-6) & fm
    w = (chord * 0.125) / bin_w
    mbins, mok = [], []
    for k in range(8):
        ts = t0 + chord * ((k + 0.5) * 0.125)
        mb, ok = _polar_bins(fp, ts * dx - fx, ts * dy - fy, ca, sa, rden)
        mbins.append(mb)
        mok.append(ok & use)
    lead = feats.mask.shape
    miss = torch.zeros(lead + (t_n, nb))
    hits = torch.zeros(lead + (t_n, nb), dtype=torch.int64)
    rows = torch.arange(t_n)
    for rnd in range(-(-b // t_n)):
        beam = rnd * t_n + rows
        live = beam < b
        beam = beam.clamp(max=b - 1)
        hits.scatter_add_(-1, take(hb, beam.expand(lead + (t_n,)))[..., None],
                          (take(hok, beam.expand(lead + (t_n,))) & live)
                          .long()[..., None])
        wb = take(w, beam.expand(lead + (t_n,)))
        for k in range(8):
            okb = take(mok[k], beam.expand(lead + (t_n,))) & live
            miss.scatter_add_(-1, take(mbins[k], beam.expand(
                lead + (t_n,)))[..., None],
                torch.where(okb, wb, 0.0)[..., None])
    stride = t_n // 2
    while stride:
        miss[..., :stride, :] = miss[..., :stride, :] \
            + miss[..., stride:2 * stride, :]
        hits[..., :stride, :] += hits[..., stride:2 * stride, :]
        stride //= 2
    h, m = hits[..., 0, :].float(), miss[..., 0, :]
    if fp.descriptor_stat == "beta_mean":
        return (h + 1.0) / ((h + m) + 2.0)
    hs = torch.zeros(lead)
    ms = torch.zeros(lead)
    for n in range(nb):
        hs = hs + h[..., n]
        ms = ms + m[..., n]
    return torch.cat([0.5 * (h / hs.clamp(min=1e-9)[..., None]),
                      0.5 * (m / ms.clamp(min=1e-9)[..., None])], -1)


DROPPED = 0xff              # csrc/features.cu kDropped


def describe_bytes(fp, feats, ranges, hit, threads):
    """The describe kernel's bin phases: each hit beam's bin (-1:
    outside the support or no hit; counted, in any order), each chord
    sample's bin as a byte (DROPPED: outside the support or no chord)
    and each beam's weight.  Items go to `threads` threads in turn (a
    beam a thread, then a (beam, sample) a thread); an item's bin does
    not depend on which thread takes it or when."""
    b = fp.num_beams
    ang = tds.beam_angles(b, device="cpu")
    dx, dy = torch.cos(ang), torch.sin(ang)
    fx, fy = feats.pts[..., 0:1], feats.pts[..., 1:2]
    fa = feats.angles[..., None]
    ca, sa = torch.cos(-fa), torch.sin(-fa)
    sup = (fp.max_rho * torch.sqrt(
        (feats.scales * _recip(fp.base_sigma)).clamp(min=1.0))).clamp(
            fp.max_rho, 4.0 * fp.max_rho)[..., None]
    rden = sup - fp.min_rho
    bin_w = (rden * _recip(fp.rho_bins)).clamp(min=1e-6)
    fm = feats.mask[..., None]
    lead = feats.mask.shape
    hit_bin = torch.full(lead + (b,), -1, dtype=torch.int64)
    t0 = torch.zeros(lead + (b,))
    length = torch.full(lead + (b,), -1.0)
    w = torch.zeros(lead + (b,))
    for base in range(0, b, threads):
        bm = slice(base, min(b, base + threads))
        r = ranges[..., None, bm]
        hb, hok = _polar_bins(fp, r * dx[bm] - fx, r * dy[bm] - fy, ca, sa,
                              rden)
        hok = hok & hit[..., None, bm] & fm
        hit_bin[..., bm] = torch.where(hok, hb, -1)
        dp = fma32(dy[bm], fy, dx[bm] * fx)
        disc = (dp * dp - (fx * fx + fy * fy)) + sup * sup
        root = torch.sqrt(disc.clamp(min=0.0))
        lo = (dp - root).clamp(min=0.0)
        chord = (torch.minimum(dp + root, r * 0.999) - lo).clamp(min=0.0)
        use = (disc > 0.0) & (chord > 1e-6) & fm
        t0[..., bm] = lo
        length[..., bm] = torch.where(use, chord, -1.0)
        w[..., bm] = torch.where(use, (chord * 0.125) / bin_w, 0.0)
    codes = torch.full(lead + (b * 8,), DROPPED, dtype=torch.int64)
    item = torch.arange(b * 8)
    for base in range(0, b * 8, threads):
        it = item[base:base + threads]
        bm, k = it // 8, (it % 8).float()
        ln = length[..., bm]
        ts = t0[..., bm] + ln * ((k + 0.5) * 0.125)
        n, ok = _polar_bins(fp, ts * dx[bm] - fx, ts * dy[bm] - fy, ca, sa,
                            rden)
        codes[..., base:base + threads] = torch.where(ok & (ln >= 0.0), n,
                                                      DROPPED)
    return hit_bin, codes.reshape(lead + (b, 8)), w


def mirror_describe_replay(fp, feats, ranges, hit, threads=1024):
    """features_describe_kernel as it is built: the bytes first
    (describe_bytes), then the replay of the 128 partial miss sums —
    sum t takes beams t, t + 128, ... and each beam's samples in order,
    holding a run of samples in one bin in a register — then the tree,
    a warp a bin: strides 64 and 32 in registers, 16 .. 1 as shuffles
    (the one-thread-a-beam tree's pairing)."""
    nb = fp.rho_bins * fp.phi_bins
    b, t_n = fp.num_beams, DESCRIBE_THREADS
    hit_bin, codes, w = describe_bytes(fp, feats, ranges, hit, threads)
    lead = feats.mask.shape
    hits = torch.zeros(lead + (nb + 1,), dtype=torch.int64)
    hits.scatter_add_(-1, torch.where(hit_bin >= 0, hit_bin, nb),
                      torch.ones_like(hit_bin))
    partial = torch.zeros(lead + (t_n, nb + 1))      # column nb: no bin
    cur = torch.full(lead + (t_n,), nb, dtype=torch.int64)
    acc = torch.zeros(lead + (t_n,))
    for rnd in range(-(-b // t_n)):
        beam = (rnd * t_n + torch.arange(t_n)).clamp(max=b - 1)
        live = rnd * t_n + torch.arange(t_n) < b
        wb = w[..., beam]
        for k in range(8):
            code = codes[..., beam, k]
            valid = (code != DROPPED) & live
            code = torch.where(valid, code, nb)
            change = valid & (code != cur)
            partial.scatter_(-1, cur[..., None], torch.where(
                change, acc, take(partial, cur[..., None])[..., 0])[..., None])
            acc = torch.where(change, take(partial, code[..., None])[..., 0],
                              acc)
            cur = torch.where(change, code, cur)
            acc = torch.where(valid, acc + wb, acc)
    partial.scatter_(-1, cur[..., None], acc[..., None])
    miss = partial[..., :nb]
    stride = t_n // 2
    while stride:
        miss[..., :stride, :] = miss[..., :stride, :] \
            + miss[..., stride:2 * stride, :]
        stride //= 2
    h, m = hits[..., :nb].float(), miss[..., 0, :]
    if fp.descriptor_stat == "beta_mean":
        return (h + 1.0) / ((h + m) + 2.0)
    hs = torch.zeros(lead)
    ms = torch.zeros(lead)
    for n in range(nb):
        hs = hs + h[..., n]
        ms = ms + m[..., n]
    return torch.cat([0.5 * (h / hs.clamp(min=1e-9)[..., None]),
                      0.5 * (m / ms.clamp(min=1e-9)[..., None])], -1)


# ----------------------------------------------------------------- matcher

def warp_sum(v):
    """The kernel's warp sum of (P, C) values: lane l adds c = l, l + 32,
    ... in order, then a butterfly over offsets 16 .. 1."""
    p, c = v.shape
    lanes = torch.zeros(p, 32)
    for k in range(0, c, 32):
        part = v[:, k:k + 32]
        lanes[:, :part.shape[1]] = lanes[:, :part.shape[1]] + part
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, lane ^ o]
    return lanes[:, 0]


def residual2(c, s, tx, ty, ax, ay, bx, by):
    px = (c * bx - s * by) + tx
    py = (s * bx + c * by) + ty
    dx, dy = ax - px, ay - py
    return dx * dx + dy * dy


def mirror_match(fp, ref, ref_desc, mov, mov_desc, u, cluster=4):
    """features_match_kernel over pairs (P, ...), its chi2 rows and
    first minima taken by a cluster of `cluster` blocks (None: one
    first-minimum scan over all rows)."""
    eps = 1e-9
    c_n, m_n, acc = (fp.max_correspondences, fp.ransac_hypotheses,
                     fp.ransac_acceptance)
    p_n, f2 = mov.mask.shape
    inf = torch.tensor(math.inf)

    def normalise(d):
        s = torch.zeros(d.shape[:-1])
        for k in range(d.shape[-1]):
            s = s + d[..., k]
        return d / s.clamp(min=eps)[..., None]

    an, bn = normalise(ref_desc), normalise(mov_desc)
    s = torch.zeros(p_n, an.shape[1], f2)
    for k in range(an.shape[-1]):
        pk, qk = an[:, :, None, k], bn[:, None, :, k]
        df = pk - qk
        s = s + (df * df) / ((pk + qk) + eps)
    good = ref.mask[:, :, None] & mov.mask[:, None, :]
    dist = torch.where(good, 0.5 * s, inf)
    if cluster is None:
        bref = first_min(dist.transpose(1, 2))                 # (P, F2)
        bd = take(dist.transpose(1, 2), bref[..., None])[..., 0]
    else:
        bd, bref = first_min_split(dist.transpose(1, 2), cluster)
    order = torch.argsort(ranks_desc(-bd), -1)[:, :min(c_n, f2)]
    pad = c_n - order.shape[1]
    cmov = torch.cat([order, torch.zeros(p_n, pad, dtype=torch.int64)], 1)
    cd = torch.cat([take(bd, order), torch.full((p_n, pad), math.inf)], 1)
    cref = take(bref, cmov)
    cm = cd < fp.ransac_dist_threshold
    ax, ay = take(ref.pts[..., 0], cref), take(ref.pts[..., 1], cref)
    bx, by = take(mov.pts[..., 0], cmov), take(mov.pts[..., 1], cmov)

    nvf = cm.sum(-1).float().clamp(min=1.0)[:, None]
    i0 = torch.floor(u[..., 0] * nvf).long().clamp(0, c_n - 1)
    i1 = torch.floor(u[..., 1] * nvf).long().clamp(0, c_n - 1)
    a0x, a0y, b0x, b0y = (take(t, i0) for t in (ax, ay, bx, by))
    dax, day = take(ax, i1) - a0x, take(ay, i1) - a0y
    dbx, dby = take(bx, i1) - b0x, take(by, i1) - b0y
    seg_len = norm2(dbx, dby)
    theta = torch.atan2(day, dax) - torch.atan2(dby, dbx)
    ch, sh = torch.cos(theta), torch.sin(theta)
    tx = a0x - (ch * b0x - sh * b0y)
    ty = a0y - (sh * b0x + ch * b0y)
    ld = seg_len - norm2(dax, day)
    ok = ((seg_len > 0.2) & (ld * ld < fp.ransac_rigidity * 4.0)
          & take(cm, i0) & take(cm, i1) & (i0 != i1))
    msac = torch.zeros(p_n, m_n)
    inl = torch.zeros(p_n, m_n, dtype=torch.int64)
    for c in range(c_n):
        r2 = residual2(ch, sh, tx, ty, ax[:, c:c + 1], ay[:, c:c + 1],
                       bx[:, c:c + 1], by[:, c:c + 1])
        cmc = cm[:, c:c + 1]
        msac = msac + torch.where(cmc, r2, acc).clamp(max=acc)
        inl = inl + ((r2 < acc) & cmc)
    budget = min(max(tr.hypothesis_budget(fp), 1), m_n)
    msac = torch.where(ok & (torch.arange(m_n) < budget), msac, inf)
    if fp.ransac_adaptive:
        p_succ, w0 = tr._success_and_ratio(fp)
        ratio = torch.where(ok, inl.float() / nvf, 0.0)
        run = torch.full((p_n,), w0, dtype=torch.float32)
        for m in range(m_n):
            w2 = (run * run).clamp(1e-9, 1.0 - 1e-6)
            bound = torch.tensor(math.log1p(-p_succ),
                                 dtype=torch.float32) / torch.log1p(-w2)
            msac[:, m] = torch.where(m < torch.ceil(bound), msac[:, m], inf)
            run = torch.maximum(run, ratio[:, m].clamp(min=w0))
    win = first_min(msac)[:, None]
    any_hyp = torch.isfinite(take(msac, win))[:, 0]
    T = [take(t, win)[:, 0] for t in (tx, ty, theta)]
    for _ in range(2):
        c0, s0 = torch.cos(T[2])[:, None], torch.sin(T[2])[:, None]
        r2 = residual2(c0, s0, T[0][:, None], T[1][:, None], ax, ay, bx, by)
        w = ((r2 < acc) & cm).float()
        sw = warp_sum(w)
        wsum = sw.clamp(min=1e-9)[:, None]
        cax, cay = warp_sum(ax * w)[:, None] / wsum, warp_sum(ay * w)[:, None] / wsum
        cbx, cby = warp_sum(bx * w)[:, None] / wsum, warp_sum(by * w)[:, None] / wsum
        a0x, a0y, b0x, b0y = ax - cax, ay - cay, bx - cbx, by - cby
        sxx = warp_sum(w * (b0x * a0x + b0y * a0y))
        sxy = warp_sum(w * (b0x * a0y - b0y * a0x))
        th = torch.atan2(sxy, sxx)
        c1, s1 = torch.cos(th)[:, None], torch.sin(th)[:, None]
        fit = [(cax - (c1 * cbx - s1 * cby))[:, 0],
               (cay - (s1 * cbx + c1 * cby))[:, 0], th]
        T = [torch.where(sw >= 2.0, a, b) for a, b in zip(fit, T)]
    T = [torch.where(any_hyp, t, 0.0) for t in T]
    c0, s0 = torch.cos(T[2])[:, None], torch.sin(T[2])[:, None]
    r2 = residual2(c0, s0, T[0][:, None], T[1][:, None], ax, ay, bx, by)
    inlier = (r2 < acc) & cm & any_hyp[:, None]
    n_in = inlier.sum(-1).to(torch.int32)
    score = warp_sum(torch.where(cm, r2.clamp(max=acc), acc))
    return tr.MatchResult(
        T=torch.stack(T, -1), score=score, num_inliers=n_in, corr_ref=cref,
        corr_mov=cmov, corr_mask=cm, inlier_mask=inlier,
        valid=any_hyp & (n_in >= 2))


def _compose(a, b):
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    t = a[..., 2] + b[..., 2]
    return torch.stack([a[..., 0] + b[..., 0] * ca - b[..., 1] * sa,
                        a[..., 1] + b[..., 0] * sa + b[..., 1] * ca,
                        torch.atan2(torch.sin(t), torch.cos(t))], -1)


def _transform(pose, pts):
    """Poses (P, 3) on points (P, C, 2): the rotation as torch's einsum
    contracts it, a product then a fused multiply-add."""
    c, s = torch.cos(pose[..., 2:3]), torch.sin(pose[..., 2:3])
    x, y = pts[..., 0], pts[..., 1]
    return torch.stack([fma32(-s, y, c * x) + pose[..., 0:1],
                        fma32(c, y, s * x) + pose[..., 1:2]], -1)


def mirror_gate(res, ref, mov, gate):
    """The match kernel's gate epilogue: (src means, tgt means, mask)."""
    sp = gate.sensor_pose.expand(res.T.shape)
    ca, sa = torch.cos(sp[..., 2]), torch.sin(sp[..., 2])
    inv = torch.stack([-(sp[..., 0] * ca + sp[..., 1] * sa),
                       -(-sp[..., 0] * sa + sp[..., 1] * ca), -sp[..., 2]],
                      -1)
    tf = _compose(_compose(sp, res.T), inv)
    o, p = tf, gate.motion.expand(res.T.shape)
    co, so = torch.cos(o[..., 2]), torch.sin(o[..., 2])
    dx, dy = p[..., 0] - o[..., 0], p[..., 1] - o[..., 1]
    t = p[..., 2] - o[..., 2]
    diff = torch.stack([dx * co + dy * so, -dx * so + dy * co,
                        torch.atan2(torch.sin(t), torch.cos(t))], -1)
    consistent = ((norm2(diff[..., 0], diff[..., 1]) <= gate.max_translation)
                  & (diff[..., 2].abs() <= gate.max_rotation)) | (
                      not gate.check)
    ok = res.valid & consistent
    wp = _compose(gate.prev_pose.expand(res.T.shape), sp)
    a = torch.gather(ref.pts, 1, res.corr_ref[..., None].expand(-1, -1, 2))
    b = torch.gather(mov.pts, 1, res.corr_mov[..., None].expand(-1, -1, 2))
    return (_transform(sp, b), _transform(wp, a),
            res.inlier_mask & ok[:, None])


# ------------------------------------------------------------------- tests

@pytest.mark.parametrize("t", SCANS)
def test_detect_mirror_matches_jax(t):
    jf, _ = _jax_feats(t)
    fx = _fixture()
    with jax.enable_x64(True):
        j64 = jdet.detect(FP, jnp.asarray(fx["ranges"][t], jnp.float64),
                          jnp.asarray(fx["hit"][t]))
        resp64 = np.asarray(j64.response)
        np.testing.assert_array_equal(np.asarray(j64.mask),
                                      np.asarray(jf.mask))
    r, h = _scans([t])
    got = mirror_detect(TFP, r, h)
    m = np.asarray(jf.mask)
    np.testing.assert_array_equal(got.mask[0].numpy(), m)
    assert m.sum() >= 5
    np.testing.assert_array_equal(got.scales[0].numpy(), np.asarray(jf.scales))
    np.testing.assert_allclose(got.pts[0].numpy()[m], np.asarray(jf.pts)[m],
                               rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(got.angles[0].numpy()[m],
                               np.asarray(jf.angles)[m], rtol=1e-5, atol=2e-5)
    resp = got.response[0].numpy()
    np.testing.assert_allclose(resp, resp64, rtol=1e-4, atol=1e-6)
    resp32 = np.asarray(jf.response)
    own = np.abs(resp32 - resp64)
    assert np.all(np.abs(resp - resp32) <= 1e-4 * np.abs(resp32) + 1e-6
                  + own)


def test_detect_mirror_batch_equals_rows():
    """One block a scan: a scan's bits do not depend on the batch."""
    r, h = _scans(SCANS)
    batch = mirror_detect(TFP, r, h)
    for i, t in enumerate(SCANS):
        one = mirror_detect(TFP, r[i:i + 1], h[i:i + 1])
        for k in dataclasses.fields(tdet.FeatureSet):
            assert torch.equal(getattr(one, k.name)[0],
                               getattr(batch, k.name)[i]), k.name


@pytest.mark.parametrize("stat", ["beta_mean", "hitmiss"])
def test_describe_mirror_matches_jax(stat):
    fp = dataclasses.replace(FP, descriptor_stat=stat)
    tfp = interop.params_from_jax(fp)
    fx = _fixture()
    sets, want = [], []
    for t in SCANS[:3]:
        r, h = jnp.asarray(fx["ranges"][t]), jnp.asarray(fx["hit"][t])
        jf = jdet.detect(fp, r, h)
        sets.append(_to_port(jf))
        want.append(np.asarray(jdesc.describe(fp, jf, r, h)))
    r, h = _scans(SCANS[:3])
    got = mirror_describe(tfp, _stack(sets), r, h)
    assert got.shape == (3, fp.max_features, tdesc.descriptor_dim(tfp))
    np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("threads", [128, 256, 512, 1024])
@pytest.mark.parametrize("stat", ["beta_mean", "hitmiss"])
def test_describe_replay_is_the_one_thread_a_beam_order(stat, threads):
    """The kernel's bytes-then-replay order, at every block size, gives
    the bits of mirror_describe (128 threads, each binning and adding
    its own beams) on the fixture's scans and their twin features."""
    fp = dataclasses.replace(TFP, descriptor_stat=stat)
    r, h = _scans(SCANS)
    feats = tdet._detect_plain(fp, r, h)
    want = mirror_describe(fp, feats, r, h)
    got = mirror_describe_replay(fp, feats, r, h, threads)
    assert torch.equal(got, want)
    assert torch.equal(got[1], mirror_describe_replay(
        fp, tdet.FeatureSet(**{k.name: getattr(feats, k.name)[1]
                               for k in dataclasses.fields(feats)}),
        r[1], h[1], threads))


def test_describe_threads_rule():
    """The most of 1,024, 512 and 256 threads a feature that keep the
    call within 1,024 threads of each of the H100's 132 SMs: one scan's
    32 features 1,024, a B = 8 fleet step's 256 512, 200 scans' 256."""
    got = [cuda_kernels.describe_threads(n, SMS)
           for n in (1, 32, 132, 133, 256, 264, 265, 2048, 6400)]
    assert got == [1024, 1024, 1024, 512, 512, 512, 256, 256, 256]


def _jax_pair(pair):
    (jref, jrd), (jmov, jmd) = _jax_feats(pair[0]), _jax_feats(pair[1])
    key = jax.random.PRNGKey(sum(pair))
    u = jax.random.uniform(jax.random.split(key)[0],
                           (FP.ransac_hypotheses, 2))
    return jref, jrd, jmov, jmd, key, u


def _port_pairs(pairs):
    ref, rd, mov, md, us = [], [], [], [], []
    for pair in pairs:
        jref, jrd, jmov, jmd, _, u = _jax_pair(pair)
        ref.append(_to_port(jref))
        mov.append(_to_port(jmov))
        rd.append(torch.tensor(np.asarray(jrd)))
        md.append(torch.tensor(np.asarray(jmd)))
        us.append(torch.tensor(np.asarray(u)))
    return (_stack(ref), torch.stack(rd), _stack(mov), torch.stack(md),
            torch.stack(us))


@pytest.mark.parametrize("adaptive", [False, True])
def test_match_mirror_matches_jax(adaptive):
    fp = dataclasses.replace(FP, ransac_adaptive=adaptive)
    tfp = interop.params_from_jax(fp)
    ref, rd, mov, md, u = _port_pairs(PAIRS)
    got = mirror_match(tfp, ref, rd, mov, md, u)
    for i, pair in enumerate(PAIRS):
        jref, jrd, jmov, jmd, key, _ = _jax_pair(pair)
        want = jr.match_sets(fp, jref, jrd, jmov, jmd, key)
        for name in ("corr_ref", "corr_mov", "corr_mask", "inlier_mask",
                     "num_inliers", "valid"):
            np.testing.assert_array_equal(getattr(got, name)[i].numpy(),
                                          np.asarray(getattr(want, name)),
                                          f"{pair} {name}")
        np.testing.assert_allclose(got.T[i].numpy(), np.asarray(want.T),
                                   atol=1e-5)
        np.testing.assert_allclose(float(got.score[i]), float(want.score),
                                   rtol=1e-5, atol=1e-6)
    assert bool(got.valid[0]) and int(got.num_inliers[0]) >= 5


def test_match_mirror_pads_fewer_features_than_correspondences():
    """F = 32 < C = 64: the padded correspondences are feature 0 at
    distance inf, never valid, as the plain twin pads them."""
    ref, rd, mov, md, u = _port_pairs(PAIRS[:2])
    got = mirror_match(TFP, ref, rd, mov, md, u)
    want = tr._match_sets_plain(TFP, ref, rd, mov, md, u)
    f = TFP.max_features
    assert torch.equal(got.corr_mov[:, f:], torch.zeros_like(
        got.corr_mov[:, f:]))
    assert not got.corr_mask[:, f:].any()
    for name in ("corr_ref", "corr_mov", "corr_mask", "inlier_mask"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def _gate(n):
    rng = np.random.default_rng(3)
    pose = lambda *s: torch.tensor(  # noqa: E731
        rng.uniform(-0.1, 0.1, s + (3,)).astype(F32))
    return pose, tr.OdometryGate(
        sensor_pose=pose(), motion=pose(n), prev_pose=pose(n),
        max_translation=FuserParams().max_translation_norm / 10.0,
        max_rotation=FuserParams().max_rotation_norm / 4.0, check=True,
        cov_xy=FuserParams().feature_cov_xy)


def test_gate_mirror_matches_jax_prepare_features():
    """The match kernel's epilogue against the reference's
    feature_fuser._prepare_features on the same sets, draws and poses:
    the same pair masks, the pseudo-cells within 1e-5."""
    fx = _fixture()
    params = FuserParams(features=FP)
    n = len(PAIRS)
    pose, _ = _gate(n)
    sp = pose()
    got_src, got_tgt, got_mask, want = [], [], [], []
    for i, (a, b) in enumerate(PAIRS):
        jref, jrd, jmov, jmd, key, u = _jax_pair((a, b))
        motion, prev = pose(), pose()
        state = types.SimpleNamespace(
            base=types.SimpleNamespace(sensor_pose=jnp.asarray(sp.numpy())),
            prev_feats=jref, prev_desc=jrd, prev_pose=jnp.asarray(
                prev.numpy()), key=key)
        out = jff._prepare_features(state, params, jnp.asarray(
            motion.numpy()), jnp.asarray(fx["ranges"][b]),
            jnp.asarray(fx["hit"][b]))
        want.append(out)
        res = mirror_match(TFP, *[
            x[None] if torch.is_tensor(x) else tdet.FeatureSet(
                **{k.name: getattr(x, k.name)[None]
                   for k in dataclasses.fields(tdet.FeatureSet)})
            for x in (_to_port(jref), torch.tensor(np.asarray(jrd)),
                      _to_port(jmov), torch.tensor(np.asarray(jmd)),
                      torch.tensor(np.asarray(u)))])
        gate = tr.OdometryGate(
            sensor_pose=sp, motion=motion[None], prev_pose=prev[None],
            max_translation=params.max_translation_norm / 10.0,
            max_rotation=params.max_rotation_norm / 4.0,
            check=params.check_consistency, cov_xy=params.feature_cov_xy)
        src, tgt, mask = mirror_gate(
            res, tdet.FeatureSet(**{k.name: getattr(_to_port(jref), k.name)[None]
                                    for k in dataclasses.fields(
                                        tdet.FeatureSet)}),
            tdet.FeatureSet(**{k.name: getattr(_to_port(jmov), k.name)[None]
                               for k in dataclasses.fields(tdet.FeatureSet)}),
            gate)
        got_src.append(src[0])
        got_tgt.append(tgt[0])
        got_mask.append(mask[0])
    kept = 0
    for i, out in enumerate(want):
        feat_src, feat_tgt = out[5], out[6]
        np.testing.assert_array_equal(got_mask[i].numpy(),
                                      np.asarray(feat_src.mask))
        np.testing.assert_allclose(got_src[i].numpy(),
                                   np.asarray(feat_src.means), atol=1e-5)
        np.testing.assert_allclose(got_tgt[i].numpy(),
                                   np.asarray(feat_tgt.means), atol=1e-5)
        kept += int(got_mask[i].sum())
    assert kept > 0


def _dispatch_inputs():
    r, h = _scans(SCANS[:2])
    feats = tdet._detect_plain(TFP, r, h)
    desc = tdesc._describe_plain(TFP, feats, r, h)
    u = torch.tensor(_fixture()["ransac_u"][:1])
    one = lambda s, i: tdet.FeatureSet(**{  # noqa: E731
        k.name: getattr(s, k.name)[i:i + 1]
        for k in dataclasses.fields(tdet.FeatureSet)})
    return r, h, feats, desc, one(feats, 0), desc[:1], one(feats, 1), \
        desc[1:], u


def test_cpu_dispatch_runs_the_plain_twins():
    """On CPU tensors the public entries are the plain twins, bit for
    bit, and no kernel launches."""
    cuda_kernels.reset_launch_counts()
    r, h, feats, desc, ref, rd, mov, md, u = _dispatch_inputs()
    got = tdet.detect(TFP, r, h)
    for k in dataclasses.fields(tdet.FeatureSet):
        assert torch.equal(getattr(got, k.name), getattr(feats, k.name))
    assert torch.equal(tdesc.describe(TFP, feats, r, h), desc)
    res = tr.match_sets(TFP, ref, rd, mov, md, u)
    want = tr._match_sets_plain(TFP, ref, rd, mov, md, u)
    for k in dataclasses.fields(tr.MatchResult):
        assert torch.equal(getattr(res, k.name), getattr(want, k.name))
    _, gate = _gate(1)
    res2, src, tgt = tr.match_sets_gated(TFP, ref, rd, mov, md, u, gate)
    w_src, w_tgt = tr._gate_plain(want, ref, mov, gate)
    for a, b in ((src, w_src), (tgt, w_tgt)):
        for k in ("means", "covs", "mask"):
            assert torch.equal(getattr(a, k), getattr(b, k))
    assert all(v == 0 for v in cuda_kernels.LAUNCHES.values())


def test_gate_twin_matches_mirror():
    """The plain gate (se2 operations) and the epilogue's mirror agree on
    the same result: the masks exactly, the points within 1e-6."""
    _, _, _, _, ref, rd, mov, md, u = _dispatch_inputs()
    res = tr._match_sets_plain(TFP, ref, rd, mov, md, u)
    _, gate = _gate(1)
    src, tgt = tr._gate_plain(res, ref, mov, gate)
    m_src, m_tgt, m_mask = mirror_gate(res, ref, mov, gate)
    assert torch.equal(src.mask, m_mask)
    torch.testing.assert_close(src.means, m_src, rtol=0, atol=1e-6)
    torch.testing.assert_close(tgt.means, m_tgt, rtol=0, atol=1e-6)
    assert torch.equal(src.covs[0, 0], torch.tensor(
        [[2e-4, 0.0], [0.0, 2e-4]]))


def test_rank_count_is_a_stable_descending_order():
    """The kernels' top-K: ranks give torch's stable descending sort,
    zeros in index order after every positive value."""
    rng = np.random.default_rng(1)
    v = torch.tensor(np.where(rng.random((6, 720)) < 0.9, 0.0,
                              rng.choice([0.4, 0.7, 1.3], (6, 720))),
                     dtype=torch.float32)
    order = torch.argsort(ranks_desc(v), -1)
    want = torch.sort(v, descending=True, stable=True).indices
    assert torch.equal(order, want)


def test_left_search_on_ties():
    """A left binary search (the kernel's lower bound) on a cumulative
    arc with repeated values (missing returns add no arc), as
    torch.searchsorted and jnp.searchsorted."""
    arc = np.cumsum(np.array([0, 0.1, 0, 0, 0.2, 0.2, 0, 0.3], F32))
    vals = np.concatenate([arc, arc + F32(0.1), arc - F32(0.1)])
    want = np.asarray(jnp.searchsorted(jnp.asarray(arc), jnp.asarray(vals)))

    def lower_bound(v):
        lo, hi = 0, len(arc)
        while lo < hi:
            mid = (lo + hi) // 2
            if not arc[mid] >= v:
                lo = mid + 1
            else:
                hi = mid
        return lo

    got = np.array([lower_bound(v) for v in vals])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        torch.searchsorted(torch.tensor(arc), torch.tensor(vals)).numpy(),
        want)


# ------------------------------------------- the cluster splits, all scans

@functools.lru_cache(maxsize=None)
def _all_scans():
    fx = _fixture()
    r, h = torch.tensor(fx["ranges"]), torch.tensor(fx["hit"])
    return (r, h, *scan_geometry(TFP, r, h))


@functools.lru_cache(maxsize=None)
def _twin_order_smoothing():
    """The 200 canonical scans' arc (the kernel's) and smoothed points
    (S, N, B, 2) summed in the plain twin's order: each scale's (B, W)
    weights (the kernel's) summed over the window by torch.sum and the
    twin's einsum, in float64."""
    _, h, px, py, seg, sid = _all_scans()
    cum = arc_runs(seg)
    b, half = TFP.num_beams, TFP.smooth_half_beams
    nidx = (torch.arange(b)[:, None] + torch.arange(-half, half + 1)[None]
            ).clamp(0, b - 1)
    out = []
    for i in range(0, h.shape[0], 50):
        sl = slice(i, i + 50)
        darc = (cum[sl][:, nidx] - cum[sl][..., None]).abs()
        same = (sid[sl][:, nidx] == sid[sl][..., None]) & h[sl][:, nidx]
        pts = torch.stack([px[sl], py[sl]], -1)[:, nidx].double()
        sms = []
        for k in range(TFP.num_scales):
            sig = float(F32(TFP.base_sigma * TFP.sigma_step ** k))
            q = darc * _recip(sig)
            w = torch.where(same, torch.exp(q * q * -0.5), 0.0).double()
            wsum = w.sum(-1, keepdim=True).clamp(min=1e-9)
            sms.append((torch.einsum("...bw,...bwc->...bc", w, pts)
                        / wsum).float())
        out.append(torch.stack(sms))
    return cum, torch.cat(out, 1)


def test_detect_arc_runs_equal_a_float64_cumsum_over_all_scans():
    """The kernel's arc order (runs of three beams, the block's scan) and
    a float64 cumsum in beam order give the same float32 arc, bit for
    bit, on all 200 scans (the segment lengths rounded as the card's;
    the CPU twin's own vector_norm fuses a product, so the card run
    holds the kernel's arc to the twin's)."""
    _, _, _, _, seg, _ = _all_scans()
    assert torch.equal(arc_runs(seg), torch.cumsum(seg.double(), -1).float())


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_detect_split_window_sums_equal_the_twin_order_over_all_scans(
        cluster):
    """Block by block of a cluster of `cluster` (each block's beams, each
    window in offset order), the smoothed points of all 200 scans equal
    bit for bit those of the same weights summed in the plain twin's
    order (torch.sum and einsum in float64: the claim that these float64
    sums round to float32 alike in any order), and the offset-order sums
    over all beams at once."""
    _, h, px, py, _, sid = _all_scans()
    cum, sm_t = _twin_order_smoothing()
    got = split_smoothing(TFP, px, py, cum, sid, h, cluster)
    assert torch.equal(got, sm_t)
    if cluster == 1:
        return
    assert torch.equal(got, split_smoothing(TFP, px, py, cum, sid, h, 1))


def test_cluster_choices():
    """The wrappers' cluster sizes on the H100's 132 SMs: the most blocks
    that fill the SMs once, up to 8 a scan (one scan over 8 blocks, 200
    scans one block each) and 4 a pair (one pair over 4 blocks, 199
    pairs and the LC bank's 171 one)."""
    got = [cuda_kernels.detect_cluster(n, SMS)
           for n in (1, 16, 17, 32, 33, 34, 64, 66, 67, 132, 200)]
    assert got == [8, 8, 4, 4, 4, 2, 2, 2, 1, 1, 1]
    got = [cuda_kernels.match_cluster(n, SMS)
           for n in (1, 33, 34, 66, 67, 171, 199)]
    assert got == [4, 4, 2, 2, 1, 1, 1]


def test_first_min_split_is_a_first_minimum_scan():
    """Rows split over 1, 2 and 4 blocks, 32 lanes and a butterfly give a
    first-minimum scan's row and value, on ties and inf columns (131
    rows: lanes with several rows, a short last block)."""
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.choice([0.25, 0.5, 1.0, np.inf], (40, 7, 131),
                                p=[0.05, 0.1, 0.35, 0.5]), dtype=torch.float32)
    x[3] = math.inf
    want_i = first_min(x)
    for cluster in (1, 2, 4):
        v, i = first_min_split(x, cluster)
        assert torch.equal(i, want_i), cluster
        assert torch.equal(v, take(x, want_i[..., None])[..., 0])


@functools.lru_cache(maxsize=None)
def _canonical_pairs():
    """The fixture's 199 consecutive pairs on the plain twins' features
    and descriptors, with the fixture's draws."""
    r, h = _all_scans()[:2]
    n = r.shape[0]
    ft = tdet._detect_plain(TFP, r, h)
    rows = lambda sl: tdet.FeatureSet(**{  # noqa: E731
        k.name: getattr(ft, k.name)[sl]
        for k in dataclasses.fields(tdet.FeatureSet)})
    desc = torch.cat([tdesc._describe_plain(TFP, rows(slice(i, i + 10)),
                                            r[i:i + 10], h[i:i + 10])
                      for i in range(0, n, 10)])
    return (rows(slice(0, n - 1)), desc[:-1], rows(slice(1, n)), desc[1:],
            torch.tensor(_fixture()["ransac_u"]))


@functools.lru_cache(maxsize=None)
def _one_block_match():
    """The order of one block a pair: one first-minimum scan over the
    rows."""
    return mirror_match(TFP, *_canonical_pairs(), cluster=None)


@pytest.mark.parametrize("cluster", [1, 2, 4])
def test_match_split_keeps_every_choice_over_all_pairs(cluster):
    """The first minimum over a cluster's blocks keeps every
    correspondence, inlier, count and validity of the one-block order on
    the fixture's 199 pairs, and the poses' and scores' bits."""
    want = _one_block_match()
    got = mirror_match(TFP, *_canonical_pairs(), cluster=cluster)
    for k in ("corr_ref", "corr_mov", "corr_mask", "inlier_mask",
              "num_inliers", "valid", "score", "T"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert int(want.valid.sum()) > 150
