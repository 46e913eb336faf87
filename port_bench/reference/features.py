"""The FLIRT front end: a frozen copy of the port's plain detector,
beta-grid descriptor, chi2 distance, RANSAC and odometry gate, and the
scan projection."""

from __future__ import annotations

import dataclasses
import math

import torch

from port_bench.reference import se2
from port_bench.reference.config import FeatureParams
from port_bench.reference.ndt_map import CellList
from port_bench.reference.ndt_map import take_rows

_ANGLES = {}       # (num_beams, fov, device) -> (B,) float32 beam angles
_DIRECTIONS = {}   # (num_beams, fov, device) -> the beams' (cos, sin)


def beam_angles(num_beams: int, fov: float = 2.0 * math.pi,
                device=None):
    """Beam angles of a `num_beams` scan over `fov`: the reference's
    `jnp.linspace(-fov/2, fov/2, num_beams, endpoint=False)` in float32.

    XLA evaluates that linspace as start*(1 - i*r) + i*(stop*r), r =
    f32(1/num), contracted into fused multiply-adds.  The FMAs are
    reproduced here in float64 (an f32 x f32 product is exact there,
    so each is rounded once, to double, then to float32).  XLA's own
    result is not fixed bit for bit: its vectorised body and scalar tail
    round differently, so the eager and the jitted linspace disagree in
    a few entries (5 of 720); this helper matches either to one ulp.
    Cached per device."""
    key = (num_beams, float(fov), torch.device(device))
    out = _ANGLES.get(key)
    if out is None:
        f32, f64 = torch.float32, torch.float64
        start = torch.tensor(-fov / 2, dtype=f32).to(f64)
        rec = torch.tensor(1.0, dtype=f32) / torch.tensor(
            float(num_beams), dtype=f32)
        c2 = (torch.tensor(fov / 2, dtype=f32) * rec).to(f64)
        i = torch.arange(num_beams, dtype=f32).to(f64)
        one_minus = (1.0 - i * rec.to(f64)).to(f32).to(f64)
        first = (start * one_minus).to(f32).to(f64)
        out = (first + i * c2).to(f32).to(key[2])
        _ANGLES[key] = out
    return out


def beam_directions(num_beams: int, fov: float = 2.0 * math.pi,
                    device=None):
    """(cos, sin) of `beam_angles` in float32 as the CPU computes them,
    on `device`: every device takes the CPU's bits (the card's own
    float32 cos / sin round otherwise, by an ulp).  Cached per device as
    the angles are."""
    key = (num_beams, float(fov), torch.device(device))
    out = _DIRECTIONS.get(key)
    if out is None:
        ang = beam_angles(num_beams, fov, "cpu")
        out = tuple(x.to(key[2]) for x in (torch.cos(ang), torch.sin(ang)))
        _DIRECTIONS[key] = out
    return out


def scan_to_points(ranges, hit, fov=2.0 * math.pi):
    """Polar scan -> (B, 2) points in the sensor frame + mask: each
    range times its beam's direction (`beam_directions`, the CPU's
    float32 cos / sin), one float32 product a coordinate, so the card's
    points are the CPU's bit for bit."""
    cos, sin = beam_directions(ranges.shape[-1], fov, ranges.device)
    pts = torch.stack([ranges * cos, ranges * sin], -1)
    return pts, hit



def symmetric_chi2_matrix(a, b, eps=1e-9):
    """Pairwise symmetric chi-square distance between sum-normalized
    histogram rows: a (..., F1, D), b (..., F2, D) -> (..., F1, F2),
    d(p, q) = 0.5 * sum_i (p_i - q_i)^2 / (p_i + q_i), in [0, 1]."""
    an = a / torch.clamp(a.sum(-1, keepdim=True), min=eps)
    bn = b / torch.clamp(b.sum(-1, keepdim=True), min=eps)
    diff = an[..., :, None, :] - bn[..., None, :, :]
    s = an[..., :, None, :] + bn[..., None, :, :]
    return 0.5 * (diff * diff / (s + eps)).sum(-1)



@dataclasses.dataclass
class FeatureSet:
    """Padded interest points in the SENSOR frame (leading dims: a
    batch of scans)."""

    pts: torch.Tensor        # (..., F, 2)
    angles: torch.Tensor     # (..., F) orientation
    scales: torch.Tensor     # (..., F) detection scale (sigma)
    response: torch.Tensor   # (..., F) detector response
    mask: torch.Tensor       # (..., F) bool

    def transform(self, pose):
        return dataclasses.replace(
            self, pts=se2.transform_points(pose, self.pts),
            angles=self.angles + pose[..., 2],
        )


def top_k_stable(x, k: int):
    """(values, indices) of the k largest entries along the last dim,
    lower index first among ties — the order of `jax.lax.top_k`."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _smoothing_plain(params: FeatureParams, ranges, hit):
    """The plain twin's points (..., B, 2), cumulative arc (..., B),
    polyline pieces (..., B) and smoothed points at each scale, a list
    of (..., B, 2)."""
    b = params.num_beams
    dev = ranges.device
    angles = beam_angles(b, device=dev)
    pts = torch.stack(
        [ranges * torch.cos(angles), ranges * torch.sin(angles)], -1
    )
    ar = torch.arange(b, device=dev)

    seg = torch.linalg.vector_norm(pts - torch.roll(pts, 1, -2), dim=-1)
    seg = torch.cat([torch.zeros_like(seg[..., :1]), seg[..., 1:]], -1)
    cumarc = torch.cumsum(seg.double(), -1).float()

    jump = torch.abs(ranges - torch.roll(ranges, 1, -1)) > 0.5
    jump = torch.cat([torch.zeros_like(jump[..., :1]), jump[..., 1:]], -1)
    jump = jump | ~hit | ~torch.roll(hit, 1, -1)
    seg_id = torch.cumsum(jump.to(torch.int32), -1)

    half = int(params.smooth_half_beams)
    offs = torch.arange(-half, half + 1, device=dev)
    nidx = (ar[:, None] + offs[None, :]).clamp(0, b - 1)
    darc = torch.abs(cumarc[..., nidx] - cumarc[..., None])   # (..., B, W)
    same_piece = (seg_id[..., nidx] == seg_id[..., None]) & hit[..., nidx]
    pts_n = pts[..., nidx, :].double()                        # (..., B, W, 2)

    sms = []
    for i in range(params.num_scales):
        sigma = params.base_sigma * params.sigma_step**i
        w = (torch.exp(-0.5 * (darc / sigma) ** 2) * same_piece).double()
        wsum = torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        sms.append(
            (torch.einsum("...bw,...bwc->...bc", w, pts_n) / wsum).float())
    return pts, cumarc, seg_id, sms


def _detect_plain(params: FeatureParams, ranges, hit) -> FeatureSet:
    """The plain twin of `detect`: eager operations over (..., S, B, W)
    tensors."""
    b = params.num_beams
    ar = torch.arange(b, device=ranges.device)
    pts, cumarc, seg_id, sms = _smoothing_plain(params, ranges, hit)

    responses, tangents, sigmas = [], [], []
    for i, sm in enumerate(sms):
        sigma = params.base_sigma * params.sigma_step**i
        fwd = torch.searchsorted(cumarc, cumarc + sigma).clamp(0, b - 1)
        bwd = torch.searchsorted(cumarc, cumarc - sigma).clamp(0, b - 1)
        sm_f, sm_b = take_rows(sm, fwd), take_rows(sm, bwd)
        f = sm_f - sm
        bk = sm - sm_b
        dot = f[..., 0] * bk[..., 0] + f[..., 1] * bk[..., 1]
        cross = bk[..., 0] * f[..., 1] - bk[..., 1] * f[..., 0]
        curv = torch.abs(torch.atan2(cross, dot + 1e-12))

        ok = (
            hit & take_rows(hit, fwd) & take_rows(hit, bwd)
            & (take_rows(seg_id, fwd) == seg_id)
            & (take_rows(seg_id, bwd) == seg_id)
            & (fwd > ar) & (bwd < ar)
        )
        responses.append(torch.where(ok, curv, 0.0))
        tangents.append(sm_f - sm_b)
        sigmas.append(sigma)

    resp = torch.stack(responses, -2)              # (..., S, B)
    tang = torch.stack(tangents, -3)               # (..., S, B, 2)

    left = torch.roll(resp, 1, -1)
    right = torch.roll(resp, -1, -1)
    is_peak = (
        (resp > left + params.peak_min_diff)
        & (resp > right + params.peak_min_diff)
        & (resp > params.peak_min_value)
    )
    peak_resp = torch.where(is_peak, resp, 0.0)

    best_scale = torch.argmax(peak_resp, -2)     # first max, as jnp
    best_resp = peak_resp.amax(-2)

    top_resp, top_idx = top_k_stable(best_resp, params.max_features)
    valid = top_resp > 0.0

    sel_scale_idx = take_rows(best_scale, top_idx)
    # Scale sigmas selected with where(), not a host->device table copy.
    sel_scale = torch.zeros_like(top_resp)
    for i, sigma in enumerate(sigmas):
        sel_scale = torch.where(sel_scale_idx == i, sigma, sel_scale)
    sel_pts = take_rows(pts, top_idx)
    sel_tang = take_rows(tang.flatten(-3, -2),
                         sel_scale_idx * b + top_idx)          # (..., F, 2)
    na = torch.atan2(sel_tang[..., 0], -sel_tang[..., 1])
    nvec = torch.stack([torch.cos(na), torch.sin(na)], -1)
    flip = (nvec * -sel_pts).sum(-1) < 0
    na = torch.where(flip, na + math.pi, na)

    return FeatureSet(
        pts=sel_pts,
        angles=torch.atan2(torch.sin(na), torch.cos(na)),
        scales=sel_scale,
        response=top_resp,
        mask=valid,
    )



def _describe_plain(params: FeatureParams, feats: FeatureSet, ranges, hit):
    """The plain twin of `describe`: the polar bins of every hit and
    chord sample, summed through (..., F, B, 8, bins) one-hot tensors."""
    r_bins, p_bins = params.rho_bins, params.phi_bins
    nbins = r_bins * p_bins
    dev = ranges.device

    ang = beam_angles(params.num_beams, device=dev)
    d_hat = torch.stack([torch.cos(ang), torch.sin(ang)], -1)       # (B, 2)
    endpoints = torch.stack(
        [ranges * torch.cos(ang), ranges * torch.sin(ang)], -1
    )

    support = params.max_rho * torch.clamp(
        feats.scales / params.base_sigma, min=1.0
    ) ** 0.5
    support = support.clamp(params.max_rho, 4.0 * params.max_rho)  # (.., F)

    def polar_bins(rel_pts, feat_angle, sup):
        """rel_pts (..., 2) relative to feature -> (bin_idx, in_support)."""
        ca, sa = torch.cos(-feat_angle), torch.sin(-feat_angle)
        x = rel_pts[..., 0] * ca - rel_pts[..., 1] * sa
        y = rel_pts[..., 0] * sa + rel_pts[..., 1] * ca
        rho = torch.sqrt(x * x + y * y)
        phi = torch.atan2(y, x)
        rlo = params.min_rho
        ri = torch.floor((rho - rlo) / (sup - rlo) * r_bins).to(torch.int64)
        pi_ = torch.floor(
            (phi + math.pi) / (2 * math.pi) * p_bins
        ).to(torch.int64).clamp(0, p_bins - 1)
        ok = (ri >= 0) & (ri < r_bins)
        return ri.clamp(0, r_bins - 1) * p_bins + pi_, ok

    # Hits: endpoints of hitting beams.
    rel = endpoints[..., None, :, :] - feats.pts[..., :, None, :]  # (.,F,B,2)
    hbin, hok = polar_bins(rel, feats.angles[..., None], support[..., None])
    hok = hok & hit[..., None, :] & feats.mask[..., None]

    # Misses: samples along each beam's chord through the support circle.
    dp = torch.einsum("bc,...fc->...fb", d_hat, feats.pts)        # (., F, B)
    p2 = (feats.pts ** 2).sum(-1)
    disc = dp * dp - p2[..., None] + support[..., None] ** 2
    has_chord = disc > 0.0
    root = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = torch.clamp(dp - root, min=0.0)
    t1 = torch.minimum(dp + root, ranges[..., None, :] * 0.999)
    chord = torch.clamp(t1 - t0, min=0.0)
    s_steps = 8
    sfrac = (torch.arange(s_steps, dtype=torch.float32, device=dev)
             + 0.5) / s_steps
    t_s = t0[..., None] + chord[..., None] * sfrac              # (., F, B, K)
    sample_pts = t_s[..., None] * d_hat[:, None, :]
    mrel = sample_pts - feats.pts[..., :, None, None, :]
    mbin, mok = polar_bins(
        mrel, feats.angles[..., None, None], support[..., None, None]
    )
    mok = mok & has_chord[..., None] & (chord[..., None] > 1e-6) \
        & feats.mask[..., None, None]
    bin_w = torch.clamp((support - params.min_rho) / r_bins, min=1e-6)
    mw = torch.where(mok, chord[..., None] / s_steps
                     / bin_w[..., None, None], 0.0)

    bins_iota = torch.arange(nbins, device=dev)
    h_onehot = (hbin[..., None] == bins_iota).to(torch.float32)
    hits = torch.einsum("...fb,...fbn->...fn", hok.to(torch.float32),
                        h_onehot)
    m_onehot = (mbin[..., None] == bins_iota).to(torch.float32)
    misses = torch.einsum("...fbk,...fbkn->...fn", mw, m_onehot)
    if params.descriptor_stat == "hitmiss":
        hn = hits / torch.clamp(hits.sum(-1, keepdim=True), min=1e-9)
        mn = misses / torch.clamp(misses.sum(-1, keepdim=True), min=1e-9)
        return torch.cat([0.5 * hn, 0.5 * mn], -1)
    return (hits + 1.0) / (hits + misses + 2.0)


@dataclasses.dataclass
class MatchResult:
    T: torch.Tensor            # (3,) mov -> ref SE(2) transform
    score: torch.Tensor        # MSAC score (lower better)
    num_inliers: torch.Tensor  # int32
    corr_ref: torch.Tensor     # (C,) candidate ref indices
    corr_mov: torch.Tensor     # (C,) candidate mov indices
    corr_mask: torch.Tensor    # (C,) candidate validity
    inlier_mask: torch.Tensor  # (C,) inliers under final T
    valid: torch.Tensor        # bool — enough inliers for a pose


def _procrustes(a, b, w):
    """Weighted 2D rigid fit argmin_T sum w |a - T(b)|^2; a, b (..., C, 2),
    w (..., C).  Returns (..., 3)."""
    wsum = torch.clamp(w.sum(-1), min=1e-9)[..., None]
    ca = (a * w[..., None]).sum(-2) / wsum
    cb = (b * w[..., None]).sum(-2) / wsum
    a0 = a - ca[..., None, :]
    b0 = b - cb[..., None, :]
    sxx = (w * (b0[..., 0] * a0[..., 0] + b0[..., 1] * a0[..., 1])).sum(-1)
    sxy = (w * (b0[..., 0] * a0[..., 1] - b0[..., 1] * a0[..., 0])).sum(-1)
    theta = torch.atan2(sxy, sxx)
    c, s = torch.cos(theta), torch.sin(theta)
    tx = ca[..., 0] - (c * cb[..., 0] - s * cb[..., 1])
    ty = ca[..., 1] - (s * cb[..., 0] + c * cb[..., 1])
    return torch.stack([tx, ty, theta], -1)


def _apply(T, pts):
    """Poses T (..., 3) applied to points (..., 2)."""
    c, s = torch.cos(T[..., 2]), torch.sin(T[..., 2])
    x = c * pts[..., 0] - s * pts[..., 1] + T[..., 0]
    y = s * pts[..., 0] + c * pts[..., 1] + T[..., 1]
    return torch.stack([x, y], -1)


def _success_and_ratio(params: FeatureParams):
    """(p, w): the success probability and inlier ratio, clipped."""
    return (min(max(params.ransac_success_prob, 1e-6), 1.0 - 1e-9),
            min(max(params.ransac_inlier_ratio, 1e-6), 1.0 - 1e-9))


def hypothesis_budget(params: FeatureParams) -> int:
    """N = log(1-p) / log(1-w^2), the RANSAC stopping bound."""
    p_succ, w0 = _success_and_ratio(params)
    return int(math.ceil(math.log1p(-p_succ) / math.log1p(-w0 * w0)))


def adaptive_considered(params: FeatureParams, r2_raw, corr_mask, hyp_ok):
    """The adaptive variant's mask of hypotheses (..., M): hypothesis i
    counts only while i < N(best inlier ratio seen before i), a running
    max over the hypotheses since N(w) does not increase with w.  The
    bound is float32, as the reference's."""
    p_succ, w0 = _success_and_ratio(params)
    acc = params.ransac_acceptance
    n_cand = torch.clamp(corr_mask.sum(-1), min=1).to(torch.float32)
    inl_cnt = ((r2_raw < acc) & corr_mask[..., None, :]).sum(-1)
    ratio = torch.where(hyp_ok, inl_cnt / n_cand[..., None], 0.0)
    run = torch.cummax(torch.clamp(ratio, min=w0), -1).values
    run_prev = torch.cat([torch.full_like(run[..., :1], w0),
                          run[..., :-1]], -1)
    w2 = torch.clamp(run_prev * run_prev, 1e-9, 1.0 - 1e-6)
    bound = torch.tensor(math.log1p(-p_succ), dtype=torch.float32,
                         device=w2.device) / torch.log1p(-w2)
    m_hyp = r2_raw.shape[-2]
    return torch.arange(m_hyp, device=w2.device) < torch.ceil(bound)


@dataclasses.dataclass
class OdometryGate:
    """The feature fuser's check of a RANSAC pose against odometry and
    its pseudo-cells (fusion/feature_fuser.py): poses (..., 3) over the
    pair batch (or shared by it)."""

    sensor_pose: torch.Tensor   # laser in the vehicle frame
    motion: torch.Tensor        # the odometry motion, Tmotion
    prev_pose: torch.Tensor     # the previous scan's Tnow
    max_translation: float      # FuserParams.max_translation_norm / 10
    max_rotation: float         # FuserParams.max_rotation_norm / 4
    check: bool                 # FuserParams.check_consistency
    cov_xy: float               # the pseudo-cells' covariance, cov_xy * I


def _gate_plain(res: MatchResult, ref: FeatureSet, mov: FeatureSet,
                gate: OdometryGate):
    """The plain twin of match_sets_gated's gate: (src, tgt)."""
    sp = gate.sensor_pose
    T_feat_vehicle = se2.compose(se2.compose(sp, res.T), se2.inverse(sp))
    diff = se2.sub(T_feat_vehicle, gate.motion)
    consistent = (
        (torch.linalg.vector_norm(diff[..., :2], dim=-1)
         <= gate.max_translation)
        & (torch.abs(diff[..., 2]) <= gate.max_rotation)
    ) | (not gate.check)
    feats_ok = res.valid & consistent

    world_prev = se2.compose(gate.prev_pose, sp)
    tgt_pts = se2.transform_points(world_prev, take_rows(ref.pts, res.corr_ref))
    src_pts = se2.transform_points(sp, take_rows(mov.pts, res.corr_mov))
    # Materialised once per scan: the objective kernel reads the lists
    # of every Newton trial through plain pointers.
    covs = (torch.eye(2, dtype=torch.float32, device=res.T.device)
            * gate.cov_xy).expand(*res.corr_ref.shape, 2, 2).contiguous()
    pair_mask = res.inlier_mask & feats_ok[..., None]
    return (CellList(means=src_pts, covs=covs, mask=pair_mask),
            CellList(means=tgt_pts, covs=covs, mask=pair_mask))


def _match_sets_plain(params: FeatureParams, ref: FeatureSet, ref_desc,
                      mov: FeatureSet, mov_desc, u) -> MatchResult:
    """The plain twin of match_sets: eager operations over (..., M, C)
    tensors."""
    c_cap = params.max_correspondences
    m_hyp = params.ransac_hypotheses
    acc = params.ransac_acceptance
    dev = u.device

    dist = symmetric_chi2_matrix(ref_desc, mov_desc)
    bad = ~(ref.mask[..., :, None] & mov.mask[..., None, :])
    dist = torch.where(bad, math.inf, dist)

    best_ref = torch.argmin(dist, -2)                 # first min, as jnp
    best_d = dist.amin(-2)
    neg_topk, mov_sel = top_k_stable(-best_d, min(c_cap, best_d.shape[-1]))
    if mov_sel.shape[-1] < c_cap:
        padn = c_cap - mov_sel.shape[-1]
        mov_sel = torch.cat(
            [mov_sel, mov_sel.new_zeros(mov_sel.shape[:-1] + (padn,))], -1)
        neg_topk = torch.cat([neg_topk, neg_topk.new_full(
            neg_topk.shape[:-1] + (padn,), -math.inf)], -1)
    cd = -neg_topk
    corr_mov = mov_sel
    corr_ref = take_rows(best_ref, mov_sel)
    corr_mask = cd < params.ransac_dist_threshold

    a = take_rows(ref.pts, corr_ref)                              # (..., C, 2)
    b = take_rows(mov.pts, corr_mov)

    n_valid = corr_mask.sum(-1).to(torch.float32)
    pair_idx = torch.floor(
        u * torch.clamp(n_valid, min=1.0)[..., None, None]
    ).to(torch.int64).clamp(0, c_cap - 1)
    i0, i1 = pair_idx[..., 0], pair_idx[..., 1]
    a0, a1 = take_rows(a, i0), take_rows(a, i1)
    b0, b1 = take_rows(b, i0), take_rows(b, i1)
    da = a1 - a0
    db = b1 - b0
    seg_len = torch.linalg.vector_norm(db, dim=-1)
    theta = (torch.atan2(da[..., 1], da[..., 0])
             - torch.atan2(db[..., 1], db[..., 0]))
    ch, sh = torch.cos(theta), torch.sin(theta)
    tx = a0[..., 0] - (ch * b0[..., 0] - sh * b0[..., 1])
    ty = a0[..., 1] - (sh * b0[..., 0] + ch * b0[..., 1])
    hyp_T = torch.stack([tx, ty, theta], -1)                  # (..., M, 3)
    len_diff2 = (seg_len - torch.linalg.vector_norm(da, dim=-1)) ** 2
    hyp_ok = (
        (seg_len > 0.2)
        & (len_diff2 < params.ransac_rigidity * 4.0)
        & take_rows(corr_mask, i0) & take_rows(corr_mask, i1) & (i0 != i1)
    )

    proj = _apply(hyp_T[..., :, None, :], b[..., None, :, :])  # (..., M, C, 2)
    r2_raw = ((a[..., None, :, :] - proj) ** 2).sum(-1)
    r2 = torch.where(corr_mask[..., None, :], r2_raw, acc)
    msac = torch.clamp(r2, max=acc).sum(-1)
    msac = torch.where(hyp_ok, msac, math.inf)
    n_budget = hypothesis_budget(params)
    considered = torch.arange(m_hyp, device=dev) < min(max(n_budget, 1),
                                                        m_hyp)
    if params.ransac_adaptive:
        considered = considered & adaptive_considered(params, r2_raw,
                                                      corr_mask, hyp_ok)
    msac = torch.where(considered, msac, math.inf)

    best = torch.argmin(msac, -1)[..., None]
    T = take_rows(hyp_T, best)[..., 0, :]
    any_hyp = torch.isfinite(take_rows(msac, best)[..., 0])

    for _ in range(2):
        r2 = ((a - _apply(T[..., None, :], b)) ** 2).sum(-1)
        w = ((r2 < acc) & corr_mask).to(torch.float32)
        T = torch.where((w.sum(-1) >= 2)[..., None], _procrustes(a, b, w), T)
    T_fit = torch.where(any_hyp[..., None], T, 0.0)

    r2 = ((a - _apply(T_fit[..., None, :], b)) ** 2).sum(-1)
    inlier = (r2 < acc) & corr_mask & any_hyp[..., None]
    n_in = inlier.sum(-1).to(torch.int32)
    score = torch.where(corr_mask, torch.clamp(r2, max=acc), acc).sum(-1)
    return MatchResult(
        T=T_fit, score=score, num_inliers=n_in, corr_ref=corr_ref,
        corr_mov=corr_mov, corr_mask=corr_mask, inlier_mask=inlier,
        valid=any_hyp & (n_in >= 2),
    )


