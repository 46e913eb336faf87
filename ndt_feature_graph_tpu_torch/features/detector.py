"""Multi-scale curvature interest-point detector (port of
ndt_feature_graph_tpu/features/detector.py).

Each scale smooths the scan polyline with a Gaussian over its arc
length (severed at occlusion jumps and missing returns); the response is
the turning angle between the points one sigma of arc ahead and behind;
peaks are strict local maxima above the thresholds; the best scale per
beam competes in a global top-K.

`lax.top_k` puts the lower index first among equal values, and zero
responses tie en masse; `torch.topk` promises no order for ties, so the
top-K is a stable descending sort, sliced.

On CUDA tensors `detect` is one launch of the detector kernel
(ops/cuda_kernels.py detect_features, csrc/features.cu); on the CPU it is
the plain twin, `_detect_plain`, the kernel's yardstick on the card.  The
twin takes the cumulative arc and the window's Gaussian sums in float64
(the CPU's own cumsum accumulates in float64), so their float32 results
do not depend on the order of the adds, on the card or in the kernel.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ndt_feature_graph_tpu_torch.config import FeatureParams
from ndt_feature_graph_tpu_torch.core import se2
from ndt_feature_graph_tpu_torch.io.dataset import beam_angles
from ndt_feature_graph_tpu_torch.ops.ndt_map import take_rows


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


def detect(params: FeatureParams, ranges, hit) -> FeatureSet:
    """Detect up to `max_features` interest points per scan (ranges
    (..., B), hit (..., B) bool; leading dims are independent scans).
    CUDA tensors: cuda_kernels.detect_features (one launch); CPU: the
    plain twin."""
    from ndt_feature_graph_tpu_torch.ops import cuda_kernels

    return cuda_kernels.detect_features(params, ranges, hit)


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
