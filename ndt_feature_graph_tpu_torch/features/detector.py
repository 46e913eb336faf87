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
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ndt_feature_graph_tpu.config import FeatureParams
from ndt_feature_graph_tpu_torch.core import se2
from ndt_feature_graph_tpu_torch.io.dataset import beam_angles


@dataclasses.dataclass
class FeatureSet:
    """Padded interest points in the SENSOR frame."""

    pts: torch.Tensor        # (F, 2)
    angles: torch.Tensor     # (F,) orientation
    scales: torch.Tensor     # (F,) detection scale (sigma)
    response: torch.Tensor   # (F,) detector response
    mask: torch.Tensor       # (F,) bool

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
    """Detect up to `max_features` interest points in one scan
    (ranges (B,), hit (B,) bool)."""
    b = params.num_beams
    dev = ranges.device
    angles = beam_angles(b, device=dev)
    pts = torch.stack(
        [ranges * torch.cos(angles), ranges * torch.sin(angles)], -1
    )
    ar = torch.arange(b, device=dev)

    seg = torch.linalg.vector_norm(pts - torch.roll(pts, 1, 0), dim=-1)
    seg = torch.cat([seg.new_zeros(1), seg[1:]])
    cumarc = torch.cumsum(seg, 0)

    jump = torch.abs(ranges - torch.roll(ranges, 1)) > 0.5
    jump = torch.cat([jump.new_zeros(1), jump[1:]])
    jump = jump | ~hit | ~torch.roll(hit, 1)
    seg_id = torch.cumsum(jump.to(torch.int32), 0)

    half = int(params.smooth_half_beams)
    offs = torch.arange(-half, half + 1, device=dev)
    nidx = (ar[:, None] + offs[None, :]).clamp(0, b - 1)
    darc = torch.abs(cumarc[nidx] - cumarc[:, None])          # (B, W)
    same_piece = (seg_id[nidx] == seg_id[:, None]) & hit[nidx]
    pts_n = pts[nidx]                                         # (B, W, 2)

    responses, tangents, sigmas = [], [], []
    for i in range(params.num_scales):
        sigma = params.base_sigma * params.sigma_step**i
        w = torch.exp(-0.5 * (darc / sigma) ** 2) * same_piece
        wsum = torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        sm = torch.einsum("bw,bwc->bc", w / wsum, pts_n)      # (B, 2)

        fwd = torch.searchsorted(cumarc, cumarc + sigma).clamp(0, b - 1)
        bwd = torch.searchsorted(cumarc, cumarc - sigma).clamp(0, b - 1)
        f = sm[fwd] - sm
        bk = sm - sm[bwd]
        dot = f[:, 0] * bk[:, 0] + f[:, 1] * bk[:, 1]
        cross = bk[:, 0] * f[:, 1] - bk[:, 1] * f[:, 0]
        curv = torch.abs(torch.atan2(cross, dot + 1e-12))

        ok = (
            hit & hit[fwd] & hit[bwd]
            & (seg_id[fwd] == seg_id) & (seg_id[bwd] == seg_id)
            & (fwd > ar) & (bwd < ar)
        )
        responses.append(torch.where(ok, curv, 0.0))
        tangents.append(sm[fwd] - sm[bwd])
        sigmas.append(sigma)

    resp = torch.stack(responses)                  # (S, B)
    tang = torch.stack(tangents)                   # (S, B, 2)

    left = torch.roll(resp, 1, -1)
    right = torch.roll(resp, -1, -1)
    is_peak = (
        (resp > left + params.peak_min_diff)
        & (resp > right + params.peak_min_diff)
        & (resp > params.peak_min_value)
    )
    peak_resp = torch.where(is_peak, resp, 0.0)

    best_scale = torch.argmax(peak_resp, 0)      # first max, as jnp
    best_resp = peak_resp.amax(0)

    top_resp, top_idx = top_k_stable(best_resp, params.max_features)
    valid = top_resp > 0.0

    sel_scale_idx = best_scale[top_idx]
    # Scale sigmas selected with where(), not a host->device table copy.
    sel_scale = torch.zeros_like(top_resp)
    for i, sigma in enumerate(sigmas):
        sel_scale = torch.where(sel_scale_idx == i, sigma, sel_scale)
    sel_pts = pts[top_idx]
    sel_tang = tang[sel_scale_idx, top_idx]                   # (F, 2)
    na = torch.atan2(sel_tang[:, 0], -sel_tang[:, 1])
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
