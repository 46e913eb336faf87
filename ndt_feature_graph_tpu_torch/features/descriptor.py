"""Beta-grid descriptor: polar occupancy histogram with hit/miss counts
(port of ndt_feature_graph_tpu/features/descriptor.py).

For each interest point, scan endpoints inside its scale-proportional
support count as hits in their polar bin; length-weighted free-space
samples along each beam chord inside the support count as misses.  The
bins are accumulated as one-hot contractions (matmuls — run in full
float32, TF32 off), as the reference does.

On CUDA tensors `describe` is one launch of the descriptor kernel
(ops/cuda_kernels.py describe_features, csrc/features.cu: per-thread bins
and a fixed tree, no one-hot tensor); on the CPU it is the plain twin,
`_describe_plain`, the kernel's yardstick on the card.
"""

from __future__ import annotations

import math

import torch

from ndt_feature_graph_tpu_torch.config import FeatureParams
from ndt_feature_graph_tpu_torch.features.detector import FeatureSet
from ndt_feature_graph_tpu_torch.io.dataset import beam_angles


def describe(params: FeatureParams, feats: FeatureSet, ranges, hit):
    """(..., F, descriptor_dim) descriptors; `feats` (..., F) in the
    sensor frame of the scan (`ranges`, `hit`) (..., B) with the same
    leading dims (independent scans).  CUDA tensors:
    cuda_kernels.describe_features (one launch); CPU: the plain twin."""
    from ndt_feature_graph_tpu_torch.ops import cuda_kernels

    return cuda_kernels.describe_features(params, feats, ranges, hit)


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


def descriptor_dim(params: FeatureParams) -> int:
    """Descriptor row width for the configured statistic."""
    nbins = params.rho_bins * params.phi_bins
    return 2 * nbins if params.descriptor_stat == "hitmiss" else nbins
