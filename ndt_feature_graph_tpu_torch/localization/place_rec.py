"""Place recognition and relocalization against a scan database (port of
ndt_feature_graph_tpu/localization/place_rec.py).

The database is a fixed-capacity stack of reference scans (pose,
features, descriptors, used flag).  Relocalizing matches the live scan
against every stored scan in ONE batched RANSAC call, with the draws
passed in: u (K, M, 2), one (M, 2) block per stored scan.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ndt_feature_graph_tpu_torch import resolve_device
from ndt_feature_graph_tpu_torch.config import FeatureParams
from ndt_feature_graph_tpu_torch.core import se2
from ndt_feature_graph_tpu_torch.features import descriptor, detector, ransac
from ndt_feature_graph_tpu_torch.io import serialize


@dataclasses.dataclass
class ScanDatabase:
    """RefScan store (conversions.h RefScan: scan + pose + features)."""

    poses: torch.Tensor              # (K, 3) world pose of each stored scan
    feats: detector.FeatureSet       # stacked (K, F, ...)
    desc: torch.Tensor               # (K, F, D)
    mask: torch.Tensor               # (K,) slot used


def empty_database(fp: FeatureParams, capacity: int,
                   device=None) -> ScanDatabase:
    """An empty database on `device` (the card unless given)."""
    dev = resolve_device(device)
    f = fp.max_features
    z = dict(dtype=torch.float32, device=dev)
    return ScanDatabase(
        poses=torch.zeros((capacity, 3), **z),
        feats=detector.FeatureSet(
            pts=torch.zeros((capacity, f, 2), **z),
            angles=torch.zeros((capacity, f), **z),
            scales=torch.ones((capacity, f), **z),
            response=torch.zeros((capacity, f), **z),
            mask=torch.zeros((capacity, f), dtype=torch.bool, device=dev),
        ),
        desc=torch.full((capacity, f, descriptor.descriptor_dim(fp)), 0.5,
                        **z),
        mask=torch.zeros(capacity, dtype=torch.bool, device=dev),
    )


def _set_row(buf, slot, row):
    out = buf.clone()
    out[slot] = row
    return out


def insert_scan(db: ScanDatabase, fp: FeatureParams, pose, ranges, hit,
                min_dist: float = 0.5) -> ScanDatabase:
    """Store the scan if it is novel (>= min_dist from every stored pose)
    and capacity remains (generate_scan_map semantics; the decision is
    read on the host)."""
    pose = torch.as_tensor(pose, dtype=torch.float32, device=db.poses.device)
    d = torch.linalg.vector_norm(db.poses[:, :2] - pose[:2], dim=-1)
    novel = ~torch.any(db.mask & (d < min_dist))
    slot = torch.argmax((~db.mask).to(torch.int32))   # first free slot
    if not bool(novel & ~torch.all(db.mask)):
        return db
    feats = detector.detect(fp, ranges, hit)
    desc = descriptor.describe(fp, feats, ranges, hit)
    return ScanDatabase(
        poses=_set_row(db.poses, slot, pose),
        feats=detector.FeatureSet(**{
            f.name: _set_row(getattr(db.feats, f.name), slot,
                             getattr(feats, f.name))
            for f in dataclasses.fields(feats)}),
        desc=_set_row(db.desc, slot, desc),
        mask=_set_row(db.mask, slot, True),
    )


def save_database(path, db: ScanDatabase):
    """Persist the RefScan store to one npz, with the reference's leaf
    keys (a database either package saved loads in both)."""
    serialize.save_pytree(path, db)


def load_database(path, fp: FeatureParams, device=None) -> ScanDatabase:
    """Rebuild a ScanDatabase from a checkpoint (capacity from the file),
    on `device` (the card unless given)."""
    with np.load(path) as data:
        capacity = int(data["poses"].shape[0])
    return serialize.load_pytree(path, empty_database(fp, capacity, device))


def relocalize(db: ScanDatabase, fp: FeatureParams, ranges, hit, u,
               min_num_matches: int = 8):
    """Match the live scan against every stored scan; u (K, M, 2) are
    the RANSAC draws, one block per stored scan.  Returns (world pose (3,)
    numpy or None, best index, inliers).

    The RANSAC transform maps the live sensor frame onto the stored
    scan's; the world pose is ref_pose o T (updateUnlocalized,
    localization_monitor_node.cpp:346-396)."""
    feats = detector.detect(fp, ranges, hit)
    desc = descriptor.describe(fp, feats, ranges, hit)
    k = db.poses.shape[0]
    live = detector.FeatureSet(**{
        f.name: getattr(feats, f.name).expand(k, *getattr(feats, f.name).shape)
        for f in dataclasses.fields(feats)})
    res = ransac.match_sets(fp, db.feats, db.desc, live,
                            desc.expand(k, *desc.shape), u)
    ninl = torch.where(db.mask & res.valid, res.num_inliers, 0)
    best = int(torch.argmax(ninl))
    n_best = int(ninl[best])
    if n_best < min_num_matches:
        return None, best, n_best
    return se2.compose(db.poses[best], res.T[best]).cpu().numpy(), best, n_best
