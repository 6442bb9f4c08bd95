"""Projection data association over the masked Hamming matcher.

Port of `orbslam3_tpu/vision/matcher.py` (`project_points`,
`_resolve_duplicates`, `search_by_projection`): every map point is
projected, candidate features are the ones inside an octave-scaled pixel
window that pass the reference's `isInFrustum` gates, and kernel K1 picks
the best and runner-up descriptor among them.
"""

from __future__ import annotations

import torch

from orbslam3_tpu_torch import device as device_policy
from orbslam3_tpu_torch.core import lie
from orbslam3_tpu_torch.kernels import hamming as ham

BIG = 1 << 20


def project_points(R, t, camera, pts, margin: float = 0.0):
    """Project world points; returns (uv, depth, visible mask)."""
    xc = lie.se3_apply(R, t, pts)
    uv = camera.project(xc)
    vis = ((xc[..., 2] > 0.05)
           & (uv[..., 0] >= -margin) & (uv[..., 0] < camera.width + margin)
           & (uv[..., 1] >= -margin) & (uv[..., 1] < camera.height + margin))
    return uv, xc[..., 2], vis


def _resolve_duplicates(best_feat, best_dist, ok, n_feats: int):
    """Keep at most one map point per feature: the closest in descriptor
    space, and of equal distances the lowest map-point index."""
    dist_f = torch.where(ok, best_dist, BIG)
    feat = best_feat.long()
    per_feat = torch.full((n_feats,), BIG, dtype=dist_f.dtype, device=dist_f.device)
    per_feat = per_feat.scatter_reduce(0, feat, dist_f, reduce="amin")
    keep = ok & (dist_f <= per_feat[feat])
    order = torch.arange(best_feat.shape[0], device=feat.device)
    first = torch.full((n_feats,), 1 << 30, dtype=order.dtype, device=feat.device)
    first = first.scatter_reduce(0, feat, torch.where(keep, order, 1 << 30),
                                 reduce="amin")
    return keep & (first[feat] == order)


def search_by_projection(
    mp_pos, mp_planes, mp_valid,     # (K,3), (K,256) +/-1, (K,) bool
    R, t, camera,
    f_uv, f_planes, f_octave, f_valid,  # (N,2), (N,256), (N,) int, (N,) bool
    radius,                          # px search window at octave 0
    max_dist: int = ham.TH_HIGH,
    ratio: float = 0.9,
    mp_normal=None, mp_min_dist=None, mp_max_dist=None,
    device=None,
):
    """Project map points into the frame and associate them to keypoints
    within the window (reference `SearchByProjection`, tracking overload).

    With the point statistics given, applies the `isInFrustum` gates: view
    distance in [0.8 min, 1.2 max], viewing angle cos > 0.5, and the
    predicted scale level restricting candidate octaves to pred +/- 1.

    Returns (feat_idx (K,), dist (K,), matched (K,), n_matches, in_frustum (K,)).
    """
    dev = device_policy.resolve(device)
    mp_pos, mp_planes, mp_valid, R, t, f_uv, f_planes, f_octave, f_valid = (
        x.to(dev) for x in (mp_pos, mp_planes, mp_valid, R, t, f_uv, f_planes,
                            f_octave, f_valid))
    radius = torch.as_tensor(radius, dtype=torch.float32, device=dev)
    camera = camera.to(dev)
    uv, _depth, vis = project_points(R, t, camera, mp_pos)
    vis = vis & mp_valid

    d2 = torch.sum(torch.square(uv[:, None, :] - f_uv[None, :, :]), dim=-1)
    r = radius * (1.2 ** f_octave.float())  # octave-scaled window
    window = d2 <= torch.square(r)[None, :]

    oct_ok = None
    if mp_max_dist is not None:
        mp_max_dist, mp_min_dist = mp_max_dist.to(dev), mp_min_dist.to(dev)
        center = -(R.T @ t)
        pw = mp_pos - center
        dist = torch.linalg.norm(pw, dim=-1)
        in_band = ((dist >= 0.8 * mp_min_dist) & (dist <= 1.2 * mp_max_dist)
                   & (mp_max_dist > 0))
        vis = vis & in_band
        if mp_normal is not None:
            mp_normal = mp_normal.to(dev)
            cosang = torch.sum(pw * mp_normal, dim=-1) / torch.clamp(dist, min=1e-9)
            has_n = torch.linalg.norm(mp_normal, dim=-1) > 1e-6
            vis = vis & (~has_n | (cosang > 0.5))
        # PredictScale: level = ceil(log(maxDist/dist) / log 1.2)
        log_scale = torch.log(torch.tensor(1.2, dtype=torch.float32, device=dev))
        lvl = torch.ceil(torch.log(torch.clamp(mp_max_dist, min=1e-9)
                                   / torch.clamp(dist, min=1e-9)) / log_scale)
        lvl = torch.clamp(lvl, 0, 7).to(torch.int32)
        oct_ok = torch.abs(lvl[:, None] - f_octave[None, :]) <= 1

    mask = window & vis[:, None] & f_valid[None, :]
    if oct_ok is not None:
        mask = mask & oct_ok

    idx, best, ok = ham.masked_match_ratio(mp_planes, f_planes, mask,
                                           max_dist=max_dist, ratio=ratio)
    ok = ok & vis
    keep = _resolve_duplicates(idx, best, ok, f_uv.shape[0])
    return idx, best, keep, torch.sum(keep), vis
