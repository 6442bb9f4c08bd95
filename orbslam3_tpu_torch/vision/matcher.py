"""Projection data association over the masked Hamming matcher.

Port of `orbslam3_tpu/vision/matcher.py`: every policy builds a candidate
mask and hands it to kernel K1, which picks the best and runner-up
descriptor among the candidates.

- `search_by_projection` (tracking): map points projected into the frame,
  octave-scaled windows and the `isInFrustum` gates;
- `search_for_initialization`: 100 px windows between two frames, both
  directions (a mutual check), optionally the rotation histogram;
- `search_for_triangulation`: epipolar bands between two keyframes, both
  directions;
- `fuse_by_projection`: a neighbour's points projected into a keyframe.

Descriptors may be packed (N, 8) int32 words or (N, 256) +/-1 planes; the
callers of the port hand words, so K1 reads them as they are stored. Each
call names its policy for K1's launch counts.
"""

from __future__ import annotations

import math

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


def projection_window(
    mp_pos, mp_valid, R, t, camera,  # (K,3), (K,) bool
    f_uv, f_octave, f_valid,         # (N,2), (N,) int, (N,) bool
    radius,                          # px search window at octave 0
    mp_normal=None, mp_min_dist=None, mp_max_dist=None,
):
    """The candidate mask of `search_by_projection`, the part before K1:
    map points projected into the frame, octave-scaled windows and, with the
    point statistics given, the `isInFrustum` gates. No host read and no
    host-to-device copy (`radius` may be a 0-dim tensor on the device), so a
    CUDA graph can hold it. Returns (mask (K,N) bool, in_frustum (K,))."""
    dev = mp_pos.device
    radius = torch.as_tensor(radius, dtype=torch.float32, device=dev)
    uv, _depth, vis = project_points(R, t, camera, mp_pos)
    vis = vis & mp_valid

    d2 = torch.sum(torch.square(uv[:, None, :] - f_uv[None, :, :]), dim=-1)
    r = radius * (1.2 ** f_octave.float())  # octave-scaled window
    window = d2 <= torch.square(r)[None, :]

    oct_ok = None
    if mp_max_dist is not None:
        center = -(R.T @ t)
        pw = mp_pos - center
        dist = torch.linalg.norm(pw, dim=-1)
        in_band = ((dist >= 0.8 * mp_min_dist) & (dist <= 1.2 * mp_max_dist)
                   & (mp_max_dist > 0))
        vis = vis & in_band
        if mp_normal is not None:
            cosang = torch.sum(pw * mp_normal, dim=-1) / torch.clamp(dist, min=1e-9)
            has_n = torch.linalg.norm(mp_normal, dim=-1) > 1e-6
            vis = vis & (~has_n | (cosang > 0.5))
        # PredictScale: level = ceil(log(maxDist/dist) / log 1.2)
        log_scale = torch.log(torch.full((), 1.2, dtype=torch.float32, device=dev))
        lvl = torch.ceil(torch.log(torch.clamp(mp_max_dist, min=1e-9)
                                   / torch.clamp(dist, min=1e-9)) / log_scale)
        lvl = torch.clamp(lvl, 0, 7).to(torch.int32)
        oct_ok = torch.abs(lvl[:, None] - f_octave[None, :]) <= 1

    mask = window & vis[:, None] & f_valid[None, :]
    if oct_ok is not None:
        mask = mask & oct_ok
    return mask, vis


def projection_matches(idx, best, second, vis, n_feats: int,
                       max_dist: int = ham.TH_HIGH, ratio: float = 0.9):
    """The part of `search_by_projection` after K1: the ratio test on K1's
    best and runner-up, in-frustum rows only, one map point per feature.
    Returns (matched (K,), n_matches)."""
    ok = ham.ratio_test(best, second, max_dist, ratio) & vis
    keep = _resolve_duplicates(idx, best, ok, n_feats)
    return keep, torch.sum(keep)


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
    within the window (reference `SearchByProjection`, tracking overload):
    `projection_window`, K1 under policy "tracker", `projection_matches`.

    With the point statistics given, applies the `isInFrustum` gates: view
    distance in [0.8 min, 1.2 max], viewing angle cos > 0.5, and the
    predicted scale level restricting candidate octaves to pred +/- 1.

    Returns (feat_idx (K,), dist (K,), matched (K,), n_matches, in_frustum (K,)).
    """
    dev = device_policy.resolve(device)
    mp_pos, mp_planes, mp_valid, R, t, f_uv, f_planes, f_octave, f_valid = (
        x.to(dev) for x in (mp_pos, mp_planes, mp_valid, R, t, f_uv, f_planes,
                            f_octave, f_valid))
    stats = [None if x is None else x.to(dev) for x in (mp_normal, mp_min_dist, mp_max_dist)]
    mask, vis = projection_window(mp_pos, mp_valid, R, t, camera.to(dev), f_uv, f_octave,
                                  f_valid, radius, *stats)
    idx, best, second = ham.masked_top2(mp_planes, f_planes, mask, policy="tracker")
    keep, n = projection_matches(idx, best, second, vis, f_uv.shape[0], max_dist, ratio)
    return idx, best, keep, n, vis


HISTO_LENGTH = 30  # reference ORBmatcher.cc:41 rotation histogram bins


def rotation_consistency(ang1, ang2, idx, ok, n_bins: int = HISTO_LENGTH,
                         top: int = 3):
    """Dominant-orientation voting: histogram the keypoint-angle difference
    of each match (rounded to the nearest bin), keep matches in the top-3
    bins, where a bin also needs >= 10% of the fullest bin's votes. Angles in
    radians; `idx` maps set-1 entries to set-2 features."""
    two_pi = 2.0 * math.pi
    rot = torch.remainder(ang1 - ang2[idx.long()], two_pi)
    b = torch.remainder(torch.round(rot * (n_bins / two_pi)).to(torch.int64), n_bins)
    hist = torch.zeros(n_bins, dtype=torch.int64, device=ok.device)
    hist.index_add_(0, b, ok.to(torch.int64))
    top_vals, top_idx = torch.sort(hist, descending=True, stable=True)
    top_vals, top_idx = top_vals[:top], top_idx[:top]
    good = top_vals.float() >= 0.1 * top_vals[0].float()
    keep_bin = torch.zeros(n_bins, dtype=torch.bool, device=ok.device)
    keep_bin[top_idx] = good
    return ok & keep_bin[b]


def _both_ways(desc1, desc2, mask, max_dist, ratio, policy):
    """K1 from set 1 to set 2 and back; matches that survive the mutual
    check. Returns (idx (N1,), best (N1,), ok (N1,))."""
    idx, best, ok = ham.masked_match_ratio(desc1, desc2, mask, max_dist=max_dist,
                                           ratio=ratio, policy=policy)
    idx_ba, _, _ = ham.masked_match_ratio(desc2, desc1, mask.T.contiguous(),
                                          max_dist=max_dist, ratio=ratio,
                                          policy=policy)
    return idx, best, ham.mutual_filter(idx, ok, idx_ba)


def search_for_initialization(uv1, desc1, valid1, uv2, desc2, valid2,
                              radius: float = 100.0, max_dist: int = ham.TH_LOW,
                              ratio: float = 0.9, ang1=None, ang2=None,
                              check_rotation: bool = False):
    """Frame-1 -> frame-2 matching in a wide window with a mutual check
    (reference `SearchForInitialization`), plus the rotation histogram when
    asked. Returns (idx, best, ok, n)."""
    d2 = torch.sum(torch.square(uv1[:, None, :] - uv2[None, :, :]), dim=-1)
    mask = (d2 <= radius * radius) & valid1[:, None] & valid2[None, :]
    idx, best, ok = _both_ways(desc1, desc2, mask, max_dist, ratio, "init")
    if check_rotation:
        ok = rotation_consistency(ang1, ang2, idx, ok)
    return idx, best, ok, torch.sum(ok)


def search_for_triangulation(uv1, desc1, avail1, uv2, desc2, avail2,
                             R1, t1, R2, t2, camera, epi_sigma: float = 2.0,
                             max_dist: int = ham.TH_LOW):
    """Match unassigned features of two keyframes under the epipolar
    constraint (reference `SearchForTriangulation`, its BoW buckets replaced
    by the masked distance matrix): a pair is a candidate when the second
    point lies within 3.84 sigma px of the first one's epipolar line.
    Returns (idx (N1,), ok (N1,))."""
    R12 = R2 @ R1.T
    t12 = t2 - R12 @ t1
    E = lie.hat(t12) @ R12
    x1 = camera.unproject(uv1)  # (N1,3) z=1
    x2 = camera.unproject(uv2)
    l2 = x1 @ E.T  # epipolar lines in image 2, normalized units
    num = torch.abs(l2 @ x2.T)
    den = torch.sqrt(torch.clamp(l2[:, 0] ** 2 + l2[:, 1] ** 2, min=1e-12))[:, None]
    epi_px = num / den * camera.params[0]
    mask = (epi_px < 3.84 * epi_sigma) & avail1[:, None] & avail2[None, :]
    idx, _, ok = _both_ways(desc1, desc2, mask, max_dist, 0.8, "triangulation")
    return idx, ok


def fuse_by_projection(mp_pos, mp_desc, mp_valid, R, t, camera,
                       f_uv, f_desc, f_octave, f_valid,
                       radius: float = 3.0, max_dist: int = ham.TH_LOW):
    """Project candidate map points into a keyframe and associate them with
    features in an octave-scaled window (reference `Fuse`); the caller binds
    free features and merges duplicates. Returns (feat_idx (K,), matched (K,))."""
    uv, _depth, vis = project_points(R, t, camera, mp_pos)
    vis = vis & mp_valid
    d2 = torch.sum(torch.square(uv[:, None, :] - f_uv[None, :, :]), dim=-1)
    r = radius * (1.2 ** f_octave.float())
    mask = (d2 <= torch.square(r)[None, :]) & vis[:, None] & f_valid[None, :]
    idx, best, ok = ham.masked_match_ratio(mp_desc, f_desc, mask, max_dist=max_dist,
                                           ratio=1.0, policy="fuse")
    ok = ok & vis
    return idx, _resolve_duplicates(idx, best, ok, f_uv.shape[0])


def search_by_bow(words1, desc1, valid1, ang1, words2, desc2, valid2, ang2,
                  k: int, max_dist: int = ham.TH_LOW, ratio: float = 0.7):
    """Vocabulary-bucketed matching (reference `SearchByBoW`): features are
    compared only within the same node one level above the leaves, a
    parent-equality mask over the leaf words, then the 0.7 ratio test, the
    mutual check and the rotation histogram, under K1 policy "bow".
    Returns (idx (N1,), dist (N1,), ok (N1,), n)."""
    mask = ((words1 // k)[:, None] == (words2 // k)[None, :]) \
        & (valid1 & (words1 >= 0))[:, None] & (valid2 & (words2 >= 0))[None, :]
    idx, best, ok = _both_ways(desc1, desc2, mask, max_dist, ratio, "bow")
    ok = rotation_consistency(ang1, ang2, idx, ok)
    return idx, best, ok, torch.sum(ok)
