"""Stereo matching and depth: rectified row bands, RGB-D, fisheye pairs.

Port of `orbslam3_tpu/vision/stereo.py` (ORB-SLAM3's
`Frame::ComputeStereoMatches`, `Frame::ComputeStereoFromRGBD` and
`KannalaBrandt8::TriangulateMatches`):

- `stereo_match`: for each left keypoint of a rectified pair, the right
  keypoints in its row band at a compatible octave and a positive
  disparity are the candidates; kernel K1 picks the best (policy
  "stereo"), and depth = bf / disparity;
- `depth_from_rgbd`: the registered depth map read at each keypoint, with
  the virtual right coordinate uR = u - bf / z;
- `fisheye_stereo_match`: a descriptor match over every valid pair
  (K1, policy "fisheye_stereo"), then midpoint triangulation with the
  known extrinsics and a reprojection check in both cameras.

Descriptors are the packed (N, 8) int32 words of `FrameFeatures.desc`,
handed to K1 as they are.
"""

from __future__ import annotations

import torch

from orbslam3_tpu_torch.kernels import hamming as ham


def _octave_scale(octave: torch.Tensor, scale: float = 1.2) -> torch.Tensor:
    """scale ** octave in f32 from a table computed by `torch.pow` on the
    CPU (the values the reference's f32 power gives there), so the band
    edge is the same on every device."""
    table = torch.pow(torch.tensor(scale, dtype=torch.float32),
                      torch.arange(32, dtype=torch.float32))
    return table.to(octave.device)[octave.long()]


def stereo_mask(uvL, octL, validL, uvR, octR, validR, max_disp) -> torch.Tensor:
    """(N, M) bool candidates of the rectified row search: row distance
    <= 2 px x 1.2^octave of the left keypoint, octave difference <= 1,
    disparity in (0.1, max_disp]."""
    row_tol = 2.0 * _octave_scale(octL)
    band = torch.abs(uvL[:, 1:2] - uvR[None, :, 1]) <= row_tol[:, None]
    oct_ok = torch.abs(octL[:, None] - octR[None, :]) <= 1
    disp = uvL[:, 0:1] - uvR[None, :, 0]
    disp_ok = (disp > 0.1) & (disp <= max_disp)
    return (band & oct_ok & disp_ok & validL[:, None] & validR[None, :]).contiguous()


def stereo_match(uvL, wordsL, octL, validL, uvR, wordsR, octR, validR,
                 bf, min_z, max_disp, max_dist: int = ham.TH_HIGH):
    """Row-band stereo association of a rectified pair. `bf` = baseline *
    fx, `min_z` the closest admissible depth, `max_disp` = bf / min_z.
    Returns (u_right (N,), depth (N,), has_depth (N,)), -1 / 0 where
    unmatched. Gates: the `stereo_mask` candidates, Hamming distance <=
    `max_dist` (TH_HIGH) with a 0.9 best/runner-up ratio, disparity >
    0.1 and depth >= min_z."""
    dev = uvL.device
    bf, min_z, max_disp = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                           for x in (bf, min_z, max_disp))
    mask = stereo_mask(uvL, octL, validL, uvR, octR, validR, max_disp)
    idx, _best, ok = ham.masked_match_ratio(wordsL, wordsR, mask, max_dist=max_dist,
                                            ratio=0.9, policy="stereo")
    u_r = uvR[idx.long(), 0]
    d = uvL[:, 0] - u_r
    depth = bf / torch.clamp(d, min=1e-6)
    good = ok & (d > 0.1) & (depth >= min_z)
    return torch.where(good, u_r, -1.0), torch.where(good, depth, 0.0), good


def depth_from_rgbd(uv, valid, depth_map, bf, depth_factor: float = 1.0):
    """RGB-D: the registered depth map (H, W) read at the keypoints
    (rounded half to even, clamped to the image) times `depth_factor`, and
    the virtual right coordinate u - bf / z. Returns (u_right, depth,
    has_depth)."""
    h, w = depth_map.shape
    x = torch.clamp(torch.round(uv[:, 0]).long(), 0, w - 1)
    y = torch.clamp(torch.round(uv[:, 1]).long(), 0, h - 1)
    z = depth_map[y, x].to(torch.float32) * depth_factor
    good = valid & (z > 0.0) & torch.isfinite(z)
    bf = torch.as_tensor(bf, dtype=torch.float32, device=uv.device)
    u_r = uv[:, 0] - bf / torch.clamp(z, min=1e-6)
    return torch.where(good, u_r, -1.0), torch.where(good, z, 0.0), good


def fisheye_stereo_match(uvL, wordsL, validL, uvR, wordsR, validR, camL, camR,
                         R_rl, t_rl, max_dist: int = ham.TH_LOW,
                         max_reproj_err: float = 3.0):
    """Non-rectified (fisheye) stereo: a descriptor match over every valid
    pair (TH_LOW, ratio 0.8), then the midpoint of the two rays' closest
    points in the left frame, kept if it lies in front of both cameras,
    deeper than 0.05 m, and reprojects within `max_reproj_err` px in both.
    `R_rl`, `t_rl` map left coords to the right (x_r = R_rl x_l + t_rl).
    Returns (depth (N,), good (N,), idx (N,))."""
    mask = (validL[:, None] & validR[None, :]).contiguous()
    idx, _best, ok = ham.masked_match_ratio(wordsL, wordsR, mask, max_dist=max_dist,
                                            ratio=0.8, policy="fisheye_stereo")
    uvR_m = uvR[idx.long()]
    d1 = camL.unproject(uvL)
    d1 = d1 / torch.linalg.vector_norm(d1, dim=-1, keepdim=True)
    d2 = camR.unproject(uvR_m)
    d2 = d2 / torch.linalg.vector_norm(d2, dim=-1, keepdim=True)
    d2 = d2 @ R_rl                # the right rays in the left frame
    o2 = -t_rl @ R_rl             # the right centre in the left frame
    b_ = torch.sum(d1 * d2, dim=-1)
    denom = torch.clamp(1.0 - b_ * b_, min=1e-9)
    e_ = d1 @ o2
    f_ = d2 @ o2
    s = (e_ - b_ * f_) / denom
    t = (b_ * e_ - f_) / denom
    X = 0.5 * (s[:, None] * d1 + (o2[None, :] + t[:, None] * d2))
    depth = X[:, 2]
    errL = torch.linalg.vector_norm(camL.project(X) - uvL, dim=-1)
    errR = torch.linalg.vector_norm(camR.project(X @ R_rl.T + t_rl) - uvR_m, dim=-1)
    good = (ok & (s > 0) & (t > 0) & (depth > 0.05)
            & (errL < max_reproj_err) & (errR < max_reproj_err))
    return torch.where(good, depth, 0.0), good, idx
