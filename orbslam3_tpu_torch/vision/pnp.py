"""PnP for relocalization: batched hypothesize-and-verify RANSAC + pose GN.

Port of `orbslam3_tpu/vision/pnp.py` (in place of ORB-SLAM3's MLPnPsolver
in `Tracking::Relocalization`): every hypothesis takes a 6-point sample,
solves the DLT projection matrix (one batched SVD of the (12, 12)
systems), projects its 3x3 block onto SO(3), and is scored by its inlier
count against all correspondences; the winner is polished by the robust
pose GN (`opt/pose_gn.optimize_pose`). Geometry is in normalized camera
coordinates, so any camera model works.

Samples come from a host `torch.Generator`, or the caller passes the
(n_hyp, 6) indices (`samples`), as the parity tests pass the reference's.

One deliberate difference: the DLT's null vector is taken with the sign
that makes det(M) >= 0 (the scale of P = lambda [R|t] positive). An SVD's
null vector has no fixed sign, and the reference's result depends on the
one its solver returns; the port's does not, so the card and the CPU agree.
"""

from __future__ import annotations

import torch

from orbslam3_tpu_torch.opt.pose_gn import optimize_pose
from orbslam3_tpu_torch.vision.twoview import draw_samples

SAMPLE = 6
N_HYP = 256


def _closest_rotation(M: torch.Tensor) -> torch.Tensor:
    u, _, vt = torch.linalg.svd(M)
    d = torch.linalg.det(u @ vt)
    one = torch.ones_like(d)
    return (u * torch.stack([one, one, d], dim=-1)[..., None, :]) @ vt


def _dlt_pose(pts: torch.Tensor, xn: torch.Tensor):
    """DLT from (B,S,3) world points and (B,S,2) normalized image points:
    the (2S, 12) system for P = [R|t], its smallest right singular vector,
    the 3x3 block projected onto a rotation; a sample whose points are
    mostly behind the camera is flipped."""
    B, S, _ = pts.shape
    zeros = pts.new_zeros((B, S, 4))
    Xh = torch.cat([pts, pts.new_ones((B, S, 1))], -1)
    r1 = torch.cat([Xh, zeros, -xn[..., :1] * Xh], -1)
    r2 = torch.cat([zeros, Xh, -xn[..., 1:2] * Xh], -1)
    A = torch.cat([r1, r2], 1)                                   # (B, 2S, 12)
    _, _, vt = torch.linalg.svd(A, full_matrices=True)
    p = vt[:, -1].reshape(B, 3, 4)
    p = p * torch.where(torch.linalg.det(p[:, :, :3]) < 0, -1.0, 1.0)[:, None, None]
    M, t = p[:, :, :3], p[:, :, 3]
    u, sv, vtm = torch.linalg.svd(M)
    det = torch.linalg.det(u @ vtm)
    one = torch.ones_like(det)
    R = (u * torch.stack([one, one, det], dim=-1)[:, None, :]) @ vtm
    scale = sv.sum(-1) / 3.0 * det
    t = t / torch.where(torch.abs(scale) > 1e-12, scale, 1e-12)[:, None]
    z = (torch.einsum("bij,bsj->bsi", R, pts) + t[:, None])[..., 2]
    flip = (z < 0).sum(-1) > (S // 2)
    sign = torch.where(flip, -1.0, 1.0)
    return _closest_rotation(R * sign[:, None, None]), t * sign[:, None]


def pnp_ransac(points, uv, valid, camera, generator: torch.Generator | None = None,
               samples: torch.Tensor | None = None, n_hyp: int = N_HYP,
               inlier_thresh_px: float = 5.991 ** 0.5 * 2.0):
    """(N,3) world points, (N,2) pixels, (N,) valid -> (R, t, inliers (N,),
    n_inliers) of the hypothesis with the most inliers (the first of equal
    counts)."""
    if samples is None:  # drawn on the host, with a host generator
        samples = draw_samples(valid.cpu(), n_hyp, generator, size=SAMPLE)
    idx = samples.to(points.device).long()
    xn = camera.unproject(uv)[..., :2]
    Rs, ts = _dlt_pose(points[idx], xn[idx])
    xc = torch.einsum("bij,nj->bni", Rs, points) + ts[:, None]
    err2 = torch.sum((camera.project(xc) - uv) ** 2, -1)
    inl = valid & (err2 < inlier_thresh_px ** 2) & (xc[..., 2] > 0)
    scores = inl.sum(-1)
    best = torch.argmax(scores)
    return Rs[best], ts[best], inl[best], scores[best]


def relocalize_pose(points, uv, octave_info, valid, camera,
                    generator: torch.Generator | None = None,
                    samples: torch.Tensor | None = None, min_inliers: int = 15):
    """PnP RANSAC + robust pose GN polish (the candidate body of
    `Tracking::Relocalization`). Returns (R, t, ok, n_inliers)."""
    R0, t0, inl, _ = pnp_ransac(points, uv, valid, camera, generator, samples)
    R, t, _, n = optimize_pose(R0, t0, points, uv, octave_info, valid & inl, camera,
                               device=points.device)
    return R, t, n >= min_inliers, n
