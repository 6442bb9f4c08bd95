"""Sim(3) / SE(3) alignment: batched Horn RANSAC + robust GN refinement.

Port of `orbslam3_tpu/vision/sim3.py` (ORB-SLAM3's `Sim3Solver` and
`Optimizer::OptimizeSim3`): every RANSAC hypothesis is the closed-form
alignment of a 3-point sample (Horn's method in its SVD form), scored by
the reprojection of each set into the other image; the winner is refined
by Gauss-Newton over the 7 Sim(3) parameters on the mutual reprojection
residuals under a Huber kernel. Fixed-scale mode (stereo, RGB-D, inertial
maps) holds s = 1.

Samples come from a host `torch.Generator`, or the caller passes the
(n_hyp, 3) indices (`samples`), as the parity tests pass the reference's.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.func import jacfwd

from orbslam3_tpu_torch.core import lie, robust
from orbslam3_tpu_torch.vision.twoview import draw_samples

SAMPLE = 3
N_HYP = 256


def horn_alignment(p1: torch.Tensor, p2: torch.Tensor, fix_scale: bool):
    """Closed-form (s, R, t) with p2 ~ s R p1 + t, batched over leading
    dimensions of (..., S, 3) point sets."""
    c1, c2 = p1.mean(-2), p2.mean(-2)
    q1, q2 = p1 - c1[..., None, :], p2 - c2[..., None, :]
    H = q2.transpose(-1, -2) @ q1
    u, sv, vt = torch.linalg.svd(H)
    d = torch.linalg.det(u @ vt)
    one = torch.ones_like(d)
    diag = torch.stack([one, one, d], dim=-1)
    R = (u * diag[..., None, :]) @ vt
    denom = torch.clamp(torch.sum(q1 * q1, dim=(-1, -2)), min=1e-12)
    s = one if fix_scale else torch.sum(sv * diag, -1) / denom
    t = c2 - s[..., None] * (R @ c1[..., None])[..., 0]
    return s, R, t


class Sim3Result(NamedTuple):
    s: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def _mutual(s, R, t, p1, p2):
    """Set 1 in camera 2 and set 2 in camera 1 under S_21 = (s, R, t)."""
    p1_in2 = lie.sim3_apply(s[..., None], R[..., None, :, :], t[..., None, :], p1)
    si, Ri, ti = lie.sim3_inverse(s, R, t)
    p2_in1 = lie.sim3_apply(si[..., None], Ri[..., None, :, :], ti[..., None, :], p2)
    return p1_in2, p2_in1


def sim3_ransac(p1, p2, uv1, uv2, valid, camera1, camera2,
                generator: torch.Generator | None = None,
                samples: torch.Tensor | None = None, n_hyp: int = N_HYP,
                fix_scale: bool = False, th_px: float = 9.210 ** 0.5):
    """3-point Sim3 RANSAC with bidirectional reprojection scoring
    (`Sim3Solver::CheckInliers`): (N,3) points of the same landmarks in
    each camera, their (N,2) pixels, (N,) valid."""
    if samples is None:  # drawn on the host, with a host generator
        samples = draw_samples(valid.cpu(), n_hyp, generator, size=SAMPLE)
    idx = samples.to(p1.device).long()
    ss, Rs, ts = horn_alignment(p1[idx], p2[idx], fix_scale)
    p1_in2, p2_in1 = _mutual(ss, Rs, ts, p1, p2)
    e2 = torch.sum((camera2.project(p1_in2) - uv2) ** 2, -1)
    e1 = torch.sum((camera1.project(p2_in1) - uv1) ** 2, -1)
    inl = valid & (e1 < th_px ** 2) & (e2 < th_px ** 2) \
        & (p1_in2[..., 2] > 0) & (p2_in1[..., 2] > 0)
    scores = inl.sum(-1)
    best = torch.argmax(scores)
    return Sim3Result(ss[best], Rs[best], ts[best], inl[best], scores[best])


def optimize_sim3(s0, R0, t0, p1, p2, uv1, uv2, info, valid, camera1, camera2,
                  n_iters: int = 10, fix_scale: bool = False,
                  huber: float = math.sqrt(10.0)):
    """Robust Gauss-Newton over the Sim3 (`Optimizer::OptimizeSim3`): mutual
    reprojection residuals, Huber weights, left perturbation S <- exp(xi) S;
    the Jacobian by forward-mode AD. Returns (s, R, t, inliers,
    n_inliers)."""
    info2 = torch.cat([info, info])
    valid2 = torch.cat([valid, valid]).to(info.dtype)

    def residuals(s, R, t):
        p1_in2, p2_in1 = _mutual(s, R, t, p1, p2)
        return camera1.project(p2_in1) - uv1, camera2.project(p1_in2) - uv2

    s, R, t = s0, R0, t0
    for _ in range(n_iters):
        def res_vec(xi, s=s, R=R, t=t):
            ds, dR, dt = lie.sim3_exp(xi)
            r1, r2 = residuals(*lie.sim3_compose(ds, dR, dt, s, R, t))
            return torch.cat([r1.reshape(-1), r2.reshape(-1)])

        xi0 = torch.zeros(7, dtype=R.dtype, device=R.device)
        r = res_vec(xi0)
        J = jacfwd(res_vec)(xi0)
        chi2 = (r.reshape(-1, 2) ** 2).sum(-1) * info2
        w = robust.huber_weight(chi2, huber) * info2 * valid2
        w2 = torch.repeat_interleave(w, 2)
        H = J.T @ (J * w2[:, None])
        b = J.T @ (r * w2)
        if fix_scale:
            keep = torch.ones(7, dtype=H.dtype, device=H.device)
            keep[6] = 0.0
            H = H * keep[:, None] * keep[None, :] + torch.diag(1.0 - keep)
            b = b * keep
        H = H + 1e-6 * torch.eye(7, dtype=H.dtype, device=H.device)
        ds, dR, dt = lie.sim3_exp(-torch.linalg.solve(H, b))
        s, R, t = lie.sim3_compose(ds, dR, dt, s, R, t)
    R = lie.so3_normalize(R)
    r1, r2 = residuals(s, R, t)
    inl = valid & ((r1 ** 2).sum(-1) * info < 9.21) & ((r2 ** 2).sum(-1) * info < 9.21)
    return s, R, t, inl, inl.sum()
