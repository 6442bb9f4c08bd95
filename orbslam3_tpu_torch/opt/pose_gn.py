"""Pose-only optimization: fixed-iteration robust Gauss-Newton on SE(3).

Port of the JAX package's `opt/pose_gn.py` (`reprojection_residuals`,
`optimize_pose`), monocular observations: 4 rounds of 10 damped GN steps
with Huber weights, re-normalising R and re-classifying outliers by
chi2 > 5.991 after each round. Left-multiplicative perturbation,
T <- exp(xi) * T with xi = (rho, phi), so dXc/dxi = [I | -hat(Xc)].
"""

from __future__ import annotations

import torch

from orbslam3_tpu_torch import device as device_policy
from orbslam3_tpu_torch.core import lie, robust

CHI2_MONO = robust.CHI2_MONO
HUBER_MONO = CHI2_MONO ** 0.5


def reprojection_residuals(R, t, points, uv, camera):
    """Residuals (N,2), Jacobians (N,2,6) wrt left-perturbation, and the
    camera-frame points (N,3)."""
    xc = lie.se3_apply(R, t, points)
    res = camera.project(xc) - uv
    Jproj = camera.project_jac(xc)  # (N,2,3)
    Jpose = torch.cat([Jproj, -Jproj @ lie.hat(xc)], dim=-1)
    return res, Jpose, xc


def optimize_pose(
    R0: torch.Tensor,      # (3,3) initial Tcw rotation
    t0: torch.Tensor,      # (3,)
    points: torch.Tensor,  # (N,3) world points
    uv: torch.Tensor,      # (N,2) observations
    info: torch.Tensor,    # (N,) information weight (1/sigma^2 per octave)
    valid: torch.Tensor,   # (N,) bool
    camera,
    n_rounds: int = 4,
    n_iters: int = 10,
    damping: float = 1e-3,
    device=None,
):
    """Returns (R, t, inliers, n_inliers). After each round, observations
    with chi2 > 5.991 are excluded and may re-enter later, as the
    reference's g2o edge levels allow."""
    dev = device_policy.resolve(device)
    R, t, points, uv, info, valid = (x.to(dev) for x in (R0, t0, points, uv,
                                                         info, valid))
    camera = camera.to(dev)
    inlier = valid.to(R.dtype)
    for _ in range(n_rounds):
        for _ in range(n_iters):
            res, J, _ = reprojection_residuals(R, t, points, uv, camera)
            chi2 = torch.sum(res * res, dim=-1) * info
            w = robust.huber_weight(chi2, HUBER_MONO) * info * inlier
            JW = J * w[:, None, None]
            H = torch.einsum("nia,nib->ab", JW, J)
            b = torch.einsum("nia,ni->a", JW, res)
            # relative (Marquardt) diagonal damping: the rotation and
            # translation blocks of H differ by orders of magnitude
            H = H + damping * torch.diag(torch.clamp(torch.diag(H), min=1e-6))
            # solve_ex: no host sync for the singularity check
            dx = -torch.linalg.solve_ex(H, b).result
            dR, dt = lie.se3_exp(dx)
            R, t = dR @ R, dR @ t + dt
        # re-orthonormalise: 40 f32 compositions leave shear in R otherwise
        R = lie.so3_normalize(R)
        res, _, xc = reprojection_residuals(R, t, points, uv, camera)
        chi2 = torch.sum(res * res, dim=-1) * info
        inlier = (valid.to(R.dtype) * (chi2 < CHI2_MONO).to(R.dtype)
                  * (xc[:, 2] > 0).to(R.dtype))
    return R, t, inlier > 0, torch.sum(inlier).to(torch.int32)
