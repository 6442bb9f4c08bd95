"""Pose-only optimization: fixed-iteration robust Gauss-Newton on SE(3).

Port of the JAX package's `opt/pose_gn.py` (`reprojection_residuals`,
`optimize_pose`, `optimize_pose_batch`): 4 rounds of 10 damped GN steps
with Huber weights, re-normalising R and re-classifying outliers by chi2
after each round. Observations with a virtual right coordinate (stereo or
RGB-D) add a third residual row, (u - bf/z) - u_r, and take the 3-DoF
Huber delta and gate (sqrt(7.815) / 7.815) where the others take the
2-DoF ones (sqrt(5.991) / 5.991). Left-multiplicative perturbation,
T <- exp(xi) * T with xi = (rho, phi), so dXc/dxi = [I | -hat(Xc)].
"""

from __future__ import annotations

import torch

from orbslam3_tpu_torch import device as device_policy
from orbslam3_tpu_torch.core import lie, robust

CHI2_MONO = robust.CHI2_MONO
HUBER_MONO = CHI2_MONO ** 0.5


def stereo_rows(pred, xc, Jproj, res, u_r, bf):
    """Append the stereo row (u - bf/z) - u_r to residuals (..., 2) and
    projection Jacobians (..., 2, 3), zero where u_r < 0 (a monocular
    observation; EdgeStereoSE3ProjectXYZ)."""
    has_st = (u_r >= 0.0)[..., None]
    z = torch.clamp(xc[..., 2], min=1e-6)
    r3 = (pred[..., 0] - bf / z) - u_r
    res = torch.cat([res, torch.where(has_st, r3[..., None], 0.0)], dim=-1)
    zero = torch.zeros_like(z)
    # d(u - bf/z)/dxc = du/dxc + [0, 0, bf/z^2]
    Jr3 = Jproj[..., 0, :] + torch.stack([zero, zero, bf / (z * z)], dim=-1)
    Jproj = torch.cat([Jproj, torch.where(has_st, Jr3, 0.0)[..., None, :]], dim=-2)
    return res, Jproj


def stereo_thresholds(u_r):
    """(Huber delta, chi2 gate) per observation: the 3-DoF ones where
    u_r >= 0, else the 2-DoF ones; scalars without `u_r`."""
    if u_r is None:
        return HUBER_MONO, CHI2_MONO
    st = u_r >= 0.0
    return (torch.where(st, robust.CHI2_STEREO ** 0.5, HUBER_MONO),
            torch.where(st, robust.CHI2_STEREO, CHI2_MONO))


def reprojection_residuals(R, t, points, uv, camera, u_r=None, bf=None):
    """Residuals (N,2|3), Jacobians (N,2|3,6) wrt left-perturbation, and
    the camera-frame points (N,3). With `u_r` (N,) and `bf`, the stereo
    row is appended (zero where u_r < 0)."""
    xc = lie.se3_apply(R, t, points)
    pred = camera.project(xc)
    res = pred - uv
    Jproj = camera.project_jac(xc)  # (N,2,3)
    if u_r is not None:
        res, Jproj = stereo_rows(pred, xc, Jproj, res, u_r, bf)
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
    u_r: torch.Tensor | None = None,  # (N,) virtual right u; < 0 = monocular
    bf=None,                          # baseline * fx, with `u_r`
    normalize=lie.so3_normalize,      # puts R back on SO(3) after each round
):
    """Returns (R, t, inliers, n_inliers). After each round, observations
    over their chi2 gate are excluded and may re-enter later, as the
    reference's g2o edge levels allow. Inputs already on the device, `bf`
    among them as a 0-dim tensor, and `normalize=lie.so3_polar64` leave no
    host read and no host-to-device copy, for a CUDA graph to hold."""
    dev = device_policy.resolve(device)
    R, t, points, uv, info, valid = (x.to(dev) for x in (R0, t0, points, uv,
                                                         info, valid))
    camera = camera.to(dev)
    if u_r is not None:
        u_r = u_r.to(dev)
        bf = torch.as_tensor(bf, dtype=torch.float32, device=dev)
    delta, gate = stereo_thresholds(u_r)
    inlier = valid.to(R.dtype)
    for _ in range(n_rounds):
        for _ in range(n_iters):
            res, J, _ = reprojection_residuals(R, t, points, uv, camera, u_r, bf)
            chi2 = torch.sum(res * res, dim=-1) * info
            w = robust.huber_weight(chi2, delta) * info * inlier
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
        R = normalize(R)
        res, _, xc = reprojection_residuals(R, t, points, uv, camera, u_r, bf)
        chi2 = torch.sum(res * res, dim=-1) * info
        inlier = (valid.to(R.dtype) * (chi2 < gate).to(R.dtype)
                  * (xc[:, 2] > 0).to(R.dtype))
    return R, t, inlier > 0, torch.sum(inlier).to(torch.int32)


def optimize_pose_batch(
    R0: torch.Tensor,      # (F,3,3)
    t0: torch.Tensor,      # (F,3)
    points: torch.Tensor,  # (F,N,3)
    uv: torch.Tensor,      # (F,N,2)
    info: torch.Tensor,    # (F,N)
    valid: torch.Tensor,   # (F,N) bool
    camera,
    n_rounds: int = 4,
    n_iters: int = 10,
    damping: float = 1e-3,
    device=None,
):
    """`optimize_pose` over a batch of frames at once (the reference vmaps
    it; used by the export-time trajectory polish). Returns (R (F,3,3),
    t (F,3), inliers (F,N), n_inliers (F,))."""
    dev = device_policy.resolve(device)
    R, t, points, uv, info, valid = (x.to(dev) for x in (R0, t0, points, uv,
                                                         info, valid))
    camera = camera.to(dev)
    eye6 = torch.eye(6, dtype=R.dtype, device=dev)

    def residuals(R, t):
        xc = torch.einsum("fij,fnj->fni", R, points) + t[:, None, :]
        res = camera.project(xc) - uv
        Jproj = camera.project_jac(xc)
        return res, torch.cat([Jproj, -Jproj @ lie.hat(xc)], dim=-1), xc

    inlier = valid.to(R.dtype)
    for _ in range(n_rounds):
        for _ in range(n_iters):
            res, J, _ = residuals(R, t)
            chi2 = torch.sum(res * res, dim=-1) * info
            w = robust.huber_weight(chi2, HUBER_MONO) * info * inlier
            JW = J * w[..., None, None]
            H = torch.einsum("fnia,fnib->fab", JW, J)
            b = torch.einsum("fnia,fni->fa", JW, res)
            H = H + damping * eye6 * torch.clamp(
                torch.diagonal(H, dim1=-2, dim2=-1), min=1e-6)[:, None, :]
            dx = -torch.linalg.solve_ex(H, b).result
            dR, dt = lie.se3_exp(dx)
            R, t = dR @ R, torch.einsum("fij,fj->fi", dR, t) + dt
        R = lie.so3_normalize(R)
        res, _, xc = residuals(R, t)
        chi2 = torch.sum(res * res, dim=-1) * info
        inlier = (valid.to(R.dtype) * (chi2 < CHI2_MONO).to(R.dtype)
                  * (xc[..., 2] > 0).to(R.dtype))
    return R, t, inlier > 0, torch.sum(inlier, dim=-1).to(torch.int32)
