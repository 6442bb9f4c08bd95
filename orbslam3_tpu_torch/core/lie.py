"""SO(3) / SE(3) operations as plain PyTorch functions.

Port of `orbslam3_tpu/core/lie.py` (the subset the tracking front end uses).
Same conventions: rotations are (..., 3, 3) matrices, SE(3) is the pair
(R, t), ``xi = (rho, phi)`` puts translation first, and small-angle branches
are Taylor expansions selected with `torch.where`, so nothing branches on
data. Functions broadcast over leading batch dimensions and keep the input's
dtype and device.
"""

from __future__ import annotations

import torch

# Angle below which Taylor expansions replace trig ratios.
_SMALL = 1e-5


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (...,3) -> (...,3,3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`: (...,3,3) -> (...,3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc_terms(theta2: torch.Tensor):
    """(sin th/th, (1-cos th)/th^2, (th - sin th)/th^3), branch-free."""
    theta = torch.sqrt(theta2)
    small = theta < _SMALL
    th2 = torch.where(small, torch.ones_like(theta2), theta2)
    th = torch.sqrt(th2)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(th)) / th2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (th - torch.sin(th)) / (th2 * th))
    return a, b, c


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Exponential map so(3) -> SO(3) (Rodrigues), (...,3) -> (...,3,3)."""
    a, b, _ = _sinc_terms(torch.sum(w * w, dim=-1))
    W = hat(w)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J_l = I + B*W + C*W^2 of SO(3)."""
    _, b, c = _sinc_terms(torch.sum(w * w, dim=-1))
    W = hat(w)
    return _eye_like(W) + b[..., None, None] * W + c[..., None, None] * (W @ W)


def so3_normalize(R: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation matrix back onto SO(3) via SVD."""
    u, _, vt = torch.linalg.svd(R)
    det = torch.linalg.det(u @ vt)
    one = torch.ones_like(det)[..., None]
    d = torch.cat([one, one, det[..., None]], dim=-1)
    return (u * d[..., None, :]) @ vt


def se3_exp(xi: torch.Tensor):
    """Exponential map se(3) -> SE(3). ``xi = (rho, phi)`` (...,6) -> (R, t)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t = (so3_left_jacobian(phi) @ rho[..., None])[..., 0]
    return R, t


def se3_apply(R: torch.Tensor, t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Transform points p (...,3) by (R, t)."""
    return torch.einsum("...ij,...j->...i", R, p) + t
