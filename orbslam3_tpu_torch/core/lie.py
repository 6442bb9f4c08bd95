"""SO(3) / SE(3) operations as plain PyTorch functions.

Port of `orbslam3_tpu/core/lie.py` (the subset the tracking front end and
the inertial stack use).
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
    """(sin th/th, (1-cos th)/th^2, (th - sin th)/th^3), branch-free.

    Here and below the per-rotation scalars keep a trailing axis of 1
    (`keepdim`): under `torch.func.jacfwd`, arithmetic between a 0-dim
    tensor and a Python number gives float64 tangents."""
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
    a, b, _ = _sinc_terms(torch.sum(w * w, dim=-1, keepdim=True))
    W = hat(w)
    return _eye_like(W) + a[..., None] * W + b[..., None] * (W @ W)


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J_l = I + B*W + C*W^2 of SO(3)."""
    _, b, c = _sinc_terms(torch.sum(w * w, dim=-1, keepdim=True))
    W = hat(w)
    return _eye_like(W) + b[..., None] * W + c[..., None] * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Logarithm map SO(3) -> so(3), (...,3,3) -> (...,3).

    The reference's branches: an atan2 form of the angle (arccos has an
    infinite derivative at 1, and forward-mode tangents through a log at
    the identity would be NaN), a polynomial Taylor branch below `_SMALL`,
    and near pi the axis from the largest column of R + I with its sign
    from the antisymmetric part.
    """
    v = 0.5 * vee(R - R.transpose(-1, -2))               # = sin(theta) * axis
    s2 = torch.sum(v * v, dim=-1, keepdim=True)          # sin^2(theta)
    trace = torch.diagonal(R, dim1=-2, dim2=-1).sum(-1, keepdim=True)
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    s_safe = torch.sqrt(torch.clamp(s2, min=1e-24))      # finite tangent at 0
    theta = torch.atan2(s_safe, cos_theta)
    small = theta < _SMALL
    near_pi = theta > torch.pi - 1e-3
    f_generic = theta / torch.where(small | near_pi, torch.ones_like(s_safe), s_safe)
    f_small = 1.0 + s2 / 6.0 + 7.0 * s2 * s2 / 360.0
    w = torch.where(small, f_small * v, f_generic * v)
    # near pi: the axis from the largest column of S = R + I
    S = R + _eye_like(R)
    k = torch.argmax(torch.diagonal(S, dim1=-2, dim2=-1), dim=-1)  # first maximum
    col = torch.take_along_dim(S, k[..., None, None].expand(S.shape[:-1] + (1,)),
                               dim=-1)[..., 0]
    axis = col / torch.clamp(torch.linalg.vector_norm(col, dim=-1, keepdim=True),
                             min=1e-12)
    s_dot = torch.sum(vee(R - R.transpose(-1, -2)) * axis, dim=-1, keepdim=True)
    sign = torch.where(s_dot < 0, -torch.ones_like(s_dot), torch.ones_like(s_dot))
    return torch.where(near_pi, axis * (sign * theta), w)


def so3_right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Right Jacobian J_r(w) = J_l(-w)."""
    return so3_left_jacobian(-w)


def so3_right_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian: I + W/2 + (1/th^2 - (1+cos)/(2 th sin)) W^2,
    with the small-angle expansion 1/12 + th^2/720."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    small = torch.sqrt(theta2) < _SMALL
    th2 = torch.where(small, torch.ones_like(theta2), theta2)
    th = torch.sqrt(th2)
    coef = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                       1.0 / th2 - (1.0 + torch.cos(th)) / (2.0 * th * torch.sin(th)))
    W = hat(w)
    return _eye_like(W) + 0.5 * W + coef[..., None] * (W @ W)


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
