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


def so3_polar(R: torch.Tensor, steps: int = 2) -> torch.Tensor:
    """Project a near-rotation matrix onto SO(3) by Newton's iteration for
    its polar factor, R <- (R + R^-T) / 2, with R^-T from cofactors: the
    rotation `so3_normalize` returns (U V^T), within 3e-6 of it entry by
    entry in float32 for R up to 1e-2 off a rotation (both round at ~1e-6).
    Plain arithmetic: on the card `torch.linalg.svd` checks its convergence
    on the host, which a CUDA graph cannot capture."""
    for _ in range(steps):
        # rows r1 x r2, r2 x r0, r0 x r1: the cofactors, det(R) R^-T
        C = torch.linalg.cross(R.roll(-1, dims=-2), R.roll(-2, dims=-2), dim=-1)
        det = torch.sum(R[..., :1, :] * C[..., :1, :], dim=-1, keepdim=True)
        R = 0.5 * (R + C / det)
    return R


def so3_polar64(R: torch.Tensor) -> torch.Tensor:
    """`so3_polar` carried out in float64 (three steps) and rounded back to
    R's dtype: the rotation `so3_normalize` gives in float64, bit for bit
    for R up to 1e-2 off a rotation, where `so3_polar` in float32 rounds
    apart from the SVD by ~1e-7 an entry. No host read, for a CUDA graph."""
    return so3_polar(R.double(), steps=3).to(R.dtype)


def se3_exp(xi: torch.Tensor):
    """Exponential map se(3) -> SE(3). ``xi = (rho, phi)`` (...,6) -> (R, t)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t = (so3_left_jacobian(phi) @ rho[..., None])[..., 0]
    return R, t


def se3_apply(R: torch.Tensor, t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Transform points p (...,3) by (R, t)."""
    return torch.einsum("...ij,...j->...i", R, p) + t


def _left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian of SO(3): J_l(w)^-1 = J_r(-w)^-1."""
    return so3_right_jacobian_inv(-w)


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Logarithm map SE(3) -> se(3), (...,6) = (rho, phi)."""
    phi = so3_log(R)
    rho = (_left_jacobian_inv(phi) @ t[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def se3_inverse(R: torch.Tensor, t: torch.Tensor):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def se3_compose(Ra, ta, Rb, tb):
    """(Ra,ta) * (Rb,tb): first apply b, then a."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def se3_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Pack (R, t) into homogeneous (...,4,4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(batch + (1, 4))
    top = torch.cat([R.expand(batch + (3, 3)), t.expand(batch + (3,))[..., None]], dim=-1)
    return torch.cat([top, bottom], dim=-2)


# ----------------------------------------------------------------------------
# Quaternions (x, y, z, w), scalar last (Eigen's storage order).
# ----------------------------------------------------------------------------

def quat_from_matrix(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (x,y,z,w), Shepperd's method:
    the four constructions, the one with the largest pivot selected."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def build(x, y, z, w):
        q = torch.stack([x, y, z, w], dim=-1)
        return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                               min=1e-12)

    one = torch.ones_like(tr)
    sw = torch.sqrt(torch.clamp(one + tr, min=1e-12))
    q0 = build((m21 - m12) / (2 * sw), (m02 - m20) / (2 * sw), (m10 - m01) / (2 * sw),
               0.5 * sw)
    sx = torch.sqrt(torch.clamp(one + m00 - m11 - m22, min=1e-12))
    q1 = build(0.5 * sx, (m01 + m10) / (2 * sx), (m02 + m20) / (2 * sx),
               (m21 - m12) / (2 * sx))
    sy = torch.sqrt(torch.clamp(one - m00 + m11 - m22, min=1e-12))
    q2 = build((m01 + m10) / (2 * sy), 0.5 * sy, (m12 + m21) / (2 * sy),
               (m02 - m20) / (2 * sy))
    sz = torch.sqrt(torch.clamp(one - m00 - m11 + m22, min=1e-12))
    q3 = build((m02 + m20) / (2 * sz), (m12 + m21) / (2 * sz), 0.5 * sz,
               (m10 - m01) / (2 * sz))
    k = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)  # first maximum
    qs = torch.stack([q0, q1, q2, q3], dim=-2)
    return torch.take_along_dim(qs, k[..., None, None].expand(qs.shape[:-2] + (1, 4)),
                                dim=-2)[..., 0, :]


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (x,y,z,w) -> rotation matrix."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
    ], dim=-2)


# ----------------------------------------------------------------------------
# Sim(3): loop closure (the Sim3 solver and its refinement, the essential
# graph). A similarity is (s, R, t) with s of shape (...), acting as
# s R p + t.
# ----------------------------------------------------------------------------

def sim3_apply(s, R, t, p):
    """Transform points by the similarity (s, R, t): s R p + t."""
    return s[..., None] * torch.einsum("...ij,...j->...i", R, p) + t


def sim3_inverse(s, R, t):
    Rt = R.transpose(-1, -2)
    s_inv = torch.reciprocal(s)  # 1.0 / s gives float64 tangents on a 0-dim s
    return s_inv, Rt, -s_inv[..., None] * (Rt @ t[..., None])[..., 0]


def sim3_compose(sa, Ra, ta, sb, Rb, tb):
    """(sa,Ra,ta) * (sb,Rb,tb)."""
    return sa * sb, Ra @ Rb, sa[..., None] * (Ra @ tb[..., None])[..., 0] + ta


def sim3_exp(xi: torch.Tensor):
    """Exponential map sim(3) -> Sim(3), xi = (rho, phi, sigma) (...,7)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6:7]
    R = so3_exp(phi)
    # clamped sqrt: d sqrt/dx at 0 is inf, and inf * 0 would poison
    # forward-mode tangents through the guarded Taylor terms of _sim3_W
    theta = torch.sqrt(torch.clamp(torch.sum(phi * phi, dim=-1, keepdim=True), min=1e-24))
    t = (_sim3_W(theta, sigma, phi) @ rho[..., None])[..., 0]
    return torch.exp(sigma)[..., 0], R, t


def sim3_log(s, R, t):
    """Logarithm map Sim(3) -> sim(3), (...,7) = (rho, phi, sigma)."""
    sigma = torch.log(s)[..., None]
    phi = so3_log(R)
    theta = torch.sqrt(torch.clamp(torch.sum(phi * phi, dim=-1, keepdim=True), min=1e-24))
    rho = (_inv3(_sim3_W(theta, sigma, phi)) @ t[..., None])[..., 0]
    return torch.cat([rho, phi, sigma], dim=-1)


def _inv3(W: torch.Tensor) -> torch.Tensor:
    """Inverse of (...,3,3) matrices by cofactors: plain arithmetic, so
    forward-mode tangents stay finite under `vmap` (those of
    `torch.linalg.solve` did not, on a batch of near-identity residuals)."""
    c0 = torch.cross(W[..., 1, :], W[..., 2, :], dim=-1)
    c1 = torch.cross(W[..., 2, :], W[..., 0, :], dim=-1)
    c2 = torch.cross(W[..., 0, :], W[..., 1, :], dim=-1)
    det = torch.sum(W[..., 0, :] * c0, dim=-1, keepdim=True)
    return torch.stack([c0, c1, c2], dim=-1) / det[..., None]


def _sim3_W(theta, sigma, phi):
    """Sim(3)'s translation matrix W = C I + A hat(phi) + B hat(phi)^2
    (Strasdat's closed form), with Taylor branches for small sigma and/or
    small theta selected branch-free. theta and sigma carry a trailing axis
    of 1."""
    eps = 1e-5
    s2 = sigma * sigma
    t2 = theta * theta
    es = torch.exp(sigma)
    small_sig = torch.abs(sigma) < eps
    small_th = theta < eps
    one = torch.ones_like(sigma)
    sig_safe = torch.where(small_sig, one, sigma)
    th_safe = torch.where(small_th, torch.ones_like(theta), theta)
    t2_safe = torch.where(small_th, torch.ones_like(t2), t2)
    s2_safe = torch.where(small_sig, torch.ones_like(s2), s2)
    sin_t, cos_t = torch.sin(th_safe), torch.cos(th_safe)
    denom_safe = torch.where(small_sig & small_th, torch.ones_like(s2), s2 + t2)

    C = torch.where(small_sig, 1.0 + sigma / 2.0 + s2 / 6.0, (es - 1.0) / sig_safe)
    # sigma ~ 0: SO(3)'s left-Jacobian coefficients
    A_s0 = torch.where(small_th, 0.5 - t2 / 24.0, (1.0 - cos_t) / t2_safe)
    B_s0 = torch.where(small_th, 1.0 / 6.0 - t2 / 120.0,
                       (th_safe - sin_t) / (t2_safe * th_safe))
    # theta ~ 0, sigma != 0
    A_t0 = ((sig_safe - 1.0) * es + 1.0) / s2_safe
    B_t0 = ((0.5 * s2 - sig_safe + 1.0) * es - 1.0) / (s2_safe * sig_safe)
    a, b = es * sin_t, es * cos_t
    A_gen = (sigma * a + (1.0 - b) * th_safe) / (th_safe * denom_safe)
    B_gen = (C - ((b - 1.0) * sigma + a * th_safe) / denom_safe) / t2_safe

    A = torch.where(small_sig, A_s0, torch.where(small_th, A_t0, A_gen))
    B = torch.where(small_sig, B_s0, torch.where(small_th, B_t0, B_gen))
    W = hat(phi)
    return (C[..., None] * _eye_like(W) + A[..., None] * W + B[..., None] * (W @ W))
