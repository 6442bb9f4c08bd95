"""Camera projection models: pinhole (+ rad-tan distortion) and
Kannala-Brandt-8 fisheye.

Port of `orbslam3_tpu/core/camera.py`. `Camera` is a plain dataclass where
the reference uses a flax struct; ``kind`` picks the model in Python, as
the reference's static pytree field does. As there, pinhole projection is
ideal (keypoints are undistorted once per frame) and KB8 keeps its
distortion inside the projection.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from orbslam3_tpu_torch import device as device_policy

PINHOLE = "pinhole"
KB8 = "kb8"


@dataclasses.dataclass
class Camera:
    """A camera model: ``kind`` + padded (9,) float32 parameter vector.

    ``params`` layout:
      pinhole: [fx, fy, cx, cy, k1, k2, p1, p2, k3]   (distortion may be 0)
      kb8:     [fx, fy, cx, cy, k1, k2, k3, k4, 0]
    """

    kind: str
    params: torch.Tensor
    width: int = 752
    height: int = 480

    @staticmethod
    def pinhole(fx, fy, cx, cy, dist=(0.0, 0.0, 0.0, 0.0, 0.0), width=752,
                height=480, device=None) -> "Camera":
        d = tuple(dist) + (0.0,) * (5 - len(dist))
        p = torch.tensor([fx, fy, cx, cy, *d], dtype=torch.float32,
                         device=device_policy.resolve(device))
        return Camera(kind=PINHOLE, params=p, width=width, height=height)

    @staticmethod
    def kb8(fx, fy, cx, cy, k1, k2, k3, k4, width=512, height=512,
            device=None) -> "Camera":
        p = torch.tensor([fx, fy, cx, cy, k1, k2, k3, k4, 0.0],
                         dtype=torch.float32, device=device_policy.resolve(device))
        return Camera(kind=KB8, params=p, width=width, height=height)

    def to(self, device) -> "Camera":
        return dataclasses.replace(self, params=self.params.to(device))

    def project(self, xc: torch.Tensor) -> torch.Tensor:
        """Camera-frame points (...,3) -> pixel coords (...,2)."""
        if self.kind == PINHOLE:
            return pinhole_project(self.params, xc)
        return kb8_project(self.params, xc)

    def unproject(self, uv: torch.Tensor) -> torch.Tensor:
        """Pixels (...,2) -> rays (...,3) with z=1."""
        if self.kind == PINHOLE:
            return pinhole_unproject(self.params, uv)
        return kb8_unproject(self.params, uv)

    def project_jac(self, xc: torch.Tensor) -> torch.Tensor:
        """d(uv)/d(xc): (...,2,3)."""
        if self.kind == PINHOLE:
            return pinhole_project_jac(self.params, xc)
        return kb8_project_jac(self.params, xc)

    def distort_points(self, uv: torch.Tensor) -> torch.Tensor:
        """Ideal pixel coords -> distorted pixel coords (pinhole rad-tan)."""
        if self.kind != PINHOLE:
            return uv
        return _in_normalized(self.params, uv, radtan_distort)

    def undistort_points(self, uv: torch.Tensor) -> torch.Tensor:
        """Distorted pixel coords -> ideal pixel coords (fixed-point rad-tan)."""
        if self.kind != PINHOLE:
            return uv
        return _in_normalized(self.params, uv, radtan_undistort)


def _in_normalized(params, uv, fn):
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    xn = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], dim=-1)
    xo = fn(params[4:9], xn)
    return torch.stack([xo[..., 0] * fx + cx, xo[..., 1] * fy + cy], dim=-1)


def _safe_z(z: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(z) < 1e-9, torch.sign(z) * 1e-9 + 1e-12, z)


# ----------------------------------------------------------------------------
# Pinhole
# ----------------------------------------------------------------------------


def pinhole_project(params: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    z = _safe_z(xc[..., 2])
    return torch.stack([fx * xc[..., 0] / z + cx, fy * xc[..., 1] / z + cy],
                       dim=-1)


def pinhole_unproject(params: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def pinhole_project_jac(params: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """Analytic d(uv)/d(xc) of the ideal pinhole."""
    fx, fy = params[0], params[1]
    x, y = xc[..., 0], xc[..., 1]
    iz = 1.0 / _safe_z(xc[..., 2])
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    row0 = torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1)
    row1 = torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def radtan_distort(dist: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """Radial-tangential distortion of normalized coords (...,2)."""
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def radtan_undistort(dist: torch.Tensor, xd: torch.Tensor,
                     iters: int = 8) -> torch.Tensor:
    """Invert rad-tan distortion by fixed-point iteration (OpenCV-style)."""
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    xn = xd
    for _ in range(iters):
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        xn = torch.stack([(xd[..., 0] - dx) / radial, (xd[..., 1] - dy) / radial],
                         dim=-1)
    return xn


# ----------------------------------------------------------------------------
# Kannala-Brandt 8: r(theta) = theta + k1 theta^3 + k2 theta^5 + ...
# ----------------------------------------------------------------------------


def _kb8_theta_poly(k: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    t2 = theta * theta
    return theta * (1.0 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3]))))


def kb8_project(params: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    x, y, z = xc[..., 0], xc[..., 1], xc[..., 2]
    r = torch.sqrt(x * x + y * y)
    theta = torch.atan2(r, z)
    scale = _kb8_theta_poly(params[4:8], theta) / torch.clamp(r, min=1e-12)
    # r -> 0: d ~= theta ~= r/z, so the scale tends to 1/z
    scale = torch.where(r < 1e-8, 1.0 / _safe_z(z), scale)
    return torch.stack([fx * x * scale + cx, fy * y * scale + cy], dim=-1)


def kb8_unproject(params: torch.Tensor, uv: torch.Tensor,
                  iters: int = 10) -> torch.Tensor:
    """Pixels -> z=1 rays via Newton inversion of the theta polynomial."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k = params[4:8]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    d = torch.sqrt(mx * mx + my * my)
    d_clip = torch.clamp(d, max=math.pi / 2.0 * 1.5)
    theta = d_clip
    for _ in range(iters):
        t2 = theta * theta
        f = _kb8_theta_poly(k, theta) - d_clip
        fp = 1.0 + t2 * (3.0 * k[0] + t2 * (5.0 * k[1]
                                            + t2 * (7.0 * k[2] + 9.0 * t2 * k[3])))
        theta = theta - f / torch.where(torch.abs(fp) < 1e-9, torch.ones_like(fp), fp)
    scale = torch.where(d < 1e-9, torch.ones_like(d),
                        torch.tan(theta) / torch.clamp(d, min=1e-12))
    return torch.stack([mx * scale, my * scale, torch.ones_like(mx)], dim=-1)


def kb8_project_jac(params: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """d(uv)/d(xc) for KB8 by forward-mode autodiff of the projection."""
    flat = xc.reshape(-1, 3)
    jac = torch.func.vmap(torch.func.jacfwd(lambda p: kb8_project(params, p)))(flat)
    return jac.reshape(xc.shape[:-1] + (2, 3))
