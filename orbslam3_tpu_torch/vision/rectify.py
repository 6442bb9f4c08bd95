"""Pinhole stereo rectification: precomputed inverse maps + a bilinear remap.

Port of `orbslam3_tpu/vision/rectify.py` (ORB-SLAM3's
`Settings::precomputeRectificationMaps`, i.e. `cv::stereoRectify` +
`cv::initUndistortRectifyMap`, and the per-frame `cv::remap` of
`System::TrackStereo`):

- the geometry solve and the (H, W, 2) source-coordinate maps are a
  one-time host precompute in double precision (numpy, copied from the
  reference);
- the per-frame work, two bilinear remaps ahead of feature extraction,
  runs as tensor ops on the maps' device. It is a gather in the reference
  too (no Pallas kernel), so the port has no kernel for it.

Geometry (`cv::stereoRectify` with CALIB_ZERO_DISPARITY): split the
inter-camera rotation evenly between the two views, rotate both so the
baseline lies along the image x axis, and give both views one ideal
pinhole, so that matching epipolar lines land on the same rows.
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam3_tpu_torch import device as device_policy


def _rodrigues(r: np.ndarray) -> np.ndarray:
    """Rotation vector -> matrix (host, double precision)."""
    th = float(np.linalg.norm(r))
    if th < 1e-12:
        return np.eye(3)
    k = r / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _rot_vec(R: np.ndarray) -> np.ndarray:
    """Matrix -> rotation vector."""
    c = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    th = np.arccos(c)
    if th < 1e-12:
        return np.zeros(3)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return th / (2.0 * np.sin(th)) * w


def _distort_radtan(x, y, dist):
    """Radial-tangential distortion of ideal normalized coords;
    dist = (k1, k2, p1, p2[, k3])."""
    k1, k2, p1, p2, k3 = (list(dist) + [0.0] * 5)[:5]
    r2 = x * x + y * y
    rad = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * rad + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * rad + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return xd, yd


def _undistort_points(pts, K, dist, iters=8):
    """Invert rad-tan distortion by fixed-point iteration -> ideal
    normalized coords."""
    x = (pts[:, 0] - K[0, 2]) / K[0, 0]
    y = (pts[:, 1] - K[1, 2]) / K[1, 1]
    x0, y0 = x.copy(), y.copy()
    for _ in range(iters):
        xd, yd = _distort_radtan(x, y, dist)
        x = x + (x0 - xd)
        y = y + (y0 - yd)
    return np.stack([x, y], -1)


def stereo_rectify(K1, d1, K2, d2, size, R12, t12):
    """Rectifying rotations and the shared projection.

    ``R12, t12`` map left-camera coords to the right (x_r = R12 x_l + t12),
    as the reference hands `cv::stereoRectify`. Returns (R1, R2, K_new,
    baseline): each camera's rectifying rotation (rectified <- raw), the
    shared pinhole intrinsics, and the metric baseline (bf = baseline *
    K_new[0, 0])."""
    K1 = np.asarray(K1, np.float64)
    K2 = np.asarray(K2, np.float64)
    R12 = np.asarray(R12, np.float64)
    t12 = np.asarray(t12, np.float64).reshape(3)
    nx, ny = int(size[0]), int(size[1])

    # split the rotation evenly between the two cameras
    r_half = _rodrigues(-0.5 * _rot_vec(R12))
    t = r_half @ t12
    # rotate both so the baseline is the x axis
    uu = np.array([1.0 if t[0] > 0 else -1.0, 0.0, 0.0])
    ww = np.cross(t, uu)
    nw = np.linalg.norm(ww)
    if nw > 1e-12:
        ww *= np.arccos(min(1.0, abs(t[0]) / np.linalg.norm(t))) / nw
    wR = _rodrigues(ww)
    R1 = wR @ r_half.T
    R2 = wR @ r_half
    baseline = abs((R2 @ t12)[0])

    # shared focal: the smaller y focal, shrunk for barrel distortion
    fc_new = np.inf
    for K, d in ((K1, d1), (K2, d2)):
        fc = K[1, 1]
        k1 = d[0] if len(d) else 0.0
        if k1 < 0:
            fc *= 1 + k1 * (nx * nx + ny * ny) / (4 * fc * fc)
        fc_new = min(fc_new, fc)

    # shared principal point: centre the rectified corner images
    cc = np.zeros((2, 2))
    corners = np.array([[0, 0], [nx - 1, 0], [0, ny - 1], [nx - 1, ny - 1]],
                       np.float64)
    for k, (K, d, Rr) in enumerate(((K1, d1, R1), (K2, d2, R2))):
        und = _undistort_points(corners, K, d)
        h = np.concatenate([und, np.ones((4, 1))], -1) @ Rr.T
        proj = fc_new * h[:, :2] / h[:, 2:3]
        cc[k, 0] = (nx - 1) / 2 - proj[:, 0].mean()
        cc[k, 1] = (ny - 1) / 2 - proj[:, 1].mean()
    cc_shared = cc.mean(axis=0)  # CALIB_ZERO_DISPARITY

    K_new = np.array([[fc_new, 0.0, cc_shared[0]],
                      [0.0, fc_new, cc_shared[1]],
                      [0.0, 0.0, 1.0]])
    return R1, R2, K_new, float(baseline)


def undistort_rectify_map(K, dist, R_rect, K_new, size):
    """(H, W, 2) float32 map of the source pixel of each rectified pixel
    (`cv::initUndistortRectifyMap`)."""
    K = np.asarray(K, np.float64)
    K_new = np.asarray(K_new, np.float64)
    nx, ny = int(size[0]), int(size[1])
    u, v = np.meshgrid(np.arange(nx, dtype=np.float64),
                       np.arange(ny, dtype=np.float64))
    x = (u - K_new[0, 2]) / K_new[0, 0]
    y = (v - K_new[1, 2]) / K_new[1, 1]
    h = np.stack([x, y, np.ones_like(x)], -1) @ R_rect  # R_rect^T applied
    xs = h[..., 0] / h[..., 2]
    ys = h[..., 1] / h[..., 2]
    xd, yd = _distort_radtan(xs, ys, dist)
    us = K[0, 0] * xd + K[0, 2]
    vs = K[1, 1] * yd + K[1, 2]
    return np.stack([us, vs], -1).astype(np.float32)


def remap_bilinear(img: torch.Tensor, src_map: torch.Tensor) -> torch.Tensor:
    """Sample `img` (H, W) at the (H', W', 2) source pixel coords of
    `src_map`, bilinearly from four taps; taps out of the image read 0
    (`cv::remap` with BORDER_CONSTANT). The result keeps `img`'s dtype
    (f32 images stay unrounded, as in the reference)."""
    H, W = img.shape
    u, v = src_map[..., 0], src_map[..., 1]
    u0, v0 = torch.floor(u), torch.floor(v)
    fu, fv = u - u0, v - v0
    u0i, v0i = u0.to(torch.int64), v0.to(torch.int64)
    flat = img.reshape(-1)

    def tap(vi, ui):
        ok = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
        val = flat[torch.clamp(vi, 0, H - 1) * W + torch.clamp(ui, 0, W - 1)]
        return torch.where(ok, val, 0.0)

    out = ((1 - fu) * (1 - fv) * tap(v0i, u0i)
           + fu * (1 - fv) * tap(v0i, u0i + 1)
           + (1 - fu) * fv * tap(v0i + 1, u0i)
           + fu * fv * tap(v0i + 1, u0i + 1))
    return out.to(img.dtype)


class RectifyMaps:
    """Stereo rectification state, built once from the calibration.

    The reference's M1l/M2l/M1r/M2r and updated calibration: ``K_new``
    replaces both cameras' intrinsics, ``bf`` is baseline * new focal, and
    ``R1`` turns camera 1's frame (the IMU extrinsic of stereo-inertial
    configs folds it in). The two maps live on `device` (the card unless
    ``device="cpu"``); each call remaps a raw pair there."""

    def __init__(self, K1, d1, K2, d2, size, R12, t12, device=None):
        R1, R2, K_new, baseline = stereo_rectify(K1, d1, K2, d2, size, R12, t12)
        self.R1, self.R2, self.K_new = R1, R2, K_new
        self.baseline = baseline
        self.bf = baseline * K_new[0, 0]
        self._host = (undistort_rectify_map(K1, d1, R1, K_new, size),
                      undistort_rectify_map(K2, d2, R2, K_new, size))
        self._place(device_policy.resolve(device))

    def _place(self, device: torch.device):
        self.device = device
        self.map_l, self.map_r = (torch.from_numpy(m).to(device) for m in self._host)

    def to(self, device) -> "RectifyMaps":
        """The same rectification with its maps on `device` (self if they
        are there already)."""
        device = torch.device(device)
        if device == self.device:
            return self
        out = object.__new__(RectifyMaps)
        out.__dict__.update({k: v for k, v in self.__dict__.items()
                             if k not in ("map_l", "map_r", "device")})
        out._place(device)
        return out

    def __call__(self, img_l, img_r):
        """The rectified (H, W) float32 pair on the maps' device."""
        def as_img(x):
            return torch.as_tensor(x, dtype=torch.float32, device=self.device)
        return (remap_bilinear(as_img(img_l), self.map_l),
                remap_bilinear(as_img(img_r), self.map_r))
