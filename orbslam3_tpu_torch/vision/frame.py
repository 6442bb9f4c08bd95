"""Frame feature extraction: image -> fixed-capacity ORB features.

Port of `orbslam3_tpu/vision/frame.py` (`FrameFeatures`, `level_quotas`,
`extract_features`): pyramid atlas, dual-threshold dense FAST + 3x3 NMS,
per-level uniform selection, sub-pixel fit, intensity-centroid
orientation, Gaussian blur and steered BRIEF through kernel K2; and the
edge server's wire features (`features_from_wire`, `features_from_arrays`)
and `undistort`.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from orbslam3_tpu_torch import device as device_policy
from orbslam3_tpu_torch.kernels import fast as fast_k
from orbslam3_tpu_torch.kernels import image as image_k
from orbslam3_tpu_torch.kernels import orb_descriptor as desc_k


@dataclasses.dataclass
class FrameFeatures:
    """Padded per-frame feature set (capacity N = requested nfeatures)."""

    uv: torch.Tensor        # (N, 2) float32 level-0 pixel coords
    uv_raw: torch.Tensor    # (N, 2) float32 raw (distorted) coords
    response: torch.Tensor  # (N,) float32
    angle: torch.Tensor     # (N,) float32 radians
    octave: torch.Tensor    # (N,) int32 pyramid level
    desc: torch.Tensor      # (N, 8) int32 packed 256-bit descriptors
    valid: torch.Tensor     # (N,) bool

    @property
    def capacity(self) -> int:
        return self.uv.shape[0]


def level_quotas(n_features: int, n_levels: int, scale: float) -> Sequence[int]:
    """Per-level feature budget (geometric split, f = 1/scale)."""
    f = 1.0 / scale
    total = (1.0 - f ** n_levels) / (1.0 - f)
    quotas = [int(round(n_features * (f ** l) / total)) for l in range(n_levels)]
    quotas[-1] += n_features - sum(quotas)
    return quotas


def extract_features(
    img,  # (H, W) grayscale in [0, 255]: tensor or numpy array
    n_features: int = 1000,
    n_levels: int = image_k.DEFAULT_LEVELS,
    scale: float = image_k.DEFAULT_SCALE,
    cell: int = 32,
    ini_th: float = fast_k.INI_TH,
    min_th: float = fast_k.MIN_TH,
    device=None,
) -> FrameFeatures:
    """Full ORB extraction on `device` (the card unless ``device="cpu"``).

    All levels are packed into one atlas, so FAST, NMS, the moment maps and
    the blur each run once; keypoints of all levels go through orientation
    and BRIEF in one batch. ATLAS_MARGIN keeps every patch read inside its
    level.
    """
    dev = device_policy.resolve(device)
    if isinstance(img, np.ndarray):
        img = torch.from_numpy(img)
    img = img.to(device=dev, dtype=torch.float32)
    h, w = img.shape
    quotas = level_quotas(n_features, n_levels, scale)
    rows, ah, aw = image_k.atlas_layout(h, w, n_levels, scale)
    margin = image_k.ATLAS_MARGIN

    atlas = image_k.build_atlas(img, n_levels, scale)
    score, raw_score = fast_k.detect_with_raw(atlas, ini_th, min_th)

    ys_parts, xs_parts, y0_parts, sx_parts, sy_parts = [], [], [], [], []
    resps, octs, valids = [], [], []
    for lvl, ((y0, lh, lw), quota) in enumerate(zip(rows, quotas)):
        if quota <= 0:
            continue
        s_lvl = torch.zeros((lh, lw), dtype=score.dtype, device=dev)
        s_lvl[margin:lh - margin, margin:lw - margin] = \
            score[y0 + margin:y0 + lh - margin, margin:lw - margin]
        ys, xs, resp, valid = fast_k.select_uniform(s_lvl, quota, cell=cell)
        if ys.shape[0] < quota:
            # a level with fewer than `quota` slots (4 per cell): pad with
            # invalid rows at an interior pixel, so the capacity stays
            # n_features and every level keeps the reference's layout
            pad = quota - ys.shape[0]
            ys = torch.cat([ys, ys.new_full((pad,), margin)])
            xs = torch.cat([xs, xs.new_full((pad,), margin)])
            resp = torch.cat([resp, resp.new_zeros(pad)])
            valid = torch.cat([valid, valid.new_zeros(pad)])
        k = quota
        # level -> level-0: the resize is centre-aligned with the true ratio
        # w/lw, so x0 = (x + 0.5) * (w/lw) - 0.5
        ys_parts.append(ys + y0)  # atlas coords
        xs_parts.append(xs)
        y0_parts.append(torch.full((k,), y0, dtype=torch.int64, device=dev))
        sx_parts.append(torch.full((k,), w / lw, dtype=torch.float32, device=dev))
        sy_parts.append(torch.full((k,), h / lh, dtype=torch.float32, device=dev))
        resps.append(resp)
        octs.append(torch.full((k,), lvl, dtype=torch.int32, device=dev))
        valids.append(valid)

    ys_a = torch.cat(ys_parts)
    xs_a = torch.cat(xs_parts)
    sx = torch.cat(sx_parts)
    sy = torch.cat(sy_parts)
    dy_sp, dx_sp = fast_k.subpixel_offsets(raw_score, ys_a, xs_a)
    y_lvl = (ys_a - torch.cat(y0_parts)).float()
    uv = torch.stack([(xs_a.float() + dx_sp + 0.5) * sx - 0.5,
                      (y_lvl + dy_sp + 0.5) * sy - 0.5], dim=-1)

    m10, m01 = desc_k.orientation_maps(atlas)
    flat_idx = ys_a * aw + xs_a
    ang = torch.atan2(m01.reshape(-1)[flat_idx], m10.reshape(-1)[flat_idx])

    blurred = image_k.gaussian_blur(atlas)
    desc = desc_k.brief_descriptors(blurred, ys_a, xs_a, ang)

    return FrameFeatures(uv=uv, uv_raw=uv, response=torch.cat(resps), angle=ang,
                         octave=torch.cat(octs), desc=desc, valid=torch.cat(valids))


def undistort(features: FrameFeatures, camera) -> FrameFeatures:
    """Undistort the keypoints (ORB-SLAM3's `Frame::UndistortKeyPoints`):
    `uv` from `uv_raw` through the camera's rad-tan model; a KB8 camera
    keeps the raw coordinates (its distortion stays in the projection)."""
    return dataclasses.replace(features, uv=camera.undistort_points(features.uv_raw))


def features_from_wire(uv: np.ndarray, desc: np.ndarray, n_capacity: int,
                       device=None) -> FrameFeatures:
    """`FrameFeatures` from an edge client's (n, 2) keypoints and (n, 8)
    uint32 packed descriptors (the fork's frame-from-wire constructor),
    padded or clipped to `n_capacity`, on `device` (the card unless
    ``device="cpu"``). The uint32 words become the port's int32 words bit
    for bit (reinterpreted, never cast by value). Octave, angle and
    response are 0, as the wire carries none."""
    dev = device_policy.resolve(device)
    uv = torch.from_numpy(np.asarray(uv, np.float32))
    d = np.ascontiguousarray(desc)
    if d.dtype != np.uint32:
        raise TypeError(f"features_from_wire: descriptors of dtype {d.dtype}, not uint32")
    words = torch.from_numpy(d.view(np.int32))
    m = min(uv.shape[0], n_capacity)
    uv_p = torch.zeros((n_capacity, 2), dtype=torch.float32)
    uv_p[:m] = uv[:m]
    d_p = torch.zeros((n_capacity, 8), dtype=torch.int32)
    d_p[:m] = words[:m]
    uv_p, d_p = uv_p.to(dev), d_p.to(dev)
    return FrameFeatures(
        uv=uv_p, uv_raw=uv_p, response=torch.zeros(n_capacity, device=dev),
        angle=torch.zeros(n_capacity, device=dev),
        octave=torch.zeros(n_capacity, dtype=torch.int32, device=dev), desc=d_p,
        valid=torch.arange(n_capacity, device=dev) < m)


def features_from_arrays(uv: np.ndarray, desc_bytes: np.ndarray, capacity: int,
                         device=None) -> FrameFeatures:
    """Wire-format adapter: (n, 32) uint8 ORB descriptors (the SlamPktVI
    layout) -> packed (n, 8) little-endian 32-bit words -> padded
    `FrameFeatures`."""
    d = np.ascontiguousarray(np.asarray(desc_bytes, np.uint8))
    packed = d.view('<u4').reshape(d.shape[0], 8)
    return features_from_wire(np.asarray(uv), packed, capacity, device=device)


def wire_arrays(features: FrameFeatures) -> tuple[np.ndarray, np.ndarray]:
    """A phone's side of `features_from_arrays`: the valid features' (n, 2)
    float32 coordinates and (n, 32) uint8 descriptor bytes (each int32
    word written little-endian, bit for bit), as `encode_frame` takes
    them."""
    valid = features.valid.cpu().numpy()
    uv = features.uv.cpu().numpy()[valid]
    words = np.ascontiguousarray(features.desc.cpu().numpy()[valid])
    return uv, words.astype('<i4', copy=False).view(np.uint8).reshape(-1, 32)
