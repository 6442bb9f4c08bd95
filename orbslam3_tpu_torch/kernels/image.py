"""Image-space stages: Gaussian blur, pyramid, pyramid atlas.

Port of `orbslam3_tpu/kernels/image.py`. The atlas keeps the reference's
layout exactly (levels stacked with 8 zero rows between them, width rounded
up to 128), because keypoint coordinates and the patch kernel's image are
defined on it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

DEFAULT_SCALE = 1.2
DEFAULT_LEVELS = 8

ATLAS_GAP = 8     # zero rows between levels (isolates blur/NMS across seams)
ATLAS_MARGIN = 17 # no keypoints within this distance of a level edge


def _gaussian_taps(sigma: float, radius: int) -> list[float]:
    kv = np.arange(-radius, radius + 1, dtype=np.float64)
    kv = np.exp(-0.5 * (kv / sigma) ** 2)
    return [float(c) for c in (kv / kv.sum()).astype(np.float32)]


def gaussian_blur(img: torch.Tensor, sigma: float = 2.0,
                  radius: int = 3) -> torch.Tensor:
    """Separable Gaussian blur of an (H, W) image with zero padding.

    Shifted multiply-adds in the reference's order (rows, then columns), so
    the f32 sums round as the reference's do.
    """
    h, w = img.shape
    P = F.pad(img, (radius, radius, radius, radius))
    rowacc = torch.zeros((h + 2 * radius, w), dtype=img.dtype, device=img.device)
    for i, c in enumerate(_gaussian_taps(sigma, radius)):
        rowacc = rowacc + c * P[:, i:i + w]
    out = torch.zeros((h, w), dtype=img.dtype, device=img.device)
    for i, c in enumerate(_gaussian_taps(sigma, radius)):
        out = out + c * rowacc[i:i + h, :]
    return out


def pyramid_shapes(h: int, w: int, n_levels: int = DEFAULT_LEVELS,
                   scale: float = DEFAULT_SCALE):
    """Per-level (h, w) sizes, mirroring mvScaleFactor construction."""
    shapes = []
    for lvl in range(n_levels):
        s = 1.0 / (scale ** lvl)
        shapes.append((max(8, int(round(h * s))), max(8, int(round(w * s)))))
    return shapes


def build_pyramid(img: torch.Tensor, n_levels: int = DEFAULT_LEVELS,
                  scale: float = DEFAULT_SCALE) -> list[torch.Tensor]:
    """(H, W) image -> list of per-level images.

    Antialiased bilinear resize, like the reference's `jax.image.resize(...,
    "bilinear")`: both stretch the triangle filter by the downscale factor
    and renormalise its weights. They differ in summation order, so levels
    above 0 agree to float rounding, not bit for bit.
    """
    h, w = img.shape
    levels = [img]
    for lh, lw in pyramid_shapes(h, w, n_levels, scale)[1:]:
        levels.append(F.interpolate(img[None, None], size=(lh, lw),
                                    mode="bilinear", align_corners=False,
                                    antialias=True)[0, 0])
    return levels


def atlas_layout(h: int, w: int, n_levels: int = DEFAULT_LEVELS,
                 scale: float = DEFAULT_SCALE):
    """Static packing: returns ((y0, lh, lw) per level, atlas_h, atlas_w)."""
    shapes = pyramid_shapes(h, w, n_levels, scale)
    rows = []
    y = 0
    for lh, lw in shapes:
        rows.append((y, lh, lw))
        y += lh + ATLAS_GAP
    ah = -(-(y - ATLAS_GAP) // 8) * 8
    aw = -(-w // 128) * 128
    return tuple(rows), ah, aw


def build_atlas(img: torch.Tensor, n_levels: int = DEFAULT_LEVELS,
                scale: float = DEFAULT_SCALE) -> torch.Tensor:
    """(H, W) image -> (AH, AW) pyramid atlas (levels stacked with gaps)."""
    h, w = img.shape
    rows, ah, aw = atlas_layout(h, w, n_levels, scale)
    atlas = torch.zeros((ah, aw), dtype=img.dtype, device=img.device)
    for lvl_img, (y0, lh, lw) in zip(build_pyramid(img, n_levels, scale), rows):
        atlas[y0:y0 + lh, :lw] = lvl_img
    return atlas
