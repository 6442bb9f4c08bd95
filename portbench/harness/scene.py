"""A textured box rendered on the card: the frames of the replay traffic.

Frozen copy of `orbslam3_tpu_torch/datasets/render.py` (`make_texture`'s
"blobs" family with its OpenCV-rule cubic and nearest resizes, and
`BoxScene.render`: per-pixel ray against the box's six faces, then the
texture's bilinear remap rounded to uint8, then Gaussian pixel noise; with
rad-tan distortion, the rays of `_camera_rays`: each pixel undistorted by
`core/camera.py`'s eight fixed-point steps in float32). The
textures are made on the host with numpy, as there; the rays, the
intersections and the remap run in torch on any device, in float64 for
the geometry and float32 for the remap, as the numpy version computes
them. Only the noise differs: it comes from a `torch.Generator` on the
device instead of numpy's.
"""

from __future__ import annotations

import numpy as np
import torch

BOX = ((-8.0, 8.0), (-5.0, 5.0), (-4.0, 14.0))  # render.py: BoxScene.default's box


def _cubic_weights(x: np.ndarray) -> np.ndarray:
    A = -0.75
    c0 = ((A * (x + 1) - 5 * A) * (x + 1) + 8 * A) * (x + 1) - 4 * A
    c1 = ((A + 2) * x - (A + 3)) * x * x + 1
    c2 = ((A + 2) * (1 - x) - (A + 3)) * (1 - x) * (1 - x) + 1
    return np.stack([c0, c1, c2, 1.0 - c0 - c1 - c2], axis=-1).astype(np.float32)


def _cubic_axis(n_src: int, n_dst: int):
    fx = (np.arange(n_dst) + 0.5) * (n_src / n_dst) - 0.5
    sx = np.floor(fx)
    idx = np.clip(sx[:, None].astype(np.int64) + np.arange(-1, 3), 0, n_src - 1)
    return idx, _cubic_weights((fx - sx).astype(np.float32))


def resize_cubic(img: np.ndarray, size: int) -> np.ndarray:
    iy, wy = _cubic_axis(img.shape[0], size)
    ix, wx = _cubic_axis(img.shape[1], size)
    rows = np.einsum("ykx,yk->yx", img[iy], wy)
    return np.einsum("ysk,sk->ys", rows[:, ix], wx).astype(np.float32)


def resize_nearest(img: np.ndarray, size: int) -> np.ndarray:
    iy = np.minimum(np.floor(np.arange(size) * (img.shape[0] / size)).astype(np.int64),
                    img.shape[0] - 1)
    ix = np.minimum(np.floor(np.arange(size) * (img.shape[1] / size)).astype(np.int64),
                    img.shape[1] - 1)
    return img[iy[:, None], ix[None, :]]


def make_texture(size: int, seed: int, n_blobs: int = 350) -> np.ndarray:
    """render.py's `make_texture(size, seed, n_blobs, family="blobs")`."""
    rng = np.random.default_rng(seed)
    tex = np.zeros((size, size), np.float32)
    for scale, amp in ((8, 40.0), (32, 30.0), (128, 25.0)):
        small = rng.uniform(-1, 1, (scale, scale)).astype(np.float32)
        tex += amp * resize_cubic(small, size)
    tex += 128.0
    for _ in range(n_blobs):
        s = int(rng.integers(8, 28))
        x = int(rng.integers(0, size - s))
        y = int(rng.integers(0, size - s))
        cells = int(rng.integers(2, 5))
        patch = rng.uniform(0, 255, (cells, cells)).astype(np.float32)
        patch = resize_nearest(patch, s)
        tex[y:y + s, x:x + s] = 0.3 * tex[y:y + s, x:x + s] + 0.7 * patch
    return np.clip(tex, 0, 255).astype(np.uint8)


def box_textures(scene_seed: int, size: int = 1024) -> np.ndarray:
    """(6, size, size) uint8: BoxScene.default(seed)'s faces x-, x+, y-, y+,
    z-, z+ (texture seeds seed * 13 + face)."""
    return np.stack([make_texture(size, seed=scene_seed * 13 + f) for f in range(6)])


def camera_rays(intrinsics, dist, width: int, height: int, device) -> torch.Tensor:
    """(height, width, 3) float64 camera-frame rays (z = 1) of the pixel
    centres: through the ideal pinhole (fx, fy, cx, cy), or with rad-tan
    `dist` (k1, k2, p1, p2[, k3]) undistorted by the fixed-point inverse."""
    fx, fy, cx, cy = (float(v) for v in intrinsics)
    v, u = torch.meshgrid(torch.arange(height, dtype=torch.float64, device=device),
                          torch.arange(width, dtype=torch.float64, device=device),
                          indexing="ij")
    k = [float(x) for x in dist] + [0.0] * (5 - len(dist))
    if not any(k):
        return torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], -1)
    k1, k2, p1, p2, k3 = k
    xd = ((u.float() - cx) / fx, (v.float() - cy) / fy)
    x, y = xd
    for _ in range(8):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = (xd[0] - dx) / radial, (xd[1] - dy) / radial
    return torch.stack([x.double(), y.double(), torch.ones_like(u)], -1)


def render(textures: torch.Tensor, intrinsics, R_cw: torch.Tensor, t_cw: torch.Tensor,
           width: int, height: int, noise_std: float = 1.5,
           generator: torch.Generator | None = None, dist=()) -> torch.Tensor:
    """(B, height, width) uint8 views of the box from world->camera poses
    R_cw (B,3,3) and t_cw (B,3) (float64), through a pinhole (fx, fy, cx,
    cy) with rad-tan `dist` (none: ideal), on the textures' device. Pixel
    centres sit at integer coordinates, as the extractor's keypoints."""
    dev = textures.device
    lo = torch.tensor([b[0] for b in BOX], dtype=torch.float64, device=dev)
    hi = torch.tensor([b[1] for b in BOX], dtype=torch.float64, device=dev)
    d_c = camera_rays(intrinsics, dist, width, height, dev)                   # (H,W,3)
    R_wc = R_cw.transpose(1, 2)
    o = -torch.einsum("bij,bj->bi", R_wc, t_cw)                               # (B,3)
    d_w = torch.einsum("hwj,bij->bhwi", d_c, R_wc)                            # (B,H,W,3)
    B = R_cw.shape[0]
    best_t = torch.full((B, height, width), float("inf"), dtype=torch.float64, device=dev)
    out = torch.zeros((B, height, width), dtype=torch.float32, device=dev)
    tex_f = textures.float()
    S = textures.shape[-1]
    faces = [(0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (2, 1)]
    eps = 1e-6
    for f, (axis, side) in enumerate(faces):
        val = (lo if side == 0 else hi)[axis]
        denom = d_w[..., axis]
        t = (val - o[:, axis, None, None]) / denom
        hitp = o[:, None, None, :] + t[..., None] * d_w
        a1, a2 = [a for a in range(3) if a != axis]
        ok = (denom.abs() > 1e-12) & (t > 1e-3) & (t < best_t)
        ok &= (hitp[..., a1] >= lo[a1] - eps) & (hitp[..., a1] <= hi[a1] + eps)
        ok &= (hitp[..., a2] >= lo[a2] - eps) & (hitp[..., a2] <= hi[a2] + eps)
        tu = (hitp[..., a1] - lo[a1]) / (hi[a1] - lo[a1])
        tv = (hitp[..., a2] - lo[a2]) / (hi[a2] - lo[a2])
        mx = torch.nan_to_num(tu * (S - 1)).clamp(0, S - 1.001).float()
        my = torch.nan_to_num(tv * (S - 1)).clamp(0, S - 1.001).float()
        x0, y0 = mx.floor(), my.floor()
        ax, ay = mx - x0, my - y0
        x0, y0 = x0.long(), y0.long()
        x1, y1 = (x0 + 1).clamp(max=S - 1), (y0 + 1).clamp(max=S - 1)
        tx = tex_f[f]
        top = tx[y0, x0] * (1 - ax) + tx[y0, x1] * ax
        bot = tx[y1, x0] * (1 - ax) + tx[y1, x1] * ax
        samp = torch.round(top * (1 - ay) + bot * ay).clamp(0, 255)
        out = torch.where(ok, samp, out)
        best_t = torch.where(ok, t, best_t)
    if noise_std > 0:
        out = out + noise_std * torch.randn(out.shape, generator=generator, device=dev,
                                            dtype=torch.float32)
    return out.clamp(0, 255).to(torch.uint8)
