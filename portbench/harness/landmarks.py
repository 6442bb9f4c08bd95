"""The phones' keypoints and descriptors: a landmark field seen along the
path, as the edge cell's packets carry them.

Frozen copy of `orbslam3_tpu_torch/utils/synth.py` (`make_world` and
`render_features`): a persistent field of landmarks in a box, each with a
256-bit descriptor (here as 32 bytes, the SlamPktVI layout); per frame the
landmarks in front of the camera (depth > 0.3 m) that project inside an
8-pixel margin, each dropped with probability `dropout`, shuffled, the
first `capacity - distractors` kept, with Gaussian pixel noise of
`noise_px` and `bit_flips` random bit flips (with replacement, as there),
then `distractors` uniform keypoints with random descriptors. It runs in
torch on the card for all frames at once, with its draws from a
`torch.Generator`, where the original draws from numpy per frame. The
pinhole projects, through rad-tan `dist` where one is given, so the
keypoints are raw (distorted) pixels as a phone's extractor finds them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

FIELD_BOX = ((-8.0, 8.0), (-5.0, 5.0), (2.0, 14.0))  # synth.py: make_world's box


@dataclasses.dataclass
class Field:
    points: np.ndarray   # (P,3) float64
    desc: np.ndarray     # (P,32) uint8


def make_field(n_points: int, seed: int) -> Field:
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(*FIELD_BOX[i], n_points) for i in range(3)], axis=-1)
    bits = rng.integers(0, 2, (n_points, 256)).astype(np.uint8)
    return Field(points=pts, desc=np.packbits(bits, axis=1, bitorder="little"))


def frame_features(field: Field, R_cw: np.ndarray, t_cw: np.ndarray, intrinsics,
                   width: int, height: int, capacity: int, noise_px: float,
                   bit_flips: int, dropout: float, distractors: int,
                   generator: torch.Generator, device, chunk: int = 32, dist=()):
    """For F poses: uv (F, capacity, 2) float32, desc (F, capacity, 32)
    uint8 and count (F,) int64, on the host. Row i of a frame holds its
    i-th feature; the first count - distractors are landmarks in random
    order, the last `distractors` of the count are distractors (rows past
    the count are unused). A frame sent at a smaller budget b keeps its
    first b - distractors landmarks and its distractors."""
    fx, fy, cx, cy = (float(v) for v in intrinsics)
    pts = torch.as_tensor(field.points, dtype=torch.float64, device=device)
    desc = torch.as_tensor(field.desc, device=device)
    keep = capacity - distractors
    F = len(R_cw)
    uv_out = np.zeros((F, capacity, 2), np.float32)
    desc_out = np.zeros((F, capacity, 32), np.uint8)
    count = np.zeros(F, np.int64)
    bit = (1 << torch.arange(8, device=device)).to(torch.uint8)
    for s in range(0, F, chunk):
        R = torch.as_tensor(R_cw[s:s + chunk], dtype=torch.float64, device=device)
        t = torch.as_tensor(t_cw[s:s + chunk], dtype=torch.float64, device=device)
        B = R.shape[0]
        xc = torch.einsum("pj,bij->bpi", pts, R) + t[:, None, :]
        z = xc[..., 2]
        x, y = xc[..., 0] / z, xc[..., 1] / z
        k = [float(c) for c in dist] + [0.0] * (5 - len(dist))
        if any(k):
            k1, k2, p1, p2, k3 = k
            r2 = x * x + y * y
            radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
            x, y = (x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x),
                    y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y)
        u = fx * x + cx
        v = fy * y + cy
        vis = (z > 0.3) & (u >= 8) & (u < width - 8) & (v >= 8) & (v < height - 8)
        vis &= torch.rand(vis.shape, generator=generator, device=device,
                          dtype=torch.float64) > dropout
        key = torch.rand(vis.shape, generator=generator, device=device, dtype=torch.float64)
        key = torch.where(vis, key, key + 2.0)
        ids = torch.argsort(key, dim=1)[:, :keep]
        n_obs = vis.sum(1).clamp(max=keep)
        uv = torch.stack([u.gather(1, ids), v.gather(1, ids)], -1)
        uv = uv + noise_px * torch.randn(uv.shape, generator=generator, device=device,
                                         dtype=torch.float64)
        d = desc[ids]                                                   # (B,keep,32)
        pos = torch.randint(0, 256, (B, keep, bit_flips), generator=generator, device=device)
        flip = torch.zeros((B, keep, 256), dtype=torch.int64, device=device)
        flip.scatter_add_(2, pos, torch.ones_like(pos))
        flip = (flip % 2).to(torch.uint8).view(B, keep, 32, 8)
        d = d ^ (flip * bit).sum(-1, dtype=torch.uint8)
        du = torch.rand((B, distractors, 2), generator=generator, device=device,
                        dtype=torch.float64) * torch.tensor([width, height], device=device)
        dd = torch.randint(0, 256, (B, distractors, 32), generator=generator, device=device,
                           dtype=torch.uint8)
        uv_h, d_h, n_h = uv.float().cpu().numpy(), d.cpu().numpy(), n_obs.cpu().numpy()
        du_h, dd_h = du.float().cpu().numpy(), dd.cpu().numpy()
        for b in range(B):
            n = int(n_h[b])
            f = s + b
            uv_out[f, :n], desc_out[f, :n] = uv_h[b, :n], d_h[b, :n]
            uv_out[f, n:n + distractors], desc_out[f, n:n + distractors] = du_h[b], dd_h[b]
            count[f] = n + distractors
    return uv_out, desc_out, count


def packet_arrays(uv, desc, count, f: int, budget: int, distractors: int):
    """Frame f's (uv, desc) at a feature budget: its first budget -
    distractors landmarks and its distractors."""
    n = int(count[f])
    n_obs = n - distractors
    take = min(n_obs, budget - distractors)
    rows = np.r_[0:take, n_obs:n]
    return uv[f, rows], desc[f, rows]
