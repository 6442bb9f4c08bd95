"""Keypoint orientation + steered BRIEF (rBRIEF) descriptors.

Port of `orbslam3_tpu/kernels/orb_descriptor.py`. The BRIEF pattern is the
reference's seeded numpy pattern, copied here, and gives the same 256 test
pairs bit for bit.

One change of formulation, exact in f32: the reference takes each
keypoint's bf16-rounded 32x32 patch times a (1024, 64*256) one-hot +/-1
matrix (`_bin_weight_matrix`) to get every pair's sample difference under
all 64 rotation bins, then blends the two bins that bracket the angle. Each
column of that matrix picks two pixels, so the port gathers those two
pixels for the two bins it needs (`_bin_pair_index`) and subtracts. The
differences of two bf16 values are exact in f32 either way, and the blend
is the same two products and one sum; the 33 MB matrix and its product over
62 unused bins are not needed. The patches come from kernel K2
(`kernels/patch.py`).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from orbslam3_tpu_torch.kernels import patch

HALF_PATCH = 15  # orientation patch radius (reference HALF_PATCH_SIZE)
PATTERN_SIGMA = 13.0 / 2.5  # BRIEF pair spread; coords clipped to |r|<=13
PATTERN_SEED = 31
N_BITS = 256
PATCH_R = 16  # patch half-size: rotated pattern radius <= 13 + rounding < 16
N_ANGLE_BINS = 64  # rotated-pattern bins; adjacent bins are angle-interpolated


def _make_pattern(seed: int = PATTERN_SEED) -> np.ndarray:
    """Deterministic 256x4 (y1,x1,y2,x2) BRIEF test pattern: isotropic
    Gaussian pairs clipped to radius 13."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(scale=PATTERN_SIGMA, size=(N_BITS, 2, 2))
    norms = np.linalg.norm(pts, axis=-1, keepdims=True)
    too_far = norms > 13.0
    pts = np.where(too_far, pts * (13.0 / norms), pts)
    return np.round(pts).astype(np.float32).reshape(N_BITS, 4)


PATTERN = _make_pattern()  # (256, 4) = (y1, x1, y2, x2)


def _bin_pair_index() -> tuple[np.ndarray, np.ndarray]:
    """(64, 256) flat patch indices of each pair's first and second sample,
    with the pattern rotated by each bin's angle (row-major 32x32 patch)."""
    pat = _make_pattern()
    half = PATCH_R
    lins = []
    for yy, xx in ((pat[:, 0], pat[:, 1]), (pat[:, 2], pat[:, 3])):
        lin = np.zeros((N_ANGLE_BINS, N_BITS), np.int64)
        for b in range(N_ANGLE_BINS):
            a = 2 * np.pi * b / N_ANGLE_BINS
            ca, sa = np.cos(a), np.sin(a)
            ry = np.clip(np.round(sa * xx + ca * yy), -half, half - 1).astype(np.int64)
            rx = np.clip(np.round(ca * xx - sa * yy), -half, half - 1).astype(np.int64)
            lin[b] = (ry + half) * (2 * half) + (rx + half)
        lins.append(lin)
    return lins[0], lins[1]


def _bin_weight_matrix() -> np.ndarray:
    """(1024, N_BINS*256): column (b*256+k) is onehot(p2_rot(b)) -
    onehot(p1_rot(b)) of pair k over the flattened 32x32 patch — the
    reference's matrix, which the port's two-pixel gather replaces."""
    lin1, lin2 = _bin_pair_index()
    W = np.zeros((N_ANGLE_BINS, 4 * PATCH_R * PATCH_R, N_BITS), np.float32)
    b = np.arange(N_ANGLE_BINS)[:, None]
    k = np.arange(N_BITS)[None, :]
    np.add.at(W, (b, lin1, k), -1.0)
    np.add.at(W, (b, lin2, k), 1.0)
    return W.transpose(1, 0, 2).reshape(4 * PATCH_R * PATCH_R, N_ANGLE_BINS * N_BITS)


@functools.cache
def _pair_index_tensors(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    lin1, lin2 = _bin_pair_index()
    return torch.from_numpy(lin1).to(device), torch.from_numpy(lin2).to(device)


def orientation_maps(img: torch.Tensor):
    """Dense (m10, m01) circular-patch moment maps.

    m10(y,x) = sum_{dy,dx in circle} dx * I(y+dy, x+dx), m01 likewise with
    dy; each circle row is a box sum from x-prefix-sums of I and x*I, in the
    reference's order of operations.
    """
    h, w = img.shape
    R = HALF_PATCH
    P = F.pad(img, (R, R, R, R))
    wp = w + 2 * R
    c = wp * 0.5  # centred column coordinate keeps the prefix sums small
    u = torch.arange(wp, dtype=img.dtype, device=img.device) - c
    S = F.pad(torch.cumsum(P, dim=1), (1, 0))
    T = F.pad(torch.cumsum(P * u[None, :], dim=1), (1, 0))
    xs = torch.arange(w, dtype=img.dtype, device=img.device) + R - c
    m10 = torch.zeros((h, w), dtype=img.dtype, device=img.device)
    m01 = torch.zeros((h, w), dtype=img.dtype, device=img.device)
    for dy in range(-R, R + 1):
        ww = int(math.floor(math.sqrt(R * R - dy * dy)))
        rowS = S[R + dy:R + dy + h]
        rowT = T[R + dy:R + dy + h]
        bS = rowS[:, R + ww + 1:R + ww + 1 + w] - rowS[:, R - ww:R - ww + w]
        bT = rowT[:, R + ww + 1:R + ww + 1 + w] - rowT[:, R - ww:R - ww + w]
        m10 = m10 + (bT - xs[None, :] * bS)
        m01 = m01 + dy * bS
    return m10, m01


def brief_descriptors(blurred: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                      angles: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF: (N, 8) int32 packed 256-bit descriptors.

    blurred: (H, W) Gaussian-blurred image; ys, xs: (N,) keypoint pixels;
    angles: (N,) radians. The two rotation bins bracketing each angle are
    blended linearly; bit k is set where the blended difference is > 0.
    """
    h, w = blurred.shape
    n = ys.shape[0]
    half = PATCH_R
    y0 = torch.clamp(ys - half, 0, h - 2 * half).to(torch.int32)
    x0 = torch.clamp(xs - half, 0, w - 2 * half).to(torch.int32)
    patches = patch.gather_patches(blurred, y0, x0)
    pf = patches.reshape(n, 4 * half * half).to(torch.bfloat16).float()
    lin1, lin2 = _pair_index_tensors(blurred.device)

    def pair_diffs(b):  # (n, 256) sample differences under bin b
        return pf.gather(1, lin2[b]) - pf.gather(1, lin1[b])

    bpos = (angles / (2.0 * np.pi)) * N_ANGLE_BINS
    fl = torch.floor(bpos)
    b0 = fl.long() % N_ANGLE_BINS
    frac = (bpos - fl)[:, None]
    v = pair_diffs(b0) * (1.0 - frac) + pair_diffs((b0 + 1) % N_ANGLE_BINS) * frac
    return pack_bits(v > 0)


@functools.cache
def _bit_weights(device: torch.device) -> torch.Tensor:
    """(32,) int64 weight of each bit of an int32 word: 2^b, and -2^31 for
    the sign bit, so a weighted sum of bits is the word's two's-complement
    value, exact in int64."""
    w = torch.tensor([1 << b for b in range(31)] + [-(1 << 31)], dtype=torch.int64)
    return w.to(device)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, 256) {0,1} -> (N, 8) int32 (bit b of word w = bit 32*w+b).

    The words are the reference's uint32 words reinterpreted as int32."""
    n = bits.shape[0]
    s = torch.sum(bits.reshape(n, 8, 32) * _bit_weights(bits.device), dim=-1)
    return s.to(torch.int32)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 -> (N, 256) {0,1} uint8."""
    n = packed.shape[0]
    shifts = torch.arange(32, device=packed.device)
    bits = ((packed.long() & 0xFFFFFFFF)[:, :, None] >> shifts) & 1
    return bits.reshape(n, 256).to(torch.uint8)


def descriptor_planes(packed: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 -> (N, 256) float32 in {-1, +1}."""
    return unpack_bits(packed).float() * 2.0 - 1.0
