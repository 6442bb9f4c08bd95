"""Peaks of the card and the least work of the port's two CUDA kernels.

Frozen copies of `chip_smoke.py`'s `bound_ms`, `k1_bound` and `k2_times`'
byte count: each input read once and each output written once, over HBM
bandwidth, against the allowed pairs as int8 operations; a launch's least
time is the larger of the two.
"""

from __future__ import annotations

import numpy as np

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
# the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
N_BITS = 256
PATCH = 32


def least_s(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / INT8_OPS_PER_S)


def k1_least_s(n: int, m: int, candidates: int) -> float:
    """K1 `masked_top2` over an (n, m) mask with `candidates` allowed
    pairs: the mask, both (., 8) int32 descriptor sets and three (n,) int32
    outputs; the allowed pairs as 256 +/-1 int8 products and sums."""
    return least_s(n * m + 32 * (n + m) + 12 * n, 2 * N_BITS * candidates)


def k2_least_s(height: int, width: int, ys: np.ndarray, xs: np.ndarray) -> float:
    """K2 `gather_patches` of 32x32 float32 patches at corners (ys, xs) of an
    (height, width) float32 image: the pixels the patches cover, the two
    int32 corner arrays, the patches out."""
    ys = np.clip(np.asarray(ys, np.int64), 0, height - PATCH)
    xs = np.clip(np.asarray(xs, np.int64), 0, width - PATCH)
    cover = np.zeros((height, width), bool)
    r = np.arange(PATCH)
    cover[(ys[:, None] + r)[:, :, None], (xs[:, None] + r)[:, None, :]] = True
    n = len(ys)
    return least_s(4 * int(cover.sum()) + 8 * n + 4 * n * PATCH * PATCH, 0)
