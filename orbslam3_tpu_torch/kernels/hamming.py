"""Hamming distances and masked best/runner-up matching: kernel K1.

Port of `orbslam3_tpu/kernels/hamming.py` and
`orbslam3_tpu/kernels/hamming_pallas.py:masked_top2`. On CUDA tensors
`masked_top2` launches the hand-written kernel in `csrc/hamming_top2.cu`;
on CPU tensors it runs `masked_top2_reference`, the plain PyTorch version,
which is also what the kernel is held against on the card. The choice
follows the tensors' device only; there is no switch.

Descriptors travel as packed (N, 8) int32 words (the reference's uint32
words, reinterpreted) or as (N, 256) +/-1 planes.
"""

from __future__ import annotations

import ctypes

import torch

from orbslam3_tpu_torch import _build
from orbslam3_tpu_torch.kernels.orb_descriptor import pack_bits

N_BITS = 256
TH_LOW = 50    # reference ORBmatcher.h:83
TH_HIGH = 100  # reference ORBmatcher.h:84
BIG = 1 << 20  # distance of a masked-out candidate
KERNEL = "masked_top2"


def distance_matrix(planes_a: torch.Tensor, planes_b: torch.Tensor) -> torch.Tensor:
    """(N,256) +/-1 x (M,256) +/-1 -> (N,M) int32 Hamming distances.

    Exact: f32 products of +/-1 sum to small integers (TF32 is off)."""
    dot = planes_a.float() @ planes_b.float().T
    return ((N_BITS - dot) * 0.5).to(torch.int32)


def match_ratio(dist: torch.Tensor, max_dist: int = TH_LOW, ratio: float = 0.9):
    """Best match per row with the Lowe ratio test over a distance matrix.

    Returns (idx, best_dist, ok). Ties go to the lowest column (stable sort),
    as `jax.lax.top_k` breaks them."""
    vals, order = torch.sort(dist.float(), dim=1, stable=True)
    best, second = vals[:, 0], vals[:, 1]
    ok = (best <= max_dist) & (best < ratio * second)
    return order[:, 0], best.to(torch.int32), ok


def _as_words(desc: torch.Tensor) -> torch.Tensor:
    """Packed (N, 8) int32 words from words or from (N, 256) +/-1 planes."""
    if desc.shape[-1] == N_BITS:
        return pack_bits(desc > 0)
    if desc.shape[-1] != 8 or desc.dtype != torch.int32:
        raise ValueError("descriptors must be (N, 8) int32 words or (N, 256) "
                         f"planes, got {desc.dtype} {tuple(desc.shape)}")
    return desc.contiguous()


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int64 values in [0, 2^32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def masked_top2_reference(words_a: torch.Tensor, words_b: torch.Tensor,
                          mask: torch.Tensor):
    """Plain version of `masked_top2` on packed words: XOR + popcount per
    word, masked-out entries at BIG, then the same (distance, lowest column)
    order the kernel reduces in."""
    a = words_a.long() & 0xFFFFFFFF
    b = words_b.long() & 0xFFFFFFFF
    dist = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int64,
                       device=a.device)
    for wd in range(8):
        dist += _popcount32(a[:, wd, None] ^ b[None, :, wd])
    dist = torch.where(mask.bool(), dist, BIG)
    m = dist.shape[1]
    cols = torch.arange(m, device=dist.device)
    best = dist.min(dim=1).values
    idx = torch.where(dist == best[:, None], cols, m).min(dim=1).values
    second = torch.where(cols[None, :] == idx[:, None], BIG, dist)
    second = second.min(dim=1).values if m > 1 else torch.full_like(best, BIG)
    return idx.to(torch.int32), best.to(torch.int32), second.to(torch.int32)


def masked_top2(desc_a: torch.Tensor, desc_b: torch.Tensor, mask: torch.Tensor):
    """Masked Hamming best / runner-up match.

    desc_a (N, ...) and desc_b (M, ...) are packed words or +/-1 planes;
    mask (N, M) bool, True where b[j] is a candidate for a[i]. Returns
    (idx, best, second), each (N,) int32. A row with no candidate gets
    best == second == 2^20 and idx 0; ties go to the lowest column.
    """
    a, b = _as_words(desc_a), _as_words(desc_b)
    n, m = a.shape[0], b.shape[0]
    if mask.shape != (n, m):
        raise ValueError(f"masked_top2: mask {tuple(mask.shape)} != ({n}, {m})")
    if m < 1:
        raise ValueError("masked_top2: no candidate columns")
    if a.device.type == "cpu":
        return masked_top2_reference(a, b, mask)
    if a.device.type != "cuda":
        raise ValueError(f"masked_top2: unsupported device {a.device}")
    if mask.dtype not in (torch.bool, torch.uint8) or not mask.is_contiguous():
        raise ValueError("masked_top2: mask must be a contiguous bool/uint8 tensor")
    for name, v in (("a", a), ("b", b), ("mask", mask)):
        if v.device != a.device:
            raise ValueError(f"masked_top2: {name} is on {v.device}, not {a.device}")
        if v.data_ptr() % 16:
            raise ValueError(f"masked_top2: {name} is not 16-byte aligned")
    idx, best, second = (torch.empty(n, dtype=torch.int32, device=a.device)
                         for _ in range(3))
    if n == 0:
        return idx, best, second
    lib = _build.library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.orb_masked_top2(
            ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(b.data_ptr()),
            ctypes.c_void_p(mask.data_ptr()), n, m,
            ctypes.c_void_p(idx.data_ptr()), ctypes.c_void_p(best.data_ptr()),
            ctypes.c_void_p(second.data_ptr()), ctypes.c_void_p(stream))
    _build.check(rc, KERNEL)
    _build.launches[KERNEL] += 1
    return idx, best, second


def masked_match_ratio(planes_a: torch.Tensor, planes_b: torch.Tensor,
                       mask: torch.Tensor, max_dist: int = TH_LOW,
                       ratio: float = 0.9):
    """Best match + Lowe ratio test over a candidate mask; the single entry
    point of every Search* policy. Returns (idx, best_dist, ok)."""
    idx, best, second = masked_top2(planes_a, planes_b, mask)
    ok = (best <= max_dist) & (best.float() < ratio * second.float())
    return idx, best, ok
