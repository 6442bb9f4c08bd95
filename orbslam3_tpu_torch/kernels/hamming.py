"""Hamming distances and masked best/runner-up matching: kernel K1.

Port of `orbslam3_tpu/kernels/hamming.py` and
`orbslam3_tpu/kernels/hamming_pallas.py:masked_top2`. On CUDA tensors
`masked_top2` launches the hand-written kernel in `csrc/hamming_top2.cu`;
on CPU tensors it runs `masked_top2_reference`, the plain PyTorch version,
which is also what the kernel is held against on the card. The choice
follows the tensors' device only; there is no switch.

Descriptors travel as packed (N, 8) int32 words (the reference's uint32
words, reinterpreted) or as (N, 256) +/-1 planes.

Every launch adds one to `_build.launches["masked_top2"]` and, when the
caller names its matcher policy, one to
`_build.launches["masked_top2[<policy>]"]`.
"""

from __future__ import annotations

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


def distance_matrix_popcount(words_a: torch.Tensor, words_b: torch.Tensor) -> torch.Tensor:
    """(N,8) x (M,8) packed words -> (N,M) int32 by XOR + popcount, a word
    at a time so the intermediate stays one (N,M) buffer."""
    a = words_a.long() & 0xFFFFFFFF
    b = words_b.long() & 0xFFFFFFFF
    out = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int64, device=a.device)
    for w in range(a.shape[1]):
        out += _popcount32(a[:, w, None] ^ b[None, :, w])
    return out.to(torch.int32)


def distance_vector(words_a: torch.Tensor, words_b: torch.Tensor) -> torch.Tensor:
    """Row-wise distance between aligned packed words (N,8) x (N,8) -> (N,)."""
    x = (words_a.long() & 0xFFFFFFFF) ^ (words_b.long() & 0xFFFFFFFF)
    return _popcount32(x).sum(-1).to(torch.int32)


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
    """Plain version of `masked_top2` on packed words: XOR + popcount of
    the allowed pairs only, then the same (distance, lowest column) order
    the kernel reduces in. A row with no allowed pair gets idx 0 and
    best == second == BIG, as a dense matrix of BIG would give."""
    n, m = mask.shape
    dev = words_a.device
    rows, cols = torch.nonzero(mask.bool(), as_tuple=True)
    a = words_a.long()[rows] & 0xFFFFFFFF
    b = words_b.long()[cols] & 0xFFFFFFFF
    dist = _popcount32(a ^ b).sum(dim=1)
    big = torch.full((n,), BIG, dtype=torch.int64, device=dev)
    best = big.scatter_reduce(0, rows, dist, reduce="amin")
    at_best = dist == best[rows]
    idx = torch.full((n,), m, dtype=torch.int64, device=dev).scatter_reduce(
        0, rows, torch.where(at_best, cols, m), reduce="amin")
    idx = torch.where(idx == m, 0, idx)
    second = big.scatter_reduce(0, rows, torch.where(cols == idx[rows], BIG, dist),
                                reduce="amin")
    return idx.to(torch.int32), best.to(torch.int32), second.to(torch.int32)


def masked_top2(desc_a: torch.Tensor, desc_b: torch.Tensor, mask: torch.Tensor,
                policy: str | None = None):
    """Masked Hamming best / runner-up match.

    desc_a (N, ...) and desc_b (M, ...) are packed words or +/-1 planes;
    mask (N, M) bool, True where b[j] is a candidate for a[i]. Returns
    (idx, best, second), each (N,) int32. A row with no candidate gets
    best == second == 2^20 and idx 0; ties go to the lowest column.
    `policy` names the calling matcher policy for the launch counts.
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
    out = torch.empty((3, n), dtype=torch.int32, device=a.device)
    if n:
        if a.device.index == torch.cuda.current_device():
            _launch(a, b, mask, out, policy)
        else:
            with torch.cuda.device(a.device):
                _launch(a, b, mask, out, policy)
    idx, best, second = out
    return idx, best, second


def _launch(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor,
            out: torch.Tensor, policy: str | None) -> None:
    """K1 on the current stream of the current device, into the rows of
    the (3, N) int32 `out`: idx, best, second."""
    n, m = mask.shape
    rows = out.data_ptr()
    rc = _build.library().orb_masked_top2(
        a.data_ptr(), b.data_ptr(), mask.data_ptr(), n, m, rows, rows + 4 * n,
        rows + 8 * n, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, KERNEL)
    _build.count(KERNEL, *(() if policy is None else (f"{KERNEL}[{policy}]",)))


def masked_match_ratio(planes_a: torch.Tensor, planes_b: torch.Tensor,
                       mask: torch.Tensor, max_dist: int = TH_LOW,
                       ratio: float = 0.9, policy: str | None = None):
    """Best match + Lowe ratio test over a candidate mask; the single entry
    point of every Search* policy. Returns (idx, best_dist, ok)."""
    idx, best, second = masked_top2(planes_a, planes_b, mask, policy=policy)
    return idx, best, ratio_test(best, second, max_dist, ratio)


def ratio_test(best: torch.Tensor, second: torch.Tensor, max_dist: int,
               ratio: float) -> torch.Tensor:
    """Lowe's ratio test on K1's best and runner-up distances."""
    return (best <= max_dist) & (best.float() < ratio * second.float())


def mutual_filter(idx_ab: torch.Tensor, ok_ab: torch.Tensor,
                  idx_ba: torch.Tensor) -> torch.Tensor:
    """Cross-check: keep a->b matches whose b->a best maps back to a."""
    back = idx_ba[idx_ab.long()]
    return ok_ab & (back == torch.arange(idx_ab.shape[0], device=back.device))
