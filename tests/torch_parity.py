"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX
runs on the CPU, the port with ``device="cpu"`` (its kernels' plain
versions). Tests that need the card take the `cuda` fixture, which skips
when there is none; the decision is made inside the test run, never at
import time.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def textured_image(seed: int, h: int, w: int) -> np.ndarray:
    """Integer-valued (h, w) float32 image in [0, 255]: bicubically
    upsampled uniform noise, so FAST finds stable corners and level-0
    scores are exact integer sums in both packages."""
    rng = np.random.default_rng(seed)
    small = rng.uniform(0, 255, (h // 4 + 2, w // 4 + 2)).astype(np.float32)
    up = F.interpolate(torch.from_numpy(small)[None, None], size=(h, w),
                       mode="bicubic", align_corners=False)[0, 0]
    return np.clip(np.round(up.numpy()), 0, 255).astype(np.float32)


def np_(x) -> np.ndarray:
    """numpy view of a JAX array or a CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def t32(x, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype)


def random_words(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)


def top2_case(name):
    """(words_a, words_b, mask) of the reference's kernel tests, plus tie
    and edge cases."""
    rng = np.random.default_rng(0)
    if name == "random_unaligned":  # test_masked_top2_matches_reference
        a, b = random_words(rng, 200), random_words(rng, 310)
        return a, b, rng.random((200, 310)) < 0.3
    if name == "empty_rows":  # test_masked_top2_empty_rows_rejected
        a, b = random_words(rng, 16), random_words(rng, 32)
        mask = np.zeros((16, 32), bool)
        mask[3] = True
        return a, b, mask
    if name == "dense_half":  # test_masked_match_ratio_dispatch_parity
        a, b = random_words(rng, 64), random_words(rng, 96)
        return a, b, rng.random((64, 96)) < 0.5
    if name == "ties":  # duplicated candidates: equal minima in many columns
        a = random_words(rng, 37)
        b = np.concatenate([a[:20], a[:20], random_words(rng, 13)])
        mask = rng.random((37, 53)) < 0.6
        mask[:, 0] = False  # the lowest tied column is not always allowed
        return a, b, mask
    if name == "single_column":
        a, b = random_words(rng, 9), random_words(rng, 1)
        return a, b, rng.random((9, 1)) < 0.5
    raise KeyError(name)


CASES = ["random_unaligned", "empty_rows", "dense_half", "ties", "single_column"]
