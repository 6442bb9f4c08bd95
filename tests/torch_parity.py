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


@pytest.fixture(scope="module")
def one_torch_thread():
    """Run a module's tests on one torch CPU thread, then restore the
    count. The suite runs several workers on one machine; torch's default
    of a thread per core in each worker oversubscribes it several times
    over. Used autouse by the stereo slice's test modules."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    if name == "window":  # the tracker's search, small: see window_mask
        a, b = random_words(rng, 96), random_words(rng, 80)
        b[40:] = b[:40]  # every tie twice
        a[:40] = b[:40] ^ (rng.integers(0, 2, (40, 8), dtype=np.uint32) << 3)
        return a, b, window_mask(rng, 96, 80, 752, 480)
    if name == "all_true":
        a, b = random_words(rng, 40), random_words(rng, 70)
        b[35:] = b[:35]
        return a, b, np.ones((40, 70), bool)
    if name.startswith("m"):  # rows start on and off the 16-byte grid
        m = int(name[1:])
        a, b = random_words(rng, 21), random_words(rng, m)
        mask = rng.random((21, m)) < 0.1
        mask[5, :] = True
        mask[6, :] = False
        mask[7, m // 2:] = True  # a run across chunk and step boundaries
        return a, b, mask
    if name == "last_column":  # the only candidate is a row's last byte
        a, b = random_words(rng, 33), random_words(rng, 47)
        mask = np.zeros((33, 47), bool)
        mask[::2, -1] = True
        mask[1::4, 0] = True
        mask[3::4] = rng.random((8, 47)) < 0.2
        mask[32] = False
        mask[32, -1] = True  # the mask's very last byte
        return a, b, mask
    if name == "wide":  # rows longer than the kernel's batch of mask bytes
        a, b = random_words(rng, 9), random_words(rng, 2100)
        mask = rng.random((9, 2100)) < 0.05
        mask[2, 1400:2100] = True  # a run across the batch boundary
        mask[4] = False
        mask[4, -1] = True
        return a, b, mask
    raise KeyError(name)


def window_mask(rng, n, m, width, height, radius=15.0):
    """(n, m) mask as `search_by_projection` builds it: features scattered
    around projected map points, octave-scaled windows, and every 17th row
    without a candidate."""
    mp_uv = rng.random((n, 2)) * (width, height)
    f_uv = mp_uv[rng.integers(0, n, m)] + 6 * rng.standard_normal((m, 2))
    r = radius * 1.2 ** rng.integers(0, 8, m)
    d2 = np.sum((mp_uv[:, None, :] - f_uv[None, :, :]) ** 2, axis=-1)
    mask = d2 <= (r * r)[None, :]
    mask[::17] = False
    return mask


CASES = ["random_unaligned", "empty_rows", "dense_half", "ties", "single_column",
         "window", "all_true", "m15", "m16", "m17", "m511", "m513", "last_column",
         "wide"]
