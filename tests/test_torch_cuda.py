"""The port's CUDA kernels on the card, against their plain versions.

Imports no JAX, so it also runs on a machine with a card and no jax:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider

(`--noconftest` skips tests/conftest.py, which imports jax). On a machine
without a card every test here skips through the `cuda` fixture. The
kernels must equal their plain versions exactly: both compute integer
distances or copy floats."""

import numpy as np
import pytest
import torch

from orbslam3_tpu_torch import _build
from orbslam3_tpu_torch.kernels import hamming, patch
from orbslam3_tpu_torch.kernels import orb_descriptor as desc_k
from orbslam3_tpu_torch.vision.frame import extract_features
from torch_parity import CASES, cuda, textured_image, top2_case  # noqa: F401


def _words_t(words):
    return torch.from_numpy(words.view(np.int32).copy())


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_top2_kernel_equals_plain(cuda, name):
    a, b, mask = top2_case(name)
    args = (_words_t(a), _words_t(b), torch.from_numpy(mask))
    ref = hamming.masked_top2_reference(*args)
    before = _build.launches[hamming.KERNEL]
    got = hamming.masked_top2(*(x.to(cuda) for x in args))
    torch.cuda.synchronize()
    assert _build.launches[hamming.KERNEL] == before + 1
    for r, g in zip(ref, got):
        assert torch.equal(g.cpu(), r)


@pytest.mark.cuda
def test_top2_kernel_at_tracking_shape(cuda):
    """(2048, 1200) with a sparse mask: the shape of the tracker's search."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.integers(-2**31, 2**31, (2048, 8)).astype(np.int32)).to(cuda)
    b = torch.from_numpy(rng.integers(-2**31, 2**31, (1200, 8)).astype(np.int32)).to(cuda)
    b[600:] = b[:600]  # ties everywhere
    mask = torch.from_numpy(rng.random((2048, 1200)) < 0.02).to(cuda)
    got = hamming.masked_top2(a, b, mask)
    ref = hamming.masked_top2_reference(a, b, mask)
    for r, g in zip(ref, got):
        assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["m513", "window", "wide"])
def test_top2_kernel_uint8_mask_any_nonzero_byte(cuda, name):
    """A uint8 mask allows a pair wherever its byte is nonzero, not only 1."""
    a, b, mask = top2_case(name)
    rng = np.random.default_rng(4)
    weights = torch.from_numpy(mask * rng.integers(1, 256, mask.shape)).to(torch.uint8)
    args = (_words_t(a), _words_t(b))
    ref = hamming.masked_top2_reference(*args, torch.from_numpy(mask))
    got = hamming.masked_top2(*(x.to(cuda) for x in args), weights.to(cuda))
    for r, g in zip(ref, got):
        assert torch.equal(g.cpu(), r)


@pytest.mark.cuda
def test_top2_kernel_rejects_misaligned_words(cuda):
    w = torch.zeros(8 * 5 + 1, dtype=torch.int32, device=cuda)[1:].view(5, 8)
    with pytest.raises(ValueError, match="aligned"):
        hamming.masked_top2(w, w, torch.ones((5, 5), dtype=torch.bool, device=cuda))


@pytest.mark.cuda
def test_patch_kernel_equals_plain(cuda):
    """K2 at the main path's shapes: the (2272, 768) atlas, 1200 corners,
    some of them out of range (the kernel clamps them as the plain
    version does)."""
    rng = np.random.default_rng(9)
    img = torch.from_numpy(rng.uniform(0, 255, (2272, 768)).astype(np.float32)).to(cuda)
    ys = torch.from_numpy(rng.integers(-40, 2272, 1200).astype(np.int32)).to(cuda)
    xs = torch.from_numpy(rng.integers(-40, 768, 1200).astype(np.int32)).to(cuda)
    before = _build.launches[patch.KERNEL]
    got = patch.gather_patches(img, ys, xs)
    torch.cuda.synchronize()
    assert _build.launches[patch.KERNEL] == before + 1
    assert torch.equal(got, patch.gather_patches_reference(img, ys, xs))


@pytest.mark.cuda
def test_extract_features_kernel_path_equals_plain_path(cuda, monkeypatch):
    img = torch.from_numpy(textured_image(3, 240, 376)).to(cuda)
    before = _build.launches[patch.KERNEL]
    feats = extract_features(img, n_features=500, n_levels=4)
    assert _build.launches[patch.KERNEL] == before + 1
    monkeypatch.setattr(patch, "gather_patches", patch.gather_patches_reference)
    plain = extract_features(img, n_features=500, n_levels=4)
    for name in ("uv", "angle", "octave", "desc", "valid"):
        assert torch.equal(getattr(feats, name), getattr(plain, name)), name
    planes = desc_k.descriptor_planes(feats.desc)
    assert planes.is_cuda and planes.shape == (500, 256)


def _policy_mask(kind: str, n: int = 1200, seed: int = 12) -> np.ndarray:
    """(n, n) masks as the mono-init and triangulation policies build them
    at 752x480: 100 px windows between two frames' keypoints, and 2-sigma
    (7.68 px) epipolar bands between two keyframes 0.3 m apart."""
    rng = np.random.default_rng(seed)
    uv1 = rng.uniform(0, 1, (n, 2)) * (752, 480)
    uv2 = uv1[rng.permutation(n)] + rng.normal(0, 20, (n, 2))
    if kind == "init_window":
        return np.sum((uv1[:, None] - uv2[None]) ** 2, -1) <= 100.0 ** 2
    f, c = 458.0, np.array([376.0, 240.0])
    x1 = np.concatenate([(uv1 - c) / f, np.ones((n, 1))], 1)
    x2 = np.concatenate([(uv2 - c) / f, np.ones((n, 1))], 1)
    t = np.array([0.3, 0.02, 0.05])
    E = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    l2 = x1 @ E.T
    d = np.abs(l2 @ x2.T) / np.sqrt(l2[:, :1] ** 2 + l2[:, 1:2] ** 2) * f
    return d < 3.84 * 2.0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["init_window", "epipolar_band"])
def test_top2_kernel_equals_plain_on_policy_masks(cuda, kind):
    """K1 at the (1200, 1200) masks of the matcher policies the mono SLAM
    path adds, both directions (the mutual check), with duplicated
    descriptors so ties occur."""
    rng = np.random.default_rng(13)
    mask = _policy_mask(kind)
    a = rng.integers(0, 2 ** 32, (1200, 8), dtype=np.uint32)
    b = a[rng.permutation(1200)] ^ (rng.integers(0, 2, (1200, 8), dtype=np.uint32) << 5)
    b[600:] = b[:600]
    for aa, bb, mm in ((a, b, mask), (b, a, np.ascontiguousarray(mask.T))):
        args = (_words_t(aa), _words_t(bb), torch.from_numpy(mm))
        ref = hamming.masked_top2_reference(*args)
        got = hamming.masked_top2(*(x.to(cuda) for x in args), policy="test")
        for r, g in zip(ref, got):
            assert torch.equal(g.cpu(), r)
    assert 0.01 < mask.mean() < 0.5


@pytest.mark.cuda
def test_policies_launch_k1_once_per_direction(cuda):
    """search_for_initialization and search_for_triangulation run K1 in
    both directions, each launch counted under its policy."""
    from orbslam3_tpu_torch.core.camera import Camera
    from orbslam3_tpu_torch.vision import matcher
    rng = np.random.default_rng(14)
    uv = torch.from_numpy(rng.uniform(0, 400, (300, 2)).astype(np.float32)).to(cuda)
    words = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (300, 8)).astype(np.int32)).to(cuda)
    valid = torch.ones(300, dtype=torch.bool, device=cuda)
    cam = Camera.pinhole(458.0, 458.0, 376.0, 240.0, device=cuda)
    eye, t = torch.eye(3, device=cuda), torch.tensor([0.3, 0.0, 0.0], device=cuda)
    _build.launches.clear()
    matcher.search_for_initialization(uv, words, valid, uv + 3.0, words, valid)
    matcher.search_for_triangulation(uv, words, valid, uv + 3.0, words, valid,
                                     eye, torch.zeros(3, device=cuda), eye, t, cam)
    torch.cuda.synchronize()
    assert _build.launches[f"{hamming.KERNEL}[init]"] == 2
    assert _build.launches[f"{hamming.KERNEL}[triangulation]"] == 2
    assert _build.launches[hamming.KERNEL] == 4
