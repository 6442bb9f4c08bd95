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
