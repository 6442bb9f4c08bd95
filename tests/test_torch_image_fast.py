"""Parity of the port's kernels/image and kernels/fast against the JAX
package on small integer-valued images (f32, CPU).

Level 0 of the pyramid is the image itself, so FAST on it is exact
(integer sums): the keypoint sets must be identical. Levels above 0 come
from two implementations of the antialiased bilinear resize that sum in
different orders; the measured difference is ~2.4e-4 grey levels on a
0..255 image, and the bound below is 1e-3."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orbslam3_tpu.kernels import fast as jfast
from orbslam3_tpu.kernels import image as jimage
from orbslam3_tpu_torch.kernels import fast as tfast
from orbslam3_tpu_torch.kernels import image as timage
from torch_parity import np_, t32, textured_image

RESIZE_ATOL = 1e-3  # grey levels


@pytest.fixture(scope="module")
def img():
    return textured_image(0, 120, 160)


def test_gaussian_blur_matches(img):
    """Same taps, same order; XLA may contract multiply-adds into FMAs, so
    allow a few f32 ulps at 255 (1.5e-5 each) over the 14 taps."""
    np.testing.assert_allclose(np_(timage.gaussian_blur(t32(img))),
                               np_(jimage.gaussian_blur(jnp.asarray(img))),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("shape", [(120, 160), (480, 752), (31, 47)])
def test_pyramid_shapes_and_atlas_layout(shape):
    h, w = shape
    assert timage.pyramid_shapes(h, w) == jimage.pyramid_shapes(h, w)
    assert timage.atlas_layout(h, w) == jimage.atlas_layout(h, w)


def test_atlas_layout_at_the_operating_point():
    """752x480, 8 levels, x1.2: the (2272, 768) atlas kernel K2 reads."""
    _rows, ah, aw = timage.atlas_layout(480, 752)
    assert (ah, aw) == (2272, 768)


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_build_pyramid_per_level_error(img, level):
    ref = jimage.build_pyramid(jnp.asarray(img), 4, 1.2)[level]
    got = timage.build_pyramid(t32(img), 4, 1.2)[level]
    assert got.shape == ref.shape
    err = np.abs(np_(got) - np_(ref)).max()
    if level == 0:
        assert err == 0.0
    assert err <= RESIZE_ATOL, f"level {level}: max |err| {err}"


def test_build_atlas_matches(img):
    ref = np_(jimage.build_atlas(jnp.asarray(img), 3, 1.2))
    got = np_(timage.build_atlas(t32(img), 3, 1.2))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=RESIZE_ATOL)
    np.testing.assert_array_equal(got[:120, :160], ref[:120, :160])  # level 0


@pytest.mark.parametrize("threshold", [jfast.MIN_TH, jfast.INI_TH])
def test_fast_score_map_is_exact(img, threshold):
    np.testing.assert_array_equal(
        np_(tfast.fast_score_map(t32(img), threshold)),
        np_(jfast.fast_score_map(jnp.asarray(img), threshold)))


def test_contiguous_arc_matches_on_all_patterns():
    """Every 16-bit circle pattern: the int64 bit trick equals the
    reference's uint32 one."""
    codes = np.arange(1 << 16, dtype=np.int64)
    mask16 = ((codes[None, :] >> np.arange(16)[:, None]) & 1).astype(bool)
    mask16 = mask16.reshape(16, 256, 256)
    np.testing.assert_array_equal(
        np_(tfast._contiguous_arc(torch.from_numpy(mask16))),
        np_(jfast._contiguous_arc(jnp.asarray(mask16))))


def test_detect_with_raw_and_nms_are_exact(img):
    s_j, raw_j = jfast.detect_with_raw(jnp.asarray(img))
    s_t, raw_t = tfast.detect_with_raw(t32(img))
    np.testing.assert_array_equal(np_(raw_t), np_(raw_j))
    np.testing.assert_array_equal(np_(s_t), np_(s_j))


@pytest.mark.parametrize("ini_th,min_th", [(jfast.INI_TH, jfast.MIN_TH), (30.0, 12.0)])
def test_detect_is_exact(img, ini_th, min_th):
    np.testing.assert_array_equal(np_(tfast.detect(t32(img), ini_th, min_th)),
                                  np_(jfast.detect(jnp.asarray(img), ini_th, min_th)))


def test_nms3_with_plateaus():
    """Equal neighbours all survive (>=), as in the reference."""
    rng = np.random.default_rng(1)
    s = rng.integers(0, 4, (40, 50)).astype(np.float32)
    np.testing.assert_array_equal(np_(tfast.nms3(t32(s))),
                                  np_(jfast.nms3(jnp.asarray(s))))


@pytest.mark.parametrize("num,per_cell", [(60, 4), (200, 4), (37, 2)])
def test_select_uniform_exact_keypoints_level0(img, num, per_cell):
    score, _ = jfast.detect_with_raw(jnp.asarray(img))
    ref = jfast.select_uniform(score, num, cell=32, per_cell=per_cell)
    got = tfast.select_uniform(t32(np_(score)), num, cell=32, per_cell=per_cell)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np_(g), np_(r))


def test_select_uniform_breaks_ties_by_lowest_index():
    """A map of many equal scores: the order must be the reference's
    (lowest flat index first within a cell, stable across cells)."""
    s = np.zeros((64, 96), np.float32)
    s[5::3, 7::4] = 12.0
    s[10, 10] = 30.0
    ref = jfast.select_uniform(jnp.asarray(s), 40, cell=32, per_cell=4)
    got = tfast.select_uniform(t32(s), 40, cell=32, per_cell=4)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np_(g), np_(r))


def test_subpixel_offsets_match(img):
    _, raw = jfast.detect_with_raw(jnp.asarray(img))
    ys, xs, _, _ = jfast.select_uniform(
        jfast.detect_with_raw(jnp.asarray(img))[0], 80)
    dy_j, dx_j = jfast.subpixel_offsets(raw, ys, xs)
    dy_t, dx_t = tfast.subpixel_offsets(t32(np_(raw)), torch.as_tensor(np_(ys)).long(),
                                        torch.as_tensor(np_(xs)).long())
    np.testing.assert_allclose(np_(dy_t), np_(dy_j), atol=1e-6)
    np.testing.assert_allclose(np_(dx_t), np_(dx_j), atol=1e-6)
