"""Parity of the port's kernels/orb_descriptor and kernel K2
(kernels/patch.py) against the JAX package, CPU.

The BRIEF pattern and the rotation-bin matrix are built from the port's own
copy of the seeded numpy code and must be bit-equal. K2's plain version
must equal the Pallas kernel (interpret mode) exactly. Descriptors of
identical keypoints on identical images may differ only where a blended
pair difference sits within float rounding of 0; the bound is 2 bits of
256 per descriptor, and the observed count at these sizes is 0."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orbslam3_tpu.kernels import image as jimage
from orbslam3_tpu.kernels import orb_descriptor as jdesc
from orbslam3_tpu.kernels import patch_pallas
from orbslam3_tpu_torch.kernels import fast as tfast
from orbslam3_tpu_torch.kernels import image as timage
from orbslam3_tpu_torch.kernels import orb_descriptor as tdesc
from orbslam3_tpu_torch.kernels import patch as tpatch
from torch_parity import np_, t32, textured_image

MAX_BIT_DIFF = 2


def test_pattern_is_bit_equal():
    ref = np.asarray(jdesc.PATTERN)
    assert tdesc.PATTERN.dtype == ref.dtype
    np.testing.assert_array_equal(tdesc.PATTERN, ref)
    np.testing.assert_array_equal(tdesc._make_pattern(), jdesc._make_pattern())


def test_bin_weight_matrix_is_bit_equal():
    ref = jdesc._bin_weight_matrix()
    got = tdesc._bin_weight_matrix()
    assert got.shape == ref.shape == (1024, 64 * 256)
    assert got.dtype == ref.dtype
    assert got.tobytes() == ref.tobytes()


def test_pair_index_reproduces_the_matrix_product():
    """The two-pixel gather equals the reference's bf16 one-hot matmul on
    bf16-rounded patches, for every bin, exactly."""
    rng = np.random.default_rng(0)
    pf = torch.from_numpy(rng.uniform(0, 255, (6, 1024)).astype(np.float32))
    pf = pf.to(torch.bfloat16).float()
    W = torch.from_numpy(tdesc._bin_weight_matrix())
    full = (pf.double() @ W.double()).reshape(6, 64, 256)
    lin1, lin2 = (torch.from_numpy(a) for a in tdesc._bin_pair_index())
    for b in range(64):
        got = pf[:, lin2[b]] - pf[:, lin1[b]]
        np.testing.assert_array_equal(got.double().numpy(), full[:, b].numpy())


def test_pack_unpack_planes_match_jax():
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, (50, 256)).astype(np.uint32)
    bits[0] = 1  # all-ones words: the int32 sign bit is set
    ref = np.asarray(jdesc.pack_bits(jnp.asarray(bits)))
    got = tdesc.pack_bits(torch.from_numpy(bits.astype(np.int64)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np_(got), ref.view(np.int32))
    np.testing.assert_array_equal(np_(tdesc.unpack_bits(got)),
                                  np.asarray(jdesc.unpack_bits(jnp.asarray(ref))))
    np.testing.assert_array_equal(
        np_(tdesc.descriptor_planes(got)),
        np.asarray(jdesc.descriptor_planes(jnp.asarray(ref))).astype(np.float32))


def test_orientation_maps_match_jax():
    """Prefix sums in the reference's order; the moments are sums of up to
    ~1e5 grey levels, compared with 1e-5 relative tolerance."""
    img = textured_image(2, 96, 128)
    m10_j, m01_j = jdesc.orientation_maps(jnp.asarray(img))
    m10_t, m01_t = tdesc.orientation_maps(t32(img))
    scale = np.abs(np_(m10_j)).max()
    np.testing.assert_allclose(np_(m10_t), np_(m10_j), atol=1e-5 * scale)
    np.testing.assert_allclose(np_(m01_t), np_(m01_j), atol=1e-5 * scale)


@pytest.mark.parametrize("seed", [2, 8])
def test_keypoint_angles_match_jax(seed):
    """At the FAST keypoints of a textured image (borders included); the
    moments agree to 1e-5 relative, so the angles agree within 1e-4 rad
    (compared on the circle)."""
    img = textured_image(seed, 96, 128)
    ys, xs, _, valid = tfast.select_uniform(tfast.detect(t32(img)), 200, cell=16)
    ys, xs = ys[valid], xs[valid]
    got = np_(tdesc.keypoint_angles(t32(img), ys, xs))
    ref = np_(jdesc.keypoint_angles(jnp.asarray(img), jnp.asarray(np_(ys)),
                                    jnp.asarray(np_(xs))))
    assert len(ref) > 50
    np.testing.assert_allclose(np.angle(np.exp(1j * (got - ref))), 0.0, atol=1e-4)


def _patch_inputs(seed, H=256, W=384, N=24):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    ys = rng.integers(0, H - 32, N).astype(np.int32)
    xs = rng.integers(0, W - 32, N).astype(np.int32)
    ys[:2], xs[:2] = (0, H - 32), (W - 32, 0)  # the image's corners
    return img, ys, xs


@pytest.mark.parametrize("seed,N", [(3, 24), (4, 8), (5, 40)])
def test_patch_plain_equals_pallas_interpret(seed, N):
    img, ys, xs = _patch_inputs(seed, N=N)
    ref = patch_pallas.gather_patches(jnp.asarray(img), jnp.asarray(ys),
                                      jnp.asarray(xs), interpret=True)
    got = tpatch.gather_patches(t32(img), torch.from_numpy(ys),
                                torch.from_numpy(xs))
    np.testing.assert_array_equal(np_(got), np_(ref))


def test_patch_plain_clamps_out_of_range_starts():
    img, _, _ = _patch_inputs(6)
    ys = torch.tensor([-5, 300], dtype=torch.int32)
    xs = torch.tensor([400, -1], dtype=torch.int32)
    got = tpatch.gather_patches_reference(t32(img), ys, xs)
    np.testing.assert_array_equal(np_(got[0]), img[0:32, 384 - 32:384])
    np.testing.assert_array_equal(np_(got[1]), img[256 - 32:256, 0:32])


def test_brief_descriptors_on_identical_keypoints():
    img = textured_image(7, 120, 160)
    blurred = np.asarray(jimage.gaussian_blur(jnp.asarray(img)))
    rng = np.random.default_rng(8)
    N = 64
    ys = rng.integers(17, 120 - 17, N).astype(np.int32)
    xs = rng.integers(17, 160 - 17, N).astype(np.int32)
    ang = rng.uniform(-np.pi, np.pi, N).astype(np.float32)
    ang[:4] = [0.0, np.pi, -np.pi, 2 * np.pi / 64 * 5]  # bin edges
    ref = np.asarray(jdesc.brief_descriptors(jnp.asarray(blurred), jnp.asarray(ys),
                                             jnp.asarray(xs), jnp.asarray(ang)))
    got = np_(tdesc.brief_descriptors(t32(blurred), torch.from_numpy(ys).long(),
                                      torch.from_numpy(xs).long(), t32(ang)))
    diff = np.unpackbits((got ^ ref.view(np.int32)).view(np.uint8), axis=1).sum(1)
    assert diff.max() <= MAX_BIT_DIFF, diff


def test_patch_wrapper_rejects_other_devices():
    img = torch.zeros((64, 64), device="meta")
    ys = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tpatch.gather_patches(img, ys, ys)
