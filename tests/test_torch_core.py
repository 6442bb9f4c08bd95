"""Parity of the port's core/lie, core/camera and core/robust against the
JAX package, f32 on the CPU.

Tolerance: 1e-5 absolute on unit-scale outputs (a few f32 ulps; the two
packages order their sums differently) and 1e-3 px on pixel-scale ones
(f32 relative precision at ~500 px)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orbslam3_tpu.core import camera as jcam
from orbslam3_tpu.core import lie as jlie
from orbslam3_tpu.core import robust as jrobust
from orbslam3_tpu_torch.core import camera as tcam
from orbslam3_tpu_torch.core import lie as tlie
from orbslam3_tpu_torch.core import robust as trobust
from torch_parity import np_, t32

ATOL = 1e-5
PX_ATOL = 1e-3


def _tangents(seed, n=64):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    w[:8] *= 1e-7  # small-angle Taylor branch
    w[8:16] *= 3.0  # large angles
    return w


@pytest.mark.parametrize("name", ["hat", "so3_exp", "so3_left_jacobian"])
def test_so3_maps_match_jax(name):
    w = _tangents(0)
    ref = getattr(jlie, name)(jnp.asarray(w))
    got = getattr(tlie, name)(t32(w))
    np.testing.assert_allclose(np_(got), np_(ref), atol=ATOL)


def test_vee_inverts_hat():
    w = t32(_tangents(1))
    np.testing.assert_array_equal(np_(tlie.vee(tlie.hat(w))), np_(w))


def test_se3_exp_apply_match_jax():
    rng = np.random.default_rng(2)
    xi = rng.normal(0, 0.5, (32, 6)).astype(np.float32)
    p = rng.normal(0, 3.0, (32, 3)).astype(np.float32)
    Rj, tj = jlie.se3_exp(jnp.asarray(xi))
    Rt, tt = tlie.se3_exp(t32(xi))
    np.testing.assert_allclose(np_(Rt), np_(Rj), atol=ATOL)
    np.testing.assert_allclose(np_(tt), np_(tj), atol=ATOL)
    np.testing.assert_allclose(np_(tlie.se3_apply(Rt, tt, t32(p))),
                               np_(jlie.se3_apply(Rj, tj, jnp.asarray(p))),
                               atol=1e-4)  # |p| ~ 3: a few ulps of the sum


def test_so3_normalize_matches_jax():
    rng = np.random.default_rng(3)
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, 1, (16, 3)),
                                            jnp.float32)))
    R = (R + rng.normal(0, 1e-2, R.shape)).astype(np.float32)  # shear + scale
    ref = np_(jlie.so3_normalize(jnp.asarray(R)))
    got = np_(tlie.so3_normalize(t32(R)))
    np.testing.assert_allclose(got, ref, atol=ATOL)
    np.testing.assert_allclose(got @ got.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), got.shape), atol=ATOL)


def _cams():
    pin = dict(args=(458.0, 457.0, 367.0, 248.0),
               kw=dict(dist=(-0.28, 0.07, 2e-4, 2e-5, 0.0)))
    kb8 = dict(args=(190.0, 190.0, 254.0, 256.0, 0.003, 0.03, -0.02, 0.004),
               kw={})
    return {"pinhole": pin, "kb8": kb8}


def _cam_pair(kind):
    spec = _cams()[kind]
    make_j = jcam.Camera.pinhole if kind == "pinhole" else jcam.Camera.kb8
    make_t = tcam.Camera.pinhole if kind == "pinhole" else tcam.Camera.kb8
    return (make_j(*spec["args"], **spec["kw"]),
            make_t(*spec["args"], **spec["kw"], device="cpu"))


def _points(seed, n=128):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n),
                     rng.uniform(1.0, 6.0, n)], -1).astype(np.float32)


@pytest.mark.parametrize("kind", ["pinhole", "kb8"])
def test_camera_project_unproject_jac_match_jax(kind):
    cj, ct = _cam_pair(kind)
    xc = _points(4)
    uv_j = cj.project(jnp.asarray(xc))
    uv_t = ct.project(t32(xc))
    np.testing.assert_allclose(np_(uv_t), np_(uv_j), atol=PX_ATOL)
    np.testing.assert_allclose(np_(ct.unproject(uv_t)),
                               np_(cj.unproject(uv_j)), atol=1e-4)
    jac = ct.project_jac(t32(xc))
    assert jac.dtype == torch.float32  # f32 like the solvers it feeds
    np.testing.assert_allclose(np_(jac), np_(cj.project_jac(jnp.asarray(xc))),
                               rtol=1e-4, atol=1e-3)


def test_camera_radtan_distort_undistort_match_jax():
    cj, ct = _cam_pair("pinhole")
    rng = np.random.default_rng(5)
    uv = np.stack([rng.uniform(0, 752, 200), rng.uniform(0, 480, 200)],
                  -1).astype(np.float32)
    np.testing.assert_allclose(np_(ct.distort_points(t32(uv))),
                               np_(cj.distort_points(jnp.asarray(uv))),
                               atol=PX_ATOL)
    np.testing.assert_allclose(np_(ct.undistort_points(t32(uv))),
                               np_(cj.undistort_points(jnp.asarray(uv))),
                               atol=PX_ATOL)


def test_huber_weight_matches_jax():
    rng = np.random.default_rng(6)
    e2 = np.concatenate([[0.0, 1e-30], rng.exponential(5.0, 200)]).astype(np.float32)
    for delta in (jrobust.CHI2_MONO ** 0.5, 1.0):
        np.testing.assert_allclose(np_(trobust.huber_weight(t32(e2), delta)),
                                   np_(jrobust.huber_weight(jnp.asarray(e2), delta)),
                                   rtol=1e-6)
    assert (trobust.CHI2_MONO, trobust.CHI2_STEREO) == (jrobust.CHI2_MONO,
                                                        jrobust.CHI2_STEREO)


@pytest.mark.parametrize("name", ["cauchy_weight", "tukey_weight"])
@pytest.mark.parametrize("delta", [jrobust.CHI2_MONO ** 0.5, 1.0])
def test_cauchy_and_tukey_weights_match_jax(name, delta):
    """Both sides are the same f32 formula; rtol 1e-6, and Tukey's zero
    beyond delta exact."""
    rng = np.random.default_rng(7)
    e2 = np.concatenate([[0.0, delta * delta, 1e-30],
                         rng.exponential(5.0, 200)]).astype(np.float32)
    got = np_(getattr(trobust, name)(t32(e2), delta))
    ref = np_(getattr(jrobust, name)(jnp.asarray(e2), delta))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got == 0, ref == 0)


def test_camera_default_device_is_the_card():
    """No device argument means CUDA; without a card that raises rather
    than falling back to the CPU."""
    if torch.cuda.is_available():
        assert tcam.Camera.pinhole(1.0, 1.0, 0.0, 0.0).params.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcam.Camera.pinhole(1.0, 1.0, 0.0, 0.0)
