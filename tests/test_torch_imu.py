"""Port parity, CPU: the IMU numerics (`core/lie` log and right Jacobians,
`imu/preintegration`, the IMU generators of `utils/synth` and
`datasets/render`) against the JAX package on the same seeded inputs.

Tolerances: the Lie maps 1e-5 (f32, same branches); preintegrated deltas
rtol 1e-5, covariance rtol 1e-4 and bias Jacobians 1e-5, each relative to
the largest entry (f32 products summed in another order over up to 300
samples); the float64 generators exactly, the f32 ones to f32."""

import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orbslam3_tpu.core import lie as jlie
from orbslam3_tpu.datasets import euroc as jeuroc
from orbslam3_tpu.datasets import synth_euroc as jsynth_euroc
from orbslam3_tpu.imu import preintegration as jpre
from orbslam3_tpu.utils import synth as jsynth
from orbslam3_tpu_torch.core import lie as tlie
from orbslam3_tpu_torch.datasets import render as trender
from orbslam3_tpu_torch.imu import preintegration as tpre
from orbslam3_tpu_torch.utils import synth as tsynth
from torch_parity import np_

JCAL = jpre.ImuCalib.create()
TCAL = tpre.ImuCalib.create()
BIAS = np.array([0.004, -0.01, 0.002, 0.05, -0.02, 0.03], np.float32)


def close(got, ref, rtol):
    """|got - ref| <= rtol * max|ref|, entrywise."""
    got, ref = np_(got), np_(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * max(np.abs(ref).max(), 1e-30))


ANGLES = {
    "zero": np.zeros(3),
    "tiny": np.array([1e-8, -2e-8, 5e-9]),
    "generic": np.array([0.3, -0.7, 0.45]),
    "near_pi": np.array([1.0, 2.0, -2.0]) / 3.0 * (np.pi - 3e-4),
    "pi_axis": np.array([np.pi - 1e-4, 0.0, 0.0]),
}


@pytest.mark.parametrize("name", list(ANGLES))
def test_so3_log_and_right_jacobians_match_jax(name):
    w = ANGLES[name].astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray(w)))
    close(tlie.so3_log(torch.from_numpy(R.copy())), jlie.so3_log(jnp.asarray(R)), 1e-5)
    for fn in ("so3_right_jacobian", "so3_right_jacobian_inv"):
        close(getattr(tlie, fn)(torch.from_numpy(w)), getattr(jlie, fn)(jnp.asarray(w)), 1e-5)


def test_so3_log_batched_matches_jax():
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(64, 3)) * rng.uniform(0, 3.1, (64, 1))).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray(w)))
    close(tlie.so3_log(torch.from_numpy(R.copy())), jlie.so3_log(jnp.asarray(R)), 1e-5)


def test_so3_log_tangents_finite_at_identity():
    """Forward-mode tangents through exp and log at zero angle stay finite
    and are the identity (every converged inertial edge evaluates there)."""
    J = torch.func.jacfwd(lambda x: tlie.so3_log(tlie.so3_exp(x)))(torch.zeros(3))
    assert J.dtype == torch.float32
    np.testing.assert_allclose(J.numpy(), np.eye(3), atol=1e-6)


def _window(duration=1.5, seed=1):
    traj = jsynth.simulate_imu(duration=duration, seed=seed,
                               gyro_bias=(0.01, -0.02, 0.005), acc_bias=(0.1, 0.0, -0.05))
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return traj, f32(traj.acc), f32(traj.gyro), f32(traj.dt)


def _both(acc, gyro, dt, bias=BIAS):
    j = jpre.preintegrate(jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(dt),
                          jnp.asarray(bias), JCAL)
    t = tpre.preintegrate(torch.from_numpy(acc), torch.from_numpy(gyro),
                          torch.from_numpy(dt), torch.from_numpy(bias), TCAL)
    return j, t


def _check_pre(t, j):
    for name in ("dT", "dR", "dV", "dP", "bias"):
        close(getattr(t, name), getattr(j, name), 1e-5)
    for name in ("cov", "cov_walk"):
        close(getattr(t, name), getattr(j, name), 1e-4)
    for name in ("JRg", "JVg", "JVa", "JPg", "JPa"):
        close(getattr(t, name), getattr(j, name), 1e-5)


@pytest.mark.parametrize("lo,hi", [(0, 10), (40, 140), (0, 300)])
def test_preintegrate_matches_jax(lo, hi):
    _, acc, gyro, dt = _window()
    j, t = _both(acc[lo:hi], gyro[lo:hi], dt[lo:hi])
    _check_pre(t, j)


def test_preintegrate_padding_invariance():
    """A window padded with dt = 0 rows (the reference's 128-sample buffer)
    gives what the unpadded window gives, in both packages."""
    _, acc, gyro, dt = _window()
    n, cap = 11, 128
    pad = lambda x: np.concatenate([x[:n], np.zeros((cap - n,) + x.shape[1:], x.dtype)])  # noqa: E731
    j, t = _both(pad(acc), pad(gyro), pad(dt))
    _, t_short = _both(acc[:n], gyro[:n], dt[:n])
    _check_pre(t, j)
    for a, b in zip(t, t_short):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_merge_corrected_deltas_predict_state_match_jax():
    traj, acc, gyro, dt = _window()
    j1, t1 = _both(acc[:100], gyro[:100], dt[:100])
    j2, t2 = _both(acc[100:220], gyro[100:220], dt[100:220])
    _check_pre(tpre.merge(t1, t2), jpre.merge(j1, j2))
    _check_pre(tpre.merge_all([t1, t2, t1]), jpre.merge(jpre.merge(j1, j2), j1))
    b = BIAS + np.array([0.002, 0.001, -0.003, 0.02, 0.01, -0.01], np.float32)
    for got, ref in zip(tpre.corrected_deltas(t1, torch.from_numpy(b)),
                        jpre.corrected_deltas(j1, jnp.asarray(b))):
        close(got, ref, 1e-5)
    R, p, v = (traj.R_wb[0].astype(np.float32), traj.p_wb[0].astype(np.float32),
               traj.v_wb[0].astype(np.float32))
    for got, ref in zip(tpre.predict_state(*(torch.from_numpy(x) for x in (R, p, v)), t1,
                                           torch.from_numpy(b)),
                        jpre.predict_state(*(jnp.asarray(x) for x in (R, p, v)), j1,
                                           jnp.asarray(b))):
        close(got, ref, 1e-5)


def test_identity_preintegrated_and_calib_match_jax():
    for got, ref in zip(tpre.identity_preintegrated(), jpre.identity_preintegrated()):
        np.testing.assert_array_equal(np_(got), np_(ref))
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.1, -0.02, 0.03]
    cj, ct = jpre.ImuCalib.create(Tbc=T), tpre.ImuCalib.create(Tbc=T)
    for name in ("Rbc", "tbc", "gyro_noise2", "acc_noise2", "gyro_walk2", "acc_walk2"):
        np.testing.assert_array_equal(np_(getattr(ct, name)), np_(getattr(cj, name)))


def test_simulate_imu_matches_jax():
    kw = dict(duration=0.3, seed=5, gyro_bias=(0.01, 0, 0), acc_noise=1e-3, gyro_noise=1e-4)
    a, b = tsynth.simulate_imu(**kw), jsynth.simulate_imu(**kw)
    for name in ("t", "R_wb", "p_wb", "v_wb", "gyro", "acc", "dt"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    for x, y in zip(a.gt_deltas(3, 40), b.gt_deltas(3, 40)):
        np.testing.assert_array_equal(x, y)


def test_imu_orbit_samples_match_jax():
    R, t = jsynth.orbit_trajectory(n_frames=6, radius=3.0, arc=0.6)
    ts = np.arange(6) * 0.05
    kw = dict(seed=2, gyro_noise=1e-3, acc_noise=1e-2, gyro_bias=np.full(3, 0.01))
    for (a1, g1, d1), (a2, g2, d2) in zip(tsynth.imu_orbit_samples(R, t, ts, **kw),
                                          jsynth.imu_orbit_samples(R, t, ts, **kw)):
        np.testing.assert_allclose(a1, a2, rtol=1e-6, atol=1e-6)  # to f32
        np.testing.assert_allclose(g1, g2, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(d1, d2)


def test_vi_sequence_matches_the_euroc_writer():
    """`vi_sequence`'s trajectory and IMU are the writer's: the same
    `excited_trajectory`, noise and stamps; `imu_batches` on its arrays
    groups the samples as the reference's loader does."""
    center = (0.0, 0.0, 8.0)
    got = trender.excited_trajectory(8, 20.0, 200.0, center, 3.0, 1.0, 0.05, 0.06, seed=3)
    ref = jsynth_euroc.excited_trajectory(8, 20.0, 200.0, center, 3.0, 1.0,
                                          excitation=0.05, rot_excitation=0.06, seed=3)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    seq = trender.vi_sequence(8, render=False)
    _, _, _, imu_t, gyro, acc = ref
    rng = np.random.default_rng(3 + 5)
    gyro_n = gyro + rng.normal(0, 2e-4, gyro.shape)
    acc_n = acc + rng.normal(0, 2e-3, acc.shape)
    np.testing.assert_array_equal(seq.gyro[1:], gyro_n)
    np.testing.assert_array_equal(seq.acc[0], acc_n[0])
    np.testing.assert_allclose(seq.imu_ts[1:], 100.0 + imu_t[1:], rtol=0, atol=1e-12)
    assert seq.imu_ts[0] == pytest.approx(99.995)
    np.testing.assert_array_equal(seq.R_wb, np.swapaxes(ref[0], 1, 2))
    asl = types.SimpleNamespace(image_ts=seq.frame_ts, imu_ts=seq.imu_ts,
                                imu_gyro=seq.gyro, imu_acc=seq.acc)
    mine = trender.imu_batches(seq.frame_ts, seq.imu_ts, seq.gyro, seq.acc)
    theirs = list(jeuroc.imu_batches(asl))
    assert [len(b) for b in mine] == [len(b) for b in theirs] == [1] + [10] * 7
    for bm, bt in zip(mine, theirs):
        for (t1, g1, a1), (t2, g2, a2) in zip(bm, bt):
            assert t1 == t2
            np.testing.assert_array_equal(g1, g2)
            np.testing.assert_array_equal(a1, a2)
