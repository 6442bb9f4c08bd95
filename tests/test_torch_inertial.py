"""Port parity, CPU: the inertial factors and the inertial-only MAP of
`opt/inertial`, and the VI pose tracking of `opt/pose_inertial`, against
the JAX package on the same seeded inputs (the visual-inertial BA is in
`tests/test_torch_vi_ba.py`).

Tolerances, each relative to the largest entry compared: whitening and
residuals 1e-5; their Jacobians (`torch.func.jacfwd`, or the port's
closed forms, against `jax.jacfwd`) 1e-4; inertial-only MAP: gravity direction 1e-4 rad, scale rtol 1e-4,
biases and velocities 1e-4, cost rtol 1e-3; VI pose tracking: pose and
velocity 1e-4, inlier mask exact, marginal information rtol 1e-3. Biases
near zero are held to 1e-5 in their units (rad/s, m/s^2)."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orbslam3_tpu.core import lie as jlie
from orbslam3_tpu.core.camera import Camera as JCamera
from orbslam3_tpu.imu import preintegration as jpre
from orbslam3_tpu.opt import inertial as jin
from orbslam3_tpu.opt import pose_inertial as jpi
from orbslam3_tpu.utils.synth import simulate_imu
from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.core.camera import Camera as TCamera
from orbslam3_tpu_torch.opt import inertial as tin
from orbslam3_tpu_torch.opt import pose_inertial as tpi
from torch_parity import np_

JCAL = jpre.ImuCalib.create()
TCAL = convert.imu_calib(JCAL, device="cpu")
JCAM = JCamera.pinhole(400.0, 400.0, 320.0, 240.0, width=640, height=480)
TCAM = TCamera.pinhole(400.0, 400.0, 320.0, 240.0, width=640, height=480, device="cpu")
RATE = 200


def close(got, ref, rtol):
    got, ref = np_(got), np_(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * max(np.abs(ref).max(), 1e-30))


def f32(x):
    return np.asarray(x, np.float32)


def t32(x):
    return torch.from_numpy(f32(x).copy())


def _pre(traj, i, j):
    return jpre.preintegrate(jnp.asarray(f32(traj.acc[i:j])), jnp.asarray(f32(traj.gyro[i:j])),
                             jnp.asarray(f32(traj.dt[i:j])), jnp.zeros(6, jnp.float32), JCAL)


def _edges(traj, idx):
    pres = [_pre(traj, a, b) for a, b in zip(idx[:-1], idx[1:])]
    pairs = [(k, k + 1) for k in range(len(idx) - 1)]
    return (jin.build_edges(pres, pairs),
            tin.build_edges([convert.preintegrated(p, "cpu") for p in pres], pairs))


@functools.lru_cache(maxsize=None)
def _gs_problem(s_true: float):
    """Vision poses in a rotated world scaled by 1 / s_true and the IMU of
    the true biases (`tests/test_imu.py`'s inertial-only problem)."""
    from scipy.spatial.transform import Rotation
    n_kf, step = 11, 100
    traj = simulate_imu(duration=n_kf * 0.5 + 0.1, seed=7, gyro_bias=(0.01, -0.02, 0.015),
                        acc_bias=(0.05, 0.08, -0.06))
    idx = [k * step for k in range(n_kf)]
    Rp = Rotation.from_rotvec([0.3, -0.2, 0.9]).as_matrix()
    Rwb = f32(np.einsum("ij,njk->nik", Rp, traj.R_wb[idx]))
    p = f32((traj.p_wb[idx] @ Rp.T) / s_true)
    ej, et = _edges(traj, idx)
    return Rwb, p, ej, et


@pytest.fixture(scope="module")
def gs_problem():
    return _gs_problem(2.5)


def test_whiten_and_build_edges_match_jax(gs_problem):
    _, _, ej, et = gs_problem
    for name in ("i", "j", "dT", "dR", "dV", "dP", "JRg", "bias0", "valid"):
        np.testing.assert_array_equal(np_(getattr(et, name)), np_(getattr(ej, name)))
    close(et.W, ej.W, 1e-5)
    close(et.Ww, ej.Ww, 1e-5)
    cov = np.asarray(ej.W[:3])
    cov = f32(cov @ np.swapaxes(cov, 1, 2) + 0.5 * np.eye(9))
    close(tin.whiten_from_cov(t32(cov)), jin.whiten_from_cov(jnp.asarray(cov)), 1e-5)


def test_inertial_residuals_match_jax(gs_problem):
    Rwb, p, ej, et = gs_problem
    rng = np.random.default_rng(1)
    v = f32(rng.normal(size=(len(p), 3)))
    bias = f32(rng.normal(size=6) * 0.01)
    Rwg = f32(np.asarray(jlie.so3_exp(jnp.asarray([0.1, -0.2, 0.0]))))
    got = tin.inertial_residuals(et, t32(Rwb), t32(p), t32(v), t32(bias), t32(Rwg),
                                 torch.tensor(1.7))
    ref = jin.inertial_residuals(ej, jnp.asarray(Rwb), jnp.asarray(p), jnp.asarray(v),
                                 jnp.asarray(bias), jnp.asarray(Rwg), jnp.asarray(1.7))
    close(got, ref, 1e-5)
    # Jacobians with respect to the velocities and the bias, jacfwd vs jacfwd
    Jt = torch.func.jacfwd(lambda vb: tin.inertial_residuals(
        et, t32(Rwb), t32(p), vb[:-6].reshape(-1, 3), vb[-6:], t32(Rwg), torch.tensor(1.7)))(
        torch.cat([t32(v).reshape(-1), t32(bias)]))
    Jj = jax.jit(jax.jacfwd(lambda vb: jin.inertial_residuals(
        ej, jnp.asarray(Rwb), jnp.asarray(p), vb[:-6].reshape(-1, 3), vb[-6:], jnp.asarray(Rwg),
        jnp.asarray(1.7))))(jnp.concatenate([jnp.asarray(v).reshape(-1), jnp.asarray(bias)]))
    close(Jt, Jj, 1e-4)


@pytest.mark.parametrize("mode", ["init", "viba1", "refine"])
def test_inertial_only_optimize_matches_jax(mode):
    Rwb, p, ej, et = _gs_problem(2.5)
    kw = {"init": dict(prior_gyro=1e2, prior_acc=1e10),
          "viba1": dict(prior_gyro=1.0, prior_acc=1e3, n_iters=30),
          "refine": dict(prior_gyro=1e6, prior_acc=1e10, fix_vel=True)}[mode]
    ref = jin.inertial_only_optimize(jnp.asarray(Rwb), jnp.asarray(p), ej, **kw)
    got = tin.inertial_only_optimize(t32(Rwb), t32(p), et, **kw)
    g_ref = np_(ref.Rwg).astype(np.float64) @ np.array([0.0, 0.0, -1.0])
    g_got = np_(got.Rwg).astype(np.float64) @ np.array([0.0, 0.0, -1.0])
    assert np.arctan2(np.linalg.norm(np.cross(g_ref, g_got)), g_ref @ g_got) < 1e-4
    np.testing.assert_allclose(float(got.scale), float(ref.scale), rtol=1e-4)
    close(got.bias, ref.bias, 1e-4)
    close(got.v, ref.v, 1e-4)
    np.testing.assert_allclose(float(got.cost), float(ref.cost), rtol=1e-3)


@pytest.mark.parametrize("frame", ["world", "body"])
def test_inertial_jacobians_match_jax_jacfwd(frame):
    """The closed-form Jacobians of the preintegration factor and the bias
    walk against `jax.jacfwd` of the JAX package's residuals, at states off
    the optimum with biases away from the linearization point. "world" is
    the VI pose tracking's perturbation (p <- p + dp), with the prior term;
    "body" the VI-BA's per-edge one (p <- p + R dp)."""
    rng = np.random.default_rng(4)
    traj = simulate_imu(duration=1.0, rate=200.0, seed=5)
    k, j = 60, 110
    pre = _pre(traj, k, j)
    dR = np.asarray(jlie.so3_exp(jnp.asarray([0.02, -0.03, 0.01])))
    si = (traj.R_wb[k], traj.p_wb[k], traj.v_wb[k], rng.normal(0, 0.05, 6))
    sj = (traj.R_wb[j] @ dR, traj.p_wb[j] + [0.03, -0.02, 0.04],
          traj.v_wb[j] + [0.1, 0.05, -0.08], rng.normal(0, 0.05, 6))
    ji, jj = _body(si, jpi), _body(sj, jpi)
    deltas = (pre.dR, pre.dV, pre.dP, pre.JRg, pre.JVg, pre.JVa, pre.JPg, pre.JPa,
              pre.bias, pre.dT)
    W = jin.whiten_from_cov(pre.cov)
    Ww = jin.whiten_from_cov(pre.cov_walk)
    z = jnp.zeros(15, jnp.float32)

    def body_perturb(s, x):
        return jpi.BodyState(s.Rwb @ jlie.so3_exp(x[:3]), s.p + s.Rwb @ x[3:6],
                             s.v + x[6:9], s.bias + x[9:])

    move = jpi._perturb if frame == "world" else body_perturb

    def res(xi, xj):
        a, c = move(ji, xi), move(jj, xj)
        return jnp.concatenate([jpi._inertial_residual(a, c, *deltas, W),
                                jpi._bias_rw_residual(a, c, Ww)])

    r_ref = res(z, z)
    Ji_ref = jax.jacfwd(lambda x: res(x, z))(z)
    Jj_ref = jax.jacfwd(lambda x: res(z, x))(z)
    tpre = convert.preintegrated(pre, "cpu")
    if frame == "world":
        ti, tj = _body(si, tpi), _body(sj, tpi)
        r9, Ji, Jj = tpi._inertial_terms(ti, tj, tpre, t32(W))
        close(r9, r_ref[:9], 1e-5)
        close(Ji, Ji_ref[:9], 1e-4)
        close(Jj, Jj_ref[:9], 1e-4)
        # the prior on the anchor, at a state off the prior's mean
        H = np.asarray(jpi.optimize_pose_inertial(
            ji, jj, pre, JCAL, *_pose_args(traj, _pose_case(traj, k, rng), jpi), JCAM)[3].H)
        Lt = f32(np.linalg.cholesky(H + 1e-8 * np.eye(15)).T)
        r_p, J_p = tpi._prior_terms(tj, t32(Lt), ti)
        J_ref = jax.jacfwd(lambda x: jpi._prior_residual(jj, jnp.asarray(Lt), jpi._perturb(ji, x)))(z)
        close(r_p, jpi._prior_residual(jj, jnp.asarray(Lt), ji), 1e-4)
        close(J_p, J_ref, 1e-4)
        return
    tprob = tin.VIBAProblem(*(torch.stack([t32(x), t32(y)]) for x, y in zip(si, sj)),
                            *([None] * 8))
    ej = _edges(traj, [k, j])[1]
    r, Ji, Jj = tin.inertial_edge_terms(tprob, ej)
    close(r[0], r_ref, 1e-5)
    close(Ji[0], Ji_ref, 1e-4)
    close(Jj[0], Jj_ref, 1e-4)


def _body(s, mod):
    return mod.BodyState(*(jnp.asarray(f32(x)) if mod is jpi else t32(x) for x in s))


def _pose_case(traj, j, rng, n_pts=200, n_out=12):
    """`tests/test_pose_inertial.py`'s case: points in front of the camera
    at sample j, 0.3 px noise, gross outliers first."""
    xc = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                   rng.uniform(3, 9, n_pts)], -1)
    pts = xc @ traj.R_wb[j].T + traj.p_wb[j]
    uv = np.asarray(JCAM.project(jnp.asarray(xc))) + rng.normal(0, 0.3, (n_pts, 2))
    uv[:n_out] += rng.uniform(12, 40, (n_out, 2))
    return f32(pts), f32(uv), np.ones(n_pts, np.float32), np.ones(n_pts, bool)


def _pose_args(traj, case, mod):
    pts, uv, info, valid = case
    if mod is jpi:
        return jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(info), jnp.asarray(valid)
    return t32(pts), t32(uv), t32(info), torch.from_numpy(valid)


def _check_pose(got, ref):
    (s_t, inl_t, n_t, prior_t), (s_j, inl_j, n_j, prior_j) = got, ref
    for a, b in zip(s_t[:3], s_j[:3]):
        close(a, b, 1e-4)
    np.testing.assert_allclose(np_(s_t.bias), np_(s_j.bias), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(np_(inl_t), np_(inl_j))
    assert n_t == n_j
    np.testing.assert_allclose(np_(prior_t.H), np_(prior_j.H), rtol=1e-3,
                               atol=1e-3 * np.abs(np_(prior_j.H)).max())


def test_optimize_pose_inertial_matches_jax():
    """The last-keyframe variant from a perturbed guess, then the last-frame
    variant with the marginalization prior it produced."""
    rng = np.random.default_rng(3)
    traj = simulate_imu(duration=1.0, rate=200.0, seed=7)
    k, j1, j2 = 60, 100, 140
    zero6 = np.zeros(6)
    anchor = (traj.R_wb[k], traj.p_wb[k], traj.v_wb[k], zero6)
    dR = np.asarray(jlie.so3_exp(jnp.asarray([0.03, -0.02, 0.04])))
    cur1 = (traj.R_wb[j1] @ dR, traj.p_wb[j1] + [0.08, -0.05, 0.06],
            traj.v_wb[j1] + [0.2, -0.1, 0.15], zero6)
    pre1 = _pre(traj, k, j1)
    case1 = _pose_case(traj, j1, rng)
    ref1 = jpi.optimize_pose_inertial(_body(anchor, jpi), _body(cur1, jpi), pre1, JCAL,
                                      *_pose_args(traj, case1, jpi), JCAM, anchor_fixed=True)
    got1 = tpi.optimize_pose_inertial(_body(anchor, tpi), _body(cur1, tpi),
                                      convert.preintegrated(pre1, "cpu"), TCAL,
                                      *_pose_args(traj, case1, tpi), TCAM, anchor_fixed=True)
    _check_pose(got1, ref1)
    assert not np_(got1[1])[:5].any()

    cur2 = (traj.R_wb[j2], traj.p_wb[j2] + [-0.06, 0.04, 0.05],
            traj.v_wb[j2] + [0.1, 0.0, -0.1], zero6)
    pre2 = _pre(traj, j1, j2)
    case2 = _pose_case(traj, j2, rng)
    prior_t = tpi.PoseImuPrior(_body(tuple(ref1[3].state), tpi), t32(ref1[3].H))
    ref2 = jpi.optimize_pose_inertial(ref1[0], _body(cur2, jpi), pre2, JCAL,
                                      *_pose_args(traj, case2, jpi), JCAM, prior=ref1[3],
                                      anchor_fixed=False)
    got2 = tpi.optimize_pose_inertial(prior_t.state, _body(cur2, tpi),
                                      convert.preintegrated(pre2, "cpu"), TCAL,
                                      *_pose_args(traj, case2, tpi), TCAM, prior=prior_t,
                                      anchor_fixed=False)
    _check_pose(got2, ref2)
