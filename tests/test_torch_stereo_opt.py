"""Port parity, CPU: the stereo rows of the optimizers and the metric-scale
IMU initialization.

- `opt/pose_gn.py:optimize_pose` and `engine/track_program.py:
  fused_track_pose` with a mix of monocular and stereo observations
  (a virtual right coordinate u_r, bf = 40 px m): poses within 1e-4,
  inlier sets exact;
- `opt/ba.py` with stereo rows: the Schur-reduced system within 1e-4 of
  its largest entry, poses 1e-4, points 1e-3 m, the chi2 gate's outlier
  mask exact;
- `opt/inertial.py:inertial_only_optimize(fix_scale=True)` and
  `imu/init.py:initialize_imu(fix_scale=True)` on a converted JAX map:
  gravity 1e-4 rad, velocities 1e-4, biases 1e-3 (the accelerometer bias
  is weakly determined, PR 7's bound), the scale exactly 1;
- `kf_uright` carried by `convert.map_state`, `MapState.grow` and
  `Atlas.weld`."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orbslam3_tpu.engine.track_program import fused_track_pose as j_fused
from orbslam3_tpu.imu import init as jinit
from orbslam3_tpu.kernels import orb_descriptor as jdesc
from orbslam3_tpu.opt import ba as jba
from orbslam3_tpu.opt import inertial as jin
from orbslam3_tpu.opt.pose_gn import optimize_pose as j_optimize_pose
from orbslam3_tpu.slam_map.map_state import MapConfig as JMC, MapState as JMS
from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.engine.track_program import fused_track_pose as t_fused
from orbslam3_tpu_torch.imu import init as tinit
from orbslam3_tpu_torch.kernels import orb_descriptor as tdesc
from orbslam3_tpu_torch.opt import ba as tba
from orbslam3_tpu_torch.opt import inertial as tin
from orbslam3_tpu_torch.opt.pose_gn import optimize_pose as t_optimize_pose
from orbslam3_tpu_torch.slam_map.atlas import Atlas
from orbslam3_tpu_torch.slam_map.map_state import MapConfig
from test_torch_geometry import _rot
from test_torch_inertial import _gs_problem
from test_torch_tracking import CAM, _pinhole, _track_scene, _words_t
from test_torch_vi_slam import JCAL, TCAL, _check_maps, _jax_map, close
from torch_parity import np_, one_torch_thread, t32  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU = "cpu"
BF = 40.0
POSE_ATOL = 1e-4


def _stereo_obs(rng, uv, z, share=0.6, noise=0.4):
    """Virtual right coordinates u - bf/z (+ noise) for `share` of the
    observations, -1 (monocular) for the rest."""
    u_r = (uv[:, 0] - BF / z + rng.normal(0, noise, len(z))).astype(np.float32)
    return np.where(rng.random(len(z)) < share, u_r, -1.0).astype(np.float32)


@pytest.mark.parametrize("outliers", [0, 15])
def test_optimize_pose_with_stereo_rows_matches_jax(outliers):
    rng = np.random.default_rng(14)
    cj, ct = _pinhole(458.0, 457.0, 367.0, 248.0, 752, 480)
    n = 150
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(1.5, 8, n)], -1).astype(np.float32)
    uv = np.asarray(cj.project(jnp.asarray(pts))) + rng.normal(0, 0.5, (n, 2))
    u_r = _stereo_obs(rng, uv, pts[:, 2])
    uv[:outliers] += rng.uniform(20, 40, (outliers, 2))
    u_r[outliers:2 * outliers] = np.where(u_r[outliers:2 * outliers] >= 0,
                                          u_r[outliers:2 * outliers] - 25.0, -1.0)
    uv = uv.astype(np.float32)
    info = (1.0 / 1.2 ** (2.0 * rng.integers(0, 4, n))).astype(np.float32)
    valid = rng.random(n) < 0.9
    R0 = _rot([0.0, 0.0, 0.03])
    t0 = np.array([0.05, -0.04, 0.1], np.float32)
    Rr, tr, inl_r, n_r = j_optimize_pose(
        jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(pts), jnp.asarray(uv),
        jnp.asarray(info), jnp.asarray(valid), cj, u_r=jnp.asarray(u_r),
        bf=jnp.float32(BF))
    R, t, inl, n_in = t_optimize_pose(t32(R0), t32(t0), t32(pts), t32(uv), t32(info),
                                      torch.from_numpy(valid), ct, device=CPU,
                                      u_r=t32(u_r), bf=BF)
    np.testing.assert_allclose(np_(R), np.asarray(Rr), atol=POSE_ATOL)
    np.testing.assert_allclose(np_(t), np.asarray(tr), atol=POSE_ATOL)
    np.testing.assert_array_equal(np_(inl), np.asarray(inl_r))
    assert int(n_in) == int(n_r)
    assert np.linalg.norm(np_(t)) < 5e-3  # recovered (the truth is the identity)


def _run_both_stereo(sc, cams, u_right, R0, t0, allow_last=False):
    cj, ct = cams
    radii = (15.0, 30.0, 60.0, 8.0)
    ok_j, res_j = j_fused(
        jnp.asarray(sc["mp_pos"]), jdesc.descriptor_planes(jnp.asarray(sc["mp_desc"])),
        jnp.asarray(sc["mp_valid"]), jnp.asarray(sc["mp_normal"]),
        jnp.asarray(sc["mp_min_d"]), jnp.asarray(sc["mp_max_d"]), cj,
        jnp.asarray(sc["f_uv"]), jdesc.descriptor_planes(jnp.asarray(sc["f_desc"])),
        jnp.asarray(sc["f_oct"]), jnp.asarray(sc["f_valid"]),
        jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(R0), jnp.asarray(t0),
        jnp.asarray(allow_last), jnp.asarray(radii, jnp.float32),
        jnp.asarray(20, jnp.int32), jnp.asarray(15, jnp.int32),
        u_right=jnp.asarray(u_right), bf=jnp.float32(BF))
    mp = convert.map_points(sc["mp_pos"], sc["mp_desc"], sc["mp_normal"],
                            sc["mp_min_d"], sc["mp_max_d"], device=CPU)
    ok_t, res_t = t_fused(
        mp["mp_pos"], mp["mp_desc"], torch.from_numpy(np.array(sc["mp_valid"])),
        mp["mp_normal"], mp["mp_min_dist"], mp["mp_max_dist"], ct, t32(sc["f_uv"]),
        _words_t(sc["f_desc"]), torch.from_numpy(np.array(sc["f_oct"])),
        torch.from_numpy(np.array(sc["f_valid"])), t32(R0), t32(t0), t32(R0), t32(t0),
        allow_last, radii, 20, 15, device=CPU, u_right=t32(u_right), bf=BF)
    return (bool(ok_j), jax.device_get(res_j)), (ok_t, {k: np_(v) for k, v in res_t.items()})


@pytest.mark.parametrize("offset", [(0.0, 0.0, 0.01), (0.35, 0.0, 0.0)])
def test_fused_track_pose_with_right_coordinates_matches_jax(offset):
    """`tests/test_torch_tracking.py`'s scene, each frame feature with its
    virtual right coordinate (60% of them), from a good prediction and one
    that needs the wide window."""
    sc, R_true, t_true, perm = _track_scene()
    rng = np.random.default_rng(2)
    xc = sc["mp_pos"][:len(perm)] @ R_true.T + t_true
    u_right = np.full(len(sc["f_uv"]), -1.0, np.float32)
    u_right[perm] = _stereo_obs(rng, sc["f_uv"][perm], xc[:, 2])
    (ok_j, rj), (ok_t, rt) = _run_both_stereo(sc, _pinhole(*CAM), u_right, R_true,
                                              t_true + np.asarray(offset, np.float32))
    assert ok_t == ok_j is True
    for key in ("sel", "fidx", "vsel", "inl", "nm", "n_in", "fr", "oct"):
        np.testing.assert_array_equal(rt[key], np.asarray(rj[key]), err_msg=key)
    for key in ("R", "t", "uv"):
        np.testing.assert_allclose(rt[key], np.asarray(rj[key]), atol=POSE_ATOL, err_msg=key)
    assert np.linalg.norm(rt["t"] - t_true) < 8e-3


# --------------------------------------------------------------------------
# bundle adjustment with stereo rows
# --------------------------------------------------------------------------


def _stereo_ba_problem(seed, n_kf=5, n_pts=160, n_fixed=2):
    """A seeded local BA: perturbed poses and points, 0.5 px noise, 60% of
    the observations stereo, gross outliers on both kinds of row, padding
    rows and an unobserved landmark; two fixed keyframes, as the local
    mapper's window has its fixed border. Every landmark is seen by at
    least three keyframes."""
    rng = np.random.default_rng(seed)
    fx, fy, cx, cy = CAM[:4]
    pts = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                    rng.uniform(2, 8, n_pts)], -1).astype(np.float32)
    Rs = np.stack([_rot([0.01 * k, 0.03 * k + 1e-3, 0.0]) for k in range(n_kf)])
    ts = np.stack([np.array([-0.2 * k, 0.02 * k, 0.0], np.float32) for k in range(n_kf)])
    M, P, O = n_kf + 1, n_pts + 8, n_kf * n_pts + 64
    kf_idx, lm_idx = np.zeros(O, np.int32), np.zeros(O, np.int32)
    uv, z = np.zeros((O, 2), np.float32), np.ones(O)
    valid = np.zeros(O, bool)
    seen = rng.random((n_kf, n_pts)) < 0.85
    seen[:3, seen.sum(0) < 3] = True  # every landmark seen at least 3 times
    o = 0
    for k in range(n_kf):
        xc = pts @ Rs[k].T + ts[k]
        proj = np.stack([fx * xc[:, 0] / xc[:, 2] + cx, fy * xc[:, 1] / xc[:, 2] + cy], -1)
        for j in np.nonzero(seen[k])[0]:
            kf_idx[o], lm_idx[o], uv[o], z[o], valid[o] = k, j, proj[j], xc[j, 2], True
            o += 1
    uv[:o] += rng.normal(0, 0.5, (o, 2)).astype(np.float32)
    u_r = _stereo_obs(rng, uv, z)
    u_r[o:] = -1.0
    # gross outliers only on landmarks seen 4+ times, so each stays
    # determined once they are gated (a landmark left with one monocular
    # observation runs off along its ray, in each package its own way)
    bad = rng.choice(np.nonzero(seen.sum(0)[lm_idx[:o]] >= 4)[0], 16, replace=False)
    uv[bad[:8]] += rng.uniform(15, 30, (8, 2)).astype(np.float32)
    u_r[bad[8:]] = np.where(u_r[bad[8:]] >= 0, u_r[bad[8:]] + 20.0, -1.0)
    info = (1.0 / 1.2 ** (2.0 * rng.integers(0, 3, O))).astype(np.float32)
    R0 = np.tile(np.eye(3, dtype=np.float32), (M, 1, 1))
    t0 = np.zeros((M, 3), np.float32)
    R0[:n_kf], t0[:n_kf] = Rs, ts
    for k in range(n_fixed, n_kf):
        R0[k] = _rot([0.004, -0.003, 0.002]) @ Rs[k]
        t0[k] += rng.normal(0, 0.02, 3).astype(np.float32)
    p0 = np.zeros((P, 3), np.float32)
    p0[:n_pts] = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    fixed_kf = np.arange(M) < n_fixed
    fixed_kf[n_kf:] = True
    return dict(R=R0, t=t0, points=p0, kf_idx=kf_idx, lm_idx=lm_idx, uv=uv, info=info,
                valid=valid, fixed_kf=fixed_kf, fixed_lm=np.arange(P) >= n_pts,
                u_r=u_r, bf=np.float32(BF)), (Rs, ts, pts)


def _both_problems(p):
    jprob = jba.BAProblem(**{k: jnp.asarray(v) for k, v in p.items()})
    tprob = tba.BAProblem(**{k: torch.from_numpy(np.array(v)) for k, v in p.items()})
    return jprob, tprob._replace(kf_idx=tprob.kf_idx.long(), lm_idx=tprob.lm_idx.long())


def test_ba_normal_equations_with_stereo_rows_match_jax():
    from test_torch_geometry import _cams
    cj, ct = _cams()
    p, _ = _stereo_ba_problem(3)
    jprob, tprob = _both_problems(p)
    ref = jba.ba_normal_equations(jprob, cj, jnp.float32(1e-4))
    got = tba.ba_normal_equations(tprob, ct, torch.tensor(1e-4), tba.segments(tprob))
    for name, a, b in zip(("S", "b_schur", "T", "b_l", "W_o", "empty_lm", "chi2", "w"),
                          got, ref):
        b = np.asarray(b)
        if b.dtype == bool:
            np.testing.assert_array_equal(np_(a), b, err_msg=name)
        else:
            close(a, b, 1e-4)
    _, _, _, chi2 = tba._eval_residuals(tprob, ct)
    assert float(tba._huber_delta(tprob).max()) == pytest.approx(7.815 ** 0.5)


@pytest.mark.parametrize("n_iters", [8, 20])
def test_bundle_adjust_with_stereo_rows_matches_jax(n_iters):
    from test_torch_geometry import _cams
    cj, ct = _cams()
    p, (Rs, ts, pts) = _stereo_ba_problem(5)
    jprob, tprob = _both_problems(p)
    ref, costs_r, out_r = jba.bundle_adjust(jprob, cj, n_iters=n_iters)
    got, costs_t, out_t = tba.bundle_adjust(tprob, ct, n_iters=n_iters)
    np.testing.assert_array_equal(np_(out_t), np.asarray(out_r))
    assert np_(out_t).sum() >= 12  # the planted outliers, mono and stereo
    np.testing.assert_allclose(np_(got.R), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(np_(got.t), np.asarray(ref.t), atol=1e-4)
    np.testing.assert_allclose(np_(got.points), np.asarray(ref.points), atol=1e-3)
    np.testing.assert_allclose(np_(costs_t), np.asarray(costs_r), rtol=1e-3)
    np.testing.assert_allclose(np_(got.t)[:len(ts)], ts, atol=0.02)  # recovered


# --------------------------------------------------------------------------
# the IMU initialization at fixed scale
# --------------------------------------------------------------------------


def test_inertial_only_optimize_fix_scale_matches_jax():
    Rwb, p, ej, et = _gs_problem(1.0)
    kw = dict(prior_gyro=1e2, prior_acc=1e10, fix_scale=True)
    ref = jin.inertial_only_optimize(jnp.asarray(Rwb), jnp.asarray(p), ej, **kw)
    got = tin.inertial_only_optimize(t32(Rwb), t32(p), et, **kw)
    g_ref = np_(ref.Rwg).astype(np.float64) @ np.array([0.0, 0.0, -1.0])
    g_got = np_(got.Rwg).astype(np.float64) @ np.array([0.0, 0.0, -1.0])
    assert np.arctan2(np.linalg.norm(np.cross(g_ref, g_got)), g_ref @ g_got) < 1e-4
    assert float(got.scale) == float(ref.scale) == 1.0
    close(got.bias, ref.bias, 1e-3)
    close(got.v, ref.v, 1e-4)
    np.testing.assert_allclose(float(got.cost), float(ref.cost), rtol=1e-3)


def test_initialize_imu_fix_scale_on_a_converted_map_matches_jax():
    """The first rung of a stereo-inertial map: the re-gauge turns the map
    (gravity) and keeps its scale."""
    jm = _jax_map()
    tm = convert.map_state(jm, device="cpu")
    before = tm.mp_pos[tm.mp_valid].copy()
    out_j = jinit.initialize_imu(jm, JCAL, prior_gyro=1e2, prior_acc=1e10, fix_scale=True)
    out_t = tinit.initialize_imu(tm, TCAL, prior_gyro=1e2, prior_acc=1e10, fix_scale=True,
                                 device="cpu")
    assert (out_j is None) == (out_t is None) is False
    assert float(out_t.scale) == float(out_j.scale) == 1.0
    _check_maps(tm, jm)
    np.testing.assert_allclose(np.linalg.norm(tm.mp_pos[tm.mp_valid], axis=-1),
                               np.linalg.norm(before, axis=-1), rtol=1e-5)


# --------------------------------------------------------------------------
# the map's right coordinates
# --------------------------------------------------------------------------


def test_kf_uright_is_carried_by_convert_grow_and_weld():
    rng = np.random.default_rng(1)
    n = 32
    jm = JMS(JMC(max_keyframes=2, max_points=64, features_per_frame=n))
    ur = np.where(rng.random(n) < 0.5, rng.uniform(0, 600, n), -1.0).astype(np.float32)
    for k in range(2):
        jm.add_keyframe(np.eye(3, dtype=np.float32), np.full(3, k, np.float32), 0.1 * k, k,
                        rng.uniform(0, 600, (n, 2)).astype(np.float32),
                        np.zeros(n, np.int32), np.zeros(n, np.float32),
                        rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32), np.ones(n, bool),
                        np.full(n, -1, np.int32), uright=ur if k else None)
    tm = convert.map_state(jm, device=CPU)
    np.testing.assert_array_equal(tm.kf_uright, jm.kf_uright)
    assert (tm.kf_uright[0] == -1.0).all() and (tm.kf_uright[1] == ur).all()
    tm.grow(max_keyframes=4)  # a tier bump keeps the rows, fills the new ones with -1
    assert tm.kf_uright.shape == (4, n) and (tm.kf_uright[2:] == -1.0).all()
    np.testing.assert_array_equal(tm.kf_uright[:2], jm.kf_uright)
    atlas = Atlas(MapConfig(max_keyframes=4, max_points=64, features_per_frame=n), device=CPU)
    dst = atlas.active_id
    src = atlas.adopt(convert.map_state(jm, device=CPU))
    kf_map = atlas.weld(dst, src, 1.0, np.eye(3), np.zeros(3))
    assert sorted(kf_map) == [0, 1]
    for s_k, d_k in kf_map.items():
        np.testing.assert_array_equal(atlas.maps[dst].kf_uright[d_k], jm.kf_uright[s_k])
