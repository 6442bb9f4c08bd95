"""The traffic generators: deterministic per seed, and the frozen copies
held to the port's originals they were copied from."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from harness import landmarks, motion, scene

INTR = (114.66, 114.32, 91.80, 62.09)   # EuRoC cam0 at a quarter
W, H = 188, 120
ORBIT = dict(fps=20.0, imu_rate=200.0, center=(0.0, 0.0, 8.0), radius=3.0, arc=1.0,
             excitation=0.05, rot_excitation=0.06, turn_s=0.3)


def _motion(seed, n=60, rate=1.0 / 6.0):
    return motion.make_motion(n, seed, rate=rate, **ORBIT)


def _render(seed, mo, noise=1.5):
    tex = torch.as_tensor(scene.box_textures(seed, 128))
    gen = torch.Generator().manual_seed(seed)
    return scene.render(tex, INTR, torch.as_tensor(mo.R_cw[:4]), torch.as_tensor(mo.t_cw[:4]),
                        W, H, noise, gen)


def _features(seed, mo):
    field = landmarks.make_field(3000, seed + 11)
    gen = torch.Generator().manual_seed(seed)
    return landmarks.frame_features(field, mo.R_cw[:6], mo.t_cw[:6], INTR, W, H, 300, 0.4,
                                    10, 0.15, 40, gen, "cpu")


@pytest.mark.parametrize("make", ["motion", "render", "features"])
def test_generators_are_deterministic_per_seed(make):
    def gen(seed):
        mo = _motion(seed)
        if make == "motion":
            return [mo.R_cw, mo.t_cw, mo.gyro, mo.acc, mo.v_w]
        if make == "render":
            return [_render(seed, mo).numpy()]
        return list(_features(seed, mo))
    a, b, c = gen(2**31 + 7), gen(2**31 + 7), gen(2**31 + 8)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))


def test_textures_and_render_match_the_ports_renderer():
    from orbslam3_tpu_torch.datasets import render
    seed = 5
    box = render.BoxScene.default(seed=seed, tex_size=128)
    tex = scene.box_textures(seed, 128)
    assert all(np.array_equal(a, b) for a, b in zip(box.textures, tex))
    mo = _motion(seed)
    K = np.array([[INTR[0], 0, INTR[2]], [0, INTR[1], INTR[3]], [0, 0, 1.0]])
    ours = scene.render(torch.as_tensor(tex), INTR, torch.as_tensor(mo.R_cw[:3]),
                        torch.as_tensor(mo.t_cw[:3]), W, H, noise_std=0.0).numpy()
    for i in range(3):
        ref = box.render(K, mo.R_cw[i], mo.t_cw[i], W, H, noise_std=0.0)
        diff = np.abs(ref.astype(int) - ours[i].astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


def test_motion_matches_excited_trajectory_before_the_first_turn():
    """Over its first pass, the sweep is `vi_sequence`'s orbit and IMU: the
    same rate (arc over the clip), shake, gravity and noise."""
    from orbslam3_tpu_torch.datasets import render
    n, seed = 120, 3
    ref = render.vi_sequence(n_frames=n, seed=seed, render=False)
    mo = _motion(seed, n=n, rate=1.0 / 6.0)
    keep = 80   # frames well before the fold at frame 120, which the Gaussian smooths
    np.testing.assert_allclose(mo.R_cw[:keep], ref.R_cw[:keep], atol=1e-12)
    np.testing.assert_allclose(mo.t_cw[:keep], ref.t_cw[:keep], atol=1e-12)
    np.testing.assert_allclose(mo.frame_ts[:keep], ref.frame_ts[:keep])
    k = keep * 10
    np.testing.assert_allclose(mo.imu_ts[:k], ref.imu_ts[:k])
    np.testing.assert_allclose(mo.gyro[:k], ref.gyro[:k], atol=1e-9)
    np.testing.assert_allclose(mo.acc[:k], ref.acc[:k], atol=1e-7)


def test_sweep_stays_on_the_arc_and_turns_smoothly():
    t = np.arange(0, 40, 1 / 200)
    th = motion.sweep_angle(t, arc=1.0, rate=1.0 / 6.0, turn_s=0.3, imu_rate=200.0)
    assert th.min() >= -0.5 - 1e-9 and th.max() <= 0.5 + 1e-9
    acc = np.diff(th, 2) * 200 ** 2
    assert np.abs(acc).max() < 0.6          # rad/s^2: no jump in the angular rate


def test_features_hold_projections_of_the_field():
    mo = _motion(9)
    field = landmarks.make_field(3000, 20)
    gen = torch.Generator().manual_seed(1)
    uv, desc, count = landmarks.frame_features(field, mo.R_cw[:2], mo.t_cw[:2], INTR, W, H,
                                               300, 0.0, 0, 0.0, 40, gen, "cpu")
    xc = field.points @ mo.R_cw[0].T + mo.t_cw[0]
    u = INTR[0] * xc[:, 0] / xc[:, 2] + INTR[2]
    v = INTR[1] * xc[:, 1] / xc[:, 2] + INTR[3]
    n_obs = count[0] - 40
    for j in range(n_obs):     # each landmark row sits on a landmark with its descriptor
        i = np.argmin((u - uv[0, j, 0]) ** 2 + (v - uv[0, j, 1]) ** 2)
        assert abs(u[i] - uv[0, j, 0]) < 1e-3 and np.array_equal(field.desc[i], desc[0, j])
    small_uv, small_desc = landmarks.packet_arrays(uv, desc, count, 0, 100, 40)
    assert len(small_uv) == 100 and np.array_equal(small_desc[-40:], desc[0, n_obs:n_obs + 40])


EUROC_T_B_C = json.loads((Path(__file__).resolve().parents[1] / "configs"
                          / "euroc_mono_inertial.json").read_text())["imu"]["T_b_c1"]
EUROC_DIST = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05)


def test_distorted_render_matches_the_ports_renderer():
    """Through EuRoC's rad-tan distortion, as `render.py` renders a raw
    pinhole camera."""
    from orbslam3_tpu_torch.datasets import render
    seed = 6
    box = render.BoxScene.default(seed=seed, tex_size=128)
    tex = torch.as_tensor(scene.box_textures(seed, 128))
    mo = _motion(seed)
    K = np.array([[INTR[0], 0, INTR[2]], [0, INTR[1], INTR[3]], [0, 0, 1.0]])
    cam = render._render_camera(INTR, EUROC_DIST, W, H)
    ours = scene.render(tex, INTR, torch.as_tensor(mo.R_cw[:2]), torch.as_tensor(mo.t_cw[:2]),
                        W, H, noise_std=0.0, dist=EUROC_DIST).numpy()
    plain = scene.render(tex, INTR, torch.as_tensor(mo.R_cw[:1]), torch.as_tensor(mo.t_cw[:1]),
                         W, H, noise_std=0.0).numpy()
    for i in range(2):
        ref = box.render(K, mo.R_cw[i], mo.t_cw[i], W, H, noise_std=0.0, camera=cam)
        diff = np.abs(ref.astype(int) - ours[i].astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    assert (plain[0] != ours[0]).mean() > 0.3    # the distortion moves most pixels


def test_body_frame_imu_carries_the_camera_along():
    """The IMU in EuRoC's body frame (`T_b_c1`): integrated from the body's
    true state, it brings the camera to its true pose a second later."""
    mo = motion.make_motion(40, 4, rate=1.0 / 6.0, T_b_c=EUROC_T_B_C, **ORBIT)
    T = np.asarray(EUROC_T_B_C)
    U, _, Vt = np.linalg.svd(T[:3, :3])
    R_bc, t_bc = U @ Vt, T[:3, 3]
    f0, f1, stride, dt = 5, 25, 10, 1.0 / 200.0
    R = mo.R_cw[f0].T @ R_bc.T
    p = -mo.R_cw[f0].T @ mo.t_cw[f0] + mo.R_cw[f0].T @ (-R_bc.T @ t_bc)
    v = mo.v_w[f0].copy()
    g = np.array([0.0, 0.0, -motion.G])
    for i in range(f0 * stride + 1, f1 * stride + 1):    # sample i covers (t[i-1], t[i]]
        a = R @ mo.acc[i] + g
        p, v = p + v * dt + 0.5 * a * dt * dt, v + a * dt
        R = R @ Rotation.from_rotvec(mo.gyro[i] * dt).as_matrix()
    R_wc, c = R @ R_bc, p + R @ t_bc
    np.testing.assert_allclose(c, -mo.R_cw[f1].T @ mo.t_cw[f1], atol=0.01)
    assert np.degrees(Rotation.from_matrix(R_wc @ mo.R_cw[f1]).magnitude()) < 0.1
    # the same path with the body on the camera differs in the IMU's axes
    cam = motion.make_motion(40, 4, rate=1.0 / 6.0, **ORBIT)
    np.testing.assert_allclose(mo.R_cw, cam.R_cw)
    assert np.abs(mo.acc - cam.acc).max() > 5.0
