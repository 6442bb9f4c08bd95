"""The camera's path and its 200 Hz IMU: an excited orbit swept back and
forth over an arc.

Frozen copy of `orbslam3_tpu_torch/datasets/render.py:excited_trajectory`
(its 'center' gaze) and of `vi_sequence`'s IMU layout, with one change:
the orbit angle does not run once over the arc in a clip's length but
sweeps over it at `rate` rad/s, turning at each end, so a stream of any
length stays in the mapped area. The turns are the triangle wave smoothed
by a Gaussian of `turn_s` seconds, so the path stays smooth for the IMU.
The 1.4-2.6 Hz shake (translation and rotation) that makes scale and
gravity observable is as there, drawn from seed + 77; the IMU noise
(2e-4 rad/s, 2e-3 m/s^2) from seed + 5; timestamps from 100 s, one IMU
sample 5 ms before the first frame. The IMU rides on the body, whose
pose in the camera's is given by the configuration's `T_b_c` (x_b =
R_bc x_c + t_bc, the settings' `IMU.T_b_c1`); the identity puts the body
on the camera, as `vi_sequence` does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.spatial.transform import Rotation

G = 9.81
T0 = 100.0


@dataclasses.dataclass
class Motion:
    R_cw: np.ndarray      # (F,3,3) world->camera at the frames
    t_cw: np.ndarray      # (F,3)
    v_w: np.ndarray       # (F,3) the body's (the IMU's) velocity in the world
    frame_ts: np.ndarray  # (F,) seconds
    imu_ts: np.ndarray    # (K,) seconds, each sample stamped at its interval's end
    gyro: np.ndarray      # (K,3) rad/s, body, with noise
    acc: np.ndarray       # (K,3) m/s^2, body, with noise


def sweep_angle(t: np.ndarray, arc: float, rate: float, turn_s: float,
                imu_rate: float) -> np.ndarray:
    """Orbit angle at times t (a uniform grid from 0): from -arc/2 forward at
    `rate` rad/s, folded back at +-arc/2, the folds smoothed."""
    sigma = max(int(round(turn_s * imu_rate)), 1)
    pad = 4 * sigma
    n = len(t)
    tt = (np.arange(-pad, n + pad) / imu_rate)
    u = rate * tt
    per = np.mod(u, 2 * arc)
    tri = np.where(u < 0, u, arc - np.abs(per - arc))
    k = np.exp(-0.5 * (np.arange(-pad, pad + 1) / sigma) ** 2)
    smooth = np.convolve(tri, k / k.sum(), mode="valid")
    return smooth[:n] - arc / 2


def make_motion(n_frames: int, seed: int, fps: float, imu_rate: float, center,
                radius: float, arc: float, rate: float, excitation: float,
                rot_excitation: float, turn_s: float, T_b_c=None) -> Motion:
    rng = np.random.default_rng(seed + 77)
    stride = int(round(imu_rate / fps))
    n_dense = n_frames * stride + 1
    t = np.arange(n_dense) / imu_rate
    th = sweep_angle(t, arc, rate, turn_s, imu_rate)
    cx, cy, cz = center
    C = np.stack([cx + radius * np.sin(th), cy + 0.4 * np.sin(2 * th),
                  cz - radius * np.cos(th)], axis=-1)
    freqs = rng.uniform(1.4, 2.6, 3)
    phases = rng.uniform(0, 2 * np.pi, 3)
    for ax in range(3):
        C[:, ax] += excitation * np.sin(2 * np.pi * freqs[ax] * t + phases[ax])
    look = np.asarray(center, np.float64)[None] - C
    z = look / np.linalg.norm(look, axis=1, keepdims=True)
    x = np.cross(np.broadcast_to(np.array([0.0, 1.0, 0.0]), z.shape), z)
    x = x / np.linalg.norm(x, axis=1, keepdims=True)
    y = np.cross(z, x)
    R_wc = np.stack([x, y, z], axis=-1)
    if rot_excitation > 0:
        rfreqs = rng.uniform(0.9, 1.9, 3)
        rphases = rng.uniform(0, 2 * np.pi, 3)
        ang = rot_excitation * np.sin(2 * np.pi * rfreqs[None, :] * t[:, None]
                                      + rphases[None, :])
        R_wc = R_wc @ Rotation.from_rotvec(ang).as_matrix()
    R_cw = np.swapaxes(R_wc, 1, 2)
    t_cw = -np.einsum("kij,kj->ki", R_cw, C)

    # the body: R_wb = R_wc R_bc^T, its origin at the camera's -R_bc^T t_bc
    R_bc, t_bc = np.eye(3), np.zeros(3)
    if T_b_c is not None:
        T = np.asarray(T_b_c, np.float64).reshape(4, 4)
        U, _, Vt = np.linalg.svd(T[:3, :3])     # the nearest rotation
        R_bc, t_bc = U @ Vt, T[:3, 3]
    R_wb = R_wc @ R_bc.T
    C_b = C + R_wc @ (-R_bc.T @ t_bc)

    dt = 1.0 / imu_rate
    g_w = np.array([0.0, 0.0, -G])
    a_w = (C_b[2:] - 2 * C_b[1:-1] + C_b[:-2]) / (dt * dt)
    K = n_dense - 1
    Rel = np.einsum("kji,kjl->kil", R_wb[:-1], R_wb[1:])
    gyro = Rotation.from_matrix(Rel).as_rotvec() / dt
    a_mid = np.empty((K, 3))
    a_mid[1:-1] = 0.5 * (a_w[:-1] + a_w[1:])
    a_mid[0] = a_w[0]
    a_mid[-1] = a_w[-1]
    acc = np.einsum("kji,kj->ki", R_wb[:-1], a_mid - g_w[None])
    v = np.gradient(C_b, dt, axis=0)
    idx = np.arange(n_frames) * stride

    nrng = np.random.default_rng(seed + 5)
    gyro = gyro + nrng.normal(0, 2e-4, gyro.shape)
    acc = acc + nrng.normal(0, 2e-3, acc.shape)
    imu_ts = np.concatenate([[T0 - 0.005], T0 + t[1:]])
    gyro = np.concatenate([gyro[:1], gyro])
    acc = np.concatenate([acc[:1], acc])
    return Motion(R_cw=R_cw[idx], t_cw=t_cw[idx], v_w=v[idx],
                  frame_ts=T0 + np.arange(n_frames) / fps, imu_ts=imu_ts, gyro=gyro, acc=acc)


def imu_batches(frame_ts, imu_ts, gyro, acc) -> list[list]:
    """Per frame the (ts, gyro(3,), acc(3,)) samples in (frame_ts[i-1],
    frame_ts[i]], all samples up to the first frame for frame 0
    (render.py's `imu_batches`)."""
    out, j, prev = [], 0, -np.inf
    for t1 in frame_ts:
        batch = []
        while j < len(imu_ts) and imu_ts[j] <= t1:
            if imu_ts[j] > prev:
                batch.append((float(imu_ts[j]), gyro[j], acc[j]))
            j += 1
        prev = t1
        out.append(batch)
    return out
