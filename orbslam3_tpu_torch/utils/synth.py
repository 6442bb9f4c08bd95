"""Synthetic SLAM sequences for tests and the card's smoke run.

Port of the numpy parts of `orbslam3_tpu/utils/synth.py`: a persistent 3-D
landmark field with per-landmark 256-bit descriptors (`make_world`), an
orbit trajectory (`orbit_trajectory`), and per-frame `FrameFeatures`
synthesized from the field with pixel noise, bit flips, dropout and
distractors (`render_features`), and the IMU generators: finite-difference
samples along a pose sequence (`imu_orbit_samples`) and an exact float64
integration of analytic body rates (`simulate_imu`, `ImuTrajectory`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orbslam3_tpu_torch import device as device_policy
from orbslam3_tpu_torch.kernels.orb_descriptor import pack_bits
from orbslam3_tpu_torch.vision.frame import FrameFeatures


@dataclasses.dataclass
class SynthWorld:
    points: np.ndarray        # (P,3) landmark positions
    desc_bits: np.ndarray     # (P,256) uint8 canonical descriptors
    rng: np.random.Generator
    scale_d0: np.ndarray = None   # (P,) per-landmark scale-anchor distance


def make_world(n_points=2000, box=((-8, 8), (-5, 5), (2, 14)), seed=0,
               min_center_dist: float = 0.0) -> SynthWorld:
    """`min_center_dist` > 0 rejects landmarks closer than that to the box
    center. A trajectory that passes THROUGH its landmark field sweeps
    per-point viewing-distance ratios beyond any 8-level/1.2x pyramid's
    scale-invariance span (1.2^8 = 4.3x) — such points are legitimately
    unmatchable across the pass in the reference too. Long-duration orbit
    fixtures (the capacity soak) keep the field outside the orbit's near
    zone, like real indoor datasets where the camera doesn't fly through
    the furniture."""
    rng = np.random.default_rng(seed)
    center_np = np.array([(b[0] + b[1]) / 2.0 for b in box], np.float32)
    pts = np.zeros((0, 3), np.float32)
    while len(pts) < n_points:
        cand = np.stack(
            [rng.uniform(*box[i], n_points) for i in range(3)], axis=-1
        ).astype(np.float32)
        if min_center_dist > 0:
            cand = cand[np.linalg.norm(cand - center_np, axis=1)
                        >= min_center_dist]
        pts = np.concatenate([pts, cand])[:n_points]
    bits = rng.integers(0, 2, (n_points, 256)).astype(np.uint8)
    # Physical scale model: each landmark has a fixed apparent size, so the
    # pyramid level it is detected at follows its viewing DISTANCE —
    # level = ceil(log(d0/d)/log 1.2), the exact relation the matcher's
    # PredictScale / scale-band gates assume (MapPoint::PredictScale).
    # d0 = distance at which the landmark would appear at the COARSEST
    # level, anchored to the world center so center-orbiting views (the
    # standard fixture trajectory, radius <= 3) span levels 0..7 without
    # saturating the clip.
    d0 = (np.linalg.norm(pts - center_np, axis=1) + 3.2).astype(np.float32)
    return SynthWorld(points=pts, desc_bits=bits, rng=rng, scale_d0=d0)


def orbit_trajectory(n_frames=120, radius=3.0, height=0.4, center=(0, 0, 8.0),
                     arc=1.2, forward_axis=2):
    """Camera orbit segment looking at `center`. Returns (R_cw, t_cw) lists
    (world->camera poses)."""
    Rs, ts = [], []
    cx, cy, cz = center
    for i in range(n_frames):
        a = arc * i / max(n_frames - 1, 1) - arc / 2
        cam_pos = np.array(
            [cx + radius * np.sin(a), cy + height * np.sin(2 * a), cz - radius * np.cos(a)],
            np.float32,
        )
        # look-at: z-axis towards center
        z = np.asarray(center, np.float32) - cam_pos
        z = z / np.linalg.norm(z)
        x = np.cross(np.array([0.0, 1.0, 0.0], np.float32), z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R_wc = np.stack([x, y, z], axis=-1)  # columns = camera axes in world
        R_cw = R_wc.T
        t_cw = -R_cw @ cam_pos
        Rs.append(R_cw.astype(np.float32))
        ts.append(t_cw.astype(np.float32))
    return np.stack(Rs), np.stack(ts)


def render_features(
    world: SynthWorld,
    R_cw: np.ndarray, t_cw: np.ndarray,
    camera,
    capacity: int = 600,
    noise_px: float = 0.4,
    bit_flips: int = 10,
    dropout: float = 0.15,
    n_distractors: int = 40,
    seed: int = 0,
    device=None,
):
    """Synthesize one frame's FrameFeatures (on `device`, the card unless
    ``device="cpu"``) and its ground-truth landmark ids."""
    dev = device_policy.resolve(device)
    rng = np.random.default_rng(seed)
    xc = world.points @ R_cw.T + t_cw
    uv = camera.to("cpu").project(torch.as_tensor(xc, dtype=torch.float32)).numpy()
    w, h = camera.width, camera.height
    vis = (
        (xc[:, 2] > 0.3)
        & (uv[:, 0] >= 8) & (uv[:, 0] < w - 8)
        & (uv[:, 1] >= 8) & (uv[:, 1] < h - 8)
    )
    vis &= rng.uniform(size=len(vis)) > dropout
    ids = np.nonzero(vis)[0]
    rng.shuffle(ids)
    ids = ids[: capacity - n_distractors]
    n = len(ids)

    uv_obs = uv[ids] + rng.normal(scale=noise_px, size=(n, 2))
    bits = world.desc_bits[ids].copy()
    flips = rng.integers(0, 256, (n, bit_flips))
    for k in range(bit_flips):
        bits[np.arange(n), flips[:, k]] ^= 1
    # distance-consistent pyramid level (see make_world scale model)
    if world.scale_d0 is not None:
        d = np.linalg.norm(xc[ids], axis=1)
        oct_obs = np.ceil(np.log(np.maximum(world.scale_d0[ids], 1e-6)
                                 / np.maximum(d, 1e-6)) / np.log(1.2))
        oct_obs = np.clip(oct_obs, 0, 7).astype(np.int32)
    else:
        oct_obs = np.zeros(n, np.int32)

    n_d = min(n_distractors, capacity - n)
    uv_dis = np.stack(
        [rng.uniform(0, w, n_d), rng.uniform(0, h, n_d)], axis=-1
    )
    bits_dis = rng.integers(0, 2, (n_d, 256)).astype(np.uint8)

    total = n + n_d
    uv_all = np.zeros((capacity, 2), np.float32)
    uv_all[:n] = uv_obs
    uv_all[n:total] = uv_dis
    bits_all = np.zeros((capacity, 256), np.uint8)
    bits_all[:n] = bits
    bits_all[n:total] = bits_dis
    gt_ids = np.full(capacity, -1, np.int64)
    gt_ids[:n] = ids
    valid = np.zeros(capacity, bool)
    valid[:total] = True

    packed = pack_bits(torch.from_numpy(bits_all))
    oct_all = np.zeros(capacity, np.int32)
    oct_all[:n] = oct_obs
    uv_t = torch.from_numpy(uv_all).to(dev)
    feats = FrameFeatures(
        uv=uv_t, uv_raw=uv_t.clone(),
        response=torch.from_numpy(valid.astype(np.float32)).to(dev),
        angle=torch.zeros(capacity, dtype=torch.float32, device=dev),
        octave=torch.from_numpy(oct_all).to(dev),
        desc=packed.to(dev),
        valid=torch.from_numpy(valid).to(dev),
    )
    return feats, gt_ids


def imu_orbit_samples(R_cw, t_cw, ts, rate=200.0, g=9.81, seed=0,
                      gyro_noise=0.0, acc_noise=0.0, gyro_bias=None, acc_bias=None):
    """Finite-difference IMU samples consistent with a camera pose sequence
    (body == camera frame). Returns a list of per-interval (acc, gyro, dt)
    float32 arrays."""
    from orbslam3_tpu_torch.core import lie
    rng = np.random.default_rng(seed)
    R_wb = np.swapaxes(R_cw, -1, -2)
    p_wb = -np.einsum("nij,nj->ni", R_wb, t_cw)
    out = []
    g_w = np.array([0.0, 0.0, -g])
    for i in range(len(ts) - 1):
        t0, t1 = ts[i], ts[i + 1]
        n = max(int(round((t1 - t0) * rate)), 2)
        tau = np.linspace(t0, t1, n + 1)
        # angular velocity (body): log(R_wb_i^T R_wb_{i+1}) / dt, in f32
        dR = R_wb[i].T @ R_wb[i + 1]
        w_b = lie.so3_log(torch.from_numpy(dR.astype(np.float32))).numpy() / (t1 - t0)
        # acceleration by central differences of position
        if 0 < i < len(ts) - 2:
            dt = ts[i + 1] - ts[i]
            a_w = (p_wb[i + 2] - p_wb[i + 1] - p_wb[i] + p_wb[i - 1]) / (2 * dt * dt)
        else:
            a_w = np.zeros(3)
        acc_b = R_wb[i].T @ (a_w - g_w)
        acc = np.tile(acc_b, (n, 1))
        gyr = np.tile(w_b, (n, 1))
        if gyro_noise > 0:
            gyr = gyr + rng.normal(scale=gyro_noise, size=gyr.shape)
        if acc_noise > 0:
            acc = acc + rng.normal(scale=acc_noise, size=acc.shape)
        if gyro_bias is not None:
            gyr = gyr + gyro_bias
        if acc_bias is not None:
            acc = acc + acc_bias
        out.append((acc.astype(np.float32), gyr.astype(np.float32),
                    np.diff(tau).astype(np.float32)))
    return out


@dataclasses.dataclass
class ImuTrajectory:
    """Ground-truth body trajectory and IMU samples from analytic body
    rates. States are at the sample times (R_wb[k] at t[k]); samples are
    per interval [t[k], t[k+1]], taken at its midpoint."""

    t: np.ndarray       # (K+1,) sample times
    R_wb: np.ndarray    # (K+1,3,3) body->world rotations
    p_wb: np.ndarray    # (K+1,3) body positions (world)
    v_wb: np.ndarray    # (K+1,3) body velocities (world)
    gyro: np.ndarray    # (K,3) measured angular rate (body) incl. bias
    acc: np.ndarray     # (K,3) measured specific force (body) incl. bias
    dt: np.ndarray      # (K,)

    def gt_deltas(self, i: int, j: int, g=9.81):
        """Exact preintegration deltas between sample times i < j."""
        g_w = np.array([0.0, 0.0, -g])
        dT = self.t[j] - self.t[i]
        Ri = self.R_wb[i]
        dR = Ri.T @ self.R_wb[j]
        dV = Ri.T @ (self.v_wb[j] - self.v_wb[i] - g_w * dT)
        dP = Ri.T @ (self.p_wb[j] - self.p_wb[i] - self.v_wb[i] * dT
                     - 0.5 * g_w * dT * dT)
        return dR, dV, dP, dT


def simulate_imu(duration=2.0, rate=200.0, substeps=40, seed=0, g=9.81,
                 gyro_bias=(0.0, 0.0, 0.0), acc_bias=(0.0, 0.0, 0.0),
                 gyro_noise=0.0, acc_noise=0.0,
                 w_scale=0.6, f_scale=1.2) -> ImuTrajectory:
    """Integrate smooth analytic body rates in float64. The rates are sums
    of seeded incommensurate sinusoids; f_b is the specific force in the
    body frame, so the world acceleration is R_wb f_b + g_w."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    aw = rng.uniform(0.5, 2.0, (3, 2))
    ph = rng.uniform(0, 2 * np.pi, (3, 4))

    def w_fn(t):
        return w_scale * np.array([
            np.sin(aw[0, 0] * t + ph[0, 0]) + 0.5 * np.cos(aw[0, 1] * t + ph[0, 1]),
            np.sin(aw[1, 0] * t + ph[1, 0]) + 0.5 * np.cos(aw[1, 1] * t + ph[1, 1]),
            np.sin(aw[2, 0] * t + ph[2, 0]),
        ])

    def f_fn(t):
        return f_scale * np.array([
            np.sin(aw[0, 1] * t + ph[0, 2]),
            np.cos(aw[1, 1] * t + ph[1, 2]),
            np.sin(aw[2, 1] * t + ph[2, 3]),
        ]) + np.array([0.0, 0.0, g])  # roughly gravity-supporting

    K = int(round(duration * rate))
    h = 1.0 / (rate * substeps)
    g_w = np.array([0.0, 0.0, -g])
    R, p, v, t_cur = np.eye(3), np.zeros(3), np.zeros(3), 0.0
    states_t, states_R, states_p, states_v = [0.0], [R.copy()], [p.copy()], [v.copy()]
    gyro_s, acc_s, dt_s = [], [], []
    bg = np.asarray(gyro_bias, np.float64)
    ba = np.asarray(acc_bias, np.float64)
    for _ in range(K):
        t_mid_sample = t_cur + 0.5 / rate
        gyro_s.append(w_fn(t_mid_sample) + bg + rng.normal(scale=gyro_noise, size=3))
        acc_s.append(f_fn(t_mid_sample) + ba + rng.normal(scale=acc_noise, size=3))
        dt_s.append(1.0 / rate)
        for _ in range(substeps):
            tm = t_cur + 0.5 * h
            w = w_fn(tm)
            f = f_fn(tm)
            R_mid = R @ Rotation.from_rotvec(w * 0.5 * h).as_matrix()
            a_w = R_mid @ f + g_w
            p = p + v * h + 0.5 * a_w * h * h
            v = v + a_w * h
            R = R @ Rotation.from_rotvec(w * h).as_matrix()
            t_cur += h
        states_t.append(t_cur)
        states_R.append(R.copy())
        states_p.append(p.copy())
        states_v.append(v.copy())
    return ImuTrajectory(
        t=np.asarray(states_t), R_wb=np.asarray(states_R),
        p_wb=np.asarray(states_p), v_wb=np.asarray(states_v),
        gyro=np.asarray(gyro_s), acc=np.asarray(acc_s), dt=np.asarray(dt_s))
