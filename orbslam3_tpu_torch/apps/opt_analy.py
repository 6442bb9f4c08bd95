"""Offline acoustic + IMU fusion analysis harness.

Port of `apps/opt_analy.py` (the ORB-SLAM3 fork's Examples/
imu_acoustic_opt_analy.cc): simulated trajectories, ranges and IMU deltas
through the fork's acoustic optimizers (`edge/acoustic.py`, on the card
unless --device cpu), reporting the position error of each mode. The draws
come from one seeded generator in the JAX app's order (scipy's
`Rotation.random` included), so the two print the same scene.

Modes:
  pos        PoseOptimizationDistanceGivenScale: position from ranges
  regu       PoseOptimizationDistanceRegu: + previous-position regularizer
  imu        IMUAcousticOptimization: ranges + IMU relative-motion factors
  key        IMUAcousticKeyOptimization: keyed variant over a window
  calib      CalibOptimization: solve mic offset t_mc + metric scale

Usage:

    python -m orbslam3_tpu_torch.apps.opt_analy [--mode all] [--noise 0.03] [--n 40]
        [--seed 0] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def analyse(mode: str = 'all', noise: float = 0.03, n: int = 40, seed: int = 0,
            device=None) -> dict:
    """{mode: mean position error (m)} and, for 'calib', {t_mc_err,
    scale_err}."""
    from orbslam3_tpu_torch.edge import acoustic

    def host(x):
        return x.detach().cpu().numpy()

    rng = np.random.default_rng(seed)
    # simulated scene: 3 anchor devices + a walking user
    anchors = np.asarray([[0, 0, 0], [3.0, 0, 0.2], [1.5, 2.5, -0.1]], np.float32)
    t = np.linspace(0, 2 * np.pi, n)
    traj = np.stack([1.5 + 1.0 * np.cos(t), 1.2 + 0.8 * np.sin(t),
                     0.1 * np.sin(2 * t)], -1).astype(np.float32)

    def ranges(p):
        d = np.linalg.norm(anchors - p, axis=1)
        return (d + rng.normal(0, noise, d.shape)).astype(np.float32)

    report = {}
    if mode in ('all', 'pos'):
        errs = []
        for p in traj:
            est = host(acoustic.optimize_position_given_scale(
                p + rng.normal(0, 0.3, 3).astype(np.float32), anchors, ranges(p), 1.0,
                device=device))
            errs.append(np.linalg.norm(est - p))
        report['pos'] = float(np.mean(errs))
    if mode in ('all', 'regu'):
        errs = []
        prev = traj[0]
        for p in traj:
            est = host(acoustic.optimize_position_regularized(
                p + rng.normal(0, 0.3, 3).astype(np.float32), prev, anchors, ranges(p), 1.0,
                device=device))
            errs.append(np.linalg.norm(est - p))
            prev = est
        report['regu'] = float(np.mean(errs))
    if mode in ('all', 'imu'):
        W = 6
        errs = []
        for i in range(W, len(traj)):
            chain = traj[i - W:i + 1]
            dp = np.zeros_like(chain)
            dp[1:] = np.diff(chain, axis=0) + rng.normal(0, 0.01, (W, 3)).astype(np.float32)
            est = host(acoustic.imu_acoustic_optimize(
                chain + rng.normal(0, 0.2, chain.shape).astype(np.float32),
                dp.astype(np.float32), anchors, ranges(chain[-1]), 1.0, device=device))
            errs.append(np.linalg.norm(est[-1] - chain[-1]))
        report['imu'] = float(np.mean(errs))
    if mode in ('all', 'key'):
        W = 5
        errs = []
        for i in range(W, len(traj)):
            dps = np.diff(traj[i - W:i + 1], axis=0).astype(np.float32)
            dps += rng.normal(0, 0.01, dps.shape).astype(np.float32)
            # ranges are drawn at all W + 1 poses, as the JAX app draws
            # them, but the optimizer takes those of poses 1..W (the first
            # is fixed); the JAX app hands it all W + 1 and raises
            ds = np.stack([ranges(p) for p in traj[i - W:i + 1]])
            est = host(acoustic.imu_acoustic_key_optimize(
                traj[i - W:i + 1] + rng.normal(0, 0.2, (W + 1, 3)).astype(np.float32),
                dps, ds[1:], anchors, 1.0, device=device))
            errs.append(np.linalg.norm(est[-1] - traj[i]))
        report['key'] = float(np.mean(errs))
    if mode in ('all', 'calib'):
        # mic offset + scale recovery (the fork's CalibOptimization)
        from scipy.spatial.transform import Rotation
        t_mc_true = np.asarray([0.05, -0.02, 0.08], np.float32)
        s_true = 1.7
        K, M = 20, 3
        R0 = Rotation.random(K, rng).as_matrix().astype(np.float32)
        t0s = rng.uniform(-2, 2, (K, 3)).astype(np.float32)
        R_others = Rotation.random(M, rng).as_matrix().astype(np.float32)
        t_others = rng.uniform(-2, 2, (M, 3)).astype(np.float32)
        wm0 = np.einsum('kij,j->ki', R0, -s_true * t_mc_true) + t0s
        wm1 = np.einsum('mij,j->mi', R_others, -s_true * t_mc_true) + t_others
        d = (np.linalg.norm(wm0[:, None] - wm1[None, :], axis=-1) / s_true
             + rng.normal(0, noise, (K, M)))
        t_mc, s = acoustic.calibrate_mic_offset(
            np.zeros(3, np.float32), 1.0, R0, t0s, R_others, t_others, d.astype(np.float32),
            n_iters=30, device=device)
        report['calib'] = dict(t_mc_err=float(np.linalg.norm(host(t_mc) - t_mc_true)),
                               scale_err=abs(float(s) - s_true) / s_true)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--mode', default='all', choices=['all', 'pos', 'regu', 'imu', 'key', 'calib'])
    ap.add_argument('--noise', type=float, default=0.03,
                    help='range noise sigma [m] (acoustic ~3 cm)')
    ap.add_argument('--n', type=int, default=40, help='trajectory length')
    ap.add_argument('--seed', type=int, default=0)
    from orbslam3_tpu_torch.apps.common import add_device_arg
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from orbslam3_tpu_torch import device as device_policy
    report = analyse(args.mode, args.noise, args.n, args.seed,
                     device=device_policy.resolve(args.device))
    print('\n== acoustic fusion analysis ==')
    for k, v in report.items():
        if isinstance(v, dict):
            print(f'{k:6s}: ' + ', '.join(f'{a}={b:.4f}' for a, b in v.items()))
        else:
            print(f'{k:6s}: mean position error {v * 100:.1f} cm')
    return 0


if __name__ == '__main__':
    sys.exit(main())
