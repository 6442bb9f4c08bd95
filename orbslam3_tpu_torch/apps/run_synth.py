"""Synthetic-sequence SLAM run: the smoke-test app.

Port of `apps/run_synth.py` (the pattern of ORB-SLAM3's Examples/
Monocular/mono_euroc.cc: load frames -> per-frame track -> save trajectory
-> evaluate) on the synthetic feature-level world, so it runs with no data.
Prints per-frame tracking state and the final scale-aligned ATE.

Usage:

    python -m orbslam3_tpu_torch.apps.run_synth [--frames N] [--features N]
        [--save-tum out.txt] [--device cpu]

The card is the default device.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def run(argv=None) -> dict:
    """The run; returns {"rc", "slam", "ate"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--frames', type=int, default=60)
    ap.add_argument('--features', type=int, default=600)
    ap.add_argument('--save-tum', default='')
    from orbslam3_tpu_torch.apps.common import add_device_arg
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from orbslam3_tpu_torch import device as device_policy
    from orbslam3_tpu_torch.core.camera import Camera
    from orbslam3_tpu_torch.engine.system import Slam, SystemConfig
    from orbslam3_tpu_torch.engine.tracking import TrackerConfig
    from orbslam3_tpu_torch.evaluation import ate_rmse
    from orbslam3_tpu_torch.place.vocab import build_vocabulary
    from orbslam3_tpu_torch.slam_map.map_state import MapConfig
    from orbslam3_tpu_torch.utils import synth

    dev = device_policy.resolve(args.device)
    cam = Camera.pinhole(458., 458., 320., 240., width=640, height=480, device=dev)
    world = synth.make_world(n_points=3000, seed=2)
    R_gt, t_gt = synth.orbit_trajectory(n_frames=args.frames, radius=3.0, arc=1.0)
    vocab = build_vocabulary(
        np.packbits(world.desc_bits, axis=1).view(np.uint32).reshape(-1, 8),
        k=6, depth=3, seed=0)
    slam = Slam(cam, SystemConfig(map=MapConfig(max(64, args.frames), 8192, args.features),
                                  tracker=TrackerConfig(n_features=args.features)),
                vocab=vocab, device=dev)

    ts = np.arange(args.frames) * 0.05
    t_start = time.time()
    for i in range(args.frames):
        feats, _ = synth.render_features(world, R_gt[i], t_gt[i], cam,
                                         capacity=args.features, seed=50 + i, device=dev)
        t0 = time.time()
        slam.track_features(feats, float(ts[i]))
        info = slam.print_info()
        print(f'frame {i:3d}  state={info["state"]:<16s} '
              f'kfs={info["n_kfs"]:3d} mps={info["n_mps"]:5d} '
              f'track={1e3 * (time.time() - t0):6.1f} ms')
    wall = time.time() - t_start

    poses = slam._full_poses(0)
    gt = {round(float(t), 6): -R_gt[i].T @ t_gt[i] for i, t in enumerate(ts)}
    est = np.array([p[2] for p in poses])
    g = np.array([gt[round(p[0], 6)] for p in poses])
    ate = ate_rmse(est, g, with_scale=True)
    print(f'\n{len(poses)} frames tracked in {wall:.1f} s '
          f'({len(poses) / wall:.1f} fps incl. mapping)')
    print(f'ATE RMSE (scale-aligned): {ate * 1e3:.2f} mm')
    if args.save_tum:
        slam.save_trajectory_tum(args.save_tum)
        print('trajectory saved to', args.save_tum)
    return dict(rc=0 if ate < 0.05 else 1, slam=slam, ate=ate)


def main(argv=None) -> int:
    return run(argv)['rc']


if __name__ == '__main__':
    sys.exit(main())
