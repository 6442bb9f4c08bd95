"""TUM RGB-D dataset runner.

Port of `apps/run_rgbd.py` (ORB-SLAM3's Examples/RGB-D/rgbd_tum.cc): load
associated rgb+depth pairs -> per-frame `Slam.track_rgbd` -> save the
trajectory -> report the metric ATE against the ground truth (RGB-D fixes
the scale, so no alignment). PNGs are decoded by the port's codec.

Usage:

    python -m orbslam3_tpu_torch.apps.run_rgbd --seq <dir> [--config <yaml>]
        [--association <file>] [--max-frames N] [--save-tum out.txt]
        [--vocab auto|none|<path>] [--device cpu]

The card is the default device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def run(argv=None, frame_hook=None) -> dict:
    """The runner; returns {"rc", "slam", "seq", "log", "ate", "wall_s"}.
    `frame_hook(i, slam, log)` gives a context manager that wraps frame i's
    reading and tracking."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--seq', required=True,
                    help='TUM RGB-D sequence dir (rgb/ depth/ rgb.txt ...)')
    ap.add_argument('--config', default='', help='settings yaml (default: <seq>/config.yaml)')
    ap.add_argument('--association', default='',
                    help='associate.py output file (default: associate rgb.txt/depth.txt '
                         'by nearest timestamp)')
    ap.add_argument('--max-frames', type=int, default=0)
    ap.add_argument('--save-tum', default='')
    ap.add_argument('--vocab', default='auto',
                    help="vocabulary .npz: 'auto' (shipped), 'none', or path")
    ap.add_argument('--quiet', action='store_true')
    from orbslam3_tpu_torch.apps.common import FrameLog, add_device_arg, load_vocab, no_hook
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from orbslam3_tpu_torch import device as device_policy
    from orbslam3_tpu_torch.config import Settings
    from orbslam3_tpu_torch.datasets.tum_rgbd import load_tum_rgbd
    from orbslam3_tpu_torch.engine.system import Slam
    from orbslam3_tpu_torch.evaluation import ate_rmse
    from orbslam3_tpu_torch.slam_map.map_state import MapConfig

    dev = device_policy.resolve(args.device)
    seq = load_tum_rgbd(args.seq, association_file=args.association or None)
    n = len(seq) if args.max_frames <= 0 else min(len(seq), args.max_frames)
    print(f'{n} associated rgb-d pairs')

    cfg_path = args.config or os.path.join(args.seq, 'config.yaml')
    st = Settings.from_yaml(cfg_path, sensor='rgbd')
    cfg = st.system_config(map_cfg=MapConfig(max_keyframes=256, max_points=20000,
                                             features_per_frame=st.n_features), device=dev)
    slam = Slam(st.camera(device=dev), cfg, vocab=load_vocab(args.vocab), device=dev)
    # the reference inverts DepthMapFactor once (Tracking.cc ctor): raw
    # 16-bit depth * (1/factor) = metres
    inv_factor = 1.0 / st.depth_map_factor if abs(st.depth_map_factor) > 1e-5 else 1.0

    log = FrameLog(dev)
    t_start = time.time()
    hook = frame_hook or no_hook
    for i in range(n):
        with hook(i, slam, log):
            img = log.decode(seq.read_image, i)
            depth = seq.read_depth(i)
            log.track(slam, slam.track_rgbd, img, depth, float(seq.image_ts[i]),
                      depth_factor=inv_factor)
        if not args.quiet and (i % 20 == 0 or i == n - 1):
            tr = slam.trackers[0]
            print(f'[{i:4d}] state={tr.state.name} kfs={slam.atlas.active.n_keyframes} '
                  f'pts={slam.atlas.active.n_points}')
    wall = time.time() - t_start
    print(f'{n} frames in {wall:.1f} s ({1e3 * wall / n:.1f} ms/frame)')

    if args.save_tum:
        slam.save_trajectory_tum(args.save_tum)
        print('saved', args.save_tum)

    out = dict(rc=0, slam=slam, seq=seq, log=log, ate=None, ate_mode='metric', wall_s=wall)
    if seq.gt_ts is not None:
        poses = slam._full_poses(0)
        if poses:
            ts = np.array([p[0] for p in poses])
            est = np.array([p[2] for p in poses])
            gt = seq.gt_positions_at(ts)
            ate = ate_rmse(est, gt, with_scale=False)  # metric: depth = scale
            print(f'metric ATE: {ate * 100:.2f} cm over {len(poses)} frames')
            out['ate'] = ate
    return out


def main(argv=None) -> int:
    return run(argv)['rc']


if __name__ == '__main__':
    sys.exit(main())
