"""KITTI odometry runner (stereo or monocular).

Port of `apps/run_kitti.py` (ORB-SLAM3's Examples/Stereo/stereo_kitti.cc
and Examples/Monocular/mono_kitti.cc): load image_0[/image_1] and
times.txt, per-frame `Slam.track_*`, save the KITTI-format trajectory
(`Slam.save_trajectory_kitti`), report the ATE against the odometry
ground-truth poses file when given. PNGs are decoded by the port's codec.

Usage:

    python -m orbslam3_tpu_torch.apps.run_kitti --seq <dir> --config <KITTIxx.yaml>
        [--mono] [--poses 00.txt] [--max-frames N] [--save-kitti out.txt]
        [--vocab auto|none|<path>] [--device cpu]

The card is the default device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def run(argv=None) -> dict:
    """The runner; returns {"rc", "slam", "seq", "log", "ate", "wall_s"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--seq', required=True,
                    help='KITTI sequence dir (image_0/ [image_1/] times.txt)')
    ap.add_argument('--config', default='', help='settings yaml (default: <seq>/config.yaml)')
    ap.add_argument('--mono', action='store_true', help='monocular instead of stereo')
    ap.add_argument('--poses', default='', help='GT poses file (dataset poses/NN.txt) for ATE')
    ap.add_argument('--max-frames', type=int, default=0)
    ap.add_argument('--save-kitti', default='')
    ap.add_argument('--vocab', default='auto',
                    help="vocabulary .npz: 'auto' (shipped), 'none', or path")
    ap.add_argument('--quiet', action='store_true')
    from orbslam3_tpu_torch.apps.common import FrameLog, add_device_arg, load_vocab
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from orbslam3_tpu_torch import device as device_policy
    from orbslam3_tpu_torch.config import Settings
    from orbslam3_tpu_torch.datasets import load_kitti
    from orbslam3_tpu_torch.engine.system import Slam
    from orbslam3_tpu_torch.evaluation import ate_rmse
    from orbslam3_tpu_torch.slam_map.map_state import MapConfig

    dev = device_policy.resolve(args.device)
    seq = load_kitti(args.seq, poses_file=args.poses or None, stereo=not args.mono)
    n = len(seq) if args.max_frames <= 0 else min(len(seq), args.max_frames)
    print(f'{n} frames ({"mono" if args.mono else "stereo"})')

    cfg_path = args.config or os.path.join(args.seq, 'config.yaml')
    st = Settings.from_yaml(cfg_path, sensor='monocular' if args.mono else 'stereo')
    cfg = st.system_config(map_cfg=MapConfig(max_keyframes=512, max_points=40000,
                                             features_per_frame=st.n_features), device=dev)
    slam = Slam(st.camera(device=dev), cfg, vocab=load_vocab(args.vocab), device=dev)

    log = FrameLog(dev)
    t_start = time.time()
    for i in range(n):
        img = log.decode(seq.read_image, i)
        if args.mono:
            log.track(slam, slam.track_monocular, img, float(seq.image_ts[i]))
        else:
            log.track(slam, slam.track_stereo, img, seq.read_image(i, right=True),
                      float(seq.image_ts[i]))
        if not args.quiet and (i % 50 == 0 or i == n - 1):
            tr = slam.trackers[0]
            print(f'[{i:5d}] state={tr.state.name} kfs={slam.atlas.active.n_keyframes} '
                  f'pts={slam.atlas.active.n_points}')
    wall = time.time() - t_start
    print(f'{n} frames in {wall:.1f} s ({1e3 * wall / n:.1f} ms/frame)')

    if args.save_kitti:
        slam.save_trajectory_kitti(args.save_kitti)
        print('saved', args.save_kitti)

    out = dict(rc=0, slam=slam, seq=seq, log=log, ate=None,
               ate_mode='scale-aligned' if args.mono else 'metric', wall_s=wall)
    if seq.gt_poses is not None:
        poses = slam._full_poses(0)
        if poses:
            ts = np.array([p[0] for p in poses])
            est = np.array([p[2] for p in poses])
            # KITTI GT rows are frame-indexed; map times back to indices
            lut = {round(float(t), 6): i for i, t in enumerate(seq.image_ts)}
            idx = np.array([lut.get(round(float(t), 6), -1) for t in ts])
            sel = idx >= 0
            gt = seq.gt_poses[idx[sel], :, 3]
            ate = ate_rmse(est[sel], gt, with_scale=args.mono)
            kind = 'scale-aligned' if args.mono else 'metric'
            print(f'{kind} ATE: {ate * 100:.2f} cm over {int(sel.sum())} frames')
            out['ate'] = ate
    return out


def main(argv=None) -> int:
    return run(argv)['rc']


if __name__ == '__main__':
    sys.exit(main())
