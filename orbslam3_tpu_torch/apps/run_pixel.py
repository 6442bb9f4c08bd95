"""Pixel-phone offline dataset runner (multi-sequence mono-inertial).

Port of `apps/run_pixel.py` (the ORB-SLAM3 fork's Examples/
Monocular-Inertial/mono_inertial_pixel.cc): TUM-VI-style loading (an image
directory, a timestamps file with one ns timestamp per line and the image
at `<dir>/<ts>.png`, and a EuRoC-format IMU csv), several sequences in
order with `change_dataset` between them, so each starts a fresh map and
place recognition may weld them. PNGs are decoded by the port's codec and
`Camera.newWidth` resizes by its OpenCV-rule `resize_linear`.

Usage:

    python -m orbslam3_tpu_torch.apps.run_pixel --config PIXEL6.yaml \\
        --seq imgs1,times1.txt,imu1.csv [--seq imgs2,times2.txt,imu2.csv ...]
        [--save-tum out.txt] [--vocab auto|none|<path>] [--device cpu]

The card is the default device.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def load_pixel_sequence(img_dir: str, times_file: str, imu_csv: str):
    """(image paths, image ts (s), imu ts, gyro, acc): the fork's
    LoadImagesTUMVI + LoadIMU."""
    paths, ts = [], []
    with open(times_file) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith('#'):
                continue
            item = line.split()[0].split(',')[0]
            paths.append(os.path.join(img_dir, item + '.png'))
            ts.append(float(item) * 1e-9)
    rows = []
    with open(imu_csv) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith('#'):
                continue
            rows.append([float(x) for x in line.split(',')[:7]])
    arr = np.asarray(rows, np.float64)
    return (paths, np.asarray(ts, np.float64), arr[:, 0] * 1e-9, arr[:, 1:4], arr[:, 4:7])


def run(argv=None) -> dict:
    """The runner; returns {"rc", "slam", "log"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--config', required=True)
    ap.add_argument('--seq', action='append', required=True, metavar='IMAGES,TIMES,IMU',
                    help='one sequence triple; repeat for multi-sequence')
    ap.add_argument('--save-tum', default='')
    ap.add_argument('--vocab', default='auto')
    ap.add_argument('--max-frames', type=int, default=0)
    ap.add_argument('--quiet', action='store_true')
    from orbslam3_tpu_torch.apps.common import FrameLog, add_device_arg, load_vocab
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from orbslam3_tpu_torch import device as device_policy
    from orbslam3_tpu_torch.config import Settings
    from orbslam3_tpu_torch.datasets import imageio
    from orbslam3_tpu_torch.engine.system import Slam
    from orbslam3_tpu_torch.slam_map.map_state import MapConfig

    dev = device_policy.resolve(args.device)
    st = Settings.from_yaml(args.config, sensor='imu-monocular')
    cfg = st.system_config(map_cfg=MapConfig(max_keyframes=256, max_points=20000,
                                             features_per_frame=st.n_features), device=dev)
    cfg.imu_calib = st.imu_calib()
    slam = Slam(st.camera(device=dev), cfg, vocab=load_vocab(args.vocab), device=dev)

    size = (st.new_width, st.new_height) if st.new_width > 0 and st.new_height > 0 else None
    log = FrameLog(dev)
    for si, triple in enumerate(args.seq):
        img_dir, times_file, imu_csv = triple.split(',')
        paths, img_ts, imu_ts, gyro, acc = load_pixel_sequence(img_dir, times_file, imu_csv)
        n = len(paths) if args.max_frames <= 0 else min(len(paths), args.max_frames)
        print(f'sequence {si}: {n} frames, {len(imu_ts)} IMU samples')
        j = int(np.searchsorted(imu_ts, img_ts[0], side='right'))
        for i in range(n):
            try:
                img = log.decode(imageio.imread, paths[i])
            except (IOError, ValueError):
                print(f'skipping unreadable {paths[i]}')
                continue
            if size:
                img = log.resize(imageio.resize_linear, img, *size)
            j2 = int(np.searchsorted(imu_ts, img_ts[i], side='right'))
            imu = [(float(imu_ts[k]), gyro[k].astype(np.float32), acc[k].astype(np.float32))
                   for k in range(j, j2)]
            j = j2
            log.track(slam, slam.track_monocular, img, float(img_ts[i]), imu=imu)
            if not args.quiet and i % 50 == 0:
                tr = slam.trackers[0]
                print(f'[s{si} {i:5d}] state={tr.state.name} '
                      f'kfs={slam.atlas.active.n_keyframes}')
        if si < len(args.seq) - 1:
            slam.change_dataset()   # mono_inertial_pixel.cc's ChangeDataset

    if args.save_tum:
        slam.save_trajectory_tum(args.save_tum)
        print('saved', args.save_tum)
    print(slam.print_info())
    return dict(rc=0, slam=slam, log=log)


def main(argv=None) -> int:
    return run(argv)['rc']


if __name__ == '__main__':
    sys.exit(main())
