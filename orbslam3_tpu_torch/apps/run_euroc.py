"""EuRoC / TUM-VI dataset runner: mono, mono-inertial, stereo and
stereo-inertial SLAM on an ASL-layout sequence on disk.

Port of `apps/run_euroc.py` (ORB-SLAM3's Examples/Monocular-Inertial/
mono_inertial_euroc.cc and its siblings): load images and IMU -> per-frame
`Slam.track_*` with the frame's IMU window -> save the trajectory ->
report the ATE against the ground truth. PNGs are decoded by the port's
codec and `Camera.newWidth` resizes by its OpenCV-rule `resize_linear`.

Usage:

    python -m orbslam3_tpu_torch.apps.run_euroc --seq <dir> [--config <yaml>]
        [--imu] [--stereo] [--tumvi] [--max-frames N] [--save-tum out.txt]
        [--vocab auto|none|<path>] [--load-atlas a.npz] [--save-atlas a.npz]
        [--localization] [--device cpu]

The card is the default device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def run(argv=None, frame_hook=None) -> dict:
    """The runner; returns {"rc", "slam", "seq", "log" (`FrameLog`), "ate",
    "ate_mode", "wall_s"}. `frame_hook(i, slam, log)` gives a context
    manager that wraps frame i's reading and tracking."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--seq', required=True, help='sequence dir (contains mav0/)')
    ap.add_argument('--config', default='', help='settings yaml (default: <seq>/config.yaml)')
    ap.add_argument('--times', default='', help='optional frame times file')
    ap.add_argument('--imu', action='store_true', help='inertial mode')
    ap.add_argument('--stereo', action='store_true', help='stereo mode')
    ap.add_argument('--tumvi', action='store_true', help='TUM-VI GT layout')
    ap.add_argument('--max-frames', type=int, default=0)
    ap.add_argument('--save-tum', default='')
    ap.add_argument('--quiet', action='store_true')
    ap.add_argument('--load-atlas', default='',
                    help='warm-start from an atlas checkpoint (.npz)')
    ap.add_argument('--save-atlas', default='', help='save the atlas checkpoint at shutdown')
    ap.add_argument('--vocab', default='auto',
                    help="vocabulary .npz for loop closing/relocalization: 'auto' "
                         "(shipped 100k-word artifact), 'none', or a path")
    ap.add_argument('--localization', action='store_true',
                    help='localization-only mode: freeze mapping, track + relocalize '
                         'against the loaded atlas (System::ActivateLocalizationMode)')
    from orbslam3_tpu_torch.apps.common import FrameLog, add_device_arg, load_vocab, no_hook
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from orbslam3_tpu_torch import device as device_policy
    from orbslam3_tpu_torch.config import Settings
    from orbslam3_tpu_torch.datasets import imu_batches, load_euroc, load_tumvi
    from orbslam3_tpu_torch.datasets.imageio import resize_linear
    from orbslam3_tpu_torch.engine.system import Slam
    from orbslam3_tpu_torch.evaluation import ate_rmse
    from orbslam3_tpu_torch.slam_map.map_state import MapConfig

    dev = device_policy.resolve(args.device)
    loader = load_tumvi if args.tumvi else load_euroc
    seq = loader(args.seq, times_file=args.times or None, stereo=args.stereo)
    n = len(seq) if args.max_frames <= 0 else min(len(seq), args.max_frames)
    print(f'{n} frames, {len(seq.imu_ts)} IMU samples, '
          f'GT={"yes" if seq.gt_ts is not None else "no"}')

    cfg_path = args.config or os.path.join(args.seq, 'config.yaml')
    base = 'stereo' if args.stereo else 'monocular'
    sensor = f'imu_{base}' if args.imu else base
    settings = Settings.from_yaml(cfg_path, sensor=sensor)
    cam = settings.camera(device=dev)
    sys_cfg = settings.system_config(
        map_cfg=MapConfig(max_keyframes=256, max_points=20000,
                          features_per_frame=settings.n_features), device=dev)
    if args.imu:
        sys_cfg.imu_calib = settings.imu_calib()
    vocab = load_vocab(args.vocab)
    if vocab is not None:
        print(f'vocabulary: {vocab.n_words} words')
    slam = Slam(cam, sys_cfg, vocab=vocab, load_atlas_from=args.load_atlas or None,
                device=dev)
    if args.localization:
        slam.activate_localization_mode()

    imu_iter = imu_batches(seq) if args.imu else None
    size = ((settings.new_width, settings.new_height)
            if settings.new_width > 0 and settings.new_height > 0 else None)
    log = FrameLog(dev)
    t_wall = time.time()
    hook = frame_hook or no_hook
    for i in range(n):
        with hook(i, slam, log):
            img = log.decode(seq.read_image, i)
            if size:
                img = log.resize(resize_linear, img, *size)
            imu = next(imu_iter) if imu_iter else None
            if args.stereo:
                img_r = seq.read_image(i, right=True)
                if size:
                    img_r = resize_linear(img_r, *size)
                log.track(slam, slam.track_stereo, img, img_r, float(seq.image_ts[i]),
                          imu=imu)
            else:
                log.track(slam, slam.track_monocular, img, float(seq.image_ts[i]), imu=imu)
        if not args.quiet and (i % 20 == 0 or i == n - 1):
            info = slam.print_info()
            print(f'frame {i:4d}  state={info["state"]:<16s} '
                  f'kfs={info["n_kfs"]:3d} mps={info["n_mps"]:6d} '
                  f'track={log.track_ms[-1]:6.1f} ms')
    wall = time.time() - t_wall
    med = float(np.median(log.track_ms))
    print(f'\n{n} frames in {wall:.1f}s ({n / wall:.1f} fps); median track {med:.1f} ms')

    if args.save_tum:
        slam.save_trajectory_tum(args.save_tum)
        print('saved', args.save_tum)
    if args.save_atlas:
        slam.save_atlas(args.save_atlas)
        print('saved atlas', args.save_atlas)
    out = dict(rc=0, slam=slam, seq=seq, log=log, ate=None, ate_mode=None, wall_s=wall)
    if seq.gt_ts is not None:
        poses = slam._full_poses(0)
        if len(poses) >= 5:
            ts = np.array([p[0] for p in poses])
            est = np.array([p[2] for p in poses])  # camera centres
            gt = seq.gt_positions_at(ts)
            metric_scale = args.imu or args.stereo
            ate = ate_rmse(est, gt, with_scale=not metric_scale)
            tag = '' if metric_scale else 'scale-aligned '
            print(f'ATE RMSE ({tag}{len(poses)} frames): {ate * 1e3:.1f} mm')
            out.update(ate=ate, ate_mode='metric' if metric_scale else 'scale-aligned')
        else:
            print('too few tracked frames for ATE')
            out['rc'] = 1
    return out


def main(argv=None) -> int:
    return run(argv)['rc']


if __name__ == '__main__':
    sys.exit(main())
