"""The JAX package's monocular SLAM on the port's rendered sequence, on CPU.

Renders `orbslam3_tpu_torch.datasets.render.orbit_sequence` (the sequence
`chip_smoke.py` drives through the port on the card), runs the JAX
package's `Slam.track_monocular` on it, and prints the frame at which the
map initialized, the tracked share after init, the keyframe and point
counts and the Sim3-aligned ATE of `_full_poses` against the rendered
poses. `chip_smoke.py` bounds the port's ATE by this number times a stated
margin.

Usage (from the repository root; at 752x480 and 1200 features the run
takes a few minutes and a few GB):

    python scripts/port_mono_reference.py --frames 40 --width 752 --height 480 --features 1200
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import _cpu_env  # noqa: E402,F401  (pins jax to the CPU)
import numpy as np  # noqa: E402

from orbslam3_tpu.core.camera import Camera  # noqa: E402
from orbslam3_tpu.engine.system import Slam, SystemConfig  # noqa: E402
from orbslam3_tpu.engine.tracking import TrackerConfig  # noqa: E402
from orbslam3_tpu.evaluation import ate_rmse  # noqa: E402
from orbslam3_tpu.slam_map.map_state import MapConfig  # noqa: E402
from orbslam3_tpu_torch.datasets.render import orbit_sequence  # noqa: E402

EUROC_CAM0 = (458.654, 457.296, 367.215, 248.375)


def trajectory_ate(poses, R_gt, t_gt, ts_gt) -> float:
    """Sim3-aligned ATE of (ts, R_wc, t_wc) poses against world->camera
    ground truth at the frames' timestamps."""
    idx = [int(np.argmin(np.abs(ts_gt - p[0]))) for p in poses]
    est = np.asarray([p[2] for p in poses], np.float64)
    gt = np.asarray([-R_gt[i].T @ t_gt[i] for i in idx], np.float64)
    return ate_rmse(est, gt, with_scale=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--width", type=int, default=752)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--features", type=int, default=1200)
    args = ap.parse_args()
    s = args.width / 752.0
    intr = tuple(v * s for v in EUROC_CAM0)
    imgs, R, t, ts = orbit_sequence(args.frames, args.width, args.height, intr)
    cam = Camera.pinhole(*intr, width=args.width, height=args.height)
    cfg = SystemConfig(use_loop_closing=False,
                       map=MapConfig(features_per_frame=args.features),
                       tracker=TrackerConfig(n_features=args.features))
    slam = Slam(cam, cfg)
    tracked, t0 = [], time.perf_counter()
    for i in range(args.frames):
        tracked.append(slam.track_monocular(imgs[i], float(ts[i])) is not None)
    init = tracked.index(True) if any(tracked) else -1
    m = slam.trackers[0].map
    poses = slam._full_poses()
    out = dict(frames=args.frames, width=args.width, height=args.height,
               features=args.features, init_frame=init,
               tracked_after_init=(sum(tracked[init:]) / len(tracked[init:])
                                   if init >= 0 else 0.0),
               keyframes=m.n_keyframes, points=m.n_points, poses=len(poses),
               ate=trajectory_ate(poses, R, t, ts) if len(poses) >= 3 else None,
               seconds=time.perf_counter() - t0)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
