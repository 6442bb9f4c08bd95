"""The JAX package's mono-inertial SLAM on the port's rendered sequence, on CPU.

Renders `orbslam3_tpu_torch.datasets.render.vi_sequence` (the sequence
`chip_smoke.py` drives through the port on the card), runs the JAX
package's `Slam(sensor=IMU_MONOCULAR)` on its frames and IMU samples, and
prints one JSON line: the frame at which the map initialized, the frame
and keyframe at which the IMU initialized, the frames at which VIBA1 and
VIBA2 ran and the final `iba_stage`, the keyframe and point counts, the
metric and Sim3-aligned ATE of `_full_poses`, the keyframe scale and the
gravity tilt (`orbslam3_tpu_torch.evaluation.vi_metrics`), and the
seconds. `chip_smoke.py` takes its bounds from these numbers.

Usage (from the repository root; at 752x480 and 1200 features over 120
frames the run takes tens of minutes and a few GB):

    python scripts/port_vi_reference.py --frames 120 --width 752 --height 480 --features 1200
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

from orbslam3_tpu.core.camera import Camera  # noqa: E402
from orbslam3_tpu.engine.local_mapping import LocalMapperConfig  # noqa: E402
from orbslam3_tpu.engine.system import Sensor, Slam, SystemConfig  # noqa: E402
from orbslam3_tpu.engine.tracking import TrackerConfig  # noqa: E402
from orbslam3_tpu.imu.preintegration import ImuCalib  # noqa: E402
from orbslam3_tpu.slam_map.map_state import MapConfig  # noqa: E402
from orbslam3_tpu_torch.datasets.render import imu_batches, vi_sequence  # noqa: E402
from orbslam3_tpu_torch.evaluation import vi_metrics  # noqa: E402

EUROC_CAM0 = (458.654, 457.296, 367.215, 248.375)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--width", type=int, default=752)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--features", type=int, default=1200)
    ap.add_argument("--viba1", type=float, default=1.5)
    ap.add_argument("--viba2", type=float, default=3.0)
    ap.add_argument("--refine-every", type=float, default=1.5)
    args = ap.parse_args()
    s = args.width / 752.0
    intr = tuple(v * s for v in EUROC_CAM0)
    seq = vi_sequence(args.frames, args.width, args.height, intr)
    cam = Camera.pinhole(*intr, width=args.width, height=args.height)
    cfg = SystemConfig(
        sensor=Sensor.IMU_MONOCULAR, imu_calib=ImuCalib.create(),
        use_loop_closing=False,
        map=MapConfig(features_per_frame=args.features),
        tracker=TrackerConfig(n_features=args.features),
        mapper=LocalMapperConfig(viba1_after_s=args.viba1, viba2_after_s=args.viba2,
                                 scale_refine_every_s=args.refine_every))
    slam = Slam(cam, cfg)
    batches = imu_batches(seq.frame_ts, seq.imu_ts, seq.gyro, seq.acc)
    tracked, events, t0 = [], {}, time.perf_counter()
    for i in range(args.frames):
        out = slam.track_monocular(seq.images[i], float(seq.frame_ts[i]), imu=batches[i])
        tracked.append(out is not None)
        m = slam.trackers[0].map
        if m.imu_initialized and "imu_init_frame" not in events:
            events["imu_init_frame"] = i
            events["imu_init_keyframe"] = int(m._next_uid) - 1
        for stage in (1, 2):
            if m.iba_stage >= stage and f"viba{stage}_frame" not in events:
                events[f"viba{stage}_frame"] = i
    seconds = time.perf_counter() - t0
    init = tracked.index(True) if any(tracked) else -1
    m = slam.trackers[0].map
    poses = slam._full_poses()
    ks = m.keyframe_ids()
    out = dict(frames=args.frames, width=args.width, height=args.height,
               features=args.features, init_frame=init,
               tracked_after_init=(sum(tracked[init:]) / len(tracked[init:])
                                   if init >= 0 else 0.0),
               imu_initialized=bool(m.imu_initialized), iba_stage=int(m.iba_stage),
               keyframes=int(m.n_keyframes), keyframes_made=int(m._next_uid),
               points=int(m.n_points), poses=len(poses),
               events=[e["event"] for e in slam.events], **events)
    if len(poses) >= 3 and len(ks) >= 3:
        out.update(vi_metrics(poses, m.kf_R[ks], m.kf_t[ks], m.kf_ts[ks],
                              seq.frame_ts, seq.R_cw, seq.t_cw))
    out["seconds"] = seconds
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
