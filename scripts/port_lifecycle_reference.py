"""The JAX package's failure and lifecycle paths on the port's rendered
sequence, on CPU: the lifecycle phase's faults and capacity tiers.

Renders the mono-inertial phase's `vi_sequence` (the frames `chip_smoke.py`
drives through the port on the card), builds the JAX package's
`Slam(sensor=IMU_MONOCULAR)` with the shipped vocabulary
(`orbslam3_tpu/assets/vocab_100k.npz`, global BA inline), the small map
tiers (`chip_smoke.LIFECYCLE_TIERS`) and the 1 s IMU initialization span
(`chip_smoke.LIFECYCLE_MAPPER`), and drives `chip_smoke.lifecycle_plan`
through `chip_smoke.lifecycle_report`, the code the card runs: 10 dropped
frames, a backward timestamp, a forward gap on the new map's young IMU, a
bad IMU. It prints one JSON line: the `Slam.events` and the capacity
events with the frame of the plan they came at, the maps with their
keyframes and points, the tracked share, the last map's segment (metric
ATE, keyframe scale, gravity tilt), per frame the tracked flag, state and
counts, and the seconds. `chip_smoke.py` takes its bounds from these
numbers.

Usage (from the repository root; at 752x480 and 1200 features it takes
minutes to tens of minutes and a few GB):

    python scripts/port_lifecycle_reference.py [--width 376 --height 240 --features 600]
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

import chip_smoke as smoke  # noqa: E402  (the plan, the report and the constants only)
from orbslam3_tpu.core.camera import Camera  # noqa: E402
from orbslam3_tpu.engine.local_mapping import LocalMapperConfig  # noqa: E402
from orbslam3_tpu.engine.system import Sensor, Slam, SystemConfig  # noqa: E402
from orbslam3_tpu.engine.tracking import TrackerConfig  # noqa: E402
from orbslam3_tpu.imu.preintegration import ImuCalib  # noqa: E402
from orbslam3_tpu.place.vocab import Vocabulary  # noqa: E402
from orbslam3_tpu.slam_map.map_state import MapConfig  # noqa: E402
from orbslam3_tpu_torch.datasets.render import imu_batches, vi_sequence  # noqa: E402
from orbslam3_tpu_torch.place.vocab import default_vocabulary_path  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=smoke.W)
    ap.add_argument("--height", type=int, default=smoke.H)
    ap.add_argument("--features", type=int, default=smoke.N_FEATURES)
    args = ap.parse_args()
    s = args.width / smoke.W
    intr = tuple(v * s for v in smoke.CAMERA)
    seq = vi_sequence(smoke.VI_FRAMES, args.width, args.height, intr)
    batches = imu_batches(seq.frame_ts, seq.imu_ts, seq.gyro, seq.acc)
    kfs, pts = smoke.LIFECYCLE_TIERS
    cfg = SystemConfig(sensor=Sensor.IMU_MONOCULAR, imu_calib=ImuCalib.create(),
                       map=MapConfig(kfs, pts, args.features),
                       tracker=TrackerConfig(n_features=args.features, n_levels=smoke.N_LEVELS,
                                             scale_factor=smoke.SCALE),
                       mapper=LocalMapperConfig(**smoke.LIFECYCLE_MAPPER))
    slam = Slam(Camera.pinhole(*intr, width=args.width, height=args.height), cfg,
                vocab=Vocabulary.load(default_vocabulary_path()))
    slam.loop_closer.gba_background = False
    t0 = time.perf_counter()
    out = dict(width=args.width, height=args.height, features=args.features)
    out.update(smoke.lifecycle_report(slam, seq, batches, smoke.lifecycle_plan()))
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
