"""Where the port's mono-inertial SLAM first parts from the JAX package's.

Both packages' `Slam` (IMU_MONOCULAR, the chip_smoke mono-inertial phase's
ladder cadence, loop closing off) track the same rendered frames and IMU
samples (`orbslam3_tpu_torch.datasets.render.vi_sequence`, intrinsics
scaled to the size) in lockstep on the CPU; the port's two-view RANSAC takes
the samples the reference drew (`tests/test_torch_slam_e2e.reference_samples`).
After every frame the keyframes both maps hold (same slot, same uid) are
compared: rotation entries and translation ("pose"), velocity and bias
("state"). The script prints a JSON line per group at the frame at which
its largest difference first exceeds each of 1e-6, 1e-5, 1e-4 and 1e-3
(frame, keyframe uid, quantity, both values, both maps' keyframe and point
counts), and the first frame one tracks and the other does not; the frames of the events of each run (init, IMU init, VIBA1/2),
and at the end both runs' keyframe scale and metric ATE against the truth
(`evaluation.vi_metrics`), then one summary JSON line.

Usage (from the repository root; ~10 min on the CPU at the default size):

    python scripts/port_vi_parting.py [--frames 120] [--width 376 --height 240]
        [--features 600]
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import _cpu_env  # noqa: E402,F401  (pins jax to the CPU)
import numpy as np  # noqa: E402
import torch  # noqa: E402

from orbslam3_tpu.core.camera import Camera as JCamera  # noqa: E402
from orbslam3_tpu.engine.local_mapping import LocalMapperConfig as JLC  # noqa: E402
from orbslam3_tpu.engine.system import Sensor as JSensor, Slam as JSlam  # noqa: E402
from orbslam3_tpu.engine.system import SystemConfig as JSC  # noqa: E402
from orbslam3_tpu.engine.tracking import TrackerConfig as JTC  # noqa: E402
from orbslam3_tpu.imu.preintegration import ImuCalib as JCalib  # noqa: E402
from orbslam3_tpu.slam_map.map_state import MapConfig as JMC  # noqa: E402
from orbslam3_tpu_torch.core.camera import Camera as TCamera  # noqa: E402
from orbslam3_tpu_torch.datasets.render import imu_batches, vi_sequence  # noqa: E402
from orbslam3_tpu_torch.engine.local_mapping import LocalMapperConfig as TLC  # noqa: E402
from orbslam3_tpu_torch.engine.system import Sensor as TSensor, Slam as TSlam  # noqa: E402
from orbslam3_tpu_torch.engine.system import SystemConfig as TSC  # noqa: E402
from orbslam3_tpu_torch.engine.tracking import TrackerConfig as TTC  # noqa: E402
from orbslam3_tpu_torch.evaluation import vi_metrics  # noqa: E402
from orbslam3_tpu_torch.imu.preintegration import ImuCalib as TCalib  # noqa: E402
from orbslam3_tpu_torch.slam_map.map_state import MapConfig as TMC  # noqa: E402
from test_torch_slam_e2e import reference_samples  # noqa: E402

EUROC_CAM0 = (458.654, 457.296, 367.215, 248.375)
CADENCE = dict(viba1_after_s=1.5, viba2_after_s=3.0, scale_refine_every_s=1.5)
LEVELS = (1e-6, 1e-5, 1e-4, 1e-3)


GROUPS = {"pose": ("kf_R", "kf_t"), "state": ("kf_vel", "kf_bias")}


def keyframe_diff(jm, tm, names) -> tuple[float, dict]:
    """The largest difference of `names` over the keyframes both maps hold,
    and where."""
    worst, where = 0.0, {}
    common = np.intersect1d(jm.keyframe_ids(), tm.keyframe_ids())
    for k in common:
        if int(jm.kf_uid[k]) != int(tm.kf_uid[k]):
            return np.inf, dict(slot=int(k), quantity="uid", jax=int(jm.kf_uid[k]),
                                port=int(tm.kf_uid[k]))
        for name in names:
            a, b = np.asarray(getattr(jm, name)[k]), np.asarray(getattr(tm, name)[k])
            d = float(np.abs(a - b).max())
            if d > worst:
                worst = d
                where = dict(slot=int(k), uid=int(jm.kf_uid[k]), quantity=name,
                             jax=np.round(a, 7).tolist(), port=np.round(b, 7).tolist())
    return worst, where


def events_of(m, i: int, events: dict, tracked: bool):
    if tracked and "init" not in events:
        events["init"] = i
    if m.imu_initialized and "imu_init" not in events:
        events["imu_init"] = (i, int(m._next_uid) - 1)
    for stage in (1, 2):
        if m.iba_stage >= stage and f"viba{stage}" not in events:
            events[f"viba{stage}"] = i


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--width", type=int, default=376)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--features", type=int, default=600)
    args = ap.parse_args()
    torch.set_num_threads(1)
    s = args.width / 752.0
    intr = tuple(v * s for v in EUROC_CAM0)
    seq = vi_sequence(args.frames, args.width, args.height, intr)
    batches = imu_batches(seq.frame_ts, seq.imu_ts, seq.gyro, seq.acc)

    jslam = JSlam(JCamera.pinhole(*intr, width=args.width, height=args.height), JSC(
        sensor=JSensor.IMU_MONOCULAR, imu_calib=JCalib.create(), use_loop_closing=False,
        map=JMC(features_per_frame=args.features), tracker=JTC(n_features=args.features),
        mapper=JLC(**CADENCE)))
    tslam = TSlam(TCamera.pinhole(*intr, width=args.width, height=args.height, device="cpu"),
                  TSC(sensor=TSensor.IMU_MONOCULAR, imu_calib=TCalib.create(),
                      use_loop_closing=False, map=TMC(features_per_frame=args.features),
                      tracker=TTC(n_features=args.features), mapper=TLC(**CADENCE)),
                  device="cpu")
    tslam.trackers[0].sample_fn = reference_samples

    events = {"jax": {}, "port": {}}
    parted, t0 = {}, time.perf_counter()
    for i in range(args.frames):
        pj = jslam.track_monocular(seq.images[i], float(seq.frame_ts[i]), imu=batches[i])
        pt = tslam.track_monocular(seq.images[i], float(seq.frame_ts[i]), imu=batches[i])
        jm, tm = jslam.trackers[0].map, tslam.trackers[0].map
        events_of(jm, i, events["jax"], pj is not None)
        events_of(tm, i, events["port"], pt is not None)
        for group, names in GROUPS.items():
            worst, where = keyframe_diff(jm, tm, names)
            for level in LEVELS:
                if worst > level and (group, level) not in parted:
                    parted[group, level] = dict(
                        group=group, level=level, frame=i, diff=worst,
                        keyframes=(int(jm.n_keyframes), int(tm.n_keyframes)),
                        points=(int(jm.n_points), int(tm.n_points)), **where)
                    print(json.dumps(parted[group, level]), flush=True)
        if (pj is None) != (pt is None) and "tracking" not in parted:
            parted["tracking"] = dict(frame=i, jax=pj is not None, port=pt is not None)
            print(json.dumps(parted["tracking"]), flush=True)
    out = dict(frames=args.frames, width=args.width, height=args.height,
               features=args.features, events=events, seconds=round(time.perf_counter() - t0, 1),
               first_parting={" ".join(map(str, k)) if isinstance(k, tuple) else k: v["frame"]
                              for k, v in parted.items()})
    for name, slam in (("jax", jslam), ("port", tslam)):
        m = slam.trackers[0].map
        ks = m.keyframe_ids()
        met = vi_metrics(slam._full_poses(), np.asarray(m.kf_R[ks]), np.asarray(m.kf_t[ks]),
                         np.asarray(m.kf_ts[ks]), seq.frame_ts, seq.R_cw, seq.t_cw)
        out[name] = dict(keyframes=int(m.n_keyframes), iba_stage=int(m.iba_stage),
                         kf_scale=round(float(met["kf_scale"]), 5),
                         ate_metric=round(float(met["ate_metric"]), 6),
                         gravity_tilt_deg=round(float(met["gravity_tilt_deg"]), 3))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
