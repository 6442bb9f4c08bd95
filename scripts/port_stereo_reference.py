"""The JAX package's stereo, RGB-D and stereo-inertial SLAM on the port's
rendered sequences, on CPU.

Renders the sequences `chip_smoke.py` drives through the port on the card
(`orbslam3_tpu_torch.datasets.render`: `orbit_stereo_sequence` for stereo,
`rgbd_sequence` for RGB-D, `vi_sequence` with EuRoC's raw pair for
stereo-inertial), builds the JAX package's `Settings` from the same YAML
texts (`chip_smoke.EUROC_STEREO_YAML`, `TUM1_RGBD_YAML`,
`EUROC_STEREO_INERTIAL_YAML`), runs its `Slam.track_stereo` /
`track_rgbd` on the same images and IMU samples, and prints one JSON line
per phase: the init frame, the tracked share, the frame and keyframe at
which the IMU initialized, the frames of VIBA1 and VIBA2 and the final
`iba_stage`, the keyframe and point counts, the metric (rigid) and
Sim3-aligned ATE of `_full_poses` against the rendered poses, the keyframe
scale and the gravity tilt (`orbslam3_tpu_torch.evaluation.vi_metrics`,
the truth turned into the rectified camera's frame), and the seconds.
`chip_smoke.py` takes its bounds from these numbers.

Usage (from the repository root; each phase takes minutes to tens of
minutes and 2-3 GB at full width):

    python scripts/port_stereo_reference.py --phase stereo --frames 40
    python scripts/port_stereo_reference.py --phase rgbd --frames 40
    python scripts/port_stereo_reference.py --phase stereo_vi --frames 120
"""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import _cpu_env  # noqa: E402,F401  (pins jax to the CPU)
import numpy as np  # noqa: E402

import chip_smoke as smoke  # noqa: E402  (the YAML texts and constants only)
from orbslam3_tpu.config import Settings  # noqa: E402
from orbslam3_tpu.engine.local_mapping import LocalMapperConfig  # noqa: E402
from orbslam3_tpu.engine.system import Slam  # noqa: E402
from orbslam3_tpu_torch.datasets import render  # noqa: E402
from orbslam3_tpu_torch.evaluation import vi_metrics  # noqa: E402

PHASES = {
    "stereo": (smoke.EUROC_STEREO_YAML, "stereo"),
    "rgbd": (smoke.TUM1_RGBD_YAML, "rgbd"),
    "stereo_vi": (smoke.EUROC_STEREO_INERTIAL_YAML, "imu_stereo"),
}


def settings(text: str, sensor: str) -> Settings:
    with tempfile.NamedTemporaryFile("w", suffix=".yaml", delete=False) as f:
        f.write(text)
    try:
        return Settings.from_yaml(f.name, sensor)
    finally:
        os.unlink(f.name)


def frames_of(phase: str, n: int):
    """(per-frame track arguments, per-frame IMU batches or None, truth
    R_cw, t_cw, frame timestamps, depth_factor)."""
    (f0, d0), (f1, d1) = smoke.EUROC_CAM0, smoke.EUROC_CAM1
    if phase == "stereo":
        left, right, R, t, ts = render.orbit_stereo_sequence(
            n, smoke.W, smoke.H, f0, d0, right=(f1, d1), T_c1_c2=smoke.EUROC_T_C1_C2)
        return list(zip(left, right)), None, R, t, ts
    if phase == "rgbd":
        h, w = smoke.TUM1_SIZE
        seq = render.rgbd_sequence(n, w, h, smoke.TUM1_INTRINSICS)
        return list(zip(seq.images, seq.depth)), None, seq.R_cw, seq.t_cw, seq.frame_ts
    seq = render.vi_sequence(n, smoke.W, smoke.H, f0, pinhole_dist=d0,
                             T_c1_c2=smoke.EUROC_T_C1_C2, right=(f1, d1))
    batches = render.imu_batches(seq.frame_ts, seq.imu_ts, seq.gyro, seq.acc)
    return (list(zip(seq.images, seq.images_right)), batches, seq.R_cw, seq.t_cw,
            seq.frame_ts)


def run(phase: str, n: int) -> dict:
    text, sensor = PHASES[phase]
    st = settings(text, sensor)
    cfg = st.system_config()
    if st.inertial:
        cfg.mapper = LocalMapperConfig(**smoke.VI_CADENCE)
    slam = Slam(st.camera(), cfg)
    args, batches, R_gt, t_gt, stamps = frames_of(phase, n)
    tracked, events, t0 = [], {}, time.perf_counter()
    for i, (a, b) in enumerate(args):
        imu = None if batches is None else batches[i]
        if st.rgbd:
            out = slam.track_rgbd(a, b, float(stamps[i]), imu=imu,
                                  depth_factor=1.0 / st.depth_map_factor)
        else:
            out = slam.track_stereo(a, b, float(stamps[i]), imu=imu)
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
    out = dict(phase=phase, frames=n, init_frame=init,
               tracked_after_init=(sum(tracked[init:]) / len(tracked[init:])
                                   if init >= 0 else 0.0),
               imu_initialized=bool(m.imu_initialized), iba_stage=int(m.iba_stage),
               keyframes=int(m.n_keyframes), keyframes_made=int(m._next_uid),
               points=int(m.n_points), poses=len(poses),
               events=[e["event"] for e in slam.events], **events)
    rect = st.rectification()
    R1 = np.eye(3) if rect is None else rect.R1  # the rectified camera's frame
    if len(poses) >= 3 and len(ks) >= 3:
        out.update(vi_metrics(poses, m.kf_R[ks], m.kf_t[ks], m.kf_ts[ks], stamps,
                              np.einsum("ij,njk->nik", R1, R_gt),
                              np.einsum("ij,nj->ni", R1, t_gt)))
    out["seconds"] = seconds
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=sorted(PHASES), required=True)
    ap.add_argument("--frames", type=int, default=None,
                    help="default: chip_smoke.py's clip length for the phase")
    args = ap.parse_args()
    n = args.frames or {"stereo": smoke.STEREO_FRAMES, "rgbd": smoke.RGBD_FRAMES,
                        "stereo_vi": smoke.STEREO_VI_FRAMES}[args.phase]
    print(json.dumps(run(args.phase, n)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
