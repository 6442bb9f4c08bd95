"""EuRoC MAV / TUM-VI loader (ASL directory layout).

Port of `orbslam3_tpu/datasets/euroc.py`, reading PNGs with the port's own
codec (`datasets/imageio.py`) instead of OpenCV.

Layout (both datasets share it):
    <seq>/mav0/cam0/data.csv            timestamp_ns, filename
    <seq>/mav0/cam0/data/<ts>.png       grayscale images
    <seq>/mav0/cam1/...                 right camera (stereo)
    <seq>/mav0/imu0/data.csv            ts_ns, wx, wy, wz, ax, ay, az
    <seq>/mav0/state_groundtruth_estimate0/data.csv   (EuRoC GT)
    <seq>/mav0/mocap0/data.csv                        (TUM-VI GT)

Reference behaviour (ORB-SLAM3's Examples/Monocular-Inertial/
mono_inertial_euroc.cc `LoadImages` / `LoadIMU`): timestamps ns ->
seconds, and IMU rows that precede the first camera frame are dropped down
to one sample before it.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from orbslam3_tpu_torch.datasets import imageio
from orbslam3_tpu_torch.datasets import render


@dataclasses.dataclass
class AslSequence:
    """One ASL-layout sequence, lazily loading images."""

    image_paths: list            # cam0 image file paths, time order
    image_ts: np.ndarray         # (N,) seconds, float64
    imu_ts: np.ndarray           # (M,) seconds
    imu_gyro: np.ndarray         # (M,3) rad/s
    imu_acc: np.ndarray          # (M,3) m/s^2
    gt_ts: np.ndarray | None = None      # (G,) seconds
    gt_p: np.ndarray | None = None       # (G,3) body position, world
    gt_q: np.ndarray | None = None       # (G,4) wxyz body->world quaternion
    image_paths_right: list | None = None  # cam1 (stereo), aligned to cam0

    def __len__(self):
        return len(self.image_paths)

    def read_image(self, i: int, right: bool = False) -> np.ndarray:
        """Grayscale uint8 image for frame i."""
        paths = self.image_paths_right if right else self.image_paths
        return imageio.imread(paths[i], grey=True)

    def gt_positions_at(self, ts: np.ndarray) -> np.ndarray:
        """Linearly interpolated GT body positions at given times (for ATE)."""
        if self.gt_ts is None:
            raise ValueError("sequence has no ground truth")
        return np.stack([np.interp(ts, self.gt_ts, self.gt_p[:, k]) for k in range(3)],
                        axis=-1)


def _read_csv(path: str) -> np.ndarray:
    """Numeric csv with '#' comment header; returns float64 array."""
    return np.genfromtxt(path, delimiter=",", comments="#", dtype=np.float64)


def _load_cam(cam_dir: str, times_file: str | None):
    """Image list from a times file (reference style) or cam data.csv."""
    data_dir = os.path.join(cam_dir, "data")
    if times_file:
        ts_ns = np.loadtxt(times_file, dtype=np.int64, comments="#", ndmin=1)
        names = [f"{int(t)}.png" for t in ts_ns]
    else:
        csv = os.path.join(cam_dir, "data.csv")
        if os.path.exists(csv):
            names, ts_ns = [], []
            with open(csv) as f:
                for line in f:
                    line = line.strip()
                    if not line or line.startswith("#"):
                        continue
                    parts = line.split(",")
                    ts_ns.append(int(parts[0]))
                    names.append(parts[1].strip() if len(parts) > 1 else f"{parts[0]}.png")
            ts_ns = np.asarray(ts_ns, np.int64)
        else:  # fall back to directory listing (<ts>.png)
            names = sorted(os.listdir(data_dir))
            ts_ns = np.asarray([int(os.path.splitext(n)[0]) for n in names], np.int64)
    order = np.argsort(ts_ns)
    ts_ns = ts_ns[order]
    names = [names[i] for i in order]
    paths = [os.path.join(data_dir, n) for n in names]
    return paths, ts_ns.astype(np.float64) * 1e-9


def _load_asl(seq_dir: str, gt_subdir: str, times_file: str | None = None,
              stereo: bool = False) -> AslSequence:
    mav = os.path.join(seq_dir, "mav0")
    if not os.path.isdir(mav):
        mav = seq_dir  # allow pointing straight at mav0
    paths, image_ts = _load_cam(os.path.join(mav, "cam0"), times_file)
    paths_r = None
    if stereo:
        paths_r, _ = _load_cam(os.path.join(mav, "cam1"), times_file)
        n = min(len(paths), len(paths_r))
        paths, image_ts, paths_r = paths[:n], image_ts[:n], paths_r[:n]

    imu = _read_csv(os.path.join(mav, "imu0", "data.csv"))
    imu_ts = imu[:, 0] * 1e-9
    imu_gyro = imu[:, 1:4].astype(np.float32)
    imu_acc = imu[:, 4:7].astype(np.float32)
    # drop IMU strictly before the first frame, keeping one leading sample
    # (mono_inertial_euroc.cc's first_imu scan)
    k = int(np.searchsorted(imu_ts, image_ts[0], side="right"))
    k = max(k - 1, 0)
    imu_ts, imu_gyro, imu_acc = imu_ts[k:], imu_gyro[k:], imu_acc[k:]

    gt_ts = gt_p = gt_q = None
    gt_csv = os.path.join(mav, gt_subdir, "data.csv")
    if os.path.exists(gt_csv):
        gt = _read_csv(gt_csv)
        gt_ts = gt[:, 0] * 1e-9
        gt_p = gt[:, 1:4]
        gt_q = gt[:, 4:8]  # wxyz
    return AslSequence(paths, image_ts, imu_ts, imu_gyro, imu_acc, gt_ts, gt_p, gt_q,
                       image_paths_right=paths_r)


def load_euroc(seq_dir: str, times_file: str | None = None,
               stereo: bool = False) -> AslSequence:
    """EuRoC MAV sequence (GT in state_groundtruth_estimate0)."""
    return _load_asl(seq_dir, "state_groundtruth_estimate0", times_file, stereo)


def load_tumvi(seq_dir: str, times_file: str | None = None,
               stereo: bool = False) -> AslSequence:
    """TUM-VI sequence (GT in mocap0)."""
    return _load_asl(seq_dir, "mocap0", times_file, stereo)


def imu_batches(seq: AslSequence):
    """Per-frame IMU sample batches in the tracker's queue format: an
    iterator whose item i is the list of (ts_s, gyro(3,), acc(3,)) samples
    in (prev_frame_ts, frame_ts], the window `Tracking::PreintegrateIMU`
    integrates (`datasets/render.py:imu_batches` on the sequence's
    arrays)."""
    return iter(render.imu_batches(seq.image_ts, seq.imu_ts, seq.imu_gyro, seq.imu_acc))
