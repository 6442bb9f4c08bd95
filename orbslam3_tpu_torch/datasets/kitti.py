"""KITTI odometry sequence loader.

Port of `orbslam3_tpu/datasets/kitti.py`, reading PNGs with the port's own
codec (`datasets/imageio.py`). Layout: <seq>/image_0/NNNNNN.png (+ image_1
for stereo), <seq>/times.txt, optional GT poses file (12 floats per line,
3x4 row-major T_w_cam). Reference: ORB-SLAM3's
Examples/Monocular/mono_kitti.cc `LoadImages`.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from orbslam3_tpu_torch.datasets import imageio


@dataclasses.dataclass
class KittiSequence:
    image_paths: list
    image_ts: np.ndarray                  # (N,) seconds
    image_paths_right: list | None = None
    gt_poses: np.ndarray | None = None    # (N,3,4) T_w_cam

    def __len__(self):
        return len(self.image_paths)

    def read_image(self, i: int, right: bool = False) -> np.ndarray:
        paths = self.image_paths_right if right else self.image_paths
        return imageio.imread(paths[i], grey=True)


def load_kitti(seq_dir: str, poses_file: str | None = None,
               stereo: bool = False) -> KittiSequence:
    ts = np.loadtxt(os.path.join(seq_dir, "times.txt"), ndmin=1)
    d0 = os.path.join(seq_dir, "image_0")
    names = sorted(n for n in os.listdir(d0) if n.endswith(".png"))
    paths = [os.path.join(d0, n) for n in names]
    paths_r = None
    if stereo:
        d1 = os.path.join(seq_dir, "image_1")
        paths_r = [os.path.join(d1, n) for n in names]
    n = min(len(paths), len(ts))
    gt = None
    if poses_file and os.path.exists(poses_file):
        gt = np.loadtxt(poses_file).reshape(-1, 3, 4)[:n]
    return KittiSequence(paths[:n], ts[:n], paths_r[:n] if paths_r else None, gt)
