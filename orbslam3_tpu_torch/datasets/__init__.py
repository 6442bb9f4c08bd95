"""Datasets of the port: the textured-box renderer, the PNG codec, the
EuRoC / TUM-VI (ASL layout), KITTI odometry and TUM RGB-D loaders, and the
synthetic EuRoC and TUM RGB-D writers.

Port of `orbslam3_tpu/datasets/`, with the same exports. Loading is host
Python (ORB-SLAM3's per-dataset example mains, e.g. Examples/
Monocular-Inertial/mono_inertial_euroc.cc `LoadImages` / `LoadIMU`);
frames stream into `Slam.track_*` on the card.
"""

from .euroc import AslSequence, imu_batches, load_euroc, load_tumvi
from .kitti import KittiSequence, load_kitti
from .tum_rgbd import TumRgbdSequence, load_tum_rgbd

__all__ = [
    "AslSequence", "load_euroc", "load_tumvi", "imu_batches",
    "KittiSequence", "load_kitti",
    "TumRgbdSequence", "load_tum_rgbd",
]
