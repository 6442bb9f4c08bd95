#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card.

Usage, from the repository root on a machine with a card and nvcc:

    python3 chip_smoke.py

It builds the port's CUDA kernels from `orbslam3_tpu_torch/csrc/` with one
nvcc call and holds each kernel against its plain PyTorch version on the
card. Then it drives, at the EuRoC operating point (752x480, 1200
features, 8 levels, x1.2; 2048 map-point candidates):

- the tracking front end (`extract_features` -> `fused_track_pose`) on
  one seeded frame against a back-projected map, checking the recovered
  pose;
- monocular SLAM (`Slam.track_monocular`) over a rendered 40-frame
  sequence: the frame the map initialized at, the tracked share, the
  keyframe and point counts, the Sim3-aligned ATE against the rendered
  poses, K1's launches per matcher policy and K2's per frame, then its
  first 20 frames once more through the kernels' plain versions, a run
  that must launch no kernel and agree with the kernel run's state after
  them;
- mono-inertial SLAM (`Slam(sensor=IMU_MONOCULAR).track_monocular(...,
  imu=...)`) over a rendered 120-frame sequence with 200 Hz IMU
  (`vi_sequence`): the IMU initialization, the VIBA1/VIBA2 ladder, the
  tracked share, the metric ATE (no scale alignment), the keyframe scale
  and the gravity tilt against the rendered truth and the JAX package's
  run on the same images, the kernels' launches, and a plain-kernel rerun
  of the first 45 frames (past the IMU init) that must launch no kernel
  and agree with the kernel run's state after them;
- stereo SLAM (`Slam.track_stereo`) over 40 raw pairs of EuRoC's
  distorted, rotated stereo rig along the mono orbit, rectified on the
  card; RGB-D SLAM (`Slam.track_rgbd`) over 40 frames with uint16 depth
  at TUM fr1's operating point (640x480, 1000 features); stereo-inertial
  SLAM over `vi_sequence`'s 120 frames seen by the raw pair, with its IMU.
  Each takes its settings from a YAML text parsed by the port's
  `Settings`, is held to the JAX package's run on the same inputs
  (init frame, tracked share, metric ATE; the IMU ladder's stage), counts
  K1's launches under the `stereo` policy (once a frame) and K2's (twice
  a frame on a pair), and is rerun through the plain versions (the
  stereo-inertial run over its first 45 frames, as the mono-inertial);
- mono SLAM with the shipped vocabulary (`Slam(vocab=...)`, loop closing
  on, global BA inline) over four rendered sessions (`loop_sequences`):
  an orbit past 2 pi whose closing views return to the opening ones (a
  loop must fire at the JAX package's keyframes), `change_dataset()` and
  a second session that re-observes the opening arc (a merge at the JAX
  package's frame), `add_client(1)` on the merged map (its first frame
  relocalizes, every frame tracks within 2 cm / 1 deg after the map's
  Sim3 alignment), and localization mode (no keyframe). It counts K1
  under the `loop`, `fuse` (in the correction) and `reloc` policies,
  prints the loop closer's stages, and is rerun through the plain
  versions, which must agree on the events and the map;
- atlas save and load: the vocabulary phase's atlas written by
  `save_atlas`, read back by `Slam(load_atlas_from=...)` on the card
  (every array equal, a database row per keyframe), then localization mode
  on client 1's views (relocalized on the first, 5/5 within 2 cm / 1 deg,
  no keyframe), with the file's size and the save and load times;
- the edge server (the ORB-SLAM3 fork's mono_inertial_edge deployment):
  `Slam(sensor=IMU_MONOCULAR, vocab=...)` behind an `EdgeServer` on
  127.0.0.1, two `FakePhone`s that extract on the card (K2) and stream
  SlamPktVI packets with their IMU in lockstep (phone 0 the mono-inertial
  phase's first 60 frames, phone 1 ten frames of a revisit after phone
  0's frame 45), then one acoustic round: the C++ codec, the 1000/500
  budgets, client 0's init, IMU init and metric ATE and client 1's
  relocalization against the JAX package's run on the same packets, K1
  under five policies on the server; the stream again through the plain
  versions;
- mono SLAM with async mapping: the mono phase's frames with
  `async_mapping=True`, held to the mono bounds, its ms/frame beside the
  synchronous run's.
- the distributed back end: the mono phase's map through `map_to_blocks`
  -> `serialize_block` -> `deserialize_block` -> `blocks_to_map` (every
  valid row back, uids and flags too; points added afterwards take fresh
  uids); the landmark-sharded BA (`make_sharded_ba`) at world size 1 over
  NCCL on the card on that map's whole problem, held to the same call over
  gloo on the CPU (1e-4) and to `bundle_adjust` (R 2e-3, t 5e-3), with its
  ms per iteration; then the two-process app
  (`orbslam3_tpu_torch.apps.multihost`, the JAX app's defaults: 120
  frames, 1500 points, 8 BA iterations) with both ranks on the card over
  gloo, rank 0 in this process and rank 1 in its own with a deadline: both
  join a group of 2, rank 0 welds rank 1's map and its merged-map ATE
  stays within 3x the JAX package's on the same arguments, K1 runs under
  four policies in both ranks and is exact on rank 0's inputs;
- the failure and lifecycle paths, in three parts: (a) mono-inertial SLAM
  with the vocabulary over the mono-inertial phase's frames, each map
  starting at small capacity tiers, with faults at fixed frames
  (`lifecycle_plan`: 10 dropped frames, a backward timestamp that stores
  the map and spawns a new one, a 3 s forward gap that resets the young
  one, `bad_imu` that resets it again), its events, capacity events, maps,
  tracked share and last map's metric ATE held to the JAX package's run
  on the same frames, and its frames up to the respawn rerun through the
  plain versions; (b) a global BA on its thread over the vocabulary
  phase's merged map while client 1 tracks 12 new views: no error, the
  keyframes made meanwhile caught up, the solve within R 2e-3 / t 5e-3 of
  the inline one on the same snapshot; (c) the edge server with each
  phone on its own thread at 20 Hz whatever the replies (phone 1 from
  2.25 s on): per lane the packets sent, dropped, skipped and answered,
  the reply delays, replies in frame order, client 0 initialized, client
  1 relocalized and then tracked, then an acoustic round. (b) and (c)
  depend on timing and have no plain rerun;
- the dataset runners on sequences the port's writers put on disk and its
  PNG codec reads back: `apps/run_euroc --imu --save-tum` over a 48-frame
  EuRoC-layout sequence at 752x480 (the IMU initializes inside it,
  `utils.timing.transfer_audit` around three tracked frames), `eval_ate`
  on its saved trajectory (the same ATE), `run_euroc --tumvi --stereo
  --imu` over 45 frames of a TUM-VI-layout KB8 fisheye pair at 512x512
  (the first fisheye SLAM run; its first 10 frames again through the plain
  versions), `run_rgbd` over 20 TUM RGB-D frames at 640x480, each held to
  the JAX apps on the same files (init and IMU-init frames, `iba_stage`,
  tracked share, metric ATE); `build_vocab` (K2 on the card) loaded back,
  `opt_analy --mode all` against the CPU, and the codec's decode and
  `resize_linear` times.

The phases' inputs are rendered ahead, in RENDER_WORKERS spawned
processes, while the card runs the earlier phases; each phase logs how
long it waited for its inputs. Each path is driven with the launch counters set to 0 just before it and
read just after, and fails if a kernel of the path was not launched. The
mono, stereo, RGB-D, vocabulary and async phases and the inertial paths
(mono-inertial, stereo-inertial, the edge server, the EuRoC and TUM-VI
runners) print their retry-ladder attempts, and fail unless every attempt
replayed captured CUDA graphs; the inertial paths print their
visual-inertial pose solves and fail unless every one replayed a captured
CUDA graph; the async phase, monocular, prints its count too. The
timings phase times both kernels by replaying a captured CUDA graph (so
their device time is not hidden behind host launch overhead) at the inputs
the SLAM runs handed them: K1 at one captured mask of each matcher policy
(tracker, init, triangulation, fuse; the stereo run's row band; the
vocabulary run's loop and reloc masks and one real bow mask) and at one
full-size fisheye pair's all-valid mask, each held exactly against the
plain version, beside its library call and its byte bound; K1 also under four
masks at the tracker's shape and at narrow widths, and the launch floor (a
one-element op under the same replay). Each phase prints one line with its
wall seconds. The line before the last is the kernels' JSON record; the
last line is ``{"ok": true, "device": {...}}``. Any failed phase raises, so
the script exits non-zero and prints no result; so does a machine without a
card. It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import multiprocessing
import io
import json
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from orbslam3_tpu_torch import _build, convert
from orbslam3_tpu_torch.core import lie
from orbslam3_tpu_torch.core.camera import Camera
from orbslam3_tpu_torch.config import Settings
from orbslam3_tpu_torch.datasets import imageio, load_euroc
from orbslam3_tpu_torch.datasets.render import (BoxScene, imu_batches, orbit_sequence,
                                                orbit_stereo_sequence, orbit_views, rgbd_sequence,
                                                stereo_extrinsics, vi_sequence)
from orbslam3_tpu_torch.apps import build_vocab, eval_ate, opt_analy, run_euroc, run_rgbd
from orbslam3_tpu_torch.apps import multihost as multihost_app
from orbslam3_tpu_torch.apps.edge_server import fuse_acoustic
from orbslam3_tpu_torch.distributed import map_blocks, multihost, sharded_ba
from orbslam3_tpu_torch.distributed import mesh as dist_mesh
from orbslam3_tpu_torch.edge import acoustic, wire
from orbslam3_tpu_torch.edge.client_sim import FakePhone
from orbslam3_tpu_torch.edge.server import (K_TRACK, N_FEATURES_INIT, N_FEATURES_TRACKING,
                                            EdgeServer)
from orbslam3_tpu_torch.engine import global_ba, local_mapping
from orbslam3_tpu_torch.engine.global_ba import GlobalBA
from orbslam3_tpu_torch.engine.local_mapping import LocalMapperConfig
from orbslam3_tpu_torch.engine.loop_closing import LoopCloser
from orbslam3_tpu_torch.engine.system import Sensor, Slam, SystemConfig
from orbslam3_tpu_torch.engine.track_program import fused_track_pose
from orbslam3_tpu_torch.engine.tracking import TrackerConfig
from orbslam3_tpu_torch.evaluation import aligned_pose_errors, ate_rmse, vi_metrics
from orbslam3_tpu_torch.imu.preintegration import ImuCalib
from orbslam3_tpu_torch.kernels import hamming, image, patch
from orbslam3_tpu_torch.kernels import orb_descriptor as desc_k
from orbslam3_tpu_torch.opt.ba import bundle_adjust
from orbslam3_tpu_torch.place.vocab import Vocabulary, load_default_vocabulary
from orbslam3_tpu_torch.slam_map.map_state import MapConfig
from orbslam3_tpu_torch.utils import timing
from orbslam3_tpu_torch.utils.synth import orbit_trajectory
from orbslam3_tpu_torch.vision.frame import extract_features, wire_arrays
from orbslam3_tpu_torch.vision.stereo import fisheye_stereo_match

# The operating point: __graft_entry__.py (EuRoC ORBextractor.nFeatures
# 1200, 752x480, 8 levels, x1.2) and the tracker's defaults
# (engine/tracking.py TrackerConfig: local_points_cap 2048, radii
# 15/30/60/8 px, min_track_matches 20, min_inliers_ok 15, max_mp_dist 100).
H, W = 480, 752
N_FEATURES, N_LEVELS, SCALE = 1200, 8, 1.2
K_CANDIDATES = 2048
RADII = (15.0, 30.0, 60.0, 8.0)
MIN_MATCHES, MIN_INLIERS, MAX_DIST = 20, 15, 100
CAMERA = (458.654, 457.296, 367.215, 248.375)  # EuRoC cam0 fx fy cx cy
SEED = 0

# Bounds of the checks, with their reasons.
ROT_TOL = 1e-3      # rad: observations are exact reprojections of the map
TRANS_TOL = 5e-3    # m, at 2-8 m depth
MATCH_SHARE = 0.8   # of valid features matched after refinement
AGREE_POSE_TOL = 1e-5  # kernel vs plain front end: same ops, exact kernels

# Published H100 SXM peaks (NVIDIA data sheet; at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

# Mono SLAM: `orbit_sequence`'s defaults (BoxScene.default(seed=7), 40
# frames at 20 fps, a 2 m orbit around (4, 2, 9) over 1.0 rad) at 752x480,
# the tracker and mapper at their defaults but for 1200 features. The JAX
# package on the same images (scripts/port_mono_reference.py, CPU):
# initialized at frame 4, tracked every later frame, 14 keyframes, 1644
# points, Sim3-aligned ATE 0.01877 m. The port may initialize on other
# RANSAC draws and sums in another order, so its ATE is held to that
# number times ATE_MARGIN.
SLAM_FRAMES = 40
REFERENCE_ATE = 0.01877  # m
ATE_MARGIN = 3.0
MAX_INIT_FRAME = 10
TRACKED_SHARE = 0.8      # of the frames from the init frame on
# kernel vs plain SLAM runs: the kernels are exact and the port sums in a
# fixed order (BA's segment sums), so the runs agree exactly on the card
# (three runs on an H100 agreed bit for bit); the init frame, keyframe and
# point counts must agree, camera centres within this (m), 10x under what
# one flipped keyframe decision moves them
AGREE_CENTRE_TOL = 1e-4
POLICIES = ("tracker", "init", "triangulation", "fuse")

# Mono-inertial SLAM: `vi_sequence`'s defaults (the EuRoC writer's
# `excited_trajectory` in BoxScene.default(seed=3): a 3 m orbit over 1.0 rad
# with 5 cm / 0.06 rad shake, 120 frames at 20 fps, IMU at 200 Hz with
# noise, body == camera) at 752x480 and 1200 features, `ImuCalib.create()`
# (EuRoC's noise densities), the tracker and mapper at their defaults but
# for the ladder's cadence, shortened for a 6 s clip as
# tests/test_vi_golden.py shortens it. The JAX package on the same images
# and samples (CPU):
#     python scripts/port_vi_reference.py --frames 120 --width 752 --height 480 --features 1200
# initialized the map at frame 6 and the IMU at frame 40 (keyframe uid 18),
# ran VIBA1 at frame 71 and VIBA2 at frame 102 (iba_stage 2), tracked every
# frame from init, kept 17 keyframes (77 made) and 2093 points; metric ATE
# 0.014848 m (Sim3-aligned 0.014486 m), keyframe scale 0.99721, gravity
# tilt 0.408 deg.
VI_FRAMES = 120
VI_CADENCE = dict(viba1_after_s=1.5, viba2_after_s=3.0, scale_refine_every_s=1.5)
VI_REFERENCE = dict(iba_stage=2, ate_metric=0.014848, kf_scale=0.99721,
                    gravity_tilt_deg=0.408)
VI_ATE_MARGIN = 3.0       # other RANSAC draws and summation orders, as above
VI_SCALE_FLOOR = 0.05     # |s - 1| bound: max(this, 2x the JAX package's)
# The two inertial phases rerun their first 45 frames, not all 120, through
# the plain versions (past the IMU init at frames 40-42, before VIBA1), to
# keep the script near 930 s of phases with the runner phase
PLAIN_PREFIX = 45
MONO_PREFIX = 20    # frames of the mono run rerun through the plain versions

# Stereo and RGB-D: the settings are parsed from these YAML texts by the
# port's `Settings` (the card's machine has no PyYAML). EuRoC's raw pair as
# ORB-SLAM3's Examples/Stereo/EuRoC.yaml gives it (the dataset's
# mav0/cam{0,1}/sensor.yaml): rad-tan intrinsics of both cameras and
# T_c1_c2, a 0.110 m baseline with 0.8 deg of rotation, mostly about x.
EUROC_CAM0 = ((458.654, 457.296, 367.215, 248.375),
              (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05))
EUROC_CAM1 = ((457.587, 456.134, 379.999, 255.238),
              (-0.28368365, 0.07451284, -0.00010473, -3.55590700e-05))
EUROC_T_C1_C2 = np.array([
    [0.999997256477797, -0.002317135723275, -0.000343393120620, 0.110074137800478],
    [0.002312067192432, 0.999898048507103, -0.014090668452683, -0.000156612054392],
    [0.000376008102320, 0.014089835846691, 0.999900662638081, 0.000889382785432],
    [0.0, 0.0, 0.0, 1.0]])


def euroc_yaml(imu: bool, scale: float = 1.0, n_features: int = 1200) -> str:
    """EuRoC's stereo (or, with `imu`, stereo-inertial) settings; `scale`
    shrinks the images and intrinsics (the CPU tests run at 0.5)."""
    f0, f1 = ([v * scale for v in cam[0]] for cam in (EUROC_CAM0, EUROC_CAM1))
    d0, d1 = EUROC_CAM0[1], EUROC_CAM1[1]
    rows = ",\n         ".join(", ".join(repr(float(v)) for v in r) for r in EUROC_T_C1_C2)
    text = f"""%YAML:1.0
File.version: "1.0"
Camera.type: "PinHole"
Camera1.fx: {f0[0]}
Camera1.fy: {f0[1]}
Camera1.cx: {f0[2]}
Camera1.cy: {f0[3]}
Camera1.k1: {d0[0]}
Camera1.k2: {d0[1]}
Camera1.p1: {d0[2]}
Camera1.p2: {d0[3]}
Camera2.fx: {f1[0]}
Camera2.fy: {f1[1]}
Camera2.cx: {f1[2]}
Camera2.cy: {f1[3]}
Camera2.k1: {d1[0]}
Camera2.k2: {d1[1]}
Camera2.p1: {d1[2]}
Camera2.p2: {d1[3]}
Camera.width: {round(W * scale)}
Camera.height: {round(H * scale)}
Camera.fps: 20
Camera.RGB: 1
Stereo.ThDepth: 60.0
Stereo.T_c1_c2: !!opencv-matrix
  rows: 4
  cols: 4
  dt: f
  data: [{rows}]
ORBextractor.nFeatures: {n_features}
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""
    if imu:  # EuRoC's IMU noise (Examples/Stereo-Inertial/EuRoC.yaml); body == cam0
        text += """IMU.T_b_c1: !!opencv-matrix
  rows: 4
  cols: 4
  dt: f
  data: [1.0, 0.0, 0.0, 0.0,
         0.0, 1.0, 0.0, 0.0,
         0.0, 0.0, 1.0, 0.0,
         0.0, 0.0, 0.0, 1.0]
IMU.NoiseGyro: 1.7e-4
IMU.NoiseAcc: 2.0000e-3
IMU.GyroWalk: 1.9393e-05
IMU.AccWalk: 3.0000e-03
IMU.Frequency: 200.0
"""
    return text


EUROC_STEREO_YAML = euroc_yaml(imu=False)
EUROC_STEREO_INERTIAL_YAML = euroc_yaml(imu=True)
# TUM fr1 (ORB-SLAM3's Examples/RGB-D/TUM1.yaml) as an ideal pinhole, the
# way the JAX package's TUM writer renders: 640x480, 1000 features,
# Camera.bf 40, ThDepth 40, depth as uint16 at DepthMapFactor 5000
TUM1_INTRINSICS = (517.306408, 516.469215, 318.643040, 255.313989)
TUM1_SIZE = (480, 640)


def tum1_yaml(scale: float = 1.0, n_features: int = 1000) -> str:
    """TUM fr1's RGB-D settings; `scale` shrinks the images and intrinsics."""
    fx, fy, cx, cy = (v * scale for v in TUM1_INTRINSICS)
    return f"""%YAML:1.0
Camera.type: "PinHole"
Camera.fx: {fx}
Camera.fy: {fy}
Camera.cx: {cx}
Camera.cy: {cy}
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: {round(TUM1_SIZE[1] * scale)}
Camera.height: {round(TUM1_SIZE[0] * scale)}
Camera.fps: 30.0
Camera.bf: {40.0 * scale}
Camera.RGB: 1
ThDepth: 40.0
DepthMapFactor: 5000.0
ORBextractor.nFeatures: {n_features}
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


TUM1_RGBD_YAML = tum1_yaml()
# The three depth phases: stereo over 40 frames of the mono phase's orbit
# seen by EuRoC's raw pair (rectified on the card), RGB-D over 40 frames of
# `rgbd_sequence` (the TUM writer's sequence) at TUM fr1's operating point,
# stereo-inertial over `vi_sequence`'s 120 frames and 200 Hz IMU with the
# raw pair and the mono-inertial phase's ladder cadence (s held at 1). The
# JAX package on the same images and samples (CPU,
# scripts/port_stereo_reference.py --phase stereo|rgbd|stereo_vi):
# stereo initialized at frame 0, tracked all 40 frames, 4 keyframes, 1853
# points, metric ATE 0.021085 m; RGB-D at frame 0, all 40, 5 keyframes, 1293
# points, 0.017006 m; stereo-inertial at frame 0, the IMU at frame 42
# (keyframe uid 9), VIBA1 / VIBA2 at frames 78 / 105, iba_stage 2, all 120
# tracked, 20 keyframes, 2573 points, metric ATE 0.024705 m, gravity tilt
# 2.460 deg (against the truth turned into the rectified camera). The port
# may take other keyframe decisions on sums in another order, so its ATE is
# held to 3x.
STEREO_FRAMES = 40
RGBD_FRAMES = 40
STEREO_VI_FRAMES = 120
MAX_DEPTH_INIT_FRAME = 2
STEREO_REFERENCE = dict(ate_metric=0.021085)
RGBD_REFERENCE = dict(ate_metric=0.017006)
STEREO_VI_REFERENCE = dict(iba_stage=2, ate_metric=0.024705, gravity_tilt_deg=2.460)
DEPTH_ATE_MARGIN = 3.0
DEPTH_POLICIES = ("tracker", "triangulation", "fuse")  # no two-view init

# Mono SLAM with a vocabulary (`orbslam3_tpu/assets/vocab_100k.npz`, read by
# path): a drone or headset that comes back to where it started, then more
# phones streaming into the shared map. In BoxScene.default(seed=7), at the
# mono phase's operating point, loop closing on with global BA inline:
# (a) one orbit of `orbit_sequence`'s circle (2 m around (4, 2, 9)) over
#     LOOP_ARC rad, LOOP_FRAMES frames (~0.05 rad a frame), so the closing
#     views return to the opening ones: a loop must fire;
# (b) `change_dataset()`, then MERGE_FRAMES frames at MERGE_RADIUS m with the
#     arc run backwards from MERGE_START into the opening arc: a merge;
# (c) `add_client(1)` fed RELOC_ANGLES (new poses on the opening arc): its
#     first frame relocalizes; then localization mode, and client 0 tracks
#     LOCALIZE_FRAMES more frames of its backwards arc without a keyframe.
# Timestamps run on across the sessions, so each one names its view.
LOOP_ARC = 2 * np.pi + 0.6
LOOP_FRAMES = 139
MERGE_RADIUS = 2.3
MERGE_FRAMES = 40
MERGE_START = 1.95            # rad past the opening view, run backwards
MERGE_STEP = -0.05
RELOC_ANGLES = tuple(0.225 + 0.05 * j for j in range(5))  # past the opening view
LOCALIZE_FRAMES = 5
SESSION_GAP_S = 1.0
# The JAX package on the same images and settings (CPU, 2065 s):
#     python scripts/port_loop_reference.py
# initialized at frame 2 and tracked every later frame; the loop fired at
# frame 119, keyframe uid 117 matched to uid 6 (frame 8), scale 0.986;
# 66 keyframes, 6232 points, Sim3-aligned ATE 0.011737 m; the merge fired
# at merge-session frame 15 (uid 142 matched to uid 23, frame 25), the
# merged map 66 + 12 keyframes; client 1 relocalized on its first frame and
# tracked 5/5 with centre errors 0.31-1.20 cm and 0.035-0.064 deg after the
# merged map's Sim3 alignment; localization mode tracked 5/5, no keyframe.
LOOP_REFERENCE = dict(ate=0.011737, loop_kf_uid=117, loop_matched_uid=6, merge_frame=15,
                      reloc_centre_err_m=0.01205, reloc_rot_err_deg=0.064)
LOOP_UID_TOL = 3            # keyframes: the loop's and merge's keyframes
MERGE_FRAME_TOL = 3         # frames of the merge session
OPENING_FRAMES = 20         # loop-session frames of the opening arc (~1 rad)
LOOP_ATE_MARGIN = 3.0
RELOC_TOL = (0.02, 1.0)     # m, deg: client 1 after the map's Sim3 alignment
VOCAB_POLICIES = ("tracker", "init", "triangulation", "fuse", "loop", "reloc")
# The edge server: the ORB-SLAM3 fork's deployment (mono_inertial_edge),
# phones that extract ORB on the device and stream keypoints, descriptors
# and 200 Hz IMU over TCP to one server with a shared atlas. The server's
# Slam is IMU_MONOCULAR with the shipped vocabulary, from
# euroc_yaml(imu=True, n_features=EDGE_FEATURES) (EuRoC cam0, the phone
# protocol's 1000-feature ceiling; the mono-inertial phase's ladder
# cadence), synchronous mapping, behind an EdgeServer on 127.0.0.1 with
# max_clients 2. Phone 0 streams the first EDGE_FRAMES frames of the
# mono-inertial phase's `vi_sequence`; phone 1 connects after phone 0's
# frame EDGE_JOIN_AFTER and streams frames EDGE_CLIENT1 (a revisit of the
# mapped area) EDGE_CLIENT1_OFFSET_S later, alternating with phone 0. One
# packet is in flight at a time (each is sent after the previous reply),
# so a run is deterministic, and the whole stream is rerun through the
# kernels' plain versions.
EDGE_FEATURES = 1000
EDGE_FRAMES = 60
EDGE_JOIN_AFTER = 45
EDGE_CLIENT1 = tuple(range(10, 20))
EDGE_CLIENT1_OFFSET_S = 10.0
EDGE_WAIT_S = 300.0          # deadline of one reply
EDGE_ACOUSTIC_TOL = 0.01     # m: cal_acoustic's distance against the truth
EDGE_FUSE_RESIDUAL = 1e-3    # m: |d - |p - a|| after optimize_position_given_scale
EDGE_FUSE_CPU_TOL = 1e-5     # of the largest coordinate: a solve on the card against the CPU
EDGE_FUSE_GRAD = 1e-4        # |J^T r| (f64, numpy) at the 6-phone solution: a stationary point
EDGE_FUSE_NOISE_M = 0.005    # m: seeded range noise of the 6-phone solve (one sample is 7.2 mm)
EDGE_TRACKED_SHARE = 0.8
EDGE_FRAME_TOL = 2           # frames: client 0's init and IMU-init frames
EDGE_MARGIN = 3.0            # client 0's metric ATE, client 1's centre errors
EDGE_POLICIES = ("tracker", "init", "triangulation", "fuse", "reloc")
# The JAX package on the same packet stream (CPU, 526 s; the port's
# extract_features on the CPU playing the phones at the budgets the JAX
# server sent back):  python scripts/port_edge_reference.py
# client 0 initialized at frame 6 (budgets 1000 then 500 from frame 7),
# the IMU at frame 42, tracked every frame from 6, 11 keyframes, 740
# points, metric ATE 0.006249 m (Sim3 0.006133 m) over 54 poses; phone 1's
# frames 0 and 5 were tracked (8 left to the 1-in-5 rule), both
# relocalized, centre errors 0.35 / 0.60 cm and 1.06 deg after the map's
# Sim3 alignment; cal_acoustic 1.12832 m for a true 1.12922 m.
EDGE_REFERENCE = dict(init_frame=6, imu_init_frame=42, ate_metric=0.006249,
                      client1_reloc_at=0, client1_centre_err_m=0.006017,
                      client1_rot_err_deg=1.056)
# A fisheye pair for K1's all-valid mask: TUM-VI's KB8 cameras (cam0/cam1
# of its calibration) at their 512x512 and 1000 features, a 0.101 m
# baseline, one frame of the mono phase's orbit.
TUMVI_CAM0 = (190.97847715128717, 190.9733070521226, 254.93170605935475, 256.8974428996504,
              0.0034823894022493434, 0.0007150348452162257, -0.0020532361418706202,
              0.00020293673591811182)
TUMVI_CAM1 = (190.44236969414825, 190.4344384721956, 252.59949716835982, 254.91723064636983,
              0.0034003170790442797, 0.001766278153469831, -0.00266312569781606,
              0.0003299517423931039)
FISHEYE_SIZE, FISHEYE_FEATURES = 512, 1000
# The distributed phase: the sharded BA at world size 1 on the mono phase's
# map (every keyframe and point, the first keyframe fixed), NCCL on the
# card against gloo on the CPU and against bundle_adjust with
# tests/test_sharded_ba.py's bounds; then the two-process app at the JAX
# app's defaults (apps/run_multihost.py: 120 frames, 1500 points, 500
# features at 640x480, 8 BA iterations), both ranks on the one card over
# gloo (NCCL refuses two ranks on one device). Its bound comes from the JAX
# package on the CPU with the same arguments
# (python scripts/port_multihost_reference.py): two segments of 9
# keyframes (607 and 684 points), 18 keyframes welded, 1291 points, 5052
# observations, cost 669.40 -> 635.52, merged-map keyframe ATE 170.198 mm.
# The merged map is poor by design: each session has its own monocular
# gauge and the weld takes the identity Sim3.
SHARDED_ITERS = 8
SHARDED_CPU_TOL = 1e-4          # R entries and t: NCCL on the card against gloo on the CPU
SHARDED_BA_TOL = (2e-3, 5e-3)   # R, t against bundle_adjust (tests/test_sharded_ba.py)
MULTIHOST_ARGS = ("--n-frames", "120", "--n-points", "1500", "--ba-iters", "8")
MULTIHOST_REFERENCE = dict(ate_mm=170.198, welded_kfs=18)
MULTIHOST_ATE_MARGIN = 3.0
MULTIHOST_WAIT_S = 300.0        # deadline of rank 1's process after rank 0 returns
MULTIHOST_POLICIES = ("tracker", "init", "triangulation", "fuse")

# The runner phase: the dataset mains on sequences the port's writers put
# on disk (`datasets/synth_euroc.py`, `datasets/tum_rgbd.py`), read back
# through the port's PNG codec and loaders. The EuRoC layout at 752x480 with
# the mono-inertial phase's trajectory (BoxScene.default(seed=3), a 3 m
# orbit, 5 cm / 0.06 rad shake, 200 Hz IMU with noise) over 48 frames, so
# the IMU initializes inside the run at the mapper's default 2 s; its arc
# keeps the mono-inertial phase's 1/120 rad a frame. The TUM-VI layout:
# TUM-VI cam0's KB8 focal lengths and distortion (the writer centres the
# principal point at 256, 256) at 512x512 and 1000 features, a 0.101 m
# baseline, the same trajectory at 20 Hz over 45 frames (the fisheye pair
# tracks at ~1.5 s a frame on the card; the IMU initializes at frame ~40),
# the ground truth under mocap0. The TUM RGB-D layout at TUM fr1's
# 640x480, focal lengths and 1000 features (the writer's pinhole,
# centred), 20 frames along the RGB-D phase's path. All three run with the apps' defaults (the shipped
# vocabulary, the mapper's default IMU cadence).
RUNNER_EUROC = dict(n_frames=48, width=W, height=H, fx=CAMERA[0], fy=CAMERA[1], seed=3,
                    radius=3.0, arc=0.4, n_features=N_FEATURES, excitation=0.05,
                    rot_excitation=0.06)
RUNNER_TUMVI = dict(n_frames=45, width=FISHEYE_SIZE, height=FISHEYE_SIZE, fx=TUMVI_CAM0[0],
                    fy=TUMVI_CAM0[1], fisheye=True, kb8_dist=TUMVI_CAM0[4:8],
                    stereo_baseline=0.101, n_features=FISHEYE_FEATURES, seed=3, radius=3.0,
                    arc=0.375, excitation=0.05, rot_excitation=0.06)
RUNNER_TUM = dict(n_frames=20, width=TUM1_SIZE[1], height=TUM1_SIZE[0],
                  fx=TUM1_INTRINSICS[0], fy=TUM1_INTRINSICS[1], n_features=1000, arc=0.5)
RUNNER_PREFIX = 10          # frames of the fisheye run rerun through the plain versions
# The JAX apps on the same files (CPU; python scripts/port_runner_reference.py,
# which writes them with `write_runner_sequences`): EuRoC mono-inertial
# initialized at frame 5, the IMU at frame 41, iba_stage 0, all 43 frames
# from init tracked, 10 keyframes, 1219 points, metric ATE 0.011545 m;
# TUM-VI fisheye stereo-inertial at frame 0, the IMU at frame 40, iba_stage
# 0, all 45 tracked, 9 keyframes, 1254 points, metric ATE 0.004105 m;
# TUM RGB-D at frame 0, all 20 tracked, 3 keyframes, 1129 points, metric
# ATE 0.009564 m.
RUNNER_REFERENCE = dict(
    euroc=dict(init_frame=5, imu_init_frame=41, iba_stage=0, ate_metric=0.011545),
    tumvi=dict(init_frame=0, imu_init_frame=40, iba_stage=0, ate_metric=0.004105),
    tum=dict(init_frame=0, imu_init_frame=-1, iba_stage=0, ate_metric=0.009564))
RUNNER_FRAME_TOL = 2        # frames: init and IMU init against the JAX apps'
RUNNER_ATE_MARGIN = 3.0
EVAL_ATE_TOL = 1e-5         # m: eval_ate reads the saved TUM file's 7 decimals
RUNNER_AUDIT_FRAMES = (44, 45, 46)   # EuRoC frames tracked under transfer_audit
FISHEYE_POLICIES = ("tracker", "fisheye_stereo", "triangulation", "fuse")
OPT_ANALY_TOL = (0.1, 1e-2)  # abs (cm; calib's ratio and m), rel: the card against the CPU
RESIZE_TO = ((640, 408), (376, 240))  # resize_linear timed per EuRoC frame (2x: INTER_AREA)
# The lifecycle phase. (a) The failure ladder and the capacity tiers:
# `Slam(sensor=IMU_MONOCULAR)` with the shipped vocabulary (the BoW fallback
# and relocalization; global BA inline) over the mono-inertial phase's
# frames and IMU, each new map starting at small tiers and the IMU
# initialization span cut to 1 s, so the last map's IMU initializes inside
# the run. The tiers are half tests/test_soak.py's (16 keyframes, 2048
# points): over this run a map holds at most ~14 keyframes and ~1000
# points, so at 16 / 2048 nothing would grow. `lifecycle_plan` sends frames
# 0-19, drops 20-29 (their IMU samples come with frame 30), sends 30-34,
# turns the clock back 5 s at frame 35 (the map is stored and a new one
# spawned), forward 3 s at frame 47 while the new map's IMU is young (reset
# in place), sets `bad_imu` on the active map before frame 57 (reset), and
# ends at frame 89. The frames up to and including the respawn are rerun
# through the plain versions. (b) A global BA on its thread over the
# vocabulary phase's merged map while client 1 tracks LIFECYCLE_GBA_FRAMES
# new views (`gba_views_of_loop`), held to the inline solve on the same
# snapshot. (c) The edge server as deployed: the edge phase's phones each on
# its own thread, a packet every LIFECYCLE_PACE_S whatever the replies.
LIFECYCLE_TIERS = (8, 1024)
LIFECYCLE_MAPPER = dict(imu_init_min_span_s=1.0, **VI_CADENCE)
LIFECYCLE_DROPPED = (20, 30)
LIFECYCLE_BACKWARD, LIFECYCLE_BACK_S = 35, -5.0
LIFECYCLE_GAP, LIFECYCLE_GAP_S = 47, 3.0
LIFECYCLE_BAD_IMU = 57
LIFECYCLE_END = 90
LIFECYCLE_FRAME_TOL = 2     # frames: each event against the JAX package's
LIFECYCLE_SHARE = 0.8       # tracked share from each map's first tracked frame
LIFECYCLE_ATE_MARGIN = 3.0  # the last map's metric ATE against the JAX package's
# The JAX package on the same frames (CPU, 338 s; python
# scripts/port_lifecycle_reference.py): frames 0-5 initializing, then every
# frame tracked until the respawn at plan frame 25 (map 0: 6 keyframes, 859
# points, its IMU not yet initialized); the new map initialized at 30 and
# tracked to the gap at 37 (reset in place); the reset map initialized at
# 46, `bad_imu` at 47 (reset); the last map initialized at 55, grew its
# points 1024 -> 2048 at 66 and its keyframes 8 -> 16 at 71, its IMU
# initialized, every frame from its init tracked: 13 keyframes, 1021
# points, metric ATE 0.008068 m (Sim3 0.008065 m) over 25 poses, keyframe
# scale 1.00503, gravity tilt 0.062 deg.
LIFECYCLE_REFERENCE = dict(
    events=[dict(kind="timestamp_jump", frame=25, action="new_map"),
            dict(kind="timestamp_jump", frame=37, action="reset_map"),
            dict(kind="map_reset", frame=37, action=None),
            dict(kind="bad_imu_reset", frame=47, action=None),
            dict(kind="map_reset", frame=47, action=None)],
    capacity=[dict(kind="grow_points", frame=66, map_id=1),
              dict(kind="grow_keyframes", frame=71, map_id=1)],
    n_maps=2, tracked_share=1.0,
    last_segment=dict(ate_metric=0.008068, ate_sim3=0.008065, kf_scale=1.00503,
                      gravity_tilt_deg=0.062))
LIFECYCLE_GBA_FRAMES = 12
LIFECYCLE_GBA_TOL = (2e-3, 5e-3)  # R entries, t: the background solve against the inline one
LIFECYCLE_CATCH_UP_TOL = 1e-4     # a keyframe made during the solve keeps its pose to its parent
LIFECYCLE_PACE_S = 0.05     # 20 Hz, EuRoC's camera rate
LIFECYCLE_JOIN_S = 2.25     # phone 1 starts with phone 0's frame EDGE_JOIN_AFTER
LIFECYCLE_RELOC_KFS = 5     # keyframes the tracker needs to relocalize a new client
RENDER_WORKERS = 3          # processes that render the phases' inputs ahead

PHASE_SECONDS = []          # each phase's wall seconds, in order

FRAMES = 10
KERNEL_ITERS = 200
PLAIN_ITERS = 20


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    torch.cuda.synchronize()
    PHASE_SECONDS.append(time.perf_counter() - t0)
    log(f"phase {name}: ok ({PHASE_SECONDS[-1]:.2f} s)")


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of `fn` over `iters` calls, CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, reps: int = 5) -> float:
    """Device milliseconds per call of `fn`: `iters` calls captured in one
    CUDA graph and replayed, so host launch overhead is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside capture: lazy init, allocator, library load
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def median_frame_ms(fn, frames: int = FRAMES) -> float:
    """Median milliseconds of `fn` over `frames` calls after two warm-ups."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(frames):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def textured_image(seed: int, h: int, w: int) -> torch.Tensor:
    """Integer-valued (h, w) image in [0, 255]: bicubically upsampled
    uniform noise, so FAST finds stable corners at every level."""
    rng = np.random.default_rng(seed)
    small = torch.from_numpy(rng.uniform(0, 255, (h // 4 + 2, w // 4 + 2))
                             .astype(np.float32))
    up = F.interpolate(small[None, None], size=(h, w), mode="bicubic",
                       align_corners=False)[0, 0]
    return torch.clamp(torch.round(up), 0, 255)


def make_map(feats, camera: Camera, R_true, t_true, k: int, seed: int) -> dict:
    """`k` map-point candidates: the frame's valid keypoints back-projected
    at seeded depths under the pose (R_true, t_true), carrying the frame's
    own descriptors, and the rest distractors in view with random
    descriptors; in a seeded random order. Returns the tensors and, per
    candidate, the feature it was made from (-1 for a distractor)."""
    dev = feats.uv.device
    g = torch.Generator().manual_seed(seed)
    valid = feats.valid.cpu()
    src = torch.nonzero(valid).flatten()
    n_real = src.numel()
    n_fake = k - n_real
    uv = torch.cat([feats.uv.cpu()[src],
                    torch.rand(n_fake, 2, generator=g) * torch.tensor([W - 1.0, H - 1.0])])
    depth = 2.0 + 6.0 * torch.rand(k, generator=g)
    octave = torch.cat([feats.octave.cpu()[src],
                        torch.randint(0, N_LEVELS, (n_fake,), generator=g,
                                      dtype=torch.int32)])
    desc = torch.cat([feats.desc.cpu()[src],
                      torch.randint(-2 ** 31, 2 ** 31, (n_fake, 8), generator=g,
                                    dtype=torch.int64).to(torch.int32)])
    origin = torch.cat([src, torch.full((n_fake,), -1, dtype=torch.int64)])
    perm = torch.randperm(k, generator=g)
    uv, depth, octave, desc, origin = (x[perm] for x in (uv, depth, octave, desc, origin))
    R, t = R_true.cpu(), t_true.cpu()
    xc = camera.to("cpu").unproject(uv) * depth[:, None]
    pts = (xc - t) @ R  # R^T (xc - t)
    center = -(R.T @ t)
    dist = torch.linalg.norm(pts - center, dim=-1)
    max_d = dist * 1.2 ** octave.float()
    return dict(
        mp_pos=pts.to(dev), mp_desc=desc.to(dev),
        mp_valid=torch.ones(k, dtype=torch.bool, device=dev),
        mp_normal=((pts - center) / dist[:, None]).to(dev),
        mp_min_d=(max_d / 1.2 ** 7).to(dev), mp_max_d=max_d.to(dev),
        origin=origin.to(dev))


def track(feats, mp: dict, camera: Camera, R_pred, t_pred):
    """`fused_track_pose` with the tracker's settings, on the frame."""
    return fused_track_pose(
        mp["mp_pos"], desc_k.descriptor_planes(mp["mp_desc"]), mp["mp_valid"],
        mp["mp_normal"], mp["mp_min_d"], mp["mp_max_d"], camera,
        feats.uv, desc_k.descriptor_planes(feats.desc), feats.octave, feats.valid,
        R_pred, t_pred, R_pred, t_pred, False, RADII, MIN_MATCHES, MIN_INLIERS,
        max_dist=MAX_DIST, device=feats.uv.device)


def known_poses(dev):
    """The true pose and the perturbed prediction tracking starts from."""
    R_true = lie.so3_exp(torch.tensor([0.02, -0.05, 0.01], device=dev))
    t_true = torch.tensor([0.10, -0.05, 0.20], device=dev)
    R_pred = lie.so3_exp(torch.tensor([0.004, 0.006, -0.003], device=dev)) @ R_true
    t_pred = t_true + torch.tensor([0.03, -0.02, 0.04], device=dev)
    return R_true, t_true, R_pred, t_pred


def pose_error(R, t, R_true, t_true) -> tuple[float, float]:
    """(rotation angle in rad, translation distance): the angle from the
    skew part of R R_true^T, which stays precise for small angles."""
    dR = R @ R_true.T
    sin = torch.clamp(torch.linalg.norm(lie.vee(dR - dR.T)) * 0.5, max=1.0)
    return float(torch.asin(sin)), float(torch.linalg.norm(t - t_true))


@contextlib.contextmanager
def capture(module, name: str, keep=lambda args, kwargs: True):
    """Record the arguments of every call of `module.name` in the block
    for which `keep(args, kwargs)` holds."""
    calls = []
    fn = getattr(module, name)

    def recorder(*args, **kwargs):
        if keep(args, kwargs):
            calls.append((args, kwargs))
        return fn(*args, **kwargs)

    setattr(module, name, recorder)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def first_per(key):
    """A `capture` filter that keeps the first call of each `key(args,
    kwargs)`."""
    seen = set()

    def keep(args, kwargs):
        k = key(args, kwargs)
        if k in seen:
            return False
        seen.add(k)
        return True

    return keep


@contextlib.contextmanager
def plain_kernels():
    """Route the main path through the kernels' plain PyTorch versions."""
    saved = hamming.masked_top2, patch.gather_patches
    hamming.masked_top2 = lambda a, b, m, policy=None: hamming.masked_top2_reference(
        hamming._as_words(a), hamming._as_words(b), m)
    patch.gather_patches = patch.gather_patches_reference
    try:
        yield
    finally:
        hamming.masked_top2, patch.gather_patches = saved


def window_case(dev, n: int, m: int, seed: int):
    """Packed descriptors and a window-shaped mask as `search_by_projection`
    builds it (octave-scaled 15 px windows around projected points), with
    tied minima (duplicated candidates) and rows with no candidate."""
    g = torch.Generator().manual_seed(seed)
    a = torch.randint(-2 ** 31, 2 ** 31, (n, 8), generator=g, dtype=torch.int64)
    b = torch.randint(-2 ** 31, 2 ** 31, (m, 8), generator=g, dtype=torch.int64)
    half = min(n, m) // 2
    b[half:2 * half] = b[:half]             # every tie twice
    a[:half] = b[:half] ^ (torch.randint(0, 2, (half, 8), generator=g) << 3)
    mp_uv = torch.rand(n, 2, generator=g) * torch.tensor([float(W), float(H)])
    f_uv = mp_uv[torch.randint(0, n, (m,), generator=g)] + 6 * torch.randn(m, 2, generator=g)
    f_oct = torch.randint(0, N_LEVELS, (m,), generator=g)
    r = RADII[0] * 1.2 ** f_oct.float()
    d2 = torch.sum((mp_uv[:, None, :] - f_uv[None, :, :]) ** 2, dim=-1)
    mask = d2 <= (r * r)[None, :]
    mask[::17] = False                      # rows with no candidate
    return (a.to(torch.int32).to(dev), b.to(torch.int32).to(dev),
            mask.contiguous().to(dev))


def check_top2(got, ref, label: str) -> int:
    idx, best, second = got
    ridx, rbest, rsecond = ref
    has = rbest < hamming.BIG
    if not (torch.equal(best, rbest) and torch.equal(second, rsecond)
            and torch.equal(idx[has], ridx[has]) and bool((best[~has] >= hamming.BIG).all())
            and torch.equal(idx, ridx)):
        raise AssertionError(f"K1 differs from its plain version ({label})")
    return max(int((x.long() - y.long()).abs().max()) if x.numel() else 0
               for x, y in zip(got, ref))


def top2_library(pa, pb, mask):
    """One PyTorch formulation of K1 (yardstick only): +/-1 plane product,
    masked_fill, stable sort."""
    d = (hamming.N_BITS - (pa @ pb.T).float()) * 0.5
    v, i = torch.sort(d.masked_fill(~mask, float(hamming.BIG)), dim=1, stable=True)
    return i[:, 0], v[:, 0], v[:, 1]


def patch_library(img, y0, x0):
    """One PyTorch formulation of K2 (yardstick only): an unfold view of
    every 32x32 window, indexed at the corners."""
    return img.unfold(0, patch.PATCH, 1).unfold(1, patch.PATCH, 1)[y0.long(), x0.long()]


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def k1_bound(n: int, m: int, candidates: int) -> tuple[float, str]:
    """K1's bound: bytes of the mask, both descriptor sets and three (N,)
    outputs; operations: the allowed pairs as +/-1 int8 products."""
    return bound_ms(n * m + 32 * (n + m) + 12 * n, 2 * hamming.N_BITS * candidates)


def k1_times(a, b, mask) -> dict:
    """K1 on packed words and a mask, held exactly against its plain
    version and timed: kernel and library call by CUDA-graph replay, the
    plain version (which reads the allowed pairs' positions back to the
    host) eagerly with CUDA events."""
    ref = hamming.masked_top2_reference(a, b, mask)
    check_top2(hamming.masked_top2(a, b, mask), ref, f"mask {tuple(mask.shape)}")
    pa, pb = desc_k.descriptor_planes(a), desc_k.descriptor_planes(b)
    bf_a, bf_b = pa.to(torch.bfloat16), pb.to(torch.bfloat16)
    lib = top2_library(bf_a, bf_b, mask)
    has = ref[1] < hamming.BIG
    if not (torch.equal(lib[1].to(torch.int32), ref[1])
            and torch.equal(lib[2].to(torch.int32), ref[2])
            and torch.equal(lib[0][has].to(torch.int32), ref[0][has])):
        raise AssertionError("K1 yardstick differs from the plain version")
    n, m = mask.shape
    cand = int(mask.sum())
    bnd, by = k1_bound(n, m, cand)
    return dict(candidates=cand, density=cand / (n * m),
                ms=device_ms(lambda: hamming.masked_top2(a, b, mask), KERNEL_ITERS),
                plain_ms=cuda_ms(lambda: hamming.masked_top2_reference(a, b, mask),
                                 PLAIN_ITERS),
                plain_timed_by="eager calls, CUDA events",
                bound_ms=bnd, bound_by=by,
                library_ms=device_ms(lambda: top2_library(bf_a, bf_b, mask), PLAIN_ITERS))


def k2_times(atlas, y0, x0) -> dict:
    """K2 timed at its inputs; bytes: the pixels the patches cover, the
    corners, the patches out."""
    if not torch.equal(patch.gather_patches(atlas, y0, x0),
                       patch.gather_patches_reference(atlas, y0, x0)):
        raise AssertionError("K2 differs from its plain version")
    n = y0.numel()
    cover = torch.zeros(atlas.shape, dtype=torch.bool, device=atlas.device)
    r = torch.arange(patch.PATCH, device=atlas.device)
    cover[(torch.clamp(y0.long(), 0, atlas.shape[0] - 32)[:, None] + r)[:, :, None],
          (torch.clamp(x0.long(), 0, atlas.shape[1] - 32)[:, None] + r)[:, None, :]] = True
    bnd, by = bound_ms(4 * int(cover.sum()) + 8 * n + 4 * n * 1024, 0)
    return dict(ms=device_ms(lambda: patch.gather_patches(atlas, y0, x0), KERNEL_ITERS),
                plain_ms=device_ms(lambda: patch.gather_patches_reference(atlas, y0, x0),
                                   PLAIN_ITERS),
                plain_timed_by="CUDA-graph replay",
                bound_ms=bnd, bound_by=by,
                library_ms=device_ms(lambda: patch_library(atlas, y0, x0), PLAIN_ITERS))


def trajectory_ate(poses, R_gt, t_gt, stamps) -> float:
    """Sim3-aligned ATE of `Slam._full_poses` against the rendered poses."""
    idx = [int(np.argmin(np.abs(stamps - p[0]))) for p in poses]
    est = np.asarray([p[2] for p in poses], np.float64)
    gt = np.asarray([-R_gt[i].T @ t_gt[i] for i in idx], np.float64)
    return ate_rmse(est, gt, with_scale=True)


def loop_sequences(width: int = W, height: int = H, intrinsics=CAMERA) -> dict:
    """The vocabulary phase's sessions, each (images, R_cw, t_cw, stamps):
    "loop" (a), "merge" (b), "reloc" (client 1's frames) and "localize"
    (client 0's frames in localization mode), from `orbit_views`."""
    a0 = -LOOP_ARC / 2  # the opening view, as `orbit_trajectory` starts
    loop_a = LOOP_ARC * np.arange(LOOP_FRAMES) / (LOOP_FRAMES - 1) + a0
    back = a0 + MERGE_START + MERGE_STEP * np.arange(MERGE_FRAMES + LOCALIZE_FRAMES)
    plan = (("loop", loop_a, 2.0), ("merge", back[:MERGE_FRAMES], MERGE_RADIUS),
            ("reloc", a0 + np.asarray(RELOC_ANGLES), 2.0),
            ("localize", back[MERGE_FRAMES:], MERGE_RADIUS))
    out, t0, first = {}, 0.0, 0
    for name, angles, radius in plan:
        imgs, R, t = orbit_views(angles, width, height, intrinsics, radius=radius,
                                 first_seed=first)
        stamps = t0 + np.arange(len(angles)) / 20.0
        out[name] = (imgs, R, t, stamps)
        t0, first = stamps[-1] + SESSION_GAP_S, first + len(angles)
    # client 0 carries on from the merge session's last view
    out["localize"] = out["localize"][:3] + (out["merge"][3][-1] + 0.05
                                            + np.arange(LOCALIZE_FRAMES) / 20.0,)
    return out


def loop_phase_report(slam, seqs: dict, sync=lambda: None,
                      progress=lambda name, out: None) -> dict:
    """Drive the vocabulary phase's sessions through `slam` (a `Slam` of
    either package, loop closing on) and read what it did: the loop and
    merge events with the session frame they fired at, the keyframes' slots
    and uids and the matched keyframe's frame of the loop session; the loop
    session's tracked share, keyframes, points and Sim3-aligned ATE; the
    merged map's keyframes per session; client 1's tracked frames and pose
    errors after the merged map's Sim3 alignment; the keyframes that
    localization mode added; host ms per frame (`sync` before each read of
    the clock). `progress(session, out)` runs after each session."""
    where = {}   # stamp -> (session, frame)
    truth = {}   # stamp -> (R_cw, t_cw)
    for name, (_, R, t, stamps) in seqs.items():
        for i, ts in enumerate(stamps):
            where[round(float(ts), 6)] = (name, i)
            truth[round(float(ts), 6)] = (R[i], t[i])

    def frame_of(m, k):
        return where.get(round(float(m.kf_ts[k]), 6), ("?", -1))

    def session(name, client=0):
        imgs, _, _, stamps = seqs[name]
        tracked, poses, ms = [], [], []
        for i in range(len(stamps)):
            n_ev = len(slam.loop_closer.events)
            t0 = time.perf_counter()
            pose = slam.track_monocular(imgs[i], float(stamps[i]), client_id=client)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            tracked.append(pose is not None)
            poses.append(pose)
            for ev in slam.loop_closer.events[n_ev:]:
                m = slam.atlas.active
                events.append(dict(
                    kind=ev.kind, session=name, frame=i, kf=int(ev.kf),
                    kf_uid=int(m.kf_uid[ev.kf]), kf_frame=frame_of(m, ev.kf),
                    matched_kf=int(ev.matched_kf),
                    matched_uid=int(m.kf_uid[ev.matched_kf]),
                    matched_frame=frame_of(m, ev.matched_kf), scale=float(ev.scale),
                    inliers=int(ev.n_inliers)))
        return tracked, poses, ms

    events, out = [], {}
    tracked, _, ms = session("loop")
    m = slam.trackers[0].map
    init = tracked.index(True) if any(tracked) else -1
    _, R_gt, t_gt, stamps = seqs["loop"]
    full = slam._full_poses()
    out["loop"] = dict(
        init_frame=init, tracked_after_init=sum(tracked[init:]) / len(tracked[init:])
        if init >= 0 else 0.0, keyframes=int(m.n_keyframes), points=int(m.n_points),
        maps=len(slam.atlas.maps), poses=len(full),
        ate=trajectory_ate(full, R_gt, t_gt, stamps) if len(full) >= 3 else None,
        centres=[[float(v) for v in p[2]] for p in full], ms=ms)
    progress("loop", dict(out, events=events))
    slam.change_dataset()
    tracked, _, ms = session("merge")
    m = slam.atlas.active
    kf_sessions = {}
    for k in m.keyframe_ids():
        name = frame_of(m, k)[0]
        kf_sessions[name] = kf_sessions.get(name, 0) + 1
    out["merge"] = dict(tracked=sum(tracked), frames=len(tracked), ms=ms,
                        maps=len(slam.atlas.maps), active_keyframes=int(m.n_keyframes),
                        active_points=int(m.n_points), keyframes_by_session=kf_sessions)
    progress("merge", dict(out, events=events))
    slam.add_client(1)
    n_reloc = sum(e["event"] == "relocalized" for e in slam.events)
    tracked, poses, ms = session("reloc", client=1)
    m = slam.trackers[1].map
    kfs = m.keyframe_ids()
    kf_c = np.asarray([-m.kf_R[k].T @ m.kf_t[k] for k in kfs], np.float64)
    gt = [truth[round(float(m.kf_ts[k]), 6)] for k in kfs]
    kf_gt = np.asarray([-R.T @ t for R, t in gt], np.float64)
    got = [(j, p) for j, p in enumerate(poses) if p is not None]
    errs = ([], [])
    if got:
        stamps = seqs["reloc"][3]
        tr = [truth[round(float(stamps[j]), 6)] for j, _ in got]
        errs = aligned_pose_errors(
            kf_c, kf_gt, np.asarray([p[0].T for _, p in got]),
            np.asarray([-p[0].T @ p[1] for _, p in got]),
            np.asarray([R.T for R, _ in tr]), np.asarray([-R.T @ t for R, t in tr]))
    out["reloc"] = dict(tracked=tracked, ms=ms,
                        relocalized=sum(e["event"] == "relocalized"
                                        for e in slam.events) - n_reloc,
                        centre_err_m=[float(x) for x in errs[0]],
                        rot_err_deg=[float(x) for x in errs[1]],
                        map_keyframes=int(m.n_keyframes))
    progress("reloc", dict(out, events=events))
    slam.activate_localization_mode()
    maps = {id(mm): mm for mm in list(slam.atlas.maps.values()) + [slam.trackers[0].map]}
    kf_before = {key: int(mm._next_uid) for key, mm in maps.items()}
    tracked, _, ms = session("localize")
    out["localize"] = dict(tracked=tracked, ms=ms, keyframes_added=sum(
        int(mm._next_uid) - kf_before[key] for key, mm in maps.items()))
    slam.deactivate_localization_mode()
    out["events"] = events
    return out


def lifecycle_plan() -> list[tuple[int, float, str | None]]:
    """(`vi_sequence` index, clock offset in s, fault) of each frame the
    lifecycle phase sends, in order; the fault names what happens at that
    frame: "dropped" (the first frame after the dropped ones), "backward",
    "gap" or "bad_imu"."""
    plan, offset = [], 0.0
    lo, hi = LIFECYCLE_DROPPED
    for i in range(LIFECYCLE_END):
        if lo <= i < hi:
            continue
        fault = None
        if i == hi:
            fault = "dropped"
        elif i == LIFECYCLE_BACKWARD:
            offset, fault = offset + LIFECYCLE_BACK_S, "backward"
        elif i == LIFECYCLE_GAP:
            offset, fault = offset + LIFECYCLE_GAP_S, "gap"
        elif i == LIFECYCLE_BAD_IMU:
            fault = "bad_imu"
        plan.append((i, offset, fault))
    return plan


def lifecycle_report(slam, seq, batches, plan, sync=lambda: None,
                     stop_after: int | None = None) -> dict:
    """Drive `plan` (`lifecycle_plan`) through `slam` (an IMU_MONOCULAR `Slam`
    of either package) over `seq` (a `vi_sequence`) and its per-frame IMU
    `batches` and read what it did. Each frame's stamp and IMU samples take
    its clock offset; the samples of dropped frames come with the next frame
    sent; "bad_imu" sets the flag on the active map before its frame. Per
    frame sent: tracked or not, the tracker's state, the maps, the active
    map's keyframes and points, the camera centre, host ms (`sync` before
    each read of the clock); each `Slam.events` entry and each capacity
    event (`grow_*` / `drop_*` of any map) with the frame it came at; per
    map its keyframes and points; the tracked share from each map's first
    tracked frame; the metric ATE, keyframe scale and gravity tilt of the
    last map's segment (`evaluation.vi_metrics`). With `stop_after`, the
    first that many frames of the plan."""
    frames, slam_events, capacity = [], [], []
    seen = {}   # id(map) -> capacity events read
    prev = -1
    for n, (i, off, fault) in enumerate(plan[:stop_after]):
        imu = [(t + off, g, a) for j in range(prev + 1, i + 1) for t, g, a in batches[j]]
        prev = i
        if fault == "bad_imu":
            slam.atlas.active.bad_imu = True
        n_ev = len(slam.events)
        # the tracker's bindings so far: a reset or respawn rebinds it
        bound = len(getattr(slam.trackers[0], "_traj_maps", None) or [])
        stamp = float(seq.frame_ts[i]) + off
        t0 = time.perf_counter()
        pose = slam.track_monocular(seq.images[i], stamp, imu=imu)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        tracker = slam.trackers[0]
        for e in slam.events[n_ev:]:
            slam_events.append(dict(kind=e["event"], frame=n, index=i,
                                    action=e.get("action")))
        for m in list(slam.atlas.maps.values()) + [tracker.map]:
            new = m.events[seen.get(id(m), 0):]
            seen[id(m)] = len(m.events)
            capacity += [dict(frame=n, index=i, **e) for e in new]
        frames.append(dict(
            index=i, stamp=stamp, fault=fault, bound=bound, tracked=pose is not None,
            state=tracker.state.name, map_id=int(tracker.map.map_id),
            maps=len(slam.atlas.maps), keyframes=int(tracker.map.n_keyframes),
            points=int(tracker.map.n_points), ms=ms,
            centre=None if pose is None else [float(v) for v in
                                               -np.asarray(pose[0]).T @ np.asarray(pose[1])]))
    # the frames each map saw, from its first tracked one
    tracker = slam.trackers[0]
    marks = getattr(tracker, "_traj_maps", None) or []
    segments = [[f for f in frames if f["bound"] == b] for b in range(len(marks) + 1)]
    after = [f["tracked"] for seg in segments for f in seg[next(
        (j for j, g in enumerate(seg) if g["tracked"]), len(seg)):]]
    m = tracker.map
    out = dict(frames=frames, events=slam_events, capacity=capacity,
               maps={int(mid): dict(keyframes=int(mm.n_keyframes), points=int(mm.n_points),
                                    imu_initialized=bool(mm.imu_initialized),
                                    tiers=[int(mm.cfg.max_keyframes), int(mm.cfg.max_points)])
                     for mid, mm in slam.atlas.maps.items()},
               n_maps=len(slam.atlas.maps), tracked_share=sum(after) / max(len(after), 1))
    # the last map's segment: the trajectory records logged since the
    # tracker was bound to it
    full = tracker.trajectory
    tracker.trajectory = full[marks[-1][0] if marks else 0:]
    try:
        poses = slam._full_poses()
    finally:
        tracker.trajectory = full
    seg, ks = segments[-1], m.keyframe_ids()
    if len(poses) >= 3 and len(ks) >= 3:
        idx = np.asarray([f["index"] for f in seg])
        met = vi_metrics(poses, m.kf_R[ks], m.kf_t[ks], m.kf_ts[ks],
                         np.asarray([f["stamp"] for f in seg]), seq.R_cw[idx], seq.t_cw[idx])
        out["last_segment"] = dict(frames=len(seg), poses=len(poses), first_index=int(idx[0]),
                                   **{k: float(met[k]) for k in (
                                       "ate_metric", "ate_sim3", "kf_scale",
                                       "gravity_tilt_deg")})
    return out


def localize_loaded(slam, seqs: dict) -> dict:
    """Localization mode on a `Slam` (either package) loaded from the
    vocabulary phase's atlas: client 1's views (`seqs["reloc"]`) through
    client 0, a fresh lane on the largest stored map. Returns the tracked
    frames, the relocalizations, the keyframes made, and the pose errors
    after the map's Sim3 alignment (the keyframes' truth by timestamp)."""
    truth = {}
    for _, R, t, stamps in seqs.values():
        for i, ts in enumerate(stamps):
            truth[round(float(ts), 6)] = (R[i], t[i])
    slam.activate_localization_mode()
    m = slam.trackers[0].map
    maps = {id(mm): mm for mm in list(slam.atlas.maps.values()) + [m]}
    kf_before = {key: int(mm._next_uid) for key, mm in maps.items()}
    n_reloc = sum(e["event"] == "relocalized" for e in slam.events)
    imgs, R_gt, t_gt, stamps = seqs["reloc"]
    poses = [slam.track_monocular(imgs[i], float(stamps[i])) for i in range(len(stamps))]
    kfs = m.keyframe_ids()
    kf_c = np.asarray([-m.kf_R[k].T @ m.kf_t[k] for k in kfs], np.float64)
    kf_gt = np.asarray([-truth[round(float(m.kf_ts[k]), 6)][0].T
                        @ truth[round(float(m.kf_ts[k]), 6)][1] for k in kfs], np.float64)
    got = [(j, p) for j, p in enumerate(poses) if p is not None]
    errs = ([], [])
    if got:
        errs = aligned_pose_errors(
            kf_c, kf_gt, np.asarray([p[0].T for _, p in got]),
            np.asarray([-p[0].T @ p[1] for _, p in got]),
            np.asarray([R_gt[j].T for j, _ in got]),
            np.asarray([-R_gt[j].T @ t_gt[j] for j, _ in got]))
    return dict(tracked=[p is not None for p in poses], map_keyframes=int(m.n_keyframes),
                relocalized=sum(e["event"] == "relocalized" for e in slam.events) - n_reloc,
                keyframes_added=sum(int(mm._next_uid) - kf_before[key]
                                    for key, mm in maps.items()),
                centre_err_m=[float(x) for x in errs[0]],
                rot_err_deg=[float(x) for x in errs[1]])


def edge_plan(n0: int = EDGE_FRAMES) -> list[tuple[int, int, int]]:
    """(phone, `vi_sequence` index, frame id) of each packet in sending
    order: phone 0's frames 0..n0-1, and after its frame EDGE_JOIN_AFTER
    phone 1's EDGE_CLIENT1 frames (ids 0, 1, ...), alternating."""
    plan, c1 = [], list(EDGE_CLIENT1)
    for i in range(n0):
        plan.append((0, i, i))
        if i >= EDGE_JOIN_AFTER and c1:
            plan.append((1, c1.pop(0), len(EDGE_CLIENT1) - len(c1) - 1))
    return plan


def edge_phase_report(slam, server, extract, seq, batches, plan, phone_cls,
                      fuse=None, sync=lambda: None, acoustic: bool = True) -> dict:
    """Drive an edge server (either package's `EdgeServer` on 127.0.0.1,
    its `track_fn` a `Slam.track_edge`) with `phone_cls` phones playing
    `plan` over `seq` (a `vi_sequence`) and its per-frame IMU `batches`,
    one packet in flight, and read what happened. Each phone extracts with
    `extract(image, budget)` (port `FrameFeatures`) at its budget: 1000 until
    a CmdPkt sets it. A packet the server's 1-in-k rule skips gets no reply;
    this function then waits until the lane took it. Then one acoustic round:
    `broadcast_emit`, both phones report the interval of their true
    distance, `cal_acoustic`, and `fuse(server, dists, slam.device)` when
    given. Closes
    the phones and the server. `sync` runs before each read of the clock."""
    index = {(p, fid): idx for p, idx, fid in plan}
    truth = {}
    records = []
    inner = server.track_fn

    def stamp(p, idx):
        return float(seq.frame_ts[idx]) + (EDGE_CLIENT1_OFFSET_S if p == 1 else 0.0)

    def timed(cid, pkt):
        t0 = time.perf_counter()
        out = inner(cid, pkt)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        tr = slam.trackers[cid]
        m = tr.map
        records.append(dict(
            client=cid, frame_id=int(pkt.frame_id), index=index[(cid, int(pkt.frame_id))],
            ok=out is not None, state=tr.state.name, keyframes=int(m.n_keyframes),
            points=int(m.n_points), imu_initialized=bool(m.imu_initialized),
            events=len(slam.events), features=int(pkt.uv.shape[0]), ms=ms,
            centre=None if out is None else [float(v) for v in -out[0].T @ out[1]],
            pose=out))
        return out

    server.track_fn = timed
    phones, sent, rtt, extract_ms, skipped = {}, [], [], [], 0
    try:
        for p, idx, fid in plan:
            if p not in phones:
                phones[p] = phone_cls("127.0.0.1", server.slam_port,
                                      server.acoustic_port if acoustic else None, p)
                deadline = time.monotonic() + 30.0
                while len(server.lanes) <= p:
                    if time.monotonic() > deadline:
                        raise AssertionError(f"phone {p}: the server made no lane")
                    time.sleep(0.01)
            ph, lane = phones[p], server.lanes[p]
            budget = ph.feature_budget if ph.budgets else N_FEATURES_INIT
            t0 = time.perf_counter()
            uv, desc = wire_arrays(extract(seq.images[idx], budget))
            sync()
            extract_ms.append((time.perf_counter() - t0) * 1e3)
            ts = stamp(p, idx)
            truth[round(ts, 6)] = (seq.R_cw[idx], seq.t_cw[idx])
            imu = batches[idx]
            off = EDGE_CLIENT1_OFFSET_S if p == 1 else 0.0
            imu_ns = np.asarray([round((s[0] + off) * 1e9) for s in imu], np.int64)
            gyro = np.asarray([s[1] for s in imu], np.float32).reshape(-1, 3)
            acc = np.asarray([s[2] for s in imu], np.float32).reshape(-1, 3)
            # the lane's 1-in-k rule, read while nothing is in flight
            tracks = p == 0 or lane.init_flag or fid % K_TRACK == 0
            n_poses, n_recv = len(ph.poses), lane.stats.frames_received
            t_send = time.monotonic()
            ph.send_frame(fid, round(ts * 1e9), uv, desc, imu_ns, gyro, acc)
            sent.append(dict(phone=p, frame_id=fid, index=idx, budget=budget,
                             features=int(uv.shape[0]), tracked=tracks))
            if tracks:
                if not ph.wait_replies(n_poses + 1, EDGE_WAIT_S):
                    errors = [repr(e) for e in getattr(lane, "errors", [])]
                    raise AssertionError(f"phone {p} frame {fid}: no reply within "
                                         f"{EDGE_WAIT_S} s; lane errors {errors}")
                rtt.append((ph.reply_times[-1] - t_send) * 1e3)
            else:
                skipped += 1
                deadline = time.monotonic() + EDGE_WAIT_S
                while lane.stats.frames_received <= n_recv or not lane.frame_q.empty():
                    if time.monotonic() > deadline:
                        raise AssertionError(f"phone {p} frame {fid}: not received")
                    time.sleep(0.002)
        sync()
        out = dict(records=records, sent=sent, rtt_ms=rtt, extract_ms=extract_ms,
                   skipped=skipped,
                   budgets={p: list(ph.budgets) for p, ph in phones.items()},
                   replies={p: len(ph.poses) for p, ph in phones.items()},
                   received=[int(ln.stats.frames_received) for ln in server.lanes],
                   lane_errors=[repr(e) for ln in server.lanes
                                for e in getattr(ln, "errors", [])],
                   events=[e["event"] for e in slam.events])
        if acoustic and len(phones) == 2:
            out["acoustic"] = _edge_acoustic_round(server, phones, sent, seq, fuse,
                                                   getattr(slam, "device", None))
    finally:
        for ph in phones.values():
            ph.close()
        server.close()
        server.track_fn = inner
    out.update(_edge_outcomes(slam, records, truth, seq, plan))
    return out


def _edge_acoustic_round(server, phones, sent, seq, fuse, device) -> dict:
    """`broadcast_emit`; both phones report the half interval of the true
    distance between their last views; `cal_acoustic`; `fuse` on `device`
    (client 0's solve is read back when both lanes have tracked, with the
    same solve on the CPU beside it). Then `_trilateration_check` on
    `device`."""
    last = {r["phone"]: r["index"] for r in sent}
    c_true = {p: -seq.R_cw[i].T @ seq.t_cw[i] for p, i in last.items()}
    d_true = float(np.linalg.norm(c_true[0] - c_true[1]))
    base = {p: ph.emit_count for p, ph in phones.items()}
    server.broadcast_emit()
    for p, ph in phones.items():
        if not ph.wait_emit(base[p], 30.0):
            raise AssertionError(f"phone {p} got no emit")
    n = phones[0].distance_to_interval(d_true)
    phones[0].report_intervals({1: n})
    phones[1].report_intervals({0: n})
    deadline = time.monotonic() + 30.0
    lanes = server.lanes
    while any(q is None or q.empty() for q in (lanes[0].intervals.get(1),
                                               lanes[1].intervals.get(0))):
        if time.monotonic() > deadline:
            raise AssertionError("the interval reports did not arrive")
        time.sleep(0.005)
    dists = server.cal_acoustic()
    out = dict(true_m=d_true, half_interval=n, dists=[float(d) for d in dists])
    if fuse is None:
        return out
    fused = fuse(server, dists, device) if dists else {}
    if 0 in fused:
        pos, anchors, d, new_p = fused[0]
        cpu = acoustic.optimize_position_given_scale(pos, anchors, d, 1.0,
                                                     device="cpu").numpy()
        out.update(residual_m=float(abs(d[0] - np.linalg.norm(new_p - anchors[0]))),
                   fused_clients=sorted(fused),
                   cpu_err=float(np.abs(new_p - cpu).max() / max(np.abs(cpu).max(), 1.0)),
                   rewritten=bool(np.allclose(lanes[0].latest_position()[1], new_p,
                                              atol=1e-5)))
    out.update(_trilateration_check(seq, last[0], device))
    return out


def _trilateration_check(seq, idx: int, device) -> dict:
    """`optimize_position_given_scale` on a problem whose residual is not
    zero: the true centre of view `idx` from six phones 1-3 m away in
    seeded directions, ranges with seeded noise, started 0.26 m off.
    Solved on `device` and on the CPU; the gradient J^T r of the range
    cost at the solution, in f64 numpy with the closed-form Jacobian,
    shows a stationary point."""
    target = (-seq.R_cw[idx].T @ seq.t_cw[idx]).astype(np.float64)
    rng = np.random.default_rng(17)
    dirs = rng.normal(size=(6, 3))
    anchors = (target + dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
               * rng.uniform(1.0, 3.0, (6, 1))).astype(np.float32)
    d = (np.linalg.norm(anchors - target, axis=1)
         + rng.normal(0.0, EDGE_FUSE_NOISE_M, len(anchors))).astype(np.float32)
    start = (target + np.array([0.2, -0.1, 0.15])).astype(np.float32)
    got = acoustic.optimize_position_given_scale(start, anchors, d, 1.0, device=device)
    cpu = acoustic.optimize_position_given_scale(start, anchors, d, 1.0, device="cpu").numpy()
    x = got.cpu().numpy().astype(np.float64)
    diff = x - anchors.astype(np.float64)
    rng_x = np.linalg.norm(diff, axis=1)
    r = d.astype(np.float64) - rng_x
    grad = (-(diff / rng_x[:, None])).T @ r
    return dict(tri_device=str(got.device), tri_residual_rms=float(np.sqrt(np.mean(r * r))),
                tri_grad=float(np.abs(grad).max()), tri_err_m=float(np.linalg.norm(x - target)),
                tri_cpu_err=float(np.abs(x - cpu).max() / max(np.abs(cpu).max(), 1.0)))


def _edge_outcomes(slam, records, truth, seq, plan) -> dict:
    """Client 0's init and IMU-init frames, tracked share and metric ATE of
    its `_full_poses`; client 1's tracked frames, the frame it relocalized
    at (its tracked frames counted from 0) and its pose errors after the
    map's Sim3 alignment; keyframe and point counts."""
    r0 = [r for r in records if r["client"] == 0]
    r1 = [r for r in records if r["client"] == 1]
    init = next((r["frame_id"] for r in r0 if r["ok"]), -1)
    imu_init = next((r["frame_id"] for r in r0 if r["imu_initialized"]), -1)
    after = [r["ok"] for r in r0 if init >= 0 and r["frame_id"] >= init]
    full = slam._full_poses(0)
    full = [p for p in full if round(float(p[0]), 6) in truth]
    ate = None
    if len(full) >= 3:
        est = np.asarray([p[2] for p in full], np.float64)
        gt = np.asarray([-truth[round(float(p[0]), 6)][0].T @ truth[round(float(p[0]), 6)][1]
                         for p in full], np.float64)
        ate = dict(metric=ate_rmse(est, gt, with_scale=False),
                   sim3=ate_rmse(est, gt, with_scale=True), poses=len(full))
    m = slam.trackers[0].map
    kfs = [k for k in m.keyframe_ids() if round(float(m.kf_ts[k]), 6) in truth]
    got = [r for r in r1 if r["ok"]]
    errs = ([], [])
    if got and len(kfs) >= 3:
        kf_c = np.asarray([-m.kf_R[k].T @ m.kf_t[k] for k in kfs], np.float64)
        kf_gt = np.asarray([-truth[round(float(m.kf_ts[k]), 6)][0].T
                            @ truth[round(float(m.kf_ts[k]), 6)][1] for k in kfs], np.float64)
        R_t = np.asarray([seq.R_cw[r["index"]] for r in got])
        t_t = np.asarray([seq.t_cw[r["index"]] for r in got])
        errs = aligned_pose_errors(
            kf_c, kf_gt, np.asarray([np.asarray(r["pose"][0]).T for r in got]),
            np.asarray([r["centre"] for r in got]), np.swapaxes(R_t, 1, 2),
            -np.einsum("nji,nj->ni", R_t, t_t))
    reloc = next((j for j, r in enumerate(r1) if r["ok"]), -1)
    return dict(init_frame=init, imu_init_frame=imu_init,
                tracked_after_init=sum(after) / max(len(after), 1), ate=ate,
                client1=dict(tracked=[r["ok"] for r in r1],
                             frame_ids=[r["frame_id"] for r in r1], reloc_at=reloc,
                             centre_err_m=[float(x) for x in errs[0]],
                             rot_err_deg=[float(x) for x in errs[1]]),
                keyframes=int(m.n_keyframes), points=int(m.n_points),
                maps=len(slam.atlas.maps))


def vocab_config() -> SystemConfig:
    """The vocabulary phase's mono configuration at the operating point."""
    return SystemConfig(map=MapConfig(features_per_frame=N_FEATURES),
                        tracker=TrackerConfig(n_features=N_FEATURES, n_levels=N_LEVELS,
                                              scale_factor=SCALE))


def vocab_slam(seqs: dict, camera: Camera, plain: bool = False) -> dict:
    """`loop_phase_report` of a mono `Slam` with the shipped vocabulary on
    the card, global BA inline, launch counters set to 0 just before and
    read just after (per session too, and across each loop correction and
    merge). The kernel run keeps the first K1 input of each matcher policy.
    With `plain`, the kernels' plain versions run instead."""
    slam = Slam(camera, vocab_config(), vocab=load_default_vocabulary())
    slam.loop_closer.gba_background = False
    sessions, corrections = {}, []
    saved = LoopCloser._correct_loop, LoopCloser._merge_maps

    def counted(fn, kind):
        def run(self, *args, **kwargs):
            before = dict(_build.launches)
            out = fn(self, *args, **kwargs)
            corrections.append((kind, {k: v - before.get(k, 0)
                                       for k, v in _build.launches.items()
                                       if v != before.get(k, 0)}))
            return out
        return run

    def progress(name, _out):
        sessions[name] = dict(_build.launches)

    LoopCloser._correct_loop = counted(saved[0], "loop")
    LoopCloser._merge_maps = counted(saved[1], "merge")
    try:
        with contextlib.ExitStack() as stack:
            if plain:
                stack.enter_context(plain_kernels())
            else:
                k1_calls = stack.enter_context(capture(
                    hamming, "masked_top2", first_per(lambda args, kw: kw.get("policy"))))
            torch.cuda.synchronize()
            timing.reset()
            timing.enable(not plain)
            _build.launches.clear()
            report = loop_phase_report(slam, seqs, sync=torch.cuda.synchronize,
                                       progress=progress)
            launches = dict(_build.launches)
    finally:
        LoopCloser._correct_loop, LoopCloser._merge_maps = saved
        timing.enable(False)
    out = dict(report=report, launches=launches, sessions=sessions,
               corrections=corrections, stages=timing.stats(), counts=timing.counts(),
               slam=slam)
    if not plain:
        out["k1_inputs"] = {kw["policy"]: (hamming._as_words(a), hamming._as_words(b), mk)
                            for (a, b, mk), kw in k1_calls}
    return out


def bow_input(slam, img) -> tuple:
    """K1's input under policy "bow" at one real mask: client 0's
    `TrackReferenceKeyFrame` of a frame against its reference keyframe
    (captured from the call; its launches are not the main path's)."""
    tracker = slam.trackers[0]
    feats = extract_features(torch.as_tensor(img, dtype=torch.float32, device=slam.device),
                             n_features=N_FEATURES, n_levels=N_LEVELS, scale=SCALE)
    with capture(hamming, "masked_top2",
                 lambda args, kw: kw.get("policy") == "bow") as calls:
        tracker._track_reference_keyframe_bow(feats)
    (a, b, mk), _ = calls[0]
    return hamming._as_words(a), hamming._as_words(b), mk


def check_vocab(run: dict, smi: str) -> None:
    """The vocabulary phase's checks against the JAX package's run
    (LOOP_REFERENCE), with what they read printed first."""
    rep, ref = run["report"], LOOP_REFERENCE
    loop = [e for e in rep["events"] if e["kind"] == "loop" and e["session"] == "loop"]
    merge = [e for e in rep["events"] if e["kind"] == "merge" and e["session"] == "merge"]
    lp, mg, rl, lz = rep["loop"], rep["merge"], rep["reloc"], rep["localize"]
    log(f"loop session: init frame {lp['init_frame']}, tracked share "
        f"{lp['tracked_after_init']:.3f}, {lp['keyframes']} keyframes, {lp['points']} points, "
        f"Sim3-aligned ATE {lp['ate']:.5f} m (bound {ref['ate'] * LOOP_ATE_MARGIN:.5f} m = JAX "
        f"package's {ref['ate']} m x {LOOP_ATE_MARGIN}); events {json.dumps(rep['events'])} "
        f"(JAX package: loop keyframe uid {ref['loop_kf_uid']} matched uid "
        f"{ref['loop_matched_uid']}, merge at merge-session frame {ref['merge_frame']})")
    log(f"merge session: {mg['tracked']}/{mg['frames']} tracked, {mg['maps']} maps, active map "
        f"{mg['active_keyframes']} keyframes {mg['active_points']} points, keyframes by "
        f"session {mg['keyframes_by_session']}")
    log(f"client 1: tracked {rl['tracked']}, relocalized {rl['relocalized']}, centre error "
        f"{[round(x, 5) for x in rl['centre_err_m']]} m, rotation error "
        f"{[round(x, 4) for x in rl['rot_err_deg']]} deg after the map's Sim3 alignment "
        f"(bound {RELOC_TOL}; JAX package {ref['reloc_centre_err_m']} m, "
        f"{ref['reloc_rot_err_deg']} deg); localization mode: tracked {lz['tracked']}, "
        f"keyframes added {lz['keyframes_added']}")
    log_ladder_attempts("vocabulary phase", run["counts"])
    for kind, delta in run["corrections"]:
        log(f"launches during the {kind} correction: {json.dumps(delta, sort_keys=True)}")
    base = {}
    for name in ("loop", "merge", "reloc", "localize"):
        now = run["sessions"].get(name, run["launches"])
        log(f"launches in the {name} session: "
            f"{json.dumps({k: v - base.get(k, 0) for k, v in now.items() if v != base.get(k, 0)}, sort_keys=True)}")
        base = now
    frame_ms = np.asarray(lp["ms"] + mg["ms"] + rl["ms"] + lz["ms"])
    log(f"track_monocular ms/frame over the {len(frame_ms)} frames of the phase: p50 "
        f"{np.percentile(frame_ms, 50):.1f}, p90 {np.percentile(frame_ms, 90):.1f}, max "
        f"{frame_ms.max():.1f} (host wall clock, synchronized; {smi})")
    for name, st in sorted(run["stages"].items()):
        log(f"stage {name}: n {st['n']}, median {st['median_ms']:.1f} ms, p90 "
            f"{st['p90_ms']:.1f} ms, total {st['total_ms']:.1f} ms (host wall clock)")
    if lp["tracked_after_init"] < TRACKED_SHARE:
        raise AssertionError(f"tracked {lp['tracked_after_init']:.3f} of the loop session")
    if not lp["ate"] <= ref["ate"] * LOOP_ATE_MARGIN:
        raise AssertionError(f"loop session ATE {lp['ate']} m")
    if not loop:
        raise AssertionError("no loop fired in the loop session")
    ev = loop[0]
    if (abs(ev["kf_uid"] - ref["loop_kf_uid"]) > LOOP_UID_TOL
            or abs(ev["matched_uid"] - ref["loop_matched_uid"]) > LOOP_UID_TOL
            or ev["matched_frame"][0] != "loop" or ev["matched_frame"][1] >= OPENING_FRAMES):
        raise AssertionError(f"the loop {ev} is not the JAX package's")
    fixes = [d for kind, d in run["corrections"] if kind == "loop"]
    if not fixes or fixes[0].get(f"{hamming.KERNEL}[fuse]", 0) < 1:
        raise AssertionError("K1 did not run under the fuse policy in the loop correction")
    if run["sessions"]["loop"].get(f"{hamming.KERNEL}[loop]", 0) < 1:
        raise AssertionError("K1 did not run under the loop policy")
    if not merge or abs(merge[0]["frame"] - ref["merge_frame"]) > MERGE_FRAME_TOL:
        raise AssertionError(f"the merge {merge} is not at the JAX package's frame")
    if min(mg["keyframes_by_session"].get(k, 0) for k in ("loop", "merge")) < 1:
        raise AssertionError("the merged map lacks keyframes of a session")
    errs_ok = (max(rl["centre_err_m"], default=1e9) <= RELOC_TOL[0]
               and max(rl["rot_err_deg"], default=1e9) <= RELOC_TOL[1])
    if not all(rl["tracked"]) or rl["relocalized"] < 1 or not errs_ok:
        raise AssertionError("client 1 did not relocalize and track within the bound")
    if (run["sessions"]["reloc"].get(f"{hamming.KERNEL}[reloc]", 0)
            - run["sessions"]["merge"].get(f"{hamming.KERNEL}[reloc]", 0)) < 1:
        raise AssertionError("K1 did not run under the reloc policy for client 1")
    if not all(lz["tracked"]) or lz["keyframes_added"] != 0:
        raise AssertionError("localization mode lost track or made a keyframe")
    frames = len(frame_ms)
    if run["launches"].get(patch.KERNEL, 0) != frames:
        raise AssertionError(f"K2 launched {run['launches'].get(patch.KERNEL, 0)} times over "
                             f"{frames} frames of the vocabulary phase")


def check_vocab_agree(run: dict, plain: dict) -> None:
    """A plain rerun of the vocabulary phase launched nothing and agrees:
    the events (session frame, keyframe uids), the keyframe and point
    counts, the loop session's camera centres and client 1's errors."""
    if any(plain["launches"].values()):
        raise AssertionError(f"the plain-kernel vocabulary run launched kernels: "
                             f"{json.dumps(plain['launches'], sort_keys=True)}")
    a, b = run["report"], plain["report"]
    key = [(e["kind"], e["session"], e["frame"], e["kf_uid"], e["matched_uid"])
           for e in a["events"]]
    d_centre = max(float(np.abs(np.asarray(a["loop"]["centres"])
                                - np.asarray(b["loop"]["centres"])).max()),
                   float(np.abs(np.asarray(a["reloc"]["centre_err_m"])
                                - np.asarray(b["reloc"]["centre_err_m"])).max()))
    counts = [(r["loop"]["keyframes"], r["loop"]["points"], r["merge"]["active_keyframes"],
               r["merge"]["active_points"]) for r in (a, b)]
    log(f"kernel vs plain vocabulary phase on the card: events {key} vs "
        f"{[(e['kind'], e['session'], e['frame'], e['kf_uid'], e['matched_uid']) for e in b['events']]}, "
        f"(loop keyframes, points, merged keyframes, points) {counts[0]} vs {counts[1]}, max "
        f"centre diff {d_centre:.3e} m")
    if (key != [(e["kind"], e["session"], e["frame"], e["kf_uid"], e["matched_uid"])
                for e in b["events"]] or counts[0] != counts[1]
            or len(a["loop"]["centres"]) != len(b["loop"]["centres"])
            or d_centre > AGREE_CENTRE_TOL):
        raise AssertionError("kernel and plain vocabulary runs disagree")


def edge_run(seq, batches, plan, plain: bool = False) -> dict:
    """The edge phase on the card: the server's `Slam` from
    euroc_yaml(imu=True, n_features=EDGE_FEATURES) with the shipped
    vocabulary (global BA inline) behind an `EdgeServer` on 127.0.0.1, the
    phones extracting on the card, driven by `edge_phase_report`. The
    launch counters are set to 0 just before and read just after; the
    phones' launches are told apart by reading them around each
    extraction (one packet is in flight, so the server is idle then). With
    `plain` the kernels' plain versions run and there is no acoustic round."""
    camera, cfg, _ = settings_config(euroc_yaml(imu=True, n_features=EDGE_FEATURES),
                                     "imu_monocular")
    slam = Slam(camera, cfg, vocab=load_default_vocabulary())
    slam.loop_closer.gba_background = False
    server = EdgeServer(slam.track_edge, host="127.0.0.1", slam_port=0, acoustic_port=0,
                        max_clients=2)
    phones = collections.Counter()

    def extract(img, budget):
        before = _build.snapshot()
        feats = extract_features(img, n_features=budget, n_levels=N_LEVELS, scale=SCALE)
        torch.cuda.synchronize()
        phones.update({k: v - before.get(k, 0) for k, v in _build.snapshot().items()})
        return feats

    try:
        with contextlib.ExitStack() as stack:
            if plain:
                stack.enter_context(plain_kernels())
            torch.cuda.synchronize()
            timing.reset()
            timing.enable(not plain)
            _build.launches.clear()
            decodes = wire.decodes["native"]
            report = edge_phase_report(slam, server, extract, seq, batches, plan, FakePhone,
                                       fuse=fuse_acoustic, sync=torch.cuda.synchronize,
                                       acoustic=not plain)
            launches = _build.snapshot()
    finally:
        timing.enable(False)
        slam.shutdown()
    return dict(report=report, launches=launches, phones=dict(phones),
                server={k: v - phones.get(k, 0) for k, v in launches.items()},
                decodes=wire.decodes["native"] - decodes, stages=timing.stats(),
                counts=timing.counts(),
                log=[e["event"] for e in slam.events])


def budget_rule(records, client: int) -> list[int]:
    """The budget commands a lane owes its phone: 1000 when a frame fails
    while not (re)initializing, 500 when one succeeds while it is."""
    flag, cmds = False, []
    for r in records:
        if r["client"] != client:
            continue
        if not flag and not r["ok"]:
            cmds, flag = cmds + [N_FEATURES_INIT], True
        elif flag and r["ok"]:
            cmds, flag = cmds + [N_FEATURES_TRACKING], False
    return cmds


def check_edge(run: dict, plan, smi: str) -> None:
    """The edge phase's checks against the rules and the JAX package's run
    (EDGE_REFERENCE), with what they read printed first."""
    rep, ref = run["report"], EDGE_REFERENCE
    recs = rep["records"]
    c1, ac = rep["client1"], rep.get("acoustic", {})
    ate = rep["ate"] or {}
    log(f"edge: {len(plan)} packets ({rep['skipped']} left untracked by the 1-in-"
        f"{K_TRACK} rule), {run['decodes']} decoded by the C++ codec, received per lane "
        f"{rep['received']}, replies per phone {rep['replies']}, budgets {rep['budgets']}, "
        f"budgets extracted at {sorted(collections.Counter((s['phone'], s['budget']) for s in rep['sent']).items())}")
    log(f"edge client 0: init frame {rep['init_frame']} (JAX package {ref['init_frame']}), "
        f"IMU init frame {rep['imu_init_frame']} ({ref['imu_init_frame']}), tracked share "
        f"{rep['tracked_after_init']:.3f}, metric ATE {ate.get('metric', float('nan')):.5f} m "
        f"(bound {EDGE_MARGIN * ref['ate_metric']:.5f} m = JAX package's "
        f"{ref['ate_metric']} m x {EDGE_MARGIN}), Sim3 {ate.get('sim3', float('nan')):.5f} m "
        f"over {ate.get('poses')} poses; {rep['keyframes']} keyframes, {rep['points']} points, "
        f"{rep['maps']} maps; events {run['log']}")
    log(f"edge client 1: frames {c1['frame_ids']} tracked {c1['tracked']}, relocalized at "
        f"its tracked frame {c1['reloc_at']} (JAX package {ref['client1_reloc_at']}), centre "
        f"errors {[round(x, 5) for x in c1['centre_err_m']]} m (bound "
        f"{EDGE_MARGIN * ref['client1_centre_err_m']:.5f} m), rotation errors "
        f"{[round(x, 4) for x in c1['rot_err_deg']]} deg (JAX package "
        f"{ref['client1_rot_err_deg']} deg)")
    log(f"edge acoustic round: true distance {ac.get('true_m')} m, half interval "
        f"{ac.get('half_interval')}, cal_acoustic {ac.get('dists')}, residual after "
        f"optimize_position_given_scale {ac.get('residual_m')} m, against the CPU's solve "
        f"{ac.get('cpu_err')} (bound {EDGE_FUSE_CPU_TOL}), fused clients "
        f"{ac.get('fused_clients')}, client 0's entry rewritten {ac.get('rewritten')}")
    log(f"edge trilateration from 6 phones ({EDGE_FUSE_NOISE_M} m range noise) on "
        f"{ac.get('tri_device')}: residual rms {ac.get('tri_residual_rms')} m, |J^T r| "
        f"{ac.get('tri_grad')} (bound {EDGE_FUSE_GRAD}), error to the true centre "
        f"{ac.get('tri_err_m')} m, against the CPU's solve {ac.get('tri_cpu_err')} "
        f"(bound {EDGE_FUSE_CPU_TOL})")
    log(f"launches on the edge path: server {json.dumps(run['server'], sort_keys=True)}, "
        f"phones {json.dumps(run['phones'], sort_keys=True)}")
    server_ms = np.asarray([r["ms"] for r in recs])
    rtt, ext = np.asarray(rep["rtt_ms"]), np.asarray(rep["extract_ms"])
    for name, v in (("server ttrack (track_edge)", server_ms),
                    ("reply delay as the phones see it (send to pose reply)", rtt),
                    ("phone extract_features", ext)):
        log(f"edge {name} ms over {len(v)}: p50 {np.percentile(v, 50):.1f}, p90 "
            f"{np.percentile(v, 90):.1f}, max {v.max():.1f} (host wall clock, synchronized; "
            f"{smi})")
    for name, st in sorted(run["stages"].items()):
        log(f"stage {name}: n {st['n']}, median {st['median_ms']:.1f} ms, p90 "
            f"{st['p90_ms']:.1f} ms, total {st['total_ms']:.1f} ms (host wall clock)")
    if rep["lane_errors"]:
        raise AssertionError(f"edge lanes raised: {rep['lane_errors']}")
    if not run["decodes"] == sum(rep["received"]) == len(plan):
        raise AssertionError("a packet was not decoded by the C++ codec")
    for phone in (0, 1):
        n_tracked = sum(r["client"] == phone for r in recs)
        if rep["replies"].get(phone) != n_tracked:
            raise AssertionError(f"phone {phone}: {rep['replies'].get(phone)} replies for "
                                 f"{n_tracked} tracked packets")
        if rep["budgets"].get(phone, []) != budget_rule(recs, phone):
            raise AssertionError(f"phone {phone}: budgets {rep['budgets'].get(phone)} break "
                                 f"the 1000/500 rule")
    if sum(r["client"] == 0 for r in recs) != sum(p == 0 for p, _, _ in plan):
        raise AssertionError("client 0 did not track every packet")
    if (abs(rep["init_frame"] - ref["init_frame"]) > EDGE_FRAME_TOL or rep["init_frame"] < 0
            or rep["imu_init_frame"] < 0
            or abs(rep["imu_init_frame"] - ref["imu_init_frame"]) > EDGE_FRAME_TOL):
        raise AssertionError("client 0's init or IMU-init frame is not the JAX package's")
    if rep["tracked_after_init"] < EDGE_TRACKED_SHARE:
        raise AssertionError(f"client 0 tracked {rep['tracked_after_init']:.3f}")
    if not ate.get("metric", np.inf) <= EDGE_MARGIN * ref["ate_metric"]:
        raise AssertionError(f"client 0's metric ATE {ate.get('metric')} m")
    if c1["reloc_at"] < 0 or abs(c1["reloc_at"] - ref["client1_reloc_at"]) > 1:
        raise AssertionError("client 1 did not relocalize where the JAX package does")
    if not max(c1["centre_err_m"], default=np.inf) <= EDGE_MARGIN * ref["client1_centre_err_m"]:
        raise AssertionError(f"client 1's centre errors {c1['centre_err_m']} m")
    if not (abs(ac["dists"][0] - ac["true_m"]) <= EDGE_ACOUSTIC_TOL
            and ac["residual_m"] < EDGE_FUSE_RESIDUAL and ac["rewritten"]
            and ac["cpu_err"] <= EDGE_FUSE_CPU_TOL):
        raise AssertionError(f"the acoustic round failed: {ac}")
    if not (ac["tri_device"].startswith("cuda") and ac["tri_grad"] <= EDGE_FUSE_GRAD
            and ac["tri_cpu_err"] <= EDGE_FUSE_CPU_TOL
            and ac["tri_residual_rms"] > 0.1 * EDGE_FUSE_NOISE_M):
        raise AssertionError(f"the 6-phone trilateration failed: {ac}")
    for pol in EDGE_POLICIES:
        if run["server"].get(f"{hamming.KERNEL}[{pol}]", 0) < 1:
            raise AssertionError(f"K1 was not launched by the {pol} policy on the server")
    if run["server"].get(patch.KERNEL, 0) != 0 or run["phones"].get(hamming.KERNEL, 0) != 0:
        raise AssertionError("the server extracted, or a phone matched")
    if run["phones"].get(patch.KERNEL, 0) != len(plan):
        raise AssertionError(f"K2 launched {run['phones'].get(patch.KERNEL, 0)} times by the "
                             f"phones over {len(plan)} phone frames")


def check_edge_agree(run: dict, plain: dict) -> None:
    """A plain rerun of the packet stream launched nothing and agrees with
    the kernel run: states, keyframe and point counts, events, budgets and
    camera centres, packet by packet."""
    if any(plain["launches"].values()):
        raise AssertionError(f"the plain-kernel edge run launched kernels: "
                             f"{json.dumps(plain['launches'], sort_keys=True)}")
    a, b = run["report"]["records"], plain["report"]["records"]
    key = ("client", "frame_id", "ok", "state", "keyframes", "points", "events")
    ka = [tuple(r[k] for k in key) for r in a]
    kb = [tuple(r[k] for k in key) for r in b]
    d_centre = max((float(np.abs(np.asarray(x["centre"]) - np.asarray(y["centre"])).max())
                    for x, y in zip(a, b) if x["centre"] and y["centre"]), default=0.0)
    ba, bb = run["report"]["budgets"], plain["report"]["budgets"]
    log(f"kernel vs plain edge run on the card over {len(b)} tracked packets: (client, "
        f"frame, ok, state, keyframes, points, events) equal {ka == kb}, budgets {ba} vs "
        f"{bb}, events {run['log'] == plain['log']}, max camera-centre diff {d_centre:.3e} m")
    if ka != kb or ba != bb or run["log"] != plain["log"] or d_centre > AGREE_CENTRE_TOL:
        raise AssertionError("kernel and plain edge runs disagree")


def mono_slam(imgs, stamps, camera: Camera, plain: bool = False, imu=None,
              async_mapping: bool = False, snapshot_at: int | None = None) -> dict:
    """`run_slam` of `Slam.track_monocular` with the tracker's defaults at
    the operating point; with `imu` the sensor is IMU_MONOCULAR at the
    shortened ladder cadence; `async_mapping` maps on the worker thread."""
    cfg = SystemConfig(map=MapConfig(features_per_frame=N_FEATURES),
                       tracker=TrackerConfig(n_features=N_FEATURES, n_levels=N_LEVELS,
                                             scale_factor=SCALE), async_mapping=async_mapping)
    if imu is not None:
        cfg.sensor, cfg.imu_calib = Sensor.IMU_MONOCULAR, ImuCalib.create()
        cfg.mapper = LocalMapperConfig(**VI_CADENCE)
    return run_slam(camera, cfg, [(im,) for im in imgs], stamps, plain=plain, imu=imu,
                    snapshot_at=snapshot_at)


def settings_config(text: str, sensor: str):
    """(camera, SystemConfig, R1) from a YAML text through the port's
    `Settings`, on the card; R1 turns the raw left camera into the
    rectified one (identity without rectification). An inertial sensor
    runs the shortened ladder cadence of the mono-inertial phase."""
    st = Settings.from_text(text, sensor)
    cfg = st.system_config()
    if st.inertial:
        cfg.mapper = LocalMapperConfig(**VI_CADENCE)
    rect = st.rectification()
    return st.camera(), cfg, np.eye(3) if rect is None else rect.R1


def run_slam(camera: Camera, cfg, frames, stamps, plain: bool = False, imu=None,
             depth_factor: float = 1.0, snapshot_at: int | None = None) -> dict:
    """The sensor's `Slam.track_*` over the frames on the card (`frames`:
    per frame (image,), (left, right) or (image, depth)), launch counters
    set to 0 just before and read just after. The kernel run also keeps
    the first K1 input of each matcher policy (as packed words and mask)
    and the first K2 input. With `plain`, the kernels' plain versions run
    instead. With `imu` (one batch of samples a frame) the frames at which
    the IMU initialized and each ladder rung ran are recorded."""
    slam = Slam(camera, cfg)  # the card: the default device
    if cfg.sensor in (Sensor.STEREO, Sensor.IMU_STEREO):
        track = slam.track_stereo
    elif cfg.sensor in (Sensor.RGBD, Sensor.IMU_RGBD):
        def track(img, depth, ts, imu=None):
            return slam.track_rgbd(img, depth, ts, imu=imu, depth_factor=depth_factor)
    else:
        track = slam.track_monocular
    events = {}
    kf_ms = []
    process = local_mapping.LocalMapper.process_keyframe

    def timed_process(mapper, k, abort=None):
        t0 = time.perf_counter()
        process(mapper, k, abort)
        torch.cuda.synchronize()
        kf_ms.append((time.perf_counter() - t0) * 1e3)

    tracked, frame_ms = [], []
    local_mapping.LocalMapper.process_keyframe = timed_process
    try:
        with contextlib.ExitStack() as stack:
            if plain:
                stack.enter_context(plain_kernels())
            else:
                k1_calls = stack.enter_context(capture(
                    hamming, "masked_top2", first_per(lambda args, kw: kw.get("policy"))))
                k2_calls = stack.enter_context(capture(
                    patch, "gather_patches", first_per(lambda args, kw: None)))
            torch.cuda.synchronize()
            timing.reset()
            timing.enable(not plain)
            _build.launches.clear()
            for i, (args, ts) in enumerate(zip(frames, stamps)):
                t0 = time.perf_counter()
                tracked.append(track(*args, float(ts),
                                     imu=None if imu is None else imu[i]) is not None)
                torch.cuda.synchronize()
                frame_ms.append((time.perf_counter() - t0) * 1e3)
                m = slam.trackers[0].map
                if m.imu_initialized and "imu_init" not in events:
                    events["imu_init"] = (i, int(m._next_uid) - 1)
                for stage in (1, 2):
                    if m.iba_stage >= stage and f"viba{stage}" not in events:
                        events[f"viba{stage}"] = i
                if i + 1 == snapshot_at:
                    snapshot = slam_state(slam, tracked, events)
            slam.flush()  # the mapping worker's queue, with async mapping
            torch.cuda.synchronize()
            launches = _build.snapshot()
    finally:
        local_mapping.LocalMapper.process_keyframe = process
        timing.enable(False)
    worker = slam._backend.backend
    if worker is not None:
        events["async"] = dict(queue=worker.queue_len(), errors=[repr(e) for e in worker.errors])
        slam.shutdown()  # joins the worker
        events["async"]["alive"] = worker.alive
    m = slam.trackers[0].map
    out = dict(tracked=tracked, init=tracked.index(True) if any(tracked) else -1,
               keyframes=m.n_keyframes, points=m.n_points, poses=slam._full_poses(),
               launches=launches, frame_ms=frame_ms, kf_ms=kf_ms, stages=timing.stats(),
               counts=timing.counts(), events=events, imu_initialized=m.imu_initialized,
               iba_stage=m.iba_stage,
               map=m, log=[e["event"] for e in slam.events])
    if snapshot_at is not None:
        out["snapshot"] = snapshot
    if not plain:
        out["k1_inputs"] = {kw["policy"]: (hamming._as_words(a), hamming._as_words(b), mk)
                            for (a, b, mk), kw in k1_calls}
        out["k2_input"] = k2_calls[0][0]
    return out


def slam_state(slam, tracked, events) -> dict:
    """What a plain rerun over a prefix of the frames is held to: the init
    frame, the events so far, the map's stage and counts, and its keyframe
    centres, read after the prefix's last frame."""
    m = slam.trackers[0].map
    kfs = m.keyframe_ids()
    return dict(frames=len(tracked), init=tracked.index(True) if any(tracked) else -1,
                events=dict(events), iba_stage=m.iba_stage, keyframes=m.n_keyframes,
                points=m.n_points,
                kf_centres=np.einsum("kji,kj->ki", m.kf_R[kfs], -m.kf_t[kfs]))


def check_prefix_agree(run: dict, plain: dict, path: str) -> None:
    """A plain-kernel rerun over the first frames launched nothing and
    agrees with the kernel run's state after the same frames: init frame,
    events, `iba_stage`, keyframe and point counts, keyframe centres within
    AGREE_CENTRE_TOL."""
    if any(plain["launches"].values()):
        raise AssertionError(f"the plain-kernel {path} run launched kernels: "
                             f"{json.dumps(plain['launches'], sort_keys=True)}")
    a, b = run["snapshot"], plain["snapshot"]
    same_shape = a["kf_centres"].shape == b["kf_centres"].shape
    d_centre = float(np.abs(a["kf_centres"] - b["kf_centres"]).max()) if same_shape else np.inf
    log(f"kernel vs plain {path} on the card over the first {b['frames']} frames: init "
        f"frame {a['init']} vs {b['init']}, events {a['events']} vs {b['events']}, "
        f"iba_stage {a['iba_stage']} vs {b['iba_stage']}, keyframes {a['keyframes']} vs "
        f"{b['keyframes']}, points {a['points']} vs {b['points']}, max keyframe-centre diff "
        f"{d_centre:.3e} m")
    if (a["frames"] != b["frames"] or a["init"] != b["init"] or a["events"] != b["events"]
            or a["iba_stage"] != b["iba_stage"] or a["keyframes"] != b["keyframes"]
            or a["points"] != b["points"] or d_centre > AGREE_CENTRE_TOL):
        raise AssertionError(f"kernel and plain {path} runs disagree over the first "
                             f"{b['frames']} frames")


def report_times(run: dict, smi: str, entry: str = "track_monocular") -> None:
    """Print a SLAM run's host times: per frame, per keyframe, per stage."""
    frame_ms, kf_ms = np.asarray(run["frame_ms"]), np.asarray(run["kf_ms"])
    mapping = (f"p50 {np.percentile(kf_ms, 50):.1f}, max {kf_ms.max():.1f}"
               if len(kf_ms) else "none")
    log(f"{entry} ms/frame over {len(frame_ms)} frames: p50 "
        f"{np.percentile(frame_ms, 50):.1f}, p90 {np.percentile(frame_ms, 90):.1f}, "
        f"max {frame_ms.max():.1f}; local mapping ms/keyframe over {len(kf_ms)}: "
        f"{mapping} (host wall clock, synchronized; {smi})")
    for name, st in sorted(run["stages"].items()):
        log(f"stage {name}: n {st['n']}, median {st['median_ms']:.1f} ms, p90 "
            f"{st['p90_ms']:.1f} ms, total {st['total_ms']:.1f} ms (host wall clock; "
            f"each stage ends in a host read of its result)")


def log_ladder_attempts(path: str, counts: dict) -> None:
    """Print a run's retry-ladder attempts (`utils.timing` counters):
    replayed from CUDA graphs, graph pairs captured, run eagerly. On the
    card every tracking path replays every attempt and runs none eagerly."""
    replayed, captured, eager = (counts.get(f"track.pose_{k}", 0)
                                 for k in ("replay", "capture", "eager"))
    log(f"{path}: ladder attempts {replayed} replayed from {captured} captured graph "
        f"pair(s), {eager} eager")
    if replayed == 0 or eager:
        raise AssertionError(f"{path}: {replayed} ladder attempts replayed, {eager} eager")


def log_vi_solves(path: str, counts: dict, inertial: bool = True) -> None:
    """Print a run's visual-inertial pose solves (`utils.timing` counters):
    replayed from a CUDA graph, graphs captured, solved eagerly. On the card
    an inertial path replays every solve and solves none eagerly."""
    replayed, captured, eager = (counts.get(f"track.vi_pose_{k}", 0)
                                 for k in ("replay", "capture", "eager"))
    log(f"{path}: VI pose solves {replayed} replayed from {captured} captured graph(s), "
        f"{eager} eager")
    if inertial and (replayed == 0 or eager):
        raise AssertionError(f"{path}: {replayed} VI pose solves replayed, {eager} eager")


def check_policies(launches: dict, frames: int, path: str, policies=POLICIES,
                   k2_per_frame: int = 1) -> None:
    """K2 `k2_per_frame` times a frame and K1 under every matcher policy of
    a SLAM path."""
    if launches.get(patch.KERNEL, 0) != k2_per_frame * frames:
        raise AssertionError(f"K2 launched {launches.get(patch.KERNEL, 0)} times over "
                             f"{frames} frames on the {path} path, not {k2_per_frame} "
                             f"a frame")
    for pol in policies:
        if launches.get(f"{hamming.KERNEL}[{pol}]", 0) < 1:
            raise AssertionError(f"K1 was not launched by the {pol} policy on the "
                                 f"{path} path")


def check_agree(run: dict, plain: dict, path: str) -> None:
    """A plain-kernel rerun launched nothing and agrees with the kernel
    run: init frame, IMU-init keyframe, iba_stage, keyframe and point
    counts, camera centres within AGREE_CENTRE_TOL."""
    if any(plain["launches"].values()):
        raise AssertionError(f"the plain-kernel {path} run launched kernels: "
                             f"{json.dumps(plain['launches'], sort_keys=True)}")
    d_centre = max(float(np.abs(a[2] - b[2]).max())
                   for a, b in zip(run["poses"], plain["poses"]))
    log(f"kernel vs plain {path} on the card: init frame {run['init']} vs "
        f"{plain['init']}, IMU init {run['events'].get('imu_init')} vs "
        f"{plain['events'].get('imu_init')}, iba_stage {run['iba_stage']} vs "
        f"{plain['iba_stage']}, keyframes {run['keyframes']} vs {plain['keyframes']}, "
        f"points {run['points']} vs {plain['points']}, max camera-centre diff "
        f"{d_centre:.3e} m")
    if (plain["init"] != run["init"]
            or plain["events"].get("imu_init") != run["events"].get("imu_init")
            or plain["iba_stage"] != run["iba_stage"]
            or plain["keyframes"] != run["keyframes"] or plain["points"] != run["points"]
            or len(plain["poses"]) != len(run["poses"]) or d_centre > AGREE_CENTRE_TOL):
        raise AssertionError(f"kernel and plain {path} runs disagree")


def depth_phase(path: str, yaml_text: str, sensor: str, frames, stamps, R_gt, t_gt,
                reference: dict, smi: str, imu=None, depth_factor: float = 1.0,
                plain_frames: int | None = None) -> dict:
    """A stereo / RGB-D (-inertial) SLAM run on the card from settings
    parsed out of `yaml_text`, its checks against the rendered truth and
    the JAX package's `reference`, and its plain-kernel rerun."""
    camera, cfg, R1 = settings_config(yaml_text, sensor)
    stereo = cfg.sensor in (Sensor.STEREO, Sensor.IMU_STEREO)
    log(f"{path}: sensor {cfg.sensor.name}, camera "
        f"{[round(float(v), 4) for v in camera.params[:4]]}, bf {cfg.tracker.bf:.4f}, "
        f"th_depth {cfg.tracker.th_depth}, rectified {cfg.tracker.rectify is not None}")
    t0 = time.perf_counter()
    run = run_slam(camera, cfg, frames, stamps, imu=imu, depth_factor=depth_factor,
                   snapshot_at=plain_frames)
    seconds = time.perf_counter() - t0
    m = run["map"]
    ks = m.keyframe_ids()
    # the truth in the rectified camera's frame (the centres are unchanged)
    met = vi_metrics(run["poses"], m.kf_R[ks], m.kf_t[ks], m.kf_ts[ks], stamps,
                     np.einsum("ij,njk->nik", R1, R_gt), np.einsum("ij,nj->ni", R1, t_gt))
    init = run["init"]
    after = run["tracked"][init:] if init >= 0 else []
    share = sum(after) / max(len(after), 1)
    bound = reference["ate_metric"] * DEPTH_ATE_MARGIN
    launches = run["launches"]
    log(f"{path}: initialized at frame {init}; tracked {sum(after)}/{len(after)} from init "
        f"({share:.3f}); {run['keyframes']} keyframes, {run['points']} points; metric ATE "
        f"{met['ate_metric']:.5f} m (bound {bound:.5f} m = JAX package's "
        f"{reference['ate_metric']} m x {DEPTH_ATE_MARGIN}), Sim3-aligned "
        f"{met['ate_sim3']:.5f} m; {seconds:.1f} s for the run")
    if imu is not None:
        log(f"{path}: IMU initialized {run['imu_initialized']} (frame, keyframe uid) "
            f"{run['events'].get('imu_init')}; VIBA1 at frame {run['events'].get('viba1')}, "
            f"VIBA2 at frame {run['events'].get('viba2')}; iba_stage {run['iba_stage']} (JAX "
            f"package: {reference['iba_stage']}); keyframe scale {met['kf_scale']:.5f}; "
            f"gravity tilt {met['gravity_tilt_deg']:.3f} deg (JAX package "
            f"{reference['gravity_tilt_deg']} deg)")
        log_vi_solves(path, run["counts"])
    log_ladder_attempts(path, run["counts"])
    log(f"launches on the {path} path: {json.dumps(launches, sort_keys=True)}")
    report_times(run, smi, "track_stereo" if stereo else "track_rgbd")
    if not 0 <= init <= MAX_DEPTH_INIT_FRAME:
        raise AssertionError(f"the {path} map initialized at frame {init}")
    if share < TRACKED_SHARE:
        raise AssertionError(f"{path}: tracked {share:.3f} of the frames after init")
    if not met["ate_metric"] <= bound:
        raise AssertionError(f"{path}: metric ATE {met['ate_metric']} m over {bound} m")
    if imu is not None:
        if not run["imu_initialized"]:
            raise AssertionError(f"{path}: the IMU did not initialize")
        if run["iba_stage"] != reference["iba_stage"]:
            raise AssertionError(f"{path}: iba_stage {run['iba_stage']}, the JAX package "
                                 f"reaches {reference['iba_stage']}")
    check_policies(launches, len(frames), path,
                   DEPTH_POLICIES + (("stereo",) if stereo else ()),
                   k2_per_frame=2 if stereo else 1)
    n_stereo = launches.get(f"{hamming.KERNEL}[stereo]", 0)
    if stereo and n_stereo != len(frames):
        raise AssertionError(f"{path}: K1 ran {n_stereo} times under the stereo policy "
                             f"over {len(frames)} frames")
    if plain_frames is None:
        plain = run_slam(camera, cfg, frames, stamps, plain=True, imu=imu,
                         depth_factor=depth_factor)
        check_agree(run, plain, path)
    else:
        n = plain_frames
        plain = run_slam(camera, cfg, frames[:n], stamps[:n], plain=True,
                         imu=None if imu is None else imu[:n], depth_factor=depth_factor,
                         snapshot_at=n)
        check_prefix_agree(run, plain, path)
    return run


def fisheye_pair(dev):
    """K1's input at one full-size fisheye pair through
    `fisheye_stereo_match` on the card: (words_l, words_r, all-valid mask),
    after holding the match's kernel result exactly against its plain
    version."""
    kb_l = Camera.kb8(*TUMVI_CAM0, width=FISHEYE_SIZE, height=FISHEYE_SIZE, device="cpu")
    kb_r = Camera.kb8(*TUMVI_CAM1, width=FISHEYE_SIZE, height=FISHEYE_SIZE, device="cpu")
    T = stereo_extrinsics(0.101, 0.005)
    R12, t12 = T[:3, :3], T[:3, 3]
    R, t = orbit_trajectory(n_frames=SLAM_FRAMES, radius=2.0, center=(4.0, 2.0, 9.0), arc=1.0)
    scene = BoxScene.default(seed=7)
    img_l = scene.render(None, R[0], t[0], FISHEYE_SIZE, FISHEYE_SIZE, seed=0, camera=kb_l)
    img_r = scene.render(None, R12.T @ R[0], R12.T @ (t[0] - t12), FISHEYE_SIZE,
                         FISHEYE_SIZE, seed=500000, camera=kb_r)
    fl, fr = (extract_features(torch.as_tensor(im, dtype=torch.float32, device=dev),
                               n_features=FISHEYE_FEATURES, n_levels=N_LEVELS, scale=SCALE)
              for im in (img_l, img_r))
    args = (fl.uv, fl.desc, fl.valid, fr.uv, fr.desc, fr.valid, kb_l.to(dev), kb_r.to(dev),
            torch.as_tensor(R12.T, dtype=torch.float32, device=dev),
            torch.as_tensor(-R12.T @ t12, dtype=torch.float32, device=dev))
    with capture(hamming, "masked_top2") as calls:
        got = fisheye_stereo_match(*args)
    with plain_kernels():
        ref = fisheye_stereo_match(*args)
    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
        raise AssertionError("fisheye_stereo_match differs between K1 and its plain version")
    good = got[1]
    log(f"fisheye pair ({FISHEYE_SIZE}x{FISHEYE_SIZE}, {FISHEYE_FEATURES} features): "
        f"{int(fl.valid.sum())} x {int(fr.valid.sum())} valid, {int(good.sum())} "
        f"triangulated, median depth "
        f"{float(got[0][good].median()) if bool(good.any()) else 0.0:.3f} m; kernel and "
        f"plain results identical")
    (a, b, mask), kw = calls[0]
    if kw.get("policy") != "fisheye_stereo":
        raise AssertionError(f"the fisheye match ran K1 under {kw.get('policy')}")
    return hamming._as_words(a), hamming._as_words(b), mask


def atlas_round_trip(src, seqs: dict, camera: Camera) -> None:
    """Save the vocabulary phase's atlas, load it into a fresh `Slam` on the
    card (the keyframe database rebuilt), check every array and a database
    row per keyframe, then localization mode on client 1's views."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "atlas.npz")
        t0 = time.perf_counter()
        src.save_atlas(path)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        loaded = Slam(camera, vocab_config(), vocab=src.vocab, load_atlas_from=path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    loaded.loop_closer.gba_background = False
    diff = [(mid, name) for mid, m in src.atlas.maps.items()
            for name, arr in vars(m).items() if isinstance(arr, np.ndarray)
            and not np.array_equal(getattr(loaded.atlas.maps[mid], name), arr)]
    kfs = [(mid, int(k)) for mid, m in loaded.atlas.maps.items() for k in m.keyframe_ids()]
    rows = sum(loaded.db.row_for(k, mid) is not None for mid, k in kfs)
    _build.launches.clear()
    loc = localize_loaded(loaded, seqs)
    launches = _build.snapshot()
    loaded.shutdown()
    log(f"atlas: {size} bytes, {len(src.atlas.maps)} maps, {len(kfs)} keyframes; save "
        f"{save_s:.2f} s, load {load_s:.2f} s with the database rebuild ({rows} rows); "
        f"arrays differing {diff}")
    log(f"loaded atlas in localization mode: client 1's views tracked {loc['tracked']}, "
        f"relocalized {loc['relocalized']}, centre errors "
        f"{[round(x, 5) for x in loc['centre_err_m']]} m, rotation errors "
        f"{[round(x, 4) for x in loc['rot_err_deg']]} deg (bound {RELOC_TOL}), keyframes "
        f"added {loc['keyframes_added']}; launches {json.dumps(launches, sort_keys=True)}")
    if diff or rows != len(kfs):
        raise AssertionError("the loaded atlas or its database differs from the saved one")
    if not (loc["tracked"][0] and all(loc["tracked"]) and loc["relocalized"] >= 1
            and max(loc["centre_err_m"]) <= RELOC_TOL[0]
            and max(loc["rot_err_deg"]) <= RELOC_TOL[1] and loc["keyframes_added"] == 0):
        raise AssertionError("client 1's views did not relocalize and track on the loaded "
                             "atlas within the bound, or made a keyframe")
    if launches.get(f"{hamming.KERNEL}[reloc]", 0) < 1:
        raise AssertionError("K1 did not run under the reloc policy on the loaded atlas")


def check_async(arun: dict, sync_run: dict, R_gt, t_gt, stamps, smi: str) -> None:
    """The async mono run against the mono phase's bounds; its times beside
    the synchronous run's."""
    init = arun["init"]
    after = arun["tracked"][init:] if init >= 0 else []
    share = sum(after) / max(len(after), 1)
    ate = trajectory_ate(arun["poses"], R_gt, t_gt, stamps)
    ate_sync = trajectory_ate(sync_run["poses"], R_gt, t_gt, stamps)
    worker = arun["events"]["async"]
    log(f"async mapping: initialized at frame {init}; tracked {sum(after)}/{len(after)} "
        f"({share:.3f}); {arun['keyframes']} keyframes, {arun['points']} points (synchronous: "
        f"{sync_run['keyframes']}, {sync_run['points']}); ATE {ate:.5f} m (synchronous "
        f"{ate_sync:.5f} m; bound {REFERENCE_ATE * ATE_MARGIN:.5f} m); worker {worker}; "
        f"keyframes mapped {len(arun['kf_ms'])}; launches "
        f"{json.dumps(arun['launches'], sort_keys=True)}")
    log_ladder_attempts("async mapping (monocular)", arun["counts"])
    log_vi_solves("async mapping (monocular)", arun["counts"], inertial=False)
    for name, r in (("async", arun), ("synchronous", sync_run)):
        v = np.asarray(r["frame_ms"])
        log(f"track_monocular ms/frame, {name} mapping, over {len(v)} frames: p50 "
            f"{np.percentile(v, 50):.1f}, p90 {np.percentile(v, 90):.1f}, max {v.max():.1f} "
            f"(host wall clock, synchronized; {smi})")
    if worker["errors"] or worker["queue"] or worker["alive"]:
        raise AssertionError(f"the mapping worker: {worker}")
    if not 0 <= init <= MAX_INIT_FRAME or share < TRACKED_SHARE:
        raise AssertionError(f"async mapping: init frame {init}, tracked share {share:.3f}")
    if not ate <= REFERENCE_ATE * ATE_MARGIN:
        raise AssertionError(f"async mapping: ATE {ate} m")
    check_policies(arun["launches"], SLAM_FRAMES, "async mono SLAM")


def lifecycle_config() -> SystemConfig:
    """The lifecycle phase's mono-inertial configuration at the operating
    point: small map tiers and the 1 s IMU initialization span."""
    kfs, pts = LIFECYCLE_TIERS
    return SystemConfig(sensor=Sensor.IMU_MONOCULAR, imu_calib=ImuCalib.create(),
                        map=MapConfig(kfs, pts, N_FEATURES),
                        tracker=TrackerConfig(n_features=N_FEATURES, n_levels=N_LEVELS,
                                              scale_factor=SCALE),
                        mapper=LocalMapperConfig(**LIFECYCLE_MAPPER))


def lifecycle_run(seq, batches, camera: Camera, plain: bool = False,
                  stop_after: int | None = None) -> dict:
    """`lifecycle_report` of the port's `Slam` with the shipped vocabulary
    on the card, global BA inline, the launch counters set to 0 just before
    and read just after; with `plain` the kernels' plain versions run."""
    slam = Slam(camera, lifecycle_config(), vocab=load_default_vocabulary())
    slam.loop_closer.gba_background = False
    try:
        with contextlib.ExitStack() as stack:
            if plain:
                stack.enter_context(plain_kernels())
            torch.cuda.synchronize()
            _build.launches.clear()
            report = lifecycle_report(slam, seq, batches, lifecycle_plan(),
                                      sync=torch.cuda.synchronize, stop_after=stop_after)
            launches = _build.snapshot()
    finally:
        slam.shutdown()
    return dict(report=report, launches=launches)


def check_lifecycle(run: dict, plain: dict, smi: str) -> None:
    """The faulted run against the JAX package's on the same frames
    (LIFECYCLE_REFERENCE), and the plain prefix rerun against it."""
    rep, ref = run["report"], LIFECYCLE_REFERENCE
    for e in rep["capacity"]:
        log(f"lifecycle capacity event at frame {e['frame']} (sequence frame {e['index']}): "
            f"{json.dumps({k: v for k, v in e.items() if k not in ('frame', 'index')})}")
    log(f"lifecycle events (kind, frame): "
        f"{[(e['kind'], e['frame'], e['action']) for e in rep['events']]}; JAX package "
        f"{[(e['kind'], e['frame'], e['action']) for e in ref['events']]}")
    log(f"lifecycle maps {rep['n_maps']} (JAX package {ref['n_maps']}): "
        f"{json.dumps(rep['maps'], sort_keys=True)}; tracked share {rep['tracked_share']:.3f} "
        f"(JAX package {ref['tracked_share']:.3f}); last map's segment "
        f"{json.dumps(rep.get('last_segment'))} (JAX package {json.dumps(ref['last_segment'])})")
    log(f"launches on the lifecycle path: {json.dumps(run['launches'], sort_keys=True)}")
    v = np.asarray([f["ms"] for f in rep["frames"]])
    log(f"lifecycle track_monocular ms/frame over {len(v)} frames: p50 "
        f"{np.percentile(v, 50):.1f}, p90 {np.percentile(v, 90):.1f}, max {v.max():.1f} "
        f"(host wall clock, synchronized; {smi})")
    kinds = [(e["kind"], e["action"]) for e in rep["events"]]
    if kinds != [(e["kind"], e["action"]) for e in ref["events"]]:
        raise AssertionError("the lifecycle events differ from the JAX package's")
    if any(abs(a["frame"] - b["frame"]) > LIFECYCLE_FRAME_TOL
           for a, b in zip(rep["events"], ref["events"])):
        raise AssertionError(f"a lifecycle event is more than {LIFECYCLE_FRAME_TOL} frames "
                             f"from the JAX package's")
    cap = [(e["kind"], e["map_id"]) for e in rep["capacity"]]
    if not any(k.startswith("grow_") for k, _ in cap):
        raise AssertionError("no map grew a tier on the card")
    if cap != [(e["kind"], e["map_id"]) for e in ref["capacity"]] or any(
            abs(a["frame"] - b["frame"]) > LIFECYCLE_FRAME_TOL
            for a, b in zip(rep["capacity"], ref["capacity"])):
        raise AssertionError("the capacity events differ from the JAX package's")
    if rep["n_maps"] != ref["n_maps"]:
        raise AssertionError(f"{rep['n_maps']} maps, the JAX package {ref['n_maps']}")
    if rep["tracked_share"] < LIFECYCLE_SHARE:
        raise AssertionError(f"tracked share {rep['tracked_share']:.3f}")
    bound = LIFECYCLE_ATE_MARGIN * ref["last_segment"]["ate_metric"]
    if not rep.get("last_segment", {}).get("ate_metric", np.inf) <= bound:
        raise AssertionError(f"the last map's metric ATE over {bound} m")
    sent = len(rep["frames"])
    check_policies(run["launches"], sent, "lifecycle")
    # the plain prefix: up to and including the respawn
    if any(plain["launches"].values()):
        raise AssertionError(f"the plain-kernel lifecycle run launched kernels: "
                             f"{json.dumps(plain['launches'], sort_keys=True)}")
    pre = plain["report"]
    n = len(pre["frames"])
    head = rep["frames"][:n]
    d_centre = max((float(np.abs(np.subtract(a["centre"], b["centre"])).max())
                    for a, b in zip(head, pre["frames"]) if a["centre"] and b["centre"]),
                   default=0.0)
    same = ([(f["tracked"], f["maps"], f["keyframes"]) for f in head]
            == [(f["tracked"], f["maps"], f["keyframes"]) for f in pre["frames"]]
            and [(e["kind"], e["frame"]) for e in rep["events"] if e["frame"] < n]
            == [(e["kind"], e["frame"]) for e in pre["events"]])
    log(f"kernel vs plain lifecycle run on the card over its first {n} frames (the "
        f"respawn included): events {[(e['kind'], e['frame']) for e in pre['events']]}, maps "
        f"{pre['frames'][-1]['maps']} vs {head[-1]['maps']}, tracked, maps and keyframes per "
        f"frame equal {same}, max camera-centre diff {d_centre:.3e} m")
    if not same or d_centre > AGREE_CENTRE_TOL:
        raise AssertionError("kernel and plain lifecycle runs disagree")


def gba_views_of_loop() -> tuple:
    """Client 1's views after the vocabulary phase (`loop_sequences`): its
    relocalization path carried on LIFECYCLE_GBA_FRAMES steps of 0.05 rad,
    the radius widening 5 cm a step, so the views are new ones.
    (images, R_cw, t_cw, stamps)."""
    a0 = -LOOP_ARC / 2
    # noise seeds and stamps after those of `loop_sequences`' sessions
    first = LOOP_FRAMES + MERGE_FRAMES + len(RELOC_ANGLES) + LOCALIZE_FRAMES
    last = 2 * SESSION_GAP_S + (LOOP_FRAMES + MERGE_FRAMES + len(RELOC_ANGLES) - 3) / 20.0
    views = [orbit_views([a0 + RELOC_ANGLES[-1] + 0.05 * (j + 1)], W, H, CAMERA,
                         radius=2.0 + 0.05 * (j + 1), first_seed=first + j)
             for j in range(LIFECYCLE_GBA_FRAMES)]
    imgs, R, t = (np.concatenate(x) for x in zip(*views))
    return imgs, R, t, last + 0.05 * (1 + np.arange(LIFECYCLE_GBA_FRAMES))


def background_gba(slam, views) -> dict:
    """A global BA on its thread over client 1's map (the vocabulary phase's
    merged map), while client 1 tracks `views`; then `join()`. The solve's
    snapshot is copied under the same lock hold, and the map just before
    and after the write-back is kept, so the catch-up of the keyframes made
    meanwhile and the inline solve on the same snapshot can be checked. The
    solve's first block waits until client 1 has made a keyframe (as
    tests/test_torch_loop.py's catch-up test holds its solve), so a
    keyframe is always made during the solve. Timing decides the rest, so
    this has no plain rerun."""
    m = slam.trackers[1].map
    fixed = int(m.keyframe_ids()[0])
    gba = GlobalBA(slam.camera, iters_per_block=5, n_blocks=4)
    snap, wb, errors = {}, {}, []
    take, write = gba._snapshot, gba._write_back
    made = threading.Event()
    solve = global_ba.bundle_adjust

    def held(*args, **kwargs):  # the first block waits for a keyframe
        if "open" not in snap:
            made.wait(60.0)
            snap["open"] = time.perf_counter()
        return solve(*args, **kwargs)

    def snapshot(mm):
        with mm.lock:
            snap["copy"] = convert.map_state(mm, device=slam.device)
            snap["t"] = time.perf_counter()
            snap["snap"] = take(mm)
        return snap["snap"]

    def poses(mm):
        return {int(mm.kf_uid[k]): (mm.kf_R[k].copy(), mm.kf_t[k].copy(),
                                    int(mm.kf_uid[mm.kf_prev[k]]) if mm.kf_prev[k] >= 0 else -1)
                for k in mm.keyframe_ids()}

    def write_back(mm, sn, R_new, t_new, pos_new):
        with mm.lock:
            wb["before"] = poses(mm)
            wb["solve"] = (R_new.copy(), t_new.copy())
            write(mm, sn, R_new, t_new, pos_new)
            wb["after"] = poses(mm)
            wb["t"] = time.perf_counter()

    gba._snapshot, gba._write_back = snapshot, write_back
    hook = threading.excepthook
    threading.excepthook = lambda a: errors.append(repr(a.exc_value))
    global_ba.bundle_adjust = held
    imgs, _, _, stamps = views
    frames = []
    uid0 = int(m._next_uid)
    try:
        _build.launches.clear()
        t0 = time.perf_counter()
        gba.request(m, fixed, background=True)
        for i in range(len(stamps)):
            t1 = time.perf_counter()
            pose = slam.track_monocular(imgs[i], float(stamps[i]), client_id=1)
            torch.cuda.synchronize()
            frames.append(dict(start=t1 - t0, ms=(time.perf_counter() - t1) * 1e3,
                               tracked=pose is not None, made=int(m._next_uid) - uid0,
                               solving=gba.running))
            if int(m._next_uid) > uid0:
                made.set()
        made.set()
        gba.join()
        launches = _build.snapshot()
    finally:
        global_ba.bundle_adjust = solve
        threading.excepthook = hook
    if "t" not in wb:
        raise AssertionError(f"the background global BA wrote nothing back: finished "
                             f"{gba.n_finished}, aborted {gba.n_aborted}, errors {errors}")
    # the inline solve on the same snapshot
    ref = GlobalBA(slam.camera, iters_per_block=5, n_blocks=4)
    ref.request(snap["copy"], fixed, background=False)
    kfs = snap["snap"]["kfs"]
    R_bg, t_bg = wb["solve"]
    d_R = float(np.abs(R_bg - snap["copy"].kf_R[kfs]).max())
    d_t = float(np.abs(t_bg - snap["copy"].kf_t[kfs]).max())
    # keyframes made during the solve keep their pose relative to the
    # parent they were caught up through
    in_snap = set(int(u) for u in snap["snap"]["kf_uid"])
    caught, worst = [], 0.0
    for uid, (R1, t1, puid) in wb["after"].items():
        if uid in in_snap or puid not in wb["after"]:
            continue
        (R0, t0_, _), (Rp0, tp0, _), (Rp1, tp1, _) = (
            wb["before"][uid], wb["before"][puid], wb["after"][puid])
        R_rel0, R_rel1 = R0 @ Rp0.T, R1 @ Rp1.T
        worst = max(worst, float(np.abs(R_rel1 - R_rel0).max()),
                    float(np.abs((t1 - R_rel1 @ tp1) - (t0_ - R_rel0 @ tp0)).max()))
        caught.append(uid)
    return dict(solve_s=wb["t"] - snap["open"], held_s=snap["open"] - snap["t"],
                finished=gba.n_finished, aborted=gba.n_aborted, errors=errors,
                snapshot_kfs=len(kfs), d_R=d_R, d_t=d_t, caught_up=caught, catch_up_err=worst,
                frames=frames, launches=launches, made=int(m._next_uid) - uid0)


def check_background_gba(run: dict, smi: str) -> None:
    """The background solve finished without error, caught the keyframes
    made meanwhile up, and agrees with the inline solve; client 1 tracked
    every frame."""
    fr = run["frames"]
    during = [f["ms"] for f in fr if f["solving"]]
    after = [f["ms"] for f in fr if not f["solving"]]
    log(f"background global BA over {run['snapshot_kfs']} keyframes: solve {run['solve_s']:.3f} "
        f"s of wall time after its first block waited {run['held_s']:.3f} s for a keyframe; "
        f"finished {run['finished']}, aborted {run['aborted']}, thread errors "
        f"{run['errors']}; against the inline solve on the same snapshot: max |dR| "
        f"{run['d_R']:.3e}, max |dt| {run['d_t']:.3e} (bounds {LIFECYCLE_GBA_TOL}); "
        f"{run['made']} keyframes made over {len(fr)} frames, caught up through their "
        f"parent {run['caught_up']} (max error {run['catch_up_err']:.3e}); tracked "
        f"{sum(f['tracked'] for f in fr)}/{len(fr)}; launches "
        f"{json.dumps(run['launches'], sort_keys=True)}")
    log(f"client 1's track_monocular ms/frame while the solve ran (or waited): "
        f"{[round(x, 1) for x in during]}; "
        f"after it: p50 {np.percentile(after, 50) if after else float('nan'):.1f} over "
        f"{len(after)} (host wall clock, synchronized; {smi})")
    if run["errors"] or run["finished"] != 1 or run["aborted"]:
        raise AssertionError(f"the background global BA failed: {run}")
    if not (run["d_R"] <= LIFECYCLE_GBA_TOL[0] and run["d_t"] <= LIFECYCLE_GBA_TOL[1]):
        raise AssertionError("the background global BA differs from the inline solve")
    if not run["caught_up"] or run["catch_up_err"] > LIFECYCLE_CATCH_UP_TOL:
        raise AssertionError("no keyframe made during the solve was caught up, or one "
                             "moved against its parent")
    if sum(f["tracked"] for f in fr) < len(fr) or len(fr) < 10:
        raise AssertionError("client 1 did not track every frame during the global BA")


def paced_edge_run(seq, batches) -> dict:
    """The edge phase's server and phones with each phone on its own thread,
    a packet every LIFECYCLE_PACE_S whatever the replies: phone 0 frames
    0..EDGE_FRAMES-1, phone 1 the revisit (EDGE_CLIENT1) from
    LIFECYCLE_JOIN_S on, once client 0's map holds LIFECYCLE_RELOC_KFS
    keyframes (a new client on a younger map would initialize a map of its
    own in the shared one). Each frame is extracted on the card ahead, at
    both budgets, and a phone sends the one its last CmdPkt asks for. Then
    one acoustic round. Timing-dependent: no plain rerun."""
    camera, cfg, _ = settings_config(euroc_yaml(imu=True, n_features=EDGE_FEATURES),
                                     "imu_monocular")
    slam = Slam(camera, cfg, vocab=load_default_vocabulary())
    slam.loop_closer.gba_background = False
    items = {0: [(i, i) for i in range(EDGE_FRAMES)],
             1: [(idx, j) for j, idx in enumerate(EDGE_CLIENT1)]}
    _build.launches.clear()
    ahead = {}
    for p, its in items.items():
        for idx, fid in its:
            ahead[p, fid] = {b: wire_arrays(extract_features(
                seq.images[idx], n_features=b, n_levels=N_LEVELS, scale=SCALE))
                for b in (N_FEATURES_INIT, N_FEATURES_TRACKING)}
    torch.cuda.synchronize()
    phone_launches = _build.snapshot()
    _build.launches.clear()
    server = EdgeServer(slam.track_edge, host="127.0.0.1", slam_port=0, acoustic_port=0,
                        max_clients=2)
    records, lock, lane = [], threading.Lock(), threading.local()
    inner, compute = server.track_fn, slam.track_features

    def timed_compute(*args, **kwargs):  # inside track_edge's lock
        n_reloc = sum(e["event"] == "relocalized" for e in slam.events)
        t0 = time.perf_counter()
        out = compute(*args, **kwargs)
        torch.cuda.synchronize()
        lane.ms = (time.perf_counter() - t0) * 1e3
        lane.reloc = sum(e["event"] == "relocalized" for e in slam.events) > n_reloc
        return out

    def timed(cid, pkt):
        t0 = time.perf_counter()
        out = inner(cid, pkt)
        tr = slam.trackers[cid]
        with lock:
            records.append(dict(client=cid, frame_id=int(pkt.frame_id), ok=out is not None,
                                state=tr.state.name, ms=lane.ms, relocalized=lane.reloc,
                                wait_ms=(time.perf_counter() - t0) * 1e3 - lane.ms))
        return out

    slam.track_features, server.track_fn = timed_compute, timed
    phones, sends, errors = {}, {0: [], 1: []}, []
    gate = {}
    try:
        for p in (0, 1):
            phones[p] = FakePhone("127.0.0.1", server.slam_port, server.acoustic_port, p)
            deadline = time.monotonic() + 30.0
            while len(server.lanes) <= p:
                if time.monotonic() > deadline:
                    raise AssertionError(f"phone {p}: the server made no lane")
                time.sleep(0.01)

        def stream(p, t_start):
            try:
                ph = phones[p]
                if p == 1:  # LIFECYCLE_JOIN_S in, and a map client 1 can relocalize in
                    while time.monotonic() < t_start or \
                            slam.trackers[0].map.n_keyframes < LIFECYCLE_RELOC_KFS:
                        if time.monotonic() > t_start + EDGE_WAIT_S:
                            raise AssertionError("client 0's map never reached "
                                                 f"{LIFECYCLE_RELOC_KFS} keyframes")
                        time.sleep(0.005)
                    gate["phone1_s"] = time.monotonic() - t0
                    t_start = time.monotonic()
                for k, (idx, fid) in enumerate(items[p]):
                    while time.monotonic() < t_start + k * LIFECYCLE_PACE_S:
                        time.sleep(0.001)
                    budget = ph.feature_budget if ph.budgets else N_FEATURES_INIT
                    uv, desc = ahead[p, fid][budget]
                    off = EDGE_CLIENT1_OFFSET_S if p == 1 else 0.0
                    imu = batches[idx]
                    ts_ns = round((float(seq.frame_ts[idx]) + off) * 1e9)
                    sends[p].append(dict(frame_id=fid, index=idx, t=time.monotonic(),
                                         budget=budget))
                    ph.send_frame(fid, ts_ns, uv, desc,
                                  np.asarray([round((s[0] + off) * 1e9) for s in imu], np.int64),
                                  np.asarray([s[1] for s in imu], np.float32).reshape(-1, 3),
                                  np.asarray([s[2] for s in imu], np.float32).reshape(-1, 3))
            except Exception as e:  # noqa: BLE001  (raised by the caller)
                errors.append(repr(e))

        t0 = time.monotonic()
        threads = [threading.Thread(target=stream, args=(p, t0 + (LIFECYCLE_JOIN_S if p else 0)))
                   for p in (0, 1)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(EDGE_WAIT_S)
        # every packet tracked, skipped or dropped, and every tracked one answered
        deadline = time.monotonic() + EDGE_WAIT_S
        while True:
            st = [ln.stats for ln in server.lanes]
            done = all(s.frames_received == len(sends[p]) and s.frames_received
                       == s.frames_tracked + s.frames_skipped + s.frames_dropped
                       and len(phones[p].poses) == s.frames_tracked
                       for p, s in enumerate(st))
            if done or any(ln.errors for ln in server.lanes):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"the lanes did not drain: {st}")
            time.sleep(0.01)
        wall_s = time.monotonic() - t0
        lane_errors = [repr(e) for ln in server.lanes for e in ln.errors]
        stats = [dict(vars(ln.stats)) for ln in server.lanes]
        replies = {p: list(ph.reply_times) for p, ph in phones.items()}
        acoustic_out = _edge_acoustic_round(
            server, phones, [dict(phone=p, index=s["index"]) for p in (0, 1) for s in sends[p]],
            seq, fuse_acoustic, slam.device)
        torch.cuda.synchronize()
        launches = _build.snapshot()
    finally:
        for ph in phones.values():
            ph.close()
        server.close()
        server.track_fn, slam.track_features = inner, compute
        slam.shutdown()
    return dict(records=records, sends=sends, replies=replies, stats=stats, errors=errors,
                lane_errors=lane_errors, acoustic=acoustic_out, launches=launches,
                phones=phone_launches, wall_s=wall_s, phone1_s=gate.get("phone1_s"),
                events=[e["event"] for e in slam.events])


def check_paced_edge(run: dict, smi: str) -> None:
    """Per lane: sent, dropped, skipped, answered; reply delays; order;
    client 0 initialized, client 1 relocalized and then tracked."""
    recs = run["records"]
    ok = True
    for p in (0, 1):
        mine = [r for r in recs if r["client"] == p]
        st, sends, reps = run["stats"][p], run["sends"][p], run["replies"][p]
        sent_at = {s["frame_id"]: s["t"] for s in sends}
        delays = np.asarray([(t - sent_at[r["frame_id"]]) * 1e3 for r, t in zip(mine, reps)])
        ms = np.asarray([r["ms"] for r in mine])
        gaps = np.diff([s["t"] for s in sends]) * 1e3
        log(f"paced lane {p}: sent {len(sends)} (interval p50 "
            f"{np.percentile(gaps, 50) if len(gaps) else 0:.1f} ms, max "
            f"{gaps.max() if len(gaps) else 0:.1f}), received {st['frames_received']}, dropped by "
            f"the 64-deep queue {st['frames_dropped']}, skipped by the 1-in-{K_TRACK} rule "
            f"{st['frames_skipped']}, tracked {st['frames_tracked']}, answered {len(reps)}; reply "
            f"delay ms p50 {np.percentile(delays, 50):.1f}, p90 {np.percentile(delays, 90):.1f}, "
            f"max {delays.max():.1f}; track_edge ms p50 {np.percentile(ms, 50):.1f}, p90 "
            f"{np.percentile(ms, 90):.1f}; waiting for the other lane ms p50 "
            f"{np.percentile([r['wait_ms'] for r in mine], 50):.1f} (host wall clock, "
            f"synchronized; {smi})")
        log(f"paced lane {p} tracked frames: "
            f"{[(r['frame_id'], r['ok']) for r in mine]}")
        ids = [r["frame_id"] for r in mine]
        ok &= ids == sorted(ids) and len(set(ids)) == len(ids) and len(reps) == len(mine)
    ac = run["acoustic"]
    log(f"paced edge: {run['wall_s']:.1f} s from the first packet to the last reply; phone 1 "
        f"started {run['phone1_s']:.2f} s in; events {run['events']}; phone errors "
        f"{run['errors']}, lane errors {run['lane_errors']}; acoustic round: cal_acoustic "
        f"{ac.get('dists')} for a true {ac.get('true_m')} m, residual {ac.get('residual_m')} m; "
        f"launches: phones (ahead, both budgets) {json.dumps(run['phones'], sort_keys=True)}, "
        f"server {json.dumps(run['launches'], sort_keys=True)}")
    if run["errors"] or run["lane_errors"]:
        raise AssertionError("a paced phone or lane raised")
    if not ok:
        raise AssertionError("a paced lane's replies are out of frame order or missing")
    r0 = [r for r in recs if r["client"] == 0]
    r1 = [r for r in recs if r["client"] == 1]
    if not any(r["ok"] for r in r0):
        raise AssertionError("client 0 did not initialize")
    j = next((k for k, r in enumerate(r1) if r["ok"]), -1)
    if j < 0 or not r1[j]["relocalized"] or not r1[j + 1:] \
            or not all(r["ok"] for r in r1[j + 1:]):
        raise AssertionError("client 1 did not relocalize and then track")
    if not (abs(ac["dists"][0] - ac["true_m"]) <= EDGE_ACOUSTIC_TOL
            and ac["residual_m"] < EDGE_FUSE_RESIDUAL and ac["rewritten"]):
        raise AssertionError(f"the acoustic round failed: {ac}")
    for pol in ("tracker", "init", "triangulation", "fuse", "reloc"):
        if run["launches"].get(f"{hamming.KERNEL}[{pol}]", 0) < 1:
            raise AssertionError(f"K1 was not launched by the {pol} policy on the server")
    n_frames = sum(len(s) for s in run["sends"].values())
    if run["launches"].get(patch.KERNEL, 0) != 0 or \
            run["phones"].get(patch.KERNEL, 0) != 2 * n_frames:
        raise AssertionError("K2 ran on the server, or not twice a phone frame ahead")


def free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def blocks_round_trip(m, device) -> None:
    """A map through map_to_blocks -> serialize_block -> deserialize_block
    -> blocks_to_map: every valid row back equal, uids and flags too; then
    points added to the received map take uids no point holds."""
    t0 = time.perf_counter()
    wires = [map_blocks.serialize_block(b) for b in map_blocks.map_to_blocks(m)]
    back = map_blocks.blocks_to_map([map_blocks.deserialize_block(w) for w in wires], m.cfg,
                                    map_id=m.map_id, device=device)
    seconds = time.perf_counter() - t0
    kv, pv = m.kf_valid, m.mp_valid
    if not (np.array_equal(back.kf_valid, kv) and np.array_equal(back.mp_valid, pv)):
        raise AssertionError("map blocks: the valid rows differ")
    for f in map_blocks._KF_FIELDS:
        if not np.array_equal(getattr(back, f)[kv], getattr(m, f)[kv]):
            raise AssertionError(f"map blocks: keyframe field {f} differs")
    for f in map_blocks._MP_FIELDS + map_blocks._MP_EXTRA:
        if not np.array_equal(getattr(back, f)[pv], getattr(m, f)[pv]):
            raise AssertionError(f"map blocks: point field {f} differs")
    if (back.imu_initialized, back.iba_stage, back._next_uid) != (
            m.imu_initialized, m.iba_stage, m._next_uid):
        raise AssertionError("map blocks: the map's flags or keyframe-uid counter differ")
    g = np.random.default_rng(SEED + 5)
    ids = back.add_points(pos=g.uniform(-1, 1, (16, 3)).astype(np.float32),
                          desc=g.integers(0, 2 ** 32, (16, 8), dtype=np.uint32), first_kf=-1)
    uids = back.mp_uid[back.mp_valid]
    if (ids < 0).any() or len(np.unique(uids)) != len(uids):
        raise AssertionError("map blocks: points added after the transfer reuse a uid")
    log(f"map blocks: {m.n_keyframes} keyframes, {m.n_points} points in {len(wires)} blocks, "
        f"{sum(map(len, wires))} bytes, serialized and reassembled in {seconds:.2f} s; every "
        f"valid row equal; 16 points added, {len(uids)} uids all distinct")


def sharded_ba_run(prob, camera, backend: str, device) -> dict:
    """`make_sharded_ba` at world size 1 over `backend` on `device`: a
    warm-up call, then one timed call (host wall clock, synchronized)."""
    multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0, backend=backend)
    try:
        run = sharded_ba.make_sharded_ba(dist_mesh.make_mesh(device), camera,
                                         n_iters=SHARDED_ITERS)
        routed = sharded_ba.route_observations(
            prob._replace(**{k: v.to(device) for k, v in prob._asdict().items()
                             if v is not None}), 1)
        run(routed)
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, costs = run(routed)
        if device.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / SHARDED_ITERS
    finally:
        multihost.shutdown()
    return dict(R=out.R.cpu(), t=out.t.cpu(), costs=costs.cpu(), ms=ms)


def sharded_ba_check(m, camera: Camera, smi: str, backend: str = "nccl",
                     device=torch.device("cuda")) -> None:
    """The BA problem of map `m` with every keyframe and point: the sharded
    BA at world size 1 over `backend` on `device`, against the same call
    over gloo on the CPU and against `bundle_adjust` on `device`."""
    prob = convert.ba_problem(multihost_app.merged_problem(m)[0], device="cpu")
    M, P, O = len(prob.R), len(prob.points), len(prob.kf_idx)
    card = sharded_ba_run(prob, camera.to(device), backend, device)
    cpu = sharded_ba_run(prob, camera.to("cpu"), "gloo", torch.device("cpu"))
    t0 = time.perf_counter()
    ref, ref_costs, _ = bundle_adjust(prob._replace(**{
        k: v.to(device) for k, v in prob._asdict().items() if v is not None}),
        camera.to(device), n_iters=SHARDED_ITERS)
    if device.type == "cuda":
        torch.cuda.synchronize()
    ba_ms = (time.perf_counter() - t0) * 1e3 / SHARDED_ITERS
    d_cpu = max(float((card["R"] - cpu["R"]).abs().max()),
                float((card["t"] - cpu["t"]).abs().max()))
    d_R = float((card["R"] - ref.R.cpu()).abs().max())
    d_t = float((card["t"] - ref.t.cpu()).abs().max())
    costs = card["costs"]
    log(f"sharded BA at world size 1 ({backend}, {device}) on the mono map: M {M} keyframes, "
        f"P {P} points, {O} observations; cost {float(costs[0]):.3f} -> "
        f"{float(costs[-1]):.3f} over {SHARDED_ITERS} iterations; {card['ms']:.2f} "
        f"ms/iteration (host wall clock of one synchronized call over {SHARDED_ITERS}; "
        f"gloo on the CPU {cpu['ms']:.2f}; bundle_adjust on {device} {ba_ms:.2f}; {smi}); "
        f"against gloo on the CPU max |dR|,|dt| {d_cpu:.3e} (bound {SHARDED_CPU_TOL}); "
        f"against bundle_adjust |dR| {d_R:.3e}, |dt| {d_t:.3e} m (bounds "
        f"{SHARDED_BA_TOL[0]}, {SHARDED_BA_TOL[1]}); bundle_adjust cost "
        f"{float(ref_costs[0]):.3f} -> {float(ref_costs[-1]):.3f}")
    if not float(costs[-1]) <= float(costs[0]):
        raise AssertionError(f"sharded BA: the cost rose, {costs.tolist()}")
    if d_cpu > SHARDED_CPU_TOL:
        raise AssertionError(f"sharded BA: {device} and the CPU differ by {d_cpu}")
    if d_R > SHARDED_BA_TOL[0] or d_t > SHARDED_BA_TOL[1]:
        raise AssertionError(f"sharded BA against bundle_adjust: dR {d_R}, dt {d_t}")


def multihost_run(device: str = "cuda:0") -> dict:
    """The two-process app on one card over gloo: rank 0 in this process
    (its stdout captured, launch counters set to 0 just before and read
    just after, the first K1 input of each matcher policy kept), rank 1 a
    process of its own with a deadline, its counts read from its output."""
    common = ["--coordinator", f"127.0.0.1:{free_port()}", "--map-port", str(free_port()),
              *MULTIHOST_ARGS, "--device", device, "--backend", "gloo"]
    out1 = tempfile.TemporaryFile("w+")
    rank1 = subprocess.Popen([sys.executable, "-m", "orbslam3_tpu_torch.apps.multihost",
                              "--process-id", "1", *common], stdout=out1,
                             stderr=subprocess.STDOUT, text=True,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
    buf = io.StringIO()
    try:
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            k1_calls = stack.enter_context(capture(
                hamming, "masked_top2", first_per(lambda args, kw: kw.get("policy"))))
            stack.enter_context(contextlib.redirect_stdout(buf))
            _build.launches.clear()
            rc0 = multihost_app.main(["--process-id", "0", *common])
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            launches0 = _build.snapshot()
        wall0 = time.perf_counter() - t0
        rc1 = rank1.wait(timeout=MULTIHOST_WAIT_S)
        wall = time.perf_counter() - t0
    finally:
        if rank1.poll() is None:
            rank1.kill()
            rank1.wait()
        out1.seek(0)
        text1 = out1.read()
        out1.close()
    text0 = buf.getvalue()
    for line in text0.splitlines():
        log(f"rank 0: {line}")
    for line in text1.splitlines():
        if "socket.cpp" not in line:  # c10d's note that 127.0.0.1 has no hostname
            log(f"rank 1: {line}")
    got = [ln.split("launches: ", 1)[1] for ln in text1.splitlines() if "] launches: " in ln]
    return dict(rc=(rc0, rc1), out=(text0, text1), wall0=wall0, wall=wall,
                launches=(launches0, json.loads(got[0]) if got else None),
                k1_inputs={kw["policy"]: (hamming._as_words(a), hamming._as_words(b), mk)
                           for (a, b, mk), kw in k1_calls})


def check_multihost(run: dict, smi: str, policies=MULTIHOST_POLICIES) -> None:
    """Both ranks joined one group of 2, rank 0 welded and reported its
    merged-map ATE within the bound, both printed their markers, K1 ran
    under every policy in both ranks and is exact on rank 0's inputs."""
    text0, text1 = run["out"]
    ok = [ln for ln in text0.splitlines() if ln.startswith("MULTIHOST OK welded_kfs=")]
    ate = float(ok[0].split("ate_mm=")[1]) if ok else float("nan")
    welded = int(ok[0].split("welded_kfs=")[1].split()[0]) if ok else -1
    bound = MULTIHOST_REFERENCE["ate_mm"] * MULTIHOST_ATE_MARGIN
    log(f"two-process app on one card: exit codes {run['rc']}; rank 0 {run['wall0']:.1f} s, "
        f"both {run['wall']:.1f} s (host wall clock, process start included; {smi}); "
        f"{welded} keyframes after the weld (JAX package {MULTIHOST_REFERENCE['welded_kfs']}); "
        f"merged-map ATE {ate:.3f} mm (bound {bound:.3f} mm = JAX package's "
        f"{MULTIHOST_REFERENCE['ate_mm']} mm x {MULTIHOST_ATE_MARGIN}); launches rank 0 "
        f"{json.dumps(run['launches'][0], sort_keys=True)}, rank 1 "
        f"{json.dumps(run['launches'][1], sort_keys=True)}")
    if run["rc"] != (0, 0):
        raise AssertionError(f"the app's ranks exited with {run['rc']}")
    if not ("[0] joined: 2 ranks" in text0 and "[1] joined: 2 ranks" in text1):
        raise AssertionError("a rank did not print 'joined: 2'")
    if "[0] welded" not in text0 or not ok or "MULTIHOST OK (worker)" not in text1:
        raise AssertionError("the app did not weld, or a rank printed no MULTIHOST OK")
    if not ate <= bound:
        raise AssertionError(f"merged-map ATE {ate} mm over {bound} mm")
    for rank, launches in enumerate(run["launches"]):
        for pol in policies:
            if (launches or {}).get(f"{hamming.KERNEL}[{pol}]", 0) < 1:
                raise AssertionError(f"K1 was not launched by the {pol} policy in rank {rank}")
    for pol, (a, b, mask) in sorted(run["k1_inputs"].items()):
        check_top2(hamming.masked_top2(a, b, mask),
                   hamming.masked_top2_reference(a, b, mask), f"app {pol}")
        log(f"K1 exact on the app's {pol} mask {tuple(mask.shape)}: "
            f"{int(mask.sum())} candidates")


def timed_call(fn, *args, **kwargs):
    """(fn(*args, **kwargs), seconds), for a render in a worker process."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, time.perf_counter() - t0


def start_renders(runner_root: str):
    """Every phase's input rendered ahead, in RENDER_WORKERS spawned
    processes, in the order the phases use them, so the card's phases do
    not wait on the host's numpy renders one after another. Returns (the
    pool, {name: future of (inputs, seconds)})."""
    (f0, d0), (f1, d1) = EUROC_CAM0, EUROC_CAM1
    th, tw = TUM1_SIZE
    jobs = dict(
        mono=(orbit_sequence, (SLAM_FRAMES, W, H, CAMERA), {}),
        vi=(vi_sequence, (VI_FRAMES, W, H, CAMERA), {}),
        stereo=(orbit_stereo_sequence, (STEREO_FRAMES, W, H, f0, d0),
                dict(right=(f1, d1), T_c1_c2=EUROC_T_C1_C2)),
        rgbd=(rgbd_sequence, (RGBD_FRAMES, tw, th, TUM1_INTRINSICS), {}),
        stereo_vi=(vi_sequence, (STEREO_VI_FRAMES, W, H, f0),
                   dict(pinhole_dist=d0, T_c1_c2=EUROC_T_C1_C2, right=(f1, d1))),
        vocab=(loop_sequences, (), {}),
        gba=(gba_views_of_loop, (), {}),
        runner=(write_runner_sequences, (runner_root,), {}))
    # one thread each: the workers share the host with this process's
    # host-bound phases (they spawn in the submits, with this environment)
    threads = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
    saved = {k: os.environ.get(k) for k in threads}
    os.environ.update({k: "1" for k in threads})
    try:
        pool = ProcessPoolExecutor(RENDER_WORKERS,
                                   mp_context=multiprocessing.get_context("spawn"))
        futures = {name: pool.submit(timed_call, fn, *args, **kw)
                   for name, (fn, args, kw) in jobs.items()}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    return pool, futures


def rendered(futures: dict, name: str, what: str):
    """The inputs of `name` from its worker, logging the worker's render
    time and how long the phase waited for it."""
    t0 = time.perf_counter()
    out, seconds = futures[name].result()
    log(f"rendered {what} in a worker in {seconds:.2f} s; the phase waited "
        f"{time.perf_counter() - t0:.2f} s for it")
    return out


def runner_run(app, argv: list, snapshot_at: int | None = None, audit_frames=(),
               plain: bool = False) -> dict:
    """One dataset main (`app.run(argv)`, the card by default) with the
    launch counters set to 0 just before and read just after. Records the
    frames at which the IMU initialized (with the keyframe uid) and each
    ladder rung ran, the state after `snapshot_at` frames (`slam_state`),
    and `utils.timing.transfer_audit`'s counts around each of
    `audit_frames`. With `plain`, the kernels' plain versions run."""
    events, audits, snapshot = {}, {}, {}

    @contextlib.contextmanager
    def hook(i, slam, frame_log):
        m = slam.trackers[0].map
        kf_uid, box = int(m._next_uid), {}
        with timing.transfer_audit(box) if i in audit_frames else contextlib.nullcontext():
            yield
        m = slam.trackers[0].map
        if i in audit_frames:
            audits[i] = dict(box, track_ms=frame_log.track_ms[-1],
                             keyframes=int(m._next_uid) - kf_uid)
        if m.imu_initialized and "imu_init" not in events:
            events["imu_init"] = (i, int(m._next_uid) - 1)
        for stage in (1, 2):
            if m.iba_stage >= stage and f"viba{stage}" not in events:
                events[f"viba{stage}"] = i
        if i + 1 == snapshot_at:
            snapshot.update(slam_state(slam, frame_log.tracked, events))

    buf = io.StringIO()
    with contextlib.ExitStack() as stack:
        if plain:
            stack.enter_context(plain_kernels())
        torch.cuda.synchronize()
        _build.launches.clear()
        counted = timing.counts()
        with contextlib.redirect_stdout(buf):
            out = app.run(argv, frame_hook=hook)
        out["slam"].flush()
        torch.cuda.synchronize()
        out["launches"] = _build.snapshot()
        out["counts"] = {k: v - counted.get(k, 0) for k, v in timing.counts().items()}
    m = out["slam"].trackers[0].map
    out.update(events=events, audits=audits, stdout=buf.getvalue(),
               iba_stage=m.iba_stage, keyframes=m.n_keyframes, points=m.n_points)
    if snapshot_at is not None:
        out["snapshot"] = snapshot
    return out


def check_runner(path: str, run: dict, reference: dict, frames: int, smi: str,
                 policies, k2_per_frame: int = 1) -> None:
    """A runner's outcome against the JAX app's on the same files: the init
    and IMU-init frames within RUNNER_FRAME_TOL, the same `iba_stage`, the
    tracked share, the metric ATE within RUNNER_ATE_MARGIN; its host times
    and kernel launches printed."""
    fl = run["log"]
    s = fl.summary()
    launches = run["launches"]
    ate_bound = reference["ate_metric"] * RUNNER_ATE_MARGIN
    log(f"{path}: rc {run['rc']}, {s['frames']} frames; initialized at frame "
        f"{s['init_frame']} (JAX app {reference['init_frame']}), IMU at frame "
        f"{s['imu_init_frame']} (JAX app {reference['imu_init_frame']}; (frame, keyframe "
        f"uid) {run['events'].get('imu_init')}), iba_stage {run['iba_stage']} (JAX app "
        f"{reference['iba_stage']}); tracked share {s['tracked_share']:.3f}; "
        f"{run['keyframes']} keyframes, {run['points']} points; metric ATE "
        f"{run['ate']:.6f} m (bound {ate_bound:.6f} m = JAX app's "
        f"{reference['ate_metric']} m x {RUNNER_ATE_MARGIN})")
    log(f"{path}: track ms/frame p50 {s['track_ms']['p50']:.1f}, p90 "
        f"{s['track_ms']['p90']:.1f}, max {s['track_ms']['max']:.1f}; PNG decode "
        f"ms/frame p50 {s['decode_ms']['p50']:.2f}, p90 {s['decode_ms']['p90']:.2f}, max "
        f"{s['decode_ms']['max']:.2f} (host wall clock; {smi}); {run['wall_s']:.1f} s for "
        f"the run")
    log(f"{path}: launches {json.dumps(launches, sort_keys=True)}")
    if run["rc"] != 0:
        raise AssertionError(f"{path}: the app returned {run['rc']}")
    if abs(s["init_frame"] - reference["init_frame"]) > RUNNER_FRAME_TOL or s["init_frame"] < 0:
        raise AssertionError(f"{path}: initialized at frame {s['init_frame']}")
    if abs(s["imu_init_frame"] - reference["imu_init_frame"]) > RUNNER_FRAME_TOL:
        raise AssertionError(f"{path}: IMU initialized at frame {s['imu_init_frame']}")
    if run["iba_stage"] != reference["iba_stage"]:
        raise AssertionError(f"{path}: iba_stage {run['iba_stage']}")
    if s["tracked_share"] < TRACKED_SHARE:
        raise AssertionError(f"{path}: tracked {s['tracked_share']:.3f} of the frames")
    if not run["ate"] <= ate_bound:
        raise AssertionError(f"{path}: metric ATE {run['ate']} m over {ate_bound} m")
    check_policies(launches, frames, path, policies=policies, k2_per_frame=k2_per_frame)


def runner_phase(seqs: dict, root: str, smi: str) -> dict:
    """The dataset mains on the written sequences (`write_runner_sequences`):
    EuRoC mono-inertial (`run_euroc --imu --save-tum`, with
    `transfer_audit` around three tracked frames) and `eval_ate` on its
    trajectory, TUM-VI fisheye stereo-inertial (`run_euroc --tumvi --stereo
    --imu`) and its first RUNNER_PREFIX frames through the plain versions,
    TUM RGB-D (`run_rgbd`), `build_vocab` on 10 EuRoC frames loaded back,
    `opt_analy --mode all` against the same on the CPU, and the codec's
    decode and resize times. Returns the runs' launch counts."""
    out = {}
    traj = os.path.join(root, "euroc_traj.txt")
    eu = runner_run(run_euroc, ["--seq", seqs["euroc"], "--imu", "--save-tum", traj, "--quiet"],
                    audit_frames=RUNNER_AUDIT_FRAMES)
    check_runner("EuRoC runner (mono-inertial)", eu, RUNNER_REFERENCE["euroc"],
                 RUNNER_EUROC["n_frames"], smi, POLICIES)
    log_ladder_attempts("EuRoC runner (mono-inertial)", eu["counts"])
    log_vi_solves("EuRoC runner (mono-inertial)", eu["counts"])
    for i, a in sorted(eu["audits"].items()):
        log(f"transfer_audit, EuRoC frame {i}: h2d {a['h2d']}, d2h {a['d2h']}, synchronize "
            f"calls {a['syncs']}, {a['keyframes']} keyframe(s) made, track {a['track_ms']:.1f} "
            f"ms under the profiler ({smi})")
    out["euroc"] = eu["launches"]

    gt = os.path.join(seqs["euroc"], "mav0", "state_groundtruth_estimate0", "data.csv")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = eval_ate.main([gt, traj])
    rmse = float(buf.getvalue().split("absolute_translational_error.rmse ")[1].split()[0])
    log(f"eval_ate on the saved trajectory: rc {rc}, rmse {rmse:.6f} m (no scale); run_euroc "
        f"printed {eu['ate']:.6f} m ({eu['ate_mode']})")
    if rc != 0 or eu["ate_mode"] != "metric" or abs(rmse - eu["ate"]) > EVAL_ATE_TOL:
        raise AssertionError(f"eval_ate gives {rmse} m, run_euroc {eu['ate']} m")

    vi_args = ["--seq", seqs["tumvi"], "--tumvi", "--stereo", "--imu", "--quiet"]
    vi = runner_run(run_euroc, vi_args, snapshot_at=RUNNER_PREFIX)
    check_runner("TUM-VI runner (fisheye stereo-inertial)", vi, RUNNER_REFERENCE["tumvi"],
                 RUNNER_TUMVI["n_frames"], smi, FISHEYE_POLICIES, k2_per_frame=2)
    log_ladder_attempts("TUM-VI runner (fisheye stereo-inertial)", vi["counts"])
    log_vi_solves("TUM-VI runner (fisheye stereo-inertial)", vi["counts"])
    vplain = runner_run(run_euroc, vi_args + ["--max-frames", str(RUNNER_PREFIX)],
                        snapshot_at=RUNNER_PREFIX, plain=True)
    check_prefix_agree(vi, vplain, "TUM-VI runner")
    out["tumvi"] = vi["launches"]

    tum = runner_run(run_rgbd, ["--seq", seqs["tum"], "--quiet"])
    check_runner("TUM RGB-D runner", tum, RUNNER_REFERENCE["tum"], RUNNER_TUM["n_frames"],
                 smi, DEPTH_POLICIES)
    out["tum"] = tum["launches"]

    vocab_path = os.path.join(root, "vocab.npz")
    torch.cuda.synchronize()
    _build.launches.clear()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        bv = build_vocab.run(["--seq", seqs["euroc"], "--max-frames", "10", "--k", "10",
                              "--depth", "3", "--out", vocab_path])
    torch.cuda.synchronize()
    out["build_vocab"] = _build.snapshot()
    loaded = Vocabulary.load(vocab_path)
    same = (loaded.n_words == bv["vocab"].n_words == 1000
            and all(np.array_equal(a, b) for a, b in zip(loaded.levels, bv["vocab"].levels))
            and all(np.array_equal(a, b) for a, b in zip(loaded.valid, bv["vocab"].valid))
            and np.array_equal(loaded.idf, bv["vocab"].idf))
    log(f"build_vocab: {bv['frames']} frames, {bv['descriptors']} descriptors, "
        f"{loaded.n_words} words in {time.perf_counter() - t0:.2f} s; loaded back equal: "
        f"{same}; launches {json.dumps(out['build_vocab'], sort_keys=True)}")
    if bv["rc"] != 0 or not same or out["build_vocab"].get(patch.KERNEL, 0) != bv["frames"]:
        raise AssertionError("build_vocab: the saved vocabulary or its K2 launches are wrong")

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = opt_analy.main(["--mode", "all"])
    card_s = time.perf_counter() - t0
    printed = buf.getvalue().strip().splitlines()[1:]
    cpu = opt_analy.analyse(device="cpu")
    # the printed numbers: four mean errors in cm (0.1 cm), calib's two at 1e-4
    card = [float(x) for x in re.findall(r"[-+]?\d+\.\d+", "\n".join(printed))]
    ref = [cpu[k] * 100 for k in ("pos", "regu", "imu", "key")] + list(cpu["calib"].values())
    log(f"opt_analy --mode all on the card: rc {rc}, {card_s:.1f} s; {printed}; the CPU: {cpu}")
    if rc != 0 or len(card) != len(ref) or not all(
            abs(a - b) <= OPT_ANALY_TOL[0] + OPT_ANALY_TOL[1] * abs(b) for a, b in zip(card, ref)):
        raise AssertionError(f"opt_analy on the card {card} against the CPU's {ref}")

    seq = load_euroc(seqs["euroc"])
    decode, resize = [], {size: [] for size in RESIZE_TO}
    for i in range(10):
        t0 = time.perf_counter()
        img = seq.read_image(i)
        decode.append((time.perf_counter() - t0) * 1e3)
        for size in RESIZE_TO:
            t0 = time.perf_counter()
            imageio.resize_linear(img, *size)
            resize[size].append((time.perf_counter() - t0) * 1e3)
    log(f"PNG decode of a {W}x{H} frame: median {statistics.median(decode):.2f} ms; "
        + "; ".join(f"resize_linear to {w}x{h}: median {statistics.median(v):.2f} ms"
                    for (w, h), v in resize.items()) + f" (host wall clock; {smi})")
    return out


def write_runner_sequences(root: str, which=("euroc", "tumvi", "tum")) -> dict:
    """The runner phase's sequences written under `root` by the port's
    writers: {"euroc", "tumvi", "tum"} -> directory. The TUM-VI one keeps
    its ground truth under mocap0, as TUM-VI does. ORB_SYNTH_CACHE is
    ignored: every file is written here."""
    from orbslam3_tpu_torch.datasets.synth_euroc import write_synth_euroc
    from orbslam3_tpu_torch.datasets.tum_rgbd import write_synth_tum_rgbd
    saved = os.environ.pop("ORB_SYNTH_CACHE", None)
    out = {}
    try:
        if "euroc" in which:
            out["euroc"] = write_synth_euroc(os.path.join(root, "euroc"), **RUNNER_EUROC)
        if "tumvi" in which:
            d = write_synth_euroc(os.path.join(root, "tumvi"), **RUNNER_TUMVI)
            os.rename(os.path.join(d, "mav0", "state_groundtruth_estimate0"),
                      os.path.join(d, "mav0", "mocap0"))
            out["tumvi"] = d
        if "tum" in which:
            out["tum"] = write_synth_tum_rgbd(os.path.join(root, "tum"), **RUNNER_TUM)
    finally:
        if saved is not None:
            os.environ["ORB_SYNTH_CACHE"] = saved
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on an NVIDIA card", file=sys.stderr)
        return 1
    runner_root = tempfile.mkdtemp(prefix="chip_smoke_runners_")
    pool, futures = start_renders(runner_root)
    try:
        return phases(futures, pool, runner_root)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(runner_root, ignore_errors=True)


def phases(futures: dict, pool, runner_root: str) -> int:
    """Every phase, in order, on inputs the render workers prepare."""
    dev = torch.device("cuda")
    kernels = {}

    with phase("device+build"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
        log(smi)
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
        t0 = time.perf_counter()
        path, cached = _build.build()
        _build.library()
        log(f"build: {path.name} cached={cached} {time.perf_counter() - t0:.2f} s")

    camera = Camera.pinhole(*CAMERA, width=W, height=H, device=dev)
    img = textured_image(SEED, H, W).to(dev)

    with phase("K2 gather_patches vs plain"):
        atlas = image.gaussian_blur(image.build_atlas(img, N_LEVELS, SCALE))
        ah, aw = atlas.shape
        rows, _, _ = image.atlas_layout(H, W, N_LEVELS, SCALE)
        g = torch.Generator().manual_seed(SEED + 1)
        lvl = torch.randint(0, N_LEVELS, (N_FEATURES,), generator=g)
        m = image.ATLAS_MARGIN
        y_lvl = torch.tensor([rows[int(l)][0] for l in lvl])
        lh = torch.tensor([rows[int(l)][1] for l in lvl])
        lw = torch.tensor([rows[int(l)][2] for l in lvl])
        ys = y_lvl + m + (torch.rand(N_FEATURES, generator=g) * (lh - 2 * m)).long()
        xs = m + (torch.rand(N_FEATURES, generator=g) * (lw - 2 * m)).long()
        y0 = torch.clamp(ys - 16, 0, ah - 32).to(torch.int32).to(dev)
        x0 = torch.clamp(xs - 16, 0, aw - 32).to(torch.int32).to(dev)
        got = patch.gather_patches(atlas, y0, x0)
        ref = patch.gather_patches_reference(atlas, y0, x0)
        if not torch.equal(got, ref):
            raise AssertionError("K2 differs from its plain version")
        if not torch.equal(patch_library(atlas, y0, x0), ref):
            raise AssertionError("K2 yardstick differs from the plain version")
        k2_err = float((got - ref).abs().max())
        log(f"K2 exact on ({ah},{aw}) atlas, {N_FEATURES} patches: max |err| {k2_err}")

    with phase("K1 masked_top2 vs plain"):
        k1_err = 0
        # widths that straddle the kernel's 16-byte chunk and 512-byte
        # warp step, and one wider than its 1536-byte batch, follow the
        # tracker's shapes
        for n, mcols, seed in ((K_CANDIDATES, N_FEATURES, 1), (37, 53, 2),
                               (2051, 1199, 3), (1, 1, 4), (64, 100, 5),
                               (21, 15, 6), (21, 16, 7), (21, 17, 8), (21, 511, 9),
                               (21, 513, 10), (9, 2100, 11)):
            a, b, mask = window_case(dev, n, mcols, seed)
            if seed == 5:
                mask.zero_()  # every row empty
            if seed >= 6:
                mask[1::3] = False
                mask[1::3, -1] = True  # the last column the only candidate
                mask[2::6] = True      # full rows
            got = hamming.masked_top2(a, b, mask)
            ref = hamming.masked_top2_reference(a, b, mask)
            k1_err = max(k1_err, check_top2(got, ref, f"{n}x{mcols}"))
            pa, pb = desc_k.descriptor_planes(a), desc_k.descriptor_planes(b)
            planes = hamming.masked_top2(pa, pb, mask)  # the wrapper packs
            check_top2(planes, ref, f"{n}x{mcols} from planes")
            log(f"K1 exact at ({n},{mcols}): {int(mask.sum())} candidates, "
                f"{int((~mask.any(1)).sum())} empty rows")

    with phase("front end at full width"):
        R_true, t_true, R_pred, t_pred = known_poses(dev)
        _build.launches.clear()
        feats = extract_features(img, n_features=N_FEATURES, n_levels=N_LEVELS,
                                 scale=SCALE)
        mp = make_map(feats, camera, R_true, t_true, K_CANDIDATES, SEED + 2)
        ok, res = track(feats, mp, camera, R_pred, t_pred)
        torch.cuda.synchronize()
        front_launches = dict(_build.launches)
        n_valid = int(feats.valid.sum())
        nm = int(res["nm"])
        rot_err, trans_err = pose_error(res["R"], res["t"], R_true, t_true)
        mask = res["vsel"]
        right = mp["origin"][res["sel"].long()[mask]] == res["fidx"].long()[mask]
        log(f"features {n_valid}/{N_FEATURES} valid; tracked={ok} matches {nm} "
            f"inliers {int(res['n_in'])} planted-correct {int(right.sum())}/{int(mask.sum())}; "
            f"rot err {rot_err:.3e} rad, trans err {trans_err:.3e} m")
        log(f"launches on the front-end path: {json.dumps(front_launches, sort_keys=True)}")
        if not ok or nm < MATCH_SHARE * n_valid:
            raise AssertionError(f"tracking failed: ok={ok} matches {nm} of {n_valid}")
        if rot_err > ROT_TOL or trans_err > TRANS_TOL:
            raise AssertionError(f"pose error {rot_err} rad / {trans_err} m over "
                                 f"{ROT_TOL} / {TRANS_TOL}")
        for name in (patch.KERNEL, hamming.KERNEL):
            if front_launches.get(name, 0) < 1:
                raise AssertionError(f"kernel {name} was not launched on the front-end path")

        with plain_kernels():
            feats_p = extract_features(img, n_features=N_FEATURES, n_levels=N_LEVELS,
                                       scale=SCALE)
            ok_p, res_p = track(feats_p, mp, camera, R_pred, t_pred)
        for name in ("uv", "octave", "desc", "valid", "angle", "response"):
            if not torch.equal(getattr(feats, name), getattr(feats_p, name)):
                raise AssertionError(f"features differ between kernel and plain: {name}")
        d_pose = max(float((res["R"] - res_p["R"]).abs().max()),
                     float((res["t"] - res_p["t"]).abs().max()))
        if ok_p != ok or int(res_p["nm"]) != nm or d_pose > AGREE_POSE_TOL:
            raise AssertionError(f"kernel and plain front ends disagree: pose {d_pose}")
        log(f"kernel vs plain front end on the card: features identical, "
            f"matches {nm} vs {int(res_p['nm'])}, max pose diff {d_pose:.3e}")

    with phase("mono SLAM at full width"):
        imgs, R_gt, t_gt, stamps = rendered(futures, "mono", f"{SLAM_FRAMES} frames at {W}x{H}")
        mono_frames = imgs, R_gt, t_gt, stamps
        run = mono_slam(imgs, stamps, camera, snapshot_at=MONO_PREFIX)
        slam_launches = run["launches"]
        init = run["init"]
        after = run["tracked"][init:] if init >= 0 else []
        share = sum(after) / max(len(after), 1)
        ate = trajectory_ate(run["poses"], R_gt, t_gt, stamps)
        log(f"initialized at frame {init}; tracked {sum(after)}/{len(after)} frames "
            f"from there ({share:.3f}); {run['keyframes']} keyframes, {run['points']} "
            f"points; ATE {ate:.5f} m over {len(run['poses'])} poses (bound "
            f"{REFERENCE_ATE * ATE_MARGIN:.5f} m = JAX package's {REFERENCE_ATE} m x "
            f"{ATE_MARGIN})")
        log(f"launches on the mono SLAM path: {json.dumps(slam_launches, sort_keys=True)}")
        report_times(run, smi)
        log_ladder_attempts("mono SLAM", run["counts"])
        if not 0 <= init <= MAX_INIT_FRAME:
            raise AssertionError(f"the map initialized at frame {init}, not by "
                                 f"{MAX_INIT_FRAME}")
        if share < TRACKED_SHARE:
            raise AssertionError(f"tracked {share:.3f} of the frames after init")
        if not ate <= REFERENCE_ATE * ATE_MARGIN:
            raise AssertionError(f"ATE {ate} m over {REFERENCE_ATE * ATE_MARGIN} m")
        check_policies(slam_launches, SLAM_FRAMES, "mono SLAM")

        n = MONO_PREFIX
        plain = mono_slam(imgs[:n], stamps[:n], camera, plain=True, snapshot_at=n)
        check_prefix_agree(run, plain, "mono SLAM")

    with phase("mono-inertial SLAM at full width"):
        seq = rendered(futures, "vi", f"{VI_FRAMES} frames at {W}x{H} with 200 Hz IMU")
        batches = imu_batches(seq.frame_ts, seq.imu_ts, seq.gyro, seq.acc)
        t0 = time.perf_counter()
        vi = mono_slam(seq.images, seq.frame_ts, camera, imu=batches, snapshot_at=PLAIN_PREFIX)
        vi_seconds = time.perf_counter() - t0
        vi_launches = vi["launches"]
        m = vi["map"]
        ks = m.keyframe_ids()
        met = vi_metrics(vi["poses"], m.kf_R[ks], m.kf_t[ks], m.kf_ts[ks], seq.frame_ts,
                         seq.R_cw, seq.t_cw)
        vinit = vi["init"]
        after = vi["tracked"][vinit:] if vinit >= 0 else []
        vshare = sum(after) / max(len(after), 1)
        ate_bound = VI_REFERENCE["ate_metric"] * VI_ATE_MARGIN
        scale_bound = max(VI_SCALE_FLOOR, 2 * abs(VI_REFERENCE["kf_scale"] - 1.0))
        log(f"initialized at frame {vinit}; IMU initialized {vi['imu_initialized']} "
            f"(frame, keyframe uid) {vi['events'].get('imu_init')}; VIBA1 at frame "
            f"{vi['events'].get('viba1')}, VIBA2 at frame {vi['events'].get('viba2')}; "
            f"iba_stage {vi['iba_stage']} (JAX package: {VI_REFERENCE['iba_stage']}); "
            f"tracked {sum(after)}/{len(after)} from init ({vshare:.3f}); "
            f"{vi['keyframes']} keyframes, {vi['points']} points; events {vi['log']}")
        log(f"metric ATE {met['ate_metric']:.5f} m (bound {ate_bound:.5f} m = JAX "
            f"package's {VI_REFERENCE['ate_metric']} m x {VI_ATE_MARGIN}), Sim3-aligned "
            f"{met['ate_sim3']:.5f} m, keyframe metric ATE {met['kf_ate_metric']:.5f} m; "
            f"keyframe scale {met['kf_scale']:.5f} (bound |s-1| <= {scale_bound:.3f}); "
            f"gravity tilt {met['gravity_tilt_deg']:.3f} deg (JAX package "
            f"{VI_REFERENCE['gravity_tilt_deg']} deg); {vi_seconds:.1f} s for the run")
        log(f"launches on the mono-inertial SLAM path: "
            f"{json.dumps(vi_launches, sort_keys=True)}")
        report_times(vi, smi)
        log_ladder_attempts("mono-inertial SLAM", vi["counts"])
        log_vi_solves("mono-inertial SLAM", vi["counts"])
        if not 0 <= vinit <= MAX_INIT_FRAME:
            raise AssertionError(f"the VI map initialized at frame {vinit}")
        if not vi["imu_initialized"]:
            raise AssertionError("the IMU did not initialize")
        if vi["iba_stage"] != VI_REFERENCE["iba_stage"]:
            raise AssertionError(f"iba_stage {vi['iba_stage']}, the JAX package reaches "
                                 f"{VI_REFERENCE['iba_stage']}")
        if vshare < TRACKED_SHARE:
            raise AssertionError(f"tracked {vshare:.3f} of the frames after init")
        if not met["ate_metric"] <= ate_bound:
            raise AssertionError(f"metric ATE {met['ate_metric']} m over {ate_bound} m")
        if not abs(met["kf_scale"] - 1.0) <= scale_bound:
            raise AssertionError(f"keyframe scale {met['kf_scale']} off by more than "
                                 f"{scale_bound}")
        check_policies(vi_launches, VI_FRAMES, "mono-inertial SLAM")

        n = PLAIN_PREFIX
        vplain = mono_slam(seq.images[:n], seq.frame_ts[:n], camera, plain=True,
                           imu=batches[:n], snapshot_at=n)
        check_prefix_agree(vi, vplain, "VI SLAM")

    with phase("stereo SLAM at full width"):
        left, right, R_gt, t_gt, stamps = rendered(
            futures, "stereo", f"{STEREO_FRAMES} raw stereo pairs at {W}x{H}")
        st_run = depth_phase("stereo SLAM", EUROC_STEREO_YAML, "stereo",
                             list(zip(left, right)), stamps, R_gt, t_gt, STEREO_REFERENCE, smi)

    with phase("RGB-D SLAM at full width"):
        th, tw = TUM1_SIZE
        rgbd = rendered(futures, "rgbd", f"{RGBD_FRAMES} frames at {tw}x{th} with uint16 depth")
        factor = 1.0 / Settings.from_text(TUM1_RGBD_YAML, "rgbd").depth_map_factor
        rgbd_run = depth_phase("RGB-D SLAM", TUM1_RGBD_YAML, "rgbd",
                               list(zip(rgbd.images, rgbd.depth)), rgbd.frame_ts, rgbd.R_cw,
                               rgbd.t_cw, RGBD_REFERENCE, smi, depth_factor=factor)

    with phase("stereo-inertial SLAM at full width"):
        sv = rendered(futures, "stereo_vi",
                      f"{STEREO_VI_FRAMES} raw stereo pairs at {W}x{H} with 200 Hz IMU")
        sv_batches = imu_batches(sv.frame_ts, sv.imu_ts, sv.gyro, sv.acc)
        sv_run = depth_phase("stereo-inertial SLAM", EUROC_STEREO_INERTIAL_YAML, "imu_stereo",
                             list(zip(sv.images, sv.images_right)), sv.frame_ts, sv.R_cw,
                             sv.t_cw, STEREO_VI_REFERENCE, smi, imu=sv_batches,
                             plain_frames=PLAIN_PREFIX)

    with phase("mono SLAM with a vocabulary at full width"):
        seqs = rendered(futures, "vocab", "the vocabulary phase's sessions")
        log(f"{sum(len(v[3]) for v in seqs.values())} frames at {W}x{H} "
            f"({', '.join(f'{k} {len(v[3])}' for k, v in seqs.items())})")
        t0 = time.perf_counter()
        voc = vocab_slam(seqs, camera)
        log(f"vocabulary phase: {time.perf_counter() - t0:.1f} s for the kernel run; "
            f"launches {json.dumps(voc['launches'], sort_keys=True)}")
        check_vocab(voc, smi)
        voc_plain = vocab_slam(seqs, camera, plain=True)
        check_vocab_agree(voc, voc_plain)
        voc["k1_inputs"]["bow"] = bow_input(voc["slam"], seqs["localize"][0][-1])
        bow_fallbacks = voc["launches"].get(f"{hamming.KERNEL}[bow]", 0)
        log(f"the BoW fallback launched K1 {bow_fallbacks} times on the phase's path")
        del voc_plain

    with phase("atlas save and load"):
        voc_slam = voc.pop("slam")  # the lifecycle phase's global BA runs on its map
        atlas_round_trip(voc_slam, seqs, camera)

    with phase("edge server at full width"):
        plan = edge_plan()
        t0 = time.perf_counter()
        edge = edge_run(seq, batches, plan)
        log(f"edge phase: {time.perf_counter() - t0:.1f} s for the kernel run over "
            f"{len(plan)} packets")
        check_edge(edge, plan, smi)
        log_ladder_attempts("edge server", edge["counts"])
        log_vi_solves("edge server", edge["counts"])
        edge_plain = edge_run(seq, batches, plan, plain=True)
        check_edge_agree(edge, edge_plain)
        del edge_plain

    with phase("mono SLAM with async mapping"):
        imgs, R_gt, t_gt, stamps = mono_frames
        arun = mono_slam(imgs, stamps, camera, async_mapping=True)
        check_async(arun, run, R_gt, t_gt, stamps, smi)
        del arun

    with phase("distributed back end"):
        blocks_round_trip(run["map"], dev)
        sharded_ba_check(run["map"], camera, smi)
        dist_run = multihost_run()
        check_multihost(dist_run, smi)

    with phase("lifecycle: faults and tiers"):
        t0 = time.perf_counter()
        life = lifecycle_run(seq, batches, camera)
        log(f"lifecycle faulted run: {time.perf_counter() - t0:.1f} s")
        respawn = next(n for n, (_, _, f) in enumerate(lifecycle_plan()) if f == "backward")
        life_plain = lifecycle_run(seq, batches, camera, plain=True, stop_after=respawn + 1)
        check_lifecycle(life, life_plain, smi)
        del life_plain

    with phase("lifecycle: background global BA"):
        views = rendered(futures, "gba", f"{LIFECYCLE_GBA_FRAMES} new views of client 1")
        gba_run = background_gba(voc_slam, views)
        voc_slam.shutdown()
        check_background_gba(gba_run, smi)
        del voc_slam

    with phase("lifecycle: two paced edge lanes"):
        paced = paced_edge_run(seq, batches)
        check_paced_edge(paced, smi)

    with phase("runners on written sequences"):
        runner_seqs = rendered(futures, "runner", "the runners' sequences, written to disk,")
        pool.shutdown(wait=True)  # every input is in; the timings want no other thread
        runner = runner_phase(runner_seqs, runner_root, smi)

    with phase("timings"):
        others = [t.name for t in threading.enumerate() if t is not threading.main_thread()]
        if others:  # a launch from another thread would break the graph captures
            raise AssertionError(f"threads still running before the timings: {others}")

        extract_ms = median_frame_ms(lambda: extract_features(
            img, n_features=N_FEATURES, n_levels=N_LEVELS, scale=SCALE))
        track_ms = median_frame_ms(lambda: track(feats, mp, camera, R_pred, t_pred))
        log(f"front end: extract_features {extract_ms:.3f} ms/frame, fused_track_pose "
            f"{track_ms:.3f} ms/frame (median of {FRAMES} frames)")

        # each kernel at inputs the SLAM run handed it
        depth_runs = (("stereo", st_run), ("rgbd", rgbd_run), ("stereo_vi", sv_run))
        atlas, y0, x0 = run["k2_input"]
        kernels[patch.KERNEL] = dict(
            name=patch.KERNEL, route="cuda", source="orbslam3_tpu_torch/csrc/patch_gather.cu",
            replaces="orbslam3_tpu/kernels/patch_pallas.py:91",
            launches=slam_launches.get(patch.KERNEL, 0),
            launches_front_end=front_launches.get(patch.KERNEL, 0),
            launches_vi=vi_launches.get(patch.KERNEL, 0),
            **{f"launches_{key}": r["launches"].get(patch.KERNEL, 0) for key, r in depth_runs},
            launches_vocab=voc["launches"].get(patch.KERNEL, 0),
            launches_edge={"server": edge["server"].get(patch.KERNEL, 0),
                           "phones": edge["phones"].get(patch.KERNEL, 0)},
            launches_multihost=[r.get(patch.KERNEL, 0) for r in dist_run["launches"]],
            launches_runner={key: r.get(patch.KERNEL, 0) for key, r in runner.items()},
            launches_lifecycle={"faults": life["launches"].get(patch.KERNEL, 0),
                                "gba": gba_run["launches"].get(patch.KERNEL, 0),
                                "lanes_phones": paced["phones"].get(patch.KERNEL, 0),
                                "lanes_server": paced["launches"].get(patch.KERNEL, 0)},
            max_abs_err=k2_err, **k2_times(atlas, y0, x0))
        # K1 at one captured mask of each policy: the mono run's four, the
        # stereo run's row band, and one fisheye pair's all-valid mask
        masks = [(pol, run["k1_inputs"][pol], slam_launches) for pol in POLICIES]
        masks.append(("stereo", st_run["k1_inputs"]["stereo"], st_run["launches"]))
        masks.append(("fisheye_stereo", fisheye_pair(dev), {}))
        masks += [(pol, voc["k1_inputs"][pol], voc["launches"])
                  for pol in ("bow", "loop", "reloc")]
        policies = []
        for pol, (a, b, mask), launched in masks:
            rec = k1_times(a, b, mask)
            policies.append(dict(policy=pol, shape=list(mask.shape), **rec))
            log(f"masked_top2 at the {pol} policy's mask {tuple(mask.shape)}: "
                f"{rec['candidates']} candidates ({rec['density'] * 100:.3f}%), device "
                f"{rec['ms'] * 1e3:.2f} us (bound {rec['bound_ms'] * 1e3:.2f} us by "
                f"{rec['bound_by']}), plain {rec['plain_ms'] * 1e3:.2f} us, library "
                f"{rec['library_ms'] * 1e3:.2f} us; exact vs plain; "
                f"{launched.get(f'{hamming.KERNEL}[{pol}]', 0)} launches on its SLAM path")
        k1 = {k: v for k, v in policies[0].items()
              if k in ("ms", "plain_ms", "plain_timed_by", "bound_ms", "bound_by",
                       "library_ms")}
        kernels[hamming.KERNEL] = dict(
            name=hamming.KERNEL, route="cuda", source="orbslam3_tpu_torch/csrc/hamming_top2.cu",
            replaces="orbslam3_tpu/kernels/hamming_pallas.py:108",
            launches=slam_launches.get(hamming.KERNEL, 0),
            launches_front_end=front_launches.get(hamming.KERNEL, 0),
            launches_by_policy={pol: slam_launches.get(f"{hamming.KERNEL}[{pol}]", 0)
                                for pol in POLICIES},
            launches_vi=vi_launches.get(hamming.KERNEL, 0),
            launches_by_policy_vi={pol: vi_launches.get(f"{hamming.KERNEL}[{pol}]", 0)
                                   for pol in POLICIES},
            **{f"launches_{key}": r["launches"].get(hamming.KERNEL, 0) for key, r in depth_runs},
            **{f"launches_by_policy_{key}": {
                pol: r["launches"].get(f"{hamming.KERNEL}[{pol}]", 0)
                for pol in DEPTH_POLICIES + ("stereo",)} for key, r in depth_runs},
            launches_vocab=voc["launches"].get(hamming.KERNEL, 0),
            launches_by_policy_vocab={pol: voc["launches"].get(f"{hamming.KERNEL}[{pol}]", 0)
                                      for pol in VOCAB_POLICIES + ("bow",)},
            launches_edge={"server": edge["server"].get(hamming.KERNEL, 0),
                           "phones": edge["phones"].get(hamming.KERNEL, 0)},
            launches_by_policy_edge={pol: edge["server"].get(f"{hamming.KERNEL}[{pol}]", 0)
                                     for pol in EDGE_POLICIES + ("bow", "loop")},
            launches_multihost=[r.get(hamming.KERNEL, 0) for r in dist_run["launches"]],
            launches_by_policy_multihost=[{pol: r.get(f"{hamming.KERNEL}[{pol}]", 0)
                                           for pol in MULTIHOST_POLICIES}
                                          for r in dist_run["launches"]],
            launches_runner={key: r.get(hamming.KERNEL, 0) for key, r in runner.items()},
            launches_by_policy_runner={
                key: {k.split("[")[1][:-1]: v for k, v in sorted(r.items())
                      if k.startswith(f"{hamming.KERNEL}[")} for key, r in runner.items()},
            launches_lifecycle={key: r.get(hamming.KERNEL, 0) for key, r in (
                ("faults", life["launches"]), ("gba", gba_run["launches"]),
                ("lanes_server", paced["launches"]))},
            launches_by_policy_lifecycle={
                key: {k.split("[")[1][:-1]: v for k, v in sorted(r.items())
                      if k.startswith(f"{hamming.KERNEL}[")}
                for key, r in (("faults", life["launches"]), ("gba", gba_run["launches"]),
                               ("lanes_server", paced["launches"]))},
            max_abs_err=k1_err, **k1, policies=policies)
        for kv in kernels.values():
            log(f"{kv['name']}: device {kv['ms'] * 1e3:.2f} us (bound "
                f"{kv['bound_ms'] * 1e3:.2f} us by {kv['bound_by']}), plain "
                f"{kv['plain_ms'] * 1e3:.2f} us, library {kv['library_ms'] * 1e3:.2f} us; "
                f"{kv['launches']} launches on the mono SLAM path")

        a, b, mask = run["k1_inputs"]["tracker"]
        pa, pb = desc_k.descriptor_planes(a), desc_k.descriptor_planes(b)
        log(f"masked_top2 eager call handed packed words: "
            f"{cuda_ms(lambda: hamming.masked_top2(a, b, mask), KERNEL_ITERS) * 1e3:.2f} us, "
            f"handed +/-1 planes: "
            f"{cuda_ms(lambda: hamming.masked_top2(pa, pb, mask), KERNEL_ITERS) * 1e3:.2f} us")
        # K1 across mask densities at the tracker's shape and descriptors
        nn, mm = mask.shape
        x = torch.zeros(1, device=dev)
        floor_ms = device_ms(lambda: x.add_(1), KERNEL_ITERS)
        log(f"launch floor: one-element add_ {floor_ms * 1e3:.2f} us "
            f"(device time, CUDA graph replay)")
        g = torch.Generator(device=dev).manual_seed(SEED + 3)
        bf_a, bf_b = pa.to(torch.bfloat16), pb.to(torch.bfloat16)
        for label, dmask in (("tracker", mask),
                             ("random 2%", torch.rand((nn, mm), generator=g, device=dev) < 0.02),
                             ("all true", torch.ones((nn, mm), dtype=torch.bool, device=dev)),
                             ("all false", torch.zeros((nn, mm), dtype=torch.bool, device=dev))):
            check_top2(hamming.masked_top2(a, b, dmask),
                       hamming.masked_top2_reference(a, b, dmask), f"{label} mask")
            dbound, dby = k1_bound(nn, mm, int(dmask.sum()))
            log(f"masked_top2 at ({nn},{mm}), {label} mask, {int(dmask.sum())} "
                f"candidates: device "
                f"{device_ms(lambda: hamming.masked_top2(a, b, dmask), KERNEL_ITERS) * 1e3:.2f}"
                f" us (bound {dbound * 1e3:.2f} us by {dby}), library "
                f"{device_ms(lambda: top2_library(bf_a, bf_b, dmask), PLAIN_ITERS) * 1e3:.2f}"
                f" us; exact vs plain")
        # and over the first w of its candidates, where the launch's fixed
        # cost outweighs the mask
        for w in (1, 32, 128, 512):
            bw, wmask = b[:w], torch.rand((nn, w), generator=g, device=dev) < 0.02
            check_top2(hamming.masked_top2(a, bw, wmask),
                       hamming.masked_top2_reference(a, bw, wmask), f"width {w} mask")
            log(f"masked_top2 at ({nn},{w}), random 2% mask, {int(wmask.sum())} "
                f"candidates: device "
                f"{device_ms(lambda: hamming.masked_top2(a, bw, wmask), KERNEL_ITERS) * 1e3:.2f}"
                f" us; exact vs plain")

    log(f"{len(PHASE_SECONDS)} phases: {sum(PHASE_SECONDS):.1f} s")
    log(smi)
    log(json.dumps({"kernels": list(kernels.values())}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
