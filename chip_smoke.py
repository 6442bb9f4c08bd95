#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's two main paths on one NVIDIA card.

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
  poses, K1's launches per matcher policy and K2's per frame, then the
  same frames once more through the kernels' plain versions, a run that
  must launch no kernel;
- mono-inertial SLAM (`Slam(sensor=IMU_MONOCULAR).track_monocular(...,
  imu=...)`) over a rendered 120-frame sequence with 200 Hz IMU
  (`vi_sequence`): the IMU initialization, the VIBA1/VIBA2 ladder, the
  tracked share, the metric ATE (no scale alignment), the keyframe scale
  and the gravity tilt against the rendered truth and the JAX package's
  run on the same images, the kernels' launches, and a plain-kernel rerun
  that must launch no kernel and agree.

Each path is driven with the launch counters set to 0 just before it and
read just after, and fails if a kernel of the path was not launched. The
timings phase times both kernels by replaying a captured CUDA graph (so
their device time is not hidden behind host launch overhead) at the inputs
the SLAM run handed them: K1 at one captured mask of each matcher policy
(tracker, init, triangulation, fuse), each held exactly against the plain
version, beside its library call and its byte bound; K1 also under four
masks at the tracker's shape and at narrow widths, and the launch floor (a
one-element op under the same replay). Each phase prints one line with its
wall seconds. The line before the last is the kernels' JSON record; the
last line is ``{"ok": true, "device": {...}}``. Any failed phase raises, so
the script exits non-zero and prints no result; so does a machine without a
card. It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from orbslam3_tpu_torch import _build
from orbslam3_tpu_torch.core import lie
from orbslam3_tpu_torch.core.camera import Camera
from orbslam3_tpu_torch.datasets.render import imu_batches, orbit_sequence, vi_sequence
from orbslam3_tpu_torch.engine import local_mapping
from orbslam3_tpu_torch.engine.local_mapping import LocalMapperConfig
from orbslam3_tpu_torch.engine.system import Sensor, Slam, SystemConfig
from orbslam3_tpu_torch.engine.track_program import fused_track_pose
from orbslam3_tpu_torch.engine.tracking import TrackerConfig
from orbslam3_tpu_torch.evaluation import ate_rmse, vi_metrics
from orbslam3_tpu_torch.imu.preintegration import ImuCalib
from orbslam3_tpu_torch.kernels import hamming, image, patch
from orbslam3_tpu_torch.kernels import orb_descriptor as desc_k
from orbslam3_tpu_torch.slam_map.map_state import MapConfig
from orbslam3_tpu_torch.utils import timing
from orbslam3_tpu_torch.vision.frame import extract_features

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
    log(f"phase {name}: ok ({time.perf_counter() - t0:.2f} s)")


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


def mono_slam(imgs, stamps, camera: Camera, plain: bool = False, imu=None) -> dict:
    """`Slam.track_monocular` over the frames on the card, launch counters
    set to 0 just before and read just after. The kernel run also keeps
    the first K1 input of each matcher policy (as packed words and mask)
    and the first K2 input. With `plain`, the kernels' plain versions run
    instead. With `imu` (one batch of samples a frame) the sensor is
    IMU_MONOCULAR, and the frames at which the IMU initialized and each
    ladder rung ran are recorded."""
    cfg = SystemConfig(map=MapConfig(features_per_frame=N_FEATURES),
                       tracker=TrackerConfig(n_features=N_FEATURES, n_levels=N_LEVELS,
                                             scale_factor=SCALE))
    if imu is not None:
        cfg.sensor, cfg.imu_calib = Sensor.IMU_MONOCULAR, ImuCalib.create()
        cfg.mapper = LocalMapperConfig(**VI_CADENCE)
    slam = Slam(camera, cfg)  # the card: the default device
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
            for i, (im, ts) in enumerate(zip(imgs, stamps)):
                t0 = time.perf_counter()
                tracked.append(slam.track_monocular(
                    im, float(ts), imu=None if imu is None else imu[i]) is not None)
                torch.cuda.synchronize()
                frame_ms.append((time.perf_counter() - t0) * 1e3)
                m = slam.trackers[0].map
                if m.imu_initialized and "imu_init" not in events:
                    events["imu_init"] = (i, int(m._next_uid) - 1)
                for stage in (1, 2):
                    if m.iba_stage >= stage and f"viba{stage}" not in events:
                        events[f"viba{stage}"] = i
            launches = dict(_build.launches)
    finally:
        local_mapping.LocalMapper.process_keyframe = process
        timing.enable(False)
    m = slam.trackers[0].map
    out = dict(tracked=tracked, init=tracked.index(True) if any(tracked) else -1,
               keyframes=m.n_keyframes, points=m.n_points, poses=slam._full_poses(),
               launches=launches, frame_ms=frame_ms, kf_ms=kf_ms, stages=timing.stats(),
               events=events, imu_initialized=m.imu_initialized, iba_stage=m.iba_stage,
               map=m, log=[e["event"] for e in slam.events])
    if not plain:
        out["k1_inputs"] = {kw["policy"]: (hamming._as_words(a), hamming._as_words(b), mk)
                            for (a, b, mk), kw in k1_calls}
        out["k2_input"] = k2_calls[0][0]
    return out


def report_times(run: dict, smi: str) -> None:
    """Print a SLAM run's host times: per frame, per keyframe, per stage."""
    frame_ms, kf_ms = np.asarray(run["frame_ms"]), np.asarray(run["kf_ms"])
    log(f"track_monocular ms/frame over {len(frame_ms)} frames: p50 "
        f"{np.percentile(frame_ms, 50):.1f}, p90 {np.percentile(frame_ms, 90):.1f}, "
        f"max {frame_ms.max():.1f}; local mapping ms/keyframe over {len(kf_ms)}: "
        f"p50 {np.percentile(kf_ms, 50):.1f}, max {kf_ms.max():.1f} "
        f"(host wall clock, synchronized; {smi})")
    for name, st in sorted(run["stages"].items()):
        log(f"stage {name}: n {st['n']}, median {st['median_ms']:.1f} ms, p90 "
            f"{st['p90_ms']:.1f} ms, total {st['total_ms']:.1f} ms (host wall clock; "
            f"each stage ends in a host read of its result)")


def check_policies(launches: dict, frames: int, path: str) -> None:
    """K2 once a frame and K1 under every matcher policy on a SLAM path."""
    if launches.get(patch.KERNEL, 0) != frames:
        raise AssertionError(f"K2 launched {launches.get(patch.KERNEL, 0)} times over "
                             f"{frames} frames on the {path} path")
    for pol in POLICIES:
        if launches.get(f"{hamming.KERNEL}[{pol}]", 0) < 1:
            raise AssertionError(f"K1 was not launched by the {pol} policy on the "
                                 f"{path} path")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on an NVIDIA card", file=sys.stderr)
        return 1
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
        t0 = time.perf_counter()
        imgs, R_gt, t_gt, stamps = orbit_sequence(SLAM_FRAMES, W, H, CAMERA)
        log(f"rendered {SLAM_FRAMES} frames at {W}x{H} in {time.perf_counter() - t0:.2f} s")
        run = mono_slam(imgs, stamps, camera)
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
        if not 0 <= init <= MAX_INIT_FRAME:
            raise AssertionError(f"the map initialized at frame {init}, not by "
                                 f"{MAX_INIT_FRAME}")
        if share < TRACKED_SHARE:
            raise AssertionError(f"tracked {share:.3f} of the frames after init")
        if not ate <= REFERENCE_ATE * ATE_MARGIN:
            raise AssertionError(f"ATE {ate} m over {REFERENCE_ATE * ATE_MARGIN} m")
        check_policies(slam_launches, SLAM_FRAMES, "mono SLAM")

        plain = mono_slam(imgs, stamps, camera, plain=True)
        if any(plain["launches"].values()):
            raise AssertionError(f"the plain-kernel SLAM run launched kernels: "
                                 f"{json.dumps(plain['launches'], sort_keys=True)}")
        d_centre = max(float(np.abs(a[2] - b[2]).max())
                       for a, b in zip(run["poses"], plain["poses"]))
        log(f"kernel vs plain SLAM on the card: init frame {init} vs {plain['init']}, "
            f"keyframes {run['keyframes']} vs {plain['keyframes']}, points "
            f"{run['points']} vs {plain['points']}, max camera-centre diff "
            f"{d_centre:.3e} m")
        if (plain["init"] != init or plain["keyframes"] != run["keyframes"]
                or plain["points"] != run["points"]
                or len(plain["poses"]) != len(run["poses"]) or d_centre > AGREE_CENTRE_TOL):
            raise AssertionError("kernel and plain SLAM runs disagree")

    with phase("mono-inertial SLAM at full width"):
        t0 = time.perf_counter()
        seq = vi_sequence(VI_FRAMES, W, H, CAMERA)
        batches = imu_batches(seq.frame_ts, seq.imu_ts, seq.gyro, seq.acc)
        log(f"rendered {VI_FRAMES} frames at {W}x{H} with {len(seq.imu_ts)} IMU samples "
            f"in {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        vi = mono_slam(seq.images, seq.frame_ts, camera, imu=batches)
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

        vplain = mono_slam(seq.images, seq.frame_ts, camera, plain=True, imu=batches)
        if any(vplain["launches"].values()):
            raise AssertionError(f"the plain-kernel VI run launched kernels: "
                                 f"{json.dumps(vplain['launches'], sort_keys=True)}")
        d_centre = max(float(np.abs(a[2] - b[2]).max())
                       for a, b in zip(vi["poses"], vplain["poses"]))
        log(f"kernel vs plain VI SLAM on the card: init frame {vinit} vs {vplain['init']}, "
            f"IMU init {vi['events'].get('imu_init')} vs {vplain['events'].get('imu_init')}, "
            f"iba_stage {vi['iba_stage']} vs {vplain['iba_stage']}, keyframes "
            f"{vi['keyframes']} vs {vplain['keyframes']}, max camera-centre diff "
            f"{d_centre:.3e} m")
        if (vplain["init"] != vinit or vplain["events"].get("imu_init") != vi["events"].get("imu_init")
                or vplain["iba_stage"] != vi["iba_stage"]
                or vplain["keyframes"] != vi["keyframes"]
                or len(vplain["poses"]) != len(vi["poses"]) or d_centre > AGREE_CENTRE_TOL):
            raise AssertionError("kernel and plain VI SLAM runs disagree")

    with phase("timings"):
        extract_ms = median_frame_ms(lambda: extract_features(
            img, n_features=N_FEATURES, n_levels=N_LEVELS, scale=SCALE))
        track_ms = median_frame_ms(lambda: track(feats, mp, camera, R_pred, t_pred))
        log(f"front end: extract_features {extract_ms:.3f} ms/frame, fused_track_pose "
            f"{track_ms:.3f} ms/frame (median of {FRAMES} frames)")

        # each kernel at inputs the SLAM run handed it
        atlas, y0, x0 = run["k2_input"]
        kernels[patch.KERNEL] = dict(
            name=patch.KERNEL, route="cuda", source="orbslam3_tpu_torch/csrc/patch_gather.cu",
            replaces="orbslam3_tpu/kernels/patch_pallas.py:91",
            launches=slam_launches.get(patch.KERNEL, 0),
            launches_front_end=front_launches.get(patch.KERNEL, 0),
            launches_vi=vi_launches.get(patch.KERNEL, 0),
            max_abs_err=k2_err, **k2_times(atlas, y0, x0))
        policies = []
        for pol in POLICIES:
            a, b, mask = run["k1_inputs"][pol]
            rec = k1_times(a, b, mask)
            policies.append(dict(policy=pol, shape=list(mask.shape), **rec))
            log(f"masked_top2 at the {pol} policy's mask {tuple(mask.shape)}: "
                f"{rec['candidates']} candidates ({rec['density'] * 100:.3f}%), device "
                f"{rec['ms'] * 1e3:.2f} us (bound {rec['bound_ms'] * 1e3:.2f} us by "
                f"{rec['bound_by']}), plain {rec['plain_ms'] * 1e3:.2f} us, library "
                f"{rec['library_ms'] * 1e3:.2f} us; exact vs plain; "
                f"{slam_launches.get(f'{hamming.KERNEL}[{pol}]', 0)} launches")
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

    log(smi)
    log(json.dumps({"kernels": list(kernels.values())}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
