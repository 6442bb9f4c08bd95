"""Tracking front end: the per-frame state machine over the device stages.

Port of `orbslam3_tpu/engine/tracking.py` (ORB-SLAM3's `Tracking`):
monocular, stereo and RGB-D, each with or without an IMU. The host owns the
state machine
(NOT_INITIALIZED / OK / RECENTLY_LOST / LOST); feature extraction,
projection search, pose optimization and two-view initialization run on
`device` (the card unless ``device="cpu"``):

- stereo and RGB-D ingestion (`GrabImageStereo` / `GrabImageRGBD`): the
  raw pair rectified on the device, both images extracted, per-feature
  depth and virtual right coordinate from the row-band matcher, from the
  fisheye pair's triangulation, or from the depth map, far depths gated
  (`thFarPoints`);
- stereo / RGB-D initialization (`StereoInitialization`): the first frame
  with enough depths becomes a keyframe with its points unprojected;
- monocular initialization (`MonocularInitialization` +
  `CreateInitialMapMonocular`): wide-window matching, H/F RANSAC, the map
  bootstrap with median-depth normalization, the init BA;
- motion-model and local-map tracking through `fused_track_pose` (the
  projection-search retry ladder and pose GN, with stereo rows where a
  feature has a right coordinate);
- with an IMU (`imu_calib`): the sample queue and per-frame
  preintegration (`PreintegrateIMU`), the IMU pose prediction once the map
  is inertial (`PredictStateIMU`), the visual-inertial pose refinement
  (`PoseInertialOptimizationLastKeyFrame` / `LastFrame`), the keyframe
  cadence of inertial maps, the KF->KF preintegration chain, and the
  hand-off after the mapper re-gauges the map (`UpdateFrameIMU`);
- the keyframe policy (`NeedNewKeyFrame` / `CreateNewKeyFrame`, which
  on stereo and RGB-D maps spawns points at the close unmatched features);
- with a vocabulary (`bow_fn`, set by `Slam`): `TrackReferenceKeyFrame`,
  the reference keyframe matched by vocabulary buckets (`search_by_bow`,
  K1 policy "bow") when the projection ladder fails;
- relocalization through the `relocalizer` callable (`Slam._relocalize`):
  a secondary client or a tracker in localization mode relocalizes where
  the primary would initialize, a recently lost frame tries it, and a
  lost tracker in localization mode keeps trying it; on an inertial map
  the tracker then tracks visually until its next keyframe, from which its
  inertial chain restarts (the relocalized frame's reference keyframe may
  be another lane's, at another time);
- localization mode (`only_tracking`): no keyframes;
- the per-frame relative-pose log for trajectory export.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional

import numpy as np
import torch

from orbslam3_tpu_torch import device as device_policy
from orbslam3_tpu_torch.convert import words_to_int32
from orbslam3_tpu_torch.engine.track_program import TrackPoseGraphs, fused_track_pose
from orbslam3_tpu_torch.imu import init as imu_init
from orbslam3_tpu_torch.imu import preintegration as preint
from orbslam3_tpu_torch.opt.pose_gn import optimize_pose
from orbslam3_tpu_torch.opt.pose_inertial import (BodyState, PoseInertialGraphs,
                                                  optimize_pose_inertial)
from orbslam3_tpu_torch.slam_map.map_state import MapState
from orbslam3_tpu_torch.utils import timing
from orbslam3_tpu_torch.vision import matcher
from orbslam3_tpu_torch.vision import stereo as stereo_m
from orbslam3_tpu_torch.vision.frame import FrameFeatures, extract_features
from orbslam3_tpu_torch.vision.twoview import reconstruct_two_views

# the most the frame's preintegration may fall short of the frame interval
# (its last sample before the frame's timestamp) for the velocity from poses
# and IMU: two samples at EuRoC's 200 Hz
IMU_VELOCITY_DT_SLACK_S = 0.01


class TrackingState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    RECENTLY_LOST = 3
    LOST = 4


@dataclasses.dataclass
class TrackerConfig:
    """The reference's `TrackerConfig` fields, with its defaults (but for
    `kf_min_interval`, which it reads nowhere)."""
    n_features: int = 600
    init_min_matches: int = 80       # reference: 100 (mono init gate)
    init_window_px: float = 100.0
    init_check_rotation: bool = False
    min_track_matches: int = 20
    min_inliers_ok: int = 15         # below -> RECENTLY_LOST
    local_points_cap: int = 2048     # padded local-map candidate set
    proj_radius: float = 15.0        # motion-model search window (px)
    proj_radius_wide: float = 30.0
    local_radius: float = 8.0
    kf_ref_ratio: float = 0.9        # reference thRefRatio (mono)
    kf_max_interval: int = 10        # frames; reference mMaxFrames ~ fps
    kf_min_inliers: int = 15
    max_mp_dist: int = 100           # TH_HIGH descriptor gate
    n_levels: int = 8                # ORBextractor.nLevels
    scale_factor: float = 1.2        # ORBextractor.scaleFactor
    ini_th_fast: float = 20.0        # ORBextractor.iniThFAST
    min_th_fast: float = 7.0         # ORBextractor.minThFAST
    # thFarPoints: stereo / RGB-D depths beyond this (m) are dropped; 0 = off
    th_far_points: float = 0.0
    recently_lost_frames: int = 20   # ~1 s at 20 fps
    imu_samples_per_frame: int = 128  # most IMU samples integrated a frame
    # stereo / RGB-D (mbf, the close/far split mThDepth)
    bf: float = 0.0                  # baseline * fx (px m); 0 = mono
    stereo_min_z: float = 0.1        # closest admissible stereo depth (m)
    th_depth: float = 35.0           # close-point threshold, in baselines
    stereo_init_min_points: int = 100  # StereoInitialization gate (ref: 500)
    # a non-rectified fisheye pair: depth by two-view triangulation with
    # these extrinsics, no virtual right coordinates (bf = 0)
    fisheye_stereo: bool = False
    camera2: object = None           # right camera model (default: the left)
    stereo_R_rl: object = None       # (3,3) right <- left rotation
    stereo_t_rl: object = None       # (3,)
    baseline_m: float = 0.0          # metric baseline (the close-point gate)
    # a raw pinhole pair: `vision.rectify.RectifyMaps`, applied on the
    # device before extraction
    rectify: object = None


@dataclasses.dataclass
class FrameRecord:
    ts: float
    ref_kf_uid: int  # stable keyframe id (slots are reused after culling)
    Tcr_R: np.ndarray  # pose relative to the reference keyframe: Tcw * Twr
    Tcr_t: np.ndarray
    state: TrackingState
    # inlier observations at track time, for the export-time pose polish;
    # None for init frames
    obs_mp: Optional[np.ndarray] = None    # (M,) int32 point slots
    obs_uid: Optional[np.ndarray] = None   # (M,) int64 stable point uids
    obs_uv: Optional[np.ndarray] = None    # (M,2) float32
    obs_oct: Optional[np.ndarray] = None   # (M,) int8


def _host(feats: FrameFeatures) -> dict:
    """numpy copies of a frame's fields; descriptors as uint32 words."""
    out = {f.name: getattr(feats, f.name).cpu().numpy()
           for f in dataclasses.fields(FrameFeatures)}
    out["desc"] = out["desc"].view(np.uint32)
    return out


class Tracker:
    """One tracking lane."""

    def __init__(self, camera, slam_map: MapState, cfg: TrackerConfig = None,
                 client_id: int = 0, local_mapper=None, relocalizer=None,
                 imu_calib=None, device=None,
                 sample_fn: Callable | None = None):
        cfg = cfg or TrackerConfig()
        self.device = device_policy.resolve(device)
        self.camera = camera.to(self.device)
        self.map = slam_map
        self.cfg = cfg
        self.client_id = client_id
        self.local_mapper = local_mapper
        # callable(feats) -> (R_cw, t_cw, mp_ids, ref_kf) | None: BoW
        # relocalization against the shared map
        self.relocalizer = relocalizer
        # the vocabulary's word function for the TrackReferenceKeyFrame
        # fallback (set by Slam with a vocabulary): (N,8) words -> (N,) ids
        self.bow_fn = None
        self.bow_k = 8                      # the vocabulary's branching factor
        self._ref_words_cache = None        # (kf uid, words)
        # localization mode: track and relocalize against a frozen map, no
        # keyframes
        self.only_tracking = False
        # two-view RANSAC samples: sample_fn(frame_id, mask (N,) bool numpy)
        # -> (200, 8) indices; None draws them from a generator seeded with
        # the frame id, as the reference seeds its key
        self.sample_fn = sample_fn
        # visual-inertial state: the calibration, the sample queue, the
        # preintegration last frame -> this frame and the windows since the
        # last keyframe, the marginalization prior on the last frame, the
        # per-frame bias estimate and the world body velocity
        self.imu_calib = None if imu_calib is None else imu_calib.to(self.device)
        self._cam_from_body = None if imu_calib is None else imu_init.cam_from_body(imu_calib)
        self._imu_queue: list[tuple[float, np.ndarray, np.ndarray]] = []
        self._pre_cur = None
        self._pre_frames: list = []
        # whether `_pre_frames` start at `ref_kf`: False from a
        # relocalization until this tracker's next keyframe
        self._pre_from_ref = True
        self._imu_prior = None
        # the VI pose solve's and the retry ladder's CUDA graphs and their
        # buffers, this tracker's own
        self._vi_graphs = PoseInertialGraphs()
        self._pose_graphs = TrackPoseGraphs()
        self._frame_bias: Optional[np.ndarray] = None
        self._vel_w: Optional[np.ndarray] = None
        self._map_change_seen = -1
        self._gauge_seen = slam_map.gauge_epoch
        # the current frame's stereo / RGB-D depth and right coordinate
        # (host numpy, set by process_stereo / process_rgbd)
        self._cur_depth: Optional[np.ndarray] = None
        self._cur_uright: Optional[np.ndarray] = None
        self._rectify = None if cfg.rectify is None else cfg.rectify.to(self.device)
        self.state = TrackingState.NO_IMAGES_YET
        self.reset_request = None
        self._init_feats: Optional[FrameFeatures] = None
        self._init_ts: float = 0.0
        self.R_cw = np.eye(3, dtype=np.float32)
        self.t_cw = np.zeros(3, np.float32)
        self._vel_R = np.eye(3, dtype=np.float32)  # Tcw_k * Tcw_{k-1}^-1
        self._vel_t = np.zeros(3, np.float32)
        self._last_ts: Optional[float] = None
        self.ref_kf: int = -1
        self._ref_uid: int = -1
        self.frame_id = 0
        self._frames_since_kf = 0
        self._lost_count = 0
        self.trajectory: list[FrameRecord] = []
        self.n_inliers = 0
        self._cur_obs = None

    def _set_ref_kf(self, k: int):
        self.ref_kf = k
        self._ref_uid = int(self.map.kf_uid[k]) if k >= 0 else -1

    # ------------------------------------------------------------------ imu
    def queue_imu(self, samples):
        """`Tracking::GrabImuData`: (ts_seconds, gyro(3,), acc(3,)) tuples,
        in timestamp order."""
        for ts, gyro, acc in samples:
            self._imu_queue.append((float(ts), np.asarray(gyro, np.float32),
                                    np.asarray(acc, np.float32)))

    def _current_bias(self) -> np.ndarray:
        if self._frame_bias is not None:
            return self._frame_bias.copy()
        if self.ref_kf >= 0 and self.map.kf_valid[self.ref_kf]:
            return self.map.kf_bias[self.ref_kf].copy()
        return np.zeros(6, np.float32)

    def _preintegrate_to(self, ts: float):
        """`Tracking::PreintegrateIMU`: integrate the queued samples in
        (last frame's ts, ts] on the device, the first
        `imu_samples_per_frame` of them (counter `track.imu_truncated`: the
        samples cut beyond)."""
        if self.imu_calib is None or self._last_ts is None:
            return None
        t0, t1 = self._last_ts, ts
        take = [q for q in self._imu_queue if t0 < q[0] <= t1 + 1e-6]
        self._imu_queue = [q for q in self._imu_queue if q[0] > t1 + 1e-6]
        cap = self.cfg.imu_samples_per_frame
        if len(take) > cap:
            timing.count("track.imu_truncated", len(take) - cap)
            take = take[:cap]
        if not take:
            return None
        stamps = np.asarray([t0] + [q[0] for q in take])
        dt = np.maximum(np.diff(stamps), 0.0).astype(np.float32)
        return preint.preintegrate(
            self._t(np.stack([q[2] for q in take])), self._t(np.stack([q[1] for q in take])),
            dt, self._t(self._current_bias()), self.imu_calib)

    def _body_pose(self, R_cw, t_cw):
        Rcb, tcb = self._cam_from_body
        return R_cw.T @ Rcb, R_cw.T @ (tcb - t_cw), Rcb, tcb

    def _predict_pose_imu(self):
        """`Tracking::PredictStateIMU`: propagate the last frame's body state
        through this frame's preintegration (gravity is -z once the map is
        inertial). Returns (R_cw, t_cw, velocity) or None."""
        if (self._pre_cur is None or self._vel_w is None
                or not self.map.imu_initialized):
            return None
        dR, dV, dP, dT = (x.cpu().numpy() for x in preint.corrected_deltas(
            self._pre_cur, self._t(self._current_bias())))
        dT = float(dT)
        if dT <= 1e-6:
            return None
        g = np.array([0.0, 0.0, -preint.GRAVITY], np.float32)
        Rwb1, twb1, Rcb, tcb = self._body_pose(self.R_cw, self.t_cw)
        Rwb2 = Rwb1 @ dR
        twb2 = twb1 + self._vel_w * dT + 0.5 * g * dT * dT + Rwb1 @ dP
        v2 = self._vel_w + g * dT + Rwb1 @ dV
        R_cw = Rcb @ Rwb2.T
        t_cw = -R_cw @ twb2 + tcb
        return (R_cw.astype(np.float32), t_cw.astype(np.float32),
                v2.astype(np.float32))

    def _update_velocity(self, R_prev, t_prev, dt: float):
        """Body velocity at this frame from the last frame's pose and this
        one's. On an inertial map with the frame's preintegration over the
        same interval, the velocity the two poses and the IMU agree on:
        v1 = (p2 - p1 - g dt^2 / 2 - R1 dP) / dt, v2 = v1 + g dt + R1 dV
        (a finite difference is the mean velocity over the interval, off by
        whatever the motion shook within it); else the finite difference."""
        if self.imu_calib is None or dt <= 1e-6:
            return
        Rwb_prev, twb_prev, _, _ = self._body_pose(R_prev, t_prev)
        _, twb_cur, _, _ = self._body_pose(self.R_cw, self.t_cw)
        pre = self._pre_cur
        if (self.map.imu_initialized and pre is not None
                and abs(float(pre.dT) - dt) < IMU_VELOCITY_DT_SLACK_S):
            _, dV, dP, _ = (x.cpu().numpy() for x in preint.corrected_deltas(
                pre, self._t(self._current_bias())))
            g = np.array([0.0, 0.0, -preint.GRAVITY])
            v_prev = (twb_cur - twb_prev - 0.5 * g * dt * dt - Rwb_prev @ dP) / dt
            self._vel_w = (v_prev + g * dt + Rwb_prev @ dV).astype(np.float32)
        else:
            self._vel_w = ((twb_cur - twb_prev) / dt).astype(np.float32)

    # ------------------------------------------------------------------ api
    def _extract(self, img) -> FrameFeatures:
        cfg = self.cfg
        return extract_features(img, n_features=cfg.n_features,
                                n_levels=cfg.n_levels, scale=cfg.scale_factor,
                                ini_th=cfg.ini_th_fast, min_th=cfg.min_th_fast,
                                device=self.device)

    def process_image(self, img, ts: float):
        with timing.stage("track.extract"):
            feats = self._extract(img)
        return self.process_features(feats, ts)

    def _gate_far_points(self):
        """thFarPoints: drop stereo / RGB-D depths beyond the configured
        range (far disparities are noise)."""
        th = self.cfg.th_far_points
        if th <= 0 or self._cur_depth is None:
            return
        far = self._cur_depth > th
        self._cur_depth = np.where(far, 0.0, self._cur_depth)
        if self._cur_uright is not None:
            self._cur_uright = np.where(far, -1.0, self._cur_uright)

    def _process_with_depth(self, feats: FrameFeatures, ts: float):
        """`process_features` with this frame's depths, then forget them."""
        self._gate_far_points()
        try:
            return self.process_features(feats, ts)
        finally:
            self._cur_depth = None
            self._cur_uright = None

    def process_stereo(self, img_left, img_right, ts: float):
        """Stereo entry (GrabImageStereo): rectify a raw pinhole pair on the
        device, extract both images, and give each left feature a depth:
        by the row-band matcher on a rectified pair, by two-view
        triangulation on a fisheye pair."""
        cfg = self.cfg
        with timing.stage("track.extract"):
            if self._rectify is not None:
                img_left, img_right = self._rectify(img_left, img_right)
            featsL = self._extract(img_left)
            featsR = self._extract(img_right)
        with timing.stage("track.stereo_match"):
            if cfg.fisheye_stereo:
                cam2 = self.camera if cfg.camera2 is None else cfg.camera2.to(self.device)
                depth, good, _ = stereo_m.fisheye_stereo_match(
                    featsL.uv, featsL.desc, featsL.valid, featsR.uv, featsR.desc,
                    featsR.valid, self.camera, cam2, self._t(cfg.stereo_R_rl, torch.float32),
                    self._t(cfg.stereo_t_rl, torch.float32))
                self._cur_depth = np.where(good.cpu().numpy(), depth.cpu().numpy(), 0.0)
                self._cur_uright = None  # no virtual right coordinates
            else:
                u_r, depth, _ = stereo_m.stereo_match(
                    featsL.uv, featsL.desc, featsL.octave, featsL.valid,
                    featsR.uv, featsR.desc, featsR.octave, featsR.valid,
                    cfg.bf, cfg.stereo_min_z, cfg.bf / max(cfg.stereo_min_z, 1e-6))
                self._cur_depth = depth.cpu().numpy()
                self._cur_uright = u_r.cpu().numpy()
        return self._process_with_depth(featsL, ts)

    def process_rgbd(self, img, depth_map, ts: float, depth_factor: float = 1.0):
        """RGB-D entry (GrabImageRGBD): the registered depth map (H, W),
        scaled by `depth_factor` to metres, read at the keypoints, and the
        virtual right coordinate u - bf / z for the stereo rows."""
        with timing.stage("track.extract"):
            feats = self._extract(img)
        if isinstance(depth_map, torch.Tensor):
            depth_map = depth_map.to(self.device, torch.float32)
        else:  # uint16 (TUM's PNG) and float maps alike, exactly in f32
            depth_map = self._t(np.asarray(depth_map, np.float32))
        u_r, depth, _ = stereo_m.depth_from_rgbd(feats.uv, feats.valid, depth_map,
                                                 self.cfg.bf, depth_factor)
        self._cur_depth = depth.cpu().numpy()
        self._cur_uright = u_r.cpu().numpy()
        return self._process_with_depth(feats, ts)

    def process_features(self, feats: FrameFeatures, ts: float):
        """Main entry (GrabImageMonocular). Returns the world->camera pose
        (R, t) or None while uninitialized or lost."""
        feats = FrameFeatures(**{f.name: getattr(feats, f.name).to(self.device)
                                 for f in dataclasses.fields(FrameFeatures)})
        self.frame_id += 1
        self._cur_obs = None
        # timestamp-jump guards: a backwards jump flushes the IMU queue and
        # respawns the map; a forward gap over 1 s on an inertial map resets
        # a young map and respawns an initialized one
        self.reset_request = None
        if self._last_ts is not None and self.state in (
                TrackingState.OK, TrackingState.RECENTLY_LOST):
            if ts < self._last_ts - 1e-9:
                self._imu_queue = []
                self.reset_request = 'new_map'
            elif self.imu_calib is not None and ts - self._last_ts > 1.0:
                self.reset_request = ('new_map' if self.map.imu_initialized
                                      else 'reset_map')
        with timing.stage("track.imu_integrate"):
            self._pre_cur = self._preintegrate_to(ts)
        if self._pre_cur is not None:
            self._pre_frames.append(self._pre_cur)
        if self.state in (TrackingState.NO_IMAGES_YET, TrackingState.NOT_INITIALIZED):
            # secondary clients on a mature shared map, and any tracker in
            # localization mode, relocalize instead of initializing
            if ((self.client_id != 0 or self.only_tracking)
                    and self.relocalizer is not None and self.map.n_keyframes >= 5):
                if self._try_relocalize(feats):
                    self.state = TrackingState.OK
            elif self._cur_depth is not None:
                self._stereo_initialization(feats, ts)
            else:
                self._monocular_initialization(feats, ts)
        elif self.state in (TrackingState.OK, TrackingState.RECENTLY_LOST):
            ok = self._track_frame(feats, ts)
            if not ok and self.relocalizer is not None:
                ok = self._try_relocalize(feats)  # recently lost: relocalize
            if ok:
                self.state = TrackingState.OK
                self._lost_count = 0
            else:
                self._lost_count += 1
                # an inertial map holds the pose by IMU dead reckoning while
                # recently lost (client 0 only, as the reference)
                if (self._lost_count <= self.cfg.recently_lost_frames
                        and self.client_id == 0):
                    pred = self._predict_pose_imu()
                    if pred is not None:
                        self.R_cw, self.t_cw, self._vel_w = pred
                self.state = (TrackingState.RECENTLY_LOST
                              if self._lost_count <= self.cfg.recently_lost_frames
                              else TrackingState.LOST)
        elif self.state == TrackingState.LOST and self.only_tracking:
            # a frozen map spawns nothing: keep trying to relocalize
            if self.relocalizer is not None and self._try_relocalize(feats):
                self.state = TrackingState.OK
        self._last_ts = ts
        self._record_pose(ts)
        if self.state in (TrackingState.OK, TrackingState.RECENTLY_LOST):
            return self.R_cw.copy(), self.t_cw.copy()
        return None

    # --------------------------------------------------------- initialization
    def _ransac_samples(self, ok: torch.Tensor):
        if self.sample_fn is None:
            return None
        return torch.from_numpy(np.array(self.sample_fn(self.frame_id, ok.cpu().numpy())))

    def _stereo_initialization(self, feats: FrameFeatures, ts: float):
        """StereoInitialization: the first frame with enough stereo / RGB-D
        depths becomes a keyframe at the origin, its points unprojected
        from the depths (no two-view RANSAC)."""
        f = _host(feats)
        depth = self._cur_depth
        has_d = f["valid"] & (depth > 0)
        if int(has_d.sum()) < self.cfg.stereo_init_min_points:
            return
        rays = self.camera.unproject(feats.uv).cpu().numpy()  # z = 1
        pts = rays * depth[:, None]
        sel = np.nonzero(has_d)[0]
        # first_kf is set below, once the keyframe has its slot
        ids = self.map.add_points(pos=pts[sel].astype(np.float32),
                                  desc=f["desc"][sel], first_kf=0)
        obs = np.full(feats.capacity, -1, np.int32)
        good = ids >= 0
        obs[sel[good]] = ids[good]
        k0 = self.map.add_keyframe(
            np.eye(3, dtype=np.float32), np.zeros(3, np.float32), ts, self.frame_id,
            f["uv"], f["octave"], f["angle"], f["desc"], f["valid"], obs,
            uright=self._cur_uright)
        if k0 < 0:
            # at keyframe capacity: take the points back
            if good.any():
                self.map.remove_points(ids[good])
            return
        self.map.mp_first_kf[ids[good]] = k0
        self.map.mp_ref_kf[ids[good]] = k0
        self.R_cw = np.eye(3, dtype=np.float32)
        self.t_cw = np.zeros(3, np.float32)
        self._set_ref_kf(k0)
        self._update_mp_stats_after_insert(ids[good])
        self._vel_R = np.eye(3, dtype=np.float32)
        self._vel_t = np.zeros(3, np.float32)
        self._pre_frames = []  # the inertial chain starts at this keyframe
        self._pre_from_ref = True
        self.state = TrackingState.OK
        self._frames_since_kf = 0

    def _monocular_initialization(self, feats: FrameFeatures, ts: float):
        cfg = self.cfg
        if self._init_feats is None:
            if int(feats.valid.sum()) >= cfg.init_min_matches:
                self._init_feats = feats
                self._init_ts = ts
                self._pre_frames = []  # preintegrate from the init reference
            self.state = TrackingState.NOT_INITIALIZED
            return

        ref = self._init_feats
        idx, _dist, ok, n = matcher.search_for_initialization(
            ref.uv, ref.desc, ref.valid, feats.uv, feats.desc, feats.valid,
            radius=cfg.init_window_px, ang1=ref.angle, ang2=feats.angle,
            check_rotation=cfg.init_check_rotation)
        if int(n) < cfg.init_min_matches:
            # reference: replace the reference frame and retry
            self._init_feats = feats
            self._init_ts = ts
            self._pre_frames = []
            return

        x_ref = self.camera.unproject(ref.uv)[:, :2]
        x_cur = self.camera.unproject(feats.uv)[:, :2][idx.long()]
        focal = float(self.camera.params[0])
        gen = torch.Generator(device=self.device).manual_seed(self.frame_id)
        res = reconstruct_two_views(
            x_ref, x_cur, ok, torch.tensor((1.0 / focal) ** 2, dtype=torch.float32,
                                           device=self.device),
            generator=gen, samples=self._ransac_samples(ok))
        if not bool(res.success):
            return

        inl = res.inliers.cpu().numpy()
        pts = res.points.cpu().numpy()
        # median-depth normalization (CreateInitialMapMonocular)
        med = float(np.median(pts[inl, 2]))
        if med <= 0:
            return
        pts = pts / med
        R2 = res.R.cpu().numpy()
        t2 = res.t.cpu().numpy() / med

        # the initial map: KF0 at identity, KF1 at (R2, t2)
        ref_np, cur_np = _host(ref), _host(feats)
        obs0 = np.full(ref.capacity, -1, np.int32)
        obs1 = np.full(feats.capacity, -1, np.int32)
        idx_np = idx.cpu().numpy()
        ids = self.map.add_points(pos=pts[inl].astype(np.float32),
                                  desc=cur_np["desc"][idx_np[inl]], first_kf=0)
        sel = np.nonzero(inl)[0]
        good = ids >= 0
        obs0[sel[good]] = ids[good]
        obs1[idx_np[sel[good]]] = ids[good]
        k0 = self.map.add_keyframe(
            np.eye(3, dtype=np.float32), np.zeros(3, np.float32), self._init_ts,
            self.frame_id - 1, ref_np["uv"], ref_np["octave"], ref_np["angle"],
            ref_np["desc"], ref_np["valid"], obs0)
        pre_init = None
        if self.imu_calib is not None and self._pre_frames:
            pre_init = preint.merge_all(self._pre_frames)
        self._pre_frames = []
        self._pre_from_ref = True
        k1 = self.map.add_keyframe(
            R2, t2, ts, self.frame_id, cur_np["uv"], cur_np["octave"],
            cur_np["angle"], cur_np["desc"], cur_np["valid"], obs1, prev_kf=k0,
            preint=pre_init)
        if k0 < 0 or k1 < 0:
            return
        self._update_mp_stats_after_insert(ids[good])

        # init BA over the two keyframes (GlobalBundleAdjustemnt(20))
        if self.local_mapper is not None:
            self.local_mapper.initial_ba(k0, k1)

        self.R_cw = self.map.kf_R[k1].copy()
        self.t_cw = self.map.kf_t[k1].copy()
        self._set_ref_kf(k1)
        self._vel_R = np.eye(3, dtype=np.float32)
        self._vel_t = np.zeros(3, np.float32)
        self.state = TrackingState.OK
        self._frames_since_kf = 0

    # --------------------------------------------------------------- tracking
    def _local_map_points(self) -> np.ndarray:
        """Candidate map points of the local keyframe set: the reference
        KF, its covisible neighbours, their neighbours, and temporal-chain
        parents (UpdateLocalKeyFrames + UpdateLocalPoints)."""
        m = self.map
        k1 = [self.ref_kf] + [int(x) for x in
                              m.covisibility(self.ref_kf, min_shared=10)[:10]]
        local = list(dict.fromkeys(k1))
        for kf in k1[:5]:
            for nb in m.covisibility(kf, min_shared=15)[:5]:
                nb = int(nb)
                if nb not in local:
                    local.append(nb)
            p = int(m.kf_prev[kf])
            if p >= 0 and m.kf_valid[p] and p not in local:
                local.append(p)
            if len(local) >= 20:
                break
        obs = m.kf_obs_mp[local]
        ids = np.unique(obs[obs >= 0])
        return ids[m.mp_valid[ids]]

    def _t(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _sync_gauge(self, transform_pose: bool = True):
        """Re-express the cached motion state after the map was re-gauged
        (w' = s Rgw w; the reference's UpdateFrameIMU hand-off): without it
        the first frame after IMU initialization searches with an old-gauge
        prediction against a rescaled map."""
        m = self.map
        if m.gauge_epoch == self._gauge_seen:
            return
        bumps = m.gauge_epoch - self._gauge_seen
        self._gauge_seen = m.gauge_epoch
        self._imu_prior = None  # the prior's information is gauge-bound
        if bumps == 1 and m.last_gauge is not None:
            Rgw, s = m.last_gauge
            if transform_pose:
                self.R_cw = (self.R_cw @ Rgw.T).astype(np.float32)
                self.t_cw = (s * self.t_cw).astype(np.float32)
            self._vel_t = (s * self._vel_t).astype(np.float32)
            if self._vel_w is not None:
                self._vel_w = (s * (Rgw @ self._vel_w)).astype(np.float32)
        else:
            # several re-gauges since: adopt the reference keyframe's state
            if self.ref_kf >= 0 and m.kf_valid[self.ref_kf]:
                self._vel_w = m.kf_vel[self.ref_kf].copy()
                if transform_pose:
                    self.R_cw = m.kf_R[self.ref_kf].copy()
                    self.t_cw = m.kf_t[self.ref_kf].copy()
            self._vel_R = np.eye(3, dtype=np.float32)
            self._vel_t = np.zeros(3, np.float32)

    def _track_frame(self, feats: FrameFeatures, ts: float) -> bool:
        cfg = self.cfg
        m = self.map
        with m.lock:
            self._sync_gauge(transform_pose=True)
        # the reference KF may have been culled (its slot possibly reused):
        # fall back to the newest keyframe
        if (self.ref_kf < 0 or not m.kf_valid[self.ref_kf]
                or m.kf_uid[self.ref_kf] != self._ref_uid):
            ids = m.keyframe_ids()
            if len(ids) == 0:
                return False
            self._set_ref_kf(int(ids[np.argmax(m.kf_frame_id[ids])]))
        # the prediction: IMU propagation once the map is inertial, else
        # constant velocity
        pred_v = None
        pred = self._predict_pose_imu()
        if pred is not None:
            R_pred, t_pred, pred_v = pred
        else:
            R_pred = self._vel_R @ self.R_cw
            t_pred = self._vel_R @ self.t_cw + self._vel_t

        with timing.stage("track.local_map"), m.lock:
            local_ids = self._local_map_points()
            if len(local_ids) == 0:
                return False
            K = cfg.local_points_cap
            ids_p = np.full(K, 0, np.int32)
            valid_p = np.zeros(K, bool)
            n = min(len(local_ids), K)
            ids_p[:n] = local_ids[:n]
            valid_p[:n] = True
            mp_pos = self._t(m.mp_pos[ids_p])
            mp_words = self._t(words_to_int32(m.mp_desc[ids_p]))
            mp_normal = self._t(m.mp_normal[ids_p])
            mp_min_d = self._t(m.mp_min_dist[ids_p])
            mp_max_d = self._t(m.mp_max_dist[ids_p])
            valid_pt = self._t(valid_p)

        # the retry ladder (narrow -> wide -> recently-lost wide -> local
        # refinement) with its pose GN; K1 reads the packed words as stored.
        # On the card each attempt replays the tracker's graphs of its shape
        stereo = {}
        if self._cur_uright is not None and cfg.bf > 0:
            stereo = dict(u_right=self._t(self._cur_uright, torch.float32), bf=cfg.bf)
        with timing.stage("track.fused_pose"):
            success, res = fused_track_pose(
                mp_pos, mp_words, valid_pt, mp_normal, mp_min_d, mp_max_d,
                self.camera, feats.uv, feats.desc, feats.octave, feats.valid,
                self._t(R_pred), self._t(t_pred), self._t(self.R_cw), self._t(self.t_cw),
                self.state == TrackingState.RECENTLY_LOST,
                [cfg.proj_radius, cfg.proj_radius_wide, cfg.proj_radius_wide * 2,
                 cfg.local_radius],
                cfg.min_track_matches, cfg.min_inliers_ok, max_dist=cfg.max_mp_dist,
                device=self.device, graphs=self._pose_graphs, **stereo)
            if not success:
                # TrackReferenceKeyFrame: the prediction is too far off for
                # any projection window; match the reference keyframe by
                # vocabulary buckets (pose-free), then search the local map
                # from there with the narrow window only
                rec = self._track_reference_keyframe_bow(feats)
                if rec is None:
                    return False
                success, res = fused_track_pose(
                    mp_pos, mp_words, valid_pt, mp_normal, mp_min_d, mp_max_d,
                    self.camera, feats.uv, feats.desc, feats.octave, feats.valid,
                    self._t(rec[0]), self._t(rec[1]), self._t(rec[0]), self._t(rec[1]),
                    False, [cfg.proj_radius, cfg.proj_radius, cfg.proj_radius,
                            cfg.local_radius],
                    cfg.min_track_matches, cfg.min_inliers_ok, max_dist=cfg.max_mp_dist,
                    device=self.device, graphs=self._pose_graphs, **stereo)
                if not success:
                    return False
            res = {k: v.cpu().numpy() for k, v in res.items()}
        R1 = res["R"].astype(np.float32)
        t1 = res["t"].astype(np.float32)
        mask = res["vsel"]
        sel = res["sel"][mask]          # candidate-set indices
        fsel = res["fidx"][mask]        # frame feature indices
        inliers = res["inl"][mask]
        uv_sel = res["uv"][mask]
        oct_sel = res["oct"][mask]
        n_in = int(res["n_in"])
        frustum = res["fr"]
        if n_in < cfg.min_inliers_ok:
            return False

        # visual-inertial pose refinement once the map is inertial (the
        # reference replaces PoseOptimization by PoseInertialOptimization*)
        vi = self._optimize_pose_vi(R1, t1, ids_p, sel, uv_sel, oct_sel, feats.capacity)
        vi_ok = False
        if vi is not None:
            R_vi, t_vi, inliers_vi, n_in_vi, vi_prior, vi_v, vi_bias = vi
            if n_in_vi >= cfg.min_inliers_ok:
                # velocity, bias and prior are committed with the pose
                R1, t1, inliers, n_in = R_vi, t_vi, inliers_vi, n_in_vi
                self._imu_prior, self._vel_w, self._frame_bias = vi_prior, vi_v, vi_bias
                vi_ok = True
        if not vi_ok and self.imu_calib is not None:
            # the prior would now point two frames back: re-anchor the next
            # solve at the reference keyframe
            self._imu_prior = None
            self._frame_bias = None

        # per-feature map-point assignment for KF creation
        mp_ids = np.full(feats.capacity, -1, np.int32)
        inliers = inliers[:len(sel)].astype(bool)
        good = sel[inliers]
        mp_ids[fsel[inliers]] = ids_p[good]
        # the inlier observations, for the export-time polish
        self._cur_obs = (ids_p[good].astype(np.int32), m.mp_uid[ids_p[good]].copy(),
                         uv_sel[inliers].astype(np.float32),
                         oct_sel[inliers].astype(np.int8))
        # found/visible counters: `visible` counts in-frustum points only
        m.mp_visible[ids_p[np.nonzero(frustum)[0]]] += 1
        m.mp_found[ids_p[good]] += 1

        # velocity model update
        R_prev, t_prev = self.R_cw.copy(), self.t_cw.copy()
        self._vel_R = (R1 @ self.R_cw.T).astype(np.float32)
        self._vel_t = (t1 - self._vel_R @ self.t_cw).astype(np.float32)
        self.R_cw, self.t_cw = R1.astype(np.float32), t1.astype(np.float32)
        # the body velocity: the VI solve's, else the IMU-propagated one,
        # else a finite difference over the last frame
        if self.imu_calib is not None and self._last_ts is not None and not vi_ok:
            if pred_v is not None:
                self._vel_w = np.asarray(pred_v, np.float32)
            else:
                self._update_velocity(R_prev, t_prev, ts - self._last_ts)
        self.n_inliers = n_in
        self._frames_since_kf += 1

        if self._need_new_keyframe(n_in, ts):
            with timing.stage("track.new_kf"):
                self._create_keyframe(feats, ts, mp_ids)
        return True

    def _optimize_pose_vi(self, R1, t1, ids_p, sel, uv_sel, oct_sel, cap: int):
        """VI pose refinement (PoseInertialOptimizationLastKeyFrame /
        LastFrame): anchored at the reference keyframe when the map changed
        since the last frame (its prior is stale), else at the last frame
        through the marginalization prior. On the card the solve replays a
        CUDA graph of the tracker's, one per shape, variant and camera kind,
        captured at its first solve (`PoseInertialGraphs`); on the CPU it
        runs eagerly. Returns (R_cw, t_cw, inliers, n_in, prior, velocity,
        bias), or None when it does not apply. It notes the map's change
        index and changes nothing else: the caller commits or drops the
        result."""
        m = self.map
        if (self.imu_calib is None or not m.imu_initialized
                or self._pre_cur is None or self._vel_w is None
                or self.ref_kf < 0 or not m.kf_valid[self.ref_kf]):
            return None
        map_updated = m.change_index != self._map_change_seen
        self._map_change_seen = m.change_index
        with m.lock:  # the anchor state and the landmarks together
            Rwb1, twb1, Rcb, tcb = self._body_pose(R1, t1)
            cur = BodyState(Rwb1, twb1, self._vel_w, self._current_bias())
            if not map_updated and self._imu_prior is not None:
                pre, prior, fixed = self._pre_cur, self._imu_prior, False
                anchor = None  # the prior's state
            else:
                if not self._pre_frames or not self._pre_from_ref:
                    return None
                pre, prior, fixed = preint.merge_all(self._pre_frames), None, True
                k = self.ref_kf
                Rwb_k, twb_k, _, _ = self._body_pose(m.kf_R[k], m.kf_t[k])
                anchor = BodyState(Rwb_k, twb_k, m.kf_vel[k].copy(), m.kf_bias[k].copy())
            n_sel = min(len(sel), cap)
            pts = np.zeros((cap, 3), np.float32)
            pts[:n_sel] = m.mp_pos[ids_p[sel[:n_sel]]]
        uv_obs = np.zeros((cap, 2), np.float32)
        info = np.ones(cap, np.float32)
        valid = np.zeros(cap, bool)
        uv_obs[:n_sel] = uv_sel[:n_sel]
        info[:n_sel] = 1.0 / (1.2 ** (2 * oct_sel[:n_sel]))
        valid[:n_sel] = True
        with timing.stage("track.vi_pose"):
            if self.device.type == "cuda":
                out, inl, n_in, new_prior = self._vi_graphs.solve(
                    cur, pre, self.imu_calib, self.camera, pts, uv_obs, info, valid,
                    anchor=anchor, prior=prior, anchor_fixed=fixed)
            else:
                def on_device(s):
                    return BodyState(*(self._t(x, torch.float32) for x in s))
                out, inl, n_in, new_prior = optimize_pose_inertial(
                    prior.state if prior is not None else on_device(anchor), on_device(cur),
                    pre, self.imu_calib, self._t(pts), self._t(uv_obs), self._t(info),
                    self._t(valid), self.camera, prior=prior, anchor_fixed=fixed)
                out = BodyState(*(x.cpu().numpy() for x in out))
                inl = inl.cpu().numpy()
        Rwb2, p2, v2, b2 = out
        if not all(np.isfinite(x).all() for x in (Rwb2, p2, v2, b2)):
            return None
        R_cw = (Rcb @ Rwb2.T).astype(np.float32)
        t_cw = (-R_cw @ p2 + tcb).astype(np.float32)
        return (R_cw, t_cw, inl[:len(sel)], int(n_in), new_prior,
                v2.astype(np.float32), b2.astype(np.float32))

    def _track_reference_keyframe_bow(self, feats: FrameFeatures):
        """TrackReferenceKeyFrame: match the frame to the reference keyframe
        by vocabulary buckets (`search_by_bow`, pose-free), then optimize the
        pose from the last one. Returns (R_cw, t_cw), or None below 15
        matches or 10 inliers."""
        if self.bow_fn is None or self.ref_kf < 0:
            return None
        m = self.map
        with m.lock:
            k = self.ref_kf
            if not m.kf_valid[k]:
                return None
            kf_desc = m.kf_desc[k].copy()
            kf_angle = m.kf_angle[k].copy()
            kf_obs = m.kf_obs_mp[k].copy()
            has_mp = (kf_obs >= 0) & m.kf_feat_valid[k]
            has_mp &= np.where(kf_obs >= 0, m.mp_valid[np.maximum(kf_obs, 0)], False)
            mp_pos_kf = m.mp_pos[np.maximum(kf_obs, 0)].copy()
        uid = int(m.kf_uid[k])
        if self._ref_words_cache is not None and self._ref_words_cache[0] == uid:
            words_kf = self._ref_words_cache[1]
        else:
            words_kf = self.bow_fn(kf_desc)
            self._ref_words_cache = (uid, words_kf)
        with timing.stage("track.bow"):
            idx, _, ok, nm = matcher.search_by_bow(
                words_kf, self._t(words_to_int32(kf_desc)), self._t(has_mp),
                self._t(kf_angle), self.bow_fn(feats.desc), feats.desc, feats.valid,
                feats.angle, k=self.bow_k)
        if int(nm) < 15:
            return None
        sel = np.nonzero(ok.cpu().numpy())[0]
        idx_np = idx.cpu().numpy()
        cap = feats.capacity
        n_sel = min(len(sel), cap)
        pts = np.zeros((cap, 3), np.float32)
        uv_obs = np.zeros((cap, 2), np.float32)
        info = np.ones(cap, np.float32)
        valid_sel = np.zeros(cap, bool)
        f_idx = idx_np[sel[:n_sel]]
        pts[:n_sel] = mp_pos_kf[sel[:n_sel]]
        uv_obs[:n_sel] = feats.uv.cpu().numpy()[f_idx]
        info[:n_sel] = 1.0 / (1.2 ** (2 * feats.octave.cpu().numpy()[f_idx]))
        valid_sel[:n_sel] = True
        R, t, _, n_in = optimize_pose(
            self._t(self.R_cw), self._t(self.t_cw), self._t(pts), self._t(uv_obs),
            self._t(info), self._t(valid_sel), self.camera, device=self.device)
        if int(n_in) < 10:
            return None
        return R.cpu().numpy(), t.cpu().numpy()

    def _try_relocalize(self, feats: FrameFeatures) -> bool:
        with timing.stage("track.relocalize"):
            out = self.relocalizer(feats)
        if out is None:
            return False
        R, t, _mp_ids, ref_kf = out
        self._imu_prior = None   # stale after a relocalization jump
        self._frame_bias = None
        self.R_cw = np.asarray(R, np.float32).copy()
        self.t_cw = np.asarray(t, np.float32).copy()
        self._vel_R = np.eye(3, dtype=np.float32)
        self._vel_t = np.zeros(3, np.float32)
        self._set_ref_kf(int(ref_kf))
        self._lost_count = 0
        if self.imu_calib is not None:
            # the samples so far do not start at the new reference keyframe,
            # and the velocity belongs to the frames before the jump: track
            # visually (as ORB-SLAM3 for mnFramesToResetIMU frames) until a
            # keyframe of this tracker, with no inertial link into it
            self._pre_frames = []
            self._pre_from_ref = False
            self._vel_w = None
        return True

    def _need_new_keyframe(self, n_in: int, ts: float = None) -> bool:
        """NeedNewKeyFrame: the weakness test counts the reference KF's
        well-observed points (observed by >= 3 keyframes, 2 while the map
        has <= 2). An inertial map also takes a keyframe every 0.25 s before
        IMU initialization and every 0.5 s after, so the preintegration
        windows stay short."""
        cfg = self.cfg
        if self.only_tracking or self.ref_kf < 0:
            return False
        m = self.map
        with m.lock:  # the observation counts and the ref KF's row together
            obs_ref = m.kf_obs_mp[self.ref_kf]
            mp = obs_ref[obs_ref >= 0]
            mp = mp[m.mp_valid[mp]]
            min_obs = 3 if m.n_keyframes > 2 else 2
            ref_tracked = int((m.obs_counts()[mp] >= min_obs).sum())
            imu_due = False
            if self.imu_calib is not None and ts is not None and m.kf_valid[self.ref_kf]:
                gap = ts - float(m.kf_ts[self.ref_kf])
                imu_due = gap >= (0.25 if not m.imu_initialized else 0.5)
        if n_in < cfg.kf_min_inliers:
            return False
        weak = n_in < cfg.kf_ref_ratio * ref_tracked
        stale = self._frames_since_kf >= cfg.kf_max_interval
        return weak or stale or imu_due

    def _create_keyframe(self, feats: FrameFeatures, ts: float, mp_ids: np.ndarray):
        with self.map.lock:
            f = _host(feats)
            # the per-frame windows since the last keyframe become one
            # KF->KF inertial edge (mpImuPreintegratedFromLastKF)
            pre_kf = None
            if self.imu_calib is not None and self._pre_frames and self._pre_from_ref:
                pre_kf = preint.merge_all(self._pre_frames)
            self._pre_frames = []
            self._pre_from_ref = True
            k = self.map.add_keyframe(
                self.R_cw, self.t_cw, ts, self.frame_id, f["uv"], f["octave"],
                f["angle"], f["desc"], f["valid"], mp_ids.copy(),
                prev_kf=self.ref_kf, vel=self._vel_w,
                bias=self._current_bias() if self.imu_calib is not None else None,
                preint=pre_kf, uright=self._cur_uright)
            if k < 0:
                return  # map at keyframe capacity; keep tracking without a KF
            if self._cur_depth is not None and (self.cfg.bf > 0 or self.cfg.fisheye_stereo):
                self._spawn_close_points(k, feats, f, mp_ids)
            self._update_mp_stats_after_insert(mp_ids[mp_ids >= 0])
            self._set_ref_kf(k)
            self._frames_since_kf = 0
            if self.local_mapper is not None:
                self.local_mapper.process_keyframe(k)
                # adopt the possibly updated pose
                self.R_cw = self.map.kf_R[k].copy()
                self.t_cw = self.map.kf_t[k].copy()
                if self.map.gauge_epoch != self._gauge_seen:
                    # the mapper re-gauged the map (IMU init, scale
                    # refinement): the adopted pose is already in the new
                    # gauge; take velocity and bias from the keyframe
                    self._sync_gauge(transform_pose=False)
                    if self.imu_calib is not None and self.map.kf_valid[k]:
                        self._vel_w = self.map.kf_vel[k].copy()
                        self._frame_bias = self.map.kf_bias[k].copy()
                    self._vel_R = np.eye(3, dtype=np.float32)
                    self._vel_t = np.zeros(3, np.float32)

    def _spawn_close_points(self, k: int, feats: FrameFeatures, f: dict,
                            mp_ids: np.ndarray):
        """CreateNewKeyFrame on stereo / RGB-D maps: each valid feature
        without a point whose depth is under th_depth baselines gets a new
        point, unprojected from its depth (`mp_ids` is updated in place)."""
        cfg = self.cfg
        if cfg.fisheye_stereo:
            close = cfg.baseline_m * cfg.th_depth
        else:
            close = cfg.bf / float(self.camera.params[0]) * cfg.th_depth
        depth = self._cur_depth
        sel = np.nonzero(f["valid"] & (mp_ids < 0) & (depth > 0) & (depth < close))[0]
        if len(sel) == 0:
            return
        xc = self.camera.unproject(feats.uv).cpu().numpy()[sel] * depth[sel, None]
        pw = xc @ self.R_cw + (-self.R_cw.T @ self.t_cw)
        ids = self.map.add_points(pos=pw.astype(np.float32), desc=f["desc"][sel],
                                  first_kf=k)
        ok = ids >= 0
        self.map.kf_obs_mp[k, sel[ok]] = ids[ok]
        mp_ids[sel[ok]] = ids[ok]

    def _update_mp_stats_after_insert(self, ids):
        ids = np.asarray(ids)
        ids = ids[ids >= 0]
        self.map.mp_visible[ids] += 1
        self.map.mp_found[ids] += 1
        # normals and scale bands of freshly created/observed points
        self.map.update_point_stats(ids)

    # ------------------------------------------------------------- trajectory
    def _record_pose(self, ts: float):
        if self.state not in (TrackingState.OK, TrackingState.RECENTLY_LOST):
            return
        if self.ref_kf < 0:
            return
        # Tcr = Tcw * Trw^-1 (relative to the reference KF)
        Rr, tr = self.map.kf_R[self.ref_kf], self.map.kf_t[self.ref_kf]
        R_rel = self.R_cw @ Rr.T
        t_rel = self.t_cw - R_rel @ tr
        obs = self._cur_obs
        self.trajectory.append(FrameRecord(
            ts=ts, ref_kf_uid=int(self.map.kf_uid[self.ref_kf]), Tcr_R=R_rel,
            Tcr_t=t_rel, state=self.state,
            obs_mp=None if obs is None else obs[0],
            obs_uid=None if obs is None else obs[1],
            obs_uv=None if obs is None else obs[2],
            obs_oct=None if obs is None else obs[3]))

    def export_trajectory(self) -> tuple[np.ndarray, np.ndarray]:
        """(T,) timestamps + (T,3) camera centers in the world frame,
        composing the logged relative poses with the current KF poses
        (SaveTrajectoryTUM). Records whose reference KF was culled walk the
        stored cull anchors until a live KF is found."""
        uid_to_slot = {int(self.map.kf_uid[k]): int(k)
                       for k in self.map.keyframe_ids()}
        anchors = self.map.culled_anchor
        ts, centers = [], []
        for rec in self.trajectory:
            R_cr, t_cr, uid, hops = rec.Tcr_R, rec.Tcr_t, rec.ref_kf_uid, 0
            while uid not in uid_to_slot and uid in anchors and hops < 64:
                p_uid, R_rp, t_rp = anchors[uid]
                R_cr, t_cr = R_cr @ R_rp, R_cr @ t_rp + t_cr
                uid = p_uid
                hops += 1
            slot = uid_to_slot.get(uid, -1)
            if slot < 0:
                continue
            Rr, tr = self.map.kf_R[slot], self.map.kf_t[slot]
            R = R_cr @ Rr
            t = R_cr @ tr + t_cr
            centers.append(-R.T @ t)
            ts.append(rec.ts)
        return np.asarray(ts), np.asarray(centers, np.float32)
