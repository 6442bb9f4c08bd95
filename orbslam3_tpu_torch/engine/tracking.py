"""Tracking front end: the per-frame state machine over the device stages.

Port of `orbslam3_tpu/engine/tracking.py` (ORB-SLAM3's `Tracking`), the
monocular path without an IMU. The host owns the state machine
(NOT_INITIALIZED / OK / RECENTLY_LOST / LOST); feature extraction,
projection search, pose optimization and two-view initialization run on
`device` (the card unless ``device="cpu"``):

- monocular initialization (`MonocularInitialization` +
  `CreateInitialMapMonocular`): wide-window matching, H/F RANSAC, the map
  bootstrap with median-depth normalization, the init BA;
- motion-model and local-map tracking through `fused_track_pose` (the
  projection-search retry ladder and pose GN);
- the keyframe policy (`NeedNewKeyFrame` / `CreateNewKeyFrame`);
- the per-frame relative-pose log for trajectory export.

Not ported yet, and raising where asked for: stereo and RGB-D (ROADMAP
slice C), the IMU (slice D), relocalization and the BoW fallback (slice E).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional

import numpy as np
import torch

from orbslam3_tpu_torch import device as device_policy
from orbslam3_tpu_torch.convert import words_to_int32
from orbslam3_tpu_torch.engine.track_program import fused_track_pose
from orbslam3_tpu_torch.slam_map.map_state import MapState
from orbslam3_tpu_torch.utils import timing
from orbslam3_tpu_torch.vision import matcher
from orbslam3_tpu_torch.vision.frame import FrameFeatures, extract_features
from orbslam3_tpu_torch.vision.twoview import reconstruct_two_views


class TrackingState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    RECENTLY_LOST = 3
    LOST = 4


@dataclasses.dataclass
class TrackerConfig:
    """The reference's `TrackerConfig` fields that the monocular path reads,
    with the reference's defaults. Of the stereo and RGB-D fields only the
    ones that switch those sensors on are here, and setting them raises
    until ROADMAP slice C; the IMU fields come with slice D."""
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
    recently_lost_frames: int = 20   # ~1 s at 20 fps
    bf: float = 0.0                  # baseline * fx; 0 = mono
    fisheye_stereo: bool = False
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
        if imu_calib is not None:
            raise NotImplementedError("Tracker: the IMU is ROADMAP slice D, "
                                      "not yet ported")
        if cfg.bf > 0 or cfg.fisheye_stereo or cfg.rectify is not None:
            raise NotImplementedError("Tracker: stereo and RGB-D are ROADMAP "
                                      "slice C, not yet ported")
        if relocalizer is not None:
            raise NotImplementedError("Tracker: relocalization is ROADMAP "
                                      "slice E, not yet ported")
        self.device = device_policy.resolve(device)
        self.camera = camera.to(self.device)
        self.map = slam_map
        self.cfg = cfg
        self.client_id = client_id
        self.local_mapper = local_mapper
        # two-view RANSAC samples: sample_fn(frame_id, mask (N,) bool numpy)
        # -> (200, 8) indices; None draws them from a generator seeded with
        # the frame id, as the reference seeds its key
        self.sample_fn = sample_fn
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

    def queue_imu(self, samples):
        raise NotImplementedError("Tracker: the IMU is ROADMAP slice D, "
                                  "not yet ported")

    # ------------------------------------------------------------------ api
    def _extract(self, img) -> FrameFeatures:
        cfg = self.cfg
        return extract_features(img, n_features=cfg.n_features,
                                n_levels=cfg.n_levels, scale=cfg.scale_factor,
                                ini_th=cfg.ini_th_fast, min_th=cfg.min_th_fast,
                                device=self.device)

    def process_image(self, img, ts: float):
        with timing.stage("track.extract"):
            timing.count("dispatch.extract")
            feats = self._extract(img)
        return self.process_features(feats, ts)

    def process_stereo(self, img_left, img_right, ts: float):
        raise NotImplementedError("Tracker: stereo is ROADMAP slice C, "
                                  "not yet ported")

    def process_rgbd(self, img, depth_map, ts: float, depth_factor: float = 1.0):
        raise NotImplementedError("Tracker: RGB-D is ROADMAP slice C, "
                                  "not yet ported")

    def process_features(self, feats: FrameFeatures, ts: float):
        """Main entry (GrabImageMonocular). Returns the world->camera pose
        (R, t) or None while uninitialized or lost."""
        feats = FrameFeatures(**{f.name: getattr(feats, f.name).to(self.device)
                                 for f in dataclasses.fields(FrameFeatures)})
        self.frame_id += 1
        self._cur_obs = None
        # timestamp-jump guard: a backwards jump respawns the map
        self.reset_request = None
        if (self._last_ts is not None and ts < self._last_ts - 1e-9
                and self.state in (TrackingState.OK, TrackingState.RECENTLY_LOST)):
            self.reset_request = 'new_map'
        if self.state in (TrackingState.NO_IMAGES_YET, TrackingState.NOT_INITIALIZED):
            self._monocular_initialization(feats, ts)
        elif self.state in (TrackingState.OK, TrackingState.RECENTLY_LOST):
            if self._track_frame(feats, ts):
                self.state = TrackingState.OK
                self._lost_count = 0
            else:
                self._lost_count += 1
                self.state = (TrackingState.RECENTLY_LOST
                              if self._lost_count <= self.cfg.recently_lost_frames
                              else TrackingState.LOST)
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

    def _monocular_initialization(self, feats: FrameFeatures, ts: float):
        cfg = self.cfg
        if self._init_feats is None:
            if int(feats.valid.sum()) >= cfg.init_min_matches:
                self._init_feats = feats
                self._init_ts = ts
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
        k1 = self.map.add_keyframe(
            R2, t2, ts, self.frame_id, cur_np["uv"], cur_np["octave"],
            cur_np["angle"], cur_np["desc"], cur_np["valid"], obs1, prev_kf=k0)
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

    def _track_frame(self, feats: FrameFeatures, ts: float) -> bool:
        cfg = self.cfg
        m = self.map
        # the reference KF may have been culled (its slot possibly reused):
        # fall back to the newest keyframe
        if (self.ref_kf < 0 or not m.kf_valid[self.ref_kf]
                or m.kf_uid[self.ref_kf] != self._ref_uid):
            ids = m.keyframe_ids()
            if len(ids) == 0:
                return False
            self._set_ref_kf(int(ids[np.argmax(m.kf_frame_id[ids])]))
        # constant-velocity prediction
        R_pred = self._vel_R @ self.R_cw
        t_pred = self._vel_R @ self.t_cw + self._vel_t

        with m.lock:
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
        # refinement) with its pose GN; K1 reads the packed words as stored
        timing.count("dispatch.track_fused")
        success, res = fused_track_pose(
            mp_pos, mp_words, valid_pt, mp_normal, mp_min_d, mp_max_d,
            self.camera, feats.uv, feats.desc, feats.octave, feats.valid,
            self._t(R_pred), self._t(t_pred), self._t(self.R_cw), self._t(self.t_cw),
            self.state == TrackingState.RECENTLY_LOST,
            [cfg.proj_radius, cfg.proj_radius_wide, cfg.proj_radius_wide * 2,
             cfg.local_radius],
            cfg.min_track_matches, cfg.min_inliers_ok, max_dist=cfg.max_mp_dist,
            device=self.device)
        if not success:
            # TrackReferenceKeyFrame needs the vocabulary (ROADMAP slice E);
            # without one the reference returns None here too
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
        self._vel_R = (R1 @ self.R_cw.T).astype(np.float32)
        self._vel_t = (t1 - self._vel_R @ self.t_cw).astype(np.float32)
        self.R_cw, self.t_cw = R1, t1
        self.n_inliers = n_in
        self._frames_since_kf += 1

        if self._need_new_keyframe(n_in, ts):
            with timing.stage("track.new_kf"):
                self._create_keyframe(feats, ts, mp_ids)
        return True

    def _need_new_keyframe(self, n_in: int, ts: float = None) -> bool:
        """NeedNewKeyFrame: the weakness test counts the reference KF's
        well-observed points (observed by >= 3 keyframes, 2 while the map
        has <= 2)."""
        cfg = self.cfg
        if self.ref_kf < 0:
            return False
        m = self.map
        with m.lock:  # the observation counts and the ref KF's row together
            obs_ref = m.kf_obs_mp[self.ref_kf]
            mp = obs_ref[obs_ref >= 0]
            mp = mp[m.mp_valid[mp]]
            min_obs = 3 if m.n_keyframes > 2 else 2
            ref_tracked = int((m.obs_counts()[mp] >= min_obs).sum())
        if n_in < cfg.kf_min_inliers:
            return False
        weak = n_in < cfg.kf_ref_ratio * ref_tracked
        stale = self._frames_since_kf >= cfg.kf_max_interval
        return weak or stale

    def _create_keyframe(self, feats: FrameFeatures, ts: float, mp_ids: np.ndarray):
        with self.map.lock:
            f = _host(feats)
            k = self.map.add_keyframe(
                self.R_cw, self.t_cw, ts, self.frame_id, f["uv"], f["octave"],
                f["angle"], f["desc"], f["valid"], mp_ids.copy(),
                prev_kf=self.ref_kf)
            if k < 0:
                return  # map at keyframe capacity; keep tracking without a KF
            self._update_mp_stats_after_insert(mp_ids[mp_ids >= 0])
            self._set_ref_kf(k)
            self._frames_since_kf = 0
            if self.local_mapper is not None:
                self.local_mapper.process_keyframe(k)
                # adopt the possibly updated pose
                self.R_cw = self.map.kf_R[k].copy()
                self.t_cw = self.map.kf_t[k].copy()

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
