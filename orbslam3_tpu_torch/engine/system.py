"""System facade: the engine's entry points.

Port of `orbslam3_tpu/engine/system.py` (ORB-SLAM3's `System`), the
monocular and mono-inertial paths: it owns the Atlas, one tracking lane per
client and the shared local mapper, routes frames and IMU samples
(`track_monocular`, `track_features`), stores or resets maps on tracking
loss, a bad IMU or a timestamp jump, and exports trajectories
(`save_trajectory_tum` / `_euroc` / `_kitti`). Everything runs on `device`
(the card unless ``device="cpu"``).

Not ported yet, and raising where asked for: stereo, RGB-D and their
trackers, with or without an IMU (ROADMAP slice C), the vocabulary with
loop closing and relocalization (slice E), atlas load and save (slice F),
the edge server's wire features (slice H), and `async_mapping=True`.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from orbslam3_tpu_torch import device as device_policy
from orbslam3_tpu_torch.engine.local_mapping import LocalMapper, LocalMapperConfig
from orbslam3_tpu_torch.engine.tracking import Tracker, TrackerConfig, TrackingState
from orbslam3_tpu_torch.opt.pose_gn import optimize_pose_batch
from orbslam3_tpu_torch.slam_map.atlas import Atlas
from orbslam3_tpu_torch.slam_map.map_state import MapConfig


class Sensor(enum.Enum):
    """Reference `System::eSensor`."""
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2
    IMU_MONOCULAR = 3
    IMU_STEREO = 4
    IMU_RGBD = 5


@dataclass
class SystemConfig:
    sensor: Sensor = Sensor.MONOCULAR
    map: MapConfig = field(default_factory=MapConfig)
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    mapper: LocalMapperConfig = field(default_factory=LocalMapperConfig)
    imu_calib: object = None  # ImuCalib for IMU_* sensors
    async_mapping: bool = False
    # LOST with a map this mature stores it and spawns a fresh one (the
    # reference's > 10 KFs); smaller maps are reset instead
    min_kfs_to_store_map: int = 10


def rotation_to_quat(R: np.ndarray) -> np.ndarray:
    """R (3,3) -> quaternion (qx, qy, qz, qw), Hamilton, unit."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
        q = np.zeros(3)
        q[i] = 0.25 * s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        w = (R[k, j] - R[j, k]) / s
        x, y, z = q
    q = np.array([x, y, z, w])
    return q / np.linalg.norm(q)


def _not_ported(what: str, slice_: str) -> NotImplementedError:
    return NotImplementedError(f"Slam: {what} is ROADMAP {slice_}, not yet ported")


class Slam:
    """Session object (reference `System`)."""

    def __init__(self, camera, cfg: SystemConfig = None, vocab=None,
                 load_atlas_from: str = None, device=None):
        self.cfg = cfg or SystemConfig()
        if vocab is not None:
            raise _not_ported("the vocabulary (loop closing, relocalization)",
                              "slice E")
        if load_atlas_from:
            raise _not_ported("loading an atlas", "slice F")
        if self.cfg.sensor not in (Sensor.MONOCULAR, Sensor.IMU_MONOCULAR):
            raise _not_ported(f"sensor {self.cfg.sensor.name}", "slice C")
        if self.cfg.sensor == Sensor.IMU_MONOCULAR and self.cfg.imu_calib is None:
            raise ValueError("Slam: Sensor.IMU_MONOCULAR needs SystemConfig.imu_calib")
        if self.cfg.async_mapping:
            raise _not_ported("async_mapping=True (the reference's "
                              "engine/async_engine.py)", "slice B")
        self.device = device_policy.resolve(device)
        self.camera = camera.to(self.device)
        self.atlas = Atlas(self.cfg.map, device=self.device)
        self.trackers: dict[int, Tracker] = {}
        self._lock = threading.Lock()
        self.events: list[dict] = []  # structured event log
        # ONE shared mapping back end for all clients, as the reference wires
        # every tracking lane into a single LocalMapping
        self._backend = self._make_backend()
        self.add_client(0)

    def _make_backend(self) -> LocalMapper:
        return LocalMapper(self.camera, self.atlas.active, cfg=self.cfg.mapper,
                           imu_calib=self._imu_calib(), device=self.device)

    def _make_tracker(self, client_id: int) -> Tracker:
        return Tracker(self.camera, self.atlas.active, self.cfg.tracker,
                       client_id=client_id, local_mapper=self._backend,
                       imu_calib=self._imu_calib(), device=self.device)

    def _imu_calib(self):
        """The IMU calibration of an inertial sensor, else None."""
        return self.cfg.imu_calib if self.cfg.sensor == Sensor.IMU_MONOCULAR else None

    # ------------------------------------------------------------- clients
    def add_client(self, client_id: int) -> Tracker:
        """A new tracking lane against the shared active map."""
        with self._lock:
            tracker = self._make_tracker(client_id)
            self.trackers[client_id] = tracker
            self._log('add_client', client=client_id)
            return tracker

    def get_tracker(self, client_id: int = 0) -> Tracker:
        return self.trackers[client_id]

    def activate_localization_mode(self):
        raise _not_ported("localization mode (it relocalizes against the map)",
                          "slice E")

    # -------------------------------------------------------------- tracking
    def track_monocular(self, img, ts: float, imu=None, client_id: int = 0):
        """Reference `System::TrackMonocular`: a (H, W) grayscale image in
        [0, 255] (numpy or tensor) and the IMU samples since the last frame
        -> the world->camera pose (R, t), or None while uninitialized or
        lost."""
        tracker = self.trackers[client_id]
        if imu is not None:
            tracker.queue_imu(imu)
        out = tracker.process_image(img, ts)
        self._after_track(tracker)
        return out

    def track_stereo(self, img_left, img_right, ts: float, imu=None,
                     client_id: int = 0):
        raise _not_ported("stereo", "slice C")

    def track_rgbd(self, img, depth, ts: float, imu=None, client_id: int = 0,
                   depth_factor: float = 1.0):
        raise _not_ported("RGB-D", "slice C")

    def track_features(self, feats, ts: float, client_id: int = 0, imu=None):
        """Track from pre-extracted `FrameFeatures`."""
        tracker = self.trackers[client_id]
        if imu is not None:
            tracker.queue_imu(imu)
        out = tracker.process_features(feats, ts)
        self._after_track(tracker)
        return out

    def track_edge(self, client_id: int, pkt):
        raise _not_ported("the edge server's wire features", "slice H")

    def _after_track(self, tracker: Tracker):
        """Failure ladder: on LOST, store a mature map and respawn, or reset
        a young one; also services the bad-IMU flag (reset the map) and the
        timestamp-jump requests (reset a young inertial map, else respawn)."""
        if tracker.map.bad_imu:
            self._log('bad_imu_reset', map=tracker.map.map_id)
            self.reset_active_map()
            return
        req = tracker.reset_request
        if req is not None:
            tracker.reset_request = None
            self._log('timestamp_jump', action=req)
            if req == 'reset_map':
                self.reset_active_map()
            else:
                self.atlas.create_new_map()
                self._rebind_all_trackers()
            return
        if tracker.state != TrackingState.LOST:
            return
        m = tracker.map
        if m.n_keyframes > self.cfg.min_kfs_to_store_map:
            self._log('map_stored', map=m.map_id, kfs=m.n_keyframes)
            new_id = self.atlas.create_new_map()
            self._rebind_all_trackers()
            self._log('map_created', map=new_id)
        else:
            self.reset_active_map()

    def _rebind_all_trackers(self):
        self._backend = self._make_backend()
        for cid, tracker in self.trackers.items():
            old_traj = tracker.trajectory
            fresh = self._make_tracker(cid)
            fresh.trajectory = old_traj  # keep the cross-map trajectory log
            fresh._traj_maps = getattr(tracker, '_traj_maps', []) + \
                [(len(old_traj), tracker.map)]
            self.trackers[cid] = fresh

    def reset_active_map(self):
        """Reference `System::ResetActiveMap`."""
        m = self.atlas.active
        mid = m.map_id
        self.atlas.maps[mid] = type(m)(m.cfg, map_id=mid, device=self.device)
        self._rebind_all_trackers()
        self._log('map_reset', map=mid)

    # ----------------------------------------------------------- trajectory
    def _trajectory(self, client_id: int = 0):
        return self.trackers[client_id].export_trajectory()

    def _full_poses(self, client_id: int = 0, refine: bool = True):
        """(ts, R_wc, t_wc) per tracked frame, composing relative poses with
        the current KF estimates (SaveTrajectoryTUM). With `refine`, frames
        that carry stored inlier observations are re-optimized against the
        final map in one batched pose GN (`_polish_poses`)."""
        tracker = self.trackers[client_id]
        m = tracker.map
        uid_to_slot = {int(m.kf_uid[k]): int(k) for k in m.keyframe_ids()}
        out, recs, anchored = [], [], []
        for rec in tracker.trajectory:
            # spanning-tree repair for culled reference KFs
            R_cr, t_cr, uid, hops = rec.Tcr_R, rec.Tcr_t, rec.ref_kf_uid, 0
            while uid not in uid_to_slot and uid in m.culled_anchor and hops < 64:
                p_uid, R_rp, t_rp = m.culled_anchor[uid]
                R_cr, t_cr = R_cr @ R_rp, R_cr @ t_rp + t_cr
                uid, hops = p_uid, hops + 1
            slot = uid_to_slot.get(uid, -1)
            if slot < 0:
                continue
            Rr, tr = m.kf_R[slot], m.kf_t[slot]
            out.append([rec.ts, R_cr @ Rr, R_cr @ tr + t_cr])
            recs.append(rec)
            anchored.append(
                hops == 0 and np.allclose(rec.Tcr_R, np.eye(3), atol=1e-6)
                and np.allclose(rec.Tcr_t, 0.0, atol=1e-7))
        if refine:
            self._polish_poses(m, out, recs, anchored)
        return [(ts, R_cw.T, -R_cw.T @ t_cw) for ts, R_cw, t_cw in out]

    def _polish_poses(self, m, out, recs, anchored, min_inliers: int = 20,
                      chunk: int = 256):
        """Export-time trajectory polish: frames anchored to a live keyframe
        with identity Tcr already carry its BA pose and are skipped; the
        others are re-optimized against the final landmarks, `chunk`
        frames per batch."""
        cap = m.cfg.features_per_frame
        todo = [i for i, rec in enumerate(recs)
                if rec.obs_mp is not None and len(rec.obs_mp) >= min_inliers
                and not anchored[i]]
        if not todo:
            return
        with m.lock:
            mp_pos = m.mp_pos.copy()
            mp_valid = m.mp_valid.copy()
            mp_uid = m.mp_uid.copy()
        for start in range(0, len(todo), chunk):
            batch = todo[start:start + chunk]
            F = len(batch)
            R0 = np.tile(np.eye(3, dtype=np.float32), (F, 1, 1))
            t0 = np.zeros((F, 3), np.float32)
            pts = np.zeros((F, cap, 3), np.float32)
            uv = np.zeros((F, cap, 2), np.float32)
            info = np.ones((F, cap), np.float32)
            valid = np.zeros((F, cap), bool)
            for bi, i in enumerate(batch):
                rec = recs[i]
                R0[bi], t0[bi] = out[i][1], out[i][2]
                ids = rec.obs_mp
                # culled slots are recycled for new landmarks: slot and uid
                # must both match
                keep = (ids >= 0) & mp_valid[ids] & (mp_uid[ids] == rec.obs_uid)
                n = min(int(keep.sum()), cap)
                sel = np.nonzero(keep)[0][:n]
                pts[bi, :n] = mp_pos[ids[sel]]
                uv[bi, :n] = rec.obs_uv[sel]
                info[bi, :n] = 1.0 / (1.2 ** (2 * rec.obs_oct[sel].astype(np.float32)))
                valid[bi, :n] = True
            R, t, _, n_in = optimize_pose_batch(
                *(torch.from_numpy(x) for x in (R0, t0, pts, uv, info, valid)),
                self.camera, device=self.device)
            R, t, n_in = R.cpu().numpy(), t.cpu().numpy(), n_in.cpu().numpy()
            for bi, i in enumerate(batch):
                if (n_in[bi] >= min_inliers and np.isfinite(R[bi]).all()
                        and np.isfinite(t[bi]).all()):
                    out[i][1], out[i][2] = R[bi], t[bi]

    def save_trajectory_tum(self, path: str, client_id: int = 0):
        """`ts x y z qx qy qz qw` per line (System::SaveTrajectoryTUM)."""
        with open(path, 'w') as f:
            for ts, R_wc, t_wc in self._full_poses(client_id):
                q = rotation_to_quat(R_wc)
                f.write(f'{ts:.6f} {t_wc[0]:.7f} {t_wc[1]:.7f} {t_wc[2]:.7f} '
                        f'{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n')

    def save_trajectory_euroc(self, path: str, client_id: int = 0):
        """Nanosecond timestamps (System::SaveTrajectoryEuRoC)."""
        with open(path, 'w') as f:
            for ts, R_wc, t_wc in self._full_poses(client_id):
                q = rotation_to_quat(R_wc)
                f.write(f'{int(ts * 1e9)} {t_wc[0]:.9f} {t_wc[1]:.9f} '
                        f'{t_wc[2]:.9f} {q[0]:.9f} {q[1]:.9f} {q[2]:.9f} '
                        f'{q[3]:.9f}\n')

    def save_trajectory_kitti(self, path: str, client_id: int = 0):
        """Row-major 3x4 T_wc per line (System::SaveTrajectoryKITTI)."""
        with open(path, 'w') as f:
            for _, R_wc, t_wc in self._full_poses(client_id):
                T = np.hstack([R_wc, t_wc[:, None]])
                f.write(' '.join(f'{v:.9e}' for v in T.reshape(-1)) + '\n')

    # ------------------------------------------------------------ lifecycle
    def save_atlas(self, path: str):
        raise _not_ported("saving an atlas", "slice F")

    def flush(self):
        """Mapping runs synchronously: nothing is in flight."""

    def shutdown(self, save_atlas_to: str = None):
        if save_atlas_to:
            self.save_atlas(save_atlas_to)
        self._log('shutdown')

    def print_info(self, client_id: int = 0) -> dict:
        """Current state snapshot of a client (the fork's PrintInfo)."""
        t = self.trackers[client_id]
        m = t.map
        return {'client': client_id, 'state': t.state.name, 'map_id': m.map_id,
                'n_kfs': m.n_keyframes, 'n_mps': m.n_points,
                'imu_initialized': m.imu_initialized, 'n_maps': len(self.atlas.maps)}

    def _log(self, kind: str, **kw):
        self.events.append({'event': kind, **kw})
