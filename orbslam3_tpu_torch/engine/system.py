"""System facade: the engine's entry points.

Port of `orbslam3_tpu/engine/system.py` (ORB-SLAM3's `System`) for every
sensor (monocular, stereo, RGB-D, each with or without an IMU): it owns
the Atlas, one tracking lane per client and the shared local mapper,
routes frames and IMU samples (`track_monocular`, `track_stereo`,
`track_rgbd`, `track_features`), stores or resets maps on tracking
loss, a bad IMU or a timestamp jump, and exports trajectories
(`save_trajectory_tum` / `_euroc` / `_kitti`). Everything runs on `device`
(the card unless ``device="cpu"``).

With a vocabulary and `use_loop_closing`, it also owns the keyframe
database and the loop closer (`_on_keyframe` after each mapped keyframe:
loops and merges), gives the trackers the vocabulary's words for the BoW
fallback and `_relocalize` (database candidates, the frame matched against
each candidate's group under K1 policy "reloc", PnP RANSAC + pose GN), and
serves localization mode and `change_dataset`.

Atlas checkpoints: `save_atlas` / `shutdown(save_atlas_to=)` write the
JAX package's `.npz` format (`slam_map/serialize.py`), and
`Slam(load_atlas_from=...)` restores it under a fresh active map and
rebuilds the keyframe database (every loaded keyframe's BoW on `device`).
`track_edge` is the edge server's `track_fn` (wire packets -> padded
features -> `track_features`). With `async_mapping=True`, local mapping
and loop closing run on a worker thread fed by a keyframe queue
(`engine/async_engine.py`).
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from orbslam3_tpu_torch import device as device_policy
from orbslam3_tpu_torch.engine.async_engine import AsyncBackend
from orbslam3_tpu_torch.engine.local_mapping import LocalMapper, LocalMapperConfig
from orbslam3_tpu_torch.engine.loop_closing import LoopCloser, LoopCloserConfig
from orbslam3_tpu_torch.engine.tracking import Tracker, TrackerConfig, TrackingState
from orbslam3_tpu_torch.kernels import hamming as ham
from orbslam3_tpu_torch.opt.pose_gn import optimize_pose_batch
from orbslam3_tpu_torch.place.database import KeyFrameDatabase
from orbslam3_tpu_torch.slam_map import serialize
from orbslam3_tpu_torch.slam_map.atlas import Atlas
from orbslam3_tpu_torch.slam_map.map_state import MapConfig
from orbslam3_tpu_torch.utils import timing
from orbslam3_tpu_torch.vision.frame import features_from_arrays
from orbslam3_tpu_torch.vision.pnp import relocalize_pose


class Sensor(enum.Enum):
    """Reference `System::eSensor`."""
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2
    IMU_MONOCULAR = 3
    IMU_STEREO = 4
    IMU_RGBD = 5


INERTIAL = (Sensor.IMU_MONOCULAR, Sensor.IMU_STEREO, Sensor.IMU_RGBD)
# sensors whose maps are metric from the start: the IMU ladder holds s = 1
WITH_DEPTH = (Sensor.STEREO, Sensor.RGBD, Sensor.IMU_STEREO, Sensor.IMU_RGBD)


@dataclass
class SystemConfig:
    sensor: Sensor = Sensor.MONOCULAR
    map: MapConfig = field(default_factory=MapConfig)
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    mapper: LocalMapperConfig = field(default_factory=LocalMapperConfig)
    imu_calib: object = None  # ImuCalib for IMU_* sensors
    use_loop_closing: bool = True  # with a vocabulary
    # local mapping and loop closing on a worker thread fed by a keyframe
    # queue, with an abortable local BA; False runs them inline
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


class Slam:
    """Session object (reference `System`)."""

    def __init__(self, camera, cfg: SystemConfig = None, vocab=None,
                 load_atlas_from: str = None, device=None):
        self.cfg = cfg or SystemConfig()
        if self.cfg.sensor in INERTIAL and self.cfg.imu_calib is None:
            raise ValueError(f"Slam: Sensor.{self.cfg.sensor.name} needs "
                             "SystemConfig.imu_calib")
        self.device = device_policy.resolve(device)
        self.camera = camera.to(self.device)
        if load_atlas_from:
            # the saved maps come back stored, under a fresh active map
            self.atlas = serialize.load_atlas(load_atlas_from, vocab=vocab,
                                              check_vocab=vocab is not None,
                                              device=self.device)
        else:
            self.atlas = Atlas(self.cfg.map, device=self.device)
        self.vocab = vocab
        self.db = None
        self.loop_closer = None
        if vocab is not None and self.cfg.use_loop_closing:
            self.db = KeyFrameDatabase(vocab, max_keyframes=self.cfg.map.max_keyframes * 4,
                                       device=self.device)
            # stereo / RGB-D / inertial maps observe their scale: the loop
            # Sim3 is an SE3 there; inertial maps take the 4-DoF graph
            inertial = self.cfg.sensor in INERTIAL
            self.loop_closer = LoopCloser(
                self.camera, self.atlas, self.db,
                LoopCloserConfig(fix_scale=self.cfg.sensor != Sensor.MONOCULAR,
                                 inertial=inertial),
                imu_calib=self.cfg.imu_calib if inertial else None, device=self.device)
            if load_atlas_from:
                self._rebuild_database()
        # relocalization's PnP samples: reloc_sample_fn(change_index, valid
        # (N,) numpy) -> (256, 6) indices; None draws them from a generator
        # seeded with the map's change index
        self.reloc_sample_fn = None
        self._localization_only = False
        self.trackers: dict[int, Tracker] = {}
        self._frames_in: dict[int, int] = {}  # frames handed in, per client
        self._lock = threading.Lock()
        self._edge_lock = threading.Lock()  # one edge lane in `track_edge` at a time
        self.events: list[dict] = []  # structured event log
        # ONE shared mapping back end for all clients, as the reference wires
        # every tracking lane into a single LocalMapping
        self._backend = self._make_backend()
        self.add_client(0)

    def _rebuild_database(self):
        """The keyframe database of a loaded atlas: every keyframe's BoW
        (on `device`) added under its map, as ORB-SLAM3 rebuilds its
        KeyFrameDatabase on LoadAtlas; without it relocalization against a
        loaded map finds no candidate."""
        for mid, m in self.atlas.maps.items():
            for k in m.keyframe_ids():
                _, bow = self.db.compute_bow(m.kf_desc[k], m.kf_feat_valid[k])
                self.db.add(int(k), bow, map_id=mid)

    def _make_backend(self) -> "_HookedMapper":
        return _HookedMapper(LocalMapper(
            self.camera, self.atlas.active, cfg=self.cfg.mapper,
            imu_calib=self._imu_calib(), bf=self.cfg.tracker.bf,
            fix_scale=self.cfg.sensor in WITH_DEPTH, device=self.device), self._on_keyframe,
            async_mode=self.cfg.async_mapping)

    def _make_tracker(self, client_id: int) -> Tracker:
        tracker = Tracker(self.camera, self.atlas.active, self.cfg.tracker,
                          client_id=client_id, local_mapper=self._backend,
                          relocalizer=self._relocalize, imu_calib=self._imu_calib(),
                          device=self.device)
        if self.db is not None:
            # the vocabulary's words for the TrackReferenceKeyFrame fallback
            tracker.bow_fn = self.db.words
            tracker.bow_k = self.vocab.k
        return tracker

    def _imu_calib(self):
        """The IMU calibration of an inertial sensor, else None."""
        return self.cfg.imu_calib if self.cfg.sensor in INERTIAL else None

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
        """Reference `System::ActivateLocalizationMode`: freeze mapping and
        track / relocalize against the map; no keyframes, no map changes.
        An empty active map gives way to the largest stored one."""
        self._localization_only = True
        if self.atlas.active.n_keyframes == 0:
            stored = [(self.atlas.maps[mid].n_keyframes, mid)
                      for mid in self.atlas.stored_maps()]
            if stored:
                self._shutdown_backend()
                self.atlas.change_map(max(stored)[1])
                self._rebind_all_trackers()
        for tr in self.trackers.values():
            tr.only_tracking = True
        self._log('localization_mode', active=True)

    def deactivate_localization_mode(self):
        self._localization_only = False
        for tr in self.trackers.values():
            tr.only_tracking = False
        self._log('localization_mode', active=False)

    # -------------------------------------------------------------- tracking
    def track_monocular(self, img, ts: float, imu=None, client_id: int = 0):
        """Reference `System::TrackMonocular`: a (H, W) grayscale image in
        [0, 255] (numpy or tensor) and the IMU samples since the last frame
        -> the world->camera pose (R, t), or None while uninitialized or
        lost."""
        return self._track(client_id, imu, "process_image", img, ts)

    def track_stereo(self, img_left, img_right, ts: float, imu=None,
                     client_id: int = 0):
        """Reference `System::TrackStereo`: a (H, W) pair, raw or rectified
        as the tracker's config says, and the IMU samples since the last
        frame -> the world->camera pose (R, t), or None."""
        return self._track(client_id, imu, "process_stereo", img_left, img_right, ts)

    def track_rgbd(self, img, depth, ts: float, imu=None, client_id: int = 0,
                   depth_factor: float = 1.0):
        """Reference `System::TrackRGBD`: an image and its registered depth
        map (times `depth_factor` gives metres; TUM's uint16 PNG takes
        1/5000) -> the world->camera pose (R, t), or None."""
        return self._track(client_id, imu, "process_rgbd", img, depth, ts,
                           depth_factor=depth_factor)

    def track_features(self, feats, ts: float, client_id: int = 0, imu=None):
        """Track from pre-extracted `FrameFeatures`."""
        return self._track(client_id, imu, "process_features", feats, ts)

    def _track(self, client_id: int, imu, process: str, *args, **kw):
        """One frame of a client: queue its IMU samples, run the tracker's
        `process` entry, then the failure ladder, in one `slam.frame` stage
        whose fields name the client and the frame (its index among the
        frames this `Slam` was handed for the client)."""
        tracker = self.trackers[client_id]
        frame = self._frames_in.get(client_id, 0)
        self._frames_in[client_id] = frame + 1
        with timing.stage("slam.frame", client=client_id, frame=frame):
            if imu is not None:
                tracker.queue_imu(imu)
            out = getattr(tracker, process)(*args, **kw)
            self._after_track(tracker)
        return out

    def track_edge(self, client_id: int, pkt):
        """The edge server's `track_fn`: a wire `FramePacket` -> padded
        `FrameFeatures` at the tracker's `n_features` -> `track_features`
        with the packet's IMU samples. A new client id gets its lane. The
        server's lane threads call this concurrently; they take turns (the
        JAX package lets them run at once on the shared map). Stage
        `edge.lock_wait` runs from entry until the lock is held, with the
        packet's `edge.features` inside it."""
        with timing.stage("edge.lock_wait", client=client_id):
            with timing.stage("edge.features", client=client_id):
                feats = features_from_arrays(pkt.uv, pkt.desc,
                                             capacity=self.cfg.tracker.n_features,
                                             device=self.device)
            imu = list(zip(pkt.imu_ts_ns * 1e-9, pkt.imu_gyro, pkt.imu_acc))
            self._edge_lock.acquire()
        try:
            if client_id not in self.trackers:
                self.add_client(client_id)
            return self.track_features(feats, pkt.timestamp_ns * 1e-9, client_id=client_id,
                                       imu=imu)
        finally:
            self._edge_lock.release()

    def _after_track(self, tracker: Tracker):
        """Failure ladder: on LOST, store a mature map and respawn, or reset
        a young one; also services the bad-IMU flag (reset the map) and the
        timestamp-jump requests (reset a young inertial map, else respawn).
        In localization mode nothing is reset or spawned."""
        if self._localization_only:
            return
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
                self._shutdown_backend()
                self.atlas.create_new_map()
                self._rebind_all_trackers()
            return
        if tracker.state != TrackingState.LOST:
            return
        m = tracker.map
        if m.n_keyframes > self.cfg.min_kfs_to_store_map:
            self._log('map_stored', map=m.map_id, kfs=m.n_keyframes)
            self._shutdown_backend()
            new_id = self.atlas.create_new_map()
            self._rebind_all_trackers()
            self._log('map_created', map=new_id)
        else:
            self.reset_active_map()

    def _rebind_all_trackers(self):
        """A fresh back end and trackers on the new active map. The caller
        has stopped the old worker (`_shutdown_backend`) before the active
        map changed: its queued keyframes belong to the old map, and their
        loop-closing pass reads `atlas.active`."""
        self._backend = self._make_backend()
        for cid, tracker in self.trackers.items():
            old_traj = tracker.trajectory
            fresh = self._make_tracker(cid)
            fresh.trajectory = old_traj  # keep the cross-map trajectory log
            fresh._traj_maps = getattr(tracker, '_traj_maps', []) + \
                [(len(old_traj), tracker.map)]
            self.trackers[cid] = fresh

    def change_dataset(self):
        """Reference `System::ChangeDataset`: close the sequence: a mature
        active map is stored and a fresh one spawned (place recognition may
        weld them later), a young one is reset."""
        m = self.atlas.active
        if m.n_keyframes > self.cfg.min_kfs_to_store_map:
            self._log('dataset_change', stored_map=m.map_id, kfs=m.n_keyframes)
            self._shutdown_backend()
            self.atlas.create_new_map()
            self._rebind_all_trackers()
        else:
            self._log('dataset_change', stored_map=None, kfs=m.n_keyframes)
            self.reset_active_map()

    def reset_active_map(self):
        """Reference `System::ResetActiveMap`."""
        self._shutdown_backend()  # the queued keyframes land before the clear
        m = self.atlas.active
        mid = m.map_id
        if self.db is not None:
            self.db.clear_map(mid)
        self.atlas.maps[mid] = type(m)(m.cfg, map_id=mid, device=self.device)
        self._rebind_all_trackers()
        self._log('map_reset', map=mid)

    # ------------------------------------------------------------ keyframes
    def _on_keyframe(self, k: int):
        """After local mapping of keyframe `k`: the loop closer's pass (the
        LocalMapping -> LoopClosing hand-off)."""
        if self.loop_closer is None:
            return
        ev = self.loop_closer.process_keyframe(k)
        if ev is not None:
            self._log('loop_event', loop_kind=ev.kind, kf=k)

    # -------------------------------------------------------- relocalization
    RELOC_CANDIDATES = 8     # database candidates tried per frame
    RELOC_CAP = 2048         # candidate points per candidate group

    def _relocalize(self, feats):
        """BoW relocalization against the active map
        (`Tracking::Relocalization`): database candidates; per candidate,
        the points of it and its best covisible neighbours (the first
        observation of each, at most RELOC_CAP) matched against the frame's
        features under K1 policy "reloc" (ratio 0.75); PnP RANSAC + pose GN
        on the matches. Returns (R_cw, t_cw, per-feature point ids, ref_kf)
        or None."""
        if self.db is None:
            return None
        m = self.atlas.active
        if m.n_keyframes < 2:
            return None
        fval = feats.valid.cpu().numpy()
        _, bow = self.db.compute_bow(feats.desc, fval)
        covis = (lambda kf: [int(x) for x in m.covisibility(kf, min_shared=10)]
                 if m.kf_valid[kf] else [])
        cands = self.db.detect_relocalization_candidates(bow, covis, map_id=m.map_id)
        uv = feats.uv
        info = 1.0 / (1.2 ** (2 * feats.octave.float()))
        seed = int(m.change_index) & 0x7FFFFFFF
        for cand in list(cands[:self.RELOC_CANDIDATES]):
            cand = int(cand)
            if cand >= m.kf_valid.size or not m.kf_valid[cand]:
                continue
            group = np.asarray([cand] + [int(x) for x in
                                         m.covisibility(cand, min_shared=15)[:4]])
            # the group's points, each at its first observation
            obs_g = m.kf_obs_mp[group]
            gi_, si_ = np.nonzero(m.kf_feat_valid[group] & (obs_g >= 0))
            mp_g = obs_g[gi_, si_]
            okg = m.mp_valid[mp_g]
            gi_, si_, mp_g = gi_[okg], si_[okg], mp_g[okg]
            _, firstg = np.unique(mp_g, return_index=True)
            if len(firstg) < 15:
                continue
            firstg = firstg[:self.RELOC_CAP]
            g_mp = mp_g[firstg].astype(np.int64)
            g_desc = np.ascontiguousarray(m.kf_desc[group[gi_[firstg]], si_[firstg]])
            mask = feats.valid[:, None].expand(-1, len(g_mp)).contiguous()
            with timing.stage("track.reloc_match"):
                idx, _, ok = ham.masked_match_ratio(
                    feats.desc, torch.from_numpy(g_desc.view(np.int32)).to(self.device),
                    mask, max_dist=ham.TH_LOW, ratio=0.75, policy="reloc")
            ok_np = ok.cpu().numpy() & fval
            mp = np.where(ok_np, g_mp[idx.cpu().numpy()], -1)
            if (mp >= 0).sum() < 15:
                continue
            valid = mp >= 0
            samples = (None if self.reloc_sample_fn is None else
                       torch.as_tensor(np.array(self.reloc_sample_fn(seed, valid))))
            with timing.stage("track.reloc_pnp"):
                R, t, okp, n = relocalize_pose(
                    torch.from_numpy(m.mp_pos[np.clip(mp, 0, None)]).to(self.device), uv,
                    info, torch.from_numpy(valid).to(self.device), self.camera,
                    generator=torch.Generator().manual_seed(seed), samples=samples)
            if bool(okp):
                self._log('relocalized', kf=cand, inliers=int(n))
                return R.cpu().numpy(), t.cpu().numpy(), mp, cand
        return None

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
        """Write every map of the atlas to one `.npz` (`serialize`)."""
        serialize.save_atlas(self.atlas, path, vocab=self.vocab)
        self._log('atlas_saved', path=path)

    def flush(self):
        """Drain the mapping queue (async mapping) and wait for a global BA
        in flight."""
        self._backend.flush()
        if self.loop_closer is not None:
            self.loop_closer.gba.join()

    def _shutdown_backend(self):
        try:
            self._backend.shutdown()
        except Exception as e:  # the worker's first error, kept in the log
            self._log('backend_error', error=repr(e))

    def shutdown(self, save_atlas_to: str = None):
        self.flush()
        self._shutdown_backend()
        if self.loop_closer is not None:
            self.loop_closer.gba.abort_and_join()
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


class _HookedMapper:
    """The local mapper with the system's post-keyframe hook: mapping, then
    loop closing, in keyframe order (LocalMapping -> LoopClosing). With
    `async_mode` a keyframe is queued to an `AsyncBackend` worker instead,
    which runs both with the abort flag, and tracking returns at once."""

    def __init__(self, mapper: LocalMapper, on_kf, async_mode: bool = False):
        self.mapper = mapper
        self._on_kf = on_kf
        self.backend = None
        if async_mode:
            def process(k, abort):
                self.mapper.process_keyframe(k, abort=abort)
                self._on_kf(k)
            self.backend = AsyncBackend(process)

    def process_keyframe(self, k: int):
        if self.backend is not None:
            self.backend.insert_keyframe(k)
            return
        self.mapper.process_keyframe(k)
        self._on_kf(k)

    def flush(self):
        if self.backend is not None:
            self.backend.flush()

    def shutdown(self):
        if self.backend is not None:
            self.backend.shutdown()

    def __getattr__(self, name):
        return getattr(self.mapper, name)
