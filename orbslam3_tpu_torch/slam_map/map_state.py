"""Map data model: fixed-capacity structure-of-arrays map state.

Port of `orbslam3_tpu/slam_map/map_state.py` (`MapConfig`, `MapState`),
the replacement of ORB-SLAM3's pointer-linked map objects (`Map`,
`KeyFrame`, `MapPoint`):

  KeyFrame  -> rows of kf_* arrays (pose, features, per-slot observation)
  MapPoint  -> rows of mp_* arrays (position, representative descriptor,
               view-direction/distance stats, found/visible counters)
  observations (MapPoint::mObservations / KeyFrame::mvpMapPoints)
            -> kf_obs_mp[(kf, feature_slot)] = mp_id   (-1 = none)
  covisibility graph -> recomputed on demand as a boolean matmul over the
               observation incidence matrix (see covisibility())

As in the reference, the arrays are plain numpy on the host, for cheap
random mutation by tracking and mapping; the callers build padded device
views per call (matching, BA), and the covisibility product runs on the
map's device. Lifecycle (SetBadFlag-style erasure) is tombstoning via the
valid masks. The inertial state rides along: per-keyframe velocity, bias
and the preintegration to the previous keyframe, the IMU-init flags, and
the re-gauge of the whole map at IMU initialization, and so do the
stereo / RGB-D features' right image coordinates (`kf_uright`).
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from orbslam3_tpu_torch import device as device_policy
from orbslam3_tpu_torch.utils import verbose

# byte-wise popcount LUT for host-side Hamming medians
_POPCOUNT_TABLE = np.array([bin(i).count("1") for i in range(256)],
                           np.uint16)


def _scatter_obs(rows: np.ndarray, cols: np.ndarray, K: int, P: int,
                 device: torch.device) -> torch.Tensor:
    """(K, P) float32 0/1 observation matrix on `device` from COO; row K is
    a dump row for padding entries (sliced off)."""
    A = torch.zeros((K + 1, P), dtype=torch.float32, device=device)
    A[torch.from_numpy(rows).to(device).long(),
      torch.from_numpy(cols).to(device).long()] = 1.0
    return A[:K]


def _covis_matmul(A: torch.Tensor) -> np.ndarray:
    """W = A A^T as host int32: one f32 product of 0/1 values, exact below
    2^24 shared points (TF32 is off)."""
    return torch.round(A @ A.T).to(torch.int32).cpu().numpy()


@dataclasses.dataclass
class MapConfig:
    max_keyframes: int = 256
    max_points: int = 20000
    features_per_frame: int = 1000
    # tiered-capacity ceilings: SoA arrays double when full until these
    # hard ceilings, after which drops are LOUD events. The
    # reference is unbounded and relies on culling (LocalMapping.cc:906);
    # here culling keeps occupancy low and the ceiling is a safety rail.
    keyframes_ceil: int = 4096
    points_ceil: int = 400_000


class MapState:
    """One SLAM map (the reference's `Map`); Atlas holds several of these."""

    def __init__(self, cfg: MapConfig, map_id: int = 0, device=None):
        self.cfg = cfg
        self.map_id = map_id
        self.device = device_policy.resolve(device)  # of the covisibility product
        M, P, N = cfg.max_keyframes, cfg.max_points, cfg.features_per_frame
        # keyframes
        self.kf_R = np.tile(np.eye(3, dtype=np.float32), (M, 1, 1))
        self.kf_t = np.zeros((M, 3), np.float32)
        self.kf_valid = np.zeros(M, bool)
        self.kf_ts = np.zeros(M, np.float64)
        self.kf_frame_id = np.full(M, -1, np.int64)
        self.kf_uv = np.zeros((M, N, 2), np.float32)
        self.kf_octave = np.zeros((M, N), np.int32)
        self.kf_angle = np.zeros((M, N), np.float32)
        self.kf_desc = np.zeros((M, N, 8), np.uint32)
        self.kf_feat_valid = np.zeros((M, N), bool)
        self.kf_obs_mp = np.full((M, N), -1, np.int32)
        # stereo / RGB-D: the virtual right-image u of each feature, -1 for
        # a monocular observation (Frame::mvuRight carried onto the KeyFrame)
        self.kf_uright = np.full((M, N), -1.0, np.float32)
        self.kf_prev = np.full(M, -1, np.int32)  # temporal chain (mPrevKF)
        # IMU state per keyframe (used once inertial is initialized)
        self.kf_vel = np.zeros((M, 3), np.float32)
        self.kf_bias = np.zeros((M, 6), np.float32)
        # preintegration from kf_prev to each keyframe (reference
        # KeyFrame::mpImuPreintegrated): slot -> Preintegrated, dropped with
        # the slot
        self.kf_pre: dict[int, object] = {}
        # map points
        self.mp_pos = np.zeros((P, 3), np.float32)
        self.mp_desc = np.zeros((P, 8), np.uint32)
        self.mp_valid = np.zeros(P, bool)
        self.mp_normal = np.zeros((P, 3), np.float32)
        self.mp_min_dist = np.zeros(P, np.float32)
        self.mp_max_dist = np.zeros(P, np.float32)
        self.mp_visible = np.zeros(P, np.int32)
        self.mp_found = np.zeros(P, np.int32)
        self.mp_first_kf = np.full(P, -1, np.int32)
        self.mp_ref_kf = np.full(P, -1, np.int32)
        # stable landmark identity across slot reuse (reference
        # MapPoint::mnId): culled slots are recycled by add_points, so any
        # host-side snapshot of point ids (e.g. the trajectory polish's
        # per-frame observation records) must be validated by uid
        self.mp_uid = np.full(P, -1, np.int64)
        self._next_mp_uid = 0
        # stable keyframe identity across slot reuse (reference KFs carry
        # monotonically increasing mnId; slots here are reusable storage)
        self.kf_uid = np.full(M, -1, np.int64)
        self._next_uid = 0
        # change bookkeeping (reference Map::mnMapChange)
        self.change_index = 0
        # capacity events: every grow/drop is recorded here AND printed at
        # NORMAL verbosity — silent degradation is a bug
        self.events: list[dict] = []
        # keyframe-removal observers, called with the slot: the loop closer
        # registers the database erase here, so a culled slot never serves
        # stale retrievals (KeyFrame::SetBadFlag -> KeyFrameDatabase::erase)
        self.on_kf_removed: list = []
        # trajectory repair: culled-KF uid -> (anchor uid, R_ca, t_ca) where
        # T_ca maps anchor-KF camera coords to the culled KF's. Lets the
        # trajectory exporter re-anchor frames whose reference KF was culled
        # (reference SaveTrajectoryTUM walks bad KFs' mTcp up the spanning
        # tree, System.cc:759-874)
        self.culled_anchor: dict[int, tuple] = {}
        # map-update mutex (reference Map::mMutexMapUpdate, Map.h:141):
        # held by the async mapping worker around map-mutating stages and by
        # the tracker around multi-array consistent reads/inserts
        self.lock = threading.RLock()
        self.imu_initialized = False
        self.iba_stage = 0  # 0: none, 1: VIBA1 done, 2: VIBA2 done
        self.gauge_epoch = 0       # bumped by apply_scaled_rotation
        self.last_gauge = None     # (Rgw, s) of the latest re-gauge
        # bad-IMU detector (reference mbBadImu): too little motion for the
        # inertial initialization; the system resets the map when it sees it
        self.bad_imu = False

    # -- capacity tiers ------------------------------------------------------
    def _event(self, kind: str, **info):
        ev = dict(kind=kind, map_id=self.map_id, **info)
        self.events.append(ev)
        verbose.normal(f"[map {self.map_id}] {kind}: "
                       + ", ".join(f"{k}={v}" for k, v in info.items()))

    def _grow_rows(self, names_fills: list, old: int, new: int):
        for name, fill in names_fills:
            a = getattr(self, name)
            shape = (new,) + a.shape[1:]
            if name == 'kf_R':
                b = np.tile(np.eye(3, dtype=np.float32), (new, 1, 1))
            else:
                b = np.full(shape, fill, a.dtype)
            b[:old] = a
            setattr(self, name, b)

    def grow(self, max_keyframes: int = None, max_points: int = None):
        """Reallocate the SoA arrays at a larger tier (caller holds the map
        lock)."""
        kf_new = min(max_keyframes or self.cfg.max_keyframes,
                     self.cfg.keyframes_ceil)
        mp_new = min(max_points or self.cfg.max_points, self.cfg.points_ceil)
        kf_old, mp_old = self.cfg.max_keyframes, self.cfg.max_points
        if kf_new > kf_old:
            self._grow_rows(
                [('kf_R', 0), ('kf_t', 0.0), ('kf_valid', False),
                 ('kf_ts', 0.0), ('kf_frame_id', -1), ('kf_uv', 0.0),
                 ('kf_octave', 0), ('kf_angle', 0.0), ('kf_desc', 0),
                 ('kf_feat_valid', False), ('kf_obs_mp', -1),
                 ('kf_uright', -1.0), ('kf_vel', 0.0), ('kf_bias', 0.0),
                 ('kf_prev', -1), ('kf_uid', -1)], kf_old, kf_new)
            self._event('grow_keyframes', old=kf_old, new=kf_new)
        if mp_new > mp_old:
            self._grow_rows(
                [('mp_pos', 0.0), ('mp_desc', 0), ('mp_valid', False),
                 ('mp_normal', 0.0), ('mp_min_dist', 0.0),
                 ('mp_max_dist', 0.0), ('mp_visible', 0), ('mp_found', 0),
                 ('mp_first_kf', -1), ('mp_ref_kf', -1), ('mp_uid', -1)],
                mp_old, mp_new)
            self._event('grow_points', old=mp_old, new=mp_new)
        if kf_new != kf_old or mp_new != mp_old:
            self.cfg = dataclasses.replace(
                self.cfg, max_keyframes=kf_new, max_points=mp_new)

    # -- keyframes -----------------------------------------------------------
    @property
    def n_keyframes(self) -> int:
        return int(self.kf_valid.sum())

    @property
    def n_points(self) -> int:
        return int(self.mp_valid.sum())

    def keyframe_ids(self) -> np.ndarray:
        return np.nonzero(self.kf_valid)[0]

    def obs_counts(self) -> np.ndarray:
        """(max_points,) number of live keyframes observing each point
        (reference MapPoint::Observations()), cached by change_index."""
        key = self.change_index
        c = getattr(self, '_obs_count_cache', None)
        if c is None or c[0] != key:
            kk, ss = np.nonzero(self.kf_valid[:, None] & (self.kf_obs_mp >= 0))
            mm = self.kf_obs_mp[kk, ss]
            cnt = np.bincount(mm, minlength=self.cfg.max_points)
            c = (key, cnt)
            self._obs_count_cache = c
        return c[1]

    def add_keyframe(self, R, t, ts, frame_id, uv, octave, angle, desc,
                     feat_valid, obs_mp, prev_kf: int = -1, vel=None, bias=None,
                     preint=None, uright=None) -> int:
        free = np.nonzero(~self.kf_valid)[0]
        if len(free) == 0:
            # tier bump (x2) instead of a silent skip; only the hard
            # ceiling drops a keyframe, and LOUDLY
            self.grow(max_keyframes=self.cfg.max_keyframes * 2)
            free = np.nonzero(~self.kf_valid)[0]
            if len(free) == 0:
                self._event('drop_keyframe', at_ceiling=self.cfg.max_keyframes,
                            ts=float(ts))
                return -1
        k = int(free[0])
        self.kf_R[k] = R
        self.kf_t[k] = t
        self.kf_ts[k] = ts
        self.kf_frame_id[k] = frame_id
        self.kf_uv[k] = uv
        self.kf_octave[k] = octave
        self.kf_angle[k] = angle
        self.kf_desc[k] = desc
        self.kf_feat_valid[k] = feat_valid
        self.kf_obs_mp[k] = obs_mp
        self.kf_uright[k] = uright if uright is not None else -1.0
        self.kf_prev[k] = prev_kf
        if vel is not None:
            self.kf_vel[k] = vel
        if bias is not None:
            self.kf_bias[k] = bias
        if preint is not None:
            self.kf_pre[k] = preint
        else:
            self.kf_pre.pop(k, None)
        self.kf_uid[k] = self._next_uid
        self._next_uid += 1
        self.kf_valid[k] = True
        self.change_index += 1
        return k

    def slot_of_uid(self, uid: int) -> int:
        """Current slot of a keyframe uid, or -1 if culled."""
        hits = np.nonzero(self.kf_valid & (self.kf_uid == uid))[0]
        return int(hits[0]) if len(hits) else -1

    def remove_keyframe(self, k: int):
        """SetBadFlag equivalent: tombstone the KF and its observations."""
        p = int(self.kf_prev[k])
        if p >= 0 and self.kf_valid[p]:
            R_ca = self.kf_R[k] @ self.kf_R[p].T
            t_ca = self.kf_t[k] - R_ca @ self.kf_t[p]
            self.culled_anchor[int(self.kf_uid[k])] = (
                int(self.kf_uid[p]), R_ca.copy(), t_ca.copy())
        self.kf_valid[k] = False
        self.kf_obs_mp[k] = -1
        self.kf_pre.pop(k, None)
        self.change_index += 1
        for cb in self.on_kf_removed:
            cb(int(k))

    def apply_scaled_rotation(self, Rgw: np.ndarray, s: float,
                              scale_velocities: bool = True):
        """Re-gauge the whole map: new world w' = s Rgw w (reference
        `Map::ApplyScaledRotation`, after IMU initialization: gravity along
        -z, metric scale). Camera poses become Rcw' = Rcw Rgw^T, tcw' = s tcw,
        so camera-frame coordinates scale uniformly; viewing normals rotate
        and the scale bands scale. `gauge_epoch` tells trackers to re-express
        their motion state."""
        Rgw = np.asarray(Rgw, np.float32)
        ks = self.keyframe_ids()
        self.kf_R[ks] = self.kf_R[ks] @ Rgw.T
        self.kf_t[ks] = s * self.kf_t[ks]
        if scale_velocities:
            self.kf_vel[ks] = s * (self.kf_vel[ks] @ Rgw.T)
        live = self.mp_valid
        self.mp_pos[live] = s * (self.mp_pos[live] @ Rgw.T)
        self.mp_normal[live] = self.mp_normal[live] @ Rgw.T
        self.mp_min_dist[live] *= s
        self.mp_max_dist[live] *= s
        self.change_index += 1
        self.gauge_epoch += 1
        self.last_gauge = (Rgw.copy(), float(s))

    # -- map points ----------------------------------------------------------
    def add_points(self, pos, desc, first_kf, normals=None,
                   min_dist=None, max_dist=None) -> np.ndarray:
        """Bulk-allocate map points; returns their ids (-1 where full)."""
        n = len(pos)
        free = np.nonzero(~self.mp_valid)[0][:n]
        if len(free) < n:
            self.grow(max_points=max(self.cfg.max_points * 2,
                                     self.cfg.max_points + n))
            free = np.nonzero(~self.mp_valid)[0][:n]
            if len(free) < n:
                self._event('drop_points', requested=n, granted=len(free),
                            at_ceiling=self.cfg.max_points)
        ids = np.full(n, -1, np.int32)
        m = len(free)
        ids[:m] = free
        self.mp_pos[free] = pos[:m]
        self.mp_desc[free] = desc[:m]
        self.mp_first_kf[free] = first_kf
        self.mp_ref_kf[free] = first_kf
        self.mp_normal[free] = normals[:m] if normals is not None else 0.0
        self.mp_min_dist[free] = min_dist[:m] if min_dist is not None else 0.0
        self.mp_max_dist[free] = max_dist[:m] if max_dist is not None else np.inf
        self.mp_visible[free] = 1
        self.mp_found[free] = 1
        self.mp_valid[free] = True
        self.mp_uid[free] = np.arange(self._next_mp_uid,
                                      self._next_mp_uid + m, dtype=np.int64)
        self._next_mp_uid += m
        self.change_index += 1
        return ids

    def update_point_stats(self, mp_ids: np.ndarray, scale: float = 1.2,
                           n_levels: int = 8):
        """Refresh viewing normal, scale-invariance distances and the
        distinctive descriptor of the given points from their current
        observations (reference `MapPoint::UpdateNormalAndDepth` +
        `ComputeDistinctiveDescriptors`, MapPoint.cc). These feed the
        predicted-scale and view-angle gates in projection matching
        (Frame::isInFrustum); stale values let repeated-texture mismatches
        through."""
        mp_ids = np.asarray(mp_ids)
        mp_ids = mp_ids[(mp_ids >= 0) & self.mp_valid[np.maximum(mp_ids, 0)]]
        if len(mp_ids) == 0:
            return
        kk, slots, mm = self.observations_of(mp_ids)
        if len(kk) == 0:
            return
        centers = np.einsum("kij,ki->kj", np.swapaxes(self.kf_R[kk], 1, 2),
                            -self.kf_t[kk])
        vec = self.mp_pos[mm] - centers
        dist = np.linalg.norm(vec, axis=1)
        good = dist > 1e-9
        unit = np.zeros_like(vec)
        unit[good] = vec[good] / dist[good, None]
        # mean viewing direction per point
        nsum = np.zeros((self.cfg.max_points, 3), np.float32)
        cnt = np.zeros(self.cfg.max_points, np.int32)
        np.add.at(nsum, mm, unit)
        np.add.at(cnt, mm, 1)
        upd = np.unique(mm)
        norms = np.linalg.norm(nsum[upd], axis=1)
        nz = norms > 1e-9
        self.mp_normal[upd[nz]] = (nsum[upd[nz]] / norms[nz, None]).astype(
            np.float32)
        # scale-invariance band from the reference KF's observation
        # (maxDist = d * 1.2^level, minDist = maxDist / 1.2^(L-1)); fall
        # back to the first good observation when the ref KF no longer
        # observes the point. Fully vectorized pick: sort observations by
        # (point, rank) where rank prefers ref-KF rows, take the first per
        # point.
        ref = self.mp_ref_kf[mm]
        is_ref = (kk == ref) & good
        rank = np.where(is_ref, 0, np.where(good, 1, 2)).astype(np.int8)
        ordr = np.lexsort((np.arange(len(mm)), rank, mm))
        mm_o = mm[ordr]
        first = np.r_[True, mm_o[1:] != mm_o[:-1]]
        pick = ordr[first]
        pick = pick[rank[pick] < 2]  # points with at least one good obs
        mvals = mm[pick]
        lvl = self.kf_octave[kk[pick], slots[pick]].astype(np.float64)
        dmax = dist[pick] * scale ** lvl
        # RAW band edges (reference mfMaxDistance/mfMinDistance,
        # MapPoint::UpdateNormalAndDepth); the 0.8/1.2 tolerance factors
        # are applied ONLY by the matcher's frustum gate — storing them
        # here too widened the gate to [0.64, 1.44] (advisor finding)
        self.mp_max_dist[mvals] = dmax.astype(np.float32)
        self.mp_min_dist[mvals] = (dmax / scale ** (n_levels - 1)).astype(
            np.float32)
        # distinctive descriptor: min-median-Hamming representative over up
        # to CAPO observations per point, as one batched popcount pass
        # (reference ComputeDistinctiveDescriptors walks per-MP maps)
        POP = _POPCOUNT_TABLE
        CAPO = 16
        ordr2 = np.argsort(mm, kind="stable")
        mm_s = mm[ordr2]
        uniq, starts, counts = np.unique(mm_s, return_index=True,
                                         return_counts=True)
        U = len(uniq)
        gid = np.repeat(np.arange(U), counts)
        pos = np.arange(len(mm_s)) - np.repeat(starts, counts)
        keep = pos < CAPO
        idx_mat = np.zeros((U, CAPO), np.int64)
        val_mat = np.zeros((U, CAPO), bool)
        idx_mat[gid[keep], pos[keep]] = ordr2[keep]
        val_mat[gid[keep], pos[keep]] = True
        D = self.kf_desc[kk[idx_mat], slots[idx_mat]]      # (U,CAPO,8)
        x = D[:, :, None, :] ^ D[:, None, :, :]            # (U,CAPO,CAPO,8)
        h = (POP[x & 0xFF] + POP[(x >> 8) & 0xFF]
             + POP[(x >> 16) & 0xFF] + POP[(x >> 24) & 0xFF]).sum(-1)
        h = np.where(val_mat[:, None, :], h.astype(np.float64), np.nan)
        with np.errstate(all="ignore"):
            med = np.nanmedian(h, axis=2)
        med = np.where(val_mat, med, np.inf)
        best = np.argmin(med, axis=1)
        multi = counts >= 2
        if multi.any():
            self.mp_desc[uniq[multi]] = D[np.arange(U)[multi], best[multi]]

    def merge_points(self, keep_id: int, drop_id: int):
        """MapPoint::Replace equivalent: re-point every observation of
        `drop_id` at `keep_id` (unless the keyframe already observes keep_id)
        and tombstone drop_id."""
        if keep_id == drop_id or not self.mp_valid[drop_id]:
            return
        kk, slots = np.nonzero(self.kf_obs_mp == drop_id)
        has_keep = (self.kf_obs_mp[kk] == keep_id).any(axis=1)
        # KFs already observing keep drop the duplicate; others re-point
        self.kf_obs_mp[kk, slots] = np.where(has_keep, -1, keep_id)
        self.mp_found[keep_id] += self.mp_found[drop_id]
        self.mp_visible[keep_id] += self.mp_visible[drop_id]
        self.mp_valid[drop_id] = False
        self.change_index += 1

    def remove_points(self, ids: np.ndarray):
        ids = np.asarray(ids, np.int32)
        ids = ids[ids >= 0]
        self.mp_valid[ids] = False
        # clear observations referencing them
        mask = np.isin(self.kf_obs_mp, ids)
        self.kf_obs_mp[mask] = -1
        self.change_index += 1

    # -- observation graph ---------------------------------------------------
    def observation_count(self) -> np.ndarray:
        """(P,) number of keyframes observing each map point."""
        P = self.cfg.max_points
        counts = np.zeros(P, np.int64)
        obs = self.kf_obs_mp[self.kf_valid]
        flat = obs[obs >= 0]
        np.add.at(counts, flat, 1)
        return counts

    def incidence(self) -> np.ndarray:
        """(M, P) bool: keyframe k observes point p.

        NOTE: dense host allocation — O(max_keyframes * max_points). Only
        for small fixtures/debug; production paths use `observations_of`
        (COO) or the device covisibility matmul below."""
        M, P = self.cfg.max_keyframes, self.cfg.max_points
        inc = np.zeros((M, P), bool)
        kk, slots = np.nonzero(self.kf_obs_mp >= 0)
        inc[kk, self.kf_obs_mp[kk, slots]] = True
        inc[~self.kf_valid] = False
        inc[:, ~self.mp_valid] = False
        return inc

    # -- covisibility (device) ----------------------------------------------
    def _obs_matrix(self):
        """Cached device 0/1 observation matrix over LIVE keyframes: the
        weight graph W = A A^T is one product over (live keyframes x point
        tier). Rows are padded to a power of two, as the reference pads its
        compiled shapes. Cache keyed by change_index; callers hold the map
        lock.

        Returns (A (Kp, P) on the map's device, live kfs (n,), row_of (M,)
        int32 with -1 for dead slots)."""
        key = (self.change_index, self.cfg.max_keyframes,
               self.cfg.max_points)
        c = getattr(self, '_covis_cache', None)
        if c is not None and c[0] == key:
            return c[1], c[2], c[3]
        kfs = np.nonzero(self.kf_valid)[0]
        Kp = 64
        while Kp < len(kfs):
            Kp *= 2
        row_of = np.full(self.cfg.max_keyframes, -1, np.int32)
        row_of[kfs] = np.arange(len(kfs), dtype=np.int32)
        kk, slots = np.nonzero(self.kf_valid[:, None] & (self.kf_obs_mp >= 0))
        mm = self.kf_obs_mp[kk, slots]
        keep = self.mp_valid[mm]
        kk, mm = kk[keep], mm[keep]
        E = len(kk)
        Ep = 1024
        while Ep < E:
            Ep *= 2
        rows = np.full(Ep, Kp, np.int32)        # padding -> dump row Kp
        cols = np.zeros(Ep, np.int32)
        rows[:E] = row_of[kk]
        cols[:E] = mm
        A = _scatter_obs(rows, cols, Kp, self.cfg.max_points, self.device)
        self._covis_cache = (key, A, kfs, row_of)
        return A, kfs, row_of

    def _covis_w(self):
        """Host copy of the full live-KF weight matrix W = A A^T, cached by
        change_index alongside the observation matrix: one product and one
        fetch per map change serve every covisibility query until then."""
        A, live, row_of = self._obs_matrix()
        key = (self.change_index, self.cfg.max_keyframes,
               self.cfg.max_points)
        c = getattr(self, '_covis_w_cache', None)
        if c is None or c[0] != key:
            c = (key, _covis_matmul(A))
            self._covis_w_cache = c
        return c[1], live, row_of

    def covis_weights(self, kfs: np.ndarray) -> np.ndarray:
        """(len(kfs), len(kfs)) shared-observation counts via the device
        product (reference KeyFrame::UpdateConnections weight semantics)."""
        W, live, row_of = self._covis_w()
        rows = row_of[np.asarray(kfs)]
        if (rows < 0).any():
            out = np.zeros((len(kfs), len(kfs)), np.int64)
            ok = rows >= 0
            sub = W[np.ix_(rows[ok], rows[ok])]
            out[np.ix_(ok.nonzero()[0], ok.nonzero()[0])] = sub
            return out
        return W[np.ix_(rows, rows)].astype(np.int64)

    def covisibility(self, k: int, min_shared: int = 15) -> np.ndarray:
        """KF ids sharing >= min_shared map points with KF k, sorted by
        weight descending (reference KeyFrame::GetBestCovisibilityKeyFrames /
        UpdateConnections). Reads a row of the cached host weight matrix
        (one device product per map change)."""
        W, live, row_of = self._covis_w()
        r = int(row_of[k]) if 0 <= k < len(row_of) else -1
        if r < 0 or len(live) == 0:
            return np.zeros(0, np.int64)
        w_live = W[r, :len(live)].copy()
        w_live[r] = 0
        sel = np.nonzero(w_live >= min_shared)[0]
        order = sel[np.argsort(-w_live[sel])]
        return live[order].astype(np.int64)

    def observations_of(self, mp_ids: np.ndarray):
        """All (kf, slot) observations of the given points as COO arrays."""
        sel = np.zeros(self.cfg.max_points + 1, bool)
        sel[mp_ids[mp_ids >= 0]] = True
        kk, slots = np.nonzero(self.kf_valid[:, None] & (self.kf_obs_mp >= 0))
        mp = self.kf_obs_mp[kk, slots]
        keep = sel[mp]
        return kk[keep], slots[keep], mp[keep]

