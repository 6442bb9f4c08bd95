"""Atlas: the multi-map registry with map spawn on loss and map welding.

Port of `orbslam3_tpu/slam_map/atlas.py` (ORB-SLAM3's `Atlas`): a set of
maps with one active; on tracking loss with a mature map the active map is
stored and a fresh one spawned (`Tracking::CreateMapInAtlas`); when place
recognition finds a revisit into a stored map the two maps are welded
(`LoopClosing::MergeLocal`).

Each map is a `MapState` (fixed-capacity SoA tensors); welding is a bulk
Sim3-transform of the source map's keyframes/landmarks followed by an array
append into the destination — no pointer surgery.
"""

from __future__ import annotations

import numpy as np

from orbslam3_tpu_torch import device as device_policy
from orbslam3_tpu_torch.slam_map.map_state import MapConfig, MapState


def _next_pow2(needed: int, at_least: int) -> int:
    """Smallest power-of-two-scaled tier >= needed."""
    n = at_least
    while n < needed:
        n *= 2
    return n


class Atlas:
    def __init__(self, cfg: MapConfig, device=None):
        self.cfg = cfg
        self.device = device_policy.resolve(device)
        self._next_map_id = 0
        self.maps: dict[int, MapState] = {}
        self.active_id = self.create_new_map()

    @property
    def active(self) -> MapState:
        return self.maps[self.active_id]

    def create_new_map(self) -> int:
        mid = self._next_map_id
        self._next_map_id += 1
        self.maps[mid] = MapState(self.cfg, map_id=mid, device=self.device)
        self.active_id = mid
        return mid

    def change_map(self, map_id: int):
        assert map_id in self.maps
        self.active_id = map_id

    def set_map_bad(self, map_id: int):
        """RemoveBadMaps equivalent: drop a degenerate map entirely."""
        if map_id in self.maps and map_id != self.active_id:
            del self.maps[map_id]

    def stored_maps(self) -> list[int]:
        return [m for m in self.maps if m != self.active_id]

    def adopt(self, m: MapState) -> int:
        """Register a foreign MapState as a STORED map, keeping the current
        active map (the analog of LoadAtlas merging a saved map set into the
        running Atlas)."""
        mid = self._next_map_id
        self._next_map_id += 1
        m.map_id = mid
        self.maps[mid] = m
        return mid

    def map_of_kf_uid(self, uid: int) -> int:
        for mid, m in self.maps.items():
            if m.slot_of_uid(uid) >= 0:
                return mid
        return -1

    # -- welding (MergeLocal's map surgery) -----------------------------------
    def weld(self, dst_id: int, src_id: int, s: float, R: np.ndarray,
             t: np.ndarray) -> dict[int, int]:
        """Move every keyframe/landmark of map `src` into map `dst`,
        transforming src-world coordinates into dst-world by the similarity
        x_dst = s * R @ x_src + t (the merge Sim3 from place recognition).

        Poses: T_cw_dst = T_cw_src o S^-1, i.e. R' = R_cw R^T,
        t' = s t - R' t_m (derived below); keyframe velocities are world
        vectors and map as s R v (the reference divides translation by scale
        when converting corrected Sim3 back to SE3, LoopClosing.cc
        MergeLocal corrected poses).

        Returns {src_kf_slot: dst_kf_slot} so callers (trackers, loop closer)
        can re-point their keyframe references.
        """
        dst, src = self.maps[dst_id], self.maps[src_id]
        Rm = np.asarray(R, np.float32)
        tm = np.asarray(t, np.float32)
        s = float(s)
        # tier the destination up-front so welding never silently drops
        # (drops now only happen at the hard ceiling, with loud events)
        dst.grow(max_keyframes=_next_pow2(dst.n_keyframes + src.n_keyframes,
                                          dst.cfg.max_keyframes),
                 max_points=_next_pow2(dst.n_points + src.n_points,
                                       dst.cfg.max_points))

        # landmarks: x_dst = s*R x_src + t
        mp_map = {}
        src_mp = np.nonzero(src.mp_valid)[0]
        new_pos = (s * src.mp_pos[src_mp] @ Rm.T + tm).astype(np.float32)
        ids = dst.add_points(pos=new_pos, desc=src.mp_desc[src_mp],
                             first_kf=-1)
        for old, new in zip(src_mp, ids):
            if new >= 0:
                mp_map[int(old)] = int(new)

        # keyframes: src pose maps src-world -> camera (src metric). Rescale
        # the camera metric by s so it matches the dst gauge:
        #   x_cam' = s * (R_cw x_src + t_cw)  with  x_src = (1/s) R^T (x_dst - t)
        #          = (R_cw R^T) x_dst + (s t_cw - R_cw R^T t)
        # i.e. R'_cw = R_cw R^T,  t'_cw = s t_cw - R'_cw t  (the Sim3->SE3
        # conversion in the reference's MergeLocal corrected-pose loop).
        kf_map = {}
        for k in src.keyframe_ids():
            Rp = (src.kf_R[k] @ Rm.T).astype(np.float32)
            tp = (s * src.kf_t[k] - Rp @ tm).astype(np.float32)
            obs = src.kf_obs_mp[k].copy()
            remapped = np.full_like(obs, -1)
            good = obs >= 0
            remapped[good] = [mp_map.get(int(o), -1) for o in obs[good]]
            prev = kf_map.get(int(src.kf_prev[k]), -1)
            nk = dst.add_keyframe(
                Rp, tp, src.kf_ts[k], src.kf_frame_id[k], src.kf_uv[k],
                src.kf_octave[k], src.kf_angle[k], src.kf_desc[k],
                src.kf_feat_valid[k], remapped, prev_kf=prev,
                vel=s * (Rm @ src.kf_vel[k]), bias=src.kf_bias[k],
                preint=src.kf_pre.get(int(k)),
                # stereo maps are metric (s = 1), so u - bf/z still holds;
                # the reference drops them here
                uright=src.kf_uright[k])
            if nk < 0:
                continue  # at the hard ceiling (loud drop event already fired)
            kf_map[int(k)] = nk
        del self.maps[src_id]
        self.active_id = dst_id
        return kf_map
