"""Loop closing and map merging: place recognition -> Sim3 -> correction.

Port of `orbslam3_tpu/engine/loop_closing.py` (ORB-SLAM3's `LoopClosing`):

- detection (`NewDetectCommonRegions`): the keyframe database's N best
  candidates outside the keyframe's covisible set; a loop needs the same
  candidate group in `consistency_threshold` consecutive keyframes, chains
  kept per map and per candidate group; a candidate in a stored map is a
  merge at once;
- verification (`DetectCommonRegionsFromBoW`): the two keyframes' features
  that carry points matched both ways under K1 policy "loop", Sim3 RANSAC
  and its refinement (`vision/sim3.py`);
- `CorrectLoop`: the corrected Sim3 spread through the current keyframe's
  covisible window, its points re-expressed, the loop side's points fused
  into the window (K1 "fuse"), the essential graph (`opt/pose_graph.py`:
  Sim3 for mono, SE(3) with `fix_scale`, 4-DoF inertial), then global BA
  (`engine/global_ba.py`, on its thread unless `gba_background` is off);
- `MergeLocal`: the active map welded into the stored one
  (`Atlas.weld`), the seam fused, the welding window optimized (a window
  BA, or `merge_inertial_ba` on inertial maps), the merge essential graph
  over the rest of the welded map, then global BA.

Numerics run on `device` (the card unless ``device="cpu"``); the host
glues them to the map arrays. Sim3 RANSAC samples come from a generator
seeded once, or from `sample_fn(n)` -> (256, 3) indices, as the parity
tests pass the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from orbslam3_tpu_torch import device as device_policy
from orbslam3_tpu_torch.convert import words_to_int32
from orbslam3_tpu_torch.core import lie
from orbslam3_tpu_torch.engine.global_ba import GlobalBA
from orbslam3_tpu_torch.kernels import hamming as ham
from orbslam3_tpu_torch.opt.ba import BAProblem, bundle_adjust
from orbslam3_tpu_torch.opt.pose_graph import (DOF_4DOF, DOF_SE3, DOF_SIM3, PoseGraph,
                                               correct_points, optimize_pose_graph)
from orbslam3_tpu_torch.place.database import KeyFrameDatabase
from orbslam3_tpu_torch.slam_map.atlas import Atlas
from orbslam3_tpu_torch.slam_map.map_state import MapState
from orbslam3_tpu_torch.utils import timing
from orbslam3_tpu_torch.vision import matcher
from orbslam3_tpu_torch.vision.sim3 import optimize_sim3, sim3_ransac


@dataclasses.dataclass
class LoopCloserConfig:
    min_kfs_in_map: int = 12        # the map-size guard of detection
    min_bow_matches: int = 20       # SearchByBoW match gate
    min_sim3_inliers: int = 20      # Sim3Solver success gate
    consistency_threshold: int = 3  # mnLoopNumCoincidences
    covis_weight_essential: int = 30  # the reference uses 100 on big maps
    fix_scale: bool = False         # stereo / RGB-D / inertial: True
    inertial: bool = False          # IMU maps: 4-DoF essential graph + gates
    run_global_ba: bool = True
    gba_iters: int = 10
    n_best_candidates: int = 3
    # inertial loop sanity gates
    max_pitch_roll_rad: float = 0.008
    merge_scale_range: tuple = (0.9, 1.1)


@dataclasses.dataclass
class LoopEvent:
    kind: str            # "loop" | "merge"
    kf: int
    matched_kf: int
    scale: float
    n_inliers: int


def _dof(cfg: LoopCloserConfig) -> tuple:
    """The essential graph's gauge per sensor: 4-DoF inertial, SE(3) with a
    fixed scale, Sim(3) for mono."""
    return DOF_4DOF if cfg.inertial else DOF_SE3 if cfg.fix_scale else DOF_SIM3


class LoopCloser:
    """Host actor: consumes keyframes, detects and corrects loops and merges."""

    def __init__(self, camera, atlas: Atlas, db: KeyFrameDatabase,
                 cfg: LoopCloserConfig | None = None, imu_calib=None, device=None,
                 sample_fn: Callable | None = None):
        self.device = device_policy.resolve(device)
        self.camera = camera.to(self.device)
        self.atlas = atlas
        self.db = db
        self.cfg = cfg or LoopCloserConfig()
        self.imu_calib = imu_calib  # enables merge_inertial_ba on merges
        # temporal-consistency chains per map: map_id -> [(uid group, count)]
        self._chains: dict[int, list[tuple[set[int], int]]] = {}
        self._gen = torch.Generator().manual_seed(1234)
        self.sample_fn = sample_fn
        self.events: list[LoopEvent] = []
        self.gba = GlobalBA(camera, iters_per_block=5,
                            n_blocks=max(1, -(-self.cfg.gba_iters // 5)), device=self.device)
        # run global BA inline instead of on its thread (deterministic runs)
        self.gba_background = True

    def _t(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------ api
    def process_keyframe(self, k: int) -> LoopEvent | None:
        """InsertKeyFrame + one pass of the Run loop for keyframe slot `k` of
        the active map. Returns the loop or merge event if one was closed."""
        m = self.atlas.active
        self._ensure_cull_hook(m)
        with timing.stage("lc.bow"):
            _, bow = self.db.compute_bow(m.kf_desc[k], m.kf_feat_valid[k])
        event = None
        # inertial maps look for places only after VIBA2, when scale and
        # gravity have settled
        viba_ok = (not self.cfg.inertial) or m.iba_stage >= 2
        if m.n_keyframes >= self.cfg.min_kfs_in_map and viba_ok:
            event = self._detect_and_correct(m, k, bow)
        self.db.add(k, bow, map_id=m.map_id)
        return event

    # ------------------------------------------------------------ detection
    def _covis(self, m: MapState, kf: int) -> list[int]:
        return [int(x) for x in m.covisibility(kf, min_shared=10)]

    def _ensure_cull_hook(self, m: MapState):
        """Register the database erase on this map once: a culled keyframe's
        row goes before its slot is reused."""
        if any(getattr(cb, '_kfdb_hook', False) for cb in m.on_kf_removed):
            return

        def hook(slot, _mid=m.map_id, _db=self.db):
            _db.erase(slot, map_id=_mid)

        hook._kfdb_hook = True
        m.on_kf_removed.append(hook)

    def _covis_by_map(self, mid: int, slot: int):
        """Cross-map covisibility for the database's group accumulation."""
        mm = self.atlas.maps.get(mid)
        if mm is None or slot >= len(mm.kf_valid) or not mm.kf_valid[slot]:
            return []
        return self._covis(mm, slot)

    def _detect_and_correct(self, m: MapState, k: int, bow) -> LoopEvent | None:
        cfg = self.cfg
        exclude = {int(k)} | set(int(x) for x in m.covisibility(k, min_shared=5))
        with timing.stage("lc.detect"):
            cands = self.db.detect_n_best_candidates(
                bow, exclude, self._covis_by_map, n_best=cfg.n_best_candidates,
                exclude_map_id=m.map_id)
        prev_chains = self._chains.get(m.map_id, [])
        new_chains: list[tuple[set[int], int]] = []
        fired = None
        for cand_map_id, cand in cands:
            cand = int(cand)
            if cand_map_id == m.map_id:
                res = self._verify_sim3(m, cand, m, k)  # S_cur<-cand
                if res is None:
                    continue
                s, R, t, n_inl = res
                # a candidate extends a chain when its covisible group meets
                # the chain's group of the previous keyframe
                group = {int(m.kf_uid[cand])} | {int(m.kf_uid[c])
                                                 for c in self._covis(m, cand)}
                count = 1 + max((c for g, c in prev_chains if g & group), default=0)
                new_chains.append((group, count))
                if count >= cfg.consistency_threshold and fired is None:
                    # inertial maps: the correction must be near yaw-only
                    if cfg.inertial and not self._yaw_only_ok(R):
                        continue
                    with timing.stage("lc.correct"):
                        self._correct_loop(m, k, cand, s, R, t)
                    fired = LoopEvent("loop", k, cand, float(s), int(n_inl))
                    self.events.append(fired)
            else:
                # the candidate lives in a stored map: merge
                other = self.atlas.maps.get(cand_map_id)
                if other is None or not other.kf_valid[cand]:
                    continue
                res = self._verify_sim3(other, cand, m, k)
                if res is None:
                    continue
                s, R, t, n_inl = res
                if cfg.inertial:
                    lo, hi = cfg.merge_scale_range
                    if m.imu_initialized and not lo <= float(s) <= hi:
                        continue
                    if not self._yaw_only_ok(R):
                        continue
                with timing.stage("lc.merge"):
                    ev = self._merge_maps(m, k, other, cand, s, R, t, int(n_inl))
                self.events.append(ev)
                self._chains.pop(m.map_id, None)
                return ev
        # chains this keyframe did not extend die; a loop clears the map's
        self._chains[m.map_id] = [] if fired is not None else new_chains
        return fired

    def _yaw_only_ok(self, R) -> bool:
        """Inertial maps observe gravity: accept only corrections whose
        pitch and roll stay under `max_pitch_roll_rad`."""
        phi = lie.so3_log(torch.as_tensor(np.asarray(R), dtype=torch.float32)).numpy()
        thr = self.cfg.max_pitch_roll_rad
        return abs(float(phi[0])) < thr and abs(float(phi[1])) < thr

    def _matched_mp_pairs(self, m1: MapState, k1: int, m2: MapState, k2: int):
        """`SearchByBoW` for verification: the features of keyframe k1 that
        carry a point matched against those of k2 (ratio 0.75, both ways,
        mutual) under K1 policy "loop"; pairs whose points both live.
        Returns (mp1_ids, mp2_ids, uv1, uv2)."""
        has1 = m1.kf_feat_valid[k1] & (m1.kf_obs_mp[k1] >= 0)
        has2 = m2.kf_feat_valid[k2] & (m2.kf_obs_mp[k2] >= 0)
        mask = self._t(has1)[:, None] & self._t(has2)[None, :]
        idx, _, ok = matcher._both_ways(
            self._t(words_to_int32(m1.kf_desc[k1])), self._t(words_to_int32(m2.kf_desc[k2])),
            mask, ham.TH_LOW, 0.75, "loop")
        f1 = np.nonzero(ok.cpu().numpy())[0]
        f2 = idx.cpu().numpy()[f1]
        mp1, mp2 = m1.kf_obs_mp[k1][f1], m2.kf_obs_mp[k2][f2]
        good = (mp1 >= 0) & (mp2 >= 0) & m1.mp_valid[np.maximum(mp1, 0)] \
            & m2.mp_valid[np.maximum(mp2, 0)]
        return mp1[good], mp2[good], m1.kf_uv[k1][f1[good]], m2.kf_uv[k2][f2[good]]

    def _samples(self, n: int):
        if self.sample_fn is not None:
            return torch.as_tensor(np.array(self.sample_fn(n)))
        return None

    def _verify_sim3(self, m_cand: MapState, cand: int, m_cur: MapState, cur: int):
        """Sim3 RANSAC + refinement between a candidate and the current
        keyframe. Returns S_cur<-cand = (s, R, t, n_inliers) mapping
        candidate-camera to current-camera coordinates, or None."""
        cfg = self.cfg
        with timing.stage("lc.sim3"):
            mp_cand, mp_cur, uv_cand, uv_cur = self._matched_mp_pairs(m_cand, cand, m_cur, cur)
            n = len(mp_cand)
            if n < cfg.min_bow_matches:
                return None
            p_cand = self._t(m_cand.mp_pos[mp_cand] @ m_cand.kf_R[cand].T + m_cand.kf_t[cand],
                             torch.float32)
            p_cur = self._t(m_cur.mp_pos[mp_cur] @ m_cur.kf_R[cur].T + m_cur.kf_t[cur],
                            torch.float32)
            uv1, uv2 = self._t(uv_cand, torch.float32), self._t(uv_cur, torch.float32)
            valid = torch.ones(n, dtype=torch.bool, device=self.device)
            res = sim3_ransac(p_cand, p_cur, uv1, uv2, valid, self.camera, self.camera,
                              generator=self._gen, samples=self._samples(n),
                              fix_scale=cfg.fix_scale)
            if int(res.n_inliers) < cfg.min_sim3_inliers:
                return None
            s, R, t, _, n_inl = optimize_sim3(
                res.s, res.R, res.t, p_cand, p_cur, uv1, uv2,
                torch.ones(n, device=self.device), res.inliers, self.camera, self.camera,
                fix_scale=cfg.fix_scale)
            if int(n_inl) < cfg.min_sim3_inliers:
                return None
            return float(s), R.cpu().numpy(), t.cpu().numpy(), int(n_inl)

    # ----------------------------------------------------------- correction
    def _sim3(self, s, R, t):
        return (torch.as_tensor(np.float32(s)), torch.as_tensor(np.asarray(R, np.float32)),
                torch.as_tensor(np.asarray(t, np.float32)))

    def _correct_points(self, pts, old, new):
        """`correct_points` of (P,3) host points on the device: old and new
        (s, R, t) similarities of their reference keyframe."""
        out = correct_points(self._t(pts, torch.float32),
                             *(x.to(self.device) for x in self._sim3(*old)),
                             *(x.to(self.device) for x in self._sim3(*new)))
        return out.cpu().numpy().astype(np.float32)

    def _correct_loop(self, m: MapState, cur: int, cand: int, s: float, R, t):
        """CorrectLoop: spread the corrected Sim3 through the current
        keyframe's covisible window, re-express its points, fuse the loop
        side's points, optimize the essential graph, then global BA."""
        cfg = self.cfg
        self.gba.abort_and_join()  # a new loop stops the global BA in flight
        # corrected S_cw(cur) = S_cur<-cand o T_cand_w
        s_corr, R_corr, t_corr = lie.sim3_compose(
            *self._sim3(s, R, t), *self._sim3(1.0, m.kf_R[cand], m.kf_t[cand]))
        s_corr = float(s_corr)
        R_corr, t_corr = R_corr.numpy(), t_corr.numpy()
        # all map mutation below runs under the map lock (mMutexMapUpdate)
        with m.lock:
            window = [cur] + self._covis(m, cur)
            old_R = {int(i): m.kf_R[i].copy() for i in m.keyframe_ids()}
            old_t = {int(i): m.kf_t[i].copy() for i in m.keyframe_ids()}
            corrected: dict[int, tuple[float, np.ndarray, np.ndarray]] = {}
            Rc, tc = old_R[cur], old_t[cur]
            for i in window:
                # T_ic = T_iw o T_wc (uncorrected, SE3)
                R_ic = old_R[i] @ Rc.T
                t_ic = old_t[i] - R_ic @ tc
                si, Ri, ti = lie.sim3_compose(*self._sim3(1.0, R_ic, t_ic),
                                              *self._sim3(s_corr, R_corr, t_corr))
                corrected[i] = (float(si), Ri.numpy(), ti.numpy())
            # the window's points, once each, through their first window KF
            done = set()
            for i in window:
                mp_ids = m.kf_obs_mp[i]
                mp_ids = np.unique(mp_ids[mp_ids >= 0])
                mp_ids = np.asarray([p for p in mp_ids if p not in done and m.mp_valid[p]],
                                    np.int64)
                done.update(int(p) for p in mp_ids)
                if len(mp_ids) == 0:
                    continue
                m.mp_pos[mp_ids] = self._correct_points(
                    m.mp_pos[mp_ids], (1.0, old_R[i], old_t[i]), corrected[i])
            # corrected SE3 poses (t / s)
            for i, (si, Ri, ti) in corrected.items():
                m.kf_R[i] = Ri.astype(np.float32)
                m.kf_t[i] = (ti / si).astype(np.float32)
            with timing.stage("lc.fuse"):
                self._search_and_fuse(m, window, cand)
            with timing.stage("lc.essential_graph"):
                self._optimize_essential_graph(m, cur, cand, s, R, t, corrected, old_R, old_t)
            m.change_index += 1
        if cfg.run_global_ba:
            with timing.stage("lc.gba"):
                self.gba.request(m, fixed_kf=cand, background=self.gba_background)

    def _search_and_fuse(self, m: MapState, window: list[int], cand: int):
        """SearchAndFuse: project the points seen around the loop keyframe
        into each corrected window keyframe (K1 policy "fuse") and merge
        duplicates."""
        loop_side = [cand] + [int(x) for x in m.covisibility(cand, 10)[:10]]
        obs = m.kf_obs_mp[loop_side]
        loop_mps = np.unique(obs[obs >= 0])
        loop_mps = loop_mps[m.mp_valid[loop_mps]]
        if len(loop_mps) == 0:
            return
        mp_pos = self._t(m.mp_pos[loop_mps])
        mp_desc = self._t(words_to_int32(m.mp_desc[loop_mps]))
        valid = torch.ones(len(loop_mps), dtype=torch.bool, device=self.device)
        for i in window:
            idx, keep = matcher.fuse_by_projection(
                mp_pos, mp_desc, valid, self._t(m.kf_R[i]), self._t(m.kf_t[i]),
                self.camera, self._t(m.kf_uv[i]), self._t(words_to_int32(m.kf_desc[i])),
                self._t(m.kf_octave[i]), self._t(m.kf_feat_valid[i]), radius=4.0)
            idx, keep = idx.cpu().numpy(), keep.cpu().numpy()
            for j in np.nonzero(keep)[0]:
                feat = int(idx[j])
                keep_id = int(loop_mps[j])
                existing = int(m.kf_obs_mp[i, feat])
                if existing == keep_id:
                    continue
                if existing >= 0 and m.mp_valid[existing]:
                    m.merge_points(keep_id, existing)
                elif m.kf_obs_mp[i][m.kf_obs_mp[i] == keep_id].size == 0:
                    m.kf_obs_mp[i, feat] = keep_id

    def _graph_edges(self, m: MapState, kfs: np.ndarray):
        """Spanning-tree (temporal chain) and covisibility (weight >=
        covis_weight_essential) pairs over the live keyframes, each once,
        as (a, b) slots with a < b."""
        W_live = m.covis_weights(kfs)
        ai, bi = np.nonzero(W_live >= self.cfg.covis_weight_essential)
        keep = ai < bi
        a_c, b_c = np.asarray(kfs)[ai[keep]], np.asarray(kfs)[bi[keep]]
        prev = m.kf_prev[kfs]
        has_p = (prev >= 0) & m.kf_valid[np.maximum(prev, 0)]
        a_t = np.minimum(np.asarray(kfs)[has_p], prev[has_p])
        b_t = np.maximum(np.asarray(kfs)[has_p], prev[has_p])
        a_all, b_all = np.concatenate([a_t, a_c]), np.concatenate([b_t, b_c])
        _, first = np.unique(a_all.astype(np.int64) * m.cfg.max_keyframes + b_all,
                             return_index=True)
        return a_all[first], b_all[first]

    def _solve_graph(self, s0, R0, t0, e_i, e_j, m_s, m_R, m_t, dof):
        f32 = torch.float32
        g = PoseGraph(s=self._t(s0, f32), R=self._t(R0, f32), t=self._t(t0, f32),
                      e_i=self._t(e_i, torch.int64), e_j=self._t(e_j, torch.int64),
                      m_s=self._t(m_s, f32), m_R=self._t(m_R, f32), m_t=self._t(m_t, f32),
                      w=torch.ones(len(e_i), dtype=f32, device=self.device),
                      dof=self._t(dof, f32))
        return (x.cpu().numpy() for x in optimize_pose_graph(g))

    def _optimize_essential_graph(self, m: MapState, cur: int, cand: int,
                                  s_loop, R_loop, t_loop, corrected, old_R, old_t):
        """OptimizeEssentialGraph: spanning tree + covisibility + the loop
        edge over every keyframe of the map; points follow their reference
        keyframe."""
        kfs = m.keyframe_ids()
        slot = {int(k): i for i, k in enumerate(kfs)}
        M = len(kfs)
        s0 = np.ones(M, np.float32)
        R0, t0 = m.kf_R[kfs].copy(), m.kf_t[kfs].copy()
        for k, (si, Ri, ti) in corrected.items():
            i = slot[int(k)]
            s0[i], R0[i], t0[i] = si, Ri, ti
        a_all, b_all = self._graph_edges(m, kfs)
        # relative measurements from the poses before the correction
        # (NonCorrectedSim3): R_ba = R_b R_a^T, t_ba = t_b - R_ba t_a
        oldR_a = np.tile(np.eye(3, dtype=np.float32), (m.cfg.max_keyframes, 1, 1))
        oldt_a = np.zeros((m.cfg.max_keyframes, 3), np.float32)
        for i, Rv in old_R.items():
            oldR_a[int(i)] = Rv
        for i, tv in old_t.items():
            oldt_a[int(i)] = tv
        Ra, ta, Rb, tb = oldR_a[a_all], oldt_a[a_all], oldR_a[b_all], oldt_a[b_all]
        R_ba = Rb @ np.swapaxes(Ra, 1, 2)
        t_ba = tb - np.einsum("eij,ej->ei", R_ba, ta)
        slot_arr = np.full(m.cfg.max_keyframes, -1, np.int64)
        slot_arr[kfs] = np.arange(M)
        # the loop edge, S_ji (j = cur, i = cand) = the Sim3 solve's S_cur<-cand
        e_i = np.append(slot_arr[a_all], slot[cand])
        e_j = np.append(slot_arr[b_all], slot[cur])
        m_s = np.append(np.ones(len(a_all), np.float32), np.float32(s_loop))
        m_R = np.concatenate([R_ba.reshape(-1, 3, 3), np.asarray(R_loop)[None]])
        m_t = np.concatenate([t_ba.reshape(-1, 3), np.asarray(t_loop)[None]])
        dof = np.tile(np.asarray(_dof(self.cfg), np.float32), (M, 1))
        dof[slot[cand]] = 0.0  # the loop keyframe is fixed
        s_new, R_new, t_new = self._solve_graph(s0, R0, t0, e_i, e_j, m_s, m_R, m_t, dof)
        # points through their reference keyframe's old and new transforms,
        # then the SE3 poses (t / s)
        mp_ids = np.nonzero(m.mp_valid)[0]
        ref = m.mp_ref_kf[mp_ids]
        for k in kfs:
            k = int(k)
            sel = mp_ids[ref == k]
            if len(sel) == 0:
                continue
            i = slot[k]
            old = corrected[k] if k in corrected else (1.0, old_R[k], old_t[k])
            m.mp_pos[sel] = self._correct_points(m.mp_pos[sel], old,
                                                 (s_new[i], R_new[i], t_new[i]))
        for k in kfs:
            i = slot[int(k)]
            m.kf_R[k] = R_new[i].astype(np.float32)
            m.kf_t[k] = (t_new[i] / s_new[i]).astype(np.float32)

    # ------------------------------------------------------------- global BA
    def _ba(self, m: MapState, kfs, mp_ids, kk, ss, mm, fixed, n_iters: int):
        """`bundle_adjust` over keyframes `kfs` and points `mp_ids` with the
        (keyframe, slot, point) observations; returns the solved problem."""
        kf_lut = np.full(m.cfg.max_keyframes, -1, np.int64)
        kf_lut[kfs] = np.arange(len(kfs))
        lm_lut = np.full(m.cfg.max_points, -1, np.int64)
        lm_lut[mp_ids] = np.arange(len(mp_ids))
        info = (1.0 / 1.2 ** (2 * m.kf_octave[kk, ss])).astype(np.float32)
        prob = BAProblem(
            R=self._t(m.kf_R[kfs]), t=self._t(m.kf_t[kfs]), points=self._t(m.mp_pos[mp_ids]),
            kf_idx=self._t(kf_lut[kk]), lm_idx=self._t(lm_lut[mm]),
            uv=self._t(m.kf_uv[kk, ss], torch.float32), info=self._t(info),
            valid=torch.ones(len(kk), dtype=torch.bool, device=self.device),
            fixed_kf=self._t(fixed),
            fixed_lm=torch.zeros(len(mp_ids), dtype=torch.bool, device=self.device))
        out, _, _ = bundle_adjust(prob, self.camera, n_iters=n_iters)
        return out

    def run_global_ba(self, m: MapState, fixed_kf: int, n_iters: int = 10):
        """RunGlobalBundleAdjustment, inline over the whole map."""
        kfs = m.keyframe_ids()
        mp_ids = np.nonzero(m.mp_valid)[0]
        if len(mp_ids) == 0 or len(kfs) < 2:
            return
        kk, slots, mps = m.observations_of(mp_ids)
        if len(kk) == 0:
            return
        fixed = np.zeros(len(kfs), bool)
        hit = np.nonzero(kfs == int(fixed_kf))[0]
        fixed[hit[0] if len(hit) else 0] = True
        out = self._ba(m, kfs, mp_ids, kk, slots, mps, fixed, n_iters)
        m.kf_R[kfs] = out.R.cpu().numpy()
        m.kf_t[kfs] = out.t.cpu().numpy()
        m.mp_pos[mp_ids] = out.points.cpu().numpy()
        m.change_index += 1

    # ---------------------------------------------------------------- merges
    def _merge_maps(self, m_cur: MapState, cur: int, m_old: MapState, cand: int,
                    s: float, R, t, n_inl: int) -> LoopEvent:
        """MergeLocal: weld the active map into the stored one through
        S_cur<-cand, fuse the seam, optimize the welding window, spread the
        correction over the welded map, then global BA. The stored map keeps
        its gauge."""
        # world to world (old -> cur): S = T_cur_w^-1 o S_cur<-cand o T_cand_w
        s1, R1, t1 = lie.sim3_compose(*self._sim3(s, R, t),
                                      *self._sim3(1.0, m_old.kf_R[cand], m_old.kf_t[cand]))
        sw, Rw, tw = lie.sim3_compose(
            *lie.sim3_inverse(*self._sim3(1.0, m_cur.kf_R[cur], m_cur.kf_t[cur])), s1, R1, t1)
        # weld the current map into the old one: cur-world -> old-world
        si, Ri, ti = lie.sim3_inverse(sw, Rw, tw)
        kf_map = self.atlas.weld(m_old.map_id, m_cur.map_id, float(si), Ri.numpy(),
                                 ti.numpy())
        self.db.clear_map(m_cur.map_id)
        merged = self.atlas.maps[m_old.map_id]
        for new_slot in kf_map.values():  # the welded keyframes, under the merged map
            _, bow = self.db.compute_bow(merged.kf_desc[new_slot],
                                         merged.kf_feat_valid[new_slot])
            self.db.add(new_slot, bow, map_id=merged.map_id)
        new_cur = kf_map[int(cur)]
        # the poses before the window BA: the merge essential graph's
        # relative measurements
        pre_kfs = merged.keyframe_ids()
        pre_R = {int(i): merged.kf_R[i].copy() for i in pre_kfs}
        pre_t = {int(i): merged.kf_t[i].copy() for i in pre_kfs}
        welded = set(int(v) for v in kf_map.values())
        with timing.stage("lc.fuse"):
            self._search_and_fuse(merged, [new_cur, cand], cand)
        if self.cfg.inertial and merged.imu_initialized and self.imu_calib is not None:
            # MergeInertialBA: two temporal windows, one ending at the
            # current keyframe and one at the matched one, each with its
            # inertial chain, coupled through the fused seam points
            from orbslam3_tpu_torch.imu import init as imu_init
            imu_init.merge_inertial_ba(merged, self.imu_calib, self.camera, new_cur, cand,
                                       n_iters=self.cfg.gba_iters, window=10,
                                       device=self.device)
            seam = {new_cur, cand}
            for root in (new_cur, cand):
                p, steps = int(root), 0
                while p >= 0 and merged.kf_valid[p] and steps < 10:
                    seam.add(int(p))
                    p = int(merged.kf_prev[p])
                    steps += 1
        else:
            # the welding-window BA: the seam neighbourhoods move, the rest
            # of the merged map stays
            seam = {new_cur, cand}
            for root in (new_cur, cand):
                for nb in merged.covisibility(root, min_shared=10)[:8]:
                    seam.add(int(nb))
            with timing.stage("lc.window_ba"):
                self._window_ba(merged, sorted(seam), n_iters=self.cfg.gba_iters)
        # spread the window's correction over the welded map (the merge
        # essential graph), the window itself held fixed, then global BA
        with merged.lock:
            with timing.stage("lc.essential_graph"):
                self._merge_essential_graph(merged, welded, sorted(seam), pre_R, pre_t)
            merged.change_index += 1
        if self.cfg.run_global_ba:
            with timing.stage("lc.gba"):
                self.gba.request(merged, fixed_kf=cand, background=self.gba_background)
        ev = LoopEvent("merge", new_cur, cand, float(s), n_inl)
        ev.kf_map = kf_map  # type: ignore[attr-defined]
        return ev

    def _merge_essential_graph(self, m: MapState, welded: set[int], window: list[int],
                               pre_R: dict, pre_t: dict):
        """The merge overload of OptimizeEssentialGraph: the stored map and
        the welding window stay at their poses; the other welded keyframes
        move over spanning-tree + covisibility edges measured on the poses
        before the window BA."""
        kfs = m.keyframe_ids()
        M = len(kfs)
        if M < 3:
            return
        slot = {int(k): i for i, k in enumerate(kfs)}
        win = set(window)
        free = [k for k in kfs if int(k) in welded and int(k) not in win]
        if not free:
            return
        a_all, b_all = self._graph_edges(m, kfs)
        if len(a_all) == 0:
            return
        # an edge needs a free end and both ends in the welded map: pairs
        # across the seam measure the old misalignment
        free_set = set(int(k) for k in free)
        fa = np.asarray([int(x) in free_set for x in a_all])
        fb = np.asarray([int(x) in free_set for x in b_all])
        wa = np.asarray([int(x) in welded for x in a_all])
        wb = np.asarray([int(x) in welded for x in b_all])
        sel = (fa | fb) & wa & wb
        a_all, b_all = a_all[sel], b_all[sel]
        if len(a_all) == 0:
            return
        Ra = np.stack([pre_R.get(int(x), m.kf_R[int(x)]) for x in a_all])
        ta = np.stack([pre_t.get(int(x), m.kf_t[int(x)]) for x in a_all])
        Rb = np.stack([pre_R.get(int(x), m.kf_R[int(x)]) for x in b_all])
        tb = np.stack([pre_t.get(int(x), m.kf_t[int(x)]) for x in b_all])
        R_ba = Rb @ np.swapaxes(Ra, 1, 2)
        t_ba = tb - np.einsum("eij,ej->ei", R_ba, ta)
        dof = np.zeros((M, 7), np.float32)
        for k in free:
            dof[slot[int(k)]] = _dof(self.cfg)
        slot_arr = np.full(m.cfg.max_keyframes, -1, np.int64)
        slot_arr[kfs] = np.arange(M)
        s_new, R_new, t_new = self._solve_graph(
            np.ones(M, np.float32), m.kf_R[kfs].copy(), m.kf_t[kfs].copy(),
            slot_arr[a_all], slot_arr[b_all], np.ones(len(a_all), np.float32), R_ba, t_ba,
            dof)
        # the free keyframes move; their points follow their reference
        # keyframe's old and new poses
        mp_ids = np.nonzero(m.mp_valid)[0]
        ref = m.mp_ref_kf[mp_ids]
        for k in free:
            k = int(k)
            i = slot[k]
            sel_mp = mp_ids[ref == k]
            if len(sel_mp):
                m.mp_pos[sel_mp] = self._correct_points(
                    m.mp_pos[sel_mp], (1.0, m.kf_R[k], m.kf_t[k]),
                    (s_new[i], R_new[i], t_new[i]))
            m.kf_R[k] = R_new[i].astype(np.float32)
            m.kf_t[k] = (t_new[i] / s_new[i]).astype(np.float32)
        m.update_point_stats(mp_ids)

    def _window_ba(self, m: MapState, window: list[int], n_iters: int = 10,
                   fixed_cap: int = 12):
        """BA over a keyframe window and a fixed border of observers (the
        welding BA's shape)."""
        win = [k for k in window if m.kf_valid[k]]
        if len(win) < 2:
            return
        obs_w = m.kf_obs_mp[win]
        mp_ids = np.unique(obs_w[obs_w >= 0])
        mp_ids = mp_ids[m.mp_valid[mp_ids]]
        if len(mp_ids) == 0:
            return
        kk_o, _, _ = m.observations_of(mp_ids)
        win_set = set(win)
        fixed = [int(x) for x in np.unique(kk_o) if int(x) not in win_set][:fixed_cap]
        kfs = np.asarray(win + fixed, np.int64)
        in_kfs = np.zeros(m.cfg.max_keyframes, bool)
        in_kfs[kfs] = True
        kk, ss = np.nonzero(in_kfs[:, None] & np.isin(m.kf_obs_mp, mp_ids))
        mm = m.kf_obs_mp[kk, ss]
        if len(kk) == 0:
            return
        fixed_mask = np.zeros(len(kfs), bool)
        fixed_mask[len(win):] = True
        if not fixed:
            fixed_mask[0] = True  # gauge
        out = self._ba(m, kfs, mp_ids, kk, ss, mm, fixed_mask, n_iters)
        upd = ~fixed_mask
        m.kf_R[kfs[upd]] = out.R.cpu().numpy()[upd]
        m.kf_t[kfs[upd]] = out.t.cpu().numpy()[upd]
        m.mp_pos[mp_ids] = out.points.cpu().numpy()
        m.change_index += 1
