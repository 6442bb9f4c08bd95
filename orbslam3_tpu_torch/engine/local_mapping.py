"""Local mapping back end: map-point creation, fusion, local BA, culling.

Port of `orbslam3_tpu/engine/local_mapping.py` (ORB-SLAM3's `LocalMapping`),
for every sensor: `ProcessNewKeyFrame`,
`MapPointCulling`, `CreateNewMapPoints` (epipolar triangulation with
covisible neighbours), `SearchInNeighbors` (fuse), the local BA (over a
covisibility window, or over the last keyframes of the temporal chain with
their inertial edges once the IMU is initialized), the IMU initialization
ladder, and `KeyFrameCulling` with the inertial gates. It runs
synchronously when a keyframe is inserted.

The map stays on the host (numpy); each stage builds the padded device
tensors it needs on `device` (the card unless ``device="cpu"``). Keyframe
and map-point descriptors go to kernel K1 as the packed words the map
stores. With `bf` > 0 (stereo and RGB-D maps) the visual BA takes the
keyframes' right coordinates as stereo rows; with `fix_scale` the IMU
ladder holds the already metric scale at 1.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orbslam3_tpu_torch import device as device_policy
from orbslam3_tpu_torch.convert import words_to_int32
from orbslam3_tpu_torch.core import robust
from orbslam3_tpu_torch.imu import init as imu_init
from orbslam3_tpu_torch.imu import preintegration as preint
from orbslam3_tpu_torch.opt.ba import BAProblem, bundle_adjust
from orbslam3_tpu_torch.slam_map.map_state import MapState
from orbslam3_tpu_torch.utils import timing
from orbslam3_tpu_torch.vision import matcher
from orbslam3_tpu_torch.vision.triangulate import projection_matrix, triangulate_points


@dataclasses.dataclass
class LocalMapperConfig:
    triangulate_neighbors: int = 5    # reference: 10 (mono) covisible KFs
    window_kfs: int = 12              # local BA window cap
    fixed_kfs: int = 8                # fixed-border cap
    ba_points_cap: int = 4096
    ba_obs_cap: int = 16384
    ba_iters: int = 8
    culling_min_found_ratio: float = 0.25
    culling_obs_after: int = 3        # KFs after creation before obs test
    kf_cull_redundancy: float = 0.9   # reference: 90% redundant observations
    # IMU initialization ladder (reference LocalMapping.cc:185-244)
    imu_init_min_kfs: int = 8
    imu_init_min_span_s: float = 2.0  # mono needs ~2 s of excitation
    viba1_after_s: float = 5.0
    viba2_after_s: float = 15.0
    inertial_window_kfs: int = 10     # LocalInertialBA temporal window
    post_init_viba_iters: int = 24    # the full VI-BA after each rung
    scale_refine_every_s: float = 10.0  # mono ScaleRefinement cadence
    scale_refine_until_s: float = 75.0


class LocalMapper:
    def __init__(self, camera, slam_map: MapState, cfg: LocalMapperConfig = None,
                 imu_calib=None, bf: float = 0.0, fix_scale: bool = False,
                 device=None):
        self.bf = bf  # baseline * fx: > 0 adds the stereo rows to the BA
        # stereo and RGB-D maps are metric: the IMU ladder holds s = 1 (a
        # free scale could land in a wrong basin and wreck the map)
        self.fix_scale = fix_scale
        self.device = device_policy.resolve(device)
        self.camera = camera.to(self.device)
        self.map = slam_map
        self.cfg = cfg or LocalMapperConfig()
        self.imu_calib = None if imu_calib is None else imu_calib.to(self.device)
        self._t_imu_init: float | None = None  # ts of the first IMU init
        self._last_scale_refine: float = -np.inf
        # recent map points to watch for culling: (mp_id, created_kf_count)
        self._recent_mps: list[tuple[int, int]] = []
        self._kf_counter = 0

    def _t(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    # ----------------------------------------------------------------- entry
    def initial_ba(self, k0: int, k1: int, n_iters: int = 20):
        """Init-map BA (reference GlobalBundleAdjustemnt(20) after mono init)."""
        self._run_ba(window=[k0, k1], fixed=[k0], n_iters=n_iters)

    def process_keyframe(self, k: int, abort=None):
        """One LocalMapping::Run iteration for a new keyframe.

        `abort` (nullary callable) discards the local BA's result when it
        turns true (mbAbortBA semantics)."""
        self._kf_counter += 1
        with self.map.lock:
            with timing.stage("lm.cull_mps"):
                self._cull_map_points()
            with timing.stage("lm.triangulate"):
                self._create_new_map_points(k)
            with timing.stage("lm.fuse"):
                self._fuse_neighbors(k)
            # normals, scale bands and distinctive descriptors of every
            # point this KF observes (ProcessNewKeyFrame)
            self.map.update_point_stats(self.map.kf_obs_mp[k])
        # local BA: the inertial window once the IMU is initialized, else the
        # visual covisibility window
        with timing.stage("lm.local_ba"):
            if self.map.imu_initialized and self.imu_calib is not None:
                # until VIBA2 the init-stage bias priors stay on
                pg, pa = (1.0, 1e5) if self.map.iba_stage < 2 else (0.0, 0.0)
                with timing.stage("lm.vi_window_ba"):
                    imu_init.full_inertial_ba(
                        self.map, self.imu_calib, self.camera, n_iters=self.cfg.ba_iters,
                        points_cap=self.cfg.ba_points_cap, obs_cap=self.cfg.ba_obs_cap,
                        window=self.cfg.inertial_window_kfs, prior_gyro=pg,
                        prior_acc=pa, device=self.device)
            else:
                window = [k] + list(self.map.covisibility(k, min_shared=15)
                                    [: self.cfg.window_kfs - 1])
                self._run_ba(window, self._fixed_border(window), self.cfg.ba_iters,
                             abort=abort)
        with self.map.lock:
            with timing.stage("lm.imu_init"):
                self._imu_init_ladder(k)
            with timing.stage("lm.cull_kfs"):
                self._cull_keyframes(k)

    # ------------------------------------------------------------- imu ladder
    def _full_viba(self, prior_gyro: float = 0.0, prior_acc: float = 0.0):
        """The full VI-BA after a rung (FullInertialBA): no keyframe fixed,
        so the residual gravity tilt goes into the gauge."""
        with timing.stage("lm.vi_full_ba"):
            imu_init.full_inertial_ba(self.map, self.imu_calib, self.camera,
                                      n_iters=self.cfg.post_init_viba_iters,
                                      fix_first=False, prior_gyro=prior_gyro,
                                      prior_acc=prior_acc, device=self.device)

    def _imu_init_ladder(self, k: int):
        """The staged IMU initialization: first init, then VIBA1 and VIBA2
        after `viba1_after_s` and `viba2_after_s` (each with s held at 1
        under `fix_scale`), then, on a monocular map, scale refinement
        every `scale_refine_every_s` up to `scale_refine_until_s`. Before
        the first init, a platform that has barely moved over twice the
        init span is flagged `bad_imu`."""
        if self.imu_calib is None:
            return
        m, cfg = self.map, self.cfg
        kfs, _ = imu_init.chain_with_preint(m)
        if len(kfs) < cfg.imu_init_min_kfs:
            return
        span = float(m.kf_ts[kfs[-1]] - m.kf_ts[kfs[0]])
        now = float(m.kf_ts[k])
        rung = dict(calib=self.imu_calib, fix_scale=self.fix_scale, device=self.device)
        if not m.imu_initialized:
            if span >= 2.0 * cfg.imu_init_min_span_s:
                centers = np.stack([-m.kf_R[i].T @ m.kf_t[i] for i in kfs])
                dist = float(np.linalg.norm(np.diff(centers[-4:], axis=0), axis=1).sum())
                if dist < 0.02:
                    m.bad_imu = True
                    return
            if span < cfg.imu_init_min_span_s:
                return
            if imu_init.initialize_imu(m, prior_gyro=1e2, prior_acc=1e10, **rung) is not None:
                self._t_imu_init = now
                self._full_viba(prior_gyro=1e2, prior_acc=1e10)
            return
        elapsed = now - (self._t_imu_init if self._t_imu_init is not None else now)
        if m.iba_stage == 0 and elapsed > cfg.viba1_after_s:
            if imu_init.initialize_imu(m, prior_gyro=1.0, prior_acc=1e5, **rung) is not None:
                m.iba_stage = 1
                self._full_viba(prior_gyro=1.0, prior_acc=1e5)
        elif m.iba_stage == 1 and elapsed > cfg.viba2_after_s:
            if imu_init.initialize_imu(m, prior_gyro=0.0, prior_acc=0.0, **rung) is not None:
                m.iba_stage = 2
                self._full_viba()
                self._last_scale_refine = now
        elif (m.iba_stage == 2 and self.bf <= 0 and elapsed <= cfg.scale_refine_until_s
              and now - self._last_scale_refine >= cfg.scale_refine_every_s):
            # monocular scale refinement: scale and gravity only, the
            # biases pinned by large priors
            self._last_scale_refine = now
            imu_init.initialize_imu(m, self.imu_calib, prior_gyro=1e6, prior_acc=1e10,
                                    fix_vel=True, device=self.device)

    # --------------------------------------------------------------- culling
    def _cull_map_points(self):
        """MapPointCulling: drop low found-ratio points and young points
        that failed to accumulate observations."""
        m = self.map
        bad: list[int] = []
        keep: list[tuple[int, int]] = []
        counts = m.observation_count()
        for mp_id, born in self._recent_mps:
            if not m.mp_valid[mp_id]:
                continue
            age = self._kf_counter - born
            ratio = m.mp_found[mp_id] / max(m.mp_visible[mp_id], 1)
            if ratio < self.cfg.culling_min_found_ratio:
                bad.append(mp_id)
            elif age >= 2 and counts[mp_id] <= 2:
                bad.append(mp_id)
            elif age >= self.cfg.culling_obs_after:
                continue  # graduated
            else:
                keep.append((mp_id, born))
        if bad:
            m.remove_points(np.asarray(bad))
        self._recent_mps = keep

    def _cull_keyframes(self, k: int):
        """KeyFrameCulling: remove covisible KFs whose observations are
        >= 90% redundant, where redundant means >= 3 OTHER keyframes observe
        the point at the same or a finer octave. On an inertial map only a
        keyframe inside a temporal chain goes (with a predecessor and a
        successor, as ORB-SLAM3's `mPrevKF && mNextKF`): a chain's last
        keyframe is its tracking lane's anchor and the start of the lane's
        next inertial edge."""
        m = self.map
        if m.n_keyframes < 8:
            return
        # the newest two keyframes by frame id are protected
        valid_ids = m.keyframe_ids()
        newest = set(valid_ids[np.argsort(-m.kf_frame_id[valid_ids])[:2]].tolist())
        # one pass over all observations builds a per-point cumulative octave
        # histogram; each candidate's redundancy test is then a row gather
        n_lvls = 8
        kk_all, ss_all = np.nonzero(m.kf_valid[:, None] & (m.kf_obs_mp >= 0))
        mm_all = m.kf_obs_mp[kk_all, ss_all]
        oo_all = np.clip(m.kf_octave[kk_all, ss_all], 0, n_lvls - 1)
        oct_hist = np.zeros((m.cfg.max_points, n_lvls), np.int32)
        np.add.at(oct_hist, (mm_all, oo_all), 1)
        oct_cum = np.cumsum(oct_hist, axis=1)  # observers with octave <= o
        for kf in m.covisibility(k, min_shared=15):
            kf = int(kf)
            if kf == k or not m.kf_valid[kf] or kf in newest:
                continue
            if m.kf_prev[k] == kf or kf == 0:
                continue  # keep the temporal chain root & origin
            obs = m.kf_obs_mp[kf]
            slots = np.nonzero(obs >= 0)[0]
            if len(slots) < 20:
                continue
            mps = obs[slots]
            octs = np.clip(m.kf_octave[kf, slots] + 1, 0, n_lvls - 1)
            own_oct = np.clip(m.kf_octave[kf, slots], 0, n_lvls - 1)
            # exclude this KF's own observation where it counts as "finer"
            total_finer = oct_cum[mps, octs] - (own_oct <= octs)
            n_redundant = int((total_finer >= 3).sum())
            if n_redundant / len(slots) > self.cfg.kf_cull_redundancy:
                nxt = np.nonzero(m.kf_valid & (m.kf_prev == kf))[0]
                if self.imu_calib is not None:
                    # inertial gates: no culling before VIBA2, only inside a
                    # chain, and no gap of 3 s or more in the temporal chain
                    if m.iba_stage < 2:
                        continue
                    prev = int(m.kf_prev[kf])
                    if prev < 0 or not len(nxt) or any(
                            float(m.kf_ts[int(nk)] - m.kf_ts[prev]) >= 3.0 for nk in nxt):
                        continue
                    # the successors' edges now start at prev: merge this
                    # keyframe's preintegration into theirs
                    pre_kf = m.kf_pre.get(kf)
                    for nk in nxt:
                        pre_nk = m.kf_pre.get(int(nk))
                        if pre_kf is not None and pre_nk is not None:
                            m.kf_pre[int(nk)] = preint.merge(pre_kf, pre_nk)
                for nk in nxt:
                    m.kf_prev[nk] = m.kf_prev[kf]
                m.remove_keyframe(kf)
                # keep the redundancy statistics exact for later candidates
                np.add.at(oct_hist, (mps, own_oct), -1)
                oct_cum[mps] = np.cumsum(oct_hist[mps], axis=1)

    # --------------------------------------------------- new point creation
    def _create_new_map_points(self, k: int):
        """Epipolar triangulation with covisible neighbours
        (CreateNewMapPoints)."""
        m = self.map
        cam = self.camera
        neighbors = m.covisibility(k, min_shared=10)[: self.cfg.triangulate_neighbors]
        if len(neighbors) == 0:
            return
        Rk, tk = m.kf_R[k], m.kf_t[k]
        avail_k = m.kf_feat_valid[k] & (m.kf_obs_mp[k] < 0)
        words_k = self._t(words_to_int32(m.kf_desc[k]))
        uv_k = self._t(m.kf_uv[k])
        x1 = cam.unproject(uv_k)[:, :2]
        Rk_t, tk_t = self._t(Rk), self._t(tk)
        P1 = projection_matrix(Rk_t, tk_t)

        for nb in neighbors:
            Rn, tn = m.kf_R[nb], m.kf_t[nb]
            # baseline vs scene-depth gate
            baseline = np.linalg.norm(-Rn.T @ tn - (-Rk.T @ tk))
            med_depth = self._median_depth(k)
            if med_depth > 0 and baseline / med_depth < 0.01:
                continue
            avail_n = m.kf_feat_valid[nb] & (m.kf_obs_mp[nb] < 0)
            uv_n = self._t(m.kf_uv[nb])
            Rn_t, tn_t = self._t(Rn), self._t(tn)
            idx, ok = matcher.search_for_triangulation(
                uv_k, words_k, self._t(avail_k), uv_n, self._t(words_to_int32(m.kf_desc[nb])),
                self._t(avail_n), Rk_t, tk_t, Rn_t, tn_t, cam)
            ok_np = ok.cpu().numpy()
            if not ok_np.any():
                continue
            idx_np = idx.cpu().numpy()
            x2 = cam.unproject(uv_n)[:, :2]
            X, _ = triangulate_points(P1, projection_matrix(Rn_t, tn_t), x1,
                                      x2[idx.long()])
            X = X.cpu().numpy()
            # acceptance checks (depth, parallax, reprojection) on the host,
            # as the reference makes them
            xc1 = X @ Rk.T + tk
            xc2 = X @ Rn.T + tn
            z1, z2 = xc1[:, 2], xc2[:, 2]
            r1 = X - (-Rk.T @ tk)
            r2 = X - (-Rn.T @ tn)
            cosp = np.sum(r1 * r2, -1) / np.maximum(
                np.linalg.norm(r1, axis=-1) * np.linalg.norm(r2, axis=-1), 1e-12)
            uv_pred = cam.project(self._t(np.stack([xc1, xc2]))).cpu().numpy()
            e1 = np.sum((uv_pred[0] - m.kf_uv[k]) ** 2, -1)
            e2 = np.sum((uv_pred[1] - m.kf_uv[nb][idx_np]) ** 2, -1)
            good = (ok_np & (z1 > 0.05) & (z2 > 0.05) & (cosp < 0.9998)
                    & (e1 < robust.CHI2_MONO) & (e2 < robust.CHI2_MONO)
                    & np.isfinite(X).all(-1))
            slots_k = np.nonzero(good)[0]
            if len(slots_k) == 0:
                continue
            ids = m.add_points(pos=X[slots_k].astype(np.float32),
                               desc=m.kf_desc[k][slots_k], first_kf=k)
            ok_ids = ids >= 0
            sk = slots_k[ok_ids]
            m.kf_obs_mp[k, sk] = ids[ok_ids]
            m.kf_obs_mp[nb, idx_np[sk]] = ids[ok_ids]
            for mp_id in ids[ok_ids]:
                self._recent_mps.append((int(mp_id), self._kf_counter))
            # mark slots used
            avail_k = m.kf_feat_valid[k] & (m.kf_obs_mp[k] < 0)

    def _median_depth(self, k: int) -> float:
        """Scene median depth (KeyFrame::ComputeSceneMedianDepth)."""
        m = self.map
        obs = m.kf_obs_mp[k]
        mps = obs[obs >= 0]
        if len(mps) == 0:
            return -1.0
        xc = m.mp_pos[mps] @ m.kf_R[k].T + m.kf_t[k]
        return float(np.median(xc[:, 2]))

    # ------------------------------------------------------------------ fuse
    def _fuse_neighbors(self, k: int):
        """SearchInNeighbors: project each neighbour's points into KF k (and
        vice versa) and bind them to unassigned features, merging
        duplicates."""
        m = self.map
        neighbors = m.covisibility(k, min_shared=10)[: self.cfg.triangulate_neighbors]
        pairs = [(k, nb) for nb in neighbors] + [(nb, k) for nb in neighbors]
        K = 4096  # candidate capacity per pair
        for target, source in pairs:
            obs_s = m.kf_obs_mp[source]
            mp_ids = obs_s[obs_s >= 0]
            mp_ids = np.unique(mp_ids[m.mp_valid[mp_ids]])
            if len(mp_ids) == 0:
                continue
            ids_p = np.zeros(K, np.int32)
            valid_p = np.zeros(K, bool)
            n = min(len(mp_ids), K)
            ids_p[:n] = mp_ids[:n]
            valid_p[:n] = True
            fidx, matched = matcher.fuse_by_projection(
                self._t(m.mp_pos[ids_p]), self._t(words_to_int32(m.mp_desc[ids_p])),
                self._t(valid_p), self._t(m.kf_R[target]), self._t(m.kf_t[target]),
                self.camera, self._t(m.kf_uv[target]),
                self._t(words_to_int32(m.kf_desc[target])), self._t(m.kf_octave[target]),
                self._t(m.kf_feat_valid[target]))
            sel = np.nonzero(matched.cpu().numpy())[0]
            if len(sel) == 0:
                continue
            slots_t = fidx.cpu().numpy()[sel]
            mps = ids_p[sel]
            existing = m.kf_obs_mp[target, slots_t]
            obs_t = m.kf_obs_mp[target]
            has_mp = np.zeros(m.cfg.max_points, bool)
            has_mp[obs_t[obs_t >= 0]] = True
            # new bindings: empty slot, landmark not already in the row;
            # first wins over both landmark and slot
            selA = np.nonzero((existing < 0) & ~has_mp[mps])[0]
            _, fm = np.unique(mps[selA], return_index=True)
            selA = selA[fm]
            _, fs = np.unique(slots_t[selA], return_index=True)
            selA = selA[fs]
            m.kf_obs_mp[target, slots_t[selA]] = mps[selA]
            # duplicate landmarks: merge, keeping the better-observed one
            # (Fuse -> MapPoint::Replace)
            selB = np.nonzero((existing >= 0) & (existing != mps)
                              & m.mp_valid[np.maximum(existing, 0)])[0]
            if len(selB):
                counts = m.observation_count()
                for i in selB:
                    a, b = int(existing[i]), int(mps[i])
                    if not (m.mp_valid[a] and m.mp_valid[b]) or a == b:
                        continue
                    if counts[a] >= counts[b]:
                        m.merge_points(a, b)
                    else:
                        m.merge_points(b, a)

    # -------------------------------------------------------------------- BA
    def _fixed_border(self, window: list[int]) -> list[int]:
        """KFs outside the window that observe window points (fixed in BA,
        like LocalBundleAdjustment's lFixedCameras)."""
        m = self.map
        win = set(window)
        obs = m.kf_obs_mp[list(window)]
        mp_ids = np.unique(obs[obs >= 0])
        kk, _, _ = m.observations_of(mp_ids)
        fixed = [int(x) for x in np.unique(kk) if int(x) not in win]
        return fixed[: self.cfg.fixed_kfs]

    def _run_ba(self, window: list[int], fixed: list[int], n_iters: int,
                abort=None):
        """Local BA over `window` with `fixed` as the border. `abort` (a
        nullary callable, mbAbortBA) discards the result when it turns
        true."""
        m = self.map
        all_kfs = list(window) + list(fixed)
        if len(window) == 0:
            return
        if abort is not None and abort():
            return
        with m.lock:  # assembly reads a consistent map snapshot
            prob = self._assemble_ba(window, fixed, all_kfs)
        if prob is None:
            return
        prob, fixed_mask, mp_ids, kk, slots, mm, info, O = prob
        out, _costs, ba_outlier = bundle_adjust(prob, self.camera, n_iters=n_iters)
        with m.lock:
            self._apply_ba_result(out, ba_outlier, all_kfs, fixed_mask, mp_ids,
                                  kk, slots, mm, info, O, abort)

    def _assemble_ba(self, window, fixed, all_kfs):
        m = self.map
        if len(fixed) < 2 and len(window) > 2:
            # ORB-SLAM3's num_fixedKF guard: with fewer than two anchor
            # cameras the monocular similarity gauge is free, so the
            # lowest-uid window KFs are promoted to fixed (membership only:
            # all_kfs keeps its order, shared with _apply_ba_result)
            promote = sorted(window, key=lambda kf: int(m.kf_uid[kf]))
            fixed = list(fixed) + promote[: 2 - len(fixed)]
        elif len(fixed) == 0 and len(window) >= 2:
            fixed = [window[-1]]  # gauge: fix one (2-KF init window)
            all_kfs = list(window)
        M_cap = self.cfg.window_kfs + self.cfg.fixed_kfs
        P_cap = self.cfg.ba_points_cap
        O_cap = self.cfg.ba_obs_cap

        kf_rows = np.zeros(M_cap, np.int32)
        kf_rows[: len(all_kfs)] = all_kfs
        fixed_mask = np.zeros(M_cap, bool)
        fixed_mask[len(window): len(all_kfs)] = True
        fixed_mask[len(all_kfs):] = True
        for i, kf in enumerate(all_kfs):
            if kf in fixed:
                fixed_mask[i] = True

        # landmark set: points observed by window KFs
        obs_w = m.kf_obs_mp[list(window)]
        mp_ids = np.unique(obs_w[obs_w >= 0])
        mp_ids = mp_ids[m.mp_valid[mp_ids]][:P_cap]
        lm_rows = np.zeros(P_cap, np.int32)
        lm_rows[: len(mp_ids)] = mp_ids
        lm_lut = np.full(m.cfg.max_points, -1, np.int32)
        lm_lut[mp_ids] = np.arange(len(mp_ids))
        kf_lut = np.full(m.cfg.max_keyframes, -1, np.int32)
        kf_lut[all_kfs] = np.arange(len(all_kfs))

        kk, slots, mm = m.observations_of(mp_ids)
        in_prob = (kf_lut[kk] >= 0) & (lm_lut[mm] >= 0)
        kk, slots, mm = kk[in_prob], slots[in_prob], mm[in_prob]
        if len(kk) > O_cap:
            keep = np.random.default_rng(0).permutation(len(kk))[:O_cap]
            kk, slots, mm = kk[keep], slots[keep], mm[keep]
        O = len(kk)
        kf_idx = np.zeros(O_cap, np.int64)
        lm_idx = np.zeros(O_cap, np.int64)
        uv = np.zeros((O_cap, 2), np.float32)
        info = np.zeros(O_cap, np.float32)
        valid = np.zeros(O_cap, bool)
        kf_idx[:O] = kf_lut[kk]
        lm_idx[:O] = lm_lut[mm]
        uv[:O] = m.kf_uv[kk, slots]
        info[:O] = 1.0 / (1.2 ** (2 * m.kf_octave[kk, slots]))
        valid[:O] = True
        stereo = {}
        if self.bf > 0:
            u_r = np.full(O_cap, -1.0, np.float32)
            u_r[:O] = m.kf_uright[kk, slots]
            stereo = dict(u_r=self._t(u_r), bf=self._t(np.float32(self.bf)))
        prob = BAProblem(
            R=self._t(m.kf_R[kf_rows]), t=self._t(m.kf_t[kf_rows]),
            points=self._t(m.mp_pos[lm_rows]),
            kf_idx=self._t(kf_idx), lm_idx=self._t(lm_idx),
            uv=self._t(uv), info=self._t(info), valid=self._t(valid),
            fixed_kf=self._t(fixed_mask),
            fixed_lm=self._t(np.arange(P_cap) >= len(mp_ids)), **stereo)
        return prob, fixed_mask, mp_ids, kk, slots, mm, info, O

    def _apply_ba_result(self, out, ba_outlier, all_kfs, fixed_mask, mp_ids,
                         kk, slots, mm, info, O, abort):
        m = self.map
        if abort is not None and abort():
            return  # interrupted: discard
        R_new = out.R.cpu().numpy()
        t_new = out.t.cpu().numpy()
        p_new = out.points.cpu().numpy()
        for i, kf in enumerate(all_kfs):
            if not fixed_mask[i]:
                m.kf_R[kf] = R_new[i]
                m.kf_t[kf] = t_new[i]
        m.mp_pos[mp_ids] = p_new[: len(mp_ids)]
        m.change_index += 1

        # outlier observation pruning (the reference erases chi2 > 5.991
        # edges after LBA)
        xcs = np.einsum("oij,oj->oi", m.kf_R[kk], m.mp_pos[mm]) + m.kf_t[kk]
        uv_pred = self.camera.project(self._t(xcs)).cpu().numpy()
        err2 = np.sum((uv_pred - m.kf_uv[kk, slots]) ** 2, -1) * info[:O]
        outlier = (err2 > robust.CHI2_MONO) | (xcs[:, 2] <= 0)
        outlier |= ba_outlier.cpu().numpy()[:O]  # rejected at the mid-BA gate
        m.kf_obs_mp[kk[outlier], slots[outlier]] = -1
        # normals and scale bands from the post-BA geometry
        m.update_point_stats(mp_ids)
