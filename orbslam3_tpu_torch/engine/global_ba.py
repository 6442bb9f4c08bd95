"""Interruptible global bundle adjustment with catch-up write-back.

Port of `orbslam3_tpu/engine/global_ba.py` (ORB-SLAM3's
`RunGlobalBundleAdjustment`): the global BA solves a snapshot of the map,
on its own thread or inline, and a new loop or merge aborts it
(`mbStopGBA`). Keyframes and points keep being created while it solves,
so the write-back corrects them through the spanning tree before it
writes under the map lock:

- the snapshot (uids, poses, points, observation triplets) is taken under
  the lock;
- the solve runs in blocks of iterations with an abort check between
  blocks (one `bundle_adjust` per block, on `device`);
- the write-back matches rows by uid (slots may be reused meanwhile);
  keyframes missing from the snapshot are corrected by
  T_corr = T_child_old T_parent_old^-1 T_parent_corr along `kf_prev`, and
  new points through their reference keyframe's old and corrected poses.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from orbslam3_tpu_torch import device as device_policy
from orbslam3_tpu_torch.opt.ba import BAProblem, bundle_adjust
from orbslam3_tpu_torch.slam_map.map_state import MapState


class GlobalBA:
    """One global BA in flight at a time: a new request aborts the running
    one first."""

    def __init__(self, camera, iters_per_block: int = 5, n_blocks: int = 4, device=None):
        self.device = device_policy.resolve(device)
        self.camera = camera.to(self.device)
        self.iters_per_block = iters_per_block
        self.n_blocks = n_blocks
        self._thread: threading.Thread | None = None
        self._abort = threading.Event()
        self.running = False
        self.n_aborted = 0
        self.n_finished = 0

    # ------------------------------------------------------------------ api
    def request(self, m: MapState, fixed_kf: int, background: bool = True):
        """Start a global BA over map `m`, after aborting any in flight;
        with background=False it runs inline."""
        self.abort_and_join()
        self._abort.clear()
        self.running = True
        if background:
            self._thread = threading.Thread(target=self._run, args=(m, int(fixed_kf)),
                                            daemon=True)
            self._thread.start()
        else:
            self._run(m, int(fixed_kf))

    def abort_and_join(self):
        """Signal abort and wait for the worker (mbStopGBA + join)."""
        t = self._thread
        if t is not None and t.is_alive():
            self._abort.set()
            t.join()
        self._thread = None

    def join(self):
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None

    # ------------------------------------------------------------ internals
    def _snapshot(self, m: MapState):
        with m.lock:
            kfs = m.keyframe_ids()
            mp_ids = np.nonzero(m.mp_valid)[0]
            if len(kfs) < 2 or len(mp_ids) == 0:
                return None
            kk, slots, mps = m.observations_of(mp_ids)
            return dict(kfs=kfs.copy(), kf_uid=m.kf_uid[kfs].copy(),
                        R=m.kf_R[kfs].copy(), t=m.kf_t[kfs].copy(),
                        mp_ids=mp_ids.copy(), mp_uid=m.mp_uid[mp_ids].copy(),
                        pos=m.mp_pos[mp_ids].copy(),
                        obs=(kk.copy(), slots.copy(), mps.copy()),
                        uv=m.kf_uv[kk, slots].copy(), octv=m.kf_octave[kk, slots].copy())

    def _run(self, m: MapState, fixed_kf: int):
        try:
            snap = self._snapshot(m)
            if snap is None:
                return
            kfs = snap["kfs"]
            slot = np.full(m.cfg.max_keyframes, -1, np.int64)
            slot[kfs] = np.arange(len(kfs))
            pslot = np.full(m.cfg.max_points, -1, np.int64)
            pslot[snap["mp_ids"]] = np.arange(len(snap["mp_ids"]))
            kk, _, mps = snap["obs"]
            fixed = np.zeros(len(kfs), bool)
            row = int(slot[fixed_kf]) if 0 <= fixed_kf < len(slot) else -1
            fixed[max(row, 0)] = True       # the first keyframe if it is gone

            def t_(x, dtype=None):
                return torch.as_tensor(x, dtype=dtype, device=self.device)

            info = (1.0 / 1.2 ** (2 * snap["octv"])).astype(np.float32)
            R, t, pos = t_(snap["R"]), t_(snap["t"]), t_(snap["pos"])
            for _ in range(self.n_blocks):
                if self._abort.is_set():
                    self.n_aborted += 1
                    return
                prob = BAProblem(
                    R=R, t=t, points=pos, kf_idx=t_(slot[kk]), lm_idx=t_(pslot[mps]),
                    uv=t_(snap["uv"], torch.float32), info=t_(info),
                    valid=torch.ones(len(kk), dtype=torch.bool, device=self.device),
                    fixed_kf=t_(fixed),
                    fixed_lm=torch.zeros(len(snap["mp_ids"]), dtype=torch.bool,
                                         device=self.device))
                out, _, _ = bundle_adjust(prob, self.camera, n_iters=self.iters_per_block)
                R, t, pos = out.R, out.t, out.points
            if self._abort.is_set():
                self.n_aborted += 1
                return
            self._write_back(m, snap, R.cpu().numpy(), t.cpu().numpy(),
                             pos.cpu().numpy())
            self.n_finished += 1
        finally:
            self.running = False

    def _write_back(self, m: MapState, snap, R_new, t_new, pos_new):
        """The solved state plus the catch-up correction, under the map lock."""
        with m.lock:
            uid_row = {int(u): i for i, u in enumerate(snap["kf_uid"])}
            old_R, old_t = {}, {}
            live = m.keyframe_ids()
            # 1. snapshot keyframes still alive: written directly
            for k in live:
                row = uid_row.get(int(m.kf_uid[k]), -1)
                if row >= 0:
                    old_R[int(k)] = m.kf_R[k].copy()
                    old_t[int(k)] = m.kf_t[k].copy()
                    m.kf_R[k] = R_new[row]
                    m.kf_t[k] = t_new[row]
            # 2. keyframes created during the solve, parents first: through
            #    the spanning tree from a corrected parent
            corrected = set(old_R)
            fresh = sorted((int(k) for k in live if int(k) not in corrected),
                           key=lambda k: float(m.kf_ts[k]))
            for k in fresh:
                p = int(m.kf_prev[k])
                if p < 0 or not m.kf_valid[p] or p not in corrected:
                    continue
                R_rel = m.kf_R[k] @ old_R[p].T
                t_rel = m.kf_t[k] - R_rel @ old_t[p]
                old_R[k], old_t[k] = m.kf_R[k].copy(), m.kf_t[k].copy()
                m.kf_R[k] = (R_rel @ m.kf_R[p]).astype(np.float32)
                m.kf_t[k] = (R_rel @ m.kf_t[p] + t_rel).astype(np.float32)
                corrected.add(k)
            # 3. snapshot points still alive: written directly
            prow = {int(u): i for i, u in enumerate(snap["mp_uid"])}
            live_mp = np.nonzero(m.mp_valid)[0]
            fresh_mp = []
            for p in live_mp:
                row = prow.get(int(m.mp_uid[p]), -1)
                if row >= 0:
                    m.mp_pos[p] = pos_new[row]
                else:
                    fresh_mp.append(int(p))
            # 4. points created during the solve: through their reference
            #    keyframe's old and corrected poses
            for p in fresh_mp:
                rk = int(m.mp_ref_kf[p])
                if rk < 0 or rk not in old_R:
                    continue
                xc = old_R[rk] @ m.mp_pos[p] + old_t[rk]
                m.mp_pos[p] = (m.kf_R[rk].T @ (xc - m.kf_t[rk])).astype(np.float32)
            m.change_index += 1
            # geometry moved: the scale bands and normals follow
            m.update_point_stats(live_mp)
