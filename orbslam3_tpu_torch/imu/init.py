"""IMU initialization ladder: gravity/scale/bias MAP, map re-gauge, VI-BA.

Port of `orbslam3_tpu/imu/init.py` (ORB-SLAM3's `LocalMapping::InitializeIMU`
and `ScaleRefinement`, and the `FullInertialBA` dispatch): the ladder is
host logic over the map's numpy arrays; every solve runs on `device` (the
card unless ``device="cpu"``) through `opt/inertial.py`.

Stages (driven by `LocalMapper`):
  0. first init: inertial-only MAP with priors (1e2, 1e10), then the map is
     re-gauged in place so gravity is -z and the monocular scale metric,
     then a full VI-BA;
  1. VIBA1: re-solve with priors (1, 1e5);
  2. VIBA2: re-solve with priors (0, 0);
  +  monocular scale refinement at a fixed cadence.

`merge_inertial_ba` is the welding-window VI-BA of a map merge
(`MergeInertialBA`): two temporal chains over one point set.
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam3_tpu_torch import device as device_policy
from orbslam3_tpu_torch.imu.preintegration import ImuCalib
from orbslam3_tpu_torch.opt import inertial as iopt
from orbslam3_tpu_torch.slam_map.map_state import MapState


def temporal_chain(m: MapState) -> list[int]:
    """Valid keyframes in timestamp order."""
    ks = m.keyframe_ids()
    return [int(k) for k in ks[np.argsort(m.kf_ts[ks], kind="stable")]]


def chain_with_preint(m: MapState) -> tuple[list[int], list]:
    """The longest contiguous inertial chain along the `kf_prev` links (the
    reference's mPrevKF chain, not a timestamp sort: several tracking lanes
    may interleave keyframes on one map). A link into k is usable only when
    k carries the preintegration spanning it. Returns (kfs, pres) with
    len(pres) == len(kfs) - 1."""
    valid = set(int(k) for k in m.keyframe_ids())
    succ: dict[int, list[int]] = {}
    heads = []
    for k in valid:
        p = int(m.kf_prev[k])
        if p in valid:
            succ.setdefault(p, []).append(k)
        if p not in valid or m.kf_pre.get(k) is None:
            heads.append(k)  # no live predecessor, or a break in the chain
    chains = []
    for h in heads:
        chain, cur = [h], h
        while True:
            nxt = next((c for c in sorted(succ.get(cur, []), key=lambda j: m.kf_ts[j])
                        if m.kf_pre.get(c) is not None), None)
            if nxt is None:
                break
            chain.append(nxt)
            cur = nxt
        chains.append(chain)
    if not chains:
        return [], []
    best = max(chains, key=len)
    return best, [m.kf_pre[k] for k in best[1:]]


def cam_from_body(calib: ImuCalib):
    """(Rcb, tcb) as float32 numpy: the solvers take camera<-body."""
    return tuple(x.cpu().numpy() for x in calib.cam_from_body())


def body_poses(m: MapState, ks: list[int], calib: ImuCalib, device=None):
    """Keyframe Tcw poses -> body poses (Rwb, twb) on `device`."""
    Rcb, tcb = cam_from_body(calib)
    Rcw, tcw = m.kf_R[ks], m.kf_t[ks]
    Rwb = np.einsum("kji,jl->kil", Rcw, Rcb)           # Rcw^T Rcb
    twb = np.einsum("kji,kj->ki", Rcw, tcb[None] - tcw)
    dev = device_policy.resolve(device)
    return (torch.as_tensor(Rwb, dtype=torch.float32, device=dev),
            torch.as_tensor(twb, dtype=torch.float32, device=dev))


MIN_CHAIN_KFS = 6     # the shortest chain an init rung solves over
INIT_GN_ITERS = 20    # Gauss-Newton steps of the inertial-only MAP


def initialize_imu(m: MapState, calib: ImuCalib, prior_gyro: float = 1e2,
                   prior_acc: float = 1e10, fix_scale: bool = False,
                   fix_vel: bool = False, device=None):
    """One rung of the ladder. Returns the `InertialInit`, or None if the
    chain is too short or the scale degenerate.

    On success the map is re-gauged to metric, gravity-aligned
    coordinates, the keyframe velocities and biases are written and
    `m.imu_initialized` is set (InitializeIMU -> ApplyScaledRotation ->
    UpdateFrameIMU). `fix_scale` holds s = 1 (stereo and RGB-D maps are
    metric already). The reference's `regauge=False` has no caller and is
    not ported."""
    dev = device_policy.resolve(device)
    kfs, pres = chain_with_preint(m)
    if len(kfs) < MIN_CHAIN_KFS:
        return None
    edges = iopt.build_edges(pres, [(i, i + 1) for i in range(len(kfs) - 1)], device=dev)
    Rwb, twb = body_poses(m, kfs, calib, dev)
    v0 = (torch.as_tensor(m.kf_vel[kfs], dtype=torch.float32, device=dev)
          if m.imu_initialized else None)
    init = iopt.inertial_only_optimize(Rwb, twb, edges, prior_gyro=prior_gyro,
                                       prior_acc=prior_acc, v0=v0, n_iters=INIT_GN_ITERS,
                                       fix_scale=fix_scale, fix_vel=fix_vel)
    s = float(init.scale)
    if not np.isfinite(s) or s < 1e-1:
        return None  # degenerate scale: the reference aborts too
    Rgw = init.Rwg.cpu().numpy().T  # new world: gravity along -z
    ang = float(np.arccos(np.clip((np.trace(Rgw) - 1.0) / 2.0, -1.0, 1.0)))
    if (not m.imu_initialized) or abs(s - 1.0) > 1e-5 or ang > 1e-3:
        # later rungs apply the full gravity correction too, not only the
        # scale (ApplyScaledRotation(Twg, scale))
        m.apply_scaled_rotation(Rgw, s)
    m.kf_vel[kfs] = (s * (init.v.cpu().numpy() @ Rgw.T)).astype(np.float32)
    m.kf_bias[kfs] = init.bias.cpu().numpy().astype(np.float32)
    m.imu_initialized = True
    return init


def full_inertial_ba(m: MapState, calib: ImuCalib, camera, n_iters: int = 8,
                     points_cap: int = 4096, obs_cap: int = 16384,
                     fix_first: bool = True, window: int | None = None,
                     prior_gyro: float = 0.0, prior_acc: float = 0.0, device=None):
    """Visual-inertial BA over the temporal chain (`FullInertialBA`); with
    `window=W` the sliding-window `LocalInertialBA`: the last W chain
    keyframes move and the one before them is the fixed border. Writes the
    optimized poses, velocities, biases and points back into the map and
    returns the trial costs (None if there was nothing to solve)."""
    dev = device_policy.resolve(device)
    kfs, pres = chain_with_preint(m)
    windowed = window is not None and len(kfs) > window + 1
    if windowed:
        cut = len(kfs) - (window + 1)  # keep one extra as the fixed border
        kfs, pres = kfs[cut:], pres[cut:]
        fix_first = True
    return _viba_over_chains(m, calib, camera, [(kfs, pres)], n_iters=n_iters,
                             points_cap=points_cap, obs_cap=obs_cap, fix_first=fix_first,
                             windowed=windowed, prior_gyro=prior_gyro,
                             prior_acc=prior_acc, device=dev)


def _window_back(m: MapState, k: int, window: int):
    """The temporal window ending at keyframe `k`: `kf_prev` walked while
    the link's preintegration exists, up to `window` keyframes to optimize
    plus 1 border."""
    kfs, pres = [int(k)], []
    while len(kfs) < window + 1:
        p = int(m.kf_prev[kfs[0]])
        pre = m.kf_pre.get(kfs[0])
        if p < 0 or not m.kf_valid[p] or pre is None:
            break
        kfs.insert(0, p)
        pres.insert(0, pre)
    return kfs, pres


def merge_inertial_ba(m: MapState, calib: ImuCalib, camera, cur_kf: int, merge_kf: int,
                      window: int = 10, n_iters: int = 8, points_cap: int = 4096,
                      obs_cap: int = 16384, device=None):
    """The welding-window visual-inertial BA over a merge seam
    (`Optimizer::MergeInertialBA`): two temporal windows, one ending at the
    current keyframe and one at the matched keyframe of the welded-in map,
    each with its inertial chain, coupled through the fused seam points;
    the back of each window is its fixed border. Overlapping windows are
    one chain."""
    chains = [c for c in (_window_back(m, root, window) for root in (cur_kf, merge_kf))
              if len(c[0]) >= 2]
    if not chains:
        return None
    if len(chains) == 2 and any(k in set(chains[0][0]) for k in chains[1][0]):
        chains = chains[:1]
    return _viba_over_chains(m, calib, camera, chains, n_iters=n_iters,
                             points_cap=points_cap, obs_cap=obs_cap, fix_first=True,
                             windowed=True, device=device)


def _viba_over_chains(m: MapState, calib: ImuCalib, camera, chains: list, n_iters: int,
                      points_cap: int, obs_cap: int, fix_first: bool, windowed: bool,
                      prior_gyro: float = 0.0, prior_acc: float = 0.0, device=None):
    """VI-BA over one or more temporal chains [(keyframes, preintegrations)]
    sharing one point set; with `windowed`, the strongest outside observers
    of those points join as a fixed border."""
    dev = device_policy.resolve(device)
    kfs, pairs, pres, chain_starts = [], [], [], []
    for c_kfs, c_pres in chains:
        off = len(kfs)
        chain_starts.append(off)
        pairs += [(off + i, off + i + 1) for i in range(len(c_kfs) - 1)]
        kfs += list(c_kfs)
        pres += list(c_pres)
    if len(kfs) < 3:
        return None
    n_chain = len(kfs)

    obs = m.kf_obs_mp[kfs]
    mp_ids = np.unique(obs[obs >= 0])
    mp_ids = mp_ids[m.mp_valid[mp_ids]][:points_cap]
    P = len(mp_ids)
    if P == 0:
        return None

    fixed_obs: list[int] = []
    if windowed:
        # the fixed observer border (LocalInertialBA's lFixedKeyFrames):
        # keyframes outside the window that observe its landmarks anchor the
        # gauge; without them each window solve lets the scale drift
        in_chain = np.zeros(m.cfg.max_keyframes, bool)
        in_chain[kfs] = True
        mp_mask = np.zeros(m.cfg.max_points, bool)
        mp_mask[mp_ids] = True
        kk_all, ss_all = np.nonzero(m.kf_valid[:, None] & (m.kf_obs_mp >= 0))
        sees = mp_mask[m.kf_obs_mp[kk_all, ss_all]] & ~in_chain[kk_all]
        cand, counts = np.unique(kk_all[sees], return_counts=True)
        fixed_obs = [int(x) for x in cand[np.argsort(-counts)][:12]]

    kfs = list(kfs) + fixed_obs
    edges = iopt.build_edges(pres, pairs, device=dev)
    Rwb, twb = body_poses(m, kfs, calib, dev)
    M = len(kfs)
    lm_lut = np.full(m.cfg.max_points, -1, np.int64)
    lm_lut[mp_ids] = np.arange(P)
    kf_lut = np.full(m.cfg.max_keyframes, -1, np.int64)
    kf_lut[kfs] = np.arange(M)

    kk, slots, mm = m.observations_of(mp_ids)
    sel = (kf_lut[kk] >= 0) & (lm_lut[mm] >= 0)
    kk, slots, mm = kk[sel], slots[sel], mm[sel]
    if len(kk) > obs_cap:
        keep = np.random.default_rng(0).permutation(len(kk))[:obs_cap]
        kk, slots, mm = kk[keep], slots[keep], mm[keep]
    O = len(kk)
    kf_idx = np.zeros(obs_cap, np.int64)
    lm_idx = np.zeros(obs_cap, np.int64)
    uv = np.zeros((obs_cap, 2), np.float32)
    info = np.zeros(obs_cap, np.float32)
    valid = np.zeros(obs_cap, bool)
    kf_idx[:O] = kf_lut[kk]
    lm_idx[:O] = lm_lut[mm]
    uv[:O] = m.kf_uv[kk, slots]
    info[:O] = 1.0 / (1.2 ** (2 * m.kf_octave[kk, slots]))
    valid[:O] = True
    pts = np.zeros((points_cap, 3), np.float32)
    pts[:P] = m.mp_pos[mp_ids]
    fixed_kf = np.zeros(M, bool)
    if fix_first:
        fixed_kf[chain_starts] = True  # each chain's oldest keyframe
    fixed_kf[n_chain:] = True          # the observer border stays put

    def t(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    prob = iopt.VIBAProblem(
        Rwb=Rwb, twb=twb, vel=t(m.kf_vel[kfs]), bias=t(m.kf_bias[kfs]),
        points=t(pts), kf_idx=t(kf_idx), lm_idx=t(lm_idx), uv=t(uv),
        info=t(info), valid=t(valid), fixed_kf=t(fixed_kf),
        fixed_lm=t(np.arange(points_cap) >= P))
    Rcb, tcb = (t(x) for x in cam_from_body(calib))
    out, costs = iopt.visual_inertial_ba(prob, edges, camera.to(dev), Rcb, tcb,
                                         n_iters=n_iters, prior_gyro=prior_gyro,
                                         prior_acc=prior_acc)
    Rcw, tcw = iopt.body_to_cam(out.Rwb, out.twb, Rcb, tcb)
    m.kf_R[kfs] = Rcw.cpu().numpy()
    m.kf_t[kfs] = tcw.cpu().numpy()
    m.kf_vel[kfs] = out.vel.cpu().numpy()
    m.kf_bias[kfs] = out.bias.cpu().numpy()
    m.mp_pos[mp_ids] = out.points[:P].cpu().numpy()
    m.change_index += 1
    # VI-BA can move the gauge: the scale bands and normals follow, or the
    # matcher's frustum gates reject the map on the next frame
    m.update_point_stats(mp_ids)
    return costs
