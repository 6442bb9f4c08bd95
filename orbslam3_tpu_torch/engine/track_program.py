"""Per-frame visual tracking: the projection-search retry ladder + pose GN.

Port of `orbslam3_tpu/engine/track_program.py:fused_track_pose`. The
reference runs the ladder as one `lax.while_loop`; here it is a Python loop
over the same stages, which reads one match count back from the device per
attempt:
  0: narrow window from the predicted pose;
  1: wide window from the predicted pose;
  2: extra-wide window from the last known-good pose (only if allowed);
  3: refinement search at the local radius from the accepted attempt;
  4: done (success)   5: done (no acquisition).
Matched candidate rows are compacted to the front of the GN problem by a
stable sort, so their order is the candidates' own.
"""

from __future__ import annotations

import torch

from orbslam3_tpu_torch import device as device_policy
from orbslam3_tpu_torch.opt.pose_gn import optimize_pose
from orbslam3_tpu_torch.vision import matcher


def _zeros_result(K: int, cap: int, dev: torch.device) -> dict:
    f32, i32 = torch.float32, torch.int32
    return dict(
        R=torch.eye(3, dtype=f32, device=dev), t=torch.zeros(3, dtype=f32, device=dev),
        sel=torch.zeros(cap, dtype=i32, device=dev),
        fidx=torch.zeros(cap, dtype=i32, device=dev),
        vsel=torch.zeros(cap, dtype=torch.bool, device=dev),
        inl=torch.zeros(cap, dtype=torch.bool, device=dev),
        nm=torch.zeros((), dtype=i32, device=dev),
        n_in=torch.zeros((), dtype=i32, device=dev),
        fr=torch.zeros(K, dtype=torch.bool, device=dev),
        uv=torch.zeros((cap, 2), dtype=f32, device=dev),
        oct=torch.zeros(cap, dtype=i32, device=dev),
    )


def fused_track_pose(
    mp_pos, mp_planes, mp_valid,     # (K,3), (K,256) +/-1, (K,) bool
    mp_normal, mp_min_d, mp_max_d,   # (K,3), (K,), (K,)
    camera,
    f_uv, f_planes, f_octave, f_valid,  # frame features (cap, ...)
    R_pred, t_pred,                  # motion-model predicted pose
    R_last, t_last,                  # last known-good pose (stage 2)
    allow_last: bool,                # permit the stage-2 attempt
    radii,                           # 4 radii: narrow, wide, wide2, local
    min_matches: int,                # acquisition gate (match count)
    min_inliers: int,                # refinement acceptance gate (match count)
    max_dist: int = 100,
    device=None,
):
    """Returns (success, result dict of the accepted attempt)."""
    dev = device_policy.resolve(device)
    K, cap = mp_pos.shape[0], f_uv.shape[0]
    if K < cap:
        # the reference's `order[:cap]` would give a carry of the wrong shape
        raise ValueError(f"fused_track_pose: {K} map-point candidates < "
                         f"{cap} feature slots; pad the candidates to >= {cap}")
    mp_pos, f_uv, f_octave, R_pred, t_pred, R_last, t_last = (
        x.to(dev) for x in (mp_pos, f_uv, f_octave, R_pred, t_pred, R_last, t_last))
    radii = [float(r) for r in radii]
    min_matches, min_inliers = int(min_matches), int(min_inliers)
    allow_last = bool(allow_last)
    ar = torch.arange(cap, device=dev)

    def attempt(R0, t0, radius):
        fidx, _dist, matched, nm, fr = matcher.search_by_projection(
            mp_pos, mp_planes, mp_valid, R0, t0, camera,
            f_uv, f_planes, f_octave, f_valid, radius,
            max_dist=max_dist, mp_normal=mp_normal,
            mp_min_dist=mp_min_d, mp_max_dist=mp_max_d, device=dev)
        order = torch.sort(torch.where(matched, 0, 1), stable=True).indices
        sel = order[:cap]
        vsel = matched[sel] & (ar < nm)
        fsel = torch.where(vsel, fidx[sel].long(), 0)
        pts = mp_pos[sel]
        uv_obs = f_uv[fsel]
        oct_sel = f_octave[fsel].to(torch.int32)
        info = 1.0 / (1.2 ** (2.0 * oct_sel.float()))
        R, t, inl, n_in = optimize_pose(R0, t0, pts, uv_obs, info, vsel, camera,
                                        device=dev)
        return dict(R=R, t=t, sel=sel.to(torch.int32), fidx=fsel.to(torch.int32),
                    vsel=vsel, inl=inl & vsel, nm=nm.to(torch.int32), n_in=n_in,
                    fr=fr, uv=uv_obs, oct=oct_sel)

    acq = final = _zeros_result(K, cap, dev)
    stage = 0
    while stage < 4:
        if stage == 3:
            R0, t0 = acq["R"], acq["t"]
        elif stage == 2:
            R0, t0 = R_last, t_last
        else:
            R0, t0 = R_pred, t_pred
        out = attempt(R0, t0, radii[stage])
        nm = int(out["nm"])
        if stage == 3:
            # refinement accepted on match count; else keep the acquisition
            # result but report the refinement's frustum mask, as the
            # reference does
            final = out if nm >= min_inliers else dict(acq, fr=out["fr"])
            stage = 4
        elif nm >= min_matches:
            acq, stage = out, 3
        elif stage == 0:
            stage = 1
        else:
            stage = 2 if stage == 1 and allow_last else 5
    return stage == 4, final
