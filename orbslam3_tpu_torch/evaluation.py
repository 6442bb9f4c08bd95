"""Trajectory evaluation: ATE RMSE after Horn alignment with optimal scale.

The port's own copy of `orbslam3_tpu/evaluation.py` (ORB-SLAM3's
`evaluate_ate_scale.py` alignment and `associate.py` timestamp
association). Pure numpy, host-side analysis tooling.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(est: np.ndarray, gt: np.ndarray, with_scale: bool = True):
    """Least-squares similarity aligning est -> gt.

    est, gt: (N, 3). Returns (s, R, t) with gt ~= s * R @ est + t.
    Horn/Umeyama closed form — the reference's `align` computes the same
    rotation and its `--scale` mode the same optimal scale.
    """
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    xe = est - mu_e
    xg = gt - mu_g
    cov = xg.T @ xe / len(est)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_e = (xe ** 2).sum() / len(est)
        s = float(np.trace(np.diag(D) @ S) / max(var_e, 1e-12))
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est: np.ndarray, gt: np.ndarray, with_scale: bool = True) -> float:
    """RMS absolute trajectory error after alignment (meters)."""
    s, R, t = umeyama_alignment(est, gt, with_scale)
    aligned = s * est @ R.T + t
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=-1))))


def aligned_pose_errors(kf_centres, kf_centres_gt, R_wc, c, R_wc_gt, c_gt):
    """Pose errors of cameras in a map's frame after the map's own Sim3
    alignment: the similarity that takes the keyframe centres (K, 3) onto
    their ground truth (`umeyama_alignment` with scale) moves each camera
    (R_wc (N,3,3), centre c (N,3)) into the truth's frame. Returns
    (centre errors (N,) in the truth's units, rotation errors (N,) in
    degrees)."""
    s, R, t = umeyama_alignment(np.asarray(kf_centres, np.float64),
                                np.asarray(kf_centres_gt, np.float64))
    c_al = s * np.asarray(c, np.float64) @ R.T + t
    d_c = np.linalg.norm(c_al - np.asarray(c_gt, np.float64), axis=-1)
    R_err = np.swapaxes(np.asarray(R_wc_gt, np.float64), -1, -2) @ R @ np.asarray(
        R_wc, np.float64)
    cos = np.clip((np.trace(R_err, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0)
    return d_c, np.degrees(np.arccos(cos))


def associate(ts_a: np.ndarray, ts_b: np.ndarray, max_dt: float = 0.02):
    """Nearest-timestamp association (reference associate.py). Returns index
    pairs (ia, ib)."""
    ib = np.searchsorted(ts_b, ts_a)
    ib = np.clip(ib, 1, len(ts_b) - 1)
    left = ts_b[ib - 1]
    right = ts_b[ib]
    ib = np.where(np.abs(ts_a - left) < np.abs(ts_a - right), ib - 1, ib)
    ok = np.abs(ts_a - ts_b[ib]) < max_dt
    return np.nonzero(ok)[0], ib[ok]


def vi_metrics(poses, kf_R, kf_t, kf_ts, frame_ts, R_cw_gt, t_cw_gt) -> dict:
    """The checks of a mono-inertial run against ground truth, as
    `tests/test_vi_golden.py` makes them (body == camera):

    - `ate_metric` / `ate_sim3`: ATE of the (ts, R_wc, t_wc) poses after a
      rigid / a similarity alignment (the IMU fixes the scale, so the rigid
      one is the metric error);
    - `kf_ate_metric` and `kf_scale`: the keyframe centres' rigid ATE and
      the scale of their similarity alignment;
    - `gravity_tilt_deg`: median over keyframes of the angle between the
      map's -z and true gravity, through each keyframe's true rotation."""
    frame_ts = np.asarray(frame_ts, np.float64)
    centres_gt = -np.einsum("nji,nj->ni", R_cw_gt, t_cw_gt)

    def at(ts):
        return np.asarray([int(np.argmin(np.abs(frame_ts - x))) for x in ts], np.int64)

    est = np.asarray([p[2] for p in poses], np.float64)
    gt = centres_gt[at([p[0] for p in poses])]
    kf_R = np.asarray(kf_R, np.float64)
    kf_c = -np.einsum("nji,nj->ni", kf_R, np.asarray(kf_t, np.float64))
    gi = at(kf_ts)
    s_kf, _, _ = umeyama_alignment(kf_c, centres_gt[gi], with_scale=True)
    # map world <- true world is R_wc(map) R_cw(true); true gravity is -z
    g_map = np.einsum("nji,njk,k->ni", kf_R, R_cw_gt[gi], np.array([0.0, 0.0, -1.0]))
    tilt = np.degrees(np.arccos(np.clip(-g_map[:, 2], -1.0, 1.0)))
    return dict(ate_metric=ate_rmse(est, gt, with_scale=False),
                ate_sim3=ate_rmse(est, gt, with_scale=True),
                kf_ate_metric=ate_rmse(kf_c, centres_gt[gi], with_scale=False),
                kf_scale=float(s_kf), gravity_tilt_deg=float(np.median(tilt)))
