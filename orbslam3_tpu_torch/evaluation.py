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
