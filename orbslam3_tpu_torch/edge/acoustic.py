"""Acoustic-ranging fusion: the chirp-interval distance model and the five
small Levenberg-Marquardt solves of the ORB-SLAM3 fork.

Port of `orbslam3_tpu/edge/acoustic.py`:

* the distance model ``d = c(T)·(n1+n2)/(2·fs) + k``, with the speed of
  sound ``c = 331.3 + 0.606·T`` at 48 kHz, offset k = 0.0272 m, accepted
  over 0-4 m;
* the range factor ``d − s·‖T − p‖``, the relative-position factor
  ``Δ − (T₁ − T₂)`` and the microphone-calibration factor;
* the fork's five fusion solves (PoseOptimizationDistanceGivenScale,
  PoseOptimizationDistanceRegu, IMUAcousticOptimization,
  IMUAcousticKeyOptimization, CalibOptimization).

Each is a dense problem of at most tens of variables: a fixed 10
iterations of LM (the fork's ``optimizer.optimize(10)``), the Jacobian by
`torch.func.jacfwd`, a step kept only if it lowers the cost, damping
x0.3 on a kept step and x5 on a rejected one. Everything is float32 on
``device``: the card unless the caller asks for the CPU. Under
`jacfwd`, per-problem scalars keep a trailing axis of 1, so that no
0-dim operand meets a Python number (that gives float64 tangents).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd

from orbslam3_tpu_torch import device as device_policy

SAMPLE_RATE = 48000.0
K_DISTANCE = 0.0272
MAX_RANGE_M = 4.0
TEMPERATURE_C = 27.1
SPEED_OF_SOUND = 331.3 + 0.606 * TEMPERATURE_C  # m/s at TEMPERATURE_C
LM_ITERS = 10  # the fork's optimizer.optimize(10)


def _f32(x, dev) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def interval_to_distance(n1, n2, device=None):
    """Two-way chirp sample intervals -> metric distance (the fork's
    CalAcoustic). Returns (distance, valid) with the 0-4 m gate."""
    dev = device_policy.resolve(device)
    n1, n2 = _f32(n1, dev), _f32(n2, dev)
    d = SPEED_OF_SOUND * (n1 + n2) / (2.0 * SAMPLE_RATE) + K_DISTANCE
    return d, (d > 0.0) & (d < MAX_RANGE_M)


def _lm(residual_fn, x0: torch.Tensor, n_iters: int = LM_ITERS) -> torch.Tensor:
    """Dense LM over a flat parameter vector, `n_iters` steps: forward-mode
    Jacobian, a step kept only if it lowers the cost, damping x0.3 on a
    kept step and x5 on a rejected one."""
    x = x0
    lam = torch.full((1,), 1e-4, dtype=x0.dtype, device=x0.device)
    eye = torch.eye(x0.shape[0], dtype=x0.dtype, device=x0.device)
    jac = jacfwd(residual_fn)
    for _ in range(n_iters):
        r = residual_fn(x)
        J = jac(x)
        H = J.T @ J
        g = J.T @ r
        dx = torch.linalg.solve(H + lam * eye, -g)
        x_new = x + dx
        r_new = residual_fn(x_new)
        better = torch.dot(r_new, r_new) < torch.dot(r, r)
        x = torch.where(better, x_new, x)
        lam = torch.where(better, lam * 0.3, lam * 5.0)
    return x


def _range_residuals(T, anchors, distances, scale, valid=None):
    """Range residuals d_i − s·‖T − p_i‖ of one position against M anchors."""
    diff = T[None, :] - anchors
    r = distances - scale * torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)
    if valid is not None:
        r = torch.where(valid, r, torch.zeros_like(r))
    return r


def _scale(scale, dev) -> torch.Tensor:
    return _f32(scale, dev).reshape(-1)[:1]  # (1,), not 0-dim


def _mask(valid, dev):
    if valid is None:
        return None
    if isinstance(valid, torch.Tensor):
        return valid.to(device=dev, dtype=torch.bool)
    return torch.as_tensor(np.asarray(valid, bool), device=dev)


def optimize_position_given_scale(pos, anchors, distances, scale, valid=None,
                                  device=None) -> torch.Tensor:
    """Trilaterate one position from ranges to others at a known scale
    (PoseOptimizationDistanceGivenScale)."""
    dev = device_policy.resolve(device)
    pos, anchors, distances = (_f32(x, dev) for x in (pos, anchors, distances))
    s, vm = _scale(scale, dev), _mask(valid, dev)
    return _lm(lambda x: _range_residuals(x, anchors, distances, s, vm), pos)


def optimize_position_regularized(pos, pos_last, anchors, distances, scale, valid=None,
                                  device=None) -> torch.Tensor:
    """The same trilateration plus a zero-distance range to the previous
    estimate (PoseOptimizationDistanceRegu: one more range factor with
    measurement 0 anchored at pose_last)."""
    dev = device_policy.resolve(device)
    pos, pos_last, anchors, distances = (_f32(x, dev) for x in
                                         (pos, pos_last, anchors, distances))
    s, vm = _scale(scale, dev), _mask(valid, dev)

    def res(x):
        r = _range_residuals(x, anchors, distances, s, vm)
        return torch.cat([r, -s * torch.linalg.norm(x - pos_last)])

    return _lm(res, pos)


def imu_acoustic_optimize(pos, delta_pos, anchors, distances, scale, valid=None,
                          device=None) -> torch.Tensor:
    """Fuse an IMU dead-reckoned chain of positions with ranges on the
    latest one (IMUAcousticOptimization): relative-position factors
    Δp_t − (p_t − p_{t−1}) for t = 1..T−1 and range factors on p_{T−1};
    every position is free."""
    dev = device_policy.resolve(device)
    pos, delta_pos, anchors, distances = (_f32(x, dev) for x in
                                          (pos, delta_pos, anchors, distances))
    s, vm = _scale(scale, dev), _mask(valid, dev)
    T = pos.shape[0]

    def res(x):
        p = x.reshape(T, 3)
        rel = (delta_pos[1:] - (p[1:] - p[:-1])).reshape(-1)
        return torch.cat([rel, _range_residuals(p[-1], anchors, distances, s, vm)])

    return _lm(res, pos.reshape(-1)).reshape(T, 3)


def imu_acoustic_key_optimize(pos, delta_p, distances, anchors, scale, valid=None,
                              device=None) -> torch.Tensor:
    """Keyframe-chain fusion (IMUAcousticKeyOptimization): the first
    position fixed; relative-position factors delta_p[t−1] − (p_t − p_{t−1})
    and range factors distances[t−1, j] on p_t for t = 1..T−1."""
    dev = device_policy.resolve(device)
    pos, delta_p, distances, anchors = (_f32(x, dev) for x in
                                        (pos, delta_p, distances, anchors))
    s = _scale(scale, dev)
    vm = _mask(valid, dev)
    if vm is None:
        vm = torch.ones_like(distances, dtype=torch.bool)
    T = pos.shape[0]
    p0 = pos[:1]

    def res(x):
        p = torch.cat([p0, x.reshape(T - 1, 3)], dim=0)
        rel = (delta_p - (p[1:] - p[:-1])).reshape(-1)
        diff = p[1:, None, :] - anchors[None]
        rng = distances - s * torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)
        rng = torch.where(vm, rng, torch.zeros_like(rng))
        return torch.cat([rel, rng.reshape(-1)])

    x = _lm(res, pos[1:].reshape(-1))
    return torch.cat([p0, x.reshape(T - 1, 3)], dim=0)


def calibrate_mic_offset(t_mc, scale, R0, t0, R_others, t_others, distances, valid=None,
                         n_iters: int = LM_ITERS, device=None):
    """Joint microphone offset and metric scale (CalibOptimization): t_mc
    (the microphone in the camera frame) and s (world -> SLAM scale) from
    K poses of user 0, M poses of the others and a (K, M) distance table,
    err = d − ‖t_wm0 − t_wm1‖ / s with t_wm = R·(−s·t_mc) + t. Returns
    (t_mc, s) after `n_iters` LM steps."""
    dev = device_policy.resolve(device)
    R0, t0, R_others, t_others, distances = (_f32(x, dev) for x in
                                             (R0, t0, R_others, t_others, distances))
    vm = _mask(valid, dev)

    def res(x):
        mc, s = x[:3], x[3:4]
        wm0 = torch.einsum('kij,j->ki', R0, -s * mc) + t0
        wm1 = torch.einsum('mij,j->mi', R_others, -s * mc) + t_others
        diff = wm0[:, None, :] - wm1[None, :, :]
        d = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12) / s
        r = (distances - d).reshape(-1)
        if vm is not None:
            r = torch.where(vm.reshape(-1), r, torch.zeros_like(r))
        return r

    x0 = torch.cat([_f32(t_mc, dev).reshape(3), _scale(scale, dev)])
    x = _lm(res, x0, n_iters)
    return x[:3], x[3]
