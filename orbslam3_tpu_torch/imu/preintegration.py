"""IMU preintegration between two frames.

Port of `orbslam3_tpu/imu/preintegration.py` (ORB-SLAM3's
`IMU::Preintegrated`): the delta rotation, velocity and position between
two frames, the 9x9 covariance of (phi, v, p) and the 6x6 bias random walk
over the interval, and the Jacobians of the deltas with respect to the gyro
and accelerometer biases, used for first-order bias correction.

The reference scans a padded 128-sample buffer under `lax.scan`, masking
the padding; here the samples with ``dt > 0`` are integrated by a Python
loop (about ten between two frames at 200 Hz / 20 fps), the same math
step for step. Everything stays on the device of the inputs.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from orbslam3_tpu_torch.core import lie

GRAVITY = 9.81  # reference GRAVITY_VALUE


def gravity_vec(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.tensor([0.0, 0.0, -GRAVITY], dtype=dtype, device=device)


@dataclasses.dataclass
class ImuCalib:
    """Noise model and extrinsics (reference `IMU::Calib`): the body<-camera
    transform and the continuous-time noise and random-walk variances."""

    Rbc: torch.Tensor          # (3,3) body<-camera rotation
    tbc: torch.Tensor          # (3,)
    gyro_noise2: torch.Tensor  # () [rad/s/sqrt(Hz)]^2
    acc_noise2: torch.Tensor   # () [m/s^2/sqrt(Hz)]^2
    gyro_walk2: torch.Tensor
    acc_walk2: torch.Tensor

    @staticmethod
    def create(Tbc=None, noise_gyro=1.7e-4, noise_acc=2.0e-3, walk_gyro=1.9e-5,
               walk_acc=3.0e-3, freq=200.0) -> "ImuCalib":
        """EuRoC's noise densities by default; tensors on the CPU (a
        `Tracker` or `LocalMapper` moves them to its device). The sample
        rate is not used: each step discretizes with its own dt."""
        del freq
        f32 = torch.float32
        T = None if Tbc is None else torch.as_tensor(np.asarray(Tbc), dtype=f32)
        return ImuCalib(
            Rbc=torch.eye(3, dtype=f32) if T is None else T[:3, :3].clone(),
            tbc=torch.zeros(3, dtype=f32) if T is None else T[:3, 3].clone(),
            gyro_noise2=torch.tensor(noise_gyro ** 2, dtype=f32),
            acc_noise2=torch.tensor(noise_acc ** 2, dtype=f32),
            gyro_walk2=torch.tensor(walk_gyro ** 2, dtype=f32),
            acc_walk2=torch.tensor(walk_acc ** 2, dtype=f32))

    def to(self, device) -> "ImuCalib":
        return ImuCalib(**{f.name: getattr(self, f.name).to(device)
                           for f in dataclasses.fields(self)})

    def cam_from_body(self):
        """(Rcb, tcb): the camera<-body transform the solvers take."""
        Rcb = self.Rbc.T
        return Rcb, -Rcb @ self.tbc


class Preintegrated(NamedTuple):
    """Preintegrated deltas between two frames (reference `Preintegrated`)."""

    dT: torch.Tensor        # () total time
    dR: torch.Tensor        # (3,3)
    dV: torch.Tensor        # (3,)
    dP: torch.Tensor        # (3,)
    cov: torch.Tensor       # (9,9) covariance of (phi, v, p)
    cov_walk: torch.Tensor  # (6,6) bias random walk over the interval
    JRg: torch.Tensor       # (3,3) d(dR)/d(bg)
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    bias: torch.Tensor      # (6,) linearization bias (bg, ba)

    def to(self, device) -> "Preintegrated":
        return Preintegrated(*(x.to(device) for x in self))


def identity_preintegrated(dtype=torch.float32, device=None) -> Preintegrated:
    z3 = torch.zeros(3, dtype=dtype, device=device)
    z33 = torch.zeros((3, 3), dtype=dtype, device=device)
    return Preintegrated(
        dT=torch.zeros((), dtype=dtype, device=device),
        dR=torch.eye(3, dtype=dtype, device=device), dV=z3, dP=z3,
        cov=torch.zeros((9, 9), dtype=dtype, device=device),
        cov_walk=torch.zeros((6, 6), dtype=dtype, device=device),
        JRg=z33, JVg=z33, JVa=z33, JPg=z33, JPa=z33,
        bias=torch.zeros(6, dtype=dtype, device=device))


def _blocks(rows) -> torch.Tensor:
    return torch.cat([torch.cat(r, dim=1) for r in rows], dim=0)


def preintegrate(acc, gyro, dt, bias, calib: ImuCalib) -> Preintegrated:
    """Integrate an IMU window: (N,3) accelerometer and gyro samples, (N,)
    per-sample intervals (dt <= 0 marks padding, which is skipped) and the
    (6,) linearization bias, on the device of `acc`.

      dP += dV dt + 0.5 dR (a - ba) dt^2
      dV += dR (a - ba) dt
      dR  = dR Exp((w - bg) dt)

    with the covariance propagated through the linearized transition (A, B)
    and the bias Jacobians updated with the old dR (ImuTypes.cc:192-258).
    """
    acc = torch.as_tensor(acc)
    dev, dtype = acc.device, acc.dtype
    gyro = torch.as_tensor(gyro, dtype=dtype, device=dev)
    dt_host = np.asarray(torch.as_tensor(dt).cpu(), np.float32)
    dts = torch.as_tensor(dt_host, dtype=dtype, device=dev)
    bias = torch.as_tensor(bias, dtype=dtype, device=dev)
    bg, ba = bias[:3], bias[3:]
    nga = torch.diag(torch.stack([calib.gyro_noise2] * 3 + [calib.acc_noise2] * 3)
                     .to(dev, dtype))
    I3 = torch.eye(3, dtype=dtype, device=dev)
    Z3 = torch.zeros((3, 3), dtype=dtype, device=dev)
    dR, dV, dP = I3, torch.zeros(3, dtype=dtype, device=dev), torch.zeros(3, dtype=dtype, device=dev)
    cov = torch.zeros((9, 9), dtype=dtype, device=dev)
    JRg = JVg = JVa = JPg = JPa = Z3
    dT = torch.zeros((), dtype=dtype, device=dev)
    for i in np.nonzero(dt_host > 0)[0]:
        dt_i = dts[i]
        a = acc[i] - ba
        w = gyro[i] - bg
        dt2 = dt_i * dt_i
        a_hat = lie.hat(a)
        dRa = dR @ a
        dRah = dR @ a_hat
        dP_new = dP + dV * dt_i + 0.5 * dt2 * dRa
        dV_new = dV + dt_i * dRa
        JPa_new = JPa + JVa * dt_i - 0.5 * dt2 * dR
        JPg_new = JPg + JVg * dt_i - 0.5 * dt2 * (dRah @ JRg)
        JVa_new = JVa - dt_i * dR
        JVg_new = JVg - dt_i * (dRah @ JRg)
        phi = w * dt_i
        dRi = lie.so3_exp(phi)
        Jr = lie.so3_right_jacobian(phi)
        A = _blocks([[dRi.T, Z3, Z3],
                     [-dt_i * dRah, I3, Z3],
                     [-0.5 * dt2 * dRah, dt_i * I3, I3]])
        B = _blocks([[dt_i * Jr, Z3],
                     [Z3, dt_i * dR],
                     [Z3, 0.5 * dt2 * dR]])
        cov = A @ cov @ A.T + B @ (nga / torch.clamp(dt_i, min=1e-9)) @ B.T
        JRg = dRi.T @ JRg - dt_i * Jr
        dR, dV, dP = dR @ dRi, dV_new, dP_new
        JPa, JPg, JVa, JVg = JPa_new, JPg_new, JVa_new, JVg_new
        dT = dT + dt_i
    walk = torch.diag(torch.stack([calib.gyro_walk2] * 3 + [calib.acc_walk2] * 3)
                      .to(dev, dtype)) * dT
    return Preintegrated(dT=dT, dR=lie.so3_normalize(dR), dV=dV, dP=dP, cov=cov,
                         cov_walk=walk, JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg,
                         JPa=JPa, bias=bias)


# -- bias-corrected getters (reference GetDeltaRotation/Velocity/Position) ---

def delta_rotation(pre: Preintegrated, bias: torch.Tensor) -> torch.Tensor:
    return pre.dR @ lie.so3_exp(pre.JRg @ (bias[:3] - pre.bias[:3]))


def delta_velocity(pre: Preintegrated, bias: torch.Tensor) -> torch.Tensor:
    dbg, dba = bias[:3] - pre.bias[:3], bias[3:] - pre.bias[3:]
    return pre.dV + pre.JVg @ dbg + pre.JVa @ dba


def delta_position(pre: Preintegrated, bias: torch.Tensor) -> torch.Tensor:
    dbg, dba = bias[:3] - pre.bias[:3], bias[3:] - pre.bias[3:]
    return pre.dP + pre.JPg @ dbg + pre.JPa @ dba


def corrected_deltas(pre: Preintegrated, bias: torch.Tensor):
    """(dR, dV, dP, dT) corrected to `bias`."""
    return (delta_rotation(pre, bias), delta_velocity(pre, bias),
            delta_position(pre, bias), pre.dT)


def merge(prev: Preintegrated, nxt: Preintegrated) -> Preintegrated:
    """Concatenate two consecutive windows by composing their deltas (exact
    for equal linearization biases; the reference re-integrates the union
    of the samples, `MergePrevious`):
    dR = dR1 dR2, dV = dV1 + dR1 dV2, dP = dP1 + dV1 dT2 + dR1 dP2."""
    dR = prev.dR @ nxt.dR
    dV = prev.dV + prev.dR @ nxt.dV
    dP = prev.dP + prev.dV * nxt.dT + prev.dR @ nxt.dP
    I3 = torch.eye(3, dtype=prev.dR.dtype, device=prev.dR.device)
    Z3 = torch.zeros_like(I3)
    A = _blocks([[nxt.dR.T, Z3, Z3],
                 [-prev.dR @ lie.hat(nxt.dV), I3, Z3],
                 [-prev.dR @ lie.hat(nxt.dP), nxt.dT * I3, I3]])
    G = torch.block_diag(prev.dR, prev.dR, prev.dR)
    cov = A @ prev.cov @ A.T + G @ nxt.cov @ G.T
    JRg = nxt.dR.T @ prev.JRg + nxt.JRg
    JVg = prev.JVg + prev.dR @ nxt.JVg - prev.dR @ lie.hat(nxt.dV) @ prev.JRg
    JVa = prev.JVa + prev.dR @ nxt.JVa
    JPg = (prev.JPg + nxt.dT * prev.JVg + prev.dR @ nxt.JPg
           - prev.dR @ lie.hat(nxt.dP) @ prev.JRg)
    JPa = prev.JPa + nxt.dT * prev.JVa + prev.dR @ nxt.JPa
    return Preintegrated(dT=prev.dT + nxt.dT, dR=dR, dV=dV, dP=dP, cov=cov,
                         cov_walk=prev.cov_walk + nxt.cov_walk, JRg=JRg, JVg=JVg,
                         JVa=JVa, JPg=JPg, JPa=JPa, bias=prev.bias)


def merge_all(pres: list) -> Preintegrated:
    """Left fold of `merge` over consecutive windows."""
    out = pres[0]
    for p in pres[1:]:
        out = merge(out, p)
    return out


def predict_state(Rwb, twb, vw, pre: Preintegrated, bias):
    """IMU state prediction (reference `Tracking::PredictStateIMU`):
    R2 = R1 dR(b); v2 = v1 + g dT + R1 dV(b);
    p2 = p1 + v1 dT + 0.5 g dT^2 + R1 dP(b)."""
    g = gravity_vec(Rwb.dtype, Rwb.device)
    dT = pre.dT
    R2 = Rwb @ delta_rotation(pre, bias)
    v2 = vw + g * dT + Rwb @ delta_velocity(pre, bias)
    p2 = twb + vw * dT + 0.5 * g * dT * dT + Rwb @ delta_position(pre, bias)
    return R2, p2, v2
