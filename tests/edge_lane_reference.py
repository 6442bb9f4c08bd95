"""A plain reference of one phone's lane in the edge server, in float64 on
the CPU: the fork's lane rule, and the IMU preintegration of a tracked
frame over every sample its phone sent since its previous tracked frame.

The edge server of the ORB-SLAM3 fork (JiangongChen/ORB_SLAM3-1,
`src/Socket/client.cc`, `Examples/Monocular-Inertial/mono_inertial_edge.cc`)
runs one Tracking lane per phone. This file restates, in numpy and plain
torch and without either package of this repository or JAX:

(a) `lane_rule`: which packets of a client are tracked, answered and
    skipped, and the feature budgets the server sends back
    (`client.cc:160-200`): 1000 features while initializing or lost, 500
    while tracking, a command when the state flips; a secondary client
    (id != 0) tracks only the frames whose id is a multiple of k (5) while
    it is not (re)initializing, its first frames too; every tracked packet
    is answered, a skipped one is not.
(b) `preintegrate`: ORB-SLAM3's `IMU::Preintegrated::IntegrateNewMeasurement`
    (Forster et al., "On-Manifold Preintegration for Real-Time
    Visual-Inertial Odometry", T-RO 2017), the deltas dR, dV, dP and dT
    at a given bias (gyro, accelerometer), over every sample with a
    timestamp in (t0, t1]:
        dP += dV dt + 0.5 dR (a - ba) dt^2
        dV += dR (a - ba) dt
        dR  = dR Exp((w - bg) dt)
        dT += dt

Departures from ORB-SLAM3, each as the port computes it:
- `Tracking::PreintegrateIMU` integrates each interval between two
  samples with their mean and interpolates the measurements at the two
  frame timestamps. Here each sample is held over the interval that ends
  at its own timestamp, the first interval starting at t0, with no
  interpolation: a sample-and-hold rule over the same samples.
- The covariance and the bias Jacobians are not computed: they follow
  from the same samples, and the deltas show which samples were used.
- dR is the plain product of the step rotations. In float64 it stays
  orthonormal to ~1e-15; ORB-SLAM3 renormalizes it at each step.
- Intervals of zero length (repeated timestamps) are skipped.

The lane in `orbslam3_tpu_torch/edge/server.py` departs from the fork on
purpose: the fork drops a skipped packet's IMU with the packet
(`client.cc:166`, before `GrabImuData`), so a secondary client's tracked
frame integrates one frame interval of a five-frame step. The port's lane
hands those samples on, and (b) holds it to every sample sent.

Timestamps are integer nanoseconds, as the wire carries them.
"""

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

K_TRACK = 5
N_FEATURES_INIT = 1000
N_FEATURES_TRACKING = 500


def lane_rule(client_id: int, frame_ids, ok, k: int = K_TRACK,
              budget_init: int = N_FEATURES_INIT,
              budget_tracking: int = N_FEATURES_TRACKING) -> dict:
    """The fork's lane over a client's packets, in arrival order.

    `frame_ids`: the packets' frame ids; `ok(frame_id)`: whether tracking
    that packet gave a pose (asked only of tracked packets). Returns the
    ids `tracked`, `answered` and `skipped`, and `budgets`, the feature
    counts sent back, in order."""
    init = False
    tracked, skipped, budgets = [], [], []
    for fid in frame_ids:
        if client_id != 0 and not init and fid % k != 0:
            skipped.append(fid)
            continue
        tracked.append(fid)
        good = bool(ok(fid))
        if not init and not good:
            budgets.append(budget_init)
            init = True
        elif init and good:
            budgets.append(budget_tracking)
            init = False
    return dict(tracked=tracked, answered=list(tracked), skipped=skipped, budgets=budgets)


def _hat(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros((), dtype=v.dtype)
    return torch.stack([torch.stack([z, -v[2], v[1]]),
                        torch.stack([v[2], z, -v[0]]),
                        torch.stack([-v[1], v[0], z])])


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula; the series to second order below 1e-4 rad."""
    theta = torch.linalg.vector_norm(phi)
    K = _hat(phi)
    eye = torch.eye(3, dtype=phi.dtype)
    if float(theta) < 1e-4:
        return eye + K + 0.5 * (K @ K)
    return eye + (torch.sin(theta) / theta) * K + ((1 - torch.cos(theta)) / theta ** 2) * (K @ K)


def samples_in(ts_ns, t0_ns: int, t1_ns: int) -> np.ndarray:
    """Indices of the samples with t0 < ts <= t1, in timestamp order."""
    ts_ns = np.asarray(ts_ns, np.int64)
    idx = np.nonzero((ts_ns > t0_ns) & (ts_ns <= t1_ns))[0]
    return idx[np.argsort(ts_ns[idx], kind="stable")]


def preintegrate(ts_ns, gyro, acc, t0_ns: int, t1_ns: int, bias,
                 dtype=torch.float64) -> dict:
    """(b) over the samples in (t0_ns, t1_ns]: `ts_ns` (m,) int64, `gyro`
    and `acc` (m, 3), `bias` (6,) = (bg, ba). Returns dR (3, 3), dV, dP
    (3,) and dT, float64 numpy, computed in `dtype`."""
    idx = samples_in(ts_ns, t0_ns, t1_ns)
    stamps = np.concatenate([[t0_ns], np.asarray(ts_ns, np.int64)[idx]])
    dts = np.diff(stamps).astype(np.float64) * 1e-9
    w = torch.as_tensor(np.asarray(gyro, np.float64)[idx], dtype=dtype)
    a = torch.as_tensor(np.asarray(acc, np.float64)[idx], dtype=dtype)
    b = torch.as_tensor(np.asarray(bias, np.float64), dtype=dtype)
    dR = torch.eye(3, dtype=dtype)
    dV = torch.zeros(3, dtype=dtype)
    dP = torch.zeros(3, dtype=dtype)
    dT = torch.zeros((), dtype=dtype)
    for i, dt_s in enumerate(dts):
        if dt_s <= 0:
            continue
        dt = torch.tensor(dt_s, dtype=dtype)
        acc_w = dR @ (a[i] - b[3:])
        dP = dP + dV * dt + 0.5 * acc_w * dt * dt
        dV = dV + acc_w * dt
        dR = dR @ so3_exp((w[i] - b[:3]) * dt)
        dT = dT + dt
    return dict(dR=dR.double().numpy(), dV=dV.double().numpy(), dP=dP.double().numpy(),
                dT=float(dT))


def relative_error(got: dict, ref: dict) -> float:
    """The worst of the four deltas' relative errors: |x - x_ref| / |x_ref|
    (Frobenius for dR, Euclidean for dV and dP)."""
    errs = []
    for key in ("dR", "dV", "dP", "dT"):
        x = np.asarray(got[key], np.float64)
        r = np.asarray(ref[key], np.float64)
        errs.append(float(np.linalg.norm(x - r) / np.linalg.norm(r)))
    return max(errs)
