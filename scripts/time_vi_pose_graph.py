"""Time the visual-inertial pose solve on the card: eager against its CUDA
graph, for both variants at a frame's capacity of rows.

    python3 scripts/time_vi_pose_graph.py [--cap 1000] [--visible 400] [--reps 50]

The problem: a simulated IMU trajectory (`utils/synth.py:simulate_imu`),
two frames 50 ms apart (20 Hz), `--visible` landmarks seen by the second
with 0.5 px noise in `--cap` padded rows, EuRoC's pinhole intrinsics; the
frame variant takes the marginalization prior of a keyframe-variant solve
of the frame before. Per variant it prints one JSON line: the host time of
a whole solve (upload, launches or replay, read-back), eager and replayed,
medians over `--reps`; the first graph call (warm-up and capture); the
device time of one replay (CUDA events around `--reps` replays); and, from
torch.profiler over one replay, the graph's device operations (its nodes)
and their summed time. Then one line with a capture made while another
thread calls `torch.cuda.synchronize()`, which CUDA forbids while a stream
of the device is capturing: whether the capture held. Needs a card; no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from orbslam3_tpu_torch.core.camera import Camera  # noqa: E402
from orbslam3_tpu_torch.imu import preintegration as P  # noqa: E402
from orbslam3_tpu_torch.opt.pose_inertial import (BodyState, PoseInertialGraphs,  # noqa: E402
                                                  optimize_pose_inertial)
from orbslam3_tpu_torch.utils.synth import simulate_imu  # noqa: E402


def problem(cap: int, visible: int, seed: int = 7):
    """Host arrays of one frame's solve and a prior from the frame before."""
    rng = np.random.default_rng(seed)
    traj = simulate_imu(duration=1.0, seed=seed)
    i, j, k = 100, 110, 120  # 200 Hz: 50 ms apart
    cam = Camera.pinhole(458.654, 457.296, 367.215, 248.375, device="cpu")
    calib = P.ImuCalib.create()
    f32 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32)  # noqa: E731

    def window(a, b):
        return P.preintegrate(*(f32(x[a:b]) for x in (traj.acc, traj.gyro, traj.dt)),
                              torch.zeros(6), calib)

    def rows(f):
        xc = np.stack([rng.uniform(-3, 3, visible), rng.uniform(-2, 2, visible),
                       rng.uniform(3, 10, visible)], -1)
        pts = xc @ traj.R_wb[f].T + traj.p_wb[f]
        uv = cam.project(f32(xc)).numpy() + rng.normal(0, 0.5, (visible, 2))
        out = (np.zeros((cap, 3), np.float32), np.zeros((cap, 2), np.float32),
               np.ones(cap, np.float32), np.zeros(cap, bool))
        out[0][:visible], out[1][:visible], out[3][:visible] = pts, uv, True
        return out

    def state(f, dp):
        return BodyState(*(np.asarray(x, np.float32) for x in
                           (traj.R_wb[f], traj.p_wb[f] + dp, traj.v_wb[f], np.zeros(6))))

    return dict(cam=cam, calib=calib, pre_kf=window(i, j), anchor=state(i, 0.0),
                cur_kf=state(j, 0.02), rows_kf=rows(j), pre_fr=window(j, k),
                cur_fr=state(k, 0.02), rows_fr=rows(k))


def median_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def variant(prob, name: str, dev, reps: int) -> dict:
    cam, calib = prob["cam"].to(dev), prob["calib"].to(dev)
    t = lambda s: BodyState(*(torch.from_numpy(x).to(dev) for x in s))  # noqa: E731
    if name == "keyframe":
        pre, cur, rows, prior = prob["pre_kf"].to(dev), prob["cur_kf"], prob["rows_kf"], None
    else:
        first = optimize_pose_inertial(t(prob["anchor"]), t(prob["cur_kf"]),
                                       prob["pre_kf"].to(dev), calib,
                                       *(torch.from_numpy(x).to(dev) for x in prob["rows_kf"]),
                                       cam)
        pre, cur, rows, prior = prob["pre_fr"].to(dev), prob["cur_fr"], prob["rows_fr"], first[3]
    anchor = prob["anchor"] if prior is None else None

    def eager():
        out = optimize_pose_inertial(prior.state if prior else t(anchor), t(cur), pre, calib,
                                     *(torch.from_numpy(x).to(dev) for x in rows), cam,
                                     prior=prior, anchor_fixed=prior is None)
        return [x.cpu() for x in out[0]], out[1].cpu()

    graphs = PoseInertialGraphs()

    def replayed():
        return graphs.solve(cur, pre, calib, cam, *rows, anchor=anchor, prior=prior,
                            anchor_fixed=prior is None)

    eager()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = replayed()
    first_ms = (time.perf_counter() - t0) * 1e3
    out = dict(variant=name, cap=len(rows[0]), inliers=got[2], first_call_ms=first_ms,
               eager_ms=median_ms(eager, max(5, reps // 5)), replay_ms=median_ms(replayed, reps))
    graph = next(iter(graphs.graphs.values()))._graph
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    out["replay_device_ms"] = start.elapsed_time(end) / reps
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    ops = [e for e in prof.profiler.kineto_results.events() if "CUDA" in str(e.device_type())]
    out["graph_nodes"] = len(ops)
    out["graph_kernel_ms"] = sum(e.duration_ns() for e in ops) * 1e-6
    return out


def capture_beside_a_device_sync(prob, dev) -> dict:
    """A capture while another thread synchronizes the whole device."""
    stop, errors, rounds = threading.Event(), [], [0]

    def spin():
        while not stop.is_set():
            try:
                torch.cuda.synchronize()
            except RuntimeError as e:  # reported in the result
                errors.append(repr(e))
            rounds[0] += 1

    other = threading.Thread(target=spin)
    other.start()
    try:
        graphs = PoseInertialGraphs()
        got = graphs.solve(prob["cur_kf"], prob["pre_kf"].to(dev), prob["calib"].to(dev),
                           prob["cam"].to(dev), *prob["rows_kf"], anchor=prob["anchor"])
        held = dict(captured=True, inliers=got[2])
    except RuntimeError as e:
        held = dict(captured=False, error=repr(e)[:300])
    finally:
        stop.set()
        other.join(timeout=30)
    return dict(check="capture_beside_device_synchronize", sync_rounds=rounds[0],
                sync_errors=errors[:3], n_sync_errors=len(errors), **held)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cap", type=int, default=1000)
    ap.add_argument("--visible", type=int, default=400)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_vi_pose_graph: needs an NVIDIA card")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    prob = problem(args.cap, args.visible)
    for name in ("keyframe", "prior"):
        print(json.dumps(dict(variant(prob, name, dev, args.reps), card=smi)), flush=True)
    print(json.dumps(capture_beside_a_device_sync(prob, dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
