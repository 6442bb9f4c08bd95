"""Time one retry-ladder attempt of `fused_track_pose` on the card: eager
against its two CUDA graphs with K1 launched between them.

    python3 scripts/time_track_pose_graph.py [--K 2048] [--cap 1000] [--points 600] [--reps 50]

The frame is `utils.synth.tracking_frame`'s (the card tests' too):
`--points` map points 4-12 m before a pinhole camera at EuRoC's
intrinsics, padded to `--K` candidates (the tracker's `local_points_cap`);
their projections with 0.3 px noise, octaves 0-2, shuffled among `--cap`
feature rows (the tracker's `n_features`) whose rest are clutter; a
prediction 1 cm off. Per camera kind (monocular, and with right
coordinates on 60% of the features) it prints one JSON line: the host time
of one attempt ending in the host read of its match count, eager and
replayed, medians over `--reps`; the first replayed call (warm-up and the
capture of both graphs); the whole ladder (two attempts here) eager and
replayed; the device time of each graph's replay (CUDA events around
`--reps` replays); and, from torch.profiler over one replay of each, the
graphs' device operations (their nodes) and their summed time. Needs a
card; no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from orbslam3_tpu_torch.engine import track_program as tp  # noqa: E402
from orbslam3_tpu_torch.utils.synth import tracking_frame  # noqa: E402

RADII = (15.0, 30.0, 60.0, 8.0)
MAX_DIST = 100


def median_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_ms(graph, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def nodes(graph) -> tuple[int, float]:
    """(device operations of one replay, their summed ms)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    ops = [e for e in prof.profiler.kineto_results.events() if "CUDA" in str(e.device_type())]
    return len(ops), sum(e.duration_ns() for e in ops) * 1e-6


def kind(dev, args, stereo: bool) -> dict:
    frame, R, t = tracking_frame(dev, args.K, args.cap, args.points, stereo)

    def eager():
        return int(tp._eager_attempt(frame, MAX_DIST, R, t, RADII[0])["nm"])

    graphs = tp.TrackPoseGraphs()
    graph = graphs.get(args.K, args.cap, stereo, frame[6], MAX_DIST, dev)

    def replayed():
        graph.load(*frame)
        return int(graph.replay(R, t, RADII[0])["nm"])

    def ladder(g):
        return tp.fused_track_pose(*frame[:11], R, t, R, t, False, RADII, 20, 15,
                                   max_dist=MAX_DIST, device=dev, u_right=frame[11],
                                   bf=frame[12], graphs=g)[0]

    eager()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nm = replayed()
    out = dict(kind="stereo" if stereo else "mono", K=args.K, cap=args.cap, matches=nm,
               first_call_ms=(time.perf_counter() - t0) * 1e3,
               eager_ms=median_ms(eager, max(5, args.reps // 5)),
               replay_ms=median_ms(replayed, args.reps),
               ladder_eager_ms=median_ms(lambda: ladder(None), max(5, args.reps // 5)),
               ladder_replay_ms=median_ms(lambda: ladder(graphs), args.reps))
    for name, g in (("pre", graph._pre), ("post", graph._post)):
        out[f"{name}_device_ms"] = device_ms(g, args.reps)
        out[f"{name}_nodes"], out[f"{name}_kernel_ms"] = nodes(g)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--K", type=int, default=2048)
    ap.add_argument("--cap", type=int, default=1000)
    ap.add_argument("--points", type=int, default=600)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_track_pose_graph: needs an NVIDIA card")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    for stereo in (False, True):
        print(json.dumps(dict(kind(dev, args, stereo), card=smi)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
