#!/usr/bin/env python3
"""A traced run of a cell, with the card's idle time split by the port's
innermost stage open at each idle gap's start.

    python3 portbench/stage_idle.py --workload <cell> --seed <n> --seconds <s>

run from the repository root. The run is `run.py --trace 1`'s (set-up,
window, trace, judgement) and prints its result line; then one more JSON
line: the traced window's idle seconds by the innermost `timing` stage
(`harness.program_spans.innermost_at`) open when each gap of the device
(`Trace.gaps`) began, '(no stage)' where none was, largest first, with
the traced window's length and its idle total, and the count and mean
duration of the window's `slam.frame` spans. The benchmark's own
`breakdown.idle_gaps` names the benchmark's span and the CUDA runtime
call there instead.
"""

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import run as pb  # noqa: E402
from harness import program_spans, trace as trace_mod  # noqa: E402


def idle_by_stage(trace, spans) -> dict:
    gaps = trace.gaps()
    by: dict = {}
    for name, (a, b) in zip(program_spans.innermost_at(spans, gaps[:, 0]), gaps):
        by[name] = by.get(name, 0.0) + (b - a) * 1e-9
    return dict(window_s=trace.window_s, idle_s=sum(by.values()),
                idle_by_stage=sorted(([n, s] for n, s in by.items()), key=lambda kv: -kv[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    args.trace = 1
    traces = []
    stop = trace_mod.Profiler.stop

    def keep(self):
        stop(self)
        traces.append(self.trace)

    trace_mod.Profiler.stop = keep
    result = pb.measure(pb.prepare(args))
    print(json.dumps(result), flush=True)
    spans = program_spans.spans() or []
    frames = [(s.end_ns - s.start_ns) * 1e-6 for s in spans if s.name == "slam.frame"]
    print(json.dumps(dict(idle_by_stage(traces[-1], spans), slam_frames=len(frames),
                          slam_frame_ms_mean=sum(frames) / len(frames) if frames else None)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
