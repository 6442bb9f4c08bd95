"""Per-stage timing harness.

Port of `orbslam3_tpu/utils/timing.py` (ORB-SLAM3's `REGISTER_TIMES`
instrumentation): per-frame stage timers in tracking and per-keyframe
timers in mapping, in a process-global registry of named series, and
`count()`, an always-on tally of named events.

`stage(name)` times host wall clock and does not synchronize the card:
callers time whole host-visible stages, which is what the reference
measures too. Disabled by default (a perf_counter pair when on); enable
with `timing.enable()` or ORBSLAM3_TORCH_TIMING=1. The reference's
`transfer_audit` counts JAX's host<->device transfers and has no
counterpart here.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import numpy as np

_enabled = bool(int(os.environ.get("ORBSLAM3_TORCH_TIMING", "0")))
_series: dict[str, list] = defaultdict(list)


def enable(on: bool = True):
    global _enabled
    _enabled = on


def enabled() -> bool:
    return _enabled


def reset():
    _series.clear()


@contextlib.contextmanager
def stage(name: str):
    """Time a stage; appends milliseconds to the named series when enabled."""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _series[name].append((time.perf_counter() - t0) * 1e3)


def record(name: str, ms: float):
    if _enabled:
        _series[name].append(ms)


def stats() -> dict[str, dict]:
    """{stage: {n, mean_ms, median_ms, p90_ms, total_ms}}."""
    out = {}
    for name, xs in _series.items():
        a = np.asarray(xs)
        out[name] = dict(n=len(a), mean_ms=float(a.mean()),
                         median_ms=float(np.median(a)),
                         p90_ms=float(np.percentile(a, 90)),
                         total_ms=float(a.sum()))
    return out


def print_time_stats(file=None):
    """`Tracking::PrintTimeStats` equivalent: mean/median per stage."""
    import sys
    f = file or sys.stdout
    rows = sorted(stats().items())
    if not rows:
        print("(timing disabled or no samples)", file=f)
        return
    w = max(len(n) for n, _ in rows)
    print(f"{'stage'.ljust(w)}      n     mean ms   median ms      p90 ms",
          file=f)
    for name, s in rows:
        print(f"{name.ljust(w)} {s['n']:6d} {s['mean_ms']:11.2f} "
              f"{s['median_ms']:11.2f} {s['p90_ms']:11.2f}", file=f)


def save(path: str = "ExecTimeMean.txt"):
    with open(path, "w") as f:
        print_time_stats(file=f)


# -- event counts ------------------------------------------------------------
# `count()` tallies named events at hot-path call sites (an int increment,
# always on).

_counts: dict[str, int] = defaultdict(int)


def count(name: str, k: int = 1):
    _counts[name] += k


def counts() -> dict[str, int]:
    return dict(_counts)


def reset_counts():
    _counts.clear()
