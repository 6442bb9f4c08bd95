"""Per-stage timing harness.

Port of `orbslam3_tpu/utils/timing.py` (ORB-SLAM3's `REGISTER_TIMES`
instrumentation): per-frame stage timers in tracking and per-keyframe
timers in mapping, in a process-global registry of named series, and
`count()`, an always-on tally of named events.

`stage(name)` times host wall clock and does not synchronize the card:
callers time whole host-visible stages, which is what the reference
measures too. Disabled by default (a perf_counter pair when on); enable
with `timing.enable()` or ORBSLAM3_TORCH_TIMING=1. `transfer_audit`
counts the host<->device copies inside a block from torch.profiler's CUDA
memcpy events, where the reference counts JAX's transfer-guard log lines.
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


# -- host<->device copies ------------------------------------------------------

_SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


@contextlib.contextmanager
def transfer_audit(box: dict):
    """Counts the host<->device copies inside the block into `box`.

    Port of `orbslam3_tpu/utils/timing.py:transfer_audit`. The block runs
    under `torch.profiler` (with CUDA activity where a card is present); on
    exit `box["h2d"]` and `box["d2h"]` hold the CUDA memcpy events from host
    to device and back, and `box["syncs"]` the runtime's synchronize calls.
    Tensors on the CPU copy nothing, so the counts are 0 there. Nothing is
    redirected: stderr written inside the block stays where it was, and an
    error inside the block raises after the counts are taken."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    try:
        yield box
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        names = [e.name for e in prof.events()]
        box["h2d"] = sum("Memcpy HtoD" in n for n in names)
        box["d2h"] = sum("Memcpy DtoH" in n for n in names)
        box["syncs"] = sum(n in _SYNC_CALLS for n in names)
