"""Per-stage timing: the port's one span recorder.

Port of `orbslam3_tpu/utils/timing.py` (ORB-SLAM3's `REGISTER_TIMES`
instrumentation): per-frame stage timers in tracking and per-keyframe
timers in mapping, grown into spans, and `count()`, an always-on tally of
named events.

When timing is enabled (`timing.enable()` or ORBSLAM3_TORCH_TIMING=1),
`stage(name, **fields)` appends the stage's duration in ms on
`perf_counter` to the named series behind `stats()`, and keeps a `Span`:
its start and end on the host clock that torch.profiler's kineto events
carry (unix-time nanoseconds, `time.time_ns()`), its thread, the
enclosing stage open on the same thread (`parent`), the outermost one
(`root`: a frame's `slam.frame`, whose fields name the client and the
frame), and the caller's fields. `spans()` returns them in the order
they closed; the newest `MAX_SPANS` are kept. Disabled, a stage is a shared null
context. A stage does not synchronize the card: callers time whole
host-visible stages, which end in a host read, as the reference's timers
do. `transfer_audit` counts the host<->device copies inside a block from
torch.profiler's CUDA memcpy events, where the reference counts JAX's
transfer-guard log lines.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import NamedTuple

import numpy as np

# an hour of frames at 20 Hz, 16 stages each
MAX_SPANS = 3600 * 20 * 16

_enabled = bool(int(os.environ.get("ORBSLAM3_TORCH_TIMING", "0")))
_series: dict[str, list] = collections.defaultdict(list)
_spans: collections.deque = collections.deque(maxlen=MAX_SPANS)
_ids = itertools.count()   # span ids, unique in the process (reset keeps counting)
_open = threading.local()  # .stack: ids of the stages open on this thread
_counts: dict[str, int] = collections.defaultdict(int)
_OFF = contextlib.nullcontext()


class Span(NamedTuple):
    id: int          # the stage's index among those opened in the process
    name: str
    start_ns: int    # time.time_ns(), the clock of torch.profiler's events
    end_ns: int
    thread: int      # threading.get_ident()
    parent: int      # id of the enclosing stage open on this thread, -1 if none
    root: int        # id of the outermost stage open on this thread (its own if none)
    fields: dict     # the caller's keyword arguments to `stage`


def enable(on: bool = True):
    global _enabled
    _enabled = on


def enabled() -> bool:
    return _enabled


def reset():
    """Clear the series, the spans and the counts."""
    _series.clear()
    _spans.clear()
    _counts.clear()


class _Stage:
    __slots__ = ("name", "fields", "id", "parent", "root", "t0", "p0")

    def __init__(self, name: str, fields: dict):
        self.name, self.fields = name, fields

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.id = next(_ids)
        self.parent = stack[-1] if stack else -1
        self.root = stack[0] if stack else self.id
        stack.append(self.id)
        self.t0 = time.time_ns()
        self.p0 = time.perf_counter()

    def __exit__(self, *exc):
        p1 = time.perf_counter()
        t1 = time.time_ns()
        _open.stack.pop()
        _series[self.name].append((p1 - self.p0) * 1e3)
        _spans.append(Span(self.id, self.name, self.t0, t1, threading.get_ident(),
                           self.parent, self.root, self.fields))
        return False


def stage(name: str, **fields):
    """Time a stage (a context manager); records nothing unless enabled."""
    if not _enabled:
        return _OFF
    return _Stage(name, fields)


def spans() -> list[Span]:
    """The kept spans, in the order they closed."""
    return list(_spans)


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


# -- event counts ------------------------------------------------------------
# `count()` tallies named events at hot-path call sites (an int increment,
# always on).

def count(name: str, k: int = 1):
    _counts[name] += k


def counts() -> dict[str, int]:
    return dict(_counts)


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
