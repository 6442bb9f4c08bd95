"""The port's own spans and counters (`orbslam3_tpu_torch.utils.timing`),
and the interval arithmetic the readers of them share.

`timing.stage` keeps a `Span` for each stage of a traced window (name,
start and end in unix-time ns, the clock of the profiler's events,
thread, the enclosing stage's id as `parent`, the outermost one's as
`root`, and the caller's fields); `timing.count` tallies named events.
`port.modules()` hands the run the same module, so what a reader finds
here is what the window recorded: `run.py` resets timing when the window
opens and reads the readers before anything else runs. A port without the
recorder (no `timing.spans`) gives None, and its readers report nothing.

Intervals are (N, 2) int64 arrays of [start, end) in ns.
"""

from __future__ import annotations

import numpy as np

from harness import port


def spans() -> list | None:
    """The window's spans, or None where the port keeps none."""
    timing = port.modules().timing
    got = timing.spans() if hasattr(timing, "spans") else []
    return got or None


def counts() -> dict:
    return port.modules().timing.counts()


def intervals(spans_) -> np.ndarray:
    return np.asarray([(s.start_ns, s.end_ns) for s in spans_], np.int64).reshape(-1, 2)


def union(iv) -> np.ndarray:
    """The union of intervals, sorted and disjoint."""
    iv = np.asarray(iv, np.int64).reshape(-1, 2)
    iv = iv[iv[:, 1] > iv[:, 0]]
    if not len(iv):
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = [list(iv[0])]
    for a, b in iv[1:]:
        if a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return np.asarray(out, np.int64)


def length(iv) -> int:
    iv = np.asarray(iv, np.int64).reshape(-1, 2)
    return int((iv[:, 1] - iv[:, 0]).sum())


def clip(iv, t0: int, t1: int) -> np.ndarray:
    """Intervals cut to [t0, t1]; those left empty go."""
    iv = np.clip(np.asarray(iv, np.int64).reshape(-1, 2), t0, t1)
    return iv[iv[:, 1] > iv[:, 0]]


def overlap(a, b) -> int:
    """The length of the intersection of two sorted disjoint sets of
    intervals (`union`'s output)."""
    a, b = np.asarray(a, np.int64).reshape(-1, 2), np.asarray(b, np.int64).reshape(-1, 2)
    tot, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i, 0], b[j, 0]), min(a[i, 1], b[j, 1])
        tot += max(0, hi - lo)
        if a[i, 1] < b[j, 1]:
            i += 1
        else:
            j += 1
    return int(tot)


def self_ns(spans_, name: str) -> list[int]:
    """Each span named `name`: its duration less the part of it that its
    child stages (spans whose `parent` is it) cover."""
    kids: dict = {}
    for s in spans_:
        kids.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
    out = []
    for s in spans_:
        if s.name == name:
            covered = length(clip(union(kids.get(s.id, [])), s.start_ns, s.end_ns))
            out.append(s.end_ns - s.start_ns - covered)
    return out


def under(spans_, names) -> set:
    """Ids of the spans named in `names` and of every span inside one of
    them (a descendant through `parent`)."""
    parent = {s.id: s.parent for s in spans_}
    name = {s.id: s.name for s in spans_}
    found: dict = {}

    def inside(i):
        path = []
        while i in parent and i not in found:
            if name[i] in names:
                found[i] = True
                break
            path.append(i)
            i = parent[i]
        hit = found.get(i, False)
        for k in path:
            found[k] = hit
        return hit

    return {s.id for s in spans_ if inside(s.id)}


def idle_pct(trace, spans_) -> float | None:
    """The share of the union of `spans_`, cut to the traced window, that
    falls in the device's idle gaps, in %; None where nothing is left."""
    u = union(clip(intervals(spans_), trace.t0_ns, trace.t1_ns))
    total = length(u)
    if total <= 0:
        return None
    return 100.0 * overlap(u, trace.gaps()) / total


def innermost_at(spans_, t_ns) -> list[str]:
    """The name of the shortest span open at each time of `t_ns` (the
    innermost stage, on whichever thread), '(no stage)' where none is."""
    t = np.asarray(t_ns, np.int64).reshape(-1)
    name = np.full(len(t), "(no stage)", dtype=object)
    best = np.full(len(t), np.iinfo(np.int64).max)
    for s in spans_:
        d = s.end_ns - s.start_ns
        hit = (s.start_ns <= t) & (t < s.end_ns) & (d < best)
        name[hit], best[hit] = s.name, d
    return list(name)
