"""One torch.profiler trace of the measured window, reduced to what the
per-layer readers take: the device's busy intervals, kernel time by name,
the host's synchronize calls, and the host at each idle gap.

An idle gap of the device is named by what the host was doing at its
start: the innermost of the benchmark's own spans open then (its host
clock moved onto the profiler's), and the most recently started host
event still running then: on the card a CUDA runtime call, such as a
launch, a copy or a synchronize ('python' where none is).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
BACK = 64   # host events looked back over from a gap's start for one still running


@dataclasses.dataclass
class Trace:
    t0_ns: int                    # the window on the profiler's clock
    t1_ns: int
    dev_name: list                # device ops: kernels, copies, sets
    dev_start: np.ndarray         # (D,) ns
    dev_end: np.ndarray
    cpu_name: list                # host events: CUDA runtime calls, or CPU ops
    cpu_start: np.ndarray
    cpu_end: np.ndarray
    syncs: int
    spans: list = dataclasses.field(default_factory=list)   # (name, start ns, end ns)

    @staticmethod
    def from_events(events, t0_ns: int, t1_ns: int, spans=()) -> "Trace":
        """From kineto events (name(), device_type(), start_ns(),
        duration_ns()) or any objects with those methods, and the
        benchmark's spans on the same clock."""
        dn, ds, de, cn, cs, ce, syncs = [], [], [], [], [], [], 0
        for e in events:
            name = e.name()
            s = int(e.start_ns())
            d = int(e.duration_ns())
            if "CUDA" in str(e.device_type()):
                dn.append(name)
                ds.append(s)
                de.append(s + d)
            else:
                syncs += name in SYNC_CALLS
                cn.append(name)
                cs.append(s)
                ce.append(s + d)
        order = np.argsort(np.asarray(cs, np.int64), kind="stable")
        return Trace(t0_ns, t1_ns, dn, np.asarray(ds, np.int64), np.asarray(de, np.int64),
                     [cn[i] for i in order], np.asarray(cs, np.int64)[order],
                     np.asarray(ce, np.int64)[order], syncs, list(spans))

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-9

    def busy(self) -> np.ndarray:
        """The union of the device ops' intervals inside the window, (B, 2)
        ns, sorted and disjoint."""
        if not len(self.dev_start):
            return np.zeros((0, 2), np.int64)
        s = np.clip(self.dev_start, self.t0_ns, self.t1_ns)
        e = np.clip(self.dev_end, self.t0_ns, self.t1_ns)
        order = np.argsort(s, kind="stable")
        out = []
        for a, b in zip(s[order], e[order]):
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return np.asarray(out, np.int64).reshape(-1, 2)

    def busy_s(self) -> float:
        b = self.busy()
        return float((b[:, 1] - b[:, 0]).sum()) * 1e-9

    def device_time_by_name(self) -> dict:
        out: dict = {}
        for n, s, e in zip(self.dev_name, self.dev_start, self.dev_end):
            out[n] = out.get(n, 0.0) + (e - s) * 1e-9
        return out

    def kernel_s(self, fragment: str) -> tuple[float, int]:
        """Device seconds and count of the ops whose name holds `fragment`."""
        sel = [(e - s) for n, s, e in zip(self.dev_name, self.dev_start, self.dev_end)
               if fragment in n]
        return float(sum(sel)) * 1e-9, len(sel)

    def gaps(self) -> np.ndarray:
        """The idle intervals of the device inside the window, (G, 2) ns."""
        b = self.busy()
        edges = np.concatenate([[self.t0_ns], b.reshape(-1), [self.t1_ns]]).reshape(-1, 2)
        return edges[edges[:, 1] > edges[:, 0]]

    def host_at(self, t_ns) -> list[str]:
        """What the host was doing at each time of `t_ns`: the innermost
        benchmark span open then ('window' if none) and the most recently
        started host event still running then ('python' if none), as
        'span/op'."""
        t = np.asarray(t_ns, np.int64).reshape(-1)
        span = np.full(len(t), "window", dtype=object)
        span_len = np.full(len(t), np.iinfo(np.int64).max)
        for name, a, b in self.spans:
            inside = (a <= t) & (t < b) & (b - a < span_len)
            span[inside], span_len[inside] = name, b - a
        op = np.full(len(t), "python", dtype=object)
        found = np.zeros(len(t), bool)
        idx = np.searchsorted(self.cpu_start, t, side="right") - 1
        for k in range(BACK):
            j = idx - k
            ok = ~found & (j >= 0)
            jj = np.where(ok, j, 0)
            hit = ok & (self.cpu_end[jj] > t) if len(self.cpu_end) else ok & False
            for i in np.nonzero(hit)[0]:
                op[i] = self.cpu_name[jj[i]]
            found |= hit
        return [f"{a}/{b}" for a, b in zip(span, op)]

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time (names cut to 100 characters),
        and the idle time summed by what the host was doing at each gap's
        start."""
        ops: dict = {}
        for n, sec in self.device_time_by_name().items():
            key = (n[5:] if n.startswith("void ") else n)[:100]
            ops[key] = ops.get(key, 0.0) + sec
        g = self.gaps()
        by_host: dict = {}
        for name, (a, b) in zip(self.host_at(g[:, 0]), g):
            by_host[name] = by_host.get(name, 0.0) + (b - a) * 1e-9
        ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return dict(device_ops=[[n, float(s)] for n, s in ops],
                    idle_gaps=[[n, float(s)] for n, s in gaps])


class Profiler:
    """The profiler: CUDA activity on the card (kernels, copies, sets and
    the CUDA runtime calls, from every thread), CPU ops where there is no
    card. It drives the profiler's own enable and disable calls, so the
    events come back raw, without torch.profiler's tree of events. `start`
    and `stop` run on the thread that drives the window; `spans` (a
    `harness.spans.Spans`) are moved onto the profiler's clock."""

    def __init__(self, cuda: bool, spans=None):
        from torch._C._profiler import ProfilerActivity
        self._acts = {ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU}
        self._cuda = cuda
        self._spans = spans
        self.trace: Trace | None = None
        self.started = self.stopped = None   # the traced window, on perf_counter

    def start(self):
        from torch._C._autograd import _enable_profiler, _prepare_profiler
        from torch._C._profiler import ProfilerConfig, ProfilerState, _ExperimentalConfig
        cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                             _ExperimentalConfig())
        _prepare_profiler(cfg, self._acts)
        _enable_profiler(cfg, self._acts)
        # kineto stamps events on the wall clock's nanoseconds
        self._t0 = time.time_ns()
        self._offset = self._t0 - time.perf_counter_ns()
        self.started = time.perf_counter()

    def stop(self):
        import torch
        from torch._C._autograd import _disable_profiler
        if self._cuda:
            torch.cuda.synchronize()
        t1 = time.time_ns()
        self.stopped = time.perf_counter()
        events = _disable_profiler().events()
        spans = [] if self._spans is None else [
            (r["name"], int(r["t0"] * 1e9) + self._offset, int(r["t1"] * 1e9) + self._offset)
            for r in self._spans.records]
        self.trace = Trace.from_events(events, self._t0, t1, spans)
