"""The readers of the port's own spans and counters, and the interval
arithmetic under them (`harness/program_spans.py`), on synthetic spans
from two threads and a synthetic trace; and the same readers on a port
without the span recorder."""

import types

import numpy as np
import pytest

import run as pb
import stage_idle
from harness import program_spans, trace as trace_mod
from orbslam3_tpu_torch.utils import timing

MS = 1_000_000
A, B = 11, 22   # the tracking thread, the mapper's thread (async mapping)


def _span(id, name, a, b, thread=A, parent=-1, root=None, **fields):
    return timing.Span(id, name, a * MS, b * MS, thread, parent, id if root is None else root,
                       fields)


# two frames on the tracking thread, a keyframe's inline mapping inside the
# first, a mapper stage on its own thread; in the order they closed
SPANS = [
    _span(1, "track.extract", 5, 20, parent=0, root=0),
    _span(2, "track.local_map", 20, 30, parent=0, root=0),
    _span(4, "track.bow", 40, 50, parent=3, root=0),
    _span(3, "track.fused_pose", 30, 60, parent=0, root=0),
    _span(5, "track.vi_pose", 55, 80, parent=0, root=0),       # overlaps its sibling
    _span(7, "lm.local_ba", 82, 90, parent=6, root=0),
    _span(6, "track.new_kf", 80, 95, parent=0, root=0),
    _span(0, "slam.frame", 0, 100, client=0, frame=0),
    _span(10, "track.extract", 110, 120, parent=9, root=9),
    _span(8, "lm.cull_kfs", 100, 130, thread=B),
    _span(11, "track.fused_pose", 150, 190, parent=9, root=9),  # past the traced window
    _span(9, "slam.frame", 100, 200, client=0, frame=1),
]


class Ev:
    def __init__(self, start, end):
        self._s, self._d = start * MS, (end - start) * MS

    def name(self):
        return "kernel"

    def device_type(self):
        return "DeviceType.CUDA"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def _trace():
    """Traced from 10 to 180 ms; the card busy at 25-35, 45-48, 85-88,
    120-125 and 160-170 ms."""
    busy = [(25, 35), (45, 48), (85, 88), (120, 125), (160, 170)]
    return trace_mod.Trace.from_events([Ev(a, b) for a, b in busy], 10 * MS, 180 * MS)


def test_interval_arithmetic():
    u = program_spans.union([(5, 20), (20, 30), (40, 50), (30, 35), (60, 60), (1, 3)])
    np.testing.assert_array_equal(u, [[1, 3], [5, 35], [40, 50]])
    assert program_spans.length(u) == 2 + 30 + 10
    np.testing.assert_array_equal(program_spans.clip(u, 2, 45), [[2, 3], [5, 35], [40, 45]])
    assert program_spans.clip(u, 36, 39).shape == (0, 2)
    assert program_spans.overlap(u, [[0, 6], [30, 42], [49, 100]]) == 2 + 1 + 5 + 2 + 1
    assert program_spans.overlap(u, np.zeros((0, 2))) == 0
    assert program_spans.union([]).shape == (0, 2)


def test_self_time_with_overlapping_children():
    # frame 0: children cover 5-95 (extract, local map, the overlapping
    # fused pose and VI pose, the keyframe; the BoW and the local BA are
    # grandchildren); frame 1: 110-120 and 150-190
    assert program_spans.self_ns(SPANS, "slam.frame") == [10 * MS, 50 * MS]
    assert program_spans.self_ns(SPANS, "track.fused_pose") == [20 * MS, 40 * MS]
    assert program_spans.self_ns(SPANS, "lm.cull_kfs") == [30 * MS]
    # a child that started before its parent (clock steps) counts inside it only
    odd = [_span(1, "c", 0, 30, parent=0, root=0), _span(0, "p", 10, 20)]
    assert program_spans.self_ns(odd, "p") == [0]


def test_spans_under_a_stage_and_the_innermost_one():
    assert program_spans.under(SPANS, {"track.new_kf"}) == {6, 7}
    assert program_spans.under(SPANS, {"slam.frame"}) == {0, 1, 2, 3, 4, 5, 6, 7, 9, 10, 11}
    # a span whose parent was cleared by a reset is under nothing
    orphan = [_span(5, "lm.fuse", 0, 1, parent=99)]
    assert program_spans.under(orphan, {"track.new_kf"}) == set()
    at = program_spans.innermost_at(SPANS, np.array([12, 45, 97, 105, 250]) * MS)
    assert at == ["track.extract", "track.bow", "slam.frame", "lm.cull_kfs", "(no stage)"]


def test_idle_shares_clip_to_the_traced_window():
    tr = _trace()
    tracking = [s for s in SPANS if s.name.startswith("track.") and s.id not in (6, 7)]
    # union 5-80, 110-120, 150-190, cut to 10-80, 110-120, 150-180 (110 ms),
    # of which 23 ms busy
    assert program_spans.idle_pct(tr, tracking) == pytest.approx(100 * 87 / 110)
    # 80-95 and 100-130 on two threads (45 ms), 8 ms busy
    mapping = [s for s in SPANS if s.id in (6, 7, 8)]
    assert program_spans.idle_pct(tr, mapping) == pytest.approx(100 * 37 / 45)
    outside = [_span(0, "track.extract", 190, 200)]
    assert program_spans.idle_pct(tr, outside) is None


def _readings(cuda=True):
    return pb.Readings(win=dict(t0=0.0, poses=2, keyframes=1), window_s=0.2, spans=None,
                       stages={"track.fused_pose": dict(total_ms=70.0),
                               "track.local_map": dict(total_ms=10.0),
                               "track.vi_pose": dict(total_ms=25.0)},
                       launches={}, trace=_trace(), cuda=cuda, traced_poses=1, k1_sizes=[],
                       k2_sizes=[], cell=types.SimpleNamespace())


def _read(name, rd):
    return pb.load_module(pb.HERE / "metrics" / f"{name}.py",
                          "t_" + name.replace(".", "_")).read(rd)


NEW = ("tracking.fused_pose_ms", "tracking.local_map_ms", "tracking.ladder_attempts_per_frame",
       "system.unstaged_ms", "tracking.idle_pct", "mapping.idle_pct")


def test_the_six_readers_on_synthetic_spans(monkeypatch):
    monkeypatch.setattr(timing, "spans", lambda: list(SPANS))
    monkeypatch.setattr(timing, "counts", lambda: {"track.ladder_attempt": 7, "other": 3})
    rd = _readings()
    want = {
        "tracking.fused_pose_ms": 35.0,
        "tracking.local_map_ms": 5.0,
        "tracking.ladder_attempts_per_frame": 3.5,
        "system.unstaged_ms": (30.0, {"n": 2}),
        "tracking.idle_pct": 100 * 87 / 110,
        "mapping.idle_pct": 100 * 37 / 45,
    }
    for name, value in want.items():
        got = _read(name, rd)
        if isinstance(value, tuple):
            assert got[0] == pytest.approx(value[0]) and got[1] == value[1], name
        else:
            assert got == pytest.approx(value), name
    # no card: the idle shares read nothing; the rest read as before
    rd = _readings(cuda=False)
    assert _read("tracking.idle_pct", rd) is None and _read("mapping.idle_pct", rd) is None
    assert _read("tracking.fused_pose_ms", rd) == pytest.approx(35.0)


def test_the_readers_read_nothing_from_a_port_without_the_recorder(monkeypatch):
    """A port whose `timing` keeps no spans, no `track.ladder_attempt`
    counter and none of the new stages (the benchmark laid over an older
    checkout): every new reader returns None and none raises."""
    monkeypatch.delattr(timing, "spans")
    monkeypatch.setattr(timing, "counts", lambda: {"dispatch.extract": 9})
    rd = _readings()
    rd.stages = {"track.vi_pose": dict(total_ms=25.0)}
    for name in NEW:
        assert _read(name, rd) is None, name


def test_the_readers_on_the_recorder_itself():
    """Stages recorded by the port's `timing` reach the readers: the frame's
    self time is what its children leave."""
    timing.reset()
    timing.enable(True)
    try:
        for frame in range(3):
            with timing.stage("slam.frame", client=0, frame=frame):
                with timing.stage("track.fused_pose"):
                    timing.count("track.ladder_attempt", 2)
                    with timing.stage("track.bow"):
                        pass
    finally:
        timing.enable(False)
    try:
        rd = _readings(cuda=False)
        got, extra = _read("system.unstaged_ms", rd)
        frames = [s for s in timing.spans() if s.name == "slam.frame"]
        kids = [s for s in timing.spans() if s.name == "track.fused_pose"]
        want = np.mean([(f.end_ns - f.start_ns) - (k.end_ns - k.start_ns)
                        for f, k in zip(frames, kids)]) * 1e-6
        assert extra == {"n": 3} and got == pytest.approx(want)
        assert _read("tracking.ladder_attempts_per_frame", rd) == pytest.approx(3.0)
    finally:
        timing.reset()


def test_idle_by_stage_names_the_innermost_stage_at_each_gap():
    # gaps start at 10 (extract), 35 (fused pose), 48 (BoW), 88 (local BA),
    # 125 (the mapper's cull, inside no frame of its thread) and 170 (fused pose)
    got = stage_idle.idle_by_stage(_trace(), SPANS)
    assert got["window_s"] == pytest.approx(0.17)
    assert got["idle_s"] == pytest.approx(0.139)
    assert got["idle_by_stage"] == [
        ["track.bow", pytest.approx(0.037)], ["lm.cull_kfs", pytest.approx(0.035)],
        ["lm.local_ba", pytest.approx(0.032)], ["track.fused_pose", pytest.approx(0.020)],
        ["track.extract", pytest.approx(0.015)]]
