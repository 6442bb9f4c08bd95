"""Every per-layer reader, and the trace reduction under them, on a small
synthetic trace."""

import types

import numpy as np
import pytest

import run as pb
from harness import trace as trace_mod, yardstick


class Ev:
    def __init__(self, name, dev, start, dur):
        self._n, self._d, self._s, self._u = name, dev, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u


def _trace():
    ms = 1_000_000
    events = [
        Ev("aten::item", False, 10 * ms, 5 * ms),
        Ev("cudaStreamSynchronize", False, 11 * ms, 3 * ms),
        Ev("cudaDeviceSynchronize", False, 60 * ms, 1 * ms),
        Ev("masked_top2_kernel", True, 5 * ms, 2 * ms),
        Ev("masked_top2_kernel", True, 6 * ms, 2 * ms),     # overlaps the first
        Ev("gather_patches_kernel", True, 20 * ms, 1 * ms),
        Ev("Memcpy DtoH", True, 90 * ms, 5 * ms),
        Ev("Memcpy DtoH", True, 95 * ms, 20 * ms),          # runs past the window
    ]
    return trace_mod.Trace.from_events(events, 0, 100 * ms, [("track_monocular", 0, 100 * ms)])


def test_trace_reduction():
    tr = _trace()
    assert tr.syncs == 2
    np.testing.assert_array_equal(tr.busy() // 1_000_000, [[5, 8], [20, 21], [90, 100]])
    assert tr.busy_s() == pytest.approx(0.014)
    assert tr.window_s == pytest.approx(0.1)
    assert tr.kernel_s("masked_top2_kernel") == (pytest.approx(0.004), 2)
    assert tr.host_at([12_000_000, 30_000_000, 200_000_000]) == [
        "track_monocular/cudaStreamSynchronize", "track_monocular/python", "window/python"]
    bd = tr.breakdown()
    assert bd["device_ops"][0][0] == "Memcpy DtoH"
    names = dict(bd["idle_gaps"])
    assert sum(names.values()) == pytest.approx(0.1 - 0.014)
    # gaps start at 0, 8 and 21 ms, inside the span with no op running
    assert list(names) == ["track_monocular/python"]


def _readings(tr, cuda=True):
    spans = types.SimpleNamespace(records=[
        dict(name="track_monocular", t0=1.0, t1=1.2), dict(name="track_monocular", t0=1.2, t1=1.5),
        dict(name="track_monocular", t0=0.5, t1=0.9)])    # before the window: left out
    stages = {"track.extract": dict(total_ms=40.0), "track.vi_pose": dict(total_ms=500.0),
              "track.new_kf": dict(mean_ms=300.0, total_ms=600.0),
              "lc.detect": dict(total_ms=20.0), "lc.bow": dict(total_ms=10.0)}
    return pb.Readings(win=dict(t0=1.0, poses=2, keyframes=2), window_s=0.5, spans=spans,
                       stages=stages, launches={}, trace=tr, cuda=cuda, traced_poses=2,
                       k1_sizes=[(100, 200, 50), (100, 200, 10)],
                       k2_sizes=[(480, 752, np.array([0, 10]), np.array([0, 700]))],
                       cell=types.SimpleNamespace())


def _read(name, rd):
    return pb.load_module(pb.HERE / "metrics" / f"{name}.py", "t_" + name.replace(".", "_")).read(rd)


def test_every_reader_on_a_synthetic_trace():
    tr = _trace()
    rd = _readings(tr)
    want = {
        "system.frame_ms.p90": (np.percentile([200.0, 300.0], 90), {"n": 2}),
        "tracking.extract_ms": 20.0,
        "tracking.vi_pose_ms": 250.0,
        "mapping.keyframe_ms": 300.0,
        "mapping.keyframes_per_frame": 1.0,
        "loop.keyframe_ms": 15.0,
        "device.idle_pct": 86.0,
        "device.syncs_per_frame": 1.0,
    }
    for name, value in want.items():
        got = _read(name, rd)
        if isinstance(value, tuple):
            assert got[0] == pytest.approx(value[0]) and got[1] == value[1]
        else:
            assert got == pytest.approx(value), name
    least = yardstick.k1_least_s(100, 200, 50) + yardstick.k1_least_s(100, 200, 10)
    assert _read("masked_top2_roofline", rd)[0] == pytest.approx(100 * least / 0.004)
    assert _read("gather_patches_roofline", rd)[0] == pytest.approx(
        100 * yardstick.k2_least_s(480, 752, np.array([0, 10]), np.array([0, 700])) / 0.001)
    # the edge readers find no phones in this cell
    assert _read("edge.reply_ms.p90", rd) is None and _read("edge.wait_ms", rd) is None


def test_readers_return_nothing_where_nothing_was_read():
    tr = trace_mod.Trace.from_events([], 0, 10)
    rd = _readings(tr, cuda=False)
    rd.stages, rd.k1_sizes, rd.k2_sizes, rd.traced_poses = {}, [], [], 0
    rd.spans.records = []
    for name in ("system.frame_ms.p90", "tracking.extract_ms", "tracking.vi_pose_ms",
                 "mapping.keyframe_ms", "loop.keyframe_ms", "masked_top2_roofline",
                 "gather_patches_roofline", "device.idle_pct", "device.syncs_per_frame"):
        assert _read(name, rd) is None, name


def test_edge_readers():
    phones = [types.SimpleNamespace(ids=np.arange(10)), types.SimpleNamespace(ids=5 * np.arange(10))]
    # phone 0 frame 1 sent at 1.0, answered at 1.5; the server tracked it 1.3-1.45
    replies = [(0, 1, 1.0, 1.5, None), (1, 2, 1.1, 1.4, None)]
    spans = types.SimpleNamespace(records=[
        dict(name="track_edge", client=0, frame=1, t0=1.01, t1=1.46),
        dict(name="edge_tracking", client=0, t0=1.3, t1=1.45),
        dict(name="track_edge", client=1, frame=10, t0=1.11, t1=1.39),
        dict(name="edge_tracking", client=1, t0=1.2, t1=1.38)])
    rd = pb.Readings(win=dict(t0=1.0, poses=2, keyframes=0), spans=spans,
                     cell=types.SimpleNamespace(replies=replies, phones=phones))
    got, extra = _read("edge.reply_ms.p90", rd)
    assert got == pytest.approx(np.percentile([500.0, 300.0], 90)) and extra == {"n": 2}
    got, extra = _read("edge.wait_ms", rd)
    assert got == pytest.approx(np.mean([500 - 150, 300 - 180])) and extra == {"n": 2}
    got, extra = _read("system.frame_ms.p90", rd)
    assert got == pytest.approx(np.percentile([150.0, 180.0], 90))
