"""The reader of `tracking.pose_replay_pct` on synthetic counters, and on
a port without the counters or without the span recorder."""

import types

import pytest

import run as pb
from orbslam3_tpu_torch.utils import timing

NAME = "tracking.pose_replay_pct"


def _readings():
    return pb.Readings(win=dict(t0=0.0, poses=2, keyframes=1), window_s=0.2, spans=None,
                       stages={}, launches={}, trace=None, cuda=True, traced_poses=1,
                       k1_sizes=[], k2_sizes=[], cell=types.SimpleNamespace())


def _read(rd):
    return pb.load_module(pb.HERE / "metrics" / f"{NAME}.py",
                          "t_" + NAME.replace(".", "_")).read(rd)


@pytest.mark.parametrize("counts,share,captures", [
    ({"track.pose_replay": 240, "track.pose_capture": 0, "track.ladder_attempt": 240}, 100.0, 0),
    ({"track.pose_replay": 6, "track.pose_eager": 2, "track.pose_capture": 1}, 75.0, 1),
    ({"track.pose_eager": 8, "track.ladder_attempt": 8, "track.vi_pose_replay": 4}, 0.0, 0),
])
def test_the_pose_replay_reader_on_synthetic_counters(monkeypatch, counts, share, captures):
    """Replayed attempts over replayed and eager ones, in %, with the
    captures beside it; the VI solve's counters do not count."""
    monkeypatch.setattr(timing, "counts", lambda: dict(counts))
    got, extra = _read(_readings())
    assert got == pytest.approx(share) and extra == {"captures": captures}


def test_the_pose_replay_reader_without_the_counters(monkeypatch):
    """None from a port that counts no attempt's kind (the parent of the
    counters counts only `track.ladder_attempt`), and from one without the
    span recorder."""
    monkeypatch.setattr(timing, "counts", lambda: {"track.ladder_attempt": 8,
                                                   "track.vi_pose_replay": 4})
    assert _read(_readings()) is None
    monkeypatch.delattr(timing, "spans")
    monkeypatch.setattr(timing, "counts", lambda: {"dispatch.extract": 9})
    assert _read(_readings()) is None
