"""The reader of `tracking.vi_pose_replay_pct` on synthetic counters, and
on a port without the counters or without the span recorder."""

import types

import pytest

import run as pb
from orbslam3_tpu_torch.utils import timing

NAME = "tracking.vi_pose_replay_pct"


def _readings():
    return pb.Readings(win=dict(t0=0.0, poses=2, keyframes=1), window_s=0.2, spans=None,
                       stages={}, launches={}, trace=None, cuda=True, traced_poses=1,
                       k1_sizes=[], k2_sizes=[], cell=types.SimpleNamespace())


def _read(rd):
    return pb.load_module(pb.HERE / "metrics" / f"{NAME}.py",
                          "t_" + NAME.replace(".", "_")).read(rd)


@pytest.mark.parametrize("counts,share,captures", [
    ({"track.vi_pose_replay": 57, "track.vi_pose_capture": 0}, 100.0, 0),
    ({"track.vi_pose_replay": 3, "track.vi_pose_eager": 1, "track.vi_pose_capture": 2}, 75.0, 2),
    ({"track.vi_pose_eager": 4, "track.ladder_attempt": 8}, 0.0, 0),
])
def test_the_vi_pose_replay_reader_on_synthetic_counters(monkeypatch, counts, share, captures):
    """Replays over replays and eager solves, in %, with the captures
    beside it."""
    monkeypatch.setattr(timing, "counts", lambda: dict(counts))
    got, extra = _read(_readings())
    assert got == pytest.approx(share) and extra == {"captures": captures}


def test_the_vi_pose_replay_reader_without_the_counters(monkeypatch):
    """None from a port that counts no VI pose solve (the parent of the
    counters), and from one without the span recorder."""
    monkeypatch.setattr(timing, "counts", lambda: {"track.ladder_attempt": 8})
    assert _read(_readings()) is None
    monkeypatch.delattr(timing, "spans")
    monkeypatch.setattr(timing, "counts", lambda: {"dispatch.extract": 9})
    assert _read(_readings()) is None
