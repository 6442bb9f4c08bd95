"""The edge cell with inertial phones (`edge.two_phones_vi`, traffic kind
`phones_vi`), on the CPU: the readers of the port's edge stages on
synthetic spans and on a port without them, the probe of the port's lane,
the judgement at half the cell's size (a sound window is correct, and
windows under `drop_client` and `skipped_imu_dropped` are not) and the
phones' strict turns behind a lane slow to reach the server's lock.

`skipped_imu_dropped` (defined here) is the fork's own lane: the IMU of
the packets the 1-in-k rule skips is dropped, so each tracked packet of
phone 1 reaches the tracker with the samples of its own frame interval
only. Run as a script, this file measures the cell's controls on the card
with that plant beside `control.py`'s, and prints with each window the
reading of `c1_preint_err`'s reference computed at float16:

    python3 portbench/tests/test_portbench_edge_vi.py --workload edge.two_phones_vi \\
        --seeds 11,12,13 --seconds 51 --plants none,half,drop_client,skipped_imu_dropped
"""

import argparse
import dataclasses
import json
import sys
import time
import types
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
for p in (HERE, HERE.parent, HERE.parent.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import control  # noqa: E402
import run as pb  # noqa: E402
from orbslam3_tpu_torch.edge.server import ClientLane  # noqa: E402
from orbslam3_tpu_torch.utils import timing  # noqa: E402

CELL = "edge.two_phones_vi"
MS = 1_000_000


def plant_skipped_imu_dropped(cell, mods):
    """Phone 1's tracked packets keep only the IMU samples after the
    previous frame's timestamp (the fork's `client.cc:166`)."""
    server = cell.server
    inner = server.track_fn
    frame_ns = round(1e9 / cell.p["fps"])
    half_sample_ns = round(0.5e9 / cell.cfg["imu"]["rate_hz"])

    def track_fn(client_id, pkt):
        if client_id == 1:
            own = pkt.imu_ts_ns > pkt.timestamp_ns - frame_ns + half_sample_ns
            pkt = dataclasses.replace(pkt, imu_ts_ns=pkt.imu_ts_ns[own],
                                      imu_gyro=pkt.imu_gyro[own], imu_acc=pkt.imu_acc[own])
        return inner(client_id, pkt)

    server.track_fn = track_fn

    def undo():
        server.track_fn = inner
    return undo


PLANTS = dict(control.PLANTS, skipped_imu_dropped=plant_skipped_imu_dropped)


# ------------------------------------------------------------------ readers
def _span(id, name, a, b, parent=-1, thread=1, **fields):
    return timing.Span(id, name, a * MS, b * MS, thread, parent, id, fields)


# two tracked packets of client 0, one of client 1; four packets decoded
SPANS = [
    _span(0, "edge.decode", 0, 1, thread=7, client=0),
    _span(1, "edge.decode", 2, 3, thread=8, client=1),
    _span(2, "edge.decode", 4, 6, thread=8, client=1),
    _span(4, "edge.features", 10, 12, parent=3, client=0),
    _span(3, "edge.lock_wait", 10, 30, client=0),          # 18 ms waiting
    _span(5, "slam.frame", 30, 400, client=0, frame=0),
    _span(7, "edge.features", 31, 34, parent=6, thread=2, client=1),
    _span(6, "edge.lock_wait", 31, 400, thread=2, client=1),   # 366 ms
    _span(8, "edge.decode", 401, 402, thread=7, client=0),
    _span(10, "edge.features", 402, 403, parent=9, client=0),
    _span(9, "edge.lock_wait", 402, 740, client=0),       # 337 ms
]


def _readings():
    return pb.Readings(win=dict(t0=0.0, poses=3, keyframes=0), window_s=1.0, spans=None,
                       stages={}, launches={}, trace=None, cuda=True, traced_poses=3,
                       k1_sizes=[], k2_sizes=[], cell=types.SimpleNamespace())


def _read(name, rd):
    return pb.load_module(pb.HERE / "metrics" / f"{name}.py",
                          "t_" + name.replace(".", "_")).read(rd)


def test_the_edge_readers_on_synthetic_spans(monkeypatch):
    monkeypatch.setattr(timing, "spans", lambda: list(SPANS))
    wait, extra = _read("edge.lock_wait_ms", _readings())
    assert wait == pytest.approx((18 + 366 + 337) / 3) and extra == {"n": 3}
    host, extra = _read("edge.lane_host_ms", _readings())
    assert host == pytest.approx((1 + 1 + 2 + 1 + 2 + 3 + 1) / 3)
    assert extra == {"n": 3, "decoded": 4}


@pytest.mark.parametrize("name", ["edge.lock_wait_ms", "edge.lane_host_ms"])
def test_the_edge_readers_without_the_stages(monkeypatch, name):
    """None from a port whose edge path has no stages (the parent of the
    stages), and from one without the span recorder."""
    monkeypatch.setattr(timing, "spans", lambda: [s for s in SPANS if s.name == "slam.frame"])
    assert _read(name, _readings()) is None
    monkeypatch.setattr(timing, "spans", lambda: [])
    assert _read(name, _readings()) is None
    monkeypatch.delattr(timing, "spans")
    assert _read(name, _readings()) is None


# -------------------------------------------------------------------- probe
def _phones_vi():
    return pb.load_module(pb.HERE / "traffic" / "phones_vi.py", "t_phones_vi")


def test_the_probe_tells_a_lane_that_drops_the_skipped_imu(monkeypatch):
    """4 samples reach the tracked packet through the port's lane; 2
    through a lane that drops the skipped packet's, and set-up then stops
    with a non-zero exit before the warm-up."""
    kind = _phones_vi()
    assert kind.probe_lane(5) == 4
    monkeypatch.setattr(ClientLane, "_with_carried_imu", lambda self, pkt: pkt)
    assert kind.probe_lane(5) == 2
    mix = json.loads((pb.HERE / "workloads" / f"{CELL}.json").read_text())
    cell = kind.Cell({}, mix, 1, 1.0, torch.device("cpu"), None, print)
    with pytest.raises(SystemExit, match="drops the IMU of skipped packets"):
        cell.setup()


# ------------------------------------------------------------ the judgement
@pytest.fixture(scope="module")
def session():
    from test_portbench_faults import half_size
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    args = argparse.Namespace(workload=CELL, seed=2**31 + 19, seconds=10.0, trace=0)
    ss = pb.prepare(args, device="cpu", overrides={"budget_init": 600}, shrink=half_size)
    yield ss
    ss.cell.release()
    torch.set_num_threads(threads)


@pytest.mark.parametrize("plant", ["none", "drop_client", "skipped_imu_dropped"])
def test_correct_holds_a_sound_window_and_fails_the_controls(session, plant):
    res = pb.measure(session, plant=PLANTS[plant], release=False)
    failing = {k for k, c in res["checks"].items() if not pb.passes(c)}
    assert res["correct"] is (plant == "none"), (plant, res["checks"])
    if plant == "skipped_imu_dropped":
        assert "c1_preint_err" in failing, res["checks"]
    if plant == "none":
        # the reference at float16, the precision below the port's, fails
        # the limit on the same packets
        limit = res["checks"]["c1_preint_err"]["limit"]
        assert session.cell.preint_err(torch.float16) > limit


def plant_slow_lane(cell, mods):
    """Phone 1's lane reaches the freed edge lock 0.3 s late, as a busy
    host may be slow to wake it."""
    server = cell.server
    inner = server.track_fn
    lock = cell.slam._edge_lock

    def track_fn(client_id, pkt):
        if client_id == 1:
            while lock.locked():
                time.sleep(0.005)
            time.sleep(0.3)
        return inner(client_id, pkt)

    server.track_fn = track_fn

    def undo():
        server.track_fn = inner
    return undo


def test_the_phones_keep_strict_turns_behind_a_slow_lane(session):
    """Phone 0's next packet waits for phone 1's to take its turn at the
    lock, however late phone 1's lane gets there: the turns alternate."""
    res = pb.measure(session, plant=plant_slow_lane, release=False)
    clients = [c[0] for c in session.cell.window_calls]
    assert len(clients) >= 4
    assert all(a != b for a, b in zip(clients, clients[1:])), clients
    assert res["checks"]["poses_unshared"]["value"] <= 1


# ---------------------------------------------------------- the controls
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the edge cell's controls, one set-up a seed")
    ap.add_argument("--workload", default=CELL)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--plants", default="none", help="comma-separated, of " + ", ".join(PLANTS))
    args = ap.parse_args(argv)
    plants = args.plants.split(",")
    unknown = [p for p in plants if p not in PLANTS]
    if unknown:
        raise SystemExit(f"unknown plants {unknown}")
    for seed in (int(s) for s in args.seeds.split(",")):
        run_args = argparse.Namespace(workload=args.workload, seed=seed, seconds=args.seconds,
                                      trace=0)
        ss = pb.prepare(run_args)
        for i, plant in enumerate(plants):
            captures = timing.counts().get("track.vi_pose_capture", 0)
            res = pb.measure(ss, plant=PLANTS[plant], release=i == len(plants) - 1)
            captures = timing.counts().get("track.vi_pose_capture", 0) - captures
            print(json.dumps(dict(workload=args.workload, plant=plant, seed=seed,
                                  correct=res["correct"], attempted=res["attempted"],
                                  failed=res["failed"], numbers=ss.numbers,
                                  c1_preint_err_f16=ss.cell.preint_err(torch.float16),
                                  frames_per_s=res["metrics"]["frames_per_s"]["value"],
                                  setup_s=ss.setup_s,
                                  captures_in_window=captures,
                                  memory_peak_bytes=res["device"]["memory_peak_bytes"])),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
