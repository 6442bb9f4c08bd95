"""The edge server's lanes with IMU, on the CPU: every IMU sample a
secondary phone sends reaches its tracker, and the fork's lane rule holds.

Two fake phones stream seeded random features and 200 Hz IMU (gyro,
accelerometer, and a tracker bias) over loopback to an `EdgeServer` whose
`track_fn` runs the port's `Slam.track_edge` (IMU_MONOCULAR) and then
answers by a plan, so that phone 1 loses and regains tracking at chosen
frames. Held against `tests/edge_lane_reference.py` (float64, plain
torch):

- the server's tracked, answered and skipped frame ids and its budget
  commands equal the reference rule's;
- each tracked frame of phone 1 preintegrates every sample phone 1 sent
  since its previous tracked frame: dR, dV, dP and dT within PREINT_TOL
  of the reference's (relative), dT 0.25 s over a five-frame step;
- the lane's counters (`edge.skipped`, `edge.imu_carried`) and stages
  (`edge.decode`, `edge.lock_wait` with `edge.features` inside it, each
  with its client), and the tracker's `track.imu_truncated`;
- what a secondary lane's inertial chain needs once its IMU is whole:
  the velocity from two poses and the frame's preintegration (exact on a
  motion made from those deltas, 1e-4 m/s in float32), the chain's restart
  after a relocalization, and culling that keeps each chain's last
  keyframe.

Every socket has a timeout and every wait a deadline.
"""

import time

import numpy as np
import pytest
import torch

import edge_lane_reference as ref
from orbslam3_tpu_torch.core.camera import Camera
from orbslam3_tpu_torch.edge import server as edge_server
from orbslam3_tpu_torch.edge.client_sim import FakePhone
from orbslam3_tpu_torch.edge.server import EdgeServer
from orbslam3_tpu_torch.engine.system import Sensor, Slam, SystemConfig
from orbslam3_tpu_torch.engine.tracking import Tracker, TrackerConfig
from orbslam3_tpu_torch.imu import preintegration as preint
from orbslam3_tpu_torch.slam_map.map_state import MapConfig, MapState
from orbslam3_tpu_torch.utils import timing
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# relative: float32 against float64 over 50 samples reads ~4e-7; one 5 ms
# sample left out reads 4e-3 and more (dT 2% off where it is the last), the
# window integrated at float16 ~7e-4
# (test_the_reference_preintegration_matches_the_port)
PREINT_TOL = 2e-5
FPS = 20
IMU_HZ = 200
N_FEAT = 100
T0_NS = [100 * 10 ** 9, 250 * 10 ** 9]   # each phone's clock at its frame 0
# phone 1's packets; the tracker answers LOST at these (its tracked) ids:
# id 0 LOST (1000 features), 1 regained (500), 2-4 skipped, 5, 6-9
# skipped, 10 and 11 LOST (1000), 12 regained (500), 13-14 skipped, 15,
# 16-19 skipped, 20
PHONE1_IDS = list(range(21))
PHONE1_LOST = {0, 10, 11}
PHONE0_IDS = list(range(8))
WAIT_S = 60.0


def _frame_ns(phone: int, fid: int) -> int:
    return T0_NS[phone] + fid * 10 ** 9 // FPS


def _stream(phone: int, ids, rng):
    """Per packet: (id, ts_ns, uv, desc, imu_ns, gyro, acc), the IMU at
    200 Hz in (previous frame, this frame]."""
    out = []
    per = IMU_HZ // FPS
    for fid in ids:
        ts = _frame_ns(phone, fid)
        imu_ns = ts - (per - 1 - np.arange(per)) * (10 ** 9 // IMU_HZ)
        gyro = rng.normal(0.0, 0.5, (per, 3)).astype(np.float32)
        acc = (rng.normal(0.0, 1.0, (per, 3)) + [0.0, 0.0, 9.81]).astype(np.float32)
        uv = rng.uniform(0, [640, 480], (N_FEAT, 2)).astype(np.float32)
        desc = rng.integers(0, 256, (N_FEAT, 32), dtype=np.uint8)
        out.append((fid, ts, uv, desc, imu_ns.astype(np.int64), gyro, acc))
    return out


def _ok(phone: int, fid: int) -> bool:
    return phone == 0 or fid not in PHONE1_LOST


@pytest.fixture
def timed():
    was = timing.enabled()
    timing.enable(True)
    yield
    timing.enable(was)


def _wait(cond, what: str):
    deadline = time.monotonic() + WAIT_S
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: not within {WAIT_S} s")
        time.sleep(0.01)


@pytest.fixture(scope="module")
def lanes():
    """Both phones' streams through the server, with what the track_fn,
    the phones, the counters and the stages saw."""
    rng = np.random.default_rng(19)
    bias = rng.normal(0.0, [0.02] * 3 + [0.1] * 3).astype(np.float32)
    cam = Camera.pinhole(458.0, 458.0, 320.0, 240.0, width=640, height=480, device="cpu")
    slam = Slam(cam, SystemConfig(sensor=Sensor.IMU_MONOCULAR, imu_calib=preint.ImuCalib.create(),
                                  map=MapConfig(32, 4096, 128),
                                  tracker=TrackerConfig(n_features=128)), device="cpu")
    slam.add_client(1)._frame_bias = bias.copy()
    streams = [_stream(0, PHONE0_IDS, rng), _stream(1, PHONE1_IDS, rng)]
    seen = {0: [], 1: []}   # per client: (frame id, the tracker's Preintegrated or None)

    def track_fn(cid, pkt):
        slam.track_edge(cid, pkt)
        seen[cid].append((int(pkt.frame_id), slam.trackers[cid]._pre_cur))
        if not _ok(cid, pkt.frame_id):
            return None
        return np.eye(3, dtype=np.float32), np.array([-pkt.frame_id, 0.0, 0.0], np.float32)

    was = timing.enabled()
    timing.enable(True)
    counts0 = timing.counts()
    n_spans = len(timing.spans())
    srv = EdgeServer(track_fn, slam_port=0, acoustic_port=0, max_clients=2)
    phones = []
    try:
        for p in (0, 1):
            phones.append(FakePhone("127.0.0.1", srv.slam_port, None, p))
            _wait(lambda: len(srv.lanes) > p, f"lane {p}")
        for p, ph in enumerate(phones):   # phone 1 streams while phone 0 is tracked
            for fid, ts, uv, desc, imu_ns, gyro, acc in streams[p]:
                ph.send_frame(fid, ts, uv, desc, imu_ns, gyro, acc)
        for p, ln in enumerate(srv.lanes):
            n = len(streams[p])
            _wait(lambda: ln.stats.frames_tracked + ln.stats.frames_skipped == n
                  or ln.errors, f"lane {p}'s packets")
            assert not ln.errors, ln.errors
        _wait(lambda: all(len(ph.poses) == len(seen[p]) for p, ph in enumerate(phones)),
              "the replies")
        time.sleep(0.2)   # a late budget command would land here
        counts = {k: v - counts0.get(k, 0) for k, v in timing.counts().items()}
        spans = timing.spans()[n_spans:]
        out = dict(streams=streams, seen=seen, bias=bias, counts=counts,
                   spans=spans, poses=[list(ph.poses) for ph in phones],
                   budgets=[list(ph.budgets) for ph in phones],
                   stats=[ln.stats for ln in srv.lanes])
    finally:
        timing.enable(was)
        for ph in phones:
            ph.close()
        srv.close()
    yield out


def test_the_lane_rule_matches_the_reference(lanes):
    """Tracked, answered and skipped ids and the budget commands, per phone,
    as the fork's rule gives them, on a plan that loses and regains."""
    for p in (0, 1):
        ids = [s[0] for s in lanes["streams"][p]]
        want = ref.lane_rule(p, ids, lambda fid: _ok(p, fid))
        tracked = [fid for fid, _ in lanes["seen"][p]]
        assert tracked == want["tracked"]
        assert sorted(set(ids) - set(tracked)) == want["skipped"]
        assert lanes["stats"][p].frames_skipped == len(want["skipped"])
        assert lanes["budgets"][p] == want["budgets"]
        # one reply per answered packet, in order: its camera centre names
        # the frame where it was tracked, zeros where LOST
        poses = lanes["poses"][p]
        assert len(poses) == len(want["answered"])
        for fid, (_, centre) in zip(want["answered"], poses):
            np.testing.assert_allclose(centre, [fid, 0, 0] if _ok(p, fid) else [0, 0, 0])
    assert ref.lane_rule(1, PHONE1_IDS, lambda fid: fid not in PHONE1_LOST)["skipped"] == \
        [2, 3, 4, 6, 7, 8, 9, 13, 14, 16, 17, 18, 19]


def test_every_sample_phone1_sent_reaches_its_tracker(lanes):
    """Each tracked frame of phone 1 (after its first) integrates every
    sample since its previous tracked frame, at the tracker's bias."""
    stream = lanes["streams"][1]
    ts_ns = np.concatenate([s[4] for s in stream])
    gyro = np.concatenate([s[5] for s in stream])
    acc = np.concatenate([s[6] for s in stream])
    seen = lanes["seen"][1]
    assert seen[0][1] is None   # the first frame has nothing before it
    worst, dts = 0.0, {}
    for (prev, _), (fid, pre) in zip(seen, seen[1:]):
        np.testing.assert_array_equal(pre.bias.numpy(), lanes["bias"])
        want = ref.preintegrate(ts_ns, gyro, acc, _frame_ns(1, prev), _frame_ns(1, fid),
                                lanes["bias"])
        got = dict(dR=pre.dR.numpy(), dV=pre.dV.numpy(), dP=pre.dP.numpy(), dT=float(pre.dT))
        worst = max(worst, ref.relative_error(got, want))
        dts[fid] = float(pre.dT)
    assert worst < PREINT_TOL, worst
    # a five-frame step: 0.25 s, where the fork's lane gave one frame's 0.05 s
    assert dts[20] == pytest.approx(0.25, abs=1e-6) and dts[10] == pytest.approx(0.25, abs=1e-6)
    assert dts[5] == pytest.approx(0.20, abs=1e-6) and dts[15] == pytest.approx(0.15, abs=1e-6)


def test_the_lane_counts_and_stages(lanes):
    stream = lanes["streams"][1]
    skipped = ref.lane_rule(1, PHONE1_IDS, lambda fid: fid not in PHONE1_LOST)["skipped"]
    counts = lanes["counts"]
    assert counts.get("edge.skipped") == len(skipped)
    assert counts.get("edge.imu_carried") == sum(len(s[4]) for s in stream if s[0] in skipped)
    spans = lanes["spans"]
    for p in (0, 1):
        n_sent = len(lanes["streams"][p])
        n_tracked = len(lanes["seen"][p])
        mine = [s for s in spans if s.fields.get("client") == p]
        assert sum(s.name == "edge.decode" for s in mine) == n_sent
        waits = {s.id: s for s in mine if s.name == "edge.lock_wait"}
        feats = [s for s in mine if s.name == "edge.features"]
        assert len(waits) == len(feats) == n_tracked
        # the features are made inside the wait, which ends before the frame
        assert all(f.parent in waits for f in feats)
        frames = [s for s in spans if s.name == "slam.frame" and s.fields["client"] == p]
        assert len(frames) == n_tracked
        assert all(w.parent == -1 for w in waits.values())


def test_a_gap_over_the_per_frame_cap_is_counted(timed):
    """`_preintegrate_to` integrates the first `imu_samples_per_frame`
    samples of a frame and counts the rest in `track.imu_truncated`."""
    cam = Camera.pinhole(458.0, 458.0, 320.0, 240.0, width=640, height=480, device="cpu")
    slam = Slam(cam, SystemConfig(sensor=Sensor.IMU_MONOCULAR, imu_calib=preint.ImuCalib.create(),
                                  map=MapConfig(32, 4096, 128),
                                  tracker=TrackerConfig(n_features=128, imu_samples_per_frame=16)),
                device="cpu")
    rng = np.random.default_rng(3)
    before = timing.counts().get("track.imu_truncated", 0)
    for i, n in enumerate((4, 40)):   # 40 samples in the second frame: 24 over the cap
        fid, ts, uv, desc, _, _, _ = _stream(0, [i], rng)[0]
        imu_ns = ts - np.arange(n)[::-1] * (10 ** 9 // IMU_HZ // 8)   # at 1.6 kHz
        gyro = rng.normal(0.0, 0.5, (n, 3)).astype(np.float32)
        acc = rng.normal(0.0, 1.0, (n, 3)).astype(np.float32)
        pkt = edge_server.wire.FramePacket(fid, ts, uv, desc, imu_ns.astype(np.int64), gyro, acc)
        slam.track_edge(0, pkt)
    assert timing.counts().get("track.imu_truncated", 0) - before == 24
    pre = slam.trackers[0]._pre_cur
    # from frame 0 to the 16th sample of frame 1, the last 24 cut
    assert float(pre.dT) == pytest.approx((imu_ns[15] - _frame_ns(0, 0)) * 1e-9, abs=1e-7)


def test_the_reference_preintegration_matches_the_port():
    """`edge_lane_reference.preintegrate` against the port's
    `preint.preintegrate` on the same samples at a random bias, within
    PREINT_TOL; and the tolerance separates a dropped sample and float16."""
    rng = np.random.default_rng(5)
    n = 50
    ts_ns = 10 ** 9 + np.arange(1, n + 1, dtype=np.int64) * (10 ** 9 // IMU_HZ)
    gyro = rng.normal(0.0, 0.5, (n, 3)).astype(np.float32)
    acc = (rng.normal(0.0, 1.0, (n, 3)) + [0.0, 0.0, 9.81]).astype(np.float32)
    bias = rng.normal(0.0, [0.02] * 3 + [0.1] * 3).astype(np.float32)
    want = ref.preintegrate(ts_ns, gyro, acc, 10 ** 9, int(ts_ns[-1]), bias)
    dt = np.diff(np.concatenate([[10 ** 9], ts_ns])) * 1e-9
    pre = preint.preintegrate(torch.from_numpy(acc), torch.from_numpy(gyro),
                              dt.astype(np.float32), torch.from_numpy(bias),
                              preint.ImuCalib.create())
    got = dict(dR=pre.dR.numpy(), dV=pre.dV.numpy(), dP=pre.dP.numpy(), dT=float(pre.dT))
    assert ref.relative_error(got, want) < PREINT_TOL
    assert want["dT"] == pytest.approx(0.25)
    # one 5 ms sample left out, and the whole window at float16, fail it
    dropped = ref.preintegrate(np.delete(ts_ns, 20), np.delete(gyro, 20, 0),
                               np.delete(acc, 20, 0), 10 ** 9, int(ts_ns[-1]), bias)
    half = ref.preintegrate(ts_ns, gyro, acc, 10 ** 9, int(ts_ns[-1]), bias,
                            dtype=torch.float16)
    assert ref.relative_error(dropped, want) > 10 * PREINT_TOL
    assert ref.relative_error(half, want) > 10 * PREINT_TOL


# ------------------------------------- a secondary lane's inertial chain
def _tracker(calib):
    cam = Camera.pinhole(458.0, 458.0, 320.0, 240.0, width=640, height=480, device="cpu")
    m = MapState(MapConfig(16, 256, 64), device="cpu")
    return Tracker(cam, m, TrackerConfig(n_features=64), client_id=1, imu_calib=calib,
                   device="cpu")


def test_the_velocity_from_two_poses_and_the_imu():
    """On an inertial map the velocity at a frame tracked without the VI
    solve is the one its pose, the last frame's and the frame's
    preintegration agree on: exact on a motion made from those deltas,
    where the finite difference is off by the shake within the interval."""
    rng = np.random.default_rng(11)
    calib = preint.ImuCalib.create(Tbc=np.eye(4))
    tr = _tracker(calib)
    tr.map.imu_initialized = True
    n, dt = 50, 0.005
    acc = (rng.normal(0.0, 3.0, (n, 3)) + [0.0, 0.0, 9.81]).astype(np.float32)
    gyro = rng.normal(0.0, 0.8, (n, 3)).astype(np.float32)
    pre = preint.preintegrate(torch.from_numpy(acc), torch.from_numpy(gyro),
                              np.full(n, dt, np.float32), torch.zeros(6), calib)
    dR, dV, dP = (x.double().numpy() for x in (pre.dR, pre.dV, pre.dP))
    T, g = float(pre.dT), np.array([0.0, 0.0, -preint.GRAVITY])
    R1 = so3_exp_np(rng.normal(0.0, 1.0, 3))
    p1, v1 = rng.normal(0.0, 2.0, 3), rng.normal(0.0, 1.0, 3)
    R2, p2, v2 = R1 @ dR, p1 + v1 * T + 0.5 * g * T * T + R1 @ dP, v1 + g * T + R1 @ dV
    tr._pre_cur = pre
    tr.R_cw, tr.t_cw = R2.T.astype(np.float32), (-R2.T @ p2).astype(np.float32)
    tr._update_velocity(R1.T.astype(np.float32), (-R1.T @ p1).astype(np.float32), T)
    np.testing.assert_allclose(tr._vel_w, v2, atol=1e-4)
    assert np.linalg.norm((p2 - p1) / T - v2) > 0.1
    # before the IMU initialization: the finite difference
    tr.map.imu_initialized = False
    tr._update_velocity(R1.T.astype(np.float32), (-R1.T @ p1).astype(np.float32), T)
    np.testing.assert_allclose(tr._vel_w, (p2 - p1) / T, atol=1e-4)


def so3_exp_np(phi):
    return ref.so3_exp(torch.as_tensor(phi, dtype=torch.float64)).numpy()


def test_a_relocalized_inertial_lane_restarts_its_chain():
    """After a relocalization on an inertial map the tracker drops the
    samples and the velocity of the frames before it: no solve is anchored
    at the relocalized reference keyframe until the tracker makes a
    keyframe of its own, and that keyframe gets no inertial link."""
    calib = preint.ImuCalib.create()
    tr = _tracker(calib)
    tr.relocalizer = lambda feats: (np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                                    None, 0)
    tr._pre_frames = [preint.identity_preintegrated()]
    tr._vel_w = np.ones(3, np.float32)
    assert tr._try_relocalize(None)
    assert tr._pre_frames == [] and tr._vel_w is None and not tr._pre_from_ref
    assert tr.ref_kf == 0
    # a visual tracker is left as it was
    vis = _tracker(None)
    vis.relocalizer = tr.relocalizer
    vis._pre_frames = [preint.identity_preintegrated()]
    assert vis._try_relocalize(None) and len(vis._pre_frames) == 1 and vis._pre_from_ref


def test_culling_keeps_each_lanes_last_inertial_keyframe():
    """On an inertial map a redundant keyframe goes only from inside its
    chain: nine keyframes 0.25 s apart see the same 100 points; the chain's
    last one, numbered by a second lane (its frame id below the first
    lane's, so the newest-two rule does not cover it), stays, and the
    redundant ones inside the chain go, their links merged."""
    from orbslam3_tpu_torch.engine.local_mapping import LocalMapper
    rng = np.random.default_rng(13)
    cam = Camera.pinhole(458.0, 458.0, 320.0, 240.0, width=640, height=480, device="cpu")
    m = MapState(MapConfig(16, 256, 128), device="cpu")
    ids = m.add_points(pos=rng.normal(0.0, 1.0, (100, 3)) + [0.0, 0.0, 5.0],
                       desc=rng.integers(0, 2 ** 32, (100, 8), dtype=np.uint32), first_kf=0)
    obs = np.full(128, -1, np.int32)
    obs[:100] = ids
    ks, prev = [], -1
    for i in range(9):
        prev = m.add_keyframe(np.eye(3, dtype=np.float32), np.array([0.02 * i, 0, 0], np.float32),
                              0.25 * i, 1 if i == 8 else i, np.zeros((128, 2), np.float32),
                              np.zeros(128, np.int32), np.zeros(128, np.float32),
                              rng.integers(0, 2 ** 32, (128, 8), dtype=np.uint32),
                              obs >= 0, obs, prev_kf=prev,
                              preint=preint.identity_preintegrated() if i else None)
        ks.append(prev)
    m.imu_initialized, m.iba_stage = True, 2
    LocalMapper(cam, m, imu_calib=preint.ImuCalib.create(), device="cpu")._cull_keyframes(ks[7])
    gone = [k for k in ks if not m.kf_valid[k]]
    assert gone and ks[8] not in gone and ks[0] not in gone
    kept = [k for k in ks if m.kf_valid[k]]
    assert [int(m.kf_prev[k]) for k in kept[1:]] == kept[:-1]
