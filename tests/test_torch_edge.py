"""Port parity, CPU: the edge layer (slice H) against the JAX package.

Inputs are made with numpy from seeds. Tolerances:

- wire: the port's `encode_frame`, `encode_cmd_*` and
  framing equal the JAX package's byte for byte; the C++ and numpy
  decoders equal the JAX package's decode field by field, on random
  frames, on the half-pixel / out-of-range coordinates of
  `tests/test_native.py`, and give None on malformed and truncated
  payloads; `StreamDecoder` (the C++ stream scan) reassembles fragmented
  streams as the JAX package's does, and the scan equals its numpy
  version;
- `features_from_wire` / `features_from_arrays` exact, descriptor words
  bit for bit; `undistort` within 1e-5 of the largest coordinate;
- acoustic: `interval_to_distance` and the five LM solves within 1e-4
  (relative to the largest entry; f32, 10 iterations, both packages);
  without a device they ask for the card and raise here;
- the server: the JAX package's loopback test with a stub tracker; the
  port's `Slam.track_edge` behind its `EdgeServer` against the JAX
  package's behind its own, two phones in lockstep on a feature-level
  session (the two-view samples the reference drew injected): the same
  state per packet, poses within 1e-3, the same budget commands and
  events, the same acoustic distance;
- the port's app (`python -m orbslam3_tpu_torch.apps.edge_server
  --selftest --device cpu`) runs a few seconds and saves both clients'
  trajectories.

Every socket has a timeout and every wait a deadline.
"""

import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke as smoke
from orbslam3_tpu.core.camera import Camera as JCamera
from orbslam3_tpu.edge import acoustic as jac
from orbslam3_tpu.edge import wire as jwire
from orbslam3_tpu.edge.server import EdgeServer as JEdgeServer
from orbslam3_tpu.engine.system import Slam as JSlam
from orbslam3_tpu.engine.system import SystemConfig as JSystemConfig
from orbslam3_tpu.engine.tracking import TrackerConfig as JTrackerConfig
from orbslam3_tpu.slam_map.map_state import MapConfig as JMapConfig
from orbslam3_tpu.utils import synth as jsynth
from orbslam3_tpu.vision import frame as jframe
from orbslam3_tpu_torch.apps.edge_server import fuse_acoustic
from orbslam3_tpu_torch.core.camera import Camera as TCamera
from orbslam3_tpu_torch.edge import acoustic as tac
from orbslam3_tpu_torch.edge import wire
from orbslam3_tpu_torch.edge.client_sim import FakePhone
from orbslam3_tpu_torch.edge.server import EdgeServer
from orbslam3_tpu_torch.engine.system import Slam, SystemConfig
from orbslam3_tpu_torch.engine.tracking import TrackerConfig
from orbslam3_tpu_torch.slam_map.map_state import MapConfig
from orbslam3_tpu_torch.vision import frame as tframe
from test_torch_slam_e2e import reference_samples
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACOUSTIC_TOL = 1e-4
POSE_TOL = 1e-3


def _frame(rng, n=120, m=9):
    uv = rng.uniform(0, 640, (n, 2)).astype(np.float32)
    desc = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    ts = rng.integers(10 ** 15, 10 ** 18, m, dtype=np.int64)
    gyro = rng.normal(0, 1, (m, 3)).astype(np.float32)
    acc = rng.normal(0, 9.8, (m, 3)).astype(np.float32)
    return uv, desc, ts, gyro, acc


def _edge_uv():
    """The rounding and clamping cases of tests/test_native.py."""
    return np.array([[0.5, 1.5], [2.5, 65534.5], [-3.0, 70000.0], [100.49, 100.51],
                     [np.nan, -0.4]], np.float32)


def _same_packet(a, b):
    assert (a.frame_id, a.timestamp_ns) == (b.frame_id, b.timestamp_ns)
    for name in ("uv", "desc", "imu_ts_ns", "imu_gyro", "imu_acc"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


# ------------------------------------------------------------------ wire
@pytest.mark.parametrize("case", ["random", "empty", "no_imu", "rounding"])
def test_encode_matches_jax_byte_for_byte(case):
    rng = np.random.default_rng(11)
    uv, desc, ts, gyro, acc = _frame(rng, *{"random": (120, 9), "empty": (0, 0),
                                            "no_imu": (40, 0), "rounding": (5, 2)}[case])
    if case == "rounding":
        uv = _edge_uv()
    args = (7, 123456789012345, uv, desc, ts, gyro, acc)
    ref = jwire.encode_frame(*args)
    assert wire.encode_frame(*args) == ref
    assert wire.frame_packet(ref) == jwire.frame_packet(ref)
    for n in (0, 500, 1000, 65535):
        assert wire.encode_cmd_feature_count(n) == jwire.encode_cmd_feature_count(n)
    pos = rng.normal(0, 3, 3).astype(np.float32)
    assert wire.encode_cmd_pose_delay(0.0371, pos) == jwire.encode_cmd_pose_delay(0.0371, pos)
    code, (delay, p) = wire.decode_cmd(wire.encode_cmd_pose_delay(0.0371, pos))
    assert code == wire.CMD_POSE_DELAY and delay == np.float32(0.0371)
    np.testing.assert_array_equal(p, pos)


@pytest.mark.parametrize("case", ["random", "large", "rounding"])
def test_decoders_match_jax(case):
    rng = np.random.default_rng({"random": 3, "large": 4, "rounding": 5}[case])
    uv, desc, ts, gyro, acc = _frame(rng, *{"random": (300, 20), "large": (1000, 40),
                                            "rounding": (5, 3)}[case])
    if case == "rounding":
        uv = _edge_uv()
    payload = jwire.encode_frame(3, -42, uv, desc, ts, gyro, acc)
    ref = jwire.decode_frame(payload)
    before = wire.decodes["native"]
    _same_packet(wire.decode_frame(payload), ref)
    _same_packet(wire.decode_frame_py(payload), ref)
    assert wire.decodes["native"] == before + 1


def test_malformed_and_truncated_payloads_give_none():
    rng = np.random.default_rng(6)
    payload = jwire.encode_frame(1, 2, *_frame(rng, 10, 3))
    bad = [b"", payload[:15], payload[:16], payload[:16 + 36 * 10 - 1], payload[:-1],
           payload[:12] + b"\xff\xff" + payload[14:]]
    for p in bad:
        assert jwire.decode_frame(p) is None
        assert wire.decode_frame(p) is None
        assert wire.decode_frame_py(p) is None
    # a longer payload than its counts say still parses (the reference's rule)
    _same_packet(wire.decode_frame(payload + b"\x00" * 7), jwire.decode_frame(payload))


def test_stream_decoder_and_native_scan():
    rng = np.random.default_rng(8)
    payloads = [bytes(rng.integers(0, 256, int(n), dtype=np.uint8))
                for n in rng.integers(0, 3000, 12)] + [b""]
    blob = b"".join(wire.frame_packet(p) for p in payloads)
    for step in (1, 7, 4096):
        dec, jdec, got, jgot = wire.StreamDecoder(), jwire.StreamDecoder(), [], []
        for k in range(0, len(blob), step):
            got += dec.feed(blob[k:k + step])
            jgot += jdec.feed(blob[k:k + step])
        assert got == jgot == payloads
    for cut in (0, 1, 2, len(blob) - 5, len(blob)):  # complete packets, and a tail
        found, consumed = wire.scan_stream(bytearray(blob[:cut]))
        assert (found, consumed) == wire.scan_stream_py(blob[:cut])
        assert found == jwire.StreamDecoder().feed(blob[:cut])
        assert consumed == sum(len(p) + 2 for p in found)


# ----------------------------------------------------------------- frame
@pytest.mark.parametrize("n,cap", [(120, 200), (300, 200), (0, 50)])
def test_features_from_wire_and_arrays_exact(n, cap):
    rng = np.random.default_rng(n + cap)
    uv = np.round(rng.uniform(0, 640, (n, 2))).astype(np.float32)
    desc = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    ref = jframe.features_from_arrays(uv, desc, cap)
    got = tframe.features_from_arrays(uv, desc, cap, device="cpu")
    for name in ("uv", "uv_raw", "response", "angle", "octave", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert got.desc.dtype == torch.int32
    # bit for bit: the int32 words are the reference's uint32 words
    np.testing.assert_array_equal(got.desc.numpy().view(np.uint32), np.asarray(ref.desc))
    m = min(n, cap)
    words = np.ascontiguousarray(desc[:m]).view("<u4").reshape(m, 8)
    np.testing.assert_array_equal(got.desc.numpy()[:m].view(np.uint32), words)
    wire_got = tframe.features_from_wire(uv, words, cap, device="cpu")
    np.testing.assert_array_equal(wire_got.desc.numpy(), got.desc.numpy())
    # the phone's side gives the same bytes back
    uv_b, desc_b = tframe.wire_arrays(got)
    np.testing.assert_array_equal(desc_b, desc[:m])
    np.testing.assert_array_equal(uv_b, uv[:m])


def test_undistort_matches_jax():
    rng = np.random.default_rng(9)
    dist = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05)
    jc = JCamera.pinhole(458.654, 457.296, 367.215, 248.375, dist=dist)
    tc = TCamera.pinhole(458.654, 457.296, 367.215, 248.375, dist=dist, device="cpu")
    uv = np.round(rng.uniform(0, [752, 480], (150, 2))).astype(np.float32)
    desc = rng.integers(0, 256, (150, 32), dtype=np.uint8)
    ref = jframe.undistort(jframe.features_from_arrays(uv, desc, 200), jc)
    got = tframe.undistort(tframe.features_from_arrays(uv, desc, 200, device="cpu"), tc)
    # 1e-5 of the largest coordinate (measured: one f32 ulp, 6.1e-5 px at ~700 px)
    ref_uv = np.asarray(ref.uv)
    np.testing.assert_allclose(got.uv.numpy(), ref_uv, rtol=0,
                               atol=1e-5 * np.abs(ref_uv).max())
    np.testing.assert_array_equal(got.uv_raw.numpy(), np.asarray(ref.uv_raw))


# -------------------------------------------------------------- acoustic
def _close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=ACOUSTIC_TOL * max(np.abs(ref).max(), 1.0))


def _rot(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], axis=1).astype(np.float32)


def _acoustic_case(name, rng):
    """(args, kwargs) of one seeded problem of `name`."""
    p = rng.uniform(-2, 2, 3).astype(np.float32)
    anchors = rng.uniform(-3, 3, (5, 3)).astype(np.float32)
    d = np.linalg.norm(p - anchors, axis=1).astype(np.float32) * 2.5
    valid = np.array([True, True, False, True, True])
    if name == "given_scale":
        return (p + rng.normal(0, 0.3, 3).astype(np.float32), anchors, d, 2.5), dict(valid=valid)
    if name == "regularized":
        return (p + 0.2, p, anchors[:2], d[:2] / 2.5, 1.0), {}
    if name == "imu_chain":
        T = 6
        true = np.cumsum(rng.normal(0, 0.5, (T, 3)), axis=0).astype(np.float32)
        deltas = np.vstack([np.zeros(3), np.diff(true, axis=0)]).astype(np.float32)
        dd = np.linalg.norm(true[-1] - anchors[:4], axis=1).astype(np.float32)
        return (true + rng.normal(0, 0.2, (T, 3)).astype(np.float32), deltas, anchors[:4], dd,
                1.0), {}
    if name == "key_chain":
        T = 5
        true = np.cumsum(rng.normal(0, 0.4, (T, 3)), axis=0).astype(np.float32)
        dd = np.stack([np.linalg.norm(q - anchors[:3], axis=1) for q in true[1:]]).astype(
            np.float32)
        noisy = true.copy()
        noisy[1:] += rng.normal(0, 0.3, (T - 1, 3)).astype(np.float32)
        vm = np.ones_like(dd, bool)
        vm[1, 2] = False
        return (noisy, np.diff(true, axis=0), dd, anchors[:3], 1.0), dict(valid=vm)
    mc, s, K, M = np.array([0.03, -0.01, 0.05], np.float32), 0.5, 12, 3
    R0, t0 = _rot(rng, K), rng.uniform(-2, 2, (K, 3)).astype(np.float32)
    R1, t1 = _rot(rng, M), rng.uniform(-2, 2, (M, 3)).astype(np.float32)
    wm0 = np.einsum("kij,j->ki", R0, -s * mc) + t0
    wm1 = np.einsum("mij,j->mi", R1, -s * mc) + t1
    dd = (np.linalg.norm(wm0[:, None] - wm1[None], axis=-1) / s).astype(np.float32)
    return (mc + rng.normal(0, 0.02, 3).astype(np.float32), s * 1.2, R0, t0, R1, t1, dd), {}


ACOUSTIC = {"given_scale": "optimize_position_given_scale",
            "regularized": "optimize_position_regularized",
            "imu_chain": "imu_acoustic_optimize", "key_chain": "imu_acoustic_key_optimize",
            "calibration": "calibrate_mic_offset"}


@pytest.mark.parametrize("name", list(ACOUSTIC))
def test_acoustic_solves_match_jax(name):
    args, kw = _acoustic_case(name, np.random.default_rng(len(name)))
    ref = getattr(jac, ACOUSTIC[name])(*args, **kw)
    got = getattr(tac, ACOUSTIC[name])(*args, **kw, device="cpu")
    if name == "calibration":
        _close(got[0].numpy(), ref[0])
        _close(got[1].numpy(), ref[1])
        assert got[1].dtype == torch.float32
    else:
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        _close(got.numpy(), ref)


def test_interval_to_distance_matches_jax():
    n1 = np.array([300, 30000, 0, -50, 10])
    n2 = np.array([280, 30000, 0, 10, 10])
    d, ok = tac.interval_to_distance(n1, n2, device="cpu")
    dj, okj = jac.interval_to_distance(n1, n2)
    _close(d.numpy(), dj)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okj))
    expect = (331.3 + 0.606 * 27.1) * 580 / 96000 + 0.0272
    assert abs(float(d[0]) - expect) < 1e-5 and not bool(ok[1])
    assert tac.SPEED_OF_SOUND == jac.speed_of_sound(tac.TEMPERATURE_C)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the machine without a card")
@pytest.mark.parametrize("name", list(ACOUSTIC) + ["interval_to_distance"])
def test_acoustic_asks_for_the_card_by_default(name):
    """With numpy inputs and no device, each acoustic entry point computes
    on the card, so here, without one, it raises (no silent CPU)."""
    if name == "interval_to_distance":
        fn, args, kw = tac.interval_to_distance, (np.array([300]), np.array([280])), {}
    else:
        fn = getattr(tac, ACOUSTIC[name])
        args, kw = _acoustic_case(name, np.random.default_rng(1))
    with pytest.raises(RuntimeError, match="CUDA requested"):
        fn(*args, **kw)


# ------------------------------------------------------------- loopback
def test_loopback_server_two_clients():
    """The JAX package's loopback test on the port: two phones stream
    frames and report chirp intervals; the server tracks (a stub), replies
    pose and budget, converts the intervals to a distance."""
    rng = np.random.default_rng(7)
    tracked = []

    def stub_track(cid, pkt):
        tracked.append((cid, pkt.frame_id, pkt.uv.shape[0]))
        if pkt.frame_id < 2:
            return None  # "initializing"
        return np.eye(3, dtype=np.float32), np.array([0.1 * pkt.frame_id, 0, float(cid)],
                                                     np.float32)

    srv = EdgeServer(stub_track, slam_port=0, acoustic_port=0, max_clients=2)
    phones = [FakePhone("127.0.0.1", srv.slam_port, srv.acoustic_port, i) for i in range(2)]
    try:
        uv, desc, ts, gyro, acc = _frame(rng, 50, 4)
        deadline = time.time() + 10
        while len(srv.lanes) < 2 and time.time() < deadline:
            time.sleep(0.01)
        for fid in range(8):
            for ph in phones:
                ph.send_frame(fid, int(1e9 * (100 + fid * 0.05)), uv, desc, ts, gyro, acc)
            time.sleep(0.02)
        deadline = time.time() + 10
        while time.time() < deadline and (len(srv.lanes) < 2
                                          or srv.lanes[0].stats.frames_tracked < 8):
            time.sleep(0.05)
        assert len(srv.lanes) == 2
        # client 0 tracks every frame; client 1 at least its 1-in-5 frames
        assert srv.lanes[0].stats.frames_tracked == 8
        assert srv.lanes[1].stats.frames_tracked >= 1
        assert phones[0].wait_replies(8, 10.0), "no pose replies received"
        assert phones[0].budgets == [1000, 500] and phones[0].feature_budget == 500
        np.testing.assert_allclose(phones[0].poses[-1][1], [-0.7, 0, 0], atol=1e-6)
        assert phones[0].max_clients == 2
        # acoustic: emit, interval reports, CalAcoustic, the fusion pass
        true_d = 1.5
        n_half = FakePhone.distance_to_interval(true_d)
        base = [ph.emit_count for ph in phones]
        srv.broadcast_emit()
        assert phones[0].wait_emit(base[0], 5.0) and phones[1].wait_emit(base[1], 5.0)
        phones[0].report_intervals({1: n_half})
        phones[1].report_intervals({0: n_half})
        deadline = time.time() + 5
        while time.time() < deadline and (
                srv.lanes[1].intervals.get(0) is None or srv.lanes[1].intervals[0].empty()
                or srv.lanes[0].intervals.get(1) is None or srv.lanes[0].intervals[1].empty()):
            time.sleep(0.02)
        dists = srv.cal_acoustic()
        assert len(dists) == 1 and abs(dists[0] - true_d) < 0.01
        fused = fuse_acoustic(srv, dists, "cpu")
        _, anchors, d, new_p = fused[0]
        assert abs(float(np.linalg.norm(new_p - anchors[0])) - d[0]) < 1e-3
        np.testing.assert_allclose(srv.lanes[0].latest_position()[1], new_p, atol=1e-5)
    finally:
        for ph in phones:
            ph.close()
        srv.close()
    assert not any(t.is_alive() for ln in srv.lanes for t in ln._threads)


def test_a_malformed_packet_is_dropped_and_the_lane_kept():
    got = []
    srv = EdgeServer(lambda cid, pkt: got.append(pkt.frame_id) or None, slam_port=0,
                     acoustic_port=0, max_clients=1)
    ph = FakePhone("127.0.0.1", srv.slam_port, None, 0)
    try:
        ph.sock.sendall(wire.frame_packet(b"\x01\x02\x03"))
        ph.send_frame(5, 1, np.zeros((2, 2), np.float32), np.zeros((2, 32), np.uint8))
        assert ph.wait_replies(1, 10.0)
        assert got == [5] and srv.lanes[0].stats.frames_received == 1
    finally:
        ph.close()
        srv.close()


class _SlowList(list):
    """A lane list whose `append` lands 0.5 s late: a lane that served
    before it was published tracks its first frame inside that gap."""

    def append(self, item):
        time.sleep(0.5)
        super().append(item)


def test_a_lane_is_published_before_it_tracks():
    seen = []
    srv = EdgeServer(lambda cid, pkt: seen.append(len(srv.lanes)) or None, slam_port=0,
                     acoustic_port=0, max_clients=1)
    srv.lanes = _SlowList()  # before any phone connects
    ph = FakePhone("127.0.0.1", srv.slam_port, None, 0)
    try:
        ph.send_frame(0, 1, np.zeros((2, 2), np.float32), np.zeros((2, 32), np.uint8))
        assert ph.wait_replies(1, 10.0)
        assert seen == [1]
    finally:
        ph.close()
        srv.close()
    assert not any(t.is_alive() for ln in srv.lanes for t in ln._threads)


# -------------------------------------------------- track_edge, lockstep
EDGE_FEATURES = 600
# phone 0's frames 0-18, then phone 1 (frame ids 3-6: ids 3 and 4 fall to
# the 1-in-5 rule, 5 is tracked) alternating with phone 0's 19-22
EDGE_PLAN = [(0, i, i) for i in range(19)] + [
    x for j in range(4) for x in ((1, 30 + j, 3 + j), (0, 19 + j, 19 + j))]


def _session():
    """A feature-level orbit (`tests/test_slam_e2e.py`'s world) as the
    edge phase's sequence: `images[i]` is the frame index, the phones
    render its features at their budget."""
    world = jsynth.make_world(n_points=3000, seed=4)
    R, t = jsynth.orbit_trajectory(n_frames=80, radius=3.0, arc=1.0)
    seq = SimpleNamespace(images=list(range(len(R))), frame_ts=0.05 * np.arange(len(R)),
                          R_cw=np.asarray(R), t_cw=np.asarray(t))
    jc = JCamera.pinhole(458.0, 458.0, 320.0, 240.0, width=640, height=480)

    def extract(i, budget):
        f = jsynth.render_features(world, R[i], t[i], jc, capacity=min(budget, EDGE_FEATURES),
                                   seed=100 + i)[0]
        return SimpleNamespace(**{k: torch.from_numpy(np.array(getattr(f, k)).view(np.int32)
                                                      if k == "desc" else np.array(getattr(f, k)))
                                  for k in ("uv", "desc", "valid")})
    return seq, extract


@pytest.fixture(scope="module")
def edge_runs():
    seq, extract = _session()
    batches = [[] for _ in seq.frame_ts]
    cfg = dict(map=dict(max_keyframes=64, max_points=8192, features_per_frame=EDGE_FEATURES),
               tracker=dict(n_features=EDGE_FEATURES))
    js = JSlam(JCamera.pinhole(458.0, 458.0, 320.0, 240.0, width=640, height=480),
               JSystemConfig(map=JMapConfig(**cfg["map"]),
                             tracker=JTrackerConfig(**cfg["tracker"])))
    ts_ = Slam(TCamera.pinhole(458.0, 458.0, 320.0, 240.0, width=640, height=480,
                               device="cpu"),
               SystemConfig(map=MapConfig(**cfg["map"]), tracker=TrackerConfig(**cfg["tracker"])),
               device="cpu")
    ts_.trackers[0].sample_fn = reference_samples
    js.add_client(1)
    ts_.add_client(1).sample_fn = reference_samples
    out = {}
    for key, slam, server_cls, fuse in (("jax", js, JEdgeServer, None),
                                        ("port", ts_, EdgeServer, fuse_acoustic)):
        srv = server_cls(slam.track_edge, host="127.0.0.1", slam_port=0, acoustic_port=0,
                         max_clients=2)
        before = wire.decodes["native"]
        out[key] = smoke.edge_phase_report(slam, srv, extract, seq, batches, EDGE_PLAN,
                                           FakePhone, fuse=fuse)
        out[key]["native_decodes"] = wire.decodes["native"] - before
    return out


def test_track_edge_matches_jax_in_lockstep(edge_runs):
    j, p = edge_runs["jax"], edge_runs["port"]
    key = [(r["client"], r["frame_id"], r["ok"], r["state"]) for r in j["records"]]
    assert [(r["client"], r["frame_id"], r["ok"], r["state"]) for r in p["records"]] == key
    assert p["sent"] == j["sent"] and p["skipped"] == j["skipped"] > 0
    assert p["budgets"] == j["budgets"] and p["budgets"][0][:2] == [1000, 500]
    assert p["events"] == j["events"]
    assert p["init_frame"] == j["init_frame"] > 0
    assert p["tracked_after_init"] == j["tracked_after_init"] == 1.0
    worst = 0.0
    for rj, rp in zip(j["records"], p["records"]):
        if rj["ok"]:
            worst = max(worst, float(np.abs(np.asarray(rj["pose"][0]) - rp["pose"][0]).max()),
                        float(np.abs(np.asarray(rj["pose"][1]) - rp["pose"][1]).max()))
    assert worst < POSE_TOL, worst
    assert abs(p["keyframes"] - j["keyframes"]) == 0
    assert p["acoustic"]["dists"] == pytest.approx(j["acoustic"]["dists"], abs=1e-9)


def test_track_edge_wire_path(edge_runs):
    """Every packet went through the C++ codec; the server replied to each
    packet its 1-in-k rule kept, and each budget command is the rule's."""
    p = edge_runs["port"]
    assert p["native_decodes"] == len(EDGE_PLAN) == sum(p["received"])
    assert p["lane_errors"] == []
    for phone in (0, 1):
        recs = [r for r in p["records"] if r["client"] == phone]
        assert p["replies"][phone] == len(recs)
        flag, cmds = False, []
        for r in recs:
            if not flag and not r["ok"]:
                cmds, flag = cmds + [1000], True
            elif flag and r["ok"]:
                cmds, flag = cmds + [500], False
        assert p["budgets"][phone] == cmds
    # client 1 never relocalizes here (no vocabulary), so nothing is fused
    a = p["acoustic"]
    assert abs(a["dists"][0] - a["true_m"]) < 0.01 and "residual_m" not in a
    # the 6-phone trilateration: a stationary point of a cost that is not 0
    assert a["tri_device"] == "cpu" and a["tri_cpu_err"] == 0.0
    assert a["tri_grad"] <= smoke.EDGE_FUSE_GRAD
    assert a["tri_residual_rms"] > 0.1 * smoke.EDGE_FUSE_NOISE_M


def test_track_edge_registers_a_new_client():
    slam = Slam(TCamera.pinhole(458.0, 458.0, 320.0, 240.0, width=640, height=480,
                                device="cpu"), SystemConfig(), device="cpu")
    pkt = wire.decode_frame_py(wire.encode_frame(
        0, 10 ** 9, np.zeros((3, 2), np.float32), np.zeros((3, 32), np.uint8),
        [999_000_000], [[0, 0, 0]], [[0, 0, 9.81]]))
    assert slam.track_edge(3, pkt) is None
    assert 3 in slam.trackers and slam.trackers[3].frame_id == 1


def test_edge_app_selftest_runs(tmp_path):
    out = tmp_path / "traj"
    proc = subprocess.run(
        [sys.executable, "-m", "orbslam3_tpu_torch.apps.edge_server", "--selftest",
         "--device", "cpu", "--duration", "4", "--port", "0", "--acoustic-port", "0",
         "--features", "300", "--out-dir", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=240,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "selftest: 2 fake phones connected" in proc.stdout
    assert sorted(os.listdir(out)) == ["traj_client0.txt", "traj_client1.txt"]
    lines = (out / "traj_client0.txt").read_text().splitlines()
    assert lines and all(len(ln.split()) == 8 for ln in lines)
