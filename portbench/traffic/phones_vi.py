"""Traffic kind "phones_vi": the "phones" traffic (`phones.py`, imported,
not copied), with phone 1's inertial preintegration held to the plain
reference (`harness/edge_lane_reference.py`).

The configuration promises metric, gravity-aligned poses for every client
of the shared map. Phone 1 is tracked one frame in five, so each of its
tracked frames spans five frame intervals of IMU, and only if the server
hands the samples of the skipped packets on does its preintegration
span them. Set-up first probes the port's edge lane with a throwaway
`EdgeServer` and a stub `track_fn`: a secondary phone sends a packet the
1-in-k rule skips, then one it tracks. A lane that gives the tracked packet
only its own samples cannot keep the promise, and the run stops there,
before the warm-up, with a non-zero exit.

Then the "phones" set-up runs, and every tracker of client 1, the current
one and any the system makes later, records each frame's preintegration:
the previous frame's timestamp, its own, and the deltas at their bias,
kept on the device until the judgement. `judge()` adds `c1_preint_err`:
over phone 1's packets tracked in the window, the worst relative error
of the tracker's dR, dV, dP and dT against the reference's, computed in
float64 over every sample phone 1 sent in (previous tracked frame, frame].

The phones keep the strict turns at the server's edge lock by their own
order, not by the timing of the host's threads: a phone sends a packet the
server will track only once the other phone's last such packet has taken
its turn at the lock (and the first after set-up is phone 1's). Each phone
still has its one packet in flight, which waits at the lock while the
other's is tracked, and phone 1 still sends its skipped packets without
waiting. Without the order, phone 0 took turns in a row where the host was
slow to wake phone 1's lane at the lock (a loaded CPU), and as phone 0's
poses make fewer keyframes, the window's mix of poses, and so its rate,
followed the host's load.
"""

from __future__ import annotations

import importlib.util
import socket
import threading
import time
from pathlib import Path

import numpy as np

from harness import edge_lane_reference, port, wire


def _load_phones():
    spec = importlib.util.spec_from_file_location("portbench_traffic_phones",
                                                  Path(__file__).with_name("phones.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


phones = _load_phones()
PROBE_WAIT_S = 30.0
TURN_POLL_S = 0.1   # how often a phone waiting for its turn looks at the window's stop


def probe_lane(every: int) -> int:
    """How many IMU samples the port's lane hands a secondary client's
    tracked packet after one skipped packet, each packet with 2 samples:
    4 where the skipped packet's samples are carried, 2 where dropped."""
    got = []

    def stub(client_id, pkt):
        got.append((client_id, int(pkt.frame_id), len(pkt.imu_ts_ns)))
        return np.eye(3, dtype=np.float32), np.zeros(3, np.float32)

    server = port.edge_server(stub, 2)
    socks = []
    try:
        deadline = time.monotonic() + PROBE_WAIT_S
        for pid in (0, 1):
            socks.append(socket.create_connection(("127.0.0.1", server.slam_port),
                                                  timeout=PROBE_WAIT_S))
            while len(server.lanes) <= pid:
                if time.monotonic() > deadline:
                    raise RuntimeError("probe: the server made no lane")
                time.sleep(0.005)
        for fid in (every - 1, every):   # skipped, then tracked
            ts = fid * 50_000_000
            imu_ns = np.array([ts - 5_000_000, ts], np.int64)
            payload = wire.encode_frame(fid, ts, np.zeros((1, 2), np.float32),
                                        np.zeros((1, 32), np.uint8), imu_ns,
                                        np.zeros((2, 3), np.float32), np.zeros((2, 3), np.float32))
            socks[1].sendall(wire.frame_packet(payload))
        while not got:
            if time.monotonic() > deadline:
                raise RuntimeError("probe: the tracked packet did not reach track_fn")
            time.sleep(0.005)
    finally:
        for s in socks:
            s.close()
        server.close()
    if got[0][:2] != (1, every):
        raise RuntimeError(f"probe: track_fn saw {got[0][:2]}, not (1, {every})")
    return got[0][2]


class Phone(phones.Phone):
    """A phone that sends each packet due a reply only in its turn
    (`Cell.take_turn`)."""

    def loop(self, stop: threading.Event):
        try:
            while not stop.is_set():
                if self.due_next() and not self.cell.take_turn(self.pid, stop):
                    break
                if self.send_next():
                    self.wait_reply()
        except BaseException as e:  # noqa: BLE001  (the main thread reads and raises it)
            self.error = e


class Cell(phones.Cell):

    def setup(self):
        carried = probe_lane(self.p["secondary_track_every"])
        if carried != 4:
            raise SystemExit(
                f"portbench: the port's edge lane handed a tracked packet {carried} IMU samples "
                "of 4 (2 of its own, 2 of the packet before it, which the 1-in-k rule skipped): "
                "it drops the IMU of skipped packets, so a secondary phone's preintegration "
                "misses most of its step and its poses cannot be metric, as this deployment "
                "promises")
        self.preints: list = []   # client 1's frames: (previous ts, ts, Preintegrated)
        super().setup()
        make = self.slam._make_tracker
        self.slam._make_tracker = lambda client_id: self._watch(make(client_id))
        for tracker in self.slam.trackers.values():
            self._watch(tracker)

    def _connect(self, pid, frames, ids, offset) -> Phone:
        ph = Phone(pid, self.server.slam_port, frames, ids, offset, self)
        deadline = time.perf_counter() + 30.0
        while len(self.server.lanes) <= pid:
            if time.perf_counter() > deadline:
                raise RuntimeError(f"phone {pid}: the server made no lane")
            time.sleep(0.005)
        return ph

    def _start_phones(self):
        """The phones on their threads, their turns counted from here:
        phone 1 first, then each phone's packets due a reply in turn."""
        if not hasattr(self, "_turn_cv"):
            self._turn_cv = threading.Condition()
            inner = self.slam.track_features

            def track_features(feats, ts, client_id=0, imu=None):
                # inside `track_edge`'s turn at the server's edge lock
                with self._turn_cv:
                    self._taken[client_id] += 1
                    self._turn_cv.notify_all()
                return inner(feats, ts, client_id=client_id, imu=imu)

            self.slam.track_features = track_features
        with self._turn_cv:
            # every packet sent before is answered: the warm-up waits for
            # each reply, a window for its phones' last ones
            self._sent, self._taken, self._next = [0, 0], [0, 0], 1
        super()._start_phones()

    def take_turn(self, pid: int, stop: threading.Event) -> bool:
        """Wait until phone `pid` may send its next packet due a reply: its
        turn is next and the other phone's last such packet has taken its
        turn at the lock. False once `stop` is set."""
        other = 1 - pid
        deadline = time.monotonic() + phones.REPLY_WAIT_S
        with self._turn_cv:
            while not (self._next == pid and self._taken[other] >= self._sent[other]):
                if stop.is_set():
                    return False
                if time.monotonic() > deadline:
                    raise RuntimeError(f"phone {pid}: phone {other}'s packet did not take "
                                       f"its turn within {phones.REPLY_WAIT_S} s")
                self._turn_cv.wait(TURN_POLL_S)
            if stop.is_set():
                return False
            self._sent[pid] += 1
            self._next = other
            return True

    def _watch(self, tracker):
        """Record client 1's tracker's preintegration, frame by frame."""
        if tracker.client_id != 1:
            return tracker
        inner = tracker._preintegrate_to

        def preintegrate_to(ts):
            t0 = tracker._last_ts
            pre = inner(ts)
            if pre is not None:
                self.preints.append((t0, ts, pre))
            return pre

        tracker._preintegrate_to = preintegrate_to
        return tracker

    def preint_err(self, dtype=None) -> float | None:
        """The worst relative error, over phone 1's packets tracked in the
        window, of the tracker's deltas against the reference's in
        float64; with `dtype`, of the reference computed in `dtype` instead
        of the tracker's (the reading of a lower precision). None where no
        such packet was preintegrated."""
        ph = self.phones[1]
        sent = [self.imu_packet(int(f), ph.offset) for f in ph.frames[:ph.k]]
        ts_ns = np.concatenate([s[0] for s in sent])
        gyro = np.concatenate([s[1] for s in sent])
        acc = np.concatenate([s[2] for s in sent])
        due = {c[5] for c in self.window_calls if c[0] == 1}
        worst = None
        for t0, t1, pre in self.preints:
            if round(t1, 6) not in due:
                continue
            span = (round(t0 * 1e9), round(t1 * 1e9))
            bias = pre.bias.double().cpu().numpy()
            want = edge_lane_reference.preintegrate(ts_ns, gyro, acc, *span, bias)
            if dtype is None:
                got = dict(dR=pre.dR.cpu().numpy(), dV=pre.dV.cpu().numpy(),
                           dP=pre.dP.cpu().numpy(), dT=float(pre.dT))
            else:
                got = edge_lane_reference.preintegrate(ts_ns, gyro, acc, *span, bias, dtype=dtype)
            err = edge_lane_reference.relative_error(got, want)
            worst = err if worst is None else max(worst, err)
        return worst

    def judge(self) -> dict:
        out = super().judge()
        err = self.preint_err()
        if err is not None:
            out["c1_preint_err"] = err
        return out

