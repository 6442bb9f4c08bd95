"""Fake-phone replayer: drives the edge server without real devices.

Port of `orbslam3_tpu/edge/client_sim.py`. A `FakePhone` serializes
features and IMU samples into SlamPktVI packets, streams them over TCP,
consumes the CmdPkt replies (the adaptive feature budget, the pose and
delay) and answers the acoustic "emit" command with chirp intervals made
from true distances (the inverse of the server's distance model).

Beyond the JAX package's phone it keeps the arrival time of each pose
reply and offers `wait_replies`, so a caller can pace packets in
lockstep. Every socket has a timeout and every wait a deadline.
"""

from __future__ import annotations

import socket
import threading
import time

import numpy as np

from orbslam3_tpu_torch.edge import wire
from orbslam3_tpu_torch.edge.acoustic import K_DISTANCE, SAMPLE_RATE, SPEED_OF_SOUND

POLL_S = 0.2  # socket timeout: how often a loop re-checks liveness


class FakePhone:
    """One simulated phone."""

    def __init__(self, host: str, slam_port: int, acoustic_port: int = None,
                 client_id: int = 0, connect_timeout: float = 10.0):
        self.id = client_id
        self.sock = socket.create_connection((host, slam_port), timeout=connect_timeout)
        self.sock.settimeout(POLL_S)
        self.ac_sock = None
        if acoustic_port is not None:
            self.ac_sock = socket.create_connection((host, acoustic_port),
                                                    timeout=connect_timeout)
            self.ac_sock.settimeout(POLL_S)
        self.feature_budget = wire.MAX_PACKET  # updated by CMD 0 replies
        self.budgets: list[int] = []           # every CMD 0 received, in order
        self.poses: list[tuple[float, np.ndarray]] = []  # (delay, t_wc)
        self.reply_times: list[float] = []     # time.monotonic() of each pose reply
        self.max_clients = 1
        self._alive = True
        self._dec = wire.StreamDecoder()
        self._reply_cv = threading.Condition()
        self._emit_count = 0
        self._emit_cv = threading.Condition()
        self._threads = [threading.Thread(target=self._reply_loop, daemon=True)]
        if self.ac_sock is not None:
            self._threads.append(threading.Thread(target=self._acoustic_loop, daemon=True))
        for t in self._threads:
            t.start()

    def send_frame(self, frame_id: int, timestamp_ns: int, uv: np.ndarray,
                   desc: np.ndarray, imu_ts_ns=None, imu_gyro=None, imu_acc=None):
        payload = wire.encode_frame(frame_id, timestamp_ns, uv, desc, imu_ts_ns, imu_gyro,
                                    imu_acc)
        self.sock.sendall(wire.frame_packet(payload))

    def _reply_loop(self):
        try:
            while self._alive:
                try:
                    data = self.sock.recv(4096)
                except socket.timeout:
                    continue
                if not data:
                    break
                for payload in self._dec.feed(data):
                    code, val = wire.decode_cmd(payload)
                    with self._reply_cv:
                        if code == wire.CMD_FEATURE_COUNT:
                            self.feature_budget = val
                            self.budgets.append(val)
                        else:
                            self.poses.append(val)
                            self.reply_times.append(time.monotonic())
                        self._reply_cv.notify_all()
        except OSError:
            pass

    def wait_replies(self, n: int, timeout: float) -> bool:
        """Wait until `n` pose replies have arrived in all."""
        with self._reply_cv:
            return self._reply_cv.wait_for(lambda: len(self.poses) >= n, timeout)

    # ----------------------------------------------------------- acoustic
    def _acoustic_loop(self):
        buf = b''
        try:
            while self._alive:
                try:
                    data = self.ac_sock.recv(1024)
                except socket.timeout:
                    continue
                if not data:
                    break
                buf += data
                while b'\n' in buf:
                    line, buf = buf.split(b'\n', 1)
                    if line == b'emit':
                        with self._emit_cv:
                            self._emit_count += 1
                            self._emit_cv.notify_all()
                    elif b',' in line:  # handshake "<id>,<max_clients>"
                        _, mc = line.split(b',')
                        self.max_clients = int(mc)
        except OSError:
            pass

    @property
    def emit_count(self) -> int:
        with self._emit_cv:
            return self._emit_count

    def wait_emit(self, since: int = 0, timeout: float = 5.0) -> bool:
        """Wait until more than `since` emit commands have been received."""
        with self._emit_cv:
            return self._emit_cv.wait_for(lambda: self._emit_count > since, timeout)

    def report_intervals(self, intervals: dict[int, int]):
        """Send a `peer_id n` interval report line."""
        msg = ' '.join(f'{p} {n}' for p, n in intervals.items()) + '\n'
        self.ac_sock.sendall(msg.encode())

    @staticmethod
    def distance_to_interval(d_m: float) -> int:
        """Invert d = c·(n1+n2)/(2·fs) + k for symmetric halves: the half
        interval n such that two phones each reporting n give d."""
        return int(round((d_m - K_DISTANCE) * SAMPLE_RATE / SPEED_OF_SOUND))

    def close(self, timeout: float = 5.0):
        self._alive = False
        for s in (self.sock, self.ac_sock):
            if s is not None:
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    s.close()
                except OSError:
                    pass
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(max(0.0, deadline - time.monotonic()))
