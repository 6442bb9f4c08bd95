"""Edge SLAM server: TCP ingestion feeding one tracking lane per phone.

Port of `orbslam3_tpu/edge/server.py` (the ORB-SLAM3 fork's threaded
socket server): one listener for the SLAM feature stream (8080 by
default) and one for the acoustic side channel (8848). Each accepted
phone gets a `ClientLane` with a receive thread (length-prefixed
SlamPktVI reassembly -> frame queue) and a track thread (dequeue ->
``track_fn`` -> adaptive feature budget -> pose + delay reply).

The rules are the fork's: 1000 features while initializing or lost and 500
while tracking (a CmdPkt when the state flips); a secondary client tracks
one frame in `K_TRACK` = 5 while its ``init_flag`` is False (its first
frames too); the acoustic handshake ``"<id>,<max_clients>\\n"``, then
``peer interval`` reports queued per peer; `cal_acoustic` converts
pending interval pairs to distances gated to 0-4 m.

The compute is not here: ``track_fn(client_id, FramePacket) -> (R_cw,
t_cw) | None`` comes from the system (`Slam.track_edge`). Every socket has
a timeout and every loop re-checks its lane's liveness, so `close()`
ends all threads within a bounded time.
"""

from __future__ import annotations

import queue
import socket
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from orbslam3_tpu_torch.edge import wire
from orbslam3_tpu_torch.edge.acoustic import K_DISTANCE, MAX_RANGE_M, SAMPLE_RATE, SPEED_OF_SOUND
from orbslam3_tpu_torch.utils import verbose as _verbose

# the fork's budgets: 1000 features when initializing / lost, 500 when OK;
# secondary clients track 1 frame in 5 while not (re)initializing
N_FEATURES_INIT = 1000
N_FEATURES_TRACKING = 500
K_TRACK = 5
POLL_S = 0.2  # socket timeout and queue wait: how often a loop re-checks liveness


@dataclass
class LaneStats:
    frames_received: int = 0
    frames_tracked: int = 0
    recv_times: list = field(default_factory=list)
    send_times: list = field(default_factory=list)


class ClientLane:
    """The server's side of one phone (the fork's `Client`)."""

    def __init__(self, client_id: int, conn: socket.socket, server: "EdgeServer"):
        self.id = client_id
        self.conn = conn
        self.conn.settimeout(POLL_S)
        self.server = server
        self.frame_q: "queue.Queue[wire.FramePacket]" = queue.Queue(maxsize=64)
        self.ac_conn: socket.socket | None = None
        # per-peer FIFO of reported chirp intervals
        self.intervals: dict[int, queue.Queue] = {}
        self.trajectory: list = []   # (ts, R_cw, t_cw, ttrack)
        self.stats = LaneStats()
        self.init_flag = False       # True while lost / initializing
        self.errors: list[BaseException] = []  # raised by track_fn; the lane stops
        self._alive = True
        self._closed = False
        self._lock = threading.Lock()
        self._serving = (threading.Thread(target=self._receive_loop, daemon=True),
                         threading.Thread(target=self._track_loop, daemon=True))
        self._threads = list(self._serving)  # with the acoustic thread, once attached

    def start(self):
        """Start the receive and track threads. The owner calls it once the
        lane is published in `EdgeServer.lanes`, so no frame is tracked, or
        answered, by a lane the server cannot see (its acoustic connection
        may be attached, and served, first)."""
        for t in self._serving:
            t.start()

    # ------------------------------------------------------------ threads
    def _receive_loop(self):
        dec = wire.StreamDecoder()
        try:
            while self._alive:
                try:
                    data = self.conn.recv(4096)
                except socket.timeout:
                    continue
                if not data:
                    break
                for payload in dec.feed(data):
                    pkt = wire.decode_frame(payload)
                    if pkt is None:  # malformed: drop the packet, keep the lane
                        _verbose.normal(f"client {self.id}: dropping malformed packet "
                                        f"({len(payload)} bytes)")
                        continue
                    self.stats.frames_received += 1
                    self.stats.recv_times.append(time.monotonic())
                    try:
                        self.frame_q.put(pkt, timeout=1.0)
                    except queue.Full:
                        pass  # dropped under backpressure
        except OSError:
            pass
        finally:
            self._alive = False

    def _track_loop(self):
        # after the phone hangs up the queued frames are still tracked;
        # after close() they are dropped
        while not self._closed and (self._alive or not self.frame_q.empty()):
            try:
                pkt = self.frame_q.get(timeout=POLL_S)
            except queue.Empty:
                continue
            # secondary clients not (re)initializing track 1 frame in k
            if self.id != 0 and not self.init_flag and \
                    pkt.frame_id % K_TRACK != 0:
                continue
            t0 = time.monotonic()
            try:
                result = self.server.track_fn(self.id, pkt)
            except Exception as e:  # noqa: BLE001  (kept for the owner; the lane stops)
                self.errors.append(e)
                self._alive = False
                break
            ttrack = time.monotonic() - t0
            self.stats.frames_tracked += 1
            ok = result is not None
            if ok:
                R_cw, t_cw = result
                with self._lock:
                    self.trajectory.append((pkt.timestamp_ns * 1e-9, np.asarray(R_cw),
                                            np.asarray(t_cw), ttrack))
            # adaptive feature budget
            if not self.init_flag and not ok:
                self._send(wire.encode_cmd_feature_count(N_FEATURES_INIT))
                self.init_flag = True
            elif self.init_flag and ok:
                self._send(wire.encode_cmd_feature_count(N_FEATURES_TRACKING))
                self.init_flag = False
            # the pose and the processing delay back to the phone
            twc = (-np.asarray(R_cw).T @ np.asarray(t_cw)) if ok else np.zeros(3, np.float32)
            recvs = self.stats.recv_times
            self.stats.send_times.append(time.monotonic())
            delay = self.stats.send_times[-1] - \
                recvs[min(len(self.stats.send_times), len(recvs)) - 1]
            self._send(wire.encode_cmd_pose_delay(delay, twc))

    def _send(self, payload: bytes):
        try:
            self.conn.sendall(wire.frame_packet(payload))
        except OSError:
            self._alive = False

    # ----------------------------------------------------------- acoustic
    def attach_acoustic(self, conn: socket.socket):
        """Serve the lane's acoustic connection: published (`ac_conn`, and
        its thread in `_threads` for `close`) before its thread starts."""
        self.ac_conn = conn
        conn.settimeout(POLL_S)
        t = threading.Thread(target=self._acoustic_loop, daemon=True)
        self._threads.append(t)
        t.start()

    def _acoustic_loop(self):
        """Interval reports: whitespace-separated `peer_id interval` pairs,
        one message a line."""
        buf = b''
        try:
            self.ac_conn.sendall(f'{self.id},{self.server.max_clients}\n'.encode())
            while self._alive:
                try:
                    data = self.ac_conn.recv(1024)
                except socket.timeout:
                    continue
                if not data:
                    break
                buf += data
                while b'\n' in buf:
                    line, buf = buf.split(b'\n', 1)
                    toks = line.split()
                    for i in range(len(toks) // 2):
                        peer = int(float(toks[2 * i]))
                        n = int(float(toks[2 * i + 1]))
                        self.intervals.setdefault(peer, queue.Queue()).put(n)
        except OSError:
            pass

    def emit(self):
        if self.ac_conn is not None:
            try:
                self.ac_conn.sendall(b'emit\n')
            except OSError:
                pass

    def latest_position(self):
        """(timestamp, camera centre in the world) of the latest tracked
        frame, or (None, None)."""
        with self._lock:
            if not self.trajectory:
                return None, None
            ts, R_cw, t_cw, _ = self.trajectory[-1]
            return ts, (-R_cw.T @ t_cw)

    def last_entry(self):
        """(index, camera centre in the world) of the latest tracked frame,
        or (None, None)."""
        with self._lock:
            if not self.trajectory:
                return None, None
            _, R_cw, t_cw, _ = self.trajectory[-1]
            return len(self.trajectory) - 1, (-R_cw.T @ t_cw)

    def rewrite_traj(self, idx: int, t_wc: np.ndarray):
        """Overwrite a stored position after an acoustic correction (the
        fork's `Client::rewriteTraj`)."""
        with self._lock:
            ts, R_cw, _, tt = self.trajectory[idx]
            self.trajectory[idx] = (ts, R_cw, -R_cw @ np.asarray(t_wc), tt)

    def close(self, timeout: float = 5.0):
        self._alive = False
        self._closed = True
        for c in (self.conn, self.ac_conn):
            if c is not None:
                try:
                    c.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    c.close()
                except OSError:
                    pass
        deadline = time.monotonic() + timeout
        for t in self._threads:
            if t is not threading.current_thread() and t.ident is not None:  # started
                t.join(max(0.0, deadline - time.monotonic()))


class EdgeServer:
    """Accepts up to ``max_clients`` phones and spawns a `ClientLane` for
    each (the fork's `Server::Listening`)."""

    def __init__(self, track_fn, host: str = '127.0.0.1', slam_port: int = 8080,
                 acoustic_port: int = 8848, max_clients: int = 2):
        self.track_fn = track_fn
        self.max_clients = max_clients
        self.lanes: list[ClientLane] = []
        self._alive = True
        # distance-pair history for calibration (the fork's CalAcoustic)
        self.hist_pos1, self.hist_pos2, self.hist_dist = [], [], []

        self._sock = socket.create_server((host, slam_port))
        self._ac_sock = socket.create_server((host, acoustic_port))
        for s in (self._sock, self._ac_sock):
            s.settimeout(POLL_S)
        self.slam_port = self._sock.getsockname()[1]
        self.acoustic_port = self._ac_sock.getsockname()[1]
        self._threads = [threading.Thread(target=self._listen_slam, daemon=True),
                         threading.Thread(target=self._listen_acoustic, daemon=True)]
        for t in self._threads:
            t.start()

    def _listen_slam(self):
        while self._alive and len(self.lanes) < self.max_clients:
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            lane = ClientLane(len(self.lanes), conn, self)
            self.lanes.append(lane)  # published before it serves
            lane.start()

    def _listen_acoustic(self):
        n = 0
        while self._alive and n < self.max_clients:
            try:
                conn, _ = self._ac_sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            # the n-th acoustic connection belongs to the n-th lane
            while n >= len(self.lanes) and self._alive:
                time.sleep(0.003)
            if not self._alive:
                conn.close()
                break
            self.lanes[n].attach_acoustic(conn)
            n += 1

    # ----------------------------------------------------------- acoustic
    def broadcast_emit(self):
        for lane in self.lanes:
            lane.emit()

    def cal_acoustic(self) -> list[float]:
        """Pending interval pairs -> metric distances d = c·(n1+n2)/(2·fs) + k,
        gated to (0, 4) m. Returns client 0's distances; the other pairs go
        to the calibration history."""
        out = []
        for i, li in enumerate(self.lanes):
            _, pos1 = li.latest_position()
            for j in range(i + 1, len(self.lanes)):
                lj = self.lanes[j]
                qi, qj = li.intervals.get(j), lj.intervals.get(i)
                if qi is None or qj is None or qi.empty() or qj.empty():
                    continue
                n1, n2 = qi.get(), qj.get()
                d = SPEED_OF_SOUND * (n1 + n2) / (2 * SAMPLE_RATE) + K_DISTANCE
                if not (0.0 < d < MAX_RANGE_M):
                    continue
                if i == 0:
                    out.append(d)
                else:
                    _, pos2 = lj.latest_position()
                    if pos1 is not None and pos2 is not None:
                        self.hist_pos1.append(pos1)
                        self.hist_pos2.append(pos2)
                        self.hist_dist.append(d)
        return out

    def close(self, timeout: float = 5.0):
        self._alive = False
        for s in (self._sock, self._ac_sock):
            try:
                s.close()
            except OSError:
                pass
        for lane in self.lanes:
            lane.close(timeout)
        for t in self._threads:
            t.join(timeout)
