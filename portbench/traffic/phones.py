"""Traffic kind "phones": phones streaming keypoints, descriptors and IMU
over TCP to the port's `EdgeServer`, whose `track_fn` is the server
`Slam`'s `track_edge`, as the ORB-SLAM3 fork's mono_inertial_edge
deployment runs.

Each phone is a closed loop with one packet in flight: it sends its next
frame when the pose reply to the previous one arrives, at the feature
budget the server last sent it (1000 until told otherwise). The packets'
features come from a landmark field seen along the path
(`harness.landmarks`), made on the card in set-up with the IMU
(`harness.motion`), and go out through the benchmark's own SlamPktVI
encoder (`harness.wire`).

Phone 0 streams the path from its start. It alone warms the server up
until the map's IMU ladder reaches the workload's `iba_stage` and its
last scale refinement is past (the configuration's
`scale_refine_until_s` after the IMU initialization); then phone 1 joins
and, alone, revisits the mapped area (the same path from frame
`join_frame` on, on its own clock `clock_offset_s` later) until it has
relocalized and then been tracked `phone1_steady_frames` times under the
server's rule below (its first frames under the rule, which follow the
switch from tracking every frame, stay out of the window). Then both stream, taking strict turns at the server's edge
lock, and the window opens.

Both phones number their frames one by one, as the fork's phone does.
The server tracks one frame in `secondary_track_every` of a secondary
client's (ids that are multiples of it) while that client is not
(re)initializing, and answers only the frames it tracks. A phone knows
the rule: it learns from the budget the server sends (`budget_tracking`
means tracking, another budget (re)initializing) whether its next frame
will be tracked, waits for the reply only then, and sends the skipped
frames without waiting. Only frames due a reply count as handed in.
"""

from __future__ import annotations

import math
import socket
import threading
import time

import numpy as np
import torch

from harness import landmarks, motion as motion_mod, port, reference, wire

REPLY_WAIT_S = 120.0   # a reply later than this fails the run


class Phone:
    """One phone: its frames (indices into the path), ids and clock."""

    def __init__(self, pid: int, port_no: int, frames: np.ndarray, ids: np.ndarray,
                 offset_s: float, cell: "Cell"):
        self.pid, self.frames, self.ids, self.offset = pid, frames, ids, offset_s
        self.cell = cell
        self.sock = socket.create_connection(("127.0.0.1", port_no), timeout=10.0)
        self.sock.settimeout(0.2)
        self.budget = cell.p["budget_init"]
        self.server_init = False       # the server's lane (re)initializing, as last told
        self.k = 0                     # next frame to send
        self.sent: list = []           # (k, t_send, t_reply | None, centre | None, due)
        self.due: list[int] = []       # indices into `sent` of the frames due a reply
        self._cv = threading.Condition()
        self._replies = 0
        self._alive = True
        self._dec = wire.StreamDecoder()
        self.thread: threading.Thread | None = None
        self.error: BaseException | None = None
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        while self._alive:
            try:
                data = self.sock.recv(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            if not data:
                break
            for payload in self._dec.feed(data):
                code, val = wire.decode_cmd(payload)
                t = time.perf_counter()
                with self._cv:
                    if code == wire.CMD_FEATURE_COUNT:
                        self.budget = val
                        self.server_init = val != self.cell.p["budget_tracking"]
                    elif self._replies >= len(self.due):
                        self.error = RuntimeError(f"phone {self.pid}: a reply to a frame "
                                                  "the server's rule skips")
                    else:
                        i = self.due[self._replies]
                        k, t_send, _, _, due = self.sent[i]
                        self.sent[i] = (k, t_send, t, val[1], due)
                        self._replies += 1
                    self._cv.notify_all()

    def due_next(self) -> bool:
        """Whether the server will track (and answer) the next frame."""
        every = self.cell.p["secondary_track_every"]
        return self.pid == 0 or self.server_init or int(self.ids[self.k]) % every == 0

    def send_next(self) -> bool:
        """Send the next frame; returns whether it is due a reply."""
        c = self.cell
        k = self.k
        if k >= len(self.frames):
            raise RuntimeError(f"phone {self.pid}: the traffic ran out after {k} frames")
        f = int(self.frames[k])
        uv, desc = landmarks.packet_arrays(c.uv[self.pid], c.desc[self.pid], c.count[self.pid],
                                           k, self.budget, c.p["distractors"])
        ts_ns, gyro, acc = c.imu_packet(f, self.offset)
        payload = wire.encode_frame(int(self.ids[k]), round((c.motion.frame_ts[f] + self.offset)
                                                            * 1e9), uv, desc, ts_ns, gyro, acc)
        with self._cv:
            due = self.due_next()
            if due:
                self.due.append(len(self.sent))
            self.sent.append((k, time.perf_counter(), None, None, due))
        self.sock.sendall(wire.frame_packet(payload))
        self.k += 1
        return due

    def wait_reply(self):
        with self._cv:
            n = len(self.due)
            if not self._cv.wait_for(lambda: self._replies >= n or self.error, REPLY_WAIT_S):
                raise RuntimeError(f"phone {self.pid}: no reply within {REPLY_WAIT_S} s")
            if self.error is not None:
                raise self.error

    def loop(self, stop: threading.Event):
        try:
            while not stop.is_set():
                if self.send_next():
                    self.wait_reply()
        except BaseException as e:  # noqa: BLE001  (the main thread reads and raises it)
            self.error = e

    def start(self, stop: threading.Event):
        self.thread = threading.Thread(target=self.loop, args=(stop,), daemon=True)
        self.thread.start()

    def close(self):
        self._alive = False
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()
        self._reader.join(5.0)
        if self.thread is not None:
            self.thread.join(REPLY_WAIT_S)


class Cell:
    kernels = ("k1",)

    def __init__(self, config: dict, workload: dict, seed: int, seconds: float, device,
                 spans, log):
        self.cfg, self.wl, self.seed, self.dev = config, workload, seed, device
        self.spans, self.log = spans, log
        self.p = workload["traffic"]
        self.per_phone = self.p["warmup"]["max_frames"] + math.ceil(self.p["fps"] * seconds) + 1

    # ---------------------------------------------------------------- set-up
    def setup(self):
        p, cam = self.p, self.cfg["camera"]
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(self.seed % (1 << 63))
        n = p["join_frame"] + self.per_phone
        self.motion = motion_mod.make_motion(
            n, self.seed, p["fps"], self.cfg["imu"]["rate_hz"], p["orbit_center"],
            p["radius_m"], p["arc_rad"], p["rate_rad_s"], p["excitation_m"],
            p["rot_excitation_rad"], p["turn_s"], self.cfg["imu"].get("T_b_c1"))
        self.field = landmarks.make_field(p["landmarks"], self.seed + 11)
        mo = self.motion
        self.path = [np.arange(self.per_phone), p["join_frame"] + np.arange(self.per_phone)]
        self.uv, self.desc, self.count = [], [], []
        for frames in self.path:
            uv, desc, count = landmarks.frame_features(
                self.field, mo.R_cw[frames], mo.t_cw[frames], cam["intrinsics"], cam["width"],
                cam["height"], p["budget_init"], p["noise_px"], p["bit_flips"], p["dropout"],
                p["distractors"], gen, self.dev, dist=cam.get("dist", ()))
            self.uv.append(uv)
            self.desc.append(desc)
            self.count.append(count)
        self.batches = motion_mod.imu_batches(mo.frame_ts, mo.imu_ts, mo.gyro, mo.acc)
        self.slam = port.build_slam(self.cfg, self.dev)
        self.calls: list = []       # (client, frame id, t0, t1, pose or None, ts)
        inner, track_features = self.slam.track_edge, self.slam.track_features

        self.turns = {0: 0, 1: 0}   # turns each lane has taken at the edge lock

        def locked(feats, ts, client_id=0, imu=None):
            # inside `track_edge`'s turn at the server's edge lock
            self.turns[client_id] += 1
            with self.spans.span("edge_tracking", client=client_id):
                out = track_features(feats, ts, client_id=client_id, imu=imu)
                if self.dev.type == "cuda":
                    torch.cuda.synchronize(self.dev)
            return out

        def track_fn(client_id, pkt):
            with self.spans.span("track_edge", client=client_id, frame=int(pkt.frame_id)) as s:
                out = inner(client_id, pkt)
                s["ok"] = out is not None
            self.calls.append((client_id, int(pkt.frame_id), s["t0"], s["t1"], out,
                               round(pkt.timestamp_ns * 1e-9, 6)))
            return out

        self.slam.track_features = locked

        self.server = port.edge_server(track_fn, self.cfg["max_clients"])
        self.phones: list[Phone] = []
        ids = np.arange(self.per_phone)
        self.phones.append(self._connect(0, self.path[0], ids, 0.0))
        ph0 = self.phones[0]
        w = p["warmup"]
        ladder = port.LadderWatch(self.slam)
        until = self.cfg["mapper"]["scale_refine_until_s"]
        while True:
            ph0.send_next()
            ph0.wait_reply()
            ts = float(mo.frame_ts[ph0.frames[ph0.k - 1]])
            if ladder.done(ts, w["iba_stage"], until) and self.calls[-1][4] is not None:
                break
            if ph0.k >= w["max_frames"]:
                raise RuntimeError(f"warm-up: iba_stage {self.slam.atlas.active.iba_stage} "
                                   f"after {ph0.k} packets, {w['iba_stage']} and {until} s "
                                   "past the IMU init needed")
        ph1 = self._connect(1, self.path[1], ids, p["clock_offset_s"])
        self.phones.append(ph1)
        steady = 0      # phone 1 alone until it has relocalized and been
        while steady < w["phone1_steady_frames"]:   # tracked under the 1-in-k rule
            init = ph1.server_init
            if ph1.send_next():
                ph1.wait_reply()
                ok = self.calls[-1][4] is not None
                steady = steady + 1 if ok and not init and ph1.k > 1 else 0
                if not ok and ph1.k >= w["max_frames"]:
                    raise RuntimeError("warm-up: phone 1 did not relocalize")
            if ph1.k >= 2 * w["max_frames"]:
                raise RuntimeError("warm-up: phone 1 was not tracked under the rule")
        self._start_phones()
        self.log(f"warm-up: phone 0 {ph0.k} packets, phone 1 {ph1.k}, "
                 f"iba_stage {self.slam.atlas.active.iba_stage}")

    def _start_phones(self):
        """Both phones on their threads, phone 1 first: phone 0's packet
        waits at the edge lock while phone 1's is tracked, so the two take
        strict turns and every run of a seed tracks the same packets in the
        same order."""
        self.stop = threading.Event()
        turns = self.turns[1]
        self.phones[1].start(self.stop)
        deadline = time.perf_counter() + REPLY_WAIT_S
        while self.turns[1] == turns:
            self._raise_errors()
            if time.perf_counter() > deadline:
                raise RuntimeError("phone 1's packet was not taken")
            time.sleep(0.001)
        self.phones[0].start(self.stop)

    def _connect(self, pid, frames, ids, offset) -> Phone:
        ph = Phone(pid, self.server.slam_port, frames, ids, offset, self)
        deadline = time.perf_counter() + 30.0
        while len(self.server.lanes) <= pid:
            if time.perf_counter() > deadline:
                raise RuntimeError(f"phone {pid}: the server made no lane")
            time.sleep(0.005)
        return ph

    def imu_packet(self, f: int, offset: float):
        batch = self.batches[f]
        ts = np.asarray([round((s[0] + offset) * 1e9) for s in batch], np.int64)
        gyro = np.asarray([s[1] for s in batch], np.float32).reshape(-1, 3)
        acc = np.asarray([s[2] for s in batch], np.float32).reshape(-1, 3)
        return ts, gyro, acc

    def _raise_errors(self):
        for ph in self.phones:
            if ph.error is not None:
                raise RuntimeError(f"phone {ph.pid}: {ph.error!r}")
        for lane in self.server.lanes:
            if lane.errors:
                raise RuntimeError(f"lane {lane.id}: {lane.errors[0]!r}")

    # ---------------------------------------------------------------- window
    def window(self, seconds: float, tick=lambda elapsed: None) -> dict:
        """Both phones for `seconds`, then until every packet sent in the
        window is answered; `tick(elapsed)` runs every 10 ms."""
        if self.stop.is_set():   # a window before this one stopped the phones
            self._start_phones()
        self.kf0 = port.keyframes_made(self.slam)
        starts = [len(ph.sent) for ph in self.phones]
        t0 = time.perf_counter()
        while (elapsed := time.perf_counter() - t0) < seconds:
            tick(elapsed)
            self._raise_errors()
            time.sleep(0.01)
        self.stop.set()
        for ph in self.phones:
            ph.thread.join(REPLY_WAIT_S)
        self._raise_errors()
        self.kf1 = port.keyframes_made(self.slam)
        self.map = port.map_arrays(self.slam)
        # the window's packets due a reply: sent after t0 (and before its
        # end, as the phones stop sending then), each answered
        self.replies, self.skipped = [], 0
        for ph, s0 in zip(self.phones, starts):
            for k, t_send, t_reply, centre, due in ph.sent[s0:]:
                if t_send >= t0 and due:
                    self.replies.append((ph.pid, k, t_send, t_reply, centre))
                elif t_send >= t0:
                    self.skipped += 1
        t1 = max((r[3] for r in self.replies), default=time.perf_counter())
        ids = {(pid, int(self.phones[pid].ids[k])) for pid, k, _, _, _ in self.replies}
        self.window_calls = [c for c in self.calls if (c[0], c[1]) in ids]
        poses = sum(c[4] is not None for c in self.window_calls)
        self.log(f"window: {self.skipped} packets skipped by the server's 1-in-"
                 f"{self.p['secondary_track_every']} rule, of "
                 f"{self.skipped + len(self.replies)} sent")
        return dict(t0=t0, t1=t1, attempted=len(self.replies),
                    failed=len(self.replies) - poses, poses=poses,
                    keyframes=self.kf1 - self.kf0)

    def release(self):
        for ph in self.phones:
            ph.close()
        self.server.close()
        self.slam.shutdown()
        del self.slam

    # ----------------------------------------------------------- reference
    def judge(self) -> dict:
        mo = self.motion
        truth = {}
        for pid, ph in enumerate(self.phones):
            for f in ph.frames:
                truth[round(float(mo.frame_ts[f]) + ph.offset, 6)] = int(f)
        got = [c for c in self.window_calls if c[4] is not None]
        per_client = [sum(c[0] == ph.pid for c in got) for ph in self.phones]
        # the phones take strict turns at the lock: each client's share of
        # the poses is equal, to the one turn a window's edges can cut
        out = {"poses_unshared": max(per_client) - min(per_client)}
        if len(got) >= 3:
            f = np.asarray([truth[c[5]] for c in got])
            R = np.stack([np.asarray(c[4][0]) for c in got])
            t = np.stack([np.asarray(c[4][1]) for c in got])
            client = np.asarray([c[0] for c in got])
            both = reference.trajectory_numbers(R, t, client, mo.R_cw[f], mo.t_cw[f])
            out.update(ate_m=both["ate_m"], repeated_poses=both["repeated_poses"])
            # the steps of each client: phone 0's, every frame tracked, are
            # compared; phone 1's, one frame in five under the rule, whose
            # tracked packet carries the IMU of its own frame only, are read
            for pid in np.unique(client):
                i = client == pid
                if i.sum() >= 2:
                    one = reference.trajectory_numbers(R[i], t[i], client[i], mo.R_cw[f[i]],
                                                       mo.t_cw[f[i]])
                    pre = "" if pid == 0 else f"c{pid}_"
                    out[pre + "rpe_p90_m"] = one["rpe_p90_m"]
                    out[pre + "rpe_rot_p90_deg"] = one["rpe_rot_p90_deg"]
        m = self.map
        f = np.asarray([truth.get(round(float(ts), 6), -1) for ts in m["kf_ts"]])
        if len(f) >= 3 and m["imu_initialized"] and (f >= 0).all():
            out.update(reference.map_numbers(
                m["kf_R"], m["kf_t"], m["kf_v"], mo.R_cw[f], mo.t_cw[f], mo.v_w[f], m["pts"],
                reference.nearest_dist(self.field.points)))
        return out
