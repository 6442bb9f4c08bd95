"""Traffic kind "replay": one camera replayed in closed loop into
`Slam.track_monocular`, as ORB-SLAM3's `mono_inertial_euroc` main feeds
EuRoC, minus its sleep: each frame, with the IMU samples since the last
one, is handed in when the previous pose returns.

The frames are rendered on the card in set-up (`harness.scene`) along an
excited orbit swept over its arc (`harness.motion`), enough for the
workload's `fps` over the whole window after the longest warm-up; a run
that runs out of frames fails. The warm-up runs until the map's IMU
ladder has reached the workload's `iba_stage` and its last scale
refinement is past (the configuration's `scale_refine_until_s` after the
IMU initialization), then `then_frames` more: the window holds steady
tracking and mapping, with no rung of the ladder in it however fast the
system runs.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from harness import motion as motion_mod
from harness import port, reference, scene


class Cell:
    kernels = ("k1", "k2")

    def __init__(self, config: dict, workload: dict, seed: int, seconds: float, device,
                 spans, log):
        self.cfg, self.wl, self.seed, self.dev = config, workload, seed, device
        self.spans, self.log = spans, log
        self.p = workload["traffic"]
        self.n_frames = self.p["warmup"]["max_frames"] + math.ceil(self.p["fps"] * seconds) + 1

    # ---------------------------------------------------------------- set-up
    def setup(self):
        p, cam = self.p, self.cfg["camera"]
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(self.seed % (1 << 63))
        self.motion = motion_mod.make_motion(
            self.n_frames, self.seed, p["fps"], self.cfg["imu"]["rate_hz"], p["orbit_center"],
            p["radius_m"], p["arc_rad"], p["rate_rad_s"], p["excitation_m"],
            p["rot_excitation_rad"], p["turn_s"], self.cfg["imu"].get("T_b_c1"))
        tex = torch.as_tensor(scene.box_textures(self.seed, p["texture_size"]), device=self.dev)
        R = torch.as_tensor(self.motion.R_cw, device=self.dev)
        t = torch.as_tensor(self.motion.t_cw, device=self.dev)
        chunk = p["render_chunk"]
        self.frames = torch.cat([
            scene.render(tex, cam["intrinsics"], R[s:s + chunk], t[s:s + chunk], cam["width"],
                         cam["height"], p["noise_std"], gen, cam.get("dist", ()))
            for s in range(0, self.n_frames, chunk)])
        self.batches = motion_mod.imu_batches(self.motion.frame_ts, self.motion.imu_ts,
                                              self.motion.gyro, self.motion.acc)
        self.slam = port.build_slam(self.cfg, self.dev)
        self.i = -1
        w = p["warmup"]
        ladder = port.LadderWatch(self.slam)
        until = self.cfg["mapper"]["scale_refine_until_s"]
        while True:
            ok = self._step(None) is not None
            ts = float(self.motion.frame_ts[self.i])
            if ladder.done(ts, w["iba_stage"], until) and ok:
                break
            if self.i + 1 >= w["max_frames"]:
                raise RuntimeError(f"warm-up: iba_stage {self.slam.atlas.active.iba_stage} "
                                   f"after {self.i + 1} frames, {w['iba_stage']} and {until} s "
                                   "past the IMU init needed")
        for _ in range(w["then_frames"]):
            self._step(None)
        self.warmup_frames = self.i + 1
        self.log(f"warm-up: {self.warmup_frames} frames, iba_stage "
                 f"{self.slam.atlas.active.iba_stage}")

    def _step(self, rec: list | None):
        self.i += 1
        i = self.i
        if i >= self.n_frames:
            raise RuntimeError(f"the traffic ran out after {i} frames")
        if rec is None:
            out = self.slam.track_monocular(self.frames[i], float(self.motion.frame_ts[i]),
                                            imu=self.batches[i])
            torch.cuda.synchronize(self.dev) if self.dev.type == "cuda" else None
            return out
        with self.spans.span("track_monocular", client=0, frame=i) as s:
            out = self.slam.track_monocular(self.frames[i], float(self.motion.frame_ts[i]),
                                            imu=self.batches[i])
            if self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)
            s["ok"] = out is not None
        rec.append((i, out))
        return out

    # ---------------------------------------------------------------- window
    def window(self, seconds: float, tick=lambda elapsed: None) -> dict:
        """Frames in closed loop for `seconds`; `tick(elapsed)` runs between
        frames."""
        self.kf0 = port.keyframes_made(self.slam)
        self.records: list = []
        t0 = time.perf_counter()
        while (elapsed := time.perf_counter() - t0) < seconds:
            tick(elapsed)
            self._step(self.records)
        t1 = time.perf_counter()
        self.kf1 = port.keyframes_made(self.slam)
        self.map = port.map_arrays(self.slam)
        poses = sum(out is not None for _, out in self.records)
        return dict(t0=t0, t1=t1, attempted=len(self.records),
                    failed=len(self.records) - poses, poses=poses,
                    keyframes=self.kf1 - self.kf0)

    def release(self):
        self.slam.shutdown()
        del self.slam, self.frames

    # ----------------------------------------------------------- reference
    def judge(self) -> dict:
        """The numbers `correct` compares (harness.reference)."""
        mo = self.motion
        got = [(i, out) for i, out in self.records if out is not None]
        idx = np.asarray([i for i, _ in got])
        out = {}
        if len(got) >= 3:
            out.update(reference.trajectory_numbers(
                np.stack([np.asarray(o[0]) for _, o in got]),
                np.stack([np.asarray(o[1]) for _, o in got]), np.zeros(len(got)),
                mo.R_cw[idx], mo.t_cw[idx]))
        m = self.map
        f = np.rint((m["kf_ts"] - mo.frame_ts[0]) * self.p["fps"]).astype(np.int64)
        if len(f) >= 3 and m["imu_initialized"]:
            out.update(reference.map_numbers(
                m["kf_R"], m["kf_t"], m["kf_v"], mo.R_cw[f], mo.t_cw[f], mo.v_w[f], m["pts"],
                reference.box_surface_dist(scene.BOX)))
        return out
