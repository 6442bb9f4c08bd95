"""Where the port's SLAM first parts from the JAX package's on a long run.

Both packages' `Slam` track the same rendered frames in lockstep on the
CPU, intrinsics scaled to the size; the port's two-view RANSAC takes the
samples the reference drew (`tests/test_torch_slam_e2e.reference_samples`)
and, with a vocabulary, its loop closer the reference's Sim3 draws. The
sensors (`--sensor`):

- `imu_mono` (default): IMU_MONOCULAR over
  `orbslam3_tpu_torch.datasets.render.vi_sequence` and its IMU samples,
  the chip_smoke mono-inertial phase's ladder cadence, loop closing off;
- `imu_stereo`: the stereo-inertial phase's raw EuRoC pair over the same
  trajectory, through each package's `Settings` from
  `chip_smoke.euroc_yaml(imu=True)` at the size (rectified), its cadence;
- `vocab`: mono with the shipped vocabulary over the loop session of
  `chip_smoke.loop_sequences`, loop closing on, the global BA inline.

After every frame the keyframes both maps hold (same slot, same uid) are
compared: rotation entries and translation ("pose"), and with an IMU
velocity and bias ("state"); so is each frame's tracked pose ("frame").
The script prints a JSON line per group at the frame at which its largest
difference first exceeds each of 1e-6, 1e-5, 1e-4 and 1e-3 (frame,
keyframe uid, quantity, both values, both maps' keyframe and point
counts), the first frame the maps hold different point counts, the first
frame one tracks and the other does not, and each loop or merge event as
it fires; then one summary JSON
line: the frames of each run's events (init, IMU init, VIBA1/2, loops)
and its `Slam.events`, and at the end each run's keyframes and points, and
its metric ATE, keyframe scale and gravity tilt against the truth
(`evaluation.vi_metrics`) with an IMU, its Sim3-aligned ATE without.

With `--same-input`, every keyframe the JAX package's mapper processes and
every pose solve (`fused_track_pose`) its tracker runs is run again by the
port on the JAX package's inputs (`SameInputProbe`, `TrackerProbe`): a
module that differs shows there, a borderline decision only in the
lockstep run.

Usage (from the repository root; ~10-30 min on the CPU at the default size):

    python scripts/port_vi_parting.py [--sensor imu_mono|imu_stereo|vocab]
        [--frames 120] [--until N] [--same-input] [--width 376 --height 240]
        [--features 600]
"""

import argparse
import contextlib
import copy
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import _cpu_env  # noqa: E402,F401  (pins jax to the CPU)
import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402  (the YAML text, sessions and constants only)
from orbslam3_tpu.config import Settings as JSettings  # noqa: E402

from orbslam3_tpu.core.camera import Camera as JCamera  # noqa: E402
from orbslam3_tpu.engine.local_mapping import LocalMapperConfig as JLC  # noqa: E402
from orbslam3_tpu.engine.system import Sensor as JSensor, Slam as JSlam  # noqa: E402
from orbslam3_tpu.engine.system import SystemConfig as JSC  # noqa: E402
from orbslam3_tpu.engine.tracking import TrackerConfig as JTC  # noqa: E402
from orbslam3_tpu.imu.preintegration import ImuCalib as JCalib  # noqa: E402
from orbslam3_tpu.place.vocab import Vocabulary as JVocabulary  # noqa: E402
from orbslam3_tpu.slam_map.map_state import MapConfig as JMC  # noqa: E402
from orbslam3_tpu_torch import convert  # noqa: E402
from orbslam3_tpu_torch.config import Settings as TSettings  # noqa: E402
from orbslam3_tpu_torch.core.camera import Camera as TCamera  # noqa: E402
from orbslam3_tpu_torch.datasets.render import imu_batches, vi_sequence  # noqa: E402
from orbslam3_tpu_torch.engine.local_mapping import LocalMapperConfig as TLC  # noqa: E402
from orbslam3_tpu_torch.engine.system import Sensor as TSensor, Slam as TSlam  # noqa: E402
from orbslam3_tpu_torch.engine.system import SystemConfig as TSC  # noqa: E402
from orbslam3_tpu_torch.engine.tracking import TrackerConfig as TTC  # noqa: E402
from orbslam3_tpu_torch.evaluation import vi_metrics  # noqa: E402
from orbslam3_tpu_torch.imu.preintegration import ImuCalib as TCalib  # noqa: E402
from orbslam3_tpu_torch.place.vocab import default_vocabulary_path  # noqa: E402
from orbslam3_tpu_torch.place.vocab import load_default_vocabulary  # noqa: E402
from orbslam3_tpu_torch.slam_map.map_state import MapConfig as TMC  # noqa: E402
from test_torch_loop import jax_sampler  # noqa: E402
from test_torch_slam_e2e import reference_samples  # noqa: E402

EUROC_CAM0 = (458.654, 457.296, 367.215, 248.375)
CADENCE = dict(viba1_after_s=1.5, viba2_after_s=3.0, scale_refine_every_s=1.5)
LEVELS = (1e-6, 1e-5, 1e-4, 1e-3)


GROUPS = {"pose": ("kf_R", "kf_t"), "state": ("kf_vel", "kf_bias")}


def keyframe_diff(jm, tm, names) -> tuple[float, dict]:
    """The largest difference of `names` over the keyframes both maps hold,
    and where."""
    worst, where = 0.0, {}
    common = np.intersect1d(jm.keyframe_ids(), tm.keyframe_ids())
    for k in common:
        if int(jm.kf_uid[k]) != int(tm.kf_uid[k]):
            return np.inf, dict(slot=int(k), quantity="uid", jax=int(jm.kf_uid[k]),
                                port=int(tm.kf_uid[k]))
        for name in names:
            a, b = np.asarray(getattr(jm, name)[k]), np.asarray(getattr(tm, name)[k])
            d = float(np.abs(a - b).max())
            if d > worst:
                worst = d
                where = dict(slot=int(k), uid=int(jm.kf_uid[k]), quantity=name,
                             jax=np.round(a, 7).tolist(), port=np.round(b, 7).tolist())
    return worst, where


def events_of(m, i: int, events: dict, tracked: bool):
    if tracked and "init" not in events:
        events["init"] = i
    if m.imu_initialized and "imu_init" not in events:
        events["imu_init"] = (i, int(m._next_uid) - 1)
    for stage in (1, 2):
        if m.iba_stage >= stage and f"viba{stage}" not in events:
            events[f"viba{stage}"] = i


MAPPER_STATE = ("_kf_counter", "_recent_mps", "_t_imu_init", "_last_scale_refine")


def jax_map_copy(m):
    """A JAX package `MapState` holding copies of `m`'s arrays and counters
    (no removal callbacks)."""
    c = type(m)(m.cfg, map_id=m.map_id)
    for name in convert.MAP_ARRAYS:
        setattr(c, name, np.array(getattr(m, name), copy=True))
    for name in ("_next_uid", "_next_mp_uid", "change_index", "imu_initialized", "bad_imu",
                 "iba_stage", "gauge_epoch", "last_gauge"):
        setattr(c, name, copy.copy(getattr(m, name)))
    c.culled_anchor, c.kf_pre = dict(m.culled_anchor), dict(m.kf_pre)
    return c


class SameInputProbe:
    """Each keyframe the JAX package's mapper processes, processed again by
    the port's mapper from the same inputs: the JAX map just before (carried
    across by `convert.map_state`) and the JAX mapper's bookkeeping. The
    port's result is held against the JAX map just after: the same live
    keyframes, points and observations, poses and positions within the
    largest difference reported. The port's own run is left as it was."""

    def __init__(self, jslam, tslam):
        self.tslam, self.records, self.first = tslam, [], {}
        jmapper = jslam._backend.mapper
        orig = type(jmapper).process_keyframe

        def wrapped(mapper, k, *a, **kw):
            before = convert.map_state(mapper.map, device="cpu")
            jbefore = jax_map_copy(mapper.map)
            state = {n: copy.deepcopy(getattr(mapper, n)) for n in MAPPER_STATE
                     if hasattr(mapper, n)}
            out = orig(mapper, k, *a, **kw)
            if not self.check(before, state, int(k), mapper.map):
                self.stages(mapper, jbefore, state, int(k))
            return out
        self._patch = (type(jmapper), orig)
        type(jmapper).process_keyframe = wrapped

    def check(self, before, state, k, jafter):
        tmapper = self.tslam._backend.mapper
        saved = dict(tmapper.__dict__)
        try:
            tmapper.map = before
            tmapper.__dict__.update(state)
            tmapper.process_keyframe(k)
        finally:
            tmapper.__dict__.clear()
            tmapper.__dict__.update(saved)
        same = {n: bool(np.array_equal(getattr(before, n), np.asarray(getattr(jafter, n))))
                for n in ("kf_valid", "mp_valid", "kf_obs_mp")}
        diff = {}
        for n in ("kf_R", "kf_t", "kf_vel", "kf_bias"):
            live = np.asarray(jafter.kf_valid) & before.kf_valid
            diff[n] = float(np.abs(getattr(before, n)[live]
                                   - np.asarray(getattr(jafter, n))[live]).max(initial=0.0))
        # points: the change relative to the point's distance from the
        # keyframe (a far point slides along its ray at little cost)
        live = np.asarray(jafter.mp_valid) & before.mp_valid
        ref = np.asarray(jafter.mp_pos)[live]
        centre = -before.kf_R[k].T @ before.kf_t[k]
        rel = (np.linalg.norm(before.mp_pos[live] - ref, axis=1)
               / np.maximum(np.linalg.norm(ref - centre, axis=1), 1e-6))
        diff["mp_pos_rel"] = float(rel.max(initial=0.0))
        diff["mp_pos_rel_p99"] = float(np.percentile(rel, 99)) if len(rel) else 0.0
        rec = dict(kf_uid=int(jafter.kf_uid[k]), decisions_equal=all(same.values()),
                   same=same, diff=diff, points=(int(jafter.n_points), int(before.n_points)))
        self.records.append(rec)
        print(json.dumps(dict(same_input_kf=rec["kf_uid"], decisions_equal=rec["decisions_equal"],
                              **{n: float(f"{v:.3g}") for n, v in diff.items()})), flush=True)
        worst = max(v for n, v in diff.items() if n != "mp_pos_rel")
        for level in LEVELS:
            if (worst > level or not rec["decisions_equal"]) and level not in self.first:
                self.first[level] = rec
                print(json.dumps(dict(same_input=level, **rec)), flush=True)
        return rec["decisions_equal"]

    def stages(self, jmapper, jbefore, state, k):
        """The keyframe's mapping stages one at a time on copies of the same
        input in both packages: the first stage whose result differs, and
        how (entries of each bookkeeping array that differ, the largest
        point move)."""
        tmapper = self.tslam._backend.mapper
        tm = convert.map_state(jbefore, device="cpu")
        pre = convert.map_state(jbefore, device="cpu")  # stays as it was
        saved = {"jax": dict(jmapper.__dict__), "port": dict(tmapper.__dict__)}
        out = []
        try:
            for mapper, m in ((jmapper, jbefore), (tmapper, tm)):
                mapper.map = m
                mapper.__dict__.update(copy.deepcopy(state))
            for name, call in (("cull_map_points", lambda mp: mp._cull_map_points()),
                               ("triangulate", lambda mp: mp._create_new_map_points(k)),
                               ("fuse", lambda mp: mp._fuse_neighbors(k)),
                               ("point_stats", lambda mp: mp.map.update_point_stats(
                                   mp.map.kf_obs_mp[k]))):
                with triangulation_calls() as calls:
                    call(jmapper)
                    call(tmapper)
                differ = {n: int(np.sum(np.asarray(getattr(jbefore, n)) != getattr(tm, n)))
                          for n in ("kf_valid", "mp_valid", "kf_obs_mp", "mp_first_kf")}
                live = np.asarray(jbefore.mp_valid) & tm.mp_valid
                move = float(np.abs(np.asarray(jbefore.mp_pos)[live] - tm.mp_pos[live]).max(
                    initial=0.0))
                rec = dict(stage=name, differ=differ, point_move=move,
                           points=(int(jbefore.n_points), int(tm.n_points)))
                if any(differ.values()) and name == "triangulate":
                    rec["candidates"] = triangulation_differences(
                        calls, pre, k, [float(v) for v in tmapper.camera.params[:4]])
                out.append(rec)
                if any(differ.values()):
                    break
        finally:
            for key, mapper in (("jax", jmapper), ("port", tmapper)):
                mapper.__dict__.clear()
                mapper.__dict__.update(saved[key])
        print(json.dumps(dict(same_input_stages=int(jbefore.kf_uid[k]), stages=out)), flush=True)

    def close(self):
        cls, orig = self._patch
        cls.process_keyframe = orig


class TrackerProbe:
    """Each `fused_track_pose` the JAX package's tracker runs, run again by
    the port's on the same inputs (converted to CPU tensors): success, the
    match and inlier counts and the inlier set equal, the pose within the
    largest difference reported."""

    def __init__(self):
        from orbslam3_tpu.engine import tracking as jtracking
        from orbslam3_tpu_torch.engine.track_program import fused_track_pose
        self.records, self.first, self.frame = [], {}, -1
        self._mod, orig = jtracking, jtracking.fused_track_pose

        def to_t(x):
            a = np.array(jax.device_get(x))
            if a.dtype.name == "bfloat16":  # the +/-1 descriptor planes
                a = a.astype(np.float32)
            return torch.from_numpy(a)

        def wrapped(*args, **kwargs):
            ok_j, res_j = orig(*args, **kwargs)
            cam = args[6]
            targs = [to_t(a) for a in args[:6]] + [convert.camera(
                np.asarray(cam.params), cam.kind, cam.width, cam.height, device="cpu")]
            targs += [to_t(a) for a in args[7:15]]
            targs += [bool(args[15]), [float(r) for r in np.asarray(args[16])],
                      int(args[17]), int(args[18])]
            tkw = dict(max_dist=kwargs.get("max_dist", 100), device="cpu")
            if kwargs.get("u_right") is not None:
                tkw.update(u_right=to_t(kwargs["u_right"]), bf=float(kwargs["bf"]))
            ok_t, res_t = fused_track_pose(*targs, **tkw)
            rj = jax.device_get(res_j)
            same = bool(ok_j) == bool(ok_t) and all(
                np.array_equal(np.asarray(rj[k]), res_t[k].numpy()) for k in ("nm", "n_in", "inl"))
            diff = max(float(np.abs(np.asarray(rj[k]) - res_t[k].numpy()).max())
                       for k in ("R", "t"))
            rec = dict(frame=self.frame, success=(bool(ok_j), bool(ok_t)),
                       n_in=(int(rj["n_in"]), int(res_t["n_in"])), decisions_equal=same,
                       pose_diff=diff)
            self.lockstep.setdefault(self.frame, {})["jax"] = dict(
                success=bool(ok_j), frustum=int(np.asarray(rj["fr"]).sum()), nm=int(rj["nm"]),
                n_in=int(rj["n_in"]))
            self.records.append(rec)
            for level in LEVELS:
                if (diff > level or not same) and level not in self.first:
                    self.first[level] = rec
                    print(json.dumps(dict(tracker_same_input=level, **rec)), flush=True)
            return ok_j, res_j
        jtracking.fused_track_pose = wrapped
        # the port's own solve in the lockstep run: its counts beside the JAX package's
        from orbslam3_tpu_torch.engine import tracking as ttracking
        torig = ttracking.fused_track_pose
        self.lockstep = {}

        def port_wrapped(*args, **kwargs):
            ok, res = torig(*args, **kwargs)
            self.lockstep.setdefault(self.frame, {})["port"] = dict(
                success=bool(ok), frustum=int(res["fr"].sum()), nm=int(res["nm"]),
                n_in=int(res["n_in"]))
            return ok, res
        ttracking.fused_track_pose = port_wrapped


@contextlib.contextmanager
def triangulation_calls():
    """Record each package's `search_for_triangulation` results (the
    keyframe's candidate partner per feature) and `triangulate_points`
    outputs, in call order, while the block runs."""
    from orbslam3_tpu.engine import local_mapping as jlm
    from orbslam3_tpu_torch.engine import local_mapping as tlm
    calls = {"jax": [], "port": []}
    saved = []
    for key, mod in (("jax", jlm), ("port", tlm)):
        search, tri = mod.matcher.search_for_triangulation, mod.triangulate_points

        def rec_search(*a, _f=search, _key=key, **kw):
            idx, ok = _f(*a, **kw)
            calls[_key].append(dict(idx=np.array(idx), ok=np.array(ok),
                                    R2=np.array(a[8]), t2=np.array(a[9])))
            return idx, ok

        def rec_tri(*a, _f=tri, _key=key, **kw):
            out = _f(*a, **kw)
            calls[_key][-1]["X"] = np.array(out[0])
            return out
        saved.append((mod, search, tri))
        mod.matcher.search_for_triangulation, mod.triangulate_points = rec_search, rec_tri
    try:
        yield calls
    finally:
        for mod, search, tri in saved:
            mod.matcher.search_for_triangulation, mod.triangulate_points = search, tri


def triangulation_differences(calls, tm, k, intrinsics) -> list:
    """Where the two packages' triangulations of keyframe `k` part (`tm`, the
    map before): per neighbour call, the features whose candidate partner or
    acceptance differs, with the epipolar distance of each package's pair in
    f64 (the gate is 3.84 x 2 px) and the depths and parallax cosine (gate
    0.9998) of each package's point."""
    fx, fy, cx, cy = intrinsics
    Rk, tk = tm.kf_R[k].astype(np.float64), tm.kf_t[k].astype(np.float64)

    def ray(uv):
        return np.array([(uv[0] - cx) / fx, (uv[1] - cy) / fy, 1.0])

    out = []
    for cj, ct in zip(calls["jax"], calls["port"]):
        Rn, tn = ct["R2"].astype(np.float64), ct["t2"].astype(np.float64)
        nb = int(np.nonzero(tm.kf_valid & np.all(np.isclose(tm.kf_t, ct["t2"]), axis=1))[0][0])
        R12 = Rn @ Rk.T
        t12 = tn - R12 @ tk
        E = np.array([[0, -t12[2], t12[1]], [t12[2], 0, -t12[0]], [-t12[1], t12[0], 0]]) @ R12
        diff = np.nonzero((cj["ok"] != ct["ok"]) | (cj["ok"] & (cj["idx"] != ct["idx"])))[0]
        rec = dict(candidates_differ=int(len(diff)),
                   accepted=(int(cj["ok"].sum()), int(ct["ok"].sum())), features=[])
        both = cj["ok"] & ct["ok"] & (cj["idx"] == ct["idx"])
        if "X" in cj and "X" in ct:
            rec["X_diff"] = float(np.abs(cj["X"] - ct["X"])[both].max(initial=0.0))
            # the acceptance gates of each package's points, as the packages
            # evaluate them (f32) and in f64
            limits = dict(z1=(0.05, ">"), z2=(0.05, ">"), cos=(0.9998, "<"), e1=(5.991, "<"),
                          e2=(5.991, "<"))
            for dtype in (np.float32, np.float64):
                gates = {}
                for key, c in (("jax", cj), ("port", ct)):
                    X = c["X"].astype(dtype)
                    Rk_, tk_ = tm.kf_R[k].astype(dtype), tm.kf_t[k].astype(dtype)
                    Rn_, tn_ = ct["R2"].astype(dtype), ct["t2"].astype(dtype)
                    xc1, xc2 = X @ Rk_.T + tk_, X @ Rn_.T + tn_
                    r1, r2 = X - (-Rk_.T @ tk_), X - (-Rn_.T @ tn_)
                    cosp = np.sum(r1 * r2, -1) / (np.linalg.norm(r1, axis=-1)
                                                  * np.linalg.norm(r2, axis=-1))
                    f = np.asarray([fx, fy], dtype)
                    cc = np.asarray([cx, cy], dtype)
                    e = [np.sum((xc[:, :2] / xc[:, 2:3] * f + cc - uv.astype(dtype)) ** 2, -1)
                         for xc, uv in ((xc1, tm.kf_uv[k]), (xc2, tm.kf_uv[nb][c["idx"]]))]
                    gates[key] = dict(z1=xc1[:, 2], z2=xc2[:, 2], cos=cosp, e1=e[0], e2=e[1])
                for i in np.nonzero(both)[0]:
                    for g, (lim, op) in limits.items():
                        a, b = gates["jax"][g][i], gates["port"][g][i]
                        if (a > lim) != (b > lim):
                            rec["features"].append(dict(
                                slot=int(i), gate=f"{g} {op} {lim}", dtype=np.dtype(dtype).name,
                                jax=float(a), port=float(b)))
        for i in diff[:4]:
            f = dict(slot=int(i), ok=(bool(cj["ok"][i]), bool(ct["ok"][i])),
                     idx=(int(cj["idx"][i]), int(ct["idx"][i])))
            for key, c in (("jax", cj), ("port", ct)):
                j = int(c["idx"][i])
                l2 = E @ ray(tm.kf_uv[k][i])
                epi = abs(l2 @ ray(tm.kf_uv[nb][j])) / np.hypot(l2[0], l2[1]) * fx
                f[key] = dict(epipolar_px=float(epi))
                if c["ok"][i] and "X" in c:
                    X = c["X"][i].astype(np.float64)
                    r1, r2 = X + Rk.T @ tk, X + Rn.T @ tn
                    f[key].update(z=[float((Rk @ X + tk)[2]), float((Rn @ X + tn)[2])],
                                  cos_parallax=float(r1 @ r2 / np.linalg.norm(r1)
                                                     / np.linalg.norm(r2)))
            rec["features"].append(f)
        out.append(rec)
    return out


def settings_pair(text: str, sensor: str):
    """Both packages' `Settings` of one YAML text."""
    with tempfile.NamedTemporaryFile("w", suffix=".yaml", delete=False) as f:
        f.write(text)
    try:
        return JSettings.from_yaml(f.name, sensor), TSettings.from_text(text, sensor)
    finally:
        os.unlink(f.name)


def build(args):
    """(JAX Slam, port Slam, per-frame track calls, truth, groups) of
    `args.sensor`: calls[i](slam) tracks frame i and returns its pose;
    truth is (R_cw, t_cw, frame stamps, R1), R1 the rectified camera's
    rotation from the raw left one."""
    s = args.width / 752.0
    intr = tuple(v * s for v in EUROC_CAM0)
    if args.sensor == "vocab":
        imgs, R, t, ts = smoke.loop_sequences(args.width, args.height, intr)["loop"]
        n = min(args.frames, len(ts))
        jcfg = JSC(map=JMC(features_per_frame=args.features),
                   tracker=JTC(n_features=args.features))
        tcfg = TSC(map=TMC(features_per_frame=args.features),
                   tracker=TTC(n_features=args.features))
        jslam = JSlam(JCamera.pinhole(*intr, width=args.width, height=args.height), jcfg,
                      vocab=JVocabulary.load(default_vocabulary_path()))
        tslam = TSlam(TCamera.pinhole(*intr, width=args.width, height=args.height,
                                      device="cpu"), tcfg, vocab=load_default_vocabulary(),
                      device="cpu")
        for slam in (jslam, tslam):
            slam.loop_closer.gba_background = False
        tslam.loop_closer.sample_fn = jax_sampler()
        calls = [lambda slam, i=i: slam.track_monocular(imgs[i], float(ts[i]))
                 for i in range(n)]
        return jslam, tslam, calls, (R, t, ts, np.eye(3)), {"pose": GROUPS["pose"]}
    seq_kw, n = {}, args.frames
    if args.sensor == "imu_stereo":
        (_, d0), (f1, d1) = smoke.EUROC_CAM0, smoke.EUROC_CAM1
        seq_kw = dict(pinhole_dist=d0, T_c1_c2=smoke.EUROC_T_C1_C2,
                      right=(tuple(v * s for v in f1), d1))
    seq = vi_sequence(n, args.width, args.height, intr, **seq_kw)
    batches = imu_batches(seq.frame_ts, seq.imu_ts, seq.gyro, seq.acc)
    if args.sensor == "imu_stereo":
        jst, tst = settings_pair(smoke.euroc_yaml(True, s, args.features), "imu_stereo")
        jcfg, tcfg = jst.system_config(), tst.system_config(device="cpu")
        jcfg.mapper, tcfg.mapper = JLC(**CADENCE), TLC(**CADENCE)
        jslam = JSlam(jst.camera(), jcfg)
        tslam = TSlam(tst.camera(device="cpu"), tcfg, device="cpu")
        R1 = tst.rectification(device="cpu").R1
        calls = [lambda slam, i=i: slam.track_stereo(
            seq.images[i], seq.images_right[i], float(seq.frame_ts[i]), imu=batches[i])
            for i in range(n)]
    else:
        jslam = JSlam(JCamera.pinhole(*intr, width=args.width, height=args.height), JSC(
            sensor=JSensor.IMU_MONOCULAR, imu_calib=JCalib.create(), use_loop_closing=False,
            map=JMC(features_per_frame=args.features), tracker=JTC(n_features=args.features),
            mapper=JLC(**CADENCE)))
        tslam = TSlam(TCamera.pinhole(*intr, width=args.width, height=args.height,
                                      device="cpu"),
                      TSC(sensor=TSensor.IMU_MONOCULAR, imu_calib=TCalib.create(),
                          use_loop_closing=False, map=TMC(features_per_frame=args.features),
                          tracker=TTC(n_features=args.features), mapper=TLC(**CADENCE)),
                      device="cpu")
        R1 = np.eye(3)
        calls = [lambda slam, i=i: slam.track_monocular(
            seq.images[i], float(seq.frame_ts[i]), imu=batches[i]) for i in range(n)]
    return jslam, tslam, calls, (seq.R_cw, seq.t_cw, seq.frame_ts, R1), GROUPS


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sensor", choices=("imu_mono", "imu_stereo", "vocab"),
                    default="imu_mono")
    ap.add_argument("--frames", type=int, default=None,
                    help="default: 120, the whole loop session (139) with --sensor vocab")
    ap.add_argument("--width", type=int, default=376)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--features", type=int, default=600)
    ap.add_argument("--until", type=int, default=None,
                    help="stop after this many frames (the sequence is still the --frames one)")
    ap.add_argument("--same-input", action="store_true",
                    help="also run the port's mapper on the JAX package's inputs at "
                         "every keyframe (SameInputProbe) and its tracker's pose solve "
                         "on the JAX tracker's inputs at every frame (TrackerProbe)")
    args = ap.parse_args()
    args.frames = args.frames or (smoke.LOOP_FRAMES if args.sensor == "vocab" else 120)
    torch.set_num_threads(1)
    jslam, tslam, calls, (R_cw, t_cw, stamps, R1), groups = build(args)
    make = tslam._make_tracker

    def with_samples(client_id):  # every tracker, also after a reset or respawn
        tracker = make(client_id)
        tracker.sample_fn = reference_samples
        return tracker
    tslam._make_tracker = with_samples
    tslam.trackers[0].sample_fn = reference_samples
    probe = SameInputProbe(jslam, tslam) if args.same_input else None
    tprobe = TrackerProbe() if args.same_input else None

    events = {"jax": {}, "port": {}}
    parted, t0 = {}, time.perf_counter()
    n_loop = {"jax": 0, "port": 0}
    for i, call in enumerate(calls[:args.until]):
        if tprobe is not None:
            tprobe.frame = i
        pj, pt = call(jslam), call(tslam)
        if pj is not None and pt is not None:  # the frame's tracked pose
            worst = max(float(np.abs(np.asarray(pj[0]) - np.asarray(pt[0])).max()),
                        float(np.abs(np.asarray(pj[1]) - np.asarray(pt[1])).max()))
            for level in LEVELS:
                if worst > level and ("frame", level) not in parted:
                    parted["frame", level] = dict(group="frame", level=level, frame=i, diff=worst)
                    print(json.dumps(parted["frame", level]), flush=True)
        jm, tm = jslam.trackers[0].map, tslam.trackers[0].map
        events_of(jm, i, events["jax"], pj is not None)
        events_of(tm, i, events["port"], pt is not None)
        for name, slam in (("jax", jslam), ("port", tslam)):
            if slam.loop_closer is None:
                continue
            for ev in slam.loop_closer.events[n_loop[name]:]:
                m = slam.atlas.active
                rec = dict(run=name, event=ev.kind, frame=i, kf_uid=int(m.kf_uid[ev.kf]),
                           matched_uid=int(m.kf_uid[ev.matched_kf]),
                           scale=round(float(ev.scale), 5), inliers=int(ev.n_inliers))
                events[name].setdefault("loops", []).append(rec)
                print(json.dumps(rec), flush=True)
            n_loop[name] = len(slam.loop_closer.events)
        for group, names in groups.items():
            worst, where = keyframe_diff(jm, tm, names)
            for level in LEVELS:
                if worst > level and (group, level) not in parted:
                    parted[group, level] = dict(
                        group=group, level=level, frame=i, diff=worst,
                        keyframes=(int(jm.n_keyframes), int(tm.n_keyframes)),
                        points=(int(jm.n_points), int(tm.n_points)), **where)
                    print(json.dumps(parted[group, level]), flush=True)
        if jm.n_points != tm.n_points and "points" not in parted:
            parted["points"] = dict(frame=i, points=(int(jm.n_points), int(tm.n_points)),
                                    keyframes=(int(jm.n_keyframes), int(tm.n_keyframes)))
            print(json.dumps(parted["points"]), flush=True)
        if (pj is None) != (pt is None) and "tracking" not in parted:
            parted["tracking"] = dict(frame=i, jax=pj is not None, port=pt is not None)
            print(json.dumps(parted["tracking"]), flush=True)
    out = dict(sensor=args.sensor, frames=args.frames, width=args.width, height=args.height,
               features=args.features, events=events, seconds=round(time.perf_counter() - t0, 1),
               first_parting={" ".join(map(str, k)) if isinstance(k, tuple) else k: v["frame"]
                              for k, v in parted.items()})
    if tprobe is not None:
        out["tracker_same_input"] = dict(
            calls=len(tprobe.records), worst=max((r["pose_diff"] for r in tprobe.records),
                                                 default=0.0),
            decisions_differ=[r["frame"] for r in tprobe.records if not r["decisions_equal"]],
            lockstep_counts_differ={f: v for f, v in tprobe.lockstep.items()
                                   if v.get("jax") != v.get("port")})
    if probe is not None:
        probe.close()
        out["same_input"] = dict(keyframes=len(probe.records),
                                 first={str(k): v for k, v in probe.first.items()},
                                 worst={n: max(r["diff"][n] for r in probe.records)
                                        for n in probe.records[0]["diff"]}
                                 if probe.records else {},
                                 decisions_differ=sum(not r["decisions_equal"]
                                                      for r in probe.records))
    R_gt = np.einsum("ij,njk->nik", R1, R_cw)
    t_gt = np.einsum("ij,nj->ni", R1, t_cw)
    for name, slam in (("jax", jslam), ("port", tslam)):
        m = slam.trackers[0].map
        ks = m.keyframe_ids()
        poses = slam._full_poses()
        out[name] = dict(keyframes=int(m.n_keyframes), points=int(m.n_points),
                         keyframes_made=int(m._next_uid),
                         slam_events=[e["event"] for e in slam.events])
        if args.sensor == "vocab":
            out[name]["ate"] = round(smoke.trajectory_ate(poses, R_cw, t_cw, stamps), 6)
            continue
        met = vi_metrics(poses, np.asarray(m.kf_R[ks]), np.asarray(m.kf_t[ks]),
                         np.asarray(m.kf_ts[ks]), stamps, R_gt, t_gt)
        out[name].update(iba_stage=int(m.iba_stage),
                         kf_scale=round(float(met["kf_scale"]), 5),
                         ate_metric=round(float(met["ate_metric"]), 6),
                         gravity_tilt_deg=round(float(met["gravity_tilt_deg"]), 3))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
