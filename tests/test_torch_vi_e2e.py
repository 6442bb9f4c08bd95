"""The mono-inertial slice as a whole, CPU: the JAX `Tracker` + `LocalMapper`
against the port's on the same feature-level sequence with IMU.

The frames are `render_features` of `make_world(4000, seed=4)` along the
trajectory of `datasets/render.py:vi_sequence` (the EuRoC writer's
`excited_trajectory`: a 3 m orbit with translational and rotational
shake), and the IMU samples are that sequence's, batched per frame; the
port is handed the two-view RANSAC samples the reference drew.

Tier-1 size: 26 frames with the IMU initialization span cut to 1.0 s and
smaller BA caps (2048 points, 8192 observations, 8 post-init VI-BA
iterations), so the IMU initializes inside the run (frame 24, the eighth
keyframe). Held: the same tracked frames, init frame, IMU-init frame and
keyframe, keyframe count and `iba_stage`, per-frame metric poses and
keyframe velocities within 2e-3 (measured 1.1e-4 and 4e-5), and keyframe
biases at their own scale (gyro to 1% of its largest entry, measured
0.15%; accelerometer 1e-5 m/s^2). The 120-frame run at the reference
cadence (VIBA1 after 1.5 s, VIBA2 after 3.0 s) is marked slow: the JAX
side alone takes minutes on the CPU."""

import numpy as np
import pytest

from orbslam3_tpu.core.camera import Camera as JCamera
from orbslam3_tpu.engine.local_mapping import LocalMapper as JMapper, LocalMapperConfig as JLC
from orbslam3_tpu.engine.tracking import Tracker as JTracker, TrackerConfig as JTC
from orbslam3_tpu.imu.preintegration import ImuCalib as JCalib
from orbslam3_tpu.slam_map.map_state import MapConfig as JMC, MapState as JMS
from orbslam3_tpu.utils import synth
from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.core.camera import Camera as TCamera
from orbslam3_tpu_torch.datasets.render import imu_batches, vi_sequence
from orbslam3_tpu_torch.engine.local_mapping import LocalMapper as TMapper, LocalMapperConfig as TLC
from orbslam3_tpu_torch.engine.tracking import Tracker as TTracker, TrackerConfig as TTC
from orbslam3_tpu_torch.evaluation import umeyama_alignment
from orbslam3_tpu_torch.slam_map.map_state import MapConfig as TMC, MapState as TMS
from test_torch_slam_e2e import reference_samples

POSE_TOL = 2e-3
CADENCE = dict(viba1_after_s=1.5, viba2_after_s=3.0, scale_refine_every_s=1.5)
TIER1 = dict(imu_init_min_span_s=1.0, ba_points_cap=2048, ba_obs_cap=8192,
             post_init_viba_iters=8, **CADENCE)


def run_both(n_frames: int, mapper_cfg: dict):
    seq = vi_sequence(n_frames, render=False)
    cj = JCamera.pinhole(458.0, 458.0, 320.0, 240.0, width=640, height=480)
    ct = TCamera.pinhole(458.0, 458.0, 320.0, 240.0, width=640, height=480, device="cpu")
    world = synth.make_world(n_points=4000, seed=4)
    frames = [synth.render_features(world, seq.R_cw[i], seq.t_cw[i], cj, capacity=600,
                                    seed=100 + i)[0] for i in range(n_frames)]
    batches = imu_batches(seq.frame_ts, seq.imu_ts, seq.gyro, seq.acc)

    jm = JMS(JMC(max_keyframes=64, max_points=8192, features_per_frame=600))
    jcal = JCalib.create()
    jt = JTracker(cj, jm, JTC(n_features=600), imu_calib=jcal,
                  local_mapper=JMapper(cj, jm, JLC(**mapper_cfg), imu_calib=jcal))
    tm = TMS(TMC(max_keyframes=64, max_points=8192, features_per_frame=600), device="cpu")
    tcal = convert.imu_calib(jcal, device="cpu")
    tt = TTracker(ct, tm, TTC(n_features=600), imu_calib=tcal, device="cpu",
                  local_mapper=TMapper(ct, tm, TLC(**mapper_cfg), imu_calib=tcal, device="cpu"),
                  sample_fn=reference_samples)
    runs = {}
    for name, tracker, m in (("jax", jt, jm), ("port", tt, tm)):
        poses, events = [], {}
        for i, f in enumerate(frames):
            if name == "port":
                f = convert.frame_features(*(np.asarray(getattr(f, k)) for k in
                                             ("uv", "uv_raw", "response", "angle", "octave",
                                              "desc", "valid")), device="cpu")
            tracker.queue_imu(batches[i])
            poses.append(tracker.process_features(f, float(seq.frame_ts[i])))
            if m.imu_initialized and "imu_init" not in events:
                events["imu_init"] = (i, int(m._next_uid) - 1)
            for stage in (1, 2):
                if m.iba_stage >= stage and stage not in events:
                    events[stage] = i
        runs[name] = dict(poses=poses, events=events, map=m, tracker=tracker)
    return seq, runs


def _check(runs):
    j, p = runs["jax"], runs["port"]
    tracked_j = [x is not None for x in j["poses"]]
    assert [x is not None for x in p["poses"]] == tracked_j
    init = tracked_j.index(True)
    assert 0 < init < 10 and all(tracked_j[init:])
    assert p["events"] == j["events"]
    assert "imu_init" in j["events"]
    assert p["map"].n_keyframes == j["map"].n_keyframes
    assert p["map"].iba_stage == j["map"].iba_stage
    assert p["map"].imu_initialized and p["tracker"].state.name == "OK"
    worst = 0.0
    for a, b in zip(j["poses"], p["poses"]):
        if a is not None:
            worst = max(worst, float(np.abs(np.asarray(a[0]) - b[0]).max()),
                        float(np.abs(np.asarray(a[1]) - b[1]).max()))
    assert worst < POSE_TOL, worst


@pytest.fixture(scope="module")
def tier1():
    return run_both(26, TIER1)


def test_imu_initializes_at_the_same_keyframe(tier1):
    _, runs = tier1
    _check(runs)
    assert runs["port"]["events"]["imu_init"] == (24, 7)


def test_inertial_state_agrees(tier1):
    """After the init's re-gauge, keyframe velocities and biases agree, and
    the metric keyframe centres match the ground truth's scale."""
    seq, runs = tier1
    jm, tm = runs["jax"]["map"], runs["port"]["map"]
    ks = jm.keyframe_ids()
    np.testing.assert_array_equal(tm.keyframe_ids(), ks)
    np.testing.assert_allclose(tm.kf_vel[ks], jm.kf_vel[ks], rtol=0, atol=POSE_TOL)
    # biases at their own scale: the gyro bias (~1.6e-4 rad/s here) to 1% of
    # the JAX package's largest entry; the accelerometer bias, which the
    # first rung's prior (1e10) holds near 0, to 1e-5 m/s^2
    bg_j = jm.kf_bias[ks][:, :3]
    np.testing.assert_allclose(tm.kf_bias[ks][:, :3], bg_j, rtol=0,
                               atol=1e-2 * np.abs(bg_j).max())
    np.testing.assert_allclose(tm.kf_bias[ks][:, 3:], jm.kf_bias[ks][:, 3:], rtol=0, atol=1e-5)
    assert tm.gauge_epoch == jm.gauge_epoch == 1
    gi = [int(np.argmin(np.abs(seq.frame_ts - t))) for t in jm.kf_ts[ks]]
    gt = -np.einsum("nji,nj->ni", seq.R_cw[gi], seq.t_cw[gi])
    for m in (jm, tm):
        centres = -np.einsum("nji,nj->ni", m.kf_R[ks], m.kf_t[ks])
        s, _, _ = umeyama_alignment(centres.astype(np.float64), gt, with_scale=True)
        assert abs(s - 1.0) < 0.2


@pytest.mark.slow
def test_full_ladder_120_frames():
    """The whole ladder at the reference cadence: IMU init, VIBA1, VIBA2
    and scale refinement, at the default init span and caps."""
    seq, runs = run_both(120, dict(CADENCE))
    _check(runs)
    assert runs["jax"]["map"].iba_stage == 2
