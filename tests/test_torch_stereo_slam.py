"""Port parity, CPU: the stereo / RGB-D trackers and local mapping.

1. Feature level: the JAX `Tracker` + `LocalMapper` against the port's on
   the first 24 frames of the feature-level sequence of
   `tests/test_slam_e2e.py`, each feature given the same stereo depth and
   virtual right coordinate (bf 40, 70% of the features, 0.3 px of
   disparity noise, far depths gated by thFarPoints), so both trackers see
   identical inputs. Held: stereo initialization on the first frame with
   the same points (positions 1e-5 m) and right coordinates (exact), every
   frame tracked by both, the same keyframe count, the close points
   spawned at each keyframe, per-frame poses within 1e-3 (rotation entries
   and metres; the f32 solves sum in another order, and a keyframe's BA
   moves the map a little differently in each), point counts within 2%.
2. `LocalMapper.process_keyframe` with stereo BA rows on the JAX map
   carried over just before two of its keyframes: the same new points,
   observations and live keyframes, poses 1e-4, points 1e-3 m.
3. The stereo and RGB-D sensors with an IMU run.

`Slam.track_stereo` / `track_rgbd` end to end against the JAX package:
tests/test_torch_stereo_e2e.py."""

import numpy as np
import pytest

from orbslam3_tpu.core.camera import Camera as JCamera
from orbslam3_tpu.engine import local_mapping as jlm
from orbslam3_tpu.engine.tracking import Tracker as JTracker, TrackerConfig as JTC
from orbslam3_tpu.slam_map.map_state import MapConfig as JMC, MapState as JMS
from orbslam3_tpu.utils import synth
from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.core.camera import Camera as TCamera
from orbslam3_tpu_torch.datasets import render as trender
from orbslam3_tpu_torch.engine import local_mapping as tlm
from orbslam3_tpu_torch.engine.system import Sensor, Slam as TSlam
from orbslam3_tpu_torch.engine.tracking import Tracker as TTracker, TrackerConfig as TTC
from orbslam3_tpu_torch.imu.preintegration import ImuCalib
from orbslam3_tpu_torch.slam_map.map_state import MapConfig as TMC, MapState as TMS
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU = "cpu"
BF = 40.0
FEATURE_FRAMES = 24
POSE_TOL = 1e-3
CFG = dict(n_features=600, bf=BF, th_depth=60.0, th_far_points=12.0, kf_ref_ratio=0.75)


def _stereo_inputs(f, gt, R, t, world, cam, rng):
    """Depth and right coordinate of each feature: the landmark's depth
    with 0.3 px of disparity noise for 70% of the real features."""
    uv = np.asarray(f.uv)
    depth = np.zeros(len(gt), np.float32)
    u_r = np.full(len(gt), -1.0, np.float32)
    real = np.nonzero((gt >= 0) & (rng.random(len(gt)) < 0.7))[0]
    z = (world.points[gt[real]] @ R.T + t)[:, 2]
    ur = uv[real, 0] - BF / z + rng.normal(0, 0.3, len(real))
    ok = uv[real, 0] - ur > 0.1
    u_r[real[ok]] = ur[ok]
    depth[real[ok]] = BF / (uv[real[ok], 0] - ur[ok])
    return depth, u_r


@pytest.fixture(scope="module")
def feature_runs():
    cj = JCamera.pinhole(458.0, 458.0, 320.0, 240.0, width=640, height=480)
    ct = TCamera.pinhole(458.0, 458.0, 320.0, 240.0, width=640, height=480, device=CPU)
    world = synth.make_world(n_points=3000, seed=4)
    R_gt, t_gt = synth.orbit_trajectory(n_frames=80, radius=3.0, arc=1.0)
    rng = np.random.default_rng(11)
    cases = []

    class Recording(jlm.LocalMapper):
        def process_keyframe(self, k, abort=None):
            before = (convert.map_state(self.map, device=CPU), list(self._recent_mps),
                      self._kf_counter)
            super().process_keyframe(k, abort)
            cases.append((k, before, convert.map_state(self.map, device=CPU)))

    jm = JMS(JMC(max_keyframes=64, max_points=8192, features_per_frame=600))
    jt = JTracker(cj, jm, JTC(**CFG), local_mapper=Recording(cj, jm, bf=BF, fix_scale=True))
    tm = TMS(TMC(max_keyframes=64, max_points=8192, features_per_frame=600), device=CPU)
    tt = TTracker(ct, tm, TTC(**CFG), device=CPU,
                  local_mapper=tlm.LocalMapper(ct, tm, bf=BF, fix_scale=True, device=CPU))
    out = {"jax": [], "port": [], "kfs": [], "init": None}
    for i in range(FEATURE_FRAMES):
        f, gt = synth.render_features(world, R_gt[i], t_gt[i], cj, capacity=600,
                                      seed=100 + i)
        depth, u_r = _stereo_inputs(f, gt, R_gt[i], t_gt[i], world, cj, rng)
        jt._cur_depth, jt._cur_uright = depth.copy(), u_r.copy()
        jt._gate_far_points()
        out["jax"].append(jt.process_features(f, 0.05 * i))
        jt._cur_depth = jt._cur_uright = None
        fields = (np.asarray(getattr(f, k)) for k in
                  ("uv", "uv_raw", "response", "angle", "octave", "desc", "valid"))
        tt._cur_depth, tt._cur_uright = depth.copy(), u_r.copy()
        out["port"].append(tt._process_with_depth(
            convert.frame_features(*fields, device=CPU), 0.05 * i))
        if i == 0:
            out["init"] = [(m.mp_pos[m.mp_valid].copy(), m.kf_uright[m.kf_valid].copy())
                           for m in (jm, tm)]
        out["kfs"].append((jm.n_keyframes, tm.n_keyframes, jm.n_points, tm.n_points))
    return out, (jm, jt), (tm, tt), cases


def test_stereo_tracker_matches_jax(feature_runs):
    out, (jm, jt), (tm, tt), _ = feature_runs
    tracked_j = [p is not None for p in out["jax"]]
    assert [p is not None for p in out["port"]] == tracked_j
    assert all(tracked_j)  # stereo initializes on the first frame
    assert tm.n_keyframes == jm.n_keyframes >= 3
    assert abs(tm.n_points - jm.n_points) <= 0.02 * jm.n_points
    for (Rj, tj), (Rt, tt_) in zip(out["jax"], out["port"]):
        np.testing.assert_allclose(Rt, Rj, atol=POSE_TOL)
        np.testing.assert_allclose(tt_, tj, atol=POSE_TOL)
    # the stereo keyframes keep their right coordinates
    ks = jm.keyframe_ids()
    np.testing.assert_array_equal(tm.keyframe_ids(), ks)
    assert (tm.kf_uright[ks] >= 0).sum() > 100


def test_stereo_initialization_and_close_points_match_jax(feature_runs):
    """The init keyframe's points are its features' depths unprojected: the
    same points (1e-5 m) and right coordinates (exact) in both, none past
    thFarPoints (12 m, whose right coordinates are -1); each later
    keyframe spawned the close points (under 60 baselines, 5.2 m) that
    keep the point counts within 2% frame by frame."""
    out, _, _, _ = feature_runs
    (pj, urj), (pt, urt) = out["init"]
    assert len(pj) == len(pt) > 100
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(urt, urj)
    assert pj[:, 2].max() <= CFG["th_far_points"]
    for (kj, kt, nj, nt) in out["kfs"]:
        assert kt == kj and abs(nt - nj) <= 0.02 * nj
    assert out["kfs"][-1][2] > 1.5 * len(pj)  # the map grew past the init points


@pytest.mark.parametrize("case", [0, 1])
def test_stereo_process_keyframe_matches_jax(feature_runs, case):
    _, _, _, cases = feature_runs
    ct = TCamera.pinhole(458.0, 458.0, 320.0, 240.0, width=640, height=480, device=CPU)
    k, (tm, recent, counter), ref = cases[case]
    mapper = tlm.LocalMapper(ct, tm, bf=BF, fix_scale=True, device=CPU)
    mapper._recent_mps, mapper._kf_counter = recent, counter
    mapper.process_keyframe(k)
    assert tm.n_points == ref.n_points
    np.testing.assert_array_equal(tm.kf_valid, ref.kf_valid)
    np.testing.assert_array_equal(tm.mp_valid, ref.mp_valid)
    np.testing.assert_array_equal(tm.kf_obs_mp, ref.kf_obs_mp)
    np.testing.assert_allclose(tm.kf_R, ref.kf_R, atol=1e-4)
    np.testing.assert_allclose(tm.kf_t, ref.kf_t, atol=1e-4)
    v = ref.mp_valid
    np.testing.assert_allclose(tm.mp_pos[v], ref.mp_pos[v], atol=1e-3)


@pytest.mark.parametrize("sensor", [Sensor.IMU_STEREO, Sensor.IMU_RGBD])
def test_inertial_depth_sensors_run(sensor):
    """A stereo or RGB-D map with an IMU: initialized from depth on the
    first frame, tracked, the IMU samples queued and integrated."""
    seq = trender.vi_sequence(6, 160, 120, (100.0, 100.0, 80.0, 60.0), stereo_baseline=0.1)
    cam = TCamera.pinhole(100.0, 100.0, 80.0, 60.0, width=160, height=120, device=CPU)
    from orbslam3_tpu_torch.engine.system import SystemConfig
    cfg = SystemConfig(sensor=sensor, imu_calib=ImuCalib.create(),
                       map=TMC(features_per_frame=300),
                       tracker=TTC(n_features=300, bf=10.0, kf_ref_ratio=0.75))
    slam = TSlam(cam, cfg, device=CPU)
    assert slam._backend.fix_scale and slam._backend.bf == 10.0
    batches = trender.imu_batches(seq.frame_ts, seq.imu_ts, seq.gyro, seq.acc)
    depth = np.full((120, 160), 5000 * 4, np.uint16)
    for i in range(6):
        if sensor == Sensor.IMU_STEREO:
            out = slam.track_stereo(seq.images[i], seq.images_right[i], seq.frame_ts[i],
                                    imu=batches[i])
        else:
            out = slam.track_rgbd(seq.images[i], depth, seq.frame_ts[i], imu=batches[i],
                                  depth_factor=1.0 / 5000)
        if i == 0:
            assert out is not None  # initialized from depth
    tr = slam.trackers[0]
    assert tr.map.n_keyframes >= 1 and tr._pre_cur is not None
