"""Port parity, CPU: the IMU initialization ladder (`imu/init`) on a JAX
map carried over by `convert.map_state`, and the mono-inertial entry
points that now run (and the parts that still raise).

The map: nine keyframes 0.25 s apart on a simulated IMU trajectory (body ==
camera), seen in a rotated world at 1/2.5 of metric scale, with the
preintegration between consecutive keyframes, and 150 landmarks observed
with 0.5 px noise. Tolerances, relative to the largest entry compared:
keyframe poses and velocities 1e-4, biases 1e-3 (the accelerometer bias,
held by a weak prior, is the least observed state), landmarks 1e-3 m; the
flags, the chain and the re-gauge count exact."""

import numpy as np
import jax.numpy as jnp
import pytest

from orbslam3_tpu.core.camera import Camera as JCamera
from orbslam3_tpu.imu import init as jinit
from orbslam3_tpu.imu import preintegration as jpre
from orbslam3_tpu.slam_map.map_state import MapConfig as JMC, MapState as JMS
from orbslam3_tpu.utils import synth as jsynth
from orbslam3_tpu.utils.synth import simulate_imu
from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.core.camera import Camera as TCamera
from orbslam3_tpu_torch.engine.local_mapping import LocalMapper
from orbslam3_tpu_torch.engine.system import Sensor, Slam, SystemConfig
from orbslam3_tpu_torch.engine.tracking import Tracker, TrackerConfig
from orbslam3_tpu_torch.imu import init as tinit
from orbslam3_tpu_torch.imu import preintegration as tpre
from orbslam3_tpu_torch.slam_map.map_state import MapConfig, MapState
from torch_parity import np_

JCAL = jpre.ImuCalib.create()
TCAL = convert.imu_calib(JCAL, device="cpu")
JCAM = JCamera.pinhole(400.0, 400.0, 320.0, 240.0, width=640, height=480)
TCAM = TCamera.pinhole(400.0, 400.0, 320.0, 240.0, width=640, height=480, device="cpu")
N_FEAT = 160


def close(got, ref, rtol):
    np.testing.assert_allclose(np_(got), np_(ref), rtol=0,
                               atol=rtol * max(np.abs(np_(ref)).max(), 1e-30))


def _jax_map():
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(5)
    traj = simulate_imu(duration=2.6, seed=9, gyro_bias=(0.01, -0.02, 0.015),
                        acc_bias=(0.05, 0.08, -0.06))
    idx = [100 + 50 * k for k in range(9)]
    Rp = Rotation.from_rotvec([0.25, -0.15, 0.7]).as_matrix()
    s_true = 2.5
    m = JMS(JMC(max_keyframes=16, max_points=256, features_per_frame=N_FEAT))
    # landmarks in front of the middle keyframe, in the vision world
    mid = idx[4]
    xc = np.stack([rng.uniform(-2.5, 2.5, 150), rng.uniform(-2, 2, 150),
                   rng.uniform(3, 8, 150)], -1)
    X_true = xc @ traj.R_wb[mid].T + traj.p_wb[mid]
    ids = m.add_points(pos=np.asarray((X_true @ Rp.T) / s_true, np.float32),
                       desc=rng.integers(0, 2 ** 32, (150, 8), dtype=np.uint32), first_kf=0)
    prev = -1
    for k, i in enumerate(idx):
        R_wb = Rp @ traj.R_wb[i]
        p_wb = Rp @ traj.p_wb[i] / s_true
        R_cw, t_cw = R_wb.T, -R_wb.T @ p_wb
        xo = (X_true - traj.p_wb[i]) @ traj.R_wb[i]
        uv = np.asarray(JCAM.project(jnp.asarray(xo, jnp.float32)))
        seen = np.nonzero((xo[:, 2] > 1.0) & (uv[:, 0] >= 0) & (uv[:, 0] < 640)
                          & (uv[:, 1] >= 0) & (uv[:, 1] < 480))[0][:N_FEAT]
        kuv = np.zeros((N_FEAT, 2), np.float32)
        obs = np.full(N_FEAT, -1, np.int32)
        valid = np.zeros(N_FEAT, bool)
        kuv[:len(seen)] = uv[seen] + rng.normal(0, 0.5, (len(seen), 2))
        obs[:len(seen)] = ids[seen]
        valid[:len(seen)] = True
        pre = None
        if k > 0:
            a, b = idx[k - 1], i
            pre = jpre.preintegrate(*(jnp.asarray(np.asarray(x[a:b], np.float32))
                                      for x in (traj.acc, traj.gyro, traj.dt)),
                                    jnp.zeros(6, jnp.float32), JCAL)
        prev = m.add_keyframe(R_cw.astype(np.float32), t_cw.astype(np.float32),
                              traj.t[i], k, kuv, np.zeros(N_FEAT, np.int32),
                              np.zeros(N_FEAT, np.float32),
                              rng.integers(0, 2 ** 32, (N_FEAT, 8), dtype=np.uint32),
                              valid, obs, prev_kf=prev, preint=pre)
    m.update_point_stats(ids)
    return m


def _check_maps(tm: MapState, jm: JMS):
    assert tm.imu_initialized == jm.imu_initialized
    assert (tm.iba_stage, tm.gauge_epoch) == (jm.iba_stage, jm.gauge_epoch)
    ks = jm.keyframe_ids()
    np.testing.assert_array_equal(tm.keyframe_ids(), ks)
    close(tm.kf_R[ks], jm.kf_R[ks], 1e-4)
    close(tm.kf_t[ks], jm.kf_t[ks], 1e-4)
    close(tm.kf_vel[ks], jm.kf_vel[ks], 1e-4)
    close(tm.kf_bias[ks], jm.kf_bias[ks], 1e-3)
    live = jm.mp_valid
    np.testing.assert_array_equal(tm.mp_valid, live)
    np.testing.assert_allclose(tm.mp_pos[live], jm.mp_pos[live], rtol=0, atol=1e-3)


def test_map_state_carries_the_inertial_state():
    jm = _jax_map()
    tm = convert.map_state(jm, device="cpu")
    _check_maps(tm, jm)
    assert sorted(tm.kf_pre) == sorted(jm.kf_pre)
    for k, p in jm.kf_pre.items():
        for a, b in zip(tm.kf_pre[k], p):
            np.testing.assert_array_equal(np_(a), np_(b))
    kj, pj = jinit.chain_with_preint(jm)
    kt, pt = tinit.chain_with_preint(tm)
    assert kt == kj and len(pt) == len(pj) == 8
    assert tinit.temporal_chain(tm) == jinit.temporal_chain(jm)
    for a, b in zip(tinit.body_poses(tm, kt, TCAL, "cpu"), jinit.body_poses(jm, kj, JCAL)):
        np.testing.assert_allclose(np_(a), np_(b), rtol=0, atol=1e-6)


def test_apply_scaled_rotation_matches_jax():
    jm = _jax_map()
    tm = convert.map_state(jm, device="cpu")
    from scipy.spatial.transform import Rotation
    Rgw = Rotation.from_rotvec([0.4, -0.3, 1.1]).as_matrix().astype(np.float32)
    jm.apply_scaled_rotation(Rgw, 1.7)
    tm.apply_scaled_rotation(Rgw, 1.7)
    _check_maps(tm, jm)
    np.testing.assert_array_equal(tm.mp_normal, jm.mp_normal)
    np.testing.assert_array_equal(tm.mp_max_dist, jm.mp_max_dist)
    assert tm.last_gauge[1] == jm.last_gauge[1]


def test_initialize_imu_and_full_inertial_ba_match_jax():
    """The first rung (with its re-gauge) and the full VI-BA after it, then
    the windowed VI-BA with the init-stage priors, on both maps."""
    jm = _jax_map()
    tm = convert.map_state(jm, device="cpu")
    out_j = jinit.initialize_imu(jm, JCAL, prior_gyro=1.0, prior_acc=1e3)
    out_t = tinit.initialize_imu(tm, TCAL, prior_gyro=1.0, prior_acc=1e3, device="cpu")
    assert out_j is not None and out_t is not None
    np.testing.assert_allclose(float(out_t.scale), float(out_j.scale), rtol=1e-4)
    _check_maps(tm, jm)
    assert jm.imu_initialized and jm.gauge_epoch == 1
    cj = jinit.full_inertial_ba(jm, JCAL, JCAM, n_iters=6, fix_first=False,
                                prior_gyro=1e2, prior_acc=1e10)
    ct = tinit.full_inertial_ba(tm, TCAL, TCAM, n_iters=6, fix_first=False,
                                prior_gyro=1e2, prior_acc=1e10, device="cpu")
    np.testing.assert_allclose(np_(ct), np_(cj), rtol=1e-3)
    _check_maps(tm, jm)
    cj = jinit.full_inertial_ba(jm, JCAL, JCAM, n_iters=4, window=5,
                                prior_gyro=1.0, prior_acc=1e5)
    ct = tinit.full_inertial_ba(tm, TCAL, TCAM, n_iters=4, window=5, prior_gyro=1.0,
                                prior_acc=1e5, device="cpu")
    np.testing.assert_allclose(np_(ct), np_(cj), rtol=1e-3)
    _check_maps(tm, jm)


def test_initialize_imu_needs_a_chain():
    """With the preintegration into the fifth keyframe gone, the longest
    chain holds five keyframes, under the six a rung needs: neither package
    solves, and the map stays visual."""
    jm = _jax_map()
    del jm.kf_pre[int(jm.keyframe_ids()[4])]
    tm = convert.map_state(jm, device="cpu")
    assert len(tinit.chain_with_preint(tm)[0]) == 5
    assert tinit.initialize_imu(tm, TCAL, device="cpu") is None
    assert jinit.initialize_imu(jm, JCAL) is None
    assert not tm.imu_initialized and not jm.imu_initialized


def test_config_loader_raises():
    """The YAML settings loader is ported (tests/test_torch_stereo.py holds
    it to the JAX package); what it still raises on is YAML outside the
    subset ORB-SLAM3's configs use."""
    from orbslam3_tpu_torch.config import Settings
    with pytest.raises(ValueError, match="unsupported value for IMU.T_b_c1"):
        Settings.from_text("%YAML:1.0\nIMU.T_b_c1: [1, 0, 0]\n", sensor="imu-monocular")


def test_merge_inertial_ba_raises():
    """`merge_inertial_ba` is ported (tests/test_torch_reloc_merge.py holds
    it to the JAX package); on a map without an inertial chain it has
    nothing to solve and returns None, as the reference."""
    m = MapState(MapConfig(16, 64, 8), device="cpu")
    assert tinit.merge_inertial_ba(m, TCAL, TCAM, 0, 1) is None


@pytest.mark.parametrize("sensor", [Sensor.IMU_STEREO, Sensor.IMU_RGBD])
def test_other_inertial_sensors_raise(sensor, tmp_path):
    """Stereo- and RGB-D-inertial SLAM run with a vocabulary: loop closing
    with a fixed scale and the inertial gauge, and saving an atlas (slice
    F, which a fresh `Slam` of the sensor loads with its database). What
    still raises on them is a missing IMU calibration."""
    from orbslam3_tpu_torch.place.vocab import build_vocabulary
    voc = build_vocabulary(np.random.default_rng(0).integers(0, 2 ** 32, (200, 8),
                                                             dtype=np.uint32), k=4, depth=2)
    slam = Slam(TCAM, SystemConfig(sensor=sensor, imu_calib=TCAL), vocab=voc, device="cpu")
    assert slam.loop_closer.cfg.fix_scale and slam.loop_closer.cfg.inertial
    assert slam.trackers[0].relocalizer is not None and slam.trackers[0].bow_k == 4
    slam.save_atlas(str(tmp_path / "atlas.npz"))
    back = Slam(TCAM, SystemConfig(sensor=sensor, imu_calib=TCAL), vocab=voc,
                load_atlas_from=str(tmp_path / "atlas.npz"), device="cpu")
    assert sorted(back.atlas.maps) == [0, 1] and back.atlas.active_id == 1
    with pytest.raises(ValueError, match="needs SystemConfig.imu_calib"):
        Slam(TCAM, SystemConfig(sensor=sensor), device="cpu")


def test_inertial_tracker_and_mapper_construct_and_queue():
    m = MapState(MapConfig(16, 64, 8), device="cpu")
    calib = tpre.ImuCalib.create()
    mapper = LocalMapper(TCAM, m, imu_calib=calib, device="cpu")
    tr = Tracker(TCAM, m, TrackerConfig(n_features=8), local_mapper=mapper,
                 imu_calib=calib, device="cpu")
    tr.queue_imu([(0.005, [0.0, 0.1, 0.0], [0.0, 0.0, 9.81]),
                  (0.010, np.zeros(3), np.array([0.0, 0.0, 9.81]))])
    assert len(tr._imu_queue) == 2 and tr._imu_queue[1][2].dtype == np.float32
    tr._last_ts = 0.0
    pre = tr._preintegrate_to(0.01)
    assert float(pre.dT) == pytest.approx(0.01)
    assert tr._imu_queue == []
    with pytest.raises(ValueError, match="imu_calib"):
        Slam(TCAM, SystemConfig(sensor=Sensor.IMU_MONOCULAR), device="cpu")


def test_track_features_with_imu_runs():
    """`Slam(IMU_MONOCULAR).track_features(..., imu=...)` on a few
    feature-level frames: the samples reach the tracker, the map
    initializes, and the keyframes carry the preintegration chain."""
    from orbslam3_tpu_torch.datasets.render import imu_batches, vi_sequence
    seq = vi_sequence(6, render=False)
    world = jsynth.make_world(n_points=3000, seed=4)
    cam = JCamera.pinhole(458.0, 458.0, 320.0, 240.0, width=640, height=480)
    tcam = TCamera.pinhole(458.0, 458.0, 320.0, 240.0, width=640, height=480, device="cpu")
    slam = Slam(tcam, SystemConfig(sensor=Sensor.IMU_MONOCULAR, imu_calib=TCAL,
                                   map=MapConfig(64, 8192, 600),
                                   tracker=TrackerConfig(n_features=600)), device="cpu")
    batches = imu_batches(seq.frame_ts, seq.imu_ts, seq.gyro, seq.acc)
    out = []
    for i in range(6):
        f = jsynth.render_features(world, seq.R_cw[i], seq.t_cw[i], cam, capacity=600,
                                   seed=100 + i)[0]
        feats = convert.frame_features(*(np.asarray(getattr(f, k)) for k in
                                         ("uv", "uv_raw", "response", "angle", "octave",
                                          "desc", "valid")), device="cpu")
        out.append(slam.track_features(feats, float(seq.frame_ts[i]), imu=batches[i]))
    assert any(o is not None for o in out)
    m = slam.trackers[0].map
    ks = m.keyframe_ids()
    assert len(ks) >= 2 and len(m.kf_pre) >= 1
    assert all(float(p.dT) > 0.04 for p in m.kf_pre.values())
    assert slam.print_info()["imu_initialized"] is False
