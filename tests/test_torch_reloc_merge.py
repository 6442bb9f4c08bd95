"""Port parity, CPU: map merging, the inertial seam BA, relocalization, the
tracker's relocalization rungs, localization mode and `change_dataset`.

JAX maps are built with numpy from seeds (the JAX package's
`tests/test_merge_graph.py`, `test_merge_inertial.py` and
`test_loop_closing.py` scenes) and carried to the port by `convert`; the
reference's RANSAC samples are injected into the port. Tolerances:

- `_merge_maps` (weld, seam fuse, welding-window BA, merge essential
  graph, global BA inline): the same keyframe map and database rows,
  keyframe poses within 1e-3, the welded-in far end within 5 cm of truth;
- `merge_inertial_ba`: the same windows, poses and velocities within 1e-3
  (relative to the largest entry), biases within 1e-3;
- `Slam._relocalize` on a converted map (K1 policy "reloc"): the same
  candidate and per-feature points, the pose within 1e-4;
- the rungs through `track_features`: a secondary client relocalizes on
  its first frame and tracks the next (poses within 1e-3); in
  localization mode a fresh or a lost lane relocalizes and no keyframe is
  made; the event logs equal the reference's;
- `change_dataset`: a mature map is stored and a fresh one spawned, a
  young one reset with its database rows, as the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import test_loop_closing as jloop
import test_merge_graph as jmerge
import test_merge_inertial as jmi
from orbslam3_tpu.engine.loop_closing import LoopCloser as JLoopCloser
from orbslam3_tpu.engine.loop_closing import LoopCloserConfig as JLCConfig
from orbslam3_tpu.engine.system import Slam as JSlam
from orbslam3_tpu.engine.system import SystemConfig as JSystemConfig
from orbslam3_tpu.engine.tracking import TrackerConfig as JTrackerConfig
from orbslam3_tpu.engine.tracking import TrackingState as JState
from orbslam3_tpu.imu import init as jinit
from orbslam3_tpu.place.database import KeyFrameDatabase as JDB
from orbslam3_tpu.place.vocab import build_vocabulary
from orbslam3_tpu.slam_map.atlas import Atlas as JAtlas
from orbslam3_tpu.slam_map.map_state import MapConfig as JMapConfig
from orbslam3_tpu.vision.frame import FrameFeatures as JFeatures
from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.core.camera import Camera as TCamera
from orbslam3_tpu_torch.engine.loop_closing import LoopCloser, LoopCloserConfig
from orbslam3_tpu_torch.engine.system import Slam, SystemConfig
from orbslam3_tpu_torch.engine.tracking import TrackerConfig, TrackingState
from orbslam3_tpu_torch.imu import init as tinit
from orbslam3_tpu_torch.place.database import KeyFrameDatabase
from orbslam3_tpu_torch.slam_map.atlas import Atlas
from orbslam3_tpu_torch.slam_map.map_state import MapConfig
from test_torch_loop import jax_sampler, port_atlas
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TCAM = TCamera.pinhole(458.0, 457.0, 376.0, 240.0, device="cpu")


def close(got, ref, rtol):
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * max(np.abs(ref).max(), 1e-30))


# ------------------------------------------------------------------- merges
def _two_maps():
    """The JAX package's merge scene (`test_merge_graph._two_map_merge`):
    stored map A over the first 12 of 18 circle poses at truth, active map
    B over the last 9 in a drifted world, the seam Sim3 perturbed."""
    rng = np.random.default_rng(31)
    cfg = JMapConfig(max_keyframes=64, max_points=8192, features_per_frame=512)
    atlas = JAtlas(cfg)
    m_old = atlas.active
    M = 18
    R_true, t_true = jmerge.circle_poses(M)
    pts = rng.uniform(-1.5, 1.5, (600, 3)).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (600, 8), dtype=np.uint32)
    ids_a = m_old.add_points(pts, desc, first_kf=0)
    kfs_a, prev = [], -1
    for i in range(12):
        prev = jmerge.add_kf(m_old, i, R_true[i], t_true[i], pts, ids_a, desc, prev)
        kfs_a.append(prev)
    mid_b = atlas.create_new_map()
    m_b = atlas.maps[mid_b]
    G = Rotation.from_rotvec([0, 0, 0.04]).as_matrix().astype(np.float32)
    g_t = np.array([0.2, -0.15, 0.1], np.float32)
    ids_b = m_b.add_points((pts @ G.T + g_t).astype(np.float32), desc, first_kf=0)
    kfs_b, prev = [], -1
    for i in range(9, M):
        R_off = (R_true[i] @ G.T).astype(np.float32)
        t_off = (t_true[i] - R_off @ g_t).astype(np.float32)
        j = i - 9
        prev = jmerge.add_kf(m_b, i, R_off, t_off, (pts @ G.T + g_t).astype(np.float32),
                             ids_b, desc, prev, subset=np.arange(60 * j, min(60 * j + 180, 600)))
        kfs_b.append(prev)
    cur, cand = kfs_b[0], kfs_a[9]
    R_cur, t_cur = m_b.kf_R[cur], m_b.kf_t[cur]
    R_ca = R_cur @ G @ m_old.kf_R[cand].T
    t_ca = t_cur + R_cur @ g_t - R_ca @ m_old.kf_t[cand]
    P = Rotation.from_rotvec([0, 0, 0.004]).as_matrix().astype(np.float32)
    seam = (cur, cand, 1.0, (P @ R_ca).astype(np.float32),
            (t_ca + np.array([0.03, 0.02, 0.0], np.float32)).astype(np.float32))
    voc = build_vocabulary(rng.integers(0, 2 ** 32, (600, 8), dtype=np.uint32), k=6, depth=3)
    return atlas, mid_b, kfs_b, seam, voc, R_true, t_true


def test_merge_maps_matches_jax():
    atlas, mid_b, kfs_b, (cur, cand, s, R, t), voc, R_true, t_true = _two_maps()
    atlas.change_map(mid_b)
    tatlas = port_atlas(atlas)
    kw = dict(fix_scale=True, gba_iters=5, run_global_ba=True)
    jlc = JLoopCloser(jloop.CAM, atlas, JDB(voc, max_keyframes=64), JLCConfig(**kw))
    tlc = LoopCloser(TCAM, tatlas, KeyFrameDatabase(convert.vocabulary(voc), max_keyframes=64,
                                                    device="cpu"),
                     LoopCloserConfig(**kw), device="cpu")
    jlc.gba_background = tlc.gba_background = False
    jev = jlc._merge_maps(atlas.maps[mid_b], cur, atlas.maps[0], cand, s, R, t, 50)
    tev = tlc._merge_maps(tatlas.maps[mid_b], cur, tatlas.maps[0], cand, s, R, t, 50)
    assert tev.kf_map == jev.kf_map and (tev.kind, tev.kf, tev.matched_kf) == \
        (jev.kind, jev.kf, jev.matched_kf)
    assert sorted(tatlas.maps) == sorted(atlas.maps) == [0] and tatlas.active_id == 0
    jm, tm = atlas.maps[0], tatlas.maps[0]
    ids = jm.keyframe_ids()
    np.testing.assert_array_equal(tm.keyframe_ids(), ids)
    np.testing.assert_allclose(tm.kf_R[ids], jm.kf_R[ids], atol=1e-3)
    np.testing.assert_allclose(tm.kf_t[ids], jm.kf_t[ids], atol=1e-3)
    np.testing.assert_array_equal(tm.mp_valid, jm.mp_valid)
    assert tlc.gba.n_finished == jlc.gba.n_finished == 1
    assert tlc.db._row == jlc.db._row
    far = [tev.kf_map[k] for k in kfs_b[-4:]]
    err = jmerge.centers_err(tm, far, R_true, t_true, range(14, 18))
    assert float(err.mean()) < 0.05


@pytest.fixture
def two_chains(monkeypatch):
    monkeypatch.setattr(jmi, "RNG", np.random.default_rng(31))
    m, calib, traj, ca, cb = jmi._build_two_chain_map(perturb=0.05)
    return m, calib, ca, cb


def test_merge_inertial_ba_matches_jax(two_chains):
    jm, calib, ca, cb = two_chains
    tm = convert.map_state(jm, device="cpu")
    tcal = convert.imu_calib(calib, device="cpu")
    cam = TCamera.pinhole(400.0, 400.0, 320.0, 240.0, width=640, height=480, device="cpu")
    for root in (cb[-1], ca[-1]):
        jk, jp = jinit._window_back(jm, root, 5)
        tk, tp = tinit._window_back(tm, root, 5)
        assert tk == jk and len(tp) == len(jp) == 5
    assert jinit.merge_inertial_ba(jm, calib, jmi.CAM, cb[-1], ca[-1], window=5) is not None
    assert tinit.merge_inertial_ba(tm, tcal, cam, cb[-1], ca[-1], window=5,
                                   device="cpu") is not None
    ks = ca + cb
    close(tm.kf_t[ks], jm.kf_t[ks], 1e-3)
    close(tm.kf_R[ks], jm.kf_R[ks], 1e-3)
    close(tm.kf_vel[ks], jm.kf_vel[ks], 1e-3)
    np.testing.assert_allclose(tm.kf_bias[ks], jm.kf_bias[ks], atol=1e-3)
    # both roots on one chain: one window, as the reference
    jm2, tm2 = jm, convert.map_state(jm, device="cpu")
    jinit.merge_inertial_ba(jm2, calib, jmi.CAM, cb[-1], cb[-2], window=5)
    tinit.merge_inertial_ba(tm2, tcal, cam, cb[-1], cb[-2], window=5, device="cpu")
    close(tm2.kf_t[cb], jm2.kf_t[cb], 1e-3)


# ----------------------------------------------------------- relocalization
N_FEAT = 512


def _features(rng, m, R, t, n_bits=3):
    """The frame a camera at (R, t) sees of the map's points: projections
    and descriptors with a few bits flipped, padded to N_FEAT."""
    live = np.nonzero(m.mp_valid)[0]
    xc = m.mp_pos[live] @ R.T + t
    uv = np.asarray(jloop.CAM.project(jnp.asarray(xc)))
    vis = (xc[:, 2] > 0.5) & (np.abs(uv[:, 0] - 376) < 370) & (np.abs(uv[:, 1] - 240) < 235)
    sel = np.nonzero(vis)[0][:N_FEAT]
    n = len(sel)
    desc = np.zeros((N_FEAT, 8), np.uint32)
    desc[:n] = m.mp_desc[live[sel]]
    for i in range(n):
        for b in rng.choice(256, n_bits, replace=False):
            desc[i, b // 32] ^= np.uint32(1 << (b % 32))
    uvp = np.zeros((N_FEAT, 2), np.float32)
    uvp[:n] = uv[sel] + rng.normal(0, 0.3, (n, 2))
    valid = np.arange(N_FEAT) < n
    z = np.zeros(N_FEAT, np.float32)
    arrays = (uvp, uvp, z + 1.0, z, np.zeros(N_FEAT, np.int32), desc, valid)
    jf = JFeatures(*(jnp.asarray(a) for a in arrays))
    return jf, convert.frame_features(*arrays, device="cpu")


def _reloc_sampler(seed, valid):
    key = jax.random.PRNGKey(seed)
    v = jnp.asarray(valid, jnp.float32)
    probs = v / jnp.maximum(v.sum(), 1.0)
    return np.asarray(jax.random.categorical(
        key, jnp.log(probs + 1e-20)[None, :].repeat(256 * 6, 0)).reshape(256, 6))


def _pose_between(R_true, t_true, i, f):
    """A camera a fraction f of the way from circle pose i to i+1."""
    c0, c1 = -R_true[i].T @ t_true[i], -R_true[i + 1].T @ t_true[i + 1]
    c = (1 - f) * c0 + f * c1
    z = -c / np.linalg.norm(c)
    x = np.cross([0, 0, 1.0], z)
    x /= np.linalg.norm(x)
    R = np.stack([x, np.cross(z, x), z], 1).T.astype(np.float32)
    return R, (-R @ c).astype(np.float32)


@pytest.fixture
def slams():
    """Both packages' Slam (mono, loop closing on) over the JAX tests'
    noisy 10-keyframe circle map, its keyframes in the database."""
    jm, R_true, t_true, _, _, _ = jloop.TestGlobalBA()._noisy_map()
    jm.update_point_stats(np.nonzero(jm.mp_valid)[0])  # scale bands, normals
    voc = build_vocabulary(np.random.default_rng(3).integers(0, 2 ** 32, (1000, 8),
                                                             dtype=np.uint32), k=6, depth=3)
    mcfg = dict(max_keyframes=64, max_points=4096, features_per_frame=N_FEAT)
    js = JSlam(jloop.CAM, JSystemConfig(map=JMapConfig(**mcfg),
                                        tracker=JTrackerConfig(n_features=N_FEAT)), vocab=voc)
    ts = Slam(TCAM, SystemConfig(map=MapConfig(**mcfg), tracker=TrackerConfig(n_features=N_FEAT)),
              vocab=convert.vocabulary(voc), device="cpu")
    ts.reloc_sample_fn = _reloc_sampler
    tm = convert.map_state(jm, device="cpu")
    for slam, m in ((js, jm), (ts, tm)):
        slam.atlas.maps[0] = m
        slam._rebind_all_trackers()
        slam.loop_closer.gba_background = False
        for k in m.keyframe_ids():
            slam.db.add(int(k), slam.db.compute_bow(m.kf_desc[k], m.kf_feat_valid[k])[1], 0)
    return js, ts, jm, R_true, t_true


def test_relocalize_matches_jax(slams):
    js, ts, jm, R_true, t_true = slams
    rng = np.random.default_rng(4)
    R, t = _pose_between(R_true, t_true, 3, 0.4)
    jf, tf = _features(rng, jm, R, t)
    ref, got = js._relocalize(jf), ts._relocalize(tf)
    assert ref is not None and got is not None
    assert got[3] == ref[3]
    np.testing.assert_array_equal(got[2], np.asarray(ref[2]))
    np.testing.assert_allclose(got[0], np.asarray(ref[0]), atol=1e-4)
    np.testing.assert_allclose(got[1], np.asarray(ref[1]), atol=1e-4)
    np.testing.assert_allclose(got[1], t, atol=0.02)
    assert [e for e in ts.events if e["event"] == "relocalized"] == \
        [e for e in js.events if e["event"] == "relocalized"]


def test_secondary_client_relocalizes_then_tracks(slams):
    js, ts, jm, R_true, t_true = slams
    rng = np.random.default_rng(5)
    js.add_client(1)
    ts.add_client(1)
    for i, f in enumerate((0.3, 0.45, 0.6)):
        R, t = _pose_between(R_true, t_true, 5, f)
        jf, tf = _features(rng, jm, R, t)
        ref = js.track_features(jf, 1.0 + 0.05 * i, client_id=1)
        got = ts.track_features(tf, 1.0 + 0.05 * i, client_id=1)
        assert ref is not None and got is not None
        np.testing.assert_allclose(got[0], ref[0], atol=1e-3)
        np.testing.assert_allclose(got[1], ref[1], atol=1e-3)
        np.testing.assert_allclose(got[1], t, atol=0.1)
        assert ts.trackers[1].state == TrackingState.OK
    assert sum(e["event"] == "relocalized" for e in ts.events) == 1
    assert [e["event"] for e in ts.events] == [e["event"] for e in js.events]


def test_localization_mode_relocalizes_and_makes_no_keyframe(slams):
    js, ts, jm, R_true, t_true = slams
    rng = np.random.default_rng(6)
    for slam in (js, ts):
        slam.activate_localization_mode()
    assert ts.trackers[0].only_tracking and ts._localization_only
    uid0 = int(ts.atlas.active._next_uid)
    for i, f in enumerate((0.2, 0.35, 0.5, 0.65)):
        R, t = _pose_between(R_true, t_true, 2, f)
        jf, tf = _features(rng, jm, R, t)
        if i == 2:  # a lost lane keeps relocalizing while the map is frozen
            js.trackers[0].state = JState.LOST
            ts.trackers[0].state = TrackingState.LOST
        ref = js.track_features(jf, 2.0 + 0.05 * i)
        got = ts.track_features(tf, 2.0 + 0.05 * i)
        assert ref is not None and got is not None
        np.testing.assert_allclose(got[1], ref[1], atol=1e-3)
        np.testing.assert_allclose(got[1], t, atol=0.1)
    assert int(ts.atlas.active._next_uid) == uid0 == int(js.atlas.active._next_uid)
    assert sum(e["event"] == "relocalized" for e in ts.events) >= 2
    assert [e["event"] for e in ts.events] == [e["event"] for e in js.events]
    for slam in (js, ts):
        slam.deactivate_localization_mode()
    assert not ts.trackers[0].only_tracking and not ts._localization_only


@pytest.mark.parametrize("n_kfs", [10, 12])
def test_change_dataset_matches_jax(n_kfs, slams):
    """A map of more than 10 keyframes is stored and a fresh one spawned;
    a smaller one is reset and its database rows cleared."""
    js, ts, jm, _, _ = slams
    for slam in (js, ts):
        m = slam.atlas.active
        if n_kfs == 12:  # two more keyframes: copies of the last one
            k = int(m.keyframe_ids()[-1])
            for _ in range(2):
                m.add_keyframe(m.kf_R[k], m.kf_t[k], 9.0, 9, m.kf_uv[k], m.kf_octave[k],
                               m.kf_angle[k], m.kf_desc[k], m.kf_feat_valid[k], m.kf_obs_mp[k],
                               prev_kf=k)
        slam.change_dataset()
    assert sorted(ts.atlas.maps) == sorted(js.atlas.maps)
    assert ts.atlas.active_id == js.atlas.active_id
    assert ts.atlas.active.n_keyframes == js.atlas.active.n_keyframes == 0
    assert ts.trackers[0].map is ts.atlas.active
    assert [e for e in ts.events if e["event"] in ("dataset_change", "map_reset")] == \
        [e for e in js.events if e["event"] in ("dataset_change", "map_reset")]
    assert bool(ts.db.active.any()) == bool(js.db.active.any()) == (n_kfs == 12)


@pytest.mark.parametrize("sensor", ["MONOCULAR", "STEREO", "RGBD", "IMU_MONOCULAR",
                                    "IMU_STEREO", "IMU_RGBD"])
def test_vocabulary_runs_on_every_sensor(sensor):
    """`Slam(..., vocab=...)` tracks on every sensor: the loop closer's
    gauge follows the sensor (SE3 but for mono, 4-DoF with an IMU), every
    keyframe the mapper processed has its database row, and the lanes carry
    the relocalizer and the vocabulary's words."""
    from orbslam3_tpu_torch.datasets import render as trender
    from orbslam3_tpu_torch.engine.system import Sensor
    from orbslam3_tpu_torch.imu.preintegration import ImuCalib
    from orbslam3_tpu_torch.place.vocab import build_vocabulary as tbuild
    s = Sensor[sensor]
    seq = trender.vi_sequence(6, 160, 120, (100.0, 100.0, 80.0, 60.0), stereo_baseline=0.1)
    cam = TCamera.pinhole(100.0, 100.0, 80.0, 60.0, width=160, height=120, device="cpu")
    depth_sensor = s in (Sensor.STEREO, Sensor.RGBD, Sensor.IMU_STEREO, Sensor.IMU_RGBD)
    cfg = SystemConfig(sensor=s, imu_calib=ImuCalib.create() if "IMU" in sensor else None,
                       map=MapConfig(features_per_frame=300),
                       tracker=TrackerConfig(n_features=300, bf=10.0 if depth_sensor else 0.0,
                                             kf_ref_ratio=0.75, kf_max_interval=2))
    voc = tbuild(np.random.default_rng(0).integers(0, 2 ** 32, (400, 8), dtype=np.uint32),
                 k=4, depth=3)
    slam = Slam(cam, cfg, vocab=voc, device="cpu")
    lc = slam.loop_closer
    assert lc.cfg.fix_scale == (s != Sensor.MONOCULAR)
    assert lc.cfg.inertial == ("IMU" in sensor) and (lc.imu_calib is not None) == lc.cfg.inertial
    batches = trender.imu_batches(seq.frame_ts, seq.imu_ts, seq.gyro, seq.acc)
    depth = np.full((120, 160), 5000 * 4, np.uint16)
    for i in range(6):
        imu = batches[i] if "IMU" in sensor else None
        if s in (Sensor.STEREO, Sensor.IMU_STEREO):
            slam.track_stereo(seq.images[i], seq.images_right[i], seq.frame_ts[i], imu=imu)
        elif s in (Sensor.RGBD, Sensor.IMU_RGBD):
            slam.track_rgbd(seq.images[i], depth, seq.frame_ts[i], imu=imu,
                            depth_factor=1.0 / 5000)
        else:
            slam.track_monocular(seq.images[i], seq.frame_ts[i], imu=imu)
    m = slam.atlas.active
    # the initial keyframes (one from depth, two from two views) never pass
    # through the mapper, so they get no row, as in the reference
    init_kfs = (1 if depth_sensor else 2) if m.n_keyframes else 0
    rows = slam.db.slot_of[slam.db.active]
    assert len(rows) == m.n_keyframes - init_kfs and m.kf_valid[rows].all()
    assert m.n_keyframes >= (2 if depth_sensor else 0)
    tr = slam.trackers[0]
    assert tr.relocalizer is not None and tr.bow_k == 4 and tr.bow_fn is not None
