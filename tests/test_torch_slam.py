"""The port's monocular SLAM entry point and its host-side helpers, CPU:
the `extract_features` capacity repair, the renderer against the
reference's OpenCV renderer, `evaluation`, `utils/timing`'s span recorder,
the parts that are not ported yet raising, and a short image-level run of
`Slam.track_monocular` that initializes and tracks, with its spans."""

import threading
import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orbslam3_tpu import evaluation as jeval
from orbslam3_tpu.datasets import render as jrender
from orbslam3_tpu.vision import frame as jframe
from orbslam3_tpu_torch import evaluation as teval
from orbslam3_tpu_torch.core.camera import Camera
from orbslam3_tpu_torch.datasets import render as trender
from orbslam3_tpu_torch.engine.system import Sensor, Slam, SystemConfig
from orbslam3_tpu_torch.engine.tracking import TrackerConfig
from orbslam3_tpu_torch.imu.init import merge_inertial_ba
from orbslam3_tpu_torch.slam_map.map_state import MapConfig
from orbslam3_tpu_torch.utils import timing
from orbslam3_tpu_torch.utils.synth import orbit_trajectory
from orbslam3_tpu_torch.vision import frame as tframe
from torch_parity import np_, textured_image


def test_extract_features_capacity_is_n_features_on_a_small_image():
    """A 120x160 image has fewer slots than 1000 features at its coarse
    levels (4 per 32-px cell); the capacity stays 1000, the padding rows
    are invalid, and every level keeps its quota of rows."""
    img = textured_image(5, 120, 160)
    f = tframe.extract_features(img, n_features=1000, device="cpu")
    assert f.capacity == 1000
    for name in ("uv", "response", "angle", "octave", "desc", "valid"):
        assert getattr(f, name).shape[0] == 1000, name
    quotas = tframe.level_quotas(1000, 8, 1.2)
    np.testing.assert_array_equal(np.bincount(np_(f.octave), minlength=8), quotas)
    valid = np_(f.valid)
    assert 0 < valid.sum() < 1000
    assert np.isfinite(np_(f.uv)).all()
    assert (np_(f.response)[~valid] == 0).all()


def test_extract_features_rows_match_jax_at_240x376():
    """Where the reference runs, the layout is its layout: same octaves and
    valid rows, keypoints within 1e-4 px (the pyramid resize's rounding),
    descriptors within 2 bits (none observed)."""
    img = textured_image(9, 240, 376)
    jf = jframe.extract_features(jnp.asarray(img), n_features=600)
    tf = tframe.extract_features(img, n_features=600, device="cpu")
    assert tf.capacity == 600
    np.testing.assert_array_equal(np_(tf.octave), np.asarray(jf.octave))
    np.testing.assert_array_equal(np_(tf.valid), np.asarray(jf.valid))
    v = np.asarray(jf.valid)
    np.testing.assert_allclose(np_(tf.uv)[v], np.asarray(jf.uv)[v], atol=1e-4)
    bits = np.unpackbits((np_(tf.desc)[v] ^ np.asarray(jf.desc)[v].view(np.int32))
                         .view(np.uint8), axis=1)
    assert bits.sum(1).max() <= 2


def test_renderer_matches_the_reference_within_one_grey_level():
    """The port renders without OpenCV; on BoxScene.default(seed=7) the
    images differ from the reference's by at most 1 grey level (the cubic
    texture resize's float rounding before the uint8 cast)."""
    fx, fy, cx, cy = 229.3, 228.6, 183.6, 124.2  # EuRoC cam0 at 376x240
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    sj, st = jrender.BoxScene.default(seed=7), trender.BoxScene.default(seed=7)
    worst = 0
    for j, t in zip(sj.textures, st.textures):
        worst = max(worst, int(np.abs(j.astype(int) - t.astype(int)).max()))
    Rs, ts = orbit_trajectory(n_frames=3, radius=2.0, center=(4, 2, 9), arc=0.1)
    for i in range(3):
        a = sj.render(K, Rs[i], ts[i], 376, 240, seed=i)
        b = st.render(K, Rs[i], ts[i], 376, 240, seed=i)
        worst = max(worst, int(np.abs(a.astype(int) - b.astype(int)).max()))
    assert worst <= 1, worst


def test_evaluation_matches_jax():
    rng = np.random.default_rng(0)
    gt = rng.normal(size=(50, 3))
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    R *= np.sign(np.linalg.det(R))
    est = 0.5 * (gt @ R.T) + [1.0, 2, 3] + rng.normal(0, 0.01, (50, 3))
    for a, b in zip(teval.umeyama_alignment(est, gt), jeval.umeyama_alignment(est, gt)):
        np.testing.assert_allclose(a, b)
    assert teval.ate_rmse(est, gt) == jeval.ate_rmse(est, gt) < 0.05
    ta, tb = np.sort(rng.uniform(0, 10, 40)), np.sort(rng.uniform(0, 10, 60))
    for a, b in zip(teval.associate(ta, tb, 0.1), jeval.associate(ta, tb, 0.1)):
        np.testing.assert_array_equal(a, b)


def test_timing_stages_and_counts():
    """`utils/timing.py`, the port's span recorder: nested stages get their
    parent, root, thread and fields, and each start and end lies between
    two `time.time_ns()` reads taken around it; a stage on another thread
    is its own root; a stage left by an exception closes; `stats()` keeps
    its series on perf_counter; `reset()` clears series, spans and counts;
    disabled, a stage keeps nothing and `count` still counts."""
    timing.reset()
    timing.enable(True)
    try:
        before = time.time_ns()
        with timing.stage("outer", client=3, frame=7):
            mid0 = time.time_ns()
            with timing.stage("inner"):
                pass
            mid1 = time.time_ns()
        after = time.time_ns()

        def on_another_thread():
            with timing.stage("other"):
                pass

        th = threading.Thread(target=on_another_thread)
        th.start()
        th.join(10)
        assert not th.is_alive()
        with pytest.raises(ValueError):
            with timing.stage("raised"):
                raise ValueError
        with timing.stage("after"):
            pass
        timing.count("k", 2)

        sp = {s.name: s for s in timing.spans()}
        assert [s.name for s in timing.spans()] == ["inner", "outer", "other", "raised", "after"]
        outer, inner, other = sp["outer"], sp["inner"], sp["other"]
        assert outer.parent == -1 and outer.root == outer.id
        assert inner.parent == outer.id and inner.root == outer.id and inner.id != outer.id
        assert dict(outer.fields) == {"client": 3, "frame": 7} and dict(inner.fields) == {}
        assert inner.thread == outer.thread == threading.get_ident() != other.thread
        assert other.parent == -1 and other.root == other.id
        assert sp["after"].parent == -1 and sp["after"].root == sp["after"].id
        assert (before <= outer.start_ns <= mid0 <= inner.start_ns <= inner.end_ns <= mid1
                <= outer.end_ns <= after)

        st = timing.stats()
        assert set(st) == {"outer", "inner", "other", "raised", "after"}
        assert set(st["outer"]) == {"n", "mean_ms", "median_ms", "p90_ms", "total_ms"}
        assert st["outer"]["n"] == 1 and st["outer"]["total_ms"] >= st["inner"]["total_ms"]
        assert st["outer"]["total_ms"] <= (after - before) * 1e-6
        assert timing.counts() == {"k": 2}

        timing.reset()
        assert timing.stats() == {} and timing.spans() == [] and timing.counts() == {}
        timing.enable(False)
        with timing.stage("off", client=0, frame=0):
            pass
        timing.count("k")
        assert timing.stats() == {} and timing.spans() == [] and timing.counts() == {"k": 1}
    finally:
        timing.enable(False)
        timing.reset()


CAM = Camera.pinhole(229.3, 228.6, 183.6, 124.2, width=376, height=240, device="cpu")


# what each case asks for; the slice that ported the last of it
UNPORTED = {"vocab": "F", "atlas": "F", "stereo": "F", "imu": "F", "async": "B",
            "track_stereo": "H", "track_imu": "F", "localization": "F", "tracker_bf": "H",
            "tracker_rectify": "F", "track_features_imu": "H"}


@pytest.mark.parametrize("what", list(UNPORTED))
def test_unported_parts_raise(what, tmp_path):
    """Each case once asked for a part that was not ported and raised
    NotImplementedError naming its slice. Every part is ported now (slice
    E: the vocabulary, loop closing, relocalization, localization mode,
    `merge_inertial_ba`; F: atlas load and save; H: `track_edge`; B's
    async mapping), so each case builds its `Slam` on its sensor and runs
    the part: loading an atlas (the maps and the database rows come back),
    saving one (it loads back with the same arrays), `track_edge` with a
    real wire packet (the lane takes the frame), `async_mapping=True` (the
    worker runs and stops). tests/test_torch_persist.py, test_torch_edge.py
    and test_torch_async.py hold these parts to the JAX package."""
    from orbslam3_tpu_torch.edge import wire
    from orbslam3_tpu_torch.engine.tracking import Tracker
    from orbslam3_tpu_torch.imu.preintegration import ImuCalib
    from orbslam3_tpu_torch.place.vocab import build_vocabulary
    from orbslam3_tpu_torch.slam_map import serialize
    from orbslam3_tpu_torch.slam_map.map_state import MapState
    from orbslam3_tpu_torch.vision.rectify import RectifyMaps
    cfg = SystemConfig()
    kw = {}
    if what in ("vocab", "stereo", "track_stereo", "track_imu", "localization",
                "tracker_bf", "track_features_imu"):
        kw["vocab"] = build_vocabulary(np.random.default_rng(0).integers(
            0, 2 ** 32, (200, 8), dtype=np.uint32), k=4, depth=2)
    if what in ("vocab", "atlas", "imu", "tracker_rectify"):
        # an atlas with one keyframe, saved by a plain session
        src = Slam(CAM, SystemConfig(), vocab=kw.get("vocab"), device="cpu")
        m = src.atlas.active
        m.add_keyframe(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 0.5, 3,
                       np.zeros((m.cfg.features_per_frame, 2), np.float32),
                       np.zeros(m.cfg.features_per_frame, np.int32),
                       np.zeros(m.cfg.features_per_frame, np.float32),
                       np.random.default_rng(1).integers(
                           0, 2 ** 32, (m.cfg.features_per_frame, 8), dtype=np.uint32),
                       np.ones(m.cfg.features_per_frame, bool),
                       np.full(m.cfg.features_per_frame, -1, np.int32))
        src.save_atlas(str(tmp_path / "atlas.npz"))
        kw["load_atlas_from"] = str(tmp_path / "atlas.npz")
    if what in ("stereo", "track_stereo", "tracker_bf"):
        cfg.sensor, cfg.tracker = Sensor.STEREO, TrackerConfig(bf=40.0)
    elif what in ("imu", "track_imu", "track_features_imu"):
        cfg.sensor = {"imu": Sensor.IMU_STEREO, "track_imu": Sensor.IMU_RGBD,
                      "track_features_imu": Sensor.IMU_MONOCULAR}[what]
        cfg.imu_calib = ImuCalib.create()
        cfg.tracker = TrackerConfig(bf=0.0 if what == "track_features_imu" else 40.0)
    elif what == "async":
        cfg.async_mapping = True
    elif what == "tracker_rectify":
        K = np.array([[229.3, 0, 183.6], [0, 228.6, 124.2], [0, 0, 1.0]])
        cfg.sensor = Sensor.STEREO
        cfg.tracker = TrackerConfig(bf=25.0, rectify=RectifyMaps(
            K, (-0.28, 0.07, 0, 0), K, (-0.28, 0.07, 0, 0), (376, 240), np.eye(3),
            np.array([-0.11, 0.0, 0.0]), device="cpu"))
    if what == "tracker_bf":  # a stereo lane with a relocalizer builds
        tr = Tracker(CAM, MapState(MapConfig(), device="cpu"), TrackerConfig(bf=40.0),
                     relocalizer=lambda feats: None, device="cpu")
        assert tr.relocalizer is not None
    slam = Slam(CAM, cfg, device="cpu", **kw)
    assert UNPORTED[what] in "BEFH"
    if "vocab" in kw:
        assert slam.loop_closer.cfg.fix_scale == (cfg.sensor != Sensor.MONOCULAR)
    if "load_atlas_from" in kw:
        assert sorted(slam.atlas.maps) == [0, 1] and slam.atlas.active_id == 1
        assert slam.atlas.maps[0].n_keyframes == 1
        if slam.db is not None:
            assert slam.db.row_for(0, 0) is not None
    if what in ("localization", "track_stereo"):
        slam.activate_localization_mode()
        assert slam.trackers[0].only_tracking
    if what == "track_features_imu":
        assert merge_inertial_ba(slam.atlas.active, cfg.imu_calib, CAM, 0, 1) is None
    if what == "async":
        assert slam._backend.backend.alive
    out = tmp_path / "saved.npz"
    if what in ("track_stereo", "tracker_bf", "track_features_imu"):
        rng = np.random.default_rng(2)
        pkt = wire.decode_frame(wire.encode_frame(
            0, 10 ** 9, rng.uniform(0, 376, (50, 2)), rng.integers(0, 256, (50, 32),
                                                                     dtype=np.uint8),
            [999_000_000], [[0, 0, 0]], [[0, 0, 9.81]]))
        assert slam.track_edge(0, pkt) is None  # one frame does not initialize
        assert slam.trackers[0].frame_id == 1
        slam.save_atlas(str(out))
    elif what == "localization":
        slam.shutdown(save_atlas_to=str(out))
    else:
        slam.save_atlas(str(out))
    back = serialize.load_atlas(str(out), vocab=kw.get("vocab"), device="cpu")
    for mid, m in slam.atlas.maps.items():
        assert np.array_equal(back.maps[mid].kf_desc, m.kf_desc)
    slam.shutdown()
    if what == "async":
        assert not slam._backend.backend.alive


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        Slam(CAM, SystemConfig())


@pytest.fixture(scope="module")
def mono_run():
    """Rendered 240x376 frames at 600 features on the orbit `chip_smoke.py`
    drives at full width, tracked with timing on: the `Slam`, the images,
    whether each frame returned a pose, and timing's spans and counts."""
    imgs, _, _, ts = trender.orbit_sequence(12, 376, 240,
                                            (229.327, 228.648, 183.6075, 124.1875))
    slam = Slam(CAM, SystemConfig(map=MapConfig(max_keyframes=32, max_points=4096,
                                                features_per_frame=600),
                                  tracker=TrackerConfig(n_features=600)), device="cpu")
    timing.reset()
    timing.enable(True)
    try:
        tracked = [slam.track_monocular(im, float(s)) is not None for im, s in zip(imgs, ts)]
        spans, counts = timing.spans(), timing.counts()
    finally:
        timing.enable(False)
        timing.reset()
    return slam, imgs, tracked, spans, counts


def test_track_monocular_initializes_and_tracks(mono_run):
    """The map initializes within 10 frames and every later frame tracks."""
    slam, imgs, tracked, _, _ = mono_run
    init = tracked.index(True)
    assert init < 10 and all(tracked[init:])
    m = slam.trackers[0].map
    assert m.n_keyframes >= 2 and m.n_points >= 100
    poses = slam._full_poses()
    assert len(poses) == len(imgs) - init
    assert all(np.isfinite(p[1]).all() and np.isfinite(p[2]).all() for p in poses)


def test_slam_frame_spans_of_a_short_run(mono_run):
    """Each frame handed to `Slam` is one `slam.frame` span (client 0, the
    frame's index), the root of every stage inside it, which lie within
    it; each frame tracked after the initializing one has `track.local_map`
    and `track.fused_pose` as children, and the retry ladder made at least
    two attempts (acquisition and refinement) for each."""
    _, imgs, tracked, spans, counts = mono_run
    frames = [s for s in spans if s.name == "slam.frame"]
    assert [s.fields["frame"] for s in frames] == list(range(len(imgs)))
    assert all(s.fields["client"] == 0 and s.parent == -1 and s.root == s.id for s in frames)
    by_id = {s.id: s for s in spans}
    assert all(s.root in by_id and by_id[s.root].name == "slam.frame" for s in spans)
    init = tracked.index(True)
    for i, f in enumerate(frames):
        inside = [s for s in spans if s.root == f.id and s is not f]
        assert all(f.start_ns <= s.start_ns <= s.end_ns <= f.end_ns for s in inside)
        children = sorted(s.name for s in inside if s.parent == f.id)
        if i > init:
            assert tracked[i]
            assert children.count("track.local_map") == 1, children
            assert children.count("track.fused_pose") == 1, children
        else:
            assert "track.fused_pose" not in children
    assert counts["track.ladder_attempt"] >= 2 * (len(imgs) - init - 1)
