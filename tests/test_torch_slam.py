"""The port's monocular SLAM entry point and its host-side helpers, CPU:
the `extract_features` capacity repair, the renderer against the
reference's OpenCV renderer, `evaluation`, `utils/timing`, the parts that
are not ported yet raising, and a short image-level run of
`Slam.track_monocular` that initializes and tracks."""

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
    timing.reset()
    timing.reset_counts()
    timing.enable(True)
    try:
        with timing.stage("x"):
            pass
        timing.count("k", 2)
        assert timing.stats()["x"]["n"] == 1 and timing.counts() == {"k": 2}
    finally:
        timing.enable(False)
        timing.reset()


CAM = Camera.pinhole(229.3, 228.6, 183.6, 124.2, width=376, height=240, device="cpu")


@pytest.mark.parametrize("what", ["vocab", "atlas", "stereo", "imu", "async",
                                  "track_stereo", "track_imu", "localization",
                                  "tracker_bf", "tracker_rectify", "track_features_imu"])
def test_unported_parts_raise(what):
    cfg = SystemConfig()
    kw = {}
    if what == "vocab":
        kw["vocab"] = object()
    elif what == "atlas":
        kw["load_atlas_from"] = "atlas.npz"
    elif what == "stereo":
        cfg.sensor = Sensor.STEREO
    elif what == "imu":
        cfg.sensor = Sensor.IMU_STEREO  # mono-inertial runs; stereo-inertial is slice C
    elif what == "async":
        cfg.async_mapping = True
    elif what == "tracker_bf":
        cfg.tracker = TrackerConfig(bf=40.0)
    elif what == "tracker_rectify":
        cfg.tracker = TrackerConfig(rectify=object())
    with pytest.raises(NotImplementedError, match="not yet ported"):
        slam = Slam(CAM, cfg, device="cpu", **kw)
        if what == "track_stereo":
            slam.track_stereo(None, None, 0.0)
        elif what == "track_imu":
            slam.track_rgbd(np.zeros((240, 376)), np.zeros((240, 376)), 0.0, imu=[])
        elif what == "localization":
            slam.activate_localization_mode()
        elif what == "track_features_imu":
            merge_inertial_ba(slam.atlas.active, None, CAM, 0, 1)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        Slam(CAM, SystemConfig())


def test_track_monocular_initializes_and_tracks():
    """Rendered 240x376 frames at 600 features on the orbit `chip_smoke.py`
    drives at full width: the map initializes within 10 frames and every
    later frame tracks."""
    imgs, _, _, ts = trender.orbit_sequence(12, 376, 240,
                                            (229.327, 228.648, 183.6075, 124.1875))
    slam = Slam(CAM, SystemConfig(map=MapConfig(max_keyframes=32, max_points=4096,
                                                features_per_frame=600),
                                  tracker=TrackerConfig(n_features=600)), device="cpu")
    tracked = [slam.track_monocular(im, float(s)) is not None for im, s in zip(imgs, ts)]
    init = tracked.index(True)
    assert init < 10 and all(tracked[init:])
    m = slam.trackers[0].map
    assert m.n_keyframes >= 2 and m.n_points >= 100
    poses = slam._full_poses()
    assert len(poses) == len(imgs) - init
    assert all(np.isfinite(p[1]).all() and np.isfinite(p[2]).all() for p in poses)
