"""Port parity, CPU: `Slam.track_stereo` and `Slam.track_rgbd` end to end.

Image level, at half EuRoC / TUM size: the JAX package's and the port's
`Slam` built from the same YAML text by their own `Settings`, over 6
rendered frames of a raw (distorted, rotated) stereo pair and of an RGB-D
sequence with a uint16 depth map, and over 4 frames of a KB8 fisheye pair
(the triangulation path): the same init frame, tracked frames and
keyframe count, camera centres within 5e-3 m (the images pass through
each package's pyramid, whose resize differs by 2.4e-4 grey levels, so
keypoints differ by up to 1e-4 px)."""

import numpy as np
import pytest

import chip_smoke
from orbslam3_tpu.config import Settings as JSettings
from orbslam3_tpu.engine.system import Slam as JSlam
from orbslam3_tpu_torch.config import Settings as TSettings
from orbslam3_tpu_torch.datasets import render as trender
from orbslam3_tpu_torch.engine.system import Slam as TSlam
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU = "cpu"
IMAGE_FRAMES = 6
CENTRE_TOL = 5e-3


def _jax_settings(tmp_path, text, sensor):
    p = tmp_path / "cfg.yaml"
    p.write_text(text)
    return JSettings.from_yaml(str(p), sensor)


def _run_image_level(tmp_path, text, sensor, frames, depth_factor=None):
    js = _jax_settings(tmp_path, text, sensor)
    ts = TSettings.from_text(text, sensor)
    jslam = JSlam(js.camera(), js.system_config())
    tslam = TSlam(ts.camera(CPU), ts.system_config(device=CPU), device=CPU)
    poses = {"jax": [], "port": []}
    for i, (a, b, stamp) in enumerate(frames):
        if depth_factor is None:
            pj = jslam.track_stereo(a, b, stamp)
            pt = tslam.track_stereo(a, b, stamp)
        else:
            pj = jslam.track_rgbd(a, b, stamp, depth_factor=depth_factor)
            pt = tslam.track_rgbd(a, b, stamp, depth_factor=depth_factor)
        poses["jax"].append(pj)
        poses["port"].append(pt)
    return poses, jslam.trackers[0].map, tslam.trackers[0].map


def _assert_same_runs(poses, jm, tm):
    tracked = [p is not None for p in poses["jax"]]
    assert [p is not None for p in poses["port"]] == tracked
    assert tracked[0] and all(tracked)
    assert tm.n_keyframes == jm.n_keyframes
    for (Rj, tj), (Rt, tt) in zip(poses["jax"], poses["port"]):
        np.testing.assert_allclose(-Rt.T @ tt, -Rj.T @ tj, atol=CENTRE_TOL)


def test_track_stereo_raw_pair_matches_jax(tmp_path):
    (f0, d0), (f1, d1) = chip_smoke.EUROC_CAM0, chip_smoke.EUROC_CAM1
    half = lambda f: tuple(v * 0.5 for v in f)  # noqa: E731
    left, right, _, _, stamps = trender.orbit_stereo_sequence(
        IMAGE_FRAMES, 376, 240, half(f0), d0, right=(half(f1), d1),
        T_c1_c2=chip_smoke.EUROC_T_C1_C2, arc=0.15)
    poses, jm, tm = _run_image_level(
        tmp_path, chip_smoke.euroc_yaml(False, 0.5, 600), "stereo",
        list(zip(left, right, stamps)))
    _assert_same_runs(poses, jm, tm)
    assert tm.n_points > 200


def test_track_rgbd_matches_jax(tmp_path):
    seq = trender.rgbd_sequence(IMAGE_FRAMES, 320, 240,
                                tuple(v * 0.5 for v in chip_smoke.TUM1_INTRINSICS), arc=0.15)
    poses, jm, tm = _run_image_level(
        tmp_path, chip_smoke.tum1_yaml(0.5, 500), "rgbd",
        list(zip(seq.images, seq.depth, seq.frame_ts)), depth_factor=1.0 / 5000)
    _assert_same_runs(poses, jm, tm)
    assert tm.n_points > 200


def test_track_stereo_fisheye_pair_matches_jax(tmp_path):
    """A KB8 fisheye pair the JAX package's EuRoC writer renders (with its
    YAML): both `Settings` pick the two-view triangulation path (K1
    "fisheye_stereo", no right coordinates), and the runs initialize from
    the triangulated depths alike."""
    from orbslam3_tpu.datasets import load_euroc
    from orbslam3_tpu.datasets.synth_euroc import write_synth_euroc
    d = str(tmp_path / "fisheye")
    write_synth_euroc(d, n_frames=4, width=256, height=256, fx=110.0, fy=110.0, seed=3,
                      n_features=500, arc=0.1, stereo_baseline=0.1, fisheye=True)
    seq = load_euroc(d, stereo=True)
    frames = [(seq.read_image(i), seq.read_image(i, right=True), float(seq.image_ts[i]))
              for i in range(4)]
    text = open(f"{d}/config.yaml").read()
    assert TSettings.from_text(text, "stereo").system_config(device=CPU).tracker.fisheye_stereo
    poses, jm, tm = _run_image_level(tmp_path, text, "stereo", frames)
    _assert_same_runs(poses, jm, tm)
    assert abs(tm.n_points - jm.n_points) <= 0.02 * jm.n_points
    assert (tm.kf_uright[tm.kf_valid] == -1.0).all()


