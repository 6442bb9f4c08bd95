"""Port parity, CPU: the stereo / RGB-D front end (`vision/stereo`,
`vision/rectify`, `core/camera:Camera.K`), the settings (`config`) and the
stereo and RGB-D sequences of `datasets/render`.

Tolerances: K1's candidate masks, match indices and has-depth masks are
exact (integer distances, and window tests at the same f32 values); the
rectified pair's depth rtol 1e-6 (one f32 division of the same operands);
RGB-D depth exact and its right coordinate rtol 1e-6; the fisheye pair's
triangulated depth rtol 1e-4 at exact projections; with 0.7 px of noise
the reference's own f32 midpoint (1 - b^2 ~ 5e-4 for a 0.11 m baseline at
2-8 m amplifies one ulp of the ray products) is off the float64
triangulation of the same rays by up to 4.2e-3 relative, and the two
packages' depths are held to each other at rtol 5e-3;
the rectification's host precompute exact (the same numpy code); the
bilinear remap within 4 ulps of the reference (XLA contracts the
multiply-adds); the settings field by field as the reference parses them
with PyYAML; the rendered sequences within 1 grey level of the reference's
writers (the renderer's own bound) and their depth maps exact."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from orbslam3_tpu.config import Settings as JSettings
from orbslam3_tpu.core.camera import Camera as JCamera
from orbslam3_tpu.kernels import orb_descriptor as jdesc
from orbslam3_tpu.vision import rectify as jrect
from orbslam3_tpu.vision import stereo as jstereo
from orbslam3_tpu_torch import config as tconfig
from orbslam3_tpu_torch.core.camera import Camera as TCamera
from orbslam3_tpu_torch.datasets import render as trender
from orbslam3_tpu_torch.vision import rectify as trect
from orbslam3_tpu_torch.vision import stereo as tstereo
from torch_parity import np_, one_torch_thread, t32  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU = "cpu"


def _words_t(words):
    return torch.from_numpy(np.asarray(words, np.uint32).view(np.int32).copy())


def _planes_j(words):
    return jdesc.descriptor_planes(jnp.asarray(words))


def test_camera_K_matches_jax():
    args = (458.654, 457.296, 367.215, 248.375)
    np.testing.assert_array_equal(np_(TCamera.pinhole(*args, device=CPU).K),
                                  np.asarray(JCamera.pinhole(*args).K))
    kb = (190.0, 191.0, 256.0, 250.0, 0.003, 0.001, -0.003, 0.001)
    np.testing.assert_array_equal(np_(TCamera.kb8(*kb, device=CPU).K),
                                  np.asarray(JCamera.kb8(*kb).K))


# --------------------------------------------------------------------------
# stereo_match: the rectified row band
# --------------------------------------------------------------------------


def _stereo_case(seed, n=300, m=320):
    """Left keypoints and their right matches at seeded depths (1-12 m,
    bf = 40), sub-pixel row jitter, distractors in the band, right rows
    planted exactly on the band edge 2 x 1.2^octave, and invalid rows."""
    rng = np.random.default_rng(seed)
    uvL = np.stack([rng.uniform(60, 700, n), rng.uniform(0, 480, n)], -1)
    octL = rng.integers(0, 8, n).astype(np.int32)
    z = rng.uniform(1.0, 12.0, n)
    k = min(n, m) * 2 // 3
    uvR = np.stack([rng.uniform(0, 740, m), rng.uniform(0, 480, m)], -1)
    octR = rng.integers(0, 8, m).astype(np.int32)
    uvR[:k, 0] = uvL[:k, 0] - 40.0 / z[:k]
    uvR[:k, 1] = uvL[:k, 1] + rng.normal(0, 0.4, k)
    octR[:k] = np.clip(octL[:k] + rng.integers(-1, 2, k), 0, 7)
    edge = np.arange(k, k + 20)  # right rows exactly on the left band's edge
    tol = (2.0 * np.float32(1.2) ** octL[edge - k].astype(np.float32)).astype(np.float64)
    uvR[edge, 0] = uvL[edge - k, 0] - 5.0
    uvR[edge, 1] = uvL[edge - k, 1] + np.where(np.arange(20) % 2, tol, -tol)
    octR[edge] = octL[edge - k]
    uvL, uvR = uvL.astype(np.float32), uvR.astype(np.float32)
    wL = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    wR = rng.integers(0, 2 ** 32, (m, 8), dtype=np.uint32)
    flips = rng.integers(0, 2, (k, 8)).astype(np.uint32) << rng.integers(0, 32, (k, 8)).astype(np.uint32)
    wR[:k] = wL[:k] ^ flips
    wR[edge] = wL[edge - k]
    wR[k + 20:k + 40] = wL[:20]  # tied duplicates, elsewhere on the image
    vL = rng.random(n) < 0.95
    vR = rng.random(m) < 0.95
    return uvL, wL, octL, vL, uvR, wR, octR, vR


def _jax_stereo_mask(uvL, octL, validL, uvR, octR, validR, max_disp):
    """The candidate mask as `orbslam3_tpu/vision/stereo.py:stereo_match`
    builds it (its lines 48-54, which it does not return)."""
    uvL, uvR, octL, octR = map(jnp.asarray, (uvL, uvR, octL, octR))
    row_tol = 2.0 * (1.2 ** octL.astype(jnp.float32))
    band = jnp.abs(uvL[:, 1:2] - uvR[None, :, 1]) <= row_tol[:, None]
    oct_ok = jnp.abs(octL[:, None] - octR[None, :]) <= 1
    disp = uvL[:, 0:1] - uvR[None, :, 0]
    disp_ok = (disp > 0.1) & (disp <= max_disp)
    return np.asarray(band & oct_ok & disp_ok & jnp.asarray(validL)[:, None]
                      & jnp.asarray(validR)[None, :])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stereo_match_matches_jax(seed):
    uvL, wL, octL, vL, uvR, wR, octR, vR = _stereo_case(seed)
    bf, min_z = 40.0, 0.1
    max_disp = np.float32(bf / min_z)
    mask_t = tstereo.stereo_mask(t32(uvL), torch.from_numpy(octL), torch.from_numpy(vL),
                                 t32(uvR), torch.from_numpy(octR), torch.from_numpy(vR),
                                 torch.tensor(max_disp))
    mask_j = _jax_stereo_mask(uvL, octL, vL, uvR, octR, vR, jnp.float32(max_disp))
    np.testing.assert_array_equal(np_(mask_t), mask_j)
    k = 200  # the planted band-edge rows fall on both sides of the edge
    edge_in = mask_j[np.arange(20), np.arange(k, k + 20)][vL[:20] & vR[k:k + 20]]
    assert edge_in.any() and not edge_in.all()
    ref = jstereo.stereo_match(
        jnp.asarray(uvL), _planes_j(wL), jnp.asarray(octL), jnp.asarray(vL),
        jnp.asarray(uvR), _planes_j(wR), jnp.asarray(octR), jnp.asarray(vR),
        jnp.float32(bf), jnp.float32(min_z), jnp.float32(max_disp))
    got = tstereo.stereo_match(t32(uvL), _words_t(wL), torch.from_numpy(octL),
                               torch.from_numpy(vL), t32(uvR), _words_t(wR),
                               torch.from_numpy(octR), torch.from_numpy(vR), bf, min_z,
                               bf / min_z)
    np.testing.assert_array_equal(np_(got[2]), np.asarray(ref[2]))
    np.testing.assert_array_equal(np_(got[0]), np.asarray(ref[0]))
    np.testing.assert_allclose(np_(got[1]), np.asarray(ref[1]), rtol=1e-6, atol=0)
    assert np_(got[2]).sum() > 100


def test_depth_from_rgbd_matches_jax():
    """Keypoints at exact .5 positions round half to even in both; keypoints
    off the image clamp; zero, infinite and NaN depths are no depth. A
    uint16 map at TUM's factor 1/5000 gives the same metres."""
    rng = np.random.default_rng(3)
    h, w = 48, 64
    dmap = rng.uniform(0.3, 9.0, (h, w)).astype(np.float32)
    dmap[::7, ::5] = 0.0
    dmap[3, 4], dmap[5, 6] = np.inf, np.nan
    n = 400
    uv = np.stack([rng.integers(-3, w + 3, n) + rng.choice([0.0, 0.5, 0.49, 0.51], n),
                   rng.integers(-3, h + 3, n) + rng.choice([0.0, 0.5, -0.5], n)], -1)
    uv[:4] = [[4.0, 3.0], [6.5, 5.0], [4.5, 2.5], [3.5, 3.5]]
    uv = uv.astype(np.float32)
    valid = rng.random(n) < 0.9
    for dm, factor in ((dmap, 1.0), ((np.nan_to_num(dmap, posinf=0.0) * 5000)
                                     .astype(np.uint16), 1.0 / 5000)):
        ref = jstereo.depth_from_rgbd(jnp.asarray(uv), jnp.asarray(valid), jnp.asarray(dm),
                                      jnp.float32(40.0), factor)
        dm_t = torch.from_numpy(np.asarray(dm, np.float32))
        got = tstereo.depth_from_rgbd(t32(uv), torch.from_numpy(valid), dm_t, 40.0, factor)
        np.testing.assert_array_equal(np_(got[2]), np.asarray(ref[2]))
        np.testing.assert_array_equal(np_(got[1]), np.asarray(ref[1]))
        np.testing.assert_allclose(np_(got[0]), np.asarray(ref[0]), rtol=1e-6, atol=0)
        assert 0 < np_(got[2]).sum() < valid.sum()


@pytest.mark.parametrize("noise", [0.0, 0.7])
def test_fisheye_stereo_match_matches_jax(noise):
    """`tests/test_fisheye_stereo.py`'s KB8 pair, with pixel noise, a small
    rotation between the cameras, distractor rows and invalid keypoints."""
    rng = np.random.default_rng(21)
    kb = (190.0, 190.0, 256.0, 256.0, 0.003, 0.001, -0.003, 0.001)
    cj, ct = JCamera.kb8(*kb, width=512, height=512), TCamera.kb8(*kb, width=512, height=512,
                                                                 device=CPU)
    n = 160
    pts = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(2.0, 8.0, n)], -1).astype(np.float32)
    c, s = np.cos(0.01), np.sin(0.01)
    R_rl = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    t_rl = np.array([-0.11, 0.002, 0.0], np.float32)
    uvL = np.asarray(cj.project(jnp.asarray(pts))) + rng.normal(0, noise, (n, 2))
    uvR = np.asarray(cj.project(jnp.asarray(pts @ R_rl.T + t_rl))) + rng.normal(0, noise, (n, 2))
    perm = rng.permutation(n)
    uvR = uvR[perm].astype(np.float32)
    uvL = uvL.astype(np.float32)
    wL = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    wR = wL[perm].copy()
    wR[:20] = rng.integers(0, 2 ** 32, (20, 8), dtype=np.uint32)
    vL, vR = rng.random(n) < 0.95, rng.random(n) < 0.95
    ref = jstereo.fisheye_stereo_match(jnp.asarray(uvL), _planes_j(wL), jnp.asarray(vL),
                                       jnp.asarray(uvR), _planes_j(wR), jnp.asarray(vR),
                                       cj, cj, jnp.asarray(R_rl), jnp.asarray(t_rl))
    got = tstereo.fisheye_stereo_match(t32(uvL), _words_t(wL), torch.from_numpy(vL),
                                       t32(uvR), _words_t(wR), torch.from_numpy(vR),
                                       ct, ct, t32(R_rl), t32(t_rl))
    np.testing.assert_array_equal(np_(got[2]), np.asarray(ref[2]))
    np.testing.assert_array_equal(np_(got[1]), np.asarray(ref[1]))
    np.testing.assert_allclose(np_(got[0]), np.asarray(ref[0]), rtol=1e-4 if noise == 0 else 5e-3,
                               atol=0)
    good = np_(got[1])
    assert good.sum() > 0.7 * n
    if noise == 0:  # exact projections triangulate to the true depths
        assert np.median(np.abs(np_(got[0])[good] - pts[good, 2])) < 0.02


# --------------------------------------------------------------------------
# rectification
# --------------------------------------------------------------------------

K1 = np.array([[458.654, 0, 367.215], [0, 457.296, 248.375], [0, 0, 1.0]])
K2 = np.array([[457.587, 0, 379.999], [0, 456.134, 255.238], [0, 0, 1.0]])
D1 = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0)
D2 = (-0.28368365, 0.07451284, -0.00010473, -3.55590700e-05, 0.0)


def _rig():
    T = chip_smoke.EUROC_T_C1_C2
    R12 = T[:3, :3].T
    return R12, -R12 @ T[:3, 3]


def test_rectification_matches_jax():
    """`stereo_rectify` and the maps are the reference's numpy code: exact.
    `RectifyMaps` keeps them on the device it was given."""
    R12, t12 = _rig()
    size = (376, 240)
    ref = jrect.stereo_rectify(K1, D1, K2, D2, size, R12, t12)
    got = trect.stereo_rectify(K1, D1, K2, D2, size, R12, t12)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    jm = jrect.RectifyMaps(K1, D1, K2, D2, size, R12, t12)
    tm = trect.RectifyMaps(K1, D1, K2, D2, size, R12, t12, device=CPU)
    assert tm.bf == jm.bf and tm.baseline == jm.baseline
    np.testing.assert_array_equal(tm.R1, jm.R1)
    np.testing.assert_array_equal(tm.K_new, jm.K_new)
    np.testing.assert_array_equal(np_(tm.map_l), np.asarray(jm.map_l))
    np.testing.assert_array_equal(np_(tm.map_r), np.asarray(jm.map_r))
    assert tm.map_l.device.type == "cpu" and tm.to(CPU) is tm


def test_remap_bilinear_matches_jax_within_ulps():
    """A random image through a map with sub-pixel, out-of-range and
    border coordinates, and the rectified pair of a raw rendered pair."""
    rng = np.random.default_rng(8)
    img = rng.uniform(0, 255, (40, 56)).astype(np.float32)
    src = np.stack([rng.uniform(-3, 59, (30, 50)), rng.uniform(-3, 43, (30, 50))],
                   -1).astype(np.float32)
    src[0, :5] = [[0, 0], [55, 39], [55.5, 39.5], [-0.5, 10], [-1.0, -1.0]]
    ref = np.asarray(jrect.remap_bilinear(jnp.asarray(img), jnp.asarray(src)))
    got = np_(trect.remap_bilinear(t32(img), t32(src)))
    np.testing.assert_array_max_ulp(got, ref, maxulp=4)
    assert (got == 0).sum() > 10  # taps off the image read 0
    R12, t12 = _rig()
    size = (188, 120)
    K1s, K2s = K1.copy(), K2.copy()
    K1s[:2] *= 0.25
    K2s[:2] *= 0.25
    jm = jrect.RectifyMaps(K1s, D1, K2s, D2, size, R12, t12)
    tm = trect.RectifyMaps(K1s, D1, K2s, D2, size, R12, t12, device=CPU)
    left = rng.integers(0, 256, (120, 188)).astype(np.uint8)
    right = rng.integers(0, 256, (120, 188)).astype(np.uint8)
    for a, b in zip(tm(left, right), jm(left, right)):
        np.testing.assert_array_max_ulp(np_(a), np.asarray(b), maxulp=4)


# --------------------------------------------------------------------------
# settings
# --------------------------------------------------------------------------


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _writer_yaml(tmp_path, kind):
    """(path, sensor) of a config the JAX package's writers produce."""
    from orbslam3_tpu.datasets.synth_euroc import write_synth_euroc
    from orbslam3_tpu.datasets.tum_rgbd import write_synth_tum_rgbd
    d = str(tmp_path / kind)
    kw = dict(n_frames=1, width=96, height=64, fx=70.0, fy=70.0, seed=5)
    if kind == "mono":
        write_synth_euroc(d, **kw)
        return os.path.join(d, "config.yaml"), "monocular"
    if kind == "stereo_rectified":
        write_synth_euroc(d, stereo_baseline=0.11, **kw)
        return os.path.join(d, "config.yaml"), "stereo"
    if kind == "stereo_raw":
        write_synth_euroc(d, stereo_baseline=0.11, pinhole_dist=(-0.05, 0.01, 0.0, 0.0),
                          stereo_rot=0.01, **kw)
        return os.path.join(d, "config.yaml"), "imu_stereo"
    if kind == "fisheye":
        write_synth_euroc(d, stereo_baseline=0.1, fisheye=True, **kw)
        return os.path.join(d, "config.yaml"), "imu_stereo"
    write_synth_tum_rgbd(d, n_frames=1, width=96, height=64, fx=70.0, fy=70.0)
    return os.path.join(d, "config.yaml"), "rgbd"


def _same_value(a, b, name):
    if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=name)
    else:
        assert a == b and type(a) is type(b), (name, a, b)


def _assert_same_settings(ts, js):
    import dataclasses
    for f in dataclasses.fields(js):
        a, b = getattr(ts, f.name), getattr(js, f.name)
        if f.name == "imu":
            for g in dataclasses.fields(b):
                _same_value(getattr(a, g.name), getattr(b, g.name), f"imu.{g.name}")
        else:
            _same_value(a, b, f.name)


def _assert_same_configs(ts, js):
    """The adapters: camera(s), rectification, IMU calibration and the
    tracker fields the system config sets."""
    np.testing.assert_array_equal(np_(ts.camera(CPU).params), np.asarray(js.camera().params))
    np.testing.assert_array_equal(np_(ts.camera2(CPU).params), np.asarray(js.camera2().params))
    rj, rt = js.rectification(), ts.rectification(CPU)
    assert (rj is None) == (rt is None)
    if rj is not None:
        np.testing.assert_array_equal(np_(rt.map_l), np.asarray(rj.map_l))
        np.testing.assert_array_equal(rt.R1, rj.R1)
    ci, cj_ = ts.imu_calib(), js.imu_calib()
    for name in ("Rbc", "tbc", "gyro_noise2", "acc_noise2", "gyro_walk2", "acc_walk2"):
        np.testing.assert_array_equal(np_(getattr(ci, name)), np.asarray(getattr(cj_, name)))
    ct, cj = ts.system_config(device=CPU), js.system_config()
    assert ct.sensor.name == cj.sensor.name
    for name in ("n_features", "bf", "th_depth", "n_levels", "scale_factor", "ini_th_fast",
                 "min_th_fast", "th_far_points", "fisheye_stereo", "baseline_m",
                 "kf_ref_ratio"):
        assert getattr(ct.tracker, name) == getattr(cj.tracker, name), name
    for name in ("stereo_R_rl", "stereo_t_rl"):
        a, b = getattr(ct.tracker, name), getattr(cj.tracker, name)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert ct.map.features_per_frame == cj.map.features_per_frame
    assert (ct.imu_calib is None) == (cj.imu_calib is None)


@pytest.mark.parametrize("kind", ["mono", "stereo_rectified", "stereo_raw", "fisheye", "tum"])
def test_settings_from_writer_yaml_match_jax(tmp_path, kind):
    path, sensor = _writer_yaml(tmp_path, kind)
    js = JSettings.from_yaml(path, sensor)
    ts = tconfig.Settings.from_yaml(path, sensor)
    _assert_same_settings(ts, js)
    _assert_same_configs(ts, js)


@pytest.mark.parametrize("name,sensor", [("EUROC_STEREO_YAML", "stereo"),
                                         ("EUROC_STEREO_INERTIAL_YAML", "imu_stereo"),
                                         ("TUM1_RGBD_YAML", "rgbd")])
def test_chip_smoke_settings_match_jax(tmp_path, name, sensor):
    """The YAML texts chip_smoke.py parses on the card."""
    path = _write(tmp_path, "cfg.yaml", getattr(chip_smoke, name))
    js = JSettings.from_yaml(path, sensor)
    ts = tconfig.Settings.from_text(getattr(chip_smoke, name), sensor)
    _assert_same_settings(ts, js)
    _assert_same_configs(ts, js)


LEGACY_YAML = """%YAML:1.0
---
# a legacy-format config with the spellings PyYAML reads as strings
Camera.type: 'PinHole'   # quoted with single quotes
Camera.fx: 517.3
Camera.fy: 516.5
Camera.cx: 318.6
Camera.cy: 255.3
Camera.k1: 2.62383e-01
Camera.k2: -1e-3
Camera.p1: 0
Camera.p2: -5.358e-03
Camera.width: 640
Camera.height: 480
Camera.fps: 30
Camera.bf: 40
Camera.RGB: 0
ThDepth: 4e1
DepthMapFactor: 5000
IMU.NoiseGyro: 1e-3
IMU.NoiseAcc: .02
Tbc: !!opencv-matrix
   rows: 4
   cols: 4
   dt: f
   data: [ 1, 0, 0, 0.1,
     0, 1, 0, 0,
     0, 0, 1, 0,
     0, 0, 0, 1 ]
ORBextractor.nFeatures: 800
loopClosing: 0
System.SaveAtlasToFile: "atlas # not a comment"
thFarPoints: 20.0
"""


def test_parser_gives_the_settings_pyyaml_gives(tmp_path):
    """PyYAML (YAML 1.1) reads `1e-3`, `4e1` and `.02` as strings, then
    `Settings` takes float() of them: the fields are the same numbers."""
    path = _write(tmp_path, "legacy.yaml", LEGACY_YAML)
    for sensor in ("rgbd", "imu_rgbd"):
        js = JSettings.from_yaml(path, sensor)
        ts = tconfig.Settings.from_yaml(path, sensor)
        _assert_same_settings(ts, js)
    assert ts.save_atlas_to == "atlas # not a comment" and not ts.loop_closing
    with pytest.raises(ValueError, match="unsupported"):
        tconfig.load_opencv_yaml("Camera.list: [1, 2]\n")
    with pytest.raises(ValueError, match="cannot parse"):
        tconfig.load_opencv_yaml("- a list item\n")


# --------------------------------------------------------------------------
# the stereo and RGB-D sequences
# --------------------------------------------------------------------------


def _read_png(path):
    import cv2
    return cv2.imread(path, cv2.IMREAD_UNCHANGED)


def test_vi_sequence_stereo_matches_the_euroc_writer(tmp_path, monkeypatch):
    """The writer's raw stereo options: both views within 1 grey level of
    its PNGs (the renderer's bound), at its intrinsics and trajectory."""
    from orbslam3_tpu.datasets.synth_euroc import write_synth_euroc
    monkeypatch.delenv("ORB_SYNTH_CACHE", raising=False)
    d = str(tmp_path / "euroc")
    w, h, fx = 120, 80, 90.0
    kw = dict(stereo_baseline=0.11, pinhole_dist=(-0.05, 0.01, 0.001, 0.0), stereo_rot=0.01)
    write_synth_euroc(d, n_frames=2, width=w, height=h, fx=fx, fy=fx, seed=4, radius=3.0,
                      arc=1.2, excitation=0.06, **kw)
    seq = trender.vi_sequence(2, w, h, (fx, fx, w / 2.0, h / 2.0), seed=4, arc=1.2,
                              excitation=0.06, rot_excitation=0.0, **kw)
    names = sorted(os.listdir(os.path.join(d, "mav0", "cam0", "data")))
    for i, name in enumerate(names):
        for cam, imgs in (("cam0", seq.images), ("cam1", seq.images_right)):
            ref = _read_png(os.path.join(d, "mav0", cam, "data", name))
            assert np.abs(imgs[i].astype(int) - ref.astype(int)).max() <= 1, (cam, i)
    T = trender.stereo_extrinsics(0.11, 0.01)
    assert T[0, 3] == 0.11 and abs(T[0, 2] - np.sin(0.01)) < 1e-15


def test_rgbd_sequence_matches_the_tum_writer(tmp_path):
    """Images within 1 grey level, the uint16 depth maps and the poses
    exactly as `write_synth_tum_rgbd` writes them."""
    from orbslam3_tpu.datasets.tum_rgbd import write_synth_tum_rgbd
    d = str(tmp_path / "tum")
    write_synth_tum_rgbd(d, n_frames=2, width=96, height=72, fx=80.0, fy=80.0, seed=2)
    seq = trender.rgbd_sequence(2, 96, 72, (80.0, 80.0, 48.0, 36.0), seed=2)
    rgb = sorted(os.listdir(os.path.join(d, "rgb")))
    dep = sorted(os.listdir(os.path.join(d, "depth")))
    for i in range(2):
        img = _read_png(os.path.join(d, "rgb", rgb[i]))
        assert np.abs(seq.images[i].astype(int) - img.astype(int)).max() <= 1
        np.testing.assert_array_equal(seq.depth[i], _read_png(os.path.join(d, "depth", dep[i])))
        assert f"{seq.frame_ts[i]:.6f}.png" == rgb[i]
    assert seq.depth.dtype == np.uint16 and (seq.depth > 0).mean() > 0.9
