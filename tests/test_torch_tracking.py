"""Parity of the port's vision/matcher, opt/pose_gn, engine/track_program
and vision/frame against the JAX package, CPU, and of the slice as a whole
(extract_features -> fused_track_pose).

Match sets (indices, counts, masks) must be identical: they are decided by
integer distances and by window tests that no rounding reaches at these
inputs. Poses are f32 Gauss-Newton results whose sums run in another order
in each package; they must agree within 1e-4 (rotation entries, and metres
at 2-8 m depth), two orders of magnitude under the recovery bounds the
reference's own tests use (1e-3 and 5e-3)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orbslam3_tpu.core.camera import Camera as JCamera
from orbslam3_tpu.engine.track_program import fused_track_pose as j_fused
from orbslam3_tpu.kernels import orb_descriptor as jdesc
from orbslam3_tpu.opt.pose_gn import optimize_pose as j_optimize_pose
from orbslam3_tpu.vision import frame as jframe
from orbslam3_tpu.vision import matcher as jmatcher
from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.core.camera import Camera as TCamera
from orbslam3_tpu_torch.engine.track_program import fused_track_pose as t_fused
from orbslam3_tpu_torch.kernels import orb_descriptor as tdesc
from orbslam3_tpu_torch.opt.pose_gn import optimize_pose as t_optimize_pose
from orbslam3_tpu_torch.vision import frame as tframe
from orbslam3_tpu_torch.vision import matcher as tmatcher
from torch_parity import np_, t32, textured_image

POSE_ATOL = 1e-4
CPU = "cpu"


def _words_t(words):
    return torch.from_numpy(np.asarray(words, np.uint32).view(np.int32).copy())


def _pinhole(fx, fy, cx, cy, width, height):
    return (JCamera.pinhole(fx, fy, cx, cy, width=width, height=height),
            TCamera.pinhole(fx, fy, cx, cy, width=width, height=height, device=CPU))


# --------------------------------------------------------------------------
# search_by_projection: the scenario of test_hamming_pallas's full stack
# --------------------------------------------------------------------------


def _matcher_scene(seed=41, K=256, N=128):
    rng = np.random.default_rng(seed)
    cj, ct = _pinhole(400.0, 400.0, 320.0, 240.0, 640, 480)
    pts = np.stack([rng.uniform(-2, 2, K), rng.uniform(-1.5, 1.5, K),
                    rng.uniform(3, 9, K)], -1).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (K, 8), dtype=np.uint32)
    uv = np.asarray(cj.project(jnp.asarray(pts)))
    f_uv = (uv[:N] + rng.normal(0, 1.0, (N, 2))).astype(np.float32)
    f_oct = rng.integers(0, 3, N).astype(np.int32)
    return cj, ct, pts, desc, f_uv, desc[:N], f_oct


@pytest.mark.parametrize("radius,gates", [(10.0, False), (4.0, False), (10.0, True)])
def test_search_by_projection_matches_jax(radius, gates):
    cj, ct, pts, desc, f_uv, f_desc, f_oct = _matcher_scene()
    K, N = pts.shape[0], f_uv.shape[0]
    extra_j, extra_t = {}, {}
    if gates:
        dist = np.linalg.norm(pts, axis=-1).astype(np.float32)
        max_d = dist * np.float32(1.2) ** np.float32(1.0)
        normal = (pts / dist[:, None]).astype(np.float32)
        normal[::5] *= -1.0  # some points seen from behind: angle gate
        for d, conv in ((extra_j, jnp.asarray), (extra_t, t32)):
            d.update(mp_normal=conv(normal), mp_min_dist=conv(max_d / 1.2 ** 7),
                     mp_max_dist=conv(max_d))
    ref = jmatcher.search_by_projection(
        jnp.asarray(pts), jdesc.descriptor_planes(jnp.asarray(desc)),
        jnp.ones(K, bool), jnp.eye(3), jnp.zeros(3), cj, jnp.asarray(f_uv),
        jdesc.descriptor_planes(jnp.asarray(f_desc)), jnp.asarray(f_oct),
        jnp.ones(N, bool), jnp.asarray(radius, jnp.float32), **extra_j)
    got = tmatcher.search_by_projection(
        t32(pts), tdesc.descriptor_planes(_words_t(desc)),
        torch.ones(K, dtype=torch.bool), torch.eye(3), torch.zeros(3), ct,
        t32(f_uv), tdesc.descriptor_planes(_words_t(f_desc)),
        torch.from_numpy(f_oct), torch.ones(N, dtype=torch.bool), radius,
        device=CPU, **extra_t)
    idx_r, dist_r, keep_r, n_r, vis_r = (np.asarray(x) for x in ref)
    idx, dist, keep, n, vis = (np_(x) for x in got)
    assert int(n) == int(n_r) > 0
    np.testing.assert_array_equal(keep, keep_r)
    np.testing.assert_array_equal(vis, vis_r)
    np.testing.assert_array_equal(idx[keep], idx_r[keep_r])
    np.testing.assert_array_equal(dist[keep], dist_r[keep_r])


def test_resolve_duplicates_matches_jax():
    rng = np.random.default_rng(3)
    feat = rng.integers(0, 12, 80).astype(np.int32)
    dist = rng.integers(0, 6, 80).astype(np.int32)  # many equal distances
    ok = rng.random(80) < 0.7
    ref = np.asarray(jmatcher._resolve_duplicates(jnp.asarray(feat), jnp.asarray(dist),
                                                  jnp.asarray(ok), 12))
    got = tmatcher._resolve_duplicates(torch.from_numpy(feat), torch.from_numpy(dist),
                                       torch.from_numpy(ok), 12)
    np.testing.assert_array_equal(np_(got), ref)


# --------------------------------------------------------------------------
# optimize_pose
# --------------------------------------------------------------------------


@pytest.mark.parametrize("outliers", [0, 15])
def test_optimize_pose_matches_jax(outliers):
    rng = np.random.default_rng(4)
    cj, ct = _pinhole(458.0, 457.0, 367.0, 248.0, 752, 480)
    n = 120
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(3, 8, n)], -1).astype(np.float32)
    uv = np.asarray(cj.project(jnp.asarray(pts))) + rng.normal(0, 0.5, (n, 2))
    uv[:outliers] += rng.uniform(20, 40, (outliers, 2))
    uv = uv.astype(np.float32)
    octave = rng.integers(0, 4, n)
    info = (1.0 / 1.2 ** (2.0 * octave)).astype(np.float32)
    valid = rng.random(n) < 0.9
    c, s = np.cos(0.03), np.sin(0.03)
    R0 = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    t0 = np.array([0.05, -0.04, 0.1], np.float32)
    Rr, tr, inl_r, n_r = j_optimize_pose(jnp.asarray(R0), jnp.asarray(t0),
                                          jnp.asarray(pts), jnp.asarray(uv),
                                          jnp.asarray(info), jnp.asarray(valid), cj)
    R, t, inl, n_in = t_optimize_pose(t32(R0), t32(t0), t32(pts), t32(uv), t32(info),
                                      torch.from_numpy(valid), ct, device=CPU)
    np.testing.assert_allclose(np_(R), np.asarray(Rr), atol=POSE_ATOL)
    np.testing.assert_allclose(np_(t), np.asarray(tr), atol=POSE_ATOL)
    np.testing.assert_array_equal(np_(inl), np.asarray(inl_r))
    assert int(n_in) == int(n_r)
    np.testing.assert_allclose(np_(R), np.eye(3), atol=2e-3)  # recovered


# --------------------------------------------------------------------------
# fused_track_pose: the scenarios of tests/test_track_fused.py
# --------------------------------------------------------------------------

K_CAP, F_CAP, N_PTS = 256, 128, 90
CAM = (458.0, 457.0, 367.0, 248.0, 752, 480)


def _track_scene(seed=0, yaw=0.02, t_off=(0.03, -0.01, 0.02)):
    rng = np.random.default_rng(seed)
    cj, _ = _pinhole(*CAM)
    pts = np.stack([rng.uniform(-2, 2, N_PTS), rng.uniform(-1.5, 1.5, N_PTS),
                    rng.uniform(4.0, 8.0, N_PTS)], -1).astype(np.float32)
    c, s = np.cos(yaw), np.sin(yaw)
    R_true = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    t_true = np.asarray(t_off, np.float32)
    xc = pts @ R_true.T + t_true
    uv = np.asarray(cj.project(jnp.asarray(xc)))
    inside = ((uv[:, 0] > 10) & (uv[:, 0] < 742) & (uv[:, 1] > 10) & (uv[:, 1] < 470))
    desc = rng.integers(0, 2**32, size=(N_PTS, 8), dtype=np.uint32)
    sc = dict(mp_pos=np.zeros((K_CAP, 3), np.float32),
              mp_desc=np.zeros((K_CAP, 8), np.uint32),
              mp_valid=np.zeros(K_CAP, bool),
              mp_max_d=np.full(K_CAP, 1.0, np.float32))
    sc["mp_pos"][:N_PTS] = pts
    sc["mp_desc"][:N_PTS] = desc
    sc["mp_valid"][:N_PTS] = inside
    sc["mp_max_d"][:N_PTS] = np.linalg.norm(xc, axis=-1)
    sc["mp_min_d"] = sc["mp_max_d"] / (1.2 ** 8)
    sc["mp_normal"] = np.zeros((K_CAP, 3), np.float32)  # angle gate off
    perm = (np.arange(N_PTS) + 7) % N_PTS
    sc["f_uv"] = np.zeros((F_CAP, 2), np.float32)
    sc["f_desc"] = rng.integers(0, 2**32, size=(F_CAP, 8), dtype=np.uint32)
    sc["f_oct"] = np.zeros(F_CAP, np.int32)
    sc["f_valid"] = np.zeros(F_CAP, bool)
    sc["f_uv"][perm] = uv + rng.normal(0, 0.3, uv.shape)
    sc["f_desc"][perm] = desc
    sc["f_valid"][perm] = True
    return sc, R_true, t_true, perm


def _run_both(sc, cams, R0, t0, R_last, t_last, allow_last,
              radii=(15.0, 30.0, 60.0, 8.0), min_matches=20, min_inliers=15):
    cj, ct = cams
    ok_j, res_j = j_fused(
        jnp.asarray(sc["mp_pos"]), jdesc.descriptor_planes(jnp.asarray(sc["mp_desc"])),
        jnp.asarray(sc["mp_valid"]), jnp.asarray(sc["mp_normal"]),
        jnp.asarray(sc["mp_min_d"]), jnp.asarray(sc["mp_max_d"]), cj,
        jnp.asarray(sc["f_uv"]), jdesc.descriptor_planes(jnp.asarray(sc["f_desc"])),
        jnp.asarray(sc["f_oct"]), jnp.asarray(sc["f_valid"]),
        jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(R_last), jnp.asarray(t_last),
        jnp.asarray(bool(allow_last)), jnp.asarray(radii, jnp.float32),
        jnp.asarray(min_matches, jnp.int32), jnp.asarray(min_inliers, jnp.int32))
    mp = convert.map_points(sc["mp_pos"], sc["mp_desc"], sc["mp_normal"],
                            sc["mp_min_d"], sc["mp_max_d"], device=CPU)
    ok_t, res_t = t_fused(
        mp["mp_pos"], tdesc.descriptor_planes(mp["mp_desc"]),
        torch.from_numpy(np.array(sc["mp_valid"])), mp["mp_normal"], mp["mp_min_dist"],
        mp["mp_max_dist"], ct, t32(sc["f_uv"]),
        tdesc.descriptor_planes(_words_t(sc["f_desc"])), torch.from_numpy(np.array(sc["f_oct"])),
        torch.from_numpy(np.array(sc["f_valid"])), t32(R0), t32(t0), t32(R_last), t32(t_last),
        allow_last, radii, min_matches, min_inliers, device=CPU)
    return (bool(ok_j), jax.device_get(res_j)), (ok_t, {k: np_(v) for k, v in res_t.items()})


def _assert_same_result(ref, got):
    (ok_j, rj), (ok_t, rt) = ref, got
    assert ok_t == ok_j
    for key in ("sel", "fidx", "vsel", "inl", "nm", "n_in", "fr", "oct"):
        np.testing.assert_array_equal(rt[key], np.asarray(rj[key]), err_msg=key)
    for key in ("R", "t", "uv"):
        np.testing.assert_allclose(rt[key], np.asarray(rj[key]), atol=POSE_ATOL,
                                   err_msg=key)


SCENARIOS = {
    # name: (t offset of the prediction, allow_last, last pose is the truth)
    "good_prediction": ((0.0, 0.0, 0.01), False, False),
    "exact_prediction": ((0.0, 0.0, 0.0), False, False),
    "ladder_widens": ((0.35, 0.0, 0.0), False, False),
    "lost_without_last": ((3.0, 0.0, 0.0), False, True),
    "recovers_from_last": ((3.0, 0.0, 0.0), True, True),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_fused_track_pose_matches_jax(name):
    sc, R_true, t_true, perm = _track_scene()
    off, allow_last, last_is_truth = SCENARIOS[name]
    t_pred = t_true + np.asarray(off, np.float32)
    R_last, t_last = (R_true, t_true) if last_is_truth else (R_true, t_pred)
    ref, got = _run_both(sc, _pinhole(*CAM), R_true, t_pred, R_last, t_last,
                         allow_last)
    _assert_same_result(ref, got)
    ok, res = got
    assert ok == (name != "lost_without_last")
    if ok:
        assert np.linalg.norm(res["t"] - t_true) < 8e-3
        mask = res["vsel"]
        assert (perm[res["sel"][mask]] == res["fidx"][mask]).all()


def test_fused_track_pose_no_map_overlap_fails():
    sc, R_true, t_true, _ = _track_scene()
    R_away = -np.eye(3, dtype=np.float32)
    R_away[1, 1] = 1.0
    ref, got = _run_both(sc, _pinhole(*CAM), R_away, t_true, R_away, t_true, True)
    assert not got[0] and not ref[0]
    _assert_same_result(ref, got)


def test_fused_track_pose_rejects_fewer_candidates_than_slots():
    _, ct = _pinhole(*CAM)
    z = torch.zeros
    with pytest.raises(ValueError, match="pad the candidates"):
        t_fused(z(8, 3), z(8, 256), z(8, dtype=torch.bool), z(8, 3), z(8), z(8), ct,
                z(16, 2), z(16, 256), z(16, dtype=torch.int32),
                z(16, dtype=torch.bool), torch.eye(3), z(3), torch.eye(3), z(3),
                False, (15.0, 30.0, 60.0, 8.0), 20, 15, device=CPU)


# --------------------------------------------------------------------------
# The slice as a whole: image -> extract_features -> fused_track_pose
# --------------------------------------------------------------------------

H, W, NF, NL = 120, 160, 100, 3
SLICE_CAM = (150.0, 150.0, 80.0, 60.0, W, H)


@pytest.fixture(scope="module")
def slice_frame():
    img = textured_image(11, H, W)
    jf = jax.device_get(jframe.extract_features(jnp.asarray(img), n_features=NF,
                                                n_levels=NL))
    tf = tframe.extract_features(img, n_features=NF, n_levels=NL, device=CPU)
    return img, jf, tf


def test_slice_features_match(slice_frame):
    _, jf, tf = slice_frame
    assert tf.capacity == NF
    np.testing.assert_array_equal(np_(tf.octave), jf.octave)
    np.testing.assert_array_equal(np_(tf.valid), jf.valid)
    lvl0 = jf.octave == 0  # exact integer FAST sums at level 0
    np.testing.assert_array_equal(np_(tf.response)[lvl0], jf.response[lvl0])
    np.testing.assert_allclose(np_(tf.response), jf.response, rtol=1e-6)
    np.testing.assert_allclose(np_(tf.uv), jf.uv, atol=1e-4)  # px; resize rounding
    np.testing.assert_allclose(np_(tf.angle), jf.angle, atol=1e-3)  # rad
    bits = np.unpackbits((np_(tf.desc) ^ jf.desc.view(np.int32)).view(np.uint8), axis=1)
    assert bits.sum(1).max() <= 2


def test_slice_end_to_end_matches_jax(slice_frame):
    """A map back-projected from the frame's own keypoints at seeded depths
    under a known pose; both packages track the frame from a perturbed
    pose, must agree with each other, and recover the pose."""
    _, jf, tf = slice_frame
    rng = np.random.default_rng(12)
    cj, ct = _pinhole(*SLICE_CAM)
    c, s = np.cos(0.05), np.sin(0.05)
    R_true = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    t_true = np.array([0.1, -0.05, 0.2], np.float32)
    depth = rng.uniform(2.0, 6.0, NF).astype(np.float32)
    rays = np.asarray(cj.unproject(jnp.asarray(jf.uv)))
    xc = rays * depth[:, None]
    pts = ((xc - t_true) @ R_true).astype(np.float32)  # R^T (xc - t)
    center = -(R_true.T @ t_true)
    dist = np.linalg.norm(pts - center, axis=-1)
    K = 128  # >= the 100 feature slots
    sc = dict(mp_pos=np.zeros((K, 3), np.float32), mp_desc=np.zeros((K, 8), np.uint32),
              mp_valid=np.zeros(K, bool), mp_max_d=np.ones(K, np.float32),
              mp_normal=np.zeros((K, 3), np.float32))
    sc["mp_pos"][:NF] = pts
    sc["mp_desc"][:NF] = jf.desc
    sc["mp_valid"][:NF] = jf.valid
    sc["mp_max_d"][:NF] = dist * 1.2 ** jf.octave
    sc["mp_min_d"] = sc["mp_max_d"] / 1.2 ** 7
    sc["mp_normal"][:NF] = (pts - center) / dist[:, None]
    sc.update(f_uv=jf.uv, f_desc=jf.desc, f_oct=jf.octave, f_valid=jf.valid)
    t_pred = t_true + np.array([0.02, 0.01, -0.03], np.float32)
    ref, got = _run_both(sc, (cj, ct), R_true, t_pred, R_true, t_pred, False)
    _assert_same_result(ref, got)
    ok, res = got
    assert ok and int(res["n_in"]) >= 50
    np.testing.assert_allclose(res["t"], t_true, atol=1e-3)
    np.testing.assert_allclose(res["R"], R_true, atol=1e-4)



def test_convert_carries_jax_features_and_map_bit_for_bit(slice_frame):
    _, jf, _ = slice_frame
    feats = convert.frame_features(jf.uv, jf.uv_raw, jf.response, jf.angle,
                                   jf.octave, jf.desc, jf.valid, device=CPU)
    for name in ("uv", "uv_raw", "response", "angle", "octave", "valid"):
        np.testing.assert_array_equal(np_(getattr(feats, name)), getattr(jf, name))
    assert feats.desc.dtype == torch.int32
    np.testing.assert_array_equal(np_(feats.desc).view(np.uint32), jf.desc)
    cj, _ = _pinhole(*SLICE_CAM)
    ct = convert.camera(np.asarray(cj.params), cj.kind, cj.width, cj.height, device=CPU)
    assert (ct.kind, ct.width, ct.height) == (cj.kind, cj.width, cj.height)
    np.testing.assert_array_equal(np_(ct.params), np.asarray(cj.params))
