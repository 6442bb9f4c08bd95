"""Parity of the port's geometry against the JAX package, CPU: robust cost,
the mutual and rotation filters, triangulation, two-view initialization,
bundle adjustment and the batched pose GN.

Inputs are made with numpy from seeds. Decisions (filter masks, inlier
sets, outlier masks, success flags) must be identical. Floating results are
f32 solves whose sums run in another order in each package; their
tolerances are stated per test with the reason."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orbslam3_tpu.core import robust as jrobust
from orbslam3_tpu.core.camera import Camera as JCamera
from orbslam3_tpu.kernels import hamming as jham
from orbslam3_tpu.opt import ba as jba
from orbslam3_tpu.opt.pose_gn import optimize_pose_batch as j_pose_batch
from orbslam3_tpu.vision import matcher as jmatcher
from orbslam3_tpu.vision import triangulate as jtri
from orbslam3_tpu.vision import twoview as jtv
from orbslam3_tpu_torch.core import robust as trobust
from orbslam3_tpu_torch.core.camera import Camera as TCamera
from orbslam3_tpu_torch.kernels import hamming as tham
from orbslam3_tpu_torch.opt import ba as tba
from orbslam3_tpu_torch.opt.pose_gn import optimize_pose_batch as t_pose_batch
from orbslam3_tpu_torch.vision import matcher as tmatcher
from orbslam3_tpu_torch.vision import triangulate as ttri
from orbslam3_tpu_torch.vision import twoview as ttv
from torch_parity import np_, t32

CAM = (458.0, 457.0, 367.0, 248.0)


def _cams(width=752, height=480):
    return (JCamera.pinhole(*CAM, width=width, height=height),
            TCamera.pinhole(*CAM, width=width, height=height, device="cpu"))


def _rot(axis_angle):
    v = np.asarray(axis_angle, np.float64)
    th = np.linalg.norm(v)
    k = v / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K).astype(np.float32)


def test_huber_rho_matches_jax():
    """Same formula in f32: equal to a few ulps (rtol 1e-6)."""
    e2 = np.random.default_rng(0).uniform(0, 30, 500).astype(np.float32)
    e2[:3] = [0.0, 5.991, 5.9911]
    for delta in (5.991 ** 0.5, 7.815 ** 0.5):
        ref = np.asarray(jrobust.huber_rho(jnp.asarray(e2), delta))
        np.testing.assert_allclose(np_(trobust.huber_rho(t32(e2), delta)), ref, rtol=1e-6)


def _match_case(seed, n=300, m=260):
    rng = np.random.default_rng(seed)
    idx_ab = rng.integers(0, m, n).astype(np.int32)
    ok_ab = rng.random(n) < 0.7
    idx_ba = rng.integers(0, n, m).astype(np.int32)
    idx_ba[idx_ab[: n // 2]] = np.arange(n // 2)  # half map back
    # angles in radians, differences clustered in a few bins
    ang_a = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    ang_b = rng.uniform(0, 2 * np.pi, m).astype(np.float32)
    ang_b[idx_ab[::3]] = ang_a[::3] - 0.3  # a dominant rotation
    return idx_ab, ok_ab, idx_ba, ang_a, ang_b


@pytest.mark.parametrize("seed", [0, 1])
def test_mutual_filter_and_rotation_consistency_match_jax(seed):
    """Integer decisions: identical masks."""
    idx_ab, ok_ab, idx_ba, ang_a, ang_b = _match_case(seed)
    ref = np.asarray(jham.mutual_filter(jnp.asarray(idx_ab), jnp.asarray(ok_ab),
                                        jnp.asarray(idx_ba)))
    got = tham.mutual_filter(torch.from_numpy(idx_ab), torch.from_numpy(ok_ab),
                             torch.from_numpy(idx_ba))
    np.testing.assert_array_equal(np_(got), ref)
    args_j = [jnp.asarray(x) for x in (ang_a, ang_b, idx_ab, ok_ab)]
    args_t = [torch.from_numpy(x) for x in (ang_a, ang_b, idx_ab, ok_ab)]
    got = np_(tmatcher.rotation_consistency(*args_t))
    np.testing.assert_array_equal(got, np.asarray(jmatcher.rotation_consistency(*args_j)))
    assert 0 < got.sum() < ok_ab.sum()  # the filter removed something


def test_triangulate_points_matches_jax():
    """Batched 4x4 SVDs in f32: points within 1e-4 relative to depth
    (3-8 m) on 1-px-noise observations, sigma_min within 1e-5."""
    rng = np.random.default_rng(2)
    X = np.stack([rng.uniform(-2, 2, 400), rng.uniform(-1, 1, 400),
                  rng.uniform(3, 8, 400)], -1).astype(np.float32)
    R2, t2 = _rot([0.02, -0.1, 0.01]), np.array([-0.4, 0.05, 0.02], np.float32)
    x1 = X[:, :2] / X[:, 2:]
    xc2 = X @ R2.T + t2
    x2 = (xc2[:, :2] / xc2[:, 2:] + rng.normal(0, 1 / 458, (400, 2))).astype(np.float32)
    P1 = np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(np.float32)
    P2 = np.asarray(jtri.projection_matrix(jnp.asarray(R2), jnp.asarray(t2)))
    Xr, sr = (np.asarray(v) for v in jtri.triangulate_points(
        jnp.asarray(P1), jnp.asarray(P2), jnp.asarray(x1), jnp.asarray(x2)))
    Xt, st = ttri.triangulate_points(t32(P1), ttri.projection_matrix(t32(R2), t32(t2)),
                                     t32(x1), t32(x2))
    np.testing.assert_allclose(np_(Xt), Xr, atol=1e-4 * 8)
    np.testing.assert_allclose(np_(st), sr, atol=1e-5)


def _two_view_scene(seed, planar):
    rng = np.random.default_rng(seed)
    n = 500
    if planar:  # a wall: both motion models fit, no clear winner
        X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                      np.full(n, 6.0)], -1)
    else:
        X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                      rng.uniform(3, 10, n)], -1)
    R, t = _rot([0.01, 0.06, -0.02]), np.array([0.5, 0.05, 0.1], np.float32)
    xc2 = X @ R.T + t
    noise = 1.0 / 458
    p1 = (X[:, :2] / X[:, 2:] + rng.normal(0, noise, (n, 2))).astype(np.float32)
    p2 = (xc2[:, :2] / xc2[:, 2:] + rng.normal(0, noise, (n, 2))).astype(np.float32)
    p2[:40] += rng.uniform(-0.05, 0.05, (40, 2)).astype(np.float32)  # outliers
    mask = rng.random(n) < 0.9
    return p1, p2, mask, R, t


@pytest.mark.parametrize("planar", [False, True])
def test_reconstruct_two_views_matches_jax(planar):
    """The port is handed the samples the reference drew from its key.
    Success, model choice and the inlier set are identical (on the wall
    both refuse: no clear winner among the motion candidates); R within
    1e-5 and the unit translation within 1e-3 (the SVD of a refit F in f32
    is sensitive along t); points within 1e-3 of their depth."""
    p1, p2, mask, R_true, _ = _two_view_scene(3, planar)
    key = jax.random.PRNGKey(7)
    sigma2 = np.float32((1.0 / 458) ** 2)
    ref = jtv.reconstruct_two_views(key, jnp.asarray(p1), jnp.asarray(p2),
                                    jnp.asarray(mask), jnp.asarray(sigma2))
    probs = jnp.asarray(mask, jnp.float32) / jnp.maximum(jnp.sum(mask), 1.0)
    samples = np.asarray(jax.random.choice(key, len(mask), shape=(200, 8),
                                           replace=True, p=probs))
    got = ttv.reconstruct_two_views(t32(p1), t32(p2), torch.from_numpy(mask),
                                    torch.tensor(sigma2),
                                    samples=torch.from_numpy(samples.copy()))
    assert bool(got.success) == bool(ref.success) == (not planar)
    assert bool(got.used_homography) == bool(ref.used_homography)
    inl = np.asarray(ref.inliers)
    np.testing.assert_array_equal(np_(got.inliers), inl)
    if planar:
        return
    np.testing.assert_allclose(np_(got.R), np.asarray(ref.R), atol=1e-5)
    np.testing.assert_allclose(np_(got.t), np.asarray(ref.t), atol=1e-3)
    pts_r = np.asarray(ref.points)[inl]
    err = np.abs(np_(got.points)[inl] - pts_r).max(axis=1) / np.abs(pts_r[:, 2])
    assert err.max() < 1e-3, err.max()
    np.testing.assert_allclose(np_(got.R), R_true, atol=0.02)  # recovered


def test_draw_samples_only_masked():
    mask = torch.zeros(50, dtype=torch.bool)
    mask[[3, 17, 40]] = True
    s = ttv.draw_samples(mask, 30, torch.Generator().manual_seed(0))
    assert s.shape == (30, 8) and set(s.flatten().tolist()) <= {3, 17, 40}


def _ba_problem(seed, n_kf=5, n_pts=160, n_fixed=2):
    """A seeded local-BA problem: perturbed poses and points, 0.5 px noise,
    a few gross outliers, padding rows and an unobserved landmark."""
    rng = np.random.default_rng(seed)
    _, _ = _cams()
    pts = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                    rng.uniform(4, 8, n_pts)], -1).astype(np.float32)
    Rs = np.stack([_rot([0.01 * k, 0.03 * k + 1e-3, 0.0]) for k in range(n_kf)])
    ts = np.stack([np.array([-0.2 * k, 0.02 * k, 0.0], np.float32) for k in range(n_kf)])
    M, P, O = n_kf + 1, n_pts + 8, n_kf * n_pts + 64
    kf_idx = np.zeros(O, np.int32)
    lm_idx = np.zeros(O, np.int32)
    uv = np.zeros((O, 2), np.float32)
    valid = np.zeros(O, bool)
    o = 0
    fx, fy, cx, cy = CAM
    for k in range(n_kf):
        xc = pts @ Rs[k].T + ts[k]
        proj = np.stack([fx * xc[:, 0] / xc[:, 2] + cx, fy * xc[:, 1] / xc[:, 2] + cy], -1)
        seen = rng.random(n_pts) < 0.85
        for j in np.nonzero(seen)[0]:
            kf_idx[o], lm_idx[o], uv[o], valid[o] = k, j, proj[j], True
            o += 1
    uv[:o] += rng.normal(0, 0.5, (o, 2)).astype(np.float32)
    bad = rng.choice(o, 12, replace=False)
    uv[bad] += rng.uniform(15, 30, (12, 2)).astype(np.float32)
    octave = rng.integers(0, 3, O)
    info = (1.0 / 1.2 ** (2.0 * octave)).astype(np.float32)
    R0 = np.tile(np.eye(3, dtype=np.float32), (M, 1, 1))
    t0 = np.zeros((M, 3), np.float32)
    R0[:n_kf] = Rs
    t0[:n_kf] = ts
    for k in range(n_fixed, n_kf):  # perturb the free poses
        R0[k] = _rot([0.004, -0.003, 0.002]) @ Rs[k]
        t0[k] += rng.normal(0, 0.02, 3).astype(np.float32)
    p0 = np.zeros((P, 3), np.float32)
    p0[:n_pts] = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    fixed_kf = np.arange(M) < n_fixed
    fixed_kf[n_kf:] = True
    fixed_lm = np.arange(P) >= n_pts
    return dict(R=R0, t=t0, points=p0, kf_idx=kf_idx, lm_idx=lm_idx, uv=uv, info=info,
                valid=valid, fixed_kf=fixed_kf, fixed_lm=fixed_lm)


@pytest.mark.parametrize("n_iters", [8, 20])
def test_bundle_adjust_matches_jax(n_iters):
    """Two fixed keyframes pin the gauge (as the local mapper's window
    does). The outlier mask is identical; poses within 1e-4 and points
    within 1e-3 m at 4-8 m depth: f32 Schur solves with scatter sums in
    another order, through the same accept/reject sequence."""
    cj, ct = _cams()
    p = _ba_problem(5)
    jprob = jba.BAProblem(**{k: jnp.asarray(v) for k, v in p.items()})
    tprob = tba.BAProblem(**{k: torch.from_numpy(np.array(v)) for k, v in p.items()})
    tprob = tprob._replace(kf_idx=tprob.kf_idx.long(), lm_idx=tprob.lm_idx.long())
    ref, costs_r, out_r = jba.bundle_adjust(jprob, cj, n_iters=n_iters)
    got, costs_t, out_t = tba.bundle_adjust(tprob, ct, n_iters=n_iters)
    np.testing.assert_array_equal(np_(out_t), np.asarray(out_r))
    assert np_(out_t).sum() >= 10  # the planted outliers are rejected
    np.testing.assert_allclose(np_(got.R), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(np_(got.t), np.asarray(ref.t), atol=1e-4)
    np.testing.assert_allclose(np_(got.points), np.asarray(ref.points), atol=1e-3)
    np.testing.assert_allclose(np_(costs_t), np.asarray(costs_r), rtol=1e-3)


def test_optimize_pose_batch_matches_jax():
    """Per-frame pose GN over a batch: inlier sets identical, poses within
    1e-4 (the single-frame `optimize_pose` tolerance)."""
    cj, ct = _cams()
    rng = np.random.default_rng(6)
    F, N = 4, 150
    pts = np.stack([rng.uniform(-2, 2, (F, N)), rng.uniform(-1.5, 1.5, (F, N)),
                    rng.uniform(3, 8, (F, N))], -1).astype(np.float32)
    uv = (np.asarray(cj.project(jnp.asarray(pts))) + rng.normal(0, 0.5, (F, N, 2)))
    uv[:, :10] += 30.0
    uv = uv.astype(np.float32)
    info = (1.0 / 1.2 ** (2.0 * rng.integers(0, 4, (F, N)))).astype(np.float32)
    valid = rng.random((F, N)) < 0.9
    valid[3, 60:] = False  # a padded frame
    R0 = np.stack([_rot([0.01, -0.02 * f, 0.005]) for f in range(1, F + 1)])
    t0 = rng.normal(0, 0.05, (F, 3)).astype(np.float32)
    ref = [np.asarray(x) for x in j_pose_batch(*(jnp.asarray(x) for x in
                                                 (R0, t0, pts, uv, info, valid)), cj)]
    got = [np_(x) for x in t_pose_batch(*(torch.from_numpy(x) for x in
                                          (R0, t0, pts, uv, info, valid)), ct,
                                        device="cpu")]
    np.testing.assert_allclose(got[0], ref[0], atol=1e-4)
    np.testing.assert_allclose(got[1], ref[1], atol=1e-4)
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_array_equal(got[3], ref[3])
    np.testing.assert_allclose(got[0], np.tile(np.eye(3), (F, 1, 1)), atol=2e-3)
