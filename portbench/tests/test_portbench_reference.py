"""The plain reference that decides `correct`, held to what it claims."""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from harness import reference


@pytest.mark.parametrize("n, m, density, planes", [
    (300, 500, 0.05, False), (200, 100, 1.0, False), (50, 1, 1.0, False),
    (40, 60, 0.0, False), (120, 90, 0.3, True)])
def test_k1_definition_matches_the_ports_plain_version(n, m, density, planes):
    from orbslam3_tpu_torch.kernels import hamming, orb_descriptor
    rng = np.random.default_rng(n + m)
    a = rng.integers(-2**31, 2**31, (n, 8), dtype=np.int64).astype(np.int32)
    b = rng.integers(-2**31, 2**31, (m, 8), dtype=np.int64).astype(np.int32)
    if m >= 10:
        b[:5] = b[5:10]     # ties between columns
    mask = rng.uniform(size=(n, m)) < density
    want = hamming.masked_top2_reference(torch.from_numpy(a), torch.from_numpy(b),
                                         torch.from_numpy(mask))
    if planes:
        a = orb_descriptor.descriptor_planes(torch.from_numpy(a)).numpy()
        b = orb_descriptor.descriptor_planes(torch.from_numpy(b)).numpy()
    got = reference.masked_top2(a, b, mask)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w.numpy().astype(np.int64), g)
    assert reference.k1_rows_differ([(a, b, mask, [w.numpy() for w in want])]) == 0
    bad = [w.numpy().copy() for w in want]
    bad[1][::7] += 1
    assert reference.k1_rows_differ([(a, b, mask, bad)]) == len(bad[1][::7])


def test_k2_definition():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (100, 120)).astype(np.float32)
    ys, xs = np.array([0, 50, 90], np.int32), np.array([5, 100, 60], np.int32)
    out = np.stack([img[min(y, 68):min(y, 68) + 32, min(x, 88):min(x, 88) + 32]
                    for y, x in zip(ys, xs)])
    assert reference.k2_values_differ([(img, ys, xs, out)]) == 0
    out[1, 3, 4] += 1
    assert reference.k2_values_differ([(img, ys, xs, out)]) == 1


def _truth(n=40, seed=0):
    rng = np.random.default_rng(seed)
    R_wc = Rotation.from_rotvec(rng.normal(0, 0.3, (n, 3))).as_matrix()
    c = np.cumsum(rng.normal(0, 0.05, (n, 3)), 0) + np.array([0, 0, 5.0])
    R_cw = np.swapaxes(R_wc, 1, 2)
    return R_cw, -np.einsum("nij,nj->ni", R_cw, c), c


def test_trajectory_numbers_see_a_moved_world_as_exact_and_faults_as_errors():
    R_cw, t_cw, c = _truth()
    yaw = Rotation.from_rotvec([0, 0, 0.7]).as_matrix()
    off = np.array([1.0, -2.0, 0.5])
    # the same trajectory in a world turned about gravity and moved
    R_est = R_cw @ yaw.T
    t_est = -np.einsum("nij,nj->ni", R_est, c @ yaw.T + off)
    got = reference.trajectory_numbers(R_est, t_est, np.zeros(len(c)), R_cw, t_cw)
    assert got["ate_m"] < 1e-9 and got["rpe_p90_m"] < 1e-9 and got["repeated_poses"] == 0
    assert got["rpe_rot_p90_deg"] < 1e-5
    stale = np.repeat(t_est[:1], len(c), 0)
    got = reference.trajectory_numbers(np.repeat(R_est[:1], len(c), 0), stale,
                                       np.zeros(len(c)), R_cw, t_cw)
    assert got["ate_m"] > 0.05 and got["rpe_p90_m"] > 0.05
    assert got["rpe_rot_p90_deg"] > 10 and got["repeated_poses"] == len(c) - 1
    # two clients: a repeat counts within a client only
    client = np.arange(len(c)) % 2
    R2, t2 = R_est.copy(), t_est.copy()
    R2[2], t2[2] = R2[0], t2[0]
    assert reference.trajectory_numbers(R2, t2, client, R_cw, t_cw)["repeated_poses"] == 1


def test_map_numbers_scale_tilt_and_surfaces():
    R_cw, t_cw, c = _truth(seed=1)
    v = np.gradient(c, axis=0)
    box = ((-8, 8), (-5, 5), (-4, 14))
    pts = np.array([[-8.0, 0, 3], [0, 5.0, 1], [1, 1, 14.0]])
    got = reference.map_numbers(R_cw, t_cw, v, R_cw, t_cw, v, pts,
                                reference.box_surface_dist(box))
    assert got == pytest.approx(dict(kf_ate_m=0, kf_scale_err=0, tilt_deg=0, kf_vel_mps=0,
                                     map_pts_m=0), abs=1e-6)
    # a map at 1.1 x scale, tilted by 2 degrees about x
    tilt = Rotation.from_rotvec([np.radians(2.0), 0, 0]).as_matrix()
    R_est = R_cw @ tilt.T
    t_est = -np.einsum("nij,nj->ni", R_est, 1.1 * c @ tilt.T)
    got = reference.map_numbers(R_est, t_est, v @ tilt.T, R_cw, t_cw, v, pts @ tilt.T,
                                reference.box_surface_dist(box))
    assert got["kf_scale_err"] == pytest.approx(1 - 1 / 1.1, abs=1e-9)  # truth = s x map
    assert got["tilt_deg"] == pytest.approx(2.0, abs=1e-6)
    assert reference.nearest_dist(pts)(pts + [0, 0, 0.25]) == pytest.approx([0.25] * 3)
