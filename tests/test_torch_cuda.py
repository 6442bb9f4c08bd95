"""The port's CUDA kernels on the card, against their plain versions.

Imports no JAX, so it also runs on a machine with a card and no jax:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider

(`--noconftest` skips tests/conftest.py, which imports jax). On a machine
without a card every test here skips through the `cuda` fixture. The
kernels must equal their plain versions exactly: both compute integer
distances or copy floats."""

import numpy as np
import pytest
import torch

from orbslam3_tpu_torch import _build
from orbslam3_tpu_torch.kernels import hamming, patch
from orbslam3_tpu_torch.kernels import orb_descriptor as desc_k
from orbslam3_tpu_torch.vision.frame import extract_features
from torch_parity import CASES, cuda, textured_image, top2_case  # noqa: F401


def _words_t(words):
    return torch.from_numpy(words.view(np.int32).copy())


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_top2_kernel_equals_plain(cuda, name):
    a, b, mask = top2_case(name)
    args = (_words_t(a), _words_t(b), torch.from_numpy(mask))
    ref = hamming.masked_top2_reference(*args)
    before = _build.launches[hamming.KERNEL]
    got = hamming.masked_top2(*(x.to(cuda) for x in args))
    torch.cuda.synchronize()
    assert _build.launches[hamming.KERNEL] == before + 1
    for r, g in zip(ref, got):
        assert torch.equal(g.cpu(), r)


@pytest.mark.cuda
def test_top2_kernel_at_tracking_shape(cuda):
    """(2048, 1200) with a sparse mask: the shape of the tracker's search."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.integers(-2**31, 2**31, (2048, 8)).astype(np.int32)).to(cuda)
    b = torch.from_numpy(rng.integers(-2**31, 2**31, (1200, 8)).astype(np.int32)).to(cuda)
    b[600:] = b[:600]  # ties everywhere
    mask = torch.from_numpy(rng.random((2048, 1200)) < 0.02).to(cuda)
    got = hamming.masked_top2(a, b, mask)
    ref = hamming.masked_top2_reference(a, b, mask)
    for r, g in zip(ref, got):
        assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["m513", "window", "wide"])
def test_top2_kernel_uint8_mask_any_nonzero_byte(cuda, name):
    """A uint8 mask allows a pair wherever its byte is nonzero, not only 1."""
    a, b, mask = top2_case(name)
    rng = np.random.default_rng(4)
    weights = torch.from_numpy(mask * rng.integers(1, 256, mask.shape)).to(torch.uint8)
    args = (_words_t(a), _words_t(b))
    ref = hamming.masked_top2_reference(*args, torch.from_numpy(mask))
    got = hamming.masked_top2(*(x.to(cuda) for x in args), weights.to(cuda))
    for r, g in zip(ref, got):
        assert torch.equal(g.cpu(), r)


@pytest.mark.cuda
def test_top2_kernel_rejects_misaligned_words(cuda):
    w = torch.zeros(8 * 5 + 1, dtype=torch.int32, device=cuda)[1:].view(5, 8)
    with pytest.raises(ValueError, match="aligned"):
        hamming.masked_top2(w, w, torch.ones((5, 5), dtype=torch.bool, device=cuda))


@pytest.mark.cuda
def test_patch_kernel_equals_plain(cuda):
    """K2 at the main path's shapes: the (2272, 768) atlas, 1200 corners,
    some of them out of range (the kernel clamps them as the plain
    version does)."""
    rng = np.random.default_rng(9)
    img = torch.from_numpy(rng.uniform(0, 255, (2272, 768)).astype(np.float32)).to(cuda)
    ys = torch.from_numpy(rng.integers(-40, 2272, 1200).astype(np.int32)).to(cuda)
    xs = torch.from_numpy(rng.integers(-40, 768, 1200).astype(np.int32)).to(cuda)
    before = _build.launches[patch.KERNEL]
    got = patch.gather_patches(img, ys, xs)
    torch.cuda.synchronize()
    assert _build.launches[patch.KERNEL] == before + 1
    assert torch.equal(got, patch.gather_patches_reference(img, ys, xs))


@pytest.mark.cuda
def test_extract_features_kernel_path_equals_plain_path(cuda, monkeypatch):
    img = torch.from_numpy(textured_image(3, 240, 376)).to(cuda)
    before = _build.launches[patch.KERNEL]
    feats = extract_features(img, n_features=500, n_levels=4)
    assert _build.launches[patch.KERNEL] == before + 1
    monkeypatch.setattr(patch, "gather_patches", patch.gather_patches_reference)
    plain = extract_features(img, n_features=500, n_levels=4)
    for name in ("uv", "angle", "octave", "desc", "valid"):
        assert torch.equal(getattr(feats, name), getattr(plain, name)), name
    planes = desc_k.descriptor_planes(feats.desc)
    assert planes.is_cuda and planes.shape == (500, 256)


def _policy_mask(kind: str, n: int = 1200, seed: int = 12) -> np.ndarray:
    """(n, n) masks as the mono-init and triangulation policies build them
    at 752x480: 100 px windows between two frames' keypoints, and 2-sigma
    (7.68 px) epipolar bands between two keyframes 0.3 m apart."""
    rng = np.random.default_rng(seed)
    uv1 = rng.uniform(0, 1, (n, 2)) * (752, 480)
    uv2 = uv1[rng.permutation(n)] + rng.normal(0, 20, (n, 2))
    if kind == "init_window":
        return np.sum((uv1[:, None] - uv2[None]) ** 2, -1) <= 100.0 ** 2
    f, c = 458.0, np.array([376.0, 240.0])
    x1 = np.concatenate([(uv1 - c) / f, np.ones((n, 1))], 1)
    x2 = np.concatenate([(uv2 - c) / f, np.ones((n, 1))], 1)
    t = np.array([0.3, 0.02, 0.05])
    E = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    l2 = x1 @ E.T
    d = np.abs(l2 @ x2.T) / np.sqrt(l2[:, :1] ** 2 + l2[:, 1:2] ** 2) * f
    return d < 3.84 * 2.0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["init_window", "epipolar_band"])
def test_top2_kernel_equals_plain_on_policy_masks(cuda, kind):
    """K1 at the (1200, 1200) masks of the matcher policies the mono SLAM
    path adds, both directions (the mutual check), with duplicated
    descriptors so ties occur."""
    rng = np.random.default_rng(13)
    mask = _policy_mask(kind)
    a = rng.integers(0, 2 ** 32, (1200, 8), dtype=np.uint32)
    b = a[rng.permutation(1200)] ^ (rng.integers(0, 2, (1200, 8), dtype=np.uint32) << 5)
    b[600:] = b[:600]
    for aa, bb, mm in ((a, b, mask), (b, a, np.ascontiguousarray(mask.T))):
        args = (_words_t(aa), _words_t(bb), torch.from_numpy(mm))
        ref = hamming.masked_top2_reference(*args)
        got = hamming.masked_top2(*(x.to(cuda) for x in args), policy="test")
        for r, g in zip(ref, got):
            assert torch.equal(g.cpu(), r)
    assert 0.01 < mask.mean() < 0.5


@pytest.mark.cuda
def test_policies_launch_k1_once_per_direction(cuda):
    """search_for_initialization and search_for_triangulation run K1 in
    both directions, each launch counted under its policy."""
    from orbslam3_tpu_torch.core.camera import Camera
    from orbslam3_tpu_torch.vision import matcher
    rng = np.random.default_rng(14)
    uv = torch.from_numpy(rng.uniform(0, 400, (300, 2)).astype(np.float32)).to(cuda)
    words = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (300, 8)).astype(np.int32)).to(cuda)
    valid = torch.ones(300, dtype=torch.bool, device=cuda)
    cam = Camera.pinhole(458.0, 458.0, 376.0, 240.0, device=cuda)
    eye, t = torch.eye(3, device=cuda), torch.tensor([0.3, 0.0, 0.0], device=cuda)
    _build.launches.clear()
    matcher.search_for_initialization(uv, words, valid, uv + 3.0, words, valid)
    matcher.search_for_triangulation(uv, words, valid, uv + 3.0, words, valid,
                                     eye, torch.zeros(3, device=cuda), eye, t, cam)
    torch.cuda.synchronize()
    assert _build.launches[f"{hamming.KERNEL}[init]"] == 2
    assert _build.launches[f"{hamming.KERNEL}[triangulation]"] == 2
    assert _build.launches[hamming.KERNEL] == 4


def _vi_problem():
    """A small visual-inertial BA problem built by the port alone (this
    file imports no JAX): six keyframes 0.25 s apart on a simulated IMU
    trajectory (body == camera), landmarks seen by two or three of them
    with 0.5 px noise, perturbed starting states, the first keyframe
    fixed."""
    from orbslam3_tpu_torch.core import lie
    from orbslam3_tpu_torch.core.camera import Camera
    from orbslam3_tpu_torch.imu import preintegration as pre
    from orbslam3_tpu_torch.opt import inertial
    from orbslam3_tpu_torch.utils.synth import simulate_imu

    rng = np.random.default_rng(11)
    cam = Camera.pinhole(400.0, 400.0, 320.0, 240.0, width=640, height=480, device="cpu")
    traj = simulate_imu(duration=2.1, seed=3, acc_bias=(0.03, -0.02, 0.05))
    idx = [100 + 50 * k for k in range(6)]
    M = len(idx)
    pts, kf_idx, lm_idx, uv = [], [], [], []
    for k in range(M):
        xc = np.stack([rng.uniform(-2, 2, 40), rng.uniform(-1.5, 1.5, 40),
                       rng.uniform(3, 8, 40)], -1)
        for X in xc @ traj.R_wb[idx[k]].T + traj.p_wb[idx[k]]:
            seen = []
            for kk in range(k, min(k + 3, M)):
                xo = (X - traj.p_wb[idx[kk]]) @ traj.R_wb[idx[kk]]
                q = cam.project(torch.tensor(xo, dtype=torch.float32)).numpy()
                if xo[2] > 1.0 and 0 <= q[0] < 640 and 0 <= q[1] < 480:
                    seen.append((kk, q))
            if len(seen) >= 2:
                for kk, q in seen:
                    kf_idx.append(kk)
                    lm_idx.append(len(pts))
                    uv.append(q)
                pts.append(X)
    O, P = len(uv), len(pts)
    f32 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32)  # noqa: E731
    dR = lie.so3_exp(f32(rng.normal(0, 0.01, (M, 3))))
    prob = inertial.VIBAProblem(
        Rwb=f32(traj.R_wb[idx]) @ dR, twb=f32(traj.p_wb[idx] + rng.normal(0, 0.02, (M, 3))),
        vel=f32(traj.v_wb[idx] + rng.normal(0, 0.05, (M, 3))), bias=torch.zeros(M, 6),
        points=f32(np.asarray(pts) + rng.normal(0, 0.03, (P, 3))),
        kf_idx=torch.tensor(kf_idx), lm_idx=torch.tensor(lm_idx),
        uv=f32(np.asarray(uv) + rng.normal(0, 0.5, (O, 2))), info=torch.ones(O),
        valid=torch.ones(O, dtype=torch.bool), fixed_kf=torch.arange(M) == 0,
        fixed_lm=torch.zeros(P, dtype=torch.bool))
    calib = pre.ImuCalib.create()
    pres = [pre.preintegrate(*(f32(x[a:b]) for x in (traj.acc, traj.gyro, traj.dt)),
                             torch.zeros(6), calib) for a, b in zip(idx[:-1], idx[1:])]
    edges = inertial.build_edges(pres, [(k, k + 1) for k in range(M - 1)])
    return prob, edges, cam, calib, traj, idx


def _to(x, dev):
    return type(x)(*(v.to(dev) for v in x))


@pytest.mark.cuda
def test_visual_inertial_ba_on_the_card(cuda):
    """VI-BA on the card against the CPU (1e-4 of the largest entry; points
    1e-3 m), and two runs on the card bit for bit (segment sums in a fixed
    order)."""
    from orbslam3_tpu_torch.opt import inertial
    prob, edges, cam, _, _, _ = _vi_problem()
    eye, zero = torch.eye(3), torch.zeros(3)
    ref, ref_costs = inertial.visual_inertial_ba(prob, edges, cam, eye, zero, n_iters=8,
                                                 prior_gyro=1.0, prior_acc=1e5)
    runs = [inertial.visual_inertial_ba(_to(prob, cuda), _to(edges, cuda), cam.to(cuda),
                                        eye.to(cuda), zero.to(cuda), n_iters=8,
                                        prior_gyro=1.0, prior_acc=1e5) for _ in range(2)]
    got, costs = runs[0]
    for name in ("Rwb", "twb", "vel", "bias"):
        r = getattr(ref, name)
        assert (getattr(got, name).cpu() - r).abs().max() <= 1e-4 * r.abs().max() + 1e-6, name
    assert (got.points.cpu() - ref.points).abs().max() <= 1e-3
    assert torch.allclose(costs.cpu(), ref_costs, rtol=1e-3)
    for a, b in zip(runs[0][0], runs[1][0]):
        assert torch.equal(a, b)
    assert torch.equal(runs[0][1], runs[1][1])


@pytest.mark.cuda
def test_optimize_pose_inertial_on_the_card(cuda):
    """VI pose tracking on the card against the CPU: pose and velocity 1e-4,
    the inlier mask exact; two runs on the card bit for bit."""
    from orbslam3_tpu_torch.opt.pose_inertial import BodyState, optimize_pose_inertial
    prob, edges, cam, calib, traj, idx = _vi_problem()
    from orbslam3_tpu_torch.imu import preintegration as P
    i, j = idx[1], idx[2]
    f32 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32)  # noqa: E731
    window = P.preintegrate(*(f32(x[i:j]) for x in (traj.acc, traj.gyro, traj.dt)),
                            torch.zeros(6), calib)
    anchor = BodyState(f32(traj.R_wb[i]), f32(traj.p_wb[i]), f32(traj.v_wb[i]), torch.zeros(6))
    cur = BodyState(f32(traj.R_wb[j]), f32(traj.p_wb[j] + [0.05, -0.03, 0.04]),
                    f32(traj.v_wb[j] + [0.1, 0.0, -0.1]), torch.zeros(6))
    sel = prob.kf_idx == 2
    pts = prob.points[prob.lm_idx[sel]]
    uv, n = prob.uv[sel], int(sel.sum())
    args = (pts, uv, torch.ones(n), torch.ones(n, dtype=torch.bool))
    ref = optimize_pose_inertial(anchor, cur, window, calib, *args, cam)
    runs = [optimize_pose_inertial(_to(anchor, cuda), _to(cur, cuda), window.to(cuda), calib,
                                   *(x.to(cuda) for x in args), cam.to(cuda))
            for _ in range(2)]
    got = runs[0]
    for a, b in zip(got[0][:3], ref[0][:3]):
        assert (a.cpu() - b).abs().max() <= 1e-4 * b.abs().max()
    assert torch.equal(got[1].cpu(), ref[1]) and got[2] == ref[2]
    for a, b in zip(runs[0][0], runs[1][0]):
        assert torch.equal(a, b)
    assert torch.equal(runs[0][3].H, runs[1][3].H)
