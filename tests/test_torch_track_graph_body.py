"""The body that `engine/track_program.py:TrackPoseGraph` captures, run
eagerly on the CPU, against `fused_track_pose`'s eager attempt and ladder.

The graph body differs from the eager attempt in one op: R goes back on
SO(3) through `lie.so3_polar64` instead of the SVD, the SVD's rotation in
float64 bit for bit, and the body then equals the eager attempt with the
SVD in float64 bit for bit. On `tests/
test_torch_tracking.py`'s scene, and on it with the virtual right
coordinates of `tests/test_torch_stereo_opt.py`, every index, mask and
count is exact and R, t are within 1e-5. The ladder over the graph body
(`_ladder`, as the card runs it, a result kept apart by `_own`) gives the
eager ladder's answer, in the rejected-refinement case and at the BoW
fallback's radii too. The replays themselves run on the card
(`tests/test_torch_cuda.py`)."""

import numpy as np
import pytest
import torch

from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.core import lie
from orbslam3_tpu_torch.engine import track_program as tp
from orbslam3_tpu_torch.utils import timing
from test_torch_stereo_opt import BF, _stereo_obs
from test_torch_tracking import CAM, _pinhole, _track_scene, _words_t
from torch_parity import np_, one_torch_thread, t32  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RADII = (15.0, 30.0, 60.0, 8.0)
BOW_RADII = (15.0, 15.0, 15.0, 8.0)
MAX_DIST = 100
EXACT = ("sel", "fidx", "vsel", "inl", "nm", "n_in", "fr", "oct", "uv")
POSE_ATOL = 1e-5


def _case(stereo: bool, offset=(0.0, 0.0, 0.01)):
    """The frame tuple as `fused_track_pose` hands it on (packed words, as
    the tracker's), the true pose and the offset prediction."""
    sc, R_true, t_true, perm = _track_scene()
    u_right, bf = None, None
    if stereo:
        rng = np.random.default_rng(2)
        xc = sc["mp_pos"][:len(perm)] @ R_true.T + t_true
        u_r = np.full(len(sc["f_uv"]), -1.0, np.float32)
        u_r[perm] = _stereo_obs(rng, sc["f_uv"][perm], xc[:, 2])
        u_right, bf = t32(u_r), BF
    mp = convert.map_points(sc["mp_pos"], sc["mp_desc"], sc["mp_normal"], sc["mp_min_d"],
                            sc["mp_max_d"], device="cpu")
    frame = (mp["mp_pos"], mp["mp_desc"], torch.from_numpy(sc["mp_valid"].copy()),
             mp["mp_normal"], mp["mp_min_dist"], mp["mp_max_dist"], _pinhole(*CAM)[1],
             t32(sc["f_uv"]), _words_t(sc["f_desc"]), torch.from_numpy(sc["f_oct"].copy()),
             torch.from_numpy(sc["f_valid"].copy()), u_right, bf)
    return frame, t32(R_true), t32(t_true + np.asarray(offset, np.float32))


def _graph(frame, graphs=None):
    """The case's graph of a (new) `TrackPoseGraphs`, its buffers loaded."""
    graphs = tp.TrackPoseGraphs() if graphs is None else graphs
    graph = graphs.get(frame[0].shape[0], frame[7].shape[0], frame[11] is not None, frame[6],
                       MAX_DIST, "cpu")
    graph.load(*frame)
    return graph


def _assert_same(got: dict, ref: dict):
    assert set(got) == set(ref)
    for key in EXACT:
        np.testing.assert_array_equal(np_(got[key]), np_(ref[key]), err_msg=key)
    for key in ("R", "t"):
        np.testing.assert_allclose(np_(got[key]), np_(ref[key]), atol=POSE_ATOL, err_msg=key)


def _eager_ladder(frame, R_pred, t_pred, R_last, t_last, allow_last, radii,
                  min_matches=20, min_inliers=15):
    return tp.fused_track_pose(*frame[:6], frame[6], *frame[7:11], R_pred, t_pred, R_last,
                               t_last, allow_last, radii, min_matches, min_inliers,
                               max_dist=MAX_DIST, device="cpu", u_right=frame[11],
                               bf=frame[12])


def _graph_ladder(graph, frame, R_pred, t_pred, R_last, t_last, allow_last, radii,
                  min_matches=20, min_inliers=15):
    K, cap = frame[0].shape[0], frame[7].shape[0]
    return tp._ladder(graph.eager, tp._own, K, cap, torch.device("cpu"), R_pred, t_pred,
                      R_last, t_last, allow_last, list(radii), min_matches, min_inliers)


@pytest.mark.parametrize("stereo,offset,radius", [
    (False, (0.0, 0.0, 0.01), 15.0),
    (False, (0.35, 0.0, 0.0), 30.0),
    (False, (0.0, 0.0, 0.0), 8.0),
    (True, (0.0, 0.0, 0.01), 15.0),
    (True, (0.35, 0.0, 0.0), 30.0),
], ids=["mono-narrow", "mono-wide", "mono-local", "stereo-narrow", "stereo-wide"])
def test_the_graph_body_equals_the_eager_attempt(stereo, offset, radius):
    """One attempt through the buffers and `so3_polar64` against the eager
    attempt on the caller's tensors and the SVD."""
    frame, R, t = _case(stereo, offset)
    got = _graph(frame).eager(R, t, radius)
    ref = tp._eager_attempt(frame, MAX_DIST, R, t, radius)
    _assert_same(got, ref)
    assert int(ref["nm"]) >= 20 and int(ref["n_in"]) >= 15


@pytest.mark.parametrize("scale", [1e-6, 1e-4, 1e-2])
def test_so3_polar64_is_the_svd_in_float64(scale):
    """The graph's normalization: for float32 matrices `scale` off a
    rotation, the SVD's rotation in float64 rounded to float32, bit for
    bit."""
    gen = torch.Generator().manual_seed(7)
    Q = torch.linalg.qr(torch.randn(2000, 3, 3, dtype=torch.float64, generator=gen))[0]
    Q = Q * torch.sign(torch.linalg.det(Q))[:, None, None]
    P = (Q + scale * torch.randn(2000, 3, 3, dtype=torch.float64, generator=gen)).float()
    got = lie.so3_polar64(P)
    assert got.dtype == torch.float32
    assert torch.equal(got, lie.so3_normalize(P.double()).float())


@pytest.mark.parametrize("stereo,offset,radius", [
    (False, (0.35, 0.0, 0.0), 30.0),
    (True, (0.0, 0.0, 0.01), 15.0),
], ids=["mono-wide", "stereo-narrow"])
def test_the_graph_body_is_the_attempt_with_the_svd_in_float64(stereo, offset, radius,
                                                              monkeypatch):
    """With the eager attempt's SVD taken in float64, the graph body gives
    its answer bit for bit: `so3_polar64` is the one op between them."""
    frame, R, t = _case(stereo, offset)
    got = _graph(frame).eager(R, t, radius)
    svd = lie.so3_normalize
    monkeypatch.setattr(lie, "so3_normalize", lambda M: svd(M.double()).to(M.dtype))
    ref = tp._eager_attempt(frame, MAX_DIST, R, t, radius)
    for key in ref:
        assert torch.equal(got[key], ref[key]), key


@pytest.mark.parametrize("stereo,offset,allow_last,last_is_truth,ok", [
    (False, (0.0, 0.0, 0.01), False, False, True),
    (False, (0.35, 0.0, 0.0), False, False, True),
    (False, (3.0, 0.0, 0.0), True, True, True),
    (False, (3.0, 0.0, 0.0), False, True, False),
    (True, (0.35, 0.0, 0.0), False, False, True),
], ids=["good_prediction", "ladder_widens", "recovers_from_last", "lost_without_last",
        "stereo_ladder_widens"])
def test_the_graph_ladder_equals_the_eager_ladder(stereo, offset, allow_last, last_is_truth,
                                                  ok):
    """`tests/test_torch_tracking.py`'s scenarios: the ladder over the graph
    body takes the eager ladder's attempts and returns its answer."""
    frame, R, t = _case(stereo, offset)
    R_true, t_true = _case(stereo, (0.0, 0.0, 0.0))[1:]
    R_last, t_last = (R_true, t_true) if last_is_truth else (R, t)
    before = timing.counts().get("track.ladder_attempt", 0)
    ok_ref, ref = _eager_ladder(frame, R, t, R_last, t_last, allow_last, RADII)
    eager_attempts = timing.counts()["track.ladder_attempt"] - before
    ok_got, got = _graph_ladder(_graph(frame), frame, R, t, R_last, t_last, allow_last, RADII)
    assert ok_got == ok_ref == ok
    assert timing.counts()["track.ladder_attempt"] - before == 2 * eager_attempts
    _assert_same(got, ref)


@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "stereo"])
def test_a_rejected_refinement_returns_the_acquisition(stereo):
    """With a refinement gate no attempt meets, the ladder returns the
    acquisition, apart from the replays after it, with the refinement's
    frustum mask, as the eager ladder does."""
    frame, R, t = _case(stereo)
    graph = _graph(frame)
    ok_got, got = _graph_ladder(graph, frame, R, t, R, t, False, RADII, min_inliers=10 ** 6)
    ok_ref, ref = _eager_ladder(frame, R, t, R, t, False, RADII, min_inliers=10 ** 6)
    assert ok_got and ok_ref
    _assert_same(got, ref)
    acq = graph.eager(R, t, RADII[0])
    refine = graph.eager(acq["R"], acq["t"], RADII[3])
    for key in set(acq) - {"fr"}:
        assert torch.equal(got[key], acq[key]), key
    assert torch.equal(got["fr"], refine["fr"])
    assert not torch.equal(got["R"], refine["R"])


@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "stereo"])
def test_the_bow_fallback_radii_go_through_the_same_body(stereo):
    """The BoW fallback's second ladder (the narrow radius three times, no
    last pose) on the tracker's graph of the first: one graph serves both,
    and both give the eager ladder's answers."""
    frame, R, t = _case(stereo, (0.35, 0.0, 0.0))
    graphs = tp.TrackPoseGraphs()
    for radii, allow_last in ((RADII, True), (BOW_RADII, False)):
        ok_got, got = _graph_ladder(_graph(frame, graphs), frame, R, t, R, t, allow_last,
                                    radii)
        ok_ref, ref = _eager_ladder(frame, R, t, R, t, allow_last, radii)
        assert ok_got == ok_ref
        _assert_same(got, ref)
    assert len(graphs.graphs) == 1


def test_the_graphs_key_on_what_a_capture_fixes():
    """One graph a (K, cap, stereo row, camera kind and size, max_dist,
    device); the same key returns the same graph."""
    from orbslam3_tpu_torch.core.camera import Camera
    graphs = tp.TrackPoseGraphs()
    pin = Camera.pinhole(458.0, 457.0, 367.0, 248.0, device="cpu")
    kb8 = Camera.kb8(190.0, 190.0, 254.0, 256.0, 0.0, 0.0, 0.0, 0.0, device="cpu")
    first = graphs.get(256, 128, False, pin, MAX_DIST, "cpu")
    assert graphs.get(256, 128, False, pin, MAX_DIST, torch.device("cpu")) is first
    others = [graphs.get(512, 128, False, pin, MAX_DIST, "cpu"),
              graphs.get(256, 64, False, pin, MAX_DIST, "cpu"),
              graphs.get(256, 128, True, pin, MAX_DIST, "cpu"),
              graphs.get(256, 128, False, kb8, MAX_DIST, "cpu"),
              graphs.get(256, 128, False, pin, 50, "cpu")]
    assert len({id(g) for g in [first, *others]}) == 6 == len(graphs.graphs)
    assert others[0].mp_pos.shape == (512, 3) and others[1].f_uv.shape == (64, 2)
    assert others[2].u_right.shape == (128,) and first.u_right is None


def test_the_cpu_ladder_runs_eagerly_with_graphs_given():
    """On the CPU `fused_track_pose` runs every attempt eagerly, graphs or
    none: the same answer, one `track.pose_eager` an attempt, no graph."""
    frame, R, t = _case(False, (0.35, 0.0, 0.0))
    names = ("track.ladder_attempt", "track.pose_eager", "track.pose_replay",
             "track.pose_capture")

    def counted():
        return [timing.counts().get(n, 0) for n in names]

    start = counted()
    ok_ref, ref = _eager_ladder(frame, R, t, R, t, False, RADII)
    graphs = tp.TrackPoseGraphs()
    ok_got, got = tp.fused_track_pose(*frame[:11], R, t, R, t, False, RADII, 20, 15,
                                      max_dist=MAX_DIST, device="cpu", graphs=graphs)
    attempts = counted()[0] - start[0]
    assert ok_got and ok_ref and attempts >= 4 and not graphs.graphs
    assert [b - a for a, b in zip(start, counted())] == [attempts, attempts, 0, 0]
    for key in ref:
        assert torch.equal(got[key], ref[key]), key
