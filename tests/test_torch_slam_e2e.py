"""The slice as a whole, CPU: the JAX `Tracker` + `LocalMapper` against the
port's on the same 30-frame feature-level sequence (the world, orbit and
frames of `tests/test_slam_e2e.py`), the port handed the two-view RANSAC
samples the reference drew (`Tracker.sample_fn`).

Both packages run f32 solves in different summation orders, and the
reference's own init BA leaves the monocular scale direction free (one
fixed keyframe), so the maps drift apart by ~1e-4 after the init and a
keyframe decision on a borderline inlier count may move by a frame. The
test holds what that cannot move: the same init frame, the same keyframe
count at the end, every frame tracked by both, per-frame poses within
2e-3 (rotation entries, and translation in map units where the init's
median depth is 1; measured 7e-4), and point counts within 2% (measured
600 against 602)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from orbslam3_tpu.core.camera import Camera as JCamera
from orbslam3_tpu.engine.local_mapping import LocalMapper as JMapper
from orbslam3_tpu.engine.tracking import Tracker as JTracker, TrackerConfig as JTC
from orbslam3_tpu.slam_map.map_state import MapConfig as JMC, MapState as JMS
from orbslam3_tpu.utils import synth
from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.core.camera import Camera as TCamera
from orbslam3_tpu_torch.engine.local_mapping import LocalMapper as TMapper
from orbslam3_tpu_torch.engine.tracking import Tracker as TTracker, TrackerConfig as TTC
from orbslam3_tpu_torch.slam_map.map_state import MapConfig as TMC, MapState as TMS

FRAMES = 30
POSE_TOL = 2e-3
POINT_SHARE = 0.02


def reference_samples(frame_id: int, mask: np.ndarray) -> np.ndarray:
    """The (200, 8) indices `reconstruct_two_views` draws in the reference
    tracker at this frame (its key is PRNGKey(frame_id))."""
    m = jnp.asarray(mask)
    probs = m.astype(jnp.float32) / jnp.maximum(jnp.sum(m), 1.0)
    return np.asarray(jax.random.choice(jax.random.PRNGKey(frame_id), m.shape[0],
                                        shape=(200, 8), replace=True, p=probs))


@pytest.fixture(scope="module")
def runs():
    cj = JCamera.pinhole(458.0, 458.0, 320.0, 240.0, width=640, height=480)
    ct = TCamera.pinhole(458.0, 458.0, 320.0, 240.0, width=640, height=480, device="cpu")
    world = synth.make_world(n_points=3000, seed=4)
    R_gt, t_gt = synth.orbit_trajectory(n_frames=80, radius=3.0, arc=1.0)
    frames = [synth.render_features(world, R_gt[i], t_gt[i], cj, capacity=600,
                                    seed=100 + i)[0] for i in range(FRAMES)]

    jm = JMS(JMC(max_keyframes=64, max_points=8192, features_per_frame=600))
    jt = JTracker(cj, jm, JTC(n_features=600), local_mapper=JMapper(cj, jm))
    tm = TMS(TMC(max_keyframes=64, max_points=8192, features_per_frame=600), device="cpu")
    tt = TTracker(ct, tm, TTC(n_features=600), local_mapper=TMapper(ct, tm, device="cpu"),
                  device="cpu", sample_fn=reference_samples)
    out = {"jax": [], "port": []}
    for i, f in enumerate(frames):
        out["jax"].append(jt.process_features(f, 0.05 * i))
        fields = (np.asarray(getattr(f, k)) for k in
                  ("uv", "uv_raw", "response", "angle", "octave", "desc", "valid"))
        out["port"].append(tt.process_features(convert.frame_features(*fields, device="cpu"),
                                               0.05 * i))
    return out, (jm, jt), (tm, tt)


def test_same_init_frame_and_keyframe_count(runs):
    out, (jm, jt), (tm, tt) = runs
    tracked_j = [p is not None for p in out["jax"]]
    tracked_p = [p is not None for p in out["port"]]
    assert tracked_p == tracked_j
    init = tracked_j.index(True)
    assert 0 < init < 10 and all(tracked_j[init:])
    assert tm.n_keyframes == jm.n_keyframes >= 4
    assert abs(tm.n_points - jm.n_points) <= POINT_SHARE * jm.n_points
    assert tt.state.name == jt.state.name == "OK"


def test_poses_agree(runs):
    out, _, _ = runs
    worst = 0.0
    for pj, pp in zip(out["jax"], out["port"]):
        if pj is None:
            continue
        worst = max(worst, float(np.abs(np.asarray(pj[0]) - pp[0]).max()),
                    float(np.abs(np.asarray(pj[1]) - pp[1]).max()))
    assert worst < POSE_TOL, worst


def test_exported_trajectories_agree(runs):
    """`export_trajectory` composes the logged relative poses with the
    final keyframe poses in both packages: same timestamps, centres within
    the pose tolerance."""
    _, (_, jt), (_, tt) = runs
    ts_j, c_j = jt.export_trajectory()
    ts_p, c_p = tt.export_trajectory()
    np.testing.assert_array_equal(ts_p, ts_j)
    np.testing.assert_allclose(c_p, c_j, atol=POSE_TOL)
