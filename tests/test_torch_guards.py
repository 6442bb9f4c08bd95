"""Parity of the port's failure and lifecycle paths against the JAX package,
CPU: the timestamp guards, the bad-IMU reset and the failure ladder of
`Slam._after_track`, and the tracker's BoW reference-keyframe fallback.

The cases are those of `tests/test_guards.py` and
`tests/test_recovery.py::test_bow_refkf_fallback_recovers_tracking`, plus
LOST on a mature map. Both packages' `Slam` track the same feature-level
frames (`render_features` of each package's `utils/synth.py`, equal bit
for bit) in lockstep, one module-scoped run per sensor, the faults
injected along it in order; every tracker the port makes takes the
two-view RANSAC samples the reference drew. After each fault the test
holds the same `Slam.events` kinds in order, the same number of maps, the
same keyframe count on the active map and the same tracker state as the
JAX package's, and the JAX tests' own assertions on the port.

Monocular run: frames 0-29, the BoW fallback at frame 10 (a poisoned
velocity model, the vocabulary's words bound for that frame only; the
pose within the pose GN tolerance of `tests/test_torch_tracking.py`, the
inlier count within BOW_INLIERS); 10 dropped frames (frames 40-49
follow); LOST on the mature map (more than MATURE keyframes; frames of
another world until the ladder gives up after 3 of them, 20 by default:
the map is stored, a fresh one spawned); a new map on frames 60-65, then
a backward timestamp (respawn).

Mono-inertial run (no IMU samples, as the JAX tests): frames 0-19; a
forward gap of 3 s on the young map (reset in place); frames 22-27 on the
reset map; `bad_imu` set on the active map (reset).
"""

import numpy as np
import pytest

from orbslam3_tpu.core.camera import Camera as JCamera
from orbslam3_tpu.engine.system import Sensor as JSensor, Slam as JSlam
from orbslam3_tpu.engine.system import SystemConfig as JSC
from orbslam3_tpu.engine.tracking import TrackerConfig as JTC
from orbslam3_tpu.imu.preintegration import ImuCalib as JCalib
from orbslam3_tpu.place.vocab import build_vocabulary
from orbslam3_tpu.slam_map.map_state import MapConfig as JMC
from orbslam3_tpu.utils import synth as jsynth
from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.core.camera import Camera as TCamera
from orbslam3_tpu_torch.engine.system import Sensor as TSensor, Slam as TSlam
from orbslam3_tpu_torch.engine.system import SystemConfig as TSC
from orbslam3_tpu_torch.engine.tracking import TrackerConfig as TTC
from orbslam3_tpu_torch.imu.preintegration import ImuCalib as TCalib
from orbslam3_tpu_torch.place.database import KeyFrameDatabase as TDB
from orbslam3_tpu_torch.slam_map.map_state import MapConfig as TMC
from orbslam3_tpu_torch.utils import synth as tsynth
from test_torch_slam_e2e import reference_samples
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CJ = JCamera.pinhole(458.0, 458.0, 320.0, 240.0, width=640, height=480)
CT = TCamera.pinhole(458.0, 458.0, 320.0, 240.0, width=640, height=480, device="cpu")
POSE_TOL = 1e-4  # rotation entries and translation (tests/test_torch_tracking.py's POSE_ATOL)
# LOST on a map of more keyframes than this stores it (10 by default; the
# monocular run's map holds 6-7 at its LOST)
MATURE = 5
# keyframes the two active maps may differ by while tracking: the
# weakness test (n_in < 0.9 x the reference keyframe's well-observed
# points) is borderline on this sequence; at frame 13 the JAX package
# tracks 321 inliers and the port 322 against 0.9 x 357 = 321.3, so the
# port takes that keyframe one frame later. Right after a reset or a
# respawn the counts are equal.
KF_SPREAD = 1
# the BoW fallback's frame: the maps still hold the same keyframes there
BOW_FRAME = 10
# inliers the recovered frames may differ by: the two maps' points part by
# ~1e-5 after the initialization's BA (f32 sums in another order), and the
# port tracks one inlier more than the JAX package on most frames 5-12,
# frame 10 among them without the fault (346 against 345)
BOW_INLIERS = 1


class Lockstep:
    """Both packages' `Slam` on the same frames of the JAX tests' world and
    orbit. `snapshots[name]` holds, per package, what a case compares."""

    def __init__(self, sensor: str, **system):
        self.jworld = jsynth.make_world(n_points=3000, seed=4)
        self.tworld = tsynth.make_world(n_points=3000, seed=4)
        self.R_gt, self.t_gt = tsynth.orbit_trajectory(n_frames=80, radius=3.0, arc=1.0)
        jcfg = JSC(sensor=getattr(JSensor, sensor), map=JMC(64, 8192, 600),
                   tracker=JTC(n_features=600), **system)
        tcfg = TSC(sensor=getattr(TSensor, sensor), map=TMC(64, 8192, 600),
                   tracker=TTC(n_features=600), **system)
        if sensor != "MONOCULAR":
            jcfg.imu_calib, tcfg.imu_calib = JCalib.create(), TCalib.create()
        self.js = JSlam(CJ, jcfg)
        self.ts = TSlam(CT, tcfg, device="cpu")
        make = self.ts._make_tracker

        def with_samples(client_id):  # also the trackers of a reset or respawn
            tracker = make(client_id)
            tracker.sample_fn = reference_samples
            return tracker
        self.ts._make_tracker = with_samples
        self.ts.trackers[0].sample_fn = reference_samples
        self.snapshots = {}
        self.poses = []

    def feed(self, i: int, stamp: float, seed: int = None, other_world: bool = False):
        """Frame i's features (seed 100 + i unless given) at `stamp` through
        both; with `other_world`, a world the maps never saw."""
        seed = 100 + i if seed is None else seed
        jw, tw = self.jworld, self.tworld
        if other_world:
            if not hasattr(self, "other"):
                self.other = (jsynth.make_world(n_points=3000, seed=77),
                              tsynth.make_world(n_points=3000, seed=77))
            jw, tw = self.other
        jf, _ = jsynth.render_features(jw, self.R_gt[i], self.t_gt[i], CJ, capacity=600,
                                       seed=seed)
        tf, _ = tsynth.render_features(tw, self.R_gt[i], self.t_gt[i], CT, capacity=600,
                                       seed=seed, device="cpu")
        pj = self.js.track_features(jf, stamp)
        pt = self.ts.track_features(tf, stamp)
        self.poses.append((pj, pt))
        return pj, pt

    def snap(self, name: str):
        self.snapshots[name] = {key: state(slam) for key, slam in
                                (("jax", self.js), ("port", self.ts))}


def state(slam) -> dict:
    tracker = slam.trackers[0]
    return dict(events=[e["event"] for e in slam.events], maps=len(slam.atlas.maps),
                active_keyframes=int(slam.atlas.active.n_keyframes),
                state=tracker.state.name, n_inliers=int(tracker.n_inliers),
                imu_initialized=bool(slam.atlas.active.imu_initialized),
                bad_imu=bool(slam.atlas.active.bad_imu))


def bind_words(run: Lockstep, voc):
    """The vocabulary's word function on both client-0 trackers (what `Slam`
    binds with a vocabulary), and call counters on the fallback."""
    import jax.numpy as jnp
    from orbslam3_tpu.place.vocab import descend
    lv, vv, _ = voc.device_tensors()
    tdb = TDB(convert.vocabulary(voc), max_keyframes=4, device="cpu")
    calls = {"jax": 0, "port": 0}
    for key, tr, words in (
            ("jax", run.js.trackers[0],
             lambda d: np.asarray(descend(jnp.asarray(d), lv, vv, voc.k))),
            ("port", run.ts.trackers[0], tdb.words)):
        tr.bow_fn, tr.bow_k = words, voc.k
        orig = tr._track_reference_keyframe_bow

        def counted(*a, _orig=orig, _key=key, **kw):
            calls[_key] += 1
            return _orig(*a, **kw)
        tr._track_reference_keyframe_bow = counted
    return calls


def unbind_words(run: Lockstep):
    for tr in (run.js.trackers[0], run.ts.trackers[0]):
        tr.bow_fn = None
        del tr._track_reference_keyframe_bow


@pytest.fixture(scope="module")
def mono():
    run = Lockstep("MONOCULAR", min_kfs_to_store_map=MATURE)
    dt = 0.05
    for i in range(BOW_FRAME):
        run.feed(i, dt * i)

    # the BoW reference-keyframe fallback: a 25 deg/frame spin and a large
    # step throw the prediction outside every window
    from scipy.spatial.transform import Rotation
    voc = build_vocabulary(np.packbits(run.jworld.desc_bits, axis=1).view(np.uint32)
                           .reshape(-1, 8), k=6, depth=3, seed=0)
    calls = bind_words(run, voc)
    before = [(tr.R_cw.copy(), tr.t_cw.copy()) for tr in (run.js.trackers[0],
                                                         run.ts.trackers[0])]
    for tr in (run.js.trackers[0], run.ts.trackers[0]):
        tr._vel_R = Rotation.from_rotvec([0, 0.44, 0]).as_matrix().astype(np.float32)
        tr._vel_t = np.array([0.5, 0.2, 0.1], np.float32)
    run.feed(BOW_FRAME, dt * BOW_FRAME)
    run.snap("bow")
    run.bow = dict(calls=calls, before=before, poses=run.poses[-1])
    unbind_words(run)
    for i in range(BOW_FRAME + 1, 30):
        run.feed(i, dt * i)
    run.snap("base")

    for i in range(40, 50):  # frames 31-39 dropped
        run.feed(i, dt * i)
    run.snap("dropped")

    # LOST on the mature map: frames of another world until the ladder
    # stores the map and spawns a fresh one; the lanes give up after 3
    # failed frames here (20 by default)
    for slam in (run.js, run.ts):
        slam.cfg.tracker.recently_lost_frames = 3
    i = 50
    while not any(e["event"] in ("map_stored", "map_reset") for e in run.ts.events) \
            and i < 60:
        run.feed(i, dt * i, seed=500 + i, other_world=True)
        i += 1
    run.snap("lost")

    # a new map on frames 60-69 (timestamps after the lost run's), then
    # the clock goes back by 5 s
    t0 = dt * i
    for j in range(60, 66):
        run.feed(j, t0 + dt * (j - 60))
    run.snap("new_map")
    run.feed(66, t0 + dt * 5 - 5.0, seed=990)
    run.snap("backward")
    return run


@pytest.fixture(scope="module")
def inertial():
    run = Lockstep("IMU_MONOCULAR")
    dt = 0.05
    for i in range(20):
        run.feed(i, dt * i)
    run.snap("base")
    gap = dt * 19 + 3.0  # a 3 s gap while the map's IMU is young
    run.feed(21, gap, seed=991)
    run.snap("gap")
    for i in range(22, 28):
        run.feed(i, gap + dt * (i - 21))
    run.snap("reinit")
    for slam in (run.js, run.ts):
        slam.atlas.active.bad_imu = True
    run.feed(28, gap + dt * 7, seed=992)
    run.snap("bad_imu")
    return run


def assert_same(run: Lockstep, name: str, kf_spread: int = 0):
    """The port's snapshot `name` against the JAX package's: the same
    events, maps, state and IMU flags, keyframes within `kf_spread`."""
    j, p = run.snapshots[name]["jax"], run.snapshots[name]["port"]
    keys = ("events", "maps", "state", "imu_initialized", "bad_imu")
    assert {k: p[k] for k in keys} == {k: j[k] for k in keys}, name
    assert abs(p["active_keyframes"] - j["active_keyframes"]) <= kf_spread, (name, j, p)
    return p


def test_mono_run_matches_jax_before_the_faults(mono):
    p = assert_same(mono, "base")
    assert p["state"] == "OK" and p["active_keyframes"] >= 4 and p["maps"] == 1


def test_backward_timestamp_respawns_map(mono):
    before = assert_same(mono, "new_map")
    p = assert_same(mono, "backward")
    assert before["state"] == "OK" and before["active_keyframes"] > 0
    assert p["maps"] == before["maps"] + 1
    new = p["events"][len(before["events"]):]
    assert new[0] == "timestamp_jump"
    assert p["active_keyframes"] == 0 and p["state"] == "NO_IMAGES_YET"


def test_dropped_frames_recover(mono):
    p = assert_same(mono, "dropped", KF_SPREAD)
    assert p["state"] in ("OK", "RECENTLY_LOST") and p["maps"] == 1
    assert p["n_inliers"] >= 15 and mono.snapshots["dropped"]["jax"]["n_inliers"] >= 15


def test_lost_on_a_mature_map_stores_it_and_spawns(mono):
    before = mono.snapshots["dropped"]["port"]
    p = assert_same(mono, "lost")
    assert before["active_keyframes"] > MATURE
    assert mono.snapshots["dropped"]["jax"]["active_keyframes"] > MATURE
    new = p["events"][len(before["events"]):]
    assert new == ["map_stored", "map_created"]
    assert p["maps"] == 2 and p["active_keyframes"] == 0
    stored = [m for mid, m in mono.ts.atlas.maps.items() if mid != mono.ts.atlas.active_id]
    assert stored[0].n_keyframes == before["active_keyframes"]


def test_bow_refkf_fallback_recovers_tracking(mono):
    p = assert_same(mono, "bow")
    calls, (pj, pt) = mono.bow["calls"], mono.bow["poses"]
    assert calls["port"] == calls["jax"] >= 1, calls
    assert p["state"] == "OK" and pt is not None and pj is not None
    assert abs(p["n_inliers"] - mono.snapshots["bow"]["jax"]["n_inliers"]) <= BOW_INLIERS
    np.testing.assert_allclose(pt[0], np.asarray(pj[0]), atol=POSE_TOL)
    np.testing.assert_allclose(pt[1], np.asarray(pj[1]), atol=POSE_TOL)
    # continuous with frame 29's pose, not the poisoned prediction
    R29, t29 = mono.bow["before"][1]
    assert np.linalg.norm(pt[1] - t29) < 0.5
    assert np.degrees(np.arccos(np.clip((np.trace(pt[0] @ R29.T) - 1) / 2, -1, 1))) < 8.0


def test_forward_gap_resets_young_inertial_map(inertial):
    before = assert_same(inertial, "base")
    assert before["active_keyframes"] > 0 and not before["imu_initialized"]
    p = assert_same(inertial, "gap")
    assert p["active_keyframes"] == 0 and p["maps"] == 1  # reset in place, not stored
    new = p["events"][len(before["events"]):]
    assert new[:2] == ["timestamp_jump", "map_reset"]


def test_bad_imu_forces_reset(inertial):
    before = assert_same(inertial, "reinit")
    assert before["active_keyframes"] > 0
    p = assert_same(inertial, "bad_imu")
    assert not p["bad_imu"] and p["active_keyframes"] == 0 and p["maps"] == 1
    new = p["events"][len(before["events"]):]
    assert new[:2] == ["bad_imu_reset", "map_reset"]
