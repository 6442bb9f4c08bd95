"""Port, CPU: asynchronous mapping (`engine/async_engine.py`, the worker
behind `Slam(async_mapping=True)`).

- The JAX package's `tests/test_async_engine.py` on the port's
  `AsyncBackend`: the queue drains in order, the abort flag is up while a
  burst waits and down for the last keyframe; a failing keyframe leaves
  the worker alive and `shutdown` re-raises its error. The JAX package's
  backend is driven the same way and gives the same order and flags.
- A feature-level session (the world and orbit of the JAX package's
  async test, 40 frames at 600 features) with `async_mapping=True`: no
  worker error, the queue empty after `flush`, at least 80% of the frames
  posed and the Sim3-aligned ATE under 0.05 (the JAX test's bound). The
  worker's timing decides which keyframes it sees, so the run is not held
  to the JAX package frame by frame.
- The launch counter `_build.count` stays exact when threads count at
  once.
- Every sensor builds its worker and `shutdown` joins it.
- A LOST spawn with keyframes still queued (the worker held until its
  stop is asked for): they are mapped and entered in the keyframe
  database under the stored map, which keeps a row for every keyframe;
  the fresh map starts with none.
"""

import threading
import time

import numpy as np
import pytest

from orbslam3_tpu.engine.async_engine import AsyncBackend as JAsyncBackend
from orbslam3_tpu_torch import _build
from orbslam3_tpu_torch.core.camera import Camera as TCamera
from orbslam3_tpu_torch.engine.async_engine import AsyncBackend
from orbslam3_tpu_torch.engine.system import Sensor, Slam, SystemConfig
from orbslam3_tpu_torch.engine.tracking import TrackerConfig
from orbslam3_tpu_torch.evaluation import ate_rmse
from orbslam3_tpu_torch.imu.preintegration import ImuCalib
from orbslam3_tpu_torch.place.vocab import build_vocabulary
from orbslam3_tpu_torch.slam_map.map_state import MapConfig
from orbslam3_tpu_torch.utils import synth
from orbslam3_tpu_torch.vision.frame import features_from_arrays
from torch_parity import one_torch_thread, random_words  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TCAM = TCamera.pinhole(458.0, 458.0, 320.0, 240.0, width=640, height=480, device="cpu")
FRAMES = 40
ATE_BOUND = 0.05


def _drain(cls):
    seen, aborts = [], []

    def work(k, abort):
        time.sleep(0.02)
        seen.append(k)
        aborts.append(abort())

    be = cls(work)
    for k in range(6):
        be.insert_keyframe(k)
    be.flush()
    assert be.queue_len() == 0
    be.shutdown()
    return seen, aborts


def test_backend_queue_and_abort():
    """The worker drains in order; the abort flag is up while a burst is
    queued, down for the last keyframe; the JAX package's backend alike."""
    seen, aborts = _drain(AsyncBackend)
    assert seen == list(range(6))
    assert aborts[-1] is False and any(aborts[:-1])
    jseen, jaborts = _drain(JAsyncBackend)
    assert seen == jseen and aborts[-1] == jaborts[-1]


def test_backend_survives_exceptions():
    calls = []

    def work(k, abort):
        calls.append(k)
        if k == 1:
            raise RuntimeError("boom")

    be = AsyncBackend(work)
    for k in range(3):
        be.insert_keyframe(k)
    be.flush()
    assert calls == [0, 1, 2] and be.alive
    assert len(be.errors) == 1
    with pytest.raises(RuntimeError, match="boom"):
        be.shutdown()
    assert not be.alive


def test_flush_has_a_deadline():
    release = threading.Event()
    be = AsyncBackend(lambda k, abort: release.wait(10.0))
    be.insert_keyframe(0)
    with pytest.raises(TimeoutError):
        be.flush(timeout=0.2)
    release.set()
    be.flush()
    be.shutdown()


def test_launch_counts_stay_exact_across_threads():
    _build.launches.clear()

    def hammer():
        for _ in range(20000):
            _build.count("k", "k[policy]")

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60.0)
    assert _build.snapshot() == {"k": 80000, "k[policy]": 80000}
    _build.launches.clear()


def test_async_slam_feature_session():
    world = synth.make_world(n_points=3000, seed=4)
    R_gt, t_gt = synth.orbit_trajectory(n_frames=60, radius=3.0, arc=1.0)
    ts = np.arange(FRAMES) * 0.05
    slam = Slam(TCAM, SystemConfig(map=MapConfig(64, 8192, 600),
                                   tracker=TrackerConfig(n_features=600), async_mapping=True),
                device="cpu")
    backend = slam._backend.backend
    assert backend is not None and backend.alive
    for i in range(FRAMES):
        feats, _ = synth.render_features(world, R_gt[i], t_gt[i], TCAM, capacity=600,
                                         seed=100 + i, device="cpu")
        slam.track_features(feats, float(ts[i]))
    slam.flush()
    backend = slam._backend.backend
    assert backend.queue_len() == 0 and backend.errors == []
    poses = slam._full_poses(0)
    assert len(poses) >= 0.8 * FRAMES
    est = np.array([p[2] for p in poses])
    gt = {round(float(t), 6): -R_gt[i].T @ t_gt[i] for i, t in enumerate(ts)}
    ate = ate_rmse(est, np.array([gt[round(p[0], 6)] for p in poses]), with_scale=True)
    assert ate < ATE_BOUND, ate
    assert slam.trackers[0].map.n_keyframes >= 3
    slam.shutdown()
    assert not backend.alive
    assert "backend_error" not in [e["event"] for e in slam.events]


@pytest.mark.parametrize("sensor", list(Sensor))
def test_every_sensor_runs_its_worker(sensor):
    cfg = SystemConfig(sensor=sensor, async_mapping=True, tracker=TrackerConfig(bf=40.0))
    if sensor.name.startswith("IMU"):
        cfg.imu_calib = ImuCalib.create()
    slam = Slam(TCAM, cfg, device="cpu")
    backend = slam._backend.backend
    assert backend.alive
    slam.reset_active_map()  # stops the old worker; the rebind starts a new one
    assert not backend.alive and slam._backend.backend.alive
    slam.shutdown()
    assert not slam._backend.backend.alive


class _HeldMapper:
    """The local mapper behind a gate that opens when the worker is asked
    to stop: keyframes queue up behind it until then. `held` lists the
    keyframes that waited."""

    def __init__(self, mapper, backend):
        self._mapper, self._backend = mapper, backend
        self.held = []

    def process_keyframe(self, k, abort=None):
        self.held.append(int(k))
        deadline = time.monotonic() + 60.0
        while not self._backend._stop and time.monotonic() < deadline:
            time.sleep(0.005)
        return self._mapper.process_keyframe(k, abort=abort)

    def __getattr__(self, name):
        return getattr(self._mapper, name)


def test_a_lost_spawn_drains_the_worker_onto_the_stored_map():
    voc = build_vocabulary(random_words(np.random.default_rng(12), 1500), k=4, depth=3,
                           seed=5)
    slam = Slam(TCAM, SystemConfig(map=MapConfig(64, 8192, 600),
                                   tracker=TrackerConfig(n_features=600, recently_lost_frames=0),
                                   async_mapping=True, min_kfs_to_store_map=2),
                vocab=voc, device="cpu")
    slam.loop_closer.gba_background = False
    world = synth.make_world(n_points=3000, seed=4)
    R_gt, t_gt = synth.orbit_trajectory(n_frames=60, radius=3.0, arc=1.0)

    def track(i):
        feats, _ = synth.render_features(world, R_gt[i], t_gt[i], TCAM, capacity=600,
                                         seed=100 + i, device="cpu")
        slam.track_features(feats, 0.05 * i)

    i = 0
    while slam.atlas.active.n_keyframes <= 2 and i < 30:
        track(i)
        slam.flush()
        i += 1
    hooked = slam._backend
    backend = hooked.backend
    held = hooked.mapper = _HeldMapper(hooked.mapper, backend)
    stored = slam.atlas.active_id
    rows_before = {k for (mid, k) in slam.db._row if mid == stored}
    while backend.queue_len() < 2 and i < 45:
        track(i)
        i += 1
    assert backend.queue_len() >= 2, "no keyframe queued behind the held mapper"
    empty = features_from_arrays(np.zeros((0, 2), np.float32), np.zeros((0, 32), np.uint8),
                                 600, device="cpu")
    slam.track_features(empty, 0.05 * i)  # fails: LOST at once, the mature map is stored
    events = [e["event"] for e in slam.events]
    assert "map_stored" in events and "backend_error" not in events
    assert not backend.alive and backend.queue_len() == 0
    assert slam.atlas.active_id != stored
    live = {int(k) for k in slam.atlas.maps[stored].keyframe_ids()}
    assert len(held.held) >= 3 and rows_before
    # the two-view pair never passes the back end, so it has no row (as
    # in synchronous mapping); every keyframe that did has one
    for k in sorted(rows_before | set(held.held)):
        assert (k not in live) or slam.db.row_for(k, map_id=stored) is not None, k
    assert not [key for key in slam.db._row if key[0] == slam.atlas.active_id]
    slam.shutdown()
