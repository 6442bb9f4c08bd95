"""Port parity, CPU: atlas checkpoints (slice F) against the JAX package.

A feature-level session of the JAX package's `Slam` (the synthetic world
and orbit of `tests/test_slam_e2e.py`, a vocabulary built from seeded
words) makes an atlas of two maps at different capacity tiers. Checked,
all exact unless stated:

- an atlas saved by the JAX package loads in the port, and one saved by
  the port loads in the JAX package, with every array of every map equal
  (`np.array_equal`, dtype and shape too), the map scalars, tiers, ids and
  the fresh active map the same;
- the config and vocabulary fingerprints equal the JAX package's, for the
  shipped vocabulary and a built one; another vocabulary raises
  "vocabulary fingerprint";
- `Slam(load_atlas_from=...)` rebuilds a keyframe database with the JAX
  package's rows (words exact, weights rtol 1e-5) and scores (rtol 1e-5);
- `save_atlas` and `shutdown(save_atlas_to=)` write the same arrays;
- a loaded map's point-uid counter is the session's, from a file of
  either package (the port saves it, and takes the largest stored uid
  plus one from a JAX file), so points added after loading get fresh uids.
"""

import numpy as np
import pytest
import torch

from orbslam3_tpu.core.camera import Camera as JCamera
from orbslam3_tpu.engine.system import Slam as JSlam
from orbslam3_tpu.engine.system import SystemConfig as JSystemConfig
from orbslam3_tpu.engine.tracking import TrackerConfig as JTrackerConfig
from orbslam3_tpu.place import vocab as jvoc
from orbslam3_tpu.slam_map import serialize as jser
from orbslam3_tpu.slam_map.map_state import MapConfig as JMapConfig
from orbslam3_tpu.utils import synth as jsynth
from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.core.camera import Camera as TCamera
from orbslam3_tpu_torch.engine.system import Sensor, Slam, SystemConfig
from orbslam3_tpu_torch.engine.tracking import TrackerConfig
from orbslam3_tpu_torch.imu.preintegration import ImuCalib
from orbslam3_tpu_torch.place import vocab as tvoc
from orbslam3_tpu_torch.slam_map import serialize as tser
from orbslam3_tpu_torch.slam_map.map_state import MapConfig
from test_torch_slam_e2e import reference_samples
from torch_parity import one_torch_thread, random_words  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FRAMES = 14
ROW_RTOL = 1e-5
JCAM = JCamera.pinhole(458.0, 458.0, 320.0, 240.0, width=640, height=480)
TCAM = TCamera.pinhole(458.0, 458.0, 320.0, 240.0, width=640, height=480, device="cpu")
MAP = dict(max_keyframes=32, max_points=4096, features_per_frame=400)


def _arrays(m) -> dict:
    return {k: v for k, v in vars(m).items() if isinstance(v, np.ndarray)}


def _same_atlas(a, b):
    assert sorted(a.maps) == sorted(b.maps)
    assert (a.active_id, a._next_map_id) == (b.active_id, b._next_map_id)
    for mid in a.maps:
        ma, mb = a.maps[mid], b.maps[mid]
        assert vars(ma.cfg) == vars(mb.cfg)
        xa, xb = _arrays(ma), _arrays(mb)
        assert sorted(xa) == sorted(xb)
        for name in xa:
            assert xa[name].dtype == xb[name].dtype and np.array_equal(xa[name], xb[name]), \
                (mid, name)
        for s in jser._MAP_SCALARS:  # the port adds `_next_mp_uid`, checked below
            assert getattr(ma, s) == getattr(mb, s), (mid, s)


@pytest.fixture(scope="module")
def vocabs():
    train = random_words(np.random.default_rng(12), 1500)
    jv = jvoc.build_vocabulary(train, k=4, depth=3, seed=5)
    return jv, convert.vocabulary(jv)


@pytest.fixture(scope="module")
def jax_atlas(vocabs, tmp_path_factory):
    """The JAX package's atlas after a feature-level session, with a second
    map at a larger tier, saved by the JAX package."""
    jv, _ = vocabs
    slam = JSlam(JCAM, JSystemConfig(map=JMapConfig(**MAP),
                                     tracker=JTrackerConfig(n_features=400)), vocab=jv)
    slam.loop_closer.gba_background = False
    world = jsynth.make_world(n_points=3000, seed=4)
    R, t = jsynth.orbit_trajectory(n_frames=80, radius=3.0, arc=1.0)
    for i in range(FRAMES):
        f, _ = jsynth.render_features(world, R[i], t[i], JCAM, capacity=400, seed=100 + i)
        slam.track_features(f, 0.05 * i)
    m0 = slam.atlas.active
    assert m0.n_keyframes >= 3 and m0.n_points > 100
    with m0.lock:
        m0.grow(max_keyframes=64, max_points=8192)  # a tier of its own
    slam.atlas.create_new_map()
    path = tmp_path_factory.mktemp("atlas") / "jax.npz"
    slam.save_atlas(str(path))
    return slam, str(path)


def test_a_jax_atlas_loads_in_the_port(vocabs, jax_atlas):
    jv, tv = vocabs
    slam, path = jax_atlas
    ref = jser.load_atlas(path, vocab=jv)
    got = tser.load_atlas(path, vocab=tv, device="cpu")
    _same_atlas(got, ref)
    # and against the session's own maps (the new active map is fresh)
    for mid, m in slam.atlas.maps.items():
        for name, arr in _arrays(m).items():
            assert np.array_equal(getattr(got.maps[mid], name), arr), (mid, name)
    assert got.active_id == 2 and got.active.n_keyframes == 0
    assert got.maps[0].cfg.max_keyframes == 64 and got.maps[1].cfg.max_keyframes == 32


def test_a_port_atlas_loads_in_jax(vocabs, jax_atlas, tmp_path):
    jv, tv = vocabs
    _, path = jax_atlas
    atlas = tser.load_atlas(path, vocab=tv, device="cpu")
    out = tmp_path / "port.npz"
    tser.save_atlas(atlas, str(out), vocab=tv)
    back_j = jser.load_atlas(str(out), vocab=jv)
    back_t = tser.load_atlas(str(out), vocab=tv, device="cpu")
    _same_atlas(back_j, back_t)
    for mid, m in atlas.maps.items():
        for name, arr in _arrays(m).items():
            assert np.array_equal(getattr(back_j.maps[mid], name), arr), (mid, name)
    with np.load(out) as z, np.load(path) as zj:
        # the same array names per map (the port's file also holds map 2,
        # the fresh active map that loading made)
        assert {f.split("/")[1] for f in z.files if "/" in f} == \
            {f.split("/")[1] for f in zj.files if "/" in f}
        assert set(zj.files) <= set(z.files)
        meta = __import__("json").loads(bytes(z["__meta__"]).decode())
        assert meta["format"] == jser.FORMAT_VERSION == tser.FORMAT_VERSION
        assert meta["vocab_md5"] == jser.vocab_fingerprint(jv)


def test_fingerprints_match_jax(vocabs):
    jv, tv = vocabs
    assert tser.vocab_fingerprint(tv) == jser.vocab_fingerprint(jv)
    shipped_t = tvoc.load_default_vocabulary()
    shipped_j = jvoc.Vocabulary.load(tvoc.default_vocabulary_path())
    assert tser.vocab_fingerprint(shipped_t) == jser.vocab_fingerprint(shipped_j)
    assert tser.vocab_fingerprint(None) == jser.vocab_fingerprint(None) == "none"
    for cfg in (MAP, dict(max_keyframes=7, max_points=9, features_per_frame=11,
                          keyframes_ceil=13, points_ceil=17)):
        assert tser.config_fingerprint(MapConfig(**cfg)) == \
            jser.config_fingerprint(JMapConfig(**cfg))


def test_another_vocabulary_is_refused(vocabs, jax_atlas):
    _, path = jax_atlas
    other = tvoc.build_vocabulary(random_words(np.random.default_rng(99), 600), k=4, depth=2)
    with pytest.raises(ValueError, match="vocabulary fingerprint"):
        tser.load_atlas(path, vocab=other, device="cpu")
    with pytest.raises(ValueError, match="vocabulary fingerprint"):
        Slam(TCAM, SystemConfig(map=MapConfig(**MAP)), vocab=other, load_atlas_from=path,
             device="cpu")
    # without a vocabulary the check is skipped, as in the JAX package
    assert len(Slam(TCAM, SystemConfig(map=MapConfig(**MAP)), load_atlas_from=path,
                    device="cpu").atlas.maps) == 3


def test_loading_rebuilds_the_database_as_jax(vocabs, jax_atlas):
    jv, tv = vocabs
    _, path = jax_atlas
    js = JSlam(JCAM, JSystemConfig(map=JMapConfig(**MAP)), vocab=jv, load_atlas_from=path)
    ts = Slam(TCAM, SystemConfig(map=MapConfig(**MAP)), vocab=tv, load_atlas_from=path,
              device="cpu")
    jd, td = js.db, ts.db
    assert td._row == jd._row and len(td._row) == js.atlas.maps[0].n_keyframes
    rows = sorted(td._row.values())
    np.testing.assert_array_equal(td.kf_words.numpy()[rows], np.asarray(jd.kf_words)[rows])
    np.testing.assert_allclose(td.kf_weights.numpy()[rows], np.asarray(jd.kf_weights)[rows],
                               rtol=ROW_RTOL, atol=1e-8)
    np.testing.assert_array_equal(td.map_of[rows], np.asarray(jd.map_of)[rows])
    np.testing.assert_array_equal(td.slot_of[rows], np.asarray(jd.slot_of)[rows])
    m = js.atlas.maps[0]
    for k in m.keyframe_ids()[:3]:
        _, q = jd.compute_bow(m.kf_desc[k], m.kf_feat_valid[k])
        mask = np.ones(len(jd.active), bool)
        jshared, jscore = jd._scores(q, mask)
        tshared, tscore = td._scores(q, mask[:len(td.active)])
        n = min(len(jscore), len(tscore))
        np.testing.assert_array_equal(tshared[:n], np.asarray(jshared)[:n])
        np.testing.assert_allclose(tscore[:n], np.asarray(jscore)[:n], rtol=ROW_RTOL,
                                   atol=1e-7)


def test_port_session_save_and_shutdown_save(vocabs, tmp_path):
    """The port's own session (two-view samples injected), saved by
    `save_atlas` and by `shutdown(save_atlas_to=)`: the same arrays, and the
    JAX package loads it."""
    jv, tv = vocabs
    slam = Slam(TCAM, SystemConfig(map=MapConfig(**MAP), tracker=TrackerConfig(n_features=400)),
                vocab=tv, device="cpu")
    slam.loop_closer.gba_background = False
    slam.trackers[0].sample_fn = reference_samples
    world = jsynth.make_world(n_points=3000, seed=4)
    R, t = jsynth.orbit_trajectory(n_frames=80, radius=3.0, arc=1.0)
    for i in range(8):
        f, _ = jsynth.render_features(world, R[i], t[i], JCAM, capacity=400, seed=100 + i)
        feats = convert.frame_features(*(np.asarray(getattr(f, k)) for k in
                                         ("uv", "uv_raw", "response", "angle", "octave",
                                          "desc", "valid")), device="cpu")
        slam.track_features(feats, 0.05 * i)
    assert slam.atlas.active.n_keyframes >= 2
    a, b = tmp_path / "a.npz", tmp_path / "b.npz"
    slam.save_atlas(str(a))
    slam.shutdown(save_atlas_to=str(b))
    assert [e["event"] for e in slam.events][-2:] == ["atlas_saved", "shutdown"]
    _same_atlas(tser.load_atlas(str(a), vocab=tv, device="cpu"),
                jser.load_atlas(str(b), vocab=jv))


@pytest.mark.parametrize("sensor", [Sensor.STEREO, Sensor.IMU_RGBD])
def test_load_and_save_on_other_sensors(vocabs, jax_atlas, sensor, tmp_path):
    """Loading and saving do not depend on the sensor: a stereo and an
    RGB-D-inertial `Slam` load the atlas, rebuild the database and save
    the same arrays."""
    _, tv = vocabs
    _, path = jax_atlas
    cfg = SystemConfig(sensor=sensor, map=MapConfig(**MAP), tracker=TrackerConfig(bf=40.0))
    if sensor == Sensor.IMU_RGBD:
        cfg.imu_calib = ImuCalib.create()
    slam = Slam(TCAM, cfg, vocab=tv, load_atlas_from=path, device="cpu")
    assert len(slam.db._row) == slam.atlas.maps[0].n_keyframes > 0
    slam.save_atlas(str(tmp_path / "s.npz"))
    back = tser.load_atlas(str(tmp_path / "s.npz"), vocab=tv, device="cpu")
    assert sorted(back.maps) == sorted(slam.atlas.maps) + [back.active_id]
    for mid, m in slam.atlas.maps.items():
        for name, arr in _arrays(m).items():
            assert np.array_equal(getattr(back.maps[mid], name), arr), (mid, name)
    assert bool(torch.all(slam.db.kf_words[sorted(slam.db._row.values())] >= -1))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_loaded_map_issues_fresh_point_uids(vocabs, jax_atlas, writer, tmp_path):
    jv, tv = vocabs
    slam, path = jax_atlas
    session = slam.atlas.maps[0]
    if writer == "port":
        path = str(tmp_path / "port.npz")
        tser.save_atlas(tser.load_atlas(jax_atlas[1], vocab=tv, device="cpu"), path, vocab=tv)
        # the JAX package's loader sets the port's counter too
        assert jser.load_atlas(path, vocab=jv).maps[0]._next_mp_uid == session._next_mp_uid
    with np.load(path) as z:
        meta = __import__("json").loads(bytes(z["__meta__"]).decode())
    assert ("_next_mp_uid" in meta["map_scalars"]["0"]) == (writer == "port")
    m = tser.load_atlas(path, vocab=tv, device="cpu").maps[0]
    assert m._next_mp_uid == session._next_mp_uid > 0
    n = m.n_points
    rng = np.random.default_rng(3)
    ids = m.add_points(pos=rng.uniform(-1, 1, (10, 3)).astype(np.float32),
                       desc=random_words(rng, 10), first_kf=-1)
    assert (ids >= 0).all() and m.n_points == n + 10
    uids = m.mp_uid[m.mp_valid]
    assert len(np.unique(uids)) == len(uids)
    assert set(m.mp_uid[ids]) == set(range(session._next_mp_uid, session._next_mp_uid + 10))
