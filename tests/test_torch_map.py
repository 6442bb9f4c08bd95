"""Parity of the port's map state and local mapper against the JAX package,
CPU: `MapState` (add/remove/merge, point statistics, covisibility),
`convert.map_state`, `Atlas` welding, and one `LocalMapper.process_keyframe`
started from a JAX map carried across by `convert.map_state`.

The map is host numpy in both packages, so its bookkeeping must give the
same arrays exactly. Local mapping adds device numerics (triangulation,
matching, BA): its decisions (new points, fused and merged observations,
culled keyframes) must be identical, positions and poses within stated
tolerances."""

import numpy as np
import pytest

from orbslam3_tpu.core.camera import Camera as JCamera
from orbslam3_tpu.engine import local_mapping as jlm
from orbslam3_tpu.engine.tracking import Tracker as JTracker, TrackerConfig as JTC
from orbslam3_tpu.slam_map import atlas as jatlas
from orbslam3_tpu.slam_map.map_state import MapConfig as JMC, MapState as JMS
from orbslam3_tpu.utils import synth
from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.core.camera import Camera as TCamera
from orbslam3_tpu_torch.engine import local_mapping as tlm
from orbslam3_tpu_torch.slam_map import atlas as tatlas
from orbslam3_tpu_torch.slam_map.map_state import MapConfig as TMC, MapState as TMS

CJ = JCamera.pinhole(458.0, 458.0, 320.0, 240.0, width=640, height=480)
CT = TCamera.pinhole(458.0, 458.0, 320.0, 240.0, width=640, height=480, device="cpu")


def assert_maps_equal(a, b, atol=0.0):
    """Every SoA array of two maps; float arrays within `atol`."""
    for name in convert.MAP_ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        if atol and np.issubdtype(x.dtype, np.floating):
            np.testing.assert_allclose(y, x, atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(y, x, err_msg=name)


def _drive_map_ops(m, seed=0):
    """One seeded sequence of map operations: keyframes that observe
    overlapping point sets, point statistics, covisibility queries,
    removals and merges, a grow past capacity. Returns the queries'
    answers."""
    rng = np.random.default_rng(seed)
    N = m.cfg.features_per_frame
    out = []
    ids = m.add_points(pos=rng.uniform(-3, 3, (150, 3)).astype(np.float32) + [0, 0, 6],
                       desc=rng.integers(0, 2 ** 32, (150, 8), dtype=np.uint32),
                       first_kf=0)
    kfs = []
    for k in range(6):
        R = np.eye(3, dtype=np.float32)
        t = np.array([-0.3 * k, 0.0, 0.0], np.float32)
        obs = np.full(N, -1, np.int32)
        seen = ids[rng.random(150) < 0.7]
        slots = rng.choice(N, len(seen), replace=False)
        obs[slots] = seen
        kfs.append(m.add_keyframe(
            R, t, 0.05 * k, k, rng.uniform(0, 600, (N, 2)).astype(np.float32),
            rng.integers(0, 8, N).astype(np.int32),
            rng.uniform(0, 6, N).astype(np.float32),
            rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint32), np.ones(N, bool), obs,
            prev_kf=kfs[-1] if kfs else -1))
    m.update_point_stats(ids)
    out += [m.covisibility(k, min_shared=15) for k in kfs]
    out.append(m.covis_weights(np.asarray(kfs)))
    m.remove_points(ids[:10])
    m.merge_points(int(ids[20]), int(ids[21]))
    m.merge_points(int(ids[22]), int(ids[23]))
    m.remove_keyframe(kfs[2])
    out += [m.covisibility(k, min_shared=10) for k in kfs]
    out += [m.observation_count(), m.obs_counts(), m.incidence()]
    more = m.add_points(pos=np.ones((200, 3), np.float32),
                        desc=np.zeros((200, 8), np.uint32), first_kf=1)  # grows
    out += [more, m.n_points, m.n_keyframes, m.cfg.max_points]
    return out


def test_map_state_ops_match_jax():
    jm = JMS(JMC(max_keyframes=8, max_points=256, features_per_frame=160))
    tm = TMS(TMC(max_keyframes=8, max_points=256, features_per_frame=160), device="cpu")
    for a, b in zip(_drive_map_ops(jm), _drive_map_ops(tm)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    assert_maps_equal(jm, tm)
    assert tm.culled_anchor.keys() == jm.culled_anchor.keys()
    assert [e["kind"] for e in tm.events] == [e["kind"] for e in jm.events] == ["grow_points"]


def test_convert_map_state_and_weld_match_jax():
    """A JAX map carried across is array-for-array the same map, answers
    covisibility alike, and welds into another map alike."""
    maps_j, maps_t = [], []
    for seed in (1, 2):
        jm = JMS(JMC(max_keyframes=8, max_points=256, features_per_frame=160))
        _drive_map_ops(jm, seed)
        tm = convert.map_state(jm, device="cpu")
        assert_maps_equal(jm, tm)
        for k in jm.keyframe_ids():
            np.testing.assert_array_equal(tm.covisibility(k), jm.covisibility(k))
        maps_j.append(jm)
        maps_t.append(tm)
    ja, ta = jatlas.Atlas(maps_j[0].cfg), tatlas.Atlas(maps_t[0].cfg, device="cpu")
    for atlas, (m0, m1) in ((ja, maps_j), (ta, maps_t)):
        atlas.maps = {0: m0}
        atlas.active_id = 0
        atlas._next_map_id = 1
        atlas.adopt(m1)
    R = np.asarray([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
    kmap_j = ja.weld(0, 1, 1.5, R, np.array([1.0, 2, 3], np.float32))
    kmap_t = ta.weld(0, 1, 1.5, R, np.array([1.0, 2, 3], np.float32))
    assert kmap_t == kmap_j
    assert_maps_equal(ja.maps[0], ta.maps[0])


# --------------------------------------------------------------------------
# one LocalMapper.process_keyframe from a JAX map
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def keyframe_cases():
    """The JAX tracker and mapper on 16 frames of the feature-level
    sequence of tests/test_slam_e2e.py; for each keyframe the mapper
    processes, the map and mapper state just before (carried across) and
    the JAX map just after."""
    world = synth.make_world(n_points=3000, seed=4)
    R_gt, t_gt = synth.orbit_trajectory(n_frames=80, radius=3.0, arc=1.0)
    m = JMS(JMC(max_keyframes=64, max_points=8192, features_per_frame=600))
    cases = []

    class Recording(jlm.LocalMapper):
        def process_keyframe(self, k, abort=None):
            before = (convert.map_state(self.map, device="cpu"), list(self._recent_mps),
                      self._kf_counter)
            super().process_keyframe(k, abort)
            cases.append((k, before, convert.map_state(self.map, device="cpu")))

    tracker = JTracker(CJ, m, JTC(n_features=600), local_mapper=Recording(CJ, m))
    for i in range(16):
        f, _ = synth.render_features(world, R_gt[i], t_gt[i], CJ, capacity=600,
                                     seed=100 + i)
        tracker.process_features(f, 0.05 * i)
    assert len(cases) >= 2
    return cases


@pytest.mark.parametrize("case", [0, 1])
def test_process_keyframe_matches_jax(keyframe_cases, case):
    """Same new points (slots, observations, descriptors), same fused and
    merged observations, same live keyframes; BA poses within 1e-4 and
    point positions within 1e-3 (f32 BA, another summation order; the map
    is at median depth ~1)."""
    k, (tm, recent, counter), ref = keyframe_cases[case]
    mapper = tlm.LocalMapper(CT, tm, device="cpu")
    mapper._recent_mps, mapper._kf_counter = recent, counter
    mapper.process_keyframe(k)
    assert tm.n_points == ref.n_points
    np.testing.assert_array_equal(tm.kf_valid, ref.kf_valid)
    np.testing.assert_array_equal(tm.mp_valid, ref.mp_valid)
    np.testing.assert_array_equal(tm.kf_obs_mp, ref.kf_obs_mp)
    np.testing.assert_array_equal(tm.mp_desc, ref.mp_desc)
    np.testing.assert_allclose(tm.kf_R, ref.kf_R, atol=1e-4)
    np.testing.assert_allclose(tm.kf_t, ref.kf_t, atol=1e-4)
    v = ref.mp_valid
    np.testing.assert_allclose(tm.mp_pos[v], ref.mp_pos[v], atol=1e-3)
    assert (ref.mp_first_kf[ref.mp_valid] == k).sum() > 20  # it triangulated
