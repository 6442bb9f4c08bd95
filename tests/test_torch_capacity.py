"""Parity of the port's capacity tiers against the JAX package, CPU: the
six cases of `tests/test_capacity.py`, each driven through both packages
on the same seeded inputs.

The map is host numpy in both packages, so every case must give the same
arrays exactly (`convert.MAP_ARRAYS`, float arrays too), the same
`grow_*` / `drop_*` events in the same order with the same fields, and the
same tiers:

- keyframe growth under insert pressure (4 -> 8 -> 16 -> 32, earlier rows
  kept);
- the keyframe ceiling's loud drops;
- point growth, then slot reuse before growing again;
- the keyframe database's rows doubling with the map;
- `Atlas.weld` into a map that must grow, carrying the preintegration
  chain and the temporal chain;
- a grown map's checkpoint: saved by either package, loaded by both.
"""

import numpy as np
import pytest

from orbslam3_tpu.place.database import KeyFrameDatabase as JDB
from orbslam3_tpu.place.vocab import build_vocabulary
from orbslam3_tpu.slam_map import atlas as jatlas
from orbslam3_tpu.slam_map import serialize as jser
from orbslam3_tpu.slam_map.map_state import MapConfig as JMC, MapState as JMS
from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.place.database import KeyFrameDatabase as TDB
from orbslam3_tpu_torch.slam_map import atlas as tatlas
from orbslam3_tpu_torch.slam_map import serialize as tser
from orbslam3_tpu_torch.slam_map.map_state import MapConfig as TMC, MapState as TMS

JAX = dict(MC=JMC, MS=lambda cfg: JMS(cfg), Atlas=lambda cfg: jatlas.Atlas(cfg))
PORT = dict(MC=TMC, MS=lambda cfg: TMS(cfg, device="cpu"),
            Atlas=lambda cfg: tatlas.Atlas(cfg, device="cpu"))
PACKAGES = (JAX, PORT)


def assert_maps_equal(a, b):
    """Every SoA array of two maps, bit for bit, and the same tiers."""
    assert a.cfg.max_keyframes == b.cfg.max_keyframes
    assert a.cfg.max_points == b.cfg.max_points
    for name in convert.MAP_ARRAYS:
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name), err_msg=name)


def assert_events_equal(a, b):
    """The same capacity events, kinds and fields, in the same order."""
    assert [e["kind"] for e in b.events] == [e["kind"] for e in a.events]
    assert b.events == a.events


def kf_args(rng, n=64):
    return dict(uv=rng.uniform(0, 300, (n, 2)).astype(np.float32),
                octave=np.zeros(n, np.int32), angle=np.zeros(n, np.float32),
                desc=rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32),
                feat_valid=np.ones(n, bool), obs_mp=np.full(n, -1, np.int32))


def add_kfs(m, rng, count, ts0=0.0, fid0=0, chain=False, preint=None):
    """`count` keyframes at identity poses; their slots."""
    out, prev = [], -1
    for i in range(count):
        extra = {}
        if chain:
            extra["prev_kf"] = prev
        if preint is not None:
            extra["preint"] = preint(i)
        prev = m.add_keyframe(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                              ts0 + float(i), fid0 + i, **extra, **kf_args(rng))
        out.append(prev)
    return out


def test_keyframe_growth_under_pressure_matches_jax():
    runs = []
    for pkg in PACKAGES:
        m = pkg["MS"](pkg["MC"](max_keyframes=4, max_points=64, features_per_frame=64,
                                keyframes_ceil=32))
        ids = add_kfs(m, np.random.default_rng(5), 20)
        runs.append((m, ids))
    (jm, jids), (tm, tids) = runs
    assert tids == jids and min(tids) >= 0
    assert [e["kind"] for e in tm.events] == ["grow_keyframes"] * 3  # 4 -> 8 -> 16 -> 32
    assert_events_equal(jm, tm)
    assert_maps_equal(jm, tm)
    assert tm.cfg.max_keyframes == len(tm.kf_R) == 32
    assert tm.kf_ts[tids[3]] == 3.0 and tm.kf_uid[tids[19]] == 19  # earlier rows kept


def test_keyframe_ceiling_drops_loudly_matches_jax():
    runs = []
    for pkg in PACKAGES:
        m = pkg["MS"](pkg["MC"](max_keyframes=4, max_points=64, features_per_frame=64,
                                keyframes_ceil=8))
        runs.append((m, add_kfs(m, np.random.default_rng(5), 10)))
    (jm, jids), (tm, tids) = runs
    assert tids == jids
    assert sum(k >= 0 for k in tids) == 8 and tids[8:] == [-1, -1]
    assert [e["kind"] for e in tm.events] == ["grow_keyframes", "drop_keyframe",
                                              "drop_keyframe"]
    assert tm.events[1]["at_ceiling"] == 8
    assert_events_equal(jm, tm)
    assert_maps_equal(jm, tm)


def test_point_growth_and_slot_reuse_matches_jax():
    runs = []
    for pkg in PACKAGES:
        rng = np.random.default_rng(5)
        m = pkg["MS"](pkg["MC"](max_keyframes=4, max_points=16, features_per_frame=64,
                                points_ceil=256))
        ids1 = m.add_points(rng.normal(0, 1, (40, 3)).astype(np.float32),
                            rng.integers(0, 2 ** 32, (40, 8), dtype=np.uint32), first_kf=0)
        tier = m.cfg.max_points
        m.remove_points(ids1[:30])
        ids2 = m.add_points(rng.normal(0, 1, (25, 3)).astype(np.float32),
                            rng.integers(0, 2 ** 32, (25, 8), dtype=np.uint32), first_kf=0)
        runs.append((m, ids1, ids2, tier))
    (jm, j1, j2, jtier), (tm, t1, t2, ttier) = runs
    np.testing.assert_array_equal(t1, j1)
    np.testing.assert_array_equal(t2, j2)
    assert (t1 >= 0).all() and (t2 >= 0).all()
    assert ttier == jtier == tm.cfg.max_points == 56  # reused the tombstones, no grow
    assert set(t2.tolist()) <= set(t1[:30].tolist())
    assert [e["kind"] for e in tm.events] == ["grow_points"]
    assert_events_equal(jm, tm)
    assert_maps_equal(jm, tm)


def test_database_grows_with_map_matches_jax():
    rng = np.random.default_rng(5)
    desc = rng.integers(0, 2 ** 32, (512, 8), dtype=np.uint32)
    jvoc = build_vocabulary(desc, k=4, depth=3)
    jdb = JDB(jvoc, max_keyframes=4)
    tdb = TDB(convert.vocabulary(jvoc), max_keyframes=4, device="cpu")
    sizes = []
    for kf in range(40):
        for db in (jdb, tdb):
            _, bow = db.compute_bow(desc[kf * 8:(kf + 1) * 8], np.ones(8, bool))
            db.add(kf, bow, map_id=kf % 3)
        sizes.append((len(jdb.active), len(tdb.active)))
    assert [t for _, t in sizes] == [j for j, _ in sizes]
    assert len(tdb.active) == 64 and tdb.active[:40].all() and not tdb.active[40:].any()
    for name in ("active", "map_of", "slot_of"):
        np.testing.assert_array_equal(getattr(tdb, name), getattr(jdb, name), err_msg=name)
    np.testing.assert_array_equal(tdb.kf_words.numpy(), jdb.kf_words.astype(np.int32))
    np.testing.assert_array_equal(tdb.kf_weights.numpy(), jdb.kf_weights)
    assert tdb.kf_words.shape == (64, tdb.F)


def test_weld_grows_and_carries_preint_matches_jax():
    runs = []
    for pkg in PACKAGES:
        rng = np.random.default_rng(5)
        atlas = pkg["Atlas"](pkg["MC"](max_keyframes=8, max_points=128,
                                       features_per_frame=64))
        dst = atlas.active
        add_kfs(dst, rng, 6, chain=True)
        src_id = atlas.create_new_map()
        src = atlas.maps[src_id]
        add_kfs(src, rng, 7, ts0=10.0, fid0=100, chain=True,
                preint=lambda i: ("PRE", i) if i > 0 else None)
        src.add_points(rng.normal(0, 1, (200, 3)).astype(np.float32),
                       rng.integers(0, 2 ** 32, (200, 8), dtype=np.uint32), first_kf=0)
        R = np.asarray([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
        kf_map = atlas.weld(dst.map_id, src_id, 1.5, R, np.array([1.0, 2, 3], np.float32))
        runs.append((atlas.maps[dst.map_id], src, kf_map))
    (jm, jsrc, jmap), (tm, tsrc, tmap) = runs
    assert tmap == jmap and len(tmap) == 7
    assert tm.n_keyframes == 13 and tm.n_points == 200
    assert (tm.cfg.max_keyframes, tm.cfg.max_points) == (16, 256)
    assert [e["kind"] for e in tm.events] == ["grow_keyframes", "grow_points"]
    assert_events_equal(jm, tm)
    assert_maps_equal(jm, tm)
    assert tm.kf_pre == jm.kf_pre
    for s, d in tmap.items():
        if tsrc.kf_frame_id[s] >= 101:  # preintegration re-keyed to the new slot
            assert tm.kf_pre[d] == ("PRE", int(tsrc.kf_frame_id[s]) - 100)
        ps = int(tsrc.kf_prev[s])
        if ps in tmap:  # the temporal chain re-keyed
            assert int(tm.kf_prev[d]) == tmap[ps]


@pytest.fixture
def grown_atlases():
    """Both packages' atlases after a grow past the atlas tier: 10
    keyframes and 70 points in a map made at 4 / 32."""
    out = []
    for pkg in PACKAGES:
        rng = np.random.default_rng(5)
        atlas = pkg["Atlas"](pkg["MC"](max_keyframes=4, max_points=32, features_per_frame=64))
        m = atlas.active
        add_kfs(m, rng, 10, chain=True)
        m.add_points(rng.normal(0, 1, (70, 3)).astype(np.float32),
                     rng.integers(0, 2 ** 32, (70, 8), dtype=np.uint32), first_kf=0)
        out.append(atlas)
    return out


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_checkpoint_roundtrip_grown_map_across_packages(grown_atlases, saver, tmp_path):
    ja, ta = grown_atlases
    assert ta.active.cfg.max_keyframes == 16 and ta.active.cfg.max_points == 102
    assert_events_equal(ja.active, ta.active)
    path = str(tmp_path / "atlas.npz")
    if saver == "jax":
        jser.save_atlas(ja, path)
    else:
        tser.save_atlas(ta, path)
    jout = jser.load_atlas(path, check_vocab=False)
    tout = tser.load_atlas(path, check_vocab=False, device="cpu")
    mid = ta.active.map_id
    for m in (jout.maps[mid], tout.maps[mid]):
        assert m.cfg.max_keyframes == 16 and m.cfg.max_points == 102
        assert m.n_keyframes == 10 and m.n_points == 70
        assert_maps_equal(ta.active, m)
    assert tout.maps[mid]._next_mp_uid == ta.active._next_mp_uid
    assert sorted(tout.maps) == sorted(jout.maps)
    assert tout.active_id == jout.active_id
    # the fresh active map of either loader starts at the atlas's tier
    assert tout.active.cfg.max_keyframes == jout.active.cfg.max_keyframes == 4
