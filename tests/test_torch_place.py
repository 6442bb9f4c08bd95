"""Port parity, CPU: place recognition and the geometry under loop closing.

The same seeded numpy inputs go through the JAX package and the port
(``device="cpu"``, the kernels' plain versions):

- the shipped vocabulary (`orbslam3_tpu/assets/vocab_100k.npz`, read by
  path): `descend` words exact, ties included; `bow_vector` and `l1_score`
  rtol 1e-6;
- `KeyFrameDatabase`: scores rtol 1e-5, shared-word counts, candidates in
  the same order, `erase`, `clear_map`, n-best without the covisible set;
- `search_by_bow` (K1 policy "bow") and the loop closer's and the
  relocalizer's masked matches (policies "loop" and "reloc") against
  `distance_matrix` + `match_ratio`: exact;
- `distance_matrix_popcount` / `distance_vector`: exact;
- the Sim(3) / SE(3) / quaternion functions: 1e-5;
- `horn_alignment` 1e-5; `sim3_ransac` and `pnp_ransac` with the
  reference's samples injected 1e-4; `optimize_sim3`, `optimize_pose_graph`
  (7, 6 and 4 DoF) and `correct_points` 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from orbslam3_tpu.core import lie as jlie
from orbslam3_tpu.core.camera import Camera as JCamera
from orbslam3_tpu.kernels import hamming as jham
from orbslam3_tpu.kernels import orb_descriptor as jdesc
from orbslam3_tpu.opt import pose_graph as jpg
from orbslam3_tpu.place import database as jdb
from orbslam3_tpu.place import vocab as jvoc
from orbslam3_tpu.vision import matcher as jmatch
from orbslam3_tpu.vision import pnp as jpnp
from orbslam3_tpu.vision import sim3 as jsim3
from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.core import lie as tlie
from orbslam3_tpu_torch.core.camera import Camera as TCamera
from orbslam3_tpu_torch.kernels import hamming as tham
from orbslam3_tpu_torch.opt import pose_graph as tpg
from orbslam3_tpu_torch.place import database as tdb
from orbslam3_tpu_torch.place import vocab as tvoc
from orbslam3_tpu_torch.vision import matcher as tmatch
from orbslam3_tpu_torch.vision import pnp as tpnp
from orbslam3_tpu_torch.vision import sim3 as tsim3
from torch_parity import np_, one_torch_thread, random_words, t32  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

JCAM = JCamera.pinhole(458.0, 457.0, 376.0, 240.0)
TCAM = TCamera.pinhole(458.0, 457.0, 376.0, 240.0, device="cpu")


@pytest.fixture(scope="module")
def vocabs():
    jv = jvoc.Vocabulary.load(tvoc.default_vocabulary_path())
    return jv, convert.vocabulary(jv)


def perturb(desc, n_bits, rng):
    out = desc.copy()
    for i in range(len(out)):
        for b in rng.choice(256, n_bits, replace=False):
            out[i, b // 32] ^= np.uint32(1 << (b % 32))
    return out


def words_t(desc):
    return torch.from_numpy(convert.words_to_int32(desc))


# ---------------------------------------------------------------- vocabulary
def test_shipped_vocabulary_path_and_shape(vocabs):
    jv, tv = vocabs
    assert tv.k == 10 and tv.depth == 5 and tv.n_words == 100_000
    assert jv.n_words == tv.n_words


def test_descend_matches_jax_with_ties(vocabs):
    jv, tv = vocabs
    rng = np.random.default_rng(0)
    # random descriptors and near copies of leaf centres: small integer
    # distances, so equal distances between siblings are common
    leaves = tv.levels[-1][rng.integers(0, tv.n_words, 300)]
    desc = np.concatenate([random_words(rng, 700), perturb(leaves, 3, rng)])
    ref = np.asarray(jvoc.descend(jnp.asarray(desc), *jv.device_tensors()[:2], jv.k))
    lv, vd, _ = tv.device_tensors("cpu")
    got = tvoc.descend(words_t(desc), lv, vd, tv.k)
    np.testing.assert_array_equal(np_(got), ref)
    np.testing.assert_array_equal(tv.words_np(desc), ref)
    # ties happened at the first level
    d = tvoc.hamming_np(desc, tv.levels[0][:tv.k])
    assert ((d == d.min(1, keepdims=True)).sum(1) > 1).sum() > 0


def test_bow_vector_and_l1_score(vocabs):
    jv, tv = vocabs
    rng = np.random.default_rng(1)
    desc = random_words(rng, 600)
    valid = rng.random(600) < 0.9
    words = tv.words_np(desc)
    idf = jnp.asarray(jv.idf, jnp.float32)
    va = np.asarray(jvoc.bow_vector(jnp.asarray(words), jnp.asarray(valid), idf))
    vb = np.asarray(jvoc.bow_vector(jnp.asarray(words[::-1]), jnp.asarray(valid), idf))
    tidf = torch.from_numpy(tv.idf)
    ta = tvoc.bow_vector(torch.from_numpy(words), torch.from_numpy(valid), tidf)
    tb = tvoc.bow_vector(torch.from_numpy(words[::-1].copy()), torch.from_numpy(valid), tidf)
    np.testing.assert_allclose(np_(ta), va, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(np_(tvoc.l1_score(ta, tb)),
                               np.asarray(jvoc.l1_score(va, vb)), rtol=1e-6)
    assert np_(tvoc.node_at_level(torch.from_numpy(words), 5, 10, 3)).tolist() == \
        np.asarray(jvoc.node_at_level(jnp.asarray(words), 5, 10, 3)).tolist()


def test_build_save_load_roundtrip(tmp_path):
    rng = np.random.default_rng(2)
    train = random_words(rng, 400)
    jv = jvoc.build_vocabulary(train, k=4, depth=3, seed=3)
    tv = tvoc.build_vocabulary(train, k=4, depth=3, seed=3)
    for a, b in zip(jv.levels, tv.levels):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jv.idf, tv.idf)
    tv.save(str(tmp_path / "v.npz"))
    back = tvoc.Vocabulary.load(str(tmp_path / "v.npz"))
    np.testing.assert_array_equal(back.words_np(train), jv.words_np(train))


# ------------------------------------------------------------------ database
def _databases(vocabs, n_kf=10, n_feat=120, seed=4):
    jv, tv = vocabs
    rng = np.random.default_rng(seed)
    jd = jdb.KeyFrameDatabase(jv, max_keyframes=16)
    td = tdb.KeyFrameDatabase(tv, max_keyframes=16, device="cpu")
    places = [random_words(rng, n_feat) for _ in range(4)]
    descs = [perturb(places[k % 4], 6, rng) for k in range(n_kf)]
    for k, d in enumerate(descs):
        valid = np.ones(n_feat, bool)
        jw, jbow = jd.compute_bow(d, valid)
        tw, tbow = td.compute_bow(d, valid)
        np.testing.assert_array_equal(tw, jw)
        np.testing.assert_array_equal(tbow.words, jbow.words)
        np.testing.assert_allclose(tbow.weights, jbow.weights, rtol=1e-6)
        jd.add(k, jbow, map_id=k % 2)
        td.add(k, tbow, map_id=k % 2)
    return jd, td, places, rng


def test_database_scores_and_candidates(vocabs):
    jd, td, places, rng = _databases(vocabs)
    covis = lambda k: [k - 2, k + 2]           # same-place neighbours, same map
    for q in range(4):
        d = perturb(places[q], 6, rng)
        _, qv = jd.compute_bow(d, np.ones(len(d), bool))
        mask = np.ones(16, bool)
        js, jsc = jd._scores(qv, mask)
        ts, tsc = td._scores(qv, mask)
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_allclose(tsc, jsc, rtol=1e-5, atol=1e-7)
        for mid in (None, 0, 1):
            assert td.detect_relocalization_candidates(qv, covis, map_id=mid).tolist() \
                == jd.detect_relocalization_candidates(qv, covis, map_id=mid).tolist()
        two = lambda mid, k: [k - 2, k + 2]
        assert td.detect_n_best_candidates(qv, {q, q + 4}, two, n_best=3,
                                           exclude_map_id=q % 2) \
            == jd.detect_n_best_candidates(qv, {q, q + 4}, two, n_best=3,
                                           exclude_map_id=q % 2)
        # the excluded slots never come back
        got = td.detect_n_best_candidates(qv, {q, q + 4}, two, n_best=5,
                                          exclude_map_id=q % 2)
        assert (q % 2, q) not in got and (q % 2, q + 4) not in got


def test_database_erase_and_clear_map(vocabs):
    jd, td, places, rng = _databases(vocabs, seed=5)
    covis = lambda k: []
    for db in (jd, td):
        db.erase(2, map_id=0)
        db.erase(3, map_id=1)
        db.clear_map(1)
    np.testing.assert_array_equal(np_(td.kf_words), jd.kf_words)
    np.testing.assert_array_equal(np_(td.kf_weights), jd.kf_weights)
    np.testing.assert_array_equal(td.active, jd.active)
    assert td._free == jd._free and td._row == jd._row
    _, qv = jd.compute_bow(perturb(places[2], 4, rng), np.ones(120, bool))
    got = td.detect_relocalization_candidates(qv, covis)
    assert got.tolist() == jd.detect_relocalization_candidates(qv, covis).tolist()
    assert 2 not in got.tolist() and not any(s % 2 for s in got.tolist())
    # a freed row is reused by the next keyframe, on both sides
    _, v = jd.compute_bow(places[0], np.ones(120, bool))
    jd.add(11, v, map_id=0)
    td.add(11, v, map_id=0)
    assert td.row_for(11) == jd.row_for(11)
    # converted database: same rows
    cd = convert.keyframe_database(jd, vocabs[1], device="cpu")
    np.testing.assert_array_equal(np_(cd.kf_words), jd.kf_words)
    assert cd.detect_relocalization_candidates(qv, covis).tolist() == \
        jd.detect_relocalization_candidates(qv, covis).tolist()


# ------------------------------------------------------------------ matching
def test_search_by_bow_matches_jax(vocabs):
    jv, tv = vocabs
    rng = np.random.default_rng(6)
    n = 300
    d1 = random_words(rng, n)
    perm = rng.permutation(n)
    d2 = perturb(d1[perm], 8, rng)
    a1 = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    a2 = np.mod(a1[perm] + 0.3 + rng.normal(0, 0.02, n), 2 * np.pi).astype(np.float32)
    v1, v2 = rng.random(n) < 0.95, rng.random(n) < 0.95
    w1, w2 = tv.words_np(d1), tv.words_np(d2)
    ref = jmatch.search_by_bow(
        jnp.asarray(w1), jdesc.descriptor_planes(jnp.asarray(d1)), jnp.asarray(v1),
        jnp.asarray(a1), jnp.asarray(w2), jdesc.descriptor_planes(jnp.asarray(d2)),
        jnp.asarray(v2), jnp.asarray(a2), k=tv.k)
    got = tmatch.search_by_bow(
        torch.from_numpy(w1), words_t(d1), torch.from_numpy(v1), torch.from_numpy(a1),
        torch.from_numpy(w2), words_t(d2), torch.from_numpy(v2), torch.from_numpy(a2),
        k=tv.k)
    ok = np.asarray(ref[2])
    np.testing.assert_array_equal(np_(got[2]), ok)
    np.testing.assert_array_equal(np_(got[0])[ok], np.asarray(ref[0])[ok])
    assert int(got[3]) == int(ref[3]) > 50


@pytest.mark.parametrize("policy", ["loop", "reloc"])
def test_loop_and_reloc_matches_equal_dense_ratio(policy):
    """The masked matches of the loop closer (has1 x has2, both ways) and
    of the relocalizer (fval x g_valid, ratio 0.75) equal the reference's
    distance_matrix + where(mask, d, 2^20) + match_ratio: lowest column on
    ties, 2^20 on an empty row."""
    rng = np.random.default_rng(7 if policy == "loop" else 8)
    n, m = 400, 350
    b = random_words(rng, m)
    a = np.concatenate([perturb(b[:250], 20, rng), random_words(rng, n - 250)])
    a[5] = a[6]                                  # equal rows
    b[10] = b[11]                                # equal columns: a tie
    if policy == "loop":
        r1, r2 = rng.random(n) < 0.8, rng.random(m) < 0.8
    else:
        r1, r2 = rng.random(n) < 0.9, np.ones(m, bool)
    r1[7] = True
    mask = r1[:, None] & r2[None, :]
    mask[7] = False                              # an empty row
    dist = jham.distance_matrix(jdesc.descriptor_planes(jnp.asarray(a)),
                                jdesc.descriptor_planes(jnp.asarray(b)))
    dist = jnp.where(jnp.asarray(mask), dist, 1 << 20)
    ridx, rbest, rok = jham.match_ratio(dist, max_dist=jham.TH_LOW, ratio=0.75)
    idx, best, ok = tham.masked_match_ratio(words_t(a), words_t(b), torch.from_numpy(mask),
                                            max_dist=tham.TH_LOW, ratio=0.75, policy=policy)
    np.testing.assert_array_equal(np_(ok), np.asarray(rok))
    np.testing.assert_array_equal(np_(best), np.asarray(rbest))
    np.testing.assert_array_equal(np_(idx), np.asarray(ridx))
    assert int(np_(best)[7]) == 1 << 20 and np.asarray(rok).sum() > 100
    if policy == "loop":   # the reverse direction and the mutual check
        ridx_ba, _, _ = jham.match_ratio(dist.T, max_dist=jham.TH_LOW, ratio=0.75)
        rmut = jham.mutual_filter(ridx, rok, ridx_ba)
        _, _, mut = tmatch._both_ways(words_t(a), words_t(b), torch.from_numpy(mask),
                                      tham.TH_LOW, 0.75, "loop")
        np.testing.assert_array_equal(np_(mut), np.asarray(rmut))


def test_popcount_distances_match_jax():
    rng = np.random.default_rng(9)
    a, b = random_words(rng, 60), random_words(rng, 45)
    np.testing.assert_array_equal(
        np_(tham.distance_matrix_popcount(words_t(a), words_t(b))),
        np.asarray(jham.distance_matrix_popcount(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(
        np_(tham.distance_vector(words_t(a), words_t(a[::-1].copy()))),
        np.asarray(jham.distance_vector(jnp.asarray(a), jnp.asarray(a[::-1]))))


# ----------------------------------------------------------------------- Lie
def _rots(rng, n, scale=1.0):
    return Rotation.from_rotvec(rng.normal(0, scale, (n, 3))).as_matrix().astype(np.float32)


def test_sim3_se3_quaternion_functions_match_jax():
    rng = np.random.default_rng(10)
    n = 32
    xi = rng.normal(0, 0.4, (n, 7)).astype(np.float32)
    xi[:4, 3:6] *= 1e-7    # small angle
    xi[4:8, 6] *= 1e-7     # small scale
    xi[8:10] *= 1e-8       # both small
    s, R, t = jlie.sim3_exp(jnp.asarray(xi))
    ts, tR, tt = tlie.sim3_exp(t32(xi))
    for a, b in ((ts, s), (tR, R), (tt, t)):
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np_(tlie.sim3_log(ts, tR, tt)),
                               np.asarray(jlie.sim3_log(s, R, t)), atol=1e-5)
    s2, R2 = rng.uniform(0.5, 2, n).astype(np.float32), _rots(rng, n)
    t2 = rng.normal(0, 1, (n, 3)).astype(np.float32)
    p = rng.normal(0, 2, (n, 3)).astype(np.float32)
    jc = jlie.sim3_compose(s, R, t, jnp.asarray(s2), jnp.asarray(R2), jnp.asarray(t2))
    tc = tlie.sim3_compose(ts, tR, tt, t32(s2), t32(R2), t32(t2))
    ji, ti = jlie.sim3_inverse(*jc), tlie.sim3_inverse(*tc)
    for a, b in zip(tc + ti, jc + ji):
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np_(tlie.sim3_apply(*tc, t32(p))),
                               np.asarray(jlie.sim3_apply(*jc, jnp.asarray(p))),
                               rtol=1e-5, atol=1e-5)
    # SE(3)
    np.testing.assert_allclose(np_(tlie.se3_log(t32(R2), t32(t2))),
                               np.asarray(jlie.se3_log(jnp.asarray(R2), jnp.asarray(t2))),
                               atol=1e-5)
    for a, b in zip(tlie.se3_inverse(t32(R2), t32(t2)) + tlie.se3_compose(
            t32(R2), t32(t2), tR, tt) + (tlie.se3_matrix(t32(R2), t32(t2)),),
            jlie.se3_inverse(jnp.asarray(R2), jnp.asarray(t2)) + jlie.se3_compose(
                jnp.asarray(R2), jnp.asarray(t2), R, t)
            + (jlie.se3_matrix(jnp.asarray(R2), jnp.asarray(t2)),)):
        np.testing.assert_allclose(np_(a), np.asarray(b), atol=1e-5)
    np.testing.assert_allclose(np_(tlie._left_jacobian_inv(t32(xi[:, 3:6]))),
                               np.asarray(jlie._left_jacobian_inv(jnp.asarray(xi[:, 3:6]))),
                               atol=1e-5)
    # quaternions, each branch of Shepperd's pivot
    Rq = np.concatenate([R2, Rotation.from_rotvec(
        np.pi * np.eye(3) * 0.99).as_matrix().astype(np.float32)])
    q = tlie.quat_from_matrix(t32(Rq))
    np.testing.assert_allclose(np_(q), np.asarray(jlie.quat_from_matrix(jnp.asarray(Rq))),
                               atol=1e-5)
    np.testing.assert_allclose(np_(tlie.quat_to_matrix(q)),
                               np.asarray(jlie.quat_to_matrix(jnp.asarray(np_(q)))),
                               atol=1e-5)
    np.testing.assert_allclose(np_(tlie.quat_to_matrix(q)), Rq, atol=1e-5)


# ------------------------------------------------------------ Sim3, PnP, graph
def _scene(rng, n):
    return np.stack([rng.uniform(-4, 4, n), rng.uniform(-2.5, 2.5, n),
                     rng.uniform(4, 10, n)], -1).astype(np.float32)


def _jax_samples(key, valid, n_hyp, sample):
    """The reference's RANSAC draw (categorical over the valid rows)."""
    v = jnp.asarray(valid, jnp.float32)
    probs = v / jnp.maximum(v.sum(), 1.0)
    return np.array(jax.random.categorical(
        key, jnp.log(probs + 1e-20)[None, :].repeat(n_hyp * sample, 0)
    ).reshape(n_hyp, sample))


@pytest.mark.parametrize("fix_scale", [False, True])
def test_horn_alignment_matches_jax(fix_scale):
    rng = np.random.default_rng(11)
    p1 = _scene(rng, 30)
    Rg = _rots(rng, 1, 0.4)[0]
    p2 = (1.7 * p1 @ Rg.T + np.array([0.5, -1.0, 2.0])).astype(np.float32)
    p2 += rng.normal(0, 0.01, p2.shape).astype(np.float32)
    ref = jsim3.horn_alignment(jnp.asarray(p1), jnp.asarray(p2), fix_scale)
    got = tsim3.horn_alignment(t32(p1), t32(p2), fix_scale)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_sim3_ransac_and_optimize_match_jax(fix_scale):
    rng = np.random.default_rng(12)
    n = 120
    p1 = _scene(rng, n)
    Rg = Rotation.from_rotvec([0.05, 0.3, -0.1]).as_matrix().astype(np.float32)
    sg = 1.0 if fix_scale else 1.4
    p2 = (sg * p1 @ Rg.T + np.array([0.3, -0.2, 1.0])).astype(np.float32)
    uv1 = np.asarray(JCAM.project(jnp.asarray(p1)))
    uv2 = np.asarray(JCAM.project(jnp.asarray(p2)))
    p2n = p2 + rng.normal(0, 0.005, p2.shape).astype(np.float32)
    bad = rng.random(n) < 0.25
    p2n[bad] += rng.uniform(1, 3, (bad.sum(), 3)).astype(np.float32)
    valid = np.ones(n, bool)
    key = jax.random.PRNGKey(2)
    ref = jsim3.sim3_ransac(jnp.asarray(p1), jnp.asarray(p2n), jnp.asarray(uv1),
                            jnp.asarray(uv2), jnp.asarray(valid), JCAM, JCAM, key,
                            fix_scale=fix_scale)
    got = tsim3.sim3_ransac(t32(p1), t32(p2n), t32(uv1), t32(uv2), torch.from_numpy(valid),
                            TCAM, TCAM, samples=torch.from_numpy(
                                _jax_samples(key, valid, 256, 3)), fix_scale=fix_scale)
    assert int(got.n_inliers) == int(ref.n_inliers) > 0.6 * n
    np.testing.assert_array_equal(np_(got.inliers), np.asarray(ref.inliers))
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(np_(a), np.asarray(b), atol=1e-4)
    rs = jsim3.optimize_sim3(ref.s, ref.R, ref.t, jnp.asarray(p1), jnp.asarray(p2n),
                             jnp.asarray(uv1), jnp.asarray(uv2), jnp.ones(n), ref.inliers,
                             JCAM, JCAM, fix_scale=fix_scale)
    gs = tsim3.optimize_sim3(got.s, got.R, got.t, t32(p1), t32(p2n), t32(uv1), t32(uv2),
                             torch.ones(n), got.inliers, TCAM, TCAM, fix_scale=fix_scale)
    for a, b in zip(gs[:3], rs[:3]):
        np.testing.assert_allclose(np_(a), np.asarray(b), atol=1e-4)
        assert np_(a).dtype == np.float32
    np.testing.assert_array_equal(np_(gs[3]), np.asarray(rs[3]))


def test_pnp_ransac_and_relocalize_pose_match_jax():
    rng = np.random.default_rng(13)
    n = 150
    pts = _scene(rng, n)
    Rg = Rotation.from_rotvec([0.1, -0.25, 0.05]).as_matrix().astype(np.float32)
    tg = np.array([0.4, -0.1, 0.3], np.float32)
    uv = np.asarray(JCAM.project(jnp.asarray(pts @ Rg.T + tg))).copy()
    out = rng.random(n) < 0.3
    uv[out] += rng.uniform(30, 120, (out.sum(), 2))
    uv = uv.astype(np.float32)
    valid = rng.random(n) < 0.95
    key = jax.random.PRNGKey(0)
    samples = torch.from_numpy(_jax_samples(key, valid, 256, 6))
    R, t, inl, nn = jpnp.pnp_ransac(jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(valid),
                                    JCAM, key)
    gR, gt, ginl, gn = tpnp.pnp_ransac(t32(pts), t32(uv), torch.from_numpy(valid), TCAM,
                                       samples=samples)
    assert int(gn) == int(nn)
    np.testing.assert_array_equal(np_(ginl), np.asarray(inl))
    np.testing.assert_allclose(np_(gR), np.asarray(R), atol=1e-4)
    np.testing.assert_allclose(np_(gt), np.asarray(t), atol=1e-4)
    info = (1.0 / 1.2 ** (2 * rng.integers(0, 3, n))).astype(np.float32)
    jr = jpnp.relocalize_pose(jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(info),
                              jnp.asarray(valid), JCAM, key)
    tr = tpnp.relocalize_pose(t32(pts), t32(uv), t32(info), torch.from_numpy(valid), TCAM,
                              samples=samples)
    assert bool(tr[2]) and bool(jr[2]) and int(tr[3]) == int(jr[3])
    np.testing.assert_allclose(np_(tr[0]), np.asarray(jr[0]), atol=1e-4)
    np.testing.assert_allclose(np_(tr[1]), np.asarray(jr[1]), atol=1e-4)


def _ring_graph(rng, M=12):
    """A drifted chain of poses on a circle with one exact loop edge (the
    JAX package's `TestPoseGraph` ring), plus a covisibility edge."""
    a = 2 * np.pi * np.arange(M) / M
    c = np.stack([6 * np.cos(a), 6 * np.sin(a), np.zeros(M)], -1)
    R_true = []
    for ci in c:
        z = -ci / np.linalg.norm(ci)
        x = np.cross([0, 0, 1.0], z)
        x /= np.linalg.norm(x)
        R_true.append(np.stack([x, np.cross(z, x), z], 1).T)
    R_true = np.asarray(R_true, np.float32)
    t_true = (-np.einsum("nij,nj->ni", R_true, c)).astype(np.float32)
    s_est, R_est, t_est = np.ones(M, np.float32), R_true.copy(), t_true.copy()
    dR = Rotation.from_rotvec([0.01, -0.02, 0.03]).as_matrix().astype(np.float32)
    acc_R, acc_t, acc_s = np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 1.0
    for i in range(1, M):
        acc_s *= 1.02
        acc_R = dR @ acc_R
        acc_t = acc_t + np.array([0.01, 0.005, 0.0], np.float32)
        si, Ri, ti = jlie.sim3_compose(jnp.float32(1.0), jnp.asarray(R_true[i]), jnp.asarray(t_true[i]),
                                       jnp.float32(acc_s), jnp.asarray(acc_R),
                                       jnp.asarray(acc_t))
        s_est[i], R_est[i], t_est[i] = float(si), np.asarray(Ri), np.asarray(ti)
    e = [(i, i + 1) for i in range(M - 1)] + [(0, M - 1), (2, 5)]
    m_s, m_R, m_t = [], [], []
    for k, (i, j) in enumerate(e):
        src = (s_est, R_est, t_est) if k < M - 1 else (np.ones(M), R_true, t_true)
        sj, Rj, tj = jlie.sim3_compose(
            jnp.float32(src[0][j]), jnp.asarray(src[1][j]), jnp.asarray(src[2][j]),
            *jlie.sim3_inverse(jnp.float32(src[0][i]), jnp.asarray(src[1][i]),
                               jnp.asarray(src[2][i])))
        m_s.append(float(sj) * (1.0 + 0.01 * rng.normal()))
        m_R.append(np.asarray(Rj))
        m_t.append(np.asarray(tj))
    e = np.asarray(e)
    return (s_est, R_est, t_est, e[:, 0], e[:, 1], np.asarray(m_s, np.float32),
            np.stack(m_R), np.stack(m_t), rng.uniform(0.5, 2.0, len(e)).astype(np.float32))


@pytest.mark.parametrize("dof", ["sim3", "se3", "4dof"])
def test_optimize_pose_graph_matches_jax(dof):
    rng = np.random.default_rng(14)
    s0, R0, t0, ei, ej, ms, mR, mt, w = _ring_graph(rng)
    M = len(s0)
    base = {"sim3": tpg.DOF_SIM3, "se3": tpg.DOF_SE3, "4dof": tpg.DOF_4DOF}[dof]
    np.testing.assert_array_equal(np.asarray(base), np.asarray(
        {"sim3": jpg.DOF_SIM3, "se3": jpg.DOF_SE3, "4dof": jpg.DOF_4DOF}[dof]))
    d = np.tile(np.asarray(base, np.float32), (M, 1))
    d[0] = 0.0
    jg = jpg.PoseGraph(*(jnp.asarray(x) for x in (s0, R0, t0, ei.astype(np.int32),
                                                  ej.astype(np.int32), ms, mR, mt, w, d)))
    tg = tpg.PoseGraph(t32(s0), t32(R0), t32(t0), torch.from_numpy(ei),
                       torch.from_numpy(ej), t32(ms), t32(mR), t32(mt), t32(w), t32(d))
    ref = jpg.optimize_pose_graph(jg)
    got = tpg.optimize_pose_graph(tg)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np_(a), np.asarray(b), atol=1e-4)
        assert np_(a).dtype == np.float32
    # the fixed vertex stays; the graph moved the others
    np.testing.assert_array_equal(np_(got[1])[0], R0[0])
    assert np.abs(np_(got[2]) - t0).max() > 1e-2
    pts = rng.normal(0, 2, (50, 3)).astype(np.float32)
    jc = jpg.correct_points(jnp.asarray(pts), jnp.float32(1.2), jnp.asarray(R0[3]),
                            jnp.asarray(t0[3]), ref[0][3], ref[1][3], ref[2][3])
    tc = tpg.correct_points(t32(pts), torch.tensor(1.2), t32(R0[3]), t32(t0[3]),
                            got[0][3], got[1][3], got[2][3])
    np.testing.assert_allclose(np_(tc), np.asarray(jc), atol=1e-4)
