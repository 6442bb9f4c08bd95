"""Port parity, CPU: the loop closer and the global BA.

The JAX package's loop-closing test maps (`tests/test_loop_closing.py`: the
ring-drift revisit and the noisy circle) are built once with numpy and
carried to the port by `convert.map_state` / `convert.vocabulary`; the
Sim3 RANSAC samples the reference draws are injected into the port
(`LoopCloser.sample_fn`). Checked:

- `LoopCloser` on the ring-drift map: the same event, keyframe and matched
  keyframe, the loop Sim3's scale within 1e-3, keyframe poses after the
  correction (window, fuse, essential graph, global BA inline) within
  1e-3, the same points alive; with `consistency_threshold` 3 the chains
  per map after every keyframe equal the reference's (groups and counts);
- the database erase hook: culling a keyframe frees its row;
- `GlobalBA`: converges (and to the reference's inline solve within 1e-3),
  an abort discards the solve, keyframes and points created during the
  solve are caught up through the spanning tree (1e-4), as the JAX
  package's `TestGlobalBA`;
- `run_global_ba` against the reference's, 1e-3.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import test_loop_closing as jtests
from orbslam3_tpu.engine import global_ba as jgba
from orbslam3_tpu.engine.loop_closing import LoopCloser as JLoopCloser
from orbslam3_tpu.engine.loop_closing import LoopCloserConfig as JLCConfig
from orbslam3_tpu.place.database import KeyFrameDatabase as JDB
from orbslam3_tpu.place.vocab import build_vocabulary
from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.core.camera import Camera as TCamera
from orbslam3_tpu_torch.engine import global_ba as tgba
from orbslam3_tpu_torch.engine.loop_closing import LoopCloser, LoopCloserConfig
from orbslam3_tpu_torch.place.database import KeyFrameDatabase
from orbslam3_tpu_torch.slam_map.atlas import Atlas
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TCAM = TCamera.pinhole(458.0, 457.0, 376.0, 240.0, device="cpu")
LC_KW = dict(min_kfs_in_map=6, run_global_ba=True, gba_iters=6)


def jax_sampler(n_hyp=256, sample=3):
    """The reference's Sim3 RANSAC draws, in its key order: the loop
    closer splits its key once per verified candidate."""
    state = {"key": jax.random.PRNGKey(1234)}

    def draw(n):
        state["key"], sub = jax.random.split(state["key"])
        probs = jnp.ones(n) / n
        return np.asarray(jax.random.categorical(
            sub, jnp.log(probs + 1e-20)[None, :].repeat(n_hyp * sample, 0)
        ).reshape(n_hyp, sample))
    return draw


def port_atlas(jatlas):
    """The port's Atlas holding converted copies of a JAX Atlas's maps."""
    atlas = Atlas(jatlas.cfg, device="cpu")
    atlas.maps = {mid: convert.map_state(m, device="cpu") for mid, m in jatlas.maps.items()}
    atlas.active_id = jatlas.active_id
    atlas._next_map_id = jatlas._next_map_id
    return atlas


@pytest.fixture
def revisit(monkeypatch):
    """The ring-drift revisit of the JAX tests, from a fixed seed, and a
    vocabulary trained like theirs."""
    monkeypatch.setattr(jtests, "RNG", np.random.default_rng(17))
    atlas, m, kfs, R_true, t_true, desc = jtests.build_revisit_scenario()
    voc = build_vocabulary(jtests.RNG.integers(0, 2 ** 32, (1000, 8), dtype=np.uint32),
                           k=6, depth=3)
    return atlas, kfs, voc


def _closers(atlas, voc, **cfg):
    jlc = JLoopCloser(jtests.CAM, atlas, JDB(voc, max_keyframes=32), JLCConfig(**cfg))
    jlc.gba_background = False
    tatlas = port_atlas(atlas)
    tlc = LoopCloser(TCAM, tatlas, KeyFrameDatabase(convert.vocabulary(voc), max_keyframes=32,
                                                    device="cpu"),
                     LoopCloserConfig(**cfg), device="cpu", sample_fn=jax_sampler())
    tlc.gba_background = False
    return jlc, tlc, tatlas


def test_loop_closer_on_ring_drift_matches_jax(revisit):
    atlas, kfs, voc = revisit
    jlc, tlc, tatlas = _closers(atlas, voc, consistency_threshold=1, **LC_KW)
    jm, tm = atlas.active, tatlas.active
    for k in kfs:
        jev, tev = jlc.process_keyframe(k), tlc.process_keyframe(k)
        assert (jev is None) == (tev is None), k
        if jev is not None:
            assert (tev.kind, tev.kf, tev.matched_kf) == (jev.kind, jev.kf, jev.matched_kf)
            assert abs(tev.scale - jev.scale) < 1e-3
            assert abs(tev.n_inliers - jev.n_inliers) <= 2
    assert len(jlc.events) == len(tlc.events) == 1 and jlc.events[0].kind == "loop"
    assert abs(tlc.events[0].scale - 1.1) < 0.02
    assert tlc.gba.n_finished == jlc.gba.n_finished == 1
    ids = jm.keyframe_ids()
    np.testing.assert_array_equal(tm.keyframe_ids(), ids)
    np.testing.assert_allclose(tm.kf_R[ids], jm.kf_R[ids], atol=1e-3)
    np.testing.assert_allclose(tm.kf_t[ids], jm.kf_t[ids], atol=1e-3)
    np.testing.assert_array_equal(tm.mp_valid, jm.mp_valid)
    np.testing.assert_array_equal(tm.kf_obs_mp, jm.kf_obs_mp)
    live = np.nonzero(jm.mp_valid)[0]
    np.testing.assert_allclose(tm.mp_pos[live], jm.mp_pos[live], atol=2e-3)


def test_consistency_chains_match_jax(revisit):
    """With three consecutive keyframes needed, the per-map chains (their
    covisible uid groups and counts) after every keyframe equal the
    reference's, and the loop fires at the same keyframe."""
    atlas, kfs, voc = revisit
    jlc, tlc, _ = _closers(atlas, voc, consistency_threshold=3, **LC_KW)
    fired = []
    for k in kfs:
        jev, tev = jlc.process_keyframe(k), tlc.process_keyframe(k)
        assert (jev is None) == (tev is None)
        if jev is not None:
            fired.append((tev.kf, tev.matched_kf, jev.kf, jev.matched_kf))
        assert tlc._chains.keys() == jlc._chains.keys()
        for mid in jlc._chains:
            assert tlc._chains[mid] == jlc._chains[mid]
    assert all(a == c and b == d for a, b, c, d in fired)
    # chains are per map: another map's chain is its own
    tlc._chains[7] = [({1, 2}, 1)]
    assert tlc._chains[7][0][1] == 1 and 7 not in jlc._chains


def test_culled_keyframe_leaves_the_database(revisit):
    atlas, kfs, voc = revisit
    _, tlc, tatlas = _closers(atlas, voc, consistency_threshold=3, **LC_KW)
    m = tatlas.active
    for k in kfs[:7]:
        tlc.process_keyframe(k)
    assert tlc.db.row_for(kfs[2]) is not None
    assert sum(getattr(cb, "_kfdb_hook", False) for cb in m.on_kf_removed) == 1
    m.remove_keyframe(kfs[2])
    assert tlc.db.row_for(kfs[2]) is None
    assert tlc.db.row_for(kfs[3]) is not None
    tlc.process_keyframe(kfs[7])  # the hook is registered once
    assert sum(getattr(cb, "_kfdb_hook", False) for cb in m.on_kf_removed) == 1


# --------------------------------------------------------------- global BA
def _noisy():
    jm, R_true, t_true, pts, desc, ids = jtests.TestGlobalBA()._noisy_map()
    return jm, convert.map_state(jm, device="cpu"), R_true, t_true


def _pose_rms(m, R_true, t_true):
    kfs = m.keyframe_ids()
    errs = [np.linalg.norm(-m.kf_R[k].T @ m.kf_t[k] - (-R_true[i].T @ t_true[i]))
            for i, k in enumerate(kfs)]
    return float(np.sqrt(np.mean(np.square(errs))))


@pytest.mark.parametrize("background", [True, False])
def test_global_ba_converges_like_jax(background):
    jm, tm, R_true, t_true = _noisy()
    before = _pose_rms(tm, R_true, t_true)
    k0 = int(tm.keyframe_ids()[0])
    gba = tgba.GlobalBA(TCAM, iters_per_block=5, n_blocks=3, device="cpu")
    gba.request(tm, fixed_kf=k0, background=background)
    gba.join()
    assert gba.n_finished == 1 and not gba.running
    assert _pose_rms(tm, R_true, t_true) < 0.35 * before
    ref = jgba.GlobalBA(jtests.CAM, iters_per_block=5, n_blocks=3)
    ref.request(jm, fixed_kf=k0, background=False)
    ids = jm.keyframe_ids()
    np.testing.assert_allclose(tm.kf_R[ids], jm.kf_R[ids], atol=1e-3)
    np.testing.assert_allclose(tm.kf_t[ids], jm.kf_t[ids], atol=1e-3)


def test_global_ba_abort_discards():
    _, tm, _, _ = _noisy()
    R_before = tm.kf_R.copy()
    gba = tgba.GlobalBA(TCAM, iters_per_block=5, n_blocks=50, device="cpu")
    gate = threading.Event()
    solve = tgba.bundle_adjust

    def slow(*a, **k):            # the first block waits for the abort
        gate.wait(5.0)
        return solve(*a, **k)
    tgba.bundle_adjust = slow
    try:
        gba.request(tm, fixed_kf=int(tm.keyframe_ids()[0]), background=True)
        gba._abort.set()
        gate.set()
        gba.abort_and_join()
    finally:
        tgba.bundle_adjust = solve
    assert gba.n_finished == 0 and gba.n_aborted == 1
    np.testing.assert_array_equal(tm.kf_R, R_before)


def test_global_ba_catches_up_keyframes_created_during_the_solve():
    _, m, _, _ = _noisy()
    kfs = list(m.keyframe_ids())
    gba = tgba.GlobalBA(TCAM, iters_per_block=5, n_blocks=3, device="cpu")
    gate = threading.Event()
    solve = tgba.bundle_adjust

    def held(*a, **k):            # the solve waits until the insert is done
        gate.wait(5.0)
        return solve(*a, **k)
    tgba.bundle_adjust = held
    try:
        gba.request(m, fixed_kf=int(kfs[0]), background=True)
        parent = kfs[-1]
        R_rel = Rotation.from_rotvec([0, 0.05, 0]).as_matrix().astype(np.float32)
        t_rel = np.array([0.1, 0.0, 0.02], np.float32)
        N = 512
        with m.lock:
            child = m.add_keyframe(
                (R_rel @ m.kf_R[parent]).astype(np.float32),
                (R_rel @ m.kf_t[parent] + t_rel).astype(np.float32), float(len(kfs)),
                len(kfs), np.zeros((N, 2), np.float32), np.zeros(N, np.int32),
                np.zeros(N, np.float32), np.zeros((N, 8), np.uint32), np.zeros(N, bool),
                np.full(N, -1, np.int32), prev_kf=parent)
            p_new = m.add_points(np.array([[0.3, 0.2, 0.1]], np.float32),
                                 np.zeros((1, 8), np.uint32), first_kf=child)
            cam_old = m.kf_R[child] @ m.mp_pos[p_new[0]] + m.kf_t[child]
        gate.set()
        gba.join()
    finally:
        tgba.bundle_adjust = solve
    assert gba.n_finished == 1
    assert np.abs(m.kf_R[child] - R_rel @ m.kf_R[parent]).max() < 1e-4
    assert np.abs(m.kf_t[child] - (R_rel @ m.kf_t[parent] + t_rel)).max() < 1e-4
    cam_new = m.kf_R[child] @ m.mp_pos[p_new[0]] + m.kf_t[child]
    np.testing.assert_allclose(cam_new, cam_old, atol=1e-4)


def test_run_global_ba_matches_jax(revisit):
    atlas, kfs, voc = revisit
    jlc, tlc, tatlas = _closers(atlas, voc, consistency_threshold=3, **LC_KW)
    jm, tm = atlas.active, tatlas.active
    jlc.run_global_ba(jm, fixed_kf=kfs[0], n_iters=6)
    tlc.run_global_ba(tm, fixed_kf=kfs[0], n_iters=6)
    ids = jm.keyframe_ids()
    np.testing.assert_allclose(tm.kf_R[ids], jm.kf_R[ids], atol=1e-3)
    np.testing.assert_allclose(tm.kf_t[ids], jm.kf_t[ids], atol=1e-3)
    live = np.nonzero(jm.mp_valid)[0]
    np.testing.assert_allclose(tm.mp_pos[live], jm.mp_pos[live], atol=1e-3)


def test_bundle_adjust_rejects_a_non_finite_step():
    """A step that comes out non-finite is rejected, as the reference's:
    one observation's NaN weight makes every step NaN, and both packages
    return the keyframe where it was (the port's SVD raised on it before)."""
    from orbslam3_tpu.opt import ba as jba
    from orbslam3_tpu_torch.opt import ba as tba
    rng = np.random.default_rng(0)
    P = 40
    pts = np.stack([rng.uniform(-1, 1, P), rng.uniform(-1, 1, P), rng.uniform(4, 6, P)],
                   -1).astype(np.float32)
    uv = np.asarray(jtests.CAM.project(jnp.asarray(pts)))
    t = np.zeros((2, 3), np.float32)
    t[1] = -pts[0]
    info = np.ones(2 * P, np.float32)
    info[P + 3] = np.nan
    args = dict(R=np.stack([np.eye(3)] * 2).astype(np.float32), t=t, points=pts,
                kf_idx=np.repeat(np.arange(2, dtype=np.int32), P),
                lm_idx=np.tile(np.arange(P, dtype=np.int32), 2),
                uv=np.concatenate([uv, uv + 5]).astype(np.float32), info=info,
                valid=np.ones(2 * P, bool), fixed_kf=np.array([True, False]),
                fixed_lm=np.zeros(P, bool))
    ref, _, _ = jba.bundle_adjust(jba.BAProblem(**{k: jnp.asarray(v) for k, v in args.items()}),
                                  jtests.CAM, n_iters=4)
    got, _, _ = tba.bundle_adjust(tba.BAProblem(**{k: torch.as_tensor(v)
                                                   for k, v in args.items()}), TCAM, n_iters=4)
    np.testing.assert_array_equal(got.R.numpy(), np.asarray(ref.R))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-6)
    np.testing.assert_array_equal(got.R.numpy()[1], np.eye(3))
