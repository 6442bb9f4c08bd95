"""Parity of the port's matcher policies against the JAX package, CPU:
`search_for_initialization`, `search_for_triangulation` and
`fuse_by_projection`, on seeded feature-level
frames of one landmark field (the frames `tests/test_slam_e2e.py` tracks).

Each policy reaches kernel K1 through `masked_match_ratio`; here the port
runs K1's plain version, the reference its XLA path. Indices, distances and
`ok` masks must be identical: they follow from integer distances and from
window or band tests that no rounding reaches at these inputs (the
initialization test checks that no pair lies within 1e-3 px of its window
edge)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orbslam3_tpu.core.camera import Camera as JCamera
from orbslam3_tpu.kernels import orb_descriptor as jdesc
from orbslam3_tpu.utils import synth
from orbslam3_tpu.vision import matcher as jmatcher
from orbslam3_tpu_torch.core.camera import Camera as TCamera
from orbslam3_tpu_torch.vision import matcher as tmatcher
from torch_parity import np_

CJ = JCamera.pinhole(458.0, 458.0, 320.0, 240.0, width=640, height=480)
CT = TCamera.pinhole(458.0, 458.0, 320.0, 240.0, width=640, height=480, device="cpu")


@pytest.fixture(scope="module")
def scene():
    world = synth.make_world(n_points=3000, seed=4)
    R, t = synth.orbit_trajectory(n_frames=80, radius=3.0, arc=1.0)
    frames = {}
    for i in (0, 4, 9):
        f, gt = synth.render_features(world, R[i], t[i], CJ, capacity=600, seed=100 + i)
        frames[i] = dict(uv=np.asarray(f.uv), desc=np.asarray(f.desc),
                         valid=np.asarray(f.valid), octave=np.asarray(f.octave), gt=gt)
    return world, R, t, frames


def _words(desc):
    return torch.from_numpy(np.array(desc, np.uint32).view(np.int32))


def _f(frame, key):
    return torch.from_numpy(np.array(frame[key]))


@pytest.mark.parametrize("check_rotation", [False, True])
def test_search_for_initialization_matches_jax(scene, check_rotation):
    _, _, _, fr = scene
    a, b = fr[0], fr[4]
    rng = np.random.default_rng(0)
    ang_a = rng.uniform(0, 2 * np.pi, 600).astype(np.float32)
    ang_b = (ang_a[rng.permutation(600)] + 0.2).astype(np.float32)
    ref = jmatcher.search_for_initialization(
        jnp.asarray(a["uv"]), jdesc.descriptor_planes(jnp.asarray(a["desc"])),
        jnp.asarray(a["valid"]), jnp.asarray(b["uv"]),
        jdesc.descriptor_planes(jnp.asarray(b["desc"])), jnp.asarray(b["valid"]),
        radius=100.0, ang1=jnp.asarray(ang_a), ang2=jnp.asarray(ang_b),
        check_rotation=check_rotation)
    got = tmatcher.search_for_initialization(
        _f(a, "uv"), _words(a["desc"]), _f(a, "valid"), _f(b, "uv"), _words(b["desc"]),
        _f(b, "valid"), radius=100.0, ang1=torch.from_numpy(ang_a),
        ang2=torch.from_numpy(ang_b), check_rotation=check_rotation)
    idx_r, best_r, ok_r, n_r = (np.asarray(x) for x in ref)
    idx, best, ok, n = (np_(x) for x in got)
    np.testing.assert_array_equal(ok, ok_r)
    np.testing.assert_array_equal(idx[ok], idx_r[ok_r])
    np.testing.assert_array_equal(best, best_r)
    assert int(n) == int(n_r) > (20 if check_rotation else 200)
    d2 = np.sum((a["uv"][:, None] - b["uv"][None]) ** 2, -1)
    assert np.abs(np.sqrt(d2) - 100.0).min() > 1e-3  # no pair on the window edge


def test_search_for_triangulation_matches_jax(scene):
    """Two keyframes five frames apart, features already bound to points
    withheld (avail), the epipolar band at 2 sigma."""
    _, R, t, fr = scene
    a, b = fr[4], fr[9]
    rng = np.random.default_rng(1)
    avail_a = a["valid"] & (rng.random(600) < 0.6)
    avail_b = b["valid"] & (rng.random(600) < 0.6)
    ref = jmatcher.search_for_triangulation(
        jnp.asarray(a["uv"]), jdesc.descriptor_planes(jnp.asarray(a["desc"])),
        jnp.asarray(avail_a), jnp.asarray(b["uv"]),
        jdesc.descriptor_planes(jnp.asarray(b["desc"])), jnp.asarray(avail_b),
        jnp.asarray(R[4]), jnp.asarray(t[4]), jnp.asarray(R[9]), jnp.asarray(t[9]), CJ)
    got = tmatcher.search_for_triangulation(
        _f(a, "uv"), _words(a["desc"]), torch.from_numpy(avail_a), _f(b, "uv"),
        _words(b["desc"]), torch.from_numpy(avail_b), torch.from_numpy(R[4]),
        torch.from_numpy(t[4]), torch.from_numpy(R[9]), torch.from_numpy(t[9]), CT)
    idx_r, ok_r = (np.asarray(x) for x in ref)
    idx, ok = (np_(x) for x in got)
    np.testing.assert_array_equal(ok, ok_r)
    np.testing.assert_array_equal(idx[ok], idx_r[ok_r])
    assert ok.sum() > 100
    right = a["gt"][ok] == b["gt"][idx[ok]]
    assert right.mean() > 0.9  # the matches are the planted landmarks


def test_fuse_by_projection_matches_jax(scene):
    """A keyframe's landmarks (true positions, canonical descriptors)
    projected into another keyframe, 3 px octave-scaled windows."""
    world, R, t, fr = scene
    src, dst = fr[4], fr[9]
    ids = np.unique(src["gt"][src["gt"] >= 0])
    K = 1024
    pos = np.zeros((K, 3), np.float32)
    desc = np.zeros((K, 8), np.uint32)
    valid = np.zeros(K, bool)
    pos[:len(ids)] = world.points[ids]
    desc[:len(ids)] = np.asarray(jdesc.pack_bits(jnp.asarray(world.desc_bits[ids],
                                                              jnp.uint32)))
    valid[:len(ids)] = True
    ref = jmatcher.fuse_by_projection(
        jnp.asarray(pos), jmatcher.mp_descriptor_planes(jnp.asarray(desc)),
        jnp.asarray(valid), jnp.asarray(R[9]), jnp.asarray(t[9]), CJ,
        jnp.asarray(dst["uv"]), jdesc.descriptor_planes(jnp.asarray(dst["desc"])),
        jnp.asarray(dst["octave"]), jnp.asarray(dst["valid"]))
    got = tmatcher.fuse_by_projection(
        torch.from_numpy(pos), _words(desc), torch.from_numpy(valid),
        torch.from_numpy(R[9]), torch.from_numpy(t[9]), CT, _f(dst, "uv"),
        _words(dst["desc"]), _f(dst, "octave"), _f(dst, "valid"))
    idx_r, ok_r = (np.asarray(x) for x in ref)
    idx, ok = (np_(x) for x in got)
    np.testing.assert_array_equal(ok, ok_r)
    np.testing.assert_array_equal(idx[ok], idx_r[ok_r])
    assert ok.sum() > 100
    assert (dst["gt"][idx[ok]] == np.concatenate([ids, np.full(K - len(ids), -2)])[ok]).mean() > 0.9
