"""Parity of the port's kernels/hamming and kernel K1 against the JAX
package, CPU.

K1's plain version (`masked_top2_reference`, which the wrapper runs on CPU
tensors) must reproduce `hamming_pallas.masked_top2(interpret=True)` under
the contract of tests/test_hamming_pallas.py: best and second exact, idx
exact on rows with a candidate, empty rows at >= 2^20. Distances are
integers, so every comparison here is exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orbslam3_tpu.kernels import hamming as jham
from orbslam3_tpu.kernels import hamming_pallas
from orbslam3_tpu.kernels import orb_descriptor as jdesc
from orbslam3_tpu_torch.kernels import hamming as tham
from orbslam3_tpu_torch.kernels import orb_descriptor as tdesc
from torch_parity import CASES, random_words, np_, top2_case as _case

BIG = 1 << 20




def _planes_j(words):
    return jdesc.descriptor_planes(jnp.asarray(words))


def _words_t(words):
    return torch.from_numpy(words.view(np.int32).copy())


@pytest.mark.parametrize("name", CASES)
def test_plain_top2_equals_pallas_interpret(name):
    a, b, mask = _case(name)
    idx_r, best_r, second_r = (np.asarray(x) for x in hamming_pallas.masked_top2(
        _planes_j(a), _planes_j(b), jnp.asarray(mask), interpret=True))
    idx, best, second = (np_(x) for x in tham.masked_top2(
        _words_t(a), _words_t(b), torch.from_numpy(mask)))
    np.testing.assert_array_equal(best, np.minimum(best_r, BIG))
    has = best_r < BIG
    np.testing.assert_array_equal(idx[has], idx_r[has])
    np.testing.assert_array_equal(second, np.minimum(second_r, BIG))
    assert (best[~has] >= BIG).all()
    # beyond the contract: empty rows point at column 0, like the kernel
    np.testing.assert_array_equal(idx, idx_r)


@pytest.mark.parametrize("name", CASES)
def test_plain_top2_accepts_planes(name):
    """Handed +/-1 planes, the wrapper packs them into words itself."""
    a, b, mask = _case(name)
    from_words = tham.masked_top2(_words_t(a), _words_t(b), torch.from_numpy(mask))
    pa = tdesc.descriptor_planes(_words_t(a))
    pb = tdesc.descriptor_planes(_words_t(b))
    from_planes = tham.masked_top2(pa, pb, torch.from_numpy(mask))
    for x, y in zip(from_words, from_planes):
        assert torch.equal(x, y)


def test_distance_matrix_matches_jax():
    rng = np.random.default_rng(1)
    a, b = random_words(rng, 40), random_words(rng, 70)
    ref = np.asarray(jham.distance_matrix(_planes_j(a), _planes_j(b)))
    got = tham.distance_matrix(tdesc.descriptor_planes(_words_t(a)),
                               tdesc.descriptor_planes(_words_t(b)))
    np.testing.assert_array_equal(np_(got), ref)
    np.testing.assert_array_equal(
        ref, np.asarray(jham.distance_matrix_popcount(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("max_dist,ratio", [(jham.TH_LOW, 0.9), (jham.TH_HIGH, 0.75)])
def test_match_ratio_matches_jax(max_dist, ratio):
    rng = np.random.default_rng(2)
    dist = rng.integers(0, 40, (64, 30)).astype(np.int32)  # many ties
    ref = jham.match_ratio(jnp.asarray(dist), max_dist=max_dist, ratio=ratio)
    got = tham.match_ratio(torch.from_numpy(dist), max_dist=max_dist, ratio=ratio)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np_(g), np.asarray(r))


# the reference's unfused path (jax.lax.top_k(dist, 2)) cannot take a
# single candidate column; the Pallas path and the port can
@pytest.mark.parametrize("name", [c for c in CASES if c != "single_column"])
def test_masked_match_ratio_matches_jax(name):
    a, b, mask = _case(name)
    ref = jham.masked_match_ratio(_planes_j(a), _planes_j(b), jnp.asarray(mask),
                                  max_dist=jham.TH_HIGH)
    got = tham.masked_match_ratio(tdesc.descriptor_planes(_words_t(a)),
                                  tdesc.descriptor_planes(_words_t(b)),
                                  torch.from_numpy(mask), max_dist=tham.TH_HIGH)
    idx_r, best_r, ok_r = (np.asarray(x) for x in ref)
    idx, best, ok = (np_(x) for x in got)
    np.testing.assert_array_equal(ok, ok_r)
    np.testing.assert_array_equal(idx[ok], idx_r[ok_r])
    np.testing.assert_array_equal(best, np.minimum(best_r, BIG))


def test_top2_rejects_bad_shapes():
    w = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="mask"):
        tham.masked_top2(w, w, torch.zeros((4, 5), dtype=torch.bool))
    with pytest.raises(ValueError, match="int32 words"):
        tham.masked_top2(w.long(), w, torch.zeros((4, 4), dtype=torch.bool))
