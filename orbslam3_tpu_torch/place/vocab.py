"""Binary bag-of-words vocabulary, flattened for a batched descent.

Port of `orbslam3_tpu/place/vocab.py` (DBoW2's `TemplatedVocabulary` as
ORB-SLAM3 loads it): a k-ary tree of 256-bit cluster centres; a descriptor
descends the tree by Hamming argmin at each level and lands on a leaf
"word"; an image becomes a tf-idf weighted, L1-normalized vector of words
scored with the L1 metric.

The tree is stored complete, one packed-descriptor array per level
(missing children padded and pushed to distance 2^20), so `descend` is one
gather + XOR + popcount + argmin per level over all descriptors of a frame,
on the descriptors' device. Training (`build_vocabulary`) is numpy on the
host: binary k-means with bitwise-majority centres (DBoW2's `HKmeansStep`).

The shipped vocabulary (`orbslam3_tpu/assets/vocab_100k.npz`, k = 10,
depth 5) is read by path as a data file (`default_vocabulary_path`).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from orbslam3_tpu_torch.kernels.hamming import BIG, _popcount32

DESC_WORDS = 8  # 256 bits / 32


def _popcount_np(x: np.ndarray) -> np.ndarray:
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101) >> 24


def hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,8) x (M,8) packed uint32 -> (N,M) int32 Hamming distances (host)."""
    x = np.bitwise_xor(a[:, None, :], b[None, :, :])
    return _popcount_np(x).sum(-1).astype(np.int32)


def _majority_center(packed: np.ndarray) -> np.ndarray:
    """Bitwise-majority centre of packed descriptors (DBoW2 meanValue)."""
    bits = np.unpackbits(packed.view(np.uint8), axis=1, bitorder="little")
    maj = (bits.sum(0) * 2 >= bits.shape[0]).astype(np.uint8)
    return np.packbits(maj, bitorder="little").view(np.uint32)


def _kmeans_binary(packed: np.ndarray, k: int, rng: np.random.Generator,
                   iters: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """Binary k-means; returns (centres (k,8), assignment (N,))."""
    n = packed.shape[0]
    k = min(k, n)
    sel = rng.choice(n, size=k, replace=False)
    centers = packed[sel].copy()
    assign = np.zeros(n, np.int64)
    for it in range(iters):
        d = hamming_np(packed, centers)
        new_assign = d.argmin(1)
        if np.array_equal(new_assign, assign) and it != 0:
            break
        assign = new_assign
        for c in range(k):
            m = assign == c
            if m.any():
                centers[c] = _majority_center(packed[m])
            else:  # re-seed an empty cluster on the farthest point
                centers[c] = packed[d.min(1).argmax()]
    return centers, assign


@dataclasses.dataclass
class Vocabulary:
    """Flattened complete k-ary binary vocabulary.

    levels[l]: (k**(l+1), 8) uint32 node descriptors of tree level l+1 (the
    root excluded); node j's children occupy rows [j*k, (j+1)*k) of the next
    level. Padded nodes carry valid False. Leaves are level `depth`; a word
    id is a leaf row. idf: (n_words,) tf-idf weights."""

    k: int
    depth: int
    levels: list  # of (n_l, 8) uint32 arrays
    valid: list   # of (n_l,) bool arrays
    idf: np.ndarray

    @property
    def n_words(self) -> int:
        return self.levels[-1].shape[0]

    def device_tensors(self, device):
        """(levels as int32 words, valid masks, idf float32) on `device`."""
        return ([torch.from_numpy(np.ascontiguousarray(lv).view(np.int32)).to(device)
                 for lv in self.levels],
                [torch.from_numpy(np.asarray(v, bool)).to(device) for v in self.valid],
                torch.from_numpy(np.asarray(self.idf, np.float32)).to(device))

    def words_np(self, packed: np.ndarray) -> np.ndarray:
        """Host descent of (N,8) uint32 descriptors -> (N,) word ids."""
        node = np.zeros(packed.shape[0], np.int64)
        for lv in range(self.depth):
            cand = node[:, None] * self.k + np.arange(self.k)
            d = _popcount_np(np.bitwise_xor(
                packed[:, None, :], self.levels[lv][cand])).sum(-1)
            d = np.where(self.valid[lv][cand], d, BIG)
            node = cand[np.arange(packed.shape[0]), d.argmin(1)]
        return node

    def save(self, path: str):
        np.savez_compressed(
            path, k=self.k, depth=self.depth, idf=self.idf,
            **{f"level_{i}": lv for i, lv in enumerate(self.levels)},
            **{f"valid_{i}": v for i, v in enumerate(self.valid)})

    @staticmethod
    def load(path: str) -> "Vocabulary":
        z = np.load(path)
        depth = int(z["depth"])
        return Vocabulary(k=int(z["k"]), depth=depth,
                          levels=[z[f"level_{i}"] for i in range(depth)],
                          valid=[z[f"valid_{i}"] for i in range(depth)],
                          idf=z["idf"])


def default_vocabulary_path() -> str:
    """The shipped 10^5-word vocabulary (the analog of ORB-SLAM3's
    `Vocabulary/ORBvoc.txt`), a data file of the JAX package's assets."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "orbslam3_tpu", "assets", "vocab_100k.npz")


def load_default_vocabulary() -> "Vocabulary | None":
    """The shipped vocabulary, or None if the file is absent."""
    p = default_vocabulary_path()
    return Vocabulary.load(p) if os.path.exists(p) else None


def build_vocabulary(packed: np.ndarray, k: int = 8, depth: int = 3,
                     seed: int = 0) -> Vocabulary:
    """Train a k^depth-word binary vocabulary (DBoW2 `create`) from (N, 8)
    uint32 descriptors; idf over the training set (`setNodeWeights`)."""
    rng = np.random.default_rng(seed)
    sentinel = np.full(DESC_WORDS, 0xFFFFFFFF, np.uint32)
    levels, valids = [], []
    groups = {0: np.arange(packed.shape[0])}  # node -> its descriptors
    for lv in range(depth):
        n_nodes = k ** (lv + 1)
        lvl = np.tile(sentinel, (n_nodes, 1))
        vld = np.zeros(n_nodes, bool)
        nxt = {}
        for parent, idx in groups.items():
            if idx.size == 0:
                continue
            centers, assign = _kmeans_binary(packed[idx], k, rng)
            for c in range(centers.shape[0]):
                node = parent * k + c
                lvl[node] = centers[c]
                vld[node] = True
                nxt[node] = idx[assign == c]
        levels.append(lvl)
        valids.append(vld)
        groups = nxt
    n_words = k ** depth
    counts = np.zeros(n_words, np.float64)
    for leaf, idx in groups.items():
        counts[leaf] = idx.size
    n_total = max(packed.shape[0], 1)
    idf = np.where(counts > 0, np.log(n_total / np.maximum(counts, 1)), 0.0)
    return Vocabulary(k=k, depth=depth, levels=levels, valid=valids,
                      idf=idf.astype(np.float32))


# -- device path ---------------------------------------------------------------

def descend(words: torch.Tensor, levels, valids, k: int) -> torch.Tensor:
    """Batched tree descent: (N, 8) int32 descriptor words -> (N,) int64 word
    ids, on the descriptors' device. Per level one (N, k, 8) gather, XOR,
    popcount and argmin; ties go to the lowest child, as DBoW2's strict
    `<` and `jnp.argmin` break them (distances are small integers, so ties
    happen)."""
    a = words.long()[:, None, :] & 0xFFFFFFFF
    node = torch.zeros(words.shape[0], dtype=torch.int64, device=words.device)
    offs = torch.arange(k, dtype=torch.int64, device=words.device)
    for lvl, vld in zip(levels, valids):
        cand = node[:, None] * k + offs                      # (N, k)
        child = lvl[cand].long() & 0xFFFFFFFF                 # (N, k, 8)
        d = _popcount32(a ^ child).sum(-1)
        d = torch.where(vld[cand], d, BIG)
        node = torch.gather(cand, 1, torch.argmin(d, dim=1, keepdim=True))[:, 0]
    return node


def bow_vector(words: torch.Tensor, valid: torch.Tensor, idf: torch.Tensor) -> torch.Tensor:
    """tf-idf L1-normalized dense BoW vector (n_words,): v_w = tf(w) idf(w),
    then v /= |v|_1 (DBoW2 TF_IDF + L1). The counts are sums of ones, exact
    in any order."""
    tf = torch.zeros(idf.shape[0], dtype=torch.float32, device=idf.device)
    tf = tf.index_put((words.long(),), valid.to(torch.float32), accumulate=True)
    v = tf * idf
    s = v.sum()
    return torch.where(s > 0, v / torch.where(s > 0, s, 1.0), v)


def l1_score(va: torch.Tensor, vb: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 scoring: 1 - 0.5 |va - vb|_1, in [0, 1]."""
    return 1.0 - 0.5 * torch.abs(va - vb).sum(-1)


def node_at_level(words, depth: int, k: int, level: int):
    """Ancestor node of each leaf word at `level` (DBoW2's FeatureVector
    grouping, which `SearchByBoW` buckets by)."""
    return words // (k ** (depth - level))
