"""Keyframe database: place-recognition queries over sparse BoW vectors.

Port of `orbslam3_tpu/place/database.py` (ORB-SLAM3's `KeyFrameDatabase`).
DBoW2's inverted file becomes a sparse per-keyframe word table, (rows, F)
word ids and tf-idf weights with F words a keyframe, kept on `device`:
a keyframe's row is written when it is added or erased, never the whole
table. A query densifies only its own vector over the vocabulary, on the
device, and one (rows, F) gather + two row reductions give every row's
shared-word count and L1 score:
1 - 0.5 |a - b|_1 = sum over common words of (a + b - |a - b|) / 2.

Queries:
- `detect_relocalization_candidates` (`DetectRelocalizationCandidates`):
  shared words >= 0.8 max, score, accumulate over covisibility groups,
  keep the groups within 0.75 of the best;
- `detect_n_best_candidates` (`DetectNBestCandidates`, loops and merges):
  the same without the query keyframe's covisible set, the top N group
  leaders.

Rows are keyed by (map id, keyframe slot): the Atlas's maps reuse slot
numbers, and culled slots are reused, so a row is freed when its keyframe
is erased (`KeyFrame::SetBadFlag`) or its map cleared.
"""

from __future__ import annotations

import inspect
from typing import NamedTuple

import numpy as np
import torch

from orbslam3_tpu_torch import device as device_policy
from orbslam3_tpu_torch.place.vocab import Vocabulary, descend


class BowVec(NamedTuple):
    """Sparse tf-idf BoW vector: unique word ids + L1-normalized weights."""

    words: np.ndarray    # (F,) int64, -1 padding
    weights: np.ndarray  # (F,) float32


def _as_words(desc) -> torch.Tensor:
    """(N, 8) uint32 numpy or int32 tensor -> int32 words tensor."""
    if isinstance(desc, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(desc).view(np.int32))
    return desc


class KeyFrameDatabase:
    """The inverted index of a session: rows on `device`, bookkeeping on
    the host."""

    def __init__(self, vocab: Vocabulary, max_keyframes: int = 512,
                 words_per_frame: int = 1024, device=None):
        self.vocab = vocab
        self.device = device_policy.resolve(device)
        self._levels, self._valids, self._idf = vocab.device_tensors(self.device)
        self._idf_np = np.asarray(vocab.idf, np.float32)
        M, F = max_keyframes, words_per_frame
        self.F = F
        self.kf_words = torch.full((M, F), -1, dtype=torch.int32, device=self.device)
        self.kf_weights = torch.zeros((M, F), dtype=torch.float32, device=self.device)
        self.active = np.zeros(M, bool)
        self.map_of = np.full(M, -1, np.int64)      # owning map id
        self.slot_of = np.full(M, -1, np.int64)     # keyframe slot in its map
        self._row: dict[tuple[int, int], int] = {}  # (map_id, slot) -> row
        self._free: list[int] = []
        self._next_row = 0

    # -- ingestion -------------------------------------------------------------
    def _sparse_bow(self, words: np.ndarray, valid: np.ndarray) -> BowVec:
        uniq, counts = np.unique(words[valid], return_counts=True)
        tfidf = counts.astype(np.float32) * self._idf_np[uniq]
        n1 = tfidf.sum()
        if n1 > 0:
            tfidf = tfidf / n1
        out_w = np.full(self.F, -1, np.int64)
        out_x = np.zeros(self.F, np.float32)
        n = min(len(uniq), self.F)
        out_w[:n] = uniq[:n]
        out_x[:n] = tfidf[:n]
        return BowVec(out_w, out_x)

    def words(self, desc) -> torch.Tensor:
        """(N, 8) descriptors -> (N,) word ids on the device."""
        return descend(_as_words(desc).to(self.device), self._levels, self._valids,
                       self.vocab.k)

    def compute_bow(self, desc, valid):
        """(N,8) descriptors + (N,) valid -> (per-feature words, BowVec)."""
        words = self.words(desc).cpu().numpy()
        valid = valid.cpu().numpy() if isinstance(valid, torch.Tensor) else valid
        return words, self._sparse_bow(words, np.asarray(valid, bool))

    def ensure_capacity(self, n_rows: int):
        """Double the row store until row n_rows - 1 fits."""
        M = len(self.active)
        if n_rows <= M:
            return
        new = M
        while new < n_rows:
            new *= 2
        pad = new - M
        self.kf_words = torch.cat([self.kf_words, torch.full(
            (pad, self.F), -1, dtype=torch.int32, device=self.device)])
        self.kf_weights = torch.cat([self.kf_weights, torch.zeros(
            (pad, self.F), dtype=torch.float32, device=self.device)])
        self.active = np.concatenate([self.active, np.zeros(pad, bool)])
        self.map_of = np.concatenate([self.map_of, np.full(pad, -1, np.int64)])
        self.slot_of = np.concatenate([self.slot_of, np.full(pad, -1, np.int64)])

    def _alloc_row(self, key: tuple[int, int]) -> int:
        r = self._row.get(key)
        if r is not None:
            return r
        if self._free:
            r = self._free.pop()
        else:
            r = self._next_row
            self._next_row += 1
        self.ensure_capacity(r + 1)
        self._row[key] = r
        return r

    def add(self, kf: int, bow: BowVec, map_id: int = 0):
        r = self._alloc_row((int(map_id), int(kf)))
        self.kf_words[r] = torch.from_numpy(bow.words.astype(np.int32)).to(self.device)
        self.kf_weights[r] = torch.from_numpy(bow.weights).to(self.device)
        self.active[r] = True
        self.map_of[r] = map_id
        self.slot_of[r] = kf

    def erase(self, kf: int, map_id: int = 0):
        """A culled keyframe's erase: its reused slot must not serve stale
        retrievals."""
        r = self._row.pop((int(map_id), int(kf)), None)
        if r is None:
            return
        self.active[r] = False
        self.kf_words[r] = -1
        self.kf_weights[r] = 0
        self.map_of[r] = -1
        self.slot_of[r] = -1
        self._free.append(r)

    def clear_map(self, map_id: int):
        for (mid, slot) in [k for k in self._row if k[0] == int(map_id)]:
            self.erase(slot, map_id=mid)

    def row_for(self, kf: int, map_id: int = 0):
        return self._row.get((int(map_id), int(kf)))

    # -- queries ---------------------------------------------------------------
    def _scores(self, query: BowVec, candidate_mask: np.ndarray):
        """Shared-word counts and L1 scores of every row against the query,
        on the device; rows outside `active & candidate_mask` get 0 and -1."""
        W = self.vocab.n_words
        sel = query.words >= 0
        qi = torch.from_numpy(query.words[sel]).to(self.device)
        qw = torch.zeros(W + 1, dtype=torch.float32, device=self.device)  # W: padding
        qw[qi] = torch.from_numpy(query.weights[sel]).to(self.device)
        qp = torch.zeros(W + 1, dtype=torch.bool, device=self.device)
        qp[qi] = True
        idx = torch.where(self.kf_words >= 0, self.kf_words, W).long()
        a = qw[idx]
        b = self.kf_weights
        present = (self.kf_words >= 0) & (a > 0)
        shared = (present & qp[idx]).sum(dim=1).to(torch.float32)
        score = torch.where(present, a + b - torch.abs(a - b), 0.0).sum(dim=1) * 0.5
        shared, score = shared.cpu().numpy(), score.cpu().numpy()
        mask = self.active & candidate_mask
        shared[~mask] = 0
        score[~mask] = -1.0
        return shared, score

    def _group_accumulate(self, scores: np.ndarray, cands: np.ndarray, covis_fn,
                          ratio: float):
        """Covisibility-group accumulation (KeyFrameDatabase.cc): each
        candidate's score summed with its covisible neighbours that are also
        candidates; a group is represented by its best member; groups within
        `ratio` of the best accumulated score, best first, leaders once."""
        n = len(cands)
        if n == 0:
            return np.zeros(0, np.int64)
        local = {int(c): i for i, c in enumerate(cands)}
        member = np.eye(n, dtype=bool)
        for i, c in enumerate(cands):
            for nb in covis_fn(int(c)):
                j = local.get(int(nb))
                if j is not None:
                    member[i, j] = True
        s = scores[cands]
        acc = member @ s
        leader = cands[np.where(member, s[None, :], -np.inf).argmax(axis=1)]
        best_acc = acc.max()
        out, seen = [], set()
        for i in np.argsort(-acc, kind="stable"):
            if acc[i] < ratio * best_acc:
                break
            L = int(leader[i])
            if L not in seen:
                seen.add(L)
                out.append(L)
        return np.asarray(out, np.int64)

    def _row_covis(self, covis_fn):
        """Lift a slot-level covisibility function, `covis_fn(slot)` or
        `covis_fn(map_id, slot)`, to database rows of the same map; slots
        without a row are dropped."""
        two_arg = len(inspect.signature(covis_fn).parameters) >= 2

        def rows_of(r):
            mid, slot = int(self.map_of[r]), int(self.slot_of[r])
            neigh = covis_fn(mid, slot) if two_arg else covis_fn(slot)
            return [nr for nr in (self._row.get((mid, int(ns))) for ns in neigh)
                    if nr is not None]
        return rows_of

    def _candidates(self, query: BowVec, cmask: np.ndarray) -> tuple:
        shared, score = self._scores(query, cmask)
        if shared.max() <= 0:
            return score, np.zeros(0, np.int64)
        min_common = 0.8 * shared.max()
        return score, np.nonzero((shared >= max(min_common, 1)) & (score > -1))[0]

    def detect_relocalization_candidates(self, query: BowVec, covis_fn,
                                         map_id: int | None = None):
        """Relocalization candidates: keyframe slots of `map_id`."""
        cmask = np.ones_like(self.active) if map_id is None else (self.map_of == map_id)
        cmask &= self.active
        score, cands = self._candidates(query, cmask)
        if cands.size == 0:
            return np.zeros(0, np.int64)
        rows = self._group_accumulate(score, cands, self._row_covis(covis_fn), ratio=0.75)
        return self.slot_of[rows]

    def detect_n_best_candidates(self, query: BowVec, exclude: set[int], covis_fn,
                                 n_best: int = 3, exclude_map_id: int = 0):
        """Top-N loop / merge candidates, without the query keyframe's
        covisible set (`exclude`: slots of `exclude_map_id`). Returns
        [(map_id, slot), ...]."""
        cmask = self.active.copy()
        for e in exclude:
            r = self._row.get((int(exclude_map_id), int(e)))
            if r is not None:
                cmask[r] = False
        score, cands = self._candidates(query, cmask)
        if cands.size == 0:
            return []
        leaders = self._group_accumulate(score, cands, self._row_covis(covis_fn), ratio=0.0)
        return [(int(self.map_of[r]), int(self.slot_of[r])) for r in leaders[:n_best]]
