"""Keyframe recognition database over BoW vectors (KeyFrameDatabase).

The reference package's ``runtime/keyframe_db.py``: the inverted index
word -> keyframes is a dense [K, W] matrix of L1-normalised tf-idf vectors
held on the host, so a query's shared-word count and L1 score against
every keyframe are one array operation each, and the covisibility-group
accumulation is a loop over the candidates.

Candidate filtering as the reference's:
- loop (DetectLoopCandidates, src/KeyFrameDatabase.cc:75-196): keyframes
  not connected to the query, more than 0.8 x the best shared-word count,
  a score of at least ``min_score``, a group score above 0.75 x the best;
- relocalization (DetectRelocalizationCandidates, :198-310): the same
  without the connection exclusion and the minimum score.
"""

from __future__ import annotations

from typing import List

import numpy as np

from eao_slam_torch.ops.bow import Vocabulary


def score_l1(db: np.ndarray, q: np.ndarray) -> np.ndarray:
    """``ops.bow.score_l1`` on host arrays: [K, W], [W] -> [K] float32."""
    return (1.0 - 0.5 * np.abs(db - q[None, :]).sum(1, dtype=np.float32)).astype(np.float32)


class KeyFrameDatabase:
    """Host-owned dense store of keyframe BoW vectors, indexed by slot."""

    def __init__(self, voc: Vocabulary, max_keyframes: int):
        self.voc = voc
        self.K = max_keyframes
        self.vectors = np.zeros((max_keyframes, voc.n_words), np.float32)
        self.present = np.zeros((max_keyframes,), bool)

    def add(self, slot: int, vec) -> None:
        self.vectors[slot] = np.asarray(vec)
        self.present[slot] = True

    def erase(self, slot: int) -> None:
        self.present[slot] = False
        self.vectors[slot] = 0.0

    def clear(self) -> None:
        self.present[:] = False
        self.vectors[:] = 0.0

    def _scores(self, q: np.ndarray):
        scores = score_l1(self.vectors, q)
        common = ((self.vectors > 0) & (q > 0)[None, :]).sum(1).astype(np.int32)
        scores[~self.present] = -1.0
        common[~self.present] = 0
        return scores, common

    def _group_accumulate(self, base: np.ndarray, cand_mask: np.ndarray, covis: np.ndarray,
                          top: int = 10):
        """Each candidate's score summed with those of its top covisible
        neighbours that are candidates too, and the group's best member
        (accScore / bestScore, :137-170). Returns (acc [K], best [K])."""
        acc = np.where(cand_mask, base, 0.0)
        best_member = np.arange(self.K)
        for i in np.flatnonzero(cand_mask):
            nb = np.argsort(-covis[i])[:top]
            nb = nb[(covis[i][nb] > 0) & cand_mask[nb]]
            if nb.size:
                acc[i] = base[i] + base[nb].sum()
                grp = np.concatenate([[i], nb])
                best_member[i] = grp[np.argmax(base[grp])]
        return acc, best_member

    def _select(self, scores, cand, covis) -> List[int]:
        acc, best_member = self._group_accumulate(scores, cand, covis)
        keep = cand & (acc > 0.75 * acc[cand].max())
        members = np.unique(best_member[keep])
        return sorted(members.tolist(), key=lambda s: -scores[s])

    def detect_loop_candidates(self, q: np.ndarray, covis_row: np.ndarray, covis: np.ndarray,
                               min_score: float, self_slot: int) -> List[int]:
        """Loop candidates of a keyframe with BoW vector ``q``:
        ``covis_row`` its covisibility weights [K] (connected keyframes are
        not candidates), ``covis`` the full [K, K] matrix. Each surviving
        group's best member, by score."""
        scores, common = self._scores(q)
        eligible = self.present & (covis_row <= 0)
        eligible[self_slot] = False
        if not eligible.any():
            return []
        max_common = common[eligible].max()
        if max_common == 0:
            return []
        cand = eligible & (common > 0.8 * max_common) & (scores >= min_score)
        if not cand.any():
            return []
        return self._select(scores, cand, covis)

    def detect_reloc_candidates(self, q: np.ndarray, covis: np.ndarray) -> List[int]:
        """Relocalization candidates of a frame with BoW vector ``q``."""
        scores, common = self._scores(q)
        if not self.present.any():
            return []
        max_common = common[self.present].max()
        if max_common == 0:
            return []
        cand = self.present & (common > 0.8 * max_common)
        return self._select(scores, cand, covis)
