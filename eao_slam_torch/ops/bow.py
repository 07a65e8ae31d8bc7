"""Hierarchical bag-of-binary-words vocabulary (the DBoW2 equivalent of the
interactive tracker's place recognition).

The reference package's ``ops/bow.py``: the k-ary vocabulary tree is one
centroid table per level in an implicit complete-tree layout (the children
of group g at level l are rows g*k .. g*k+k-1), so quantizing a frame's
descriptors is L rounds of gather the group's k children, XOR + popcount,
first minimum, descend.

- ``build_vocabulary``: hierarchical binary k-medians with majority-bit
  means and tf-idf weights, in numpy with numpy's generator, as the
  reference trains it: the same descriptors and seed give the same tables,
  element for element;
- ``save_vocabulary`` / ``load_vocabulary`` (npz) and the DBoW2 text
  format (``load_vocabulary_text`` / ``save_vocabulary_text``);
- ``quantize`` (word and direct-index node per descriptor), ``bow_vector``
  (L1-normalised tf-idf histogram), ``score_l1``, ``common_words`` and
  ``bow_match_mask``, on tensors.

Descriptors are [N, 8] int32 holding the uint32 bit pattern on the tensor
side and uint32 on the numpy side; ``Vocabulary.levels`` are int32 tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch


class Vocabulary(NamedTuple):
    """Implicit complete k-ary tree: ``levels[l]`` [k^(l+1), 8] int32
    centroids, ``idf`` [k^L] float32 word weights. Branching factor and
    depth follow from the shapes."""

    levels: Sequence[torch.Tensor]
    idf: torch.Tensor

    @property
    def k(self) -> int:
        return int(self.levels[0].shape[0])

    @property
    def depth(self) -> int:
        return len(self.levels)

    @property
    def n_words(self) -> int:
        return int(self.levels[-1].shape[0])

    def to(self, device) -> "Vocabulary":
        return Vocabulary(tuple(t.to(device) for t in self.levels), self.idf.to(device))


def _vocabulary(levels, idf, device=None) -> Vocabulary:
    """A Vocabulary from uint32 numpy tables and float32 weights."""
    return Vocabulary(
        levels=tuple(torch.as_tensor(np.ascontiguousarray(np.asarray(t, np.uint32)).view(np.int32),
                                     device=device) for t in levels),
        idf=torch.as_tensor(np.asarray(idf, np.float32), device=device))


def _tables_numpy(voc: Vocabulary):
    return [t.cpu().numpy().view(np.uint32) for t in voc.levels]


# ---------------------------------------------------------------------------
# training (host numpy, offline in the reference)
# ---------------------------------------------------------------------------

def _np_hamming(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N, 8] u32 x [M, 8] u32 -> [N, M] popcount(xor)."""
    x = a[:, None, :] ^ b[None, :, :]
    x = x.view(np.uint8).reshape(a.shape[0], b.shape[0], 32)
    return np.unpackbits(x, axis=2).sum(axis=2).astype(np.int32)


def _np_mean_descriptor(desc: np.ndarray) -> np.ndarray:
    """Majority vote per bit (FORB::meanValue): a bit is set iff more than
    half of the cluster's descriptors set it."""
    bits = np.unpackbits(desc.view(np.uint8), axis=1)
    maj = (bits.sum(axis=0) * 2 > desc.shape[0]).astype(np.uint8)
    return np.packbits(maj).view(np.uint32).copy()


def _kmedians(desc: np.ndarray, k: int, rng: np.random.Generator, iters: int = 8):
    """Binary k-medians: hamming assignment and majority-bit means, seeded
    k-means++ style on hamming distance. Returns (centroids [k, 8],
    assignment [N])."""
    n = desc.shape[0]
    if n == 0:
        return np.zeros((k, 8), np.uint32), np.zeros((0,), np.int64)
    first = int(rng.integers(n))
    cent = [desc[first]]
    d = _np_hamming(desc, desc[first:first + 1])[:, 0].astype(np.float64)
    for _ in range(1, min(k, n)):
        p = d * d
        s = p.sum()
        j = int(rng.integers(n)) if s <= 0 else int(rng.choice(n, p=p / s))
        cent.append(desc[j])
        d = np.minimum(d, _np_hamming(desc, desc[j:j + 1])[:, 0])
    while len(cent) < k:           # degenerate cluster: duplicate seed 0
        cent.append(cent[0])
    C = np.stack(cent)
    for _ in range(iters):
        assign = _np_hamming(desc, C).argmin(axis=1)
        newC = C.copy()
        for j in range(k):
            m = assign == j
            if m.any():
                newC[j] = _np_mean_descriptor(desc[m])
        if (newC == C).all():
            break
        C = newC
    return C, _np_hamming(desc, C).argmin(axis=1)


def build_vocabulary(descriptors: np.ndarray, k: int = 10, depth: int = 4,
                     seed: int = 12345, max_train: int = 60_000, device=None) -> Vocabulary:
    """Train the k^depth-word tree on [..., 8] descriptors (uint32, or
    int32 with the same bits) (TemplatedVocabulary::create). Deterministic
    for a seed; idf over documents of 500 consecutive descriptors, 0 for
    unseen words."""
    rng = np.random.default_rng(seed)
    desc = np.ascontiguousarray(np.asarray(descriptors)).view(np.uint32).reshape(-1, 8)
    if desc.shape[0] > max_train:
        desc = desc[rng.choice(desc.shape[0], max_train, replace=False)]
    levels = []
    groups = np.zeros((desc.shape[0],), np.int64)
    for lvl in range(depth):
        n_groups = k ** lvl
        table = np.zeros((n_groups * k, 8), np.uint32)
        new_groups = np.zeros_like(groups)
        for g in range(n_groups):
            m = groups == g
            C, assign = _kmedians(desc[m], k, rng)
            table[g * k:(g + 1) * k] = C
            new_groups[m] = g * k + assign
        levels.append(table)
        groups = new_groups
    n_words = k ** depth
    doc = np.arange(desc.shape[0]) // 500
    n_docs = int(doc.max()) + 1 if desc.shape[0] else 1
    seen = np.zeros((n_words,), np.int64)
    for d in range(n_docs):
        seen[np.unique(groups[doc == d])] += 1
    idf = np.log(n_docs / np.maximum(seen, 1)).astype(np.float32)
    idf[seen == 0] = 0.0
    return _vocabulary(levels, idf, device)


def save_vocabulary(path: str, voc: Vocabulary) -> None:
    """The reference's npz layout: ``depth``, ``idf``, ``level{l}`` (uint32)."""
    np.savez_compressed(path, depth=voc.depth, idf=voc.idf.cpu().numpy(),
                        **{f"level{l}": t for l, t in enumerate(_tables_numpy(voc))})


def load_vocabulary(path: str, device=None) -> Vocabulary:
    """An npz vocabulary, or a DBoW2 text file (``.txt``)."""
    if path.endswith(".txt"):
        return load_vocabulary_text(path, device)
    z = np.load(path)
    depth = int(z["depth"])
    return _vocabulary([z[f"level{l}"] for l in range(depth)], z["idf"], device)


def load_vocabulary_text(path: str, device=None) -> Vocabulary:
    """A DBoW2 text-format ORB vocabulary (TemplatedVocabulary::
    loadFromTextFile): header ``k L scoring weighting``, then one node a
    line, ``parent is_leaf b0 .. b31 weight``. Nodes are laid into the
    implicit complete tree: an under-full node's missing children repeat
    its first child, and an early leaf repeats down to depth L, so word
    ids are a permutation of DBoW2's (scoring and bucketing do not see
    the permutation)."""
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        parents, descs, weights = [], [], []
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            parents.append(int(parts[0]))
            descs.append(np.array([int(x) for x in parts[2:34]], np.uint8))
            weights.append(float(parts[34]))
    desc = (np.ascontiguousarray(np.stack(descs)).view(np.uint32)
            if parents else np.zeros((0, 8), np.uint32))
    weights = np.asarray(weights, np.float32)
    children: dict = {}
    for nid1, pid in enumerate(parents):
        children.setdefault(pid, []).append(nid1 + 1)     # file ids start at 1
    levels = []
    idf = np.zeros((k ** L,), np.float32)
    frontier = [0]                                        # root: file node 0
    for lvl in range(L):
        table = np.zeros((len(frontier) * k, 8), np.uint32)
        nxt = []
        for g, nid in enumerate(frontier):
            ch = children.get(nid, []) if nid >= 0 else []
            if not ch and nid >= 1:
                ch = [nid]                                # early leaf: repeat it
            for c in range(k):
                node = ch[c] if c < len(ch) else (ch[0] if ch else -1)
                real = c < max(len(ch), 1) and node >= 1
                if node >= 1:
                    table[g * k + c] = desc[node - 1]
                nxt.append(node if real else -1)
                if lvl == L - 1 and real:
                    idf[g * k + c] = weights[node - 1]
        levels.append(table)
        frontier = nxt
    return _vocabulary(levels, idf, device)


def save_vocabulary_text(path: str, voc: Vocabulary) -> None:
    """The DBoW2 text format (the inverse of ``load_vocabulary_text``):
    nodes breadth first, 1-based ids in emit order, interior weights 0."""
    k, L = voc.k, voc.depth
    idf = voc.idf.cpu().numpy()
    tables = _tables_numpy(voc)
    lines = [f"{k} {L} 0 0\n"]     # scoring L1_NORM = 0, weighting TF_IDF = 0
    offsets = [0]
    for t in tables:
        offsets.append(offsets[-1] + int(t.shape[0]))
    for lvl, t in enumerate(tables):
        bytes_ = t.view(np.uint8).reshape(t.shape[0], 32)
        for row in range(t.shape[0]):
            pid = 0 if lvl == 0 else offsets[lvl - 1] + row // k + 1
            is_leaf = 1 if lvl == L - 1 else 0
            w = float(idf[row]) if lvl == L - 1 else 0.0
            ds = " ".join(str(int(b)) for b in bytes_[row])
            lines.append(f"{pid} {is_leaf} {ds} {w}\n")
    with open(path, "w") as f:
        f.writelines(lines)


# ---------------------------------------------------------------------------
# quantization and scoring (tensors)
# ---------------------------------------------------------------------------

_M1 = 0x5555555555555555
_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F


def _popcount64(v: torch.Tensor) -> torch.Tensor:
    """Population count of int64 bit patterns (SWAR; the masks drop the
    bits an arithmetic right shift smears in)."""
    v = v - ((v >> 1) & _M1)
    v = (v & _M2) + ((v >> 2) & _M2)
    v = (v + (v >> 4)) & _M4
    v = v + (v >> 8)
    v = v + (v >> 16)
    v = v + (v >> 32)
    return v & 0x7F


def quantize(voc: Vocabulary, desc: torch.Tensor, direct_level: int = 2):
    """Descend the tree for every descriptor: desc [F, 8] int32 ->
    (word [F] int64 in [0, k^L), node [F] int64, the group id at
    ``direct_level``: the FeatureVector direct index that buckets
    SearchByBoW). Ties between children go to the first child, as
    ``jnp.argmin`` takes them, on every device (a packed-key minimum)."""
    k = voc.k
    d64 = desc.contiguous().view(torch.int64)                     # [F, 4]
    j = torch.arange(k, device=desc.device)
    g = torch.zeros(desc.shape[0], dtype=torch.int64, device=desc.device)
    node = g
    for lvl, table in enumerate(voc.levels):
        child = table.contiguous().view(torch.int64)[g[:, None] * k + j[None, :]]  # [F, k, 4]
        d = _popcount64(child ^ d64[:, None, :]).sum(-1)          # [F, k]
        g = g * k + (d * k + j[None, :]).amin(1) % k
        if lvl + 1 == direct_level:
            node = g
    return g, node


def bow_vector(voc: Vocabulary, word: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """L1-normalised tf-idf histogram [n_words] (BowVector +
    Frame::ComputeBoW). Term counts are integers, so the scatter's order
    cannot move them."""
    counts = torch.zeros(voc.n_words, dtype=torch.int32, device=word.device)
    counts = counts.index_add_(0, word.long(), valid.to(torch.int32))
    v = counts.to(torch.float32) * voc.idf
    return v / torch.clamp(v.abs().sum(), min=1e-9)


def score_l1(db: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """DBoW2's L1 score of q against every row of db: 1 - 0.5 |a - b|_1
    (in [0, 1] for L1-normalised vectors). db [K, W], q [W] -> [K]."""
    return 1.0 - 0.5 * (db - q[None, :]).abs().sum(1)


def common_words(db_nonzero: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Words shared with every database row (the inverted file's count,
    KeyFrameDatabase.cc:75-117): [K, W] bool, [W] -> [K] int32."""
    return (db_nonzero & (q > 0)[None, :]).sum(1).to(torch.int32)


def bow_match_mask(node_a: torch.Tensor, node_b: torch.Tensor) -> torch.Tensor:
    """[Na] x [Nb] -> [Na, Nb] bool: features may match only inside one
    direct-index node (ORBmatcher::SearchByBoW's bucket rule)."""
    return node_a[:, None] == node_b[None, :]
