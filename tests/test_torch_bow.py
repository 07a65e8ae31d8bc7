"""The port's vocabulary (``ops/bow.py``) and recognition database
(``runtime/keyframe_db.py``) against the reference package's.

Inputs: descriptor clusters made from a seed with numpy (the reference's
``tests/test_bow.py`` recipe), at the interactive tracker's geometry (k=10,
depth 3) and at the reference test's (k=4, depth 3), plus a tree with
duplicated centroids, where every descent ties.

Tolerances: vocabulary tables, idf weights, words, nodes, files,
masks and candidate lists exact; BoW vectors and L1 scores to 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eao_slam_torch.ops import bow as tb
from eao_slam_torch.runtime.keyframe_db import KeyFrameDatabase as TDB
from eao_slam_tpu.ops import bow as jb
from eao_slam_tpu.runtime.keyframe_db import KeyFrameDatabase as JDB
from torch_parity import n, t


def _clustered(rng, n_clusters=12, per_cluster=80, flip_bits=8):
    centers = rng.integers(0, 2 ** 32, (n_clusters, 8), dtype=np.uint32)
    out, labels = [], []
    for c in range(n_clusters):
        for _ in range(per_cluster):
            d = centers[c].copy()
            for _ in range(flip_bits):
                d[rng.integers(8)] ^= np.uint32(1) << np.uint32(rng.integers(32))
            out.append(d)
            labels.append(c)
    return np.stack(out), np.asarray(labels)


@pytest.fixture(scope="module", params=[(10, 3, 0), (4, 3, 1)], ids=["k10", "k4"])
def vocs(request):
    k, depth, seed = request.param
    rng = np.random.default_rng(seed)
    desc, labels = _clustered(rng, n_clusters=30 if k == 10 else 12)
    jv = jb.build_vocabulary(desc, k=k, depth=depth, seed=seed + 1)
    tv = tb.build_vocabulary(desc, k=k, depth=depth, seed=seed + 1)
    return jv, tv, desc, labels


def _tables(voc):
    return [n(x).view(np.uint32) for x in voc.levels]


def test_vocabulary_equal_element_for_element(vocs):
    jv, tv, desc, _ = vocs
    assert (tv.k, tv.depth, tv.n_words) == (jv.k, jv.depth, jv.n_words)
    for a, b in zip(_tables(tv), _tables(jv)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(n(tv.idf), n(jv.idf))
    # the int32 view the port's tracker trains from gives the same tree
    tv2 = tb.build_vocabulary(desc.view(np.int32), k=jv.k, depth=jv.depth,
                              seed=1 if jv.k == 10 else 2)
    for a, b in zip(_tables(tv2), _tables(jv)):
        np.testing.assert_array_equal(a, b)


def test_quantize_words_and_nodes_exact(vocs):
    jv, tv, desc, _ = vocs
    rng = np.random.default_rng(5)
    q = np.concatenate([desc, rng.integers(0, 2 ** 32, (200, 8), dtype=np.uint32)])
    for level in (1, 2):
        jw, jn = jb.quantize(jv, jnp.asarray(q), direct_level=level)
        tw, tn = tb.quantize(tv, t(q), direct_level=level)
        np.testing.assert_array_equal(n(tw), np.asarray(jw))
        np.testing.assert_array_equal(n(tn), np.asarray(jn))


def test_quantize_ties_take_the_first_child():
    """A tree whose children are duplicates: every descent ties, and both
    packages take the first child."""
    rng = np.random.default_rng(9)
    base = rng.integers(0, 2 ** 32, (2, 8), dtype=np.uint32)
    levels = [np.repeat(base[:1], 4, 0), np.tile(np.concatenate([base, base]), (4, 1))]
    idf = np.ones(16, np.float32)
    jv = jb.Vocabulary(levels=tuple(jnp.asarray(x) for x in levels), idf=jnp.asarray(idf))
    tv = tb.Vocabulary(levels=tuple(t(x) for x in levels), idf=t(idf))
    q = rng.integers(0, 2 ** 32, (64, 8), dtype=np.uint32)
    jw, jn = jb.quantize(jv, jnp.asarray(q), direct_level=1)
    tw, tn = tb.quantize(tv, t(q), direct_level=1)
    np.testing.assert_array_equal(n(tw), np.asarray(jw))
    np.testing.assert_array_equal(n(tn), np.asarray(jn))
    assert (np.asarray(jn) == 0).all()


def test_bow_vector_and_scores(vocs):
    jv, tv, desc, labels = vocs
    rng = np.random.default_rng(3)
    vecs_j, vecs_t = [], []
    for group in (labels < 4, labels >= 8, labels % 3 == 0):
        d = desc[group]
        valid = rng.random(len(d)) < 0.9
        jw, _ = jb.quantize(jv, jnp.asarray(d))
        tw, _ = tb.quantize(tv, t(d))
        vj = np.asarray(jb.bow_vector(jv, jw, jnp.asarray(valid)))
        vt = n(tb.bow_vector(tv, tw, t(valid)))
        np.testing.assert_allclose(vt, vj, atol=1e-6)
        vecs_j.append(vj)
        vecs_t.append(vt)
    db_j, db_t = np.stack(vecs_j), np.stack(vecs_t)
    for q_j, q_t in zip(vecs_j, vecs_t):
        np.testing.assert_allclose(n(tb.score_l1(t(db_t), t(q_t))),
                                   np.asarray(jb.score_l1(jnp.asarray(db_j), jnp.asarray(q_j))),
                                   atol=1e-6)
        np.testing.assert_array_equal(
            n(tb.common_words(t(db_t > 0), t(q_t))),
            np.asarray(jb.common_words(jnp.asarray(db_j > 0), jnp.asarray(q_j))))


def test_files_byte_equal_and_cross_loading(vocs, tmp_path):
    jv, tv, desc, _ = vocs
    for ext, save_j, save_t in ((".npz", jb.save_vocabulary, tb.save_vocabulary),
                                (".txt", jb.save_vocabulary_text, tb.save_vocabulary_text)):
        pj, pt = str(tmp_path / f"ref{ext}"), str(tmp_path / f"port{ext}")
        save_j(pj, jv)
        save_t(pt, tv)
        if ext == ".txt":
            assert open(pj, "rb").read() == open(pt, "rb").read()
        else:
            zj, zt = np.load(pj), np.load(pt)
            assert sorted(zj.files) == sorted(zt.files)
            for f in zj.files:
                assert zj[f].dtype == zt[f].dtype
                np.testing.assert_array_equal(zj[f], zt[f])
        # the reference's file loads in the port and quantizes alike
        lv = tb.load_vocabulary(pj)
        for a, b in zip(_tables(lv), _tables(jv)):
            np.testing.assert_array_equal(a, b)
        jw, _ = jb.quantize(jb.load_vocabulary(pt), jnp.asarray(desc[:64]))
        tw, _ = tb.quantize(lv, t(desc[:64]))
        np.testing.assert_array_equal(n(tw), np.asarray(jw))
        if ext == ".txt":
            np.testing.assert_allclose(n(lv.idf), np.asarray(jb.load_vocabulary(pj).idf), rtol=0)


def test_bow_match_mask_exact():
    rng = np.random.default_rng(4)
    na, nb = rng.integers(0, 6, 40), rng.integers(0, 6, 30)
    np.testing.assert_array_equal(n(tb.bow_match_mask(t(na), t(nb))),
                                  np.asarray(jb.bow_match_mask(jnp.asarray(na), jnp.asarray(nb))))


def test_keyframe_database_candidates_equal(vocs):
    """Reloc and loop candidates as lists, on a database with a revisited
    place, after add and after erase."""
    jv, tv, desc, labels = vocs
    rng = np.random.default_rng(11)
    K = 16
    jdb, tdb = JDB(jv, K), TDB(tv, K)
    views = {i: [i % 10, (i + 1) % 10] for i in range(12)}
    views[8] = views[3]
    views[11] = views[3]

    def vec(which):
        idx = rng.choice(np.flatnonzero(np.isin(labels, which)), 60, replace=False)
        jw, _ = jb.quantize(jv, jnp.asarray(desc[idx]))
        return np.asarray(jb.bow_vector(jv, jw, jnp.ones(60, bool)))

    for i in range(12):
        v = vec(views[i])
        jdb.add(i, v)
        tdb.add(i, v)
    covis = np.zeros((K, K), np.int64)
    for i in range(11):
        covis[i, i + 1] = covis[i + 1, i] = 40
    covis[3, 4] = covis[4, 3] = 0

    def check(q):
        assert tdb.detect_reloc_candidates(q, covis) == jdb.detect_reloc_candidates(q, covis)
        for s in (8, 11):
            for min_score in (0.05, 0.2):
                args = (jdb.vectors[s], covis[s], covis, min_score, s)
                assert tdb.detect_loop_candidates(*args) == jdb.detect_loop_candidates(*args)

    q = vec(views[3])
    check(q)
    assert 3 in jdb.detect_loop_candidates(jdb.vectors[8], covis[8], covis, 0.05, 8)
    for s in (3, 5):
        jdb.erase(s)
        tdb.erase(s)
        check(q)
    np.testing.assert_array_equal(tdb.present, jdb.present)
    np.testing.assert_array_equal(tdb.vectors, jdb.vectors)
    jdb.clear()
    tdb.clear()
    assert tdb.detect_reloc_candidates(q, covis) == jdb.detect_reloc_candidates(q, covis) == []
