"""Parity of the port's matching with eao_slam_tpu.ops.matching: every
output is an integer or a mask, so everything is bit-exact.

Trouble spot named here: popcount. PyTorch has no uint32 popcount; the
port XORs the descriptors viewed as four int64 words and counts bits with
a SWAR bit-twiddle. Packed-key mins use int32 shifts as the reference
does."""

import jax.numpy as jnp
import numpy as np
import pytest

from eao_slam_tpu.ops import matching as jm
from eao_slam_torch.ops import matching as tm
from torch_parity import flip_bits, n, random_descriptors, t


@pytest.fixture
def data():
    rng = np.random.default_rng(0)
    N, M = 300, 260
    a = random_descriptors(rng, N)
    b = flip_bits(rng, a[rng.integers(0, N, M)], 0.08)
    kp1 = rng.uniform(0, 640, (N, 2)).astype(np.float32)
    kp2 = (kp1[rng.integers(0, N, M)] + rng.normal(0, 5, (M, 2))).astype(np.float32)
    ang1 = rng.uniform(-3, 3, N).astype(np.float32)
    ang2 = rng.uniform(-3, 3, M).astype(np.float32)
    oct1 = rng.integers(0, 8, N).astype(np.int32)
    oct2 = rng.integers(0, 8, M).astype(np.int32)
    v1 = rng.random(N) < 0.9
    v2 = rng.random(M) < 0.9
    return dict(a=a, b=b, kp1=kp1, kp2=kp2, ang1=ang1, ang2=ang2, oct1=oct1, oct2=oct2, v1=v1, v2=v2)


def eq(x, y):
    for u, w in zip(x, y):
        np.testing.assert_array_equal(n(u), np.asarray(w))


def test_hamming_and_nn(data):
    dj = np.asarray(jm.hamming_matrix(jnp.asarray(data["a"]), jnp.asarray(data["b"])))
    dt = n(tm.hamming_matrix(t(data["a"]), t(data["b"])))
    np.testing.assert_array_equal(dt, dj)
    mask = np.random.default_rng(1).random(dj.shape) < 0.5
    eq(tm.best_two(t(dj), t(mask)), jm.best_two(jnp.asarray(dj), jnp.asarray(mask)))
    for mutual in (False, True):
        rj = jm.match_nn(jnp.asarray(dj), jnp.asarray(mask), 100, 0.9, mutual)
        rt = tm.match_nn(t(dj), t(mask), 100, 0.9, mutual)
        eq(rt, rj)
        keep_j = jm.resolve_duplicate_cols(rj[0], rj[1], rj[2], dj.shape[1])
        keep_t = tm.resolve_duplicate_cols(rt[0], rt[1], rt[2], dj.shape[1])
        np.testing.assert_array_equal(n(keep_t), np.asarray(keep_j))
        okj = jm.rotation_consistency(jnp.asarray(data["ang1"]), jnp.asarray(data["ang2"]), rj[0], rj[2])
        okt = tm.rotation_consistency(t(data["ang1"]), t(data["ang2"]), rt[0], rt[2])
        np.testing.assert_array_equal(n(okt), np.asarray(okj))


def test_search_regimes(data):
    d = data
    J = {k: jnp.asarray(v) for k, v in d.items()}
    T = {k: t(v) for k, v in d.items()}
    rad = np.full(len(d["a"]), 20.0, np.float32)
    eq(tm.search_by_projection(T["kp1"], T["oct1"], T["a"], T["v1"], T["kp2"], T["oct2"], T["b"],
                               T["v2"], t(rad), query_angle=T["ang1"], kp_angle=T["ang2"],
                               check_rotation=True),
       jm.search_by_projection(J["kp1"], J["oct1"], J["a"], J["v1"], J["kp2"], J["oct2"], J["b"],
                               J["v2"], jnp.asarray(rad), query_angle=J["ang1"],
                               kp_angle=J["ang2"], check_rotation=True))
    eq(tm.search_for_initialization(T["kp1"], T["a"], T["ang1"], T["v1"], T["kp2"], T["b"],
                                    T["ang2"], T["v2"]),
       jm.search_for_initialization(J["kp1"], J["a"], J["ang1"], J["v1"], J["kp2"], J["b"],
                                    J["ang2"], J["v2"]))
    eq(tm.search_brute(T["a"], T["v1"], T["b"], T["v2"]),
       jm.search_brute(J["a"], J["v1"], J["b"], J["v2"]))
    K = np.array([[535.4, 0, 320.1], [0, 539.2, 247.6], [0, 0, 1]], np.float32)
    T1 = np.eye(3, 4, dtype=np.float32)
    T2 = np.eye(3, 4, dtype=np.float32)
    T2[:, 3] = [0.3, 0.02, 0.01]
    Fj = jm.fundamental_from_poses(jnp.asarray(K), jnp.asarray(T1), jnp.asarray(T2))
    Ft = tm.fundamental_from_poses(t(K), t(T1), t(T2))
    np.testing.assert_allclose(n(Ft), np.asarray(Fj), rtol=1e-5, atol=1e-9)
    s2 = (1.2 ** (2 * np.arange(8))).astype(np.float32)
    epi = np.array([900.0, 250.0], np.float32)
    min_epi = 100.0 * s2[d["oct2"]]
    eq(tm.search_for_triangulation(T["kp1"], T["a"], T["oct1"], T["v1"], T["kp2"], T["b"], T["oct2"],
                                   T["v2"], t(np.asarray(Fj)), t(s2), t(epi), t(min_epi)),
       jm.search_for_triangulation(J["kp1"], J["a"], J["oct1"], J["v1"], J["kp2"], J["b"], J["oct2"],
                                   J["v2"], Fj, jnp.asarray(s2), jnp.asarray(epi),
                                   jnp.asarray(min_epi)))
