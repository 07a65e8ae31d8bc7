"""Parity of the port's essential-graph optimization
(``solvers/pose_graph``) with the reference package's: 1e-3 on the
vertices (a 7K-dimensional dense solve over 20 damped steps), the fixed
and the invalid vertices untouched, edge residuals to 1e-5."""

import jax.numpy as jnp
import numpy as np

from eao_slam_tpu.geometry import sim3 as jsim3, so3 as jso3
from eao_slam_tpu.solvers import pose_graph as jpg
from eao_slam_torch.solvers import pose_graph as tpg
from torch_parity import n, t


def _drifted_chain(rng, K=12):
    """An odometry chain with injected drift and scale creep, a loop edge
    to the start and a few covisibility edges (the essential graph's three
    kinds of edges), in a capacity of K + 4 vertices (4 invalid)."""
    cap = K + 4
    true = []
    for k in range(K):
        ang = 2 * np.pi * k / K
        R = np.asarray(jso3.exp(jnp.asarray([0.0, ang, 0.0], jnp.float32)))
        tr = np.asarray([np.cos(ang), 0.0, np.sin(ang)], np.float32)
        true.append(np.asarray(jsim3.make(jnp.asarray(R), jnp.asarray(tr), jnp.asarray(1.0))))
    true = np.stack(true)
    est = [true[0]]
    for k in range(K - 1):
        rel = jsim3.compose(jnp.asarray(true[k + 1]), jsim3.inverse(jnp.asarray(true[k])))
        noise = jnp.asarray(np.concatenate([rng.normal(0, 0.02, 6), [0.02]]), jnp.float32)
        est.append(np.asarray(jsim3.compose(jsim3.retract(rel, noise), jnp.asarray(est[-1]))))
    verts = np.tile(np.asarray(jsim3.identity()), (cap, 1))
    verts[:K] = np.stack(est)
    ei = list(range(K - 1)) + [0, 2, 5]
    ej = list(range(1, K)) + [K - 1, 4, 8]
    meas = [np.asarray(jsim3.compose(jnp.asarray(true[j]), jsim3.inverse(jnp.asarray(true[i]))))
            for i, j in zip(ei, ej)]
    w = np.ones(len(ei), np.float32)
    w[K - 1] = 5.0
    fixed = np.zeros(cap, bool)
    fixed[0] = True
    return dict(vertices=verts.astype(np.float32), v_fixed=fixed,
                v_valid=np.arange(cap) < K, edge_i=np.asarray(ei, np.int32),
                edge_j=np.asarray(ej, np.int32), edge_meas=np.stack(meas).astype(np.float32),
                edge_valid=np.ones(len(ei), bool), edge_weight=w)


def test_essential_graph_parity():
    rng = np.random.default_rng(7)
    prob = _drifted_chain(rng)
    jv, jc = jpg.optimize_essential_graph(
        jpg.PoseGraphProblem(**{k: jnp.asarray(v) for k, v in prob.items()}), iters=20)
    tv, tc = tpg.optimize_essential_graph(
        tpg.PoseGraphProblem(**{k: t(v) for k, v in prob.items()}), iters=20)
    np.testing.assert_allclose(n(tv), np.asarray(jv), atol=1e-3)
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-3, atol=1e-6)
    np.testing.assert_array_equal(n(tv)[0], prob["vertices"][0])   # the fixed vertex
    np.testing.assert_array_equal(n(tv)[12:], prob["vertices"][12:])  # invalid vertices
    r = tpg.edge_residual(t(prob["vertices"][:3]), t(prob["vertices"][1:4]),
                          t(prob["edge_meas"][:3]))
    want = jpg.edge_residual(jnp.asarray(prob["vertices"][:3]), jnp.asarray(prob["vertices"][1:4]),
                             jnp.asarray(prob["edge_meas"][:3]))
    np.testing.assert_allclose(n(r), np.asarray(want), atol=1e-5)
