"""Parity of the port's distributed solvers (eao_slam_torch.parallel) with
the reference's on its 8-device CPU mesh and with the port's
single-device solver, on gloo groups of 2 ranks (a (1, 2) host x device
mesh) and 4 ranks (the (2, 2) mesh).

Each file spawns each group once (``torch_parallel.run_ranks``) and holds
every rank's results here. Tolerances are the reference's own tests'
(tests/test_dist_ba.py, test_dist_ba2.py, test_mesh_engine.py,
test_multi_seq.py): poses within 0.01 of the truth (0.015 in the batch,
0.02 beside a fixed two-camera gauge), median point error under 0.12, the
cost within 1.5 x the single-device solve's, >= 95 % of the inlier
decisions shared, fixed cameras unchanged to 1e-6, the distributed 5 + 10
schedule within 5e-3 of the single-device one. Against the reference's
solvers the same bounds apply (poses within 0.01 of its poses; the
accumulation order differs, float64 segment sums in the port, bf16-split
one-hot products and XLA reductions in the reference). Every rank returns
the same result: the ranks are held to each other bit for bit.

``shard_problem`` is host code: its integer arrays equal the reference's
for the same shard count, padding (the fill Pl - 1) included."""

import jax
import numpy as np
import pytest

from eao_slam_tpu.geometry.camera import TUM3 as JCAM
from eao_slam_tpu.parallel.dist_ba import distributed_bundle_adjust, make_ba_mesh
from eao_slam_tpu.parallel.dist_ba2 import (distributed_bundle_adjust_v2, make_hd_mesh,
                                            shard_problem as jshard)
from eao_slam_tpu.parallel.multi_seq import batch_bundle_adjust
from eao_slam_tpu.solvers import ba as jba
from eao_slam_torch.geometry.camera import TUM3 as TCAM
from eao_slam_torch.parallel import dist_ba2 as tba2
from eao_slam_torch.runtime import local_mapping
from eao_slam_torch.solvers import ba as tba
from test_ba import make_ba_problem
from torch_parallel import ba_problem, run_ranks

SIZES = {"K5P256": (5, 256), "K4P250": (4, 250), "K4P173": (4, 173)}


def _fields(prob) -> dict:
    return {k: np.asarray(getattr(prob, k)) for k in prob._fields}


@pytest.fixture(scope="module")
def inputs():
    problems, truths = {}, {}
    for i, (name, (K, P)) in enumerate(SIZES.items()):
        prob, poses_true, X_true = make_ba_problem(np.random.default_rng(20 + i), K=K, P=P)
        f = _fields(prob)
        if name == "K4P173":
            f["cam_fixed"] = np.arange(K) < 2          # a two-camera gauge
        problems[name] = f
        truths[name] = (poses_true, X_true)
    batch, batch_truth = [], []
    for s in range(11):     # not a multiple of 2 or 4: the pad path
        prob, poses_true, _ = make_ba_problem(np.random.default_rng(100 + s), K=4, P=128)
        batch.append(_fields(prob))
        batch_truth.append(poses_true)
    return problems, truths, batch, batch_truth


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    problems, _, batch, _ = inputs
    d = tmp_path_factory.mktemp("ba_ranks")
    return {n: run_ranks(n, d, "ba_suite", problems, batch) for n in (2, 4)}


@pytest.fixture(scope="module")
def reference(inputs):
    """The reference's solvers on its 8-device mesh (the (2, 4) host x
    device mesh for dist_ba2) and the port's single-device solves."""
    problems, _, batch, _ = inputs
    devs = jax.devices()[:8]
    jp = {k: jba.BAProblem(**{f: np.asarray(v) for f, v in p.items()})
          for k, p in problems.items()}
    out = {}
    for name, p in jp.items():
        out[f"dist_ba/{name}"] = distributed_bundle_adjust(JCAM, p, make_ba_mesh(devs), iters=8)
        for method in ("direct", "cg"):
            out[f"v2_{method}/{name}"] = distributed_bundle_adjust_v2(
                JCAM, p, make_hd_mesh(2, devs), iters=8, n_cg=30, method=method)
        out[f"single/{name}"] = tba.bundle_adjust(TCAM, ba_problem(problems[name]), iters=8)
    out["local_ba"] = tba.local_ba(TCAM, ba_problem(problems["K5P256"]))
    out["batch"] = batch_bundle_adjust(
        JCAM, [jba.BAProblem(**{f: np.asarray(v) for f, v in p.items()}) for p in batch],
        make_ba_mesh(devs), iters=8)
    return out


def _t_err(poses, truth) -> np.ndarray:
    return np.linalg.norm(np.asarray(poses)[:, :, 3] - np.asarray(truth)[:, :, 3], axis=1)


def test_ranks_agree_bit_for_bit(ranks):
    for n, res in ranks.items():
        for r in range(1, n):
            for key, val in res[0].items():
                if key.startswith(("dist_ba", "v2_", "ba_solver")):
                    for f in val:
                        np.testing.assert_array_equal(res[r][key][f], val[f], err_msg=f"{n} {key}")


def test_global_mesh_folding(ranks):
    """2 virtual hosts at 4 or more ranks, else 1; n_virtual_hosts=1 keeps
    every rank on the device axis; the chunked tracker's BA mesh folds
    the same way."""
    assert ranks[2][0]["global_mesh"] == [[0, 1]]
    assert ranks[4][0]["global_mesh"] == [[0, 1], [2, 3]]
    assert ranks[4][0]["global_mesh_1"] == [[0, 1, 2, 3]]
    assert ranks[2][0]["ba_mesh"] == [[0, 1]]
    assert ranks[4][0]["ba_mesh"] == [[0, 1], [2, 3]]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["K5P256", "K4P250"])
def test_dist_ba_matches_reference_and_single_device(ranks, reference, inputs, n, name):
    """tests/test_dist_ba.py's bounds, against the truth, the reference's
    distributed solver and the port's single-device solver (K4P250: the
    point pad path at 4 ranks)."""
    _, truths, _, _ = inputs
    poses_true, X_true = truths[name]
    res = ranks[n][0][f"dist_ba/{name}"]
    ref = reference[f"dist_ba/{name}"]
    single = reference[f"single/{name}"]
    assert _t_err(res["poses"], poses_true).max() < 0.01
    assert _t_err(res["poses"], ref.poses).max() < 0.01
    assert float(res["cost"]) < 1.5 * float(single.cost) + 1e-3
    assert float(res["cost"]) < 1.5 * float(ref.cost) + 1e-3
    assert res["points"].shape[0] >= X_true.shape[0]
    pt_err = np.linalg.norm(res["points"][: X_true.shape[0]] - X_true, axis=1)
    assert np.median(pt_err) < 0.12
    np.testing.assert_allclose(res["poses"][:2], inputs[0][name]["poses"][:2], atol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("method", ["direct", "cg"])
@pytest.mark.parametrize("name", ["K5P256", "K4P250"])
def test_dist_ba2_matches_reference_and_single_device(ranks, reference, inputs, n, method,
                                                      name):
    """tests/test_dist_ba2.py's bounds on the (1, 2) and (2, 2) meshes
    (K5 pads K to the two hosts; P250 pads the points), against the truth,
    the reference's v2 on its (2, 4) mesh and the port's single-device
    solver."""
    _, truths, _, _ = inputs
    poses_true, X_true = truths[name]
    res = ranks[n][0][f"v2_{method}/{name}"]
    ref = reference[f"v2_{method}/{name}"]
    single = reference[f"single/{name}"]
    assert res["poses"].shape == poses_true.shape
    assert res["points"].shape == X_true.shape
    assert _t_err(res["poses"], poses_true).max() < 0.01
    assert _t_err(res["poses"], ref.poses).max() < 0.01
    assert np.median(np.linalg.norm(res["points"] - X_true, axis=1)) < 0.12
    assert float(res["cost"]) <= float(single.cost) * 1.5 + 1e-3
    assert np.mean(res["obs_inlier"] == single.obs_inlier.numpy()) > 0.95
    assert np.mean(res["obs_inlier"] == np.asarray(ref.obs_inlier)) > 0.95


@pytest.mark.parametrize("n", [2, 4])
def test_dist_ba2_direct_and_cg_agree(ranks, n):
    """The direct and CG solvers reach the same basin (the reference's
    test_direct_and_cg_solvers_agree)."""
    for name in SIZES:
        rd = ranks[n][0][f"v2_direct/{name}"]
        rc = ranks[n][0][f"v2_cg/{name}"]
        assert float(rd["cost"]) <= float(rc["cost"]) * 1.2 + 1e-3
        assert np.mean(rd["obs_inlier"] == rc["obs_inlier"]) > 0.95


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("method", ["direct", "cg"])
def test_dist_ba2_ragged_points_and_fixed_gauge(ranks, inputs, n, method):
    """173 points and a fixed two-camera gauge: the gauge unchanged to
    1e-6, the free cameras within 0.02 of the truth."""
    problems, truths, _, _ = inputs
    res = ranks[n][0][f"v2_{method}/K4P173"]
    np.testing.assert_allclose(res["poses"][:2], problems["K4P173"]["poses"][:2], atol=1e-6)
    assert _t_err(res["poses"][2:], truths["K4P173"][0][2:]).max() < 0.02


@pytest.mark.parametrize("n", [2, 4])
def test_ba_solver_dispatch_matches_local_ba(ranks, reference, inputs, n):
    """A meshed ChunkedTracker's ba_solver (5 + 10 through the distributed
    dense-clique solver) within 5e-3 of the single-device local_ba, and
    within 0.01 of the truth (tests/test_mesh_engine.py)."""
    res = ranks[n][0]["ba_solver"]
    single = reference["local_ba"]
    assert _t_err(res["poses"], single.poses.numpy()).max() < 5e-3
    assert _t_err(res["poses"], inputs[1]["K5P256"][0]).max() < 0.01


@pytest.mark.parametrize("n", [2, 4])
def test_batch_bundle_adjust_pads_and_converges(ranks, reference, inputs, n):
    """11 problems over 2 and 4 ranks (padded to 12): every solve within
    0.015 of its truth (tests/test_multi_seq.py) and of the reference's
    batched solve; every rank returns all 11."""
    _, _, batch, truths = inputs
    for r in range(n):
        assert len(ranks[n][r]["batch"]) == 11
    for res, ref, truth in zip(ranks[n][0]["batch"], reference["batch"], truths):
        assert _t_err(res["poses"], truth).max() < 0.015
        assert _t_err(res["poses"], ref.poses).max() < 0.015


@pytest.mark.parametrize("n_shards,k_pad,P", [(8, 2, 250), (2, 1, 251), (4, 2, 250),
                                              (4, 2, 256)])
def test_shard_problem_arrays_equal_the_reference(n_shards, k_pad, P):
    """The routing is host numpy in both packages: the blocked integer
    arrays, masks and padded camera flags are equal, and the float arrays
    are the same values moved."""
    prob, _, _ = make_ba_problem(np.random.default_rng(7), K=5, P=P)
    sj, rj, Pj, Kj = jshard(prob, n_shards, k_pad=k_pad)
    st, rt, Pt, Kt = tba2.shard_problem(ba_problem(_fields(prob)), n_shards, k_pad=k_pad)
    assert (Pt, Kt) == (Pj, Kj)
    for f in sj._fields:
        np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(sj, f)),
                                      err_msg=f)
    for f in ("poses", "cam_fixed", "cam_valid"):
        np.testing.assert_array_equal(getattr(rt, f).numpy(), np.asarray(getattr(rj, f)))
    pt_local = st.pt_local.numpy()
    assert (np.diff(pt_local, axis=1) >= 0).all()
    assert st.obs_valid.numpy().sum() == np.asarray(prob.obs_valid).sum()


def test_run_local_ba_dispatches_the_given_solver():
    """run_local_ba(solver=spy) hands its assembled problem to the spy
    (tests/test_mesh_engine.py::test_loop_closer_uses_engine_ba_solver)."""
    import torch

    from eao_slam_torch.config import CapacityConfig, tum3_config
    from eao_slam_torch.ops.orb import scale_sigma2
    from eao_slam_torch.runtime.map_state import empty_map_state

    cfg = tum3_config().replace(capacity=CapacityConfig(
        max_keyframes=64, max_points=4096, max_features=256, local_ba_points=1024))
    m = empty_map_state(cfg.capacity, device=torch.device("cpu"))
    kf_pose = m.kf_pose.clone()
    kf_pose[:2] = torch.eye(3, 4)
    kf_valid = m.kf_valid.clone()
    kf_valid[:2] = True
    m = m._replace(kf_pose=kf_pose, kf_valid=kf_valid)
    calls = []

    def spy(cam, p):
        calls.append(p)
        return tba.local_ba(cam, p)

    res = local_mapping.run_local_ba(cfg.camera, m, [0, 1], [0],
                                     scale_sigma2(cfg.orb.n_levels, cfg.orb.scale_factor).numpy(),
                                     64, solver=spy)
    assert len(calls) == 1
    assert tuple(res.poses.shape) == (2, 3, 4)
