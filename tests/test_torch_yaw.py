"""The port's line-alignment yaw (``eao_slam_torch/objects/yaw.py``) against
the reference package's ``objects/yaw.py`` on the same numpy inputs.

Fixtures: the reference's own (tests/test_lines_yaw.py: a class-62 cuboid
off the optical axis, its top-ring edges as the lines, yaws 10 and 0
degrees, four frames of votes), the same cuboid as a chair (class 56, the
triple-weighted length edge), and random tables with many detections and
integer counts full of ties.

Tolerances: ``yaw_sample_scores`` counts and ``n_lines`` exact, errs 1e-3
degree (sums of float32 angle differences in another order);
``update_yaw`` ``yaw_hist`` 1e-5, the elected yaw the same sample, to 1e-6
rad (the samples are 0.054 rad apart); the yaw grid and the angle gate bit
for bit against the reference's ``sample_yaws()`` and ``ANGLE_GATE``. The
reference's grid is ``jnp.linspace`` evaluated inside each jitted program,
and XLA rounds it differently from program to program (in the last bit of
up to 12 of the 30 samples): its ``update_yaw`` elects from a grid that
differs from its eager ``sample_yaws()``, hence the 1e-6 on the elected
yaw.
"""

import numpy as np
import pytest
import torch

from eao_slam_torch.convert import object_table_from_numpy
from eao_slam_torch.geometry.camera import TUM3
from eao_slam_torch.objects import yaw as TY
from torch_parity import n, t

J = 8


def test_grid_and_gate_are_the_reference_bits():
    from eao_slam_tpu.objects import yaw as JY

    np.testing.assert_array_equal(n(TY.sample_yaws()).view(np.uint32),
                                  np.asarray(JY.sample_yaws()).view(np.uint32))
    assert np.float32(TY.ANGLE_GATE).view(np.uint32) == \
        np.asarray(JY.ANGLE_GATE, np.float32).view(np.uint32)
    assert (TY.YAW_SAMPLES, TY.CHAIR_CLASS, TY.EDGE_LEN, TY.EDGE_WID, TY.EDGE_HGT) == \
        (JY.YAW_SAMPLES, JY.CHAIR_CLASS, JY.EDGE_LEN, JY.EDGE_WID, JY.EDGE_HGT)


def _table_numpy(jtable) -> dict:
    return {k: np.array(v) for k, v in jtable._asdict().items()}


def reference_fixture(true_yaw_deg: float, cls: int):
    """tests/test_lines_yaw.py's setup (TestYaw._setup) with the class
    given: (table as numpy, T_cw, lines, line_valid, boxes, targets)."""
    import jax.numpy as jnp

    from eao_slam_tpu.objects.state import empty_object_table
    from test_lines_yaw import TestYaw

    table, T, lines, lvalid, boxes, targets = TestYaw()._setup(None, np.deg2rad(true_yaw_deg))
    table = table._replace(cls=table.cls.at[0].set(cls))
    assert table.capacity == empty_object_table(J, TY.YAW_SAMPLES).capacity
    return (_table_numpy(table), np.asarray(T, np.float32), lines, lvalid, boxes,
            np.asarray(targets, np.int32))


def run_both(table, T, frames):
    """Both packages' score + update over ``frames`` (lines, line_valid,
    boxes, targets each), comparing every frame's scores; returns the two
    final tables as numpy."""
    import jax.numpy as jnp

    from eao_slam_tpu.geometry.camera import TUM3 as JTUM3
    from eao_slam_tpu.objects import yaw as JY
    from eao_slam_tpu.objects.state import ObjectTable as JTable

    jt = JTable(**{k: jnp.asarray(v) for k, v in table.items()})
    tt = object_table_from_numpy(table, "cpu")
    for lines, lvalid, boxes, targets in frames:
        cj, ej, nj = JY.yaw_sample_scores(JTUM3, jt, jnp.asarray(targets), jnp.asarray(boxes),
                                          jnp.asarray(T), jnp.asarray(lines), jnp.asarray(lvalid))
        ct, et, nt = TY.yaw_sample_scores(TUM3, tt, t(targets), t(boxes), t(T), t(lines),
                                          t(lvalid))
        np.testing.assert_array_equal(n(ct), np.asarray(cj))
        np.testing.assert_allclose(n(et), np.asarray(ej), atol=1e-3)
        np.testing.assert_array_equal(n(nt), np.asarray(nj))
        jt = JY.update_yaw(jt, jnp.asarray(targets), cj, ej, nj)
        tt = TY.update_yaw(tt, t(targets), ct, et, nt)
    return {k: n(v) for k, v in tt._asdict().items()}, _table_numpy(jt)


def assert_tables_equal(a, b):
    np.testing.assert_allclose(a["yaw_hist"], b["yaw_hist"], atol=1e-5)
    np.testing.assert_allclose(a["yaw"], b["yaw"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("true_yaw,cls", [(10.0, 62), (0.0, 62), (10.0, 56), (-20.0, 73)])
def test_reference_fixture(true_yaw, cls):
    table, T, lines, lvalid, boxes, targets = reference_fixture(true_yaw, cls)
    ours, ref = run_both(table, T, [(lines, lvalid, boxes, targets)] * 4)
    assert_tables_equal(ours, ref)
    assert ours["yaw_hist"][0, :, 0].sum() == 4.0
    if cls == 62:    # the reference test's own assertion
        assert abs(np.rad2deg(ours["yaw"][0]) - true_yaw) <= 4.0


def random_case(seed: int):
    """A table of J objects in front of the camera with random extents and
    classes (chairs among them), a yaw histogram of small integer vote
    counts (ties everywhere), and frames of 6 detections each with random
    line sets; some detections inactive, some sharing a target."""
    rng = np.random.default_rng(seed)
    from eao_slam_tpu.objects.state import empty_object_table

    table = _table_numpy(empty_object_table(J, TY.YAW_SAMPLES))
    table["valid"][:] = rng.random(J) < 0.8
    table["cls"][:] = rng.choice([56, 62, 73], J)
    table["center"][:] = np.stack([rng.uniform(-1, 1, J), rng.uniform(-0.5, 0.5, J),
                                   rng.uniform(3, 5, J)], 1)
    half = rng.uniform(0.2, 0.6, (J, 3)).astype(np.float32)
    table["cub_min"][:], table["cub_max"][:] = -half, half
    hist = np.zeros((J, TY.YAW_SAMPLES, 3), np.float32)
    hist[..., 0] = rng.integers(0, 3, (J, TY.YAW_SAMPLES)) * (rng.random((J, 1)) < 0.7)
    hist[..., 1] = np.where(hist[..., 0] > 0, rng.choice([0.25, 0.5], hist.shape[:2]), 0.0)
    hist[..., 2] = np.where(hist[..., 0] > 0, rng.uniform(0, 0.2, hist.shape[:2]), 0.0)
    table["yaw_hist"][:] = hist
    T = np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(np.float32)
    frames = []
    for _ in range(3):
        L = 64
        p = rng.uniform([100, 80], [540, 400], (L, 2))
        ang = rng.choice([0.0, np.pi / 2, rng.uniform(0, np.pi)], L) + rng.normal(0, 0.02, L)
        ln = rng.uniform(20, 120, L)
        lines = np.concatenate([p, p + ln[:, None] * np.stack([np.cos(ang), np.sin(ang)], 1)],
                               1).astype(np.float32)
        lvalid = rng.random(L) < 0.8
        xy = rng.uniform([80, 60], [400, 300], (6, 2))
        boxes = np.concatenate([xy, rng.uniform(80, 240, (6, 2))], 1).astype(np.float32)
        targets = rng.integers(-1, J, 6).astype(np.int32)
        targets[1] = targets[0]
        frames.append((lines, lvalid, boxes, targets))
    return table, T, frames


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_tables(seed):
    table, T, frames = random_case(seed)
    ours, ref = run_both(table, T, frames)
    assert_tables_equal(ours, ref)
    assert ours["yaw_hist"][..., 0].sum() > table["yaw_hist"][..., 0].sum()


@pytest.mark.parametrize("seed", [0, 1])
def test_update_yaw_tied_counts(seed):
    """update_yaw alone on integer counts with ties (to the maximum and to
    zero) and equal errors: the winner's tie-breaks, the phantom vote, the
    top-3 election among tied vote totals."""
    import jax.numpy as jnp

    from eao_slam_tpu.objects import yaw as JY
    from eao_slam_tpu.objects.state import ObjectTable as JTable

    table, _, _ = random_case(seed + 10)
    rng = np.random.default_rng(seed)
    B, S = 6, TY.YAW_SAMPLES
    counts = rng.integers(0, 3, (B, S)).astype(np.float32)
    counts[0] = 0.0
    errs = np.where(counts > 0, rng.choice([1.0, 2.0], (B, S)), 0.0).astype(np.float32)
    n_lines = rng.integers(0, 6, B).astype(np.int32)
    targets = np.array([0, 1, 2, 2, -1, 3], np.int32)
    jt = JY.update_yaw(JTable(**{k: jnp.asarray(v) for k, v in table.items()}),
                       jnp.asarray(targets), jnp.asarray(counts), jnp.asarray(errs),
                       jnp.asarray(n_lines))
    tt = TY.update_yaw(object_table_from_numpy(table, "cpu"), t(targets), t(counts), t(errs),
                       t(n_lines))
    assert_tables_equal({k: n(v) for k, v in tt._asdict().items()}, _table_numpy(jt))


def test_lines_in_box_and_lr_angle():
    from eao_slam_tpu.objects import yaw as JY

    rng = np.random.default_rng(5)
    lines = rng.uniform(0, 640, (40, 4)).astype(np.float32)
    valid = rng.random(40) < 0.7
    boxes = np.concatenate([rng.uniform(0, 400, (5, 2)), rng.uniform(50, 300, (5, 2))],
                           1).astype(np.float32)
    np.testing.assert_array_equal(n(TY.lines_in_box(t(lines), t(valid), t(boxes))),
                                  np.asarray(JY.lines_in_box(lines, valid, boxes)))
    d = np.concatenate([rng.normal(size=(50, 2)), [[0.0, 1.0], [0.0, -1.0], [-1.0, 0.0]]])
    d = d.astype(np.float32)
    np.testing.assert_allclose(n(TY._lr_angle(t(d))), np.asarray(JY._lr_angle(d)), atol=1e-6)
    assert torch.all(TY._lr_angle(t(d)) > -np.pi / 2 - 1e-6)
