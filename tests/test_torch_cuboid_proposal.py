"""The port's single-view cuboid proposals (``objects/cuboid_proposal.py``)
against the reference package's ``detect_cuboid`` on
``tests/test_cuboid_proposal.py``'s fixtures: the ground-truth cuboid's
edges as the segments, its box and a second box, and two invalid boxes.

Tolerances: ``ok`` exact; position, scale, yaw and error to 1e-4;
projected corners (pixels of a few hundred, from cross products of
homogeneous lines that cancel digits: up to 20 float32 ulps apart) to
1e-5 relative. Both grids (object yaws, top-corner positions) hold the
reference's eager ``jnp.linspace`` bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from eao_slam_torch.geometry.camera import TUM3 as TCAM
from eao_slam_torch.objects import cuboid_proposal as tcp
from eao_slam_tpu.geometry.camera import TUM3 as JCAM
from eao_slam_tpu.objects import cuboid_proposal as jcp
from test_cuboid_proposal import _edges_as_lines, _gt_cuboid_scene
from torch_parity import n, t


def _both(boxes, box_valid, lines, line_valid, T_cw, ground_y):
    want = jcp.detect_cuboid(JCAM, jnp.asarray(T_cw), jnp.asarray(boxes), jnp.asarray(box_valid),
                             jnp.asarray(lines), jnp.asarray(line_valid), ground_y=ground_y)
    got = tcp.detect_cuboid(TCAM, t(np.asarray(T_cw)), t(boxes), t(box_valid), t(lines),
                            t(line_valid), ground_y=ground_y)
    return got, want


def _assert_close(got, want):
    w_ok = np.asarray(want.ok)
    np.testing.assert_array_equal(n(got.ok), w_ok)
    for f in ("pos", "scale", "yaw", "error"):
        np.testing.assert_allclose(n(getattr(got, f)), np.asarray(getattr(want, f)), atol=1e-4,
                                   rtol=0, err_msg=f)
    np.testing.assert_allclose(n(got.corners_2d)[w_ok], np.asarray(want.corners_2d)[w_ok],
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("yaw", [0.25, -0.4])
def test_detect_cuboid_matches_reference(yaw):
    corners_w, uv, T_cw, gt_pos, gt_half = _gt_cuboid_scene(yaw=yaw)
    lines = _edges_as_lines(uv)
    L = 32
    lines_pad = np.zeros((L, 4), np.float32)
    lines_pad[: len(lines)] = lines
    rng = np.random.default_rng(2)
    lines_pad[len(lines):24] = rng.uniform(0, 480, (24 - len(lines), 4))
    lvalid = np.arange(L) < 24
    x0, y0 = uv.min(0) - 2
    x1, y1 = uv.max(0) + 2
    boxes = np.array([[x0, y0, x1 - x0, y1 - y0], [x0 + 10, y0 + 5, x1 - x0 - 20, y1 - y0 - 5],
                      [100, 100, 50, 60]], np.float32)
    got, want = _both(boxes, np.array([True, True, True]), lines_pad, lvalid, T_cw, 1.5)
    assert bool(np.asarray(want.ok)[0])
    _assert_close(got, want)
    # the proposal recovers the cuboid, as the reference's own test requires
    assert np.linalg.norm(n(got.pos[0]) - gt_pos) < 0.5


def test_detect_cuboid_invalid_boxes():
    _, _, T_cw, *_ = _gt_cuboid_scene()
    got, want = _both(np.zeros((2, 4), np.float32), np.array([False, False]),
                      np.zeros((8, 4), np.float32), np.zeros(8, bool), T_cw, 0.0)
    assert not n(got.ok).any()
    _assert_close(got, want)


def test_sample_grids_are_the_reference_bits():
    """The pinned grids are ``jnp.linspace``'s float32 bits."""
    yaw_offsets, grid = tcp._grids("cpu")
    for got, (a, b, k) in ((yaw_offsets, (-np.pi / 2, np.pi / 2, tcp.N_YAW)),
                           (grid, (0.15, 0.85, tcp.N_POS))):
        np.testing.assert_array_equal(n(got).view(np.uint32),
                                      np.asarray(jnp.linspace(a, b, k)).view(np.uint32))
