"""The front end's comparison: the plain reference against the port's own
plain front end on the CPU (they agree bit for bit), and the comparison's
arithmetic on planted differences."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from harness import synthetic
from harness.check import frontend_diff
from harness.inputs import Camera
from harness.runner import _as_program
from reference import orb as ref_orb

CAM = Camera(267.7, 269.6, 160.05, 123.8, 320, 240)


@pytest.fixture(scope="module")
def frames():
    scene = synthetic.make_room_scene(seed=5, n_landmarks=200, n_objects=4, obj_z_range=(4.0, 5.2),
                                      obj_size_range=(0.4, 0.9))
    _, gt = synthetic.make_sweep_trajectory(12, sweep_deg=3.0)
    return np.stack([synthetic.render_image(scene, CAM, gt[i]) for i in (0, 6, 11)])


def test_reference_equals_the_ports_plain_front_end(frames):
    from eao_slam_torch.ops.orb import extract_orb

    imgs = torch.as_tensor(frames)
    ref = ref_orb.extract(imgs, 384, 6, 1.2, 20.0, 7.0, 19)
    f = extract_orb(imgs.float(), n_features=384, n_levels=6, scale_factor=1.2,
                    threshold=20.0, min_threshold=7.0, border=19)
    prog = {k: getattr(f, k).numpy() for k in ("kp", "desc", "octave", "valid")}
    assert frontend_diff(prog, ref, 1.2) == (0.0, 0.0)
    assert prog["valid"].sum() > 200 * len(frames)


def test_planted_differences_are_counted(frames):
    imgs = torch.as_tensor(frames)
    ref = ref_orb.extract(imgs, 384, 6, 1.2, 20.0, 7.0, 19)
    prog = _as_program(ref, 1.2)
    n = int(prog["valid"].sum())
    moved = {k: v.copy() for k, v in prog.items()}
    j = int(np.flatnonzero(moved["valid"][0])[0])
    moved["kp"][0, j, 0] += 1.0
    kp, desc = frontend_diff(moved, ref, 1.2)
    assert kp == pytest.approx(1.0 / n, rel=0.05) and desc == 0.0
    flipped = {k: v.copy() for k, v in prog.items()}
    flipped["desc"][1, :, 0] ^= 1
    kp, desc = frontend_diff(flipped, ref, 1.2)
    assert kp == 0.0
    assert desc == pytest.approx(int(prog["valid"][1].sum()) / (256 * n))
