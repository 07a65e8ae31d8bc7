"""The KITTI and EuRoC contracts of the port against the reference's
(tests/test_kitti_euroc.py): the camera presets, the sequence loaders'
image lists (the EuRoC directory-listing fallback too), the presets
``kitti_config`` / ``euroc_config`` / ``tiny_profile_config`` field by
field, the feature count of the KITTI preset's front end, the EuRoC
undistortion, and, marked
slow as the reference marks its own, ``mono_kitti`` / ``mono_euroc`` end
to end on the CPU (``chip_smoke.py`` runs both on the card)."""

import dataclasses
import os

import numpy as np
import pytest

from eao_slam_torch import config as tc
from eao_slam_torch.geometry import camera as tcam
from eao_slam_torch.io.euroc import load_euroc_sequence
from eao_slam_torch.io.kitti import kitti_camera, load_kitti_sequence
from eao_slam_tpu import config as jc
from eao_slam_tpu.geometry import camera as jcam
from eao_slam_tpu.io.euroc import load_euroc_sequence as j_load_euroc
from eao_slam_tpu.io.kitti import kitti_camera as j_kitti_camera
from eao_slam_tpu.io.kitti import load_kitti_sequence as j_load_kitti
from torch_parity import n


@pytest.mark.parametrize("name", ["TUM3", "KITTI00_02", "KITTI03", "KITTI04_12", "EUROC"])
def test_camera_presets_equal(name):
    ours, ref = getattr(tcam, name), getattr(jcam, name)
    assert tuple(ours) == tuple(ref)
    assert ours.has_distortion == ref.has_distortion


def test_kitti_camera_by_sequence():
    for seq in range(13):
        assert tuple(kitti_camera(seq)) == tuple(j_kitti_camera(seq))
    assert kitti_camera("03") is tcam.KITTI03
    for bad in (13, -1):
        with pytest.raises(ValueError):
            kitti_camera(bad)
        with pytest.raises(ValueError):
            j_kitti_camera(bad)


def _lists_equal(a, b):
    assert a.filenames == b.filenames
    assert a.timestamps.dtype == b.timestamps.dtype
    np.testing.assert_array_equal(a.timestamps, b.timestamps)


def test_load_kitti_sequence(tmp_path):
    (tmp_path / "image_2").mkdir()
    (tmp_path / "times.txt").write_text("0.000000\n0.103216\n\n0.206610 extra\n")
    lst = load_kitti_sequence(str(tmp_path))
    _lists_equal(lst, j_load_kitti(str(tmp_path)))
    _lists_equal(load_kitti_sequence(str(tmp_path), "image_0"),
                 j_load_kitti(str(tmp_path), "image_0"))
    assert lst.filenames[1] == os.path.join("image_2", "000001.png")


def test_load_euroc_sequence(tmp_path):
    times = tmp_path / "stamps.txt"
    times.write_text("#stamp\n1403636579763555584,x\n1403636579813555456\n\n")
    lst = load_euroc_sequence(str(tmp_path), str(times))
    _lists_equal(lst, j_load_euroc(str(tmp_path), str(times)))
    for stamp in ("1403636579813555456", "1403636579763555584"):
        (tmp_path / f"{stamp}.png").write_bytes(b"")
    (tmp_path / "notes.txt").write_text("")
    listed = load_euroc_sequence(str(tmp_path))
    _lists_equal(listed, j_load_euroc(str(tmp_path)))
    assert listed.filenames == lst.filenames


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _assert_port_fields_equal(ours, ref):
    """Every field the port's configuration keeps equals the reference's,
    sub-configuration by sub-configuration."""
    for name, value in _fields(ours).items():
        want = getattr(ref, name)
        if dataclasses.is_dataclass(value):
            _assert_port_fields_equal(value, want)
        elif name == "camera":
            assert tuple(value) == tuple(want)
        elif name == "flag":
            assert value.value == want.value
        else:
            assert value == want, name


@pytest.mark.parametrize("case", ["kitti0", "kitti3", "kitti7", "euroc", "tiny"])
def test_presets_equal(case):
    if case.startswith("kitti"):
        seq = int(case[5:])
        pairs = [(tc.kitti_config(seq), jc.kitti_config(seq)),
                 (tc.kitti_config(seq, "EAO"), jc.kitti_config(seq, "EAO"))]
    elif case == "euroc":
        pairs = [(tc.euroc_config(), jc.euroc_config()),
                 (tc.euroc_config("Full"), jc.euroc_config("Full"))]
    else:
        pairs = [(tc.tiny_profile_config(), jc.tiny_profile_config())]
    for ours, ref in pairs:
        _assert_port_fields_equal(ours, ref)


def test_kitti_front_end_extracts_the_capacitys_features():
    """kitti_config requests 2000 features (``orb.n_features``) while the
    feature slots stay at ``capacity.max_features``: no front end of either
    package reads the request, so a frame holds max_features features, the
    same with 2000 requested as with the default. Checked at the tiny
    profile's size in both packages on one rendered frame."""
    from eao_slam_torch.io.synthetic import make_room_scene, render_image
    from eao_slam_torch.runtime.frame import frame_from_image as t_frame
    from eao_slam_tpu.runtime.frame import frame_from_image as j_frame

    tiny_t, tiny_j = tc.tiny_profile_config(), jc.tiny_profile_config()
    scene = make_room_scene(seed=5, n_landmarks=100, n_objects=2)
    T = np.eye(4)[:3]
    T[2, 3] = 0.5
    img = render_image(scene, tiny_t.camera, T).astype(np.float32)
    F = tiny_t.capacity.max_features
    feats = {}
    for req in (128, 2000):
        cfg_t = tiny_t.replace(orb=tc.OrbConfig(n_features=req, n_levels=4))
        cfg_j = tiny_j.replace(orb=jc.OrbConfig(n_features=req, n_levels=4))
        assert tc.kitti_config(0).orb.n_features == jc.kitti_config(0).orb.n_features == 2000
        ft, fj = t_frame(cfg_t, img, "cpu"), j_frame(cfg_j, img)
        assert ft.kp.shape == (F, 2) and np.asarray(fj.kp).shape == (F, 2)
        np.testing.assert_array_equal(n(ft.valid), np.asarray(fj.valid))
        np.testing.assert_allclose(n(ft.kp), np.asarray(fj.kp), atol=1e-4)
        feats[req] = (n(ft.kp), n(ft.valid))
    np.testing.assert_array_equal(feats[128][0], feats[2000][0])
    np.testing.assert_array_equal(feats[128][1], feats[2000][1])


def _render_kitti_sequence(seq, n_frames=24):
    import cv2

    from eao_slam_torch.io.synthetic import make_arc_trajectory, make_room_scene, render_image

    (seq / "image_2").mkdir(parents=True)
    scene = make_room_scene(seed=5, n_landmarks=80, n_objects=0)
    ts, gt = make_arc_trajectory(n_frames=n_frames, sweep_deg=18.0)
    with open(seq / "times.txt", "w") as f:
        for i, T in enumerate(gt):
            cv2.imwrite(str(seq / "image_2" / ("%06d.png" % i)),
                        render_image(scene, tcam.KITTI00_02, T))
            f.write(f"{ts[i]:.6f}\n")
    return ts, gt


@pytest.mark.slow
def test_mono_kitti_end_to_end(tmp_path):
    from eao_slam_torch.cli import run_mono_kitti
    from eao_slam_torch.io.trajectory import load_kitti_poses

    _render_kitti_sequence(tmp_path / "00")
    out = tmp_path / "out"
    stats = run_mono_kitti("None", str(tmp_path / "00"), 0, str(out), device="cpu")
    assert stats["frames_tracked"] >= 8, stats
    assert stats["kitti_rows"] == stats["frames_tracked"]
    assert stats["loader_backend"] == "native"
    P = load_kitti_poses(str(out / "CameraTrajectory.txt"))
    np.testing.assert_allclose(P[0], np.eye(4)[:3], atol=1e-6)


@pytest.mark.slow
def test_mono_euroc_end_to_end(tmp_path):
    import cv2

    from eao_slam_torch.cli import run_mono_euroc
    from eao_slam_torch.io.synthetic import make_arc_trajectory, make_room_scene, render_image

    scene = make_room_scene(seed=5, n_landmarks=80, n_objects=0)
    ts, gt = make_arc_trajectory(n_frames=24, sweep_deg=18.0)
    for i, T in enumerate(gt):
        cv2.imwrite(str(tmp_path / f"{1403636579000000000 + int(ts[i] * 1e9)}.png"),
                    render_image(scene, tcam.EUROC, T))
    stats = run_mono_euroc("None", str(tmp_path), None, str(tmp_path / "out"), device="cpu")
    assert stats["frames_tracked"] >= 8, stats


def test_euroc_undistortion_matches_reference():
    """The EuRoC camera's fixed-point undistortion over its whole image (a
    grid of pixels) in both packages: bit-equal on the CPU (the port
    divides exactly on every device, ``camera._ieee_div``)."""
    import jax.numpy as jnp
    import torch

    xs, ys = np.meshgrid(np.arange(0, 752, 7.3), np.arange(0, 480, 5.9))
    uv = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)
    ours = n(tcam.undistort_points(tcam.EUROC, torch.as_tensor(uv)))
    ref = np.asarray(jcam.undistort_points(jcam.EUROC, jnp.asarray(uv)))
    np.testing.assert_array_equal(ours, ref)
    assert np.abs(ours - uv).max() > 10       # the distortion is undone, not skipped
