"""The port's command-line drivers against the reference's (eao_slam_tpu/cli.py).

- ``main(["demo", "EAO", "12"])``: the same statistics (counts exact, the
  ATE to 1e-3 m) from the synthetic demo.
- ``main(["eval_cloud", a, b])``: the same statistics to 1e-5.
- ``mono_tum`` / ``mono_kitti`` / ``mono_euroc`` on a sequence on disk,
  each package's ``System`` replaced by a recorder: the same
  configuration, the same ground-truth file, the same frames (bytes),
  timestamps and detector boxes in the same order, shutdown, the same
  export calls; the port's statistics add the decoder it used.
- Usage: no arguments or an unknown command print the usage and return 1.

Marked slow, as the reference marks its own (tests/test_cli.py), the full
``mono_tum`` run on the CPU; ``chip_smoke.py`` runs it on the card.
"""

import json
import os

import cv2
import numpy as np
import pytest

from eao_slam_torch import cli as tcli
from eao_slam_tpu import cli as jcli


def _main(module, argv, capsys) -> dict:
    assert module.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_demo_matches_reference(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    got = _main(tcli, ["demo", "EAO", "12", "--device", "cpu"], capsys)
    want = _main(jcli, ["demo", "EAO", "12"], capsys)
    for k in ("keyframes", "frames_tracked", "objects", "semidense_points", "lines3d",
              "mesh_tris"):
        assert got[k] == want[k], k
    assert got["objects"] == 3 and got["frames_tracked"] >= 10
    assert abs(got["ate_rmse_m"] - want["ate_rmse_m"]) <= 1e-3
    assert set(got) == set(want)
    for name in ("KeyFrameTrajectory.txt", "FrameTrajectory.txt", "objects.json"):
        assert os.path.exists(tmp_path / name)


def _write_cloud(path, pts):
    with open(path, "w") as f:
        f.write("".join(f"v {x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in pts))


def test_eval_cloud_matches_reference(tmp_path, capsys):
    rng = np.random.default_rng(4)
    gt = rng.uniform(-1, 1, (3000, 3)) * (2.0, 1.0, 0.5) + (0, 0, 4)
    est = (gt[::2] * 0.8 + rng.normal(0, 0.01, gt[::2].shape)) + (0.05, -0.02, 0.0)
    a, b = str(tmp_path / "est.obj"), str(tmp_path / "gt.obj")
    _write_cloud(a, est)
    _write_cloud(b, gt)
    got = _main(tcli, ["eval_cloud", a, b, "--device", "cpu"], capsys)
    want = _main(jcli, ["eval_cloud", a, b], capsys)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-5), k


@pytest.mark.parametrize("module", [tcli, jcli])
def test_usage(module, capsys):
    assert module.main([]) == 1
    assert module.main(["no_such_command"]) == 1
    assert "mono_tum" in capsys.readouterr().out


class Recorder:
    """A System that records what a driver feeds it."""

    log: list = []

    def __init__(self, cfg, **kw):
        self.cfg, self.timings = cfg, []
        self.tracker = self
        Recorder.log.append(("config", cfg.flag.value, tuple(cfg.camera),
                             cfg.orb.n_features))

    def set_groundtruth(self, path):
        Recorder.log.append(("groundtruth", path))

    def track_monocular(self, img, ts, boxes=None):
        img = np.asarray(img)
        Recorder.log.append(("track", ts, img.dtype.str, img.shape, img.tobytes(),
                             None if boxes is None else tuple(np.asarray(b).tobytes()
                                                              for b in boxes)))

    def shutdown(self):
        Recorder.log.append(("shutdown",))

    def frame_trajectory(self):
        return [], []

    def timing_stats(self):
        return {}

    def __getattr__(self, name):       # the save_* exports
        if not name.startswith("save_"):
            raise AttributeError(name)
        return lambda path: Recorder.log.append((name, os.path.basename(path))) or 0


def _gray_png(path, rng, w=640, h=480, rgb=False):
    img = rng.integers(0, 256, (h, w, 3) if rgb else (h, w), dtype=np.uint8)
    cv2.imwrite(str(path), img)


def _tum_dir(d, rng, with_gt=True, with_yolo=True):
    (d / "rgb").mkdir(parents=True)
    rows, gt_rows = [], []
    for i in range(4):
        stamp = 1000.0 + i / 30.0
        name = f"rgb/{stamp:.6f}.png"
        _gray_png(d / name, rng, rgb=i == 2)
        rows.append(f"{stamp:.6f} {name}")
        gt_rows.append(f"{stamp:.4f} 0.1 0.2 {0.01 * i} 0 0 0 1")
        if with_yolo and i != 1:                 # frame 1 has no detection file
            (d / "yolo_txts").mkdir(exist_ok=True)
            (d / "yolo_txts" / f"{stamp:.6f}.txt").write_text(
                f"56 {10 + i}.0 20.0 100.0 80.0 0.9\n62 600.0 400.0 80.0 100.0 0.5\n")
    rows.insert(2, "1000.500000 rgb/missing.png")    # an unreadable frame
    (d / "rgb.txt").write_text("# timestamp filename\n" + "\n".join(rows) + "\n")
    if with_gt:
        (d / "groundtruth.txt").write_text("# timestamp tx ty tz qx qy qz qw\n"
                                           + "\n".join(gt_rows) + "\n")
    return str(d)


def _recorded(monkeypatch, call) -> tuple:
    monkeypatch.setattr(tcli, "System", Recorder)
    monkeypatch.setattr(jcli, "System", Recorder)
    logs, stats = [], []
    for module in (tcli, jcli):
        Recorder.log = []
        stats.append(call(module))
        logs.append(Recorder.log)
    return logs, stats


@pytest.mark.parametrize("flag,with_gt,with_yolo", [("EAO", True, True), ("EAO", False, False),
                                                    ("None", True, True)])
def test_mono_tum_feeds_what_the_reference_feeds(tmp_path, monkeypatch, flag, with_gt,
                                                 with_yolo):
    seq = _tum_dir(tmp_path / "seq", np.random.default_rng(5), with_gt, with_yolo)
    (got, want), (s_got, s_want) = _recorded(
        monkeypatch, lambda m: m.run_mono_tum(flag, seq, str(tmp_path / "out")))
    assert got == want
    assert [e[0] for e in got].count("track") == 4
    assert (("groundtruth", os.path.join(seq, "groundtruth.txt")) in got) == with_gt
    boxed = [e[5] is not None for e in got if e[0] == "track"]
    assert boxed == [with_yolo and flag != "None"] * 4
    assert s_got.pop("loader_backend") == "native" and s_got == s_want


def test_mono_kitti_and_euroc_feed_what_the_reference_feeds(tmp_path, monkeypatch):
    rng = np.random.default_rng(6)
    kitti = tmp_path / "kitti"
    (kitti / "image_2").mkdir(parents=True)
    for i in range(3):
        _gray_png(kitti / "image_2" / ("%06d.png" % i), rng, 1241, 376)
    (kitti / "times.txt").write_text("0.0\n0.1\n0.2\n")
    (got, want), (s_got, s_want) = _recorded(
        monkeypatch, lambda m: m.run_mono_kitti("None", str(kitti), 3, str(tmp_path / "k")))
    assert got == want and got[0][2][9] == 1242        # KITTI03's width
    assert s_got.pop("loader_backend") == "native" and s_got == s_want

    euroc = tmp_path / "euroc"
    euroc.mkdir()
    for stamp in (1403636579763555584, 1403636579813555456):
        _gray_png(euroc / f"{stamp}.png", rng, 752, 480)
    for times in (None, str(tmp_path / "t.txt")):
        (tmp_path / "t.txt").write_text("#t\n1403636579813555456\n")
        (got, want), (s_got, s_want) = _recorded(
            monkeypatch, lambda m: m.run_mono_euroc("EAO", str(euroc), times, str(tmp_path / "e")))
        assert got == want
        assert [e[0] for e in got].count("track") == (2 if times is None else 1)
        assert s_got.pop("loader_backend") == "native" and s_got == s_want


@pytest.mark.slow
def test_mono_tum_runs_and_exports(tmp_path):
    """tests/test_cli.py's sequence and gates on the port, on the CPU."""
    from eao_slam_torch.geometry.camera import TUM3
    from eao_slam_torch.io.synthetic import (make_arc_trajectory, make_room_scene,
                                             project_boxes, render_image)
    from eao_slam_torch.io.trajectory import ate_rmse

    d = tmp_path / "seq"
    (d / "rgb").mkdir(parents=True)
    (d / "yolo_txts").mkdir()
    scene = make_room_scene(seed=4, n_landmarks=60, n_objects=2)
    ts, gt = make_arc_trajectory(n_frames=26, sweep_deg=22.0)
    rows = []
    for i, T in enumerate(gt):
        stamp = 1000.0 + ts[i]
        name = f"rgb/{stamp:.6f}.png"
        cv2.imwrite(str(d / name), render_image(scene, TUM3, T))
        rows.append(f"{stamp:.6f} {name}")
        bxs, cls, score, valid = project_boxes(scene, TUM3, T, 8)
        with open(d / "yolo_txts" / f"{stamp:.6f}.txt", "w") as f:
            for b in range(8):
                if valid[b]:
                    x, y, w, h = bxs[b]
                    f.write(f"{cls[b]} {x:.1f} {y:.1f} {w:.1f} {h:.1f} {score[b]:.2f}\n")
    (d / "rgb.txt").write_text("# timestamp filename\n" + "\n".join(rows) + "\n")
    stats = tcli.run_mono_tum("EAO", str(d), str(tmp_path / "out"), device="cpu")
    assert stats["frames_tracked"] >= 12, stats
    assert stats["keyframes"] >= 2
    objs = json.loads((tmp_path / "out" / "objects.json").read_text())
    assert isinstance(objs, list)
    rows = (tmp_path / "out" / "FrameTrajectory.txt").read_text().strip().splitlines()
    est = np.asarray([[float(v) for v in r.split()] for r in rows])
    idx = [int(np.argmin(np.abs((1000.0 + ts) - t))) for t in est[:, 0]]
    gt_c = np.stack([-T[:3, :3].T @ T[:3, 3] for T in gt[idx]])
    assert ate_rmse(est[:, 1:4], gt_c) < 0.1
