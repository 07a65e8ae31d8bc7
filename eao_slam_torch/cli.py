"""Command-line drivers: the mono_tum contract, the KITTI and EuRoC
drivers, a synthetic demo and the cloud evaluation.

``mono_tum <flag> <sequence_path>`` (Examples/Monocular/mono_tum.cc), where
flag is one of None, iForest, LineAndiForest, NA, IoU, NP, EAO, Full and
sequence_path a TUM directory with rgb.txt; the detections load from
<seq>/yolo_txts/<timestamp>.txt (the offline-YOLO contract), and a
groundtruth.txt aligns the map with the ground. ``demo`` runs on the
synthetic room scene, no dataset needed. Each prints one JSON line of
statistics, the image decoder it used among them (``loader_backend``).
Everything runs on the CUDA card; ``--device cpu`` (anywhere in the
arguments) runs it on the CPU. ``--trace PATH`` (anywhere in the
arguments) turns the port's tracer on for the run (``utils/profiling.py``)
and at the end writes its stage tree and counters to PATH as JSON: per
chunk and summed, each stage's seconds, self seconds, calls, parent and
counters (frames, keyframes, motion fallbacks, host synchronisations on
the card); the statistics line then carries ``trace_path``.

Usage:
    python -m eao_slam_torch.cli mono_tum <flag> <sequence_path> [out_dir]
    python -m eao_slam_torch.cli mono_kitti <flag> <sequence_path> [seq_num] [out_dir]
    python -m eao_slam_torch.cli mono_euroc <flag> <image_dir> [times_file|-] [out_dir]
    python -m eao_slam_torch.cli eval_cloud <est.obj/ply> <gt.obj/ply>
    python -m eao_slam_torch.cli demo [flag] [n_frames]
    (each also with --device cpu, --trace PATH)
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from eao_slam_torch.config import CapacityConfig, tum3_config
from eao_slam_torch.io.native_loader import SequenceLoader
from eao_slam_torch.system import System
from eao_slam_torch.utils.profiling import TRACER


def _track_sequence(sysm: System, directory: str, lst, boxes_of=None) -> str:
    """Every decodable frame of the image list through track_monocular
    (with ``boxes_of(timestamp)`` in an object mode); returns the decoder
    backend."""
    cam = sysm.cfg.camera
    with SequenceLoader(directory, lst.filenames, lst.timestamps, cam.width,
                        cam.height) as loader:
        for _, ts, img in loader:
            boxes = boxes_of(float(ts)) if boxes_of is not None else None
            sysm.track_monocular(img, float(ts), boxes=boxes)
        return loader.backend


def run_mono_tum(flag: str, seq: str, out_dir: str = ".", device=None) -> dict:
    from eao_slam_torch.io.tum import load_image_list, load_yolo_boxes

    cfg = tum3_config(flag)
    sysm = System(cfg, device=device)
    lst = load_image_list(os.path.join(seq, "rgb.txt"))
    yolo_dir = os.path.join(seq, "yolo_txts")
    gt_path = os.path.join(seq, "groundtruth.txt")
    if os.path.exists(gt_path):      # ground alignment (src/Tracking.cc:197-241)
        sysm.set_groundtruth(gt_path)
    boxes_of = None
    if cfg.flag.objects_enabled and os.path.isdir(yolo_dir):
        def boxes_of(ts):
            return load_yolo_boxes(yolo_dir, ts, cfg.capacity.max_boxes)
    backend = _track_sequence(sysm, seq, lst, boxes_of)
    sysm.shutdown()
    return {**_export(sysm, out_dir), "loader_backend": backend}


def run_mono_kitti(flag: str, seq: str, sequence_num: int = 0, out_dir: str = ".",
                   device=None) -> dict:
    """mono_kitti (Examples/Monocular/mono_kitti.cc): frames
    <seq>/image_2/%06d.png stamped by times.txt, the sequence's camera;
    also writes the KITTI-format CameraTrajectory.txt."""
    from eao_slam_torch.config import kitti_config
    from eao_slam_torch.io.kitti import load_kitti_sequence
    from eao_slam_torch.io.trajectory import save_kitti

    sysm = System(kitti_config(sequence_num, flag), device=device)
    backend = _track_sequence(sysm, seq, load_kitti_sequence(seq))
    sysm.shutdown()
    stats = _export(sysm, out_dir)
    _, frame_T = sysm.tracker.frame_trajectory()
    stats["kitti_rows"] = save_kitti(os.path.join(out_dir, "CameraTrajectory.txt"),
                                     np.stack(frame_T)) if len(frame_T) else 0
    stats["loader_backend"] = backend
    return stats


def run_mono_euroc(flag: str, image_dir: str, times_file: str | None = None,
                   out_dir: str = ".", device=None) -> dict:
    """mono_euroc (Examples/Monocular/mono_euroc.cc): frames named by
    nanosecond stamps, the EuRoC camera with its distortion."""
    from eao_slam_torch.config import euroc_config
    from eao_slam_torch.io.euroc import load_euroc_sequence

    sysm = System(euroc_config(flag), device=device)
    backend = _track_sequence(sysm, image_dir, load_euroc_sequence(image_dir, times_file))
    sysm.shutdown()
    return {**_export(sysm, out_dir), "loader_backend": backend}


def run_demo(flag: str = "EAO", n_frames: int = 60, out_dir: str = ".", device=None) -> dict:
    """The synthetic room scene's arc as simulated feature observations
    (and detector boxes), through track_frame; ATE against the truth."""
    from eao_slam_torch.geometry.camera import TUM3
    from eao_slam_torch.io.synthetic import (
        make_arc_trajectory, make_room_scene, project_boxes, simulate_observations)
    from eao_slam_torch.io.trajectory import ate_rmse
    from eao_slam_torch.runtime.frame import frame_from_arrays

    cfg = tum3_config(flag).replace(
        capacity=CapacityConfig(max_keyframes=64, max_points=8192, max_features=512,
                                local_ba_points=2048))
    sysm = System(cfg, device=device)
    scene = make_room_scene(seed=3, n_landmarks=2000, n_objects=3)
    ts, gt = make_arc_trajectory(n_frames=n_frames, sweep_deg=40.0)
    rng = np.random.default_rng(7)

    t0 = time.perf_counter()
    for i, T_gt in enumerate(gt):
        obs = simulate_observations(scene, TUM3, T_gt, max_features=512, rng=rng,
                                    pixel_noise=0.4, bit_flips=6)
        boxes = project_boxes(scene, TUM3, T_gt, cfg.capacity.max_boxes)
        f = frame_from_arrays(cfg, kp=obs["kp"], desc=obs["desc"], octave=obs["octave"],
                              valid=obs["valid"], boxes=boxes)
        t1 = time.perf_counter()
        sysm.track_frame(f, float(ts[i]))
        sysm.timings.append(time.perf_counter() - t1)
    wall = time.perf_counter() - t0
    sysm.shutdown()

    stats = _export(sysm, out_dir)
    est_ts, est_T = sysm.tracker.frame_trajectory()
    if len(est_ts):
        idx = [int(np.argmin(np.abs(ts - t))) for t in est_ts]
        est_c = np.stack([-T[:3, :3].T @ T[:3, 3] for T in est_T])
        gt_c = np.stack([-T[:3, :3].T @ T[:3, 3] for T in gt[idx]])
        stats["ate_rmse_m"] = round(ate_rmse(est_c, gt_c), 5)
    stats["wall_s"] = round(wall, 2)
    stats["fps"] = round(len(gt) / wall, 2)
    return stats


def _export(sysm: System, out_dir: str) -> dict:
    """The six export files (trajectories, objects, semi-dense cloud, 3D
    lines, mesh) and the run's counts and timing."""
    os.makedirs(out_dir, exist_ok=True)
    stats = {
        "keyframes": sysm.save_keyframe_trajectory_tum(
            os.path.join(out_dir, "KeyFrameTrajectory.txt")),
        "frames_tracked": sysm.save_frame_trajectory_tum(
            os.path.join(out_dir, "FrameTrajectory.txt")),
        "objects": sysm.save_objects_json(os.path.join(out_dir, "objects.json")),
        "semidense_points": sysm.save_semidense_obj(os.path.join(out_dir, "semidense.obj")),
        "lines3d": sysm.save_lines_obj(os.path.join(out_dir, "lines3d.obj")),
        "mesh_tris": sysm.save_mesh_obj(os.path.join(out_dir, "mesh.obj")),
    }
    stats.update({f"tracking_{k}": round(v, 4) for k, v in sysm.timing_stats().items()})
    return stats


def _option(argv: list, name: str):
    """The value of ``name VALUE`` anywhere in ``argv`` (both removed), or
    None."""
    if name not in argv:
        return None
    k = argv.index(name)
    value = argv[k + 1]
    del argv[k:k + 2]
    return value


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    device = _option(argv, "--device")
    trace_path = _option(argv, "--trace")
    if not argv:
        print(__doc__)
        return 1
    if trace_path is not None:
        TRACER.reset()
        TRACER.enable()
    try:
        stats = _run(argv, device)
    finally:
        if trace_path is not None:
            TRACER.disable()
    if stats is None:
        print(__doc__)
        return 1
    if trace_path is not None:
        TRACER.write_trace(trace_path)
        stats["trace_path"] = trace_path
    print(json.dumps(stats))
    return 0


def _run(argv: list, device):
    """The command's statistics, or None for an unknown command."""
    cmd = argv[0]
    if cmd == "mono_tum":
        out = argv[3] if len(argv) > 3 else "."
        return run_mono_tum(argv[1], argv[2], out, device=device)
    if cmd == "mono_kitti":
        num = int(argv[3]) if len(argv) > 3 else 0
        out = argv[4] if len(argv) > 4 else "."
        return run_mono_kitti(argv[1], argv[2], num, out, device=device)
    if cmd == "mono_euroc":
        times = argv[3] if len(argv) > 3 and argv[3] != "-" else None
        out = argv[4] if len(argv) > 4 else "."
        return run_mono_euroc(argv[1], argv[2], times, out, device=device)
    if cmd == "eval_cloud":
        from eao_slam_torch.evaluation import evaluate_reconstruction

        return evaluate_reconstruction(argv[1], argv[2], device=device)
    if cmd == "demo":
        flag = argv[1] if len(argv) > 1 else "EAO"
        n = int(argv[2]) if len(argv) > 2 else 60
        return run_demo(flag, n, device=device)
    return None


if __name__ == "__main__":
    sys.exit(main())
