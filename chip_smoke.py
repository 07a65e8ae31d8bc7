"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. build every CUDA kernel of the main path from the sources in this
     checkout (nvcc, sm_90a);
  2. hold both entries of the FAST kernel (the full packed map and the
     per-cell maximum) against their plain PyTorch versions at the shapes
     the main path gives them (bit-exact), one launch for all 8 levels and
     one per level, on random, plateau and rendered levels of a chunk and
     on one rendered frame's, and time both with CUDA events;
  3. drive the main path at full width through the port's System with the
     default configuration (loop closing on, so the between-chunk passes
     run after every chunk): geometry mode, 640x480, 1024 features, 8
     levels, chunk 32, on the rendered 60-degree arc; bootstrap, one
     warm-up chunk, four timed chunks. Checks tracked share >= 90 %, the
     sim3 ATE of the timed frames against ground truth, and that the kernel
     entry the path uses was launched on that run;
  4. the same run with two more RANSAC seeds (six before the interactive
     phase needed the time): every run must track >= 90 %
     of its frames and stay under the ATE limit, and the median ATE must
     stay under the median limit. Both limits are 1.5 times the JAX
     reference's own worst and median ATE over twenty seeds
     (reference_ate_spread.py, on the CPU): the tracker is chaotic, so one
     run's ATE is a draw from a spread, and the reference itself meets
     bench.py's 5 cm gate with two of the twenty seeds only;
  5. a long run on rendered frames at full width with the depth cut (48
     keyframes, 6144 points): the arc forward, back and forward again (501
     frames), a chunk of blank frames and a jump back to frames early in
     the arc. Gates: maintenance runs at least twice, the keyframe count
     stays inside capacity after every chunk, >= 85 % of the ping-pong
     frames are tracked, and a between-chunk relocalization succeeds (if
     the jump is recovered inside the chunk, the reference's own kidnap at
     full width follows: LOST, a garbage pose, a real frame's features),
     its camera centre within 0.10 m of ground truth after the sim3
     alignment of the keyframe trajectory near it (the 8 keyframes nearest
     in ground truth: after 500 frames the map has drifted, and one global
     alignment measures that drift, not the relocalization; it is printed
     too), and the two chunks after it track >= 90 % of their frames;
  6. the loop circuit of bench.py through System.track_frame: the closed
     room, 288 frames of a full orbit, simulated observations of 512
     features, chunk 8, 128 keyframes and 8192 points; loop closing on,
     then off. Gates (bench.py's): >= 1 loop closed and the loop run's
     keyframe ATE < 0.7 x the no-loop run's;
  7. checkpoint: the loop run again, saved at a chunk boundary half way,
     loaded into a fresh System and finished: the trajectory must equal
     the uninterrupted run's to 1e-5;
  8. the EAO object layer (bench.py's EAO mode): DemoFlag.EAO at the main
     path's widths with 8 detector boxes a frame (the port's project_boxes
     of the scene's three cuboids) and 32 object slots, through
     System.track_monocular(..., boxes=...) on the same arc, seeds 12345
     and 1-3 (seven before the interactive phase needed the time).
     Gates, on every run: it tracks >= 90 % of its timed frames,
     ends with >= 3 live objects, among them one of each scene object's
     class (bench.py's gate, and every scene object found), stays under
     the ATE limit, and each scene object's centre error stays under the
     object limit; over the four runs the median ATE stays under its
     limit. The centre error is read in the camera frames of the
     keyframes that observed the object, at the map's own scale
     (eao_slam_torch.io.trajectory.map_object_errors). The limits are 1.5
     times the JAX reference's own EAO spread (reference_ate_spread.py
     --flag EAO, on the CPU; the object limit from its worst on the same
     four seeds). The FAST kernel's launches are counted on
     the default seed's run. The object layer's cost per chunk is the
     default seed's EAO chunk time less its geometry chunk time (printed
     with how far the two runs' timed poses differ); the chunk-rate
     iForest cull is also timed alone, on the default seed's final state.
     Each run also prints, ungated, the object measure of the reference's
     tests/test_objects_e2e.py (after one sim3 of the keyframe trajectory);
  9. line mode (DemoFlag.LINE_IFOREST: the object layer with line detection
     in the chunk's front end and line-alignment yaw) at the EAO phase's
     widths with 128 line slots, the same arc, seeds 12345 and 1 (two;
     seven before the FULL phase, five before the interactive phase and
     three before its card-against-CPU check needed the time), the same
     protocol.
     Gates, on every run: as the EAO phase's, with limits
     1.5 times the reference's line-mode spread (reference_ate_spread.py
     --flag LineAndiForest), and yaw votes above 0; one frame's yaw pass
     on the default seed's final state launches kernels, and neither
     synchronises with the host nor copies to or from it (a
     torch.profiler trace). Printed, not gated:
     each object with 3 or more votes whose yaw lies beyond
     LINE_YAW_LIMIT_DEG of the scene's 0 (its cuboids are axis-aligned in
     the first camera's frame; see the constant). Also printed: valid lines
     per frame, the detector's CUDA-event time and
     kernel launches per chunk, the line layer's cost (the default seed's
     line chunk less its EAO chunk), the three modes' fps and the FAST
     kernel's launches on this path. Then the ground alignment: the first
     96 frames of the arc with every camera tilted (8 degrees of roll, -6
     of pitch), rendered again, the ground truth written as a TUM file
     and fed through System.set_groundtruth: the first keyframe must equal
     the initializer frame's true camera-from-world pose to 1e-4 and the
     yaws must hold the reference's own limit on that input, about
     gravity. Last, the detector on the card against the detector on the
     CPU on frames 0, 60 and 120: valid counts within 2, >= 90 % of the
     card's segments within 1 px of a CPU segment;
 10. DemoFlag.FULL: the online run of the default seed at the line phase's
     widths and protocol (line mode's program with the keyframe images
     kept): the line phase's gates, and its timed poses equal to the line
     phase's default-seed run to 1e-6; fps printed. Then bench.py's dense
     protocol: FULL over the first 8 + 2 x 32 frames of the arc, then
     System.shutdown(semidense=True), timed between synchronises; the
     stages again from the same state with a synchronise between them
     (pass 1, the inter-keyframe check, 3D lines, TSDF, marching
     tetrahedra); one traced shutdown (kernel launches, host
     synchronisations); the counts of valid semi-dense points (gated
     above 0), 3D segments and triangles, beside the JAX reference's on
     the CPU (REFERENCE_DENSE: on this input it fits no multi-view segment
     and extracts no triangle). The same dense phase on the CPU from a
     checkpoint of the card's state and images must agree with the card's
     (DENSE_* tolerances). Then the reference's accuracy fixtures on the
     card (tests/test_semidense.py's four views, tests/test_mesh.py's flat
     wall, tests/test_lines3d.py's segment) and, printed, the cloud's
     quality against ray-cast depth (evaluation.evaluate_reconstruction,
     and the same ICP started from the keyframe trajectory's sim3);
 11. the interactive per-frame tracker, System(chunked=False), on the
     same arc at the main path's widths (loop closing and the BoW
     vocabulary on), every frame through track_monocular: geometry mode
     with RANSAC seeds 12345, 1 and 2, gated run by run on the frames
     tracked after initialization (>= 90 %) and the sim3 ATE of every
     tracked frame, and on their median, against the JAX reference's own
     spread on this protocol (reference_ate_spread.py --interactive, on
     the CPU); the default seed's run must train the vocabulary and hold
     every live keyframe in the BoW database. EAO mode on the default seed
     (8 boxes, 32 object slots): >= 3 live objects, one of each scene
     class, centre errors under 1.5 times the reference's on that seed.
     On the default seed's System after its pass: three blank frames must
     lose track, the frames from 40 on must relocalize through the BoW
     database within 5 frames, the recovered camera centre within 0.10 m
     of ground truth after the sim3 alignment of the 8 keyframes nearest
     it; then localization mode over frames 60-91 must keep the keyframe
     and live-point counts and track >= 90 %; then System.reset() and
     frames 0-40 must initialize again (state OK, >= 2 keyframes). On the
     chunked path: after the warm-up chunk, one chunk in localization mode
     adds no keyframe and tracks >= 90 %, and a checkpoint saved in that
     mode loads and resumes equal to 1e-5. The card against the CPU from
     the default seed's state after frame 100 (the same code, fed the
     card's ORB output): quantize's words and nodes exact; the next frame
     without a keyframe, one track step, integers exact and floats to
     1e-4; the next keyframe frame stage by stage from one state (pose
     tracking, insertion, triangulations, fusions, the duplicate merge,
     the windowed BA, then culling, the descriptor refresh and loop
     detection), integers exact, floats to 1e-4, except a stage's floats
     and the BA's results where the CPU's own difference with the poses
     one ulp up or on one thread is larger: there 4 times that.
     fast_nms_tile_max must be launched once per frame fed through
     track_monocular (before the card-against-CPU check). Printed: ms per
     frame (medians over non-keyframe and keyframe frames, host clock
     between synchronises) and the launches and host synchronisations of
     one traced frame of each kind;
 12. the command-line drivers: the arc's frames written as a TUM
     sequence directory (PNGs by viz.raster.save_png, rgb.txt,
     groundtruth.txt, yolo_txts/ holding the bench boxes in the
     offline-YOLO format), then `python -m eao_slam_torch.cli mono_tum EAO`
     (cli.main in a subprocess, on the card by default): the loader's
     decoder is printed; gates: >= 90 % of the frames after initialization
     tracked, >= 3 live objects, one of each scene class, the sim3 ATE of
     FrameTrajectory.txt under 1.5 times the reference's own run_mono_tum
     on the same directory (reference_ate_spread.py --cli, on the CPU:
     0.2590 m, over 0.185 m, so not the EAO per-run limit), and every export
     the run counted parses with the port's loaders (the dense exports are
     written only when they hold something, as in the reference). Then
     run_mono_kitti over 24 frames rendered with the KITTI00_02 camera
     (tests/test_kitti_euroc.py's scene and 18-degree arc; its gates: >= 8
     frames tracked, as many KITTI rows, the first pose the identity to
     1e-6) and run_mono_euroc over 24 frames rendered with the EuRoC
     camera (>= 8 tracked; its ATE printed: the renderer applies no lens
     distortion), undistort_points of one EuRoC frame's keypoints on the
     card against the CPU to 1e-5 px, and both FAST kernel entries bit-exact
     at the KITTI00_02 and EuRoC shapes (32 frames, 8 levels), timed;
     fast_nms_tile_max must be launched on each driver's run;
 13. the parallel layer: the loop circuit's global-BA problem (phase 6's
     loop run, recorded through a spy ba_solver: its keyframes and 8192
     points) solved on the card by bundle_adjust and local_ba; a chunk's
     features extracted in two halves must equal the whole chunk's bit for
     bit; the default seed's bootstrap, warm-up and PAR_CHUNKS chunks run
     again on the card (does the single-card run repeat itself bit for
     bit? if not, its run-to-run difference is the gate below) and the
     tilted arc tracked alone for PAR_ENGINE_ROUNDS chunks. Then the script
     starts itself as ranks (``--parallel-rank``, through
     parallel.distributed.initialize_from_env and the EAO_* variables):
     NCCL at one rank on the card, where dist_ba, dist_ba2 direct and cg
     on the recorded problem and batch_bundle_adjust over PAR_BATCH
     synthetic problems are held to the single-card solves (PAR_*
     tolerances) and ba_solver is None; then two gloo ranks sharing the
     card: the same solvers and the 5 + 10 ba_solver of a meshed tracker,
     the ranks equal; System(mesh=...) over the default seed's bootstrap,
     warm-up and PAR_CHUNKS chunks equal to the single card's run of the
     same frames, on both ranks; a MultiSeqEngine with the arc on rank 0
     and the tilted arc on rank 1, each sequence equal to its solo run
     and read the same by both ranks; fast_nms_tile_max launched on every
     rank. The phase's time and both backends are printed;
 14. print the host-clock time of each between-chunk pass (after a
     synchronise; medians where a pass repeats) and its share of a chunk,
     the card's name and power limit, one JSON line describing every
     kernel, and last the JSON result line.

Every frame the script renders (the arc, the tilted run, the drivers'
KITTI and EuRoC frames) is queued on one process pool when it starts: the
arc first, the rest rendering on the host's cores while the card runs the
earlier phases; the arc and the tilted run are kept for phase 13.

Needs a CUDA device and the rest of the repository beside this file.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# H100 SXM (NVIDIA data sheet): HBM rate and 132 SMs. Of integer compare,
# minimum and maximum an SM starts 64 per clock (the toolkit's table of
# arithmetic throughput for compute capability 9.0; tools/int_instr_rate.py
# measures 61.7 for the two-lane 16-bit forms). The clock is the maximum SM
# clock nvidia-smi reports.
PEAK_BYTES_PER_S = 3.35e12
SMS = 132
MINMAX_PER_SM_CLOCK = 64
BYTES_PER_PIXEL = {"fast_nms_comb": 8.0,            # one float32 read, one int32 written
                   "fast_nms_tile_max": 4.0 + 4.0 / 256}   # one int32 per 16 x 16 cell
# Integer min/max the function needs per pair of output pixels, in the widest
# form the card has (two 16-bit lanes, three inputs), whatever the tiling:
# both sides' runs of 3 (32) and arcs of 9 (32), down the 16 arcs (16), the
# larger side or 0 and the clamp (2), the 3x3 maximum across and down (2);
# the tile-max entry also takes each packed value into its cell's maximum (2).
MINMAX_PER_PAIR = {"fast_nms_comb": 84, "fast_nms_tile_max": 86}

# sim3 ATE of the timed frames, JAX reference on the CPU over RANSAC seeds
# 12345 (the default) and 1-19 (reference_ate_spread.py): worst 0.1863 m,
# median 0.1363 m. The port is held to 1.5 times each, on seven seeds.
SEEDS = (12345, 1, 2, 3, 4, 5, 6)
ATE_LIMIT_M = 1.5 * 0.1863
MEDIAN_ATE_LIMIT_M = 1.5 * 0.1363

# EAO phase: JAX reference in EAO mode on the CPU (reference_ate_spread.py
# --flag EAO), over seeds 12345 and 1-19: sim3 ATE worst 0.1847 m, median
# 0.1360 m; 3 live objects, one of each scene class (56, 62, 73), on every
# seed; the worst object-centre error (map_object_errors) over seeds 12345
# and 1-3, the seeds gated here (EAO_SEEDS), 0.3682 m (seed 2; per seed
# 0.2183, 0.1730, 0.3682, 0.2866 m). The port is held to 1.5 times each,
# the object centres on every run and every scene object.
EAO_ATE_LIMIT_M = 1.5 * 0.1847
EAO_MEDIAN_ATE_LIMIT_M = 1.5 * 0.1360
EAO_OBJECT_LIMIT_M = 1.5 * 0.3682
N_BOXES = 8
MIN_OBJECTS = 3

# line phase: JAX reference in LineAndiForest mode on the CPU
# (reference_ate_spread.py --flag LineAndiForest) over seeds 12345 and 1-19:
# sim3 ATE worst 0.1847 m (seed 2), median 0.1360 m; 128/128 tracked and 3
# live objects, one of each scene class, on every seed; the worst
# object-centre error over seeds 12345 and 1, the seeds gated here
# (LINE_SEEDS), 0.2183 m (seed 12345; seed 1 0.1730 m, seed 2 0.3682 m); the
# largest |yaw| an object with 3 or more votes elected, on those two
# seeds as on all twenty, 7.7586 degrees (a grid sample; the others
# elected 1.55 or 4.66). The port is held to 1.5 times each distance. Its
# elected yaws on the arc are printed against the larger of 8 degrees (the
# reference's own gate, tests/test_system_chunked.py) and the reference's
# worst plus 3.1 degrees, and not gated: on the card seed 5 elects -45
# degrees, and the reference's yaw functions elect the same on every one of
# that run's recorded yaw calls (port_ate_spread.py --record-yaw, then
# reference_ate_spread.py --replay-yaw; PERF.md, PR 6).
LINE_ATE_LIMIT_M = 1.5 * 0.1847
LINE_MEDIAN_ATE_LIMIT_M = 1.5 * 0.1360
LINE_OBJECT_LIMIT_M = 1.5 * 0.2183
LINE_YAW_LIMIT_DEG = max(8.0, 7.7586 + 3.1)
N_LINES = 128
TILT_DEG = (8.0, -6.0)       # roll, pitch of the ground-alignment run
TILT_FRAMES = 96
GROUND_TOL = 1e-4
# ground-alignment run: the JAX reference on the same tilted input
# (reference_ate_spread.py --flag LineAndiForest --ground), seeds 12345
# and 1-6: the first keyframe 6.8e-8 from its true pose on every seed,
# 84-93 of 96 frames tracked; the chair (class 56) collects 19-21 yaw votes
# and elects -23.28 (seeds 12345 and 5), -17.07, -13.97 or -10.86 degrees,
# class 62 -7.76 or -1.55 where it lives: the chair rule's bias on this
# view, beyond LINE_YAW_LIMIT_DEG in the reference itself. The port's yaws
# there are held to the reference's worst plus 3.1 degrees.
GROUND_REF_WORST_YAW_DEG = 23.2759
GROUND_YAW_LIMIT_DEG = max(LINE_YAW_LIMIT_DEG, GROUND_REF_WORST_YAW_DEG + 3.1)
CARD_CPU_FRAMES = (0, 60, 120)
# the geometry phase runs the first three seeds, the EAO phase the first
# four and the line phase the first two (seven, seven and five before the
# interactive phase came, which needed their time)
GEOMETRY_SEEDS = SEEDS[:3]
EAO_SEEDS = SEEDS[:4]
LINE_SEEDS = SEEDS[:2]

# FULL phase: bench.py's dense protocol (_semidense_numbers): FULL over the
# first 8 + 2 x 32 frames of the arc, then shutdown's offline dense phase.
# The JAX reference on the CPU on the same input (reference_ate_spread.py
# --dense): 17 keyframes, 7822 valid semi-dense points, 0 3D segments, 0
# triangles (REFERENCE_DENSE). The card is held to the port on the CPU
# from the same tracker state and images (a checkpoint): the edge pixels on
# >= 99.9 % of slots (a Sobel magnitude or a rounded projection one ulp
# across an integer moves one), validity on >= 99 %, the 3D segment count
# within 1 and each segment within 1e-4 m, the triangle count within 0.5 %
# and the mean distance from a card vertex to the nearest CPU vertex under
# 0.1 voxel. The inverse depths are held to the phase's own sensitivity on
# this input: the share of pixels valid in both whose inverse depths differ
# by more than 1e-4 relative may be at most twice (plus 0.5 %) the share by
# which the CPU run differs from itself when every keyframe pose moves by
# one ulp. On this input the sweep's score curves are flat and its
# Gauss-Newton refinement divides by small sums: a one-ulp pose change
# moves 6-7 % of the pixels beyond 1e-4 (measured on an NVIDIA H100 80GB
# HBM3 at 700 W); on the reference's 4-view fixture the card and the CPU
# differ there on 0.06 % of the pixels.
DENSE_FRAMES = 8 + 2 * 32
REFERENCE_DENSE = {"keyframes": 17, "semidense_valid": 7822, "segments": 0, "triangles": 0}
DENSE_PIXELS_AGREE = 0.999
DENSE_VALID_AGREE = 0.99
DENSE_RHO_RTOL = 1e-4
DENSE_RHO_NOISE_FACTOR = 2.0
DENSE_RHO_NOISE_MARGIN = 0.005
FULL_POSE_TOL = 1e-6

CHUNK = 32
N_TIMED = 4
N_FRAMES = 8 + CHUNK * (1 + N_TIMED)

# long run: the depth cut so that maintenance runs (headroom 16 keyframes,
# 3 x 1024 points); widths as on the main path
LONG_CAPACITY = dict(max_keyframes=48, max_points=6144, max_features=1024,
                     local_ba_points=2048)
JUMP_TO = 8                  # the frame of the arc the kidnap jumps to
RELOC_LIMIT_M = 0.10

# bench.py's loop circuit (bench.py:333-368)
CIRCUIT_FRAMES = 288
CIRCUIT_CHUNK = 8
CIRCUIT_CAPACITY = dict(max_keyframes=128, max_points=8192, max_features=512,
                        local_ba_points=2048)
CHECKPOINT_TOL = 1e-5

# the command-line drivers' phase (phase 12). The reference's own
# run_mono_tum on the same TUM directory, on the CPU
# (reference_ate_spread.py --cli): the ATE limit is the EAO per-run limit
# unless that run reads over 0.185 m, and then 1.5 times its reading.
STAMP0 = 1000.0
CLI_MIN_TRACKED = 0.9
REFERENCE_CLI = {"init_frame": 4, "tracked": 164, "total": 164, "ate_m": 0.2590,
                 "object_classes": [56, 62, 73], "keyframes": 34}
CLI_ATE_LIMIT_M = (EAO_ATE_LIMIT_M if REFERENCE_CLI["ate_m"] <= 0.185
                   else 1.5 * REFERENCE_CLI["ate_m"])
DRIVER_FRAMES = 24
DRIVER_SWEEP_DEG = 18.0
DRIVER_MIN_TRACKED = 8
KITTI_IDENTITY_TOL = 1e-6
UNDISTORT_TOL_PX = 1e-5
EUROC_STAMP0 = 1403636579000000000

_SCENES: dict = {}
RENDERS = None               # the script's render pool (Renders), while main runs
_RENDERED: dict = {}         # frames already rendered, by job name


def _set_scenes(scenes: dict) -> None:
    """Pool initializer: the scenes, and a lower priority than the main
    process, whose host loop drives the card while the pool renders."""
    _SCENES.update(scenes)
    os.nice(10)


def _render(task):
    """Pool worker: (scene name, camera, T_cw) -> the rendered grey image."""
    from eao_slam_torch.io.synthetic import render_image

    name, cam, T_cw = task
    return render_image(_SCENES[name], cam, T_cw)


def bench_scene():
    from eao_slam_torch.io.synthetic import make_room_scene

    return make_room_scene(seed=5, n_landmarks=200, n_objects=3, obj_z_range=(4.0, 5.2))


def driver_scene():
    """The KITTI and EuRoC drivers' room (tests/test_kitti_euroc.py's)."""
    from eao_slam_torch.io.synthetic import make_room_scene

    return make_room_scene(seed=5, n_landmarks=80, n_objects=0)


def _pool():
    return multiprocessing.get_context("spawn").Pool(
        min(8, os.cpu_count() or 1), initializer=_set_scenes,
        initargs=({"bench": bench_scene(), "drivers": driver_scene()},))


class Renders:
    """One process pool for every frame the script renders: the jobs are
    queued in order when it starts (the arc first), so the later ones render
    on the host's cores while the card runs the earlier phases. ``get(name)``
    waits for one job's frames."""

    def __init__(self, jobs: dict):
        self.t0 = time.perf_counter()
        self.pool = _pool()
        self.done = {}
        self.pending = {name: self.pool.map_async(
            _render, tasks, callback=lambda _, name=name: self._finished(name))
            for name, tasks in jobs.items()}

    def _finished(self, name: str) -> None:
        self.done[name] = time.perf_counter() - self.t0

    def get(self, name: str) -> np.ndarray:
        t = time.perf_counter()
        images = np.stack(self.pending.pop(name).get())
        print(f"render pool: {name} ({len(images)} frames) rendered {self.done[name]:.1f} s "
              f"after the pool started; waited {time.perf_counter() - t:.1f} s for it")
        return images

    def close(self) -> None:
        self.pool.terminate()
        self.pool.join()


def rendered(name: str, tasks: list) -> np.ndarray:
    """The frames of ``tasks`` ((scene name, camera, T_cw) each): the render
    pool's job ``name`` while main runs, else rendered now; kept for a later
    phase that asks again."""
    if name in _RENDERED:
        return _RENDERED[name]
    if RENDERS is not None and name in RENDERS.pending:
        _RENDERED[name] = RENDERS.get(name)
        return _RENDERED[name]
    t0 = time.perf_counter()
    with _pool() as pool:
        images = np.stack(pool.map(_render, tasks))
    print(f"rendered {len(images)} frames ({name}) in {time.perf_counter() - t0:.1f} s")
    _RENDERED[name] = images
    return images


def pool_map(fn, tasks: list) -> list:
    """``fn`` over ``tasks`` in the render pool (a pool of its own when
    main is not running)."""
    if RENDERS is not None:
        return RENDERS.pool.map(fn, tasks)
    with _pool() as pool:
        return pool.map(fn, tasks)


def bench_boxes(gt) -> list:
    """bench.py's detector boxes: the port's project_boxes of the scene's
    cuboids, N_BOXES slots a frame."""
    from eao_slam_torch.geometry.camera import TUM3
    from eao_slam_torch.io.synthetic import project_boxes

    scene = bench_scene()
    return [project_boxes(scene, TUM3, T, N_BOXES) for T in gt]


def arc():
    from eao_slam_torch.io.synthetic import make_arc_trajectory

    return make_arc_trajectory(n_frames=N_FRAMES, sweep_deg=60.0)


def tilted_arc(gt):
    """The ground-alignment run's poses: the arc's first TILT_FRAMES with
    every camera tilted by TILT_DEG."""
    Q = _tilt(*TILT_DEG)
    return np.stack([np.concatenate([T[:3, :3] @ Q.T, T[:3, 3:4]], 1) for T in gt[:TILT_FRAMES]])


def driver_arc():
    from eao_slam_torch.io.synthetic import make_arc_trajectory

    return make_arc_trajectory(n_frames=DRIVER_FRAMES, sweep_deg=DRIVER_SWEEP_DEG)


def render_jobs() -> dict:
    """Every render job of the script, in the order the phases need them."""
    from eao_slam_torch.geometry.camera import EUROC, KITTI00_02, TUM3

    _, gt = arc()
    _, gt_d = driver_arc()
    return {"arc": [("bench", TUM3, T) for T in gt],
            "tilted": [("bench", TUM3, T) for T in tilted_arc(gt)],
            "kitti": [("drivers", KITTI00_02, T) for T in gt_d],
            "euroc": [("drivers", EUROC, T) for T in gt_d]}


def render_sequence(n_frames: int = None):
    """The bench arc (or its first n_frames), rendered with the port's own
    synthetic renderer."""
    ts, gt = arc()
    images = rendered("arc", render_jobs()["arc"])
    return ts[:n_frames], gt[:n_frames], images[:n_frames]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return float(out.stdout.strip().splitlines()[0].split()[0]) * 1e6


def bound_ms(name: str, levels, clock_hz: float):
    """The least time the card could take for this call: the bytes that must
    move at the HBM rate, or the integer min/max the function needs at 64 per
    SM per clock, whichever takes longer. Every pixel needs the same work,
    so the count does not depend on the data.
    Returns (ms, "bytes" or "operations")."""
    px = sum(x.numel() for x in levels)
    ops_s = px / 2 * MINMAX_PER_PAIR[name] / (MINMAX_PER_SM_CLOCK * SMS * clock_hz)
    bytes_s = px * BYTES_PER_PIXEL[name] / PEAK_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s > bytes_s else "bytes")


def check_fast_nms(inputs: dict, border: int, clock_hz: float) -> dict:
    """Both kernel entries against their plain versions on every input set
    (a tuple of [C, h, w] levels each): one launch for all levels and one
    launch per level, bit-exact or fail. Times are per call (all levels, one
    launch), from CUDA events after warm-up. Returns, per entry, the largest
    difference seen and the figures on each input set."""
    import torch

    from eao_slam_torch.ops import fast_nms

    entries = {
        "fast_nms_comb": (fast_nms.fast_nms_comb, fast_nms.fast_nms_comb_reference),
        "fast_nms_tile_max": (fast_nms.fast_nms_tile_max, fast_nms.fast_nms_tile_max_reference),
    }
    result = {}
    for name, (kernel, plain) in entries.items():
        r = result[name] = {"max_abs_err": 0, "by_input": {}}
        for tag, levels in inputs.items():
            got = kernel(levels, border)
            torch.cuda.synchronize()
            for x, g in zip(levels, got):
                h, w = x.shape[-2:]
                want = plain(x, border)
                alone = kernel(x, border)
                torch.cuda.synchronize()
                for what, other in (("its plain version", want), ("its one-level launch", alone)):
                    err = int((g.long() - other.long()).abs().max())
                    r["max_abs_err"] = max(r["max_abs_err"], err)
                    if err != 0 or g.shape != other.shape:
                        raise AssertionError(
                            f"{name} differs from {what} on {tag} levels at {h}x{w}: "
                            f"{int((g != other).sum())} values, max |diff| {err}")
            k = cuda_ms(lambda: kernel(levels, border))
            per_level = [cuda_ms(lambda x=x: kernel(x, border)) for x in levels]
            p = cuda_ms(lambda: [plain(x, border) for x in levels], warmup=1, iters=3)
            b, by = bound_ms(name, levels, clock_hz)
            print(f"{name} on {tag} levels, per call ({len(levels)} levels x {len(levels[0])} "
                  f"frames): kernel {k:.4f} ms in one launch ({sum(per_level):.4f} ms as "
                  f"{len(levels)} launches: {', '.join(f'{t:.4f}' for t in per_level)}), "
                  f"plain {p:.4f} ms, bound {b:.4f} ms by {by}, max |diff| {r['max_abs_err']}")
            r["by_input"][tag] = {"ms": k, "plain_ms": p, "bound_ms": b, "bound_by": by}
    return result


def kernel_inputs(images) -> dict:
    """The level sets the kernel is held on: random levels with a coarsely
    quantised half (plateaus exercise the >= tie rule of the NMS), and what
    the main path gives it: the pyramid of CHUNK rendered frames of the arc
    (a chunk) and of one rendered frame (a bootstrap frame)."""
    import torch

    from eao_slam_torch.ops.image import build_pyramid, level_sizes

    gen = torch.Generator(device="cuda").manual_seed(0)
    random = []
    for h, w in level_sizes(images.shape[1], images.shape[2], 8, 1.2):
        x = torch.randint(0, 256, (CHUNK, h, w), generator=gen, device="cuda").float()
        x[CHUNK // 2:] = torch.round(x[CHUNK // 2:] / 64) * 64
        random.append(x)
    frames = torch.as_tensor(images[8:8 + CHUNK], device="cuda").float()
    rendered = tuple(x.contiguous() for x in build_pyramid(frames, 8, 1.2))
    one_frame = tuple(x[:1].contiguous() for x in rendered)
    return {"random": tuple(random), "rendered": rendered, "one rendered frame": one_frame}


def centers(Ts):
    return np.einsum("nij,ni->nj", -Ts[:, :3, :3], Ts[:, :3, 3])


class PassTimer:
    """Host-clock times, each between two synchronises, of a ChunkedTracker's
    chunk tracking and of every between-chunk pass that did work: the
    wrappers replace the tracker's methods on the instance (the package is
    unchanged)."""

    def __init__(self, tracker):
        self.tracker = tracker
        self.times = {k: [] for k in ("chunk", "object merge", "maintenance",
                                      "loop pass, closure", "loop pass, no closure",
                                      "relocalization, success", "relocalization, failed")}
        for name in ("_extract_track", "_track_chunk"):
            setattr(tracker, name, self._timed(getattr(tracker, name), self._chunk))
        for name in ("_maybe_merge_objects", "_maybe_maintain", "_maybe_close_loops",
                     "_maybe_relocalize"):
            setattr(tracker, name, self._timed(getattr(tracker, name), getattr(self, name)))

    def _timed(self, fn, classify):
        def wrapped(*args, **kw):
            before = self._snapshot()
            sync(self.tracker.device)
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            sync(self.tracker.device)
            kind = classify(before)
            if kind is not None:
                self.times[kind].append(time.perf_counter() - t0)
            return out

        return wrapped

    def _snapshot(self):
        tr = self.tracker
        lc = tr.loop_closer
        return (tr.n_maintenance, tr._loop_checked, tr.kf_count_host,
                lc.closed_loops if lc is not None else 0, tr.state_host, tr.n_relocalized)

    def _chunk(self, before):
        return "chunk"

    def _maybe_merge_objects(self, before):
        return "object merge" if self.tracker.carry.table is not None else None

    def _maybe_maintain(self, before):
        return "maintenance" if self.tracker.n_maintenance > before[0] else None

    def _maybe_close_loops(self, before):
        if self.tracker.loop_closer is None or before[2] <= before[1]:
            return None        # no new keyframe: the pass returned at once
        closed = self.tracker.loop_closer.closed_loops > before[3]
        return "loop pass, closure" if closed else "loop pass, no closure"

    def _maybe_relocalize(self, before):
        if before[4] != 3:     # not LOST: the pass returned at once
            return None
        ok = self.tracker.n_relocalized > before[5]
        return "relocalization, success" if ok else "relocalization, failed"

    def summary(self) -> dict:
        chunk = float(np.median(self.times["chunk"])) if self.times["chunk"] else None
        out = {}
        for kind, ts in self.times.items():
            if ts:
                med = float(np.median(ts))
                out[kind] = {"n": len(ts), "median_s": med, "max_s": float(max(ts)),
                             "share_of_chunk": (med / chunk) if kind != "chunk" else 1.0}
        return out


def print_passes(tag: str, timer: PassTimer) -> dict:
    summ = timer.summary()
    for kind, v in summ.items():
        print(f"{tag}: {kind}: {v['n']} x, median {v['median_s'] * 1e3:.1f} ms "
              f"(max {v['max_s'] * 1e3:.1f} ms), {100 * v['share_of_chunk']:.1f} % of a "
              f"chunk's tracking")
    return summ


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main_config(seed: int, objects: bool = False, flag: str = None):
    """The main path's configuration (bench.py's widths, the default
    TrackingConfig: loop closing on) with the given RANSAC seed; with
    ``objects`` an object-layer flag (DemoFlag.EAO unless ``flag`` names
    another) with N_BOXES boxes and 32 object slots."""
    from eao_slam_torch.config import CapacityConfig, DemoFlag, tum3_config

    flag = DemoFlag(flag) if flag else (DemoFlag.EAO if objects else DemoFlag.NONE)
    return tum3_config(flag).replace(
        capacity=CapacityConfig(max_keyframes=128, max_points=8192,
                                max_features=1024, local_ba_points=2048,
                                **(dict(max_boxes=N_BOXES, max_objects=32) if objects else {})),
        seed=seed)


def run_main_path(ts, gt, images, seed: int, boxes=None, device: str = "cuda",
                  flag: str = None) -> dict:
    """Bootstrap, warm-up and timed chunks through System.track_monocular
    with the given RANSAC seed: geometry mode, or with ``boxes`` (one
    detector tuple per frame) an object-layer flag (DemoFlag.EAO unless
    ``flag`` names another, such as "LineAndiForest") with N_BOXES boxes
    and 32 object slots. Returns the tracked frames, sim3 ATE, fps and poses
    of the timed chunks and the pass timer; with the object layer also the
    live objects, each scene object's centre error, their elected yaws and
    yaw votes, and the merges and kills of the merge pass.
    ``device="cpu"`` runs the port on the host (port_ate_spread.py)."""
    from eao_slam_torch.system import System

    sysm = System(main_config(seed, boxes is not None, flag), chunk=CHUNK, device=device)
    timer = PassTimer(sysm.tracker)
    out = _drive_main_path(sysm, ts, gt, images, boxes, seed)
    out["timer"] = timer
    return out


def _drive_main_path(sysm, ts, gt, images, boxes, seed) -> dict:
    from eao_slam_torch.io.trajectory import ate_rmse

    objects = boxes is not None

    def feed(k):
        sysm.track_monocular(images[k], float(ts[k]), boxes=boxes[k] if objects else None)

    i = 0
    while i < len(images) and not sysm.tracker.armed:
        feed(i)
        i += 1
    if not sysm.tracker.armed:
        raise AssertionError("two-view initialization never succeeded")
    n_boot = i
    # one warm-up chunk; a bootstrap longer than 8 frames cuts it (padded
    # tail chunk) so the timed chunks fit the arc, as in reference_ate_spread.py
    n_warm = min(CHUNK, N_FRAMES - N_TIMED * CHUNK - n_boot)
    if n_warm <= 0:
        raise AssertionError(f"bootstrap took {n_boot} frames; the arc has {len(images)}")
    for _ in range(n_warm):
        feed(i)
        i += 1
    sysm.flush()
    sync(sysm.device)
    lo = i
    t0 = time.perf_counter()
    for _ in range(N_TIMED * CHUNK):
        feed(i)
        i += 1
    sync(sysm.device)
    dt = time.perf_counter() - t0

    recs = sysm.tracker.records[lo:i]
    assert len(recs) == N_TIMED * CHUNK, len(recs)
    ok = np.array([r[1] is not None for r in recs])
    poses = np.stack([r[1] for r in recs if r[1] is not None])
    if not np.isfinite(poses).all():
        raise AssertionError("non-finite poses")
    ate = ate_rmse(centers(poses), centers(gt[lo:i][ok]), with_scale=True)
    tracked = int(ok.sum())
    total = N_TIMED * CHUNK
    fps = total / dt
    loops = sysm.tracker.loop_closer.closed_loops
    out = {"seed": seed, "fps": fps, "tracked": tracked, "total": total, "ate_m": ate,
           "loops": loops, "poses": poses, "n_boot": n_boot, "n_warm": n_warm,
           "frame_trajectory": sysm.tracker.frame_trajectory()}
    flag = sysm.cfg.flag
    tag = f"{'' if flag.name == 'NONE' else flag.name + ' '}seed {seed}"
    if objects:
        out.update(object_results(sysm.tracker, ts, gt))
        tag += (f": {out['objects']} live objects of the scene's classes (classes "
                f"{out['object_classes']}), centre errors "
                f"{', '.join(f'{e:.3f}' for e in out['object_centre_err_m'])} m (after a sim3 "
                f"of the keyframe trajectory, ungated: "
                f"{', '.join(f'{e:.3f}' for e in out['object_centre_err_sim3_m'])} m), merges "
                f"{out['merges']}, kills {out['kills']}, object keyframes "
                f"{out['object_keyframes']}")
        if flag.use_yaw_lines:
            tag += ", yaws " + ", ".join(f"{o['cls']}: {o['yaw_deg']:.2f} deg ({o['votes']:.0f} "
                                         f"votes)" for o in out["object_yaws"])
    print(f"{tag}: bootstrap {n_boot} frames, {tracked}/{total} timed frames tracked, "
          f"sim3 ATE {ate:.4f} m, {fps:.2f} fps over {N_TIMED} timed chunks ({dt:.3f} s), "
          f"keyframes {sysm.tracker.kf_count_host}, points {sysm.tracker.pt_count_host}, "
          f"loops closed {loops}")
    return out


def object_results(tracker, ts, gt) -> dict:
    """The live objects of the scene's classes, whether every scene class
    has one, each scene object's centre error (map_object_errors: in the
    camera frames of the keyframes that observed the object, at the map's
    scale), and each live object's elected yaw and yaw votes."""
    from eao_slam_torch.io.trajectory import map_object_errors, object_yaws, sim3_object_errors

    scene = bench_scene()
    tab = {k: v.cpu().numpy() for k, v in tracker.obj_table._asdict().items()}
    m = {k: v.cpu().numpy() for k, v in tracker.map._asdict().items()}
    live = tab["valid"] & ~tab["bad"] & np.isin(tab["cls"], scene.obj_classes)
    cls = tab["cls"][live]
    return {"objects": int(live.sum()), "object_classes": sorted(int(c) for c in cls),
            "every_class": set(scene.obj_classes.tolist()) <= set(cls.tolist()),
            "object_centre_err_m": map_object_errors(m, tab, ts, gt, scene.obj_centers,
                                                     scene.obj_classes),
            "object_centre_err_sim3_m": sim3_object_errors(m, tab, ts, gt, scene.obj_centers),
            "merges": tracker.n_object_merges, "kills": tracker.n_object_kills,
            "object_keyframes": int(m["kf_by_object"].sum()), "object_yaws": object_yaws(tab)}


def check_run(run: dict, ate_limit: float = ATE_LIMIT_M) -> None:
    if run["tracked"] < int(0.9 * run["total"]):
        raise AssertionError(f"seed {run['seed']}: tracking collapsed: "
                             f"{run['tracked']}/{run['total']}")
    if not run["ate_m"] < ate_limit:
        raise AssertionError(f"seed {run['seed']}: trajectory drifted: sim3 ATE "
                             f"{run['ate_m']:.4f} m >= {ate_limit:.4f} m")


def check_eao_run(run: dict, ate_limit: float = EAO_ATE_LIMIT_M,
                  object_limit: float = EAO_OBJECT_LIMIT_M, tag: str = "EAO") -> None:
    check_run(run, ate_limit)
    if run["objects"] < MIN_OBJECTS or not run["every_class"]:
        raise AssertionError(f"{tag} seed {run['seed']}: live objects of classes "
                             f"{run['object_classes']}: fewer than {MIN_OBJECTS}, or a scene "
                             f"object without one")
    worst = max(run["object_centre_err_m"])
    if not worst < object_limit:
        raise AssertionError(f"{tag} seed {run['seed']}: object centre error {worst:.3f} m >= "
                             f"{object_limit:.3f} m")


def yaws_beyond(yaws: list, limit_deg: float) -> list:
    """The objects with 3 or more yaw votes whose elected yaw lies beyond
    ``limit_deg`` of the scene's 0."""
    return [o for o in yaws if o["votes"] >= 3 and not abs(o["yaw_deg"]) <= limit_deg]


def check_yaws(yaws: list, tag: str, limit_deg: float = None) -> None:
    """Yaw evidence reached the table, and, given ``limit_deg``, every
    object with 3 or more votes elected a yaw within it."""
    if not sum(o["votes"] for o in yaws) > 0:
        raise AssertionError(f"{tag}: no yaw votes")
    bad = yaws_beyond(yaws, limit_deg) if limit_deg is not None else []
    if bad:
        raise AssertionError(f"{tag}: elected yaws beyond {limit_deg:.2f} deg: {bad}")


def check_line_run(run: dict) -> None:
    """The EAO gates at the line limits and yaw votes above 0; the objects
    whose elected yaw lies beyond LINE_YAW_LIMIT_DEG are printed (see the
    constant)."""
    tag = f"LineAndiForest seed {run['seed']}"
    check_eao_run(run, LINE_ATE_LIMIT_M, LINE_OBJECT_LIMIT_M, "LineAndiForest")
    check_yaws(run["object_yaws"], tag)
    beyond = yaws_beyond(run["object_yaws"], LINE_YAW_LIMIT_DEG)
    print(f"{tag}: supported yaws beyond {LINE_YAW_LIMIT_DEG:.2f} deg: {beyond or 'none'}")


def iforest_cull_ms(tracker) -> float:
    """The chunk-rate iForest cull alone, on the tracker's final state (the
    objects its last chunk updated), between synchronises: median of 5
    calls after one warm-up, draws from a generator of their own."""
    import torch

    from eao_slam_torch.objects.association import N_OBJ_SAMPLE, chunk_iforest_cull
    from eao_slam_torch.objects.iforest import draw_iforest, psi_depth_for

    c = tracker.carry
    psi, depth = psi_depth_for(N_OBJ_SAMPLE)
    gen = torch.Generator().manual_seed(0)
    times = []
    for _ in range(6):
        sync(tracker.device)
        t0 = time.perf_counter()
        chunk_iforest_cull(tracker.cfg.camera, c.m, c.table, c.T_last, c.frame_id - CHUNK + 1,
                           lambda mask: draw_iforest(gen, mask, psi, depth), depth)
        sync(tracker.device)
        times.append(time.perf_counter() - t0)
    return float(np.median(times[1:])) * 1e3


def run_eao(ts, gt, images, geometry: dict) -> dict:
    """The EAO phase: the default seed (fps, the kernel's launch count, the
    object layer's cost against ``geometry``, the geometry run of the same
    seed), then the other seeds."""
    from eao_slam_torch.ops import fast_nms

    boxes = bench_boxes(gt)
    fast_nms.reset_launches()
    first = run_main_path(ts, gt, images, SEEDS[0], boxes=boxes)
    launches = dict(fast_nms.launches)
    print(f"EAO path: launches {launches}")
    if launches["fast_nms_tile_max"] <= 0:
        raise AssertionError("the EAO path never launched fast_nms_tile_max")
    check_eao_run(first)
    chunk = {k: float(np.median(r["timer"].times["chunk"][-N_TIMED:])) * 1e3
             for k, r in (("eao", first), ("geometry", geometry))}
    same = first["poses"].shape == geometry["poses"].shape
    pose_diff = float(np.abs(first["poses"] - geometry["poses"]).max()) if same else float("inf")
    cull_ms = iforest_cull_ms(first["timer"].tracker)
    merge_ms = [t * 1e3 for t in first["timer"].times["object merge"]]
    layer = {"eao_chunk_ms": chunk["eao"], "geometry_chunk_ms": chunk["geometry"],
             "object_layer_ms": chunk["eao"] - chunk["geometry"], "iforest_cull_ms": cull_ms,
             "object_pass_ms": chunk["eao"] - chunk["geometry"] - cull_ms,
             "merge_ms": float(np.median(merge_ms)), "eao_vs_geometry_max_pose_diff": pose_diff}
    print(f"EAO, default seed: a timed chunk of {CHUNK} frames takes {chunk['eao']:.1f} ms against "
          f"{chunk['geometry']:.1f} ms in geometry mode (medians, host clock between "
          f"synchronises; timed poses differ by at most {pose_diff:.3g}): the object layer "
          f"{layer['object_layer_ms']:.1f} ms a chunk: the iForest cull {cull_ms:.1f} ms "
          f"(alone, on the final state), the per-frame object pass the other "
          f"{layer['object_pass_ms']:.1f} ms; merge pass median {layer['merge_ms']:.1f} ms "
          f"over {len(merge_ms)} passes")
    runs = [first]
    for seed in EAO_SEEDS[1:]:
        runs.append(run_main_path(ts, gt, images, seed, boxes=boxes))
        check_eao_run(runs[-1])
    median_ate = float(np.median([r["ate_m"] for r in runs]))
    print(f"EAO over seeds {list(EAO_SEEDS)}: sim3 ATE median {median_ate:.4f} m, worst "
          f"{max(r['ate_m'] for r in runs):.4f} m; objects {[r['objects'] for r in runs]}; "
          f"object centre error worst {max(max(r['object_centre_err_m']) for r in runs):.3f} m "
          f"(limit {EAO_OBJECT_LIMIT_M:.3f} m); fps {[round(r['fps'], 2) for r in runs]}; "
          f"merges {[r['merges'] for r in runs]}, kills {[r['kills'] for r in runs]} per run")
    if not median_ate < EAO_MEDIAN_ATE_LIMIT_M:
        raise AssertionError(f"EAO median sim3 ATE {median_ate:.4f} m >= "
                             f"{EAO_MEDIAN_ATE_LIMIT_M:.4f} m")
    return {"fps": first["fps"], "launches": launches, "median_ate_m": median_ate,
            "by_seed": {r["seed"]: {k: r[k] for k in ("fps", "tracked", "total", "ate_m",
                                                     "objects", "object_classes",
                                                     "object_centre_err_m",
                                                     "object_centre_err_sim3_m", "merges", "kills",
                                                     "object_keyframes")}
                        for r in runs},
            "default_seed": layer, "eao_chunk_ms": chunk["eao"]}


def _tilt(deg_roll: float, deg_pitch: float) -> np.ndarray:
    """The world-frame tilt of tests/test_ground_alignment.py: Rx(roll) Ry(pitch)."""
    a, b = np.deg2rad(deg_roll), np.deg2rad(deg_pitch)
    Rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
    Ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0], [-np.sin(b), 0, np.cos(b)]])
    return Rx @ Ry


LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")
RUNTIME_SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def traced_calls(fn) -> dict:
    """Kernel launches, host synchronisations and copies between host and
    card of one call of ``fn``, counted from a torch.profiler trace (the
    CUDA runtime calls, and the copies the card ran: a copy from pageable
    host memory waits for the stream), less those of an empty traced call
    (the profiler synchronises once itself)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def count(f):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            f()
        torch.cuda.synchronize()
        ev = prof.key_averages()
        return {"launches": sum(e.count for e in ev if e.key in LAUNCH_CALLS),
                "syncs": sum(e.count for e in ev if e.key in RUNTIME_SYNCS),
                "host_copies": sum(e.count for e in ev
                                   if e.key.startswith(("Memcpy HtoD", "Memcpy DtoH")))}

    got, empty = count(fn), count(lambda: None)
    return {k: got[k] - empty[k] for k in got}


def detector_launches(imgs) -> int:
    """Kernel launches of one detect_segments call on ``imgs`` (None when
    the trace records none)."""
    from eao_slam_torch.ops.lines import detect_segments

    return traced_calls(lambda: detect_segments(imgs, max_lines=N_LINES))["launches"] or None


def yaw_pass_trace(tracker, image, boxes) -> dict:
    """traced_calls of one frame's yaw pass (yaw_sample_scores, then
    update_yaw) on the tracker's final object table and pose, with the
    line segments of ``image`` and its detector boxes, each box aimed at
    the first live object of its class, after one untraced call."""
    import torch

    from eao_slam_torch.objects.yaw import update_yaw, yaw_sample_scores
    from eao_slam_torch.ops.lines import detect_segments

    table = tracker.obj_table
    dev = table.cls.device
    live = (table.valid & ~table.bad).cpu().numpy()
    cls = table.cls.cpu().numpy()
    bx, bcls, _, bvalid = boxes
    targets = torch.as_tensor([int(np.flatnonzero(live & (cls == c))[0])
                               if v and (live & (cls == c)).any() else -1
                               for c, v in zip(bcls, bvalid)], device=dev)
    bx = torch.as_tensor(np.asarray(bx, np.float32), device=dev)
    lines, lv = (x[0] for x in detect_segments(
        torch.as_tensor(image, device=dev).float()[None], max_lines=N_LINES))
    args = (tracker.cfg.camera, table, targets, bx, tracker.carry.T_last, lines, lv)

    def yaw_pass():
        return update_yaw(table, targets, *yaw_sample_scores(*args))

    yaw_pass()
    return traced_calls(yaw_pass)


def run_ground_alignment(ts, gt) -> dict:
    """LINE_IFOREST on the first TILT_FRAMES frames of the arc with every
    camera tilted, the ground truth fed through System.set_groundtruth
    from a TUM file written by save_tum: the first keyframe must land on
    the initializer frame's true T_cw, and the yaws hold
    GROUND_YAW_LIMIT_DEG about gravity."""
    import tempfile

    from eao_slam_torch.config import CapacityConfig, DemoFlag, tum3_config
    from eao_slam_torch.geometry.camera import TUM3
    from eao_slam_torch.io.synthetic import project_boxes
    from eao_slam_torch.io.trajectory import object_yaws, save_tum
    from eao_slam_torch.system import System

    gt_t = tilted_arc(gt)
    images = rendered("tilted", render_jobs()["tilted"])
    scene = bench_scene()
    boxes = [project_boxes(scene, TUM3, T, N_BOXES) for T in gt_t]
    cfg = tum3_config(DemoFlag.LINE_IFOREST).replace(capacity=CapacityConfig(
        max_keyframes=128, max_points=8192, max_features=1024, local_ba_points=2048,
        max_boxes=N_BOXES, max_objects=32))
    sysm = System(cfg, chunk=CHUNK)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "groundtruth.txt")
        save_tum(path, ts[:TILT_FRAMES], gt_t)
        sysm.set_groundtruth(path)
    kf0 = None
    for k in range(TILT_FRAMES):
        sysm.track_monocular(images[k], float(ts[k]), boxes=boxes[k])
        if kf0 is None and sysm.tracker.armed:
            inner = sysm.tracker.inner
            slot = inner.kf_slots[0]
            kf0 = (float(inner.map.kf_timestamp[slot]), inner.map.kf_pose[slot].cpu().numpy())
    sysm.flush()
    if kf0 is None:
        raise AssertionError("ground-alignment run: two-view initialization never succeeded")
    i0 = int(np.argmin(np.abs(ts - kf0[0])))
    err = float(np.abs(kf0[1] - gt_t[i0]).max())
    kts, kT = sysm.keyframe_trajectory()
    err_end = float(np.abs(kT[0] - gt_t[int(np.argmin(np.abs(ts - kts[0])))]).max())
    tab = {k: v.cpu().numpy() for k, v in sysm.tracker.obj_table._asdict().items()}
    yaws = object_yaws(tab)
    tracked = len(sysm.frame_trajectory()[0])
    print(f"ground alignment: {TILT_FRAMES} frames tilted by roll {TILT_DEG[0]} and pitch "
          f"{TILT_DEG[1]} deg, {tracked} tracked; first keyframe "
          f"(frame {i0}) against its true T_cw: max |diff| {err:.3g} after the bootstrap, "
          f"{err_end:.3g} at the end; yaws "
          + ", ".join(f"{o['cls']}: {o['yaw_deg']:.2f} deg ({o['votes']:.0f} votes)" for o in yaws))
    if not err <= GROUND_TOL:
        raise AssertionError(f"ground alignment: first keyframe {err:.3g} from its true pose")
    check_yaws(yaws, "ground alignment", GROUND_YAW_LIMIT_DEG)
    return {"frames": TILT_FRAMES, "tracked": tracked, "init_frame": i0,
            "first_kf_max_abs_diff": err, "first_kf_max_abs_diff_end": err_end,
            "object_yaws": yaws}


def card_against_cpu(images) -> dict:
    """detect_segments on the card and on the CPU on CARD_CPU_FRAMES: valid
    counts within 2, and >= 90 % of the card's valid segments within 1 px
    (both endpoints, either direction) of a valid CPU segment."""
    import torch

    from eao_slam_torch.ops.lines import detect_segments

    x = np.stack([images[k] for k in CARD_CPU_FRAMES]).astype(np.float32)
    sc, vc = (a.cpu().numpy() for a in detect_segments(torch.as_tensor(x, device="cuda"),
                                                       max_lines=N_LINES))
    sh, vh = (a.numpy() for a in detect_segments(torch.as_tensor(x), max_lines=N_LINES))
    out = []
    for k, a, va, b, vb in zip(CARD_CPU_FRAMES, sc, vc, sh, vh):
        a, b = a[va], b[vb]
        d = np.abs(a[:, None] - b[None]).max(-1)
        flip = np.abs(a[:, None] - b[None][..., [2, 3, 0, 1]]).max(-1)
        matched = float((np.minimum(d, flip) <= 1.0).any(1).mean()) if len(a) else 1.0
        out.append({"frame": k, "card_valid": int(va.sum()), "cpu_valid": int(vb.sum()),
                    "matched": matched})
    print("detector, card against CPU: " + "; ".join(
        f"frame {o['frame']}: {o['card_valid']} / {o['cpu_valid']} valid, "
        f"{100 * o['matched']:.1f} % matched" for o in out))
    for o in out:
        if abs(o["card_valid"] - o["cpu_valid"]) > 2 or o["matched"] < 0.9:
            raise AssertionError(f"detector: card and CPU disagree on frame {o['frame']}: {o}")
    return {"frames": out}


def run_lines(ts, gt, images, geometry: dict, eao: dict) -> dict:
    """The line phase: the detector alone (valid lines per frame over the
    arc, CUDA-event time and launches per chunk), the default seed (fps,
    the FAST kernel's launches, the line layer's cost against the EAO
    chunk of the same seed), the other LINE_SEEDS, the ground-alignment run, and the
    card against the CPU."""
    import torch

    from eao_slam_torch.ops import fast_nms
    from eao_slam_torch.ops.lines import detect_segments

    chunk_imgs = torch.as_tensor(images[8:8 + CHUNK], device="cuda").float()
    det_ms = cuda_ms(lambda: detect_segments(chunk_imgs, max_lines=N_LINES), warmup=1, iters=5)
    det_launches = detector_launches(chunk_imgs)
    valid = []
    for lo in range(0, len(images), CHUNK):
        x = torch.as_tensor(images[lo:lo + CHUNK], device="cuda").float()
        valid.append(detect_segments(x, max_lines=N_LINES)[1].sum(1).cpu().numpy())
    valid = np.concatenate(valid)
    print(f"line detector: {float(np.median(valid)):.1f} valid lines per frame (median over "
          f"{len(valid)} frames, range {int(valid.min())}-{int(valid.max())}); a chunk of "
          f"{CHUNK} frames in {det_ms:.2f} ms (CUDA events), {det_launches} kernel launches")

    boxes = bench_boxes(gt)

    fast_nms.reset_launches()
    first = run_main_path(ts, gt, images, SEEDS[0], boxes=boxes, flag="LineAndiForest")
    launches = dict(fast_nms.launches)
    print(f"line path: launches {launches}")
    if launches["fast_nms_tile_max"] <= 0:
        raise AssertionError("the line path never launched fast_nms_tile_max")
    check_line_run(first)
    yaw_pass = yaw_pass_trace(first["timer"].tracker, images[-1], boxes[-1])
    print(f"yaw pass of one frame (default seed's final state, the arc's last frame): "
          f"{yaw_pass['launches']} kernel launches, {yaw_pass['syncs']} host synchronisations, "
          f"{yaw_pass['host_copies']} copies between host and card")
    if yaw_pass["launches"] <= 0 or yaw_pass["syncs"] or yaw_pass["host_copies"]:
        raise AssertionError(f"the yaw pass must launch kernels, and neither synchronise "
                             f"with the host nor copy to or from it: {yaw_pass}")
    line_chunk = float(np.median(first["timer"].times["chunk"][-N_TIMED:])) * 1e3
    layer = line_chunk - eao["eao_chunk_ms"]
    print(f"LineAndiForest, default seed: a timed chunk of {CHUNK} frames takes {line_chunk:.1f} "
          f"ms against {eao['eao_chunk_ms']:.1f} ms in EAO mode (medians, host clock between "
          f"synchronises): the line layer {layer:.1f} ms a chunk; LineAndiForest "
          f"{first['fps']:.2f} fps, EAO {eao['fps']:.2f} fps, geometry {geometry['fps']:.2f} fps")
    runs = [first]
    for seed in LINE_SEEDS[1:]:
        runs.append(run_main_path(ts, gt, images, seed, boxes=boxes, flag="LineAndiForest"))
        check_line_run(runs[-1])
    median_ate = float(np.median([r["ate_m"] for r in runs]))
    worst_yaw = max([abs(o["yaw_deg"]) for r in runs for o in r["object_yaws"] if o["votes"] >= 3],
                    default=None)
    n_beyond = sum(bool(yaws_beyond(r["object_yaws"], LINE_YAW_LIMIT_DEG)) for r in runs)
    print(f"LineAndiForest over seeds {list(LINE_SEEDS)}: sim3 ATE median {median_ate:.4f} m "
          f"(limit {LINE_MEDIAN_ATE_LIMIT_M:.4f} m), worst {max(r['ate_m'] for r in runs):.4f} m "
          f"(limit {LINE_ATE_LIMIT_M:.4f} m); objects {[r['objects'] for r in runs]}; object "
          f"centre error worst {max(max(r['object_centre_err_m']) for r in runs):.3f} m (limit "
          f"{LINE_OBJECT_LIMIT_M:.3f} m); supported yaw worst {worst_yaw} deg, {n_beyond} of "
          f"{len(runs)} runs beyond {LINE_YAW_LIMIT_DEG:.2f} deg (printed, not gated); fps "
          f"{[round(r['fps'], 2) for r in runs]}")
    if not median_ate < LINE_MEDIAN_ATE_LIMIT_M:
        raise AssertionError(f"LineAndiForest median sim3 ATE {median_ate:.4f} m >= "
                             f"{LINE_MEDIAN_ATE_LIMIT_M:.4f} m")
    return {"fps": first["fps"], "launches": launches, "median_ate_m": median_ate,
            "default_poses": first["poses"], "worst_supported_yaw_deg": worst_yaw,
            "runs_with_yaw_beyond_limit": n_beyond,
            "yaw_pass": yaw_pass,
            "by_seed": {r["seed"]: {k: r[k] for k in ("fps", "tracked", "total", "ate_m",
                                                     "objects", "object_classes",
                                                     "object_centre_err_m", "object_yaws",
                                                     "merges", "kills")}
                        for r in runs},
            "detector": {"valid_lines_median": float(np.median(valid)),
                         "chunk_ms": det_ms, "launches_per_chunk": det_launches},
            "line_chunk_ms": line_chunk, "line_layer_ms": layer,
            "ground_alignment": run_ground_alignment(ts, gt),
            "card_against_cpu": card_against_cpu(images)}


def full_config():
    from eao_slam_torch.config import CapacityConfig, DemoFlag, tum3_config

    return tum3_config(DemoFlag.FULL).replace(capacity=CapacityConfig(
        max_keyframes=128, max_points=8192, max_features=1024, local_ba_points=2048,
        max_boxes=N_BOXES, max_objects=32))


def dense_stage_times(sysm) -> dict:
    """The offline dense phase once more from the System's state, stage by
    stage with a synchronise between stages (host clock): pass 1 (sweeps
    and fusion), the inter-keyframe check, 3D lines, the TSDF (densify and
    fuse), marching tetrahedra. Returns seconds per stage."""
    import torch

    from eao_slam_torch.dense import mesh, semidense

    cam = sysm.cfg.camera
    dev = sysm.device
    times = {}

    def timed(name, fn):
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        times[name] = time.perf_counter() - t0
        return out

    slots, imgs, poses, ranges, nbs = sysm.semidense_inputs()
    I = torch.as_tensor(imgs, device=dev)
    T = torch.as_tensor(poses, device=dev)
    px, rho, sig, val = timed("pass 1", lambda: semidense.sweep_and_fuse(
        cam, I, T, ranges, nbs, sysm.cfg.semidense))
    rho, val = timed("inter-keyframe check", lambda: semidense.cross_check(
        cam, T, nbs, px, rho, sig, val, cam.height, cam.width))
    res = semidense.SemiDenseResult(px, rho, sig, val, semidense.backproject(cam, T, px, rho))
    timed("3D lines", sysm._run_lines3d)
    pts = res.points_w[res.valid].cpu().numpy()
    lo = np.percentile(pts, 2, axis=0) - 0.2
    hi = np.percentile(pts, 98, axis=0) + 0.2
    voxel = np.float32((hi - lo).max() / 95)
    origin = torch.as_tensor(np.asarray(lo, np.float32), device=dev)

    def tsdf():
        dms = torch.stack([mesh.densify_depth(res.pixels[k], res.inv_depth[k], res.valid[k],
                                              cam.height, cam.width) for k in range(len(slots))])
        return mesh.tsdf_fuse(cam, dms, T, origin, voxel)

    field, weight = timed("TSDF", tsdf)
    timed("marching tetrahedra", lambda: mesh.marching_tetrahedra(field, weight, origin, voxel))
    return times


def dense_agreement(a, b) -> dict:
    """How far two Systems' dense products agree (``a`` the card's, ``b``
    the CPU's): the shares of equal edge pixels and of equal validity, the
    largest relative inverse-depth difference where both are valid, the
    segment counts and the largest endpoint difference of matched segments
    (unordered), the triangle counts and the mean distance from each of
    a's vertices to b's nearest, in voxels."""
    ra, rb = a._semidense_result, b._semidense_result
    pa, pb = ra.pixels.cpu().numpy(), rb.pixels.cpu().numpy()
    va, vb = ra.valid.cpu().numpy(), rb.valid.cpu().numpy()
    both = va & vb & (np.abs(pa - pb).max(-1) == 0)
    da, db = ra.inv_depth.cpu().numpy()[both], rb.inv_depth.cpu().numpy()[both]
    rel = np.abs(da - db) / np.abs(db)
    out = {"pixels_equal": float((np.abs(pa - pb).max(-1) == 0).mean()),
           "valid_equal": float((va == vb).mean()), "valid_card": int(va.sum()),
           "valid_cpu": int(vb.sum()),
           "inv_depth_within_rtol": float((rel <= DENSE_RHO_RTOL).mean()) if both.any() else 1.0,
           "inv_depth_max_rel": float(rel.max()) if both.any() else 0.0,
           "segments_card": len(a._lines3d), "segments_cpu": len(b._lines3d),
           "triangles_card": len(a._mesh_tris), "triangles_cpu": len(b._mesh_tris)}
    la, lb = a._lines3d, b._lines3d
    if len(la) and len(lb):
        d = np.abs(la[:, None] - lb[None]).max(-1)
        flip = np.abs(la[:, None] - lb[None][..., [3, 4, 5, 0, 1, 2]]).max(-1)
        out["segment_max_diff_m"] = float(np.minimum(d, flip).min(1).max())
    ta, tb = a._mesh_tris, b._mesh_tris
    if len(ta) and len(tb):
        from eao_slam_torch.evaluation import nearest_neighbors

        pts = ra.points_w.cpu().numpy()[va]
        voxel = float((np.percentile(pts, 98, axis=0) - np.percentile(pts, 2, axis=0)
                       + 0.4).max() / 95)
        _, dist = nearest_neighbors(ta.reshape(-1, 3), tb.reshape(-1, 3), device="cuda")
        out["mesh_mean_vertex_dist_voxels"] = float(dist.mean() / voxel)
    return out


def nudged_copy(system):
    """``system`` (on the CPU) with every keyframe pose moved by one ulp
    towards +inf: the dense phase's own sensitivity to a last-bit change."""
    import torch

    c = system.tracker.carry
    pose = c.m.kf_pose
    system.tracker.carry = c._replace(m=c.m._replace(
        kf_pose=torch.nextafter(pose, torch.full_like(pose, float("inf")))))
    return system


def check_dense_agreement(g: dict, floor: dict) -> None:
    """``g``: the card against the CPU; ``floor``: the CPU against itself
    with the poses nudged by one ulp (the DENSE_* constants)."""
    bad = []
    if g["pixels_equal"] < DENSE_PIXELS_AGREE:
        bad.append("edge pixels")
    if g["valid_equal"] < DENSE_VALID_AGREE:
        bad.append("validity")
    if (1 - g["inv_depth_within_rtol"] > DENSE_RHO_NOISE_FACTOR
            * (1 - floor["inv_depth_within_rtol"]) + DENSE_RHO_NOISE_MARGIN):
        bad.append("inverse depth")
    if abs(g["segments_card"] - g["segments_cpu"]) > 1 or g.get("segment_max_diff_m", 0) > 1e-4:
        bad.append("3D segments")
    if (abs(g["triangles_card"] - g["triangles_cpu"]) > 0.005 * max(g["triangles_cpu"], 1)
            or g.get("mesh_mean_vertex_dist_voxels", 0) >= 0.1):
        bad.append("mesh")
    if bad:
        raise AssertionError(f"dense phase: card and CPU disagree on {', '.join(bad)}: {g}")


def _render_depth(T_cw):
    from eao_slam_torch.geometry.camera import TUM3
    from eao_slam_torch.io.synthetic import depth_cloud

    return depth_cloud(_SCENES["bench"], TUM3, T_cw[None, 1], T_cw[0])


def cloud_quality(sysm, ts, gt) -> dict:
    """The semi-dense export against the ray-cast depth of the retained
    keyframes at their true poses (every 8th pixel), in the camera frame of
    the map's first keyframe: evaluation.evaluate_reconstruction as it is
    (its ICP starts from the centroids and RMS radii), and the same scaled
    ICP started from the sim3 of the keyframe centres onto their true
    centres, then the mean (which far outliers dominate) and the median
    distance of the whole cloud (printed, not gated)."""
    import tempfile

    from eao_slam_torch.evaluation import (
        evaluate_reconstruction, icp_register, load_cloud, mean_cloud_distance,
        nearest_neighbors, random_downsample)
    from eao_slam_torch.io.trajectory import umeyama_alignment

    m = sysm.tracker.map
    kf_ts = m.kf_timestamp.cpu().numpy()
    kf_valid = m.kf_valid.cpu().numpy()
    first = int(np.flatnonzero(kf_valid)[np.argmin(kf_ts[kf_valid])])
    T_ref = gt[int(np.argmin(np.abs(ts - kf_ts[first])))]
    slots = sysm._semidense_slots
    frames = [int(np.argmin(np.abs(ts - kf_ts[s]))) for s in slots]
    truth = np.concatenate(pool_map(_render_depth, [np.stack([T_ref, gt[f]]) for f in frames]))
    est_c = centers(m.kf_pose.cpu().numpy()[slots])
    true_c = centers(gt[frames]) @ T_ref[:3, :3].T + T_ref[:3, 3]
    init = umeyama_alignment(est_c, true_c, with_scale=True)
    with tempfile.TemporaryDirectory() as d:
        est_path, gt_path = os.path.join(d, "semidense.obj"), os.path.join(d, "truth.xyz")
        n_est = sysm.save_semidense_obj(est_path)
        np.savetxt(gt_path, truth)
        as_is = evaluate_reconstruction(est_path, gt_path, device="cuda")
        est = load_cloud(est_path)
        gt_cloud = load_cloud(gt_path)
    s, R, t = icp_register(random_downsample(est, 0.1, seed=1),
                           random_downsample(gt_cloud, 0.1, seed=2), init=init, device="cuda")
    _, dist = nearest_neighbors((s * (R @ est.T)).T + t, gt_cloud, device="cuda")
    return {"exported_points": n_est, "truth_points": len(truth), "evaluate_reconstruction": as_is,
            "trajectory_init": {"scale": float(s), "mean_distance": mean_cloud_distance(
                est, gt_cloud, (s, R, t), device="cuda"), "median_distance": float(np.median(dist)),
                "init_mean_distance": mean_cloud_distance(est, gt_cloud, init, device="cuda")}}


def dense_fixtures() -> dict:
    """The reference's accuracy fixtures on the card: tests/test_semidense.py's
    four rendered views (median relative depth error < 0.05, >= 60 % of
    fused pixels under 0.1, > 300 fused), tests/test_mesh.py's flat wall
    (the triangles on z = 4 within 2.1 voxels, > 200 of them) and
    tests/test_lines3d.py's segment (recovered within 0.1 m)."""
    import torch

    from eao_slam_torch.dense import lines3d, mesh, semidense
    from eao_slam_torch.geometry.camera import TUM3
    from eao_slam_torch.io.synthetic import look_at, make_room_scene, render_image

    scene = make_room_scene(seed=9, n_landmarks=50, n_objects=2)
    poses, imgs, depths = [], [], []
    for i in range(4):
        T = look_at(np.array([-0.12 + 0.08 * i, 0.0, 0.0]),
                    np.array([0.0, 0.0, 4.5])).astype(np.float32)
        img, z = render_image(scene, TUM3, T, return_depth=True)
        poses.append(T)
        imgs.append(img.astype(np.float32))
        depths.append(z)
    res = semidense.semidense_reconstruct(
        TUM3, np.stack(imgs), np.stack(poses), np.asarray([[2.0, 8.0]] * 4, np.float32),
        [[j for j in range(4) if j != k][:3] for k in range(4)], n_pix=4096, n_depth=96)
    uv, val, rho = (x[0].cpu().numpy() for x in (res.pixels, res.valid, res.inv_depth))
    gt_z = depths[0][uv[:, 1].astype(int), uv[:, 0].astype(int)]
    ok = val & np.isfinite(gt_z)
    rel = np.abs(1.0 / np.maximum(rho[ok], 1e-6) - gt_z[ok]) / gt_z[ok]
    out = {"semidense_fused": int(ok.sum()), "semidense_median_rel_err": float(np.median(rel)),
           "semidense_share_under_0.1": float((rel < 0.1).mean())}

    cam = TUM3._replace(width=160, height=120, fx=140.0, fy=140.0, cx=80.0, cy=60.0)
    eye = torch.eye(3, 4, device="cuda")[None]
    origin = torch.as_tensor([-1.0, -1.0, 3.0], device="cuda")
    voxel = np.float32(2.0 / 47)
    field, w = mesh.tsdf_fuse(cam, torch.full((1, 120, 160), 4.0, device="cuda"), eye, origin,
                              voxel, nx=48, ny=48, nz=48)
    tris, tv = mesh.marching_tetrahedra(field, w, origin, voxel, min_weight=1.0, max_tris=50_000)
    tris = tris[tv].cpu().numpy()
    out.update(wall_triangles=len(tris),
               wall_max_err_voxels=float(np.abs(tris[..., 2] - 4.0).max() / voxel))

    rng = np.random.default_rng(12345)
    p1, p2 = np.array([-0.8, -0.2, 4.0]), np.array([0.9, 0.4, 5.0])
    X = p1 + np.linspace(0, 1, 400)[:, None] * (p2 - p1)
    uv = np.stack([TUM3.fx * X[:, 0] / X[:, 2] + TUM3.cx, TUM3.fy * X[:, 1] / X[:, 2] + TUM3.cy],
                  -1).astype(np.float32)
    rho = (1.0 / X[:, 2] * (1.0 + rng.normal(0, 0.003, len(X)))).astype(np.float32)
    segs = torch.zeros((8, 4), device="cuda")
    segs[0] = torch.as_tensor([uv[0, 0], uv[0, 1], uv[-1, 0], uv[-1, 1]])
    valid = torch.zeros(8, dtype=torch.bool, device="cuda")
    valid[0] = True
    fit = lines3d.fit_3d_segments(TUM3, segs, valid, torch.as_tensor(uv, device="cuda"),
                                  torch.as_tensor(rho, device="cuda"),
                                  torch.ones(len(uv), dtype=torch.bool, device="cuda"), eye[0])
    got = fit.seg[0].cpu().numpy()
    err = max(min(np.linalg.norm(e - p1), np.linalg.norm(e - p2)) for e in (got[:3], got[3:]))
    out.update(segment_valid=bool(fit.valid[0]), segment_err_m=float(err))
    print("dense fixtures on the card: " + ", ".join(f"{k} {v}" for k, v in out.items()))
    if not (out["semidense_fused"] > 300 and out["semidense_median_rel_err"] < 0.05
            and out["semidense_share_under_0.1"] > 0.6):
        raise AssertionError(f"semi-dense accuracy fixture failed: {out}")
    if not (out["wall_triangles"] > 200 and out["wall_max_err_voxels"] < 2.1):
        raise AssertionError(f"flat-wall fixture failed: {out}")
    if not (out["segment_valid"] and out["segment_err_m"] < 0.1):
        raise AssertionError(f"segment recovery fixture failed: {out}")
    return out


def run_full(ts, gt, images, lines: dict) -> dict:
    """The FULL phase: the online run (line mode's program, keyframe images
    kept; poses equal to the line phase's default seed), bench.py's dense
    protocol on the card (timed, then stage by stage, then traced), the same
    dense phase on the CPU from a checkpoint of the card's state, the
    reference's accuracy fixtures and the cloud's quality."""
    import tempfile

    import torch

    from eao_slam_torch.ops import fast_nms
    from eao_slam_torch.system import System

    boxes = bench_boxes(gt)
    fast_nms.reset_launches()
    online = run_main_path(ts, gt, images, SEEDS[0], boxes=boxes, flag="Full")
    launches = dict(fast_nms.launches)
    check_eao_run(online, LINE_ATE_LIMIT_M, LINE_OBJECT_LIMIT_M, "Full")
    same = online["poses"].shape == lines["default_poses"].shape
    pose_diff = float(np.abs(online["poses"] - lines["default_poses"]).max()) if same else np.inf
    print(f"FULL online, default seed: {online['fps']:.2f} fps, poses against line mode's "
          f"max |diff| {pose_diff:.3g}; launches {launches}")
    if launches["fast_nms_tile_max"] <= 0:
        raise AssertionError("the FULL path never launched fast_nms_tile_max")
    if not pose_diff <= FULL_POSE_TOL:
        raise AssertionError(f"FULL's online poses differ from line mode's by {pose_diff:.3g}")

    cfg = full_config()
    sysm = System(cfg, chunk=CHUNK)
    for k in range(DENSE_FRAMES):
        sysm.track_monocular(images[k], float(ts[k]), boxes=boxes[k])
    sysm.flush()
    sync(sysm.device)
    t0 = time.perf_counter()
    res = sysm.shutdown(semidense=True)
    sync(sysm.device)
    dt = time.perf_counter() - t0
    if res is None:
        raise AssertionError(f"the dense phase did not run ({len(sysm._kf_images)} keyframe "
                             f"images kept)")
    n_kf = len(sysm._semidense_slots)
    counts = {"semidense_valid": int(res.valid.sum()), "segments": len(sysm._lines3d),
              "triangles": len(sysm._mesh_tris)}
    stages = dense_stage_times(sysm)
    traced = traced_calls(lambda: sysm.shutdown(semidense=True))
    print(f"dense phase on the card: {n_kf} keyframes in {dt:.3f} s, {dt / n_kf:.3f} s per "
          f"keyframe (host clock between synchronises, first call); stages, again from the "
          f"same state: " + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
          + f"; traced: {traced['launches']} kernel launches, {traced['syncs']} host "
          f"synchronisations, {traced['host_copies']} copies between host and card; "
          f"{counts['semidense_valid']} valid semi-dense points, {counts['segments']} 3D "
          f"segments, {counts['triangles']} triangles (the reference on the CPU: "
          f"{REFERENCE_DENSE})")
    if counts["semidense_valid"] <= 0:
        raise AssertionError("the dense phase fused no semi-dense point")

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "full.ckpt")
        sysm.save_checkpoint(path)
        host, nudged = (System(cfg, chunk=CHUNK, device="cpu") for _ in range(2))
        host.load_checkpoint(path)
        nudged.load_checkpoint(path)
    t0 = time.perf_counter()
    host.shutdown(semidense=True)
    dt_cpu = time.perf_counter() - t0
    nudged_copy(nudged).shutdown(semidense=True)
    agree = dense_agreement(sysm, host)
    floor = dense_agreement(host, nudged)
    print(f"dense phase, card against CPU (same state and images, a checkpoint; the CPU run "
          f"{dt_cpu:.1f} s): {agree}; the CPU against itself with the poses one ulp apart: "
          f"{floor}")
    check_dense_agreement(agree, floor)
    fixtures = dense_fixtures()
    quality = cloud_quality(sysm, ts, gt)
    print(f"semi-dense cloud quality (printed, not gated): {quality}")
    torch.cuda.empty_cache()
    return {"fps": online["fps"], "launches": launches, "online_pose_diff_vs_line": pose_diff,
            "online": {k: online[k] for k in ("tracked", "total", "ate_m", "objects",
                                              "object_classes", "object_centre_err_m")},
            "dense": {"keyframes": n_kf, "seconds": dt, "s_per_kf": dt / n_kf, "stages_s": stages,
                      "traced": traced, **counts, "reference_cpu": REFERENCE_DENSE},
            "card_against_cpu": agree, "cpu_against_one_ulp": floor, "cpu_seconds": dt_cpu,
            "fixtures": fixtures,
            "cloud_quality": quality}


def _reloc_errors(tracker, gt_of_step, step, T_rec, n_local: int = 8):
    """Distance of a relocalized camera centre from ground truth after a
    sim3 alignment of the keyframe trajectory onto ground truth (keyframe
    timestamps are step / 30): aligned on every keyframe, and on the
    n_local keyframes nearest the relocalized frame in ground truth. Also
    the keyframe trajectory's own sim3 ATE."""
    from eao_slam_torch.io.trajectory import ate_rmse, umeyama_alignment

    kts, kT = tracker.keyframe_trajectory()
    steps = np.rint(np.asarray(kts) * 30.0).astype(int)
    est = centers(np.asarray(kT))
    ref = centers(np.stack([gt_of_step[s] for s in steps]))
    c_rec = centers(T_rec[None])[0]
    c_gt = centers(gt_of_step[step][None])[0]
    near = np.argsort(np.linalg.norm(ref - c_gt, axis=1))[:n_local]
    errs = []
    for sel in (np.arange(len(est)), near):
        s_, R_, t_ = umeyama_alignment(est[sel], ref[sel], with_scale=True)
        errs.append(float(np.linalg.norm(s_ * R_ @ c_rec + t_ - c_gt)))
    return errs[0], errs[1], float(ate_rmse(est, ref, with_scale=True)), len(est)


def run_long(ts, gt, images) -> dict:
    """Long run on rendered frames: the arc forward, back and forward, a
    chunk of blank frames, a jump to frame JUMP_TO and two more chunks;
    then, if no between-chunk relocalization happened, the reference's own
    kidnap at full width on a frame from the middle of the arc."""
    import torch

    from eao_slam_torch.config import CapacityConfig, tum3_config
    from eao_slam_torch.runtime.frame import frame_from_image
    from eao_slam_torch.system import System

    cfg = tum3_config().replace(capacity=CapacityConfig(**LONG_CAPACITY))
    sysm = System(cfg, chunk=CHUNK)
    tr = sysm.tracker
    timer = PassTimer(tr)
    K = cfg.capacity.max_keyframes
    n = len(images)
    order = list(range(n)) + list(range(n - 2, 0, -1)) + list(range(1, n))
    blank = np.zeros_like(images[0])
    stream = ([(i, images[i]) for i in order] + [(None, blank)] * CHUNK
              + [(i, images[i]) for i in range(JUMP_TO, JUMP_TO + 3 * CHUNK)])
    gt_of_step = []
    events = []              # (step, recovered T_cw) of between-chunk relocalizations
    kf_max = 0
    t0 = time.perf_counter()

    def feed(gi, img):
        nonlocal kf_max
        step = len(gt_of_step)
        gt_of_step.append(None if gi is None else gt[gi])
        n_rel = tr.n_relocalized
        sysm.track_monocular(img, step / 30.0)
        if sysm._armed and not sysm._img_buf:      # a chunk (or the bootstrap) ended
            kf_max = max(kf_max, tr.kf_count_host)
            if tr.kf_count_host > K:
                raise AssertionError(f"keyframe count {tr.kf_count_host} over capacity {K}")
            if tr.n_relocalized > n_rel:
                events.append((step, tr.carry.T_last.cpu().numpy()))

    for gi, img in stream:
        feed(gi, img)
    sysm.flush()
    torch.cuda.synchronize()
    n_pp = len(order)
    states = np.array([r[2] for r in tr.records])
    pp_tracked = float((states[:n_pp] == 2).mean())
    jump_lo = n_pp + CHUNK
    jump_states = states[jump_lo:jump_lo + CHUNK]
    in_scan = bool(len(events) == 0 and (jump_states == 2).any())
    natural = len(events)
    print(f"long run: {len(stream)} frames ({n_pp} ping-pong, {CHUNK} blank, {3 * CHUNK} after "
          f"the jump to frame {JUMP_TO}) in {time.perf_counter() - t0:.1f} s; maintenance "
          f"{tr.n_maintenance} times, keyframes at most {kf_max}/{K}, points now "
          f"{tr.pt_count_host}/{cfg.capacity.max_points}; ping-pong tracked "
          f"{100 * pp_tracked:.1f} %; after the blank chunk: states of the jump chunk "
          f"{''.join(str(int(s)) for s in jump_states)}, between-chunk relocalizations {natural}, "
          f"in-scan reacquire {'yes' if in_scan else 'no'}")

    explicit = None
    if not events:
        # the reference's kidnap (tests/test_scan_tracker.py:98) at full width
        k = n // 2
        fr = frame_from_image(cfg, images[k], sysm.device)
        T_garbage = torch.eye(3, 4, device=sysm.device)
        T_garbage[:, 3] = 5.0
        tr.carry = tr.carry._replace(
            state=3, T_last=T_garbage, last_kp=fr.kp, last_desc=fr.desc,
            last_octave=fr.octave, last_angle=fr.angle, last_valid=fr.valid,
            last_pt=torch.full_like(tr.carry.last_pt, -1))
        tr.state_host = 3
        step = len(gt_of_step)
        gt_of_step.append(gt[k])
        tr._maybe_relocalize()
        if tr.state_host == 2:
            events.append((step, tr.carry.T_last.cpu().numpy()))
            tr.records.append((step / 30.0, events[-1][1], 2))
        explicit = k
        for gi in range(k + 1, k + 1 + 2 * CHUNK):
            feed(gi, images[gi])
        sysm.flush()
        print(f"long run: no between-chunk relocalization on the natural kidnap; the "
              f"reference's kidnap on frame {k}: {'recovered' if events else 'FAILED'}")
    if not events:
        raise AssertionError("no between-chunk relocalization succeeded")
    step, T_rec = events[0]
    err_all, err, kf_ate, n_kf = _reloc_errors(tr, gt_of_step, step, T_rec)
    states = np.array([r[2] for r in tr.records])
    after = states[-2 * CHUNK:]
    after_tracked = float((after == 2).mean())
    print(f"long run: relocalized at step {step}: camera centre {err:.4f} m from ground truth "
          f"after the sim3 alignment of the 8 keyframes nearest it ({err_all:.4f} m after the "
          f"alignment of all {n_kf} keyframes, whose own sim3 ATE is {kf_ate:.4f} m); the two "
          f"chunks after it track {100 * after_tracked:.1f} %")
    out = {"frames": len(gt_of_step), "n_maintenance": tr.n_maintenance, "kf_max": kf_max,
           "kf_capacity": K, "pingpong_tracked": pp_tracked, "natural_relocalizations": natural,
           "in_scan_reacquire": in_scan, "explicit_kidnap_frame": explicit,
           "reloc_err_m": err, "reloc_err_all_kf_m": err_all, "kf_ate_m": kf_ate,
           "after_tracked": after_tracked,
           "passes": print_passes("long run", timer)}
    if tr.n_maintenance < 2:
        raise AssertionError(f"maintenance ran {tr.n_maintenance} times, expected >= 2")
    if pp_tracked < 0.85:
        raise AssertionError(f"long run tracked {100 * pp_tracked:.1f} % < 85 %")
    if not err < RELOC_LIMIT_M:
        raise AssertionError(f"relocalized centre {err:.4f} m >= {RELOC_LIMIT_M} m from truth")
    if after_tracked < 0.9:
        raise AssertionError(f"the two chunks after relocalizing tracked "
                             f"{100 * after_tracked:.1f} % < 90 %")
    return out


class GlobalBAProblems:
    """While entered, the loop closer's global BA goes through a spy
    ba_solver: each problem it hands the solver is kept on the host
    (``recorded``: numpy fields, the window's keyframe count and the
    points it holds) before the tracker's own solver (or the single-device
    5 + 10 schedule) solves it."""

    def __enter__(self):
        from eao_slam_torch.runtime import loop_closing
        from eao_slam_torch.solvers.ba import local_ba

        self.module, self.saved, self.recorded = loop_closing, loop_closing.run_local_ba, []
        saved, recorded = self.saved, self.recorded

        def spied(cam, state, window_slots, fixed_slots, scale2, max_points, solver=None):
            def spy(cam_, prob):
                recorded.append({k: getattr(prob, k).detach().cpu().numpy()
                                 for k in prob._fields})
                return (solver or local_ba)(cam_, prob)

            return saved(cam, state, window_slots, fixed_slots, scale2, max_points, solver=spy)

        loop_closing.run_local_ba = spied
        return self

    def __exit__(self, *exc):
        self.module.run_local_ba = self.saved


def circuit_inputs():
    """bench.py's loop circuit: the closed room, a full orbit, simulated
    observations from default_rng(7), staged on the card."""
    from eao_slam_torch.config import CapacityConfig, tum3_config
    from eao_slam_torch.geometry.camera import TUM3
    from eao_slam_torch.io.synthetic import (
        make_orbit_trajectory, make_room_scene, simulate_observations)
    from eao_slam_torch.runtime.frame import frame_from_arrays

    cfg = tum3_config().replace(capacity=CapacityConfig(**CIRCUIT_CAPACITY))
    F = cfg.capacity.max_features
    scene = make_room_scene(seed=5, n_landmarks=1200, n_objects=3, closed_room=True)
    ts, gt = make_orbit_trajectory(n_frames=CIRCUIT_FRAMES, radius=2.2)
    rng = np.random.default_rng(7)
    frames = []
    for i in range(CIRCUIT_FRAMES):
        o = simulate_observations(scene, TUM3, gt[i], F, rng)
        frames.append(frame_from_arrays(cfg, kp=o["kp"], desc=o["desc"], octave=o["octave"],
                                        valid=o["valid"], device="cuda"))
    return cfg, ts, gt, frames


def drive_circuit(sysm, ts, frames, lo: int, hi: int) -> None:
    for i in range(lo, hi):
        sysm.track_frame(frames[i], float(ts[i]))


def circuit_result(sysm, ts, gt, tag: str) -> dict:
    from eao_slam_torch.io.trajectory import ate_rmse

    et, eT = sysm.frame_trajectory()
    idx = [int(np.argmin(np.abs(ts - t))) for t in et]
    online = float(ate_rmse(centers(eT), centers(gt[idx]), with_scale=True))
    kts, kT = sysm.keyframe_trajectory()
    kidx = [int(np.argmin(np.abs(ts - t))) for t in kts]
    kf = float(ate_rmse(centers(np.asarray(kT)), centers(gt[kidx]), with_scale=True))
    lc = sysm.tracker.loop_closer
    loops = lc.closed_loops if lc is not None else 0
    print(f"circuit, {tag}: keyframe ATE {kf:.4f} m, online ATE {online:.4f} m, tracked "
          f"{len(et)}/{CIRCUIT_FRAMES}, loops closed {loops}, keyframes "
          f"{sysm.tracker.kf_count_host}, points {sysm.tracker.pt_count_host}, maintenance "
          f"{sysm.tracker.n_maintenance}")
    return {"kf_ate_m": kf, "online_ate_m": online, "tracked": len(et), "loops": loops}


def run_circuit() -> dict:
    """The loop circuit with loop closing on and off, then the checkpoint
    resume of the loop run."""
    import tempfile

    import torch

    from eao_slam_torch.system import System

    cfg, ts, gt, frames = circuit_inputs()
    out = {}
    runs = {}
    for loop_on in (True, False):
        tag = "loop closing on" if loop_on else "loop closing off"
        sysm = System(cfg, chunk=CIRCUIT_CHUNK)
        if not loop_on:
            sysm.tracker.loop_closer = None
        timer = PassTimer(sysm.tracker)
        t0 = time.perf_counter()
        n_boot = 0
        with GlobalBAProblems() as problems:
            for i in range(CIRCUIT_FRAMES):
                sysm.track_frame(frames[i], float(ts[i]))
                n_boot += not sysm._armed
            sysm.flush()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if loop_on:
            if not problems.recorded:
                raise AssertionError("the circuit's loop run ran no global BA")
            out["loop_problem"] = problems.recorded[-1]
        if not sysm.tracker.armed:
            raise AssertionError("circuit bootstrap failed")
        res = circuit_result(sysm, ts, gt, tag)
        res["seconds"] = dt
        res["passes"] = print_passes(f"circuit, {tag}", timer)
        out["loop_on" if loop_on else "loop_off"] = res
        runs[loop_on] = (sysm, n_boot)
    on, off = out["loop_on"], out["loop_off"]
    print(f"circuit: loop run {on['seconds']:.1f} s, no-loop run {off['seconds']:.1f} s; "
          f"keyframe ATE {on['kf_ate_m']:.4f} m with loop closing against "
          f"{off['kf_ate_m']:.4f} m without (ratio {on['kf_ate_m'] / off['kf_ate_m']:.3f})")
    if on["loops"] < 1:
        raise AssertionError("circuit closed no loop")
    if not on["kf_ate_m"] < 0.7 * off["kf_ate_m"]:
        raise AssertionError(f"loop closing margin lost: {on['kf_ate_m']:.4f} vs "
                             f"{off['kf_ate_m']:.4f}")

    # checkpoint: the loop run saved at a chunk boundary half way, resumed
    solo, n_boot = runs[True]
    half = n_boot + 1 + CIRCUIT_CHUNK * ((CIRCUIT_FRAMES // 2 - n_boot - 1) // CIRCUIT_CHUNK)
    first = System(cfg, chunk=CIRCUIT_CHUNK)
    drive_circuit(first, ts, frames, 0, half)
    if first._frame_buf:
        raise AssertionError("the checkpoint split is not at a chunk boundary")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "circuit.ckpt")
        first.save_checkpoint(path)
        size = os.path.getsize(path)
        resumed = System(cfg, chunk=CIRCUIT_CHUNK)
        resumed.load_checkpoint(path)
    drive_circuit(resumed, ts, frames, half, CIRCUIT_FRAMES)
    ts_a, T_a = solo.frame_trajectory()
    ts_b, T_b = resumed.frame_trajectory()
    same_ts = len(ts_a) == len(ts_b) and bool(np.array_equal(ts_a, ts_b))
    diff = float(np.abs(T_a - T_b).max()) if same_ts else float("inf")
    loops_b = resumed.tracker.loop_closer.closed_loops
    print(f"checkpoint: saved after frame {half} ({size / 1e6:.1f} MB), resumed in a fresh "
          f"System: {len(ts_b)} poses, max |T - T_uninterrupted| {diff:.3g}, loops closed "
          f"{loops_b} (uninterrupted {on['loops']})")
    out["checkpoint"] = {"split_frame": half, "bytes": size, "max_abs_diff": diff,
                         "loops": loops_b}
    if not diff <= CHECKPOINT_TOL:
        raise AssertionError(f"resumed trajectory differs by {diff:.3g} > {CHECKPOINT_TOL}")
    return out


# ---------------------------------------------------------------------------
# the interactive per-frame tracker (System(chunked=False))
# ---------------------------------------------------------------------------

# interactive protocol (drive_interactive, interactive_modes): the JAX
# reference on the CPU, every frame of the arc through its
# System(chunked=False).track_monocular (reference_ate_spread.py
# --interactive), over seeds 12345 and 1-19: every seed tracks every frame
# after its initialization (frame 3-10); sim3 ATE of the tracked frames
# median 0.04209 m, worst 0.12442 m (seed 6). In EAO mode on the default
# seed: 3 live objects, one per class, worst centre error 0.13916 m (on
# seeds 1-6 up to 0.1948 m, and 3.4866 m on seed 6, whose tracker
# initializes late). With --modes on the default seed: the blank frames
# lose track, frame 40 relocalizes 0.0095 m from truth, localization mode
# tracks 32 of 32 with the counts unchanged, the reset initializes again.
# The port is held to 1.5 times the worst and the median, its EAO run to
# 1.5 times the reference's on the same seed, the tracked share to 90 % and
# the relocalization to RELOC_LIMIT_M, the long run's (the reference meets
# both).
INTERACTIVE_ATE_LIMIT_M = 1.5 * 0.12442
INTERACTIVE_MEDIAN_ATE_LIMIT_M = 1.5 * 0.04209
INTERACTIVE_OBJECT_LIMIT_M = 1.5 * 0.13916
INTERACTIVE_MIN_TRACKED = 0.9
INTERACTIVE_BLANK = 3          # blank frames of the kidnap
INTERACTIVE_RELOC_FROM = 40    # the frame the kidnapped tracker is fed from
INTERACTIVE_RELOC_WITHIN = 5   # frames it may take to relocalize
INTERACTIVE_LOC_FRAMES = (60, 92)     # localization mode: frames 60-91 again
INTERACTIVE_RESET_FRAMES = 41         # reset: frames 0-40
INTERACTIVE_SEEDS = (12345, 1, 2)
# card against CPU (interactive_card_against_cpu): from the default seed's
# state after frame 100, the same steps on both devices; integers exact,
# floats to 1e-4. The windowed BA is chaotic in float32: on the card's
# state at the keyframe of frame 115 the CPU's own BA moves the poses by
# 9.3e-4 and a point by 0.57 m with the keyframe poses one ulp up, and
# 3.7e-4 and 13.8 m on one thread, where the card differs from the CPU by
# 1.4e-3 and 1.75 m; triangulation's points move by up to 8.7e-4 with the
# nudge, 6.2e-4 on the card ("NVIDIA H100 80GB HBM3, 700.00 W"; PERF.md).
# So a mapping stage's floats and the BA's results are held to 4 times the
# larger of the CPU's two differences instead.
INTERACTIVE_CARD_CPU_FROM = 100
INTERACTIVE_CARD_CPU_MAX_STEPS = 20
INTERACTIVE_CARD_CPU_TOL = 1e-4
INTERACTIVE_CARD_CPU_FACTOR = 4.0


def _np(x):
    """A tensor of either package, or a numpy array, as numpy."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def live_keyframes(tracker) -> list:
    return [s for s in tracker.kf_slots if tracker.kf_valid_host[s]]


def drive_interactive(sysm, ts, gt, images, boxes=None, on_frame=None) -> dict:
    """Every frame of ``images`` through ``sysm.track_monocular`` (either
    package's System(chunked=False)), with ``boxes[k]`` in an object mode.
    ``on_frame(k, T, is_keyframe)`` runs after each frame. Returns the
    frame that initialized (its call returned the first pose), the frames
    tracked from there on and their count, the sim3 ATE of every tracked
    frame, the live keyframes and points, whether the vocabulary was
    trained and every live keyframe is in the BoW database, and in an
    object mode the objects (as ``object_results``)."""
    from eao_slam_torch.io.trajectory import ate_rmse

    tr = sysm.tracker
    poses = []
    for k in range(len(images)):
        n_kf = len(tr.kf_slots)
        T = sysm.track_monocular(images[k], float(ts[k]),
                                 boxes=None if boxes is None else boxes[k])
        poses.append(None if T is None else np.asarray(T))
        if on_frame is not None:
            on_frame(k, T, len(tr.kf_slots) > n_kf)
    got = [k for k, T in enumerate(poses) if T is not None]
    if not got:
        raise AssertionError("two-view initialization never succeeded")
    init = got[0]
    Ts = np.stack([poses[k] for k in got])
    if not np.isfinite(Ts).all():
        raise AssertionError("non-finite poses")
    live = live_keyframes(tr)
    out = {"init_frame": init, "tracked": len(got), "total": len(images) - init,
           "ate_m": float(ate_rmse(centers(Ts), centers(gt[got]), with_scale=True)),
           "keyframes": len(live), "points": int(tr.pt_valid_host.sum()),
           "vocab": tr.vocab is not None,
           "kfdb_holds_every_keyframe": (tr.kfdb is not None
                                         and set(np.flatnonzero(tr.kfdb.present)) == set(live)),
           "loops": tr.loop_closer.closed_loops if tr.loop_closer is not None else 0}
    if boxes is not None:
        out.update(interactive_objects(tr, ts, gt))
    return out


def interactive_objects(tracker, ts, gt) -> dict:
    """``object_results``'s object measures on a MonoTracker of either
    package."""
    from eao_slam_torch.io.trajectory import map_object_errors

    scene = bench_scene()
    tab = {k: _np(v) for k, v in tracker.obj_table._asdict().items()}
    m = {k: _np(v) for k, v in tracker.map._asdict().items()}
    live = tab["valid"] & ~tab["bad"] & np.isin(tab["cls"], scene.obj_classes)
    cls = tab["cls"][live]
    return {"objects": int(live.sum()), "object_classes": sorted(int(c) for c in cls),
            "every_class": set(scene.obj_classes.tolist()) <= set(cls.tolist()),
            "object_centre_err_m": map_object_errors(m, tab, ts, gt, scene.obj_centers,
                                                     scene.obj_classes)}


def interactive_modes(sysm, ts, gt, images, on_frame=None) -> dict:
    """After a full pass: the kidnap (INTERACTIVE_BLANK blank frames, then
    the frames from INTERACTIVE_RELOC_FROM until a pose returns, at most
    INTERACTIVE_RELOC_WITHIN; the recovered camera centre against ground
    truth after the sim3 alignment of the 8 keyframes nearest it), the
    frames up to the localization window tracked, localization mode over
    INTERACTIVE_LOC_FRAMES (keyframe and live-point counts before and
    after, frames tracked), then System.reset() and the first
    INTERACTIVE_RESET_FRAMES frames (state, keyframes)."""
    tr = sysm.tracker
    dt = float(ts[1] - ts[0])

    def feed(k, img=None, t=None):
        n_kf = len(tr.kf_slots)
        T = sysm.track_monocular(images[k] if img is None else img,
                                 float(ts[k]) if t is None else t)
        if on_frame is not None:
            on_frame(k, T, len(tr.kf_slots) > n_kf)
        return T

    blank = np.zeros_like(images[0])
    for j in range(INTERACTIVE_BLANK):
        feed(None, blank, float(ts[-1]) + (j + 1) * dt)
    out = {"lost": tr.state == 3, "reloc_frame": None}
    k = INTERACTIVE_RELOC_FROM
    while k < INTERACTIVE_RELOC_FROM + INTERACTIVE_RELOC_WITHIN:
        T = feed(k)
        k += 1
        if T is not None:
            local_err = _reloc_errors(tr, gt, k - 1, np.asarray(T))[1]
            out.update(reloc_frame=k - 1, reloc_err_m=local_err)
            break
    while k < INTERACTIVE_LOC_FRAMES[0]:
        feed(k)
        k += 1
    sysm.activate_localization_mode()
    before = (len(live_keyframes(tr)), int(tr.pt_valid_host.sum()))
    lo, hi = INTERACTIVE_LOC_FRAMES
    loc_tracked = sum(feed(k) is not None for k in range(lo, hi))
    after = (len(live_keyframes(tr)), int(tr.pt_valid_host.sum()))
    sysm.deactivate_localization_mode()
    out.update(loc_tracked=loc_tracked, loc_total=hi - lo, loc_counts_before=before,
               loc_counts_after=after)
    sysm.reset()
    for k in range(INTERACTIVE_RESET_FRAMES):
        feed(k)
    out.update(reset_state=int(tr.state), reset_keyframes=len(live_keyframes(tr)))
    return out


def _tracker_diff(a, b) -> tuple:
    """Two MonoTrackers of one state: ({field: count} of the integer and
    boolean fields that differ (map, host mirrors, keyframe slots, the
    BoW database's membership), {field: largest difference} of the float
    fields (map, BoW vectors)); fields that agree are left out."""
    ints, floats = {}, {}
    fields = [(f, _np(v), _np(getattr(b.map, f))) for f, v in a.map._asdict().items()]
    fields += [(f, getattr(a, f), getattr(b, f))
               for f in ("kf_pt_host", "kf_valid_host", "pt_valid_host", "pt_first_kf_host")]
    fields.append(("kf_slots", np.asarray(a.kf_slots), np.asarray(b.kf_slots)))
    if a.kfdb is not None:
        fields += [("kfdb_present", a.kfdb.present, b.kfdb.present),
                   ("kfdb_vectors", a.kfdb.vectors, b.kfdb.vectors)]
    for f, x, y in fields:
        if x.shape != y.shape:
            ints[f] = -1
        elif x.dtype.kind == "f":
            d = np.abs(x.astype(np.float64) - y)
            if (v := float(d[np.isfinite(d)].max(initial=0.0))):
                floats[f] = v
        elif (c := int((x != y).sum())):
            ints[f] = c
    return ints, floats


def interactive_card_against_cpu(state: dict, cfg, ts, images) -> dict:
    """The interactive path on the card against the same code on the CPU
    from one state (``state``: a MonoTracker's after frame
    INTERACTIVE_CARD_CPU_FROM, as numpy), each fed the card's ORB output:
    ``quantize`` of the live keyframes' descriptors; the first later frame
    that makes no keyframe, one ``track`` step; the first that makes one,
    stage by stage, every stage started on both devices from the card's
    state: the pose tracking, the keyframe's insertion with the card's pose
    (BoW bookkeeping), each triangulation, each fusion, the duplicate merge,
    the windowed BA, then with the card's BA the point culling, the
    descriptor refresh, keyframe culling and loop detection. The CPU's own
    sensitivity beside each mapping stage: the same stage on the CPU with
    the keyframe poses one ulp up, and with one thread (its sums in another
    order)."""
    import torch

    from eao_slam_torch.convert import (frame_from_numpy, frame_to_numpy,
                                        mono_tracker_from_numpy, mono_tracker_to_numpy)
    from eao_slam_torch.ops.bow import quantize
    from eao_slam_torch.runtime.frame import frame_from_image
    from eao_slam_torch.runtime.tracker import MonoTracker

    card = mono_tracker_from_numpy(state, MonoTracker(cfg, "cuda"))
    cpu, nudged, serial = (mono_tracker_from_numpy(state, MonoTracker(cfg, "cpu"))
                           for _ in range(3))
    live = torch.as_tensor(live_keyframes(card), device=card.device)
    desc = card.map.kf_desc[live][card.map.kf_kp_valid[live]]
    w_card, n_card = quantize(card.vocab, desc)
    w_cpu, n_cpu = quantize(cpu.vocab, desc.cpu())
    out = {"quantize_descriptors": int(desc.shape[0]),
           "quantize_equal": bool(torch.equal(w_card.cpu(), w_cpu)
                                  and torch.equal(n_card.cpu(), n_cpu))}

    def load(S):
        for t in (cpu, nudged, serial):
            mono_tracker_from_numpy(S, t)
        pose = nudged.map.kf_pose
        nudged.map = nudged.map._replace(
            kf_pose=torch.nextafter(pose, torch.full_like(pose, float("inf"))))

    def run(fn):
        """fn on every tracker (``serial`` on one thread); the diffs of
        cpu against card, and of nudged and serial against cpu."""
        res = {"card": fn(card), "cpu": fn(cpu), "nudged": fn(nudged)}
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            res["serial"] = fn(serial)
        finally:
            torch.set_num_threads(threads)
        d = {"cpu": _tracker_diff(card, cpu), "nudged": _tracker_diff(cpu, nudged),
             "serial": _tracker_diff(cpu, serial)}
        load(mono_tracker_to_numpy(card))
        return res, d

    k = INTERACTIVE_CARD_CPU_FROM + 1
    last = min(len(images), k + INTERACTIVE_CARD_CPU_MAX_STEPS)
    while k < last and "keyframe" not in out:
        S = mono_tracker_to_numpy(card)
        f_card = frame_from_image(cfg, images[k], card.device)
        f_cpu = frame_from_numpy(frame_to_numpy(f_card), "cpu")
        n_kf = len(card.kf_slots)
        T_card = card.track(f_card, float(ts[k]))
        if len(card.kf_slots) == n_kf:
            if "frame" not in out:
                load(S)
                T_cpu = cpu.track(f_cpu, float(ts[k]))
                ints, floats = _tracker_diff(card, cpu)
                if (c := int((_np(card.last_pt) != _np(cpu.last_pt)).sum())):
                    ints["last_pt"] = c
                pose = (float("inf") if T_cpu is None
                        else float(np.abs(T_card - T_cpu).max()))
                out["frame"] = {"frame": k, "pose": pose,
                                "ints": ints, "floats": floats}
            k += 1
            continue
        # the keyframe frame, stage by stage from the state before it
        mono_tracker_from_numpy(S, card)
        load(S)
        frames = {id(card): f_card}
        frames.update({id(t): f_cpu for t in (cpu, nudged, serial)})
        kf = {"frame": k, "stages": []}
        res, _ = run(lambda t: t._track_pose(frames[id(t)]))
        r_card, r_cpu = res["card"], res["cpu"]
        kf["pose"] = float(np.abs(_np(r_card.T) - _np(r_cpu.T)).max())
        kf["tracked_points_differ"] = int((_np(r_card.cur_pt) != _np(r_cpu.cur_pt)).sum())
        T, cur_pt = _np(r_card.T), _np(r_card.cur_pt)

        def insert(t):
            t.frame_id += 1
            t._insert_keyframe(frames[id(t)], float(ts[k]), T, cur_pt)

        def stage(name, fn):
            res, d = run(fn)
            kf["stages"].append({"stage": name, "cpu": d["cpu"], "nudged": d["nudged"],
                                 "serial": d["serial"]})
            return res
        stage("insert keyframe", insert)
        slot = card.kf_slots[-1]
        c = cfg.mapping
        res = stage("neighbours", lambda t: t._covisible_neighbors(
            slot, c.triangulation_neighbors, c.min_covis_weight))
        kf["neighbours_equal"] = res["card"] == res["cpu"]
        nbs = res["card"]
        for nb in nbs:
            stage(f"triangulate {nb}", lambda t, nb=nb: t._triangulate_new_points(slot, nb))
        for s_ in [slot] + nbs[:2]:
            stage(f"fuse {s_}", lambda t, s_=s_: t._fuse_into_keyframe(s_))
        stage("duplicate merge", lambda t: t._merge_duplicate_points(slot))
        window = card._ba_window()
        res, _ = run(lambda t: t._local_ba(window))
        ba = {"card": res["card"]}

        def ba_diff(a, b):
            return {"poses": float(np.abs(_np(a.poses) - _np(b.poses)).max()),
                    "points": float(np.abs(_np(a.points) - _np(b.points)).max(initial=0.0)),
                    "drop_obs": int((a.drop_obs != b.drop_obs).sum()),
                    "slots_differ": int((a.kf_slots != b.kf_slots).sum()
                                        + (a.pt_slots != b.pt_slots).sum())}
        kf["ba"] = {"cpu": ba_diff(res["card"], res["cpu"]),
                    "nudged": ba_diff(res["cpu"], res["nudged"]),
                    "serial": ba_diff(res["cpu"], res["serial"])}

        def tail(t):
            b = ba["card"]
            t._apply_ba(b._replace(poses=b.poses.to(t.device), points=b.points.to(t.device)))
            t._cull_points()
            t._refresh_descriptors(window)
            t._cull_keyframes(window)
            if t.loop_closer is not None:
                t.loop_closer.on_keyframe(t, slot)
        stage("apply the card's BA, cull points, refresh, cull keyframes, loop detection", tail)
        out["keyframe"] = kf
    return out


def check_card_against_cpu(res: dict) -> None:
    """Integers exact and floats to INTERACTIVE_CARD_CPU_TOL, except where
    the CPU's own one-ulp or one-thread difference is larger: a mapping
    stage's floats, and the BA's, are held to INTERACTIVE_CARD_CPU_FACTOR
    times it."""
    tol, fac = INTERACTIVE_CARD_CPU_TOL, INTERACTIVE_CARD_CPU_FACTOR
    bad = []
    if not res["quantize_equal"]:
        bad.append("quantize")
    if "frame" not in res or "keyframe" not in res:
        bad.append(f"no frame of each kind within {INTERACTIVE_CARD_CPU_MAX_STEPS} frames")
    else:
        fr, kf = res["frame"], res["keyframe"]
        if fr["pose"] > tol or fr["ints"] or max(fr["floats"].values(), default=0.0) > tol:
            bad.append("the frame without a keyframe")
        if kf["pose"] > tol or kf["tracked_points_differ"] or not kf["neighbours_equal"]:
            bad.append("the keyframe frame's pose tracking")
        for st in kf["stages"]:
            ints, floats = st["cpu"]
            if ints:
                bad.append(f"{st['stage']}: integers")
            for f, v in floats.items():
                floor = max(st["nudged"][1].get(f, 0.0), st["serial"][1].get(f, 0.0))
                if v > max(tol, fac * floor):
                    bad.append(f"{st['stage']}: {f}")
        b = kf["ba"]
        if b["cpu"]["slots_differ"]:
            bad.append("BA: window or point slots")
        for f in ("poses", "points", "drop_obs"):
            floor = max(b["nudged"][f], b["serial"][f])
            if b["cpu"][f] > max(tol if f != "drop_obs" else 0, fac * floor):
                bad.append(f"BA: {f}")
    if bad:
        raise AssertionError(f"interactive card against CPU: {', '.join(bad)}: "
                             f"{json.dumps(res)}")


def run_interactive(ts, gt, images) -> dict:
    """The interactive phase (see the module docstring): geometry over
    INTERACTIVE_SEEDS, EAO on the default seed, the kidnap, localization
    mode and reset on the default seed's System, and localization mode
    with a checkpoint on the chunked path."""
    import torch

    from eao_slam_torch.ops import fast_nms

    dev = torch.device("cuda")
    boxes = bench_boxes(gt)
    times = {"keyframe": [], "frame": []}
    fed = [0]
    traced = {}

    def make(seed, objects=False):
        from eao_slam_torch.system import System

        return System(main_config(seed, objects), chunked=False)

    def timed(sysm):
        """Wrap track_monocular: count the frames fed; while a keyframe
        frame and a non-keyframe frame past the bootstrap are not yet
        traced, trace the call (traced_calls), else time it between
        synchronises."""
        orig = sysm.track_monocular
        tr = sysm.tracker

        def call(img, t, boxes=None):
            fed[0] += 1
            n_kf = len(tr.kf_slots)
            was_ok = tr.state == 2
            want_trace = was_ok and len(traced) < 2 and fed[0] > 30
            if want_trace:
                res = []
                calls = traced_calls(lambda: res.append(orig(img, t, boxes=boxes)))
                kind = "keyframe" if len(tr.kf_slots) > n_kf else "frame"
                traced.setdefault(kind, calls)
                return res[0]
            sync(dev)
            t0 = time.perf_counter()
            T = orig(img, t, boxes=boxes)
            sync(dev)
            if was_ok and T is not None:
                times["keyframe" if len(tr.kf_slots) > n_kf else "frame"].append(
                    time.perf_counter() - t0)
            return T

        sysm.track_monocular = call
        return sysm

    from eao_slam_torch.convert import mono_tracker_to_numpy

    snapshot = {}

    def snap(k, T, is_keyframe):
        if k == INTERACTIVE_CARD_CPU_FROM:
            snapshot.update(mono_tracker_to_numpy(default.tracker))

    fast_nms.reset_launches()
    t0 = time.perf_counter()
    default = timed(make(INTERACTIVE_SEEDS[0]))
    runs = [dict(seed=INTERACTIVE_SEEDS[0],
                 **drive_interactive(default, ts, gt, images, on_frame=snap))]
    print(f"interactive: default seed's pass {time.perf_counter() - t0:.1f} s", flush=True)
    modes = interactive_modes(default, ts, gt, images)
    launches = dict(fast_nms.launches)
    n_fed = fed[0]
    print(f"interactive: modes done at {time.perf_counter() - t0:.1f} s", flush=True)
    card_cpu = interactive_card_against_cpu(snapshot, default.cfg, ts, images)
    print(f"interactive card against CPU (default seed's state after frame "
          f"{INTERACTIVE_CARD_CPU_FROM}, tolerance {INTERACTIVE_CARD_CPU_TOL}): "
          f"{json.dumps(card_cpu)}; done at {time.perf_counter() - t0:.1f} s", flush=True)
    for seed in INTERACTIVE_SEEDS[1:]:
        runs.append(dict(seed=seed, **drive_interactive(make(seed), ts, gt, images)))
    eao = dict(seed=INTERACTIVE_SEEDS[0],
               **drive_interactive(make(INTERACTIVE_SEEDS[0], objects=True), ts, gt, images, boxes))
    print(f"interactive: seeds and EAO done at {time.perf_counter() - t0:.1f} s", flush=True)
    chunked = run_chunked_localization(ts, gt, images)
    dt = time.perf_counter() - t0

    ms = {k: float(np.median(v)) * 1e3 if v else None for k, v in times.items()}
    for r in runs + [eao]:
        tag = "EAO " if r is eao else ""
        print(f"interactive {tag}seed {r['seed']}: initialized at frame {r['init_frame']}, "
              f"{r['tracked']}/{r['total']} frames tracked from there, sim3 ATE "
              f"{r['ate_m']:.4f} m, keyframes {r['keyframes']}, points {r['points']}, "
              f"vocabulary {r['vocab']}, database holds every keyframe "
              f"{r['kfdb_holds_every_keyframe']}, loops {r['loops']}"
              + (f", objects {r['objects']} of classes {r['object_classes']}, centre errors "
                 f"{', '.join(f'{e:.3f}' for e in r['object_centre_err_m'])} m"
                 if r is eao else ""))
    print(f"interactive kidnap and modes (default seed): {json.dumps(modes)}")
    print(f"interactive: fast_nms launches {launches} for {n_fed} frames fed through "
          f"track_monocular; ms per frame (host clock between synchronises, default seed, "
          f"tracked frames): {ms['frame']:.1f} median over {len(times['frame'])} "
          f"non-keyframe frames, {ms['keyframe']:.1f} over {len(times['keyframe'])} keyframe "
          f"frames; traced {json.dumps(traced)}; the phase took {dt:.1f} s")
    print(f"chunked localization mode: {json.dumps(chunked)}")

    # gates
    if launches["fast_nms_tile_max"] != n_fed or launches["fast_nms_comb"] != 0:
        raise AssertionError(f"interactive path: fast_nms launches {launches}, expected one "
                             f"fast_nms_tile_max launch per frame fed ({n_fed})")
    for r in runs:
        if r["tracked"] < INTERACTIVE_MIN_TRACKED * r["total"]:
            raise AssertionError(f"interactive seed {r['seed']}: {r['tracked']}/{r['total']} "
                                 f"frames tracked after initialization")
        if not r["ate_m"] < INTERACTIVE_ATE_LIMIT_M:
            raise AssertionError(f"interactive seed {r['seed']}: sim3 ATE {r['ate_m']:.4f} m >= "
                                 f"{INTERACTIVE_ATE_LIMIT_M:.4f} m")
    median_ate = float(np.median([r["ate_m"] for r in runs]))
    if not median_ate < INTERACTIVE_MEDIAN_ATE_LIMIT_M:
        raise AssertionError(f"interactive median sim3 ATE {median_ate:.4f} m >= "
                             f"{INTERACTIVE_MEDIAN_ATE_LIMIT_M:.4f} m")
    if not (runs[0]["vocab"] and runs[0]["kfdb_holds_every_keyframe"]):
        raise AssertionError("interactive default seed: no vocabulary, or a live keyframe "
                             "missing from the BoW database")
    if eao["objects"] < MIN_OBJECTS or not eao["every_class"]:
        raise AssertionError(f"interactive EAO: objects of classes {eao['object_classes']}")
    if not max(eao["object_centre_err_m"]) < INTERACTIVE_OBJECT_LIMIT_M:
        raise AssertionError(f"interactive EAO: object centre error "
                             f"{max(eao['object_centre_err_m']):.3f} m >= "
                             f"{INTERACTIVE_OBJECT_LIMIT_M:.3f} m")
    if not modes["lost"]:
        raise AssertionError("interactive kidnap: the blank frames did not lose track")
    if modes["reloc_frame"] is None or not modes["reloc_err_m"] < RELOC_LIMIT_M:
        raise AssertionError(f"interactive kidnap: no relocalization within "
                             f"{INTERACTIVE_RELOC_WITHIN} frames, or its error over "
                             f"{RELOC_LIMIT_M} m: {modes}")
    if (modes["loc_counts_before"] != modes["loc_counts_after"]
            or modes["loc_tracked"] < INTERACTIVE_MIN_TRACKED * modes["loc_total"]):
        raise AssertionError(f"interactive localization mode: {modes}")
    if modes["reset_state"] != 2 or modes["reset_keyframes"] < 2:
        raise AssertionError(f"interactive reset: {modes}")
    check_card_against_cpu(card_cpu)
    if chunked["keyframes_added"] != 0 or chunked["tracked"] < 0.9 * chunked["total"] \
            or not chunked["resume_max_diff"] <= CHECKPOINT_TOL:
        raise AssertionError(f"chunked localization mode: {chunked}")
    return {"launches": launches, "frames_fed": n_fed, "median_ate_m": median_ate,
            "by_seed": {r["seed"]: {k: r[k] for k in ("init_frame", "tracked", "total", "ate_m",
                                                     "keyframes", "points", "loops")}
                        for r in runs},
            "eao": {k: eao[k] for k in ("tracked", "total", "ate_m", "objects", "object_classes",
                                        "object_centre_err_m")},
            "modes": modes, "card_against_cpu": card_cpu, "chunked_localization": chunked,
            "ms_per_frame": ms,
            "n_timed": {k: len(v) for k, v in times.items()}, "traced": traced,
            "phase_s": dt}


def run_chunked_localization(ts, gt, images) -> dict:
    """The chunked path at the main path's widths: bootstrap and the
    warm-up chunk, then localization mode, a checkpoint, one chunk (no
    keyframe may be added); the checkpoint loaded into a fresh System and
    the same chunk tracked again (poses to CHECKPOINT_TOL)."""
    import tempfile

    from eao_slam_torch.system import System

    cfg = main_config(SEEDS[0])
    sysm = System(cfg, chunk=CHUNK)
    i = 0
    while not sysm.tracker.armed:
        sysm.track_monocular(images[i], float(ts[i]))
        i += 1
    for _ in range(CHUNK):
        sysm.track_monocular(images[i], float(ts[i]))
        i += 1
    sysm.flush()
    sysm.activate_localization_mode()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "localization.ckpt")
        sysm.save_checkpoint(path)
        kf0 = sysm.tracker.kf_count_host
        n0 = len(sysm.tracker.records)
        for k in range(i, i + CHUNK):
            sysm.track_monocular(images[k], float(ts[k]))
        recs = sysm.tracker.records[n0:]
        again = System(cfg, chunk=CHUNK)
        meta = again.load_checkpoint(path)
        for k in range(i, i + CHUNK):
            again.track_monocular(images[k], float(ts[k]))
        recs2 = again.tracker.records[n0:]
    same = [(a[1], b[1]) for a, b in zip(recs, recs2)]
    diff = max((float(np.abs(a - b).max()) if a is not None and b is not None
                else (0.0 if a is None and b is None else float("inf"))) for a, b in same)
    return {"keyframes_added": sysm.tracker.kf_count_host - kf0,
            "tracked": sum(r[1] is not None for r in recs), "total": len(recs),
            "saved_in_localization_mode": bool(meta["localization_only"]),
            "resumed_in_localization_mode": not again.tracker.carry.allow_kf,
            "resume_max_diff": diff}


def write_tum_sequence(d: str, ts, gt, images, boxes) -> None:
    """A TUM sequence directory: rgb/<stamp>.png (viz.raster.save_png),
    rgb.txt, groundtruth.txt (io.trajectory.save_tum of the true poses) and
    yolo_txts/<stamp>.txt, each box as ``class x y w h score`` (the
    offline-YOLO format, as tests/test_cli.py writes it); stamps are
    STAMP0 + ts."""
    from eao_slam_torch.io.trajectory import save_tum
    from eao_slam_torch.viz.raster import save_png

    os.makedirs(os.path.join(d, "rgb"))
    os.makedirs(os.path.join(d, "yolo_txts"))
    rows = []
    for k, img in enumerate(images):
        stamp = f"{STAMP0 + ts[k]:.6f}"
        save_png(os.path.join(d, "rgb", f"{stamp}.png"), np.asarray(img))
        rows.append(f"{stamp} rgb/{stamp}.png")
        bxs, cls, score, valid = (np.asarray(x) for x in boxes[k])
        with open(os.path.join(d, "yolo_txts", f"{stamp}.txt"), "w") as f:
            for b in np.flatnonzero(valid):
                x, y, w, h = bxs[b]
                f.write(f"{cls[b]} {x:.1f} {y:.1f} {w:.1f} {h:.1f} {score[b]:.2f}\n")
    with open(os.path.join(d, "rgb.txt"), "w") as f:
        f.write("# timestamp filename\n" + "\n".join(rows) + "\n")
    save_tum(os.path.join(d, "groundtruth.txt"), STAMP0 + np.asarray(ts), gt)


EXPORTS = {"keyframes": "KeyFrameTrajectory.txt", "frames_tracked": "FrameTrajectory.txt",
           "objects": "objects.json", "semidense_points": "semidense.obj",
           "lines3d": "lines3d.obj", "mesh_tris": "mesh.obj"}


def cli_figures(out: str, stats: dict, ts, gt) -> dict:
    """A mono_tum run's figures from its exports (either package's): each
    export parsed with the port's loaders (written exactly when its count is
    above 0, as the System's save_* calls do), the frame that initialized,
    the share tracked after it, the sim3 ATE of FrameTrajectory.txt against
    the truth, the live objects' classes."""
    from eao_slam_torch.evaluation import load_cloud
    from eao_slam_torch.io.trajectory import ate_rmse
    from eao_slam_torch.io.tum import load_groundtruth

    parsed = {}
    for key, name in EXPORTS.items():
        path = os.path.join(out, name)
        if name.endswith(".txt"):
            parsed[key] = len(load_groundtruth(path).timestamps)
        elif name.endswith(".json"):
            with open(path) as f:
                parsed[key] = len(json.load(f))
        elif os.path.exists(path):
            parsed[key] = len(load_cloud(path))
        else:
            parsed[key] = 0
    traj = load_groundtruth(os.path.join(out, EXPORTS["frames_tracked"]))
    idx = np.array([int(np.argmin(np.abs(STAMP0 + ts - t))) for t in traj.timestamps])
    init = int(idx[0])
    with open(os.path.join(out, EXPORTS["objects"])) as f:
        classes = sorted(o["class"] for o in json.load(f))
    return {"parsed": parsed, "init_frame": init, "tracked": len(idx),
            "total": len(ts) - init, "tracked_share": len(idx) / (len(ts) - init),
            "ate_m": float(ate_rmse(traj.t_wc, centers(gt[idx]), with_scale=True)),
            "object_classes": classes}


def check_cli(fig: dict, stats: dict) -> None:
    scene_classes = set(int(c) for c in bench_scene().obj_classes)
    for key, name in EXPORTS.items():
        got, want = fig["parsed"][key], stats[key]
        # the obj files hold a vertex per point, two per segment, three per triangle
        if (got != want) if key not in ("lines3d", "mesh_tris") else ((got > 0) != (want > 0)):
            raise AssertionError(f"mono_tum: {name} parses to {got} rows, the run reported {want}")
    if fig["tracked_share"] < CLI_MIN_TRACKED:
        raise AssertionError(f"mono_tum: {fig['tracked']} of {fig['total']} frames tracked "
                             f"after initialization")
    if len(fig["object_classes"]) < MIN_OBJECTS or not scene_classes <= set(fig["object_classes"]):
        raise AssertionError(f"mono_tum: objects {fig['object_classes']}")
    if not fig["ate_m"] < CLI_ATE_LIMIT_M:
        raise AssertionError(f"mono_tum: sim3 ATE {fig['ate_m']:.4f} m >= {CLI_ATE_LIMIT_M:.4f} m")


MONO_TUM_CODE = ("import json, sys\n"
                 "from eao_slam_torch import cli\n"
                 "from eao_slam_torch.ops import fast_nms\n"
                 "rc = cli.main(sys.argv[1:])\n"
                 "print(json.dumps({'launches': fast_nms.launches}))\n"
                 "sys.exit(rc)\n")


def run_cli(ts, gt, images, clock_hz: float) -> dict:
    """The command-line drivers (the module docstring's phase 12)."""
    import tempfile

    import torch

    from eao_slam_torch.cli import run_mono_euroc, run_mono_kitti
    from eao_slam_torch.geometry.camera import EUROC, TUM3
    from eao_slam_torch.geometry.camera import undistort_points
    from eao_slam_torch.io.trajectory import ate_rmse, load_kitti_poses
    from eao_slam_torch.io.tum import load_groundtruth
    from eao_slam_torch.ops import fast_nms
    from eao_slam_torch.ops.image import build_pyramid
    from eao_slam_torch.ops.orb import extract_orb
    from eao_slam_torch.viz.raster import save_png

    t_phase = time.perf_counter()
    out = {}
    jobs = render_jobs()
    kitti_imgs = rendered("kitti", jobs["kitti"])
    euroc_imgs = rendered("euroc", jobs["euroc"])
    ts_d, gt_d = driver_arc()
    with tempfile.TemporaryDirectory() as d:
        # mono_tum, a subprocess on the card: cli.main as `python -m
        # eao_slam_torch.cli` runs it, with the FAST kernel's launches after it
        seq, res = os.path.join(d, "tum"), os.path.join(d, "tum_out")
        t0 = time.perf_counter()
        write_tum_sequence(seq, ts, gt, images, bench_boxes(gt))
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", MONO_TUM_CODE, "mono_tum", "EAO", seq, res],
                              cwd=HERE, capture_output=True, text=True, timeout=900)
        t_run = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"mono_tum exited {proc.returncode}:\n{proc.stderr[-4000:]}")
        lines = proc.stdout.strip().splitlines()
        stats, launches = json.loads(lines[-2]), json.loads(lines[-1])["launches"]
        fig = cli_figures(res, stats, ts, gt)
        print(f"mono_tum EAO ({len(images)} frames written in {t_write:.1f} s; the run "
              f"{t_run:.1f} s with the process's start): loader backend "
              f"{stats['loader_backend']}; initialized at frame {fig['init_frame']}, "
              f"{fig['tracked']}/{fig['total']} tracked after it, sim3 ATE {fig['ate_m']:.4f} m "
              f"(limit {CLI_ATE_LIMIT_M:.4f} m), objects {fig['object_classes']}, keyframes "
              f"{stats['keyframes']}; exports {fig['parsed']}; launches {launches}; "
              f"the reference's run_mono_tum on this directory, on the CPU: {REFERENCE_CLI}")
        check_cli(fig, stats)
        if launches["fast_nms_tile_max"] <= 0:
            raise AssertionError("mono_tum never launched fast_nms_tile_max")
        out["mono_tum"] = {**fig, "stats": stats, "launches": launches, "seconds": t_run,
                           "reference": REFERENCE_CLI}

        # mono_kitti, in this process
        kseq = os.path.join(d, "kitti", "00")
        os.makedirs(os.path.join(kseq, "image_2"))
        with open(os.path.join(kseq, "times.txt"), "w") as f:
            for i in range(DRIVER_FRAMES):
                save_png(os.path.join(kseq, "image_2", "%06d.png" % i), kitti_imgs[i])
                f.write(f"{ts_d[i]:.6f}\n")
        fast_nms.reset_launches()
        t0 = time.perf_counter()
        kstats = run_mono_kitti("None", kseq, 0, os.path.join(d, "kitti_out"))
        t_kitti = time.perf_counter() - t0
        klaunch = dict(fast_nms.launches)
        P = load_kitti_poses(os.path.join(d, "kitti_out", "CameraTrajectory.txt"))
        first = float(np.abs(P[0] - np.eye(4)[:3]).max()) if len(P) else float("inf")
        print(f"mono_kitti None (KITTI00_02, {DRIVER_FRAMES} frames, {t_kitti:.1f} s): "
              f"{kstats['frames_tracked']} tracked, {kstats['kitti_rows']} KITTI rows, first pose "
              f"{first:.3g} from the identity; loader backend {kstats['loader_backend']}; "
              f"launches {klaunch}")
        if (kstats["frames_tracked"] < DRIVER_MIN_TRACKED
                or kstats["kitti_rows"] != kstats["frames_tracked"]
                or not first <= KITTI_IDENTITY_TOL or klaunch["fast_nms_tile_max"] <= 0):
            raise AssertionError(f"mono_kitti: {kstats}, first pose {first:.3g}, {klaunch}")
        out["mono_kitti"] = {"stats": kstats, "first_pose_max_abs_diff": first,
                             "launches": klaunch, "seconds": t_kitti}

        # mono_euroc, in this process; the renderer applies no distortion,
        # so the ATE is printed, not gated
        eseq = os.path.join(d, "euroc")
        os.makedirs(eseq)
        stamps = [EUROC_STAMP0 + int(round(t * 1e9)) for t in ts_d]
        for i in range(DRIVER_FRAMES):
            save_png(os.path.join(eseq, f"{stamps[i]}.png"), euroc_imgs[i])
        fast_nms.reset_launches()
        t0 = time.perf_counter()
        estats = run_mono_euroc("None", eseq, None, os.path.join(d, "euroc_out"))
        t_euroc = time.perf_counter() - t0
        elaunch = dict(fast_nms.launches)
        traj = load_groundtruth(os.path.join(d, "euroc_out", "FrameTrajectory.txt"))
        eidx = [int(np.argmin(np.abs(np.asarray(stamps) / 1e9 - t))) for t in traj.timestamps]
        eate = (float(ate_rmse(traj.t_wc, centers(gt_d[eidx]), with_scale=True))
                if len(eidx) >= 3 else None)
        kp = extract_orb(torch.as_tensor(euroc_imgs[0], device="cuda").float()[None]).kp[0]
        und = (undistort_points(EUROC, kp).cpu() - undistort_points(EUROC, kp.cpu())).abs().max()
        und = float(und)
        print(f"mono_euroc None (EuRoC camera, {DRIVER_FRAMES} frames, {t_euroc:.1f} s): "
              f"{estats['frames_tracked']} tracked, sim3 ATE {eate} m (printed: the renderer "
              f"applies no distortion); loader backend {estats['loader_backend']}; launches "
              f"{elaunch}; undistort_points of frame 0's {kp.shape[0]} keypoints, card against "
              f"CPU: max |diff| {und:.3g} px (limit {UNDISTORT_TOL_PX:g})")
        if (estats["frames_tracked"] < DRIVER_MIN_TRACKED or not und <= UNDISTORT_TOL_PX
                or elaunch["fast_nms_tile_max"] <= 0):
            raise AssertionError(f"mono_euroc: {estats}, undistortion {und:.3g} px, {elaunch}")
        out["mono_euroc"] = {"stats": estats, "ate_m": eate, "undistort_max_abs_px": und,
                             "launches": elaunch, "seconds": t_euroc}

    # the FAST kernel at the drivers' shapes: 32 rendered frames (the
    # drivers' 24, then their first 8 again), 8 levels at 1.2
    inputs = {}
    for name, imgs in (("KITTI00_02", kitti_imgs), ("EuRoC", euroc_imgs)):
        frames = torch.as_tensor(np.concatenate([imgs, imgs[:CHUNK - len(imgs)]]),
                                 device="cuda").float()
        inputs[name] = tuple(x.contiguous() for x in build_pyramid(frames, 8, 1.2))
    out["kernels"] = check_fast_nms(inputs, border=19, clock_hz=clock_hz)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"the command-line drivers' phase took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# the parallel layer (phase 13): NCCL at one rank, two gloo ranks on the card
# ---------------------------------------------------------------------------

# the distributed solvers against the single-card solver on the circuit's
# recorded global-BA problem, at the bounds the CPU tests state
# (tests/test_torch_parallel_ba.py, the reference's tests/test_dist_ba*.py
# and test_mesh_engine.py): the cost within 1.5 x the single-card solve's
# and >= 95 % of the inlier decisions shared, for every solver; camera
# translations within 0.01 of the single-card solve's for dist_ba and
# dist_ba2 direct, within 5e-3 of local_ba's for the 5 + 10 ba_solver. The
# CG solver's cameras are printed, not gated: the loop-time global BA
# fixes one keyframe, so the monocular scale is free (ROADMAP Queue 3,
# loop closure conditioning), and 32 CG steps stop before they settle
# along that flat direction (on the card 0.12 from the single card's
# translations at the same cost to 4e-5; the CPU tests hold CG against
# the truth on problems with a two-camera gauge). Each problem of the
# batch within 0.015 of its single-card bundle_adjust (the bound
# tests/test_multi_seq.py holds against the truth; the truth's is
# printed: these problems are drawn afresh)
PAR_POSE_TOL = {"dist_ba": 0.01, "v2_direct": 0.01, "ba_solver": 5e-3, "v2_cg": None}
PAR_COST_FACTOR = 1.5
PAR_INLIER_AGREE = 0.95
PAR_BATCH_TOL = 0.015
PAR_BATCH = 11                # problems in batch_bundle_adjust (pad path on 2 ranks)
PAR_CHUNKS = 2                # chunks after the warm-up in System(mesh=...)
PAR_ENGINE_ROUNDS = 2         # MultiSeqEngine chunks after each bootstrap
PAR_RANK_TIMEOUT_S = 420
OK_STATE = 2


def synthetic_ba_problem(rng, K: int = 4, P: int = 128):
    """tests/test_ba.py's make_ba_problem in numpy and the port's se3: K
    cameras along a short arc looking at P points 4-9 units away, 0.5 px
    noise, the first two cameras fixed and exact, the others perturbed by
    0.02 and the points by 0.05; the observation table padded to K x P
    rows, so that every problem has one shape. Returns (numpy fields, true
    poses)."""
    import torch

    from eao_slam_torch.geometry import se3
    from eao_slam_torch.geometry.camera import TUM3

    X = np.stack([rng.uniform(-2, 2, P), rng.uniform(-1.5, 1.5, P),
                  rng.uniform(4, 9, P)], -1).astype(np.float32)
    poses = []
    for k in range(K):
        ang = 0.04 * (k - K / 2)
        eye = np.array([0.5 * np.sin(ang * 4), 0.05 * k, 0.15 * k])
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
        poses.append(np.concatenate([R, (-R @ eye)[:, None]], 1).astype(np.float32))
    poses = np.stack(poses)
    kf, pt, uv = [], [], []
    for k in range(K):
        pc = X @ poses[k, :, :3].T + poses[k, :, 3]
        u = np.stack([TUM3.fx * pc[:, 0] / pc[:, 2] + TUM3.cx,
                      TUM3.fy * pc[:, 1] / pc[:, 2] + TUM3.cy], -1)
        vis = (pc[:, 2] > 0.2) & (u[:, 0] > 0) & (u[:, 0] < 640) & (u[:, 1] > 0) & (u[:, 1] < 480)
        for q in np.nonzero(vis)[0]:
            kf.append(k)
            pt.append(q)
            uv.append(u[q] + rng.normal(0, 0.5, 2))
    poses0 = poses.copy()
    for k in range(2, K):
        xi = torch.as_tensor(rng.normal(0, 0.02, 6).astype(np.float32))
        poses0[k] = se3.compose(se3.exp(xi), torch.as_tensor(poses0[k])).numpy()
    O, pad = len(kf), K * P - len(kf)       # one observation bucket: K x P rows
    fields = dict(poses=poses0, points=(X + rng.normal(0, 0.05, X.shape)).astype(np.float32),
                  kf_idx=np.pad(np.asarray(kf, np.int32), (0, pad)),
                  pt_idx=np.pad(np.asarray(pt, np.int32), (0, pad)),
                  uv=np.pad(np.asarray(uv, np.float32), ((0, pad), (0, 0))),
                  inv_sigma2=np.ones(K * P, np.float32), obs_valid=np.arange(K * P) < O,
                  cam_fixed=np.arange(K) < 2, cam_valid=np.ones(K, bool),
                  pt_valid=np.ones(P, bool))
    return fields, poses


def _ba_problem(fields: dict, device):
    import torch

    from eao_slam_torch.solvers.ba import BAProblem

    return BAProblem(**{k: torch.as_tensor(np.array(v), device=device)
                        for k, v in fields.items()})


def _ba_host(res) -> dict:
    return {k: getattr(res, k).detach().cpu().numpy() for k in res._fields}


def _timed_host(fn, device):
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def arc_prefix_run(sysm, ts, images, n_chunks: int) -> dict:
    """The main path's protocol cut short: bootstrap, the warm-up chunk
    (cut as run_main_path cuts it), then n_chunks chunks; the frame
    trajectory and the records. The FAST kernel's launches counted."""
    from eao_slam_torch.ops import fast_nms

    fast_nms.reset_launches()
    i = 0
    while i < len(images) and not sysm.tracker.armed:
        sysm.track_monocular(images[i], float(ts[i]))
        i += 1
    if not sysm.tracker.armed:
        raise AssertionError("two-view initialization never succeeded")
    n_warm = min(CHUNK, N_FRAMES - N_TIMED * CHUNK - i)
    for k in range(i, i + n_warm + n_chunks * CHUNK):
        sysm.track_monocular(images[k], float(ts[k]))
    sysm.flush()
    sync(sysm.device)
    t, T = sysm.tracker.frame_trajectory()
    return {"ts": t, "T": T, "records": len(sysm.tracker.records), "n_boot": i,
            "launches": dict(fast_nms.launches)}


def solo_run(cfg, ts, images, rounds: int, device=None, chunk: int = CHUNK) -> dict:
    """A sequence tracked alone, as MultiSeqEngine tracks one: bootstrap,
    then ``rounds`` full chunks."""
    from eao_slam_torch.runtime.frame import frame_from_image
    from eao_slam_torch.runtime.scan_tracker import ChunkedTracker

    t = ChunkedTracker(cfg, chunk=chunk, device=device)
    i = 0
    while i < len(images) and t.carry is None:
        t.bootstrap(frame_from_image(cfg, images[i], t.device), float(ts[i]))
        i += 1
    for _ in range(rounds):
        t.track_images(images[i:i + chunk], ts[i:i + chunk])
        i += chunk
    sync(t.device)
    kts, kT = t.keyframe_trajectory()
    return {"frame": t.frame_trajectory(), "keyframe": (kts, kT), "start": i - rounds * chunk}


def _solver_suite(problem: dict, batch: list, device, n_ranks: int) -> dict:
    """The distributed solvers on the recorded problem (dist_ba; dist_ba2
    direct and cg, 10 iterations each; the chunked tracker's ba_solver,
    5 + 10) and batch_bundle_adjust over the synthetic batch, each timed
    on the host clock between synchronises."""
    from eao_slam_torch.geometry.camera import TUM3
    from eao_slam_torch.parallel.dist_ba import distributed_bundle_adjust, make_ba_mesh
    from eao_slam_torch.parallel.dist_ba2 import distributed_bundle_adjust_v2
    from eao_slam_torch.parallel.frames import make_frame_mesh
    from eao_slam_torch.parallel.multi_seq import batch_bundle_adjust
    from eao_slam_torch.runtime.scan_tracker import ChunkedTracker

    prob = _ba_problem(problem, device)
    out, secs = {}, {}
    mesh = make_ba_mesh(device)
    res, secs["dist_ba"] = _timed_host(
        lambda: distributed_bundle_adjust(TUM3, prob, mesh, iters=10), device)
    out["dist_ba"] = _ba_host(res)
    tracker = ChunkedTracker(main_config(SEEDS[0]), chunk=CHUNK, device=device,
                             mesh=make_frame_mesh(device))
    hd = tracker._ba_mesh
    if hd is None:           # one rank: the single-device schedule, as the reference
        from eao_slam_torch.parallel.dist_ba2 import make_hd_mesh

        hd = make_hd_mesh(1, device)
        out["ba_solver_is_none"] = tracker.ba_solver is None
    for method in ("direct", "cg"):
        res, secs[f"v2_{method}"] = _timed_host(
            lambda: distributed_bundle_adjust_v2(TUM3, prob, hd, iters=10, method=method),
            device)
        out[f"v2_{method}"] = _ba_host(res)
    if tracker.ba_solver is not None:
        res, secs["ba_solver"] = _timed_host(lambda: tracker.ba_solver(TUM3, prob), device)
        out["ba_solver"] = _ba_host(res)
    probs = [_ba_problem(f, device) for f in batch]
    res, secs["batch"] = _timed_host(
        lambda: batch_bundle_adjust(TUM3, probs, make_ba_mesh(device), iters=8), device)
    out["batch"] = [_ba_host(r) for r in res]
    out["seconds"] = secs
    out["mesh_shape"] = hd.ranks.tolist()
    return out


def parallel_rank(d: str) -> int:
    """One rank of the parallel phase (``chip_smoke.py --parallel-rank
    DIR``, started by run_parallel with the EAO_* variables and
    EAO_BACKEND): joins the group through initialize_from_env; at one rank
    the solvers, at two also System(mesh=...) over the arc's prefix and a
    MultiSeqEngine over the arc and the tilted arc. Writes its results to
    DIR/<backend>_rank<r>.npy."""
    import torch
    import torch.distributed as dist

    from eao_slam_torch.ops import fast_nms
    from eao_slam_torch.parallel.distributed import initialize_from_env, rank_device, world

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    backend = os.environ["EAO_BACKEND"]
    if not initialize_from_env(backend=backend, timeout_s=PAR_RANK_TIMEOUT_S):
        raise RuntimeError("EAO_COORDINATOR is not set")
    rank, n = world()
    device = rank_device()
    data = np.load(os.path.join(d, "inputs.npy"), allow_pickle=True).item()
    out = {"rank": rank, "world": n, "backend": dist.get_backend(), "device": str(device),
           "card": torch.cuda.get_device_name(device), "joined_s": time.perf_counter() - t0}
    out["solvers"] = _solver_suite(data["problem"], data["batch"], device, n)
    if n > 1:
        from eao_slam_torch.parallel.frames import make_frame_mesh
        from eao_slam_torch.parallel.multi_seq import MultiSeqEngine, make_seq_mesh
        from eao_slam_torch.system import System

        ts, images = data["ts"], np.load(os.path.join(d, "arc.npy"), mmap_mode="r")
        sysm = System(main_config(SEEDS[0]), chunk=CHUNK, mesh=make_frame_mesh(device))
        t1 = time.perf_counter()
        out["system_mesh"] = arc_prefix_run(sysm, ts, images, PAR_CHUNKS)
        out["system_mesh"]["seconds"] = time.perf_counter() - t1

        tilted = np.load(os.path.join(d, "tilted.npy"), mmap_mode="r")
        seqs = [(ts, images), (ts[:TILT_FRAMES], tilted)]
        eng = MultiSeqEngine(main_config(SEEDS[0]), n_seq=2, chunk=CHUNK,
                             mesh=make_seq_mesh(device))
        fast_nms.reset_launches()
        t1 = time.perf_counter()
        starts = []
        for s, (ts_s, im_s) in enumerate(seqs):
            i = 0
            while i < len(im_s) and not eng.bootstrap(s, im_s[i], float(ts_s[i])):
                i += 1
            starts.append(i + 1)
        for k in range(PAR_ENGINE_ROUNDS):
            eng.track_images(
                np.stack([im[st + k * CHUNK: st + (k + 1) * CHUNK]
                          for st, (_, im) in zip(starts, seqs)]),
                np.stack([ts_s[st + k * CHUNK: st + (k + 1) * CHUNK]
                          for st, (ts_s, _) in zip(starts, seqs)]))
        sync(device)
        out["engine"] = {"starts": starts, "owned": list(eng.owned),
                         "frame": [eng.frame_trajectory(s) for s in range(2)],
                         "keyframe": [eng.keyframe_trajectory(s) for s in range(2)],
                         "state": [eng.state(s) for s in range(2)],
                         "launches": dict(fast_nms.launches),
                         "seconds": time.perf_counter() - t1}
    out["seconds"] = time.perf_counter() - t0
    np.save(os.path.join(d, f"{backend}_rank{rank}.npy"), out, allow_pickle=True)
    dist.destroy_process_group()
    print(f"rank {rank} of {n} ({backend}, {device}): done in {out['seconds']:.1f} s", flush=True)
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def start_ranks(d: str, n: int, backend: str) -> list:
    """Start n rank processes of this script on the card, wait for all,
    and return their results; a rank that fails or outlives the timeout
    fails the phase (every process started is stopped)."""
    env = dict(os.environ, EAO_COORDINATOR=f"localhost:{_free_port()}",
               EAO_NUM_PROCESSES=str(n), EAO_BACKEND=backend, EAO_LOCAL_RANK="0")
    procs = []
    try:
        for r in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--parallel-rank", d],
                env=dict(env, EAO_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate(timeout=PAR_RANK_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        tail = "\n".join(log.strip().splitlines()[-40:])
        if p.returncode != 0:
            raise AssertionError(f"{backend} rank {r} of {n} exited {p.returncode}:\n{tail}")
        print(tail.splitlines()[-1] if tail else f"{backend} rank {r}: no output")
    return [np.load(os.path.join(d, f"{backend}_rank{r}.npy"), allow_pickle=True).item()
            for r in range(n)]


def _t_err(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a)[:, :, 3] - np.asarray(b)[:, :, 3], axis=1).max())


def check_solvers(got: dict, single: dict, tag: str) -> dict:
    """Every distributed solve against the single-card solves of the same
    problem (module constants PAR_*)."""
    figures = {}
    for name, res in got.items():
        if name not in PAR_POSE_TOL:
            continue
        ref = single["local_ba" if name == "ba_solver" else "bundle_adjust"]
        tol = PAR_POSE_TOL[name]
        K = ref["poses"].shape[0]
        f = {"t_err": _t_err(res["poses"][:K], ref["poses"]),
             "cost": float(res["cost"]), "single_cost": float(ref["cost"]),
             "inliers_shared": float(np.mean(res["obs_inlier"] == ref["obs_inlier"])),
             "seconds": got["seconds"][name]}
        figures[name] = f
        print(f"{tag} {name}: camera translations {f['t_err']:.3g} from the single-card "
              f"solve's, cost {f['cost']:.6g} against {f['single_cost']:.6g}, inlier decisions "
              f"shared {100 * f['inliers_shared']:.2f} %, {f['seconds']:.3f} s")
        if not ((tol is None or f["t_err"] < tol)
                and f["cost"] <= PAR_COST_FACTOR * f["single_cost"] + 1e-3
                and f["inliers_shared"] > PAR_INLIER_AGREE):
            raise AssertionError(f"{tag} {name} disagrees with the single-card solve: {f}")
    errs = [_t_err(r["poses"], s["poses"]) for r, s in zip(got["batch"], single["batch"])]
    truth = [_t_err(r["poses"], tr) for r, tr in zip(got["batch"], single["batch_truth"])]
    figures["batch"] = {"max_t_err": max(errs), "max_t_err_vs_truth": max(truth),
                        "seconds": got["seconds"]["batch"]}
    print(f"{tag} batch_bundle_adjust over {len(errs)} problems: worst camera {max(errs):.3g} "
          f"from the single-card bundle_adjust's ({max(truth):.3g} from the truth, printed), "
          f"{got['seconds']['batch']:.3f} s")
    if not max(errs) < PAR_BATCH_TOL:
        raise AssertionError(f"{tag} batch_bundle_adjust: {max(errs):.3g} >= {PAR_BATCH_TOL}")
    return figures


def _traj_diff(a, b) -> float:
    """Largest pose difference of two frame trajectories (ts, T) over a's
    frames (b may run longer); inf when a's timestamps are not b's."""
    ta, Ta = a
    tb, Tb = b
    n = len(ta)
    if n > len(tb) or not np.array_equal(np.asarray(ta), np.asarray(tb)[:n]):
        return float("inf")
    return float(np.abs(np.asarray(Ta) - np.asarray(Tb)[:n]).max()) if n else 0.0


def run_parallel(ts, gt, images, geometry: dict, problem: dict) -> dict:
    """Phase 13 (the module docstring)."""
    import tempfile

    import torch

    from eao_slam_torch.geometry.camera import TUM3
    from eao_slam_torch.ops.orb import extract_orb
    from eao_slam_torch.solvers.ba import bundle_adjust, local_ba
    from eao_slam_torch.system import System

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    out = {}

    # each rank extracts its half of a chunk: the halves' features must be
    # the whole chunk's bit for bit
    chunk = torch.as_tensor(images[:CHUNK], device=dev).to(torch.float32)
    whole = extract_orb(chunk)
    halves = [extract_orb(chunk[:CHUNK // 2]), extract_orb(chunk[CHUNK // 2:])]
    split_equal = all(torch.equal(torch.cat([getattr(h, f) for h in halves]), getattr(whole, f))
                      for f in whole._fields)
    print(f"parallel: a chunk's features extracted in two halves equal the whole chunk's bit "
          f"for bit: {split_equal}")
    if not split_equal:
        raise AssertionError("frame-sharded extraction would change the features")

    # the single card: the default seed's prefix again (does the run repeat
    # itself bit for bit?), the tilted arc alone, the solvers
    cfg = main_config(SEEDS[0])
    again = arc_prefix_run(System(cfg, chunk=CHUNK), ts, images, PAR_CHUNKS)
    first = geometry["frame_trajectory"]
    repeat = _traj_diff((again["ts"], again["T"]), first)
    if not np.isfinite(repeat):
        raise AssertionError("the single-card run does not repeat its tracked frames")
    print(f"parallel: the default seed's bootstrap, warm-up and {PAR_CHUNKS} chunks again on one "
          f"card: {len(again['ts'])} poses, max |T - T_geometry_phase| {repeat:.3g} (the gate for "
          f"the ranks: {'bit equality' if repeat == 0 else 'this run-to-run difference'})")
    tilted = rendered("tilted", render_jobs()["tilted"])
    solo_t = solo_run(cfg, ts[:TILT_FRAMES], tilted, PAR_ENGINE_ROUNDS)
    single = {}
    prob = _ba_problem(problem, dev)
    res, t_single = _timed_host(lambda: bundle_adjust(TUM3, prob, iters=10), dev)
    single["bundle_adjust"] = _ba_host(res)
    res, t_local = _timed_host(lambda: local_ba(TUM3, prob), dev)
    single["local_ba"] = _ba_host(res)
    rng = np.random.default_rng(100)
    batch, truths = zip(*(synthetic_ba_problem(rng) for _ in range(PAR_BATCH)))
    single["batch_truth"] = truths
    single["batch"] = [_ba_host(bundle_adjust(TUM3, _ba_problem(f, dev), iters=8))
                       for f in batch]
    K = int(problem["cam_valid"].sum())
    print(f"parallel: the circuit's recorded global-BA problem: {K} keyframes, "
          f"{int(problem['pt_valid'].sum())} of {len(problem['pt_valid'])} points, "
          f"{int(problem['obs_valid'].sum())} observations; single card: bundle_adjust (10 "
          f"iterations) {t_single:.3f} s, local_ba (5 + 10) {t_local:.3f} s")

    with tempfile.TemporaryDirectory() as d:
        np.save(os.path.join(d, "arc.npy"), np.ascontiguousarray(images))
        np.save(os.path.join(d, "tilted.npy"), np.ascontiguousarray(tilted))
        np.save(os.path.join(d, "inputs.npy"), {"problem": problem, "batch": list(batch),
                                                "ts": ts}, allow_pickle=True)
        t0 = time.perf_counter()
        nccl = start_ranks(d, 1, "nccl")[0]
        t_nccl = time.perf_counter() - t0
        t0 = time.perf_counter()
        gloo = start_ranks(d, 2, "gloo")
        t_gloo = time.perf_counter() - t0

    print(f"parallel, NCCL at one rank: backend {nccl['backend']} on {nccl['device']} "
          f"({nccl['card']}), joined in {nccl['joined_s']:.1f} s; the rank's run "
          f"{nccl['seconds']:.1f} s, {t_nccl:.1f} s with the process's start")
    if nccl["backend"] != "nccl" or not nccl["solvers"].get("ba_solver_is_none"):
        raise AssertionError(f"NCCL at one rank: backend {nccl['backend']}, ba_solver not None")
    out["nccl"] = check_solvers(nccl["solvers"], single, "parallel, NCCL at one rank,")
    out["nccl"]["seconds"] = t_nccl

    tag = "parallel, two gloo ranks on the card,"
    print(f"{tag} backends {[g['backend'] for g in gloo]} on {[g['device'] for g in gloo]}; the "
          f"ranks' runs {[round(g['seconds'], 1) for g in gloo]} s, {t_gloo:.1f} s with the "
          f"processes' start")
    if any(g["backend"] != "gloo" or g["world"] != 2 for g in gloo):
        raise AssertionError("the two-rank group is not a gloo group of two")
    out["gloo"] = check_solvers(gloo[0]["solvers"], single, tag)
    for key in ("dist_ba", "v2_direct", "v2_cg", "ba_solver"):
        for f in ("poses", "points", "obs_inlier", "cost"):
            if not np.array_equal(gloo[0]["solvers"][key][f], gloo[1]["solvers"][key][f]):
                raise AssertionError(f"{tag} the ranks' {key} {f} differ")

    # System(mesh=...) against the single card, both ranks the same
    gate = repeat
    sm = [(g["system_mesh"]["ts"], g["system_mesh"]["T"]) for g in gloo]
    d_first = _traj_diff(sm[0], first)
    d_again = _traj_diff(sm[0], (again["ts"], again["T"]))
    d_ranks = _traj_diff(sm[0], sm[1])
    launches = [g["system_mesh"]["launches"]["fast_nms_tile_max"] for g in gloo]
    print(f"{tag} System(mesh=...) over the bootstrap ({gloo[0]['system_mesh']['n_boot']} "
          f"frames), the warm-up and {PAR_CHUNKS} chunks: {len(sm[0][0])} poses; max |T - T| "
          f"against the geometry phase {d_first:.3g}, against the single card again "
          f"{d_again:.3g}, between the ranks {d_ranks:.3g}; fast_nms_tile_max launches by rank "
          f"{launches} (single card {again['launches']['fast_nms_tile_max']}); "
          f"{[round(g['system_mesh']['seconds'], 1) for g in gloo]} s")
    if len(sm[0][0]) != len(again["ts"]) or not (d_first <= gate and d_again <= gate
                                                  and d_ranks <= gate):
        raise AssertionError(f"{tag} System(mesh=...) is not the single card's run")
    if min(launches) <= 0:
        raise AssertionError(f"{tag} a rank never launched fast_nms_tile_max: {launches}")

    # MultiSeqEngine: the arc (rank 0) and the tilted arc (rank 1)
    solos = [first, solo_t["frame"]]
    eng_diffs = []
    for r, g in enumerate(gloo):
        e = g["engine"]
        if e["owned"] != [r] or e["state"] != [OK_STATE, OK_STATE]:
            raise AssertionError(f"{tag} engine rank {r}: owned {e['owned']}, states {e['state']}")
        if e["starts"][1] != solo_t["start"]:
            raise AssertionError(f"{tag} the tilted arc's bootstrap differs from its solo run")
        eng_diffs.append([_traj_diff(e["frame"][s], solos[s]) for s in range(2)])
        for s in range(2):      # every rank reads every sequence, its owner's bits
            if _traj_diff(e["frame"][s], gloo[0]["engine"]["frame"][s]) != 0:
                raise AssertionError(f"{tag} the ranks read sequence {s} differently")
        if e["launches"]["fast_nms_tile_max"] <= 0:
            raise AssertionError(f"{tag} engine rank {r} never launched fast_nms_tile_max")
    kf_t = _traj_diff(gloo[1]["engine"]["keyframe"][1], solo_t["keyframe"])
    print(f"{tag} MultiSeqEngine (the arc on rank 0, the tilted arc on rank 1; bootstraps "
          f"{gloo[0]['engine']['starts']}, {PAR_ENGINE_ROUNDS} chunks each): max |T - T_solo| by "
          f"rank and sequence {eng_diffs}, the tilted keyframes {kf_t:.3g}; fast_nms_tile_max "
          f"launches by rank {[g['engine']['launches']['fast_nms_tile_max'] for g in gloo]}; "
          f"{[round(g['engine']['seconds'], 1) for g in gloo]} s")
    if not all(x <= gate for row in eng_diffs for x in row) or not kf_t <= gate:
        raise AssertionError(f"{tag} a MultiSeqEngine sequence is not its solo run")

    dt = time.perf_counter() - t_phase
    print(f"the parallel phase took {dt:.1f} s (NCCL at one rank, then two gloo ranks on "
          f"{torch.cuda.get_device_name(0)})")
    out.update({"split_extraction_equal": split_equal, "run_to_run_max_abs": repeat,
                "system_mesh": {"max_abs_vs_single": max(d_first, d_again),
                                "max_abs_between_ranks": d_ranks,
                                "launches_by_rank": [g["system_mesh"]["launches"] for g in gloo],
                                "seconds_by_rank": [g["system_mesh"]["seconds"] for g in gloo]},
                "engine": {"max_abs_vs_solo": max(max(r) for r in eng_diffs),
                           "launches_by_rank": [g["engine"]["launches"] for g in gloo],
                           "seconds_by_rank": [g["engine"]["seconds"] for g in gloo]},
                "problem": {"keyframes": K, "points": int(problem["pt_valid"].sum()),
                            "observations": int(problem["obs_valid"].sum()),
                            "single_s": t_single, "local_ba_s": t_local},
                "seconds": dt})
    return out



def main() -> int:
    if sys.argv[1:2] == ["--parallel-rank"]:
        return parallel_rank(sys.argv[2])
    try:
        import torch

        from eao_slam_torch.ops import fast_nms
    except ImportError as exc:
        print(f"chip_smoke: the eao_slam_torch package is not beside this script ({exc})",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    global RENDERS
    t_start = time.perf_counter()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")
    RENDERS = Renders(render_jobs())
    try:
        return run_all(t_start)
    finally:
        RENDERS.close()
        RENDERS = None


def run_all(t_start: float) -> int:
    import torch

    from eao_slam_torch.ops import fast_nms

    ts, gt, images = render_sequence()
    card = card_line()
    clock_hz = sm_clock_hz()
    print(f"card: {card}; SM clock for the bound {clock_hz / 1e6:.0f} MHz ({SMS} SMs: "
          f"{SMS * MINMAX_PER_SM_CLOCK * clock_hz / 1e12:.2f} T integer min/max per second)")

    t0 = time.perf_counter()
    fast_nms.build(force=True)
    print(f"build: fast_nms.cu in {time.perf_counter() - t0:.2f} s")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checked = check_fast_nms(kernel_inputs(images), border=19, clock_hz=clock_hz)

    fast_nms.reset_launches()
    path = run_main_path(ts, gt, images, SEEDS[0])
    launches = dict(fast_nms.launches)
    print(f"main path: launches {launches} (the main path takes the tile-max entry; "
          f"fast_nms_comb, the same source's full-map entry, is launched by the checks only)")
    if launches["fast_nms_tile_max"] <= 0:
        raise AssertionError("the main path never launched fast_nms_tile_max")
    check_run(path)

    runs = [path]
    for seed in GEOMETRY_SEEDS[1:]:
        runs.append(run_main_path(ts, gt, images, seed))
        check_run(runs[-1])
    median_ate = float(np.median([r["ate_m"] for r in runs]))
    print(f"sim3 ATE over RANSAC seeds {list(GEOMETRY_SEEDS)}: median {median_ate:.4f} m, "
          f"worst {max(r['ate_m'] for r in runs):.4f} m; loops closed "
          f"{[r['loops'] for r in runs]}")
    if not median_ate < MEDIAN_ATE_LIMIT_M:
        raise AssertionError(f"median sim3 ATE {median_ate:.4f} m >= {MEDIAN_ATE_LIMIT_M:.4f} m")
    main_passes = print_passes("main path, default seed", path["timer"])

    eao = run_eao(ts, gt, images, path)
    print(f"EAO {eao['fps']:.2f} fps against geometry {path['fps']:.2f} fps on this card "
          f"(default seed, 4 timed chunks each)")
    lines = run_lines(ts, gt, images, path, eao)
    full = run_full(ts, gt, images, lines)

    interactive = run_interactive(ts, gt, images)
    long_run = run_long(ts, gt, images)
    circuit = run_circuit()
    loop_problem = circuit.pop("loop_problem")
    drivers = run_cli(ts, gt, images, clock_hz)
    parallel = run_parallel(ts, gt, images, path, loop_problem)
    print(json.dumps({"between_chunk": {
        "main_path_passes": main_passes, "long_run": long_run, "circuit": circuit,
        "card": card}}))

    # per kernel entry: the figures on the random levels (the input of the
    # earlier measurements); the rendered levels' beside them. No single
    # PyTorch call computes either function, so library_ms is null.
    kernels = []
    for name, r in checked.items():
        first = r["by_input"]["random"]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "eao_slam_torch/csrc/fast_nms.cu",
            "replaces": "eao_slam_tpu/ops/fast_pallas.py:89",
            "launches": launches[name],
            "launches_eao_path": eao["launches"][name],
            "launches_line_path": lines["launches"][name],
            "launches_full_path": full["launches"][name],
            "launches_interactive_path": interactive["launches"][name],
            "launches_cli_mono_tum": drivers["mono_tum"]["launches"][name],
            "launches_cli_mono_kitti": drivers["mono_kitti"]["launches"][name],
            "launches_cli_mono_euroc": drivers["mono_euroc"]["launches"][name],
            "launches_parallel_system_mesh_by_rank":
                [r[name] for r in parallel["system_mesh"]["launches_by_rank"]],
            "launches_parallel_engine_by_rank":
                [r[name] for r in parallel["engine"]["launches_by_rank"]],
            "max_abs_err": r["max_abs_err"],
            "ms": first["ms"],
            "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"],
            "library_ms": None,
            "rendered": r["by_input"]["rendered"],
            "one_rendered_frame": r["by_input"]["one rendered frame"],
            "kitti00_02": drivers["kernels"][name]["by_input"]["KITTI00_02"],
            "euroc": drivers["kernels"][name]["by_input"]["EuRoC"],
            "max_abs_err_drivers": drivers["kernels"][name]["max_abs_err"],
            "sm_clock_mhz": clock_hz / 1e6,
        })
    print(json.dumps({"main_path": {
        "fps": path["fps"], "tracked": path["tracked"], "total": path["total"],
        "ate_m": path["ate_m"], "median_ate_m": median_ate,
        "ate_m_by_seed": {r["seed"]: r["ate_m"] for r in runs},
        "loops_by_seed": {r["seed"]: r["loops"] for r in runs}, "card": card}}))
    print(json.dumps({"eao": {k: v for k, v in eao.items() if k != "launches"}, "card": card}))
    print(json.dumps({"lines": {k: v for k, v in lines.items()
                                if k not in ("launches", "default_poses")}, "card": card}))
    print(json.dumps({"full": {k: v for k, v in full.items() if k != "launches"}, "card": card}))
    print(json.dumps({"interactive": {k: v for k, v in interactive.items() if k != "launches"},
                      "card": card}))
    print(json.dumps({"cli": {k: v for k, v in drivers.items() if k != "kernels"}, "card": card}))
    print(json.dumps({"parallel": parallel, "card": card}))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from start to the result lines")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
