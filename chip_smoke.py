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
  4. the same run with six more RANSAC seeds: every run must track >= 90 %
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
     System.track_monocular(..., boxes=...) on the same arc and seeds.
     Gates, on every run: it tracks >= 90 % of its timed frames,
     ends with >= 3 live objects, among them one of each scene object's
     class (bench.py's gate, and every scene object found), stays under
     the ATE limit, and each scene object's centre error stays under the
     object limit; over the seven runs the median ATE stays under its
     limit. The centre error is read in the camera frames of the
     keyframes that observed the object, at the map's own scale
     (eao_slam_torch.io.trajectory.map_object_errors). The limits are 1.5
     times the JAX reference's own EAO spread (reference_ate_spread.py
     --flag EAO, on the CPU; the object limit from its worst on seeds
     12345 and 1-6). The FAST kernel's launches are counted on
     the default seed's run. The object layer's cost per chunk is the
     default seed's EAO chunk time less its geometry chunk time (printed
     with how far the two runs' timed poses differ); the chunk-rate
     iForest cull is also timed alone, on the default seed's final state.
     Each run also prints, ungated, the object measure of the reference's
     tests/test_objects_e2e.py (after one sim3 of the keyframe trajectory);
  9. line mode (DemoFlag.LINE_IFOREST: the object layer with line detection
     in the chunk's front end and line-alignment yaw) at the EAO phase's
     widths with 128 line slots, the same arc, seeds 12345 and 1-4 (five;
     seven before the FULL phase needed the time), the same protocol.
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
 11. print the host-clock time of each between-chunk pass (after a
     synchronise; medians where a pass repeats) and its share of a chunk,
     the card's name and power limit, one JSON line describing every
     kernel, and last the JSON result line.

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
# and 1-6, the seeds gated here, 0.4613 m (seed 5). The port is held to 1.5
# times each, the object centres on every run and every scene object.
EAO_ATE_LIMIT_M = 1.5 * 0.1847
EAO_MEDIAN_ATE_LIMIT_M = 1.5 * 0.1360
EAO_OBJECT_LIMIT_M = 1.5 * 0.4613
N_BOXES = 8
MIN_OBJECTS = 3

# line phase: JAX reference in LineAndiForest mode on the CPU
# (reference_ate_spread.py --flag LineAndiForest) over seeds 12345 and 1-19:
# sim3 ATE worst 0.1847 m (seed 2), median 0.1360 m; 128/128 tracked and 3
# live objects, one of each scene class, on every seed; the worst
# object-centre error over seeds 12345 and 1-6 0.4586 m (seed 5); the
# largest |yaw| an object with 3 or more votes elected, on those seven
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
LINE_OBJECT_LIMIT_M = 1.5 * 0.4586
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
# the line phase runs the first five seeds (seven before the FULL phase came,
# which needed its time)
LINE_SEEDS = SEEDS[:5]

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

_SCENE = None


def _set_scene(scene) -> None:
    global _SCENE
    _SCENE = scene


def _render(T_cw):
    from eao_slam_torch.geometry.camera import TUM3
    from eao_slam_torch.io.synthetic import render_image

    return render_image(_SCENE, TUM3, T_cw)


def bench_scene():
    from eao_slam_torch.io.synthetic import make_room_scene

    return make_room_scene(seed=5, n_landmarks=200, n_objects=3, obj_z_range=(4.0, 5.2))


def bench_boxes(gt) -> list:
    """bench.py's detector boxes: the port's project_boxes of the scene's
    cuboids, N_BOXES slots a frame."""
    from eao_slam_torch.geometry.camera import TUM3
    from eao_slam_torch.io.synthetic import project_boxes

    scene = bench_scene()
    return [project_boxes(scene, TUM3, T, N_BOXES) for T in gt]


def render_sequence(n_frames: int = None):
    """The bench arc (or its first n_frames), rendered with the port's own
    synthetic renderer."""
    from eao_slam_torch.io.synthetic import make_arc_trajectory

    scene = bench_scene()
    ts, gt = make_arc_trajectory(n_frames=N_FRAMES, sweep_deg=60.0)
    ts, gt = ts[:n_frames], gt[:n_frames]
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(
            min(8, os.cpu_count() or 1), initializer=_set_scene, initargs=(scene,)) as pool:
        images = np.stack(pool.map(_render, list(gt)))
    print(f"rendered {len(images)} frames in {time.perf_counter() - t0:.1f} s")
    return ts, gt, images


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
    from eao_slam_torch.config import CapacityConfig, DemoFlag, tum3_config
    from eao_slam_torch.system import System

    objects = boxes is not None
    flag = DemoFlag(flag) if flag else (DemoFlag.EAO if objects else DemoFlag.NONE)
    cfg = tum3_config(flag).replace(
        capacity=CapacityConfig(max_keyframes=128, max_points=8192,
                                max_features=1024, local_ba_points=2048,
                                **(dict(max_boxes=N_BOXES, max_objects=32) if objects else {})),
        seed=seed,
    )
    sysm = System(cfg, chunk=CHUNK, device=device)
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
           "loops": loops, "poses": poses}
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
    for seed in SEEDS[1:]:
        runs.append(run_main_path(ts, gt, images, seed, boxes=boxes))
        check_eao_run(runs[-1])
    median_ate = float(np.median([r["ate_m"] for r in runs]))
    print(f"EAO over seeds {list(SEEDS)}: sim3 ATE median {median_ate:.4f} m, worst "
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

    Q = _tilt(*TILT_DEG)
    gt_t = np.stack([np.concatenate([T[:3, :3] @ Q.T, T[:3, 3:4]], 1) for T in gt[:TILT_FRAMES]])
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(
            min(8, os.cpu_count() or 1), initializer=_set_scene, initargs=(bench_scene(),)) as pool:
        images = np.stack(pool.map(_render, list(gt_t)))
    t_render = time.perf_counter() - t0
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
          f"{TILT_DEG[1]} deg (rendered in {t_render:.1f} s), {tracked} tracked; first keyframe "
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
    chunk of the same seed), seeds 1-6, the ground-alignment run, and the
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

    return depth_cloud(_SCENE, TUM3, T_cw[None, 1], T_cw[0])


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
    with multiprocessing.get_context("spawn").Pool(
            min(8, os.cpu_count() or 1), initializer=_set_scene, initargs=(bench_scene(),)) as pool:
        truth = np.concatenate(pool.map(_render_depth, [np.stack([T_ref, gt[f]])
                                                         for f in frames]))
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
        for i in range(CIRCUIT_FRAMES):
            sysm.track_frame(frames[i], float(ts[i]))
            n_boot += not sysm._armed
        sysm.flush()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
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


def main() -> int:
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

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")
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
    for seed in SEEDS[1:]:
        runs.append(run_main_path(ts, gt, images, seed))
        check_run(runs[-1])
    median_ate = float(np.median([r["ate_m"] for r in runs]))
    print(f"sim3 ATE over RANSAC seeds {list(SEEDS)}: median {median_ate:.4f} m, "
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

    long_run = run_long(ts, gt, images)
    circuit = run_circuit()
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
            "max_abs_err": r["max_abs_err"],
            "ms": first["ms"],
            "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"],
            "library_ms": None,
            "rendered": r["by_input"]["rendered"],
            "one_rendered_frame": r["by_input"]["one rendered frame"],
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
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
