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
  3. drive the main path at full width through the port's System: geometry
     mode, 640x480, 1024 features, 8 levels, chunk 32, on the rendered
     60-degree arc; bootstrap, one warm-up chunk, four timed chunks. Checks
     tracked share >= 90 %, the sim3 ATE of the timed frames against ground
     truth, and that the kernel entry the path uses was launched on that run;
  4. the same run with six more RANSAC seeds: every run must track >= 90 %
     of its frames and stay under the ATE limit, and the median ATE must
     stay under the median limit. Both limits are 1.5 times the JAX
     reference's own worst and median ATE over twenty seeds
     (reference_ate_spread.py, on the CPU): the tracker is chaotic, so one
     run's ATE is a draw from a spread, and the reference itself meets
     bench.py's 5 cm gate with two of the twenty seeds only;
  5. print the card's name and power limit, one JSON line describing every
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

CHUNK = 32
N_TIMED = 4
N_FRAMES = 8 + CHUNK * (1 + N_TIMED)

_SCENE = None


def _set_scene(scene) -> None:
    global _SCENE
    _SCENE = scene


def _render(T_cw):
    from eao_slam_torch.geometry.camera import TUM3
    from eao_slam_torch.io.synthetic import render_image

    return render_image(_SCENE, TUM3, T_cw)


def render_sequence(n_frames: int = None):
    """The bench arc (or its first n_frames), rendered with the port's own
    synthetic renderer."""
    from eao_slam_torch.io.synthetic import make_arc_trajectory, make_room_scene

    scene = make_room_scene(seed=5, n_landmarks=200, n_objects=3, obj_z_range=(4.0, 5.2))
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


def run_main_path(ts, gt, images, seed: int) -> dict:
    """Bootstrap, warm-up and timed chunks through System.track_monocular
    with the given RANSAC seed. Returns the tracked frames, sim3 ATE and
    fps of the timed chunks."""
    import torch

    from eao_slam_torch.config import CapacityConfig, TrackingConfig, tum3_config
    from eao_slam_torch.io.trajectory import ate_rmse
    from eao_slam_torch.system import System

    cfg = tum3_config().replace(
        tracking=TrackingConfig(enable_loop_closing=False),
        capacity=CapacityConfig(max_keyframes=128, max_points=8192,
                                max_features=1024, local_ba_points=2048),
        seed=seed,
    )
    sysm = System(cfg, chunk=CHUNK)
    assert sysm.device.type == "cuda"
    i = 0
    while i < len(images) and not sysm.tracker.armed:
        sysm.track_monocular(images[i], float(ts[i]))
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
        sysm.track_monocular(images[i], float(ts[i]))
        i += 1
    sysm.flush()
    torch.cuda.synchronize()
    lo = i
    t0 = time.perf_counter()
    for _ in range(N_TIMED * CHUNK):
        sysm.track_monocular(images[i], float(ts[i]))
        i += 1
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0

    recs = sysm.tracker.records[lo:i]
    assert len(recs) == N_TIMED * CHUNK, len(recs)
    ok = np.array([r[1] is not None for r in recs])
    poses = np.stack([r[1] for r in recs if r[1] is not None])
    if not np.isfinite(poses).all():
        raise AssertionError("non-finite poses")
    centers = lambda Ts: np.einsum("nij,ni->nj", -Ts[:, :3, :3], Ts[:, :3, 3])  # noqa: E731
    ate = ate_rmse(centers(poses), centers(gt[lo:i][ok]), with_scale=True)
    tracked = int(ok.sum())
    total = N_TIMED * CHUNK
    fps = total / dt
    print(f"seed {seed}: bootstrap {n_boot} frames, {tracked}/{total} timed frames tracked, "
          f"sim3 ATE {ate:.4f} m, {fps:.2f} fps over {N_TIMED} timed chunks "
          f"({dt:.3f} s), keyframes {sysm.tracker.kf_count_host}, points "
          f"{sysm.tracker.pt_count_host}")
    return {"seed": seed, "fps": fps, "tracked": tracked, "total": total, "ate_m": ate}


def check_run(run: dict) -> None:
    if run["tracked"] < int(0.9 * run["total"]):
        raise AssertionError(f"seed {run['seed']}: tracking collapsed: "
                             f"{run['tracked']}/{run['total']}")
    if not run["ate_m"] < ATE_LIMIT_M:
        raise AssertionError(f"seed {run['seed']}: trajectory drifted: sim3 ATE "
                             f"{run['ate_m']:.4f} m >= {ATE_LIMIT_M:.4f} m")


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
          f"worst {max(r['ate_m'] for r in runs):.4f} m")
    if not median_ate < MEDIAN_ATE_LIMIT_M:
        raise AssertionError(f"median sim3 ATE {median_ate:.4f} m >= {MEDIAN_ATE_LIMIT_M:.4f} m")

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
        "ate_m_by_seed": {r["seed"]: r["ate_m"] for r in runs}, "card": card}}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
