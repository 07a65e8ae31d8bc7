"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. build every CUDA kernel of the main path from the sources in this
     checkout (nvcc, sm_90a);
  2. hold each kernel against its plain PyTorch version at the shapes the
     main path gives it (bit-exact), and time both with CUDA events;
  3. drive the main path at full width through the port's System: geometry
     mode, 640x480, 1024 features, 8 levels, chunk 32, on the rendered
     60-degree arc; bootstrap, one warm-up chunk, four timed chunks. Checks
     tracked share >= 90 %, the sim3 ATE of the timed frames against ground
     truth, and that every kernel was launched on that run;
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

# H100 SXM peaks (NVIDIA data sheet): HBM rate and the float32 vector rate,
# the highest non-tensor-core operation rate the card lists
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
FAST_OPS_PER_PIXEL = 205   # 32 ring diffs, 2 x (64 min + 15 max), 8 NMS max, ~6 mask/pack
FAST_BYTES_PER_PIXEL = 8   # one float32 read, one int32 written

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


def render_sequence():
    """The bench arc, rendered with the port's own synthetic renderer."""
    from eao_slam_torch.io.synthetic import make_arc_trajectory, make_room_scene

    scene = make_room_scene(seed=5, n_landmarks=200, n_objects=3, obj_z_range=(4.0, 5.2))
    ts, gt = make_arc_trajectory(n_frames=N_FRAMES, sweep_deg=60.0)
    with multiprocessing.get_context("spawn").Pool(
            min(8, os.cpu_count() or 1), initializer=_set_scene, initargs=(scene,)) as pool:
        images = np.stack(pool.map(_render, list(gt)))
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


def check_fast_nms(levels_hw, border: int) -> dict:
    """Kernel vs plain version on random integer levels [CHUNK, h, w] at
    every pyramid size; bit-exact or fail. Times are per chunk (all
    levels), from CUDA events after warm-up."""
    import torch

    from eao_slam_torch.ops import fast_nms

    gen = torch.Generator(device="cuda").manual_seed(0)
    ms = plain_ms = bound_s = 0.0
    max_err = 0
    for h, w in levels_hw:
        x = torch.randint(0, 256, (CHUNK, h, w), generator=gen, device="cuda").float()
        # a coarsely quantised half: plateaus exercise the >= tie rule of the NMS
        x[CHUNK // 2:] = torch.round(x[CHUNK // 2:] / 64) * 64
        got = fast_nms.fast_nms_comb(x, border)
        want = fast_nms.fast_nms_comb_reference(x, border)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        if err != 0:
            raise AssertionError(f"fast_nms_comb differs from its plain version at {h}x{w}: "
                                 f"{int((got != want).sum())} pixels, max |diff| {err}")
        max_err = max(max_err, err)
        k = cuda_ms(lambda: fast_nms.fast_nms_comb(x, border))
        p = cuda_ms(lambda: fast_nms.fast_nms_comb_reference(x, border), iters=5)
        px = CHUNK * h * w
        b = max(px * FAST_BYTES_PER_PIXEL / PEAK_BYTES_PER_S,
                px * FAST_OPS_PER_PIXEL / PEAK_OPS_PER_S)
        print(f"fast_nms_comb {CHUNK}x{h}x{w}: kernel {k:.4f} ms, plain {p:.4f} ms, "
              f"bound {b * 1e3:.4f} ms, bit-exact")
        ms += k
        plain_ms += p
        bound_s += b
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_s * 1e3, "max_abs_err": max_err}


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
        from eao_slam_torch.ops.image import level_sizes
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
    print(f"card: {card}")

    t0 = time.perf_counter()
    fast_nms.build(force=True)
    print(f"build: fast_nms.cu in {time.perf_counter() - t0:.2f} s")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    k = check_fast_nms(level_sizes(480, 640, 8, 1.2), border=19)
    print(f"fast_nms_comb per chunk (8 levels x {CHUNK} frames): kernel {k['ms']:.4f} ms, "
          f"plain {k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms")

    fast_nms.reset_launches()
    path = run_main_path(ts, gt, images, SEEDS[0])
    launches = fast_nms.launches
    print(f"main path: fast_nms_comb launches {launches}")
    if launches <= 0:
        raise AssertionError("the main path never launched fast_nms_comb")
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

    kernels = [{
        "name": "fast_nms_comb",
        "route": "cuda",
        "source": "eao_slam_torch/csrc/fast_nms.cu",
        "replaces": "eao_slam_tpu/ops/fast_pallas.py:89",
        "launches": launches,
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": "operations" if FAST_OPS_PER_PIXEL / PEAK_OPS_PER_S
        > FAST_BYTES_PER_PIXEL / PEAK_BYTES_PER_S else "bytes",
        "library_ms": None,
    }]
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
