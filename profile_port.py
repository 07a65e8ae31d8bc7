"""Where one chunk's time goes in the port's main path, on one NVIDIA GPU.

    python3 profile_port.py [--flags None EAO LineAndiForest]
    python3 profile_port.py --flags Full --dense

Same configuration and arc as chip_smoke.py (geometry mode, 640x480, 1024
features, chunk 32, bench capacities, default seed); ``--flags`` names the
modes to profile one after another on the same rendered frames (default
geometry mode alone; EAO and LineAndiForest with chip_smoke.py's 8
detector boxes a frame and 32 object slots, in line mode with 128 line
slots). After the bootstrap
and one warm-up chunk it times, on the host clock with a synchronise at
each end, the next chunk's two stages separately: the ORB front end over
the 32 images (``extract_batch``) and the tracking of the 32 frames with
the chunk finalize (``track_chunk``). It splits the front end's time by CUDA
events into the pyramid, the FAST kernel, the keypoint selection, the patch
gather with the BRIEF product, and the undistortion. Then it traces one
more chunk with
``torch.profiler`` and reports the device's busy time (the sum of kernel
times), its idle share of the chunk's wall time, the kernels that take the
most device time, and the host-device synchronisations. Prints the card's
name and power limit, then one JSON line per mode.

``--dense`` profiles FULL's offline dense phase alone instead: chip_smoke.py's
dense protocol (FULL over the first 8 + 2 x 32 frames of the arc), then the
host-clock time of each stage between synchronises
(``chip_smoke.dense_stage_times``), then one traced ``System.shutdown``: its
wall time, the device's busy time and idle share, kernel launches, stream
synchronisations, copies, and the operations that take the most device
time.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)


def front_end_split(cfg, imgs, reps: int = 5) -> dict:
    """The stages of ``extract_batch`` (ops/orb.extract_orb followed by the
    undistortion) run one after another with a CUDA event between them;
    median milliseconds over ``reps`` runs after one warm-up. A stage's time
    runs from the end of the stage before it to the end of its own last
    kernel, so it holds the gaps in which the device waits for the host."""
    import torch

    from eao_slam_torch.geometry.camera import undistort_points
    from eao_slam_torch.ops import image as image_ops, orb
    from eao_slam_torch.ops.fast_nms import fast_nms_tile_max

    o = cfg.orb
    counts = orb.per_level_counts(cfg.capacity.max_features, o.n_levels, o.scale_factor)
    names = ("pyramid", "fast_kernel", "selection", "gather_and_brief", "assemble", "undistort")
    runs = []
    for _ in range(reps + 1):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        marks[0].record()
        levels = tuple(l.contiguous() for l in image_ops.build_pyramid(
            imgs.to(torch.float32), o.n_levels, o.scale_factor))
        marks[1].record()
        maxima = fast_nms_tile_max(levels, border=o.edge_threshold)
        marks[2].record()
        picked = [orb.select_from_tile_max(m, lvl.shape[-1], n_l, float(o.fast_threshold),
                                           float(o.fast_min_threshold))
                  for m, lvl, n_l in zip(maxima, levels, counts)]
        marks[3].record()
        described = [orb._angles_and_descriptors(lvl, yx) for lvl, (yx, _, _) in zip(levels, picked)]
        marks[4].record()
        kp = torch.cat([torch.stack([yx[..., 1].float(), yx[..., 0].float()], -1)
                        * o.scale_factor ** l for l, (yx, _, _) in enumerate(picked)], 1)
        desc = torch.cat([d for _, d in described], 1)
        marks[5].record()
        kp = undistort_points(cfg.camera, kp)
        marks[6].record()
        torch.cuda.synchronize()
        assert desc.shape[:2] == kp.shape[:2]
        runs.append([a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])])
    med = np.median(np.asarray(runs[1:]), axis=0)
    return {n: float(v) for n, v in zip(names, med)} | {"sum": float(med.sum())}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--flags", nargs="+", choices=("None", "EAO", "LineAndiForest", "Full"),
                   default=["None"])
    p.add_argument("--dense", action="store_true",
                   help="profile FULL's offline dense phase (with --flags Full)")
    args = p.parse_args()
    if ("Full" in args.flags) != args.dense:
        p.error("FULL is profiled through its dense phase: --flags Full --dense")
    import torch

    if not torch.cuda.is_available():
        print("profile_port: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke

    ts, gt, images = chip_smoke.render_sequence()
    card = chip_smoke.card_line()
    print(card)
    for flag in args.flags:
        prof = profile_dense if flag == "Full" else profile_mode
        print(json.dumps(prof(flag, ts, gt, images, card)), flush=True)
    return 0


def trace_summary(prof, wall_ms: float) -> dict:
    """Device busy time, idle share, launches, synchronisations, copies and
    the top device operations of one torch.profiler trace."""
    events = prof.key_averages()
    dev = [e for e in events if getattr(e, "device_type", None) is not None
           and "CUDA" in str(e.device_type) and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    syncs = sum(e.count for e in events if e.key in ("cudaStreamSynchronize",
                                                     "cudaDeviceSynchronize"))
    copies = sum(e.count for e in events if e.key == "cudaMemcpyAsync")
    launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel",
                                                        "cuLaunchKernel", "cudaLaunchKernelExC"))
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "kernel_launches": launches, "stream_syncs": syncs, "memcpy_calls": copies,
            "top_kernels_ms": [{"name": e.key[:90], "count": e.count,
                                "ms": e.self_device_time_total / 1e3} for e in top]}


def profile_dense(flag: str, ts, gt, images, card: str) -> dict:
    """FULL's offline dense phase alone (see the module docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from eao_slam_torch.system import System

    boxes = chip_smoke.bench_boxes(gt)
    sysm = System(chip_smoke.full_config(), chunk=chip_smoke.CHUNK)
    for k in range(chip_smoke.DENSE_FRAMES):
        sysm.track_monocular(images[k], float(ts[k]), boxes=boxes[k])
    sysm.flush()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sysm.shutdown(semidense=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    stages = chip_smoke.dense_stage_times(sysm)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sysm.shutdown(semidense=True)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    n_kf = len(sysm._semidense_slots)
    return {"card": card, "flag": flag, "keyframes": n_kf, "first_call_s": first_s,
            "s_per_kf": first_s / n_kf, "stages_s": stages,
            "traced_shutdown": trace_summary(prof, wall_ms),
            "counts": {"semidense_valid": int(sysm._semidense_result.valid.sum()),
                       "segments": len(sysm._lines3d), "triangles": len(sysm._mesh_tris)}}


def profile_mode(flag: str, ts, gt, images, card: str) -> dict:
    """Stage times and the traced chunk of one mode (see the module
    docstring)."""
    import torch

    import chip_smoke
    from eao_slam_torch.config import CapacityConfig, DemoFlag, TrackingConfig, tum3_config
    from eao_slam_torch.runtime.scan_tracker import extract_batch
    from eao_slam_torch.system import System

    C = chip_smoke.CHUNK
    objects = flag != "None"
    cfg = tum3_config(DemoFlag(flag)).replace(
        tracking=TrackingConfig(enable_loop_closing=False),
        capacity=CapacityConfig(max_keyframes=128, max_points=8192,
                                max_features=1024, local_ba_points=2048,
                                **(dict(max_boxes=chip_smoke.N_BOXES, max_objects=32)
                                   if objects else {})))
    boxes = chip_smoke.bench_boxes(gt) if objects else [None] * len(images)
    sysm = System(cfg, chunk=C)
    tracker = sysm.tracker
    i = 0
    while not tracker.armed:
        sysm.track_monocular(images[i], float(ts[i]), boxes=boxes[i])
        i += 1
    for _ in range(C):                       # warm-up chunk
        sysm.track_monocular(images[i], float(ts[i]), boxes=boxes[i])
        i += 1

    def chunk_inputs(lo):
        box_t = None
        if objects:
            box_t = tuple(torch.as_tensor(np.stack([b[k] for b in boxes[lo:lo + C]]),
                                          device="cuda") for k in range(4))
        return (torch.as_tensor(images[lo:lo + C], device="cuda"),
                np.asarray(ts[lo:lo + C], np.float32), box_t)

    torch.cuda.synchronize()
    imgs, tss, box_t = chunk_inputs(i)
    t0 = time.perf_counter()
    batch = extract_batch(cfg, imgs, tss, boxes=box_t)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tracker.carry, outs = tracker._track_chunk(tracker.carry, batch)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    i += C
    stages_ms = {"extract_batch": (t1 - t0) * 1e3, "track_chunk": (t2 - t1) * 1e3,
                 "keyframes_in_chunk": int(outs.is_kf.sum())}
    front_end_ms = front_end_split(cfg, imgs)

    from torch.profiler import ProfilerActivity, profile

    imgs, tss, box_t = chunk_inputs(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tracker.carry, outs = tracker._extract_track(tracker.carry, imgs, tss, None, box_t)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return {
        "card": card, "flag": flag,
        "stages_ms": stages_ms,
        "front_end_ms": front_end_ms,
        "traced_chunk": {**trace_summary(prof, wall_ms),
                         "keyframes_in_chunk": int(outs.is_kf.sum())},
    }


if __name__ == "__main__":
    sys.exit(main())
