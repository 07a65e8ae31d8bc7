"""Where the loop-closing pass's time goes, on one NVIDIA GPU.

    python3 profile_loop_closure.py

Drives bench.py's loop circuit (the configuration of chip_smoke.py's
circuit phase: closed room, 288 orbit frames, simulated observations of 512
features, chunk 8, 128 keyframes, 8192 points) through the port's
System.track_frame with loop closing on. Every stage of loop verification
and correction is timed on the host clock between two synchronises: the
brute match and seed Sim3 RANSAC, SearchBySim3 and the 5 + 10 Sim3 LM,
the essential graph with point re-anchoring, the fusion of the loop
points, and the global BA. The between-chunk loop pass that closes the
loop runs under ``torch.profiler``: its wall time, the device's busy time
(the sum of kernel times), the idle share and the kernel launches. Prints
the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_loop_closure: no CUDA device is available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import card_line, circuit_inputs
    from eao_slam_torch.runtime import loop_closing
    from eao_slam_torch.system import System

    cfg, ts, gt, frames = circuit_inputs()
    stages: dict = {}

    def timed(owner, name, stage):
        fn = getattr(owner, name)

        def wrapped(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            stages.setdefault(stage, []).append(time.perf_counter() - t0)
            return out

        setattr(owner, name, wrapped)

    # the module-level solvers as loop_closing calls them, and the methods
    timed(loop_closing, "solve_sim3_ransac", "seed Sim3 RANSAC")
    timed(loop_closing, "optimize_sim3_schedule", "Sim3 LM 5 + 10")
    timed(loop_closing.LoopCloser, "_verify_and_correct", "verification and correction")
    timed(loop_closing.LoopCloser, "_search_by_sim3", "SearchBySim3")
    timed(loop_closing.LoopCloser, "_correct_loop", "essential graph and re-anchoring")
    timed(loop_closing.LoopCloser, "_fuse_loop_points", "loop point fusion")
    timed(loop_closing.LoopCloser, "_global_ba", "global BA")

    sysm = System(cfg, chunk=8)
    tracker = sysm.tracker
    close = tracker._maybe_close_loops
    trace = {}

    def profiled_pass():
        before = tracker.loop_closer.closed_loops
        if tracker.kf_count_host <= tracker._loop_checked or before:
            return close()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            close()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if tracker.loop_closer.closed_loops > before:
            events = prof.key_averages()
            dev = [e for e in events if getattr(e, "device_type", None) is not None
                   and "CUDA" in str(e.device_type) and e.self_device_time_total > 0]
            busy = sum(e.self_device_time_total for e in dev) / 1e6
            launches = sum(e.count for e in events if e.key in (
                "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
            syncs = sum(e.count for e in events if e.key in (
                "cudaStreamSynchronize", "cudaDeviceSynchronize"))
            top = sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)[:8]
            trace.update(wall_s=wall, device_busy_s=busy, idle_share=max(0.0, 1 - busy / wall),
                         kernel_launches=launches, stream_syncs=syncs,
                         top_kernels_ms=[{"name": e.key[:90], "count": e.count,
                                          "ms": e.self_device_time_total / 1e3} for e in top])

    tracker._maybe_close_loops = profiled_pass
    for i in range(len(frames)):
        sysm.track_frame(frames[i], float(ts[i]))
    sysm.flush()
    torch.cuda.synchronize()
    if tracker.loop_closer.closed_loops < 1:
        raise AssertionError("the circuit closed no loop")

    card = card_line()
    out = {"card": card, "loops": tracker.loop_closer.closed_loops, "closing_pass": trace,
           "stages": {k: {"n": len(v), "total_s": float(sum(v)), "max_s": float(max(v))}
                      for k, v in stages.items()}}
    for k, v in out["stages"].items():
        print(f"{k}: {v['n']} calls, {v['total_s'] * 1e3:.1f} ms in all, longest "
              f"{v['max_s'] * 1e3:.1f} ms")
    print(f"the pass that closed the loop, traced: {trace['wall_s'] * 1e3:.1f} ms wall, device "
          f"busy {trace['device_busy_s'] * 1e3:.1f} ms (idle {100 * trace['idle_share']:.1f} %), "
          f"{trace['kernel_launches']} kernel launches, {trace['stream_syncs']} stream "
          f"synchronisations")
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
