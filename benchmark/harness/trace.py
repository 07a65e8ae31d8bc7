"""A traced stretch: ``torch.profiler`` over a few whole chunks or frames,
reduced in memory to what the per-layer metrics read (no timeline is
written): the device time of each device operation (kernel, copy, fill) by
name, the kernel launches, the union of the device's busy intervals
against the stretch's wall time, and the idle gaps between device
operations, each named by the innermost benchmark span (``span:<name>``)
the host was in at the gap's middle.
"""

from __future__ import annotations

import time

import torch

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")


def union_seconds(intervals: list) -> tuple:
    """(total seconds covered, merged [(start, end)]) of (start_us, end_us)
    intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged) / 1e6, merged


def name_gaps(merged: list, spans: list, top: int = 10) -> list:
    """Idle time between merged device intervals, summed by the innermost
    span covering each gap's middle ("outside spans" where none does):
    [[name, seconds], ...], longest first."""
    by_name = {}
    for (_, a), (b, _) in zip(merged[:-1], merged[1:]):
        if b <= a:
            continue
        mid = (a + b) / 2
        inner = [s for s in spans if s[1] <= mid <= s[2]]
        name = min(inner, key=lambda s: s[2] - s[1])[0] if inner else "outside spans"
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]


def profile(fn, device) -> dict:
    """Run ``fn`` under the profiler, synchronise, and reduce the trace."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize(device)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    # the raw events, one pass: building the profiler's event tree and its
    # averages for a chunk's ~250,000 kernels takes minutes
    kernels, spans, launches, ops = [], [], 0, {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        t0, t1 = e.start_ns() / 1e3, e.end_ns() / 1e3
        if "CUDA" in str(e.device_type()):
            if e.is_user_annotation() or name.startswith("span:"):
                continue                   # the spans' device-side annotations
            kernels.append((t0, t1))
            o = ops.setdefault(name, {"count": 0, "device_s": 0.0})
            o["count"] += 1
            o["device_s"] += (t1 - t0) / 1e6
        elif name in LAUNCH_CALLS:
            launches += 1
        elif name.startswith("span:"):
            spans.append((name[5:], t0, t1))
    busy, merged = union_seconds(kernels)
    return {"wall_s": wall, "busy_s": busy, "launches": launches, "ops": ops,
            "idle_gaps": name_gaps(merged, spans)}
