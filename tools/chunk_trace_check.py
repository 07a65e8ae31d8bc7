"""Hold the port's tracer (``eao_slam_torch.utils.profiling.TRACER``) to the
benchmark's own yardsticks in one traced run of a cell on one NVIDIA GPU,
and time what the tracer costs.

    python3 tools/chunk_trace_check.py [--cell tum3_eao.chunked] [--seed N]
        [--seconds 20] [--out chiprun_out/trace_check]

The run is the benchmark's ``--trace 1`` run (``benchmark/harness/runner.
run_cell``), watched from outside without a change to what it does: the
harness's span recorder and torch's profiler are kept for reading after
the run. It prints, and writes as JSON to ``OUT/<cell>.<seed>.json``:

- the run's result line (the per-layer metrics, the idle gaps by span);
- the window's stage table from the tracer's records of the window's
  chunks: each stage's milliseconds a frame, self milliseconds a frame,
  calls, share of ``chunk.track`` and host synchronisations a frame;
- ``chunk.extract`` + ``chunk.track`` against the harness's
  ``extract_track`` span over the window (synchronised at both ends);
- the share of ``chunk.track`` that the stages inside it cover;
- the tracer's ``host_syncs`` in ``chunk.extract`` and ``chunk.track`` of
  the chunk the profiler traced, against the ``cudaStreamSynchronize``
  calls the profiler saw inside those two stages (``profile_port.py``'s
  count; the harness's own synchronise is ``cudaDeviceSynchronize``, left
  out), in all and by innermost stage;
- the share of the traced chunk's idle time that the idle gaps book to the
  program's stages;
- costs: nanoseconds a ``stage()`` call with the tracer off, and on without
  and with the sync count (on the host), and microseconds a counted
  synchronisation adds (``int()`` of a one-element tensor on the card, in
  a stage with the count against one without).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
sys.path[:0] = [BENCH, ROOT]

import run as bench_run  # noqa: E402  (the benchmark's threads and cache paths)
from harness import program_trace  # noqa: E402

ROOTS = ("chunk.extract", "chunk.track")


def stage_table(total: dict, frames: int) -> list:
    stages = total["stages"]
    track = stages["chunk.track"]["seconds"]
    rows = []
    for name, s in sorted(stages.items(), key=lambda kv: -kv[1]["seconds"]):
        rows.append({"stage": name, "parent": s["parent"],
                     "ms_per_frame": 1e3 * s["seconds"] / frames,
                     "self_ms_per_frame": 1e3 * s["self_seconds"] / frames,
                     "calls": s["calls"],
                     "share_of_track": (s["seconds"] / track if program_trace.under(
                         stages, s["parent"], ("chunk.track",)) else None),
                     "host_syncs_per_frame": s["counts"].get("host_syncs", 0) / frames,
                     "counts": s["counts"]})
    return rows


def profiler_syncs(prof, stage_names: set) -> dict:
    """cudaStreamSynchronize / cudaDeviceSynchronize calls of the trace
    inside the program's ``chunk.extract`` and ``chunk.track`` ranges, in
    all and by the innermost program stage around each."""
    spans, calls = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if "CUDA" in str(e.device_type()):
            continue
        t0, t1 = e.start_ns(), e.end_ns()
        if name.startswith("span:") and name[5:] in stage_names:
            spans.append((name[5:], t0, t1))
        elif name in ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy"):
            calls.append((name, t0))
    out = {"stream_syncs": 0, "device_syncs": 0, "sync_memcpy": 0, "stream_syncs_by_stage": {}}
    key = {"cudaStreamSynchronize": "stream_syncs", "cudaDeviceSynchronize": "device_syncs",
           "cudaMemcpy": "sync_memcpy"}
    for name, t in calls:
        around = [s for s in spans if s[1] <= t <= s[2]]
        if not any(s[0] in ROOTS for s in around):
            continue
        out[key[name]] += 1
        if name == "cudaStreamSynchronize":
            inner = min(around, key=lambda s: s[2] - s[1])[0]
            by = out["stream_syncs_by_stage"]
            by[inner] = by.get(inner, 0) + 1
    return out


def per_call_ns(fn, n: int = 200_000) -> float:
    fn(1000)
    t0 = time.perf_counter()
    fn(n)
    return (time.perf_counter() - t0) / n * 1e9


def costs(torch) -> dict:
    """The tracer's costs (the module docstring)."""
    from eao_slam_torch.utils.profiling import StageProfiler

    def loop(p):
        def run(n):
            for _ in range(n):
                with p.stage("x"):
                    pass
        return run

    def baseline(n):
        for _ in range(n):
            pass

    off = StageProfiler(enabled=False)
    on = StageProfiler()
    on.enable(count_syncs=False)
    counting = StageProfiler()
    counting.enable(count_syncs=True)
    out = {"empty_loop_ns": per_call_ns(baseline),
           "stage_off_ns": per_call_ns(loop(off)),
           "stage_on_ns": per_call_ns(loop(on), 50_000),
           "stage_on_counting_ns": per_call_ns(loop(counting), 50_000)}
    counting.disable()
    on.disable()
    if torch.cuda.is_available():
        x = torch.ones(1, device="cuda")

        def syncs(count: bool, n: int = 2000) -> float:
            p = StageProfiler()
            p.enable(count_syncs=count)       # off: the sync debug mode stays off
            with p.stage("sync"):
                int(x)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    int(x)
                dt = (time.perf_counter() - t0) / n * 1e6
            p.disable()
            out["counted_syncs_seen" if count else "plain_syncs_seen"] = \
                p.chunks[0]["stages"]["sync"]["counts"]
            return dt

        reps = [(syncs(False), syncs(True)) for _ in range(5)]
        out["sync_us_plain"] = statistics.median(r[0] for r in reps)
        out["sync_us_counted"] = statistics.median(r[1] for r in reps)
    return out


def check(spec, cell: str, seed: int, seconds: float, device=None) -> dict:
    """One traced run of ``cell`` watched as the module docstring says;
    ``device`` "cpu" rehearses it (no profiler, no card, no costs)."""
    import torch

    from harness import runner
    from eao_slam_torch.utils.profiling import TRACER, merge_records

    kept = {}

    class KeepSpans(runner.Spans):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            kept["spans"] = self

    class KeepProfile(torch.profiler.profile):
        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            kept["prof"] = self
            return out

    spans_cls, profile_cls = runner.Spans, torch.profiler.profile
    runner.Spans, torch.profiler.profile = KeepSpans, KeepProfile
    try:
        result, lines = runner.run_cell(spec, cell, seed, seconds, True, time.perf_counter(),
                                        device=device)
    finally:
        runner.Spans, torch.profiler.profile = spans_cls, profile_cls
        TRACER.disable()
    frames = result["work"]["frames"]
    window = program_trace.window_records({"mode": "chunked", "window": {"frames": frames},
                                           "traffic": spec.cell(cell).traffic})
    profiled = [r for r in TRACER.chunks if r["profiled"]]
    st = merge_records(window)["stages"]
    track = st["chunk.track"]
    prog_s = st["chunk.extract"]["seconds"] + track["seconds"]
    harness_s = sum(kept["spans"].times.get("extract_track", ())) or None
    report = {"cell": cell, "seed": seed, "result": result, "checks_lines": lines,
              "window_chunks": len(window), "profiled_chunks": len(profiled),
              "stage_table": stage_table(merge_records(window), frames),
              "extract_track_s": {"program": prog_s, "harness": harness_s,
                                  "ratio": harness_s and prog_s / harness_s},
              "track_children_share": 1.0 - track["self_seconds"] / track["seconds"]}
    if "prof" in kept:
        traced = merge_records(profiled)["stages"]
        syncs = profiler_syncs(kept["prof"], set(traced))
        by_stage = {k: s["counts"].get("host_syncs", 0) for k, s in traced.items()
                    if program_trace.under(traced, k, ROOTS)}
        gaps = result["breakdown"]["idle_gaps"]
        idle = sum(v for _, v in gaps)
        report["traced_chunk_syncs"] = {"tracer_host_syncs": sum(by_stage.values()),
                                        "tracer_by_stage": by_stage, **syncs,
                                        "ratio": sum(by_stage.values())
                                        / max(syncs["stream_syncs"], 1)}
        report["idle_gaps_on_program_stages"] = (
            sum(v for k, v in gaps if k in traced) / idle if idle else None)
    return report


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cell", default="tum3_eao.chunked")
    p.add_argument("--seed", type=int, default=2147483741)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "trace_check"))
    args = p.parse_args()
    import torch

    from harness import runner
    from harness.spec import Spec

    if not torch.cuda.is_available():
        print("chunk_trace_check: no CUDA device is available", file=sys.stderr)
        return 1
    torch.set_num_threads(bench_run.THREADS)
    report = check(Spec(), args.cell, args.seed, args.seconds)
    report["card"] = runner.card()
    report["costs"] = costs(torch)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{args.cell}.{args.seed}.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report["result"]))
    for row in report["stage_table"]:
        share = row["share_of_track"]
        print(f"{row['stage']:<22} {row['ms_per_frame']:9.3f} ms/frame  self "
              f"{row['self_ms_per_frame']:8.3f}  calls {row['calls']:5d}  "
              f"{'' if share is None else f'{100 * share:5.1f} % of track'}  "
              f"syncs/frame {row['host_syncs_per_frame']:.2f}  {row['counts']}")
    for k in ("card", "extract_track_s", "track_children_share", "traced_chunk_syncs",
              "idle_gaps_on_program_stages", "costs"):
        print(f"{k}: {json.dumps(report[k])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
