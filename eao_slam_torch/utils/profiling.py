"""Stage timing and device traces.

Usage:
    prof = StageProfiler()
    with prof.stage("track"):            # host clock around the stage
        out = step(...)
        prof.sync(out)                   # wait for the device inside the span
    prof.summary()                       # {stage: {count, total_s, ...}}
    prof.write_log(path)                 # the summary as JSON

    with device_trace("/tmp/trace"):     # torch.profiler, a Chrome trace
        with annotate("chunk"):          # a named span in that trace
            step(...)
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch


class StageProfiler:
    """Named host-clock stage timers with summary statistics (total,
    mean, median, maximum and count per stage)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield self
            return
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.samples[name].append(time.perf_counter() - t0)

    @staticmethod
    def sync(tree):
        """Wait for the CUDA devices of the tensors in ``tree`` (nested
        tuples, lists, dicts and NamedTuples), so the enclosing stage
        measures device time, not the enqueue. Returns ``tree``."""
        devices = set()

        def visit(x):
            if isinstance(x, torch.Tensor):
                if x.is_cuda:
                    devices.add(x.device)
            elif isinstance(x, dict):
                for v in x.values():
                    visit(v)
            elif isinstance(x, (tuple, list)):
                for v in x:
                    visit(v)

        visit(tree)
        for d in devices:
            torch.cuda.synchronize(d)
        return tree

    def add(self, name: str, seconds: float) -> None:
        self.samples[name].append(float(seconds))

    def summary(self) -> dict:
        out = {}
        for name, xs in self.samples.items():
            a = np.asarray(xs)
            out[name] = {"count": int(a.size), "total_s": float(a.sum()),
                         "mean_s": float(a.mean()), "median_s": float(np.median(a)),
                         "max_s": float(a.max())}
        return out

    def write_log(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2, sort_keys=True)

    def report(self) -> str:
        rows = ["stage                          count   total(s)    mean(ms)"]
        for name, s in sorted(self.summary().items()):
            rows.append(f"{name:<30} {s['count']:>6} {s['total_s']:>10.3f} "
                        f"{s['mean_s'] * 1e3:>11.3f}")
        return "\n".join(rows)

    def reset(self) -> None:
        self.samples.clear()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler over the block (the CPU, and CUDA where a device is
    present); writes ``log_dir/trace.json``, a Chrome trace. Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named span in a device trace (torch.profiler.record_function)."""
    return torch.profiler.record_function(name)
