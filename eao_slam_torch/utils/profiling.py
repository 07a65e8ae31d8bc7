"""Stage timing: named host-clock stages and counters, one tracer a process.

Usage:
    prof = StageProfiler()
    with prof.stage("track"):            # host clock around the stage
        out = step(...)
    prof.add("decode", seconds)          # a sample timed by the caller
    prof.summary()                       # {stage: {count, total_s, ...}}
    prof.write_log(path)                 # the summary as JSON

The port's program carries its stages on ``TRACER``, off unless a caller
turns it on (``TRACER.enable()``; ``python -m eao_slam_torch.cli ... --trace
PATH``). Off, ``stage(name)`` is one attribute check and a shared no-op
context. On, each stage:

- reads the host clock at both ends and notes its parent, the innermost
  stage open when it started; a stage's time is host time, any wait for the
  device at a readback inside it included (a stage never synchronises);
- is a ``torch.profiler.record_function`` range named ``span:<name>``, so a
  device trace taken meanwhile puts the stages on its own clock;
- with CUDA in use, counts the host-device synchronisations made inside it
  (``host_syncs``): the tracer sets ``torch.cuda.set_sync_debug_mode("warn")``
  and counts each synchronising-operation warning under the innermost stage,
  keeping them from the user's warnings, until ``disable()``.

``count(name, n)`` adds to a counter of the innermost open stage. The totals
are kept one record a chunk (``next_chunk()`` starts the next): seconds,
self seconds (less the time of the stage's children) and calls per stage,
the counters, and whether torch's profiler ran during the chunk
(``chunks``, ``trace()``, ``write_trace(path)``).
"""

from __future__ import annotations

import functools
import json
import time
import warnings
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

SYNC_WARNING = "called a synchronizing CUDA operation"
SYNC_COUNTER = "host_syncs"


def _sync_filter(entry) -> bool:
    return entry[0] == "ignore" and entry[1] is not None and entry[1].pattern == SYNC_WARNING


class _NoStage:
    """The stage of a tracer that is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_STAGE = _NoStage()


def _new_record() -> dict:
    return {"profiled": False, "stages": {}, "counts": {}}


class _Stage:
    """One open stage of a tracer that is on."""

    __slots__ = ("tracer", "name", "entry", "child_s", "t0", "range", "catch", "log")

    def __init__(self, tracer: "StageProfiler", name: str):
        self.tracer = tracer
        self.name = name

    def __enter__(self):
        tr = self.tracer
        rec = tr._record()
        if torch.autograd._profiler_enabled():
            rec["profiled"] = True
        parent = tr._open[-1].name if tr._open else None
        entry = rec["stages"].get(self.name)
        if entry is None:
            entry = rec["stages"][self.name] = {"parent": parent, "seconds": 0.0,
                                                "self_seconds": 0.0, "calls": 0, "counts": {}}
        self.entry = entry
        self.child_s = 0.0
        tr._open.append(self)
        self.range = torch.profiler.record_function("span:" + self.name)
        self.range.__enter__()
        self.catch = None
        if tr._counting_syncs:
            self.catch = warnings.catch_warnings(record=True)
            self.log = self.catch.__enter__()
            warnings.filterwarnings("always", message=SYNC_WARNING)
        self.t0 = time.perf_counter()
        return None

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        tr = self.tracer
        if self.catch is not None:
            self.catch.__exit__(*exc)
            syncs = 0
            for w in self.log:
                if str(w.message).startswith(SYNC_WARNING):
                    syncs += 1
                else:       # the user's own: passed on to the filters outside
                    warnings.warn_explicit(w.message, w.category, w.filename, w.lineno,
                                           source=w.source)
            if syncs:
                c = self.entry["counts"]
                c[SYNC_COUNTER] = c.get(SYNC_COUNTER, 0) + syncs
        self.range.__exit__(*exc)
        tr._open.pop()
        e = self.entry
        e["seconds"] += dt
        e["self_seconds"] += dt - self.child_s
        e["calls"] += 1
        if tr._open:
            tr._open[-1].child_s += dt
        tr.samples[self.name].append(dt)
        return False


class StageProfiler:
    """Named host-clock stage timers with summary statistics (total,
    mean, median, maximum and count per stage), and per-chunk totals of
    nested stages and counters (the module docstring).

    ``chunks``: the per-chunk records, oldest first: {"profiled",
    "stages": {name: {"parent", "seconds", "self_seconds", "calls",
    "counts"}}, "counts"} (a record's ``counts``: counters outside any
    stage)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.samples: Dict[str, List[float]] = defaultdict(list)
        self.chunks: List[dict] = []
        self._open: List[_Stage] = []
        self._sync_counting = None      # None: count where CUDA is in use
        self._counting_syncs = False
        self._sync_mode_before = None   # the CUDA sync debug mode to restore

    # -- switch -------------------------------------------------------------

    def enable(self, count_syncs: Optional[bool] = None) -> None:
        """Turn the tracer on (again: no change). Keeps what was recorded.
        ``count_syncs``: True counts synchronising-operation warnings in the
        stages even without CUDA, False never; None (the default) leaves the
        choice as it was, at first: count where CUDA is in use."""
        if count_syncs is not None:
            self._sync_counting = count_syncs
        self.enabled = True
        self._arm_sync_count()

    def disable(self) -> None:
        """Turn the tracer off (again: no change) and restore the CUDA sync
        debug mode and the warning filters. Keeps what was recorded."""
        self.enabled = False
        self._counting_syncs = False
        self._restore_sync_mode()

    def _arm_sync_count(self) -> None:
        if not self.enabled:
            return
        want = self._sync_counting is not False
        cuda = want and torch.cuda.is_available() and torch.cuda.is_initialized()
        if cuda and self._sync_mode_before is None:
            self._sync_mode_before = torch.cuda.get_sync_debug_mode()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")     # torch's notice that the mode is a prototype
                torch.cuda.set_sync_debug_mode("warn")
            # outside a stage the warnings are dropped, never shown
            warnings.filterwarnings("ignore", message=SYNC_WARNING)
        elif not want:
            self._restore_sync_mode()
        self._counting_syncs = cuda or bool(self._sync_counting)

    def _restore_sync_mode(self) -> None:
        if self._sync_mode_before is not None:
            torch.cuda.set_sync_debug_mode(self._sync_mode_before)
            self._sync_mode_before = None
            warnings.filters[:] = [f for f in warnings.filters if not _sync_filter(f)]
            getattr(warnings, "_filters_mutated", lambda: None)()

    # -- recording ----------------------------------------------------------

    def stage(self, name: str):
        """Context manager: a named stage (the module docstring)."""
        if not self.enabled:
            return _NO_STAGE
        return _Stage(self, name)

    def staged(self, name: str):
        """Decorator: every call of the function is the stage ``name``."""
        def wrap(fn):
            @functools.wraps(fn)
            def run(*args, **kw):
                if not self.enabled:
                    return fn(*args, **kw)
                with _Stage(self, name):
                    return fn(*args, **kw)
            return run
        return wrap

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to counter ``name`` of the innermost open stage (of the
        chunk's record where no stage is open)."""
        if not self.enabled:
            return
        c = self._open[-1].entry["counts"] if self._open else self._record()["counts"]
        c[name] = c.get(name, 0) + n

    def next_chunk(self) -> None:
        """Start the record of the next chunk."""
        if not self.enabled:
            return
        self._arm_sync_count()
        self.chunks.append(_new_record())

    def _record(self) -> dict:
        if not self.chunks:
            self.chunks.append(_new_record())
        return self.chunks[-1]

    def add(self, name: str, seconds: float) -> None:
        self.samples[name].append(float(seconds))

    # -- reading ------------------------------------------------------------

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

    def trace(self) -> dict:
        """The stage tree and the counters, per chunk and summed."""
        total = merge_records(self.chunks)
        total.pop("profiled")
        return {"chunks": self.chunks, "total": total}

    def write_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.trace(), f, indent=1, sort_keys=True)

    def reset(self) -> None:
        self.samples.clear()
        self.chunks = []


def merge_records(records: List[dict]) -> dict:
    """The sum of chunk records, in the records' form ("profiled": any)."""
    out = _new_record()
    for rec in records:
        out["profiled"] |= rec["profiled"]
        for k, v in rec["counts"].items():
            out["counts"][k] = out["counts"].get(k, 0) + v
        for name, s in rec["stages"].items():
            o = out["stages"].setdefault(name, {"parent": s["parent"], "seconds": 0.0,
                                                "self_seconds": 0.0, "calls": 0,
                                                "counts": {}})
            o["seconds"] += s["seconds"]
            o["self_seconds"] += s["self_seconds"]
            o["calls"] += s["calls"]
            for k, v in s["counts"].items():
                o["counts"][k] = o["counts"].get(k, 0) + v
    return out


# the port's one tracer: its program's stages (runtime/scan_tracker), off
# unless a caller turns it on
TRACER = StageProfiler(enabled=False)
