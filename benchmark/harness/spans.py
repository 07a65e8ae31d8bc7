"""Spans from the benchmark's side: each span file names one program call,
which a traced run wraps in synchronise, host clock, call, synchronise,
host clock (the program is not edited; the wrapper replaces the attribute
for the run and puts the original back).

A span's ``target`` is ``package.module:name`` (a module attribute),
``package.module:Class.method`` (a class attribute, for every instance) or
``system:attr.path`` (an attribute reached from the run's ``System``, such
as ``system:tracker._extract_track``).
"""

from __future__ import annotations

import contextlib
import importlib
import time

import torch


def resolve(target: str, system=None):
    """(owner, attribute name) of a span's target."""
    root, _, path = target.partition(":")
    if not path:
        raise ValueError(f"a span target reads module:attr, got {target!r}")
    parts = path.split(".")
    if root == "system":
        if system is None:
            raise ValueError(f"span target {target!r} needs the run's System")
        owner = system
    else:
        owner = importlib.import_module(root)
    for p in parts[:-1]:
        owner = getattr(owner, p)
    if not hasattr(owner, parts[-1]):
        raise AttributeError(f"span target {target!r}: {owner!r} has no {parts[-1]!r}")
    return owner, parts[-1]


class Spans:
    """Host-clock durations of the wrapped calls, by span name, recorded
    while ``recording`` is set; while ``annotate`` is set each call is also
    a ``torch.profiler.record_function`` range named ``span:<name>``."""

    def __init__(self, specs: dict, system, device):
        self.device = device
        self.times = {name: [] for name in specs}
        self.recording = False
        self.annotate = False
        self._undo = []
        for name, spec in specs.items():
            owner, attr = resolve(spec["target"], system)
            original = getattr(owner, attr)
            self._undo.append((owner, attr, vars(owner).get(attr, original),
                               attr in vars(owner)))
            setattr(owner, attr, self._wrap(name, original))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _wrap(self, name: str, fn):
        def timed(*args, **kw):
            if not self.recording and not self.annotate:
                return fn(*args, **kw)
            ctx = (torch.profiler.record_function(f"span:{name}") if self.annotate
                   else contextlib.nullcontext())
            with ctx:
                self._sync()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                self._sync()
                dt = time.perf_counter() - t0
            if self.recording:
                self.times[name].append(dt)
            return out

        return timed

    def close(self) -> None:
        """Put every wrapped attribute back as it was."""
        for owner, attr, raw, had in reversed(self._undo):
            if had:
                setattr(owner, attr, raw)
            else:
                delattr(owner, attr)
        self._undo = []
