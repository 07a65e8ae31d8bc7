"""The program's own tracer (``eao_slam_torch.utils.profiling.TRACER``),
for the per-layer metrics of the stages inside its chunk program.

A reader of such a metric turns the tracer on when it is loaded
(``switch_on``). The runner loads the per-layer readers only in a
``--trace 1`` run, once ``System`` is built and before set-up, so timed
runs keep the tracer off. The tracer keeps one record a chunk: the set-up's
warm-up chunk, the window's chunks, then the chunk traced by torch's
profiler, which its record marks. The window's records are the last
``frames // chunk`` of those the profiler did not run in.

Where the program has no tracer (a program older than it), nothing is
switched on and every reader returns None.
"""

from __future__ import annotations


def _tracer():
    try:
        from eao_slam_torch.utils import profiling
    except ImportError:
        return None
    return getattr(profiling, "TRACER", None)


def switch_on() -> None:
    """Turn the program's tracer on, if the program has one."""
    tracer = _tracer()
    if tracer is not None:
        tracer.enable()


def window_records(rec) -> list:
    """The tracer's records of the window's chunks, or None."""
    tracer = _tracer()
    if tracer is None or rec.get("mode") != "chunked":
        return None
    n = int(rec["window"]["frames"]) // int(rec["traffic"]["chunk"])
    unprofiled = [r for r in tracer.chunks if not r["profiled"]]
    if n <= 0 or len(unprofiled) < n:
        return None
    return unprofiled[-n:]


def stage_seconds(records: list, name: str):
    """Seconds of stage ``name`` over the records, or None where it never ran."""
    hits = [r["stages"][name] for r in records if name in r["stages"]]
    return sum(s["seconds"] for s in hits) if hits else None


def count(records: list, name: str, roots=None) -> int:
    """Counter ``name`` over the records: in every stage and outside them,
    or with ``roots`` in those stages and the stages below them."""
    total = 0
    for r in records:
        stages = r["stages"]
        if roots is None:
            total += r["counts"].get(name, 0)
        for stage, s in stages.items():
            if roots is None or under(stages, stage, roots):
                total += s["counts"].get(name, 0)
    return total


def under(stages: dict, stage, roots) -> bool:
    """Whether ``stage`` is one of ``roots`` or below one of them."""
    while stage is not None:
        if stage in roots:
            return True
        stage = stages[stage]["parent"] if stage in stages else None
    return False
