"""Chunk tracking, the keyframe branch (runtime/scan_tracker
``frame.keyframe``: the slot write, covisibility, the neighbour
triangulations of runtime/local_mapping with their readbacks, and the
fuse): host-clock milliseconds of the program's own stage over the
window's chunks, per keyframe the program counted there (``keyframes``).
Loading this reader turns the program's tracer on (harness/program_trace:
readers load only in a traced run, before set-up)."""

from harness import program_trace

program_trace.switch_on()


def read(rec):
    recs = program_trace.window_records(rec)
    if recs is None:
        return None
    t = program_trace.stage_seconds(recs, "frame.keyframe")
    kfs = program_trace.count(recs, "keyframes")
    return None if t is None or not kfs else 1e3 * t / kfs
