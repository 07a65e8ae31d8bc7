"""Chunk tracking, the windowed BA (runtime/scan_tracker
``chunk.window_ba``: _window_ba through solvers/ba.local_ba, the point
cull and the bidirectional fuse, once a chunk that inserted a keyframe):
host-clock milliseconds of the program's own stage over the window's
chunks, per chunk of the window. Loading this reader turns the program's
tracer on (harness/program_trace: readers load only in a traced run,
before set-up)."""

from harness import program_trace

program_trace.switch_on()


def read(rec):
    recs = program_trace.window_records(rec)
    t = None if recs is None else program_trace.stage_seconds(recs, "chunk.window_ba")
    return None if t is None else 1e3 * t / len(recs)
