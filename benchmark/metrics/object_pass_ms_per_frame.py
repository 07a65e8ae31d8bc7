"""Chunk tracking, the object pass (runtime/scan_tracker ``frame.objects``:
objects/association, resolve, the table update, and the readback of
whether a new object forces a keyframe): host-clock milliseconds of the
program's own stage over the window's chunks, per frame of the window.
Loading this reader turns the program's tracer on (harness/program_trace:
readers load only in a traced run, before set-up)."""

from harness import program_trace

program_trace.switch_on()


def read(rec):
    recs = program_trace.window_records(rec)
    t = None if recs is None else program_trace.stage_seconds(recs, "frame.objects")
    return None if t is None else 1e3 * t / rec["window"]["frames"]
