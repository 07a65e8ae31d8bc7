"""Chunk tracking, retried work: the share of the frames the program
stepped over the window's chunks (``frames``) whose motion model fell
short of ``min_inliers_after_pose`` and were matched again against the
reference keyframe (``motion_fallbacks``), in percent. Loading this reader
turns the program's tracer on (harness/program_trace: readers load only in
a traced run, before set-up)."""

from harness import program_trace

program_trace.switch_on()


def read(rec):
    recs = program_trace.window_records(rec)
    if recs is None:
        return None
    frames = program_trace.count(recs, "frames")
    return None if not frames else 100.0 * program_trace.count(recs, "motion_fallbacks") / frames
