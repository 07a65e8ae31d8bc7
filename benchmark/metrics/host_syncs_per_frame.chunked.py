"""Chunk tracking and the front end: host-device synchronisations the
program counted (``host_syncs``: each synchronising CUDA operation, from
torch's sync debug mode, the hidden ones such as boolean-mask indexing and
synchronous copies included) in its stages ``chunk.extract`` and
``chunk.track`` and below them, over the window's chunks, per frame it
stepped there (``frames``). Loading this reader turns the program's tracer
on (harness/program_trace: readers load only in a traced run, before
set-up)."""

from harness import program_trace

program_trace.switch_on()


def read(rec):
    recs = program_trace.window_records(rec)
    if recs is None or not rec.get("device"):
        return None     # counted on the card only
    frames = program_trace.count(recs, "frames")
    if not frames:
        return None
    roots = ("chunk.extract", "chunk.track")
    return program_trace.count(recs, "host_syncs", roots) / frames
